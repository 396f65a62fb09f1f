"""The port's own copy of ``srsue_tpu/rlc/__init__.py`` (its reference), unchanged below this docstring.

RLC layer — TM/UM/AM entities (36.322; reference ue/src/upper/rlc*.cc).

Host-side byte protocol engines; the MAC mux/demux pulls/pushes PDUs via
the rlc_interface_mac surface (get_buffer_state / read_pdu / write_pdu).
"""

from .rlc import Rlc, RlcMode
