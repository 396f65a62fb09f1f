"""Radio front ends: the IQ streams a ``Receiver`` reads (``radio.py``) and
the live TCP IQ stream of ``main --iq-tcp`` (``socket_radio.py``)."""

from .radio import ArrayRadio, FileRadio, Radio
from .socket_radio import IqPeer, SocketRadio
