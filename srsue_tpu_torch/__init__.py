"""srsue_tpu_torch -- the PyTorch/CUDA port of srsue_tpu.

The JAX package ``srsue_tpu`` is the reference; this package mirrors its
module names (``srsue_tpu_torch/phy/chest.py`` is the counterpart of
``srsue_tpu/phy/chest.py``) and imports nothing of it and no JAX: where
it needs a host module of the reference (``phy/cell.py``, ``regrid.py``,
``crc.py``, ``seq.py``, the MAC, RLC, PDCP, RRC, NAS, USIM and GW layers,
``ue.py``, the eNB stack, the radios) it keeps its own copy, whose header
names the reference file.

* ``phy``     -- the downlink receive chain in torch (cell search, PBCH,
  control region, PDSCH on 1 and 2 ports, the receiver state machine),
  the uplink (PUSCH, PUCCH, SRS, PRACH, power control), the host-side
  transmitter that makes test vectors, and the UE's PHY facade
  (``phy.Phy``: one subframe per ``work`` call);
* ``mac``, ``rlc``, ``pdcp``, ``rrc``, ``nas``, ``usim``, ``gw`` -- the
  host protocol stack, and ``ue.Ue`` that wires it to a ``Phy``;
* ``enb``     -- the eNB emulator (``enb.phy.EnbPhy`` over ``enb.stack``)
  that a UE attaches to over the air;
* ``radio``   -- the IQ streams a ``Receiver`` reads (and the native
  prefetching reader, ``radio.native_io``);
* ``parallel`` -- sharding over ``torch.distributed``: carriers, time
  blocks, turbo windows, one spawned process per rank (``mesh.launch``);
* ``kernels`` -- hand-written CUDA kernels (sources in ``csrc/``), their
  wrappers and plain PyTorch twins; built with nvcc at first CUDA use;
* ``entry``   -- the main path (``entry()``), the 20 MHz MCS 28 chain;
  ``rx`` -- the blind chain, the TM2 chain and their test vectors;
  ``main`` -- the UE application (``python -m srsue_tpu_torch.main``).

Every function takes its device from its tensors or an explicit
``device`` argument. The entry points (``entry.entry``, ``rx.make_rx``,
``rx.make_tm2_rx``, ``PdschCodec``, ``pdsch.codec``, ``UeDl``, ``Receiver``,
``PuschCodec``, ``Phy``, ``EnbPhy``, ``mesh.launch``, ``dryrun_multichip``,
``bler.sweep_pdsch``) run on the card unless given
``device="cpu"``; CPU tensors run the plain twins of the kernels.
"""

__version__ = "0.1.0"
