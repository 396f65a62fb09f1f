"""srsue_tpu_torch -- the PyTorch/CUDA port of srsue_tpu.

The JAX package ``srsue_tpu`` is the reference; this package mirrors its
module names (``srsue_tpu_torch/phy/chest.py`` is the counterpart of
``srsue_tpu/phy/chest.py``) and imports nothing of it and no JAX: where
it needs a host table of the reference (``phy/cell.py``, ``regrid.py``,
``crc.py``, ``seq.py``, ``mac/pdu.py``, ``radio/radio.py``) it keeps its own
copy, whose header names the reference file.

* ``phy``     -- the downlink receive chain in torch (cell search, PBCH,
  control region, PDSCH on 1 and 2 ports, the receiver state machine),
  plus the host-side transmitter that makes its test vectors;
* ``radio``   -- the IQ streams a ``Receiver`` reads;
* ``kernels`` -- hand-written CUDA kernels (sources in ``csrc/``), their
  wrappers and plain PyTorch twins; built with nvcc at first CUDA use;
* ``entry``   -- the main path (``entry()``), the 20 MHz MCS 28 chain;
  ``rx`` -- the blind chain, the TM2 chain and their test vectors.

Every function takes its device from its tensors or an explicit
``device`` argument. The entry points (``entry.entry``, ``rx.make_rx``,
``rx.make_tm2_rx``, ``PdschCodec``, ``pdsch.codec``, ``UeDl``, ``Receiver``)
run on the card unless given ``device="cpu"``; CPU tensors run the plain
twins of the kernels.
"""

__version__ = "0.1.0"
