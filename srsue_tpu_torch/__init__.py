"""srsue_tpu_torch -- the PyTorch/CUDA port of srsue_tpu.

The JAX package ``srsue_tpu`` is the reference; this package mirrors its
module names (``srsue_tpu_torch/phy/chest.py`` is the counterpart of
``srsue_tpu/phy/chest.py``) and imports nothing of it and no JAX: where
it needs a host table of the reference (``phy/cell.py``, ``regrid.py``,
``crc.py``, ``seq.py``, ``mac/pdu.py``) it keeps its own copy, whose header
names the reference file.

* ``phy``     -- the grant-known PDSCH receive chain in torch, plus the
  host-side transmitter that makes its test vectors;
* ``kernels`` -- hand-written CUDA kernels (sources in ``csrc/``), their
  wrappers and plain PyTorch twins; built with nvcc at first CUDA use;
* ``entry``   -- the main path (``entry()``), the 20 MHz MCS 28 chain.

Every function takes its device from its tensors or an explicit
``device`` argument. The entry points (``entry.entry``, ``rx.make_rx``,
``PdschCodec``, ``pdsch.codec``, ``UeDl``) run on the card unless given
``device="cpu"``; CPU tensors run the plain twins of the kernels.
"""

__version__ = "0.1.0"
