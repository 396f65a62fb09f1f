"""srsue_tpu_torch -- the PyTorch/CUDA port of srsue_tpu.

The JAX package ``srsue_tpu`` is the reference; this package mirrors its
module names (``srsue_tpu_torch/phy/chest.py`` is the counterpart of
``srsue_tpu/phy/chest.py``) and imports no JAX. It reuses only the
reference's JAX-free host modules ``srsue_tpu.phy.{cell, regrid, crc,
seq}``.

* ``phy``     -- the grant-known PDSCH receive chain in torch, plus the
  host-side transmitter that makes its test vectors;
* ``kernels`` -- hand-written CUDA kernels (sources in ``csrc/``), their
  wrappers and plain PyTorch twins; built with nvcc at first CUDA use;
* ``entry``   -- the main path (``entry()``), the 20 MHz MCS 28 chain.

Every function takes its device from its tensors or an explicit
``device`` argument; CPU tensors run the plain twins of the kernels.
"""

__version__ = "0.1.0"
