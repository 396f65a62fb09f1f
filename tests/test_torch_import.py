"""The torch port loads no JAX, builds nothing at import, and never falls
back to the CPU when CUDA is asked for."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import srsue_tpu_torch
names = [m.name for m in pkgutil.walk_packages(srsue_tpu_torch.__path__, "srsue_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert srsue_tpu_torch.kernels.build.load.cache_info().currsize == 0, "built at import"
print(len(names))
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_every_module_imports_without_jax():
    res = _run(["-c", _IMPORT_ALL], REPO)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 27  # every module was imported


def test_chip_smoke_imports_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert "jax" not in src.replace("Imports no JAX", "")


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    for cwd in (REPO, tmp_path):
        res = _run(["chip_smoke.py"], cwd)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


def test_cuda_request_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    from srsue_tpu.phy.cell import Cell
    from srsue_tpu_torch import entry
    from srsue_tpu_torch.phy import ra
    from srsue_tpu_torch.phy.pdsch import PdschCodec
    from srsue_tpu_torch.utils import device

    with pytest.raises(RuntimeError, match="CUDA"):
        device.require_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        PdschCodec(Cell(n_prb=6), ra.dl_grant(6, 5), 0x1234, 1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry("cuda")
    with pytest.raises(ValueError):
        device.resolve("meta")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from srsue_tpu_torch.kernels import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
