"""The torch port loads no JAX and nothing of the JAX package, builds
nothing at import, runs its entry points on the card unless told
otherwise, and never falls back to the CPU when CUDA is asked for."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
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
ref = sorted(m for m in sys.modules if m == "srsue_tpu" or m.startswith("srsue_tpu."))
assert not ref, ref
assert srsue_tpu_torch.kernels.build.load.cache_info().currsize == 0, "built at import"
print(" ".join(names), len(names))
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_every_module_imports_without_jax():
    res = _run(["-c", _IMPORT_ALL], REPO)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 42  # every module was imported
    for name in ("phy.sync", "phy.pbch", "phy.receiver", "radio.radio", "mac.rnti", "phy.pusch",
                 "phy.pucch", "phy.uci", "phy.srs", "phy.prach", "phy.powerctrl",
                 "phy.ue_ul_ctrl", "mac.ul_harq"):
        assert f"srsue_tpu_torch.{name}" in res.stdout


_IMPORT_UPLINK = """
import sys
import srsue_tpu_torch.phy.pusch, srsue_tpu_torch.phy.pucch, srsue_tpu_torch.phy.uci
import srsue_tpu_torch.phy.srs, srsue_tpu_torch.phy.prach, srsue_tpu_torch.phy.powerctrl
import srsue_tpu_torch.phy.ue_ul_ctrl, srsue_tpu_torch.mac.ul_harq
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
ref = sorted(m for m in sys.modules if m == "srsue_tpu" or m.startswith("srsue_tpu."))
assert not ref, ref
print("ok")
"""


def test_uplink_modules_import_without_jax():
    """The uplink's modules, imported on their own in a fresh interpreter,
    load neither JAX nor any module of the JAX package."""
    res = _run(["-c", _IMPORT_UPLINK], REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"


def test_chip_smoke_imports_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert "jax" not in src.replace("Imports no JAX", "")
    assert not re.search(r"^\s*(from|import) srsue_tpu\b(?!_torch)", src, re.M)


def test_card_tests_import_nothing_of_the_reference():
    """tests/test_torch_cuda.py runs with --noconftest on a machine without
    JAX: it imports the port only."""
    src = (REPO / "tests" / "test_torch_cuda.py").read_text()
    assert not re.search(r"^\s*(from|import) (jax|srsue_tpu)\b(?!_torch)", src, re.M)


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
    from srsue_tpu_torch import entry
    from srsue_tpu_torch.phy import ra
    from srsue_tpu_torch.phy.cell import Cell
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


def _default_device_calls():
    from srsue_tpu_torch import rx
    from srsue_tpu_torch.phy import pdsch, ra
    from srsue_tpu_torch.phy.cell import Cell
    from srsue_tpu_torch.phy.ue_dl import UeDl

    from srsue_tpu_torch.phy import control
    from srsue_tpu_torch.phy.cell import UlGrant
    from srsue_tpu_torch.phy.pusch import PuschCodec
    from srsue_tpu_torch.phy.receiver import Receiver
    from srsue_tpu_torch.radio import ArrayRadio

    cell, grant = Cell(n_prb=6, cell_id=1), ra.dl_grant(6, 5)
    cell2 = Cell(n_prb=6, cell_id=1, n_ports=2)
    bits = np.zeros(21, np.uint8)
    pay = np.zeros((1, grant.tbs), np.uint8)
    return {
        "make_rx": lambda: rx.make_rx(cell, grant, 1, 1, 0x1234, bits, pay, True),
        "PdschCodec": lambda: pdsch.PdschCodec(cell, grant, 0x1234, 1),
        "codec": lambda: pdsch.codec(cell, grant, 0x1234, 1),
        "UeDl": lambda: UeDl(cell),
        "UeDl_2port": lambda: UeDl(cell2),
        "make_tm2_rx": lambda: rx.make_tm2_rx(cell2, grant, 1, 0x1234, pay, True),
        "Receiver": lambda: Receiver(ArrayRadio(np.zeros(8, np.complex64), cell.srate)),
        "PuschCodec": lambda: PuschCodec(cell, UlGrant(6, 0, 9, 2, 936), 0x1234, 2),
        "phich_decode": lambda: control.phich_decode(
            cell, np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64), 1, 0, 0),
    }


@pytest.mark.parametrize("name", ["make_rx", "PdschCodec", "codec", "UeDl", "UeDl_2port",
                                  "make_tm2_rx", "Receiver", "PuschCodec", "phich_decode"])
def test_entry_point_defaults_to_the_card(name):
    """Without a device argument an entry point asks for CUDA, and raises
    on a machine without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _default_device_calls()[name]()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from srsue_tpu_torch.kernels import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
