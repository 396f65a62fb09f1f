"""Build of the port's hand-written CUDA kernels.

The sources ``srsue_tpu_torch/csrc/*.cu`` have a plain C interface and are
compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared library
under ``build/kernels/`` at the root of the checkout, at the first CUDA
call, and loaded with ``ctypes``. Importing the package builds nothing.
The library's name carries a hash of the sources and flags, so an edited
source is rebuilt and a current build is reused.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Library:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    log: str              # nvcc/ptxas output (registers, shared memory, spills)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of srsue_tpu_torch cannot be built")


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.srsue_bcjr_half.argtypes = [p, p, p, p, p, p, p,
                                    ctypes.c_longlong, ctypes.c_int, p]
    lib.srsue_bcjr_half.restype = ctypes.c_int


@functools.lru_cache(maxsize=1)
def load() -> Library:
    """Compile (if needed) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libsrsue_torch_kernels_{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _bind(lib)
    return Library(lib, so, seconds, log)
