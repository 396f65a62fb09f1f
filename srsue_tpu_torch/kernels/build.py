"""Build of the port's hand-written CUDA kernels.

The sources ``srsue_tpu_torch/csrc/*.cu`` (with the shared header
``bcjr_core.cuh``) have a plain C interface. At the first CUDA call each
source is compiled with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together; the objects are linked into one
shared library under ``build/kernels/`` at the root of the checkout and
loaded with ``ctypes``. Importing the package builds nothing. The
library's name carries a hash of the sources and flags, so an edited source
is rebuilt and a current build is reused.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the half-iteration instances, srsue_bcjr_half_<name>, share one signature;
# srsue_bcjr_half_fused has its own
HALF_KERNELS = ("r2max", "v2v3", "v4", "v5")


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
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    for name in HALF_KERNELS:
        fn = getattr(lib, f"srsue_bcjr_half_{name}")
        fn.argtypes = [p, p, p, p, p, p, p, ll, i, p]
        fn.restype = ctypes.c_int
    lib.srsue_bcjr_half_fused.argtypes = [p, p, p, p, p, p, p, p, p, p, ll, i, i, p]
    lib.srsue_bcjr_half_fused.restype = ctypes.c_int
    lib.srsue_viterbi.argtypes = [p, p, ll, i, p]
    lib.srsue_viterbi.restype = ctypes.c_int
    lib.srsue_demap_dematch.argtypes = [p, ll, p, ll, ll, f, p, i, p, p, ll, ll, p, i, ll, ll,
                                        p, p]
    lib.srsue_demap_dematch.restype = ctypes.c_int
    lib.srsue_demap_llr.argtypes = [p, ll, p, ll, ll, f, p, i, ll, p, p]
    lib.srsue_demap_llr.restype = ctypes.c_int
    # resident warps per SM of each kernel, by the CUDA occupancy calculator
    for name in HALF_KERNELS:
        fn = getattr(lib, f"srsue_bcjr_half_{name}_warps")
        fn.argtypes = [i, p]
        fn.restype = ctypes.c_int
    lib.srsue_bcjr_half_fused_warps.argtypes = [ll, i, i, p]
    lib.srsue_bcjr_half_fused_warps.restype = ctypes.c_int
    lib.srsue_viterbi_warps.argtypes = [i, p]
    lib.srsue_viterbi_warps.restype = ctypes.c_int
    lib.srsue_demap_warps.argtypes = [i, i, p]
    lib.srsue_demap_warps.restype = ctypes.c_int


def _compile(nvcc: str, sources: list[Path], so: Path) -> str:
    """One nvcc per source, run in parallel, then one link; returns the
    compilers' output. Raises on the first failure."""
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{so.stem}.{src.stem}.{tag}.o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n" + "".join(logs))
        tmp = so.with_name(f"{so.name}.{tag}")
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n" + "".join(logs))
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(logs)


@functools.lru_cache(maxsize=1)
def load() -> Library:
    """Compile (if needed) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libsrsue_torch_kernels_{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _compile(nvcc_path(), sources, so)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    _bind(lib)
    return Library(lib, so, seconds, log)


def warps_per_sm(kernel: str, *args: int) -> int:
    """Warps of a kernel resident on one SM of the current CUDA device, by
    the CUDA occupancy calculator for the launch configuration its wrapper
    would use: ``kernel`` is a half instance of HALF_KERNELS (args: lw),
    ``"fused"`` (args: B, K, lw), ``"viterbi"`` (args: n) or ``"demap"``
    (args: llr_form 0 for the softbuffer form or 1 for the LLR form, qm)."""
    lib = load().lib
    fn = {"viterbi": lib.srsue_viterbi_warps, "demap": lib.srsue_demap_warps}.get(kernel)
    if fn is None:
        fn = getattr(lib, f"srsue_bcjr_half_{kernel}_warps")
    out = ctypes.c_int(0)
    rc = fn(*args, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"occupancy of {kernel} {args}: CUDA error {rc}")
    return out.value
