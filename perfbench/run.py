"""Run one cell of the benchmark once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its entry and its metrics are found by name
(``perfbench/core.py``). With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a profile
of the window's last steps. Each number compared with the plain reference
is printed beside its limit, as standard error's last lines and under
``compared``, the result's last key. The run fails, and prints no result,
without CUDA or with fewer cards than the cell asks for, and when JAX or the
JAX package is loaded once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of the program inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import core, judge

    wl = core.load_json("workloads", args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {n}", file=sys.stderr)
        return 2
    if args.seed < 0:
        print("perfbench: --seed must be >= 0", file=sys.stderr)
        return 2
    out = core.measure(args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    bad = core.forbidden_modules()
    if bad:
        print(f"perfbench: loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    info = out.pop("info")
    print("perfbench info " + json.dumps(info))
    judge.report(out["compared"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
