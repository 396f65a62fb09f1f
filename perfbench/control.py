"""The control of a cell's comparison: the plain reference, rounded to
bfloat16 at every stage (``receiver.bf16``), put in the port's place, at the
cell's own size and inputs. It has to come out as not correct: it fails the
soft numbers the port meets, so their limits lie between the two readings.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints, for each seed, the numbers a run of the cell compares (as many
subframes as a run compares), read on the control. The benchmark's runs do
not run it.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(cell: str, seed: int, device: str, cfg_over=None, wl_over=None) -> dict:
    """The compared numbers of the control of `cell` on `seed`'s inputs."""
    import numpy as np

    from perfbench import core, inputs, judge
    from perfbench.reference import receiver

    wl = {**core.load_json("workloads", cell), **(wl_over or {})}
    cfg = {**core.load_json("configs", wl["config"]), **(cfg_over or {})}
    entry = core.load_module("entries", wl["entry"])
    rng = np.random.default_rng([seed, 1])
    host = wl["batch"] == 1
    _, iq = inputs.noisy_batches(cfg, seed, wl["pool"] if host else wl["batch"],
                                 1 if host else wl["n_batches"], device)
    ref = receiver.Receiver(cfg)
    parts = []
    for _ in range(wl["sample"]["steps"]):
        b = int(rng.integers(0, len(iq)))
        if host:
            rows = [int(rng.integers(0, iq[0].shape[0]))]
            x = iq[0][rows].cpu().numpy()
        else:
            x = iq[b][entry.pick_rows(wl["batch"], wl["sample"]["rows"], rng)].cpu().numpy()
        parts.append(entry.compare(entry.reference(ref, wl, x, receiver.bf16),
                                   entry.reference(ref, wl, x)))
        if hasattr(entry, "batch_numbers"):  # numbers over a whole batch (the global SNR)
            parts[-1].update(entry.batch_numbers(ref, iq[b].cpu().numpy(), receiver.bf16))
    numbers = judge.merge(parts)
    return {"seed": seed, "correct": judge.correct(numbers, wl["limits"]), "numbers": numbers}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, **readings(args.workload, seed, "cuda")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
