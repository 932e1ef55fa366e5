"""The control of a cell's check: for each seed, one set-up and a short
window of the program, then every number the check compares read twice,
for the program (``check``) and for the control (the plain reference one
step below the configuration's precision, put in the program's place and
judged the same way: ``Driver.control``). One JSON line a seed. With
``--program-only`` the program's readings alone (the lower readings over
more seeds).

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--program-only]

On the card, from the root of a checkout. The benchmark's own runs never
run it: it is how each limit's lower and upper readings were taken.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed, seconds, device="cuda", control=True):
    """{"program": {...}, "control": {...}} for one seed (without
    ``control`` the program's alone)."""
    import importlib

    import torch

    from portbench.reference import full_float32
    from portbench.trace import Tracer

    cell = dict(cell, seed=seed)
    driver = importlib.import_module(
        f"portbench.traffic.{cell['driver']}").Driver(cell, device=device)
    window = driver.run(seconds, Tracer(False))
    with full_float32():
        out = {"program": driver.check(window)}
        notes = dict(getattr(driver, "notes", {}))
        if control:
            out["control"] = driver.control(window)
            notes["control"] = {k: driver.notes[k]
                                for k in ("same_path", "stream_p50")
                                if k in driver.notes}
    if device != "cpu":
        torch.cuda.synchronize()
    return {**out, "notes": notes}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-only", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, args.seconds,
                       control=not args.program_only)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
