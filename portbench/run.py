"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Exits non-zero, and prints no result, where
no CUDA card (or fewer than the cell asks for) is visible, where the
program or a file of the cell is missing, or where the process holds JAX
or the JAX package after the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    from portbench import harness

    try:
        cell = harness.load_cell(args.workload)
        import torch

        chips = cell.get("chips", 1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise harness.RunError(
                f"the cell needs {chips} CUDA card(s); "
                f"torch sees {torch.cuda.device_count()}")
        result = harness.run(cell, args.seed, args.seconds, args.trace,
                             T_START)
    except harness.RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
