"""Two checkouts' end-to-end headlines on one card, in turns A, B, B, A.

    python3 tests/torch_turns.py PARENT_DIR CHANGE_DIR

Each directory holds a checkout of the repository (unpacked with ``git
archive``) with its own chip_smoke.py. Each turn is a fresh process in one
checkout on card 0: chip_smoke's phase 3 (odometry over the 24-frame
640x480 orbit, ms/frame after 4 warm-up frames) and phase 5b (KeyframeSlam
over the ring, ms/frame of the 160 timed frames), then phase 6b's `cli
benchmark --fr 1` over the offline sequence twice (engine fps). The
offline sequence is rendered once, by CHANGE_DIR's chip_smoke, into a
temporary directory. Prints a line per turn and, last, one JSON object:
per checkout, each turn's ms/frame (phases 3 and 5b) and fps. Needs a
CUDA card; not a test: pytest does not collect it.
"""

import json
import os
import subprocess
import sys
import tempfile

TURN_TIMEOUT_S = 600

CHILD = r"""
import contextlib, io, json, re, sys
import torch
import chip_smoke as s
from dvo_slam_tpu_torch import _build

seq = sys.argv[1]
dev = torch.device("cuda", 0)
_build.load()
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    s.phase_main_path(dev)
    s.phase_slam(dev)
ms, slam_ms = (
    float(re.search(r"([0-9.]+) ms/frame", next(
        x for x in buf.getvalue().splitlines() if x.startswith(head))).group(1))
    for head in ("phase 3 main path", "phase 5b SLAM path"))
flags = ["--fr", "1", "--min-entropy-ratio", "0.96", "--search-radius",
         f"{0.35 * s.OFFLINE_RADIUS:g}", "--min-constraint-distance", "3",
         "--device", str(dev)]
fps = []
for _ in range(2):
    rc, out = s._cli(["benchmark", seq, *flags])
    if rc != 0:
        sys.exit(f"benchmark exited {rc}")
    fps.append(json.loads(out)["fps"])
print(json.dumps({"ms_frame": ms, "slam_ms_frame": slam_ms, "fps": fps}))
"""


def turn(checkout, seq):
    """One turn in a fresh process in ``checkout``: {"ms_frame", "fps"}."""
    proc = subprocess.run([sys.executable, "-c", CHILD, seq], cwd=checkout,
                          capture_output=True, text=True,
                          timeout=TURN_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {checkout} exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    parent, change = (os.path.abspath(d) for d in sys.argv[1:3])
    sys.path.insert(0, change)
    import chip_smoke

    out = {parent: [], change: []}
    with tempfile.TemporaryDirectory(prefix="dvo_turns_") as tmp:
        seq = os.path.join(tmp, "seq")
        chip_smoke._render_offline(seq, chip_smoke.OFFLINE_FRAMES,
                                   chip_smoke.W, chip_smoke.H)
        for k, checkout in enumerate((parent, change, change, parent)):
            got = turn(checkout, seq)
            out[checkout].append(got)
            print(f"turn {k + 1} {os.path.basename(checkout)}: phase 3 "
                  f"{got['ms_frame']:.3f} ms/frame, 5b "
                  f"{got['slam_ms_frame']:.3f} ms/frame, 6b fps "
                  f"{', '.join(f'{x:.3f}' for x in got['fps'])}", flush=True)
    print(json.dumps({os.path.basename(k): v for k, v in out.items()}))


if __name__ == "__main__":
    main()
