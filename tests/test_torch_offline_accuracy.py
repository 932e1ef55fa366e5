"""The on-disk accuracy protocols through both packages on one directory:
the port's ATE against the JAX package's.

Two protocols, each a noisy two-lap orbit written as a TUM directory by
the port's writer and replayed by `run_tum_dataset` in slam and keyframe
mode:

- "accuracy": bench/accuracy.py's full-scale protocol (:99-131, 146-157):
  `two_plane_scene(sharpness=1.0)`, radius 0.5 m, +-34 degree yaw sweeps,
  Kinect-style noise (sigma_I 10, sigma_Z 5 % of range, 25 % depth
  dropout), the default tracker, search radius 0.175, min constraint
  distance 3, min entropy ratio 0.96;
- "reduced": tests/test_accuracy_benchmark.py's CPU-scale version
  (:23-50): sharpness 2.0, radius 0.25 m, milder noise, a 2-level
  tracker.

Both seed the noise with 11. `intrinsics`: "protocol" renders and tracks
with the protocols' K (525 px at 640x480, centred principal point), "fr1"
with the freiburg-1 K of chip_smoke.py's phase 6; both scale with the
frame size.

On noisy frames the two packages' f32 IRLS paths part (see
tests/test_torch_benchmark.py), so their trajectories are not compared
point by point: each package must pass the protocol's gates, and the
port's ATE(slam) must stay within a bound of the JAX package's.

Run as a script, it runs the "accuracy" protocol and prints one JSON line
per package and mode:

    JAX_PLATFORMS=cpu python tests/test_torch_offline_accuracy.py \\
        --width 320 --height 240 --frames 160 --intrinsics fr1

`--port-only --device cuda` runs the port alone (for a machine without
JAX).
"""

import argparse
import dataclasses
import json
import sys
import tempfile

import numpy as np

SEED = 11
FR1 = (517.3, 516.5, 318.6, 255.3)
PROTOCOLS = {
    "accuracy": dict(
        sharpness=1.0, radius=0.5,
        noise=dict(intensity_std=10.0, depth_rel_std=0.05, dropout=0.25),
        tracker={},
        slam=dict(new_constraint_search_radius=0.175,
                  min_constraint_distance=3, min_entropy_ratio=0.96)),
    "reduced": dict(
        sharpness=2.0, radius=0.25,
        noise=dict(intensity_std=3.0, depth_rel_std=0.015, dropout=0.08),
        tracker=dict(num_levels=2, first_level=1, last_level=0,
                     max_iterations=30),
        slam=dict(new_constraint_search_radius=0.12,
                  min_constraint_distance=4, coarse_first_level=1,
                  coarse_last_level=1, validation_batch=4)),
}
ATE_LIMIT_M = 0.02
# The port's ATE(slam) may exceed the JAX package's by this factor plus
# the absolute slack below, no more (the reduced protocol at 96x72 reads
# 4.8884 mm in the port and 4.8888 mm in the JAX package on the CPU).
ATE_RATIO, ATE_SLACK_M = 1.1, 2e-4


def intrinsics(kind, width, height):
    sx, sy = width / 640.0, height / 480.0
    if kind == "protocol":
        return (525.0 * sx, 525.0 * sy, (width - 1) / 2.0, (height - 1) / 2.0)
    if kind == "fr1":
        fx, fy, cx, cy = FR1
        return (fx * sx, fy * sy, (cx + 0.5) * sx - 0.5,
                (cy + 0.5) * sy - 0.5)
    raise ValueError(f"intrinsics must be 'protocol' or 'fr1', got {kind!r}")


def write_sequence(out_dir, protocol, frames, width, height, K):
    """Render, corrupt and write one frame at a time, as bench/accuracy.py
    does."""
    from dvo_slam_tpu_torch.utils import synthetic

    p = PROTOCOLS[protocol]
    rng = np.random.default_rng(SEED)
    scene = synthetic.two_plane_scene(sharpness=p["sharpness"])
    poses = synthetic.orbit_trajectory(frames, radius=p["radius"],
                                       yaw_amplitude=0.6, cycles=2.0)

    def stream():
        for T_wc in poses:
            i, z = scene.render(np.asarray(K), width, height, T_wc)
            yield synthetic.add_sensor_noise(i, z, rng, **p["noise"])

    synthetic.write_tum_dataset(out_dir, stream(), poses)


def run_port(seq, protocol, K, device):
    from dvo_slam_tpu_torch import benchmark
    from dvo_slam_tpu_torch.config import SlamConfig, TrackerConfig

    p = PROTOCOLS[protocol]
    tracker, slam = TrackerConfig(**p["tracker"]), SlamConfig(**p["slam"])
    return {mode: benchmark.run_tum_dataset(seq, tracker, slam, mode=mode,
                                            intrinsics=K, device=device)
            for mode in ("slam", "keyframe")}


def run_jax(seq, protocol, K):
    from dvo_slam_tpu import benchmark
    from dvo_slam_tpu.config import SlamConfig, TrackerConfig

    p = PROTOCOLS[protocol]
    tracker, slam = TrackerConfig(**p["tracker"]), SlamConfig(**p["slam"])
    return {mode: benchmark.run_tum_dataset(seq, tracker, slam, mode=mode,
                                            intrinsics=K)
            for mode in ("slam", "keyframe")}


def gates(res):
    """bench/accuracy.py's gates: ATE(slam) < 20 mm, >= 1 loop edge,
    ATE(slam) <= 0.7 x ATE(keyframe)."""
    slam, kf = res["slam"], res["keyframe"]
    return (slam.ate_rmse_m < ATE_LIMIT_M and slam.num_loop_edges >= 1
            and slam.ate_rmse_m <= 0.7 * kf.ate_rmse_m)


def test_port_ate_against_jax(tmp_path):
    """The reduced protocol at 96x72, 60 frames (the size of
    tests/test_accuracy_benchmark.py)."""
    import torch

    w, h = 96, 72
    K = intrinsics("protocol", w, h)
    seq = str(tmp_path / "seq")
    write_sequence(seq, "reduced", 60, w, h, K)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = run_port(seq, "reduced", K, "cpu")
    finally:
        torch.set_num_threads(n)
    want = run_jax(seq, "reduced", K)
    for res in (want, got):
        assert gates(res), {m: dataclasses.asdict(r) for m, r in res.items()}
    a, b = got["slam"].ate_rmse_m, want["slam"].ate_rmse_m
    assert a <= ATE_RATIO * b + ATE_SLACK_M, (a, b)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--intrinsics", default="fr1",
                    choices=["protocol", "fr1"])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--port-only", action="store_true")
    args = ap.parse_args(argv)
    K = intrinsics(args.intrinsics, args.width, args.height)
    with tempfile.TemporaryDirectory(prefix="dvo_accuracy_") as tmp:
        write_sequence(tmp, "accuracy", args.frames, args.width,
                       args.height, K)
        runs = [("port", lambda: run_port(tmp, "accuracy", K, args.device))]
        if not args.port_only:
            runs.append(("jax", lambda: run_jax(tmp, "accuracy", K)))
        for package, run in runs:
            for mode, r in run().items():
                print(json.dumps({
                    "package": package, "mode": mode,
                    "intrinsics": args.intrinsics, "width": args.width,
                    "height": args.height, **dataclasses.asdict(r)}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
