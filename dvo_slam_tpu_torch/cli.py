"""Command-line interface of the PyTorch port (counterpart of
``dvo_slam_tpu/cli.py``, with the same flags and outputs).

Replaces the reference's executable surface (SURVEY.md §3):
  * `benchmark`      — dvo_benchmark/benchmark_slam over a TUM directory
  * `odometry`       — dvo_ros camera_tracker (frame-to-frame visual
                       odometry, offline over a dataset)
  * `slam`           — dvo_ros/dvo_slam camera_keyframe_tracker
  * `synthetic`      — self-contained benchmark on rendered scenes
  * `live`           — dvo_ros camera_keyframe_tracker / camera_tracker:
                       the streaming node over a socket (node.py)
  * `viz`            — the rviz stand-in: subscribe to a running `live`
                       node's pose feed and render it
  * `evaluate`       — TUM evaluate_ate/evaluate_rpe equivalents
  * `optimize-graph` — the g2o CLI optimizer on a .g2o file

Every command that tracks or solves runs on --device, the card ("cuda")
unless it is given "cpu".

Usage: python -m dvo_slam_tpu_torch.cli <command> [options]
"""

from __future__ import annotations

import argparse
import sys

from dvo_slam_tpu_torch.config import SlamConfig, TrackerConfig


def _add_tracker_args(p):
    g = p.add_argument_group("tracker (DenseTracker::Config equivalents)")
    g.add_argument("--num-levels", type=int, default=4)
    g.add_argument("--first-level", type=int, default=3)
    g.add_argument("--last-level", type=int, default=1)
    g.add_argument("--max-iterations", type=int, default=50)
    g.add_argument("--precision", type=float, default=1e-6)
    g.add_argument("--no-weighting", action="store_true")
    g.add_argument("--scale-estimator", default="tdist",
                   choices=["unit", "normal", "mad", "tdist"])
    g.add_argument("--influence", default="tdist",
                   choices=["unit", "huber", "tukey", "tdist"])
    g.add_argument("--no-depth", action="store_true",
                   help="photometric-only residuals")
    g.add_argument("--lm-lambda", type=float, default=0.0)


def _add_slam_args(p):
    g = p.add_argument_group("slam (dvo_slam::Config equivalents)")
    g.add_argument("--min-entropy-ratio", type=float, default=0.9)
    g.add_argument("--search-radius", type=float, default=5.0)
    g.add_argument("--min-constraint-distance", type=int, default=5)
    g.add_argument("--max-keyframes", type=int, default=256)
    g.add_argument("--max-edges", type=int, default=1024)
    g.add_argument("--no-robust-kernel", action="store_true")


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: the card (cuda, the "
                        "default) or cpu")


def _tracker_cfg(args) -> TrackerConfig:
    return TrackerConfig(
        num_levels=args.num_levels,
        first_level=args.first_level,
        last_level=args.last_level,
        max_iterations=args.max_iterations,
        precision=args.precision,
        use_weighting=not args.no_weighting,
        scale_estimator=args.scale_estimator,
        influence=args.influence,
        use_depth=not args.no_depth,
        lm_lambda_init=args.lm_lambda,
    )


def _slam_cfg(args) -> SlamConfig:
    return SlamConfig(
        min_entropy_ratio=args.min_entropy_ratio,
        new_constraint_search_radius=args.search_radius,
        min_constraint_distance=args.min_constraint_distance,
        max_keyframes=args.max_keyframes,
        max_edges=args.max_edges,
        use_robust_kernel=not args.no_robust_kernel,
    )


def _parser():
    ap = argparse.ArgumentParser(
        prog="dvo_slam_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    for name, mode in [("benchmark", "slam"), ("slam", "slam"),
                       ("odometry", "odometry")]:
        p = sub.add_parser(name)
        p.add_argument("dataset", help="TUM RGB-D sequence directory")
        p.add_argument("--trajectory-out", default=None)
        p.add_argument("--max-frames", type=int, default=None)
        p.add_argument("--fr", type=int, default=1, choices=[1, 2, 3],
                       help="TUM freiburg calibration set")
        p.add_argument(
            "--covariance-out", default=None,
            help="write per-frame 6x6 pose covariances "
                 "(Information^{-1}; reference PoseWithCovarianceStamped)",
        )
        if mode != "odometry":
            p.add_argument("--checkpoint-out", default=None,
                           help="save full SLAM state (.npz) after the run")
            p.add_argument("--resume", default=None,
                           help="resume from a checkpoint (.npz) and "
                                "continue over the dataset frames")
            p.add_argument("--chunk-size", type=int, default=None,
                           help="chunked device-resident front-end: N "
                                "frames issued with no host sync between "
                                "them, one read-back per chunk (full "
                                "feature parity incl. the windowed "
                                "local-map solve)")
            p.add_argument("--graph-out", default=None,
                           help="write the final pose graph as .g2o "
                                "(inspectable with g2o_viewer / the "
                                "reference's ecosystem tools)")
        p.set_defaults(mode=mode)
        _add_tracker_args(p)
        _add_slam_args(p)
        _add_device_arg(p)

    p = sub.add_parser("synthetic")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--mode", default="slam",
                   choices=["slam", "keyframe", "odometry"])
    p.add_argument("--trajectory-out", default=None)
    p.add_argument("--chunk-size", type=int, default=None,
                   help="run through the chunked device-resident front-end")
    _add_tracker_args(p)
    _add_slam_args(p)
    _add_device_arg(p)

    p = sub.add_parser(
        "live",
        help="streaming SLAM/odometry node over a socket (dvo_ros "
             "camera_keyframe_tracker / camera_tracker equivalent)",
    )
    p.add_argument("--tcp", type=int, default=None,
                   help="TCP port to listen on")
    p.add_argument("--unix", default=None, help="unix socket path to listen on")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--mode", default="slam",
                   choices=["slam", "keyframe", "odometry"])
    p.add_argument("--fr", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("--intrinsics", type=float, nargs=4, default=None,
                   metavar=("FX", "FY", "CX", "CY"))
    p.add_argument("--covariance", action="store_true",
                   help="include per-frame 6x6 covariance in pose messages")
    p.add_argument("--max-sessions", type=int, default=None)
    p.add_argument("--viz-out", default=None,
                   help="drive a live-updating visualizer in-process "
                        "(trajectory.png/.txt re-rendered as frames arrive)")
    p.add_argument("--publish-clouds", action="store_true",
                   help="attach downsampled keyframe point clouds to the "
                        "pose feed (remote `viz` renders the live map - "
                        "the PCL point-cloud topic equivalent)")
    p.add_argument("--chunk", type=int, default=0,
                   help="latency/throughput knob: buffer N frames and run "
                        "them through the chunked device-resident engine "
                        "(pose messages arrive in bursts up to 2N frames "
                        "late). 0 = per-frame")
    p.add_argument("--stage-eager", action="store_true",
                   help="chunked sessions upload each frame on arrival "
                        "instead of one upload per chunk")
    p.add_argument("--stall-timeout", type=float, default=60.0,
                   help="publish a {\"event\": \"stall\"} pose-feed "
                        "message when one engine call runs longer than "
                        "this many seconds (warn-only; 0 disables; keep "
                        "it above the first call's kernel build)")
    _add_tracker_args(p)
    _add_slam_args(p)
    _add_device_arg(p)

    p = sub.add_parser(
        "viz",
        help="live remote trajectory viewer (rviz equivalent): subscribe "
             "to a running `live` node's pose feed",
    )
    p.add_argument("--tcp", type=int, default=None,
                   help="TCP port of the node")
    p.add_argument("--unix", default=None, help="unix socket path of the node")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--snapshot-every", type=int, default=25)
    p.add_argument("--max-poses", type=int, default=None)

    p = sub.add_parser("evaluate")
    p.add_argument("estimated", help="TUM-format trajectory file")
    p.add_argument("groundtruth", help="TUM-format groundtruth file")
    p.add_argument("--rpe-delta", type=float, default=1)
    p.add_argument("--rpe-seconds", action="store_true",
                   help="TUM published protocol: --rpe-delta is SECONDS "
                        "(evaluate_rpe.py --fixed_delta --delta_unit s; "
                        "drift in m/s), closest-timestamp pairing, "
                        "max 10000 sampled pairs")

    p = sub.add_parser(
        "optimize-graph",
        help="standalone pose-graph optimization on a .g2o file (the g2o "
             "CLI optimizer equivalent, on the device LM backend)",
    )
    p.add_argument("graph", help="input .g2o file")
    p.add_argument("--out", required=True, help="optimized .g2o output")
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--no-robust-kernel", action="store_true")
    p.add_argument("--cauchy-c", type=float, default=1.0)
    p.add_argument("--solver", choices=["auto", "dense", "cg"],
                   default="auto",
                   help="auto: dense Cholesky below "
                        "SlamConfig.graph_cg_threshold vertices, "
                        "matrix-free block-Jacobi CG at/above it")
    _add_device_arg(p)
    return ap


def _evaluate(args) -> int:
    import numpy as np

    from dvo_slam_tpu_torch.utils import evaluate, tum

    est = tum.read_trajectory(args.estimated)
    gt = tum.read_trajectory(args.groundtruth)
    pairs = tum.associate([t for t, _ in est], [t for t, _ in gt])
    if len(pairs) < 2:
        # Different time bases (0-based synthetic stamps against mocap
        # epoch seconds) are the usual cause.
        print(
            f"error: only {len(pairs)} timestamp association(s) between "
            "the trajectories (need >= 2) — do the files share a time "
            "base within the association tolerance?",
            file=sys.stderr,
        )
        return 2
    e = [est[i][1] for i, _ in pairs]
    g = [gt[j][1] for _, j in pairs]
    ate = evaluate.ate_rmse(e, g)
    if args.rpe_seconds:
        ts = [est[i][0] for i, _ in pairs]
        rpe_t, rpe_r = evaluate.rpe(
            e, g, delta=args.rpe_delta, timestamps=ts, per_second=True
        )
        # Like evaluate_rpe.py, the value is the raw error over one
        # delta-second interval (m/s exactly when delta == 1 s).
        unit = ("m_per_s" if args.rpe_delta == 1.0
                else f"m_per_{args.rpe_delta:g}s")
    else:
        if args.rpe_delta != int(args.rpe_delta):
            print("error: --rpe-delta must be an integer frame offset "
                  "unless --rpe-seconds is given", file=sys.stderr)
            return 2
        rpe_t, rpe_r = evaluate.rpe(e, g, delta=int(args.rpe_delta))
        unit = "m"
    print(f"ate_rmse_m {ate:.6f}")
    print(f"rpe_trans_{unit} {rpe_t:.6f}")
    print(f"rpe_rot_deg {np.degrees(rpe_r):.6f}")
    return 0


def _optimize_graph(args) -> int:
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.utils import g2o_io

    g = g2o_io.load_g2o(args.graph)
    solver = args.solver
    if solver == "auto":
        solver = ("cg" if g.poses.shape[0]
                  >= SlamConfig().graph_cg_threshold else "dense")
    solved, chi2, _ = pose_graph.optimize(
        g, iterations=args.iterations,
        use_robust=not args.no_robust_kernel,
        cauchy_c=args.cauchy_c,
        solver=solver,
        device=args.device,
    )
    g2o_io.save_g2o(args.out, solved)
    print(f"vertices {int(g.num_vertices)} edges {int(g.num_edges)} "
          f"final_chi2 {float(chi2):.6g}")
    return 0


def _address(args):
    if args.unix:
        return args.unix, True
    return (args.host, args.tcp or 7447), False


def _viz(args) -> int:
    from dvo_slam_tpu_torch import node
    from dvo_slam_tpu_torch.utils.visualization import (
        LiveTrajectoryVisualizer,
    )

    viz = LiveTrajectoryVisualizer(args.out,
                                   snapshot_every=args.snapshot_every)
    address, unix = _address(args)
    n = node.view(address, viz, unix=unix, max_poses=args.max_poses)
    print(f"viewed {n} poses -> {args.out}", file=sys.stderr)
    return 0


def _live(args, tracker_cfg, slam_cfg) -> int:
    from dvo_slam_tpu_torch import node
    from dvo_slam_tpu_torch.ops import camera

    if args.intrinsics is not None:
        K = tuple(args.intrinsics)
    else:
        K = {1: camera.TUM_FR1, 2: camera.TUM_FR2, 3: camera.TUM_FR3}[args.fr]
    address, unix = _address(args)
    viz = None
    if args.viz_out:
        from dvo_slam_tpu_torch.utils.visualization import (
            LiveTrajectoryVisualizer,
        )

        viz = LiveTrajectoryVisualizer(args.viz_out)
    print(f"listening on {address} mode={args.mode} device={args.device}",
          file=sys.stderr)
    node.serve(address, K, tracker_cfg, slam_cfg, mode=args.mode,
               with_covariance=args.covariance, unix=unix,
               max_sessions=args.max_sessions, visualizer=viz,
               publish_clouds=args.publish_clouds, chunk=args.chunk,
               stage_eagerly=args.stage_eager,
               stall_timeout=args.stall_timeout, device=args.device)
    return 0


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.command == "evaluate":
        return _evaluate(args)
    if args.command == "viz":
        return _viz(args)

    import torch

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print(f"error: --device {args.device}: no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    if args.command == "optimize-graph":
        return _optimize_graph(args)

    from dvo_slam_tpu_torch import benchmark
    from dvo_slam_tpu_torch.ops import camera

    tracker_cfg = _tracker_cfg(args)
    slam_cfg = _slam_cfg(args)
    if args.command == "live":
        return _live(args, tracker_cfg, slam_cfg)
    if args.command == "synthetic":
        res = benchmark.run_synthetic(
            num_frames=args.frames, width=args.width, height=args.height,
            tracker_cfg=tracker_cfg, slam_cfg=slam_cfg, mode=args.mode,
            trajectory_out=args.trajectory_out, chunk_size=args.chunk_size,
            device=args.device,
        )
    else:
        K = {1: camera.TUM_FR1, 2: camera.TUM_FR2, 3: camera.TUM_FR3}[args.fr]
        res = benchmark.run_tum_dataset(
            args.dataset, tracker_cfg, slam_cfg, mode=args.mode,
            trajectory_out=args.trajectory_out, max_frames=args.max_frames,
            intrinsics=K,
            covariance_out=args.covariance_out,
            checkpoint_out=getattr(args, "checkpoint_out", None),
            resume=getattr(args, "resume", None),
            chunk_size=getattr(args, "chunk_size", None),
            graph_out=getattr(args, "graph_out", None),
            device=args.device,
        )
    print(res.to_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
