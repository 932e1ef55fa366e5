"""Hold one checkout's level kernel to another's bits on the card: the
t-distribution configs of chip_smoke.CONFIGS (and, where the checkout's
chip_smoke has them, its ESTIMATOR_CONFIGS and PRIOR_CONFIGS) through mode
(a) (the Linearization and the residual pass) and mode (b) at B = 1 (the
output rows) at every tracked level of chip_smoke's noisy 640x480 pair,
and phase 3's 24-frame odometry trajectory.

    python3 tests/torch_parent_bits.py TREE OUT.npz    # one checkout
    python3 tests/torch_parent_bits.py --compare A.npz B.npz

TREE is the repository root or a parent unpacked with `git archive`
under build/; each run imports and builds that tree's package, so run
each tree in its own process. Arrays present in both files are compared
byte for byte.
"""

import dataclasses
import os
import sys

import numpy as np

FIELDS = ("A", "b", "err_mean", "n_valid", "n_raw", "sigma", "log1p_sum",
          "err_raw")


def compare(path_a, path_b):
    a, b = np.load(path_a), np.load(path_b)
    keys = sorted(set(a.files) & set(b.files))
    bad = [k for k in keys if a[k].tobytes() != b[k].tobytes()]
    print(f"compared {len(keys)} arrays ({len(set(a.files) ^ set(b.files))} "
          f"in one file only): {len(bad)} differ {bad[:10]}")
    for k in bad[:10]:
        print(f"  {k}: max |a - b| "
              f"{np.abs(a[k].astype(np.float64) - b[k].astype(np.float64)).max()}")


def dump(tree, out):
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as smoke
    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker
    from dvo_slam_tpu_torch.ops import linearize
    from dvo_slam_tpu_torch.utils import synthetic

    dev = torch.device("cuda", 0)
    base = TrackerConfig()
    res = {}
    ref_pyr, cur_pyr, Ks, T = smoke._noisy_pair(dev, base)
    sigma0 = torch.tensor([[40.0, 0.01], [0.01, 1e-3]], device=dev)
    configs = {**smoke.CONFIGS, **getattr(smoke, "ESTIMATOR_CONFIGS", {}),
               **getattr(smoke, "PRIOR_CONFIGS", {})}
    for name, fields in configs.items():
        cfg = dataclasses.replace(base, **fields)
        for lvl in base.tracked_levels:
            ref = linearize.prepare_reference(ref_pyr[lvl], Ks[lvl], cfg)
            lin = linearize.linearize(ref, cur_pyr[lvl], Ks[lvl], T, cfg,
                                      sigma_init=sigma0, sigma_warm=True)
            for f in FIELDS:
                res[f"a/{name}/{lvl}/{f}"] = getattr(lin, f).cpu().numpy()
            for f, t in zip(("rI", "rZ", "valid"), linearize.kernel_residuals(
                    dev, ref.px.numel())):
                res[f"a/{name}/{lvl}/{f}"] = t.cpu().numpy()
            row = linearize.RefData(*(None if f is None else f[None]
                                      for f in ref))
            out_f, out_i = linearize.track_level_kernels(
                row, cur_pyr[lvl], Ks[lvl], T[None], cfg)
            res[f"b/{name}/{lvl}/out"] = out_f.cpu().numpy()
            res[f"b/{name}/{lvl}/out_i"] = out_i.cpu().numpy()
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(smoke.N_FRAMES, radius=0.06)
    frames = synthetic.render_sequence(scene, np.asarray(smoke.K_TUPLE),
                                       smoke.W, smoke.H, poses)
    tracker = OdometryTracker(smoke.K_TUPLE, base, device=dev)
    for k, (i, z) in enumerate(frames):
        tracker.update(i, z, float(k))
    res["odometry"] = np.stack([T_w for _, T_w in tracker.trajectory])
    np.savez(out, **res)
    print(f"{tree}: {len(res)} arrays saved to {out} "
          f"({torch.cuda.get_device_name(0)})")


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        dump(os.path.abspath(sys.argv[1]), os.path.abspath(sys.argv[2]))
