"""Do the ranks of a pixel-sharded tracker part off the t-distribution?
The JAX package's tracker in shard_map over a 2-device pixel mesh (each
shard's own results, not the replicated ones) and the port's plain pixel
route in a 2-rank gloo world, on the CPU, on B = 8 two-plane pairs.

    python3 tests/torch_pixel_parting.py jax|torch [--estimator mad]
        [--influence huber] [--noise 0.02] [--lm 0.0] [--size 64x32]

Prints, per shard or rank, each row's iterations per level and
termination codes, where the two disagree on an accept decision, and
the largest pose difference. Where the ranks part in a way that makes
them call different collectives, the JAX run aborts in XLA's
all-reduce rendezvous and the port's in gloo (a collective mismatch):
the run then exits non-zero with that error. Off the t-distribution each
rank's error adds its own log(a c) (dvo_slam_tpu/ops/linearize.py:480),
which is why they can part.
"""

import argparse
import os
import sys

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=2")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

SCALES = (1.0, 0.5, -0.7, 1.3, 2.0, -1.5, 0.2, 3.0)


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=("jax", "torch"))
    ap.add_argument("--estimator", default="mad")
    ap.add_argument("--influence", default="huber")
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--lm", type=float, default=0.0)
    ap.add_argument("--size", default="64x32")
    return ap.parse_args(argv)


def inputs(a):
    """B = 8 pairs: one two-plane render against renders moved along one
    twist by SCALES, the current intensities with Gaussian noise (seed
    0)."""
    from dvo_slam_tpu.utils import se3_np, synthetic

    W, H = (int(x) for x in a.size.split("x"))
    scene = synthetic.two_plane_scene()
    K = np.asarray((W * 0.8, W * 0.8, (W - 1) / 2, (H - 1) / 2))
    xi = np.array([0.01, -0.005, 0.008, 0.004, -0.003, 0.005])
    i0, z0 = scene.render(K, W, H, np.eye(4))
    cur = [scene.render(K, W, H, se3_np.inverse(se3_np.exp(xi * s)))
           for s in SCALES]
    rng = np.random.default_rng(0)
    ci = np.stack([c[0] for c in cur]).astype(np.float32)
    ci = ci + rng.normal(scale=a.noise, size=ci.shape).astype(np.float32)
    return {"K": tuple(K), "ref_i": np.stack([i0] * len(cur)),
            "ref_z": np.stack([z0] * len(cur)).astype(np.float32),
            "cur_i": ci,
            "cur_z": np.stack([c[1] for c in cur]).astype(np.float32),
            "cfg": dict(num_levels=2, first_level=1, last_level=0,
                        max_iterations=20, scale_estimator=a.estimator,
                        influence=a.influence, lm_lambda_init=a.lm,
                        collect_stats=True)}


def torch_rank(rank, world, device, inp):
    import torch

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.ops import camera, pyramid
    from dvo_slam_tpu_torch.parallel import sharded

    cfg = TrackerConfig(**inp["cfg"])
    L = cfg.num_levels
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*inp["K"],
                                                     device="cpu"), L)

    def pyrs(ii, zz):
        p = [pyramid.build_pyramid(torch.from_numpy(i), torch.from_numpy(z),
                                   L) for i, z in zip(ii, zz)]
        return tuple(torch.stack(lvl) for lvl in zip(*p))

    refs = pyrs(inp["ref_i"], inp["ref_z"])
    curs = pyrs(inp["cur_i"], inp["cur_z"])
    B = refs[0].shape[0]
    mesh = sharded.make_mesh(world, 1, world)
    res = sharded.sharded_track_pairs(mesh, cfg)(
        sharded.shard_pyramid(refs, mesh), curs, Ks,
        torch.eye(4).expand(B, 4, 4).contiguous())
    return (res.transformation.numpy(), res.iterations.numpy(),
            res.stats.accepted.numpy(), res.stats.termination.numpy())


def run_jax(inp):
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from dvo_slam_tpu.config import TrackerConfig
    from dvo_slam_tpu.models import dense_tracker
    from dvo_slam_tpu.ops import camera, pyramid

    cfg = TrackerConfig(**inp["cfg"])
    L = cfg.num_levels
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*inp["K"]), L)

    def pyrs(ii, zz):
        p = [pyramid.build_pyramid(jnp.asarray(i), jnp.asarray(z), L)
             for i, z in zip(ii, zz)]
        return tuple(jnp.stack(lvl) for lvl in zip(*p))

    refs = pyrs(inp["ref_i"], inp["ref_z"])
    curs = pyrs(inp["cur_i"], inp["cur_z"])
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                ("batch", "pixel"))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(tuple(P(None, None, "pixel") for _ in range(L)),
                  tuple(P() for _ in range(L)), tuple(P() for _ in range(L)),
                  P()),
        out_specs=P("pixel"), check_vma=False)
    def fn(r, c, Ks, t):
        res = jax.vmap(lambda r, c, t: dense_tracker.track(
            r, c, Ks, t, cfg, axis_name="pixel"))(r, c, t)
        return (res.transformation[None], res.iterations[None],
                res.stats.accepted[None], res.stats.termination[None])

    T0 = jnp.broadcast_to(jnp.eye(4), (refs[0].shape[0], 4, 4))
    out = [np.asarray(x) for x in jax.jit(fn)(refs, curs, Ks, T0)]
    return [tuple(x[s] for x in out) for s in range(2)]


def main(argv):
    a = _args(argv)
    inp = inputs(a)
    if a.which == "jax":
        shards = run_jax(inp)
    else:
        from dvo_slam_tpu_torch import parallel

        shards = parallel.spawn(torch_rank, 2, "cpu", (inp,), timeout_s=300)
    (T0, it0, acc0, term0), (T1, it1, acc1, term1) = shards
    print(f"{a.which} {a.estimator} + {a.influence}, noise {a.noise}, "
          f"lm {a.lm}, {a.size}")
    print(f"  iterations: {it0.tolist()} | {it1.tolist()}")
    print(f"  termination: {term0.tolist()} | {term1.tolist()}")
    print(f"  accept decisions that differ (row, level, iteration): "
          f"{np.argwhere(acc0 != acc1).tolist()}")
    print(f"  max |T0 - T1| {np.abs(T0 - T1).max():.3e}")


if __name__ == "__main__":
    main(sys.argv[1:])
