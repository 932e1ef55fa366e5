"""The benchmark's traffic, window arithmetic, discovery and imports, on
the CPU."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, roofline
from portbench.metrics import (device_idle_pct, device_records_per_frame,
                               pose_graph_ms_per_seq,
                               track_level_roofline)
from portbench.tests import tiny
from portbench.trace import Record, Trace, breakdown
from portbench.traffic import fleet_segments, scene

ROOT = Path(__file__).resolve().parents[2]
BIG_SEED = 2**31 + 977


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _frames(seed, n=3, w=40, h=30):
    cfg = harness.load_cell("slam.desk16")["config"]
    cam = dict(cfg["camera"], width=w, height=h)
    poses = scene.orbit(n, 0.5, 0.6, n / 120)
    i = torch.empty((n, h, w), dtype=torch.uint8)
    z = torch.empty((n, h, w), dtype=torch.uint16)
    scene.frames(cfg["protocol"], cam, poses, scene.generator(seed, "cpu"),
                 i, z)
    return i, z


def test_frames_are_the_same_for_a_seed_and_differ_across_seeds():
    a, b = _frames(BIG_SEED), _frames(BIG_SEED)
    c = _frames(BIG_SEED + 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[1], c[1])


def test_fleet_frames_are_one_set_and_the_seed_orders_the_segments():
    a, b, c = (fleet_segments.Driver(
        dict(tiny.fleet(ring_frames=17), seed=s), device="cpu")
        for s in (BIG_SEED, BIG_SEED, BIG_SEED + 1))
    assert torch.equal(a.ring_i, b.ring_i) and torch.equal(a.ring_z, b.ring_z)
    assert a.starts == b.starts
    assert a.starts != c.starts and sorted(a.starts) == sorted(c.starts)
    assert sorted(a.starts) == [0, 4, 8, 12]
    # The checked segments are the first of the seed's order, rendered
    # with the seed's noise; every other frame is the one set's.
    F = a.p["frames_per_call"]
    for d in (a, c):
        assert d.check_starts == sorted(d.starts[:2])
    fresh = set()
    for d in (a, c):
        fresh |= {k for st in d.check_starts for k in range(st, st + F)}
    same = [k for k in range(17) if k not in fresh]
    assert same
    assert torch.equal(a.ring_i[:, same], c.ring_i[:, same])
    assert torch.equal(a.ring_z[:, same], c.ring_z[:, same])
    for st in a.check_starts:
        seg = slice(st, st + F)
        assert not torch.equal(a.ring_i[:, seg], c.ring_i[:, seg])


def test_render_and_orbit_match_the_numpy_renderer():
    from dvo_slam_tpu_torch.utils import synthetic

    W, H = 32, 24
    K = (20.7, 20.66, 15.5, 11.5)
    gt = synthetic.orbit_trajectory(5, radius=0.5, yaw_amplitude=0.6,
                                    cycles=5 / 120)
    poses = scene.orbit(5, 0.5, 0.6, 5 / 120)
    np.testing.assert_allclose(poses.numpy(), np.stack(gt), atol=1e-12)
    i, z = scene.render(K, W, H, poses, scene.two_plane_scene())
    sc = synthetic.two_plane_scene(sharpness=1.0)
    for k, T in enumerate(gt):
        ni, nz = sc.render(np.asarray(K), W, H, T)
        np.testing.assert_array_equal(np.isnan(nz), torch.isnan(z[k]).numpy())
        np.testing.assert_allclose(z[k].numpy(), nz, rtol=1e-6)
        np.testing.assert_allclose(i[k].numpy(), ni, atol=1e-3)


def test_corruption_has_the_protocol_statistics():
    noise = harness.load_cell("slam.desk16")["config"]["protocol"]["noise"]
    shape = (200, 200)
    flat_i = torch.full(shape, 128.0)
    flat_z = torch.full(shape, 2.0)
    i8, z16 = scene.corrupt(flat_i, flat_z, scene.generator(BIG_SEED, "cpu"),
                            noise["intensity_std"], noise["depth_rel_std"],
                            noise["dropout"])
    assert i8.dtype == torch.uint8 and z16.dtype == torch.uint16
    assert abs(float(i8.float().std()) - noise["intensity_std"]) < 0.3
    dropped = float((z16.to(torch.int32) == 0).float().mean())
    assert abs(dropped - noise["dropout"]) < 0.01
    kept = z16.to(torch.int32)[z16.to(torch.int32) > 0].float() / 5000.0
    assert abs(float(kept.std()) / 2.0 - noise["depth_rel_std"]) < 0.002


def _window(driver, seconds, stall_call=None, stall_s=0.0):
    calls = []
    real = driver.track

    def track(*a, **kw):
        calls.append(1)
        if len(calls) == stall_call:
            time.sleep(stall_s)
        return real(*a, **kw)

    driver.track = track
    from portbench.trace import Tracer

    try:
        w = driver.run(seconds, Tracer(False))
    finally:
        driver.track = real
    return w["returned"] / w["window_s"], harness.p95(w["latencies_s"]), w


def test_rate_and_tail_cover_the_whole_window():
    cell = dict(tiny.fleet(), seed=BIG_SEED)
    driver = fleet_segments.Driver(cell, device="cpu")
    fps, tail, w = _window(driver, 1.5)
    calls = len(w["calls"])
    stall = 3.0 * w["window_s"] / calls + 1.0
    fps_s, tail_s, w_s = _window(driver, 1.5, stall_call=2, stall_s=stall)
    assert w_s["window_s"] >= stall
    assert fps_s < fps * 0.8
    # One stalled call of several carries more than 5 % of the frames.
    assert len(w_s["calls"]) < 20
    assert tail_s >= stall
    assert tail < stall


def test_p95_is_the_order_statistic_of_all_values():
    v = list(range(101))
    assert harness.p95(v) == 95.0
    assert harness.p95([3.0]) == 3.0
    assert harness.p95([0.0, 10.0]) == pytest.approx(9.5)


def test_level_kernel_bytes_by_hand():
    slab1 = 6 * 240 * 320 * 4
    assert roofline.track_level_bytes(
        8, 240, 320, roofline.SLAB_MODELS["own_pairs"]) == \
        16 * slab1 + 8 * 2 * 16 * 4
    assert roofline.track_level_bytes(
        2, 240, 320, roofline.SLAB_MODELS["shared_side"]) == \
        3 * slab1 + 2 * 2 * 16 * 4
    assert roofline.level_of_cluster(640, 480, [1, 2, 3]) == \
        {16: 1, 8: 2, 4: 3}
    # Two levels that need the same cluster cannot be told apart.
    assert roofline.level_of_cluster(2560, 1920, [0, 1]) == {}


def _trace(device, info, spans=()):
    return Trace(device=list(device), spans=list(spans), window=(0.0, 1000.0),
                 info=info)


def test_readers_by_hand():
    cam = {"width": 640, "height": 480}
    recs = [Record("void track_level_kernel<false>(Params)", 0.0, 100.0,
                   {"grid": [16, 8, 1]}),
            Record("void track_level_kernel<false>(Params)", 100.0, 150.0,
                   {"grid": [4, 8, 1]}),
            Record("Memcpy DtoH (Device -> Pinned)", 400.0, 410.0, {}),
            Record("pose_graph_kernel", 600.0, 700.0, {})]
    info = {"camera": cam, "tracked_levels": [1, 2, 3], "frames": 8,
            "slab_model": "own_pairs", "sequences": 2}
    tr = _trace(recs, info, [Record("fleet.track", 0.0, 390.0, {}),
                             Record("fleet.readback", 390.0, 420.0, {})])
    least = (roofline.track_level_bytes(8, 240, 320, lambda b: 2 * b)
             + roofline.track_level_bytes(8, 60, 80, lambda b: 2 * b)) \
        / roofline.PEAK_BYTES_S
    assert track_level_roofline.read(tr) == pytest.approx(
        100 * least / 150e-6)
    assert device_records_per_frame.read(tr) == 4 / 8
    assert device_idle_pct.read(tr) == pytest.approx(100 * (1 - 260 / 1000))
    assert pose_graph_ms_per_seq.read(tr) == pytest.approx(0.1 / 2)
    bd = breakdown(tr)
    assert bd["device_ops"][0] == ["void track_level_kernel<false>(Params)",
                                   pytest.approx(150e-6)]
    assert bd["idle_gaps"][0] == ["harness", pytest.approx(300e-6)]
    assert ["fleet.track", pytest.approx(250e-6)] in bd["idle_gaps"]
    # Nothing to read: no value, never a zero share.
    empty = _trace([], {"camera": cam, "tracked_levels": [1, 2, 3],
                        "slab_model": "own_pairs"})
    assert track_level_roofline.read(empty) is None
    assert pose_graph_ms_per_seq.read(empty) is None
    assert device_records_per_frame.read(empty) is None
    # A launch whose grid names no tracked level fails the run.
    odd = _trace([Record("void track_level_kernel<false>(Params)", 0.0, 10.0,
                         {"grid": [2, 8, 1]})], info)
    with pytest.raises(harness.RunError, match="no tracked level"):
        track_level_roofline.read(odd)


def test_a_new_workload_and_metric_are_found_from_files_alone():
    name = f"zz_probe_{os.getpid()}"
    work = harness.HERE / "workloads" / f"{name}.json"
    mix = harness.HERE / "traffic" / f"{name}.json"
    metric = harness.HERE / "metrics" / f"{name}.py"
    try:
        spec = json.loads((harness.HERE / "traffic" /
                           "fleet8.json").read_text())
        spec["params"]["streams"] = 3
        mix.write_text(json.dumps(spec))
        work.write_text(json.dumps({"config": "fr1_vo", "traffic": name,
                                    "chips": 1, "why": "a probe",
                                    "limits": {"pose_gap": 1.0}}))
        metric.write_text('UNIT = "%"\n\n\ndef read(trace):\n'
                          '    return 1.5\n')
        cell = harness.load_cell(name)
        assert cell["params"]["streams"] == 3
        assert cell["driver"] == "fleet_segments"
        assert cell["config"]["name"] == "fr1_vo"
        readers = harness.metric_readers()
        assert readers[name].read(None) == 1.5
        assert set(readers) >= {"device_idle_pct", "device_records_per_frame",
                                "pose_graph_ms_per_seq",
                                "track_level_roofline"}
    finally:
        for path in (work, mix, metric):
            path.unlink(missing_ok=True)
        sys.modules.pop(f"portbench.metrics.{name}", None)


def test_the_harness_and_the_reference_load_no_jax():
    code = (
        "import sys\n"
        "from portbench import harness, control, run, trace, roofline\n"
        "from portbench.reference import evaluate, pose_graph, pyramid, "
        "scan, se3, tracker\n"
        "from portbench.traffic import chunked_replay, fleet_segments, scene\n"
        "harness.metric_readers()\n"
        "import dvo_slam_tpu_torch.models.chunked_slam\n"
        "import dvo_slam_tpu_torch.parallel.batch_slam\n"
        "print(harness.banned_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        text = path.read_text()
        for name in ("dvo_slam_tpu", "jax"):
            assert f"import {name}" not in text, path
            assert f"from {name}" not in text, path


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_a_run_without_a_card_prints_no_result():
    out = _run(ROOT, "--workload", "vo.fleet8", "--seed", str(BIG_SEED),
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_run_beside_only_the_benchmark_fails(tmp_path):
    """Without the program, even past the look for a card, a run ends
    with an error and no result."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path, "--workload", "vo.fleet8", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from portbench import harness\n"
            "from portbench.tests import tiny\n"
            "harness.run(tiny.fleet(), 1, 0.1, 0, time.perf_counter(), "
            "device='cpu')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "dvo_slam_tpu_torch" in out.stderr

