"""The port's live node (dvo_slam_tpu_torch/node.py) against the JAX
package's, over localhost unix sockets.

Counterparts of tests/test_node.py. In each (mode, chunk, encoding) case
the JAX node and the port node take the same 64x48 frames (a keyframe
forced mid-stream) and must publish the same pose messages: the same
timestamps, keyframe flags and count, poses and the finished trajectory
within TRAJ_ATOL. The wire protocol is checked across the packages: a JAX
client against a port server and a port client against a JAX server. Every
socket read has its own timeout, so no case can hang the suite.
"""

import dataclasses
import json
import os
import shutil
import socket
import tempfile
import threading
import time

import numpy as np
import pytest

from dvo_slam_tpu import node as j_node
from dvo_slam_tpu.config import SlamConfig, TrackerConfig
from dvo_slam_tpu.utils import evaluate, synthetic
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch import node

from test_torch_benchmark import one_torch_thread  # noqa: F401

W, H = 64, 48
K = (32.0, 32.0, (W - 1) / 2.0, (H - 1) / 2.0)
TRACKER = TrackerConfig(num_levels=2, first_level=1, last_level=0,
                        max_iterations=30)
SLAM = SlamConfig(max_keyframes=32, max_edges=128, min_constraint_distance=3,
                  coarse_first_level=1, coarse_last_level=1,
                  validation_batch=4)
T_TRACKER = convert.tracker_config_from_fields(dataclasses.asdict(TRACKER))
T_SLAM = convert.slam_config_from_fields(dataclasses.asdict(SLAM))
TRAJ_ATOL = 1e-4
TIMEOUT_S = 120.0  # any one socket read or thread join
N_FRAMES, FORCE_AT = 8, 4


def _frames(n=N_FRAMES, radius=0.05):
    poses = synthetic.orbit_trajectory(n, radius=radius)
    return synthetic.render_sequence(synthetic.two_plane_scene(),
                                     np.asarray(K), W, H, poses), poses


FRAMES, POSES = _frames()
RAW = [(np.clip(np.round(i), 0, 255).astype(np.uint8),
        np.nan_to_num(z * 5000.0, nan=0.0).astype(np.uint16))
       for i, z in FRAMES]


_SOCK_DIRS = []


def _sock(name):
    """A fresh unix socket path (short: AF_UNIX paths end at 108 bytes)."""
    _SOCK_DIRS.append(tempfile.mkdtemp(prefix="dvo"))
    return os.path.join(_SOCK_DIRS[-1], name + ".sock")


@pytest.fixture(scope="module", autouse=True)
def _remove_socket_dirs():
    yield
    for d in _SOCK_DIRS:
        shutil.rmtree(d, ignore_errors=True)


def _serve(pkg, path, mode="slam", **kw):
    """A server of package pkg ("jax" or "port") on a unix socket in a
    daemon thread, for one camera session."""
    if pkg == "jax":
        target = j_node.serve
        kw = dict(tracker_cfg=TRACKER, slam_cfg=SLAM, **kw)
    else:
        target = node.serve
        kw = dict(tracker_cfg=T_TRACKER, slam_cfg=T_SLAM, device="cpu", **kw)
    t = threading.Thread(target=target, args=(path, K),
                         kwargs=dict(mode=mode, unix=True, max_sessions=1,
                                     **kw), daemon=True)
    t.start()
    return t


def _connect(path, client_cls=node.StreamClient):
    deadline = time.monotonic() + TIMEOUT_S
    while True:
        try:
            client = client_cls.connect_unix(path)
            client.sock.settimeout(TIMEOUT_S)
            return client
        except (FileNotFoundError, ConnectionRefusedError):
            if time.monotonic() > deadline:
                raise TimeoutError(path)
            time.sleep(0.05)


def _join(thread):
    thread.join(timeout=TIMEOUT_S)
    assert not thread.is_alive(), "server thread did not end"


def _stream(client, chunk, enc, frames):
    """Send the frames (force_keyframe before frame FORCE_AT); returns
    (pose messages in arrival order, finish reply)."""
    msgs = []
    for i, (ii, zz) in enumerate(frames):
        if i == FORCE_AT:
            client.command("force_keyframe", expect_reply=False)
        if chunk:
            client.send_frame_nowait(i / 30.0, ii, zz, enc=enc)
        else:
            msgs.append(client.send_frame(i / 30.0, ii, zz, enc=enc))
    final = client.finish()
    return msgs + client.pose_backlog, final


def _session(pkg, mode, chunk, enc, client_cls=node.StreamClient):
    path = _sock(f"{pkg}-{mode}-{chunk}-{enc}")
    thread = _serve(pkg, path, mode=mode, chunk=chunk)
    client = _connect(path, client_cls)
    try:
        out = _stream(client, chunk, enc, FRAMES if enc == "f32" else RAW)
    finally:
        client.close()
    _join(thread)
    return out


def _poses(msgs):
    return [np.asarray(m["pose"]).reshape(4, 4) for m in msgs]


def _assert_same_feed(got, want):
    (g_msgs, g_final), (w_msgs, w_final) = got, want
    assert [m["t"] for m in g_msgs] == [m["t"] for m in w_msgs]
    assert [m["keyframe"] for m in g_msgs] == [m["keyframe"] for m in w_msgs]
    assert sorted(g_msgs[0]) == sorted(w_msgs[0])
    for a, b in zip(_poses(g_msgs), _poses(w_msgs)):
        np.testing.assert_allclose(a, b, atol=TRAJ_ATOL)
    g_traj, w_traj = g_final["trajectory"], w_final["trajectory"]
    assert [e["t"] for e in g_traj] == [e["t"] for e in w_traj]
    for a, b in zip(_poses(g_traj), _poses(w_traj)):
        np.testing.assert_allclose(a, b, atol=TRAJ_ATOL)


_JAX_FEEDS = {}


@pytest.mark.parametrize("enc", ["f32", "raw", "raw12"])
@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("mode", ["slam", "keyframe", "odometry"])
def test_port_node_publishes_the_jax_node_feed(mode, chunk, enc):
    """Each mode x chunk x wire encoding: the port node's pose messages
    and finished trajectory are the JAX node's on the same frames (one
    message per frame, in frame order; odometry ignores chunk)."""
    key = (mode, chunk if mode != "odometry" else 0, enc)
    if key not in _JAX_FEEDS:
        _JAX_FEEDS[key] = _session("jax", mode, key[1], enc)
    got = _session("port", mode, chunk, enc)
    _assert_same_feed(got, _JAX_FEEDS[key])
    msgs, final = got
    assert len(msgs) == len(final["trajectory"]) == N_FRAMES
    assert [m["t"] for m in msgs] == [i / 30.0 for i in range(N_FRAMES)]
    if mode != "odometry":
        assert msgs[0]["keyframe"] and msgs[FORCE_AT]["keyframe"]
    assert evaluate.ate_rmse(_poses(final["trajectory"]), POSES) < 0.005


@pytest.mark.parametrize("enc", ["f32", "raw12"])
def test_wire_jax_client_port_server(enc):
    """A JAX StreamClient drives a port server: the same feed as the port's
    own client."""
    got = _session("port", "slam", 4, enc, client_cls=j_node.StreamClient)
    want = _session("port", "slam", 4, enc)
    _assert_same_feed(got, want)


@pytest.mark.parametrize("enc", ["f32", "raw"])
def test_wire_port_client_jax_server(enc):
    """The port's StreamClient drives a JAX server: the same feed as the
    JAX package's own client."""
    got = _session("jax", "slam", 0, enc)
    want = _session("jax", "slam", 0, enc, client_cls=j_node.StreamClient)
    _assert_same_feed(got, want)


def test_serve_raises_without_a_card():
    """Nothing falls back: on a machine without a GPU, serve() and the
    node's engines refuse device="cuda" instead of running elsewhere."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node.serve(_sock("x"), K, T_TRACKER, T_SLAM, unix=True,
                   max_sessions=1)
    for chunk in (0, 4):
        with pytest.raises((RuntimeError, AssertionError)):
            node.SlamNode(K, T_TRACKER, T_SLAM, mode="slam", chunk=chunk)


def test_broadcast_drops_stalled_subscriber(monkeypatch):
    """A subscriber that stops reading is dropped after the send timeout
    instead of wedging publish (and every camera session)."""
    monkeypatch.setattr(node.Broadcast, "SEND_TIMEOUT_S", 0.2)
    bcast = node.Broadcast()
    stalled_srv, stalled_cli = socket.socketpair()
    healthy_srv, healthy_cli = socket.socketpair()
    for s in (stalled_srv, stalled_cli):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    bcast.add(stalled_srv)
    bcast.add(healthy_srv)
    msg = {"pose": list(range(2000))}  # ~10 KB per publish
    drained = []

    def drain():
        healthy_cli.settimeout(5.0)
        try:
            while True:
                chunk = healthy_cli.recv(65536)
                if not chunk:
                    break
                drained.append(chunk)
        except OSError:
            pass

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    start = time.monotonic()
    for _ in range(40):
        bcast.publish(msg)
    assert time.monotonic() - start < 2.0

    def live_socks():
        with bcast._lock:
            return [sub.sock for sub in bcast._subs]

    deadline = time.monotonic() + 5.0
    while stalled_srv in live_socks() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert stalled_srv not in live_socks()
    assert healthy_srv in live_socks()
    while (sum(c.count(b"\n") for c in drained) < 40
           and time.monotonic() < deadline):
        time.sleep(0.02)
    healthy_srv.close()
    t.join(timeout=5)
    lines = b"".join(drained).decode().strip().split("\n")
    assert len(lines) == 40
    assert all(json.loads(line)["pose"][:3] == [0, 1, 2] for line in lines)
    for s in (stalled_cli, healthy_cli):
        s.close()


def test_broadcast_drops_backlogged_subscriber(monkeypatch):
    """A subscriber that trickles (never hitting the send timeout) is
    dropped when it falls QUEUE_CAP messages behind."""
    monkeypatch.setattr(node.Broadcast, "QUEUE_CAP", 4)
    monkeypatch.setattr(node.Broadcast, "SEND_TIMEOUT_S", 30.0)
    bcast = node.Broadcast()
    srv, cli = socket.socketpair()
    for s in (srv, cli):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    bcast.add(srv)
    msg = {"pose": list(range(2000))}
    start = time.monotonic()
    for _ in range(30):
        bcast.publish(msg)
    assert time.monotonic() - start < 2.0
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        with bcast._lock:
            if not bcast._subs:
                break
        time.sleep(0.02)
    with bcast._lock:
        assert not bcast._subs
    cli.close()


def test_live_reconfigure_frozen_fields():
    """dynamic_reconfigure equivalent: tracker and SLAM knobs retune
    mid-stream; pyramid geometry and capacities are refused; an error
    leaves the engine untouched."""
    path = _sock("cfg")
    thread = _serve("port", path, publish_clouds=True)
    client = _connect(path)
    msg0 = client.send_frame(0.0, *FRAMES[0])
    assert msg0["keyframe"] and "cloud" in msg0
    pts = np.asarray(msg0["cloud"]["points"])
    assert pts.shape[1] == 3 and len(pts) >= 40 and np.isfinite(pts).all()
    assert np.asarray(msg0["cloud"]["colors"]).shape == pts.shape
    reply = client.configure(slam={"min_entropy_ratio": 0.8,
                                   "coarse_max_iterations": 10},
                             max_iterations=12, huber_k=2.0)
    assert reply["tracker"]["max_iterations"] == 12
    assert reply["tracker"]["huber_k"] == 2.0
    assert reply["slam"]["min_entropy_ratio"] == 0.8
    for bad in ({"num_levels": 3}, {"slam": {"max_keyframes": 64}},
                {"max_iterations": 40,
                 "slam": {"coarse_first_level": 0, "coarse_last_level": 1}},
                {"point_budget_fraction": 1.5}):
        assert "error" in client.configure(**bad)
    check = client.configure()
    assert check["tracker"]["max_iterations"] == 12
    assert check["slam"]["coarse_first_level"] != 0
    for i in range(1, 5):
        msg = client.send_frame(i / 30.0, *FRAMES[i])
        assert ("cloud" in msg) == bool(msg["keyframe"])
    assert len(client.finish()["trajectory"]) == 5
    client.close()
    _join(thread)


def test_live_rejects_malformed_frame_dims():
    """A negative or huge w*h drops the session (EOF) instead of
    desynchronizing the stream or allocating without bound."""
    path = _sock("bad")
    thread = _serve("port", path, mode="odometry")
    client = _connect(path)
    client.sock.sendall((json.dumps({"t": 0.0, "w": -1, "h": 4})
                         + "\n").encode())
    client.sock.settimeout(10.0)
    assert client.sock.recv(1) == b""
    client.close()
    _join(thread)


def test_live_covariance():
    """Per-frame covariance rides the pose messages (odometry and SLAM):
    the zero matrix on the anchor frame, a finite SPD one later."""
    for mode in ("odometry", "slam"):
        path = _sock(f"cov-{mode}")
        thread = _serve("port", path, mode=mode, with_covariance=True)
        client = _connect(path)
        msgs = [client.send_frame(i / 30.0, *FRAMES[i]) for i in range(5)]
        np.testing.assert_allclose(
            np.asarray(msgs[0]["covariance"]).reshape(6, 6), 0.0)
        cov = np.asarray(msgs[2]["covariance"]).reshape(6, 6)
        assert np.isfinite(cov).all() and (np.linalg.eigvalsh(cov) > 0).all()
        assert len(client.finish()["trajectory"]) == 5
        client.close()
        _join(thread)


def test_live_subscriber_and_visualizer(tmp_path):
    """Pub/sub + live viz (the rviz stand-in): a subscriber receives every
    camera pose message; the remote viewer and the node's in-process
    visualizer both write the trajectory."""
    from dvo_slam_tpu_torch.utils.visualization import (
        LiveTrajectoryVisualizer,
    )

    path = _sock("pub")
    server_viz = LiveTrajectoryVisualizer(str(tmp_path / "node_viz"),
                                          snapshot_every=2)
    thread = _serve("port", path, visualizer=server_viz)
    _connect(path).close()  # wait for the listener
    viewer_viz = LiveTrajectoryVisualizer(str(tmp_path / "viewer"),
                                          snapshot_every=3)
    viewer_out = {}
    viewer = threading.Thread(
        target=lambda: viewer_out.setdefault(
            "n", node.view(path, viewer_viz, unix=True)), daemon=True)
    viewer.start()
    time.sleep(0.3)  # let the subscriber register before frames flow
    client = _connect(path)
    sent = [np.asarray(client.send_frame(i / 30.0, *f)["pose"]).reshape(4, 4)
            for i, f in enumerate(FRAMES)]
    client.finish()
    client.close()
    _join(thread)
    _join(viewer)
    assert viewer_out["n"] == len(FRAMES) == len(viewer_viz.poses)
    for (_, T_sub), T_cam in zip(viewer_viz.poses, sent):
        np.testing.assert_allclose(T_sub, T_cam, atol=1e-12)
    for d in ("node_viz", "viewer"):
        assert (tmp_path / d / "trajectory.png").exists()
        lines = (tmp_path / d / "trajectory.txt").read_text().splitlines()
        assert len(lines) == len(FRAMES)
    assert (tmp_path / "node_viz" / "cloud_0000.ply").exists()


def test_chunked_staging_window_blocks_and_matches():
    """Eager staging (stage_eagerly=True) with a window smaller than the
    chunk: the trajectory is the per-frame node's."""
    chunked = node.SlamNode(K, T_TRACKER, T_SLAM, mode="slam", chunk=4,
                            stage_eagerly=True, device="cpu")
    chunked._STAGE_WINDOW = 2
    msgs = []
    for i, (ii, zz) in enumerate(FRAMES):
        msgs.extend(chunked.handle_frame(i / 30.0, ii, zz))
    msgs.extend(chunked._flush())
    traj_ck = chunked.engine.finish()
    per_frame = node.SlamNode(K, T_TRACKER, T_SLAM, mode="slam",
                              device="cpu")
    for i, (ii, zz) in enumerate(FRAMES):
        per_frame.handle_frame(i / 30.0, ii, zz)
    traj_pf = per_frame.engine.finish()
    assert [m["t"] for m in msgs] == [i / 30.0 for i in range(N_FRAMES)]
    assert len(traj_ck) == len(traj_pf) == N_FRAMES
    for (_, a), (_, b) in zip(traj_ck, traj_pf):
        np.testing.assert_allclose(a, b, atol=TRAJ_ATOL)


def test_stall_watchdog_publishes_event():
    """When one engine call exceeds stall_timeout the watchdog publishes
    {"event": "stall"} on the pose feed, warn-only: the session completes
    once the call returns."""
    n = node.SlamNode(K, T_TRACKER, T_SLAM, mode="slam", device="cpu")
    real_update = n.engine.update
    calls = {"k": 0}

    def slow_update(intensity, depth, t):
        calls["k"] += 1
        if calls["k"] == 2:
            time.sleep(1.2)  # one "wedged" engine call
        return real_update(intensity, depth, t)

    n.engine.update = slow_update
    broadcast = node.Broadcast()
    sub_srv, sub_cli = socket.socketpair()
    broadcast.add(sub_srv)
    cam_srv, cam_cli = socket.socketpair()
    t = threading.Thread(target=node.serve_connection,
                         args=(cam_srv, n, broadcast),
                         kwargs=dict(stall_timeout=0.4), daemon=True)
    t.start()
    client = node.StreamClient(cam_cli)
    client.sock.settimeout(TIMEOUT_S)
    for i, (ii, zz) in enumerate(FRAMES[:4]):
        client.send_frame_nowait(i / 30.0, ii, zz)
    assert len(client.finish()["trajectory"]) == 4
    _join(t)
    sub_cli.settimeout(10.0)
    feed = b""
    while b'"stall"' not in feed:
        feed += sub_cli.recv(65536)
    events = [json.loads(line) for line in feed.decode().splitlines()
              if '"event"' in line]
    assert any(e["event"] == "stall" and e["stalled_s"] >= 0.4
               for e in events)
    client.close()
    sub_cli.close()


def test_cli_live_and_viz(tmp_path):
    """`cli live --device cpu --unix ... --chunk 4` serves one session and
    `cli viz` renders its pose feed; `cli live` on a missing card exits 2
    with an error instead of running elsewhere."""
    import contextlib
    import io

    import torch

    from dvo_slam_tpu_torch import cli

    path = _sock("cli")
    tracker = ["--num-levels", "2", "--first-level", "1", "--last-level",
               "0", "--max-iterations", "30"]
    slam = ["--min-constraint-distance", "3", "--max-keyframes", "32",
            "--max-edges", "128"]
    rc = {}
    live = threading.Thread(target=lambda: rc.setdefault("live", cli.main(
        ["live", "--device", "cpu", "--unix", path, "--max-sessions", "1",
         "--intrinsics", *map(str, K), "--chunk", "4", "--stall-timeout",
         "0", *tracker, *slam])), daemon=True)
    live.start()
    _connect(path).close()  # wait for the listener
    out = str(tmp_path / "viz")
    viz = threading.Thread(target=lambda: rc.setdefault("viz", cli.main(
        ["viz", "--unix", path, "--out", out, "--max-poses",
         str(N_FRAMES)])), daemon=True)
    viz.start()
    time.sleep(0.3)  # let the subscriber register before frames flow
    client = _connect(path)
    msgs, final = _stream(client, 4, "f32", FRAMES)
    client.close()
    _join(live)
    _join(viz)
    assert rc == {"live": 0, "viz": 0}
    assert len(msgs) == len(final["trajectory"]) == N_FRAMES
    lines = (tmp_path / "viz" / "trajectory.txt").read_text().splitlines()
    assert len(lines) == N_FRAMES
    if not torch.cuda.is_available():
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert cli.main(["live", "--unix", _sock("none")]) == 2
        assert "no CUDA device" in err.getvalue()
