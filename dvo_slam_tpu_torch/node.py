"""Live streaming SLAM/odometry node — the dvo_ros equivalent
(counterpart of ``dvo_slam_tpu/node.py``, with the same wire protocol byte
for byte: a client of either package works against a server of either).

The reference's live entry points are ROS nodes (SURVEY.md §2.3/S10:
camera_tracker / camera_keyframe_tracker subscribe synchronized RGB-D
topics and publish PoseWithCovarianceStamped + visualization topics).
This module provides the same live surface without ROS: a framed
socket protocol (Unix or TCP — the TCPROS stand-in) over which a client
streams RGB-D frames and receives per-frame pose messages back, plus the
same control surface the nodes expose (reset, force-keyframe, finish).

Wire protocol (newline-delimited JSON headers, raw payloads):

  client -> server, per frame:
      {"t": <timestamp>, "w": W, "h": H, "enc": "f32"|"raw"|"raw12"}\n
      enc "f32" (default, omitted for backward compat):
          W*H*4 bytes  float32 LE intensity (0..255)
          W*H*4 bytes  float32 LE depth (meters, NaN invalid)
      enc "raw" (sensor-native, 3 B/px — 2.7x less socket AND
      host->device traffic; conversion happens on the device):
          W*H bytes    uint8 intensity
          W*H*2 bytes  uint16 LE raw depth ticks (TUM 5000/m, 0 invalid)
      enc "raw12" (minimum bandwidth, 2.5 B/px; depth 12-bit packed by
      ops.pyramid.pack_depth12, +-1.6 mm quantization — far below sensor
      noise; device-side unpack fuses into the pyramid build):
          W*H bytes      uint8 intensity
          H*(3*W/2) bytes packed depth (W must be even)
  client -> server, control:
      {"cmd": "force_keyframe"}\n | {"cmd": "reset"}\n |
      {"cmd": "finish"}\n  (server replies with the full trajectory and
                           closes) | {"cmd": "trajectory"}\n |
      {"cmd": "configure", "tracker": {<TrackerConfig fields>},
       "slam": {<SlamConfig fields>}}\n
          (the dynamic_reconfigure equivalent: live-retune tracker AND
           SLAM-layer knobs — keyframe/loop-closure thresholds etc., the
           reference's dvo_slam::Config .cfg surface; pyramid geometry and
           padded-capacity fields are rejected mid-run — replies with the
           resulting configs or an error)
  server -> client, per frame (the PoseWithCovarianceStamped equivalent;
  also THE feed a live visualizer consumes — the rviz stand-in):
      {"t": ..., "pose": [16 floats, row-major T_world_cam],
       "keyframe": bool, "covariance": [36 floats]?,
       "cloud": {"points": [[x,y,z]...], "colors": [[r,g,b]...]}?}\n
          (cloud: downsampled world-frame keyframe point cloud, attached
           on keyframe frames when the server runs publish_clouds — the
           reference's PCL/rviz point-cloud topic equivalent)
  server -> client, on finish/trajectory:
      {"trajectory": [{"t": ..., "pose": [...]}, ...]}\n

Pub/sub (the `rgbd/pose` topic equivalent): a connection whose FIRST
message is {"cmd": "subscribe"}\n becomes a subscriber — it receives a
copy of every per-frame pose message from every camera session until it
disconnects. `view()` + `LiveTrajectoryVisualizer` make a live remote
trajectory viewer out of this feed (the rviz stand-in, SURVEY.md R3);
`serve(visualizer=...)` attaches one in-process instead (the reference
node's own marker publishing).

Chunked mode (`serve(chunk=N)` / `cli live --chunk N`): the latency/
throughput knob. Frames buffer host-side; every N run through the chunked
device-resident engine (issued with no host sync between frames) with a
depth-2 submit/collect pipeline, and the N pose messages arrive as a burst
up to 2N/30 s late — same wire format, same pub/sub feed, identical
trajectories (control commands flush pending frames first, and their
flushed pose messages precede the command reply). Clients pipeline sends
(StreamClient.send_frame_nowait + recv_msg) instead of awaiting one
reply per frame.

Everything device-side is the standard pipeline (KeyframeSlam /
ChunkedKeyframeSlam / OdometryTracker) on ``device`` ("cuda" unless the
caller asks for "cpu"); this file is transport only. Every session's
engine shares the card and its default stream; each connection is served
on its own thread.
"""

from __future__ import annotations

import json
import queue
import socket
import socketserver
import threading
from typing import Optional

import numpy as np
import torch


def _read_exact(rfile, n: int) -> bytes:
    """Read exactly n bytes from a buffered socket file (EOF -> error)."""
    data = rfile.read(n)
    if data is None or len(data) < n:
        raise ConnectionError("peer closed mid-message")
    return data


class _Subscriber:
    """One pose-feed subscriber: bounded queue + dedicated writer thread."""

    __slots__ = ("sock", "q", "thread")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.q: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=Broadcast.QUEUE_CAP
        )


class Broadcast:
    """Thread-safe fan-out of pose messages to subscriber sockets
    (the TCPROS publish side of the `rgbd/pose` topic).

    publish() only ENQUEUES: each subscriber has its own bounded queue
    drained by a dedicated writer thread, so the per-frame hot path never
    blocks on any subscriber's TCP buffer. A subscriber that trickles
    (staying under the send timeout, so it is never "dead") would
    otherwise rate-limit every camera session to the slowest viewer; now
    it just fills its own queue and gets dropped when it falls
    QUEUE_CAP messages behind — a live pose feed is only useful to a
    client that keeps up."""

    # Bound each low-level send so a fully-stalled subscriber's writer
    # thread fails out instead of blocking in sendall forever.
    SEND_TIMEOUT_S = 2.0
    # Messages a subscriber may fall behind before it is disconnected.
    QUEUE_CAP = 256

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: list[_Subscriber] = []

    def add(self, sock: socket.socket) -> None:
        sock.settimeout(self.SEND_TIMEOUT_S)
        sub = _Subscriber(sock)
        sub.thread = threading.Thread(
            target=self._writer, args=(sub,), daemon=True,
            name="pose-feed-writer",
        )
        with self._lock:
            self._subs.append(sub)
        sub.thread.start()

    def _writer(self, sub: _Subscriber) -> None:
        try:
            while True:
                data = sub.q.get()
                if data is None:  # close_all / overflow sentinel
                    break
                sub.sock.sendall(data)
        except OSError:  # includes TimeoutError: slow/stalled/hung up
            pass
        finally:
            with self._lock:
                if sub in self._subs:
                    self._subs.remove(sub)
            try:
                sub.sock.close()
            except OSError:
                pass

    def publish(self, msg: dict) -> None:
        with self._lock:
            subs = list(self._subs)
        if not subs:
            return
        data = (json.dumps(msg) + "\n").encode()
        for sub in subs:
            try:
                sub.q.put_nowait(data)
            except queue.Full:
                # QUEUE_CAP messages behind: disconnect. shutdown() (not
                # just close) WAKES a writer blocked inside sendall; its
                # cleanup then removes the subscriber from the list.
                try:
                    sub.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    sub.sock.close()
                except OSError:
                    pass

    def close_all(self) -> None:
        """Disconnect every subscriber (server shutdown): unblocks their
        reads with EOF and lets the writer threads exit."""
        with self._lock:
            subs = list(self._subs)
            self._subs.clear()
        for sub in subs:
            try:
                sub.q.put_nowait(None)
            except queue.Full:
                pass
            try:
                sub.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sub.sock.close()
            except OSError:
                pass


class SlamNode:
    """Session state for one connected camera stream.

    chunk > 0 (slam/keyframe modes) trades pose LATENCY for THROUGHPUT:
    frames buffer host-side and every `chunk` of them runs through the
    device-resident chunked scan engine (ChunkedKeyframeSlam), issued with
    no host sync between frames and read back in one copy, with a depth-2
    submit/collect pipeline (at most one chunk in flight). handle_frame
    then returns the pose messages of a COMPLETED chunk (usually none or
    `chunk` of them) — poses arrive up to 2*chunk/30 s late, the wire
    format and pub/sub surface unchanged. finish/trajectory/reset/
    force_keyframe flush the buffer first, so trajectories are identical to
    per-frame mode (tests/test_torch_node.py)."""

    def __init__(self, K, tracker_cfg=None, slam_cfg=None, mode="slam",
                 with_covariance=False, frame_logger=None, visualizer=None,
                 visualizer_lock=None, publish_clouds=False, chunk=0,
                 stage_eagerly=False, device="cuda"):
        from dvo_slam_tpu_torch.config import SlamConfig, TrackerConfig

        tracker_cfg = tracker_cfg or TrackerConfig()
        slam_cfg = slam_cfg or SlamConfig()
        self.mode = mode
        self.with_covariance = with_covariance
        self.publish_clouds = publish_clouds
        self.visualizer = visualizer
        # The visualizer may be shared by concurrent camera sessions in
        # the threaded server (serve passes one shared lock); matplotlib
        # rendering and the pose lists are not thread-safe.
        self._viz_lock = visualizer_lock or threading.Lock()
        self._K = np.asarray(K, np.float64).reshape(-1)[:4]
        self.chunk = int(chunk) if mode != "odometry" else 0
        self._buf: list = []  # buffered (t, i, z, host_or_None[, event])
        self._inflight: list = []  # submitted chunks' (t, host) lists
        self.device = torch.device(device)
        # Eager per-frame device staging (opt-in): upload each frame as it
        # arrives (a non-blocking copy from pinned host memory, one CUDA
        # event per staged frame) instead of one stacked upload per chunk.
        self.stage_eagerly = bool(stage_eagerly) and self.chunk > 0
        self._STAGE_WINDOW = 8  # max staged uploads in flight (eager mode)
        # monotonic() timestamp while inside one engine call, else None
        # (read by the serve-side stall watchdog — _stall_watchdog).
        self._busy_since = None
        if mode == "odometry":
            from dvo_slam_tpu_torch.models.odometry import OdometryTracker

            self.engine = OdometryTracker(
                K, tracker_cfg, collect_covariance=with_covariance,
                device=self.device,
            )
        else:
            from dvo_slam_tpu_torch.models.chunked_slam import (
                ChunkedKeyframeSlam,
            )
            from dvo_slam_tpu_torch.models.keyframe_tracker import (
                KeyframeSlam,
            )

            engine = ChunkedKeyframeSlam if self.chunk else KeyframeSlam
            self.engine = engine(
                K, tracker_cfg, slam_cfg,
                enable_loop_closure=(mode == "slam"),
                frame_logger=frame_logger,
                collect_covariance=with_covariance,
                device=self.device,
            )
        self.engine.init()

    def _frame_msg(self, t, pose, is_kf, cov=None, frame=None) -> dict:
        msg = {"t": t, "pose": np.asarray(pose).reshape(-1).tolist(),
               "keyframe": bool(is_kf)}
        if cov is not None:
            # Strict JSON has no NaN/Infinity tokens; a tracking-failure
            # frame's non-finite covariance would break non-Python
            # subscribers. Clamp to a huge variance ("unknown").
            cov = np.where(np.isfinite(cov), cov, 1e12)
            msg["covariance"] = cov.reshape(-1).tolist()
        if is_kf and frame is not None and (
                self.visualizer is not None or self.publish_clouds):
            from dvo_slam_tpu_torch.utils.visualization import (
                point_cloud_from_rgbd,
            )

            intensity, depth = frame
            # Raw-encoded sessions ("raw"/"raw12") carry sensor-native
            # dtypes; the cloud needs metric depth. Host conversion here
            # touches only keyframes with cloud/viz consumers attached.
            if depth.dtype == np.uint16:
                depth = np.where(depth > 0, depth / 5000.0, np.nan)
            elif depth.dtype == np.uint8:
                from dvo_slam_tpu_torch.ops.pyramid import unpack_depth12
                depth = unpack_depth12(torch.from_numpy(np.array(depth)),
                                       intensity.shape[-1]).numpy()
            pts, colors = point_cloud_from_rgbd(
                intensity, depth, self._K, np.asarray(pose), stride=8
            )
            if self.publish_clouds:
                # Downsampled world-frame keyframe cloud on the pose feed
                # (reference PCL/rviz point-cloud topic): remote viewers
                # render the map live, not just the trajectory.
                msg["cloud"] = {
                    "points": np.round(pts, 4).tolist(),
                    "colors": np.round(colors, 3).tolist(),
                }
        else:
            pts = colors = None
        if self.visualizer is not None:
            with self._viz_lock:
                self.visualizer.add_pose(t, np.asarray(pose), is_kf)
                if is_kf and pts is not None:
                    self.visualizer.add_point_cloud(pts, colors)
        return msg

    def handle_frame(self, t, intensity, depth) -> list:
        """Track one frame; returns the pose messages ready to send (one
        in per-frame mode; none or a full chunk's worth in chunked mode)."""
        import time

        self._busy_since = time.monotonic()
        try:
            return self._handle_frame(t, intensity, depth)
        finally:
            self._busy_since = None

    def _handle_frame(self, t, intensity, depth) -> list:
        if self.chunk:
            keep = (self.visualizer is not None or self.publish_clouds)
            host = (intensity, depth) if keep else None
            if self.stage_eagerly:
                # Eager per-frame staging: start the host->device copy the
                # moment the frame arrives, instead of letting
                # submit_chunk upload the whole stacked chunk at once —
                # each copy rides under the sensor interval (paced
                # sessions) or the previous chunk's compute. Flow control
                # caps un-landed copies at _STAGE_WINDOW: waiting on the
                # (window+1)-oldest frame's event costs nothing when the
                # copies keep up and paces intake when they do not.
                from dvo_slam_tpu_torch.models.chunked_slam import stage

                intensity = stage(intensity, self.device, (np.uint8,))
                depth = stage(depth, self.device, (np.uint16, np.uint8))
                event = None
                if self.device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record()
                self._buf.append((t, intensity, depth, host, event))
                if len(self._buf) > self._STAGE_WINDOW:
                    landed = self._buf[-(self._STAGE_WINDOW + 1)][4]
                    if landed is not None:
                        landed.synchronize()
            else:
                self._buf.append((t, intensity, depth, host))
            if len(self._buf) < self.chunk:
                return []
            return self._submit_buffered(collect_threshold=2)
        if self.mode == "odometry":
            pose = self.engine.update(intensity, depth, t)
            is_kf = False
        else:
            n_kf_before = len(self.engine.keyframes)
            pose = self.engine.update(intensity, depth, t)
            is_kf = len(self.engine.keyframes) > n_kf_before
        cov = (self.engine.covariances[-1][1]
               if self.with_covariance and self.engine.covariances else None)
        return [self._frame_msg(t, pose, is_kf, cov,
                                frame=(intensity, depth))]

    def _submit_buffered(self, collect_threshold: int) -> list:
        """Submit the buffered frames as one chunk; collect completed
        chunks down to collect_threshold-1 outstanding (2 = the depth-2
        pipeline: dispatch chunk k+1 before fetching chunk k)."""
        if self._buf:
            ts = [f[0] for f in self._buf]
            if self.stage_eagerly:
                # The frames were staged on arrival; the stack is a
                # device-side concat (no re-upload).
                stack = torch.stack
            else:
                # Burst mode: one stacked host array per chunk;
                # submit_chunk issues the single upload.
                stack = np.stack
            self.engine.submit_chunk(
                stack([f[1] for f in self._buf]),
                stack([f[2] for f in self._buf]),
                ts,
            )
            self._inflight.append([(f[0], f[3]) for f in self._buf])
            self._buf = []
        out = []
        while len(self._inflight) >= collect_threshold:
            frames = self._inflight.pop(0)
            poses = self.engine.collect_chunk()
            out.extend(self._chunk_msgs(frames, poses))
        return out

    def _flush(self) -> list:
        """Drain the buffer and every in-flight chunk (control commands
        and finish/trajectory need the engine caught up to the stream)."""
        return self._submit_buffered(collect_threshold=1)

    def _chunk_msgs(self, frames, poses) -> list:
        kf_times = {k.timestamp for k in self.engine.keyframes}
        covs = {}
        if self.with_covariance:
            covs = {t: c for t, c in self.engine.covariances}
        return [
            self._frame_msg(t, pose, t in kf_times, covs.get(t),
                            frame=host_frame)
            for (t, host_frame), pose in zip(frames, poses)
        ]

    # SlamConfig fields that size compiled/stored state: changing them on
    # a live map would orphan the padded graph / window / HBM budget.
    _FROZEN_SLAM = {"max_keyframes", "max_edges", "local_map_capacity"}

    def reconfigure(self, tracker_fields: dict,
                    slam_fields: Optional[dict] = None) -> dict:
        """Live-retune tracker AND SLAM knobs (reference dynamic_reconfigure:
        CameraDenseTracker.cfg + dvo_slam/cfg/*.cfg): rebuilds the frozen
        configs, which recompile on the next frame — the same semantics as
        the reference rebuilding its trackers on a reconfigure callback.
        Pyramid geometry and padded capacities cannot change mid-run
        (stored keyframe pyramids / the live graph were built with them)."""
        import dataclasses

        slam_fields = slam_fields or {}
        frozen = {"num_levels", "first_level", "last_level"}
        bad = frozen & set(tracker_fields)
        if bad:
            return {"error": f"cannot change {sorted(bad)} mid-run"}
        if self.mode == "odometry" and slam_fields:
            return {"error": "odometry mode has no slam config"}
        bad = self._FROZEN_SLAM & set(slam_fields)
        if bad:
            return {"error": f"cannot change {sorted(bad)} mid-run"}
        # Build EVERY replacement config before assigning any: a validation
        # error in a derived config (e.g. slam coarse levels that violate
        # TrackerConfig invariants) must leave the live engine untouched —
        # an error reply and a silently-retuned engine must never coexist.
        try:
            if self.mode == "odometry":
                new = dataclasses.replace(self.engine.cfg, **tracker_fields)
                self.engine.cfg = new
                return {"tracker": dataclasses.asdict(new)}
            new = dataclasses.replace(self.engine.tracker_cfg,
                                      **tracker_fields)
            new_slam = dataclasses.replace(self.engine.slam_cfg,
                                           **slam_fields)
            new_coarse = dataclasses.replace(
                self.engine.coarse_cfg,
                **{k: v for k, v in tracker_fields.items()
                   if k != "max_iterations"},
            )
            if slam_fields:
                # The coarse validation tracker derives from slam fields.
                new_coarse = dataclasses.replace(
                    new_coarse,
                    first_level=min(new_slam.coarse_first_level,
                                    new.num_levels - 1),
                    last_level=min(new_slam.coarse_last_level,
                                   new.num_levels - 1),
                    max_iterations=new_slam.coarse_max_iterations,
                )
        except (TypeError, ValueError, NotImplementedError) as e:
            return {"error": str(e)}
        self.engine.tracker_cfg = new
        self.engine.fine_cfg = new
        self.engine.coarse_cfg = new_coarse
        self.engine.slam_cfg = new_slam
        return {"tracker": dataclasses.asdict(new),
                "slam": dataclasses.asdict(new_slam)}

    def flush_pending(self) -> list:
        """Pose messages for any buffered/in-flight chunked frames ([] in
        per-frame modes). Control commands and reconfiguration flush
        first so the engine is caught up to the stream."""
        return self._flush() if self.chunk else []

    def handle_cmd(self, cmd: str) -> list:
        """Returns the messages to send, in order (possibly none). In
        chunked mode a control command first flushes pending frames, so
        their pose messages precede the command's reply; in per-frame
        mode no-reply commands still produce nothing — the framed
        protocol must not desynchronize."""
        import time

        self._busy_since = time.monotonic()
        try:
            return self._handle_cmd(cmd)
        finally:
            self._busy_since = None

    def _handle_cmd(self, cmd: str) -> list:
        out = self.flush_pending()
        if cmd == "force_keyframe":
            # In odometry mode (no keyframes) this is a silent no-op, not
            # an error message.
            if self.mode != "odometry":
                self.engine.force_keyframe()
            return out
        if cmd == "reset":
            if self.mode != "odometry":
                self.engine.reset()
            return out
        if cmd in ("finish", "trajectory"):
            if self.mode == "odometry":
                traj = self.engine.trajectory
            elif cmd == "finish":
                traj = self.engine.finish()
            else:
                traj = self.engine.trajectory()
            if cmd == "finish" and self.visualizer is not None:
                with self._viz_lock:
                    self.visualizer.finish()
            out.append({
                "trajectory": [
                    {"t": t, "pose": np.asarray(T).reshape(-1).tolist()}
                    for t, T in traj
                ]
            })
            return out
        out.append({"error": f"unknown/invalid command {cmd!r}"})
        return out


def _stall_watchdog(node: "SlamNode", broadcast: Optional[Broadcast],
                    timeout_s: float, stop: threading.Event,
                    poll_s: float = 1.0) -> None:
    """Failure detection for the live session (SURVEY §6): if one
    engine call (device dispatch/fetch) has been running for more than
    timeout_s, publish a {"event": "stall"} message on the pose feed
    and log to stderr — once per stuck call, warn-only (the first call
    on a card builds the kernels with nvcc, ~10 s; a later one stalling
    this long means the device or its transport wedged). Subscribers see
    the event instead of a silently frozen feed; the camera client still
    feels socket back-pressure, which is the only honest signal a one-way
    frame stream has."""
    import sys
    import time

    warned_episode = None
    while not stop.wait(poll_s):
        busy = node._busy_since
        if busy is None or busy == warned_episode:
            continue
        stalled = time.monotonic() - busy
        if stalled < timeout_s:
            continue
        warned_episode = busy
        msg = {"event": "stall", "stalled_s": round(stalled, 1),
               "detail": "engine call has not returned; device "
                         "transport may be wedged"}
        print(f"dvo node: engine call stalled {stalled:.0f}s "
              "(device transport wedged?)", file=sys.stderr)
        if broadcast is not None:
            broadcast.publish(msg)


def serve_connection(sock: socket.socket, node: SlamNode,
                     broadcast: Optional[Broadcast] = None,
                     first_header: Optional[dict] = None,
                     rfile=None, stall_timeout: float = 0.0) -> None:
    """Run one camera session over an accepted socket until finish/EOF.

    rfile: optional buffered reader already wrapping `sock` (headers and
    payloads then cost one syscall each instead of byte-wise recv on the
    per-frame hot path).
    stall_timeout: > 0 starts a watchdog that publishes a
    {"event": "stall"} pose-feed message when a single engine call
    exceeds that many seconds (see _stall_watchdog)."""
    owns_rfile = rfile is None
    if owns_rfile:
        rfile = sock.makefile("rb")
    stop_watch = None
    if stall_timeout > 0:
        stop_watch = threading.Event()
        threading.Thread(
            target=_stall_watchdog,
            args=(node, broadcast, stall_timeout, stop_watch),
            kwargs=dict(poll_s=min(1.0, stall_timeout / 4)),
            daemon=True, name="stall-watchdog",
        ).start()
    try:
        while True:
            if first_header is not None:
                header, first_header = first_header, None
            else:
                line = rfile.readline()
                if not line:
                    return
                header = json.loads(line)
            if "cmd" in header:
                if header["cmd"] == "configure":
                    msgs = node.flush_pending()
                    msgs.append(node.reconfigure(header.get("tracker", {}),
                                                 header.get("slam")))
                else:
                    msgs = node.handle_cmd(header["cmd"])
                for msg in msgs:
                    sock.sendall((json.dumps(msg) + "\n").encode())
                    # Flushed chunked pose messages belong on the pose
                    # feed too (subscribers see every per-frame pose).
                    if broadcast is not None and "pose" in msg:
                        broadcast.publish(msg)
                if header["cmd"] == "finish":
                    return
                continue
            w, h = int(header["w"]), int(header["h"])
            # Validate BEFORE reading the payload: a negative product
            # makes BufferedReader.read(-N) consume the stream to EOF
            # (silent desync), and a huge one is an unbounded allocation.
            if not (0 < w <= 16384 and 0 < h <= 16384):
                raise ConnectionError(f"implausible frame dims {w}x{h}")
            enc = header.get("enc", "f32")
            if enc == "f32":
                intensity = np.frombuffer(
                    _read_exact(rfile, w * h * 4), "<f4"
                ).reshape(h, w)
                depth = np.frombuffer(
                    _read_exact(rfile, w * h * 4), "<f4"
                ).reshape(h, w)
            elif enc in ("raw", "raw12"):
                # Sensor-native payloads stay raw end to end: the engines
                # pass uint8/uint16/packed-uint8 through to the device,
                # where build_pyramid converts (node.py is transport only).
                intensity = np.frombuffer(
                    _read_exact(rfile, w * h), np.uint8
                ).reshape(h, w)
                if enc == "raw":
                    depth = np.frombuffer(
                        _read_exact(rfile, w * h * 2), "<u2"
                    ).reshape(h, w)
                else:
                    if w % 2:
                        raise ConnectionError("raw12 needs even width")
                    depth = np.frombuffer(
                        _read_exact(rfile, h * (3 * w // 2)), np.uint8
                    ).reshape(h, 3 * w // 2)
            else:
                raise ConnectionError(f"unknown frame enc {enc!r}")
            for msg in node.handle_frame(float(header["t"]), intensity,
                                         depth):
                sock.sendall((json.dumps(msg) + "\n").encode())
                if broadcast is not None:
                    broadcast.publish(msg)
    finally:
        if stop_watch is not None:
            stop_watch.set()
        if owns_rfile:
            rfile.close()


def serve(address, K, tracker_cfg=None, slam_cfg=None, mode="slam",
          with_covariance=False, unix=False, max_sessions=None,
          visualizer=None, publish_clouds=False, chunk=0,
          stage_eagerly=False, stall_timeout=0.0, device="cuda"):
    """Accept camera sessions + subscribers (one SlamNode per camera).

    address: (host, port) for TCP or a filesystem path for unix=True.
    max_sessions: stop after N completed CAMERA sessions (tests / bounded
      runs); subscriber connections don't count.
    visualizer: optional TrajectoryVisualizerInterface driven in-process
      per frame (the reference node's own rviz publishing); remote viewers
      use subscribe/`view()` instead.
    publish_clouds: attach a downsampled world-frame keyframe point cloud
      to each keyframe's pose message (remote viewers render the live map
      — the reference's PCL point-cloud topic equivalent).
    chunk: > 0 runs camera sessions through the chunked engine — pose
      messages arrive in bursts up to 2*chunk frames late (see SlamNode).
      Clients must pipeline sends (StreamClient.send_frame_nowait) instead
      of awaiting one reply per frame.
    stage_eagerly: chunked sessions upload each frame on arrival instead
      of one upload per chunk (see SlamNode.stage_eagerly).
    stall_timeout: > 0 arms a per-session watchdog that publishes
      {"event": "stall"} on the pose feed (and logs) when one engine
      call runs longer than this many seconds — failure DETECTION for a
      wedged device; warn-only (cli live defaults it to 60 s; keep it
      above the first call's kernel build).
    device: where every session's engine runs ("cuda", the default, or
      "cpu"); a CUDA device without a card raises here, before listening.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"serve(device={device!r}): no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    broadcast = Broadcast()
    done = threading.Semaphore(0)
    viz_lock = threading.Lock()  # the visualizer is shared across sessions

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            rfile = self.request.makefile("rb")
            try:
                line = rfile.readline()
                if not line:
                    return
                header = json.loads(line)
                if header.get("cmd") == "subscribe":
                    broadcast.add(self.request)
                    # Hold the connection open until the subscriber leaves
                    # (subscribers never send after subscribing). The
                    # broadcast send-timeout applies to this recv too —
                    # an idle-but-healthy subscriber just keeps waiting.
                    try:
                        while True:
                            try:
                                if not self.request.recv(1):
                                    break
                            except TimeoutError:
                                continue
                    except OSError:
                        pass
                    return
                node = SlamNode(K, tracker_cfg, slam_cfg, mode,
                                with_covariance, visualizer=visualizer,
                                visualizer_lock=viz_lock,
                                publish_clouds=publish_clouds, chunk=chunk,
                                stage_eagerly=stage_eagerly, device=device)
                try:
                    serve_connection(self.request, node, broadcast,
                                     first_header=header, rfile=rfile,
                                     stall_timeout=stall_timeout)
                finally:
                    done.release()
            finally:
                rfile.close()

    base = (socketserver.UnixStreamServer if unix
            else socketserver.TCPServer)

    class Server(socketserver.ThreadingMixIn, base):
        daemon_threads = True
        allow_reuse_address = True

    if unix:
        # allow_reuse_address is a no-op for AF_UNIX: a socket file left
        # behind by an unclean exit would fail the bind forever.
        import os

        try:
            os.unlink(address)
        except FileNotFoundError:
            pass

    with Server(address, Handler) as server:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            if max_sessions is None:
                thread.join()
            else:
                for _ in range(max_sessions):
                    done.acquire()
        finally:
            server.shutdown()
            broadcast.close_all()


class StreamClient:
    """Minimal client for the node protocol (tests and tooling)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._rfile = sock.makefile("rb")
        # Pose messages that arrived while awaiting a command reply
        # (chunked servers flush pending frames before replying).
        self.pose_backlog: list = []

    @classmethod
    def connect_tcp(cls, host, port):
        return cls(socket.create_connection((host, port)))

    @classmethod
    def connect_unix(cls, path):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(path)
        return cls(s)

    def send_frame(self, t, intensity, depth, enc="f32") -> dict:
        """Send one frame and await its pose reply (per-frame servers
        ONLY — a chunked server replies in bursts; use send_frame_nowait
        + recv_msg there or this blocks until the chunk completes)."""
        self.send_frame_nowait(t, intensity, depth, enc=enc)
        return self.recv_msg()

    def send_frame_nowait(self, t, intensity, depth, enc="f32") -> None:
        """Send one frame without awaiting a reply (chunked servers reply
        in bursts; TCP buffers the pipeline).

        enc "f32" sends metric float frames (8 B/px). enc "raw" sends
        sensor-native uint8 intensity + uint16 depth ticks (3 B/px —
        operands must already be those dtypes, e.g. straight from the
        dataset loader). enc "raw12" additionally packs depth to 12 bits
        (2.5 B/px): pass uint16 ticks (packed here) or an already-packed
        (H, 3*W/2) uint8 plane."""
        h, w = intensity.shape
        if enc == "f32":
            payload = (np.ascontiguousarray(intensity, "<f4").tobytes()
                       + np.ascontiguousarray(depth, "<f4").tobytes())
        elif enc in ("raw", "raw12"):
            assert intensity.dtype == np.uint8, intensity.dtype
            if enc == "raw":
                assert depth.dtype == np.uint16, depth.dtype
                zb = np.ascontiguousarray(depth, "<u2").tobytes()
            else:
                if depth.dtype == np.uint16:
                    from dvo_slam_tpu_torch.ops.pyramid import pack_depth12
                    depth = pack_depth12(depth)
                assert depth.dtype == np.uint8 and \
                    depth.shape == (h, 3 * w // 2), depth.shape
                zb = np.ascontiguousarray(depth).tobytes()
            payload = np.ascontiguousarray(intensity).tobytes() + zb
        else:
            raise ValueError(f"unknown enc {enc!r}")
        header = json.dumps(
            {"t": float(t), "w": w, "h": h}
            | ({} if enc == "f32" else {"enc": enc})
        ) + "\n"
        self.sock.sendall(header.encode())
        self.sock.sendall(payload)

    def recv_msg(self) -> dict:
        """Read the next server message (pose burst element, command
        reply, or trajectory)."""
        return json.loads(self._rfile.readline())

    def command(self, cmd: str, expect_reply: bool) -> Optional[dict]:
        self.sock.sendall((json.dumps({"cmd": cmd}) + "\n").encode())
        if expect_reply:
            # A chunked server flushes pending pose messages before the
            # reply; keep them (pose_backlog) rather than losing frames.
            while True:
                msg = json.loads(self._rfile.readline())
                if "pose" not in msg:
                    return msg
                self.pose_backlog.append(msg)
        return None

    def configure(self, slam: Optional[dict] = None,
                  **tracker_fields) -> dict:
        body = {"cmd": "configure", "tracker": tracker_fields}
        if slam:
            body["slam"] = slam
        self.sock.sendall((json.dumps(body) + "\n").encode())
        return json.loads(self._rfile.readline())

    def subscribe(self):
        """Turn this connection into a pose subscriber; yields per-frame
        pose messages until the server closes the feed."""
        self.sock.sendall(b'{"cmd": "subscribe"}\n')
        while True:
            try:
                line = self._rfile.readline()
            except OSError:
                return
            if not line:
                return
            yield json.loads(line)

    def finish(self) -> dict:
        return self.command("finish", expect_reply=True)

    def close(self):
        try:
            self._rfile.close()
        finally:
            self.sock.close()


def view(address, visualizer, unix=False, max_poses=None) -> int:
    """Remote live trajectory viewer (the rviz stand-in): subscribe to a
    running node and drive a visualizer from its pose feed. Returns the
    number of poses consumed (feed closed or max_poses reached)."""
    client = (StreamClient.connect_unix(address) if unix
              else StreamClient.connect_tcp(*address))
    seen = 0
    try:
        for msg in client.subscribe():
            visualizer.add_pose(
                float(msg["t"]),
                np.asarray(msg["pose"], np.float64).reshape(4, 4),
                bool(msg.get("keyframe", False)),
            )
            if "cloud" in msg:
                visualizer.add_point_cloud(
                    np.asarray(msg["cloud"]["points"], np.float64),
                    np.asarray(msg["cloud"]["colors"], np.float64),
                )
            seen += 1
            if max_poses is not None and seen >= max_poses:
                break
    finally:
        client.close()
        visualizer.finish()
    return seen
