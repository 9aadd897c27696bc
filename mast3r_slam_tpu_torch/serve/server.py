"""The live SLAM session server (port of ``mast3r_slam_tpu/serve/server.py``)
on the port's own WebSocket framing (``serve/ws.py``) and image decoders.

    python -m mast3r_slam_tpu_torch.serve.server --port 8765 --config base

A client asks ``GET /connect`` for a session id, opens ``/ws/{id}`` (or
``/ws`` for a fresh id), streams frames in as base64 JPEG or PNG, and
receives the engine's events; ``GET /active_sessions`` lists the running
sessions and ``GET /`` answers with a message.  A finished session exports
its keyframe trajectory (TUM) and PLY reconstruction into ``--output-dir``;
a session idle for ``--idle-timeout`` seconds is terminated, and marked
wedged if its engine thread does not come back.

Protocol (JSON text messages), the JAX server's:

  client -> {"type": "frame", "data": <base64 JPEG/PNG>, "timestamp": optional}
            {"type": "close"}
            {"type": "active_sessions"}
  server -> {"type": "ready", "session_id"}
            {"type": "pose_update", "frame_id", "timestamp", "pose": [8], "mode"}
            {"type": "new_keyframe", "keyframe_index", "frame_id", "pose",
             "points": [[x, y, z]...], "colors": [[r, g, b]...]}
            {"type": "fps_update", "fps"}            (every 10 frames)
            {"type": "trajectory_saved" / "reconstruction_saved", "path"}
            {"type": "shutdown_complete", "n_keyframes", "n_frames"}
            {"type": "error", "message"}

Each session runs its own engine on a thread, fed by a bounded queue that
drops the oldest frame when full (live video), built by the factory from
the first frame's size.  The sessions share the card.

Kept apart from the JAX server on purpose: a session drains its backend
(``join_backend`` and the speculative gate's verdicts) before it exports,
and stops the backend's worker thread after, as ``SLAM.run`` does at its
end; the JAX session exports while a backend task may still run and leaves
the worker thread alive (ROADMAP Queue 3).  A frame that does not decode is
answered with an ``error`` event and dropped; the session goes on.
"""

from __future__ import annotations

import asyncio
import base64
import json
import pathlib
import queue
import sys
import threading
import time
import uuid
from typing import Dict, Optional

import numpy as np

from . import ws


class SlamSession:
    """One streaming session: frames in, events out, the engine on a thread."""

    def __init__(self, slam_factory, session_id: Optional[str] = None,
                 max_queue: int = 8, output_dir=None):
        self.session_id = session_id or str(uuid.uuid4())
        self.slam_factory = slam_factory
        self.output_dir = pathlib.Path(output_dir) if output_dir else None
        self.frame_q: queue.Queue = queue.Queue(maxsize=max_queue)
        self.event_q: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._run, name=f"session-{self.session_id[:8]}",
                                       daemon=True)
        self.running = False
        self.wedged = False
        self._closing = threading.Event()  # no more frames: finish the queued ones
        self._abandon = threading.Event()  # terminate: skip the queued frames
        self.slam = None
        self.created = time.time()
        self.last_activity = time.time()
        self._frame_counter = 0

    def start(self):
        self.running = True
        self.thread.start()

    def submit_frame(self, rgb01: np.ndarray, timestamp: Optional[str] = None) -> int:
        """Queue a frame without blocking; when the queue is full the oldest
        queued frame is dropped (live mode)."""
        fid = self._frame_counter
        self._frame_counter += 1
        self.last_activity = time.time()
        item = (fid, timestamp or f"{time.time():.6f}", rgb01)
        try:
            self.frame_q.put_nowait(item)
        except queue.Full:
            try:
                self.frame_q.get_nowait()
            except queue.Empty:  # the engine took it meanwhile
                pass
            self.frame_q.put_nowait(item)  # only the engine takes: room now
        return fid

    def close(self):
        """End the stream without blocking: the engine finishes the queued
        frames, exports and reports ``shutdown_complete``.  The stop is the
        ``_closing`` event, which the engine reads whenever the queue is
        empty; the sentinel only wakes an engine waiting on an empty queue,
        so a full queue needs none."""
        self._closing.set()
        try:
            self.frame_q.put_nowait(None)
        except queue.Full:
            pass

    def terminate(self, timeout: float = 10.0) -> bool:
        """Close, drop the queued frames, and wait up to ``timeout`` seconds
        for the engine thread; a thread that does not come back is abandoned
        (a thread cannot be killed) and the session marked wedged."""
        self._abandon.set()
        self.close()
        self.thread.join(timeout)
        if self.thread.is_alive():
            self.wedged = True
            self.running = False
            self.event_q.put({"type": "error",
                              "message": f"session {self.session_id} wedged; abandoned"})
            self.event_q.put(None)
            return False
        return True

    def _export(self, slam):
        """The session's keyframe trajectory and PLY, after its backend has
        drained (see the module docstring)."""
        if self.output_dir is None or slam is None or not len(slam.keyframes):
            return
        from ..eval.export import save_reconstruction
        from ..eval.trajectory import save_traj_tum
        from ..lie import sim3

        out = self.output_dir
        out.mkdir(parents=True, exist_ok=True)
        kf = slam.keyframes
        n = len(kf)
        traj_path = out / f"{self.session_id}.txt"
        ts = [str(int(kf.frame_id[i])) for i in range(n)]
        save_traj_tum(traj_path, ts, sim3.to_se3(kf.T_WC[:n]).cpu().numpy())
        self.event_q.put({"type": "trajectory_saved", "path": str(traj_path)})
        ply_path = out / f"{self.session_id}.ply"
        save_reconstruction(ply_path, kf, slam.img_hw, conf_threshold=1.5,
                            use_calib=bool(slam.cfg.get("use_calib", False)))
        self.event_q.put({"type": "reconstruction_saved", "path": str(ply_path)})

    def _run(self):
        slam = None
        last_T = None
        n_done = 0
        t0 = time.time()
        try:
            while not self._abandon.is_set():
                if self._closing.is_set() and self.frame_q.empty():
                    break
                item = self.frame_q.get()
                if item is None:
                    break
                fid, ts, rgb = item
                if slam is None:  # sized from the first frame
                    slam = self.slam_factory(rgb.shape[:2])
                    slam.on_event = self.event_q.put
                    self.slam = slam
                frame = slam.process_frame(fid, ts, rgb, last_T_WC=last_T)
                last_T = frame.T_WC
                n_done += 1
                self.last_activity = time.time()
                if n_done % 10 == 0:
                    self.event_q.put({"type": "fps_update",
                                      "fps": n_done / max(time.time() - t0, 1e-6)})
        except Exception as e:  # the engine's error goes to the client
            self.event_q.put({"type": "error", "message": repr(e)})
        finally:
            try:
                if slam is not None:
                    slam.join_backend()
                    slam.graph.resolve_pending_verdicts()
                    errors = list(slam.backend_errors)
                    if errors:
                        self.event_q.put({"type": "error",
                                          "message": f"backend task failed: {errors[0]!r}"})
                self._export(slam)
            except Exception as e:
                self.event_q.put({"type": "error", "message": f"export failed: {e!r}"})
            finally:
                if slam is not None:
                    slam.close()
            self.running = False
            self.event_q.put({"type": "shutdown_complete",
                              "n_keyframes": len(slam.keyframes) if slam else 0,
                              "n_frames": n_done})
            self.event_q.put(None)


def decode_image_payload(data_b64: str) -> np.ndarray:
    """A base64 JPEG or PNG -> float32 RGB (H, W, 3) in [0, 1], told apart by
    their magic bytes: PNG through ``data/png.py``, JPEG through the host
    library's decoder (``csrc/host/jpeg.cpp``).  Gray is replicated and
    alpha dropped, as ``cv2.imdecode(..., IMREAD_COLOR)`` does.  Other bytes
    raise ``ValueError``, and so does a JPEG that ``cv2.imdecode`` returns
    nothing for (a one-component lossless JPEG among them: its colour read
    would need a conversion libjpeg-turbo refuses in lossless mode); JPEG
    sampling factors the decoder does not take raise
    ``NotImplementedError``."""
    from ..data import png

    raw = base64.b64decode(data_b64)
    if raw.startswith(png.SIGNATURE):
        img = png.to_rgb(png.decode_png(raw))
    elif raw.startswith(png.JPEG_MAGIC):
        from ..utils.native import decode_jpeg

        img = decode_jpeg(raw)
    else:
        raise ValueError(f"frame payload is neither PNG nor JPEG (starts {raw[:8]!r})")
    return img.astype(np.float32) / 255.0


class SlamServer:
    """The session registry, its WebSocket endpoint and the REST answers."""

    def __init__(self, slam_factory, host: str = "0.0.0.0", port: int = 8765,
                 output_dir=None, idle_timeout: Optional[float] = 300.0,
                 reap_interval: float = 30.0):
        self.slam_factory = slam_factory
        self.host = host
        self.port = port
        self.output_dir = output_dir
        self.idle_timeout = idle_timeout
        self.reap_interval = reap_interval
        self.sessions: Dict[str, SlamSession] = {}
        self.pending_ids: set = set()  # ids handed out by /connect, awaiting their socket
        self.reaped: list = []  # (session id, wedged) of every reaped session
        self.bound_port: Optional[int] = None
        self._lock = threading.Lock()
        self._server = None
        self._reaper = None

    # -- REST --------------------------------------------------------------

    def connect_info(self) -> dict:
        """GET /connect: a fresh session id."""
        sid = str(uuid.uuid4())
        with self._lock:
            self.pending_ids.add(sid)
        return {"sessionId": sid,
                "message": f"Connect WebSocket to /ws/{sid} and stream frames."}

    def active_sessions(self) -> dict:
        """GET /active_sessions."""
        now = time.time()
        with self._lock:
            sessions = [{"session_id": sid, "running": s.running, "wedged": s.wedged,
                         "frames_submitted": s._frame_counter,
                         "keyframes": len(s.slam.keyframes) if s.slam else 0,
                         "age_s": round(now - s.created, 1),
                         "idle_s": round(now - s.last_activity, 1)}
                        for sid, s in self.sessions.items()]
        return {"active_sessions_count": len(sessions), "sessions": sessions}

    def http_answer(self, path: str):
        """The plain HTTP answers; None lets /ws and /ws/{id} upgrade."""
        path = path.split("?")[0]
        if path == "/connect":
            return 200, (json.dumps(self.connect_info()) + "\n").encode()
        if path == "/active_sessions":
            return 200, (json.dumps(self.active_sessions()) + "\n").encode()
        if path == "/":
            return 200, (json.dumps({"message": "mast3r-slam-tpu-torch serving"})
                         + "\n").encode()
        if path == "/ws" or path.startswith("/ws/"):
            return None
        return 404, b'{"error": "not found"}\n'

    # -- sessions ----------------------------------------------------------

    def reap_idle_sessions(self, now: Optional[float] = None) -> list:
        """Terminate the sessions idle past ``idle_timeout``; returns their ids."""
        if self.idle_timeout is None:
            return []
        now = now or time.time()
        with self._lock:
            stale = [(sid, s) for sid, s in self.sessions.items()
                     if s.running and now - s.last_activity > self.idle_timeout]
        reaped = []
        for sid, s in stale:
            s.terminate(timeout=10.0)
            reaped.append(sid)
        with self._lock:
            for sid, s in stale:
                self.sessions.pop(sid, None)
                self.reaped.append((sid, s.wedged))
        return reaped

    async def handle(self, sock: ws.WebSocket):
        # the id from /ws/{id}, or a fresh one for a bare /ws
        parts = sock.path.split("?")[0].strip("/").split("/")
        sid = parts[1] if len(parts) == 2 and parts[0] == "ws" and parts[1] else None
        with self._lock:
            self.pending_ids.discard(sid)
        session = SlamSession(self.slam_factory, session_id=sid, output_dir=self.output_dir)
        with self._lock:
            self.sessions[session.session_id] = session
        session.start()
        loop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()

        def pump():
            # the session's events onto the loop, on a thread of the session's
            # own: a blocking get in the loop's executor would hold one of its
            # threads for the session's life, and enough sessions would starve
            # the reaper, which runs there
            while True:
                ev = session.event_q.get()
                try:
                    loop.call_soon_threadsafe(events.put_nowait, ev)
                except RuntimeError:  # the loop has closed
                    return
                if ev is None:
                    return

        threading.Thread(target=pump, name=f"events-{session.session_id[:8]}",
                         daemon=True).start()

        async def forward_events():
            # a client gone mid-session stops the sends, not the draining
            connected = True
            while True:
                ev = await events.get()
                if ev is None:
                    return
                if connected:
                    try:
                        await sock.send(json.dumps(ev))
                    except ws.ConnectionClosed:
                        connected = False

        forwarder = asyncio.ensure_future(forward_events())
        try:
            await sock.send(json.dumps({"type": "ready", "session_id": session.session_id}))
            async for message in sock:
                try:
                    msg = json.loads(message)
                except ValueError:
                    await sock.send(json.dumps({"type": "error",
                                                "message": "message is not JSON"}))
                    continue
                mtype = msg.get("type")
                if mtype in ("frame", "FRAME"):
                    try:
                        rgb = decode_image_payload(msg.get("data") or msg["payload"])
                    except (KeyError, ValueError, NotImplementedError) as e:
                        await sock.send(json.dumps({"type": "error",
                                                    "message": f"frame dropped: {e}"}))
                        continue
                    ts = msg.get("timestamp")
                    session.submit_frame(rgb, None if ts is None else str(ts))
                elif mtype == "close":
                    break
                elif mtype == "active_sessions":
                    await sock.send(json.dumps({"type": "active_sessions",
                                                **self.active_sessions()}))
        finally:
            session.close()
            await forwarder
            with self._lock:
                self.sessions.pop(session.session_id, None)

    # -- serving -------------------------------------------------------------

    async def listen(self):
        """Start listening (port 0: any free port, read back as ``bound_port``)
        and the idle reaper."""
        self._server = await ws.serve(self.handle, self.host, self.port, http=self.http_answer)
        self.bound_port = self._server.sockets[0].getsockname()[1]
        self._reaper = asyncio.ensure_future(self._reap_loop())
        return self._server

    async def _reap_loop(self):
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.reap_interval)
            for sid in await loop.run_in_executor(None, self.reap_idle_sessions):
                print(f"reaped idle/wedged session {sid}", flush=True)

    async def aclose(self):
        """Stop the reaper and the listener."""
        if self._reaper is not None:
            self._reaper.cancel()
            await asyncio.gather(self._reaper, return_exceptions=True)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self):
        await self.listen()
        try:
            await asyncio.Future()
        finally:
            await self.aclose()

    def run(self):
        asyncio.run(self.serve_forever())


def default_slam_factory(cfg=None, checkpoint=None, preset="vit_large", device=None):
    """A factory of engines sized to a stream's first frame: one model and
    ``SLAM`` a session, random weights from seed 0 or ``checkpoint``
    (``.npz`` or ``.pth``).  On the card unless ``device`` says otherwise;
    without a device on a machine without CUDA this raises at once."""
    from ..config import load_config
    from ..device import resolve_device

    device = resolve_device(device)
    cfg = cfg or load_config("base")

    def make(raw_hw):
        from ..slam.pipeline import SLAM
        from ..slam.run import build_model
        from ..utils.image import resize_geometry

        size = int(cfg.get("engine", {}).get("resize", 512))
        _, (x0, y0, x1, y1) = resize_geometry(int(raw_hw[1]), int(raw_hw[0]), size)
        hw = (y1 - y0, x1 - x0)
        model = build_model(cfg, hw, checkpoint=checkpoint, preset=preset, device=device)
        return SLAM(model, cfg, hw, device=device)

    return make


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="SLAM WebSocket session server on a CUDA card")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--config", default="base")
    p.add_argument("--output-dir", default="logs/sessions",
                   help="end-of-session trajectory/PLY export dir")
    p.add_argument("--idle-timeout", type=float, default=300.0,
                   help="terminate sessions idle this long (s)")
    p.add_argument("--model-preset", default="vit_large", choices=["vit_large", "tiny"])
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from ..config import load_config

    factory = default_slam_factory(cfg=load_config(args.config),
                                   checkpoint=args.checkpoint or None,
                                   preset=args.model_preset, device=args.device)
    server = SlamServer(factory, host=args.host, port=args.port,
                        output_dir=args.output_dir, idle_timeout=args.idle_timeout)
    print(f"SLAM server on ws://{args.host}:{args.port} "
          f"(REST: GET /connect, GET /active_sessions)", file=sys.stderr)
    server.run()


if __name__ == "__main__":
    main()
