"""The live event stream of a local run (``slam/run.py --viz-ws``), port of
``mast3r_slam_tpu/serve/broadcast.py`` on the port's own WebSocket framing
(``serve/ws.py``).

``EventBroadcaster`` serves a WebSocket on a thread of its own: the
engine's ``on_event`` stream (``pose_update``, and ``new_keyframe`` with a
world point cloud) goes to every connected viewer
(``mast3r_slam_tpu_torch/viz/viewer.html?ws=...``), and the keyframe
events seen so far (at most ``history_limit``) are replayed to a viewer
that joins late, so the whole map appears at once.  The viewer's
``{"type": "control", ...}`` messages drive a ``RunControl`` that
``SLAM.run`` obeys.  ``stop`` sends each viewer the events pushed so far,
then closes its connection (1001) and the server.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import threading
import time
from typing import List, Optional

from . import ws


class RunControl:
    """Viewer -> engine run control: pause, single step, the confidence
    threshold and terminate.

    The engine calls ``proceed`` once a frame: it blocks while paused
    (taking one queued single step if there is one) and returns False once
    terminated.  ``conf_threshold`` filters the streamed keyframe point
    clouds and the final PLY export.  Its default is the engine's own filter
    without a viewer (conf > 1 + 1e-6), so attaching a viewer changes
    nothing that is streamed or exported until its slider moves."""

    def __init__(self, conf_threshold: float = 1.0 + 1e-6):
        self._lock = threading.Lock()
        self.paused = False
        self.terminated = False
        self.conf_threshold = conf_threshold
        self._steps = 0

    def update(self, msg: dict) -> None:
        """Apply one viewer control message (thread-safe)."""
        with self._lock:
            if "paused" in msg:
                self.paused = bool(msg["paused"])
            if msg.get("step"):
                self._steps += 1
            if "conf_threshold" in msg:
                self.conf_threshold = float(msg["conf_threshold"])
            if msg.get("terminate"):
                self.terminated = True

    def proceed(self, poll: float = 0.01) -> bool:
        """Block while paused; True: process one frame, False: stop."""
        while True:
            with self._lock:
                if self.terminated:
                    return False
                if not self.paused:
                    return True
                if self._steps > 0:
                    self._steps -= 1
                    return True
            time.sleep(poll)


class EventBroadcaster:
    """A WebSocket fan-out of engine events on its own thread and event loop,
    with keyframe replay to late joiners."""

    START_TIMEOUT = 60.0  # seconds; a start that takes longer raises
    FLUSH_TIMEOUT = 5.0  # seconds ``stop`` gives the viewers' sends

    def __init__(self, host: str = "127.0.0.1", port: int = 8765,
                 history_limit: int = 4096):
        self.host = host
        self.port = port
        self.history_limit = history_limit
        self.control = RunControl()  # the viewer -> engine backchannel
        self._history: List[str] = []  # serialised new_keyframe events
        self._history_lock = threading.Lock()
        self._clients: dict = {}  # viewer -> (its queue of payloads, its sender task)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._serve, name="viz-ws", daemon=True)
        self.bound_port: Optional[int] = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "EventBroadcaster":
        self._thread.start()
        # a loaded host can starve this thread for a while; a start that
        # never comes up fails here, not as a connect error downstream
        if not self._ready.wait(timeout=self.START_TIMEOUT):
            raise RuntimeError(f"EventBroadcaster failed to start within "
                               f"{self.START_TIMEOUT:.0f} s")
        if self._error is not None:
            raise RuntimeError(f"EventBroadcaster failed to start: {self._error!r}") \
                from self._error
        return self

    def stop(self) -> None:
        if self._loop is not None and self._thread.is_alive():
            flush = asyncio.run_coroutine_threadsafe(self._flush_and_close(), self._loop)
            try:
                flush.result(self.FLUSH_TIMEOUT + 1)
            except concurrent.futures.TimeoutError:
                pass  # a viewer that does not read is dropped
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)

    async def _flush_and_close(self) -> None:
        with self._history_lock:
            clients = list(self._clients.values())
        for out, _ in clients:
            out.put_nowait(None)  # after the last event: close
        senders = [task for _, task in clients]
        if senders:
            await asyncio.wait(senders, timeout=self.FLUSH_TIMEOUT)

    def _serve(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            server = loop.run_until_complete(ws.serve(self._handler, self.host, self.port))
        except OSError as e:  # the port is taken, say
            self._error = e
            self._ready.set()
            loop.close()
            return
        self.bound_port = server.sockets[0].getsockname()[1]
        self._loop = loop
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            server.close()
            tasks = asyncio.all_tasks(loop)
            for task in tasks:
                task.cancel()
            loop.run_until_complete(asyncio.gather(*tasks, return_exceptions=True))
            loop.close()

    async def _handler(self, sock: ws.WebSocket) -> None:
        # the replay and the live events go through one queue a viewer, in
        # order: the viewer is registered under the history's lock, so no
        # event falls between the replay and the live stream
        out: asyncio.Queue = asyncio.Queue()
        sender = asyncio.ensure_future(self._send_from(sock, out))
        with self._history_lock:
            for payload in self._history:
                out.put_nowait(payload)
            self._clients[sock] = (out, sender)
        try:
            async for raw in sock:
                # run control from the viewer: pause, step, threshold, terminate
                try:
                    msg = json.loads(raw)
                except (TypeError, ValueError):
                    continue
                if isinstance(msg, dict) and msg.get("type") == "control":
                    self.control.update(msg)
        finally:
            with self._history_lock:
                self._clients.pop(sock, None)
            sender.cancel()

    @staticmethod
    async def _send_from(sock: ws.WebSocket, out: asyncio.Queue) -> None:
        try:
            while True:
                payload = await out.get()
                if payload is None:  # the broadcaster stops
                    await sock.close(1001, "the run ended")
                    return
                await sock.send(payload)
        except ws.ConnectionClosed:
            pass  # the viewer went away; its handler unregisters it

    # -- engine-facing ----------------------------------------------------

    def push(self, event: dict) -> None:
        """The engine's event sink (``SLAM.on_event``): thread-safe and
        non-blocking."""
        payload = json.dumps(event)
        with self._history_lock:
            if event.get("type") == "new_keyframe":
                self._history.append(payload)
                if len(self._history) > self.history_limit:
                    self._history = self._history[-self.history_limit:]
            queues = [out for out, _ in self._clients.values()]
            if queues:  # queued in the order of the pushes
                self._loop.call_soon_threadsafe(
                    lambda: [q.put_nowait(payload) for q in queues])
