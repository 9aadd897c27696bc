"""The SLAM engine (port of ``slam/pipeline.py``).

``SLAM`` runs the INIT / TRACKING / RELOC mode machine frame by frame.
After every new keyframe a backend task runs: with a ``RetrievalDatabase``,
a query of the new keyframe that then adds it; edges from the retrieved
keyframes and the previous one to the new one through
``FactorGraph.add_factors`` (with the tracker's captured match under
``local_opt.reuse_tracker_match``); then ``FactorGraph.solve`` over all
keyframe poses.  A frame in RELOC mode queries the database, appends itself
as a keyframe, and keeps it (snapped to the best candidate's pose, then
solved) if its reloc edges pass, or pops it.  Without retrieval there are
no loop-closure edges and relocalisation fails, as in the JAX package.

The engine modes:

- ``single_thread: True`` runs each backend task in line;
  ``single_thread: False`` (the ``base`` default) hands it to a worker
  thread through a queue, so tracking goes on while it runs.  On CUDA the
  worker runs on a stream of its own; the keyframe store's snapshots and
  write-backs carry the waits between the two streams, and the worker's
  stream is synchronised at the end of every task.  ``backend_lock``
  serialises backend tasks against relocalisation (both change the graph
  and the database); tracking never takes it.  A failed task is printed
  and kept in ``backend_errors``.
- ``engine.pipeline: 0`` is the sequential loop; ``1`` the pipelined loop
  (``_loop_pipelined``), which issues the next frame's decode and tracking
  chained on the previous frame's outputs before reading its decision and
  gives the sequential loop's poses bit for bit; ``2`` (the tracker's
  compute on a second card) falls back to ``1`` on one card and raises on
  more (ROADMAP Queue 1, item 12).

``run`` reads and preprocesses frames on a prefetch thread (decode,
undistortion and the resize overlap the card's work; its time is the
``ingest`` stage), at most ``PREFETCH_DEPTH`` frames ahead; an error there
ends the run with that error.  ``preprocess`` resizes to 512 with the host
library (``utils/native.py``) and to other sizes with PIL.

``mesh`` and ``device_keyframes`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
import traceback
from collections import deque
from contextlib import closing, contextmanager
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..eval.trajectory import save_traj_tum
from ..lie import sim3
from ..retrieval.database import RetrievalDatabase
from ..utils import native
from ..utils.timing import StageTimer
from .factor_graph import FactorGraph
from .frame import Frame, Keyframes, Mode
from .tracker import FrameTracker


PREFETCH_DEPTH = 2  # frames the ingest thread reads ahead


@dataclasses.dataclass
class SlamResult:
    keyframe_timestamps: List[str]
    keyframe_poses: np.ndarray  # (K, 8) Sim3
    frame_timestamps: List[str]
    frame_poses: np.ndarray     # (F, 8)
    fps: float
    n_keyframes: int
    n_reloc: int
    n_reloc_success: int


def _check_ported(cfg, retrieval):
    engine = cfg.get("engine", {})
    for key, item in (("mesh", "ROADMAP Queue 1, item 12: multi-GPU"),
                      ("device_keyframes", "ROADMAP Queue 1, item 8: keyframe paging")):
        if int(engine.get(key, 0) or 0) != 0:
            raise NotImplementedError(f"engine.{key}: {engine[key]!r} is not ported yet ({item})")
    if retrieval is not None and not isinstance(retrieval, RetrievalDatabase):
        raise TypeError(
            f"retrieval is a {type(retrieval).__name__}; the port takes its own "
            "mast3r_slam_tpu_torch.retrieval.RetrievalDatabase")


def _pipeline_mode(cfg) -> int:
    """``engine.pipeline``: 2 falls back to 1 with fewer than two cards, as
    in the JAX package, and raises with more."""
    mode = int(cfg["engine"].get("pipeline", 0) or 0)
    if mode >= 2:
        if torch.cuda.device_count() >= 2:
            raise NotImplementedError(
                "engine.pipeline: 2 on more than one card (the tracker's compute on a "
                "second card) is not ported yet (ROADMAP Queue 1, item 12: multi-GPU)")
        print("engine.pipeline: fewer than 2 devices; "
              "running single-chip host-pipelined (pipeline: 1)")
        mode = 1
    return mode


class SLAM:
    """Single-session SLAM over a stream of frames, on the card unless told otherwise."""

    def __init__(self, model, cfg, img_hw, K=None, keyframe_buffer=None,
                 retrieval=None, device: DeviceLike = None):
        _check_ported(cfg, retrieval)
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.img_hw = tuple(img_hw)
        self.retrieval = retrieval
        cap = keyframe_buffer or cfg["engine"]["keyframe_buffer"]
        self.keyframes = Keyframes(
            capacity=cap,
            num_pixels=img_hw[0] * img_hw[1],
            num_patches=model.num_patches,
            feat_dim=model.feat_dim,
            device=self.device,
        )
        if K is not None:
            self.keyframes.K = torch.as_tensor(K, dtype=torch.float32, device=self.device)
        self.tracker = FrameTracker(model, cfg, self.keyframes, img_hw, self.device)
        self.graph = FactorGraph(model, cfg, self.keyframes, img_hw, K=self.keyframes.K,
                                 edge_capacity=cfg["engine"].get("edge_buffer", 1024))
        self.pipeline = _pipeline_mode(cfg)
        self._reuse_match = bool(cfg["local_opt"].get("reuse_tracker_match", False))
        self.mode = Mode.INIT
        self.n_reloc = 0
        self.n_reloc_success = 0
        self.frame_log: List[tuple] = []  # (timestamp, T_WC np (8,))
        self.timer = StageTimer()

        # the threaded backend (single_thread: False)
        self.backend_lock = threading.RLock()
        self.backend_errors: List[BaseException] = []
        self.single_thread = bool(cfg.get("single_thread", True))
        self._frontend_stream = (torch.cuda.current_stream(self.device)
                                 if self.device.type == "cuda" else None)
        self._backend_stream = None
        self._tasks: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        if not self.single_thread:
            if self.device.type == "cuda":
                self._backend_stream = torch.cuda.Stream(self.device)
            self._tasks = queue.Queue()
            self._worker = threading.Thread(target=self._backend_loop,
                                            name="slam-backend", daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    # the backend
    # ------------------------------------------------------------------

    def _backend_loop(self):
        while True:
            task = self._tasks.get()
            try:
                if task is None:
                    return
                kf_idx, capture = task
                with self.timer.time("backend.update"):
                    self._backend_update(kf_idx, capture)
            except Exception as e:  # the worker must outlive a failed task
                print(f"backend task failed: {e!r}", file=sys.stderr)
                traceback.print_exc(file=sys.stderr)
                self.backend_errors.append(e)
            finally:
                self._tasks.task_done()

    def join_backend(self):
        """Wait until every queued backend task has run."""
        if self._tasks is not None:
            self._tasks.join()

    def close(self):
        """Drain the backend and stop its worker thread."""
        if self._worker is not None:
            self._tasks.put(None)
            self._worker.join()
            self._worker = None
            self._tasks = None

    @contextmanager
    def _on_backend_stream(self, *inputs):
        """Run backend work (a task, a relocalisation) on the backend's CUDA
        stream, after the frontend's work so far, and wait for it at the
        end.  A no-op without a worker or without CUDA."""
        if self._backend_stream is None:
            yield
            return
        self._backend_stream.wait_stream(self._frontend_stream)
        for t in inputs:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(self._backend_stream)
        try:
            with torch.cuda.stream(self._backend_stream):
                yield
        finally:
            self._backend_stream.synchronize()

    def _submit_backend(self, kf_idx: int, capture=None):
        """Queue a backend task for the worker, or run it in line."""
        if self._tasks is not None:
            self._tasks.put((kf_idx, capture))
            return
        with self.timer.time("backend.update"):
            self._backend_update(kf_idx, capture)

    def _backend_update(self, kf_idx: int, capture=None):
        """One backend task under ``backend_lock``: the store is read through
        snapshots and written back under its own lock, so tracking goes on."""
        with self.backend_lock, self._on_backend_stream(*(capture or ())[1:]):
            self._backend_update_impl(kf_idx, capture)

    # ------------------------------------------------------------------

    def preprocess(self, rgb01: np.ndarray) -> dict:
        """Resize and normalise one RGB frame on the host: to ``engine.resize``
        (512 unless set) by the host library at 512, by PIL otherwise."""
        size = int(self.cfg.get("engine", {}).get("resize", 512))
        if size == 512:
            return native.resize_img_native(rgb01, size)
        from ..utils.pil_image import resize_img

        return resize_img(rgb01, size)

    def ingest_rgb(self, frame_id: int, timestamp: str, rgb01: np.ndarray = None,
                   T_WC_init=None, pre: dict = None) -> Frame:
        """Encode one RGB frame (optionally already preprocessed)."""
        r = pre if pre is not None else self.preprocess(rgb01)
        img = torch.as_tensor(r["img"], device=self.device)[None]
        feat, pos = self.model.encode(img)
        T = (T_WC_init if T_WC_init is not None
             else sim3.identity(device=self.device))
        return Frame(frame_id=frame_id, img=img[0], T_WC=T, feat=feat, pos=pos,
                     uimg=r.get("unnormalized_img"))

    def _backend_update_impl(self, kf_idx: int, capture=None):
        """Retrieval candidates and the previous keyframe, edges from them to
        the new keyframe, then the global solve (run_backend,
        main.py:96-143)."""
        cfg = self.cfg
        candidates = set()
        if self.retrieval is not None:
            with self.timer.time("backend.retrieval"):
                candidates.update(self.retrieval.update(
                    self.keyframes.get_frame(kf_idx), add_after_query=True,
                    k=cfg["retrieval"]["k"], min_thresh=cfg["retrieval"]["min_thresh"],
                    kf_index=kf_idx))
        if kf_idx >= 1:
            candidates.add(kf_idx - 1)
        candidates.discard(kf_idx)
        kf_idxs = sorted(candidates)
        if not kf_idxs:
            return
        captures = None
        if capture is not None and capture[0] == kf_idx - 1:
            captures = {(capture[0], kf_idx): capture[1:]}
        with self.timer.time("backend.add_factors"):
            self.graph.add_factors(kf_idxs, [kf_idx] * len(kf_idxs),
                                   cfg["local_opt"]["min_match_frac"], captures=captures)
        with self.timer.time("backend.solve"):
            self.graph.solve()

    def _relocalize(self, frame: Frame) -> bool:
        """Retrieval-driven relocalisation (main.py:28-71); without retrieval
        it fails."""
        if self.retrieval is None:
            return False
        with self.backend_lock, self._on_backend_stream(frame.T_WC, frame.X_canon, frame.C,
                                                        frame.feat, frame.pos):
            return self._relocalize_locked(frame)

    def _relocalize_locked(self, frame: Frame) -> bool:
        cfg = self.cfg
        with self.timer.time("reloc.retrieval"):
            inds, pre = self.retrieval.query(frame, k=cfg["retrieval"]["k"],
                                             min_thresh=cfg["retrieval"]["min_thresh"])
        if not inds:
            return False
        kf_idx = self.keyframes.append(frame)
        # the new keyframe is ii and the retrieved ones jj, so the
        # always-keep rule of consecutive edges never applies
        ok = self.graph.add_factors([kf_idx] * len(inds), list(inds),
                                    cfg["reloc"]["min_match_frac"], is_reloc=True,
                                    strict=cfg["reloc"]["strict"])
        if not ok:  # nothing was stored: drop the keyframe again
            self.keyframes.pop_last()
            return False
        self.retrieval.add(frame, precomputed=pre, kf_index=kf_idx)
        # snap to the best candidate's pose before the solve moves the store
        T = self.keyframes.pose(inds[0])
        self.keyframes.update_pose(kf_idx, T)
        frame.T_WC = T
        frame.T_WC_np = None
        self.graph.solve()
        return True

    def process_frame(self, frame_id: int, timestamp: str, rgb01: np.ndarray = None,
                      last_T_WC=None, pre: dict = None) -> Frame:
        """Advance the mode machine by one frame (main.py:233-310)."""
        with self.timer.time("ingest+encode"):
            frame = self.ingest_rgb(frame_id, timestamp, rgb01, T_WC_init=last_T_WC,
                                    pre=pre)
        if self.mode in (Mode.INIT, Mode.RELOC):
            self._process_nontracking(frame, timestamp)
            return frame
        with self.timer.time("tracker.track"):
            new_kf, try_reloc = self.tracker.track(frame)
        self._after_track(frame, timestamp, new_kf, try_reloc)
        return frame

    def _after_track(self, frame: Frame, timestamp, new_kf: bool, try_reloc: bool):
        if try_reloc:
            self.mode = Mode.RELOC
            self._log(timestamp, frame)
            return
        if new_kf:
            kf_idx = self.keyframes.append(frame)
            # the tracker's own match becomes the consecutive edge's backward half
            self._submit_backend(
                kf_idx, self.tracker.last_match_capture if self._reuse_match else None)
        self._log(timestamp, frame)

    def _log(self, timestamp, frame: Frame):
        T = frame.T_WC_np
        if T is None:
            T = frame.T_WC.detach().cpu().numpy()
        self.frame_log.append((timestamp, T))

    def _process_nontracking(self, frame: Frame, timestamp):
        """INIT / RELOC handling of an ingested frame."""
        X, C = self.model.mono(frame.feat, frame.pos)
        frame.update_pointmap(
            X.reshape(-1, 3), C.reshape(-1, 1),
            mode=self.cfg["tracking"]["filtering_mode"],
            score_mode=self.cfg["tracking"]["filtering_score"])
        if self.mode == Mode.INIT:
            self.keyframes.append(frame)
            if self.retrieval is not None:
                self._submit_backend(0)  # adds the first keyframe to the database
            self.mode = Mode.TRACKING
            self._log(timestamp, frame)
            return
        self.n_reloc += 1
        if self._relocalize(frame):
            self.n_reloc_success += 1
            self.mode = Mode.TRACKING
            self.tracker.reset_idx_f2k()
        self._log(timestamp, frame)

    # ------------------------------------------------------------------

    def run(self, dataset, max_frames: Optional[int] = None,
            verbose: bool = True) -> SlamResult:
        """Track every frame of ``dataset`` in order, then wait for the
        backend.  A dataset may supply preprocessed frames through a
        ``preprocessed(i)`` hook."""
        n = len(dataset)
        if max_frames is not None:
            n = min(n, max_frames)
        t0 = time.time()
        with closing(self._prefetch(dataset, n)) as frames:
            if self.pipeline >= 1:
                self._loop_pipelined(frames, n, t0, verbose)
            else:
                last_T = None
                for i, timestamp, pre in frames:
                    # frame.latency: the frame's wall time, stalls behind a
                    # backend task included
                    with self.timer.time("frame.latency"):
                        frame = self.process_frame(i, timestamp, last_T_WC=last_T,
                                                   pre=pre)
                        if frame.T_WC_np is None and frame.T_WC.is_cuda:
                            torch.cuda.synchronize(frame.T_WC.device)
                    last_T = frame.T_WC
                    self._progress(i, n, t0, verbose)
        self.join_backend()
        self.graph.resolve_pending_verdicts()  # the speculative gate's verdicts
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0

        kf = self.keyframes
        kf_ts = [dataset.timestamps[int(kf.frame_id[i])] for i in range(len(kf))]
        return SlamResult(
            keyframe_timestamps=kf_ts,
            keyframe_poses=kf.T_WC[: len(kf)].cpu().numpy(),
            frame_timestamps=[t for t, _ in self.frame_log],
            frame_poses=(np.stack([p for _, p in self.frame_log]) if self.frame_log
                         else np.zeros((0, 8))),
            fps=n / wall if wall > 0 else 0.0,
            n_keyframes=len(kf),
            n_reloc=self.n_reloc,
            n_reloc_success=self.n_reloc_success,
        )

    def _prefetch(self, dataset, n: int):
        """Yield (i, timestamp, preprocessed frame) for the first n frames,
        read on a fetcher thread (``dataset.preprocessed(i)`` where the
        dataset has that hook).  An exception on the fetcher is raised here;
        closing the generator stops the fetcher."""
        get_pre = getattr(dataset, "preprocessed", None)
        fetched: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    fetched.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def fetch():
            try:
                for i in range(n):
                    if stop.is_set():
                        return
                    with self.timer.time("ingest"):
                        timestamp, img = dataset[i]
                        pre = get_pre(i) if get_pre is not None else self.preprocess(img)
                    put((i, timestamp, pre))
                put(None)
            except BaseException as e:  # handed to the consumer, raised there
                put(e)

        fetcher = threading.Thread(target=fetch, name="slam-ingest", daemon=True)
        fetcher.start()
        try:
            while True:
                item = fetched.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            fetcher.join()

    def save_trajectory(self, path, result: SlamResult):
        """The keyframe trajectory as a TUM file (SE(3): the scale dropped)."""
        poses = sim3.to_se3(torch.as_tensor(np.asarray(result.keyframe_poses))).numpy()
        save_traj_tum(path, result.keyframe_timestamps, poses)

    def _progress(self, i: int, n: int, t0: float, verbose: bool):
        if verbose and i % 30 == 0 and i > 0:
            fps = i / (time.time() - t0)
            print(f"frame {i}/{n}  kf={len(self.keyframes)}  {fps:.2f} fps")

    def _loop_pipelined(self, frames, n: int, t0: float, verbose: bool):
        """The pipelined frontend (``engine.pipeline: 1``).  For frame i, in
        order: encode and the decode against the current keyframe
        (``infer``); ``track_submit_chained`` on frame i-1's outputs; then
        ``track_finish`` of frame i-1, the read of its decision.  The chain
        assumes a clean commit of i-1; on a keyframe switch, relocalisation
        or GN failure the chained submit is discarded and re-run from the
        committed state, so every pose is the sequential loop's.
        ``engine.chain: false`` finishes i-1 before submitting i.  INIT and
        RELOC frames drain the pipeline and run as in the sequential loop.
        Every frame starts from the last finished frame's pose, as the
        sequential loop's warm start."""
        pend = deque()  # (frame index, timestamp, tracker pending), oldest first
        chain_ok = bool(self.cfg["engine"].get("chain", True))
        last_done = None  # the most recent frame with a committed pose

        def finish_oldest():
            nonlocal last_done
            _, ts0, p0 = pend.popleft()
            new_kf, try_reloc = self.tracker.track_finish(p0)
            self._after_track(p0[0], ts0, new_kf, try_reloc)
            last_done = p0[0]
            if (new_kf or try_reloc) and pend:
                # the chained submit assumed a clean commit: run it again
                stale = list(pend)
                pend.clear()
                for ij, tsj, pj in stale:
                    fj = pj[0]
                    fj.T_WC = last_done.T_WC
                    fj.T_WC_np = None
                    if self.mode != Mode.TRACKING:
                        self._process_nontracking(fj, tsj)
                        last_done = fj
                        continue
                    pend.append((ij, tsj, self.tracker.track_submit(fj)))

        for i, timestamp, pre in frames:
            with self.timer.time("frame.latency"):
                frame = self.ingest_rgb(i, timestamp, pre=pre)
                chained = False
                speculative = None
                if self.mode == Mode.TRACKING:
                    with self.timer.time("pipeline.spec_decode"):
                        speculative = self.tracker.infer(frame)
                    last_idx = self.keyframes.last_idx()
                    if (chain_ok and pend and pend[-1][2][1] == last_idx
                            and speculative[0] == last_idx):
                        with self.timer.time("pipeline.submit"):
                            pend.append((i, timestamp, self.tracker.track_submit_chained(
                                frame, speculative, pend[-1][2])))
                        chained = True
                if chained:
                    while len(pend) > 1:
                        with self.timer.time("pipeline.finish_prev"):
                            finish_oldest()
                else:
                    while pend:
                        with self.timer.time("pipeline.finish_prev"):
                            finish_oldest()
                    if last_done is not None:
                        frame.T_WC = last_done.T_WC
                    if self.mode == Mode.TRACKING:
                        with self.timer.time("pipeline.submit"):
                            pend.append((i, timestamp, self.tracker.track_submit(
                                frame, inference=speculative)))
                    else:
                        self._process_nontracking(frame, timestamp)
                        last_done = frame
                        if frame.T_WC_np is None and frame.T_WC.is_cuda:
                            torch.cuda.synchronize(frame.T_WC.device)
            self._progress(i, n, t0, verbose)
        while pend:
            finish_oldest()
