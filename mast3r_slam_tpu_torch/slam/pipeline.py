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
  and kept in ``backend_errors``.  Every task is recorded in
  ``backend_schedule`` as [submit, start, apply] frame ids (in line, its
  frame thrice; the single-process worker's own timing is not recorded).
- ``engine.pipeline: 0`` is the sequential loop; ``1`` the pipelined loop
  (``_loop_pipelined``), which issues the next frame's decode and tracking
  chained on the previous frame's outputs before reading its decision and
  gives the sequential loop's poses bit for bit; ``2`` puts the tracker's
  compute and the keyframe store on a second card (``tracker_card``) and
  runs the pipelined loop without the chain (finish frame i-1 before
  submitting frame i, the speculative decode corrected on a keyframe
  switch), the sequential poses again; with fewer than two cards, or on
  the CPU, it falls back to ``1``.
- ``engine.mesh: N | "auto"`` shards the backend over a mesh
  (``parallel/mesh.py``): the first N cards, or every card; on the CPU N
  CPU shards, or one.  Under a process group (``parallel/multihost.py``)
  the mesh spans every rank, and every rank runs the same engine on the
  same frames.

The threaded backend across processes (``single_thread: False`` under a
mesh of several ranks) keeps the ranks in step by agreeing on each task's
timing at frame boundaries.  Tasks are submitted at the same frames on every
rank, one runs at a time, and at the end of each committed frame (the end
of ``process_frame``; under ``pipeline: 1`` the end of each frame's
``track_finish`` commit) while a task is outstanding, one all-reduce on a
gloo group of the engine's own (``mesh.host_group``; the worker's
collectives keep the default group) takes the minimum over the ranks of the
tasks finished and the first failure.  From it every rank, at the same
frame: installs the poses of the newly finished tasks (the worker leaves
them pending; ``write_back_poses`` still refuses a stale generation), then,
with no task in flight, starts the next one from a snapshot the frontend
takes there (its ``pm_version`` with it), which the task's ``add_factors``
and ``solve`` both read.  A task submitted while every rank is idle starts
at its own frame.  A chained submit of ``pipeline: 1`` that a write-back
made stale is re-run, as after a keyframe switch.  Relocalisation, the end
of ``run``, ``join_backend`` and ``close`` drain first (the worker
finishes, its poses land, then the frontend may use the default group);
a task that failed on any rank stops every rank with an error naming the
rank and the task.

``run`` reads and preprocesses frames on a prefetch thread (decode,
undistortion and the resize overlap the card's work; its time is the
``ingest`` stage), at most ``PREFETCH_DEPTH`` frames ahead; an error there
ends the run with that error.  ``preprocess`` resizes to 512 with the host
library (``utils/native.py``) and to other sizes with PIL.

``engine.device_keyframes`` pages the keyframe store to that many device
slots; its ``keep_recent`` (half the budget, at most the solve window)
clamps the solve window.

Live events: with ``on_event`` set (a callable taking a dict), every logged
frame emits ``pose_update`` (frame id, timestamp, pose, mode) and every new
keyframe (INIT, committed, relocalised) ``new_keyframe``: its world points,
strided to about 8192 (``engine.viz_point_stride`` overrides the stride),
rounded to 0.1 mm, those above the confidence threshold (``control``'s, else
1 + 1e-6; all of them if none passes), and their colours.  A sink that
raises is reported and tracking goes on; unset, no event is built.
``control`` (a ``serve.broadcast.RunControl``) is asked before every frame
of ``run``: it blocks while paused and ends the run on terminate.
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

from ..device import DeviceLike, record_on, resolve_device, to_device, to_host
from ..eval.trajectory import save_traj_tum
from ..lie import sim3
from ..parallel.mesh import all_reduce_min, destroy_group, host_group, local_cards, make_mesh
from ..retrieval.database import RetrievalDatabase
from ..utils import native
from ..utils.timing import StageTimer
from .factor_graph import FactorGraph
from .frame import Frame, Keyframes, Mode
from .tracker import FrameTracker


PREFETCH_DEPTH = 2  # frames the ingest thread reads ahead
# a drain re-asks the ranks this often while this rank's worker is busy: a
# worker that waits in a collective for a rank whose task failed never ends
DRAIN_POLL_S = 0.25
NO_FAILURE = 2 ** 62  # the agreement's failure slot when no task failed


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
    if retrieval is not None and not isinstance(retrieval, RetrievalDatabase):
        raise TypeError(
            f"retrieval is a {type(retrieval).__name__}; the port takes its own "
            "mast3r_slam_tpu_torch.retrieval.RetrievalDatabase")


def keep_recent(cfg) -> int:
    """The newest keyframes a paged store never evicts: at most half of
    ``engine.device_keyframes`` (room for uploads and pinned context) and
    at most the solve window, at least 2; 64 without paging."""
    budget = int(cfg["engine"].get("device_keyframes", 0) or 0)
    if not budget:
        return 64
    window = int(float(cfg["local_opt"].get("window_size", 0) or 0))
    return max(2, min(window or budget, budget // 2))


def tracker_card(device: torch.device) -> Optional[torch.device]:
    """The card ``engine.pipeline: 2`` gives the tracker and the keyframe
    store: the next card after the engine's, or None on the CPU or with
    fewer than two cards."""
    if device.type != "cuda":
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch.device("cuda", (index + 1) % n)


def _pipeline_mode(cfg, device: torch.device):
    """(``engine.pipeline``, the tracker's device or None): 2 takes a second
    card and falls back to 1 without one, as in the JAX package."""
    mode = int(cfg["engine"].get("pipeline", 0) or 0)
    track = None
    if mode >= 2:
        track = tracker_card(device)
        if track is None:
            print("engine.pipeline: fewer than 2 devices; "
                  "running single-chip host-pipelined (pipeline: 1)")
            mode = 1
    return mode, track


def _build_mesh(cfg, device: torch.device):
    """``engine.mesh``: 0 or absent, no mesh; N, the first N cards counted
    from the engine's (fewer cards give a smaller mesh, as in the JAX
    package) or N shards on the CPU; "auto", every card, or one CPU shard.
    Across processes each rank gives its own card (the engine's) and N
    counts shards over all ranks."""
    mesh_cfg = cfg["engine"].get("mesh", 0)
    if not mesh_cfg:
        return None
    n = None if mesh_cfg == "auto" else int(mesh_cfg)
    if device.type == "cpu":
        return make_mesh(n, [device] * (n or 1))
    return make_mesh(n, local_cards(device))


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
        self.single_thread = bool(cfg.get("single_thread", True))
        self.mesh = _build_mesh(cfg, self.device)
        self.pipeline, track_device = _pipeline_mode(cfg, self.device)
        cap = keyframe_buffer or cfg["engine"]["keyframe_buffer"]
        # the keyframe store lives with the tracker's compute
        store_device = track_device or self.device
        self.keyframes = Keyframes(
            capacity=cap,
            num_pixels=img_hw[0] * img_hw[1],
            num_patches=model.num_patches,
            feat_dim=model.feat_dim,
            device=store_device,
            device_budget=int(cfg["engine"].get("device_keyframes", 0) or 0),
            keep_recent=keep_recent(cfg),
        )
        if K is not None:
            self.keyframes.K = torch.as_tensor(K, dtype=torch.float32, device=store_device)
        self.tracker = FrameTracker(model, cfg, self.keyframes, img_hw, self.device,
                                    compute_device=track_device)
        self.graph = FactorGraph(model, cfg, self.keyframes, img_hw, K=self.keyframes.K,
                                 edge_capacity=cfg["engine"].get("edge_buffer", 1024),
                                 mesh=self.mesh)
        self._reuse_match = bool(cfg["local_opt"].get("reuse_tracker_match", False))
        self.mode = Mode.INIT
        self.n_reloc = 0
        self.n_reloc_success = 0
        self.frame_log: List[tuple] = []  # (timestamp, T_WC np (8,))
        self.timer = StageTimer()
        # live viewer / session server hooks (see the module docstring)
        self.on_event = None
        self.control = None
        self.viz_point_stride = int(cfg.get("engine", {}).get("viz_point_stride", 0) or 0)

        # the threaded backend (single_thread: False); across processes its
        # tasks' start and write-back are agreed (see the module docstring)
        self.backend_lock = threading.RLock()
        self.backend_errors: List[BaseException] = []
        self.backend_schedule: List[list] = []  # [submit, start, apply] frame ids
        self._frontend_stream = (torch.cuda.current_stream(self.device)
                                 if self.device.type == "cuda" else None)
        self._backend_stream = None
        self._tasks: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self.agreed = (not self.single_thread and self.mesh is not None
                       and self.mesh.world > 1)
        self._agree_group = host_group() if self.agreed else None
        self._waiting: deque = deque()  # (task, kf_idx, capture) not yet started
        self._n_started = 0
        self._n_applied = 0
        self._n_done = 0                # this rank's worker: tasks ended
        self._results: dict = {}        # task -> its pending write-back or None
        self._failed_task: Optional[int] = None  # this rank's first failed task
        self._agree_failure: Optional[tuple] = None  # (rank, task) once agreed
        self._done_cv = threading.Condition()
        self._frame_id = -1             # the last committed frame
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
        tasks = self._tasks  # close() may drop the engine's reference first
        while True:
            task = tasks.get()
            try:
                if task is None:
                    return
                if self.agreed:
                    self._run_agreed_task(*task)
                    continue
                kf_idx, capture = task
                with self.timer.time("backend.update"):
                    self._backend_update(kf_idx, capture)
            except Exception as e:  # the worker must outlive a failed task
                self._report_task_failure(e)
            finally:
                tasks.task_done()

    def _report_task_failure(self, e: BaseException):
        print(f"backend task failed: {e!r}", file=sys.stderr)
        traceback.print_exc(file=sys.stderr)
        self.backend_errors.append(e)

    def _run_agreed_task(self, k: int, kf_idx: int, capture, inputs):
        """Task ``k`` on the worker, from the snapshot the frontend took at
        its agreed start; its write-back is left for the frontend."""
        result, failed = None, False
        try:
            with self.timer.time("backend.update"):
                result = self._backend_update(kf_idx, capture, inputs)
        except Exception as e:
            self._report_task_failure(e)
            failed = True
        with self._done_cv:
            self._results[k] = result
            if failed and self._failed_task is None:
                self._failed_task = k
            self._n_done += 1
            self._done_cv.notify_all()

    def join_backend(self):
        """Wait until every queued backend task has run.  Across processes
        this is a drain, which every rank must call at the same frame: each
        task finishes and its poses land."""
        if self.agreed:
            self._drain(self._frame_id)
        elif self._tasks is not None:
            self._tasks.join()

    def close(self):
        """Drain the backend and stop its worker thread.  Across processes,
        the engine's agreement group is destroyed too; after a failed task
        nothing is drained and the worker, which may wait in a collective of
        the failed rank, is left to the process's end."""
        try:
            if self.agreed and self._agree_failure is None and self._agree_group is not None:
                self._drain(self._frame_id)
        finally:
            if self._worker is not None:
                self._tasks.put(None)
                if self._agree_failure is None:
                    self._worker.join()
                self._worker = None
                self._tasks = None
            if self._agree_group is not None:
                destroy_group(self._agree_group)
                self._agree_group = None

    @contextmanager
    def _on_backend_stream(self, *inputs):
        """Run backend work (a task, a relocalisation) on the backend's CUDA
        stream, after the frontend's work so far, and wait for it at the
        end.  A no-op without a worker or without CUDA."""
        if self._backend_stream is None:
            yield
            return
        self._backend_stream.wait_stream(self._frontend_stream)
        # pipeline: 2's tracker card has one stream for both threads
        record_on(self._backend_stream, self.device, inputs)
        try:
            with torch.cuda.stream(self._backend_stream):
                yield
        finally:
            self._backend_stream.synchronize()

    def _submit_backend(self, kf_idx: int, capture=None, frame_id: Optional[int] = None):
        """Queue a backend task for the worker, or run it in line; submitted
        at frame ``frame_id`` (default: the last committed one).  Across
        processes it waits for its agreed start; with every rank's worker
        idle that is now."""
        if frame_id is None:
            frame_id = self._frame_id
        if self.agreed:
            self.backend_schedule.append([frame_id, None, None])
            self._waiting.append((len(self.backend_schedule) - 1, kf_idx, capture))
            if self._n_started == self._n_applied:
                self._start_task(frame_id)
            return
        if self._tasks is not None:
            self._tasks.put((kf_idx, capture))
            return
        self.backend_schedule.append([frame_id] * 3)
        with self.timer.time("backend.update"):
            self._backend_update(kf_idx, capture)

    def _backend_update(self, kf_idx: int, capture=None, inputs=None):
        """One backend task under ``backend_lock``: the store is read through
        snapshots and written back under its own lock, so tracking goes on.
        ``inputs`` (snapshot, pm_version): an agreed task's, whose write-back
        is returned."""
        snap_tensors = () if inputs is None else (inputs[0].T_WC, inputs[0].X, inputs[0].C,
                                                  inputs[0].n_fused, inputs[0].feat,
                                                  inputs[0].pos)
        with self.backend_lock, self._on_backend_stream(*(capture or ())[1:], *snap_tensors):
            if inputs is None:
                return self._backend_update_impl(kf_idx, capture)
            return self._backend_update_impl(kf_idx, capture, inputs)

    # ------------------------------------------------------------------
    # the agreement (threaded backend across processes)
    # ------------------------------------------------------------------

    def _start_task(self, frame_id: int):
        """Start the oldest waiting task from a snapshot taken now: every
        rank's worker is idle and every earlier write-back installed."""
        k, kf_idx, capture = self._waiting.popleft()
        kf = self.keyframes
        with kf.lock:
            ver = kf.pm_version.copy()
            snap = kf.snapshot()
        self.backend_schedule[k][1] = frame_id
        self._n_started += 1
        self._tasks.put((k, kf_idx, capture, (snap, ver)))

    def _frame_committed(self, frame_id: int) -> bool:
        """The end of a committed frame: the agreement, while a task is
        outstanding (every rank knows when one is).  Returns whether a
        write-back landed."""
        self._frame_id = frame_id
        if not self.agreed or self._n_applied == len(self.backend_schedule):
            return False
        return self._agree(frame_id)

    def _agree(self, frame_id: int) -> bool:
        """One all-reduce of (tasks finished, first failure) over the ranks;
        install what every rank finished, start the next task if every rank
        is idle.  Raises on every rank if a task failed on any."""
        with self._done_cv:
            done, failed = self._n_done, self._failed_task
        mine = NO_FAILURE if failed is None else (self.mesh.rank << 32) + failed
        with self.timer.time("backend.agree"):
            done, failure = all_reduce_min(self._agree_group, done, mine)
        if failure != NO_FAILURE:
            self._agree_failure = (failure >> 32, failure & 0xFFFFFFFF)
            rank, task = self._agree_failure
            raise RuntimeError(
                f"backend task {task} (submitted at frame {self.backend_schedule[task][0]}) "
                f"failed on rank {rank}; every rank stops")
        applied = False
        while self._n_applied < done:
            k = self._n_applied
            with self._done_cv:
                write_back = self._results.pop(k)
            if write_back is not None:
                # made on the worker's stream, read on this thread's
                T_new = write_back[3]
                if T_new.is_cuda:
                    record_on(torch.cuda.current_stream(T_new.device), T_new.device, (T_new,))
                self.keyframes.write_back_poses(*write_back)
            self.backend_schedule[k][2] = frame_id
            self._n_applied += 1
            applied = True
        if self._waiting and self._n_started == self._n_applied:
            self._start_task(frame_id)
        return applied

    def _drain(self, frame_id: int):
        """Run every submitted task to its write-back, asking the ranks
        again whenever this rank's worker is idle (or every
        ``DRAIN_POLL_S``, so that a failure elsewhere is heard)."""
        while self._n_applied < len(self.backend_schedule):
            with self._done_cv:
                self._done_cv.wait_for(lambda: self._n_done == self._n_started,
                                       timeout=DRAIN_POLL_S)
            self._agree(frame_id)

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
        img = to_device(r["img"], self.device)[None]
        feat, pos = self.model.encode(img)
        T = (T_WC_init if T_WC_init is not None
             else sim3.identity(device=self.device))
        return Frame(frame_id=frame_id, img=img[0], T_WC=T, feat=feat, pos=pos,
                     uimg=r.get("unnormalized_img"))

    def _backend_update_impl(self, kf_idx: int, capture=None, inputs=None):
        """Retrieval candidates and the previous keyframe, edges from them to
        the new keyframe, then the global solve (run_backend,
        main.py:96-143).  With ``inputs`` (snapshot, pm_version), both read
        that snapshot and the solve's write-back is returned."""
        cfg = self.cfg
        candidates = set()
        if self.retrieval is not None:
            with self.timer.time("backend.retrieval"):
                candidates.update(self.retrieval.update(
                    self.keyframes.get_feat(kf_idx), add_after_query=True,
                    k=cfg["retrieval"]["k"], min_thresh=cfg["retrieval"]["min_thresh"],
                    kf_index=kf_idx))
        if kf_idx >= 1:
            candidates.add(kf_idx - 1)
        candidates.discard(kf_idx)
        kf_idxs = sorted(candidates)
        if not kf_idxs:
            return None
        captures = None
        if capture is not None and capture[0] == kf_idx - 1:
            captures = {(capture[0], kf_idx): capture[1:]}
        snap, ver = inputs if inputs is not None else (None, None)
        with self.timer.time("backend.add_factors"):
            self.graph.add_factors(kf_idxs, [kf_idx] * len(kf_idxs),
                                   cfg["local_opt"]["min_match_frac"], captures=captures,
                                   snap=snap)
        with self.timer.time("backend.solve"):
            return self.graph.solve(snap=snap, ver=ver)

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
        self._emit_keyframe(kf_idx, frame)
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

    def _after_track(self, frame: Frame, timestamp, new_kf: bool, try_reloc: bool) -> bool:
        """Commit a tracked frame's decision; returns whether an agreed
        write-back landed at its end."""
        if try_reloc:
            self.mode = Mode.RELOC
            self._log(timestamp, frame)
            return self._frame_committed(frame.frame_id)
        if new_kf:
            kf_idx = self.keyframes.append(frame)
            # the tracker's own match becomes the consecutive edge's backward half
            self._submit_backend(
                kf_idx, self.tracker.last_match_capture if self._reuse_match else None,
                frame_id=frame.frame_id)
            self._emit_keyframe(kf_idx, frame)
        self._log(timestamp, frame)
        return self._frame_committed(frame.frame_id)

    def _log(self, timestamp, frame: Frame):
        T = frame.T_WC_np
        if T is None:
            (T,) = to_host(frame.T_WC)
        self.frame_log.append((timestamp, T))
        self._emit(lambda: {"type": "pose_update", "frame_id": int(frame.frame_id),
                            "timestamp": timestamp, "pose": T.tolist(),
                            "mode": self.mode.name})

    def _emit(self, make_event):
        """Hand one event to ``on_event``; nothing is built when it is unset,
        and a failing sink never stops tracking."""
        if self.on_event is None:
            return
        try:
            self.on_event(make_event())
        except Exception as e:  # the sink must not break the run
            print(f"event sink failed: {e!r}", file=sys.stderr)

    def _emit_keyframe(self, kf_idx: int, frame: Frame):
        """``new_keyframe`` with the keyframe's world points and colours, read
        from a snapshot of the store through the keyframe's slot."""
        if self.on_event is None:
            return

        def build():
            snap = self.keyframes.snapshot()
            slot = int(snap.slots([kf_idx])[0])
            T = snap.T_WC[kf_idx]
            N = snap.X.shape[1]
            stride = self.viz_point_stride or max(1, N // 8192)
            # C is summed over n_fused observations: the mean, as the export reads it
            C = snap.C[slot, ::stride, 0] / snap.n_fused[kf_idx].clamp(min=1).to(snap.C.dtype)
            Xw = sim3.act(T, snap.X[slot, ::stride]).float()
            Xw, conf, T = Xw.cpu().numpy(), C.cpu().numpy(), T.cpu().numpy()
            uimg = self.keyframes.uimgs[kf_idx]
            if uimg is not None and np.asarray(uimg).reshape(-1, 3).shape[0] == N:
                col = np.asarray(uimg).reshape(-1, 3)[::stride]
                if col.dtype != np.uint8:
                    col = np.uint8(np.clip(col, 0, 1) * 255)
            else:
                col = np.full((len(Xw), 3), 128, np.uint8)
            thresh = (self.control.conf_threshold if self.control is not None
                      else 1.0 + 1e-6)
            sel = conf > thresh
            if sel.any():
                Xw, col = Xw[sel], col[sel]
            return {"type": "new_keyframe", "keyframe_index": int(kf_idx),
                    "frame_id": int(frame.frame_id), "pose": T.tolist(),
                    "points": np.round(Xw, 4).tolist(), "colors": col.tolist()}

        self._emit(build)

    def _process_nontracking(self, frame: Frame, timestamp):
        """INIT / RELOC handling of an ingested frame."""
        X, C = self.model.mono(frame.feat, frame.pos)
        frame.update_pointmap(
            X.reshape(-1, 3), C.reshape(-1, 1),
            mode=self.cfg["tracking"]["filtering_mode"],
            score_mode=self.cfg["tracking"]["filtering_score"])
        if self.mode == Mode.INIT:
            kf_idx = self.keyframes.append(frame)
            if self.retrieval is not None:  # adds the first keyframe to the database
                self._submit_backend(0, frame_id=frame.frame_id)
            self.mode = Mode.TRACKING
            self._log(timestamp, frame)
            self._emit_keyframe(kf_idx, frame)
            self._frame_committed(frame.frame_id)
            return
        self.n_reloc += 1
        if self.agreed:  # relocalisation's collectives run on this thread
            self._drain(frame.frame_id)
        if self._relocalize(frame):
            self.n_reloc_success += 1
            self.mode = Mode.TRACKING
            self.tracker.reset_idx_f2k()
        self._log(timestamp, frame)
        self._frame_committed(frame.frame_id)

    # ------------------------------------------------------------------

    def run(self, dataset, max_frames: Optional[int] = None,
            verbose: bool = True) -> SlamResult:
        """Track every frame of ``dataset`` in order, then wait for the
        backend.  A dataset may supply preprocessed frames through a
        ``preprocessed(i)`` hook.  A terminate from ``control`` ends the
        loop early: the frames read ahead are dropped and the frames in
        flight finish."""
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
                    if self.control is not None and not self.control.proceed():
                        break
                    # frame.latency: the frame's wall time, stalls behind a
                    # backend task included
                    with self.timer.time("frame.latency"):
                        frame = self.process_frame(i, timestamp, last_T_WC=last_T,
                                                   pre=pre)
                        if frame.T_WC_np is None and frame.T_WC.is_cuda:
                            torch.cuda.synchronize(frame.T_WC.device)
                    last_T = frame.T_WC
                    self._progress(i, n, t0, verbose)
        self.join_backend()  # across processes: the last write-backs land here
        self.graph.resolve_pending_verdicts()  # the speculative gate's verdicts
        for dev in {self.device, self.keyframes.device}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        wall = time.time() - t0

        kf = self.keyframes
        kf_ts = [dataset.timestamps[int(kf.frame_id[i])] for i in range(len(kf))]
        return SlamResult(
            keyframe_timestamps=kf_ts,
            keyframe_poses=to_host(kf.T_WC[: len(kf)])[0],
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
        or GN failure, and across processes after an agreed write-back at
        the commit, the chained submit is discarded and re-run from the
        committed state, so every pose is the sequential loop's.
        ``engine.chain: false`` finishes i-1 before submitting i.  INIT and
        RELOC frames drain the pipeline and run as in the sequential loop.
        Every frame starts from the last finished frame's pose, as the
        sequential loop's warm start."""
        pend = deque()  # (frame index, timestamp, tracker pending), oldest first
        # pipeline: 2 (the tracker on its own card) keeps the depth-1 loop
        chain_ok = self.tracker.compute_device is None and bool(
            self.cfg["engine"].get("chain", True))
        last_done = None  # the most recent frame with a committed pose

        def finish_oldest():
            nonlocal last_done
            _, ts0, p0 = pend.popleft()
            new_kf, try_reloc = self.tracker.track_finish(p0)
            moved = self._after_track(p0[0], ts0, new_kf, try_reloc)
            last_done = p0[0]
            if (new_kf or try_reloc or moved) and pend:
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
            if self.control is not None and not self.control.proceed():
                break
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
