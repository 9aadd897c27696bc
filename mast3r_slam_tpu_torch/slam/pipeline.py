"""The SLAM engine's sequential loop (port of ``slam/pipeline.py``).

``SLAM`` runs the INIT / TRACKING / RELOC mode machine frame by frame,
``single_thread: True`` and ``engine.pipeline: 0`` semantics.  After every
new keyframe it runs the backend task in line: with a
``RetrievalDatabase``, a query of the new keyframe that then adds it; edges
from the retrieved keyframes and the previous one to the new one through
``FactorGraph.add_factors``; then ``FactorGraph.solve`` over all keyframe
poses.  A frame in RELOC mode queries the database, appends itself as a
keyframe, and keeps it (snapped to the best candidate's pose, then solved)
if its reloc edges pass, or pops it.  Without retrieval there are no
loop-closure edges and relocalisation fails, as in the JAX package.
Settings this slice does not port raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..lie import sim3
from ..retrieval.database import RetrievalDatabase
from ..utils.image import resize_img
from ..utils.timing import StageTimer
from .factor_graph import FactorGraph
from .frame import Frame, Keyframes, Mode
from .tracker import FrameTracker


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
    if not cfg.get("single_thread", True):
        raise NotImplementedError(
            "single_thread: False (the backend on a worker thread) is not ported "
            "yet (ROADMAP Queue 1, item 10: the threaded backend); set "
            "cfg['single_thread'] = True for the sequential loop")
    engine = cfg.get("engine", {})
    for key, item in (("pipeline", "ROADMAP Queue 1, item 10: the pipelined/chained frontend"),
                      ("mesh", "ROADMAP Queue 1, item 12: multi-GPU"),
                      ("device_keyframes", "ROADMAP Queue 1, item 8: keyframe paging")):
        if int(engine.get(key, 0) or 0) != 0:
            raise NotImplementedError(f"engine.{key}: {engine[key]!r} is not ported yet ({item})")
    if retrieval is not None and not isinstance(retrieval, RetrievalDatabase):
        raise TypeError(
            f"retrieval is a {type(retrieval).__name__}; the port takes its own "
            "mast3r_slam_tpu_torch.retrieval.RetrievalDatabase")


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
        self.mode = Mode.INIT
        self.n_reloc = 0
        self.n_reloc_success = 0
        self.frame_log: List[tuple] = []  # (timestamp, T_WC np (8,))
        self.timer = StageTimer()

    # ------------------------------------------------------------------

    def preprocess(self, rgb01: np.ndarray) -> dict:
        """Resize and normalise one RGB frame on the host (needs PIL)."""
        size = int(self.cfg.get("engine", {}).get("resize", 512))
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

    def _submit_backend(self, kf_idx: int):
        """One backend task, in line (run_backend, main.py:96-143): retrieval
        candidates and the previous keyframe, edges from them to the new
        keyframe, then the global solve."""
        with self.timer.time("backend.update"):
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
            with self.timer.time("backend.add_factors"):
                self.graph.add_factors(kf_idxs, [kf_idx] * len(kf_idxs),
                                       cfg["local_opt"]["min_match_frac"])
            with self.timer.time("backend.solve"):
                self.graph.solve()

    def _relocalize(self, frame: Frame) -> bool:
        """Retrieval-driven relocalisation (main.py:28-71); without retrieval
        it fails."""
        if self.retrieval is None:
            return False
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
        T = self.keyframes.T_WC[inds[0]].clone()
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
            self._submit_backend(kf_idx)
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
        """Track every frame of ``dataset`` in order.  A dataset may supply
        preprocessed frames through a ``preprocessed(i)`` hook."""
        n = len(dataset)
        if max_frames is not None:
            n = min(n, max_frames)
        get_pre = getattr(dataset, "preprocessed", None)
        last_T = None
        t0 = time.time()
        for i in range(n):
            timestamp, img = dataset[i]
            pre = get_pre(i) if get_pre is not None else self.preprocess(img)
            with self.timer.time("frame.latency"):
                frame = self.process_frame(i, timestamp, last_T_WC=last_T, pre=pre)
                if frame.T_WC_np is None and frame.T_WC.is_cuda:
                    torch.cuda.synchronize(frame.T_WC.device)
            last_T = frame.T_WC
            if verbose and i % 30 == 0 and i > 0:
                fps = i / (time.time() - t0)
                print(f"frame {i}/{n}  kf={len(self.keyframes)}  {fps:.2f} fps")
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
