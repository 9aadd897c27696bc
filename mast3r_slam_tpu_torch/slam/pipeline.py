"""The SLAM engine's sequential frontend loop (port of ``slam/pipeline.py``).

``SLAM`` runs the INIT / TRACKING / RELOC mode machine frame by frame,
``single_thread: True`` and ``engine.pipeline: 0`` semantics.  The backend
(factor graph and global Gauss-Newton) is the next slice: here
``_submit_backend`` only records the new keyframe's index in
``backend_tasks``, which the next slice's ``FactorGraph`` consumes.  Without
retrieval, relocalisation fails, as in the JAX package.  Settings this slice
does not port raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..lie import sim3
from ..utils.image import resize_img
from ..utils.timing import StageTimer
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
    engine = cfg.get("engine", {})
    for key, item in (("pipeline", "ROADMAP Queue 1, item 10: the pipelined/chained frontend"),
                      ("mesh", "ROADMAP Queue 1, item 12: multi-GPU"),
                      ("device_keyframes", "ROADMAP Queue 1, item 8: keyframe paging")):
        if int(engine.get(key, 0) or 0) != 0:
            raise NotImplementedError(f"engine.{key}: {engine[key]!r} is not ported yet ({item})")
    if retrieval is not None:
        raise NotImplementedError(
            "retrieval is not ported yet (ROADMAP Queue 1, item 9: retrieval "
            "and relocalisation)")


class SLAM:
    """Single-session SLAM over a stream of frames, on the card unless told otherwise."""

    def __init__(self, model, cfg, img_hw, K=None, keyframe_buffer=None,
                 retrieval=None, device: DeviceLike = None):
        _check_ported(cfg, retrieval)
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.img_hw = tuple(img_hw)
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
        self.backend_tasks: List[int] = []
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
        """Record the new keyframe for the backend; the global optimisation
        is the next slice (its ``FactorGraph`` consumes ``backend_tasks``)."""
        self.backend_tasks.append(kf_idx)

    def _relocalize(self, frame: Frame) -> bool:
        """Retrieval-driven relocalisation; without retrieval it fails."""
        return False

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
