"""Frame-to-keyframe tracker (port of ``mast3r_slam_tpu/slam/tracker.py``).

Two-view inference through the model protocol, then ``_track_compute``:
dense matching, fusion of the frame's canonical pointmap, confidence
gating, the Sim(3) Gauss-Newton solve, fusion of the keyframe's pointmap
and the keyframe-decision statistics.  The host reads the 16-float stats
vector once per frame to decide keyframe / relocalisation.  The chained and
two-chip forms of the JAX package come later.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..geometry import constrain_points_to_ray, get_pixel_coords
from ..lie import sim3
from ..ops import matching
from ..ops.tracking_gn import GNSettings, opt_pose_calib_sim3, opt_pose_ray_dist_sim3
from .frame import Frame, Keyframes, fuse_pointmap


class TrackerSettings(NamedTuple):
    # matching (config `matching:`)
    max_iter: int = 10
    lambda_init: float = 1e-8
    convergence_thresh: float = 1e-6
    dist_thresh: float = 0.1
    radius: int = 3
    dilation_max: int = 5
    # tracking (config `tracking:`)
    min_match_frac: float = 0.05
    C_conf: float = 0.0
    Q_conf: float = 1.5
    match_frac_thresh: float = 0.333
    filtering_mode: str = "weighted_pointmap"
    filtering_score: str = "median"
    use_calib: bool = False
    gn: GNSettings = GNSettings()

    @classmethod
    def from_config(cls, cfg) -> "TrackerSettings":
        m, t = cfg["matching"], cfg["tracking"]
        for key, ported in (("refine_gate", "none"), ("proj_gate", "none"),
                            ("proj_init", "warm")):
            if m.get(key, ported) != ported:
                raise NotImplementedError(
                    f"matching.{key}: {m[key]!r} is not ported yet; the port "
                    f"runs {ported!r} (ROADMAP Queue 1, item 4: the "
                    "speed-profile matching paths)")
        return cls(
            max_iter=m["max_iter"],
            lambda_init=m["lambda_init"],
            convergence_thresh=m["convergence_thresh"],
            dist_thresh=m["dist_thresh"],
            radius=m["radius"],
            dilation_max=m["dilation_max"],
            min_match_frac=t["min_match_frac"],
            C_conf=t["C_conf"],
            Q_conf=t["Q_conf"],
            match_frac_thresh=t["match_frac_thresh"],
            filtering_mode=t["filtering_mode"],
            filtering_score=t["filtering_score"],
            use_calib=cfg["use_calib"],
            gn=GNSettings(
                max_iters=t["max_iters"],
                rel_error=t["rel_error"],
                delta_norm=t["delta_norm"],
                huber_k=t["huber"],
                sigma_ray=t["sigma_ray"],
                sigma_dist=t["sigma_dist"],
                sigma_pixel=t["sigma_pixel"],
                sigma_depth=t["sigma_depth"],
                pixel_border=t["pixel_border"],
                depth_eps=t["depth_eps"],
            ),
        )


@torch.no_grad()
def _track_compute(
    ts: TrackerSettings,
    img_hw: Tuple[int, int],
    Xii, Cii, Dii, Qii,      # frame canonical prediction (1, H, W, *)
    Xji, Cji, Dji, Qji,      # keyframe-in-frame prediction (1, H, W, *)
    frame_X, frame_C, frame_n_fused, frame_n_updates, frame_score,
    kf_X, kf_C, kf_n_fused, kf_n_updates, kf_score,
    T_WCf, T_WCk,
    idx_init,
    K,
):
    """Everything after inference for one tracked frame (tracker.py:28-127)."""
    H, W = img_hw
    N = H * W

    # 1. dense matching: keyframe pixels -> frame pixels
    idx_f2k, valid_match = matching.match(
        Xii, Xji, Dii, Dji, idx_1_to_2_init=idx_init[None],
        max_iter=ts.max_iter, lambda_init=ts.lambda_init,
        convergence_thresh=ts.convergence_thresh, dist_thresh=ts.dist_thresh,
        radius=ts.radius, dilation_max=ts.dilation_max,
    )
    idx_f2k = idx_f2k[0]
    valid_match = valid_match[0]

    Xii_f = Xii.reshape(N, 3)
    Cii_f = Cii.reshape(N, 1)
    Qii_f = Qii.reshape(N, 1)
    Xji_f = Xji.reshape(N, 3)
    Cji_f = Cji.reshape(N, 1)
    Qji_f = Qji.reshape(N, 1)

    # 2. fuse the new canonical observation into the frame pointmap
    frame_X, frame_C, frame_n_fused, frame_n_updates, frame_score = fuse_pointmap(
        frame_X, frame_C, frame_n_fused, frame_n_updates, Xii_f, Cii_f,
        score=frame_score, mode=ts.filtering_mode, score_mode=ts.filtering_score)

    # 3. gather correspondences + confidence gating (tracker.py:54-70)
    Xf_all = frame_X
    Xk_all = kf_X
    Cf_avg = frame_C / frame_n_fused.to(frame_C.dtype)
    Ck_avg = kf_C / torch.clamp_min(kf_n_fused.to(kf_C.dtype), 1.0)
    if ts.use_calib:
        Xf_all = constrain_points_to_ray(img_hw, Xf_all, K)
        Xk_all = constrain_points_to_ray(img_hw, Xk_all, K)

    gathered = torch.cat([Xf_all, Cf_avg, Qii_f], dim=-1)[idx_f2k.long()]
    Xf = gathered[:, 0:3]
    Cf = gathered[:, 3:4]
    Qk = torch.sqrt(gathered[:, 4:5] * Qji_f)

    valid_Cf = Cf > ts.C_conf
    valid_Ck = Ck_avg > ts.C_conf
    valid_Q = Qk > ts.Q_conf
    valid_opt = valid_match & valid_Cf & valid_Ck & valid_Q
    valid_kf = valid_match & valid_Q
    match_frac = valid_opt.float().mean()

    # 4. GN pose solve for T_CkCf
    T_CkCf_init = sim3.rel(T_WCk, T_WCf)
    if ts.use_calib:
        uv = get_pixel_coords(img_hw, dtype=Xk_all.dtype, device=Xk_all.device).reshape(-1, 2)
        zk = Xk_all[..., 2:3]
        valid_meas = zk > ts.gn.depth_eps
        logz = torch.where(valid_meas, torch.log(torch.clamp_min(zk, ts.gn.depth_eps)),
                           torch.zeros_like(zk))
        meas_k = torch.cat([uv, logz], dim=-1) * valid_meas
        T_CkCf, cost, ok = opt_pose_calib_sim3(
            Xf, Xk_all, T_CkCf_init, Qk, valid_opt.to(Xf.dtype), meas_k, valid_meas,
            K, img_hw, ts.gn)
    else:
        T_CkCf, cost, ok = opt_pose_ray_dist_sim3(
            Xf, Xk_all, T_CkCf_init, Qk, valid_opt.to(Xf.dtype), ts.gn)

    T_WCf_new = sim3.mul(T_WCk, T_CkCf)

    # 5. fuse the keyframe pointmap with its re-observation (tracker.py:96-101)
    Xkk = sim3.act(T_CkCf, Xji_f)
    kX, kC, kn, knu, ks = fuse_pointmap(
        kf_X, kf_C, kf_n_fused, kf_n_updates, Xkk, Cji_f,
        score=kf_score, mode=ts.filtering_mode, score_mode=ts.filtering_score)

    # 6. keyframe decision stats (tracker.py:103-110): hit[j] = 1 iff some
    # valid keyframe pixel matched frame pixel j; invalid rows go to the
    # extra slot N and are dropped
    match_frac_k = valid_kf.float().mean()
    idx_hit = torch.where(valid_match[:, 0], idx_f2k, torch.full_like(idx_f2k, N))
    hit = torch.zeros(N + 1, dtype=torch.float32, device=idx_f2k.device)
    hit[idx_hit.long()] = 1.0
    unique_frac_f = hit[:N].sum() / N

    stats = torch.cat([
        torch.stack([
            match_frac, match_frac_k, unique_frac_f, ok.float(),
            frame_n_fused.float(), frame_n_updates.float(), frame_score.float(),
            cost.float(),
        ]),
        T_WCf_new.float(),
    ])
    return dict(
        idx_f2k=idx_f2k,
        frame_X=frame_X,
        frame_C=frame_C,
        kf_X=kX,
        kf_C=kC,
        kf_n_fused=kn,
        kf_n_updates=knu,
        kf_score=ks,
        T_WCf=T_WCf_new,
        stats=stats,
    )


class FrameTracker:
    """Host orchestration and decisions around ``_track_compute``."""

    def __init__(self, model, cfg, keyframes: Keyframes, img_hw: Tuple[int, int],
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.ts = TrackerSettings.from_config(cfg)
        self.keyframes = keyframes
        self.img_hw = tuple(img_hw)
        self.last_stats = None
        self.reset_idx_f2k()

    def reset_idx_f2k(self):
        N = self.img_hw[0] * self.img_hw[1]
        self.idx_f2k = torch.arange(N, dtype=torch.int32, device=self.device)

    def track_submit(self, frame: Frame):
        """Inference against the last keyframe, then ``_track_compute``.
        Returns (frame, kf_idx, outputs)."""
        kf = self.keyframes
        kf_idx = kf.last_idx()
        dev = self.device
        K = kf.K if self.ts.use_calib else torch.eye(3, dtype=torch.float32, device=dev)
        kf_X, kf_C, kf_nf, kf_nu, kf_sc, T_WCk, feat_k, pos_k = kf.slices(kf_idx)
        (Xii, Cii, Dii, Qii), (Xji, Cji, Dji, Qji) = self.model.asymmetric(
            frame.feat, frame.pos, feat_k, pos_k)

        N = self.img_hw[0] * self.img_hw[1]
        frame_X = (frame.X_canon if frame.X_canon is not None
                   else torch.zeros((N, 3), dtype=torch.float32, device=dev))
        frame_C = (frame.C if frame.C is not None
                   else torch.zeros((N, 1), dtype=torch.float32, device=dev))
        out = _track_compute(
            self.ts, self.img_hw,
            Xii, Cii, Dii, Qii, Xji, Cji, Dji, Qji,
            frame_X, frame_C, frame.n_fused, frame.n_updates, frame.score,
            kf_X, kf_C, kf_nf, kf_nu, kf_sc,
            frame.T_WC.to(dev), T_WCk, self.idx_f2k, K,
        )
        return frame, kf_idx, out

    def track_finish(self, pending):
        """Read the decision stats (the one blocking read of a tracked frame),
        commit frame and keyframe state, decide.  Returns (new_kf, try_reloc)."""
        frame, kf_idx, out = pending
        kf = self.keyframes
        self.idx_f2k = out["idx_f2k"]
        stats = out["stats"].cpu().numpy()
        self.last_stats = stats
        (match_frac, match_frac_k, unique_frac_f, gn_ok, n_fused, n_updates,
         frame_score, _) = stats[:8]

        # low overlap -> relocalise; GN/Cholesky failure -> skip the frame
        if match_frac < self.ts.min_match_frac or not gn_ok:
            return False, True

        frame.X_canon = out["frame_X"]
        frame.C = out["frame_C"]
        frame.n_fused = int(n_fused)
        frame.n_updates = int(n_updates)
        frame.score = float(frame_score)
        frame.T_WC = out["T_WCf"]
        frame.T_WC_np = stats[8:16]
        kf.update_pointmap(kf_idx, out["kf_X"], out["kf_C"], out["kf_n_fused"],
                           out["kf_n_updates"], out["kf_score"])

        new_kf = min(match_frac_k, unique_frac_f) < self.ts.match_frac_thresh
        if new_kf:
            self.reset_idx_f2k()
        return new_kf, False

    def track(self, frame: Frame):
        """Returns (new_kf, try_reloc)."""
        return self.track_finish(self.track_submit(frame))
