#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card (an H100 is the target) and exits non-zero without one.
It imports no JAX.  Phases, any failure of which ends the run non-zero:

  1. the card's name and power limit (nvidia-smi); build every kernel from
     the sources in mast3r_slam_tpu_torch/csrc (one nvcc per source, in
     parallel);
  2. each kernel against its plain PyTorch version at the main path's
     shapes (attention (1,16,768,64) and (1,12,768,64) bf16; refine at
     384x512, F=24, radius/dilation (3,5) and (1,1), exactly equal), timed
     with CUDA events beside the plain version and, where one exists, the
     PyTorch library call;
  3. a small bf16 model on the card (kernels) against the same model on the
     CPU (plain versions);
  4. ViT-L at 384x512 with seeded random weights, bf16 trunk and f32 heads,
     TF32 off: encode, mono (INIT), then FrameTracker.track on a few frames,
     with the launch counters reset just before and read just after;
  5. SLAM.run over a synthetic plane scene at 384x512 with a known
     trajectory (a stand-in model with the encode/asymmetric/mono
     protocol), the trajectory held to a bound.

Phase 4 ends with a torch.profiler breakdown of one more ViT-L tracked
frame (device time by kernel, launches, device busy share).  It prints one
JSON line of kernel numbers, then as its last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# ---------------------------------------------------------------------------
# published H100 SXM peaks (NVIDIA data sheet, dense) for the bounds
# ---------------------------------------------------------------------------
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

ATTN_MAX_ERR = 2.0 ** -6   # 2 bf16 ulps at magnitude 2: the kernel rounds the
ATTN_MEAN_ERR = 2e-3       # softmax weights before normalising, sdpa_xla after
SMALL_MODEL_RTOL = 0.1     # bf16 card path vs bf16 CPU path, relative L2
TRAJ_BOUND_M = 0.005       # synthetic scene: Sim(3)-aligned frame RMSE, metres
N_TRACKED = 5              # ViT-L tracked frames


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_attention(dev, H: int):
    import torch
    import torch.nn.functional as F
    from mast3r_slam_tpu_torch.ops import attention

    B, N, D = 1, 768, 64
    g = torch.Generator(device=dev).manual_seed(H)
    q, k, v = (torch.randn(B, H, N, D, device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3))
    got = attention.sdpa(q, k, v)
    want = attention.sdpa_plain(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    if not (torch.isfinite(got.float()).all() and max_err <= ATTN_MAX_ERR
            and mean_err <= ATTN_MEAN_ERR):
        raise AssertionError(
            f"attention H={H}: max err {max_err} (<= {ATTN_MAX_ERR}), "
            f"mean err {mean_err} (<= {ATTN_MEAN_ERR})")
    ms = time_cuda(lambda: attention.sdpa(q, k, v))
    plain_ms = time_cuda(lambda: attention.sdpa_plain(q, k, v))
    lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(q, k, v))
    flops = 4.0 * B * H * N * N * D
    nbytes = 4.0 * B * H * N * D * 2  # q, k, v read once, out written once
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    res = dict(shape=[B, H, N, D], max_abs_err=max_err, mean_abs_err=mean_err,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"attention (1,{H},768,64) bf16: {json.dumps(res)}")
    return res


def check_refine(dev):
    import torch
    from mast3r_slam_tpu_torch.ops import refine

    B, H, W, F = 1, 384, 512, 24
    N = H * W
    g = torch.Generator(device=dev).manual_seed(7)
    D11 = torch.randn(B, H, W, F, device=dev, generator=g)
    D11 = D11 + 0.7 * torch.roll(D11, 1, 2) + 0.5 * torch.roll(D11, 1, 1)
    D11 = D11 / D11.norm(dim=-1, keepdim=True)
    shift = torch.randint(-6, 7, (B, N, 2), device=dev, generator=g)
    lin = torch.arange(N, device=dev)
    u = (lin % W + shift[..., 0]).clamp(0, W - 1)
    v = (lin // W + shift[..., 1]).clamp(0, H - 1)
    D21 = D11.reshape(B, N, F)[0][v * W + u]
    D21 = D21 + 0.05 * torch.randn(D21.shape, device=dev, generator=g)
    d11q = refine.quantize(D11).reshape(B, N, F).contiguous()
    d21q = refine.quantize(D21).contiguous()
    # start from iter_proj-like positions: the true match plus up to 2 px
    jit = torch.randint(-2, 3, (B, N, 2), device=dev, generator=g)
    su = (u + jit[..., 0]).clamp(1, W - 2)
    sv = (v + jit[..., 1]).clamp(1, H - 2)
    idx = (sv * W + su).to(torch.int32).contiguous()
    res = {}
    for radius, dil in ((3, 5), (1, 1)):
        got = refine.refine_window(d11q, d21q, idx, H, W, radius, dil)
        want = refine.refine_window_plain(d11q, d21q, idx, H, W, radius, dil)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum().item())
        if n_diff:
            raise AssertionError(f"refine ({radius},{dil}): {n_diff} indices differ")
        max_err = int((got.long() - want.long()).abs().max().item())
        moved = (got != idx).float().mean().item()
        log(f"refine (r={radius}, d={dil}) at 384x512 F=24: exact; "
            f"{moved:.3f} of pixels moved")
        if (radius, dil) == (3, 5):
            ms = time_cuda(lambda: refine.refine_window(d11q, d21q, idx, H, W, 3, 5))
            plain_ms = time_cuda(
                lambda: refine.refine_window_plain(d11q, d21q, idx, H, W, 3, 5),
                iters=3, warmup=1)
            nbytes = d11q.numel() + d21q.numel() + idx.numel() * 4 * 2
            # int8 multiply-adds of every candidate at every level; this
            # counts masked border candidates too, an upper bound that does
            # not move the bound (bytes exceed it 15-fold)
            ops = 2.0 * N * F * (2 * radius + 1) ** 2 * dil
            t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
            res = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"refine (r=3, d=5): {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phase 3: a small model, kernels on the card against plain on the CPU
# ---------------------------------------------------------------------------

SMALL_BF16 = dict(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                  dec_depth=12, dec_num_heads=2, feature_dim=64,
                  layer_dims=(32, 64, 96, 128))


def check_small_model(dev):
    import torch
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.interface import MASt3RModel

    cfg = M.ModelConfig(**SMALL_BF16, dtype=torch.bfloat16)
    hw = (64, 96)
    params = M.init_params(cfg, seed=1, device="cpu")
    gpu = MASt3RModel(params, cfg, hw, device=dev)
    cpu = MASt3RModel(params, cfg, hw, device="cpu")
    img = torch.rand(2, 3, *hw, generator=torch.Generator().manual_seed(2)) * 2 - 1

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()

    fg, pg = gpu.encode(img)
    fc, pc = cpu.encode(img)
    out_g = gpu.asymmetric(fg[:1], pg[:1], fg[1:], pg[1:])
    out_c = cpu.asymmetric(fc[:1], pc[:1], fc[1:], pc[1:])
    errs = {"feat": rel(fg, fc)}
    for v, (og, oc) in enumerate(zip(out_g, out_c)):
        for name, a, b in zip("XCDQ", og, oc):
            errs[f"{name}{v}"] = rel(a, b)
    bad = {k: e for k, e in errs.items() if not e <= SMALL_MODEL_RTOL}
    if bad:
        raise AssertionError(f"small model, card vs CPU: relative L2 errors {bad}")
    log("small bf16 model, card (kernels) vs CPU (plain), relative L2: "
        + json.dumps({k: round(e, 5) for k, e in errs.items()}))


# ---------------------------------------------------------------------------
# phase 4: ViT-L main path
# ---------------------------------------------------------------------------

def smooth_images(n, hw, dev, seed):
    """Seeded smooth random images in [-1, 1], (n, 3, H, W)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    low = torch.rand(n, 3, hw[0] // 16, hw[1] // 16, device=dev, generator=g)
    img = F.interpolate(low, size=hw, mode="bilinear", align_corners=False)
    return img * 2 - 1


def profile_frame(dev, model, tracker, img, T, top=25):
    """torch.profiler over one tracked frame (encode + track): the kernels
    with the most device time, the launch count, and the device's busy time
    against the wall time (which the profiler itself lengthens)."""
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mast3r_slam_tpu_torch.slam.frame import Frame

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        feat, pos = model.encode(img)
        tracker.track(Frame(frame_id=1, img=img[0], T_WC=T, feat=feat, pos=pos))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        per_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        per_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in per_name.values())
    log(f"profile of one tracked frame: wall {wall_ms:.3f} ms (profiler on), "
        f"{len(kernels)} kernel launches, device busy {busy_ms:.3f} ms = "
        f"{busy_ms / wall_ms:.3f} of wall")
    for name, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:9.3f} ms  x{n:5d}  {name[:110]}")


def run_vitl(dev, hw=(384, 512), n_tracked=N_TRACKED, mcfg=None):
    """encode + mono (INIT keyframe), then FrameTracker.track on n_tracked
    frames, then one frame timed by stage and one profiled.  Returns (launch
    counts of the tracked frames, ms per frame)."""
    import torch
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.interface import MASt3RModel
    from mast3r_slam_tpu_torch.ops import attention, refine
    from mast3r_slam_tpu_torch.slam.frame import Frame, Keyframes
    from mast3r_slam_tpu_torch.slam.tracker import FrameTracker
    from mast3r_slam_tpu_torch.lie import sim3

    mcfg = mcfg or M.VIT_LARGE
    t0 = time.perf_counter()
    model = MASt3RModel.random_init(0, hw, mcfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"ViT-L random init on the card: {time.perf_counter() - t0:.2f} s")
    cfg = load_config("base")
    kf = Keyframes(8, hw[0] * hw[1], model.num_patches, model.feat_dim, device=dev)
    tracker = FrameTracker(model, cfg, kf, hw, device=dev)
    imgs = smooth_images(n_tracked + 1, hw, dev, seed=3)

    feat, pos = model.encode(imgs[:1])
    X, C = model.mono(feat, pos)
    if not (torch.isfinite(feat).all() and torch.isfinite(X).all() and torch.isfinite(C).all()):
        raise AssertionError("ViT-L encode/mono: non-finite output")
    if tuple(X.shape) != (1, *hw, 3) or tuple(feat.shape) != (1, model.num_patches, mcfg.enc_embed_dim):
        raise AssertionError(f"ViT-L shapes: X {tuple(X.shape)}, feat {tuple(feat.shape)}")
    f0 = Frame(frame_id=0, img=imgs[0], T_WC=sim3.identity(device=dev), feat=feat, pos=pos)
    f0.update_pointmap(X.reshape(-1, 3), C.reshape(-1, 1))
    kf.append(f0)

    attention.counter.reset()
    refine.counter.reset()
    times, decisions = [], []
    T = f0.T_WC
    for i in range(1, n_tracked + 1):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        feat, pos = model.encode(imgs[i:i + 1])
        fr = Frame(frame_id=i, img=imgs[i], T_WC=T, feat=feat, pos=pos)
        new_kf, try_reloc = tracker.track(fr)  # ends in the stats read
        times.append((time.perf_counter() - t0) * 1e3)
        decisions.append((bool(new_kf), bool(try_reloc)))
        stats = tracker.last_stats
        if not np.isfinite(np.delete(stats, 6)).all():  # [6]: score, -inf unless best_score
            raise AssertionError(f"ViT-L frame {i}: non-finite stats {stats}")
    counts = {"attention": attention.counter.count, "refine_window": refine.counter.count}
    log(f"ViT-L tracked frames: ms {[round(t, 3) for t in times]}, "
        f"(new_kf, try_reloc) {decisions}, last stats {np.round(stats, 5).tolist()}")

    # the stages of one frame timed apart (after the counts were read):
    # median of 3 host-clock timings, each between two synchronisations
    from mast3r_slam_tpu_torch.ops import matching

    def timed(fn, reps=3):
        out, ms = None, []
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(ms)

    (feat, pos), enc_ms = timed(lambda: model.encode(imgs[1:2]))
    preds, dec_ms = timed(lambda: model.asymmetric(feat, pos, kf.feat[0][None],
                                                   kf.pos[0][None]))
    (Xii, _, Dii, _), (Xji, _, Dji, _) = preds
    _, match_ms = timed(lambda: matching.match(Xii, Xji, Dii, Dji, tracker.idx_f2k[None]))
    fr = Frame(frame_id=1, img=imgs[1], T_WC=T, feat=feat, pos=pos)
    _, track_ms = timed(lambda: tracker.track(fr))
    split = dict(encode_ms=enc_ms, decode_heads_ms=dec_ms, match_ms=match_ms,
                 track_ms=track_ms, rest_of_track_ms=track_ms - dec_ms - match_ms)
    log("ViT-L frame split (track = decode+heads + match + GN + fusion + stats): "
        + json.dumps({k: round(v, 3) for k, v in split.items()}))
    if dev.type == "cuda":
        profile_frame(dev, model, tracker, imgs[1:2], T)
    return counts, times


# ---------------------------------------------------------------------------
# phase 5: synthetic plane scene, known trajectory
# ---------------------------------------------------------------------------

def quat_to_matrix(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class PlaneSceneModel:
    """Stand-in for MASt3RModel: the encode/asymmetric/mono protocol over a
    closed box of planes seen from known camera poses.  Frame k's image is
    a constant gray level that encodes k; encode puts k in feat[0, 0, 0].
    Pointmaps are exact, descriptors a view-invariant random-Fourier field
    of the world point, confidence varies with depth."""

    def __init__(self, hw, gt, device, seed=0):
        import torch

        self.H, self.W = hw
        self.gt = np.asarray(gt, np.float64)
        self.device = device
        self.feat_dim = 16
        self.num_patches = (self.H // 16) * (self.W // 16)
        f = 0.8 * self.W
        self.K = np.array([[f, 0, self.W / 2], [0, f, self.H / 2], [0, 0, 1.0]])
        self.planes = [(np.array(n, float), c) for n, c in (
            ((0, 1, 0), 1.0), ((0, 0, 1), 4.0), ((1, 0, 0), 3.0),
            ((-1, 0, 0), 3.0), ((0, -1, 0), 3.0), ((0, 0, -1), 4.0))]
        rng = np.random.default_rng(seed)
        # frequencies grow with the resolution so that neighbouring pixels
        # keep distinct int8 descriptors (about 0.1 rad a pixel at depth 3 m)
        self.Wd = rng.normal(size=(24, 3)) * 2.0 * self.W / 64
        self.bd = rng.uniform(0, 2 * np.pi, size=24)
        u, v = np.meshgrid(np.arange(self.W), np.arange(self.H))
        rays = np.stack([(u - self.K[0, 2]) / f, (v - self.K[1, 2]) / f,
                         np.ones_like(u, float)], -1).reshape(-1, 3)
        self.rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        self._torch = torch

    @staticmethod
    def image_value(fid):
        return (fid + 1) / 255.0 * 2 - 1

    def preprocessed(self, fid):
        img = np.full((3, self.H, self.W), self.image_value(fid), np.float32)
        return dict(img=img)

    def _render(self, fid):
        T = self.gt[fid]
        R, t = quat_to_matrix(T[3:7]), T[:3]
        d_w = self.rays @ R.T
        lam = np.full(len(d_w), np.inf)
        for n, c in self.planes:
            den = d_w @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                li = np.where(np.abs(den) > 1e-9, (c - t @ n) / den, np.inf)
            lam = np.minimum(lam, np.where(li > 0.05, li, np.inf))
        X_cam = self.rays * lam[:, None]
        Xw = X_cam @ R.T * T[7] + t
        D = np.sin(Xw @ self.Wd.T + self.bd)
        D /= np.linalg.norm(D, axis=-1, keepdims=True) + 1e-12
        C = 1.6 + 1.0 / (1.0 + np.linalg.norm(X_cam, axis=-1))
        return X_cam, D, C

    def _t(self, a, shape):
        return self._torch.as_tensor(np.asarray(a, np.float32).reshape(shape),
                                     device=self.device)

    def encode(self, img):
        fid = int(round((float(img.float().mean()) + 1) / 2 * 255)) - 1
        feat = self._torch.zeros(1, self.num_patches, self.feat_dim, device=self.device)
        feat[0, 0, 0] = fid
        pos = self._torch.zeros(1, self.num_patches, 2, dtype=self._torch.int32,
                                device=self.device)
        return feat, pos

    @staticmethod
    def _fid(feat):
        return int(round(float(feat[0, 0, 0])))

    def asymmetric(self, feat_i, pos_i, feat_j, pos_j):
        fi, fj = self._fid(feat_i), self._fid(feat_j)
        Xi, Di, Ci = self._render(fi)
        Xj, Dj, Cj = self._render(fj)
        Ti, Tj = self.gt[fi], self.gt[fj]
        Ri, Rj = quat_to_matrix(Ti[3:7]), quat_to_matrix(Tj[3:7])
        Xw = Xj @ Rj.T * Tj[7] + Tj[:3]
        Xji = (Xw - Ti[:3]) @ Ri / Ti[7]  # j's points in i's frame
        H, W = self.H, self.W
        Q = np.full((H, W), 2.0)
        res_ii = (self._t(Xi, (1, H, W, 3)), self._t(Ci, (1, H, W)),
                  self._t(Di, (1, H, W, 24)), self._t(Q, (1, H, W)))
        res_ji = (self._t(Xji, (1, H, W, 3)), self._t(Cj, (1, H, W)),
                  self._t(Dj, (1, H, W, 24)), self._t(Q, (1, H, W)))
        return res_ii, res_ji

    def mono(self, feat, pos):
        X, _, C = self._render(self._fid(feat))
        return self._t(X, (1, self.H, self.W, 3)), self._t(C, (1, self.H, self.W))


class PlaneSceneDataset:
    def __init__(self, model, n):
        self.model = model
        self.n = n
        self.timestamps = [f"{i / 30.0:.6f}" for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.timestamps[i], None

    def preprocessed(self, i):
        return self.model.preprocessed(i)


def arc_trajectory(n, radius=0.5, max_angle=2.0):
    """A sideways arc with a slow yaw: a few pixels of motion per frame at
    384x512, as a hand-held camera at video rate gives."""
    poses = []
    for k in range(n):
        s = k / max(n - 1, 1)
        t = np.array([radius * np.sin(s * max_angle * 2), 0.2 * s, 0.3 * s])
        yaw = -0.4 * max_angle * s
        q = np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)])
        poses.append(np.concatenate([t, q, [1.0]]))
    return np.asarray(poses)


def umeyama_rmse(est, gt):
    """RMSE of est (n, 3) after the best similarity onto gt (n, 3)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    U, S, Vt = np.linalg.svd(g.T @ e / len(est))
    Dm = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Dm[2, 2] = -1
    R = U @ Dm @ Vt
    s = np.trace(np.diag(S) @ Dm) / max((e ** 2).sum() / len(est), 1e-12)
    aligned = (s * (R @ e.T)).T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, -1))))


def run_synthetic_slam(dev, hw=(384, 512), n_frames=16):
    """SLAM.run over the plane scene.  Returns (ATE, result, launch counts)."""
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.ops import attention, refine
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM

    gt = arc_trajectory(n_frames)
    model = PlaneSceneModel(hw, gt, dev)
    cfg = load_config("base")
    cfg["single_thread"] = True
    slam = SLAM(model, cfg, hw, keyframe_buffer=16, device=dev)
    attention.counter.reset()
    refine.counter.reset()
    t0 = time.perf_counter()
    res = slam.run(PlaneSceneDataset(model, n_frames), verbose=False)
    wall = time.perf_counter() - t0
    counts = {"attention": attention.counter.count, "refine_window": refine.counter.count}
    ate = umeyama_rmse(res.frame_poses[:, :3].astype(np.float64), gt[:, :3])
    log(f"synthetic SLAM.run {hw[0]}x{hw[1]}, {n_frames} frames: {wall:.2f} s, "
        f"{res.n_keyframes} keyframes, {res.n_reloc} reloc, frame ATE {ate:.6f} m, "
        f"launches {counts}")
    return ate, res, counts


# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from mast3r_slam_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False        # f32 convolutions too
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn TF32 {torch.backends.cudnn.allow_tf32}")
    log(smi)

    t0 = time.perf_counter()
    paths = kernels.build_all()
    log(f"built {sorted(paths)} from {kernels.CSRC_DIR.name}/ in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in sorted(kernels.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas {name}: {line.strip()}")

    attn_enc = check_attention(dev, 16)
    check_attention(dev, 12)
    ref = check_refine(dev)
    check_small_model(dev)

    counts, times = run_vitl(dev)
    want = {"attention": 72 * N_TRACKED, "refine_window": N_TRACKED}
    if counts != want:
        raise AssertionError(f"ViT-L launches {counts}, expected {want} "
                             f"(72 attention + 1 refine per tracked frame)")
    frame_ms = statistics.median(times)
    log(f"ViT-L 384x512 tracked frame (encode + decode + track): median "
        f"{frame_ms:.3f} ms over {N_TRACKED} frames; launches {counts}")

    ate, res, slam_counts = run_synthetic_slam(dev)
    n_tracked = len(res.frame_poses) - 1 - res.n_reloc
    if res.n_reloc or ate > TRAJ_BOUND_M or res.n_keyframes < 2:
        raise AssertionError(
            f"synthetic scene: ATE {ate} m (bound {TRAJ_BOUND_M}), "
            f"{res.n_reloc} reloc, {res.n_keyframes} keyframes")
    if slam_counts != {"attention": 0, "refine_window": n_tracked}:
        raise AssertionError(f"synthetic SLAM.run launches {slam_counts}")

    common = lambda r: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}
    line = {"kernels": [
        dict(name="attention", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/attention.cu",
             replaces="mast3r_slam_tpu/ops/attention.py:52",
             launches=counts["attention"], shape=attn_enc["shape"], **common(attn_enc)),
        dict(name="refine_window", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/refine_window.cu",
             replaces="mast3r_slam_tpu/ops/refine_pallas.py:70",
             launches=counts["refine_window"], shape=[1, 384 * 512, 24], **common(ref)),
    ], "tracked_frame_ms": frame_ms, "synthetic_ate_m": ate}
    log(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
