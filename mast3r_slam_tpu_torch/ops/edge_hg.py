"""Per-edge ray+distance normal-equation blocks: the CUDA kernel and its plain form.

Port of ``mast3r_slam_tpu/ops/edge_hg_pallas.py``.  For every edge e and
pixel n of the global solve's ray mode, with P = Tij[e]·Xj[e, n]:

    residual  (P/|P| - Xi/|Xi|,  |P| - |Xi|)            4 rows
    rows      [dr/dP | -[rj]x | 0 | e_k] (k < 3),  [rj | 0 0 0 | |P| | e_3]
    weight    w = huber(sw·e)·sw²,  sw = sq/sigma_ray (rows 0-2), sq/sigma_dist
    Mloc[e] = sum_n sum_rows w·B·Bᵀ                      (8x8, local frame)

Norms are ``sqrt(max(|x|², 1e-12))``, so zero or garbage points under
sq = 0 stay finite and contribute exactly nothing.

Layout: points pixel-major, Xi / Xj (E, N, 3) and sq (E, N), f32 and
contiguous: the layout the solve's gather and the gathered-point cache
produce, so no transpose is needed.  The kernel reads a pixel's 12 bytes
per array with three loads whose 32-lane footprint is three whole 128-byte
lines, used in full through L1.

``edge_hg_rays`` launches ``csrc/edge_hg_rays.cu`` (one cooperative kernel
a call over (edge, tile) items sized to fill the card, their partial sums
in a ``torch.empty`` scratch) on CUDA tensors or raises; it runs
``edge_hg_rays_plain`` only on CPU tensors.  The kernel counts its own
runs in a device counter (``counter.runs``), so the launches that the
global solve's device program captures are counted each time it replays
them, where they run.
"""

from __future__ import annotations

import torch

from ..lie import sim3
from ..utils.numerics import full_f32
from . import kernels
from .robust import huber_weight

counter = kernels.LaunchCounter("edge_hg_rays")

# a tile (one block's share of an edge) holds at least this many pixels;
# below it a block's fixed costs (the edge's transform, the first loads'
# latency, its reduction) outweigh its pixels
MIN_TILE_PIXELS = 2048
_slots: dict = {}  # blocks the kernel holds at once, by CUDA device index
_EPS = 1e-12


def ray_residuals(Tij, Xi, Xj):
    """Ray+distance residuals and local Jacobian rows, batched over edges.

    Tij: (E, 8); Xi, Xj: (E, N, 3).  Returns (err (E, N, 4), J (E, N, 4, 7)),
    the rows with respect to a left perturbation of the j-point in i's frame
    (``global_gn._ray_residuals`` of the JAX package).
    """
    ni = torch.sqrt(torch.clamp_min(torch.sum(Xi * Xi, dim=-1, keepdim=True), _EPS))
    ri = Xi / ni
    P = sim3.act(Tij[:, None, :], Xj)
    nj = torch.sqrt(torch.clamp_min(torch.sum(P * P, dim=-1, keepdim=True), _EPS))
    rj = P / nj
    err = torch.cat([rj - ri, nj - ni], dim=-1)

    eye = torch.eye(3, dtype=Xi.dtype, device=Xi.device)
    dr_dP = (eye - rj[..., :, None] * rj[..., None, :]) / nj[..., None]
    rx, ry, rz = rj.unbind(-1)
    o = torch.zeros_like(rx)
    neg_skew = torch.stack([o, rz, -ry, -rz, o, rx, ry, -rx, o], dim=-1)
    neg_skew = neg_skew.reshape(rj.shape[:-1] + (3, 3))
    J_ray = torch.cat([dr_dP, neg_skew, torch.zeros_like(dr_dP[..., :1])], dim=-1)
    J_dist = torch.cat([rj, torch.zeros_like(rj), nj], dim=-1)[..., None, :]
    return err, torch.cat([J_ray, J_dist], dim=-2)


def reduce_blocks(w, err, J):
    """Mloc (E, 8, 8) = sum over pixels and rows of w·[J|err]ᵀ[J|err].

    w, err: (E, N, R); J: (E, N, R, 7).  One (8, N·R) x (N·R, 8) product per
    edge, in full f32 on the card."""
    E = err.shape[0]
    Jb = torch.cat([J, err[..., None]], dim=-1).reshape(E, -1, 8)
    wJb = w.reshape(E, -1, 1) * Jb
    with full_f32():
        return torch.bmm(wJb.transpose(1, 2), Jb)


def edge_hg_rays_plain(Tij, Xi, Xj, sq, *, sigma_ray: float, sigma_dist: float,
                       huber_k: float):
    """The blocks in plain torch: Tij (E, 8), Xi/Xj (E, N, 3), sq (E, N)
    valid·sqrt(q) -> Mloc (E, 8, 8) f32."""
    err, J = ray_residuals(Tij, Xi, Xj)
    sw = torch.stack([sq / sigma_ray] * 3 + [sq / sigma_dist], dim=-1)
    w = huber_weight(sw * err, huber_k) * sw * sw
    return reduce_blocks(w, err, J)


def block_err(got, want) -> float:
    """Largest error of (E, 8, 8) blocks, entry by entry, on the scale the
    solve reads them at: |got_ij - want_ij| / sqrt(|want_ii|·|want_jj|).

    The diagonal is H's for the seven pose columns and the robust cost
    Mloc[7, 7] for the error column, so a gradient entry is held against
    sqrt(H_ii·cost) (its Cauchy-Schwarz bound), the distance row's scale
    entry against its own diagonal and the cost against itself: no entry
    hides under the largest one.  Computed in float64."""
    got, want = got.double(), want.double()
    d = torch.diagonal(want, dim1=-2, dim2=-1).abs()
    scale = torch.sqrt(d[..., :, None] * d[..., None, :])
    diff = (got - want).abs()
    # an all-invalid edge has an all-zero block: there only exact zeros pass
    err = torch.where(scale > 0, diff / scale.clamp_min(1e-300),
                      torch.where(diff > 0, torch.inf, 0.0))
    return err.max().item() if err.numel() else 0.0


def edge_hg_rays_cuda(Tij, Xi, Xj, sq, *, sigma_ray: float, sigma_dist: float,
                      huber_k: float):
    """Launch the edge-block kernel; raises on anything it does not take."""
    for name, t in (("Tij", Tij), ("Xi", Xi), ("Xj", Xj), ("sq", sq)):
        if not t.is_cuda:
            raise ValueError(f"edge_hg_rays_cuda: {name} is not on a CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"edge_hg_rays_cuda: {name} is {t.dtype}, the kernel "
                             "takes float32")
        if not t.is_contiguous():
            raise ValueError(f"edge_hg_rays_cuda: {name} is not contiguous")
        if t.device != Xi.device:
            raise ValueError("edge_hg_rays_cuda: inputs are on different devices")
    if Xi.ndim != 3 or Xi.shape[-1] != 3:
        raise ValueError(f"edge_hg_rays_cuda: Xi has shape {tuple(Xi.shape)}, "
                         "expected (E, N, 3)")
    E, N, _ = Xi.shape
    if Tij.shape != (E, 8) or Xj.shape != (E, N, 3) or sq.shape != (E, N):
        raise ValueError(
            f"edge_hg_rays_cuda: shapes Tij {tuple(Tij.shape)}, Xi {tuple(Xi.shape)}, "
            f"Xj {tuple(Xj.shape)}, sq {tuple(sq.shape)}; expected (E, 8), "
            "(E, N, 3), (E, N, 3), (E, N)")
    out = torch.empty((E, 8, 8), dtype=torch.float32, device=Xi.device)
    if E == 0:
        return out
    if N == 0:
        return out.zero_()
    fn = kernels.entry_point("edge_hg_rays")
    with torch.cuda.device(Xi.device):
        slots = card_slots(Xi.device)
        # tiles an edge: enough (edge, tile) items to fill the card at once
        tiles = max(1, min(slots // E, -(-N // MIN_TILE_PIXELS)))
        partial = torch.empty((E * tiles, 36), dtype=torch.float32, device=Xi.device)
        stream = torch.cuda.current_stream(Xi.device).cuda_stream
        # the kernel counts its own runs on the card, replays of a captured
        # launch among them (ops/global_gn.py's device program)
        rc = fn(Tij.data_ptr(), Xi.data_ptr(), Xj.data_ptr(), sq.data_ptr(),
                partial.data_ptr(), out.data_ptr(), counter.runs(Xi.device).data_ptr(), E, N,
                tiles, slots, 1.0 / sigma_ray, 1.0 / sigma_dist, huber_k, stream)
    kernels.check(rc, "edge_hg_rays_f32")
    return out


def card_slots(device) -> int:
    """Blocks of the kernel that ``device`` holds at once (its library loaded,
    the occupancy queried and the run count made at the first call; kept by
    device)."""
    device = torch.device(device)
    counter.runs(device)
    slots = _slots.get(device.index)
    if slots is None:
        with torch.cuda.device(device):
            slots = kernels.entry_point("edge_hg_rays_slots")()
        if slots <= 0:
            raise RuntimeError("edge_hg_rays_slots: the card's occupancy query failed")
        _slots[device.index] = slots
    return slots


def edge_hg_rays(Tij, Xi, Xj, sq, *, sigma_ray: float, sigma_dist: float,
                 huber_k: float):
    """The blocks on the tensors' device: the kernel on CUDA, the plain form on CPU."""
    kw = dict(sigma_ray=sigma_ray, sigma_dist=sigma_dist, huber_k=huber_k)
    if Xi.device.type == "cpu":
        return edge_hg_rays_plain(Tij, Xi, Xj, sq, **kw)
    return edge_hg_rays_cuda(Tij, Xi, Xj, sq, **kw)
