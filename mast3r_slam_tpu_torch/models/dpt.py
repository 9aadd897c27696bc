"""DPT dense-prediction head (port of ``mast3r_slam_tpu/models/dpt.py``).

``dpt_forward`` takes the hook tokens and returns an NHWC map, the JAX
package's layout at the boundary.  Inside, maps are NCHW and convolutions go
through ``F.conv2d`` with OIHW weights (the converter turns the JAX HWIO
weights around once).  The kernel == stride transposed convolutions keep the
JAX package's matmul + depth-to-space form, weight (Cin, k*k*Cout), and the
x2 align-corners bilinear upsample keeps its two interpolation-matrix
products.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def conv2d(p, x, stride: int = 1, padding: int = 0):
    """x (B, Cin, H, W) -> (B, Cout, H', W'); weight OIHW."""
    b = p.get("b")
    return F.conv2d(x, p["w"].to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding)


def conv_transpose_same_k_s(p, x, k: int):
    """ConvTranspose2d with kernel == stride as a matmul + depth-to-space:
    y[b, o, i*k+di, j*k+dj] = sum_c x[b, c, i, j] w[c, (di*k+dj)*Cout + o]."""
    B, _, H, W = x.shape
    w = p["w"].to(x.dtype)
    Cout = w.shape[1] // (k * k)
    y = x.permute(0, 2, 3, 1) @ w  # (B, H, W, k*k*Cout)
    y = y.reshape(B, H, W, k, k, Cout).permute(0, 5, 1, 3, 2, 4)
    y = y.reshape(B, Cout, H * k, W * k)
    if "b" in p:
        y = y + p["b"].to(x.dtype)[None, :, None, None]
    return y


@lru_cache(maxsize=64)
def _interp_matrix_ac(n_out: int, n_in: int) -> np.ndarray:
    """align_corners=True bilinear interpolation matrix (n_out, n_in)."""
    A = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1:
        A[:, 0] = 1.0
        return A
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = src - i0
    A[np.arange(n_out), i0] = 1.0 - frac
    A[np.arange(n_out), i0 + 1] = frac
    return A


def upsample2x_align_corners(x):
    """(B, C, H, W) -> (B, C, 2H, 2W), bilinear with align_corners=True."""
    _, _, H, W = x.shape
    Ah = torch.as_tensor(_interp_matrix_ac(2 * H, H), device=x.device).to(x.dtype)
    Aw = torch.as_tensor(_interp_matrix_ac(2 * W, W), device=x.device).to(x.dtype)
    y = torch.einsum("oh,bchw->bcow", Ah, x)
    return torch.einsum("pw,bcow->bcop", Aw, y)


def residual_conv_unit(p, x):
    out = F.relu(x)
    out = conv2d(p["conv1"], out, padding=1)
    out = F.relu(out)
    out = conv2d(p["conv2"], out, padding=1)
    return out + x


def feature_fusion_block(p, x, res=None):
    """Skip-merge, refine, 1x1 out-conv, x2 upsample (the 1x1 conv commutes
    exactly with the convex upsample, so it runs at the small scale)."""
    if res is not None:
        x = x + residual_conv_unit(p["res1"], res)
    x = residual_conv_unit(p["res2"], x)
    x = conv2d(p["out_conv"], x)
    return upsample2x_align_corners(x)


def dpt_forward(p, hook_tokens, grid_hw, num_channels: int):
    """hook_tokens: 4 arrays (B, N, C_hook); returns (B, nh*16, nw*16, num_channels)."""
    nh, nw = grid_hw

    def to_map(tok):
        B, N, C = tok.shape
        return tok.reshape(B, nh, nw, C).permute(0, 3, 1, 2)

    l1, l2, l3, l4 = [to_map(t) for t in hook_tokens]

    l1 = conv_transpose_same_k_s(p["act1"]["convt"], conv2d(p["act1"]["conv"], l1), 4)
    l2 = conv_transpose_same_k_s(p["act2"]["convt"], conv2d(p["act2"]["conv"], l2), 2)
    l3 = conv2d(p["act3"]["conv"], l3)
    l4 = conv2d(p["act4"]["conv"], l4)
    l4 = conv2d(p["act4"]["conv2"], l4, stride=2, padding=1)

    l1 = conv2d(p["rn1"], l1, padding=1)
    l2 = conv2d(p["rn2"], l2, padding=1)
    l3 = conv2d(p["rn3"], l3, padding=1)
    l4 = conv2d(p["rn4"], l4, padding=1)

    path4 = feature_fusion_block(p["refine4"], l4)
    path4 = path4[:, :, : l3.shape[2], : l3.shape[3]]
    path3 = feature_fusion_block(p["refine3"], path4, l3)
    path3 = path3[:, :, : l2.shape[2], : l2.shape[3]]
    path2 = feature_fusion_block(p["refine2"], path3, l2)
    path2 = path2[:, :, : l1.shape[2], : l1.shape[3]]
    path1 = feature_fusion_block(p["refine1"], path2, l1)

    out = conv2d(p["head"]["conv1"], path1, padding=1)
    out = upsample2x_align_corners(out)
    out = conv2d(p["head"]["conv2"], out, padding=1)
    out = F.relu(out)
    out = conv2d(p["head"]["conv3"], out)
    return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# random init (shapes of the JAX package's init_dpt, weights OIHW)
# ---------------------------------------------------------------------------

def init_conv(gen, kh, kw, cin, cout, device, bias=True):
    bound = math.sqrt(3.0 / (kh * kw * cin))
    w = torch.empty((cout, cin, kh, kw), device=device).uniform_(-bound, bound, generator=gen)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(cout, device=device)
    return p


def init_conv_t(gen, cin, cout, k, device):
    w = torch.empty((cin, k * k * cout), device=device).normal_(0.0, 0.02, generator=gen)
    return {"w": w, "b": torch.zeros(cout, device=device)}


def init_rcu(gen, c, device):
    return {"conv1": init_conv(gen, 3, 3, c, c, device),
            "conv2": init_conv(gen, 3, 3, c, c, device)}


def init_fusion(gen, c, device):
    return {"res1": init_rcu(gen, c, device), "res2": init_rcu(gen, c, device),
            "out_conv": init_conv(gen, 1, 1, c, c, device)}


def init_dpt(gen, dim_tokens, device, layer_dims=(96, 192, 384, 768),
             feature_dim=256, last_dim=128, num_channels=4):
    d1, d2, d3, d4 = layer_dims
    return {
        "act1": {"conv": init_conv(gen, 1, 1, dim_tokens[0], d1, device),
                 "convt": init_conv_t(gen, d1, d1, 4, device)},
        "act2": {"conv": init_conv(gen, 1, 1, dim_tokens[1], d2, device),
                 "convt": init_conv_t(gen, d2, d2, 2, device)},
        "act3": {"conv": init_conv(gen, 1, 1, dim_tokens[2], d3, device)},
        "act4": {"conv": init_conv(gen, 1, 1, dim_tokens[3], d4, device),
                 "conv2": init_conv(gen, 3, 3, d4, d4, device)},
        "rn1": init_conv(gen, 3, 3, d1, feature_dim, device, bias=False),
        "rn2": init_conv(gen, 3, 3, d2, feature_dim, device, bias=False),
        "rn3": init_conv(gen, 3, 3, d3, feature_dim, device, bias=False),
        "rn4": init_conv(gen, 3, 3, d4, feature_dim, device, bias=False),
        "refine1": init_fusion(gen, feature_dim, device),
        "refine2": init_fusion(gen, feature_dim, device),
        "refine3": init_fusion(gen, feature_dim, device),
        "refine4": init_fusion(gen, feature_dim, device),
        "head": {
            "conv1": init_conv(gen, 3, 3, feature_dim, feature_dim // 2, device),
            "conv2": init_conv(gen, 3, 3, feature_dim // 2, last_dim, device),
            "conv3": init_conv(gen, 1, 1, last_dim, num_channels, device),
        },
    }
