"""Transformer primitives of the two-view ViT, as plain functions on tensors.

Port of ``mast3r_slam_tpu/models/layers.py``.  Parameters are nested dicts
of tensors; linear weights are stored (in, out) so a layer is ``x @ w``.
Compute runs in the input's dtype (bf16 trunk, f32 heads); layer norm keeps
its statistics and affine in f32.  Every attention goes through
``ops.attention.sdpa``: the hand-written kernel on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.attention import sdpa

LN_EPS = 1e-6


def layer_norm(p, x):
    """LayerNorm over the last axis; statistics and affine in f32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    c = xf - mu
    var = (c * c).mean(dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + LN_EPS)
    y = y * p["w"] + p["b"]
    return y.to(x.dtype)


def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def mlp(p, x):
    h = F.gelu(linear(p["fc1"], x), approximate="none")
    return linear(p["fc2"], h)


# ---------------------------------------------------------------------------
# RoPE2D
# ---------------------------------------------------------------------------

def rope2d_tables(pos, head_dim: int, base: float = 100.0, dtype=torch.float32):
    """cos/sin tables (B, N, head_dim) for 2D rotary embedding of (y, x) pos."""
    d_half = head_dim // 2
    n_freq = d_half // 2
    inv_freq = 1.0 / (base ** (
        torch.arange(n_freq, dtype=torch.float32, device=pos.device) * 2.0 / d_half))
    ang_y = pos[..., 0:1].float() * inv_freq
    ang_x = pos[..., 1:2].float() * inv_freq
    ang = torch.cat([ang_y, ang_y, ang_x, ang_x], dim=-1)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _rotate_half_per_half(x):
    q = x.shape[-1] // 4
    x1, x2, x3, x4 = x[..., :q], x[..., q:2 * q], x[..., 2 * q:3 * q], x[..., 3 * q:]
    return torch.cat([-x2, x1, -x4, x3], dim=-1)


def apply_rope2d(tokens, cos, sin):
    """tokens (B, H, N, D); cos/sin (B, N, D) broadcast over heads."""
    c = cos[:, None].to(tokens.dtype)
    s = sin[:, None].to(tokens.dtype)
    return tokens * c + _rotate_half_per_half(tokens) * s


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _split_heads(x, num_heads):
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def _merge_heads(x):
    B, H, N, D = x.shape
    return x.transpose(1, 2).reshape(B, N, H * D)


def self_attention(p, x, rope_cs, num_heads: int):
    """Fused-qkv self-attention with RoPE on q and k."""
    B, N, C = x.shape
    qkv = linear(p["qkv"], x).reshape(B, N, 3, num_heads, C // num_heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)  # (3, B, H, N, D)
    q, k, v = qkv[0], qkv[1], qkv[2]
    if rope_cs is not None:
        q = apply_rope2d(q, *rope_cs)
        k = apply_rope2d(k, *rope_cs)
    out = sdpa(q.contiguous(), k.contiguous(), v.contiguous())
    return linear(p["proj"], _merge_heads(out))


def cross_attention(p, x, mem, rope_q, rope_k, num_heads: int):
    """Cross-attention with separate q/k/v projections."""
    q = _split_heads(linear(p["q"], x), num_heads)
    k = _split_heads(linear(p["k"], mem), num_heads)
    v = _split_heads(linear(p["v"], mem), num_heads)
    if rope_q is not None:
        q = apply_rope2d(q, *rope_q)
    if rope_k is not None:
        k = apply_rope2d(k, *rope_k)
    out = sdpa(q.contiguous(), k.contiguous(), v.contiguous())
    return linear(p["proj"], _merge_heads(out))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def encoder_block(p, x, rope_cs, num_heads: int):
    x = x + self_attention(p["attn"], layer_norm(p["norm1"], x), rope_cs, num_heads)
    x = x + mlp(p["mlp"], layer_norm(p["norm2"], x))
    return x


def decoder_block(p, x, y, rope_x, rope_y, num_heads: int):
    """Self-attention -> cross-attention over the normed memory y -> MLP."""
    x = x + self_attention(p["attn"], layer_norm(p["norm1"], x), rope_x, num_heads)
    y_ = layer_norm(p["norm_y"], y)
    x = x + cross_attention(
        p["cross_attn"], layer_norm(p["norm2"], x), y_, rope_x, rope_y, num_heads)
    x = x + mlp(p["mlp"], layer_norm(p["norm3"], x))
    return x


# ---------------------------------------------------------------------------
# random init (the JAX package's scheme, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

def _uniform(shape, bound, gen, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(-bound, bound, generator=gen)


def init_linear(gen, d_in, d_out, device, bias=True):
    p = {"w": _uniform((d_in, d_out), math.sqrt(6.0 / (d_in + d_out)), gen, device)}
    if bias:
        p["b"] = torch.zeros(d_out, device=device)
    return p


def init_layer_norm(dim, device):
    return {"w": torch.ones(dim, device=device), "b": torch.zeros(dim, device=device)}


def init_mlp(gen, dim, hidden, device):
    return {"fc1": init_linear(gen, dim, hidden, device),
            "fc2": init_linear(gen, hidden, dim, device)}


def init_encoder_block(gen, dim, device, mlp_ratio=4):
    return {
        "norm1": init_layer_norm(dim, device),
        "attn": {"qkv": init_linear(gen, dim, 3 * dim, device),
                 "proj": init_linear(gen, dim, dim, device)},
        "norm2": init_layer_norm(dim, device),
        "mlp": init_mlp(gen, dim, dim * mlp_ratio, device),
    }


def init_decoder_block(gen, dim, device, mlp_ratio=4):
    return {
        "norm1": init_layer_norm(dim, device),
        "attn": {"qkv": init_linear(gen, dim, 3 * dim, device),
                 "proj": init_linear(gen, dim, dim, device)},
        "norm2": init_layer_norm(dim, device),
        "norm3": init_layer_norm(dim, device),
        "norm_y": init_layer_norm(dim, device),
        "cross_attn": {k: init_linear(gen, dim, dim, device)
                       for k in ("q", "k", "v", "proj")},
        "mlp": init_mlp(gen, dim, dim * mlp_ratio, device),
    }
