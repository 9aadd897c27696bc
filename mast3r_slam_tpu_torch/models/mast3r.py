"""Two-view pointmap ViT (MASt3R class), port of ``mast3r_slam_tpu/models/mast3r.py``.

Siamese ViT encoder with RoPE2d, dual cross-attention decoder, DPT
pointmap/confidence heads and the local-feature descriptor MLP, then the
exp-depth / exp-conf / unit-descriptor postprocess.  The trunk computes in
``cfg.dtype`` (bf16 for ViT-L), the heads in ``cfg.head_dtype`` (f32).
Parameters are nested dicts of tensors; the encoder and decoder blocks are
lists of per-block dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from . import dpt as dpt_mod
from ..utils.numerics import vnorm, vnormalize
from .layers import (
    decoder_block,
    encoder_block,
    init_decoder_block,
    init_encoder_block,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
    mlp,
    rope2d_tables,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: int = 4
    rope_base: float = 100.0
    desc_dim: int = 24
    feature_dim: int = 256
    layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    conf_offset: float = 1.0
    desc_conf_offset: float = 0.0
    dtype: Any = torch.bfloat16      # trunk compute dtype
    head_dtype: Any = torch.float32  # DPT / local-MLP head compute dtype

    @property
    def head_dim_enc(self):
        return self.enc_embed_dim // self.enc_num_heads

    @property
    def head_dim_dec(self):
        return self.dec_embed_dim // self.dec_num_heads

    def grid(self, img_hw):
        return (img_hw[0] // self.patch_size, img_hw[1] // self.patch_size)


VIT_LARGE = ModelConfig()
VIT_TINY_TEST = ModelConfig(
    enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
    dec_embed_dim=48, dec_depth=12, dec_num_heads=4,
    dtype=torch.float32,
)

_TRUNK_KEYS = ("patch_embed", "enc_blocks", "decoder_embed", "dec_blocks", "dec_blocks2")


def cast_trunk_params(params, cfg: ModelConfig) -> Dict[str, Any]:
    """Store trunk matmul weights ("w" leaves outside layer norms) in the
    trunk dtype; norms and biases stay f32.  Bitwise the same results as
    casting at each use (``linear`` computes in the input's dtype)."""

    def go(node, in_norm=False):
        if isinstance(node, dict):
            return {k: (go(v, in_norm or k.startswith("norm")) if k != "w"
                        else (v if in_norm else v.to(cfg.dtype)))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [go(v, in_norm) for v in node]
        return node

    out = dict(params)
    for k in _TRUNK_KEYS:
        out[k] = go(params[k])
    return out


def init_params(cfg: ModelConfig = VIT_LARGE, seed: int = 0, device="cpu"):
    """Random parameters with the JAX package's shapes and init scheme,
    drawn from a ``torch.Generator`` on ``device`` seeded with ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    P = cfg.patch_size

    def head():
        idim = cfg.enc_embed_dim + cfg.dec_embed_dim
        return {
            "dpt": dpt_mod.init_dpt(
                gen,
                (cfg.enc_embed_dim,) + (cfg.dec_embed_dim,) * 3,
                device,
                layer_dims=cfg.layer_dims,
                feature_dim=cfg.feature_dim,
                last_dim=cfg.feature_dim // 2,
                num_channels=4,
            ),
            "local_mlp": {
                "fc1": init_linear(gen, idim, 4 * idim, device),
                "fc2": init_linear(gen, 4 * idim, (cfg.desc_dim + 1) * P * P, device),
            },
        }

    patch_w = torch.empty((P * P * 3, cfg.enc_embed_dim), device=device)
    params = {
        "patch_embed": {"w": patch_w.normal_(0.0, 0.02, generator=gen),
                        "b": torch.zeros(cfg.enc_embed_dim, device=device)},
        "enc_blocks": [init_encoder_block(gen, cfg.enc_embed_dim, device, cfg.mlp_ratio)
                       for _ in range(cfg.enc_depth)],
        "enc_norm": init_layer_norm(cfg.enc_embed_dim, device),
        "decoder_embed": init_linear(gen, cfg.enc_embed_dim, cfg.dec_embed_dim, device),
        "dec_blocks": [init_decoder_block(gen, cfg.dec_embed_dim, device, cfg.mlp_ratio)
                       for _ in range(cfg.dec_depth)],
        "dec_blocks2": [init_decoder_block(gen, cfg.dec_embed_dim, device, cfg.mlp_ratio)
                        for _ in range(cfg.dec_depth)],
        "dec_norm": init_layer_norm(cfg.dec_embed_dim, device),
        "head1": head(),
        "head2": head(),
    }
    return cast_trunk_params(params, cfg)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def patch_positions(batch: int, grid_hw, device) -> torch.Tensor:
    """(B, N, 2) integer (y, x) positions, row-major token order."""
    nh, nw = grid_hw
    yy, xx = torch.meshgrid(
        torch.arange(nh, dtype=torch.int32, device=device),
        torch.arange(nw, dtype=torch.int32, device=device),
        indexing="ij",
    )
    pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)
    return pos.expand(batch, nh * nw, 2).contiguous()


def patchify(img, patch_size: int):
    """(B, 3, H, W) -> (B, N, P*P*3) in (dy, dx, c) intra-patch order."""
    B, C, H, W = img.shape
    P = patch_size
    x = img.permute(0, 2, 3, 1).reshape(B, H // P, P, W // P, P, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // P) * (W // P), P * P * C)


def encode_image(params, cfg: ModelConfig, img):
    """img (B, 3, H, W) in [-1, 1] -> (feat (B, N, D) f32, pos (B, N, 2) int32)."""
    B, _, H, W = img.shape
    grid = cfg.grid((H, W))
    x = linear(params["patch_embed"], patchify(img.to(cfg.dtype), cfg.patch_size))
    pos = patch_positions(B, grid, img.device)
    rope_cs = rope2d_tables(pos, cfg.head_dim_enc, cfg.rope_base)
    for bp in params["enc_blocks"]:
        x = encoder_block(bp, x, rope_cs, cfg.enc_num_heads)
    x = layer_norm(params["enc_norm"], x)
    return x.float(), pos


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def decode(params, cfg: ModelConfig, feat1, pos1, feat2, pos2):
    """Dual-branch cross-attention decode.  Returns per branch the hook
    tokens (enc_out, block 6, block 9, dec-normed block 12), each f32."""
    f1 = linear(params["decoder_embed"], feat1.to(cfg.dtype))
    f2 = linear(params["decoder_embed"], feat2.to(cfg.dtype))
    rope1 = rope2d_tables(pos1, cfg.head_dim_dec, cfg.rope_base)
    rope2 = rope2d_tables(pos2, cfg.head_dim_dec, cfg.rope_base)
    ys1, ys2 = [], []
    for b1, b2 in zip(params["dec_blocks"], params["dec_blocks2"]):
        nf1 = decoder_block(b1, f1, f2, rope1, rope2, cfg.dec_num_heads)
        nf2 = decoder_block(b2, f2, f1, rope2, rope1, cfg.dec_num_heads)
        f1, f2 = nf1, nf2
        ys1.append(nf1)
        ys2.append(nf2)
    hooks1 = (feat1, ys1[5].float(), ys1[8].float(),
              layer_norm(params["dec_norm"], ys1[-1]).float())
    hooks2 = (feat2, ys2[5].float(), ys2[8].float(),
              layer_norm(params["dec_norm"], ys2[-1]).float())
    return hooks1, hooks2


# ---------------------------------------------------------------------------
# heads + postprocess
# ---------------------------------------------------------------------------

def _pixel_shuffle_tokens(tok, grid_hw, P: int, C: int):
    """(B, N, P*P*C) pixel-major tokens -> (B, H, W, C); the fc2 columns
    are stored (py, px, c), the JAX package's layout."""
    nh, nw = grid_hw
    B = tok.shape[0]
    x = tok.reshape(B, nh, nw, P, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, nh * P, nw * P, C)


def head_forward(head_params, cfg: ModelConfig, hook_tokens, grid_hw):
    """DPT + local-feature head -> raw (B, H, W, 4 + desc_dim + 1) f32 map."""
    hd = cfg.head_dtype
    hook_tokens = [t.to(hd) for t in hook_tokens]
    pts_conf = dpt_mod.dpt_forward(head_params["dpt"], hook_tokens, grid_hw, 4)
    enc_out, _, _, dec_out = hook_tokens
    local = mlp(head_params["local_mlp"], torch.cat([enc_out, dec_out], dim=-1))
    local_map = _pixel_shuffle_tokens(local, grid_hw, cfg.patch_size, cfg.desc_dim + 1)
    return torch.cat([pts_conf, local_map], dim=-1).float()


def _pointmap(xyz, conf_raw, cfg: ModelConfig):
    d = vnorm(xyz)
    X = xyz / torch.clamp_min(d, 1e-8) * torch.expm1(d)
    C = cfg.conf_offset + torch.exp(conf_raw)
    return X, C


def postprocess(raw, cfg: ModelConfig):
    """Raw head map -> (X (B,H,W,3), C (B,H,W), D (B,H,W,desc), Q (B,H,W))."""
    X, C = _pointmap(raw[..., 0:3], raw[..., 3], cfg)
    D = vnormalize(raw[..., 4:4 + cfg.desc_dim])
    Q = cfg.desc_conf_offset + torch.exp(raw[..., 4 + cfg.desc_dim])
    return X, C, D, Q


def inference_asymmetric(params, cfg: ModelConfig, feat_i, pos_i, feat_j, pos_j,
                         grid_hw):
    """-> ((Xii, Cii, Dii, Qii), (Xji, Cji, Dji, Qji)): j's geometry in i's frame."""
    hooks1, hooks2 = decode(params, cfg, feat_i, pos_i, feat_j, pos_j)
    raw1 = head_forward(params["head1"], cfg, hooks1, grid_hw)
    raw2 = head_forward(params["head2"], cfg, hooks2, grid_hw)
    return postprocess(raw1, cfg), postprocess(raw2, cfg)


def inference_symmetric(params, cfg: ModelConfig, feat_i, pos_i, feat_j, pos_j,
                        grid_hw):
    """Both directions of B pairs in ONE decoder call at batch 2B, stacked
    [i -> (i, j), j -> (j, i)].  Returns (res_ii, res_ji, res_jj, res_ij),
    each (X, C, D, Q) as ``inference_asymmetric`` gives them."""
    feat_a = torch.cat([feat_i, feat_j], dim=0)
    pos_a = torch.cat([pos_i, pos_j], dim=0)
    feat_b = torch.cat([feat_j, feat_i], dim=0)
    pos_b = torch.cat([pos_j, pos_i], dim=0)
    res_a, res_b = inference_asymmetric(params, cfg, feat_a, pos_a, feat_b, pos_b,
                                        grid_hw)
    B = feat_i.shape[0]
    res_ii = tuple(x[:B] for x in res_a)
    res_jj = tuple(x[B:] for x in res_a)
    res_ji = tuple(x[:B] for x in res_b)
    res_ij = tuple(x[B:] for x in res_b)
    return res_ii, res_ji, res_jj, res_ij


def inference_mono(params, cfg: ModelConfig, feat, pos, grid_hw):
    """(I, I) decode for the canonical pointmap; only X and C are used, so
    the descriptor head and the second view's heads are skipped."""
    hooks1, _ = decode(params, cfg, feat, pos, feat, pos)
    hd = cfg.head_dtype
    pts_conf = dpt_mod.dpt_forward(
        params["head1"]["dpt"], [t.to(hd) for t in hooks1], grid_hw, 4).float()
    return _pointmap(pts_conf[..., 0:3], pts_conf[..., 3], cfg)
