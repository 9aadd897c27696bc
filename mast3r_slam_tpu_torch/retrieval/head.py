"""Retrieval feature head: whiten, project, top-k select (port of
``mast3r_slam_tpu/retrieval/head.py``).

Backbone encoder tokens are pre-whitened (centre + PCA), projected by an MLP
(Linear [+ affine LayerNorm + GELU]* Linear), weighted by the L2 norm of the
projected feature, post-whitened, and the ``nfeat`` tokens of largest
weight are kept.  All products run in full f32 (TF32 off).

Parameters are a dict of tensors: ``prewhiten`` / ``postwhiten``
``{"m": (D,), "p": (D, D)}`` or None, and ``projector``, a list of
``{"w": (in, out), "b": (out,), "ln": {"w", "b"} or None}``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.numerics import full_f32, vnorm


class RetrievalHeadSettings(NamedTuple):
    nfeat: int = 300
    residual: bool = False


def init_head_params(generator: torch.Generator, backbone_dim: int, hdims=(1024,),
                     device=None) -> dict:
    """Random projector and identity whiteners, drawn from ``generator`` on
    its own device and moved to ``device`` (the generator's by default)."""
    gdev = generator.device
    device = torch.device(device) if device is not None else gdev
    layers = []
    d = backbone_dim
    for i, h in enumerate(hdims):
        w = torch.randn((d, h), generator=generator, device=gdev) * (1.0 / np.sqrt(d))
        ln = ({"w": torch.ones(h, device=device), "b": torch.zeros(h, device=device)}
              if i < len(hdims) - 1 else None)
        layers.append({"w": w.to(device), "b": torch.zeros(h, device=device), "ln": ln})
        d = h
    dim = hdims[-1] if hdims else backbone_dim

    def identity(n):
        return {"m": torch.zeros(n, device=device), "p": torch.eye(n, device=device)}

    return {"prewhiten": identity(backbone_dim), "projector": layers,
            "postwhiten": identity(dim)}


def _whiten(p: Optional[dict], x):
    if p is None or p.get("p") is None:
        return x
    with full_f32():
        return (x - p["m"]) @ p["p"]


def _project(layers, x):
    """Linear [+ affine LayerNorm (biased variance, eps 1e-5) + exact GELU]."""
    for lay in layers:
        with full_f32():
            x = x @ lay["w"] + lay["b"]
        if lay.get("ln") is not None:
            mu = torch.mean(x, dim=-1, keepdim=True)
            var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
            x = (x - mu) * torch.rsqrt(var + 1e-5)
            x = x * lay["ln"]["w"] + lay["ln"]["b"]
            x = F.gelu(x, approximate="none")
    return x


@torch.no_grad()
def extract_topk_features(params: dict, feat, settings: RetrievalHeadSettings):
    """feat: (B, N, D) backbone tokens -> (B, nfeat, dim) selected features,
    in descending order of weight."""
    x = _whiten(params["prewhiten"], feat.float())
    proj = _project(params["projector"], x)
    if settings.residual:
        proj = proj + x
    attn = vnorm(proj, keepdim=False)  # featweights='l2norm'
    whitened = _whiten(params["postwhiten"], proj)
    k = min(settings.nfeat, whitened.shape[1])
    top = torch.topk(attn, k, dim=1).indices  # (B, k), largest first
    return whitened[torch.arange(whitened.shape[0], device=top.device)[:, None], top]


def params_from_state_dict(sd, device="cpu") -> dict:
    """A torch retrieval checkpoint's state dict -> head params (the
    counterpart of ``convert_torch_retrieval_head``).

    A whitener stores ``m`` (1, D) and a column matrix ``p`` applied as
    x @ p, kept as it is; Linear weights (out, in) transpose.  The projector
    is a Sequential [Linear, LayerNorm, GELU]* + Linear: each 1-D weight is
    the LayerNorm after the Linear before it."""
    def arr(k):
        v = sd[k]
        v = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return v.to(device=device, dtype=torch.float32)

    proj_idx = sorted(int(k.split(".")[1]) for k in sd
                      if k.startswith("projector.") and k.endswith(".weight"))
    layers = []
    pending = None
    for i in proj_idx:
        w = arr(f"projector.{i}.weight")
        if w.ndim == 2:
            if pending is not None:
                layers.append(pending)
            pending = {"w": w.T.contiguous(), "b": arr(f"projector.{i}.bias"), "ln": None}
        else:
            pending["ln"] = {"w": w, "b": arr(f"projector.{i}.bias")}
    if pending is not None:
        layers.append(pending)

    def whiten(prefix):
        if f"{prefix}.m" not in sd:
            return None
        return {"m": arr(f"{prefix}.m").reshape(-1), "p": arr(f"{prefix}.p")}

    return {"prewhiten": whiten("prewhiten"), "projector": layers,
            "postwhiten": whiten("postwhiten")}
