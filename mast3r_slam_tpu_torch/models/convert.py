"""Model parameters in and out of the port, with numpy and torch alone.

``params_from_jax`` turns the JAX parameter pytree (``init_params`` output,
or a converted checkpoint, as numpy arrays) into the port's layout;
``load_params`` reads the ``models/io.py`` npz (format v2) and does the
same, so a machine without JAX can load a converted checkpoint, and
``save_params`` writes the port's parameters to that npz, which the JAX
package's ``load_params`` reads back leaf for leaf.
``torch_state_dict_to_params`` and ``load_torch_checkpoint`` read the
released PyTorch checkpoints (``AsymmetricMASt3R`` state dicts, port of
``mast3r_slam_tpu/models/convert.py:142-309``): the same layout transforms
into the JAX tree, then ``params_from_jax``, so both loaders give the same
parameters.  ``retrieval_from_jax`` carries the retrieval head's parameters
and the codebook across (every leaf as it is: the head has no
convolutions).

Layouts:
  * stacked ``enc_blocks`` / ``dec_blocks`` / ``dec_blocks2`` (leading depth
    axis) -> lists of per-block dicts;
  * linear weights stay (in, out);
  * conv weights HWIO -> OIHW (every 4-D leaf);
  * conv-transpose weights stay (Cin, k*k*Cout);
  * ``local_mlp`` fc2 columns stay pixel-major (py, px, c), as
    ``mast3r._pixel_shuffle_tokens`` expects: they are NOT permuted.
bf16 leaves keep their dtype; everything else keeps its numpy dtype.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Any, Dict

import numpy as np
import torch

from .mast3r import VIT_LARGE, ModelConfig, cast_trunk_params

_SEP = "/"
_FORMAT_VERSION = 2
_VERSION_KEY = "__format_version__"
_BF16_TAG = "__bf16__"
_STACKED = ("enc_blocks", "dec_blocks", "dec_blocks2")


def _to_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.array(a)  # a writable, contiguous copy
        if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    if t.ndim == 4:  # conv weight HWIO -> OIHW
        t = t.permute(3, 2, 0, 1)
    return t.contiguous().to(device)


def _convert(node, device):
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device) for v in node]
    if node is None:
        return None
    return _to_tensor(node, device)


def _unstack(node, i):
    if isinstance(node, dict):
        return {k: _unstack(v, i) for k, v in node.items()}
    return node[i]


def _depth(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.shape[0]


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX parameter pytree (nested dicts of numpy arrays) -> port params."""
    device = torch.device(device)
    out = {}
    for k, v in tree.items():
        if k in _STACKED:
            out[k] = [_convert(_unstack(v, i), device) for i in range(_depth(v))]
        else:
            out[k] = _convert(v, device)
    return out


def retrieval_from_jax(head_params: Dict[str, Any], centroids, device="cpu"):
    """The JAX retrieval head's parameter dict (``init_head_params`` or
    ``convert_torch_retrieval_head`` output, as numpy arrays) and its codebook
    -> (port head params, centroids tensor), for ``RetrievalDatabase``."""
    device = torch.device(device)
    return _convert(head_params, device), _to_tensor(centroids, device)


def load_params(path, device="cpu") -> Dict[str, Any]:
    """Read a ``models/io.py`` npz (format v2) into port params."""
    tree: dict = {}
    with np.load(path) as data:
        version = int(data[_VERSION_KEY]) if _VERSION_KEY in data.files else 1
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"{path}: converted-checkpoint format v{version}, the port "
                f"reads v{_FORMAT_VERSION}")
        for key in data.files:
            if key == _VERSION_KEY:
                continue
            parts = key.split(_SEP)
            value = data[key]
            if parts[-1] == _BF16_TAG:  # uint16 bit view of a bf16 leaf
                parts = parts[:-1]
                value = torch.from_numpy(value.view(np.int16)).view(torch.bfloat16)
            if parts[-1] == "__none__":
                raise ValueError(f"{path}: unexpected None leaf {key}")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
    return params_from_jax(tree, device)


def _stack_blocks(blocks):
    """A list of per-block dicts -> one dict of leaves stacked on depth."""
    if isinstance(blocks[0], dict):
        return {k: _stack_blocks([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack([b.detach().cpu() for b in blocks])


def save_params(path, params: Dict[str, Any]) -> None:
    """Write port params as the ``models/io.py`` npz (format v2): blocks
    stacked on depth, conv weights HWIO, bf16 leaves as tagged uint16 bit
    views."""
    flat = {_VERSION_KEY: np.asarray(_FORMAT_VERSION)}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}{_SEP}{k}" if prefix else k, v)
            return
        t = node.detach().cpu()
        if t.ndim == 4:  # conv weight OIHW -> HWIO
            t = t.permute(2, 3, 1, 0)
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            flat[f"{prefix}{_SEP}{_BF16_TAG}"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[prefix] = t.numpy()

    rec("", {k: (_stack_blocks(v) if k in _STACKED else v) for k, v in params.items()})
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


# ---------------------------------------------------------------------------
# released PyTorch checkpoints
# ---------------------------------------------------------------------------

def _t(sd, k):
    return np.asarray(sd[k], dtype=np.float32)


def _linear(sd, prefix, bias=True):
    p = {"w": _t(sd, prefix + ".weight").T}
    if bias:
        p["b"] = _t(sd, prefix + ".bias")
    return p


def _conv(sd, prefix, bias=True):
    p = {"w": _t(sd, prefix + ".weight").transpose(2, 3, 1, 0)}  # OIHW -> HWIO
    if bias:
        p["b"] = _t(sd, prefix + ".bias")
    return p


def _conv_t(sd, prefix):
    w = _t(sd, prefix + ".weight")  # (I, O, k, k) -> (I, k*k*O)
    cin, cout, k, _ = w.shape
    return {"w": w.transpose(0, 2, 3, 1).reshape(cin, k * k * cout),
            "b": _t(sd, prefix + ".bias")}


def _norm(sd, prefix):
    return {"w": _t(sd, prefix + ".weight"), "b": _t(sd, prefix + ".bias")}


def _enc_block(sd, prefix):
    return {
        "norm1": _norm(sd, prefix + ".norm1"),
        "attn": {"qkv": _linear(sd, prefix + ".attn.qkv"),
                 "proj": _linear(sd, prefix + ".attn.proj")},
        "norm2": _norm(sd, prefix + ".norm2"),
        "mlp": {"fc1": _linear(sd, prefix + ".mlp.fc1"),
                "fc2": _linear(sd, prefix + ".mlp.fc2")},
    }


def _dec_block(sd, prefix):
    return {
        "norm1": _norm(sd, prefix + ".norm1"),
        "attn": {"qkv": _linear(sd, prefix + ".attn.qkv"),
                 "proj": _linear(sd, prefix + ".attn.proj")},
        "norm2": _norm(sd, prefix + ".norm2"),
        "norm3": _norm(sd, prefix + ".norm3"),
        "norm_y": _norm(sd, prefix + ".norm_y"),
        "cross_attn": {"q": _linear(sd, prefix + ".cross_attn.projq"),
                       "k": _linear(sd, prefix + ".cross_attn.projk"),
                       "v": _linear(sd, prefix + ".cross_attn.projv"),
                       "proj": _linear(sd, prefix + ".cross_attn.proj")},
        "mlp": {"fc1": _linear(sd, prefix + ".mlp.fc1"),
                "fc2": _linear(sd, prefix + ".mlp.fc2")},
    }


def _stack(blocks):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def _dpt(sd, prefix):
    sc = prefix + ".dpt.scratch"
    ap = prefix + ".dpt.act_postprocess"

    def fusion(i):
        rp = f"{sc}.refinenet{i}"
        return {
            "res1": {"conv1": _conv(sd, rp + ".resConfUnit1.conv1"),
                     "conv2": _conv(sd, rp + ".resConfUnit1.conv2")},
            "res2": {"conv1": _conv(sd, rp + ".resConfUnit2.conv1"),
                     "conv2": _conv(sd, rp + ".resConfUnit2.conv2")},
            "out_conv": _conv(sd, rp + ".out_conv"),
        }

    return {
        "act1": {"conv": _conv(sd, ap + ".0.0"), "convt": _conv_t(sd, ap + ".0.1")},
        "act2": {"conv": _conv(sd, ap + ".1.0"), "convt": _conv_t(sd, ap + ".1.1")},
        "act3": {"conv": _conv(sd, ap + ".2.0")},
        "act4": {"conv": _conv(sd, ap + ".3.0"), "conv2": _conv(sd, ap + ".3.1")},
        "rn1": _conv(sd, sc + ".layer1_rn", bias=False),
        "rn2": _conv(sd, sc + ".layer2_rn", bias=False),
        "rn3": _conv(sd, sc + ".layer3_rn", bias=False),
        "rn4": _conv(sd, sc + ".layer4_rn", bias=False),
        "refine1": fusion(1),
        "refine2": fusion(2),
        "refine3": fusion(3),
        "refine4": fusion(4),
        "head": {"conv1": _conv(sd, prefix + ".dpt.head.0"),
                 "conv2": _conv(sd, prefix + ".dpt.head.2"),
                 "conv3": _conv(sd, prefix + ".dpt.head.4")},
    }


def torch_state_dict_to_params(sd: Dict[str, Any], cfg: ModelConfig = VIT_LARGE,
                               device="cpu") -> Dict[str, Any]:
    """An ``AsymmetricMASt3R`` state dict (tensors or numpy arrays) -> port
    params on ``device``, the trunk's matmul weights in ``cfg.dtype``.

    A checkpoint without ``dec_blocks2`` reuses ``dec_blocks`` for the
    second decoder.  The local-feature MLP's fc2 output columns go from
    torch's pixel-shuffle order (c, py, px) to the pixel-major (py, px, c)
    that ``models/mast3r._pixel_shuffle_tokens`` reads (a column
    permutation of an output layer: exact)."""
    sd = {k: (v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)) for k, v in sd.items()}
    if not any(k.startswith("dec_blocks2") for k in sd):
        for k in list(sd):
            if k.startswith("dec_blocks."):
                sd[k.replace("dec_blocks.", "dec_blocks2.", 1)] = sd[k]

    pw = _t(sd, "patch_embed.proj.weight")  # (D, 3, P, P) -> (P*P*3, D)
    D = pw.shape[0]
    P = cfg.patch_size

    def head(i):
        hp = f"downstream_head{i}"
        fc2 = _linear(sd, hp + ".head_local_features.fc2")
        if fc2["w"].shape[1] % (P * P) != 0:
            raise ValueError(
                f"{hp}.head_local_features.fc2 out_features {fc2['w'].shape[1]} is not "
                f"a multiple of patch_size^2 ({P * P}); checkpoint and config disagree")
        C = fc2["w"].shape[1] // (P * P)
        perm = (np.arange(C)[None, :] * P * P + np.arange(P * P)[:, None]).reshape(-1)
        return {"dpt": _dpt(sd, hp),
                "local_mlp": {"fc1": _linear(sd, hp + ".head_local_features.fc1"),
                              "fc2": {"w": fc2["w"][:, perm], "b": fc2["b"][perm]}}}

    tree = {
        "patch_embed": {"w": pw.transpose(2, 3, 1, 0).reshape(-1, D),
                        "b": _t(sd, "patch_embed.proj.bias")},
        "enc_blocks": _stack([_enc_block(sd, f"enc_blocks.{i}")
                              for i in range(cfg.enc_depth)]),
        "enc_norm": _norm(sd, "enc_norm"),
        "decoder_embed": _linear(sd, "decoder_embed"),
        "dec_blocks": _stack([_dec_block(sd, f"dec_blocks.{i}")
                              for i in range(cfg.dec_depth)]),
        "dec_blocks2": _stack([_dec_block(sd, f"dec_blocks2.{i}")
                               for i in range(cfg.dec_depth)]),
        "dec_norm": _norm(sd, "dec_norm"),
        "head1": head(1),
        "head2": head(2),
    }
    return cast_trunk_params(params_from_jax(tree, device), cfg)


def parse_arch_string(arch: str) -> Dict[str, Any]:
    """PARSE (never eval) the checkpoint's model-constructor string, e.g.
    "AsymmetricMASt3R(pos_embed='RoPE100', ..., conf_mode=('exp', 1, inf))",
    into {class_name, kwargs}: an AST call whose arguments are constants,
    tuples or lists of them, negation, and the name ``inf``.  Anything else
    raises ``ValueError``."""
    node = ast.parse(arch.strip(), mode="eval").body
    if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Name):
        raise ValueError(f"arch string is not a plain constructor call: {arch!r}")

    def const(n):
        if isinstance(n, ast.Constant):
            return n.value
        if isinstance(n, ast.Name) and n.id == "inf":
            return float("inf")
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -const(n.operand)
        if isinstance(n, (ast.Tuple, ast.List)):
            return tuple(const(e) for e in n.elts)
        raise ValueError(f"non-literal node {ast.dump(n)} in arch string; refusing")

    if node.args:
        raise ValueError(f"arch string has positional arguments: {arch!r}")
    return {"class_name": node.func.id,
            "kwargs": {kw.arg: const(kw.value) for kw in node.keywords}}


def config_from_arch(arch: str, base: ModelConfig = VIT_LARGE) -> ModelConfig:
    """``base`` with the structural fields of a checkpoint's arch string:
    trunk widths, depths and heads, patch size, the RoPE base, the
    descriptor width ('pts3d+desc24' -> 24) and the confidence offsets.
    Other keyword arguments are ignored; compute dtypes stay ``base``'s."""
    kw = parse_arch_string(arch)["kwargs"]
    upd = {k: int(kw[k]) for k in ("enc_embed_dim", "enc_depth", "enc_num_heads",
                                   "dec_embed_dim", "dec_depth", "dec_num_heads",
                                   "patch_size") if k in kw}
    if "pos_embed" in kw:
        m = re.fullmatch(r"RoPE(\d+(?:\.\d+)?)", str(kw["pos_embed"]))
        if not m:
            raise ValueError(f"unsupported pos_embed {kw['pos_embed']!r}")
        upd["rope_base"] = float(m.group(1))
    if "output_mode" in kw:
        m = re.fullmatch(r"pts3d\+desc(\d+)", str(kw["output_mode"]))
        if not m:
            raise ValueError(f"unsupported output_mode {kw['output_mode']!r}")
        upd["desc_dim"] = int(m.group(1))
    for mode_key, field in (("conf_mode", "conf_offset"),
                            ("desc_conf_mode", "desc_conf_offset")):
        if kw.get(mode_key) is not None:
            mode = kw[mode_key]
            if mode[0] != "exp":
                raise ValueError(f"unsupported {mode_key} {mode!r}")
            upd[field] = float(mode[1])
    return dataclasses.replace(base, **upd)


def load_torch_checkpoint(path, cfg: ModelConfig = None, device="cpu"):
    """A released ``.pth`` (``{"model": state_dict, "args": ...}``) ->
    (params, cfg).  The checkpoint unpickles (its ``args`` is a Namespace),
    so load only files you trust; its arch string is parsed, never
    evaluated, into the structural config over ``cfg`` (VIT_LARGE)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    base = cfg if cfg is not None else VIT_LARGE
    args = ckpt.get("args") if isinstance(ckpt, dict) else None
    arch = None
    if args is not None:
        arch = args.get("model") if isinstance(args, dict) else getattr(args, "model", None)
    cfg = config_from_arch(arch, base=base) if arch else base
    return torch_state_dict_to_params(sd, cfg, device), cfg
