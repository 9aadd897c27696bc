"""Carry the JAX package's parameters into the port, with numpy alone.

``params_from_jax`` turns the JAX parameter pytree (``init_params`` output,
or a converted checkpoint, as numpy arrays) into the port's layout;
``load_params`` reads the ``models/io.py`` npz (format v2) and does the
same, so a machine without JAX can load a converted checkpoint.
``retrieval_from_jax`` carries the retrieval head's parameters and the
codebook across (every leaf as it is: the head has no convolutions).

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

from typing import Any, Dict

import numpy as np
import torch

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
