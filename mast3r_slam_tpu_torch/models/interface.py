"""The model protocol the tracker consumes (port of ``models/interface.py``).

``MASt3RModel`` holds parameters, config and image size and exposes
``encode`` / ``asymmetric`` / ``symmetric`` / ``mono``; a synthetic oracle
with the same methods can stand in for it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import DeviceLike, resolve_device
from . import mast3r as M
from .convert import load_params, load_torch_checkpoint


def _move(node, device):
    if isinstance(node, dict):
        return {k: _move(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_move(v, device) for v in node]
    return node.to(device)


class MASt3RModel:
    """Parameters + config + image size; runs on the card unless told otherwise."""

    def __init__(self, params, mcfg: M.ModelConfig, img_hw: Tuple[int, int],
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = _move(params, self.device)
        self.mcfg = mcfg
        self.img_hw = tuple(img_hw)
        self.grid = mcfg.grid(img_hw)

    def replica(self, device: DeviceLike) -> "MASt3RModel":
        """The same model with its parameters copied to ``device`` (a mesh
        shard's decode on another card)."""
        return MASt3RModel(self.params, self.mcfg, self.img_hw, device)

    @classmethod
    def random_init(cls, seed: int, img_hw, mcfg: M.ModelConfig = M.VIT_LARGE,
                    device: DeviceLike = None):
        device = resolve_device(device)
        return cls(M.init_params(mcfg, seed, device), mcfg, img_hw, device)

    @classmethod
    def from_npz(cls, path, img_hw, mcfg: M.ModelConfig = M.VIT_LARGE,
                 device: DeviceLike = None):
        """A converted checkpoint (``models/io.py`` npz, format v2)."""
        device = resolve_device(device)
        return cls(load_params(path, device), mcfg, img_hw, device)

    @classmethod
    def from_torch_checkpoint(cls, path, img_hw, mcfg: M.ModelConfig = M.VIT_LARGE,
                              device: DeviceLike = None):
        """A released PyTorch checkpoint (``.pth``); its arch string sets the
        structural config over ``mcfg``."""
        device = resolve_device(device)
        params, mcfg = load_torch_checkpoint(path, mcfg, device)
        return cls(params, mcfg, img_hw, device)

    @torch.no_grad()
    def encode(self, img):
        """img (B, 3, H, W) in [-1, 1] -> (feat (B, N, D), pos (B, N, 2))."""
        return M.encode_image(self.params, self.mcfg, img.to(self.device))

    @torch.no_grad()
    def asymmetric(self, feat_i, pos_i, feat_j, pos_j):
        """-> ((Xii, Cii, Dii, Qii), (Xji, Cji, Dji, Qji)), maps (B, H, W, *)."""
        return M.inference_asymmetric(
            self.params, self.mcfg, feat_i, pos_i, feat_j, pos_j, self.grid)

    @torch.no_grad()
    def symmetric(self, feat_i, pos_i, feat_j, pos_j):
        """-> (res_ii, res_ji, res_jj, res_ij), each (X, C, D, Q): one
        decoder call at batch 2B."""
        return M.inference_symmetric(
            self.params, self.mcfg, feat_i, pos_i, feat_j, pos_j, self.grid)

    @torch.no_grad()
    def mono(self, feat, pos):
        """-> (X (B, H, W, 3), C (B, H, W)) canonical pointmap."""
        return M.inference_mono(self.params, self.mcfg, feat, pos, self.grid)

    @property
    def feat_dim(self):
        return self.mcfg.enc_embed_dim

    @property
    def num_patches(self):
        return self.grid[0] * self.grid[1]
