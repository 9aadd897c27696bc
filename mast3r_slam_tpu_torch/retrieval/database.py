"""Incremental loop-closure retrieval database (port of
``mast3r_slam_tpu/retrieval/database.py``).

Per keyframe: top-k head features from the backbone tokens, a query of the
ASMK inverted file for loop-closure candidates, then (optionally) the
keyframe's own codes added.  Everything up to the candidate list runs on
the device; ``update`` reads the host once (scores, word ids and validity in
one transfer), as the JAX flow does.
"""

from __future__ import annotations

import pickle
from typing import List, Optional, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_host
from .asmk import ASMKSettings, DeviceIVF, aggregate_residuals, binarize_pack, quantize
from .head import (RetrievalHeadSettings, extract_topk_features, init_head_params,
                   params_from_state_dict)


def _top_candidates(scores_np: np.ndarray, k: int, min_thresh: float) -> List[int]:
    top = np.argsort(-scores_np)[: min(k, len(scores_np))]
    return [int(i) for i in top if scores_np[i] > min_thresh]


class RetrievalDatabase:
    """Head parameters, a codebook and the inverted file, on one device."""

    def __init__(self, head_params: dict, centroids,
                 head_settings: RetrievalHeadSettings = RetrievalHeadSettings(),
                 asmk_settings: Optional[ASMKSettings] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.head_params = _to_device(head_params, self.device)
        self.centroids = torch.as_tensor(centroids, dtype=torch.float32).to(self.device)
        self.hs = head_settings
        dim = int(self.centroids.shape[1])
        self.s = asmk_settings or ASMKSettings()
        self.ivf = DeviceIVF(dim, self.s, num_words=int(self.centroids.shape[0]),
                             device=self.device)
        self.kf_counter = 0

    @classmethod
    def random_init(cls, generator: Union[int, torch.Generator], backbone_dim: int,
                    proj_dim: int = 64, num_centroids: int = 1024, nfeat: int = 64,
                    device: DeviceLike = None):
        """Random projector and codebook (tests, runs without a checkpoint),
        drawn from ``generator`` (or a CPU generator seeded with it)."""
        device = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator))
        params = init_head_params(generator, backbone_dim, hdims=(proj_dim,), device=device)
        centroids = torch.randn((num_centroids, proj_dim), generator=generator,
                                device=generator.device) * 0.05
        return cls(params, centroids, RetrievalHeadSettings(nfeat=nfeat), device=device)

    @classmethod
    def from_torch_checkpoint(cls, model_path: str, codebook_path: str, nfeat: int = 300,
                              device: DeviceLike = None):
        """The reference retrieval checkpoint and its codebook pickle, both
        read from local paths the caller trusts (both formats unpickle)."""
        ckpt = torch.load(model_path, map_location="cpu", weights_only=False)
        params = params_from_state_dict(ckpt["model"])
        with open(codebook_path, "rb") as f:
            cdb = pickle.load(f)
        centroids = np.asarray(
            cdb["state"]["centroids"] if isinstance(cdb, dict) else cdb.centroids,
            dtype=np.float32)
        args = ckpt.get("args")
        if args is not None and hasattr(args, "nfeat"):
            nfeat = int(args.nfeat)
        return cls(params, centroids, RetrievalHeadSettings(nfeat=nfeat), device=device)

    # ------------------------------------------------------------------

    def _extract_quantize(self, feat):
        feats = extract_topk_features(self.head_params, feat.to(self.device), self.hs)[0]
        return feats, quantize(feats, self.centroids, self.s.ma_query)

    def _codes(self, feats, codes, ma: int):
        """(packed (m*ma, W), words, valid) of the features' first ma words."""
        agg, words, valid = aggregate_residuals(feats, codes[:, :ma], self.centroids,
                                                feats.shape[0] * ma)
        return binarize_pack(agg), words, valid

    def _search(self, feats, codes):
        packed, words, valid = self._codes(feats, codes, self.s.ma_query)
        return self.ivf.search(packed, words, valid)

    @torch.no_grad()
    def query(self, frame, k: int, min_thresh: float = 0.0, with_scores: bool = False):
        """Loop-closure candidates of ``frame`` (its ``feat`` (1, N, D)).

        Returns (inds, precomputed): ``precomputed`` is the (features, codes)
        pair that :meth:`add` takes to store the same frame without
        extracting again (the reloc path queries first and adds only on
        success).  ``with_scores`` adds the per-image score vector."""
        feats, codes = self._extract_quantize(frame.feat)
        inds: List[int] = []
        scores_np = np.zeros((0,), np.float32)
        if self.kf_counter > 0:
            scores = self._search(feats, codes)
            (scores_np,) = to_host(scores[: self.ivf.n_images])
            inds = _top_candidates(scores_np, k, min_thresh)
        if with_scores:
            return inds, (feats, codes), scores_np
        return inds, (feats, codes)

    @torch.no_grad()
    def update(self, frame, add_after_query: bool, k: int, min_thresh: float = 0.0,
               kf_index: Optional[int] = None) -> List[int]:
        """Query (when the database holds an image), then optionally add the
        frame under ``kf_index`` (a running counter by default).  Returns
        the ids of the top-k images scoring above ``min_thresh``."""
        if not add_after_query:
            return self.query(frame, k, min_thresh)[0]
        imid = self.kf_counter if kf_index is None else kf_index
        if self.kf_counter == 0:
            self.add(frame, kf_index=kf_index)
            return []
        feats, codes = self._extract_quantize(frame.feat)
        scores = self._search(feats, codes)
        packed, words, valid = self._codes(feats, codes, self.s.ma_build)
        # one host read: scores for the candidates, word ids and validity
        # for the insert positions
        n_img, m = self.ivf.n_images, words.shape[0]
        (host,) = to_host(torch.cat([scores[:n_img].double(), words.double(),
                                     valid.double()]))
        scores_np = host[:n_img].astype(np.float32)
        self.ivf.add(packed, host[n_img:n_img + m].astype(np.int64),
                     host[n_img + m:] > 0, imid=imid)
        self.kf_counter += 1
        return _top_candidates(scores_np, k, min_thresh)

    @torch.no_grad()
    def add(self, frame, precomputed=None, kf_index: Optional[int] = None):
        """Aggregate with ma_build assignments and append to the IVF."""
        feats, codes = (precomputed if precomputed is not None
                        else self._extract_quantize(frame.feat))
        packed, words, valid = self._codes(feats, codes, self.s.ma_build)
        self.ivf.add(packed, words, valid,
                     imid=self.kf_counter if kf_index is None else kf_index)
        self.kf_counter += 1


def _to_device(node, device):
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_device(v, device) for v in node]
    if node is None:
        return None
    return torch.as_tensor(node, dtype=torch.float32).to(device)
