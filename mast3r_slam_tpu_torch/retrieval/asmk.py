"""ASMK retrieval: quantisation, binarised aggregation, inverted-file scoring
(port of ``mast3r_slam_tpu/retrieval/asmk.py``).

* Codebook quantisation is the cdist trick, a matrix product and a top-k,
  in full f32 (TF32 off).
* Residuals aggregate per assigned word into the first-occurrence slot of
  the word (``_unique_static``: a stable argsort and a compaction), as a
  one-hot (slots x assignments) product: a fixed summation order, so the
  packed codes are the same bits on every call (a scatter-add on the card
  adds in atomic order, which can flip the sign of a sum near 0).
* Signs pack 32 to a word into int32 tensors holding the bits of the JAX
  package's uint32 codes.
* ``DeviceIVF`` keeps one bucket of ``bucket_cap`` entries per word plus a
  trash bucket; a query gathers each word's bucket and scores it with the
  ``ops.gather.ivf_hamming`` kernel, then powers, normalises and sums the
  similarities into per-image scores in plain torch, each image's in a
  fixed order (``utils.numerics.index_add_fixed``), so a query gives the
  same score bits on every call.

Defaults follow the reference processor: binary kernel, no idf,
multiple-assignment 1 on build and 5 on query, alpha 3, threshold 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import gather
from ..utils.numerics import full_f32, index_add_fixed


class ASMKSettings(NamedTuple):
    ma_build: int = 1
    ma_query: int = 5
    alpha: float = 3.0
    similarity_threshold: float = 0.0
    max_images: int = 512


# ---------------------------------------------------------------------------
# quantisation and aggregation
# ---------------------------------------------------------------------------

def quantize(vecs, centroids, k: int):
    """Top-k nearest centroids by L2 (cdist trick): vecs (n, d) -> (n, k)
    int64, nearest first."""
    with full_f32():
        d2 = ((torch.sum(vecs * vecs, dim=1)[:, None]
               + torch.sum(centroids * centroids, dim=1)[None, :])
              - (2.0 * vecs) @ centroids.T)
    return torch.topk(-d2, k, dim=1).indices


def binarize_pack(vecs):
    """Sign bits packed along the last dim: (n, d) float -> (n, ceil(d/32))
    int32; bit b of word w is (vec[w*32 + b] > 0)."""
    n, d = vecs.shape
    bits = (vecs > 0).to(torch.int64)
    pad = (-d) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    shifts = torch.arange(32, dtype=torch.int64, device=vecs.device)
    words = torch.sum(bits.reshape(n, -1, 32) << shifts, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def hamming_sim(qvec, vecs, dim: int):
    """Normalised Hamming similarity in [-1, 1]: qvec (w,), vecs (m, w)
    int32 codes; 1 - 2 * popcount(xor) / dim."""
    dist = gather.popcount32(qvec[None, :] ^ vecs).sum(dim=-1).to(torch.float32)
    return 1.0 - 2.0 * dist / dim


def _unique_static(x, cap: int):
    """Static-shape unique of a 1-D tensor: (uniq (cap,), padded with -1, in
    ascending order; inverse (len(x),) int64, each element's slot in uniq)."""
    order = torch.argsort(x, stable=True)
    sx = x[order]
    first = torch.ones_like(sx, dtype=torch.bool)
    first[1:] = sx[1:] != sx[:-1]
    slot = torch.cumsum(first.to(torch.int64), dim=0) - 1
    inv = torch.empty_like(slot)
    inv[order] = slot
    uniq = torch.full((cap,), -1, dtype=x.dtype, device=x.device)
    uniq[slot] = sx  # duplicate slots write the same value
    return uniq, inv


def aggregate_residuals(vecs, word_ids, centroids, num_words_cap: int):
    """Sum each vec's residual to each of its assigned words.

    vecs (n, d); word_ids (n, ma) distinct per row.  Returns (agg
    (num_words_cap, d), words (num_words_cap,) with -1 padding, valid mask):
    slot s holds the sum for the s-th smallest assigned word."""
    n, ma = word_ids.shape
    d = vecs.shape[1]
    res = (vecs[:, None, :] - centroids[word_ids]).reshape(n * ma, d)
    uniq, inv = _unique_static(word_ids.reshape(-1), num_words_cap)
    slots = torch.arange(num_words_cap, device=vecs.device)
    onehot = (slots[:, None] == inv[None, :]).to(vecs.dtype)
    with full_f32():
        agg = onehot @ res
    return agg, uniq, uniq >= 0


# ---------------------------------------------------------------------------
# device-resident inverted file (word-bucketed)
# ---------------------------------------------------------------------------

class DeviceIVF:
    """Word-bucketed inverted file on the device.

    ``bvecs`` (num_words + 1, bucket_cap, W) int32 codes and ``bimids``
    (num_words + 1, bucket_cap) int32 image ids (-1 empty); the last bucket
    takes invalid rows and never matches.  Insert positions come from a host
    mirror of the per-word fill counts.  Bucket depth and the image table
    double on demand; the search kernel takes any depth, so growth rebuilds
    nothing."""

    def __init__(self, dim: int, settings: ASMKSettings, num_words: int = 1024,
                 bucket_cap: int = 16, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dim = dim
        self.words = dim // 32 + (1 if dim % 32 else 0)
        self.s = settings
        self.num_words = num_words
        self.bucket_cap = bucket_cap
        dev = self.device
        self.bvecs = torch.zeros((num_words + 1, bucket_cap, self.words),
                                 dtype=torch.int32, device=dev)
        self.bimids = torch.full((num_words + 1, bucket_cap), -1, dtype=torch.int32,
                                 device=dev)
        self.fill = np.zeros((num_words + 1,), dtype=np.int64)
        self.norm_factor = torch.zeros((settings.max_images,), dtype=torch.float32,
                                       device=dev)
        self.n_entries = 0
        self.n_images = 0

    def add(self, agg_packed, words, valid, imid=None):
        """Append one image's aggregated codes under image id ``imid`` (the
        caller's id: the SLAM layer passes the keyframe index).

        agg_packed (m, W) int32 on the device; words (m,) and valid (m,) as
        host numpy arrays or tensors."""
        if imid is None:
            imid = self.n_images
        words_np = _host(words).astype(np.int64)
        valid_np = _host(valid).astype(bool)
        w = np.where(valid_np, words_np, self.num_words)
        # per-word insert positions: current fill + rank within this batch
        order = np.argsort(w, kind="stable")
        sw = w[order]
        run_first = np.searchsorted(sw, sw, side="left")
        rank = np.empty_like(run_first)
        rank[order] = np.arange(len(w)) - run_first
        pos = self.fill[w] + rank
        pos[w == self.num_words] = 0  # trash rows overwrite slot 0
        need = int(pos[valid_np].max()) + 1 if valid_np.any() else 0
        self._ensure_capacity(need, imid)
        dev = self.device
        w_t = torch.as_tensor(w, device=dev)
        pos_t = torch.as_tensor(pos, device=dev)
        imids = torch.as_tensor(np.where(valid_np, imid, -1).astype(np.int32), device=dev)
        self.bvecs[w_t, pos_t] = agg_packed.to(self.bvecs)
        self.bimids[w_t, pos_t] = imids
        self.norm_factor[imid] = float(valid_np.sum())
        self.fill += np.bincount(w[valid_np], minlength=self.num_words + 1)
        self.n_entries += int(valid_np.sum())
        self.n_images = max(self.n_images, imid + 1)

    def _ensure_capacity(self, need_depth: int, imid=None):
        """Double the bucket depth and the image table until they fit,
        copying into new tensors."""
        s = self.s
        bc = self.bucket_cap
        while bc < need_depth:
            bc *= 2
        if bc != self.bucket_cap:
            pad = bc - self.bucket_cap
            self.bvecs = torch.cat([self.bvecs, self.bvecs.new_zeros(
                (self.num_words + 1, pad, self.words))], dim=1)
            self.bimids = torch.cat([self.bimids, self.bimids.new_full(
                (self.num_words + 1, pad), -1)], dim=1)
            self.bucket_cap = bc
        need_img = (imid + 1) if imid is not None else (self.n_images + 1)
        mi = s.max_images
        while mi < need_img:
            mi *= 2
        if mi != s.max_images:
            self.norm_factor = torch.cat([self.norm_factor,
                                          self.norm_factor.new_zeros(mi - s.max_images)])
            self.s = s._replace(max_images=mi)

    def search(self, agg_packed, q_words, q_valid):
        """Scores (max_images,) of every image against one query; entries
        beyond n_images are 0."""
        return ivf_search_bucketed(self.bvecs, self.bimids, self.norm_factor, agg_packed,
                                   q_words, q_valid, self.dim, self.s.alpha,
                                   self.s.similarity_threshold, self.s.max_images)

    def entries(self):
        """Flat (codes (E, W) int32, word ids (E,), image ids (E,)) numpy rows
        in bucket order: the checkpoint view."""
        vecs_np = self.bvecs[: self.num_words].cpu().numpy()
        imids_np = self.bimids[: self.num_words].cpu().numpy()
        wsel, dsel = np.nonzero(imids_np >= 0)
        return vecs_np[wsel, dsel], wsel.astype(np.int32), imids_np[wsel, dsel]

    def load_entries(self, vecs, word_ids, image_ids, norm_factor, n_images):
        """Rebuild the buckets from flat entry rows (checkpoint restore)."""
        vecs, word_ids, image_ids = (np.asarray(a) for a in (vecs, word_ids, image_ids))
        ok = word_ids >= 0
        vecs, word_ids, image_ids = vecs[ok], word_ids[ok], image_ids[ok]
        self.n_entries = 0
        self.n_images = 0
        self.fill[:] = 0
        self.bimids.fill_(-1)
        depth = (int(np.bincount(word_ids, minlength=self.num_words).max())
                 if len(word_ids) else 0)
        self._ensure_capacity(depth, int(n_images) - 1)
        order = np.argsort(word_ids, kind="stable")
        sw = word_ids[order]
        pos = np.arange(len(sw)) - np.searchsorted(sw, sw, side="left")
        dev = self.device
        sw_t = torch.as_tensor(sw.astype(np.int64), device=dev)
        pos_t = torch.as_tensor(pos.astype(np.int64), device=dev)
        self.bvecs[sw_t, pos_t] = torch.as_tensor(
            np.ascontiguousarray(vecs[order]).view(np.int32), device=dev)
        self.bimids[sw_t, pos_t] = torch.as_tensor(
            image_ids[order].astype(np.int32), device=dev)
        self.fill[: self.num_words] = np.bincount(word_ids, minlength=self.num_words)
        nf = torch.as_tensor(np.asarray(norm_factor, np.float32), device=dev)
        self.norm_factor[: nf.shape[0]] = nf
        self.n_entries = int(len(word_ids))
        self.n_images = int(n_images)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ivf_search_bucketed(bvecs, bimids, norm_factor, q_vecs, q_words, q_valid,
                        dim: int, alpha: float, sim_thresh: float, max_images: int,
                        hamming=gather.ivf_hamming):
    """Bucketed IVF scoring: each valid query word's bucket scored by the
    Hamming kernel, then the idf-off normalisation chain and a scatter-add
    into per-image scores.  Invalid query words go to the trash bucket.
    ``hamming`` is the kernel's wrapper; a check on the card passes its plain
    version to score the same tensors both ways."""
    qw = torch.where(q_valid, q_words, bvecs.shape[0] - 1).to(torch.int32)
    dist = hamming(bvecs, q_vecs.to(torch.int32).contiguous(), qw)
    rows_i = bimids[qw.long()]  # (Q, B)
    sim = 1.0 - 2.0 * dist.to(torch.float32) / dim
    match = (rows_i >= 0) & q_valid[:, None]
    sim = torch.where(match & (sim >= sim_thresh), torch.pow(sim, alpha),
                      torch.zeros_like(sim))
    imid = torch.clamp_min(rows_i, 0).long()
    sim = sim / torch.sqrt(torch.clamp_min(norm_factor[imid], 1.0))
    # an entry that matches no image adds its zero in a slot of its own past
    # the images: the fixed-order sum reduces each slot's run in sequence,
    # and most of a query's entries match none
    n = sim.numel()
    spare = torch.arange(max_images, max_images + n, device=sim.device)
    slot = torch.where(match.reshape(-1), imid.reshape(-1), spare)
    scores = torch.zeros((max_images + n,), dtype=torch.float32, device=sim.device)
    index_add_fixed(scores, slot, torch.where(match, sim, torch.zeros_like(sim)).reshape(-1))
    q_norm = torch.sqrt(torch.clamp_min(q_valid.to(torch.float32).sum(), 1.0))
    return scores[:max_images] / q_norm
