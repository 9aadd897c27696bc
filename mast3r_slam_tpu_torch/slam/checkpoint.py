"""Map and graph checkpoints (port of ``mast3r_slam_tpu/slam/checkpoint.py``).

One compressed npz of format v2 with the JAX package's keys and dtypes, so
that a checkpoint written by either package loads into the other: the
keyframe store's filled slots, the factor graph's edges (with the
speculative gate's ``edge_live``), the retrieval inverted file as flat
entry rows, and the mode.  Model and retrieval-head weights are not in it:
an engine is built with its weights, then loaded.

Both functions wait for the threaded backend to go idle first.  Loading
moves every restored keyframe's ``pm_version`` and the store's
``generation``, so the factor graph's gathered-point cache and any backend
snapshot taken before the load are not reused; it clears the speculative
gate's pending verdicts and the tracker's warm-start matches.  The port
recycles no edges yet (ROADMAP Queue 1 item 8e), so no edge freelist is
saved or restored.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from .frame import Mode

CHECKPOINT_VERSION = 2


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_state(path, slam) -> None:
    """Serialise a SLAM engine's map state to <path> (npz)."""
    slam.join_backend()
    kf = slam.keyframes
    g = slam.graph
    g.resolve_pending_verdicts()  # the speculative gate's verdicts land first
    with slam.backend_lock, kf.lock:
        n = len(kf)
        E = g.n_edges
        arrays = dict(
            version=np.asarray(CHECKPOINT_VERSION),
            mode=np.asarray(int(slam.mode)),
            img_hw=np.asarray(slam.img_hw),
            kf_frame_id=kf.frame_id[:n].copy(),
            kf_T_WC=_np(kf.T_WC[:n]),
            kf_n_fused=_np(kf.n_fused[:n]),
            kf_n_updates=_np(kf.n_updates[:n]),
            kf_score=_np(kf.score[:n]),
            kf_X=_np(kf.X[:n]),
            kf_C=_np(kf.C[:n]),
            kf_feat=_np(kf.feat[:n]),
            kf_pos=_np(kf.pos[:n]),
            edge_ii=g.ii[:E].copy(),
            edge_jj=g.jj[:E].copy(),
            edge_idx_ii2jj=_np(g.idx_ii2jj[:E]),
            edge_idx_jj2ii=_np(g.idx_jj2ii[:E]),
            edge_valid_j=_np(g.valid_match_j[:E]),
            edge_valid_i=_np(g.valid_match_i[:E]),
            edge_Q_ii2jj=_np(g.Q_ii2jj[:E]),
            edge_Q_jj2ii=_np(g.Q_jj2ii[:E]),
            edge_live=g.edge_live[:E].copy(),
        )
        if kf.K is not None:
            arrays["K"] = _np(kf.K)
        uimgs = kf.uimgs[:n]
        if n > 0 and all(u is not None for u in uimgs):
            arrays["kf_uimg"] = np.stack(uimgs)
        rdb = slam.retrieval
        if rdb is not None:
            vecs, word_ids, image_ids = rdb.ivf.entries()
            arrays.update(
                # the codes' bits, as the JAX package's uint32
                ivf_vecs=np.ascontiguousarray(vecs).view(np.uint32),
                ivf_word_ids=word_ids, ivf_image_ids=image_ids,
                ivf_norm_factor=_np(rdb.ivf.norm_factor),
                ivf_n_images=np.asarray(rdb.ivf.n_images),
                retrieval_kf_counter=np.asarray(rdb.kf_counter),
            )
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_state(path, slam) -> None:
    """Restore a checkpoint into an engine built with the same image size."""
    slam.join_backend()
    with np.load(path, allow_pickle=False) as data:
        version = int(data["version"])
        if version > CHECKPOINT_VERSION:
            raise ValueError(f"{path}: checkpoint format v{version}, this build reads "
                             f"up to v{CHECKPOINT_VERSION}")
        if tuple(data["img_hw"]) != tuple(slam.img_hw):
            raise ValueError(f"{path}: image size {tuple(data['img_hw'])}, the engine's "
                             f"is {tuple(slam.img_hw)}")
        _load(data, slam)


def _load(data, slam) -> None:
    kf = slam.keyframes
    g = slam.graph
    n = len(data["kf_frame_id"])
    E = len(data["edge_ii"])
    with slam.backend_lock, kf.lock:
        kf._ensure_capacity(n)
        g._ensure_capacity(E)
        dev = kf.device

        def put(dst, key, rows):
            dst[:rows] = torch.as_tensor(np.asarray(data[key])).to(device=dev,
                                                                    dtype=dst.dtype)

        kf.n = n
        kf.frame_id[:] = -1
        kf.frame_id[:n] = data["kf_frame_id"]
        put(kf.T_WC, "kf_T_WC", n)
        put(kf.n_fused, "kf_n_fused", n)
        if "kf_n_updates" in data:
            put(kf.n_updates, "kf_n_updates", n)
            put(kf.score, "kf_score", n)
        else:  # v1 checkpoints predate the fusion counters
            put(kf.n_updates, "kf_n_fused", n)
        for name in ("X", "C", "feat", "pos"):
            put(getattr(kf, name), f"kf_{name}", n)
        kf.pm_version[:n] += 1
        kf.generation += 1
        if "K" in data:
            kf.K = torch.as_tensor(np.asarray(data["K"]), dtype=torch.float32, device=dev)
            g.K = kf.K
        kf.uimgs = [None] * kf.capacity
        if "kf_uimg" in data:
            for i in range(n):
                kf.uimgs[i] = data["kf_uimg"][i]

        g.n_edges = E
        g.ii[:E] = data["edge_ii"]
        g.jj[:E] = data["edge_jj"]
        put(g.idx_ii2jj, "edge_idx_ii2jj", E)
        put(g.idx_jj2ii, "edge_idx_jj2ii", E)
        put(g.valid_match_j, "edge_valid_j", E)
        put(g.valid_match_i, "edge_valid_i", E)
        put(g.Q_ii2jj, "edge_Q_ii2jj", E)
        put(g.Q_jj2ii, "edge_Q_jj2ii", E)
        g._stamp_f[:] = -1
        g._stamp_b[:] = -1
        with g._verdict_lock:
            g._pending = []
            g.edge_live[:] = True
            if "edge_live" in data:  # checkpoints before the speculative gate lack it
                g.edge_live[:E] = data["edge_live"]

        rdb = slam.retrieval
        if rdb is not None and "ivf_vecs" in data:
            rdb.ivf.load_entries(data["ivf_vecs"], data["ivf_word_ids"],
                                 data["ivf_image_ids"], data["ivf_norm_factor"],
                                 int(data["ivf_n_images"]))
            rdb.kf_counter = int(data["retrieval_kf_counter"])

        slam.tracker.reset_idx_f2k()
        slam.mode = Mode(int(data["mode"]))
