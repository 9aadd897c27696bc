"""Port parity of the ``speed`` profile's backend edges
(``slam/factor_graph.py``): one-way loop-closure edges
(``local_opt.oneway_nonconsec``), the tracker's captured match reused as a
consecutive edge's backward half (``reuse_tracker_match``) and the
speculative gate (``speculative_gate``), against the JAX ``FactorGraph`` on
the same oracle keyframes (tests/test_torch_factor_graph.py's setup: five
keyframes of an arc at 48x64); the checks of tests/test_oneway_backend.py
and tests/test_backend_rtt.py:65-125.  Then ``SLAM.run`` under ``speed``
with retrieval, held to the JAX test's 0.04 m ATE.

Tolerances: those of tests/test_torch_factor_graph.py.  Edges and verdicts
are decisions: equal.  Indices equal on every valid pixel and within 0.1%
of pixels; validity equal; Q 1e-6 relative.  Within the port, a path that
runs the same matcher on the same decode gives the same bits (the forward
half of a one-way edge against the symmetric path's), and zero-weight rows
leave a solve unchanged to 1e-6 (the JAX test's bound).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu.eval.trajectory import umeyama_alignment
from mast3r_slam_tpu.slam import factor_graph as jfg
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.lie import sim3
from mast3r_slam_tpu_torch.retrieval import (ASMKSettings, RetrievalDatabase,
                                             RetrievalHeadSettings)
from mast3r_slam_tpu_torch.retrieval.head import init_head_params
from mast3r_slam_tpu_torch.slam import factor_graph as tfg
from mast3r_slam_tpu_torch.slam.pipeline import SLAM

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_torch_common import CPU, TorchOracleModel, assert_close, n, t
from test_torch_factor_graph import HW, MAX_MISMATCH, N, N_KF, _setup


@pytest.fixture(scope="module")
def stores():
    jg, tg, _, _ = _setup("base")
    return jg, tg


def _graphs(stores, **switches):
    """A fresh JAX graph and port graph on the shared stores, with the
    ``local_opt`` switches given."""
    jg0, tg0 = stores
    jcfg, cfg = copy.deepcopy(jg0.cfg), copy.deepcopy(tg0.cfg)
    for c in (jcfg, cfg):
        c["local_opt"].update(switches)
    jg = jfg.FactorGraph(jg0.model, jcfg, jg0.keyframes, HW, edge_capacity=8)
    tg = tfg.FactorGraph(tg0.model, cfg, tg0.keyframes, HW, edge_capacity=8)
    return jg, tg


def _assert_edges_equal(tg, jg):
    E = jg.n_edges
    assert tg.n_edges == E
    np.testing.assert_array_equal(tg.ii[:E], jg.ii[:E])
    np.testing.assert_array_equal(tg.jj[:E], jg.jj[:E])
    for idx_t, idx_j, v_t, v_j, q_t, q_j in (
            (tg.idx_ii2jj, jg.idx_ii2jj, tg.valid_match_j, jg.valid_match_j,
             tg.Q_ii2jj, jg.Q_ii2jj),
            (tg.idx_jj2ii, jg.idx_jj2ii, tg.valid_match_i, jg.valid_match_i,
             tg.Q_jj2ii, jg.Q_jj2ii)):
        it, ij = n(idx_t[:E]), np.asarray(idx_j[:E])
        vt, vj = n(v_t[:E]), np.asarray(v_j[:E])
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(it[vt[..., 0]], ij[vj[..., 0]])
        assert np.mean(it != ij) <= MAX_MISMATCH
        assert_close(q_t[:E], np.asarray(q_j[:E]), 1e-6, 0, "Q")


PAIRS = ([3, 2], [4, 4])  # the consecutive edge and a loop-closure candidate


@pytest.mark.parametrize("config", ["base", "speed"])
def test_oneway_forward_fields(stores, config):
    """The loop-closure edge stores the forward half only (its backward
    half-row zero-weight); the consecutive edge stays bidirectional; both
    equal the JAX graph's, and the forward halves equal the port's own
    symmetric path's, bit for bit."""
    matching = load_config(config)["matching"]
    jg, tg = _graphs(stores, oneway_nonconsec=True)
    _, tref = _graphs(stores)
    for g in (jg, tg, tref):
        g.cfg["matching"] = copy.deepcopy(matching)
    thresh = tg.lcfg["min_match_frac"]
    assert jg.add_factors(*PAIRS, thresh) and tg.add_factors(*PAIRS, thresh)
    assert tref.add_factors(*PAIRS, thresh)
    _assert_edges_equal(tg, jg)
    assert list(tg.ii[:2]) == PAIRS[0] and list(tg.jj[:2]) == PAIRS[1]
    for a, b in ((tg.idx_ii2jj, tref.idx_ii2jj), (tg.valid_match_j, tref.valid_match_j),
                 (tg.Q_ii2jj, tref.Q_ii2jj)):
        assert torch.equal(a[:2], b[:2])
    assert torch.equal(tg.idx_jj2ii[0], tref.idx_jj2ii[0]) and tg.valid_match_i[0].any()
    assert not tg.valid_match_i[1].any()
    assert float(tg.Q_jj2ii[1].abs().max()) == 0.0 and int(tg.idx_jj2ii[1].abs().max()) == 0


def test_oneway_gate_reads_the_forward_fraction_only(stores):
    """An impossible threshold drops the loop-closure candidate; the
    consecutive edge is kept unconditionally."""
    jg, tg = _graphs(stores, oneway_nonconsec=True)
    for g in (jg, tg):
        assert g.add_factors([3, 0], [4, 4], min_match_frac=2.0)
        assert g.n_edges == 1 and (g.ii[0], g.jj[0]) == (3, 4)
    # a threshold between the two directions' fractions: the one-way gate
    # passes the candidate on its forward fraction alone, as the JAX one does
    _, sym = _graphs(stores)
    out = sym._compute_symmetric(sym.keyframes.snapshot(), np.array([2]), np.array([4]))
    fj, fi = float(out["match_frac_j"][0]), float(out["match_frac_i"][0])
    if abs(fj - fi) > 1e-3:
        mid = (fj + fi) / 2
        jg, tg = _graphs(stores, oneway_nonconsec=True)
        assert (jg.add_factors([2], [4], mid), tg.add_factors([2], [4], mid)) == (fj >= mid,) * 2


def test_reloc_stays_bidirectional_under_oneway(stores):
    jg, tg = _graphs(stores, oneway_nonconsec=True, speculative_gate=True)
    _, tref = _graphs(stores)
    thresh = tg.lcfg["min_match_frac"]
    for g in (jg, tg, tref):
        assert g.add_factors([4], [3], thresh, is_reloc=True, strict=False)
    _assert_edges_equal(tg, jg)
    assert tg.valid_match_i[0].any() and not tg._pending
    for a, b in ((tg.idx_jj2ii, tref.idx_jj2ii), (tg.Q_jj2ii, tref.Q_jj2ii)):
        assert torch.equal(a[:1], b[:1])


def test_reuse_capture_stored_as_backward(stores):
    rng = np.random.default_rng(11)
    cap = (rng.integers(0, N, size=(N,)).astype(np.int32), rng.random((N, 1)) > 0.4,
           (rng.random((N, 1)) * 3.0).astype(np.float32))
    jg, tg = _graphs(stores, reuse_tracker_match=True)
    _, tref = _graphs(stores)
    thresh = tg.lcfg["min_match_frac"]
    assert jg.add_factors([3], [4], thresh, captures={(3, 4): tuple(jnp.asarray(a) for a in cap)})
    assert tg.add_factors([3], [4], thresh, captures={(3, 4): tuple(t(a) for a in cap)})
    assert tref.add_factors([3], [4], thresh)
    _assert_edges_equal(tg, jg)
    for got, want in zip((tg.idx_jj2ii[0], tg.valid_match_i[0], tg.Q_jj2ii[0]), cap):
        np.testing.assert_array_equal(n(got), want)
    for a, b in ((tg.idx_ii2jj, tref.idx_ii2jj), (tg.valid_match_j, tref.valid_match_j),
                 (tg.Q_ii2jj, tref.Q_ii2jj)):
        assert torch.equal(a[:1], b[:1])
    # a capture of another pair leaves the edge on the symmetric path
    _, tfb = _graphs(stores, reuse_tracker_match=True)
    assert tfb.add_factors([3], [4], thresh, captures={(0, 1): tuple(t(a) for a in cap)})
    assert torch.equal(tfb.idx_jj2ii[0], tref.idx_jj2ii[0])


MIXED = ([3, 2, 0], [4, 4, 4])  # consecutive, overlapping, hopeless


@pytest.mark.parametrize("oneway", [True, False])
def test_speculative_gate_bookkeeping(stores, oneway):
    """Every candidate is stored with its verdict on the device; once read,
    the live edges are the JAX graph's and the non-speculative port graph's,
    and the dead rows are zero-weight."""
    jg, tg = _graphs(stores, speculative_gate=True, oneway_nonconsec=oneway)
    _, tref = _graphs(stores, oneway_nonconsec=oneway)
    for g in (jg, tg, tref):
        assert g.add_factors(*MIXED, 0.5)
    _assert_edges_equal(tg, jg)
    assert tg.n_edges == 3 and len(tg._pending) >= 1
    live = tg.n_live_edges
    assert not tg._pending and live == jg.n_live_edges == tref.n_edges < 3
    np.testing.assert_array_equal(tg.edge_live[:3], jg.edge_live[:3])
    E = tg.n_edges
    live_pairs = {(int(a), int(b)) for a, b, l in zip(tg.ii[:E], tg.jj[:E], tg.edge_live[:E]) if l}
    assert live_pairs == set(zip(tref.ii[:tref.n_edges].tolist(), tref.jj[:tref.n_edges].tolist()))
    for e in np.nonzero(~tg.edge_live[:E])[0]:
        assert not tg.valid_match_j[e].any() and not tg.valid_match_i[e].any()
        assert float(tg.Q_ii2jj[e].abs().max()) == 0.0 == float(tg.Q_jj2ii[e].abs().max())


def test_speculative_solve_equals_the_gated_solve(stores):
    """Dead zero-weight rows do not move the solve: perturb the last pose,
    solve the speculative graph and the non-speculative one from it."""
    _, tg = _graphs(stores, speculative_gate=True, oneway_nonconsec=True)
    _, tref = _graphs(stores, oneway_nonconsec=True)
    for g in (tg, tref):
        g.add_factors(*MIXED, 0.5)
    assert tg.n_edges > tref.n_edges
    kf = tg.keyframes
    saved = kf.T_WC.clone()
    tau = torch.tensor([0.03, 0, 0, 0.02, 0, 0, 0])
    perturbed = saved.clone()
    perturbed[N_KF - 1] = sim3.retr(saved[N_KF - 1], tau)
    poses = []
    for g in (tref, tg):
        kf.T_WC.copy_(perturbed)
        g.solve()
        poses.append(kf.T_WC[:N_KF].clone())
    kf.T_WC.copy_(saved)
    assert not torch.equal(poses[0], perturbed[:N_KF])
    assert_close(poses[1], poses[0], 0, 1e-6, "speculative against gated solve")


def test_speed_with_retrieval_tracks():
    """``SLAM.run`` under ``speed`` (single thread, the pipelined loop) with
    retrieval: loop-closure candidates go through the one-way path, their
    backward halves carry no weight, and the frame ATE stays under the JAX
    test's 0.04 m (tests/test_oneway_backend.py)."""
    n_frames = 30
    gt = arc_trajectory(n_frames, radius=0.6, max_angle=2.5)
    oracle = OracleModel(PlaneScene(HW), gt, noise=0.002)
    g = torch.Generator().manual_seed(0)
    db = RetrievalDatabase(init_head_params(g, oracle.feat_dim, hdims=(8,)),
                           torch.randn((64, 8), generator=g) * 0.3,
                           RetrievalHeadSettings(nfeat=8), ASMKSettings(max_images=64),
                           device=CPU)
    cfg = load_config("speed")
    cfg["single_thread"] = True
    cfg["engine"]["edge_buffer"] = 64
    slam = SLAM(TorchOracleModel(oracle), cfg, HW, keyframe_buffer=64, retrieval=db,
                device=CPU)
    res = slam.run(OracleDataset(n_frames, HW), verbose=False)
    gr = slam.graph
    E = gr.n_edges
    nonconsec = [e for e in range(E) if gr.ii[e] != gr.jj[e] - 1]
    assert nonconsec, "retrieval proposed no loop-closure candidate"
    for e in nonconsec:
        assert not gr.valid_match_i[e].any()
    # the consecutive edges carry the tracker's captured match backward
    assert sum(bool(gr.valid_match_i[e].any()) for e in range(E) if e not in nonconsec) >= 2
    est = res.frame_poses[:, :3].astype(np.float64)
    s, R, tr = umeyama_alignment(est, gt[:, :3])
    aligned = (s * (R @ est.T)).T + tr
    ate = float(np.sqrt(np.mean(np.linalg.norm(aligned - gt[:, :3], axis=-1) ** 2)))
    assert ate < 0.04, f"speed-profile ATE {ate:.4f}"
