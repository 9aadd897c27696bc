"""Port parity of strided backend edges (``local_opt.pixel_stride``): edges
matched from an s-strided source grid and scattered back to full shape,
against the JAX ``FactorGraph`` on the same oracle keyframes
(tests/test_torch_factor_graph.py's set-up, 48x64), a solve through them,
and the engine at stride 2 against the JAX engine.

Tolerances (those of tests/test_torch_factor_graph.py and
tests/test_torch_slam_e2e.py).  Off-grid rows are exact zero weight.  Valid
flags are equal; match indices are equal on every valid pixel and differ
on at most 0.1 % of the pixels (tests/test_torch_matching.py's floor
bound); Q agrees to 1e-6 relative; solved poses 2e-5; engine poses 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.slam.pipeline import SLAM

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_torch_common import CPU, TorchOracleModel, assert_close, n
from test_torch_factor_graph import MAX_MISMATCH, PAIRS, POSE_ATOL, _setup

HW = (48, 64)
N = HW[0] * HW[1]
STRIDE = 2
GRID = np.zeros((N,), bool)
GRID[(np.arange(0, HW[0], STRIDE)[:, None] * HW[1]
      + np.arange(0, HW[1], STRIDE)[None, :]).reshape(-1)] = True


@pytest.fixture(scope="module")
def strided():
    """Both graphs at stride 2 over PAIRS, and the port's at stride 1."""
    jg, tg, gt, poses = _setup("base")
    _, t1, _, _ = _setup("base")
    jg._pstride = tg._pstride = STRIDE
    frac = jg.cfg["local_opt"]["min_match_frac"]
    assert jg.add_factors(*PAIRS, frac) and tg.add_factors(*PAIRS, frac)
    assert t1.add_factors(*PAIRS, frac)
    return jg, tg, t1, gt, poses


def test_strided_fields_live_on_the_grid(strided):
    """Zero weight off the grid; on it, the JAX graph's fields, and mostly
    the full-density matcher's target pixels (tests/test_pixel_budget.py)."""
    jg, tg, t1, _, _ = strided
    E = jg.n_edges
    assert tg.n_edges == E and t1.n_edges == E
    np.testing.assert_array_equal(tg.ii[:E], jg.ii[:E])
    np.testing.assert_array_equal(tg.jj[:E], jg.jj[:E])
    for idx_t, idx_j, v_t, v_j, q_t, q_j in (
            (tg.idx_ii2jj, jg.idx_ii2jj, tg.valid_match_j, jg.valid_match_j,
             tg.Q_ii2jj, jg.Q_ii2jj),
            (tg.idx_jj2ii, jg.idx_jj2ii, tg.valid_match_i, jg.valid_match_i,
             tg.Q_jj2ii, jg.Q_jj2ii)):
        it, ij = n(idx_t[:E]), np.asarray(idx_j[:E])
        vt, vj = n(v_t[:E])[..., 0], np.asarray(v_j[:E])[..., 0]
        qt = n(q_t[:E])[..., 0]
        assert not vt[:, ~GRID].any() and float(np.abs(qt[:, ~GRID]).max()) == 0.0
        assert not it[:, ~GRID].any()
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(it[vt], ij[vj])
        assert np.mean(it != ij) <= MAX_MISMATCH
        assert_close(q_t[:E], np.asarray(q_j[:E]), 1e-6, 0, "Q")
    vs, v1 = n(tg.valid_match_j[0])[:, 0], n(t1.valid_match_j[0])[:, 0]
    frac_s, frac_1 = vs[GRID].mean(), v1[GRID].mean()
    assert frac_s > 0.5 * frac_1 and frac_s > 0.3, (frac_s, frac_1)
    i1, is_ = n(t1.idx_ii2jj[0]), n(tg.idx_ii2jj[0])
    both = GRID & vs & v1
    W = HW[1]
    near = ((np.abs(i1[both] % W - is_[both] % W) <= 1)
            & (np.abs(i1[both] // W - is_[both] // W) <= 1))
    assert near.mean() > 0.9


def test_solve_through_strided_edges(strided):
    """The strided edges anchor the solve (tests/test_pixel_budget.py): from
    the solved poses perturbed by 0.03, a second solve comes back, in both
    packages to the same poses."""
    jg, tg, _, _, _ = strided
    jg.solve()
    tg.solve()
    k = len(tg.keyframes)
    clean = n(tg.keyframes.T_WC[:k]).copy()
    assert_close(clean, np.asarray(jg.keyframes.T_WC[:k]), 0, POSE_ATOL, "first solve")
    tau = np.random.default_rng(7).normal(size=(k, 7)).astype(np.float32) * 0.03
    tau[0] = 0
    noisy = np.asarray(jsim3.retr(jnp.asarray(clean), jnp.asarray(tau)))
    jg.keyframes.T_WC = jg.keyframes.T_WC.at[:k].set(jnp.asarray(noisy))
    tg.keyframes.T_WC[:k] = torch.tensor(noisy)
    jg.solve()
    tg.solve()
    got = n(tg.keyframes.T_WC[:k])
    assert_close(got, np.asarray(jg.keyframes.T_WC[:k]), 0, POSE_ATOL, "second solve")
    before = np.linalg.norm(noisy[:, :3] - clean[:, :3], axis=-1).mean()
    after = np.linalg.norm(got[:, :3] - clean[:, :3], axis=-1).mean()
    assert after < 0.3 * before, (before, after)


def test_engine_at_stride_2_equals_jax():
    """SLAM.run at pixel_stride 2 in both packages (tests/test_torch_slam_e2e.py's
    8-frame arc): the same keyframes and edges, poses within 2e-4."""
    n_frames = 8
    gt = arc_trajectory(n_frames, radius=0.6, max_angle=2.5)
    oracle = OracleModel(PlaneScene(HW), gt, noise=0.002)
    runs = []
    for load, make in ((jload_config, lambda c: JSLAM(oracle, c, HW)),
                       (load_config, lambda c: SLAM(TorchOracleModel(oracle), c, HW,
                                                    device=CPU))):
        cfg = load("base")
        cfg["single_thread"] = True
        cfg["engine"]["keyframe_buffer"] = 16
        cfg["engine"]["edge_buffer"] = 16
        cfg["local_opt"]["pixel_stride"] = STRIDE
        slam = make(cfg)
        runs.append((slam, slam.run(OracleDataset(n_frames, HW), verbose=False)))
    (js, jr), (ts, tr) = runs
    assert tr.n_keyframes == jr.n_keyframes >= 2 and tr.n_reloc == jr.n_reloc == 0
    assert tr.keyframe_timestamps == jr.keyframe_timestamps
    E = js.graph.n_edges
    assert ts.graph.n_edges == E
    np.testing.assert_array_equal(ts.graph.ii[:E], js.graph.ii[:E])
    assert not n(ts.graph.valid_match_j[:E])[:, ~GRID].any()
    np.testing.assert_allclose(tr.frame_poses, jr.frame_poses, rtol=0, atol=2e-4)
    np.testing.assert_allclose(tr.keyframe_poses, np.asarray(jr.keyframe_poses), rtol=0,
                               atol=2e-4)
