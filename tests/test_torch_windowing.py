"""Port parity of the windowed global solve and edge recycling
(``FactorGraph._solve_windowed``, ``_recycle_old_edges``, the edge
freelist): the four cases of tests/test_windowing.py run through the JAX
``FactorGraph`` and the port's on the same problem (identity
correspondences, one world cloud seen from an arc, 1 x N pixel images),
then a window slid over a growing graph with ``edge_recycle`` on.

Tolerances.  Pre-window poses are untouched: equal bits.  Solved poses:
the same systems in f32 in another summation order (and, in the JAX
package, with pinned and free padding poses that no edge touches), 2e-5
absolute, as tests/test_torch_factor_graph.py.  Edge bookkeeping (ii, jj,
edge_live, the freelist, the recycled count, the store's capacity) is
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.ops.global_gn import GlobalGNSettings, gauss_newton_poses
from mast3r_slam_tpu_torch.slam import factor_graph as tfg
from mast3r_slam_tpu_torch.slam import frame as tframe

from test_torch_common import CPU, assert_close, n, t
from test_windowing import _build_graph, _make_problem

POSE_ATOL = 2e-5


def _port_graph(noisy, Xs, window_size, edges, N, edge_capacity=32, **lopt):
    """The port's counterpart of test_windowing._build_graph."""
    M = len(noisy)
    cfg = load_config("base")
    cfg["local_opt"].update(window_size=window_size, Q_conf=-1.0, C_conf=-1.0, **lopt)
    kf = tframe.Keyframes(M, N, 1, 2, device=CPU)
    for i in range(M):
        kf.append(_frame(i, noisy[i], Xs[i], N))
    g = tfg.FactorGraph(None, cfg, kf, img_hw=(1, N), edge_capacity=edge_capacity)
    _store_identity(g, edges, N)
    return g, kf


def _frame(i, T, X, N):
    return tframe.Frame(frame_id=i, img=None, T_WC=t(T), X_canon=t(X),
                        C=torch.full((N, 1), 2.0), n_fused=1, n_updates=1,
                        feat=torch.zeros((1, 1, 2)), pos=torch.zeros((1, 1, 2), dtype=torch.int32))


def _store_identity(g, edges, N):
    """Store identity-correspondence edges through the port's row allocator."""
    if not edges:
        return
    rows = g._take_edge_rows(len(edges))
    g.ii[rows] = [a for a, _ in edges]
    g.jj[rows] = [b for _, b in edges]
    r = torch.as_tensor(rows).long()
    g.idx_ii2jj[r] = torch.arange(N, dtype=torch.int32)
    g.idx_jj2ii[r] = torch.arange(N, dtype=torch.int32)
    for a in (g.valid_match_j, g.valid_match_i):
        a[r] = True
    for a in (g.Q_ii2jj, g.Q_jj2ii):
        a[r] = 2.0
    g._stamp_f[rows] = -1
    g._stamp_b[rows] = -1
    g.edge_live[rows] = True


def _jax_store_identity(g, edges, N):
    """The same through the JAX graph's row allocator."""
    rows = g._take_edge_rows(len(edges))
    g.ii[rows] = [a for a, _ in edges]
    g.jj[rows] = [b for _, b in edges]
    r = jnp.asarray(rows)
    g.idx_ii2jj = g.idx_ii2jj.at[r].set(jnp.arange(N, dtype=jnp.int32))
    g.idx_jj2ii = g.idx_jj2ii.at[r].set(jnp.arange(N, dtype=jnp.int32))
    g.valid_match_j = g.valid_match_j.at[r].set(True)
    g.valid_match_i = g.valid_match_i.at[r].set(True)
    g.Q_ii2jj = g.Q_ii2jj.at[r].set(2.0)
    g.Q_jj2ii = g.Q_jj2ii.at[r].set(2.0)
    g._stamp_f[rows] = -1
    g._stamp_b[rows] = -1
    g.edge_live[rows] = True


def test_windowed_solve_recovers_recent_and_freezes_old():
    M, N, W = 12, 48, 4
    gt, noisy, Xs, _ = _make_problem(M, N, perturb_from=M - W)
    edges = [(i, i + 1) for i in range(M - 1)] + [(2, 9)]  # chain + loop
    jg, jkf = _build_graph(noisy, Xs, W, edges, N)
    tg, tkf = _port_graph(noisy, Xs, W, edges, N)
    old = n(tkf.T_WC[: M - W]).copy()
    jg.solve(mode="rays")
    tg.solve(mode="rays")
    T = n(tkf.T_WC[:M])
    np.testing.assert_array_equal(T[: M - W], old)  # bit for bit
    assert_close(T, np.asarray(jkf.T_WC[:M]), 0, POSE_ATOL, "windowed poses vs JAX")
    err = np.linalg.norm(T[M - W:, :3] - gt[M - W:, :3], axis=-1)
    init = np.linalg.norm(noisy[M - W:, :3] - gt[M - W:, :3], axis=-1)
    assert err.max() < 0.02 * init.max(), (err.max(), init.max())


def test_windowed_matches_pinned_full_solve():
    """The port's windowed solve == its own full-graph GN with every
    pre-window pose pinned, and == the JAX windowed solve."""
    M, N, W = 10, 32, 4
    gt, noisy, Xs, _ = _make_problem(M, N, perturb_from=M - W, seed=3)
    edges = [(i, i + 1) for i in range(M - 1)] + [(1, 7)]
    jg, jkf = _build_graph(noisy, Xs, W, edges, N)
    tg, tkf = _port_graph(noisy, Xs, W, edges, N)
    jg.solve(mode="rays")
    tg.solve(mode="rays")
    T_win = n(tkf.T_WC[:M])

    E = len(edges)
    ii2 = torch.tensor([a for a, b in edges] + [b for a, b in edges])
    jj2 = torch.tensor([b for a, b in edges] + [a for a, b in edges])
    idx = torch.arange(N, dtype=torch.int32).expand(2 * E, N)
    s = GlobalGNSettings(edge_batch=4, pin=M - W, solver="dense")
    T_ref, _, ok, _ = gauss_newton_poses(
        t(noisy), t(Xs), torch.full((M, N, 1), 2.0), ii2, jj2, idx,
        torch.ones((2 * E, N, 1), dtype=torch.bool), torch.full((2 * E, N, 1), 2.0),
        torch.eye(3), (1, N), s, "rays")
    assert ok
    assert_close(T_win, T_ref, 0, POSE_ATOL, "windowed vs pinned full solve")
    assert_close(T_win, np.asarray(jkf.T_WC[:M]), 0, POSE_ATOL, "windowed vs JAX")


def test_no_window_below_threshold():
    """window_size >= free poses: the full solve's bits, as in JAX."""
    M, N = 6, 32
    gt, noisy, Xs, _ = _make_problem(M, N, perturb_from=1, seed=5)
    edges = [(i, i + 1) for i in range(M - 1)]
    tg_w, tkf_w = _port_graph(noisy, Xs, 64, edges, N)
    tg_f, tkf_f = _port_graph(noisy, Xs, 0, edges, N)
    jg, jkf = _build_graph(noisy, Xs, 64, edges, N)
    for g in (tg_w, tg_f, jg):
        g.solve(mode="rays")
    np.testing.assert_array_equal(n(tkf_w.T_WC[:M]), n(tkf_f.T_WC[:M]))
    assert_close(tkf_w.T_WC[:M], np.asarray(jkf.T_WC[:M]), 0, POSE_ATOL, "vs JAX")


def test_auto_beyond_knee_routes_pcg_unwindowed():
    """solver auto, unbounded window: past the dense knee the solve routes
    to PCG over all poses, in both packages."""
    M, N = 9, 32
    gt, noisy, Xs, _ = _make_problem(M, N, perturb_from=1, seed=7)
    edges = [(i, i + 1) for i in range(M - 1)]
    jg, jkf = _build_graph(noisy, Xs, int(1e6), edges, N)
    tg, tkf = _port_graph(noisy, Xs, int(1e6), edges, N)
    for g in (jg, tg):
        g.settings = g.settings._replace(dense_max_poses=4)
        g.solve(mode="rays")
    T = n(tkf.T_WC[:M])
    err = np.linalg.norm(T[1:, :3] - gt[1:, :3], axis=-1)
    init = np.linalg.norm(noisy[1:, :3] - gt[1:, :3], axis=-1)
    assert err.max() < 0.05 * init.max()
    assert tg._health_pending is not None  # the PCG route recorded its flag
    assert_close(T, np.asarray(jkf.T_WC[:M]), 0, POSE_ATOL, "PCG route vs JAX")


def _slide(store, solve, append, steps):
    """Grow both graphs keyframe by keyframe: each step appends keyframe k,
    stores its chain edge and, every third, a loop edge, then solves."""
    for k in steps:
        append(k)
        edges = [(k - 1, k)] + ([(k - 5, k)] if k % 3 == 0 else [])
        store(edges)
        solve()


@pytest.mark.parametrize("recycle", [False, True])
def test_recycled_rows_freelist_and_poses_equal_jax(recycle):
    """A window of 4 slid over 12 keyframes: with ``edge_recycle`` the old
    edges' rows are zeroed, marked dead and reused (the store stops
    growing), exactly as in the JAX graph; without it nothing is recycled.
    The poses agree either way (recycled edges touch pinned poses only)."""
    M, N, W, M0 = 16, 32, 4, 6
    gt, noisy, Xs, _ = _make_problem(M, N, perturb_from=1, seed=11)
    first = [(i, i + 1) for i in range(M0 - 1)]
    jg, jkf = _build_graph(noisy[:M0], Xs[:M0], W, first, N)
    jg.lcfg["edge_recycle"] = recycle
    tg, tkf = _port_graph(noisy[:M0], Xs[:M0], W, first, N, edge_capacity=8,
                          edge_recycle=recycle)
    import mast3r_slam_tpu.slam.frame as jframe
    jkf._ensure_capacity(M)
    caps = []

    def append(k):
        jkf.append(jframe.Frame(frame_id=k, img=None, T_WC=jnp.asarray(noisy[k]),
                                X_canon=jnp.asarray(Xs[k]), C=jnp.full((N, 1), 2.0),
                                n_fused=1, n_updates=1, feat=jnp.zeros((1, 1, 2)),
                                pos=jnp.zeros((1, 1, 2), jnp.int32)))
        tkf.append(_frame(k, noisy[k], Xs[k], N))

    def store(edges):
        _jax_store_identity(jg, edges, N)
        _store_identity(tg, edges, N)

    def solve():
        jg.solve(mode="rays")
        tg.solve(mode="rays")
        caps.append(tg.capacity)
        E = jg.n_edges
        assert tg.n_edges == E
        np.testing.assert_array_equal(tg.ii[:E], jg.ii[:E])
        np.testing.assert_array_equal(tg.jj[:E], jg.jj[:E])
        np.testing.assert_array_equal(tg.edge_live[:E], jg.edge_live[:E])
        assert tg._free_edge_rows == jg._free_edge_rows
        assert tg.n_edges_recycled == jg.n_edges_recycled
        assert_close(tkf.T_WC[:len(tkf)], np.asarray(jkf.T_WC[:len(jkf)]), 0, POSE_ATOL,
                     "slid window vs JAX")

    solve()
    _slide(store, solve, append, range(M0, M))
    dead = ~tg.edge_live[:tg.n_edges]
    if not recycle:
        assert tg.n_edges_recycled == 0 and not dead.any()
        return
    assert tg.n_edges_recycled > 0 and dead.any()
    # a recycled row is a zero-weight row until it is reused
    r = torch.as_tensor(np.nonzero(dead)[0]).long()
    assert not tg.valid_match_j[r].any() and not tg.valid_match_i[r].any()
    assert float(tg.Q_ii2jj[r].abs().max()) == 0.0 and (tg.ii[dead.nonzero()] == 0).all()
    assert caps[-1] == caps[len(caps) // 2], caps  # the store stopped growing
