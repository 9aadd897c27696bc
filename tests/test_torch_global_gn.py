"""Port parity of the global Gauss-Newton solve (``ops/global_gn.py``) and of
the per-edge ray blocks (``ops/edge_hg.py``, the plain form of the
``csrc/edge_hg_rays.cu`` kernel).

The same numpy inputs go through the JAX package and the port.  Problems
are the JAX tests' own: ``test_sharded_ba._rays_problem`` /
``_calib_problem`` (exact correspondences, perturbed poses).

Tolerances.  Edge blocks are compared entry by entry on the scale the
solve reads them at, ``edge_hg.block_err``: |got_ij - want_ij| /
sqrt(|want_ii|·|want_jj|), the cost being the error column's diagonal.
The JAX kernel (Pallas, interpret mode), the JAX "reduce" formulation, the
port's (8, N·R) x (N·R, 8) product and the float64 evaluation sum the same
terms in different orders and precisions: measured 6e-7 to 3e-6 on these
inputs, bound 3e-5.  Planted faults (gradient negated or zeroed, cost 30 %
off, scale row 1 % off, distance row dropped) measure 1e-2 to 1.  Poses:
the solves assemble the same systems and factor them with different
LAPACKs; after the iterations poses agree to 1e-5 absolute (unit-scale
translations, unit quaternions), and both recover the ground truth as the
JAX tests assert (1e-4 dense, 5e-3 PCG with either preconditioner).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu.ops import global_gn as jgn
from mast3r_slam_tpu.ops.edge_hg_pallas import TILE_N, edge_hg_rays_pallas
from mast3r_slam_tpu_torch.ops import edge_hg
from mast3r_slam_tpu_torch.ops import global_gn as tgn

from test_sharded_ba import _calib_problem, _rays_problem
from test_torch_common import assert_close, n, random_sim3, t

SIG = dict(sigma_ray=0.003, sigma_dist=10.0, huber_k=1.345)
POSE_ATOL = 1e-5


def _edge_inputs(E=5, N=300, seed=0):
    """Edges whose j-points map near their i-points (residuals on both sides
    of the Huber threshold), with a fifth of the pixels invalid (sq = 0)."""
    rng = np.random.default_rng(seed)
    Tij = random_sim3(rng, (E,), t_scale=0.2, rot_scale=0.2)
    Xi = rng.normal(size=(E, N, 3)).astype(np.float32)
    Xi[..., 2] = np.abs(Xi[..., 2]) + 2.0
    Xj = np.asarray(jsim3.act(jsim3.inv(jnp.asarray(Tij))[:, None, :], jnp.asarray(Xi)))
    Xj = (Xj + rng.normal(size=Xj.shape) * 0.01).astype(np.float32)
    sq = (np.sqrt(rng.uniform(1.5, 3.0, size=(E, N)))
          * (rng.uniform(size=(E, N)) > 0.2)).astype(np.float32)
    return Tij, Xi, Xj, sq


def _pallas_mloc(Tij, Xi, Xj, sq):
    """The JAX kernel as the JAX solve calls it: pixels padded to its tile
    with finite dummy points at zero weight, channel-major."""
    pad = (-Xi.shape[1]) % TILE_N
    pts = lambda X: np.swapaxes(np.pad(X, ((0, 0), (0, pad), (0, 0)), constant_values=1.0), 1, 2)
    sq_p = np.pad(sq, ((0, 0), (0, pad)))[:, None, :]
    return np.asarray(edge_hg_rays_pallas(jnp.asarray(Tij), jnp.asarray(pts(Xi)),
                                          jnp.asarray(pts(Xj)), jnp.asarray(sq_p), **SIG))


BLOCK_ERR = 3e-5


def _blocks8(H, g, c):
    """World-frame (H_e, g_e, cost) as the (E, 8, 8) [[H, g], [gᵀ, cost]]."""
    H, g, c = (torch.as_tensor(np.asarray(x)).double() for x in (H, g, c))
    return torch.cat([torch.cat([H, g[:, :, None]], -1),
                      torch.cat([g, c[:, None]], -1)[:, None]], 1)


def _plain64(Tij, Xi, Xj, sq, **kw):
    return edge_hg.edge_hg_rays_plain(*(t(a).double() for a in (Tij, Xi, Xj, sq)), **{**SIG, **kw})


def test_edge_blocks_plain_matches_pallas_kernel():
    Tij, Xi, Xj, sq = _edge_inputs(N=300)  # 300: not a multiple of any tile
    want = _pallas_mloc(Tij, Xi, Xj, sq)
    got = edge_hg.edge_hg_rays(t(Tij), t(Xi), t(Xj), t(sq), **SIG)  # CPU: plain
    assert got.shape == (5, 8, 8) and got.dtype == torch.float32
    assert edge_hg.block_err(got, t(want)) <= BLOCK_ERR
    assert edge_hg.block_err(got, _plain64(Tij, Xi, Xj, sq)) <= BLOCK_ERR
    assert edge_hg.block_err(t(want), _plain64(Tij, Xi, Xj, sq)) <= BLOCK_ERR
    assert edge_hg.block_err(got, got.transpose(1, 2)) <= BLOCK_ERR


def _negate_grad(M):
    M = M.clone()
    M[:, :7, 7] *= -1
    M[:, 7, :7] *= -1
    return M


def _zero_grad(M):
    M = M.clone()
    M[:, :7, 7] = 0
    M[:, 7, :7] = 0
    return M


def _cost_off(M):
    M = M.clone()
    M[:, 7, 7] *= 1.3
    return M


def _scale_row_off(M):
    M = M.clone()
    M[:, 6, :] *= 1.01
    M[:, :, 6] *= 1.01
    return M


@pytest.mark.parametrize("fault", [_negate_grad, _zero_grad, _cost_off, _scale_row_off,
                                   "no_distance_row"])
def test_block_check_fails_planted_faults(fault):
    """Each planted fault breaks the bound many times over, while the same
    check passes the fault-free blocks (a check scaled by the largest entry
    passed all of these)."""
    Tij, Xi, Xj, sq = _edge_inputs(N=300)
    exact = _plain64(Tij, Xi, Xj, sq)
    good = edge_hg.edge_hg_rays(t(Tij), t(Xi), t(Xj), t(sq), **SIG)
    if fault == "no_distance_row":
        bad = edge_hg.edge_hg_rays(t(Tij), t(Xi), t(Xj), t(sq),
                                   **{**SIG, "sigma_dist": float("inf")})
    else:
        bad = fault(good)
    assert edge_hg.block_err(good, exact) <= BLOCK_ERR
    assert edge_hg.block_err(bad, exact) > 100 * BLOCK_ERR


def test_edge_blocks_match_jax_reduce_path():
    """World-frame H_e, g_e and cost against the JAX ``_edge_block_rays``
    (hg_impl "reduce"), edge by edge."""
    Tij, Xi, Xj, sq = _edge_inputs(E=4, N=257, seed=1)
    rng = np.random.default_rng(2)
    Twc = random_sim3(rng, (5,), t_scale=0.5, rot_scale=0.3)
    ii = np.array([0, 1, 2, 4], np.int32)
    jj = np.array([1, 2, 3, 0], np.int32)
    zeros = np.zeros_like(sq)
    js = jgn.GlobalGNSettings(hg_impl="reduce")
    want = [jgn._edge_block_rays(jnp.asarray(Twc), js, tuple(jnp.asarray(a[e]) for a in (
        ii, jj, Xi, Xj, sq, zeros, zeros))) for e in range(4)]
    got = tgn._edge_block_rays(t(Twc), tgn.GlobalGNSettings(), tuple(
        t(a) for a in (ii.astype(np.int64), jj.astype(np.int64), Xi, Xj, sq, zeros, zeros)))
    want8 = _blocks8(*(np.stack([np.asarray(w[k]) for w in want]) for k in range(3)))
    assert edge_hg.block_err(_blocks8(*got), want8) <= BLOCK_ERR


@pytest.mark.parametrize("garbage", [37.0, 0.0])
def test_edge_blocks_ignore_invalid_pixels(garbage):
    """Points under sq = 0 may be anything finite (zeros included): the
    blocks are bitwise the same."""
    Tij, Xi, Xj, sq = _edge_inputs(E=3, N=300, seed=3)
    clean = edge_hg.edge_hg_rays(t(Tij), t(Xi), t(Xj), t(sq), **SIG)
    Xi_g, Xj_g = Xi.copy(), Xj.copy()
    Xi_g[sq == 0] = garbage
    Xj_g[sq == 0] = garbage
    dirty = edge_hg.edge_hg_rays(t(Tij), t(Xi_g), t(Xj_g), t(sq), **SIG)
    assert torch.isfinite(dirty).all()
    assert torch.equal(clean, dirty)


# ---------------------------------------------------------------------------
# the GN solve
# ---------------------------------------------------------------------------

def _problem(mode):
    if mode == "calib":
        K, hw, gt, noisy, Xs, Cs, ii, jj, idx, valid, Q = _calib_problem()
    else:
        gt, noisy, Xs, Cs, ii, jj, idx, valid, Q = _rays_problem(n_kf=5, N=300)
        K, hw = np.eye(3, dtype=np.float32), (1, Xs.shape[1])
    return K, hw, gt, noisy, Xs, Cs, ii, jj, idx, valid, Q


def _cached_inputs(Xs, Cs, ii, idx, n_fused=2.0):
    """The gathered-point cache's rows [X | C_raw] of each edge, forward
    half and backward half (the problems' edges are two-way already)."""
    C_raw = Cs * n_fused
    XsC = np.concatenate([Xs, C_raw], axis=-1)
    gath = np.stack([XsC[a][i] for a, i in zip(ii, idx)]).astype(np.float32)
    half = len(ii) // 2
    return C_raw, np.full((Xs.shape[0],), n_fused, np.float32), gath[:half], gath[half:]


@pytest.mark.parametrize("cached", [False, True], ids=["gather", "cached"])
@pytest.mark.parametrize("solver", ["dense", "pcg", "pcg-diag"])  # diag: scalar Jacobi
@pytest.mark.parametrize("mode", ["rays", "calib", "points"])
def test_gauss_newton_parity(mode, solver, cached):
    solver, _, precond = solver.partition("-")
    settings = dict(edge_batch=4, solver=solver, pcg_precond=precond or "block")
    K, hw, gt, noisy, Xs, Cs, ii, jj, idx, valid, Q = _problem(mode)
    js = jgn.GlobalGNSettings(**settings)
    ts = tgn.GlobalGNSettings(**settings)
    if cached:
        C_raw, nf, gf, gb = _cached_inputs(Xs, Cs, ii, idx)
        args = (noisy, Xs, C_raw, nf, ii, jj, gf, gb, idx, valid, Q, K)
        Tj, itj, okj, divj = jgn.gauss_newton_poses_cached(
            *(jnp.asarray(a) for a in args), hw, js, mode)
        Tt, itt, okt, divt = tgn.gauss_newton_poses_cached(*(t(a) for a in args), hw, ts, mode)
    else:
        args = (noisy, Xs, Cs, ii, jj, idx, valid, Q, K)
        Tj, itj, okj, divj = jgn.gauss_newton_poses(*(jnp.asarray(a) for a in args), hw, js, mode)
        Tt, itt, okt, divt = tgn.gauss_newton_poses(*(t(a) for a in args), hw, ts, mode)
    # (the cost guard may trip once the cost is f32 noise at the solution:
    # its revert keeps the last good iterate, so `diverged` is not compared)
    assert okt and bool(okj)
    assert 1 <= itt <= js.max_iters
    assert_close(Tt, np.asarray(Tj), 0, POSE_ATOL, "poses against JAX")
    err = np.linalg.norm(n(Tt)[:, :3] - gt[:, :3], axis=-1).max()
    assert err < (1e-4 if solver == "dense" else 5e-3), err
    assert_close(Tt[0], noisy[0], 0, 0, "the pinned pose stays")


@pytest.mark.parametrize("impl", ["pallas", "reduce", "dot"])
def test_every_hg_impl_reaches_the_plain_blocks_on_the_cpu(impl):
    K, hw, gt, noisy, Xs, Cs, ii, jj, idx, valid, Q = _problem("rays")
    args = [t(a) for a in (noisy, Xs, Cs, ii, jj, idx, valid, Q, K)]
    want = tgn.gauss_newton_poses(*args, hw, tgn.GlobalGNSettings(edge_batch=4), "rays")[0]
    got = tgn.gauss_newton_poses(*args, hw, tgn.GlobalGNSettings(edge_batch=4, hg_impl=impl),
                                 "rays")[0]
    assert_close(got, want, 0, 1e-6, impl)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_healthy_solve_reports_no_divergence(solver):
    """The fixture of tests/test_solver_health.py: no divergence reported."""
    gt, noisy, Xs, Cs, ii, jj, idx, valid, Q = _rays_problem(n_kf=6, N=400)
    T, _, ok, diverged = tgn.gauss_newton_poses(
        *(t(a) for a in (noisy, Xs, Cs, ii, jj, idx, valid, Q, np.eye(3, dtype=np.float32))),
        (1, 1), tgn.GlobalGNSettings(edge_batch=4, solver=solver), "rays")
    assert ok and not diverged
    assert np.linalg.norm(n(T)[:, :3] - gt[:, :3], axis=-1).max() < 5e-3


def test_guard_reverts_poisoned_step(monkeypatch):
    """A poisoned linear solve returns a large wrong step: the next
    iteration sees the cost rise, reverts to the last good poses (the
    initial ones) and reports ``diverged`` (tests/test_solver_health.py)."""
    gt, noisy, Xs, Cs, ii, jj, idx, valid, Q = _rays_problem(n_kf=6, N=400)

    def poisoned(H_e, g_e, ii_, jj_, num_poses, pin, *a, **kw):
        return torch.full((num_poses - pin, 7), 0.5), torch.tensor(True)

    monkeypatch.setattr(tgn, "_assemble_and_solve_pcg", poisoned)
    T, iters, ok, diverged = tgn.gauss_newton_poses(
        *(t(a) for a in (noisy, Xs, Cs, ii, jj, idx, valid, Q, np.eye(3, dtype=np.float32))),
        (1, 1), tgn.GlobalGNSettings(edge_batch=4, solver="pcg"), "rays")
    assert diverged and iters == 2
    np.testing.assert_array_equal(n(T), noisy)


def _random_blocks(rng, E):
    A = rng.normal(size=(E, 7, 9)).astype(np.float32)
    return (A @ A.transpose(0, 2, 1)).astype(np.float32), rng.normal(size=(E, 7)).astype(np.float32)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_assembly_adds_repeated_edges(solver):
    """Edges repeated in ii/jj add up in the normal equations (a scatter
    that overwrote would drop them), as the JAX package's ``.at[].add``."""
    rng = np.random.default_rng(4)
    ii = np.array([0, 1, 1, 2, 1, 0], np.int32)  # (1, 2) three times
    jj = np.array([1, 2, 2, 3, 2, 3], np.int32)
    H_e, g_e = _random_blocks(rng, len(ii))
    if solver == "dense":
        want = jgn._assemble_and_solve(*(jnp.asarray(a) for a in (H_e, g_e, ii, jj)), 4, 1)
        got = tgn._assemble_and_solve(*(t(a) for a in (H_e, g_e, ii, jj)), 4, 1)
    else:
        kw = dict(iters=96, tol=1e-7)
        want = jgn._assemble_and_solve_pcg(*(jnp.asarray(a) for a in (H_e, g_e, ii, jj)), 4, 1, **kw)
        got = tgn._assemble_and_solve_pcg(*(t(a) for a in (H_e, g_e, ii, jj)), 4, 1, **kw)
    assert bool(got[1]) and bool(want[1])
    dx = np.asarray(want[0])
    assert_close(got[0], dx, 0, 1e-4 * np.abs(dx).max(), "step")
    # and it is not the system with the repeats dropped
    once = tgn._assemble_and_solve(*(t(a) for a in (H_e[:2], g_e[:2], ii[:2], jj[:2])), 4, 1)
    assert np.abs(n(once[0]) - dx).max() > 1e-3 * np.abs(dx).max()


def test_failed_cholesky_gives_a_zero_step():
    """A system that is not positive definite: ok False and dx = 0, as the
    JAX package's NaN from cho_factor gives."""
    rng = np.random.default_rng(5)
    H_e, g_e = _random_blocks(rng, 2)
    H_e = -H_e
    ii, jj = np.array([0, 1], np.int32), np.array([1, 2], np.int32)
    dxj, okj = jgn._assemble_and_solve(*(jnp.asarray(a) for a in (H_e, g_e, ii, jj)), 3, 1)
    dxt, okt = tgn._assemble_and_solve(*(t(a) for a in (H_e, g_e, ii, jj)), 3, 1)
    assert not bool(okj) and not bool(okt)
    assert not n(dxt).any() and not np.asarray(dxj).any()


def test_settings_from_config_equal_jax():
    from mast3r_slam_tpu.config import load_config as jload_config
    from mast3r_slam_tpu_torch.config import load_config

    assert tuple(tgn.GlobalGNSettings.from_config(load_config("base"))) == \
        tuple(jgn.GlobalGNSettings.from_config(jload_config("base")))
