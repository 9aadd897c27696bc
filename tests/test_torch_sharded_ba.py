"""Port parity of the edge-sharded global solve (``parallel/sharded_ba.py``,
``parallel/mesh.py``) against the JAX package's on its 8-device CPU mesh,
and against the port's own single-device solve.

The problems are tests/test_sharded_ba.py's: exact correspondences from a
shared world cloud (rays and points: 5 keyframes, 500 points; calib: 5
keyframes sharing one pose at 24x32), 8 two-way chain edges.  The port's
mesh is 1, 2 or 8 CPU shards; the JAX mesh is the 8 virtual CPU devices of
tests/conftest.py, the edges padded to 8 as its test pads them.

Tolerances.  Sharded against single-device (either package): JAX's own
bound, atol 5e-4 and rtol 1e-3 (test_sharded_ba.py:145): the shards' sums
reach the normal equations in another f32 order.  Port against JAX, both
sharded: the same bound.  Padding: bit for bit (zero-weight edges add exact
zeros, and the real edges keep their shards).

Iterations.  The loop stops where the JAX ``while_loop`` stops, so the
port's ``iters`` equal JAX's exactly, and the sharded step runs ``iters``
times.  At the default ``delta_norm`` (1e-8) the last iterations sit at
the f32 noise floor, where the monotone-cost guard trips on rounding that
the summation order decides (8, 10 and 8 iterations at 1, 2 and 8 shards
for rays); the counts are compared at STOP_DELTA, where the step norms
decide: each of the three modes' steps lies at least twice or at most
half that far from it (3 or 4 iterations).  The device program's pieces
(``sharded_ba._ShardedPieces``), run in order on the CPU, give the frozen
plain loop's (``gn_loop``) bits and iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops.global_gn import GlobalGNSettings as JSettings
from mast3r_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from mast3r_slam_tpu.parallel.mesh import replicate as jreplicate
from mast3r_slam_tpu.parallel.mesh import shard_edges as jshard_edges
from mast3r_slam_tpu.parallel.sharded_ba import gauss_newton_poses_sharded as jsharded
from mast3r_slam_tpu_torch.ops import global_gn as tgn
from mast3r_slam_tpu_torch.parallel import sharded_ba as sb
from mast3r_slam_tpu_torch.parallel.mesh import make_mesh, padded_rows, replicate, shard_edges
from mast3r_slam_tpu_torch.parallel.sharded_ba import (gauss_newton_poses_sharded,
                                                        normal_equations_sharded)

from test_sharded_ba import _calib_problem, _rays_problem
from test_torch_common import CPU, assert_close, frozen_sharded, t, time_limit

ATOL, RTOL = 5e-4, 1e-3
BLOCKS_RTOL = 1e-6
MODES = ["rays", "calib", "points"]
SHARDS = [1, 2, 8]
# step norms at the three modes' last iterations: rays 1.1e-3 then 9.5e-5,
# calib 6.0e-4 then 9.9e-5, points 4.8e-3 then 1.5e-4 (every shard count)
STOP_DELTA = 3e-4


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(120):
        yield


def _problem(mode):
    """(noisy poses, Xs, Cs, ii, jj, idx, valid, Q, K, img_hw, gt) as numpy."""
    if mode == "calib":
        K, hw, gt, noisy, Xs, Cs, ii, jj, idx, valid, Q = _calib_problem(n_kf=5)
    else:
        gt, noisy, Xs, Cs, ii, jj, idx, valid, Q = _rays_problem(n_kf=5)
        K, hw = np.eye(3, dtype=np.float32), (1, Xs.shape[1])
    return noisy, Xs, Cs, ii, jj, idx, valid, Q, K, hw, gt


def _port_args(mode, settings):
    noisy, Xs, Cs, ii, jj, idx, valid, Q, K, hw, _ = _problem(mode)
    return (t(noisy), t(Xs), t(Cs), t(ii), t(jj), t(idx), t(valid), t(Q),
            t(K, torch.float32), hw, settings, mode)


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's sharded solve of each mode on its 8-device mesh: the poses, and
    the iterations at STOP_DELTA."""
    assert len(jax.devices()) >= 8, "tests/conftest.py provides 8 CPU devices"
    mesh = jmake_mesh(8)
    out = {}
    for mode in MODES:
        noisy, Xs, Cs, ii, jj, idx, valid, Q, K, hw, _ = _problem(mode)
        pad = padded_rows(make_mesh(devices=[CPU] * 8), len(ii)) - len(ii)
        ii, jj = (np.concatenate([a, np.zeros(pad, np.int32)]) for a in (ii, jj))
        idx, valid, Q = (np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                         for a in (idx, valid, Q))
        Twc0, Xs_d, Cs_d = jreplicate(mesh, jnp.asarray(noisy), jnp.asarray(Xs),
                                      jnp.asarray(Cs))
        edges = jshard_edges(mesh, *(jnp.asarray(a) for a in (ii, jj, idx, valid, Q)))
        Twc, _, ok, _ = jsharded(mesh, Twc0, Xs_d, Cs_d, *edges, jnp.asarray(K), hw,
                                 JSettings(edge_batch=2), mode)
        assert bool(ok)
        _, iters, ok, _ = jsharded(mesh, Twc0, Xs_d, Cs_d, *edges, jnp.asarray(K), hw,
                                   JSettings(edge_batch=2, delta_norm=STOP_DELTA), mode)
        assert bool(ok)
        out[mode] = np.asarray(Twc), int(iters)
    return out


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_matches_jax_sharded(jax_sharded, mode, shards):
    mesh = make_mesh(devices=[CPU] * shards)
    want, want_iters = jax_sharded[mode]
    Twc, iters, ok, _ = gauss_newton_poses_sharded(
        mesh, *_port_args(mode, tgn.GlobalGNSettings(edge_batch=2)))
    assert ok and iters >= 1
    assert_close(Twc, want, RTOL, ATOL, f"{mode}, {shards} shards")
    _, iters, ok, _ = gauss_newton_poses_sharded(
        mesh, *_port_args(mode, tgn.GlobalGNSettings(edge_batch=2, delta_norm=STOP_DELTA)))
    assert ok and int(iters) == want_iters < tgn.GlobalGNSettings().max_iters, (
        int(iters), want_iters)
    gt = _problem(mode)[-1]
    err = np.linalg.norm(Twc.numpy()[:, :3] - gt[:, :3], axis=-1).mean()
    assert err < 1e-4, err  # exact correspondences: the ground truth


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_matches_the_single_device_solve(mode, shards):
    args = _port_args(mode, tgn.GlobalGNSettings(edge_batch=2))
    ref, _, ok_ref, _ = tgn.gauss_newton_poses(*args)
    Twc, _, ok, _ = gauss_newton_poses_sharded(make_mesh(devices=[CPU] * shards), *args)
    assert ok_ref and ok
    assert_close(Twc, ref, RTOL, ATOL, f"{mode}, {shards} shards against one device")


def _counted(monkeypatch, name):
    """Count the calls of ``sharded_ba.<name>`` (a list of one int)."""
    calls = [0]
    real = getattr(sb, name)

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(sb, name, counted)
    return calls


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("mode", MODES)
def test_the_sharded_step_runs_iters_times(monkeypatch, mode, shards):
    """The loop stops where the JAX loop stops: each shard's blocks are
    assembled and the summed system solved once an iteration that ran,
    not max_iters times; the bits are the frozen loop's."""
    settings = tgn.GlobalGNSettings(edge_batch=2, delta_norm=STOP_DELTA)
    mesh = make_mesh(devices=[CPU] * shards)
    args = _port_args(mode, settings)
    want = frozen_sharded(mesh, *args)
    blocks, solves = _counted(monkeypatch, "_local_blocks"), _counted(monkeypatch, "_solve_dense")
    got = gauss_newton_poses_sharded(mesh, *args)
    iters = int(got[1])
    assert 1 <= iters < settings.max_iters and bool(got[2])
    assert (blocks[0], solves[0]) == (shards * iters, iters)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _warm_sharded_pieces(mesh, Twc, Xs, Cs, ii, jj, idx, valid, Q, K, hw, settings, mode):
    """The program's pieces after its warm-up on stand-in blocks."""
    s = sb._ShardedPieces(mesh, (Twc, Xs, Cs, ii.long(), jj.long(), idx, valid, Q, K), hw,
                          settings, mode)
    s.warm_up()
    return s


def _run_sharded_pieces(s):
    """The device program's loop as a Python loop over what it captures
    (``parts()``, joined by ``loops`` as gn_program.Program joins them)."""
    (prologue, body), (outer, inner) = s.parts(), s.loops
    assert inner is None and not s.use_pcg
    prologue()
    while True:
        body()
        outer.iters.add_(1)
        if not (bool(outer.active) and int(outer.iters) < outer.max_iters):
            return s.outputs()


# case: (mode, shards, settings, fault)
SHARDED_PIECE_CASES = {
    **{f"{mode}_{n}": (mode, n, {}, None) for mode in MODES for n in SHARDS},
    "rays_2_stop_delta": ("rays", 2, dict(delta_norm=STOP_DELTA), None),
    "rays_2_pcg_setting": ("rays", 2, dict(solver="pcg"), None),
    "rays_3_padded": ("rays", 3, {}, None),
    "guard_reverts": ("rays", 2, {}, "poison"),
    "failed_cholesky": ("rays", 2, {}, "negate"),
    "max_iters_1": ("calib", 2, dict(max_iters=1), None),
}


@pytest.mark.parametrize("case", list(SHARDED_PIECE_CASES))
def test_sharded_pieces_give_the_frozen_loops_bits(case, monkeypatch):
    """The one-card program's pieces (prologue: every shard's fields; body:
    the shards' systems summed in shard order, the dense solve, the guard),
    run in order on the CPU: the frozen plain loop's poses, iterations, ok
    and diverged bit for bit, and the early-exit route's."""
    mode, shards, kw, fault = SHARDED_PIECE_CASES[case]
    settings = tgn.GlobalGNSettings(edge_batch=2, **kw)
    mesh = make_mesh(devices=[CPU] * shards)
    args = _port_args(mode, settings)
    calls = [0]
    if fault == "poison":  # the first GN step is large and wrong
        real = sb._solve_dense

        def poisoned(*a, **k):
            dx, ok = real(*a, **k)
            calls[0] += 1
            return (dx + 0.5 if calls[0] == 1 else dx), ok

        monkeypatch.setattr(sb, "_solve_dense", poisoned)
    elif fault == "negate":  # normal equations that are not positive definite
        real_scatter = sb._scatter_dense
        monkeypatch.setattr(sb, "_scatter_dense",
                            lambda *a: tuple(-x for x in real_scatter(*a)))
    want = frozen_sharded(mesh, *args)
    pieces = _warm_sharded_pieces(mesh, *args)
    runs = []
    for run in (lambda: _run_sharded_pieces(pieces),
                lambda: gauss_newton_poses_sharded(mesh, *args)):
        calls[0] = 0
        runs.append(run())
    for got in runs:
        for a, b, name in zip(got, want, ("poses", "iterations", "ok", "diverged")):
            assert torch.equal(a, b), (name, a, b)
    iters = int(want[1])
    if fault == "poison":  # the second iteration saw the cost rise and reverted
        assert (iters, bool(want[3])) == (2, True)
        assert torch.equal(want[0], args[0])
    elif fault == "negate":  # the factor failed: a zero step, and the loop stopped
        assert (iters, bool(want[2])) == (1, False)
    else:
        assert 1 <= iters <= settings.max_iters and bool(want[2])
    if case == "max_iters_1":
        assert iters == 1


def _one_device_equations(Twc, Xs, Cs, ii, jj, idx, valid, Q, K, hw, settings, mode):
    """The normal equations of every edge at once on one device."""
    ii, jj = ii.long(), jj.long()
    edge = (ii, jj) + tuple(tgn.precompute_edge_data(Xs, Cs, ii, jj, idx, valid, Q,
                                                     settings, mode, hw))
    H_e, g_e, c_e = tgn.edge_blocks(Twc, edge, K, hw, settings, mode)
    M = Twc.shape[0] - settings.pin
    io, jo = tgn._slots(ii, jj, settings.pin, M)
    return tgn._scatter_dense(H_e, g_e, io, jo, M) + (c_e.sum(),)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("mode", MODES)
def test_reduced_equations_equal_one_device(mode, shards):
    """The shards' summed (H, g, cost) against one device's scatter of every
    edge, each to BLOCKS_RTOL of its norm.  The poses cannot show a wrong
    sum here: either direction of the exact chain pins every pose alone, so
    a reduction that dropped or doubled a shard would still converge."""
    args = _port_args(mode, tgn.GlobalGNSettings(edge_batch=2))
    want = _one_device_equations(*args)
    got = normal_equations_sharded(make_mesh(devices=[CPU] * shards), *args)
    for name, a, b in zip(("H", "g", "cost"), got, want):
        rel = float((a - b).norm() / b.norm())
        assert rel <= BLOCKS_RTOL, (name, mode, shards, rel)


def _interleave_padding(mesh, arrays, extra):
    """The edges laid out so that each shard holds the edges it holds
    unpadded, followed by ``extra`` more zero-weight edges."""
    E = arrays[0].shape[0]
    per = padded_rows(mesh, E) // mesh.size
    out = []
    for a in arrays:
        parts = []
        for s in range(mesh.size):
            real = a[s * per:(s + 1) * per]
            parts += [real, a.new_zeros((per + extra - real.shape[0],) + a.shape[1:])]
        out.append(torch.cat(parts))
    return out


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_padding_changes_no_bit(shards):
    """Zero-weight rows (valid False, Q 0, ii = jj = 0) add exact zeros: the
    same solve with two more of them in every shard gives the same bits;
    and the single-device solve with zero edges appended, the same bits."""
    mesh = make_mesh(devices=[CPU] * shards)
    args = list(_port_args("rays", tgn.GlobalGNSettings(edge_batch=2)))
    want = gauss_newton_poses_sharded(mesh, *args)
    padded = list(args)
    padded[3:8] = _interleave_padding(mesh, args[3:8], 2)
    assert padded[3].shape[0] == mesh.size * (padded_rows(mesh, 8) // mesh.size + 2)
    got = gauss_newton_poses_sharded(mesh, *padded)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    one = tgn.gauss_newton_poses(*args)
    tail = [torch.cat([a, a.new_zeros((5,) + a.shape[1:])]) for a in args[3:8]]
    one_padded = tgn.gauss_newton_poses(*args[:3], *tail, *args[8:])
    assert torch.equal(one_padded[0], one[0])


@pytest.mark.parametrize("solver,dense_max", [("pcg", 1024), ("auto", 1)])
def test_pcg_stays_dense_under_a_mesh(monkeypatch, solver, dense_max):
    """As in the JAX package, the sharded route is the dense solve whatever
    the solver setting and the graph's size: PCG is never entered and the
    poses are the dense-setting run's bits."""
    mesh = make_mesh(devices=[CPU] * 2)
    dense = gauss_newton_poses_sharded(
        mesh, *_port_args("rays", tgn.GlobalGNSettings(edge_batch=2, solver="dense")))

    def refuse(*a, **k):
        raise AssertionError("PCG entered under a mesh")

    monkeypatch.setattr(tgn, "_assemble_and_solve_pcg", refuse)
    got = gauss_newton_poses_sharded(mesh, *_port_args("rays", tgn.GlobalGNSettings(
        edge_batch=2, solver=solver, dense_max_poses=dense_max)))
    assert torch.equal(got[0], dense[0])


def test_shard_edges_and_replicate():
    """Padding to a multiple of the mesh size (at least one row a shard),
    contiguous slices in shard order, replicas shared on one device."""
    mesh = make_mesh(devices=[CPU] * 4)
    assert [padded_rows(mesh, n) for n in (0, 1, 4, 5, 9)] == [4, 4, 4, 8, 12]
    a = torch.arange(5, dtype=torch.float32) + 1
    v = torch.ones(5, dtype=torch.bool)
    (sa, sv) = shard_edges(mesh, a, v)
    assert [x.tolist() for x in sa] == [[1, 2], [3, 4], [5, 0], [0, 0]]
    assert [x.tolist() for x in sv] == [[True, True], [True, True], [True, False],
                                         [False, False]]
    (r,) = replicate(mesh, a)
    assert len(r) == 4 and all(x is r[0] for x in r)
    with pytest.raises(ValueError, match="leading axes"):
        shard_edges(mesh, a, v[:3])
