"""The port's solve shapes and its device program's pieces, against the JAX
package (``slam/factor_graph.py`` ``_solve_full`` / ``_solve_windowed``,
``ops/global_gn.py`` ``_gn_core``).

Solve buckets: both packages' factor graphs run the same oracle session
(tests/oracle.py at 48x64: keyframes appended one at a time, the chain and
a loop edge every third keyframe through ``add_factors``, a solve after
each), full and windowed, with and without edge recycling, and with a dense
knee below the padded pose count.  Each package's GN entry is wrapped (on
the module objects only, no file changes) to record the (padded poses,
padded edges, pin, route) of every solve: the sequences are equal.  After
every solve the port's poses agree with the JAX graph's, and the window's
poses with the port's own unpadded solve (every keyframe and stored edge,
the poses before the window pinned), within POSE_ATOL: the same systems in
f32 in other summation orders (padded edges and poses add exact zeros), as
tests/test_torch_global_gn.py states it.

Pieces: ``global_gn._Pieces`` run eagerly in a Python early-exit loop (the
loops of the device program's WHILE nodes, csrc/gn_while.cu) give the bits
and the iteration count of the plain frozen loop (``gn_loop``): equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu.slam import factor_graph as jfg
from mast3r_slam_tpu.slam import frame as jframe
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.ops import global_gn as tgn
from mast3r_slam_tpu_torch.slam import factor_graph as tfg
from mast3r_slam_tpu_torch.slam import frame as tframe

from oracle import OracleModel, PlaneScene, arc_trajectory
from test_torch_common import CPU, TorchOracleModel, assert_close, n, t, time_limit
from test_torch_global_gn import POSE_ATOL, _cached_inputs, _problem

HW = (48, 64)
N = HW[0] * HW[1]


def _route(settings, P):
    """The JAX package's static choice (global_gn.py:642-644)."""
    return "pcg" if settings.solver == "pcg" or (
        settings.solver == "auto" and (P - settings.pin) > settings.dense_max_poses) else "dense"


def _recorder(module, calls, monkeypatch):
    """Wrap a factor graph module's two GN entries to record (Ppad, Epad,
    pin, route) of each call."""
    for name, at in (("gauss_newton_poses", 10), ("gauss_newton_poses_cached", 13)):
        real = getattr(module, name)

        def spy(*a, _real=real, _at=at, **kw):
            settings = a[_at]
            P, E = a[0].shape[0], a[4 if _at == 13 else 3].shape[0]
            calls.append((int(P), int(E), settings.pin, _route(settings, P)))
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, spy)


def _session_graphs(window, recycle, dense_max_poses, n_kf):
    """Empty keyframe stores and graphs of both packages over one oracle
    scene, and the ``n_kf`` frames to append."""
    gt = arc_trajectory(2 * n_kf, radius=0.6, max_angle=2.5)
    scene = PlaneScene(HW)
    oracle = OracleModel(scene, gt, noise=0.002)
    rng = np.random.default_rng(1)
    tau = (rng.normal(size=(n_kf, 7)) * 0.01).astype(np.float32)
    tau[0] = 0
    poses = np.asarray(jsim3.retr(jnp.asarray(gt[::2][:n_kf]), jnp.asarray(tau)))
    jcfg, cfg = jload_config("base"), load_config("base")
    for c in (jcfg, cfg):
        c["local_opt"].update(window_size=window, edge_recycle=recycle)
        if dense_max_poses is not None:
            c["local_opt"]["dense_max_poses"] = dense_max_poses
    jkf = jframe.Keyframes(16, N, oracle.num_patches, oracle.feat_dim)
    tkf = tframe.Keyframes(16, N, oracle.num_patches, oracle.feat_dim, device=CPU)
    frames = []
    for k in range(n_kf):
        fid = 2 * k
        img = jnp.full((1, 3, *HW), (fid + 1) / 255.0 * 2 - 1, jnp.float32)
        feat, pos = oracle.encode(img)
        X, C = oracle.mono(feat, pos)
        X, C = np.asarray(X).reshape(N, 3), np.asarray(C).reshape(N, 1)
        frames.append((
            jframe.Frame(frame_id=fid, img=None, T_WC=jnp.asarray(poses[k]),
                         X_canon=jnp.asarray(X), C=jnp.asarray(C), n_fused=1, n_updates=1,
                         feat=feat, pos=pos),
            tframe.Frame(frame_id=fid, img=None, T_WC=t(poses[k]), X_canon=t(X), C=t(C),
                         n_fused=1, n_updates=1, feat=t(feat), pos=t(pos))))
    jg = jfg.FactorGraph(oracle, jcfg, jkf, HW, edge_capacity=4)
    tg = tfg.FactorGraph(TorchOracleModel(oracle), cfg, tkf, HW, edge_capacity=4)
    return jg, tg, frames


def _unpadded(tg, T0, s0, route):
    """The port's own unpadded solve of the graph from poses T0 on the
    padded solve's route: every keyframe and stored edge both ways, exact
    shapes, the poses before ``s0`` pinned (the windowed solve's problem;
    its old-old edges touch pinned poses only)."""
    kf = tg.keyframes
    n_kf, E = len(kf), tg.n_edges
    rows = torch.arange(E)
    idx, valid, Q = tfg._expand_two_way(*tg._stores(), rows)
    ii = torch.as_tensor(np.concatenate([tg.ii[:E], tg.jj[:E]]))
    jj = torch.as_tensor(np.concatenate([tg.jj[:E], tg.ii[:E]]))
    Cs = kf.C[:n_kf] / torch.clamp_min(kf.n_fused[:n_kf][:, None, None].float(), 1.0)
    return tgn.gauss_newton_poses(T0, kf.X[:n_kf], Cs, ii, jj, idx, valid, Q, tg.K, HW,
                                  tg.settings._replace(pin=s0, solver=route), "rays")


# (window_size, edge_recycle, dense_max_poses, keyframes): the full solve,
# over enough keyframes that its kept edges cross the first edge bucket;
# windowed without and with recycling, over enough that the window leaves
# edges behind; full with a knee below the padded pose count (PCG by the
# padded count, dense by the exact one)
SESSIONS = {"full": (0, False, None, 8), "windowed": (3, False, None, 6),
            "windowed_recycle": (3, True, None, 6), "full_knee": (0, False, 8, 4)}


@pytest.mark.parametrize("case", list(SESSIONS))
def test_solve_shapes_route_and_poses_equal_jax(case, monkeypatch):
    window, recycle, knee, n_frames = SESSIONS[case]
    jg, tg, frames = _session_graphs(window, recycle, knee, n_frames)
    jcalls, tcalls = [], []
    _recorder(jfg, jcalls, monkeypatch)
    _recorder(tfg, tcalls, monkeypatch)
    frac = jg.cfg["local_opt"]["min_match_frac"]
    with time_limit(240):
        for k, (jf, tf) in enumerate(frames):
            jg.keyframes.append(jf)
            tg.keyframes.append(tf)
            if k == 0:
                continue
            pairs = ([k - 1], [k]) if k % 3 else ([k - 1, k - 3], [k, k])
            assert jg.add_factors(*pairs, frac) == tg.add_factors(*pairs, frac)
            n_kf = len(tg.keyframes)
            free = n_kf - tg.settings.pin
            s0 = n_kf - min(window or free, free)
            T0 = tg.keyframes.T_WC[:n_kf].clone()
            jg.solve(mode="rays")
            tg.solve(mode="rays")
            want = _unpadded(tg, T0, s0, tcalls[-1][3])
            assert bool(want[2])
            T = tg.keyframes.T_WC[:n_kf]
            assert_close(T, np.asarray(jg.keyframes.T_WC[:n_kf]), 0, POSE_ATOL,
                         f"poses against JAX after keyframe {k}")
            assert_close(T[s0:], want[0][s0:], 0, POSE_ATOL,
                         f"padded against unpadded after keyframe {k}")
    assert tcalls == jcalls and len(tcalls) == n_frames - 1
    pins = {c[2] for c in tcalls}
    routes = {c[3] for c in tcalls}
    if window:
        assert 8 in pins and tg.n_edges_recycled == jg.n_edges_recycled
        assert (tg.n_edges_recycled > 0) == recycle
    else:
        assert pins == {1}
    assert routes == ({"pcg"} if knee else {"dense"}), tcalls
    assert {c[0] for c in tcalls} == {16}  # the pose bucket's floor
    assert {c[1] for c in tcalls} == ({16, 32} if case == "full" else {16})


# ---------------------------------------------------------------------------
# the program's pieces, run eagerly, against the plain loop
# ---------------------------------------------------------------------------

def _run_pieces(entry, inputs, hw, settings, mode):
    """The device program's loops as Python loops over what it captures
    (``parts()``, joined by ``loops`` as gn_program.Program joins them):
    the GN loop's first test passes, then it runs while its flag holds and
    fewer than its count ran; the CG loop's first test is ``pre``'s."""
    s = tgn._Pieces(entry, inputs, hw, settings, mode)
    (prologue, *body), (outer, inner) = s.parts(), s.loops
    prologue()
    while True:
        if inner is None:
            body[0]()
        else:
            pre, step, post = body
            pre()
            while bool(inner.active) and int(inner.iters) < inner.max_iters:
                step()
                inner.iters.add_(1)
            post()
        outer.iters.add_(1)
        if not (bool(outer.active) and int(outer.iters) < outer.max_iters):
            return s.outputs()


def _inputs(mode, entry):
    K, hw, gt, noisy, Xs, Cs, ii, jj, idx, valid, Q = _problem(mode)
    if entry == "cached":
        C_raw, nf, gf, gb = _cached_inputs(Xs, Cs, ii, idx)
        args = (noisy, Xs, C_raw, nf, ii.astype(np.int64), jj.astype(np.int64), gf, gb, idx,
                valid, Q, K)
    else:
        args = (noisy, Xs, Cs, ii.astype(np.int64), jj.astype(np.int64), idx, valid, Q, K)
    return tuple(t(a) for a in args), hw


# case: (mode, settings, entry, fault)
PIECE_CASES = {
    "dense": ("rays", {}, "poses", None),
    "dense_cached": ("rays", {}, "cached", None),
    "pcg_block": ("rays", dict(solver="pcg"), "cached", None),
    "pcg_diag": ("rays", dict(solver="pcg", pcg_precond="diag"), "poses", None),
    "pcg_few_cg": ("rays", dict(solver="pcg", pcg_iters=2), "poses", None),
    "calib": ("calib", {}, "cached", None),
    "calib_pcg": ("calib", dict(solver="pcg"), "poses", None),
    "points": ("points", {}, "poses", None),
    "points_pcg": ("points", dict(solver="pcg"), "cached", None),
    "guard_reverts": ("rays", {}, "poses", "poison"),
    "guard_reverts_pcg": ("rays", dict(solver="pcg"), "poses", "poison"),
    "failed_cholesky": ("rays", {}, "poses", "negate"),
    "max_iters_1": ("rays", dict(max_iters=1), "cached", None),
}


@pytest.mark.parametrize("case", list(PIECE_CASES))
def test_pieces_in_an_early_exit_loop_give_the_plain_loops_bits(case, monkeypatch):
    mode, kw, entry, fault = PIECE_CASES[case]
    settings = tgn.GlobalGNSettings(edge_batch=4, **kw)
    inputs, hw = _inputs(mode, entry)
    calls = [0]
    if fault == "poison":  # the first GN step is large and wrong
        # the steps' last functions, which both loops look up here
        for name in ("_assemble_and_solve", "_pcg_result"):
            real = getattr(tgn, name)

            def poisoned(*a, _real=real, **k):
                dx, ok = _real(*a, **k)
                calls[0] += 1
                return (dx + 0.5 if calls[0] == 1 else dx), ok

            monkeypatch.setattr(tgn, name, poisoned)
    elif fault == "negate":  # normal equations that are not positive definite
        real_scatter = tgn._scatter_dense
        monkeypatch.setattr(tgn, "_scatter_dense",
                            lambda *a: tuple(-x for x in real_scatter(*a)))
    entry_fn = tgn.gauss_newton_poses_cached if entry == "cached" else tgn.gauss_newton_poses
    want = entry_fn(*inputs, hw, settings, mode)
    calls[0] = 0
    got = _run_pieces(entry, inputs, hw, settings, mode)
    for a, b, name in zip(got, want, ("poses", "iterations", "ok", "diverged")):
        assert torch.equal(a, b), (name, a, b)
    iters = int(got[1])
    if fault == "poison":  # the second iteration saw the cost rise and reverted
        assert (iters, bool(got[3])) == (2, True) and calls[0] == 2
        assert torch.equal(got[0], inputs[0])
    elif fault == "negate":  # the factor failed: a zero step, and the loop stopped
        assert (iters, bool(got[2])) == (1, False)
    else:
        assert 1 <= iters <= settings.max_iters and bool(got[2])
    if case == "max_iters_1":
        assert iters == 1
