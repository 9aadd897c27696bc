"""Port parity of the factor graph (``slam/factor_graph.py``): symmetric
inference, two-way matching, the edge gate and store, and the global solve
with its gathered-point cache, against the JAX ``FactorGraph`` on the same
oracle keyframes (tests/oracle.py, 48x64, pointmap noise 2 mm, keyframe
poses perturbed from the ground truth).

Tolerances.  Edges and the gate are decisions: equal.  Match indices are
equal on every valid pixel (the pixels the solve weighs); on the few
pixels whose LM does not converge, the two matchers' f32 solutions may
floor to different pixels, within the matcher's bound of 0.1% of pixels
(tests/test_torch_matching.py).  Validity flags are equal; Q agrees to
1e-6 relative.  Solved poses: the same systems solved in f32 in another
summation order, 2e-5 absolute.
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
from test_torch_common import CPU, TorchOracleModel, assert_close, n, t

HW = (48, 64)
N = HW[0] * HW[1]
N_KF = 5
MAX_MISMATCH = 1e-3
POSE_ATOL = 2e-5
PAIRS = ([0, 1, 2, 3, 0, 1], [1, 2, 3, 4, 2, 4])  # chain + two loop candidates


def _setup(config: str, n_kf: int = N_KF, seed: int = 0):
    """The same keyframes in a JAX store and a port store, and a graph on
    each.  Keyframe k is oracle frame 2k of an arc; poses after the first
    carry a perturbation for the solve to remove."""
    gt = arc_trajectory(2 * n_kf, radius=0.6, max_angle=2.5)
    scene = PlaneScene(HW)
    oracle = OracleModel(scene, gt, noise=0.002)
    rng = np.random.default_rng(seed)
    tau = (rng.normal(size=(n_kf, 7)) * 0.01).astype(np.float32)
    tau[0] = 0
    poses = np.asarray(jsim3.retr(jnp.asarray(gt[::2][:n_kf]), jnp.asarray(tau)))
    jcfg, cfg = jload_config(config), load_config(config)
    K = scene.K if jcfg["use_calib"] else None

    jkf = jframe.Keyframes(8, N, oracle.num_patches, oracle.feat_dim)
    tkf = tframe.Keyframes(8, N, oracle.num_patches, oracle.feat_dim, device=CPU)
    for k in range(n_kf):
        fid = 2 * k
        img = jnp.full((1, 3, *HW), (fid + 1) / 255.0 * 2 - 1, jnp.float32)
        feat, pos = oracle.encode(img)
        X, C = oracle.mono(feat, pos)
        X, C = np.asarray(X).reshape(N, 3), np.asarray(C).reshape(N, 1)
        jkf.append(jframe.Frame(frame_id=fid, img=None, T_WC=jnp.asarray(poses[k]),
                                X_canon=jnp.asarray(X), C=jnp.asarray(C), n_fused=1,
                                n_updates=1, feat=feat, pos=pos))
        tkf.append(tframe.Frame(frame_id=fid, img=None, T_WC=t(poses[k]), X_canon=t(X),
                                C=t(C), n_fused=1, n_updates=1, feat=t(feat), pos=t(pos)))
    jg = jfg.FactorGraph(oracle, jcfg, jkf, HW,
                         K=None if K is None else jnp.asarray(K), edge_capacity=4)
    tg = tfg.FactorGraph(TorchOracleModel(oracle), cfg, tkf, HW,
                         K=None if K is None else t(K, torch.float32), edge_capacity=4)
    return jg, tg, gt[::2][:n_kf], poses


@pytest.fixture(scope="module", params=["base", "eval_calib"])
def graphs(request):
    jg, tg, gt, poses = _setup(request.param)
    frac = jg.cfg["local_opt"]["min_match_frac"]
    added = (jg.add_factors(*PAIRS, frac), tg.add_factors(*PAIRS, frac))
    jg.solve()
    tg.solve()
    return jg, tg, gt, poses, added


def test_same_edges_are_kept(graphs):
    jg, tg, _, _, added = graphs
    assert added == (True, True)
    E = jg.n_edges
    assert tg.n_edges == E >= 4  # the chain is always kept
    np.testing.assert_array_equal(tg.ii[:E], jg.ii[:E])
    np.testing.assert_array_equal(tg.jj[:E], jg.jj[:E])
    assert tg.capacity >= E > 4  # the store grew past its first 4 rows


def test_match_fields_equal(graphs):
    jg, tg, _, _, _ = graphs
    E = jg.n_edges
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


def test_solved_poses_agree(graphs):
    jg, tg, gt, poses, _ = graphs
    got = n(tg.keyframes.T_WC[:N_KF])
    assert_close(got, np.asarray(jg.keyframes.T_WC[:N_KF]), 0, POSE_ATOL, "poses")
    assert_close(got[0], poses[0], 0, 0, "the pinned pose stays")
    # the solve moved the perturbed poses toward the ground truth
    before = np.linalg.norm(poses[1:, :3] - gt[1:, :3], axis=-1).mean()
    after = np.linalg.norm(got[1:, :3] - gt[1:, :3], axis=-1).mean()
    assert after < before, (before, after)


def test_gate_rules_equal_jax():
    """Consecutive edges are always kept; a non-consecutive one must pass
    the fraction; with ``strict`` one failure rejects the whole batch."""
    jg, tg, _, _ = _setup("base", n_kf=4)
    for g in (jg, tg):
        assert g.add_factors([0, 0], [1, 3], 1.1)       # (0, 1) kept alone
        assert not g.add_factors([1, 0], [3, 2], 1.1)   # nothing passes 1.1
        assert g.add_factors([1, 2], [2, 3], 0.0, strict=True)
        assert not g.add_factors([0, 1], [1, 3], 1.1, strict=True)
    assert tg.n_edges == jg.n_edges == 3
    np.testing.assert_array_equal(tg.ii[:3], jg.ii[:3])
    np.testing.assert_array_equal(tg.jj[:3], jg.jj[:3])


def test_reloc_edges_are_strict_unless_told():
    """``is_reloc`` makes ``strict`` the default; ``strict=False`` keeps the
    edges that pass.  The new keyframe is ii, so no reloc edge counts as
    consecutive, even one to the keyframe just before it."""
    jg, tg, _, _ = _setup("base", n_kf=4)
    for g in (jg, tg):
        assert not g.add_factors([3, 3], [0, 2], 0.2, is_reloc=True)
        assert g.add_factors([3, 3], [0, 2], 0.2, is_reloc=True, strict=False)
        assert not g.add_factors([3], [2], 1.1, is_reloc=True, strict=False)
    assert tg.n_edges == jg.n_edges >= 1
    E = tg.n_edges
    np.testing.assert_array_equal(tg.ii[:E], jg.ii[:E])
    np.testing.assert_array_equal(tg.jj[:E], jg.jj[:E])


def test_popped_slot_is_regathered():
    """A keyframe popped after a failed relocalisation leaves its slot's
    ``pm_version`` moving, so the keyframe appended into that slot next is
    re-gathered by the cache: solves through the cache and without it keep
    giving the same poses."""
    _, tc, _, _ = _setup("base", n_kf=4)
    _, tu, _, _ = _setup("base", n_kf=4)
    tu._gcache_on = False
    kf = tc.keyframes
    a, b = kf.get_frame(2), kf.get_frame(1)  # stand-ins for two new keyframes
    assert a.frame_id == 4 and a.n_fused == 1 and torch.equal(a.X_canon, kf.X[2])
    for g in (tc, tu):
        g.keyframes.append(a)
        g.add_factors([3, 4], [4, 0], 0.0)
        g.solve()
    v = kf.pm_version[4]
    for g in (tc, tu):
        g.keyframes.pop_last()
        assert len(g.keyframes) == 4 and g.keyframes.frame_id[4] == -1
        g.keyframes.append(b)  # into the popped slot
        g.keyframes.update_pose(4, g.keyframes.T_WC[1])
        g.solve()
    assert kf.pm_version[4] > v and kf.frame_id[4] == 2
    assert (tc._stamp_f[:tc.n_edges] == kf.pm_version[tc.ii[:tc.n_edges]]).all()
    assert_close(tc.keyframes.T_WC, tu.keyframes.T_WC, 0, 1e-6, "after the pop")


def test_gather_cache_matches_the_gather_in_solve():
    """Solves through the cache and without it give the same poses, also
    after a keyframe's pointmap changed (its version moved) between solves."""
    _, tc, _, _ = _setup("base")
    _, tu, _, _ = _setup("base")
    tu._gcache_on = False
    for g in (tc, tu):
        g.add_factors(*PAIRS, 0.1)
        g.solve()
    assert tc._gf is not None and (tc._stamp_f[:tc.n_edges] >= 0).all()
    assert_close(tc.keyframes.T_WC, tu.keyframes.T_WC, 0, 1e-6, "first solve")
    X2 = tc.keyframes.X[2] + 0.01
    for g in (tc, tu):
        g.keyframes.update_pointmap(2, X2, g.keyframes.C[2] * 2, 2, 2, 0.0)
        g.solve()
    assert (tc._stamp_f[:tc.n_edges] == tc.keyframes.pm_version[tc.ii[:tc.n_edges]]).all()
    assert_close(tc.keyframes.T_WC, tu.keyframes.T_WC, 0, 1e-6, "after the refresh")


def test_health_guard_demotes_the_next_solve_to_dense(monkeypatch):
    """A PCG-routed solve whose step raised the cost is reverted and
    recorded; the next solve runs on the dense route."""
    _, tg, gt, poses = _setup("base")
    tg.add_factors(*PAIRS, 0.1)
    tg.settings = tg.settings._replace(solver="pcg")
    real = tgn._assemble_and_solve_pcg
    monkeypatch.setattr(tgn, "_assemble_and_solve_pcg", lambda H_e, g_e, ii, jj, P, pin, *a, **k: (
        torch.full((P - pin, 7), 0.5), torch.tensor(True)))
    T0 = tg.keyframes.T_WC.clone()
    tg.solve()
    # the flag stays on the device until the next solve reads it
    assert isinstance(tg._health_pending, torch.Tensor) and bool(tg._health_pending)
    assert_close(tg.keyframes.T_WC, T0, 0, 0, "the poisoned step was reverted")
    monkeypatch.setattr(tgn, "_assemble_and_solve_pcg", real)
    routes = []
    orig = tgn.gauss_newton_poses_cached

    def spy(*a, **kw):
        routes.append(a[13].solver)
        return orig(*a, **kw)

    monkeypatch.setattr(tfg, "gauss_newton_poses_cached", spy)
    tg.solve()
    assert routes == ["dense"] and tg.n_recoveries == 1 and tg.settings.solver == "pcg"
    err = np.linalg.norm(n(tg.keyframes.T_WC[1:N_KF, :3]) - gt[1:, :3], axis=-1).mean()
    assert err < np.linalg.norm(poses[1:, :3] - gt[1:, :3], axis=-1).mean()


def test_mesh_builds_and_solves_as_one_device():
    """A graph over three CPU shards (ported mesh): the decode batch padded
    and decoded shard by shard stores the same edges bit for bit (the
    oracle decodes pair by pair and each image matches on its own), the
    gathered-point cache is off, and the edge-sharded solve lands within
    the JAX sharded test's bound (atol 5e-4, rtol 1e-3) of the one-device
    graph's (another f32 summation order)."""
    from mast3r_slam_tpu_torch.parallel.mesh import make_mesh

    _, tg, _, _ = _setup("base")
    _, tg1, _, _ = _setup("base")
    mesh = make_mesh(devices=[CPU] * 3)
    tm = tfg.FactorGraph(tg1.model, tg1.cfg, tg1.keyframes, HW, K=tg1.K, edge_capacity=4,
                         mesh=mesh)
    assert tm.mesh.size == 3 and not tm._cache_usable(1)
    frac = tg.cfg["local_opt"]["min_match_frac"]
    assert tg.add_factors(*PAIRS, frac) == tm.add_factors(*PAIRS, frac)
    E = tg.n_edges
    assert tm.n_edges == E
    np.testing.assert_array_equal(tm.ii[:E], tg.ii[:E])
    np.testing.assert_array_equal(tm.jj[:E], tg.jj[:E])
    for a, b in zip(tm._stores(), tg._stores()):
        assert torch.equal(a[:E], b[:E])
    tg.solve()
    tm.solve()
    assert_close(tm.keyframes.T_WC[:N_KF], tg.keyframes.T_WC[:N_KF], 1e-3, 5e-4,
                 "sharded against one-device solve")
