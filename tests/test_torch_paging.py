"""Port parity of keyframe paging (``engine.device_keyframes``): the store's
eviction order, slots and rows against the JAX store, the paged engine
against the JAX paged engine, and the faults the port does not carry over
from the JAX package.

Tolerances.  Slots, the resident set, evictions, keyframes and edge
bookkeeping are decisions: equal.  A keyframe's rows, resident or evicted,
are copies: equal bits.  Engine poses: the JAX-vs-port bound of
tests/test_torch_slam_e2e.py, 2e-4, on the raw poses.  The engine runs 14
frames of a slow arc with a keyframe forced every second frame (the
cadence of tests/test_paging.py's soak), 7 keyframes in a 4-slot pool.
Paging is a memory policy: the port's paged run equals its unpaged run at
the same window bit for bit.

The JAX tracker multiplies a keyframe's quaternion norm error into every
frame it tracks, so at this cadence the error grows about fivefold a
keyframe, from one rounding (ROADMAP Queue 3 item 9).  The port's tracker
normalises the composed pose.  So the port is held to the JAX run with
that one composition normalised as well (raw poses), and to the JAX run as
it is on the translations, which the drift does not move here.
"""

import contextlib
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu.retrieval.head import init_head_params as jinit_head_params
from mast3r_slam_tpu.slam import frame as jframe
from mast3r_slam_tpu.slam import tracker as jtracker
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.models.convert import retrieval_from_jax
from mast3r_slam_tpu_torch.retrieval import (ASMKSettings, RetrievalDatabase,
                                             RetrievalHeadSettings)
from mast3r_slam_tpu_torch.slam import factor_graph as tfg
from mast3r_slam_tpu_torch.slam import frame as tframe
from mast3r_slam_tpu_torch.slam.pipeline import SLAM

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_growth import _frame as _jax_frame
from test_torch_common import CPU, TorchOracleModel, assert_close, n, t
from test_torch_windowing import _frame as _id_frame
from test_torch_windowing import _store_identity
from test_windowing import _make_problem

HW = (48, 64)
POSE_ATOL = 2e-4


def _port_frame(i):
    """tests/test_growth.py's frame i, as the port's Frame."""
    f = _jax_frame(i)
    return tframe.Frame(frame_id=i, img=None, T_WC=t(f.T_WC), X_canon=t(f.X_canon),
                        C=t(f.C), n_fused=1, n_updates=1, feat=t(f.feat), pos=t(f.pos))


def _stores(capacity=16, budget=4, keep_recent=2):
    j = jframe.Keyframes(capacity=capacity, num_pixels=12, num_patches=3, feat_dim=4,
                         device_budget=budget, keep_recent=keep_recent)
    p = tframe.Keyframes(capacity, 12, 3, 4, device=CPU, device_budget=budget,
                         keep_recent=keep_recent)
    return j, p


def _assert_same_store(j, p):
    assert p.n == j.n and p.dcap == j.dcap and p.n_evictions == j.n_evictions
    np.testing.assert_array_equal(p.slot_of[:p.n], j.slot_of[:j.n])
    np.testing.assert_array_equal(p._slot_owner, j._slot_owner)
    assert p._free_slots == j._free_slots
    assert [p.is_resident(i) for i in range(p.n)] == [j.is_resident(i) for i in range(j.n)]
    for i in range(p.n):
        for got, want in zip(p.pointmap_np(i) + p.feat_np(i),
                             j.pointmap_np(i) + j.feat_np(i)):
            np.testing.assert_array_equal(got, np.asarray(want))
    assert p.device_bytes() == j.device_bytes()


def test_store_eviction_order_slots_and_rows_equal_jax():
    """tests/test_paging.py's store walk on both stores: 10 keyframes into
    4 slots, an evicted one brought back, a sticky one kept."""
    j, p = _stores()
    for i in range(10):
        j.append(_jax_frame(i))
        p.append(_port_frame(i))
        _assert_same_store(j, p)
    assert p.X.shape[0] == 4 and p.n_evictions >= 6
    assert p.is_resident(8) and p.is_resident(9) and not p.is_resident(0)
    for s in (j, p):
        s.ensure_resident([0])
    _assert_same_store(j, p)
    snap = p.snapshot()
    np.testing.assert_array_equal(n(snap.X[snap.slots([0])[0]]),
                                  np.asarray(_jax_frame(0).X_canon))
    for s in (j, p):
        s.sticky = {0}
    for i in range(10, 14):
        j.append(_jax_frame(i))
        p.append(_port_frame(i))
    _assert_same_store(j, p)
    assert p.is_resident(0)
    # a popped keyframe frees its slot and leaves the sticky set
    for s in (j, p):
        s.pop_last()
    _assert_same_store(j, p)
    assert 13 not in p.sticky and p.slot_of[13] == -1


def test_snapshot_keeps_its_tokens_when_a_slot_is_reused():
    """A snapshot's tokens stay those of the keyframes it saw after an
    eviction hands their slot to another keyframe (the store writes in
    place; a snapshot holding the pool by reference would read the new
    keyframe's tokens)."""
    _, p = _stores()
    for i in range(4):
        p.append(_port_frame(i))
    snap = p.snapshot()
    slot0 = int(snap.slots([0])[0])
    p.append(_port_frame(4))  # the pool is full: keyframe 0 is evicted
    assert not p.is_resident(0) and int(p.slot_of[4]) == slot0
    np.testing.assert_array_equal(n(p.feat[slot0]), np.full((3, 4), 4.0))
    np.testing.assert_array_equal(n(snap.feat[slot0]), np.full((3, 4), 0.0))
    np.testing.assert_array_equal(n(snap.X[slot0]), np.asarray(_jax_frame(0).X_canon))


def test_an_evicted_slot_raises_instead_of_wrapping():
    """Slot -1 of an evicted keyframe never indexes the pool's last slot."""
    _, p = _stores()
    for i in range(6):
        p.append(_port_frame(i))
    snap = p.snapshot()
    assert snap.slot_of[0] == -1
    with pytest.raises(RuntimeError, match=r"keyframes \[0\] are not resident"):
        snap.slots([0, 5])
    with pytest.raises(RuntimeError, match="evicted"):
        p.slices(0)


def test_the_paged_pool_never_grows_past_capacity():
    """With nothing evictable the pool grows, to at most ``capacity`` slots
    (the JAX package's cap expression is a no-op and doubles past it)."""
    p = tframe.Keyframes(8, 12, 3, 4, device=CPU, device_budget=6, keep_recent=64)
    for i in range(7):
        p.append(_port_frame(i))
    assert p.capacity == 8 and p.dcap == 8 and p.X.shape[0] == 8 and p.feat.shape[0] == 8
    assert all(p.is_resident(i) for i in range(7)) and p.n_evictions == 0


def _oracle_graph(budget, n_kf=6):
    """Oracle keyframes 2k of an arc in a store paged to ``budget`` slots (0:
    unpaged) and a graph over it."""
    gt = arc_trajectory(2 * n_kf, radius=0.6, max_angle=2.5)
    oracle = OracleModel(PlaneScene(HW), gt, noise=0.002)
    N = HW[0] * HW[1]
    kf = tframe.Keyframes(8, N, oracle.num_patches, oracle.feat_dim, device=CPU,
                          device_budget=budget, keep_recent=2)
    for k in range(n_kf):
        img = jnp.full((1, 3, *HW), (2 * k + 1) / 255.0 * 2 - 1, jnp.float32)
        feat, pos = oracle.encode(img)
        X, C = oracle.mono(feat, pos)
        kf.append(tframe.Frame(frame_id=2 * k, img=None, T_WC=t(gt[2 * k]),
                               X_canon=t(np.asarray(X).reshape(N, 3)),
                               C=t(np.asarray(C).reshape(N, 1)), n_fused=1, n_updates=1,
                               feat=t(feat), pos=t(pos)))
    return kf, tfg.FactorGraph(TorchOracleModel(oracle), load_config("base"), kf, HW,
                               edge_capacity=4)


def test_add_factors_holds_the_store_between_upload_and_snapshot():
    """A loop-closure candidate brought back by ``ensure_resident`` cannot be
    evicted again before the snapshot: the frontend's append waits for the
    store's lock, and the edge equals the unpaged graph's.  (The JAX package
    releases the lock in between, so the append evicts the candidate and its
    slot -1 wraps to the last slot.)"""
    kf, g = _oracle_graph(budget=4)
    _, ref = _oracle_graph(budget=0)
    assert not kf.is_resident(0)
    N = HW[0] * HW[1]
    f5 = kf.get_frame(5)
    late = tframe.Frame(frame_id=99, img=None, T_WC=f5.T_WC, X_canon=torch.zeros(N, 3),
                        C=torch.ones(N, 1), n_fused=1, n_updates=1, feat=f5.feat, pos=f5.pos)
    upload = kf.ensure_resident
    seen = {}

    def racing_upload(idxs):
        upload(idxs)
        worker = threading.Thread(target=kf.append, args=(late,))
        worker.start()
        worker.join(timeout=0.5)
        seen["blocked"] = worker.is_alive()
        seen["worker"] = worker

    kf.ensure_resident = racing_upload
    assert g.add_factors([0], [5], 0.0)
    seen["worker"].join()
    assert seen["blocked"], "the append ran between the upload and the snapshot"
    assert len(kf) == 7 and not kf.is_resident(0)  # evicted once the edge was computed
    assert ref.add_factors([0], [5], 0.0)
    for name in ("idx_ii2jj", "idx_jj2ii", "valid_match_j", "valid_match_i", "Q_ii2jj",
                 "Q_jj2ii"):
        assert torch.equal(getattr(g, name)[0], getattr(ref, name)[0]), name


def test_recovery_solve_stays_within_the_resident_window():
    """After a diverged PCG solve the dense recovery solve takes the window
    clamped to ``keep_recent`` (2 here), not ``dense_max_poses`` (6): it
    reads no evicted keyframe and leaves the older poses alone."""
    M, N = 8, 32
    gt, noisy, Xs, _ = _make_problem(M, N, perturb_from=M - 2, seed=13)
    cfg = load_config("base")
    cfg["local_opt"].update(Q_conf=-1.0, C_conf=-1.0, solver="pcg", dense_max_poses=6)
    kf = tframe.Keyframes(M, N, 1, 2, device=CPU, device_budget=4, keep_recent=2)
    for i in range(M):
        kf.append(_id_frame(i, noisy[i], Xs[i], N))
    g = tfg.FactorGraph(None, cfg, kf, img_hw=(1, N), edge_capacity=16)
    _store_identity(g, [(i, i + 1) for i in range(M - 1)], N)
    assert g._effective_window() == 2 and not kf.is_resident(0)
    g._health_pending = torch.tensor(True)  # a diverged PCG solve's flag, on the device
    before = n(kf.T_WC[:M]).copy()
    g.solve(mode="rays")
    after = n(kf.T_WC[:M])
    assert g.n_recoveries == 1 and g.settings.solver == "pcg"
    np.testing.assert_array_equal(after[:M - 2], before[:M - 2])
    err = np.linalg.norm(after[M - 2:, :3] - gt[M - 2:, :3], axis=-1)
    init = np.linalg.norm(noisy[M - 2:, :3] - gt[M - 2:, :3], axis=-1)
    assert err.max() < 0.05 * init.max()


def test_a_solve_of_every_free_pose_brings_back_its_evicted_context():
    """Three slots, keep_recent 2: the fourth keyframe evicts keyframe 0, and
    a relocalisation that fails pops the fourth again.  The solve then
    frees the two newest poses, every free pose, and reads keyframe 0 as
    pinned context: it brings it back and gives the unpaged store's poses
    bit for bit."""
    M, N = 4, 32
    _, noisy, Xs, _ = _make_problem(M, N, perturb_from=1, seed=13)
    cfg = load_config("base")
    cfg["local_opt"].update(Q_conf=-1.0, C_conf=-1.0)
    poses = []
    for budget in (3, 0):
        kf = tframe.Keyframes(M, N, 1, 2, device=CPU, device_budget=budget, keep_recent=2)
        for i in range(M):
            kf.append(_id_frame(i, noisy[i], Xs[i], N))
        kf.pop_last()
        g = tfg.FactorGraph(None, cfg, kf, img_hw=(1, N), edge_capacity=4)
        _store_identity(g, [(0, 1), (1, 2), (0, 2)], N)
        if budget:
            assert g._effective_window() == len(kf) - 1 and not kf.is_resident(0)
        g.solve(mode="rays")
        assert all(kf.is_resident(i) for i in range(M - 1))
        poses.append(n(kf.T_WC[:M - 1]).copy())
    np.testing.assert_array_equal(poses[0], poses[1])
    np.testing.assert_array_equal(poses[0][0], noisy[0])
    assert not np.array_equal(poses[0][1:], noisy[1:M - 1])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

N_FRAMES = 14


def _engine_cfg(load, budget, window=None):
    cfg = load("base")
    cfg["single_thread"] = True
    cfg["engine"]["keyframe_buffer"] = 4
    cfg["engine"]["edge_buffer"] = 8
    cfg["engine"]["device_keyframes"] = budget
    if window:
        cfg["local_opt"]["window_size"] = window
    return cfg


def _force_keyframes(slam, every=2, until_reloc=False):
    """A keyframe every ``every`` tracked frames (tests/test_paging.py's soak);
    ``until_reloc``: only until the first relocalisation."""
    count = {"i": 0}
    finish = slam.tracker.track_finish

    def dense(pending):
        new_kf, try_reloc = finish(pending)
        if try_reloc or (until_reloc and slam.n_reloc):
            return new_kf, try_reloc
        count["i"] += 1
        if count["i"] % every == 0 and not new_kf:
            slam.tracker.reset_idx_f2k()
            return True, False
        return new_kf, try_reloc

    slam.tracker.track_finish = dense


@contextlib.contextmanager
def _jax_tracker_unit_quaternion():
    """The JAX tracker with its composed frame pose normalised, as the port's
    tracker does.  Only the tracker module's ``sim3`` is swapped, for the
    block; the jit caches are cleared on entry and exit, so no trace of
    either form outlives it."""
    unit = types.SimpleNamespace(**vars(jsim3))
    unit.mul = lambda Ta, Tb: jsim3.normalize(jsim3.mul(Ta, Tb))
    jax.clear_caches()
    jtracker.sim3 = unit
    try:
        yield
    finally:
        jtracker.sim3 = jsim3
        jax.clear_caches()


@pytest.fixture(scope="module")
def engines():
    gt = arc_trajectory(N_FRAMES, radius=0.6, max_angle=0.5)
    oracle = OracleModel(PlaneScene(HW), gt, noise=0.002)
    jax_slam = lambda c: JSLAM(oracle, c, HW)
    port_slam = lambda c: SLAM(TorchOracleModel(oracle), c, HW, device=CPU)
    out = {}
    for name, make, cfg, scope in (
            ("jax", jax_slam, _engine_cfg(jload_config, 4), _jax_tracker_unit_quaternion),
            ("jax_as_is", jax_slam, _engine_cfg(jload_config, 4), contextlib.nullcontext),
            ("port", port_slam, _engine_cfg(load_config, 4), contextlib.nullcontext),
            # the control: unpaged, at the paged run's effective window
            ("control", port_slam, _engine_cfg(load_config, 0, window=2),
             contextlib.nullcontext)):
        with scope():
            slam = make(cfg)
            _force_keyframes(slam)
            out[name] = (slam, slam.run(OracleDataset(N_FRAMES, HW), verbose=False))
    return out


def test_paged_engine_keyframes_and_paging_equal_jax(engines):
    (js, jr), (ts, tr) = engines["jax"], engines["port"]
    assert tr.n_keyframes == jr.n_keyframes == 7
    assert tr.keyframe_timestamps == jr.keyframe_timestamps
    assert tr.n_reloc == jr.n_reloc == 0
    kf, jkf = ts.keyframes, js.keyframes
    assert kf.paging and kf.dcap == 4 and kf.keep_recent == jkf.keep_recent == 2
    assert kf.n_evictions == jkf.n_evictions > 0
    np.testing.assert_array_equal(kf.slot_of[:len(kf)], jkf.slot_of[:len(jkf)])
    g, jg = ts.graph, js.graph
    assert g.n_edges_recycled == jg.n_edges_recycled > 0
    assert g._free_edge_rows == jg._free_edge_rows
    E = jg.n_edges
    np.testing.assert_array_equal(g.ii[:E], jg.ii[:E])
    np.testing.assert_array_equal(g.jj[:E], jg.jj[:E])
    # the pool stayed at its budget; every keyframe readable, evicted or not
    assert kf.X.shape[0] == kf.feat.shape[0] == 4
    for i in range(len(kf)):
        assert_close(kf.pointmap_np(i)[0], np.asarray(jkf.pointmap_np(i)[0]), 0, 1e-4,
                     f"keyframe {i}'s pointmap")


def test_paged_engine_poses_equal_jax(engines):
    """Raw poses (translation, quaternion, scale) within 2e-4 of the JAX run
    whose tracker normalises as the port's does; translations within 2e-4
    of the JAX run as it is."""
    (_, jr), (_, ar), (_, tr) = engines["jax"], engines["jax_as_is"], engines["port"]
    assert tr.frame_timestamps == jr.frame_timestamps == ar.frame_timestamps
    for got, want, as_is in ((tr.frame_poses, jr.frame_poses, ar.frame_poses),
                             (tr.keyframe_poses, jr.keyframe_poses, ar.keyframe_poses)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=POSE_ATOL)
        np.testing.assert_allclose(got[:, :3], np.asarray(as_is)[:, :3], rtol=0,
                                   atol=POSE_ATOL)


def test_quaternions_stay_unit_over_the_keyframe_chain(engines):
    """Every pose's quaternion stays within a few roundings of unit norm in
    the port.  The JAX run as it is takes the same keyframes, and its
    norms drift past 1e-4 by the last keyframe (fivefold a keyframe)."""
    (_, ar), (_, tr) = engines["jax_as_is"], engines["port"]
    assert tr.keyframe_timestamps == ar.keyframe_timestamps
    for poses in (tr.frame_poses, tr.keyframe_poses):
        drift = np.abs(np.linalg.norm(np.asarray(poses, np.float64)[:, 3:7], axis=-1) - 1)
        assert drift.max() < 1e-6, drift
    jdrift = np.abs(np.linalg.norm(np.asarray(ar.keyframe_poses, np.float64)[:, 3:7],
                                   axis=-1) - 1)
    assert jdrift[-1] > 1e-4, jdrift


def test_paging_is_the_unpaged_run_at_its_window(engines):
    (ts, tr), (cs, cr) = engines["port"], engines["control"]
    assert not cs.keyframes.paging and cs.keyframes.X.shape[0] > 4
    assert tr.n_keyframes == cr.n_keyframes
    np.testing.assert_array_equal(tr.frame_poses, cr.frame_poses)
    np.testing.assert_array_equal(tr.keyframe_poses, cr.keyframe_poses)


def test_a_long_keyframe_chain_relocalises_within_bound():
    """chip_smoke.py phase 10b's scene at 48x64: an arc of 24 frames with a
    keyframe every second tracked frame and no loop-closure candidates,
    then the camera back near its start, the store paged to 5 slots and
    the relocalisation taking two candidates.  Every keyframe quaternion
    stays within a few roundings of unit norm, a relocalisation succeeds
    and the last three frames land within tests/test_reloc_e2e.py's 0.15 m.
    (With the JAX tracker's composition the norm error grows fivefold a
    keyframe, and tracking parts from the arc before the teleport.)"""
    arc = arc_trajectory(24, radius=0.5, max_angle=3.5)
    back = arc[1:7].copy()
    back[:, 0] += 0.02
    gt = np.concatenate([arc, back])
    oracle = OracleModel(PlaneScene(HW), gt, noise=0.002)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jinit_head_params(jax.random.key(0), oracle.feat_dim, hdims=(8,)))
    centroids = np.asarray(jax.random.normal(jax.random.key(1), (64, 8)) * 0.3, np.float32)
    tparams, tcent = retrieval_from_jax(params, centroids)
    db = RetrievalDatabase(tparams, tcent, RetrievalHeadSettings(nfeat=8),
                           ASMKSettings(max_images=64), device=CPU)
    cfg = _engine_cfg(load_config, 5)
    cfg["engine"].update(keyframe_buffer=64, edge_buffer=64)
    cfg["reloc"]["strict"] = False
    cfg["retrieval"]["k"] = 2
    slam = SLAM(TorchOracleModel(oracle), cfg, HW, retrieval=db, device=CPU)
    _force_keyframes(slam, until_reloc=True)
    update = db.update
    db.update = lambda frame, add_after_query, k, min_thresh=0.0, kf_index=None: update(
        frame, add_after_query, 0, min_thresh, kf_index)  # no loop-closure candidates
    res = slam.run(OracleDataset(len(gt), HW), verbose=False)
    assert res.n_keyframes > 10 and slam.keyframes.n_evictions > 0
    assert res.n_reloc_success >= 1
    drift = np.abs(np.linalg.norm(np.asarray(res.keyframe_poses, np.float64)[:, 3:7],
                                  axis=-1) - 1)
    assert drift.max() < 1e-6, drift
    err = np.linalg.norm(res.frame_poses[-3:, :3] - gt[-3:, :3], axis=-1)
    assert err.max() < 0.15, err
