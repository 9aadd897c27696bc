"""Port parity of tracking: both Gauss-Newton solvers, ``fuse_pointmap`` in
all six modes, and ``_track_compute`` on an oracle frame pair.

Tolerances: the GN solvers assemble the same f32 normal equations but sum
~N*R terms in another order and factor with another LAPACK, and the loop
compounds that over its iterations: poses agree to 1e-4 absolute (the
solution is ~1e-6 relative of unit scale; 1e-4 leaves room for one extra or
one fewer iteration at the convergence threshold).  Fusion is elementwise
f32: 1e-6 relative.  ``_track_compute`` indices and decision stats must be
equal (match fractions up to one pixel in 3072), poses within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu.ops import tracking_gn as jgn
from mast3r_slam_tpu.slam import frame as jframe
from mast3r_slam_tpu.slam import tracker as jtracker
from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu_torch.ops import tracking_gn as tgn
from mast3r_slam_tpu_torch.slam import frame as tframe
from mast3r_slam_tpu_torch.slam import tracker as ttracker
from mast3r_slam_tpu_torch.config import load_config

from oracle import OracleModel, PlaneScene, arc_trajectory
from test_torch_common import assert_close, f32, n, t

HW = (48, 64)
N = HW[0] * HW[1]
K = np.array([[51.2, 0, 32.0], [0, 51.2, 24.0], [0, 0, 1]], np.float32)


def _gn_problem(seed, calib=False):
    """Keyframe points and frame points related by a known Sim(3) + noise."""
    rng = np.random.default_rng(seed)
    Xk = f32(rng, 2000, 3)
    Xk[:, 2] = np.abs(Xk[:, 2]) * 2 + 1.5
    T_true = np.asarray(jsim3.exp(jnp.asarray(f32(rng, 7, scale=0.05))), np.float32)
    Xf = np.asarray(jsim3.act(jsim3.inv(jnp.asarray(T_true)), jnp.asarray(Xk)), np.float32)
    Xf = Xf + f32(rng, *Xf.shape, scale=0.002)
    Qk = (1.5 + rng.uniform(size=(2000, 1))).astype(np.float32)
    valid = (rng.uniform(size=(2000, 1)) > 0.1).astype(np.float32)
    T0 = np.asarray(jsim3.identity(), np.float32)
    return Xk, Xf, Qk, valid, T0, T_true


def test_gn_ray_dist_parity():
    Xk, Xf, Qk, valid, T0, T_true = _gn_problem(0)
    s = jgn.GNSettings()
    Tj, cj, okj = jgn.opt_pose_ray_dist_sim3(*(jnp.asarray(a) for a in (Xf, Xk, T0, Qk, valid)), s)
    Tt, ct, okt = tgn.opt_pose_ray_dist_sim3(*(t(a) for a in (Xf, Xk, T0, Qk, valid)),
                                             tgn.GNSettings())
    assert bool(okt) and bool(okj)
    assert_close(Tt, Tj, 0, 1e-4, "pose")
    assert_close(ct, cj, 1e-3, 1e-3, "cost")
    assert_close(Tt[:3], T_true[:3], 0, 5e-3, "recovers the pose")


def test_gn_calib_parity():
    Xk, Xf, Qk, valid, T0, _ = _gn_problem(1)
    uvz = np.stack([K[0, 0] * Xk[:, 0] / Xk[:, 2] + K[0, 2],
                    K[1, 1] * Xk[:, 1] / Xk[:, 2] + K[1, 2],
                    np.log(Xk[:, 2])], -1).astype(np.float32)
    vm = np.ones((2000, 1), bool)
    s = jgn.GNSettings()
    Tj, cj, okj = jgn.opt_pose_calib_sim3(
        *(jnp.asarray(a) for a in (Xf, Xk, T0, Qk, valid, uvz, vm, K)), HW, s)
    Tt, ct, okt = tgn.opt_pose_calib_sim3(
        *(t(a) for a in (Xf, Xk, T0, Qk, valid, uvz, vm, K)), HW, tgn.GNSettings())
    assert bool(okt) == bool(okj)
    assert_close(Tt, Tj, 0, 1e-4, "pose")


def test_gn_singular_system_is_not_ok():
    """cho_factor's NaN -> ok=False in JAX; cholesky_ex info -> ok=False here."""
    Xk, Xf, Qk, _, T0, _ = _gn_problem(2)
    zero = np.zeros((2000, 1), np.float32)  # no valid residual: H = 0
    _, _, okj = jgn.opt_pose_ray_dist_sim3(*(jnp.asarray(a) for a in (Xf, Xk, T0, Qk, zero)),
                                           jgn.GNSettings())
    Tt, _, okt = tgn.opt_pose_ray_dist_sim3(*(t(a) for a in (Xf, Xk, T0, Qk, zero)),
                                            tgn.GNSettings())
    assert not bool(okj) and not bool(okt)
    assert torch.isfinite(Tt).all()


@pytest.mark.parametrize("mode", jframe.FILTERING_MODES)
@pytest.mark.parametrize("step", [0, 1, 2])
def test_fuse_pointmap_modes(mode, step):
    rng = np.random.default_rng(7)
    X, Xn = f32(rng, 300, 3), f32(rng, 300, 3)
    C = (1 + rng.uniform(size=(300, 1))).astype(np.float32)
    Cn = (1 + rng.uniform(size=(300, 1))).astype(np.float32)
    score = np.float32(1.55)
    args = (X, C, 2, step, Xn, Cn)
    want = jframe.fuse_pointmap(*(jnp.asarray(a) for a in args), score=score, mode=mode,
                                score_mode="median")
    got = tframe.fuse_pointmap(*(t(np.asarray(a)) for a in args), score=float(score),
                               mode=mode, score_mode="median")
    for g, w in zip(got, want):
        assert_close(g, w, 1e-6, 1e-6, mode)


def test_best_score_median_of_even_count():
    C = np.arange(1, 11, dtype=np.float32)[:, None]  # even count: 5.5, not 5
    assert float(tframe.pointmap_score(t(C))) == pytest.approx(
        float(jframe.pointmap_score(jnp.asarray(C))))


@pytest.fixture(scope="module")
def oracle_pair():
    scene = PlaneScene(HW)
    gt = arc_trajectory(8, radius=0.5, max_angle=0.6)
    oracle = OracleModel(scene, gt, noise=0.002)
    res_ii, res_ji = oracle._pair(3, 2)  # frame 3 against keyframe 2
    Xk, Ck = oracle.mono(jnp.zeros((1, 1, 1)).at[0, 0, 0].set(2.0), None)
    return [np.asarray(a, np.float32) for a in (*res_ii, *res_ji)], \
        np.asarray(Xk, np.float32).reshape(N, 3), np.asarray(Ck, np.float32).reshape(N, 1), gt


@pytest.mark.parametrize("config,mode", [("base", "weighted_pointmap"),
                                         ("base", "best_score"),
                                         ("eval_calib", "weighted_pointmap")])
def test_track_compute_parity(oracle_pair, config, mode):
    """Uncalibrated (ray + distance) and calibrated (pixel + log-depth)."""
    preds, Xk, Ck, gt = oracle_pair
    cfg = jload_config(config)
    cfg["tracking"]["filtering_mode"] = mode
    ts_j = jtracker.TrackerSettings.from_config(cfg)
    tcfg = load_config(config)
    tcfg["tracking"]["filtering_mode"] = mode
    ts_t = ttracker.TrackerSettings.from_config(tcfg)
    assert ts_t.use_calib == (config == "eval_calib")

    T_WCk = gt[2]
    T_WCf = gt[2]  # warm start from the keyframe pose, as after a keyframe
    idx0 = np.arange(N, dtype=np.int32)
    frame_state = (np.zeros((N, 3), np.float32), np.zeros((N, 1), np.float32), 0, 0,
                   np.float32(-np.inf))
    kf_state = (Xk, Ck, 1, 1, np.float32(-np.inf))
    Kc = PlaneScene(HW).K  # the oracle camera (used when calibrated)
    out_j = jtracker._track_compute(
        ts_j, HW, *(jnp.asarray(a) for a in preds),
        *(jnp.asarray(a) for a in frame_state), *(jnp.asarray(a) for a in kf_state),
        jnp.asarray(T_WCf), jnp.asarray(T_WCk), jnp.asarray(idx0), jnp.asarray(Kc))
    out_t = ttracker._track_compute(
        ts_t, HW, *(t(a) for a in preds),
        *(t(np.asarray(a)) for a in frame_state), *(t(np.asarray(a)) for a in kf_state),
        t(T_WCf), t(T_WCk), t(idx0), t(Kc))

    np.testing.assert_array_equal(n(out_t["idx_f2k"]), np.asarray(out_j["idx_f2k"]))
    sj, st = np.asarray(out_j["stats"]), n(out_t["stats"])
    assert_close(st[:3], sj[:3], 0, 1.0 / N, "match fractions")
    assert st[3] == sj[3] == 1.0, "GN ok"
    assert_close(st[4:6], sj[4:6], 0, 0, "frame counters")
    assert_close(st[6], sj[6], 1e-6, 1e-6, "frame score")
    assert_close(out_t["T_WCf"], out_j["T_WCf"], 0, 1e-4, "T_WCf")
    assert_close(st[8:], np.asarray(out_j["T_WCf"]), 0, 1e-4, "stats pose")
    for key in ("frame_X", "frame_C", "kf_C"):
        assert_close(out_t[key], out_j[key], 1e-5, 1e-5, key)
    assert_close(out_t["kf_X"], out_j["kf_X"], 1e-4, 1e-4, "kf_X (through T_CkCf)")
    # the tracked pose is the ground truth's to the matcher's floor: one pixel
    # at 48x64 is ~4 cm of parallax at scene depth
    assert_close(st[8:11], gt[3][:3], 0, 0.03, "pose vs ground truth")


@pytest.mark.parametrize("config", ["base", "speed"])
def test_tracker_settings_take_the_speed_keys(config):
    """Every matching and tracking setting, the speed profile's gated
    matcher included, equals the JAX package's."""
    ts_t = ttracker.TrackerSettings.from_config(load_config(config))
    ts_j = jtracker.TrackerSettings.from_config(jload_config(config))
    for field in ts_j._fields:
        if field != "gn":
            assert getattr(ts_t, field) == getattr(ts_j, field), field
    assert tuple(ts_t.gn) == tuple(ts_j.gn)


def test_keyframe_store_append_and_grow():
    kf = tframe.Keyframes(capacity=2, num_pixels=12, num_patches=3, feat_dim=4, device="cpu")
    for i in range(5):
        fr = tframe.Frame(frame_id=i, img=None, T_WC=torch.tensor([0, 0, i, 0, 0, 0, 1, 1.0]),
                          X_canon=torch.full((12, 3), float(i)), C=torch.ones(12, 1),
                          n_fused=1, n_updates=1, feat=torch.full((1, 3, 4), float(i)),
                          pos=torch.zeros(1, 3, 2, dtype=torch.int32))
        kf.append(fr)
    assert kf.capacity == 8 and len(kf) == 5 and kf.last_idx() == 4
    # slots written before each doubling survived it
    assert list(kf.frame_id[:6]) == [0, 1, 2, 3, 4, -1]
    X, C, nf, nu, sc, T, feat, pos = kf.slices(3)
    assert float(X[0, 0]) == 3.0 and float(T[2]) == 3.0 and float(feat[0, 0, 0]) == 3.0
    assert int(nf) == 1 and int(nu) == 1 and float(sc) == float("-inf")
    assert float(kf.score[7]) == float("-inf") and float(kf.T_WC[7, 6]) == 1.0
