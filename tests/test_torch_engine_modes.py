"""The engine modes of the port (``slam/pipeline.py``, ``slam/frame.py``):
the pipelined loop (``engine.pipeline: 1``, chained or not) against the
sequential loop, bit for bit; the port's pipelined and ``speed`` runs
against the JAX package's; the threaded backend (``single_thread:
False``): tracking advances while a backend task is blocked, a stale
write-back is refused, the latency stats are recorded (the three
properties of tests/test_async_overlap.py); and a snapshot of the
keyframe store is not torn by a concurrent ``update_pointmap``.

The oracle arc at 48x64 (tests/oracle.py).  Poses against the JAX package:
2e-4 absolute, the tolerance of tests/test_torch_slam_e2e.py.  Within the
port, the pipelined loop reorders the same computations, so its poses are
equal to the sequential loop's.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu.eval.trajectory import umeyama_alignment
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.lie import sim3
from mast3r_slam_tpu_torch.slam.frame import Frame, Keyframes
from mast3r_slam_tpu_torch.slam.pipeline import SLAM

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_torch_common import CPU, TorchOracleModel

HW = (48, 64)
N_FRAMES = 16
POSE_ATOL = 2e-4


def _oracle(n_frames=N_FRAMES):
    gt = arc_trajectory(n_frames, radius=0.6, max_angle=2.5)
    return OracleModel(PlaneScene(HW), gt, noise=0.002), gt


def _cfg(load, name="base", **engine):
    cfg = load(name)
    cfg["single_thread"] = True
    cfg["engine"]["keyframe_buffer"] = 16
    cfg["engine"]["edge_buffer"] = 32
    cfg["engine"].update(engine)
    return cfg


def _run(cfg, oracle, n_frames=N_FRAMES):
    slam = SLAM(TorchOracleModel(oracle), cfg, HW, device=CPU)
    res = slam.run(OracleDataset(n_frames, HW), verbose=False)
    slam.close()
    assert slam.backend_errors == []
    return slam, res


def _ate(poses, gt):
    est = poses[:, :3].astype(np.float64)
    s, R, t = umeyama_alignment(est, gt[: len(est), :3])
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.linalg.norm(aligned - gt[: len(est), :3], axis=-1) ** 2)))


@pytest.fixture(scope="module")
def sequential():
    oracle, gt = _oracle()
    return oracle, gt, _run(_cfg(load_config), oracle)


@pytest.mark.parametrize("chain", [True, False])
def test_pipeline1_equals_the_sequential_loop(sequential, chain):
    oracle, _, (_, seq) = sequential
    slam, res = _run(_cfg(load_config, pipeline=1, chain=chain), oracle)
    assert slam.pipeline == 1 and res.n_reloc == seq.n_reloc == 0
    assert res.n_keyframes == seq.n_keyframes >= 3
    assert res.keyframe_timestamps == seq.keyframe_timestamps
    np.testing.assert_array_equal(res.frame_poses, seq.frame_poses)
    np.testing.assert_array_equal(res.keyframe_poses, seq.keyframe_poses)
    stages = slam.timer.stats()
    assert stages["frame.latency"]["count"] == N_FRAMES
    assert {"pipeline.spec_decode", "pipeline.submit", "pipeline.finish_prev"} <= set(stages)


def test_speed_pipeline1_keeps_the_jax_keyframes(sequential):
    """The port's run against the JAX package's under ``speed``, which sets
    ``pipeline: 1``, the gated matcher and the one-way, reused and
    speculative edges, both single threaded: the same keyframes and edges,
    poses within 2e-4."""
    oracle, gt, _ = sequential
    jslam = JSLAM(oracle, _cfg(jload_config, "speed"), HW)
    jres = jslam.run(OracleDataset(N_FRAMES, HW), verbose=False)
    slam, res = _run(_cfg(load_config, "speed"), oracle)
    assert jslam.pipeline == slam.pipeline == 1
    assert res.n_keyframes == jres.n_keyframes >= 3
    assert res.keyframe_timestamps == jres.keyframe_timestamps
    E = jslam.graph.n_edges
    assert slam.graph.n_edges == E
    np.testing.assert_array_equal(slam.graph.ii[:E], jslam.graph.ii[:E])
    np.testing.assert_array_equal(slam.graph.jj[:E], jslam.graph.jj[:E])
    np.testing.assert_allclose(res.keyframe_poses, np.asarray(jres.keyframe_poses),
                               rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(res.frame_poses, jres.frame_poses, rtol=0, atol=POSE_ATOL)


def test_speed_threaded_and_pipelined_runs(sequential):
    """``speed`` as packaged: the backend on its worker thread and the
    pipelined loop.  The backend's timing is not the sequential loop's, so
    the poses are held to the ground truth (the sequential run's bound in
    tests/test_async_overlap.py), not to the bit."""
    oracle, gt, _ = sequential
    cfg = load_config("speed")
    cfg["engine"]["edge_buffer"] = 32
    slam, res = _run(cfg, oracle)
    assert not slam.single_thread and slam.pipeline == 1
    assert res.n_keyframes >= 3 and slam.graph.n_edges == res.n_keyframes - 1
    assert slam.timer.stats()["backend.update"]["count"] == res.n_keyframes - 1
    assert _ate(res.frame_poses, gt) < 0.05


def test_tracking_advances_while_the_backend_is_blocked():
    """The first backend task waits on an event; the frontend keeps
    tracking frames (and may append keyframes) while it is in flight."""
    oracle, gt = _oracle(30)
    cfg = _cfg(load_config)
    cfg["single_thread"] = False
    slam = SLAM(TorchOracleModel(oracle), cfg, HW, device=CPU)
    ds = OracleDataset(30, HW)
    started, release, finished = threading.Event(), threading.Event(), threading.Event()
    orig = slam._backend_update_impl
    during = []

    def gated(kf_idx, capture=None):
        started.set()
        assert release.wait(timeout=60), "release never set"
        orig(kf_idx, capture)
        finished.set()

    slam._backend_update_impl = gated
    last_T = None
    for i in range(30):
        ts_, img = ds[i]
        frame = slam.process_frame(i, ts_, img, last_T_WC=last_T)
        last_T = frame.T_WC
        if started.is_set() and not finished.is_set():
            during.append(i)
        if len(during) >= 5:
            release.set()
    release.set()
    slam.join_backend()
    slam.close()
    assert started.is_set() and finished.is_set() and slam.backend_errors == []
    assert len(during) >= 5, f"only {len(during)} frames tracked during the task"
    assert _ate(np.stack([p for _, p in slam.frame_log]), gt) < 0.05
    assert "jitter_ms" in slam.timer.stats()["tracker.track"]


def _store(n_kf=3, N=16):
    kf = Keyframes(capacity=8, num_pixels=N, num_patches=4, feat_dim=8, device=CPU)
    for fid in range(n_kf):
        kf.append(Frame(frame_id=fid, img=None, T_WC=sim3.identity(),
                        X_canon=torch.full((N, 3), float(fid)), C=torch.ones(N, 1),
                        n_fused=1, n_updates=1, feat=torch.zeros(1, 4, 8),
                        pos=torch.zeros(1, 4, 2, dtype=torch.int32)))
    return kf


def test_stale_write_back_is_refused():
    """A pop_last between a solve's snapshot and its write-back refuses the
    poses (the slots no longer hold the same keyframes)."""
    kf = _store()
    snap = kf.snapshot()
    before = kf.T_WC[:3].clone()
    kf.pop_last()
    moved = torch.tensor([9.0, 9, 9, 0, 0, 0, 1, 1]).expand(8, 8)
    assert not kf.write_back_poses(1, snap.n, snap.generation, moved)
    assert torch.equal(kf.T_WC[:3], before)
    snap2 = kf.snapshot()
    assert snap2.generation == snap.generation + 1
    assert kf.write_back_poses(1, snap2.n, snap2.generation, moved)
    assert kf.T_WC[1, :3].tolist() == [9, 9, 9] and torch.equal(kf.T_WC[0], before[0])


def test_latency_jitter_stat_recorded():
    """``SLAM.run`` with the threaded backend records frame.latency for
    every frame, with its p95 and jitter, while slowed backend tasks run."""
    oracle, _ = _oracle(20)
    cfg = _cfg(load_config)
    cfg["single_thread"] = False
    slam = SLAM(TorchOracleModel(oracle), cfg, HW, device=CPU)
    orig = slam._backend_update_impl

    def slow(kf_idx, capture=None):
        time.sleep(0.05)
        orig(kf_idx, capture)

    slam._backend_update_impl = slow
    res = slam.run(OracleDataset(20, HW), verbose=False)
    slam.close()
    stats = slam.timer.stats()
    lat = stats["frame.latency"]
    assert res.n_keyframes >= 2 and lat["count"] == 20
    assert lat["jitter_ms"] >= 0.0 and lat["p95_ms"] >= lat["p50_ms"]
    assert stats["backend.update"]["count"] >= 1 and slam.backend_errors == []


def test_snapshot_is_not_torn_by_update_pointmap():
    """The tracker's per-frame commit writes a keyframe's X and C in place
    while a backend task reads a snapshot.  A writer thread commits X = k,
    C = k for k = 1, 2, ...; every snapshot must show one k in both, and
    keep showing it while the writer goes on."""
    N = 4096
    kf = _store(2, N)
    stop = threading.Event()

    def writer():
        k = 1.0
        while not stop.is_set():
            kf.update_pointmap(1, torch.full((N, 3), k), torch.full((N, 1), k), 1, 1, 0.0)
            k += 1.0

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    th = threading.Thread(target=writer)
    th.start()
    try:
        seen = set()
        deadline = time.time() + 3.0
        while time.time() < deadline and len(seen) < 50:
            snap = kf.snapshot()
            k = float(snap.C[1, 0, 0])
            time.sleep(0)  # let the writer run between the read and the checks
            assert (snap.X[1] == k).all() and (snap.C[1] == k).all(), "torn snapshot"
            seen.add(k)
    finally:
        stop.set()
        th.join(timeout=10)
        sys.setswitchinterval(old)
    assert not th.is_alive() and len(seen) >= 5
