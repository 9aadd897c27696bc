"""The port's threaded backend across processes (``single_thread: False``
under a mesh of two ranks): two real OS processes on the CPU, joined by
``torch.distributed`` over gloo on localhost, run the oracle arc at 48x64
under ``base`` with ``engine.mesh: "auto"`` (one CPU shard a rank).

tests/torch_distributed_threaded_worker.py runs the scenarios; the process
pairs start once for this module (the runs and the failure, each pair with
its own timeout) and the JAX package's in-line ``SLAM.run`` on the same
scene runs here meanwhile.  The checks:

- gated (each task ends at the frame it started): the in-line run's bits;
- held (each write-back lands a frame after its task's start, on both
  ranks): ``pipeline: 1`` gives ``pipeline: 0``'s bits and schedule, so a
  chained submit that a write-back made stale is re-run;
- skewed (only rank 1's worker holds its tasks two frames): both ranks the
  same schedule, keyframes, edges and pose bits, under ``pipeline: 0`` and
  ``1``; the frames within the oracle bound of
  tests/test_torch_engine_modes.py (ATE < 0.05); the JAX package's keyframe
  count, and keyframe poses within KEYFRAME_POSE_ATOL of the JAX run and of
  the port's in-line run;
- a task that raises on rank 1 stops both processes with an error naming
  the rank and the task;
- a relocalisation (tests/test_reloc_e2e.py's teleport scene with a small
  retrieval database): both ranks drain their workers, relocalise at the
  same frame, hold the same pose bits, and land within that test's 0.15 m;
  every solve is the edge-sharded loop across the processes, its shard
  blocks assembled once an iteration that ran.

In one process, an agreed task's inputs: ``add_factors`` and ``solve`` on
a paged store's snapshot, taken before the store moves on, give the
in-place path's edge fields and poses on an unmoved store, and read the
evicted keyframes from the snapshot without uploading them.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu.eval.trajectory import umeyama_alignment
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.slam.factor_graph import FactorGraph
from mast3r_slam_tpu_torch.slam.frame import Frame, Keyframes

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_torch_common import CPU, TorchOracleModel

HERE = pathlib.Path(__file__).resolve().parent
WORKER = "torch_distributed_threaded_worker.py"
HW = (48, 64)
N_FRAMES = 12       # the worker's
HELD_FRAMES = 1     # the worker's holds: both ranks
SKEW_FRAMES = 2     # rank 1 only
PAIR_TIMEOUT_S = 240
ATE_BOUND_M = 0.05  # tests/test_torch_engine_modes.py's oracle bound
# what the threaded run is allowed against an in-line run: its solves land
# at other frames, so its last solve starts from other poses.  Keyframe
# poses read 4.2e-4 to 2.0e-3 from the in-line run on the CPU, over holds
# of 1 to 5 frames (the JAX in-line run is 7e-7 from the port's); the frame
# poses, tracked against keyframes whose solves had not landed yet, are
# held to the ground truth (ATE_BOUND_M) instead.
KEYFRAME_POSE_ATOL = 5e-3


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _start_pair(scenario, out, port):
    out.mkdir(parents=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", GLOO_SOCKET_IFNAME="lo")
    return [subprocess.Popen([sys.executable, str(HERE / WORKER), str(pid), "2", str(port),
                              str(out), scenario],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             cwd=str(HERE.parent), env=env)
            for pid in range(2)]


def _finish_pair(procs, timeout):
    """Both workers' (return code, output); kills both on a timeout."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _jax_inline():
    gt = arc_trajectory(N_FRAMES, radius=0.6, max_angle=2.5)
    cfg = jload_config("base")
    cfg["single_thread"] = True
    cfg["engine"]["keyframe_buffer"] = 32
    cfg["engine"]["edge_buffer"] = 32
    slam = JSLAM(OracleModel(PlaneScene(HW), gt, noise=0.002), cfg, HW)
    return slam.run(OracleDataset(N_FRAMES, HW), verbose=False)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("threaded")
    started = {sc: _start_pair(sc, root / sc, port)
               for sc, port in zip(("runs", "fail", "reloc"), _free_ports(3))}
    try:
        jres = _jax_inline()
    finally:
        done = {sc: _finish_pair(procs, PAIR_TIMEOUT_S) for sc, procs in started.items()}
    return root, done, jres


@pytest.fixture(scope="module")
def runs(pairs):
    root, done, _ = pairs
    for pid, (rc, out) in enumerate(done["runs"]):
        assert rc == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert "threaded backend over 2 processes OK" in out, out[-4000:]

    def load(name, rank):
        meta = json.loads((root / "runs" / f"{name}_rank{rank}.json").read_text())
        return meta, np.load(root / "runs" / f"{name}_rank{rank}.npz")

    return load


def _ate(poses, gt):
    est = poses[:, :3].astype(np.float64)
    s, R, t = umeyama_alignment(est, gt[: len(est), :3])
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.linalg.norm(aligned - gt[: len(est), :3], axis=-1) ** 2)))


def _same_run(a, b):
    (ma, pa), (mb, pb) = a, b
    for key in ("n_keyframes", "n_edges", "keyframe_timestamps", "schedule"):
        assert ma[key] == mb[key], (key, ma[key], mb[key])
    np.testing.assert_array_equal(pa["frame_poses"], pb["frame_poses"])
    np.testing.assert_array_equal(pa["keyframe_poses"], pb["keyframe_poses"])


def test_a_gated_run_gives_the_inline_bits(runs):
    """Each commit waits for this rank's worker: every task ends at its own
    frame, as in line, and the two processes give the in-line run's bits."""
    for rank in range(2):
        meta, _ = runs("gated_p0", rank)
        assert meta["agreed"] and meta["mesh_size"] == 2
        inline = runs("inline", rank)
        assert not inline[0]["agreed"]
        assert all(s == [s[0]] * 3 for s in inline[0]["schedule"])
        _same_run(runs("gated_p0", rank), inline)
    _same_run(runs("gated_p0", 0), runs("gated_p0", 1))
    assert runs("inline", 0)[0]["n_keyframes"] >= 3


def test_held_write_backs_give_the_same_bits_under_both_loops(runs):
    """Each write-back lands HELD_FRAMES after its task's start, some on
    frames that are no keyframe while the solved keyframe is still the one
    tracked against: the pipelined loop re-runs the chained submit those
    made stale and gives the sequential loop's bits."""
    meta, _ = runs("held_p0", 0)
    last = N_FRAMES - 1
    keyframe_frames = {s[0] for s in meta["schedule"]}
    lags = [s for s in meta["schedule"] if s[1] + HELD_FRAMES <= last]
    assert lags and all(s[2] == s[1] + HELD_FRAMES for s in lags), meta
    # the task's own keyframe still current at its write-back's frame
    assert any(s[2] not in keyframe_frames and not any(s[0] < f <= s[2] for f in keyframe_frames)
               for s in lags), meta
    assert meta["n_agree"] > 0
    for rank in range(2):
        _same_run(runs("held_p0", rank), runs("held_p1", rank))
    _same_run(runs("held_p0", 0), runs("held_p0", 1))


@pytest.mark.parametrize("pipeline", [0, 1])
def test_a_skewed_run_agrees_across_ranks(runs, pipeline):
    """Rank 1's worker lags SKEW_FRAMES frames or more; the ranks still hold
    the same schedule, keyframes, edges and pose bits, every task applied,
    the frames within the oracle bound."""
    name = f"skewed_p{pipeline}"
    r0, r1 = runs(name, 0), runs(name, 1)
    _same_run(r0, r1)
    meta, poses = r0
    sched = meta["schedule"]
    assert len(sched) == meta["n_keyframes"] - 1 == meta["n_tasks"] >= 2
    assert all(None not in s and s[0] <= s[1] <= s[2] for s in sched), sched
    held = [s for s in sched if s[1] + SKEW_FRAMES <= N_FRAMES - 1]
    assert held and all(s[2] - s[1] >= SKEW_FRAMES for s in held), sched
    assert meta["n_reloc"] == 0
    gt = arc_trajectory(N_FRAMES, radius=0.6, max_angle=2.5)
    assert _ate(poses["frame_poses"], gt) < ATE_BOUND_M


@pytest.mark.parametrize("pipeline", [0, 1])
def test_the_skewed_run_against_the_jax_engine(pairs, runs, pipeline):
    """The JAX package's single-process in-line run: the same keyframe
    count and keyframe timestamps; keyframe poses within KEYFRAME_POSE_ATOL
    of it and of the port's own in-line run."""
    _, _, jres = pairs
    meta, poses = runs(f"skewed_p{pipeline}", 0)
    inline_meta, inline = runs("inline", 0)
    assert meta["n_keyframes"] == jres.n_keyframes == inline_meta["n_keyframes"]
    assert meta["keyframe_timestamps"] == list(jres.keyframe_timestamps)
    np.testing.assert_allclose(poses["keyframe_poses"], np.asarray(jres.keyframe_poses),
                               rtol=0, atol=KEYFRAME_POSE_ATOL)
    np.testing.assert_allclose(poses["keyframe_poses"], inline["keyframe_poses"],
                               rtol=0, atol=KEYFRAME_POSE_ATOL)


def test_a_failed_task_ends_both_processes(pairs):
    """Rank 1's second task raises: both ranks stop their runs with an error
    naming rank 1 and task 1, and both processes exit (code 3), neither
    waiting on a collective."""
    _, done, _ = pairs
    for pid, (rc, out) in enumerate(done["fail"]):
        assert rc == 3, f"worker {pid} exited with {rc}:\n{out[-4000:]}"
        assert "the run stopped: backend task 1" in out and "failed on rank 1" in out, \
            out[-4000:]
    assert "a planted fault in the second backend task" in done["fail"][1][1]


RELOC_BOUND_M = 0.15  # tests/test_reloc_e2e.py's post-reloc bound


def test_a_relocalisation_drains_both_ranks_alike(pairs):
    """Tracking breaks at the teleport; both ranks drain their workers and
    relocalise at the same frame, end in TRACKING with the same schedule,
    keyframes, edges, solve iterations and pose bits, the last frames
    within RELOC_BOUND_M.  Every solve went through the edge-sharded loop
    across the processes: one shard block a rank an iteration that ran."""
    root, done, _ = pairs
    for pid, (rc, out) in enumerate(done["reloc"]):
        assert rc == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert "relocalisation over 2 processes OK" in out, out[-4000:]
    ranks = [(json.loads((root / "reloc" / f"reloc_rank{r}.json").read_text()),
              np.load(root / "reloc" / f"reloc_rank{r}.npz")) for r in range(2)]
    (m0, p0), (m1, p1) = ranks
    for key in ("relocs", "n_keyframes", "n_edges", "schedule", "solve_iters", "mode"):
        assert m0[key] == m1[key], (key, m0[key], m1[key])
    for key in ("frame_poses", "keyframe_poses"):
        np.testing.assert_array_equal(p0[key], p1[key])
    for meta, _ in ranks:
        assert meta["agreed"] and meta["mesh_size"] == 2 and meta["mode"] == "TRACKING"
        assert meta["n_reloc"] >= 1 and meta["n_reloc_success"] >= 1
        assert [ok for _, ok in meta["relocs"]].count(True) == meta["n_reloc_success"]
        its = meta["solve_iters"]
        assert len(its) >= meta["n_keyframes"] - 1 and all(1 <= i <= 10 for i in its), its
        assert meta["blocks"] == meta["local_shards"] * sum(its), meta
    err = np.linalg.norm(p0["frame_poses"][-3:, :3] - p0["gt"][-3:, :3], axis=-1)
    assert err.max() < RELOC_BOUND_M, err


def _paged_graph(n_kf=6):
    """Oracle keyframes 2k of an arc in a store of 4 slots (keep_recent 2:
    keyframes 0 and 1 evicted) and a graph over it."""
    gt = arc_trajectory(2 * n_kf, radius=0.6, max_angle=2.5)
    model = TorchOracleModel(OracleModel(PlaneScene(HW), gt, noise=0.002))
    N = HW[0] * HW[1]
    kf = Keyframes(8, N, model.num_patches, model.feat_dim, device=CPU, device_budget=4,
                   keep_recent=2)
    for k in range(n_kf):
        feat, pos = model.encode(torch.full((1, 3, *HW), (2 * k + 1) / 255.0 * 2 - 1))
        X, C = model.mono(feat, pos)
        kf.append(Frame(frame_id=2 * k, img=None,
                        T_WC=torch.as_tensor(gt[2 * k], dtype=torch.float32),
                        X_canon=X.reshape(N, 3), C=C.reshape(N, 1), n_fused=1, n_updates=1,
                        feat=feat, pos=pos))
    return kf, FactorGraph(model, load_config("base"), kf, HW, edge_capacity=4)


def test_an_agreed_task_reads_its_snapshot_of_a_paged_store():
    """The loop-closure edge (0, 5) and the windowed solve after it, whose
    pinned context is the evicted keyframe 0, from a snapshot: the store
    then fuses into keyframe 5 and appends (evicting again), yet the task
    gives the in-place path's fields and poses on an unmoved store, and
    keyframe 0 stays evicted (the snapshot served it)."""
    kf, graph = _paged_graph()
    ref_kf, ref = _paged_graph()
    assert not kf.is_resident(0)
    with kf.lock:
        ver = kf.pm_version.copy()
        snap = kf.snapshot()
    N = HW[0] * HW[1]
    kf.update_pointmap(5, torch.zeros(N, 3), torch.ones(N, 1), 9, 9, 0.0)
    f5 = kf.get_frame(5)
    kf.append(Frame(frame_id=99, img=None, T_WC=f5.T_WC, X_canon=torch.ones(N, 3),
                    C=torch.ones(N, 1), n_fused=1, n_updates=1, feat=f5.feat, pos=f5.pos))

    assert graph.add_factors([0], [5], 0.0, snap=snap)
    write_back = graph.solve(snap=snap, ver=ver)
    assert ref.add_factors([0], [5], 0.0)
    ref.solve()
    for a, b in zip(graph._stores(), ref._stores()):
        assert torch.equal(a[:1], b[:1])
    start, n_snap, generation, T_new, offset = write_back
    assert (n_snap, generation) == (6, snap.generation) and not kf.is_resident(0)
    before = kf.T_WC[:start].clone()
    assert kf.write_back_poses(*write_back)
    assert torch.equal(kf.T_WC[:n_snap], ref_kf.T_WC[:n_snap])
    assert torch.equal(kf.T_WC[:start], before) and start == 4
