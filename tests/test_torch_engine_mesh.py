"""The engine on a mesh (``engine.mesh``), port against the JAX package.

tests/test_engine_mesh.py's scene: the oracle's forward arc at 48x64, 12
frames, no pointmap noise, `base` single threaded.  The port's mesh is 8
CPU shards (``SLAM(device="cpu")`` with ``engine.mesh: 8``), the JAX
package's its 8 virtual CPU devices: the backend's decode batch and every
global solve are sharded over them.

Tolerances: JAX's own, atol 1e-2 and rtol 3e-3 on the poses
(test_engine_mesh.py:60-65): a mesh sums the solve's blocks in another f32
order, and 12 frames of tracking and solves carry it on.  Read on this
scene: the port's mesh 8 within 1.7e-6 of its mesh 0 and within 1.6e-5 of
the JAX mesh-8 run.
"""

import numpy as np
import pytest

from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.slam import factor_graph as tfg
from mast3r_slam_tpu_torch.slam.pipeline import SLAM

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_engine_mesh import _run as jax_run
from test_torch_common import CPU, TorchOracleModel, time_limit

HW = (48, 64)
N_FRAMES = 12
ATOL, RTOL = 1e-2, 3e-3


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(240):
        yield


def _run(mesh, config="base", n_frames=N_FRAMES, noise=0.0):
    gt = arc_trajectory(n_frames, radius=0.6, max_angle=2.5)
    model = TorchOracleModel(OracleModel(PlaneScene(HW), gt, noise=noise))
    cfg = load_config(config)
    cfg["engine"]["edge_buffer"] = 64
    cfg["engine"]["mesh"] = mesh
    cfg["single_thread"] = True
    slam = SLAM(model, cfg, HW, keyframe_buffer=64, device=CPU)
    return slam, slam.run(OracleDataset(n_frames, HW), verbose=False)


@pytest.fixture(scope="module")
def runs():
    return {"port0": _run(0), "port8": _run(8), "jax8": jax_run(8)}


def test_mesh8_matches_the_jax_mesh8_run(runs):
    slam8, r8 = runs["port8"]
    jslam8, j8 = runs["jax8"]
    assert slam8.mesh.size == jslam8.graph.mesh.size == 8
    assert slam8.graph.n_edges == jslam8.graph.n_edges >= 1
    assert r8.n_keyframes == j8.n_keyframes and r8.n_reloc == j8.n_reloc == 0
    np.testing.assert_allclose(r8.frame_poses, j8.frame_poses, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(r8.keyframe_poses, np.asarray(j8.keyframe_poses),
                               atol=ATOL, rtol=RTOL)


def test_mesh8_matches_the_port_without_a_mesh(runs):
    slam0, r0 = runs["port0"]
    slam8, r8 = runs["port8"]
    assert slam0.mesh is None and slam0.graph.mesh is None
    assert r8.n_keyframes == r0.n_keyframes and r8.n_reloc == r0.n_reloc == 0
    np.testing.assert_allclose(r8.frame_poses, r0.frame_poses, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(r8.keyframe_poses, r0.keyframe_poses, atol=ATOL, rtol=RTOL)


def test_mesh_auto():
    """"auto" on the CPU is one shard (the CPU is one device); the run takes
    the mesh's paths (sharded decode and solve) to mesh 0's trajectory."""
    slam, res = _run("auto", n_frames=6)
    assert slam.mesh.size == 1 and slam.graph.mesh is slam.mesh
    assert not slam.graph._cache_usable(1)
    _, r0 = _run(0, n_frames=6)
    assert res.n_keyframes == r0.n_keyframes and res.n_reloc == 0
    np.testing.assert_allclose(res.frame_poses, r0.frame_poses, atol=ATOL, rtol=RTOL)


def test_speed_mesh_stores_symmetric_edges_only(monkeypatch):
    """Under `speed` the mesh takes no fast path (JAX factor_graph.py:327):
    no one-way decode, no reused tracker match, no speculative verdict;
    every stored edge has both halves."""
    calls = []
    orig = tfg.FactorGraph._compute_oneway
    monkeypatch.setattr(tfg.FactorGraph, "_compute_oneway",
                        lambda self, *a: calls.append(1) or orig(self, *a))
    slam0, _ = _run(0, config="speed", noise=0.002)
    assert calls, "speed without a mesh takes the one-way or reuse path"
    calls.clear()
    slam, res = _run(2, config="speed", noise=0.002)
    g = slam.graph
    E = g.n_edges
    assert calls == [] and E >= 1 and res.n_reloc == 0 and not g._pending
    assert bool(g.edge_live[:E].all())
    assert all(bool(g.valid_match_i[e].any()) and bool(g.valid_match_j[e].any())
               for e in range(E))


def test_cli_takes_engine_mesh_from_set(tmp_path, monkeypatch):
    """``--set engine.mesh=2`` through the port's CLI (no new flag):
    tests/test_torch_cli.py's sequence and oracle, eval_no_calib, the
    trajectory within the mesh bound of the run without the override."""
    from mast3r_slam_tpu_torch.data import dataloader as tdl
    from mast3r_slam_tpu_torch.slam import run as trun

    from test_eval_protocol import N_RAW_FRAMES, _write_tum_sequence
    from test_torch_cli import _oracle

    gt = arc_trajectory(N_RAW_FRAMES, radius=0.8, max_angle=3.0)
    seq = _write_tum_sequence(tmp_path / "tum", gt)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tdl.MonocularDataset, "img_size", 64)
    built = []
    real_build = trun.build_slam

    def build(cfg, dataset, **kw):
        kw["model"] = TorchOracleModel(_oracle(dataset, gt))
        built.append(real_build(cfg, dataset, **kw))
        return built[-1]

    monkeypatch.setattr(trun, "build_slam", build)
    argv = ["--dataset", str(seq), "--config", "eval_no_calib", "--device", CPU]
    r0 = trun.main(argv + ["--save-as", "no_mesh"])
    r2 = trun.main(argv + ["--save-as", "mesh", "--set", "engine.mesh=2"])
    assert built[0].mesh is None and built[1].mesh.size == 2
    assert r2.n_keyframes == r0.n_keyframes >= 2 and r2.n_reloc == 0
    np.testing.assert_allclose(r2.keyframe_poses, r0.keyframe_poses, atol=ATOL, rtol=RTOL)
