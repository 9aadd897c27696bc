"""``engine.pipeline: 2`` in the port: the tracker's compute and the keyframe
store on a second card, the model on the engine's, the pipelined loop
without the chain (the port of tests/test_pipeline2.py).

The card choice (``pipeline.tracker_card``) is patched to return the CPU,
so the two "cards" are one CPU, as the JAX test's are one CPU's virtual
devices.  The scene is that test's: the oracle arc at 48x64, 30 frames,
pointmap noise 2 mm, `base`.

Tolerances.  Against the port's sequential loop: the same bits (the loop
reorders the same computations and corrects its speculative decode on a
keyframe switch).  Against the JAX package's pipeline-2 run: the same
keyframes, no relocalisation, frames 0-19 within 1e-5 absolute (read: under
5e-6) and all 30 within 2e-2.  The arc's last ten frames turn past about
2.3 rad, where the open scene's views degenerate and f32 differences grow
chaotically (tests/oracle.py); the port's sequential loop, whose bits
pipeline 2 gives, was read 1.4e-2 from the JAX run at frame 29 there.  The
threaded backend beside pipeline 2: the JAX test's ATE bound, 0.05.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_tpu.eval.trajectory import umeyama_alignment
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.slam import pipeline as tpipeline
from mast3r_slam_tpu_torch.slam import tracker as ttracker

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_pipeline2 import _run as jax_run
from test_torch_common import CPU, TorchOracleModel, time_limit

HW = (48, 64)
N_FRAMES = 30
EARLY, EARLY_ATOL, JAX_ATOL = 20, 1e-5, 2e-2


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(240):
        yield


def _run(pipeline, single_thread=True):
    gt = arc_trajectory(N_FRAMES, radius=0.6, max_angle=2.5)
    model = TorchOracleModel(OracleModel(PlaneScene(HW), gt, noise=0.002))
    cfg = load_config("base")
    cfg["engine"]["edge_buffer"] = 64
    cfg["engine"]["pipeline"] = pipeline
    cfg["single_thread"] = single_thread
    slam = tpipeline.SLAM(model, cfg, HW, keyframe_buffer=64, device=CPU)
    try:
        res = slam.run(OracleDataset(N_FRAMES, HW), verbose=False)
    finally:
        slam.close()
    assert slam.backend_errors == []
    return slam, res, gt


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    chained = []
    try:
        mp.setattr(tpipeline, "tracker_card", lambda device: torch.device("cpu"))
        orig = ttracker.FrameTracker.track_submit_chained
        mp.setattr(ttracker.FrameTracker, "track_submit_chained",
                   lambda self, *a: chained.append(1) or orig(self, *a))
        out = {"seq": _run(0), "pipe": _run(2), "jax": jax_run(2)}
    finally:
        mp.undo()
    out["chained"] = len(chained)
    return out


def test_pipeline2_places_the_tracker_and_gives_the_sequential_bits(runs):
    _, seq, _ = runs["seq"]
    slam, pipe, _ = runs["pipe"]
    assert slam.pipeline == 2 and slam.tracker.compute_device == torch.device("cpu")
    assert slam.keyframes.device == slam.tracker.compute_device
    assert runs["chained"] == 0, "pipeline: 2 keeps the depth-1 loop"
    assert pipe.n_keyframes == seq.n_keyframes >= 2 and pipe.n_reloc == seq.n_reloc == 0
    np.testing.assert_array_equal(pipe.frame_poses, seq.frame_poses)
    np.testing.assert_array_equal(pipe.keyframe_poses, seq.keyframe_poses)


def test_pipeline2_matches_the_jax_pipeline2_run(runs):
    _, pipe, _ = runs["pipe"]
    jslam, jres = runs["jax"]
    assert jslam.pipeline == 2
    assert pipe.n_keyframes == jres.n_keyframes and pipe.n_reloc == jres.n_reloc == 0
    np.testing.assert_array_equal(runs["pipe"][0].keyframes.frame_id[:pipe.n_keyframes],
                                  jslam.keyframes.frame_id[:jres.n_keyframes])
    np.testing.assert_allclose(pipe.frame_poses[:EARLY], jres.frame_poses[:EARLY], rtol=0,
                               atol=EARLY_ATOL)
    np.testing.assert_allclose(pipe.frame_poses, jres.frame_poses, rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(pipe.keyframe_poses, np.asarray(jres.keyframe_poses),
                               rtol=0, atol=JAX_ATOL)


def test_pipeline2_with_the_threaded_backend(monkeypatch):
    monkeypatch.setattr(tpipeline, "tracker_card", lambda device: torch.device("cpu"))
    slam, res, gt = _run(2, single_thread=False)
    assert slam.pipeline == 2 and res.n_keyframes >= 2 and res.n_reloc == 0
    est = res.frame_poses[:, :3]
    s, R, tr = umeyama_alignment(est, gt[:, :3])
    aligned = (s * (R @ est.T)).T + tr
    ate = float(np.sqrt(np.mean(np.linalg.norm(aligned - gt[:, :3], axis=-1) ** 2)))
    assert ate < 0.05, ate
