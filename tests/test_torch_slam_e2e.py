"""The slices end to end: ``SLAM.run`` over the same oracle sequence in
both packages, each running its backend (consecutive edge + global solve
after every new keyframe), gives the same keyframes, modes, edges and
per-frame poses.

The sequence is an 8-frame forward arc at 48x64 with the oracle's pointmap
noise.  Tolerance on poses: each frame's GN solve agrees to ~1e-5
(test_torch_tracking.py), each global solve to ~1e-5
(test_torch_global_gn.py), and the warm starts chain the frames, so 2e-4
absolute on translation and quaternion.
"""

import numpy as np
import pytest

from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.slam.pipeline import SLAM

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_torch_common import CPU, TorchOracleModel

HW = (48, 64)
N_FRAMES = 8


@pytest.fixture(scope="module", params=["base", "eval_calib"])
def runs(request):
    """Uncalibrated, and calibrated with the oracle camera's K."""
    gt = arc_trajectory(N_FRAMES, radius=0.6, max_angle=2.5)
    scene = PlaneScene(HW)
    oracle = OracleModel(scene, gt, noise=0.002)
    K = scene.K if request.param == "eval_calib" else None

    jcfg = jload_config(request.param)
    jcfg["single_thread"] = True
    jcfg["engine"]["keyframe_buffer"] = 16
    jcfg["engine"]["edge_buffer"] = 16
    jslam = JSLAM(oracle, jcfg, HW, K=K)
    jres = jslam.run(OracleDataset(N_FRAMES, HW), verbose=False)

    cfg = load_config(request.param)
    cfg["single_thread"] = True
    cfg["engine"]["edge_buffer"] = 16
    tslam = SLAM(TorchOracleModel(oracle), cfg, HW, K=K, keyframe_buffer=16, device=CPU)
    tres = tslam.run(OracleDataset(N_FRAMES, HW), verbose=False)
    return jslam, jres, tslam, tres, gt


def test_same_keyframes_and_modes(runs):
    jslam, jres, tslam, tres, _ = runs
    assert tres.n_keyframes == jres.n_keyframes >= 2
    assert tres.keyframe_timestamps == jres.keyframe_timestamps
    np.testing.assert_array_equal(tslam.keyframes.frame_id[: tres.n_keyframes],
                                  jslam.keyframes.frame_id[: jres.n_keyframes])
    assert tres.n_reloc == jres.n_reloc == 0
    assert tslam.mode == jslam.mode
    # both backends stored the same consecutive edges
    E = jslam.graph.n_edges
    assert tslam.graph.n_edges == E == tres.n_keyframes - 1
    np.testing.assert_array_equal(tslam.graph.ii[:E], jslam.graph.ii[:E])
    np.testing.assert_array_equal(tslam.graph.jj[:E], jslam.graph.jj[:E])


def test_same_frame_poses(runs):
    _, jres, _, tres, gt = runs
    assert tres.frame_timestamps == jres.frame_timestamps
    np.testing.assert_allclose(tres.frame_poses, jres.frame_poses, rtol=0, atol=2e-4)
    np.testing.assert_allclose(tres.keyframe_poses, np.asarray(jres.keyframe_poses),
                               rtol=0, atol=2e-4)
    # and the port tracks the ground truth (first frame at the identity, as
    # in gt): without the backend, at 48x64 one pixel is ~4 cm of parallax
    # at scene depth, so a few cm is the matcher's quantisation floor
    err = np.linalg.norm(tres.frame_poses[:, :3] - gt[:, :3], axis=-1)
    assert err.max() < 0.08
