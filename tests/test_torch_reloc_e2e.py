"""Retrieval and relocalisation end to end: ``SLAM.run`` of both packages
over the oracle's teleport scene, with the same retrieval head and codebook
carried across (``models.convert.retrieval_from_jax``).

The camera tracks an arc, teleports back near its start, tracking breaks,
and the database proposes early keyframes whose reloc edges re-anchor the
pose (tests/test_reloc_e2e.py's scene and retrieval sizing).  Both packages
must take the same decisions: reloc counts, keyframes, edges (the retrieved
loop-closure edges and the reloc edges included).  Poses are held at 2e-4
absolute, the tolerance of tests/test_torch_slam_e2e.py; the reloc snap and
the solves after it add no amplification beyond the frames' own chain.
"""

import jax
import numpy as np
import pytest

from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu.retrieval import RetrievalDatabase as JRetrievalDatabase
from mast3r_slam_tpu.retrieval.asmk import ASMKSettings as JASMKSettings
from mast3r_slam_tpu.retrieval.head import RetrievalHeadSettings as JHeadSettings
from mast3r_slam_tpu.retrieval.head import init_head_params as jinit_head_params
from mast3r_slam_tpu.slam.frame import Mode as JMode
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.models.convert import retrieval_from_jax
from mast3r_slam_tpu_torch.retrieval import (ASMKSettings, RetrievalDatabase,
                                             RetrievalHeadSettings)
from mast3r_slam_tpu_torch.slam.frame import Mode
from mast3r_slam_tpu_torch.slam.pipeline import SLAM

from oracle import OracleDataset, OracleModel, PlaneScene
from test_reloc_e2e import teleport_trajectory
from test_torch_common import CPU, TorchOracleModel

HW = (48, 64)
POSE_ATOL = 2e-4


def _cfg(load):
    cfg = load("base")
    cfg["single_thread"] = True
    cfg["engine"]["keyframe_buffer"] = 64
    cfg["engine"]["edge_buffer"] = 64
    cfg["reloc"]["strict"] = False
    return cfg


@pytest.fixture(scope="module")
def runs():
    gt = teleport_trajectory()
    n = len(gt)
    oracle = OracleModel(PlaneScene(HW), gt, noise=0.002)
    # f32 leaves (tests/conftest.py turns JAX x64 on), fed to both packages
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jinit_head_params(jax.random.key(0), oracle.feat_dim, hdims=(8,)))
    centroids = np.asarray(jax.random.normal(jax.random.key(1), (64, 8)) * 0.3, np.float32)

    jdb = JRetrievalDatabase(params, centroids, JHeadSettings(nfeat=8),
                             JASMKSettings(capacity=64 * 8, max_images=64))
    jslam = JSLAM(oracle, _cfg(jload_config), HW, retrieval=jdb)
    jres = jslam.run(OracleDataset(n, HW), verbose=False)

    tparams, tcent = retrieval_from_jax(params, centroids)
    tdb = RetrievalDatabase(tparams, tcent, RetrievalHeadSettings(nfeat=8),
                            ASMKSettings(max_images=64), device=CPU)
    tslam = SLAM(TorchOracleModel(oracle), _cfg(load_config), HW, retrieval=tdb,
                 device=CPU)
    tres = tslam.run(OracleDataset(n, HW), verbose=False)
    return jslam, jres, tslam, tres, gt


def test_same_reloc_counts_and_keyframes(runs):
    jslam, jres, tslam, tres, _ = runs
    assert jres.n_reloc >= 1 and jres.n_reloc_success >= 1
    assert (tres.n_reloc, tres.n_reloc_success) == (jres.n_reloc, jres.n_reloc_success)
    assert tres.n_keyframes == jres.n_keyframes
    assert tres.keyframe_timestamps == jres.keyframe_timestamps
    np.testing.assert_array_equal(tslam.keyframes.frame_id[: tres.n_keyframes],
                                  jslam.keyframes.frame_id[: jres.n_keyframes])
    assert jslam.mode == JMode.TRACKING and tslam.mode == Mode.TRACKING


def test_same_edges(runs):
    jslam, _, tslam, _, _ = runs
    E = jslam.graph.n_edges
    assert tslam.graph.n_edges == E
    np.testing.assert_array_equal(tslam.graph.ii[:E], jslam.graph.ii[:E])
    np.testing.assert_array_equal(tslam.graph.jj[:E], jslam.graph.jj[:E])
    # retrieval proposed at least one edge that is not consecutive
    assert np.any(np.abs(tslam.graph.ii[:E] - tslam.graph.jj[:E]) > 1)


def test_same_database(runs):
    jslam, _, tslam, _, _ = runs
    jivf, tivf = jslam.retrieval.ivf, tslam.retrieval.ivf
    assert (tivf.n_images, tivf.n_entries) == (jivf.n_images, jivf.n_entries)
    assert tslam.retrieval.kf_counter == jslam.retrieval.kf_counter
    _, jw, ji = jivf.entries()
    _, tw, ti = tivf.entries()
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(ti, ji)


def test_same_frame_poses_and_post_reloc_error(runs):
    _, jres, _, tres, gt = runs
    assert tres.frame_timestamps == jres.frame_timestamps
    np.testing.assert_allclose(tres.frame_poses, jres.frame_poses, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(tres.keyframe_poses, np.asarray(jres.keyframe_poses),
                               rtol=0, atol=POSE_ATOL)
    # the JAX package's own bound (tests/test_reloc_e2e.py)
    err = np.linalg.norm(tres.frame_poses[-3:, :3] - gt[-3:, :3], axis=-1)
    assert err.max() < 0.15, err
