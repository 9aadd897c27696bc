"""The port's trajectory, ATE, PLY, keyframe-image, scene-JSON and top-down
exports against the JAX package's on the same keyframe store contents.

The port runs ``SLAM.run`` over the oracle arc (48x64, its frames resized
at 64 so that each keyframe keeps its image), saves a checkpoint, and the
JAX package's engine loads it: both stores then hold the same numbers.
Tolerances: files of text and images equal; world points within 1e-5 m
(one f32 Sim(3) action, and in calib mode the ray snap, each side's own
float order); everything selected by a threshold selects the same points.
"""

import json

import numpy as np
import pytest

from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu.eval import ate as jate
from mast3r_slam_tpu.eval import export as jexport
from mast3r_slam_tpu.eval import trajectory as jtraj
from mast3r_slam_tpu.slam.checkpoint import load_state as jload_state
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu.viz import renderer as jrenderer
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.data.png import read_png
from mast3r_slam_tpu_torch.eval import ate, export, trajectory
from mast3r_slam_tpu_torch.slam.checkpoint import save_state
from mast3r_slam_tpu_torch.slam.pipeline import SLAM
from mast3r_slam_tpu_torch.viz import renderer

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_torch_common import CPU, TorchOracleModel

HW = (48, 64)
N_FRAMES = 10
POINT_ATOL = 1e-5


@pytest.fixture(scope="module", params=["base", "eval_calib"])
def stores(request, tmp_path_factory):
    gt = arc_trajectory(N_FRAMES, radius=0.6, max_angle=2.5)
    scene = PlaneScene(HW)
    oracle = OracleModel(scene, gt, noise=0.002)
    K = scene.K if request.param == "eval_calib" else None
    cfg = load_config(request.param)
    cfg["single_thread"] = True
    cfg["engine"]["resize"] = 64
    tslam = SLAM(TorchOracleModel(oracle), cfg, HW, K=K, keyframe_buffer=16, device=CPU)
    res = tslam.run(OracleDataset(N_FRAMES, HW), verbose=False)
    ckpt = tmp_path_factory.mktemp("ckpt") / "state.npz"
    save_state(ckpt, tslam)
    jcfg = jload_config(request.param)
    jcfg["single_thread"] = True
    jslam = JSLAM(oracle, jcfg, HW, K=K)
    jload_state(ckpt, jslam)
    return tslam, jslam, res, gt, request.param == "eval_calib"


def test_trajectory_files_and_readers_agree(stores, tmp_path):
    tslam, jslam, res, gt, _ = stores
    assert res.n_keyframes >= 3
    tslam.save_trajectory(tmp_path / "t.txt", res)
    JSLAM.save_trajectory(jslam, tmp_path / "j.txt", res)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    for a, b in zip(trajectory.load_traj_tum(tmp_path / "t.txt"),
                    jtraj.load_traj_tum(tmp_path / "t.txt")):
        np.testing.assert_array_equal(a, b)


def test_ate_and_its_cli_agree(stores, tmp_path, capsys):
    tslam, _, res, gt, _ = stores
    est = tmp_path / "est.txt"
    tslam.save_trajectory(est, res)
    stamps = [f"{float(t) + 0.004:.6f}" for t in OracleDataset(N_FRAMES, HW).timestamps]
    gt_path = tmp_path / "gt.txt"
    trajectory.save_traj_tum(gt_path, stamps, gt[:, :7])
    for with_scale in (True, False):
        got = trajectory.ate_rmse(est, gt_path, with_scale=with_scale)
        want = jtraj.ate_rmse(est, gt_path, with_scale=with_scale)
        assert got == want and got < 0.05
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    for a, b in zip(trajectory.umeyama_alignment(x, y), jtraj.umeyama_alignment(x, y)):
        np.testing.assert_array_equal(a, b)
    ta, tb = np.sort(rng.random(30)), np.sort(rng.random(25))
    for a, b in zip(trajectory.associate(ta, tb), jtraj.associate(ta, tb)):
        np.testing.assert_array_equal(a, b)
    capsys.readouterr()
    assert ate.main([str(est), str(gt_path)]) == jate.main([str(est), str(gt_path)])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[0])["ate_rmse"] == json.loads(out[1])["ate_rmse"]


def test_ply_agrees(stores, tmp_path):
    tslam, jslam, _, _, calib = stores
    export.save_reconstruction(tmp_path / "t.ply", tslam.keyframes, HW, 1.5, use_calib=calib)
    jexport.save_reconstruction(tmp_path / "j.ply", jslam.keyframes, HW, 1.5,
                                use_calib=calib)
    tp, tc = export.load_ply(tmp_path / "t.ply")
    jp, jc = jexport.load_ply(tmp_path / "j.ply")
    assert len(tp) == len(jp) > 0
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POINT_ATOL)
    np.testing.assert_array_equal(jexport.load_ply(tmp_path / "t.ply")[1], tc)


def test_keyframe_images_agree(stores, tmp_path):
    tslam, jslam, res, _, _ = stores
    ts = OracleDataset(N_FRAMES, HW).timestamps
    export.save_keyframes(tmp_path / "t", ts, tslam.keyframes)
    jexport.save_keyframes(tmp_path / "j", ts, jslam.keyframes)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == res.n_keyframes
    for name in names:
        np.testing.assert_array_equal(read_png(tmp_path / "t" / name),
                                      read_png(tmp_path / "j" / name))


def test_scene_json_agrees(stores, tmp_path):
    tslam, jslam, _, _, _ = stores
    renderer.export_scene_json(tslam, tmp_path / "t.json")
    jrenderer.export_scene_json(jslam, tmp_path / "j.json")
    assert (json.loads((tmp_path / "t.json").read_text())
            == json.loads((tmp_path / "j.json").read_text()))


class _Axes:
    """Records what the JAX package's render_topdown scatters."""

    def __init__(self):
        self.scattered = None

    def scatter(self, x, y, s=None, c=None, **kw):
        self.scattered = (np.asarray(x), np.asarray(y), np.asarray(c))

    def __getattr__(self, name):  # plot, set_aspect, labels, legend
        return lambda *a, **k: None


@pytest.mark.parametrize("max_points", [200_000, 1000], ids=["all", "subsampled"])
def test_topdown_draws_the_jax_selection(stores, tmp_path, monkeypatch, max_points):
    """The same points and colours as the JAX figure's scatter (the picture
    itself is the port's own rasteriser: ROADMAP Queue 3)."""
    import matplotlib.pyplot as plt

    tslam, jslam, _, _, _ = stores
    ax = _Axes()

    class _Fig:
        def __getattr__(self, name):
            return lambda *a, **k: None

    monkeypatch.setattr(plt, "subplots", lambda *a, **k: (_Fig(), ax))
    monkeypatch.setattr(plt, "close", lambda *a, **k: None)
    jrenderer.render_topdown(jslam.keyframes, tmp_path / "j.png", max_points=max_points)
    P, C = renderer.topdown_points(tslam.keyframes, max_points=max_points)
    x, y, c = ax.scattered
    assert len(P) == len(x) > 0
    np.testing.assert_allclose(P[:, 0], x, rtol=0, atol=POINT_ATOL)
    np.testing.assert_allclose(P[:, 2], y, rtol=0, atol=POINT_ATOL)
    np.testing.assert_array_equal(np.clip(C, 0, 1), c)

    E = tslam.graph.n_edges
    edges = list(zip(tslam.graph.ii[:E].tolist(), tslam.graph.jj[:E].tolist()))
    renderer.render_topdown(tslam.keyframes, tmp_path / "t.png", max_points=max_points,
                            edges=edges)
    img = read_png(tmp_path / "t.png")
    assert img.shape == (renderer.CANVAS, renderer.CANVAS, 3)
    assert (img == renderer.TRAJ_RGB.astype(np.uint8)).all(axis=-1).sum() >= 25
    assert (img != 255).any(axis=-1).sum() > 100


def test_frustum_points_agree():
    T = np.array([0.1, -0.2, 0.3, 0.1, 0.2, -0.1, 0.97, 1.3], np.float32)
    T[3:7] /= np.linalg.norm(T[3:7])
    got = renderer.frustum_points(T, scale=0.2)
    want = jrenderer.frustum_points(T, scale=0.2)
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-6)
