"""The port's CLI (``mast3r_slam_tpu_torch.slam.run``) against the JAX CLI on
one synthetic TUM sequence, and its ``--set`` parsing.

tests/test_eval_protocol.py's sequence (24 constant-gray 480x640 PNGs
along an arc, rgb.txt, groundtruth.txt), its oracle model injected through
each CLI's ``build_slam``, and its CPU-time cut (the datasets resize to 64
long side, 48x64).  Both CLIs run eval_no_calib and eval_calib (fr1
undistortion, K_frame).  They must keep the same keyframes (timestamps),
write the same files, and their trajectories agree within 2e-4 (the pose
tolerance of tests/test_torch_slam_e2e.py, whose solves these are).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mast3r_slam_tpu.data import dataloader as jdl
from mast3r_slam_tpu.slam import run as jrun
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu_torch.data import dataloader as tdl
from mast3r_slam_tpu_torch.eval import ate as tate
from mast3r_slam_tpu_torch.eval.trajectory import load_traj_tum
from mast3r_slam_tpu_torch.slam import run as trun

from oracle import PlaneScene, arc_trajectory
from test_eval_protocol import N_RAW_FRAMES, SEQ, TumOracleModel, _write_tum_sequence
from test_torch_common import CPU, TorchOracleModel

POSE_ATOL = 2e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oracle(dataset, gt):
    (h, w), _ = dataset.get_img_shape()
    scene = PlaneScene((int(h), int(w)))
    if dataset.has_calib():
        scene.K = np.asarray(dataset.camera_intrinsics.K_frame, dtype=np.float32)
    model = TumOracleModel(scene, gt, noise=0.002)
    model.img_hw = (int(h), int(w))
    return model


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    gt = arc_trajectory(N_RAW_FRAMES, radius=0.8, max_angle=3.0)
    return _write_tum_sequence(tmp_path_factory.mktemp("tum"), gt), gt


def _run_both(seq, gt, config, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    orig_init = jdl.MonocularDataset.__init__

    def small_init(self):
        orig_init(self)
        self.img_size = 64

    monkeypatch.setattr(jdl.MonocularDataset, "__init__", small_init)
    monkeypatch.setattr(tdl.MonocularDataset, "img_size", 64)

    def jax_build(cfg, dataset, **kw):
        import jax.numpy as jnp

        model = _oracle(dataset, gt)
        K = None
        if cfg["use_calib"] and dataset.has_calib():
            K = jnp.asarray(dataset.camera_intrinsics.K_frame, jnp.float32)
        return JSLAM(model, cfg, model.img_hw, K=K)

    real_build = trun.build_slam

    def port_build(cfg, dataset, **kw):
        kw["model"] = TorchOracleModel(_oracle(dataset, gt))
        return real_build(cfg, dataset, **kw)

    monkeypatch.setattr(jrun, "build_slam", jax_build)
    monkeypatch.setattr(trun, "build_slam", port_build)
    jres = jrun.main(["--dataset", str(seq), "--config", config, "--save-as", "jax",
                      "--no-viz"])
    tres = trun.main(["--dataset", str(seq), "--config", config, "--save-as", "port",
                      "--device", CPU, "--trace", str(tmp_path / "trace")])
    return jres, tres


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*"))


@pytest.mark.parametrize("config", ["eval_no_calib", "eval_calib"])
def test_port_cli_equals_the_jax_cli(sequence, tmp_path, monkeypatch, config):
    seq, gt = sequence
    jres, tres = _run_both(seq, gt, config, tmp_path, monkeypatch)
    assert tres.n_keyframes == jres.n_keyframes >= 3
    assert tres.keyframe_timestamps == jres.keyframe_timestamps
    assert tres.frame_timestamps == jres.frame_timestamps
    assert len(tres.frame_timestamps) == N_RAW_FRAMES // 2 and tres.n_reloc == 0
    logs = tmp_path / "logs"
    assert _files(logs / "port") == _files(logs / "jax")
    t_port, p_port, q_port = load_traj_tum(logs / "port" / f"{SEQ}.txt")
    t_jax, p_jax, q_jax = load_traj_tum(logs / "jax" / f"{SEQ}.txt")
    np.testing.assert_array_equal(t_port, t_jax)
    np.testing.assert_allclose(p_port, p_jax, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(q_port, q_jax, rtol=0, atol=POSE_ATOL)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0  # --trace
    ate = tate.main([str(logs / "port" / f"{SEQ}.txt"), str(seq / "groundtruth.txt")])
    assert ate is not None and ate < 0.06  # tests/test_eval_protocol.py's bound


class _Stop(Exception):
    pass


def _parsed_cfg(monkeypatch, tmp_path, sets):
    """The config ``main`` hands to build_slam under ``--set sets``."""
    seen = {}

    def spy(cfg, dataset, **kw):
        seen["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(trun, "build_slam", spy)
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", str(tmp_path), "--device", CPU]
    for s in sets:
        argv += ["--set", s]
    (tmp_path / "a.png").write_bytes(b"")  # an RGB folder of one file
    with pytest.raises(_Stop):
        trun.main(argv)
    return seen["cfg"]


def test_set_overrides_are_yaml_scalars(monkeypatch, tmp_path):
    cfg = _parsed_cfg(monkeypatch, tmp_path, [
        "tracking.filtering_mode=best_score", "matching.max_iter=4",
        "tracking.Q_conf=1.0e+9", "tracking.C_conf=1e9", "single_thread=yes",
        "retrieval.k=null", "engine.new_key=[1, 2.5, x]"])
    assert cfg["tracking"]["filtering_mode"] == "best_score"
    assert cfg["matching"]["max_iter"] == 4 and type(cfg["matching"]["max_iter"]) is int
    assert cfg["tracking"]["Q_conf"] == 1e9
    assert cfg["tracking"]["C_conf"] == "1e9"  # YAML 1.1: no dot, a string
    assert cfg["single_thread"] is True and cfg["retrieval"]["k"] is None
    assert cfg["engine"]["new_key"] == [1, 2.5, "x"]
    assert cfg["matching"]["radius"] == 3  # the rest of the section stays


@pytest.mark.parametrize("bad", ["no_equals_sign", "tracking.Q_conf=", "a.b={c: 1}",
                                 "a.b=&x 1", "a.b=[1, 2"])
def test_set_rejects_malformed(monkeypatch, tmp_path, bad):
    with pytest.raises(SystemExit):
        _parsed_cfg(monkeypatch, tmp_path, [bad])


def test_unported_flags_and_no_card_raise(monkeypatch, tmp_path):
    with pytest.raises(NotImplementedError, match="item 11"):
        trun.main(["--dataset", str(tmp_path), "--viz-ws", "8765", "--device", CPU])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main(["--dataset", str(tmp_path)])


def test_module_entry_points_run():
    env = dict(os.environ, PYTHONPATH=ROOT)
    for mod in ("mast3r_slam_tpu_torch.slam.run", "mast3r_slam_tpu_torch.eval.ate"):
        out = subprocess.run([sys.executable, "-m", mod, "--help"], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and "usage" in out.stdout, out.stderr
