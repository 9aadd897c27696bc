"""Checkpoints across the two packages, resume and relocalisation after a
resume in the port, and the port's parameter npz read by the JAX package.

The checkpoint is npz format v2 with the JAX package's keys: a port
checkpoint loads into the JAX engine and the JAX engine's checkpoint of
that state loads back into a fresh port engine, both with every array
equal (the keyframe store, the edges, the retrieval inverted file); the
same for a paged store (``engine.device_keyframes``), whose newest
keyframes load into device slots and older ones into host buffers, and
whose recycled edge rows are queued for reuse again on load.  Resume
(tests/test_checkpoint.py's scene and bounds): the restored store equals
the saved one bit for bit, and the resumed run tracks the ground truth
within 0.04 m; relocalisation after a resume succeeds within 0.15 m.
"""

import jax
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu.models import io as jio
from mast3r_slam_tpu.retrieval import RetrievalDatabase as JRetrievalDatabase
from mast3r_slam_tpu.retrieval.asmk import ASMKSettings as JASMKSettings
from mast3r_slam_tpu.retrieval.head import RetrievalHeadSettings as JHeadSettings
from mast3r_slam_tpu.retrieval.head import init_head_params as jinit_head_params
from mast3r_slam_tpu.slam.checkpoint import load_state as jload_state
from mast3r_slam_tpu.slam.checkpoint import save_state as jsave_state
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.eval.trajectory import umeyama_alignment
from mast3r_slam_tpu_torch.models import mast3r as TM
from mast3r_slam_tpu_torch.models.convert import (params_from_jax, retrieval_from_jax,
                                                  save_params)
from mast3r_slam_tpu_torch.retrieval import (ASMKSettings, RetrievalDatabase,
                                             RetrievalHeadSettings)
from mast3r_slam_tpu_torch.slam.checkpoint import load_state, save_state
from mast3r_slam_tpu_torch.slam.frame import Mode
from mast3r_slam_tpu_torch.slam.pipeline import SLAM

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_reloc_e2e import teleport_trajectory
from test_torch_common import CPU, TorchOracleModel, n
from test_torch_paging import N_FRAMES as PAGED_FRAMES
from test_torch_paging import _engine_cfg, _force_keyframes

HW = (48, 64)


def _cfg(load, buffers=32):
    cfg = load("base")
    cfg["single_thread"] = True
    cfg["engine"]["keyframe_buffer"] = buffers
    cfg["engine"]["edge_buffer"] = buffers
    cfg["reloc"]["strict"] = False
    return cfg


def _retrieval(feat_dim):
    """The same head and codebook for both packages (f32 leaves)."""
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jinit_head_params(jax.random.key(0), feat_dim, hdims=(8,)))
    centroids = np.asarray(jax.random.normal(jax.random.key(1), (64, 8)) * 0.3, np.float32)

    def port():
        tparams, tcent = retrieval_from_jax(params, centroids)
        return RetrievalDatabase(tparams, tcent, RetrievalHeadSettings(nfeat=8),
                                 ASMKSettings(max_images=64), device=CPU)

    def jax_db():
        return JRetrievalDatabase(params, centroids, JHeadSettings(nfeat=8),
                                  JASMKSettings(capacity=64 * 8, max_images=64))

    return port, jax_db


def _store(slam):
    """Every array a checkpoint carries, as numpy."""
    kf, g = slam.keyframes, slam.graph
    k, E = len(kf), g.n_edges
    out = {"mode": int(slam.mode), "frame_id": np.asarray(kf.frame_id[:k]),
           "edge_ii": np.asarray(g.ii[:E]), "edge_jj": np.asarray(g.jj[:E]),
           "edge_live": np.asarray(g.edge_live[:E])}
    for name in ("T_WC", "n_fused", "n_updates", "score"):
        out[name] = n(getattr(kf, name)[:k])
    for name in ("idx_ii2jj", "idx_jj2ii", "valid_match_j", "valid_match_i",
                 "Q_ii2jj", "Q_jj2ii"):
        out[name] = n(getattr(g, name)[:E])
    for i in range(k):
        X, C = (kf.pointmap_np(i) if hasattr(kf, "pointmap_np")
                else (n(kf.X[i]), n(kf.C[i])))
        out[f"X{i}"], out[f"C{i}"] = np.asarray(X), np.asarray(C)
        out[f"uimg{i}"] = np.asarray(kf.uimgs[i])
    out["feat"], out["pos"] = n(kf.feat[:k]), n(kf.pos[:k])
    ivf = slam.retrieval.ivf
    vecs, words, imids = ivf.entries()
    out.update(ivf_vecs=np.asarray(vecs).view(np.int32), ivf_words=words, ivf_imids=imids,
               ivf_n=np.asarray([ivf.n_images, ivf.n_entries, slam.retrieval.kf_counter]),
               ivf_norm=n(ivf.norm_factor)[:ivf.n_images])
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_checkpoints_load_across_the_packages(tmp_path):
    gt = arc_trajectory(12, radius=0.6, max_angle=2.5)
    oracle = OracleModel(PlaneScene(HW), gt, noise=0.002)
    port_db, jax_db = _retrieval(oracle.feat_dim)
    cfg = _cfg(load_config)
    cfg["engine"]["resize"] = 64  # keyframes keep their 48x64 images
    tslam = SLAM(TorchOracleModel(oracle), cfg, HW, retrieval=port_db(), device=CPU)
    tslam.run(OracleDataset(12, HW), verbose=False)
    assert len(tslam.keyframes) >= 3 and tslam.retrieval.ivf.n_entries > 0
    want = _store(tslam)

    save_state(tmp_path / "port.npz", tslam)
    jslam = JSLAM(oracle, _cfg(jload_config), HW, retrieval=jax_db())
    jload_state(tmp_path / "port.npz", jslam)
    _assert_same(_store(jslam), want)

    jsave_state(tmp_path / "jax.npz", jslam)
    fresh = SLAM(TorchOracleModel(oracle), _cfg(load_config), HW, retrieval=port_db(),
                 device=CPU)
    load_state(tmp_path / "jax.npz", fresh)
    _assert_same(_store(fresh), want)

    # loading moves the pointmap versions and the generation: no cached
    # gather or backend snapshot from before survives it
    ver, gen = tslam.keyframes.pm_version.copy(), tslam.keyframes.generation
    load_state(tmp_path / "jax.npz", tslam)
    k = len(tslam.keyframes)
    assert (tslam.keyframes.pm_version[:k] > ver[:k]).all()
    assert tslam.keyframes.generation > gen
    assert (tslam.graph._stamp_f == -1).all() and (tslam.graph._stamp_b == -1).all()


def test_a_wrong_image_size_is_refused(tmp_path):
    gt = arc_trajectory(2)
    oracle = OracleModel(PlaneScene(HW), gt)
    slam = SLAM(TorchOracleModel(oracle), _cfg(load_config), HW, device=CPU)
    save_state(tmp_path / "s.npz", slam)
    other = SLAM(TorchOracleModel(OracleModel(PlaneScene((32, 48)), gt)), _cfg(load_config),
                 (32, 48), device=CPU)
    with pytest.raises(ValueError, match="image size"):
        load_state(tmp_path / "s.npz", other)


def test_resume_after_a_checkpoint(tmp_path):
    n_frames = 16
    gt = arc_trajectory(n_frames, radius=0.6, max_angle=2.5)
    model = TorchOracleModel(OracleModel(PlaneScene(HW), gt, noise=0.002))
    cfg = _cfg(load_config)
    ds = OracleDataset(n_frames, HW)
    first = SLAM(model, cfg, HW, device=CPU)
    half, last = n_frames // 2, None
    for i in range(half):
        t, img = ds[i]
        last = first.process_frame(i, t, img, last_T_WC=last).T_WC
    save_state(tmp_path / "state.npz", first)

    resumed = SLAM(model, cfg, HW, device=CPU)
    load_state(tmp_path / "state.npz", resumed)
    k = len(first.keyframes)
    assert len(resumed.keyframes) == k and resumed.graph.n_edges == first.graph.n_edges
    for name in ("T_WC", "X", "C", "n_fused", "feat"):
        assert torch.equal(getattr(resumed.keyframes, name)[:k],
                           getattr(first.keyframes, name)[:k]), name
    poses = []
    for i in range(half, n_frames):
        t, img = ds[i]
        fr = resumed.process_frame(i, t, img, last_T_WC=last)
        last = fr.T_WC
        poses.append(n(fr.T_WC))
    est = np.stack(poses)[:, :3].astype(np.float64)
    s, R, t_al = umeyama_alignment(est, gt[half:, :3])
    aligned = (s * (R @ est.T)).T + t_al
    err = float(np.sqrt(np.mean(np.linalg.norm(aligned - gt[half:, :3], axis=-1) ** 2)))
    assert err < 0.04, err


def test_relocalisation_after_a_resume(tmp_path):
    gt = teleport_trajectory()
    n_track, n_all = 14, len(gt)
    oracle = OracleModel(PlaneScene(HW), gt, noise=0.002)
    port_db, _ = _retrieval(oracle.feat_dim)
    model = TorchOracleModel(oracle)
    cfg = _cfg(load_config, buffers=64)
    ds = OracleDataset(n_all, HW)
    before = SLAM(model, cfg, HW, retrieval=port_db(), device=CPU)
    last = None
    for i in range(n_track):
        t, img = ds[i]
        last = before.process_frame(i, t, img, last_T_WC=last).T_WC
    assert before.retrieval.ivf.n_images >= 2
    save_state(tmp_path / "mid.npz", before)

    after = SLAM(model, cfg, HW, retrieval=port_db(), device=CPU)
    assert after.retrieval.ivf.n_images == 0
    load_state(tmp_path / "mid.npz", after)
    assert after.retrieval.ivf.n_images == before.retrieval.ivf.n_images
    assert after.retrieval.ivf.n_entries == before.retrieval.ivf.n_entries
    for i in range(n_track, n_all):
        t, img = ds[i]
        last = after.process_frame(i, t, img, last_T_WC=last).T_WC
    assert after.n_reloc >= 1 and after.n_reloc_success >= 1
    assert after.mode == Mode.TRACKING
    post = np.stack([p for _, p in after.frame_log[-3:]])[:, :3]
    assert np.linalg.norm(post - gt[-3:, :3], axis=-1).max() < 0.15


def test_port_params_npz_reads_back_in_the_jax_package(tmp_path):
    """save_params (the port) -> load_params (the JAX package): the stacked
    tree ``init_params`` builds, every leaf bit for bit, the bf16 trunk
    weights included (checked back through ``params_from_jax``)."""
    import dataclasses

    cfg = dataclasses.replace(TM.VIT_TINY_TEST, dtype=torch.bfloat16)
    port = TM.init_params(cfg, seed=0)
    assert port["enc_blocks"][0]["attn"]["qkv"]["w"].dtype == torch.bfloat16
    save_params(tmp_path / "p.npz", port)
    back = jio.load_params(tmp_path / "p.npz")
    assert back["enc_blocks"]["attn"]["qkv"]["w"].dtype == jax.numpy.bfloat16
    assert back["enc_blocks"]["attn"]["qkv"]["w"].shape[0] == cfg.enc_depth
    assert back["head1"]["dpt"]["rn1"]["w"].shape[:2] == (3, 3)  # HWIO
    again = params_from_jax(jax.tree.map(np.asarray, back))
    flat = lambda node, pre="": (
        [x for k, v in node.items() for x in flat(v, f"{pre}/{k}")] if isinstance(node, dict)
        else [x for i, v in enumerate(node) for x in flat(v, f"{pre}/{i}")]
        if isinstance(node, list) else [(pre, node)])
    got, want = dict(flat(again)), dict(flat(port))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _paged(slam):
    """A paged engine's checkpointed state, every keyframe's rows read
    through its slot or host buffers."""
    kf, g = slam.keyframes, slam.graph
    k, E = len(kf), g.n_edges
    out = {"frame_id": np.asarray(kf.frame_id[:k]), "T_WC": n(kf.T_WC[:k]),
           "n_fused": n(kf.n_fused[:k]), "edge_ii": np.asarray(g.ii[:E]),
           "edge_jj": np.asarray(g.jj[:E]), "edge_live": np.asarray(g.edge_live[:E])}
    for name in ("idx_ii2jj", "valid_match_j", "Q_jj2ii"):
        out[name] = n(getattr(g, name)[:E])
    for i in range(k):
        out[f"pm{i}"] = np.concatenate([np.asarray(a).reshape(-1) for a in kf.pointmap_np(i)])
        out[f"ft{i}"] = np.concatenate([np.asarray(a, np.float32).reshape(-1)
                                        for a in kf.feat_np(i)])
    return out


@pytest.fixture(scope="module")
def paged_run():
    """The port's paged engine of tests/test_torch_paging.py: 7 keyframes in
    4 slots, old edges recycled."""
    oracle = OracleModel(PlaneScene(HW), arc_trajectory(PAGED_FRAMES, radius=0.6,
                                                        max_angle=0.5), noise=0.002)
    slam = SLAM(TorchOracleModel(oracle), _engine_cfg(load_config, 4), HW, device=CPU)
    _force_keyframes(slam)
    slam.run(OracleDataset(PAGED_FRAMES, HW), verbose=False)
    kf = slam.keyframes
    assert len(kf) > kf.dcap and kf.n_evictions > 0 and slam.graph._free_edge_rows
    return oracle, slam


def test_paged_checkpoints_load_across_the_packages(tmp_path, paged_run):
    """Port (paged) -> JAX (paged) -> port (paged, and unpaged): every
    keyframe's rows, the poses and the edges equal; the newest keyframes
    resident in slots 0.., the older ones evicted."""
    oracle, tslam = paged_run
    want = _paged(tslam)
    save_state(tmp_path / "port.npz", tslam)
    jslam = JSLAM(oracle, _engine_cfg(jload_config, 4), HW)
    jload_state(tmp_path / "port.npz", jslam)
    _assert_same(_paged(jslam), want)
    jsave_state(tmp_path / "jax.npz", jslam)
    for budget in (4, 0):
        fresh = SLAM(TorchOracleModel(oracle), _engine_cfg(load_config, budget), HW,
                     device=CPU)
        load_state(tmp_path / "jax.npz", fresh)
        _assert_same(_paged(fresh), want)
        kf, k = fresh.keyframes, len(fresh.keyframes)
        m = min(k, kf.dcap)
        np.testing.assert_array_equal(kf.slot_of[:k],
                                      [-1] * (k - m) + list(range(m)))
        if budget:
            np.testing.assert_array_equal(kf.slot_of[:k], jslam.keyframes.slot_of[:k])


def test_the_edge_freelist_is_seeded_on_load(tmp_path, paged_run):
    """A checkpoint holds recycled rows (dead, ii == jj == 0) but no
    freelist: loading queues them for reuse again, so the next edges take
    them and the next recycle does not count them twice (the JAX package
    loads them as dead rows outside its freelist)."""
    oracle, tslam = paged_run
    g = tslam.graph
    save_state(tmp_path / "p.npz", tslam)
    fresh = SLAM(TorchOracleModel(oracle), _engine_cfg(load_config, 4), HW, device=CPU)
    load_state(tmp_path / "p.npz", fresh)
    f = fresh.graph
    assert f._free_edge_rows == g._free_edge_rows and f.n_edges == g.n_edges
    rows = f._take_edge_rows(1)
    assert rows[0] == g._free_edge_rows[0] and f.n_edges == g.n_edges
    f._free_edge_rows.insert(0, int(rows[0]))
    f._recycle_old_edges(len(fresh.keyframes) - 2)
    assert f.n_edges_recycled == 0  # nothing new was old enough
