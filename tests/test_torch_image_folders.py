"""Image folders without cv2: the port's readers tell JPEG from PNG by the
file's first bytes, as cv2 does, and decode both themselves.

``RGBFiles`` over mixed ``.jpg``/``.png`` folders against the JAX package's
loader (``cv2.imread``), frame for frame and exactly; the readers with cv2
blocked; and the slice as a whole: the port's CLI against the JAX CLI on a
JPEG folder (baseline and progressive frames, one PNG), at
``tests/test_torch_cli.py``'s scale and tolerance, the port's run with cv2
blocked.
"""

import base64
import hashlib
import json
import pathlib
import sys

import cv2
import numpy as np
import pytest

from mast3r_slam_tpu.data import dataloader as jdl
from mast3r_slam_tpu.slam import run as jrun
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu_torch.data import dataloader as tdl
from mast3r_slam_tpu_torch.data import png
from mast3r_slam_tpu_torch.eval import ate as tate
from mast3r_slam_tpu_torch.eval.trajectory import load_traj_tum
from mast3r_slam_tpu_torch.serve import server
from mast3r_slam_tpu_torch.slam import run as trun

import torch_jpeg_encoders as enc
from oracle import OracleModel, arc_trajectory
from test_torch_cli import POSE_ATOL, _files, _oracle
from test_torch_common import CPU, TorchOracleModel
from test_torch_png_variants import variant


def _frame(i, hw=(48, 64)):
    rng = np.random.default_rng(i)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    a = np.stack([128 + 90 * np.sin(x / (5.0 + i)), 128 + 90 * np.cos(y / 4.0),
                  (2 * x + 3 * y + 17 * i) % 256], -1)
    return np.clip(a + rng.normal(0, 10, a.shape), 0, 255).astype(np.uint8)


def _write(path, bgr, kind):
    """A frame as cv2 writes it: baseline or progressive JPEG (4:2:0 with
    restarts, or gray), or a PNG variant cv2 cannot write."""
    if kind == "baseline":
        ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 90])
    elif kind == "progressive":
        ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                             cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
    elif kind == "gray-progressive":
        ok, buf = cv2.imencode(".jpg", bgr[..., 1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    elif kind == "png":
        ok, buf = cv2.imencode(".png", bgr)
    elif kind.startswith("arithmetic"):  # the test-side QM encoder (SOF9, SOF10)
        path.write_bytes(enc.arithmetic_jpeg(bgr[..., ::-1], quality=90, restart=3,
                                             progressive=kind.endswith("progressive")))
        return
    elif kind.startswith("lossless"):  # SOF3: gray, or three components read as RGB
        planes = (bgr[..., 1] if kind == "lossless-gray"
                  else [bgr[..., 2], bgr[..., 1], bgr[..., 0]])
        path.write_bytes(enc.lossless_jpeg(planes, predictor=1 + len(path.name) % 7,
                                           restart_rows=4))
        return
    else:  # a PNG variant from the test writer: "ctype-depth-interlace"
        c, d, i = map(int, kind.split("-"))
        path.write_bytes(variant(c, d, i, bgr.shape[:2], False, seed=len(path.name)))
        return
    assert ok
    path.write_bytes(buf.tobytes())


FOLDERS = {
    "jpeg": ["baseline", "progressive", "baseline", "gray-progressive"],
    "mixed": ["baseline", "png", "progressive", "2-16-0", "3-4-1", "gray-progressive",
              "0-16-1"],
    "progressive": ["progressive"] * 3,
    "arithmetic": ["arithmetic", "arithmetic-progressive", "baseline", "arithmetic",
                   "lossless-rgb"],
}


@pytest.mark.parametrize("folder", FOLDERS)
def test_rgbfiles_reads_as_the_jax_loader(tmp_path, monkeypatch, folder):
    """The port's ``RGBFiles`` keeps the JAX package's globs and order, and
    its frames equal cv2's; with cv2 blocked they read the same."""
    seq = tmp_path / folder
    seq.mkdir()
    for i, kind in enumerate(FOLDERS[folder]):
        ext = "png" if kind[0].isdigit() or kind == "png" else "jpg"
        _write(seq / f"frame{i + 8}.{ext}", _frame(i), kind)
    got, want = tdl.load_dataset(str(seq)), jdl.load_dataset(str(seq))
    assert type(got).__name__ == type(want).__name__ == "RGBFiles"
    assert [str(p) for p in got.rgb_files] == [str(p) for p in want.rgb_files]
    assert got.timestamps == want.timestamps and len(got) == len(FOLDERS[folder])
    assert got.get_img_shape() == want.get_img_shape()
    frames = [want[i] for i in range(len(want))]
    monkeypatch.setitem(sys.modules, "cv2", None)
    for i, (tw, b) in enumerate(frames):
        tg, a = got[i]
        assert tg == tw
        np.testing.assert_array_equal(a, b)


def test_the_format_is_told_by_the_first_bytes(tmp_path, monkeypatch):
    """A JPEG named .png and a PNG named .jpg read as cv2 reads them: by
    their contents, not their names."""
    bgr = _frame(3)
    _write(tmp_path / "jpeg.png", bgr, "progressive")
    _write(tmp_path / "png.jpg", bgr, "3-8-1")
    want = [cv2.cvtColor(cv2.imread(str(tmp_path / n)), cv2.COLOR_BGR2RGB)
            for n in ("jpeg.png", "png.jpg")]
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name, w in zip(("jpeg.png", "png.jpg"), want):
        np.testing.assert_array_equal(png.imread_rgb(tmp_path / name), w)


@pytest.mark.parametrize("kind", ["baseline", "gray-progressive"])
def test_imread_gray_reads_a_gray_jpeg_and_refuses_a_colour_one(tmp_path, kind):
    """``imread_gray`` (EuRoC's read) of a one-component JPEG equals
    ``cv2.imread(..., IMREAD_GRAYSCALE)``, and so does its read of a colour
    JPEG, which it once refused (Queue 1 item 15): the Y plane, with cv2
    blocked."""
    bgr = _frame(5)
    _write(tmp_path / "g.jpg", bgr[..., :1].repeat(3, -1) if kind == "baseline" else bgr,
           "gray-progressive")
    _write(tmp_path / "c.jpg", bgr, kind if kind == "baseline" else "progressive")
    want = [cv2.imread(str(tmp_path / n), cv2.IMREAD_GRAYSCALE) for n in ("g.jpg", "c.jpg")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        for name, w in zip(("g.jpg", "c.jpg"), want):
            np.testing.assert_array_equal(png.imread_gray(tmp_path / name), w)


EUROC_SENSOR = """sensor_type: camera
resolution: [64, 48]
camera_model: pinhole
intrinsics: [458.654, 457.296, 32.0, 24.0]
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""
# the colour frames of a EuRoC folder: what cv2.imread(..., IMREAD_GRAYSCALE)
# converts in the JAX loader (PNG variants "ctype-depth-interlace")
EUROC_KINDS = ["baseline", "progressive", "partial-progressive", "gray-progressive",
               "2-8-0", "2-16-1", "3-8-1", "6-8-0", "6-16-0", "4-8-1", "cmyk", "ycck",
               "lossless-gray", "arithmetic", "arithmetic-progressive", "lossless-gray"]


def _euroc_frame(path, i, kind):
    bgr = _frame(i)
    if kind == "partial-progressive":  # the first three scans: smoothed
        ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        data = buf.tobytes()
        at = [k for k in range(len(data) - 1) if data[k:k + 2] == b"\xff\xda"][3]
        path.write_bytes(data[:at] + b"\xff\xd9")
    elif kind in ("cmyk", "ycck"):
        from PIL import Image

        buf = __import__("io").BytesIO()
        Image.fromarray(bgr[..., ::-1]).convert("CMYK").save(buf, "JPEG", quality=85)
        data = buf.getvalue()
        at = data.index(b"Adobe") + 11
        path.write_bytes(data[:at] + bytes([2 if kind == "ycck" else 0]) + data[at + 1:])
    else:
        _write(path, bgr, kind)


def test_euroc_reads_colour_frames_as_the_jax_loader(tmp_path, monkeypatch):
    """EuRoC's read (``cv2.imread(..., IMREAD_GRAYSCALE)`` in the JAX
    loader, replicated to RGB) on a EuRoC folder of colour frames: JPEG
    baseline, progressive and cut short, colour, palette, RGBA and 16-bit
    PNGs, CMYK and YCCK, arithmetic-coded colour (SOF9, SOF10) and lossless
    gray frames: the port's ``EurocDataset.read_img`` equals the JAX one
    frame for frame, with cv2 blocked (once refused, Queue 1 items 15 and
    13c)."""
    cam = tmp_path / "euroc" / "MH_colour" / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    rows = ["#timestamp [ns],filename"]
    for i, kind in enumerate(EUROC_KINDS):
        ts = 1403636579763555584 + 50_000_000 * i
        name = f"{ts}.{'png' if kind[0].isdigit() else 'jpg'}"
        _euroc_frame(cam / "data" / name, i, kind)
        rows.append(f"{ts},{name}")
    (cam / "data.csv").write_text("\n".join(rows) + "\n")
    (cam / "sensor.yaml").write_text(EUROC_SENSOR)
    seq = str(cam.parents[1])
    got, want = tdl.load_dataset(seq), jdl.load_dataset(seq)
    assert type(got).__name__ == type(want).__name__ == "EurocDataset"
    assert got.timestamps == want.timestamps and len(got) == len(EUROC_KINDS)
    frames = [want.read_img(i) for i in range(len(want))]
    assert not all((f[..., 0] == f[..., 0].flat[0]).all() for f in frames)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for i, b in enumerate(frames):
        a = got.read_img(i)
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (48, 64, 3)
        np.testing.assert_array_equal(a, b, err_msg=EUROC_KINDS[i])


N_FRAMES = 12
KINDS = ["baseline", "progressive", "png"]


def _jpeg_folder(root, gt):
    """The oracle's constant-gray 480x640 frames (its frame ids) as cv2
    writes them: JPEG baseline and progressive in turn, every third frame a
    PNG; a groundtruth file at the folder loader's timestamps (i / 30)."""
    seq = root / "frames"
    seq.mkdir()
    lines = []
    for i in range(N_FRAMES):
        img = (OracleModel.image_for_frame(i, (480, 640)) * 255).astype(np.uint8)
        kind = KINDS[i % 3]
        _write(seq / f"{i:03d}.{'png' if kind == 'png' else 'jpg'}", img, kind)
        lines.append(f"{i / 30.0 + 0.004:.6f} " + " ".join(f"{x:.6f}" for x in gt[i, :7]))
    gt_path = root / "groundtruth.txt"
    gt_path.write_text("\n".join(lines) + "\n")
    return seq, gt_path


def test_port_cli_equals_the_jax_cli_on_a_jpeg_folder(tmp_path, monkeypatch):
    """Both CLIs over the same JPEG folder under eval_no_calib with every
    frame read (subsample 1), the port's with cv2 blocked: the same keyframes and files, trajectories
    within tests/test_torch_cli.py's 2e-4, the ATE within its bound."""
    gt = arc_trajectory(N_FRAMES, radius=0.8, max_angle=3.0)
    seq, gt_path = _jpeg_folder(tmp_path, gt)
    monkeypatch.chdir(tmp_path)
    orig_init = jdl.MonocularDataset.__init__

    def small_init(self):
        orig_init(self)
        self.img_size = 64

    monkeypatch.setattr(jdl.MonocularDataset, "__init__", small_init)
    monkeypatch.setattr(tdl.MonocularDataset, "img_size", 64)

    def jax_build(cfg, dataset, **kw):
        model = _oracle(dataset, gt)
        return JSLAM(model, cfg, model.img_hw)

    real_build = trun.build_slam

    def port_build(cfg, dataset, **kw):
        kw["model"] = TorchOracleModel(_oracle(dataset, gt))
        return real_build(cfg, dataset, **kw)

    monkeypatch.setattr(jrun, "build_slam", jax_build)
    monkeypatch.setattr(trun, "build_slam", port_build)
    args = ["--dataset", str(seq), "--config", "eval_no_calib", "--set", "dataset.subsample=1"]
    jres = jrun.main(args + ["--save-as", "jax", "--no-viz"])
    monkeypatch.setitem(sys.modules, "cv2", None)
    tres = trun.main(args + ["--save-as", "port", "--device", CPU])
    assert tres.n_keyframes == jres.n_keyframes >= 3
    assert tres.keyframe_timestamps == jres.keyframe_timestamps
    assert tres.frame_timestamps == jres.frame_timestamps
    assert len(tres.frame_timestamps) == N_FRAMES and tres.n_reloc == 0
    logs = tmp_path / "logs"
    assert _files(logs / "port") == _files(logs / "jax")
    t_port, p_port, q_port = load_traj_tum(logs / "port" / "frames.txt")
    t_jax, p_jax, q_jax = load_traj_tum(logs / "jax" / "frames.txt")
    np.testing.assert_array_equal(t_port, t_jax)
    np.testing.assert_allclose(p_port, p_jax, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(q_port, q_jax, rtol=0, atol=POSE_ATOL)
    err = tate.main([str(logs / "port" / "frames.txt"), str(gt_path)])
    assert err is not None and err < 0.06  # tests/test_eval_protocol.py's bound


DATA = pathlib.Path(__file__).resolve().parent / "data"
DIGESTS = json.loads((DATA / "image_fixtures.json").read_text())


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_committed_image_fixtures_agree_with_cv2(name):
    """The files ``chip_smoke.py`` phases 12, 15 and 16 decode on the card's
    host (no cv2 there; ``scripts/make_image_fixtures.py`` wrote them):
    their committed digests are still cv2's colour and gray decodes here,
    and the port's readers and payload decoder give those bytes.  A null
    digest is a read cv2 returns nothing for (lossless JPEG whose read
    would need a colour conversion): the port's read raises ValueError."""
    path = DATA / name
    want = cv2.imread(str(path))
    if DIGESTS[name]["sha256"] is None:
        assert want is None
        for read in (png.imread_rgb, lambda p: server.decode_image_payload(
                base64.b64encode(p.read_bytes()).decode())):
            with pytest.raises(ValueError, match="cv2 returns nothing for it"):
                read(path)
    else:
        want = cv2.cvtColor(want, cv2.COLOR_BGR2RGB)
        assert list(want.shape) == DIGESTS[name]["shape"]
        assert hashlib.sha256(want.tobytes()).hexdigest() == DIGESTS[name]["sha256"]
        got = png.imread_rgb(path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["sha256"]
        payload = server.decode_image_payload(base64.b64encode(path.read_bytes()).decode())
        np.testing.assert_array_equal(payload, want.astype(np.float32) / 255.0)
    gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if DIGESTS[name]["gray_sha256"] is None:
        assert gray is None
        with pytest.raises(ValueError, match="cv2 returns nothing for it"):
            png.imread_gray(path)
    else:
        assert hashlib.sha256(gray.tobytes()).hexdigest() == DIGESTS[name]["gray_sha256"]
        got = png.imread_gray(path)
        assert list(got.shape) == DIGESTS[name]["shape"][:2]
        assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["gray_sha256"]
