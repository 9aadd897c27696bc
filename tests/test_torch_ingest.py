"""The port's ingest against the JAX package's: the 512 preprocess on the
host library, PNG files without cv2, the YAML subset, the dataset loaders'
sniffing and frames, the undistortion, and the prefetch thread.

Tolerances: the 512 resize at most 1 uint8 level (both libraries build
from one source with one set of flags; exact where the builds match, as
here); PNGs bit for bit against ``cv2.imread``; the YAML reader equal to
``yaml.safe_load``; ``K`` and ``K_frame`` within 1e-9 relative and the
undistortion maps within 1e-3 px of OpenCV's; remapped images within 1
level at the 99th percentile (``tests/test_native.py``'s bound: cv2's
remap interpolates in fixed point).
"""

import struct
import sys
import threading
import types
import zlib

import cv2
import numpy as np
import pytest
import yaml

from mast3r_slam_tpu.data import dataloader as jdl
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu.utils import native as jnative
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.data import dataloader as tdl
from mast3r_slam_tpu_torch.data import png
from mast3r_slam_tpu_torch.slam.pipeline import SLAM
from mast3r_slam_tpu_torch.utils import yaml_subset

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_torch_common import CPU, TorchOracleModel

LEVEL = 2.0 / 255.0  # one uint8 level in the network's [-1, 1] input


def _frames(rng):
    from scipy.ndimage import gaussian_filter

    noise = rng.random((480, 640, 3)).astype(np.float32)
    smooth = gaussian_filter(rng.random((480, 640, 3)), sigma=(3, 3, 0))
    smooth = ((smooth - smooth.min()) / (smooth.max() - smooth.min())).astype(np.float32)
    portrait = rng.random((300, 200, 3)).astype(np.float32)
    return {"noise": noise, "smooth": smooth, "portrait": portrait}


@pytest.mark.parametrize("kind", ["noise", "smooth", "portrait"])
def test_preprocess_512_matches_the_jax_package(kind):
    """At 512 both packages resize on their host libraries; the port used
    PIL here before, up to 30 levels away on noise."""
    if not jnative.available():
        pytest.skip("the JAX package's native/libpreprocess.so does not load")
    img = _frames(np.random.default_rng(3))[kind]
    cfg = {"engine": {"resize": 512}}
    got = SLAM.preprocess(types.SimpleNamespace(cfg=cfg), img)
    want = JSLAM.preprocess(types.SimpleNamespace(cfg=cfg), img)
    np.testing.assert_array_equal(got["true_shape"], want["true_shape"])
    assert np.abs(got["img"] - want["img"]).max() <= LEVEL + 1e-6
    du = np.abs(got["unnormalized_img"].astype(int) - want["unnormalized_img"])
    assert du.max() <= 1


def test_preprocess_other_sizes_match_the_jax_package():
    """Below 512 both packages resize with PIL: exactly equal."""
    img = _frames(np.random.default_rng(4))["smooth"]
    cfg = {"engine": {"resize": 64}}
    got = SLAM.preprocess(types.SimpleNamespace(cfg=cfg), img)
    want = JSLAM.preprocess(types.SimpleNamespace(cfg=cfg), img)
    for k in ("img", "true_shape", "unnormalized_img"):
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _images(C, rng):
    y, x = np.mgrid[0:37, 0:53]
    from scipy.ndimage import gaussian_filter

    return {
        "noise": rng.integers(0, 256, (37, 53, C), dtype=np.uint8),
        "gradient": np.stack([(3 * x + c * y) % 256 for c in range(C)], -1).astype(np.uint8),
        "smooth": (gaussian_filter(rng.random((37, 53, C)), (3, 3, 0)) * 255).astype(np.uint8),
    }


def _cv2_unchanged(path):
    """cv2's read of a file as stored, channels in file order (RGB[A])."""
    a = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if a.ndim == 2:
        return a[..., None]
    return a[..., [2, 1, 0] + ([3] if a.shape[2] == 4 else [])]


@pytest.mark.parametrize("C", [1, 3, 4], ids=["gray", "rgb", "rgba"])
def test_png_read_equals_cv2_on_files_cv2_wrote(tmp_path, C):
    for name, img in _images(C, np.random.default_rng(C)).items():
        path = tmp_path / f"{name}.png"
        cv2.imwrite(str(path), img[..., 0] if C == 1 else img[..., [2, 1, 0, 3][:C]])
        np.testing.assert_array_equal(png.read_png(path), _cv2_unchanged(path), name)
        want = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(png.imread_rgb(path), want, name)
        if C == 1:
            np.testing.assert_array_equal(
                png.imread_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def _filtered_png(path, img, filters):
    """Write ``img`` (H, W, C) with row r under filter filters[r % len]:
    the PNG encoder of the spec, so every filter type is exercised."""
    H, W, C = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[C]
    rows = img.reshape(H, W * C).astype(np.int64)
    raw = bytearray()
    for r in range(H):
        f = filters[r % len(filters)]
        cur = rows[r]
        up = rows[r - 1] if r > 0 else np.zeros_like(cur)
        left = np.concatenate([np.zeros(C, np.int64), cur[:-C]])
        upleft = np.concatenate([np.zeros(C, np.int64), up[:-C]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        raw.append(f)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    path.write_bytes(png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype,
                                                                 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("C", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_read_equals_cv2_under_each_row_filter(tmp_path, C, filters):
    for name, img in _images(C, np.random.default_rng(10 + C)).items():
        path = tmp_path / f"{name}.png"
        _filtered_png(path, img, filters)
        np.testing.assert_array_equal(png.read_png(path), img, name)
        np.testing.assert_array_equal(png.read_png(path), _cv2_unchanged(path), name)


def test_png_write_is_read_back_by_cv2(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (48, 80, 3), dtype=np.uint8)
    png.write_png(tmp_path / "w.png", img)
    got = cv2.cvtColor(cv2.imread(str(tmp_path / "w.png")), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(png.read_png(tmp_path / "w.png"), img)


def test_png_outside_the_subset_raises(tmp_path):
    img16 = np.random.default_rng(0).integers(0, 65535, (8, 8), dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "deep.png"), img16)
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(tmp_path / "deep.png")
    png.write_png(tmp_path / "ok.png", np.zeros((4, 4, 3), np.uint8))
    data = bytearray((tmp_path / "ok.png").read_bytes())
    data[-20] ^= 0xFF  # inside the IDAT chunk: its CRC no longer matches
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt PNG chunk"):
        png.read_png(tmp_path / "bad.png")
    with pytest.raises(ValueError, match="gray one"):
        png.imread_gray(tmp_path / "ok.png")


def test_jpeg_needs_cv2(tmp_path, monkeypatch):
    """A JPEG goes through cv2, imported only then: without cv2 it raises
    ImportError, never silently another decoder."""
    img = np.random.default_rng(0).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    want = cv2.cvtColor(cv2.imread(str(tmp_path / "a.jpg")), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(png.imread_rgb(tmp_path / "a.jpg"), want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        png.imread_rgb(tmp_path / "a.jpg")


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

SCALARS = ["1", "-1", "+7", "0", "007", "0x1F", "0b101", "1_000", "1:30", "1.5", "1.",
           ".5", "-.5", "1e-3", "1.0e-3", "1.0e3", "1.0e+9", "1.5E-05", ".inf", "-.Inf",
           "nan", "inf", "true", "True", "yes", "No", "on", "OFF", "y", "null", "~",
           "Null", "abc", "float32", "hello world", "-abc", "'q'", "'it''s'", '"dq"',
           "[1, 2, 3]", "[]", "[1,2,]", "[a, 'b', [c, 1.5]]", "5 # c", "1_0.5", "09",
           "190:20:30", "a#b"]
OUTSIDE = ["x: y", "{a: 1}", "- 1", "&a 1", "*a", "!!str 1", "|", ">", "@x",
           "2001-12-14", "'a' b", '"a\\n"', "[a, {b: 1}]", "[a: 1]", "-"]

SENSOR_YAML = """# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""
INTRINSICS_YAML = """width: 640
height: 480
# With distortion (fx, fy, cx, cy, k1, k2, p1, p2)
calibration:  [517.306408, 516.469215, 318.643040, 255.313989, 0.262383, -0.953104, -0.005358, 0.002628, 1.163314]
"""


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_scalars_equal_safe_load(text):
    got, want = yaml_subset.parse_scalar(text), yaml.safe_load(text)
    assert type(got) is type(want)
    assert got == want or (got != got and want != want)  # nan


@pytest.mark.parametrize("text", OUTSIDE)
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        yaml_subset.parse_scalar(text)


@pytest.mark.parametrize("doc", [SENSOR_YAML, INTRINSICS_YAML,
                                 "a:\n  b:\n    c: 1\n  d: x\ne:\n",
                                 "k: \"q # not a comment\"\nj: 'x' # c\n"],
                         ids=["euroc_sensor", "intrinsics", "nested", "quotes"])
def test_yaml_documents_equal_safe_load(doc):
    assert yaml_subset.load(doc) == yaml.safe_load(doc)


@pytest.mark.parametrize("doc", ["- a\n- b\n", "a: 1\n  b: 2\n", "a: &x 1\n", "a: |\n  t\n",
                                 "---\na: 1\n", "a: [1, 2\n", "a 1\n", "a:\n\tb: 1\n"])
def test_yaml_documents_outside_the_subset_raise(doc):
    with pytest.raises(ValueError):
        yaml_subset.load(doc)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _gray_frames(n, hw=(48, 64)):
    return [(np.random.default_rng(i).random(hw) * 255).astype(np.uint8) for i in range(n)]


def _layout(root, kind, n=3):
    """A tiny on-disk sequence of each layout the loader sniffs."""
    if kind == "tum":
        seq = root / "tum" / "rgbd_dataset_freiburg1_x"
    elif kind == "rgbtxt":
        seq = root / "plain" / "seq"
    elif kind == "eth3d":
        seq = root / "eth3d" / "seq"
    elif kind == "7-scenes":
        seq = root / "7-scenes" / "chess"
    elif kind == "euroc":
        seq = root / "euroc" / "MH_01"
    else:
        seq = root / "folder"
    frames = [np.stack([g, np.roll(g, 1, 0), g[::-1]], -1) for g in _gray_frames(n, (480, 640))]
    if kind in ("tum", "rgbtxt", "eth3d"):
        (seq / "rgb").mkdir(parents=True)
        lines = ["# color images"]
        for i, f in enumerate(frames):
            cv2.imwrite(str(seq / f"rgb/{i}.png"), f)
            lines.append(f"{100 + i / 30:.6f} rgb/{i}.png")
        (seq / "rgb.txt").write_text("\n".join(lines) + "\n")
        if kind == "eth3d":
            (seq / "calibration.txt").write_text("500.0 502.0 320.5 240.5\n")
    elif kind == "7-scenes":
        (seq / "seq-01").mkdir(parents=True)
        for i, f in enumerate(frames):
            cv2.imwrite(str(seq / f"seq-01/frame-{i:06d}.color.png"), f)
    elif kind == "euroc":
        d = seq / "mav0" / "cam0"
        (d / "data").mkdir(parents=True)
        rows = ["#timestamp [ns],filename"]
        for i, g in enumerate(_gray_frames(n, (480, 752))):
            cv2.imwrite(str(d / f"data/{1403636579763555584 + i}.png"), g)
            rows.append(f"{1403636579763555584 + i},{1403636579763555584 + i}.png")
        (d / "data.csv").write_text("\n".join(rows) + "\n")
        (d / "sensor.yaml").write_text(SENSOR_YAML)
    else:
        seq.mkdir(parents=True)
        for i, f in enumerate(frames):
            cv2.imwrite(str(seq / f"img{i + 8}.png"), f)  # natural order: 8, 9, 10
    return seq


@pytest.mark.parametrize("kind,cls", [("tum", "TUMDataset"), ("rgbtxt", "TUMDataset"),
                                      ("eth3d", "ETH3DDataset"),
                                      ("7-scenes", "SevenScenesDataset"),
                                      ("euroc", "EurocDataset"), ("folder", "RGBFiles")])
@pytest.mark.parametrize("use_calib", [False, True], ids=["raw", "calib"])
def test_load_dataset_sniffs_and_reads_as_the_jax_package(tmp_path, kind, cls, use_calib):
    seq = _layout(tmp_path, kind)
    got = tdl.load_dataset(str(seq), use_calib=use_calib)
    want = jdl.load_dataset(str(seq), use_calib=use_calib)
    assert type(got).__name__ == type(want).__name__ == cls
    assert got.timestamps == want.timestamps
    assert [str(p) for p in got.rgb_files] == [str(p) for p in want.rgb_files]
    assert got.has_calib() == want.has_calib()
    assert got.get_img_shape() == want.get_img_shape()
    for i in range(len(want)):
        (tg, a), (tw, b) = got[i], want[i]
        assert tg == tw
        if got.use_calibration and got.camera_intrinsics is not None:
            d = np.abs(a - b) * 255
            assert np.percentile(d, 99) <= 1.0 + 1e-4
        else:
            np.testing.assert_array_equal(a, b)


CALIBS = {
    "fr1": ([517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026, 1.1633], 640, 480),
    "fr2": ([520.9, 521.0, 325.1, 249.7, 0.2312, -0.7849, -0.0033, -0.0001, 0.9172], 640, 480),
    "fr3": ([535.4, 539.2, 320.1, 247.6], 640, 480),
    "euroc": ([458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907, 0.00019359,
               1.76187114e-05], 752, 480),
    "7scenes": ([585.0, 585.0, 320.0, 240.0], 640, 480),
}


@pytest.mark.parametrize("name", sorted(CALIBS))
@pytest.mark.parametrize("center_pp", [True, False])
def test_intrinsics_equal_the_jax_package(name, center_pp):
    calib, W, H = CALIBS[name]
    got = tdl.Intrinsics.from_calib(512, W, H, np.asarray(calib), center_pp=center_pp)
    want = jdl.Intrinsics.from_calib(512, W, H, np.asarray(calib), center_pp=center_pp)
    for a, b in ((got.K, want.K), (got.K_frame, want.K_frame)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.mapx, want.mapx, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.mapy, want.mapy, rtol=0, atol=1e-3)
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(np.random.default_rng(1).random((H, W, 3)) * 255,
                          (2, 2, 0)).astype(np.uint8)
    d = np.abs(got.remap(img).astype(int) - want.remap(img).astype(int))
    assert np.percentile(d, 99) <= 1.0


# ---------------------------------------------------------------------------
# the prefetch thread
# ---------------------------------------------------------------------------

class _Broken(OracleDataset):
    """Frame 3 fails to decode."""

    def __getitem__(self, i):
        if i == 3:
            raise OSError("frame 3: truncated file")
        return super().__getitem__(i)


def _slam(n):
    hw = (48, 64)
    gt = arc_trajectory(n, radius=0.6, max_angle=2.5)
    cfg = load_config("base")
    cfg["single_thread"] = True
    cfg["engine"]["resize"] = 64
    oracle = OracleModel(PlaneScene(hw), gt, noise=0.002)
    return SLAM(TorchOracleModel(oracle), cfg, hw, keyframe_buffer=8, device=CPU)


def test_a_failed_frame_read_ends_the_run_with_its_error():
    """The fetcher's exception is raised by run, and the fetcher thread is
    gone afterwards (no hang, no thread left behind)."""
    slam = _slam(6)
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(OSError, match="truncated"):
        slam.run(_Broken(6, (48, 64)), verbose=False)
    assert "slam-ingest" not in {t.name for t in threading.enumerate()} - before
    st = slam.timer.stats()
    assert st["ingest"]["count"] == 3 and st["frame.latency"]["count"] <= 3


def test_prefetch_runs_frames_in_order_and_times_ingest():
    slam = _slam(4)
    res = slam.run(OracleDataset(4, (48, 64)), verbose=False)
    assert res.frame_timestamps == OracleDataset(4, (48, 64)).timestamps
    assert slam.timer.stats()["ingest"]["count"] == 4
