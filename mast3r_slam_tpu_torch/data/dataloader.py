"""Dataset loaders: TUM / EuRoC / ETH3D / 7-Scenes / MP4 / image folders
(port of ``mast3r_slam_tpu/data/dataloader.py``).

The same calibration constants, undistortion and dataset-type sniffing as
the JAX package, without cv2, PIL or PyYAML on the path of a recorded
sequence: PNGs are read by ``data/png.py``, the EuRoC ``sensor.yaml`` by
``utils/yaml_subset.py``, and the undistortion (OpenCV's optimal new
camera matrix and rectify map) is computed in numpy and applied by the
host library.  JPEG files, MP4 video and the webcam need cv2
(``data/cv2_io.py``), RealSense needs pyrealsense2; each is imported where
it is used and raises ``ImportError`` where it is missing.  Frames are
handed to the engine as float arrays in [0, 1].
"""

from __future__ import annotations

import pathlib
import re
from typing import List, Optional, Sequence

import numpy as np

from ..utils import native
from ..utils.image import resize_geometry
from ..utils.yaml_subset import load_file as load_yaml
from .png import imread_gray, imread_rgb


def natsorted(paths: Sequence) -> List:
    """Natural sort (drop-in for the natsort dep the reference uses)."""

    def key(p):
        s = str(p)
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]

    return sorted(paths, key=key)


class MonocularDataset:
    """Base: indexable (timestamp, rgb float HxWx3 in [0,1]) source."""

    img_size = 512  # the long side the engine resizes to

    def __init__(self):
        self.rgb_files: List = []
        self.timestamps: List = []
        self.camera_intrinsics: Optional[Intrinsics] = None
        self.use_calibration = False
        self.save_results = True
        self.dataset_path: Optional[pathlib.Path] = None

    def __len__(self):
        return len(self.rgb_files)

    def __getitem__(self, idx):
        img = self.get_image(idx)
        return self.get_timestamp(idx), img

    def get_timestamp(self, idx):
        return self.timestamps[idx]

    def read_img(self, idx):
        return imread_rgb(self.rgb_files[idx])

    def get_image(self, idx):
        img = self.read_img(idx)
        if self.use_calibration and self.camera_intrinsics is not None:
            img = self.camera_intrinsics.remap(img)
        return img.astype(np.float32) / 255.0

    def get_img_shape(self):
        """((h, w) the engine sees after resize and crop, (H, W) as read)."""
        raw_shape = self.read_img(0).shape[:2]
        _, (x0, y0, x1, y1) = resize_geometry(raw_shape[1], raw_shape[0], self.img_size)
        return (y1 - y0, x1 - x0), raw_shape

    def subsample(self, stride: int):
        self.rgb_files = self.rgb_files[::stride]
        self.timestamps = self.timestamps[::stride]

    def has_calib(self):
        return self.camera_intrinsics is not None


# TUM-RGBD freiburg calibrations (fx, fy, cx, cy[, k1, k2, p1, p2, k3])
TUM_CALIB = {
    1: [517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026, 1.1633],
    2: [520.9, 521.0, 325.1, 249.7, 0.2312, -0.7849, -0.0033, -0.0001, 0.9172],
    3: [535.4, 539.2, 320.1, 247.6],
}


class TUMDataset(MonocularDataset):
    """TUM-RGBD freiburg sequences (rgb.txt, the freiburg calibrations)."""

    def __init__(self, dataset_path, use_calib=False, center_pp=True):
        super().__init__()
        self.use_calibration = use_calib
        self.dataset_path = pathlib.Path(dataset_path)
        rows = np.loadtxt(self.dataset_path / "rgb.txt", dtype=str, comments="#")
        self.rgb_files = [self.dataset_path / f for f in rows[:, 1]]
        self.timestamps = rows[:, 0].tolist()

        m = re.search(r"freiburg(\d+)", str(dataset_path))
        calib = TUM_CALIB.get(int(m.group(1))) if m is not None else None
        if calib is not None and use_calib:
            self.camera_intrinsics = Intrinsics.from_calib(
                self.img_size, 640, 480, np.asarray(calib), center_pp=center_pp)


class EurocDataset(MonocularDataset):
    """EuRoC MAV cam0; ALWAYS undistorts (too much distortion for the
    pointmap prior)."""

    def __init__(self, dataset_path, use_calib=False, center_pp=True):
        super().__init__()
        self.use_calibration = True  # always remap
        self.calib_for_opt = use_calib
        self.dataset_path = pathlib.Path(dataset_path)
        rows = np.loadtxt(self.dataset_path / "mav0/cam0/data.csv", delimiter=",",
                          dtype=str, comments="#")
        self.rgb_files = [self.dataset_path / "mav0/cam0/data" / f for f in rows[:, 1]]
        # raw nanosecond stamps, as the EuRoC groundtruth files carry them
        self.timestamps = rows[:, 0].tolist()
        cam0 = load_yaml(self.dataset_path / "mav0/cam0/sensor.yaml")
        W, H = cam0["resolution"]
        calib = [*cam0["intrinsics"], *cam0["distortion_coefficients"]]
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, W, H, np.asarray(calib), center_pp=center_pp)

    def read_img(self, idx):
        return np.repeat(imread_gray(self.rgb_files[idx])[..., None], 3, axis=2)

    def has_calib(self):
        return self.calib_for_opt


class ETH3DDataset(MonocularDataset):
    def __init__(self, dataset_path, use_calib=False, center_pp=True):
        super().__init__()
        self.use_calibration = use_calib
        self.dataset_path = pathlib.Path(dataset_path)
        rows = np.loadtxt(self.dataset_path / "rgb.txt", dtype=str, comments="#")
        self.rgb_files = [self.dataset_path / f for f in rows[:, 1]]
        self.timestamps = rows[:, 0].tolist()
        calib = np.loadtxt(self.dataset_path / "calibration.txt", dtype=np.float32)
        _, (H, W) = self.get_img_shape()
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, W, H, calib, center_pp=center_pp)


class SevenScenesDataset(MonocularDataset):
    def __init__(self, dataset_path, use_calib=False, center_pp=True):
        super().__init__()
        self.use_calibration = use_calib
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files = natsorted((self.dataset_path / "seq-01").glob("*.color.png"))
        self.timestamps = [str(i) for i in range(len(self.rgb_files))]
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, 640, 480, np.asarray([585.0, 585.0, 320.0, 240.0]),
            center_pp=center_pp)


class RealsenseDataset(MonocularDataset):
    """Intel RealSense live stream; needs pyrealsense2."""

    def __init__(self, use_calib=False, center_pp=True, hw=(480, 640)):
        super().__init__()
        import pyrealsense2 as rs

        self.rs = rs
        self.h, self.w = hw
        self.pipeline = rs.pipeline()
        cfgr = rs.config()
        cfgr.enable_stream(rs.stream.color, self.w, self.h, rs.format.bgr8, 30)
        self.profile = self.pipeline.start(cfgr)
        self.save_results = False
        self.timestamps = []
        self.use_calibration = use_calib
        if use_calib:
            intr = (rs.video_stream_profile(self.profile.get_stream(rs.stream.color))
                    .get_intrinsics())
            self.camera_intrinsics = Intrinsics.from_calib(
                self.img_size, self.w, self.h,
                np.asarray([intr.fx, intr.fy, intr.ppx, intr.ppy]), center_pp=center_pp)

    def __len__(self):
        return 999_999

    def read_img(self, idx):
        frames = self.pipeline.wait_for_frames()
        self.timestamps.append(str(frames.get_timestamp() / 1000.0))
        img = np.asanyarray(frames.get_color_frame().get_data())
        return np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB

    def subsample(self, stride):
        pass


class RGBFiles(MonocularDataset):
    def __init__(self, dataset_path):
        super().__init__()
        self.dataset_path = pathlib.Path(dataset_path)
        files = (list(self.dataset_path.glob("*.png"))
                 + list(self.dataset_path.glob("*.jpg")))
        self.rgb_files = natsorted(files)
        self.timestamps = [str(i / 30.0) for i in range(len(self.rgb_files))]


# ---------------------------------------------------------------------------
# undistortion: OpenCV's getOptimalNewCameraMatrix and
# initUndistortRectifyMap (no rectification, R = I) in numpy
# ---------------------------------------------------------------------------

_UNDISTORT_ITERS = 5  # cv2.undistortPoints' default: TermCriteria(COUNT, 5)


def _coeffs(distortion) -> np.ndarray:
    """OpenCV's coefficient vector (k1 k2 p1 p2 [k3 [k4 k5 k6 [s1..s4]]]),
    zero-padded to 12."""
    d = np.asarray(distortion, dtype=np.float64).reshape(-1)
    if len(d) not in (4, 5, 8, 12):
        raise ValueError(f"{len(d)} distortion coefficients; 4, 5, 8 or 12 are read "
                         "(the tilted-sensor model is not)")
    return np.concatenate([d, np.zeros(12 - len(d))])


def undistort_points(uv: np.ndarray, K: np.ndarray, distortion, P=None) -> np.ndarray:
    """cv2.undistortPoints of (n, 2) pixels: the distortion inverted by the
    fixed-point iteration OpenCV runs (5 steps), then projected by P
    (normalised coordinates when P is None)."""
    k = _coeffs(distortion)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = (uv[:, 0] - cx) * (1.0 / fx)
    y = (uv[:, 1] - cy) * (1.0 / fy)
    x0, y0 = x, y
    for _ in range(_UNDISTORT_ITERS):
        r2 = x * x + y * y
        icdist = ((1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
                  / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2))
        dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2 + k[9] * r2 * r2
        dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2 + k[11] * r2 * r2
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    if P is None:
        return np.stack([x, y], axis=-1)
    return np.stack([P[0, 0] * x + P[0, 1] * y + P[0, 2],
                     P[1, 0] * x + P[1, 1] * y + P[1, 2]], axis=-1)


def _undistort_rectangles(K, distortion, P, W: int, H: int):
    """The rectangles inscribed in and circumscribing a 9x9 grid of image
    points after undistortion: ((x, y, w, h) inner, (x, y, w, h) outer)."""
    n = 9
    gy, gx = np.mgrid[0:n, 0:n].astype(np.float64)
    uv = np.stack([gx.ravel() * (W - 1) / (n - 1), gy.ravel() * (H - 1) / (n - 1)], -1)
    p = undistort_points(uv, K, distortion, P).reshape(n, n, 2)
    ox0, ox1 = p[..., 0].min(), p[..., 0].max()
    oy0, oy1 = p[..., 1].min(), p[..., 1].max()
    ix0, ix1 = p[:, 0, 0].max(), p[:, n - 1, 0].min()
    iy0, iy1 = p[0, :, 1].max(), p[n - 1, :, 1].min()
    return (ix0, iy0, ix1 - ix0, iy1 - iy0), (ox0, oy0, ox1 - ox0, oy1 - oy0)


def optimal_new_camera_matrix(K, distortion, W: int, H: int, center_pp: bool = True):
    """cv2.getOptimalNewCameraMatrix(K, d, (W, H), alpha=0, (W, H),
    centerPrincipalPoint=center_pp): the camera whose image holds only
    valid undistorted pixels."""
    K = np.asarray(K, dtype=np.float64)
    M = K.copy()
    if center_pp:
        cx0, cy0 = K[0, 2], K[1, 2]
        cx, cy = (W - 1) * 0.5, (H - 1) * 0.5
        (ix, iy, iw, ih), _ = _undistort_rectangles(K, distortion, K, W, H)
        s = max(cx / (cx0 - ix), cy / (cy0 - iy), cx / (ix + iw - cx0), cy / (iy + ih - cy0))
        M[0, 0] *= s
        M[1, 1] *= s
        M[0, 2], M[1, 2] = cx, cy
        return M
    (ix, iy, iw, ih), _ = _undistort_rectangles(K, distortion, None, W, H)
    fx, fy = (W - 1) / iw, (H - 1) / ih
    return np.array([[fx, 0.0, -fx * ix], [0.0, fy, -fy * iy], [0.0, 0.0, 1.0]])


def undistort_rectify_map(K, distortion, K_new, W: int, H: int):
    """cv2.initUndistortRectifyMap(K, d, None, K_new, (W, H), CV_32FC1):
    for every pixel of the undistorted image its source in the raw one,
    (mapx, mapy) float32 (H, W)."""
    k = _coeffs(distortion)
    K = np.asarray(K, dtype=np.float64)
    ir = np.linalg.inv(np.asarray(K_new, dtype=np.float64))
    j = np.arange(W, dtype=np.float64)[None, :]
    i = np.arange(H, dtype=np.float64)[:, None]
    _x = i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]
    _y = i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]
    _w = i * ir[2, 1] + ir[2, 2] + j * ir[2, 0]
    w = 1.0 / _w
    x, y = _x * w, _y * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2 * x * y
    kr = ((1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
          / (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2))
    u = K[0, 0] * (x * kr + k[2] * xy2 + k[3] * (r2 + 2 * x2) + k[8] * r2
                   + k[9] * r2 * r2) + K[0, 2]
    v = K[1, 1] * (y * kr + k[2] * (r2 + 2 * y2) + k[3] * xy2 + k[10] * r2
                   + k[11] * r2 * r2) + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


class Intrinsics:
    """Pinhole + distortion -> rectified-and-resized camera model: the
    optimal new camera matrix and the undistortion map at the raw
    resolution, and ``K_frame``, that camera rescaled to the resized and
    cropped frame the network sees."""

    def __init__(self, img_size, W, H, K_orig, K, distortion, mapx, mapy):
        self.img_size = img_size
        self.W, self.H = W, H
        self.K_orig = K_orig
        self.K = K
        self.distortion = distortion
        self.mapx, self.mapy = mapx, mapy
        _, (scale_w, scale_h, half_crop_w, half_crop_h) = resize_img_transform(
            H, W, img_size)
        self.K_frame = K.copy()
        self.K_frame[0, 0] = K[0, 0] / scale_w
        self.K_frame[1, 1] = K[1, 1] / scale_h
        self.K_frame[0, 2] = K[0, 2] / scale_w - half_crop_w
        self.K_frame[1, 2] = K[1, 2] / scale_h - half_crop_h

    def remap(self, img):
        return native.remap_native(img, self.mapx, self.mapy)

    @staticmethod
    def from_calib(img_size, W, H, calib, center_pp=True):
        fx, fy, cx, cy = calib[:4]
        distortion = np.asarray(calib[4:]) if len(calib) > 4 else np.zeros(4)
        K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
        K_opt = optimal_new_camera_matrix(K, distortion, W, H, center_pp)
        mapx, mapy = undistort_rectify_map(K, distortion, K_opt, W, H)
        return Intrinsics(img_size, W, H, K, K_opt, distortion, mapx, mapy)


def resize_img_transform(H, W, img_size):
    """The resize+crop transform of an H x W image: ((h, w) the crop,
    (scale_w, scale_h, half_crop_w, half_crop_h))."""
    if img_size == 224:
        # the 224 square-crop path scales the short side; SLAM runs 512
        raise NotImplementedError("224 path unused in SLAM")
    (W2, H2), (x0, y0, x1, y1) = resize_geometry(W, H, img_size)
    h, w = y1 - y0, x1 - x0
    return (h, w), (W / W2, H / H2, (W2 - w) / 2, (H2 - h) / 2)


def load_dataset(dataset_path: str, use_calib=False, center_pp=True):
    """Sniff the dataset type from the path."""
    parts = str(dataset_path).split("/")
    kw = dict(use_calib=use_calib, center_pp=center_pp)
    if "tum" in parts:
        return TUMDataset(dataset_path, **kw)
    if "euroc" in parts:
        return EurocDataset(dataset_path, **kw)
    if "eth3d" in parts:
        return ETH3DDataset(dataset_path, **kw)
    if "7-scenes" in parts:
        return SevenScenesDataset(dataset_path, **kw)
    if "webcam" in parts:
        from .cv2_io import Webcam

        return Webcam()
    if "realsense" in parts:
        return RealsenseDataset(**kw)
    ext = parts[-1].split(".")[-1].lower()
    if ext in ("mp4", "avi", "mov"):
        from .cv2_io import MP4Dataset

        return MP4Dataset(dataset_path)
    p = pathlib.Path(dataset_path)
    if (p / "rgb.txt").exists():
        return TUMDataset(dataset_path, **kw)
    return RGBFiles(dataset_path)
