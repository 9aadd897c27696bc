"""The port's host library: frame resize, undistortion remap and PNG row
filters (port of ``mast3r_slam_tpu/utils/native.py``), the JPEG decoder
of the image readers and the session server, and the MPEG-4 Part 2,
H.264, HEVC and Motion-JPEG decoders of the video reader, in C++.

``csrc/host/preprocess.cpp``, ``jpeg.cpp``, ``mpeg4.cpp``, ``h264.cpp``,
``hevc.cpp`` and ``mjpeg.cpp`` (the video decoders share ``yuv420.h``,
HEVC beyond 8 bits ``swscale.h``, MPEG-4 Part 2 and Motion-JPEG the simple
IDCT of ``idct.h``, the NAL unit decoders and Motion-JPEG the error
handling of ``nal.h``, H.264 and HEVC its NAL unit reader and the CABAC
engine of ``cabac.h``) are compiled with the host C++ compiler (``$CXX``,
else ``g++``) at first use, the sources at once, into one library in
``build/host/`` at the repository root, named by a hash of the sources,
the flags and the host
(``-march=native`` code runs only on the CPU it was built for), and loaded
with ``ctypes``.  The source compiles with the JAX package's
``native/Makefile`` flags, so that the two libraries resize the same frames
to the same pixels where they are built alike, and links in a second step
without ``-ffast-math``: linked with it, the library would switch the whole
process's floating point to flush denormals to zero when it loads.
Nothing here runs at import; a failed build raises: no caller falls back
to another resizer.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .image import resize_geometry

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCES = [_PKG_DIR / "csrc" / "host" / name
           for name in ("preprocess.cpp", "jpeg.cpp", "mpeg4.cpp", "h264.cpp", "hevc.cpp",
                        "mjpeg.cpp")]
HEADERS = [_PKG_DIR / "csrc" / "host" / name
           for name in ("yuv420.h", "swscale.h", "cabac.h", "nal.h", "idct.h")]
BUILD_DIR = _PKG_DIR.parent / "build" / "host"
CXX_FLAGS = ["-O3", "-march=native", "-ffast-math", "-funroll-loops", "-std=c++17",
             "-fPIC", "-Wall"]
LINK_FLAGS = ["-shared", "-lpthread"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_F32P = ctypes.POINTER(ctypes.c_float)
_I = ctypes.c_int
_I32P = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = {
    "preprocess_frame": [_U8P, _I, _I, _I, _I, _I, _I, _F32P, _U8P],
    "remap_bilinear": [_U8P, _I, _I, _F32P, _F32P, _U8P],
    "png_unfilter": [_U8P, _I, _I, _I, _U8P],
    "jpeg_info": [_U8P, ctypes.c_int64, _I32P, ctypes.c_char_p, _I],
    "jpeg_decode": [_U8P, ctypes.c_int64, _I, _I, _I, _U8P, ctypes.c_char_p, _I],
    "mpeg4_open": [_U8P, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, _I],
    "mpeg4_size": [ctypes.c_void_p, _I32P],
    "mpeg4_decode": [ctypes.c_void_p, _U8P, ctypes.c_int64, _I32P, ctypes.c_char_p, _I],
    "mpeg4_rgb": [ctypes.c_void_p, _U8P],
    "mpeg4_reset": [ctypes.c_void_p],
    "mpeg4_close": [ctypes.c_void_p],
    "h264_open": [_U8P, ctypes.c_int64, _I, ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, _I],
    "h264_size": [ctypes.c_void_p, _I32P],
    "h264_decode": [ctypes.c_void_p, _U8P, ctypes.c_int64, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, _I],
    "h264_headers": [ctypes.c_void_p, _U8P, ctypes.c_int64, _I32P, ctypes.c_char_p, _I],
    "h264_rgb": [ctypes.c_void_p, _U8P],
    "h264_stale": [ctypes.c_void_p, _I32P],
    "h264_expect": [ctypes.c_void_p, _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, _I],
    "h264_drain": [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)],
    "h264_delay": [ctypes.c_void_p, _I, _I32P],
    "h264_reset": [ctypes.c_void_p],
    "h264_close": [ctypes.c_void_p],
    "hevc_open": [_U8P, ctypes.c_int64, _I, ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, _I],
    "hevc_size": [ctypes.c_void_p, _I32P],
    "hevc_decode": [ctypes.c_void_p, _U8P, ctypes.c_int64, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, _I],
    "hevc_headers": [ctypes.c_void_p, _U8P, ctypes.c_int64, _I32P, ctypes.c_char_p, _I],
    "hevc_rgb": [ctypes.c_void_p, _U8P],
    "hevc_drain": [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)],
    "hevc_delay": [ctypes.c_void_p, _I, _I32P],
    "hevc_reset": [ctypes.c_void_p],
    "hevc_close": [ctypes.c_void_p],
    "yuv420_high_rgb": [_U16P, _U16P, _U16P, _I, _I, _I, _I, _I, _I, _U8P],
    "mjpeg_open": [_I, _I, ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, _I],
    "mjpeg_size": [ctypes.c_void_p, _I32P],
    "mjpeg_decode": [ctypes.c_void_p, _U8P, ctypes.c_int64, _I32P, ctypes.c_char_p, _I],
    "mjpeg_rgb": [ctypes.c_void_p, _U8P],
    "mjpeg_reset": [ctypes.c_void_p],
    "mjpeg_close": [ctypes.c_void_p],
}

_lib = None
_lock = threading.Lock()


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler: set CXX or put g++ on PATH")
    return cxx


def library_path() -> Path:
    key = " ".join(CXX_FLAGS + LINK_FLAGS + [platform.machine(), platform.node()])
    digest = hashlib.sha1(b"".join(f.read_bytes() for f in SOURCES + HEADERS)
                          + key.encode()).hexdigest()[:12]
    return BUILD_DIR / f"libpreprocess_{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; raises on failure.  The
    sources compile at once, one compiler each; processes that ask for the
    same library meanwhile wait for the first one's build (a lock file
    beside it) instead of compiling it again."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    objs = [f"{tmp}.{src.stem}.o" for src in SOURCES]
    compiles = [[compiler(), *CXX_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    results = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(compiles, procs)]
    link = [compiler(), "-o", f"{tmp}.so", *objs, *LINK_FLAGS]
    if all(rc == 0 for _, _, rc in results):
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        results.append((link, proc.stdout, proc.returncode))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    for cmd, log, rc in results:
        if rc != 0:
            raise RuntimeError(f"building {out.name} failed (rc {rc}):\n{' '.join(cmd)}\n{log}")
    os.replace(f"{tmp}.so", out)


def load() -> ctypes.CDLL:
    """The host library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def resize_img_native(img01: np.ndarray, size: int = 512) -> dict:
    """``utils.pil_image.resize_img`` on the host library (Lanczos-3; the 512
    path).  img01: float (H, W, 3) in [0, 1]; returns the same dict."""
    if size != 512:
        raise ValueError(f"the host library resizes to 512 only, not {size}")
    if img01.ndim != 3 or img01.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img01.shape}")
    lib = load()
    H, W = img01.shape[:2]
    rgb = np.ascontiguousarray(np.clip(img01 * 255.0, 0, 255).astype(np.uint8))
    (outW, outH), (x0, y0, x1, y1) = resize_geometry(W, H, size)
    cropW, cropH = x1 - x0, y1 - y0
    out_chw = np.empty((3, cropH, cropW), dtype=np.float32)
    out_rgb = np.empty((cropH, cropW, 3), dtype=np.uint8)
    rc = lib.preprocess_frame(_ptr(rgb, _U8P), H, W, outH, outW, cropH, cropW,
                              _ptr(out_chw, _F32P), _ptr(out_rgb, _U8P))
    if rc != 0:
        raise RuntimeError(f"preprocess_frame failed: {rc}")
    return dict(img=out_chw, true_shape=np.int32([[cropH, cropW]]),
                unnormalized_img=out_rgb)


def remap_native(rgb_u8: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """Bilinear remap of an (H, W, 3) uint8 image by per-pixel source
    coordinates (H, W) (``cv2.remap(..., INTER_LINEAR)``; pixels whose
    source falls outside the image are 0)."""
    if rgb_u8.dtype != np.uint8 or rgb_u8.ndim != 3 or rgb_u8.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {rgb_u8.dtype} "
                         f"{rgb_u8.shape}")
    H, W = rgb_u8.shape[:2]
    if mapx.shape != (H, W) or mapy.shape != (H, W):
        raise ValueError(f"maps {mapx.shape}, {mapy.shape} for a {H}x{W} image")
    lib = load()
    rgb = np.ascontiguousarray(rgb_u8)
    mx = np.ascontiguousarray(mapx, dtype=np.float32)
    my = np.ascontiguousarray(mapy, dtype=np.float32)
    out = np.empty_like(rgb)
    rc = lib.remap_bilinear(_ptr(rgb, _U8P), H, W, _ptr(mx, _F32P), _ptr(my, _F32P),
                            _ptr(out, _U8P))
    if rc != 0:
        raise RuntimeError(f"remap_bilinear failed: {rc}")
    return out


def png_unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of inflated image data: ``height`` rows of a
    filter byte and ``row_bytes`` filtered bytes -> (height, row_bytes) uint8."""
    if len(raw) != height * (row_bytes + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected "
                         f"{height * (row_bytes + 1)} ({height} rows of 1 + {row_bytes})")
    lib = load()
    src = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty((height, row_bytes), dtype=np.uint8)
    rc = lib.png_unfilter(_ptr(src, _U8P), height, row_bytes, bpp, _ptr(out, _U8P))
    if rc >= 10:
        raise ValueError(f"PNG row {rc - 10}: unknown filter type "
                         f"{src[(rc - 10) * (row_bytes + 1)]}")
    if rc != 0:
        raise RuntimeError(f"png_unfilter failed: {rc}")
    return out


MAX_PIXELS = 1 << 26  # 64 Mpixel: an image header cannot make the readers allocate more


def _jpeg_error(rc: int, err) -> Exception:
    msg = err.value.decode(errors="replace")
    if rc == 2:
        return NotImplementedError(msg)
    if rc == 1:
        return ValueError(f"corrupt JPEG: {msg}")
    if rc == 4:
        return ValueError(msg)
    return MemoryError(msg)


def jpeg_info(data: bytes) -> dict:
    """The headers of a JPEG stream up to its frame: ``width``, ``height``,
    ``components`` (1, 3 or 4) and the EXIF ``orientation`` (1-8).  A coding
    that cv2 returns nothing for (hierarchical, SOF11, DCT samples other
    than 8 bits, lossless ones over 8) or a corrupt header raises
    ``ValueError``; a header the decoder does not take (sampling factors
    above 2 in DCT coding or at a non-integral ratio, a DNL height)
    ``NotImplementedError``."""
    lib = load()
    src = np.frombuffer(data, dtype=np.uint8)
    info = (ctypes.c_int * 4)()
    err = ctypes.create_string_buffer(256)
    rc = lib.jpeg_info(_ptr(src, _U8P), src.size, info, err, len(err))
    if rc != 0:
        raise _jpeg_error(rc, err)
    return dict(width=info[0], height=info[1], components=info[2], orientation=info[3])


def decode_jpeg(data: bytes, max_pixels: int = MAX_PIXELS, gray: bool = False) -> np.ndarray:
    """Decode a JPEG (``csrc/host/jpeg.cpp``: sequential and progressive
    Huffman or arithmetic coding, a progressive stream's early stop
    smoothed as libjpeg-turbo smooths it, and lossless coding at 2 to 8
    bits) with the EXIF orientation applied: to (H, W, 3) uint8 RGB, gray
    replicated, as ``cv2.cvtColor(cv2.imdecode(..., IMREAD_COLOR),
    COLOR_BGR2RGB)``, or with ``gray`` to (H, W) uint8, as
    ``cv2.imdecode(..., IMREAD_GRAYSCALE)`` (the Y plane of YCbCr,
    libjpeg's RGB->gray of RGB, OpenCV's CMYK->gray of CMYK and YCCK).
    A stream cv2 returns nothing for raises ``ValueError``: hierarchical
    and SOF11 coding, DCT samples other than 8 bits, lossless ones over 8,
    and the lossless reads that need a colour conversion (a colour read of
    one component, a gray read of three, YCbCr or YCCK).  So does a
    truncated or corrupt stream, or one larger than ``max_pixels``.
    Sampling factors the decoder does not take raise
    ``NotImplementedError``."""
    info = jpeg_info(data)
    W, H = info["width"], info["height"]
    if W * H > max_pixels:
        raise ValueError(f"JPEG of {W}x{H} pixels exceeds the limit of {max_pixels}")
    lib = load()
    src = np.frombuffer(data, dtype=np.uint8)
    err = ctypes.create_string_buffer(256)
    out = np.empty((H, W) if gray else (H, W, 3), dtype=np.uint8)
    rc = lib.jpeg_decode(_ptr(src, _U8P), src.size, W, H, int(gray), _ptr(out, _U8P), err,
                         len(err))
    if rc != 0:
        raise _jpeg_error(rc, err)
    return _orient(out, info["orientation"])


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8 applied as cv2.imdecode applies it."""
    if orientation >= 5:  # the stored rows are the picture's columns
        img = img.swapaxes(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    return np.ascontiguousarray(np.flip(img, flips) if flips else img)


def _video_error(rc: int, err, codec: str) -> Exception:
    msg = err.value.decode(errors="replace")
    if rc == 2:
        return NotImplementedError(msg)
    if rc == 1:
        return ValueError(f"corrupt {codec} video: {msg}")
    return MemoryError(msg)


class Mpeg4Decoder:
    """An MPEG-4 Part 2 decoder (``csrc/host/mpeg4.cpp``) over one stream's
    samples, in decode order.  ``config`` is the stream's VOS/VOL headers
    (the ``esds`` DecoderSpecificInfo, or the headers that open an AVI
    stream's first sample).  ``decode`` feeds a sample and says whether
    libavcodec outputs a frame for it (not for a not-coded VOP); ``rgb``
    gives the last frame output as (H, W, 3) uint8 RGB, exactly what
    ``cv2.cvtColor(cv2.VideoCapture(...).read()[1], cv2.COLOR_BGR2RGB)``
    gives for it with cv2 5.0.0.  Streams the decoder does not take raise
    ``NotImplementedError``, corrupt ones ``ValueError``.  One decoder
    serves one thread at a time."""

    _PREFIX, _CODEC = "mpeg4", "MPEG-4"  # the host library's functions, the codec's name

    def __init__(self, config: bytes = b""):
        self._lib = load()
        self._state = None
        state = ctypes.c_void_p()
        src = np.frombuffer(config, dtype=np.uint8)
        err = ctypes.create_string_buffer(256)
        rc = self._lib.mpeg4_open(_ptr(src, _U8P), src.size, ctypes.byref(state), err,
                                  len(err))
        if rc != 0:
            raise _video_error(rc, err, self._CODEC)
        self._state = state

    def _fn(self, name: str):
        return getattr(self._lib, f"{self._PREFIX}_{name}")

    def size(self):
        """(width, height) once a VOL has been read, else None."""
        wh = (ctypes.c_int * 2)()
        self._fn("size")(self._state, wh)
        return (wh[0], wh[1]) if wh[0] else None

    def decode(self, sample: bytes) -> bool:
        src = np.frombuffer(sample, dtype=np.uint8)
        err = ctypes.create_string_buffer(256)
        shown = ctypes.c_int()
        rc = self._fn("decode")(self._state, _ptr(src, _U8P), src.size, ctypes.byref(shown),
                                err, len(err))
        if rc != 0:
            raise _video_error(rc, err, self._CODEC)
        return bool(shown.value)

    def rgb(self) -> np.ndarray:
        width, height = self.size()
        out = np.empty((height, width, 3), dtype=np.uint8)
        if self._fn("rgb")(self._state, _ptr(out, _U8P)) != 0:
            raise ValueError(f"no {self._CODEC} frame decoded yet")
        return out

    def reset(self):
        """Forget the reference frame (before decoding from a sync sample)."""
        self._fn("reset")(self._state)

    def close(self):
        state, self._state = self._state, None
        if state:
            self._fn("close")(state)

    def __del__(self):
        self.close()


class H264Decoder:
    """An H.264 decoder (``csrc/host/h264.cpp``) over one stream's samples,
    in decode order.  ``config`` is Annex B NAL units whose parameter sets
    are read (an ``avcC``'s, or an AVI stream's first sample);
    ``length_size`` is the bytes of each NAL unit's length in a sample (the
    ``avcC``'s), 0 for Annex B samples.  ``decode(sample, index)`` feeds a
    sample (an access unit) and gives the index of the sample whose picture
    libavcodec outputs then, or None: pictures are held back and come out in
    picture order count order as libavcodec's ``h264_select_output_frame``
    releases them (its ``has_b_frames``, ``delay``), so the picture output
    may be an earlier sample's; at the end of the stream ``drain()`` gives
    the held pictures one at a time, as cv2 takes them at the end of a
    file.  ``rgb`` gives the last picture output as (H, W, 3) uint8 RGB,
    cropped, exactly what ``cv2.cvtColor(cv2.VideoCapture(...).read()[1],
    cv2.COLOR_BGR2RGB)`` gives for it with cv2 5.0.0 (before cv2 turns it
    by the track's display matrix).  Streams the decoder does not take
    raise ``NotImplementedError``, corrupt ones ``ValueError``.  One
    decoder serves one thread at a time."""

    _PREFIX, _CODEC = "h264", "H.264"  # the host library's functions, the codec's name

    def __init__(self, config: bytes = b"", length_size: int = 0):
        self._lib = load()
        self._state = None
        state = ctypes.c_void_p()
        src = np.frombuffer(config, dtype=np.uint8)
        err = ctypes.create_string_buffer(256)
        rc = self._fn("open")(_ptr(src, _U8P), src.size, length_size, ctypes.byref(state),
                                 err, len(err))
        if rc != 0:
            raise _video_error(rc, err, self._CODEC)
        self._state = state

    def _fn(self, name: str):
        return getattr(self._lib, f"{self._PREFIX}_{name}")

    def size(self):
        """(width, height) of the last picture output (before one, of the
        first sequence parameter set read), else None."""
        wh = (ctypes.c_int * 2)()
        self._fn("size")(self._state, wh)
        return (wh[0], wh[1]) if wh[0] else None

    def decode(self, sample: bytes, index: int):
        src = np.frombuffer(sample, dtype=np.uint8)
        err = ctypes.create_string_buffer(256)
        shown = ctypes.c_int64()
        rc = self._fn("decode")(self._state, _ptr(src, _U8P), src.size, index,
                                   ctypes.byref(shown), err, len(err))
        if rc != 0:
            raise _video_error(rc, err, self._CODEC)
        return None if shown.value < 0 else shown.value

    def drain(self):
        """At the end of the stream: the sample of the next picture held
        back (now the one ``rgb`` gives), or None when none is left."""
        shown = ctypes.c_int64()
        self._fn("drain")(self._state, ctypes.byref(shown))
        return None if shown.value < 0 else shown.value

    def delay(self, set_to: int = -1) -> tuple:
        """(has_b_frames, the last picture's SPS's num_reorder_frames (its
        VUI's, or libavcodec's guess from the level), whether that SPS has
        bitstream_restriction); ``set_to`` >= 0 sets has_b_frames first."""
        info = (ctypes.c_int * 3)()
        self._fn("delay")(self._state, set_to, info)
        return info[0], info[1], bool(info[2])

    def headers(self, sample: bytes) -> bool:
        """Read the parameter sets of ``sample`` without decoding it; whether
        it holds an IDR picture."""
        src = np.frombuffer(sample, dtype=np.uint8)
        err = ctypes.create_string_buffer(256)
        idr = ctypes.c_int()
        rc = self._fn("headers")(self._state, _ptr(src, _U8P), src.size, ctypes.byref(idr),
                                    err, len(err))
        if rc != 0:
            raise _video_error(rc, err, self._CODEC)
        return bool(idr.value)

    def rgb(self) -> np.ndarray:
        width, height = self.size()
        out = np.empty((height, width, 3), dtype=np.uint8)
        if self._fn("rgb")(self._state, _ptr(out, _U8P)) != 0:
            raise ValueError(f"no {self._CODEC} picture decoded yet")
        return out

    def reset(self):
        """Forget every picture (before decoding from a sync sample)."""
        self._fn("reset")(self._state)

    def stale(self) -> bool:
        """Whether the last picture output was decoded, after a seek, under
        parameter sets it was not encoded under (a seek back across sets
        changed in band, say): libavcodec decodes such pictures otherwise."""
        flag = ctypes.c_int()
        self._fn("stale")(self._state, ctypes.byref(flag))
        return bool(flag.value)

    def expect(self, sample: bytes, index: int):
        """Read the parameter sets of sample ``index``, which a seek skips:
        the pictures after it were encoded under them (``stale``)."""
        src = np.frombuffer(sample, dtype=np.uint8)
        err = ctypes.create_string_buffer(256)
        rc = self._fn("expect")(self._state, _ptr(src, _U8P), src.size, index, err, len(err))
        if rc != 0:
            raise _video_error(rc, err, self._CODEC)

    def close(self):
        state, self._state = self._state, None
        if state:
            self._fn("close")(state)

    def __del__(self):
        self.close()


class HevcDecoder(H264Decoder):
    """An HEVC decoder (``csrc/host/hevc.cpp``) over one stream's samples, in
    decode order, with ``H264Decoder``'s methods.  ``config`` is Annex B NAL
    units whose parameter sets are read (an ``hvcC``'s arrays, or an AVI
    stream's first sample); ``length_size`` is the bytes of each NAL unit's
    length in a sample (the ``hvcC``'s), 0 for Annex B samples.
    ``decode(sample, index)`` gives the index of the sample whose picture
    comes out next, or None: the DPB releases pictures in POC order as
    libavcodec's output process does (held back by the SPS's
    sps_max_num_reorder_pics, its latency and its DPB size, never by
    has_b_frames, so ``delay``'s ``set_to`` changes nothing), one a call; a
    sample that releases several gives the rest at the next calls, and
    ``drain()`` gives the held ones at the end of the stream; a sample of a
    RASL picture whose CRA or BLA picture opened decoding (the stream's
    first, or the first after ``reset``) is left out, as libavcodec leaves
    it out, and releases none.  ``headers`` tells whether a sample holds an
    IRAP (IDR, CRA or BLA) picture.  ``rgb``
    gives the last picture output as (H, W, 3) uint8 RGB, cropped, exactly
    what cv2 5.0.0 gives for it (before cv2 turns it by the track's display
    matrix)."""

    _PREFIX, _CODEC = "hevc", "HEVC"


class MjpegDecoder(Mpeg4Decoder):
    """A Motion-JPEG decoder (``csrc/host/mjpeg.cpp``) over one track's
    samples, each a JPEG picture, with ``Mpeg4Decoder``'s methods.
    ``width`` and ``height`` are the container's frame size (libavcodec's
    coded size when cv2 opens the decoder: a JPEG frame under 3/4 of that
    height would be an AVI1 field pair, refused).  ``decode`` feeds a
    sample and says whether libavcodec outputs a frame for it (not for an
    empty sample, an AVI chunk of no bytes); ``size`` is the last frame's
    (width, height), before one the container's; ``rgb`` gives the last
    frame output as (H, W, 3) uint8 RGB, exactly what
    ``cv2.cvtColor(cv2.VideoCapture(...).read()[1], cv2.COLOR_BGR2RGB)``
    gives for it with cv2 5.0.0 (before cv2 turns it by the track's
    display matrix).  The quantisation and Huffman tables a sample defines
    stay for the samples after it, also across ``reset``, as libavcodec
    keeps them.  What the decoder does not take (progressive, lossless,
    arithmetic, 12-bit, 4:4:4, 4:4:0 and 4:1:1 samplings, ...) raises
    ``NotImplementedError`` naming ROADMAP Queue 1 item 17f, corrupt data
    ``ValueError``."""

    _PREFIX, _CODEC = "mjpeg", "Motion-JPEG"

    def __init__(self, width: int = 0, height: int = 0):
        self._lib = load()
        self._state = None
        state = ctypes.c_void_p()
        err = ctypes.create_string_buffer(256)
        rc = self._lib.mjpeg_open(int(width), int(height), ctypes.byref(state), err, len(err))
        if rc != 0:
            raise _video_error(rc, err, self._CODEC)
        self._state = state
