"""Hold libswscale's full-range conversions to BGR24, as cv2 5.0.0 asks for
them (``sws_getContext`` at the frame's own size, SWS_BICUBIC; cv2's
bundled libswscale called through ``ctypes``), against the arithmetic the
port's host library converts Motion-JPEG frames with (``csrc/host/
yuv420.h``: nearest chroma, the 16-bit coefficients of BT.601 at full
range), for each pixel format libavcodec's MJPEG decoder outputs:

  yuvj420p, yuvj422p  every (Y, U, V) of 2^24, then random planes at
                      every width from 1 to 39 and a few more, even and
                      odd heights
  yuvj444p, yuvj440p, yuvj411p
                      the same sweep (libswscale takes its scaler and
                      chroma filters there: the port refuses them)
  gray                every value, random planes at odd sizes

and prints, per format, how many output values differ and by how much.
Needs cv2 (its libraries), so it runs where the tests run:

    python scripts/sweep_yuvj_conversion.py
"""

from __future__ import annotations

import ctypes
import glob
import json
import os

import numpy as np

# (vertical, horizontal) chroma shifts
SHIFTS = {"420": (1, 1), "422": (0, 1), "444": (0, 0), "440": (1, 0), "411": (0, 2)}


def _swscale():
    import cv2

    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    load = lambda name: ctypes.CDLL(glob.glob(os.path.join(libs, f"lib{name}-*.so*"))[0],
                                    mode=ctypes.RTLD_GLOBAL)  # noqa: E731
    avutil, sws = load("avutil"), load("swscale")
    avutil.av_log_set_level(-8)  # quiet: yuvj formats are "deprecated" to libswscale
    avutil.av_get_pix_fmt.argtypes = [ctypes.c_char_p]
    sws.sws_getContext.restype = ctypes.c_void_p
    sws.sws_getContext.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    sws.sws_scale.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    sws.sws_freeContext.argtypes = [ctypes.c_void_p]
    return avutil, sws


AVUTIL, SWS = _swscale()
SWS_BICUBIC = 4


def scale(planes, fmt: str) -> np.ndarray:
    """BGR24 of ``planes`` through libswscale, strides padded as
    libavcodec's frames and cv2's buffer are."""
    h, w = planes[0].shape
    ctx = SWS.sws_getContext(w, h, AVUTIL.av_get_pix_fmt(fmt.encode()), w, h,
                             AVUTIL.av_get_pix_fmt(b"bgr24"), SWS_BICUBIC, None, None, None)
    src, strides, keep = (ctypes.c_void_p * 4)(), (ctypes.c_int * 4)(), []
    for i, p in enumerate(planes):
        stride = -(-p.shape[1] // 64) * 64 + 64
        q = np.zeros((p.shape[0] + 2, stride), np.uint8)
        q[:p.shape[0], :p.shape[1]] = p
        keep.append(q)
        src[i], strides[i] = q.ctypes.data, stride
    stride = -(-3 * w // 64) * 64 + 192
    out = np.zeros((h + 2) * stride, np.uint8)
    SWS.sws_scale(ctx, src, strides, 0, h, (ctypes.c_void_p * 4)(out.ctypes.data),
                  (ctypes.c_int * 4)(stride))
    SWS.sws_freeContext(ctx)
    return out[:h * stride].reshape(h, stride)[:, :3 * w].reshape(h, w, 3)


def _round16(f: int) -> int:
    return max(-32768, min(32767, (f + (1 << 15)) >> 16))


# yuv420.h's yuv_coeffs(601, full range): crv, cbu, cgu, cgv scaled by 224/255
_C = dict(y=_round16((1 << 16) * 8192), vr=_round16(104597 * 224 // 255 * 8192),
          ug=_round16(-(25675 * 224 // 255) * 8192), vg=_round16(-(53279 * 224 // 255) * 8192),
          ub=_round16(132201 * 224 // 255 * 8192))


def model(Y, U, V, sy: int, sx: int) -> np.ndarray:
    """yuv420.h's conversion (nearest chroma), as BGR."""
    h, w = Y.shape
    up = lambda P: ((P.astype(np.int64).repeat(1 << sy, 0).repeat(1 << sx, 1)[:h, :w] << 3)
                    - 1024)  # noqa: E731
    u, v = up(U), up(V)
    yy = ((Y.astype(np.int64) << 3) * _C["y"]) >> 16
    r = yy + ((v * _C["vr"]) >> 16)
    g = yy + ((u * _C["ug"]) >> 16) + ((v * _C["vg"]) >> 16)
    b = yy + ((u * _C["ub"]) >> 16)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def _count(got, want, tally):
    d = np.abs(got.astype(np.int64) - want)
    tally["values"] += int(d.size)
    tally["differ"] += int((d > 0).sum())
    tally["max"] = max(tally["max"], int(d.max()))


def sweep(fmt: str) -> dict:
    """All (Y, U, V): chroma planes of 256 x 256 (U by row, V by column)
    under luma planes cycling through every Y."""
    sy, sx = SHIFTS[fmt]
    U = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 256, 1)
    V = U.T.copy()
    n = 1 << (sy + sx)
    tally = dict(values=0, differ=0, max=0)
    for k in range(-(-256 // n)):
        Y = np.zeros((256 << sy, 256 << sx), np.uint8)
        for dy in range(1 << sy):
            for dx in range(1 << sx):
                Y[dy::1 << sy, dx::1 << sx] = (k * n + (dy << sx) + dx) % 256
        _count(scale([Y, U, V], f"yuvj{fmt}p"), model(Y, U, V, sy, sx), tally)
    return tally


def sizes(fmt: str, rng) -> dict:
    """Random planes at every width from 1 to 39 (and 98, 100, 130, 131),
    at even and at odd heights apart."""
    sy, sx = SHIFTS[fmt]
    out = {}
    for parity in ("even", "odd"):
        tally = dict(values=0, differ=0, max=0)
        for h in ([2, 4, 6, 8, 16, 24, 50] if parity == "even" else [1, 3, 5, 9, 17, 49]):
            for w in list(range(1, 40)) + [98, 100, 130, 131]:
                planes = [rng.integers(0, 256, (h, w), dtype=np.uint8)] + [
                    rng.integers(0, 256, (-(-h >> sy), -(-w >> sx)), dtype=np.uint8)
                    for _ in range(2)]
                _count(scale(planes, f"yuvj{fmt}p"), model(*planes, sy, sx), tally)
        out[f"{parity}_heights"] = tally
    return out


def gray(rng) -> dict:
    tally = dict(values=0, differ=0, max=0)
    g = np.arange(256, dtype=np.uint8).reshape(16, 16)
    _count(scale([g], "gray"), np.repeat(g[..., None], 3, -1), tally)
    for h in (1, 2, 3, 5, 8, 17, 50):
        for w in list(range(1, 40)) + [98, 131]:
            g = rng.integers(0, 256, (h, w), dtype=np.uint8)
            _count(scale([g], "gray"), np.repeat(g[..., None], 3, -1), tally)
    return tally


def main():
    rng = np.random.default_rng(0)
    report = {f"yuvj{fmt}p": dict(all_triples=sweep(fmt), **sizes(fmt, rng)) for fmt in SHIFTS}
    report["gray"] = gray(rng)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
