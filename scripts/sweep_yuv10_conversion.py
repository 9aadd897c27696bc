"""Hold the port's model of libswscale's scaled conversion of 9- and 10-bit
4:2:0 samples to BGR24 (``csrc/host/swscale.h``, through the host
library's ``yuv420_high_rgb``) against cv2's own libswscale, called through
``ctypes`` as cv2 5.0.0 sets it up for a decoded frame: ``sws_alloc_context``
at the frame's own size, SWS_BICUBIC, the chroma site as ``src_h_chr_pos``
/ ``src_v_chr_pos``, then ``sws_setColorspaceDetails`` with the frame's
matrix class and range.  For yuv420p9 and yuv420p10, limited and full
range, matrix_coefficients 1, 4, 5/6 (BT.601), 7 and 9, it runs

  every Y under a grid of (U, V) pairs  every sample value of luma beneath
                      each pair of a 33 x 33 grid of (U, V) (the chroma
                      changing from row to row and from column to
                      column), chroma sited left (HEVC's default)
  random planes       at every even width from 2 to 40 and a few wider
                      ones, at even heights from 2 to 50, chroma sited at
                      each of the six chroma_sample_loc_type sites in turn

and prints, per depth, range and matrix, how many output values differ
and by how much.  Needs cv2 (its libraries), so it runs where the tests run:

    python scripts/sweep_yuv10_conversion.py
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from mast3r_slam_tpu_torch.utils import native  # noqa: E402

# chroma_sample_loc_type -> (src_h_chr_pos, src_v_chr_pos), in 1/256 luma sample
SITES = {0: (0, 128), 1: (128, 128), 2: (0, 0), 3: (128, 0), 4: (0, 256), 5: (128, 256)}
# matrix_coefficients -> the sws_getCoefficients index cv2's frame passes
MATRICES = {1: 1, 4: 4, 5: 5, 6: 5, 7: 7, 9: 9}


def _swscale():
    import cv2

    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    load = lambda name: ctypes.CDLL(glob.glob(os.path.join(libs, f"lib{name}-*.so*"))[0],
                                    mode=ctypes.RTLD_GLOBAL)  # noqa: E731
    avutil, sws = load("avutil"), load("swscale")
    avutil.av_log_set_level(-8)
    avutil.av_get_pix_fmt.argtypes = [ctypes.c_char_p]
    avutil.av_opt_set_int.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    sws.sws_alloc_context.restype = ctypes.c_void_p
    sws.sws_init_context.argtypes = [ctypes.c_void_p] * 3
    sws.sws_getCoefficients.restype = ctypes.c_void_p
    sws.sws_getCoefficients.argtypes = [ctypes.c_int]
    sws.sws_setColorspaceDetails.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_void_p] + [ctypes.c_int] * 4
    sws.sws_scale.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    sws.sws_freeContext.argtypes = [ctypes.c_void_p]
    return avutil, sws


AVUTIL, SWS = _swscale()


def scale(planes, depth: int, matrix: int, full: bool, site: int) -> np.ndarray:
    """BGR24 of 16-bit ``planes`` through libswscale, strides padded as
    libavcodec's frames and cv2's buffer are."""
    h, w = planes[0].shape
    ctx = SWS.sws_alloc_context()
    xpos, ypos = SITES[site]
    opts = dict(sws_flags=4, srcw=w, srch=h, dstw=w, dsth=h, src_h_chr_pos=xpos,
                src_v_chr_pos=ypos, src_format=AVUTIL.av_get_pix_fmt(f"yuv420p{depth}le".encode()),
                dst_format=AVUTIL.av_get_pix_fmt(b"bgr24"))
    for k, v in opts.items():
        assert AVUTIL.av_opt_set_int(ctx, k.encode(), v, 0) >= 0, k
    assert SWS.sws_init_context(ctx, None, None) >= 0
    SWS.sws_setColorspaceDetails(ctx, SWS.sws_getCoefficients(MATRICES[matrix]), int(full),
                                 SWS.sws_getCoefficients(5), 0, 0, 1 << 16, 1 << 16)
    src, strides, keep = (ctypes.c_void_p * 4)(), (ctypes.c_int * 4)(), []
    for i, p in enumerate(planes):
        stride = -(-p.shape[1] * 2 // 64) * 64 + 64
        q = np.zeros((p.shape[0] + 2, stride // 2), np.uint16)
        q[:p.shape[0], :p.shape[1]] = p
        keep.append(q)
        src[i], strides[i] = q.ctypes.data, stride
    stride = -(-3 * w // 64) * 64 + 192
    out = np.zeros((h + 2) * stride, np.uint8)
    SWS.sws_scale(ctx, src, strides, 0, h, (ctypes.c_void_p * 4)(out.ctypes.data),
                  (ctypes.c_int * 4)(stride))
    SWS.sws_freeContext(ctx)
    return out[:h * stride].reshape(h, stride)[:, :3 * w].reshape(h, w, 3)


def model(planes, depth: int, matrix: int, full: bool, site: int) -> np.ndarray:
    """swscale.h's conversion, as BGR."""
    h, w = planes[0].shape
    out = np.zeros((h, w, 3), np.uint8)
    src = [np.ascontiguousarray(p, np.uint16) for p in planes]
    rc = native.load().yuv420_high_rgb(*[native._ptr(p, native._U16P) for p in src], w, h, depth,
                                       matrix, int(full), site, native._ptr(out, native._U8P))
    assert rc == 0
    return out[..., ::-1]


def _count(planes, depth, matrix, full, site, tally):
    d = np.abs(scale(planes, depth, matrix, full, site).astype(np.int64)
               - model(planes, depth, matrix, full, site))
    tally["values"] += int(d.size)
    tally["differ"] += int((d > 0).sum())
    tally["max"] = max(tally["max"], int(d.max()))


def grid(depth, matrix, full) -> dict:
    """Every Y beneath each of 33 x 33 (U, V) pairs: chroma planes of
    66 x 66 samples (U stepping down the rows, V across the columns, each
    pair on 2 x 2 chroma samples, so 4 x 4 luma samples), under luma
    planes whose 4 x 4 blocks take 16 values a frame, every value over
    the frames."""
    top = (1 << depth) - 1
    steps = np.minimum(np.arange(33) * (1 << (depth - 5)), top).repeat(2)
    U = np.repeat(steps[:, None], 66, 1)
    V = U.T.copy()
    tally = dict(values=0, differ=0, max=0)
    yy, xx = np.mgrid[0:132, 0:132]
    for frame in range((top + 1) // 16):
        Y = frame * 16 + (yy % 4) * 4 + xx % 4
        _count([Y, U, V], depth, matrix, full, 0, tally)
    return tally


def sizes(depth, matrix, full, rng) -> dict:
    """Random planes at every even width from 2 to 40 and 64, 98, 130, at
    even heights from 2 to 50, each chroma site in turn."""
    top = (1 << depth) - 1
    tally = dict(values=0, differ=0, max=0)
    k = 0
    for h in range(2, 52, 2):
        for w in list(range(2, 42, 2)) + [64, 98, 130]:
            planes = [rng.integers(0, top + 1, (h, w))] + [
                rng.integers(0, top + 1, (h // 2, w // 2)) for _ in range(2)]
            _count(planes, depth, matrix, full, k % 6, tally)
            k += 1
    return tally


def main():
    rng = np.random.default_rng(0)
    report = {}
    for depth in (9, 10):
        for full in (False, True):
            for matrix in (1, 4, 5, 7, 9):
                key = f"yuv420p{depth}_{'full' if full else 'limited'}_matrix{matrix}"
                report[key] = dict(grid=grid(depth, matrix, full),
                                   sizes=sizes(depth, matrix, full, rng))
    total = dict(values=sum(r[k]["values"] for r in report.values() for k in r),
                 differ=sum(r[k]["differ"] for r in report.values() for k in r),
                 max=max(r[k]["max"] for r in report.values() for k in r))
    print(json.dumps(dict(cases=report, total=total), indent=1))


if __name__ == "__main__":
    main()
