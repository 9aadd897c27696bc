"""Time the host library's 8-bit HEVC decode against another checkout's.

Builds the host library of this checkout and of another one (say the
parent commit, unpacked with ``git archive``), loads both into one process
and decodes the 8-bit HEVC fixtures of ``tests/data/video_fixtures`` with
each (every picture decoded and converted to RGB, B streams drained at the
end), whole files in turn as other, this, this, other, ``--rounds`` times
a file.  It prints, for each file, each library's median milliseconds a
frame, whole and split into the decode and the conversion to RGB, and the
ratios this / other.  Host only: no GPU is used.

    git archive HEAD~1 | tar x -C /tmp/parent
    python scripts/time_hevc8_host.py --other /tmp/parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mast3r_slam_tpu_torch.data import video  # noqa: E402

FIXTURES = ROOT / "tests" / "data" / "video_fixtures"
FILES = ["hevc_480x640_smooth.mp4", "hevc_1080x1920_smooth.mp4", "hevc_b_480x640_smooth.mp4",
         "hevc_b_1080x1920_smooth.mp4", "hevc_64x48_random.mp4", "hevc_b_64x48_random.mp4"]
_P = ctypes.c_void_p


def library(root: Path) -> ctypes.CDLL:
    """The host library of the checkout at ``root``, built by its own
    ``utils/native.py`` in a process of its own."""
    path = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from mast3r_slam_tpu_torch.utils import native; print(native.build())", str(root)],
        capture_output=True, text=True, check=True).stdout.split()[-1]
    lib = ctypes.CDLL(path)
    lib.hevc_open.argtypes = [_P, ctypes.c_int64, ctypes.c_int, ctypes.POINTER(_P), _P, ctypes.c_int]
    lib.hevc_decode.argtypes = [_P, _P, ctypes.c_int64, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int64), _P, ctypes.c_int]
    lib.hevc_drain.argtypes = [_P, ctypes.POINTER(ctypes.c_int64)]
    lib.hevc_rgb.argtypes = [_P, _P]
    lib.hevc_close.argtypes = [_P]
    return lib


def decode_ms(lib, track, samples, rgb) -> tuple:
    """Milliseconds a frame of one whole decode of the file: (decode, RGB)."""
    state, err, shown = _P(), ctypes.create_string_buffer(256), ctypes.c_int64()
    cfg = np.frombuffer(track.config, dtype=np.uint8)
    if lib.hevc_open(cfg.ctypes.data, cfg.size, track.length_size, ctypes.byref(state), err, 256):
        raise RuntimeError(err.value)
    frames, t_dec, t_rgb, i = 0, 0.0, 0.0, 0
    while True:  # each sample, then each picture held back
        t0 = time.perf_counter()
        if i < len(samples):
            s = samples[i]
            if lib.hevc_decode(state, s.ctypes.data, s.size, i, ctypes.byref(shown), err, 256):
                raise RuntimeError(err.value)
        else:
            lib.hevc_drain(state, ctypes.byref(shown))
        t1 = time.perf_counter()
        t_dec += t1 - t0
        i += 1
        if shown.value < 0 and i > len(samples):
            break
        if shown.value >= 0:
            lib.hevc_rgb(state, rgb.ctypes.data)
            t_rgb += time.perf_counter() - t1
            frames += 1
    lib.hevc_close(state)
    return t_dec * 1e3 / frames, t_rgb * 1e3 / frames


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=10, help="(other, this, this, other) a file")
    args = ap.parse_args()
    libs = {"other": library(args.other.resolve()), "this": library(ROOT)}
    report = {}
    for name in FILES:
        data, track = video.read_track(FIXTURES / name)
        samples = [np.frombuffer(bytes(data[int(a):int(a) + int(n)]), dtype=np.uint8)
                   for a, n in zip(track.offsets, track.sizes)]
        rgb = np.empty((track.height, track.width, 3), dtype=np.uint8)
        runs = {"other": [], "this": []}
        for side in ("other", "this") * 2:  # warm both
            decode_ms(libs[side], track, samples, rgb)
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                runs[side].append(decode_ms(libs[side], track, samples, rgb))
        r = {}
        for part, pick in (("whole", sum), ("decode", lambda p: p[0]), ("rgb", lambda p: p[1])):
            other, this = (statistics.median(pick(p) for p in runs[s]) for s in ("other", "this"))
            r[part] = dict(other_ms=other, this_ms=this, ratio=this / other)
        r["passes"] = len(runs["this"])
        report[name] = r
        print(f"{name} ({r['passes']} passes each): " + "; ".join(
            f"{part} other {r[part]['other_ms']:.4f} ms a frame, this {r[part]['this_ms']:.4f}, "
            f"this/other {r[part]['ratio']:.4f}" for part in ("whole", "decode", "rgb")), flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
