"""Video input without cv2: the port's ``data/video.MP4Dataset`` (the
container walked in Python, MPEG-4 Part 2 decoded by the host library)
against the JAX package's ``MP4Dataset`` (``cv2.VideoCapture``, cv2 5.0.0).

Files that cv2 writes here from seeded frames (``tests/torch_video_files.py``):
``mp4v`` in ``.mp4`` and ``.mov``, ``XVID``, ``DIVX`` and ``FMP4`` in
``.avi``; 64x48, 640x480, widths that are not multiples of 16 or of 8;
noise and smooth content (the quantiser varies with both and with the
rate, which the writer scales with the fps); two GOPs or more.  Every
frame must be exactly cv2's, sequentially, after forward and backward
seeks and after ``subsample(4)``, with the same ``len``, ``fps`` and
timestamps.  The committed fixtures of ``chip_smoke.py`` phase 19 must
still be cv2's frames.  What the decoder does not take raises
``NotImplementedError``, corrupt data ``ValueError``.
"""

import hashlib
import json
import pathlib
import shutil

import cv2
import numpy as np
import pytest

from mast3r_slam_tpu.data.dataloader import MP4Dataset as JaxMP4Dataset
from mast3r_slam_tpu_torch.data import dataloader as tdl
from mast3r_slam_tpu_torch.data import video
from mast3r_slam_tpu_torch.utils import native

import torch_h264_files as hf
import torch_video_files as vf

DATA = pathlib.Path(__file__).resolve().parent / "data"
DIGESTS = json.loads((DATA / "video_fixtures.json").read_text())

# name -> (fourcc, content, width, height, frames, fps, seed)
CASES = {
    "mp4v-64x48-tex.mp4": ("mp4v", "tex", 64, 48, 26, 30.0, 0),
    "mp4v-64x48-smooth.mov": ("mp4v", "smooth", 64, 48, 26, 30.0, 1),
    "xvid-100x60-waves.avi": ("XVID", "waves", 100, 60, 26, 30.0, 2),
    "divx-98x50-tex.avi": ("DIVX", "tex", 98, 50, 26, 10.0, 3),
    "fmp4-72x40-smooth.avi": ("FMP4", "smooth", 72, 40, 26, 120.0, 4),
    "mp4v-640x480-tex.mp4": ("mp4v", "tex", 640, 480, 3, 30.0, 5),
    "mp4v-640x480-smooth.mov": ("mp4v", "smooth", 640, 480, 4, 30.0, 6),
}


def _write(tmp_path, name):
    fourcc, kind, w, h, n, fps, seed = CASES[name]
    path = tmp_path / name.replace("-", "_")
    vf.write_video(path, fourcc, vf.frames(kind, w, h, n, seed), fps)
    return path


def _reads(ds, order):
    """The uint8 frames at ``order``; None where the read raises ValueError."""
    out = []
    for i in order:
        try:
            img = ds.read_img(i)
        except ValueError:
            out.append(None)
            continue
        out.append(img)
    return out


def _same_reads(path, order, stride=1):
    want, got = JaxMP4Dataset(path), video.MP4Dataset(path)
    if stride > 1:
        want.subsample(stride)
        got.subsample(stride)
    assert len(got) == len(want) and got.fps == want.fps
    assert got.timestamps == want.timestamps
    for i, a, b in zip(order, _reads(got, order), _reads(want, order)):
        if b is None:
            assert a is None, f"frame {i}: cv2's read fails, the port's gives a frame"
            continue
        assert a is not None, f"frame {i}: the port's read fails"
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=f"{path.name} frame {i}")
    return want, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_frame_is_cv2s(tmp_path, name):
    """Sequential reads, then seeks back and forth across GOPs, then the
    dataset's float frames (``__getitem__``) and ``subsample(4)``."""
    path = _write(tmp_path, name)
    n = int(cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT))
    assert n == CASES[name][4]
    _same_reads(path, range(n))
    order = [n - 1, 0, n // 2, 1, n // 2 + 1, 13 % n, 12 % n, 2, n - 2]
    want, got = _same_reads(path, order)
    for i in (0, n - 1, 1):
        (ta, fa), (tb, fb) = got[i], want[i]
        assert ta == tb and fa.dtype == fb.dtype == np.float32
        np.testing.assert_array_equal(fa, fb)
    _same_reads(path, range(len(range(0, n, 4))), stride=4)


def test_a_not_coded_vop_shifts_the_frames_as_cv2_does(tmp_path):
    """libavcodec outputs no frame for a VOP with ``vop_coded`` 0: cv2's
    frames run one sample ahead from there and its last read fails; its
    seeks restart at the sync sample before ``t - 16`` and count frames
    out from there, so they land elsewhere than the sequential reads."""
    src = _write(tmp_path, "mp4v-64x48-tex.mp4")
    path = tmp_path / "nvop.mp4"
    path.write_bytes(vf.uncode_vop(vf.uncode_vop(src.read_bytes(), 3), 17))
    n = 26
    _same_reads(path, range(n))
    _same_reads(path, [20, 2, 19, 25, 24, 1, 0, 18, 17, 3])
    _same_reads(path, range(7), stride=4)


@pytest.mark.parametrize("suffix", ["mp4", "mov", "avi"])
def test_load_dataset_picks_the_ports_reader(tmp_path, suffix):
    src = {"mp4": "mp4v_64x48_tex.mp4", "mov": "mp4v_100x60_waves.mov",
           "avi": "xvid_98x50_tex.avi"}[suffix]
    path = tmp_path / f"clip.{suffix.upper() if suffix == 'mov' else suffix}"
    shutil.copy(DATA / "video_fixtures" / src, path)
    ds = tdl.load_dataset(str(path))
    assert type(ds) is video.MP4Dataset
    assert len(ds) == DIGESTS[f"video_fixtures/{src}"]["frame_count"]


def _digest(img):
    return None if img is None else hashlib.sha256(img.tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_committed_video_fixtures_agree_with_cv2(name):
    """The files ``chip_smoke.py`` phase 19 decodes on the card's host (no
    cv2 there; ``scripts/make_video_fixtures.py`` wrote them): their
    committed digests are still what the JAX package's dataset gives here,
    and the port's dataset gives those bytes."""
    want = DIGESTS[name]
    path = DATA / name
    jax = JaxMP4Dataset(path)
    assert [jax.total_frames, jax.fps] == [want["frame_count"], want["fps"]]
    assert [_digest(f) for f in _reads(jax, range(len(jax)))] == want["frames"]
    ds = video.MP4Dataset(path)
    assert [ds.total_frames, ds.fps] == [want["frame_count"], want["fps"]]
    assert [_digest(f) for f in _reads(ds, range(len(ds)))] == want["frames"]
    assert list(video.MP4Dataset(path).read_img(0).shape) == want["shape"]
    order = [t for t, _ in want["seeks"]]
    assert [_digest(f) for f in _reads(video.MP4Dataset(path), order)] == \
        [d for _, d in want["seeks"]]
    sub = video.MP4Dataset(path)
    sub.subsample(4)
    assert [_digest(f) for f in _reads(sub, range(len(sub)))] == want["subsample4"]


_C45, _S45 = np.cos(np.pi / 4), np.sin(np.pi / 4)
_C89, _S89 = np.cos(np.radians(89.6)), np.sin(np.radians(89.6))
# name -> (tkhd matrix (a, b, c, d), mvhd matrix, suffix)
ROTATIONS = {
    "identity": ((1, 0, 0, 1), hf.IDENTITY, ".mp4"),
    "90": ((0, 1, -1, 0), hf.IDENTITY, ".mp4"),
    "180": ((-1, 0, 0, -1), hf.IDENTITY, ".mp4"),
    "270": ((0, -1, 1, 0), hf.IDENTITY, ".mp4"),
    "mirror": ((-1, 0, 0, 1), hf.IDENTITY, ".mp4"),
    "45-degrees": ((_C45, _S45, -_S45, _C45), hf.IDENTITY, ".mp4"),
    "89.6-degrees": ((_C89, _S89, -_S89, _C89), hf.IDENTITY, ".mp4"),
    "transposed": ((0, 1, 1, 0), hf.IDENTITY, ".mp4"),
    "no-x-scale": ((0, 1, 0, 1), hf.IDENTITY, ".mp4"),
    "90-in-mov": ((0, 1, -1, 0), hf.IDENTITY, ".mov"),
    "270-by-the-movie": ((1, 0, 0, 1), (0, -1, 1, 0), ".mov"),
    "180-twice-90": ((0, 1, -1, 0), (0, 1, -1, 0), ".mp4"),
}


@pytest.mark.parametrize("name", sorted(ROTATIONS))
@pytest.mark.parametrize("codec", ["mp4v", "h264"])
def test_frames_turn_by_the_display_matrix_as_cv2_turns_them(tmp_path, codec, name):
    """cv2 5.0.0 turns every frame by the track's display matrix (FFmpeg's,
    times the movie's) when the angle rounds to 90, 180 or 270 degrees (a
    mirror reads as 180) and leaves other angles alone: sequential reads,
    seeks and subsample(4), in a cv2-written mp4v file and an H.264 one."""
    tkhd, mvhd, suffix = ROTATIONS[name]
    src = DATA / "video_fixtures" / ("mp4v_64x48_tex.mp4" if codec == "mp4v"
                                     else "h264_64x48_rot90.mp4")
    path = tmp_path / f"turned{suffix}"
    path.write_bytes(hf.set_matrix(hf.set_matrix(src.read_bytes(), tkhd), mvhd, b"mvhd"))
    _same_reads(path, range(6))
    _same_reads(path, [12, 3, 0, 13])
    _same_reads(path, range(3), stride=4)
    turned = video.read_mp4(path.read_bytes()).rotation
    assert turned == {"90": 90, "180": 180, "270": 270, "mirror": 180, "89.6-degrees": 90,
                      "transposed": 90, "90-in-mov": 90, "270-by-the-movie": 270,
                      "180-twice-90": 180}.get(name, 0)


@pytest.mark.parametrize("fourcc", ["MJPG", "MP42"])
def test_other_avi_codecs_raise_not_implemented(tmp_path, fourcc):
    """MS-MPEG4 (MP42) is refused when the file opens.  Motion-JPEG (MJPG)
    is read since item 17f's first part (tests/test_torch_mjpeg.py); what
    stays refused of it, here 4:4:4 pictures (libswscale converts them
    through its scaler), is refused at the read."""
    path = tmp_path / "clip.avi"
    frames = vf.frames("smooth", 64, 48, 3, 0)
    if fourcc == "MJPG":
        import torch_mjpeg_files as mf

        mf.write_avi(path, [mf.imencode(f, "444") for f in frames], 64, 48)
        with pytest.raises(NotImplementedError, match="item 17"):
            video.MP4Dataset(path).read_img(0)
        return
    vf.write_video(path, fourcc, frames)
    with pytest.raises(NotImplementedError, match="item 17"):
        video.MP4Dataset(path)


@pytest.mark.parametrize("fourcc", [b"avc1", b"hvc1", b"av01", b"mp4a"])
def test_other_sample_entries_raise_not_implemented(tmp_path, fourcc):
    """An ``mp4v`` file's sample entry renamed: another codec, refused."""
    path = tmp_path / "clip.mp4"
    data = (DATA / "video_fixtures" / "mp4v_64x48_tex.mp4").read_bytes()
    path.write_bytes(vf.set_stsd_fourcc(data, fourcc))
    with pytest.raises(NotImplementedError, match="item 17"):
        video.MP4Dataset(path)


@pytest.mark.parametrize("flag", ["interlaced", "sprite_enable", "not_8_bit", "quant_type",
                                  "low_delay"])
@pytest.mark.parametrize("src", ["mp4v_64x48_tex.mp4", "xvid_98x50_tex.avi"])
def test_unsupported_vol_flags_raise_not_implemented(tmp_path, flag, src):
    path = tmp_path / src
    path.write_bytes(vf.set_vol_flag((DATA / "video_fixtures" / src).read_bytes(), flag))
    with pytest.raises(NotImplementedError, match="item 17"):
        ds = video.MP4Dataset(path)
        ds.read_img(0)


def test_a_truncated_sample_raises_value_error(tmp_path):
    src = DATA / "video_fixtures" / "mp4v_64x48_tex.mp4"
    data = src.read_bytes()
    sizes = video.read_mp4(data).sizes
    path = tmp_path / "cut.mp4"
    path.write_bytes(vf.cut_sample(data, 4, int(sizes[4]) // 2))
    ds = video.MP4Dataset(path)
    for i in range(4):
        ds.read_img(i)
    with pytest.raises(ValueError, match="corrupt MPEG-4"):
        ds.read_img(4)
    # a seek decodes through the cut sample too
    with pytest.raises(ValueError, match="corrupt MPEG-4"):
        video.MP4Dataset(path).read_img(7)


def test_corrupt_samples_raise_value_error():
    """Random bytes after a VOP start code and a sample with no VOP."""
    data = (DATA / "video_fixtures" / "mp4v_64x48_tex.mp4").read_bytes()
    track = video.read_mp4(data)
    rng = np.random.default_rng(0)
    dec = native.Mpeg4Decoder(track.config)
    with pytest.raises(ValueError, match="without a VOP"):
        dec.decode(b"\x00\x00\x01\xb2junk")
    raised = 0
    for k in range(20):
        junk = vf.VOP_START + bytes([0x00]) + rng.integers(0, 256, 600, np.uint8).tobytes()
        try:
            dec.decode(junk)  # an I-VOP of random bits
        except ValueError:
            raised += 1
    assert raised == 20


def test_the_container_readers_refuse_damaged_files(tmp_path):
    data = (DATA / "video_fixtures" / "mp4v_64x48_tex.mp4").read_bytes()
    with pytest.raises(ValueError):
        video.read_mp4(data[:len(data) - 100])
    avi = (DATA / "video_fixtures" / "xvid_98x50_tex.avi").read_bytes()
    with pytest.raises(ValueError):
        video.read_avi(avi[:len(avi) // 2])


@pytest.mark.parametrize("seed", range(4))
def test_half_pel_averages_without_rounding_over_zero_pixels(tmp_path, seed):
    """A written stream (``torch_video_files.dc_stream``) of flat blocks at 0
    and odd levels moved by half-pel vectors, rounding type 1 and 0 in
    turn: where an average's pixel is 0, libavcodec's 8-wide halves (the
    chroma's) differ from exact ones unless asked to be bit-exact, and cv2
    gives theirs."""
    src = _write(tmp_path, "xvid-100x60-waves.avi")
    data = src.read_bytes()
    first = data[int(video.read_avi(data).offsets[0]):]
    headers = first[:first.index(vf.VOP_START)]
    mvs = [(1, 0), (0, 1), (0, 6), (6, 0), (1, 1), (0, -6), (3, 2), (2, 5), (-1, 6), (5, 0)]
    path = tmp_path / "dc.avi"
    vf.write_avi(path, vf.dc_stream(headers, 100, 60, mvs, seed), 100, 60)
    _same_reads(path, range(len(mvs) + 1))


@pytest.mark.parametrize("seed", range(6))
def test_random_streams_decode_as_cv2_decodes_them(tmp_path, seed):
    """Streams of random valid syntax (``torch_video_files.random_stream``):
    DQUANT, AC prediction across quantisers, the three escapes, f_code 1-3
    vectors, stuffing, not-coded and intra macroblocks in P-VOPs; every
    frame as cv2 gives it."""
    src = _write(tmp_path, "xvid-100x60-waves.avi")
    data = src.read_bytes()
    first = data[int(video.read_avi(data).offsets[0]):]
    headers = first[:first.index(vf.VOP_START)]
    path = tmp_path / "random.avi"
    vf.write_avi(path, vf.random_stream(headers, 100, 60, 8, seed), 100, 60)
    _same_reads(path, range(9))


@pytest.mark.parametrize("at", [1, 7, 20])
def test_a_resync_marker_inside_a_vop_is_refused(tmp_path, at):
    """A P-VOP whose bits hold, at a macroblock boundary, the stuffing and a
    resync marker (a video packet header) while its VOL says
    resync_marker_disable 1: libavcodec looks for the pattern after each
    macroblock whatever the VOL says (``mpeg4_is_resync``) and starts a
    video packet there, so cv2 reads the frames of the same stream without
    the packet header; the port refuses the stream, naming item 17."""
    src = _write(tmp_path, "xvid-100x60-waves.avi")
    data = src.read_bytes()
    first = data[int(video.read_avi(data).offsets[0]):]
    headers = first[:first.index(vf.VOP_START)]
    mvs = [(0, 0), (2, 0)]
    plain, marked = tmp_path / "plain.avi", tmp_path / "marked.avi"
    vf.write_avi(plain, vf.dc_stream(headers, 100, 60, mvs, at), 100, 60)
    vf.write_avi(marked, vf.dc_stream(headers, 100, 60, mvs, at, resync_at=at), 100, 60)
    want, got = JaxMP4Dataset(plain), JaxMP4Dataset(marked)
    assert len(got) == len(want) == 3
    for i in range(3):
        np.testing.assert_array_equal(got.read_img(i), want.read_img(i))
    ds = video.MP4Dataset(marked)
    ds.read_img(0)
    with pytest.raises(NotImplementedError, match="resync marker inside a VOP.*item 17"):
        ds.read_img(1)
    video.MP4Dataset(plain).read_img(2)
