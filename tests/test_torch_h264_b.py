"""H.264 B pictures without cv2: the port's ``data/video.MP4Dataset`` (the
host library's decoder, ``csrc/host/h264.cpp``) against the JAX package's
``MP4Dataset`` (``cv2.VideoCapture``, cv2 5.0.0) on streams of B pictures
written here (``tests/torch_h264_files.py``; cv2 holds no H.264 encoder).

One stream a feature (every B ``mb_type`` and ``sub_mb_type``, both direct
modes under both ``direct_8x8_inference_flag`` values, explicit weights in P
and B slices, implicit weights and their 32/32 fallback, list-1
modification, referenced B pictures, reorder depths 1 and 2, with and
without ``bitstream_restriction``), random syntax under CAVLC and CABAC, and
the containers that come with B pictures (``ctts`` of versions 0 and 1, the
edit FFmpeg's muxer writes, edits that cut frames, in ``.mp4``, ``.mov``
and ``.avi``).  Every frame must be exactly cv2's, read in order, in a
shuffled order and at stride 2, with the same ``len``, ``fps`` and
timestamps, and libavcodec must log no error while cv2 reads.
"""

import numpy as np
import pytest

from mast3r_slam_tpu.data.dataloader import MP4Dataset as JaxMP4Dataset
from mast3r_slam_tpu_torch.data import video

import torch_h264_files as hf

N = 14  # pictures a stream


def _write(path, samples, o, w, h, suffix, k=0, **mp4):
    path = path.with_suffix(suffix)
    if suffix == ".avi":
        hf.write_avi_h264(path, samples, w, h, fourcc=[b"H264", b"X264", b"avc1"][k % 3])
    else:
        hf.write_mp4(path, samples, w, h, fps=[30, 25, 60][k % 3], display=o["display"],
                     brand=b"qt  " if suffix == ".mov" else b"isom", **mp4)
    return path


def _reads(ds, order):
    out = []
    for i in order:
        try:
            out.append(ds.read_img(i))
        except ValueError:
            out.append(None)
    return out


def _same_reads(path, order, capfd, stride=1):
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
        np.testing.assert_array_equal(a, b, err_msg=f"{path.name} frame {i}")
    log = capfd.readouterr().err
    assert "[h264" not in log, log  # libavcodec logs at cv2's level (errors) nothing


def _all_reads(path, capfd, n=N):
    _same_reads(path, range(n), capfd)
    _same_reads(path, [n - 1, 0, n // 2, 1, n // 2 + 1, 11 % n, 2, n - 2, 7, 6], capfd)
    _same_reads(path, range(len(range(0, n, 2))), capfd, stride=2)


B = dict(bframes=2, max_ref=3)
# name -> (width, height, container, random_stream options over B's)
FEATURES = {
    "mb-types": (48, 32, ".mp4", dict()),
    "mb-types-cabac": (48, 32, ".mov", dict(cabac=True)),
    "sub-mb-types": (48, 32, ".avi", dict(b_types=[22])),
    "sub-mb-types-cabac": (48, 32, ".mp4", dict(b_types=[22], cabac=True)),
    "direct-spatial": (48, 32, ".mov", dict(direct="spatial", b_types=[0, 22])),
    "direct-spatial-4x4": (48, 32, ".avi", dict(direct="spatial", b_types=[0, 22],
                                                 direct8x8=False, t8=False, cabac=True)),
    "direct-temporal": (48, 32, ".mp4", dict(direct="temporal", b_types=[0, 22], cabac=True)),
    "direct-temporal-4x4": (48, 32, ".mov", dict(direct="temporal", b_types=[0, 22],
                                                  direct8x8=False, t8=False)),
    "explicit-weights-p": (48, 32, ".avi", dict(weighted=True)),
    "explicit-weights-b": (48, 32, ".mp4", dict(bipred_idc=1)),
    "explicit-weights-cabac": (48, 32, ".mov", dict(bipred_idc=1, weighted=True, cabac=True)),
    "implicit-weights": (48, 32, ".avi", dict(bipred_idc=2, max_ref=4, pyramid=True,
                                              bframes=3)),
    "implicit-fallback": (48, 32, ".mp4", dict(bipred_idc=2, b_anchor=1.0, max_ref=4,
                                               cabac=True)),
    "list-modification": (48, 32, ".mov", dict(modify=True, max_ref=4, direct="spatial")),
    "referenced-b-mmco": (48, 32, ".avi", dict(b_ref=0.5, mmco=True, max_ref=4, cabac=True)),
    "reorder-depth-1": (48, 32, ".mp4", dict(bframes=1)),
    "reorder-depth-2": (48, 32, ".avi", dict(bframes=3, pyramid=True, max_ref=4)),
    "bitstream-restriction": (48, 32, ".mov", dict(vui=dict(reorder=2, timing=True))),
    "slices": (64, 48, ".mp4", dict(slices=3, modify=True, max_ref=4, direct="temporal")),
    "vectors-far-out": (32, 16, ".avi", dict(far_mv=True, mvd=64)),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_each_b_feature_reads_as_cv2_reads_it(tmp_path, capfd, name):
    w, h, suffix, kw = FEATURES[name]
    k = sorted(FEATURES).index(name)
    samples, o = hf.random_stream(w, h, N, 200 + k, gop=N, **{**B, **kw})
    _all_reads(_write(tmp_path / name, samples, o, w, h, suffix, k), capfd)


def _random_options(seed: int) -> dict:
    rng = np.random.default_rng(3000 + seed)
    kw = dict(bframes=int(rng.integers(1, 4)), pyramid=bool(rng.random() < 0.5),
              max_ref=int(rng.integers(2, 5)), b_ref=float(rng.choice([0.0, 0.3])),
              b_anchor=float(rng.choice([0.0, 0.2])), modify=bool(rng.random() < 0.5),
              mmco=bool(rng.random() < 0.3), bipred_idc=int(rng.integers(0, 3)),
              weighted=bool(rng.random() < 0.5), direct8x8=bool(rng.random() < 0.7))
    if not kw["direct8x8"]:
        kw["t8"] = False
    if rng.random() < 0.4:
        kw["slices"] = int(rng.integers(2, 4))
    return kw


RANDOM = [(seed, cabac) for cabac in (False, True) for seed in range(3)]


@pytest.mark.parametrize("seed,cabac", RANDOM,
                         ids=[f"cabac-{s}" if c else str(s) for s, c in RANDOM])
def test_random_b_streams_decode_as_cv2_decodes_them(tmp_path, capfd, seed, cabac):
    """Random valid syntax over a random mix of the B features, an IDR
    picture every 7 (closed groups)."""
    w, h = [(48, 32), (40, 24), (64, 48)][seed % 3]
    samples, o = hf.random_stream(w, h, N, 400 + seed + 50 * cabac, gop=7, cabac=cabac,
                                  **_random_options(seed + 10 * cabac))
    path = _write(tmp_path / f"random{seed}", samples, o, w, h, [".mp4", ".mov", ".avi"][seed],
                  seed)
    _all_reads(path, capfd)


# name -> (write_mp4 options, B pictures): composition offsets and edits
CONTAINERS = {
    "ctts-v0-ffmpeg-edit": (dict(), True),
    "ctts-v0-no-edit": (dict(edits=None), True),
    "ctts-v1-negative": (dict(ctts_version=1, edits=None), True),
    "ctts-v1-edit": (dict(ctts_version=1), True),
    "edit-cuts-the-first-frames": (dict(edits=[(1000, 3)]), True),
    "edit-cuts-the-last-frames": (dict(edits=[(300, 1)]), True),
    "edit-of-no-duration": (dict(edits=[(0, 1)]), True),
    "p-only-edit-cuts-the-last-frames": (dict(edits=[(200, 0)]), False),
}


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_composition_offsets_and_edits_read_as_cv2_reads_them(tmp_path, capfd, name):
    """``ctts`` and the one edit: frames outside the edit (before its media
    time, past its duration) are decoded and not shown, as FFmpeg drops
    them, while the frame count stays the track's sample count.  The last
    case held for P pictures before B pictures were ported: the edit's
    duration was ignored, so the port gave frames that cv2 does not."""
    mp4, bframes = CONTAINERS[name]
    samples, o = hf.random_stream(32, 16, N, 300 + sorted(CONTAINERS).index(name), gop=7,
                                  **(B if bframes else {}))
    _all_reads(_write(tmp_path / name, samples, o, 32, 16, ".mp4", **mp4), capfd)


@pytest.mark.parametrize("edits", [[(400, 0), (400, 400)], [(100, -1), (400, 0)]],
                         ids=["two-edits", "an-empty-edit"])
def test_other_edit_lists_are_refused(tmp_path, edits):
    samples, o = hf.random_stream(32, 16, 6, 0, gop=6, **B)
    path = _write(tmp_path / "clip", samples, o, 32, 16, ".mp4", edits=edits)
    with pytest.raises(NotImplementedError, match="item 17"):
        video.MP4Dataset(path)


SEED_MISSING = 0  # a stream whose direct blocks name a picture list 0 lacks


def test_damaged_b_streams_raise_value_error():
    """B slices cut short anywhere, under CAVLC and CABAC, and a temporal
    direct block whose co-located reference is not in list 0."""
    from mast3r_slam_tpu_torch.utils import native

    rng = np.random.default_rng(5)
    for cabac in (False, True):
        samples, o = hf.random_stream(48, 32, 4, 7, gop=4, cabac=cabac, **B)
        dec = native.H264Decoder()
        for k in range(10):
            j = 2 + k % 2  # one of the two B pictures (after I0 and P3)
            cut = [u[:int(rng.integers(2, max(len(u) - 2, 3)))] if u[0] & 31 == 1 else u
                   for u in samples[j]]
            dec.reset()
            for i in range(j):
                dec.decode(hf.annexb(samples[i]), i)
            with pytest.raises(ValueError, match="corrupt H.264"):
                dec.decode(hf.annexb(cut), j)
    samples, o = hf.random_stream(48, 32, 7, SEED_MISSING, gop=7, direct="temporal",
                                  b_types=[0], temporal_l0=1, **B)
    dec = native.H264Decoder()
    with pytest.raises(ValueError, match="co-located reference is not in list 0"):
        for i, s in enumerate(samples):
            dec.decode(hf.annexb(s), i)


@pytest.mark.parametrize("change", ["pic-init-qp", "transform-8x8"])
def test_parameter_sets_changed_in_band_then_a_seek_back_read_as_cv2_or_are_refused(
        tmp_path, capfd, change):
    """ROADMAP Queue 3 item 28: a stream whose SPS and PPS (ids 0) change in
    band at its second IDR picture (frame 7), in ISO BMFF (the first sets in
    avcC only).  Read in order every frame is cv2's.  After a seek back
    before the change, the IDR picture the seek restarts at carries no
    parameter sets of its own: libavcodec decodes it and its followers
    under the changed ones otherwise than the port would, or conceals data
    that no longer parses, so the port refuses those frames (where the
    data parses, it reads the frames after the change as cv2 does); an
    AVI, whose first sample carries its sets, reads as cv2 reads it."""
    a_kw, b_kw = {"pic-init-qp": (dict(init_qp=28), dict(init_qp=36)),
                  "transform-8x8": (dict(t8=False), dict(t8=True))}[change]
    a, _ = hf.random_stream(48, 32, 7, 1, gop=7, **a_kw)
    b, _ = hf.random_stream(48, 32, 7, 2, gop=7, **b_kw)
    assert [u for u in a[0] if u[0] & 31 in (7, 8)] != [u for u in b[0] if u[0] & 31 in (7, 8)]
    o = dict(display=list(range(14)))
    order = [10, 2, 3, 12, 1]
    for suffix in (".mp4", ".avi"):
        path = _write(tmp_path / change, a + b, o, 48, 32, suffix)
        _same_reads(path, range(14), capfd)
        want = _reads(JaxMP4Dataset(path), order)
        ds, got = video.MP4Dataset(path), []
        for i in order:
            try:
                got.append(ds.read_img(i))
            except NotImplementedError as e:
                assert "ROADMAP Queue 1 item 17" in str(e)
                got.append("refused")
            except ValueError:
                got.append(None)
        refused = [i for i, x in zip(order, got) if isinstance(x, str)]
        if suffix == ".avi":
            assert refused == []
        elif change == "pic-init-qp":
            assert refused == [2, 3, 1]
        else:
            assert {2, 3, 1} <= set(refused)
        for i, x, y in zip(order, got, want):
            if isinstance(x, str):
                continue
            assert (x is None) == (y is None), f"{suffix} frame {i}"
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"{suffix} frame {i}")
        capfd.readouterr()  # libavcodec's concealment logs after the seek back


def _changed_stream(change, n_after):
    """Stream ``a`` (frames 0-6) under one SPS and PPS (ids 0), then ``n_after``
    frames under changed ones that only frame 7's sample carries (an IDR
    picture every 7 frames)."""
    a_kw, b_kw = {"pic-init-qp": (dict(init_qp=28), dict(init_qp=36)),
                  "transform-8x8": (dict(t8=False), dict(t8=True))}[change]
    a, _ = hf.random_stream(48, 32, 7, 1, gop=7, **a_kw)
    b, _ = hf.random_stream(48, 32, n_after, 2, gop=7, **b_kw)
    assert [u for u in a[0] if u[0] & 31 in (7, 8)] != [u for u in b[0] if u[0] & 31 in (7, 8)]
    assert all(u[0] & 31 not in (7, 8) for s in b[1:] for u in s)
    return a + b


@pytest.mark.parametrize("change", ["pic-init-qp", "transform-8x8"])
def test_parameter_sets_changed_in_band_read_as_cv2_in_order_and_at_stride_2(
        tmp_path, capfd, change):
    """ROADMAP Queue 3 item 28, the reads that need no refusal: a third IDR
    picture (frame 14) after the change carries no parameter sets of its
    own, encoded under the changed ones that are in force.  Read in order,
    every frame of the .mp4 and the .avi is cv2's.  Read at stride 2 (every
    read a seek that restarts at frame 0), each frame is cv2's or refused
    (frames 0-6 decoded under the changed sets); in the .avi, whose first
    sample carries its sets, and where the data parses under the changed
    sets, none from the change on is refused."""
    samples = _changed_stream(change, 14)
    o = dict(display=list(range(21)))
    for suffix in (".mp4", ".avi"):
        path = _write(tmp_path / change, samples, o, 48, 32, suffix)
        _same_reads(path, range(21), capfd)
        want, ds = JaxMP4Dataset(path), video.MP4Dataset(path)
        want.subsample(2)
        ds.subsample(2)
        refused = []
        for i in range(len(ds)):
            y = want.read_img(i)
            try:
                np.testing.assert_array_equal(ds.read_img(i), y, err_msg=f"{suffix} frame {2 * i}")
            except NotImplementedError as e:
                assert "ROADMAP Queue 3 item 28" in str(e)
                refused.append(2 * i)
        if suffix == ".avi":
            assert refused == []
        elif change == "pic-init-qp":
            assert max(refused, default=0) < 7
        capfd.readouterr()  # libavcodec's concealment logs after a seek back


def test_a_seek_past_changed_parameter_sets_never_fed_is_refused(tmp_path, monkeypatch):
    """ROADMAP Queue 3 item 28: with one frame thread (nothing decoded ahead),
    a read of frame 0 then of frame 34 restarts at frame 14's IDR picture:
    the sample of frame 7, which carries the changed parameter sets, is
    never fed, so frame 14 would be decoded under the first ones.  The
    port reads the skipped samples' sets (``H264Decoder.expect``) and
    refuses such frames; read in order, frame 34 is cv2's."""
    monkeypatch.setattr(video, "FRAME_THREADS", 1)
    path = _write(tmp_path / "skip", _changed_stream("pic-init-qp", 35),
                  dict(display=list(range(42))), 48, 32, ".mp4")
    ds = video.MP4Dataset(path)
    ds.read_img(0)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3 item 28"):
        ds.read_img(34)
    ds = video.MP4Dataset(path)
    want = JaxMP4Dataset(path)
    for i in range(35):
        np.testing.assert_array_equal(ds.read_img(i), want.read_img(i), err_msg=f"frame {i}")
