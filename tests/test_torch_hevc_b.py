"""HEVC B slices and leading pictures without cv2: the port's
``data/video.MP4Dataset`` (``csrc/host/hevc.cpp``) against the JAX
package's ``MP4Dataset`` (``cv2.VideoCapture``, cv2 5.0.0) on streams
written here (``tests/torch_hevc_files.py``: cv2 decodes HEVC but cannot
encode it) as x265 orders them: anchors a few pictures apart,
hierarchical B pictures between, coded after the anchor; IRAP pictures
whose B pictures before them are RASL pictures (open GOP), RADL pictures,
or coded before them; BLA pictures.

Random B syntax at several seeds, and one stream a feature (combined
bi-predictive merge candidates, ``mvd_l1_zero_flag``, the collocated
picture in list 1, explicit bi-prediction weights, no bi-prediction for
8x4 and 4x8 blocks, RASL pictures at the start and mid-stream, RADL, BLA),
in ``.mp4`` (``hvc1`` behind FFmpeg's ``ctts`` and edit, ``hev1`` with the
parameter sets in band), ``.mov`` and ``.avi``.  Every frame must be
exactly cv2's, sequentially, after forward and backward seeks (one
landing on a RASL frame, one on its CRA picture) and after
``subsample(4)``, with the same ``len``, ``fps`` and timestamps, and
libavcodec must log no error while cv2 reads.  What the decoder does not
take raises ``NotImplementedError`` naming ROADMAP Queue 1 item 17.  The
committed fixtures of ``chip_smoke.py`` phase 24 must still be cv2's.
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest

from mast3r_slam_tpu.data.dataloader import MP4Dataset as JaxMP4Dataset
from mast3r_slam_tpu_torch.data import video
from mast3r_slam_tpu_torch.utils import native

import torch_hevc_files as hv

DATA = pathlib.Path(__file__).resolve().parent / "data"
DIGESTS = {k: v for k, v in json.loads((DATA / "hevc_fixtures.json").read_text()).items()
           if "hevc_b_" in k}
N = 14  # pictures a stream
# libavcodec's own error for each slice after the first of a RASL picture
# it leaves out (the first one, not decoded, set no PPS): logged, harmless
SKIPPED_SLICE = "PPS changed between slices."


def _write(path, samples, o, w, h, suffix, k=0):
    """``samples`` into ``path`` + ``suffix``: in ISO BMFF behind FFmpeg's
    ``ctts`` and edit (``hvc1``, or ``hev1`` with the parameter sets in band
    by ``k``), or Annex B in AVI."""
    path = path.with_suffix(suffix)
    if suffix == ".avi":
        hv.write_avi(path, samples, w, h, fourcc=[b"HEVC", b"H265"][k % 2])
    else:
        hv.write_mp4(path, samples, w, h, fps=[30, 25][k % 2], display=o["display"],
                     fourcc=b"hev1" if k % 2 else b"hvc1", config_in_band=bool(k % 2),
                     brand=b"qt  " if suffix == ".mov" else b"isom")
    return path


def _reads(ds, order):
    out = []
    for i in order:
        try:
            out.append(ds.read_img(i))
        except ValueError:
            out.append(None)
    return out


def _same_reads(path, order, capfd, stride=1, allowed=()):
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
    log = [line for line in capfd.readouterr().err.splitlines()
           if "[hevc" in line and not any(a in line for a in allowed)]
    assert not log, log  # libavcodec logs at cv2's level (errors) nothing


def _all_reads(path, capfd, n, allowed=()):
    _same_reads(path, range(n), capfd, allowed=allowed)
    _same_reads(path, [n - 1, 0, n // 2, 1, n // 2 + 1, 12 % n, 11 % n, 2, n - 2, 7, 6, 5], capfd,
                allowed=allowed)
    _same_reads(path, range(len(range(0, n, 4))), capfd, stride=4, allowed=allowed)


@pytest.mark.parametrize("seed", range(8))
def test_random_b_syntax_reads_as_cv2_reads_it(tmp_path, capfd, seed):
    """Every tool drawn from the seed, B pictures 1 to 3 apart, pyramids or
    not, each IRAP picture of any style (``hv.IRAP_STYLES``)."""
    w, h = [(64, 48), (56, 40), (48, 32), (40, 48)][seed % 4]
    samples, o = hv.random_stream(w, h, N, 400 + seed, gop=[8, 6, 4][seed % 3],
                                  bframes=[3, 2, 1, 3][seed % 4], pyramid=seed % 3 != 2,
                                  styles=tuple(hv.IRAP_STYLES), slices=1 + seed % 2)
    path = _write(tmp_path / f"random{seed}", samples, o, w, h,
                  [".mp4", ".avi", ".mov", ".mp4"][seed % 4], seed // 4)
    _all_reads(path, capfd, N, allowed=(SKIPPED_SLICE,))


# name -> (width, height, container, random_stream options); B pictures 3 apart
FEATURES = {
    "combined-bi-predictive-merge": (64, 48, ".mp4", dict(
        p_merge=1.0, p_skip=0.3, tmvp=False, slice_over=dict(max_merge=5))),
    "combined-merge-after-tmvp": (48, 32, ".avi", dict(
        p_merge=1.0, p_skip=0.3, tmvp=True, slice_over=dict(max_merge=5))),
    "mvd-l1-zero": (64, 48, ".mov", dict(p_mvd_l1_zero=1.0, dirs=[hv.PRED_BI], p_merge=0.1)),
    "collocated-in-list-1": (64, 48, ".mp4", dict(tmvp=True, p_col_l0=0.0, p_merge=0.6)),
    "collocated-in-list-0": (48, 32, ".mp4", dict(tmvp=True, p_col_l0=1.0, p_merge=0.6)),
    "explicit-bi-prediction-weights": (64, 48, ".avi", dict(
        max_ref=3, dirs=[hv.PRED_BI, hv.PRED_L0, hv.PRED_L1],
        pps=dict(weighted=True, weighted_bipred=True))),
    "no-bi-prediction-for-8x4-and-4x8": (48, 32, ".mov", dict(
        log2_ctb=4, amp=False, parts=[hv.PART_2NxN, hv.PART_Nx2N], p_merge=0.9, p_skip=0.0)),
    "amvp-in-list-1": (48, 32, ".mp4", dict(p_merge=0.0, p_skip=0.0, dirs=[hv.PRED_L1],
                                            max_ref=3, num_ref=3)),
    "b-slices-of-past-references": (48, 32, ".avi", dict(gpb=1.0, tmvp=True)),
    "rasl-at-the-start": (64, 48, ".mp4", dict(start_cra=True, styles=("cra-rasl",), slices=1)),
    "rasl-at-the-start-in-avi": (48, 32, ".avi", dict(start_cra=True, styles=("cra-rasl",),
                                                      slices=1)),
    "rasl-mid-stream": (64, 48, ".mov", dict(styles=("cra-rasl",), gop=4)),
    "radl": (48, 32, ".mp4", dict(styles=("idr-radl", "cra-radl"), gop=4)),
    "bla": (48, 32, ".mp4", dict(styles=("bla-rasl", "bla-radl", "bla"), gop=4, slices=1)),
    "b-pictures-in-order": (48, 32, ".avi", dict(pyramid=False, bframes=2, b_ref=0.5)),
    "reorder-and-dpb-beyond-need": (48, 32, ".mov", dict(reorder=4, dpb=9)),
    "wpp-and-slices": (64, 48, ".mp4", dict(pps=dict(wpp=True), slices=3, log2_ctb=4,
                                            styles=("idr", "cra-radl"))),
    "pic-output-flag": (48, 32, ".mp4", dict(hidden=0.3)),
    "vectors-far-out": (32, 16, ".avi", dict(far_mv=True, mvd=64)),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_each_b_feature_reads_as_cv2_reads_it(tmp_path, capfd, name):
    w, h, suffix, kw = FEATURES[name]
    k = sorted(FEATURES).index(name)
    kw = {"gop": 8, "bframes": 3, **kw}
    samples, o = hv.random_stream(w, h, N, 500 + k, **kw)
    path = _write(tmp_path / name, samples, o, w, h, suffix, k)
    _all_reads(path, capfd, N)


def test_multi_slice_rasl_pictures_left_out_read_as_cv2_reads_them(tmp_path, capfd):
    """A stream opening with a CRA picture whose RASL pictures have three
    slices: none decoded, none shown; libavcodec logs its own error for
    each later slice (``SKIPPED_SLICE``), which is allowed here alone."""
    samples, o = hv.random_stream(64, 48, N, 620, gop=8, bframes=3, start_cra=True,
                                  styles=("cra-rasl",), slices=3, log2_ctb=4)
    path = _write(tmp_path / "sliced", samples, o, 64, 48, ".mp4")
    _all_reads(path, capfd, len(samples), allowed=(SKIPPED_SLICE,))


def test_seeks_to_a_rasl_frame_and_its_cra_read_as_cv2_reads_them(tmp_path, capfd):
    """After a seek cv2 restarts at a sync sample, which may be the CRA
    picture whose RASL pictures are then left out: reads that land on a
    RASL frame and on its CRA frame, forward and backward, in .mp4 and
    .avi."""
    samples, o = hv.random_stream(48, 32, 18, 630, gop=8, bframes=3, styles=("cra-rasl",),
                                  slices=1)
    pics = o["pictures"]
    cra = next(p["disp"] for p in pics if p["typ"] == hv.CRA)
    rasl = [p["disp"] for p in pics if p["typ"] in (hv.RASL_N, hv.RASL_R)]
    assert cra == 8 and rasl == [6, 5, 7, 14, 13, 15]
    for suffix in (".mp4", ".avi"):
        path = _write(tmp_path / "open", samples, o, 48, 32, suffix)
        for order in ([17, 6], [17, 8], [3, 6, 8], [12, 5, 9], [16, 14, 16, 7]):
            _same_reads(path, order, capfd)


@pytest.mark.parametrize("edits", ["ffmpeg", None])
def test_a_seek_between_close_sync_samples_behind_an_edit_reads_as_cv2(tmp_path, capfd, edits):
    """Every sample an IDR picture, two presented out of order so that
    FFmpeg's muxer writes ``ctts`` and an edit of media time 1: FFmpeg's
    seek restarts at the last sync sample at or before sample ``t`` (its
    ``min_corrected_pts`` taken off the target), not ``t`` + the delay
    (ROADMAP Queue 3 item 26); without the edit, at ``t`` + the delay."""
    samples, o = hv.random_stream(32, 16, 10, 3, gop=1)
    path = tmp_path / "idr.mp4"
    hv.write_mp4(path, samples, 32, 16, display=list(range(8)) + [9, 8], edits=edits)
    for t in range(4):
        _same_reads(path, [6, t, t + 1], capfd)


def test_a_smooth_b_pan_reads_as_cv2_reads_it(tmp_path, capfd):
    """The encoder of real content with B pictures (``smooth_stream(...,
    bframes=3)``), as the CLI clip of phase 24b is made."""
    samples, o = hv.smooth_stream(64, 48, N, 7, step=4, gop=8, bframes=3)
    path = tmp_path / "pan.mp4"
    hv.write_mp4(path, samples, 64, 48, display=o["display"])
    _same_reads(path, range(N), capfd)
    _same_reads(path, [13, 0, 6, 8, 2], capfd)


def _digest(img):
    return None if img is None else hashlib.sha256(img.tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_committed_hevc_b_fixtures_agree_with_cv2(name):
    """The files ``chip_smoke.py`` phase 24 decodes on the card's host (no cv2
    there; ``scripts/make_hevc_fixtures.py`` wrote them): their committed
    digests are still what the JAX package's dataset gives here, and the
    port's dataset gives those bytes."""
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


def test_the_decoder_gives_b_pictures_in_display_order_and_drains(tmp_path):
    """``HevcDecoder`` directly: an IBBBP pyramid comes out in display
    order, held back by the SPS's reorder delay, the rest drained; a
    stream opening with a CRA picture leaves its RASL pictures out."""
    samples, o = hv.smooth_stream(32, 16, 9, 5, step=4, bframes=3)
    assert o["display"] == [0, 4, 2, 1, 3, 8, 6, 5, 7]
    path = tmp_path / "d.mp4"
    hv.write_mp4(path, samples, 32, 16, display=o["display"])
    data, track = video.read_track(path)
    dec = native.HevcDecoder(track.config, track.length_size)
    shown = [dec.decode(data[int(a):int(a) + int(n)], i)
             for i, (a, n) in enumerate(zip(track.offsets, track.sizes))]
    shown += [dec.drain() for _ in range(4)]
    assert [o["display"][s] for s in shown if s is not None] == list(range(9))
    assert shown[:2] == [None, None] and shown[-1] is None
    assert dec.delay() == (o["reorder"], o["reorder"], True)
    samples, o = hv.random_stream(32, 16, 12, 6, gop=4, bframes=3, start_cra=True, slices=1,
                                  styles=("cra-rasl",))
    hv.write_mp4(path, samples, 32, 16, display=o["display"])
    data, track = video.read_track(path)
    dec = native.HevcDecoder(track.config, track.length_size)
    shown = [dec.decode(data[int(a):int(a) + int(n)], i)
             for i, (a, n) in enumerate(zip(track.offsets, track.sizes))]
    shown += [dec.drain() for _ in range(len(samples))]
    # the opening CRA picture's RASL pictures (a later one's are decoded)
    second = next(i for i, p in enumerate(o["pictures"]) if i and p["typ"] == hv.CRA)
    rasl = {i for i, p in enumerate(o["pictures"][:second]) if p["typ"] in (hv.RASL_N, hv.RASL_R)}
    assert len(rasl) == 3
    assert sorted(s for s in shown if s is not None) == sorted(set(range(len(samples))) - rasl)


# --- what is refused -------------------------------------------------------------------


def _b_stream(**kw):
    return hv.random_stream(32, 16, 6, 9, gop=4, bframes=3, styles=("cra-rasl",), slices=1,
                            **kw)


def _refused(tmp_path, samples, o, w=32, h=16):
    path = _write(tmp_path / "refused", samples, o, w, h, ".mp4")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 17"):
        ds = video.MP4Dataset(path)
        for i in range(len(ds)):
            ds.read_img(i)


@pytest.mark.parametrize("what,kw", [
    ("long-term-references", dict(long_term=True)),
    ("bit-depth-10", dict(bit_depth=10, bit_depth_chroma=8)),  # 10-bit luma over 8-bit chroma
    ("scaling-lists", dict(scaling=True)),
    ("tiles", dict(pps=dict(tiles=True))),
])
def test_features_not_ported_are_refused_in_b_streams(tmp_path, what, kw):
    _refused(tmp_path, *_b_stream(**kw))


def test_end_of_sequence_after_leading_pictures_is_refused(tmp_path):
    samples, o = _b_stream()
    samples[4] = samples[4] + [bytes([hv.EOS << 1, 1])]
    _refused(tmp_path, samples, o)


@pytest.mark.parametrize("kind", ["RASL", "RADL"])
def test_a_stream_opening_with_a_leading_picture_is_refused(tmp_path, kind):
    """Leading pictures are no IRAP pictures: a stream cut to start at one
    is refused as any stream that does not start with an IRAP picture."""
    samples, o = hv.random_stream(32, 16, 8, 9, gop=4, bframes=3, slices=1,
                                  styles=("cra-rasl" if kind == "RASL" else "cra-radl",))
    k = next(i for i, p in enumerate(o["pictures"]) if p["typ"] in (6, 7, 8, 9))
    ps = [u for u in samples[0] if hv.kind_of(u) >= 32]
    _refused(tmp_path, [ps + samples[k]] + samples[k + 1:], dict(o, display=o["display"][k:]))


def _reads_or_refusal(ds, order):
    """Each read's frame, None where it fails, or "refused" where the port
    raises NotImplementedError naming ROADMAP Queue 1 item 17 (and every
    read after it, which the test does not attempt)."""
    out = []
    for i in order:
        try:
            out.append(ds.read_img(i))
        except ValueError:
            out.append(None)
        except NotImplementedError as e:
            assert "ROADMAP Queue 1 item 17" in str(e)
            return out + ["refused"] * (len(order) - len(out))
    return out


def test_an_idr_picture_of_a_generated_pictures_poc_is_refused_where_cv2_drops_it(tmp_path,
                                                                                    capfd):
    """ROADMAP Queue 3 item 27: decoding opens at a CRA picture whose RPS
    names POC 0 (the pictures it names are generated without samples), and
    an IDR picture (POC 0) follows its RASL pictures.  libavcodec drops the
    IDR picture and the pictures that follow it up to the next IRAP
    picture.  At the stream's start cv2's reads then fail from the IDR
    picture's frame on; after a seek that restarts at the CRA picture cv2
    counts its frames on past the dropped ones (frame 32 shows frame 36).
    The port refuses both cases, and reads every frame before the refusal
    as cv2 does."""
    styles = ("cra-rasl", "idr-radl", "idr")
    samples, o = hv.random_stream(48, 32, 14, 1, gop=4, bframes=3, slices=1, styles=styles,
                                  idr_after_cra=True, start_cra=True)
    typs = [p["typ"] for p in o["pictures"]]
    assert typs[:5] == [hv.CRA, hv.RASL_R, hv.RASL_N, hv.RASL_N, hv.IDR_W_RADL]
    path = _write(tmp_path / "opens-at-the-cra", samples, o, 48, 32, ".mp4")
    order = list(range(len(samples)))
    want = _reads(JaxMP4Dataset(path), order)
    got = _reads_or_refusal(video.MP4Dataset(path), order)
    assert [w is None for w in want] == [False] * 3 + [True] * (len(order) - 3)
    assert "refused" in [g for g in got if isinstance(g, str)]
    for i, a, b in zip(order, got, want):
        if isinstance(a, str):
            break
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    # mid-stream: the CRA picture of frame 16, an IDR picture coded after its RASL pictures
    samples, o = hv.random_stream(48, 32, 56, 10, gop=4, bframes=3, slices=1, styles=styles,
                                  idr_after_cra=True)
    typs = [(p["typ"], p["disp"]) for p in o["pictures"]]
    k = typs.index((hv.CRA, 16))
    assert typs[k + 4] == (hv.IDR_W_RADL, 20)
    path = _write(tmp_path / "seek-to-the-cra", samples, o, 48, 32, ".mp4")
    seq = _reads(JaxMP4Dataset(path), range(37))
    jax = JaxMP4Dataset(path)
    jax.read_img(0)
    assert not np.array_equal(jax.read_img(32), seq[32])  # the seek restarts at the CRA picture
    ds = video.MP4Dataset(path)
    np.testing.assert_array_equal(ds.read_img(0), seq[0])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 17"):
        ds.read_img(32)
    capfd.readouterr()  # libavcodec logs the duplicate POC
