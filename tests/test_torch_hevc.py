"""HEVC video input without cv2: the port's ``data/video.MP4Dataset`` (the
container walked in Python, HEVC decoded by the host library,
``csrc/host/hevc.cpp``) against the JAX package's ``MP4Dataset``
(``cv2.VideoCapture``, cv2 5.0.0), on streams written here
(``tests/torch_hevc_files.py``; cv2 decodes HEVC but cannot encode it).

One stream a feature the decoder takes, and random valid syntax at
several seeds, in ``.mp4`` (``hvc1``, ``hev1`` with the parameter sets in
band, 2- and 4-byte NAL unit lengths), ``.mov`` and ``.avi`` (Annex B):
sizes from 16x48 to a few CTBs, widths and heights that are not multiples
of the smallest CU (cropped).  Every frame must be exactly cv2's,
sequentially, after forward and backward seeks and after
``subsample(4)``, with the same ``len``, ``fps`` and timestamps, and
libavcodec must log no error while cv2 reads (it conceals errors, which
would pass a writer's fault off as a frame).  What the decoder does not
take raises ``NotImplementedError`` naming ROADMAP Queue 1 item 17,
damaged data ``ValueError``.  The committed fixtures of ``chip_smoke.py``
phase 23 must still be cv2's.
"""

import hashlib
import json
import pathlib

import cv2
import numpy as np
import pytest

from mast3r_slam_tpu.data.dataloader import MP4Dataset as JaxMP4Dataset
from mast3r_slam_tpu_torch.data import video
from mast3r_slam_tpu_torch.utils import native

import torch_hevc_files as hv

DATA = pathlib.Path(__file__).resolve().parent / "data"
# the I and P fixtures (tests/test_torch_hevc_b.py holds the B ones)
DIGESTS = {k: v for k, v in json.loads((DATA / "hevc_fixtures.json").read_text()).items()
           if "hevc_b_" not in k}
N = 14  # pictures a stream; an IRAP picture every GOP
GOP = 5


def _write(path, samples, w, h, suffix, k=0):
    """``samples`` into ``path`` + ``suffix``: the mp4 container's variants
    by ``k`` (hvc1, or hev1 with the parameter sets in band; 4- or 2-byte
    lengths) and the AVI fourccs."""
    path = path.with_suffix(suffix)
    if suffix == ".avi":
        hv.write_avi(path, samples, w, h, fourcc=[b"HEVC", b"H265", b"hev1", b"HVC1"][k % 4])
    else:
        hv.write_mp4(path, samples, w, h, fps=[30, 25, 60][k % 3],
                     fourcc=b"hev1" if k % 2 else b"hvc1", config_in_band=bool(k % 2),
                     length_size=2 if k % 4 == 2 else 4,
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
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=f"{path.name} frame {i}")
    log = capfd.readouterr().err
    assert "[hevc" not in log, log  # libavcodec logs at cv2's level (errors) nothing


def _all_reads(path, capfd, n=N):
    _same_reads(path, range(n), capfd)
    _same_reads(path, [n - 1, 0, n // 2, 1, n // 2 + 1, 12 % n, 11 % n, 2, n - 2, 7, 6], capfd)
    _same_reads(path, range(len(range(0, n, 4))), capfd, stride=4)


# name -> (width, height, container, random_stream options)
FEATURES = {
    "ctb-16-wpp-slices": (64, 48, ".mp4", dict(log2_ctb=4, slices=4, pps=dict(wpp=True))),
    "ctb-32-partial": (72, 40, ".avi", dict(log2_ctb=5)),
    "ctb-64": (96, 72, ".mov", dict(log2_ctb=6, slices=2)),
    "one-ctb-column-wpp": (16, 48, ".mp4", dict(log2_ctb=4, pps=dict(wpp=True))),
    "amp-and-nxn": (64, 48, ".avi", dict(amp=True, log2_min_cb=3, p_intra=0.1)),
    "merge-only": (64, 48, ".mov", dict(p_merge=1.0, p_skip=0.3, max_ref=4, num_ref=4)),
    "amvp-only": (64, 48, ".mp4", dict(p_merge=0.0, p_skip=0.0, max_ref=3)),
    "tmvp-and-parallel-merge": (64, 48, ".avi", dict(tmvp=True, log2_ctb=5,
                                                    pps=dict(par_mrg=4))),
    "transform-skip-and-sign-hiding": (48, 32, ".mov", dict(pps=dict(ts=True, sdh=True))),
    "cu-qp-delta": (64, 48, ".mp4", dict(pps=dict(cu_qp_delta=True, qg_depth=2),
                                         log2_ctb=5)),
    "chroma-qp-offsets": (48, 32, ".avi", dict(pps=dict(cqp=[-12, 12], slice_cqp=True))),
    "weighted-prediction": (48, 32, ".mov", dict(max_ref=3, pps=dict(weighted=True))),
    "constrained-intra": (64, 48, ".mp4", dict(p_intra=0.5, pps=dict(cip=True))),
    "strong-intra-smoothing": (96, 64, ".avi", dict(strong=True, log2_ctb=5, p_intra=0.5)),
    "sao-band-and-edge": (64, 48, ".mov", dict(sao=True, slices=3)),
    "deblocking-offsets": (64, 48, ".mp4", dict(slices=3, pps=dict(
        dbk_ctrl=(True, False, 3, -4), lf_across=True))),
    "references-and-list-modification": (48, 32, ".avi", dict(
        max_ref=4, nonref=0.4, pps=dict(lists_mod=True))),
    "poc-wrap": (32, 16, ".mov", dict(log2_max_poc_lsb=4, poc_step=2, gop=20, n=20)),
    "cra-sync-samples": (48, 32, ".mp4", dict(cra=1.0)),
    "reorder-and-latency": (48, 32, ".avi", dict(reorder=2, latency=2, gop=7)),
    "no-output-of-prior-pictures": (48, 32, ".mov", dict(reorder=3, no_prior=0.6)),
    "pic-output-flag": (48, 32, ".mp4", dict(hidden=0.3, reorder=1)),
    "vectors-far-out": (32, 16, ".avi", dict(far_mv=True, mvd=64)),
    "levels-of-16-bits": (32, 16, ".mov", dict(big=0.4)),
    "parameter-sets-in-band": (48, 32, ".mp4", dict(inband=True, extra_nals=True)),
    "header-extensions": (48, 32, ".avi", dict(pps=dict(header_ext=True, extra_bits=2))),
    "full-range-bt709": (50, 34, ".mov", dict(vui=dict(full_range=True, prim=1, trc=1,
                                                       matrix=1))),
    "limited-range-fcc": (40, 24, ".mp4", dict(vui=dict(matrix=4, timing=True,
                                                        restriction=True))),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_each_feature_reads_as_cv2_reads_it(tmp_path, capfd, name):
    w, h, suffix, kw = FEATURES[name]
    kw = dict(kw)
    k = sorted(FEATURES).index(name)
    n = kw.pop("n", N)
    samples, _ = hv.random_stream(w, h, n, 100 + k, gop=kw.pop("gop", GOP), **kw)
    path = _write(tmp_path / name, samples, w, h, suffix, k)
    _all_reads(path, capfd, n)


@pytest.mark.parametrize("seed", range(8))
def test_random_syntax_reads_as_cv2_reads_it(tmp_path, capfd, seed):
    """Every tool drawn from the seed (the options' defaults)."""
    w, h = [(64, 48), (56, 40), (80, 32), (40, 56)][seed % 4]
    samples, _ = hv.random_stream(w, h, N, 200 + seed, gop=[5, 7, 14][seed % 3])
    path = _write(tmp_path / f"random{seed}", samples, w, h, [".mp4", ".mov", ".avi"][seed % 3],
                  seed)
    _all_reads(path, capfd)


@pytest.mark.parametrize("size", [(640, 480), (200, 104)])
def test_a_smooth_pan_reads_as_cv2_reads_it(tmp_path, capfd, size):
    """The encoder of real content (``smooth_stream``), as the CLI clip is made."""
    w, h = size
    samples, _ = hv.smooth_stream(w, h, 3, 7, step=4)
    path = tmp_path / "pan.mp4"
    hv.write_mp4(path, samples, w, h)
    _same_reads(path, range(3), capfd)
    _same_reads(path, [2, 0, 1], capfd)


def _digest(img):
    return None if img is None else hashlib.sha256(img.tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_committed_hevc_fixtures_agree_with_cv2(name):
    """The files ``chip_smoke.py`` phase 23 decodes on the card's host (no cv2
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


def test_cv2_reads_the_hevc_fourccs_the_port_reads(tmp_path):
    """FFmpeg's AVI demuxer maps these fourccs to HEVC, matched upper-cased;
    x265's own tag it does not know, and neither does the port."""
    samples, _ = hv.random_stream(32, 16, 3, 4)
    for fourcc in sorted(video.AVI_HEVC_FOURCCS) + [b"hevc", b"h265"]:
        path = tmp_path / f"{fourcc.decode()}.avi"
        hv.write_avi(path, samples, 32, 16, fourcc=fourcc)
        assert cv2.VideoCapture(str(path)).read()[0], fourcc
        assert video.MP4Dataset(path).track.codec == "hevc"
    path = tmp_path / "x265.avi"
    hv.write_avi(path, samples, 32, 16, fourcc=b"X265")
    assert not cv2.VideoCapture(str(path)).read()[0]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 17"):
        video.MP4Dataset(path)


def test_the_decoder_gives_pictures_in_order_and_drains(tmp_path):
    """``HevcDecoder`` directly: a P-only stream whose SPS asks for two
    pictures of reorder delay holds two back, gives the rest in order, and
    ``drain`` gives the held ones; ``headers`` finds the IRAP samples."""
    samples, _ = hv.random_stream(32, 16, 6, 5, gop=3, reorder=2, cra=0.0)
    path = tmp_path / "d.mp4"
    hv.write_mp4(path, samples, 32, 16)
    data, track = video.read_track(path)
    dec = native.HevcDecoder(track.config, track.length_size)
    shown = [dec.decode(data[int(a):int(a) + int(n)], i)
             for i, (a, n) in enumerate(zip(track.offsets, track.sizes))]
    assert shown == [None, None, 0, 1, 2, 3]
    assert [dec.drain(), dec.drain(), dec.drain()] == [4, 5, None]
    assert dec.size() == (32, 16) and dec.rgb().shape == (16, 32, 3)
    assert dec.delay() == (2, 2, True)
    irap = [dec.headers(data[int(a):int(a) + int(n)]) for a, n in zip(track.offsets, track.sizes)]
    assert irap == [True, False, False, True, False, False]


# --- what is refused -------------------------------------------------------------------


def _refused(tmp_path, samples, w=32, h=16, suffix=".mp4"):
    path = _write(tmp_path / "refused", samples, w, h, suffix)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 17"):
        ds = video.MP4Dataset(path)
        for i in range(len(ds)):
            ds.read_img(i)


def _stream(**kw):
    return hv.random_stream(32, 16, 3, 9, gop=3, **kw)[0]


@pytest.mark.parametrize("what,kw", [
    ("bit-depth-10", dict(bit_depth=10, bit_depth_chroma=8)),  # 10-bit luma over 8-bit chroma
    ("chroma-4:4:4", dict(chroma_format=3)),
    ("scaling-lists", dict(scaling=True)),
    ("pcm", dict(pcm=True)),
    ("long-term-references", dict(long_term=True)),
    ("range-extension", dict(sps_extension=0x80)),
    ("left-crop", dict(crop=[2, 0, 0, 0])),
    ("top-crop", dict(crop=[0, 0, 2, 0])),
])
def test_sps_features_not_ported_are_refused(tmp_path, what, kw):
    o = hv.options(32, 16, 9, **kw)
    _refused(tmp_path, [[hv.vps(o), hv.sps(o), hv.pps(o, o["pps"])] + _stream()[0][3:]])


@pytest.mark.parametrize("what,pps_kw", [
    ("transquant-bypass", dict(bypass=True)),
    ("tiles", dict(tiles=True)),
    ("pps-range-extension", dict(pps_extension=0x80)),
])
def test_pps_features_not_ported_are_refused(tmp_path, what, pps_kw):
    o = hv.options(32, 16, 9)
    o["pps"].update(pps_kw)
    _refused(tmp_path, [[hv.vps(o), hv.sps(o), hv.pps(o, o["pps"])] + _stream()[0][3:]])


def test_dependent_slice_segments_are_refused(tmp_path):
    samples = hv.random_stream(32, 32, 2, 9, gop=2, log2_ctb=4, slices=2,
                               pps=dict(dependent=True, wpp=False))[0]
    units = samples[0]
    # the second slice segment's header: dependent_slice_segment_flag 1
    second = bytearray(units[-1])
    assert not second[2] & 0x80  # first_slice_segment_in_pic_flag 0
    bits = format(int.from_bytes(second[2:6], "big"), "032b")
    # first_slice(0) no_output_of_prior(1, IDR) pps_id ue(0)='1' dependent flag
    bits = bits[:3] + "1" + bits[4:]
    second[2:6] = int(bits, 2).to_bytes(4, "big")
    _refused(tmp_path, [units[:-1] + [bytes(second)]], 32, 32)


def test_multi_layer_streams_are_refused(tmp_path):
    samples = _stream()
    extra = hv.nal(hv.TRAIL_R, samples[1][-1][2:], layer=1)
    _refused(tmp_path, [samples[0], samples[1] + [extra], samples[2]])


@pytest.mark.parametrize("kind", [hv.EOS, 37])
def test_end_of_sequence_and_bitstream_units_are_refused(tmp_path, kind):
    samples = _stream()
    _refused(tmp_path, [samples[0], samples[1] + [bytes([kind << 1, 1])], samples[2]])


def test_a_first_slice_disabling_deblocking_that_a_later_one_enables_is_refused(tmp_path):
    """libavcodec would filter the picture with offsets kept from an
    earlier picture's slice header (``hevc.cpp``, ``slice_nal``)."""
    o = hv.options(32, 32, 9, log2_ctb=4, slices=1, sao=False,
                   pps=dict(dbk_ctrl=(True, False, 1, 1), wpp=False))
    w = hv.StreamWriter(o, 9)
    idr = w.picture("IDR")
    o["slices"] = 2
    w.rng = np.random.default_rng(3)
    real = w._slice_params
    calls = []

    def params(pl, irap, idx=0):
        sl = real(pl, irap, idx)
        sl["dbk"] = (True, 0, 0) if idx == 0 else (False, 2, 2)
        calls.append(idx)
        return sl
    w._slice_params = params
    p = w.picture("P")
    assert calls == [0, 1]
    _refused(tmp_path, [w.parameter_sets() + idr, p], 32, 32)


def test_a_stream_without_an_irap_picture_first_is_refused(tmp_path):
    samples = _stream()
    _refused(tmp_path, [samples[0][:3] + samples[1], samples[2]])


def test_damaged_hevc_data_raises_value_error(tmp_path):
    samples = _stream()
    cut = [samples[0][:3] + [samples[0][3][:len(samples[0][3]) // 2]]] + samples[1:]
    path = _write(tmp_path / "cut", cut, 32, 16, ".mp4")
    ds = video.MP4Dataset(path)
    with pytest.raises(ValueError):
        for i in range(len(ds)):
            ds.read_img(i)
