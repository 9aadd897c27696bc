"""H.264 video input without cv2: the port's ``data/video.MP4Dataset`` (the
container walked in Python, H.264 decoded by the host library,
``csrc/host/h264.cpp``) against the JAX package's ``MP4Dataset``
(``cv2.VideoCapture``, cv2 5.0.0), on streams written here
(``tests/torch_h264_files.py``; cv2 decodes H.264 but cannot encode it).

One stream a feature the decoder takes, under CAVLC and under CABAC, and
random valid syntax at eight seeds of each, in ``.mp4`` (``avc1``,
``avc3`` with the parameter sets in band, 2- and 4-byte NAL unit
lengths), ``.mov`` and ``.avi`` (Annex B): sizes from 32x16 to a few
macroblocks, widths and heights that are not multiples of 16 (cropped).
Every frame must be exactly cv2's, sequentially, after forward and
backward seeks and after ``subsample(4)``, with the same ``len``,
``fps`` and timestamps, and libavcodec must log no error while cv2 reads
(it conceals errors, which would pass a writer's fault off as a frame).
The colour conversion is held on I_PCM pictures of random samples for
each matrix and range cv2 converts. What the decoder does not take
raises ``NotImplementedError`` naming ROADMAP Queue 1 item 17, damaged
data ``ValueError``. The committed fixtures of ``chip_smoke.py`` phases
20 and 21 must still be cv2's.
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

import torch_h264_files as hf

DATA = pathlib.Path(__file__).resolve().parent / "data"
DIGESTS = json.loads((DATA / "h264_fixtures.json").read_text())
N = 14  # pictures a stream; an IDR picture every GOP
GOP = 5


def _write(path, samples, w, h, suffix, k=0):
    """``samples`` into ``path`` + ``suffix``: the mp4 container's variants
    by ``k`` (avc1 or avc3 with the parameter sets in band, 4- or 2-byte
    lengths)."""
    path = path.with_suffix(suffix)
    if suffix == ".avi":
        hf.write_avi_h264(path, samples, w, h, fourcc=[b"H264", b"X264", b"avc1", b"DAVC"][k % 4])
    else:
        hf.write_mp4(path, samples, w, h, fps=[30, 25, 60][k % 3],
                     fourcc=b"avc3" if k % 2 else b"avc1", config_in_band=bool(k % 2),
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
    assert "[h264" not in log, log  # libavcodec logs at cv2's level (errors) nothing


def _all_reads(path, capfd, n=N):
    _same_reads(path, range(n), capfd)
    _same_reads(path, [n - 1, 0, n // 2, 1, n // 2 + 1, 12 % n, 11 % n, 2, n - 2, 7, 6], capfd)
    _same_reads(path, range(len(range(0, n, 4))), capfd, stride=4)


# name -> (width, height, container, random_stream options)
FEATURES = {
    "i-pcm": (48, 32, ".mp4", dict(i_types=["PCM"], p_types=[0])),
    "intra-4x4": (64, 48, ".avi", dict(i_types=["I4"], t8=False)),
    "intra-8x8": (64, 48, ".mov", dict(i_types=["I8"])),
    "intra-16x16": (50, 34, ".mp4", dict(i_types=["I16"])),
    "p-partitions": (64, 48, ".avi", dict(p_types=[0, 1, 2, 3, 4], intra_in_p=False, max_ref=4)),
    "slices": (64, 48, ".mov", dict(slices=4, slice_i_in_p=True)),
    "references": (48, 32, ".mp4", dict(max_ref=4, modify=True, mmco=True, nonref=0.3)),
    "poc-type-1": (32, 16, ".avi", dict(poc_type=1, nonref=0.3, poc_cycle=[2, 4],
                                        bottom_poc=True)),
    "poc-type-2": (32, 16, ".mov", dict(poc_type=2, nonref=0.3)),
    "poc-bottom-and-jumps": (32, 16, ".mp4", dict(bottom_poc=True, poc_step=[2, 4, 6],
                                                  log2_max_poc_lsb=8)),
    "frame-num-and-poc-wrap": (32, 16, ".avi", dict(log2_max_frame_num=4, log2_max_poc_lsb=5,
                                                     gop=40, n=20)),
    "constrained-intra": (64, 48, ".mov", dict(constrained_intra=True, slices=2)),
    "chroma-offsets": (48, 32, ".mp4", dict(cqp=[-5, 7])),
    "chroma-offsets-equal": (48, 32, ".avi", dict(cqp=[4, 4])),
    "no-deblocking-control": (48, 32, ".mov", dict(deblock_ctrl=False)),
    "vectors-far-out": (32, 16, ".mp4", dict(far_mv=True, mvd=64)),
    "constrained-baseline": (48, 32, ".avi", dict(profile=66, constraints=0x40, t8=False,
                                                  cqp=[2, 5])),
    "main": (48, 32, ".mov", dict(profile=77, t8=False)),
    "parameter-sets-in-band": (48, 32, ".avi", dict(inband="change", pps_ids=(0, 3),
                                                    extra_nals=True)),
    "sps-and-pps-ids": (32, 16, ".mp4", dict(sps_id=5, pps_ids=(7, 2))),
    "qp-low": (32, 16, ".mov", dict(qp_range=(0, 12))),
    "qp-high": (32, 16, ".avi", dict(qp_range=(40, 51))),
    "reorder-vui": (48, 32, ".mp4", dict(vui=dict(reorder=2, timing=True, hrd=True))),
    "full-range-bt709": (50, 34, ".mov", dict(vui=dict(full_range=True, prim=1, trc=1,
                                                       matrix=1))),
    "crop-top-and-bottom": (40, 28, ".avi", dict(crop=[0, 8, 2, 2])),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_each_feature_reads_as_cv2_reads_it(tmp_path, capfd, name):
    w, h, suffix, kw = FEATURES[name]
    kw = dict(kw)
    k = sorted(FEATURES).index(name)
    n = kw.pop("n", N)
    samples, _ = hf.random_stream(w, h, n, k, gop=kw.pop("gop", GOP), **kw)
    path = _write(tmp_path / name, samples, w, h, suffix, k)
    _all_reads(path, capfd, n)


# name -> (width, height, container, random_stream options), all under CABAC
CABAC_FEATURES = {
    "i-pcm-inside-slices": (48, 32, ".mp4", dict(i_types=["PCM", "I16", "I4"], p_types=[0])),
    "intra-4x4": (64, 48, ".avi", dict(i_types=["I4"], t8=False)),
    "intra-8x8": (64, 48, ".mov", dict(i_types=["I8"])),
    "intra-16x16": (50, 34, ".mp4", dict(i_types=["I16"])),
    "p-partitions": (64, 48, ".avi", dict(p_types=[0, 1, 2, 3], intra_in_p=False, max_ref=4)),
    "slices": (64, 48, ".mov", dict(slices=4, slice_i_in_p=True)),
    "references": (48, 32, ".mp4", dict(max_ref=4, modify=True, mmco=True, nonref=0.3)),
    "constrained-intra": (64, 48, ".avi", dict(constrained_intra=True, slices=2)),
    "chroma-offsets": (48, 32, ".mov", dict(cqp=[-5, 7])),
    "vectors-far-out": (32, 16, ".mp4", dict(far_mv=True, mvd=64)),
    "qp-low": (32, 16, ".avi", dict(qp_range=(0, 12))),
    "qp-high": (32, 16, ".mov", dict(qp_range=(40, 51))),
    "main": (48, 32, ".mp4", dict(profile=77, t8=False)),
    "main-avi": (48, 32, ".avi", dict(profile=77, t8=False, slices=2)),
    "parameter-sets-in-band": (48, 32, ".mov", dict(inband="change", pps_ids=(0, 3),
                                                    extra_nals=True)),
    "poc-type-2": (32, 16, ".mp4", dict(poc_type=2, nonref=0.3)),
}


@pytest.mark.parametrize("name", sorted(CABAC_FEATURES))
def test_each_cabac_feature_reads_as_cv2_reads_it(tmp_path, capfd, name):
    """Main and High profile streams coded with CABAC (``random_stream(...,
    cabac=True)``: every cabac_init_idc and slice QPs over the whole range
    unless a case narrows them): each feature the CAVLC cases hold, read
    as cv2 reads it in .mp4 (avc1, avc3), .mov and .avi."""
    w, h, suffix, kw = CABAC_FEATURES[name]
    k = sorted(CABAC_FEATURES).index(name)
    samples, _ = hf.random_stream(w, h, N, 50 + k, gop=GOP, cabac=True, **kw)
    path = _write(tmp_path / name, samples, w, h, suffix, k)
    _all_reads(path, capfd)


def test_the_deblocking_shortcut_is_exact_under_cabac(tmp_path, capfd, monkeypatch):
    """libavcodec's h264_filter_mb_fast gives an inter macroblock with the
    8x8 transform and coded_block_pattern bits 0-2 set bS 2 on every edge
    whatever its coefficients.  Under CABAC a coded 8x8 block always holds
    a level (4:2:0 codes no coded_block_flag for it), so the shortcut is
    the standard's filter: streams rich in such macroblocks, the filter on,
    equal chroma QP offsets, read as cv2 reads them."""
    seen = []
    macroblock = hf.CabacSlice.macroblock

    def counted(self, mx, my, d, slice_type, num_ref):
        seen.append(d["kind"] == "P" and bool(d.get("t8")) and (d["cbp"] & 7) == 7)
        macroblock(self, mx, my, d, slice_type, num_ref)
    monkeypatch.setattr(hf.CabacSlice, "macroblock", counted)
    samples, _ = hf.random_stream(64, 48, N, 77, gop=N, cabac=True, p_types=[0, 1, 2],
                                  intra_in_p=False, cqp=[3, 3], dbk_idc=(0,), qp_range=(30, 45))
    assert sum(seen) >= 5
    path = _write(tmp_path / "fast", samples, 64, 48, ".mp4")
    _same_reads(path, range(N), capfd)


def test_damaged_cabac_streams_raise_value_error():
    """CABAC slices cut short anywhere: the arithmetic decoder reads past
    the rbsp_stop_one_bit, or the picture lacks macroblocks."""
    samples, _ = hf.random_stream(48, 32, 3, 9, gop=GOP, cabac=True)
    rng = np.random.default_rng(1)
    dec = native.H264Decoder(hf.annexb(samples[0][:2]))
    for k in range(20):
        j = k % 3
        cut = [u[:int(rng.integers(2, max(len(u) - 2, 3)))] if u[0] & 31 in (1, 5) else u
               for u in samples[j][2 if j == 0 else 0:]]
        dec.reset()
        for i in range(j):
            dec.decode(hf.annexb(samples[i][2 if i == 0 else 0:]), i)
        with pytest.raises(ValueError, match="corrupt H.264"):
            dec.decode(hf.annexb(cut), j)


def _random_options(seed: int) -> dict:
    """A mix of the features, drawn by ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    kw = {}
    if rng.random() < 0.5:
        kw.update(slices=int(rng.integers(2, 5)), slice_i_in_p=True)
    if rng.random() < 0.6:
        kw.update(max_ref=int(rng.integers(2, 5)), modify=True, mmco=bool(rng.random() < 0.5),
                  nonref=0.25)
    kw["poc_type"] = int(rng.integers(0, 3))
    kw["constrained_intra"] = bool(rng.random() < 0.3)
    kw["cqp"] = [int(v) for v in rng.integers(-4, 5, 2)] if rng.random() < 0.5 else [0, 0]
    kw["far_mv"] = bool(rng.random() < 0.3)
    kw["t8"] = bool(rng.random() < 0.7)
    if rng.random() < 0.3:
        kw["inband"] = "change"
        kw["pps_ids"] = (0, 1)
    return kw


RANDOM = [(seed, False) for seed in range(8)] + [(seed, True) for seed in range(8)]


@pytest.mark.parametrize("seed,cabac", RANDOM,
                         ids=[f"cabac-{s}" if c else str(s) for s, c in RANDOM])
def test_random_streams_decode_as_cv2_decodes_them(tmp_path, capfd, seed, cabac):
    """Random valid syntax (``torch_h264_files.random_stream``): every mb_type,
    partition, prediction mode, ref_idx, qp delta, deblocking setting and
    slice split, over a random mix of the stream features; under CAVLC and
    under CABAC (every cabac_init_idc, slice QPs over 0-51, I_PCM inside
    slices, mvd and level escapes past the UEG prefixes, mb_qp_delta at
    -26 and +25, slices that end on a skipped macroblock)."""
    w, h = [(64, 48), (50, 34), (32, 16), (72, 40)][seed % 4]
    samples, _ = hf.random_stream(w, h, N, seed + 100 * cabac, gop=GOP, cabac=cabac,
                                  **_random_options(seed))
    path = _write(tmp_path / f"random{seed}", samples, w, h, [".mp4", ".mov", ".avi"][seed % 3],
                  seed)
    _all_reads(path, capfd)


@pytest.mark.parametrize("vui", [dict(), dict(full_range=True), dict(matrix=1),
                                 dict(matrix=1, full_range=True), dict(matrix=4),
                                 dict(matrix=7, full_range=True), dict(matrix=9),
                                 dict(prim=5, trc=6, matrix=6, full_range=True)],
                         ids=["601", "601-full", "709", "709-full", "fcc", "240m-full", "2020",
                              "170m-full"])
def test_colour_conversion_is_cv2s(tmp_path, capfd, vui):
    """I_PCM pictures of random samples: the YUV -> RGB model of each
    matrix_coefficients class and range (held on all 2^24 triples when it
    was written; here on 3 x 6144 random ones)."""
    samples, _ = hf.random_stream(128, 48, 3, 7, i_types=["PCM"], p_types=[0], vui=vui)
    path = _write(tmp_path / "pcm", samples, 128, 48, ".mp4")
    _same_reads(path, range(3), capfd)


def _stream(tmp_path, suffix=".mp4", w=32, h=16, n=6, **kw):
    samples, _ = hf.random_stream(w, h, n, 0, gop=GOP, **kw)
    return _write(tmp_path / "clip", samples, w, h, suffix), samples


REFUSED = {
    "cabac-si-slices": dict(cabac=True, force_slice_type="SI"),
    "cabac-sp-slices": dict(cabac=True, force_slice_type="SP"),
    "sp-slices": dict(force_slice_type="SP"),
    "fields": dict(frame_mbs_only=False),
    "scaling-matrix": dict(scaling=True),
    "chroma-4:2:2": dict(chroma_format=2),
    "bit-depth-10": dict(bit_depth=10),
    "transform-bypass": dict(bypass=True),
    "slice-groups": dict(slice_groups=2),
    "long-term-reference": dict(long_term_idr=True),
    "mmco-5": dict(mmco_op=5),
    "mmco-2": dict(mmco_op=2),
    "frame-num-gap": dict(gap_at=2),
    "left-crop": dict(crop=[2, 0, 0, 0]),
    "redundant-picture": dict(redundant=True, redundant_cnt=1),
    "wide-gamut": dict(vui=dict(prim=9)),
    "pq-transfer": dict(vui=dict(trc=16)),
    "ycgco-matrix": dict(vui=dict(matrix=8)),
    "colour-range-changes": dict(inband="colour", n=12),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_features_not_ported_raise_not_implemented(tmp_path, name):
    """Refused at open (an avcC's parameter sets) or at the read that meets
    the feature (in band, in .avi)."""
    suffix = [".mp4", ".avi"][sorted(REFUSED).index(name) % 2]
    path, _ = _stream(tmp_path, suffix, **REFUSED[name])
    part = "c" if "slices" in name else ""
    with pytest.raises(NotImplementedError, match="item 17" + part):
        ds = video.MP4Dataset(path)
        for i in range(len(ds)):
            ds.read_img(i)


# what the cases of the same names above refused until B slices, weighted
# prediction and output reordering were ported: each now read as cv2 reads it
PORTED = {
    "b-slices": dict(bframes=2, max_ref=3),
    "cabac-b-slices": dict(bframes=2, max_ref=3, cabac=True),
    "output-reordered": dict(poc_drop_at=2),
    "weighted-prediction": dict(weighted=True),
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_features_ported_from_the_refused_ones_read_as_cv2_reads_them(tmp_path, capfd, name):
    suffix = [".mp4", ".avi"][sorted(PORTED).index(name) % 2]
    samples, o = hf.random_stream(32, 16, 6, 0, gop=GOP, **PORTED[name])
    path = tmp_path.joinpath("clip").with_suffix(suffix)
    if suffix == ".avi":
        hf.write_avi_h264(path, samples, 32, 16)
    else:
        hf.write_mp4(path, samples, 32, 16, display=o["display"])
    _same_reads(path, range(6), capfd)
    _same_reads(path, [5, 0, 3, 1, 4, 2], capfd)


def test_streams_the_dataset_refuses(tmp_path):
    """Sync samples that are not IDR pictures, a stream that does not start
    with one, a size that changes, data partitioning, two pictures in one
    sample: each named item 17, whatever cv2 makes of them."""
    samples, _ = hf.random_stream(32, 16, 6, 0, gop=GOP)
    cases = {}
    cases["sync-p"] = _write(tmp_path / "a", samples, 32, 16, ".mp4")
    hf.write_mp4(cases["sync-p"], samples, 32, 16, sync=[0, 2])
    cases["no-idr-first"] = tmp_path / "b.avi"
    hf.write_avi_h264(cases["no-idr-first"], [samples[0][:2] + samples[1]] + samples[2:5], 32, 16)
    other, _ = hf.random_stream(48, 32, 3, 1)
    cases["size-change"] = tmp_path / "c.avi"
    hf.write_avi_h264(cases["size-change"], samples[:5] + other, 32, 16)
    cases["partition"] = tmp_path / "d.avi"
    hf.write_avi_h264(cases["partition"], samples[:2] + [samples[2] + [bytes([0x42, 0x80])]],
                      32, 16)
    cases["two-pictures"] = tmp_path / "e.avi"
    hf.write_avi_h264(cases["two-pictures"], [samples[0], samples[1] + samples[2]], 32, 16)
    for name, path in cases.items():
        with pytest.raises(NotImplementedError, match="item 17"):
            ds = video.MP4Dataset(path)
            for i in range(len(ds)):
                ds.read_img(i)


def test_damaged_streams_raise_value_error(tmp_path):
    """Slices cut short anywhere, an avcC of 3-byte lengths, a NAL unit
    length past the sample, a PPS of an SPS never sent."""
    samples, _ = hf.random_stream(48, 32, 6, 3, gop=GOP)
    rng = np.random.default_rng(0)
    dec = native.H264Decoder(hf.annexb(samples[0][:2]))
    for k in range(20):
        j = k % 3  # the picture cut: the IDR one or a P picture after it
        cut = [u[:int(rng.integers(2, max(len(u) - 2, 3)))] if u[0] & 31 in (1, 5) else u
               for u in samples[j][2 if j == 0 else 0:]]
        dec.reset()
        for i in range(j):
            dec.decode(hf.annexb(samples[i][2 if i == 0 else 0:]), i)
        with pytest.raises(ValueError, match="corrupt H.264"):
            dec.decode(hf.annexb(cut), j)
    dec.reset()  # the pictures after a corrupt one, up to an IDR picture: damaged too
    dec.decode(hf.annexb(samples[0][2:]), 0)
    with pytest.raises(ValueError, match="corrupt H.264"):
        dec.decode(hf.annexb(samples[1][:-1] + [samples[1][-1][:len(samples[1][-1]) // 2]]), 1)
    with pytest.raises(ValueError, match="after a corrupt one"):
        dec.decode(hf.annexb(samples[2]), 2)
    assert dec.decode(hf.annexb(samples[5]), 5) == 5  # GOP 5: sample 5 is IDR
    path = _write(tmp_path / "cut", [samples[0], samples[1][:-1] + [samples[1][-1][:9]]]
                  + samples[2:], 48, 32, ".avi")
    ds = video.MP4Dataset(path)
    ds.read_img(0)
    for i in (1, 2, 3):
        with pytest.raises(ValueError, match="corrupt H.264"):
            ds.read_img(i)
    with pytest.raises(ValueError, match="corrupt H.264"):
        native.H264Decoder(hf.annexb(samples[0][:2]), 4).decode(b"\x00\x00\x10\x00\x65", 0)
    with pytest.raises(ValueError, match="corrupt H.264"):
        native.H264Decoder(hf.annexb(samples[0][1:2]))
    path = _write(tmp_path / "clip", samples, 48, 32, ".mp4")
    data = bytearray(path.read_bytes())
    at = bytes(data).index(b"avcC") + 8
    data[at] |= 0x03
    data[at] &= 0xFE  # lengthSizeMinusOne 2
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        video.MP4Dataset(path)


def _digest(img):
    return None if img is None else hashlib.sha256(img.tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_committed_h264_fixtures_agree_with_cv2(name):
    """The files ``chip_smoke.py`` phases 20 and 21 decode on the card's host (no
    cv2 there; ``scripts/make_h264_fixtures.py`` wrote them): their
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


def test_cv2_reads_the_h264_fourccs_the_port_reads(tmp_path):
    """FFmpeg's AVI demuxer maps these fourccs to H.264, matched upper-cased."""
    samples, _ = hf.random_stream(32, 16, 3, 4)
    for fourcc in sorted(video.AVI_H264_FOURCCS)[:6] + [b"h264", b"x264"]:
        path = tmp_path / f"{fourcc.decode()}.avi"
        hf.write_avi_h264(path, samples, 32, 16, fourcc=fourcc)
        cap = cv2.VideoCapture(str(path))
        assert cap.read()[0], fourcc
        assert video.MP4Dataset(path).track.codec == "h264"
