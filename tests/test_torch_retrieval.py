"""Port parity of retrieval (``retrieval/head.py``, ``retrieval/asmk.py``,
``retrieval/database.py``) and of the plain versions of the three gather
kernels (``ops/gather.py``), against the JAX package on seeded numpy inputs.

Tolerances, each with its reason:
* bit codes, Hamming similarities, ``_unique_static``, the quantised codes
  and the kernels' plain versions: exact (integer work, or decisions whose
  margins the inputs are seeded to keep above f32 rounding);
* aggregated residuals: 1e-6 absolute (sums of a few residuals of size 0.1
  to 1 in another order); a packed sign bit may differ only where its
  aggregate is below 1e-6 in magnitude, and the test counts those bits;
* head features: 1e-5 (three f32 products in a row), with identical top-k
  indices;
* IVF and database scores: 1e-6 relative (the same f32 chain, the
  scatter-add in another order), identical candidate lists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.retrieval import asmk as jasmk
from mast3r_slam_tpu.retrieval import head as jhead
from mast3r_slam_tpu.retrieval.database import RetrievalDatabase as JDB
from mast3r_slam_tpu_torch.models.convert import retrieval_from_jax
from mast3r_slam_tpu_torch.ops import gather
from mast3r_slam_tpu_torch.retrieval import asmk, head
from mast3r_slam_tpu_torch.retrieval.database import RetrievalDatabase
from mast3r_slam_tpu_torch.utils.numerics import vnorm

from test_torch_common import CPU, assert_close, f32, n, t

SCORE_RTOL = 1e-6
AGG_ATOL = 1e-6


def u32(x) -> np.ndarray:
    """The port's int32 codes as the JAX package's uint32 (the same bits)."""
    return np.ascontiguousarray(n(x)).view(np.uint32)


def i32(x) -> torch.Tensor:
    """JAX uint32 codes -> an int32 tensor holding the same bits."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)).view(np.int32).copy())


# ---------------------------------------------------------------------------
# kernels' plain versions against the probes' own expressions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.float32])
@pytest.mark.parametrize("M,F", [(4096, 16), (300, 32), (50, 20)])
def test_gather_rows_sum_plain_matches_jax(dtype, M, F):
    rng = np.random.default_rng(M + F)
    table = rng.integers(-100, 100, size=(M, F)).astype(dtype)
    idx = rng.integers(0, M, size=(16, 128)).astype(np.int32)
    want = jnp.sum(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0)
                   .astype(jnp.float32), axis=-1)
    got = gather.gather_rows_sum(t(table), t(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
@pytest.mark.parametrize("M,F,K", [(256, 128, 256), (2048, 32, 2048), (64, 24, 10)])
def test_take_along_rows_plain_matches_jax(dtype, M, F, K):
    rng = np.random.default_rng(M + F)
    tab = rng.integers(-100, 100, size=(M, F)).astype(dtype)
    idx = rng.integers(0, M, size=(K, F)).astype(np.int32)
    want = jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(idx), axis=0)
    got = gather.take_along_rows(t(tab), t(idx))
    assert got.dtype == t(tab).dtype
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("W", [2, 32, 3])
def test_ivf_hamming_plain_matches_jax(W):
    rng = np.random.default_rng(W)
    nb, cap, Q = 40, 16, 300
    bvecs = rng.integers(0, 2 ** 32, size=(nb, cap, W), dtype=np.uint64).astype(np.uint32)
    q = rng.integers(0, 2 ** 32, size=(Q, W), dtype=np.uint64).astype(np.uint32)
    qw = rng.integers(0, nb, size=(Q,)).astype(np.int32)
    x = jnp.bitwise_xor(jnp.asarray(q)[:, None, :], jnp.asarray(bvecs)[jnp.asarray(qw)])
    want = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
    got = gather.ivf_hamming(i32(bvecs), i32(q), t(qw))
    assert got.dtype == torch.int32 and got.shape == (Q, cap)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_popcount32_every_bit():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555, 0x0F0F0F0F,
                      0xDEADBEEF, 0x7FFFFFFF], dtype=np.uint32)
    want = [bin(int(w)).count("1") for w in words]
    assert n(gather.popcount32(i32(words))).tolist() == want


# ---------------------------------------------------------------------------
# the gather kernels' launch plans, walked as the kernels walk them
# ---------------------------------------------------------------------------

def _take_walk(K, F, plan):
    """(row, column) of every output element written under ``plan``, by the
    index arithmetic of csrc/take_along_rows.cu: in one pass a block an
    item, (chunk, slab) = (blockIdx.x, blockIdx.y); in one pass a slab each
    of ``grid`` blocks steps the slab's chunks by the grid.  A thread takes
    the 4-column group ``t % tps`` of row ``t // tps`` of its chunk."""
    tps = plan.slab_cols // 4
    n_slabs = plan.items // plan.chunks
    if plan.passes == 1:
        assert plan.grid == plan.items
        items = [(s, c) for s in range(n_slabs) for c in range(plan.chunks)]
    else:
        items = [(s, c) for s in range(n_slabs) for b in range(plan.grid)
                 for c in range(b, plan.chunks, plan.grid)]
    slab, chunk = np.array(items).T
    t = np.arange(gather.THREADS)
    i = chunk[:, None] * (gather.THREADS // tps) + t // tps
    c = (slab[:, None] * plan.slab_cols + (t % tps) * 4)[..., None] + np.arange(4)
    i = np.broadcast_to(i[..., None], c.shape)
    live = (i < K) & (c < F)
    return i[live], c[live]


@pytest.mark.parametrize("slab_bytes", [32, 64, 128])
@pytest.mark.parametrize("dtype,M,F,K,slots", [
    (np.float32, 300, 128, 2048, 1056),  # full slabs, a persistent grid over many items
    (np.float32, 300, 12, 500, 1056),    # a partial last slab
    (np.float32, 300, 40, 77, 7),        # few slots: blocks walk several items
    (np.int8, 300, 8, 500, 1056),        # the slab is the whole row
    (np.int8, 300, 40, 999, 1056),
    (np.float32, 64, 3, 7, 1056),        # one thread a row, most columns absent
])
@pytest.mark.parametrize("passes", [False, True])
def test_take_plan_writes_every_element_once(dtype, M, F, K, slots, slab_bytes, passes,
                                             monkeypatch):
    """Every output element written exactly once, with the value JAX's
    take_along_axis gives, in one pass (a block an item) or one pass a slab
    (a table over the pass threshold: persistent blocks, at most the slots
    and a slab's chunks)."""
    if passes:
        monkeypatch.setattr(gather, "PASS_TABLE_BYTES", 0)
    eb = np.dtype(dtype).itemsize
    plan = gather.take_plan(K, M, F, eb, slots, slab_bytes)
    n_slabs = plan.items // plan.chunks
    assert plan.passes == (n_slabs if passes and n_slabs > 1 else 1)
    assert plan.grid == (plan.items if plan.passes == 1 else min(plan.chunks, slots))
    assert plan.slab_cols * eb <= slab_bytes
    rows, cols = _take_walk(K, F, plan)
    writes = np.zeros((K, F), np.int64)
    np.add.at(writes, (rows, cols), 1)
    assert (writes == 1).all()
    rng = np.random.default_rng(K + F)
    tab = rng.integers(-100, 100, size=(M, F)).astype(dtype)
    idx = rng.integers(0, M, size=(K, F)).astype(np.int32)
    out = np.zeros((K, F), dtype)
    out[rows, cols] = tab[idx[rows, cols], cols]
    want = jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(idx), axis=0)
    np.testing.assert_array_equal(out, np.asarray(want))


@pytest.mark.parametrize("F,elem_bytes,slab_bytes,slab_cols", [
    (128, 4, 32, 8), (128, 4, 64, 16), (128, 4, 128, 32),
    (12, 4, 128, 16),  # four threads cover the row: a 64-byte slab
    (3, 4, 64, 4),
    (8, 1, 128, 8), (32, 1, 32, 32), (128, 1, 128, 128), (40, 1, 128, 64)])
def test_take_plan_slab_width(F, elem_bytes, slab_bytes, slab_cols):
    assert gather.take_plan(1000, 1000, F, elem_bytes, 1056, slab_bytes).slab_cols == slab_cols


@pytest.mark.parametrize("M,F,elem_bytes,slab_bytes,passes", [
    (196_608, 128, 4, 128, 4),  # the probe: 100 MB of table, one 128-byte slab a pass
    (196_608, 128, 4, 32, 16),
    (196_608, 128, 1, 128, 1),  # 25 MB of int8: one slab, the whole row
    (49_152, 128, 4, 32, 1),    # 25 MB of f32: slabs walked in one pass
    (2048, 128, 4, 128, 1)])
def test_take_plan_passes_walk_slab_major(M, F, elem_bytes, slab_bytes, passes):
    """A table over 32 MiB takes one slab a pass (the grid waits at a
    barrier between), so the items of each round of the persistent blocks
    are that pass's slab's; in one pass a block takes one item, block
    numbers slab-major."""
    slots = 792
    plan = gather.take_plan(M, M, F, elem_bytes, slots, slab_bytes)
    assert plan.passes == passes and plan.items % plan.chunks == 0
    if passes == 1:
        assert plan.grid == plan.items
        return
    assert plan.items // plan.chunks == passes and plan.grid == min(plan.chunks, slots)
    for p in range(passes):
        for start in range(0, plan.chunks, plan.grid):  # one round: a chunk a block
            items = p * plan.chunks + np.arange(start, min(start + plan.grid, plan.chunks))
            assert np.unique(items // plan.chunks).tolist() == [p]


def test_take_plan_small_calls():
    """A call with fewer items than slots takes a block an item, one pass
    a slab where the table is large whatever K; a slab width that is not
    whole sectors is refused."""
    small = gather.take_plan(256, 256, 128, 4, 1056, 32)
    assert small == gather.TakePlan(slab_cols=8, chunks=2, items=32, passes=1, grid=32)
    big_table = gather.take_plan(64, 196_608, 128, 4, 1056)
    assert big_table == gather.TakePlan(slab_cols=32, chunks=2, items=8, passes=4, grid=2)
    with pytest.raises(ValueError, match="multiple of 32"):
        gather.take_plan(256, 256, 128, 4, 1056, 48)


@pytest.mark.parametrize("row_words,nw,lanes", [
    (4, 4, 1), (8, 4, 1), (5, 1, 1), (6, 2, 1), (16, 4, 2), (32, 4, 4), (1024, 4, 32)])
@pytest.mark.parametrize("T,slots1,slots4", [
    (77, 1056, 528),       # under one wave: a row a group
    (196_608, 1056, 528),  # the probe's rows
    (196_608, 7, 3),       # far over one wave: groups of 4k rows
    (4 * 1056 * 256 + 5, 1056, 1056)])
def test_sum_plan_one_wave_covers_every_row(row_words, nw, lanes, T, slots1, slots4):
    """Words a load and lanes a row; every row and every word of a row read
    once (csrc/gather_rows.cu's walk); the grid at most the slots of the
    instance it launches, a group on 4 rows at a time only past one wave."""
    plan = gather.sum_plan(T, row_words, lambda nw, rb: slots1 if rb == 1 else slots4)
    assert (plan.nw, plan.lanes) == (nw, lanes)
    assert plan.rb == (1 if T <= slots1 * (gather.THREADS // lanes) else 4)
    slots = slots1 if plan.rb == 1 else slots4
    assert plan.rows % plan.rb == 0 and plan.grid <= slots
    groups_block = gather.THREADS // lanes
    assert plan.grid * groups_block * plan.rows >= T
    assert (plan.grid - 1) * groups_block * plan.rows < T  # no idle block
    passes = -(-row_words // (lanes * 8))
    words = (np.arange(passes)[:, None, None] * lanes + np.arange(lanes)[None, :, None]) * 8
    words = (words + np.arange(8)).ravel()
    assert sorted(words[words < row_words].tolist()) == list(range(row_words))


# ---------------------------------------------------------------------------
# asmk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 1024, 40])
def test_binarize_pack_and_hamming_sim_bit_exact(d):
    rng = np.random.default_rng(d)
    vecs = f32(rng, 20, d)
    vecs[0, :5] = 0.0  # zero is not positive
    want = np.asarray(jasmk.binarize_pack(jnp.asarray(vecs)))
    got = asmk.binarize_pack(t(vecs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(u32(got), want)
    sim_j = jasmk.hamming_sim(jnp.asarray(want[0]), jnp.asarray(want), d)
    sim_t = asmk.hamming_sim(got[0], got, d)
    np.testing.assert_array_equal(n(sim_t), np.asarray(sim_j))


def _well_separated(vecs, cents, k):
    """Smallest relative gap between consecutive ones of the k+1 nearest
    squared distances (float64)."""
    d2 = ((vecs[:, None, :].astype(np.float64) - cents[None].astype(np.float64)) ** 2).sum(-1)
    s = np.sort(d2, axis=1)[:, : k + 1]
    return float((np.diff(s, axis=1) / s[:, 1:]).min())


def test_quantize_codes_exact():
    rng = np.random.default_rng(3)
    vecs, cents = f32(rng, 24, 16), f32(rng, 256, 16)
    # seeded so that the top-5 order and the 5th/6th boundary are decisions
    # far above f32 rounding of the cdist trick
    assert _well_separated(vecs, cents, 5) > 1e-4
    want = np.asarray(jasmk.quantize(jnp.asarray(vecs), jnp.asarray(cents), 5))
    got = asmk.quantize(t(vecs), t(cents), 5)
    np.testing.assert_array_equal(n(got), want)


def test_unique_static_exact():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 30, size=(60,)).astype(np.int32)
    uj, ij = jasmk._unique_static(jnp.asarray(x), 64)
    ut, it = asmk._unique_static(t(x).long(), 64)
    np.testing.assert_array_equal(n(ut), np.asarray(uj))
    np.testing.assert_array_equal(n(it), np.asarray(ij))


@pytest.mark.parametrize("ma", [1, 5])
def test_aggregate_residuals_and_codes(ma):
    rng = np.random.default_rng(5 + ma)
    vecs, cents = f32(rng, 40, 64), f32(rng, 48, 64, scale=0.5)
    # distinct words per row, with many shared across rows
    words = np.stack([rng.choice(48, size=ma, replace=False) for _ in range(40)])
    aj, wj, vj = jasmk.aggregate_residuals(jnp.asarray(vecs), jnp.asarray(words, jnp.int32),
                                           jnp.asarray(cents), 40 * ma)
    at, wt, vt = asmk.aggregate_residuals(t(vecs), t(words).long(), t(cents), 40 * ma)
    np.testing.assert_array_equal(n(wt), np.asarray(wj))
    np.testing.assert_array_equal(n(vt), np.asarray(vj))
    aj = np.asarray(aj)
    assert_close(at, aj, 0, AGG_ATOL, "aggregates")
    # the sign bits of the slots in use (padding slots hold zeros)
    keep = np.asarray(vj)
    bits_j = np.unpackbits(np.asarray(jasmk.binarize_pack(jnp.asarray(aj)))[keep]
                           .view(np.uint8))
    bits_t = np.unpackbits(u32(asmk.binarize_pack(at))[keep].view(np.uint8))
    small = np.unpackbits(np.asarray(jasmk.binarize_pack(
        jnp.asarray(np.abs(aj) < AGG_ATOL, jnp.float32)))[keep].view(np.uint8)).astype(bool)
    differ = bits_j != bits_t
    assert not (differ & ~small).any(), "a sign bit flipped on an aggregate above 1e-6"
    # how many bits the rule exempts: none at these inputs
    assert differ.sum() <= small.sum() == 0


# ---------------------------------------------------------------------------
# head
# ---------------------------------------------------------------------------

def _jax_head(rng, D, hdims, whiten=True):
    params = jhead.init_head_params(jax.random.key(int(rng.integers(1 << 30))), D, hdims)
    # f32 leaves (tests/conftest.py turns JAX x64 on), fed to both packages
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    if whiten:
        for key, dim in (("prewhiten", D), ("postwhiten", hdims[-1])):
            params[key] = {"m": f32(rng, dim, scale=0.1),
                           "p": np.eye(dim, dtype=np.float32) + f32(rng, dim, dim, scale=0.1)}
    for lay in params["projector"]:
        lay["b"] = f32(rng, lay["b"].shape[0], scale=0.1)
        if lay["ln"] is not None:
            lay["ln"] = {"w": 1 + f32(rng, lay["b"].shape[0], scale=0.1),
                         "b": f32(rng, lay["b"].shape[0], scale=0.1)}
    return params


@pytest.mark.parametrize("residual", [False, True])
def test_extract_topk_features(residual):
    rng = np.random.default_rng(6)
    D, hdims = 16, (32, 16)
    params = _jax_head(rng, D, hdims)
    feat = f32(rng, 2, 48, D)
    hs_j = jhead.RetrievalHeadSettings(nfeat=12, residual=residual)
    hs_t = head.RetrievalHeadSettings(nfeat=12, residual=residual)
    tparams, _ = retrieval_from_jax(params, np.zeros((1, 1), np.float32))
    # the same tokens are selected, in the same order
    xj = jhead._whiten(params["prewhiten"], jnp.asarray(feat))
    pj = jhead._project(params["projector"], xj) + (xj if residual else 0)
    idx_j = jax.lax.top_k(jnp.linalg.norm(pj, axis=-1), 12)[1]
    xt = head._whiten(tparams["prewhiten"], t(feat))
    pt = head._project(tparams["projector"], xt) + (xt if residual else 0)
    idx_t = torch.topk(vnorm(pt, keepdim=False), 12, dim=1).indices
    np.testing.assert_array_equal(n(idx_t), np.asarray(idx_j))
    want = jhead.extract_topk_features(params, jnp.asarray(feat), hs_j)
    got = head.extract_topk_features(tparams, t(feat), hs_t)
    assert got.shape == (2, 12, 16)
    assert_close(got, np.asarray(want), 1e-5, 1e-5, "features")


def test_state_dict_loader_matches_jax_converter():
    rng = np.random.default_rng(7)
    D, H, O = 12, 20, 8
    sd = {"prewhiten.m": f32(rng, 1, D), "prewhiten.p": f32(rng, D, D),
          "projector.0.weight": f32(rng, H, D), "projector.0.bias": f32(rng, H),
          "projector.1.weight": f32(rng, H), "projector.1.bias": f32(rng, H),
          "projector.3.weight": f32(rng, O, H), "projector.3.bias": f32(rng, O),
          "postwhiten.m": f32(rng, 1, O), "postwhiten.p": f32(rng, O, O)}
    want = jhead.convert_torch_retrieval_head(sd)
    got = head.params_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    flat_j = jax.tree_util.tree_leaves_with_path(want)
    flat_t = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(n, got))
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j] and len(flat_j) == 10
    for (path, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    assert got["projector"][1]["ln"] is None and got["projector"][0]["ln"] is not None


def test_from_torch_checkpoint_matches_jax(tmp_path):
    """A reference-format checkpoint (state dict under "model", nfeat in
    "args") and codebook pickle, loaded by both packages: the same head,
    codebook and feature count, and the same codes for one frame."""
    import argparse
    import pickle

    rng = np.random.default_rng(11)
    D, O = 12, 8
    sd = {"projector.0.weight": torch.from_numpy(f32(rng, O, D)),
          "projector.0.bias": torch.from_numpy(f32(rng, O)),
          "postwhiten.m": torch.from_numpy(f32(rng, 1, O)),
          "postwhiten.p": torch.from_numpy(f32(rng, O, O))}
    torch.save({"model": sd, "args": argparse.Namespace(nfeat=6)}, tmp_path / "ret.pth")
    with open(tmp_path / "cb.pkl", "wb") as f:
        pickle.dump({"state": {"centroids": f32(rng, 32, O)}}, f)
    jdb = JDB.from_torch_checkpoint(str(tmp_path / "ret.pth"), str(tmp_path / "cb.pkl"))
    tdb = RetrievalDatabase.from_torch_checkpoint(str(tmp_path / "ret.pth"),
                                                  str(tmp_path / "cb.pkl"), device=CPU)
    assert tdb.hs.nfeat == jdb.hs.nfeat == 6 and tdb.head_params["prewhiten"] is None
    np.testing.assert_array_equal(n(tdb.centroids), np.asarray(jdb.centroids))
    feat = f32(rng, 1, 20, D)
    _, (fj, cj) = jdb.query(_Frame(jnp.asarray(feat)), 3)
    _, (ft, ct) = tdb.query(_Frame(t(feat)), 3)
    assert_close(ft, np.asarray(fj), 1e-5, 1e-5, "features")
    np.testing.assert_array_equal(n(ct), np.asarray(cj))


# ---------------------------------------------------------------------------
# inverted file
# ---------------------------------------------------------------------------

def _ivf_pair(dim=64, num_words=32, max_images=16):
    s_j = jasmk.ASMKSettings(max_images=max_images)
    s_t = asmk.ASMKSettings(max_images=max_images)
    return (jasmk.DeviceIVF(dim, s_j, num_words=num_words),
            asmk.DeviceIVF(dim, s_t, num_words=num_words, device=CPU))


def _fill(jivf, tivf, rng, n_images, m=20, dim=64, num_words=32):
    for im in range(n_images):
        packed = np.asarray(jasmk.binarize_pack(jnp.asarray(f32(rng, m, dim))))
        words = rng.choice(num_words, size=m, replace=False).astype(np.int32)
        valid = rng.random(m) > 0.1
        jivf.add(jnp.asarray(packed), words, valid, imid=im)
        tivf.add(i32(packed), words, valid, imid=im)


def _queries(rng, Q=60, dim=64, num_words=32):
    packed = np.asarray(jasmk.binarize_pack(jnp.asarray(f32(rng, Q, dim))))
    words = rng.integers(0, num_words, size=Q).astype(np.int32)
    valid = rng.random(Q) > 0.2
    return packed, words, valid


def test_ivf_add_grow_search():
    rng = np.random.default_rng(8)
    jivf, tivf = _ivf_pair()
    _fill(jivf, tivf, rng, 40)  # ~25 entries a word: the buckets grow past 16
    assert tivf.bucket_cap == jivf.bucket_cap == 32
    assert tivf.s.max_images == jivf.s.max_images == 64  # and the image table
    assert (tivf.n_entries, tivf.n_images) == (jivf.n_entries, jivf.n_images)
    np.testing.assert_array_equal(u32(tivf.bvecs), np.asarray(jivf.bvecs))
    np.testing.assert_array_equal(n(tivf.bimids), np.asarray(jivf.bimids))
    for _ in range(3):
        packed, words, valid = _queries(rng)
        sj = np.asarray(jivf.search(jnp.asarray(packed), jnp.asarray(words),
                                    jnp.asarray(valid)))
        st = n(tivf.search(i32(packed), t(words).long(), t(valid)))
        assert_close(st, sj, SCORE_RTOL, 1e-9, "scores")
        assert sj.max() > 0
        np.testing.assert_array_equal(np.argsort(-st)[:5], np.argsort(-sj)[:5])


def test_ivf_entries_round_trip():
    rng = np.random.default_rng(9)
    jivf, tivf = _ivf_pair()
    _fill(jivf, tivf, rng, 12)
    vecs, words, imids = tivf.entries()
    jv, jw, ji = jivf.entries()
    np.testing.assert_array_equal(vecs.view(np.uint32), np.asarray(jv))
    np.testing.assert_array_equal(words, jw)
    np.testing.assert_array_equal(imids, ji)
    _, fresh = _ivf_pair()
    fresh.load_entries(vecs, words, imids, n(tivf.norm_factor), tivf.n_images)
    assert (fresh.n_entries, fresh.n_images) == (tivf.n_entries, tivf.n_images)
    np.testing.assert_array_equal(fresh.fill, tivf.fill)
    packed, qwords, valid = _queries(rng)
    q = (i32(packed), t(qwords).long(), t(valid))
    assert torch.equal(fresh.search(*q), tivf.search(*q))


# ---------------------------------------------------------------------------
# database
# ---------------------------------------------------------------------------

class _Frame:
    def __init__(self, feat):
        self.feat = feat


def test_database_update_and_query_sequence():
    """A sequence of frames whose tokens drift and revisit: every update's
    candidates and every query's candidates and scores agree."""
    rng = np.random.default_rng(10)
    D, N, nfeat = 24, 40, 16
    params = _jax_head(rng, D, (32,), whiten=False)
    cents = f32(rng, 128, 32, scale=0.3)
    jdb = JDB(params, jnp.asarray(cents), jhead.RetrievalHeadSettings(nfeat=nfeat),
              jasmk.ASMKSettings(max_images=8))
    tp, tc = retrieval_from_jax(params, cents)
    tdb = RetrievalDatabase(tp, tc, head.RetrievalHeadSettings(nfeat=nfeat),
                            asmk.ASMKSettings(max_images=8), device=CPU)
    base = f32(rng, 6, N, D)
    seq = [base[i % 6] + f32(rng, N, D, scale=0.05) for i in range(12)]
    n_cands = 0
    for i, feat in enumerate(seq):
        cj = jdb.update(_Frame(jnp.asarray(feat[None])), True, k=3, min_thresh=0.005,
                        kf_index=i)
        ct = tdb.update(_Frame(t(feat[None])), True, k=3, min_thresh=0.005, kf_index=i)
        assert ct == cj, i
        n_cands += len(cj)
    assert n_cands >= 6 and tdb.ivf.s.max_images == jdb.ivf.s.max_images == 16
    for feat in base:
        q = feat + f32(rng, N, D, scale=0.05)
        ij, _, sj = jdb.query(_Frame(jnp.asarray(q[None])), 3, 0.005, with_scores=True)
        it, _, st = tdb.query(_Frame(t(q[None])), 3, 0.005, with_scores=True)
        assert it == ij and len(ij) >= 1
        assert_close(st, sj, SCORE_RTOL, 1e-9, "query scores")


def test_database_random_init_runs():
    db = RetrievalDatabase.random_init(0, 16, proj_dim=8, num_centroids=32, nfeat=6,
                                       device=CPU)
    feat = torch.randn(1, 20, 16, generator=torch.Generator().manual_seed(1))
    assert db.update(_Frame(feat), True, k=2) == []
    assert db.update(_Frame(feat), True, k=2) == [0]  # the same frame comes back
    inds, (feats, codes) = db.query(_Frame(feat), 2)
    assert inds[0] in (0, 1) and feats.shape == (6, 8) and codes.shape == (6, 5)
    db.add(_Frame(feat), precomputed=(feats, codes), kf_index=5)
    assert db.ivf.n_images == 6 and db.kf_counter == 3
