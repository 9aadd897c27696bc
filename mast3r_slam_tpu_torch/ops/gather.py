"""Row gathers with a reduction over the row: three CUDA kernels and their plain forms.

Ports of the two Mosaic gather probes of ``scripts/tpu_r4_experiments.py``
and of the gather-and-popcount of retrieval's bucketed IVF scoring
(``mast3r_slam_tpu/retrieval/asmk.py`` ``_ivf_search_bucketed``):

* ``gather_rows_sum(table, idx)``: ``out[t] = sum_f float(table[idx[t], f])``
  (probe ``gatherprobe``), table (M, F) int8 or f32, f32 out of idx's shape;
* ``ivf_hamming(bvecs, q_vecs, qw)``: ``dist[q, b] = sum_w popcount(q_vecs[q, w]
  ^ bvecs[qw[q], b, w])``, a warp on a query's whole bucket;
* ``take_along_rows(tab, idx)``: ``out[i, f] = tab[idx[i, f], f]`` (probe
  ``gatherprobe2``, ``jnp.take_along_axis`` on axis 0), int8 or f32.

Packed bit codes live in int32 tensors with the bits of the JAX package's
uint32 (torch's uint32 lacks most bitwise kernels); ``popcount32`` counts
them with a SWAR sum on int64.  Each wrapper launches its kernel
(``csrc/gather_rows.cu``, ``csrc/ivf_hamming.cu``, ``csrc/take_along_rows.cu``)
on CUDA tensors or raises; it runs the plain version only on CPU tensors.
The two probes' launch geometry comes from plain functions, ``take_plan``
and ``sum_plan``, fed by the card's occupancy, which the CPU tests walk
as the kernels do.

Run as a script on the card for the probes' full sweeps, ns a row for the
kernel and for the library call (device time):

    python -m mast3r_slam_tpu_torch.ops.gather
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels

sum_counter = kernels.LaunchCounter("gather_rows_sum")
ivf_counter = kernels.LaunchCounter("ivf_hamming")
take_counter = kernels.LaunchCounter("take_along_rows")

_TYPES = (torch.int8, torch.float32)
THREADS = 256     # a block of either probe kernel
SLAB_BYTES = 128  # take_along_rows: bytes of a table row in one slab (chip_smoke sweep)
# take_along_rows: a larger table is gathered one slab a pass, a grid barrier
# between passes, as the L2 (50 MB, shared with idx and out) cannot keep it
PASS_TABLE_BYTES = 32 << 20
_slots: dict = {}  # blocks the card holds at once, by (device, kernel instance)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor, as int32 (a SWAR
    count on int64, where the shifts and the multiply cannot overflow)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gather_rows_sum_plain(table, idx):
    return table[idx.long()].to(torch.float32).sum(dim=-1)


def ivf_hamming_plain(bvecs, q_vecs, qw):
    rows = bvecs[qw.long()]  # (Q, B, W)
    return popcount32(q_vecs[:, None, :] ^ rows).sum(dim=-1, dtype=torch.int32)


def take_along_rows_plain(tab, idx):
    cols = torch.arange(idx.shape[1], device=idx.device)
    return tab[idx.long(), cols]


# ---------------------------------------------------------------------------
# launch plans (plain Python, so that the CPU tests reach them)
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class TakePlan(NamedTuple):
    slab_cols: int  # columns of a slab (a power-of-two multiple of a thread's 4)
    chunks: int     # row chunks of a slab: items = slabs x chunks
    items: int
    passes: int     # 1, or one a slab with a grid barrier between
    grid: int       # a block an item in one pass; else persistent blocks


def take_plan(K: int, M: int, F: int, elem_bytes: int, slots: int,
              slab_bytes: int = SLAB_BYTES) -> TakePlan:
    """Launch of ``take_along_rows`` for tab (M, F) and idx (K, F): a thread
    takes 4 consecutive elements of an output row, a slab ``slab_bytes`` of
    each table row (fewer where a power of two of threads covers the row in
    fewer), a block of THREADS threads one slab of THREADS / (threads a
    slab row) rows an item.  In one pass a block takes one item, and the
    card dispatches blocks in order, slab-major; where the table exceeds
    PASS_TABLE_BYTES, at most ``slots`` blocks (the card's resident blocks)
    walk the items one slab a pass, a grid barrier between."""
    if elem_bytes not in (1, 4) or slab_bytes < 32 or slab_bytes % 32:
        raise ValueError(f"take_plan: elem_bytes {elem_bytes}, slab_bytes {slab_bytes}; "
                         "expected 1 or 4, and a multiple of 32")
    tps = 1  # threads a slab row: a power of two, no wider than the row needs
    while tps * 4 < F and 2 * tps * 4 * elem_bytes <= slab_bytes:
        tps *= 2
    n_slabs = _cdiv(F, 4 * tps)
    chunks = _cdiv(K, THREADS // tps)
    items = n_slabs * chunks
    if n_slabs > 1 and M * F * elem_bytes > PASS_TABLE_BYTES:
        return TakePlan(4 * tps, chunks, items, n_slabs, min(chunks, slots))
    return TakePlan(4 * tps, chunks, items, 1, items)


class SumPlan(NamedTuple):
    nw: int     # words a load (4, 2 or 1: the largest that divides the row)
    lanes: int  # threads a row (a power of two, 32 bytes each a pass)
    rb: int     # rows a group loads at once (1, or 4)
    rows: int   # consecutive rows a group takes
    grid: int   # blocks of THREADS threads


def sum_plan(T: int, row_words: int, slots) -> SumPlan:
    """Launch of ``gather_rows_sum`` for T rows of ``row_words`` 4-byte
    words, in one wave.  ``slots(nw, rb)`` gives the blocks the card holds
    at once of the kernel instance that loads nw words at a time and one
    row (rb 1) or four (rb 4).  A row of up to 32 bytes takes one thread;
    where T exceeds one wave of one-row groups, a group takes a multiple
    of 4 consecutive rows, as few as that wave allows."""
    nw = 4 if row_words % 4 == 0 else (2 if row_words % 2 == 0 else 1)
    lanes = 1
    while lanes * 8 < row_words and lanes < 32:
        lanes *= 2
    groups_block = THREADS // lanes
    if T <= slots(nw, 1) * groups_block:
        rb, rows = 1, 1
    else:
        rb = 4
        rows = 4 * _cdiv(T, 4 * slots(nw, 4) * groups_block)
    return SumPlan(nw, lanes, rb, rows, _cdiv(_cdiv(T, rows), groups_block))


def _slots_of(dev, name: str, *args) -> int:
    """Resident blocks of one kernel instance on ``dev`` (cached)."""
    key = (dev.index, name, args)
    slots = _slots.get(key)
    if slots is None:
        with torch.cuda.device(dev):
            slots = kernels.entry_point(name)(*args)
        if slots <= 0:
            raise RuntimeError(f"{name}: the card's occupancy query failed")
        _slots[key] = slots
    return slots


# ---------------------------------------------------------------------------
# input checks
# ---------------------------------------------------------------------------

def _check(what: str, name: str, t, dtypes, align: int = 0):
    if not t.is_cuda:
        raise ValueError(f"{what}: {name} is not on a CUDA device")
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: {name} is {t.dtype}, the kernel takes "
                         + " or ".join(str(d) for d in dtypes))
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{what}: {name} is not {align}-byte aligned")


def _same_device(what: str, *ts):
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{what}: inputs are on different devices")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def gather_rows_sum_cuda(table, idx):
    what = "gather_rows_sum"
    _check(what, "table", table, _TYPES, align=16)  # rows read 16 bytes a load
    _check(what, "idx", idx, (torch.int32,))
    _same_device(what, table, idx)
    if table.ndim != 2:
        raise ValueError(f"{what}: table has shape {tuple(table.shape)}, expected (M, F)")
    M, F = table.shape
    if table.dtype == torch.int8 and F % 4:
        raise ValueError(f"{what}: F={F}; the kernel takes int8 rows of F % 4 == 0")
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    if idx.numel() == 0:
        return out
    if F == 0:
        return out.zero_()
    is_int8 = int(table.dtype == torch.int8)
    dev = idx.device
    plan = sum_plan(idx.numel(), F // 4 if is_int8 else F,
                    lambda nw, rb: _slots_of(dev, "gather_rows_sum_slots", is_int8, nw, rb))
    fn = kernels.entry_point("gather_rows_sum")
    with torch.cuda.device(dev):
        rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), M, F,
                is_int8, *plan, _stream(idx))
    kernels.check(rc, what)
    sum_counter.add()
    return out


def ivf_hamming_cuda(bvecs, q_vecs, qw):
    what = "ivf_hamming"
    _check(what, "bvecs", bvecs, (torch.int32,), align=16)
    _check(what, "q_vecs", q_vecs, (torch.int32,))
    _check(what, "qw", qw, (torch.int32,))
    _same_device(what, bvecs, q_vecs, qw)
    if bvecs.ndim != 3 or q_vecs.ndim != 2 or qw.ndim != 1:
        raise ValueError(f"{what}: expected bvecs (buckets, cap, W), q_vecs (Q, W), "
                         f"qw (Q,); got {tuple(bvecs.shape)}, {tuple(q_vecs.shape)}, "
                         f"{tuple(qw.shape)}")
    n_buckets, cap, W = bvecs.shape
    Q = qw.shape[0]
    if q_vecs.shape != (Q, W):
        raise ValueError(f"{what}: q_vecs has shape {tuple(q_vecs.shape)}, expected "
                         f"({Q}, {W}) (Q from qw, W from bvecs)")
    out = torch.empty((Q, cap), dtype=torch.int32, device=qw.device)
    if Q * cap == 0:
        return out
    if W == 0:
        return out.zero_()
    fn = kernels.entry_point("ivf_hamming")
    with torch.cuda.device(qw.device):
        rc = fn(bvecs.data_ptr(), q_vecs.data_ptr(), qw.data_ptr(), out.data_ptr(),
                Q, n_buckets, cap, W, _stream(qw))
    kernels.check(rc, what)
    ivf_counter.add()
    return out


def take_along_rows_cuda(tab, idx, slab_bytes: int = SLAB_BYTES):
    what = "take_along_rows"
    _check(what, "tab", tab, _TYPES)
    _check(what, "idx", idx, (torch.int32,), align=16)  # 4 indices a load
    _same_device(what, tab, idx)
    if tab.ndim != 2 or idx.ndim != 2 or idx.shape[1] != tab.shape[1]:
        raise ValueError(f"{what}: expected tab (M, F) and idx (K, F); got "
                         f"{tuple(tab.shape)} and {tuple(idx.shape)}")
    M, F = tab.shape
    K = idx.shape[0]
    out = torch.empty((K, F), dtype=tab.dtype, device=idx.device)
    if K * F == 0:
        return out
    eb = tab.element_size()
    plan = take_plan(K, M, F, eb, _slots_of(idx.device, "take_along_rows_slots", eb),
                     slab_bytes)
    fn = kernels.entry_point("take_along_rows")
    with torch.cuda.device(idx.device):
        rc = fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), K, M, F, eb, *plan,
                _stream(idx))
    kernels.check(rc, what)
    take_counter.add()
    return out


# ---------------------------------------------------------------------------
# dispatch on the tensors' device
# ---------------------------------------------------------------------------

def gather_rows_sum(table, idx):
    """f32 sums of the gathered rows: the kernel on CUDA, plain on CPU."""
    if idx.device.type == "cpu":
        return gather_rows_sum_plain(table, idx)
    return gather_rows_sum_cuda(table, idx)


def ivf_hamming(bvecs, q_vecs, qw):
    """(Q, bucket_cap) int32 Hamming distances of each query code to its
    word's bucket: the kernel on CUDA, plain on CPU."""
    if qw.device.type == "cpu":
        return ivf_hamming_plain(bvecs, q_vecs, qw)
    return ivf_hamming_cuda(bvecs, q_vecs, qw)


def take_along_rows(tab, idx):
    """``torch.gather(tab, 0, idx)``: the kernel on CUDA, plain on CPU."""
    if idx.device.type == "cpu":
        return take_along_rows_plain(tab, idx)
    return take_along_rows_cuda(tab, idx)


# ---------------------------------------------------------------------------
# the probes' sweeps (scripts/tpu_r4_experiments.py gatherprobe, gatherprobe2)
# ---------------------------------------------------------------------------

def probe_sweeps(dev, log=print) -> int:
    """Every shape of the two probes: the kernel checked exactly against its
    plain version, then ns a row of device time for the kernel and the
    library call.  Returns the number of shapes that disagreed."""
    from ..utils.timing import device_ms

    g = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for dtype, dname in ((torch.int8, "int8"), (torch.float32, "f32")):
        for M in (4096, 32768, 196608):
            for F in (16, 32):
                table = torch.randint(-100, 100, (M, F), device=dev, generator=g).to(dtype)
                for Tn in (128, 1536):
                    idx = torch.randint(0, M, (Tn, 128), device=dev, generator=g,
                                        dtype=torch.int32)
                    ok = torch.equal(gather_rows_sum(table, idx),
                                     gather_rows_sum_plain(table, idx))
                    bad += not ok
                    rows = Tn * 128
                    ms = device_ms(lambda: gather_rows_sum(table, idx))
                    flat = idx.reshape(-1)
                    lib = device_ms(lambda: torch.index_select(table, 0, flat)
                                   .float().sum(-1))
                    log(f"gather_rows_sum {dname} M={M:6d} F={F} rows={rows:6d}: kernel "
                        f"{ms * 1e6 / rows:7.3f} ns/row, index_select+sum "
                        f"{lib * 1e6 / rows:7.3f} ns/row, exact {ok}")
        for M, F in ((256, 128), (2048, 128), (8192, 128), (49152, 128),
                     (196608, 32), (196608, 128)):
            tab = torch.randint(-100, 100, (M, F), device=dev, generator=g).to(dtype)
            idx = torch.randint(0, M, (M, F), device=dev, generator=g, dtype=torch.int32)
            ok = torch.equal(take_along_rows(tab, idx), take_along_rows_plain(tab, idx))
            bad += not ok
            ms = device_ms(lambda: take_along_rows(tab, idx))
            idx64 = idx.long()
            lib = device_ms(lambda: torch.gather(tab, 0, idx64))
            log(f"take_along_rows {dname} ({M:6d},{F:3d}): kernel {ms * 1e6 / M:8.3f} "
                f"ns/row of {F}, torch.gather {lib * 1e6 / M:8.3f} ns/row, exact {ok}")
    # the table's L2 footprint at the probe's f32 (196608, 128): the same call
    # with its indices kept under fewer rows, so fewer 128-byte lines a slab
    M, F = 196608, 128
    tab = torch.randint(-100, 100, (M, F), device=dev, generator=g).float()
    for rows in (2048, 49152, M):
        idx = torch.randint(0, rows, (M, F), device=dev, generator=g, dtype=torch.int32)
        ok = torch.equal(take_along_rows(tab, idx), take_along_rows_plain(tab, idx))
        bad += not ok
        ms = device_ms(lambda: take_along_rows(tab, idx))
        log(f"take_along_rows f32 ({M},{F}), indices under {rows:6d} rows: kernel "
            f"{ms:.5f} ms, exact {ok}")
    return bad


if __name__ == "__main__":
    import subprocess
    import sys

    if not torch.cuda.is_available():
        sys.exit("the probe sweeps need a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    sys.exit(1 if probe_sweeps(torch.device("cuda", 0)) else 0)
