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

Run as a script on the card for the probes' full sweeps, ns a row for the
kernel and for the library call (device time):

    python -m mast3r_slam_tpu_torch.ops.gather
"""

from __future__ import annotations

import torch

from . import kernels

sum_counter = kernels.LaunchCounter("gather_rows_sum")
ivf_counter = kernels.LaunchCounter("ivf_hamming")
take_counter = kernels.LaunchCounter("take_along_rows")

_TYPES = (torch.int8, torch.float32)


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
    fn = kernels.entry_point("gather_rows_sum")
    with torch.cuda.device(idx.device):
        rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), M, F,
                int(table.dtype == torch.int8), _stream(idx))
    kernels.check(rc, what)
    sum_counter.count += 1
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
    ivf_counter.count += 1
    return out


def take_along_rows_cuda(tab, idx):
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
    fn = kernels.entry_point("take_along_rows")
    with torch.cuda.device(idx.device):
        rc = fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), K, M, F,
                tab.element_size(), _stream(idx))
    kernels.check(rc, what)
    take_counter.count += 1
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
