#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card (an H100 is the target) and exits non-zero without one.
It imports no JAX.  Phases, any failure of which ends the run non-zero:

  1. the card's name and power limit (nvidia-smi); build every kernel from
     the sources in mast3r_slam_tpu_torch/csrc (one nvcc per source, in
     parallel) and the host library from csrc/host (g++);
  2. each kernel against its plain PyTorch version at the main path's
     shapes (attention (1,16,768,64), (1,12,768,64) and (2,12,768,64)
     bf16, and (1,16,768,64) on heads split from a fused qkv tensor, with
     the HGMMA and TMA-load counts of its SASS and the kernel SDPA runs;
     refine at 384x512, F=24, radius/dilation (3,5) (the schedule 5..1)
     and (1,1), and the speed profile's two launches (12,288 compacted
     pixels at the schedule (5,2), radius 3; every pixel at (1,), radius
     1), exactly equal, on scattered and on smooth-flow matches, with the
     share of (block, level) pairs its shared-memory window served; the
     edge blocks at 32 edges x 384*512 pixels f32, entry by entry on the
     solve's scale, planted faults shown to fail, the same bits on two
     calls, one kernel a call, exact zeros where no row reaches), each
     timed by its device
     time (torch.profiler) and by CUDA events around back-to-back calls,
     beside the plain version's device time and, where one exists, the
     PyTorch library call's, read both ways too;
  3. a small bf16 model on the card (kernels) against the same model on the
     CPU (plain versions);
  4. ViT-L at 384x512 with seeded random weights, bf16 trunk and f32 heads,
     TF32 off: encode, mono (INIT), then FrameTracker.track on a few frames,
     with the launch counters reset just before and read just after;
     then the `speed` profile on the same weights with bf16 heads: the
     frames through FrameTracker.track (72 attention and 2 refine launches
     a frame, counted) and through the pipelined entry points (infer,
     track_submit_chained, track_finish) for the same bits, once as
     packaged and once with the decisions pinned so that every frame
     commits and the chain is taken; then one one-way backend task
     (add_factors on a non-consecutive pair, then solve), counted;
  5. SLAM.run over a synthetic plane scene at 384x512 with a known
     trajectory (a stand-in model with the encode/asymmetric/symmetric/mono
     protocol), the backend's solves included, the trajectory held to a
     bound: sequential under `base`; single threaded with pipeline 1, for
     the sequential run's poses bit for bit; and under `speed` as packaged
     (the backend on its worker thread, the pipelined loop), held to the
     same bound, with frame.latency p50/p95 beside the backend tasks and the
     pipeline.* stages;
  6. the backend at full width: the global Gauss-Newton on a synthetic
     16-keyframe rays problem at 384x512 (32 two-way edges), through both
     entries (gathering, and the gathered-point cache that FactorGraph.solve
     takes up to 256 edges; the cached one profiled), then PCG rays and
     calib mode through the cached entry, each held to its ground truth
     and run twice for the same pose bits, and one ViT-L backend task
     (three keyframes, FactorGraph.add_factors([1], [2]),
     FactorGraph.solve()) with the launch counters reset just before and
     read just after;
  7. retrieval at full width: the default head (1024 -> 1024, 300
     features) and a seeded 64k-word codebook over ViT-L tokens, the
     inverted file filled to 512 keyframes; update and query timed (one
     query profiled), one ivf_hamming launch a call, the kernel exactly
     against its plain version on a query's tensors and the kernel route's
     scores against the plain route's, one query three times for the same
     score bits (and the scatter-add alone on its slots, index_add_ against
     the fixed-order sum), update twice on one state;
  8. relocalisation: SLAM.run with a small retrieval head over the plane
     scene at 384x512 whose camera teleports back to its start; it must
     relocalise, end in TRACKING and land within 0.15 m, with the launch
     counts of every kernel following its queries, edges and solves, and
     ivf_hamming exact on a query of the database it built (W = 1); then
     the same under `speed` as packaged (threaded backend, pipeline 1),
     held to the same bound.  A backend task that failed on the worker
     thread fails the run;
  9. the command-line entry point (``slam.run.main``) on a 24-frame 480x640
     TUM sequence the script writes (fr1-named, constant-gray PNGs through
     the port's writer, rgb.txt, groundtruth.txt), from build/chip_smoke/:
     (a) phase 5's stand-in model behind ``run.build_slam`` under
     eval_no_calib and eval_calib (fr1 undistortion, K_frame), each scored
     by the ATE CLI against TRAJ_BOUND_M, the outputs listed; a checkpoint
     a frame past the second keyframe, loaded into a fresh engine (keyframe
     poses bit for bit) that finishes the sequence within TRAJ_BOUND_M;
     (b) ViT-L through the CLI, 8 frames, decisions pinned open by --set so
     that each tracked frame runs a backend task, with random weights
     (seed 0) and then with ``--checkpoint`` an npz that ``save_params``
     wrote from the same weights: the same trajectory bits, 72 attention
     launches a frame and 48 a backend task, one refine launch a tracked
     frame and a task, edge blocks in every solve; frames/s, the stage
     times (ingest on the prefetch thread, the exports) and the map
     checkpoint's time, beside the card's name and power limit.

Phase 2 also holds the two gather probes' kernels (gather_rows_sum,
take_along_rows, the latter at every slab width of SLAB_SWEEP, timed in
turns) and the IVF bucket scoring (ivf_hamming, W 1, 2 and 32, one kernel
a call) exactly against their plain versions; their bytes bounds count the
rows or elements this run's indices gather (and, for take_along_rows, the
32-byte sectors).  It then reads the design of the edge-block, IVF and two
gather kernels off the card: ptxas registers and spills, the gathers'
launch plans, the edge blocks' SASS pixel loop (instructions, FFMA, MUFU,
subroutine calls; cuobjdump), and a one-element fill's device time as the
floor of any kernel's.  Phase 4 ends with a torch.profiler breakdown of one more ViT-L tracked
frame (device time by kernel, launches, device busy share).  It prints one
JSON line of kernel numbers, then as its last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

# ---------------------------------------------------------------------------
# published H100 SXM peaks (NVIDIA data sheet, dense) for the bounds
# ---------------------------------------------------------------------------
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores

ATTN_MAX_ERR = 2.0 ** -6   # 2 bf16 ulps at magnitude 2: the kernel rounds the
ATTN_MEAN_ERR = 2e-3       # softmax weights before normalising, sdpa_xla after
SMALL_MODEL_RTOL = 0.1     # bf16 card path vs bf16 CPU path, relative L2
TRAJ_BOUND_M = 0.005       # synthetic scene: Sim(3)-aligned frame RMSE, metres
# edge blocks, entry by entry on the scale the solve reads them at
# (edge_hg.block_err: |diff_ij| / sqrt(|plain_ii|·|plain_jj|), the cost as the
# error column's diagonal): the kernel against the plain version in float64,
# and against the plain version in f32, whose long (8, 4N) x (4N, 8) products
# drift more than the kernel's tree of partial sums.  Read at 32 x 384*512 on
# an H100: kernel 4.2e-6 and plain f32 4.3e-4 against float64; the planted
# faults 0.031 (gradient negated) to 1 (distance row dropped)
EDGE_HG_ERR_F64 = 3e-5
EDGE_HG_ERR_F32 = 1e-3
SOLVE_BOUND_M = 1e-3       # full-width synthetic solve: max translation error, m
# flops of one pixel-edge in csrc/edge_hg_rays.cu, recounted from the
# one-launch source (an FMA is 2, a MUFU 1): transform 18, norms, unit rays
# and residuals 26, dr/dP 12, weights 24, 23 weight products and 78 FMAs
# into the accumulator 179 (the old source's 406 counted its products of
# structural zeros); the bytes bound stays the larger
EDGE_HG_FLOPS = 259
N_TRACKED = 5              # ViT-L tracked frames
# retrieval scores, kernel route against plain route on the same tensors:
# the distances are equal integers, and the rest is one f32 chain whose
# per-image sums run in a fixed order (1.2e-7 was read on an H100 when they
# were atomic adds)
RETRIEVAL_SCORE_RTOL = 1e-6
RELOC_BOUND_M = 0.15       # post-reloc frames against ground truth (tests/test_reloc_e2e.py)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    """Wait for the card (a no-op in a CPU rehearsal)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_kernel(kernel, plain, library=None, plain_iters: int = 20) -> dict:
    """Each function timed two ways, the same two for all three: ms,
    plain_ms and library_ms are device time a call (torch.profiler, which
    raises where it lost kernels); call_ms and library_call_ms are CUDA
    events around 20 back-to-back calls, which also read the host's launch
    rate (PRs 1-2 read only these)."""
    from mast3r_slam_tpu_torch.utils.timing import device_ms

    out = dict(ms=device_ms(kernel), call_ms=time_cuda(kernel),
               plain_ms=device_ms(plain, iters=plain_iters, warmup=min(3, plain_iters)),
               library_ms=None, library_call_ms=None)
    if library is not None:
        out["library_ms"] = device_ms(library)
        out["library_call_ms"] = time_cuda(library)
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_names(fn) -> list:
    """Names of the kernels one call of ``fn`` launched, one entry a launch
    (torch.profiler).  A call launches at least one kernel, so a trace with
    no kernel record has lost them (seen on an H100 for kernels launched
    from a ctypes library): it is taken again, up to ten times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(10):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)
        if names:
            break
    return names


def dump_sass(lib: str) -> str:
    """A built library's SASS (cuobjdump, next to nvcc)."""
    from mast3r_slam_tpu_torch.ops import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, "--dump-sass", str(kernels.library_path(lib))],
                          capture_output=True, text=True, timeout=120, check=True).stdout


def sass_counts(lib: str) -> dict:
    """Counts of the Hopper instructions that show the attention design in
    a built library's SASS: HGMMA (wgmma) and UTMALDG (TMA loads)."""
    sass = dump_sass(lib)
    return {op: sum(op in line for line in sass.splitlines()) for op in ("HGMMA", "UTMALDG")}


def sass_loop(lib: str, function: str) -> dict:
    """The innermost loop of one kernel's SASS that holds a MUFU.RSQ (the
    shortest backward-branch span with one: the edge blocks' pixel loop):
    its instruction count and its FFMA, MUFU and CALL counts (a CALL there
    is a division or square-root subroutine), and the kernel's MUFU
    variants."""
    import re

    text, body = dump_sass(lib), None
    for part in text.split("Function : ")[1:]:
        if function in part.split()[0]:
            body = part
    if body is None:
        raise AssertionError(f"{lib}: no function {function} in its SASS")
    ins = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            toks = [t for t in m.group(2).split() if not t.startswith("@")]
            ins.append((int(m.group(1), 16), toks[0], m.group(2)))
    back = [(a, int(t.group(1), 16)) for a, op, txt in ins if op.startswith("BRA")
            for t in [re.search(r"0x([0-9a-f]+)", txt)] if t and int(t.group(1), 16) < a]
    spans = [[op for a, op, _ in ins if lo <= a <= hi] for hi, lo in back]
    spans = [s for s in spans if "MUFU.RSQ" in s]
    if not spans:
        raise AssertionError(f"{lib}: {function} has no loop with a MUFU.RSQ")
    loop = min(spans, key=len)
    return dict(loop_instructions=len(loop),
                FFMA=sum(op == "FFMA" for op in loop),
                MUFU=sum(op.startswith("MUFU") for op in loop),
                MUFU_RSQ=sum(op == "MUFU.RSQ" for op in loop),
                CALL=sum(op.startswith("CALL") for op in loop),
                kernel_CALL=sum(op.startswith("CALL") for _, op, _ in ins),
                kernel_MUFU=sorted({op for _, op, _ in ins if op.startswith("MUFU")}))


def ptxas_report(lib: str) -> dict:
    """Registers and spill bytes of each kernel of a built library, from
    its ptxas -v log: {function: {registers, spill_stores, spill_loads}}."""
    import re
    from mast3r_slam_tpu_torch.ops import kernels

    out, fn = {}, None
    for line in kernels.build_log(lib).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


def check_attention(dev, B: int, H: int, strided: bool = False):
    """The kernel against its plain version on one of the path's shapes,
    timed beside SDPA.  strided: q/k/v as the model passes them, heads
    split from a fused (B, N, 3*H*64) projection by a permute."""
    import torch
    import torch.nn.functional as F
    from mast3r_slam_tpu_torch.ops import attention

    N, D = 768, 64
    g = torch.Generator(device=dev).manual_seed(H + 100 * B + strided)
    if strided:
        qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
    else:
        q, k, v = (torch.randn(B, H, N, D, device=dev, generator=g).to(torch.bfloat16)
                   for _ in range(3))
    got = attention.sdpa(q, k, v)
    want = attention.sdpa_plain(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    label = f"attention ({B},{H},{N},{D}){' strided' if strided else ''} bf16"
    if not (torch.isfinite(got.float()).all() and max_err <= ATTN_MAX_ERR
            and mean_err <= ATTN_MEAN_ERR):
        raise AssertionError(f"{label}: max err {max_err} (<= {ATTN_MAX_ERR}), "
                             f"mean err {mean_err} (<= {ATTN_MEAN_ERR})")
    times = time_kernel(lambda: attention.sdpa(q, k, v),
                        lambda: attention.sdpa_plain(q, k, v),
                        lambda: F.scaled_dot_product_attention(q, k, v))
    flops = 4.0 * B * H * N * N * D
    nbytes = 4.0 * B * H * N * D * 2  # q, k, v read once, out written once
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    res = dict(shape=[B, H, N, D], strided=strided, max_abs_err=max_err,
               mean_abs_err=mean_err, **times, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"{label}: {json.dumps(res)}")
    return res


def refine_inputs(dev, H, W, F, smooth: bool, seed=7):
    """Phase 2's refine inputs at 384x512.  smooth=False ("current" in the
    log): descriptors correlated over a pixel, each match shifted up to 6
    px at random, starts up to 2 px off it.  smooth=True, as on video:
    descriptors that vary over about 8 px (a field upsampled from 1/8
    resolution, plus a third of pixel-scale detail), matches displaced by
    a smooth flow (3 + 5 sin, -2 + 4 cos over the image), starts up to 2 px
    off, so a 16x16 patch's matches stay in a small box."""
    import torch
    import torch.nn.functional as Fn
    from mast3r_slam_tpu_torch.ops import refine

    B, N = 1, H * W
    g = torch.Generator(device=dev).manual_seed(seed)
    D11 = torch.randn(B, H, W, F, device=dev, generator=g)
    if smooth:
        low = torch.randn(B, F, H // 8, W // 8, device=dev, generator=g)
        field = Fn.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
        field = field.permute(0, 2, 3, 1)
        D11 = (field / field.norm(dim=-1, keepdim=True)
               + 0.3 * D11 / D11.norm(dim=-1, keepdim=True))
    else:
        D11 = D11 + 0.7 * torch.roll(D11, 1, 2) + 0.5 * torch.roll(D11, 1, 1)
    D11 = D11 / D11.norm(dim=-1, keepdim=True)
    lin = torch.arange(N, device=dev)
    if smooth:
        pu, pv = (lin % W).float(), (lin // W).float()
        u = (pu + torch.round(3 + 5 * torch.sin(2 * np.pi * pv / H))).long().clamp(0, W - 1)
        v = (pv + torch.round(-2 + 4 * torch.cos(2 * np.pi * pu / W))).long().clamp(0, H - 1)
    else:
        shift = torch.randint(-6, 7, (B, N, 2), device=dev, generator=g)
        u = (lin % W + shift[..., 0]).clamp(0, W - 1)
        v = (lin // W + shift[..., 1]).clamp(0, H - 1)
    D21 = D11.reshape(B, N, F)[0][v * W + u]
    D21 = D21 + 0.05 * torch.randn(D21.shape, device=dev, generator=g)
    d11q = refine.quantize(D11).reshape(B, N, F).contiguous()
    d21q = refine.quantize(D21).reshape(B, N, F).contiguous()
    # start from iter_proj-like positions: the true match plus up to 2 px
    jit = torch.randint(-2, 3, (B, N, 2), device=dev, generator=g)
    su = (u + jit[..., 0]).clamp(1, W - 2)
    sv = (v + jit[..., 1]).clamp(1, H - 2)
    return d11q, d21q, (sv * W + su).to(torch.int32).reshape(B, N).contiguous()


def speed_subset(d21q, idx, conv_seed=5):
    """The speed profile's first refine launch takes a compacted subset:
    gate_budget(N, 0.0625) = 12,288 pixels at 384x512, the unconverged
    first (a seeded mask with 8 % of them, more than the budget holds),
    then filler, in that order.  Returns the subset's (d21q, idx)."""
    import torch
    from mast3r_slam_tpu_torch.ops import matching

    B, N, F = d21q.shape
    g = torch.Generator(device=idx.device).manual_seed(conv_seed)
    conv = torch.rand((B, N), device=idx.device, generator=g) > 0.08
    sel = matching._compact_unconverged(conv, matching.gate_budget(N, 0.0625))
    return (torch.gather(d21q, 1, sel[..., None].expand(-1, -1, F)).contiguous(),
            torch.gather(idx, 1, sel).contiguous())


def refine_work(idx, H, W, radius, sched, d11q, d21q):
    """What a scheduled launch must touch on these inputs: the distinct
    descriptor-image rows its in-image candidates read, and the in-image
    candidates scored, level by level from the plain version's path."""
    import torch
    from mast3r_slam_tpu_torch.ops import refine

    diam = 2 * radius + 1
    off = torch.arange(diam, device=idx.device) - radius
    rows, n_cand, cur = [], 0, idx
    for d in sched:
        u0, v0 = (cur % W).long(), torch.div(cur, W, rounding_mode="floor").long()
        uu = (u0[..., None] + off * d)[..., None, :].expand(*u0.shape, diam, diam)
        vv = (v0[..., None] + off * d)[..., :, None].expand(*u0.shape, diam, diam)
        inside = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
        rows.append((vv * W + uu)[inside])
        n_cand += int(inside.sum().item())
        cur = refine.refine_window_plain(d11q, d21q, cur, H, W, radius, (d,))
    return int(torch.unique(torch.cat(rows)).numel()), n_cand


def check_refine_speed(dev, d11q, d21q, idx, name):
    """The speed profile's two launches on one input, each exact against the
    plain version with the same schedule: the compacted subset at (5, 2),
    radius 3, then every pixel at (1,), radius 1.  Each timed, with its
    bound from the rows and candidates this input's path touches."""
    import torch
    from mast3r_slam_tpu_torch.ops import refine

    H, W, F = 384, 512, d11q.shape[-1]
    sub_q, sub_i = speed_subset(d21q, idx)
    out = {}
    for label, q, i, radius, sched in (("subset", sub_q, sub_i, 3, (5, 2)),
                                       ("all_r1", d21q, idx, 1, (1,))):
        stats = torch.zeros(4, dtype=torch.int64, device=dev)
        got = refine.refine_window_cuda(d11q, q, i, H, W, radius, sched, stats=stats)
        want = refine.refine_window_plain(d11q, q, i, H, W, radius, sched)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum().item())
        if n_diff:
            raise AssertionError(f"refine {name} speed {label} {sched} r={radius}: "
                                 f"{n_diff} of {i.numel()} indices differ")
        whole, pairs = stats.tolist()[:2]
        times = time_kernel(lambda: refine.refine_window(d11q, q, i, H, W, radius, sched),
                            lambda: refine.refine_window_plain(d11q, q, i, H, W, radius, sched),
                            plain_iters=3)
        n_rows, n_cand = refine_work(i, H, W, radius, sched, d11q, q)
        nbytes = n_rows * F + q.numel() + i.numel() * 4 * 2
        ops = 2.0 * F * n_cand
        t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
        out[label] = dict(schedule=list(sched), radius=radius, n=int(i.numel()),
                          max_abs_err=0, pairs_shared=whole / pairs, rows_touched=n_rows,
                          candidates=n_cand, **times, bound_ms=max(t_ops, t_bytes) * 1e3,
                          bound_by="operations" if t_ops >= t_bytes else "bytes")
        log(f"refine {name} speed {label} (schedule {sched}, r={radius}, {i.numel()} "
            f"pixels): exact; {json.dumps(out[label])}")
    return out


def check_refine(dev):
    """Exact against the plain version at (3, 5) (the schedule 5..1) and
    (1, 1) on three inputs (the current one, a smooth flow, starts
    scattered over the image), and the speed profile's two launches on
    each (check_refine_speed); the share of (block, level) pairs served
    from the shared-memory window, and of pixel-levels, for each; each
    timed at (3, 5)."""
    import torch
    from mast3r_slam_tpu_torch.ops import refine

    H, W, F = 384, 512, 24
    N = H * W
    res, out, speed = {}, {}, {}
    for name in ("current", "smooth_flow", "scattered"):
        d11q, d21q, idx = refine_inputs(dev, H, W, F, name == "smooth_flow")
        if name == "scattered":  # starts anywhere in the image, as random weights give
            g = torch.Generator(device=dev).manual_seed(8)
            idx = torch.randint(0, N, (1, N), device=dev, generator=g, dtype=torch.int32)
        speed[name] = check_refine_speed(dev, d11q, d21q, idx, name)
        for radius, dil in ((3, 5), (1, 1)):
            sched = refine.schedule(dil)
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            got = refine.refine_window_cuda(d11q, d21q, idx, H, W, radius, sched, stats=stats)
            want = refine.refine_window_plain(d11q, d21q, idx, H, W, radius, sched)
            torch.cuda.synchronize()
            n_diff = int((got != want).sum().item())
            if n_diff:
                raise AssertionError(f"refine {name} ({radius},{dil}): {n_diff} indices differ")
            whole, pairs, px_win, px_all = stats.tolist()
            moved = (got != idx).float().mean().item()
            log(f"refine {name} (r={radius}, d={dil}) at 384x512 F=24: exact; {moved:.3f} "
                f"of pixels moved; (block, level) pairs from shared memory "
                f"{whole}/{pairs} = {whole / pairs:.4f}, pixel-levels {px_win / px_all:.4f}")
            if (radius, dil) == (3, 5):
                err = int((got.long() - want.long()).abs().max().item())
                out[name] = dict(max_abs_err=err, pairs_shared=whole / pairs,
                                 pixel_levels_shared=px_win / px_all)
        sched = refine.schedule(5)
        times = time_kernel(
            lambda: refine.refine_window(d11q, d21q, idx, H, W, 3, sched),
            lambda: refine.refine_window_plain(d11q, d21q, idx, H, W, 3, sched),
            plain_iters=3)
        nbytes = d11q.numel() + d21q.numel() + idx.numel() * 4 * 2
        # int8 multiply-adds of every candidate at every level; this counts
        # masked border candidates too, an upper bound that does not move
        # the bound (bytes exceed it 15-fold)
        ops = 2.0 * N * F * 7 ** 2 * 5
        t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
        res[name] = dict(**out[name], **times,
                         bound_ms=max(t_ops, t_bytes) * 1e3,
                         bound_by="operations" if t_ops >= t_bytes else "bytes")
        log(f"refine {name} (r=3, d=5): {json.dumps(res[name])}")
    if not res["smooth_flow"]["pairs_shared"] > 0.9:
        raise AssertionError(f"refine smooth flow: {res['smooth_flow']['pairs_shared']} of "
                             f"(block, level) pairs from shared memory (> 0.9)")
    return res["current"], res["smooth_flow"], res["scattered"], speed


def edge_hg_inputs(dev, E, N, seed):
    """Edges whose j-points map near their i-points (residuals on both sides
    of the Huber threshold), a fifth of the pixels invalid (sq = 0)."""
    import torch
    from mast3r_slam_tpu_torch.lie import sim3

    g = torch.Generator(device=dev).manual_seed(seed)
    xi = 0.2 * torch.randn(E, 7, device=dev, generator=g)
    Tij = sim3.exp(xi)
    Xi = torch.randn(E, N, 3, device=dev, generator=g)
    Xi[..., 2] = Xi[..., 2].abs() + 2.0
    Xj = sim3.act(sim3.inv(Tij)[:, None, :], Xi)
    Xj = Xj + 0.01 * torch.randn(Xj.shape, device=dev, generator=g)
    q = 1.5 + 1.5 * torch.rand(E, N, device=dev, generator=g)
    keep = torch.rand(E, N, device=dev, generator=g) > 0.2
    sq = torch.sqrt(q) * keep
    return Tij.contiguous(), Xi.contiguous(), Xj.contiguous(), sq.contiguous()


def check_edge_hg(dev, E=32, N=384 * 512):
    import torch
    from mast3r_slam_tpu_torch.ops import edge_hg

    Tij, Xi, Xj, sq = edge_hg_inputs(dev, E, N, seed=11)
    kw = dict(sigma_ray=0.003, sigma_dist=10.0, huber_k=1.345)
    got = edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **kw)
    want = edge_hg.edge_hg_rays_plain(Tij, Xi, Xj, sq, **kw)
    exact = edge_hg.edge_hg_rays_plain(Tij.double(), Xi.double(), Xj.double(),
                                       sq.double(), **kw)
    torch.cuda.synchronize()
    max_err = (got - want).abs().max().item()
    errs = {"kernel_vs_f64": edge_hg.block_err(got, exact),
            "plain_f32_vs_f64": edge_hg.block_err(want, exact),
            "kernel_vs_plain_f32": edge_hg.block_err(got, want)}
    # planted faults the check must fail: the kernel with its distance row
    # dropped, its output with the gradient negated, with the cost 30 % off
    no_dist = edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **{**kw, "sigma_dist": float("inf")})
    neg_grad = got.clone()
    neg_grad[:, :7, 7] *= -1
    neg_grad[:, 7, :7] *= -1
    cost_off = got.clone()
    cost_off[:, 7, 7] *= 1.3
    faults = {k: edge_hg.block_err(v, exact) for k, v in (
        ("distance_row_dropped", no_dist), ("gradient_negated", neg_grad),
        ("cost_30pc_off", cost_off))}
    del exact
    again = edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **kw)
    names = kernel_names(lambda: edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **kw))
    same_bits = torch.equal(got, again)
    zeros = bool((got[:, 3:6, 6] == 0).all() and (got[:, 6, 3:6] == 0).all())
    log(f"edge blocks ({E}, {N}), per-entry scaled error: {json.dumps(errs)}; "
        f"planted faults: {json.dumps(faults)}; same bits on two calls {same_bits}; "
        f"Mloc[:, 3:6, 6] exact zeros {zeros}; kernels a call {names}")
    if not (torch.isfinite(got).all() and errs["kernel_vs_f64"] <= EDGE_HG_ERR_F64
            and errs["kernel_vs_plain_f32"] <= EDGE_HG_ERR_F32):
        raise AssertionError(f"edge blocks ({E}, {N}): {errs} (bounds {EDGE_HG_ERR_F64} "
                             f"against float64, {EDGE_HG_ERR_F32} against f32)")
    if not (same_bits and zeros and len(names) == 1):
        raise AssertionError(f"edge blocks: same bits {same_bits}, structural zeros "
                             f"{zeros}, kernels a call {names} (one expected)")
    passed = {k: v for k, v in faults.items() if not v > 100 * EDGE_HG_ERR_F64}
    if passed:
        raise AssertionError(f"edge blocks: planted faults within 100x the bound {passed}")
    times = time_kernel(lambda: edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **kw),
                        lambda: edge_hg.edge_hg_rays_plain(Tij, Xi, Xj, sq, **kw),
                        plain_iters=3)
    nbytes = E * N * 28 + E * 8 * 4 + E * 64 * 4  # Xi, Xj, sq, Tij in; Mloc out
    t_ops, t_bytes = E * N * EDGE_HG_FLOPS / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    res = dict(shape=[E, N], max_abs_err=max_err, scaled_err=errs, **times,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"edge blocks ({E} edges, {N} px) f32: {json.dumps(res)}")
    return res


def _bound(nbytes, ops=0.0, peak_ops=PEAK_F32_FLOPS):
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes")


def _exact(name, got, want):
    import torch

    if not torch.equal(got, want):
        raise AssertionError(f"{name}: the kernel differs from its plain version")


def _n_unique(x) -> int:
    import torch

    return int(torch.unique(x).numel())


def check_gather_rows_sum(dev, M=196_608, T=196_608):
    """Probe 1 at its largest table: int8 and f32, F 16 and 32, integer
    values in [-100, 100), so every f32 sum is exact.  Bytes: the distinct
    rows this run's indices gather (about 63 % of the table), the indices
    and the sums.  Returns the int8 F=32 record."""
    import torch
    from mast3r_slam_tpu_torch.ops import gather

    g = torch.Generator(device=dev).manual_seed(21)
    out = {}
    for dtype in (torch.int8, torch.float32):
        for F in (16, 32):
            table = torch.randint(-100, 100, (M, F), device=dev, generator=g).to(dtype)
            idx = torch.randint(0, M, (T,), device=dev, generator=g, dtype=torch.int32)
            got = gather.gather_rows_sum(table, idx)
            want = gather.gather_rows_sum_plain(table, idx)
            torch.cuda.synchronize()
            _exact(f"gather_rows_sum {dtype} F={F}", got, want)
            times = time_kernel(
                lambda: gather.gather_rows_sum(table, idx),
                lambda: gather.gather_rows_sum_plain(table, idx),
                lambda: torch.index_select(table, 0, idx).float().sum(-1))
            nbytes = _n_unique(idx) * F * table.element_size() + T * 4 + T * 4
            res = dict(shape=[M, F, T], dtype=str(dtype).split(".")[1], max_abs_err=0.0,
                       **times, **_bound(nbytes, ops=T * F))
            log(f"gather_rows_sum ({M}, {F}) {res['dtype']}, {T} rows: {json.dumps(res)}")
            out[(res["dtype"], F)] = res
    return out[("int8", 32)]


SLAB_SWEEP = (32, 64, 128)  # take_along_rows: bytes of a table row a slab holds


def check_take_along_rows(dev, M=196_608):
    """Probe 2 at its largest shapes, int8 and f32; at F = 128 the slab
    width swept over SLAB_SWEEP, each exact, timed in turns (there and back).
    Two bytes bounds: bound_ms counts the distinct (row, column)
    elements this run's indices gather, the indices and the output;
    sector_bound_ms counts the distinct 32-byte table sectors they touch
    instead of the elements, as a random element read moves a whole sector.
    Returns the f32 (196608, 128) record."""
    import torch
    from mast3r_slam_tpu_torch.ops import gather
    from mast3r_slam_tpu_torch.utils.timing import device_ms

    g = torch.Generator(device=dev).manual_seed(22)
    out = {}
    for dtype in (torch.int8, torch.float32):
        for F in (32, 128):
            tab = torch.randint(-100, 100, (M, F), device=dev, generator=g).to(dtype)
            idx = torch.randint(0, M, (M, F), device=dev, generator=g, dtype=torch.int32)
            idx64 = idx.long()
            got = gather.take_along_rows(tab, idx)
            want = gather.take_along_rows_plain(tab, idx)
            torch.cuda.synchronize()
            _exact(f"take_along_rows {dtype} F={F}", got, want)
            times = time_kernel(lambda: gather.take_along_rows(tab, idx),
                                lambda: gather.take_along_rows_plain(tab, idx),
                                lambda: torch.gather(tab, 0, idx64))
            eb = tab.element_size()
            flat = idx64 * F + torch.arange(F, device=dev)
            n_elems = _n_unique(flat)
            n_sectors = _n_unique(flat * eb // 32)
            del flat
            nbytes = (n_elems + idx.numel()) * eb + idx.numel() * 4
            sector_bytes = n_sectors * 32 + idx.numel() * (eb + 4)
            res = dict(shape=[M, F], dtype=str(dtype).split(".")[1], max_abs_err=0.0,
                       **times, **_bound(nbytes),
                       sector_bound_ms=sector_bytes / PEAK_BYTES * 1e3)
            if F == 128:
                sweep = {sb: [] for sb in SLAB_SWEEP}
                for sb in SLAB_SWEEP + SLAB_SWEEP[::-1]:
                    run = lambda: gather.take_along_rows_cuda(tab, idx, slab_bytes=sb)
                    _exact(f"take_along_rows {dtype} F={F} slab {sb} B", run(), want)
                    sweep[sb].append(device_ms(run))
                res["slab_sweep_ms"] = sweep
                res["slab_bytes"] = gather.SLAB_BYTES
            log(f"take_along_rows ({M}, {F}) {res['dtype']}: {json.dumps(res)}")
            out[(res["dtype"], F)] = res
            del tab, idx, idx64, got, want
    return out[("float32", 128)]


def check_ivf_hamming(dev, Q=1500, cap=16, num_words=65_536):
    """The bucket scoring at the full-width query (300 features x multiple
    assignment 5) against a 64k-word IVF of depth 16, W = 1 (phase 8's
    8-wide head), 2 (64-wide) and 32 (1024-wide).  Bytes: the distinct
    buckets this run's words gather, the query codes and words, the
    distances.  Returns the W=32 record."""
    import torch
    from mast3r_slam_tpu_torch.ops import gather

    g = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for W in (1, 2, 32):
        lim = 2 ** 31
        bvecs = torch.randint(-lim, lim - 1, (num_words + 1, cap, W), device=dev,
                              generator=g, dtype=torch.int32)
        q = torch.randint(-lim, lim - 1, (Q, W), device=dev, generator=g, dtype=torch.int32)
        qw = torch.randint(0, num_words + 1, (Q,), device=dev, generator=g,
                           dtype=torch.int32)
        got = gather.ivf_hamming(bvecs, q, qw)
        want = gather.ivf_hamming_plain(bvecs, q, qw)
        torch.cuda.synchronize()
        _exact(f"ivf_hamming W={W}", got, want)
        names = kernel_names(lambda: gather.ivf_hamming(bvecs, q, qw))
        if len(names) != 1:
            raise AssertionError(f"ivf_hamming W={W}: kernels a call {names} (one expected)")
        times = time_kernel(lambda: gather.ivf_hamming(bvecs, q, qw),
                            lambda: gather.ivf_hamming_plain(bvecs, q, qw))
        nbytes = _n_unique(qw) * cap * W * 4 + Q * W * 4 + Q * 4 + Q * cap * 4
        res = dict(shape=[Q, cap, W], max_abs_err=0.0, **times, **_bound(nbytes, ops=3.0 * Q * cap * W))
        log(f"ivf_hamming Q={Q} cap={cap} W={W}: {json.dumps(res)}")
        out[W] = res
        del bvecs
    return out[32]


def read_design(dev, ehg, grs, ivf) -> dict:
    """What the card's build shows of the edge-block, IVF and two gather
    kernels: ptxas registers and spills, the SASS of the edge blocks' pixel loop
    (its pixels counted by their two rsqrt each), and the device time of a
    one-element fill, the floor of any kernel's device time, beside the
    three short kernels."""
    import torch
    from mast3r_slam_tpu_torch.utils.timing import device_ms

    out = {"ptxas": {lib: ptxas_report(lib) for lib in ("edge_hg_rays", "ivf_hamming",
                                                        "gather_rows", "take_along_rows")}}
    loop = sass_loop("edge_hg_rays", "edge_hg_rays_kernel")
    loop["pixels_a_loop"] = loop["MUFU_RSQ"] // 2  # two rsqrt a pixel-edge
    loop["instructions_a_pixel_edge"] = loop["loop_instructions"] / max(1, loop["pixels_a_loop"])
    out["edge_hg_sass_loop"] = loop
    one = torch.empty(1, device=dev)
    out["kernel_floor_ms"] = device_ms(lambda: one.fill_(1.0))
    from mast3r_slam_tpu_torch.ops import gather

    M = 196_608
    slots = lambda nw, rb: gather._slots_of(dev, "gather_rows_sum_slots", 1, nw, rb)
    out["plans"] = {
        "take_along_rows f32 (196608, 128)": gather.take_plan(
            M, M, 128, 4, gather._slots_of(dev, "take_along_rows_slots", 4))._asdict(),
        "take_along_rows int8 (196608, 128)": gather.take_plan(
            M, M, 128, 1, gather._slots_of(dev, "take_along_rows_slots", 1))._asdict(),
        "gather_rows_sum int8 (196608, 32), 196608 rows": gather.sum_plan(M, 8, slots)._asdict(),
        "gather_rows_sum f32 (196608, 32), 196608 rows": gather.sum_plan(
            M, 32, lambda nw, rb: gather._slots_of(dev, "gather_rows_sum_slots", 0, nw, rb)
        )._asdict()}
    log(f"gather launch plans: {json.dumps(out['plans'])}")
    log(f"ptxas: {json.dumps(out['ptxas'])}")
    log(f"edge_hg_rays SASS pixel loop: {json.dumps(loop)}")
    log(f"kernel floor (one-element fill_, device time) {out['kernel_floor_ms']:.6f} ms; "
        f"ivf_hamming {ivf['ms']:.6f}, gather_rows_sum {grs['ms']:.6f}, edge_hg_rays "
        f"{ehg['ms']:.6f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 3: a small model, kernels on the card against plain on the CPU
# ---------------------------------------------------------------------------

SMALL_BF16 = dict(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                  dec_depth=12, dec_num_heads=2, feature_dim=64,
                  layer_dims=(32, 64, 96, 128))


def check_small_model(dev):
    import torch
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.interface import MASt3RModel

    cfg = M.ModelConfig(**SMALL_BF16, dtype=torch.bfloat16)
    hw = (64, 96)
    params = M.init_params(cfg, seed=1, device="cpu")
    gpu = MASt3RModel(params, cfg, hw, device=dev)
    cpu = MASt3RModel(params, cfg, hw, device="cpu")
    img = torch.rand(2, 3, *hw, generator=torch.Generator().manual_seed(2)) * 2 - 1

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()

    fg, pg = gpu.encode(img)
    fc, pc = cpu.encode(img)
    out_g = gpu.asymmetric(fg[:1], pg[:1], fg[1:], pg[1:])
    out_c = cpu.asymmetric(fc[:1], pc[:1], fc[1:], pc[1:])
    errs = {"feat": rel(fg, fc)}
    for v, (og, oc) in enumerate(zip(out_g, out_c)):
        for name, a, b in zip("XCDQ", og, oc):
            errs[f"{name}{v}"] = rel(a, b)
    bad = {k: e for k, e in errs.items() if not e <= SMALL_MODEL_RTOL}
    if bad:
        raise AssertionError(f"small model, card vs CPU: relative L2 errors {bad}")
    log("small bf16 model, card (kernels) vs CPU (plain), relative L2: "
        + json.dumps({k: round(e, 5) for k, e in errs.items()}))


# ---------------------------------------------------------------------------
# phase 4: ViT-L main path
# ---------------------------------------------------------------------------

def smooth_images(n, hw, dev, seed):
    """Seeded smooth random images in [-1, 1], (n, 3, H, W)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    low = torch.rand(n, 3, hw[0] // 16, hw[1] // 16, device=dev, generator=g)
    img = F.interpolate(low, size=hw, mode="bilinear", align_corners=False)
    return img * 2 - 1


def profile(label, fn, top=25):
    """torch.profiler over one call of ``fn``: the kernels with the most
    device time, the launch count, and the device's busy time against the
    wall time (which the profiler itself lengthens)."""
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        per_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        per_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in per_name.values())
    n_copy = sum(n for name, (_, n) in per_name.items() if "copy" in name.lower())
    log(f"profile of {label}: wall {wall_ms:.3f} ms (profiler on), "
        f"{len(kernels)} kernel launches ({n_copy} of them copy kernels), device busy "
        f"{busy_ms:.3f} ms = {busy_ms / wall_ms:.3f} of wall")
    for name, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:9.3f} ms  x{n:5d}  {name[:110]}")


def profile_frame(model, tracker, img, T, label="one tracked frame"):
    """The profile of one tracked frame (encode + track)."""
    from mast3r_slam_tpu_torch.slam.frame import Frame

    def frame():
        feat, pos = model.encode(img)
        tracker.track(Frame(frame_id=1, img=img[0], T_WC=T, feat=feat, pos=pos))

    profile(label, frame)


def run_vitl(dev, hw=(384, 512), n_tracked=N_TRACKED, mcfg=None):
    """encode + mono (INIT keyframe), then FrameTracker.track on n_tracked
    frames, then one frame timed by stage and one profiled.  Returns (launch
    counts of the tracked frames, ms per frame, the model)."""
    import torch
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.interface import MASt3RModel
    from mast3r_slam_tpu_torch.ops import attention, refine
    from mast3r_slam_tpu_torch.slam.frame import Frame, Keyframes
    from mast3r_slam_tpu_torch.slam.tracker import FrameTracker
    from mast3r_slam_tpu_torch.lie import sim3

    mcfg = mcfg or M.VIT_LARGE
    t0 = time.perf_counter()
    model = MASt3RModel.random_init(0, hw, mcfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"ViT-L random init on the card: {time.perf_counter() - t0:.2f} s")
    cfg = load_config("base")
    kf = Keyframes(8, hw[0] * hw[1], model.num_patches, model.feat_dim, device=dev)
    tracker = FrameTracker(model, cfg, kf, hw, device=dev)
    imgs = smooth_images(n_tracked + 1, hw, dev, seed=3)

    feat, pos = model.encode(imgs[:1])
    X, C = model.mono(feat, pos)
    if not (torch.isfinite(feat).all() and torch.isfinite(X).all() and torch.isfinite(C).all()):
        raise AssertionError("ViT-L encode/mono: non-finite output")
    if tuple(X.shape) != (1, *hw, 3) or tuple(feat.shape) != (1, model.num_patches, mcfg.enc_embed_dim):
        raise AssertionError(f"ViT-L shapes: X {tuple(X.shape)}, feat {tuple(feat.shape)}")
    f0 = Frame(frame_id=0, img=imgs[0], T_WC=sim3.identity(device=dev), feat=feat, pos=pos)
    f0.update_pointmap(X.reshape(-1, 3), C.reshape(-1, 1))
    kf.append(f0)

    attention.counter.reset()
    refine.counter.reset()
    times, decisions = [], []
    T = f0.T_WC
    for i in range(1, n_tracked + 1):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        feat, pos = model.encode(imgs[i:i + 1])
        fr = Frame(frame_id=i, img=imgs[i], T_WC=T, feat=feat, pos=pos)
        new_kf, try_reloc = tracker.track(fr)  # ends in the stats read
        times.append((time.perf_counter() - t0) * 1e3)
        decisions.append((bool(new_kf), bool(try_reloc)))
        stats = tracker.last_stats
        if not np.isfinite(np.delete(stats, 6)).all():  # [6]: score, -inf unless best_score
            raise AssertionError(f"ViT-L frame {i}: non-finite stats {stats}")
    counts = {"attention": attention.counter.count, "refine_window": refine.counter.count}
    log(f"ViT-L tracked frames: ms {[round(t, 3) for t in times]}, "
        f"(new_kf, try_reloc) {decisions}, last stats {np.round(stats, 5).tolist()}")

    # the stages of one frame timed apart (after the counts were read):
    # median of 3 host-clock timings, each between two synchronisations
    from mast3r_slam_tpu_torch.ops import matching

    def timed(fn, reps=3):
        out, ms = None, []
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(ms)

    (feat, pos), enc_ms = timed(lambda: model.encode(imgs[1:2]))
    preds, dec_ms = timed(lambda: model.asymmetric(feat, pos, kf.feat[0][None],
                                                   kf.pos[0][None]))
    (Xii, _, Dii, _), (Xji, _, Dji, _) = preds
    _, match_ms = timed(lambda: matching.match(Xii, Xji, Dii, Dji, tracker.idx_f2k[None]))
    fr = Frame(frame_id=1, img=imgs[1], T_WC=T, feat=feat, pos=pos)
    _, track_ms = timed(lambda: tracker.track(fr))
    split = dict(encode_ms=enc_ms, decode_heads_ms=dec_ms, match_ms=match_ms,
                 track_ms=track_ms, rest_of_track_ms=track_ms - dec_ms - match_ms)
    log("ViT-L frame split (track = decode+heads + match + GN + fusion + stats): "
        + json.dumps({k: round(v, 3) for k, v in split.items()}))
    if dev.type == "cuda":
        profile_frame(model, tracker, imgs[1:2], T)
    return counts, times, model


# ---------------------------------------------------------------------------
# phase 4b: the speed profile on ViT-L
# ---------------------------------------------------------------------------

def track_chained(tracker, frames, T0):
    """The same frames as SLAM._loop_pipelined tracks them: the decode
    issued ahead (infer), frame i submitted chained on frame i-1's outputs
    (track_submit_chained) before i-1's decision is read (track_finish),
    and re-submitted from the committed state where that decision was a
    new keyframe, a relocalisation or a GN failure.  Returns what
    track_sequential does, and the number of re-submissions."""
    import numpy as _np

    out, pend, last_done, n_resubmit = [], None, None, 0

    def finish(p):
        decision = tracker.track_finish(p)
        out.append((logged_pose(p[0]), _np.array(tracker.last_stats), decision))
        return decision

    for fr in frames:
        spec = tracker.infer(fr)
        if pend is None:
            fr.T_WC = T0
            pend = tracker.track_submit(fr, inference=spec)
            continue
        nxt = tracker.track_submit_chained(fr, spec, pend)
        new_kf, reloc = finish(pend)
        last_done = pend[0]
        if new_kf or reloc:
            n_resubmit += 1
            fr.T_WC = last_done.T_WC
            fr.T_WC_np = None
            nxt = tracker.track_submit(fr, inference=spec)
        pend = nxt
    finish(pend)
    return out, n_resubmit


def logged_pose(frame):
    """The pose SLAM._log records for a frame."""
    T = frame.T_WC_np
    return (frame.T_WC.detach().cpu().numpy() if T is None else T).copy()


def run_vitl_speed(dev, vitl, hw=(384, 512), n_tracked=N_TRACKED):
    """The speed profile at full width: ViT-L with phase 4's random weights
    (seed 0), bf16 trunk and bf16 heads, TF32 off; one INIT keyframe, then
    n_tracked frames through FrameTracker.track with the launch counters
    reset just before and read just after (encode included), then the same
    frames (the same encoder tokens) through the pipelined entry points,
    which must give the same bits; then one one-way backend task
    (add_factors on the non-consecutive pair (0, 2), then solve) with its
    launch counts.  Returns a dict of counts, times and checks."""
    import dataclasses

    import torch
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.models.interface import MASt3RModel
    from mast3r_slam_tpu_torch.slam import factor_graph as fg
    from mast3r_slam_tpu_torch.slam.frame import Frame, Keyframes
    from mast3r_slam_tpu_torch.slam.tracker import FrameTracker

    cfg = load_config("speed")
    mcfg = dataclasses.replace(vitl.mcfg, head_dtype=torch.bfloat16)
    model = MASt3RModel(vitl.params, mcfg, hw, device=dev)
    N = hw[0] * hw[1]
    imgs = smooth_images(n_tracked + 1, hw, dev, seed=3)
    feat0, pos0 = model.encode(imgs[:1])
    X0, C0 = model.mono(feat0, pos0)
    if not (C0.dtype == torch.float32 and torch.isfinite(X0).all()):
        raise AssertionError("ViT-L speed: INIT pointmap not finite f32")
    T0 = sim3.identity(device=dev)

    def store():
        kf = Keyframes(8, N, model.num_patches, model.feat_dim, device=dev)
        f0 = Frame(frame_id=0, img=imgs[0], T_WC=T0, feat=feat0, pos=pos0)
        f0.update_pointmap(X0.reshape(-1, 3), C0.reshape(-1, 1))
        kf.append(f0)
        return kf

    def compare(cfg, label, encode):
        """Sequential against chained on two copies of the INIT store.  With
        ``encode`` the sequential frames are encoded inside the counted
        window (72 attention launches a frame); otherwise phase 4b's tokens
        are reused.  Returns (counts, ms a frame) of both, re-submissions,
        same bits, decisions."""
        kf_seq, kf_chain = store(), store()
        tr_seq = FrameTracker(model, cfg, kf_seq, hw, device=dev)
        tr_chain = FrameTracker(model, cfg, kf_chain, hw, device=dev)
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        seq, last_T = [], T0
        for i in range(1, n_tracked + 1):
            if encode:
                frames.append(model.encode(imgs[i:i + 1]))
            feat, pos = frames[i - 1]
            fr = Frame(frame_id=i, img=imgs[i], T_WC=last_T, feat=feat, pos=pos)
            decision = tr_seq.track(fr)
            seq.append((logged_pose(fr), tr_seq.last_stats.copy(), decision))
            last_T = fr.T_WC
        sync(dev)
        seq_ms = (time.perf_counter() - t0) * 1e3 / n_tracked
        seq_counts = read_counts()
        reset_counts()
        t0 = time.perf_counter()
        chain, n_resubmit = track_chained(
            tr_chain, [Frame(frame_id=i + 1, img=imgs[i + 1], T_WC=T0, feat=f, pos=p)
                       for i, (f, p) in enumerate(frames)], T0)
        sync(dev)
        chain_ms = (time.perf_counter() - t0) * 1e3 / n_tracked
        chain_counts = read_counts()
        same_bits = (len(chain) == len(seq) and all(
            np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]
            for a, b in zip(seq, chain))
            and torch.equal(kf_seq.X[0], kf_chain.X[0])
            and torch.equal(kf_seq.C[0], kf_chain.C[0])
            and torch.equal(tr_seq.idx_f2k, tr_chain.idx_f2k))
        decisions = [tuple(bool(x) for x in d) for _, _, d in seq]
        log(f"ViT-L speed profile (bf16 heads, {label}) {hw[0]}x{hw[1]}: sequential "
            f"launches {seq_counts} ({seq_ms:.3f} ms a frame{', encode included' if encode else ''}); "
            f"chained launches {chain_counts} ({chain_ms:.3f} ms a frame, decode + track; "
            f"{n_resubmit} re-submitted); (new_kf, try_reloc) {decisions}; chained == "
            f"sequential bits {same_bits}; last stats {np.round(seq[-1][1], 5).tolist()}")
        return seq_counts, seq_ms, chain_counts, chain_ms, n_resubmit, same_bits, decisions

    frames = []
    (seq_counts, seq_ms, chain_counts, chain_ms, n_resubmit, same_bits,
     decisions) = compare(cfg, "speed as packaged", encode=True)
    # random weights give no valid match, so every frame above asks to
    # relocalise and each chained submit is discarded; with the decision
    # thresholds opened (every LM start converged, every match valid and
    # confident, no keyframe switch) every frame commits and frames 2.. are
    # tracked on the chained path
    pinned = copy.deepcopy(cfg)
    pinned["matching"].update(convergence_thresh=1e9, dist_thresh=1e9)
    pinned["tracking"].update(C_conf=-1.0, Q_conf=-1.0, min_match_frac=0.0,
                              match_frac_thresh=-1.0)
    p_seq_counts, _, p_chain_counts, _, p_resubmit, p_same, p_decisions = compare(
        pinned, "decisions pinned to commit", encode=False)
    if p_resubmit >= n_tracked - 1:
        raise AssertionError(f"ViT-L speed, decisions pinned: {p_resubmit} of "
                             f"{n_tracked - 1} chained submits re-submitted (decisions "
                             f"{p_decisions}); no frame was tracked on the chained path")
    same_bits = same_bits and p_same
    if dev.type == "cuda":
        profile_frame(model, FrameTracker(model, cfg, store(), hw, device=dev),
                      imgs[1:2], T0, label="one speed tracked frame (bf16 heads)")

    # one one-way backend task: keyframes 0, 1, 2 (frames 1 and 2 by mono)
    kf_seq = store()
    for i in (1, 2):
        feat, pos = frames[i - 1]
        X, C = model.mono(feat, pos)
        f = Frame(frame_id=i, img=imgs[i], T_WC=T0.clone(), feat=feat, pos=pos)
        f.T_WC[0] = 0.05 * i
        f.update_pointmap(X.reshape(-1, 3), C.reshape(-1, 1))
        kf_seq.append(f)
    graph = fg.FactorGraph(model, cfg, kf_seq, hw, edge_capacity=16)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    graph.add_factors([0], [2], cfg["local_opt"]["min_match_frac"])
    graph.solve()
    sync(dev)
    task_ms = (time.perf_counter() - t0) * 1e3
    task_counts = read_counts()
    oneway = bool(graph.n_edges == 1 and not graph.valid_match_i[0].any()
                  and float(graph.Q_jj2ii[0].abs().max()) == 0.0)
    live = graph.n_live_edges
    log(f"ViT-L speed one-way backend task (add_factors([0], [2]) + solve): launches "
        f"{task_counts}, {task_ms:.3f} ms, one-way row {oneway}, live edges {live}, "
        f"forward valid fraction {graph.valid_match_j[0].float().mean().item():.4f}")
    return dict(seq_counts=seq_counts, chain_counts=chain_counts, n_resubmit=n_resubmit,
                same_bits=same_bits, seq_ms=seq_ms, chain_ms=chain_ms,
                pinned_chain_counts=p_chain_counts, task_counts=task_counts,
                pinned_resubmit=p_resubmit, task_ms=task_ms, oneway=oneway,
                decisions=decisions)


# ---------------------------------------------------------------------------
# phase 5: synthetic plane scene, known trajectory
# ---------------------------------------------------------------------------

def quat_to_matrix(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class PlaneSceneModel:
    """Stand-in for MASt3RModel: the encode/asymmetric/symmetric/mono
    protocol over a closed box of planes seen from known camera poses.  Frame k's image is
    a constant gray level that encodes k; encode puts k in feat[0, 0, 0] and
    codes the pose in the other tokens.
    Pointmaps are exact, descriptors a view-invariant random-Fourier field
    of the world point, confidence varies with depth."""

    def __init__(self, hw, gt, device, seed=0, K=None):
        import torch

        self.H, self.W = hw
        self.gt = np.asarray(gt, np.float64)
        self.device = device
        self.feat_dim = 16
        self.num_patches = (self.H // 16) * (self.W // 16)
        f = 0.8 * self.W
        self.K = (np.array([[f, 0, self.W / 2], [0, f, self.H / 2], [0, 0, 1.0]])
                  if K is None else np.asarray(K, np.float64))
        self.planes = [(np.array(n, float), c) for n, c in (
            ((0, 1, 0), 1.0), ((0, 0, 1), 4.0), ((1, 0, 0), 3.0),
            ((-1, 0, 0), 3.0), ((0, -1, 0), 3.0), ((0, 0, -1), 4.0))]
        rng = np.random.default_rng(seed)
        # frequencies grow with the resolution so that neighbouring pixels
        # keep distinct int8 descriptors (about 0.1 rad a pixel at depth 3 m)
        self.Wd = rng.normal(size=(24, 3)) * 2.0 * self.W / 64
        self.bd = rng.uniform(0, 2 * np.pi, size=24)
        # pose-coded tokens (tests/oracle.py): nearby poses give similar
        # tokens, so a retrieval head ranks keyframes by place
        self.Wf = np.random.default_rng(7).normal(size=(self.feat_dim, 8)) * 2.0
        self.phase = np.linspace(0, 2 * np.pi, self.num_patches)[:, None]
        u, v = np.meshgrid(np.arange(self.W), np.arange(self.H))
        rays = np.stack([(u - self.K[0, 2]) / self.K[0, 0], (v - self.K[1, 2]) / self.K[1, 1],
                         np.ones_like(u, float)], -1).reshape(-1, 3)
        self.rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        self._torch = torch

    @staticmethod
    def image_value(fid):
        return (fid + 1) / 255.0 * 2 - 1

    def preprocessed(self, fid):
        img = np.full((3, self.H, self.W), self.image_value(fid), np.float32)
        return dict(img=img)

    def _render(self, fid):
        T = self.gt[fid]
        R, t = quat_to_matrix(T[3:7]), T[:3]
        d_w = self.rays @ R.T
        lam = np.full(len(d_w), np.inf)
        for n, c in self.planes:
            den = d_w @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                li = np.where(np.abs(den) > 1e-9, (c - t @ n) / den, np.inf)
            lam = np.minimum(lam, np.where(li > 0.05, li, np.inf))
        X_cam = self.rays * lam[:, None]
        Xw = X_cam @ R.T * T[7] + t
        D = np.sin(Xw @ self.Wd.T + self.bd)
        D /= np.linalg.norm(D, axis=-1, keepdims=True) + 1e-12
        C = 1.6 + 1.0 / (1.0 + np.linalg.norm(X_cam, axis=-1))
        return X_cam, D, C

    def _t(self, a, shape):
        return self._torch.as_tensor(np.asarray(a, np.float32).reshape(shape),
                                     device=self.device)

    def encode(self, img):
        fid = int(round((float(img.float().mean()) + 1) / 2 * 255)) - 1
        tok = np.sin(self.gt[fid] @ self.Wf.T + self.phase)
        tok[0] = 0.0
        tok[0, 0] = fid  # token 0 carries the frame id to the decoder
        feat = self._t(tok, (1, self.num_patches, self.feat_dim))
        pos = self._torch.zeros(1, self.num_patches, 2, dtype=self._torch.int32,
                                device=self.device)
        return feat, pos

    @staticmethod
    def _fid(feat):
        return int(round(float(feat[0, 0, 0])))

    def asymmetric(self, feat_i, pos_i, feat_j, pos_j):
        fi, fj = self._fid(feat_i), self._fid(feat_j)
        Xi, Di, Ci = self._render(fi)
        Xj, Dj, Cj = self._render(fj)
        Ti, Tj = self.gt[fi], self.gt[fj]
        Ri, Rj = quat_to_matrix(Ti[3:7]), quat_to_matrix(Tj[3:7])
        Xw = Xj @ Rj.T * Tj[7] + Tj[:3]
        Xji = (Xw - Ti[:3]) @ Ri / Ti[7]  # j's points in i's frame
        H, W = self.H, self.W
        Q = np.full((H, W), 2.0)
        res_ii = (self._t(Xi, (1, H, W, 3)), self._t(Ci, (1, H, W)),
                  self._t(Di, (1, H, W, 24)), self._t(Q, (1, H, W)))
        res_ji = (self._t(Xji, (1, H, W, 3)), self._t(Cj, (1, H, W)),
                  self._t(Dj, (1, H, W, 24)), self._t(Q, (1, H, W)))
        return res_ii, res_ji

    def symmetric(self, feat_i, pos_i, feat_j, pos_j):
        """(res_ii, res_ji, res_jj, res_ij) of B pairs, each pair both ways."""
        torch = self._torch
        outs = []
        for b in range(feat_i.shape[0]):
            fi, fj = feat_i[b:b + 1], feat_j[b:b + 1]
            outs.append(self.asymmetric(fi, pos_i, fj, pos_j)
                        + self.asymmetric(fj, pos_j, fi, pos_i))
        return tuple(tuple(torch.cat([o[v][k] for o in outs]) for k in range(4))
                     for v in (0, 1, 2, 3))

    def mono(self, feat, pos):
        X, _, C = self._render(self._fid(feat))
        return self._t(X, (1, self.H, self.W, 3)), self._t(C, (1, self.H, self.W))


class PlaneSceneDataset:
    def __init__(self, model, n):
        self.model = model
        self.n = n
        self.timestamps = [f"{i / 30.0:.6f}" for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.timestamps[i], None

    def preprocessed(self, i):
        return self.model.preprocessed(i)


def arc_trajectory(n, radius=0.5, max_angle=2.0):
    """A sideways arc with a slow yaw: a few pixels of motion per frame at
    384x512, as a hand-held camera at video rate gives."""
    poses = []
    for k in range(n):
        s = k / max(n - 1, 1)
        t = np.array([radius * np.sin(s * max_angle * 2), 0.2 * s, 0.3 * s])
        yaw = -0.4 * max_angle * s
        q = np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)])
        poses.append(np.concatenate([t, q, [1.0]]))
    return np.asarray(poses)


def umeyama_rmse(est, gt):
    """RMSE of est (n, 3) after the best similarity onto gt (n, 3)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    U, S, Vt = np.linalg.svd(g.T @ e / len(est))
    Dm = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Dm[2, 2] = -1
    R = U @ Dm @ Vt
    s = np.trace(np.diag(S) @ Dm) / max((e ** 2).sum() / len(est), 1e-12)
    aligned = (s * (R @ e.T)).T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, -1))))


def launch_counters():
    from mast3r_slam_tpu_torch.ops import attention, edge_hg, gather, refine

    return (attention.counter, refine.counter, edge_hg.counter, gather.sum_counter,
            gather.take_counter, gather.ivf_counter)


def reset_counts():
    for c in launch_counters():
        c.reset()


def read_counts():
    return {c.name: c.count for c in launch_counters()}


def engine_cfg(name, single_thread=True, pipeline=None, edge_buffer=16):
    """A packaged config with the engine mode set (``pipeline`` None keeps
    the config's own)."""
    from mast3r_slam_tpu_torch.config import load_config

    cfg = load_config(name)
    cfg["single_thread"] = single_thread
    cfg["engine"]["edge_buffer"] = edge_buffer
    if pipeline is not None:
        cfg["engine"]["pipeline"] = pipeline
    return cfg


def interval_timer():
    """A StageTimer that also keeps each stage's (name, start, end) on the
    host clock, so that frames can be matched with the backend tasks that
    ran beside them."""
    from mast3r_slam_tpu_torch.utils.timing import StageTimer

    class IntervalTimer(StageTimer):
        def __init__(self):
            super().__init__()
            self.intervals = []

        @contextlib.contextmanager
        def time(self, name):
            t0 = time.perf_counter()
            with super().time(name):
                yield
            self.intervals.append((name, t0, time.perf_counter()))

    return IntervalTimer()


def engine_stats(slam):
    """frame.latency p50/p95 over every frame and over the frames that ran
    while a backend task was in flight (host clock, ms), the pipeline.*
    stages, and the backend's stages."""
    iv = slam.timer.intervals
    tasks = [(t0, t1) for name, t0, t1 in iv if name == "backend.update"]
    frames = [(t0, t1) for name, t0, t1 in iv if name == "frame.latency"]
    during = [(t1 - t0) * 1e3 for t0, t1 in frames
              if any(t0 < b1 and b0 < t1 for b0, b1 in tasks)]

    def pct(x):
        return ({"n": len(x), "p50_ms": float(np.percentile(x, 50)),
                 "p95_ms": float(np.percentile(x, 95))} if x else {"n": 0})

    st = slam.timer.stats()
    return {"frame_latency": pct([(t1 - t0) * 1e3 for t0, t1 in frames]),
            "frame_latency_during_backend": pct(during),
            "stages": {k: {m: v[m] for m in ("p50_ms", "p95_ms", "count")}
                       for k, v in st.items()
                       if k.startswith(("pipeline.", "backend."))}}


def run_synthetic_slam(dev, hw=(384, 512), n_frames=16, cfg=None, label="base"):
    """SLAM.run over the plane scene, its backend included (``cfg``: the
    sequential ``base`` loop unless given).  Returns (ATE, result, launch
    counts, engine stats, slam)."""
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM

    gt = arc_trajectory(n_frames)
    model = PlaneSceneModel(hw, gt, dev)
    slam = SLAM(model, cfg or engine_cfg("base"), hw, keyframe_buffer=16, device=dev)
    slam.timer = interval_timer()
    reset_counts()
    t0 = time.perf_counter()
    res = slam.run(PlaneSceneDataset(model, n_frames), verbose=False)
    wall = time.perf_counter() - t0
    counts = read_counts()
    slam.close()
    if slam.backend_errors:
        raise AssertionError(f"synthetic SLAM.run ({label}): backend tasks failed: "
                             f"{slam.backend_errors!r}")
    ate = umeyama_rmse(res.frame_poses[:, :3].astype(np.float64), gt[:, :3])
    stats = engine_stats(slam)
    log(f"synthetic SLAM.run ({label}: single_thread {slam.single_thread}, pipeline "
        f"{slam.pipeline}) {hw[0]}x{hw[1]}, {n_frames} frames: {wall:.2f} s, "
        f"{res.n_keyframes} keyframes, {slam.graph.n_edges} edges, {res.n_reloc} "
        f"reloc, frame ATE {ate:.6f} m, launches {counts}; engine stats (host clock, "
        f"ms) {json.dumps(stats)}")
    return ate, res, counts, stats, slam


# ---------------------------------------------------------------------------
# phase 6: the backend at full width
# ---------------------------------------------------------------------------

def calib_problem(dev, hw, n_kf, seed):
    """The calib-mode solve's scene (tests/test_sharded_ba.py _calib_problem
    at full width): every keyframe at one pose with one pointmap on the
    pixel grid (depth 2-2.5 m), so identity correspondences and pixel
    targets are exact; the poses after the first perturbed.  Returns (K,
    ground truth, noisy poses, Xs, Cs)."""
    import torch
    from mast3r_slam_tpu_torch.lie import sim3

    rng = np.random.default_rng(seed)
    H, W = hw
    N = H * W
    f = 0.9 * W
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=torch.float32, device=dev)
    lin = np.arange(N)
    z = 2.0 + 0.5 * rng.random(N)
    X = np.stack([(lin % W - W / 2) / f * z, (lin // W - H / 2) / f * z, z], -1)
    Xs = torch.as_tensor(X, dtype=torch.float32, device=dev).expand(n_kf, N, 3).contiguous()
    gt = sim3.identity(device=dev).expand(n_kf, 8).contiguous()
    tau = torch.as_tensor(rng.normal(size=(n_kf, 7)) * 0.01, dtype=torch.float32, device=dev)
    tau[0] = 0
    return K, gt, sim3.retr(gt, tau), Xs, torch.full((n_kf, N, 1), 2.0, device=dev)


def run_synthetic_solve(dev, hw=(384, 512), n_kf=16, seed=5):
    """The global GN on 16 keyframes, a chain plus loop edges (32 two-way
    edges), identity correspondences, the poses after the first perturbed.
    Rays (one world cloud seen from an arc): through gauss_newton_poses,
    then through gauss_newton_poses_cached (the entry FactorGraph.solve
    takes for up to 256 edges) with the dense solver and with PCG; calib
    (calib_problem) through the cached entry.  Each with the launch counters
    reset just before and read just after, then run again from the same
    inputs and its poses compared bit for bit (the normal equations are
    assembled by scatter-adds).  Returns {entry: dict(err, iters, launches
    of the edge-block kernel, ms, same_bits)}."""
    import torch
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.ops.global_gn import (
        GlobalGNSettings, gauss_newton_poses, gauss_newton_poses_cached)

    rng = np.random.default_rng(seed)
    N = hw[0] * hw[1]
    gt = torch.as_tensor(arc_trajectory(n_kf, radius=0.4, max_angle=1.2),
                         dtype=torch.float32, device=dev)
    world = torch.as_tensor(rng.uniform(-1, 1, size=(N, 3)) + [0, 0, 3],
                            dtype=torch.float32, device=dev)
    Xs = sim3.act(sim3.inv(gt)[:, None, :], world)  # (n_kf, N, 3)
    Cs = torch.full((n_kf, N, 1), 2.0, device=dev)
    one_way = [(i, i + 1) for i in range(n_kf - 1)] + [(0, n_kf - 1)]
    ii = torch.tensor([a for a, b in one_way] + [b for a, b in one_way], device=dev)
    jj = torch.tensor([b for a, b in one_way] + [a for a, b in one_way], device=dev)
    E, half = len(ii), len(one_way)
    idx = torch.arange(N, dtype=torch.int32, device=dev).expand(E, N)
    valid = torch.ones((E, N, 1), dtype=torch.bool, device=dev)
    Q = torch.full((E, N, 1), 2.0, device=dev)
    tau = torch.as_tensor(rng.normal(size=(n_kf, 7)) * 0.01, dtype=torch.float32, device=dev)
    tau[0] = 0
    noisy = sim3.retr(gt, tau)
    K = torch.eye(3, device=dev)
    # the cache's rows [X | C_raw] of each edge's i-points at its matches
    # (identity here), forward half then backward half; one fusion a keyframe
    gath = torch.cat([Xs, Cs], dim=-1)[ii]
    n_fused = torch.ones(n_kf, device=dev)
    Kc, gt_c, noisy_c, Xs_c, Cs_c = calib_problem(dev, hw, n_kf, seed)
    gath_c = torch.cat([Xs_c, Cs_c], dim=-1)[ii]

    def cached(settings, mode="rays"):
        if mode == "calib":
            return lambda: gauss_newton_poses_cached(
                noisy_c, Xs_c, Cs_c, n_fused, ii, jj, gath_c[:half], gath_c[half:], idx,
                valid, Q, Kc, hw, settings, "calib")
        return lambda: gauss_newton_poses_cached(
            noisy, Xs, Cs, n_fused, ii, jj, gath[:half], gath[half:], idx, valid, Q, K,
            hw, settings, "rays")

    # entry: (solve, ground truth, edge-block launches an iteration)
    entries = {
        "gather": (lambda: gauss_newton_poses(
            noisy, Xs, Cs, ii, jj, idx, valid, Q, K, hw, GlobalGNSettings(), "rays"), gt, 1),
        "cached": (cached(GlobalGNSettings()), gt, 1),
        "cached_pcg": (cached(GlobalGNSettings(solver="pcg")), gt, 1),
        "cached_calib": (cached(GlobalGNSettings(), "calib"), gt_c, 0),
    }
    out = {}
    for name, (solve, truth, per_iter) in entries.items():
        err0 = (noisy[:, :3] - gt[:, :3]) if truth is gt else (noisy_c[:, :3] - gt_c[:, :3])
        err0 = err0.norm(dim=-1).max().item()
        reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        T, iters, ok, diverged = solve()
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        err = (T[:, :3] - truth[:, :3]).norm(dim=-1).max().item()
        T2 = solve()[0]
        same_bits = torch.equal(T, T2)
        log(f"full-width solve, {name} entry ({n_kf} keyframes, {E} edges x {N} px): "
            f"{iters} GN iterations, ok {ok}, diverged {diverged}, {ms:.3f} ms (host "
            f"clock); max translation error {err0:.6f} -> {err:.8f} m; launches {counts}; "
            f"the same pose bits on a second run {same_bits}")
        if not (ok and err <= SOLVE_BOUND_M and iters >= 1
                and counts["edge_hg_rays"] == per_iter * iters):
            raise AssertionError(f"full-width solve, {name} entry: error {err} m (bound "
                                 f"{SOLVE_BOUND_M}), ok {ok}, {iters} iterations, "
                                 f"launches {counts}")
        out[name] = dict(err=err, iters=iters, launches=counts["edge_hg_rays"], ms=ms,
                         same_bits=same_bits)
    if dev.type == "cuda":
        profile("the full-width solve, cached entry", entries["cached"][0], top=15)
    return out


def run_vitl_backend(dev, model, hw=(384, 512)):
    """One backend task with the ViT-L model: three keyframes, the
    consecutive edge (1, 2) through FactorGraph.add_factors, then
    FactorGraph.solve.  The launch counters are reset just before and read
    just after.  Then the task's three stages timed apart (host clock
    between synchronisations, median of 3)."""
    import torch
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.ops import matching
    from mast3r_slam_tpu_torch.slam import factor_graph as fg
    from mast3r_slam_tpu_torch.slam.frame import Frame, Keyframes

    cfg = load_config("base")
    N = hw[0] * hw[1]
    kf = Keyframes(4, N, model.num_patches, model.feat_dim, device=dev)
    imgs = smooth_images(3, hw, dev, seed=9)
    for k in range(3):
        feat, pos = model.encode(imgs[k:k + 1])
        X, C = model.mono(feat, pos)
        T = sim3.identity(device=dev)
        T[0] = 0.05 * k
        f = Frame(frame_id=k, img=imgs[k], T_WC=T, feat=feat, pos=pos)
        f.update_pointmap(X.reshape(-1, 3), C.reshape(-1, 1))
        kf.append(f)
    graph = fg.FactorGraph(model, cfg, kf, hw, edge_capacity=16)
    frac = cfg["local_opt"]["min_match_frac"]
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    added = graph.add_factors([1], [2], frac)
    graph.solve()
    sync(dev)
    task_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    T_WC = kf.T_WC[:3]
    if not (added and graph.n_edges == 1 and torch.isfinite(T_WC).all()):
        raise AssertionError(f"ViT-L backend task: added {added}, {graph.n_edges} "
                             f"edges, poses {T_WC.tolist()}")
    valid_frac = graph.valid_match_j[0].float().mean().item()

    def timed(fn, reps=3):
        out, ms = None, []
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            out = fn()
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(ms)

    ii_t = torch.tensor([1], device=dev)
    jj_t = torch.tensor([2], device=dev)
    res, dec_ms = timed(lambda: model.symmetric(kf.feat[ii_t], kf.pos[ii_t],
                                                kf.feat[jj_t], kf.pos[jj_t]))
    _, match_ms = timed(lambda: fg._add_factors_compute(
        hw, res, float(cfg["local_opt"]["Q_conf"]), fg.match_kwargs(cfg)))
    _, solve_ms = timed(graph.solve)
    split = dict(task_ms=task_ms, symmetric_decode_ms=dec_ms, match_ms=match_ms,
                 solve_ms=solve_ms)
    log(f"ViT-L backend task {hw[0]}x{hw[1]} (add_factors([1],[2]) + solve): launches "
        f"{counts}; valid match fraction {valid_frac:.4f}; split "
        + json.dumps({k: round(v, 3) for k, v in split.items()}))
    want_fixed = {"attention": 48, "refine_window": 1}
    if ({k: counts[k] for k in want_fixed} != want_fixed
            or counts["edge_hg_rays"] < 1):
        raise AssertionError(f"ViT-L backend task launches {counts}, expected "
                             f"{want_fixed} and at least one edge_hg_rays")
    return counts, split


# ---------------------------------------------------------------------------
# phase 7: retrieval at full width
# ---------------------------------------------------------------------------

class _Tokens:
    """The one attribute of a frame that retrieval reads."""

    def __init__(self, feat):
        self.feat = feat


def query_hamming_exact(db, feat) -> bool:
    """ivf_hamming against its plain version on the tensors a query of
    ``feat`` gives it in ``db``: the bucket codes, the query's packed codes
    and its words, invalid ones routed to the trash bucket."""
    import torch
    from mast3r_slam_tpu_torch.ops import gather

    feats, codes = db._extract_quantize(feat)
    packed, words, valid = db._codes(feats, codes, db.s.ma_query)
    bvecs = db.ivf.bvecs
    qw = torch.where(valid, words, bvecs.shape[0] - 1).to(torch.int32)
    got = gather.ivf_hamming(bvecs, packed, qw)
    return torch.equal(got, gather.ivf_hamming_plain(bvecs, packed, qw))


def run_retrieval(dev, model, hw=(384, 512), n_db=512, n_real=4, n_timed=3,
                  hdims=(1024,), nfeat=300, num_words=65_536):
    """The database at the JAX package's default head (hdims (1024,), 300
    features) with a seeded 64k-word codebook, multiple assignment 5 on query
    and 1 on build, over ViT-L encoder tokens (1, 768, 1024).  It is filled to
    n_db keyframes: n_real by ``update`` from real frames, the rest from
    seeded codes (scripts/microbench_ivf.py's fill).  Then ``update`` and
    ``query`` of further frames are timed (host clock between
    synchronisations), each with the launch counters reset just before and
    read just after; ivf_hamming is held exactly against its plain version
    on a query's own tensors, and the kernel route's scores against the
    plain route's; and ``update`` runs twice on one state.  Returns a dict
    of readings."""
    import copy

    import torch
    from mast3r_slam_tpu_torch.ops import gather
    from mast3r_slam_tpu_torch.retrieval import (ASMKSettings, RetrievalDatabase,
                                                 RetrievalHeadSettings, asmk)
    from mast3r_slam_tpu_torch.retrieval.head import init_head_params
    from mast3r_slam_tpu_torch.utils import numerics

    g = torch.Generator(device=dev).manual_seed(31)
    D = model.feat_dim
    params = init_head_params(g, D, hdims=hdims)
    centroids = torch.randn((num_words, hdims[-1]), device=dev, generator=g)
    db = RetrievalDatabase(params, centroids, RetrievalHeadSettings(nfeat=nfeat),
                           ASMKSettings(max_images=n_db), device=dev)
    imgs = smooth_images(n_real + 2 * n_timed, hw, dev, seed=33)
    tokens = [model.encode(imgs[i:i + 1])[0] for i in range(len(imgs))]
    if tuple(tokens[0].shape) != (1, model.num_patches, D):
        raise AssertionError(f"retrieval: tokens of shape {tuple(tokens[0].shape)}")
    for k in range(n_real):
        db.update(_Tokens(tokens[k]), True, k=3, min_thresh=0.005, kf_index=k)
    W = db.ivf.words
    t0 = time.perf_counter()
    for k in range(n_real, n_db):  # seeded codes, as scripts/microbench_ivf.py
        packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (nfeat, W), device=dev, generator=g,
                               dtype=torch.int32)
        words = torch.randint(0, num_words, (nfeat,), device=dev, generator=g)
        db.ivf.add(packed, words, torch.ones(nfeat, dtype=torch.bool, device=dev), imid=k)
    db.kf_counter = n_db
    sync(dev)
    fill_s = time.perf_counter() - t0

    def timed(fn):
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, (time.perf_counter() - t0) * 1e3, read_counts()

    upd_ms, qry_ms, launches = [], [], []
    for i in range(n_timed):
        fr = _Tokens(tokens[n_real + i])
        inds, ms, c = timed(lambda: db.query(fr, 3, 0.005))
        qry_ms.append(ms)
        launches.append(("query", c))
        inds, ms, c = timed(lambda: db.update(fr, True, k=3, min_thresh=0.005,
                                              kf_index=n_db + i))
        upd_ms.append(ms)
        launches.append(("update", c))

    if dev.type == "cuda":
        fr = _Tokens(tokens[n_real])
        profile("one full-width retrieval query", lambda: db.query(fr, 3, 0.005), top=12)

    # the kernel route against the plain route on the same card tensors
    fr = _Tokens(tokens[n_real + n_timed])
    hamming_exact = query_hamming_exact(db, fr.feat)
    feats, codes = db._extract_quantize(fr.feat)
    packed, words, valid = db._codes(feats, codes, db.s.ma_query)
    ivf = db.ivf
    args = (ivf.bvecs, ivf.bimids, ivf.norm_factor, packed, words, valid, ivf.dim,
            ivf.s.alpha, ivf.s.similarity_threshold, ivf.s.max_images)
    kern = asmk.ivf_search_bucketed(*args)[: ivf.n_images].cpu().numpy()
    plain = asmk.ivf_search_bucketed(*args, hamming=gather.ivf_hamming_plain)
    plain = plain[: ivf.n_images].cpu().numpy()
    rel = float(np.max(np.abs(kern - plain) / np.maximum(np.abs(plain), 1e-30)))
    same_topk = bool(np.array_equal(np.argsort(-kern)[:3], np.argsort(-plain)[:3]))

    # the same query three times: the same candidates and score bits (the
    # scores are summed by a scatter-add)
    queries = [db.query(fr, 3, 0.005, with_scores=True) for _ in range(3)]
    scores_same_bits = all(q[0] == queries[0][0] and q[2].tobytes() == queries[0][2].tobytes()
                           for q in queries[1:])
    # the scatter-add alone on this query's image slots (seeded values):
    # index_add_ (atomic order) against the fixed-order sum, 20 repeats each
    slots = ivf.bimids[torch.where(valid, words, ivf.bvecs.shape[0] - 1).long()]
    slots = slots.clamp_min(0).long().reshape(-1)
    vals = torch.rand(slots.shape, device=dev, generator=g)

    def repeats(add):
        ref = add(torch.zeros(ivf.s.max_images, device=dev), slots, vals)
        return sum(torch.equal(ref, add(torch.zeros_like(ref), slots, vals))
                   for _ in range(20))

    scatter_repeats = dict(index_add_=repeats(lambda d, i, v: d.index_add_(0, i, v)),
                           index_add_fixed=repeats(numerics.index_add_fixed))

    # update twice on one state: the same candidates and the same stored codes
    state = (copy.deepcopy(db.ivf), db.kf_counter)
    runs = []
    for _ in range(2):
        db.ivf, db.kf_counter = copy.deepcopy(state[0]), state[1]
        inds = db.update(fr, True, k=3, min_thresh=0.005, kf_index=ivf.n_images)
        runs.append((inds, db.ivf.bvecs.clone(), db.ivf.bimids.clone()))
    repeat_same = (runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
                   and torch.equal(runs[0][2], runs[1][2]))
    out = dict(n_images=ivf.n_images, n_entries=ivf.n_entries, bucket_cap=db.ivf.bucket_cap,
               fill_s=fill_s, update_ms=upd_ms, query_ms=qry_ms, launches=launches,
               hamming_exact=hamming_exact, kernel_vs_plain_rel=rel, same_topk=same_topk,
               repeat_same=repeat_same, scores_same_bits=scores_same_bits,
               scatter_repeats_of_20=scatter_repeats,
               candidates=runs[0][0], scores_max=float(kern.max()))
    log(f"retrieval at full width (head {D}->{hdims}, {nfeat} features, {num_words} "
        f"words, {ivf.n_images} images): {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 8: relocalisation on the synthetic scene
# ---------------------------------------------------------------------------

def teleport_trajectory(n_track=24, n_after=6, max_angle=3.5):
    """An arc that turns 1.4 rad, more than the camera's 1.1 rad field of
    view, then the camera back near its start (2 cm aside): tracking breaks
    and retrieval must find the early keyframes."""
    arc = arc_trajectory(n_track, max_angle=max_angle)
    back = arc[1:n_after + 1].copy()
    back[:, 0] += 0.02
    return np.concatenate([arc, back])


def run_synthetic_reloc(dev, hw=(384, 512), n_track=24, n_after=6, cfg=None,
                        label="base"):
    """SLAM.run with a small retrieval head (tests/test_reloc_e2e.py's
    sizing: hdims (8,), 8 features, 64 words) and reloc.strict False over
    the teleport trajectory (``cfg``: the sequential ``base`` loop unless
    given), the launch counters reset just before and read just after.
    Returns (result, slam, gt, launch counts, add_factors calls, whether
    ivf_hamming equalled its plain version on the run's database)."""
    import torch
    from mast3r_slam_tpu_torch.retrieval import (ASMKSettings, RetrievalDatabase,
                                                 RetrievalHeadSettings)
    from mast3r_slam_tpu_torch.retrieval.head import init_head_params
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM

    gt = teleport_trajectory(n_track, n_after)
    model = PlaneSceneModel(hw, gt, dev)
    g = torch.Generator().manual_seed(41)
    params = init_head_params(g, model.feat_dim, hdims=(8,), device=dev)
    centroids = torch.randn((64, 8), generator=g) * 0.3
    db = RetrievalDatabase(params, centroids, RetrievalHeadSettings(nfeat=8),
                           ASMKSettings(max_images=64), device=dev)
    cfg = cfg or engine_cfg("base", edge_buffer=64)
    cfg["reloc"]["strict"] = False
    slam = SLAM(model, cfg, hw, keyframe_buffer=32, retrieval=db, device=dev)
    slam.timer = interval_timer()
    calls = []
    add_factors = slam.graph.add_factors

    def counted(*a, **kw):  # one refine launch per call (one matching pass)
        calls.append(kw.get("is_reloc", False))
        return add_factors(*a, **kw)

    slam.graph.add_factors = counted
    reset_counts()
    t0 = time.perf_counter()
    res = slam.run(PlaneSceneDataset(model, len(gt)), verbose=False)
    wall = time.perf_counter() - t0
    counts = read_counts()
    slam.close()
    if slam.backend_errors:
        raise AssertionError(f"synthetic reloc ({label}): backend tasks failed: "
                             f"{slam.backend_errors!r}")
    n = len(gt)
    # ivf_hamming (W = 1 here) on a query of the last frame against the
    # database the run built, after the counts were read
    last = torch.as_tensor(model.preprocessed(n - 1)["img"], device=dev)[None]
    hamming_exact = query_hamming_exact(db, model.encode(last)[0])
    err = np.linalg.norm(res.frame_poses[-3:, :3] - gt[-3:, :3], axis=-1)
    E = slam.graph.n_edges
    log(f"synthetic reloc ({label}: single_thread {slam.single_thread}, pipeline "
        f"{slam.pipeline}) {hw[0]}x{hw[1]}, {n} frames (teleport after {n_track}): "
        f"{wall:.2f} s, {res.n_reloc} reloc, {res.n_reloc_success} succeeded, "
        f"{res.n_keyframes} keyframes, edges {list(zip(slam.graph.ii[:E].tolist(), slam.graph.jj[:E].tolist()))}, "
        f"post-reloc error {err.round(5).tolist()} m, mode {slam.mode.name}, launches "
        f"{counts}, add_factors calls {len(calls)} ({sum(calls)} reloc), ivf_hamming "
        f"W={db.ivf.words} exact {hamming_exact}; stages (host clock, ms) "
        f"{json.dumps(slam.timer.stats())}; engine stats {json.dumps(engine_stats(slam))}")
    return res, slam, gt, counts, calls, hamming_exact


# ---------------------------------------------------------------------------
# phase 9: the command-line entry point on a recorded sequence
# ---------------------------------------------------------------------------

TUM_SEQ = "rgbd_dataset_freiburg1_synth"  # "freiburg1": the TUM loader's fr1 calibration
CLI_RAW_FRAMES = 24        # 480x640 PNGs; the eval configs' subsample 2 runs 12
CLI_VITL_FRAMES = 8        # --max-frames of the ViT-L runs
# the ViT-L runs pin the tracker's decisions open (random weights match
# nothing): every match valid and confident, no relocalisation, and every
# tracked frame a new keyframe, so that each frame runs a backend task
CLI_VITL_SET = ["matching.convergence_thresh=1.0e+9", "matching.dist_thresh=1.0e+9",
                "tracking.C_conf=-1.0", "tracking.Q_conf=-1.0",
                "tracking.min_match_frac=0.0", "tracking.match_frac_thresh=2.0"]


@contextlib.contextmanager
def swapped(obj, name, value):
    """``obj.name`` set to ``value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class TumSceneModel(PlaneSceneModel):
    """Phase 5's stand-in behind the CLI: it renders with the camera the
    (undistorted, resized) frames have, and reads the frame id from the
    image's central half, where the undistortion leaves no black border."""

    def encode(self, img):
        h, w = img.shape[-2:]
        return super().encode(img[..., h // 4:h - h // 4, w // 4:w - w // 4])


def write_tum_sequence(root, gt, n):
    """A TUM-RGBD folder: rgb/<t>.png (480x640, frame k a constant gray level
    k + 1, through the port's PNG writer), rgb.txt and groundtruth.txt (its
    stamps 4 ms after the frames', as a separate stream would be)."""
    from mast3r_slam_tpu_torch.data.png import write_png

    seq = root / TUM_SEQ
    (seq / "rgb").mkdir(parents=True, exist_ok=True)
    rgb = ["# color images", "# timestamp filename"]
    gtl = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for i in range(n):
        t = 1305031102.0 + i / 30.0
        write_png(seq / f"rgb/{t:.6f}.png", np.full((480, 640, 3), i + 1, np.uint8))
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        gtl.append(f"{t + 0.004:.6f} " + " ".join(f"{x:.6f}" for x in gt[i, :7]))
    (seq / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (seq / "groundtruth.txt").write_text("\n".join(gtl) + "\n")
    return seq


def standin_builder(gt, dev, built):
    """A ``run.build_slam`` that builds the engine around the stand-in model
    (its camera the dataset's K_frame when calibrated) and keeps it in
    ``built``."""
    from mast3r_slam_tpu_torch.slam import run

    real = run.build_slam

    def build(cfg, dataset, **kw):
        (h, w), _ = dataset.get_img_shape()
        K = dataset.camera_intrinsics.K_frame if dataset.has_calib() else None
        kw["model"] = TumSceneModel((h, w), gt, dev, K=K)
        slam = real(cfg, dataset, **kw)
        built.append(slam)
        return slam

    return build


def run_cli(argv):
    """``run.main(argv)`` with the launch counters reset just before and read
    just after: (result, counts, host seconds)."""
    from mast3r_slam_tpu_torch.slam import run

    reset_counts()
    t0 = time.perf_counter()
    res = run.main(argv)
    return res, read_counts(), time.perf_counter() - t0


def run_cli_standin(dev, root, img_size=512, n_raw=CLI_RAW_FRAMES):
    """The CLI over the synthetic TUM sequence with the stand-in model,
    under eval_no_calib and eval_calib, each scored by the ATE CLI; then a
    checkpoint halfway through a run, loaded into a fresh engine that
    finishes the sequence.  Returns a dict of ATEs, counts and checks."""
    import torch
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.data import dataloader
    from mast3r_slam_tpu_torch.eval import ate
    from mast3r_slam_tpu_torch.slam import run
    from mast3r_slam_tpu_torch.slam.checkpoint import load_state, save_state

    gt = arc_trajectory(n_raw, radius=0.8, max_angle=3.0)
    seq = write_tum_sequence(root, gt, n_raw)
    out = {}
    built = []
    with swapped(run, "build_slam", standin_builder(gt, dev, built)), \
            swapped(dataloader.MonocularDataset, "img_size", img_size):
        for config in ("eval_no_calib", "eval_calib"):
            res, counts, wall = run_cli(["--dataset", str(seq), "--config", config,
                                         "--save-as", config, "--device", str(dev)])
            slam = built[-1]
            est = pathlib.Path("logs") / config / f"{TUM_SEQ}.txt"
            files = sorted(p.name for p in (pathlib.Path("logs") / config).iterdir())
            kfs = sorted((pathlib.Path("logs") / config / "keyframes" / TUM_SEQ).iterdir())
            err = ate.main([str(est), str(seq / "groundtruth.txt")])
            out[config] = dict(ate_m=err, n_frames=len(res.frame_timestamps),
                               n_keyframes=res.n_keyframes, n_reloc=res.n_reloc,
                               n_edges=slam.graph.n_edges, files=files,
                               keyframe_pngs=len(kfs), launches=counts, wall_s=wall,
                               K_frame=(None if slam.keyframes.K is None
                                        else slam.keyframes.K.cpu().numpy().tolist()),
                               stages={k: {m: v[m] for m in ("p50_ms", "count")}
                                       for k, v in slam.timer.stats().items()})
            log(f"CLI ({config}, stand-in model) {slam.img_hw[0]}x{slam.img_hw[1]}: "
                f"{json.dumps(out[config])}")

        # a checkpoint halfway, resumed in a fresh engine
        cfg = load_config("eval_no_calib")
        dataset = dataloader.load_dataset(str(seq))
        dataset.subsample(cfg["dataset"]["subsample"])
        cfg["engine"]["resize"] = dataset.img_size  # as run.main sets it
        first = run.build_slam(cfg, dataset, device=dev)
        last, half = None, 0
        kf = first.keyframes
        while half < len(dataset) - 2:  # up to a frame past the second keyframe
            ts, img = dataset[half]
            last = first.process_frame(half, ts, img, last_T_WC=last).T_WC
            half += 1
            if len(kf) >= 2 and int(kf.frame_id[len(kf) - 1]) < half - 1:
                break
        path = pathlib.Path("checkpoints") / "half.npz"
        sync(dev)
        t0 = time.perf_counter()
        save_state(path, first)
        save_s = time.perf_counter() - t0
        resumed = run.build_slam(cfg, dataset, device=dev)
        t0 = time.perf_counter()
        load_state(path, resumed)
        sync(dev)
        load_s = time.perf_counter() - t0
        n = len(first.keyframes)
        same = (len(resumed.keyframes) == n and resumed.graph.n_edges == first.graph.n_edges
                and torch.equal(resumed.keyframes.T_WC[:n], first.keyframes.T_WC[:n])
                and torch.equal(resumed.keyframes.X[:n], first.keyframes.X[:n])
                and resumed.mode == first.mode)
        for i in range(half, len(dataset)):
            ts, img = dataset[i]
            last = resumed.process_frame(i, ts, img, last_T_WC=last).T_WC
        resumed.join_backend()
        poses = np.stack([p for _, p in first.frame_log + resumed.frame_log])
        resumed_ate = umeyama_rmse(poses[:, :3].astype(np.float64), gt[::2][:len(poses), :3])
        out["checkpoint"] = dict(keyframes=n, same_bits=bool(same), resumed_ate_m=resumed_ate,
                                 save_s=save_s, load_s=load_s,
                                 bytes=path.stat().st_size, frames=len(poses))
        log(f"CLI checkpoint halfway (stand-in model): {json.dumps(out['checkpoint'])}")
        first.close()
        resumed.close()
    return out


def run_cli_vitl(dev, root, img_size=512, preset="vit_large", n_frames=CLI_VITL_FRAMES):
    """The CLI over the same sequence with ViT-L (random weights, seed 0,
    as ``build_slam`` makes them), then with ``--checkpoint`` an npz that
    ``save_params`` wrote from the same weights; the launch counters reset
    just before each run and read just after, the checkpoint of the first
    engine timed.  Returns a dict of counts, stages and checks."""
    from mast3r_slam_tpu_torch.data import dataloader
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.convert import save_params
    from mast3r_slam_tpu_torch.slam import run
    from mast3r_slam_tpu_torch.slam.checkpoint import save_state

    seq = root / TUM_SEQ
    argv = ["--dataset", str(seq), "--config", "eval_no_calib", "--device", str(dev),
            "--max-frames", str(n_frames), "--profile", "--model-preset",
            "vit_large" if preset == "vit_large" else "tiny"]
    for ov in CLI_VITL_SET:
        argv += ["--set", ov]
    built = []
    real = run.build_slam

    def keep(cfg, dataset, **kw):
        slam = real(cfg, dataset, **kw)
        built.append(slam)
        return slam

    with swapped(run, "build_slam", keep), \
            swapped(dataloader.MonocularDataset, "img_size", img_size):
        res, counts, wall = run_cli(argv + ["--save-as", "vitl_random"])
        slam = built[-1]
        mcfg = slam.model.mcfg
        st = slam.timer.stats()
        path = pathlib.Path("checkpoints") / "vitl_state.npz"
        sync(dev)
        t0 = time.perf_counter()
        save_state(path, slam)
        ckpt_s = time.perf_counter() - t0
        ckpt_bytes = path.stat().st_size
        path.unlink()
        del slam, built[:]
        npz = pathlib.Path("checkpoints") / "vitl_seed0.npz"
        t0 = time.perf_counter()
        save_params(npz, M.init_params(mcfg, 0, dev))
        params_s = time.perf_counter() - t0
        res2, counts2, wall2 = run_cli(argv + ["--save-as", "vitl_npz",
                                              "--checkpoint", str(npz)])
        npz_bytes = npz.stat().st_size
        npz.unlink()
        del built[:]
    same_bits = (np.array_equal(res.frame_poses, res2.frame_poses)
                 and np.array_equal(res.keyframe_poses, res2.keyframe_poses)
                 and res.keyframe_timestamps == res2.keyframe_timestamps)
    n_tasks = st.get("backend.update", {"count": 0})["count"]
    n_tracked = st.get("tracker.track", {"count": 0})["count"]
    out = dict(frames=len(res.frame_timestamps), n_keyframes=res.n_keyframes,
               n_tracked=n_tracked, n_tasks=n_tasks, n_reloc=res.n_reloc,
               fps=res.fps, wall_s=wall, launches=counts, npz_launches=counts2,
               npz_fps=res2.fps, same_bits=bool(same_bits),
               checkpoint_s=ckpt_s, checkpoint_bytes=ckpt_bytes,
               save_params_s=params_s, params_npz_bytes=npz_bytes,
               stages={k: {m: v[m] for m in ("mean_ms", "p50_ms", "p95_ms", "count")}
                       for k, v in st.items()})
    log(f"CLI ({preset}, eval_no_calib, {n_frames} frames, decisions pinned open) "
        f"{img_size}: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from mast3r_slam_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False        # f32 convolutions too
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn TF32 {torch.backends.cudnn.allow_tf32}")
    log(smi)

    t0 = time.perf_counter()
    paths = kernels.build_all()
    log(f"built {sorted(paths)} from {kernels.CSRC_DIR.name}/ in "
        f"{time.perf_counter() - t0:.1f} s")
    from mast3r_slam_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.build()  # the host library phase 9's ingest runs on
    log(f"built {native.library_path().name} from csrc/host/ with {native.compiler()} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in sorted(kernels.SOURCES):
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas {name}: {line.strip()}")

    attn_enc = check_attention(dev, 1, 16)
    check_attention(dev, 1, 12)
    check_attention(dev, 2, 12)
    check_attention(dev, 1, 16, strided=True)
    q = torch.zeros(1, 16, 768, 64, device=dev, dtype=torch.bfloat16)
    log(f"SDPA (1,16,768,64) runs: {kernel_names(lambda: F.scaled_dot_product_attention(q, q, q))}")
    sass = sass_counts("attention")
    log(f"attention library SASS: {sass}")
    if not (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0):
        raise AssertionError(f"attention SASS holds no wgmma or no TMA load: {sass}")
    for name in ("attention", "refine_window"):
        lib = ctypes.CDLL(str(kernels.library_path(name)))
        log(f"{name}: {getattr(lib, name + '_smem_bytes')()} bytes of dynamic shared "
            f"memory a block (ptxas above: static)")
    ref, ref_smooth, ref_scattered, ref_speed = check_refine(dev)
    ehg = check_edge_hg(dev)
    grs = check_gather_rows_sum(dev)
    tar = check_take_along_rows(dev)
    ivf = check_ivf_hamming(dev)
    design = read_design(dev, ehg, grs, ivf)
    check_small_model(dev)

    counts, times, vitl = run_vitl(dev)
    want = {"attention": 72 * N_TRACKED, "refine_window": N_TRACKED}
    if counts != want:
        raise AssertionError(f"ViT-L launches {counts}, expected {want} "
                             f"(72 attention + 1 refine per tracked frame)")
    frame_ms = statistics.median(times)
    log(f"ViT-L 384x512 tracked frame (encode + decode + track): median "
        f"{frame_ms:.3f} ms over {N_TRACKED} frames; launches {counts}")

    speed = run_vitl_speed(dev, vitl)
    n_sub = N_TRACKED + speed["n_resubmit"]
    want_seq = {"attention": 72 * N_TRACKED, "refine_window": 2 * N_TRACKED}
    want_chain = {"attention": 48 * N_TRACKED, "refine_window": 2 * n_sub}
    if ({k: speed["seq_counts"][k] for k in want_seq} != want_seq
            or {k: speed["chain_counts"][k] for k in want_chain} != want_chain
            or not speed["same_bits"]):
        raise AssertionError(
            f"ViT-L speed profile: sequential launches {speed['seq_counts']} (expected "
            f"{want_seq}: 72 attention + 2 refine a frame), chained {speed['chain_counts']} "
            f"(expected {want_chain}), chained == sequential bits {speed['same_bits']}")
    want_task = {"attention": 48, "refine_window": 2}
    if ({k: speed["task_counts"][k] for k in want_task} != want_task
            or speed["task_counts"]["edge_hg_rays"] < 1 or not speed["oneway"]):
        raise AssertionError(f"ViT-L speed one-way task: launches {speed['task_counts']} "
                             f"(expected {want_task} and edge_hg_rays >= 1), one-way "
                             f"row {speed['oneway']}")

    ate, res, slam_counts, _, seq_slam = run_synthetic_slam(dev)
    n_tracked = len(res.frame_poses) - 1 - res.n_reloc
    if res.n_reloc or ate > TRAJ_BOUND_M or res.n_keyframes < 2:
        raise AssertionError(
            f"synthetic scene: ATE {ate} m (bound {TRAJ_BOUND_M}), "
            f"{res.n_reloc} reloc, {res.n_keyframes} keyframes")
    # one refine launch a tracked frame and one a backend task's matching;
    # the edge-block kernel at least once a backend solve
    n_tasks = res.n_keyframes - 1
    if (slam_counts["attention"] != 0
            or slam_counts["refine_window"] != n_tracked + n_tasks
            or slam_counts["edge_hg_rays"] < n_tasks):
        raise AssertionError(f"synthetic SLAM.run launches {slam_counts} "
                             f"({n_tracked} tracked frames, {n_tasks} backend tasks)")

    # the pipelined loop, single threaded: the sequential run's poses, bit for bit
    _, pres, _, _, _ = run_synthetic_slam(dev, cfg=engine_cfg("base", pipeline=1),
                                          label="base, pipeline 1")
    if not (np.array_equal(pres.frame_poses, res.frame_poses)
            and np.array_equal(pres.keyframe_poses, res.keyframe_poses)):
        raise AssertionError("synthetic SLAM.run: pipeline 1 poses differ from the "
                             "sequential loop's")
    # speed as packaged: the threaded backend and the pipelined loop
    sate, sres, _, sstats, _ = run_synthetic_slam(
        dev, cfg=engine_cfg("speed", single_thread=False), label="speed")
    if sres.n_reloc or sate > TRAJ_BOUND_M or sres.n_keyframes < 2:
        raise AssertionError(f"synthetic scene under speed: ATE {sate} m (bound "
                             f"{TRAJ_BOUND_M}), {sres.n_reloc} reloc, "
                             f"{sres.n_keyframes} keyframes")

    solves = run_synthetic_solve(dev)
    if not all(r["same_bits"] for r in solves.values()):
        raise AssertionError("full-width solves, the same pose bits on a second run: "
                             + json.dumps({k: r["same_bits"] for k, r in solves.items()}))
    backend_counts, backend_split = run_vitl_backend(dev, vitl)

    retr = run_retrieval(dev, vitl)
    if any(c != {**{k: 0 for k in c}, "ivf_hamming": 1} for _, c in retr["launches"]):
        raise AssertionError(f"full-width retrieval launches {retr['launches']}: "
                             f"expected one ivf_hamming and nothing else a call")
    if not (retr["hamming_exact"] and retr["kernel_vs_plain_rel"] <= RETRIEVAL_SCORE_RTOL
            and retr["same_topk"] and retr["repeat_same"] and retr["scores_same_bits"]
            and retr["n_images"] > 512
            and retr["bucket_cap"] == 16):
        raise AssertionError(f"full-width retrieval: {retr}")

    rres, rslam, rgt, rcounts, rcalls, rhamming = run_synthetic_reloc(dev)
    st = rslam.timer.stats()
    n_upd = st["backend.retrieval"]["count"]   # the first only adds keyframe 0
    n_qry = st.get("reloc.retrieval", {"count": 0})["count"]
    n_solves = st.get("backend.solve", {"count": 0})["count"] + rres.n_reloc_success
    post_err = float(np.linalg.norm(rres.frame_poses[-3:, :3] - rgt[-3:, :3], axis=-1).max())
    want = {"attention": 0, "gather_rows_sum": 0, "take_along_rows": 0,
            "ivf_hamming": n_upd - 1 + n_qry,
            "refine_window": st["tracker.track"]["count"] + len(rcalls)}
    if ({k: rcounts[k] for k in want} != want or rcounts["edge_hg_rays"] < n_solves
            or not rhamming or rres.n_reloc < 1 or rres.n_reloc_success < 1
            or rslam.mode.name != "TRACKING" or post_err >= RELOC_BOUND_M):
        raise AssertionError(
            f"synthetic reloc: launches {rcounts} (expected {want} and edge_hg_rays >= "
            f"{n_solves}), ivf_hamming exact {rhamming}, {rres.n_reloc} reloc, "
            f"{rres.n_reloc_success} succeeded, mode {rslam.mode.name}, post-reloc error "
            f"{post_err} m (bound {RELOC_BOUND_M})")

    # relocalisation under speed: the threaded backend and the pipelined loop
    sr_res, sr_slam, sr_gt, _, _, _ = run_synthetic_reloc(
        dev, cfg=engine_cfg("speed", single_thread=False, edge_buffer=64), label="speed")
    sr_err = float(np.linalg.norm(sr_res.frame_poses[-3:, :3] - sr_gt[-3:, :3], axis=-1).max())
    if (sr_res.n_reloc < 1 or sr_res.n_reloc_success < 1
            or sr_slam.mode.name != "TRACKING" or sr_err >= RELOC_BOUND_M):
        raise AssertionError(
            f"synthetic reloc under speed: {sr_res.n_reloc} reloc, {sr_res.n_reloc_success} "
            f"succeeded, mode {sr_slam.mode.name}, post-reloc error {sr_err} m (bound "
            f"{RELOC_BOUND_M})")

    # the CLI on a recorded sequence, from a scratch directory in the checkout
    work = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli = run_cli_standin(dev, work)
        vcli = run_cli_vitl(dev, work)
    finally:
        os.chdir(cwd)
    want_files = sorted([f"{TUM_SEQ}.txt", f"{TUM_SEQ}.ply", f"{TUM_SEQ}_map.png",
                         f"{TUM_SEQ}_scene.json", "keyframes"])
    for config in ("eval_no_calib", "eval_calib"):
        r = cli[config]
        if not (r["ate_m"] is not None and r["ate_m"] < TRAJ_BOUND_M and r["n_reloc"] == 0
                and r["n_frames"] == CLI_RAW_FRAMES // 2 and r["files"] == want_files
                and r["keyframe_pngs"] == r["n_keyframes"]
                and (r["K_frame"] is not None) == (config == "eval_calib")
                and r["launches"]["refine_window"] > 0
                # calib-mode edge blocks are plain torch (ROADMAP Queue 2b item 7)
                and (r["launches"]["edge_hg_rays"] > 0) == (config == "eval_no_calib")):
            raise AssertionError(f"CLI ({config}, stand-in): {json.dumps(r)} (ATE bound "
                                 f"{TRAJ_BOUND_M} m, outputs {want_files})")
    ck = cli["checkpoint"]
    if not (ck["same_bits"] and ck["resumed_ate_m"] < TRAJ_BOUND_M):
        raise AssertionError(f"CLI checkpoint halfway: {json.dumps(ck)} (keyframe poses "
                             f"must come back bit for bit, ATE under {TRAJ_BOUND_M} m)")
    vc = vcli["launches"]
    want_v = {"attention": 72 * vcli["frames"] + 48 * vcli["n_tasks"],
              "refine_window": vcli["n_tracked"] + vcli["n_tasks"]}
    if ({k: vc[k] for k in want_v} != want_v or vcli["n_tasks"] < 1
            or vc["edge_hg_rays"] < vcli["n_tasks"] or vcli["npz_launches"] != vc
            or not vcli["same_bits"] or vcli["frames"] != CLI_VITL_FRAMES):
        raise AssertionError(
            f"CLI with ViT-L: launches {vc} (expected {want_v}: 72 attention a frame and "
            f"48 a backend task, one refine a tracked frame and a task; edge_hg_rays >= "
            f"{vcli['n_tasks']} tasks >= 1), npz run {vcli['npz_launches']}, same "
            f"trajectory bits {vcli['same_bits']}, {vcli['frames']} frames")
    log(f"CLI ViT-L 384x512, {vcli['frames']} frames: {vcli['fps']:.3f} frames/s (host "
        f"clock), {vcli['n_tasks']} backend tasks, export.ply "
        f"{vcli['stages']['export.ply']['mean_ms']:.1f} ms, checkpoint "
        f"{vcli['checkpoint_s'] * 1e3:.1f} ms ({vcli['checkpoint_bytes']} bytes); {smi}")

    common = lambda r: {k: r[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms",
                                          "library_call_ms")}
    line = {"kernels": [
        dict(name="attention", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/attention.cu",
             replaces="mast3r_slam_tpu/ops/attention.py:52",
             launches=counts["attention"], shape=attn_enc["shape"], **common(attn_enc)),
        dict(name="refine_window", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/refine_window.cu",
             replaces="mast3r_slam_tpu/ops/refine_pallas.py:70",
             launches=counts["refine_window"], shape=[1, 384 * 512, 24], **common(ref),
             speed_launches=speed["seq_counts"]["refine_window"],
             speed={k: {m: r[m] for m in ("schedule", "radius", "n", "ms", "call_ms",
                                          "plain_ms", "bound_ms", "bound_by")}
                    for k, r in ref_speed["current"].items()}),
        dict(name="edge_hg_rays", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/edge_hg_rays.cu",
             replaces="mast3r_slam_tpu/ops/edge_hg_pallas.py:130",
             launches=backend_counts["edge_hg_rays"], shape=ehg["shape"], **common(ehg)),
        # the next three: launches in phase 8's SLAM.run (retrieval and reloc);
        # the two probes lie on no package path, their row-gather kernel
        # runs there as ivf_hamming
        dict(name="gather_rows_sum", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/gather_rows.cu",
             replaces="scripts/tpu_r4_experiments.py:52",
             launches=rcounts["gather_rows_sum"], shape=grs["shape"], **common(grs)),
        dict(name="take_along_rows", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/take_along_rows.cu",
             replaces="scripts/tpu_r4_experiments.py:339",
             launches=rcounts["take_along_rows"], shape=tar["shape"], **common(tar),
             sector_bound_ms=tar["sector_bound_ms"], slab_bytes=tar["slab_bytes"],
             slab_sweep_ms=tar["slab_sweep_ms"]),
        dict(name="ivf_hamming", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/ivf_hamming.cu",
             replaces="mast3r_slam_tpu/retrieval/asmk.py:307",
             launches=rcounts["ivf_hamming"], shape=ivf["shape"], **common(ivf)),
    ], "kernel_floor_ms": design["kernel_floor_ms"],
        "edge_hg_sass_loop": design["edge_hg_sass_loop"], "ptxas": design["ptxas"],
        "gather_plans": design["plans"],
        "tracked_frame_ms": frame_ms, "synthetic_ate_m": ate,
        "full_width_solve": {k: {"max_err_m": r["err"], "iters": r["iters"], "ms": r["ms"],
                                 "same_bits": r["same_bits"]} for k, r in solves.items()},
        "vitl_backend_task": backend_split,
        "refine_inputs": {name: {k: r[k] for k in ("ms", "pairs_shared", "pixel_levels_shared")}
                          for name, r in (("smooth_flow", ref_smooth),
                                          ("scattered", ref_scattered))},
        "retrieval_full_width": {k: retr[k] for k in ("update_ms", "query_ms",
                                                      "kernel_vs_plain_rel",
                                                      "scores_same_bits")},
        "synthetic_reloc": {"n_reloc": rres.n_reloc, "n_reloc_success": rres.n_reloc_success,
                            "post_reloc_err_m": post_err},
        "speed": {"vitl_frame_ms": speed["seq_ms"], "vitl_chained_ms": speed["chain_ms"],
                  "vitl_launches": speed["seq_counts"], "oneway_task_ms": speed["task_ms"],
                  "oneway_task_launches": speed["task_counts"], "synthetic_ate_m": sate,
                  "synthetic_engine": sstats, "reloc_post_err_m": sr_err,
                  "reloc_success": sr_res.n_reloc_success},
        "cli": {"standin": cli, "vitl": vcli, "card": smi}}
    log(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
