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

  10. the long-video memory plan at 384x512: (a) FactorGraph.solve with
     window_size 16 and edge_recycle over phase 6's arc problem grown to
     32, 40 and 48 keyframes (a chain and loop edges), a solve after each:
     pre-window poses keep their bits, one edge-block launch a GN
     iteration, the window within SOLVE_BOUND_M of the full solve with the
     pre-window poses pinned, recycled rows reused so the edge store stops
     growing, a second run the same bits; (b) a paged soak (48 keyframes
     with ViT-L-sized tokens into 8 device slots, a solve after each:
     device_bytes() flat once the pool is full, torch.cuda.memory_allocated()
     flat over the second half, an eviction and an upload timed), then
     phase 8's teleport run as a long video sees it (a keyframe every 2
     tracked frames, no loop-closure candidates) with
     engine.device_keyframes 5 against an unpaged control at the same
     effective window (the same keyframes and relocalisations, poses within
     1e-6 and whether the same bits, an evicted relocalisation target
     brought back), a checkpoint of the paged store loaded bit for bit, and
     the paged run under speed as packaged;
     (c) one ViT-L backend task with local_opt.pixel_stride 2 on phase 6's
     keyframes: 48 attention and 1 refine launch, the refine kernel exactly
     its plain version on that task's inputs, timed beside the stride-1
     task.
  11. serving at 384x512: (a) the committed baseline 4:2:0 JPEG
     (tests/data/serve_frame.jpg) through the host library's decoder, exactly
     against the committed cv2 decode of it (this host has no cv2); (b) one
     ViT-L session through SlamServer on 127.0.0.1 and the port's WebSocket
     client: GET / and /connect, /ws/{id}, SERVE_FRAMES 480x640 frames (phase
     4's smooth random images as base64 PNG), each sent when the previous
     frame's pose_update arrived, decisions pinned open as in 9b: ready, a
     pose_update a frame in order, a new_keyframe a keyframe with points and
     colours, fps_update, the exports written and read back,
     shutdown_complete, the session in /active_sessions, 72 attention
     launches a frame and 48 a backend task, one refine launch a tracked
     frame and a task, edge blocks in every solve, and the same pose bits as
     a control that feeds the decoded frames to SLAM.process_frame without
     the server; client latency send -> pose_update, keyframe event bytes;
     (c) ``slam.run --viz-ws PORT`` with 9a's stand-in: a late viewer gets
     the keyframe events so far as replay, then live ones; its
     conf_threshold changes the exported PLY; pause, step and terminate end
     the run early; (d) two stand-in sessions at once, their event streams
     apart, the idle one reaped.
  12. image input on the card's host, which has no cv2: (a) every committed
     image fixture (tests/data/image_fixtures.json: progressive 4:2:0 with
     restarts, progressive gray, 16-bit RGB, palette and Adam7 PNGs, the
     folder and served frames below) through the port's readers, against
     the committed SHA-256 of cv2's decode of it; each folder frame's read
     timed by kind; (b) ViT-L through the CLI as in 9b over the committed
     folder of 8 frames at 480x640 (baseline and progressive JPEGs, a
     palette Adam7 PNG), then over 8-bit RGB PNG copies of its decoded
     frames (the port's writer): the same trajectory bits and 9b's launch
     counts, the ingest stage's time beside the card's name and power
     limit; (c) 9a's stand-in served over the port's WebSocket client with
     progressive JPEG and 16-bit PNG payloads, the same pose bits as a
     control that feeds the decoded frames to SLAM.process_frame; (d) a
     session whose engine is blocked with a full queue: close() returns at
     once, terminate() within its timeout, the session marked wedged.
  13. the multi-card backend on the one card: (a) phase 6's rays problem
     (16 keyframes, 32 two-way edges x 196,608 pixels) through the
     edge-sharded solve on meshes of 1, 2 and 4 shards on cuda:0 against the
     single-device dense solve (poses within SHARDED_POSE_*), each mesh one
     device program (one global_gn_while launch a solve, edge-block runs =
     shards x iters, the bits of the frozen plain loop the route ran before,
     the same bits on a second call, ms beside the frozen loop's), also at
     a delta_norm where the loop stops early; then on 1 shard in a one-rank
     NCCL process group (the eager loop that reads its flag once an
     iteration: shards x iters, no program); (b) two processes
     (torch.multiprocessing) on the card joined over gloo (NCCL puts no two
     ranks on one card), each running phase 5's SLAM.run with engine.mesh
     "auto": phase 5's keyframe count, its poses within
     TWO_PROCESS_POSE_ATOL, both ranks the same pose bits, each rank's
     launches; (c) phase 6's ViT-L backend task on a mesh of 2 shards: 48
     attention and 1 refine launch a shard, idx, valid and Q equal to the
     unsharded task's bits, its ms beside phase 6's; (d)
     FrameTracker(compute_device=cuda:0) over phase 4's frames: the default
     tracker's bits; (e) the threaded backend (single_thread: False)
     across two processes on the card over gloo: 13b's run with every task
     gated to land at its own frame (both ranks the same bits, within
     TWO_PROCESS_POSE_ATOL of phase 5's), then ViT-L with random weights
     (seed 0) at 384x512 under base as packaged with engine.mesh "auto"
     and 9b's pinned decisions, THREADED_FRAMES frames, rank 1's worker
     holding each task's end THREADED_HOLD frames: both ranks the same
     schedule, keyframes and pose bits, every task applied, each rank's
     attention, refine and edge-block launches held to its frames and
     tasks (counters reset just before each run and read just after), the
     agreements' count and host ms and the run's wall time; in 13b and 13e
     every solve the sharded loop across the processes (edge-block runs =
     the solves' iterations summed); (f) a relocalisation's drain across
     processes: phase 8's teleport run threaded over two gloo processes on
     the card (engine.mesh "auto"): both ranks relocalise at the same
     frame, the same pose bits, within 0.15 m after, edge-block runs = the
     solves' iterations summed.  With a
     second card, engine.pipeline: 2 (the tracker and the store on cuda:1)
     for phase 5's bits, a 2-card NCCL mesh for (a)'s solve and the
     attention and refine kernels on every card; with one card, one line
     names those runs as not run.
  14. the tracking GN on the device and the host reads: (a) the card's
     syncs (torch.cuda.set_sync_debug_mode("warn"), each with the stack
     that made it) over SYNC_FRAMES ViT-L frames at 384x512 under `speed`
     with the decisions pinned open, each through infer,
     track_submit_chained and track_finish after two warm-up frames:
     exactly one a tracked frame (its encode counted apart); and over one
     `speed` backend task (retrieval with the default head at full width
     and a 64k-word codebook, add_factors, the dense solve) after two
     warm-up tasks: exactly one; (b) the tracking GN's device program
     (csrc/gn_while.cu: a CUDA graph, a WHILE conditional node over one
     captured iteration) against the eager frozen loop at 196,608 points,
     ray + distance, calib and a singular system: the same bits and
     iterations, its device time (CUDA events), the plain loop's, the
     bound and its graph's kernel nodes; (c) SLAM.run of WALL_FRAMES ViT-L
     frames under pipeline 0 and 1 in turn (wall a frame, frame.latency
     p50, the same pose bits), and phase 4's profiled launches and busy
     share beside their numbers before the loop moved to the device.
  15. the last reads cv2 gave the JAX package, on the card's host, which has
     no cv2: (a) every committed image fixture (colour 8- and 16-bit,
     RGBA and palette PNGs, two tagged with a gamma (gAMA, sRGB), which
     the gray read weighs in linear light; colour, RGB-coded, CMYK and
     YCCK JPEGs;
     progressive scripts cut short, gray and 4:2:0, with and without
     restarts, which libjpeg-turbo smooths) through imread_rgb, imread_gray
     and decode_image_payload, against the committed SHA-256 of cv2's
     colour and gray decodes; a 480x640 decode of a 2-scan prefix, of its
     whole progressive file and of a baseline JPEG timed (median of
     DECODE_REPEATS, host clock); (b) ViT-L through the CLI as in 12b over
     a EuRoC folder (cam0's focal lengths and distortion at 640x480, the
     principal point at the centre) of the committed colour image-folder
     frames, which EuRoC's read converts to gray, against a EuRoC folder of
     those gray reads written back as PNGs: the same trajectory bits and
     12b's launch counts; (c) one ViT-L session as in 11b whose payloads
     are the committed 480x640 progressive frames cut after 2 to 9 scans:
     the control's pose bits, 72 attention launches a frame and 48 a
     backend task, one refine a tracked frame and a task.  Its frames are
     smooth random fields, as 11b's: random weights fail the tracking GN
     on textured ones, and a failed frame goes to relocalisation.

  16. the last JPEG codings cv2 gives the JAX package: (a) the arithmetic
     and lossless fixtures counted and timed, (b) 15b over lossless gray
     frames, (c) 15c's session over arithmetic-coded frames.
  17. the global solve as one device program a (poses, edges) bucket
     (csrc/gn_while.cu: a WHILE node over the GN iteration, on the PCG route
     a WHILE node over the CG iteration inside it): (a) the program against the eager plain loop on phase 6's scenes at
     full width, rays dense and PCG and calib through the cached entry,
     points mode through the gathering entry: the same bits and
     iterations, one launch, the edge-block kernel once an iteration that
     ran, no sync, the program's device time against the eager loop's;
     (b) phase 6's ViT-L task: the solve's syncs (none), iterations,
     launches and solve_ms; (c) 10a's windowed arc with a solve after
     every keyframe, from no program kept: the buckets met, each built
     once, and the device memory the programs hold.  The buckets met in
     9b, 10a, 10b and 11 are logged too, with the builds an LRU cache of
     1-8 programs would make over them.
  19. video input on the card's host, which has no cv2 (data/video.py, the
     MPEG-4 Part 2 decoder of csrc/host/mpeg4.cpp): (a) every committed
     video fixture (mp4v in .mp4 and .mov, XVID and DIVX in .avi, widths
     that are not multiples of 8 or 16, a VOP marked not coded, and two
     written AVI streams: half-pel moves without rounding over 0 pixels,
     random valid syntax whose coefficients overflow the x86 IDCT) read
     sequentially, at seeks back and forth and after subsample(4), each
     frame's SHA-256, the frame count and the fps against what cv2 gave
     when the fixtures were made (tests/data/video_fixtures.json); (b) ViT-L
     through the CLI as in 12b over the committed 480x640 mp4v clip of
     smooth panning frames (every frame), against a folder of PNGs of the
     port's decode of its frames written here: the same trajectory bits,
     the same keyframe PNGs and 12b's launch counts; (c) a 480x640 frame's
     decode timed over the clip (host clock, median) beside the decode of
     the committed baseline JPEG of its first frame, in the same run.
  20. H.264 input on the card's host (the CAVLC decoder of
     csrc/host/h264.cpp): (a) every committed H.264 fixture (random syntax
     in .avi, in 3 slices with 4 references in .mov, full range BT.709,
     one turned 90 degrees by its track's display matrix) and a turned
     mp4v file, read as 19a reads them, against cv2's digests
     (tests/data/h264_fixtures.json); (b) 19b over the committed 480x640
     H.264 clip of smooth panning frames, its PNG control's frames held to
     cv2's digests; (c) a 480x640 H.264 frame's decode (IDR and P pictures
     apart) and a 1920x1080 one's, beside 19c's mp4v frame and JPEG, in the
     same call.
  21. CABAC H.264 input and JPEG restart resync on the card's host: (a)
     every committed CABAC fixture (a 480x640 and a 1920x1080 pan at High
     profile with the 8x8 transform, random syntax in 2 slices in .mov),
     read as 19a reads them, against cv2's digests
     (tests/data/h264_fixtures.json), and every committed JPEG whose
     restart markers are out of place (baseline, progressive and
     arithmetic; RST3 replaced by the next or previous marker, removed, or
     swapped; an EOI inside a progressive scan) through imread_rgb,
     imread_gray and decode_image_payload against cv2's digests
     (tests/data/resync_fixtures.json); (b) 19b over the committed 480x640
     CABAC clip, its PNG control's frames held to cv2's digests; (c) a
     frame's decode under CABAC beside CAVLC, at 480x640 and 1920x1080,
     IDR and P pictures apart, in the same call.
  22. H.264 B pictures, weighted prediction and reordered output on the
     card's host (x264's default tools): (a) every committed B-picture
     fixture (random CAVLC syntax in .mp4, random CABAC syntax with a
     referenced B picture in 2 slices in .mov, explicit weights in .avi,
     ctts version 1 behind an edit that cuts frames, and the two pans),
     read as 19a reads them, against cv2's digests
     (tests/data/h264_fixtures.json); (b) 19b over the committed 480x640
     IBBP clip (b-pyramid, CABAC, the 8x8 transform, explicit weights in
     P, implicit in B, behind ctts and FFmpeg's edit list), its PNG
     control's frames held to cv2's digests; (c) an IDR, a P and a B
     picture's decode, at 480x640 and 1920x1080, in the same call.
  23. HEVC input on the card's host (Main profile I and P pictures, the
     decoder of csrc/host/hevc.cpp): (a) every committed HEVC fixture
     (random syntax with every tool the decoder takes in .mp4 and turned
     90 degrees in .mov, full range BT.709 in band in .mov, CRA sync
     samples in .avi, and the two pans), read as 19a reads them, against
     cv2's digests (tests/data/hevc_fixtures.json); (b) 19b over the
     committed 480x640 HEVC clip (32x32 CTBs, WPP), its PNG control's
     frames held to cv2's digests; (c) an IDR and a P picture's decode at
     480x640 and 1920x1080, beside CABAC H.264's, in the same call.
  24. HEVC B slices and leading pictures on the card's host (x265's
     default open-GOP B pyramid): (a) every committed B fixture (random B
     syntax with every tool and RASL/RADL pictures in .mp4, a stream
     opening with a CRA picture whose RASL pictures are never shown in
     .mov, BLA pictures in .mp4, RASL pictures in .avi, and the two pans),
     read as 19a reads them, against cv2's digests
     (tests/data/hevc_fixtures.json, the hevc_b_ files); (b) 19b over the
     committed 480x640 clip (hierarchical B pictures, an open-GOP CRA
     picture with RASL pictures, behind ctts and FFmpeg's edit list), its
     PNG control's frames held to cv2's digests; (c) an IDR, a P and a B
     picture's decode at 480x640 and 1920x1080, beside the P-only clips'
     IDR and P pictures, in the same call.
  25. Motion-JPEG input on the card's host (the decoder of
     csrc/host/mjpeg.cpp, libavcodec's arithmetic): (a) every committed
     Motion-JPEG fixture (OpenCV's own writer, FFmpeg's in .avi, .mov and
     .mp4, libjpeg-turbo's 4:2:2 pictures with and without DHT, 4:2:0 with
     restart intervals, at a size no multiple of the MCU, and with a
     dropped frame), read as 19a reads them, against cv2's digests
     (tests/data/mjpeg_fixtures.json); (b) 19b over the committed 480x640
     clip of OpenCV's MJPEG writer, its PNG control's frames held to cv2's
     digests; (c) a frame's decode at 480x640 and 1920x1080 beside the
     image reader's decode_jpeg of the same samples, in the same call.
  26. HEVC Main 10 input on the card's host (csrc/host/hevc.cpp at 9 and
     10 bits, converted by csrc/host/swscale.h, libswscale's scaler as cv2
     runs it): (a) every committed Main 10 fixture (random I/P syntax at 10
     and 9 bits, B pictures with RASL and RADL pictures, full range BT.2020
     with chroma sited top-left in .avi, the two pans), read as 19a reads
     them, against cv2's digests (tests/data/hevc10_fixtures.json); (b) 19b
     over the committed 480x640 10-bit clip (phase 23b's content), its PNG
     control's frames held to cv2's digests; (c) a frame's decode and
     conversion at 480x640 and 1920x1080 beside the 8-bit HEVC clips of the
     same content, in the same call.

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
frame (device time by kernel, launches, device busy share), and counts the
tracking GN's device program (one launch a tracked frame) with the kernels.  It prints one
JSON line of kernel numbers, then as its last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
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
    (torch.profiler).  The profiler drops the records of ctypes launches now
    and then, most of them in a process that compiled a library after its
    first trace (scripts/torch_profiler_records.py), so phase 1 compiles and
    loads every library first, and a trace with no kernel record is taken
    again, up to ten times."""
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


PROFILES: dict = {}  # label -> the numbers of its profile() call


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
    PROFILES[label] = dict(wall_ms=wall_ms, launches=len(kernels), copy_launches=n_copy,
                           busy_ms=busy_ms, busy_share=busy_ms / wall_ms)


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
    from mast3r_slam_tpu_torch.ops import attention, refine, tracking_gn
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
    tracking_gn.counter.reset()
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
    counts = {"attention": attention.counter.count, "refine_window": refine.counter.count,
              "tracking_gn_while": tracking_gn.counter.count}
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
        self._renders = {}
        self._torch = torch

    @staticmethod
    def image_value(fid):
        return (fid + 1) / 255.0 * 2 - 1

    def preprocessed(self, fid):
        img = np.full((3, self.H, self.W), self.image_value(fid), np.float32)
        return dict(img=img)

    def _render(self, fid):
        """(X_cam, D, C) of frame fid, rendered once (the arrays are read only)."""
        if fid not in self._renders:
            self._renders[fid] = self._render_now(fid)
        return self._renders[fid]

    def _render_now(self, fid):
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
    from mast3r_slam_tpu_torch.ops import (attention, edge_hg, gather, global_gn, refine,
                                           tracking_gn)

    return (attention.counter, refine.counter, edge_hg.counter, gather.sum_counter,
            gather.take_counter, gather.ivf_counter, tracking_gn.counter, global_gn.counter)


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


def rays_problem(dev, hw, n_kf, seed):
    """The rays-mode solve's scene: one world cloud seen from an arc of
    n_kf keyframes, a chain plus one loop edge both ways (2 n_kf two-way
    edges), identity correspondences, the poses after the first perturbed.
    Returns (ground truth, noisy poses, Xs, Cs, ii, jj, idx, valid, Q, K)."""
    import torch
    from mast3r_slam_tpu_torch.lie import sim3

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
    E = len(ii)
    idx = torch.arange(N, dtype=torch.int32, device=dev).expand(E, N)
    valid = torch.ones((E, N, 1), dtype=torch.bool, device=dev)
    Q = torch.full((E, N, 1), 2.0, device=dev)
    tau = torch.as_tensor(rng.normal(size=(n_kf, 7)) * 0.01, dtype=torch.float32, device=dev)
    tau[0] = 0
    return gt, sim3.retr(gt, tau), Xs, Cs, ii, jj, idx, valid, Q, torch.eye(3, device=dev)


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
    from mast3r_slam_tpu_torch.ops.global_gn import (
        GlobalGNSettings, gauss_newton_poses, gauss_newton_poses_cached)

    N = hw[0] * hw[1]
    gt, noisy, Xs, Cs, ii, jj, idx, valid, Q, K = rays_problem(dev, hw, n_kf, seed)
    E, half = len(ii), len(ii) // 2
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
        iters, ok, diverged = int(iters), bool(ok), bool(diverged)
        err = (T[:, :3] - truth[:, :3]).norm(dim=-1).max().item()
        T2 = solve()[0]
        same_bits = torch.equal(T, T2)
        log(f"full-width solve, {name} entry ({n_kf} keyframes, {E} edges x {N} px): "
            f"{iters} GN iterations, ok {ok}, diverged {diverged}, {ms:.3f} ms (host "
            f"clock); max translation error {err0:.6f} -> {err:.8f} m; launches {counts}; "
            f"the same pose bits on a second run {same_bits}")
        # one device program a solve, stopping where the JAX loop stops:
        # the edge-block kernel once an iteration that ran
        if not (ok and err <= SOLVE_BOUND_M and iters >= 1
                and counts["edge_hg_rays"] == per_iter * iters
                and (dev.type != "cuda" or counts["global_gn_while"] == 1)):
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
    from mast3r_slam_tpu_torch.slam import factor_graph as fg

    cfg = load_config("base")
    kf = vitl_keyframes(dev, model, hw)
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
    return counts, split, kf


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
# phase 10: the long-video memory plan
# ---------------------------------------------------------------------------

WINDOW_STAGES = (32, 40, 48)  # 10a: keyframes at each of the three solves
WINDOW = 16                   # 10a: local_opt.window_size
SOAK_KF = 48                  # 10b: keyframes of the paged soak
PAGED_BUDGET = 8              # 10b: engine.device_keyframes of the soak
RELOC_BUDGET = 5              # 10b: engine.device_keyframes of the reloc runs
PAGING_POSE_ATOL = 1e-6       # paged against unpaged (tests/test_paging.py:118)
QUAT_DRIFT_MAX = 1e-5         # keyframe quaternions off unit norm (a few f32 roundings)
KF_EVERY = 2                  # 10b reloc runs: a keyframe at least every 2 tracked frames


def arc_problem(dev, hw, n_kf, seed):
    """Phase 6's rays problem for n_kf keyframes: one world cloud seen from
    an arc, the poses after the first perturbed.  Returns (ground truth,
    noisy poses, Xs (n_kf, N, 3))."""
    import torch
    from mast3r_slam_tpu_torch.lie import sim3

    rng = np.random.default_rng(seed)
    N = hw[0] * hw[1]
    gt = torch.as_tensor(arc_trajectory(n_kf, radius=0.4, max_angle=1.2),
                         dtype=torch.float32, device=dev)
    world = torch.as_tensor(rng.uniform(-1, 1, size=(N, 3)) + [0, 0, 3],
                            dtype=torch.float32, device=dev)
    Xs = sim3.act(sim3.inv(gt)[:, None, :], world)
    tau = torch.as_tensor(rng.normal(size=(n_kf, 7)) * 0.01, dtype=torch.float32, device=dev)
    tau[0] = 0
    return gt, sim3.retr(gt, tau), Xs


def arc_edges(k):
    """The edges keyframe k brings: the chain, and every sixth a loop 12 back."""
    return [(k - 1, k)] + ([(k - 12, k)] if k % 6 == 0 and k >= 12 else [])


def store_identity_edges(graph, edges, N):
    """Identity-correspondence edges into the graph's rows (recycled rows
    first), as add_factors stores them."""
    import torch

    rows = graph._take_edge_rows(len(edges))
    graph.ii[rows] = [a for a, _ in edges]
    graph.jj[rows] = [b for _, b in edges]
    r = torch.as_tensor(rows, device=graph.device).long()
    idx = torch.arange(N, dtype=torch.int32, device=graph.device)
    graph.idx_ii2jj[r] = idx
    graph.idx_jj2ii[r] = idx
    graph.valid_match_j[r] = True
    graph.valid_match_i[r] = True
    graph.Q_ii2jj[r] = 2.0
    graph.Q_jj2ii[r] = 2.0
    graph._stamp_f[rows] = -1
    graph._stamp_b[rows] = -1
    graph.edge_live[rows] = True


def arc_keyframe(Frame, k, T, X, dev, num_patches=1, feat_dim=8):
    import torch

    N = X.shape[0]
    return Frame(frame_id=k, img=None, T_WC=T, X_canon=X,
                 C=torch.full((N, 1), 2.0, device=dev), n_fused=1, n_updates=1,
                 feat=torch.full((1, num_patches, feat_dim), float(k), device=dev),
                 pos=torch.zeros((1, num_patches, 2), dtype=torch.int32, device=dev))


def solve_iters(fg):
    """Wrap the factor graph's cached GN entry to record each solve's GN
    iterations; returns (list, context manager)."""
    iters = []
    real = fg.gauss_newton_poses_cached

    def spy(*a, **kw):
        out = real(*a, **kw)
        iters.append(int(out[1]))
        return out

    return iters, swapped(fg, "gauss_newton_poses_cached", spy)


def run_windowed_solve(dev, hw=(384, 512), seed=5, oracle=True, stages=WINDOW_STAGES,
                       label="10a"):
    """10a: FactorGraph.solve with window_size 16 and edge_recycle over a
    growing 48-keyframe arc problem (phase 6's, identity correspondences):
    32, then 40, then 48 keyframes (``stages``), a solve after each stage.  Each solve:
    the pre-window poses keep their bits, one edge-block launch a GN
    iteration that ran (the device program stops where the JAX loop
    stops), and (``oracle``) the window within SOLVE_BOUND_M of
    gauss_newton_poses over every pose and edge with the pre-window poses
    pinned.  Returns a dict of the run and the final poses."""
    import torch
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.ops.global_gn import gauss_newton_poses
    from mast3r_slam_tpu_torch.slam import factor_graph as fg
    from mast3r_slam_tpu_torch.slam.frame import Frame, Keyframes

    N = hw[0] * hw[1]
    _, noisy, Xs = arc_problem(dev, hw, stages[-1], seed)
    cfg = load_config("base")
    cfg["local_opt"].update(window_size=WINDOW, edge_recycle=True)
    kf = Keyframes(64, N, 1, 8, device=dev)
    graph = fg.FactorGraph(None, cfg, kf, hw, edge_capacity=16)
    all_edges, out = [], dict(solves=[])
    iters, spy = solve_iters(fg)
    n0 = 0
    with spy:
        for n_kf in stages:
            new = []
            for k in range(n0, n_kf):
                kf.append(arc_keyframe(Frame, k, noisy[k], Xs[k], dev))
                new += arc_edges(k) if k else []
            n_edges_before = graph.n_edges
            store_identity_edges(graph, new, N)
            reused = len(new) - (graph.n_edges - n_edges_before)  # rows off the freelist
            all_edges += new
            n0 = n_kf
            s0 = max(n_kf - WINDOW, graph.settings.pin)  # a full solve up to the window
            T0 = kf.T_WC[:n_kf].clone()
            sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            graph.solve(mode="rays")
            sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            T = kf.T_WC[:n_kf].clone()
            rec = dict(n_kf=n_kf, s0=s0, ms=ms, iters=iters[-1],
                       max_iters=graph.settings.max_iters,
                       edge_hg_launches=counts["edge_hg_rays"],
                       program_launches=counts["global_gn_while"],
                       pre_window_same_bits=bool(torch.equal(T[:s0], T0[:s0])),
                       n_edges=graph.n_edges, capacity=graph.capacity,
                       new_edges=len(new), rows_reused=reused,
                       n_edges_recycled=graph.n_edges_recycled)
            if oracle:
                E = len(all_edges)
                ii = torch.tensor([a for a, b in all_edges] + [b for a, b in all_edges],
                                  device=dev)
                jj = torch.tensor([b for a, b in all_edges] + [a for a, b in all_edges],
                                  device=dev)
                T_ref, _, ok, _ = gauss_newton_poses(
                    T0, Xs[:n_kf], torch.full((n_kf, N, 1), 2.0, device=dev), ii, jj,
                    torch.arange(N, dtype=torch.int32, device=dev).expand(2 * E, N),
                    torch.ones((2 * E, N, 1), dtype=torch.bool, device=dev),
                    torch.full((2 * E, N, 1), 2.0, device=dev), torch.eye(3, device=dev),
                    hw, graph.settings._replace(pin=s0), "rays")
                rec["vs_pinned_full_m"] = (T[s0:, :3] - T_ref[s0:, :3]).norm(dim=-1).max().item()
                rec["oracle_ok"] = bool(ok)
            out["solves"].append(rec)
            log(f"{label} windowed solve {hw[0]}x{hw[1]}: {json.dumps(rec)}")
    out["T"] = kf.T_WC[:stages[-1]].clone()
    return out


def check_windowed_solve(dev):
    """10a, run twice for the same bits."""
    import torch

    a = run_windowed_solve(dev)
    b = run_windowed_solve(dev, oracle=False)
    same = bool(torch.equal(a["T"], b["T"]))
    sv = a["solves"]
    bad = [r for r in sv if not (
        r["pre_window_same_bits"] and r["edge_hg_launches"] == r["iters"]
        and r["iters"] >= 1
        and r["oracle_ok"] and r["vs_pinned_full_m"] <= SOLVE_BOUND_M)]
    grew = sv[-1]["capacity"] != sv[0]["capacity"] or sv[-1]["n_edges"] != sv[0]["n_edges"]
    if (bad or not same or sv[-1]["n_edges_recycled"] <= 0 or grew
            or sum(r["rows_reused"] for r in sv[1:]) <= 0):
        raise AssertionError(f"10a windowed solve: {json.dumps(sv)}, second run same bits "
                             f"{same} (each solve: pre-window bits kept, one edge_hg_rays "
                             f"launch a GN iteration that ran, within {SOLVE_BOUND_M} m of "
                             f"the pinned "
                             f"full solve; rows recycled and reused, the store not growing)")
    log(f"10a: the same pose bits on a second run {same}")
    return dict(solves=sv, same_bits=same)


def run_paged_soak(dev, hw=(384, 512), seed=6):
    """10b, the soak: 48 keyframes with ViT-L-sized tokens (768 x 1024 f32)
    into a store paged to 8 slots (keep_recent as the engine sizes it), the
    arc problem's edges, a solve after every keyframe (windowed past
    keep_recent, old edges recycled).  After each: device_bytes() and
    torch.cuda.memory_allocated().  Then evictions and uploads of single
    keyframes timed (host clock between synchronisations)."""
    import torch
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.slam import factor_graph as fg
    from mast3r_slam_tpu_torch.slam.frame import Frame, Keyframes
    from mast3r_slam_tpu_torch.slam.pipeline import keep_recent

    N = hw[0] * hw[1]
    gt, noisy, Xs = arc_problem(dev, hw, SOAK_KF, seed)
    cfg = load_config("base")
    cfg["engine"]["device_keyframes"] = PAGED_BUDGET
    kf = Keyframes(64, N, 768, 1024, device=dev, device_budget=PAGED_BUDGET,
                   keep_recent=keep_recent(cfg))
    graph = fg.FactorGraph(None, cfg, kf, hw, edge_capacity=16)
    dev_bytes, mem, caps = [], [], []
    for k in range(SOAK_KF):
        kf.append(arc_keyframe(Frame, k, noisy[k], Xs[k], dev, 768, 1024))
        if k:
            store_identity_edges(graph, arc_edges(k), N)
            graph.solve(mode="rays")
        sync(dev)
        dev_bytes.append(kf.device_bytes())
        mem.append(torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0)
        caps.append((graph.capacity, graph._gcache_cap, graph.n_edges))
    # the first keyframe after which the edge store, the cache and the
    # card's allocations no longer change
    flat_from = next(k for k in range(SOAK_KF)
                     if len(set(mem[k:])) == 1 and len(set(caps[k:])) == 1)
    full = kf.dcap  # the pool is full from keyframe dcap - 1 on
    out = dict(n_kf=len(kf), dcap=kf.dcap, keep_recent=kf.keep_recent,
               n_evictions=kf.n_evictions, n_edges_recycled=graph.n_edges_recycled,
               device_bytes_flat=len(set(dev_bytes[full - 1:])) == 1,
               device_bytes=dev_bytes[-1], memory_allocated=mem[-1],
               memory_flat_from_kf=flat_from, memory_first_full=mem[full - 1],
               edge_capacity=graph.capacity, n_edges=graph.n_edges,
               error_last_window_m=(kf.T_WC[SOAK_KF - kf.keep_recent:SOAK_KF, :3]
                                    - gt[SOAK_KF - kf.keep_recent:, :3]).norm(dim=-1).max().item())
    # one keyframe's rows out and back in: the newest never-evicted ones
    ev_ms, up_ms = [], []
    for i in range(SOAK_KF - kf.keep_recent, SOAK_KF):
        with kf._on_store_stream():
            sync(dev)
            t0 = time.perf_counter()
            kf._evict_locked(i)
            sync(dev)
            ev_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        kf.ensure_resident([i])
        sync(dev)
        up_ms.append((time.perf_counter() - t0) * 1e3)
    row_bytes = sum(getattr(kf, a)[0].numel() * getattr(kf, a).element_size()
                    for a in ("X", "C", "feat", "pos"))
    out.update(keyframe_row_bytes=row_bytes, evict_ms=ev_ms, upload_ms=up_ms)
    log(f"10b paged soak {hw[0]}x{hw[1]}, tokens 768x1024: {json.dumps(out)}; "
        f"device_bytes {dev_bytes}; memory_allocated {mem}")
    if not (out["device_bytes_flat"] and kf.X.shape[0] == PAGED_BUDGET
            and out["n_evictions"] > 0 and out["n_edges_recycled"] > 0
            and flat_from <= SOAK_KF // 2):
        raise AssertionError(f"10b paged soak: {json.dumps(out)} (the pool at "
                             f"{PAGED_BUDGET} slots, device bytes flat once it fills, "
                             f"the card's allocations flat over the second half)")
    return out


def run_paged_reloc(dev, cfg, label, hw=(384, 512), budget=RELOC_BUDGET, window=None):
    """Phase 8's teleport run (run_synthetic_reloc) with the store paged to
    ``budget`` slots (0: unpaged, at local_opt.window_size ``window``), as a
    long video sees it: a keyframe at least every KF_EVERY tracked frames
    until the camera is lost, no loop closures while the camera moves on (the backend's retrieval
    updates add each keyframe but ask for no candidates: in this small box
    every keyframe retrieves the first ones, whose edges would keep them in
    every window), and the relocalisation's query taking its best two
    candidates (retrieval.k 2).  The pool must then hold the window, the
    older end of its chain edge and the candidates: keep_recent 2 + 1 + 2 =
    5 slots.
    Returns (result, slam, gt, the relocalisation's targets that were evicted
    when their edges were asked for, launch counts)."""
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM

    cfg["engine"]["device_keyframes"] = budget
    cfg["retrieval"]["k"] = 2
    if window:  # the control recycles as the paged run does: the same edge rows
        cfg["local_opt"].update(window_size=window, edge_recycle=True)
    brought_back = []
    real_init = SLAM.__init__

    def spy_init(slam, *a, **kw):
        real_init(slam, *a, **kw)
        add = slam.graph.add_factors

        def counted(ii, jj, *a2, **kw2):
            if kw2.get("is_reloc"):
                brought_back.extend(j for j in jj if not slam.keyframes.is_resident(j))
            return add(ii, jj, *a2, **kw2)

        slam.graph.add_factors = counted
        force_keyframes(slam, KF_EVERY)
        update = slam.retrieval.update

        def no_loop_closures(frame, add_after_query, k, min_thresh=0.0, kf_index=None):
            return update(frame, add_after_query, 0, min_thresh, kf_index)

        slam.retrieval.update = no_loop_closures

    with swapped(SLAM, "__init__", spy_init):
        res, slam, gt, counts, _, _ = run_synthetic_reloc(dev, hw=hw, cfg=cfg, label=label)
    return res, slam, gt, sorted(set(brought_back)), counts


def force_keyframes(slam, every):
    """A keyframe at least every ``every`` tracked frames (tests/test_paging.py's
    soak) until the first relocalisation, so that a 24-frame arc outgrows a
    small pool."""
    count = {"i": 0}
    finish = slam.tracker.track_finish

    def dense(pending):
        new_kf, try_reloc = finish(pending)
        if try_reloc or slam.n_reloc:
            return new_kf, try_reloc
        count["i"] += 1
        if count["i"] % every == 0 and not new_kf:
            slam.tracker.reset_idx_f2k()
            return True, False
        return new_kf, try_reloc

    slam.tracker.track_finish = dense


def check_paged_reloc(dev, work, hw=(384, 512)):
    """10b: the teleport run paged to RELOC_BUDGET slots against an unpaged
    control at the same effective window (keep_recent), sequential under
    base, and the same run unpaged without a window; the last frames of
    both within RELOC_BOUND_M and the keyframe quaternions within
    QUAT_DRIFT_MAX of unit norm; a checkpoint of the paged store saved and
    loaded; then the paged run under speed as packaged (threaded backend,
    pipelined loop) beside an unpaged speed run at the same window."""
    import torch
    from mast3r_slam_tpu_torch.slam.checkpoint import load_state, save_state
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM

    res, slam, gt, back, counts = run_paged_reloc(
        dev, engine_cfg("base", edge_buffer=64), "base, paged", hw=hw)
    kf = slam.keyframes
    cres, cslam, _, _, _ = run_paged_reloc(
        dev, engine_cfg("base", edge_buffer=64), "base, unpaged control", budget=0,
        window=kf.keep_recent, hw=hw)
    d = float(np.abs(res.frame_poses - cres.frame_poses).max())
    same = bool(np.array_equal(res.frame_poses, cres.frame_poses)
                and np.array_equal(res.keyframe_poses, cres.keyframe_poses))
    post_err = lambda r: float(np.linalg.norm(r.frame_poses[-3:, :3] - gt[-3:, :3],
                                              axis=-1).max())
    # the largest keyframe quaternion's distance from unit norm
    q_drift = lambda r: float(np.abs(np.linalg.norm(
        np.asarray(r.keyframe_poses, np.float64)[:, 3:7], axis=-1) - 1).max())
    post = post_err(res)
    # what the window of 2 costs this scene: the same run unpaged and unwindowed
    fres = run_paged_reloc(dev, engine_cfg("base", edge_buffer=64),
                           "base, unpaged, no window", budget=0, hw=hw)[0]
    # the checkpoint of the paged store
    path = work / "paged.npz"
    t0 = time.perf_counter()
    save_state(path, slam)
    save_s = time.perf_counter() - t0
    fresh = SLAM(slam.model, slam.cfg, slam.img_hw, keyframe_buffer=32, device=dev)
    load_state(path, fresh)
    n = len(kf)
    ck_same = bool(len(fresh.keyframes) == n
                   and torch.equal(fresh.keyframes.T_WC[:n], kf.T_WC[:n])
                   and all(np.array_equal(fresh.keyframes.pointmap_np(i)[0],
                                          kf.pointmap_np(i)[0]) for i in range(n)))
    path.unlink()
    out = dict(n_keyframes=res.n_keyframes, control_n_keyframes=cres.n_keyframes,
               n_reloc=res.n_reloc, control_n_reloc=cres.n_reloc,
               n_reloc_success=res.n_reloc_success, dcap=kf.dcap, keep_recent=kf.keep_recent,
               n_evictions=kf.n_evictions, brought_back=back,
               n_edges_recycled=slam.graph.n_edges_recycled,
               vs_control_max_abs=d, vs_control_same_bits=same, post_reloc_err_m=post,
               kf_quat_norm_drift=q_drift(res),
               no_window_post_reloc_err_m=post_err(fres),
               no_window_n_reloc_success=fres.n_reloc_success,
               checkpoint_same_bits=ck_same, checkpoint_save_s=save_s,
               device_bytes=kf.device_bytes(), control_device_bytes=cslam.keyframes.device_bytes(),
               launches=counts)
    log(f"10b paged reloc (base): {json.dumps(out)}")
    if not (res.n_keyframes == cres.n_keyframes and res.n_reloc == cres.n_reloc >= 1
            and res.n_reloc_success == cres.n_reloc_success >= 1
            and d <= PAGING_POSE_ATOL and kf.n_evictions > 0 and back and ck_same
            and kf.X.shape[0] == kf.dcap == RELOC_BUDGET
            and post < RELOC_BOUND_M and post_err(fres) < RELOC_BOUND_M
            and q_drift(res) < QUAT_DRIFT_MAX
            and counts["ivf_hamming"] > 0 and counts["refine_window"] > 0):
        raise AssertionError(f"10b paged reloc against its unpaged control: {json.dumps(out)} "
                             f"(the control's keyframes and relocalisations, poses within "
                             f"{PAGING_POSE_ATOL}, an evicted target brought back, the pool "
                             f"at {RELOC_BUDGET} slots, the checkpoint's poses bit for bit, "
                             f"the last frames within {RELOC_BOUND_M} m, windowed or not, "
                             f"quaternions within {QUAT_DRIFT_MAX} of unit norm)")
    sres, sslam, _, sback, _ = run_paged_reloc(
        dev, engine_cfg("speed", single_thread=False, edge_buffer=64), "speed, paged", hw=hw)
    # the threaded backend's timing differs run to run: a control, not the same bits
    scres = run_paged_reloc(dev, engine_cfg("speed", single_thread=False, edge_buffer=64),
                            "speed, unpaged control", budget=0, window=kf.keep_recent,
                            hw=hw)[0]
    out["speed"] = dict(n_reloc=sres.n_reloc, n_reloc_success=sres.n_reloc_success,
                        n_keyframes=sres.n_keyframes, n_evictions=sslam.keyframes.n_evictions,
                        brought_back=sback, post_reloc_err_m=post_err(sres),
                        kf_quat_norm_drift=q_drift(sres),
                        mode=sslam.mode.name, control_n_reloc=scres.n_reloc,
                        control_n_reloc_success=scres.n_reloc_success,
                        control_n_keyframes=scres.n_keyframes,
                        control_post_reloc_err_m=post_err(scres))
    log(f"10b paged reloc (speed): {json.dumps(out['speed'])}")
    if not (sres.n_reloc_success >= 1 and sslam.keyframes.n_evictions > 0 and sback
            and sslam.keyframes.dcap == RELOC_BUDGET
            and out["speed"]["post_reloc_err_m"] < RELOC_BOUND_M
            and out["speed"]["control_post_reloc_err_m"] < RELOC_BOUND_M
            and q_drift(sres) < QUAT_DRIFT_MAX):
        raise AssertionError(f"10b paged reloc under speed: {json.dumps(out['speed'])}")
    return out


def run_strided_task(dev, model, kf, hw=(384, 512)):
    """10c: one backend task with local_opt.pixel_stride 2 on phase 6's
    ViT-L keyframes (add_factors([1], [2]) + solve), the launch counters
    reset just before and read just after; the refine launch's inputs kept
    and the kernel held exactly against its plain version on them, then
    timed, with its shared-window share and its bound."""
    import torch
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.ops import matching, refine
    from mast3r_slam_tpu_torch.slam import factor_graph as fg

    cfg = load_config("base")
    cfg["local_opt"]["pixel_stride"] = 2
    graph = fg.FactorGraph(model, cfg, kf, hw, edge_capacity=16)
    frac = cfg["local_opt"]["min_match_frac"]
    seen = []
    real = matching.refine_window

    def keep(*a):
        out = real(*a)
        seen.append((a, out))
        return out

    with swapped(matching, "refine_window", keep):
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        added = graph.add_factors([1], [2], frac)
        graph.solve()
        sync(dev)
        task_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
    if len(seen) != 1:
        raise AssertionError(f"10c: {len(seen)} refine calls in the strided task")
    (d11q, d21q, idx, H, W, radius, sched), got = seen[0]
    want = refine.refine_window_plain(d11q, d21q, idx, H, W, radius, sched)
    n_diff = int((got != want).sum().item())
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    again = refine.refine_window_cuda(d11q, d21q, idx, H, W, radius, sched, stats=stats)
    sync(dev)
    whole, pairs, px_win, px_all = stats.tolist()
    times = time_kernel(lambda: refine.refine_window(d11q, d21q, idx, H, W, radius, sched),
                        lambda: refine.refine_window_plain(d11q, d21q, idx, H, W, radius,
                                                           sched), plain_iters=3)
    n_rows, n_cand = refine_work(idx, H, W, radius, sched, d11q, d21q)
    F = d11q.shape[-1]
    nbytes = n_rows * F + d21q.numel() + idx.numel() * 4 * 2
    t_ops, t_bytes = 2.0 * F * n_cand / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    valid = graph.valid_match_j[0, :, 0]
    grid = torch.zeros_like(valid)
    grid[fg._strided_rows(hw, 2, dev).long()] = True
    out = dict(added=added, task_ms=task_ms, launches=counts, n=int(idx.shape[1]),
               B=int(idx.shape[0]), schedule=list(sched), radius=radius,
               max_abs_err=n_diff, same_as_second_launch=bool(torch.equal(got, again)),
               pairs_shared=whole / pairs, pixel_levels_shared=px_win / px_all,
               rows_touched=n_rows, candidates=n_cand, **times,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               off_grid_valid=int((valid & ~grid).sum().item()),
               poses_finite=bool(torch.isfinite(kf.T_WC[:3]).all()))
    log(f"10c strided ViT-L backend task (pixel_stride 2): {json.dumps(out)}")
    want_fixed = {"attention": 48, "refine_window": 1}
    if ({k: counts[k] for k in want_fixed} != want_fixed or counts["edge_hg_rays"] < 1
            or n_diff or not out["same_as_second_launch"] or not added
            or out["off_grid_valid"] or not out["poses_finite"]
            or idx.shape[1] != (H // 2) * (W // 2)):
        raise AssertionError(f"10c strided task: {json.dumps(out)} (expected {want_fixed} "
                             f"and edge_hg_rays >= 1, refine exact on the task's inputs)")
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 11: serving
# ---------------------------------------------------------------------------

SERVE_FRAMES = 12          # 11b: frames of the ViT-L session (480x640 PNG)
SERVE_SAMPLE_HW = (480, 640)
REPO = pathlib.Path(__file__).resolve().parent


def check_jpeg_fixture():
    """11a: the committed baseline 4:2:0 JPEG decoded by the host library's
    decoder, against the committed cv2 decode of the same bytes (this host
    has no cv2), exactly; the decode timed."""
    from mast3r_slam_tpu_torch.data.png import read_png
    from mast3r_slam_tpu_torch.utils import native

    data = (REPO / "tests" / "data" / "serve_frame.jpg").read_bytes()
    want = read_png(REPO / "tests" / "data" / "serve_frame_cv2.png")
    got = native.decode_jpeg(data)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        native.decode_jpeg(data)
        times.append((time.perf_counter() - t0) * 1e3)
    out = dict(shape=list(got.shape), exact=bool(np.array_equal(got, want)),
               max_abs_diff=int(np.abs(got.astype(int) - want).max()),
               decode_ms_p50=statistics.median(times))
    log(f"11a JPEG fixture {got.shape[1]}x{got.shape[0]} 4:2:0: {json.dumps(out)}")
    if not out["exact"]:
        raise AssertionError(f"11a: the JPEG decoder differs from cv2's decode: {out}")
    return out


def serve_images(dev, n, seed=11):
    """Phase 4's smooth random images at 480x640 as uint8 RGB frames."""
    imgs = smooth_images(n, SERVE_SAMPLE_HW, dev, seed)
    u8 = ((imgs + 1) * 127.5).round().clamp(0, 255).to(dtype=__import__("torch").uint8)
    return [u8[i].permute(1, 2, 0).contiguous().cpu().numpy() for i in range(n)]


def http_json(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read().decode())


async def stream_session(port, frames_b64, listing_after=2, refused=()):
    """One client session through the port's WebSocket client: GET / and
    /connect, /ws/{id}, then each frame sent after the previous frame's
    pose_update arrived (send -> pose_update timed on the client), a look
    at /active_sessions, close, and every event up to shutdown_complete.
    A frame whose index is in ``refused`` must be answered by an error
    event, and the session goes on; an error for any other frame ends the
    sending.  Returns (session id, events, latencies ms of the frames
    answered by a pose, raw keyframe event sizes, the listing)."""
    import asyncio

    from mast3r_slam_tpu_torch.serve import ws

    loop = asyncio.get_running_loop()
    base = f"http://127.0.0.1:{port}"
    root = await loop.run_in_executor(None, http_json, base + "/")
    sid = (await loop.run_in_executor(None, http_json, base + "/connect"))["sessionId"]
    events, lat, kf_bytes, listing = [], [], [], None
    async with ws.connect(f"ws://127.0.0.1:{port}/ws/{sid}") as sock:

        async def next_event():
            raw = await asyncio.wait_for(sock.recv(), 300)
            ev = json.loads(raw)
            if ev["type"] == "new_keyframe":
                kf_bytes.append(len(raw))
            events.append(ev)
            return ev

        await next_event()
        for i, data in enumerate(frames_b64):
            t0 = time.perf_counter()
            await sock.send(json.dumps({"type": "frame", "data": data, "timestamp": str(i)}))
            while True:
                ev = await next_event()
                if ev["type"] == "pose_update" or ev["type"] == "error":
                    break
            if ev["type"] != "error" or i not in refused:
                lat.append((time.perf_counter() - t0) * 1e3)
                if ev["type"] == "error":
                    break
            if i + 1 == listing_after:
                listing = await loop.run_in_executor(None, http_json, base + "/active_sessions")
        await sock.send(json.dumps({"type": "close"}))
        while events[-1]["type"] != "shutdown_complete":
            await next_event()
    return dict(root=root, sid=sid, events=events, latency_ms=lat, kf_bytes=kf_bytes,
                listing=listing)


def serve_cfg():
    """``base`` single threaded (the session's poses then have one
    schedule, held bit for bit against a control) with phase 9b's pinned
    decisions: every tracked frame commits a keyframe and runs a backend
    task."""
    from mast3r_slam_tpu_torch.config import load_config, merge_config
    from mast3r_slam_tpu_torch.slam import run

    def refuse(msg):
        raise ValueError(msg)

    cfg = load_config("base")
    cfg["single_thread"] = True
    for patch in run.parse_overrides(CLI_VITL_SET, refuse):
        cfg = merge_config(cfg, patch)
    return cfg


def check_session_events(out, n, n_keyframes, n_refused=0):
    """The protocol of one finished session, as a list of faults;
    ``n_refused`` frames must each have been dropped with an error event."""
    ev = out["events"]
    types = [e["type"] for e in ev]
    faults = []
    if ev[0] != {"type": "ready", "session_id": out["sid"]}:
        faults.append(f"first event {ev[0]}")
    poses = [e["frame_id"] for e in ev if e["type"] == "pose_update"]
    if poses != list(range(n)):
        faults.append(f"pose_update frame ids {poses}")
    kfs = [e for e in ev if e["type"] == "new_keyframe"]
    if (len(kfs) != n_keyframes
            or any(not e["points"] or len(e["points"]) != len(e["colors"]) for e in kfs)):
        faults.append(f"{len(kfs)} new_keyframe events for {n_keyframes} keyframes, points/"
                      f"colours {[(len(e['points']), len(e['colors'])) for e in kfs]}")
    if n >= 10 and "fps_update" not in types:
        faults.append("no fps_update")
    errors = [e for e in ev if e["type"] == "error"]
    if len(errors) != n_refused or any(not e["message"].startswith("frame dropped")
                                       for e in errors):
        faults.append(f"errors {errors} ({n_refused} frames to be dropped)")
    end = ev[-1]
    if end != {"type": "shutdown_complete", "n_keyframes": n_keyframes, "n_frames": n}:
        faults.append(f"last event {end}")
    return faults


def run_serve_vitl(dev, work, n_frames=SERVE_FRAMES, preset="vit_large", payloads=None,
                   label="11b", what="480x640 PNG", refused=None):
    """11b: one ViT-L session at 384x512 through SlamServer on 127.0.0.1
    (port 0, read back), frames of 480x640 as base64 PNG from the port's
    writer (or the base64 ``payloads`` given, ``what`` naming them), with
    the launch counters reset just before the session and read just after;
    then a control that feeds the same decoded frames to
    SLAM.process_frame on a fresh engine from the same factory, without the
    server.  ``refused`` maps a position in the sending order to a payload
    the server must drop with an error event.  Returns a dict of checks,
    counts and times."""
    import asyncio
    import base64

    import torch
    from mast3r_slam_tpu_torch.data.png import encode_png
    from mast3r_slam_tpu_torch.eval.export import load_ply
    from mast3r_slam_tpu_torch.eval.trajectory import load_traj_tum
    from mast3r_slam_tpu_torch.serve import server

    cfg = serve_cfg()
    factory = server.default_slam_factory(cfg=cfg, preset=preset, device=dev)
    built = []

    def keep(raw_hw):
        slam = factory(raw_hw)
        built.append(slam)
        return slam

    if payloads is None:
        frames = [base64.b64encode(encode_png(img)).decode()
                  for img in serve_images(dev, n_frames)]
    else:
        frames, n_frames = list(payloads), len(payloads)
    srv = server.SlamServer(keep, host="127.0.0.1", port=0, output_dir=work / "sessions")
    sent = list(frames)
    for at in sorted(refused or {}):
        sent.insert(at, refused[at])

    async def session():
        await srv.listen()
        try:
            return await stream_session(srv.bound_port, sent, refused=set(refused or {}))
        finally:
            await srv.aclose()

    reset_counts()
    t0 = time.perf_counter()
    out = asyncio.run(session())
    wall = time.perf_counter() - t0
    counts = read_counts()
    slam = built[0]
    st = slam.timer.stats()
    n_kf = len(slam.keyframes)
    n_tasks = st.get("backend.update", {"count": 0})["count"]
    n_tracked = st.get("tracker.track", {"count": 0})["count"]
    faults = check_session_events(out, n_frames, n_kf, len(refused or {}))
    if [s["session_id"] for s in (out["listing"] or {}).get("sessions", [])] != [out["sid"]]:
        faults.append(f"/active_sessions {out['listing']}")
    saved = {e["type"]: pathlib.Path(e["path"]) for e in out["events"]
             if e["type"].endswith("_saved")}
    traj_rows = ply_points = None
    try:
        traj_rows = len(load_traj_tum(saved["trajectory_saved"])[0])
        ply_points = len(load_ply(saved["reconstruction_saved"])[0])
    except (KeyError, OSError, ValueError) as e:
        faults.append(f"exports {saved}: {e!r}")

    # the control: the same decoded frames straight into a fresh engine
    decoded = [server.decode_image_payload(f) for f in frames]
    control = factory(decoded[0].shape[:2])
    last = None
    for i, rgb in enumerate(decoded):
        last = control.process_frame(i, str(i), rgb, last_T_WC=last).T_WC
    control.join_backend()
    control.graph.resolve_pending_verdicts()
    sync(dev)
    same_bits = (len(control.keyframes) == n_kf
                 and torch.equal(control.keyframes.T_WC[:n_kf], slam.keyframes.T_WC[:n_kf])
                 and np.array_equal(np.stack([p for _, p in control.frame_log]),
                                    np.stack([p for _, p in slam.frame_log])))
    control.close()
    lat = out["latency_ms"]
    res = dict(frames=n_frames, n_keyframes=n_kf, n_tracked=n_tracked, n_tasks=n_tasks,
               launches=counts, same_bits_as_control=bool(same_bits), faults=faults,
               latency_ms_p50=statistics.median(lat),
               latency_ms_p95=float(np.percentile(lat, 95)), latency_ms=lat,
               keyframe_event_bytes_mean=statistics.mean(out["kf_bytes"]) if out["kf_bytes"]
               else None, keyframe_event_points=[len(e["points"]) for e in out["events"]
                                                 if e["type"] == "new_keyframe"],
               session_wall_s=wall, traj_rows=traj_rows, ply_points=ply_points,
               event_counts={t: sum(e["type"] == t for e in out["events"])
                             for t in sorted({e["type"] for e in out["events"]})},
               errors=[e["message"] for e in out["events"] if e["type"] == "error"],
               stages={k: {m: v[m] for m in ("mean_ms", "p50_ms", "count")}
                       for k, v in st.items()})
    log(f"{label} session ({preset}, {slam.img_hw[0]}x{slam.img_hw[1]} from {what}, "
        f"{n_frames} frames): {json.dumps(res)}")
    return res


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_viz_ws(dev, root, img_size=512):
    """11c: ``slam.run --viz-ws PORT`` (a free port found first) with phase
    9a's stand-in over its TUM sequence, every tracked frame a keyframe. A
    first viewer joins as the broadcaster starts and pauses the run once it
    has seen the second keyframe; once the run is quiet a late viewer joins
    and must receive every keyframe event so far as replay, then raises
    the confidence threshold, steps one frame (received live) and
    terminates the run.  Returns a dict of checks."""
    import asyncio
    import threading

    from mast3r_slam_tpu_torch.data import dataloader
    from mast3r_slam_tpu_torch.eval.export import load_ply, save_reconstruction
    from mast3r_slam_tpu_torch.serve import broadcast, ws
    from mast3r_slam_tpu_torch.slam import run

    gt = arc_trajectory(CLI_RAW_FRAMES, radius=0.8, max_angle=3.0)
    seq = root / TUM_SEQ
    if not seq.exists():
        write_tum_sequence(root, gt, CLI_RAW_FRAMES)
    port = free_port()
    seen, state, built = [], {}, []
    real_start = broadcast.EventBroadcaster.start

    def start_with_viewer(self):
        real_start(self)
        state["b"] = self

        async def watcher():
            async with ws.connect(f"ws://127.0.0.1:{self.bound_port}") as sock:
                async for raw in sock:
                    ev = json.loads(raw)
                    seen.append((time.perf_counter(), ev))
                    kfs = sum(e["type"] == "new_keyframe" for _, e in seen)
                    if kfs == 2 and "paused_at" not in state:
                        state["paused_at"] = len(seen)
                        await sock.send(json.dumps({"type": "control", "paused": True}))

        th = threading.Thread(target=lambda: asyncio.run(watcher()), daemon=True)
        th.start()
        state["watcher"] = th
        deadline = time.time() + 60
        while not self._clients and time.time() < deadline:
            time.sleep(0.01)
        return self

    def late_viewer():
        # wait for the pause, then for quiet (the frame in flight finished)
        deadline = time.time() + 120
        while time.time() < deadline and not (
                "paused_at" in state and seen and time.perf_counter() - seen[-1][0] > 2.0):
            time.sleep(0.05)
        before = [e for _, e in seen if e["type"] == "new_keyframe"]
        n_before = len([e for _, e in seen if e["type"] == "pose_update"])

        async def late():
            async with ws.connect(f"ws://127.0.0.1:{state['b'].bound_port}") as sock:
                replay = [json.loads(await asyncio.wait_for(sock.recv(), 60))
                          for _ in range(len(before))]
                await sock.send(json.dumps({"type": "control", "conf_threshold": 3.0}))
                await sock.send(json.dumps({"type": "control", "step": True}))
                live = []
                while not live or live[-1]["type"] != "pose_update":
                    live.append(json.loads(await asyncio.wait_for(sock.recv(), 60)))
                await sock.send(json.dumps({"type": "control", "terminate": True}))
                await asyncio.sleep(0.2)
                return replay, live

        replay, live = asyncio.run(late())
        state.update(replay_ok=replay == before, replayed=len(replay),
                     poses_before_step=n_before, live=[e["type"] for e in live])

    def build(cfg, dataset, **kw):
        slam = standin(cfg, dataset, **kw)
        built.append(slam)
        threading.Thread(target=late_viewer, daemon=True).start()
        return slam

    standin = standin_builder(gt, dev, [])
    argv = ["--dataset", str(seq), "--config", "eval_no_calib", "--device", str(dev),
            "--save-as", "viz_ws", "--viz-ws", str(port),
            "--set", "tracking.match_frac_thresh=2.0"]
    with swapped(run, "build_slam", build), \
            swapped(dataloader.MonocularDataset, "img_size", img_size), \
            swapped(broadcast.EventBroadcaster, "start", start_with_viewer):
        t0 = time.perf_counter()
        res = run.main(argv)
        wall = time.perf_counter() - t0
    state["watcher"].join(30)
    slam = built[0]
    ply = pathlib.Path("logs") / "viz_ws" / f"{TUM_SEQ}.ply"
    exported = len(load_ply(ply)[0])
    # the same export at the threshold a viewer starts from
    save_reconstruction(ply.with_name("default_threshold.ply"), slam.keyframes, slam.img_hw,
                        conf_threshold=broadcast.RunControl().conf_threshold)
    default = len(load_ply(ply.with_name("default_threshold.ply"))[0])
    n_seq = CLI_RAW_FRAMES // 2
    out = dict(port=port, bound_port=state["b"].bound_port, frames=len(res.frame_timestamps),
               sequence_frames=n_seq, n_keyframes=res.n_keyframes,
               replay_ok=state.get("replay_ok"), replayed=state.get("replayed"),
               poses_before_step=state.get("poses_before_step"), live=state.get("live"),
               ply_points=exported, ply_points_default_threshold=default,
               conf_threshold=slam.control.conf_threshold, wall_s=wall,
               broadcaster_stopped=not state["b"]._thread.is_alive(),
               watcher_done=not state["watcher"].is_alive())
    log(f"11c --viz-ws {port}, stand-in over {TUM_SEQ}: {json.dumps(out)}")
    return out


def run_two_sessions(dev, work, raw_hw=SERVE_SAMPLE_HW, size=512):
    """11d: two stand-in sessions on one SlamServer at once: A streams its
    frames and closes; B sends two frames and goes quiet, and the reaper
    (an idle timeout of 3 s, checked every half second) terminates it.  Each
    client must see only its own session's events."""
    import asyncio
    import base64

    from mast3r_slam_tpu_torch.data.png import encode_png
    from mast3r_slam_tpu_torch.serve import server, ws
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM

    from mast3r_slam_tpu_torch.utils.image import resize_geometry

    n_a = 8
    gt = arc_trajectory(n_a, radius=0.6, max_angle=2.0)
    cfg = engine_cfg("base")
    cfg["engine"]["resize"] = size
    _, (x0, y0, x1, y1) = resize_geometry(raw_hw[1], raw_hw[0], size)
    hw = (y1 - y0, x1 - x0)

    def factory(frame_hw):
        return SLAM(PlaneSceneModel(hw, gt, dev), cfg, hw, device=dev)

    frames = [base64.b64encode(encode_png(np.full(raw_hw + (3,), i + 1, np.uint8))).decode()
              for i in range(n_a)]
    srv = server.SlamServer(factory, host="127.0.0.1", port=0, output_dir=work / "two",
                            idle_timeout=3.0, reap_interval=0.5)

    async def quiet_b(port):
        sid = (await asyncio.get_running_loop().run_in_executor(
            None, http_json, f"http://127.0.0.1:{port}/connect"))["sessionId"]
        events = []
        async with ws.connect(f"ws://127.0.0.1:{port}/ws/{sid}") as sock:
            events.append(json.loads(await sock.recv()))
            for i in range(2):
                await sock.send(json.dumps({"type": "frame", "data": frames[i]}))
            t0 = time.perf_counter()
            while not events or events[-1]["type"] != "shutdown_complete":
                events.append(json.loads(await asyncio.wait_for(sock.recv(), 120)))
        return sid, events, time.perf_counter() - t0

    async def both():
        await srv.listen()
        try:
            return await asyncio.gather(stream_session(srv.bound_port, frames, listing_after=1),
                                        quiet_b(srv.bound_port))
        finally:
            await srv.aclose()

    a, (b_sid, b_events, b_wait) = asyncio.run(both())
    a_ids = {e.get("session_id") for e in a["events"] if e["type"] == "ready"}
    out = dict(a_frames=sum(e["type"] == "pose_update" for e in a["events"]),
               a_pose_ids=[e["frame_id"] for e in a["events"] if e["type"] == "pose_update"],
               b_frames=sum(e["type"] == "pose_update" for e in b_events),
               b_last=b_events[-1], a_last=a["events"][-1],
               separate=a_ids == {a["sid"]} and b_events[0]["session_id"] == b_sid != a["sid"],
               reaped=[list(r) for r in srv.reaped], b_sid=b_sid, b_reaped_after_s=b_wait,
               a_errors=[e for e in a["events"] if e["type"] == "error"])
    log(f"11d two sessions (stand-in, {hw[0]}x{hw[1]}): {json.dumps(out)}")
    return out


def run_serving(dev, work, smi):
    """Phase 11 (a)-(d), each checked; raises on any fault."""
    jpeg = check_jpeg_fixture()
    serve = run_serve_vitl(dev, work)
    sc = serve["launches"]
    want_s = {"attention": 72 * serve["frames"] + 48 * serve["n_tasks"],
              "refine_window": serve["n_tracked"] + serve["n_tasks"]}
    if (serve["faults"] or not serve["same_bits_as_control"]
            or {k: sc[k] for k in want_s} != want_s
            or serve["n_tasks"] != serve["frames"] - 1 or sc["edge_hg_rays"] < serve["n_tasks"]
            or serve["traj_rows"] != serve["n_keyframes"] or not serve["ply_points"]):
        raise AssertionError(
            f"11b ViT-L session: faults {serve['faults']}, the control's bits "
            f"{serve['same_bits_as_control']}, launches {sc} (expected {want_s}: 72 attention a "
            f"frame and 48 a backend task, one refine a tracked frame and a task; edge_hg_rays "
            f">= {serve['n_tasks']} tasks = frames - 1), exports {serve['traj_rows']} rows, "
            f"{serve['ply_points']} points")
    log(f"11b ViT-L session 384x512, {serve['frames']} frames: send -> pose_update p50 "
        f"{serve['latency_ms_p50']:.1f} ms, p95 {serve['latency_ms_p95']:.1f} ms (client host "
        f"clock), new_keyframe event {serve['keyframe_event_bytes_mean']:.0f} bytes, session "
        f"{serve['session_wall_s']:.2f} s; {smi}")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        viz = run_viz_ws(dev, work)
    finally:
        os.chdir(cwd)
    if not (viz["replay_ok"] and viz["replayed"] >= 2 and viz["bound_port"] == viz["port"]
            and viz["live"] and viz["live"][-1] == "pose_update"
            and viz["frames"] == viz["poses_before_step"] + 1
            and viz["frames"] < viz["sequence_frames"]
            and viz["ply_points"] != viz["ply_points_default_threshold"]
            and viz["conf_threshold"] == 3.0 and viz["broadcaster_stopped"]
            and viz["watcher_done"]):
        raise AssertionError(f"11c --viz-ws: {json.dumps(viz)} (a late viewer gets every "
                             f"earlier keyframe as replay, then a stepped frame live; the "
                             f"threshold changes the PLY; terminate ends the run early)")
    two = run_two_sessions(dev, work)
    if not (two["separate"] and two["a_pose_ids"] == list(range(8)) and two["b_frames"] == 2
            and two["b_last"]["type"] == "shutdown_complete" and two["b_last"]["n_frames"] == 2
            and two["reaped"] == [[two["b_sid"], False]] and not two["a_errors"]
            and two["a_last"]["n_frames"] == 8):
        raise AssertionError(f"11d two sessions: {json.dumps(two)} (separate streams, 8 and 2 "
                             f"frames, the idle one reaped and not wedged)")
    return jpeg, serve, viz, two


# ---------------------------------------------------------------------------
# phase 12: image input on the card's host
# ---------------------------------------------------------------------------

IMAGE_DATA = REPO / "tests" / "data"
CLOSE_QUEUE = 8            # 12d: frames queued behind the blocked engine


def image_kind(path) -> str:
    """"baseline", "progressive", "arithmetic", "arithmetic-progressive" or
    "lossless" JPEG, or "png", by the file's bytes (its frame marker)."""
    data = pathlib.Path(path).read_bytes()
    if data.startswith(b"\x89PNG"):
        return "png"
    head = data[:data.index(b"\xff\xda")]
    for marker, kind in ((b"\xff\xc2", "progressive"), (b"\xff\xc9", "arithmetic"),
                         (b"\xff\xca", "arithmetic-progressive"), (b"\xff\xc3", "lossless")):
        if marker in head:
            return kind
    return "baseline"


def check_image_fixtures():
    """12a: every committed image fixture (tests/data/image_fixtures.json:
    the small progressive, 16-bit, palette and Adam7 files, the CLI folder,
    the served frames) read by the port's readers, its SHA-256 against the
    committed digest of cv2's decode of it (this host has no cv2); then
    the read of each frame of the CLI folder timed by kind (host clock,
    median of 5 reads of each frame)."""
    import hashlib

    from mast3r_slam_tpu_torch.data import png

    digests = json.loads((IMAGE_DATA / "image_fixtures.json").read_text())
    bad = []
    for name, want in sorted(digests.items()):
        if want["sha256"] is None:  # cv2 returns nothing for the colour read
            try:
                png.imread_rgb(IMAGE_DATA / name)
                bad.append(name)
            except ValueError:
                pass
            continue
        img = png.imread_rgb(IMAGE_DATA / name)
        if (list(img.shape) != want["shape"]
                or hashlib.sha256(img.tobytes()).hexdigest() != want["sha256"]):
            bad.append(name)
    ms = {}
    for path in sorted((IMAGE_DATA / "image_folder").iterdir()):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            png.imread_rgb(path)
            times.append((time.perf_counter() - t0) * 1e3)
        ms.setdefault(image_kind(path), []).append(statistics.median(times))
    out = dict(files=len(digests), exact=len(digests) - len(bad), differ=bad,
               read_ms={k: statistics.median(v) for k, v in ms.items()},
               frames_by_kind={k: len(v) for k, v in ms.items()})
    log(f"12a image fixtures: {json.dumps(out)}")
    if bad:
        raise AssertionError(f"12a: the port's readers differ from cv2's decode on {bad}")
    return out


def run_cli_images(dev, work, preset="vit_large", img_size=512):
    """12b: ViT-L through the CLI (random weights, seed 0, 9b's pinned
    decisions, every frame read: subsample 1) over the committed folder of
    8 frames at 480x640 (baseline and progressive JPEGs, a palette Adam7
    PNG), then over 8-bit RGB PNG copies of its decoded frames written by
    the port's writer, the control; launch counters reset just before each
    run and read just after.  The pins cannot keep the tracking GN from
    failing on random weights over textured frames, so some frames go to
    relocalisation (no database: they only encode) and not every frame
    runs a backend task.  Returns a dict of counts, stages and checks."""
    from mast3r_slam_tpu_torch.data import dataloader, png
    from mast3r_slam_tpu_torch.slam import run

    folder = IMAGE_DATA / "image_folder"
    control = work / "image_folder_png"
    shutil.rmtree(control, ignore_errors=True)
    files = dataloader.RGBFiles(folder).rgb_files
    for f in files:
        png.write_png(control / f"{pathlib.Path(f).stem}.png", png.imread_rgb(f))
    argv = ["--config", "eval_no_calib", "--device", str(dev), "--max-frames",
            str(CLI_VITL_FRAMES), "--model-preset",
            "vit_large" if preset == "vit_large" else "tiny", "--set", "dataset.subsample=1"]
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
        res, counts, wall = run_cli(["--dataset", str(folder), "--save-as", "images"] + argv)
        st = built[-1].timer.stats()
        del built[:]
        res2, counts2, wall2 = run_cli(["--dataset", str(control), "--save-as", "images_png"]
                                       + argv)
        st2 = built[-1].timer.stats()
        del built[:]
    same_bits = (np.array_equal(res.frame_poses, res2.frame_poses)
                 and np.array_equal(res.keyframe_poses, res2.keyframe_poses)
                 and res.keyframe_timestamps == res2.keyframe_timestamps)
    out = dict(frames=len(res.frame_timestamps), kinds=[image_kind(f) for f in files],
               n_keyframes=res.n_keyframes,
               n_tracked=st.get("tracker.track", {"count": 0})["count"],
               n_tasks=st.get("backend.update", {"count": 0})["count"], n_reloc=res.n_reloc,
               fps=res.fps, control_fps=res2.fps, wall_s=wall, control_wall_s=wall2,
               launches=counts, control_launches=counts2, same_bits=bool(same_bits),
               ingest_ms_p50=st["ingest"]["p50_ms"], control_ingest_ms_p50=st2["ingest"]["p50_ms"],
               stages={k: {m: v[m] for m in ("mean_ms", "p50_ms", "count")} for k, v in st.items()})
    log(f"12b CLI ({preset}, {len(files)} frames of the image folder, decisions pinned open) "
        f"{img_size}: {json.dumps(out)}")
    return out


def run_served_images(dev, work, size=512):
    """12c: one stand-in session (phase 9a's model) over the port's
    WebSocket client, its payloads the committed served frames:
    progressive JPEGs and 16-bit PNGs of 480x640 in turn; then a control
    that feeds the same decoded frames to SLAM.process_frame on a fresh
    engine, for the same pose bits."""
    import asyncio
    import base64

    import torch
    from mast3r_slam_tpu_torch.serve import server
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM
    from mast3r_slam_tpu_torch.utils.image import resize_geometry

    paths = sorted((IMAGE_DATA / "serve_frames").iterdir())
    frames = [base64.b64encode(p.read_bytes()).decode() for p in paths]
    gt = arc_trajectory(len(frames), radius=0.6, max_angle=2.0)
    cfg = engine_cfg("base")
    cfg["engine"]["resize"] = size
    _, (x0, y0, x1, y1) = resize_geometry(*SERVE_SAMPLE_HW[::-1], size)
    hw = (y1 - y0, x1 - x0)
    built = []

    def factory(frame_hw):
        built.append(SLAM(TumSceneModel(hw, gt, dev), cfg, hw, device=dev))
        return built[-1]

    srv = server.SlamServer(factory, host="127.0.0.1", port=0, output_dir=work / "served")

    async def session():
        await srv.listen()
        try:
            return await stream_session(srv.bound_port, frames)
        finally:
            await srv.aclose()

    out = asyncio.run(session())
    slam = built[0]
    n_kf = len(slam.keyframes)
    faults = check_session_events(out, len(frames), n_kf)
    decoded = [server.decode_image_payload(f) for f in frames]
    control = factory(decoded[0].shape[:2])
    last = None
    for i, rgb in enumerate(decoded):
        last = control.process_frame(i, str(i), rgb, last_T_WC=last).T_WC
    control.join_backend()
    sync(dev)
    same_bits = (len(control.keyframes) == n_kf
                 and torch.equal(control.keyframes.T_WC[:n_kf], slam.keyframes.T_WC[:n_kf])
                 and np.array_equal(np.stack([p for _, p in control.frame_log]),
                                    np.stack([p for _, p in slam.frame_log])))
    control.close()
    res = dict(frames=len(frames), kinds=[image_kind(p) if p.suffix == ".jpg" else "png16"
                                          for p in paths],
               n_keyframes=n_kf, faults=faults, same_bits_as_control=bool(same_bits),
               levels=[int(round(float(d.mean()) * 255)) for d in decoded],
               latency_ms_p50=statistics.median(out["latency_ms"]))
    log(f"12c served progressive JPEG and 16-bit PNG frames (stand-in, {hw[0]}x{hw[1]}): "
        f"{json.dumps(res)}")
    return res


class GatedEngine:
    """12d: a stand-in engine whose process_frame waits for ``gate``."""

    def __init__(self, gate):
        self.gate = gate
        self.done = []
        self.on_event = None
        self.keyframes = []
        self.backend_errors = []
        self.graph = type("Graph", (), {"resolve_pending_verdicts": lambda self: None})()

    def process_frame(self, fid, ts, rgb, last_T_WC=None):
        self.gate.wait(60)
        self.done.append(fid)
        return type("Frame", (), {"T_WC": None})()

    def join_backend(self):
        pass

    def close(self):
        pass


def check_session_close(timeout=1.0):
    """12d: a session whose engine is blocked inside a frame with
    CLOSE_QUEUE frames queued behind it: close() returns at once, and
    terminate(timeout) returns False within timeout + 1 s with the session
    marked wedged (ROADMAP Queue 3 item 14); released, the engine thread
    ends without the queued frames."""
    import threading

    from mast3r_slam_tpu_torch.serve import server

    gate = threading.Event()
    engines = []
    s = server.SlamSession(lambda hw: engines.append(GatedEngine(gate)) or engines[-1],
                           max_queue=CLOSE_QUEUE)
    s.start()
    s.submit_frame(np.zeros((4, 4, 3), np.float32))
    deadline = time.time() + 30
    while not engines and time.time() < deadline:
        time.sleep(0.01)
    for _ in range(CLOSE_QUEUE):
        s.submit_frame(np.zeros((4, 4, 3), np.float32))
    queued = s.frame_q.qsize()
    t0 = time.perf_counter()
    s.close()
    close_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    finished = s.terminate(timeout=timeout)
    terminate_s = time.perf_counter() - t0
    wedged = s.wedged
    gate.set()
    s.thread.join(30)
    out = dict(queued=queued, close_s=close_s, terminate_s=terminate_s, timeout_s=timeout,
               terminate_returned=finished, wedged=wedged, thread_ended=not s.thread.is_alive(),
               frames_done=engines[0].done if engines else None)
    log(f"12d close with a blocked engine and a full queue: {json.dumps(out)}")
    if not (queued == CLOSE_QUEUE and close_s < 1.0 and finished is False
            and terminate_s < timeout + 1.0 and wedged and out["thread_ended"]
            and out["frames_done"] == [0]):
        raise AssertionError(f"12d: {json.dumps(out)} (close under 1 s, terminate False "
                             f"within {timeout} + 1 s, the session wedged)")
    return out


def run_image_input(dev, work, smi):
    """Phase 12 (a)-(d), each checked; raises on any fault."""
    fixtures = check_image_fixtures()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli = run_cli_images(dev, work)
    finally:
        os.chdir(cwd)
    vc = cli["launches"]
    want = {"attention": 72 * cli["frames"] + 48 * cli["n_tasks"],
            "refine_window": cli["n_tracked"] + cli["n_tasks"]}
    if ({k: vc[k] for k in want} != want or cli["n_tasks"] < 1
            or vc["edge_hg_rays"] < cli["n_tasks"] or cli["control_launches"] != vc
            or not cli["same_bits"] or cli["frames"] != CLI_VITL_FRAMES
            or set(cli["kinds"]) != {"baseline", "progressive", "png"}):
        raise AssertionError(
            f"12b CLI over the image folder: launches {vc} (expected {want}: 72 attention a "
            f"frame and 48 a backend task, one refine a tracked frame and a task; edge_hg_rays "
            f">= {cli['n_tasks']} tasks >= 1), PNG control {cli['control_launches']}, "
            f"same trajectory bits {cli['same_bits']}, {cli['frames']} frames of "
            f"{cli['kinds']}")
    served = run_served_images(dev, work)
    if (served["faults"] or not served["same_bits_as_control"]
            or served["levels"] != list(range(1, served["frames"] + 1))):
        raise AssertionError(f"12c served images: {json.dumps(served)}")
    close = check_session_close()
    rm = fixtures["read_ms"]
    log(f"12 ingest a 480x640 frame (host clock): baseline JPEG {rm['baseline']:.2f} ms, "
        f"progressive JPEG {rm['progressive']:.2f} ms, palette Adam7 PNG {rm['png']:.2f} ms "
        f"(decode); the CLI's ingest stage p50 {cli['ingest_ms_p50']:.2f} ms over the folder, "
        f"{cli['control_ingest_ms_p50']:.2f} ms over the RGB PNG control (decode + 512 "
        f"resize); {smi}")
    return fixtures, cli, served, close


# ---------------------------------------------------------------------------
# phase 13: the multi-card backend, on one card
# ---------------------------------------------------------------------------

MESH_SHARDS = (1, 2, 4)       # 13a: shards of the meshes on one card
# a mesh adds the shards' blocks in another f32 order than one device:
# poses read 4.8e-7 from one device on the H100 at 2 and 4 shards
SHARDED_POSE_ATOL = 1e-5
# the summed (H, g, cost) at the first iterate against one device's scatter
# of every edge, relative to each one's norm (read at most 1.1e-7 on the
# CPU at 2-8 shards).  The poses alone cannot show a dropped or doubled
# shard: either direction of the exact two-way edges pins every pose.
SHARDED_BLOCKS_RTOL = 1e-6
# 13b: two processes' engine against one process's, frame poses: a mesh's
# summation order carried through 16 frames of tracking and solves (read 0
# on the H100, the same bits, and 2.7e-6 on the CPU at 48x64; the JAX
# multi-process engine worker's bound)
TWO_PROCESS_POSE_ATOL = 1e-5
TASK_SHARDS = 2               # 13c: shards of the ViT-L backend task


def frozen_sharded(mesh, args):
    """The edge-sharded step under the plain frozen loop (``gn_loop`` without
    its early exit: ``max_iters`` steps, each a shard's blocks and the
    collectives), the loop the sharded route ran before it stopped early."""
    from mast3r_slam_tpu_torch.ops import global_gn as gn
    from mast3r_slam_tpu_torch.parallel import sharded_ba as sb

    Twc, Xs, Cs, ii, jj, idx, valid, Q, K, hw, settings, mode = args
    edges, K_r = sb._shard_fields(mesh, Xs, Cs, ii.long(), jj.long(), idx, valid, Q, K, hw,
                                  settings, mode)
    M = Twc.shape[0] - settings.pin

    def step(T, active):
        H, g, cost = sb._reduce(mesh, T, edges, K_r, hw, settings, mode)
        return sb._solve_dense(H, g, M, settings.pcg_damping) + (cost,)

    return gn.gn_loop(Twc.to(mesh.devices[0]), step, settings)


def sharded_iters():
    """Record each edge-sharded solve's iterations (the factor graph's entry
    wrapped for the block; one host read a solve); returns (list, context
    manager)."""
    from mast3r_slam_tpu_torch.slam import factor_graph

    iters = []
    real = factor_graph.gauss_newton_poses_sharded

    def spy(*a, **kw):
        out = real(*a, **kw)
        iters.append(int(out[1]))
        return out

    return iters, swapped(factor_graph, "gauss_newton_poses_sharded", spy)


# 13a's early-stopping solves: a delta_norm that the step norms decide (on
# the CPU at 96x128 the steps run 3.3e-3 then 1.3e-3 at the fourth and fifth
# iterations), so the loop stops before max_iters
EARLY_DELTA = 2e-3


def run_sharded_solve(dev, hw=(384, 512), n_kf=16, seed=5, shards=MESH_SHARDS,
                      group_backend="nccl"):
    """13a: phase 6's rays problem (16 keyframes, 32 two-way edges x 196,608
    pixels) through gauss_newton_poses_sharded on meshes of 1, 2 and 4
    shards on one card, against the single-device dense solve: the pose
    difference within SHARDED_POSE_ATOL, the summed normal equations at the
    first iterate within SHARDED_BLOCKS_RTOL of one device's, the ground
    truth within SOLVE_BOUND_M.  Each mesh is one device program (route 1):
    one global_gn_while launch a solve, edge-block runs = shards x iters
    (counted by the kernel; counters reset just before, read just after),
    the bits (poses, iters, ok, diverged) of the frozen plain loop that the
    sharded route ran before (``frozen_sharded``: shards x max_iters runs),
    the same bits on a second call, host ms of the program's call (after
    the build; and CUDA events around five calls) and of the frozen loop.  Each mesh also solves at
    EARLY_DELTA, where the loop stops before max_iters, with the same
    checks.  Then the 1-shard mesh in a one-rank NCCL process group (route
    2: the eager loop reading its flag once an iteration, one all-reduce a
    field an iteration, no program; ``group_backend`` gloo rehearses it on
    the CPU)."""
    import torch
    import torch.distributed as dist
    from mast3r_slam_tpu_torch.ops import global_gn as gn
    from mast3r_slam_tpu_torch.parallel import multihost as mh
    from mast3r_slam_tpu_torch.parallel.mesh import make_mesh
    from mast3r_slam_tpu_torch.parallel.sharded_ba import (gauss_newton_poses_sharded,
                                                            normal_equations_sharded,
                                                            one_program)

    gt, noisy, Xs, Cs, ii, jj, idx, valid, Q, K = rays_problem(dev, hw, n_kf, seed)
    settings = gn.GlobalGNSettings()
    early = settings._replace(delta_norm=EARLY_DELTA)
    args = lambda st: (noisy, Xs, Cs, ii, jj, idx, valid, Q, K, hw, st, "rays")
    # one device's normal equations of every edge at the first iterate
    edge = (ii, jj) + tuple(gn.precompute_edge_data(Xs, Cs, ii, jj, idx, valid, Q,
                                                    settings, "rays", hw))
    H_e, g_e, c_e = gn.edge_blocks(noisy, edge, K, hw, settings, "rays")
    M = n_kf - settings.pin
    ref_eq = gn._scatter_dense(H_e, g_e, *gn._slots(ii, jj, settings.pin, M), M) + (
        c_e.sum(),)

    def timed(solve):
        sync(dev)
        t0 = time.perf_counter()
        out = solve()
        sync(dev)
        return out, (time.perf_counter() - t0) * 1e3

    reset_counts()
    (ref, ref_iters, ref_ok, _), ref_ms = timed(lambda: gn.gauss_newton_poses(*args(settings)))
    ref_iters, ref_ok = int(ref_iters), bool(ref_ok)
    ref_launches = read_counts()["edge_hg_rays"]
    if ref_launches != ref_iters:  # the one-device solve is the device program
        raise AssertionError(f"13a one device: {ref_launches} edge_hg_rays launches, "
                             f"expected one an iteration that ran ({ref_iters})")
    runs, poses = {}, {}

    def one(label, mesh, st):
        solve = lambda: gauss_newton_poses_sharded(mesh, *args(st))
        frozen, frozen_ms = timed(lambda: frozen_sharded(mesh, args(st)))
        first, first_ms = timed(solve)  # on route 1 the program's build and first call
        reset_counts()
        out, ms = timed(solve)
        counts = read_counts()
        T, iters, ok, diverged = out[0], int(out[1]), bool(out[2]), bool(out[3])
        launches = counts["edge_hg_rays"]
        program = one_program(mesh)
        # CUDA events around back-to-back calls (on the card; the host clock
        # in a CPU rehearsal, which has no events)
        event_ms = (time_cuda(solve, iters=5, warmup=0) if dev.type == "cuda"
                    else ms)
        eq = normal_equations_sharded(mesh, *args(st))
        blocks_rel = {k: ((a - b).norm() / b.norm()).item()
                      for k, a, b in zip(("H", "g", "cost"), eq, ref_eq)}
        r = dict(shards=mesh.size, process_group=mesh.distributed,
                 route="program" if program else "eager", delta_norm=st.delta_norm,
                 iters=iters, ok=ok, diverged=diverged, ms=ms, event_ms=event_ms,
                 first_ms=first_ms,
                 frozen_ms=frozen_ms, launches=launches,
                 program_launches=counts["global_gn_while"],
                 frozen_launches=mesh.local_size * st.max_iters,
                 same_bits_as_frozen=all(torch.equal(a, b) for a, b in zip(out, frozen)),
                 max_pose_diff=(T - ref).abs().max().item(), blocks_rel_diff=blocks_rel,
                 err_m=(T[:, :3] - gt[:, :3]).norm(dim=-1).max().item(),
                 same_bits=torch.equal(T, first[0]), same_bits_as_one_device=torch.equal(T, ref))
        log(f"13a sharded solve, {label}: {json.dumps(r)}")
        blocks_ok = max(blocks_rel.values()) <= SHARDED_BLOCKS_RTOL
        checks = dict(
            ok=ok and iters >= 1, frozen_bits=r["same_bits_as_frozen"],
            second_call_bits=r["same_bits"], equations=blocks_ok,
            launches=launches == mesh.local_size * iters,
            program_launches=r["program_launches"] == int(program))
        if st.delta_norm == settings.delta_norm:
            checks.update(one_device=r["max_pose_diff"] <= SHARDED_POSE_ATOL,
                          ground_truth=r["err_m"] <= SOLVE_BOUND_M)
        else:
            checks.update(stopped_early=iters < st.max_iters)
        if not all(checks.values()):
            raise AssertionError(
                f"13a sharded solve, {label}: {r}; failing: "
                f"{[k for k, v in checks.items() if not v]} (poses within "
                f"{SHARDED_POSE_ATOL} of one device, equations within {SHARDED_BLOCKS_RTOL} "
                f"of one device's, error bound {SOLVE_BOUND_M} m, launches {mesh.local_size} "
                f"x iters, one program launch on one card without a process group, the "
                f"frozen loop's bits)")
        runs[label], poses[label] = r, T

    for n in shards:
        mesh = make_mesh(devices=[dev] * n)
        one(f"{n}_shards", mesh, settings)
        one(f"{n}_shards_early", mesh, early)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mh.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend=group_backend)
    try:
        mesh = mh.make_global_mesh(devices=[dev])
        if not (mesh.distributed and dist.get_backend() == group_backend):
            raise AssertionError(f"13a: no {group_backend} process group")
        one("1_shard_nccl", mesh, settings)
        one("1_shard_nccl_early", mesh, early)
    finally:
        dist.destroy_process_group()
    nccl_same = torch.equal(poses["1_shard_nccl"], poses["1_shards"])
    log(f"13a one device: {ref_iters} iterations, ok {ref_ok}, {ref_ms:.3f} ms (host "
        f"clock); the NCCL rank's poses equal the 1-shard mesh's bits: {nccl_same}")
    return dict(one_device_ms=ref_ms, one_device_iters=ref_iters,
                one_device_launches=ref_launches, runs=runs,
                nccl_same_bits_as_1_shard=nccl_same)


def slam_rank(rank, world, port, out_dir, hw, n_frames, device="cuda:0"):
    """13b's worker: one of two processes on card 0, joined over gloo (NCCL
    puts no two ranks on one card; the blocks, kernels and solves run on
    the card, gloo carries the sums through host copies).  Phase 5's
    SLAM.run with engine.mesh "auto", a shard a process, the launch
    counters reset just before and read just after; its poses and counts
    saved for the parent."""
    import torch
    import torch.distributed as dist
    from mast3r_slam_tpu_torch.ops import kernels
    from mast3r_slam_tpu_torch.parallel import multihost as mh
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":  # a CPU rehearsal has no kernels
        torch.cuda.set_device(dev)
        for name in kernels.ENTRY_POINTS:  # built by the parent
            kernels.entry_point(name)
    mh.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        gt = arc_trajectory(n_frames)
        model = PlaneSceneModel(hw, gt, dev)
        cfg = engine_cfg("base")
        cfg["engine"]["mesh"] = "auto"
        slam = SLAM(model, cfg, hw, keyframe_buffer=16, device=dev)
        iters, spy = sharded_iters()
        reset_counts()
        t0 = time.perf_counter()
        with spy:
            res = slam.run(PlaneSceneDataset(model, n_frames), verbose=False)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = read_counts()
        st = slam.timer.stats()
        np.savez(out_dir / f"rank{rank}.npz", frame_poses=res.frame_poses,
                 keyframe_poses=res.keyframe_poses)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(dict(
            rank=rank, mesh_size=slam.mesh.size, local_shards=slam.mesh.local_size,
            backend=dist.get_backend(), n_keyframes=res.n_keyframes, n_reloc=res.n_reloc,
            n_edges=slam.graph.n_edges, launches=counts, wall_s=wall, solve_iters=iters,
            n_tracked=st["tracker.track"]["count"],
            n_tasks=st.get("backend.update", {"count": 0})["count"])))
    finally:
        dist.destroy_process_group()


def run_two_process_slam(dev, work, control, hw=(384, 512), n_frames=16):
    """13b: two processes (torch.multiprocessing, spawn) on the one card, each
    running slam_rank, against phase 5's one-process run (``control``): the
    same keyframe count, frame poses within TWO_PROCESS_POSE_ATOL, both ranks
    the same pose bits, each rank's launches (one refine a tracked frame
    and a task; every solve the sharded loop across the processes, which
    runs the edge blocks once an iteration that ran and no device program:
    edge-block runs = the solves' iterations summed)."""
    import torch.multiprocessing as tmp

    out = work / "two_process"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    tmp.spawn(slam_rank, args=(2, free_port(), out, hw, n_frames, str(dev)), nprocs=2,
              join=True)
    wall = time.perf_counter() - t0
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    poses = [np.load(out / f"rank{r}.npz") for r in range(2)]
    same_bits = all(np.array_equal(poses[0][k], poses[1][k])
                    for k in ("frame_poses", "keyframe_poses"))
    diff = float(np.abs(poses[0]["frame_poses"] - control.frame_poses).max())
    kf_diff = float(np.abs(poses[0]["keyframe_poses"] - control.keyframe_poses).max())
    res = dict(ranks=ranks, ranks_same_bits=same_bits, max_frame_pose_diff=diff,
               max_keyframe_pose_diff=kf_diff, control_keyframes=control.n_keyframes,
               spawn_wall_s=wall)
    log(f"13b two processes on one card (gloo): {json.dumps(res)}")
    bad = [r for r in ranks
           if not (r["mesh_size"] == 2 and r["n_keyframes"] == control.n_keyframes
                   and r["n_reloc"] == 0 and r["n_tasks"] >= 1
                   and r["launches"]["refine_window"] == r["n_tracked"] + r["n_tasks"]
                   and r["launches"]["edge_hg_rays"] >= r["n_tasks"]
                   and len(r["solve_iters"]) >= r["n_tasks"]
                   and r["launches"]["edge_hg_rays"] == sum(r["solve_iters"])
                   and r["launches"]["global_gn_while"] == 0)]
    if bad or not same_bits or diff > TWO_PROCESS_POSE_ATOL or kf_diff > TWO_PROCESS_POSE_ATOL:
        raise AssertionError(f"13b two processes: {res} (bound {TWO_PROCESS_POSE_ATOL} m; "
                             f"ranks failing their checks: {bad})")
    return res


THREADED_FRAMES = 8        # 13e: ViT-L frames a rank, every tracked one a task
THREADED_HOLD = 2          # 13e: frames rank 1's worker holds each ViT-L task


class ImageDataset:
    """Frames already on the card, normalised (3, H, W), for SLAM.run."""

    def __init__(self, imgs):
        self.imgs = imgs
        self.timestamps = [f"{i / 30.0:.6f}" for i in range(len(imgs))]

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.timestamps[i], None

    def preprocessed(self, i):
        return {"img": self.imgs[i]}


def hold_tasks(slam, frames, wait):
    """13e's hooks on one engine: its worker runs each backend task, then
    holds the task's end until the frontend has logged the frame
    ``frames`` past the task's agreed start (or the run drains at its end).
    The hold comes after the task's collectives, which would otherwise keep
    the other ranks' workers in step with this one.  With ``wait``, the
    commit of that frame first waits for the worker to end the task, so
    the agreement there sees it (``frames`` 0: every task lands at its own
    frame)."""
    import threading

    task, commit, join = slam._backend_update_impl, slam._frame_committed, slam.join_backend
    draining = threading.Event()

    def start():
        if slam._n_started == slam._n_applied:
            return None
        return slam.backend_schedule[slam._n_started - 1][1]

    def held(*args, **kwargs):
        first = start()
        out = task(*args, **kwargs)
        deadline = time.time() + 60
        while (len(slam.frame_log) <= first + frames and not draining.is_set()
               and time.time() < deadline):
            time.sleep(0.002)
        return out

    def waited(frame_id):
        first = start()
        if first is not None and frame_id >= first + frames:
            with slam._done_cv:
                if not slam._done_cv.wait_for(lambda: slam._n_done == slam._n_started,
                                              timeout=300):
                    raise AssertionError("13e: the backend worker never finished")
        return commit(frame_id)

    def drain():
        draining.set()
        join()

    slam._backend_update_impl, slam.join_backend = held, drain
    if wait:
        slam._frame_committed = waited


def threaded_run(slam, dataset, dev):
    """SLAM.run with the launch counters reset just before and read just
    after, each edge-sharded solve's iterations recorded; (result, wall s,
    launches, the rank's record)."""
    iters, spy = sharded_iters()
    reset_counts()
    t0 = time.perf_counter()
    with spy:
        res = slam.run(dataset, verbose=False)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    slam.close()
    if slam.backend_errors:
        raise AssertionError(f"13e: backend tasks failed: {slam.backend_errors!r}")
    st = slam.timer.stats()
    agree = st.get("backend.agree", {"count": 0, "mean_ms": 0.0, "p95_ms": 0.0})
    n_frames = len(res.frame_timestamps)
    return res, wall, counts, dict(
        agreed=slam.agreed, mesh_size=slam.mesh.size, n_frames=n_frames,
        n_keyframes=res.n_keyframes, n_reloc=res.n_reloc, n_edges=slam.graph.n_edges,
        schedule=slam.backend_schedule,
        n_tracked=st.get("tracker.track", {"count": 0})["count"],
        n_tasks=st.get("backend.update", {"count": 0})["count"], launches=counts,
        solve_iters=iters,
        n_agree=agree["count"], agree_mean_ms=agree["mean_ms"], agree_p95_ms=agree["p95_ms"],
        agree_ms_per_frame=agree["count"] * agree["mean_ms"] / max(n_frames, 1),
        task_mean_ms=st.get("backend.update", {"mean_ms": 0.0})["mean_ms"], wall_s=wall)


def threaded_rank(rank, world, port, out_dir, hw, n_standin, n_vitl, device="cuda:0",
                  mcfg=None):
    """13e's worker: one of two processes on card 0, joined over gloo, each
    engine threaded (``single_thread: False``) on a mesh of one shard a
    rank.  First 13b's stand-in run, gated (every task lands at its own
    frame); then ViT-L (random weights, seed 0) under ``base`` as packaged
    with 9b's pinned decisions over ``n_vitl`` smooth frames, rank 1's
    worker holding each task's end THREADED_HOLD frames.  Poses and records
    saved for the parent."""
    import torch
    import torch.distributed as dist
    from mast3r_slam_tpu_torch.config import load_config, merge_config
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.interface import MASt3RModel
    from mast3r_slam_tpu_torch.ops import kernels
    from mast3r_slam_tpu_torch.parallel import multihost as mh
    from mast3r_slam_tpu_torch.slam import run
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":  # a CPU rehearsal has no kernels
        torch.cuda.set_device(dev)
        for name in kernels.ENTRY_POINTS:  # built by the parent
            kernels.entry_point(name)
    # a collective whose peer stopped ends in an error, not a hang
    mh.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout=300)
    try:
        gt = arc_trajectory(n_standin)
        model = PlaneSceneModel(hw, gt, dev)
        cfg = engine_cfg("base", single_thread=False)
        cfg["engine"]["mesh"] = "auto"
        slam = SLAM(model, cfg, hw, keyframe_buffer=16, device=dev)
        hold_tasks(slam, 0, wait=True)
        res, _, _, rec = threaded_run(slam, PlaneSceneDataset(model, n_standin), dev)
        np.savez(out_dir / f"standin_rank{rank}.npz", frame_poses=res.frame_poses,
                 keyframe_poses=res.keyframe_poses)
        (out_dir / f"standin_rank{rank}.json").write_text(json.dumps(rec))

        def refuse(msg):
            raise ValueError(msg)

        cfg = load_config("base")  # as packaged: single_thread False
        for patch in run.parse_overrides(CLI_VITL_SET, refuse):
            cfg = merge_config(cfg, patch)
        cfg["engine"]["mesh"] = "auto"
        cfg["engine"]["edge_buffer"] = 16
        t0 = time.perf_counter()
        vitl = MASt3RModel.random_init(0, hw, mcfg or M.VIT_LARGE, device=dev)
        slam = SLAM(vitl, cfg, hw, keyframe_buffer=16, device=dev)
        init_s = time.perf_counter() - t0
        if rank == 1:
            hold_tasks(slam, THREADED_HOLD, wait=False)
        res, _, _, rec = threaded_run(slam, ImageDataset(smooth_images(n_vitl, hw, dev, seed=13)),
                                      dev)
        rec.update(init_s=init_s, enc_depth=vitl.mcfg.enc_depth, dec_depth=vitl.mcfg.dec_depth)
        np.savez(out_dir / f"vitl_rank{rank}.npz", frame_poses=res.frame_poses,
                 keyframe_poses=res.keyframe_poses)
        (out_dir / f"vitl_rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def run_threaded_two_process(dev, work, control, hw=(384, 512), n_standin=16,
                             n_vitl=THREADED_FRAMES, mcfg=None):
    """13e: two processes (spawn) on the one card, each running
    threaded_rank.  The stand-in: both ranks the same bits, within
    TWO_PROCESS_POSE_ATOL of phase 5's one-process run (``control``), and
    whether 13b's in-line ranks' bits.  ViT-L: both ranks the same schedule,
    keyframes and pose bits, every task applied, rank 1's held tasks
    THREADED_HOLD frames or more behind their start, and each rank's
    launches held to its frames and tasks (72 attention a frame and 48 a
    task at ViT-L's depths, one refine a tracked frame and a task, the same
    edge blocks on both ranks, at least one a task).  In both runs every
    solve is the sharded loop across the processes: edge-block runs = the
    solves' iterations summed, no device program."""
    import torch.multiprocessing as tmp

    out = work / "threaded"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    tmp.spawn(threaded_rank, args=(2, free_port(), out, hw, n_standin, n_vitl, str(dev), mcfg),
              nprocs=2, join=True)
    wall = time.perf_counter() - t0

    def load(name):
        return ([json.loads((out / f"{name}_rank{r}.json").read_text()) for r in range(2)],
                [np.load(out / f"{name}_rank{r}.npz") for r in range(2)])

    def same_bits(poses):
        return all(np.array_equal(poses[0][k], poses[1][k])
                   for k in ("frame_poses", "keyframe_poses"))

    srec, spose = load("standin")
    inline = work / "two_process" / "rank0.npz"
    res = dict(spawn_wall_s=wall, standin=dict(
        ranks=srec, ranks_same_bits=same_bits(spose),
        max_frame_pose_diff=float(np.abs(spose[0]["frame_poses"]
                                         - control.frame_poses).max()),
        max_keyframe_pose_diff=float(np.abs(spose[0]["keyframe_poses"]
                                            - control.keyframe_poses).max()),
        same_bits_as_13b=(inline.exists() and same_bits([spose[0], np.load(inline)]))))
    vrec, vpose = load("vitl")
    last = vrec[0]["n_frames"] - 1
    held = [s for s in vrec[0]["schedule"] if s[1] + THREADED_HOLD <= last]
    res["vitl"] = dict(ranks=vrec, ranks_same_bits=same_bits(vpose),
                       held_tasks=held, hold_frames=THREADED_HOLD)
    log(f"13e threaded backend, two processes on one card (gloo): {json.dumps(res)}")

    st = res["standin"]
    faults = []
    if not (st["ranks_same_bits"] and st["max_frame_pose_diff"] <= TWO_PROCESS_POSE_ATOL
            and st["max_keyframe_pose_diff"] <= TWO_PROCESS_POSE_ATOL
            and all(r["agreed"] and r["n_keyframes"] == control.n_keyframes
                    and r["schedule"] == [[s[0]] * 3 for s in r["schedule"]]
                    for r in srec)):
        faults.append(f"stand-in: ranks' bits, within {TWO_PROCESS_POSE_ATOL} of the "
                      f"control, every task at its own frame")
    keys = ("n_frames", "n_keyframes", "n_reloc", "n_edges", "schedule", "n_tracked",
            "n_tasks")
    if any(vrec[0][k] != vrec[1][k] for k in keys) or not res["vitl"]["ranks_same_bits"]:
        faults.append("ViT-L: the ranks disagree")
    for r in vrec:
        c = r["launches"]
        if not (r["agreed"] and r["mesh_size"] == 2 and r["n_frames"] == n_vitl
                and r["n_tasks"] == len(r["schedule"]) >= 1
                and all(None not in s for s in r["schedule"])
                and c["attention"] == ((r["enc_depth"] + 4 * r["dec_depth"]) * r["n_frames"]
                                       + 4 * r["dec_depth"] * r["n_tasks"])
                and c["refine_window"] == r["n_tracked"] + r["n_tasks"]
                and c["edge_hg_rays"] >= r["n_tasks"]):
            faults.append(f"ViT-L rank record {r}")
    if vrec[0]["launches"]["edge_hg_rays"] != vrec[1]["launches"]["edge_hg_rays"]:
        faults.append("ViT-L: edge-block launches differ between the ranks")
    for r in srec + vrec:
        if not (r["launches"]["edge_hg_rays"] == sum(r["solve_iters"])
                and len(r["solve_iters"]) >= r["n_tasks"]
                and r["launches"]["global_gn_while"] == 0):
            faults.append(f"edge-block runs {r['launches']['edge_hg_rays']} against the "
                          f"solves' iterations {r['solve_iters']} (route 2: no program)")
    if not held or any(s[2] - s[1] < THREADED_HOLD for s in held):
        faults.append(f"ViT-L: rank 1's hold shows in no task's schedule: {held}")
    if faults:
        raise AssertionError(f"13e threaded backend: {faults}: {json.dumps(res)}")
    return res


def reloc_rank(rank, world, port, out_dir, hw, device="cuda:0"):
    """13f's worker: one of two processes on card 0, joined over gloo, each
    running phase 8's teleport run (run_synthetic_reloc) threaded
    (``single_thread: False``) under the agreement with engine.mesh "auto":
    tracking breaks, both ranks drain their workers and relocalise.  Each
    relocalisation's frame and outcome and each edge-sharded solve's
    iterations recorded; poses and records saved for the parent."""
    import torch
    import torch.distributed as dist
    from mast3r_slam_tpu_torch.ops import kernels
    from mast3r_slam_tpu_torch.parallel import multihost as mh
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":  # a CPU rehearsal has no kernels
        torch.cuda.set_device(dev)
        for name in kernels.ENTRY_POINTS:  # built by the parent
            kernels.entry_point(name)
    mh.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout=300)
    try:
        cfg = engine_cfg("base", single_thread=False, edge_buffer=64)
        cfg["engine"]["mesh"] = "auto"
        relocs = []
        relocalize = SLAM._relocalize

        def relocalized(slam, frame):
            ok = relocalize(slam, frame)
            relocs.append([int(frame.frame_id), bool(ok)])
            return ok

        iters, spy = sharded_iters()
        t0 = time.perf_counter()
        with swapped(SLAM, "_relocalize", relocalized), spy:
            res, slam, gt, counts, calls, hamming = run_synthetic_reloc(
                dev, hw=hw, cfg=cfg, label=f"13f rank {rank}")
        wall = time.perf_counter() - t0
        st = slam.timer.stats()
        np.savez(out_dir / f"rank{rank}.npz", frame_poses=res.frame_poses,
                 keyframe_poses=res.keyframe_poses, gt=gt)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(dict(
            rank=rank, agreed=slam.agreed, mesh_size=slam.mesh.size, n_reloc=res.n_reloc,
            n_reloc_success=res.n_reloc_success, relocs=relocs, mode=slam.mode.name,
            n_keyframes=res.n_keyframes, n_edges=slam.graph.n_edges,
            schedule=slam.backend_schedule, solve_iters=iters, launches=counts,
            add_factors_calls=len(calls), hamming_exact=hamming, wall_s=wall,
            n_tasks=st.get("backend.update", {"count": 0})["count"],
            reloc_ms=st.get("reloc.retrieval", {"mean_ms": None})["mean_ms"])))
    finally:
        dist.destroy_process_group()


def run_reloc_two_process(dev, work, hw=(384, 512)):
    """13f: a relocalisation's drain across processes.  Two processes (spawn)
    on the one card, each running reloc_rank: both ranks relocalise at the
    same frames with the same outcomes, end in TRACKING with the same
    schedule, keyframes, edges, solve iterations and pose bits, the last
    three frames within RELOC_BOUND_M of the ground truth; every solve is
    the edge-sharded loop across the processes (edge-block runs = the
    solves' iterations summed, no device program)."""
    import torch.multiprocessing as tmp

    out = work / "reloc_two_process"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    tmp.spawn(reloc_rank, args=(2, free_port(), out, hw, str(dev)), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    poses = [np.load(out / f"rank{r}.npz") for r in range(2)]
    same_bits = all(np.array_equal(poses[0][k], poses[1][k])
                    for k in ("frame_poses", "keyframe_poses"))
    errs = [float(np.linalg.norm(p["frame_poses"][-3:, :3] - p["gt"][-3:, :3], axis=-1).max())
            for p in poses]
    res = dict(ranks=ranks, ranks_same_bits=same_bits, post_reloc_err_m=errs,
               spawn_wall_s=wall)
    log(f"13f relocalisation, threaded over two processes on one card (gloo): "
        f"{json.dumps(res)}")
    faults = []
    keys = ("relocs", "n_reloc", "n_reloc_success", "mode", "n_keyframes", "n_edges",
            "schedule", "solve_iters")
    if any(ranks[0][k] != ranks[1][k] for k in keys) or not same_bits:
        faults.append("the ranks disagree")
    for r, err in zip(ranks, errs):
        c = r["launches"]
        if not (r["agreed"] and r["mesh_size"] == 2 and r["n_reloc"] >= 1
                and r["n_reloc_success"] >= 1 and r["mode"] == "TRACKING"
                and [ok for _, ok in r["relocs"]].count(True) == r["n_reloc_success"]
                and err < RELOC_BOUND_M and r["hamming_exact"]
                and len(r["solve_iters"]) >= 1
                and c["edge_hg_rays"] == sum(r["solve_iters"])
                and c["global_gn_while"] == 0):
            faults.append(f"rank {r['rank']}: {r} (post-reloc error {err} m, bound "
                          f"{RELOC_BOUND_M})")
    if faults:
        raise AssertionError(f"13f relocalisation across processes: {faults}")
    return res


def vitl_keyframes(dev, model, hw):
    """Phase 6's three ViT-L keyframes (smooth random images, mono pointmaps,
    poses 5 cm apart) in a fresh store."""
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.slam.frame import Frame, Keyframes

    kf = Keyframes(4, hw[0] * hw[1], model.num_patches, model.feat_dim, device=dev)
    imgs = smooth_images(3, hw, dev, seed=9)
    for k in range(3):
        feat, pos = model.encode(imgs[k:k + 1])
        X, C = model.mono(feat, pos)
        T = sim3.identity(device=dev)
        T[0] = 0.05 * k
        f = Frame(frame_id=k, img=imgs[k], T_WC=T, feat=feat, pos=pos)
        f.update_pointmap(X.reshape(-1, 3), C.reshape(-1, 1))
        kf.append(f)
    return kf


def run_sharded_vitl_task(dev, model, hw=(384, 512), shards=TASK_SHARDS):
    """13c: phase 6's ViT-L backend task (add_factors([1], [2]) + solve) on a
    mesh of ``shards`` shards on one card: each shard decodes and matches its
    slice of the padded batch (the real pair and a pair of keyframe 0), so
    48 attention and 1 refine launch a shard; the stored idx, valid and Q
    equal the unsharded task's bits (decoded first on the same keyframes);
    edge blocks shards x GN iterations.  Counters reset just before the
    sharded task and read just after."""
    import torch
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.parallel.mesh import make_mesh
    from mast3r_slam_tpu_torch.slam import factor_graph as fg

    cfg = load_config("base")
    frac = cfg["local_opt"]["min_match_frac"]
    kf = vitl_keyframes(dev, model, hw)
    plain = fg.FactorGraph(model, cfg, kf, hw, edge_capacity=16)
    plain.add_factors([1], [2], frac)
    graph = fg.FactorGraph(model, cfg, kf, hw, edge_capacity=16,
                           mesh=make_mesh(devices=[dev] * shards))
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    added = graph.add_factors([1], [2], frac)
    graph.solve()
    sync(dev)
    task_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    same = [torch.equal(a[:1], b[:1]) for a, b in zip(graph._stores(), plain._stores())]
    res = dict(shards=shards, launches=counts, task_ms=task_ms, added=added,
               n_edges=graph.n_edges, fields_same_bits=all(same))
    log(f"13c ViT-L backend task on {shards} shards: {json.dumps(res)}")
    want = {"attention": 48 * shards, "refine_window": shards}
    if ({k: counts[k] for k in want} != want or counts["edge_hg_rays"] < shards
            or counts["edge_hg_rays"] % shards or not added or graph.n_edges != 1
            or not all(same) or not torch.isfinite(kf.T_WC[:3]).all()):
        raise AssertionError(f"13c ViT-L task on {shards} shards: {res} (expected "
                             f"launches {want}, edge blocks a multiple of {shards}; "
                             f"fields (idx_i2j, idx_j2i, valid_j, valid_i, Qj, Qi) equal "
                             f"the unsharded task's: {same})")
    return res


def track_frames(dev, model, hw, n_frames, compute_device):
    """Phase 4's frames through FrameTracker.track (``compute_device`` None:
    the default tracker): the stats vector of every frame."""
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.slam.frame import Frame, Keyframes
    from mast3r_slam_tpu_torch.slam.tracker import FrameTracker

    kf = Keyframes(8, hw[0] * hw[1], model.num_patches, model.feat_dim,
                   device=compute_device or dev)
    tracker = FrameTracker(model, load_config("base"), kf, hw, device=dev,
                           compute_device=compute_device)
    imgs = smooth_images(n_frames + 1, hw, dev, seed=3)
    feat, pos = model.encode(imgs[:1])
    X, C = model.mono(feat, pos)
    f0 = Frame(frame_id=0, img=imgs[0], T_WC=sim3.identity(device=dev), feat=feat, pos=pos)
    f0.update_pointmap(X.reshape(-1, 3), C.reshape(-1, 1))
    kf.append(f0)
    stats = []
    for i in range(1, n_frames + 1):
        feat, pos = model.encode(imgs[i:i + 1])
        tracker.track(Frame(frame_id=i, img=imgs[i], T_WC=f0.T_WC, feat=feat, pos=pos))
        stats.append(tracker.last_stats.copy())
    return stats


def check_kernels_on_card(dev):
    """Attention (1,12,768,64) and refine (384x512, F 24, (3, 5)) launched on
    ``dev`` against their plain versions there: each raises its dynamic
    shared memory limit on every card it runs on."""
    import torch
    from mast3r_slam_tpu_torch.ops import attention, refine

    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn(1, 12, 768, 64, device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3))
    err = (attention.sdpa(q, k, v).float() - attention.sdpa_plain(q, k, v).float()).abs()
    d11q, d21q, idx = refine_inputs(dev, 384, 512, 24, smooth=False)
    sched = refine.schedule(5)
    exact = torch.equal(refine.refine_window(d11q, d21q, idx, 384, 512, 3, sched),
                        refine.refine_window_plain(d11q, d21q, idx, 384, 512, 3, sched))
    out = dict(device=str(dev), attention_max_err=err.max().item(), refine_exact=exact)
    if not (out["attention_max_err"] <= ATTN_MAX_ERR and exact):
        raise AssertionError(f"13d kernels on {dev}: {out}")
    return out


def solve_rank(rank, world, port, out_dir, hw, n_kf, seed):
    """13d's worker on a machine with two cards: one NCCL rank a card, the
    sharded solve of 13a over the two cards' mesh; poses saved."""
    import torch
    import torch.distributed as dist
    from mast3r_slam_tpu_torch.ops import kernels
    from mast3r_slam_tpu_torch.ops.global_gn import GlobalGNSettings
    from mast3r_slam_tpu_torch.parallel import multihost as mh
    from mast3r_slam_tpu_torch.parallel.sharded_ba import gauss_newton_poses_sharded

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in kernels.ENTRY_POINTS:
        kernels.entry_point(name)
    mh.initialize(f"127.0.0.1:{port}", world, rank, backend="nccl")
    try:
        dev = torch.device("cuda", rank)
        mesh = mh.make_global_mesh(devices=[dev])
        gt, noisy, Xs, Cs, ii, jj, idx, valid, Q, K = rays_problem(dev, hw, n_kf, seed)
        T, iters, ok, _ = gauss_newton_poses_sharded(
            mesh, noisy, Xs, Cs, ii, jj, idx, valid, Q, K, hw, GlobalGNSettings(), "rays")
        np.save(out_dir / f"solve_rank{rank}.npy", T.cpu().numpy())
        (out_dir / f"solve_rank{rank}.json").write_text(json.dumps(dict(
            iters=int(iters), ok=bool(ok), mesh_size=mesh.size)))
    finally:
        dist.destroy_process_group()


def run_second_card(dev, work, control, ref_poses, hw=(384, 512)):
    """13d on two or more cards: the kernels on every card, engine.pipeline: 2
    (the tracker and the store on cuda:1) against phase 5's sequential run
    for the same bits, and a 2-card NCCL mesh (a process a card) for 13a's
    solve against 13a's one-device poses."""
    import torch
    import torch.multiprocessing as tmp

    cards = [check_kernels_on_card(torch.device("cuda", i))
             for i in range(torch.cuda.device_count())]
    _, pres, _, _, pslam = run_synthetic_slam(dev, cfg=engine_cfg("base", pipeline=2),
                                              label="base, pipeline 2")
    pipe_same = (pslam.tracker.compute_device == torch.device("cuda", 1)
                 and np.array_equal(pres.frame_poses, control.frame_poses)
                 and np.array_equal(pres.keyframe_poses, control.keyframe_poses))
    out = work / "two_cards"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    tmp.spawn(solve_rank, args=(2, free_port(), out, hw, 16, 5), nprocs=2, join=True)
    T = [np.load(out / f"solve_rank{r}.npy") for r in range(2)]
    meta = [json.loads((out / f"solve_rank{r}.json").read_text()) for r in range(2)]
    ref = ref_poses.cpu().numpy()
    nccl_ok = (np.array_equal(T[0], T[1]) and all(m["ok"] and m["mesh_size"] == 2 for m in meta)
               and float(np.abs(T[0] - ref).max()) <= SHARDED_POSE_ATOL)
    res = dict(cards=cards, pipeline2_same_bits=pipe_same, nccl_two_cards=meta,
               nccl_two_cards_ok=nccl_ok,
               nccl_max_pose_diff=float(np.abs(T[0] - ref).max()))
    log(f"13d on {torch.cuda.device_count()} cards: {json.dumps(res)}")
    if not (pipe_same and nccl_ok):
        raise AssertionError(f"13d on two cards: {res}")
    return res


def run_multi_card(dev, work, smi, vitl, control, stride1_task_ms):
    """Phase 13: 13a-13f (see the module docstring)."""
    import torch
    from mast3r_slam_tpu_torch.ops.global_gn import GlobalGNSettings, gauss_newton_poses

    solve = run_sharded_solve(dev)
    two = run_two_process_slam(dev, work, control)
    threaded = run_threaded_two_process(dev, work, control)
    tv = threaded["vitl"]["ranks"]
    log(f"13e ViT-L, threaded over two ranks: {tv[0]['n_frames']} frames, "
        f"{tv[0]['n_tasks']} tasks, run wall {[round(r['wall_s'], 3) for r in tv]} s, "
        f"{tv[0]['n_agree']} agreements at {[round(r['agree_mean_ms'], 3) for r in tv]} ms "
        f"each (host clock); {smi}")
    reloc = run_reloc_two_process(dev, work)
    r0 = reloc["ranks"][0]
    log(f"13f relocalisation across two processes: reloc at {r0['relocs']}, solves' "
        f"iterations {r0['solve_iters']}, run wall "
        f"{[round(r['wall_s'], 3) for r in reloc['ranks']]} s (host clock); {smi}")
    task = run_sharded_vitl_task(dev, vitl)
    log(f"13c: the sharded task {task['task_ms']:.3f} ms against phase 6's unsharded "
        f"{stride1_task_ms:.3f} ms (host clock); {smi}")
    seq = track_frames(dev, vitl, (384, 512), 3, None)
    explicit = track_frames(dev, vitl, (384, 512), 3, dev)
    same = all(np.array_equal(a, b) for a, b in zip(seq, explicit))
    log(f"13d FrameTracker(compute_device={dev}) over 3 of phase 4's frames: the "
        f"default tracker's stats bits {same}")
    if not same:
        raise AssertionError("13d: FrameTracker(compute_device) differs from the "
                             "default tracker")
    second = None
    if torch.cuda.device_count() >= 2:
        gt, noisy, Xs, Cs, ii, jj, idx, valid, Q, K = rays_problem(dev, (384, 512), 16, 5)
        ref = gauss_newton_poses(noisy, Xs, Cs, ii, jj, idx, valid, Q, K, (384, 512),
                                 GlobalGNSettings(), "rays")[0]
        second = run_second_card(dev, work, control, ref)
    else:
        log(f"13d: not run for want of a second card (torch.cuda.device_count() = "
            f"{torch.cuda.device_count()}): engine.pipeline: 2 with the tracker on cuda:1, "
            f"a 2-card NCCL mesh for 13a, and the attention and refine kernels on every card")
    return dict(sharded_solve=solve, two_process=two, threaded_two_process=threaded,
                reloc_two_process=reloc, sharded_task=task, compute_device_same_bits=same, second_card=second,
                card=smi)


# ---------------------------------------------------------------------------
# phase 14: the tracking GN's device program; host reads
# ---------------------------------------------------------------------------

SYNC_FRAMES = 5            # 14a: counted tracked frames (after two warm-up frames)
WALL_FRAMES = 12           # 14c: frames of each SLAM.run timed under pipeline 0 and 1
# phase 4's profiled frame before the GN loop ran on the device (PERF.md §5,
# PRs 4-13), for the log only: launches and the busy share of the profiled wall
BEFORE_FRAME_LAUNCHES = 5866
BEFORE_BUSY_SHARE = (0.15, 0.18)


@contextlib.contextmanager
def counted_syncs():
    """The synchronising calls on the card in the body, each as the Python
    stack that made it (``torch.cuda.set_sync_debug_mode("warn")``, which
    also sees implicit syncs: a blocking copy to or from the host, a data
    dependent shape)."""
    import traceback
    import warnings

    import torch

    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            seen.append("".join(traceback.format_stack(limit=9)[:-2]))
        else:
            shown(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        shown = warnings.showwarning
        warnings.simplefilter("always")
        # switched on before the recorder: the switch itself can warn
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = record
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode("default")


def pinned_speed_cfg():
    """``speed`` with phase 4b's decisions pinned to commit: every frame is
    tracked on the chained path, no keyframe switch, no relocalisation."""
    from mast3r_slam_tpu_torch.config import load_config

    cfg = load_config("speed")
    cfg["single_thread"] = True
    cfg["matching"].update(convergence_thresh=1e9, dist_thresh=1e9)
    cfg["tracking"].update(C_conf=-1.0, Q_conf=-1.0, min_match_frac=0.0,
                           match_frac_thresh=-1.0)
    return cfg


def speed_model(dev, vitl, hw):
    """Phase 4b's model: phase 4's ViT-L weights, bf16 heads."""
    import dataclasses

    import torch
    from mast3r_slam_tpu_torch.models.interface import MASt3RModel

    mcfg = dataclasses.replace(vitl.mcfg, head_dtype=torch.bfloat16)
    return MASt3RModel(vitl.params, mcfg, hw, device=dev)


def count_frame_syncs(dev, model, hw=(384, 512), n=SYNC_FRAMES):
    """14a: ViT-L under ``speed`` with the decisions pinned open: an INIT
    keyframe, two warm-up frames (the GN's device program is built at the
    first), then n frames each through ``infer``, ``track_submit_chained``
    and ``track_finish`` of the previous one, as SLAM._loop_pipelined runs
    them (its re-submission after a failed frame reads nothing and is left
    out), with the card's syncs counted around each frame; its encode is
    counted apart.  Returns (syncs a frame, encode syncs a frame, where the
    frames' syncs came from)."""
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.slam.frame import Frame, Keyframes
    from mast3r_slam_tpu_torch.slam.tracker import FrameTracker

    cfg = pinned_speed_cfg()
    imgs = smooth_images(n + 3, hw, dev, seed=3)
    kf = Keyframes(8, hw[0] * hw[1], model.num_patches, model.feat_dim, device=dev)
    feat, pos = model.encode(imgs[:1])
    X, C = model.mono(feat, pos)
    T0 = sim3.identity(device=dev)
    f0 = Frame(frame_id=0, img=imgs[0], T_WC=T0, feat=feat, pos=pos)
    f0.update_pointmap(X.reshape(-1, 3), C.reshape(-1, 1))
    kf.append(f0)
    tracker = FrameTracker(model, cfg, kf, hw, device=dev)

    def frame(i):
        feat, pos = model.encode(imgs[i:i + 1])
        return Frame(frame_id=i, img=imgs[i], T_WC=T0, feat=feat, pos=pos)

    f1 = frame(1)
    pend = tracker.track_submit(f1, inference=tracker.infer(f1))
    f2 = frame(2)
    nxt = tracker.track_submit_chained(f2, tracker.infer(f2), pend)
    tracker.track_finish(pend)
    pend = nxt
    sync(dev)
    per_frame, per_encode, where, decisions = [], [], [], []
    for i in range(3, n + 3):
        with counted_syncs() as enc:
            fr = frame(i)
        with counted_syncs() as seen:
            nxt = tracker.track_submit_chained(fr, tracker.infer(fr), pend)
            decisions.append(tracker.track_finish(pend))
        pend = nxt
        per_frame.append(len(seen))
        per_encode.append(len(enc))
        where += seen + enc
    tracker.track_finish(pend)
    log(f"14a (new_kf, try_reloc) of the counted frames: {decisions} (random weights: "
        f"a GN failure asks to relocalise; the loop would re-submit, reading nothing)")
    return per_frame, per_encode, where


def count_task_syncs(dev, model, hw=(384, 512)):
    """14a: one ``speed`` backend task (retrieval update with the default
    head at full width and a seeded 64k-word codebook, add_factors with the
    one-way and speculative edges, the dense solve) on phase 6's three
    keyframes, after two warm-up tasks, with the card's syncs counted.
    Returns (syncs, where they came from, task ms)."""
    import torch
    from mast3r_slam_tpu_torch.retrieval import (ASMKSettings, RetrievalDatabase,
                                                 RetrievalHeadSettings)
    from mast3r_slam_tpu_torch.retrieval.head import init_head_params
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM

    g = torch.Generator(device=dev).manual_seed(41)
    params = init_head_params(g, model.feat_dim, hdims=(1024,))
    centroids = torch.randn((65_536, 1024), device=dev, generator=g)
    db = RetrievalDatabase(params, centroids, RetrievalHeadSettings(nfeat=300),
                           ASMKSettings(max_images=64), device=dev)
    cfg = engine_cfg("speed", single_thread=True)
    slam = SLAM(model, cfg, hw, retrieval=db, device=dev)
    src = vitl_keyframes(dev, model, hw)
    for k in range(3):
        slam.keyframes.append(src.get_frame(k))
    slam._backend_update_impl(0)  # adds keyframe 0 to the database
    slam._backend_update_impl(1)
    sync(dev)
    t0 = time.perf_counter()
    with counted_syncs() as seen:
        slam._backend_update_impl(2)
    sync(dev)
    task_ms = (time.perf_counter() - t0) * 1e3
    slam.close()
    return len(seen), seen, task_ms


def tracking_gn_inputs(dev, N, calib, seed=0):
    """A tracking GN problem of N matched points (a known Sim(3), 2 mm of
    noise, a tenth of the points invalid): (mode, inputs, image size)."""
    import torch
    from mast3r_slam_tpu_torch.lie import sim3

    g = torch.Generator(device=dev).manual_seed(seed)
    Xk = torch.randn(N, 3, device=dev, generator=g)
    Xk[:, 2] = Xk[:, 2].abs() * 2 + 1.5
    T_true = sim3.exp(torch.randn(7, device=dev, generator=g) * 0.05)
    Xf = sim3.act(sim3.inv(T_true), Xk) + 0.002 * torch.randn(N, 3, device=dev, generator=g)
    Q = 1.5 + torch.rand(N, 1, device=dev, generator=g)
    valid = (torch.rand(N, 1, device=dev, generator=g) > 0.1).float()
    if not calib:
        return "ray_dist", (Xf, Xk, Q, valid), None
    K = torch.tensor([[400.0, 0, 256], [0, 400.0, 192], [0, 0, 1]], device=dev)
    uvz = torch.stack([K[0, 0] * Xk[:, 0] / Xk[:, 2] + K[0, 2],
                       K[1, 1] * Xk[:, 1] / Xk[:, 2] + K[1, 2], torch.log(Xk[:, 2])], -1)
    return ("calib", (Xf, Xk, Q, valid, uvz, torch.ones(N, 1, dtype=torch.bool, device=dev),
                      K), (384, 512))


def check_tracking_gn(dev, hw=(384, 512)):
    """14b: the tracking GN's device program against the eager frozen loop
    on the same inputs, in both residual models and with a singular
    system: the same bits of T, cost, ok and iterations; the program's
    device time (CUDA events, mean of 5 launches), the plain loop's, the
    bound, and the program's kernel nodes."""
    import torch
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.ops import kernels, tracking_gn as tg

    N = hw[0] * hw[1]
    settings = tg.GNSettings()
    T0 = sim3.identity(device=dev)
    lib = ctypes.CDLL(str(kernels.library_path("gn_while")))
    out = {}
    for name in ("ray_dist", "calib", "ray_dist_singular"):
        mode, inputs, img = tracking_gn_inputs(dev, N, name == "calib")
        if name.endswith("singular"):
            inputs = inputs[:3] + (torch.zeros_like(inputs[3]),)
        plain = tg.tracking_gn_plain(mode, inputs, T0, settings, img)
        got = tg.tracking_gn_graph(mode, inputs, T0, settings, img)
        same = all(torch.equal(a, b) for a, b in zip(got, plain))
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got[:2], plain[:2]))
        ms = time_cuda(lambda: tg.tracking_gn_graph(mode, inputs, T0, settings, img), iters=5,
                       warmup=1)
        plain_ms = time_cuda(lambda: tg.tracking_gn_plain(mode, inputs, T0, settings, img),
                             iters=2, warmup=0)
        iters = int(got[3])
        # bytes: the inputs read once and the 8 + 3 outputs written once;
        # operations: an iteration's [J | r]^T [J | r] over R rows a point
        R = 4 if mode == "ray_dist" else 3
        nbytes = sum(a.numel() * a.element_size() for a in inputs) + 11 * 4
        bound = _bound(nbytes, iters * N * R * 8 * 8 * 2)
        graphed = tg._programs.program((mode, tuple((a.shape, a.dtype) for a in inputs),
                                        T0.device, tuple(img) if img is not None else None,
                                        settings))
        nodes = {}
        for part, graph in zip(("prologue", "body"), graphed.graphs):
            c = (ctypes.c_int * 16)()
            kernels.check(lib.gn_while_node_types(
                ctypes.c_void_p(graph.raw_cuda_graph()), c), "node types")
            nodes[part] = {k: c[i] for i, k in enumerate(
                ("kernel", "memcpy", "memset")) if c[i]}
        out[name] = dict(same_bits=same, max_abs_err=err, iters=iters, plain_iters=int(plain[3]),
                         ok=bool(got[2]), ms=ms, plain_ms=plain_ms, **bound, nodes=nodes,
                         kernel_nodes_run=nodes["prologue"]["kernel"]
                         + iters * (nodes["body"]["kernel"] + 1))
        log(f"14b tracking GN device program ({name}, {N} points; route: one CUDA graph, "
            f"a WHILE conditional node over one captured iteration, csrc/gn_while.cu): "
            + json.dumps(out[name]))
    return out


def time_pipelines(dev, model, hw=(384, 512), n=WALL_FRAMES):
    """14c: SLAM.run of n ViT-L frames under the pinned ``speed`` config
    with ``engine.pipeline`` 0 and 1, twice each in turn (0, 1, 1, 0): run
    wall a frame and frame.latency p50 (host clock), and the same poses bit
    for bit.  The frames are one smooth image with a little smooth noise
    each (on the card), so that random weights still track every frame:
    unrelated images make the GN fail now and then, and a failed frame
    relocalises."""
    from mast3r_slam_tpu_torch.slam.pipeline import SLAM

    imgs = smooth_images(1, hw, dev, seed=3) + 0.02 * smooth_images(n, hw, dev, seed=4)
    runs = {0: [], 1: []}
    poses = {}
    for pipe in (0, 1, 1, 0):
        cfg = pinned_speed_cfg()
        cfg["engine"]["pipeline"] = pipe
        slam = SLAM(model, cfg, hw, keyframe_buffer=8, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        res = slam.run(ImageDataset(imgs), verbose=False)
        wall = (time.perf_counter() - t0) * 1e3
        slam.close()
        st = slam.timer.stats()
        runs[pipe].append(dict(wall_ms_a_frame=wall / n,
                               latency_p50_ms=st["frame.latency"]["p50_ms"],
                               n_keyframes=res.n_keyframes, n_reloc=res.n_reloc))
        poses.setdefault(pipe, res.frame_poses)
        if res.n_reloc or res.n_keyframes != 1:
            raise AssertionError(f"14c pipeline {pipe}: {res.n_keyframes} keyframes, "
                                 f"{res.n_reloc} reloc with the decisions pinned open")
    same = bool(np.array_equal(poses[0], poses[1]))
    log(f"14c ViT-L speed SLAM.run, {n} frames, pipeline 0 against 1 (host clock): "
        + json.dumps({"pipeline_0": runs[0], "pipeline_1": runs[1],
                      "same_pose_bits": same}))
    return dict(pipeline_0=runs[0], pipeline_1=runs[1], same_pose_bits=same)


def run_host_reads(dev, vitl, smi, hw=(384, 512)):
    """Phase 14: (a) the card's syncs a tracked frame and a backend task,
    (b) the device program against the plain loop, (c) what it changed."""
    model = speed_model(dev, vitl, hw)
    frames, encodes, where = count_frame_syncs(dev, model, hw)
    task_syncs, task_where, task_ms = count_task_syncs(dev, model, hw)
    for stack in sorted(set(where + task_where)):
        log("14a sync from:\n" + stack)
    log(f"14a syncs (set_sync_debug_mode warn): a tracked frame {frames} (infer, "
        f"track_submit_chained, track_finish), its encode {encodes}; a speed backend "
        f"task {task_syncs} ({task_ms:.3f} ms, host clock)")
    if frames != [1] * SYNC_FRAMES or task_syncs != 1:
        raise AssertionError(f"14a: {frames} syncs a tracked frame (expected one each), "
                             f"{task_syncs} a backend task (expected 1)")
    gn = check_tracking_gn(dev, hw)
    bad = {k: r for k, r in gn.items() if not (r["same_bits"] and r["iters"] == r["plain_iters"])}
    if bad or gn["ray_dist_singular"]["ok"] or not gn["ray_dist"]["ok"]:
        raise AssertionError(f"14b: the device program against the plain loop: {gn}")
    walls = time_pipelines(dev, model, hw)
    if not walls["same_pose_bits"]:
        raise AssertionError("14c: pipeline 1 gave other poses than pipeline 0")
    after = PROFILES.get("one tracked frame", {})
    speed_after = PROFILES.get("one speed tracked frame (bf16 heads)", {})
    log(f"14c phase 4's profiled frame: {after.get('launches')} launches (before: "
        f"{BEFORE_FRAME_LAUNCHES}), busy share {after.get('busy_share')} (before: "
        f"{BEFORE_BUSY_SHARE}); the speed frame {speed_after.get('launches')} launches, "
        f"busy share {speed_after.get('busy_share')}; {smi}")
    return dict(frame_syncs=frames, encode_syncs=encodes, task_syncs=task_syncs,
                task_ms=task_ms, tracking_gn=gn, pipelines=walls, frame_profile=after,
                speed_frame_profile=speed_after, card=smi)


# ---------------------------------------------------------------------------
# phase 15: the last reads cv2 gave the JAX package
# ---------------------------------------------------------------------------

EUROC_SEQ = "MH_colour"     # under a directory named euroc: the CLI's loader reads EuRoC
EUROC_T0_NS = 1403636579763555584
# cam0's sensor.yaml at 640x480: EuRoC cam0's focal lengths and distortion,
# the principal point at the centre
EUROC_SENSOR = """sensor_type: camera
rate_hz: 20
resolution: [640, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 320.0, 240.0]
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""
DECODE_REPEATS = 5         # 15a: decodes of each timed file (median, host clock)
# 15a's timed 480x640 files: a prefix cv2 smooths (2 of 10 scans), the whole
# progressive file it was cut from, and a baseline JPEG
TIMED_DECODES = {"smoothed_2_scans": "image_fixtures/progressive_480x640_2scans.jpg",
                 "whole_progressive": "image_fixtures/progressive_480x640.jpg",
                 "baseline": "image_folder/000.jpg"}


def fixture_faults(name, want):
    """The reads of one committed fixture that differ from its digests:
    imread_rgb, imread_gray and the server's decode_image_payload against
    the SHA-256 of cv2's colour or gray decode; a null digest (cv2 returns
    nothing) wants a ValueError."""
    import base64
    import hashlib

    from mast3r_slam_tpu_torch.data import png
    from mast3r_slam_tpu_torch.serve import server

    path = IMAGE_DATA / name

    def read(fn):
        try:
            return fn()
        except ValueError as e:
            return e

    rgb, gray = read(lambda: png.imread_rgb(path)), read(lambda: png.imread_gray(path))
    payload = read(lambda: server.decode_image_payload(
        base64.b64encode(path.read_bytes()).decode()))

    def same(img, digest, shape):
        if digest is None:
            return isinstance(img, ValueError)
        return (not isinstance(img, ValueError) and list(img.shape) == shape
                and hashlib.sha256(img.tobytes()).hexdigest() == digest)

    return [k for k, ok in (
        ("rgb", same(rgb, want["sha256"], want["shape"])),
        ("gray", same(gray, want["gray_sha256"], want["shape"][:2])),
        ("payload", isinstance(payload, ValueError) if want["sha256"] is None
         else not isinstance(rgb, ValueError) and np.array_equal(
             payload, rgb.astype(np.float32) / 255.0))) if not ok]


def check_last_reads():
    """15a: every committed fixture (tests/data/image_fixtures.json) through
    imread_rgb, imread_gray and the server's decode_image_payload, each
    against the committed SHA-256 of cv2's colour or gray decode (this host
    has no cv2); then TIMED_DECODES decoded to RGB and to gray,
    DECODE_REPEATS times each."""
    from mast3r_slam_tpu_torch.utils import native

    digests = json.loads((IMAGE_DATA / "image_fixtures.json").read_text())
    bad = {}
    for name, want in sorted(digests.items()):
        faults = fixture_faults(name, want)
        if faults:
            bad[name] = faults
    ms = {}
    for key, name in TIMED_DECODES.items():
        data = (IMAGE_DATA / name).read_bytes()
        for gray in (False, True):
            times = []
            for _ in range(DECODE_REPEATS):
                t0 = time.perf_counter()
                native.decode_jpeg(data, gray=gray)
                times.append((time.perf_counter() - t0) * 1e3)
            ms[f"{key}{'_gray' if gray else ''}"] = statistics.median(times)
    folders = collections.Counter(name.split("/")[0] for name in digests)
    out = dict(files=len(digests), by_folder=dict(folders), exact=len(digests) - len(bad),
               differ=bad, decode_ms=ms)
    log(f"15a fixtures read as RGB, gray and payload: {json.dumps(out)}")
    if bad:
        raise AssertionError(f"15a: the port's reads differ from cv2's decode: {bad}")
    return out


def write_euroc(root, frames):
    """A EuRoC folder (mav0/cam0/data.csv, sensor.yaml, data/) holding the
    given (suffix, bytes) frames 50 ms apart."""
    cam = root / "euroc" / EUROC_SEQ / "mav0" / "cam0"
    shutil.rmtree(cam.parents[1], ignore_errors=True)
    (cam / "data").mkdir(parents=True)
    rows = ["#timestamp [ns],filename"]
    for i, (suffix, data) in enumerate(frames):
        ts = EUROC_T0_NS + 50_000_000 * i
        (cam / "data" / f"{ts}{suffix}").write_bytes(data)
        rows.append(f"{ts},{ts}{suffix}")
    (cam / "data.csv").write_text("\n".join(rows) + "\n")
    (cam / "sensor.yaml").write_text(EUROC_SENSOR)
    return cam.parents[1]


def run_cli_euroc(dev, work, preset="vit_large", img_size=512, frames=None, label="15b",
                  what="colour frames read as gray"):
    """15b: ViT-L through the CLI (random weights, seed 0, 9b's pinned
    decisions, every frame: subsample 1) over a EuRoC folder whose frames
    are the committed colour image-folder frames (baseline and progressive
    JPEGs, a palette Adam7 PNG), which EuRoC's read converts to gray, or
    the (suffix, bytes) ``frames`` given; then over the control, a EuRoC
    folder of the gray reads written back as 8-bit RGB PNGs (gray
    replicated, which the conversion gives back); launch counters reset
    just before each run and read just after."""
    from mast3r_slam_tpu_torch.data import dataloader, png
    from mast3r_slam_tpu_torch.slam import run

    if frames is None:
        frames = [(pathlib.Path(f).suffix, pathlib.Path(f).read_bytes())
                  for f in dataloader.RGBFiles(IMAGE_DATA / "image_folder").rgb_files]
    colour = write_euroc(work / label / "colour", frames)
    files = sorted((colour / "mav0" / "cam0" / "data").iterdir())
    gray = [png.imread_gray(f) for f in files]
    control = write_euroc(work / label / "gray", [
        (".png", png.encode_png(np.repeat(g[..., None], 3, 2))) for g in gray])
    argv = ["--config", "eval_no_calib", "--device", str(dev), "--max-frames",
            str(CLI_VITL_FRAMES), "--model-preset",
            "vit_large" if preset == "vit_large" else "tiny", "--set", "dataset.subsample=1"]
    for ov in CLI_VITL_SET:
        argv += ["--set", ov]
    built, loaders = [], []
    real = run.build_slam

    def keep(cfg, dataset, **kw):
        loaders.append(type(dataset).__name__)
        slam = real(cfg, dataset, **kw)
        built.append(slam)
        return slam

    with swapped(run, "build_slam", keep), \
            swapped(dataloader.MonocularDataset, "img_size", img_size):
        res, counts, wall = run_cli(["--dataset", str(colour), "--save-as", f"euroc_{label}"]
                                    + argv)
        st = built[-1].timer.stats()
        del built[:]
        res2, counts2, wall2 = run_cli(["--dataset", str(control), "--save-as",
                                        f"euroc_{label}_gray"] + argv)
        st2 = built[-1].timer.stats()
        del built[:]
    same_bits = (np.array_equal(res.frame_poses, res2.frame_poses)
                 and np.array_equal(res.keyframe_poses, res2.keyframe_poses)
                 and res.keyframe_timestamps == res2.keyframe_timestamps)
    out = dict(frames=len(res.frame_timestamps), loaders=loaders,
               kinds=[image_kind(f) for f in files], n_keyframes=res.n_keyframes,
               n_tracked=st.get("tracker.track", {"count": 0})["count"],
               n_tasks=st.get("backend.update", {"count": 0})["count"], n_reloc=res.n_reloc,
               fps=res.fps, control_fps=res2.fps, wall_s=wall, control_wall_s=wall2,
               launches=counts, control_launches=counts2, same_bits=bool(same_bits),
               gray_levels=[float(g.mean()) for g in gray],
               ingest_ms_p50=st["ingest"]["p50_ms"], control_ingest_ms_p50=st2["ingest"]["p50_ms"])
    log(f"{label} CLI ({preset}, EuRoC layout, {len(files)} {what}, decisions pinned open) "
        f"{img_size}: {json.dumps(out)}")
    return out


def run_last_reads(dev, work, smi, preset="vit_large"):
    """Phase 15 (a)-(c), each checked; raises on any fault."""
    import base64

    fixtures = check_last_reads()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        euroc = run_cli_euroc(dev, work, preset=preset)
    finally:
        os.chdir(cwd)
    vc = euroc["launches"]
    want = {"attention": 72 * euroc["frames"] + 48 * euroc["n_tasks"],
            "refine_window": euroc["n_tracked"] + euroc["n_tasks"]}
    if ({k: vc[k] for k in want} != want or euroc["n_tasks"] < 1
            or vc["edge_hg_rays"] < euroc["n_tasks"] or euroc["control_launches"] != vc
            or not euroc["same_bits"] or euroc["frames"] != CLI_VITL_FRAMES
            or euroc["loaders"] != ["EurocDataset", "EurocDataset"]):
        raise AssertionError(
            f"15b EuRoC CLI over colour frames: launches {vc} (expected {want}: 72 attention a "
            f"frame and 48 a backend task, one refine a tracked frame and a task; edge_hg_rays "
            f">= {euroc['n_tasks']} tasks >= 1), gray control {euroc['control_launches']}, "
            f"same trajectory bits {euroc['same_bits']}, {euroc['frames']} frames, loaders "
            f"{euroc['loaders']}")
    paths = sorted((IMAGE_DATA / "serve_partial").iterdir())
    scans = [p.read_bytes().count(b"\xff\xda") for p in paths]
    served = run_serve_vitl(dev, work, preset=preset, label="15c",
                            what="480x640 progressive JPEGs cut after 2-9 scans",
                            payloads=[base64.b64encode(p.read_bytes()).decode() for p in paths])
    served["scans"] = scans
    sc = served["launches"]
    want_s = {"attention": 72 * served["frames"] + 48 * served["n_tasks"],
              "refine_window": served["n_tracked"] + served["n_tasks"]}
    if (served["faults"] or not served["same_bits_as_control"]
            or {k: sc[k] for k in want_s} != want_s
            or served["n_tasks"] != served["frames"] - 1 or sc["edge_hg_rays"] < served["n_tasks"]
            or scans != list(range(2, 2 + len(paths)))):
        raise AssertionError(
            f"15c ViT-L session over partial progressive frames: faults {served['faults']}, the "
            f"control's bits {served['same_bits_as_control']}, launches {sc} (expected "
            f"{want_s}: 72 attention a tracked frame and 48 a backend task, one refine a "
            f"tracked frame and a task; edge_hg_rays >= {served['n_tasks']} tasks = frames - "
            f"1), scans {scans}")
    dm = fixtures["decode_ms"]
    log(f"15 decode a 480x640 JPEG (host clock, median of {DECODE_REPEATS}): 2-scan prefix "
        f"smoothed {dm['smoothed_2_scans']:.2f} ms (gray {dm['smoothed_2_scans_gray']:.2f}), its "
        f"whole progressive file {dm['whole_progressive']:.2f} ms (gray "
        f"{dm['whole_progressive_gray']:.2f}), baseline {dm['baseline']:.2f} ms (gray "
        f"{dm['baseline_gray']:.2f}); EuRoC CLI ingest p50 {euroc['ingest_ms_p50']:.2f} ms over "
        f"colour frames, {euroc['control_ingest_ms_p50']:.2f} ms over the gray PNG control; "
        f"served partial frames send -> pose_update p50 {served['latency_ms_p50']:.1f} ms; "
        f"{smi}")
    return fixtures, euroc, {k: v for k, v in served.items() if k not in ("stages", "latency_ms")}


# ---------------------------------------------------------------------------
# phase 16: the last JPEG codings cv2 gives the JAX package (arithmetic
# coding, SOF9/SOF10 with DAC; lossless SOF3 through the gray read)
# ---------------------------------------------------------------------------

# 16a's timed 480x640 files, each beside the baseline file in the same call
TIMED_CODINGS = {"arithmetic": "image_fixtures/arith_480x640.jpg",
                 "arithmetic_progressive": "image_fixtures/arith_progressive_480x640.jpg",
                 "lossless": "image_fixtures/lossless_480x640.jpg",
                 "baseline": "image_folder/000.jpg"}
ARITH_SERVE_SEED = 11      # 16c: serve_images' seed (11b's smooth frames, which track)
LOSSLESS_REFUSED_AT = 4    # 16c: the gray lossless payload's place in the sending order


def jpeg_encoders():
    """tests/torch_jpeg_encoders.py (numpy only): the test-side arithmetic
    and lossless encoders, neither of which cv2 or PIL has."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_jpeg_encoders", REPO / "tests" / "torch_jpeg_encoders.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_last_codings():
    """16a: the arithmetic-coded and lossless fixtures (image_fixtures/
    arith_*, lossless_*) are among the digests 15a holds every read
    against (a null digest: cv2 returns nothing, the read must raise
    ValueError); here their count and refused reads, then TIMED_CODINGS
    decoded, DECODE_REPEATS times each (host clock, median), to RGB and to
    gray (lossless: gray alone)."""
    from mast3r_slam_tpu_torch.utils import native

    digests = json.loads((IMAGE_DATA / "image_fixtures.json").read_text())
    names = [n for n in sorted(digests) if n.split("/")[-1].startswith(("arith_", "lossless_"))]
    ms = {}
    for key, name in TIMED_CODINGS.items():
        data = (IMAGE_DATA / name).read_bytes()
        for gray in (False, True) if key != "lossless" else (True,):
            times = []
            for _ in range(DECODE_REPEATS):
                t0 = time.perf_counter()
                native.decode_jpeg(data, gray=gray)
                times.append((time.perf_counter() - t0) * 1e3)
            ms[f"{key}{'_gray' if gray else ''}"] = statistics.median(times)
    out = dict(files=len(names),
               refused_reads=sum((digests[n]["sha256"] is None) + (digests[n]["gray_sha256"]
                                                                   is None) for n in names),
               decode_ms=ms)
    log(f"16a arithmetic and lossless fixtures (read and checked in 15a): {json.dumps(out)}")
    if len(names) < 14:
        raise AssertionError(f"16a: {len(names)} arithmetic and lossless fixtures, expected 14")
    return out


def lossless_euroc_frames(enc):
    """16b: the committed image-folder frames' gray reads as lossless JPEG
    (predictors 1-7 in turn, every other frame with restarts): each decodes
    back to exactly the samples coded, and its colour read is refused (cv2
    returns nothing for it)."""
    from mast3r_slam_tpu_torch.data import dataloader, png
    from mast3r_slam_tpu_torch.utils import native

    frames, faults = [], []
    for i, f in enumerate(dataloader.RGBFiles(IMAGE_DATA / "image_folder").rgb_files):
        g = png.imread_gray(f)
        data = enc.lossless_jpeg(g, predictor=1 + i % 7, restart_rows=16 * (i % 2))
        if not np.array_equal(native.decode_jpeg(data, gray=True), g):
            faults.append(f"frame {i}: the gray read differs from the samples coded")
        try:
            native.decode_jpeg(data)
            faults.append(f"frame {i}: a colour read of one lossless component decoded")
        except ValueError:
            pass
        frames.append((".jpg", data))
    if faults:
        raise AssertionError(f"16b: {faults}")
    return frames


def arithmetic_payloads(dev, enc, n):
    """16c: serve_images' smooth 480x640 frames as arithmetic-coded JPEG,
    SOF9 and SOF10 in turn, every third with restarts, base64."""
    import base64

    return [base64.b64encode(enc.arithmetic_jpeg(
        img, quality=90, sampling="420", progressive=k % 2 == 1,
        restart=4 * (k % 3 == 2))).decode()
        for k, img in enumerate(serve_images(dev, n, seed=ARITH_SERVE_SEED))]


def run_last_codings(dev, work, smi, preset="vit_large"):
    """Phase 16 (a)-(c), each checked; raises on any fault."""
    import base64

    enc = jpeg_encoders()
    fixtures = check_last_codings()
    t0 = time.perf_counter()
    frames = lossless_euroc_frames(enc)
    encode_s = time.perf_counter() - t0
    cwd = os.getcwd()
    os.chdir(work)
    try:
        euroc = run_cli_euroc(dev, work, preset=preset, frames=frames, label="16b",
                              what="lossless gray frames")
    finally:
        os.chdir(cwd)
    vc = euroc["launches"]
    want = {"attention": 72 * euroc["frames"] + 48 * euroc["n_tasks"],
            "refine_window": euroc["n_tracked"] + euroc["n_tasks"]}
    if ({k: vc[k] for k in want} != want or euroc["n_tasks"] < 1
            or vc["edge_hg_rays"] < euroc["n_tasks"] or euroc["control_launches"] != vc
            or not euroc["same_bits"] or euroc["frames"] != CLI_VITL_FRAMES
            or euroc["loaders"] != ["EurocDataset", "EurocDataset"]
            or set(euroc["kinds"]) != {"lossless"}):
        raise AssertionError(
            f"16b EuRoC CLI over lossless gray frames: launches {vc} (expected {want}: 72 "
            f"attention a frame and 48 a backend task, one refine a tracked frame and a task; "
            f"edge_hg_rays >= {euroc['n_tasks']} tasks >= 1), gray PNG control "
            f"{euroc['control_launches']}, same trajectory bits {euroc['same_bits']}, "
            f"{euroc['frames']} frames, loaders {euroc['loaders']}, kinds {euroc['kinds']}")
    t0 = time.perf_counter()
    payloads = arithmetic_payloads(dev, enc, CLI_VITL_FRAMES)
    refused = base64.b64encode(enc.lossless_jpeg(
        serve_images(dev, 1, seed=ARITH_SERVE_SEED)[0][..., 1])).decode()
    encode_s += time.perf_counter() - t0
    served = run_serve_vitl(dev, work, preset=preset, label="16c",
                            what="480x640 arithmetic-coded JPEGs (SOF9, SOF10) and one lossless "
                                 "gray frame to drop",
                            payloads=payloads, refused={LOSSLESS_REFUSED_AT: refused})
    sc = served["launches"]
    want_s = {"attention": 72 * served["frames"] + 48 * served["n_tasks"],
              "refine_window": served["n_tracked"] + served["n_tasks"]}
    if (served["faults"] or not served["same_bits_as_control"]
            or {k: sc[k] for k in want_s} != want_s
            or served["n_tasks"] != served["frames"] - 1 or sc["edge_hg_rays"] < served["n_tasks"]
            or len(served["errors"]) != 1
            or "colour read of a one-component lossless JPEG" not in served["errors"][0]):
        raise AssertionError(
            f"16c ViT-L session over arithmetic-coded frames: faults {served['faults']}, the "
            f"control's bits {served['same_bits_as_control']}, launches {sc} (expected "
            f"{want_s}: 72 attention a tracked frame and 48 a backend task, one refine a "
            f"tracked frame and a task; edge_hg_rays >= {served['n_tasks']} tasks = frames - "
            f"1), errors {served['errors']} (one: the lossless frame dropped)")
    dm = fixtures["decode_ms"]
    log(f"16 decode a 480x640 JPEG (host clock, median of {DECODE_REPEATS}): arithmetic SOF9 "
        f"{dm['arithmetic']:.2f} ms (gray {dm['arithmetic_gray']:.2f}), SOF10 "
        f"{dm['arithmetic_progressive']:.2f} ms (gray {dm['arithmetic_progressive_gray']:.2f}), "
        f"lossless gray {dm['lossless_gray']:.2f} ms, baseline in the same call "
        f"{dm['baseline']:.2f} ms (gray {dm['baseline_gray']:.2f}); EuRoC CLI ingest p50 "
        f"{euroc['ingest_ms_p50']:.2f} ms over lossless frames, "
        f"{euroc['control_ingest_ms_p50']:.2f} ms over the PNG control; served arithmetic "
        f"frames send -> pose_update p50 {served['latency_ms_p50']:.1f} ms, p95 "
        f"{served['latency_ms_p95']:.1f}; test-side encoding {encode_s:.1f} s; {smi}")
    return fixtures, euroc, {k: v for k, v in served.items() if k not in ("stages", "latency_ms")}


# ---------------------------------------------------------------------------
# phase 17: the global solve as one device program a bucket
# ---------------------------------------------------------------------------

# flops of one pixel-edge of a calib or points block (plain torch): the
# reduction w·[J | err]ᵀ[J | err] of 3 rows, an (8, 3) x (3, 8) product
BLOCK_FLOPS_3_ROWS = 3 * 8 * 8 * 2
PROGRAM_SOLVES = ("rays_dense", "rays_pcg", "calib", "points")


def program_problems(dev, hw, n_kf, seed):
    """17a's solves on phase 6's scenes: name -> (entry, inputs, settings,
    mode, ground truth).  The rays scene through the cached entry (dense,
    then PCG), the calib scene through the cached entry, points mode through
    the gathering entry on the rays scene."""
    import torch
    from mast3r_slam_tpu_torch.ops.global_gn import GlobalGNSettings

    gt, noisy, Xs, Cs, ii, jj, idx, valid, Q, K = rays_problem(dev, hw, n_kf, seed)
    Kc, gt_c, noisy_c, Xs_c, Cs_c = calib_problem(dev, hw, n_kf, seed)
    ii, jj = ii.long(), jj.long()
    half = len(ii) // 2
    n_fused = torch.ones(n_kf, device=dev)
    idx = idx.contiguous()

    def cached(T, X, C, Kx):
        gath = torch.cat([X, C], dim=-1)[ii]  # identity matches
        return (T, X, C, n_fused, ii, jj, gath[:half], gath[half:], idx, valid, Q, Kx)

    return {
        "rays_dense": ("cached", cached(noisy, Xs, Cs, K), GlobalGNSettings(), "rays", gt),
        "rays_pcg": ("cached", cached(noisy, Xs, Cs, K), GlobalGNSettings(solver="pcg"),
                     "rays", gt),
        "calib": ("cached", cached(noisy_c, Xs_c, Cs_c, Kc), GlobalGNSettings(), "calib", gt_c),
        "points": ("poses", (noisy, Xs, Cs, ii, jj, idx, valid, Q, K), GlobalGNSettings(),
                   "points", gt),
    }


def check_global_program(dev, hw=(384, 512), n_kf=16, seed=5):
    """17a: the global GN's device program against the eager plain loop
    (``gn_loop``, frozen at max_iters) on the same inputs at full width: the
    same bits of the poses, iterations, ok and diverged; then a second
    call, with the counters reset just before and read just after and the
    card's syncs counted: one program launch, the edge-block kernel once an
    iteration that ran (rays), no sync, nothing built; the ground truth
    within SOLVE_BOUND_M; the program's time against the eager loop's (CUDA
    events) and the bound.  No program is kept at the start, so each
    first call builds one (``build_s``: the build and that call, host
    clock).  Returns {solve: record}."""
    import torch
    from mast3r_slam_tpu_torch.ops import global_gn as gn

    gn.clear_programs()
    out = {}
    for name, (entry, inputs, settings, mode, truth) in program_problems(
            dev, hw, n_kf, seed).items():
        fields = lambda: gn._entry_fields(entry, inputs, hw, settings, mode)
        plain = lambda: gn._gn_core(inputs[0], *fields(), inputs[-1], hw, settings, mode)
        program = lambda: gn.global_gn_graph(entry, inputs, hw, settings, mode)
        want = plain()
        t0 = time.perf_counter()
        got = program()  # its first call builds it
        sync(dev)
        build_s = time.perf_counter() - t0
        built = gn.programs_built()
        reset_counts()
        with counted_syncs() as seen:
            again = program()
        sync(dev)
        counts = read_counts()
        same = all(torch.equal(a, b) for a, b in zip(got, want)) and all(
            torch.equal(a, b) for a, b in zip(again, want))
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        iters, ok = int(got[1]), bool(got[2])
        ms = time_cuda(program, iters=3, warmup=0)
        plain_ms = time_cuda(plain, iters=1, warmup=0)
        E, N = inputs[4].shape[0], hw[0] * hw[1]
        nbytes = sum(a.numel() * a.element_size() for a in inputs) + sum(
            a.numel() * a.element_size() for a in got)
        flops = iters * E * N * (EDGE_HG_FLOPS if mode == "rays" else BLOCK_FLOPS_3_ROWS)
        rec = dict(entry=entry, mode=mode, route="pcg" if gn.routes_pcg(
            settings, inputs[0].shape[0]) else "dense", iters=iters,
            plain_iters=int(want[1]), ok=ok, diverged=bool(got[3]), same_bits=same,
            max_abs_err=err, program_launches=counts["global_gn_while"],
            edge_hg_launches=counts["edge_hg_rays"], syncs=len(seen),
            built_on_second_call=gn.programs_built() - built,
            err_m=(got[0][:, :3] - truth[:, :3]).norm(dim=-1).max().item(),
            ms=ms, plain_ms=plain_ms, build_s=build_s, **_bound(nbytes, flops))
        log(f"17a global GN device program, {name} ({n_kf} keyframes, {E} edges x {N} px): "
            + json.dumps(rec))
        for stack in seen:
            log("17a sync from:\n" + stack)
        if not (same and ok and 1 <= iters <= settings.max_iters
                and rec["program_launches"] == 1 and rec["syncs"] == 0
                and rec["built_on_second_call"] == 0
                and rec["edge_hg_launches"] == (iters if mode == "rays" else 0)
                and rec["err_m"] <= SOLVE_BOUND_M):
            raise AssertionError(f"17a {name}: {rec} (the plain loop's bits and iterations, "
                                 f"one launch, one edge-block launch an iteration in rays "
                                 f"mode, no sync, within {SOLVE_BOUND_M} m)")
        out[name] = rec
    return out


def run_program_task(dev, model, hw=(384, 512)):
    """17b: phase 6's ViT-L backend task (three keyframes, add_factors([1],
    [2]), solve) with the card's syncs counted apart for add_factors and the
    solve, the solve's iterations, edge-block and program launches, then
    solve_ms (host clock between synchronisations, median of 3)."""
    from mast3r_slam_tpu_torch.config import load_config
    from mast3r_slam_tpu_torch.slam import factor_graph as fg

    cfg = load_config("base")
    kf = vitl_keyframes(dev, model, hw)
    graph = fg.FactorGraph(model, cfg, kf, hw, edge_capacity=16)
    frac = cfg["local_opt"]["min_match_frac"]
    iters, spy = solve_iters(fg)
    sync(dev)
    t0 = time.perf_counter()
    with counted_syncs() as add_seen:
        added = graph.add_factors([1], [2], frac)
    graph.solve()  # the bucket's program is built here
    sync(dev)
    task_ms = (time.perf_counter() - t0) * 1e3
    reset_counts()
    with counted_syncs() as solve_seen:
        graph.solve()
    sync(dev)
    counts = read_counts()
    ms = []
    with spy:
        for _ in range(3):
            sync(dev)
            t0 = time.perf_counter()
            graph.solve()
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
    rec = dict(added=added, first_task_ms=task_ms, add_factors_syncs=len(add_seen),
               solve_syncs=len(solve_seen), iters=iters[-1],
               edge_hg_launches=counts["edge_hg_rays"],
               program_launches=counts["global_gn_while"], solve_ms=statistics.median(ms),
               solve_ms_runs=ms)
    log(f"17b ViT-L backend task {hw[0]}x{hw[1]} (base): " + json.dumps(rec))
    for stack in solve_seen:
        log("17b solve sync from:\n" + stack)
    if not (added and rec["solve_syncs"] == 0 and rec["program_launches"] == 1
            and rec["edge_hg_launches"] == rec["iters"] >= 1):
        raise AssertionError(f"17b ViT-L task: {rec} (a solve: no sync, one program "
                             f"launch, one edge-block launch an iteration that ran)")
    return rec


def program_bucket(entry, inputs, settings, mode):
    """A solve's device program as the cache groups it: ((entry, route),
    (mode, padded poses, padded edges, pin))."""
    from mast3r_slam_tpu_torch.ops import global_gn as gn

    P, E = inputs[0].shape[0], inputs[4 if entry == "cached" else 3].shape[0]
    route = "pcg" if gn.routes_pcg(settings, P) else "dense"
    return (entry, route), (mode, int(P), int(E), settings.pin)


def lru_builds(seq, cap):
    """Programs that an LRU cache of ``cap`` programs a group, empty at the
    start, builds over ``seq``, a sequence of (group, bucket)."""
    kept, built = {}, 0
    for group, bucket in seq:
        held = kept.setdefault(group, [])
        if bucket in held:
            held.remove(bucket)
        else:
            built += 1
            if len(held) >= cap:
                held.pop(0)
        held.append(bucket)
    return built


@contextlib.contextmanager
def programs_met(label, out):
    """Record the global solve's device programs met while the block runs
    into ``out[label]``: solves, buckets met, programs built (with the
    cache as it stood: more than the buckets met when it starts empty means
    rebuilds), the memory each program kept at the end holds, the builds
    an LRU cache of 1-8 programs a group would make from empty, and the
    sequence of buckets, run-length coded."""
    from mast3r_slam_tpu_torch.ops import global_gn as gn, gn_program

    real = gn.global_gn_graph
    seq = []

    def spy(entry, inputs, img_hw, settings, mode):
        seq.append(program_bucket(entry, inputs, settings, mode))
        return real(entry, inputs, img_hw, settings, mode)

    built = gn.programs_built()
    with swapped(gn, "global_gn_graph", spy):
        yield
    runs = []
    for g, b in seq:
        if runs and runs[-1][0] == [*g, *b]:
            runs[-1][1] += 1
        else:
            runs.append([[*g, *b], 1])
    rec = dict(solves=len(seq), buckets=len(set(seq)), built=gn.programs_built() - built,
               budget_mb=gn_program.PROGRAM_BYTES / 2 ** 20,
               held_mb=[b / 2 ** 20 for _, b in gn.programs()],
               lru_builds={c: lru_builds(seq, c) for c in range(1, 9)}, sequence=runs)
    out[label] = rec
    log(f"{label} global GN device programs met: " + json.dumps(rec))


def run_program_arc(dev, hw=(384, 512)):
    """17c: 10a's windowed arc (window_size 16, edge_recycle) from no program
    kept, a solve after every keyframe up to 48: full solves while the
    window holds every free pose (16, then 32 padded poses), windowed ones
    after, whose pinned context and kept edges change bucket as the loops
    come and go.  Each solve one program launch and one edge-block run an
    iteration that ran (counted by the kernel); every bucket met built once
    (no rebuild under the cache's cap); the device memory the programs
    hold (allocated and reserved, dropped with clear_programs)."""
    import gc

    import torch
    from mast3r_slam_tpu_torch.ops import global_gn as gn

    gn.clear_programs()
    gc.collect()
    torch.cuda.empty_cache()
    met = {}
    with programs_met("17c", met):
        run = run_windowed_solve(dev, hw, oracle=False,
                                 stages=tuple(range(2, WINDOW_STAGES[-1] + 1)), label="17c")
    sync(dev)
    kept = gn.programs()
    alloc, reserved = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
    gn.clear_programs()
    gc.collect()
    torch.cuda.empty_cache()
    sv = run["solves"]
    rec = dict(met["17c"], kept=len(kept), kept_mb=sum(b for _, b in kept) / 2 ** 20,
               iters=[r["iters"] for r in sv],
               program_launches=sum(r["program_launches"] for r in sv),
               edge_hg_launches=sum(r["edge_hg_launches"] for r in sv),
               ms=[round(r["ms"], 3) for r in sv],
               programs_allocated_mb=(alloc - torch.cuda.memory_allocated(dev)) / 2 ** 20,
               programs_reserved_mb=(reserved - torch.cuda.memory_reserved(dev)) / 2 ** 20)
    log("17c windowed arc, a solve a keyframe: " + json.dumps(
        {k: v for k, v in rec.items() if k != "sequence"}))
    if not (rec["solves"] == len(sv) and rec["buckets"] > 2
            and rec["built"] == rec["buckets"]
            and all(r["program_launches"] == 1 and r["edge_hg_launches"] == r["iters"] >= 1
                    and r["pre_window_same_bits"] for r in sv)):
        raise AssertionError(f"17c: {rec} (more than two buckets, each built once; a solve: "
                             f"one program launch, one edge-block run an iteration that ran, "
                             f"the pre-window poses' bits kept)")
    return rec


def run_global_program(dev, vitl, smi):
    """Phase 17 (a)-(c), each checked; raises on any fault."""
    t0 = time.perf_counter()
    solves = check_global_program(dev)
    task = run_program_task(dev, vitl)
    arc = run_program_arc(dev)
    log(f"17 global GN device program: phase 17 {time.perf_counter() - t0:.1f} s; {smi}")
    return dict(solves=solves, vitl_task=task, arc=arc, card=smi)



# ---------------------------------------------------------------------------
# phase 19: video input on the card's host
# ---------------------------------------------------------------------------

VIDEO_DATA = IMAGE_DATA / "video_fixtures"
VIDEO_CLIP = "mp4v_480x640_smooth.mp4"
VIDEO_CLIP_JPEG = "mp4v_480x640_smooth_frame0.jpg"
VIDEO_DECODE_PASSES = 5    # 19c: decodes of the whole clip, the median frame of all


def video_reads(ds, order):
    """SHA-256 of the dataset's uint8 frames at ``order``; None where the
    read raises ValueError (cv2's read failed there)."""
    import hashlib

    out = []
    for i in order:
        try:
            out.append(hashlib.sha256(ds.read_img(i).tobytes()).hexdigest())
        except ValueError:
            out.append(None)
    return out


def check_video_fixtures(digest_file="video_fixtures.json", tag="19a", part=None, skip=None):
    """19a (20a, 21a): every committed video fixture (whose name holds
    ``part``, if given, and not ``skip``) through the port's MP4Dataset: its sequential
    reads, its seeks in the committed order, its reads after subsample(4),
    the frame count and the fps against cv2's
    (tests/data/video_fixtures.json, h264_fixtures.json)."""
    from mast3r_slam_tpu_torch.data import video

    digests = json.loads((IMAGE_DATA / digest_file).read_text())
    if part is not None:
        digests = {k: v for k, v in digests.items() if part in k}
    if skip is not None:
        digests = {k: v for k, v in digests.items() if skip not in k}
    bad, frames = [], 0
    for name, want in sorted(digests.items()):
        path = IMAGE_DATA / name
        ds = video.MP4Dataset(path)
        got = dict(frame_count=ds.total_frames, fps=ds.fps,
                   frames=video_reads(ds, range(len(ds))),
                   shape=list(video.MP4Dataset(path).read_img(0).shape))
        order = [t for t, _ in want["seeks"]]
        got["seeks"] = [list(x) for x in zip(order, video_reads(video.MP4Dataset(path), order))]
        sub = video.MP4Dataset(path)
        sub.subsample(4)
        got["subsample4"] = video_reads(sub, range(len(sub)))
        frames += len(got["frames"]) + len(order) + len(got["subsample4"])
        if got != want:
            bad.append(name)
    out = dict(files=len(digests), reads=frames, exact=len(digests) - len(bad), differ=bad)
    log(f"{tag} video fixtures: {json.dumps(out)}")
    if bad:
        raise AssertionError(f"{tag}: the port's video reads differ from cv2's on {bad}")
    return out


def run_cli_video(dev, work, preset="vit_large", img_size=512, clip_name=VIDEO_CLIP, tag="19b",
                  save="video"):
    """19b (20b): ViT-L through the CLI (random weights, seed 0, 9b's pinned
    decisions, every frame: subsample 1) over a committed 480x640 clip
    (mp4v; H.264), then over the control, a folder of 8-bit RGB PNGs of the
    port's decode of its frames, which 19a (20a) holds to cv2's (the folder
    loader's timestamps, i / 30, are the clip's at 30 fps); launch counters
    reset just before each run and read just after.  The trajectories and
    the keyframe PNGs must hold the same bits."""
    from mast3r_slam_tpu_torch.data import dataloader, png, video
    from mast3r_slam_tpu_torch.slam import run

    clip = VIDEO_DATA / clip_name
    ds = video.MP4Dataset(clip)
    control = work / f"{save}_png"
    shutil.rmtree(control, ignore_errors=True)
    for i in range(len(ds)):
        png.write_png(control / f"{i:03d}.png", ds.read_img(i))
    argv = ["--config", "eval_no_calib", "--device", str(dev), "--max-frames", str(len(ds)),
            "--model-preset", "vit_large" if preset == "vit_large" else "tiny",
            "--set", "dataset.subsample=1"]
    for ov in CLI_VITL_SET:
        argv += ["--set", ov]
    built, loaders = [], []
    real = run.build_slam

    def keep(cfg, dataset, **kw):
        loaders.append(type(dataset).__name__)
        slam = real(cfg, dataset, **kw)
        built.append(slam)
        return slam

    with swapped(run, "build_slam", keep), \
            swapped(dataloader.MonocularDataset, "img_size", img_size):
        res, counts, wall = run_cli(["--dataset", str(clip), "--save-as", save] + argv)
        st = built[-1].timer.stats()
        del built[:]
        res2, counts2, wall2 = run_cli(["--dataset", str(control), "--save-as", f"{save}_png"]
                                       + argv)
        st2 = built[-1].timer.stats()
        del built[:]
    same_bits = (np.array_equal(res.frame_poses, res2.frame_poses)
                 and np.array_equal(res.keyframe_poses, res2.keyframe_poses)
                 and res.keyframe_timestamps == res2.keyframe_timestamps)
    kf = sorted((pathlib.Path(f"logs/{save}/keyframes") / clip.stem).iterdir())
    kf2 = sorted((pathlib.Path(f"logs/{save}_png/keyframes") / control.name).iterdir())
    same_keyframes = ([p.name for p in kf] == [p.name for p in kf2]
                      and all(a.read_bytes() == b.read_bytes() for a, b in zip(kf, kf2)))
    out = dict(frames=len(res.frame_timestamps), clip_frames=len(ds), loaders=loaders,
               n_keyframes=res.n_keyframes, keyframe_pngs=len(kf),
               n_tracked=st.get("tracker.track", {"count": 0})["count"],
               n_tasks=st.get("backend.update", {"count": 0})["count"], n_reloc=res.n_reloc,
               fps=res.fps, control_fps=res2.fps, wall_s=wall, control_wall_s=wall2,
               launches=counts, control_launches=counts2, same_bits=bool(same_bits),
               same_keyframe_pngs=bool(same_keyframes),
               ingest_ms_p50=st["ingest"]["p50_ms"], control_ingest_ms_p50=st2["ingest"]["p50_ms"])
    log(f"{tag} CLI ({preset}, {len(ds)} frames of {clip_name}, decisions pinned open) "
        f"{img_size}: {json.dumps(out)}")
    return out


def check_cli_video(cli, what, tag):
    """19b (20b)'s launches against the frames and tasks, and the bits
    against the PNG control's; raises on any fault."""
    vc = cli["launches"]
    want = {"attention": 72 * cli["frames"] + 48 * cli["n_tasks"],
            "refine_window": cli["n_tracked"] + cli["n_tasks"]}
    if ({k: vc[k] for k in want} != want or cli["n_tasks"] < 1
            or vc["edge_hg_rays"] < cli["n_tasks"] or cli["control_launches"] != vc
            or not cli["same_bits"] or not cli["same_keyframe_pngs"]
            or cli["frames"] != cli["clip_frames"]
            or cli["loaders"] != ["MP4Dataset", "RGBFiles"]):
        raise AssertionError(
            f"{tag} CLI over {what}: launches {vc} (expected {want}: 72 attention a "
            f"frame and 48 a backend task, one refine a tracked frame and a task; edge_hg_rays "
            f">= {cli['n_tasks']} tasks >= 1), PNG control {cli['control_launches']}, "
            f"same trajectory bits {cli['same_bits']}, same keyframe PNGs "
            f"{cli['same_keyframe_pngs']}, {cli['frames']} of {cli['clip_frames']} frames, "
            f"loaders {cli['loaders']}")


def time_video_decode():
    """19c: host milliseconds of a 480x640 frame's decode (the sample
    through the MPEG-4 decoder and its conversion to RGB), median over
    VIDEO_DECODE_PASSES decodes of every frame of the clip, I- and P-VOPs
    apart; beside the median of as many decodes of the committed baseline
    JPEG of its first frame."""
    from mast3r_slam_tpu_torch.data import video
    from mast3r_slam_tpu_torch.utils import native

    data, track = video.read_track(VIDEO_DATA / VIDEO_CLIP)
    samples = [data[int(a):int(a) + int(n)] for a, n in zip(track.offsets, track.sizes)]
    ms = {"i_vop": [], "p_vop": []}
    for _ in range(VIDEO_DECODE_PASSES):
        dec = native.Mpeg4Decoder(track.config)
        for i, sample in enumerate(samples):
            t0 = time.perf_counter()
            dec.decode(sample)
            dec.rgb()
            ms["i_vop" if track.sync[i] else "p_vop"].append((time.perf_counter() - t0) * 1e3)
        dec.close()
    jpeg = (VIDEO_DATA / VIDEO_CLIP_JPEG).read_bytes()
    jms = []
    for _ in range(VIDEO_DECODE_PASSES * len(samples)):
        t0 = time.perf_counter()
        native.decode_jpeg(jpeg)
        jms.append((time.perf_counter() - t0) * 1e3)
    out = dict(frame_ms=statistics.median(ms["i_vop"] + ms["p_vop"]),
               i_vop_ms=statistics.median(ms["i_vop"]), p_vop_ms=statistics.median(ms["p_vop"]),
               jpeg_ms=statistics.median(jms), frames=len(samples),
               i_vops=int(track.sync.sum()), passes=VIDEO_DECODE_PASSES,
               clip_bytes=len(data), jpeg_bytes=len(jpeg))
    log(f"19c decode a 480x640 frame (host clock): {json.dumps(out)}")
    return out


def run_video_input(dev, work, smi):
    """Phase 19 (a)-(c), each checked; raises on any fault."""
    t0 = time.perf_counter()
    fixtures = check_video_fixtures()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli = run_cli_video(dev, work)
    finally:
        os.chdir(cwd)
    check_cli_video(cli, "the mp4v clip", "19b")
    decode = time_video_decode()
    log(f"19 video input: a 480x640 mp4v frame decodes in {decode['frame_ms']:.3f} ms (I-VOP "
        f"{decode['i_vop_ms']:.3f}, P-VOP {decode['p_vop_ms']:.3f}) against "
        f"{decode['jpeg_ms']:.3f} ms for the baseline JPEG of its first frame (host clock); "
        f"the CLI's ingest p50 {cli['ingest_ms_p50']:.2f} ms over the clip, "
        f"{cli['control_ingest_ms_p50']:.2f} ms over its PNG control; phase 19 "
        f"{time.perf_counter() - t0:.1f} s; {smi}")
    return fixtures, cli, decode


# ---------------------------------------------------------------------------
# phase 20: H.264 video input on the card's host
# ---------------------------------------------------------------------------

H264_CLIP = "h264_480x640_smooth.mp4"
H264_BIG = "h264_1080x1920_smooth.mp4"


def _h264_decode_ms(name, passes):
    """Host milliseconds of each sample's decode and conversion to RGB,
    IDR and P pictures apart, over ``passes`` decodes of the whole file."""
    from mast3r_slam_tpu_torch.data import video
    from mast3r_slam_tpu_torch.utils import native

    data, track = video.read_track(VIDEO_DATA / name)
    samples = [data[int(a):int(a) + int(n)] for a, n in zip(track.offsets, track.sizes)]
    ms = {"idr": [], "p": []}
    for _ in range(passes):
        dec = native.H264Decoder(track.config, track.length_size)
        for i, sample in enumerate(samples):
            t0 = time.perf_counter()
            if dec.decode(sample, i) is None:
                raise AssertionError(f"20c: {name} sample {i} output no picture")
            dec.rgb()
            ms["idr" if track.sync[i] else "p"].append((time.perf_counter() - t0) * 1e3)
        dec.close()
    return dict(frame_ms=statistics.median(ms["idr"] + ms["p"]),
                idr_ms=statistics.median(ms["idr"]), p_ms=statistics.median(ms["p"]),
                frames=len(samples), idr_pictures=int(track.sync.sum()), passes=passes,
                file_bytes=len(data))


def time_h264_decode():
    """20c: host milliseconds of a 480x640 H.264 frame's decode (the sample
    through the H.264 decoder and its conversion to RGB), median over
    VIDEO_DECODE_PASSES decodes of every frame of the clip, IDR and P
    pictures apart; in the same call 19c's mp4v frame and baseline JPEG,
    and a 1920x1080 H.264 frame (an IDR and two P pictures)."""
    out = dict(h264_480x640=_h264_decode_ms(H264_CLIP, VIDEO_DECODE_PASSES),
               h264_1080x1920=_h264_decode_ms(H264_BIG, VIDEO_DECODE_PASSES),
               mp4v_and_jpeg_480x640=time_video_decode())
    log(f"20c decode (host clock): {json.dumps(out)}")
    return out


def run_h264_input(dev, work, smi):
    """Phase 20 (a)-(c), each checked; raises on any fault."""
    t0 = time.perf_counter()
    fixtures = check_video_fixtures("h264_fixtures.json", "20a")
    digests = json.loads((IMAGE_DATA / "h264_fixtures.json").read_text())
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli = run_cli_video(dev, work, clip_name=H264_CLIP, tag="20b", save="h264")
    finally:
        os.chdir(cwd)
    import hashlib

    from mast3r_slam_tpu_torch.data import png

    control = sorted((work / "h264_png").iterdir())
    cli["control_is_cv2s"] = ([hashlib.sha256(png.read_png(p).tobytes()).hexdigest()
                               for p in control]
                              == digests[f"video_fixtures/{H264_CLIP}"]["frames"])
    if not cli["control_is_cv2s"]:
        raise AssertionError("20b: the PNG control's frames are not cv2's by the digests")
    check_cli_video(cli, "the H.264 clip", "20b")
    decode = time_h264_decode()
    small, big = decode["h264_480x640"], decode["h264_1080x1920"]
    old = decode["mp4v_and_jpeg_480x640"]
    log(f"20 H.264 input: a 480x640 H.264 frame decodes in {small['frame_ms']:.3f} ms (IDR "
        f"{small['idr_ms']:.3f}, P {small['p_ms']:.3f}), an mp4v one in {old['frame_ms']:.3f} "
        f"ms, the baseline JPEG in {old['jpeg_ms']:.3f} ms; 1920x1080 H.264 "
        f"{big['frame_ms']:.3f} ms (IDR {big['idr_ms']:.3f}, P {big['p_ms']:.3f}) (host "
        f"clock); the CLI's ingest p50 {cli['ingest_ms_p50']:.2f} ms over the clip, "
        f"{cli['control_ingest_ms_p50']:.2f} ms over its PNG control; phase 20 "
        f"{time.perf_counter() - t0:.1f} s; {smi}")
    return fixtures, cli, decode


# ---------------------------------------------------------------------------
# phase 21: CABAC H.264 input, and JPEG restart resync, on the card's host
# ---------------------------------------------------------------------------

H264_CABAC_CLIP = "h264_cabac_480x640_smooth.mp4"
H264_CABAC_BIG = "h264_cabac_1080x1920_smooth.mp4"


def check_resync_fixtures():
    """21a: every committed JPEG whose restart markers are out of place
    (tests/data/resync_fixtures.json) through imread_rgb, imread_gray and
    decode_image_payload, against the committed SHA-256 of cv2's colour
    and gray decodes."""
    digests = json.loads((IMAGE_DATA / "resync_fixtures.json").read_text())
    bad = {}
    for name, want in sorted(digests.items()):
        faults = fixture_faults(name, want)
        if faults:
            bad[name] = faults
    out = dict(files=len(digests), exact=len(digests) - len(bad), differ=bad)
    log(f"21a JPEG resync fixtures read as RGB, gray and payload: {json.dumps(out)}")
    if bad:
        raise AssertionError(f"21a: the port's reads differ from cv2's decode: {bad}")
    return out


def time_cabac_decode():
    """21c: host milliseconds of a frame's decode and conversion to RGB,
    IDR and P pictures apart, under CABAC beside CAVLC, at 480x640 (14
    frames) and 1920x1080 (an IDR and two P pictures), median over
    VIDEO_DECODE_PASSES decodes of each file, all in one call."""
    out = {name: _h264_decode_ms(clip, VIDEO_DECODE_PASSES)
           for name, clip in (("cabac_480x640", H264_CABAC_CLIP),
                              ("cavlc_480x640", H264_CLIP),
                              ("cabac_1080x1920", H264_CABAC_BIG),
                              ("cavlc_1080x1920", H264_BIG))}
    log(f"21c decode (host clock): {json.dumps(out)}")
    return out


def run_cabac_input(dev, work, smi):
    """Phase 21 (a)-(c), each checked; raises on any fault."""
    import hashlib

    from mast3r_slam_tpu_torch.data import png

    t0 = time.perf_counter()
    fixtures = dict(h264=check_video_fixtures("h264_fixtures.json", "21a", part="cabac"),
                    jpeg_resync=check_resync_fixtures())
    if fixtures["h264"]["files"] < 3:
        raise AssertionError(f"21a: {fixtures['h264']['files']} CABAC fixtures, 3 expected")
    digests = json.loads((IMAGE_DATA / "h264_fixtures.json").read_text())
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli = run_cli_video(dev, work, clip_name=H264_CABAC_CLIP, tag="21b", save="h264_cabac")
    finally:
        os.chdir(cwd)
    control = sorted((work / "h264_cabac_png").iterdir())
    cli["control_is_cv2s"] = ([hashlib.sha256(png.read_png(p).tobytes()).hexdigest()
                               for p in control]
                              == digests[f"video_fixtures/{H264_CABAC_CLIP}"]["frames"])
    if not cli["control_is_cv2s"]:
        raise AssertionError("21b: the PNG control's frames are not cv2's by the digests")
    check_cli_video(cli, "the CABAC clip", "21b")
    decode = time_cabac_decode()
    ms = {k: f"{r['frame_ms']:.3f} (IDR {r['idr_ms']:.3f}, P {r['p_ms']:.3f})"
          for k, r in decode.items()}
    log(f"21 CABAC input: a frame decodes in {json.dumps(ms)} ms (host clock); the CLI's "
        f"ingest p50 {cli['ingest_ms_p50']:.2f} ms over the CABAC clip, "
        f"{cli['control_ingest_ms_p50']:.2f} ms over its PNG control; phase 21 "
        f"{time.perf_counter() - t0:.1f} s; {smi}")
    return fixtures, cli, decode


# ---------------------------------------------------------------------------
# phase 22: H.264 B pictures, weighted prediction and reordered output
# ---------------------------------------------------------------------------

H264_B_CLIP = "h264_b_480x640_smooth.mp4"
H264_B_BIG = "h264_b_1080x1920_smooth.mp4"


def _picture_kind(sample, length_size):
    """"idr", "i", "p" or "b": the slice_type of a sample's first slice."""
    units, at = [], 0
    while at + length_size <= len(sample):  # NAL units behind their lengths (avcC)
        n = int.from_bytes(sample[at:at + length_size], "big")
        units.append(sample[at + length_size:at + length_size + n])
        at += length_size + n
    for u in units:
        if u[0] & 31 in (1, 5):
            bits = "".join(format(c, "08b") for c in u[1:9])
            pos, vals = 0, []
            for _ in range(2):  # first_mb_in_slice, slice_type: ue(v)
                zeros = bits.index("1", pos) - pos
                vals.append(int(bits[pos + zeros:pos + 2 * zeros + 1], 2) - 1)
                pos += 2 * zeros + 1
            return "idr" if u[0] & 31 == 5 else "pbi"[vals[1] % 5] if vals[1] % 5 < 3 else "sp"
    raise AssertionError("22c: a sample without a slice")


def _h264_b_decode_ms(name, passes):
    """Host milliseconds of each sample's decode, and of the conversion to
    RGB of the picture it lets out, by the kind of picture decoded (IDR, P,
    B: the B pictures come out in display order, later than they go in),
    over ``passes`` decodes of the whole file, the held pictures drained."""
    from mast3r_slam_tpu_torch.data import video
    from mast3r_slam_tpu_torch.utils import native

    data, track = video.read_track(VIDEO_DATA / name)
    samples = [data[int(a):int(a) + int(n)] for a, n in zip(track.offsets, track.sizes)]
    kinds = [_picture_kind(s, track.length_size) for s in samples]
    ms = {k: [] for k in ("idr", "p", "b")}
    shown = 0
    for _ in range(passes):
        dec = native.H264Decoder(track.config, track.length_size)
        dec.delay(track.video_delay)  # the delay cv2's decoder starts with (ctts)
        for i, sample in enumerate(samples):
            t0 = time.perf_counter()
            if dec.decode(sample, i) is not None:
                dec.rgb()
                shown += 1
            ms[kinds[i]].append((time.perf_counter() - t0) * 1e3)
        while dec.drain() is not None:
            dec.rgb()
            shown += 1
        dec.close()
    if shown != passes * len(samples):
        raise AssertionError(f"22c: {name} output {shown} of {passes * len(samples)} pictures")
    return dict({f"{k}_ms": statistics.median(v) for k, v in ms.items()},
                frame_ms=statistics.median(ms["idr"] + ms["p"] + ms["b"]), frames=len(samples),
                pictures={k: kinds.count(k) for k in ms}, passes=passes, file_bytes=len(data))


def time_bframe_decode():
    """22c: host milliseconds of an IDR, a P and a B picture's decode and
    conversion to RGB, at 480x640 (the 22b clip, 14 frames) and 1920x1080
    (an IDR, a P and a B picture), median over VIDEO_DECODE_PASSES decodes
    of each file, in one call."""
    out = dict(b_480x640=_h264_b_decode_ms(H264_B_CLIP, VIDEO_DECODE_PASSES),
               b_1080x1920=_h264_b_decode_ms(H264_B_BIG, VIDEO_DECODE_PASSES))
    log(f"22c decode (host clock): {json.dumps(out)}")
    return out


def run_bframe_input(dev, work, smi):
    """Phase 22 (a)-(c), each checked; raises on any fault."""
    import hashlib

    from mast3r_slam_tpu_torch.data import png

    t0 = time.perf_counter()
    fixtures = check_video_fixtures("h264_fixtures.json", "22a", part="h264_b_")
    if fixtures["files"] < 6:
        raise AssertionError(f"22a: {fixtures['files']} B-picture fixtures, 6 expected")
    digests = json.loads((IMAGE_DATA / "h264_fixtures.json").read_text())
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli = run_cli_video(dev, work, clip_name=H264_B_CLIP, tag="22b", save="h264_b")
    finally:
        os.chdir(cwd)
    control = sorted((work / "h264_b_png").iterdir())
    cli["control_is_cv2s"] = ([hashlib.sha256(png.read_png(p).tobytes()).hexdigest()
                               for p in control]
                              == digests[f"video_fixtures/{H264_B_CLIP}"]["frames"])
    if not cli["control_is_cv2s"]:
        raise AssertionError("22b: the PNG control's frames are not cv2's by the digests")
    check_cli_video(cli, "the B-picture clip", "22b")
    decode = time_bframe_decode()
    ms = {k: f"{r['frame_ms']:.3f} (IDR {r['idr_ms']:.3f}, P {r['p_ms']:.3f}, B "
             f"{r['b_ms']:.3f})" for k, r in decode.items()}
    log(f"22 B pictures: a frame decodes in {json.dumps(ms)} ms (host clock); the CLI's "
        f"ingest p50 {cli['ingest_ms_p50']:.2f} ms over the B clip, "
        f"{cli['control_ingest_ms_p50']:.2f} ms over its PNG control; phase 22 "
        f"{time.perf_counter() - t0:.1f} s; {smi}")
    return fixtures, cli, decode


# ---------------------------------------------------------------------------
# phase 23: HEVC video input (Main profile I and P pictures) on the card's host
# ---------------------------------------------------------------------------

HEVC_CLIP = "hevc_480x640_smooth.mp4"
HEVC_BIG = "hevc_1080x1920_smooth.mp4"


def _hevc_decode_ms(name, passes):
    """Host milliseconds of each sample's decode and conversion to RGB, IRAP
    and P pictures apart, over ``passes`` decodes of the whole file (the
    SPS asks for no reorder delay: each sample lets its own picture out)."""
    from mast3r_slam_tpu_torch.data import video
    from mast3r_slam_tpu_torch.utils import native

    data, track = video.read_track(VIDEO_DATA / name)
    samples = [data[int(a):int(a) + int(n)] for a, n in zip(track.offsets, track.sizes)]
    ms = {"idr": [], "p": []}
    for _ in range(passes):
        dec = native.HevcDecoder(track.config, track.length_size)
        for i, sample in enumerate(samples):
            t0 = time.perf_counter()
            if dec.decode(sample, i) != i:
                raise AssertionError(f"23c: {name} sample {i} did not output its picture")
            dec.rgb()
            ms["idr" if track.sync[i] else "p"].append((time.perf_counter() - t0) * 1e3)
        dec.close()
    return dict(frame_ms=statistics.median(ms["idr"] + ms["p"]),
                idr_ms=statistics.median(ms["idr"]), p_ms=statistics.median(ms["p"]),
                frames=len(samples), idr_pictures=int(track.sync.sum()), passes=passes,
                file_bytes=len(data))


def time_hevc_decode():
    """23c: host milliseconds of an HEVC frame's decode and conversion to
    RGB, IDR and P pictures apart, at 480x640 (the 23b clip, 14 frames) and
    1920x1080 (an IDR and two P pictures, the last CTB row cut short),
    beside H.264 CABAC's at both sizes, median over VIDEO_DECODE_PASSES
    decodes of each file, all in one call."""
    out = dict(hevc_480x640=_hevc_decode_ms(HEVC_CLIP, VIDEO_DECODE_PASSES),
               hevc_1080x1920=_hevc_decode_ms(HEVC_BIG, VIDEO_DECODE_PASSES),
               cabac_480x640=_h264_decode_ms(H264_CABAC_CLIP, VIDEO_DECODE_PASSES),
               cabac_1080x1920=_h264_decode_ms(H264_CABAC_BIG, VIDEO_DECODE_PASSES))
    log(f"23c decode (host clock): {json.dumps(out)}")
    return out


def run_hevc_input(dev, work, smi):
    """Phase 23 (a)-(c), each checked; raises on any fault."""
    import hashlib

    from mast3r_slam_tpu_torch.data import png

    t0 = time.perf_counter()
    fixtures = check_video_fixtures("hevc_fixtures.json", "23a", skip="hevc_b_")
    if fixtures["files"] < 6:
        raise AssertionError(f"23a: {fixtures['files']} HEVC fixtures, 6 expected")
    digests = json.loads((IMAGE_DATA / "hevc_fixtures.json").read_text())
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli = run_cli_video(dev, work, clip_name=HEVC_CLIP, tag="23b", save="hevc")
    finally:
        os.chdir(cwd)
    control = sorted((work / "hevc_png").iterdir())
    cli["control_is_cv2s"] = ([hashlib.sha256(png.read_png(p).tobytes()).hexdigest()
                               for p in control]
                              == digests[f"video_fixtures/{HEVC_CLIP}"]["frames"])
    if not cli["control_is_cv2s"]:
        raise AssertionError("23b: the PNG control's frames are not cv2's by the digests")
    check_cli_video(cli, "the HEVC clip", "23b")
    decode = time_hevc_decode()
    ms = {k: f"{r['frame_ms']:.3f} (IDR {r['idr_ms']:.3f}, P {r['p_ms']:.3f})"
          for k, r in decode.items()}
    log(f"23 HEVC input: a frame decodes in {json.dumps(ms)} ms (host clock); the CLI's "
        f"ingest p50 {cli['ingest_ms_p50']:.2f} ms over the HEVC clip, "
        f"{cli['control_ingest_ms_p50']:.2f} ms over its PNG control; phase 23 "
        f"{time.perf_counter() - t0:.1f} s; {smi}")
    return fixtures, cli, decode


# ---------------------------------------------------------------------------
# phase 24: HEVC B slices and leading pictures on the card's host
# ---------------------------------------------------------------------------

HEVC_B_CLIP = "hevc_b_480x640_smooth.mp4"
HEVC_B_BIG = "hevc_b_1080x1920_smooth.mp4"


def _hevc_picture_kind(sample, length_size):
    """An HEVC sample's picture: "idr", "cra" or "bla" by its first slice's
    NAL unit type, else "p" or "b" by its slice_type (read after
    first_slice_segment_in_pic_flag and slice_pic_parameter_set_id: the
    smooth streams' PPS has no extra slice header bits)."""
    at = 0
    while at + length_size <= len(sample):
        n = int.from_bytes(sample[at:at + length_size], "big")
        unit = bytes(sample[at + length_size:at + length_size + n])
        at += length_size + n
        typ = (unit[0] >> 1) & 63
        if typ > 31:
            continue
        if 16 <= typ <= 23:
            return "idr" if typ in (19, 20) else "cra" if typ == 21 else "bla"
        bits = "".join(format(c, "08b") for c in unit[2:10])
        pos, vals = 1, []
        for _ in range(2):  # ue(v)
            zeros = bits.index("1", pos) - pos
            vals.append(int(bits[pos + zeros:pos + 2 * zeros + 1], 2) - 1)
            pos += 2 * zeros + 1
        return "bpi"[vals[1]]
    raise AssertionError("24c: a sample without a slice")


def _hevc_b_decode_ms(name, passes):
    """Host milliseconds of each sample's decode, and of the conversion to
    RGB of the picture it lets out, by the kind of picture decoded (IDR,
    CRA, P, B: pictures come out in display order, later than they go
    in), over ``passes`` decodes of the whole file, the held ones drained."""
    from mast3r_slam_tpu_torch.data import video
    from mast3r_slam_tpu_torch.utils import native

    data, track = video.read_track(VIDEO_DATA / name)
    samples = [data[int(a):int(a) + int(n)] for a, n in zip(track.offsets, track.sizes)]
    kinds = [_hevc_picture_kind(s, track.length_size) for s in samples]
    ms = {k: [] for k in sorted(set(kinds))}
    shown = 0
    for _ in range(passes):
        dec = native.HevcDecoder(track.config, track.length_size)
        for i, sample in enumerate(samples):
            t0 = time.perf_counter()
            if dec.decode(sample, i) is not None:
                dec.rgb()
                shown += 1
            ms[kinds[i]].append((time.perf_counter() - t0) * 1e3)
        while dec.drain() is not None:
            dec.rgb()
            shown += 1
        dec.close()
    if shown != passes * len(samples):
        raise AssertionError(f"24c: {name} output {shown} of {passes * len(samples)} pictures")
    return dict({f"{k}_ms": statistics.median(v) for k, v in ms.items()},
                frame_ms=statistics.median([v for vs in ms.values() for v in vs]),
                frames=len(samples), pictures={k: kinds.count(k) for k in ms}, passes=passes,
                file_bytes=len(data))


def time_hevc_b_decode():
    """24c: host milliseconds of an HEVC IDR, P and B picture's decode and
    conversion to RGB at 480x640 (the 24b clip, 14 frames, a CRA picture
    among them) and 1920x1080 (an IDR, a P and a B picture), beside the
    P-only clips' IDR and P pictures (23c's), median over
    VIDEO_DECODE_PASSES decodes of each file, all in one call."""
    out = dict(b_480x640=_hevc_b_decode_ms(HEVC_B_CLIP, VIDEO_DECODE_PASSES),
               b_1080x1920=_hevc_b_decode_ms(HEVC_B_BIG, VIDEO_DECODE_PASSES),
               p_480x640=_hevc_decode_ms(HEVC_CLIP, VIDEO_DECODE_PASSES),
               p_1080x1920=_hevc_decode_ms(HEVC_BIG, VIDEO_DECODE_PASSES))
    log(f"24c decode (host clock): {json.dumps(out)}")
    return out


def run_hevc_b_input(dev, work, smi):
    """Phase 24 (a)-(c), each checked; raises on any fault."""
    import hashlib

    from mast3r_slam_tpu_torch.data import png

    t0 = time.perf_counter()
    fixtures = check_video_fixtures("hevc_fixtures.json", "24a", part="hevc_b_")
    if fixtures["files"] < 6:
        raise AssertionError(f"24a: {fixtures['files']} HEVC B fixtures, 6 expected")
    digests = json.loads((IMAGE_DATA / "hevc_fixtures.json").read_text())
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli = run_cli_video(dev, work, clip_name=HEVC_B_CLIP, tag="24b", save="hevc_b")
    finally:
        os.chdir(cwd)
    control = sorted((work / "hevc_b_png").iterdir())
    cli["control_is_cv2s"] = ([hashlib.sha256(png.read_png(p).tobytes()).hexdigest()
                               for p in control]
                              == digests[f"video_fixtures/{HEVC_B_CLIP}"]["frames"])
    if not cli["control_is_cv2s"]:
        raise AssertionError("24b: the PNG control's frames are not cv2's by the digests")
    check_cli_video(cli, "the HEVC B clip", "24b")
    decode = time_hevc_b_decode()
    ms = {k: f"{r['frame_ms']:.3f} (" + ", ".join(
        f"{n.upper()} {r[n + '_ms']:.3f}" for n in ("idr", "cra", "p", "b") if n + "_ms" in r) + ")"
        for k, r in decode.items()}
    log(f"24 HEVC B pictures: a frame decodes in {json.dumps(ms)} ms (host clock); the CLI's "
        f"ingest p50 {cli['ingest_ms_p50']:.2f} ms over the B clip, "
        f"{cli['control_ingest_ms_p50']:.2f} ms over its PNG control; phase 24 "
        f"{time.perf_counter() - t0:.1f} s; {smi}")
    return fixtures, cli, decode


# ---------------------------------------------------------------------------
# phase 25: Motion-JPEG video input on the card's host
# ---------------------------------------------------------------------------

MJPEG_CLIP = "mjpeg_480x640_smooth.avi"
MJPEG_BIG = "mjpeg_1080x1920_smooth.avi"


def _mjpeg_decode_ms(name, passes):
    """Host milliseconds of each sample's decode and conversion to RGB
    (``native.MjpegDecoder``: libavcodec's arithmetic), and of the same
    sample through ``native.decode_jpeg`` (the image reader: libjpeg-turbo's
    ISLOW IDCT and fancy upsampling), over ``passes`` decodes of the file,
    alternating."""
    from mast3r_slam_tpu_torch.data import video
    from mast3r_slam_tpu_torch.utils import native

    data, track = video.read_track(VIDEO_DATA / name)
    samples = [data[int(a):int(a) + int(n)] for a, n in zip(track.offsets, track.sizes)]
    ms, jms = [], []
    for _ in range(passes):
        dec = native.MjpegDecoder(track.width, track.height)
        for sample in samples:
            t0 = time.perf_counter()
            if not dec.decode(sample):
                raise AssertionError(f"25c: {name}: a sample output no frame")
            dec.rgb()
            ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            native.decode_jpeg(sample)
            jms.append((time.perf_counter() - t0) * 1e3)
        dec.close()
    return dict(frame_ms=statistics.median(ms), jpeg_ms=statistics.median(jms),
                frames=len(samples), passes=passes, file_bytes=len(data),
                shape=[track.height, track.width, 3])


def time_mjpeg_decode():
    """25c: host milliseconds of a Motion-JPEG frame's decode and conversion
    to RGB at 480x640 (the 25b clip, 14 frames) and 1920x1080 (3 frames),
    beside ``native.decode_jpeg`` of the same samples, median over
    VIDEO_DECODE_PASSES decodes of each file, all in one call."""
    out = dict(mjpeg_480x640=_mjpeg_decode_ms(MJPEG_CLIP, VIDEO_DECODE_PASSES),
               mjpeg_1080x1920=_mjpeg_decode_ms(MJPEG_BIG, VIDEO_DECODE_PASSES))
    log(f"25c decode (host clock): {json.dumps(out)}")
    return out


def run_mjpeg_input(dev, work, smi):
    """Phase 25 (a)-(c), each checked; raises on any fault."""
    import hashlib

    from mast3r_slam_tpu_torch.data import png

    t0 = time.perf_counter()
    fixtures = check_video_fixtures("mjpeg_fixtures.json", "25a")
    if fixtures["files"] < 10:
        raise AssertionError(f"25a: {fixtures['files']} Motion-JPEG fixtures, 10 expected")
    digests = json.loads((IMAGE_DATA / "mjpeg_fixtures.json").read_text())
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli = run_cli_video(dev, work, clip_name=MJPEG_CLIP, tag="25b", save="mjpeg")
    finally:
        os.chdir(cwd)
    control = sorted((work / "mjpeg_png").iterdir())
    cli["control_is_cv2s"] = ([hashlib.sha256(png.read_png(p).tobytes()).hexdigest()
                               for p in control]
                              == digests[f"video_fixtures/{MJPEG_CLIP}"]["frames"])
    if not cli["control_is_cv2s"]:
        raise AssertionError("25b: the PNG control's frames are not cv2's by the digests")
    check_cli_video(cli, "the Motion-JPEG clip", "25b")
    decode = time_mjpeg_decode()
    ms = {k: f"{r['frame_ms']:.3f} (decode_jpeg {r['jpeg_ms']:.3f})" for k, r in decode.items()}
    log(f"25 Motion-JPEG input: a frame decodes in {json.dumps(ms)} ms (host clock); the "
        f"CLI's ingest p50 {cli['ingest_ms_p50']:.2f} ms over the Motion-JPEG clip, "
        f"{cli['control_ingest_ms_p50']:.2f} ms over its PNG control; launches "
        f"{cli['launches']}; phase 25 {time.perf_counter() - t0:.1f} s; {smi}")
    return fixtures, cli, decode


# ---------------------------------------------------------------------------
# phase 26: HEVC Main 10 video input on the card's host
# ---------------------------------------------------------------------------

HEVC10_CLIP = "hevc10_480x640_smooth.mp4"
HEVC10_BIG = "hevc10_1080x1920_smooth.mp4"


def time_hevc10_decode():
    """26c: host milliseconds of a Main 10 frame's decode and conversion to
    RGB (libswscale's scaled route), IDR and P pictures apart, at 480x640
    (the 26b clip, 14 frames) and 1920x1080 (an IDR and two P pictures),
    beside the 8-bit clips of the same content (phase 23's), median over
    VIDEO_DECODE_PASSES decodes of each file, all in one call."""
    out = dict(hevc10_480x640=_hevc_decode_ms(HEVC10_CLIP, VIDEO_DECODE_PASSES),
               hevc10_1080x1920=_hevc_decode_ms(HEVC10_BIG, VIDEO_DECODE_PASSES),
               hevc8_480x640=_hevc_decode_ms(HEVC_CLIP, VIDEO_DECODE_PASSES),
               hevc8_1080x1920=_hevc_decode_ms(HEVC_BIG, VIDEO_DECODE_PASSES))
    log(f"26c decode (host clock): {json.dumps(out)}")
    return out


def run_hevc10_input(dev, work, smi):
    """Phase 26 (a)-(c), each checked; raises on any fault."""
    import hashlib

    from mast3r_slam_tpu_torch.data import png

    t0 = time.perf_counter()
    fixtures = check_video_fixtures("hevc10_fixtures.json", "26a")
    if fixtures["files"] < 6:
        raise AssertionError(f"26a: {fixtures['files']} Main 10 fixtures, 6 expected")
    digests = json.loads((IMAGE_DATA / "hevc10_fixtures.json").read_text())
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli = run_cli_video(dev, work, clip_name=HEVC10_CLIP, tag="26b", save="hevc10")
    finally:
        os.chdir(cwd)
    control = sorted((work / "hevc10_png").iterdir())
    cli["control_is_cv2s"] = ([hashlib.sha256(png.read_png(p).tobytes()).hexdigest()
                               for p in control]
                              == digests[f"video_fixtures/{HEVC10_CLIP}"]["frames"])
    if not cli["control_is_cv2s"]:
        raise AssertionError("26b: the PNG control's frames are not cv2's by the digests")
    check_cli_video(cli, "the Main 10 clip", "26b")
    decode = time_hevc10_decode()
    ms = {k: f"{r['frame_ms']:.3f} (IDR {r['idr_ms']:.3f}, P {r['p_ms']:.3f})"
          for k, r in decode.items()}
    log(f"26 HEVC Main 10 input: a frame decodes in {json.dumps(ms)} ms (host clock); the "
        f"CLI's ingest p50 {cli['ingest_ms_p50']:.2f} ms over the Main 10 clip, "
        f"{cli['control_ingest_ms_p50']:.2f} ms over its PNG control; launches "
        f"{cli['launches']}; phase 26 {time.perf_counter() - t0:.1f} s; {smi}")
    return fixtures, cli, decode


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
    for name in kernels.ENTRY_POINTS:  # loaded before the first profiler trace
        kernels.entry_point(name)
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
    want = {"attention": 72 * N_TRACKED, "refine_window": N_TRACKED,
            "tracking_gn_while": N_TRACKED}
    if counts != want:
        raise AssertionError(f"ViT-L launches {counts}, expected {want} (72 attention, "
                             f"1 refine and 1 tracking GN program per tracked frame)")
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
    backend_counts, backend_split, vitl_kf = run_vitl_backend(dev, vitl)

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
    met = {}  # the global solve's device programs met in the runs with many solves
    work = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli = run_cli_standin(dev, work)
        with programs_met("9b", met):
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

    # the long-video memory plan, in the same scratch directory
    with programs_met("10a", met):
        windowed = check_windowed_solve(dev)
    with programs_met("10b", met):
        soak = run_paged_soak(dev)
    with programs_met("10b_reloc", met):
        paged = check_paged_reloc(dev, work)
    strided = run_strided_task(dev, vitl, vitl_kf)
    log(f"10c: strided task {strided['task_ms']:.3f} ms against the stride-1 task's "
        f"{backend_split['task_ms']:.3f} ms (host clock); {smi}")

    # serving, in the same scratch directory
    with programs_met("11", met):
        jpeg, serve, viz, two = run_serving(dev, work, smi)
    # image input without cv2, in the same scratch directory
    img_fixtures, img_cli, img_served, img_close = run_image_input(dev, work, smi)
    # the multi-card backend on one card, against phase 5's run and phase 6's task
    multi = run_multi_card(dev, work, smi, vitl, res, backend_split["task_ms"])
    msolve, mtask = multi["sharded_solve"]["runs"], multi["sharded_task"]
    mranks = [r["launches"] for r in multi["two_process"]["ranks"]]
    tranks = [r["launches"] for r in multi["threaded_two_process"]["vitl"]["ranks"]]
    rranks = [r["launches"] for r in multi["reloc_two_process"]["ranks"]]
    # the tracking GN on the device: syncs a frame and a task, the program
    # against the plain loop, what it changed
    host = run_host_reads(dev, vitl, smi)
    tgn = host["tracking_gn"]["ray_dist"]
    # the last reads cv2 gave the JAX package: colour as gray (EuRoC), partial
    # progressive scripts smoothed, CMYK/YCCK; in the same scratch directory
    last_fixtures, last_euroc, last_served = run_last_reads(dev, work, smi)
    # the last codings: arithmetic-coded JPEG (SOF9, SOF10, DAC) and lossless
    # JPEG read as gray; in the same scratch directory
    coding_fixtures, coding_euroc, coding_served = run_last_codings(dev, work, smi)
    # the global solve as one device program a bucket: against the plain
    # loop at full width, the ViT-L task's solve, a SLAM.run's buckets
    program = run_global_program(dev, vitl, smi)
    ptask, prays = program["vitl_task"], program["solves"]["rays_dense"]
    # video input without cv2: the fixtures against cv2's digests, the ViT-L
    # CLI over an mp4v clip against its PNG control, the decode timed; in
    # the same scratch directory
    video_fixtures, video_cli, video_decode = run_video_input(dev, work, smi)
    # H.264 input without cv2: the fixtures (a rotated one among them)
    # against cv2's digests, the ViT-L CLI over an H.264 clip against its
    # PNG control, the decode timed beside mp4v and JPEG; same directory
    h264_fixtures, h264_cli, h264_decode = run_h264_input(dev, work, smi)
    # CABAC H.264 input and the JPEG restart resync: the fixtures against
    # cv2's digests, the ViT-L CLI over a CABAC clip against its PNG
    # control, the decode timed beside CAVLC; same directory
    cabac_fixtures, cabac_cli, cabac_decode = run_cabac_input(dev, work, smi)
    # B pictures, weighted prediction and reordered output (x264's default
    # tools): the fixtures against cv2's digests, the ViT-L CLI over an IBBP
    # clip behind ctts and an edit list against its PNG control, the decode
    # of IDR, P and B pictures timed; same directory
    bframe_fixtures, bframe_cli, bframe_decode = run_bframe_input(dev, work, smi)
    # HEVC input (Main profile I and P pictures: WPP, AMP, SAO, TMVP, weights):
    # the fixtures against cv2's digests, the ViT-L CLI over an HEVC clip
    # against its PNG control, the decode timed beside CABAC H.264's; same
    # directory
    hevc_fixtures, hevc_cli, hevc_decode = run_hevc_input(dev, work, smi)
    # HEVC B slices and leading pictures (x265's open-GOP B pyramid): the
    # fixtures against cv2's digests, the ViT-L CLI over a B clip with RASL
    # pictures behind ctts and an edit against its PNG control, the decode
    # of IDR, P and B pictures timed; same directory
    hevc_b_fixtures, hevc_b_cli, hevc_b_decode = run_hevc_b_input(dev, work, smi)
    # Motion-JPEG input (OpenCV's and FFmpeg's writers, libjpeg-turbo's
    # pictures): the fixtures against cv2's digests, the ViT-L CLI over
    # OpenCV's MJPEG AVI against its PNG control, the decode timed beside
    # the image reader's; same directory
    mjpeg_fixtures, mjpeg_cli, mjpeg_decode = run_mjpeg_input(dev, work, smi)
    # HEVC Main 10 (9 and 10 bits, libswscale's scaled conversion): the
    # fixtures against cv2's digests, the ViT-L CLI over a 10-bit clip
    # against its PNG control, the decode timed beside the 8-bit clips of
    # the same content; same directory
    hevc10_fixtures, hevc10_cli, hevc10_decode = run_hevc10_input(dev, work, smi)

    common = lambda r: {k: r[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms",
                                          "library_call_ms")}
    line = {"kernels": [
        dict(name="attention", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/attention.cu",
             replaces="mast3r_slam_tpu/ops/attention.py:52",
             launches=counts["attention"], shape=attn_enc["shape"], **common(attn_enc),
             strided_task_launches=strided["launches"]["attention"],
             serve_launches=serve["launches"]["attention"],
             image_cli_launches=img_cli["launches"]["attention"],
             euroc_cli_launches=last_euroc["launches"]["attention"],
             partial_serve_launches=last_served["launches"]["attention"],
             lossless_euroc_cli_launches=coding_euroc["launches"]["attention"],
             arithmetic_serve_launches=coding_served["launches"]["attention"],
             video_cli_launches=video_cli["launches"]["attention"],
             h264_cli_launches=h264_cli["launches"]["attention"],
             cabac_cli_launches=cabac_cli["launches"]["attention"],
             bframe_cli_launches=bframe_cli["launches"]["attention"],
             hevc_cli_launches=hevc_cli["launches"]["attention"],
             hevc_b_cli_launches=hevc_b_cli["launches"]["attention"],
             mjpeg_cli_launches=mjpeg_cli["launches"]["attention"],
             hevc10_cli_launches=hevc10_cli["launches"]["attention"],
             mesh_launches={"vitl_task_2_shards": mtask["launches"]["attention"],
                            "threaded_vitl_ranks": [c["attention"] for c in tranks]}),
        dict(name="refine_window", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/refine_window.cu",
             replaces="mast3r_slam_tpu/ops/refine_pallas.py:70",
             launches=counts["refine_window"], shape=[1, 384 * 512, 24], **common(ref),
             speed_launches=speed["seq_counts"]["refine_window"],
             speed={k: {m: r[m] for m in ("schedule", "radius", "n", "ms", "call_ms",
                                          "plain_ms", "bound_ms", "bound_by")}
                    for k, r in ref_speed["current"].items()},
             strided_launches=strided["launches"]["refine_window"],
             paged_reloc_launches=paged["launches"]["refine_window"],
             serve_launches=serve["launches"]["refine_window"],
             image_cli_launches=img_cli["launches"]["refine_window"],
             euroc_cli_launches=last_euroc["launches"]["refine_window"],
             partial_serve_launches=last_served["launches"]["refine_window"],
             lossless_euroc_cli_launches=coding_euroc["launches"]["refine_window"],
             arithmetic_serve_launches=coding_served["launches"]["refine_window"],
             video_cli_launches=video_cli["launches"]["refine_window"],
             h264_cli_launches=h264_cli["launches"]["refine_window"],
             cabac_cli_launches=cabac_cli["launches"]["refine_window"],
             bframe_cli_launches=bframe_cli["launches"]["refine_window"],
             hevc_cli_launches=hevc_cli["launches"]["refine_window"],
             hevc_b_cli_launches=hevc_b_cli["launches"]["refine_window"],
             mjpeg_cli_launches=mjpeg_cli["launches"]["refine_window"],
             hevc10_cli_launches=hevc10_cli["launches"]["refine_window"],
             mesh_launches={"vitl_task_2_shards": mtask["launches"]["refine_window"],
                            "two_process_ranks": [c["refine_window"] for c in mranks],
                            "threaded_vitl_ranks": [c["refine_window"] for c in tranks]},
             strided={k: strided[k] for k in ("B", "n", "schedule", "radius", "max_abs_err",
                                              "ms", "call_ms", "plain_ms", "bound_ms",
                                              "bound_by", "pairs_shared",
                                              "pixel_levels_shared")}),
        dict(name="edge_hg_rays", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/edge_hg_rays.cu",
             replaces="mast3r_slam_tpu/ops/edge_hg_pallas.py:130",
             launches=backend_counts["edge_hg_rays"], shape=ehg["shape"], **common(ehg),
             windowed_launches=sum(r["edge_hg_launches"] for r in windowed["solves"]),
             paged_reloc_launches=paged["launches"]["edge_hg_rays"],
             strided_task_launches=strided["launches"]["edge_hg_rays"],
             serve_launches=serve["launches"]["edge_hg_rays"],
             image_cli_launches=img_cli["launches"]["edge_hg_rays"],
             euroc_cli_launches=last_euroc["launches"]["edge_hg_rays"],
             partial_serve_launches=last_served["launches"]["edge_hg_rays"],
             lossless_euroc_cli_launches=coding_euroc["launches"]["edge_hg_rays"],
             arithmetic_serve_launches=coding_served["launches"]["edge_hg_rays"],
             video_cli_launches=video_cli["launches"]["edge_hg_rays"],
             h264_cli_launches=h264_cli["launches"]["edge_hg_rays"],
             cabac_cli_launches=cabac_cli["launches"]["edge_hg_rays"],
             bframe_cli_launches=bframe_cli["launches"]["edge_hg_rays"],
             hevc_cli_launches=hevc_cli["launches"]["edge_hg_rays"],
             hevc_b_cli_launches=hevc_b_cli["launches"]["edge_hg_rays"],
             mjpeg_cli_launches=mjpeg_cli["launches"]["edge_hg_rays"],
             hevc10_cli_launches=hevc10_cli["launches"]["edge_hg_rays"],
             mesh_launches={"sharded_solve": {k: r["launches"] for k, r in msolve.items()},
                            "two_process_ranks": [c["edge_hg_rays"] for c in mranks],
                            "threaded_vitl_ranks": [c["edge_hg_rays"] for c in tranks],
                            "reloc_two_process_ranks": [c["edge_hg_rays"] for c in rranks],
                            "vitl_task_2_shards": mtask["launches"]["edge_hg_rays"]}),
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
             launches=rcounts["ivf_hamming"], shape=ivf["shape"], **common(ivf),
             paged_reloc_launches=paged["launches"]["ivf_hamming"]),
        # the XLA while_loop of the tracking GN: one CUDA graph a solve, a
        # WHILE node over a captured iteration; exact against the plain loop
        dict(name="tracking_gn_while", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/gn_while.cu",
             replaces="mast3r_slam_tpu/ops/tracking_gn.py:87",
             launches=counts["tracking_gn_while"], shape=[384 * 512, 4],
             max_abs_err=max(r["max_abs_err"] for r in host["tracking_gn"].values()),
             ms=tgn["ms"], plain_ms=tgn["plain_ms"], bound_ms=tgn["bound_ms"],
             bound_by=tgn["bound_by"], library_ms=None, iters=tgn["iters"],
             kernel_nodes_run=tgn["kernel_nodes_run"],
             speed_launches=speed["seq_counts"]["tracking_gn_while"]),
        # the XLA while_loops of the global GN and its CG: one CUDA graph a
        # solve, nested WHILE nodes; exact against the plain loop (17a)
        dict(name="global_gn_while", route="cuda",
             source="mast3r_slam_tpu_torch/csrc/gn_while.cu",
             replaces="mast3r_slam_tpu/ops/global_gn.py:724",
             launches=program["arc"]["program_launches"],
             shape=[16, 32, 384 * 512],
             max_abs_err=max(r["max_abs_err"] for r in program["solves"].values()),
             ms=prays["ms"], plain_ms=prays["plain_ms"], bound_ms=prays["bound_ms"],
             bound_by=prays["bound_by"], library_ms=None, iters=prays["iters"],
             solves={k: {m: r[m] for m in ("route", "iters", "ms", "plain_ms", "bound_ms",
                                           "bound_by")}
                     for k, r in program["solves"].items()},
             vitl_task_launches=ptask["program_launches"],
             sharded_solve={k: {m: r[m] for m in ("route", "iters", "program_launches",
                                                  "launches", "ms", "event_ms",
                                                  "frozen_ms")}
                            for k, r in msolve.items()}),
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
        "cli": {"standin": cli, "vitl": vcli, "card": smi},
        "long_video": {"windowed": windowed, "paged_soak": soak,
                       "paged_reloc": {k: v for k, v in paged.items() if k != "launches"},
                       "strided_task_ms": strided["task_ms"],
                       "stride1_task_ms": backend_split["task_ms"], "card": smi},
        "serve": {"jpeg_fixture": jpeg, "vitl_session": {k: v for k, v in serve.items()
                                                          if k not in ("stages", "latency_ms")},
                  "viz_ws": viz, "two_sessions": two, "card": smi},
        "image_input": {"fixtures": img_fixtures,
                        "cli": {k: v for k, v in img_cli.items() if k != "stages"},
                        "served": img_served, "close": img_close, "card": smi},
        "multi_card": multi,
        "last_reads": {"fixtures": last_fixtures, "euroc_cli": last_euroc,
                       "partial_serve": last_served, "card": smi},
        "last_codings": {"fixtures": coding_fixtures, "lossless_euroc_cli": coding_euroc,
                         "arithmetic_serve": coding_served, "card": smi},
        "host_reads": {k: v for k, v in host.items() if k != "tracking_gn"},
        "tracking_gn_program": host["tracking_gn"],
        "global_gn_program": dict(program, buckets_met=met),
        "video_input": {"fixtures": video_fixtures, "cli": video_cli, "decode": video_decode,
                        "card": smi},
        "h264_input": {"fixtures": h264_fixtures, "cli": h264_cli, "decode": h264_decode,
                       "card": smi},
        "cabac_input": {"fixtures": cabac_fixtures, "cli": cabac_cli, "decode": cabac_decode,
                        "card": smi},
        "bframe_input": {"fixtures": bframe_fixtures, "cli": bframe_cli, "decode": bframe_decode,
                         "card": smi},
        "hevc_input": {"fixtures": hevc_fixtures, "cli": hevc_cli, "decode": hevc_decode,
                       "card": smi},
        "hevc_b_input": {"fixtures": hevc_b_fixtures, "cli": hevc_b_cli,
                         "decode": hevc_b_decode, "card": smi},
        "mjpeg_input": {"fixtures": mjpeg_fixtures, "cli": mjpeg_cli, "decode": mjpeg_decode,
                        "card": smi},
        "hevc10_input": {"fixtures": hevc10_fixtures, "cli": hevc10_cli,
                         "decode": hevc10_decode, "card": smi}}
    log(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
