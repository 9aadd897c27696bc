"""Worker for tests/test_torch_threaded_multihost.py: the port's threaded
backend (``single_thread: False``) across processes.

Usage: python torch_distributed_threaded_worker.py <pid> <nproc> <port> <out_dir> <scenario>

Every process runs the same engine (``base``, ``engine.mesh: "auto"``: one
CPU shard a process) on the oracle arc at 48x64 and writes each run's
poses (``<run>_rank<pid>.npz``) and its schedule, keyframes and edges
(``<run>_rank<pid>.json``) to ``out_dir``.

scenario ``runs``:
  inline     single_thread: True, the control
  gated_p0   threaded; each frame's commit first waits for this rank's
             worker, so every task ends at the frame it started
  held_p0    threaded; on both ranks the worker holds each task's end until
  held_p1    HELD_FRAMES frame past its start, and the commit there waits
             for it: each write-back lands exactly HELD_FRAMES after its
             start, some of them on a frame that is no keyframe, while the
             solved keyframe is still the one tracked against (pipeline 0, 1)
  skewed_p0  threaded; only rank 1's worker holds each task's end
  skewed_p1  SKEW_FRAMES frames, and nothing waits: rank 0's worker is
             done first (pipeline 0, 1)
scenario ``fail``: threaded, rank 1's second task raises; the run must stop
  with an error on both ranks (this worker then exits with code 3).
scenario ``reloc``: threaded, with a retrieval database (a small head and
  codebook from one seed, the same on both ranks; tests/test_reloc_e2e.py's
  sizing) over tests/test_reloc_e2e.py's teleport scene: tracking breaks,
  both ranks drain their workers and relocalise.  Written besides: each
  relocalisation's frame and outcome, each edge-sharded solve's
  iterations, and the shard blocks assembled (``sharded_ba._local_blocks``
  calls: one a shard an iteration that ran).

The hooks (``chip_smoke.hold_tasks``, ``fail_second_task``) wrap the
engine's methods on the instance; the package has none of them.
"""

import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
out_dir, scenario = pathlib.Path(sys.argv[4]), sys.argv[5]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mast3r_slam_tpu_torch.config import load_config  # noqa: E402
from mast3r_slam_tpu_torch.parallel import multihost as mh  # noqa: E402
from mast3r_slam_tpu_torch.parallel import sharded_ba  # noqa: E402
from mast3r_slam_tpu_torch.retrieval import (  # noqa: E402
    ASMKSettings, RetrievalDatabase, RetrievalHeadSettings)
from mast3r_slam_tpu_torch.retrieval.head import init_head_params  # noqa: E402
from mast3r_slam_tpu_torch.slam import factor_graph  # noqa: E402
from mast3r_slam_tpu_torch.slam.pipeline import SLAM  # noqa: E402

from chip_smoke import hold_tasks  # noqa: E402  (phase 13e's hooks)
from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory  # noqa: E402
from test_reloc_e2e import teleport_trajectory  # noqa: E402
from test_torch_common import TorchOracleModel  # noqa: E402

# two pairs of these processes run beside the test session's workers
torch.set_num_threads(1)

HW = (48, 64)
N_FRAMES = 12
HELD_FRAMES = 1     # frames a held task waits past its start, both ranks
SKEW_FRAMES = 2     # the same, rank 1 only
# a collective whose peer stopped ends with an error after this long
GROUP_TIMEOUT_S = 60

mh.initialize(f"127.0.0.1:{port}", nproc, pid, backend="gloo", timeout=GROUP_TIMEOUT_S)


def engine(single_thread, pipeline):
    gt = arc_trajectory(N_FRAMES, radius=0.6, max_angle=2.5)
    model = TorchOracleModel(OracleModel(PlaneScene(HW), gt, noise=0.002))
    cfg = load_config("base")
    cfg["engine"]["edge_buffer"] = 32
    cfg["engine"]["mesh"] = "auto"
    cfg["engine"]["pipeline"] = pipeline
    cfg["single_thread"] = single_thread
    return SLAM(model, cfg, HW, keyframe_buffer=32, device="cpu")


def run_reloc():
    """The threaded engine over the teleport scene with retrieval; the
    relocalisations, the solves' iterations and the blocks assembled."""
    gt = teleport_trajectory()
    model = TorchOracleModel(OracleModel(PlaneScene(HW), gt, noise=0.002))
    g = torch.Generator().manual_seed(41)
    params = init_head_params(g, model.feat_dim, hdims=(8,))
    centroids = torch.randn((64, 8), generator=g) * 0.3
    db = RetrievalDatabase(params, centroids, RetrievalHeadSettings(nfeat=8),
                           ASMKSettings(max_images=64), device="cpu")
    cfg = load_config("base")
    cfg["engine"]["edge_buffer"] = 64
    cfg["engine"]["mesh"] = "auto"
    cfg["single_thread"] = False
    cfg["reloc"]["strict"] = False
    slam = SLAM(model, cfg, HW, keyframe_buffer=64, retrieval=db, device="cpu")
    relocs, iters, blocks = [], [], [0]
    relocalize, solve, local = (slam._relocalize, factor_graph.gauss_newton_poses_sharded,
                                sharded_ba._local_blocks)

    def relocalized(frame):
        ok = relocalize(frame)
        relocs.append([int(frame.frame_id), bool(ok)])
        return ok

    def solved(*a, **kw):
        out = solve(*a, **kw)
        iters.append(int(out[1]))
        return out

    def counted(*a, **kw):
        blocks[0] += 1
        return local(*a, **kw)

    slam._relocalize = relocalized
    factor_graph.gauss_newton_poses_sharded, sharded_ba._local_blocks = solved, counted
    try:
        res = slam.run(OracleDataset(len(gt), HW), verbose=False)
        slam.close()
    finally:
        factor_graph.gauss_newton_poses_sharded, sharded_ba._local_blocks = solve, local
    assert slam.backend_errors == [], slam.backend_errors
    np.savez(out_dir / f"reloc_rank{pid}.npz", frame_poses=res.frame_poses,
             keyframe_poses=res.keyframe_poses, gt=gt)
    (out_dir / f"reloc_rank{pid}.json").write_text(json.dumps(dict(
        n_keyframes=res.n_keyframes, n_reloc=res.n_reloc, n_reloc_success=res.n_reloc_success,
        n_edges=slam.graph.n_edges, mode=slam.mode.name, relocs=relocs, solve_iters=iters,
        blocks=blocks[0], local_shards=slam.mesh.local_size, mesh_size=slam.mesh.size,
        agreed=slam.agreed, schedule=slam.backend_schedule)))
    print(f"worker {pid}: reloc at {relocs}, solves {iters}", flush=True)


def fail_second_task(slam):
    task = slam._backend_update_impl
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("a planted fault in the second backend task")
        return task(*args, **kwargs)

    slam._backend_update_impl = failing


def run(name, single_thread, pipeline, hook=None):
    slam = engine(single_thread, pipeline)
    if hook is not None:
        hook(slam)
    t0 = time.perf_counter()
    res = slam.run(OracleDataset(N_FRAMES, HW), verbose=False)
    wall = time.perf_counter() - t0
    slam.close()
    assert slam.backend_errors == [], slam.backend_errors
    np.savez(out_dir / f"{name}_rank{pid}.npz", frame_poses=res.frame_poses,
             keyframe_poses=res.keyframe_poses)
    st = slam.timer.stats()
    (out_dir / f"{name}_rank{pid}.json").write_text(json.dumps(dict(
        n_keyframes=res.n_keyframes, n_reloc=res.n_reloc, n_edges=slam.graph.n_edges,
        keyframe_timestamps=res.keyframe_timestamps, schedule=slam.backend_schedule,
        n_tasks=st.get("backend.update", {"count": 0})["count"],
        n_agree=st.get("backend.agree", {"count": 0})["count"], wall_s=wall,
        mesh_size=slam.mesh.size, agreed=slam.agreed)))
    print(f"worker {pid}: {name} {wall:.2f} s, kf={res.n_keyframes}, "
          f"schedule={slam.backend_schedule}", flush=True)


if scenario == "runs":
    run("inline", True, 0)
    run("gated_p0", False, 0, lambda slam: hold_tasks(slam, 0, wait=True))
    for pipeline in (0, 1):
        run(f"held_p{pipeline}", False, pipeline,
            lambda slam: hold_tasks(slam, HELD_FRAMES, wait=True))
    for pipeline in (0, 1):
        run(f"skewed_p{pipeline}", False, pipeline,
            lambda slam: hold_tasks(slam, SKEW_FRAMES, wait=False) if pid == 1 else None)
    dist.destroy_process_group()
    print(f"worker {pid}: threaded backend over {nproc} processes OK", flush=True)
elif scenario == "reloc":
    run_reloc()
    dist.destroy_process_group()
    print(f"worker {pid}: relocalisation over {nproc} processes OK", flush=True)
elif scenario == "fail":
    slam = engine(False, 0)
    if pid == 1:
        fail_second_task(slam)
    try:
        slam.run(OracleDataset(N_FRAMES, HW), verbose=False)
    except RuntimeError as e:
        print(f"worker {pid}: the run stopped: {e}", flush=True)
        slam.close()
        dist.destroy_process_group()
        print(f"worker {pid}: process group destroyed", flush=True)
        sys.exit(3)
    raise AssertionError("the run went on past a failed task")
else:
    raise ValueError(scenario)
