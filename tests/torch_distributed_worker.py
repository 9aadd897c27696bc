"""Worker for tests/test_torch_multihost.py: one process of the port's
multi-process mesh (``parallel/multihost.py``) on the CPU, over gloo.

Usage: python torch_distributed_worker.py <pid> <nproc> <port>

Each process holds 4 CPU shards; together they form one edge mesh of
4 * nproc shards, as tests/distributed_worker.py's processes hold 4 virtual
devices each.  Checked: the backend chosen for the CPU, the global mesh,
``process_edge_slice``, one all-reduce of an edge-sharded sum, the
all-gather, the rank-mismatch check, and the edge-sharded solve across the
processes against the single-device solve (every rank the same bits).
Then the sharded loop's early exit across the processes: at a
``delta_norm`` that the step norms decide (STOP_DELTA, 4 iterations:
steps 1.1e-3 then 9.4e-5), both ranks stop at the same ``iters`` with the
same bits, each rank's step ran ``iters`` times (4 shards a step), and
the one-process mesh of 8 CPU shards stops at the same ``iters`` with the
poses within 1e-6 (its shards' sums arrive in another order).
"""

import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mast3r_slam_tpu_torch.ops.global_gn import GlobalGNSettings, gauss_newton_poses  # noqa: E402
from mast3r_slam_tpu_torch.parallel import multihost as mh  # noqa: E402
from mast3r_slam_tpu_torch.parallel import sharded_ba  # noqa: E402
from mast3r_slam_tpu_torch.parallel.mesh import (  # noqa: E402
    all_gather_rows, all_reduce_sum, check_same, make_mesh, shard_edges)
from mast3r_slam_tpu_torch.parallel.sharded_ba import gauss_newton_poses_sharded  # noqa: E402

from test_torch_common import rays_problem  # noqa: E402

torch.set_num_threads(2)
mh.initialize(f"127.0.0.1:{port}", nproc, pid)
assert dist.get_backend() == "gloo" and dist.get_world_size() == nproc

mesh = mh.make_global_mesh(devices=["cpu"] * 4)
assert mesh.size == 4 * nproc and mesh.first_shard == 4 * pid

# an edge-sharded array: this process's rows, summed over the processes
E = 16
sl = mh.process_edge_slice(E)
assert sl == slice(pid * (E // nproc), (pid + 1) * (E // nproc))
assert mh.process_edge_slice(E, mesh) == sl
(shards,) = shard_edges(mesh, torch.arange(E, dtype=torch.float32))
local = torch.cat(shards)
assert local.tolist() == list(range(E))[sl]
total = local.sum()
all_reduce_sum(mesh, total)
assert float(total) == E * (E - 1) / 2, float(total)
assert all_gather_rows(mesh, local).tolist() == list(range(E))

# ranks that disagree raise on every rank instead of waiting
try:
    check_same(mesh, "a test count", 7, 100 + pid)
except RuntimeError as e:
    assert "ranks disagree on a test count" in str(e), e
else:
    raise AssertionError("check_same passed on ranks that disagree")
check_same(mesh, "a test count", 7, 8)

# the sharded solve across the processes (tests/test_sharded_ba.py's problem)
gt, problem, hw = rays_problem("cpu", n_kf=5, N=500)
args = (*problem, hw, GlobalGNSettings(edge_batch=2), "rays")
Twc, _, ok, _ = gauss_newton_poses_sharded(mesh, *args)
ref, _, ok_ref, _ = gauss_newton_poses(*args)
assert ok and ok_ref
np.testing.assert_allclose(Twc.numpy(), ref.numpy(), atol=5e-4, rtol=1e-3)
every = all_gather_rows(mesh, Twc[None])
assert all(torch.equal(every[r], every[0]) for r in range(nproc)), "ranks' poses differ"
ref_diff = float((Twc - ref).abs().max())

# the early exit: every rank reads the same flag and stops at the same iteration
STOP_DELTA = 3e-4
settings = GlobalGNSettings(edge_batch=2, delta_norm=STOP_DELTA)
args = (*problem, hw, settings, "rays")
blocks = [0]
real_blocks = sharded_ba._local_blocks


def counted(*a, **k):
    blocks[0] += 1
    return real_blocks(*a, **k)


sharded_ba._local_blocks = counted
Twc, iters, ok, diverged = gauss_newton_poses_sharded(mesh, *args)
sharded_ba._local_blocks = real_blocks
iters = int(iters)
assert bool(ok) and 1 <= iters < settings.max_iters, iters
assert blocks[0] == mesh.local_size * iters, (blocks[0], iters)
state = torch.cat([Twc.flatten(), torch.tensor([iters, bool(ok), bool(diverged)],
                                               dtype=Twc.dtype)])
every = all_gather_rows(mesh, state[None])
assert all(torch.equal(every[r], every[0]) for r in range(nproc)), "ranks' loops differ"
one = gauss_newton_poses_sharded(make_mesh(devices=["cpu"] * mesh.size), *args)
assert int(one[1]) == iters, (int(one[1]), iters)
assert float((Twc - one[0]).abs().max()) <= 1e-6, float((Twc - one[0]).abs().max())

dist.destroy_process_group()
print(f"worker {pid}: torch gloo mesh over {nproc} processes OK "
      f"(max pose difference {ref_diff:.3e}; "
      f"early exit at {iters} iterations, {float((Twc - one[0]).abs().max()):.3e} from "
      f"one process)", flush=True)
