"""Worker for tests/test_torch_multihost.py: the port's SLAM engine across
processes (tests/distributed_engine_worker.py's run, on the port).

Usage: python torch_distributed_engine_worker.py <pid> <nproc> <port>

Every process runs the same engine on the same frames over one edge mesh
of 4 CPU shards a process, as the JAX worker's processes hold 4 virtual
devices each: a backend task's decode batch is split over the shards of
every process (each rank decodes its slice, the results are gathered), and
every global solve assembles each rank's edges there and sums them with an
all-reduce a field.  Each worker also runs the engine without a mesh and
holds the mesh run to it; the ranks hold the same pose bits.
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

from mast3r_slam_tpu_torch.config import load_config  # noqa: E402
from mast3r_slam_tpu_torch.parallel import multihost as mh  # noqa: E402
from mast3r_slam_tpu_torch.parallel.mesh import all_gather_rows  # noqa: E402
from mast3r_slam_tpu_torch.slam.pipeline import SLAM  # noqa: E402

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory  # noqa: E402
from test_torch_common import TorchOracleModel  # noqa: E402

mh.initialize(f"127.0.0.1:{port}", nproc, pid, backend="gloo")

HW = (48, 64)
N_FRAMES = 12
MESH = 4 * nproc
POSE_ATOL = 1e-5  # the JAX worker's bound


def engine(mesh, single_thread=True):
    gt = arc_trajectory(N_FRAMES, radius=0.6, max_angle=2.5)
    model = TorchOracleModel(OracleModel(PlaneScene(HW), gt, noise=0.002))
    cfg = load_config("base")
    cfg["engine"]["edge_buffer"] = 32
    cfg["engine"]["mesh"] = mesh
    cfg["single_thread"] = single_thread
    return SLAM(model, cfg, HW, keyframe_buffer=32, device="cpu")


# "auto" spans every rank: one CPU shard each
assert engine("auto").mesh.size == nproc
# the threaded backend builds across processes, its tasks agreed at frames
threaded = engine(MESH, single_thread=False)
assert threaded.agreed and threaded.mesh.size == MESH and threaded._worker.is_alive()
threaded.close()

single = engine(0).run(OracleDataset(N_FRAMES, HW), verbose=False)
slam = engine(MESH)
assert slam.mesh.size == MESH and slam.mesh.local_size == 4
meshed = slam.run(OracleDataset(N_FRAMES, HW), verbose=False)

assert meshed.n_keyframes == single.n_keyframes >= 2, (meshed.n_keyframes,
                                                       single.n_keyframes)
assert meshed.n_reloc == single.n_reloc == 0
assert slam.graph.n_edges >= 1
np.testing.assert_allclose(meshed.frame_poses, single.frame_poses, rtol=0, atol=POSE_ATOL)
np.testing.assert_allclose(meshed.keyframe_poses, single.keyframe_poses, rtol=0,
                           atol=POSE_ATOL)
mine = torch.from_numpy(np.ascontiguousarray(meshed.frame_poses))
every = all_gather_rows(slam.mesh, mine[None])
assert all(torch.equal(every[r], every[0]) for r in range(nproc)), "ranks' poses differ"

dist.destroy_process_group()
diff = float(np.abs(meshed.frame_poses - single.frame_poses).max())
print(f"worker {pid}: torch distributed SLAM engine over {nproc} processes OK "
      f"(kf={meshed.n_keyframes}, edges={slam.graph.n_edges}, max pose difference "
      f"{diff:.3e})", flush=True)
