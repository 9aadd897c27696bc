#!/usr/bin/env python3
"""Can the edge-sharded solve's device program hold an NCCL all-reduce?

    python3 scripts/sharded_nccl_capture.py

Needs one CUDA card.  Builds the kernels, then in a child process (killed
after CHILD_TIMEOUT_S, so a capture that hangs the card ends here) joins a
one-rank NCCL process group and captures the one-card program of the
edge-sharded solve (``parallel/sharded_ba._ShardedPieces``: the prologue,
then the body whose shard sums go through ``all_reduce_sum``, here an NCCL
all-reduce on the card) with ``gn_program.Program``, as a solve without a
process group is captured.  It reports what the capture did: the node
types of each captured piece, the return code of the WHILE node's build
(``gn_while_build``: 10000 x the failing step + the CUDA error), or the
error raised, and, if the program was built, its launch against the eager
early-exit loop of the same mesh (``gauss_newton_poses_sharded``): the bits
of the poses, iterations, ok and diverged, and the edge-block kernel's runs
against shards x iters.  The same for the mesh without a process group
(route 1, whose program a solve runs), for the node counts the all-reduce
adds.  Problem: chip_smoke.py's 13a rays scene (16 keyframes, 32 two-way
edges x 384*512 pixels).  The last line of its
output is one JSON object of the findings.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 600
# cudaGraphNodeType, by index
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
              "event_record", "ext_semas_signal", "ext_semas_wait", "mem_alloc", "mem_free",
              "batch_mem_op", "conditional")


def node_types(raw_graph: int) -> dict:
    from mast3r_slam_tpu_torch.ops import kernels

    c = (ctypes.c_int * 16)()
    lib = ctypes.CDLL(str(kernels.library_path("gn_while")))
    kernels.check(lib.gn_while_node_types(ctypes.c_void_p(raw_graph), c),
                  "gn_while_node_types")
    return {NODE_TYPES[i]: c[i] for i in range(len(NODE_TYPES)) if c[i]}


def child() -> dict:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from chip_smoke import frozen_sharded, rays_problem
    from mast3r_slam_tpu_torch.ops import edge_hg, global_gn, gn_program, kernels
    from mast3r_slam_tpu_torch.parallel import multihost as mh
    from mast3r_slam_tpu_torch.parallel import sharded_ba as sb
    from mast3r_slam_tpu_torch.parallel.mesh import Mesh
    from mast3r_slam_tpu_torch.utils.numerics import full_f32

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for name in kernels.ENTRY_POINTS:
        kernels.entry_point(name)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mh.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    out = dict(backend=dist.get_backend(), world=dist.get_world_size())
    hw = (384, 512)
    gt, noisy, Xs, Cs, ii, jj, idx, valid, Q, K = rays_problem(dev, hw, 16, 5)
    settings = global_gn.GlobalGNSettings()
    inputs = (noisy, Xs, Cs, ii.long(), jj.long(), idx, valid, Q, K)

    def capture(mesh) -> dict:
        """The program of ``mesh``'s sharded solve built as a solve without a
        process group builds it; what the capture and the build did, and
        the program's launch against the eager early-exit loop."""
        eager = sb.gauss_newton_poses_sharded(mesh, *inputs, hw, settings, "rays")
        frozen = frozen_sharded(mesh, (*inputs, hw, settings, "rays"))
        rec = dict(mesh_distributed=mesh.distributed, eager_iters=int(eager[1]),
                   eager_same_bits_as_frozen=all(torch.equal(a, b)
                                                 for a, b in zip(eager, frozen)))
        # the builder's arguments are the captured graphs: count their nodes
        real_entry = kernels.entry_point
        seen = {}

        def entry(name):
            fn = real_entry(name)
            if not name.startswith("gn_while_build"):
                return fn

            def build(*args):
                seen["nodes"] = [node_types(g) for g in args[:2]]
                seen["rc"] = rc = fn(*args)
                return rc

            return build

        kernels.entry_point = entry
        try:
            with full_f32():
                prog = gn_program.Program(
                    lambda static: sb._ShardedPieces(mesh, static, hw, settings, "rays"),
                    inputs, global_gn.counter)
            rec["built"] = True
        except Exception as e:  # the finding: what the capture or the build refused
            rec.update(built=False, error=f"{type(e).__name__}: {e}"[:2000])
            prog = None
        finally:
            kernels.entry_point = real_entry
        rec.update(piece_nodes=dict(zip(("prologue", "body"), seen.get("nodes", []))),
                   build_rc=seen.get("rc"))
        if prog is not None:
            runs = edge_hg.counter.count
            got = prog(inputs)
            torch.cuda.synchronize()
            rec.update(program_iters=int(got[1]),
                       program_edge_runs=edge_hg.counter.count - runs,
                       program_same_bits_as_eager=all(torch.equal(a, b)
                                                      for a, b in zip(got, eager)))
            prog.close()
        return rec

    try:
        out["nccl_one_rank"] = capture(mh.make_global_mesh(devices=[dev]))
        out["no_group"] = capture(Mesh((dev,)))  # route 1's mesh, for its node counts
    finally:
        dist.destroy_process_group()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sharded_nccl_capture: no CUDA card", file=sys.stderr)
        return 2
    if "--child" in sys.argv:
        print(json.dumps(child()))
        return 0
    sys.path.insert(0, str(REPO))
    from mast3r_slam_tpu_torch.ops import kernels

    kernels.build_all()
    try:
        proc = subprocess.run([sys.executable, __file__, "--child"], capture_output=True,
                              text=True, timeout=CHILD_TIMEOUT_S, cwd=str(REPO))
    except subprocess.TimeoutExpired as e:
        print(json.dumps({"timeout_s": CHILD_TIMEOUT_S,
                          "output": (e.stdout or "")[-2000:] if isinstance(e.stdout, str)
                          else None}))
        return 1
    sys.stderr.write(proc.stderr[-8000:])
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    print(lines[-1] if lines else json.dumps({"child_rc": proc.returncode}))
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
