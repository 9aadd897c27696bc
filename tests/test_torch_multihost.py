"""The port's multi-process mesh: two real OS processes on the CPU, joined
by ``torch.distributed`` over gloo on localhost (the port of
tests/test_multihost.py).

tests/torch_distributed_worker.py checks ``initialize`` (gloo chosen for
the CPU), ``make_global_mesh``, ``process_edge_slice``, one all-reduce of
an edge-sharded sum, the all-gather, the rank-mismatch check raising on
both ranks, and the edge-sharded solve across the processes (JAX's sharded
bound, atol 5e-4, rtol 1e-3, against one device; the same bits on both
ranks).  tests/torch_distributed_engine_worker.py runs the engine over the
two processes' 8 shards against the same engine without a mesh (the JAX
worker's bound, 1e-5 absolute; the same bits on both ranks).
"""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(worker: str, timeout: float):
    """Both workers' (return code, output); kills both on a timeout."""
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, str(HERE / worker), str(pid), "2", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=str(HERE.parent), env=env)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.mark.parametrize("worker,ok_line", [
    ("torch_distributed_worker.py", "torch gloo mesh over 2 processes OK"),
    ("torch_distributed_engine_worker.py",
     "torch distributed SLAM engine over 2 processes OK"),
])
def test_two_processes(worker, ok_line):
    for pid, (rc, out) in enumerate(_run_pair(worker, timeout=240)):
        assert rc == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert ok_line in out, out[-4000:]
