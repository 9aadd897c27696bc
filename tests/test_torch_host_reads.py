"""Host reads of the port's engine: the JAX package's contract, held on the CPU.

The JAX package runs its Gauss-Newton loops on the device
(``lax.while_loop``), so the host reads a tracked frame once (the stats
vector, pose included) and a backend task once (retrieval's scores):
tests/test_pipeline1.py::test_pipeline1_one_readback_per_frame and
tests/test_backend_rtt.py::test_backend_task_single_blocking_fetch.  The
port's loops run a fixed count of iterations frozen on the device
(``ops/tracking_gn._gn_loop``, ``ops/global_gn.gn_loop``); these tests
count its reads the same way and hold the frozen loops to the early-exit
loops they replace, bit for bit.

A host read is counted where it can be seen on the CPU: every deliberate
read goes through ``device.to_host`` (counted in ``device.host_reads``),
and a dispatch mode counts ``aten._local_scalar_dense``, which every
``.item()``, ``bool(t)`` and ``float(t)`` reaches.  ``.tolist()``,
``.cpu()`` and ``.numpy()`` reach no operator there, so a static rule keeps
them out of the tracker and the solvers.  The oracle model's own host math
is excluded, as in the JAX tests (a real model reads nothing).
"""

import ast
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mast3r_slam_tpu_torch import device as tdevice
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.lie import sim3
from mast3r_slam_tpu_torch.ops import global_gn as tgn
from mast3r_slam_tpu_torch.ops import tracking_gn as ttg
from mast3r_slam_tpu_torch.retrieval.asmk import ASMKSettings
from mast3r_slam_tpu_torch.retrieval.database import RetrievalDatabase
from mast3r_slam_tpu_torch.retrieval.head import RetrievalHeadSettings, init_head_params
from mast3r_slam_tpu_torch.slam.pipeline import SLAM

from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_torch_common import CPU, TorchOracleModel, rays_problem, time_limit

HW = (48, 64)
PORT = pathlib.Path(__file__).resolve().parents[1] / "mast3r_slam_tpu_torch"
NO_HOST_READ_FILES = ("ops/tracking_gn.py", "ops/global_gn.py", "ops/matching.py",
                      "slam/tracker.py")


class HostReads(TorchDispatchMode):
    """Counts host reads while active: ``to_host`` calls plus scalar reads
    (``aten._local_scalar_dense``), except inside ``paused`` calls."""

    def __init__(self):
        super().__init__()
        self.scalar_reads = 0
        self.paused = 0
        self._paused_reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default and not self.paused:
            self.scalar_reads += 1
        return func(*args, **(kwargs or {}))

    def __enter__(self):
        self._start = tdevice.host_reads()
        return super().__enter__()

    def __exit__(self, *exc):
        self.helper_reads = tdevice.host_reads() - self._start - self._paused_reads
        return super().__exit__(*exc)

    @property
    def count(self) -> int:
        return self.scalar_reads + self.helper_reads

    def pause(self, fn):
        def wrapped(*a, **k):
            self.paused += 1
            before = tdevice.host_reads()
            try:
                return fn(*a, **k)
            finally:
                self._paused_reads += tdevice.host_reads() - before
                self.paused -= 1
        return wrapped


def _exclude_model(counter, model):
    for name in ("encode", "asymmetric", "symmetric", "mono"):
        setattr(model, name, counter.pause(getattr(model, name)))


def test_pipeline1_one_read_per_tracked_frame():
    """``base`` under ``pipeline: 1``, 16 frames, the backend stubbed out
    (its reads are the next test's): one read a tracked frame (the stats,
    pose included), one for the INIT frame's logged pose and one for the
    result's keyframe poses."""
    n = 16
    gt = arc_trajectory(n, radius=0.6, max_angle=2.5)
    model = TorchOracleModel(OracleModel(PlaneScene(HW), gt, noise=0.002))
    cfg = load_config("base")
    cfg["engine"].update(keyframe_buffer=64, edge_buffer=64, pipeline=1)
    cfg["single_thread"] = True
    with time_limit(120):
        slam = SLAM(model, cfg, HW, device=CPU)
        slam._submit_backend = lambda *a, **k: None
        counter = HostReads()
        _exclude_model(counter, model)
        with counter:
            result = slam.run(OracleDataset(n, HW), verbose=False)
        slam.close()
    assert slam.pipeline == 1 and result.n_reloc == 0
    assert result.n_keyframes >= 3  # keyframe switches re-submit, and read nothing more
    n_tracked = n - 1
    assert counter.count == 2 + n_tracked, (
        f"{counter.count} host reads ({counter.helper_reads} through to_host, "
        f"{counter.scalar_reads} scalar reads) for {n_tracked} tracked frames; "
        f"expected {2 + n_tracked}")


def test_speed_backend_task_reads_once():
    """One steady-state ``speed`` backend task (retrieval, add_factors with
    the speculative gate, the dense solve) reads the host once: retrieval's
    batched read."""
    n = 12
    gt = arc_trajectory(n, radius=0.6, max_angle=2.5)
    model = TorchOracleModel(OracleModel(PlaneScene(HW), gt, noise=0.002))
    cfg = load_config("speed")
    assert cfg["local_opt"]["speculative_gate"] is True
    cfg["engine"].update(keyframe_buffer=64, edge_buffer=64)
    cfg["single_thread"] = True
    g = torch.Generator().manual_seed(0)
    db = RetrievalDatabase(init_head_params(g, model.feat_dim, hdims=(8,)),
                           torch.randn((64, 8), generator=g) * 0.3,
                           RetrievalHeadSettings(nfeat=8),
                           ASMKSettings(max_images=64), device=CPU)
    with time_limit(120):
        slam = SLAM(model, cfg, HW, retrieval=db, device=CPU)
        slam.run(OracleDataset(n, HW), verbose=False)
        kf_idx = len(slam.keyframes) - 1
        assert kf_idx >= 3
        counter = HostReads()
        _exclude_model(counter, model)
        with counter:
            slam._backend_update_impl(kf_idx)
        slam.close()
    assert counter.count == 1, (
        f"{counter.count} host reads ({counter.helper_reads} through to_host, "
        f"{counter.scalar_reads} scalar reads) in one backend task; expected 1")


def test_no_host_read_call_in_the_tracker_and_the_solvers():
    """``.tolist()``, ``.numpy()`` and ``.cpu()`` reach no operator on the
    CPU, so the counts above cannot see them: none in these files (reads go
    through ``device.to_host``)."""
    found = []
    for rel in NO_HOST_READ_FILES:
        tree = ast.parse((PORT / rel).read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("tolist", "numpy", "cpu")):
                found.append(f"{rel}:{node.lineno} .{node.func.attr}()")
    assert not found, found


# ---------------------------------------------------------------------------
# the frozen loops against the early-exit loops they replace
# ---------------------------------------------------------------------------

def _tracking_early_exit(residual_fn, T, settings):
    """The port's loop before the freeze: one host check an iteration."""
    cost = torch.full((), float("inf"))
    ok = torch.ones((), dtype=torch.bool)
    for _ in range(settings.max_iters):
        T, cost, ok, converged = ttg._gn_step(residual_fn, T, cost, settings)
        if bool(converged) or not bool(ok):
            break
    return T, cost, ok


def _tracking_problem(seed, calib, singular=False):
    rng = np.random.default_rng(seed)
    N = 2000
    Xk = rng.normal(size=(N, 3)).astype(np.float32)
    Xk[:, 2] = np.abs(Xk[:, 2]) * 2 + 1.5
    T_true = sim3.exp(torch.as_tensor(rng.normal(size=7) * 0.05, dtype=torch.float32))
    Xf = sim3.act(sim3.inv(T_true), torch.as_tensor(Xk))
    Xf = Xf + torch.as_tensor(rng.normal(size=(N, 3)) * 0.002, dtype=torch.float32)
    Qk = torch.as_tensor(1.5 + rng.uniform(size=(N, 1)), dtype=torch.float32)
    valid = torch.as_tensor(rng.uniform(size=(N, 1)) > 0.1, dtype=torch.float32)
    if singular:
        valid = torch.zeros_like(valid)  # no residual: H = 0, the factor fails
    Xk = torch.as_tensor(Xk)
    if not calib:
        return "ray_dist", (Xf, Xk, Qk, valid), None
    K = torch.tensor([[51.2, 0, 32.0], [0, 51.2, 24.0], [0, 0, 1]])
    uvz = torch.stack([K[0, 0] * Xk[:, 0] / Xk[:, 2] + K[0, 2],
                       K[1, 1] * Xk[:, 1] / Xk[:, 2] + K[1, 2], torch.log(Xk[:, 2])], -1)
    return "calib", (Xf, Xk, Qk, valid, uvz, torch.ones((N, 1), dtype=torch.bool), K), HW


@pytest.mark.parametrize("case", ["ray_dist", "calib", "ray_dist_singular",
                                  "calib_singular", "ray_dist_one_iter"])
def test_frozen_tracking_loop_equals_the_early_exit_loop(case):
    mode, inputs, img_size = _tracking_problem(3, case.startswith("calib"),
                                               singular=case.endswith("singular"))
    settings = ttg.GNSettings(max_iters=1 if case.endswith("one_iter") else 50)
    T0 = sim3.identity()
    if mode == "ray_dist":
        residual_fn = ttg._ray_dist_problem(settings, *inputs)
    else:
        residual_fn = ttg._calib_problem(settings, *inputs, img_size)
    want = _tracking_early_exit(residual_fn, T0, settings)
    with HostReads() as counter:
        got = ttg.tracking_gn_plain(mode, inputs, T0, settings, img_size)
        entry = (ttg.opt_pose_ray_dist_sim3(inputs[0], inputs[1], T0, *inputs[2:], settings)
                 if mode == "ray_dist" else
                 ttg.opt_pose_calib_sim3(inputs[0], inputs[1], T0, *inputs[2:], img_size,
                                         settings))
    assert counter.count == 0
    for a, b, c in zip(got, want, entry):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert bool(got[2]) == (not case.endswith("singular"))
    if case.endswith("singular"):  # the zero step of a failed factor
        assert torch.equal(got[0], sim3.retr(T0, torch.zeros(7)))


def _gn_early_exit(Twc, step, settings):
    """The port's gn_loop before the freeze: one host read an iteration."""
    P, pin = Twc.shape[0], settings.pin
    keep = (torch.arange(P) >= pin)[:, None]
    Twc_cur, Twc_prev = Twc, Twc
    prev_cost = torch.full((), float("inf"))
    it, ok, diverged = 0, True, False
    while it < settings.max_iters:
        dx, ok_t, cost = step(Twc_cur, torch.tensor(True))
        dx_full = torch.cat([dx.new_zeros((pin, 7)), dx], dim=0)
        Twc_new = torch.where(keep, sim3.retr(Twc_cur, dx_full), Twc_cur)
        delta = torch.sqrt(torch.sum(dx * dx))
        worse = cost > prev_cost * 1.01
        Twc_cur, Twc_prev = torch.where(worse, Twc_prev, Twc_new), Twc_cur
        prev_cost = torch.where(worse, prev_cost, cost)
        it += 1
        ok, diverged = bool(ok_t), bool(worse)
        if float(delta) < settings.delta_norm or not ok or diverged:
            break
    return Twc_cur, it, ok, diverged


def _rays_step(settings):
    _, (Twc, Xs, Cs, ii, jj, idx, valid, Q, K), hw = rays_problem(CPU, n_kf=5, N=400)
    fields = tgn.precompute_edge_data(Xs, Cs, ii, jj, idx, valid, Q, settings, "rays", hw)
    edge = (ii, jj, *fields)
    P = Twc.shape[0]

    def step(T, active):
        H_e, g_e, c_e = tgn.edge_blocks(T, edge, K, hw, settings, "rays")
        dx, ok = tgn._assemble_and_solve(H_e, g_e, ii, jj, P, settings.pin,
                                         settings.pcg_damping)
        return dx, ok, torch.sum(c_e)

    return Twc, step


@pytest.mark.parametrize("case", ["full", "delta_norm_stop", "guard_reverts", "not_ok"])
def test_frozen_gn_loop_equals_the_early_exit_loop(case):
    settings = tgn.GlobalGNSettings(
        edge_batch=2, delta_norm=1e-3 if case == "delta_norm_stop" else 1e-8)
    Twc, step = _rays_step(settings)
    calls = [0]
    if case == "guard_reverts":  # the second step is wrong and large
        real = step

        def step(T, active):
            dx, ok, cost = real(T, active)
            calls[0] += 1
            return (dx + 0.5 if calls[0] == 2 else dx), ok, cost
    elif case == "not_ok":  # the third solve fails
        real = step

        def step(T, active):
            dx, ok, cost = real(T, active)
            calls[0] += 1
            return dx, ok & torch.tensor(calls[0] != 3), cost
    want = _gn_early_exit(Twc, step, settings)
    calls[0] = 0
    with HostReads() as counter:
        got = tgn.gn_loop(Twc, step, settings)
    assert counter.count == 0
    assert calls[0] in (0, settings.max_iters)  # a fixed count of steps
    T, iters, ok, diverged = got
    assert torch.equal(T, want[0])
    assert (int(iters), bool(ok), bool(diverged)) == want[1:]
    expect = {"guard_reverts": (3, True, True), "not_ok": (3, False, False)}.get(case)
    if expect is not None:
        assert want[1:] == expect
    elif case == "delta_norm_stop":
        assert want[1] < settings.max_iters and want[2] and not want[3]


def test_pcg_routed_solve_reads_once_a_frozen_iteration(monkeypatch):
    """On the PCG route the CG loop still reads its test once a CG
    iteration; the GN loop's flag joins that test, so an iteration after
    the loop stopped reads once and leaves, and the solve stops where the
    early-exit loop did."""
    settings = tgn.GlobalGNSettings(edge_batch=2, solver="pcg", delta_norm=1e-3)
    _, (Twc, Xs, Cs, ii, jj, idx, valid, Q, K), hw = rays_problem(CPU, n_kf=5, N=400)
    real = tgn._assemble_and_solve_pcg
    reads = []

    def counted(*a, **k):
        with HostReads() as inner:
            out = real(*a, **k)
        reads.append(inner.scalar_reads)
        return out

    monkeypatch.setattr(tgn, "_assemble_and_solve_pcg", counted)
    with HostReads() as counter:
        T, iters, ok, diverged = tgn.gauss_newton_poses(
            Twc, Xs, Cs, ii, jj, idx, valid, Q, K, hw, settings, "rays")
    iters = int(iters)
    assert bool(ok) and not bool(diverged) and 1 <= iters < settings.max_iters
    assert len(reads) == settings.max_iters
    assert all(r >= 2 for r in reads[:iters]), reads  # CG ran in every active one
    assert reads[iters:] == [1] * (settings.max_iters - iters), reads
    assert counter.count == sum(reads)
