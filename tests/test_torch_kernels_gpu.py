"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when no
CUDA card is present (decided when the test runs, never at import, so every
xdist worker collects the same tests).  This file imports no JAX, so on the
GPU machine it runs without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Attention tolerance: bf16 output; the kernel rounds the softmax weights to
bf16 before dividing by the row sum (online softmax) where the plain
version rounds after, and sums in another order.  At unit-scale inputs the
outputs agree to within 2 bf16 ulps at magnitude 2 (2**-6 = 0.0156) at the
worst element, and 2e-3 on average; on strided views (heads split from
a fused projection) the same.  Refine: exact integer equality, on inputs
that take the shared-memory window (smooth flow), that force global reads
(scattered starts), at every border and on ties.
Edge blocks: compared entry by entry on the scale the solve reads them
at, ``edge_hg.block_err`` (|got_ij - want_ij| / sqrt(|want_ii|·|want_jj|),
the cost being the error column's diagonal): against the plain version
evaluated in float64 within EDGE_HG_ERR_F64, against the plain version in
f32 within EDGE_HG_ERR_F32 (its long (8, 4N) x (4N, 8) products drift
more than the kernel's tree of partial sums).  At 32 x 384*512 on an H100
the kernel reads 4.2e-6 against float64 and 4.3e-4 against the f32 plain
version, which itself reads 4.3e-4 against float64; planted faults read
0.031 to 1.  Under invalid pixels (sq = 0) bitwise equality; two calls
give the same bits, in one kernel launch, with exact zeros at
Mloc[:, 3:6, 6] (no row reaches them).
The gathers (gather_rows_sum, ivf_hamming, take_along_rows): exact, on
integer-valued inputs whose f32 sums are exact; take_along_rows at every
slab width of chip_smoke.py's sweep, with partial last slabs and indices
outside the table in the first and last slab; gather_rows_sum below, at
and above one wave of the card.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_tpu_torch.lie import sim3
from mast3r_slam_tpu_torch.ops import attention, edge_hg, gather, refine
from mast3r_slam_tpu_torch.ops import global_gn

pytestmark = pytest.mark.gpu

ATTN_MAX_ERR = 2.0 ** -6
ATTN_MEAN_ERR = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,H,N,M", [
    (1, 2, 128, 128),     # small
    (2, 3, 100, 72),      # ragged query and key tiles
    (1, 16, 768, 768),    # ViT-L encoder at 384x512
    (1, 12, 768, 768),    # ViT-L decoder at 384x512
    (2, 12, 768, 768),    # ViT-L symmetric decoder (a backend task)
])
def test_attention_kernel_matches_plain(cuda, B, H, N, M):
    g = torch.Generator(device=cuda).manual_seed(N + M)
    q = torch.randn(B, H, N, 64, device=cuda, generator=g).to(torch.bfloat16)
    k = torch.randn(B, H, M, 64, device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn(B, H, M, 64, device=cuda, generator=g).to(torch.bfloat16)
    before = attention.counter.count
    got = attention.sdpa(q, k, v)
    torch.cuda.synchronize()
    assert attention.counter.count == before + 1
    want = attention.sdpa_plain(q, k, v)
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert err.max().item() <= ATTN_MAX_ERR, err.max().item()
    assert err.mean().item() <= ATTN_MEAN_ERR, err.mean().item()


@pytest.mark.parametrize("B,N,H", [(1, 768, 16), (2, 100, 3)])
def test_attention_kernel_on_strided_views(cuda, B, N, H):
    """Heads split from a fused qkv projection without a copy (the model's
    self-attention), and from separate projections (its cross-attention):
    the kernel reads the views through its tensor maps, the plain version
    gives the same values on the same views, and the output is a view of a
    (B, N, H, D) tensor."""
    g = torch.Generator(device=cuda).manual_seed(N + H)
    qkv = torch.randn(B, N, 3 * H * 64, device=cuda, generator=g).to(torch.bfloat16)
    q, k, v = qkv.reshape(B, N, 3, H, 64).permute(2, 0, 3, 1, 4)
    assert not q.is_contiguous()
    sep = torch.randn(B, N, H * 64, device=cuda, generator=g).to(torch.bfloat16)
    k2 = sep.reshape(B, N, H, 64).transpose(1, 2)
    for args in ((q, k, v), (q, k2, v), (q.contiguous(), k2, v.contiguous())):
        got = attention.sdpa(*args)
        torch.cuda.synchronize()
        want = attention.sdpa_plain(*args)
        err = (got.float() - want.float()).abs()
        assert err.max().item() <= ATTN_MAX_ERR, err.max().item()
        assert err.mean().item() <= ATTN_MEAN_ERR, err.mean().item()
        assert got.transpose(1, 2).is_contiguous()
        assert torch.equal(got, attention.sdpa(*(a.contiguous() for a in args)))


def test_attention_kernel_refuses_other_inputs(cuda):
    q = torch.zeros(1, 1, 64, 64, device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        attention.sdpa(q, q, q)
    q = torch.zeros(1, 1, 64, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        attention.sdpa(q, q, q)
    q = torch.zeros(1, 1, 64, 128, device=cuda, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        attention.sdpa(q, q, q)
    q = torch.zeros(1 * 64 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="aligned"):
        attention.sdpa(*(q.view(1, 1, 64, 64),) * 3)
    q = torch.zeros(1, 2, 60, 68, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):  # rows 136 bytes apart
        attention.sdpa(q, q, q)


def _refine_inputs(B, H, W, F, device, seed):
    rng = np.random.default_rng(seed)
    D11 = rng.normal(size=(B, H, W, F)).astype(np.float32)
    D11 = D11 + np.roll(D11, 1, axis=2) * 0.7 + np.roll(D11, 1, axis=1) * 0.5
    D11 /= np.linalg.norm(D11, axis=-1, keepdims=True)
    N = H * W
    sh = rng.integers(-4, 5, size=(B, N, 2))
    u = np.clip(np.arange(N) % W + sh[..., 0], 0, W - 1)
    v = np.clip(np.arange(N) // W + sh[..., 1], 0, H - 1)
    D21 = np.stack([D11[b].reshape(N, F)[v[b] * W + u[b]] for b in range(B)])
    D21 = D21 + rng.normal(size=D21.shape).astype(np.float32) * 0.05
    idx = np.tile(np.arange(N, dtype=np.int32), (B, 1))
    d11q = refine.quantize(torch.from_numpy(D11).to(device)).reshape(B, N, F).contiguous()
    d21q = refine.quantize(torch.from_numpy(D21.astype(np.float32)).to(device)).contiguous()
    return d11q, d21q, torch.from_numpy(idx).to(device)


@pytest.mark.parametrize("B,H,W,F", [(2, 24, 32, 24), (1, 384, 512, 24), (1, 16, 20, 8),
                                     (1, 16, 20, 12),  # F % 8 != 0: 4-byte loads
                                     (1, 48, 64, 16)])
@pytest.mark.parametrize("radius,dil", [(3, 5), (1, 1), (2, 3)])
def test_refine_kernel_matches_plain_exactly(cuda, B, H, W, F, radius, dil):
    d11q, d21q, idx = _refine_inputs(B, H, W, F, cuda, seed=H + radius)
    before = refine.counter.count
    got = refine.refine_window(d11q, d21q, idx, H, W, radius, dil)
    torch.cuda.synchronize()
    assert refine.counter.count == before + 1
    want = refine.refine_window_plain(d11q, d21q, idx, H, W, radius, dil)
    assert torch.equal(got, want)


def _smooth_flow_inputs(H, W, F, device, seed, jitter=2):
    """As on video: descriptors that vary over about 8 px (a field
    upsampled from 1/8 resolution plus some pixel-scale detail), matches
    displaced by a smooth flow (a few pixels, varying over the image),
    starts up to `jitter` px off, so a 16x16 patch's matches stay within a
    small box."""
    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.normal(size=(1, F, H // 8, W // 8)).astype(np.float32))
    field = torch.nn.functional.interpolate(low, size=(H, W), mode="bilinear",
                                            align_corners=False)[0].permute(1, 2, 0).numpy()
    detail = rng.normal(size=(H, W, F)).astype(np.float32)
    D11 = (field / np.linalg.norm(field, axis=-1, keepdims=True)
           + 0.3 * detail / np.linalg.norm(detail, axis=-1, keepdims=True))
    D11 /= np.linalg.norm(D11, axis=-1, keepdims=True)
    N = H * W
    u, v = np.arange(N) % W, np.arange(N) // W
    tu = np.clip(u + np.rint(3 + 5 * np.sin(2 * np.pi * v / H)), 0, W - 1).astype(np.int64)
    tv = np.clip(v + np.rint(-2 + 4 * np.cos(2 * np.pi * u / W)), 0, H - 1).astype(np.int64)
    D21 = D11.reshape(N, F)[tv * W + tu] + rng.normal(size=(N, F)).astype(np.float32) * 0.05
    su = np.clip(tu + rng.integers(-jitter, jitter + 1, N), 0, W - 1)
    sv = np.clip(tv + rng.integers(-jitter, jitter + 1, N), 0, H - 1)
    d11q = refine.quantize(torch.from_numpy(D11).to(device)).reshape(1, N, F).contiguous()
    d21q = refine.quantize(torch.from_numpy(D21).to(device))[None].contiguous()
    idx = torch.from_numpy((sv * W + su).astype(np.int32))[None].to(device)
    return d11q, d21q, idx


def _refine_with_stats(d11q, d21q, idx, H, W, radius, dil):
    stats = torch.zeros(4, dtype=torch.int64, device=d11q.device)
    got = refine.refine_window_cuda(d11q, d21q, idx, H, W, radius, dil, stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(got, refine.refine_window_plain(d11q, d21q, idx, H, W, radius, dil))
    whole, pairs, px_win, px_all = stats.tolist()
    assert pairs > 0 and px_all == idx.numel() * dil
    return whole / pairs, px_win / px_all


@pytest.mark.parametrize("radius,dil", [(3, 5), (1, 1), (2, 3)])
def test_refine_kernel_smooth_flow_reads_shared_memory(cuda, radius, dil):
    H, W, F = 384, 512, 24
    d11q, d21q, idx = _smooth_flow_inputs(H, W, F, cuda, seed=radius + dil)
    whole, px = _refine_with_stats(d11q, d21q, idx, H, W, radius, dil)
    assert whole > 0.9 and px > 0.95, (whole, px)


def test_refine_kernel_spread_input_reads_global_memory(cuda):
    """Starts scattered over the whole image (random network weights):
    every block's window is over the budget, so every candidate comes from
    global memory, and the result is still exact."""
    H, W, F = 384, 512, 24
    d11q, d21q, _ = _smooth_flow_inputs(H, W, F, cuda, seed=9)
    g = torch.Generator(device=cuda).manual_seed(9)
    idx = torch.randint(0, H * W, (1, H * W), device=cuda, generator=g, dtype=torch.int32)
    whole, px = _refine_with_stats(d11q, d21q, idx, H, W, 3, 5)
    assert whole == 0 and px < 0.05, (whole, px)


@pytest.mark.parametrize("H,W", [(40, 48), (24, 24), (37, 53)])
@pytest.mark.parametrize("radius,dil", [(3, 5), (1, 1), (2, 3)])
def test_refine_kernel_windows_at_every_border(cuda, H, W, radius, dil):
    """Starts pushed out to the image's edges and corners, so windows are
    clamped at every border and candidates fall outside the image."""
    rng = np.random.default_rng(H + W)
    F = 24
    D11 = rng.normal(size=(H, W, F)).astype(np.float32)
    D11 /= np.linalg.norm(D11, axis=-1, keepdims=True)
    N = H * W
    u, v = np.arange(N) % W, np.arange(N) // W
    su = np.clip(2 * u - W // 2, 0, W - 1)
    sv = np.clip(2 * v - H // 2, 0, H - 1)
    D21 = D11.reshape(N, F)[rng.integers(0, N, N)]
    d11q = refine.quantize(torch.from_numpy(D11).to(cuda)).reshape(1, N, F).contiguous()
    d21q = refine.quantize(torch.from_numpy(D21).to(cuda))[None].contiguous()
    idx = torch.from_numpy((sv * W + su).astype(np.int32))[None].to(cuda)
    _refine_with_stats(d11q, d21q, idx, H, W, radius, dil)


@pytest.mark.parametrize("radius,dil", [(3, 5), (1, 1), (2, 3)])
def test_refine_kernel_constant_descriptors_tie(cuda, radius, dil):
    """Every in-image candidate ties: the first in dy-major order wins."""
    H, W, F = 48, 64, 24
    d = torch.full((1, H * W, F), 26, dtype=torch.int8, device=cuda)
    idx = torch.arange(H * W, dtype=torch.int32, device=cuda)[None]
    _refine_with_stats(d, d.clone(), idx, H, W, radius, dil)


def test_refine_kernel_refuses_other_inputs(cuda):
    d = torch.zeros(1, 16, 6, device=cuda, dtype=torch.int8)  # F % 4 != 0
    idx = torch.zeros(1, 16, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="F % 4"):
        refine.refine_window(d, d, idx, 4, 4, 1, 1)
    d = torch.zeros(16 * 8 + 4, device=cuda, dtype=torch.int8)[4:].view(1, 16, 8)
    with pytest.raises(ValueError, match="aligned"):
        refine.refine_window(d, d, idx, 4, 4, 1, 1)


SIG = dict(sigma_ray=0.003, sigma_dist=10.0, huber_k=1.345)
EDGE_HG_ERR_F64 = 3e-5
EDGE_HG_ERR_F32 = 1e-3


def _edge_inputs(E, N, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    Tij = sim3.exp(0.2 * torch.randn(E, 7, device=device, generator=g))
    Xi = torch.randn(E, N, 3, device=device, generator=g)
    Xi[..., 2] = Xi[..., 2].abs() + 2.0
    Xj = sim3.act(sim3.inv(Tij)[:, None, :], Xi)
    Xj = Xj + 0.01 * torch.randn(Xj.shape, device=device, generator=g)
    sq = torch.sqrt(1.5 + 1.5 * torch.rand(E, N, device=device, generator=g))
    sq = sq * (torch.rand(E, N, device=device, generator=g) > 0.2)
    return Tij.contiguous(), Xi.contiguous(), Xj.contiguous(), sq.contiguous()


def _kernel_names(fn):
    """Names of the kernels one call of ``fn`` launched, one a launch.  A
    call launches at least one kernel, so a trace with no kernel record has
    lost them (seen on an H100 for kernels launched from a ctypes library):
    it is taken again, up to ten times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


@pytest.mark.parametrize("E,N", [(1, 1), (3, 300), (5, 4097), (2, 12345), (257, 1000),
                                 (32, 384 * 512)])  # N a multiple of no tile
def test_edge_hg_kernel_matches_plain(cuda, E, N):
    Tij, Xi, Xj, sq = _edge_inputs(E, N, cuda, seed=E + N)
    before = edge_hg.counter.count
    got = edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **SIG)
    torch.cuda.synchronize()
    assert edge_hg.counter.count == before + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, got.transpose(1, 2))
    exact = edge_hg.edge_hg_rays_plain(Tij.double(), Xi.double(), Xj.double(),
                                       sq.double(), **SIG)
    assert edge_hg.block_err(got, exact) <= EDGE_HG_ERR_F64
    want = edge_hg.edge_hg_rays_plain(Tij, Xi, Xj, sq, **SIG)
    assert edge_hg.block_err(got, want) <= EDGE_HG_ERR_F32


@pytest.mark.parametrize("E,N", [(1, 1), (3, 300), (5, 4097), (257, 1000),
                                 (32, 384 * 512)])
def test_edge_hg_kernel_same_bits_one_launch(cuda, E, N):
    """Ragged and unaligned N (e·N·12 bytes not a multiple of 16), more
    edges than one gathered-point cache holds (256): the same bits on two
    calls, exact zeros where no row reaches (Mloc[:, 3:6, 6] and its
    mirror), and one kernel a call by the profiler's kernel names."""
    Tij, Xi, Xj, sq = _edge_inputs(E, N, cuda, seed=7 * E + N)
    got = edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **SIG)
    again = edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **SIG)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got[:, 3:6, 6] == 0).all() and (got[:, 6, 3:6] == 0).all()
    names = _kernel_names(lambda: edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **SIG))
    assert len(names) == 1, names


def test_edge_hg_check_fails_planted_faults(cuda):
    """The kernel with its distance row dropped (sigma_dist = inf), and its
    output with the gradient negated or the cost 30 % off, each break the
    bound many times over."""
    Tij, Xi, Xj, sq = _edge_inputs(8, 20000, cuda, seed=5)
    exact = edge_hg.edge_hg_rays_plain(Tij.double(), Xi.double(), Xj.double(),
                                       sq.double(), **SIG)
    got = edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **SIG)
    no_dist = edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **{**SIG, "sigma_dist": float("inf")})
    neg_grad = got.clone()
    neg_grad[:, :7, 7] *= -1
    neg_grad[:, 7, :7] *= -1
    cost_off = got.clone()
    cost_off[:, 7, 7] *= 1.3
    assert edge_hg.block_err(got, exact) <= EDGE_HG_ERR_F64
    for bad in (no_dist, neg_grad, cost_off):
        assert edge_hg.block_err(bad, exact) > 100 * EDGE_HG_ERR_F64


@pytest.mark.parametrize("garbage", [37.0, 0.0])
def test_edge_hg_kernel_ignores_invalid_pixels(cuda, garbage):
    Tij, Xi, Xj, sq = _edge_inputs(4, 5000, cuda, seed=3)
    clean = edge_hg.edge_hg_rays(Tij, Xi, Xj, sq, **SIG)
    bad = sq == 0
    Xi_g, Xj_g = Xi.clone(), Xj.clone()
    Xi_g[bad] = garbage
    Xj_g[bad] = garbage
    dirty = edge_hg.edge_hg_rays(Tij, Xi_g, Xj_g, sq, **SIG)
    torch.cuda.synchronize()
    assert torch.equal(clean, dirty)


def test_edge_hg_kernel_refuses_other_inputs(cuda):
    Tij, Xi, Xj, sq = _edge_inputs(2, 64, cuda, seed=1)
    with pytest.raises(ValueError, match="float32"):
        edge_hg.edge_hg_rays(Tij, Xi.double(), Xj, sq, **SIG)
    with pytest.raises(ValueError, match="CUDA device"):
        edge_hg.edge_hg_rays_cuda(Tij.cpu(), Xi.cpu(), Xj.cpu(), sq.cpu(), **SIG)
    with pytest.raises(ValueError, match="shapes"):
        edge_hg.edge_hg_rays(Tij, Xi, Xj[:, :32].contiguous(), sq, **SIG)
    with pytest.raises(ValueError, match="contiguous"):
        edge_hg.edge_hg_rays(Tij, Xi.transpose(0, 1), Xj, sq, **SIG)


def _rays_problem(device, n_kf=5, N=3000, seed=0):
    """A shared world cloud seen through identity correspondences, chain
    edges both ways, perturbed poses (tests/test_sharded_ba.py's problem)."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0, 1, n_kf)
    gt = np.zeros((n_kf, 8), np.float32)
    gt[:, 0], gt[:, 1], gt[:, 2] = 0.4 * np.sin(2.4 * s), 0.2 * s, 0.3 * s
    gt[:, 4], gt[:, 6], gt[:, 7] = np.sin(-0.24 * s), np.cos(-0.24 * s), 1.0
    gt = torch.as_tensor(gt)
    world = torch.as_tensor(rng.uniform(-1, 1, size=(N, 3)) + [0, 0, 3], dtype=torch.float32)
    Xs = sim3.act(sim3.inv(gt)[:, None, :], world)
    ii = torch.tensor(list(range(n_kf - 1)) + list(range(1, n_kf)))
    jj = torch.tensor(list(range(1, n_kf)) + list(range(n_kf - 1)))
    E = len(ii)
    tau = torch.as_tensor(rng.normal(size=(n_kf, 7)) * 0.02, dtype=torch.float32)
    tau[0] = 0
    args = (sim3.retr(gt, tau), Xs, torch.full((n_kf, N, 1), 2.0), ii, jj,
            torch.arange(N, dtype=torch.int32).expand(E, N).contiguous(),
            torch.ones((E, N, 1), dtype=torch.bool), torch.full((E, N, 1), 2.0),
            torch.eye(3))
    return gt, [a.to(device) for a in args], (1, N)


def test_global_gn_on_the_card_launches_the_kernel_each_iteration(cuda):
    gt, args, hw = _rays_problem(cuda)
    before = edge_hg.counter.count
    T, iters, ok, _ = global_gn.gauss_newton_poses(*args, hw, global_gn.GlobalGNSettings(),
                                                   "rays")
    torch.cuda.synchronize()
    assert ok and edge_hg.counter.count - before == iters >= 1
    T_cpu = global_gn.gauss_newton_poses(*[a.cpu() for a in args], hw,
                                         global_gn.GlobalGNSettings(), "rays")[0]
    assert (T.cpu() - T_cpu).abs().max().item() <= 1e-5
    assert (T.cpu()[:, :3] - gt[:, :3]).norm(dim=-1).max().item() < 1e-4


@pytest.mark.parametrize("impl", ["reduce", "dot"])
def test_plain_ray_blocks_on_the_card_raise(cuda, impl):
    _, args, hw = _rays_problem(cuda, N=100)
    with pytest.raises(NotImplementedError, match="edge-block kernel"):
        global_gn.gauss_newton_poses(*args, hw, global_gn.GlobalGNSettings(hg_impl=impl),
                                     "rays")


# ---------------------------------------------------------------------------
# gathers: gather_rows_sum, ivf_hamming, take_along_rows (exact)
# ---------------------------------------------------------------------------

def _ints(shape, lo, hi, device, seed, dtype=torch.int32):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(lo, hi, shape, device=device, generator=g, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
@pytest.mark.parametrize("M,F,T", [(196608, 32, 196608), (196608, 16, 16384), (4096, 8, 1000),
                                   (300, 20, 77), (50, 128, 5)])
def test_gather_rows_sum_kernel_matches_plain_exactly(cuda, dtype, M, F, T):
    table = _ints((M, F), -100, 100, cuda, seed=M + F).to(dtype)
    idx = _ints((T,), 0, M, cuda, seed=T)
    before = gather.sum_counter.count
    got = gather.gather_rows_sum(table, idx)
    torch.cuda.synchronize()
    assert gather.sum_counter.count == before + 1
    assert torch.equal(got, gather.gather_rows_sum_plain(table, idx))


@pytest.mark.parametrize("W", [1, 2, 3, 32])
@pytest.mark.parametrize("cap", [16, 32])
def test_ivf_hamming_kernel_matches_plain_exactly(cuda, W, cap):
    nb, Q = 1025, 1500
    bvecs = _ints((nb, cap, W), -2 ** 31, 2 ** 31 - 1, cuda, seed=W)
    q = _ints((Q, W), -2 ** 31, 2 ** 31 - 1, cuda, seed=W + 1)
    qw = _ints((Q,), 0, nb, cuda, seed=cap)
    before = gather.ivf_counter.count
    got = gather.ivf_hamming(bvecs, q, qw)
    torch.cuda.synchronize()
    assert gather.ivf_counter.count == before + 1
    assert torch.equal(got, gather.ivf_hamming_plain(bvecs, q, qw))
    bad = qw.clone()
    bad[:3] = torch.tensor([-1, nb, 2 ** 30], device=cuda)  # outside: nothing read
    out = gather.ivf_hamming(bvecs, q, bad)
    assert (out[:3] == -1).all() and torch.equal(out[3:], got[3:])


@pytest.mark.parametrize("Q", [1, 7, 1500])
@pytest.mark.parametrize("W", [1, 2, 3, 32])
@pytest.mark.parametrize("cap", [16, 5])
def test_ivf_hamming_kernel_query_counts(cuda, Q, W, cap):
    """Several queries a warp (W 1 and 2, and cap 5 at W 3), a ragged last
    warp (Q = 7), words outside the table (-1, nothing read); one kernel a
    call."""
    nb = 257
    bvecs = _ints((nb, cap, W), -2 ** 31, 2 ** 31 - 1, cuda, seed=Q + W)
    q = _ints((Q, W), -2 ** 31, 2 ** 31 - 1, cuda, seed=Q + W + 1)
    qw = _ints((Q,), 0, nb, cuda, seed=Q + cap)
    bad = torch.zeros(Q, dtype=torch.bool, device=cuda)
    if Q > 1:
        bad[1::3] = True
        qw[1::6] = -1
        qw[4::6] = nb
    got = gather.ivf_hamming(bvecs, q, qw)
    torch.cuda.synchronize()
    want = gather.ivf_hamming_plain(bvecs, q, torch.where(bad, 0, qw))
    assert torch.equal(got[~bad], want[~bad])
    assert (got[bad] == -1).all()
    assert len(_kernel_names(lambda: gather.ivf_hamming(bvecs, q, qw))) == 1


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
@pytest.mark.parametrize("M,F,K", [(196608, 32, 196608), (2048, 128, 2048), (768, 1024, 300),
                                   (64, 3, 7)])  # K * F % 4 != 0: a ragged tail
def test_take_along_rows_kernel_matches_plain_exactly(cuda, dtype, M, F, K):
    tab = _ints((M, F), -100, 100, cuda, seed=M).to(dtype)
    idx = _ints((K, F), 0, M, cuda, seed=K + F)
    before = gather.take_counter.count
    got = gather.take_along_rows(tab, idx)
    torch.cuda.synchronize()
    assert gather.take_counter.count == before + 1
    assert torch.equal(got, gather.take_along_rows_plain(tab, idx))
    assert torch.equal(got, torch.gather(tab, 0, idx.long()))
    rows = idx[:, :1].expand(K, F).contiguous()  # the index broadcast along each row
    assert torch.equal(gather.take_along_rows(tab, rows), tab[rows[:, 0].long()])


@pytest.mark.parametrize("slab_bytes", [32, 64, 128])
@pytest.mark.parametrize("dtype,M,F,K", [
    (torch.float32, 5000, 12, 3000),   # F not a multiple of the slab: a partial last slab
    (torch.float32, 5000, 40, 3000),
    (torch.int8, 5000, 8, 3000),       # the slab is the whole row
    (torch.int8, 5000, 32, 3000),
    (torch.int8, 5000, 40, 3000),      # int8 rows not a multiple of 16: scalar stores
    (torch.float32, 196608, 128, 64),  # K much smaller than M
    (torch.int8, 196608, 128, 64),
    (torch.float32, 100, 64, 20000),   # K much larger than M
])
def test_take_along_rows_slab_widths_exact(cuda, slab_bytes, dtype, M, F, K):
    """Every slab width of the sweep, exact, one kernel a call."""
    tab = _ints((M, F), -100, 100, cuda, seed=M + F).to(dtype)
    idx = _ints((K, F), 0, M, cuda, seed=K)
    run = lambda: gather.take_along_rows_cuda(tab, idx, slab_bytes=slab_bytes)
    before = gather.take_counter.count
    got = run()
    torch.cuda.synchronize()
    assert gather.take_counter.count == before + 1
    assert torch.equal(got, gather.take_along_rows_plain(tab, idx))
    assert len(_kernel_names(run)) == 1


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
@pytest.mark.parametrize("F", [12, 40, 128])
def test_take_along_rows_out_of_range_in_first_and_last_slab(cuda, dtype, F):
    """Indices outside [0, M) in the first, a middle and the last column
    read nothing and give NaN (f32) or 0 (int8); the rest stays exact."""
    M, K = 1000, 500
    tab = _ints((M, F), -100, 100, cuda, seed=F).to(dtype)
    idx = _ints((K, F), 0, M, cuda, seed=F + 1)
    bad = torch.zeros((K, F), dtype=torch.bool, device=cuda)
    bad[::7, 0] = bad[3::11, F - 1] = bad[5::13, F // 2] = True
    outside = torch.tensor([-1, M, 2 ** 31 - 1, -2 ** 31], dtype=torch.int32, device=cuda)
    idx[bad] = outside[torch.arange(int(bad.sum()), device=cuda) % 4]
    got = gather.take_along_rows(tab, idx)
    want = gather.take_along_rows_plain(tab, torch.where(bad, 0, idx))
    torch.cuda.synchronize()
    assert torch.equal(got[~bad], want[~bad])
    poison = got[bad].isnan() if dtype == torch.float32 else got[bad] == 0
    assert poison.all()


@pytest.mark.parametrize("dtype,F", [(torch.int8, 32), (torch.int8, 16), (torch.float32, 32),
                                     (torch.float32, 6)])
@pytest.mark.parametrize("waves", [0.5, 1.0, 2.5])
def test_gather_rows_sum_below_and_above_one_wave(cuda, dtype, F, waves):
    """T below, at and above what one wave of one-row groups holds: exact,
    one launch of at most the resident blocks, a group on 4 rows at a time
    only above the wave; an index outside the table gives NaN; the same
    bits on two calls on non-integer values."""
    is_int8 = int(dtype == torch.int8)
    row_words = F // 4 if is_int8 else F
    nw, lanes = gather.sum_plan(1, row_words, lambda nw, rb: 1)[:2]
    slots = lambda nw, rb: gather._slots_of(cuda, "gather_rows_sum_slots", is_int8, nw, rb)
    T = int(waves * slots(nw, 1) * (gather.THREADS // lanes)) + 3
    plan = gather.sum_plan(T, row_words, slots)
    assert plan.rb == (1 if waves < 1 else 4) and plan.grid <= slots(nw, plan.rb)
    M = 5000
    table = _ints((M, F), -100, 100, cuda, seed=F).to(dtype)
    idx = _ints((T,), 0, M, cuda, seed=T)
    before = gather.sum_counter.count
    got = gather.gather_rows_sum(table, idx)
    torch.cuda.synchronize()
    assert gather.sum_counter.count == before + 1
    assert torch.equal(got, gather.gather_rows_sum_plain(table, idx))
    assert len(_kernel_names(lambda: gather.gather_rows_sum(table, idx))) == 1
    idx[::97] = -1
    idx[1::97] = M
    got = gather.gather_rows_sum(table, idx)
    want = gather.gather_rows_sum_plain(table, idx.clamp(0, M - 1))
    bad = (idx < 0) | (idx >= M)
    assert got[bad].isnan().all() and torch.equal(got[~bad], want[~bad])
    if dtype == torch.float32:
        g = torch.Generator(device=cuda).manual_seed(1)
        x = torch.randn((M, F), device=cuda, generator=g)
        a, b = gather.gather_rows_sum(x, idx), gather.gather_rows_sum(x, idx)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))  # NaN rows too


def test_gather_kernels_refuse_other_inputs(cuda):
    table = torch.zeros(64, 16, device=cuda)
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int8 or torch.float32"):
        gather.gather_rows_sum(table.double(), idx)
    with pytest.raises(ValueError, match="int32"):
        gather.gather_rows_sum(table, idx.long())
    with pytest.raises(ValueError, match="CUDA device"):
        gather.gather_rows_sum_cuda(table.cpu(), idx.cpu())
    with pytest.raises(ValueError, match="aligned"):
        gather.gather_rows_sum(torch.zeros(64 * 16 + 1, device=cuda)[1:].view(64, 16), idx)
    with pytest.raises(ValueError, match="F % 4"):
        gather.gather_rows_sum(torch.zeros(64, 6, dtype=torch.int8, device=cuda), idx)

    bvecs = torch.zeros(5, 16, 2, dtype=torch.int32, device=cuda)
    q = torch.zeros(8, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        gather.ivf_hamming(bvecs.float(), q, idx)
    with pytest.raises(ValueError, match="CUDA device"):
        gather.ivf_hamming_cuda(bvecs.cpu(), q.cpu(), idx.cpu())
    with pytest.raises(ValueError, match="aligned"):
        gather.ivf_hamming(torch.zeros(5 * 16 * 2 + 1, dtype=torch.int32,
                                       device=cuda)[1:].view(5, 16, 2), q, idx)
    with pytest.raises(ValueError, match="W from bvecs"):
        gather.ivf_hamming(bvecs, torch.zeros(8, 3, dtype=torch.int32, device=cuda), idx)

    tab = torch.zeros(64, 16, device=cuda)
    tidx = torch.zeros(8, 16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int8 or torch.float32"):
        gather.take_along_rows(tab.half(), tidx)
    with pytest.raises(ValueError, match="CUDA device"):
        gather.take_along_rows_cuda(tab.cpu(), tidx.cpu())
    with pytest.raises(ValueError, match="aligned"):
        gather.take_along_rows(tab, torch.zeros(8 * 16 + 1, dtype=torch.int32,
                                                device=cuda)[1:].view(8, 16))
    with pytest.raises(ValueError, match="idx \\(K, F\\)"):
        gather.take_along_rows(tab, tidx[:, :8].contiguous())


def test_retrieval_database_on_the_card(cuda):
    """update/query on the card: one ivf_hamming launch a search and no
    other gather kernel; the kernel equals its plain version on a query's
    tensors and the kernel route's scores the plain route's; two calls give
    the same codes."""
    from mast3r_slam_tpu_torch.retrieval import RetrievalDatabase, asmk

    class Fr:
        def __init__(self, feat):
            self.feat = feat

    db = RetrievalDatabase.random_init(3, 64, proj_dim=64, num_centroids=512, nfeat=32,
                                       device=cuda)
    g = torch.Generator().manual_seed(4)
    base = torch.randn(4, 100, 64, generator=g)
    ivf0, take0 = gather.ivf_counter.count, gather.take_counter.count
    n_cands = 0
    for i in range(8):
        feat = base[i % 4] + 0.05 * torch.randn(100, 64, generator=g)
        n_cands += len(db.update(Fr(feat[None].to(cuda)), True, k=3, min_thresh=0.005))
    assert n_cands >= 4
    assert gather.ivf_counter.count - ivf0 == 7   # the first update only adds
    assert gather.take_counter.count - take0 == 0
    feat = (base[1] + 0.05 * torch.randn(100, 64, generator=g))[None].to(cuda)
    inds, (feats, codes), scores = db.query(Fr(feat), 3, 0.005, with_scores=True)
    packed, words, valid = db._codes(feats, codes, db.s.ma_query)
    assert torch.equal(packed, db._codes(feats, codes, db.s.ma_query)[0])
    ivf = db.ivf
    qw = torch.where(valid, words, ivf.bvecs.shape[0] - 1).to(torch.int32)
    assert torch.equal(gather.ivf_hamming(ivf.bvecs, packed, qw),
                       gather.ivf_hamming_plain(ivf.bvecs, packed, qw))
    args = (ivf.bvecs, ivf.bimids, ivf.norm_factor, packed, words, valid, ivf.dim,
            ivf.s.alpha, ivf.s.similarity_threshold, ivf.s.max_images)
    plain = asmk.ivf_search_bucketed(*args, hamming=gather.ivf_hamming_plain)
    kernel = asmk.ivf_search_bucketed(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(kernel.cpu().numpy(), plain.cpu().numpy(), rtol=1e-6, atol=1e-9)
    n_img = ivf.n_images
    assert np.array_equal(np.argsort(-kernel[:n_img].cpu().numpy())[:3],
                          np.argsort(-plain[:n_img].cpu().numpy())[:3])
    np.testing.assert_allclose(scores, kernel[:n_img].cpu().numpy(), rtol=1e-6, atol=1e-9)
    assert len(inds) >= 1
