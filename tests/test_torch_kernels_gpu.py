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
worst element, and 2e-3 on average.  Refine: exact integer equality.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_tpu_torch.ops import attention, refine

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
                                     (1, 16, 20, 12)])  # F % 8 != 0: 4-byte loads
@pytest.mark.parametrize("radius,dil", [(3, 5), (1, 1)])
def test_refine_kernel_matches_plain_exactly(cuda, B, H, W, F, radius, dil):
    d11q, d21q, idx = _refine_inputs(B, H, W, F, cuda, seed=H + radius)
    before = refine.counter.count
    got = refine.refine_window(d11q, d21q, idx, H, W, radius, dil)
    torch.cuda.synchronize()
    assert refine.counter.count == before + 1
    want = refine.refine_window_plain(d11q, d21q, idx, H, W, radius, dil)
    assert torch.equal(got, want)


def test_refine_kernel_refuses_other_inputs(cuda):
    d = torch.zeros(1, 16, 6, device=cuda, dtype=torch.int8)  # F % 4 != 0
    idx = torch.zeros(1, 16, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="F % 4"):
        refine.refine_window(d, d, idx, 4, 4, 1, 1)
    d = torch.zeros(16 * 8 + 4, device=cuda, dtype=torch.int8)[4:].view(1, 16, 8)
    with pytest.raises(ValueError, match="aligned"):
        refine.refine_window(d, d, idx, 4, 4, 1, 1)
