"""Port kernels on the card: each CUDA kernel against its plain version.

Marked ``cuda``: these skip on hosts without an NVIDIA GPU.  On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

# bf16 tolerance: 4 ulps relative plus 2^-6 absolute (see chip_smoke.py)
ATOL = RTOL = 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, ci, co, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((b, h, h, ci), generator=g, device=device)
    w = torch.randn((4, 4, ci, co), generator=g, device=device) * 0.05
    gamma = 1 + 0.1 * torch.randn(co, generator=g, device=device)
    beta = 0.1 * torch.randn(co, generator=g, device=device)
    return x.to(torch.bfloat16), w, gamma, beta


def _assert_close(a, b):
    a, b = a.float(), b.float()
    assert torch.all((a - b).abs() <= ATOL + RTOL * b.abs()), \
        float((a - b).abs().max())


@pytest.mark.parametrize("b,h,ci,co,gs", [(3, 4, 128, 64, 16),
                                          (2, 8, 64, 32, 8),
                                          (2, 16, 64, 64, 16)])
def test_k1_matches_plain(cuda, b, h, ci, co, gs):
    from levelgan_torch.kernels import upsample_block as k1
    from levelgan_torch.ops.blocks import upsample_block
    x, w, gamma, beta = _inputs(b, h, ci, co, cuda)
    n = k1.launches
    y = k1.upsample_block_fwd(x, w, gamma, beta, group_size=gs)
    assert k1.launches == n + 1
    _assert_close(y, upsample_block(x, w, gamma, beta, group_size=gs))


@pytest.mark.parametrize("b,h,ci,co", [(2, 16, 128, 64), (2, 32, 64, 32)])
def test_k1l_matches_plain(cuda, b, h, ci, co):
    from levelgan_torch.kernels import upsample_rows as k1l
    x, w, _, _ = _inputs(b, h, ci, co, cuda, seed=1)
    yf, s1, s2 = k1l.upsample_rows_fwd(x, w)
    yf_p, s1_p, s2_p = k1l.conv_rows_plain(x, w)
    _assert_close(yf, yf_p)
    torch.testing.assert_close(s1, s1_p, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(s2, s2_p, atol=1e-3, rtol=1e-4)


def test_kernel_wrappers_raise_on_bad_shapes(cuda):
    from levelgan_torch.kernels import upsample_block as k1
    x, w, gamma, beta = _inputs(2, 4, 48, 32, cuda)   # ci not a multiple of 64
    with pytest.raises(ValueError):
        k1.upsample_block_fwd(x, w, gamma, beta)
