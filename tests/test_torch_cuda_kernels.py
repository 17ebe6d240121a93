"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it runs on a machine with a card and no JAX:
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``. Without a
card every test skips. Tolerances: f32 1e-5 (the same f32 sums in another
order); bf16 two roundings of an 8-bit mantissa, 2^-7 * max(|plain|, 1).
"""

import pytest
import torch

from gpushare_device_plugin_tpu_torch.ops import flash_attention as fa


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(2, 300, 8, 128, generator=gen, device="cuda").to(dt)
    kv = torch.randn(2, 300, 2, 2, 128, generator=gen, device="cuda").to(dt)
    start = torch.tensor([0, 70], dtype=torch.int32, device="cuda")
    kv_len = torch.tensor([300, 130], dtype=torch.int32, device="cuda")
    before = fa.LAUNCHES["flash_fwd"]
    o, lse = fa.flash_fwd(q, kv[:, :, 0], kv[:, :, 1], start=start, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == before + 1
    po, plse = fa.flash_fwd_plain(
        q, kv[:, :, 0], kv[:, :, 1], causal=True, scale=128 ** -0.5, start=start, kv_len=kv_len
    )
    tol = 1e-5 if dt == torch.float32 else 2.0 ** -7 * po.float().abs().clamp(min=1)
    assert ((o.float() - po.float()).abs() <= tol).all()
    assert torch.equal(torch.isneginf(lse), torch.isneginf(plse))
