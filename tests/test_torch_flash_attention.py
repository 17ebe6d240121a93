"""The port's flash attention (gpushare_device_plugin_tpu_torch/ops) against
the reference Pallas kernel, run in interpret mode as its own tests run it.

On the CPU the port's wrapper takes the kernel's plain version, so these
tests hold that version (and the shape/bound handling around the kernel)
to the reference at f32, atol 1e-5: the same f32 sums in another order.
The CUDA kernel itself is compared with its plain version on the card by
tests/test_torch_cuda_kernels.py and by chip_smoke.py.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.ops.flash_attention import (
    flash_attention as jflash,
    flash_attention_lse as jflash_lse,
)
from gpushare_device_plugin_tpu_torch.ops import _build
from gpushare_device_plugin_tpu_torch.ops import flash_attention as fa
from gpushare_device_plugin_tpu_torch.workloads import attention as A

ATOL = 1e-5
B, S, D = 2, 64, 16


def _inputs(H, Hkv, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(
        rng.randn(B, S, h, D).astype(np.float32) for h in (H, Hkv, Hkv)
    )


def _ref(q, k, v, **kw):
    return np.asarray(jflash(
        *map(jnp.asarray, (q, k, v)), block_q=32, block_k=32, interpret=True,
        **{n: (jnp.asarray(b) if isinstance(b, np.ndarray) else b) for n, b in kw.items()},
    ))


def _port(q, k, v, **kw):
    kw = {n: (torch.from_numpy(b) if isinstance(b, np.ndarray) else b) for n, b in kw.items()}
    return fa.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (4, 1)])
def test_forward_matches_reference(causal, H, Hkv):
    q, k, v = _inputs(H, Hkv)
    np.testing.assert_allclose(
        _port(q, k, v, causal=causal), _ref(q, k, v, causal=causal), atol=ATOL, rtol=0
    )


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_reference(causal):
    q, k, v = _inputs(4, 2, seed=1)
    jo, jl = jflash_lse(
        *map(jnp.asarray, (q, k, v)), causal=causal, block_q=32, block_k=32,
        interpret=True,
    )
    to, tl = fa.flash_attention_lse(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert tl.shape == (B, S, 4) and tl.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_start_dead_rows_are_zero_like_reference():
    q, k, v = _inputs(4, 2, seed=2)
    start = np.array([0, 40], np.int32)  # row 1's queries < 40 see no key
    got = _port(q, k, v, causal=True, start=start)
    np.testing.assert_allclose(got, _ref(q, k, v, causal=True, start=start), atol=ATOL, rtol=0)
    assert np.all(got[1, :40] == 0) and np.isfinite(got).all()
    _, lse = fa.flash_fwd(*map(torch.from_numpy, (q, k, v)), start=torch.from_numpy(start))
    assert torch.isneginf(lse[1, :40]).all() and torch.isfinite(lse[1, 40:]).all()


@pytest.mark.parametrize("causal", [True, False])
def test_kv_len_matches_reference(causal):
    q, k, v = _inputs(4, 2, seed=3)
    kv_len = np.array([64, 21], np.int32)
    np.testing.assert_allclose(
        _port(q, k, v, causal=causal, kv_len=kv_len),
        _ref(q, k, v, causal=causal, kv_len=kv_len), atol=ATOL, rtol=0,
    )


def test_start_and_kv_len_window_matches_reference():
    q, k, v = _inputs(4, 2, seed=4)
    start, kv_len = np.array([5, 10], np.int32), np.array([50, 33], np.int32)
    np.testing.assert_allclose(
        _port(q, k, v, causal=True, start=start, kv_len=kv_len),
        _ref(q, k, v, causal=True, start=start, kv_len=kv_len), atol=ATOL, rtol=0,
    )


def test_cpu_tensors_take_the_plain_version_without_the_kernel(monkeypatch):
    def no_kernel(name):
        raise AssertionError("the kernel loader must not run for CPU tensors")

    monkeypatch.setattr(_build, "load", no_kernel)
    before = dict(fa.LAUNCHES)
    q, k, v = map(torch.from_numpy, _inputs(4, 2))
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    po, plse = fa.flash_fwd_plain(q, k, v, causal=True, scale=D ** -0.5)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert fa.LAUNCHES == before


def test_wrapper_rejects_bad_shapes():
    q, k, v = map(torch.from_numpy, _inputs(4, 2))
    with pytest.raises(ValueError, match="not a multiple"):
        fa.flash_attention(q, k[:, :, :1].expand(B, S, 3, D), v[:, :, :1].expand(B, S, 3, D))
    with pytest.raises(ValueError, match="one bound per row"):
        fa.flash_attention(q, k, v, kv_len=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, k[:, :10], v[:, :10])


def test_fits_kernel_and_gate():
    assert fa.fits_kernel(1, 128) and fa.fits_kernel(1537, 64)
    assert not fa.fits_kernel(64, 132) and not fa.fits_kernel(64, 12)
    q = torch.zeros(1, 8, 4, 16)
    assert A.use_flash("flash", q) and not A.use_flash("plain", q)
    assert not A.use_flash("auto", q)  # CPU tensors stay on the plain path
    with pytest.raises(ValueError, match="unknown attention"):
        A.use_flash("fast", q)


def test_chunk_prefill_attention_matches_reference():
    from gpushare_device_plugin_tpu.workloads.attention import (
        chunk_prefill_attention as jchunk,
    )

    q, k, v = _inputs(4, 2, seed=5)
    want = np.asarray(jchunk(*map(jnp.asarray, (q, k, v)), n_real=jnp.int32(40), attention="plain"))
    for attention in ("plain", "flash", "auto"):
        got = A.chunk_prefill_attention(
            *map(torch.from_numpy, (q, k, v)), n_real=40, attention=attention
        ).numpy()
        # pad rows (>= 40) differ by design between the routes; real rows agree
        np.testing.assert_allclose(got[:, :40], want[:, :40], atol=ATOL, rtol=0)


def _extern_c_entries():
    """{name: (source stem, [ctypes type per parameter])} for every
    ``extern "C"`` function in ``ops/csrc/*.cu``, parsed from the sources."""
    scalar = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_int64}
    out = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            types = []
            for param in m.group(2).split(","):
                ctype = re.sub(r"\s+", " ", param).strip().rsplit(" ", 1)[0]
                types.append(ctypes.c_void_p if ctype.endswith("*") else scalar[ctype])
            out[m.group(1)] = (path.stem, types)
    return out


def test_argtypes_match_the_c_entries():
    """Each C entry's ctypes declaration has its source's argument count,
    order and types, and names the source that defines it; every entry
    has a launch count."""
    entries = _extern_c_entries()
    assert set(entries) == set(fa._ARGTYPES) == set(fa._SOURCE) == set(fa.LAUNCHES)
    for name, (stem, types) in entries.items():
        assert fa._SOURCE[name] == stem, name
        assert fa._ARGTYPES[name] == types, name
