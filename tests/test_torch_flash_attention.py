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


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 128, "flash_fwd"),
    (torch.bfloat16, 64, "flash_fwd"),
    (torch.bfloat16, 96, "flash_fwd_scalar"),
    (torch.bfloat16, 32, "flash_fwd_scalar"),
    (torch.float32, 128, "flash_fwd_scalar"),
    (torch.float32, 64, "flash_fwd_scalar"),
])
def test_forward_entry_is_chosen_by_dtype_and_head_dim(monkeypatch, dtype, D, want):
    """bf16 with D in {64, 128} takes the tensor-core entry, everything
    else the scalar one, and ``flash_fwd`` launches what ``fwd_entry``
    names. Meta tensors reach the launch path without a card."""
    assert fa.fwd_entry(dtype, D) == want
    launched = []

    def record(entry, q, k, v, **kw):
        launched.append(entry)
        return q, q[..., 0].float()

    monkeypatch.setattr(fa, "_launch_fwd", record)
    q = torch.empty(1, 8, 4, D, dtype=dtype, device="meta")
    kv = torch.empty(1, 8, 2, D, dtype=dtype, device="meta")
    fa.flash_fwd(q, kv, kv)
    assert launched == [want]


@pytest.mark.parametrize("entry", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_tensor_core_entries_refuse_misaligned_rows(entry):
    """One check guards every tensor-core entry: bf16, D in {64, 128}, rows
    16-byte aligned. It raises, so such inputs never reach the scalar
    entry; a dim of size 1 may have any stride."""
    ok = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
    fa._check_sm90(entry, ok, ok)
    odd = torch.zeros(1, 64, 2, 129, dtype=torch.bfloat16)[..., 1:]  # base off 16 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_sm90(entry, odd, ok)
    strided = torch.zeros(1, 64, 2, 132, dtype=torch.bfloat16)[..., :128]  # row stride 132
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_sm90(entry, ok, strided)
    with pytest.raises(ValueError, match="bf16 with D"):
        fa._check_sm90(entry, ok[..., :96])
    size_one = torch.zeros(64, 2, 128, 1, dtype=torch.bfloat16).permute(3, 0, 1, 2)
    assert size_one.stride(0) == 1
    fa._check_sm90(entry, size_one)


def test_library_name_hashes_the_shared_headers(monkeypatch, tmp_path):
    """Editing a header in ``csrc`` renames every source's library, so a
    stale build is never loaded; headers are not sources of their own."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert _build._target("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build._target("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build._target("k") not in (first, second)
    assert _build.sources() == ["k"]
