"""Shared setup for the PyTorch port's parity tests (tests/test_torch_*.py).

One small decoder, configured twice (JAX reference, PyTorch port) with
the same shape, f32 compute. Weights are made once by the reference and
cross to the port only through ``np.asarray`` -> ``from_jax_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

SHAPE = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq=128)
EOS = 3


def configs(**kw):
    """(reference config, port config) of the same small decoder."""
    shape = {**SHAPE, **kw}
    return (
        JT.TransformerConfig(**shape, compute_dtype=jnp.float32),
        T.TransformerConfig(**shape, compute_dtype=torch.float32),
    )


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def params_pair(jcfg, tcfg, seed=0, transform=None):
    """Reference params (optionally passed through ``transform``, e.g.
    ``quantize_decoder``) and their port copy on the CPU."""
    jp = JT.init_params(jax.random.key(seed), jcfg)
    if transform is not None:
        jp = transform(jp)
    return jp, convert.from_jax_numpy(to_numpy(jp), tcfg, device="cpu")


def tokens(shape, seed=0, vocab=SHAPE["vocab"]):
    return np.random.RandomState(seed).randint(0, vocab, size=shape).astype(np.int32)


def cache_to_numpy(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


def assert_cache_close(tcache, jcache, atol=1e-5):
    """Port cache (torch) vs reference cache (jax): same keys, int8 parts
    within one quantization step, the rest within ``atol``."""
    assert set(tcache) == set(jcache)
    for key, jv in cache_to_numpy(jcache).items():
        tv = tcache[key].numpy()
        assert tv.shape == jv.shape, key
        if jv.dtype == np.int8:
            assert np.abs(tv.astype(np.int32) - jv.astype(np.int32)).max() <= 1, key
        else:
            np.testing.assert_allclose(tv, jv, atol=atol, rtol=0, err_msg=key)
