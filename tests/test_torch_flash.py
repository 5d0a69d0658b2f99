"""The port's flash-attention forward against the JAX package.

On the CPU the port's wrapper runs its plain version (the f32 softmax);
the CUDA kernel is held against that version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``. Here the plain version
meets the JAX package's Pallas kernel in interpret mode, as
tests/test_kernels.py runs it, on the same numpy inputs. Tolerances: f32
rtol 1e-4, atol 1e-5 for out and lse (the JAX test's); bf16 5e-2 (the
Pallas kernel rounds p to bf16 before p . v, the plain version does not;
the JAX bf16 test's tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import FLASH_SWEEP

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention, ops


def _inputs(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", FLASH_SWEEP)
def test_flash_attention_matches_pallas(b, sq, sk, h, kv, hd, causal):
    q, k, v = _inputs(sq + sk + hd, ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, backend="pallas", block_q=64, block_k=64)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.shape == (b, sq, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal,seq_k", [(True, 128), (False, 128), (False, 100)])
def test_flash_attention_lse_matches_pallas(causal, seq_k):
    """The reference kernel's flattened layout, q (B*H, Sq, d) with group 2
    q heads a kv head, is a view of the port's head-major one."""
    bkv, group, sq, sk, d = 3, 2, 128, 128, 64
    q, k, v = _inputs(7, ((bkv * group, sq, d), (bkv, sk, d), (bkv, sk, d)))
    want, want_lse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, block_q=64,
        block_k=64, group=group, interpret=True, seq_k=seq_k)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention.flash_attention(
        qt.view(bkv, group, sq, d), kt.view(bkv, 1, sk, d), vt.view(bkv, 1, sk, d),
        causal=causal, seq_k=seq_k)
    np.testing.assert_allclose(out.reshape(bkv * group, sq, d).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lse.reshape(bkv * group, sq).numpy(), np.asarray(want_lse),
                               rtol=1e-4, atol=1e-5)


def test_flash_attention_bf16_matches_pallas():
    q, k, v = _inputs(11, ((2, 128, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64)))
    want = jops.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                backend="pallas")
    got = ops.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_flash_attention_refuses_a_device_without_a_kernel():
    q = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention.flash_attention(q, q[:, :1], q[:, :1])
