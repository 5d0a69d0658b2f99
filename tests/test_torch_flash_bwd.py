"""The port's flash-attention backward against the JAX package, on the CPU.

``ops.flash_attention`` is differentiable through ``FlashAttention``; on
the CPU its backward is ``flash_attention_bwd_plain`` (the TPU kernels'
explicit formulas in f32), the same Function whose backward the card runs
as the dq and dk/dv kernels (held against the plain version there by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Here the gradients
of sum(sin(out)) meet ``jax.grad`` through the Pallas forward and backward
kernels in interpret mode, as tests/test_kernels.py runs them, on the
same numpy inputs. Tolerances: f32 rtol/atol 1e-4 (the JAX test's); bf16
6e-2 (the Pallas kernels round p and ds to bf16 before their products and
every gradient to bf16; the plain version rounds only the result; the
bf16 forward's tolerance is 5e-2 and the backward adds two products); the
plain backward against autograd through the f64 reference: rtol 1e-5,
atol 1e-5 (f32 arithmetic against f64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import FLASH_SWEEP

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention, ops, ref


def _inputs(seed, b, sq, sk, h, kv, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


def _jax_grads(q, k, v, causal, dtype=jnp.float32):
    def loss(q_, k_, v_):
        out = jops.flash_attention(q_, k_, v_, causal=causal, backend="pallas",
                                   block_q=64, block_k=64)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))
    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a, dtype) for a in (q, k, v)))


def _torch_grads(q, k, v, causal, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=causal)
    return torch.autograd.grad(out.float().sin().sum(), (q, k, v))


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", FLASH_SWEEP)
def test_flash_gradients_match_pallas(b, sq, sk, h, kv, hd, causal):
    q, k, v = _inputs(sq + sk + hd, b, sq, sk, h, kv, hd)
    want = _jax_grads(q, k, v, causal)
    got = _torch_grads(q, k, v, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


def test_flash_gradients_bf16_match_pallas():
    q, k, v = _inputs(11, 2, 128, 128, 4, 2, 64)
    want = _jax_grads(q, k, v, True, jnp.bfloat16)
    got = _torch_grads(q, k, v, True, torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=6e-2,
                                   atol=6e-2, err_msg=f"d{name}")


@pytest.mark.parametrize("causal,seq_k", [(True, None), (False, None), (False, 77)])
def test_plain_backward_matches_autograd_of_the_reference(causal, seq_k):
    """Explicit formulas against autograd through ``ref.flash_attention_ref``
    in f64, head-major views with GQA (8 q heads on 2 kv heads), do with a
    strided layout (the model's (B, S, H, d) memory)."""
    b, h, kv, sq, sk, d = 2, 8, 2, 80, 96, 32
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s)).transpose(1, 2)
                   for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d), (b, sq, h, d)))
    q64, k64, v64 = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = ref.flash_attention_ref(q64.reshape(b * h, sq, d), k64.reshape(b * kv, sk, d),
                                       v64.reshape(b * kv, sk, d), causal=causal,
                                       group=h // kv, seq_k=seq_k)
    want = torch.autograd.grad(out, (q64, k64, v64), do.reshape(b * h, sq, d))
    got = flash_attention.flash_attention_bwd_plain(
        q, k, v, out.detach().view(b, h, sq, d), lse.view(b, h, sq).float(), do, causal, seq_k)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float64, name
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=f"d{name}")
    if seq_k is not None:
        assert not got[1][:, :, seq_k:].any() and not got[2][:, :, seq_k:].any()


def test_flash_output_carries_the_function():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(1, 1, 16, 16, 2, 2, 32))
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn.next_functions[0][0].name() == "FlashAttentionBackward"
    with torch.inference_mode():
        assert ops.flash_attention(q, k, v).grad_fn is None


def test_flash_backward_refuses_a_device_without_a_kernel():
    q = torch.empty((1, 2, 8, 64), device="meta")
    lse = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention.flash_attention_bwd(q, q[:, :1], q[:, :1], q, lse, q)
