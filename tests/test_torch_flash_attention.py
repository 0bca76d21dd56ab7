"""The PyTorch port's flash attention (apex_tpu_torch.ops.flash_attention)
against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(`use_pallas_override=True`: `_fwd_kernel` forward, `_bwd_fused_kernel`
backward); the port's side runs its plain PyTorch version (what a CPU
tensor gets) and takes dq, dk, dv through torch.autograd.  The same
seeded numpy inputs go to both.

Tolerances.  fp32: 1e-5 absolute (about 10x the measured 1.1e-6) —
both sides compute fp32 scores and softmax, in different orders.  bf16:
1e-2 of the largest magnitude of each output (about 2x the measured
4.6e-3) — the TPU kernel rounds p to bf16 before P.V and ds before its
products (the port's CUDA kernel does the same), while the plain
version keeps them fp32, so the two sit one or two bf16 roundings
apart."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.flash_attention import attention_reference as jax_reference
from apex_tpu.ops.flash_attention import flash_attention as jax_flash
from apex_tpu_torch.ops import flash_attention as tfa

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's plain versions on one CPU thread.  Once JAX has run
    in the process, torch's vector math (sqrt, exp, tanh) on an intra-op
    worker thread sometimes comes out at ~3e-4 relative error, in about
    one process in ten; the main thread always computes it in full."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, h, s, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(4)]


def _close(got, want, dtype, what):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, what
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=what)
    else:
        err = np.max(np.abs(got - want))
        assert err <= 1e-2 * np.max(np.abs(want)), (what, err)


@pytest.mark.parametrize("s,causal,dtype", [
    (128, True, "f32"), (128, False, "f32"), (128, True, "bf16"),
    (128, False, "bf16"), (256, True, "bf16")])
def test_forward_and_grads_match_jax_kernel(s, causal, dtype):
    b, h, d = 1, 1, 64
    q, k, v, do = _inputs(b, h, s, d, seed=s + causal)
    jdt, tdt = _DTYPES[dtype]
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)

    def jf(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=causal, softmax_scale=scale,
                         use_pallas_override=True)

    jo, vjp = jax.vjp(jf, jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)

    tq, tk, tv = (torch.tensor(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    to = tfa.flash_attention(tq, tk, tv, causal=causal, softmax_scale=scale)
    to.backward(torch.tensor(do).to(tdt))
    assert to.dtype == tdt
    _close(to.detach(), jo, dtype, "o")
    for got, want, what in ((tq.grad, jdq, "dq"), (tk.grad, jdk, "dk"),
                            (tv.grad, jdv, "dv")):
        _close(got, want, dtype, what)


def test_plain_version_matches_jax_reference_with_bias_and_segments():
    """The plain version takes the whole surface on the CPU: an additive
    bias, segment ids and causal masking together, fp32 to 1e-5."""
    b, h, s, d = 2, 2, 32, 16
    q, k, v, _ = _inputs(b, h, s, d, seed=3)
    rng = np.random.RandomState(4)
    bias = rng.randn(1, h, s, s).astype(np.float32)
    seg = np.sort(rng.randint(0, 3, (b, s)), axis=1).astype(np.int32)
    want = jax_reference(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                         bias=jnp.asarray(bias),
                         q_segment_ids=jnp.asarray(seg),
                         kv_segment_ids=jnp.asarray(seg))
    got = tfa.flash_attention(*(torch.tensor(x) for x in (q, k, v)),
                              causal=True, bias=torch.tensor(bias),
                              segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _pad_segments(b, s, lengths):
    """BERT's segment ids from a padding mask: 1 for the first
    `lengths[i]` tokens of row i, 0 for its pads."""
    return (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)


@pytest.mark.parametrize("causal,dtype", [
    (False, "f32"), (False, "bf16"), (True, "f32")])
def test_segment_ids_match_jax_kernel(causal, dtype):
    """Ragged padding as segment ids (128, 70 and 1 real tokens; causal
    composes after the segment mask), forward and gradients against the
    JAX Pallas kernels in interpret mode."""
    b, h, s, d = 3, 2, 128, 64
    q, k, v, do = _inputs(b, h, s, d, seed=20 + causal)
    seg = _pad_segments(b, s, [128, 70, 1])
    jdt, tdt = _DTYPES[dtype]
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)

    def jf(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=causal, softmax_scale=scale,
                         segment_ids=jnp.asarray(seg),
                         use_pallas_override=True)

    jo, vjp = jax.vjp(jf, jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)
    tq, tk, tv = (torch.tensor(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    to = tfa.flash_attention(tq, tk, tv, causal=causal, softmax_scale=scale,
                             segment_ids=torch.tensor(seg))
    to.backward(torch.tensor(do).to(tdt))
    _close(to.detach(), jo, dtype, "o")
    for got, want, what in ((tq.grad, jdq, "dq"), (tk.grad, jdk, "dk"),
                            (tv.grad, jdv, "dv")):
        _close(got, want, dtype, what)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_rows_match_jax(causal):
    """q_/kv_segment_ids set apart: queries whose id no key carries are
    fully masked and get uniform weights over every key (the finite
    -1e30 mask), with a zero gradient through their scores; forward and
    gradients, fp32, against the JAX `flash_attention` on the CPU (its
    reference path), and no NaN."""
    b, h, s, d = 2, 2, 64, 16
    q, k, v, do = _inputs(b, h, s, d, seed=30 + causal)
    rng = np.random.RandomState(31)
    qseg = rng.randint(0, 4, (b, s)).astype(np.int32)
    kvseg = rng.randint(0, 3, (b, s)).astype(np.int32)  # id 3: no key
    assert np.any(qseg == 3)

    def jf(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=causal,
                         q_segment_ids=jnp.asarray(qseg),
                         kv_segment_ids=jnp.asarray(kvseg))

    jo, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(x).requires_grad_(True) for x in (q, k, v))
    to = tfa.flash_attention(tq, tk, tv, causal=causal,
                             q_segment_ids=torch.tensor(qseg),
                             kv_segment_ids=torch.tensor(kvseg))
    to.backward(torch.tensor(do))
    dead = torch.tensor(qseg == 3)[:, None, :, None]
    want_dead = torch.tensor(v).mean(dim=2, keepdim=True)
    assert torch.allclose(torch.where(dead, to.detach(), want_dead),
                          want_dead.expand_as(to), atol=1e-6)
    for got, want, what in ((to.detach(), jo, "o"), (tq.grad, jgrads[0], "dq"),
                            (tk.grad, jgrads[1], "dk"),
                            (tv.grad, jgrads[2], "dv")):
        assert torch.isfinite(got).all(), what
        _close(got, want, "f32", what)
    assert torch.all(tq.grad.masked_select(dead) == 0)


def test_kernel_surface_and_dispatch():
    """What the CUDA kernels refuse (checked before any launch, so it is
    testable here), the argument checks shared with the JAX package, and
    dispatch by device: meta tensors are neither CPU nor CUDA."""
    before = (tfa.flash_fwd_cuda.launches, tfa.flash_bwd_cuda.launches)
    x32 = torch.zeros(1, 2, 8, 64)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tfa._check_kernel_inputs(x32, x32, x32)
    x = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim"):
        tfa._check_kernel_inputs(x, x, x)
    with pytest.raises(ValueError, match="dropout_rate"):
        tfa.flash_attention(x32, x32, x32, dropout_rate=1.0)
    with pytest.raises(ValueError, match="go together"):
        tfa.flash_attention(x32, x32, x32,
                            q_segment_ids=torch.zeros(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CPU"):
        tfa.flash_attention(*(torch.empty(1, 2, 8, 64, device="meta"),) * 3)
    # a CPU call never reaches a kernel
    tfa.flash_attention(x32, x32, x32, causal=True)
    assert (tfa.flash_fwd_cuda.launches,
            tfa.flash_bwd_cuda.launches) == before
