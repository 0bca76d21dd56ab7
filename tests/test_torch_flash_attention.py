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
apart.

The split backward (the dq pass and the dk/dv pass that the JAX package
runs past `_FUSED_BWD_CAP`) is held by its plain versions against the
JAX `_bwd_impl` with the cap shrunk to 1, at the same tolerances."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jfa
from apex_tpu.ops.flash_attention import attention_reference as jax_reference
from apex_tpu.ops.flash_attention import flash_attention as jax_flash
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.ops.flash_attention import attention_reference
from apex_tpu_torch.ops.fused_dense import qkv_split_heads

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


def test_dropout_without_a_key_raises_as_jax():
    """Fault 5: `flash_attention` with dropout_rate > 0 and no key raises
    the JAX package's message, on the CPU as on the card (before the
    device dispatch), for the same inputs handed to both packages."""
    q, k, v, _ = _inputs(1, 2, 16, 64, seed=11)
    with pytest.raises(ValueError, match="dropout_rate > 0 requires "
                                         "dropout_key") as jerr:
        jax_flash(*(jnp.asarray(x) for x in (q, k, v)), dropout_rate=0.5)
    with pytest.raises(ValueError, match="dropout_rate > 0 requires "
                                         "dropout_key") as terr:
        tfa.flash_attention(*(torch.tensor(x) for x in (q, k, v)),
                            dropout_rate=0.5)
    assert str(terr.value) == str(jerr.value)
    # and before any device check: meta tensors are neither CPU nor CUDA
    with pytest.raises(ValueError, match="requires dropout_key"):
        tfa.flash_attention(*(torch.empty(1, 2, 16, 64, device="meta"),) * 3,
                            dropout_rate=0.5)


def test_keyless_reference_applies_no_dropout():
    """Fault 5: `attention_reference` with a rate but no key applies no
    dropout, as the JAX one does (its `_common.dropout` returns x without a
    key): fp32 at (1, 2, 16, 64) to 1e-5, and the same across two calls."""
    q, k, v, _ = _inputs(1, 2, 16, 64, seed=12)
    want = jax_reference(*(jnp.asarray(x) for x in (q, k, v)),
                         dropout_rate=0.5)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    got = attention_reference(tq, tk, tv, dropout_rate=0.5)
    again = attention_reference(tq, tk, tv, dropout_rate=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert torch.equal(got, again)
    np.testing.assert_allclose(
        got.numpy(), attention_reference(tq, tk, tv).numpy(), atol=0, rtol=0)


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
    # the split backward's launchers refuse, before any launch: fp32, a
    # head_dim of 96, segment ids that do not match, and CPU tensors
    lse = torch.zeros(1, 2, 8)
    for fn in (tfa.flash_bwd_dq_cuda, tfa.flash_bwd_dkv_cuda):
        n = fn.launches
        with pytest.raises(NotImplementedError, match="bfloat16"):
            fn(x32, x32, x32, x32, lse, lse, 0.125, True)
        x96 = torch.zeros(1, 2, 8, 96, dtype=torch.bfloat16)
        with pytest.raises(NotImplementedError, match="head_dim"):
            fn(x96, x96, x96, x96, lse, lse, 0.125, True)
        xb = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
        seg = torch.zeros(1, 8, dtype=torch.int32)
        with pytest.raises(ValueError, match="go together"):
            fn(xb, xb, xb, xb, lse, lse, 0.125, True, seg, None)
        with pytest.raises(ValueError, match="kv_seg must be"):
            fn(xb, xb, xb, xb, lse, lse, 0.125, True, seg,
               torch.zeros(1, 7, dtype=torch.int32))
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(xb, xb, xb, xb, lse, lse, 0.125, True, seg, seg)
        assert fn.launches == n


def test_backward_route_is_the_jax_rule():
    """The port's cap is the JAX constant, and the route splits exactly
    where `_bwd_impl` does: past sk * d = 256k."""
    assert tfa._FUSED_BWD_CAP == jfa._FUSED_BWD_CAP == 256 * 1024
    for sk, d in ((4096, 64), (2048, 128), (1024, 64), (1, 64)):
        assert tfa.backward_route(sk, d) == "fused", (sk, d)
    for sk, d in ((4160, 64), (2112, 128), (32768, 64), (8192, 64)):
        assert tfa.backward_route(sk, d) == "split", (sk, d)


def _jax_split_backward(monkeypatch, q, k, v, do, causal, jdt, seg=None):
    """The JAX forward (o, lse) and its two-kernel backward (the Pallas
    `_bwd_dq_kernel` and `_bwd_dkv_kernel` in interpret mode, 64 x 64
    blocks), forced by shrinking `_FUSED_BWD_CAP`, on numpy inputs."""
    monkeypatch.setattr(jfa, "_FUSED_BWD_CAP", 1)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    js = None if seg is None else jnp.asarray(seg)
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = jfa._fwd_impl(jq, jk, jv, scale, causal, block_q=64,
                           block_k=64, q_seg=js, kv_seg=js)
    dq, dk, dv, _ = jfa._bwd_impl(jq, jk, jv, o, lse, jdo, scale, causal,
                                  block_q=64, block_k=64, q_seg=js,
                                  kv_seg=js)
    delta = jnp.sum(jdo.astype(jnp.float32) * o.astype(jnp.float32), -1)
    return lse, delta, (dq, dk, dv)


def _port_split_backward(q, k, v, do, lse, delta, causal, tdt, seg=None):
    tq, tk, tv, tdo = (torch.tensor(x).to(tdt) for x in (q, k, v, do))
    tlse, tdelta = (torch.tensor(np.asarray(x)) for x in (lse, delta))
    ts = None if seg is None else torch.tensor(seg)
    args = (tq, tk, tv, tdo, tlse, tdelta, 1.0 / math.sqrt(q.shape[-1]),
            causal, ts, ts)
    dq = tfa.flash_bwd_dq_reference(*args)
    dk, dv = tfa.flash_bwd_dkv_reference(*args)
    return dq, dk, dv


@pytest.mark.parametrize("causal,dtype,d", [
    (True, "f32", 64), (False, "f32", 64), (True, "bf16", 64),
    (False, "bf16", 64), (True, "bf16", 128)])
def test_split_backward_matches_jax_kernels(monkeypatch, causal, dtype, d):
    """dq from `flash_bwd_dq_reference` and dk, dv from
    `flash_bwd_dkv_reference` against the JAX `_bwd_dq_kernel` /
    `_bwd_dkv_kernel` on the same q, k, v, do and the JAX forward's lse
    and delta, (1, 2, 256, d): four 64-row blocks each way."""
    q, k, v, do = _inputs(1, 2, 256, d, seed=40 + causal + d)
    jdt, tdt = _DTYPES[dtype]
    lse, delta, want = _jax_split_backward(monkeypatch, q, k, v, do, causal,
                                           jdt)
    got = _port_split_backward(q, k, v, do, lse, delta, causal, tdt)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == tdt, what
        _close(g, w, dtype, what)


@pytest.mark.parametrize("causal,dtype", [(False, "f32"), (True, "bf16")])
def test_split_backward_with_padding_matches_jax_kernels(monkeypatch, causal,
                                                         dtype):
    """BERT's padding as segment ids (256, 100 and 0 real tokens: the
    last sequence is padding from end to end, so its pads see only each
    other), the two passes against the JAX split kernels."""
    q, k, v, do = _inputs(3, 2, 256, 64, seed=50 + causal)
    seg = _pad_segments(3, 256, [256, 100, 0])
    jdt, tdt = _DTYPES[dtype]
    lse, delta, want = _jax_split_backward(monkeypatch, q, k, v, do, causal,
                                           jdt, seg)
    got = _port_split_backward(q, k, v, do, lse, delta, causal, tdt, seg)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        _close(g, w, dtype, what)


@pytest.mark.parametrize("causal", [False, True])
def test_split_backward_fully_masked_rows(causal):
    """Queries whose id no visible key carries: the plain passes give
    `attention_reference`'s gradient (uniform p = 1/sk into dv, ds = 0,
    so dq = 0 on those rows), fp32 against autograd through the JAX
    `attention_reference`.  (The JAX Pallas kernels take p = exp(0) = 1
    there and keep its ds, which that gradient does not.)"""
    b, h, s, d = 2, 2, 128, 64
    q, k, v, do = _inputs(b, h, s, d, seed=60 + causal)
    rng = np.random.RandomState(61)
    qseg = rng.randint(0, 4, (b, s)).astype(np.int32)
    kvseg = rng.randint(0, 3, (b, s)).astype(np.int32)  # id 3: no key
    scale = 1.0 / math.sqrt(d)

    def jf(q_, k_, v_):
        return jax_reference(q_, k_, v_, causal=causal, softmax_scale=scale,
                             q_segment_ids=jnp.asarray(qseg),
                             kv_segment_ids=jnp.asarray(kvseg))

    jo, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    # the forward's lse as the kernels keep it: -1e30 on dead rows
    sc = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    keep = qseg[:, None, :, None] == kvseg[:, None, None, :]
    if causal:
        keep = keep & np.tril(np.ones((s, s), bool))
    lse = np.asarray(jax.nn.logsumexp(jnp.where(keep, sc, -1e30), -1))
    dead = ~keep.any(-1)                                   # (b, 1, s)
    assert dead.any() and (lse[np.broadcast_to(dead, lse.shape)]
                           < -1e29).all()
    delta = np.sum(do * np.asarray(jo), -1)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    args = (tq, tk, tv, tdo, torch.tensor(lse), torch.tensor(delta), scale,
            causal, torch.tensor(qseg), torch.tensor(kvseg))
    got = (tfa.flash_bwd_dq_reference(*args),
           *tfa.flash_bwd_dkv_reference(*args))
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), what
        _close(g, w, "f32", what)
    assert torch.all(got[0][torch.tensor(dead)[:, :, :, None]
                            .expand(b, h, s, d)] == 0)


def test_flash_fn_backward_follows_the_route(monkeypatch):
    """`_FlashFn.backward` runs the fused launcher at sk * d = 256k and
    the dq and dk/dv launchers one key past it, and nothing else: the
    launchers are replaced by counting stand-ins that run the plain
    versions on these CPU tensors."""
    calls = []

    def fwd(q, k, v, scale, causal, q_seg, kv_seg):
        sc = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        return (attention_reference(q, k, v, softmax_scale=scale),
                torch.logsumexp(sc, -1))

    def dq_pass(*args):
        calls.append("dq")
        return tfa.flash_bwd_dq_reference(*args)

    def dkv_pass(*args):
        calls.append("dkv")
        return tfa.flash_bwd_dkv_reference(*args)

    def fused(*args):
        calls.append("fused")
        return (tfa.flash_bwd_dq_reference(*args),
                *tfa.flash_bwd_dkv_reference(*args))

    for name, fn in (("flash_fwd_cuda", fwd), ("flash_bwd_cuda", fused),
                     ("flash_bwd_dq_cuda", dq_pass),
                     ("flash_bwd_dkv_cuda", dkv_pass)):
        monkeypatch.setattr(tfa, name, fn)
    for sk, route in ((4096, ["fused"]), (4160, ["dq", "dkv"])):
        calls.clear()
        q, k, v = (torch.randn(1, 1, n, 64, generator=torch.Generator()
                               .manual_seed(sk + i)).requires_grad_(True)
                   for i, n in enumerate((64, sk, sk)))
        out = tfa._FlashFn.apply(q, k, v, 0.125, False, None, None, 1)
        out.backward(torch.ones_like(out))
        assert calls == route, (sk, calls)
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        attention_reference(qr, kr, vr, softmax_scale=0.125).backward(
            torch.ones_like(out))
        for got, want in ((q.grad, qr.grad), (k.grad, kr.grad),
                          (v.grad, vr.grad)):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ----------------------------- head packing ---------------------------------

@functools.lru_cache(maxsize=None)
def _jax_packed(causal, seg):
    """The JAX packed kernels (`_fwd_kernel_packed`, and
    `_bwd_fused_kernel_packed` for the backward) in interpret mode at
    heads_per_step=2, 32 x 32 blocks, (2, 4, 64, 16) fp32: o and dq, dk,
    dv for do = the seeded cotangent, as numpy."""
    b, h, s, d = 2, 4, 64, 16
    q, k, v, do = _inputs(b, h, s, d, seed=40 + 2 * causal + seg)
    ids = _pad_segments(b, s, [64, 23]) if seg else None

    def jf(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=causal,
                         segment_ids=None if ids is None else jnp.asarray(ids),
                         block_q=32, block_k=32, heads_per_step=2,
                         use_pallas_override=True)

    jo, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return (q, k, v, do, ids), [np.asarray(x) for x in (jo, *grads)]


@pytest.mark.parametrize("hp", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seg", [False, True])
def test_packed_heads_match_jax_packed_kernels(hp, causal, seg):
    """The port's flash attention at heads_per_step hp (on the CPU: the
    plain version, the packed route's plain version) against the JAX
    packed kernels, forward and gradients, fp32 within 1e-5 (about 10x
    the measured difference; the two compute fp32 scores in different
    orders)."""
    (q, k, v, do, ids), want = _jax_packed(causal, seg)
    tq, tk, tv = (torch.tensor(x).requires_grad_(True) for x in (q, k, v))
    to = tfa.flash_attention(
        tq, tk, tv, causal=causal, heads_per_step=hp,
        segment_ids=None if ids is None else torch.tensor(ids))
    to.backward(torch.tensor(do))
    for got, w, what in zip((to.detach(), tq.grad, tk.grad, tv.grad), want,
                            ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=0,
                                   err_msg=f"{what} hp={hp}")


def test_flash_fn_takes_the_packed_kernels_by_the_route(monkeypatch):
    """`_FlashFn` with hp > 1 launches the packed forward, and its
    backward follows `backward_route(sk, d, hp)`: the packed fused
    kernel at hp * sk * d <= 512k, the unpacked fused kernel past it
    (hp 16 at sk 1024), the split pair past sk * d = 256k; hp = 1 never
    reaches a packed launcher.  Counting stand-ins run the plain
    versions on these CPU tensors, and the gradients match autograd
    through `attention_reference`."""
    calls = []

    def plain_fwd(q, k, v, scale):
        sc = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        return (attention_reference(q, k, v, softmax_scale=scale),
                torch.logsumexp(sc, -1))

    def fwd(q, k, v, scale, causal, q_seg, kv_seg):
        calls.append("fwd")
        return plain_fwd(q, k, v, scale)

    def fwd_packed(q, k, v, scale, causal, hp, q_seg, kv_seg):
        calls.append(f"fwd_packed{hp}")
        return plain_fwd(q, k, v, scale)

    def fused(*args):
        calls.append("fused")
        return (tfa.flash_bwd_dq_reference(*args),
                *tfa.flash_bwd_dkv_reference(*args))

    def packed(q, k, v, do, lse, delta, scale, causal, hp, q_seg, kv_seg):
        calls.append(f"packed{hp}")
        args = (q, k, v, do, lse, delta, scale, causal, q_seg, kv_seg)
        return (tfa.flash_bwd_dq_reference(*args),
                *tfa.flash_bwd_dkv_reference(*args))

    for name, fn in (("flash_fwd_cuda", fwd),
                     ("flash_fwd_packed_cuda", fwd_packed),
                     ("flash_bwd_cuda", fused),
                     ("flash_bwd_packed_cuda", packed),
                     ("flash_bwd_dq_cuda",
                      lambda *a: calls.append("dq")
                      or tfa.flash_bwd_dq_reference(*a)),
                     ("flash_bwd_dkv_cuda",
                      lambda *a: calls.append("dkv")
                      or tfa.flash_bwd_dkv_reference(*a))):
        monkeypatch.setattr(tfa, name, fn)
    for h, hp, sk, route in (
            (4, 2, 1024, ["fwd_packed2", "packed2"]),
            (16, 16, 1024, ["fwd_packed16", "fused"]),
            (16, 8, 1024, ["fwd_packed8", "packed8"]),
            (2, 2, 4160, ["fwd_packed2", "dq", "dkv"]),
            (2, 1, 1024, ["fwd", "fused"])):
        calls.clear()
        q, k, v = (torch.randn(1, h, n, 64, generator=torch.Generator()
                               .manual_seed(sk + hp + i)).requires_grad_(True)
                   for i, n in enumerate((64, sk, sk)))
        out = tfa._FlashFn.apply(q, k, v, 0.125, False, None, None, hp)
        out.backward(torch.ones_like(out))
        assert calls == route, (h, hp, sk, calls)
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        attention_reference(qr, kr, vr, softmax_scale=0.125).backward(
            torch.ones_like(out))
        for got, want in ((q.grad, qr.grad), (k.grad, kr.grad),
                          (v.grad, vr.grad)):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_packed_launchers_refuse_before_launching():
    """What the packed launchers refuse, before any launch: a
    heads_per_step that does not divide h (or is not a positive int),
    fp32, and CPU tensors."""
    xb = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 8)
    n = (tfa.flash_fwd_packed_cuda.launches,
         tfa.flash_bwd_packed_cuda.launches)
    for hp in (3, 0, 8, 2.0):
        with pytest.raises(ValueError, match="divides num_heads=4"):
            tfa.flash_fwd_packed_cuda(xb, xb, xb, 0.125, True, hp)
        with pytest.raises(ValueError, match="divides num_heads=4"):
            tfa.flash_bwd_packed_cuda(xb, xb, xb, xb, lse, lse, 0.125, True,
                                      hp)
    x32 = torch.zeros(1, 4, 8, 64)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tfa.flash_fwd_packed_cuda(x32, x32, x32, 0.125, True, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_fwd_packed_cuda(xb, xb, xb, 0.125, True, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_bwd_packed_cuda(xb, xb, xb, xb, lse, lse, 0.125, True, 2)
    assert (tfa.flash_fwd_packed_cuda.launches,
            tfa.flash_bwd_packed_cuda.launches) == n


def _operand_cases():
    qkv = torch.zeros(16, 2, 3 * 4 * 64, dtype=torch.bfloat16)
    q, _, _ = qkv_split_heads(qkv, 4, 64)
    base = torch.zeros(2, 1, 16, 64, dtype=torch.bfloat16)
    flat = torch.zeros(2 * 4 * 16 * 64 + 1, dtype=torch.bfloat16)
    return [
        ("packed qkv view", q, False),
        ("heads broadcast by expand", base.expand(2, 4, 16, 64), True),
        ("a stride of 0 on an extent of 1",
         torch.zeros(1, 4, 16, 64, dtype=torch.bfloat16).as_strided(
             (1, 4, 16, 64), (0, 1024, 64, 1)), False),
        ("base one element off 16 bytes",
         flat[1:].view(2, 4, 16, 64), True),
        ("d not contiguous",
         torch.zeros(2, 4, 64, 16, dtype=torch.bfloat16).transpose(2, 3),
         True),
        # the training step's output gradient: (s, b, h, d) permuted
        ("do as the step passes it",
         torch.zeros(16, 2, 4, 64, dtype=torch.bfloat16).permute(1, 2, 0, 3),
         False),
    ]


@pytest.mark.parametrize("case", range(6))
def test_kernel_operand_keeps_what_tma_reads(case):
    """`_kernel_operand` passes a view through unchanged where a TMA tensor
    map can read it (last dim contiguous, 16-byte aligned base and
    strides, no stride of 0 across more than one row), and makes one
    contiguous copy otherwise; the values are the same either way."""
    name, t, copied = _operand_cases()[case]
    got = tfa._kernel_operand(t)
    assert (got.data_ptr() != t.data_ptr()) == copied, name
    assert torch.equal(got, t), name
    if copied:
        assert got.is_contiguous(), name


@pytest.mark.parametrize("err,match", [
    (0, None), (1, "CUDA error 1"), (100000 + 1, "TMA tensor map, CUresult 1"),
    (100000 + 500, "CUresult 500")])
def test_forward_launch_errors_are_named(err, match):
    """A forward launcher's error code: 0 is a launch; a driver refusal of
    a tensor map (csrc/hopper.cuh kTensorMapError + the CUresult) and a
    CUDA error raise, each named."""
    if match is None:
        tfa._raise_launch_error(err, "forward")
        return
    with pytest.raises(RuntimeError, match=match):
        tfa._raise_launch_error(err, "forward")


class _StandInLib:
    """A flash library whose every launcher returns `err`."""

    def __init__(self, err):
        self.err = err

    def __getattr__(self, name):
        return lambda *args: self.err


_BWD_LAUNCHERS = {
    "backward": lambda a: tfa.flash_bwd_cuda(*a),
    "packed backward": lambda a: tfa.flash_bwd_packed_cuda(*a, 2),
    "dq pass": lambda a: tfa.flash_bwd_dq_cuda(*a),
    "dk/dv pass": lambda a: tfa.flash_bwd_dkv_cuda(*a),
}
_BWD_COUNTERS = {"backward": tfa.flash_bwd_cuda,
                 "packed backward": tfa.flash_bwd_packed_cuda,
                 "dq pass": tfa.flash_bwd_dq_cuda,
                 "dk/dv pass": tfa.flash_bwd_dkv_cuda}


@pytest.mark.parametrize("err,match", [
    (1, "launch failed: CUDA error 1"),
    (100000 + 1, "refused a TMA tensor map, CUresult 1")])
@pytest.mark.parametrize("what", sorted(_BWD_LAUNCHERS))
def test_backward_launch_errors_are_named(monkeypatch, what, err, match):
    """Each backward launcher raises the forward's named error for its C
    function's return code (a CUDA error, or a tensor map the CUDA driver
    refused), with the library stood in and the device checks passed on
    the CPU, and counts no launch."""
    monkeypatch.setattr(tfa, "_LIB", _StandInLib(err))
    monkeypatch.setattr(tfa, "_require_cuda", lambda *ts: None)
    monkeypatch.setattr(tfa.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    x = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8)
    fn = _BWD_COUNTERS[what]
    n = fn.launches
    with pytest.raises(RuntimeError, match=f"flash attention {what}.*{match}"):
        _BWD_LAUNCHERS[what]((x, x, x, x, lse, lse, 0.125, True))
    assert fn.launches == n
    # 0 is a launch: counted once
    monkeypatch.setattr(tfa, "_LIB", _StandInLib(0))
    _BWD_LAUNCHERS[what]((x, x, x, x, lse, lse, 0.125, True))
    assert fn.launches == n + 1
    fn.launches = n


def test_bindings_match_the_c_signatures():
    """`_bind` declares, for every function that csrc/flash_attention.cu
    exports, as many arguments as its C signature has (read from the
    source): a parameter added on one side only would shift every
    argument after it."""
    import os
    import re
    from types import SimpleNamespace

    from apex_tpu_torch import csrc

    with open(os.path.join(csrc._DIR, "flash_attention.cu")) as f:
        src = f.read()
    sigs = {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert len(sigs) == 8, sorted(sigs)

    class Lib(SimpleNamespace):
        def __getattr__(self, name):
            fn = SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = tfa._bind(Lib())
    for name, n in sigs.items():
        assert len(getattr(lib, name).argtypes) == n, name


def _c_params(name):
    """The parameter names of csrc/flash_attention.cu's `extern "C"`
    function `name`, in order."""
    import os
    import re

    from apex_tpu_torch import csrc

    with open(os.path.join(csrc._DIR, "flash_attention.cu")) as f:
        src = f.read()
    m = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', src)
    return [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]


@pytest.mark.parametrize("seg", [False, True])
def test_dq_launcher_passes_the_c_arguments_in_order(monkeypatch, seg):
    """`flash_bwd_dq_cuda` hands `apex_flash_attn_bwd_dq` each argument in
    the place the C signature declares it (parameter names read from the
    .cu): the operands' and dq's addresses, the zeroed int32 work-item
    counter after dq, the 12 (batch, head, seq) strides of q, k, v and do,
    the shape, scale, causal, the segment ids and the stream — with the
    library stood in and the device checks passed on the CPU.  The dq
    pass's shared-memory query takes (head_dim, seg)."""
    calls = []

    class Lib:
        def apex_flash_attn_bwd_dq(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(tfa, "_LIB", Lib())
    monkeypatch.setattr(tfa, "_require_cuda", lambda *ts: None)
    monkeypatch.setattr(tfa.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 77}))
    b, h, sq, sk, d = 2, 3, 40, 24, 64
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn(b, h, sq, d, generator=g).to(torch.bfloat16)
             for _ in range(2))
    # k a strided view: its strides reach the C side as they are
    k = torch.randn(b, sk, h, d, generator=g).to(torch.bfloat16).transpose(
        1, 2)
    v = torch.randn(b, h, sk, d, generator=g).to(torch.bfloat16)
    lse, delta = torch.zeros(b, h, sq), torch.ones(b, h, sq)
    ids = ((torch.zeros(b, sq, dtype=torch.int32),
            torch.ones(b, sk, dtype=torch.int32)) if seg else (None, None))
    n = tfa.flash_bwd_dq_cuda.launches
    dq = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, 0.125, True, *ids)
    tfa.flash_bwd_dq_cuda.launches = n
    (args,) = calls
    params = _c_params("apex_flash_attn_bwd_dq")
    assert len(args) == len(params)
    got = dict(zip(params, args))
    assert (got["head_dim"], got["b"], got["h"], got["sq"], got["sk"]) == (
        d, b, h, sq, sk)
    assert got["scale"] == 0.125 and got["causal"] == 1
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", do),
                    ("lse", lse), ("delta", delta), ("dq", dq)):
        assert got[name] == t.data_ptr(), name
    assert dq.shape == (b, h, sq, d) and dq.dtype == torch.bfloat16
    assert isinstance(got["work"], int) and got["work"] not in (
        got["dq"], got["q"])
    assert list(got["strides"]) == [s_ for t in (q, k, v, do)
                                    for s_ in t.stride()[:3]]
    assert got["stream"] == 77
    if seg:
        assert got["q_seg"] == ids[0].data_ptr()
        assert got["kv_seg"] == ids[1].data_ptr()
        assert (got["q_seg_sb"], got["kv_seg_sb"]) == (sq, sk)
    else:
        assert got["q_seg"] is None and got["kv_seg"] is None
    assert _c_params("apex_flash_attn_bwd_dq_smem") == ["head_dim", "seg"]
