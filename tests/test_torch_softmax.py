"""The PyTorch port's scaled (masked, causal) softmax
(apex_tpu_torch.ops.softmax) and FusedScaleMaskSoftmax
(apex_tpu_torch.transformer.functional) against the JAX package's, on
the CPU.

The JAX side runs its Pallas kernels in interpret mode
(`use_pallas_override=True`, as tests/test_softmax.py does); the port's
side runs its plain PyTorch versions, which is what a CPU tensor gets,
through the same autograd structure as on the card (the forward saves
only y, the backward is the kernel's formula).  The same seeded numpy
inputs go to both.  Tolerances: fp32 rtol 1e-5 / atol 1e-6 (the same
fp32 formula, summed in other orders); bf16 at most one bf16 ulp of the
JAX value (both compute in fp32 and round once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import softmax as jsm
from apex_tpu.transformer.functional.fused_softmax import (
    AttnMaskType as JaxAttnMaskType)
from apex_tpu.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax as JaxFusedScaleMaskSoftmax)
from apex_tpu_torch.ops import softmax as sm
from apex_tpu_torch.transformer.functional import (AttnMaskType,
                                                   FusedScaleMaskSoftmax)

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, dtype, slack=0.0):
    got = got.detach().float().numpy()
    want = _np(want)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 + slack)
    else:
        # one bf16 ulp: 2^(e - 8) for want = m * 2^e, m in [0.5, 1)
        _, e = np.frexp(np.abs(want))
        ulp = np.ldexp(np.ones_like(want), e - 8)
        assert np.all(np.abs(got - want) <= ulp + slack), \
            np.max(np.abs(got - want))


def _run_both(kind, shape, mshape, dtype, seed, scale=0.125):
    """The forward and the input gradient (cotangent: seeded N(0, 1)) of
    one softmax form in both packages; returns (port y, port dx, jax y,
    jax dx)."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    mask = None if mshape is None else rng.rand(*mshape) < 0.3
    if kind == "causal":
        def jf(a):
            return jsm.scaled_upper_triang_masked_softmax(
                a, scale, use_pallas_override=True)

        def tf(a):
            return sm.scaled_upper_triang_masked_softmax(a, scale)
    elif kind == "masked":
        jm, tm = jnp.asarray(mask), torch.tensor(mask)

        def jf(a):
            return jsm.scaled_masked_softmax(a, jm, scale,
                                             use_pallas_override=True)

        def tf(a):
            return sm.scaled_masked_softmax(a, tm, scale)
    else:
        def jf(a):
            return jsm.scaled_softmax(a, scale, use_pallas_override=True)

        def tf(a):
            return sm.scaled_softmax(a, scale)
    jx = jnp.asarray(x).astype(jdt)
    jy, vjp = jax.vjp(jf, jx)
    (jdx,) = vjp(jnp.asarray(g).astype(jdt))
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    ty = tf(tx)
    ty.backward(torch.tensor(g).to(tdt))
    assert ty.dtype == tdt and tx.grad.dtype == tdt
    assert ty.shape == tx.shape
    return ty, tx.grad, jy, jdx


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind,shape,mshape", [
    ("plain", (2, 3, 8, 16), None),
    ("plain", (5, 7), None),
    ("plain", (3, 1), None),
    ("masked", (2, 3, 8, 16), (2, 1, 1, 16)),
    ("masked", (2, 3, 8, 16), (2, 1, 8, 16)),
    ("masked", (2, 3, 4, 5, 7), (2, 1, 4, 1, 7)),
    ("causal", (6, 16, 16), None),
    ("causal", (2, 3, 13, 13), None),
])
def test_softmax_matches_jax_pallas(kind, shape, mshape, dtype):
    """y and dx of every form against the JAX Pallas kernels (forward
    and custom-vjp backward).  fp32 end to end.  In bf16 the two y may
    round to neighbouring values, and dx is rounded from each side's own
    y, so the bf16 dx is held to the JAX formula on the port's own y
    instead (one bf16 ulp)."""
    ty, tdx, jy, jdx = _run_both(kind, shape, mshape, dtype, seed=3)
    _assert_close(ty, jy, dtype)
    if dtype == "f32":
        _assert_close(tdx, jdx, dtype)
        return
    rng = np.random.RandomState(3)
    rng.randn(*shape)
    g = rng.randn(*shape).astype(np.float32)
    sk = shape[-1]
    y2 = jnp.asarray(ty.detach().float().numpy()).astype(
        jnp.bfloat16).reshape(-1, sk)
    want = jsm._bwd_pallas(jnp.asarray(g).astype(jnp.bfloat16).reshape(
        -1, sk), y2, 0.125).reshape(shape)
    _assert_close(tdx, want, dtype, slack=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fully_masked_rows_are_uniform(dtype):
    """A row whose every key is masked gets -10000 everywhere and comes
    out uniform (not NaN), in both packages; its gradient is finite."""
    jdt, tdt = _DTYPES[dtype]
    x = np.random.RandomState(4).randn(2, 2, 3, 8).astype(np.float32)
    mask = np.zeros((2, 1, 1, 8), bool)
    mask[1] = True                                 # sequence 1: all pads
    mask[0, ..., 5:] = True
    ty = sm.scaled_masked_softmax(torch.tensor(x).to(tdt),
                                  torch.tensor(mask), 0.5)
    jy = jsm.scaled_masked_softmax(jnp.asarray(x).astype(jdt),
                                   jnp.asarray(mask), 0.5,
                                   use_pallas_override=True)
    np.testing.assert_array_equal(ty[1].float().numpy(), 1.0 / 8)
    np.testing.assert_array_equal(_np(jy)[1], 1.0 / 8)
    assert torch.all(ty[0, ..., 5:] == 0)
    _assert_close(ty, jy, dtype)
    tx = torch.tensor(x).requires_grad_(True)
    sm.scaled_masked_softmax(tx, torch.tensor(mask), 0.5).sum().backward()
    assert torch.isfinite(tx.grad).all()


def test_causal_refuses_sq_ne_sk():
    with pytest.raises(ValueError, match="sq == sk"):
        sm.scaled_upper_triang_masked_softmax(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="sq == sk"):
        jsm.scaled_upper_triang_masked_softmax(jnp.zeros((2, 3, 4)))


def test_forward_saves_only_y_and_skips_autograd_without_grad():
    """With a gradient the op is one autograd node holding y alone; under
    no_grad (or for an input that needs none) it is the forward alone."""
    x = torch.randn(2, 4, 4, requires_grad=True)
    y = sm.scaled_upper_triang_masked_softmax(x, 0.5)
    assert type(y.grad_fn).__name__ == "_SoftmaxFnBackward"
    (saved,) = y.grad_fn.saved_tensors
    assert torch.equal(saved, y)
    with torch.no_grad():
        assert sm.scaled_upper_triang_masked_softmax(x, 0.5).grad_fn is None
    assert sm.scaled_softmax(torch.randn(3, 5)).grad_fn is None


def test_mask_layout_addresses_the_broadcast_mask():
    """The kernel's view of a broadcast mask: for every row index r =
    (i0 * n1 + i1) * n2 + i2 and column c, the entry at offset
    i0·s0 + i1·s1 + i2·s2 + c·sc of the mask's storage is the broadcast
    mask's (r, c) entry — for masks that fold into three leading dims
    with nothing copied, and for one that does not (copied out)."""
    rng = np.random.RandomState(5)
    for shape, mshape, copied in (
            ((2, 3, 8, 16), (2, 1, 1, 16), False),   # BERT's padding mask
            ((2, 3, 8, 16), (2, 1, 8, 16), False),
            ((2, 3, 8, 16), (8, 16), False),
            ((6, 16, 16), (1, 16, 16), False),
            ((2, 3, 4, 5, 7), (2, 1, 4, 1, 7), True)):
        mask = torch.tensor(rng.rand(*mshape) < 0.5)
        m, n1, n2, s0, s1, s2, sc = sm._mask_layout(mask, shape)
        if not copied:
            assert m.untyped_storage().data_ptr() == \
                mask.untyped_storage().data_ptr()
        storage = torch.tensor(
            np.frombuffer(bytes(m.untyped_storage()), np.uint8))
        want = mask.expand(shape).reshape(-1, shape[-1])
        r = torch.arange(want.shape[0])[:, None]
        c = torch.arange(shape[-1])[None, :]
        i2, i1, i0 = r % n2, (r // n2) % n1, r // n2 // n1
        off = m.storage_offset() + i0 * s0 + i1 * s1 + i2 * s2 + c * sc
        assert torch.equal(storage[off] != 0, want)


def test_mask_must_broadcast():
    with pytest.raises(ValueError, match="broadcast"):
        sm._mask_layout(torch.zeros(3, 1, 1, 8, dtype=torch.bool),
                        (2, 3, 8, 8))


@pytest.mark.parametrize("rows,cols,want", [
    (196_608, 1024, (1024, 4, True, 8)),      # GPT-350M's scores
    (262_144, 512, (512, 8, True, 8)),        # BERT-Large's
    (10, 1, (16, 256, True, 8)),
    (3, 8192, (8192, 1, True, 16)),
    (3, 20000, (4096, 1, False, 8)),          # past the single-block cap
])
def test_launch_shape(rows, cols, want):
    block, per_prog, one, warps, grid = sm._launch_shape(rows, cols)
    assert (block, per_prog, one, warps) == want
    assert grid == (-(-rows // per_prog),)


@pytest.mark.parametrize("kind", ["causal", "padding", "no_mask"])
def test_fused_scale_mask_softmax_matches_jax(kind):
    """FusedScaleMaskSoftmax for each AttnMaskType: the causal type
    reshapes to (-1, sq, sk), a mask goes to the masked form and none to
    the plain one.  fp32: rtol 1e-5 / atol 1e-6."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    mask = rng.rand(2, 1, 1, 8) < 0.3 if kind == "padding" else None
    t = FusedScaleMaskSoftmax(AttnMaskType[kind], scale=0.5)
    j = JaxFusedScaleMaskSoftmax(JaxAttnMaskType[kind], scale=0.5)
    assert t.is_kernel_available(mask, 2, 3, 8, 8) is True
    got = t(torch.tensor(x), None if mask is None else torch.tensor(mask))
    want = j(jnp.asarray(x), None if mask is None else jnp.asarray(mask),
             use_pallas_override=True)
    _assert_close(got, want, "f32")
    assert not FusedScaleMaskSoftmax(
        scaled_masked_softmax_fusion=False).is_kernel_available(
            None, 2, 3, 8, 8)
    with pytest.raises(RuntimeError, match="fp32"):
        FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=2.0)


@pytest.mark.parametrize("sq,sk,b,nh", [(1024, 1024, 12, 16),
                                        (512, 512, 32, 16), (7, 9, 2, 3),
                                        (1, 20000, 1, 1)])
def test_get_batch_per_block_matches_jax(sq, sk, b, nh):
    assert sm.get_batch_per_block(sq, sk, b, nh) == \
        jsm.get_batch_per_block(sq, sk, b, nh)


def test_kernel_dispatch_refuses_mixed_devices():
    """A CPU tensor runs the plain version; tensors on two devices (here
    a CPU input and a meta mask) are refused, never quietly moved."""
    x = torch.randn(2, 4)
    torch.testing.assert_close(sm.softmax_fwd(x, None, 1.0, False),
                               torch.softmax(x, -1))
    with pytest.raises(ValueError, match="CPU"):
        sm.softmax_fwd(x, torch.zeros(2, 4, dtype=torch.bool,
                                      device="meta"), 1.0, False)
