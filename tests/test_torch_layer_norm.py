"""The PyTorch port's LayerNorm/RMSNorm (apex_tpu_torch.ops.layer_norm)
against the JAX package's, on the CPU.

The JAX side runs its Pallas forward kernel in interpret mode
(`use_pallas_override=True`, as tests/test_layer_norm.py does); the
port's side runs its plain PyTorch version, which is what a CPU tensor
gets.  The same seeded numpy inputs go to both.  Tolerances: fp32 atol
1e-5; bf16 at most one bf16 ulp of the JAX value (both compute fp32
statistics and round once, but sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.layer_norm import fused_layer_norm as jax_layer_norm
from apex_tpu.ops.layer_norm import fused_rms_norm as jax_rms_norm
from apex_tpu_torch.ops import layer_norm as tln

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rows, hidden, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, hidden) * 2 + 0.5).astype(np.float32)
    w = (rng.randn(hidden) * 0.5 + 1).astype(np.float32)
    b = (rng.randn(hidden) * 0.1).astype(np.float32)
    return x, w, b


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        # one bf16 ulp: 2^(e - 8) for want = m * 2^e, m in [0.5, 1)
        _, e = np.frexp(np.abs(want))
        ulp = np.ldexp(np.ones_like(want), e - 8)
        assert np.all(np.abs(got - want) <= ulp), np.max(
            np.abs(got - want) / ulp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hidden", [32, 1024])
@pytest.mark.parametrize("rows", [5, 64])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_norm_matches_jax_pallas(kind, affine, rows, hidden, dtype):
    x, w, b = _inputs(rows, hidden, seed=rows * 7 + hidden)
    jdt, tdt = _DTYPES[dtype]
    jx, tx = jnp.asarray(x).astype(jdt), torch.tensor(x).to(tdt)
    jw = jnp.asarray(w).astype(jdt) if affine else None
    tw = torch.tensor(w).to(tdt) if affine else None
    if kind == "layer":
        jb = jnp.asarray(b).astype(jdt) if affine else None
        tb = torch.tensor(b).to(tdt) if affine else None
        want = jax_layer_norm(jx, jw, jb, use_pallas_override=True)
        got = tln.fused_layer_norm(tx, tw, tb)
    else:
        want = jax_rms_norm(jx, jw, use_pallas_override=True)
        got = tln.fused_rms_norm(tx, tw)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    _assert_close(got, want, dtype)


def test_stats_are_centred_fp32():
    """mean/rstd come out fp32 per row; the variance is centred, so a
    large common offset does not cancel catastrophically."""
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 256) + 1e4).astype(np.float32)
    y, mean, rstd = tln.norm_fwd_reference(torch.tensor(x))
    assert mean.dtype == rstd.dtype == torch.float32
    assert tuple(mean.shape) == tuple(rstd.shape) == (4, 1)
    xd = x.astype(np.float64)
    np.testing.assert_allclose(mean.numpy()[:, 0], xd.mean(1), rtol=1e-6)
    np.testing.assert_allclose(rstd.numpy()[:, 0],
                               1 / np.sqrt(xd.var(1) + 1e-5), rtol=1e-3)
    _, rmean, _ = tln.norm_fwd_reference(torch.tensor(x), rms=True)
    assert torch.equal(rmean, torch.zeros(4, 1))


def test_modules_match_functions_and_stay_on_cpu():
    """FusedLayerNorm/FusedRMSNorm are nn.Modules over the functions; a
    CPU tensor never reaches the kernel (its launch count stays put)."""
    x = torch.tensor(np.random.RandomState(0).randn(3, 5, 16)
                     .astype(np.float32))
    before = tln.norm_fwd_triton.launches
    m = tln.FusedLayerNorm(16)
    assert [n for n, _ in m.named_parameters()] == ["weight", "bias"]
    torch.testing.assert_close(m(x), tln.layer_norm_reference(
        x, torch.ones(16), torch.zeros(16)), atol=0, rtol=0)
    r = tln.FusedRMSNorm(16, elementwise_affine=False)
    torch.testing.assert_close(r(x), tln.rms_norm_reference(x), atol=0,
                               rtol=0)
    y = tln.fused_layer_norm(x.requires_grad_(True))
    y.sum().backward()         # the plain version is differentiable
    assert x.grad is not None and x.grad.shape == x.shape
    assert tln.norm_fwd_triton.launches == before


def test_kernel_dispatch_refuses_other_devices():
    """Dispatch follows the tensor's device: CPU → plain, CUDA → kernel,
    anything else (here the meta device, or mixed devices) raises."""
    with pytest.raises(ValueError, match="CPU"):
        tln.fused_layer_norm(torch.empty(2, 8, device="meta"))
    with pytest.raises(ValueError, match="CPU"):
        tln.fused_layer_norm(torch.ones(2, 8),
                             torch.ones(8, device="meta"))


def _ulp_close(got, want, slack):
    """|got - want| <= one bf16 ulp of want + slack (fp32 differences
    from summing in another order, before the one rounding to bf16)."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    _, e = np.frexp(np.abs(want))
    ulp = np.ldexp(np.ones_like(want), e - 8)
    assert np.all(np.abs(got - want) <= ulp + slack), np.max(
        np.abs(got - want) - ulp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_backward_matches_jax_pallas(kind, dtype):
    """dx, dw (and db) through torch.autograd against jax.vjp of the JAX
    package's norm with its Pallas backward kernel in interpret mode.
    Tolerances: fp32 dx atol 1e-5, dw/db rtol 1e-5 over sums of 37
    rows; bf16 one bf16 ulp plus 1e-5 of slack for the fp32 sums."""
    rows, hidden = 37, 256
    x, w, b = _inputs(rows, hidden, seed=5)
    g = np.random.RandomState(6).randn(rows, hidden).astype(np.float32)
    jdt, tdt = _DTYPES[dtype]
    jx, jw, jb, jg = (jnp.asarray(a).astype(jdt) for a in (x, w, b, g))
    tx, tw, tb = (torch.tensor(a).to(tdt).requires_grad_(True)
                  for a in (x, w, b))
    if kind == "layer":
        _, vjp = jax.vjp(lambda x_, w_, b_: jax_layer_norm(
            x_, w_, b_, use_pallas_override=True), jx, jw, jb)
        want = vjp(jg)
        tln.fused_layer_norm(tx, tw, tb).backward(torch.tensor(g).to(tdt))
        got = (tx.grad, tw.grad, tb.grad)
    else:
        _, vjp = jax.vjp(lambda x_, w_: jax_rms_norm(
            x_, w_, use_pallas_override=True), jx, jw)
        want = vjp(jg)
        tln.fused_rms_norm(tx, tw).backward(torch.tensor(g).to(tdt))
        got = (tx.grad, tw.grad)
    for i, (gt, wt) in enumerate(zip(got, want)):
        assert gt.dtype == tdt
        if dtype == "bf16":
            _ulp_close(gt, wt, 1e-5 * float(jnp.max(jnp.abs(
                wt.astype(jnp.float32)))))
        elif i == 0:
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                       atol=1e-5, rtol=0)
        else:
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rms", [False, True])
def test_bwd_reference_is_the_gradient(rms):
    """`norm_bwd_reference` (the plain version the CUDA kernel is held
    against) is the gradient autograd takes through the plain forward:
    fp32, atol 1e-5; dw/db fp32 whatever the input dtype."""
    x, w, b = _inputs(19, 64, seed=8)
    g = torch.tensor(np.random.RandomState(9).randn(19, 64)
                     .astype(np.float32))
    tx, tw, tb = (torch.tensor(a).requires_grad_(True) for a in (x, w, b))
    y, mean, rstd = tln.norm_fwd_reference(tx, tw, None if rms else tb,
                                           rms=rms)
    y.backward(g)
    dx, dw, db = tln.norm_bwd_reference(g, tx.detach(), mean.detach(),
                                        rstd.detach(), tw.detach(), rms)
    torch.testing.assert_close(dx, tx.grad, atol=1e-5, rtol=0)
    torch.testing.assert_close(dw, tw.grad, atol=1e-5, rtol=1e-6)
    if not rms:
        torch.testing.assert_close(db, tb.grad, atol=1e-5, rtol=1e-6)
    _, dw_none, db_none = tln.norm_bwd_reference(g, tx.detach(), mean,
                                                 rstd, None, rms)
    assert dw_none is None and db_none is None
