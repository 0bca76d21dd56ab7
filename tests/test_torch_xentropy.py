"""The PyTorch port's label-smoothed softmax cross entropy
(apex_tpu_torch.ops.xentropy and the contrib.xentropy facade) against
the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(`use_pallas_override=True`, its custom_vjp `_xent`); the port's side
runs its plain versions through `_XentFn` (what CPU tensors get).  The
same seeded numpy logits and labels go to both.

Tolerances.  fp32 logits: loss and gradient rtol 1e-5 / atol 1e-6 (the
same formulas, the log-sum-exp reduced in another order).  bf16 logits:
the loss is fp32 from bf16 inputs, rtol 1e-5 / atol 1e-5; dx is rounded
once to bf16, so one bf16 ulp of the JAX value plus 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import xentropy as jax_contrib
from apex_tpu.ops import xentropy as JX
from apex_tpu_torch.contrib import xentropy as contrib
from apex_tpu_torch.ops import xentropy as X

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


def _case(seed, rows, v, scale=3.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, v) * scale).astype(np.float32)
    y = rng.randint(0, v, (rows,)).astype(np.int32)
    g = rng.randn(rows).astype(np.float32)
    return x, y, g


def _to(x, dt):
    """numpy fp32 → (jax array, torch tensor) in the dtype pair `dt`."""
    jdt, tdt = _DTYPES[dt]
    j = jnp.asarray(x).astype(jdt)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(tdt)


def _jax_loss_and_grad(jx, jy, jg, smoothing):
    def f(a):
        return JX.softmax_cross_entropy_loss(a, jy, smoothing,
                                             use_pallas_override=True)
    loss, vjp = jax.vjp(f, jx)
    return np.asarray(loss), np.asarray(vjp(jg)[0].astype(jnp.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("rows,v", [(16, 1000), (5, 37)])
def test_loss_and_grad_match_jax_pallas(rows, v, smoothing, dt):
    x, y, g = _case(rows + v, rows, v)
    jx, tx = _to(x, dt)
    want_loss, want_dx = _jax_loss_and_grad(jx, jnp.asarray(y),
                                            jnp.asarray(g), smoothing)
    tx.requires_grad_(True)
    loss = X.softmax_cross_entropy_loss(tx, torch.tensor(y), smoothing)
    loss.backward(torch.tensor(g))
    assert loss.dtype == torch.float32 and tx.grad.dtype == tx.dtype
    atol = 1e-6 if dt == "f32" else 1e-5
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, rtol=1e-5,
                               atol=atol)
    got_dx = tx.grad.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got_dx, want_dx, rtol=1e-5, atol=1e-6)
    else:
        _, e = np.frexp(np.abs(want_dx))
        ulp = np.ldexp(np.ones_like(want_dx), e - 8)
        assert np.all(np.abs(got_dx - want_dx) <= ulp + 1e-6)


def test_leading_dims_and_the_reference_agree():
    """(2, 3, V) logits give a (2, 3) loss; the differentiable reference
    and the autograd.Function give the same loss and gradient."""
    x, y, _ = _case(1, 6, 50)
    xt = torch.tensor(x.reshape(2, 3, 50), requires_grad=True)
    yt = torch.tensor(y.reshape(2, 3))
    loss = X.softmax_cross_entropy_loss(xt, yt, 0.1)
    assert loss.shape == (2, 3)
    (gx,) = torch.autograd.grad(loss.sum(), xt)
    xr = xt.detach().clone().requires_grad_(True)
    ref = X.softmax_cross_entropy_reference(xr, yt, 0.1)
    (gr,) = torch.autograd.grad(ref.sum(), xr)
    np.testing.assert_allclose(loss.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), gr.numpy(), rtol=1e-5, atol=1e-7)
    want = JX.softmax_cross_entropy_reference(jnp.asarray(x.reshape(2, 3, 50)),
                                              jnp.asarray(y.reshape(2, 3)),
                                              0.1)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_forward_saves_lse_and_backward_is_softmax_minus_q():
    """The plain forward's lse is the row log-sum-exp, and the backward is
    g·(softmax − q) with q = (1−ε)·onehot + ε/V."""
    x, y, g = _case(2, 4, 10)
    xt, yt, gt = torch.tensor(x), torch.tensor(y), torch.tensor(g)
    loss, lse = X.xent_fwd_reference(xt, yt, 0.2)
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(x).sum(1)),
                               rtol=1e-6)
    dx = X.xent_bwd_reference(gt, xt, yt, lse, 0.2)
    p = np.exp(x) / np.exp(x).sum(1, keepdims=True)
    q = 0.8 * np.eye(10)[y] + 0.02
    np.testing.assert_allclose(dx.numpy(), g[:, None] * (p - q), rtol=1e-5,
                               atol=1e-7)


def test_contrib_facade_is_the_op():
    """contrib.xentropy re-exports the op, as the JAX package's does."""
    assert contrib.SoftmaxCrossEntropyLoss is X.softmax_cross_entropy_loss
    assert contrib.softmax_cross_entropy_loss is X.softmax_cross_entropy_loss
    assert X.SoftmaxCrossEntropyLoss is X.softmax_cross_entropy_loss
    x, y, _ = _case(3, 8, 100)
    got = contrib.SoftmaxCrossEntropyLoss(torch.tensor(x), torch.tensor(y),
                                          0.1)
    want = jax_contrib.SoftmaxCrossEntropyLoss(jnp.asarray(x),
                                               jnp.asarray(y), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_kernel_wrappers_check_their_inputs():
    """The launch wrappers refuse what the kernels do not take, before
    any launch (here, on CPU tensors, before triton is imported)."""
    x = torch.zeros(4, 10)
    with pytest.raises(TypeError, match="int32"):
        X.xent_fwd_triton(x, torch.zeros(4, dtype=torch.int64), 0.0)
    with pytest.raises(ValueError, match="labels"):
        X.xent_fwd_triton(x, torch.zeros(3, dtype=torch.int32), 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        X.xent_fwd_triton(x.t(), torch.zeros(10, dtype=torch.int32), 0.0)
    with pytest.raises(TypeError, match="fp32"):
        X.xent_bwd_triton(torch.zeros(4, dtype=torch.bfloat16), x,
                          torch.zeros(4, dtype=torch.int32), torch.zeros(4),
                          0.0)
