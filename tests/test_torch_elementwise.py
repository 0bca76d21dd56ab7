"""The PyTorch port's generic elementwise launcher
(apex_tpu_torch.ops.optimizer_kernels._elementwise_call) against the JAX
package's, on the CPU.

The JAX side runs its Pallas launcher in interpret mode
(`interpret_override=True`) over buffers it pads to (rows, 128) tiles;
the port's side runs the body's plain version (what CPU buffers get),
in place.  The same seeded numpy inputs go to both, at a ragged length.
Tolerance: 2 ulps of fp32 (rtol 2.4e-7), plus 2 ulps of the largest
operand (atol 1e-6 for these unit normals) where a result cancels — XLA's
CPU backend may contract a multiply and an add into one fma in the
interpret run, where PyTorch rounds twice."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import optimizer_kernels as jok
from apex_tpu_torch.ops import optimizer_kernels as tok

_N = 70_001          # past one (512, 128) tile, and not a multiple of it
_RTOL = 2.4e-7
_ATOL = 1e-6


def _buffers(k, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(_N).astype(np.float32) for _ in range(k)]


def _no_body():
    raise AssertionError("the Triton body is built only for CUDA buffers")


def test_one_output_body_matches_jax():
    """axpy: y <- y + a x, y updated in place."""
    y, x = _buffers(2, seed=1)

    def jbody(y_ref, x_ref, o_ref):
        o_ref[...] = y_ref[...] + 0.5 * x_ref[...]

    (want,) = jok._elementwise_call(jbody, [jnp.asarray(y), jnp.asarray(x)],
                                    1, interpret_override=True)
    kernel = tok.ElementwiseKernel(
        lambda y_, x_, _2, _3, a, *_: y_ + a * x_, _no_body, (0.5,))
    ty, tx = torch.tensor(y), torch.tensor(x)
    (got,) = tok._elementwise_call(kernel, [ty, tx], 1)
    assert got is ty and torch.equal(tx, torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(want), rtol=_RTOL,
                               atol=_ATOL)


def test_two_output_body_matches_jax():
    """Heavy-ball momentum: m <- b m + g, p <- p - lr m; p and m updated
    in place, g read only."""
    p, m, g = _buffers(3, seed=2)

    def jbody(p_ref, m_ref, g_ref, p_out, m_out):
        m_new = 0.9 * m_ref[...] + g_ref[...]
        m_out[...] = m_new
        p_out[...] = p_ref[...] - 0.125 * m_new

    def plain(p_, m_, g_, _3, b, lr, *_):
        m_new = b * m_ + g_
        return p_ - lr * m_new, m_new

    want = jok._elementwise_call(
        jbody, [jnp.asarray(p), jnp.asarray(m), jnp.asarray(g)], 2,
        interpret_override=True)
    tp, tm, tg = (torch.tensor(x) for x in (p, m, g))
    got = tok._elementwise_call(
        tok.ElementwiseKernel(plain, _no_body, (0.9, 0.125)), [tp, tm, tg], 2)
    assert got[0] is tp and got[1] is tm
    for t, w in zip((tp, tm), want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=_RTOL,
                                   atol=_ATOL)
    assert torch.equal(tg, torch.tensor(g))


def test_outputs_round_to_the_buffers_dtype():
    """A bf16 output buffer takes the fp32 result rounded to nearest-even,
    as the kernel's store rounds it."""
    y = torch.tensor([1.0, 2.0, 3.0], dtype=torch.bfloat16)
    x = torch.tensor([1e-3, 1e-2, 0.5])
    kernel = tok.ElementwiseKernel(
        lambda y_, x_, *_: y_.float() + x_, _no_body)
    tok._elementwise_call(kernel, [y, x], 1)
    want = (torch.tensor([1.0, 2.0, 3.0]) + x).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)


def test_contract_is_checked_before_anything_runs():
    a = torch.zeros(8)
    k = tok.ElementwiseKernel(lambda *xs: xs[0], _no_body)
    with pytest.raises(TypeError, match="ElementwiseKernel"):
        tok._elementwise_call(lambda r: r, [a], 1)
    with pytest.raises(ValueError, match="1..4 buffers"):
        tok._elementwise_call(k, [a] * 5, 1)
    with pytest.raises(ValueError, match="n_out=4"):
        tok._elementwise_call(k, [a] * 4, 4)
    with pytest.raises(ValueError, match="n_out=2"):
        tok._elementwise_call(k, [a], 2)
    with pytest.raises(ValueError, match="one length"):
        tok._elementwise_call(k, [a, torch.zeros(9)], 1)
    with pytest.raises(ValueError, match="one length"):
        tok._elementwise_call(k, [torch.zeros(4, 2)], 1)
    with pytest.raises(ValueError, match="at most 4 constants"):
        tok._elementwise_call(tok.ElementwiseKernel(k.plain, _no_body,
                                                    (1.0,) * 5), [a], 1)
    with pytest.raises(ValueError, match="returned 1 values"):
        tok._elementwise_call(k, [a, a], 2)
    n = tok.elementwise_triton.launches
    tok._elementwise_call(k, [a], 1)
    assert tok.elementwise_triton.launches == n
