"""The port's RNN zoo (apex_tpu_torch.rnn) against the JAX package's
(apex_tpu.rnn), on the CPU, through `params_from_jax`: every cell at 2
layers and bidirectional, mLSTM where the JAX package runs (2 layers
one way; one bidirectional layer with input_size == hidden_size).

Tolerances: fp32 outputs rtol 1e-5 / atol 1e-6; the gradients of the
outputs' sum with respect to every parameter and the input against
`jax.grad` at rtol 1e-4 / atol 1e-6; bf16 outputs within 2e-2 of each
output's largest magnitude (the products round to bf16 in both, XLA's
CPU backend keeping excess precision in places).  The JAX mLSTM's own
failure (its w_mx sized by the parameter's position in the list): both
packages raise, the JAX one when it runs, the port when it is built."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import rnn as jrnn
from apex_tpu_torch import rnn

CASES = [("RNNReLU", 5, 7, 2, True), ("RNNTanh", 5, 7, 2, True),
         ("LSTM", 5, 7, 2, True), ("GRU", 5, 7, 2, True),
         ("mLSTM", 5, 7, 2, False), ("mLSTM", 7, 7, 1, True)]
IDS = [f"{c[0]}-in{c[1]}-L{c[3]}-{'bi' if c[4] else 'uni'}" for c in CASES]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(case):
    """The JAX module, its parameters (seeded numpy values, biases too,
    in the shapes of the port's init, which are the JAX package's) and
    the input."""
    name, i, h, layers, bi = case
    jm = getattr(jrnn, name)(i, h, layers, bi)
    shapes = getattr(rnn, name)(i, h, layers, bi).init(
        torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(3)
    jp = [{k: jnp.asarray(rng.uniform(-0.4, 0.4, tuple(v.shape))
                          .astype(np.float32)) for k, v in q.items()}
          for q in shapes]
    x = np.random.RandomState(1).randn(6, 3, i).astype(np.float32)
    return name, jm, jp, x


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fp32_outputs_and_grads_match_jax(case):
    name, jm, jp, x = _setup(case)
    m = getattr(rnn, name)(*case[1:])
    params = rnn.params_from_jax(jp, device="cpu")
    assert [sorted(p) for p in params] == [sorted(p) for p in jp]
    leaves = [t.requires_grad_(True) for p in params for t in p.values()]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = m.apply(params, xt)

    @jax.jit               # one compile for the outputs and the grads
    def fwd_bwd(p, xx):
        out, vjp = jax.vjp(jm.apply, p, xx)
        return out, vjp(jnp.ones_like(out))

    want, (jg, jgx) = fwd_bwd(jp, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(y.sum(), leaves + [xt])
    jleaves = [q[k] for q, p in zip(jg, params) for k in p]
    for g, w in zip(grads, jleaves + [jgx]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_outputs_match_jax(case):
    name, jm, jp, x = _setup(case)
    m = getattr(rnn, name)(*case[1:])
    jpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    params = rnn.params_from_jax(jp, device="cpu", dtype=torch.bfloat16)
    y = m.apply(params, torch.from_numpy(x).to(torch.bfloat16))
    # jitted: one compile, where op-by-op dispatch around the scan
    # costs twice the time
    want = np.asarray(jax.jit(jm.apply)(jpb, jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    assert y.dtype == torch.bfloat16
    err = np.abs(y.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("i,h,layers", [(8, 16, 1), (16, 16, 2)])
def test_bidirectional_mlstm_raises_where_jax_cannot_run(i, h, layers):
    """The JAX package's own failure: its w_mx does not fit the layer's
    input (a TypeError from dot_general); the port refuses the model."""
    jm = jrnn.mLSTM(i, h, layers, True)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    with pytest.raises(TypeError):          # raised while tracing apply
        jax.eval_shape(jm.apply, jp, jnp.ones((3, 2, i)))
    with pytest.raises(ValueError, match="bidirectional"):
        rnn.mLSTM(i, h, layers, True)


def test_init_shapes_are_the_jax_packages():
    """The port's own init draws the JAX package's shapes (and zero
    biases), so its params and converted JAX params are interchangeable."""
    for case in CASES:
        name, i, h, layers, bi = case
        jp = jax.eval_shape(getattr(jrnn, name)(i, h, layers, bi).init,
                            jax.random.PRNGKey(0))
        p = getattr(rnn, name)(i, h, layers, bi).init(
            torch.Generator().manual_seed(0), device="cpu")
        assert [{k: tuple(v.shape) for k, v in q.items()} for q in p] == \
            [{k: tuple(v.shape) for k, v in q.items()} for q in jp]
        assert all(float(q["b_ih"].abs().sum()) == 0 for q in p)
    import apex_tpu_torch
    assert apex_tpu_torch.RNN is rnn and apex_tpu_torch.rnn is rnn


@pytest.mark.parametrize("name", ["RNNReLU", "RNNTanh", "LSTM", "GRU",
                                  "mLSTM"])
def test_init_without_a_device_is_on_the_card(name):
    """`init` with no device puts the parameters on the card; with no
    card it raises rather than leave them on the CPU."""
    m = getattr(rnn, name)(4, 4)
    key = torch.Generator().manual_seed(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            m.init(key)
        return
    assert all(t.is_cuda for p in m.init(key) for t in p.values())
