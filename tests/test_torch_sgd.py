"""The PyTorch port's SGD (apex_tpu_torch.ops.optimizer_kernels.sgd_flat
and optimizers.FusedSGD) against the JAX package's, on the CPU.

The JAX side runs its Pallas SGD kernel in interpret mode
(`use_pallas_override=True` / `use_pallas=True`); the port's side runs
its plain PyTorch version (what CPU tensors get), in place.  The same
seeded numpy buffers go to both.

Tolerances.  fp32 state: rtol 1e-6 / atol 1e-7 (the same fp32 formula,
which XLA's CPU backend may contract into fused multiply-adds).  bf16
state: one bf16 ulp of the JAX value plus 1e-7.  A found_inf step keeps
p and buf bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import optimizer_kernels as JK
from apex_tpu.optimizers.fused_sgd import FusedSGD as JaxFusedSGD
from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.optimizers import flat as F

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's plain versions on one CPU thread (as the other
    port tests do: once JAX has run in the process, torch's vector math
    on an intra-op worker thread is sometimes less accurate)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, dt, what):
    got = got.float().numpy()
    want = _np(want)
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=what)
    else:
        _, e = np.frexp(np.abs(want))
        ulp = np.ldexp(np.ones_like(want), e - 8)
        assert np.all(np.abs(got - want) <= ulp + 1e-7), what


def _bufs(seed, n, dt):
    """p, buf in the state dtype `dt`, g bf16 (the O1 step's grads), as
    (jax, torch) pairs built from one numpy draw."""
    rng = np.random.RandomState(seed)
    jdt, tdt = _DTYPES[dt]
    out = []
    for scale, d in ((1.0, dt), (0.1, dt), (2.0, "bf16")):
        a = (rng.randn(n) * scale).astype(np.float32)
        j = jnp.asarray(a).astype(_DTYPES[d][0])
        out.append((j, torch.tensor(_np(j)).to(_DTYPES[d][1])))
    return out


# (momentum, dampening, nesterov, weight_decay, wd_after_momentum)
_FLAGS = [(0.9, 0.0, False, 1e-4, False),     # the ResNet step's
          (0.9, 0.0, True, 1e-4, False),
          (0.9, 0.1, False, 0.0, False),
          (0.9, 0.0, False, 1e-2, True),
          (0.9, 0.0, True, 1e-2, True),
          (0.0, 0.0, False, 1e-4, False),
          (0.0, 0.0, False, 0.0, False)]


# each flag set at a steady step, at the traced first step (buf := g)
# and with the static first_run; first_run selects a momentum branch, so
# the momentum-free sets take the first two only
_CASES = [(i, first, first_run) for i, f in enumerate(_FLAGS)
          for first, first_run in ((False, False), (True, False),
                                   (False, True))
          if f[0] != 0.0 or not first_run]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case,first,first_run", _CASES)
def test_sgd_flat_matches_jax_pallas(case, first, first_run, dt):
    momentum, dampening, nesterov, wd, after = _FLAGS[case]
    n = 1000
    (jp, p), (jb, b), (jg, g) = _bufs(case, n, dt)
    kw = dict(momentum=momentum, dampening=dampening, nesterov=nesterov,
              weight_decay=wd, wd_after_momentum=after, first_run=first_run)
    wp, wb = JK.sgd_flat(jp, jb, jg, 0.1, first=first, inv_scale=0.5,
                         use_pallas_override=True, **kw)
    rp, rb = K.sgd_flat(p, b, g, 0.1, first=torch.tensor(first),
                        inv_scale=torch.tensor(0.5), **kw)
    assert rp is p and rb is b                     # in place
    _assert_close(p, wp, dt, "p")
    _assert_close(b, wb, dt, "buf")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_found_inf_keeps_p_and_buf_bit_for_bit(dt):
    (jp, p), (jb, b), (jg, g) = _bufs(3, 513, dt)
    g[7] = float("inf")
    jg = jg.at[7].set(jnp.inf)
    p0, b0 = p.clone(), b.clone()
    wp, wb = JK.sgd_flat(jp, jb, jg, 0.1, momentum=0.9, weight_decay=1e-4,
                         first=True, found_inf=True,
                         use_pallas_override=True)
    K.sgd_flat(p, b, g, 0.1, momentum=0.9, weight_decay=1e-4, first=True,
               found_inf=torch.tensor(True))
    assert torch.equal(p, p0) and torch.equal(b, b0)
    np.testing.assert_array_equal(p.float().numpy(), _np(wp))
    np.testing.assert_array_equal(b.float().numpy(), _np(wb))


def _tree(seed, dt=np.float32):
    rng = np.random.RandomState(seed)
    shapes = {"conv": (8, 3, 3, 4), "bn": {"scale": (8,), "bias": (8,)},
              "fc_w": (32, 10), "fc_b": (10,)}

    def draw(s):
        return {k: draw(v) for k, v in s.items()} if isinstance(s, dict) \
            else rng.randn(*s).astype(dt)
    return draw(shapes)


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _bf16(tree):
    return {k: _bf16(v) if isinstance(v, dict) else v.astype(jnp.bfloat16)
            for k, v in tree.items()}


@pytest.mark.parametrize("nesterov", [False, True])
def test_three_fused_sgd_steps_match_jax(nesterov):
    """Three FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4) steps from
    bf16 grad trees, the second with found_inf (skipped: the step count
    stays and the first-step select is taken again at the next step),
    against the JAX FusedSGD with its Pallas kernel in interpret mode."""
    params = _tree(0)
    jopt = JaxFusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4,
                       nesterov=nesterov, use_pallas=True)
    jstate = jopt.init(_jax(params))
    opt = FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4,
                   nesterov=nesterov)
    state = opt.init(_torch(params))
    assert state.params.numel() % K.FLAT_TILE == 0
    np.testing.assert_array_equal(state.params.numpy(),
                                  np.asarray(jstate.params))
    for i, found in enumerate((True, False, False)):
        jg = _bf16(_jax(_tree(10 + i)))
        tg = _torch_from_jax(jg)
        jtree, jstate = jopt.step(jstate, jg, inv_scale=0.25,
                                  found_inf=found)
        tree, state = opt.step(state, tg, inv_scale=torch.tensor(0.25),
                               found_inf=torch.tensor(found))
        assert int(state.step) == int(jstate.step) == (0 if i == 0 else i)
        np.testing.assert_allclose(state.params.numpy(),
                                   np.asarray(jstate.params), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(state.momentum_buffer.numpy(),
                                   np.asarray(jstate.momentum_buffer),
                                   rtol=1e-6, atol=1e-7)
    for got, want in zip(F.tree_leaves(tree), jax.tree_util.tree_leaves(
            jtree)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    # the returned tree views the flat buffer: no copy of the params
    leaf = F.tree_leaves(tree)[0]
    assert leaf.untyped_storage().data_ptr() == \
        state.params.untyped_storage().data_ptr()


def _torch_from_jax(tree):
    return {k: _torch_from_jax(v) if isinstance(v, dict)
            else torch.tensor(_np(v)).to(torch.bfloat16)
            for k, v in tree.items()}


def test_fused_sgd_refuses_and_raises():
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(lr=0.1, momentum=0.0, nesterov=True)
    opt = FusedSGD(lr=0.1)
    with pytest.raises(RuntimeError, match="init"):
        opt.step_flat(None, torch.zeros(4))
    state = opt.init({"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="match"):
        opt.step_flat(state, torch.zeros(4))
    with pytest.raises(ValueError, match="scalars"):
        K.sgd_flat_triton(state.params, state.momentum_buffer,
                          state.params.clone(), torch.zeros(3), 0.9, 0.0,
                          False, 0.0, False, False)


def test_momentum_free_sgd_leaves_the_buffer():
    """momentum=0: p -= lr · (g·inv + wd·p) and buf is untouched (the JAX
    kernel writes it back unchanged)."""
    p = torch.tensor([1.0, -2.0, 0.5])
    b = torch.tensor([3.0, 3.0, 3.0])
    g = torch.tensor([0.5, 0.25, -1.0])
    K.sgd_flat(p, b, g, 0.1, weight_decay=0.5, inv_scale=2.0)
    want = np.array([1.0, -2.0, 0.5]) - 0.1 * (
        np.array([1.0, 0.5, -2.0]) + 0.5 * np.array([1.0, -2.0, 0.5]))
    np.testing.assert_allclose(p.numpy(), want, rtol=1e-6)
    assert torch.equal(b, torch.tensor([3.0, 3.0, 3.0]))
