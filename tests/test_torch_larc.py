"""The PyTorch port's LARC (apex_tpu_torch.parallel.larc) against the
JAX package's, on the CPU.

The JAX side runs FusedSGD's Pallas kernel and the per-tensor norm
kernel in interpret mode (`use_pallas=True`); the port's side runs its
plain PyTorch versions.  The same seeded numpy inputs go to both.

Tolerances.  Adjusted grads: rtol 1e-5 / atol 1e-7 (fp32 norms summed
in another order; the trust ratio is a quotient of two of them).
Params and momentum after three steps: rtol 1e-5 / atol 1e-6.  The flat
route (`step_flat`, the form the port's train steps call) against the
tree route (`step`): the same tolerance, since the per-tensor scale
multiplies the same fp32 numbers by the same factor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.optimizers.fused_sgd import FusedSGD as JaxFusedSGD
from apex_tpu.parallel import ddp as jax_ddp
from apex_tpu.parallel import mesh as M
from apex_tpu.parallel.larc import LARC as JaxLARC
from apex_tpu.parallel.larc import larc_adjust_grads as jax_larc_adjust
from apex_tpu_torch.optimizers import FusedAdagrad, FusedSGD
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.parallel import ddp
from apex_tpu_torch.parallel.larc import LARC, larc_adjust_grads

_SHAPES = {"conv": {"weight": (3, 3, 4, 8), "bias": (8,)},
           "fc": {"weight": (40, 10), "bias": (10,)}, "scale": (5,)}


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


def _tree(fn, spec=_SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in spec.items()}


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree):
    return jax.tree_util.tree_map(torch.tensor, tree)


def _grads(rng):
    g = _tree(lambda s: (rng.randn(*s) * 0.5).astype(np.float32))
    g["scale"][:] = 0.0          # a zero grad: the adaptation is skipped
    return g


@pytest.mark.parametrize("clip,wd", [(True, 0.0), (True, 1e-4),
                                     (False, 1e-4)])
def test_larc_adjust_grads_matches_jax(clip, wd):
    rng = np.random.RandomState(41)
    p = _tree(lambda s: rng.randn(*s).astype(np.float32))
    g = _grads(rng)
    want = jax_larc_adjust(_jt(p), _jt(g), 0.1, trust_coefficient=0.02,
                           clip=clip, weight_decay=wd, use_pallas=True)
    got = larc_adjust_grads(_tt(p), _tt(g), 0.1, trust_coefficient=0.02,
                            clip=clip, weight_decay=wd)
    for a, b in zip(F.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("clip", [True, False])
def test_three_larc_sgd_steps_match_jax(clip):
    """LARC(FusedSGD(0.1, 0.9, 1e-4)): three steps through `step` against
    the JAX LARC's; the inner optimizer's weight decay is 0 during the
    step (folded into the grads) and restored after it."""
    rng = np.random.RandomState(42)
    w = _tree(lambda s: rng.randn(*s).astype(np.float32))
    jopt = JaxLARC(JaxFusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4,
                               use_pallas=True), clip=clip)
    topt = LARC(FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4),
                clip=clip)
    jstate, tstate = jopt.init(_jt(w)), topt.init(_tt(w))
    for _ in range(3):
        g = _grads(rng)
        _, jstate = jopt.step(jstate, _jt(g))
        _, tstate = topt.step(tstate, _tt(g))
    assert topt.optim.weight_decay == 1e-4 and topt.spec is topt.optim.spec
    assert int(tstate.step) == int(jstate.step) == 3
    for a, b in ((tstate.params, jstate.params),
                 (tstate.momentum_buffer, jstate.momentum_buffer)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_step_flat_equals_step_and_unscales_first():
    """The flat route equals the tree route; with a loss scale it takes
    the trust ratio of the unscaled grads, so grads x 2^10 at inv_scale
    2^-10 give the same step; an overflow keeps the state bit for bit."""
    rng = np.random.RandomState(43)
    w = _tt(_tree(lambda s: rng.randn(*s).astype(np.float32)))
    outs = []
    for route in ("tree", "flat", "scaled"):
        opt = LARC(FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4))
        state = opt.init(w)
        rs = np.random.RandomState(44)
        for _ in range(2):
            g = _tt(_grads(rs))
            if route == "tree":
                _, state = opt.step(state, g)
                continue
            flat = F.flatten(g, pad_to=state.params.numel())
            if route == "flat":
                _, state = opt.step_flat(state, flat)
            else:
                _, state = opt.step_flat(state, flat * 1024.0,
                                         inv_scale=torch.tensor(2.0 ** -10),
                                         found_inf=torch.tensor(False))
        outs.append(state)
    for other in outs[1:]:
        for a, b in zip(other[1:], outs[0][1:]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
    kept = [t.clone() for t in state]
    bad = torch.full_like(state.params, float("inf"))
    _, state = opt.step_flat(state, bad, found_inf=torch.tensor(True))
    assert all(torch.equal(a, b) for a, b in zip(state, kept))
    # an inner optimizer without an overflow skip takes no found_inf
    ada = LARC(FusedAdagrad(lr=0.1, weight_decay=1e-4))
    st = ada.init(w)
    _, st = ada.step_flat(st, F.flatten(_tt(_grads(rs)),
                                        pad_to=st.params.numel()))
    assert int(st.step) == 1


def test_ddp_train_step_with_larc_matches_jax():
    """A two-layer model through both packages' `ddp.make_train_step`
    (one device, no amp) with LARC(FusedSGD): three steps on new seeded
    batches, the loss rtol 1e-5 and the params rtol 1e-5 / atol 1e-6."""
    M.destroy_model_parallel()
    mesh = M.initialize_model_parallel(devices=jax.devices()[:1])
    rng = np.random.RandomState(45)
    w = {"w1": (rng.randn(8, 16) * 0.3).astype(np.float32),
         "b1": np.zeros(16, np.float32),
         "w2": (rng.randn(16, 4) * 0.3).astype(np.float32),
         "b2": np.zeros(4, np.float32)}

    def jloss(p, b):
        x, y = b
        h = jnp.maximum(x @ p["w1"] + p["b1"], 0.0)
        return jnp.mean(jnp.square(h @ p["w2"] + p["b2"] - y))

    def tloss(p, b):
        x, y = b
        h = torch.relu(x @ p["w1"] + p["b1"])
        return torch.mean(torch.square(h @ p["w2"] + p["b2"] - y))

    jopt = JaxLARC(JaxFusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4,
                               use_pallas=True))
    jstep = jax_ddp.make_train_step(jloss, jopt, mesh,
                                    batch_spec=(P("dp"), P("dp")),
                                    donate=False)
    topt = LARC(FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4))
    tstep = ddp.make_train_step(tloss, topt, device="cpu")
    jstate, tstate = jopt.init(_jt(w)), topt.init(_tt(w))
    for i in range(3):
        x = rng.randn(6, 8).astype(np.float32)
        y = rng.randn(6, 4).astype(np.float32)
        jstate, _, jl = jstep(jstate, None, (jnp.asarray(x), jnp.asarray(y)))
        tstate, _, tl = tstep(tstate, None, (torch.tensor(x),
                                             torch.tensor(y)))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tstate.params.numpy(),
                               np.asarray(jstate.params), rtol=1e-5,
                               atol=1e-6)
    M.destroy_model_parallel()
