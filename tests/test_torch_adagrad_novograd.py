"""The PyTorch port's Adagrad, LAMB phase 2 per element, flat-buffer
utilities, FusedAdagrad, FusedNovoGrad, multi_tensor_applier and
clip_grad_norm against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(`use_pallas_override=True` / `use_pallas=True`) or, where it has none,
its plain functions; the port's side runs its plain PyTorch versions
(what CPU tensors get).  The same seeded numpy inputs go to both.

Tolerances.  `adagrad_flat` against the JAX Pallas kernel in
interpret mode: fp32 p and h rtol 1e-6 / atol 1e-8, a few ulps (XLA's
CPU backend contracts g·g + h and wd·p + g into fmas, and p - lr·upd
cancels when p is near lr).  `lamb_phase2_flat`: bit for bit against a
numpy float32 evaluation of the JAX formula one operation at a time
(what the port computes), and against the JAX kernel within one ulp of
p plus one of lr·r·u in fp32 (XLA contracts the multiply and the
subtraction into one fma), one bf16 ulp in bf16.  Norms: rtol 1e-6
(fp32 sums in another order); expansions, scale and axpby: exact.
Optimizer steps, fp32 state: rtol 1e-5 / atol 1e-6 after three steps
(Adagrad's g / sqrt(h) and NovoGrad's g / ||g|| magnify last-digit
differences of the grads' fp32 sums only slightly: the inputs are the
same arrays, so these are the kernels' own roundings).  clip_grad_norm:
rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply import multi_tensor_applier as jax_mta
from apex_tpu.ops import optimizer_kernels as JK
from apex_tpu.optimizers import flat as jax_flat
from apex_tpu.optimizers.fused_adagrad import FusedAdagrad as JaxFusedAdagrad
from apex_tpu.optimizers.fused_novograd import (
    FusedNovoGrad as JaxFusedNovoGrad)
from apex_tpu.parallel.clip_grad import clip_grad_norm as jax_clip
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
from apex_tpu_torch.multi_tensor_apply import (MultiTensorApply,
                                               multi_tensor_applier)
from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import FusedAdagrad, FusedNovoGrad
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.parallel.clip_grad import clip_grad_norm

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}

# matrices, vectors shorter than a row of 128, a 2-element bias and a
# (3, 5) leaf that is not row-aligned
_SHAPES = {"block0": {"qkv": {"weight": (16, 48), "bias": (48,)},
                      "ln1": {"weight": (16,), "bias": (16,)}},
           "embed": {"weight": (300, 16)}, "nsp_b": (2,), "pos": (3, 5)}


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


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree):
    return jax.tree_util.tree_map(torch.tensor, tree)


# ---------------------------------------------------------------- kernels

def _ulp(x, bits=24):
    _, e = np.frexp(np.abs(x))
    return np.ldexp(np.ones_like(x), e - bits)


@pytest.mark.parametrize("gdt", ["f32", "bf16"])
@pytest.mark.parametrize("w_mode,wd", [(False, 0.0), (False, 0.01),
                                       (True, 0.01)])
def test_adagrad_flat_matches_jax_kernel(w_mode, wd, gdt):
    """Two steps over a buffer that is not a whole number of tiles, p and
    h fp32, grads in `gdt`; p and h updated in place."""
    n, lr = 3001, 0.05
    rng = np.random.RandomState(11)
    p0 = rng.randn(n).astype(np.float32)
    jp, jh = jnp.asarray(p0), jnp.zeros(n, jnp.float32)
    tp, th = torch.tensor(p0), torch.zeros(n)
    for _ in range(2):
        g = (rng.randn(n) * 0.3).astype(np.float32)
        jg = jnp.asarray(g).astype(_DTYPES[gdt][0])
        tg = torch.tensor(g).to(_DTYPES[gdt][1])
        jp, jh = JK.adagrad_flat(jp, jh, jg, lr, eps=1e-10,
                                 weight_decay=wd, adagrad_w_mode=w_mode,
                                 use_pallas_override=True)
        out = K.adagrad_flat(tp, th, tg, lr, eps=1e-10, weight_decay=wd,
                             adagrad_w_mode=w_mode)
        assert out[0] is tp and out[1] is th
        for got, want in ((tp, jp), (th, jh)):
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6,
                                       atol=1e-8)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lamb_phase2_flat_matches_jax_kernel(dtype):
    """p -= lr · r · u in place with a per-element ratio."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.RandomState(12)
    n = 5000
    p, u = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    r = (rng.rand(n) * 2).astype(np.float32)
    want = _np(JK.lamb_phase2_flat(jnp.asarray(p).astype(jdt),
                                   jnp.asarray(u).astype(jdt),
                                   jnp.asarray(r), 1e-2,
                                   use_pallas_override=True))
    tp, tu = torch.tensor(p).to(tdt), torch.tensor(u).to(tdt)
    pf, uf = tp.float().numpy(), tu.float().numpy()
    step = (np.float32(1e-2) * r) * uf
    exact = torch.tensor(pf - step).to(tdt).float().numpy()
    out = K.lamb_phase2_flat(tp, tu, torch.tensor(r), torch.tensor(1e-2))
    assert out is tp and tp.dtype == tdt
    np.testing.assert_array_equal(tp.float().numpy(), exact)
    tol = (_ulp(want) + _ulp(step) if dtype == "f32"
           else _ulp(want, bits=8))
    assert np.all(np.abs(tp.float().numpy() - want) <= tol)


def test_lamb_phase2_flat_equals_the_segmented_phase_2():
    """Fed the per-tensor ratios expanded by `expand_per_tensor_aligned`,
    the flat phase 2 equals `lamb_phase2_seg` bit for bit, padding
    untouched."""
    rng = np.random.RandomState(13)
    w = _tt(_tree(lambda s: rng.randn(*s).astype(np.float32)))
    spec = F.make_spec(w, align=128)
    p = F.flatten(w, pad_to=K.FLAT_TILE, align=128)
    u = F.flatten(_tt(_tree(lambda s: rng.randn(*s).astype(np.float32))),
                  pad_to=K.FLAT_TILE, align=128)
    ratio = torch.tensor(rng.rand(len(spec.sizes)).astype(np.float32) + 0.5)
    flat = K.lamb_phase2_flat(p.clone(), u, K.expand_per_tensor_aligned(
        ratio, spec, p.numel()), 1e-2)
    seg = K.lamb_phase2_seg(p.clone(), u, ratio, spec, 1e-2)
    assert torch.equal(flat, seg)
    assert torch.all(flat[spec.total:] == 0)


def test_reductions_and_utilities_match_jax():
    """per_tensor_l2norm over back-to-back segments, expand_per_tensor
    (the tail repeats the last value), expand_per_tensor_aligned over a
    lane-aligned spec, scale_flat and axpby_flat."""
    rng = np.random.RandomState(14)
    sizes = (7, 300, 1, 129)
    flat = rng.randn(sum(sizes) + 9).astype(np.float32)
    np.testing.assert_allclose(
        K.per_tensor_l2norm(torch.tensor(flat), sizes).numpy(),
        np.asarray(JK.per_tensor_l2norm(jnp.asarray(flat), sizes)),
        rtol=1e-6)
    vals = rng.randn(len(sizes)).astype(np.float32)
    total = sum(sizes) + 5
    got = K.expand_per_tensor(torch.tensor(vals), sizes, total)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(JK.expand_per_tensor(jnp.asarray(vals), sizes, total)))
    w = _tree(lambda s: rng.randn(*s).astype(np.float32))
    jspec = jax_flat.make_spec(_jt(w), align=128)
    tspec = F.make_spec(_tt(w), align=128)
    vals = rng.randn(len(tspec.sizes)).astype(np.float32)
    for total in (tspec.total, K.FLAT_TILE):
        np.testing.assert_array_equal(
            K.expand_per_tensor_aligned(torch.tensor(vals), tspec,
                                        total).numpy(),
            np.asarray(JK.expand_per_tensor_aligned(jnp.asarray(vals), jspec,
                                                    total)))
    x, y = rng.randn(2, 1000).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        K.scale_flat(torch.tensor(x).to(torch.bfloat16), 0.25).numpy(),
        np.asarray(JK.scale_flat(xb, 0.25)))
    np.testing.assert_array_equal(
        K.axpby_flat(2.0, torch.tensor(x), -0.5, torch.tensor(y)).numpy(),
        np.asarray(JK.axpby_flat(2.0, jnp.asarray(x), -0.5,
                                 jnp.asarray(y))))


# ------------------------------------------------------------- optimizers

@pytest.mark.parametrize("w_mode,wd", [(False, 0.0), (False, 0.01),
                                       (True, 0.01)])
def test_three_fused_adagrad_steps_match_jax(w_mode, wd):
    rng = np.random.RandomState(15)
    w = _tree(lambda s: rng.randn(*s).astype(np.float32))
    kw = dict(lr=0.05, weight_decay=wd, adagrad_w_mode=w_mode)
    jopt = JaxFusedAdagrad(use_pallas=True, **kw)
    topt = FusedAdagrad(**kw)
    jstate, tstate = jopt.init(_jt(w)), topt.init(_tt(w))
    np.testing.assert_array_equal(tstate.params.numpy(),
                                  np.asarray(jstate.params))
    for _ in range(3):
        g = _tree(lambda s: rng.randn(*s).astype(np.float32))
        _, jstate = jopt.step(jstate, _jt(g))
        tparams, tstate = topt.step(tstate, _tt(g))
    assert int(tstate.step) == int(jstate.step) == 3
    for got, want in ((tstate.params, jstate.params),
                      (tstate.sum_sq, jstate.sum_sq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    assert tparams["embed"]["weight"].shape == (300, 16)


_NOVO_CASES = [
    # (init_zero, reg_inside_moment, grad_averaging, bias_correction, wd)
    (False, False, False, True, 0.0),
    (True, False, True, True, 0.01),
    (False, True, True, False, 0.01),
    (True, True, False, True, 0.01),
]


@pytest.mark.parametrize("init_zero,reg_inside,grad_averaging,bc,wd",
                         _NOVO_CASES)
def test_fused_novograd_matches_jax(init_zero, reg_inside, grad_averaging,
                                    bc, wd):
    """Four steps, the second an overflow (found_inf with a NaN grad):
    params, m, v and the step count stay as they were; inv_scale 0.5 on
    grads twice as large."""
    rng = np.random.RandomState(16)
    w = _tree(lambda s: rng.randn(*s).astype(np.float32))
    kw = dict(lr=1e-2, betas=(0.95, 0.98), weight_decay=wd,
              grad_averaging=grad_averaging, reg_inside_moment=reg_inside,
              init_zero=init_zero, bias_correction=bc)
    jopt = JaxFusedNovoGrad(use_pallas=True, **kw)
    topt = FusedNovoGrad(**kw)
    jstate, tstate = jopt.init(_jt(w)), topt.init(_tt(w))
    np.testing.assert_array_equal(tstate.params.numpy(),
                                  np.asarray(jstate.params))
    steps = 0
    for i in range(4):
        g = _tree(lambda s: (rng.randn(*s) * 2).astype(np.float32))
        found = i == 1
        if found:
            g["pos"][0, 0] = np.nan
        steps += not found
        kept = [t.clone() for t in tstate[1:]]
        _, jstate = jopt.step(jstate, _jt(g), inv_scale=0.5,
                              found_inf=found)
        _, tstate = topt.step(tstate, _tt(g), inv_scale=0.5,
                              found_inf=torch.tensor(found))
        assert int(tstate.step) == int(jstate.step) == steps
        if found:
            assert all(torch.equal(a, b) for a, b in zip(tstate[1:], kept))
        for got, want in ((tstate.params, jstate.params),
                          (tstate.exp_avg, jstate.exp_avg),
                          (tstate.exp_avg_sq, jstate.exp_avg_sq)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i}")


def test_fused_novograd_refuses():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedNovoGrad(amsgrad=True)
    with pytest.raises(ValueError, match="l2 norm"):
        FusedNovoGrad(norm_type=0)
    with pytest.raises(RuntimeError, match="init"):
        FusedNovoGrad().step_flat(None, torch.zeros(1))


# ------------------------------------------------ multi-tensor, clipping

def test_multi_tensor_applier_matches_jax():
    """A scale functor over two parallel lists, each flattened once; the
    second list is left as it was (the functor returns None for it)."""
    rng = np.random.RandomState(17)
    a = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (5,), (1,))]
    b = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (5,), (1,))]

    def jop(flag, bufs, s):
        return JK.scale_flat(bufs[0], s), None

    def top(flag, bufs, s):
        return K.scale_flat(bufs[0], s), None

    want = jax_mta(jop, None, [[jnp.asarray(x) for x in a],
                               [jnp.asarray(x) for x in b]], 0.5)
    tb = [torch.tensor(x) for x in b]
    got = multi_tensor_applier(top, None, [[torch.tensor(x) for x in a], tb],
                               0.5)
    assert got[1] == tb
    for g, wv in zip(got[0], want[0]):
        assert tuple(g.shape) == wv.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    with pytest.raises(ValueError, match="equal length"):
        MultiTensorApply()(top, None, [[torch.ones(1)], []])
    with pytest.raises(ValueError, match="share a dtype"):
        multi_tensor_applier(top, None, [[torch.ones(1),
                                          torch.ones(1, dtype=torch.int32)]])


@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 3.0])
@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_grad_norm_matches_jax(norm_type, max_norm):
    """The total norm and the clipped grads (clipped only when the total
    exceeds max_norm); bf16 leaves keep their dtype."""
    rng = np.random.RandomState(18)
    g = _tree(lambda s: rng.randn(*s).astype(np.float32))
    jg = _jt(g)
    jg["pos"] = jg["pos"].astype(jnp.bfloat16)
    tg = _tt(g)
    tg["pos"] = tg["pos"].to(torch.bfloat16)
    jc, jt = jax_clip(jg, max_norm, norm_type)
    tc, tt = clip_grad_norm(tg, max_norm, norm_type)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    assert tc["pos"].dtype == torch.bfloat16
    for got, want in zip(F.tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   rtol=1e-6, atol=0)
    if max_norm > float(tt):
        assert all(torch.equal(a, b) for a, b in zip(F.tree_leaves(tc),
                                                     F.tree_leaves(tg)))
    lc, lt = clip_grad_norm_(F.tree_leaves(tg), max_norm, norm_type)
    assert float(lt) == float(tt)
    assert all(torch.equal(a, b) for a, b in zip(lc, F.tree_leaves(tc)))
