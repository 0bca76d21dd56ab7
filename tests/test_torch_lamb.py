"""The PyTorch port's LAMB (apex_tpu_torch.ops.optimizer_kernels LAMB
functions, optimizers.FusedLAMB, resolve_per_leaf and the weight-decay
mask) against the JAX package's, on the CPU.

The JAX side runs its Pallas LAMB kernels in interpret mode
(`use_pallas_override=True` / `use_pallas=True`); the port's side runs
its plain PyTorch versions (what CPU tensors get), in place.  The same
seeded numpy inputs go to both, on a FLAT_TILE-padded, lane-aligned
buffer of a few tensors.

Tolerances.  fp32 kernels: rtol 1e-6 / atol 1e-7 (the same fp32
formula; the moments cancel to values far below their operands, so an
absolute term near one fp32 ulp of the operands is needed).  bf16 state:
at most one bf16 ulp plus that 1e-7.  Sums of squares: rtol 1e-5 (fp32
sums in another order).  Params after several FusedLAMB steps: fp32
rtol 1e-5 / atol 1e-6; bf16 one ulp of the state plus 1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.bert import Bert as JaxBert
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.ops import optimizer_kernels as JK
from apex_tpu.optimizers import flat as jax_flat
from apex_tpu.optimizers.fused_lamb import FusedLAMB as JaxFusedLAMB
from apex_tpu.transformer.pipeline_parallel.common import (
    get_params_for_weight_decay_optimization as jax_wd_mask)
from apex_tpu_torch.models.bert import BertConfig, init_bert_params
from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import FusedLAMB, FusedMixedPrecisionLamb
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.transformer.pipeline_parallel import (
    get_params_for_weight_decay_optimization)

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}

# a few tensors of the shapes LAMB meets: matrices, vectors shorter than
# a row of 128, a 2-element bias, a (3, 5) leaf that is not row-aligned
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


def _assert_state_close(got, want, dtype, what):
    got = got.float().numpy()
    want = _np(want)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=what)
    else:
        _, e = np.frexp(np.abs(want))
        ulp = np.ldexp(np.ones_like(want), e - 8)
        assert np.all(np.abs(got - want) <= ulp + 1e-7), what


def _specs(rng):
    """A lane-aligned spec in both packages, and a flat p in both."""
    w = _tree(lambda s: rng.randn(*s).astype(np.float32))
    jspec = jax_flat.make_spec(jax.tree_util.tree_map(jnp.asarray, w),
                               align=128)
    tspec = F.make_spec(jax.tree_util.tree_map(torch.tensor, w), align=128)
    flat = F.flatten(jax.tree_util.tree_map(torch.tensor, w),
                     pad_to=K.FLAT_TILE, align=128).numpy()
    return jspec, tspec, flat


def _buffers(rng, n, dtype, flat_p):
    jdt, tdt = _DTYPES[dtype]
    m0 = (rng.randn(n) * 0.1).astype(np.float32)
    v0 = (np.abs(rng.randn(n)) * 0.01).astype(np.float32)
    g0 = (rng.randn(n) * 2).astype(np.float32)
    # the padding stays zero, as in a real flat buffer
    pad = flat_p == 0
    m0[pad] = v0[pad] = g0[pad] = 0.0
    j = [jnp.asarray(x).astype(jdt) for x in (m0, v0, g0, flat_p)]
    t = [torch.tensor(x).to(tdt) for x in (m0, v0, g0, flat_p)]
    return j, t


@pytest.mark.parametrize("dtype,wd,found", [
    ("f32", 0.0, False), ("f32", 0.01, False), ("bf16", 0.01, False),
    ("bf16", 0.01, True)])
def test_lamb_phase1_flat_matches_jax_kernel(dtype, wd, found):
    """Phase 1 with one uniform weight decay: m and v in place, u new;
    a found_inf step (an inf grad) leaves m and v exactly as they were."""
    rng = np.random.RandomState(1)
    _, _, flat_p = _specs(rng)
    (jm, jv, jg, jp), (tm, tv, tg, tp) = _buffers(rng, flat_p.size, dtype,
                                                  flat_p)
    if found:
        jg = jg.at[3].set(jnp.inf)
        tg[3] = float("inf")
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=wd,
              bias_correction=True, grad_averaging=True, inv_scale=0.5,
              found_inf=found)
    jm2, jv2, ju = JK.lamb_phase1_flat(jm, jv, jg, jp, 0.7, 3.0,
                                       use_pallas_override=True, **kw)
    before = (tm.clone(), tv.clone())
    out = K.lamb_phase1_flat(tm, tv, tg, tp, 0.7, 3, **kw)
    assert out[0] is tm and out[1] is tv and out[2].dtype == tp.dtype
    if found:
        assert torch.equal(tm, before[0]) and torch.equal(tv, before[1])
    for got, want, what in ((tm, jm2, "m"), (tv, jv2, "v"),
                            (out[2], ju, "u")):
        _assert_state_close(got, want, dtype, what)


@pytest.mark.parametrize("dtype,grad_averaging", [
    ("f32", True), ("f32", False), ("bf16", True)])
def test_lamb_phase1_seg_matches_jax_kernel(dtype, grad_averaging):
    """Phase 1 with per-tensor weight decay looked up per row; padding
    rows get the dummy wd 0."""
    rng = np.random.RandomState(2)
    jspec, tspec, flat_p = _specs(rng)
    (jm, jv, jg, jp), (tm, tv, tg, tp) = _buffers(rng, flat_p.size, dtype,
                                                  flat_p)
    wd = (rng.rand(len(tspec.sizes)) * 0.1).astype(np.float32)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, bias_correction=True,
              grad_averaging=grad_averaging, inv_scale=1.0, found_inf=False)
    jm2, jv2, ju = JK.lamb_phase1_seg(jm, jv, jg, jp, 1.0, 2.0,
                                      wd_values=wd, spec=jspec,
                                      use_pallas_override=True, **kw)
    _, _, tu = K.lamb_phase1_seg(tm, tv, tg, tp, 1.0, 2, wd_values=wd,
                                 spec=tspec, **kw)
    for got, want, what in ((tm, jm2, "m"), (tv, jv2, "v"), (tu, ju, "u")):
        _assert_state_close(got, want, dtype, what)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lamb_phase2_seg_matches_jax_kernel(dtype):
    """p -= lr · ratio[tensor] · u in place; the tail padding (ratio 0)
    stays exactly as it was."""
    rng = np.random.RandomState(3)
    jspec, tspec, flat_p = _specs(rng)
    jdt, tdt = _DTYPES[dtype]
    u = rng.randn(flat_p.size).astype(np.float32)
    u[tspec.total:] = 5.0                  # must not move the padding
    ratio = (rng.rand(len(tspec.sizes)) * 2).astype(np.float32)
    jp = JK.lamb_phase2_seg(jnp.asarray(flat_p).astype(jdt),
                            jnp.asarray(u).astype(jdt), jnp.asarray(ratio),
                            jspec, 1e-2, use_pallas_override=True)
    tp = torch.tensor(flat_p).to(tdt)
    out = K.lamb_phase2_seg(tp, torch.tensor(u).to(tdt),
                            torch.tensor(ratio), tspec, 1e-2)
    assert out is tp
    assert torch.all(tp[tspec.total:] == 0)
    _assert_state_close(tp, jp, dtype, "p")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_per_tensor_l2norm_matches_jax_kernel(dtype):
    rng = np.random.RandomState(4)
    jspec, tspec, flat_p = _specs(rng)
    jdt, tdt = _DTYPES[dtype]
    want = JK.per_tensor_l2norm_aligned(jnp.asarray(flat_p).astype(jdt),
                                        jspec, use_pallas_override=True)
    got = K.per_tensor_l2norm_aligned(torch.tensor(flat_p).to(tdt), tspec)
    assert got.dtype == torch.float32 and got.shape == (len(tspec.sizes),)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # the global norm, a plain reduction in both packages
    np.testing.assert_allclose(
        float(K.l2norm_flat(torch.tensor(flat_p).to(tdt))),
        float(JK.l2norm_flat(jnp.asarray(flat_p).astype(jdt))), rtol=1e-6)


def test_segment_tables_cover_every_row_once():
    """The norm pass's work items partition each tensor's rows, at most
    256 rows each, in order; padding rows carry the dummy id."""
    rng = np.random.RandomState(5)
    _, tspec, flat_p = _specs(rng)
    big = F.make_spec({"a": torch.zeros(700 * 128 + 3),
                       "b": torch.zeros(5)}, align=128)
    for spec, n_rows in ((tspec, flat_p.size // 128), (big, 704)):
        t = K.segment_tables(spec, n_rows, torch.device("cpu"))
        seg = t["seg"].numpy()
        lo, hi, ptr = (t[k].numpy() for k in ("item_lo", "item_hi",
                                              "item_ptr"))
        assert np.all(hi - lo <= 256) and np.all(hi > lo)
        for s, (off, size) in enumerate(zip(spec.offsets, spec.sizes)):
            rows = np.arange(off // 128, -(-(off + size) // 128))
            assert np.all(seg[rows] == s)
            items = range(ptr[s], ptr[s + 1])
            covered = np.concatenate([np.arange(lo[i], hi[i])
                                      for i in items])
            np.testing.assert_array_equal(covered, rows)
        assert np.all(seg[spec.total // 128:] == len(spec.sizes))


def test_resolve_per_leaf_matches_jax():
    rng = np.random.RandomState(6)
    w = _tree(lambda s: rng.randn(*s).astype(np.float32))
    jw = jax.tree_util.tree_map(jnp.asarray, w)
    tw = jax.tree_util.tree_map(torch.tensor, w)
    mask = _tree(lambda s: len(s) >= 2)
    scales = _tree(lambda s: float(len(s)) + 0.5)
    for wd_mask, lr_scales in ((mask, None), (None, scales),
                               (mask, scales)):
        got = F.resolve_per_leaf(wd_mask, lr_scales, 0.01, tw, "t")
        want = jax_flat.resolve_per_leaf(wd_mask, lr_scales, 0.01, jw, "t")
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    bad = dict(mask, extra=True)
    with pytest.raises(ValueError, match="structure"):
        F.resolve_per_leaf(bad, None, 0.01, tw, "t")


_STEP_CASES = [
    # (master, wd_mask, lr_scales, max_grad_norm, grad_averaging)
    ("f32", False, False, 1.0, True),
    ("f32", True, False, 1.0, True),
    ("f32", True, True, 0.0, True),
    ("f32", False, True, 1.0, False),
    ("bf16", True, False, 1.0, True),
    ("bf16", False, False, 0.0, False),
]


@pytest.mark.parametrize("dtype,use_mask,use_scales,clip,grad_averaging",
                         _STEP_CASES)
def test_fused_lamb_matches_jax(dtype, use_mask, use_scales, clip,
                                grad_averaging):
    """Four FusedLAMB steps from the same weights and grads as the JAX
    FusedLAMB (Pallas in interpret mode).  Step 2 overflows (found_inf,
    a NaN grad): params, moments and the step count stay as they were.
    Grads are large enough for clipping to act when it is on."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.RandomState(7)
    w = _tree(lambda s: rng.randn(*s).astype(np.float32))
    mask = _tree(lambda s: len(s) >= 2) if use_mask else None
    scales = (_tree(lambda s: 0.5 + rng.rand()) if use_scales else None)
    kw = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=clip,
              grad_averaging=grad_averaging, wd_mask=mask, lr_scales=scales)
    jopt = JaxFusedLAMB(master_dtype=jdt, use_pallas=True, **kw)
    topt = FusedLAMB(master_dtype=tdt, **kw)
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, w))
    tstate = topt.init(jax.tree_util.tree_map(torch.tensor, w))
    np.testing.assert_array_equal(_np(jstate.params),
                                  tstate.params.float().numpy())
    steps = 0
    for i in range(4):
        g = _tree(lambda s: (rng.randn(*s) * 3).astype(np.float32))
        found = i == 1
        if found:
            g["pos"][0, 0] = np.nan
        steps += not found
        kept = [t.clone() for t in tstate[1:]]
        _, jstate = jopt.step(jstate, jax.tree_util.tree_map(jnp.asarray, g),
                              found_inf=found)
        tparams, tstate = topt.step(
            tstate, jax.tree_util.tree_map(torch.tensor, g), found_inf=found)
        assert int(tstate.step) == int(jstate.step) == steps
        if found:
            assert all(torch.equal(a, b) for a, b in zip(tstate[1:], kept))
        for got, want, what in ((tstate.exp_avg, jstate.exp_avg, "m"),
                                (tstate.exp_avg_sq, jstate.exp_avg_sq, "v")):
            _assert_state_close(got, want, dtype, f"step {i} {what}")
        got, want = tstate.params.float().numpy(), _np(jstate.params)
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} p")
        else:
            _assert_state_close(tstate.params, jstate.params, dtype,
                                f"step {i} p")
    leaf = tparams["block0"]["qkv"]["weight"]
    assert leaf.shape == (16, 48) and leaf.dtype == torch.float32


def test_weight_decay_mask_matches_jax_on_bert_large_tree():
    """The BERT-Large tree (24 layers; the widths do not change the
    leaves' names or ranks, so a narrow one stands in): the mask equals
    the JAX package's leaf for leaf, 102 of 301 leaves decay."""
    small = dict(vocab_size=16, seq_len=8, hidden=8, num_heads=2)
    jshapes = jax.eval_shape(JaxBert(JaxBertConfig(**small)).init,
                             jax.random.PRNGKey(0))
    tparams = init_bert_params(BertConfig(**small), device="cpu")
    want = jax.tree_util.tree_leaves(jax_wd_mask(jshapes))
    got_tree = get_params_for_weight_decay_optimization(tparams)
    got = F.tree_leaves(got_tree)
    assert len(got) == len(want) == 301
    assert got == want and sum(got) == 102
    # the mask is a valid wd_mask for the port's optimizers
    seg_wd, _ = F.resolve_per_leaf(got_tree, None, 0.01, tparams, "t")
    assert int(np.count_nonzero(seg_wd)) == 102


def test_fused_lamb_refuses_and_mixed_precision_alias():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(amsgrad=True)
    with pytest.raises(RuntimeError, match="init"):
        FusedLAMB().step_flat(None, torch.zeros(1))
    assert issubclass(FusedMixedPrecisionLamb, FusedLAMB)
    opt = FusedLAMB()
    state = opt.init({"w": torch.ones(3, 4)})
    with pytest.raises(ValueError, match="must match"):
        opt.step_flat(state, torch.zeros(7))
    with pytest.raises(ValueError, match="lane-aligned"):
        K.lamb_phase2_seg(state.params, state.params, torch.ones(1),
                          F.make_spec({"w": torch.ones(3, 4)}), 0.1)
