"""The PyTorch port's flat buffers, Adam kernel contracts (uniform and
per-tensor) and FusedAdam (apex_tpu_torch.optimizers,
apex_tpu_torch.ops.optimizer_kernels) against the JAX package's, on the
CPU.

The JAX side runs its Pallas Adam kernels in interpret mode
(`use_pallas_override=True`); the port's side runs its plain PyTorch
version (what CPU tensors get), in place.  The same seeded numpy inputs
go to both.  Tolerances: fp32 state rtol 1e-6 / atol 1e-7 (the same
fp32 formula evaluated in another order; the moments cancel to values
far below their operands, ~0.1-3, so an absolute term near one fp32 ulp
of the operands is needed); bf16 state at most one bf16 ulp plus that
same 1e-7 (the fp32 results may round to neighbouring bf16 values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.optimizer_kernels import FLAT_TILE as JAX_FLAT_TILE
from apex_tpu.ops.optimizer_kernels import adam_flat as jax_adam_flat
from apex_tpu.ops.optimizer_kernels import adam_flat_seg as jax_adam_flat_seg
from apex_tpu.optimizers import flat as jax_flat
from apex_tpu.optimizers.fused_adam import FusedAdam as JaxFusedAdam
from apex_tpu.transformer.pipeline_parallel.common import (
    get_params_for_weight_decay_optimization as jax_wd_mask)
from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.pipeline_parallel import (
    get_params_for_weight_decay_optimization)

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


@pytest.mark.parametrize("dtype,wd,adam_w", [
    ("f32", 0.0, True), ("f32", 0.01, False), ("bf16", 0.0, True),
    ("bf16", 0.01, True)])
def test_adam_flat_matches_jax_kernel(dtype, wd, adam_w):
    """Four steps over a buffer that is not a whole number of tiles; step
    3 carries found_inf with an inf in the grads and must leave p, m, v
    exactly as they were."""
    jdt, tdt = _DTYPES[dtype]
    n = 3001
    rng = np.random.RandomState(7)
    p0 = rng.randn(n).astype(np.float32)
    jp, jm, jv = (jnp.asarray(p0).astype(jdt),
                  jnp.zeros(n, jdt), jnp.zeros(n, jdt))
    tp = torch.tensor(p0).to(tdt)
    tm, tv = torch.zeros(n, dtype=tdt), torch.zeros(n, dtype=tdt)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd,
              adam_w_mode=adam_w, inv_scale=0.5)
    step = 0
    for i in range(4):
        g = (rng.randn(n) * 3).astype(np.float32)
        found = i == 2
        if found:
            g[5] = np.inf
        else:
            step += 1
        jp, jm, jv = jax_adam_flat(jp, jm, jv, jnp.asarray(g).astype(jdt),
                                   1e-2, float(step), found_inf=found,
                                   use_pallas_override=True, **kw)
        before = (tp.clone(), tm.clone(), tv.clone())
        out = K.adam_flat(tp, tm, tv, torch.tensor(g).to(tdt), 1e-2, step,
                          found_inf=found, **kw)
        assert all(a is b for a, b in zip(out, (tp, tm, tv)))  # in place
        if found:
            assert all(torch.equal(a, b)
                       for a, b in zip((tp, tm, tv), before))
        for got, want, what in ((tp, jp, "p"), (tm, jm, "m"),
                                (tv, jv, "v")):
            _assert_state_close(got, want, dtype, f"step {i} {what}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_adam_matches_jax_with_skipped_first_step(dtype):
    """FusedAdam over a parameter tree from the same weights and grads
    as the JAX FusedAdam: the first step overflows (found_inf), so the
    step count stays 0 and p, m, v are untouched (the bias-correction
    clamp keeps 1/bc finite), then three steps update."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.RandomState(11)
    shapes = {"block2": {"fc1": {"weight": (8, 16), "bias": (16,)}},
              "block10": {"qkv": {"weight": (8, 24)}}, "pos": (5, 8)}

    def tree(fn, spec=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in spec.items()}

    w = tree(lambda s: rng.randn(*s).astype(np.float32))
    jopt = JaxFusedAdam(lr=1e-3, weight_decay=0.01, master_dtype=jdt,
                        use_pallas=True)
    topt = FusedAdam(lr=1e-3, weight_decay=0.01, master_dtype=tdt)
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, w))
    tstate = topt.init(jax.tree_util.tree_map(torch.tensor, w))
    assert np.array_equal(_np(jstate.params), tstate.params.float().numpy())
    for i in range(4):
        g = tree(lambda s: rng.randn(*s).astype(np.float32))
        found = i == 0
        if found:
            g["pos"][0, 0] = np.nan
        kept = tstate.params.clone()
        _, jstate = jopt.step(jstate, jax.tree_util.tree_map(jnp.asarray, g),
                              found_inf=found)
        tparams, tstate = topt.step(
            tstate, jax.tree_util.tree_map(torch.tensor, g),
            found_inf=found)
        assert int(tstate.step) == int(jstate.step) == i
        if found:
            assert torch.equal(tstate.params, kept)
            assert not torch.any(tstate.exp_avg != 0)
        for got, want, what in (
                (tstate.params, jstate.params, "p"),
                (tstate.exp_avg, jstate.exp_avg, "m"),
                (tstate.exp_avg_sq, jstate.exp_avg_sq, "v")):
            _assert_state_close(got, want, dtype, f"step {i} {what}")
    # with fp32 leaves and an fp32 master the returned tree is views of
    # the updated buffer; a bf16 master hands back fp32 copies
    leaf = tparams["block2"]["fc1"]["weight"]
    shares = (leaf.untyped_storage().data_ptr()
              == tstate.params.untyped_storage().data_ptr())
    assert shares == (dtype == "f32") and leaf.dtype == torch.float32


def test_flat_spec_leaf_order_is_jax():
    """The same tree gives the same spec in both packages: key paths in
    JAX's sorted-key order (block10 before block2, fc1 before qkv, bias
    before weight), shapes, offsets (aligned too) and totals — so flat
    buffers, and later checkpoints, map element for element."""
    rng = np.random.RandomState(0)
    tree = {"block2": {"qkv": {"weight": rng.randn(4, 12),
                               "bias": rng.randn(12)},
                       "fc1": {"weight": rng.randn(4, 16),
                               "bias": rng.randn(16)}},
            "block10": {"ln1": {"weight": rng.randn(4),
                                "bias": rng.randn(4)}},
            "pos_embed": rng.randn(3, 4), "embed": {"weight": rng.randn(9, 4)}}
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                   tree)
    ttree = jax.tree_util.tree_map(lambda a: torch.tensor(a).float(), tree)
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jtree)[0]]
    for align in (1, 128):
        js = jax_flat.make_spec(jtree, align=align)
        ts = F.make_spec(ttree, align=align)
        assert list(ts.paths) == jpaths
        assert ts.paths[0] == ("block10", "ln1", "bias")
        assert ts.paths[2] == ("block2", "fc1", "bias")
        assert (ts.shapes, ts.sizes, ts.offsets, ts.total) == (
            js.shapes, js.sizes, js.offsets, js.total)
        jbuf = jax_flat.flatten(jtree, pad_to=JAX_FLAT_TILE, align=align)
        tbuf = F.flatten(ttree, pad_to=K.FLAT_TILE, align=align)
        assert K.FLAT_TILE == JAX_FLAT_TILE
        np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))


def test_flatten_unflatten_round_trip_and_views():
    rng = np.random.RandomState(1)
    tree = {"b": {"w": torch.tensor(rng.randn(3, 5), dtype=torch.bfloat16)},
            "a": {"x": torch.tensor(rng.randn(7)).float(),
                  "y": torch.tensor(rng.randn(2, 2)).float()}}
    spec = F.make_spec(tree, align=4)
    flat = F.flatten(tree, torch.float32, pad_to=64, align=4)
    assert flat.numel() == 64 and spec.total == 8 + 4 + 16
    back = F.unflatten(flat, spec)
    assert back["b"]["w"].dtype == torch.bfloat16     # cast back
    for got, want in zip(F.tree_leaves(back), F.tree_leaves(tree)):
        assert torch.equal(got, want)
    # same dtype → views: an in-place update of the buffer shows through
    views = F.unflatten(flat, spec)
    flat.add_(1.0)
    assert torch.equal(views["a"]["x"], tree["a"]["x"] + 1.0)
    assert torch.all(flat[7:8] == 1.0)                # padding untouched
    # a list of tensors flattens in its own order
    assert torch.equal(F.flatten([tree["a"]["y"], tree["a"]["x"]]),
                       torch.cat([tree["a"]["y"].reshape(-1),
                                  tree["a"]["x"]]))


def test_fused_adam_refuses_what_is_not_ported():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(amsgrad=True)
    with pytest.raises(RuntimeError, match="init"):
        FusedAdam().step_flat(None, torch.zeros(1))


# a tree of mixed leaves: lengths that are and are not multiples of 128,
# matrices (decayed under the no-decay recipe) and biases / norms (not)
_SEG_SHAPES = {"block2": {"fc1": {"weight": (8, 16), "bias": (16,)},
                          "ln1": {"weight": (130,), "bias": (130,)}},
               "block10": {"qkv": {"weight": (8, 24)}}, "pos": (5, 8),
               "embed": {"weight": (40, 9)}}


def _seg_tree(fn, spec=_SEG_SHAPES):
    return {k: _seg_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in spec.items()}


@pytest.mark.parametrize("dtype,adam_w", [("f32", True), ("f32", False),
                                          ("bf16", True), ("bf16", False)])
def test_adam_flat_seg_matches_jax_kernel(dtype, adam_w):
    """Four steps of the per-tensor update over a lane-aligned flat
    buffer of one FLAT_TILE (so the JAX side runs its Pallas kernel),
    with the no-decay weight decay and per-tensor lr scales in
    [0.5, 1.5); step 3 carries found_inf with an inf in the grads and
    must leave p, m, v exactly as they were; the padding tail (the
    lane-alignment rows and the tile's end) never moves from zero."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.RandomState(13)
    w = _seg_tree(lambda s: rng.randn(*s).astype(np.float32))
    jspec = jax_flat.make_spec(jax.tree_util.tree_map(jnp.asarray, w),
                               align=128)
    tspec = F.make_spec(jax.tree_util.tree_map(torch.tensor, w), align=128)
    assert tspec.offsets == tuple(jspec.offsets)
    assert tspec.total == jspec.total
    jp = jax_flat.flatten(jax.tree_util.tree_map(jnp.asarray, w), jdt,
                          pad_to=JAX_FLAT_TILE, align=128)
    tp = F.flatten(jax.tree_util.tree_map(torch.tensor, w), tdt,
                   pad_to=K.FLAT_TILE, align=128)
    n = tp.numel()
    assert n == jp.shape[0] == JAX_FLAT_TILE
    real = np.zeros(n, bool)
    for off, size in zip(tspec.offsets, tspec.sizes):
        real[off:off + size] = True
    n_seg = len(tspec.sizes)
    wd = 0.01 * np.asarray(
        [float(x) for x in jax.tree_util.tree_leaves(jax_wd_mask(w))],
        np.float32)
    assert 0 < int((wd > 0).sum()) < n_seg
    lrs = (0.5 + rng.rand(n_seg)).astype(np.float32)
    jm, jv = jnp.zeros(n, jdt), jnp.zeros(n, jdt)
    tm, tv = torch.zeros(n, dtype=tdt), torch.zeros(n, dtype=tdt)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, adam_w_mode=adam_w,
              inv_scale=0.5)
    step = 0
    for i in range(4):
        g = np.where(real, rng.randn(n) * 3, 0.0).astype(np.float32)
        found = i == 2
        if found:
            g[5] = np.inf
        else:
            step += 1
        jp, jm, jv = jax_adam_flat_seg(
            jp, jm, jv, jnp.asarray(g).astype(jdt), 1e-2, float(step),
            wd_values=wd, lr_scale_values=lrs, spec=jspec,
            found_inf=found, use_pallas_override=True, **kw)
        before = (tp.clone(), tm.clone(), tv.clone())
        out = K.adam_flat_seg(tp, tm, tv, torch.tensor(g).to(tdt), 1e-2,
                              step, wd_values=wd, lr_scale_values=lrs,
                              spec=tspec, found_inf=found, **kw)
        assert all(a is b for a, b in zip(out, (tp, tm, tv)))  # in place
        if found:
            assert all(torch.equal(a, b)
                       for a, b in zip((tp, tm, tv), before))
        for got, want, what in ((tp, jp, "p"), (tm, jm, "m"),
                                (tv, jv, "v")):
            _assert_state_close(got, want, dtype, f"step {i} {what}")
            assert not torch.any(got[torch.tensor(~real)] != 0), what


def test_adam_flat_seg_refuses_wrong_tables_and_layouts():
    tree = {"a": torch.zeros(3, 5), "b": torch.zeros(7)}
    spec = F.make_spec(tree, align=128)
    buf = F.flatten(tree, pad_to=K.FLAT_TILE, align=128)
    bufs = [buf.clone() for _ in range(4)]
    with pytest.raises(ValueError, match="3 wd values for 2 tensors"):
        K.adam_flat_seg(*bufs, 1e-3, 1, wd_values=[0.0] * 3,
                        lr_scale_values=[1.0] * 2, spec=spec)
    with pytest.raises(ValueError, match="1 lr scales for 2 tensors"):
        K.adam_flat_seg(*bufs, 1e-3, 1, wd_values=[0.0] * 2,
                        lr_scale_values=[1.0], spec=spec)
    with pytest.raises(ValueError, match="lane-aligned"):
        K.adam_flat_seg(*bufs, 1e-3, 1, wd_values=[0.0] * 2,
                        lr_scale_values=[1.0] * 2,
                        spec=F.make_spec(tree))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_adam_per_leaf_groups_match_jax(dtype):
    """FusedAdam(wd_mask=get_params_for_weight_decay_optimization(params),
    lr_scales=...) against the JAX FusedAdam (Pallas in interpret mode)
    for three steps from the same weights and grads: the lane-aligned
    layout, the per-tensor values resolved at init and the state after
    each step."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.RandomState(17)
    w = _seg_tree(lambda s: rng.randn(*s).astype(np.float32))
    scales = _seg_tree(lambda s: float(0.5 + rng.rand()))
    jw = jax.tree_util.tree_map(jnp.asarray, w)
    tw = jax.tree_util.tree_map(torch.tensor, w)
    jopt = JaxFusedAdam(lr=1e-3, weight_decay=0.01, master_dtype=jdt,
                        use_pallas=True, wd_mask=jax_wd_mask(jw),
                        lr_scales=scales)
    topt = FusedAdam(lr=1e-3, weight_decay=0.01, master_dtype=tdt,
                     wd_mask=get_params_for_weight_decay_optimization(tw),
                     lr_scales=scales)
    jstate = jopt.init(jw)
    tstate = topt.init(tw)
    assert topt.spec.align == 128
    np.testing.assert_array_equal(topt._seg_wd.numpy(),
                                  np.asarray(jopt._seg_wd))
    np.testing.assert_array_equal(topt._seg_lrs.numpy(),
                                  np.asarray(jopt._seg_lrs))
    assert np.array_equal(_np(jstate.params), tstate.params.float().numpy())
    for i in range(3):
        g = _seg_tree(lambda s: rng.randn(*s).astype(np.float32))
        _, jstate = jopt.step(jstate, jax.tree_util.tree_map(jnp.asarray, g))
        tparams, tstate = topt.step(tstate,
                                    jax.tree_util.tree_map(torch.tensor, g))
        assert int(tstate.step) == int(jstate.step) == i + 1
        for got, want, what in (
                (tstate.params, jstate.params, "p"),
                (tstate.exp_avg, jstate.exp_avg, "m"),
                (tstate.exp_avg_sq, jstate.exp_avg_sq, "v")):
            _assert_state_close(got, want, dtype, f"step {i} {what}")
    assert tparams["block2"]["ln1"]["bias"].shape == (130,)
