"""The port's ZeRO-2 optimizers (apex_tpu_torch.optimizers.
distributed_fused_adam) and the shard offsets of the segmented optimizer
kernels against the JAX package's, on the CPU.

The multi-rank cases run the port as 2 and 4 gloo ranks (one launcher
run a world size, tests/torch_dist_worker.py) and the JAX package on a
dp = 2 or 4 mesh of its 8-device CPU mesh, from the same seeded numpy
params and per-rank grads (rank r: base · (1 + 0.1 r)).

Tolerances: fp32 state, 2e-6 absolute on params of magnitude ~0.3 and
the same relative to the moments' largest magnitude (the ranks' grads
summed in another order; Adam's √v turns last-bit differences into
update differences of that size); bf16 state, one bf16 rounding (2^-8
of the largest magnitude); LAMB adds the trust ratios' per-tensor norms
(the port sums rows in fp64, the JAX package in fp32), 1e-5.  A gathered
state dict moves between the packages and shard counts bit for bit.
The shard helpers: row ids and expansions exactly, partial sums of
squares 1e-5 relative; the segmented kernels at a shard's row offset, run
shard by shard, give the whole-buffer call's bits."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.ops import optimizer_kernels as JK
from apex_tpu.optimizers import flat as JF
from apex_tpu.optimizers.distributed_fused_adam import (
    DistributedFusedAdam as JDAdam, DistributedFusedLAMB as JDLamb)
from apex_tpu.parallel import ddp as jddp
from apex_tpu.parallel import mesh as JM
from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import (DistributedFusedAdam,
                                       DistributedFusedLAMB)
from apex_tpu_torch.optimizers import flat as F

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORLDS = (2, 4)
# (name, kind, n_buckets, wd_mask, master dtype)
CONFIGS = [(f"adam_nb{nb}_{'mask' if mask else 'nomask'}", "adam", nb, mask,
            "fp32") for nb in (1, 2, 4) for mask in (False, True)]
CONFIGS += [("adam_nb2_mask_bf16", "adam", 2, True, "bf16"),
            ("lamb_nomask", "lamb", 1, False, "fp32"),
            ("lamb_mask", "lamb", 1, True, "fp32")]
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gpt_like(seed, n_layers=7, h=64):
    """229,824 params: past three FLAT_TILE shards, so at dp = 2 and 4
    tensors straddle the shard edges and every rank's rows hold
    parameters (the row offsets matter)."""
    rng = np.random.default_rng(seed)
    return {f"block{i}": {
        "w1": (rng.normal(size=(h, 4 * h)) * 0.3).astype(np.float32),
        "w2": (rng.normal(size=(4 * h, h)) * 0.3).astype(np.float32),
        "b": (rng.normal(size=(h,)) * 0.1).astype(np.float32)}
        for i in range(n_layers)}


def _mlp_params():
    rng = np.random.default_rng(0)
    return {"w1": (rng.normal(size=(8, 16)) * 0.3).astype(np.float32),
            "b1": (rng.normal(size=(16,)) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(16, 4)) * 0.3).astype(np.float32)}


def _batch():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(16, 8)).astype(np.float32),
            rng.normal(size=(16, 4)).astype(np.float32))


def _mesh(world):
    JM.destroy_model_parallel()
    return JM.initialize_model_parallel(devices=jax.devices()[:world])


def _jflat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _jopt(kind, world, nb, mask, dt, params):
    wd = W.decay_mask(params) if mask else None
    if kind == "adam":
        return JDAdam(num_shards=world, lr=1e-2, weight_decay=0.01,
                      n_buckets=nb, master_dtype=JDT[dt], wd_mask=wd)
    return JDLamb(num_shards=world, lr=1e-2, weight_decay=0.01,
                  master_dtype=JDT[dt], wd_mask=wd)


def _jax_zero(opt, world, params, base, steps=3):
    """`steps` JAX ZeRO steps from grads base · (1 + 0.1 r); returns the
    full params, the gathered state dict, the state and the mesh."""
    mesh = _mesh(world)
    sspec = opt.state_partition_specs()
    state = jax.jit(shard_map(opt.init, mesh=mesh, in_specs=(P(),),
                              out_specs=sspec, check_vma=False))(params)

    def local_step(state, g):
        rank = lax.axis_index("dp").astype(jnp.float32)
        grads = jax.tree_util.tree_map(lambda x: x * (1.0 + 0.1 * rank), g)
        return opt.step(state, grads)

    step = jax.jit(shard_map(local_step, mesh=mesh, in_specs=(sspec, P()),
                             out_specs=(P(), sspec), check_vma=False))
    full = None
    for _ in range(steps):
        full, state = step(state, base)
    sd = jax.jit(shard_map(opt.gather_state_dict, mesh=mesh,
                           in_specs=(sspec,), out_specs=P(),
                           check_vma=False))(state)
    return full, sd, state, mesh


def _jax_load(opt, world, gathered, base, steps=1):
    """The JAX package's state loaded from a gathered state dict on a dp =
    `world` mesh, `steps` steps from grads base · (1 + 0.1 r), gathered
    again."""
    mesh = _mesh(world)
    sspec = opt.state_partition_specs()
    # init fixes the layout; the loaded state replaces its values
    jax.jit(shard_map(opt.init, mesh=mesh, in_specs=(P(),),
                      out_specs=sspec, check_vma=False))(
        jax.tree_util.tree_map(jnp.asarray, gathered["params"]))
    jd = {"step": jnp.asarray(gathered["step"], jnp.int32),
          **{k: jax.tree_util.tree_map(jnp.asarray, gathered[k])
             for k in ("params", "exp_avg", "exp_avg_sq")}}
    state = jax.jit(shard_map(opt.load_gathered_state_dict, mesh=mesh,
                              in_specs=(P(),), out_specs=sspec,
                              check_vma=False))(jd)

    def local_step(state, g):
        rank = lax.axis_index("dp").astype(jnp.float32)
        grads = jax.tree_util.tree_map(lambda x: x * (1.0 + 0.1 * rank), g)
        return opt.step(state, grads)

    step = jax.jit(shard_map(local_step, mesh=mesh, in_specs=(sspec, P()),
                             out_specs=(P(), sspec), check_vma=False))
    for _ in range(steps):
        _, state = step(state, base)
    sd = jax.jit(shard_map(opt.gather_state_dict, mesh=mesh,
                           in_specs=(sspec,), out_specs=P(),
                           check_vma=False))(state)
    JM.destroy_model_parallel()
    return sd


def _inputs(world):
    x, y = _batch()
    params, base = _gpt_like(0), _gpt_like(1)
    # the JAX package's gathered state at the other shard count
    other = 4 if world == 2 else 2
    jopt = _jopt("adam", other, 2, False, "fp32", params)
    _, sd, _, _ = _jax_zero(jopt, other, params, base)
    JM.destroy_model_parallel()
    gathered = jax.tree_util.tree_map(np.asarray, sd)
    return {"scenarios": ["zero", "zero_step", "zero_load"],
            "zero": {"configs": CONFIGS, "params": params, "base": base},
            "zero_step": {"params": _mlp_params(), "x": x, "y": y},
            "zero_load": {"params": params, "base": base,
                          "gathered": gathered}}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"dp{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    d = tmp_path_factory.mktemp(f"zero{world}")
    inputs = _inputs(world)
    return world, inputs, W.run_ranks(str(d), world, inputs)


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("config", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_zero_optimizer_matches_jax(ranks, config):
    """Three DistributedFusedAdam (n_buckets 1, 2, 4; with and without
    wd_mask; bf16 master) and DistributedFusedLAMB (with and without
    wd_mask) steps: every rank's full params and the gathered moments
    equal the JAX package's, and the layout (padded total, shard size)
    is its layout."""
    world, inputs, outs = ranks
    outs = [o["zero"] for o in outs]
    name, kind, nb, mask, dt = config
    d = inputs["zero"]
    jopt = _jopt(kind, world, nb, mask, dt, d["params"])
    full, sd, jstate, _ = _jax_zero(jopt, world, d["params"], d["base"])
    JM.destroy_model_parallel()
    tol = 2 ** -8 if dt == "bf16" else (1e-5 if kind == "lamb" else 2e-6)
    atol = (lambda w: tol * max(np.abs(w).max(), 1.0)) if dt == "fp32" \
        else (lambda w: tol * np.abs(w).max())
    for r, out in enumerate(outs):
        for key, want in ((name, _jflat(full)),
                          (name + "_m", _jflat(sd["exp_avg"])),
                          (name + "_v", _jflat(sd["exp_avg_sq"]))):
            np.testing.assert_allclose(out[key], want, rtol=0,
                                       atol=atol(want),
                                       err_msg=f"{key} rank {r}")
        assert list(out[name + "_layout"]) == [
            jopt.padded_total, jstate.params_shard.shape[0] // world]
        np.testing.assert_array_equal(out[name], outs[0][name])


def test_zero_shards_are_the_jax_shards(ranks):
    """Rank r's shard of each configuration is the JAX package's rank-r
    slice of its sharded state (the same bucket-major layout)."""
    world, inputs, outs = ranks
    outs = [o["zero"] for o in outs]
    d = inputs["zero"]
    for name, kind, nb, mask, dt in CONFIGS[:4]:
        jopt = _jopt(kind, world, nb, mask, dt, d["params"])
        _, _, jstate, _ = _jax_zero(jopt, world, d["params"], d["base"])
        shards = np.asarray(jstate.params_shard, np.float32).reshape(
            world, -1)
        for r, out in enumerate(outs):
            _close(out[name + "_shard"], shards[r], 2e-6, f"{name} {r}")
    JM.destroy_model_parallel()


@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_zero_through_make_train_step(ranks, kind):
    """ZeRO-2 through make_train_step (DistributedFusedAdam n_buckets 2
    with wd_mask, DistributedFusedLAMB with wd_mask; O0 with a dynamic
    loss scale; an inf in the last rank's second batch): the optimizer's
    reduce-scatter is the sync, the overflow flag is OR-ed over the
    ranks, and the params and scaler equal the JAX step's."""
    world, inputs, outs = ranks
    outs = [o["zero_step"] for o in outs]
    d = inputs["zero_step"]
    x, y = d["x"], d["y"]
    jopt = _jopt(kind, world, 2, True, "fp32", d["params"])
    mesh = _mesh(world)
    sspec = jopt.state_partition_specs()
    state = jax.jit(shard_map(jopt.init, mesh=mesh, in_specs=(P(),),
                              out_specs=sspec, check_vma=False))(
                                  d["params"])
    amp_state = jamp.initialize(opt_level="O0", loss_scale="dynamic")
    scaler = amp_state.loss_scalers[0]

    def loss_fn(p, b):
        xb, yb = b
        h = jnp.tanh(xb @ p["w1"] + p["b1"])
        return jnp.mean((h @ p["w2"] - yb) ** 2)

    step = jddp.make_train_step(loss_fn, jopt, mesh, amp_state=amp_state,
                                batch_spec=(P("dp"), P("dp")), donate=False)
    per = x.shape[0] // world
    for i in range(3):
        xi = x.copy()
        if i == 1:
            xi[(world - 1) * per, 0] = np.inf
        state, scaler, _ = step(state, scaler, (xi, y))
    full = jax.jit(shard_map(jopt.full_params, mesh=mesh,
                             in_specs=(sspec,), out_specs=P(),
                             check_vma=False))(state)
    JM.destroy_model_parallel()
    tol = 1e-5 if kind == "lamb" else 2e-6
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[kind], _jflat(full), rtol=0,
                                   atol=tol, err_msg=f"rank {r}")
        assert list(out[kind + "_scaler"]) == [
            float(scaler.scale), float(scaler.growth_tracker),
            float(scaler.found_inf), float(state.step)] == [
                2.0 ** 15, 1.0, 0.0, 2.0]


def test_gathered_state_dict_moves_between_packages(ranks):
    """A JAX gathered state dict written at the other shard count (4 for
    dp = 2, 2 for dp = 4; two buckets) loads into the port at n_buckets 3
    and gathers back bit for bit; one more step from it equals the JAX
    package's step from the same state at the port's world size; the
    port's gathered state after that step loads into the JAX package at
    the other shard count and gathers back bit for bit."""
    world, inputs, outs = ranks
    outs = [o["zero_load"] for o in outs]
    d = inputs["zero_load"]
    g = d["gathered"]
    for out in outs:
        np.testing.assert_array_equal(out["params"], _jflat(g["params"]))
        np.testing.assert_array_equal(out["m"], _jflat(g["exp_avg"]))
        np.testing.assert_array_equal(out["v"], _jflat(g["exp_avg_sq"]))
        assert int(out["step"]) == int(g["step"]) == 3
    # the next step: the JAX package at the port's world size and
    # n_buckets, from the same gathered state
    jopt = _jopt("adam", world, 3, False, "fp32", d["params"])
    sd = _jax_load(jopt, world, g, d["base"])
    for r, out in enumerate(outs):
        for key, want in (("next_params", sd["params"]),
                          ("next_m", sd["exp_avg"]),
                          ("next_v", sd["exp_avg_sq"])):
            _close(out[key], _jflat(want), 2e-6, f"{key} rank {r}")
    # and back: the port's gathered state into the JAX package at the
    # other shard count
    ported = outs[0]["gathered"]
    other = 4 if world == 2 else 2
    jopt = _jopt("adam", other, 2, False, "fp32", d["params"])
    back = _jax_load(jopt, other, ported, d["base"], steps=0)
    for k in ("params", "exp_avg", "exp_avg_sq"):
        np.testing.assert_array_equal(_jflat(back[k]), _jflat(ported[k]))
    assert int(back["step"]) == 4


# -------------------------- single-process checks ---------------------------

def _straddling():
    """A lane-aligned layout whose tensors straddle the edges of 4 shards
    of 512 rows (padded_total = 4 · FLAT_TILE)."""
    rng = np.random.default_rng(5)
    shapes = {"a": (700, 128), "b": (3, 100), "c": (900, 128),
              "d": (77,), "e": (300, 128)}
    return {k: (rng.normal(size=s) * 0.5).astype(np.float32)
            for k, s in shapes.items()}


def test_shard_helpers_match_jax():
    """shard_segment_ids, per_tensor_sumsq_shard and
    expand_per_tensor_shard per rank of 4 equal the JAX package's (its
    jnp path, and its Pallas kernel in interpret mode for the sums); the
    ranks' partial sums add up to the whole buffer's per-tensor sums."""
    params = _straddling()
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    spec = F.make_spec(tparams, align=128)
    jspec = JF.make_spec(jax.tree_util.tree_map(jnp.asarray, params),
                         align=128)
    shards = 4
    total = shards * K.FLAT_TILE
    flat = F.flatten(tparams, torch.float32, pad_to=total, align=128)
    assert flat.numel() == total
    rows = total // shards // 128
    vals = np.arange(1, len(spec.sizes) + 1, dtype=np.float32) * 0.5
    sums = torch.zeros(len(spec.sizes))
    for r in range(shards):
        seg = K.shard_segment_ids(spec, r, rows, total)
        jseg = JK.shard_segment_ids(jspec, r, rows, total)
        np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
        shard = flat[r * rows * 128:(r + 1) * rows * 128]
        got = K.per_tensor_sumsq_shard(shard, spec, r, total)
        jshard = jnp.asarray(shard.numpy())
        for pallas in (False, True):
            want = JK.per_tensor_sumsq_shard(jshard, jspec, r, total,
                                             use_pallas_override=pallas)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-30)
        sums += got
        np.testing.assert_array_equal(
            K.expand_per_tensor_shard(torch.from_numpy(vals), seg).numpy(),
            np.asarray(JK.expand_per_tensor_shard(jnp.asarray(vals),
                                                  jseg)))
    whole = K._rows_sumsq_reference(flat, spec)
    np.testing.assert_allclose(sums.numpy(), whole.numpy(), rtol=1e-6)


def test_segmented_kernels_at_shard_offsets():
    """adam_flat_seg, lamb_phase1_seg and lamb_phase2_seg run shard by
    shard at their row offsets (4 shards, tensors straddling the edges)
    give the whole-buffer call's bits, and each shard equals the JAX
    package's function at the same row offset within a few fp32 ulps
    (XLA contracts multiply-adds into fmas)."""
    params = _straddling()
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    spec = F.make_spec(tparams, align=128)
    jspec = JF.make_spec(jax.tree_util.tree_map(jnp.asarray, params),
                         align=128)
    shards, total = 4, 4 * K.FLAT_TILE
    size = total // shards
    rng = np.random.default_rng(6)
    p = F.flatten(tparams, torch.float32, pad_to=total, align=128)
    real = p != 0
    m = torch.from_numpy(rng.normal(size=total).astype(np.float32)) * 0.01
    v = torch.from_numpy(np.abs(rng.normal(size=total)).astype(np.float32)
                         ) * 1e-4
    g = torch.from_numpy(rng.normal(size=total).astype(np.float32))
    m, v, g = (torch.where(real, x, 0.0) for x in (m, v, g))
    n_t = len(spec.sizes)
    wd = np.where(np.arange(n_t) % 2 == 0, 0.01, 0.0).astype(np.float32)
    lrs = (0.5 + np.arange(n_t) / n_t).astype(np.float32)
    ratio = (1.0 + np.arange(n_t) / 10).astype(np.float32)
    adam_kw = dict(wd_values=wd, lr_scale_values=lrs, spec=spec)
    lamb_kw = dict(wd_values=wd, spec=spec, beta1=0.9, beta2=0.999,
                   eps=1e-6)

    def whole_and_shards(fn):
        whole = fn(None, p.clone(), m.clone(), v.clone(), g)
        parts = [fn(r, *(x[r * size:(r + 1) * size].clone()
                         for x in (p, m, v)), g[r * size:(r + 1) * size])
                 for r in range(shards)]
        for i, w in enumerate(whole):
            assert torch.equal(torch.cat([pt[i] for pt in parts]), w)
        return parts

    def off(r):
        return {} if r is None else {"row_offset": r * size // 128,
                                     "padded_total": total}

    adam = whole_and_shards(lambda r, p_, m_, v_, g_: K.adam_flat_seg(
        p_, m_, v_, g_, 1e-2, 3, **adam_kw, **off(r)))
    lamb1 = whole_and_shards(lambda r, p_, m_, v_, g_: K.lamb_phase1_seg(
        m_, v_, g_, p_, 0.7, 3, **lamb_kw, **off(r)))
    lamb2 = whole_and_shards(lambda r, p_, m_, v_, g_: (K.lamb_phase2_seg(
        p_, m_, torch.from_numpy(ratio), spec, 1e-2, **off(r)),))
    for r in range(shards):
        sl = slice(r * size, (r + 1) * size)
        jp, jm, jv, jg = (jnp.asarray(x[sl].numpy()) for x in (p, m, v, g))
        jo = dict(row_offset=r * size // 128, padded_total=total,
                  use_pallas_override=False)
        want = JK.adam_flat_seg(jp, jm, jv, jg, 1e-2, 3.0, wd_values=wd,
                                lr_scale_values=lrs, spec=jspec, **jo)
        want += JK.lamb_phase1_seg(jm, jv, jg, jp, 0.7, 3.0, wd_values=wd,
                                   spec=jspec, beta1=0.9, beta2=0.999,
                                   eps=1e-6, **jo)
        want += (JK.lamb_phase2_seg(jp, jm, jnp.asarray(ratio), jspec,
                                    1e-2, **jo),)
        for got, w in zip(adam[r] + lamb1[r] + lamb2[r], want):
            _close(got.numpy(), np.asarray(w), 1e-6, f"shard {r}")


def test_zero_refusals_and_world_of_one():
    """num_shards must be the group's size (here a world of one); an
    ep_shards that does not divide num_shards raises the JAX package's
    ValueError, the combined ("dp", "ep") axes are taken (at ep = 1 the
    dp group: the world of one) and another axis name is refused; a
    checkpoint of another bucket count is refused; at one rank the ZeRO
    step is FusedAdam's."""
    from apex_tpu_torch.optimizers import FusedAdam

    params = {k: torch.from_numpy(v) for k, v in _mlp_params().items()}
    with pytest.raises(ValueError, match="num_shards"):
        DistributedFusedAdam(2).init(params)
    msg = r"ep_shards=2 must be >= 1 and divide num_shards=1"
    with pytest.raises(ValueError, match=msg):
        DistributedFusedAdam(1, ep_shards=2)
    with pytest.raises(ValueError, match=msg):
        JDAdam(num_shards=1, ep_shards=2)
    lamb = DistributedFusedLAMB(1, axis_name=("dp", "ep"))
    lamb.init(params)
    assert "ep_shards" not in lamb.shard_layout()
    with pytest.raises(ValueError, match="axis_name"):
        DistributedFusedAdam(1, axis_name="tp")
    opt = DistributedFusedAdam(1, lr=1e-2, n_buckets=2)
    state = opt.init(params)
    with pytest.raises(ValueError, match="n_buckets"):
        DistributedFusedAdam(1, n_buckets=1).load_state_dict(
            opt.state_dict(state))
    ref = FusedAdam(lr=1e-2)
    rstate = ref.init(params)
    grads = {k: v * 0.5 for k, v in params.items()}
    for _ in range(2):
        full, state = opt.step(state, grads)
        _, rstate = ref.step(rstate, grads)
    for k, leaf in F.unflatten(rstate.params, ref.spec).items():
        assert torch.equal(full[k], leaf)
    lay = opt.shard_layout()
    assert (lay["num_shards"], lay["n_buckets"], lay["total"]) == (
        1, 2, sum(v.numel() for v in params.values()))
