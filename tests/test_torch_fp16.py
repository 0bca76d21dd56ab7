"""The rest of the port's amp (apex_tpu_torch.amp.fp16_optimizer,
apex_tpu_torch.fp16_utils, apex_tpu_torch.transformer.amp and O2 through
parallel.ddp.make_train_step) against the JAX package's, on the CPU.

The multi-rank cases run the port as 2 and 4 gloo ranks (one launcher
run a world size, tests/torch_dist_worker.py) and the JAX package on a
dp = 2 or 4 mesh of its 8-device CPU mesh.

Tolerances: FP16_Optimizer (fp32 masters) 2e-6 absolute on params of
magnitude ~0.3; the scalers exactly (powers of two).  O2 (bf16 params and
compute): the port keeps the batch-norm params fp32 in the step, as
apex's keep_batchnorm_fp32 does, while the JAX step rounds them to bf16,
and the two round the bf16 products in other places, so the masters'
updates agree within 1e-2 of the update's norm (measured 2.3e-3 to
2.7e-3)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu import fp16_utils as jfp16
from apex_tpu.amp import scaler as jscaler
from apex_tpu.amp.fp16_optimizer import FP16_Optimizer as JFP16
from apex_tpu.optimizers.fused_adam import FusedAdam as JAdam
from apex_tpu.optimizers.fused_sgd import FusedSGD as JSGD
from apex_tpu.parallel import ddp as jddp
from apex_tpu.parallel import mesh as JM
from apex_tpu.parallel.sync_batchnorm import sync_batch_norm as jbn
from apex_tpu.transformer.amp import GradScaler as JGradScaler
from apex_tpu_torch import amp, fp16_utils
from apex_tpu_torch.amp.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.transformer.amp import GradScaler

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORLDS = (2, 4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(8, 16)) * 0.3).astype(np.float32),
            "b1": (rng.normal(size=(16,)) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(16, 4)) * 0.3).astype(np.float32)}


def _bn_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(8, 16)) * 0.3).astype(np.float32),
            "bn": {"scale": np.ones(16, np.float32),
                   "bias": np.zeros(16, np.float32)},
            "w2": (rng.normal(size=(16, 4)) * 0.3).astype(np.float32)}


def _grads(world, seed=2):
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=v.shape) * (1 + r)).astype(np.float32)
             for k, v in _params().items()} for r in range(world)]


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(16, 8)).astype(np.float32),
            rng.normal(size=(16, 4)).astype(np.float32))


def _mp_layouts(world):
    """(pp, tp, the rank whose gradient overflows) of each found_inf
    layout: dp = world (tp = pp = 1) in both worlds, pp 2 x tp 2 at 4."""
    out = [(1, 1, world - 1)]
    if world == 4:
        out.append((2, 2, 3))
    return out


def _inputs(world):
    x, y = _batch()
    return {"scenarios": ["found_inf", "found_inf_mp", "fp16opt", "o2"],
            "found_inf": {},
            "found_inf_mp": {"layouts": _mp_layouts(world)},
            "fp16opt": {"params": _params(), "grads": _grads(world)},
            "o2": {"params": _bn_params(), "x": x, "y": y}}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"dp{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    d = tmp_path_factory.mktemp(f"fp16_{world}")
    inputs = _inputs(world)
    return world, inputs, W.run_ranks(str(d), world, inputs)


def _mesh(world):
    JM.destroy_model_parallel()
    return JM.initialize_model_parallel(devices=jax.devices()[:world])


def _jflat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _tree(a, dtype=torch.float32):
    return {k: (_tree(v, dtype) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)).to(dtype))
            for k, v in a.items()}


# ------------------------------ FP16_Optimizer ------------------------------

def _jax_fp16(grads_seq, params):
    """The JAX FP16_Optimizer(FusedAdam) over a sequence of mean grads,
    scale from 2^4, the second step's grads overflowing, the third
    clipped at 0.5 (as scn_fp16opt)."""
    opt = JFP16(JAdam(lr=1e-2), dynamic_loss_scale=True)
    opt.scaler_state = jscaler.init("dynamic", init_scale=16.0)
    state = opt.init(jax.tree_util.tree_map(jnp.asarray, params))
    for i, g in enumerate(grads_seq):
        g = {k: jnp.asarray(v) * opt.scaler_state.scale for k, v in g.items()}
        if i == 1:
            g["w1"] = g["w1"].at[0, 0].set(jnp.inf)
        _, state = opt.step(state, g, max_grad_norm=0.5 if i == 2 else None)
    return opt, state


def test_fp16_optimizer_on_synced_grads(ranks):
    """FP16_Optimizer(FusedAdam) on grads averaged over the ranks by
    sync_gradients: an overflow on one rank skips the step on every rank
    and halves the scale; the third step clips by the global norm; every
    rank's masters equal the JAX facade's on the mean grads."""
    world, inputs, outs = ranks
    outs = [o["fp16opt"] for o in outs]
    d = inputs["fp16opt"]
    mean = {k: np.mean([g[k] for g in d["grads"]], axis=0)
            for k in d["params"]}
    jopt, jstate = _jax_fp16([mean] * 3, d["params"])
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["params"],
                                   np.asarray(jstate.params), rtol=0,
                                   atol=2e-6, err_msg=f"rank {r}")
        assert float(out["scale"]) == jopt.loss_scale == 8.0
        assert int(out["step"]) == int(jstate.step) == 2


def test_fp16_optimizer_one_process_and_state_dict():
    """On one process: the same steps against the JAX facade; its state
    dict (the inner optimizer's masters and the scaler) restores into a
    new facade that then steps as the first one does; `step(metrics=)`
    folds the scale used, the unscaled grad norm and the step count in,
    and refuses what is not a MetricsState before it touches the state
    or the scale."""
    params, g = _params(), _grads(1)[0]
    opt = FP16_Optimizer(FusedAdam(lr=1e-2), dynamic_loss_scale=True,
                         device="cpu")
    opt.scaler_state = amp.scaler.init("dynamic", init_scale=16.0,
                                       device="cpu")
    state = opt.init(_tree(params))
    for i in range(3):
        gi = {k: v * opt.scaler_state.scale for k, v in _tree(g).items()}
        if i == 1:
            gi["w1"][0, 0] = float("inf")
        _, state = opt.step(state, gi, max_grad_norm=0.5 if i == 2 else None)
    jopt, jstate = _jax_fp16([g] * 3, params)
    np.testing.assert_allclose(state.params.numpy(),
                               np.asarray(jstate.params), rtol=0, atol=2e-6)
    assert opt.loss_scale == jopt.loss_scale == 8.0
    sd = opt.state_dict(state)
    assert sd["loss_scaler"] == jopt.state_dict(jstate)["loss_scaler"]
    again = FP16_Optimizer(FusedAdam(lr=1e-2), dynamic_loss_scale=True,
                           device="cpu")
    again.init(_tree(params))
    restored = again.load_state_dict(sd)
    assert again.loss_scale == 8.0
    gs = {k: v * 8.0 for k, v in _tree(g).items()}
    _, a = opt.step(state, {k: v.clone() for k, v in gs.items()})
    _, b = again.step(restored, gs)
    assert torch.equal(a.params, b.params)
    from apex_tpu_torch import monitor
    _, a, m = opt.step(a, {k: v.clone() for k, v in gs.items()},
                       metrics=monitor.init_metrics("cpu"))
    assert int(m.step) == 1 and float(m.loss_scale) == 8.0
    assert int(m.overflow_count) == 0 and float(m.update_norm) > 0
    gnorm = np.sqrt(sum(float(np.sum(np.square(v))) for v in g.values()))
    np.testing.assert_allclose(float(m.grad_norm), gnorm, rtol=1e-5)
    before = (a.params.clone(), a.exp_avg.clone(), a.step.clone(),
              opt.scaler_state.scale.clone())
    with pytest.raises(TypeError, match="MetricsState"):
        opt.step(a, gs, metrics=object())
    after = (a.params, a.exp_avg, a.step, opt.scaler_state.scale)
    assert all(torch.equal(x, y) for x, y in zip(before, after)), \
        "the refused step changed the state or the scale"


# --------------------------- fp16_utils, GradScaler --------------------------

def test_fp16_utils_match_jax():
    """network_to_half (norm leaves kept fp32), to_python_float, the
    static and dynamic loss scalers through overflow, backoff and growth,
    against the JAX package's facade."""
    p = _bn_params()
    half = fp16_utils.network_to_half(_tree(p))
    jhalf = jfp16.network_to_half(jax.tree_util.tree_map(jnp.asarray, p))
    for (path, leaf), jleaf in zip(F.tree_leaves_with_paths(half),
                                   jax.tree_util.tree_leaves(jhalf)):
        assert str(leaf.dtype).split(".")[-1] == str(jleaf.dtype), path
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(jleaf, np.float32))
    assert fp16_utils.to_python_float(torch.tensor([2.5])) == 2.5 == \
        jfp16.to_python_float(jnp.asarray([2.5]))
    st, jst = fp16_utils.LossScaler(128.0, device="cpu"), \
        jfp16.LossScaler(128.0)
    g, found = st.unscale({"a": torch.tensor([256.0, float("inf")])})
    jg, jfound = jst.unscale({"a": jnp.asarray([256.0, np.inf])})
    np.testing.assert_array_equal(g["a"].numpy(), np.asarray(jg["a"]))
    assert bool(found) is bool(jfound) is True
    st.update_scale(found)
    jst.update_scale(jfound)
    assert st.loss_scale == jst.loss_scale == 128.0
    assert float(st.scale_loss(torch.tensor(3.0))) == 384.0
    dyn = fp16_utils.DynamicLossScaler(init_scale=2.0 ** 10, scale_window=2,
                                       device="cpu")
    jdyn = jfp16.DynamicLossScaler(init_scale=2.0 ** 10, scale_window=2)
    scales = []
    for overflow in (True, False, False, False, True, False, False):
        dyn.update_scale(torch.tensor(overflow))
        jdyn.update_scale(jnp.asarray(overflow))
        assert dyn.loss_scale == jdyn.loss_scale
        scales.append(dyn.loss_scale)
    assert scales == [512.0, 512.0, 1024.0, 1024.0, 512.0, 512.0, 1024.0]


def test_grad_scaler_matches_jax():
    """GradScaler: scale, unscale_and_sync (a world of one: the flag as it
    is) and the dynamic update through an overflow and growth, against
    the JAX package's GradScaler on a one-device mesh."""
    gs = GradScaler(init_scale=8.0, growth_interval=2, device="cpu")
    jgs = JGradScaler(init_scale=8.0, growth_interval=2)
    mesh = _mesh(1)
    assert float(gs.scale(torch.tensor(2.0))) == float(
        jgs.scale(jnp.asarray(2.0))) == 16.0
    for bad in (False, True, False, False):
        g = {"a": torch.tensor([8.0, float("nan") if bad else 4.0])}
        grads, found = gs.unscale_and_sync(g)
        jgrads, jfound = jax.jit(shard_map(
            lambda t: jgs.unscale_and_sync(t), mesh=mesh, in_specs=(P(),),
            out_specs=P(), check_vma=False))(
                {"a": jnp.asarray(g["a"].numpy())})
        np.testing.assert_array_equal(grads["a"].numpy(),
                                      np.asarray(jgrads["a"]))
        assert bool(found) is bool(jfound) is bad
        gs.update(found)
        jgs.update(jfound)
        assert float(gs.state.scale) == float(jgs.state.scale)
    JM.destroy_model_parallel()
    assert float(gs.state.scale) == 8.0


def test_found_inf_is_or_ed_over_ranks(ranks):
    """allreduce_found_inf: one rank's overflow is every rank's; with a
    NaN on rank 0 GradScaler.unscale_and_sync reports the overflow on
    every rank, and the update halves every rank's scale."""
    world, _, outs = ranks
    for r, o in enumerate(outs):
        o = o["found_inf"]
        assert bool(o["or"]) is True
        assert bool(o["found"]) is True
        assert float(o["scale"]) == 4.0
        want = np.full(3, float(r + 1))
        if r == 0:
            want[1] = np.nan
        np.testing.assert_array_equal(o["unscaled"], want)


def _jax_found_inf(world, pp, tp, bad):
    """Each device's overflow flag and updated scale from the JAX
    GradScaler.unscale_and_sync + update in shard_map over a (pp, dp, tp)
    mesh of `world` devices, the gradient of device `bad` holding an inf
    (device r is the port's rank r)."""
    JM.destroy_model_parallel()
    mesh = JM.initialize_model_parallel(
        tensor_model_parallel_size=tp, pipeline_model_parallel_size=pp,
        devices=jax.devices()[:world])
    g = np.full((world, 2), 8.0, np.float32)
    g[bad, 0] = np.inf
    axes = ("pp", "dp", "tp")

    def local(a):
        gs = JGradScaler(init_scale=8.0)
        _, found = gs.unscale_and_sync({"a": a})
        st = gs.update(found)
        return found.reshape(1), st.scale.reshape(1)

    found, scale = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(axes),), out_specs=(P(axes), P(axes)),
        check_vma=False))(jnp.asarray(g))
    JM.destroy_model_parallel()
    return np.asarray(found), np.asarray(scale)


def test_found_inf_is_or_ed_over_tp_and_pp_only(ranks):
    """An overflow on one rank: at pp 2 x tp 2 (4 ranks) every rank of the
    model-parallel plane skips and halves its scale; at dp = world (tp =
    pp = 1) only that rank does, as the JAX package ORs over tp and pp
    and not over dp.  Each rank's flag and scale against the JAX scaler's
    on the same device of the same mesh."""
    world, inputs, outs = ranks
    for pp, tp, bad in inputs["found_inf_mp"]["layouts"]:
        jfound, jscale = _jax_found_inf(world, pp, tp, bad)
        for r, o in enumerate(outs):
            got = o["found_inf_mp"][(pp, tp, bad)]
            want_found = r == bad or tp * pp == world
            assert bool(got["found"]) is bool(jfound[r]) is want_found, (
                pp, tp, r)
            assert float(got["scale"]) == float(jscale[r]) == (
                4.0 if want_found else 8.0), (pp, tp, r)


# ------------------------------------ O2 ------------------------------------

def _jax_o2(world, d):
    mesh = _mesh(world)
    params, amp_state = jamp.initialize(
        jax.tree_util.tree_map(jnp.asarray, d["params"]), opt_level="O2")
    opt = JSGD(lr=0.1, momentum=0.9)
    state = opt.init(params)
    start = np.asarray(state.params, np.float32)

    def loss_fn(p, ms, b):
        x, y = b
        h = x @ p["w1"]
        h, rm, rv = jbn(h, p["bn"]["scale"], p["bn"]["bias"], ms["mean"],
                        ms["var"], training=True, axis_name="dp")
        h = jax.nn.relu(h)
        loss = jnp.mean((h @ p["w2"] - y).astype(jnp.float32) ** 2)
        return loss, {"mean": rm, "var": rv}

    step = jddp.make_train_step(loss_fn, opt, mesh, amp_state=amp_state,
                                batch_spec=(P("dp"), P("dp")),
                                with_state=True, donate=False)
    scaler = amp_state.loss_scalers[0]
    ms = {"mean": jnp.zeros(16), "var": jnp.ones(16)}
    for _ in range(3):
        state, scaler, ms, _ = step(state, scaler, ms, (d["x"], d["y"]))
    JM.destroy_model_parallel()
    return start, np.asarray(state.params, np.float32), scaler, ms


def test_o2_step_across_ranks(ranks):
    """Three O2 steps (bf16 params and compute, the batch norm's params
    fp32 in the step and synced over the ranks, the fp32 master in
    FusedSGD's flat buffer, dynamic loss scale 2^16) at dp = 2 and 4:
    every rank's masters agree with the JAX O2 step's (module
    docstring), the loss scale grows on neither, and the running
    statistics agree within bf16's precision."""
    world, inputs, outs = ranks
    outs = [o["o2"] for o in outs]
    start, want, jsc, jms = _jax_o2(world, inputs["o2"])
    for r, out in enumerate(outs):
        assert bool(out["bn_dtype"]), "O2 did not keep the bn leaves fp32"
        err = (np.linalg.norm(out["params"] - want)
               / np.linalg.norm(want - start))
        assert err <= 1e-2, (r, err)
        assert float(out["scale"]) == float(jsc.scale) == 2.0 ** 16
        np.testing.assert_allclose(out["rm"], np.asarray(jms["mean"]),
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(out["rv"], np.asarray(jms["var"]),
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_array_equal(out["params"], outs[0]["params"])


def test_o2_step_one_process():
    """The same O2 step on one process (local batch norm) against the JAX
    step on a one-device mesh; the master buffer is fp32 and the step
    reads bf16 weights with fp32 batch-norm params."""
    d = {"params": _bn_params(), "x": _batch()[0], "y": _batch()[1]}
    params, amp_state = amp.initialize(_tree(d["params"]), opt_level="O2",
                                       device="cpu")
    assert params["w1"].dtype == torch.bfloat16
    assert params["bn"]["scale"].dtype == torch.float32
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import ddp

    opt = FusedSGD(lr=0.1, momentum=0.9)
    state = opt.init(params)
    assert state.params.dtype == torch.float32
    seen = []

    def loss_fn(p, ms, b):
        seen.append({"/".join(k): str(v.dtype) for k, v in
                     F.tree_leaves_with_paths(p)})
        return W.bn_mlp_loss(p, ms, b, None)

    step = ddp.make_train_step(loss_fn, opt, amp_state=amp_state,
                               with_state=True, device="cpu")
    scaler = amp_state.loss_scalers[0]
    ms = {"mean": torch.zeros(16), "var": torch.ones(16)}
    for _ in range(3):
        state, scaler, ms, _ = step(
            state, scaler, ms, (torch.from_numpy(d["x"]),
                                torch.from_numpy(d["y"])))
    assert seen[0] == {"bn/bias": "torch.float32",
                       "bn/scale": "torch.float32",
                       "w1": "torch.bfloat16", "w2": "torch.bfloat16"}
    start, want, _, _ = _jax_o2(1, {**d, "params": d["params"]})
    err = np.linalg.norm(state.params.numpy() - want) / np.linalg.norm(
        want - start)
    assert err <= 1e-2, err
