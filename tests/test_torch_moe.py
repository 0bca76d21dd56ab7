"""The port's Mixture-of-Experts (apex_tpu_torch.moe, models/moe_gpt.py,
the mesh's ep axis and the ZeRO optimizers' (dp, ep) sharding) against
the JAX package's, on the CPU.  Mirrors tests/test_moe.py.

The same seeded numpy inputs (or JAX-initialised weights through
`params_from_jax`) go through both packages, fp32 unless stated.  The
multi-rank cases run the port as one 4-rank gloo world (scenario `moe` of
tests/torch_dist_worker.py) against the JAX package in `shard_map` on its
first 4 CPU devices: dp 2 x ep 2 (and ep 2 x tp 2 for the mesh).

Tolerances: the router's logits, probabilities and gates 1e-6 relative
(fp32 sums in another order; bf16 inputs are products of exact upcasts
in both), its expert choices exactly; dispatch destinations and drop
counts exactly, combined rows 1e-6 (XLA contracts the gate multiply-adds
into FMAs); MoEMLP outputs 1e-5 and gradients 1e-5 of each tensor's
largest magnitude; the model's loss and stats 1e-5 relative; parameters
after the ZeRO-2 steps 2e-6 absolute (Adam turns last-bit gradient
differences into update differences of that size at lr 1e-4).  Port
against port: the blocked router, the dense anchor and the round trips
bit for bit; the chunked exchange's outputs bit for bit with the
monolithic one, its gradients 1e-6 (the bias and weight gradients sum
their chunks' partial products).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.models import moe_gpt as jmoe_gpt
from apex_tpu.moe import dispatch as JD
from apex_tpu.moe import layer as JL
from apex_tpu.moe import router as JR
from apex_tpu.parallel import mesh as JM
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.models import moe_gpt
from apex_tpu_torch.moe import MoERecorder
from apex_tpu_torch.moe import dispatch as D
from apex_tpu_torch.moe import router as R
from apex_tpu_torch.moe.layer import MoEAux, MoEMLP
from apex_tpu_torch.optimizers import DistributedFusedAdam
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.parallel import ddp
from apex_tpu_torch.parallel import mesh as M

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORLD = 4
INF = float("inf")
MLP = dict(hidden=16, ffn=32, n_experts=4)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jtree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.fixture(autouse=True)
def _world_of_one():
    M.destroy_model_parallel()
    JM.destroy_model_parallel()
    yield
    M.destroy_model_parallel()
    JM.destroy_model_parallel()


# --------------------------------- router -----------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_matches_jax_and_blocked_is_byte_identical(dtype):
    """fp32 logits, probabilities and gates from x in either dtype; the
    expert choices the JAX ones; the blocked router byte-identical to the
    dense one at every block size, and a forced `moe_router` tuner entry
    the same bytes as a miss."""
    from apex_tpu_torch import tune
    from apex_tpu_torch.tune.search import forced

    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 16)).astype(np.float32)
    wg = (rng.normal(size=(16, 8)) * 0.1).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref = JR.topk_gates_dense(jnp.asarray(x, jdt), jnp.asarray(wg, jdt), 2)
    tx = _t(x).to(getattr(torch, dtype))
    tw = _t(wg).to(getattr(torch, dtype))
    got = R.topk_gates_dense(tx, tw, 2)
    for f in ("probs", "gate", "logits"):
        assert getattr(got, f).dtype == torch.float32, f
        _close(getattr(got, f), getattr(ref, f), 1e-6, f)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    for blk in (8, 16, 64):
        out = R.topk_gates_blocked(tx, tw, 2, blk)
        for f in got._fields:
            assert torch.equal(getattr(out, f), getattr(got, f)), (f, blk)
    attrs = tune.moe_router_attrs(37, 8, 2, tx.dtype)
    with forced("moe_router", attrs, {"block_rows": 16}):
        hit = R.topk_gates(tx, tw, 2)
    for f in got._fields:
        assert torch.equal(getattr(hit, f), getattr(got, f)), f


def test_router_ties_pinned_by_index():
    """Equal probabilities resolve to the lower expert index, as
    `lax.top_k` resolves them: all tied, and rows with ties among the
    largest and among the runners-up."""
    logits = np.zeros((5, 4), np.float32)
    logits[1] = [0.0, 2.0, 0.0, 2.0]
    logits[2] = [1.0, 0.0, 1.0, 1.0]
    logits[3] = [3.0, 1.0, 1.0, 1.0]
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    jgate, jidx = lax.top_k(probs, 2)
    _, gate, idx = R._softmax_topk(_t(logits), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy()[[0, 1, 2, 3]],
                                  [[0, 1], [1, 3], [0, 2], [0, 1]])
    _close(gate, jgate, 1e-6)
    np.testing.assert_array_equal(gate.numpy()[0], 0.25)


def test_expert_capacity_matches_jax():
    """Rounded up to 8, clamped to the tokens, inf = no drop; a factor of
    0 or no tokens raise with the JAX messages."""
    for tokens in (1, 10, 64, 100, 8192):
        for e, k in ((1, 1), (2, 1), (4, 2), (8, 2)):
            for cf in (0.5, 1.0, 1.25, 2.0, 100.0, INF):
                assert (R.expert_capacity(tokens, e, k, cf)
                        == JR.expert_capacity(tokens, e, k, cf)), (
                            tokens, e, k, cf)
    assert R.expert_capacity(8192, 8, 2, 1.25) == 2560
    for args in ((64, 4, 2, 0.0), (0, 4, 2, 1.0)):
        with pytest.raises(ValueError) as ei:
            JR.expert_capacity(*args)
        with pytest.raises(ValueError) as ti:
            R.expert_capacity(*args)
        assert str(ti.value) == str(ei.value)


def test_aux_losses_and_entropy_match_jax():
    """The load-balancing loss and its f and P, the z-loss and the gate
    entropy (a zero probability included)."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(64, 8)).astype(np.float32) * 3
    logits[0, 0] = -1e4                              # exp underflows to 0
    @jax.jit
    def jstats(lg):
        out = JR.topk_gates_dense(lg, jnp.eye(8), 2)
        return (JR.load_balancing_aux(out.probs, out.idx, 8)
                + (JR.router_z_loss(out.logits), JR.gate_entropy(out.probs)))

    tout = R.topk_gates_dense(_t(logits), torch.eye(8), 2)
    got = R.load_balancing_aux(tout.probs, tout.idx, 8) + (
        R.router_z_loss(tout.logits), R.gate_entropy(tout.probs))
    for g, want in zip(got, jstats(jnp.asarray(logits))):
        _close(g, want, 1e-6)
    assert float(tout.probs[0, 0]) == 0.0


# ---------------------------- dispatch / combine ----------------------------

def test_dispatch_combine_roundtrip_bitwise():
    """capacity_factor inf, k = 1, unit gates: scatter, exchange at ep 1
    and combine give every token back bit for bit."""
    t, h, e = 24, 8, 4
    rng = np.random.default_rng(2)
    x = _t(rng.normal(size=(t, h)).astype(np.float32))
    idx = _t(rng.integers(0, e, size=(t, 1)).astype(np.int32))
    cap = R.expert_capacity(t, e, 1, INF)
    dest, dropped = R.capacity_destinations(idx, e, cap)
    assert float(dropped.sum()) == 0.0
    buf = D.dispatch(x, dest, e, cap)
    ybuf = D.exchange_combine(D.exchange_dispatch(buf, "ep", 1, e, cap),
                              "ep", 1, e, cap)
    assert torch.equal(D.combine(ybuf, dest, torch.ones(t, 1)), x)


def test_capacity_dropping_matches_jax():
    """At capacity factor 1.0 with k = 2 over skewed routing: the
    destinations (trash rows included) and the per-expert drop counts
    equal the JAX ones; the combined rows within 1e-6, the dropped
    assignments adding exactly 0; the gradients of x and the gates
    through dispatch and combine match `jax.grad`."""
    t, h, e, k = 64, 8, 4, 2
    rng = np.random.default_rng(4)
    x = rng.normal(size=(t, h)).astype(np.float32)
    p = np.array([0.55, 0.25, 0.15, 0.05])
    idx = np.stack([rng.choice(e, size=t, p=p) for _ in range(k)], 1)
    idx[:, 1] = np.where(idx[:, 1] == idx[:, 0], (idx[:, 0] + 1) % e,
                         idx[:, 1])
    idx = idx.astype(np.int32)
    gate = rng.uniform(0.1, 0.9, size=(t, k)).astype(np.float32)
    cot = rng.normal(size=(t, h)).astype(np.float32)
    cap = R.expert_capacity(t, e, k, 1.0)
    assert cap == JR.expert_capacity(t, e, k, 1.0) == 32
    jdest, jdrop = JR.capacity_destinations(jnp.asarray(idx), e, cap)
    dest, drop = R.capacity_destinations(_t(idx), e, cap)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(drop.numpy(), np.asarray(jdrop))
    assert float(drop.sum()) > 0 and int((dest == e * cap).sum()) > 0

    def jf(x_, g_):
        buf = JD.dispatch(x_, jdest, e, cap)
        ybuf = JD.exchange_combine(JD.exchange_dispatch(buf, "ep", 1, e, cap),
                                   "ep", 1, e, cap)
        return JD.combine(ybuf * 2.0, jdest, g_)

    @jax.jit
    def jvjp(x_, g_, c):
        y, vjp = jax.vjp(jf, x_, g_)
        return (y,) + vjp(c)

    jy, jdx, jdg = jvjp(jnp.asarray(x), jnp.asarray(gate), jnp.asarray(cot))
    tx, tg = _t(x).requires_grad_(True), _t(gate).requires_grad_(True)
    buf = D.dispatch(tx, dest, e, cap)
    ybuf = D.exchange_combine(D.exchange_dispatch(buf, "ep", 1, e, cap),
                              "ep", 1, e, cap)
    y = D.combine(ybuf * 2.0, dest, tg)
    dx, dg = torch.autograd.grad(y, (tx, tg), _t(cot))
    _close(y.detach(), jy, 1e-6, "y")
    _close(dx, jdx, 1e-6, "dx")
    _close(dg, jdg, 1e-6, "dgate")
    dropped_both = (dest == e * cap).all(1).numpy()
    assert dropped_both.any()
    assert np.all(y.detach().numpy()[dropped_both] == 0.0)


# ---------------------------------- MoEMLP ----------------------------------

def _smoke_layer_inputs(seed=7):
    """moe_smoke_config's MLP shape: hidden 64, ffn 256, 4 experts, top 2,
    over (64, 4, 64) activations (256 tokens)."""
    cfg = jmoe_gpt.moe_smoke_config()
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(cfg.seq_len, 4, cfg.hidden)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return cfg, x, cot


@pytest.mark.parametrize("cf", [2.0, 1.0], ids=["no_drops", "drops"])
def test_moe_mlp_matches_jax(cf):
    """MoEMLP at moe_smoke_config's shapes, from the JAX weights: the
    output, the aux scalars and the gradients of x and every parameter
    against `jax.vjp`, without drops (cf 2) and with them (cf 1); the
    port at overlap_chunks 2 gives the output bit for bit and the
    gradients within 1e-6."""
    cfg, x, cot = _smoke_layer_inputs()
    f = cfg.ffn_mult * cfg.hidden
    jl = JL.MoEMLP(cfg.hidden, f, cfg.n_experts, top_k=2,
                   capacity_factor=cf, overlap_chunks=1)
    jp = jl.init(jax.random.PRNGKey(0))
    # trained-looking gates: routing far from uniform, so drops happen
    jp["wg"] = jp["wg"] * 40.0

    @jax.jit
    def jf(p, x_, c):
        (y, aux), vjp = jax.vjp(jl.apply, p, x_)
        return y, aux, vjp((c, JL.MoEAux(*[jnp.zeros((), jnp.float32)] * 4)))

    jy, jaux, (jg, jdx) = jf(jp, jnp.asarray(x), jnp.asarray(cot))
    if cf == 1.0:
        assert float(jaux.drop_fraction) > 0
    else:
        assert float(jaux.drop_fraction) == 0.0
    names = sorted(jp)
    outs = {}
    for chunks in (1, 2):
        tl = MoEMLP(cfg.hidden, f, cfg.n_experts, top_k=2,
                    capacity_factor=cf, overlap_chunks=chunks)
        params = {k: _t(np.asarray(v)).requires_grad_(True)
                  for k, v in jp.items()}
        tx = _t(x).requires_grad_(True)
        y, aux = tl.apply(params, tx)
        grads = torch.autograd.grad(
            y, [params[k] for k in names] + [tx], _t(cot))
        outs[chunks] = (y.detach(), grads, aux)
    y, grads, aux = outs[1]
    _close(y, jy, 1e-5, "y")
    for fld in MoEAux._fields:
        _close(getattr(aux, fld).detach(), getattr(jaux, fld), 1e-5, fld)
    for name, g in zip(names + ["x"], grads):
        want = jdx if name == "x" else jg[name]
        _close(g, want, 1e-5, name)
    y2, grads2, _ = outs[2]
    assert torch.equal(y2, y)
    for name, g2, g in zip(names + ["x"], grads2, grads):
        _close(g2, g, 1e-6, f"chunks 2 {name}")


def test_moe_config_and_layer_refusals():
    """The three MoEGPTConfig refusals and MoEMLP's top_k / ep checks,
    with the JAX messages."""
    for kw in ({"sequence_parallel": True}, {"remat": True},
               {"n_experts": 3, "expert_parallel": 2}):
        with pytest.raises(ValueError) as ei:
            jmoe_gpt.MoEGPTConfig(**kw)
        with pytest.raises(ValueError) as ti:
            moe_gpt.MoEGPTConfig(**kw)
        assert str(ti.value) == str(ei.value)
    for args, kw in (((8, 32, 2), {"top_k": 4}),
                     ((8, 32, 3), {"ep_size": 2})):
        with pytest.raises(ValueError) as ei:
            JL.MoEMLP(*args, **kw)
        with pytest.raises(ValueError) as ti:
            MoEMLP(*args, **kw)
        assert str(ti.value) == str(ei.value)


def test_moe_recorder():
    """MoERecorder: nothing before an update; a MoEAux or the model's
    moe_-prefixed stats dict, floated (the JAX recorder's record)."""
    from apex_tpu.moe import MoERecorder as JRec

    rec, jrec = MoERecorder(), JRec()
    assert rec.moe_record() == {} == jrec.moe_record()
    aux = MoEAux(*(torch.tensor(v) for v in (1.25, 0.5, 0.03, 1.1)))
    rec.update(aux)
    jrec.update(JL.MoEAux(*(jnp.float32(v) for v in (1.25, 0.5, 0.03, 1.1))))
    assert rec.moe_record() == pytest.approx(jrec.moe_record())
    rec.update({"ce_loss": torch.tensor(2.0),
                "moe_aux_loss": torch.tensor(1.5)})
    assert rec.moe_record() == {"moe_aux_loss": 1.5}


# ------------------------------ the model / step -----------------------------

def _jax_zero_step(devices):
    """The JAX `build_moe_train_step` on `devices` (smoke shapes), its
    weights, a seeded batch and two / three of its steps."""
    model, step, args, info = jmoe_gpt.build_moe_train_step(
        False, devices=devices)
    state, _, (tok_sds, _) = args
    params = model.init(jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), tok_sds.shape, 0,
                                info["vocab_size"])
    labels = jnp.roll(tokens, -1, axis=1)
    return model, step, state, params, tokens, labels, info


def test_moe_gpt_loss_and_zero_steps_match_jax():
    """MoEGPT.loss_with_stats and its stats from the JAX weights, then
    three steps of the port's `build_moe_train_step` (a world of one:
    ep 1, DistributedFusedAdam(1, n_buckets 2), fp32) against the JAX
    `build_moe_train_step` on one device: the losses, the stats and the flat master
    params (the same bucket-major layout) after the steps."""
    model, step, state, params, tokens, labels, info = _jax_zero_step(
        jax.devices()[:1])
    assert info["ep"] == 1
    tparams = moe_gpt.params_from_jax(_jtree(params), device="cpu")
    tmodel, tstep, _, tinfo = moe_gpt.build_moe_train_step("cpu")
    assert (tinfo["ep"], tinfo["dp"], tinfo["batch"]) == (1, 1, 4)
    assert tmodel.c == moe_gpt.moe_smoke_config()
    tok, lab = _t(np.asarray(tokens)), _t(np.asarray(labels))
    loss, stats = tmodel.loss_with_stats(tparams, tok, lab)
    opt = tinfo["optimizer"]
    tstate = opt.init(tparams)
    for it in range(3):
        state, _, jloss, jstats = step(state, None, (tokens, labels))
        tstate, _, tloss, tstats = tstep(tstate, None, (tok, lab))
        _close(tloss, jloss, 1e-5, f"loss step {it}")
        for k in jstats:
            _close(tstats[k], jstats[k], 1e-5, f"{k} step {it}")
        if it == 0:
            _close(loss.detach(), jloss, 1e-5, "loss_with_stats")
            for k in jstats:
                _close(stats[k].detach(), jstats[k], 1e-5, k)
    assert int(tstate.step) == 3
    np.testing.assert_allclose(tstate.params_shard.numpy(),
                               np.asarray(state.params_shard), rtol=0,
                               atol=2e-6)


def test_dense_anchor_bitwise():
    """n_experts 1 / top_k 1 / cf inf / aux 0 / z 0 with the experts
    mapped from a dense GPT of the same width: three ZeRO-2 steps of the
    port's MoEGPT give the port GPT's losses and updated params bit for
    bit (the router's parameter untouched)."""
    kw = dict(vocab_size=512, seq_len=32, hidden=32, num_layers=2,
              num_heads=4, dropout=0.0)
    dense = tgpt.GPT(tgpt.GPTConfig(**kw))
    moe = moe_gpt.MoEGPT(moe_gpt.MoEGPTConfig(
        n_experts=1, top_k=1, capacity_factor=INF, aux_coef=0.0, z_coef=0.0,
        **kw))
    dp = dense.init(seed=0, device="cpu")
    mp = moe.init(seed=0, device="cpu")
    for i in range(2):
        bp, dbp = mp[f"block{i}"], dp[f"block{i}"]
        for k in ("ln1", "ln2", "qkv", "proj"):
            bp[k] = {n_: v.clone() for n_, v in dbp[k].items()}
        bp["moe"].update(w1=dbp["fc1"]["weight"][None].clone(),
                         b1=dbp["fc1"]["bias"][None].clone(),
                         w2=dbp["fc2"]["weight"][None].clone(),
                         b2=dbp["fc2"]["bias"][None].clone())
    for k in ("embed", "pos_embed", "final_ln"):
        mp[k] = jax.tree_util.tree_map(torch.clone, dp[k])
    wg0 = [mp[f"block{i}"]["moe"]["wg"].clone() for i in range(2)]
    rng = np.random.default_rng(1)
    tokens = _t(rng.integers(0, 512, size=(4, 32)).astype(np.int32))
    labels = torch.roll(tokens, -1, dims=1)

    def run(model, params, has_aux):
        opt = DistributedFusedAdam(1, lr=1e-3, n_buckets=2)
        state = opt.init(params)

        def loss_fn(p, b):
            return (model.loss_with_stats(p, *b) if has_aux
                    else model.loss(p, *b))

        step = ddp.make_train_step(loss_fn, opt, has_aux=has_aux,
                                   device="cpu")
        losses, aux = [], None
        for _ in range(3):
            out = step(state, None, (tokens, labels))
            state, losses = out[0], losses + [out[2]]
            aux = out[3] if has_aux else None
        return losses, opt.full_params(state), aux

    ld, pd, _ = run(dense, dp, False)
    lm, pm, aux = run(moe, mp, True)
    for it, (a, b) in enumerate(zip(ld, lm)):
        assert torch.equal(a, b), f"loss step {it}"
    assert float(aux["moe_drop_fraction"]) == 0.0
    assert float(aux["moe_aux_loss"]) == 1.0
    ren = {("fc1", "weight"): ("moe", "w1"), ("fc1", "bias"): ("moe", "b1"),
           ("fc2", "weight"): ("moe", "w2"), ("fc2", "bias"): ("moe", "b2")}
    for path, leaf in F.tree_leaves_with_paths(pd):
        q = path[:-2] + ren.get(path[-2:], path[-2:])
        got = pm
        for key in q:
            got = got[key]
        assert torch.equal(got.reshape(leaf.shape), leaf), path
    for i in range(2):
        assert torch.equal(pm[f"block{i}"]["moe"]["wg"], wg0[i])


# ------------------------------ 4 gloo ranks ---------------------------------

def _inputs():
    rng = np.random.default_rng(11)
    h, f, e = MLP["hidden"], MLP["ffn"], MLP["n_experts"]
    jl = JL.MoEMLP(h, f, e, top_k=2, capacity_factor=2.0)
    mlp_params = _jtree(jl.init(jax.random.PRNGKey(0)))
    _, _, _, gpt_params, tokens, _, _ = _JAX4["train"]
    return {"scenarios": ["moe"], "moe": {
        "layouts": [(2, 1), (2, 2)], "n_experts": e,
        "x": rng.normal(size=(16, 8)).astype(np.float32),
        "mlp": {"hidden": h, "ffn": f, "params": mlp_params,
                "x": rng.normal(size=(64, h)).astype(np.float32),
                "t": rng.normal(size=(64, h)).astype(np.float32)},
        "gpt_params": _jtree(gpt_params), "tokens": np.asarray(tokens)}}


# the JAX `build_moe_train_step` run on 4 devices, shared by the fixture and the tests
_JAX4 = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    JM.destroy_model_parallel()
    _JAX4["train"] = _jax_zero_step(jax.devices()[:WORLD])
    inputs = _inputs()
    d = tmp_path_factory.mktemp("moe4")
    return inputs["moe"], W.run_ranks(str(d), WORLD, inputs)


def test_ep_groups_match_the_jax_mesh(ranks):
    """At ep 2 x tp 1 (dp 2) and ep 2 x tp 2 (dp 1): each rank's dp, ep
    and tp sizes and coordinates are its place in the JAX (pp, dp, ep,
    tp) mesh, the data axes ("dp", "ep"), the rank info the JAX string;
    every group's members are the devices of the JAX mesh along those
    axes, and the data-parallel group is the combined (dp, ep) one."""
    d, outs = ranks
    for ep, tp in d["layouts"]:
        JM.destroy_model_parallel()
        mesh = JM.initialize_model_parallel(
            tensor_model_parallel_size=tp, expert_model_parallel_size=ep,
            devices=jax.devices()[:WORLD])
        assert mesh.axis_names == ("pp", "dp", "ep", "tp")
        ids = np.vectorize(lambda dv: dv.id)(mesh.devices)
        names = mesh.axis_names
        for r, o in enumerate(outs):
            got = o["moe"][("mesh", ep, tp)]
            pp_i, dp_i, ep_i, tp_i = (int(a[0]) for a in np.nonzero(ids == r))
            np.testing.assert_array_equal(
                got["sizes"], [JM.get_data_parallel_world_size(), dp_i, ep,
                               ep_i, tp, tp_i])
            assert got["axes"] == JM.get_data_parallel_axis_names() == (
                "dp", "ep")
            assert got["info"] == f"proc{r} " + JM.get_rank_info().split(
                " ", 1)[1]
            coord = dict(zip(names, (pp_i, dp_i, ep_i, tp_i)))
            for axes, members in got["groups"].items():
                idx = tuple(slice(None) if a in axes else coord[a]
                            for a in names)
                assert members == sorted(ids[idx].ravel().tolist()), (
                    ep, tp, r, axes)
            assert got["data_group"] == got["groups"][("dp", "ep")]
    JM.destroy_model_parallel()


def test_ep_exchange_and_layer_match_jax(ranks):
    """The dispatch/combine round trip through the ep all-to-all pair is
    bit for bit the input, monolithic and in 2 chunks (elementwise
    expert, bit for bit the JAX chunked exchange); MoEMLP at dp 2 x ep 2
    from the JAX weights: each rank's output and loss and the (dp, ep)
    mean of the gradients against `shard_map` with `pmean` over ("dp",
    "ep"), at overlap_chunks 1 and 2 (the port's chunk 2 output bit for
    bit its chunk 1)."""
    d, outs = ranks
    e = d["n_experts"]
    JM.destroy_model_parallel()
    mesh = JM.initialize_model_parallel(expert_model_parallel_size=2,
                                        devices=jax.devices()[:WORLD])
    spec = P(("dp", "ep"))

    def rt(xs):
        t = xs.shape[0]
        idx = (jnp.arange(t)[:, None] * 3) % e
        cap = JR.expert_capacity(t, e, 1, INF)
        dest, _ = JR.capacity_destinations(idx, e, cap)
        buf = JD.dispatch(xs, dest, e, cap)
        ybuf = JD.chunked_expert_exchange(buf, lambda xe: xe * 2.0 + 1.0,
                                          "ep", 2, e, cap, 2)
        return JD.combine(ybuf, dest, jnp.ones((t, 1), jnp.float32))

    want = np.asarray(jax.jit(shard_map(rt, mesh=mesh, in_specs=(spec,),
                                        out_specs=spec, check_vma=False))(
        jnp.asarray(d["x"])))
    for r, o in enumerate(outs):
        rows = slice(r * 4, (r + 1) * 4)
        np.testing.assert_array_equal(o["moe"]["roundtrip"], d["x"][rows])
        np.testing.assert_array_equal(o["moe"]["roundtrip_chunks"],
                                      want[rows])
    m = d["mlp"]
    jl = JL.MoEMLP(m["hidden"], m["ffn"], e, top_k=2, capacity_factor=2.0,
                   ep_size=2, overlap_chunks=1)

    def local(p, x_l, t_l):
        def loss_fn(p_):
            y, _ = jl.apply(p_, x_l)
            return jnp.sum(y * t_l), y
        (loss, y), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        grads = jax.tree_util.tree_map(lambda g: lax.pmean(g, ("dp", "ep")),
                                       grads)
        return y, loss.reshape(1), grads

    jy, jloss, jg = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), spec, spec),
        out_specs=(spec, spec, P()), check_vma=False))(
        jax.tree_util.tree_map(jnp.asarray, m["params"]),
        jnp.asarray(m["x"]), jnp.asarray(m["t"]))
    for r, o in enumerate(outs):
        rows = slice(r * 16, (r + 1) * 16)
        for chunks in (1, 2):
            got = o["moe"][("mlp", chunks)]
            _close(got["y"], np.asarray(jy)[rows], 1e-5, f"y {r} {chunks}")
            _close(got["loss"], np.asarray(jloss)[r], 1e-5, f"loss {r}")
            for k, g in got["grads"].items():
                _close(g, jg[k], 1e-5, f"grad {k} rank {r} chunks {chunks}")
        np.testing.assert_array_equal(o["moe"][("mlp", 2)]["y"],
                                      o["moe"][("mlp", 1)]["y"])
    JM.destroy_model_parallel()


def test_ep_train_steps_match_jax(ranks):
    """`build_moe_train_step` in the 4-rank world (dp 2 x ep 2, batch 4:
    one row a rank, DistributedFusedAdam over the combined group with
    ep_shards 2) from the JAX weights, two steps against the JAX `build_moe_train_step`
    on 4 devices: each rank's losses and stats its JAX shard's, and the
    ranks' master shards concatenated the JAX (dp, ep)-sharded state;
    `shard_layout()` records ep_shards 2."""
    d, outs = ranks
    model, step, state, params, tokens, labels, info = _JAX4["train"]
    assert (info["dp"], info["ep"]) == (2, 2)
    jl = []
    for _ in range(2):
        state, _, loss, aux = step(state, None, (tokens, labels))
        jl.append((float(loss), {k: float(v) for k, v in aux.items()}))
    shard = np.concatenate([o["moe"]["train"]["shard"] for o in outs])
    np.testing.assert_allclose(shard, np.asarray(state.params_shard),
                               rtol=0, atol=2e-6)
    for o in outs:
        tr = o["moe"]["train"]
        assert (tr["dp"], tr["ep"], tr["local_batch"]) == (2, 2, 1)
        assert tr["layout"]["ep_shards"] == 2
        assert tr["layout"]["num_shards"] == 4
    # the JAX step returns one shard's loss and stats (its out_spec P()):
    # shard 0's, which rank 0 holds
    tr = outs[0]["moe"]["train"]
    for it, (jloss, jstats) in enumerate(jl):
        _close(tr["losses"][it], jloss, 1e-5, f"loss step {it}")
        for k, v in jstats.items():
            _close(tr["stats"][it][k], v, 1e-5, f"{k} step {it}")
    JM.destroy_model_parallel()


def test_ep_refusals(ranks):
    """In the gloo world: MoEMLP at tp 2 raises the JAX layer's
    NotImplementedError, and an ep of 3 does not divide 4 ranks (the JAX
    mesh's ValueError)."""
    d, outs = ranks
    m = d["mlp"]
    JM.destroy_model_parallel()
    mesh = JM.initialize_model_parallel(tensor_model_parallel_size=2,
                                        devices=jax.devices()[:WORLD])
    jl = JL.MoEMLP(m["hidden"], m["ffn"], d["n_experts"], top_k=2,
                   tp_axis="tp")
    with pytest.raises(NotImplementedError) as ei:
        jax.jit(shard_map(lambda p, x: jl.apply(p, x)[0], mesh=mesh,
                          in_specs=(P(), P()), out_specs=P(),
                          check_vma=False)).lower(
            jax.tree_util.tree_map(jnp.asarray, m["params"]),
            jnp.asarray(m["x"]))
    JM.destroy_model_parallel()
    with pytest.raises(ValueError) as vi:
        JM.initialize_model_parallel(expert_model_parallel_size=3,
                                     devices=jax.devices()[:WORLD])
    for o in outs:
        assert o["moe"]["tp_refused"] == str(ei.value)
        assert o["moe"]["ep3_refused"] == str(vi.value)
