"""Checkpoints of an optimizer state cut over tp or pp ranks
(apex_tpu_torch.checkpoint.CheckpointManager over
`make_tp_dp_train_step` states) against the JAX package's, on the CPU.

One global state a case: a tiny GPT's FusedAdam state on a (pp, dp, tp)
mesh, the params its sharded init's (the `P(("pp", "tp"))`
concatenation of the ranks' flats), the moments seeded numpy
(`torch_dist_worker.seeded_moments`).  The JAX package builds it on its
CPU devices and saves it.  The port builds it as gloo worlds
(`tests/torch_dist_worker.py` scenario `ckpt_tp`; one 2-rank world for
tp 2, one 4-rank world for tp 2 x dp 2 and for `GPTPipelined` at pp 2 x
tp 2, both started before the JAX side runs) and saves it: the shard
files byte for byte the JAX save's, the manifest equal apart from
`created_unix` and `tuner_fingerprint`.  Each row of the JAX save
restores in the port at its (pp, tp) coordinates; the port takes a step
and saves that, which the JAX package restores to the port's rows; a
fresh optimizer resumes from it bit for bit.  Every comparison is
exact: a checkpoint moves bytes, never arithmetic."""

import concurrent.futures
import json
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import checkpoint as JC
from apex_tpu.checkpoint import sharded as JS
from apex_tpu.models.gpt import GPT as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.models.gpt import GPTPipelined as JaxGPTPipelined
from apex_tpu.optimizers.fused_adam import FusedAdam as JaxFusedAdam
from apex_tpu.parallel import mesh as JM
from apex_tpu.transformer import training as jax_training
from apex_tpu_torch import checkpoint as PC
from apex_tpu_torch.checkpoint import manager as PM
from apex_tpu_torch.checkpoint import sharded as PS
from apex_tpu_torch.models.gpt import GPT, GPTConfig, GPTPipelined
from apex_tpu_torch.models.gpt import params_from_jax
from apex_tpu_torch.ops.optimizer_kernels import FLAT_TILE
from apex_tpu_torch.optimizers import DistributedFusedAdam, FusedAdam
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.transformer.tensor_parallel.layers import shard_tree_axes

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

CFG = dict(vocab_size=64, seq_len=16, hidden=32, num_layers=4, num_heads=4,
           dropout=0.0)
JAX_STEP = 5
# (name, world, tp, pp): the worlds are shared by their cases
CASES = [("tp2", 2, 2, 1), ("tp2dp2", 4, 2, 1), ("pp2tp2", 4, 2, 2)]
IDS = [c[0] for c in CASES]
FIELDS = ("params", "exp_avg", "exp_avg_sq")
VOLATILE = ("created_unix", "tuner_fingerprint")


def _jmodel(tp, pp):
    cfg = JaxGPTConfig(**CFG)
    if pp > 1:
        return JaxGPTPipelined(cfg, num_microbatches=2,
                               pipeline_parallel_size=pp)
    return JaxGPT(cfg)


def _jax_save(directory, world, tp, pp, seed):
    """The JAX package's global state on its (pp, dp, tp) mesh (the
    sharded init's params at step 1, the seeded moments), saved at
    JAX_STEP.  Returns (optimizer, the state's fields as numpy)."""
    JM.destroy_model_parallel()
    mesh = JM.initialize_model_parallel(
        tensor_model_parallel_size=tp, pipeline_model_parallel_size=pp,
        devices=jax.devices()[:world])
    model = _jmodel(tp, pp)
    opt = JaxFusedAdam(lr=1e-3, use_pallas=False)
    state = jax_training.init_sharded_optimizer(
        opt, model, model.init(jax.random.PRNGKey(3)), mesh)
    m, v = W.seeded_moments(state.params.shape[0], seed)
    state = state._replace(step=jnp.asarray(1, jnp.int32),
                           exp_avg=jnp.asarray(m), exp_avg_sq=jnp.asarray(v))
    JC.CheckpointManager(directory, opt, async_write=False).save(JAX_STEP,
                                                                 state)
    JM.destroy_model_parallel()
    return opt, {f: np.asarray(getattr(state, f)) for f in state._fields}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One gloo world per world size over its cases, started first; the
    JAX side's saves while they run."""
    root = tmp_path_factory.mktemp("ckpt_tp")
    tokens = [np.random.RandomState(s).randint(
        0, CFG["vocab_size"], (4, CFG["seq_len"])).astype(np.int32)
        for s in (0, 1)]
    cases, jax_side = {}, {}
    for i, (name, world, tp, pp) in enumerate(CASES):
        params = jax.tree_util.tree_map(
            np.asarray, _jmodel(tp, pp).init(jax.random.PRNGKey(3)))
        d = {k: str(root / name / k) for k in ("jax", "same", "next")}
        jax_side[name] = dict(d, params=params, seed=i)
        cases.setdefault(world, []).append({
            "name": name, "tp": tp, "pp": pp, "params": params, "seed": i,
            "same_dir": d["same"], "next_dir": d["next"]})

    def run(world):
        d = root / f"world{world}"
        d.mkdir()
        return W.run_ranks(str(d), world, {
            "scenarios": ["ckpt_tp"],
            "ckpt_tp": {"cfg": CFG, "cases": cases[world], "tokens": tokens,
                        "step": JAX_STEP}})

    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        futures = {w: pool.submit(run, w) for w in cases}
        for name, world, tp, pp in CASES:
            j = jax_side[name]
            j["opt"], j["state"] = _jax_save(j["jax"], world, tp, pp,
                                              j["seed"])
        results = {w: f.result() for w, f in futures.items()}
    outs = {c["name"]: [r["ckpt_tp"][c["name"]] for r in results[world]]
            for world, cs in cases.items() for c in cs}
    return jax_side, outs


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", IDS)
def test_port_restores_the_jax_save_row_by_row(worlds, name):
    """Row pp_i·tp + tp_i of every field of the JAX save restores (its
    step whole) for an optimizer built at those coordinates, whose own
    sharded init's params are that row of the JAX state; the worlds'
    ranks cover every row."""
    jax_side, outs = worlds
    _, world, tp, pp = _case(name)
    j = jax_side[name]
    n = tp * pp
    model = GPTPipelined(GPTConfig(**CFG), 2, pp) if pp > 1 \
        else GPT(GPTConfig(**CFG))
    params = params_from_jax(j["params"], device="cpu")
    for r in range(n):
        opt = FusedAdam(lr=1e-3)
        own = opt.init(shard_tree_axes(params, model.partition_specs(), {
            M.PP_AXIS: (r // tp, pp), M.TP_AXIS: (r % tp, tp)}))
        np.testing.assert_array_equal(
            own.params.numpy(), np.split(j["state"]["params"], n)[r],
            err_msg=f"row {r} init")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # a tuner fingerprint
            state, _, manifest = PS.restore_sharded(
                j["jax"], opt, device="cpu", cut=(r, pp, tp))
        assert manifest["step"] == JAX_STEP and int(state.step) == 1
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(state, f).numpy(), np.split(j["state"][f], n)[r],
                err_msg=f"row {r} {f}")
    assert {o["row"] for o in outs[name]} == set(range(n))


@pytest.mark.parametrize("name", IDS)
def test_port_save_matches_the_jax_save_byte_for_byte(worlds, name):
    """The port's save of the same global state (the fields gathered
    over the (pp, tp) group, rank 0 writing and committing) writes the
    JAX package's files byte for byte and its manifest apart from
    created_unix and tuner_fingerprint; the ranks' sub-manifests of the
    file barrier stay beside them."""
    jax_side, outs = worlds
    world = _case(name)[1]
    assert all(o["multihost"] for o in outs[name])
    ours = PS.step_dir(jax_side[name]["same"], JAX_STEP)
    theirs = JS.step_dir(jax_side[name]["jax"], JAX_STEP)
    files = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == sorted(
        files + [f"manifest.host{h:03d}.json" for h in range(world)])
    assert {f"{f}.bin" for f in FIELDS} <= set(files)
    for f in files:
        if f == "manifest.json":
            continue
        with open(os.path.join(ours, f), "rb") as a, \
                open(os.path.join(theirs, f), "rb") as b:
            assert a.read() == b.read(), f
    m_ours, m_theirs = (json.load(open(os.path.join(p, "manifest.json")))
                        for p in (ours, theirs))
    for m in (m_ours, m_theirs):
        for k in VOLATILE:
            m.pop(k)
    assert m_ours == m_theirs


@pytest.mark.parametrize("name", IDS)
def test_jax_restores_the_port_save_of_a_step(worlds, name):
    """The port's save after one make_tp_dp_train_step step restores in
    the JAX package to the ranks' rows concatenated in row order."""
    jax_side, outs = worlds
    by_row = {o["row"]: o["stepped"] for o in outs[name]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # a tuner-fingerprint mismatch
        state, _, manifest = JC.CheckpointManager(
            jax_side[name]["next"], jax_side[name]["opt"]).restore()
    assert manifest["step"] == JAX_STEP + 1
    assert int(np.asarray(state.step)) == 2
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(state, f)),
            np.concatenate([by_row[r][f] for r in sorted(by_row)]),
            err_msg=f)
    assert not np.array_equal(by_row[0]["params"],
                              outs[name][0]["saved"]["params"])


@pytest.mark.parametrize("name", IDS)
def test_the_run_saves_and_resumes(worlds, name):
    """A fresh optimizer restores the stepped save bit for bit, and the
    resumed step's loss is the continuing run's bit for bit."""
    _, outs = worlds
    for r, o in enumerate(outs[name]):
        assert o["resumed_step"] == JAX_STEP + 1
        assert o["resumed_bit_for_bit"], f"rank {r}"
        np.testing.assert_array_equal(o["resumed_next_loss"],
                                      o["next_loss"], err_msg=f"rank {r}")


def test_a_row_that_cannot_hold_the_layout_is_refused(tmp_path):
    """Restoring at a cut whose rank count does not divide the saved
    buffer, or whose row is shorter or longer than the optimizer's own
    flat buffer (with no mesh too), is refused by name."""
    opt = FusedAdam(lr=1e-2)
    n = FLAT_TILE * 2          # no padding: a half row is too short
    state = opt.init({"w": torch.ones(n - 7), "b": torch.ones(7)})
    assert state.params.numel() == n
    PC.CheckpointManager(str(tmp_path), opt, async_write=False).save(1,
                                                                     state)
    with pytest.raises(PS.LayoutMismatchError, match="do not divide"):
        PS.restore_sharded(str(tmp_path), opt, device="cpu", cut=(0, 1, 3))
    with pytest.raises(PS.LayoutMismatchError, match="flat buffer"):
        PS.restore_sharded(str(tmp_path), opt, device="cpu", cut=(1, 1, 2))
    half = FusedAdam(lr=1e-2)
    assert half.init({"w": torch.ones(FLAT_TILE)}).params.numel() == n // 2
    with pytest.raises(PS.LayoutMismatchError, match="flat buffer of 65536"):
        PS.restore_sharded(str(tmp_path), half, device="cpu")
    with pytest.raises(PS.LayoutMismatchError, match="flat buffer of 65536"):
        PC.CheckpointManager(str(tmp_path), half).restore(device="cpu")
    back, _, _ = PS.restore_sharded(str(tmp_path), opt, device="cpu",
                                    cut=(0, 1, 1))
    assert torch.equal(back.params, state.params)


@pytest.mark.parametrize("name", IDS)
def test_a_save_at_another_cut_is_refused(worlds, name):
    """With no mesh, an optimizer over the whole model refuses the
    port's cut save by its recorded (pp, tp), and the JAX package's,
    which records none, by its rows' length; at the save's rank count
    and another (pp, tp) the port's save is refused by its record."""
    jax_side, _ = worlds
    _, _, tp, pp = _case(name)
    j = jax_side[name]
    whole = FusedAdam(lr=1e-3)
    whole.init(params_from_jax(j["params"], device="cpu"))
    with pytest.raises(PS.LayoutMismatchError,
                       match=f"cut over \\(pp, tp\\) = \\({pp}, {tp}\\)"):
        PC.CheckpointManager(j["same"], whole).restore(device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # a tuner fingerprint
        with pytest.raises(PS.LayoutMismatchError, match="flat buffer"):
            PC.CheckpointManager(j["jax"], whole).restore(device="cpu")
    with pytest.raises(PS.LayoutMismatchError, match="target is cut over"):
        PS.restore_sharded(j["same"], whole, device="cpu",
                           cut=(0, tp, pp) if tp != pp else (0, tp * pp, 1))


def test_a_zero_state_cut_over_tp_is_refused(tmp_path, monkeypatch):
    """What the format cannot hold is a ZeRO state (dp-sharded fields)
    cut over tp or pp as well: refused by name, nothing committed."""
    opt = DistributedFusedAdam(1, lr=1e-2)
    state = opt.init({"w": torch.ones(64)})
    mgr = PC.CheckpointManager(str(tmp_path), opt, async_write=False)
    monkeypatch.setattr(PM, "_plane", lambda: "plane")
    monkeypatch.setattr(M, "group_size",
                        lambda g: 2 if g == "plane" else 1)
    with pytest.raises(PC.CheckpointError, match="2 \\(pp, tp\\) ranks"):
        mgr.save(1, state)
    assert mgr.last_committed_step is None
