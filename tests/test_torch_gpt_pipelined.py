"""The port's pipelined GPT (apex_tpu_torch.models.gpt.GPTPipelined) and
its pp x tp training step against the JAX package's, on the CPU.
Mirrors tests/test_gpt_pipelined.py (vocab 64, seq 16, h32, L4, 4 heads,
fp32, dense attention, batch 4).

The port runs as one 4-rank gloo world (tests/torch_dist_worker.py,
scenario `gpt_pp`), each rank on its shard of the JAX package's seeded
`GPTPipelined.init` weights (`params_from_jax(..., pp_rank, pp_size,
tp_rank, tp_size)`: blocks[pp_rank] cut over tp, the embedding,
positions and final LayerNorm whole or vocab-cut); the JAX package runs
`GPTPipelined.loss` in `shard_map` on a (pp, dp, tp) mesh of its first 4
CPU devices.  Cases: pp 2 x tp 2 at 2 and 4 microbatches, with 2 chunks
a stage, and with sequence parallelism; pp 4 x tp 1.  Tolerances: losses
rtol 1e-5; each rank's gradients (its own partial gradients of the
replicated leaves included) rtol 1e-5 and atol 1e-5 of each leaf's
largest magnitude.  The JAX package's sequence-parallel gradients are tp
times its others (tests/test_torch_gpt_tp.py), so the port's
sequence-parallel gradients are held to its own without it.  Three
training steps at pp 2 x tp 2 with FusedAdam(lr=1e-4): each rank's flat
buffer against row pp_i·tp + tp_i of the JAX state within rtol 1e-5 /
atol 1e-6, Adam's eps-regime elements (|first gradient| < 1e-7) within
atol 1e-5, as tests/test_torch_gpt_tp.py holds them; the replicated
leaves bit for bit equal across the two stages."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.models.gpt import GPTPipelined as JaxGPTPipelined
from apex_tpu.optimizers.fused_adam import FusedAdam as JaxFusedAdam
from apex_tpu.parallel import mesh as JM
from apex_tpu.transformer import training as jax_training

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORLD = 4
CFG = dict(vocab_size=64, seq_len=16, hidden=32, num_layers=4,
           num_heads=4, dropout=0.0)
# (pp, tp, microbatches, chunks, sequence_parallel)
CASES = [(2, 2, 2, 1, False), (2, 2, 4, 1, False), (2, 2, 2, 2, False),
         (2, 2, 2, 1, True), (4, 1, 4, 1, False)]
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5
AXES = ("pp", "dp", "tp")


def _jmodel(pp, m, chunks, sp=False):
    return JaxGPTPipelined(JaxGPTConfig(**CFG, sequence_parallel=sp),
                           num_microbatches=m, pipeline_parallel_size=pp,
                           num_model_chunks=chunks)


def _jparams(pp, chunks):
    return _jmodel(pp, 2, chunks).init(jax.random.PRNGKey(3))


def _tokens(seed, batch=4):
    tokens = np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (batch, CFG["seq_len"])).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _inputs():
    tokens, labels = _tokens(0)
    layouts = {(c[0], c[3]) for c in CASES}
    return {"scenarios": ["gpt_pp"], "gpt_pp": {
        "cfg": CFG, "cases": CASES, "tokens": tokens, "labels": labels,
        "params": {lay: jax.tree_util.tree_map(np.asarray, _jparams(*lay))
                   for lay in layouts},
        "train_tokens": [_tokens(s)[0] for s in range(3)]}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("gptpp4")
    return W.run_ranks(str(d), WORLD, _inputs())


def _mesh(pp, tp):
    JM.destroy_model_parallel()
    return JM.initialize_model_parallel(
        tensor_model_parallel_size=tp, pipeline_model_parallel_size=pp,
        devices=jax.devices()[:WORLD])


def _jax_loss_and_grads(case):
    """The JAX loss and every device's local gradients (a leading device
    axis; device r is the port's rank r)."""
    pp, tp, m, chunks, sp = case
    mesh = _mesh(pp, tp)
    model = _jmodel(pp, m, chunks, sp)
    specs = model.partition_specs()
    tokens, labels = _tokens(0)

    def local(p, t, lab):
        loss, g = jax.value_and_grad(model.loss)(p, t, lab)
        return loss, jax.tree_util.tree_map(lambda x: x[None], g)

    gspecs = jax.tree_util.tree_map(lambda _: P(AXES), specs,
                                    is_leaf=lambda s: isinstance(s, P))
    loss, grads = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=(P(), gspecs), check_vma=False))(
            _jparams(pp, chunks), tokens, labels)
    JM.destroy_model_parallel()
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", CASES, ids=lambda c: "pp{}-tp{}-m{}-c{}-"
                         "sp{}".format(*c))
def test_loss_and_grads_match_jax(ranks, case):
    """Every rank's loss within rtol 1e-5 of the JAX package's (and near
    log V at these weights); without sequence parallelism each rank's
    gradients, leaf by leaf, against its device's in the JAX package's
    `jax.grad`; with it, against the same rank's without it."""
    jloss, jgrads = _jax_loss_and_grads(case)
    assert abs(jloss - np.log(CFG["vocab_size"])) < 0.5
    pp, tp, m, chunks, sp = case
    for r, o in enumerate(ranks):
        got = o["gpt_pp"][case]
        np.testing.assert_allclose(float(got["loss"]), jloss, rtol=1e-5,
                                   err_msg=f"rank {r}")
        if sp:
            base = o["gpt_pp"][(pp, tp, m, chunks, False)]["grads"]
        for q, g in got["grads"].items():
            want = base[q] if sp else _leaf(jgrads, q)[r].reshape(g.shape)
            np.testing.assert_allclose(
                g, want, rtol=GRAD_RTOL,
                atol=GRAD_ATOL * max(np.abs(want).max(), 1e-30),
                err_msg=f"rank {r} {q}")


def test_three_pp_tp_steps_match_jax(ranks):
    """Three make_tp_dp_train_step steps at pp 2 x tp 2 (the pp-partial
    gradients of the replicated leaves summed over the pp group):
    losses, step count and each rank's flat buffer against its row of
    the JAX state; the embedding shard, positions and final LayerNorm
    equal bit for bit on the two stages of each tp rank."""
    mesh = _mesh(2, 2)
    jmodel = _jmodel(2, 2, 1)
    jopt = JaxFusedAdam(lr=1e-4, use_pallas=False)
    jstate = jax_training.init_sharded_optimizer(jopt, jmodel,
                                                 _jparams(2, 1), mesh)
    jstep = jax_training.make_tp_dp_train_step(jmodel, jopt, mesh,
                                               donate=False)
    jlosses = []
    for s in range(3):
        tokens, labels = _tokens(s)
        jstate, jloss = jstep(jstate, jnp.asarray(tokens),
                              jnp.asarray(labels))
        jlosses.append(float(jloss))
        if s == 0:     # m after one step is (1 - beta1) g
            g = np.abs(np.asarray(jstate.exp_avg) / 0.1)
            eps_regime = (g > 0) & (g < 1e-7)
    flat = np.asarray(jstate.params)
    rows = flat.reshape(WORLD, -1)
    tiny_rows = eps_regime.reshape(WORLD, -1)
    for r, o in enumerate(ranks):
        got = o["gpt_pp"]["train"]
        assert got["step"] == int(jstate.step) == 3
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5,
                                   err_msg=f"rank {r}")
        row, tiny = rows[r], tiny_rows[r]
        assert got["params"].shape == row.shape
        assert tiny.sum() < 1e-3 * tiny.size
        np.testing.assert_allclose(got["params"][~tiny], row[~tiny],
                                   rtol=1e-5, atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["params"][tiny], row[tiny], rtol=0,
                                   atol=1e-5, err_msg=f"rank {r}")
    assert jlosses[-1] < jlosses[0]
    for tp_i in range(2):
        a = ranks[tp_i]["gpt_pp"]["train"]["replicated"]
        b = ranks[2 + tp_i]["gpt_pp"]["train"]["replicated"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    JM.destroy_model_parallel()
