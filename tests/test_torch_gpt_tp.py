"""The port's GPT across tensor-parallel ranks, with and without sequence
parallelism, and its tp x dp training step (apex_tpu_torch.models.gpt,
.transformer.training) against the JAX package's, on the CPU.  Mirrors
tests/test_gpt_minimal.py.

The small GPT of bench.py's CPU smoke (vocab 512, seq 64, h64, L2, 4
heads, fp32, dense attention; one case with flash attention) from the
JAX package's seeded weights, each port rank on its shard of them
(`params_from_jax(..., tp_rank, tp_size)`).  The port runs as 2 and 4
gloo ranks started by its launcher (one module-scoped world each,
tests/torch_dist_worker.py); the JAX package runs `GPT.loss` in
`shard_map` on a tp = 2 or 4 mesh of its CPU devices, and its
`make_tp_dp_train_step` on a dp = 2 x tp = 2 mesh (and dp = 2 x tp = 1
in the 2-rank world).  Tolerances: losses rtol 1e-5; the gradients of
each rank's shards, with sequence parallelism against without it and
without it against the JAX package's, rtol 1e-5 and atol 1e-5 of each
leaf's largest magnitude (the largest gap at these seeds is 8.3e-7 of
it, chunked at tp = 4); after three steps each rank's flat parameter
buffer within rtol 1e-5 / atol 1e-6 of its rows of the JAX state, the
single-device step's tolerances (tests/test_torch_gpt_train.py), except
where the first gradient is nonzero and in Adam's eps regime (|g| <
10·eps = 1e-7, where m / (√v + eps) turns the two packages' last-digit
gradient differences into different updates): those elements (187 of
the 262,144 in the two tp shards at these seeds) are held to atol 1e-5,
a tenth of one step's largest move (lr).  The largest two gaps, with
first gradients -7.0e-9 and 2.7e-8, are 1.7e-6 and 1.8e-6."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.models.gpt import GPT as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.optimizers.fused_adam import FusedAdam as JaxFusedAdam
from apex_tpu.parallel import mesh as JM
from apex_tpu.transformer import training as jax_training

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORLDS = (2, 4)
CFG = dict(vocab_size=512, seq_len=64, hidden=64, num_layers=2,
           num_heads=4, dropout=0.0)
BATCH = 2
# gradients: rtol, and atol as a fraction of the leaf's largest magnitude
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5


def _cases(world):
    """(tp, extra config) of each loss the world computes."""
    sp = {"sequence_parallel": True}
    cases = [(world, {}), (world, sp), (world, dict(sp, overlap_chunks=2))]
    if world == 2:
        cases.append((2, dict(sp, use_flash_attention=True)))
    return cases


def _jparams():
    return JaxGPT(JaxGPTConfig(**CFG)).init(jax.random.PRNGKey(7))


def _tokens(seed, batch=BATCH):
    tokens = np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (batch, CFG["seq_len"])).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _inputs(world):
    tokens, labels = _tokens(0)
    d = {"cfg": CFG, "params": jax.tree_util.tree_map(np.asarray, _jparams()),
         "losses": _cases(world), "tokens": tokens, "labels": labels}
    d["train"] = {"tp": world // 2,
                  "tokens": [_tokens(s, 4)[0] for s in range(3)]}
    return {"scenarios": ["gpt"], "gpt": d}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    d = tmp_path_factory.mktemp(f"gpt{world}")
    inputs = _inputs(world)
    return world, inputs["gpt"], W.run_ranks(str(d), world, inputs)


def _mesh(world, tp):
    JM.destroy_model_parallel()
    return JM.initialize_model_parallel(tensor_model_parallel_size=tp,
                                        devices=jax.devices()[:world])


def test_losses_match_jax_across_tp_and_sp(ranks):
    """The loss at tp = 2 and 4, with and without sequence parallelism
    (and chunked at 2, and with flash attention at tp = 2), on every rank,
    within rtol 1e-5 of the JAX package's."""
    world, d, outs = ranks
    for tp, kw in d["losses"]:
        mesh = _mesh(tp, tp)
        model = JaxGPT(JaxGPTConfig(**CFG, **kw))
        want = float(jax.jit(shard_map(
            model.loss, mesh=mesh,
            in_specs=(model.partition_specs(), P(), P()), out_specs=P(),
            check_vma=False))(_jparams(), d["tokens"], d["labels"]))
        for r, o in enumerate(outs):
            got = float(o["gpt"][("loss", tp, tuple(sorted(kw.items())))])
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       err_msg=f"tp {tp} {kw} rank {r}")
    assert abs(want - np.log(CFG["vocab_size"])) < 0.5
    JM.destroy_model_parallel()


def test_three_tp_dp_steps_match_jax(ranks):
    """Three steps of make_tp_dp_train_step at tp = 2 x dp = 2 (tp = 1 x
    dp = 2 in the 2-rank world) with FusedAdam(lr=1e-4): the dp-averaged
    losses, and each rank's flat params against rows [r·L, (r+1)·L) of
    the JAX state, r its tp rank."""
    world, d, outs = ranks
    tp = d["train"]["tp"]
    mesh = _mesh(world, tp)
    jmodel = JaxGPT(JaxGPTConfig(**CFG))
    jopt = JaxFusedAdam(lr=1e-4, use_pallas=False)
    jstate = jax_training.init_sharded_optimizer(jopt, jmodel, _jparams(),
                                                 mesh)
    jstep = jax_training.make_tp_dp_train_step(jmodel, jopt, mesh,
                                               donate=False)
    jlosses = []
    for tokens in d["train"]["tokens"]:
        jstate, jloss = jstep(jstate, jnp.asarray(tokens),
                              jnp.asarray(np.roll(tokens, -1, axis=1)))
        jlosses.append(float(jloss))
        if len(jlosses) == 1:     # m after one step is (1 - beta1) g
            g = np.abs(np.asarray(jstate.exp_avg) / 0.1)
            eps_regime = (g > 0) & (g < 1e-7)
    flat = np.asarray(jstate.params)
    per = flat.size // tp
    for r, o in enumerate(outs):
        got = o["gpt"]["train"]
        assert got["step"] == int(jstate.step) == 3
        assert got["tp_rank"] == r % tp
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5,
                                   err_msg=f"rank {r}")
        cut = slice(got["tp_rank"] * per, (got["tp_rank"] + 1) * per)
        rows, tiny = flat[cut], eps_regime[cut]
        assert got["params"].shape == rows.shape
        assert tiny.sum() < 1e-3 * tiny.size
        np.testing.assert_allclose(got["params"][~tiny], rows[~tiny],
                                   rtol=1e-5, atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["params"][tiny], rows[tiny], rtol=0,
                                   atol=1e-5, err_msg=f"rank {r}")
    JM.destroy_model_parallel()


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_sp_gradients_match_the_non_sp_gradients(ranks):
    """Sequence parallelism (monolithic, chunked at 2, and with flash
    attention at tp = 2) changes no gradient: every leaf of every rank's
    shard at tp = 2 and 4 against the same rank's without it.  A trunk
    scaled by tp, or a replicated leaf left with a partial sum, fails."""
    world, d, outs = ranks
    for tp, kw in d["losses"]:
        if not kw:
            continue
        case = tuple(sorted(kw.items()))
        for r, o in enumerate(outs):
            want = o["gpt"][("grads", tp, ())]
            got = o["gpt"][("grads", tp, case)]
            assert got.keys() == want.keys()
            for q in want:
                np.testing.assert_allclose(
                    got[q], want[q], rtol=GRAD_RTOL,
                    atol=GRAD_ATOL * np.abs(want[q]).max(),
                    err_msg=f"tp {tp} {kw} rank {r} {q}")
    JM.destroy_model_parallel()


def test_gradients_match_jax(ranks):
    """Without sequence parallelism each rank's gradients at tp = 2 and 4
    are its shard of the JAX package's (`jax.grad` of `GPT.loss` in
    `shard_map`), leaf by leaf."""
    from apex_tpu_torch.models.gpt import GPTConfig, partition_specs

    world, d, outs = ranks
    mesh = _mesh(world, world)
    model = JaxGPT(JaxGPTConfig(**CFG))
    specs = model.partition_specs()
    grads = jax.tree_util.tree_map(np.asarray, jax.jit(shard_map(
        jax.grad(model.loss), mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=specs, check_vma=False))(_jparams(), d["tokens"],
                                           d["labels"]))
    dims = partition_specs(GPTConfig(**CFG))
    for r, o in enumerate(outs):
        got = o["gpt"][("grads", world, ())]
        for q, g in got.items():
            want, dim = _leaf(grads, q), _leaf(dims, q)
            if dim is not None:
                want = np.split(want, world, axis=dim)[r]
            np.testing.assert_allclose(
                g, want, rtol=GRAD_RTOL, atol=GRAD_ATOL * np.abs(want).max(),
                err_msg=f"rank {r} {q}")
    JM.destroy_model_parallel()
