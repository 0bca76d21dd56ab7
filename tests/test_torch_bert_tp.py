"""The port's BERT across tensor-parallel ranks (apex_tpu_torch.models.bert
at tp = 2, transformer.training with FusedLAMB) against the JAX
package's `Bert` in `shard_map`, on the CPU.

A small BERT (vocab 128, seq 32, h32, L2, 4 heads, fp32) from the JAX
package's seeded weights; the batch has token types, a ragged padding
mask, a Bernoulli(0.15) MLM mask and NSP labels.  `params_from_jax(...,
tp_rank, tp_size=2)` must cut exactly the shards `shard_map` hands each
rank (it raised `KeyError: 'embed_ln'` while BERT borrowed GPT's cut).
The port runs as one 4-rank gloo world (tests/torch_dist_worker.py
scenario `bert_tp`, tp = 2 x dp = 2): each rank's loss at tp = 2, dense
and flash attention, within rtol 1e-5 of the JAX package's; then three
steps of make_tp_dp_train_step with FusedLAMB(lr=1e-4,
weight_decay=0.01, the no-decay mask), once with the whole batch on
both dp ranks (the tp = 2 x dp = 1 step, against a JAX 2-device mesh)
and once with the batch split over dp (against a JAX tp = 2 x dp = 2
mesh): the losses within rtol 1e-5, each rank's flat parameters within
rtol 1e-5 / atol 1e-6 of its rows of the JAX state
(tests/test_torch_gpt_tp.py's tolerances)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.models.bert import Bert as JaxBert
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.optimizers.fused_lamb import FusedLAMB as JaxFusedLAMB
from apex_tpu.parallel import mesh as JM
from apex_tpu.transformer import training as jax_training
from apex_tpu.transformer.pipeline_parallel.common import (
    get_params_for_weight_decay_optimization as jax_wd_mask)
from apex_tpu_torch.models.bert import (BertConfig, params_from_jax,
                                        partition_specs)

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

CFG = dict(vocab_size=128, seq_len=32, hidden=32, num_layers=2,
           num_heads=4)
BATCH = 4
LABELS = ("mlm", "mask", "nsp", "tt", "pad")


def _jparams():
    return JaxBert(JaxBertConfig(**CFG)).init(jax.random.PRNGKey(11))


def _batch(seed):
    rng = np.random.RandomState(seed)
    v, s = CFG["vocab_size"], CFG["seq_len"]
    tokens = rng.randint(0, v, (BATCH, s)).astype(np.int32)
    real = np.array([[s], [21], [s], [9]])
    return dict(tokens=tokens, mlm=np.roll(tokens, -1, axis=1),
                mask=rng.rand(BATCH, s) < 0.15,
                nsp=rng.randint(0, 2, (BATCH,)).astype(np.int32),
                tt=rng.randint(0, 2, (BATCH, s)).astype(np.int32),
                pad=np.arange(s)[None, :] >= real)


def _mesh(n):
    JM.destroy_model_parallel()
    return JM.initialize_model_parallel(tensor_model_parallel_size=2,
                                        devices=jax.devices()[:n])


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = {"cfg": CFG, "params": jax.tree_util.tree_map(np.asarray,
                                                      _jparams()),
         "batch": _batch(0), "steps": [_batch(10 + i) for i in range(3)]}
    outs = W.run_ranks(str(tmp_path_factory.mktemp("bert_tp")), 4,
                       {"scenarios": ["bert_tp"], "bert_tp": d})
    return d, [o["bert_tp"] for o in outs]


def test_params_from_jax_cuts_the_shard_map_shards():
    """Each rank's `params_from_jax(tree, tp_rank=r, tp_size=2)` is, leaf
    for leaf, exactly the shard `shard_map` hands rank r under the JAX
    `Bert.partition_specs()`; the port's partition_specs name the same
    dims."""
    mesh = _mesh(2)
    model = JaxBert(JaxBertConfig(**CFG))
    jspecs = model.partition_specs()
    stacked = jax.jit(shard_map(
        lambda p: jax.tree_util.tree_map(lambda x: x[None], p), mesh=mesh,
        in_specs=(jspecs,),
        out_specs=jax.tree_util.tree_map(lambda _: P("tp"), jspecs),
        check_vma=False))(_jparams())
    tree = jax.tree_util.tree_map(np.asarray, _jparams())
    dims = dict(_leaves(partition_specs(BertConfig(**CFG))))
    for path, spec in _leaves(jspecs):
        want = None if spec == P() else list(spec).index("tp")
        assert dims[path] == want, path
    for r in range(2):
        got = dict(_leaves(params_from_jax(tree, device="cpu", tp_rank=r,
                                           tp_size=2)))
        want = dict(_leaves(stacked))
        assert got.keys() == want.keys()
        for path, leaf in got.items():
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(want[path])[r],
                                          err_msg=f"rank {r} {path}")
    JM.destroy_model_parallel()


def test_losses_match_jax_at_tp2(ranks):
    """MLM + NSP with token types and the ragged padding mask, dense and
    flash attention, on every rank within rtol 1e-5 of the JAX `Bert`
    in `shard_map` over tp = 2."""
    d, outs = ranks
    mesh = _mesh(2)
    b = d["batch"]
    for flash in (False, True):
        model = JaxBert(JaxBertConfig(**CFG, use_flash_attention=flash))

        def loss(p, *a):
            return model.loss(p, a[0], a[1], a[2], nsp_labels=a[3],
                              tokentype_ids=a[4], pad_mask=a[5])

        want = float(jax.jit(shard_map(
            loss, mesh=mesh, in_specs=(model.partition_specs(),) + (P(),) * 6,
            out_specs=P(), check_vma=False))(
                _jparams(), *(jnp.asarray(b[k]) for k in ("tokens",)
                              + LABELS)))
        for r, o in enumerate(outs):
            np.testing.assert_allclose(float(o[("loss", flash)]), want,
                                       rtol=1e-5,
                                       err_msg=f"flash {flash} rank {r}")
    JM.destroy_model_parallel()


@pytest.mark.parametrize("name,devices", [("tp2", 2), ("tp2dp2", 4)])
def test_three_lamb_steps_match_jax(ranks, name, devices):
    """Three FusedLAMB steps at tp = 2 x dp = 1 and tp = 2 x dp = 2: the
    dp-averaged losses, and each rank's flat parameter buffer against
    rows [r·L, (r+1)·L) of the JAX state, r its tp rank."""
    d, outs = ranks
    mesh = _mesh(devices)
    jmodel = JaxBert(JaxBertConfig(**CFG))
    jparams = _jparams()
    jopt = JaxFusedLAMB(lr=1e-4, weight_decay=0.01, use_pallas=False,
                        wd_mask=jax_wd_mask(jparams))
    jstate = jax_training.init_sharded_optimizer(jopt, jmodel, jparams,
                                                 mesh)
    jstep = jax_training.make_tp_dp_train_step(
        jmodel, jopt, mesh, donate=False,
        loss_fn=lambda p, t, lab: jmodel.loss(
            p, t, lab[0], lab[1], lab[2], tokentype_ids=lab[3],
            pad_mask=lab[4]))
    losses = []
    for b in d["steps"]:
        jstate, loss = jstep(jstate, jnp.asarray(b["tokens"]),
                             tuple(jnp.asarray(b[k]) for k in LABELS))
        losses.append(float(loss))
    flat = np.asarray(jstate.params)
    per = flat.size // 2
    for r, o in enumerate(outs):
        got = o[name]
        assert got["step"] == int(jstate.step) == 3
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                                   err_msg=f"{name} rank {r}")
        rows = flat[o["tp_rank"] * per:(o["tp_rank"] + 1) * per]
        assert got["params"].shape == rows.shape
        np.testing.assert_allclose(got["params"], rows, rtol=1e-5,
                                   atol=1e-6, err_msg=f"{name} rank {r}")
    assert [o["tp_rank"] for o in outs] == [0, 1, 0, 1]
    JM.destroy_model_parallel()
