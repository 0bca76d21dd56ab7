"""The PyTorch port's BERT pretraining step (apex_tpu_torch.models.bert,
FusedLAMB with the no-decay mask, transformer.training) against the JAX
package's, on the CPU.

The slice as a whole: the bench's CPU shape (`bench.py:304`: hidden
128, 2 layers, 4 heads, seq 64, batch 2, vocab 30528) in fp32 with flash
attention (padding-masked: segment ids) and, for the loss and grads,
with the default dense attention (the masked scaled softmax), weights
carried from the JAX model by `params_from_jax`.  Tolerances: the loss
within 1e-5 relative; gradients within 1e-5 of each leaf's largest;
after three FusedLAMB steps the flat params within rtol 1e-5 / atol
1e-6 (fp32 throughout: both packages compute the same formulas in other
orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.models.bert import Bert as JaxBert
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.optimizers.fused_lamb import FusedLAMB as JaxFusedLAMB
from apex_tpu.parallel import mesh as M
from apex_tpu.transformer import training as jax_training
from apex_tpu.transformer.pipeline_parallel.common import (
    get_params_for_weight_decay_optimization as jax_wd_mask)
from apex_tpu_torch.models.bert import Bert, BertConfig, params_from_jax
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.transformer import training
from apex_tpu_torch.transformer.pipeline_parallel import (
    get_params_for_weight_decay_optimization)

CPU_BENCH = dict(vocab_size=30528, seq_len=64, hidden=128, num_layers=2,
                 num_heads=4, use_flash_attention=True)
BATCH = 2


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


def _one_device_mesh():
    M.destroy_model_parallel()
    return M.initialize_model_parallel(devices=jax.devices()[:1])


def _data(seed):
    """The bench's batch: random tokens, MLM labels = tokens rolled by -1,
    a Bernoulli(0.15) loss mask, random NSP labels, random token types,
    and a ragged padding mask (row 0 unpadded, row 1 with 41 real
    tokens)."""
    rng = np.random.RandomState(seed)
    v, s = CPU_BENCH["vocab_size"], CPU_BENCH["seq_len"]
    tokens = rng.randint(0, v, (BATCH, s)).astype(np.int32)
    return dict(tokens=tokens, mlm=np.roll(tokens, -1, axis=1),
                mask=rng.rand(BATCH, s) < 0.15,
                nsp=rng.randint(0, 2, (BATCH,)).astype(np.int32),
                tt=rng.randint(0, 2, (BATCH, s)).astype(np.int32),
                pad=np.arange(s)[None, :] >= np.array([[s], [41]]))


def _models(seed=0, flash=True):
    cfg = dict(CPU_BENCH, use_flash_attention=flash)
    jmodel = JaxBert(JaxBertConfig(**cfg))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = Bert(BertConfig(**cfg))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jmodel, jparams, model, params


def test_loss_and_grads_with_nsp_and_ragged_pad_mask_match_jax():
    """MLM + NSP loss with token types and a ragged padding mask, and
    every leaf's gradient, against jax.value_and_grad of `Bert.loss`."""
    _check_loss_and_grads(flash=True)


def test_dense_loss_and_grads_with_ragged_pad_mask_match_jax():
    """The same with the models' default dense attention
    (use_flash_attention=False): the (B, 1, 1, S) padding mask into the
    masked scaled softmax (the JAX model's reference on the CPU).
    `params_from_jax` carries the weights over unchanged: the dense path
    reads the same leaves as the flash path."""
    assert not BertConfig().use_flash_attention     # the default path
    _check_loss_and_grads(flash=False)


def _check_loss_and_grads(flash):
    mesh = _one_device_mesh()
    jmodel, jparams, model, params = _models(flash=flash)
    d = _data(1)

    def jloss(p, t, lm, m, n, tt, pm):
        return jmodel.loss(p, t, lm, m, nsp_labels=n, tokentype_ids=tt,
                           pad_mask=pm)

    f = shard_map(jloss, mesh=mesh,
                  in_specs=(jmodel.partition_specs(),) + (P(),) * 6,
                  out_specs=P(), check_vma=False)
    jl, jg = jax.jit(jax.value_and_grad(f))(
        jparams, *(jnp.asarray(d[k]) for k in ("tokens", "mlm", "mask",
                                                "nsp", "tt", "pad")))
    leaves = F.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, *(torch.tensor(d[k]) for k in (
        "tokens", "mlm", "mask", "nsp")),
        tokentype_ids=torch.tensor(d["tt"]), pad_mask=torch.tensor(d["pad"]))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for got, want in zip(grads, jleaves):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    M.destroy_model_parallel()


def test_pad_mask_hides_padded_tokens():
    """≡ the JAX package's test_bert_pad_mask: changing the padded tokens
    does not change the unpadded positions' output."""
    cfg = dict(vocab_size=64, seq_len=16, hidden=32, num_layers=2,
               num_heads=4, use_flash_attention=True)
    model = Bert(BertConfig(**cfg))
    params = model.init(seed=5, device="cpu")
    rng = np.random.RandomState(0)
    tokens = torch.tensor(rng.randint(0, 64, (2, 16)))
    pad = torch.zeros((2, 16), dtype=torch.bool)
    pad[:, 8:] = True
    h = model.encode(params, tokens, pad_mask=pad)
    tokens2 = tokens.clone()
    tokens2[:, 8:] = 0
    h2 = model.encode(params, tokens2, pad_mask=pad)
    assert h.shape == (16, 2, 32)
    np.testing.assert_allclose(h[:8].detach().numpy(),
                               h2[:8].detach().numpy(), rtol=1e-4, atol=1e-5)
    assert not torch.allclose(h[8:], h2[8:])


def test_three_lamb_steps_match_jax():
    """Three steps of FusedLAMB(lr=1e-4, weight_decay=0.01, wd_mask=the
    no-decay mask) through both packages' make_tp_dp_train_step on a
    one-device mesh, labels passed as the tuple (mlm, mask, nsp)."""
    mesh = _one_device_mesh()
    jmodel, jparams, model, params = _models(seed=2)
    jmask = jax_wd_mask(jparams)
    mask = get_params_for_weight_decay_optimization(params)
    assert F.tree_leaves(mask) == jax.tree_util.tree_leaves(jmask)
    jopt = JaxFusedLAMB(lr=1e-4, weight_decay=0.01, use_pallas=False,
                        wd_mask=jmask)
    jstate = jax_training.init_sharded_optimizer(jopt, jmodel, jparams, mesh)
    jstep = jax_training.make_tp_dp_train_step(
        jmodel, jopt, mesh, donate=False,
        loss_fn=lambda p, t, l: jmodel.loss(p, t, l[0], l[1], l[2]))
    opt = FusedLAMB(lr=1e-4, weight_decay=0.01, wd_mask=mask)
    state = training.init_sharded_optimizer(opt, model, params)
    step = training.make_tp_dp_train_step(
        model, opt, device="cpu",
        loss_fn=lambda p, t, l: model.loss(p, t, l[0], l[1], l[2]))
    np.testing.assert_array_equal(state.params.numpy(),
                                  np.asarray(jstate.params))
    for i in range(3):
        d = _data(10 + i)
        jstate, jloss = jstep(jstate, jnp.asarray(d["tokens"]),
                              tuple(jnp.asarray(d[k])
                                    for k in ("mlm", "mask", "nsp")))
        state, loss = step(state, torch.tensor(d["tokens"]),
                           tuple(torch.tensor(d[k])
                                 for k in ("mlm", "mask", "nsp")))
        assert loss.device.type == "cpu" and loss.ndim == 0
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(state.step) == int(jstate.step) == 3
    np.testing.assert_allclose(state.params.numpy(),
                               np.asarray(jstate.params), rtol=1e-5,
                               atol=1e-6)
    M.destroy_model_parallel()


def test_what_bert_refuses():
    """A head count that does not divide the width is refused; the entry
    point runs on the card unless asked for the CPU."""
    with pytest.raises(ValueError, match="divide"):
        Bert(BertConfig(**dict(CPU_BENCH, num_heads=3)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Bert(BertConfig(**CPU_BENCH)).init()
