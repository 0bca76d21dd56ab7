"""The PyTorch port's training step (apex_tpu_torch.models.gpt.GPT,
transformer.training, tensor_parallel cross entropy) against the JAX
package's, on the CPU, with flash attention and with the default dense
attention and FusedAdam's no-decay groups.

The slice as a whole: three steps of the CPU smoke configuration at
bench.py:1275 (h64, L2, 4 heads, V512, seq 64, batch 2, flash
attention) through the JAX package's `make_tp_dp_train_step` on a
one-device mesh and through the port's, from the same weights (carried
by `params_from_jax`) and the same seeded tokens.  fp32 throughout: the
losses agree to 1e-5 relative (measured 8e-8) and the final flat
parameter buffers to rtol 1e-5 / atol 1e-6 (measured 5.8e-7 at most,
0.2 % of the three-step update of 3e-4: Adam's m/sqrt(v) magnifies the
last-digit differences of near-zero grads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.models.gpt import GPT as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.ops.fused_dense import qkv_split_heads as jax_qkv_split
from apex_tpu.optimizers.fused_adam import FusedAdam as JaxFusedAdam
from apex_tpu.parallel import mesh as M
from apex_tpu.transformer import training as jax_training
from apex_tpu.transformer.pipeline_parallel.common import (
    get_params_for_weight_decay_optimization as jax_wd_mask)
from apex_tpu.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy as jax_xent)
from apex_tpu_torch.models.gpt import GPT, GPTConfig, params_from_jax
from apex_tpu_torch.ops.fused_dense import qkv_split_heads
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer import training
from apex_tpu_torch.transformer.pipeline_parallel import (
    get_params_for_weight_decay_optimization)
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy)

SMOKE = dict(vocab_size=512, seq_len=64, hidden=64, num_layers=2,
             num_heads=4, dropout=0.0, use_flash_attention=True)


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


def test_three_train_steps_match_jax():
    mesh = _one_device_mesh()
    jmodel = JaxGPT(JaxGPTConfig(**SMOKE))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt = JaxFusedAdam(lr=1e-4, use_pallas=False)
    jstate = jax_training.init_sharded_optimizer(jopt, jmodel, jparams, mesh)
    jstep = jax_training.make_tp_dp_train_step(jmodel, jopt, mesh,
                                               donate=False)

    model = GPT(GPTConfig(**SMOKE))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    opt = FusedAdam(lr=1e-4)
    state = training.init_sharded_optimizer(opt, model, params)
    step = training.make_tp_dp_train_step(model, opt, device="cpu")
    # same leaf order, same weights: the flat buffers start identical
    np.testing.assert_array_equal(state.params.numpy(),
                                  np.asarray(jstate.params))

    rng = np.random.RandomState(0)
    for _ in range(3):
        tokens = rng.randint(0, SMOKE["vocab_size"], (2, 64)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        jstate, jloss = jstep(jstate, jnp.asarray(tokens),
                              jnp.asarray(labels))
        state, loss = step(state, torch.tensor(tokens), torch.tensor(labels))
        assert loss.device.type == "cpu" and loss.ndim == 0
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(state.step) == int(jstate.step) == 3
    np.testing.assert_allclose(state.params.numpy(),
                               np.asarray(jstate.params), rtol=1e-5,
                               atol=1e-6)
    M.destroy_model_parallel()


def test_three_dense_steps_with_no_decay_groups_match_jax():
    """The slice of the dense path: the same smoke configuration with the
    models' default attention (use_flash_attention=False: the S² scores,
    the causal scaled softmax, the probabilities times v) and
    FusedAdam(weight_decay=0.01, wd_mask=the no-decay recipe), three
    steps through each package's `make_tp_dp_train_step`.  The JAX
    optimizer runs its segmented Pallas kernel in interpret mode; the
    JAX model's softmax runs its reference on the CPU, as its own tests
    do.  `params_from_jax` carries the weights over unchanged: the dense
    path reads the same leaves as the flash path.  fp32, the flash
    step's seeds and tolerances: losses rtol 1e-5, flat params rtol 1e-5
    / atol 1e-6.  (Adam's m / (sqrt(v) + eps) is ~g / eps for a gradient
    near eps, which magnifies that gradient's last-digit differences:
    with weights from PRNGKey(2) and tokens from RandomState(5), one of
    the 196,608 params, whose first gradient is 8.8e-10 in one package
    and 1.4e-9 in the other against a leaf maximum of 1e-2, ends 4.3e-6
    apart.  `test_dense_loss_and_grads_match_jax` holds the gradients
    themselves.)"""
    mesh = _one_device_mesh()
    cfg = dict(SMOKE, use_flash_attention=False)
    jmodel = JaxGPT(JaxGPTConfig(**cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt = JaxFusedAdam(lr=1e-4, weight_decay=0.01, use_pallas=True,
                        wd_mask=jax_wd_mask(jparams))
    jstate = jax_training.init_sharded_optimizer(jopt, jmodel, jparams, mesh)
    jstep = jax_training.make_tp_dp_train_step(jmodel, jopt, mesh,
                                               donate=False)

    model = GPT(GPTConfig(**cfg))
    assert not GPTConfig().use_flash_attention          # the default path
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    opt = FusedAdam(lr=1e-4, weight_decay=0.01,
                    wd_mask=get_params_for_weight_decay_optimization(params))
    state = training.init_sharded_optimizer(opt, model, params)
    step = training.make_tp_dp_train_step(model, opt, device="cpu")
    np.testing.assert_array_equal(state.params.numpy(),
                                  np.asarray(jstate.params))
    np.testing.assert_array_equal(opt._seg_wd.numpy(),
                                  np.asarray(jopt._seg_wd))
    assert 0 < int((opt._seg_wd > 0).sum()) < len(opt.spec.sizes)

    rng = np.random.RandomState(0)
    for _ in range(3):
        tokens = rng.randint(0, SMOKE["vocab_size"], (2, 64)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        jstate, jloss = jstep(jstate, jnp.asarray(tokens),
                              jnp.asarray(labels))
        state, loss = step(state, torch.tensor(tokens), torch.tensor(labels))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(state.step) == int(jstate.step) == 3
    np.testing.assert_allclose(state.params.numpy(),
                               np.asarray(jstate.params), rtol=1e-5,
                               atol=1e-6)
    M.destroy_model_parallel()


def test_dense_loss_and_grads_match_jax():
    """The dense path's loss and every gradient against
    jax.value_and_grad of the JAX model's loss (its softmax reference on
    the CPU), on weights carried by `params_from_jax`: fp32, loss rtol
    1e-5, grads within 1e-5 of each leaf's largest (measured 8e-7)."""
    mesh = _one_device_mesh()
    cfg = dict(SMOKE, use_flash_attention=False)
    jmodel = JaxGPT(JaxGPTConfig(**cfg))
    jparams = jmodel.init(jax.random.PRNGKey(2))
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, 512, (2, 64)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    jloss_fn = shard_map(jmodel.loss, mesh=mesh,
                         in_specs=(jmodel.partition_specs(), P(), P()),
                         out_specs=P(), check_vma=False)
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(
        jparams, jnp.asarray(tokens), jnp.asarray(labels))
    model = GPT(GPTConfig(**cfg))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    leaves = jax.tree_util.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, torch.tensor(tokens), torch.tensor(labels))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for got, want in zip(grads, jax.tree_util.tree_leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    M.destroy_model_parallel()


def test_dense_and_flash_attention_agree():
    """The two attention paths compute one function: the dense forward
    and every gradient equal the flash path's (both plain versions on
    the CPU) to fp32 rounding, atol 1e-5 of each leaf's largest."""
    dense = GPT(GPTConfig(**dict(SMOKE, use_flash_attention=False)))
    flash = GPT(GPTConfig(**SMOKE))
    params = dense.init(seed=3, device="cpu")
    tokens = torch.tensor(np.random.RandomState(4).randint(0, 512, (2, 64)))
    labels = torch.roll(tokens, -1, dims=1)
    leaves = jax.tree_util.tree_leaves(params)
    out = []
    for model in (dense, flash):
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(params, tokens, labels)
        out.append((loss.item(), torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_entropy_matches_jax(dtype, fused, smoothing):
    """Per-token loss and dlogits (cotangent: seeded per-token weights),
    fused and unfused, against the JAX package's at tp=1.  fp32 logits:
    atol 1e-5; bf16 logits: the loss in fp32 to 1e-5, dlogits (bf16)
    within one bf16 ulp plus 1e-7."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    rng = np.random.RandomState(3)
    logits = (rng.randn(16, 3, 100) * 3).astype(np.float32)
    labels = rng.randint(0, 100, (16, 3)).astype(np.int32)
    cot = rng.rand(16, 3).astype(np.float32)
    mesh = _one_device_mesh()

    def jloss(x, y):
        return shard_map(
            lambda x_, y_: jax_xent(x_, y_, smoothing, fused=fused),
            mesh=mesh, in_specs=(P(), P()), out_specs=P(),
            check_vma=False)(x, y)

    jx = jnp.asarray(logits).astype(jdt)
    jl, jdx = jax.jit(lambda x, y, c: (
        jloss(x, y), jax.vjp(lambda x_: jloss(x_, y), x)[1](c)[0]))(
            jx, jnp.asarray(labels), jnp.asarray(cot))
    tx = torch.tensor(logits).to(tdt).requires_grad_(True)
    tl = vocab_parallel_cross_entropy(tx, torch.tensor(labels), smoothing,
                                      fused=fused)
    tl.backward(torch.tensor(cot))
    assert tl.dtype == torch.float32 and tx.grad.dtype == tdt
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-5, rtol=0)
    want = np.asarray(jdx.astype(jnp.float32))
    got = tx.grad.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        _, e = np.frexp(np.abs(want))
        assert np.all(np.abs(got - want)
                      <= np.ldexp(np.ones_like(want), e - 8) + 1e-7)
    M.destroy_model_parallel()


def test_bf16_logits_loss_and_grads_match_jax():
    """The bench's LM-head choice — bf16 logits, so the fused cross
    entropy — on the fp32 smoke model: loss and every gradient against
    jax.value_and_grad of the JAX model's loss.  The logits are rounded
    to bf16 on both sides: loss rtol 1e-5, grads within 2e-3 of each
    leaf's largest gradient (bf16 rounding of the logits' cotangent)."""
    mesh = _one_device_mesh()
    cfg = dict(SMOKE, logits_dtype="bf16")
    jmodel = JaxGPT(JaxGPTConfig(**dict(cfg, logits_dtype=jnp.bfloat16)))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 512, (2, 64)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    jloss_fn = shard_map(jmodel.loss, mesh=mesh,
                         in_specs=(jmodel.partition_specs(), P(), P()),
                         out_specs=P(), check_vma=False)
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(
        jparams, jnp.asarray(tokens), jnp.asarray(labels))
    model = GPT(GPTConfig(**dict(cfg, logits_dtype=torch.bfloat16)))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    leaves = jax.tree_util.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, torch.tensor(tokens), torch.tensor(labels))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for got, want in zip(grads, jax.tree_util.tree_leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-3 * np.abs(want).max())
    M.destroy_model_parallel()


def test_qkv_split_heads_matches_jax():
    x = np.random.RandomState(2).randn(5, 3, 3 * 4 * 8).astype(np.float32)
    for got, want in zip(qkv_split_heads(torch.tensor(x), 4, 8),
                         jax_qkv_split(jnp.asarray(x), 4, 8)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_what_the_step_refuses():
    """An unknown remat policy raises by name (the JAX package's
    ValueError) when the model runs; the entry point runs on the card
    unless asked for the CPU, so without CUDA it refuses."""
    bad = GPT(GPTConfig(**dict(SMOKE, remat=True, remat_policy="bogus")))
    tokens = torch.zeros((2, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="unknown remat_policy 'bogus'"):
        bad.loss(bad.init(seed=0, device="cpu"), tokens, tokens)
    model = GPT(GPTConfig(**SMOKE))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            training.make_tp_dp_train_step(model, FusedAdam())
    step = training.make_tp_dp_train_step(model, FusedAdam(), device="cpu")
    with pytest.raises(RuntimeError, match="init_sharded_optimizer"):
        step(None, None, None)
