"""The port's GPT with dropout and activation checkpointing (remat)
against the JAX package's, on the CPU.

Dropout: the two packages draw different bits from their keys, so the
parity test hands both the same masks — each package's mask draw
(`_common.dropout`, and the JAX flash path's `_dense_dropout`) is
replaced by a table of numpy masks taken in call order — and holds the
loss to 1e-5 relative and every gradient to 1e-5 of its leaf's largest
magnitude (fp32; measured ~1e-7).  Remat: the port recomputes each block
from generators it derives again from the layer's key, so every policy
gives the no-remat loss and gradients bit for bit, with dropout on and
off, on the dense path and on the flash path's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import apex_tpu.ops._common as jcommon
from apex_tpu.models.gpt import GPT as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.ops import flash_attention as jfa
from apex_tpu.parallel import mesh as M
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.models.gpt import GPT, GPTConfig, params_from_jax
from apex_tpu_torch.ops import _common
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer import training

SMALL = dict(vocab_size=256, seq_len=32, hidden=64, num_layers=2,
             num_heads=4, dropout=0.1)
POLICIES = [None, "dots", "names:attn_ctx,ffn1",
            "names:qkv,attn_out,ffn_out"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One CPU thread for the port (as the other GPT tests: once JAX has
    run in the process, torch's vector math on a worker thread sometimes
    loses precision)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(seed=1, b=2, s=32, v=256):
    t = np.random.RandomState(seed).randint(0, v, (b, s)).astype(np.int32)
    return t, np.roll(t, -1, axis=1)


def _loss_and_grads(model, params, tokens, labels, key):
    leaves = [t.detach().requires_grad_(True)
              for t in jax.tree_util.tree_leaves(params)]
    p = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params),
                                     leaves)
    loss = model.loss(p, torch.tensor(tokens), torch.tensor(labels), key=key)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("flash", [False, True])
def test_key_at_rate_zero_is_the_keyless_loss(flash):
    model = GPT(GPTConfig(**dict(SMALL, dropout=0.0,
                                 use_flash_attention=flash)))
    params = model.init(seed=0, device="cpu")
    tokens, labels = _tokens()
    a = _loss_and_grads(model, params, tokens, labels,
                        torch.Generator().manual_seed(5))
    b = _loss_and_grads(model, params, tokens, labels, None)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    # at rate 0.1 the key changes the loss; another key, another loss
    drop = GPT(GPTConfig(**dict(SMALL, use_flash_attention=flash)))
    c = _loss_and_grads(drop, params, tokens, labels,
                        torch.Generator().manual_seed(5))
    d = _loss_and_grads(drop, params, tokens, labels,
                        torch.Generator().manual_seed(6))
    assert not torch.equal(c[0], b[0]) and not torch.equal(c[0], d[0])


class _MaskTable:
    """Masks by call order: call i keeps where a numpy uniform draw
    seeded with 1000 + i is below 1 - rate."""

    def __init__(self):
        self.calls = []

    def __call__(self, shape, keep):
        m = np.random.RandomState(1000 + len(self.calls)).rand(*shape) < keep
        self.calls.append(tuple(shape))
        return m


@pytest.mark.parametrize("flash", [False, True])
def test_dropout_loss_and_grads_match_jax_with_the_same_masks(monkeypatch,
                                                              flash):
    jtable, ttable = _MaskTable(), _MaskTable()

    def jax_dropout(key, rate, x):
        if rate == 0.0 or key is None:
            return x
        m = jnp.asarray(jtable(x.shape, 1.0 - rate))
        return jnp.where(m, x / (1.0 - rate), jnp.zeros((), x.dtype))

    def torch_dropout(key, rate, x):
        if rate == 0.0 or key is None:
            return x
        m = torch.tensor(ttable(x.shape, 1.0 - rate))
        return torch.where(m, x / (1.0 - rate),
                           torch.zeros((), dtype=x.dtype))

    monkeypatch.setattr(jcommon, "dropout", jax_dropout)
    monkeypatch.setattr(jfa, "_dense_dropout", jax_dropout)
    monkeypatch.setattr(_common, "dropout", torch_dropout)
    M.destroy_model_parallel()
    mesh = M.initialize_model_parallel(devices=jax.devices()[:1])
    cfg = dict(SMALL, use_flash_attention=flash)
    jmodel = JaxGPT(JaxGPTConfig(**cfg))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tokens, labels = _tokens(seed=3)
    jloss_fn = shard_map(jmodel.loss, mesh=mesh,
                         in_specs=(jmodel.partition_specs(), P(), P(), P()),
                         out_specs=P(), check_vma=False)
    # traced once: the masks are taken in the forward's call order
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(
        jparams, jnp.asarray(tokens), jnp.asarray(labels),
        jax.random.PRNGKey(0))
    model = GPT(GPTConfig(**cfg))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    loss, grads = _loss_and_grads(model, params, tokens, labels,
                                  torch.Generator().manual_seed(0))
    # three masks a layer: the attention weights and both residuals
    assert ttable.calls == jtable.calls and len(ttable.calls) == 6
    assert ttable.calls[0] == (2, 4, 32, 32)
    assert ttable.calls[1] == ttable.calls[2] == (32, 2, 64)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for got, want in zip(grads, jax.tree_util.tree_leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    M.destroy_model_parallel()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("flash", [False, True])
def test_remat_gives_the_grads_bit_for_bit(policy, rate, flash):
    cfg = dict(SMALL, dropout=rate, use_flash_attention=flash)
    params = GPT(GPTConfig(**cfg)).init(seed=0, device="cpu")
    tokens, labels = _tokens(seed=4)
    want = _loss_and_grads(GPT(GPTConfig(**cfg)), params, tokens, labels,
                           torch.Generator().manual_seed(9))
    got = _loss_and_grads(
        GPT(GPTConfig(**cfg, remat=True, remat_policy=policy)), params,
        tokens, labels, torch.Generator().manual_seed(9))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(x, y) for x, y in zip(got[1], want[1]))


def test_remat_keeps_what_the_policy_names(monkeypatch):
    """"dots" keeps each matmul's output (four GEMMs and the dense path's
    two batched products a layer), "names:attn_ctx,ffn1" the two tagged
    tensors a layer; None keeps nothing (no policy runs)."""
    from torch.utils.checkpoint import CheckpointPolicy

    tokens, labels = _tokens(seed=5)
    for policy, want in (("dots", {"aten.mm.default": 8,
                                   "aten.bmm.default": 4}),
                         ("names:attn_ctx,ffn1", {"aten.alias.default": 4}),
                         (None, {})):
        model = GPT(GPTConfig(**SMALL, remat=True, remat_policy=policy))
        kept = {}
        real = model._keeps

        def spy(ctx, func, *args, _real=real, _kept=kept, **kwargs):
            out = _real(ctx, func, *args, **kwargs)
            if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                _kept[str(func)] = _kept.get(str(func), 0) + 1
            return out

        model._keeps = spy
        params = model.init(seed=0, device="cpu")
        _loss_and_grads(model, params, tokens, labels,
                        torch.Generator().manual_seed(1))
        assert kept == want, policy


def test_cn_adds_no_op_without_remat():
    x = torch.ones(3)
    for cfg in (dict(SMALL), dict(SMALL, remat=True),
                dict(SMALL, remat=True, remat_policy="dots")):
        assert GPT(GPTConfig(**cfg))._cn(x, "qkv") is x
    named = GPT(GPTConfig(**SMALL, remat=True, remat_policy="names:qkv"))
    y = named._cn(x, "qkv")
    assert y is not x and y.data_ptr() == x.data_ptr()
    assert set(tgpt.REMAT_TAGS) == {"qkv", "attn_ctx", "attn_out", "ffn1",
                                    "ffn_out"}
    with pytest.raises(AssertionError):
        named._cn(x, "nope")


@pytest.mark.parametrize("policy", ["names:qkv,bogus", "bogus", "names:"])
def test_remat_policy_errors_are_jax_s(policy):
    """An unknown tag or policy raises the JAX package's ValueError, word
    for word, when the model runs; "names:" with no tag keeps nothing in
    both."""
    M.destroy_model_parallel()
    mesh = M.initialize_model_parallel(devices=jax.devices()[:1])
    cfg = dict(SMALL, dropout=0.0, remat=True, remat_policy=policy)
    jmodel = JaxGPT(JaxGPTConfig(**cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens, labels = _tokens()
    jloss_fn = shard_map(jmodel.loss, mesh=mesh,
                         in_specs=(jmodel.partition_specs(), P(), P()),
                         out_specs=P(), check_vma=False)
    model = GPT(GPTConfig(**cfg))
    params = model.init(seed=0, device="cpu")
    if policy == "names:":
        jl = jloss_fn(jparams, jnp.asarray(tokens), jnp.asarray(labels))
        assert np.isfinite(float(jl))
        loss, _ = _loss_and_grads(model, params, tokens, labels, None)
        assert torch.isfinite(loss)
        M.destroy_model_parallel()
        return
    with pytest.raises(ValueError) as jerr:
        jloss_fn(jparams, jnp.asarray(tokens), jnp.asarray(labels))
    with pytest.raises(ValueError) as terr:
        model.loss(params, torch.tensor(tokens), torch.tensor(labels))
    assert str(terr.value) == str(jerr.value)
    M.destroy_model_parallel()


def test_dropout_train_step_takes_a_step_key():
    """The training step passes no key (as the JAX step); a dropout step
    gets one through `loss_fn`, a fresh one each step: three remat steps
    on the CPU, each equal bit for bit to the same step without remat."""
    def run(remat):
        model = GPT(GPTConfig(**SMALL, use_flash_attention=True,
                              remat=remat))
        opt = FusedAdam(lr=1e-3)
        state = training.init_sharded_optimizer(
            opt, model, model.init(seed=0, device="cpu"))
        keys = iter(torch.Generator().manual_seed(100 + i) for i in range(3))
        step = training.make_tp_dp_train_step(
            model, opt, device="cpu",
            loss_fn=lambda p, t, lab: model.loss(p, t, lab, key=next(keys)))
        tokens, labels = (torch.tensor(x) for x in _tokens(seed=6))
        losses = []
        for _ in range(3):
            state, loss = step(state, tokens, labels)
            losses.append(loss)
        return state, losses

    plain, losses = run(False)
    again, remat_losses = run(True)
    assert all(torch.isfinite(x) for x in losses)
    assert all(torch.equal(a, b) for a, b in zip(losses, remat_losses))
    assert torch.equal(plain.params, again.params)
