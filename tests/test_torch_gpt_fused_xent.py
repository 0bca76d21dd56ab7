"""`GPTConfig.fused_xent` in the port against the JAX package's, on the
CPU: forced True or False, with fp32 and with bf16 logits, the loss and
every gradient of the smoke GPT equal jax.value_and_grad of the JAX
model's loss with the same setting, at `tests/test_torch_gpt_train.py`'s
tolerances (fp32 logits: loss rtol 1e-5, grads within 1e-5 of each
leaf's largest; bf16 logits: grads within 2e-3, the bf16 rounding of the
logits' cotangent).  The field reaches the cross entropy as `fused=`,
and the port's config still holds every JAX field but the mesh's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.models.gpt import GPT as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.parallel import mesh as M
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.models.gpt import GPT, GPTConfig, params_from_jax

SMOKE = dict(vocab_size=512, seq_len=64, hidden=64, num_layers=2,
             num_heads=4, dropout=0.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as `test_torch_gpt_train.py` runs the plain
    versions once JAX is in the process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("logits", ["f32", "bf16"])
@pytest.mark.parametrize("fused", [True, False])
def test_fused_xent_loss_and_grads_match_jax(monkeypatch, fused, logits):
    M.destroy_model_parallel()
    mesh = M.initialize_model_parallel(devices=jax.devices()[:1])
    jl_dtype = jnp.bfloat16 if logits == "bf16" else None
    tl_dtype = torch.bfloat16 if logits == "bf16" else None
    jmodel = JaxGPT(JaxGPTConfig(**SMOKE, logits_dtype=jl_dtype,
                                 fused_xent=fused))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, 512, (2, 64)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    jloss_fn = shard_map(jmodel.loss, mesh=mesh,
                         in_specs=(jmodel.partition_specs(), P(), P()),
                         out_specs=P(), check_vma=False)
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(
        jparams, jnp.asarray(tokens), jnp.asarray(labels))

    seen = []
    xent = tgpt.vocab_parallel_cross_entropy
    monkeypatch.setattr(tgpt, "vocab_parallel_cross_entropy",
                        lambda *a, **kw: seen.append(kw.get("fused"))
                        or xent(*a, **kw))
    model = GPT(GPTConfig(**SMOKE, logits_dtype=tl_dtype, fused_xent=fused))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    leaves = jax.tree_util.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, torch.tensor(tokens), torch.tensor(labels))
    grads = torch.autograd.grad(loss, leaves)
    assert seen == [fused]
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    tol = 2e-3 if logits == "bf16" else 1e-5
    for got, want in zip(grads, jax.tree_util.tree_leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())
    M.destroy_model_parallel()


def test_config_fields_cover_the_jax_config():
    """Every JAX `GPTConfig` field, the mesh's among them (the
    tensor-parallel axis name, sequence parallelism and its overlap
    chunks), is a port field with the same default; `fused_xent` among
    them, None (the automatic choice) by default."""
    jf = {f.name: f.default for f in dataclasses.fields(JaxGPTConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(GPTConfig)}
    assert set(jf) == set(tf)
    assert {"axis_name", "sequence_parallel", "overlap_chunks"} <= set(tf)
    assert tf["fused_xent"] is None and jf["fused_xent"] is None
    for name in set(tf) - {"dtype", "logits_dtype"}:
        assert tf[name] == jf[name], name
    assert GPTConfig().fused_xent is None
