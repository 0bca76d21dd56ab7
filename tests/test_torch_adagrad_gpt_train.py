"""The slice as a whole: FusedAdagrad through the PyTorch port's
training step (apex_tpu_torch.transformer.training with models.gpt)
against the JAX package's, on the CPU.

Three steps of the CPU smoke configuration at bench.py:1275 (h64, L2,
4 heads, V512, seq 64, batch 2, flash attention) through the JAX
package's `make_tp_dp_train_step` on a one-device mesh, with its
FusedAdagrad running the Pallas Adagrad kernel in interpret mode, and
through the port's with its FusedAdagrad, from the same weights
(carried by `params_from_jax`) and the same seeded tokens.  fp32
throughout: the losses agree to 1e-5 relative and the final flat
parameter and sum-of-squares buffers to rtol 1e-5 / atol 1e-6, except on
the key third of each layer's qkv bias.  Its gradient is zero in exact
arithmetic (a bias on the keys adds the same q · b to every score of a
query's row, which the softmax cancels), so both packages see fp32
rounding noise there (|g| ~ 1e-11), and Adagrad's first update,
lr · g / (|g| + eps), turns that noise into a step of up to lr in either
direction: those elements are held to |Δp| <= 2 · lr a step and a sum
of squares below 1e-9 in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPT as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.optimizers.fused_adagrad import FusedAdagrad as JaxFusedAdagrad
from apex_tpu.parallel import mesh as M
from apex_tpu.transformer import training as jax_training
from apex_tpu_torch.models.gpt import GPT, GPTConfig, params_from_jax
from apex_tpu_torch.optimizers import FusedAdagrad
from apex_tpu_torch.transformer import training

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


@pytest.mark.parametrize("w_mode", [False, True])
def test_three_fused_adagrad_train_steps_match_jax(w_mode):
    M.destroy_model_parallel()
    mesh = M.initialize_model_parallel(devices=jax.devices()[:1])
    jmodel = JaxGPT(JaxGPTConfig(**SMOKE))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    kw = dict(lr=1e-3, weight_decay=0.01, adagrad_w_mode=w_mode)
    jopt = JaxFusedAdagrad(use_pallas=True, **kw)
    jstate = jax_training.init_sharded_optimizer(jopt, jmodel, jparams, mesh)
    jstep = jax_training.make_tp_dp_train_step(jmodel, jopt, mesh,
                                               donate=False)

    model = GPT(GPTConfig(**SMOKE))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    opt = FusedAdagrad(**kw)
    state = training.init_sharded_optimizer(opt, model, params)
    step = training.make_tp_dp_train_step(model, opt, device="cpu")
    np.testing.assert_array_equal(state.params.numpy(),
                                  np.asarray(jstate.params))

    rng = np.random.RandomState(0)
    for _ in range(3):
        tokens = rng.randint(0, SMOKE["vocab_size"], (2, 64)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        jstate, jloss = jstep(jstate, jnp.asarray(tokens),
                              jnp.asarray(labels))
        state, loss = step(state, torch.tensor(tokens), torch.tensor(labels))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(state.step) == int(jstate.step) == 3
    noise = np.zeros(state.params.numel(), bool)
    h = SMOKE["hidden"]
    for path, off in zip(opt.spec.paths, opt.spec.offsets):
        if path[1:] == ("qkv", "bias"):
            noise[off + h:off + 2 * h] = True
    assert noise.sum() == SMOKE["num_layers"] * h
    for got, want in ((state.params, jstate.params),
                      (state.sum_sq, jstate.sum_sq)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[~noise], want[~noise], rtol=1e-5,
                                   atol=1e-6)
    p, jp = state.params.numpy()[noise], np.asarray(jstate.params)[noise]
    assert np.all(np.abs(p - jp) <= 2 * kw["lr"] * 3 * (1 + 1e-6))
    assert state.sum_sq.numpy()[noise].max() < 1e-9
    assert np.asarray(jstate.sum_sq)[noise].max() < 1e-9
    M.destroy_model_parallel()
