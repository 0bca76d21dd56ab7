"""The PyTorch port's GPT parameters (seeded init, the converter from the
JAX package's tree), its recompile sentry and its `_common` helpers, on
the CPU, against the JAX package where both have the function."""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import gpt as jgpt
from apex_tpu.models.gpt import GPT, GPTConfig
from apex_tpu.ops import _common as jcommon
from apex_tpu_torch.models import GPT2_350M
from apex_tpu_torch.models import GPTConfig as TGPTConfig
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.models import init_gpt_params, params_from_jax
from apex_tpu_torch.monitor.compile import RecompileSentry
from apex_tpu_torch.ops import _common as tcommon

_KW = dict(vocab_size=96, seq_len=32, hidden=32, num_layers=2, num_heads=4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_jax_tree_and_distributions(dtype):
    jtree = _flat(GPT(GPTConfig(dtype=getattr(jnp, dtype), **_KW)).init(
        jax.random.PRNGKey(0)))
    cfg = TGPTConfig(dtype=getattr(torch, dtype), **_KW)
    ttree = _flat(init_gpt_params(cfg, seed=0, device="cpu"))
    assert sorted(ttree) == sorted(jtree)
    for k, t in ttree.items():
        assert tuple(t.shape) == tuple(jtree[k].shape), k
        assert str(t.dtype).replace("torch.", "") == str(jtree[k].dtype), k
    out_std = 0.02 / math.sqrt(2 * cfg.num_layers)
    for k, t in ttree.items():
        t = t.float()
        if k.endswith(("ln1.weight", "ln2.weight")) or k == "final_ln.weight":
            assert torch.equal(t, torch.ones_like(t)), k
        elif k.endswith("bias"):
            assert torch.equal(t, torch.zeros_like(t)), k
        else:
            want = out_std if (".proj." in k or ".fc2." in k) else 0.02
            assert abs(t.std().item() / want - 1) < 0.15, k
            assert abs(t.mean().item()) < 0.2 * want, k


def test_init_is_seeded():
    cfg = TGPTConfig(**_KW)
    a = init_gpt_params(cfg, seed=3, device="cpu")
    b = init_gpt_params(cfg, seed=3, device="cpu")
    c = init_gpt_params(cfg, seed=4, device="cpu")
    assert torch.equal(a["block1"]["fc1"]["weight"],
                       b["block1"]["fc1"]["weight"])
    assert not torch.equal(a["embed"]["weight"], c["embed"]["weight"])
    assert GPT2_350M == dict(hidden=1024, num_layers=24, num_heads=16)
    assert TGPTConfig(**GPT2_350M).head_dim == 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_exact(dtype):
    jp = GPT(GPTConfig(dtype=getattr(jnp, dtype), **_KW)).init(
        jax.random.PRNGKey(1))
    tp = _flat(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu"))
    for k, j in _flat(jp).items():
        t = tp[k]
        assert t.dtype == getattr(torch, dtype), k
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j.astype(jnp.float32)))
    cast = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu", dtype=torch.float16)
    assert cast["pos_embed"].dtype == torch.float16


def test_params_from_jax_copies():
    src = {"w": np.ones((2, 2), np.float32)}
    t = params_from_jax(src, device="cpu")
    src["w"][0, 0] = 5.0
    assert t["w"][0, 0].item() == 1.0


def test_sentry_counts_steady_signature_changes():
    calls = []
    sentry = RecompileSentry(lambda *a, **k: calls.append(1) or len(calls),
                             name="step")
    x = torch.zeros(4, 3)
    state = {"a": torch.zeros(2, dtype=torch.int32), "b": (x, 1.5)}
    assert sentry(x, state) == 1
    assert sentry(x + 1, state) == 2        # same signature: values differ
    sentry.mark_steady()
    assert sentry(torch.ones(4, 3), state) == 3
    assert sentry.summary() == {"calls": 3, "n_compiles": 1,
                                "n_signatures": 1, "steady_recompiles": 0}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sentry(torch.zeros(5, 3), state)                    # shape
        sentry(x.to(torch.float64), state)                  # dtype
        sentry(x, {"a": state["a"], "b": (x, 2.5)})         # scalar value
    assert sentry.steady_recompiles == 3
    assert sum("steady-state" in str(m.message) for m in w) == 1  # once
    assert [e["kind"] for e in sentry.events] == [
        "compile", "retrace", "retrace", "retrace"]
    assert all(e["steady_state"] for e in sentry.events[1:])


@pytest.mark.parametrize("rows,hidden", [(5, 32), (64, 1024), (4096, 50304),
                                         (1, 7), (300, 128)])
def test_row_helpers_match_jax(rows, hidden):
    assert tcommon.row_block(rows, hidden) == jcommon.row_block(rows, hidden)
    assert tcommon.round_up(rows, 8) == jcommon.round_up(rows, 8)


def test_resolve_device():
    assert tcommon.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcommon.resolve_device()


@pytest.mark.parametrize("build,preset", [("gpt_350m", "GPT2_350M"),
                                          ("gpt_1p3b", "GPT2_1p3B")])
def test_presets_match_jax(build, preset):
    """`gpt_350m()` / `gpt_1p3b()` build the JAX presets' hidden size,
    depth and heads, and take `GPTConfig` overrides as the JAX ones do."""
    assert getattr(tgpt, preset) == getattr(jgpt, preset)
    jm = getattr(jgpt, build)(seq_len=8192)
    tm = getattr(tgpt, build)(seq_len=8192)
    for field in ("hidden", "num_layers", "num_heads", "seq_len",
                  "head_dim"):
        assert getattr(tm.c, field) == getattr(jm.c, field), field


@pytest.mark.parametrize("which", ["gpt", "bert"])
def test_configs_carry_the_attention_knobs_as_jax_does(which, monkeypatch):
    """GPTConfig and BertConfig have the JAX configs' three attn_* fields
    (default None, the presets too), and the flash path hands them to
    `flash_attention` as the JAX models do."""
    from apex_tpu.models import bert as jbert
    from apex_tpu_torch.models import bert as tbert

    jmod, tmod = (jgpt, tgpt) if which == "gpt" else (jbert, tbert)
    jcfg, tcfg = ((jgpt.GPTConfig, tgpt.GPTConfig) if which == "gpt"
                  else (jbert.BertConfig, tbert.BertConfig))
    knobs = ("attn_block_q", "attn_block_k", "attn_heads_per_step")
    for f in knobs:
        assert getattr(tcfg(), f) is None is getattr(jcfg(), f), f
    if which == "gpt":
        assert all(getattr(tgpt.gpt_350m().c, f) is None for f in knobs)
        assert tgpt.gpt_1p3b(attn_heads_per_step=2).c.attn_heads_per_step \
            == jgpt.gpt_1p3b(attn_heads_per_step=2).c.attn_heads_per_step
    seen = []

    def flash(q, k, v, **kw):
        seen.append({f: kw[f] for f in ("block_q", "block_k",
                                        "heads_per_step")})
        return q

    monkeypatch.setattr(tmod, "flash_attention", flash)
    small = dict(vocab_size=96, seq_len=32, hidden=32, num_layers=2,
                 num_heads=4, use_flash_attention=True, attn_block_q=32,
                 attn_block_k=16, attn_heads_per_step=2)
    if which == "gpt":
        model = tgpt.GPT(tgpt.GPTConfig(**small))
        params = model.init(seed=0, device="cpu")
        tokens = torch.zeros(2, 32, dtype=torch.int64)
        model.loss(params, tokens, tokens)
    else:
        model = tbert.Bert(tbert.BertConfig(**small))
        params = model.init(seed=0, device="cpu")
        tokens = torch.zeros(2, 32, dtype=torch.int64)
        model.loss(params, tokens, tokens, torch.ones(2, 32, dtype=torch.bool),
                   torch.zeros(2, dtype=torch.int64))
    assert seen == [{"block_q": 32, "block_k": 16, "heads_per_step": 2}] * 2
