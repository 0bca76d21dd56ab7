"""The PyTorch port's serving slice as a whole, held against the JAX
package on the CPU: the port's `DecodeEngine` (plain PyTorch versions of
its kernels, device="cpu") must emit exactly the JAX engine's tokens on
one shared set of weights, and keep the engine's contracts (fixed
shapes, drained pool, EOS).  Also: the port's entry points refuse to run
without CUDA unless asked for the CPU, and the port never imports JAX or
the JAX package."""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPT, GPTConfig
from apex_tpu.serve import DecodeEngine, ServeConfig
from apex_tpu_torch.models import GPTConfig as TGPTConfig
from apex_tpu_torch.models import params_from_jax
from apex_tpu_torch.serve import DecodeEngine as TDecodeEngine
from apex_tpu_torch.serve import ServeConfig as TServeConfig
from apex_tpu_torch.serve import build_flagship_engine

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the configuration of tests/test_serve.py's engine tests
_CFG = GPTConfig(vocab_size=64, seq_len=64, hidden=32, num_layers=2,
                 num_heads=4, dropout=0.0)
_SC = ServeConfig(n_slots=3, max_prompt_len=8, max_new_cap=8, page_size=4)
_TCFG = TGPTConfig(vocab_size=64, seq_len=64, hidden=32, num_layers=2,
                   num_heads=4, dropout=0.0, dtype=torch.float32)
_TSC = TServeConfig(n_slots=3, max_prompt_len=8, max_new_cap=8,
                    page_size=4)

_PROMPTS = [[1, 2], [3, 4, 5], [7], [9, 10, 11, 12], [13, 14],
            [15, 16, 17, 18, 19], [21], [22, 23]]
_BUDGETS = [4, 6, 3, 5, 8, 2, 7, 4]


def _jax_params(seed=11, spread=20.0):
    """GPT weights with the position embedding scaled up so greedy
    decoding produces varied tokens (test_serve.py's construction)."""
    params = GPT(_CFG).init(jax.random.PRNGKey(seed))
    params["pos_embed"] = params["pos_embed"] * spread
    return params


def _both(seed=11, **serve):
    jp = _jax_params(seed)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    import dataclasses
    jeng = DecodeEngine(_CFG, jp, dataclasses.replace(_SC, **serve))
    teng = TDecodeEngine(_TCFG, tp, dataclasses.replace(_TSC, **serve),
                         device="cpu")
    return jeng, teng


def _run(eng):
    rids = [eng.submit(p, b) for p, b in zip(_PROMPTS, _BUDGETS)]
    fin = {f.request_id: f for f in eng.run()}
    return [fin[r].tokens for r in rids], [fin[r].status for r in rids]


def test_port_churn_tokens_equal_jax_engine():
    """8 ragged requests through 3 slots: the port's tokens equal the
    JAX engine's token for token; the fixed-shape contract holds and
    the pool drains."""
    jeng, teng = _both()
    jtoks, _ = _run(jeng)
    ttoks, status = _run(teng)
    assert any(len(set(t)) > 1 for t in jtoks), "degenerate decode"
    assert ttoks == jtoks
    assert status == ["ok"] * len(_PROMPTS)
    assert teng.recompile_ok, teng.sentry.summary()
    assert teng.sentry.n_signatures == 1
    assert teng.cache.free_pages == teng.kv_config.usable_pages
    assert teng.stats()["live"] == 0


def test_port_churn_equals_solo():
    """Each stream decoded alone gives bitwise the tokens it gets under
    churn (the port's analogue of test_serve.py's churn gate)."""
    _, teng = _both()
    churn, _ = _run(teng)
    _, solo_eng = _both()
    solo = []
    for p, b in zip(_PROMPTS, _BUDGETS):
        solo_eng.submit(p, b)
        solo.append(solo_eng.run()[0].tokens)
    assert solo == churn
    assert solo_eng.recompile_ok


def test_port_emit_logits_match_jax():
    """Per-step fp32 logits of the decode step agree with the JAX
    engine's at atol/rtol 1e-4 over a churned run."""
    jeng, teng = _both(emit_logits=True)
    for eng in (jeng, teng):
        for p, b in zip(_PROMPTS[:4], _BUDGETS[:4]):
            eng.submit(p, b)
    n = 0
    while jeng.pending or teng.pending:
        assert jeng.step() == teng.step()
        if jeng.last_logits is not None:
            np.testing.assert_allclose(
                teng.last_logits.numpy(), np.asarray(jeng.last_logits),
                atol=1e-4, rtol=1e-4)
            n += 1
    assert n >= 3


def test_port_eos_stops_generation():
    """With the first emitted token as EOS, generation stops after one
    token; requests without it run to their budget."""
    _, probe = _both()
    probe.submit([1, 2, 3], 4)
    first = probe.run()[0].tokens[0]
    jeng, teng = _both(eos_id=first)
    for eng in (jeng, teng):
        eng.submit([1, 2, 3], 4)
    jt = jeng.run()[0].tokens
    tt = teng.run()[0].tokens
    assert tt == jt == [first]


def test_port_state_dict_resume_bitwise():
    """A snapshot taken mid-generation restores into a fresh engine
    that finishes with the uninterrupted run's tokens."""
    _, ref = _both()
    ref_toks, _ = _run(ref)
    _, a = _both()
    rids = [a.submit(p, b) for p, b in zip(_PROMPTS, _BUDGETS)]
    for _ in range(3):
        a.step()
    snap = a.state_dict()
    done_early = {f.request_id: f.tokens for f in a.poll()}
    _, b = _both()
    b.load_state_dict(snap)
    fin = {f.request_id: f.tokens for f in b.run()}
    fin.update(done_early)
    assert [fin[r] for r in rids] == ref_toks


def test_flagship_refuses_cpu_fallback():
    """The port's entry points run on the card unless asked for the CPU:
    without CUDA they raise instead of carrying on."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship_engine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDecodeEngine(_TCFG, {}, _TSC)
    eng = build_flagship_engine(device="cpu")
    assert eng.device.type == "cpu" and eng.serve_cfg.n_slots == 8


_PORT_FILES = sorted(
    os.path.join(d, f)
    for d, _, fs in os.walk(os.path.join(_ROOT, "apex_tpu_torch"))
    for f in fs if f.endswith(".py")) + [os.path.join(_ROOT, "chip_smoke.py")] \
    + sorted(os.path.join(_ROOT, "examples", f)
             for f in os.listdir(os.path.join(_ROOT, "examples"))
             if f.startswith("torch_") and f.endswith(".py"))


def _forbidden(name):
    return (name == "jax" or name.startswith("jax.") or name == "apex_tpu"
            or name.startswith("apex_tpu."))


@pytest.mark.parametrize(
    "path", _PORT_FILES, ids=lambda p: os.path.relpath(p, _ROOT))
def test_port_source_imports_no_jax(path):
    """AST scan: no module of the port (nor chip_smoke.py) imports JAX
    or anything of the JAX package."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_port_import_loads_no_jax():
    """In a fresh interpreter, importing every module of the port leaves
    no JAX and no JAX-package module in sys.modules."""
    mods = sorted(
        "apex_tpu_torch" + p[len(os.path.join(_ROOT, "apex_tpu_torch")):-3]
        .replace(os.sep, ".").replace(".__init__", "")
        for p in _PORT_FILES if p.endswith(".py") and "apex_tpu_torch" in p)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'apex_tpu' or m.startswith('apex_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
