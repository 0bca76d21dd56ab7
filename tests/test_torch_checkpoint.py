"""Optimizer checkpoints and the engine's telemetry report in the
PyTorch port, against the JAX package's, on the CPU.

Checkpoints (`optimizers.flat.FlatCheckpointMixin` in FusedAdam,
FusedLAMB and FusedNovoGrad): a state dict written by the JAX optimizer
(its arrays through numpy) loads into the port's, and the next step
equals the JAX next step; a state dict written by the port (its tensors
through numpy) loads into the JAX optimizer the same way, bf16 buffers
included.  The loaded buffers equal the saved ones exactly; the next
step, fp32 state rtol 1e-5 / atol 1e-6, bf16 state one bf16 ulp plus
1e-7 (the packages' steps agree to that, tests/test_torch_lamb.py and
tests/test_torch_optimizers.py).  A dict whose layout differs, or a
load before init(), is refused.

The telemetry report: after the same requests, the port's
`telemetry_report()` has the JAX engine's keys, with the SLO and its
verdict when one is attached, and is None without telemetry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPT, GPTConfig
from apex_tpu.optimizers.fused_adam import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers.fused_lamb import FusedLAMB as JaxFusedLAMB
from apex_tpu.optimizers.fused_novograd import (
    FusedNovoGrad as JaxFusedNovoGrad)
from apex_tpu.serve import DecodeEngine, ServeConfig
from apex_tpu.serve.telemetry import ServeSLO as JaxServeSLO
from apex_tpu_torch.models import GPTConfig as TGPTConfig
from apex_tpu_torch.models import params_from_jax
from apex_tpu_torch.optimizers import (FusedAdam, FusedLAMB,
                                       FusedMixedPrecisionLamb,
                                       FusedNovoGrad)
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.serve import DecodeEngine as TDecodeEngine
from apex_tpu_torch.serve import ServeConfig as TServeConfig
from apex_tpu_torch.serve.telemetry import ServeSLO

_SHAPES = {"block0": {"qkv": {"weight": (16, 48), "bias": (48,)},
                      "ln1": {"weight": (16,), "bias": (16,)}},
           "embed": {"weight": (300, 16)}, "pos": (3, 5)}


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


def _tree(fn, spec=_SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in spec.items()}


def _mask():
    return _tree(lambda s: len(s) >= 2)


# (name, the JAX optimizer, the port's) — FusedAdam unaligned and with
# the lane-aligned per-tensor layout, FusedLAMB, FusedNovoGrad
_CASES = {
    "adam": (lambda: JaxFusedAdam(lr=1e-2, weight_decay=0.01,
                                  use_pallas=True),
             lambda: FusedAdam(lr=1e-2, weight_decay=0.01)),
    "adam_wd_mask": (lambda: JaxFusedAdam(lr=1e-2, weight_decay=0.01,
                                          use_pallas=True, wd_mask=_mask()),
                     lambda: FusedAdam(lr=1e-2, weight_decay=0.01,
                                       wd_mask=_mask())),
    "lamb": (lambda: JaxFusedLAMB(lr=1e-2, use_pallas=True),
             lambda: FusedMixedPrecisionLamb(lr=1e-2)),
    "lamb_bf16": (lambda: JaxFusedLAMB(lr=1e-2, use_pallas=True,
                                       master_dtype=jnp.bfloat16),
                  lambda: FusedLAMB(lr=1e-2, master_dtype=torch.bfloat16)),
    "novograd": (lambda: JaxFusedNovoGrad(lr=1e-2, weight_decay=0.01,
                                          use_pallas=True),
                 lambda: FusedNovoGrad(lr=1e-2, weight_decay=0.01)),
}


def _grads(rng):
    return _tree(lambda s: rng.randn(*s).astype(np.float32))


def _port_to_numpy(t):
    """A port tensor as the JAX package's arrays come through numpy (bf16
    as ml_dtypes' bfloat16), copied as a checkpoint written out would be.

    The copy matters: `t.numpy()` shares the port's buffer, which the
    port's next step updates in place (its state dict holds the state's
    own tensors, as a torch optimizer's does), and `jnp.asarray` of a
    numpy array may alias it on the CPU without a copy.  The JAX state
    loaded from it then changes under the JAX package's asynchronously
    dispatched step whenever the port steps first: the fp32 NovoGrad
    case read the port's step-3 params in about one xdist run in ten."""
    if t.dtype == torch.bfloat16:
        return np.asarray(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
    return t.numpy().copy()


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).astype(np.float32))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_state_dict_round_trips_between_packages(case, direction):
    """Two steps in the writing package, save, load into the other
    package's freshly initialised optimizer, one more step in each: the
    loaded state equals the saved one and the next steps agree."""
    make_jax, make_port = _CASES[case]
    rng = np.random.RandomState(31)
    w = _tree(lambda s: rng.randn(*s).astype(np.float32))
    g1, g2, g3 = _grads(rng), _grads(rng), _grads(rng)
    jopt, topt = make_jax(), make_port()
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, w))
    tstate = topt.init(jax.tree_util.tree_map(torch.tensor, w))
    for g in (g1, g2):
        if direction == "jax_to_port":
            _, jstate = jopt.step(jstate,
                                  jax.tree_util.tree_map(jnp.asarray, g))
        else:
            _, tstate = topt.step(tstate,
                                  jax.tree_util.tree_map(torch.tensor, g))
    if direction == "jax_to_port":
        d = {k: (v if k == "flat_layout" else np.asarray(v))
             for k, v in jopt.state_dict(jstate).items()}
        tstate = topt.load_state_dict(d)
        assert tstate.step.dtype == torch.int32 and int(tstate.step) == 2
    else:
        d = {k: (v if k == "flat_layout" else _port_to_numpy(v))
             for k, v in topt.state_dict(tstate).items()}
        jstate = jopt.load_state_dict(d)
        assert int(jstate.step) == 2
    assert d["flat_layout"] == F.layout_dict(topt.spec)
    assert tstate.params.dtype == (torch.bfloat16 if case == "lamb_bf16"
                                   else torch.float32)
    for name in tstate._fields:
        np.testing.assert_array_equal(_f32(getattr(tstate, name)),
                                      _f32(getattr(jstate, name)))
    # a load copies: stepping the loaded state leaves the dict as saved
    saved = ({k: np.array(v) for k, v in d.items() if k != "flat_layout"}
             if direction == "jax_to_port" else {})
    _, jstate = jopt.step(jstate, jax.tree_util.tree_map(jnp.asarray, g3))
    _, tstate = topt.step(tstate, jax.tree_util.tree_map(torch.tensor, g3))
    assert int(tstate.step) == int(jstate.step) == 3
    for k, v in saved.items():
        np.testing.assert_array_equal(_f32(d[k]), _f32(v), err_msg=k)
    for name in tstate._fields[1:]:
        got, want = _f32(getattr(tstate, name)), _f32(getattr(jstate, name))
        if getattr(tstate, name).dtype == torch.bfloat16:
            _, e = np.frexp(np.abs(want))
            assert np.all(np.abs(got - want)
                          <= np.ldexp(np.ones_like(want), e - 8) + 1e-7), name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("cls", [FusedAdam, FusedLAMB, FusedNovoGrad])
def test_load_state_dict_refuses_other_layouts_and_before_init(cls):
    opt = cls()
    with pytest.raises(ValueError, match=f"{cls.__name__}.load_state_dict "
                                         "called before init"):
        opt.load_state_dict({})
    params = {"a": torch.ones(3, 4), "b": torch.ones(5)}
    d = opt.state_dict(opt.init(params))
    for key, delta in (("total", 128), ("n_tensors", 1), ("align", 127)):
        bad = dict(d, flat_layout=dict(d["flat_layout"]))
        bad["flat_layout"][key] += delta
        with pytest.raises(ValueError, match=f"{cls.__name__}: checkpoint "
                                             "flat layout"):
            opt.load_state_dict(bad)
    state = opt.load_state_dict(d)
    assert all(torch.equal(a, b) for a, b in zip(state, d.values()))
    assert state.params.device == opt.device


def test_pre_layout_checkpoints():
    """A dict without a layout record: taken for an unaligned spec whose
    buffer it covers; refused for an aligned spec, or when its buffer is
    shorter than the spec."""
    params = {"a": torch.ones(3, 4), "b": torch.ones(5)}
    opt = FusedAdam()
    d = opt.state_dict(opt.init(params))
    del d["flat_layout"]
    assert int(opt.load_state_dict(d).step) == 0
    with pytest.raises(ValueError, match="truncated"):
        opt.load_state_dict(dict(d, params=d["params"][:10]))
    lamb = FusedLAMB()
    d = lamb.state_dict(lamb.init(params))
    del d["flat_layout"]
    with pytest.raises(ValueError, match="FusedLAMB: checkpoint has no "
                                         "flat_layout record"):
        lamb.load_state_dict(d)


# -------------------------------------------------------------- telemetry

_CFG = GPTConfig(vocab_size=64, seq_len=64, hidden=32, num_layers=2,
                 num_heads=4, dropout=0.0)
_SC = ServeConfig(n_slots=3, max_prompt_len=8, max_new_cap=8, page_size=4)
_TCFG = TGPTConfig(vocab_size=64, seq_len=64, hidden=32, num_layers=2,
                   num_heads=4, dropout=0.0, dtype=torch.float32)
_TSC = TServeConfig(n_slots=3, max_prompt_len=8, max_new_cap=8,
                    page_size=4)


def _keys(d, prefix=""):
    """Every key path of a nested dict."""
    out = set()
    for k, v in d.items():
        out.add(prefix + str(k))
        if isinstance(v, dict):
            out |= _keys(v, prefix + str(k) + "/")
    return out


@pytest.mark.parametrize("with_slo", [False, True])
def test_telemetry_report_has_the_jax_engines_keys(with_slo):
    jp = GPT(_CFG).init(jax.random.PRNGKey(11))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    jeng = DecodeEngine(_CFG, jp, _SC)
    teng = TDecodeEngine(_TCFG, tp, _TSC, device="cpu")
    if with_slo:
        jeng.slo = JaxServeSLO(ttft_p99_ms=1e6, per_token_p99_ms=1e6)
        teng.slo = ServeSLO(ttft_p99_ms=1e6, per_token_p99_ms=1e6)
    for eng in (jeng, teng):
        for p, b in (([1, 2], 3), ([3, 4, 5], 2), ([7], 4)):
            eng.submit(p, b)
        eng.run()
    want, got = jeng.telemetry_report(), teng.telemetry_report()
    assert _keys(got) == _keys(want)
    assert got["stats"] == teng.stats()
    assert ("slo" in got) == ("slo_verdict" in got) == with_slo
    if with_slo:
        assert got["slo"] == teng.slo.to_dict()
        assert got["slo_verdict"]["ok"] is True


def test_telemetry_report_is_none_without_telemetry():
    tp = params_from_jax(jax.tree_util.tree_map(
        np.asarray, GPT(_CFG).init(jax.random.PRNGKey(11))), device="cpu")
    eng = TDecodeEngine(_TCFG, tp, dataclasses.replace(_TSC),
                        telemetry=False, device="cpu")
    assert eng.telemetry_report() is None
