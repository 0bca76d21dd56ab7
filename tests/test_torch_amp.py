"""The PyTorch port's mixed precision (apex_tpu_torch.amp: policies, the
fp16_utils helpers, the dynamic loss scaler, initialize and state
dicts) against the JAX package's, on the CPU.

Policies and casts are compared exactly (dtypes by name); the scaler's
states are compared exactly after each update (powers of two and
integer counters); unscaled grads rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu_torch import amp
from apex_tpu_torch.amp import scaler


def _name(dt):
    return str(dt).replace("torch.", "").replace("<class 'jax.numpy.", "") \
        .replace("'>", "")


def _jname(dt):
    return jnp.dtype(dt).name


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_presets_match_jax(level):
    got = amp.get_policy(level)
    want = jax_amp.get_policy(level)
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
        assert _name(getattr(got, field)) == _jname(getattr(want, field)), \
            field
    for field in ("keep_norm_fp32", "master_weights", "loss_scale",
                  "opt_level"):
        assert getattr(got, field) == getattr(want, field), field


def test_presets_take_overrides_and_refuse_unknown_levels():
    p = amp.get_policy("O1", low_dtype=torch.float16, loss_scale=128.0)
    assert p.compute_dtype == torch.float16 and p.loss_scale == 128.0
    with pytest.raises(ValueError, match="O4"):
        amp.get_policy("O4")


@pytest.mark.parametrize("level", ["O1", "O3"])
def test_compute_for_matches_jax(level):
    got, want = amp.get_policy(level), jax_amp.get_policy(level)
    names = ("conv", "matmul", "einsum", "batch_norm", "layer_norm",
             "cross_entropy", "softmax", "relu", "dense_sum", "pool")
    for op in names:
        assert _name(got.compute_for(op)) == _jname(want.compute_for(op)), op
    assert amp.MATMUL_CLASS_OPS == jax_amp.MATMUL_CLASS_OPS
    assert amp.FP32_CLASS_OPS == jax_amp.FP32_CLASS_OPS


def _tree():
    return {"conv": torch.ones(2, 2), "bn": {"scale": torch.ones(2)},
            "steps": torch.zeros(2, dtype=torch.int32),
            "blocks": [torch.ones(3), (torch.ones(1),)]}


def test_casts_touch_floating_leaves_only():
    p = amp.get_policy("O1")
    t = p.cast_to_compute(_tree())
    assert t["conv"].dtype == torch.bfloat16
    assert t["bn"]["scale"].dtype == torch.bfloat16
    assert t["steps"].dtype == torch.int32
    assert t["blocks"][0].dtype == torch.bfloat16
    assert isinstance(t["blocks"][1], tuple)
    a, b = p.cast_to_param(t, t)
    assert a["conv"].dtype == b["conv"].dtype == torch.float32
    assert p.cast_to_output(t)["conv"].dtype == torch.float32


def test_fp16_utils_helpers_match_jax():
    """convert_network keeps norm leaves (by key) fp32; prep_param_lists,
    model_grads_to_master_grads and master_params_to_model_params cast as
    the JAX package's do."""
    tree = {"conv1": torch.ones(2), "bn1": {"scale": torch.ones(2)},
            "layer_norm": {"weight": torch.ones(2)}, "fc": torch.ones(2)}
    jtree = {"conv1": jnp.ones(2), "bn1": {"scale": jnp.ones(2)},
             "layer_norm": {"weight": jnp.ones(2)}, "fc": jnp.ones(2)}
    got = amp.convert_network(tree, torch.float16)
    want = jax_amp.convert_network(jtree, jnp.float16)
    assert got["conv1"].dtype == torch.float16 == got["fc"].dtype
    assert got["bn1"]["scale"].dtype == torch.float32
    assert got["layer_norm"]["weight"].dtype == torch.float32
    assert _jname(want["conv1"].dtype) == "float16"
    assert _jname(want["bn1"]["scale"].dtype) == "float32"
    model, master = amp.prep_param_lists(got)
    assert model is got and master["conv1"].dtype == torch.float32
    g = amp.model_grads_to_master_grads({"w": torch.ones(2,
                                                         dtype=torch.float16)})
    assert g["w"].dtype == torch.float32
    back = amp.master_params_to_model_params(master, got)
    assert back["conv1"].dtype == torch.float16
    assert back["bn1"]["scale"].dtype == torch.float32


def _jax_state(s):
    return (float(s.scale), int(s.growth_tracker), bool(s.found_inf))


def _state(s):
    return (float(s.scale), int(s.growth_tracker), bool(s.found_inf))


def test_scaler_updates_match_jax():
    """A run of clean and overflowing steps with growth_interval 3:
    growth after three clean steps, backoff and a reset tracker on an
    overflow, the floor at min_scale, the cap at max_scale."""
    kw = dict(growth_interval=3, min_scale=2.0 ** 14, max_scale=2.0 ** 17)
    s = scaler.init(device="cpu")
    js = jax_amp.scaler.init()
    assert _state(s) == _jax_state(js) == (65536.0, 0, False)
    pattern = [False, False, False, True, False, True, True, True, False,
               False, False, False, False, False, False, False, False]
    for found in pattern:
        s = scaler.update(s, torch.tensor(found), **kw)
        js = jax_amp.scaler.update(js, jnp.asarray(found), **kw)
        assert _state(s) == _jax_state(js), found
        assert s.growth_tracker.dtype == torch.int32
    assert float(s.scale) == 2.0 ** 17                     # capped


def test_static_scaler_only_records_the_flag():
    s = scaler.init(128.0, device="cpu")
    s = scaler.update(s, torch.tensor(True), dynamic=False)
    assert _state(s) == (128.0, 0, True)
    assert _state(scaler.init(None, device="cpu")) == (1.0, 0, False)


def test_unscale_and_check_finite_match_jax():
    rng = np.random.RandomState(0)
    g = {"a": rng.randn(5).astype(np.float32),
         "b": {"c": rng.randn(2, 3).astype(np.float32)}}
    s = scaler.init(device="cpu")
    tg = {"a": torch.tensor(g["a"]), "b": {"c": torch.tensor(g["b"]["c"])}}
    jg = {"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["b"]["c"])}}
    got, found = scaler.unscale(s, tg)
    want, jfound = jax_amp.scaler.unscale(jax_amp.scaler.init(), jg)
    np.testing.assert_allclose(got["b"]["c"].numpy(),
                               np.asarray(want["b"]["c"]), rtol=1e-6)
    assert bool(found) is bool(jfound) is False
    tg["b"]["c"][1, 2] = float("nan")
    assert bool(scaler.check_finite(tg))
    flat = torch.zeros(8)
    assert not bool(scaler.check_finite(flat))
    flat[3] = float("inf")
    assert bool(scaler.check_finite(flat))
    assert float(scaler.scale_loss(s, torch.tensor(0.5))) == 32768.0


def test_initialize_and_state_dict_round_trip():
    """initialize builds one scaler per loss on the device asked for;
    O2 casts the params keeping norms fp32; state_dict / load_state_dict
    round-trip the scale and the tracker, as the JAX package's do."""
    params = {"conv": torch.ones(2), "bn": {"scale": torch.ones(2)}}
    cast, st = amp.initialize(params, opt_level="O2", num_losses=2,
                              device="cpu")
    assert cast["conv"].dtype == torch.bfloat16
    assert cast["bn"]["scale"].dtype == torch.float32
    assert len(st.loss_scalers) == 2 and st.dynamic
    g = {"w": torch.tensor([1.0, float("inf")])}
    _, found, st = amp.unscale_and_update(st, g, loss_id=1)
    assert bool(found)
    d = amp.state_dict(st)
    jst = jax_amp.initialize(opt_level="O2", num_losses=2)
    _, _, jst = jax_amp.unscale_and_update(
        jst, {"w": jnp.asarray([1.0, jnp.inf])}, loss_id=1)
    assert d == jax_amp.state_dict(jst)
    assert d == {"loss_scaler0": {"loss_scale": 65536.0, "unskipped": 0},
                 "loss_scaler1": {"loss_scale": 32768.0, "unskipped": 0}}
    back = amp.load_state_dict(amp.initialize(opt_level="O2", num_losses=2,
                                              device="cpu"), d, device="cpu")
    assert amp.state_dict(back) == d
    assert float(amp.scale_loss(back, torch.tensor(1.0), loss_id=1)) \
        == 32768.0
    o1 = amp.initialize(opt_level="O1", device="cpu")
    assert o1.policy.compute_dtype == torch.bfloat16 and o1.dynamic
    assert not amp.initialize(opt_level="O0", device="cpu").dynamic
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            amp.initialize(opt_level="O1")
