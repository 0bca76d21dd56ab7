"""The port's telemetry plane (apex_tpu_torch.monitor: metrics, flops,
sinks, logger) against the JAX package's (apex_tpu.monitor), on the CPU.

The same numpy-seeded inputs go through both packages.  Tolerances:
`update_metrics` and `global_norm`, rtol 1e-6 with the counters exact
(fp32 sums of a few hundred elements in another order); the flops
functions, exact integers; three steps of `ddp.make_train_step(
metrics=True)`, the metrics at rtol 1e-5 (the loss, the norms of grads
and params that the two packages compute in other summation orders) with
the counters exact, and the params as tests/test_torch_ddp.py holds
three steps (2e-6 absolute on params of magnitude ~0.3)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu import monitor as jmon
from apex_tpu.models.bert import BertConfig as JBertConfig
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.monitor.compile.sentry import RecompileSentry as JSentry
from apex_tpu.moe import MoERecorder as JMoERecorder
from apex_tpu.optimizers.distributed_fused_adam import (
    DistributedFusedAdam as JDAdam)
from apex_tpu.optimizers.fused_adam import FusedAdam as JAdam
from apex_tpu.parallel import ddp as jddp
from apex_tpu.parallel import mesh as JM
from apex_tpu_torch import amp, monitor
from apex_tpu_torch.models.bert import BertConfig
from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.monitor import flops, sinks
from apex_tpu_torch.monitor.compile import RecompileSentry
from apex_tpu_torch.monitor.compile import watermarks as wm
from apex_tpu_torch.moe import MoERecorder
from apex_tpu_torch.optimizers import DistributedFusedAdam, FusedAdam
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.parallel import ddp


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng, shape, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return a, torch.from_numpy(a.copy())


def _jfields(m):
    return {k: np.asarray(v) for k, v in m._asdict().items()}


def _pfields(m):
    return {k: v.numpy() for k, v in m._asdict().items()}


def _assert_metrics(got, want, rtol):
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.integer):
            assert int(g) == int(w), k
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=k)


# ------------------------------ metrics ------------------------------------

def test_update_metrics_and_global_norm_match_jax():
    """Four updates through every argument of `update_metrics` (grads
    with an inv_scale, flat param buffers, precomputed norms, found_inf
    as a tensor and a bool, count_step=False) and `global_norm` over a
    tree, from the same seeded numpy values."""
    rng = np.random.default_rng(0)
    jm, pm = jmon.init_metrics(), monitor.init_metrics("cpu")
    assert pm.step.dtype == torch.int32 and pm.tokens_seen.dtype == \
        torch.float32
    for i in range(4):
        (jw, pw), (jb, pb) = _pair(rng, (17, 5)), _pair(rng, (9,), 3.0)
        (jp0, pp0), (jd, pd) = _pair(rng, (40,)), _pair(rng, (40,), 1e-2)
        np.testing.assert_allclose(
            monitor.global_norm({"w": pw, "b": [pb]}).numpy(),
            np.asarray(jmon.global_norm({"w": jw, "b": [jb]})), rtol=1e-6)
        kw = dict(loss=1.5 + i, tokens=96 * (i + 1),
                  loss_scale=2.0 ** (10 - i))
        found = [False, True, False, True][i]
        jkw, pkw = dict(kw), dict(kw)
        if i == 2:
            jkw.update(param_norm=3.5, update_norm=0.25)
            pkw.update(param_norm=torch.tensor(3.5), update_norm=0.25)
        jm = jmon.update_metrics(
            jm, grads={"w": jw, "b": jb}, inv_scale=0.5,
            params_flat=jp0, new_params_flat=jp0 + jd,
            found_inf=jnp.asarray(found), count_step=i != 3, **jkw)
        pm = monitor.update_metrics(
            pm, grads={"w": pw, "b": pb}, inv_scale=0.5,
            params_flat=pp0, new_params_flat=pp0 + pd,
            found_inf=torch.tensor(found) if i % 2 else found,
            count_step=i != 3, **pkw)
        _assert_metrics(_pfields(pm), _jfields(jm), rtol=1e-6)
    assert int(pm.step) == 3 and int(pm.overflow_count) == 2
    with pytest.raises(TypeError, match="MetricsState"):
        monitor.update_metrics({"step": 0})


def test_tokens_seen_rounds_past_2_24_as_jax():
    """tokens_seen is f32 in both packages: past 2**24 an odd count
    rounds to the same representable value."""
    jm, pm = jmon.init_metrics(), monitor.init_metrics("cpu")
    for t in (2 ** 24, 3, 1, 12345677):
        jm = jmon.update_metrics(jm, tokens=t)
        pm = monitor.update_metrics(pm, tokens=t)
    assert float(pm.tokens_seen) == float(jm.tokens_seen)


@pytest.mark.parametrize("case", range(6))
def test_infer_tokens_per_step_matches_jax(case):
    shapes = [((4, 16), np.int32, 0), ((4, 8, 8, 3), np.float32, 0),
              ((2, 4, 16), np.int32, 1), ((2, 4, 8, 8, 3), np.float32, 1),
              ((7,), np.int32, 0), ((3, 5), np.int64, 0)]
    shape, dt, mb = shapes[case]
    a = np.zeros(shape, dt)
    other = np.zeros((4, 16), np.int32)
    want = jmon.infer_tokens_per_step((jnp.asarray(a), other),
                                      microbatch_dims=mb)
    got = monitor.infer_tokens_per_step(
        (torch.from_numpy(a), torch.from_numpy(other)), microbatch_dims=mb)
    assert got == want
    assert monitor.infer_tokens_per_step({}) == 0


# ------------------------------ flops --------------------------------------

GPT_SHAPES = [dict(vocab_size=50304, seq_len=1024, hidden=1024,
                   num_layers=24, num_heads=16),
              dict(vocab_size=512, seq_len=64, hidden=64, num_layers=2,
                   num_heads=4, ffn_mult=2)]


@pytest.mark.parametrize("shape", range(2))
def test_flops_functions_equal_jax(shape):
    cfg = GPT_SHAPES[shape]
    for batch, seq in ((12, None), (3, 256)):
        assert flops.gpt_step_flops(GPTConfig(**cfg), batch, seq) == \
            jmon.gpt_step_flops(JGPTConfig(**cfg), batch, seq)
    bcfg = {k: v for k, v in cfg.items() if k != "ffn_mult"}
    assert flops.bert_step_flops(BertConfig(**bcfg), 8) == \
        jmon.bert_step_flops(JBertConfig(**bcfg), 8)
    kw = dict(hidden=cfg["hidden"], num_layers=cfg["num_layers"],
              num_heads=cfg["num_heads"], vocab_size=cfg["vocab_size"],
              batch=4, seq=128)
    for head in (True, False):
        n = flops.transformer_step_flops(with_head=head, **kw)
        assert isinstance(n, int)
        assert n == jmon.transformer_step_flops(with_head=head, **kw)
    for t, p in ((0.1, 1e15), (0.0, 1e15), (0.1, 0.0), (0.2, None)):
        assert flops.mfu(1e13, t, p) == jmon.mfu(1e13, t, p)


JAX_KINDS = ["TPU v2", "TPU v3", "TPU v4", "TPU v4 lite", "TPU v5 lite",
             "TPU v5e", "TPU v5litepod", "TPU v5p", "TPU v5", "TPU v6 lite",
             "TPU v6e", "Trillium", "cpu", "", "gpu", "weird device"]


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_device_peak_flops_matches_jax_for_every_kind(kind):
    assert flops.device_peak_flops(kind) == jmon.device_peak_flops(kind)
    assert flops.device_peak_flops(kind, default=1.0) == \
        jmon.device_peak_flops(kind, default=1.0)
    assert flops.device_peak_flops(kind, override=5e14) == 5e14


def test_device_peak_flops_h100_rows():
    """The H100 rows (NVIDIA's data sheet, bf16 dense): the SXM part's
    name as `torch.cuda.get_device_name` gives it, and the PCIe part; no
    card (this CPU run) resolves to the JAX package's fallback."""
    assert flops.device_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.device_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert flops.DEVICE_BF16_PEAKS["h100-sxm"] == 989.4e12
    for k, v in jmon.DEVICE_BF16_PEAKS.items():
        assert flops.DEVICE_BF16_PEAKS[k] == v
    if not torch.cuda.is_available():
        assert flops.device_peak_flops() == jmon.V5E_BF16_PEAK
    assert flops.V5E_BF16_PEAK == jmon.V5E_BF16_PEAK


# ------------------------------ sinks --------------------------------------

SANITIZE_CASES = [
    {"loss": float("nan"), "g": float("inf"), "ok": 1.5, "n": 3},
    {"a": [1.0, float("-inf"), {"b": float("nan")}], "s": "x"},
    [float("inf"), (2.0, float("nan")), {"z": None}],
    {"nested": {"deep": {"v": float("-inf")}}, "t": (1, 2)},
    3.0, float("nan"), "plain"]


@pytest.mark.parametrize("case", range(len(SANITIZE_CASES)))
def test_sanitize_json_floats_matches_jax(case):
    obj = SANITIZE_CASES[case]
    got = sinks.sanitize_json_floats(obj)
    want = jmon.sanitize_json_floats(obj)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_sinks_write_what_jax_sinks_write(tmp_path):
    rec = {"step": 3, "loss": float("nan"), "grad_norm": 0.5,
           "loss_scale": 1024.0, "step_time_ms": 12.25,
           "tokens_per_sec": 1000.0, "mfu": 0.4, "flag": True}
    for mod, name in ((sinks, "p"), (jmon.sinks, "j")):
        with mod.JSONLSink(tmp_path / f"{name}.jsonl") as s:
            s.write(rec)
        lines = []
        mod.ConsoleSink(lines.append).write(rec)
        (tmp_path / f"{name}.txt").write_text("\n".join(lines))

        class W:
            def __init__(self):
                self.calls = []

            def add_scalar(self, tag, v, step):
                self.calls.append((tag, v, step))

        w = W()
        mod.SummaryWriterSink(w).write(rec)
        mod.SummaryWriterSink(w).write({"x": 1.0})
        mod.ScalarWriter(mod.SummaryWriterSink(w)).add_scalar("t", 2, 7)
        (tmp_path / f"{name}.sw").write_text(repr(w.calls))
    for ext in ("jsonl", "txt", "sw"):
        assert (tmp_path / f"p.{ext}").read_text() == \
            (tmp_path / f"j.{ext}").read_text()
    with pytest.raises(ValueError, match="mode"):
        sinks.JSONLSink(tmp_path / "x", mode="r")
    with pytest.raises(TypeError, match="add_scalar"):
        sinks.SummaryWriterSink(object())


# ------------------------------ schema + logger ----------------------------

def test_schema_equals_jax_and_records_cross_validate(tmp_path):
    """The port's SCHEMA, OPTIONAL_SCHEMA and version are the JAX
    package's; a record the port's logger wrote (through its JSONL sink,
    with the memory watermarks null on the CPU) passes JAX's
    validate_record, and the reverse."""
    assert monitor.SCHEMA == jmon.SCHEMA
    assert monitor.logger.OPTIONAL_SCHEMA == jmon.logger.OPTIONAL_SCHEMA
    assert monitor.SCHEMA_VERSION == jmon.SCHEMA_VERSION == 11
    path = tmp_path / "p.jsonl"
    lg = monitor.MetricsLogger([monitor.JSONLSink(path)],
                               flops_per_step=1e9, memory=True)
    pm = monitor.init_metrics("cpu")
    for i in range(3):
        pm = monitor.update_metrics(pm, loss=2.0 - i, tokens=64,
                                    grads=torch.ones(3),
                                    found_inf=torch.tensor(i == 1))
        lg.log_step(pm)
    lg.close()
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    jmon.validate_records(recs)
    monitor.validate_records(recs)
    assert recs[0]["hbm_bytes_in_use"] is None
    assert [r["overflowed_this_window"] for r in recs] == [False, True,
                                                           False]
    jpath = tmp_path / "j.jsonl"
    jl = jmon.MetricsLogger([jmon.JSONLSink(jpath)], flops_per_step=1e9)
    jm = jmon.update_metrics(jmon.init_metrics(), loss=1.0, tokens=8)
    jl.log_step(jm)
    jl.close()
    monitor.validate_records([json.loads(x) for x in
                              jpath.read_text().splitlines()])
    with pytest.raises(ValueError, match="non-monotonic"):
        monitor.validate_records(recs[:1] * 2)
    with pytest.raises(ValueError, match="missing field"):
        monitor.validate_record({k: v for k, v in recs[0].items()
                                 if k != "mfu"})


class _Ckpt:
    def stats(self):
        return {"ckpt_blocking_s": 0.25, "ckpt_save_s": 1.5,
                "ckpt_last_step": 4, "ckpt_bytes": 1024}


class _Fleet:
    def stats(self):
        return {"fleet_resumes": 1, "fleet_dp": 2}


class _Serve:
    def serve_record(self):
        return {"serve_queue_depth": 3, "serve_pool_util": 0.5}


class _Timeline:
    def timeline_record(self):
        return {"timeline_device_busy_fraction": 0.75}


def test_logger_stamps_the_fields_jax_stamps(tmp_path):
    """MetricsLogger(ckpt=, fleet=, moe=, sentry=, serve=, timeline=,
    taps=False) of each package over the same record: the same keys and
    the same values, the rates aside (they read each logger's clock)."""
    def run(mon, sentry_cls, moe_cls, metrics_state, path):
        sentry = sentry_cls(lambda x: x, warn=False)
        sentry(np.zeros(3))
        sentry.mark_steady()
        sentry(np.zeros(4))
        moe = moe_cls()
        moe.update({"moe_aux_loss": 1.25, "moe_drop_fraction": 0.0,
                    "moe_gate_entropy": 0.5, "moe_z_loss": 2.0,
                    "ce_loss": 3.0})
        lg = mon.MetricsLogger([mon.JSONLSink(path)], flops_per_step=1e12,
                               peak_flops=1e15, ckpt=_Ckpt(),
                               fleet=_Fleet(), moe=moe, sentry=sentry,
                               serve=_Serve(), timeline=_Timeline())
        rec = lg.log_step(metrics_state, extra={"note": "x"})
        lg.close()
        return rec

    pm = monitor.update_metrics(monitor.init_metrics("cpu"), loss=2.5,
                                tokens=128, grads=torch.full((4,), 2.0))
    jm = jmon.update_metrics(jmon.init_metrics(), loss=2.5, tokens=128,
                             grads=jnp.full((4,), 2.0))
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = run(monitor, RecompileSentry, MoERecorder, pm,
                  tmp_path / "p.jsonl")
        want = run(jmon, JSentry, JMoERecorder, jm, tmp_path / "j.jsonl")
    rates = {"step_time_ms", "tokens_per_sec", "mfu", "tuner_fingerprint",
             "tuner_hits", "tuner_misses"}
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in rates} == \
        {k: v for k, v in want.items() if k not in rates}
    assert got["n_compiles"] == 2 and got["steady_recompiles"] == 1
    jmon.validate_record(got)


def test_watermarks_on_the_cpu_are_null():
    assert wm.device_memory_stats() is None
    assert wm.device_memory_stats("cpu") is None
    assert wm.all_device_memory_stats() is None
    assert wm.hbm_watermarks() == {"hbm_bytes_in_use": None,
                                   "hbm_peak_bytes_in_use": None,
                                   "hbm_bytes_limit": None}
    fake = {"bytes_in_use": 5, "peak_bytes_in_use": 7.0, "bytes_limit":
            "x", "bytes_free": 9, "flag": True}
    from apex_tpu.monitor.compile import watermarks as jwm
    assert wm.hbm_watermarks(stats=fake) == jwm.hbm_watermarks(stats=fake)


# --------------------------- the monitored step -----------------------------

def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(8, 16)) * 0.3).astype(np.float32),
            "b1": (rng.normal(size=(16,)) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(16, 4)) * 0.3).astype(np.float32)}


def _batches(steps=3):
    rng = np.random.default_rng(1)
    out = []
    for i in range(steps):
        x = rng.normal(size=(16, 8)).astype(np.float32)
        if i == 1:
            x[0, 0] = np.inf            # the overflow step
        out.append((x, rng.normal(size=(16, 4)).astype(np.float32)))
    return out


def _jloss(p, b):
    x, y = b
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] - y) ** 2)


def _ploss(p, b):
    x, y = b
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] - y) ** 2)


def _tree(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


@pytest.mark.parametrize("zero", [False, True], ids=["dense", "zero2"])
def test_three_monitored_steps_match_jax(zero):
    """Three steps of make_train_step(metrics=True) under O0 with a
    dynamic loss scale (the second batch holds an inf: an overflow, a
    skipped step), dense FusedAdam and ZeRO-2 DistributedFusedAdam at
    one rank, against the JAX step on a one-device mesh: every metrics
    field after every step, and the params after the three."""
    params = _mlp_params()
    JM.destroy_model_parallel()
    mesh = JM.initialize_model_parallel(devices=jax.devices()[:1])
    if zero:
        jopt = JDAdam(num_shards=1, lr=1e-2, weight_decay=0.01,
                      n_buckets=2)
        sspec = jopt.state_partition_specs()
        jstate = jax.jit(shard_map(jopt.init, mesh=mesh, in_specs=(P(),),
                                   out_specs=sspec, check_vma=False))(params)
        opt = DistributedFusedAdam(1, lr=1e-2, weight_decay=0.01,
                                   n_buckets=2)
    else:
        jopt = JAdam(lr=1e-2, weight_decay=0.01)
        jstate = jopt.init(params)
        opt = FusedAdam(lr=1e-2, weight_decay=0.01)
    jamp_state = jamp.initialize(opt_level="O0", loss_scale="dynamic")
    jscaler = jamp_state.loss_scalers[0]
    jstep = jddp.make_train_step(_jloss, jopt, mesh, amp_state=jamp_state,
                                 batch_spec=(P("dp"), P("dp")),
                                 donate=False, metrics=True)
    state = opt.init(_tree(params))
    amp_state = amp.initialize(opt_level="O0", loss_scale="dynamic",
                               device="cpu")
    scaler = amp_state.loss_scalers[0]
    step = ddp.make_train_step(_ploss, opt, amp_state=amp_state,
                               device="cpu", metrics=True)
    with pytest.raises(TypeError, match="build time"):
        ddp.make_train_step(_ploss, opt, device="cpu",
                            metrics=monitor.init_metrics("cpu"))
    jm, pm = jmon.init_metrics(), monitor.init_metrics("cpu")
    for x, y in _batches():
        jstate, jscaler, jl, jm = jstep(jstate, jscaler, (x, y), jm)
        state, scaler, loss, pm = step(state, scaler,
                                       (torch.from_numpy(x),
                                        torch.from_numpy(y)), pm)
        _assert_metrics(_pfields(pm), _jfields(jm), rtol=1e-5)
    assert int(pm.overflow_count) == 1 and int(pm.skipped_steps) == 1
    assert float(pm.tokens_seen) == 48.0 and int(pm.step) == 3
    if zero:
        full = jax.jit(shard_map(jopt.full_params, mesh=mesh,
                                 in_specs=(sspec,), out_specs=P(),
                                 check_vma=False))(jstate)
        want = np.concatenate([np.asarray(v, np.float32).ravel() for v in
                               jax.tree_util.tree_leaves(full)])
        got = np.concatenate([v.numpy().ravel() for v in
                              F.tree_leaves(opt.full_params(state))])
    else:
        want, got = np.asarray(jstate.params), state.params.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    JM.destroy_model_parallel()
