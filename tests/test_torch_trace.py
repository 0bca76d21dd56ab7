"""The port's numerics flight recorder (apex_tpu_torch.monitor.trace and
the tap op of ops._common) against the JAX package's, on the CPU: the
counterparts of tests/test_trace.py's cases, the remat hazard, and the
rank-timing plane in one 2-rank gloo world.

Tolerances: tap stats of the same array, rtol 1e-6 (an fp32 mean and
rms in another summation order); the tap planes of a GPT and a BERT
step (fp32) against the JAX step's, rtol 1e-4 on every lane, with an
absolute floor of 1e-4 of the tap's rms for the mean lane (a mean of a
LayerNorm output is a cancellation near 0); provenance indices, names,
counts and the gathered timing matrices, exact; metrics across ranks,
rtol 1e-5 with the counters exact."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu import monitor as jmon
from apex_tpu.amp.fp16_optimizer import FP16_Optimizer as JFP16
from apex_tpu.models.bert import Bert as JBert
from apex_tpu.models.bert import BertConfig as JBertConfig
from apex_tpu.models.gpt import GPT as JGPT
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.monitor import trace as jtrace
from apex_tpu.ops import _common as jtapc
from apex_tpu.optimizers.distributed_fused_adam import (
    DistributedFusedAdam as JDAdam)
from apex_tpu.optimizers.fused_adam import FusedAdam as JAdam
from apex_tpu.parallel import ddp as jddp
from apex_tpu.parallel import mesh as JM
from apex_tpu.transformer.pipeline_parallel.schedules import (
    forward_backward_no_pipelining as jfbnp)
from apex_tpu_torch import amp, monitor
from apex_tpu_torch.amp.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.checkpoint import CheckpointManager
from apex_tpu_torch.checkpoint import chaos
from apex_tpu_torch.checkpoint import sharded as PS
from apex_tpu_torch.models import bert as pbert
from apex_tpu_torch.models import gpt as pgpt
from apex_tpu_torch.monitor import trace
from apex_tpu_torch.monitor.compile import RecompileSentry
from apex_tpu_torch.ops import _common as tapc
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.parallel import ddp
from apex_tpu_torch.parallel import mesh as PM

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_device_mesh():
    JM.destroy_model_parallel()
    return JM.initialize_model_parallel(devices=jax.devices()[:1])


def _planes_close(got, want, what):
    """A (n, 4) port plane against the JAX one (module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got[:, 3], want[:, 3], err_msg=what)
    for lane in (0, 2):
        np.testing.assert_allclose(got[:, lane], want[:, lane], rtol=1e-4,
                                   err_msg=f"{what} lane {lane}")
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-4,
                               atol=1e-4 * np.abs(want[:, 2]).max(),
                               err_msg=f"{what} mean")


# ------------------------------ the tap op ---------------------------------

def test_tap_is_identity_without_context():
    x = torch.ones(4, 4)
    assert tapc.tap(x, "anything") is x
    ctx = tapc.TapContext(discover=True)
    with tapc.tap_context(ctx):
        assert tapc.tap(x, "a") is x
    assert ctx.names == ["a"] and tapc.active_tap_context() is None


@pytest.mark.parametrize("case", range(4))
def test_tap_stats_match_jax(case):
    rng = np.random.default_rng(case)
    x = [np.asarray([[1.0, -3.0], [2.0, 0.0]], np.float32),
         rng.normal(size=(33, 65)).astype(np.float32) * 5,
         np.asarray([np.nan, np.inf, 1.0, -np.inf], np.float32),
         rng.normal(size=(7, 3, 5)).astype(np.float32)][case]
    got = tapc.tap_stats(torch.from_numpy(x)).numpy()
    want = np.asarray(jtapc.tap_stats(jnp.asarray(x)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    if case == 2:
        assert got[3] == 3.0 and not np.isfinite(got[0])
    # bf16 input: the stats are of its f32 upcast in both
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_allclose(
        tapc.tap_stats(xb).numpy(),
        np.asarray(jtapc.tap_stats(jnp.asarray(xb.float().numpy())
                                   .astype(jnp.bfloat16))),
        rtol=1e-6, equal_nan=True)


def test_tap_context_overflow_raises():
    ctx = tapc.TapContext(probes=trace.make_probes(1, "cpu"))
    with tapc.tap_context(ctx):
        tapc.tap(torch.ones(3), "a")
        with pytest.raises(ValueError, match="max_taps"):
            tapc.tap(torch.ones(3), "b")


# ----------------------- make_train_step trace plane ------------------------

def _linear_problem():
    X = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    Y = X @ np.asarray([[1.0], [-2.0], [0.5], [3.0]], np.float32)

    def loss_fn(params, batch):
        x, y = batch
        h = tapc.tap(x @ params["w"], "dense")
        return torch.mean((h - y) ** 2)

    return loss_fn, (torch.from_numpy(X), torch.from_numpy(Y))


def _train(trace_arg, steps=4, amp_on=True, **kw):
    loss_fn, batch = _linear_problem()
    amp_state = amp.initialize(opt_level="O0", loss_scale="dynamic",
                               device="cpu") if amp_on else None
    scaler = amp_state.loss_scalers[0] if amp_on else None
    opt = FusedAdam(lr=0.05)
    state = opt.init({"w": torch.zeros(4, 1)})
    step = ddp.make_train_step(loss_fn, opt, amp_state=amp_state,
                               device="cpu", trace=trace_arg, **kw)
    outs = None
    for _ in range(steps):
        outs = step(state, scaler, batch)
        state, scaler = outs[0], outs[1]
    return state, outs, step


def test_trace_off_is_the_pre_trace_step():
    """trace=None: the output arity and the params as always, bit for bit
    against the tapped run (taps change no numerics)."""
    state_off, outs_off, _ = _train(None)
    assert len(outs_off) == 3
    state_on, outs_on, step = _train(True)
    assert len(outs_on) == 4
    assert torch.equal(state_off.params, state_on.params)
    assert step.tap_names() == ("dense",)
    ts = outs_on[-1]
    assert ts.fwd.shape == (1, 4) and ts.grad.shape == (1, 4)
    assert int(ts.first_bad_fwd) == -1 and int(ts.first_bad_grad) == -1
    assert float(ts.fwd[0, 0]) > 0 and float(ts.grad[0, 0]) > 0


def test_trace_grad_plane_is_unscaled():
    _, scaled, _ = _train(True, steps=1, amp_on=True)
    _, plain, _ = _train(True, steps=1, amp_on=False)
    np.testing.assert_allclose(scaled[-1].grad[0, 0].item(),
                               plain[-1].grad[0, 0].item(), rtol=1e-5)


def test_trace_taps_reject_microbatching():
    loss_fn, _ = _linear_problem()
    opt = FusedAdam(lr=0.05)
    with pytest.raises(ValueError, match="num_microbatches"):
        ddp.make_train_step(loss_fn, opt, device="cpu", num_microbatches=2,
                            trace=True)
    # the timing-only config composes with microbatching
    ddp.make_train_step(loss_fn, opt, device="cpu", num_microbatches=2,
                        trace=trace.TraceConfig(taps=False,
                                                rank_timing=True))


# ------------------------- GPT and BERT against JAX -------------------------

GPT_CFG = dict(vocab_size=64, seq_len=16, hidden=32, num_layers=3,
               num_heads=4)


@pytest.fixture(scope="module")
def jax_gpt():
    """The JAX package's tapped GPT step (tests/test_trace.py's), built
    once: the weights, the batch and the step."""
    mesh = _one_device_mesh()
    model = JGPT(JGPTConfig(**GPT_CFG))
    params = model.init(jax.random.PRNGKey(0))
    opt = JAdam(lr=1e-3, use_pallas=False)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16),
                                           0, 64), np.int32)
    batch = (tokens, np.roll(tokens, -1, 1))
    step = jddp.make_train_step(lambda p, b: model.loss(p, b[0], b[1]), opt,
                                mesh, batch_spec=(P("dp"), P("dp")),
                                trace=True, donate=False)
    yield params, batch, opt, step
    JM.destroy_model_parallel()


def _port_gpt_step(params, batch, trace_arg=True, **cfg_kw):
    model = pgpt.GPT(pgpt.GPTConfig(**GPT_CFG, **cfg_kw))
    opt = FusedAdam(lr=1e-3)
    state = opt.init(pgpt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    step = ddp.make_train_step(lambda p, b: model.loss(p, b[0], b[1]), opt,
                               device="cpu", trace=trace_arg)
    out = step(state, None, tuple(torch.tensor(b) for b in batch))
    return out, step


def test_gpt_tap_names_and_planes_match_jax(jax_gpt):
    params, batch, opt, jstep = jax_gpt
    jout = jstep(opt.init(params), None, batch)
    out, step = _port_gpt_step(params, batch)
    assert step.tap_names() == jstep.tap_names()
    assert len(step.tap_names()) == 12
    _planes_close(out[-1].fwd, jout[-1].fwd, "fwd")
    _planes_close(out[-1].grad, jout[-1].grad, "grad")
    for f in ("first_bad_fwd", "first_bad_grad"):
        assert int(getattr(out[-1], f)) == int(getattr(jout[-1], f)) == -1
    off, _ = _port_gpt_step(params, batch, trace_arg=None)
    assert torch.equal(off[0].params, out[0].params)


def test_gpt_nan_injection_attributed_as_jax(jax_gpt, tmp_path):
    """A NaN in block1's attention projection: both packages name
    block1/attn first in the forward plane, with the same gradient-plane
    index, and the port's dumped report carries it."""
    params, batch, opt, jstep = jax_gpt
    w = np.asarray(params["block1"]["proj"]["weight"]).copy()
    w[0, 0] = np.nan
    bad = dict(params, block1=dict(params["block1"],
                                   proj=dict(params["block1"]["proj"],
                                             weight=jnp.asarray(w))))
    jts = jstep(opt.init(bad), None, batch)[-1]
    out, step = _port_gpt_step(bad, batch)
    ts, names = out[-1], step.tap_names()
    for f in ("first_bad_fwd", "first_bad_grad"):
        assert int(getattr(ts, f)) == int(getattr(jts, f))
    prov = trace.provenance(ts, names)
    assert prov == dict(jtrace.provenance(jts, names), stats=prov["stats"])
    assert prov["plane"] == "fwd" and prov["tap"] == "block1/attn"
    rec = trace.FlightRecorder(tmp_path / "f.json", capacity=4,
                               tap_names=names)
    rec.record(7, taps=ts)
    rec.dump(reason="test")
    on_disk = json.loads((tmp_path / "f.json").read_text())
    jtrace.validate_report(on_disk)
    assert on_disk["records"][0]["taps"]["first_bad_fwd"] == "block1/attn"
    for render in (trace.render_report, jtrace.render_report):
        text = render(on_disk)
        assert "block1/attn" in text and "first bad step: 7" in text


BERT_CFG = dict(vocab_size=128, seq_len=16, hidden=32, num_layers=2,
                num_heads=4)


def test_bert_tap_names_and_planes_match_jax():
    """BERT's encoder taps the same four points a block; the planes of
    one tapped gradient of the MLM loss (ragged padding) match JAX's."""
    mesh = _one_device_mesh()
    jmodel = JBert(JBertConfig(**BERT_CFG))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, 128, (2, 16)).astype(np.int32)
    mlm = np.roll(tokens, -1, 1)
    mask = rng.rand(2, 16) < 0.3
    pad = np.arange(16)[None, :] >= np.array([[16], [11]])
    holder = {}

    def jtapped(p, probes, t, lm, m, pm):
        ctx = jtapc.TapContext(probes=probes)
        with jtapc.tap_context(ctx):
            loss = jmodel.loss(p, t, lm, m, pad_mask=pm)
        holder["names"] = list(ctx.names)
        return loss

    f = shard_map(jtapped, mesh=mesh,
                  in_specs=(jmodel.partition_specs(),) + (P(),) * 5,
                  out_specs=P(), check_vma=False)
    jprobe = jax.jit(jax.grad(f, argnums=1))(
        jparams, jtrace.make_probes(16), tokens, mlm, mask, pad)
    n = len(holder["names"])
    jts = jtrace.finalize(jprobe, n)
    JM.destroy_model_parallel()

    model = pbert.Bert(pbert.BertConfig(**BERT_CFG))
    params = pbert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   device="cpu")
    probes = trace.make_probes(16, "cpu").requires_grad_(True)
    ctx = tapc.TapContext(probes=probes)
    with tapc.tap_context(ctx):
        loss = model.loss(params, torch.from_numpy(tokens),
                          torch.from_numpy(mlm), torch.from_numpy(mask),
                          pad_mask=torch.from_numpy(pad))
    (g,) = torch.autograd.grad(loss, [probes])
    assert ctx.names == holder["names"] == [
        f"block{i}/{p}" for i in range(2) for p in ("ln1", "attn", "ln2",
                                                    "mlp")]
    ts = trace.finalize(g, len(ctx.names))
    _planes_close(ts.fwd, jts.fwd, "fwd")
    _planes_close(ts.grad, jts.grad, "grad")


# ---------------------------- the remat hazard ------------------------------

def test_remat_taps_equal_no_remat_taps_bit_for_bit():
    """A checkpointed block's forward runs again in the backward.  Its
    taps must neither take new rows nor append the names again nor
    change what the recompute saves (a CheckpointError): with remat
    (policy None and "dots") the TapState equals the one without remat
    bit for bit and the names are the 12 of three blocks, once each —
    through make_train_step (the backward after the tap context has
    exited) and through a tapped backward run inside the context."""
    cfg = pgpt.GPTConfig(**GPT_CFG)
    params = pgpt.GPT(cfg).init(seed=0, device="cpu")
    rng = np.random.RandomState(3)
    tokens = torch.from_numpy(rng.randint(0, 64, (4, 16)).astype(np.int32))
    labels = torch.roll(tokens, -1, 1)
    ref = None
    for remat, policy in ((False, None), (True, None), (True, "dots")):
        model = pgpt.GPT(pgpt.GPTConfig(**GPT_CFG, remat=remat,
                                        remat_policy=policy))
        opt = FusedAdam(lr=1e-3)
        step = ddp.make_train_step(
            lambda p, b, model=model: model.loss(p, b[0], b[1]), opt,
            device="cpu", trace=True)
        out = step(opt.init(params), None, (tokens, labels))
        names = step.tap_names()
        assert len(names) == len(set(names)) == 12
        leaves = [x.detach().requires_grad_(True)
                  for x in F.tree_leaves(params)]
        tree = F.tree_from_leaves(F.make_spec(params), leaves)
        probes = trace.make_probes(32, "cpu").requires_grad_(True)
        ctx = tapc.TapContext(probes=probes)
        with tapc.tap_context(ctx):      # the widened context
            loss = model.loss(tree, tokens, labels)
            g = torch.autograd.grad(loss, [probes] + leaves)[0]
        assert list(ctx.names) == list(names)
        wide = trace.finalize(g, len(ctx.names))
        got = (out[-1].fwd, out[-1].grad, wide.fwd, wide.grad, out[0].params)
        if ref is None:
            ref = got
            continue
        for a, b in zip(got, ref):
            assert torch.equal(a, b), (remat, policy)


# ------------------------ FP16_Optimizer provenance -------------------------

def test_fp16_optimizer_overflow_provenance_equals_jax():
    """A loss-scaling overflow (clean forward, non-finite scaled grads)
    attributes on the gradient plane in both packages, and
    FP16_Optimizer.overflow_provenance() gives the same answer."""
    big = 3e38

    def jloss(p, x):
        return jnp.sum(jtapc.tap(x @ p["w"], "dense")) * big

    jfp = JFP16(JAdam(lr=0.1, use_pallas=False), dynamic_loss_scale=True)
    jp = {"w": jnp.full((4, 1), 1e-3)}
    jstate = jfp.init(jp)

    def scaled(pp, x):
        p, pr = pp
        ctx = jtapc.TapContext(probes=pr)
        with jtapc.tap_context(ctx):
            loss = jloss(p, x)
        return jfp.scale_loss(loss), tuple(ctx.names)

    (jg, jpg), names = jax.grad(scaled, has_aux=True)(
        (jp, jtrace.make_probes(4)), jnp.ones((4, 4)))
    jts = jtrace.finalize(jpg, len(names))
    jfp.step(jstate, jg, tap_state=jts, tap_names=names)
    want = jfp.overflow_provenance()

    fp = FP16_Optimizer(FusedAdam(lr=0.1), dynamic_loss_scale=True,
                        device="cpu")
    w = torch.full((4, 1), 1e-3, requires_grad=True)
    state = fp.init({"w": w.detach()})
    assert fp.overflow_provenance() is None
    probes = trace.make_probes(4, "cpu").requires_grad_(True)
    ctx = tapc.TapContext(probes=probes)
    with tapc.tap_context(ctx):
        loss = torch.sum(tapc.tap(torch.ones(4, 4) @ w, "dense")) * big
    gw, gp = torch.autograd.grad(fp.scale_loss(loss), [w, probes])
    ts = trace.finalize(gp, len(ctx.names))
    assert int(ts.first_bad_fwd) == -1 and int(ts.first_bad_grad) == 0
    params0 = state.params.clone()
    _, state, m = fp.step(state, {"w": gw}, tap_state=ts,
                          tap_names=ctx.names,
                          metrics=monitor.init_metrics("cpu"))
    assert bool(fp.scaler_state.found_inf)
    assert int(m.overflow_count) == 1 and int(m.skipped_steps) == 1
    assert torch.equal(state.params, params0)
    got = fp.overflow_provenance()
    assert {k: v for k, v in got.items() if k != "stats"} == \
        {k: v for k, v in want.items() if k != "stats"} == \
        {"plane": "grad", "tap": "dense", "index": 0}
    np.testing.assert_allclose(
        [got["stats"][k] for k in trace.TAP_STAT_FIELDS],
        [want["stats"][k] for k in trace.TAP_STAT_FIELDS], rtol=1e-6)


# ------------------------ straggler, recorder, report -----------------------

def test_straggler_detector_matches_jax_on_one_sequence():
    rng = np.random.default_rng(5)
    seq = [np.full((4, 2), 0.1) for _ in range(8)]
    for i in (1, 2, 3, 5):
        seq[i] = seq[i].copy()
        seq[i][2, 0] = 0.3 + 0.01 * i
    seq[6] = rng.uniform(0.05, 0.2, (4, 2))
    mine = trace.StragglerDetector(threshold=1.5, patience=2)
    theirs = jtrace.StragglerDetector(threshold=1.5, patience=2)
    for i, t in enumerate(seq):
        x = torch.from_numpy(t) if i % 2 else t
        assert mine.update(x) == theirs.update(t)
        assert mine.flagged_ranks == theirs.flagged_ranks
    assert mine.summary() == theirs.summary()
    with pytest.raises(ValueError, match="threshold"):
        trace.StragglerDetector(threshold=1.0)
    with pytest.raises(ValueError, match="rank count"):
        mine.update(np.ones((3, 2)))


def test_flight_recorder_ring_and_guard(tmp_path):
    path = tmp_path / "r.json"
    rec = trace.FlightRecorder(path, capacity=3, tap_names=["a"])
    with pytest.raises(RuntimeError, match="boom"):
        with rec.guard():
            for i in range(5):
                rec.record(i, metrics={"step": i, "loss": float(i)})
            raise RuntimeError("boom")
    data = json.loads(path.read_text())
    trace.validate_report(data)
    jtrace.validate_report(data)
    assert data["reason"].startswith("exception: RuntimeError")
    assert data["oom"] is False
    assert [r["step"] for r in data["records"]] == [2, 3, 4]
    assert len(rec) == 3 and not os.path.exists(str(path) + ".tmp")
    with pytest.raises(torch.OutOfMemoryError):
        with rec.guard():
            raise torch.OutOfMemoryError("CUDA out of memory")
    assert json.loads(path.read_text())["oom"] is True
    with pytest.raises(ValueError, match="capacity"):
        trace.FlightRecorder(path, capacity=0)
    rep = trace.FlightRecorder(tmp_path / "x.json", capacity=2).report()
    with pytest.raises(ValueError, match="flight_recorder_version"):
        trace.validate_report(dict(rep, flight_recorder_version=99))
    with pytest.raises(ValueError, match="missing report field"):
        trace.validate_report({k: v for k, v in rep.items()
                               if k != "tap_names"})


def test_logger_tap_summary_fields_match_jax(tmp_path):
    planes = dict(fwd=[[2.0, 0.0, 1.0, 0.0], [3.0, 0.0, 1.0, 0.0]],
                  grad=[[0.5, 0.0, 0.1, 0.0], [np.inf, np.nan, np.inf, 7.0]])
    recs = []
    for mon, tr, arr, i32 in ((monitor, trace, torch.tensor, torch.int32),
                              (jmon, jtrace, jnp.asarray, jnp.int32)):
        ts = tr.TapState(fwd=arr(planes["fwd"]), grad=arr(planes["grad"]),
                         first_bad_fwd=arr(-1, dtype=i32),
                         first_bad_grad=arr(1, dtype=i32))
        path = tmp_path / f"{mon.__name__}.jsonl"
        lg = mon.MetricsLogger([mon.JSONLSink(path)], taps=True)
        m = (mon.init_metrics("cpu") if mon is monitor
             else mon.init_metrics())._replace(step=arr(1, dtype=i32))
        rec = lg.log_step(m, taps=ts, tap_names=["l0", "l1"])
        lg.close()
        assert rec["tap_first_bad"] == "l1" and rec["tap_nonfinite"] == 7.0
        recs.append(json.loads(path.read_text()))
    keys = [k for k in recs[1] if k.startswith("tap_")]
    assert {k: recs[0][k] for k in keys} == {k: recs[1][k] for k in keys}
    assert recs[0]["tap_grad_absmax_nonfinite"] == "inf"


def _port_report(tmp_path):
    """A port report with every plane: metrics records from the logger,
    the taps of a tapped step, gathered timings with a straggler, a
    sentry's compile events and an attached serve dict."""
    _, outs, step = _train(True, steps=1)
    rec = trace.FlightRecorder(tmp_path / "p.json", capacity=4,
                               straggler=trace.StragglerDetector(patience=1))
    sentry = RecompileSentry(lambda x: x, recorder=rec, warn=False)
    sentry(torch.zeros(2))
    rec.attach_serve({"ledger": [], "gauges": {"queue_depth": 0}})
    lg = monitor.MetricsLogger([], log_tuner=False)
    m = monitor.init_metrics("cpu")
    for i in range(3):
        m = monitor.update_metrics(m, loss=1.0 / (i + 1), tokens=32)
        timings = torch.tensor([[0.1, 0.01], [0.1 + 0.2 * i, 0.01]])
        rec.record(i, metrics=lg.log_step(m), taps=outs[-1],
                   timings=timings, tap_names=step.tap_names())
    return rec.dump()


def test_reports_cross_validate_and_render_in_both_packages(tmp_path):
    """A port report passes JAX's validate_report and renders with JAX's
    render_report to the port's own text; a JAX report does the same in
    the port."""
    rep = json.loads(json.dumps(_port_report(tmp_path)))
    jtrace.validate_report(rep)
    assert rep["straggler"]["steps_seen"] == 3
    assert rep["compile_events"][0]["name"] == "train_step"
    assert rep["serve"]["gauges"] == {"queue_depth": 0}
    assert rep["records"][2]["timings"]["per_rank"][1][0] == \
        pytest.approx(0.5)
    text = trace.render_report(rep)
    assert text == jtrace.render_report(rep)
    assert "STRAGGLER rank 1" in text and "compile: 1 compile event" in text
    jrec = jtrace.FlightRecorder(tmp_path / "j.json", capacity=2,
                                 tap_names=["t"])
    for i in range(3):
        jrec.record(i, metrics={"step": i, "loss": 1.0})
    jrep = json.loads(json.dumps(jrec.dump(reason="explicit")))
    trace.validate_report(jrep)
    assert trace.render_report(jrep) == jtrace.render_report(jrep)


def test_resume_guard_with_a_flight_recorder_names_the_committed_step(
        tmp_path):
    PS.save_sharded(str(tmp_path / "ck"), 5,
                    {"c": ("replicated", np.zeros(2))})
    mgr = CheckpointManager(str(tmp_path / "ck"))
    rec = trace.FlightRecorder(tmp_path / "crash.json", capacity=2)
    rec.record(5, metrics={"step": 5})
    with pytest.raises(chaos.SimulatedPreemption):
        with chaos.resume_guard(rec, mgr):
            raise chaos.SimulatedPreemption("at ckpt.mid_shards")
    rep = json.loads((tmp_path / "crash.json").read_text())
    jtrace.validate_report(rep)
    assert "last committed checkpoint: step 5" in rep["reason"]
    assert "last committed checkpoint: step 5" in trace.render_report(rep)


# --------------------------- rank timing, 2 ranks ---------------------------

def _timing_inputs():
    rng = np.random.default_rng(7)
    return {"scenarios": ["trace_timing"], "trace_timing": {
        "params": _mlp_params(),
        "x": rng.normal(size=(16, 8)).astype(np.float32),
        "y": rng.normal(size=(16, 4)).astype(np.float32),
        "timing": rng.uniform(0.05, 0.5, (3, 2, 2)).astype(np.float32),
        "fb_w": {"w": np.asarray([[2.0], [1.0]], np.float32)},
        "fb_batch": rng.normal(size=(2, 8, 2)).astype(np.float32),
        "fb_timing": np.asarray([[0.1, 0.02], [0.5, 0.02]], np.float32)}}


def _mlp_params():
    rng = np.random.default_rng(0)
    return {"w1": (rng.normal(size=(8, 16)) * 0.3).astype(np.float32),
            "b1": (rng.normal(size=(16,)) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(16, 4)) * 0.3).astype(np.float32)}


def _jmlp_loss(p, b):
    x, y = b
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] - y) ** 2)


def test_rank_timing_plane_across_two_ranks(tmp_path):
    """One 2-rank gloo world: make_train_step's timing plane (dense and
    ZeRO-2, with metrics) and forward_backward_no_pipelining's against
    the JAX package's all_gather in shard_map on a dp = 2 mesh: the
    gathered matrices exactly, the metrics at rtol 1e-5."""
    inputs = _timing_inputs()
    outs = [o["trace_timing"] for o in
            W.run_ranks(str(tmp_path), 2, inputs)]
    d = inputs["trace_timing"]
    JM.destroy_model_parallel()
    mesh = JM.initialize_model_parallel(devices=jax.devices()[:2])
    cfg = jtrace.TraceConfig(taps=False, rank_timing=True)
    for kind in ("dense", "zero"):
        if kind == "dense":
            jopt = JAdam(lr=1e-2, weight_decay=0.01)
            state = jopt.init(d["params"])
        else:
            jopt = JDAdam(num_shards=2, lr=1e-2, weight_decay=0.01,
                          n_buckets=2)
            state = jax.jit(shard_map(
                jopt.init, mesh=mesh, in_specs=(P(),),
                out_specs=jopt.state_partition_specs(),
                check_vma=False))(d["params"])
        step = jddp.make_train_step(_jmlp_loss, jopt, mesh,
                                    batch_spec=(P("dp"), P("dp")),
                                    donate=False, metrics=True, trace=cfg)
        m = jmon.init_metrics()
        for i in range(3):
            state, _, _, m, gathered = step(state, None, (d["x"], d["y"]),
                                            m, d["timing"][i])
            np.testing.assert_array_equal(np.asarray(gathered),
                                          d["timing"][i])
            want = np.asarray([float(v) for v in m])
            for r, out in enumerate(outs):
                np.testing.assert_array_equal(out[f"{kind}_gathered{i}"],
                                              d["timing"][i])
                got = out[f"{kind}_metrics{i}"]
                if kind == "zero" and r > 0:
                    # a ZeRO step's grad norm is each rank's local
                    # pre-reduction norm; JAX's replicated output is
                    # rank 0's
                    got, want_r = np.delete(got, 2), np.delete(want, 2)
                else:
                    want_r = want
                np.testing.assert_allclose(got, want_r, rtol=1e-5,
                                           err_msg=f"{kind} {r}")

    def local(params, b, timing):
        loss, grads, mm, gathered = jfbnp(
            lambda p, mb: jnp.mean((mb @ p["w"]) ** 2), b, params,
            num_microbatches=2, metrics=jmon.init_metrics(),
            rank_timing=timing.reshape(-1))
        return mm, gathered

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P(), P("dp")),
                           out_specs=(P(), P()), check_vma=False))
    jm, gathered = fn(d["fb_w"], d["fb_batch"], d["fb_timing"])
    np.testing.assert_array_equal(np.asarray(gathered), d["fb_timing"])
    for out in outs:
        np.testing.assert_array_equal(out["fb_gathered"], d["fb_timing"])
        np.testing.assert_allclose(out["fb_metrics"],
                                   [float(v) for v in jm], rtol=1e-5)
    JM.destroy_model_parallel()


def test_moe_gpt_tap_names_and_planes_match_jax():
    """MoE-GPT taps ln1/attn/ln2, the MoE layer's load, drops and gate
    entropy, and mlp a block: through each package's
    `build_moe_train_step(trace=True)` (smoke shapes, one device, the
    JAX weights) the names and both planes match, and the tapped step's
    loss is the untapped one's."""
    from apex_tpu.models import moe_gpt as jmoe_gpt
    from apex_tpu_torch.models import moe_gpt

    JM.destroy_model_parallel()
    model, jstep, args, info = jmoe_gpt.build_moe_train_step(
        False, devices=jax.devices()[:1], trace=True)
    state, _, (tok_sds, _) = args
    params = model.init(jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), tok_sds.shape, 0,
                                info["vocab_size"])
    labels = jnp.roll(tokens, -1, axis=1)
    jout = jstep(state, None, (tokens, labels))
    JM.destroy_model_parallel()
    batch = (torch.from_numpy(np.array(tokens)),
             torch.from_numpy(np.array(labels)))
    outs = []
    for trace_arg in (True, None):
        _, step, _, tinfo = moe_gpt.build_moe_train_step("cpu",
                                                         trace=trace_arg)
        st = tinfo["optimizer"].init(moe_gpt.params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), device="cpu"))
        outs.append(step(st, None, batch))
        if trace_arg:
            names = step.tap_names()
    PM.destroy_model_parallel()
    assert tuple(names) == tuple(jstep.tap_names())
    assert tuple(names[:7]) == (
        "block0/ln1", "block0/attn", "block0/ln2", "block0/moe/load",
        "block0/moe/drop", "block0/moe/gate_entropy", "block0/mlp")
    _planes_close(outs[0][-1].fwd, jout[-1].fwd, "fwd")
    _planes_close(outs[0][-1].grad, jout[-1].grad, "grad")
    assert torch.equal(outs[0][2], outs[1][2])
