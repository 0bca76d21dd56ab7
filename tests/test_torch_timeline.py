"""The port's runtime timeline observatory and profiler capture
(apex_tpu_torch.monitor.timeline, monitor.ProfileCapture) against the
JAX package's, on the CPU.

  * the JAX package's committed report (scripts/timeline_fixture.json,
    read only) validates in both packages and renders to the same
    table; the JAX package's trace forms (TPU-style device lanes, a CPU
    trace) give equal `to_dict()`s and tables through both packages'
    `analyze_trace`;
  * hand-made Kineto traces (what `torch.profiler` writes on a card)
    give the numbers worked out by hand: the busy union over two
    streams, an NCCL kernel concurrent with a GEMM (measured overlap
    0.5), a host-to-device copy, the annotation mirrors on the stream
    lanes counted nowhere, a collective named by the host range around
    its launch;
  * the trimmed card trace (tests/fixtures/torch_h100_step.trace.json.gz,
    made by tests/fixtures/torch_trace_fixture.py) parses;
  * a real CPU capture of three tiny steps gives 3 windows with the
    overlap unmeasurable; truncated or corrupt files raise
    `TraceParseError`; `ProfileCapture`'s contract mirrors
    tests/test_monitor.py's; both validators refuse the same dicts.

Times are exact in the hand-made traces (microseconds, compared with
pytest.approx at its default 1e-6 relative).
"""

import gzip
import json
import os
import pathlib

import pytest
import torch

from apex_tpu.monitor import timeline as jtimeline
from apex_tpu_torch import monitor
from apex_tpu_torch.monitor import timeline
from apex_tpu_torch.parallel import mesh as M

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_FIXTURE = ROOT / "scripts" / "timeline_fixture.json"
CARD_TRACE = ROOT / "tests" / "fixtures" / "torch_h100_step.trace.json.gz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny ops run faster on one thread than spread over a shared
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------- the JAX package's trace forms ----------------------

def _meta_tpu():
    return [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "pid": 1, "tid": 10, "name": "thread_name",
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "pid": 1, "tid": 11, "name": "thread_name",
         "args": {"name": "XLA Ops #2"}},
        {"ph": "M", "pid": 9, "name": "process_name",
         "args": {"name": "/host:CPU"}},
    ]


def _step(i, t0, wall=1000.0):
    return {"ph": "X", "pid": 9, "tid": 1, "name": "train-step",
            "ts": t0, "dur": wall, "args": {"step_num": str(i)}}


def _op(name, ts, dur, tid=10, pid=1):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts,
            "dur": dur, "args": {"hlo_op": name, "hlo_module": "jit_step"}}


def _jax_traces():
    """Named TPU- and CPU-style traces of the JAX package's tests."""
    second = [{"ph": "M", "pid": 2, "name": "process_name",
               "args": {"name": "/device:TPU:1"}},
              {"ph": "M", "pid": 2, "tid": 20, "name": "thread_name",
               "args": {"name": "XLA Ops"}}]
    return {
        "overlap": _meta_tpu() + [
            _step(0, 0.0), _op("all-reduce.1", 100.0, 200.0, tid=11),
            _op("dot.1", 150.0, 100.0), _op("reduce-scatter.2", 500.0,
                                            150.0, tid=11),
            _op("fusion.3", 700.0, 100.0)],
        "gapped": _meta_tpu() + [
            _step(0, 0.0), _op("dot.1", 100.0, 250.0),
            _op("fusion.2", 600.0, 150.0), _step(1, 2000.0),
            _op("dot.1", 2000.0, 100.0), _op("fusion.2", 2050.0, 100.0,
                                             tid=11),
            _step(2, 4000.0)],
        "lanes": _meta_tpu() + [
            {"ph": "M", "pid": 1, "tid": 99, "name": "thread_name",
             "args": {"name": "XLA Modules"}},
            _step(0, 0.0), _op("dot.1", 100.0, 300.0),
            {"ph": "X", "pid": 1, "tid": 99, "name": "jit_step",
             "ts": 0.0, "dur": 1000.0}],
        "devices": _meta_tpu() + second + [
            _step(0, 0.0), _op("all-reduce.1", 100.0, 200.0),
            _op("dot.1", 150.0, 400.0, pid=2, tid=20),
            _op("all-reduce.1", 600.0, 200.0, pid=2, tid=20)],
        "cpu": [{"ph": "M", "pid": 7, "name": "process_name",
                 "args": {"name": "/host:CPU"}},
                _step(0, 0.0), _op("dot.1", 100.0, 300.0, pid=7, tid=2),
                _op("all-reduce.1", 450.0, 200.0, pid=7, tid=2)],
        "seeded_idle": _meta_tpu() + [
            e for i in range(3) for e in (
                _step(i, i * 10_000.0, wall=10_000.0),
                _op("fusion.1", i * 10_000.0 + 10.0, 2_000.0))],
        "unannotated": _meta_tpu() + [_op("dot.1", 0.0, 10.0),
                                      _op("fusion.4", 20.0, 5.0)],
    }


def _tables_equal(a: str, b: str):
    """The two packages' tables, line for line; the unmeasurable-overlap
    line names each package's remedy and is compared by its start."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x.startswith("overlap: UNMEASURABLE"):
            assert y.startswith("overlap: UNMEASURABLE")
        else:
            assert x == y


def test_jax_fixture_validates_and_renders_as_jax():
    with open(JAX_FIXTURE) as f:
        rep = json.load(f)
    timeline.validate_timeline_report(rep)
    jtimeline.validate_timeline_report(rep)
    assert timeline.render_timeline_table(rep, label="fixture-step") \
        == jtimeline.render_timeline_table(rep, label="fixture-step")


@pytest.mark.parametrize("name", sorted(_jax_traces()))
def test_jax_traces_analyze_as_jax(name):
    obj = {"traceEvents": _jax_traces()[name]}
    got, want = timeline.analyze_trace(obj), jtimeline.analyze_trace(obj)
    assert got.to_dict() == want.to_dict()
    assert got.timeline_record() == want.timeline_record()
    _tables_equal(timeline.render_timeline_table(got),
                  jtimeline.render_timeline_table(want))


def test_crosscheck_and_its_table_as_jax():
    """The crosscheck's passes (exact name, prefix group, kind order)
    over one report pair give the JAX package's rows and table."""
    def cc(name, kind, overlap=None, expected=False, group_size=2):
        return {"name": name, "kind": kind, "group_size": group_size,
                "overlap_fraction": overlap, "expected_overlap": expected}

    def span(name, kind, frac, total_ms=1.0):
        return {"name": name, "kind": kind, "overlap_fraction": frac,
                "total_ms": total_ms, "n_events": 3,
                "concurrent_compute_ms": 0.0, "serialized": frac == 0.0}

    comms = {"collectives": [
        cc("all-reduce.3", "all-reduce", 0.9, True),
        cc("reduce-scatter-start.5", "reduce-scatter", 0.8, True),
        cc("collective-permute.9", "collective-permute", 0.9, True),
        cc("collective-permute.10", "collective-permute", 0.2, True),
        cc("all-gather.7", "all-gather", None),
        cc("all-to-all.2", "all-to-all", 0.5),
        cc("all-reduce.1", "all-reduce", 0.9, group_size=1)]}
    tl = {"collectives": [
        span("all-reduce.3", "all-reduce", 0.95),
        span("reduce-scatter.5", "reduce-scatter", 0.1),
        span("collective-permute.21", "collective-permute", 0.85),
        span("collective-permute.22", "collective-permute", 0.0),
        span("all-gather.40", "all-gather", 0.6)],
        "overlap_measurable": True}
    got = timeline.crosscheck_comms(tl, comms)
    assert got == jtimeline.crosscheck_comms(tl, comms)
    assert got["ok"] is False and got["n_diverge"] >= 1
    assert timeline.render_crosscheck(got, "x") \
        == jtimeline.render_crosscheck(got, "x")


# --------------------------- Kineto (card) traces ---------------------------

HOST, DEV = 100, 0


def _meta_gpu():
    return [
        {"ph": "M", "pid": HOST, "tid": 0, "name": "process_name",
         "args": {"name": "python3"}},
        {"ph": "M", "pid": HOST, "tid": 0, "name": "process_labels",
         "args": {"labels": "CPU"}},
        {"ph": "M", "pid": DEV, "tid": 0, "name": "process_name",
         "args": {"name": "python3"}},
        {"ph": "M", "pid": DEV, "tid": 0, "name": "process_labels",
         "args": {"labels": "GPU 0"}},
        {"ph": "M", "pid": DEV, "tid": 7, "name": "thread_name",
         "args": {"name": "stream 7 "}},
    ]


def _x(cat, name, ts, dur, pid=DEV, tid=7, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
         "ts": ts, "dur": dur, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _gpu_trace():
    """One step, window [-10, 500] (host range) on a card:

        stream 7   flash_fwd_kernel  [0, 100]     other
        stream 13  ln_fwd_kernel     [50, 150]    other (overlaps: union)
        stream 20  ncclDevKernel_AllReduce [200, 300]  collective
        stream 7   nvjet gemm        [250, 350]   gemm (half the NCCL span)
        stream 7   Memcpy HtoD       [400, 420]   infeed_outfeed
        stream 7   Memcpy DtoD       [440, 460]   launched inside the host
                                                  range "all-gather.3"
        stream 7   gpu_user_annotation mirrors [0, 460]: never work

    busy union [0,150] + [200,350] + [400,420] + [440,460] = 340 us of
    510; categories other 200, collective 100 + 20, gemm 100, infeed 20
    (440 in all); the NCCL kernel's span holds 50 us of compute (0.5);
    the copy named all-gather.3 holds none (0.0, under the 0.1 ms
    serialized floor)."""
    return _meta_gpu() + [
        _x("user_annotation", "train-step#4", -10.0, 510.0, pid=HOST,
           tid=HOST),
        _x("gpu_user_annotation", "train-step#4", 0.0, 460.0),
        _x("kernel", "void (anonymous namespace)::flash_fwd_kernel<64, "
           "true, false>(FwdArgs)", 0.0, 100.0),
        _x("kernel", "void (anonymous namespace)::ln_fwd_kernel<"
           "__nv_bfloat16, 256, true, 1>(LnArgs)", 50.0, 100.0, tid=13),
        _x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL("
           "ncclDevKernelArgsStorage<4096ul>)", 200.0, 100.0, tid=20),
        _x("kernel", "nvjet_tst_128x64_64x8_1x2_h_bz_NNT", 250.0, 100.0),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 400.0, 20.0),
        _x("user_annotation", "all-gather.3", 430.0, 30.0, pid=HOST,
           tid=HOST),
        _x("cuda_runtime", "cudaMemcpyAsync", 435.0, 5.0, pid=HOST,
           tid=HOST, corr=77),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 440.0, 20.0,
           corr=77),
        _x("gpu_user_annotation", "all-gather.3", 440.0, 20.0),
        _x("cpu_op", "aten::mm", 240.0, 20.0, pid=HOST, tid=HOST),
    ]


def test_gpu_trace_numbers_by_hand():
    rep = timeline.analyze_trace({"traceEvents": _gpu_trace()})
    assert rep.device_type == "gpu" and rep.overlap_measurable
    (s,) = rep.steps
    assert s.step == 4 and s.wall_ms == pytest.approx(0.51)
    assert s.device_busy_ms == pytest.approx(0.34)
    assert s.host_gap_ms == pytest.approx(0.17)
    assert s.n_device_events == 6
    assert s.category_ms == pytest.approx(
        {"gemm": 0.1, "collective": 0.12, "infeed_outfeed": 0.02,
         "other": 0.2})
    assert rep.category_fractions["collective"] == pytest.approx(12 / 44)
    assert rep.n_device_events == 6
    # the host range, the launch and the aten op; the mirrors are neither
    assert rep.n_host_events == 3
    by = {c.name: c for c in rep.collectives}
    nccl = next(c for c in rep.collectives if c.name.startswith("nccl"))
    assert nccl.kind == "all-reduce"
    assert nccl.overlap_fraction == pytest.approx(0.5)
    assert nccl.concurrent_compute_ms == pytest.approx(0.05)
    ag = by["all-gather.3"]
    assert ag.kind == "all-gather" and ag.overlap_fraction == 0.0
    assert not ag.serialized and rep.measured_overlap_ok is True
    d = json.loads(json.dumps(rep.to_dict()))
    timeline.validate_timeline_report(d)
    jtimeline.validate_timeline_report(d)


def test_gpu_serialized_collective_is_measured():
    """A 200 us NCCL kernel with no concurrent compute on its device is
    MEASURED-SERIALIZED; another device's compute does not hide it."""
    ev = _meta_gpu() + [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_labels",
         "args": {"labels": "GPU 1"}},
        _x("user_annotation", "train-step#0", 0.0, 1000.0, pid=HOST,
           tid=HOST),
        _x("kernel", "ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL",
           100.0, 200.0, tid=20),
        _x("kernel", "sm90_xmma_gemm_bf16bf16", 100.0, 200.0, pid=1),
    ]
    rep = timeline.analyze_trace({"traceEvents": ev})
    (c,) = rep.collectives
    assert c.kind == "reduce-scatter" and c.serialized
    assert rep.measured_overlap_ok is False
    # per-device means: 200 us busy on each of two devices
    assert rep.steps[0].device_busy_ms == pytest.approx(0.2)
    assert "MEASURED-SERIALIZED" in timeline.render_timeline_table(rep)


def test_classify_op_cuda_names():
    c = timeline.classify_op
    assert c("ncclDevKernel_AllGather_RING_LL(x)") == "collective"
    assert c("ncclKernel_SendRecv_RING_SIMPLE_Sum_int8_t") == "collective"
    assert timeline.report.collective_kind(
        "ncclDevKernel_SendRecv(x)") == "collective-permute"
    assert timeline.report.collective_kind(
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "all-reduce"
    assert c("Memcpy HtoD (Pageable -> Device)") == "infeed_outfeed"
    assert c("Memcpy DtoH (Device -> Pinned)") == "infeed_outfeed"
    assert c("Memcpy DtoD (Device -> Device)") == "other"
    assert c("nvjet_tst_64x48_64x15_2x4_h_bz_TNT") == "gemm"
    assert c("void cutlass::Kernel2<cutlass_80_tensorop>") == "gemm"
    assert c("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert c("void (anonymous namespace)::dense_wgmma_kernel<1, true>"
             "(CUtensorMap)") == "gemm"
    assert c("void (anonymous namespace)::dense_gemv_kernel<float>()") \
        == "gemm"
    assert c("void (anonymous namespace)::flash_fwd_kernel<64>()") \
        == "other"
    assert c("_adam_kernel") == "other"
    assert c("Memset (Device)") == "other"
    # the collective an event belongs to wins over its name
    assert c("Memcpy DtoD (Device -> Device)", "all-gather.3") \
        == "collective"


def test_step_numbers_from_either_mark():
    """"<annotation>#<i>" (ProfileCapture) and Kineto's
    "ProfilerStep#<i>" give the same step numbers."""
    def trace(mark):
        return {"traceEvents": _meta_gpu() + [
            _x("user_annotation", f"{mark}#{i}", 1000.0 * i, 900.0,
               pid=HOST, tid=HOST) for i in (5, 6)] + [
            _x("kernel", "k", 1000.0 * i + 10, 50.0) for i in (5, 6)]}

    a = timeline.analyze_trace(trace("train-step"))
    b = timeline.analyze_trace(trace("ProfilerStep"))
    assert [s.step for s in a.steps] == [s.step for s in b.steps] == [5, 6]
    assert a.to_dict()["steps"] == b.to_dict()["steps"]
    parsed = timeline.parse_trace(trace("ProfilerStep"))
    assert [e.step_num for e in parsed.events
            if e.cat == "user_annotation"] == [5, 6]


def test_card_trace_fixture_parses():
    with gzip.open(CARD_TRACE, "rt") as f:
        obj = json.load(f)
    assert len(obj["traceEvents"]) < 1000
    rep = timeline.analyze_trace(str(CARD_TRACE))
    assert rep.device_type == "gpu" and rep.overlap_measurable
    (s,) = rep.steps
    assert s.step == 3 and s.n_device_events == rep.n_device_events > 0
    assert 0.0 < s.device_busy_fraction <= 1.0
    d = json.loads(json.dumps(rep.to_dict()))
    timeline.validate_timeline_report(d)
    jtimeline.validate_timeline_report(d)
    tr = timeline.read_trace(str(CARD_TRACE))
    kernels = [e.name for e in tr.events if e.cat == "kernel"]
    # the fixture's GPT: 2 layers, one flash forward and backward each
    assert sum("flash_fwd_kernel<" in k for k in kernels) == 2
    assert sum("flash_bwd_kernel<" in k for k in kernels) == 2
    assert sum(k == "_adam_kernel" for k in kernels) == 1
    # the collectives are named after the inventory by their host ranges
    names = {c.name for c in rep.collectives}
    assert names and all(timeline.events.COLLECTIVE_NAME.match(n)
                         for n in names)
    assert {c.kind for c in rep.collectives} >= {"all-gather",
                                                 "reduce-scatter"}
    assert rep.category_fractions["gemm"] > 0


# ------------------------------ real captures ------------------------------

def _tiny_step(x, w):
    return torch.tanh(x @ w).sum()


def test_cpu_capture_three_steps(tmp_path):
    cap = monitor.profile_capture(range(1, 4), logdir=str(tmp_path),
                                  device="cpu")
    x, w = torch.randn(32, 32), torch.randn(32, 32)
    for i in range(5):
        with cap.step(i):
            _tiny_step(x, w)
    path = cap.trace_path()
    assert path.endswith(".trace.json.gz") and path.startswith(str(tmp_path))
    rep = monitor.analyze_trace(path)
    assert [s.step for s in rep.steps] == [1, 2, 3]
    assert rep.device_type == "cpu" and rep.n_device_events == 0
    assert rep.overlap_measurable is False
    assert rep.measured_overlap_ok is None
    assert all(s.wall_ms > 0 for s in rep.steps)
    rec = rep.timeline_record()
    assert "timeline_measured_overlap_ok" not in rec
    monitor.validate_timeline_report(rep.to_dict())
    lg = monitor.MetricsLogger([], timeline=rep)
    r = lg.log_step(monitor.init_metrics("cpu"))
    monitor.validate_record(r)
    assert r["timeline_device_busy_fraction"] == 0.0


def test_malformed_trace_named_error(tmp_path):
    payload = json.dumps({"traceEvents": _gpu_trace()}).encode()
    good = tmp_path / "t.trace.json.gz"
    good.write_bytes(gzip.compress(payload))
    timeline.analyze_trace(str(good))
    cut = tmp_path / "cut.trace.json.gz"
    cut.write_bytes(gzip.compress(payload)[:40])
    with pytest.raises(timeline.TraceParseError, match="cannot parse"):
        timeline.analyze_trace(str(cut))
    garbage = tmp_path / "garbage.trace.json"
    garbage.write_text("{not json")
    with pytest.raises(timeline.TraceParseError):
        timeline.analyze_trace(str(garbage))
    notdict = tmp_path / "list.trace.json"
    notdict.write_text("[1, 2]")
    with pytest.raises(timeline.TraceParseError, match="trace-event"):
        timeline.analyze_trace(str(notdict))
    with pytest.raises(timeline.TraceParseError, match="traceEvents"):
        timeline.analyze_trace({"no": "events"})
    with pytest.raises(timeline.TraceParseError, match="no trace"):
        timeline.analyze_trace(None)
    assert issubclass(timeline.TraceParseError, ValueError)
    # a malformed row costs the row: Kineto's string pids ("Spans")
    tr = timeline.parse_trace({"traceEvents": _gpu_trace() + [
        {"ph": "X", "cat": "Trace", "pid": "Spans", "tid": "PyTorch",
         "name": "PyTorch Profiler (0)", "ts": 0, "dur": 1}]})
    assert len(tr.events) == len(_gpu_trace()) - 5


# ---------------------- ProfileCapture's contract ----------------------

def test_profile_capture_window(tmp_path):
    cap = monitor.profile_capture(range(1, 3), logdir=str(tmp_path / "t"),
                                  device="cpu")
    seen = []
    for i in range(5):
        with cap.step(i):
            seen.append((cap.active, M._OBSERVER is not None))
            torch.ones(4, 4).sum()
    assert seen == [(False, False), (True, True), (True, True),
                    (False, False), (False, False)]
    assert not cap.active and M._OBSERVER is None
    assert os.listdir(tmp_path / "t")
    cap.close()   # idempotent


def test_profile_capture_rejects_gapped_ranges(tmp_path):
    with pytest.raises(ValueError, match="contiguous"):
        monitor.profile_capture({3, 10}, logdir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        monitor.ProfileCapture([0, 2, 3], logdir=str(tmp_path), device="cpu")
    monitor.ProfileCapture([2, 1, 3, 2], logdir=str(tmp_path), device="cpu")
    monitor.ProfileCapture((), logdir=str(tmp_path), device="cpu")


def test_profile_capture_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        monitor.ProfileCapture(range(2))


def test_profile_capture_close_is_safety_net(tmp_path):
    cap = monitor.profile_capture([0, 1], logdir=str(tmp_path / "t"),
                                  device="cpu")
    with cap.step(0):
        pass
    assert cap.active and cap.trace_path() is None
    cap.close()
    assert not cap.active and cap.trace_path() is not None
    cap.close()
    assert not cap.active


def test_profile_capture_trace_path(tmp_path):
    cap = monitor.profile_capture(range(1, 3), logdir=str(tmp_path / "t"),
                                  device="cpu")
    assert cap.trace_path() is None
    for i in range(4):
        with cap.step(i):
            torch.ones(4, 4).sum()
    assert monitor.analyze_trace(cap.trace_path()).n_events > 0
    cap2 = monitor.profile_capture(range(50, 52),
                                   logdir=str(tmp_path / "t2"), device="cpu")
    for i in range(3):
        with cap2.step(i):
            pass
    cap2.close()
    assert cap2.trace_path() is None


def test_profile_capture_step_reentry_raises(tmp_path):
    cap = monitor.profile_capture([0, 1], logdir=str(tmp_path / "t"),
                                  device="cpu")
    with pytest.raises(monitor.ProfileStepReentryError, match="still open"):
        with cap.step(0):
            with cap.step(1):
                pass
    cap.close()
    inert = monitor.ProfileCapture((), device="cpu")
    with inert.step(0):
        with inert.step(1):
            pass
    cap2 = monitor.profile_capture(range(1, 3), logdir=str(tmp_path / "t3"),
                                   device="cpu")
    with cap2.step(0):
        with cap2.step(1):
            pass
        assert not cap2.active
    with cap2.step(1):
        assert cap2.active
        with pytest.raises(monitor.ProfileStepReentryError):
            with cap2.step(2):
                pass
    cap2.close()
    assert M._OBSERVER is None


# -------------------------- the two validators --------------------------

def _drifted():
    rep = timeline.analyze_trace({"traceEvents": _gpu_trace()}).to_dict()
    rep = json.loads(json.dumps(rep))
    cases = [("ok", rep),
             ("version", dict(rep, timeline_schema_version=2)),
             ("missing", {k: v for k, v in rep.items()
                          if k != "device_busy_fraction"}),
             ("bool", dict(rep, n_events=True)),
             ("type", dict(rep, overlap_measurable="yes"))]
    for mutate in ("kind", "sum", "category", "step"):
        bad = json.loads(json.dumps(rep))
        if mutate == "kind":
            bad["collectives"][0]["kind"] = "psum"
        elif mutate == "sum":
            bad["category_fractions"]["gemm"] += 0.5
        elif mutate == "category":
            del bad["steps"][0]["category_ms"]["other"]
        else:
            bad["steps"][0]["wall_ms"] = "1"
        cases.append((mutate, bad))
    return cases


@pytest.mark.parametrize("case", range(9))
def test_both_validators_agree(case):
    name, d = _drifted()[case]
    results = []
    for validate in (timeline.validate_timeline_report,
                     jtimeline.validate_timeline_report):
        try:
            validate(d)
            results.append(True)
        except ValueError:
            results.append(False)
    assert results == [name == "ok"] * 2


# ------------------------------ the example ------------------------------

def test_train_with_monitor_example(tmp_path):
    """examples/torch_train_with_monitor.py on the CPU: 3 steps with a
    capture over steps 0-1 and a flight report; the JSONL validates and
    its last record carries the timeline stamps, the report validates,
    renders and carries the audit with its comms plane."""
    import subprocess
    import sys

    from apex_tpu_torch.monitor.trace import report as trace_report

    jsonl, flight = tmp_path / "m.jsonl", tmp_path / "flight.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "torch_train_with_monitor.py"),
         "--device", "cpu", "--steps", "3", "--profile-steps", "0:2",
         "--profile-dir", str(tmp_path / "trace"), "--jsonl", str(jsonl),
         "--flight-report", str(flight)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "=== timeline: steps 0:2 ===" in proc.stdout
    with open(jsonl) as f:
        records = [json.loads(line) for line in f]
    monitor.validate_records(records)
    assert len(records) == 3
    assert "timeline_device_busy_fraction" in records[-1]
    with open(flight) as f:
        rep = json.load(f)
    text = trace_report.render_report(rep)
    assert "=== numerics flight report ===" in text
    cr = rep["compile_report"]
    assert cr["backend"] == "cpu" and cr["flops_ok"] is True
    monitor.comms.validate_comms_report(cr["comms"])
    assert len(rep["records"]) == 3
