"""The port's utils (apex_tpu_torch.utils: log_util, timers) and the
root `RankInfoFormatter` / `deprecated_warning`, beside the JAX
package's: the counterparts of tests/test_log_util_timers.py's cases.

The timers read the host clock on both sides, so what is held is their
behaviour, not their readings: the package logger's handler, the
rank-info format, the env verbosity, the blocking stop (the JAX
package's drains its live arrays, the port's synchronizes the card),
the profiler range under the timer's name, and the `log` / `write` text
and unknown-name errors, on the same sequence of calls."""

import logging
import re
import time

import pytest
import torch

import apex_tpu_torch
from apex_tpu.utils import log_util as jlog
from apex_tpu.utils.timers import Timers as JTimers
from apex_tpu_torch.utils import log_util
from apex_tpu_torch.utils.timers import Timers, _Timer


@pytest.fixture
def package_logger():
    logger = logging.getLogger("apex_tpu_torch")
    before, level = list(logger.handlers), logger.level
    yield logger
    logger.handlers[:] = before
    logger.setLevel(level)


def test_set_logging_level_idempotent(package_logger):
    """Two calls leave one stream handler (the rank-info formatter would
    double every line), as the JAX package's."""
    log_util.set_logging_level("DEBUG")
    n1 = len(package_logger.handlers)
    log_util.set_logging_level("INFO")
    assert len(package_logger.handlers) == n1
    assert package_logger.level == logging.INFO
    fmt = [h.formatter for h in package_logger.handlers
           if isinstance(h, logging.StreamHandler)][0]
    assert isinstance(fmt, apex_tpu_torch.RankInfoFormatter)


def test_rank_info_formatter_formats_without_mesh():
    """Without a mesh the rank info is this process's ("proc0"), stable
    across calls; the JAX formatter formats the same record alike."""
    from apex_tpu import RankInfoFormatter as JFormatter

    f = apex_tpu_torch.RankInfoFormatter("[%(rank_info)s] %(message)s")
    rec = logging.LogRecord("apex_tpu_torch.x", logging.INFO, __file__, 1,
                            "hello", (), None)
    out = f.format(rec)
    assert out == "[proc0] hello"
    assert f.format(rec) == out
    jout = JFormatter("[%(rank_info)s] %(message)s").format(rec)
    assert jout.startswith("[") and jout.endswith("] hello")


def test_env_var_verbosity_applies_at_import(monkeypatch):
    """APEX_TPU_TORCH_VERBOSITY sets the package logger's level when
    log_util is imported (here: executed again by a reload)."""
    import importlib

    logger = logging.getLogger("apex_tpu_torch")
    level, handlers = logger.level, list(logger.handlers)
    monkeypatch.setenv("APEX_TPU_TORCH_VERBOSITY", "DEBUG")
    try:
        importlib.reload(log_util)
        assert logger.level == logging.DEBUG
    finally:
        logger.setLevel(level)
        logger.handlers[:] = handlers


def test_get_transformer_logger_strips_extension():
    assert log_util.get_transformer_logger("module.py").name == \
        jlog.get_transformer_logger("module.py").name == "module"


def test_deprecated_warning_warns_without_a_process_group():
    with pytest.warns(FutureWarning, match="old name"):
        apex_tpu_torch.deprecated_warning("old name")


def test_timer_block_synchronizes_the_card(monkeypatch):
    """stop(block=True) waits for the card before reading the clock (the
    JAX timer drains its live arrays); a plain stop does not."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("sync"))
    t = _Timer("x")
    t.start()
    t.stop(block=True)
    assert calls == ["sync"]
    t.start()
    t.stop()
    assert calls == ["sync"]


def test_timer_opens_a_profiler_range_under_its_name(monkeypatch):
    """start / stop enter and leave a `torch.profiler.record_function`
    range named as the timer (the JAX TraceAnnotation), which a
    profiler trace then holds."""
    events = []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            events.append(("enter", self.name))

        def __exit__(self, *exc):
            events.append(("exit", self.name))

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    t = Timers()
    t("fwd-phase").start()
    assert events == [("enter", "fwd-phase")]
    t("fwd-phase").stop(block=True)
    assert events == [("enter", "fwd-phase"), ("exit", "fwd-phase")]
    t("fwd-phase").elapsed()            # a stopped timer: no range
    assert len(events) == 2


def test_timer_wall_clock_covers_execution():
    t = Timers()
    t("step").start()
    time.sleep(0.01)
    t("step").stop(block=True)
    assert t("step").elapsed(reset=True) >= 0.01
    t("step").start()      # restartable after elapsed(reset=True)
    t("step").stop()


def test_timers_unknown_name_raises_clear_keyerror():
    for T in (Timers, JTimers):
        t = T()
        t("fwd").start()
        t("fwd").stop()
        with pytest.raises(KeyError, match=r"unknown timer 'bwd'.*fwd"):
            t.log(["bwd"])
        with pytest.raises(KeyError, match="unknown timer"):
            t.write(["nope"], writer=None, iteration=0)
        assert sorted(t.timers) == ["fwd"]
        with pytest.raises(KeyError, match=r"\(none\)"):
            T().log(["anything"])


class _Writer:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, value, step))


def test_timers_log_and_write_match_the_jax_text():
    """The same calls give the same `log` text (the times as `%.2f` ms,
    which both read as 0.00 for an empty interval) and the same `write`
    rows."""
    out = []
    for T in (Timers, JTimers):
        t = T()
        for name in ("fwd", "bwd"):
            t(name).start()
            t(name).stop()
        s = re.sub(r"\d+\.\d\d", "T", t.log(["fwd", "bwd"], reset=False))
        w = _Writer()
        t.write(["fwd"], w, iteration=3, normalizer=2.0)
        out.append((s, [(tag, step) for tag, _, step in w.rows]))
    assert out[0] == out[1]
    assert out[0][0] == "time (ms) | fwd: T | bwd: T"
    assert out[0][1] == [("fwd-time", 3)]


def test_timers_write_lands_in_the_metrics_logger(tmp_path):
    """`Timers.write(names, logger.writer, step)` puts `<name>-time` into
    the port's metrics JSONL, as the monitor example does."""
    import json

    from apex_tpu_torch import monitor

    logger = monitor.MetricsLogger([monitor.JSONLSink(
        str(tmp_path / "m.jsonl"))])
    t = Timers()
    t("train-step").start()
    t("train-step").stop(block=True)
    t.write(["train-step"], logger.writer, 7, reset=True)
    logger.close()
    rows = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert any("train-step-time" in json.dumps(r) for r in rows)
