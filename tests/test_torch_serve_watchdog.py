"""The port's engine watchdog and the serving overload storm, held
against the JAX package on the CPU: `EngineWatchdog` trips on a stalled
heartbeat with the JAX watchdog's error, its step and its message, and
`restart()` resumes a fresh engine whose tokens are the JAX engine's bit
for bit; an idle engine never trips; the snapshot stays known-good
through poison; and bench.py's 4x overload storm with mixed deadlines
sheds and expires the same requests in both engines, gives the same
tokens for every request that ends ok, and keeps both gates (the
ledger's balance, a drained page pool).  The watchdogs read an injected
clock, so no test waits on wall time.  The weights are the JAX test's
(`tests/test_serve_resilience.py`), carried by `params_from_jax`."""

import jax
import numpy as np
import pytest
import torch

from apex_tpu.checkpoint import chaos as jchaos
from apex_tpu.models.gpt import GPT, GPTConfig
from apex_tpu.serve import DecodeEngine as JDecodeEngine
from apex_tpu.serve import EngineStalledError as JEngineStalledError
from apex_tpu.serve import EngineWatchdog as JEngineWatchdog
from apex_tpu.serve import PoisonedOutputError as JPoisonedOutputError
from apex_tpu.serve import ServeConfig as JServeConfig
from apex_tpu_torch.checkpoint import chaos
from apex_tpu_torch.models import GPTConfig as TGPTConfig
from apex_tpu_torch.models import params_from_jax
from apex_tpu_torch.serve import (DecodeEngine, EngineStalledError,
                                  EngineWatchdog, PoisonedOutputError,
                                  ServeConfig)

_JCFG = GPTConfig(vocab_size=64, seq_len=64, hidden=32, num_layers=2,
                  num_heads=4, dropout=0.0)
_CFG = TGPTConfig(vocab_size=64, seq_len=64, hidden=32, num_layers=2,
                  num_heads=4, dropout=0.0, dtype=torch.float32)
_SC = dict(n_slots=3, max_prompt_len=8, max_new_cap=8, page_size=4)

_PROMPTS = [[5, 9, 2, 17], [33, 1], [40, 41, 42], [8, 9], [11, 12, 13],
            [21, 22], [7, 7, 7]]
_BUDGETS = [6, 8, 5, 4, 7, 3, 5]


@pytest.fixture(scope="module")
def jax_params():
    p = GPT(_JCFG).init(jax.random.PRNGKey(7))
    p["pos_embed"] = p["pos_embed"] * 20.0  # varied decode trajectories
    return p


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                           device="cpu")


@pytest.fixture(scope="module")
def ref_tokens(jax_params):
    """The JAX engine's unloaded run, which every request that ends ok
    must match bit for bit."""
    eng = JDecodeEngine(_JCFG, jax_params, JServeConfig(**_SC))
    for p, b in zip(_PROMPTS, _BUDGETS):
        eng.submit(p, b)
    return {f.request_id: f.tokens for f in eng.run()}


@pytest.fixture(autouse=True)
def _disarm():
    for mod in (chaos, jchaos):
        mod.disarm_all()
    yield
    for mod in (chaos, jchaos):
        mod.disarm_all()


def _engines(jax_params, params, **serve):
    return (JDecodeEngine(_JCFG, jax_params, JServeConfig(**_SC, **serve)),
            DecodeEngine(_CFG, params, ServeConfig(**_SC, **serve),
                         device="cpu"))


def _assert_clean(eng, fins, ref):
    for rid, f in fins.items():
        if f.status == "ok":
            assert f.tokens == ref[rid], f"request {rid} drifted"
    assert eng.cache.free_pages == eng.kv_config.usable_pages
    assert eng.telemetry.ledger.balance()["ok"], \
        eng.telemetry.ledger.balance()


class _Recorder:
    """A flight recorder stand-in: keeps the reasons it was asked to
    dump for."""

    def __init__(self):
        self.reasons = []

    def dump(self, reason):
        self.reasons.append(reason)


def _stall_and_restart(chaos_mod, stalled_error, eng, dog, clock):
    """The JAX test's drive loop with the injected clock: a loop turn is
    0.02 s; a trip restarts the engine from the watchdog's snapshot."""
    fins, tripped, steps = {}, None, 0
    while eng.pending:
        assert steps < 400
        eng.step()
        for f in eng.poll():
            fins[f.request_id] = f
        try:
            dog.check()
        except stalled_error as e:
            tripped = e
            eng = dog.restart()
        clock[0] += 0.02
        steps += 1
    eng._retire_finished()
    for f in eng.poll():
        fins[f.request_id] = f
    return eng, fins, tripped


def test_watchdog_trips_restarts_bitwise(jax_params, params, ref_tokens):
    """The serve.stall_step wedge in both packages: each watchdog trips
    once naming the stuck step (the same step, snapshot and message),
    dumps its report to the recorder given, and restart() resumes from
    the periodic snapshot; the finished tokens are the unstalled JAX
    run's bit for bit, and serve_record stamps the counters."""
    out = {}
    for name, eng, mod, dog_cls, err in (
            ("jax",) + (_engines(jax_params, params)[0], jchaos,
                        JEngineWatchdog, JEngineStalledError),
            ("port",) + (_engines(jax_params, params)[1], chaos,
                         EngineWatchdog, EngineStalledError)):
        for p, b in zip(_PROMPTS[:5], _BUDGETS[:5]):
            eng.submit(p, b)
        clock = [100.0]
        rec = _Recorder()
        dog = dog_cls(eng, stall_timeout_s=0.05, recorder=rec,
                      snapshot_every=1, clock=lambda c=clock: c[0])
        mod.arm("serve.stall_step", 3)
        eng, fins, tripped = _stall_and_restart(mod, err, eng, dog, clock)
        out[name] = (eng, fins, tripped, dog, rec)
    (jeng, jfins, jerr, jdog, jrec), (eng, fins, err, dog, rec) = (
        out["jax"], out["port"])
    assert err is not None and err.step is not None
    assert "stalled" in str(err) and f"step {err.step}" in str(err)
    assert (err.step, err.snapshot_step, str(err)) == (
        jerr.step, jerr.snapshot_step, str(jerr))
    assert err.stalled_for_s == pytest.approx(jerr.stalled_for_s)
    assert rec.reasons == jrec.reasons == [f"engine watchdog: {err}"]
    assert dog.stalls == dog.restarts == 1 == jdog.stalls == jdog.restarts
    assert all(f.status == "ok" for f in fins.values())
    assert {r: f.tokens for r, f in fins.items()} == \
        {r: f.tokens for r, f in jfins.items()}
    _assert_clean(eng, fins, ref_tokens)
    assert eng.recompile_ok
    rec_p, rec_j = eng.serve_record(), jeng.serve_record()
    for key in ("serve_watchdog_stalls", "serve_watchdog_restarts"):
        assert rec_p[key] == rec_j[key] == 1
    assert eng.watchdog is dog and eng.device.type == "cpu"


def test_watchdog_idle_engine_never_trips(jax_params, params):
    """No pending work is not a stall: the clock re-arms while idle and
    after a submission the timeout is judged fresh, in both packages."""
    for eng, dog_cls, err in (
            (_engines(jax_params, params)[0], JEngineWatchdog,
             JEngineStalledError),
            (_engines(jax_params, params)[1], EngineWatchdog,
             EngineStalledError)):
        t = [0.0]
        dog = dog_cls(eng, stall_timeout_s=1.0, clock=lambda: t[0])
        t[0] = 50.0
        dog.check()                                # idle: no trip
        eng.submit([1, 2], 2)
        t[0] = 50.5
        dog.check()                                # within timeout: fine
        t[0] = 52.0
        with pytest.raises(err) as e:
            dog.check()
        assert e.value.step == 0 and e.value.snapshot_step is None
        assert "NO SNAPSHOT" in str(e.value) and dog.stalls == 1


def test_watchdog_refuses_what_jax_refuses(params):
    eng = DecodeEngine(_CFG, params, ServeConfig(**_SC), device="cpu")
    with pytest.raises(ValueError, match="stall_timeout_s"):
        EngineWatchdog(eng, stall_timeout_s=0.0)
    with pytest.raises(ValueError, match="snapshot_every"):
        EngineWatchdog(eng, snapshot_every=-1)
    with pytest.raises(ValueError, match="no snapshot"):
        EngineWatchdog(eng).restart()


def test_snapshot_stays_known_good_through_poison(jax_params, params,
                                                  ref_tokens):
    """serve.poison_logits in both packages: a poisoned candidate never
    replaces the held snapshot, so one restart clears the corruption and
    the run finishes bit for bit."""
    for eng, mod, dog_cls, poison in (
            (_engines(jax_params, params)[0], jchaos, JEngineWatchdog,
             JPoisonedOutputError),
            (_engines(jax_params, params)[1], chaos, EngineWatchdog,
             PoisonedOutputError)):
        for p, b in zip(_PROMPTS[:4], _BUDGETS[:4]):
            eng.submit(p, b)
        dog = dog_cls(eng, stall_timeout_s=30.0, snapshot_every=1,
                      clock=lambda: 0.0)
        mod.arm("serve.poison_logits", 2)
        fins, caught, steps, restarts = {}, None, 0, 0
        while eng.pending:
            assert steps < 400
            try:
                eng.step()
            except poison as e:
                caught = e
                restarts += 1
                assert restarts < 3, "snapshot was not known-good"
                eng = dog.restart()
                continue
            for f in eng.poll():
                fins[f.request_id] = f
            dog.check()
            steps += 1
        eng._retire_finished()
        for f in eng.poll():
            fins[f.request_id] = f
        assert caught is not None and caught.slot is not None
        assert all(f.status == "ok" for f in fins.values())
        _assert_clean(eng, fins, ref_tokens)


def test_overload_storm_4x_mixed_deadlines(jax_params, params, ref_tokens):
    """The JAX test's storm in both engines side by side: 4x slot
    capacity against a queue of 4 under shed-lowest-deadline, half the
    workload with a finite deadline.  The same requests are shed (only
    deadline-carrying ones) and expired, every request that ends ok has
    the same tokens in both (the unloaded run's), and both gates hold."""
    out = {}
    for name, eng in zip(("jax", "port"), _engines(
            jax_params, params, max_queue_depth=4,
            shed_policy="shed-lowest-deadline")):
        rids, deadline_rids = [], []
        for i, (p, b) in enumerate(zip(_PROMPTS, _BUDGETS)):
            dl = 120_000.0 if i % 2 else None
            rids.append(eng.submit(p, b, deadline_ms=dl))
            if dl is not None:
                deadline_rids.append(rids[-1])
        extra = [eng.submit([9, 9 + i], 3, deadline_ms=120_000.0)
                 for i in range(5)]
        led = eng.telemetry.ledger
        assert led.n_shed > 0, "4x storm shed nothing"
        shed = {f.request_id for f in eng.poll() if f.status == "shed"}
        assert shed and shed <= set(deadline_rids) | set(extra)
        fins, steps = {}, 0
        while eng.pending:
            assert steps < 400
            eng.step()
            for f in eng.poll():
                fins[f.request_id] = f
            steps += 1
        eng._retire_finished()
        for f in eng.poll():
            fins[f.request_id] = f
        assert all(f.status in ("ok", "shed") for f in fins.values())
        _assert_clean(eng, fins, ref_tokens)
        assert eng.recompile_ok
        bal = led.balance()
        assert bal["ok"] and bal["n_shed"] == len(shed)
        out[name] = (shed, {r: (f.status, f.tokens) for r, f in fins.items()},
                     (led.n_retired, led.n_shed, led.n_expired), steps)
    assert out["port"] == out["jax"]
