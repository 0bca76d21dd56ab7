"""The PyTorch port's serving failure semantics, on the CPU: deadlines,
cancellation, bounded-queue shedding, the ledger's terminal states,
poisoned-output detection, the stall fail point and graceful drain.
Survivors of every fault must decode bitwise what the JAX engine decodes
for them unloaded (the shared weights go through `params_from_jax`)."""

import time

import jax
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPT, GPTConfig
from apex_tpu.serve import DecodeEngine as JDecodeEngine
from apex_tpu.serve import ServeConfig as JServeConfig
from apex_tpu.serve import choose_shed_victim as jax_choose_shed_victim
from apex_tpu_torch.checkpoint import chaos
from apex_tpu_torch.models import GPTConfig as TGPTConfig
from apex_tpu_torch.models import params_from_jax
from apex_tpu_torch.serve import (DecodeEngine, PoisonedOutputError,
                                  ServeConfig, ServeSLO,
                                  choose_shed_victim)

_JCFG = GPTConfig(vocab_size=64, seq_len=64, hidden=32, num_layers=2,
                  num_heads=4, dropout=0.0)
_CFG = TGPTConfig(vocab_size=64, seq_len=64, hidden=32, num_layers=2,
                  num_heads=4, dropout=0.0, dtype=torch.float32)
_SC = ServeConfig(n_slots=3, max_prompt_len=8, max_new_cap=8, page_size=4)

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
    """The JAX engine's unloaded run: every surviving request of the
    port must match it bitwise."""
    eng = JDecodeEngine(_JCFG, jax_params, JServeConfig(
        n_slots=3, max_prompt_len=8, max_new_cap=8, page_size=4))
    for p, b in zip(_PROMPTS, _BUDGETS):
        eng.submit(p, b)
    return {f.request_id: f.tokens for f in eng.run()}


@pytest.fixture(autouse=True)
def _disarm():
    chaos.disarm_all()
    yield
    chaos.disarm_all()


def _engine(params, sc=_SC):
    return DecodeEngine(_CFG, params, sc, device="cpu")


def _drive(eng, max_steps=400):
    fins = {}
    steps = 0
    while eng.pending:
        assert steps < max_steps, "drive loop exceeded bound"
        eng.step()
        for f in eng.poll():
            fins[f.request_id] = f
        steps += 1
    eng._retire_finished()
    for f in eng.poll():
        fins[f.request_id] = f
    return fins


def _assert_clean(eng, fins, ref):
    for rid, f in fins.items():
        if f.status == "ok":
            assert f.tokens == ref[rid], f"request {rid} drifted"
    assert eng.cache.free_pages == eng.kv_config.usable_pages
    assert eng.telemetry.ledger.balance()["ok"], \
        eng.telemetry.ledger.balance()


def test_unloaded_run_equals_jax(params, ref_tokens):
    eng = _engine(params)
    for p, b in zip(_PROMPTS, _BUDGETS):
        eng.submit(p, b)
    fins = _drive(eng)
    assert {r: f.tokens for r, f in fins.items()} == ref_tokens
    _assert_clean(eng, fins, ref_tokens)


def test_deadline_expires_in_queue(params, ref_tokens):
    eng = _engine(params)
    rids = [eng.submit(p, b) for p, b in zip(_PROMPTS[:3], _BUDGETS[:3])]
    doomed = eng.submit([1, 2, 3], 4, deadline_ms=0.001)
    time.sleep(0.005)
    fins = _drive(eng)
    assert fins[doomed].status == "expired" and fins[doomed].tokens == []
    led = eng.telemetry.ledger
    assert led.n_expired_queue == 1 and led.n_expired_live == 0
    rec = {r.request_id: r for r in led.tail}[doomed]
    assert rec.where == "queue" and rec.admit_t is None
    assert led.ttft.n == 3 and led.queue_wait.n == 3
    assert all(fins[r].status == "ok" for r in rids)
    _assert_clean(eng, fins, ref_tokens)


def test_deadline_evicts_live_slot(params, ref_tokens):
    eng = _engine(params)
    doomed = eng.submit(_PROMPTS[0], _BUDGETS[0], deadline_ms=25.0)
    other = eng.submit(_PROMPTS[1], _BUDGETS[1])
    eng.step()
    assert any(r.rid == doomed for r in eng._live.values())
    pages_live = eng.cache.free_pages
    time.sleep(0.05)
    fins = _drive(eng)
    assert fins[doomed].status == "expired"
    assert eng.telemetry.ledger.n_expired_live == 1
    assert fins[other].status == "ok"
    assert fins[other].tokens == ref_tokens[other]
    assert eng.cache.free_pages > pages_live
    _assert_clean(eng, fins, ref_tokens)


@pytest.mark.parametrize("bad", [
    dict(deadline_ms=0.0), dict(deadline_ms=-5.0), dict(max_new_tokens=0),
    dict(max_new_tokens=9), dict(prompt=[]), dict(prompt=[1] * 9),
    dict(prompt=[64]), dict(prompt=[-1])])
def test_submit_validates(params, bad):
    eng = _engine(params)
    kw = dict(prompt=[1, 2], max_new_tokens=4)
    kw.update(bad)
    with pytest.raises(ValueError):
        eng.submit(kw.pop("prompt"), **kw)
    assert eng.pending == 0


def test_cancel_in_queue_and_mid_generation(params, ref_tokens):
    eng = _engine(params)
    rids = [eng.submit(p, b) for p, b in zip(_PROMPTS, _BUDGETS)]
    assert eng.cancel(rids[4])                  # still queued
    eng.step()
    live_rid = next(iter(eng._live.values())).rid
    assert eng.cancel(live_rid)                 # mid-generation
    assert not eng.cancel(live_rid)             # double-cancel: no-op
    assert not eng.cancel(10_000)               # unknown id
    fins = _drive(eng)
    assert fins[rids[4]].status == "cancelled" and fins[rids[4]].tokens == []
    assert fins[live_rid].status == "cancelled"
    led = eng.telemetry.ledger
    assert led.n_cancelled_queue == 1 and led.n_cancelled_live == 1
    assert eng.recompile_ok
    _assert_clean(eng, fins, ref_tokens)


def test_bounded_queue_sheds_newest(params, ref_tokens):
    sc = ServeConfig(n_slots=3, max_prompt_len=8, max_new_cap=8,
                     page_size=4, max_queue_depth=2)
    eng = _engine(params, sc)
    kept = [eng.submit(_PROMPTS[0], _BUDGETS[0]),
            eng.submit(_PROMPTS[1], _BUDGETS[1])]
    assert eng.last_shed_rid is None
    assert eng.gauges()["queue_saturation"] == 1.0 and eng.overloaded
    shed = eng.submit(_PROMPTS[2], _BUDGETS[2])
    assert eng.last_shed_rid == shed
    fins = {f.request_id: f for f in eng.poll()}
    assert fins[shed].status == "shed" and fins[shed].tokens == []
    fins.update(_drive(eng))
    assert all(fins[r].status == "ok" for r in kept)
    _assert_clean(eng, fins, ref_tokens)


def test_shed_policy_ordering_matches_jax(params):
    class _C:
        def __init__(self, rid, deadline_t):
            self.rid, self.deadline_t = rid, deadline_t

    cands = [_C(0, 9.0), _C(1, 2.5), _C(2, None), _C(3, 7.0)]
    for policy in ("shed-lowest-deadline", "shed-newest"):
        assert (choose_shed_victim(cands, policy).rid
                == jax_choose_shed_victim(cands, policy).rid)
    assert choose_shed_victim([_C(0, None), _C(1, None)],
                              "shed-lowest-deadline").rid == 1
    with pytest.raises(ValueError, match="shed policy"):
        choose_shed_victim(cands, "shed-oldest")
    sc = ServeConfig(n_slots=3, max_prompt_len=8, max_new_cap=8,
                     page_size=4, max_queue_depth=3,
                     shed_policy="shed-lowest-deadline")
    eng = _engine(params, sc)
    r_far = eng.submit([1, 2], 4, deadline_ms=90_000.0)
    r_soon = eng.submit([3, 4], 4, deadline_ms=10_000.0)
    r_none = eng.submit([5, 6], 4)
    r_in = eng.submit([7, 8], 4, deadline_ms=50_000.0)
    assert eng.last_shed_rid == r_soon
    assert {f.request_id: f.status for f in eng.poll()} == {r_soon: "shed"}
    assert {r.rid for r in eng._pending} == {r_far, r_none, r_in}


def test_slo_projection_sheds_before_breach(params):
    eng = _engine(params)
    eng.slo = ServeSLO(max_queue_wait_ms=100.0)
    assert eng.projected_queue_wait_s() is None
    eng.submit([1, 2], 4)
    for _ in range(4):
        eng.telemetry.ledger.service.add(0.2)
    eng.submit([3, 4], 4)             # depth 1 → 66.7 ms < 100 ms
    assert eng.last_shed_rid is None
    r2 = eng.submit([5, 6], 4)        # depth 2 → 133 ms > 100 ms: shed
    assert eng.last_shed_rid == r2 and eng.overloaded


def test_terminal_states_reconcile_against_step_sums(params):
    eng = _engine(params)
    rids = [eng.submit(p, b, deadline_ms=(30.0 if i == 5 else None))
            for i, (p, b) in enumerate(zip(_PROMPTS, _BUDGETS))]
    eng.cancel(rids[6])
    admitted, retired = eng.step()
    eng.cancel(next(iter(eng._live.values())).rid)
    time.sleep(0.05)
    steps = 0
    while eng.pending:
        a, r = eng.step()
        admitted += a
        retired += r
        eng.poll()
        steps += 1
        assert steps < 400
    retired += eng._retire_finished()
    led = eng.telemetry.ledger
    assert (led.n_retired + led.n_cancelled_live + led.n_expired_live
            == retired)
    assert led.n_admitted == admitted
    assert led.n_open == 0 and led.balance()["ok"]


def test_poison_detected_and_snapshot_restart(params, ref_tokens):
    """serve.poison_logits: garbage token ids are refused by name at the
    retire poll with the engine untouched; a restart from the last
    snapshot finishes every request bitwise."""
    eng = _engine(params)
    for p, b in zip(_PROMPTS[:4], _BUDGETS[:4]):
        eng.submit(p, b)
    eng.step()
    snap = eng.state_dict()
    chaos.arm("serve.poison_logits", 1)
    with pytest.raises(PoisonedOutputError) as err:
        _drive(eng)
    assert err.value.slot is not None
    assert "token ids outside" in str(err.value)
    fresh = _engine(params)
    fresh.load_state_dict(snap)
    fins = {f.request_id: f for f in eng.poll()}
    fins.update(_drive(fresh))
    assert sorted(fins) == [0, 1, 2, 3]
    assert all(f.status == "ok" for f in fins.values())
    _assert_clean(fresh, fins, ref_tokens)


def test_stall_point_wedges_without_progress(params):
    eng = _engine(params)
    eng.submit([1, 2], 4)
    eng.step()
    before = eng.steps_completed
    chaos.arm("serve.stall_step", 1)
    assert eng.step() == (0, 0) and eng.stalled
    assert eng.step() == (0, 0)
    assert eng.steps_completed == before and eng.stats()["stalled"]


def test_drain_finishes_live_snapshots_queue(params, ref_tokens):
    eng = _engine(params)
    for p, b in zip(_PROMPTS[:5], _BUDGETS[:5]):
        eng.submit(p, b)
    eng.step()
    n_queued = len(eng._pending)
    assert n_queued > 0
    snap = eng.drain()
    assert not eng.draining and len(eng._live) == 0
    assert len(snap["scheduler"]["pending"]) == n_queued
    fins = {f.request_id: f for f in eng.poll()}
    eng2 = _engine(params)
    eng2.load_state_dict(snap)
    fins.update(_drive(eng2))
    assert set(fins) == set(range(5))
    assert all(f.status == "ok" for f in fins.values())
    _assert_clean(eng2, fins, ref_tokens)

    eng3 = _engine(params)
    for p, b in zip(_PROMPTS[:5], _BUDGETS[:5]):
        eng3.submit(p, b)
    eng3.step()
    chaos.arm("serve.kill_mid_drain", 2)
    with pytest.raises(chaos.SimulatedPreemption):
        eng3.drain()
    assert not eng3.draining
    snap3 = eng3.state_dict()
    fins3 = {f.request_id: f for f in eng3.poll()}
    eng4 = _engine(params)
    eng4.load_state_dict(snap3)
    fins3.update(_drive(eng4))
    assert all(f.status == "ok" for f in fins3.values())
    _assert_clean(eng4, fins3, ref_tokens)


def test_snapshot_refuses_other_deployments(params):
    eng = _engine(params)
    snap = eng.state_dict()
    other = _engine(params, ServeConfig(n_slots=2, max_prompt_len=8,
                                        max_new_cap=8, page_size=4))
    with pytest.raises(ValueError, match="n_slots"):
        other.load_state_dict(snap)
    with pytest.raises(ValueError, match="serve_state_version"):
        eng.load_state_dict(dict(snap, serve_state_version=1))
    assert snap["deployment"]["cache_dtype"] == "float32"


def test_fail_points_match_jax_names():
    from apex_tpu.checkpoint import chaos as jchaos

    assert chaos.POINTS == jchaos.POINTS
    assert chaos.SERVE_POINTS == jchaos.SERVE_POINTS
    with pytest.raises(ValueError, match="unknown fail point"):
        chaos.arm("serve.nope")
    armed = chaos.arm_from_env({"APEX_TPU_CHAOS":
                                "serve.stall_step:2,ckpt.mid_shards"})
    assert armed == [("serve.stall_step", 2), ("ckpt.mid_shards", 1)]
    assert not chaos.fire("serve.stall_step")
    assert chaos.fire("serve.stall_step")
    with pytest.raises(chaos.SimulatedPreemption):
        chaos.check("ckpt.mid_shards")
    assert chaos.arm_from_env({"APEX_TPU_CHAOS": "serve.stall_step",
                               "APEX_TPU_CHAOS_PROC": "1",
                               "APEX_TPU_PROCESS_ID": "0"}) == []
    with pytest.raises(chaos.SimulatedPreemption):
        with chaos.preempt_at("serve.kill_mid_drain"):
            chaos.check("serve.kill_mid_drain")
    chaos.check("serve.kill_mid_drain")         # disarmed on exit
