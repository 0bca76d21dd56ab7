"""The port's fleet fault tolerance (apex_tpu_torch.checkpoint:
multihost, manager in multi-host mode, chaos, orchestrator, legacy)
against the JAX package's, on the CPU.

Each case of tests/test_fleet.py (the multi-host merge, the barrier's
refusals, the stale sub-manifest race, the attempt token, the manager's
host split; the orchestrator's recovery, escalation and transient
paths) runs through both packages' modules and must give the same
outcome: the same steps committed, the same errors with the same
messages, the same events.  The watchdogs are fed one timing matrix
sequence, each through its own JAX `StragglerDetector` (numpy only),
and must raise at the same step for the same rank; `resume_guard` must
give a stub recorder the JAX reason.  The legacy pickle round-trips
across the packages, the port's serve engine resumes mid-generation
through it, and the port's `validate_manifest` accepts the committed
probe fixtures.  No module of the port imports jax, orbax or the JAX
package."""

import ast
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from apex_tpu import checkpoint as JC
from apex_tpu.checkpoint import chaos as jchaos
from apex_tpu.checkpoint import multihost as JMH
from apex_tpu.checkpoint import sharded as JS
from apex_tpu.monitor.trace.straggler import StragglerDetector
from apex_tpu_torch import checkpoint as PC
from apex_tpu_torch.checkpoint import chaos as pchaos
from apex_tpu_torch.checkpoint import multihost as PMH
from apex_tpu_torch.checkpoint import sharded as PS

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKGS = {"jax": (JS, JMH, jchaos, JC), "port": (PS, PMH, pchaos, PC)}

LAYOUT4 = {"align": 1, "total": 16, "n_tensors": 2, "num_shards": 4,
           "n_buckets": 1, "bucket_totals": [16], "bucket_padded": [16],
           "master_dtype": "float32"}
FLAT = np.arange(16, dtype=np.float32)
SHARDS = {r: FLAT[r * 4:(r + 1) * 4] for r in range(4)}


def _outcome(fn):
    """(exception type name, message) of a call, or ("ok", its value)."""
    try:
        return ("ok", fn())
    except Exception as e:  # the outcome under comparison
        return (type(e).__name__, str(e))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(case, tmp_path):
    """The case's record through the port equals its record through the
    JAX package (each in a directory of its own, spelled "<d>")."""
    rec = {}
    for pkg in ("port", "jax"):
        root = tmp_path / pkg
        root.mkdir()
        rec[pkg] = json.loads(json.dumps(case(pkg, str(root)),
                                         default=str).replace(str(root),
                                                              "<d>"))
    assert rec["port"] == rec["jax"]
    return rec["port"]


def _commit_two_hosts(S, MH, tmp, step, attempt=0):
    MH.save_sharded_multihost(
        tmp, step,
        {"params_shard": ("sharded", {2: SHARDS[2], 3: SHARDS[3]})},
        process_id=1, num_processes=2, attempt=attempt,
        flat_layout=LAYOUT4)
    return MH.save_sharded_multihost(
        tmp, step,
        {"params_shard": ("sharded", {0: SHARDS[0], 1: SHARDS[1]}),
         "count": ("replicated", np.asarray(step, np.int64))},
        process_id=0, num_processes=2, attempt=attempt,
        flat_layout=LAYOUT4, timeout_s=10.0)


def _merge_case(pkg, tmp):
    S, MH, chaos, C = PKGS[pkg]
    out = []
    d, barrier_s = _commit_two_hosts(S, MH, tmp, 4)
    out.append(barrier_s >= 0)
    m = S.read_manifest(d)
    out.append({k: v for k, v in m.items() if k != "created_unix"})
    host = S.load_field_host(d, m, "params_shard")
    out.append(_np(S.canonical_flat(host, LAYOUT4)).tolist())
    # the stale race: host 1 raced ahead into step 5
    MH.save_sharded_multihost(
        tmp, 5, {"params_shard": ("sharded", {2: SHARDS[2], 3: SHARDS[3]})},
        process_id=1, num_processes=2, flat_layout=LAYOUT4)
    out.append(C.latest_committed_step(tmp))
    S.prune(tmp, keep=1)
    out.append(os.path.exists(MH.submanifest_path(S.step_dir(tmp, 5), 1)))
    out.append(_outcome(lambda: _commit_two_hosts(S, MH, tmp, 4)))
    # the barrier: a missing host, a stale attempt, a torn file
    d7 = S.step_dir(tmp, 7)
    sub = MH.write_host_shards(
        d7, 7, {"params_shard": ("sharded", {0: SHARDS[0]})}, host=0,
        num_processes=2)
    MH.publish_submanifest(d7, sub)
    out.append(_outcome(lambda: MH.gather_submanifests(
        d7, 2, step=7, timeout_s=0.1, poll_s=0.02))[1].split(
            " timed out")[0])
    for kw in ({"attempt": 1}, {}):
        if not kw:
            fn = sub["fields"]["params_shard"]["files"][0]["file"]
            with open(os.path.join(d7, fn), "r+b") as f:
                f.write(b"\xff\xff")
        e = _outcome(lambda: MH.gather_submanifests(
            d7, 1, step=7, timeout_s=0.1, poll_s=0.02, **kw))
        out.append((e[0], e[1].split("unready hosts: ")[-1]))
    # merge coverage: overlap, gap, unknown count, non-rank-0 replicated
    dup = MH.write_host_shards(
        S.step_dir(tmp, 9), 9,
        {"params_shard": ("sharded", {0: SHARDS[0], 1: SHARDS[1],
                                      2: SHARDS[2]})},
        host=1, num_processes=2)
    sub0 = dict(sub, step=9)
    for subs, kw in (([sub0, dup], {"num_shards": 4}),
                     ([sub0], {"num_shards": 4}), ([sub0], {})):
        out.append(_outcome(lambda: MH.merge_submanifests(subs, step=9,
                                                          **kw)))
    out.append(_outcome(lambda: MH.write_host_shards(
        S.step_dir(tmp, 10), 1, {"c": ("replicated", np.zeros(2))},
        host=1, num_processes=2)))
    return out


def test_multihost_protocol_gives_the_jax_outcome(tmp_path):
    """The two-host commit, its merged manifest, the stale step-5 race
    and prune, the refused overwrite, the barrier's refusals and the
    merge's coverage checks, through both packages."""
    rec = _same(_merge_case, tmp_path)
    assert rec[0] is True and rec[3] == 4 and rec[4] is True
    assert rec[5][0] == "CheckpointError"
    assert "multihost" in rec[1]


class _Stub:
    """A 4-shard flat optimizer without device work: its state holds the
    global buffer, which the manager splits per host."""
    num_shards = 4
    axis_name = "dp"

    def __init__(self, pkg):
        self.pkg = pkg

    def state_partition_specs(self):
        if self.pkg == "jax":
            from jax.sharding import PartitionSpec as P
            return {"params_shard": P("dp"), "count": P()}
        return {"params_shard": ("dp",), "count": ()}

    def shard_layout(self):
        return dict(LAYOUT4)


def _manager_case(pkg, tmp):
    S, MH, chaos, C = PKGS[pkg]
    out = []
    state = {"params_shard": FLAT.copy(), "count": np.asarray(3, np.int64)}

    def mgr(pid, **kw):
        kw.setdefault("barrier_timeout_s", 10.0)
        return C.CheckpointManager(tmp, _Stub(pkg), every_n_steps=1,
                                   process_id=pid, num_processes=2,
                                   async_write=False, **kw)

    m1 = mgr(1)
    m1.save(3, state)
    out.append(C.latest_committed_step(tmp))
    out.append("ckpt_commit_barrier_s" in m1.stats())
    m0 = mgr(0)
    m0.save(3, state, model_state={"rng_key": np.asarray([9], np.uint32)})
    out.append(C.latest_committed_step(tmp))
    out.append(sorted(k for k in m0.stats()))
    m = S.read_manifest(S.step_dir(tmp, 3))
    out.append(sorted(f["file"] for e in m["fields"].values()
                      for f in e["files"]))
    out.append(_np(m0.restore_model_state(3)["rng_key"]).tolist())
    # an optimizer without a group gets the global buffers back, and no
    # model.* field
    kw = {} if pkg == "jax" else {"device": "cpu"}
    restored, _, _ = C.restore_sharded(tmp, _Stub(pkg), **kw)
    out.append({k: _np(v).tolist() for k, v in sorted(restored.items())})
    # a refused barrier surfaces once and leaves the next save alone
    m0.barrier_timeout_s = 0.2
    out.append(_outcome(lambda: m0.save(4, state))[0])
    mgr(1).save(8, state)
    m0.barrier_timeout_s = 10.0
    m0.save(8, state)
    out.append(C.latest_committed_step(tmp))
    # a retry at attempt 1 refuses host 1's attempt-0 sub-manifest
    mgr(1, attempt=0).save(6, state)
    e = _outcome(lambda: mgr(0, attempt=1, barrier_timeout_s=0.2).save(
        6, state))
    out.append((e[0], e[1].split("unready hosts: ")[-1]))
    return out


def test_manager_multihost_mode_gives_the_jax_outcome(tmp_path):
    """CheckpointManager with explicit process ids: each host writes its
    local ranks, process 0 the replicated fields and the commit, the
    barrier's wait is stamped; a refused commit and a stale attempt
    token end the same way in both packages."""
    rec = _same(_manager_case, tmp_path)
    assert rec[:3] == [None, False, 3]
    assert "ckpt_commit_barrier_s" in rec[3]
    assert rec[6]["params_shard"] == FLAT.tolist()
    assert rec[7] == "MultihostCommitError" and rec[8] == 8


def _orchestrator_case(pkg, tmp):
    S, MH, chaos, C = PKGS[pkg]
    out = []
    S.save_sharded(tmp, 4, {"params_shard": (
        "sharded", list(np.split(FLAT, 4))),
        "count": ("replicated", np.asarray(4, np.int64))},
        flat_layout=LAYOUT4)
    dumps, resets, calls = [], [], []

    class Recorder:
        def dump(self, reason, oom=False):
            dumps.append((reason, oom))

    class WD:
        def reset(self):
            resets.append(True)

    def build(dp, resume_step, attempt):
        calls.append((dp, resume_step, attempt))

        def session():
            if dp == 4:
                raise chaos.RankLostError("rank 3 lost", rank=3,
                                          last_committed=4)
            return f"done@dp{dp}"
        return session

    orch = C.ElasticOrchestrator(tmp, build, initial_dp=4,
                                 choose_dp=lambda dp, e: 2,
                                 recorder=Recorder(), watchdog=WD())
    out += [orch.run(), calls, orch.stats(), resets, dumps, orch.events]

    def doomed(dp, resume_step, attempt):
        def session():
            raise chaos.RankLostError("rank 1 lost", rank=1)
        return session

    empty = os.path.join(tmp, "empty")
    os.makedirs(empty)
    out.append(_outcome(C.ElasticOrchestrator(empty, doomed,
                                              initial_dp=2).run))
    out.append(_outcome(C.ElasticOrchestrator(tmp, doomed, initial_dp=4,
                                              max_resumes=0).run))
    out.append(_outcome(C.ElasticOrchestrator(tmp, doomed, initial_dp=2,
                                              min_dp=2).run))
    sleeps = []

    def flaky(dp, resume_step, attempt):
        raise ConnectionError("coordinator not up yet")

    out.append(_outcome(C.ElasticOrchestrator(
        tmp, flaky, initial_dp=2,
        retry=C.RetryPolicy(attempts=3, backoff_s=0.01),
        sleep=sleeps.append).run))
    out.append(sleeps)

    def broken(dp, resume_step, attempt):
        raise ValueError("bad config")

    out.append(_outcome(C.ElasticOrchestrator(tmp, broken,
                                              initial_dp=2).run))
    tries = []

    def once_flaky(dp, resume_step, attempt):
        tries.append(dp)
        if len(tries) == 1:
            raise ConnectionError("transient")
        return lambda: "ok"

    orch = C.ElasticOrchestrator(tmp, once_flaky, initial_dp=2,
                                 retry=C.RetryPolicy(backoff_s=0.0),
                                 sleep=lambda s: None)
    out += [orch.run(), tries, orch.stats(), orch.events]
    return out


def test_orchestrator_gives_the_jax_outcome(tmp_path):
    """The recovery cycle (dump, rebuild at dp 2, resume), the
    escalations (nothing committed, budget spent, below min_dp, a build
    failing past the retry policy with its backoff), a non-transient
    build error, and one transient failure then recovery."""
    rec = _same(_orchestrator_case, tmp_path)
    assert rec[0] == "done@dp2" and rec[2] == {"fleet_resumes": 1,
                                               "fleet_dp": 2}
    assert "last committed checkpoint: step 4" in rec[4][0][0]
    assert [r[0] for r in rec[6:10]] == ["EscalationError"] * 4
    assert rec[10] == [0.01, 0.02] and rec[11][0] == "ValueError"


def _timings(dp, slow=None, skew=3.0):
    t = np.full((dp, 1), 0.1)
    if slow is not None:
        t[slow, 0] = 0.1 * skew
    return t


def test_watchdogs_raise_at_the_same_step_and_rank():
    """One sequence of timing matrices (a flap, a recovery, a stale
    re-check, a rank-count change after reset) through each package's
    LostRankWatchdog, each over its own JAX StragglerDetector: the same
    summaries, and the same RankLostError at the same step."""
    seq = ([_timings(4, 2)] * 3 + [_timings(4), None, None]
           + [_timings(4, 2)] * 4 + ["reset", _timings(3)]
           + [_timings(3, 1)] * 4)

    def run(chaos):
        class Mgr:
            last_committed_step = 6

        wd = chaos.LostRankWatchdog(StragglerDetector(threshold=1.5,
                                                      patience=1),
                                    manager=Mgr(), deadline=4)
        rec = []
        for i, t in enumerate(seq):
            if isinstance(t, str):
                wd.reset()
                continue
            try:
                last = wd.check(t)
                rec.append((i, None if last is None else
                            [f["consecutive"] for f in last["flagged"]]))
            except chaos.RankLostError as e:
                rec.append((i, str(e), e.rank, e.last_committed))
        return rec

    got, want = run(pchaos), run(jchaos)
    assert got == want
    raised = [r for r in got if len(r) == 4]
    assert [(r[0], r[2], r[3]) for r in raised] == [(9, 2, 6), (15, 1, 6)]


def test_resume_guard_reason_matches_jax(tmp_path):
    """Inside resume_guard any exception dumps once, with the JAX
    reason naming the last committed step (or none) and the OOM flag,
    and propagates."""
    S = PS
    S.save_sharded(str(tmp_path), 5, {"c": ("replicated", np.zeros(2))})
    errors = [RuntimeError("boom"), MemoryError("RESOURCE_EXHAUSTED: x"),
              pchaos.SimulatedPreemption("at ckpt.mid_shards")]

    def run(chaos, C, directory):
        dumps = []

        class Recorder:
            def dump(self, reason, oom=False):
                dumps.append((reason, oom))

        mgr = C.CheckpointManager(directory)
        for e in errors + [None]:
            with pytest.raises(ValueError if e is None else type(e)):
                with chaos.resume_guard(Recorder(),
                                        mgr if e is not None else None):
                    raise e or ValueError("no manager")
        return dumps

    got = run(pchaos, PC, str(tmp_path))
    assert got == run(jchaos, JC, str(tmp_path))
    assert [o for _, o in got] == [False, True, False, False]
    assert "last committed checkpoint: step 5" in got[0][0]
    assert "NONE COMMITTED" in got[3][0]
    from apex_tpu_torch.monitor.compile import watermarks as wm
    assert wm.is_oom(torch.OutOfMemoryError("CUDA out of memory"))
    assert not wm.is_oom(RuntimeError("BLOOM filter"))


def test_legacy_pickle_round_trips_across_packages(tmp_path):
    """A tree saved by either package's save_checkpoint loads in the
    other with the same values; `use_orbax=True` in the port warns and
    writes the pickle; an orbax-layout directory is refused by the port
    with the JAX package named; latest_step agrees."""
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "n": {"step": np.asarray(7, np.int32), "b": [1.5, None]}}
    with pytest.warns(UserWarning, match="pickle format"):
        PC.save_checkpoint(str(tmp_path / "p"), {
            "w": torch.from_numpy(tree["w"]),
            "n": {"step": torch.tensor(7, dtype=torch.int32),
                  "b": [1.5, None]}}, step=3)
    back = JC.load_checkpoint(str(tmp_path / "p"), step=3)
    np.testing.assert_array_equal(back["w"], tree["w"])
    assert back["n"]["step"] == 7 and back["n"]["b"] == [1.5, None]
    JC.save_checkpoint(str(tmp_path / "j"), tree, step=4, use_orbax=False)
    back = PC.load_checkpoint(str(tmp_path / "j"), step=4)
    np.testing.assert_array_equal(back["w"], tree["w"])
    assert PC.latest_step(str(tmp_path / "j")) == JC.latest_step(
        str(tmp_path / "j")) == 4
    os.makedirs(tmp_path / "o" / "step_1" / "state")
    with pytest.raises(PC.CheckpointError, match="JAX package"):
        PC.load_checkpoint(str(tmp_path / "o"), step=1)
    d = tmp_path / "pk"
    os.makedirs(d)
    import pickle
    raw = pickle.dumps({"w": np.arange(100.0)})
    (d / "state.pkl").write_bytes(raw[: len(raw) // 2])
    with pytest.raises(PC.CheckpointError, match="truncated or corrupt"):
        PC.load_checkpoint(str(d))


def test_serve_engine_preempt_resume_through_the_port(tmp_path):
    """The JAX test_serve_engine_preempt_resume_bitwise scenario in the
    port: the engine snapshotted mid-generation, saved with its weights
    through save_checkpoint, restored into a fresh engine through
    load_checkpoint, finishes with the unpreempted tokens."""
    from apex_tpu.models.gpt import GPT, GPTConfig
    from apex_tpu_torch.models import GPTConfig as TGPTConfig
    from apex_tpu_torch.models import params_from_jax
    from apex_tpu_torch.serve import DecodeEngine, ServeConfig

    cfg = TGPTConfig(vocab_size=64, seq_len=64, hidden=32, num_layers=2,
                     num_heads=4, dropout=0.0, dtype=torch.float32)
    sc = ServeConfig(n_slots=3, max_prompt_len=8, max_new_cap=8,
                     page_size=4)
    jp = GPT(GPTConfig(vocab_size=64, seq_len=64, hidden=32, num_layers=2,
                       num_heads=4, dropout=0.0)).init(jax.random.PRNGKey(7))
    jp["pos_embed"] = jp["pos_embed"] * 20.0
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    prompts, budgets = [[5, 9, 2, 17], [33, 1], [40, 41, 42]], [6, 8, 5]

    def engine(p):
        eng = DecodeEngine(cfg, p, sc, device="cpu")
        return eng

    eng1 = engine(params)
    for p, b in zip(prompts, budgets):
        eng1.submit(p, b)
    ref = {f.request_id: f.tokens for f in eng1.run()}
    assert any(len(set(t)) > 1 for t in ref.values())
    eng2 = engine(params)
    for p, b in zip(prompts, budgets):
        eng2.submit(p, b)
    eng2.step()
    eng2.step()
    PC.save_checkpoint(str(tmp_path), {"params": params,
                                       "engine": eng2.state_dict()},
                       step=2, use_orbax=False)
    half = {f.request_id: f.tokens for f in eng2.poll()}
    del eng2
    restored = PC.load_checkpoint(str(tmp_path), step=2)
    eng3 = engine(jax.tree_util.tree_map(
        torch.from_numpy, restored["params"]))
    eng3.load_state_dict(restored["engine"])
    finished = dict(half)
    finished.update({f.request_id: f.tokens for f in eng3.run()})
    assert finished == ref
    assert eng3.cache.free_pages == eng1.cache.free_pages


def test_probe_fixtures_validate_in_the_port():
    """The committed resume and fleet fixtures pass the port's
    validate_manifest, and the fleet fixture's sub-manifests merge to
    its global manifest's fields, as in the JAX package."""
    scripts = ROOT / "scripts"
    resume = json.loads((scripts / "resume_fixture.json").read_text())
    fleet = json.loads((scripts / "fleet_fixture.json").read_text())
    for m in (resume, fleet["global"]):
        PC.validate_manifest(m)
        JC.validate_manifest(m)
    merged = PMH.merge_submanifests(
        fleet["submanifests"], step=fleet["global"]["step"],
        flat_layout=fleet["global"]["flat_layout"],
        scaler=fleet["global"]["scaler"])
    assert merged["fields"] == fleet["global"]["fields"]
    with pytest.raises(PC.CheckpointError, match="ckpt_schema_version"):
        PC.validate_manifest(dict(resume, ckpt_schema_version=2))


def test_no_port_module_imports_jax_orbax_or_the_jax_package():
    """Import hygiene: no module under apex_tpu_torch/, and not
    chip_smoke.py, imports jax, orbax or apex_tpu (at any depth of the
    file: top level or inside a function)."""
    banned = {"jax", "jaxlib", "orbax", "apex_tpu"}
    files = sorted((ROOT / "apex_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in banned]
    assert len(files) > 50 and not bad, bad
