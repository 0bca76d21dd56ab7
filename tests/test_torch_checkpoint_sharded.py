"""The port's shard-native checkpoints (apex_tpu_torch.checkpoint:
sharded, manager, chaos, legacy) against the JAX package's, on the CPU.

A ZeRO-2 state of a tiny GPT (`DistributedFusedAdam(n_buckets=2)`,
after one step) moves between the packages bit for bit: the JAX
`CheckpointManager` saves it at dp = 4 on its CPU mesh; the port
restores it at dp = 1 (this process) and at dp = 2 (one 2-rank gloo
world, `tests/torch_dist_worker.py` scenario `ckpt`), saves the restored
state again (its shard files byte-identical to the JAX package's dp = 2
save of the same state, its manifest equal apart from `created_unix` and
`tuner_fingerprint`), takes a step and saves that, which the JAX package
restores at dp = 1, 2 and 4.  Every comparison is exact: a restore moves
bytes, never arithmetic.  The kill-mid-save, crc-fallback,
interrupted-swap, staged-overwrite and corruption cases of
tests/test_checkpoint.py run through both packages' modules, which must
give the same outcome."""

import json
import os
import shutil
import sys
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu import checkpoint as JC
from apex_tpu.checkpoint import chaos as jchaos
from apex_tpu.checkpoint import sharded as JS
from apex_tpu.models.gpt import GPT as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.optimizers.distributed_fused_adam import (
    DistributedFusedAdam as JaxDFA)
from apex_tpu.optimizers.fused_adam import FusedAdam as JaxFusedAdam
from apex_tpu.parallel import mesh as JM
from apex_tpu_torch import checkpoint as PC
from apex_tpu_torch.checkpoint import chaos as pchaos
from apex_tpu_torch.checkpoint import sharded as PS
from apex_tpu_torch.optimizers import DistributedFusedAdam, FusedAdam

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

CFG = dict(vocab_size=64, seq_len=16, hidden=32, num_layers=2, num_heads=4,
           dropout=0.0)
JAX_STEP = 3
# the manifest keys that differ between two saves of one state
VOLATILE = ("created_unix", "tuner_fingerprint")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params():
    return _np_tree(JaxGPT(JaxGPTConfig(**CFG)).init(jax.random.PRNGKey(3)))


def _grads(seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 1e-2).astype(np.float32),
        _params())


def _jax_zero(dp, params, master_dtype=jnp.float32):
    JM.destroy_model_parallel()
    mesh = JM.initialize_model_parallel(devices=jax.devices()[:dp])
    opt = JaxDFA(num_shards=dp, lr=1e-3, n_buckets=2,
                 master_dtype=master_dtype, use_pallas=False)
    state = jax.jit(shard_map(
        opt.init, mesh=mesh, in_specs=(P(),),
        out_specs=opt.state_partition_specs(), check_vma=False))(params)
    return mesh, opt, state


def _jax_step(mesh, opt, state, grads):
    return jax.jit(shard_map(
        lambda s, g: opt.step(s, g)[1], mesh=mesh,
        in_specs=(opt.state_partition_specs(), P()),
        out_specs=opt.state_partition_specs(), check_vma=False))(
            state, grads)


def _jax_restore(directory, dp, params):
    """The JAX package's restore at dp: (canonical flats by field, step,
    state)."""
    mesh, opt, _ = _jax_zero(dp, params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # a tuner-fingerprint mismatch
        state, _, _ = JC.CheckpointManager(directory, opt).restore(mesh)
    lay = opt.shard_layout()
    canon = {f: JS.canonical_flat(list(np.split(np.asarray(
        getattr(state, f)), dp)), lay) for f in state._fields
        if f != "step"}
    return canon, int(np.asarray(state.step)), state


def _port_canonical(shards_by_rank, layout):
    """{field: canonical flat} from each rank's {field: shard}."""
    return {f: PS.canonical_flat([torch.from_numpy(s[f])
                                  for s in shards_by_rank], layout).numpy()
            for f in shards_by_rank[0] if f != "step"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX dp = 4 save and the JAX dp = 2 save of the same state,
    then the port's 2-rank world over them."""
    root = tmp_path_factory.mktemp("ckpt")
    params = _params()
    mesh, opt, state = _jax_zero(4, params)
    state = _jax_step(mesh, opt, state, _grads(0))
    jax_dir, jax_dir2 = str(root / "jax4"), str(root / "jax2")
    mgr = JC.CheckpointManager(jax_dir, opt, every_n_steps=1)
    mgr.save(JAX_STEP, state)
    mgr.wait()
    # the same state saved by the JAX package at dp = 2
    mesh2, opt2, _ = _jax_zero(2, params)
    state2, _, _ = JC.CheckpointManager(jax_dir, opt2).restore(mesh2)
    mgr2 = JC.CheckpointManager(jax_dir2, opt2, every_n_steps=1)
    mgr2.save(JAX_STEP, state2)
    mgr2.wait()
    JM.destroy_model_parallel()
    d = {"params": params, "jax_dir": jax_dir, "grads": _grads(1),
         "same_dir": str(root / "port2"), "next_dir": str(root / "port2n")}
    outs = W.run_ranks(str(root), 2, {"scenarios": ["ckpt"], "ckpt": d})
    return d, jax_dir2, [o["ckpt"] for o in outs]


def test_port_restores_the_jax_dp4_save_at_dp1_and_dp2(world):
    """Every field of the JAX dp = 4 save comes back in the port bit for
    bit: at dp = 2 each rank's shards are its slice of the JAX dp = 2
    state, and at dp = 1 the canonical flats are the JAX state's."""
    d, _, outs = world
    want, step, _ = _jax_restore(d["jax_dir"], 4, d["params"])
    _, _, jstate2 = _jax_restore(d["jax_dir"], 2, d["params"])
    for r, o in enumerate(outs):
        assert o["restored_step"] == JAX_STEP
        assert int(o["restored"]["step"]) == step == 1
        for f in ("params_shard", "exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(
                o["restored"][f],
                np.split(np.asarray(getattr(jstate2, f)), 2)[r],
                err_msg=f"rank {r} {f}")
    got = _port_canonical([o["restored"] for o in outs], outs[0]["layout"])
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)

    opt = DistributedFusedAdam(1, lr=1e-3, n_buckets=2)
    opt.init(W.tree_t(d["params"]))
    state, scaler, manifest = PC.restore_sharded(d["jax_dir"], opt,
                                                 device="cpu")
    assert scaler is None and manifest["step"] == JAX_STEP
    assert state.params_shard.device.type == "cpu"
    assert int(state.step) == 1
    for f in want:
        np.testing.assert_array_equal(
            PS.canonical_flat([getattr(state, f)],
                              opt.shard_layout()).numpy(), want[f],
            err_msg=f)
    JM.destroy_model_parallel()


def test_port_dp2_save_matches_the_jax_dp2_save_byte_for_byte(world):
    """The port's dp = 2 save of the restored state (each rank its own
    shard files, rank 0 the rest and the commit) writes the same files
    as the JAX package's dp = 2 save of that state, byte for byte, and
    a manifest equal to it apart from created_unix and
    tuner_fingerprint: no multi-host record.  The ranks' sub-manifests
    of the file barrier stay beside it, as the JAX package's multi-host
    commit leaves them."""
    d, jax_dir2, _ = world
    ours = PS.step_dir(d["same_dir"], JAX_STEP)
    theirs = JS.step_dir(jax_dir2, JAX_STEP)
    files = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == sorted(
        files + ["manifest.host000.json", "manifest.host001.json"])
    assert "params_shard.rank001.bin" in files
    for f in files:
        if f == "manifest.json":
            continue
        with open(os.path.join(ours, f), "rb") as a, \
                open(os.path.join(theirs, f), "rb") as b:
            assert a.read() == b.read(), f
    m_ours, m_theirs = (json.load(open(os.path.join(p, "manifest.json")))
                        for p in (ours, theirs))
    for m in (m_ours, m_theirs):
        for k in VOLATILE:
            m.pop(k)
    assert m_ours == m_theirs


def test_jax_restores_the_port_dp2_save_at_dp_1_2_4(world):
    """The port's save after one more step restores in the JAX package
    at dp = 1, 2 and 4 to the port's canonical flats exactly."""
    d, _, outs = world
    want = _port_canonical([o["stepped"] for o in outs], outs[0]["layout"])
    for dp in (1, 2, 4):
        got, step, _ = _jax_restore(d["next_dir"], dp, d["params"])
        assert step == int(outs[0]["stepped"]["step"]) == 2
        for f in want:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"dp {dp} {f}")
    JM.destroy_model_parallel()


def test_bf16_state_round_trips_without_ml_dtypes(tmp_path, monkeypatch):
    """A bf16-master ZeRO state: the JAX dp = 2 save restores in the
    port, and the port's save restores in the JAX package, bit for bit,
    with `ml_dtypes` unimportable on the port's side.  The legacy pickle
    of a bf16 leaf needs it and names it."""
    params = _params()
    mesh, jopt, jstate = _jax_zero(2, params, jnp.bfloat16)
    jstate = _jax_step(mesh, jopt, jstate, _grads(2))
    JC.CheckpointManager(str(tmp_path / "j"), jopt,
                         async_write=False).save(5, jstate)
    canon = JS.canonical_flat(list(np.split(np.asarray(jstate.exp_avg), 2)),
                              jopt.shard_layout())
    assert canon.dtype == ml_dtypes.bfloat16

    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    opt = DistributedFusedAdam(1, lr=1e-3, n_buckets=2,
                               master_dtype=torch.bfloat16)
    opt.init(W.tree_t(params))
    mgr = PC.CheckpointManager(str(tmp_path / "j"), opt, async_write=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state, _, m = mgr.restore(device="cpu")
    assert m["fields"]["exp_avg"]["dtype"] == "bfloat16"
    assert state.exp_avg.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        PS.canonical_flat([state.exp_avg], opt.shard_layout()).view(
            torch.int16).numpy(), canon.view(np.int16))
    PC.CheckpointManager(str(tmp_path / "p"), opt,
                         async_write=False).save(6, state)
    with pytest.raises(PC.CheckpointError, match="ml_dtypes"):
        PC.save_checkpoint(str(tmp_path / "pk"), {"w": state.exp_avg},
                           use_orbax=False)
    monkeypatch.undo()

    _, jopt1, _ = _jax_zero(1, params, jnp.bfloat16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        back, _, _ = JC.CheckpointManager(str(tmp_path / "p"),
                                          jopt1).restore()
    np.testing.assert_array_equal(
        JS.canonical_flat([np.asarray(back.exp_avg)],
                          jopt1.shard_layout()).view(np.int16),
        canon.view(np.int16))
    JM.destroy_model_parallel()


def test_reshard_math_matches_jax():
    """canonical_flat, relayout_flat and reshard equal the JAX functions
    on the layouts of tests/test_checkpoint.py, in fp32 and bf16; a
    layout mismatch is refused by both with the same message."""
    for dt, tdt in ((np.float32, torch.float32),
                    (ml_dtypes.bfloat16, torch.bfloat16)):
        name = np.dtype(dt).name
        canon = np.arange(24).astype(dt)
        tcanon = torch.arange(24).to(tdt)
        src = {"align": 1, "total": 24, "n_tensors": 4, "num_shards": 2,
               "n_buckets": 2, "bucket_totals": [14, 10],
               "bucket_padded": [16, 12], "master_dtype": name}
        jg = JS.relayout_flat(canon, src)
        pg = PS.relayout_flat(tcanon, src)
        np.testing.assert_array_equal(pg.float().numpy(),
                                      jg.astype(np.float32))
        shards = list(np.split(jg, 2))
        tshards = list(torch.chunk(pg, 2))
        for m, nb in ((4, 1), (3, 3), (1, 2)):
            totals = {1: [24], 2: [14, 10], 3: [8, 8, 8]}[nb]
            dst = dict(src, num_shards=m, n_buckets=nb, bucket_totals=totals,
                       bucket_padded=[-(-t // m) * m for t in totals])
            np.testing.assert_array_equal(
                PS.reshard(tshards, src, dst).float().numpy(),
                JS.reshard(shards, src, dst).astype(np.float32))
            np.testing.assert_array_equal(
                PS.canonical_flat(list(torch.chunk(
                    PS.reshard(tshards, src, dst), m)), dst).float().numpy(),
                canon.astype(np.float32))
    for bad in (dict(src, align=128), dict(src, ep_shards=2)):
        with pytest.raises(JS.LayoutMismatchError) as je:
            JS.reshard(shards, src, bad)
        with pytest.raises(PS.LayoutMismatchError) as pe:
            PS.reshard(tshards, src, bad)
        assert str(pe.value) == str(je.value)


# ---------------------------------------------------------------------------
# the commit protocol's fault cases, through both packages
# ---------------------------------------------------------------------------

PKGS = {"jax": (JS, jchaos, JC), "port": (PS, pchaos, PC)}


def _host(x):
    """A loaded field (numpy or tensor, or a list of them) as numpy."""
    if isinstance(x, list):
        return np.concatenate([_host(a).ravel() for a in x])
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _toy(S, directory, step=7, n=2, fill=None):
    flat = (np.arange(8 * n, dtype=np.float32) if fill is None
            else np.full(8 * n, fill, np.float32))
    return S.save_sharded(
        str(directory), step,
        {"params_shard": ("sharded", list(np.split(flat, n))),
         "step": ("replicated", np.asarray(step, np.int32))},
        flat_layout={"align": 1, "total": 8 * n, "n_tensors": 1,
                     "num_shards": n, "n_buckets": 1,
                     "bucket_totals": [8 * n], "bucket_padded": [8 * n],
                     "master_dtype": "float32"})


def _outcome(fn):
    """(exception type name, message) of a call, or its value."""
    try:
        return ("ok", fn())
    except Exception as e:  # the outcome under comparison
        return (type(e).__name__, str(e))


def _scrub(x, root):
    """`x` as JSON with the case's directory spelled "<d>"."""
    return json.loads(json.dumps(x, default=str).replace(str(root), "<d>"))


def _corruption_case(pkg, root):
    S, chaos, C = PKGS[pkg]
    out = []
    p = _toy(S, root / "a")
    out.append(C.latest_committed_step(str(root / "a")))
    out.append(_host(C.load_checkpoint(p)["params_shard"]).tolist())
    chaos.truncate_shard(p, "params_shard", rank=1)
    out.append(_outcome(lambda: C.load_checkpoint(p)))
    out.append(C.latest_committed_step(str(root / "a")))
    p2 = _toy(S, root / "b")
    chaos.delete_shard(p2, "params_shard", rank=0)
    out.append(_outcome(lambda: S.verify_shards(p2)))
    p3 = _toy(S, root / "c")
    chaos.corrupt_manifest(p3, mode="stale")
    out.append(_outcome(lambda: S.verify_shards(p3)))
    p4 = _toy(S, root / "d")
    chaos.corrupt_manifest(p4, mode="truncate")
    out.append(_outcome(lambda: C.load_checkpoint(p4))[0])
    p5 = _toy(S, root / "e")
    f = os.path.join(p5, "params_shard.rank000.bin")
    raw = bytearray(open(f, "rb").read())
    raw[0] ^= 0xFF
    open(f, "wb").write(bytes(raw))
    out.append(_outcome(lambda: S.verify_shards(p5)))
    return _scrub(out, root)


def _overwrite_case(pkg, root):
    S, chaos, C = PKGS[pkg]
    out = []
    p = _toy(S, root, step=5)
    new = {"params_shard": ("sharded",
                            list(np.split(np.full(16, 9.0, np.float32), 2))),
           "step": ("replicated", np.asarray(5, np.int32))}
    for point in chaos.CKPT_POINTS:
        with chaos.preempt_at(point):
            out.append(_outcome(lambda: S.save_sharded(
                str(root), 5, new, overwrite=True))[0])
        out.append(C.latest_committed_step(str(root)))
        out.append(_host(C.load_checkpoint(p)["params_shard"]).tolist())
    S.save_sharded(str(root), 5, new, overwrite=True)
    out.append(_host(C.load_checkpoint(p)["params_shard"]).tolist())
    out.append([os.path.exists(p + s) for s in (".tmp", ".old")])
    out.append(_outcome(lambda: S.save_sharded(str(root), 5, new)))
    # a legacy pickle in the step directory is refused, never cleared
    C.save_checkpoint(str(root / "legacy"), {"w": np.ones(4)}, step=5,
                      use_orbax=False)
    out.append(_outcome(lambda: S.save_sharded(
        str(root / "legacy"), 5, {"step": ("replicated",
                                           np.asarray(5, np.int32))}))[0])
    out.append(_outcome(lambda: C.load_checkpoint(p, target={"a": 1})))
    return _scrub(out, root)


def _swap_case(pkg, root):
    S, chaos, C = PKGS[pkg]
    out = []
    p = _toy(S, root, step=5)
    shutil.move(p, p + ".old")
    _toy(S, root, step=5, fill=9.0)
    shutil.move(p, p + ".tmp")
    out.append(os.path.exists(p))
    out.append(C.latest_committed_step(str(root)))
    out.append(_host(C.load_checkpoint(p)["params_shard"]).tolist())
    S.prune(str(root), keep=1)
    out.append(os.path.exists(p + ".old"))
    q = _toy(S, root / "b", step=9)
    shutil.move(q, q + ".old")
    out.append(C.latest_committed_step(str(root / "b")))
    out.append(os.path.exists(q))
    return _scrub(out, root)


def _manager_case(pkg, root):
    """Kill mid-save at every writer point (the previous commit stays the
    resume point), an async writer's death at wait(), and the restore's
    fallback past a crc-damaged newest commit."""
    S, chaos, C = PKGS[pkg]
    params = {"w": np.ones(300, np.float32), "b": np.ones(7, np.float32)}
    if pkg == "jax":
        opt = JaxFusedAdam(lr=1e-2, use_pallas=False)
        state = opt.init(params)

        def restore(m, **kw):
            return m.restore(**kw)
    else:
        opt = FusedAdam(lr=1e-2)
        state = opt.init(W.tree_t(params))

        def restore(m, **kw):
            return m.restore(device="cpu", **kw)
    out = []
    mgr = C.CheckpointManager(str(root), opt, every_n_steps=1, keep=4,
                              async_write=False)
    mgr.save(1, state)
    for point in chaos.CKPT_POINTS:
        with chaos.preempt_at(point):
            out.append(_outcome(lambda: mgr.save(2, state))[0])
        out.append(mgr.last_committed_step)
        out.append(_outcome(lambda: S.read_manifest(
            S.step_dir(str(root), 2))))
    r, _, m = restore(mgr)
    out.append(m["step"])
    out.append(_host(r.params).tolist() == params["w"].tolist()
               + params["b"].tolist() + [0.0] * (len(_host(r.params)) - 307))
    mgr2 = C.CheckpointManager(str(root / "async"), opt, every_n_steps=1)
    with chaos.preempt_at("ckpt.before_manifest"):
        mgr2.save(3, state)
        out.append(_outcome(mgr2.wait)[0])
    out.append(mgr2.last_committed_step)
    mgr.save(8, state)
    f = os.path.join(S.step_dir(str(root), 8), "params.bin")
    raw = bytearray(open(f, "rb").read())
    raw[0] ^= 0xFF
    open(f, "wb").write(bytes(raw))
    out.append(C.latest_committed_step(str(root)))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _, _, m = restore(mgr)
    out.append([str(x.message)[:90] for x in w
                if "falling back" in str(x.message)])
    out.append(m["step"])
    out.append(_outcome(lambda: restore(mgr, step=8)))
    return _scrub(out, root)


@pytest.mark.parametrize("case", [_corruption_case, _overwrite_case,
                                  _swap_case, _manager_case],
                         ids=["corruption", "staged_overwrite",
                              "interrupted_swap", "kill_and_crc_fallback"])
def test_fault_cases_give_the_jax_outcome(case, tmp_path):
    """The same sequence of saves, kills and corruptions through each
    package's modules: the same steps committed, the same values loaded,
    the same errors with the same messages."""
    got = case("port", tmp_path / "port")
    want = case("jax", tmp_path / "jax")
    assert got == want


def test_manager_refuses_a_tp_sharded_state(tmp_path, monkeypatch):
    """A state cut over tp (or pp) ranks is refused by name: the format
    records dp shards of one flat state."""
    from apex_tpu_torch.parallel import mesh as M

    opt = FusedAdam(lr=1e-2)
    state = opt.init({"w": torch.ones(8)})
    monkeypatch.setattr(M, "group_of", lambda axis: axis)
    monkeypatch.setattr(M, "group_size",
                        lambda g: 2 if g == M.TP_AXIS else 1)
    mgr = PC.CheckpointManager(str(tmp_path), opt, async_write=False)
    with pytest.raises(PC.CheckpointError, match="2 'tp' ranks"):
        mgr.save(1, state)
    assert mgr.last_committed_step is None
