"""The port's data parallelism across ranks (apex_tpu_torch.parallel:
ddp, mesh, sync_batchnorm's merge, clip_grad, multiproc) against the JAX
package's, on the CPU.

The port runs as 2 and 4 gloo ranks, each a process started by its own
launcher (`apex_tpu_torch.parallel.multiproc`, a file store under the
test's temporary directory, no port) that runs every scenario of
tests/torch_dist_worker.py once; the JAX package runs the same seeded
numpy inputs on a dp = 2 or 4 mesh of its 8-device CPU mesh.

Tolerances (fp32 unless stated): the grad means and sums, 1e-6 of the
largest magnitude (the ranks' values summed in another order); three
train steps, 2e-6 absolute on params of magnitude ~0.3 (Adam divides
by √v, which turns the sums' last-bit differences into update
differences of that size); SyncBN's output and input gradient, 2e-4 as
the JAX package's own SyncBN test; bf16 params, 1e-2 of the update's
norm (the packages round the bf16 products in other places; measured
1.4e-3 to 1.7e-3)."""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.optimizers.fused_adagrad import FusedAdagrad as JAdagrad
from apex_tpu.optimizers.fused_adam import FusedAdam as JAdam
from apex_tpu.optimizers.fused_sgd import FusedSGD as JSGD
from apex_tpu.parallel import clip_grad as jclip
from apex_tpu.parallel import ddp as jddp
from apex_tpu.parallel import mesh as JM
from apex_tpu.parallel.larc import LARC as JLARC
from apex_tpu.parallel.sync_batchnorm import sync_batch_norm as jbn
from apex_tpu.transformer.pipeline_parallel.schedules import (
    forward_backward_no_pipelining)
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import ddp, multiproc
from apex_tpu_torch.parallel.sync_batchnorm import sync_batch_norm

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORLDS = (2, 4)
OPTS = ("adam", "sgd_amp", "adagrad", "larc")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(8, 16)) * 0.3).astype(np.float32),
            "b1": (rng.normal(size=(16,)) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(16, 4)) * 0.3).astype(np.float32)}


def _batch(seed=1, rows=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, 8)).astype(np.float32),
            rng.normal(size=(rows, 4)).astype(np.float32))


def _grads(world, seed=2):
    rng = np.random.default_rng(seed)
    return [{"a": rng.normal(size=(5, 3)).astype(np.float32) * (1 + r),
             "b": rng.normal(size=(7,)).astype(np.float32) + r}
            for r in range(world)]


def _inputs(world):
    x, y = _batch()
    rng = np.random.default_rng(3)
    uneven = [rng.normal(size=(r % 3 + 1, 5)).astype(np.float32)
              for r in range(world)]
    return {
        "scenarios": ["sync", "train", "micro", "syncbn", "clip"],
        "sync": {"grads": _grads(world)},
        "train": {"opts": OPTS, "params": _mlp_params(), "x": x, "y": y},
        "micro": {"params": _mlp_params(), "x": x, "y": y},
        "syncbn": {"x": rng.normal(size=(16, 4, 4, 6)).astype(np.float32),
                   "w": rng.normal(size=(16, 4, 4, 6)).astype(np.float32),
                   "uneven": uneven},
        "clip": {"grads": _grads(world, seed=4)},
    }


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"dp{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    d = tmp_path_factory.mktemp(f"ddp{world}")
    inputs = _inputs(world)
    return world, inputs, W.run_ranks(str(d), world, inputs)


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _mesh(world):
    JM.destroy_model_parallel()
    return JM.initialize_model_parallel(devices=jax.devices()[:world])


def _jflat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _jmlp_loss(p, b):
    x, y = b
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] - y).astype(jnp.float32) ** 2)


# ------------------------------ gradient sync -------------------------------

def test_sync_gradients_across_ranks(ranks):
    """sync_gradients, the bucketed form, Reducer and DDP.sync give every
    rank the mean of the ranks' grads (average=False: the sum), as the
    JAX package's sync over its dp axis."""
    world, inputs, outs = ranks
    outs = [o["sync"] for o in outs]
    grads = inputs["sync"]["grads"]
    mesh = _mesh(world)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *grads)

    def jsync(g, fn):
        return jax.jit(shard_map(
            lambda s: jax.tree_util.tree_map(
                lambda x: x[None], fn(jax.tree_util.tree_map(
                    lambda x: x[0], s))),
            mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp"),
            check_vma=False))(g)

    want = {
        "sync": jsync(stacked, jddp.sync_gradients),
        "sum": jsync(stacked, lambda s: jddp.sync_gradients(
            s, average=False)),
        "bucketed": jsync(stacked, lambda s: jddp.sync_gradients_bucketed(
            s, num_buckets=3)),
    }
    mean = _jflat(jax.tree_util.tree_map(lambda x: x[0], want["sync"]))
    np.testing.assert_allclose(mean, _jflat(jax.tree_util.tree_map(
        lambda *a: np.mean(a, axis=0), *grads)), rtol=1e-6)
    for r, out in enumerate(outs):
        for key in ("sync", "sum", "bucketed"):
            _close(out[key], _jflat(jax.tree_util.tree_map(
                lambda x: x[r], want[key])), 1e-6, f"{key} rank {r}")
        _close(out["reducer"], mean, 1e-6, f"Reducer rank {r}")
        _close(out["ddp_sync"], mean, 1e-6, f"DDP.sync rank {r}")
    JM.destroy_model_parallel()


def test_clip_grad_norm_on_synced_grads(ranks):
    """clip_grad_norm over the dp-mean grads: every rank the same clipped
    grads and norm, the JAX package's on the mean grads."""
    world, inputs, outs = ranks
    outs = [o["clip"] for o in outs]
    grads = inputs["clip"]["grads"]
    mean = jax.tree_util.tree_map(lambda *a: jnp.mean(jnp.stack(a), 0),
                                  *grads)
    clipped, total = jclip.clip_grad_norm(mean, 1.0)
    for r, out in enumerate(outs):
        _close(out["clipped"], _jflat(clipped), 1e-6, f"rank {r}")
        _close(out["norm"], np.asarray(total), 1e-6, f"norm rank {r}")


# ------------------------------- train steps --------------------------------

def _jopt(name):
    if name == "adam":
        return JAdam(lr=1e-2, weight_decay=0.01)
    if name == "sgd":
        return JSGD(lr=0.1, momentum=0.9)
    if name == "adagrad":
        return JAdagrad(lr=1e-2)
    return JLARC(JSGD(lr=0.1, momentum=0.9), trust_coefficient=0.02,
                 clip=True)


def _unflat(flat, opt):
    from apex_tpu.optimizers import flat as JF
    return JF.unflatten(flat, opt.spec)


def _jax_train(name, world, x, y):
    mesh = _mesh(world)
    opt = _jopt(name.replace("_amp", ""))
    state = opt.init(jax.tree_util.tree_map(jnp.asarray, _mlp_params()))
    amp_state = scaler = None
    if name.endswith("_amp"):
        amp_state = jamp.initialize(opt_level="O0", loss_scale="dynamic")
        scaler = amp_state.loss_scalers[0]
    if name == "adagrad":
        # the dp mean of equal shards' mean losses is the full batch's
        for _ in range(3):
            g = jax.grad(_jmlp_loss)(_unflat(state.params, opt), (x, y))
            _, state = opt.step(state, g)
        JM.destroy_model_parallel()
        return state, None
    step = jddp.make_train_step(_jmlp_loss, opt, mesh, amp_state=amp_state,
                                batch_spec=(P("dp"), P("dp")), donate=False)
    per = x.shape[0] // world
    for i in range(3):
        xi = x.copy()
        if name.endswith("_amp") and i == 1:
            xi[(world - 1) * per, 0] = np.inf
        state, scaler, _ = step(state, scaler, (xi, y))
    JM.destroy_model_parallel()
    return state, scaler


@pytest.mark.parametrize("name", OPTS)
def test_make_train_step_across_ranks(ranks, name):
    """Three make_train_step steps at dp = 2 and 4 (FusedAdam, FusedSGD
    under O0 with a dynamic loss scale and an inf in one rank's second
    batch, LARC(FusedSGD)) equal the JAX step's on the same global batch
    on every rank, and the port's full-batch step on one process; the
    overflow skips the step on every rank and halves the scale.
    FusedAdagrad, which takes no loss scale in either package, steps on
    grads synced by `sync_gradients` against the JAX optimizer on the
    full batch's grads."""
    world, inputs, outs = ranks
    outs = [o["train"] for o in outs]
    x, y = inputs["train"]["x"], inputs["train"]["y"]
    jstate, jscaler = _jax_train(name, world, x, y)
    want = np.asarray(jstate.params, np.float32)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[name], want, rtol=0, atol=2e-6,
                                   err_msg=f"{name} rank {r}")
        np.testing.assert_array_equal(out[name], outs[0][name])
    if name == "adagrad":
        return
    if name == "sgd_amp":
        got = outs[0][name + "_scaler"]
        assert list(got) == [float(jscaler.scale),
                             float(jscaler.growth_tracker),
                             float(jscaler.found_inf), float(jstate.step)]
        assert list(got) == [2.0 ** 15, 1.0, 0.0, 2.0]
        return
    # the full batch on one process
    opt = W._make_opt(name)
    state = opt.init(W.tree_t(_mlp_params()))
    step = ddp.make_train_step(W.mlp_loss, opt, device="cpu")
    for _ in range(3):
        state, _, _ = step(state, None, (torch.from_numpy(x),
                                         torch.from_numpy(y)))
    np.testing.assert_allclose(outs[0][name], state.params.numpy(), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_microbatches_with_fp32_main_grads_across_ranks(ranks, dtype):
    """num_microbatches=2 with main_grad_dtype=float32 at dp = 2 and 4
    against the JAX step with the same settings: fp32 params within
    2e-6, bf16 params (fp32 master, bf16 step leaves) within 1e-2 of the
    update's norm."""
    world, inputs, outs = ranks
    outs = [o["micro"] for o in outs]
    x, y = inputs["micro"]["x"], inputs["micro"]["y"]
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    mesh = _mesh(world)
    opt = JSGD(lr=0.1)
    p0 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), _mlp_params())
    state = opt.init(p0)
    start = np.asarray(state.params, np.float32)
    step = jddp.make_train_step(_jmlp_loss, opt, mesh,
                                batch_spec=(P("dp"), P("dp")), donate=False,
                                num_microbatches=2,
                                main_grad_dtype=jnp.float32)
    for _ in range(3):
        state, _, _ = step(state, None, (jnp.asarray(x, jdt),
                                         jnp.asarray(y, jdt)))
    JM.destroy_model_parallel()
    want = np.asarray(state.params, np.float32)
    for r, out in enumerate(outs):
        got = out[dtype]
        if dtype == "fp32":
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        else:
            err = np.linalg.norm(got - want) / np.linalg.norm(want - start)
            assert err <= 1e-2, (r, err)


# -------------------------- the fp32 main-grad drift ------------------------

N_MICRO = 32


class _Capture(FusedSGD):
    """FusedSGD that keeps the flat grads the step hands it."""

    def step_flat(self, state, g_flat, **kw):
        self.seen = g_flat.clone()
        return super().step_flat(state, g_flat, **kw)


def _drift_problem():
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(16, 32)) * 0.3,
              "b1": rng.normal(size=(32,)) * 0.1,
              "w2": rng.normal(size=(32, 4)) * 0.3}
    scale = (1.0 + np.arange(N_MICRO) / 4.0)[:, None, None]
    x = rng.normal(size=(N_MICRO, 8, 16)) * scale
    y = rng.normal(size=(N_MICRO, 8, 4))
    return params, x, y


def test_main_grad_drift_contract():
    """tests/test_grad_accum_drift.py's contract through the port's step:
    32 microbatches of bf16 grads accumulated in fp32 track the fp64 sum
    of the same per-microbatch grads at least 10x closer than the bf16
    accumulation (main_grad_dtype None: each leaf's own dtype), and the
    fp32 main grads are the JAX package's within 1e-2 relative (its bf16
    per-microbatch grads round elsewhere)."""
    params, x, y = _drift_problem()
    bf = torch.bfloat16
    tp = {k: torch.tensor(v, dtype=torch.float32).to(bf)
          for k, v in params.items()}
    tx = torch.tensor(x, dtype=torch.float32).to(bf)
    ty = torch.tensor(y, dtype=torch.float32).to(bf)

    def loss_fn(p, b):
        xb, yb = b
        h = torch.tanh(xb @ p["w1"] + p["b1"])
        return torch.mean((h @ p["w2"] - yb) ** 2).float()

    def captured(main_grad_dtype):
        opt = _Capture(lr=0.0)
        state = opt.init(tp)
        step = ddp.make_train_step(loss_fn, opt, device="cpu",
                                   num_microbatches=N_MICRO,
                                   main_grad_dtype=main_grad_dtype)
        step(state, None, (tx.reshape(-1, 16), ty.reshape(-1, 4)))
        return opt.seen[:opt.spec.total].double().numpy(), opt.spec

    # the fp64 oracle: the same per-microbatch bf16 grads, summed in fp64
    leaves = [tp[k].clone().requires_grad_(True) for k in sorted(tp)]
    acc = None
    for i in range(N_MICRO):
        p = dict(zip(sorted(tp), leaves))
        g = torch.autograd.grad(loss_fn(p, (tx[i], ty[i])), leaves)
        g = np.concatenate([t.double().numpy().ravel() for t in g])
        acc = g if acc is None else acc + g
    oracle = acc / N_MICRO

    def rel(a):
        return np.linalg.norm(a - oracle) / np.linalg.norm(oracle)

    g32, spec = captured(torch.float32)
    g16, _ = captured(None)
    assert rel(g32) < rel(g16) / 10.0, (rel(g32), rel(g16))
    _, jg = forward_backward_no_pipelining(
        lambda p, mb: jnp.mean((jnp.tanh(mb[0] @ p["w1"] + p["b1"])
                                @ p["w2"] - mb[1]) ** 2).astype(jnp.float32),
        (jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)),
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                               params),
        num_microbatches=N_MICRO, main_grad_dtype=jnp.float32)
    jflat = _jflat(jg).astype(np.float64)
    assert np.linalg.norm(g32 - jflat) / np.linalg.norm(jflat) <= 1e-2


# ---------------------------------- SyncBN ----------------------------------

def test_sync_batch_norm_across_ranks(ranks):
    """SyncBN over the ranks' slices of the batch equals global batch norm
    (numpy) and the JAX package's SyncBN over its dp axis; the input
    gradient of Σ y·w summed over the ranks equals the global batch
    norm's (autograd on one process); the running statistics take the
    global mean and unbiased variance; uneven per-rank counts merge to
    the statistics of all rows."""
    world, inputs, outs = ranks
    outs = [o["syncbn"] for o in outs]
    d = inputs["syncbn"]
    x, w = d["x"], d["w"]
    mesh = _mesh(world)
    c = x.shape[-1]
    jy = shard_map(lambda xs: jbn(xs, jnp.ones(c), jnp.zeros(c),
                                  jnp.zeros(c), jnp.ones(c), training=True,
                                  axis_name="dp")[0],
                   mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp"),
                   check_vma=False)(jnp.asarray(x))
    JM.destroy_model_parallel()
    m, v = x.mean(axis=(0, 1, 2)), x.var(axis=(0, 1, 2))
    ref = (x - m) / np.sqrt(v + 1e-5)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, rm, rv = sync_batch_norm(tx, torch.ones(c), torch.zeros(c),
                                 torch.zeros(c), torch.ones(c),
                                 training=True)
    (ty * torch.from_numpy(w)).sum().backward()
    y = np.concatenate([o["y"] for o in outs])
    dx = np.concatenate([o["dx"] for o in outs])
    np.testing.assert_allclose(y, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(y, np.asarray(jy), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dx, tx.grad.numpy(), rtol=2e-4, atol=2e-4)
    for o in outs:
        np.testing.assert_allclose(o["rm"], rm.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(o["rv"], rv.numpy(), rtol=1e-5,
                                   atol=1e-6)
    rows = np.concatenate(d["uneven"])
    for o in outs:
        np.testing.assert_allclose(o["u_mean"], rows.mean(0), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(o["u_var"], rows.var(0), rtol=1e-4,
                                   atol=1e-4)
        assert float(o["u_count"]) == len(rows)


# ------------------------------- the launcher -------------------------------

def _launch(tmp_path, body, *args):
    script = tmp_path / "child.py"
    script.write_text("import os, sys, time\n"
                      "rank = int(os.environ['APEX_TPU_PROCESS_ID'])\n"
                      + body)
    t0 = time.monotonic()
    rc = multiproc.main(["--nproc", "2", *args, str(script)])
    return rc, time.monotonic() - t0


def test_launcher_propagates_the_first_failure(tmp_path):
    """A rank's nonzero exit is the launcher's exit code; each child
    sees the rendezvous, the world size and its rank."""
    rc, _ = _launch(tmp_path, "assert os.environ['APEX_TPU_NUM_PROCESSES']"
                    " == '2'\nassert os.environ['APEX_TPU_INIT_METHOD']\n"
                    "sys.exit(3 if rank == 1 else 0)\n")
    assert rc == 3
    rc, _ = _launch(tmp_path, "sys.exit(0)\n")
    assert rc == 0


@pytest.mark.parametrize("grace,finished", [(0.0, False), (20.0, True)])
def test_launcher_grace(tmp_path, grace, finished):
    """After rank 1 fails, rank 0 runs on for --grace seconds: with 20 s
    it finishes its three-second job, with 0 it is ended at once."""
    marker = tmp_path / "done"
    rc, _ = _launch(tmp_path, f"if rank == 1:\n    sys.exit(5)\n"
                    f"time.sleep(3.0)\nopen({str(marker)!r}, 'w').close()\n",
                    "--grace", str(grace))
    assert rc == 5
    assert marker.exists() is finished


def test_launcher_timeout(tmp_path):
    """--timeout ends a hung fleet with exit 124."""
    rc, took = _launch(tmp_path, "time.sleep(60)\n", "--timeout", "1")
    assert rc == 124 and took < 30


def test_init_from_env_without_the_launcher(monkeypatch):
    """Outside the launcher init_from_env does nothing; a device other
    than the CPU or the card is refused."""
    for var in ("APEX_TPU_INIT_METHOD", "APEX_TPU_PROCESS_ID",
                "APEX_TPU_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert multiproc.init_from_env() is False
    monkeypatch.setenv("APEX_TPU_INIT_METHOD", "file:///nonexistent/x")
    monkeypatch.setenv("APEX_TPU_PROCESS_ID", "0")
    monkeypatch.setenv("APEX_TPU_NUM_PROCESSES", "1")
    with pytest.raises(ValueError, match="cpu"):
        multiproc.init_from_env("tpu")


def test_launcher_runs_as_a_module(tmp_path):
    """`python -m apex_tpu_torch.parallel.multiproc` is the entry point."""
    script = tmp_path / "ok.py"
    script.write_text("import os\nassert os.environ['APEX_TPU_PROCESS_ID']"
                      " in ('0', '1', '2')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m",
                           "apex_tpu_torch.parallel.multiproc", "--nproc",
                           "3", str(script)], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------ the process groups --------------------------

def test_mesh_world_of_one_and_refusals():
    """Without torch.distributed the dp group is a world of one (no group,
    size 1, rank 0) and the sync is the identity; tp, pp, cp and ep > 1
    raise naming their ROADMAP items."""
    from apex_tpu_torch.parallel import mesh as M

    assert M.initialize_model_parallel() is None
    assert M.model_parallel_is_initialized()
    assert (M.get_data_parallel_world_size(), M.get_data_parallel_rank(),
            M.get_data_parallel_axis_names()) == (1, 0, ("dp",))
    g = torch.arange(4.0)
    assert ddp.sync_gradients(g) is g and torch.equal(g, torch.arange(4.0))
    for kw, item in (({"tensor_model_parallel_size": 2}, "13"),
                     ({"pipeline_model_parallel_size": 2}, "14"),
                     ({"context_parallel_size": 2}, "15"),
                     ({"expert_model_parallel_size": 2}, "16")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            M.initialize_model_parallel(**kw)
    M.destroy_model_parallel()
    assert not M.model_parallel_is_initialized()
    with pytest.raises(M.MeshNotInitializedError):
        M.get_data_parallel_world_size()
    assert (M.DP_AXIS, M.PP_AXIS, M.TP_AXIS, M.EP_AXIS) == (
        JM.DP_AXIS, JM.PP_AXIS, JM.TP_AXIS, JM.EP_AXIS)


def test_microbatch_split_refuses_a_ragged_batch():
    """A local batch the microbatch count does not divide raises."""
    opt = FusedSGD(lr=0.1)
    state = opt.init(W.tree_t(_mlp_params()))
    step = ddp.make_train_step(W.mlp_loss, opt, device="cpu",
                               num_microbatches=3)
    x, y = _batch()
    with pytest.raises(ValueError, match="num_microbatches=3"):
        step(state, None, (torch.from_numpy(x), torch.from_numpy(y)))
