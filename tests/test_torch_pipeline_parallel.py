"""The port's pipeline parallelism (apex_tpu_torch.parallel.mesh's pp
axis, apex_tpu_torch.transformer.pipeline_parallel and .microbatches)
against the JAX package's, on the CPU.  Mirrors
tests/test_pipeline_parallel.py.

The multi-rank cases run the port as one 4-rank gloo world started by
its launcher (tests/torch_dist_worker.py, scenarios `pp_mesh` and
`pipeline`), re-initializing the groups at pp 4, pp 2 x tp 2 and pp 2 x
dp 2; the JAX package runs on a mesh of the same shape over its first
CPU devices.  The clocked pipeline's cases: the toy stage x + tanh(x·w +
b) (D = 8, microbatches of 2 rows) at pp 4 and pp 2 with m in {4, 8, 3}
(m < pp included), both output modes, two chunks a stage,
checkpoint_window in {None, 2, pp} and remat_stage, each rank's output
and gradients (its stage's w and b, and the microbatches') against the
JAX `spmd_pipeline` in `shard_map`.  Tolerances (fp32): outputs and
losses rtol 1e-5; gradients rtol 1e-5 and atol 1e-5 of each leaf's
largest magnitude (the port sums a stage's gradients over the clocks in
its own order, not XLA's)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel import mesh as JM
from apex_tpu.transformer import microbatches as jmb
from apex_tpu.transformer.pipeline_parallel import common as jcommon
from apex_tpu.transformer.pipeline_parallel import utils as jutils
from apex_tpu.transformer.pipeline_parallel.schedules import (
    forward_backward_no_pipelining as j_no_pipelining,
    spmd_pipeline as j_spmd_pipeline)
from apex_tpu_torch.transformer import microbatches as tmb
from apex_tpu_torch.transformer.pipeline_parallel import common, utils
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    forward_backward_no_pipelining, get_forward_backward_func)

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORLD = 4
D = 8
RTOL, ATOL = 1e-5, 1e-5
# (pp, m, chunks, checkpoint_window, remat_stage, output mode)
CASES = [
    (4, 4, 1, None, False, "loss"), (4, 8, 1, None, False, "loss"),
    (4, 3, 1, None, False, "loss"), (4, 4, 1, None, False, "stacked"),
    (4, 8, 1, 2, False, "loss"), (4, 8, 1, 4, False, "loss"),
    (4, 4, 1, None, True, "loss"), (4, 4, 2, None, False, "loss"),
    (4, 3, 2, None, False, "stacked"), (4, 8, 2, 2, True, "loss"),
    (2, 4, 1, None, False, "loss"), (2, 3, 2, 2, False, "stacked"),
]
LAYOUTS = [(4, 1), (2, 2), (2, 1)]     # (pp, tp); dp = 4 / (pp·tp)


def _case_data(case):
    pp, m, chunks = case[:3]
    rng = np.random.default_rng(CASES.index(case))
    n_layers = pp * chunks
    return {"w": (rng.normal(size=(n_layers, D, D)) * 0.3).astype(np.float32),
            "b": (rng.normal(size=(n_layers, D)) * 0.1).astype(np.float32),
            "mbs": rng.normal(size=(m, 2, D)).astype(np.float32),
            "labels": rng.normal(size=(m, 2, D)).astype(np.float32)}


def _inputs():
    data = {case: _case_data(case) for case in CASES}
    return {"scenarios": ["pp_mesh", "pipeline"],
            "pp_mesh": {"layouts": LAYOUTS},
            "pipeline": {"cases": CASES,
                         **{k: {c: v[k] for c, v in data.items()}
                            for k in ("w", "b", "mbs", "labels")}}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline4")
    inputs = _inputs()
    return inputs, W.run_ranks(str(d), WORLD, inputs)


def _jmesh(pp, tp=1, n=WORLD):
    JM.destroy_model_parallel()
    return JM.initialize_model_parallel(
        tensor_model_parallel_size=tp, pipeline_model_parallel_size=pp,
        devices=jax.devices()[:n])


# ------------------------------- the groups ---------------------------------

def test_pp_groups_match_the_jax_mesh(ranks):
    """At pp 4, pp 2 x tp 2 and pp 2 x dp 2 every rank's sizes, (pp, dp,
    tp) coordinates, source ranks and the members of its tp, dp, pp,
    (pp, tp), (dp, tp) and (pp, dp) groups are the JAX mesh's (device r
    is rank r): rank = pp_i·dp·tp + dp_i·tp + tp_i; a sum over the pp
    group is the sum over those members; get_rank_info is the JAX
    package's text."""
    inputs, outs = ranks
    for pp, tp in LAYOUTS:
        ids = np.vectorize(lambda dev: dev.id)(_jmesh(pp, tp).devices)
        dp = WORLD // (pp * tp)
        assert ids.shape == (pp, dp, tp)
        for r, o in enumerate(outs):
            got = o["pp_mesh"][(pp, tp)]
            (pp_i, dp_i, tp_i), = np.argwhere(ids == r)
            want = [pp, pp_i, dp, dp_i, tp, tp_i,
                    JM.get_tensor_model_parallel_src_rank(r),
                    JM.get_data_parallel_src_rank(r)]
            np.testing.assert_array_equal(got["sizes"], want)
            m = got["members"]
            np.testing.assert_array_equal(m[("tp",)], ids[pp_i, dp_i])
            np.testing.assert_array_equal(m[("dp",)], ids[pp_i, :, tp_i])
            np.testing.assert_array_equal(m[("pp",)], ids[:, dp_i, tp_i])
            np.testing.assert_array_equal(got["pp_ranks"], ids[:, dp_i, tp_i])
            np.testing.assert_array_equal(
                m[("pp", "tp")], ids[:, dp_i, :].ravel())
            np.testing.assert_array_equal(
                m[("dp", "tp")], ids[pp_i].ravel())
            np.testing.assert_array_equal(
                m[("pp", "dp")], ids[:, :, tp_i].ravel())
            np.testing.assert_array_equal(
                got["pp_sum"], [np.sum(ids[:, dp_i, tp_i] + 1)])
            assert got["info"] == f"proc{r} " + JM.get_rank_info().split(
                " ", 1)[1]
    JM.destroy_model_parallel()


def test_stage_helpers_and_embedding_groups(ranks):
    """First/last stage, the ring neighbours and the embedding and
    position-embedding stages (with and without a split rank) as the JAX
    package's helpers give them for each rank's stage; a virtual
    pipeline of 2 chunks at pp 4 places pre_process on virtual stage 0
    and post_process on the last (chunk c of stage s is c·pp + s), as
    the JAX build_model does."""
    inputs, outs = ranks
    for pp, tp in LAYOUTS:
        _jmesh(pp, tp)
        for r, o in enumerate(outs):
            got = o["pp_mesh"][(pp, tp)]
            s = r // (WORLD // pp)
            assert got["stages"] == (
                s == 0, JM.is_pipeline_last_stage(s),
                JM.get_pipeline_model_parallel_next_rank(s),
                JM.get_pipeline_model_parallel_prev_rank(s),
                JM.get_embedding_group_stages(),
                JM.get_position_embedding_group_stages(),
                JM.is_rank_in_embedding_group(s)), (pp, tp, r)
            JM.set_pipeline_model_parallel_split_rank(1)
            assert got["split"] == (
                JM.get_embedding_group_stages(),
                JM.get_position_embedding_group_stages(),
                JM.get_encoder_relative_position_embedding_group_stages(),
                JM.get_decoder_relative_position_embedding_group_stages(),
                JM.is_pipeline_stage_before_split(s),
                JM.is_pipeline_stage_after_split(s),
                JM.is_pipeline_stage_at_split(s)), (pp, tp, r)
            JM.set_pipeline_model_parallel_split_rank(None)
    JM.destroy_model_parallel()
    JM.initialize_model_parallel(pipeline_model_parallel_size=WORLD,
                                 virtual_pipeline_model_parallel_size=2,
                                 devices=jax.devices()[:WORLD])
    for r, o in enumerate(outs):
        want = jcommon.build_model(
            lambda pre_process, post_process: (pre_process, post_process),
            virtual_pipeline_model_parallel_size=2, stage=r)
        got = o["pp_mesh"]["vpp"]
        assert got["size"] == 2
        assert [g[:2] for g in got["models"]] == want
        assert [g[2] for g in got["models"]] == [0, 1]
    JM.destroy_model_parallel()


# --------------------------- the clocked pipeline ---------------------------

def _jax_pipeline(case, data):
    """The JAX spmd_pipeline at `case` on a pp mesh: (out, grads of the
    stacked (pp, chunks, ...) w and b, grads of the microbatches by
    stage)."""
    pp, m, chunks, window, remat, mode = case
    mesh = _jmesh(pp, n=pp)

    def reorder(x):     # global layer c·pp + s → [s, c]
        return x.reshape((chunks, pp) + x.shape[1:]).swapaxes(0, 1)

    params = {"w": reorder(jnp.asarray(data["w"])),
              "b": reorder(jnp.asarray(data["b"]))}

    def stage(p, x, c):
        return x + jnp.tanh(x @ p["w"] + p["b"])

    def local(params, mbs, lab):
        def loss(p, x):
            p = jax.tree_util.tree_map(lambda leaf: leaf[0], p)
            if mode == "loss":
                res = j_spmd_pipeline(
                    stage, p, x, num_model_chunks=chunks,
                    remat_stage=remat, checkpoint_window=window,
                    loss_fn=lambda y, lbl: jnp.sum((y - lbl) ** 2),
                    loss_args=lab) / m
                return res, res
            res = j_spmd_pipeline(stage, p, x, num_model_chunks=chunks,
                                  remat_stage=remat,
                                  checkpoint_window=window)
            return jnp.mean(res ** 2), res
        (_, res), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, mbs)
        return res, gp, gx[None]

    spec = {"w": P("pp"), "b": P("pp")}
    res, gp, gx = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec, P(), P()),
        out_specs=(P(), spec, P("pp")), check_vma=False))(
            params, jnp.asarray(data["mbs"]), jnp.asarray(data["labels"]))
    JM.destroy_model_parallel()
    return np.asarray(res), jax.tree_util.tree_map(np.asarray, gp), \
        np.asarray(gx)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "pp{}-m{}-c{}-w{}-r{}-"
                         "{}".format(*c))
def test_spmd_pipeline_matches_jax(ranks, case):
    """Each rank's output (stacked or the mean loss, the same on every
    stage) and the gradients of its stage's chunks and of the
    microbatches against the JAX pipeline's on that stage."""
    inputs, outs = ranks
    data = {k: inputs["pipeline"][k][case]
            for k in ("w", "b", "mbs", "labels")}
    res, gp, gx = _jax_pipeline(case, data)
    pp = case[0]
    for r, o in enumerate(outs):
        got = o["pipeline"][case]
        s = r // (WORLD // pp)
        np.testing.assert_allclose(got["out"], res, rtol=RTOL,
                                   atol=1e-6, err_msg=f"rank {r} out")
        _close(got["w"], gp["w"][s], f"rank {r} dw")
        _close(got["b"], gp["b"][s], f"rank {r} db")
        if s == 0:
            _close(got["x"], gx[0], f"rank {r} dx")
        else:
            np.testing.assert_array_equal(got["x"], 0 * gx[0])


# -------------------------- one-process utilities ---------------------------

def _mlp_fwd_torch(p, mb):
    return torch.mean((mb @ p["w"]) ** 2)


@pytest.mark.parametrize("main_grad_dtype", [None, "float32"])
def test_forward_backward_no_pipelining_matches_jax(main_grad_dtype):
    """forward_backward_no_pipelining over 6 microbatches (fp32 params,
    and bf16 params with fp32 main grads): the mean loss and the
    gradients against the JAX driver's."""
    rng = np.random.default_rng(6)
    w = (rng.normal(size=(D, 1)) * 0.1).astype(np.float32)
    batch = rng.normal(size=(6, 2, D)).astype(np.float32)
    dt = None if main_grad_dtype is None else torch.float32
    jdt = None if main_grad_dtype is None else jnp.float32
    pdt = torch.float32 if dt is None else torch.bfloat16
    jpdt = jnp.float32 if dt is None else jnp.bfloat16
    loss, grads = forward_backward_no_pipelining(
        _mlp_fwd_torch, torch.from_numpy(batch).to(pdt),
        {"w": torch.from_numpy(w).to(pdt)}, num_microbatches=6,
        main_grad_dtype=dt)
    jloss, jgrads = j_no_pipelining(
        lambda p, mb: jnp.mean((mb @ p["w"]) ** 2),
        jnp.asarray(batch).astype(jpdt), {"w": jnp.asarray(w).astype(jpdt)},
        num_microbatches=6, main_grad_dtype=jdt)
    assert grads["w"].dtype == (pdt if dt is None else dt)
    tol = 1e-6 if dt is None else 1e-2
    np.testing.assert_allclose(float(loss), float(jloss), rtol=tol)
    np.testing.assert_allclose(grads["w"].float().numpy(),
                               np.asarray(jgrads["w"], np.float32),
                               rtol=tol, atol=1e-6)
    # the metrics plane: the loss, the local grad norm and the samples
    # (6 microbatches of 2) folded in as the JAX package folds them
    from apex_tpu import monitor as jmon
    from apex_tpu_torch import monitor
    *_, m = forward_backward_no_pipelining(
        _mlp_fwd_torch, torch.from_numpy(batch).to(pdt),
        {"w": torch.from_numpy(w).to(pdt)}, num_microbatches=6,
        main_grad_dtype=dt, metrics=monitor.init_metrics("cpu"))
    *_, jm = j_no_pipelining(
        lambda p, mb: jnp.mean((mb @ p["w"]) ** 2),
        jnp.asarray(batch).astype(jpdt), {"w": jnp.asarray(w).astype(jpdt)},
        num_microbatches=6, main_grad_dtype=jdt, metrics=jmon.init_metrics())
    assert int(m.step) == int(jm.step) == 1
    assert float(m.tokens_seen) == float(jm.tokens_seen) == 12.0
    for f in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(getattr(m, f)),
                                   float(getattr(jm, f)), rtol=tol)
    with pytest.raises(TypeError, match="MetricsState"):
        forward_backward_no_pipelining(
            _mlp_fwd_torch, torch.from_numpy(batch),
            {"w": torch.from_numpy(w)}, num_microbatches=6,
            metrics=object())
    assert get_forward_backward_func(None, 1) is \
        forward_backward_no_pipelining


def test_microbatch_calculators_match_jax():
    """≡ test_microbatches.py + test_dynamic_batchsize.py, each value
    against the JAX calculators', with their messages."""
    c, jc = tmb.ConstantNumMicroBatches(64, 4, 2), \
        jmb.ConstantNumMicroBatches(64, 4, 2)
    assert (c.get(), c.get_current_global_batch_size()) == (
        jc.get(), jc.get_current_global_batch_size()) == (8, 64)
    kw = dict(start_batch_size=16, batch_size_increment=16,
              ramup_samples=48, global_batch_size=64, micro_batch_size=4,
              data_parallel_size=2)
    r, jr = tmb.RampupBatchsizeNumMicroBatches(**kw), \
        jmb.RampupBatchsizeNumMicroBatches(**kw)
    for consumed in (0, 16, 31, 48, 49, 100):
        r.update(consumed, True)
        jr.update(consumed, True)
        assert (r.get(), r.get_current_global_batch_size()) == (
            jr.get(), jr.get_current_global_batch_size()), consumed
    with pytest.raises(AssertionError, match="not divisible"):
        tmb.ConstantNumMicroBatches(63, 4, 2)
    b, jb = tmb.build_num_microbatches_calculator(0, [8, 8, 32], 32, 2, 2), \
        jmb.build_num_microbatches_calculator(0, [8, 8, 32], 32, 2, 2)
    assert type(b).__name__ == type(jb).__name__
    assert b.get() == jb.get()
    utils.setup_microbatch_calculator(0, None, 64, 4, 2)
    jutils.setup_microbatch_calculator(0, None, 64, 4, 2)
    assert utils.get_num_microbatches() == jutils.get_num_microbatches() == 8


def test_microbatch_slicing_masks_and_norm_match_jax():
    """split_into_microbatches, get_kth_microbatch,
    get_ltor_masks_and_position_ids (with the eod loss mask) and
    calc_params_l2_norm against the JAX utilities."""
    x = np.arange(24.0, dtype=np.float32).reshape(12, 2)
    got = utils.split_into_microbatches({"x": torch.from_numpy(x)}, 4)
    want = jutils.split_into_microbatches({"x": jnp.asarray(x)}, 4)
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    got = utils.get_kth_microbatch({"x": torch.from_numpy(x)}, 2, 3)
    want = jutils.get_kth_microbatch({"x": jnp.asarray(x)}, 2, 3)
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    assert utils.get_kth_microbatch(None, 0, 3) is None
    tokens = np.random.default_rng(1).integers(0, 5, (3, 7)).astype(np.int32)
    got = utils.get_ltor_masks_and_position_ids(
        torch.from_numpy(tokens), eod_token=2, eod_mask_loss=True)
    want = jutils.get_ltor_masks_and_position_ids(
        jnp.asarray(tokens), eod_token=2, eod_mask_loss=True)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    got = utils.calc_params_l2_norm(
        {"a": torch.from_numpy(params["a"]),
         "b": {"c": torch.from_numpy(params["b"]["c"])}})
    want = jutils.calc_params_l2_norm(
        jax.tree_util.tree_map(jnp.asarray, params))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert "memory stats unavailable" in utils.report_memory("x")
    losses = utils.average_losses_across_data_parallel_group(
        [torch.tensor(1.0), torch.tensor(3.0)])
    np.testing.assert_array_equal(losses.numpy(), [1.0, 3.0])


def test_backward_step_with_grad_scale_matches_jax():
    """backward_step: the last stage's scalar loss seeded with grad_scale,
    and a middle stage with a received output gradient: the input and
    parameter gradients against the JAX vjp; free_output_tensor is a
    no-op and custom_backward raises pointing to backward_step."""
    rng = np.random.default_rng(3)
    p = {"w": (rng.normal(size=(D, D)) * 0.3).astype(np.float32)}
    x = rng.normal(size=(2, D)).astype(np.float32)
    dy = rng.normal(size=(2, D)).astype(np.float32)

    def t_fwd(p_, x_):
        return torch.tanh(x_ @ p_["w"])

    def j_fwd(p_, x_):
        return jnp.tanh(x_ @ p_["w"])

    tp_ = {"w": torch.from_numpy(p["w"])}
    jp = {"w": jnp.asarray(p["w"])}
    for out_grad, scale, tf, jf in (
            (None, 1024.0, lambda a, b: torch.sum(t_fwd(a, b) ** 2),
             lambda a, b: jnp.sum(j_fwd(a, b) ** 2)),
            (dy, None, t_fwd, j_fwd)):
        gx, gp = common.backward_step(
            tf, tp_, torch.from_numpy(x),
            None if out_grad is None else torch.from_numpy(out_grad),
            grad_scale=scale)
        jgx, jgp = jcommon.backward_step(
            jf, jp, jnp.asarray(x),
            None if out_grad is None else jnp.asarray(out_grad),
            grad_scale=scale)
        np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(gp["w"].numpy(), np.asarray(jgp["w"]),
                                   rtol=1e-5, atol=1e-4)
    out, loss = common.forward_step(
        lambda b, m: (b * 2, lambda o: o.sum()), torch.ones(3), None, None,
        num_microbatches=4)
    assert float(loss) == 1.5
    assert common.free_output_tensor([out]) == [out]
    with pytest.raises(NotImplementedError, match="backward_step"):
        common.custom_backward(out, out)
