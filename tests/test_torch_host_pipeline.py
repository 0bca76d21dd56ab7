"""The port's host-driven pipeline (apex_tpu_torch.transformer.
pipeline_parallel.host_driver) against the JAX package's driver and
against one-program autograd through the composed stages, on the CPU
(every stage `device="cpu"`).  Mirrors tests/test_host_pipeline.py.

Stages tanh(x·w + b) (h = 16), the last one's loss the mean of the
squares; the same seeded numpy weights and microbatches in both
packages.  Tolerances (fp32): the mean loss rtol 1e-6; each stage's
gradients rtol 1e-5 and atol 1e-6, as the JAX test holds its driver to
jax.grad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer.pipeline_parallel.host_driver import (
    HostPipelineStage as JStage,
    host_pipeline_train_step as j_train_step,
)
from apex_tpu_torch.transformer.pipeline_parallel import (
    HostPipelineStage,
    host_pipeline_train_step,
)

H = 16


def _np_params(n_stage, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(H, H)) * 0.3).astype(np.float32),
             "b": (rng.normal(size=(H,)) * 0.1).astype(np.float32)}
            for _ in range(n_stage)]


def _np_microbatches(n_mb, rows=4):
    rng = np.random.default_rng(100)
    return [rng.normal(size=(rows, H)).astype(np.float32)
            for _ in range(n_mb)]


def _fns(n_stage, lib):
    tanh = torch.tanh if lib is torch else jnp.tanh
    mean = torch.mean if lib is torch else jnp.mean

    def mid(p, x):
        return tanh(x @ p["w"] + p["b"])

    def last(p, x):
        return mean(tanh(x @ p["w"] + p["b"]) ** 2)

    return [mid] * (n_stage - 1) + [last]


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _run(n_stage, n_mb, schedule, **kw):
    fns = _fns(n_stage, torch)
    stages = [HostPipelineStage(f, device="cpu") for f in fns]
    return host_pipeline_train_step(
        stages, [_torch(p) for p in _np_params(n_stage)],
        [torch.from_numpy(x) for x in _np_microbatches(n_mb)],
        schedule=schedule, **kw)


def _one_program(n_stage, n_mb):
    """Mean loss and per-stage grads by plain autograd through the
    composed stages."""
    fns = _fns(n_stage, torch)
    params = [{k: v.requires_grad_() for k, v in _torch(p).items()}
              for p in _np_params(n_stage)]
    losses = []
    for x in _np_microbatches(n_mb):
        h = torch.from_numpy(x)
        for i in range(n_stage - 1):
            h = fns[i](params[i], h)
        losses.append(fns[-1](params[-1], h))
    loss = sum(losses) / n_mb
    leaves = [p[k] for p in params for k in ("b", "w")]
    grads = iter(torch.autograd.grad(loss, leaves))
    return float(loss.detach()), [{k: next(grads) for k in ("b", "w")}
                         for _ in range(n_stage)]


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
@pytest.mark.parametrize("n_stage,n_mb", [(2, 4), (4, 8), (4, 3)])
def test_host_pipeline_matches_jax_and_one_program(n_stage, n_mb, schedule):
    """Loss and per-stage gradients against the JAX driver (its stages on
    the first CPU devices) and against one-program autograd — n_mb <
    n_stage (a degenerate warmup) and both schedules included; the loss
    is a 0-d tensor on the last stage's device and every stage's
    gradients stay on its device."""
    loss, grads = _run(n_stage, n_mb, schedule)
    assert loss.dim() == 0 and loss.device.type == "cpu"
    devs = jax.devices()[:n_stage]
    jstages = [JStage(f, device=devs[i])
               for i, f in enumerate(_fns(n_stage, jnp))]
    jloss, jgrads = j_train_step(
        jstages, [jax.tree_util.tree_map(jnp.asarray, p)
                  for p in _np_params(n_stage)],
        [jnp.asarray(x) for x in _np_microbatches(n_mb)], schedule=schedule)
    ref_loss, ref_grads = _one_program(n_stage, n_mb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-6)
    for i in range(n_stage):
        for k in ("w", "b"):
            got = grads[i][k].numpy()
            np.testing.assert_allclose(got, np.asarray(jgrads[i][k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"stage {i} {k} vs JAX")
            np.testing.assert_allclose(got, ref_grads[i][k].numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"stage {i} {k}")


def test_host_pipeline_in_flight_bound_matches_jax():
    """1F1B keeps at most n_stage − i saved inputs on stage i (the last
    stage one), whatever the microbatch count; gpipe holds all n_mb.  The
    per-stage peaks are the JAX driver's on the same schedule."""
    for schedule in ("1f1b", "gpipe"):
        loss, _, stats = _run(4, 12, schedule, return_stats=True)
        assert np.isfinite(float(loss))
        jstages = [JStage(f) for f in _fns(4, jnp)]
        _, _, jstats = j_train_step(
            jstages, [jax.tree_util.tree_map(jnp.asarray, p)
                      for p in _np_params(4)],
            [jnp.asarray(x) for x in _np_microbatches(12, rows=2)],
            schedule=schedule, return_stats=True)
        assert stats == jstats, schedule
        peaks = stats["peak_in_flight_per_stage"]
        if schedule == "1f1b":
            assert all(p <= 4 - i for i, p in enumerate(peaks)), stats
            assert peaks[-1] == 1, stats
        else:
            assert stats["peak_in_flight"] == 12, stats


def test_host_pipeline_rejects_bad_input():
    """Zero microbatches or stages and a params list of the wrong length
    raise the JAX driver's ValueErrors; an unknown schedule raises; the
    stage's device defaults to the card (none here: it raises)."""
    fns = _fns(2, torch)
    stages = [HostPipelineStage(f, device="cpu") for f in fns]
    params = [_torch(p) for p in _np_params(2)]
    with pytest.raises(ValueError, match="microbatch"):
        host_pipeline_train_step(stages, params, [])
    with pytest.raises(ValueError, match="stage"):
        host_pipeline_train_step([], [], [torch.ones((2, H))])
    with pytest.raises(ValueError, match="params_list"):
        host_pipeline_train_step(stages, params[:1], [torch.ones((2, H))])
    with pytest.raises(ValueError, match="unknown schedule"):
        host_pipeline_train_step(stages, params, [torch.ones((2, H))],
                                 schedule="zb")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            HostPipelineStage(fns[0])


class _Short(list):
    """A microbatch list that claims one more microbatch than it holds."""

    def __len__(self):
        return super().__len__() + 1


def test_host_pipeline_stall_raises():
    """When no stage can make progress (here: a microbatch list that
    claims one more microbatch than it yields, so stage 0 waits for a
    backward that never comes) the driver raises its stall error, as the
    JAX driver does on the same input, instead of looping."""
    fns = _fns(2, torch)
    stages = [HostPipelineStage(f, device="cpu") for f in fns]
    params = [_torch(p) for p in _np_params(2)]
    with pytest.raises(RuntimeError, match="host pipeline stalled"):
        host_pipeline_train_step(
            stages, params, _Short([torch.ones((2, H))] * 2))
    jstages = [JStage(f) for f in _fns(2, jnp)]
    with pytest.raises(RuntimeError, match="host pipeline stalled"):
        j_train_step(jstages, [jax.tree_util.tree_map(jnp.asarray, p)
                               for p in _np_params(2)],
                     _Short([jnp.ones((2, H))] * 2))
