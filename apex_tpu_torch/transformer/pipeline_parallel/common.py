"""Schedule-independent pipeline helpers (counterpart of
apex_tpu/transformer/pipeline_parallel/common.py:29-159, itself ≡
apex/transformer/pipeline_parallel/schedules/common.py): model-chunk
construction with pre/post-process placement (build_model, 30-149), the
per-microbatch forward and backward steps (253-403), output freeing and
the direct-engine backward (199-250), and the weight-decay grouping
(162).
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Optional, Sequence

import torch

from apex_tpu_torch.parallel import mesh as _mesh
from apex_tpu_torch.transformer.pipeline_parallel.utils import tree_flatten

__all__ = [
    "build_model", "forward_step", "backward_step", "free_output_tensor",
    "custom_backward", "get_params_for_weight_decay_optimization",
]


def build_model(model_provider_func: Callable, wrap_with_ddp: bool = True,
                virtual_pipeline_model_parallel_size: Optional[int] = None,
                stage: Optional[int] = None, *args, **kwargs) -> List[Any]:
    """This pipeline stage's model chunk(s) ≡ build_model
    (schedules/common.py:30-149): `model_provider_func(*args,
    pre_process=..., post_process=..., **kwargs)` once per virtual chunk
    the stage owns; chunk c of stage s is virtual stage c·pp + s, and
    pre_process is True only for virtual stage 0 (the embedding),
    post_process only for the last (the LM head and loss).  Each call
    sets the mesh's virtual-pipeline rank to its chunk first.

    `stage` defaults to this rank's pipeline stage (the JAX package,
    single-controller, defaults to 0).  `wrap_with_ddp` records intent
    only: the data-parallel gradient sync is the train step's.  Virtual
    chunks need pp > 2, as the reference (and the JAX package) assert."""
    pp = _mesh.get_pipeline_model_parallel_world_size()
    if stage is None:
        stage = _mesh.get_pipeline_model_parallel_rank()
    vpp = virtual_pipeline_model_parallel_size
    if vpp is not None and pp <= 2:
        raise ValueError(
            "virtual pipeline parallelism requires pipeline_model_parallel_"
            "size > 2 (≡ schedules/common.py assertion)")
    num_chunks = vpp if vpp is not None else 1
    total_stages = pp * num_chunks
    models = []
    for chunk in range(num_chunks):
        _mesh.set_virtual_pipeline_model_parallel_rank(chunk)
        virtual_stage = chunk * pp + stage
        models.append(model_provider_func(
            *args, pre_process=virtual_stage == 0,
            post_process=virtual_stage == total_stages - 1, **kwargs))
    return models


def forward_step(forward_step_func: Callable, batch, model,
                 input_tensor: Optional[torch.Tensor],
                 num_microbatches: int = 1):
    """One microbatch forward ≡ forward_step (schedules/common.py:253-322).

    `forward_step_func(batch, model) -> (output, loss_func)`, the
    reference contract; a stage that is not first passes its received
    activation as `input_tensor`, which replaces `batch`.  On the last
    stage the loss is divided by num_microbatches, so that the sum of the
    microbatches' losses is their mean.  Returns (output, loss or None)."""
    feed = batch if input_tensor is None else input_tensor
    output, loss_func = forward_step_func(feed, model)
    if loss_func is None:
        return output, None
    return output, loss_func(output) / num_microbatches


def backward_step(forward_fn: Callable, params, inputs,
                  output_grad: Optional[torch.Tensor] = None,
                  grad_scale=None):
    """One microbatch backward ≡ backward_step (schedules/common.py:325-403).

    `forward_fn(params, inputs) -> output` (an activation, or the last
    stage's scalar loss) is run again under autograd and differentiated
    with `torch.autograd.grad`.  The last stage passes output_grad=None:
    the seed is ones, times `grad_scale` when given (the GradScaler
    multiplication the reference applies to the first backward's seed,
    common.py:378-379).  Returns (input_grad, param_grads): input_grad is
    what the previous stage receives (None for integer inputs), and
    param_grads a tree like `params`."""
    leaves, rebuild = tree_flatten(params)
    leaves = [p.detach().requires_grad_(p.is_floating_point())
              for p in leaves]
    x = inputs.detach()
    if x.is_floating_point():
        x.requires_grad_(True)
    with torch.enable_grad():
        output = forward_fn(rebuild(leaves), x)
    if output_grad is None:
        seed = torch.ones_like(output)
        if grad_scale is not None:
            seed = seed * torch.as_tensor(grad_scale, dtype=seed.dtype,
                                          device=seed.device)
    else:
        seed = output_grad
    wrt = [p for p in leaves if p.requires_grad]
    if x.requires_grad:
        wrt.append(x)
    grads = list(torch.autograd.grad(output, wrt, seed, allow_unused=True,
                                     materialize_grads=True))
    input_grad = grads.pop() if x.requires_grad else None
    it = iter(grads)
    return input_grad, rebuild([next(it) if p.requires_grad else None
                                for p in leaves])


def free_output_tensor(output_tensors, deallocate_pipeline_outputs=False):
    """≡ free_output_tensor (schedules/common.py:199-216), a no-op as in
    the JAX package: the schedules drop their references to a clock's
    activations once its backward has run."""
    return output_tensors


def custom_backward(output, grad_output):
    """≡ custom_backward (schedules/common.py:219-250), a direct
    autograd-engine call that skips the freed-buffer check; the JAX
    package raises, and so does the port."""
    raise NotImplementedError(
        "custom_backward is a CUDA-engine workaround; use backward_step "
        "(torch.autograd.grad) in apex_tpu_torch")


def get_params_for_weight_decay_optimization(
        params, no_decay_names: Sequence[str] = ("bias", "norm", "bn",
                                                 "scale", "offset")):
    """A boolean tree over `params` (nested dicts of tensors), True where
    a leaf takes weight decay: the optimizers' `wd_mask` (≡ the JAX
    package's helper, leaf for leaf).  A leaf whose lowercase key path
    holds one of `no_decay_names` gets none (biases, norm parameters);
    any other leaf gets weight decay iff it has two or more dims."""

    def decide(path, tree):
        if isinstance(tree, Mapping):
            return {k: decide(path + (str(k),), v) for k, v in tree.items()}
        p = "/".join(path).lower()
        if any(n in p for n in no_decay_names):
            return False
        return hasattr(tree, "ndim") and tree.ndim >= 2

    return decide((), params)
