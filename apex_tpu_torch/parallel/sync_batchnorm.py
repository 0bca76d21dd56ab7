"""Batch normalization with statistics merged across a process group
(counterpart of apex_tpu/parallel/sync_batchnorm.py, itself ≡
apex.parallel.SyncBatchNorm and `convert_syncbn_model`).

Statistics come from `ops.welford` (the per-channel sums kernel) and are
merged across `process_group` by `merge_stats` (one all-reduce; without
a group the batch norm is local, as the JAX package's is without an
axis name).  The gradient flows through the batch mean and variance by
autograd, across the ranks through the all-reduce, as JAX
differentiates through its psum.
Running statistics take the batch mean and the *unbiased* variance.

Layout is channels-last (NHWC, `channel_axis=-1`), as in the JAX
package: the (rows, C) view the sums kernel reads is then free.  The
normalisation runs in fp32 and the result returns in x's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.ops import welford


def sync_batch_norm(x, scale, bias, running_mean, running_var, *,
                    training: bool = True, momentum: float = 0.1,
                    eps: float = 1e-5, process_group=None,
                    channel_axis: int = -1):
    """Functional SyncBN (≡ the JAX package's `sync_batch_norm`).  Returns
    (y, new_running_mean, new_running_var); the running statistics come
    back as new tensors, detached."""
    chan = channel_axis % x.ndim
    reduce_axes = tuple(a for a in range(x.ndim) if a != chan)
    if training:
        mean, var, count = welford.batch_stats(x, reduce_axes)
        mean, var, count = welford.merge_stats(mean, var, count,
                                               process_group)
        if isinstance(count, torch.Tensor):     # merged: a device count
            unbiased = var.detach() * count / torch.clamp_min(count - 1.0,
                                                              1.0)
        else:
            count = float(count)
            unbiased = var.detach() * count / max(count - 1.0, 1.0)
        new_rm = (1 - momentum) * running_mean + momentum * mean.detach()
        new_rv = (1 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var

    shape = [1] * x.ndim
    shape[chan] = x.shape[chan]
    y = (x.float() - mean.reshape(shape)) * torch.rsqrt(var + eps).reshape(
        shape)
    if scale is not None:
        y = y * scale.float().reshape(shape)
    if bias is not None:
        y = y + bias.float().reshape(shape)
    return y.to(x.dtype), new_rm, new_rv


class SyncBatchNorm(nn.Module):
    """Module facade (≡ the JAX package's `SyncBatchNorm`).

    `forward(x)` normalises with the module's own `scale`/`bias`
    parameters and updates its `running_mean`/`running_var` buffers in
    training mode.  `init()` and `apply(params, state, x, training)` are
    the JAX package's functional form: params {"scale", "bias"}, state
    {"running_mean", "running_var"}."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, process_group=None,
                 channel_axis: int = -1, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.process_group = process_group
        self.channel_axis = channel_axis
        params, state = self.init(device=device, dtype=dtype)
        if affine:
            self.scale = nn.Parameter(params["scale"])
            self.bias = nn.Parameter(params["bias"])
        else:
            self.register_parameter("scale", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", state["running_mean"])
        self.register_buffer("running_var", state["running_var"])

    def init(self, device=None, dtype=torch.float32):
        c = self.num_features
        params = {}
        if self.affine:
            params = {"scale": torch.ones(c, dtype=dtype, device=device),
                      "bias": torch.zeros(c, dtype=dtype, device=device)}
        state = {"running_mean": torch.zeros(c, device=device),
                 "running_var": torch.ones(c, device=device)}
        return params, state

    def apply(self, params, state, x, training: bool = True,
              process_group: Optional[object] = "__unset__"):
        pg = self.process_group if process_group == "__unset__" \
            else process_group
        y, rm, rv = sync_batch_norm(
            x, params.get("scale") if self.affine else None,
            params.get("bias") if self.affine else None,
            state["running_mean"], state["running_var"],
            training=training, momentum=self.momentum, eps=self.eps,
            process_group=pg, channel_axis=self.channel_axis)
        return y, {"running_mean": rm, "running_var": rv}

    def forward(self, x):
        y, rm, rv = sync_batch_norm(
            x, self.scale, self.bias, self.running_mean, self.running_var,
            training=self.training, momentum=self.momentum, eps=self.eps,
            process_group=self.process_group,
            channel_axis=self.channel_axis)
        if self.training and self.track_running_stats:
            with torch.no_grad():
                self.running_mean.copy_(rm)
                self.running_var.copy_(rv)
        return y


def convert_syncbn_model(module, process_group):
    """Give every SyncBatchNorm inside `module` (an nn.Module tree) the
    process group (≡ the JAX package's `convert_syncbn_model`, which sets
    the DP axis name).  Returns the module."""
    for m in module.modules():
        if isinstance(m, SyncBatchNorm):
            m.process_group = process_group
    return module
