"""Model-parallel-aware grad scaler (counterpart of
apex_tpu/transformer/amp/grad_scaler.py, itself ≡
apex/transformer/amp/grad_scaler.py GradScaler): the only change from a
plain scaler is that `found_inf` is OR-ed over the model-parallel ranks
before the step and update decision, so that a tp or pp rank that
overflows makes every rank of its model replica skip in lockstep.

As in the JAX package the OR runs over the tp and pp axes, not over dp:
the data-parallel replicas see the same averaged gradients, so their
flags already agree.  Each named axis is a MAX all-reduce of a device
flag over that axis's process group (`parallel.mesh.group_of`): a group
of one rank, even a one-rank NCCL group, issues it; no group (a world
of one) is the identity.  No host sync.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp import scaler as scaler_lib
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel.mesh import PP_AXIS, TP_AXIS


def allreduce_found_inf(found_inf, axis_names=(TP_AXIS, PP_AXIS)):
    """The overflow flag OR-ed over each axis of `axis_names` in turn, as
    a bool device scalar (≡ GradScaler._unscale_grads_'s model-parallel
    allreduce, grad_scaler.py:44-55, and the JAX package's `pmax` over
    the same axes)."""
    flag = torch.as_tensor(found_inf, dtype=torch.float32).reshape(1).clone()
    for ax in axis_names:
        flag = M.all_reduce(flag, "max", M.group_of(ax))
    return flag[0] > 0.5


class GradScaler:
    """≡ the JAX package's functional GradScaler facade: `scale`,
    `unscale_and_sync` (unscaled grads and the overflow flag OR-ed over
    the model-parallel axes) and `update`."""

    def __init__(self, init_scale=2.0 ** 16, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000, enabled=True,
                 device=None):
        self.enabled = enabled
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.state = scaler_lib.init("dynamic" if enabled else None,
                                     init_scale=init_scale, device=device)

    def scale(self, loss):
        return scaler_lib.scale_loss(self.state, loss) if self.enabled \
            else loss

    def unscale_and_sync(self, grads, axis_names=(TP_AXIS, PP_AXIS)):
        grads, found_inf = scaler_lib.unscale(self.state, grads)
        return grads, allreduce_found_inf(found_inf, axis_names)

    def update(self, found_inf):
        self.state = scaler_lib.update(
            self.state, found_inf, dynamic=self.enabled,
            growth_interval=self.growth_interval,
            growth_factor=self.growth_factor,
            backoff_factor=self.backoff_factor)
        return self.state
