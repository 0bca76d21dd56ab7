"""Model-parallel-aware grad scaler (counterpart of
apex_tpu/transformer/amp/grad_scaler.py, itself ≡
apex/transformer/amp/grad_scaler.py GradScaler): the only change from a
plain scaler is that `found_inf` is OR-ed over the ranks before the
step and update decision, so that a rank that overflows makes every
rank skip in lockstep.

The JAX package ORs over the tp and pp mesh axes.  At tp = pp = 1, all
the port has, the reduction runs over the torch.distributed world (a
MAX all-reduce of a device flag, no host sync), or is the identity
without one.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp import scaler as scaler_lib
from apex_tpu_torch.parallel import mesh as M


def allreduce_found_inf(found_inf):
    """The overflow flag OR-ed over the world (the dp group at tp = pp =
    1), as a bool device scalar (≡ GradScaler._unscale_grads_'s
    allreduce, grad_scaler.py:44-55)."""
    group = M.data_parallel_group()
    flag = torch.as_tensor(found_inf, dtype=torch.float32).reshape(1).clone()
    return M.all_reduce(flag, "max", group)[0] > 0.5


class GradScaler:
    """≡ the JAX package's functional GradScaler facade: `scale`,
    `unscale_and_sync` (unscaled grads and the group-wide overflow flag)
    and `update`."""

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

    def unscale_and_sync(self, grads):
        grads, found_inf = scaler_lib.unscale(self.state, grads)
        return grads, allreduce_found_inf(found_inf)

    def update(self, found_inf):
        self.state = scaler_lib.update(
            self.state, found_inf, dynamic=self.enabled,
            growth_interval=self.growth_interval,
            growth_factor=self.growth_factor,
            backoff_factor=self.backoff_factor)
        return self.state
