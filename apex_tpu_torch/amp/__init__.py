"""apex_tpu_torch.amp — mixed precision: policies and dynamic loss
scaling (counterpart of apex_tpu.amp, itself ≡ apex.amp and the
apex.fp16_utils helpers).

An explicit `Policy` applied where the train step casts, and a loss
scaler whose state is a few device tensors; `parallel.ddp.
make_train_step` takes the `AmpState` this module builds.  Under O2 the
step runs low-precision params with the norm leaves kept fp32, and the
optimizer's flat buffer in its master dtype is the master copy; the
manual workflow's optimizer facade is `amp.fp16_optimizer.FP16_Optimizer`
(with the reference's names in `apex_tpu_torch.fp16_utils`).
"""

from __future__ import annotations

import dataclasses

import torch

from apex_tpu_torch.amp import scaler
from apex_tpu_torch.amp.policy import (  # noqa: F401
    FP32_CLASS_OPS,
    MATMUL_CLASS_OPS,
    Policy,
    convert_network,
    get_policy,
    master_params_to_model_params,
    model_grads_to_master_grads,
    prep_param_lists,
)
from apex_tpu_torch.amp.scaler import LossScalerState  # noqa: F401

__all__ = [
    "Policy", "get_policy", "initialize", "AmpState", "scaler",
    "LossScalerState", "convert_network", "prep_param_lists",
    "model_grads_to_master_grads", "master_params_to_model_params",
    "MATMUL_CLASS_OPS", "FP32_CLASS_OPS", "scale_loss",
    "unscale_and_update", "state_dict", "load_state_dict",
]


@dataclasses.dataclass
class AmpState:
    """Policy plus one loss-scaler state per loss (≡ the JAX package's
    `AmpState`)."""

    policy: Policy
    loss_scalers: list

    @property
    def dynamic(self) -> bool:
        return self.policy.loss_scale == "dynamic"


def initialize(params=None, opt_level: str = "O1", num_losses: int = 1,
               low_dtype=torch.bfloat16, device=None, **overrides):
    """≡ the JAX package's `initialize` (apex.amp.initialize).  Returns
    AmpState, or (cast_params, AmpState) when given params: O2/O3 cast
    the param tree (O2 keeps norm params fp32), O0/O1 leave it fp32.
    The scaler states live on `device`: the card unless the caller asks
    for the CPU."""
    policy = get_policy(opt_level, low_dtype=low_dtype, **overrides)
    if params is not None and policy.param_dtype != torch.float32:
        if policy.keep_norm_fp32:
            params = convert_network(params, policy.param_dtype)
        else:
            params = policy.cast_to_param(params)
    scalers = [scaler.init(policy.loss_scale, device=device)
               for _ in range(num_losses)]
    state = AmpState(policy=policy, loss_scalers=scalers)
    if params is None:
        return state
    return params, state


def scale_loss(state: AmpState, loss, loss_id: int = 0):
    """≡ the entry of apex's `with amp.scale_loss(...)`."""
    return scaler.scale_loss(state.loss_scalers[loss_id], loss)


def unscale_and_update(state: AmpState, grads, loss_id: int = 0):
    """Unscale a grad tree, check for overflow, update that loss's
    scaler.  Returns (unscaled_grads, found_inf, new_state); the caller
    hands found_inf to the optimizer, which then keeps its state."""
    s = state.loss_scalers[loss_id]
    grads, found_inf = scaler.unscale(s, grads)
    scalers = list(state.loss_scalers)
    scalers[loss_id] = scaler.update(s, found_inf, dynamic=state.dynamic)
    return grads, found_inf, AmpState(policy=state.policy,
                                      loss_scalers=scalers)


def state_dict(state: AmpState) -> dict:
    """≡ apex.amp.state_dict."""
    return {f"loss_scaler{i}": scaler.state_dict(s)
            for i, s in enumerate(state.loss_scalers)}


def load_state_dict(state: AmpState, d: dict, device=None) -> AmpState:
    """≡ apex.amp.load_state_dict, the scalers onto `device`."""
    scalers = [scaler.load_state_dict(d[f"loss_scaler{i}"], device=device)
               for i in range(len(state.loss_scalers))]
    return AmpState(policy=state.policy, loss_scalers=scalers)
