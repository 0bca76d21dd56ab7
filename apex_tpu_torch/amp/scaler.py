"""Dynamic loss scaling as a function of a small device-tensor state
(counterpart of apex_tpu/amp/scaler.py, itself ≡ apex.amp.scaler.
LossScaler).

The state is three 0-d tensors on the training device.  `update` runs
every step and is branch-free (`torch.where`, no `.item()`): on an
overflow the scale backs off and the optimizer keeps its state (its
kernels take `found_inf` as a device scalar), after `growth_interval`
clean steps the scale grows.  Nothing here reads a value back to the
host, so a step that uses it makes no host sync; `state_dict` does,
once, outside the step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from apex_tpu_torch.amp.policy import _map_with_path
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.optimizer_kernels import device_scalar
from apex_tpu_torch.optimizers.flat import tree_leaves


class LossScalerState(NamedTuple):
    scale: torch.Tensor           # fp32 scalar, the current loss scale
    growth_tracker: torch.Tensor  # int32 scalar, clean steps since a change
    found_inf: torch.Tensor       # bool scalar, the last step's overflow


def init(loss_scale="dynamic", init_scale=2.0 ** 16,
         device=None) -> LossScalerState:
    """≡ the JAX package's `init`: "dynamic" starts at `init_scale`; a
    float is a static scale (no growth or backoff); None is 1.  On
    `device`, the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    if loss_scale == "dynamic":
        scale = init_scale
    else:
        scale = float(loss_scale) if loss_scale is not None else 1.0
    return LossScalerState(
        scale=torch.full((), scale, dtype=torch.float32, device=dev),
        growth_tracker=torch.zeros((), dtype=torch.int32, device=dev),
        found_inf=torch.zeros((), dtype=torch.bool, device=dev))


def scale_loss(state: LossScalerState, loss):
    """loss.float() · scale."""
    return loss.float() * state.scale


def check_finite(grads) -> torch.Tensor:
    """True (a bool device scalar) when any element of the grads is inf
    or NaN.  `grads` is one tensor (a flat buffer, whose zero padding
    changes nothing) or a tree of them."""
    leaves = [grads] if isinstance(grads, torch.Tensor) else \
        tree_leaves(grads)
    if not leaves:
        return torch.zeros((), dtype=torch.bool)
    flags = [~torch.isfinite(g).all() for g in leaves]
    return torch.stack(flags).any()


def unscale(state: LossScalerState, grads):
    """(grads / scale, found_inf) over a tree of grads."""
    inv = 1.0 / state.scale
    unscaled = _map_with_path(lambda _, g: g * inv.to(g.dtype), grads)
    return unscaled, check_finite(grads)


def update(state: LossScalerState, found_inf, dynamic: bool = True,
           growth_interval: int = 2000, growth_factor: float = 2.0,
           backoff_factor: float = 0.5, min_scale: float = 1.0,
           max_scale: float = 2.0 ** 24) -> LossScalerState:
    """≡ the JAX package's branch-free `update`: on overflow scale ·=
    backoff (at least `min_scale`) and the tracker resets; after
    `growth_interval` clean steps scale ·= growth (at most `max_scale`)
    and the tracker resets."""
    found = device_scalar(found_inf, torch.bool, state.scale.device)
    if not dynamic:
        return state._replace(found_inf=found)
    tracker = torch.where(found, 0, state.growth_tracker + 1)
    grow = tracker >= growth_interval
    scale = torch.where(
        found,
        torch.clamp_min(state.scale * backoff_factor, min_scale),
        torch.where(grow, torch.clamp_max(state.scale * growth_factor,
                                          max_scale), state.scale))
    tracker = torch.where(grow, 0, tracker).to(torch.int32)
    return LossScalerState(scale=scale, growth_tracker=tracker,
                           found_inf=found)


def state_dict(state: LossScalerState) -> dict:
    """≡ apex.amp.state_dict: host numbers (reads the card once)."""
    return {"loss_scale": state.scale.item(),
            "unskipped": int(state.growth_tracker.item())}


def load_state_dict(d: dict, device=None) -> LossScalerState:
    """≡ apex.amp.load_state_dict, onto `device` (the card unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    return LossScalerState(
        scale=torch.full((), d["loss_scale"], dtype=torch.float32,
                         device=dev),
        growth_tracker=torch.full((), d["unskipped"], dtype=torch.int32,
                                  device=dev),
        found_inf=torch.zeros((), dtype=torch.bool, device=dev))
