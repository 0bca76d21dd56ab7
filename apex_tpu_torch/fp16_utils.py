"""apex_tpu_torch.fp16_utils — the manual fp16/bf16 master-weight tools
(counterpart of apex_tpu/fp16_utils.py, itself ≡ apex.fp16_utils): the
mechanisms live in `apex_tpu_torch.amp` (policies and the scaler's
device-tensor state); this module gives them the reference's names.

  network_to_half / convert_network  ≡ fp16util.py:35-72
  prep_param_lists                   ≡ fp16util.py:92
  model_grads_to_master_grads        ≡ fp16util.py:138
  master_params_to_model_params      ≡ fp16util.py:160
  FP16_Optimizer                     ≡ fp16_optimizer.py:13
  LossScaler / DynamicLossScaler     ≡ loss_scaler.py:10,49
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp import scaler as _scaler
from apex_tpu_torch.amp.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.amp.policy import (
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    prep_param_lists,
)

__all__ = [
    "network_to_half", "convert_network", "prep_param_lists",
    "model_grads_to_master_grads", "master_params_to_model_params",
    "FP16_Optimizer", "LossScaler", "DynamicLossScaler", "to_python_float",
]


def network_to_half(params, dtype=torch.float16):
    """≡ network_to_half: every floating leaf to half, norm params kept
    fp32 (recognized by name, as in convert_network)."""
    return convert_network(params, dtype)


def to_python_float(x):
    """≡ to_python_float: a host float (reads the card for a device
    tensor)."""
    if isinstance(x, torch.Tensor):
        return float(x.reshape(()).item())
    return float(x)


class LossScaler:
    """Static loss scaler ≡ apex/fp16_utils/loss_scaler.py:10-46, an
    object over the functional `amp.scaler` state."""

    dynamic = False

    def __init__(self, scale=1.0, device=None):
        self.state = _scaler.init(float(scale), device=device)

    @property
    def loss_scale(self):
        return float(self.state.scale)

    def scale_loss(self, loss):
        return _scaler.scale_loss(self.state, loss)

    def unscale(self, grads):
        return _scaler.unscale(self.state, grads)

    def update_scale(self, overflow):
        self.state = _scaler.update(self.state, overflow,
                                    dynamic=self.dynamic)


class DynamicLossScaler(LossScaler):
    """≡ apex/fp16_utils/loss_scaler.py:49-118: the scale grows by
    `scale_factor` after `scale_window` finite steps and falls by it on
    an overflow."""

    dynamic = True

    def __init__(self, init_scale=2.0 ** 32, scale_factor=2.0,
                 scale_window=1000, device=None):
        self.state = _scaler.init("dynamic", init_scale=float(init_scale),
                                  device=device)
        self.scale_factor = scale_factor
        self.scale_window = scale_window

    def update_scale(self, overflow):
        self.state = _scaler.update(
            self.state, overflow, dynamic=True,
            growth_interval=self.scale_window,
            growth_factor=self.scale_factor,
            backoff_factor=1.0 / self.scale_factor)
