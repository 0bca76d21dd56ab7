"""FP16_Optimizer — the manual master-weight optimizer facade (counterpart
of apex_tpu/amp/fp16_optimizer.py, itself ≡ apex.fp16_utils.FP16_Optimizer).

The fused optimizers already keep their flat master buffer (fp32, or
`master_dtype`), so this class is the workflow around one: scale the
loss, (the caller's backward), unscale the grads and check them for
overflow, optionally clip them by their global norm, take the masked
step (the optimizer keeps its state when `found_inf`) and update the
loss scaler.  The scaler's state is a few device tensors and the
overflow flag stays on the device: a step makes no host sync
(`loss_scale` and `state_dict` read the card, outside the step).

The flight recorder's tap arguments and the metrics plane come with the
monitor port (ROADMAP Queue 1 item 23) and raise until then.
"""

from __future__ import annotations

from typing import Optional

from apex_tpu_torch.amp import scaler as scaler_lib
from apex_tpu_torch.parallel.clip_grad import clip_grad_norm


class FP16_Optimizer:
    """opt = FP16_Optimizer(FusedAdam(...), dynamic_loss_scale=True);
    state = opt.init(params); loss = opt.scale_loss(loss); (backward);
    params, state = opt.step(state, grads[, lr=, max_grad_norm=])."""

    def __init__(self, init_optimizer, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = False, device=None):
        self.optimizer = init_optimizer
        self.dynamic = dynamic_loss_scale
        self.device = device
        self.scaler_state = scaler_lib.init(
            "dynamic" if dynamic_loss_scale else static_loss_scale,
            device=device)
        self.clip_grad_norm_value = None

    @property
    def loss_scale(self):
        """The current loss scale, a host float (reads the card)."""
        return float(self.scaler_state.scale)

    def init(self, params):
        return self.optimizer.init(params)

    def scale_loss(self, loss):
        """≡ FP16_Optimizer.backward's loss · scale (the backward itself
        is the caller's)."""
        return scaler_lib.scale_loss(self.scaler_state, loss)

    def step(self, state, grads, lr=None, max_grad_norm=None, metrics=None,
             metrics_count_step: bool = True, tap_state=None,
             tap_names=None):
        """Unscale, (optionally clip), masked step, update the scaler.
        Returns (params, state)."""
        if metrics is not None or tap_state is not None \
                or tap_names is not None:
            raise NotImplementedError(
                "the metrics plane and the flight recorder's taps come "
                "with the monitor port, ROADMAP Queue 1 item 23")
        grads, found_inf = scaler_lib.unscale(self.scaler_state, grads)
        if max_grad_norm:
            grads, _ = clip_grad_norm(grads, max_grad_norm)
        params, new_state = self.optimizer.step(state, grads, lr=lr,
                                                found_inf=found_inf)
        self.scaler_state = scaler_lib.update(
            self.scaler_state, found_inf, dynamic=self.dynamic)
        return params, new_state

    def overflow_provenance(self):
        raise NotImplementedError(
            "overflow provenance reads the flight recorder, which comes "
            "with the monitor port, ROADMAP Queue 1 item 23")

    def state_dict(self, state):
        """The inner optimizer's state dict (its masters included) and
        the scaler's (≡ FP16_Optimizer.state_dict)."""
        return {"optimizer": self.optimizer.state_dict(state),
                "loss_scaler": scaler_lib.state_dict(self.scaler_state)}

    def load_state_dict(self, d):
        self.scaler_state = scaler_lib.load_state_dict(d["loss_scaler"],
                                                       device=self.device)
        return self.optimizer.load_state_dict(d["optimizer"])
