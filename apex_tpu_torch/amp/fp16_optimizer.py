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

`step(metrics=)` folds the loss scale, the pre-clip grad norm, the
overflow/skip counts and the master param/update norms into a
`monitor.MetricsState` on the device; `step(tap_state=, tap_names=)`
keeps the iteration's flight-recorder taps so `overflow_provenance()`
names the tap an overflow skip came from.
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
        # the last step's tap snapshot (device tensors, fetched only
        # when provenance is asked for)
        self._last_tap_state = None
        self._last_tap_names = None

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
        Returns (params, state), or (params, state, new_metrics) when a
        `monitor.MetricsState` is passed: the loss scale used, the
        unscaled PRE-clip grad norm, the overflow/skip counts and the
        master param/update norms fold in on the device (this facade
        holds no loss, so that field carries over).  Pass
        metrics_count_step=False when another hook (e.g.
        forward_backward_no_pipelining) already counts the iteration.

        tap_state / tap_names: the iteration's `monitor.trace.TapState`
        and tap labels (from the tapped backward that produced `grads`),
        kept for `overflow_provenance()`; no sync unless it is asked.

        `metrics` that is not a MetricsState raises TypeError before
        anything is touched (the step updates its buffers in place)."""
        if metrics is not None:
            from apex_tpu_torch.monitor import metrics as _mon
            _mon.require_metrics_state(metrics, "FP16_Optimizer.step")
        self._last_tap_state = tap_state
        if tap_names is not None:
            self._last_tap_names = tuple(tap_names)
        scale_used = self.scaler_state.scale
        grads, found_inf = scaler_lib.unscale(self.scaler_state, grads)
        # telemetry wants the PRE-clip norm: a clipped norm pins at the
        # threshold and never shows the spike clipping tames
        grads_preclip = grads
        if max_grad_norm:
            grads, _ = clip_grad_norm(grads, max_grad_norm)
        p_old = None
        if metrics is not None and getattr(state, "params", None) is not None:
            p_old = state.params.clone()   # the step updates in place
        params, new_state = self.optimizer.step(state, grads, lr=lr,
                                                found_inf=found_inf)
        self.scaler_state = scaler_lib.update(
            self.scaler_state, found_inf, dynamic=self.dynamic)
        if metrics is None:
            return params, new_state
        new_metrics = _mon.update_metrics(
            metrics, grads=grads_preclip,  # unscaled, pre-clip
            params_flat=p_old,
            new_params_flat=getattr(new_state, "params", None),
            loss_scale=scale_used, found_inf=found_inf,
            count_step=metrics_count_step)
        return params, new_state, new_metrics

    def overflow_provenance(self):
        """Which tap tripped on the last step (None when the last step
        carried no tap state or both planes were clean): one fetch;
        `monitor.trace.provenance`'s dict {"plane", "tap", "index",
        "stats"} — for a loss-scaling overflow the gradient plane names
        the tap nearest the loss where non-finite values entered the
        backward."""
        if self._last_tap_state is None:
            return None
        from apex_tpu_torch.monitor.trace import taps as _trc
        return _trc.provenance(self._last_tap_state,
                               self._last_tap_names or ())

    def state_dict(self, state):
        """The inner optimizer's state dict (its masters included) and
        the scaler's (≡ FP16_Optimizer.state_dict)."""
        return {"optimizer": self.optimizer.state_dict(state),
                "loss_scaler": scaler_lib.state_dict(self.scaler_state)}

    def load_state_dict(self, d):
        self.scaler_state = scaler_lib.load_state_dict(d["loss_scaler"],
                                                       device=self.device)
        return self.optimizer.load_state_dict(d["optimizer"])
