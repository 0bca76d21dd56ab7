"""apex_tpu_torch.transformer.amp — the model-parallel-aware grad scaler
(counterpart of apex_tpu.transformer.amp)."""

from apex_tpu_torch.transformer.amp.grad_scaler import (  # noqa: F401
    GradScaler,
    allreduce_found_inf,
)
