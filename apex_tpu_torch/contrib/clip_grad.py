"""≡ apex.contrib.clip_grad (counterpart of apex_tpu/contrib/clip_grad.py):
re-export of the global-norm clip_grad_norm."""

from apex_tpu_torch.parallel.clip_grad import (  # noqa: F401
    clip_grad_norm,
    clip_grad_norm_,
)
