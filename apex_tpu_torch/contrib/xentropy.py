"""≡ apex.contrib.xentropy (counterpart of apex_tpu/contrib/xentropy.py):
re-export of the fused label-smoothed softmax cross entropy."""

from apex_tpu_torch.ops.xentropy import (  # noqa: F401
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy_loss,
)
