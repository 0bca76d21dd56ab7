"""≡ apex.contrib.optimizers (counterpart of apex_tpu/contrib/optimizers.py):
the distributed (ZeRO) optimizers and the contrib Fused* aliases."""

from apex_tpu_torch.amp.fp16_optimizer import FP16_Optimizer  # noqa: F401
from apex_tpu_torch.optimizers.distributed_fused_adam import (  # noqa: F401
    DistributedFusedAdam,
    DistributedFusedLAMB,
)
from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB  # noqa: F401
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD  # noqa: F401
