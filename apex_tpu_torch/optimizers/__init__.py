"""apex_tpu_torch.optimizers — flat-buffer optimizers (counterpart of
apex_tpu.optimizers; FusedAdam, FusedLAMB, FusedSGD and the flat
mapping so far)."""

from apex_tpu_torch.optimizers.flat import (  # noqa: F401
    FlatSpec,
    flatten,
    make_spec,
    unflatten,
)
from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    FusedAdam,
    FusedAdamState,
)
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedLAMBState,
    FusedMixedPrecisionLamb,
)
from apex_tpu_torch.optimizers.fused_sgd import (  # noqa: F401
    FusedSGD,
    FusedSGDState,
)
