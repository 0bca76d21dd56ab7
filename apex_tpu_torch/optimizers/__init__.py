"""apex_tpu_torch.optimizers — flat-buffer optimizers (counterpart of
apex_tpu.optimizers): FusedAdam, FusedLAMB, FusedSGD, FusedAdagrad,
FusedNovoGrad and the flat mapping; DistributedFusedAdam is still to
port."""

from apex_tpu_torch.optimizers.flat import (  # noqa: F401
    FlatSpec,
    flatten,
    make_spec,
    unflatten,
)
from apex_tpu_torch.optimizers.fused_adagrad import (  # noqa: F401
    FusedAdagrad,
    FusedAdagradState,
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
from apex_tpu_torch.optimizers.fused_novograd import (  # noqa: F401
    FusedNovoGrad,
    FusedNovoGradState,
)
from apex_tpu_torch.optimizers.fused_sgd import (  # noqa: F401
    FusedSGD,
    FusedSGDState,
)
