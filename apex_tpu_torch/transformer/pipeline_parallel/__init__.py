"""apex_tpu_torch.transformer.pipeline_parallel (counterpart of
apex_tpu.transformer.pipeline_parallel, ≡ apex/transformer/
pipeline_parallel): stage-to-stage communication (`p2p_communication`),
the clocked pipeline schedules and the reference-shaped drivers
(`schedules`), the host-driven 1F1B driver (`host_driver`), the
schedule-independent helpers (`common`) and the microbatch utilities
(`utils`)."""

from apex_tpu_torch.transformer.pipeline_parallel.schedules import (  # noqa: F401
    forward_backward_no_pipelining,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
    spmd_pipeline,
)
from apex_tpu_torch.transformer.pipeline_parallel import common  # noqa: F401
from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication  # noqa: F401
from apex_tpu_torch.transformer.pipeline_parallel import utils  # noqa: F401
from apex_tpu_torch.transformer.pipeline_parallel.common import (  # noqa: F401
    build_model,
    get_params_for_weight_decay_optimization,
)
from apex_tpu_torch.transformer.pipeline_parallel.host_driver import (  # noqa: F401
    HostPipelineStage,
    host_pipeline_train_step,
)
