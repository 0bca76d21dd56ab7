"""apex_tpu_torch.transformer.pipeline_parallel — so far only the
weight-decay grouping helper of `common` (counterpart of
apex_tpu.transformer.pipeline_parallel; the schedules come with the
model-parallel slice)."""

from apex_tpu_torch.transformer.pipeline_parallel.common import (  # noqa: F401
    get_params_for_weight_decay_optimization,
)
