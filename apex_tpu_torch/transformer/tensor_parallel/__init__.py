"""apex_tpu_torch.transformer.tensor_parallel — the tensor-parallel layers
and cross entropy at tp=1 (counterpart of
apex_tpu.transformer.tensor_parallel)."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
