"""apex_tpu_torch.transformer.tensor_parallel (counterpart of
apex_tpu.transformer.tensor_parallel): Megatron-style parallel layers,
the region collectives (≡ mappings.py), the vocab-parallel cross
entropy, `broadcast_data`, RNG keys, activation-checkpoint helpers and
the activation arenas of `memory`."""

from apex_tpu_torch.parallel.collectives import (  # noqa: F401  (≡ mappings.py)
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data  # noqa: F401
from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (  # noqa: F401
    RNGStatesTracker,
    checkpoint,
    get_rng_tracker,
    model_parallel_fold_in,
)
