"""Preemption-proof checkpointing (counterpart of apex_tpu/checkpoint).

Three layers, each reading and writing the JAX package's bytes:

* `legacy`: whole-tree `save_checkpoint` / `load_checkpoint` /
  `latest_step` in the pickle layout, for model weights and small state.
* `sharded` + `manager` + `multihost`: the shard-native format.  Each
  dp rank's ZeRO-2 flat-buffer shard persists as raw bytes under an
  atomically committed manifest; `CheckpointManager` takes the
  device→host copy off the hot path (a background writer thread) and
  `restore_sharded` re-lays a dp=N checkpoint out for dp=M (elastic
  resume; equal topology is bitwise).  Above one rank each rank writes
  its own shard files and rank 0 commits behind the multi-host
  protocol's file barrier.
* `chaos` + `orchestrator`: fail points inside the writer, host-side
  corruption helpers, the `resume_guard`, the `LostRankWatchdog` and
  the `ElasticOrchestrator` that turns a lost rank into a dump, a
  rebuild at the surviving topology and a resume.
"""

from apex_tpu_torch.checkpoint import chaos  # noqa: F401
from apex_tpu_torch.checkpoint import multihost  # noqa: F401
from apex_tpu_torch.checkpoint.legacy import (  # noqa: F401
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from apex_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from apex_tpu_torch.checkpoint.multihost import (  # noqa: F401
    MultihostCommitError,
    save_sharded_multihost,
)
from apex_tpu_torch.checkpoint.orchestrator import (  # noqa: F401
    ElasticOrchestrator,
    EscalationError,
    RetryPolicy,
)
from apex_tpu_torch.checkpoint.sharded import (  # noqa: F401
    CKPT_SCHEMA_VERSION,
    CheckpointError,
    IncompleteCheckpointError,
    LayoutMismatchError,
    latest_committed_step,
    load_model_state,
    pack_model_state,
    read_manifest,
    restore_sharded,
    save_sharded,
    unpack_model_state,
    validate_manifest,
    verify_shards,
)

__all__ = [
    "CKPT_SCHEMA_VERSION",
    "CheckpointError",
    "CheckpointManager",
    "ElasticOrchestrator",
    "EscalationError",
    "IncompleteCheckpointError",
    "LayoutMismatchError",
    "MultihostCommitError",
    "RetryPolicy",
    "chaos",
    "latest_committed_step",
    "latest_step",
    "load_checkpoint",
    "load_model_state",
    "multihost",
    "pack_model_state",
    "read_manifest",
    "restore_sharded",
    "save_checkpoint",
    "save_sharded",
    "save_sharded_multihost",
    "unpack_model_state",
    "validate_manifest",
    "verify_shards",
]
