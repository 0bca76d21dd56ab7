"""apex_tpu_torch.transformer — Megatron-style tensor, sequence and
pipeline parallelism (counterpart of apex_tpu.transformer):
parallel_state (here `apex_tpu_torch.parallel.mesh`), `tensor_parallel`
(the layers, the region collectives, the vocab-parallel cross entropy,
RNG keys), `pipeline_parallel` (the p2p hops, the clocked schedules, the
host-driven 1F1B driver, the microbatch utilities, the weight-decay
grouping), the microbatch calculators of `microbatches`, `layers` (the
sequence-parallel LayerNorm), the pp x tp x dp training step of
`training`, the attention softmax dispatch of `functional` and the
model-parallel-aware GradScaler of `amp`."""

from apex_tpu_torch.parallel import mesh as parallel_state  # noqa: F401


def __getattr__(name):
    import importlib

    if name in ("tensor_parallel", "pipeline_parallel", "functional",
                "layers", "training", "amp", "microbatches"):
        return importlib.import_module(f"apex_tpu_torch.transformer.{name}")
    raise AttributeError(name)
