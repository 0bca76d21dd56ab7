"""apex_tpu_torch.parallel — distributed utilities (counterpart of
apex_tpu.parallel): the process groups of `mesh` (data, tensor,
pipeline and expert parallelism), the Megatron region collectives and
the tiled all-to-all of `collectives`, the chunked compute/collective
overlap of `overlap`, ring attention and Ulysses of `context_parallel`,
the data-parallel train step and gradient sync of
`ddp`, the batch norm of `sync_batchnorm` (statistics merged across a
process group), the `larc` optimizer wrapper, `clip_grad` and the
`multiproc` launcher."""

_LAZY = {"ddp", "sync_batchnorm", "larc", "clip_grad", "mesh", "multiproc",
         "collectives", "overlap", "context_parallel"}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        return importlib.import_module(f"apex_tpu_torch.parallel.{name}")
    if name == "LARC":
        return importlib.import_module("apex_tpu_torch.parallel.larc").LARC
    raise AttributeError(name)
