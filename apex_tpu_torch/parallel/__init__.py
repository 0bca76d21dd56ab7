"""apex_tpu_torch.parallel — data-parallel utilities (counterpart of
apex_tpu.parallel): the process groups of `mesh` (data parallelism; tp,
pp, cp and ep come with later ROADMAP items), the data-parallel train
step and gradient sync of `ddp`, the batch norm of `sync_batchnorm`
(statistics merged across a process group), the `larc` optimizer
wrapper, `clip_grad` and the `multiproc` launcher."""

_LAZY = {"ddp", "sync_batchnorm", "larc", "clip_grad", "mesh", "multiproc"}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        return importlib.import_module(f"apex_tpu_torch.parallel.{name}")
    if name == "LARC":
        return importlib.import_module("apex_tpu_torch.parallel.larc").LARC
    raise AttributeError(name)
