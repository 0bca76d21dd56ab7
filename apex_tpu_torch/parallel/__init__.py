"""apex_tpu_torch.parallel — data-parallel utilities (counterpart of
apex_tpu.parallel; so far the single-device train step of `ddp`, the
batch norm of `sync_batchnorm`, whose cross-rank halves come with
multi-GPU data parallelism, ROADMAP Queue 1 item 12, the `larc`
optimizer wrapper and `clip_grad`)."""

_LAZY = {"ddp", "sync_batchnorm", "larc", "clip_grad"}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        return importlib.import_module(f"apex_tpu_torch.parallel.{name}")
    if name == "LARC":
        return importlib.import_module("apex_tpu_torch.parallel.larc").LARC
    raise AttributeError(name)
