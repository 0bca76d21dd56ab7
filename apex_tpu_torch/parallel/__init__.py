"""apex_tpu_torch.parallel — data-parallel utilities (counterpart of
apex_tpu.parallel; so far the single-device train step of `ddp` and the
batch norm of `sync_batchnorm`, whose cross-rank halves come with
multi-GPU data parallelism, ROADMAP Queue 1 item 12)."""

_LAZY = {"ddp", "sync_batchnorm"}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        return importlib.import_module(f"apex_tpu_torch.parallel.{name}")
    raise AttributeError(name)
