"""apex_tpu_torch.contrib — optional fused components (counterpart of
apex_tpu.contrib; so far the xentropy and clip_grad facades)."""


def __getattr__(name):
    import importlib

    if name in ("xentropy", "clip_grad"):
        return importlib.import_module(f"apex_tpu_torch.contrib.{name}")
    raise AttributeError(name)
