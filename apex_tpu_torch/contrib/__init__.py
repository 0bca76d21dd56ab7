"""apex_tpu_torch.contrib — optional fused components (counterpart of
apex_tpu.contrib; so far the xentropy facade)."""


def __getattr__(name):
    import importlib

    if name == "xentropy":
        return importlib.import_module("apex_tpu_torch.contrib.xentropy")
    raise AttributeError(name)
