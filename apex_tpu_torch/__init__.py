"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu for NVIDIA Hopper.

The JAX package `apex_tpu` is the reference; this package mirrors its
module paths and public names (`apex_tpu_torch/serve/engine.py` is the
counterpart of `apex_tpu/serve/engine.py`, and so on) and never imports
it or JAX.  Every Pallas kernel on a ported path is a hand-written
Hopper kernel here (CUDA C++ under `csrc/`, or Triton), with a plain
PyTorch version beside it in the same module: a CPU tensor runs the
plain version, a CUDA tensor runs the kernel or raises.

Entry points run on the card unless the caller passes `device="cpu"`.
Importing the package builds nothing: kernels are compiled from the
sources in the checkout at their first launch.

Subpackages (lazily importable):
  ops         — LayerNorm/RMSNorm forward and backward and flat Adam
                (Triton), paged flash-decode and flash attention
                forward and backward (CUDA)
  serve       — paged KV cache + continuous-batching decode engine
  models      — GPT: config, seeded init, the JAX-params converter and
                the training forward
  optimizers  — flat buffers and FusedAdam
  transformer — the single-device training step and the
                tensor-parallel layers and cross entropy at tp=1
  checkpoint  — the serving fail points (chaos)
  monitor     — the recompile sentry
"""

__version__ = "0.1.0"

_LAZY_SUBMODULES = {"ops", "serve", "models", "optimizers", "transformer",
                    "checkpoint", "monitor", "csrc"}


def __getattr__(name):
    import importlib

    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f"apex_tpu_torch.{name}")
    raise AttributeError(
        f"module 'apex_tpu_torch' has no attribute {name!r}")
