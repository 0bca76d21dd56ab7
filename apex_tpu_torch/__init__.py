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
  ops         — LayerNorm/RMSNorm forward and backward, flat Adam and
                the LAMB phases and per-tensor norms (Triton), paged
                flash-decode and flash attention forward and backward,
                with segment ids (CUDA)
  serve       — paged KV cache + continuous-batching decode engine
  models      — GPT and BERT: configs, seeded inits, the JAX-params
                converter and the training forwards
  optimizers  — flat buffers, FusedAdam and FusedLAMB
  transformer — the single-device training step, the tensor-parallel
                layers and cross entropy at tp=1, and the weight-decay
                grouping of pipeline_parallel.common
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
