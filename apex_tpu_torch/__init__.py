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
  ops         — LayerNorm/RMSNorm forward and backward, the scaled
                (masked, causal) softmax forward and backward, flat Adam
                (uniform and per-tensor), the LAMB phases (per tensor
                and per element) and per-tensor norms, flat SGD and
                Adagrad, the label-smoothed cross entropy and the
                batch-norm channel sums (Triton), paged flash-decode,
                flash attention forward and backward with segment ids,
                and the fused dense GEMM with its bias and activation
                epilogue (CUDA), the fused MLP, and the NHWC max pool
  serve       — paged KV cache + continuous-batching decode engine
  models      — GPT, MoE-GPT, BERT and ResNet: configs, seeded inits,
                the JAX-params converters and the training forwards
  moe         — the Mixture-of-Experts layer: the fp32 top-k router, the
                dense dispatch/combine with the ep all-to-all, MoEMLP
  optimizers  — flat buffers and their checkpoints, FusedAdam,
                FusedLAMB, FusedSGD, FusedAdagrad, FusedNovoGrad and the
                ZeRO-2 DistributedFusedAdam / DistributedFusedLAMB
  amp         — O0–O3 policies, the dynamic loss scaler and
                FP16_Optimizer (with `fp16_utils`, the reference's names)
  parallel    — the (pp, dp[, ep], tp) process groups of `mesh`, the
                region collectives (and the tiled all-to-all) and the
                chunked overlap, the data-parallel
                train step of `ddp` (microbatches, fp32 main grads,
                ZeRO-2), the batch norm of `sync_batchnorm` (statistics
                merged across ranks), LARC, clip_grad and the
                `multiproc` launcher
  contrib     — the xentropy and clip_grad facades
  multi_tensor_apply — one functor over parallel tensor lists
  fused_dense, mlp, normalization — the reference's facades over ops
  transformer — the pp x tp x dp training step, the tensor-parallel
                layers and cross entropy, pipeline_parallel (the p2p
                hops, the clocked schedules, the host-driven 1F1B
                driver, the weight-decay grouping), the microbatch
                calculators, the model-parallel-aware GradScaler of
                `amp` and the attention softmax dispatch of functional
                (FusedScaleMaskSoftmax)
  checkpoint  — the serving fail points (chaos)
  monitor     — the recompile sentry
  tune        — the kernel tuner: the JSON config cache the JAX package
                shares, the lookups, the offline sweep
"""

__version__ = "0.1.0"

_LAZY_SUBMODULES = {"ops", "serve", "models", "optimizers", "transformer",
                    "checkpoint", "monitor", "csrc", "amp", "parallel",
                    "contrib", "multi_tensor_apply", "fused_dense", "mlp",
                    "normalization", "tune", "fp16_utils", "moe"}


def __getattr__(name):
    import importlib

    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f"apex_tpu_torch.{name}")
    raise AttributeError(
        f"module 'apex_tpu_torch' has no attribute {name!r}")
