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
  contrib     — the JAX package's contrib modules: multihead_attn and
                fmha over the flash kernels (masks as segment ids or an
                additive bias), groupbn, bottleneck and peer_memory
                (halo exchange), focal_loss, index_mul_2d, transducer,
                sparsity (ASP), conv_bias_relu, and the xentropy,
                clip_grad, layer_norm and optimizers facades
  multi_tensor_apply — one functor over parallel tensor lists
  fused_dense, mlp, normalization — the reference's facades over ops
  transformer — the pp x tp x dp training step, the tensor-parallel
                layers and cross entropy, pipeline_parallel (the p2p
                hops, the clocked schedules, the host-driven 1F1B
                driver, the weight-decay grouping), the microbatch
                calculators, the model-parallel-aware GradScaler of
                `amp`, the attention softmax dispatch of functional
                (FusedScaleMaskSoftmax), the batch samplers of `_data`,
                `broadcast_data` and the activation arenas of
                `tensor_parallel`, and the test harness of `testing`
  checkpoint  — the shard-native checkpoints: the format, the async
                CheckpointManager, elastic re-shard, the multi-host
                commit, the orchestrator, the legacy single-file format
                and the serving fail points (chaos)
  monitor     — the telemetry plane (on-device metrics, sinks, the
                logger, flops, watermarks, the tap plane and the flight
                recorder of trace/) and the observatories (the profiler
                capture, the timeline, the compile audit, the comms
                inventory, the recompile sentry)
  tune        — the kernel tuner: the JSON config cache the JAX package
                shares, the lookups, the offline sweep
  csrc        — the CUDA kernels' build-on-first-use loader, and the
                host runtime (g++: flat layouts, chunk plans, the epoch
                shuffle, the threaded row gather)
  rnn         — RNNReLU, RNNTanh, LSTM, GRU and mLSTM, stacked and
                bidirectional (also as `RNN`)
  utils       — the phase timers and the per-module loggers
"""

import logging as _logging

__version__ = "0.1.0"


class RankInfoFormatter(_logging.Formatter):
    """Log formatter that stamps `rank_info` on each record: this
    process's rank and the group sizes (`parallel.mesh.get_rank_info()`,
    "uninit" when that cannot be read)."""

    def format(self, record):
        from apex_tpu_torch.parallel import mesh as _mesh

        try:
            info = _mesh.get_rank_info()
        except Exception:
            info = "uninit"
        record.rank_info = info
        return super().format(record)


_logger = _logging.getLogger(__name__)
_logger.addHandler(_logging.NullHandler())


def deprecated_warning(msg: str) -> None:
    """Emit `msg` as a FutureWarning, from global rank 0 only (every
    process warns when torch.distributed is not initialized)."""
    import warnings

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_rank() != 0:
        return
    warnings.warn(msg, FutureWarning, stacklevel=2)


def _get_logger(name=None):
    return _logging.getLogger(name or __name__)


_LAZY_SUBMODULES = {"ops", "serve", "models", "optimizers", "transformer",
                    "checkpoint", "monitor", "csrc", "amp", "parallel",
                    "contrib", "multi_tensor_apply", "fused_dense", "mlp",
                    "normalization", "tune", "fp16_utils", "moe", "rnn",
                    "utils"}


def __getattr__(name):
    import importlib

    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f"apex_tpu_torch.{name}")
    if name == "RNN":  # the reference's `apex.RNN`
        return importlib.import_module("apex_tpu_torch.rnn")
    raise AttributeError(
        f"module 'apex_tpu_torch' has no attribute {name!r}")
