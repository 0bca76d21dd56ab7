"""Megatron-style argument parser (counterpart of
apex_tpu/transformer/testing/arguments.py): `parse_args` with the JAX
package's 14 argument groups, the same flags and the same defaults.
Flags that only name another stack's choice (`--distributed-backend
xla`, `--use-cpu-initialization`) are accepted as they are, for drop-in
script parity.
"""

from __future__ import annotations

import argparse
import os


def parse_args(extra_args_provider=None, defaults={},
               ignore_unknown_args=False):
    """Parse `sys.argv` into a namespace; `defaults` fill the fields
    left None, RANK / WORLD_SIZE come from the environment, and
    kv_channels is hidden_size / num_attention_heads when both are
    given."""
    parser = argparse.ArgumentParser(
        description="apex_tpu_torch Arguments", allow_abbrev=False)
    parser = _add_network_size_args(parser)
    parser = _add_regularization_args(parser)
    parser = _add_training_args(parser)
    parser = _add_initialization_args(parser)
    parser = _add_learning_rate_args(parser)
    parser = _add_checkpointing_args(parser)
    parser = _add_mixed_precision_args(parser)
    parser = _add_distributed_args(parser)
    parser = _add_validation_args(parser)
    parser = _add_data_args(parser)
    parser = _add_autoresume_args(parser)
    parser = _add_biencoder_args(parser)
    parser = _add_vit_args(parser)
    parser = _add_logging_args(parser)
    if extra_args_provider is not None:
        parser = extra_args_provider(parser)
    if ignore_unknown_args:
        args, _ = parser.parse_known_args()
    else:
        args = parser.parse_args()
    for key, value in defaults.items():
        if getattr(args, key, None) is None:
            setattr(args, key, value)
    args.rank = int(os.getenv("RANK", "0"))
    args.world_size = int(os.getenv("WORLD_SIZE", "1"))
    if args.num_attention_heads and args.hidden_size:
        args.kv_channels = args.hidden_size // args.num_attention_heads
    return args


def _add_network_size_args(parser):
    g = parser.add_argument_group(title="network size")
    g.add_argument("--num-layers", type=int, default=None)
    g.add_argument("--hidden-size", type=int, default=None)
    g.add_argument("--ffn-hidden-size", type=int, default=None)
    g.add_argument("--num-attention-heads", type=int, default=None)
    g.add_argument("--kv-channels", type=int, default=None)
    g.add_argument("--max-position-embeddings", type=int, default=None)
    g.add_argument("--make-vocab-size-divisible-by", type=int, default=128)
    g.add_argument("--layernorm-epsilon", type=float, default=1e-5)
    return parser


def _add_regularization_args(parser):
    g = parser.add_argument_group(title="regularization")
    g.add_argument("--attention-dropout", type=float, default=0.1)
    g.add_argument("--hidden-dropout", type=float, default=0.1)
    g.add_argument("--weight-decay", type=float, default=0.01)
    g.add_argument("--clip-grad", type=float, default=1.0)
    g.add_argument("--adam-beta1", type=float, default=0.9)
    g.add_argument("--adam-beta2", type=float, default=0.999)
    g.add_argument("--adam-eps", type=float, default=1e-8)
    g.add_argument("--sgd-momentum", type=float, default=0.9)
    return parser


def _add_training_args(parser):
    g = parser.add_argument_group(title="training")
    g.add_argument("--micro-batch-size", type=int, default=None)
    g.add_argument("--global-batch-size", type=int, default=None)
    g.add_argument("--rampup-batch-size", nargs="*", default=None)
    g.add_argument("--train-iters", type=int, default=None)
    g.add_argument("--log-interval", type=int, default=100)
    g.add_argument("--exit-interval", type=int, default=None)
    g.add_argument("--tensorboard-dir", type=str, default=None)
    g.add_argument("--optimizer", type=str, default="adam",
                   choices=["adam", "sgd", "lamb", "novograd", "adagrad"])
    g.add_argument("--use-flash-attention", action="store_true")
    return parser


def _add_initialization_args(parser):
    g = parser.add_argument_group(title="initialization")
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--init-method-std", type=float, default=0.02)
    return parser


def _add_learning_rate_args(parser):
    g = parser.add_argument_group(title="learning rate")
    g.add_argument("--lr", type=float, default=None)
    g.add_argument("--lr-decay-style", type=str, default="linear",
                   choices=["constant", "linear", "cosine"])
    g.add_argument("--lr-decay-iters", type=int, default=None)
    g.add_argument("--lr-warmup-fraction", type=float, default=None)
    g.add_argument("--min-lr", type=float, default=0.0)
    return parser


def _add_checkpointing_args(parser):
    g = parser.add_argument_group(title="checkpointing")
    g.add_argument("--save", type=str, default=None)
    g.add_argument("--save-interval", type=int, default=None)
    g.add_argument("--load", type=str, default=None)
    g.add_argument("--no-save-optim", action="store_true", default=None)
    g.add_argument("--no-load-optim", action="store_true", default=None)
    return parser


def _add_mixed_precision_args(parser):
    g = parser.add_argument_group(title="mixed precision")
    g.add_argument("--fp16", action="store_true")
    g.add_argument("--bf16", action="store_true")
    g.add_argument("--loss-scale", type=float, default=None)
    g.add_argument("--initial-loss-scale", type=float, default=2 ** 32)
    g.add_argument("--min-loss-scale", type=float, default=1.0)
    g.add_argument("--loss-scale-window", type=float, default=1000)
    g.add_argument("--hysteresis", type=int, default=2)
    g.add_argument("--accumulate-allreduce-grads-in-fp32",
                   action="store_true")
    return parser


def _add_distributed_args(parser):
    g = parser.add_argument_group(title="distributed")
    g.add_argument("--tensor-model-parallel-size", type=int, default=1)
    g.add_argument("--pipeline-model-parallel-size", type=int, default=1)
    g.add_argument("--num-layers-per-virtual-pipeline-stage", type=int,
                   default=None)
    g.add_argument("--sequence-parallel", action="store_true")
    g.add_argument("--distributed-backend", default="xla",
                   choices=["nccl", "gloo", "ucc", "xla"])
    g.add_argument("--local_rank", type=int, default=None)
    g.add_argument("--use-cpu-initialization", action="store_true",
                   default=None)
    return parser


def _add_validation_args(parser):
    g = parser.add_argument_group(title="validation")
    g.add_argument("--eval-iters", type=int, default=100)
    g.add_argument("--eval-interval", type=int, default=1000)
    return parser


def _add_data_args(parser):
    g = parser.add_argument_group(title="data and dataloader")
    g.add_argument("--data-path", nargs="*", default=None)
    g.add_argument("--seq-length", type=int, default=None)
    g.add_argument("--encoder-seq-length", type=int, default=None)
    g.add_argument("--decoder-seq-length", type=int, default=None)
    g.add_argument("--vocab-size", type=int, default=None)
    g.add_argument("--num-workers", type=int, default=2)
    g.add_argument("--reset-position-ids", action="store_true")
    g.add_argument("--reset-attention-mask", action="store_true")
    g.add_argument("--eod-mask-loss", action="store_true")
    return parser


def _add_autoresume_args(parser):
    g = parser.add_argument_group(title="autoresume")
    g.add_argument("--adlr-autoresume", action="store_true")
    g.add_argument("--adlr-autoresume-interval", type=int, default=1000)
    return parser


def _add_biencoder_args(parser):
    g = parser.add_argument_group(title="biencoder")
    g.add_argument("--ict-head-size", type=int, default=None)
    return parser


def _add_vit_args(parser):
    g = parser.add_argument_group(title="vit")
    g.add_argument("--num-classes", type=int, default=1000)
    g.add_argument("--img-dim", type=int, default=224)
    g.add_argument("--patch-dim", type=int, default=16)
    return parser


def _add_logging_args(parser):
    g = parser.add_argument_group(title="logging")
    g.add_argument("--log-params-norm", action="store_true")
    g.add_argument("--log-num-zeros-in-grad", action="store_true")
    g.add_argument("--log-timers-to-tensorboard", action="store_true")
    return parser
