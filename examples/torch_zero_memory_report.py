"""ZeRO-2 per-device memory report on the PyTorch port — the point of
the sharded optimizer (counterpart of examples/zero_memory_report.py).

Builds GPT-1.3B (hidden 2048, 24 layers, 32 heads, seq 512, bf16
compute, remat, flash attention) with fp32-master DistributedFusedAdam
(bf16 gradient sync) over the data-parallel group this process has (one
rank unless the port's launcher or the caller set up more), audits one
full train step with `monitor.analyze_step` (the step run once on clones
of its arguments: the argument, output and temp bytes the allocator
measured, and their peak), takes one real step, and prints beside the
measurement the analytic p + m + v bytes per shard at `--dp` ranks
(default 8): the JAX example's numbers, whose dp = 8 shards it reads
from XLA's memory analysis of an 8-device program.  Whether the step
fits is judged against this card's own memory.  On the CPU
(`--device cpu`) the model shrinks to vocab 512 and seq 64 with the
width flags as given, and no fit is judged.

Run:  python examples/torch_zero_memory_report.py [--dp 8] \\
          [--hidden 2048 --layers 24 --heads 32] [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from apex_tpu_torch import monitor  # noqa: E402
from apex_tpu_torch.models.gpt import GPT, GPTConfig  # noqa: E402
from apex_tpu_torch.ops._common import resolve_device  # noqa: E402
from apex_tpu_torch.optimizers import DistributedFusedAdam  # noqa: E402
from apex_tpu_torch.optimizers.flat import tree_leaves  # noqa: E402
from apex_tpu_torch.parallel import ddp  # noqa: E402
from apex_tpu_torch.parallel import mesh as M  # noqa: E402
from apex_tpu_torch.parallel.multiproc import init_from_env  # noqa: E402


def main(argv=None):
    """Returns the measured and analytic numbers and the step's loss."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=8,
                    help="the dp size of the analytic per-shard bytes")
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--device", default=None, choices=(None, "cpu", "cuda"),
                    help="cpu runs the plain versions at vocab 512, seq 64 "
                    "(default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_gpu = dev.type == "cuda"
    joined = init_from_env(args.device)
    if dist.is_initialized() and on_gpu:
        dev = torch.device("cuda", torch.cuda.current_device())
    M.destroy_model_parallel()
    M.initialize_model_parallel()
    group = M.data_parallel_group()
    run_dp = M.group_size(group)

    cfg = GPTConfig(vocab_size=50304 if on_gpu else 512,
                    seq_len=512 if on_gpu else 64, hidden=args.hidden,
                    num_layers=args.layers, num_heads=args.heads,
                    dropout=0.0, dtype=torch.bfloat16,
                    logits_dtype=torch.bfloat16, remat=True,
                    use_flash_attention=True)
    model = GPT(cfg)
    params = model.init(seed=0, device=dev)
    n = sum(int(x.numel()) for x in tree_leaves(params))
    print(f"model: {n/1e9:.3f}B params, dp={args.dp} (this run: "
          f"{run_dp}), fp32 master + bf16 grad sync")

    opt = DistributedFusedAdam(num_shards=run_dp, lr=1e-4,
                               grad_sync_dtype=torch.bfloat16)
    state = opt.init(params)
    del params

    def loss_fn(p, batch):
        tokens, labels = batch
        return model.loss(p, tokens, labels)

    step = ddp.make_train_step(loss_fn, opt, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, cfg.seq_len),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1 + M.group_rank(group)),
                           device=dev, dtype=torch.int32)
    batch = (tokens, torch.roll(tokens, -1, dims=1))

    rep = monitor.analyze_step(step, (state, None, batch), donated=(0,))
    gb = 1e9
    # fp32 p, m and v over the padded flat buffer, cut in --dp shards
    state_total = 3 * 4 * opt.padded_total
    print(f"fp32 p+m+v total (sharded over dp): {state_total/gb:.2f} GB "
          f"-> {state_total/args.dp/gb:.2f} GB/device at dp={args.dp}")
    print(f"measured per-device (dp={run_dp}): arguments "
          f"{_gb(rep.argument_bytes)}, temps {_gb(rep.temp_bytes)}, output "
          f"{_gb(rep.output_bytes)} (alias {_gb(rep.alias_bytes)}: the "
          f"state updated in place)")
    peak = None
    if on_gpu:      # the allocator's peak is the card's (None on the CPU)
        peak = rep.argument_bytes + rep.temp_bytes
        props = torch.cuda.get_device_properties(dev)
        print(f"measured per-device requirement ~= {peak/gb:.2f} GB "
              f"({'fits' if peak < props.total_memory else 'exceeds'} one "
              f"{props.name}, {props.total_memory/gb:.1f} GB)")
    else:
        print("measured per-device requirement: not measured (no card)")

    state, _, loss = step(state, None, batch)
    loss = float(loss)
    print("one ZeRO step executed; loss =", loss)
    M.destroy_model_parallel()
    if joined:
        dist.destroy_process_group()
    return {"params": n, "run_dp": run_dp, "dp": args.dp,
            "state_bytes": state_total,
            "state_bytes_per_shard": state_total / args.dp,
            "argument_bytes": rep.argument_bytes,
            "temp_bytes": rep.temp_bytes, "output_bytes": rep.output_bytes,
            "peak_bytes": peak, "loss": loss}


def _gb(x):
    return "not measured" if x is None else f"{x / 1e9:.2f} GB"


if __name__ == "__main__":
    main()
