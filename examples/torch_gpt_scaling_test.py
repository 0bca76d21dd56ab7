"""GPT scaling sweep on the PyTorch port — iteration time against model
size (counterpart of examples/gpt_scaling_test.py, ≡ apex's
tests/L0/run_transformer/gpt_scaling_test.py).

For each point of the JAX example's `SWEEP` (hidden 512 to 2048, 8 to
24 layers): GPT (vocab 50304) in bf16 with flash attention and remat,
FusedAdam(lr=1e-4) over an fp32 master buffer (`--pure-half`: bf16;
`--optimizer sgd`: FusedSGD(1e-3, momentum 0.9)), one warm-up step, then
`--steps` timed ones, and the "Average Iteration Time" line the
reference's test parses.  The flash kernels take head_dim 64 or 128, so
the hidden-1536 point (16 heads of 96) runs the dense attention path
(the scaled causal softmax kernels), and says so on a line of its own.
On the CPU (`--device cpu`) one smoke point
substitutes (hidden 128, 2 layers, 2 heads, vocab 512).
The port's step updates its buffers in place, so the JAX example's
`--donate` has no counterpart.

  python examples/torch_gpt_scaling_test.py --steps 5 --batch-size 8
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from apex_tpu_torch.models.gpt import GPT, GPTConfig  # noqa: E402
from apex_tpu_torch.ops.flash_attention import (  # noqa: E402
    _KERNEL_HEAD_DIMS as FLASH_HEAD_DIMS)
from apex_tpu_torch.ops._common import resolve_device  # noqa: E402
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD  # noqa: E402
from apex_tpu_torch.optimizers.flat import tree_leaves  # noqa: E402
from apex_tpu_torch.parallel import mesh as M  # noqa: E402
from apex_tpu_torch.transformer.training import (  # noqa: E402
    init_sharded_optimizer,
    make_tp_dp_train_step,
)

SWEEP = [  # (hidden, layers, heads), the JAX example's size points
    (512, 8, 8),
    (1024, 12, 16),
    (1536, 16, 16),
    (2048, 24, 32),
]
CPU_SWEEP = [(128, 2, 2)]


def main(argv=None):
    """Returns one dict a size point: hidden, params, losses, s_per_iter,
    tokens_per_s."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--max-hidden", type=int, default=2048)
    p.add_argument("--min-hidden", type=int, default=0)
    p.add_argument("--optimizer", choices=["adam", "sgd"], default="adam")
    p.add_argument("--pure-half", action="store_true",
                   help="O3-style bf16 optimizer state (master_dtype="
                        "bfloat16)")
    p.add_argument("--device", default=None, choices=(None, "cpu", "cuda"),
                   help="cpu runs the plain versions at the smoke point "
                   "(default: the card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    on_gpu = dev.type == "cuda"

    out = []
    for hidden, layers, heads in (SWEEP if on_gpu else CPU_SWEEP):
        if hidden > args.max_hidden or hidden < args.min_hidden:
            continue
        M.destroy_model_parallel()
        M.initialize_model_parallel(tensor_model_parallel_size=args.tp)
        flash = hidden // heads in FLASH_HEAD_DIMS
        if not flash:
            print(f"hidden={hidden}: head_dim {hidden // heads} is not one "
                  f"the flash kernels take {FLASH_HEAD_DIMS}: dense "
                  f"attention")
        cfg = GPTConfig(vocab_size=50304 if on_gpu else 512,
                        seq_len=args.seq_len, hidden=hidden,
                        num_layers=layers, num_heads=heads,
                        dtype=torch.bfloat16, remat=True,
                        use_flash_attention=flash,
                        sequence_parallel=args.tp > 1)
        model = GPT(cfg)
        params = model.init(seed=0, device=dev)
        n_params = sum(x.numel() for x in tree_leaves(params))
        mdt = torch.bfloat16 if args.pure_half else torch.float32
        if args.optimizer == "sgd":
            opt = FusedSGD(lr=1e-3, momentum=0.9, master_dtype=mdt)
        else:
            opt = FusedAdam(lr=1e-4, master_dtype=mdt)
        opt_state = init_sharded_optimizer(opt, model, params)
        step = make_tp_dp_train_step(model, opt, device=dev)
        del params      # the flat state holds the master copy
        tokens = torch.randint(
            0, cfg.vocab_size, (args.batch_size, args.seq_len),
            generator=torch.Generator(device=dev).manual_seed(1),
            device=dev, dtype=torch.int32)
        labels = torch.roll(tokens, -1, dims=1)
        opt_state, loss = step(opt_state, tokens, labels)   # warm-up
        losses = [float(loss)]
        t0 = time.perf_counter()
        for _ in range(args.steps):
            opt_state, loss = step(opt_state, tokens, labels)
            losses.append(loss)
        losses = losses[:1] + [float(x) for x in losses[1:]]
        dt = (time.perf_counter() - t0) / args.steps
        # the parsed metric (gpt_scaling_test.py:13-47)
        print(f"hidden={hidden} params={n_params/1e6:.0f}M  "
              f"Average Iteration Time: {dt:.3f} s  "
              f"({args.batch_size*args.seq_len/dt:.0f} tokens/s)")
        out.append({"hidden": hidden, "layers": layers, "flash": flash,
                    "params": n_params,
                    "losses": losses, "s_per_iter": dt,
                    "tokens_per_s": args.batch_size * args.seq_len / dt})
        del opt_state, step, opt
        if on_gpu:
            torch.cuda.empty_cache()
    M.destroy_model_parallel()
    return out


if __name__ == "__main__":
    main()
