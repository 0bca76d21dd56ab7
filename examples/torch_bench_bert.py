"""BERT-Large pretraining-step benchmark on the PyTorch port (counterpart
of examples/bench_bert.py): one full MLM + NSP training step (forward,
backward, FusedLAMB) on one card, sequences/s printed as JSON.

The card runs BERT-Large (vocab 30528, hidden 1024, 24 layers, 16
heads) in bf16 with flash attention and `FusedLAMB(lr=1e-4,
weight_decay=0.01)` with no `wd_mask`: one unsegmented LAMB phase 1, the
per-tensor norms and phase 2 a step.  On the CPU (`--device cpu`) the
JAX example's smoke shape substitutes (batch 2, seq 64, 2 iterations,
hidden 128, 2 layers, 4 heads, dense attention).  The batch comes from
torch Generators seeded 1, 2 and 3: random tokens, MLM labels = tokens
rolled by one, a Bernoulli(0.15) loss mask, random NSP labels.

Run:  python examples/torch_bench_bert.py [--batch 8] [--seq 512] [--iters 10]
      python examples/torch_bench_bert.py --batch-sweep 16,32,48
(`--batch-sweep` runs each batch in a fresh process and needs the card.)
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from apex_tpu_torch.models.bert import Bert, BertConfig  # noqa: E402
from apex_tpu_torch.ops._common import resolve_device  # noqa: E402
from apex_tpu_torch.optimizers import FusedLAMB  # noqa: E402
from apex_tpu_torch.parallel import mesh as M  # noqa: E402
from apex_tpu_torch.transformer.training import (  # noqa: E402
    init_sharded_optimizer,
    make_tp_dp_train_step,
)


def _sweep(args):
    """One fresh process a batch (a failed point must not poison the
    later points' allocator); prints each point's JSON line or FAIL."""
    import subprocess

    for b in (int(x) for x in args.batch_sweep.split(",") if x):
        cmd = [_sys.executable, _os.path.abspath(__file__), "--batch",
               str(b), "--seq", str(args.seq), "--iters", str(args.iters)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=1800)
        except subprocess.TimeoutExpired:
            print(f"b{b}: FAIL timeout (1800s)", flush=True)
            continue
        line = "<no json output>"
        for cand in reversed(r.stdout.strip().splitlines()):
            try:
                d = json.loads(cand)
            except ValueError:
                continue
            if isinstance(d, dict) and "metric" in d:
                line = cand
                break
        print(f"b{b}: {line if r.returncode == 0 else 'FAIL ' + r.stderr.strip()[-120:]}",
              flush=True)


def main(argv=None):
    """Returns {"losses": [...], "record": the printed JSON}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch-sweep", type=str, default=None,
                    help="comma-separated batches to sweep, one process "
                    "each (the card only)")
    ap.add_argument("--device", default=None, choices=(None, "cpu", "cuda"),
                    help="cpu runs the plain versions at the smoke shape "
                    "(default: the card)")
    args = ap.parse_args(argv)
    on_gpu = args.device in (None, "cuda")
    if args.batch_sweep:
        if not on_gpu:
            # every point would be the same smoke measurement
            print("--batch-sweep needs the card; got --device "
                  f"{args.device}", file=_sys.stderr)
            _sys.exit(2)
        resolve_device(args.device)
        return _sweep(args)
    dev = resolve_device(args.device)
    if not on_gpu:
        args.batch, args.seq, args.iters = 2, 64, 2

    M.destroy_model_parallel()
    M.initialize_model_parallel()
    cfg = (BertConfig(seq_len=args.seq, dtype=torch.bfloat16,
                      use_flash_attention=True) if on_gpu else
           BertConfig(seq_len=args.seq, hidden=128, num_layers=2,
                      num_heads=4, dtype=torch.bfloat16))
    model = Bert(cfg)
    params = model.init(seed=0, device=dev)
    opt = FusedLAMB(lr=1e-4, weight_decay=0.01)
    opt_state = init_sharded_optimizer(opt, model, params)
    del params

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                           generator=gen(1), device=dev, dtype=torch.int32)
    mlm_labels = torch.roll(tokens, -1, dims=1)
    loss_mask = torch.rand((args.batch, args.seq), generator=gen(2),
                           device=dev) < 0.15
    nsp = torch.randint(0, 2, (args.batch,), generator=gen(3), device=dev,
                        dtype=torch.int32)

    def loss_fn(p, tokens, labels):
        return model.loss(p, tokens, labels, loss_mask, nsp_labels=nsp)

    step = make_tp_dp_train_step(model, opt, loss_fn=loss_fn, device=dev)
    losses = []
    for _ in range(2):
        opt_state, loss = step(opt_state, tokens, mlm_labels)
        losses.append(loss)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        opt_state, loss = step(opt_state, tokens, mlm_labels)
        losses.append(loss)
    float(loss)
    dt = (time.perf_counter() - t0) / args.iters
    rec = {
        "metric": "bert_large_lamb_seqs_per_sec_per_chip",
        "value": round(args.batch / dt, 1),
        "unit": "sequences/s",
        "s_per_iter": round(dt, 4),
        "vs_baseline": 1.0,
    }
    print(json.dumps(rec))
    M.destroy_model_parallel()
    return {"losses": [float(x) for x in losses], "record": rec}


if __name__ == "__main__":
    main()
