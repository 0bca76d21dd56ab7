"""Multihead-attention latency benchmark on the PyTorch port
(counterpart of examples/bench_multihead_attn.py, itself ≡ apex's
contrib/examples/multihead_attn/perf_test_multihead_attn.py:101-110).

Times the forward and the forward + backward of
`contrib.multihead_attn.SelfMultiheadAttn` at the example's defaults
(seq 1024, batch 8, hidden 1024, 16 heads, bf16 on the card), fused:
the flash kernels as its attention core; and unfused: the same module
with the plain `ops.flash_attention.attention_reference` as its core (the
JAX example's "ref" line runs the flash core too, since its module never
reads `impl`; the port's unfused line is the plain version instead).
Prints one JSON line: the ms of each, by CUDA events on the card.

Run on the card:
    python examples/torch_bench_multihead_attn.py [--seq 1024] [--batch 8]
and on the CPU, at the JAX example's CPU shape (seq 128, batch 2, fp32;
host-clock ms of PyTorch's CPU operators, not a device time):
    python examples/torch_bench_multihead_attn.py --device cpu
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

from apex_tpu_torch.contrib import multihead_attn as mha_mod  # noqa: E402
from apex_tpu_torch.ops import flash_attention as fa  # noqa: E402
from apex_tpu_torch.ops._common import resolve_device  # noqa: E402


def plain_core(q, k, v, *, bias=None, bias_grad=True, **kw):
    """`attention_reference` with `flash_attention`'s arguments (a bias
    without `bias_grad` gets no gradient)."""
    if bias is not None and not bias_grad:
        bias = bias.detach()
    return fa.attention_reference(q, k, v, bias=bias, **kw)


def timeit(fn, dev, iters=20, warm=3):
    """ms a call: CUDA events around `iters` calls on the card, the host
    clock on the CPU."""
    for _ in range(warm):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def run(seq, batch, hidden, heads, device=None, iters=20, mask=None):
    """{fused, unfused} x {fwd, fwd+bwd} ms of the module on `device`
    (the card unless it says otherwise), bf16 on the card and fp32 on
    the CPU, weights from seed 0 and x from seed 1."""
    dev = resolve_device(device)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    mha = mha_mod.SelfMultiheadAttn(hidden, heads, device=dev, dtype=dt)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((seq, batch, hidden), generator=gen).to(dev, dt)
    xg = x.clone().requires_grad_(True)

    def fwd():
        with torch.no_grad():
            return mha(x, mask=mask)

    def fwd_bwd():
        mha(xg, mask=mask).float().sum().backward()

    res = {}
    saved = mha_mod.flash_attention
    for name, core in (("fused", saved), ("unfused", plain_core)):
        mha_mod.flash_attention = core
        try:
            res[f"{name}_fwd_ms"] = timeit(fwd, dev, iters)
            res[f"{name}_fwdbwd_ms"] = timeit(fwd_bwd, dev, iters)
        finally:
            mha_mod.flash_attention = saved
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        args.seq, args.batch = 128, 2
    res = {"metric": "self_mha_latency_ms",
           "config": f"seq{args.seq} b{args.batch} h{args.hidden}",
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    res.update(run(args.seq, args.batch, args.hidden, args.heads, dev,
                   args.iters))
    res["value"] = res["fused_fwdbwd_ms"]
    res["unit"] = "ms"
    res["vs_unfused"] = res["unfused_fwdbwd_ms"] / max(
        res["fused_fwdbwd_ms"], 1e-9)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
