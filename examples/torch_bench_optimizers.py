"""FusedAdam step-time micro-benchmark at large parameter counts on the
PyTorch port (counterpart of examples/bench_optimizers.py).

One launch of the port's fused Adam (`ops.optimizer_kernels.adam_flat`:
the Triton kernel on the card) over one flat buffer, updated in place:
fp32 p, m and v, bf16 gradients on the card (the gradients' dtype is
the params' on the CPU, as in the JAX example).  A size that fails
raises: there is no retry in bf16 (a 1B fp32 p, m and v is 12 GB, which
one 80 GB card holds with room to spare).

Run:  python examples/torch_bench_optimizers.py [n_params ...] [--device cpu]
Prints one JSON line per size (2**27 and 10**9 by default on the card,
2**20 on the CPU), with the bytes moved a step over its time as GB/s on
the card.
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

from apex_tpu_torch.ops import optimizer_kernels as K  # noqa: E402
from apex_tpu_torch.ops._common import resolve_device  # noqa: E402


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_adam(n: int, param_dtype=torch.float32, iters: int = 20,
               warmup: int = 3, device=None) -> dict:
    """`iters` timed Adam steps over `n` params (rounded up to the flat
    tile, as FusedAdam.init lays its buffer out) after `warmup` ones."""
    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    n = -(-n // K.FLAT_TILE) * K.FLAT_TILE
    p = torch.zeros((n,), dtype=param_dtype, device=dev)
    m = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    g = torch.full((n,), 1e-3, device=dev,
                   dtype=torch.bfloat16 if on_gpu else param_dtype)

    def step():
        K.adam_flat(p, m, v, g, lr=1e-3, step=10, weight_decay=0.01)

    for _ in range(warmup):
        step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _sync(dev)
    ms = (time.perf_counter() - t0) / iters * 1e3
    # bytes a step: p read and written, m and v read and written (fp32),
    # one bf16 gradient read
    itemsize = p.element_size()
    bytes_moved = n * (2 * itemsize + 4 * 4 + 2) if on_gpu else None
    return {
        "metric": f"fused_adam_step_ms_at_{n/1e9:.2g}B_params",
        "value": round(ms, 3),
        "unit": "ms",
        "dtype": str(param_dtype).replace("torch.", ""),
        "gb_per_s": round(bytes_moved / (ms / 1e3) / 1e9, 1)
        if bytes_moved else None,
        "vs_baseline": 1.0,
    }


def main(argv=None):
    """Returns the JSON records, one a size."""
    ap = argparse.ArgumentParser()
    ap.add_argument("sizes", nargs="*", type=float)
    ap.add_argument("--device", default=None, choices=(None, "cpu", "cuda"),
                    help="cpu runs the plain version (default: the card)")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    sizes = [int(x) for x in a.sizes] or [2 ** 27, 10 ** 9]
    if dev.type == "cpu":
        sizes = [2 ** 20]
    out = []
    for n in sizes:
        rec = bench_adam(n, torch.float32, device=dev)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
