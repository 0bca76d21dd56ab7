#!/usr/bin/env python3
"""Host time of one NCCL collective on a one-rank group, on the card.

    python3 scripts/port_nccl_host_cost.py

chip_smoke.py phase 15 drives GPT-350M through the TP layers on one-rank
NCCL tp and dp groups, where the step issues ~350 collectives and its
wall time is about twice its device time.  This script times what one
call costs the host: each collective is issued behind ~20 ms of GEMMs
already queued on the stream, so a call that returned only after the
card caught up would show it; the best and worst of 5 calls are
printed, in ms, beside a plain device copy of the same bytes.  Then, in
a fresh process each, the mean host ms of 500 back-to-back 8 KB
all-reduces through `torch.distributed.all_reduce` and through the
ProcessGroup's own `allreduce`, under the default settings, with
TORCH_NCCL_TRACE_BUFFER_SIZE=0 (no flight-recorder entries) and with
TORCH_NCCL_ENABLE_MONITORING=0 as well.  Prints the card's name and
power limit first and one JSON line per part.  Needs CUDA; exits 2
without it.
"""

import json
import os
import subprocess
import sys
import time

_CHILD = r'''
import json, time, torch, torch.distributed as dist
dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                        world_size=1, device_id=torch.device("cuda", 0))
g = dist.group.WORLD
x = torch.randn(2048, device="cuda")
for _ in range(50):
    dist.all_reduce(x, group=g)
torch.cuda.synchronize()
t = time.perf_counter()
for _ in range(500):
    dist.all_reduce(x, group=g)
wrapped = (time.perf_counter() - t) / 500 * 1e3
torch.cuda.synchronize()
opts = dist.AllreduceOptions()
t = time.perf_counter()
for _ in range(500):
    g.allreduce([x], opts)
raw = (time.perf_counter() - t) / 500 * 1e3
torch.cuda.synchronize()
print(json.dumps({"all_reduce_host_ms": wrapped,
                  "process_group_allreduce_host_ms": raw}))
dist.destroy_process_group()
'''


def behind_queued_gemms():
    import torch
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    g = dist.group.WORLD
    x = torch.randn(12 * 2 ** 20, device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(x)
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)

    def host_ms(fn, n=5):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            for _ in range(20):
                a @ a
            t = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        return [min(ts), max(ts)]

    res = {
        "nothing": host_ms(lambda: None),
        "copy_25MB": host_ms(lambda: out.copy_(x)),
        "all_reduce_in_place_25MB": host_ms(lambda: dist.all_reduce(
            x, group=g)),
        "all_reduce_in_place_4KB": host_ms(lambda: dist.all_reduce(
            x[:2048], group=g)),
        "all_gather_25MB": host_ms(lambda: dist.all_gather_into_tensor(
            out, x, group=g)),
        "reduce_scatter_25MB": host_ms(lambda: dist.reduce_scatter_tensor(
            out, x, group=g)),
        "all_reduce_async_then_wait_25MB": host_ms(lambda: dist.all_reduce(
            x, group=g, async_op=True).wait())}
    dist.destroy_process_group()
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("port_nccl_host_cost: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    print(json.dumps({"host_ms_behind_20_queued_gemms_min_max":
                      behind_queued_gemms()}), flush=True)
    by_env = {}
    for name, env in (
            ("default", {}),
            ("TORCH_NCCL_TRACE_BUFFER_SIZE=0",
             {"TORCH_NCCL_TRACE_BUFFER_SIZE": "0"}),
            ("TORCH_NCCL_TRACE_BUFFER_SIZE=0,TORCH_NCCL_ENABLE_MONITORING=0",
             {"TORCH_NCCL_TRACE_BUFFER_SIZE": "0",
              "TORCH_NCCL_ENABLE_MONITORING": "0"})):
        proc = subprocess.run([sys.executable, "-c", _CHILD],
                              env=dict(os.environ, **env),
                              capture_output=True, text=True, timeout=300)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
        if proc.returncode or not lines:
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        by_env[name] = json.loads(lines[-1])
    print(json.dumps({"back_to_back_8KB_all_reduce": by_env}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
