#!/usr/bin/env python3
"""Time variants of the port's head-packed flash kernels on one GPU.

    python3 scripts/port_flash_packed_ablation.py

Builds `apex_tpu_torch/csrc/flash_attention.cu` as it stands and two
variants made from it (into the gitignored
`apex_tpu_torch/csrc/build/ablation_packed/`):

  shipped          the next head's Q tile and first K/V stage (backward:
                   K/V tiles and first q step) are issued by cp.async
                   before the current head's epilogue; the first head's
                   inside the head loop, under `p == 0` (the source as it
                   stands)
  prologue_before  the same prefetch, the first head's prologue before
                   the head loop
  no_prefetch      each head issues its own prologue at the top of the
                   loop

holds each against the unpacked kernels (o, lse, dk, dv bit for bit) at
a ragged shape and at the step's, and times the packed forward and fused
backward at hp 1, 2 and 4 beside the unpacked kernels, at GPT-350M's
step shape (b 12, h 16, s 1024, d 64, causal, bf16; q, k, v strided
views of the packed qkv) and at bench.py's MHA shape (8, 16, 2048, 64):
the median of 60 CUDA-event timings, the variants in turns (each in
order, then in reverse order).

The card's name and power limit come first, the times last.  Fails
without CUDA.
"""

import ctypes
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the first head's prologue in the shipped forward and backward head loops
FWD_FIRST = "    const int hh = bh % h;\n    if (p == 0) prologue(bh);\n"
BWD_FIRST = "    const int bh = bh0 + p;\n    if (p == 0) prologue(bh);\n"
LOOP = "  for (int p = 0; p < hp; ++p) {\n"
NEXT = "    if (p + 1 < hp) prologue(bh + 1);\n"


def variants(src):
    """{"shipped", "prologue_before", "no_prefetch"}: the source texts."""
    for text, n in ((FWD_FIRST, 1), (BWD_FIRST, 1), (LOOP, 2), (NEXT, 2)):
        if src.count(text) != n:
            raise SystemExit(f"ablation: {text!r} is not {n}x in the source")
    before = src.replace(FWD_FIRST, FWD_FIRST.replace(
        "    if (p == 0) prologue(bh);\n", ""))
    before = before.replace(BWD_FIRST, BWD_FIRST.replace(
        "    if (p == 0) prologue(bh);\n", ""))
    before = before.replace(LOOP, "  prologue(bh0);\n" + LOOP)
    no_prefetch = src.replace(NEXT, "").replace(
        "    if (p == 0) prologue(bh);\n", "    prologue(bh);\n")
    return {"shipped": src, "prologue_before": before,
            "no_prefetch": no_prefetch}


def main():
    import torch

    if not torch.cuda.is_available():
        print("packed flash ablation: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from apex_tpu_torch import csrc
    from apex_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    with open(csrc.source_path("flash_attention")) as f:
        src = f.read()
    texts = variants(src)
    out = os.path.join(csrc.BUILD_DIR, "ablation_packed")
    os.makedirs(out, exist_ok=True)
    nvcc = csrc._nvcc()
    procs = {}
    for name, text in texts.items():
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *csrc.NVCC_FLAGS, "-o", os.path.join(out, f"{name}.so"),
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        regs = [line.split("Used ")[1].split(",")[0]
                for line in log.splitlines() if "Used " in line]
        print(f"{name}: ptxas registers by kernel {regs}", flush=True)
        libs[name] = fa._bind(ctypes.CDLL(os.path.join(out, f"{name}.so")))

    rng = torch.Generator(device="cuda").manual_seed(0)
    for name, lib in libs.items():
        fa._LIB = lib
        for kw in (dict(b=2, h=4, s=200, d=64, causal=True),
                   dict(b=12, h=16, s=1024, d=64, causal=True, views=True)):
            e = cs.check_packed_flash(torch, fa, rng, hps=(2, 4), **kw)
            print(f"{name}: {kw} bit for bit with hp=1, {e}", flush=True)

    for label, shape, views in (("gpt", (12, 16, 1024, 64), True),
                                ("mha", cs.MHA_SHAPE, False)):
        b, h, s, d = shape
        q, k, v, do = cs.flash_inputs(torch, rng, b, h, s, d, views)
        sc = 1.0 / math.sqrt(d)
        fa._LIB = libs["shipped"]
        o, lse = fa.flash_fwd_cuda(q, k, v, sc, True)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        times = {}
        for name in list(libs) + list(reversed(libs)):
            fa._LIB = libs[name]
            t = {"fwd_unpacked": cs.time_ms(torch, lambda: fa.flash_fwd_cuda(
                     q, k, v, sc, True)),
                 "bwd_unpacked": cs.time_ms(torch, lambda: fa.flash_bwd_cuda(
                     q, k, v, do, lse, delta, sc, True))}
            for hp in (1, 2, 4):
                t[f"fwd_hp{hp}"] = cs.time_ms(
                    torch, lambda: fa.flash_fwd_packed_cuda(
                        q, k, v, sc, True, hp))
                t[f"bwd_hp{hp}"] = cs.time_ms(
                    torch, lambda: fa.flash_bwd_packed_cuda(
                        q, k, v, do, lse, delta, sc, True, hp))
            for key, ms in t.items():
                times.setdefault((name, key), []).append(ms)
        for (name, key), ts in times.items():
            print(f"{label} {shape} {name} {key}: "
                  f"{', '.join(f'{1e3 * x:.1f}' for x in ts)} us", flush=True)
        del q, k, v, do, o, lse, delta
    fa._LIB = libs["shipped"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
