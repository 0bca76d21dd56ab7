#!/usr/bin/env python3
"""Time variants of the port's wgmma + TMA kernels on one GPU.

    python3 scripts/port_hopper_ablation.py

Builds `apex_tpu_torch/csrc/fused_dense.cu` and `flash_attention.cu` as
they stand and variants of them through the `-D` overrides the two
sources declare (`APEX_GEMM_WG_*`, `APEX_FWD_*`; into the gitignored
`apex_tpu_torch/csrc/build/ablation_hopper/`):

  fused dense GEMM (the wgmma route)
    shipped           128 x 256 output tiles, a 4-stage TMA ring
    tile_128x128      128 x 128 tiles, a 6-stage ring (the runner-up)
  flash forward
    shipped           d=64: three consumer warpgroups (192 query rows a
                      work item), a 4-stage K/V ring; a warpgroup skips the
                      key tiles above its rows' diagonal
    two_warpgroups    d=64 with two consumer warpgroups (128 rows)
    two_stages        d=64 with a 2-stage K/V ring
    no_tile_skip      every warpgroup runs every key tile of its item
    no_math           the pipeline alone: every wait, load, release and
                      store, but no product, softmax or rescale (o is
                      then garbage: timed, not checked)
    no_o_store        everything but the stores of o (timed, not checked)

holds each against its plain version (the GEMM within 1e-2 of max |y| at
GPT-350M's two MLP shapes; the forward's o and lse packed against
unpacked bit for bit and against `attention_reference`, through
chip_smoke.check_packed_flash, at GPT's step shape), and times the GEMM
at GPT-350M's MLP shapes (bf16; the up projection with its bias and
gelu, the down projection with its bias) and the forward (hp 1 and 2) at
GPT's step shape (12, 16, 1024, 64) causal on the step's views, BERT's
(32, 16, 512, 64) with padding segment ids, and bench.py's MHA shape
(8, 16, 2048, 64) causal: the median of 60 CUDA-event timings, the
variants in turns (each in order, then in reverse order).

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

# variant -> its -D overrides of the source's defaults
GEMM_VARIANTS = {
    "shipped": [],
    "tile_128x128": ["-DAPEX_GEMM_WG_BN=128", "-DAPEX_GEMM_WG_STAGES=6"],
}
FLASH_VARIANTS = {
    "shipped": [],
    "two_warpgroups": ["-DAPEX_FWD_WGS64=2"],
    "two_stages": ["-DAPEX_FWD_STAGES64=2"],
    "no_tile_skip": ["-DAPEX_FWD_TILE_SKIP=0"],
    "no_math": ["-DAPEX_FWD_MATH=0"],
    "no_o_store": ["-DAPEX_FWD_STORE_O=0"],
}
# variants whose output is not the function (timed only)
UNCHECKED = ("no_math", "no_o_store")


def build(csrc, cs, name, out, variants):
    """{variant: loaded library} for `name`.cu under each variant's
    overrides, one nvcc each, all started together."""
    nvcc = csrc._nvcc()
    procs = {}
    for var, defs in variants.items():
        procs[var] = subprocess.Popen(
            [nvcc, *csrc.NVCC_FLAGS, *defs, "-o",
             os.path.join(out, f"{name}_{var}.so"), csrc.source_path(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for var, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {var}:\n{log}")
        regs = [line.split("Used ")[1].split(",")[0]
                for line in log.splitlines() if "Used " in line]
        print(f"{name} {var}: ptxas registers by kernel {regs}", flush=True)
        libs[var] = ctypes.CDLL(os.path.join(out, f"{name}_{var}.so"))
    return libs


def in_turns(cs, torch, libs, install, cases):
    """{(variant, case): [ms, ms]}: every case under every variant, the
    variants in order then in reverse."""
    times = {}
    for var in list(libs) + list(reversed(libs)):
        install(libs[var])
        for case, fn in cases.items():
            times.setdefault((var, case), []).append(cs.time_ms(torch, fn))
    return times


def main():
    import torch

    if not torch.cuda.is_available():
        print("hopper ablation: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from apex_tpu_torch import csrc
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_dense as fdn
    from apex_tpu_torch.ops._common import strict_matmul_numerics

    strict_matmul_numerics()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    out = os.path.join(csrc.BUILD_DIR, "ablation_hopper")
    os.makedirs(out, exist_ok=True)
    gemm = build(csrc, cs, "fused_dense", out, GEMM_VARIANTS)
    flash = build(csrc, cs, "flash_attention", out, FLASH_VARIANTS)

    rng = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    # the GEMM at GPT-350M's MLP shapes
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in gemm.values():
        lib.apex_fused_dense_fwd.restype = i32
        lib.apex_fused_dense_fwd.argtypes = [i32, i32, i32, vp, vp, vp, vp,
                                             i32, i32, i32, vp]
    cases = {}
    data = []
    for (m, k, n), act in (((12288, 1024, 4096), "gelu"),
                           ((12288, 4096, 1024), None)):
        x = torch.randn((m, k), generator=rng, device="cuda").to(bf16)
        w = (torch.randn((k, n), generator=rng, device="cuda")
             / math.sqrt(k)).to(bf16)
        b = torch.randn((n,), generator=rng, device="cuda").to(bf16)
        data.append((x, w, b, act))
        cases[f"{m}x{k}x{n} act={act}"] = (
            lambda x=x, w=w, b=b, act=act: fdn.linear_bias_cuda(x, w, b,
                                                                act))

    def use_gemm(lib):
        fdn._LIB = lib

    for var, lib in gemm.items():
        use_gemm(lib)
        for x, w, b, act in data:
            ref = fdn.linear_bias_reference(x, w, b, act).float()
            err = ((fdn.linear_bias_cuda(x, w, b, act).float() - ref).abs()
                   .max() / ref.abs().max()).item()
            cs.check(err <= 1e-2, f"GEMM {var}: error {err:.3e}")
            print(f"GEMM {var} {tuple(x.shape)}x{tuple(w.shape)}: max err "
                  f"{err:.3e} of max |y|", flush=True)
    times = in_turns(cs, torch, gemm, use_gemm, cases)
    for (var, case), ts in times.items():
        print(f"GEMM {case} {var}: "
              f"{', '.join(f'{x:.4f}' for x in ts)} ms", flush=True)
    del data, cases
    use_gemm(gemm["shipped"])

    # the flash forward
    for var in flash:
        flash[var] = fa._bind(flash[var])
        if var in UNCHECKED:
            continue
        fa._LIB = flash[var]
        e = cs.check_packed_flash(torch, fa, rng, b=12, h=16, s=1024, d=64,
                                  causal=True, views=True, hps=(2,))
        print(f"flash {var}: GPT shape bit for bit packed vs unpacked, {e}",
              flush=True)
    cases = {}
    keep = []
    seg = cs.pad_segments(torch, 32, 512, [512, 300, 129, 1])
    for label, (b, h, s, d), causal, ids, views in (
            ("gpt", (12, 16, 1024, 64), True, None, True),
            ("bert", (32, 16, 512, 64), False, seg, True),
            ("mha", cs.MHA_SHAPE, True, None, False)):
        q, k, v, _ = cs.flash_inputs(torch, rng, b, h, s, d, views)
        keep.append((q, k, v))
        sc = 1.0 / math.sqrt(d)
        sg = (ids, ids) if ids is not None else (None, None)
        cases[f"{label} hp1"] = (
            lambda q=q, k=k, v=v, sc=sc, c=causal, sg=sg:
            fa.flash_fwd_cuda(q, k, v, sc, c, *sg))
        cases[f"{label} hp2"] = (
            lambda q=q, k=k, v=v, sc=sc, c=causal, sg=sg:
            fa.flash_fwd_packed_cuda(q, k, v, sc, c, 2, *sg))

    def use_flash(lib):
        fa._LIB = lib

    times = in_turns(cs, torch, flash, use_flash, cases)
    for (var, case), ts in times.items():
        print(f"flash fwd {case} {var}: "
              f"{', '.join(f'{x:.4f}' for x in ts)} ms", flush=True)
    use_flash(flash["shipped"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
