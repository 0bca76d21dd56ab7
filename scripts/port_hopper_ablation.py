#!/usr/bin/env python3
"""Time variants of the port's wgmma + TMA kernels on one GPU.

    python3 scripts/port_hopper_ablation.py [--backward | --dq | --softmax]

Builds `apex_tpu_torch/csrc/fused_dense.cu` and `flash_attention.cu` as
they stand and variants of them through the `-D` overrides the two
sources declare (`APEX_GEMM_WG_*`, `APEX_FWD_*`, `APEX_BWD_*`,
`APEX_DQ_*`; into the gitignored
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
  flash backward (the fused, packed and dk/dv kernels' one body)
    shipped           two consumer warpgroups of 64 keys and (d=64) a
                      producer warpgroup, a 2-stage Q/dO ring at d=64,
                      work items taken from a counter in chunks of a few
                      heads, dQ over a warpgroup's own 64 keys at d=64, dq
                      by one bulk tensor reduce-add per warp and 32
                      columns
    dq_red            dq by per-thread red.global.add.v2.f32 from registers
    one_stage         d=64 with a 1-stage Q/dO ring (no load overlaps a
                      step)
    three_stages      d=64 with a 3-stage Q/dO ring
    dq_split          d=64: each warpgroup takes half of dQ's columns over
                      all 128 keys, the two exchanging dS^T through shared
                      memory behind a named barrier each step (half the
                      reduce-adds)
    no_math           the pipeline alone: every wait, load, release, barrier
                      and store, but no product or softmax (timed, not
                      checked)
    no_dq_store       everything but dq's way out (timed, not checked)
    key_major         the work items in key-tile order over all heads
                      (all first tiles first) instead of in chunks of a
                      few heads
    head_major        one head (group) a chunk: its tiles side by side
  the split backward's dq pass
    shipped           d=64: three consumer warpgroups of 64 query rows
                      (192 rows a work item), 64-key tiles through a
                      6-stage K/V ring, a tile's dQ product and the next
                      tile's S and dP each waited for
    two_warpgroups    two consumer warpgroups (128 rows a work item)
    keys128           two warpgroups with 128-key tiles (a 3-stage ring)
    three_stages      a 3-stage K/V ring
    no_math           the pipeline alone: every wait, load, release and
                      store, but no product or math (timed, not checked)
    no_dq_store       everything but the stores of dq (timed, not checked)

holds each against its plain version (the GEMM within 1e-2 of max |y| at
GPT-350M's two MLP shapes; the forward's o and lse packed against
unpacked bit for bit and against `attention_reference`, through
chip_smoke.check_packed_flash, at GPT's step shape), and times the GEMM
at GPT-350M's MLP shapes (bf16; the up projection with its bias and
gelu, the down projection with its bias) and the forward (hp 1 and 2) at
GPT's step shape (12, 16, 1024, 64) causal on the step's views, BERT's
(32, 16, 512, 64) with padding segment ids, and bench.py's MHA shape
(8, 16, 2048, 64) causal: the median of 60 CUDA-event timings, the
variants in turns (each in order, then in reverse order).  The backward
variants are checked as the forward's are (dk and dv of the packed kernel
and of the dk/dv pass bit for bit with the fused kernel's at GPT's step
shape, every output against the plain version) and timed at the same
three shapes (fused at hp 1, packed at hp 2, the dk/dv pass) and the dk/dv
pass at bench.py's 32k shape (1, 8, 32768, 64) causal.  Each build's
ptxas summary of the backward kernels (registers, spills, serialised
wgmma notes) is printed beside its name.  The dq-pass variants are held
against `flash_bwd_dq_reference` (chip_smoke.check_dq_pass: causal at
(1, 8, 2048, 64), and BERT's padding at (4, 8, 512, 64); two runs bit
for bit) and timed at GPT-350M's seq 8192 (1, 16, 8192, 64) and at
bench.py's 32k shape (1, 8, 32768, 64), causal, with their ptxas
summaries.

`--softmax` times the Triton softmax forward (`ops/softmax.py`) as
shipped, whose causal form loads x only in the 8-column groups up to
each row's diagonal, and a copy of it built here with its visibility
helper swapped for one that loads every in-bounds x (`read_all`: the
masks applied as before, the same outputs), at GPT's (192, 1024, 1024)
causal and BERT's (32, 16, 512, 512) with the padding masks
512/300/129/0 and none (the bench's batch; the masked form is the same
code in both), in turns, each checked against
`softmax_fwd_reference`.

The card's name and power limit come first, the times last.
`--backward` runs the backward's variants alone, `--dq` the dq pass's,
`--softmax` the softmax forward's.  Fails without CUDA.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# triton.language, bound by `softmax_forward` on the card (this script
# imports without triton)
tl = None

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
BWD_VARIANTS = {
    "shipped": [],
    "dq_red": ["-DAPEX_BWD_DQ_RED=1"],
    "one_stage": ["-DAPEX_BWD_STAGES64=1"],
    "three_stages": ["-DAPEX_BWD_STAGES64=3"],
    "dq_split": ["-DAPEX_BWD_DQ_OWN64=0"],
    "no_math": ["-DAPEX_BWD_MATH=0"],
    "no_dq_store": ["-DAPEX_BWD_STORE_DQ=0"],
    "key_major": ["-DAPEX_BWD_CHUNK=1000000"],
    "head_major": ["-DAPEX_BWD_CHUNK=1"],
}
DQ_VARIANTS = {
    "shipped": [],
    "two_warpgroups": ["-DAPEX_DQ_WGS64=2"],
    "keys128": ["-DAPEX_DQ_WGS64=2", "-DAPEX_DQ_KEYS64=128",
                "-DAPEX_DQ_STAGES64=3"],
    "three_stages": ["-DAPEX_DQ_STAGES64=3"],
    "no_math": ["-DAPEX_DQ_MATH=0"],
    "no_dq_store": ["-DAPEX_DQ_STORE=0"],
}
# variants whose output is not the function (timed only)
UNCHECKED = ("no_math", "no_o_store", "no_dq_store")
# every -D override above, for the check that the sources declare them
OVERRIDES = {"fused_dense": GEMM_VARIANTS,
             "flash_attention": {**FLASH_VARIANTS, **{
                 f"bwd_{k}": v for k, v in BWD_VARIANTS.items()}, **{
                 f"dq_{k}": v for k, v in DQ_VARIANTS.items()}}}


def ptxas_summary(log, part):
    """(kernel, registers, spill line) for each entry of an nvcc log whose
    name holds `part`, and ptxas' serialised-wgmma notes (C7512, C7515)
    for them."""
    rows, notes, name = [], [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and part in name and "Used " in line:
            rows.append([name, line.split("Used ")[1].split(",")[0]])
        elif name and part in name and "spill" in line:
            rows.append([name, line.strip()])
        if "Performance Loss" in line and part in line:
            notes.append(line.strip())
    return rows, notes


def start(csrc, name, out, variants):
    """{variant: nvcc process} building `name`.cu under each variant's
    overrides into `out`."""
    nvcc = csrc._nvcc()
    return {var: (subprocess.Popen(
        [nvcc, *csrc.NVCC_FLAGS, *defs, "-o",
         os.path.join(out, f"{name}_{var}.so"), csrc.source_path(name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        os.path.join(out, f"{name}_{var}.so"))
        for var, defs in variants.items()}


def finish(cs, name, procs, part=None):
    """{variant: loaded library} once each build of `start` is done.
    `part`: print the ptxas summary of the kernels whose names hold it."""
    libs = {}
    for var, (proc, path) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {var}:\n{log}")
        regs = [line.split("Used ")[1].split(",")[0]
                for line in log.splitlines() if "Used " in line]
        print(f"{name} {var}: ptxas registers by kernel {regs}", flush=True)
        if part:
            rows, notes = ptxas_summary(log, part)
            for row in rows:
                print(f"{name} {var}: ptxas {row[0][-60:]} {row[1]}",
                      flush=True)
            print(f"{name} {var}: serialised wgmma notes: "
                  f"{notes or 'none'}", flush=True)
        libs[var] = ctypes.CDLL(path)
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


def backward(cs, torch, fa, rng, libs):
    """The backward variants: checked (`UNCHECKED` aside) and timed in
    turns (module docstring)."""
    for var in libs:
        libs[var] = fa._bind(libs[var])
        if var in UNCHECKED:
            continue
        fa._LIB = libs[var]
        e = cs.check_packed_flash(torch, fa, rng, b=12, h=16, s=1024, d=64,
                                  causal=True, views=True, hps=(2,))
        q, k, v, do = cs.flash_inputs(torch, rng, 12, 16, 1024, 64, True)
        o, lse = fa.flash_fwd_cuda(q, k, v, 0.125, True)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        args = (q, k, v, do, lse, delta, 0.125, True)
        _, fdk, fdv = fa.flash_bwd_cuda(*args)
        dk, dv = fa.flash_bwd_dkv_cuda(*args)
        cs.check(torch.equal(dk, fdk) and torch.equal(dv, fdv),
                 f"flash bwd {var}: the dk/dv pass differs from fused")
        print(f"flash bwd {var}: GPT shape bit for bit packed, dk/dv pass "
              f"and fused (dk, dv), {e}", flush=True)
    cases = {}
    keep = []
    seg = cs.pad_segments(torch, 32, 512, [512, 300, 129, 1])
    for label, (b, h, s, d), causal, ids, views in (
            ("gpt", (12, 16, 1024, 64), True, None, True),
            ("bert", (32, 16, 512, 64), False, seg, True),
            ("mha", cs.MHA_SHAPE, True, None, False),
            ("32k", cs.LONG_SHAPE, True, None, False)):
        q, k, v, do = cs.flash_inputs(torch, rng, b, h, s, d, views)
        sc = 1.0 / math.sqrt(d)
        sg = (ids, ids) if ids is not None else (None, None)
        fa._LIB = libs["shipped"]
        o, lse = fa.flash_fwd_cuda(q, k, v, sc, causal, *sg)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        args = (q, k, v, do, lse, delta, sc, causal)
        keep.append(args)
        if label != "32k":
            cases[f"{label} fused"] = (
                lambda a=args, sg=sg: fa.flash_bwd_cuda(*a, *sg))
            cases[f"{label} packed hp2"] = (
                lambda a=args, sg=sg: fa.flash_bwd_packed_cuda(*a, 2, *sg))
        cases[f"{label} dk/dv pass"] = (
            lambda a=args, sg=sg: fa.flash_bwd_dkv_cuda(*a, *sg))

    def use_flash(lib):
        fa._LIB = lib

    times = in_turns(cs, torch, libs, use_flash, cases)
    for (var, case), ts in times.items():
        print(f"flash bwd {case} {var}: "
              f"{', '.join(f'{x:.4f}' for x in ts)} ms", flush=True)
    use_flash(libs["shipped"])


def dq_pass(cs, torch, fa, rng, libs):
    """The dq-pass variants: checked (`UNCHECKED` aside) and timed in
    turns (module docstring)."""
    seg = cs.pad_segments(torch, 4, 512, [512, 300, 129, 0])
    for var in libs:
        libs[var] = fa._bind(libs[var])
        if var in UNCHECKED:
            continue
        fa._LIB = libs[var]
        e = (cs.check_dq_pass(torch, fa, rng, b=1, h=8, sq=2048, sk=2048,
                              d=64, causal=True),
             cs.check_dq_pass(torch, fa, rng, b=4, h=8, sq=512, sk=512,
                              d=64, causal=False, q_seg=seg, kv_seg=seg))
        print(f"dq pass {var}: max err vs plain (causal, padding) {e}",
              flush=True)
    cases = {}
    keep = []
    for label, shape in (("seq8192", (1, 16, 8192, 64)),
                         ("32k", cs.LONG_SHAPE)):
        q, k, v, do = (torch.randn(shape, generator=rng, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        sc = 1.0 / math.sqrt(shape[3])
        fa._LIB = libs["shipped"]
        o, lse = fa.flash_fwd_cuda(q, k, v, sc, True)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        args = (q, k, v, do, lse, delta, sc, True)
        keep.append(args)
        cases[f"{label} dq pass"] = (
            lambda a=args: fa.flash_bwd_dq_cuda(*a))

    def use_flash(lib):
        fa._LIB = lib

    times = in_turns(cs, torch, libs, use_flash, cases)
    for (var, case), ts in times.items():
        print(f"flash {case} {var}: "
              f"{', '.join(f'{x:.4f}' for x in ts)} ms", flush=True)
    use_flash(libs["shipped"])


def _visible_read_all(m_row, cols, grp, inb, pos, msc,
                      HAS_MASK: tl.constexpr, CAUSAL: tl.constexpr):
    """`ops.softmax._fwd_visible` with every in-bounds x loaded: the
    `read_all` variant's helper (written against the module global `tl`,
    bound to triton.language before it is jitted)."""
    vis = inb
    if CAUSAL:
        vis = inb & (cols <= pos)
    elif HAS_MASK:
        mk = tl.load(m_row + cols.to(tl.int64) * msc, mask=inb, other=1)
        vis = inb & (mk == 0)
    return vis, inb


def softmax_forward(cs, torch, rng):
    """The softmax forward as shipped and with every x loaded (module
    docstring), checked and timed in turns.  The wrapper launches the
    kernel it finds in `softmax._JIT`, swapped here as `fa._LIB` is for
    the CUDA variants."""
    global tl
    import types

    import triton
    import triton.language

    from apex_tpu_torch.ops import softmax as sm

    tl = triton.language
    name = sm._softmax_fwd_kernel.__name__
    shipped = sm._jit(sm._softmax_fwd_kernel)
    # the kernel's own code and signature over the module's globals, but
    # the helper
    kernel = types.FunctionType(
        sm._softmax_fwd_kernel.__code__,
        dict(vars(sm), _fwd_visible=triton.jit(_visible_read_all)), name)
    kernel.__annotations__ = sm._softmax_fwd_kernel.__annotations__
    read_all = triton.jit(kernel)
    variants = {"shipped": shipped, "read_all": read_all}
    bf16 = torch.bfloat16
    x = torch.randn((192, 1024, 1024), generator=rng,
                    device="cuda").to(bf16)
    xb = torch.randn((32, 16, 512, 512), generator=rng,
                     device="cuda").to(bf16)

    def pad(lens):
        return (cs.pad_segments(torch, 32, 512, lens) == 0)[:, None, None, :]

    cases = {"gpt causal": (x, None, True),
             "bert 512/300/129/0": (xb, pad([512, 300, 129, 0]), False),
             "bert no padding": (xb, pad([512]), False)}
    for var, fn in variants.items():
        sm._JIT[name] = fn
        for case, (xx, mk, causal) in cases.items():
            got = sm.softmax_fwd_triton(xx, mk, 0.125, causal).float()
            ref = sm.softmax_fwd_reference(xx, mk, 0.125, causal).float()
            err = (got - ref).abs().max().item()
            cs.check(err <= 1e-3, f"softmax {var} {case}: error {err:.3e}")
            print(f"softmax fwd {var} {case}: max err {err:.3e}",
                  flush=True)
    times = {}
    for var in list(variants) + list(reversed(variants)):
        sm._JIT[name] = variants[var]
        for case, (xx, mk, causal) in cases.items():
            times.setdefault((var, case), []).append(cs.time_ms(
                torch, lambda: sm.softmax_fwd_triton(xx, mk, 0.125,
                                                     causal)))
    sm._JIT[name] = shipped
    for (var, case), ts in times.items():
        print(f"softmax fwd {case} {var}: "
              f"{', '.join(f'{t:.4f}' for t in ts)} ms", flush=True)


def main(argv):
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
    rng = torch.Generator(device="cuda").manual_seed(0)
    if "--softmax" in argv:
        softmax_forward(cs, torch, rng)
        return 0
    if "--dq" in argv:
        os.makedirs(os.path.join(out, "dq"), exist_ok=True)
        dq_procs = start(csrc, "flash_attention", os.path.join(out, "dq"),
                         DQ_VARIANTS)
        dq_pass(cs, torch, fa, rng, finish(cs, "flash_attention", dq_procs,
                                           part="flash_bwd_dq"))
        return 0
    only_bwd = "--backward" in argv
    os.makedirs(os.path.join(out, "bwd"), exist_ok=True)
    bwd_procs = start(csrc, "flash_attention", os.path.join(out, "bwd"),
                      BWD_VARIANTS)
    if not only_bwd:
        gemm_procs = start(csrc, "fused_dense", out, GEMM_VARIANTS)
        flash_procs = start(csrc, "flash_attention", out, FLASH_VARIANTS)
    bwd = finish(cs, "flash_attention", bwd_procs, part="flash_bwd")
    backward(cs, torch, fa, rng, bwd)
    if only_bwd:
        return 0
    gemm = finish(cs, "fused_dense", gemm_procs)
    flash = finish(cs, "flash_attention", flash_procs)
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
    sys.exit(main(sys.argv[1:]))
