#!/usr/bin/env python3
"""Time variants of the port's wgmma + TMA kernels on one GPU.

    python3 scripts/port_hopper_ablation.py [--backward | --dq | --softmax |
                                             --gemm32 | --lnbwd | --decode |
                                             --lnfwd | --sums]
                                            [--baseline ROOT]

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

`--gemm32` times the fused dense GEMM's fp32 kernel (the `fma` route)
at apex's run_mlp layers (batch 1024: 1024 x 480 x 1024, 1024^2, 1024
x 1024 x 512, 1024 x 512 x 256; bias and relu), each variant checked
against `linear_bias_reference` within 1e-5 of max |y| first (but the
timed-only `no_reads` and `no_math`) and timed in turns beside
`torch.relu(torch.addmm(...))`:

    shipped           `ops.fused_dense._plan`: `f32_plan` on the card's
                      SMs and clusters (tile 128 x 128 or 128 x 64, K
                      split among a cluster's blocks), 16-byte cp.async
                      into a 4-stage ring
    no_split          the shipped build and tile under split 1 (the grid of
                      tiles only)
    loads4            the shipped build and plan with 4-byte copies, as
                      ragged shapes take them
    tile_128          the shipped build under the best plan of 128 x 128
                      tiles alone
    all_clusters      the shipped build under `f32_plan` without the card's
                      clusters (as if it held sms / split of each size:
                      split 4 at the last two layers, whose 32 clusters of
                      4 the card cannot hold at once)
    one_stage         -DAPEX_GEMM_F32_STAGES=1: one slice in shared memory,
                      no copy overlapping the FMAs
    two_stages        -DAPEX_GEMM_F32_STAGES=2
    no_reads          -DAPEX_GEMM_F32_READS=0: x and w read from shared
                      memory once a slice (the FMAs without their reads)
    no_math           -DAPEX_GEMM_F32_MATH=0: the reads, adds instead of the
                      FMAs

(the split-K sums go through the cluster's shared memory in the one
launch; no workspace variant exists).  Then the shipped build at every
tile and split 1-8 at each layer, once: the times `f32_plan`'s costs
(F32_TILE_COST, F32_EPILOGUE, F32_REDUCE) are fitted to.  Each build's
fp32 kernels' ptxas registers and spills are printed beside its name.

`--softmax` times the Triton softmax forward (`ops/softmax.py`) as
shipped, whose causal form loads x only in the 8-column groups up to
each row's diagonal, and a copy of it built here with its visibility
helper swapped for one that loads every in-bounds x (`read_all`: the
masks applied as before, the same outputs), at GPT's (192, 1024, 1024)
causal and BERT's (32, 16, 512, 512) with the padding masks
512/300/129/0 and none (the bench's batch; the masked form is the same
code in both), in turns, each checked against
`softmax_fwd_reference`.

`--lnbwd` checks and times the LayerNorm backward (`csrc/layer_norm.cu`)
at GPT-350M's and BERT-Large's rows, (12288, 1024) and (16384, 1024)
bf16 with a weight, beside `F.layer_norm`'s backward, each checked
variant against `norm_bwd_reference` first (chip_smoke's
`check_layer_norm_bwd`, two runs bit for bit):

    shipped           `ops.layer_norm.bwd_plan`: a warp a row, a 4-slot
                      ring of bulk copies, a second launch of one block a
                      4-column slice summing the partial rows; also timed
                      without a weight (no partial rows, no second launch)
    grid_barrier      -DAPEX_LNB_FINISH=1: a cooperative launch whose
                      blocks sum the slices after a grid barrier
    no_finish         -DAPEX_LNB_FINISH=2: no finishing pass (timed only)
    no_math           -DAPEX_LNB_MATH=0: the rows stream through the ring,
                      nothing computed or stored (timed only; also without
                      a weight)
    one_row           the shipped build, one ring slot (one row in flight)
    loads4            the shipped build with 4-byte loads, one row at a time
    finish32          the shipped build, the finishing pass on 32 blocks
    torch.add         g + x into dx: the kernel's bytes through one ATen
                      elementwise kernel (the streaming yardstick)

`--decode` checks and times flash-decode (`csrc/flash_decode.cu`) with a
cold L2 at the serving case (64 slots x 16 heads of 64, pages of 128,
lengths 0-256) and the long case (4 slots x 16 heads x 4096 keys), each
checked variant against `paged_attention_reference` first (chip_smoke's
`check_flash_decode`, two runs bit for bit), beside SDPA over the cache
gathered beforehand:

    shipped           `ops.flash_decode.decode_plan`: 4 warps a block, one
                      bulk copy of K and one of V a page and head
    cp_async          -DAPEX_FD_BULK=0: 16-byte cp.async by every thread
                      into the same ring
    no_math           -DAPEX_FD_MATH=0: the keys stream through, nothing
                      computed (timed only)
    no_split          the shipped build without the long case's split
    row_tile8         the 8-row tile on one query row
    two_stages        two ring slots (both pages of a serving slot at once)
    chunk64           ring slots of 64 keys
    hp2, hp4, hp8     the plan at heads_per_step 2, 4, 8

`--lnfwd` checks and times the LayerNorm forward (`csrc/layer_norm.cu`)
at the main paths' rows in bf16 with weight and bias: decode's (64,
1024), GPT-350M's (12288, 1024), BERT-Large's (16384, 1024), GPT-1.3B's
(3584, 2048), beside `F.layer_norm`, each checked variant against
`norm_fwd_reference` first (chip_smoke's `check_layer_norm`, two runs
bit for bit):

    shipped           `ops.layer_norm.fwd_plan`: at the training rows two
                      16-byte vectors a thread (2 warps a row at 1024),
                      8 warps a block, each row group walking a run of
                      rows with the next row's x in flight, w and b
                      loaded once, one wave of the blocks an SM the
                      form is compiled for (2); at decode's one vector a
                      thread (4 warps a row), a row a block
    no_math           -DAPEX_LNF_MATH=0: x copied to y, no sums (timed
                      only)
    warps_2x, half    the shipped build, twice or half the warps a row
                      (1 or 4 vectors a thread at the training rows)
    group_a_block     the shipped build, one row group a block
    row_a_group       the shipped build, one row a group (no next row's
                      loads in flight), as many blocks as that takes
    runs4             the shipped build, runs of rows sized for four
                      blocks an SM whatever the form (two waves of the
                      two-vector form at the training rows)
    y.copy_(x)        the kernel's bytes (x read, y written) through one
                      ATen copy kernel (the streaming yardstick)

`--sums` checks and times the channel sums (`csrc/welford.cu`) at each
batch-norm shape of the ResNet-50 step at batch 256 in bf16, and their
sum over a step's 53, beside `torch.var_mean`, each checked variant
against fp64 sums and `channel_sums_reference` first (chip_smoke's
`check_channel_sums`, two runs bit for bit):

    shipped           `ops.welford.sums_plan`: a block an SM in
                      clusters of 6, the last cluster (an integer
                      ticket) summing the clusters' partials
    no_math           -DAPEX_SUMS_MATH=0: the rows stream through, their
                      bits folded (timed only)
    no_cluster        the shipped build, clusters of one block
    cluster4          the shipped build, clusters of up to 4 blocks
    blocks2, blocks4  the shipped build, two or four blocks an SM

`--baseline ROOT` adds, for `--lnfwd` and `--sums`, the Triton kernels of
the checkout at ROOT (`norm_fwd_triton`, `channel_sums_triton`, as the
port had them before these kernels were CUDA C++), timed in the same
turns.

The card's name and power limit come first, the times last.
`--backward` runs the backward's variants alone, `--dq` the dq pass's,
`--softmax` the softmax forward's, `--gemm32` the fp32 GEMM's, `--lnbwd`
the LayerNorm backward's, `--decode` flash-decode's, `--lnfwd` the
LayerNorm forward's, `--sums` the channel sums'.  Fails without CUDA.
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
GEMM32_VARIANTS = {
    "shipped": [],
    "one_stage": ["-DAPEX_GEMM_F32_STAGES=1"],
    "two_stages": ["-DAPEX_GEMM_F32_STAGES=2"],
    "no_reads": ["-DAPEX_GEMM_F32_READS=0"],
    "no_math": ["-DAPEX_GEMM_F32_MATH=0"],
}
# variants that run the shipped build under another plan
GEMM32_PLANS = ("no_split", "loads4", "tile_128", "all_clusters")
LNBWD_VARIANTS = {
    "shipped": [],
    "grid_barrier": ["-DAPEX_LNB_FINISH=1"],
    "no_finish": ["-DAPEX_LNB_FINISH=2"],
    "no_math": ["-DAPEX_LNB_MATH=0"],
}
# the shipped build's plan changed: (field, value) pairs
LNBWD_PLANS = {"one_row": {"stages": 1},
               "loads4": {"stages": 1, "load_width": 4},
               "finish32": {"finish_blocks": 32}}
DECODE_VARIANTS = {
    "shipped": [],
    "cp_async": ["-DAPEX_FD_BULK=0"],
    "no_math": ["-DAPEX_FD_MATH=0"],
}
DECODE_PLANS = {"no_split": {"split": 1}, "row_tile8": {"row_tile": 8},
                "two_stages": {"stages": 2}, "chunk64": {"chunk": 64}}
# the shipped build and plan at a caller's heads_per_step
DECODE_HPS = {"hp2": 2, "hp4": 4, "hp8": 8}
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
UNCHECKED = ("no_math", "no_o_store", "no_dq_store", "no_reads",
             "no_finish")
# the cases the LayerNorm backward's variants are timed at: GPT-350M's
# step rows (batch 12 x seq 1024) and BERT-Large's (32 x 512), hidden 1024
LNBWD_ROWS = (12288, 16384)
LNFWD_VARIANTS = {
    "shipped": [],
    "no_math": ["-DAPEX_LNF_MATH=0"],
}



def _runs4(p, rows, sms):
    """`p` with its runs of rows sized for four blocks an SM."""
    groups = p.warps // p.warps_per_row
    per_block = -(-rows // (sms * 4 * groups)) * groups
    return p._replace(blocks=-(-rows // per_block), rows_per_block=per_block)


# the shipped build under another plan: plan, rows, SMs -> plan
LNFWD_PLANS = {
    # twice the warps a row (a vector a thread at the training rows)
    "warps_2x": lambda p, rows, sms: p if p.warps_per_row > 4 else (
        p._replace(warps_per_row=2 * p.warps_per_row,
                   warps=max(2 * p.warps_per_row, p.warps))),
    # half the warps a row (four vectors a thread at the training rows)
    "warps_half": lambda p, rows, sms: p if p.warps_per_row in (1, 12) else (
        p._replace(warps_per_row=p.warps_per_row // 2)),
    # one row group a block
    "group_a_block": lambda p, rows, sms: p if p.warps_per_row > 8 else (
        p._replace(blocks=rows, rows_per_block=1, warps=p.warps_per_row)),
    # one row a group (nothing to load ahead), as many blocks as that takes
    "row_a_group": lambda p, rows, sms: p if p.warps_per_row > 8 else (
        p._replace(rows_per_block=p.warps // p.warps_per_row,
                   blocks=-(-rows // (p.warps // p.warps_per_row)))),
    # runs sized for four blocks an SM whatever the form's registers
    "runs4": lambda p, rows, sms: p if p.warps_per_row > 8 else (
        _runs4(p, rows, sms)),
}
LNFWD_SHAPES = ((64, 1024), (12288, 1024), (16384, 1024), (3584, 2048))
SUMS_VARIANTS = {
    "shipped": [],
    "no_math": ["-DAPEX_SUMS_MATH=0"],
}
# the shipped build under another plan: the plan's constants changed
SUMS_PLANS = {"no_cluster": {"SUMS_MAX_CLUSTER": 1},
              "cluster4": {"SUMS_MAX_CLUSTER": 4},
              "blocks2": {"SUMS_BLOCKS_PER_SM": 2},
              "blocks4": {"SUMS_BLOCKS_PER_SM": 4}}
# every -D override above, for the check that the sources declare them
OVERRIDES = {"layer_norm": {**LNBWD_VARIANTS, **{
                 f"fwd_{k}": v for k, v in LNFWD_VARIANTS.items()}},
             "welford": SUMS_VARIANTS,
             "flash_decode": DECODE_VARIANTS,
             "fused_dense": {**GEMM_VARIANTS, **{
                 f"f32_{k}": v for k, v in GEMM32_VARIANTS.items()}},
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


def gemm32(cs, torch, fdn, rng, libs):
    """The fp32 GEMM's variants (module docstring): each checked, then all
    timed in turns with `torch.relu(torch.addmm(...))` at the MLP
    layers; then the shipped build's tile x split sweep."""
    libs = {var: fdn._bind(lib) for var, lib in libs.items()}
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clusters = fdn.f32_clusters(dev)
    print(f"fp32 GEMM: {sms} SMs, clusters of 1..8 blocks held at once "
          f"{clusters}", flush=True)
    runs = {var: (lib, var) for var, lib in libs.items()}
    runs.update({var: (libs["shipped"], var) for var in GEMM32_PLANS})
    data = []
    for m, k, n in cs.MLP_LAYERS[:4]:
        x = torch.randn((m, k), generator=rng, device="cuda")
        w = torch.randn((k, n), generator=rng, device="cuda") / math.sqrt(k)
        b = torch.randn((n,), generator=rng, device="cuda")
        data.append((x, w, b, torch.empty((m, n), device="cuda")))

    def plan_of(var, x, w):
        (m, k), n = x.shape, w.shape[1]
        tile_n, split, k_split, vec = fdn._plan("fma", x, w)
        if var == "no_split":
            split, k_split = 1, -(-k // fdn.F32_SLICE) * fdn.F32_SLICE
        elif var == "loads4":
            vec = False
        elif var == "tile_128":
            saved, fdn.F32_TILES = fdn.F32_TILES, ((128, 128),)
            try:
                tile, split, k_split = fdn.f32_plan(m, n, k, sms, clusters)
            finally:
                fdn.F32_TILES = saved
            tile_n = tile[1]
        elif var == "all_clusters":
            tile, split, k_split = fdn.f32_plan(m, n, k, sms)
            tile_n = tile[1]
        return tile_n, split, k_split, vec

    def launch(lib, plan, x, w, b, y):
        tile_n, split, k_split, vec = plan
        err = lib.apex_fused_dense_fwd(
            fdn._ROUTE_CODES["fma"], 0, fdn._ACT_CODES["relu"],
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            x.shape[0], w.shape[1], x.shape[1], tile_n, split, k_split,
            int(vec), torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"fp32 GEMM launch {plan}: error {err}")

    for var, (lib, pv) in runs.items():
        for x, w, b, y in data:
            plan = plan_of(pv, x, w)
            launch(lib, plan, x, w, b, y)
            if var in UNCHECKED:
                print(f"fp32 GEMM {var} {tuple(x.shape)}x{tuple(w.shape)} "
                      f"plan {plan}: timed only", flush=True)
                continue
            ref = fdn.linear_bias_reference(x, w, b, "relu")
            err = ((y - ref).abs().max() / ref.abs().max()).item()
            cs.check(err <= 1e-5, f"fp32 GEMM {var}: error {err:.3e}")
            print(f"fp32 GEMM {var} {tuple(x.shape)}x{tuple(w.shape)} plan "
                  f"(tile_n, split, k_split, vec) {plan}: max err "
                  f"{err:.3e} of max |y|", flush=True)
    order = list(runs) + ["addmm+relu"]
    times = {}
    for var in order + list(reversed(order)):
        for x, w, b, y in data:
            case = "x".join(map(str, (x.shape[0], x.shape[1], w.shape[1])))
            if var == "addmm+relu":
                fn = (lambda x=x, w=w, b=b: torch.relu(torch.addmm(b, x, w)))
            else:
                lib, pv = runs[var]
                fn = (lambda lib=lib, p=plan_of(pv, x, w), x=x, w=w, b=b,
                      y=y: launch(lib, p, x, w, b, y))
            times.setdefault((var, case), []).append(cs.time_ms(torch, fn))
    for (var, case), ts in times.items():
        print(f"fp32 GEMM {case} {var}: "
              f"{', '.join(f'{t:.4f}' for t in ts)} ms", flush=True)
    for x, w, b, y in data:
        case = "x".join(map(str, (x.shape[0], x.shape[1], w.shape[1])))
        k = x.shape[1]
        slices = -(-k // fdn.F32_SLICE)
        row = []
        for tile in fdn.F32_TILES:
            for split in range(1, fdn.F32_MAX_SPLIT + 1):
                per = -(-slices // split)
                if split > 1 and (split - 1) * per >= slices:
                    continue
                plan = (tile[1], split, per * fdn.F32_SLICE, True)
                t = cs.time_ms(torch, lambda: launch(
                    libs["shipped"], plan, x, w, b, y))
                row.append(f"{tile[0]}x{tile[1]}/{split} {t:.4f}")
        print(f"fp32 GEMM sweep {case} (tile/split ms): " + ", ".join(row),
              flush=True)


def layer_norm_bwd(cs, torch, ln, rng, libs):
    """The LayerNorm backward's builds and plans (module docstring): each
    checked variant against `norm_bwd_reference` (chip_smoke's
    `check_layer_norm_bwd`: GPT's rows in bf16, a ragged fp32 case, two
    runs bit for bit), then all timed in turns at `LNBWD_ROWS` beside
    `F.layer_norm`'s backward."""
    libs = {var: ln._bind(lib) for var, lib in libs.items()}
    runs = {var: (lib, {}) for var, lib in libs.items()}
    runs.update({var: (libs["shipped"], ch)
                 for var, ch in LNBWD_PLANS.items()})
    launch = ln._launch
    data = []
    for rows in LNBWD_ROWS:
        x = (torch.randn((rows, 1024), generator=rng, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        w = (torch.randn((1024,), generator=rng, device="cuda") * 0.5
             + 1).to(torch.bfloat16)
        gy = torch.randn((rows, 1024), generator=rng,
                         device="cuda").to(torch.bfloat16)
        _, mean, rstd = ln.norm_fwd_reference(x, w, None)
        dx = torch.empty_like(x)
        data.append((x, w, gy, mean, rstd, dx,
                     torch.empty((2, 1024), device="cuda"), ""))
        # no weight: no dw, db, so no partial rows and no finishing pass
        data.append((x, None, gy, mean, rstd, dx, None, " no weight"))

    def use(var):
        lib, change = runs[var]
        ln._LIB = lib
        ln._launch = (lambda plan, *a: launch(plan._replace(**change), *a))

    try:
        for var in runs:
            if var in UNCHECKED:
                continue
            use(var)
            errs = [cs.check_layer_norm_bwd(torch, ln, rng, r, h, dt)[1]
                    for r, h, dt in ((12288, 1024, torch.bfloat16),
                                     (77, 1000, torch.float32))]
            print(f"layer_norm bwd {var}: max dx err {errs} (GPT rows "
                  f"bf16, (77, 1000) fp32), two runs bit for bit",
                  flush=True)
        order = list(runs) + ["F.layer_norm", "torch.add"]
        times = {}
        for var in order + list(reversed(order)):
            for x, w, gy, mean, rstd, dx, dwdb, label in data:
                case = f"({x.shape[0]}, 1024){label}"
                if label and var not in ("shipped", "no_math"):
                    continue
                if var == "torch.add":
                    # the kernel's bytes (g and x read, dx written) through
                    # one ATen elementwise kernel: what streaming costs
                    fn = (lambda gy=gy, x=x, dx=dx: torch.add(gy, x, out=dx))
                elif var == "F.layer_norm":
                    xg, wg, bg = (t.detach().requires_grad_(True) for t in
                                  (x, w, torch.zeros_like(w)))
                    out = torch.nn.functional.layer_norm(xg, (1024,), wg, bg)
                    fn = (lambda out=out, xg=xg, wg=wg, bg=bg, gy=gy:
                          torch.autograd.grad(out, (xg, wg, bg), gy,
                                              retain_graph=True))
                else:
                    use(var)
                    plan = ln.bwd_plan(x.shape[0], 1024, 2,
                                       ln._sm_count(x.device))
                    fn = (lambda p=plan, a=(gy, x, mean, rstd, w, dx, dwdb,
                                            False): ln._launch(p, *a))
                times.setdefault((var, case), []).append(
                    cs.time_ms(torch, fn))
    finally:
        ln._LIB, ln._launch = libs["shipped"], launch
    for (var, case), ts in times.items():
        print(f"layer_norm bwd {case} bf16 {var}: "
              f"{', '.join(f'{t:.4f}' for t in ts)} ms", flush=True)


def _baseline_module(root, name):
    """ROOT's `apex_tpu_torch/ops/<name>.py`, imported on its own (its
    imports of the package resolve to this checkout's)."""
    import importlib.util

    path = os.path.join(root, "apex_tpu_torch", "ops", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"baseline_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _print_times(what, times):
    for (var, case), ts in times.items():
        print(f"{what} {case} {var}: {', '.join(f'{t:.4f}' for t in ts)} ms",
              flush=True)


def layer_norm_fwd(cs, torch, ln, rng, libs, baseline=None):
    """The LayerNorm forward's builds and plans (module docstring): each
    checked variant against `norm_fwd_reference` (chip_smoke's
    `check_layer_norm`: every `LNFWD_SHAPES` case in bf16, a ragged fp32
    one, two runs bit for bit), then all timed in turns beside
    `F.layer_norm`, the streaming yardstick and, with `baseline`, its
    Triton forward."""
    libs = {var: ln._bind(lib) for var, lib in libs.items()}
    runs = {var: (lib, None) for var, lib in libs.items()}
    runs.update({var: (libs["shipped"], ch)
                 for var, ch in LNFWD_PLANS.items()})
    launch = ln._launch_fwd
    base = _baseline_module(baseline, "layer_norm") if baseline else None

    def use(var):
        lib, change = runs[var]
        ln._LIB = lib
        ln._launch_fwd = launch if change is None else (
            lambda plan, x2, *a: launch(change(
                plan, x2.shape[0], ln._sm_count(x2.device)), x2, *a))

    data = []
    for rows, hid in LNFWD_SHAPES:
        x = (torch.randn((rows, hid), generator=rng, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        w = (torch.randn((hid,), generator=rng, device="cuda") * 0.5
             + 1).to(torch.bfloat16)
        b = (torch.randn((hid,), generator=rng, device="cuda")
             * 0.1).to(torch.bfloat16)
        data.append((f"({rows}, {hid})", x, w, b, torch.empty_like(x)))
    try:
        for var in runs:
            if var in UNCHECKED:
                continue
            use(var)
            errs = [cs.check_layer_norm(torch, ln, rng, r, h, dt)[1]
                    for (r, h), dt in [(sh, torch.bfloat16)
                                       for sh in LNFWD_SHAPES]
                    + [((77, 1000), torch.float32)]]
            print(f"layer_norm fwd {var}: max y err {errs}, two runs bit "
                  f"for bit", flush=True)
        order = list(runs) + ["F.layer_norm", "y.copy_(x)"]
        if base is not None:
            order.append("triton (baseline)")
        times = {}
        for var in order + list(reversed(order)):
            for case, x, w, b, y in data:
                hid = x.shape[1]
                if var == "F.layer_norm":
                    fn = (lambda x=x, w=w, b=b, hid=hid: torch.nn.functional
                          .layer_norm(x, (hid,), w, b, 1e-5))
                elif var == "y.copy_(x)":
                    fn = (lambda x=x, y=y: y.copy_(x))
                elif var == "triton (baseline)":
                    fn = (lambda x=x, w=w, b=b: base.norm_fwd_triton(
                        x, w, b, 1e-5, False))
                else:
                    use(var)
                    fn = (lambda x=x, w=w, b=b: ln.norm_fwd_cuda(
                        x, w, b, 1e-5, False))
                times.setdefault((var, case), []).append(
                    cs.time_ms(torch, fn))
    finally:
        ln._LIB, ln._launch_fwd = libs["shipped"], launch
    for case, x, *_ in data:
        print(f"layer_norm fwd {case}: shipped plan "
              f"{tuple(ln.fwd_plan(x.shape[0], x.shape[1], 2, ln._sm_count(x.device)))}",
              flush=True)
    _print_times("layer_norm fwd bf16", times)


def channel_sums(cs, torch, wf, rng, libs, baseline=None):
    """The channel sums' builds and plans (module docstring): each
    checked variant against fp64 sums and `channel_sums_reference`
    (chip_smoke's `check_channel_sums`: the stem's and the last stage's
    shapes in bf16, C = 3, a ragged fp32 case, two runs bit for bit),
    then all timed in turns at every batch-norm shape of the ResNet-50
    step beside `torch.var_mean` and, with `baseline`, its Triton
    kernels; the last lines weigh each by the step's count."""
    libs = {var: wf._bind(lib) for var, lib in libs.items()}
    runs = {var: (lib, {}) for var, lib in libs.items()}
    runs.update({var: (libs["shipped"], ch)
                 for var, ch in SUMS_PLANS.items()})
    consts = {k: getattr(wf, k) for ch in SUMS_PLANS.values() for k in ch}
    base = _baseline_module(baseline, "welford") if baseline else None

    def use(var):
        lib, change = runs[var]
        wf._LIB = lib
        for k, v in consts.items():
            setattr(wf, k, change.get(k, v))

    try:
        for var in runs:
            if var in UNCHECKED:
                continue
            use(var)
            errs = [cs.check_channel_sums(torch, wf, rng, r, c, dt)[1]
                    for r, c, dt in ((3_211_264, 64, torch.bfloat16),
                                     (12_544, 2048, torch.bfloat16),
                                     (802_816, 3, torch.bfloat16),
                                     (5000, 130, torch.float32))]
            print(f"channel sums {var}: max |kernel - plain| {errs}, two "
                  f"runs bit for bit", flush=True)
            torch.cuda.empty_cache()
        order = list(runs) + ["torch.var_mean"]
        if base is not None:
            order.append("triton (baseline)")
        times = {}
        data = {shape: torch.randn(shape, generator=rng,
                                   device="cuda").to(torch.bfloat16)
                for shape in cs.RESNET50_BN_SHAPES}
        for var in order + list(reversed(order)):
            for (r, c), x2 in data.items():
                if var == "torch.var_mean":
                    fn = (lambda x2=x2: torch.var_mean(x2, dim=0,
                                                       correction=0))
                elif var == "triton (baseline)":
                    fn = (lambda x2=x2: base.channel_sums_triton(x2))
                else:
                    use(var)
                    fn = (lambda x2=x2: wf.channel_sums_cuda(x2))
                times.setdefault((var, f"({r}, {c})"), []).append(
                    cs.time_ms(torch, fn))
    finally:
        use("shipped")
    _print_times("channel sums bf16", times)
    for var in order:
        step = [sum(n * times[(var, f"({r}, {c})")][i]
                    for (r, c), n in cs.RESNET50_BN_SHAPES.items())
                for i in range(2)]
        print(f"channel sums a ResNet-50 step (53) {var}: "
              f"{', '.join(f'{t:.4f}' for t in step)} ms", flush=True)


def decode(cs, torch, fd, rng, libs):
    """Flash-decode's builds and plans (module docstring): each checked
    against `paged_attention_reference` (chip_smoke's
    `check_flash_decode`, two runs bit for bit) at the serving shape and
    the long case, then timed in turns with a cold L2 at both beside
    SDPA over the pre-gathered cache."""
    libs = {var: fd._bind(lib) for var, lib in libs.items()}
    runs = {var: (lib, {}, None) for var, lib in libs.items()}
    runs.update({var: (libs["shipped"], ch, None)
                 for var, ch in DECODE_PLANS.items()})
    runs.update({var: (libs["shipped"], {}, hp)
                 for var, hp in DECODE_HPS.items()})
    launch = fd._launch
    cases = {"serving": cs.decode_main_case(torch, rng),
             "long": cs.decode_long_case(torch, rng)}
    flush_src = torch.ones(64 * 2 ** 20, dtype=torch.int8, device="cuda")
    sink = torch.empty((), dtype=torch.int64, device="cuda")

    def flush():
        torch.sum(flush_src, dim=0, dtype=torch.int64, out=sink)

    def use(var):
        lib, change, hp = runs[var]
        fd._LIB = lib
        fd._launch = (lambda plan, *a: launch(plan._replace(**change), *a))
        return hp

    try:
        for var in runs:
            if var in UNCHECKED:
                continue
            hp = use(var)
            for case, args in cases.items():
                e = cs.check_flash_decode(torch, fd, args, torch.bfloat16,
                                          hp)
                print(f"flash_decode {var} {case}: plan "
                      f"{tuple(fd.flash_decode_cuda.last_plan)}, max err "
                      f"{e:.3e}, two runs bit for bit", flush=True)
        order = list(runs) + ["SDPA"]
        times = {}
        for var in order + list(reversed(order)):
            for case, (q, k, v, tbl, lens) in cases.items():
                if var == "SDPA":
                    lib_ms = cs.decode_times(torch, fd, (q, k, v, tbl, lens),
                                             flush)["library_ms"]
                    times.setdefault((var, case), []).append(lib_ms)
                    continue
                hp = use(var)
                times.setdefault((var, case), []).append(cs.time_ms(
                    torch, lambda a=(q, k, v, tbl, lens): fd.flash_decode_cuda(
                        *a, 0.125, hp), flush=flush))
    finally:
        fd._LIB, fd._launch = libs["shipped"], launch
    for (var, case), ts in times.items():
        print(f"flash_decode {case} {var} (cold L2): "
              f"{', '.join(f'{t:.4f}' for t in ts)} ms", flush=True)


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
    from apex_tpu_torch.ops import flash_decode as fd
    from apex_tpu_torch.ops import fused_dense as fdn
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import welford as wf
    from apex_tpu_torch.ops._common import strict_matmul_numerics

    strict_matmul_numerics()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    out = os.path.join(csrc.BUILD_DIR, "ablation_hopper")
    os.makedirs(out, exist_ok=True)
    rng = torch.Generator(device="cuda").manual_seed(0)
    baseline = (argv[argv.index("--baseline") + 1]
                if "--baseline" in argv else None)
    for flag, name, variants, run in (
            ("--lnbwd", "layer_norm", LNBWD_VARIANTS, layer_norm_bwd),
            ("--decode", "flash_decode", DECODE_VARIANTS, decode)):
        if flag in argv:
            os.makedirs(os.path.join(out, name), exist_ok=True)
            procs = start(csrc, name, os.path.join(out, name), variants)
            mod = ln if name == "layer_norm" else fd
            run(cs, torch, mod, rng, finish(cs, name, procs, part="kernel"))
            return 0
    for flag, name, variants, run, mod in (
            ("--lnfwd", "layer_norm", LNFWD_VARIANTS, layer_norm_fwd, ln),
            ("--sums", "welford", SUMS_VARIANTS, channel_sums, wf)):
        if flag in argv:
            sub = os.path.join(out, flag[2:])
            os.makedirs(sub, exist_ok=True)
            procs = start(csrc, name, sub, variants)
            run(cs, torch, mod, rng, finish(cs, name, procs, part="kernel"),
                baseline)
            return 0
    if "--softmax" in argv:
        softmax_forward(cs, torch, rng)
        return 0
    if "--gemm32" in argv:
        os.makedirs(os.path.join(out, "gemm32"), exist_ok=True)
        procs = start(csrc, "fused_dense", os.path.join(out, "gemm32"),
                      GEMM32_VARIANTS)
        gemm32(cs, torch, fdn, rng, finish(cs, "fused_dense", procs,
                                           part="dense_f32_kernel"))
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
    for lib in gemm.values():
        fdn._bind(lib)
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
