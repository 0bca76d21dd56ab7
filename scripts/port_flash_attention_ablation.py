#!/usr/bin/env python3
"""Time variants of the port's flash-attention backward on one GPU.

    python3 scripts/port_flash_attention_ablation.py

Builds `apex_tpu_torch/csrc/flash_attention.cu` as it stands and three
variants made from it by replacing its dq-accumulation block (into the
gitignored `apex_tpu_torch/csrc/build/ablation/`), holds each against the
plain version on a ragged case, and times the backward kernel at the
training step's shape (b 12, h 16, s 1024, d 64, causal, bf16; q, k, v
strided views of the packed qkv): one launch on a zeroed dq buffer, the
median of 60 CUDA-event timings, every variant twice, in turns.

  shipped   2-wide float2 atomics (the source as it stands)
  scalar    one atomicAdd per value (the kernel's first version)
  float4    lanes t and t^1 trade fragment halves; 4-wide atomics
  none      dq is not written: a wrong result, timing only

Then the segment-masked kernels (BERT's padding mask) at the BERT step's
shape (b 32, h 16, s 512, d 64, not causal; q, k, v views of the packed
qkv), forward and backward, with the segment ids of the BERT step's
batch (every token real) and of a ragged one (512, 300, 129 and 1 real
tokens), in turns:

  shipped        a warp whose tile is one segment skips the per-score
                 id compares (the source as it stands)
  seg_per_score  every tile compares ids per score (the warp vote
                 replaced by "no")

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

SHIPPED_BEGIN = "    // 2-wide atomics (red.global.add.v2.f32)"
SHIPPED_END = "    __syncthreads();  // ds_s and this stage"

SCALAR = """    const int qr_a = q0 + warp * 16 + g, qr_b = qr_a + 8;
    float* dqg = dq_acc + (long long)bh * sq * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (qr_a < sq) {
        atomicAdd(dqg + (long long)qr_a * D + n * 8, scale * dqa[n][0]);
        atomicAdd(dqg + (long long)qr_a * D + n * 8 + 1, scale * dqa[n][1]);
      }
      if (qr_b < sq) {
        atomicAdd(dqg + (long long)qr_b * D + n * 8, scale * dqa[n][2]);
        atomicAdd(dqg + (long long)qr_b * D + n * 8 + 1, scale * dqa[n][3]);
      }
    }
"""
FLOAT4 = """    const bool even = (t4 & 1) == 0;
    const int qrow = q0 + warp * 16 + g + (even ? 0 : 8);
    float* dqg = dq_acc + (long long)bh * sq * D + (long long)qrow * D +
                 2 * (t4 & ~1);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float o0 = __shfl_xor_sync(kFull, even ? dqa[n][2] : dqa[n][0], 1);
      const float o1 = __shfl_xor_sync(kFull, even ? dqa[n][3] : dqa[n][1], 1);
      const float4 val =
          even ? make_float4(scale * dqa[n][0], scale * dqa[n][1], scale * o0,
                             scale * o1)
               : make_float4(scale * o0, scale * o1, scale * dqa[n][2],
                             scale * dqa[n][3]);
      if (qrow < sq) atomicAdd(reinterpret_cast<float4*>(dqg + n * 8), val);
    }
"""
# the warp vote of the segment fast path, and its "never" variant
VOTE = "  return __all_sync(kFull, same);"
NO_VOTE = "  return false;"
NONE = """    float keep = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      keep += dqa[n][0] + dqa[n][1] + dqa[n][2] + dqa[n][3];
    if (sq < 0) dq_acc[0] = keep;   // never true: keeps the dq products
"""


def main():
    import torch

    if not torch.cuda.is_available():
        print("flash attention ablation: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from apex_tpu_torch import csrc
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops.fused_dense import qkv_split_heads

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    with open(csrc.source_path("flash_attention")) as f:
        src = f.read()
    i, j = src.index(SHIPPED_BEGIN), src.index(SHIPPED_END)
    cs.check(src.count(VOTE) == 1, "the segment vote is not in the source")
    variants = {"shipped": src, "scalar": src[:i] + SCALAR + src[j:],
                "float4": src[:i] + FLOAT4 + src[j:],
                "none": src[:i] + NONE + src[j:],
                "seg_per_score": src.replace(VOTE, NO_VOTE)}
    out = os.path.join(csrc.BUILD_DIR, "ablation")
    os.makedirs(out, exist_ok=True)
    nvcc = csrc._nvcc()
    procs = {}
    for name, text in variants.items():
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
        libs[name] = fa._bind(ctypes.CDLL(os.path.join(out, f"{name}.so")))

    rng = torch.Generator(device="cuda").manual_seed(0)
    for name, lib in libs.items():
        if name == "none":
            continue
        fa._LIB = lib
        e = cs.check_flash_attention(torch, fa, rng, b=2, h=3, s=200, d=64,
                                     causal=True)
        print(f"{name}: ragged (2,3,200,64) causal vs plain {e}", flush=True)
        if name in ("shipped", "seg_per_score"):
            sg = cs.pad_segments(torch, 4, 200, [200, 77, 130, 1])
            e = cs.check_flash_attention(torch, fa, rng, b=4, h=3, s=200,
                                         d=64, causal=False, q_seg=sg,
                                         kv_seg=sg)
            print(f"{name}: segments (4,3,200,64) vs plain {e}", flush=True)

    b, h, s, d = 12, 16, 1024, 64
    bf16 = torch.bfloat16
    sc = 1.0 / math.sqrt(d)
    qkv = torch.randn((s, b, 3 * h * d), generator=rng,
                      device="cuda").to(bf16)
    q, k, v = qkv_split_heads(qkv, h, d)
    do = torch.randn((s, b, h, d), generator=rng,
                     device="cuda").to(bf16).permute(1, 2, 0, 3)
    fa._LIB = libs["shipped"]
    o, lse = fa.flash_fwd_cuda(q, k, v, sc, True)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    strides = fa._strides(q, k, v, do)
    dq = torch.zeros((b, h, s, d), dtype=torch.float32, device="cuda")
    dk, dv = torch.empty_like(o), torch.empty_like(o)
    stream = torch.cuda.current_stream().cuda_stream

    def bwd(lib):
        err = lib.apex_flash_attn_bwd(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), strides, b, h, s, s, sc, 1, None, None, 0, 0,
            stream)
        cs.check(err == 0, f"launch failed: CUDA error {err}")

    times = {name: [] for name in libs}
    order = list(libs) + list(reversed(libs))
    for name in order:
        times[name].append(cs.time_ms(torch, lambda: bwd(libs[name]),
                                      flush=lambda: dq.zero_()))
    for name, ts in times.items():
        print(f"{name}: backward {', '.join(f'{1e3 * t:.1f}' for t in ts)} "
              "us", flush=True)

    b, s = 32, 512
    qkv = torch.randn((s, b, 3 * h * d), generator=rng,
                      device="cuda").to(bf16)
    q, k, v = qkv_split_heads(qkv, h, d)
    do = torch.randn((s, b, h, d), generator=rng,
                     device="cuda").to(bf16).permute(1, 2, 0, 3)
    for label, lengths in (("all real", [512]),
                           ("ragged 512/300/129/1", [512, 300, 129, 1])):
        seg = cs.pad_segments(torch, b, s, lengths)
        fa._LIB = libs["shipped"]
        o, lse = fa.flash_fwd_cuda(q, k, v, sc, False, seg, seg)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        times = {}
        for name in ("shipped", "seg_per_score", "seg_per_score",
                     "shipped"):
            fa._LIB = libs[name]
            fwd = cs.time_ms(torch, lambda: fa.flash_fwd_cuda(
                q, k, v, sc, False, seg, seg))
            bwd = cs.time_ms(torch, lambda: fa.flash_bwd_cuda(
                q, k, v, do, lse, delta, sc, False, seg, seg))
            times.setdefault(name, []).append((fwd, bwd))
        for name, ts in times.items():
            print(f"segments (32,16,512,64) {label}, {name}: forward "
                  f"{', '.join(f'{1e3 * f:.1f}' for f, _ in ts)} us, "
                  f"backward (with dq zeroing and cast) "
                  f"{', '.join(f'{1e3 * bw:.1f}' for _, bw in ts)} us",
                  flush=True)
    fa._LIB = libs["shipped"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
