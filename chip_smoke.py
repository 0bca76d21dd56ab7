#!/usr/bin/env python3
"""Drive the PyTorch port (apex_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. device      the card's name and power limit, as nvidia-smi gives
                 them; the kernels are built from this checkout's
                 sources (nvcc for the CUDA C++, Triton's JIT).
  2. kernels     each hand-written kernel against its plain PyTorch
                 version on the card, at the serving path's shapes.
  3. engine      the flagship serving path at full width: GPT-350M in
                 bf16 (random weights, seed 0), 64 slots, 64 requests
                 with the bench's ragged prompts (1..128 tokens) and 32
                 new tokens each, driven by `measure_decode`; the
                 kernels' launch counters prove the path ran through
                 them.
  4. churn       8 ragged requests through a 4-slot engine of the same
                 model equal, bitwise, the same 8 decoded one at a time;
                 one decode step with the kernels agrees with the same
                 step through the plain versions.
  5. table       the kernels' times on the card (CUDA events) beside
                 their bounds, their plain versions and one library
                 call computing the same function.

The line before the last is the kernel table as one JSON object; the
last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the rest of the repository beside it, the script fails before printing
any result.
"""

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS = 67e12               # H100 SXM, fp32 outside the tensor cores


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


# ------------------------------------------------------------ timing ----

def time_ms(torch, fn, n=60, warm=5, flush=None):
    """Median device time of `fn` over n launches (CUDA events around
    each), after `warm` launches.  A long device sleep is queued first
    so the host enqueues every launch before the card reaches them: the
    events then bracket device work only, not host launch gaps.
    `flush` (optional) runs before each launch, outside the events."""
    for _ in range(warm):
        if flush is not None:
            flush()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(int(2e6 * min(2000.0, 3 * n * host_ms + 20)))
    for i in range(n):
        if flush is not None:
            flush()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[n // 2]


# ----------------------------------------------------------- kernels ----

def flash_decode_case(torch, rng, *, n_slots, hkv, G, q_len, d, page,
                      max_pages, n_pages, lengths, dtype):
    dev = "cuda"
    q = torch.randn((n_slots, q_len, hkv * G, d), generator=rng,
                    device=dev).to(dtype)
    k = torch.randn((hkv, n_pages, page, d), generator=rng,
                    device=dev).to(dtype)
    v = torch.randn((hkv, n_pages, page, d), generator=rng,
                    device=dev).to(dtype)
    tbl = torch.randint(1, n_pages, (n_slots, max_pages), generator=rng,
                        device=dev, dtype=torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, tbl, lens


def check_flash_decode(torch, fd, case, dtype):
    q, k, v, tbl, lens = case
    out = fd.flash_decode_cuda(q, k, v, tbl, lens, 1.0 / math.sqrt(q.shape[3]))
    ref = fd.paged_attention_reference(q, k, v, tbl, lens)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"flash_decode shape/dtype {out.shape}/{out.dtype}")
    check(bool(torch.isfinite(out.float()).all()), "flash_decode non-finite")
    # rows with no visible position must be exact zeros
    q_len = q.shape[1]
    vis = (lens[:, None] - q_len + 1
           + torch.arange(q_len, device=q.device)[None, :])
    dead = out[vis <= 0]
    check(bool((dead == 0).all()), "flash_decode inactive rows not zero")
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        tol = 1e-5 + 1e-5 * ref.float().abs()
    else:
        # p is rounded to bf16 before P.V, as on the TPU (kernel note)
        tol = torch.full_like(err, 2e-2)
    check(bool((err <= tol).all()),
          f"flash_decode {dtype} max err {err.max().item():.3e}")
    return err.max().item()


def check_layer_norm(torch, ln, rng, rows, hidden, dtype, rms=False):
    dev = "cuda"
    x = (torch.randn((rows, hidden), generator=rng, device=dev) * 2
         + 0.5).to(dtype)
    w = (torch.randn((hidden,), generator=rng, device=dev) * 0.5
         + 1).to(dtype)
    b = (None if rms else
         (torch.randn((hidden,), generator=rng, device=dev) * 0.1).to(dtype))
    y, mean, rstd = ln.norm_fwd_triton(x, w, b, 1e-5, rms)
    yr, meanr, rstdr = ln.norm_fwd_reference(x, w, b, 1e-5, rms)
    torch.cuda.synchronize()
    check(y.dtype == dtype and y.shape == x.shape, "layer_norm shape/dtype")
    err = (y.float() - yr.float()).abs()
    if dtype == torch.float32:
        tol = 1e-5 + 1e-5 * yr.abs()
    else:
        # at most one bf16 ulp of the plain value
        tol = torch.ldexp(torch.ones_like(err),
                          torch.frexp(yr.float().abs()).exponent - 8)
    check(bool((err <= tol).all()),
          f"layer_norm {dtype} ({rows},{hidden}) max err {err.max().item():.3e}")
    for a, r, what in ((mean, meanr, "mean"), (rstd, rstdr, "rstd")):
        check(bool(((a - r).abs() <= 1e-5 + 1e-5 * r.abs()).all()),
              f"layer_norm {what} ({rows},{hidden}) {dtype}")
    return err.max().item()


def profile_decode(torch, np, build_flagship_engine, params, steps=4):
    """Where a full-width decode step's time goes: 64 live slots (prompts
    of 1..96 tokens, so every request fits one page and all 64 are
    admitted at once), `steps` pure decode steps under torch.profiler.
    Returns the wall time per step, the device-busy share (kernel time
    summed over the window's wall time; one stream, so kernels do not
    overlap) and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    eng = build_flagship_engine(params=params)
    rng = np.random.RandomState(2)
    for _ in range(eng.serve_cfg.n_slots):
        eng.submit(rng.randint(0, eng.model_cfg.vocab_size,
                               int(rng.randint(1, 97))).tolist(), 32)
    for _ in range(3):                       # admit all, then warm up
        eng.step()
    g = eng.gauges()
    check(g["queue_depth"] == 0 and g["slots_live"] == eng.serve_cfg.n_slots,
          "profile: not every slot is live")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            check(eng.step() == (0, 0), "profile: a step churned")
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = {}                  # device-side events only: CPU ops
    for e in prof.key_averages():  # carry their kernels' time as well
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = (kernels.get(e.key, 0.0)
                              + e.self_device_time_total)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_ms_per_step": busy / steps / 1e3,
            "device_busy_share": busy / wall_us,
            "top_kernels_ms_per_step": {k[:80]: v / steps / 1e3
                                        for k, v in top}}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2

    from apex_tpu_torch import csrc
    from apex_tpu_torch.ops import flash_decode as fd
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops._common import strict_matmul_numerics
    from apex_tpu_torch.serve import engine as engine_mod
    from apex_tpu_torch.serve import build_flagship_engine, measure_decode

    t_start = time.perf_counter()
    strict_matmul_numerics()

    # ---- 1. device + build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    csrc.build(["flash_decode"])
    log(f"nvcc build {time.perf_counter() - t0:.1f}s")
    if os.path.exists(csrc.log_path("flash_decode")):
        with open(csrc.log_path("flash_decode")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log("ptxas: " + line.strip())

    # ---- 2. kernels vs plain -----------------------------------------
    rng = torch.Generator(device="cuda").manual_seed(1234)
    errs = {}
    bf16, f32 = torch.bfloat16, torch.float32
    # the serving path's shape: 64 slots, 16 heads of 64, page 128,
    # 2 pages per slot, a 65-page pool; lengths ragged with 0,
    # mid-page and page-aligned entries
    main_lengths = [0, 1, 5, 63, 127, 128, 129, 200, 255, 256, 0, 128]
    gl = torch.Generator().manual_seed(7)
    main_lengths += torch.randint(0, 257, (64 - len(main_lengths),),
                                  generator=gl).tolist()
    fd_main = flash_decode_case(
        torch, rng, n_slots=64, hkv=16, G=1, q_len=1, d=64, page=128,
        max_pages=2, n_pages=65, lengths=main_lengths, dtype=bf16)
    errs["flash_decode"] = check_flash_decode(torch, fd, fd_main, bf16)
    for dtype in (f32, bf16):
        for d in (64, 128):
            case = flash_decode_case(
                torch, rng, n_slots=4, hkv=2, G=2, q_len=2, d=d, page=16,
                max_pages=4, n_pages=17, lengths=[0, 5, 32, 64], dtype=dtype)
            e = check_flash_decode(torch, fd, case, dtype)
            log(f"flash_decode GQA G=2 q_len=2 d={d} {dtype}: "
                f"max err {e:.3e}")
    # 16 query rows per kv head (two row tiles), page 8, and a length
    # past the table's capacity (40 positions)
    case = flash_decode_case(
        torch, rng, n_slots=5, hkv=2, G=8, q_len=2, d=64, page=8,
        max_pages=5, n_pages=26, lengths=[0, 3, 17, 40, 45], dtype=f32)
    e = check_flash_decode(torch, fd, case, f32)
    log(f"flash_decode GQA G=8 q_len=2 page=8 float32: max err {e:.3e}")
    log(f"flash_decode main shape bf16: max err {errs['flash_decode']:.3e}")
    ln_errs = []
    for rows, hidden in ((64, 1024), (128, 1024), (5, 1000)):
        for dtype in (f32, bf16):
            e = check_layer_norm(torch, ln, rng, rows, hidden, dtype)
            log(f"layer_norm ({rows},{hidden}) {dtype}: max err {e:.3e}")
            if (rows, hidden, dtype) == (64, 1024, bf16):
                errs["layer_norm"] = e
            ln_errs.append(e)
    check_layer_norm(torch, ln, rng, 64, 1024, f32, rms=True)

    # ---- 3. the engine at full width ---------------------------------
    eng = build_flagship_engine()
    c, s = eng.model_cfg, eng.serve_cfg
    check((c.vocab_size, c.hidden, c.num_layers, c.num_heads, c.dtype,
           s.n_slots, eng.kv_config.page_size, eng.kv_config.n_pages)
          == (50304, 1024, 24, 16, bf16, 64, 128, 65),
          "flagship configuration drifted")
    prng = np.random.RandomState(0)
    n_req, max_new = 64, 32
    for _ in range(n_req):
        plen = int(prng.randint(1, s.max_prompt_len + 1))
        eng.submit(prng.randint(0, c.vocab_size, plen).tolist(), max_new)
    fd.flash_decode_cuda.launches = 0
    ln.norm_fwd_triton.launches = 0
    m = measure_decode(eng, max_steps=16 * max_new + 64)
    launches = {"flash_decode": fd.flash_decode_cuda.launches,
                "layer_norm": ln.norm_fwd_triton.launches}
    decode_steps = eng.sentry.calls
    prefills = eng.prefills
    fins = m["finished"]
    check(len(fins) == n_req, f"{len(fins)} of {n_req} requests finished")
    check(all(f.status == "ok" for f in fins), "a request did not end ok")
    check(all(len(f.tokens) == max_new for f in fins),
          "a request's token count is not its budget")
    check(all(0 <= t < c.vocab_size for f in fins for t in f.tokens),
          "token id out of vocab")
    check(m["recompile_ok"], f"recompile: {eng.sentry.summary()}")
    check(prefills == n_req == m["admitted"], f"prefills {prefills}")
    check(launches["flash_decode"] == c.num_layers * decode_steps > 0,
          f"flash_decode launches {launches['flash_decode']} != "
          f"{c.num_layers} x {decode_steps} decode steps")
    n_ln = 2 * c.num_layers + 1
    check(launches["layer_norm"] == n_ln * (decode_steps + prefills),
          f"layer_norm launches {launches['layer_norm']} != {n_ln} x "
          f"({decode_steps} decode steps + {prefills} prefills)")
    check(eng.cache.free_pages == eng.kv_config.usable_pages,
          "pool not drained")
    led = m["ledger"]
    engine_line = {
        "decode_tokens_per_s": m["tokens_per_sec"],
        "token_p50_ms": m["p50_ms"], "token_p99_ms": m["p99_ms"],
        "ttft_p50_ms": 1e3 * led["ttft_s"]["p50"],
        "ttft_p99_ms": 1e3 * led["ttft_s"]["p99"],
        "steps": m["steps"], "decode_steps": decode_steps,
        "prefills": prefills, "pure_decode_steps": m["pure_decode_steps"],
        "launches": launches,
        "logits_mm_out_dtype": eng._logits_out_dtype,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("engine " + json.dumps(engine_line))
    params = eng.params
    del eng
    log("decode step profile " + json.dumps(
        profile_decode(torch, np, build_flagship_engine, params)))

    # ---- 4. churn == solo, bitwise; kernel step == plain step --------
    crng = np.random.RandomState(1)
    prompts = [crng.randint(0, c.vocab_size,
                            int(crng.randint(1, 129))).tolist()
               for _ in range(8)]
    budgets = [4, 9, 3, 7, 12, 2, 8, 5]
    churn_eng = build_flagship_engine(n_slots=4, params=params)
    rids = [churn_eng.submit(p, b) for p, b in zip(prompts, budgets)]
    churn = {f.request_id: f.tokens for f in churn_eng.run()}
    check(churn_eng.recompile_ok and churn_eng.cache.free_pages
          == churn_eng.kv_config.usable_pages, "churn engine not drained")
    solo_eng = build_flagship_engine(n_slots=4, params=params)
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        solo_eng.submit(p, b)
        solo = solo_eng.run()[0].tokens
        check(solo == churn[rids[i]],
              f"stream {i}: churn {churn[rids[i]]} != solo {solo}")
    check(solo_eng.cache.free_pages == solo_eng.kv_config.usable_pages,
          "solo engine not drained")
    log("churn == solo: 8 streams bitwise equal")

    step_eng = build_flagship_engine(
        n_slots=4, params=params, serve_overrides={"emit_logits": True})
    for p in prompts[:4]:
        step_eng.submit(p, 8)
    step_eng.step()

    def one_step():
        kv = {k: v.clone() for k, v in step_eng.kv.items()}
        st = step_eng.state._replace(
            **{k: v.clone() for k, v in step_eng.state._asdict().items()})
        with torch.inference_mode():
            return step_eng.decode_step(step_eng.params, kv, st)[2]

    logits_k = one_step()
    plain_fd = (lambda *a, softmax_scale=None:
                fd.paged_attention_reference(*a, softmax_scale=softmax_scale))
    saved = engine_mod.flash_decode, engine_mod.fused_layer_norm
    engine_mod.flash_decode = plain_fd
    engine_mod.fused_layer_norm = ln.layer_norm_reference
    try:
        logits_p = one_step()
    finally:
        engine_mod.flash_decode, engine_mod.fused_layer_norm = saved
    torch.cuda.synchronize()
    step_err = (logits_k - logits_p).abs().max().item()
    scale = logits_p.abs().max().item()
    agree = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    log(f"decode step, kernels vs plain versions: max |dlogit| "
        f"{step_err:.4e} of max |logit| {scale:.4e}; argmax agreement "
        f"{agree:.2f}")
    check(math.isfinite(step_err) and step_err <= 0.05 * scale,
          "decode step through the kernels disagrees with the plain step")

    # ---- 5. kernel table ---------------------------------------------
    q, k, v, tbl, lens = fd_main
    sc = 1.0 / math.sqrt(q.shape[3])
    # a cold cache: read 64 MiB (more than the 50 MB L2) before each
    # launch.  A read leaves the L2 clean; a write would leave the timed
    # kernel paying for the write-back of dirty lines.
    flush_src = torch.ones(64 * 2 ** 20, dtype=torch.int8, device="cuda")
    flush_sink = torch.empty((), dtype=torch.int64, device="cuda")

    def flush():
        torch.sum(flush_src, dim=0, dtype=torch.int64, out=flush_sink)

    fd_ms = time_ms(torch, lambda: fd.flash_decode_cuda(
        q, k, v, tbl, lens, sc), flush=flush)
    fd_warm = time_ms(torch, lambda: fd.flash_decode_cuda(
        q, k, v, tbl, lens, sc))
    # how the kernel's time grows with the keys it reads: every slot at
    # length 0 (launch and exit), 1 (one key: the latency chain alone)
    # and 256 (both pages)
    scaling = {}
    for n in (0, 1, 256):
        ln_n = torch.full_like(lens, n)
        scaling[f"len{n}_ms"] = time_ms(torch, lambda: fd.flash_decode_cuda(
            q, k, v, tbl, ln_n, sc), flush=flush)
    log("flash_decode time by slot length (cold L2) " + json.dumps(scaling))
    fd_plain = time_ms(torch, lambda: fd.paged_attention_reference(
        q, k, v, tbl, lens, softmax_scale=sc), flush=flush)
    # library yardstick: SDPA over the cache gathered densely beforehand
    # (the gather is not timed) with the same position mask
    n_slots, hkv, d = q.shape[0], k.shape[0], q.shape[3]
    kd = k[:, tbl.long()].permute(1, 0, 2, 3, 4).reshape(n_slots, hkv, -1, d)
    vd = v[:, tbl.long()].permute(1, 0, 2, 3, 4).reshape(n_slots, hkv, -1, d)
    qd = q.permute(0, 2, 1, 3)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, None, None, :]
            < lens[:, None, None, None])
    fd_lib = time_ms(torch, lambda: torch.nn.functional
                     .scaled_dot_product_attention(qd, kd, vd,
                                                   attn_mask=mask),
                     flush=flush)
    vis_keys = sum(min(int(n), tbl.shape[1] * k.shape[2])
                   for n in lens.tolist())
    el = q.element_size()
    fd_bytes = (2 * vis_keys * hkv * d * el           # K and V rows read
                + 2 * q.numel() * el                   # q in, out
                + tbl.numel() * 4 + lens.numel() * 4)
    fd_ops = 4 * vis_keys * hkv * d                    # q.k and p.v
    fd_bound = 1e3 * max(fd_bytes / HBM_BYTES_PER_S, fd_ops / FP32_FLOPS)

    x = torch.randn((64, 1024), generator=rng, device="cuda").to(bf16)
    w = torch.randn((1024,), generator=rng, device="cuda").to(bf16)
    b = torch.randn((1024,), generator=rng, device="cuda").to(bf16)
    ln_ms = time_ms(torch, lambda: ln.norm_fwd_triton(x, w, b, 1e-5, False))
    ln_plain = time_ms(torch, lambda: ln.norm_fwd_reference(x, w, b, 1e-5))
    ln_lib = time_ms(torch, lambda: torch.nn.functional.layer_norm(
        x, (1024,), w, b, 1e-5))
    ln_bytes = 2 * x.numel() * 2 + 2 * 1024 * 2 + 2 * 64 * 4
    ln_ops = 8 * x.numel()
    ln_bound = 1e3 * max(ln_bytes / HBM_BYTES_PER_S, ln_ops / FP32_FLOPS)

    table = {"kernels": [
        {"name": "flash_decode", "route": "cuda",
         "source": "apex_tpu_torch/csrc/flash_decode.cu",
         "replaces": "apex_tpu/ops/flash_decode.py:205",
         "launches": launches["flash_decode"],
         "launches_per_decode_step": c.num_layers,
         "max_abs_err": errs["flash_decode"],
         "ms": fd_ms, "kernel_ms": fd_ms, "warm_l2_ms": fd_warm,
         "plain_ms": fd_plain,
         "bound_ms": fd_bound, "bound_by": "bytes", "library_ms": fd_lib,
         "library": "scaled_dot_product_attention on a pre-gathered cache",
         "shape": "q (64,1,16,64) bf16, pages (16,65,128,64), table (64,2)",
         "l2": "flushed (read) before each launch"},
        {"name": "layer_norm_fwd", "route": "triton",
         "source": "apex_tpu_torch/ops/layer_norm.py",
         "replaces": "apex_tpu/ops/layer_norm.py:58",
         "launches": launches["layer_norm"],
         "launches_per_decode_step": n_ln,
         "max_abs_err": errs["layer_norm"],
         "ms": ln_ms, "kernel_ms": ln_ms, "plain_ms": ln_plain,
         "bound_ms": ln_bound, "bound_by": "bytes", "library_ms": ln_lib,
         "library": "torch.nn.functional.layer_norm",
         "shape": "x (64,1024) bf16, affine", "l2": "warm"},
    ]}
    check(all(math.isfinite(r[key]) for r in table["kernels"]
              for key in ("ms", "plain_ms", "bound_ms", "library_ms")),
          "a timing is not finite")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
