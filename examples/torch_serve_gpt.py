"""Serve a GPT with continuous batching on the PyTorch port (counterpart
of examples/serve_gpt.py).

Decodes N concurrent ragged-length streams through `apex_tpu_torch.
serve`: paged KV cache, the flash-decode kernel, a fixed-shape slot
grid.  The engine's RecompileSentry is the correctness gate: this script
EXITS NONZERO if admission/retirement churn ever changed the steady-state
decode step's signature, so CI holds the "shapes never change" contract,
not just the throughput number.

usage:
  python examples/torch_serve_gpt.py                       # 64 streams
  python examples/torch_serve_gpt.py --streams 256 --max-new 32
  python examples/torch_serve_gpt.py --device cpu          # CPU smoke
  python examples/torch_serve_gpt.py --slo-ttft-p99-ms 500 \\
      --slo-token-p99-ms 50        # exit nonzero on an SLO breach

On the card `serve.build_flagship_engine` builds GPT-350M in bf16 (64
slots, pages of 128 tokens, prompts up to 128 tokens); with `--device
cpu` its smoke-size model substitutes through the same build path.
Besides the recompile gate, the run prints the request-lifecycle
ledger summary (TTFT / queue-wait percentiles, the pool-utilization
peak) and, when `--slo-*` thresholds are given, exits nonzero on a
`ServeSLO` breach verdict with the violated axis named.

Resilience: `--deadline-ms` attaches a TTL to every request (expired
ones are evicted, terminal state `expired`), and the process installs a
SIGTERM handler (restored when `main` returns) that runs the GRACEFUL
DRAIN path (stop admission, finish live slots, snapshot the queued
remainder) and exits nonzero if any live request was lost to a non-ok
terminal.  `--drain-after-steps N` triggers the same path
deterministically after N engine steps.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from apex_tpu_torch.ops._common import resolve_device  # noqa: E402
from apex_tpu_torch.serve import (ServeSLO, build_flagship_engine,  # noqa: E402
                                  measure_decode)

def _drain_and_report(eng, finished_by_rid, live_before):
    """The ONE drain path (SIGTERM and --drain-after-steps both land
    here): drain(), account for every request that was live when the
    drain began, and return an exit code — nonzero if any of them was
    LOST (no terminal record at all) or ended in a non-ok terminal."""
    snap = eng.drain()
    for f in eng.poll():
        finished_by_rid[f.request_id] = f
    queued = len(snap["scheduler"]["pending"])
    lost = [rid for rid in live_before if rid not in finished_by_rid]
    bad = [rid for rid in live_before
           if rid in finished_by_rid
           and finished_by_rid[rid].status != "ok"]
    print(f"drain: {len(live_before)} live finished, {queued} queued "
          f"request(s) in the restorable snapshot "
          f"(serve_state_version "
          f"{snap['serve_state_version']})")
    if lost or bad:
        print(f"FAIL: drain lost request(s) {lost} / non-ok terminals "
              f"{bad}", file=sys.stderr)
        return 1
    print("serve_gpt: drain OK (no live request lost)")
    return 0


def main(argv=None):
    """Returns the exit code."""
    ap = argparse.ArgumentParser(
        description="continuous-batching GPT decode demo")
    ap.add_argument("--streams", type=int, default=64,
                    help="concurrent request streams (default 64)")
    ap.add_argument("--max-new", type=int, default=None,
                    help="tokens to generate per request "
                         "(default: 16 CPU / 64 card)")
    ap.add_argument("--slots", type=int, default=None,
                    help="engine slots (default: min(streams, 64) — "
                         "fewer slots than streams exercises queueing)")
    ap.add_argument("--slo-ttft-p99-ms", type=float, default=None,
                    help="fail (exit nonzero) if the ledger's TTFT "
                         "p99 exceeds this many ms")
    ap.add_argument("--slo-token-p99-ms", type=float, default=None,
                    help="fail (exit nonzero) if the per-token p99 "
                         "exceeds this many ms")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request TTL: requests not served within "
                         "this many ms are evicted (terminal state "
                         "'expired')")
    ap.add_argument("--drain-after-steps", type=int, default=None,
                    help="run the graceful-drain path after N engine "
                         "steps (same code as SIGTERM) and exit — "
                         "nonzero if any live request is lost")
    ap.add_argument("--device", default=None, choices=(None, "cpu", "cuda"),
                    help="cpu runs the smoke-size engine on the plain "
                         "versions (default: the card)")
    args = ap.parse_args(argv)
    if args.streams < 1:
        ap.error("--streams must be >= 1")

    dev = resolve_device(args.device)
    n_slots = args.slots or min(args.streams, 64)
    max_new = args.max_new or (64 if dev.type == "cuda" else 16)
    eng = build_flagship_engine(n_slots=n_slots, device=dev)
    max_new = min(max_new, eng.serve_cfg.max_new_cap)
    cfg = eng.kv_config
    print(f"engine: {n_slots} slots, {cfg.n_pages} pages x "
          f"{cfg.page_size} tokens, pool "
          f"{cfg.pool_bytes() / 2**20:.1f} MiB "
          f"({cfg.bytes_per_user(eng.serve_cfg.max_prompt_len + max_new) / 2**10:.0f}"
          f" KiB per user worst-case)")

    rng = np.random.RandomState(0)
    mp = eng.serve_cfg.max_prompt_len
    rids = []
    for _ in range(args.streams):
        plen = int(rng.randint(1, mp + 1))
        prompt = rng.randint(0, eng.model_cfg.vocab_size, plen).tolist()
        rids.append(eng.submit(prompt, max_new,
                               deadline_ms=args.deadline_ms))

    # graceful shutdown for deploys: SIGTERM requests a drain; the drive
    # loops below honor it between steps (a signal handler must never
    # call drain() re-entrantly under a running step)
    flag = {"drain": False}

    def on_sigterm(signum, frame):
        flag["drain"] = True

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        return _serve(args, eng, max_new, flag)
    finally:
        signal.signal(signal.SIGTERM, previous)


def _serve(args, eng, max_new, flag):
    if args.drain_after_steps is not None:
        # the CI-drivable drain gate: N steps of normal serving, then
        # the exact SIGTERM path
        fins = {}
        for _ in range(args.drain_after_steps):
            if not eng.pending:
                break
            eng.step()
            for f in eng.poll():
                fins[f.request_id] = f
        live = [r.rid for r in eng._live.values()]
        return _drain_and_report(eng, fins, live)

    t0 = time.perf_counter()
    try:
        # sequential worst case bounds the drive so a scheduler
        # regression FAILS the gate instead of hanging it; the stop=
        # hook ends the drive between steps when SIGTERM lands, so
        # the drain below runs with the remainder genuinely pending
        m = measure_decode(eng, max_steps=args.streams * max_new + 64,
                           stop=lambda: flag["drain"])
    except RuntimeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    wall = time.perf_counter() - t0
    finished = m["finished"]

    if flag["drain"]:
        # SIGTERM landed mid-run: measure_decode returned between
        # steps with the remainder still pending — finish the live
        # slots, snapshot the queue, audit for lost work.  BEFORE the
        # stats prints: an early signal may have stopped the drive
        # with zero finished requests, and losing the drain to a
        # stats-formatting crash is the exact outcome this path exists
        # to prevent
        fins = {f.request_id: f for f in finished}
        return _drain_and_report(
            eng, fins, [r.rid for r in eng._live.values()])

    n_tok = sum(len(f.tokens) for f in finished)
    print(f"decoded {len(finished)} requests / {n_tok} tokens in "
          f"{wall:.2f}s ({n_tok / wall:.1f} tok/s end-to-end; "
          f"{m['tokens_per_sec']:.1f} tok/s post-warmup)")
    print(f"per-token latency p50 {m['p50_ms']:.2f} ms, "
          f"p99 {m['p99_ms']:.2f} ms over "
          f"{m['pure_decode_steps']} pure-decode of "
          f"{m['steps']} steps")
    sample = finished[0]
    print(f"sample request {sample.request_id}: {sample.n_prompt} prompt "
          f"tokens -> {sample.tokens[:8]}{'...' if len(sample.tokens) > 8 else ''}")
    print(f"sentry: {eng.sentry.summary()}")

    if not eng.recompile_ok:
        print("FAIL: steady-state recompile under churn — the fixed-"
              "shape contract broke (see docs/serving.md)",
              file=sys.stderr)
        return 1
    if len(finished) != args.streams:
        print(f"FAIL: {args.streams - len(finished)} request(s) never "
              "retired", file=sys.stderr)
        return 1
    n_expired = eng.telemetry.ledger.n_expired
    if args.deadline_ms is not None and n_expired:
        print(f"deadline plane: {n_expired} request(s) expired at "
              f"--deadline-ms {args.deadline_ms:g} (terminal state "
              "'expired'; balance "
              f"{eng.telemetry.ledger.balance()['ok']})")

    # the serving observatory: the request-lifecycle
    # ledger's live percentiles, and — when an SLO is given — the
    # verdict as an exit code (same posture as the sentry trip above:
    # CI holds the latency contract, not just the throughput print)
    led = eng.telemetry.ledger
    print(f"ledger: {led.n_retired} retired / {led.tokens_emitted} "
          f"tokens | ttft p50 {1e3 * led.ttft.percentile(50):.1f} ms "
          f"p99 {1e3 * led.ttft.percentile(99):.1f} ms | queue-wait "
          f"p99 {1e3 * led.queue_wait.percentile(99):.1f} ms | pool "
          f"util peak {eng.telemetry.peaks['pool_util']:.2f}")
    if (args.slo_ttft_p99_ms is not None
            or args.slo_token_p99_ms is not None):
        slo = ServeSLO(ttft_p99_ms=args.slo_ttft_p99_ms,
                       per_token_p99_ms=args.slo_token_p99_ms)
        verdict = eng.slo_verdict(slo)
        print(verdict.describe())
        if not verdict.ok:
            print("FAIL: serve SLO breach (axes: "
                  + ", ".join(b.axis for b in verdict.breaches) + ")",
                  file=sys.stderr)
            return 1
    print("serve_gpt: OK (zero steady-state recompiles)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
