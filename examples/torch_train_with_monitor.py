"""Train the minimal GPT with full telemetry on the PyTorch port
(counterpart of examples/train_with_monitor.py).

The smallest end-to-end `apex_tpu_torch.monitor` loop: a tiny GPT trains
with the data-parallel step (`ddp.make_train_step`) under dynamic loss
scaling, with a `MetricsState` riding through the step on the device.
The host logs every step to a metrics JSONL (schema-validated) and the
console, with step time, tokens/sec and MFU derived by `MetricsLogger`;
`--profile-dir` arms a `torch.profiler` capture over steps 1-2.

`--flight-report PATH` arms the numerics flight recorder: the step is
built with `trace=True` (per-layer stat taps + cross-rank timing),
every step lands in a bounded ring buffer, and any exception in the loop
dumps a JSON crash report to PATH.  Before the loop the step is audited
once (`monitor.analyze_step`, on clones of its arguments, with its
comms report) and the audit rides in the report, so a crash dump
carries the memory budget table.  `--crash-at N` raises mid-loop at
step N to exercise exactly that path.

`--profile-steps A:B` arms a `ProfileCapture` over steps [A, B) and,
after the loop, parses the trace it wrote with the timeline
observatory: the measured per-step anatomy table prints, the records
after the window stamp the `timeline_*` fields, and on the card the
script exits nonzero if the trace parsed to zero device events (a CPU
trace has no device lanes: there it must hold the captured steps).

`--ckpt-dir PATH` arms checkpointing: a `checkpoint.CheckpointManager`
saves the optimizer + scaler state every `--ckpt-every` steps, the
logger stamps the ckpt_* fields, and `--resume` restores the latest
committed step (and the batch generator's state) before training.

The JAX example's phase timers (`utils.timers`) are not ported, so the
step's wall time is the logger's own; its `--force-cpu-devices` has no
counterpart (the world is the launcher's, one rank without it).

  python examples/torch_train_with_monitor.py --steps 10 \\
      --jsonl /tmp/metrics.jsonl [--profile-steps 3:6] \\
      [--flight-report /tmp/flight.json [--crash-at N]] \\
      [--ckpt-dir /tmp/ckpt [--ckpt-every N] [--resume]] \\
      [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from apex_tpu_torch import amp, monitor  # noqa: E402
from apex_tpu_torch.models.gpt import GPT, GPTConfig  # noqa: E402
from apex_tpu_torch.ops._common import resolve_device  # noqa: E402
from apex_tpu_torch.optimizers import FusedAdam  # noqa: E402
from apex_tpu_torch.parallel import ddp  # noqa: E402
from apex_tpu_torch.parallel import mesh as M  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--jsonl", default=_os.path.join(
        tempfile.gettempdir(), "torch_train_with_monitor.jsonl"))
    ap.add_argument("--profile-dir", default=None,
                    help="arm profile_capture over steps 1-2, traces here")
    ap.add_argument("--profile-steps", default=None, metavar="A:B",
                    help="capture steps [A, B) and print the measured "
                         "timeline anatomy after the loop (traces land "
                         "in --profile-dir or a temp dir)")
    ap.add_argument("--flight-report", default=None,
                    help="arm the numerics flight recorder; crash "
                         "report JSON dumps here")
    ap.add_argument("--flight-capacity", type=int, default=8,
                    help="flight-recorder ring depth (steps)")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="raise mid-loop at this step (crash-dump demo)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="arm checkpointing; committed steps land under "
                         "this directory")
    ap.add_argument("--ckpt-every", type=int, default=5,
                    help="checkpoint cadence in steps")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest committed checkpoint from "
                         "--ckpt-dir before training")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card) or cpu")
    return ap.parse_args(argv)


def _capture(args, dev):
    if args.profile_steps:
        try:
            a, b = (int(x) for x in args.profile_steps.split(":"))
        except ValueError:
            raise SystemExit(
                f"--profile-steps wants A:B, got {args.profile_steps!r}")
        if b <= a:
            raise SystemExit("--profile-steps A:B needs A < B")
        return monitor.profile_capture(
            range(a, b), device=dev, logdir=args.profile_dir
            or tempfile.mkdtemp(prefix="torch_train_with_monitor_trace_"))
    if args.profile_dir:
        return monitor.profile_capture(range(1, 3), logdir=args.profile_dir,
                                       device=dev)
    return monitor.ProfileCapture((), device=dev)


def main(argv=None):
    args = parse(argv)
    dev = resolve_device(args.device)
    M.initialize_model_parallel()
    dp = M.group_size(M.data_parallel_group())
    if args.batch % dp:
        raise SystemExit(f"--batch {args.batch} not divisible by dp={dp}")
    local_batch = args.batch // dp

    cfg = GPTConfig(vocab_size=128, seq_len=32, hidden=64, num_layers=2,
                    num_heads=4, dropout=0.0)
    model = GPT(cfg)
    params = model.init(seed=0, device=dev)

    # dynamic loss scaling exercises the scale/overflow telemetry even in
    # this fp32 config (the scaler state is precision-agnostic)
    amp_state = amp.initialize(opt_level="O0", loss_scale="dynamic",
                               device=dev)
    scaler = amp_state.loss_scalers[0]
    opt = FusedAdam(lr=1e-3)
    opt_state = opt.init(params)

    manager = None
    start_step = 0  # saves number from here: a resumed run must not
    # restart at step 1 and overwrite earlier commits
    if args.ckpt_dir:
        from apex_tpu_torch.checkpoint import CheckpointManager
        manager = CheckpointManager(args.ckpt_dir, opt,
                                    every_n_steps=args.ckpt_every)

    def loss_fn(p, batch):
        tokens, labels = batch
        return model.loss(p, tokens, labels)

    flight = args.flight_report is not None
    trace_cfg = (monitor.TraceConfig(taps=True, rank_timing=True)
                 if flight else None)
    train_step = ddp.make_train_step(loss_fn, opt, amp_state=amp_state,
                                     metrics=True, trace=trace_cfg,
                                     device=dev)
    recorder = None
    if flight:
        recorder = monitor.FlightRecorder(
            args.flight_report, capacity=args.flight_capacity,
            straggler=monitor.StragglerDetector())
    # the sentry counts signatures (events land in the flight ring), the
    # logger stamps n_compiles and the hbm_* watermarks (null on the CPU)
    sentry = monitor.RecompileSentry(train_step, recorder=recorder)

    logger = monitor.MetricsLogger(
        [monitor.JSONLSink(args.jsonl), monitor.ConsoleSink()],
        flops_per_step=monitor.gpt_step_flops(cfg, args.batch),
        peak_flops=monitor.device_peak_flops() * dp,
        taps=flight, sentry=sentry, memory=True, ckpt=manager)
    metrics = monitor.init_metrics(dev)
    cap = _capture(args, dev)

    gen = torch.Generator().manual_seed(1 + M.group_rank(
        M.data_parallel_group()))

    def make_batch():
        tokens = torch.randint(0, cfg.vocab_size, (local_batch, cfg.seq_len),
                               generator=gen, dtype=torch.int32)
        return (tokens.to(dev), torch.roll(tokens, -1, dims=1).to(dev))

    box = {"opt": opt_state, "scaler": scaler}

    def run_step(batch, metrics, timing_row):
        if not flight:
            return sentry(box["opt"], box["scaler"], batch,
                          metrics) + (None, None)
        # a host tensor: the step moves it to its device without a sync
        return sentry(box["opt"], box["scaler"], batch, metrics,
                      torch.tensor(timing_row, dtype=torch.float32))

    prev_durations = (0.0, 0.0)
    if flight:
        # the step audited once, on clones of its arguments: the crash
        # dump then carries the memory budget table and the comms plane.
        # Advisory: a failed audit must not stop the run
        try:
            audit_args = (box["opt"], box["scaler"], make_batch(), metrics,
                          torch.tensor(prev_durations, dtype=torch.float32))
            recorder.attach_compile_report(monitor.analyze_step(
                train_step, audit_args,
                analytic_flops=monitor.gpt_step_flops(cfg, args.batch),
                comms=True))
        except Exception as e:
            print(f"step audit unavailable: {e!r}")

    # two unlogged warm-up steps, then restart the rate window, so that
    # the first record's rates measure training, not first-call costs
    for _ in range(2):
        out = run_step(make_batch(), metrics, prev_durations)
        box["opt"], box["scaler"], _, metrics = out[:4]
    if manager is not None and args.resume:
        # restore only now, the warm-up paid on throwaway state: the
        # resumed trajectory continues from the committed step
        if manager.last_committed_step is not None:
            box["opt"], restored_scaler, manifest = manager.restore(dev)
            if restored_scaler is not None:
                box["scaler"] = restored_scaler
            start_step = int(manifest["step"])
            model_state = manager.restore_model_state(step=start_step)
            if "rng_state" in model_state:
                gen.set_state(torch.as_tensor(
                    model_state["rng_state"]).to(torch.uint8))
            print(f"resumed from committed checkpoint step {start_step}")
        else:
            print(f"--resume: no committed checkpoint under "
                  f"{args.ckpt_dir}; starting fresh")
    logger.reset_timer(metrics)
    sentry.mark_steady()

    with (recorder.guard() if flight else cap):
        for i in range(args.steps):
            batch = make_batch()
            t0 = time.perf_counter()
            with cap.step(i):
                out = run_step(batch, metrics, prev_durations)
                box["opt"], box["scaler"], loss, metrics = out[:4]
                tap_state, rank_timings = out[4], out[5]
            prev_durations = (time.perf_counter() - t0, 0.0)
            if args.profile_steps and logger.timeline is None \
                    and not cap.active and cap.trace_path() is not None:
                # the window just closed: the remaining records stamp
                # the timeline_* fields
                logger.timeline = monitor.analyze_trace(cap.trace_path())
            rec = logger.log_step(
                metrics, taps=tap_state,
                tap_names=train_step.tap_names() if flight else None)
            if recorder is not None:
                recorder.record(i, metrics=rec, taps=tap_state,
                                timings=rank_timings,
                                tap_names=train_step.tap_names())
            if manager is not None:
                manager.maybe_save(start_step + i + 1, box["opt"],
                                   box["scaler"],
                                   model_state={"rng_state":
                                                gen.get_state()})
            if args.crash_at is not None and i == args.crash_at:
                raise RuntimeError(
                    f"injected crash at step {i} (--crash-at)")
    cap.close()
    if args.profile_steps:
        rep = logger.timeline
        if rep is None:
            tp = cap.trace_path()
            if tp is None:
                raise SystemExit(
                    "--profile-steps: no trace was captured — does the "
                    "window overlap [0, --steps)?")
            rep = monitor.analyze_trace(tp)
        print(monitor.render_timeline_table(
            rep, label=f"steps {args.profile_steps}"))
        if dev.type == "cuda" and rep.n_device_events == 0:
            raise SystemExit(
                "--profile-steps: the trace parsed to ZERO device "
                "events — the capture wiring is broken")
        if not rep.steps or rep.steps[0].step < 0:
            raise SystemExit("--profile-steps: the trace holds no "
                             "captured step")
    if manager is not None:
        manager.wait()
        print(f"last committed checkpoint: step "
              f"{manager.last_committed_step}")
    logger.close()
    print(f"wrote {args.steps} metric records to {args.jsonl} "
          f"({args.batch * cfg.seq_len} tokens/step)")
    if recorder is not None:
        recorder.dump(reason="run completed")
        print(f"flight report at {args.flight_report}")


if __name__ == "__main__":
    main()
