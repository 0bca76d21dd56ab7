"""Make `tests/fixtures/torch_h100_step.trace.json.gz`, the trimmed card
trace the timeline tests parse (run on a machine with a card, from the
repository's root):

    python3 tests/fixtures/torch_trace_fixture.py [OUT]

A small GPT (2 layers, hidden 256, 4 heads, seq 256, batch 4, bf16,
flash attention, sequence parallelism) takes steps through
`make_tp_dp_train_step` on one-rank NCCL tp and dp groups, so that
every collective of the step is issued, under
`monitor.ProfileCapture(range(2, 4))`.  The second captured step is
kept: the metadata rows of the host and device processes, then every
complete event in the step's window except `cpu_op` and
`python_function` (the host's op tree, thousands of rows), and a
`"fixture"` key that says so.  It prints what it kept, by category.
"""

import collections
import gzip
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "fixtures",
                   "torch_h100_step.trace.json.gz")
DROPPED = ("cpu_op", "python_function")


def capture(logdir):
    import tempfile

    import torch
    import torch.distributed as dist

    from apex_tpu_torch import csrc, monitor
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.transformer.training import (
        init_sharded_optimizer, make_tp_dp_train_step)

    csrc.build(["flash_attention", "layer_norm"])
    os.environ.setdefault("APEX_TPU_TUNE_CACHE", os.path.join(
        tempfile.mkdtemp(), "tune.json"))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh.initialize_model_parallel(tensor_model_parallel_size=1)
        bf16 = torch.bfloat16
        model = gpt_mod.GPT(gpt_mod.GPTConfig(
            vocab_size=512, seq_len=256, hidden=256, num_layers=2,
            num_heads=4, dropout=0.0, dtype=bf16, logits_dtype=bf16,
            use_flash_attention=True, sequence_parallel=True,
            overlap_chunks=1))
        opt = FusedAdam(lr=1e-4, master_dtype=bf16)
        state = init_sharded_optimizer(opt, model, model.init(seed=0))
        step = make_tp_dp_train_step(model, opt)
        gen = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, 512, (4, 256), generator=gen,
                               device="cuda", dtype=torch.int32)
        labels = torch.roll(tokens, -1, dims=1)
        cap = monitor.profile_capture(range(2, 4), logdir=logdir)
        for i in range(4):
            with cap.step(i):
                state, _ = step(state, tokens, labels)
        cap.close()
        return cap.trace_path()
    finally:
        mesh.destroy_model_parallel()
        dist.destroy_process_group()


def trim(path, step=3, annotation="train-step"):
    with gzip.open(path, "rt") as f:
        obj = json.load(f)
    events = obj["traceEvents"]
    marks = [e for e in events if e.get("name") == f"{annotation}#{step}"]
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    keep_pids = {e["pid"] for e in events if e.get("ph") == "X"
                 and lo <= e.get("ts", -1) <= hi
                 and e.get("cat") not in DROPPED}
    kept = [e for e in events if e.get("ph") == "M"
            and e.get("pid") in keep_pids]
    kept += [e for e in events if e.get("ph") == "X"
             and e.get("cat") not in DROPPED
             and isinstance(e.get("pid"), int)
             and lo <= e.get("ts", -1) and e["ts"] + e.get("dur", 0) <= hi]
    return {"traceEvents": kept,
            "deviceProperties": obj.get("deviceProperties"),
            "fixture": f"step {step} of a torch.profiler capture through "
                       f"monitor.ProfileCapture (tests/fixtures/"
                       f"torch_trace_fixture.py); {', '.join(DROPPED)} "
                       f"rows left out"}


def main(argv):
    import tempfile

    out = argv[1] if len(argv) > 1 else OUT
    with tempfile.TemporaryDirectory() as logdir:
        fixture = trim(capture(logdir))
    with gzip.open(out, "wt") as f:
        json.dump(fixture, f)
    cats = collections.Counter(e.get("cat", "M")
                               for e in fixture["traceEvents"])
    print(json.dumps({"out": out, "events": len(fixture["traceEvents"]),
                      "by_category": cats}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv))
