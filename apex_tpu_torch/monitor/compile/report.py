"""The step audit: `analyze_step(step_fn, args) -> CompileReport`
(counterpart of apex_tpu/monitor/compile/report.py, with its report,
budget classes and table).

The JAX audit lowers and compiles the step without executing it and
reads XLA's memory and cost analyses.  An eager PyTorch step has no
compiled program, so the port runs the step ONCE, on clones of `args`
(the caller's tensors are never touched: the optimizer and scaler
states are step arguments, and the step updates its own clones in
place), and fills the report from what that run shows:

  * argument / output bytes: the tensors' storages, each counted once;
  * alias bytes: outputs whose storage is an argument's (the state the
    step updates in place, PyTorch's donation);
  * temp bytes: the allocator's peak over the step above what was
    resident before it (`torch.cuda.max_memory_allocated`; None on the
    CPU, which has no such counter);
  * flops: counted, not estimated: `torch.utils.flop_counter.
    FlopCounterMode` over the run sees ATen's matmuls, and the launchers
    of the port's own matmul kernels (the flash attention kernels, the
    fused dense GEMM) add theirs through `ops._common.add_kernel_flops`,
    which a flop counter cannot see;
  * generated code bytes and bytes accessed: None (no counterpart).

The two questions the JAX audit answers are answered the same way:

  * did donation take?  `donated` (default: the step's
    `donate_argnums`, its state arguments) are the arguments the step
    should update in place; `undonated_bytes` are the bytes of their
    tensors whose storage no output reuses, and `donation_ok` allows
    `DONATION_TOL` of them (a step counter the optimizer replaces);
  * does the flop accounting of `monitor.flops` agree with the counted
    flops?  `flops_divergence` above `flops_tol` (default 10%) flags the
    accounting before a wrong MFU lands in a table.

The run leaves the caller's state bit for bit as it was: the arguments
are cloned, and the global RNG states (CPU and CUDA) are restored
after it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from apex_tpu_torch.ops import _common

# donated bytes may legitimately not alias in full: small leaves the
# step replaces rather than updates (an int32 step counter) ride inside
# big donated states.  5% covers those without masking a real failure:
# a lost master copy is a third of the state.
DONATION_TOL = 0.05


@dataclasses.dataclass
class CompileReport:
    """One audited step's memory/cost anatomy (host-side, JSON-able via
    `to_dict`).  A field with no counterpart in an eager run is None,
    never made up.

    Bytes fields are one device's.  `flops` is the counted total of one
    step; `analytic_flops` is the caller's `monitor.flops` accounting
    when given.  `budget` is the memory budget table: the per-argument
    bytes classified into params / optimizer_state / inputs (see
    `analyze_step`), plus the run's output and temp terms.
    """

    backend: str
    device_kind: Optional[str]
    argument_bytes: Optional[int]
    output_bytes: Optional[int]
    temp_bytes: Optional[int]
    alias_bytes: Optional[int]
    generated_code_bytes: Optional[int]
    flops: Optional[float]
    bytes_accessed: Optional[float]
    # per top-level argument bytes, keyed by arg name
    arg_bytes: dict
    # donation verification
    donated_bytes: int
    undonated_bytes: Optional[int]
    donation_ok: Optional[bool]
    # flops cross-check vs monitor.flops analytic accounting
    analytic_flops: Optional[float]
    flops_divergence: Optional[float]
    flops_ok: Optional[bool]
    # budget classification (params / optimizer_state / inputs /
    # activations_temps / outputs / generated_code)
    budget: dict
    # the JAX package's static-analysis attachment; the port's linter is
    # not ported, so this stays None
    lint: Optional[dict] = None
    # analyze_step(..., comms=True): `comms_report`'s dict from the SAME
    # run, so that a crash dump carrying this report carries the
    # communication anatomy too
    comms: Optional[dict] = None

    def to_dict(self) -> dict:
        """Flat JSON-able dict (what the flight recorder attaches)."""
        return dataclasses.asdict(self)


# ------------------------------ tensors ------------------------------

def _leaves(tree):
    """The tensors of a tree of tuples (named ones too), lists and
    dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def tree_bytes(tree) -> int:
    """Total bytes of a tree of tensors (numel x element size a leaf,
    the JAX package's count of an array tree)."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _storages(tree) -> dict:
    """{storage address: its bytes} of the tensors of a tree."""
    out = {}
    for t in _leaves(tree):
        s = t.untyped_storage()
        out[s.data_ptr()] = s.nbytes()
    return out


def _clone(tree, memo):
    """A copy of the tree whose tensors are clones that share storage
    where the originals did (views of one buffer stay views of one
    clone), and whose generators are copies."""
    if isinstance(tree, torch.Tensor):
        base = tree.untyped_storage()
        key = base.data_ptr()
        if key not in memo:
            memo[key] = base.clone()
        c = torch.empty(0, dtype=tree.dtype, device=tree.device)
        c.set_(memo[key], tree.storage_offset(), tree.shape, tree.stride())
        return c.requires_grad_(tree.requires_grad)
    if isinstance(tree, torch.Generator):
        g = torch.Generator(device=tree.device)
        g.set_state(tree.get_state())
        return g
    if isinstance(tree, dict):
        return type(tree)((k, _clone(v, memo)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v, memo) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v, memo) for v in tree)
    return tree


def _device_of(args) -> torch.device:
    for t in _leaves(args):
        if t.device.type == "cuda":
            return t.device
    return torch.device("cpu")


def _device_info(dev: torch.device):
    """(backend, device_kind) as the JAX package names them."""
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev)
    return "cpu", "cpu"


class _OpCount(TorchDispatchMode):
    """Counts the ATen ops a run dispatches (the inventory's n_between)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@dataclasses.dataclass
class _Run:
    """What one audited run of a step shows."""

    device: torch.device
    args: list          # the clones the step ran on
    outputs: Any
    flops: float
    temp_bytes: Optional[int]
    inventory: Optional[list] = None


def audit_run(step_fn, args: Sequence[Any], *,
              inventory: bool = False) -> _Run:
    """Run `step_fn` once on clones of `args` under a flop count (and,
    with `inventory`, the collective recorder), restoring the global RNG
    states after it."""
    from apex_tpu_torch.monitor.comms import inventory as inv

    dev = _device_of(args)
    cpu_rng = torch.get_rng_state()
    cuda_rng = (torch.cuda.get_rng_state_all()
                if torch.cuda.is_available() and torch.cuda.is_initialized()
                else None)
    clones = _clone(list(args), {})
    resident = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
    fc = FlopCounterMode(display=False)
    ops = _OpCount()
    rec = None
    try:
        with contextlib.ExitStack() as stack:
            kbox = stack.enter_context(_common.kernel_flop_count())
            stack.enter_context(fc)
            stack.enter_context(ops)
            if inventory:
                rec = inv.InventoryRecorder(
                    flops_now=lambda: fc.get_total_flops() + kbox[0],
                    ops_now=lambda: ops.n)
                stack.enter_context(inv.recording(rec))
            outputs = step_fn(*clones)
        flops = float(fc.get_total_flops() + kbox[0])
    finally:
        torch.set_rng_state(cpu_rng)
        if cuda_rng is not None:
            torch.cuda.set_rng_state_all(cuda_rng)
    temp = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        temp = max(0, torch.cuda.max_memory_allocated(dev) - resident)
    return _Run(device=dev, args=clones, outputs=outputs, flops=flops,
                temp_bytes=temp,
                inventory=None if rec is None else rec.entries)


def _classify_budget(args: Sequence[Any], names: Sequence[str]) -> dict:
    """Split the argument bytes into the budget classes an operator
    reasons in (the JAX package's classes and convention): an arg named
    `opt_state` with NamedTuple fields contributes its master buffer
    (`params` / `params_shard` fields) to "params" and the rest (moments,
    step counter) to "optimizer_state"; an arg whose name contains
    `kv_cache` or `page` is the serving path's paged KV pool; an arg
    named `params` is a bare weight tree; every other arg counts as
    "inputs" (batch, scaler, metrics, timing rows)."""
    params = opt_state = inputs = kv_cache = 0
    for name, arg in zip(names, args):
        if name == "opt_state" and hasattr(arg, "_fields"):
            for field in arg._fields:
                b = tree_bytes(getattr(arg, field))
                if field in ("params", "params_shard"):
                    params += b
                else:
                    opt_state += b
        elif "kv_cache" in name or "page" in name:
            kv_cache += tree_bytes(arg)
        elif name == "params":
            params += tree_bytes(arg)
        else:
            inputs += tree_bytes(arg)
    return {"params": params, "optimizer_state": opt_state,
            "inputs": inputs, "kv_cache": kv_cache}


def analyze_step(step_fn, args: Sequence[Any], *,
                 donated: Optional[Sequence[int]] = None,
                 arg_names: Optional[Sequence[str]] = None,
                 analytic_flops: Optional[float] = None,
                 flops_tol: float = 0.10,
                 donation_tol: float = DONATION_TOL,
                 lint: bool = False,
                 comms: bool = False) -> CompileReport:
    """Run `step_fn(*args)` once on clones of `args` and return the
    `CompileReport`.

    step_fn: any callable; the steps `ddp.make_train_step` and
    `make_tp_dp_train_step` return carry `arg_names`, `donate_argnums`
    and the mesh's axes, which label the report.  donated: indices into
    `args` whose tensors the step updates in place; None reads
    `step_fn.donate_argnums`, () skips the donation check.  arg_names
    labels the budget table (None reads `step_fn.arg_names`, falling back
    to `arg{i}`).  analytic_flops: the `monitor.flops` count of one step,
    held against the counted flops.  comms: also attach `comms_report`'s
    dict, taken from the SAME run.  lint: the JAX package's static
    program passes; the port's linter is not ported (ROADMAP item 26),
    so lint=True raises NotImplementedError."""
    if lint:
        raise NotImplementedError(
            "analyze_step(lint=True): the static linter (ROADMAP item 26) "
            "is not ported to apex_tpu_torch yet")
    if donated is None:
        donated = getattr(step_fn, "donate_argnums", ())
    if arg_names is None:
        arg_names = getattr(step_fn, "arg_names", None)
    names = list(arg_names) if arg_names is not None else []
    names += [f"arg{i}" for i in range(len(names), len(args))]
    names = names[:len(args)]

    run = audit_run(step_fn, args, inventory=comms)
    backend, device_kind = _device_info(run.device)
    arg_st = _storages(run.args)
    out_st = _storages(run.outputs)
    alias = sum(b for p, b in out_st.items() if p in arg_st)

    per_arg = {nm: tree_bytes(a) for nm, a in zip(names, args)}
    donated = [i for i in donated if 0 <= i < len(args)]
    donated_bytes = sum(tree_bytes(args[i]) for i in donated)
    undonated = sum(t.numel() * t.element_size()
                    for i in donated for t in _leaves(run.args[i])
                    if t.untyped_storage().data_ptr() not in out_st)
    donation_ok = (undonated <= donated_bytes * donation_tol
                   if donated_bytes else True)

    divergence = flops_ok = None
    if analytic_flops and run.flops:
        divergence = abs(run.flops - float(analytic_flops)) \
            / max(float(analytic_flops), 1.0)
        flops_ok = divergence <= flops_tol

    out_bytes = sum(out_st.values())
    budget = _classify_budget(args, names)
    budget["activations_temps"] = run.temp_bytes
    budget["outputs"] = out_bytes
    budget["generated_code"] = None

    report = CompileReport(
        backend=backend, device_kind=device_kind,
        argument_bytes=int(sum(arg_st.values())),
        output_bytes=int(out_bytes),
        temp_bytes=run.temp_bytes,
        alias_bytes=int(alias),
        generated_code_bytes=None,
        flops=run.flops,
        bytes_accessed=None,
        arg_bytes=per_arg,
        donated_bytes=int(donated_bytes),
        undonated_bytes=int(undonated),
        donation_ok=bool(donation_ok),
        analytic_flops=(None if analytic_flops is None
                        else float(analytic_flops)),
        flops_divergence=divergence,
        flops_ok=flops_ok,
        budget=budget,
    )
    if comms:
        from apex_tpu_torch.monitor.comms import report as comms_lib
        report.comms = comms_lib.comms_report(
            step_fn, args, inventory=run.inventory, flops=run.flops,
            device=run.device).to_dict()
    del run
    return report


def _human_bytes(b) -> str:
    if b is None:
        return "n/a"
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if b >= div:
            return f"{b / div:.2f} {unit}"
    return f"{int(b)} B"


def render_budget_table(report) -> str:
    """The memory budget table, the thing an operator reads before
    picking a batch size (the JAX package's table, line for line).
    Accepts a CompileReport or its to_dict() (the crash dump attaches
    the dict form).  Its labels are the JAX package's ("xla" names the
    step's counted flops), so that both packages render one report
    dict to the same text."""
    r = report.to_dict() if hasattr(report, "to_dict") else dict(report)
    budget = r.get("budget") or {}
    lines = [
        "=== HBM budget ===",
        f"backend: {r.get('backend')}"
        + (f" ({r['device_kind']})" if r.get("device_kind") else ""),
        "| class               |       size |",
        "|---|---|",
    ]
    for key, label in (("params", "params (master)"),
                       ("optimizer_state", "optimizer state"),
                       ("kv_cache", "kv cache (pages)"),
                       ("inputs", "inputs (batch etc.)"),
                       ("activations_temps", "activations + temps"),
                       ("outputs", "outputs"),
                       ("generated_code", "generated code")):
        if key == "kv_cache" and not budget.get(key):
            continue          # training steps have no pool; keep tables tidy
        lines.append(f"| {label:<19} | "
                     f"{_human_bytes(budget.get(key)):>10} |")
    alias = r.get("alias_bytes")
    if alias is not None:
        lines.append(f"| aliased (donated)   | "
                     f"{_human_bytes(alias):>10} |")
    don = r.get("donation_ok")
    if don is False:
        lines.append(
            f"** DONATION FAILED: "
            f"{_human_bytes(r.get('undonated_bytes'))} of "
            f"{_human_bytes(r.get('donated_bytes'))} donated input NOT "
            "aliased — a second state copy is alive")
    elif don is True and r.get("donated_bytes"):
        lines.append("donation: ok (donated state aliases in place)")
    if r.get("flops_ok") is False:
        lines.append(
            f"** FLOPS ACCOUNTING DIVERGES: xla {r.get('flops'):.3e} vs "
            f"analytic {r.get('analytic_flops'):.3e} "
            f"({100 * r.get('flops_divergence'):.0f}% — MFU numbers "
            "derived from the analytic count are suspect)")
    elif r.get("flops_divergence") is not None:
        lines.append(
            f"flops: xla agrees with analytic accounting to "
            f"{100 * r['flops_divergence']:.1f}%")
    lint = r.get("lint")
    if lint is not None:
        if lint.get("ok"):
            lines.append("lint: clean (static program passes)")
        else:
            rules = sorted({f.get("rule", "?")
                            for f in lint.get("findings") or []})
            # a lint attachment comes from the JAX package's audit, whose
            # linter the line names
            lines.append(
                f"** LINT: {len(lint.get('findings') or [])} "
                f"finding(s) [{', '.join(rules)}] — run "
                "scripts/lint_step.py for the full report")
    comms = r.get("comms")
    if comms is not None:
        if comms.get("collectives") is None:       # analyzer crashed
            lines.append(f"comms: unavailable "
                         f"({comms.get('error', '?')[:80]})")
        else:
            n = sum((comms.get("counts") or {}).values())
            total = comms.get("total_comm_bytes", 0)
            if comms.get("overlap_ok"):
                verdict = ("overlap ok" if comms.get("async_supported")
                           else "overlap n/a on this backend")
            else:
                n_ser = sum(1 for c in comms["collectives"]
                            if c.get("serialized"))
                verdict = f"** {n_ser} SERIALIZED"
            lines.append(
                f"comms: {n} collective(s), {_human_bytes(total)} — "
                f"{verdict} (render_comms_table for the full table)")
    return "\n".join(lines)
