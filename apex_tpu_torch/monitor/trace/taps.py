"""Device side of the numerics flight recorder: the `TapState` record
(counterpart of apex_tpu/monitor/trace/taps.py).

Everything is computed in the step from values it already holds, with no
host sync and no collective a tap.  The tap op lives in `ops._common`
(the models call it on their hot path and must not import the monitor
package); this module owns the record the hot paths return and the
host-side helpers that read it.

How stats get out of autograd: each `tap(x, name)` takes a zeros (2, 4)
row of a `probes` tensor the step differentiates; the tap's backward
returns `[tap_stats(x), tap_stats(grad)]` as that row's gradient.
`finalize()` slices the used rows, unscales the gradient plane by the
loss scale and computes the first-nonfinite provenance indices, all on
the device.

Provenance convention: the FORWARD plane reads in forward order, so
`first_bad_fwd` is the MINIMUM tapped index with a non-finite value,
the earliest layer where the forward went bad.  The GRADIENT plane flows
loss→embedding, so the first tap the backward corrupted is the MAXIMUM
index (`first_bad_grad`).  -1 = plane clean.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from apex_tpu_torch.ops._common import (  # noqa: F401 — re-exported
    TAP_PLANES,
    TAP_STAT_DIM,
    TAP_STAT_FIELDS,
    TapContext,
    active_tap_context,
    grad_tap,
    resolve_device,
    tap,
    tap_context,
    tap_stats,
)
from apex_tpu_torch.parallel import mesh as M

# Columns of the cross-rank timing vector (see `gather_rank_timings`):
# the host measures these per rank per step and the step all-gathers
# them so every rank's flight recorder sees every rank.
TIMING_FIELDS = ("step_duration_s", "allreduce_duration_s")


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static knobs for the flight-recorder planes a hot path collects.

    taps: per-layer stat taps (TapState output).  max_taps bounds the
    probes tensor (rows are (2, 4) f32; unused rows stay zero and are
    sliced off).  rank_timing: the cross-rank timing plane — the step
    takes this rank's timing vector and returns the all-gathered
    (n_ranks, k) matrix (ONE small collective a step)."""

    taps: bool = True
    max_taps: int = 512
    rank_timing: bool = False
    timing_dim: int = len(TIMING_FIELDS)


class TapState(NamedTuple):
    """Per-step tap snapshot.

    fwd/grad: (n_taps, 4) f32 — [absmax, mean, rms, nonfinite count]
    per tap point, forward plane and gradient plane (gradient stats are
    unscaled when the step runs under loss scaling; the nonfinite count
    is of the RAW scaled grads — what the overflow skip saw).
    first_bad_fwd / first_bad_grad: i32 provenance indices into the tap
    name list (-1 = clean); see the module docstring for the order."""

    fwd: torch.Tensor
    grad: torch.Tensor
    first_bad_fwd: torch.Tensor
    first_bad_grad: torch.Tensor


def make_probes(max_taps: int, device=None) -> torch.Tensor:
    """The zeros probes tensor a tapped forward takes rows from, on
    `device` (the card unless the caller asks for the CPU)."""
    return torch.zeros((max_taps, 2, TAP_STAT_DIM), dtype=torch.float32,
                       device=resolve_device(device))


def _first_nonfinite(plane: torch.Tensor, reverse: bool) -> torch.Tensor:
    n = plane.shape[0]
    if n == 0:
        return torch.full((), -1, dtype=torch.int32, device=plane.device)
    bad = plane[:, TAP_STAT_FIELDS.index("nonfinite")] > 0
    idx = torch.arange(n, dtype=torch.int32, device=plane.device)
    if reverse:  # gradient plane: backward hits high indices first
        return torch.where(bad, idx, -1).amax()
    first = torch.where(bad, idx, n).amin()
    return torch.where(first == n, -1, first).to(torch.int32)


def finalize(probe_grads: torch.Tensor, n_taps: int,
             inv_scale=1.0) -> TapState:
    """Build the TapState from the probes' gradient.

    probe_grads: (max_taps, 2, 4); n_taps: how many rows the forward
    used (`len(ctx.names)`).  inv_scale (a float or a 0-dim tensor)
    unscales the gradient plane's absmax/mean/rms so reported magnitudes
    compare across loss-scale changes; the nonfinite count is left as
    observed on the raw scaled grads."""
    used = probe_grads[:n_taps]
    fwd = used[:, 0]
    one = torch.ones((), dtype=torch.float32, device=used.device)
    inv = (inv_scale.to(torch.float32).reshape(())
           if isinstance(inv_scale, torch.Tensor) else one * inv_scale)
    unscale = torch.stack([inv, inv, inv, one])
    grad = used[:, 1] * unscale
    return TapState(
        fwd=fwd, grad=grad,
        first_bad_fwd=_first_nonfinite(fwd, reverse=False),
        first_bad_grad=_first_nonfinite(used[:, 1], reverse=True))


def timing_to_device(local_timing, device) -> torch.Tensor:
    """This rank's timing vector as a flat f32 tensor on `device`, with no
    host sync: a host vector (a list, a numpy array or a CPU tensor) bound
    for a card goes through a pinned buffer and a non-blocking copy (a
    copy from pageable memory would wait for the stream)."""
    dev = torch.device(device)
    v = torch.as_tensor(local_timing, dtype=torch.float32)
    if dev.type == "cuda" and v.device.type == "cpu":
        v = v.pin_memory()
    return v.to(dev, non_blocking=True).reshape(-1)


def gather_rank_timings(local_timing, group=None,
                        device=None) -> torch.Tensor:
    """The cross-rank timing plane: ONE all-gather of a small vector.

    local_timing: this rank's (k,) f32 host-measured durations (by
    convention `TIMING_FIELDS`), moved to `device` first (None: where it
    lies; a host vector then stays on the host, which an NCCL group
    refuses).  Returns (n_ranks, k) on every rank of `group` (a
    torch.distributed group; None: a world of one, where the result is
    this rank's row)."""
    v = (torch.as_tensor(local_timing, dtype=torch.float32)
         if device is None else timing_to_device(local_timing, device))
    v = v.reshape(-1)
    n = M.group_size(group)
    out = torch.empty(n * v.numel(), dtype=torch.float32, device=v.device)
    M.all_gather(out, v.contiguous(), group)
    return out.reshape(n, v.numel())


# --------------------------- host-side helpers ---------------------------

def _host(tap_state: TapState):
    """The four planes on the host in ONE device-to-host copy:
    (fwd (n, 4), grad (n, 4), first_bad_fwd, first_bad_grad)."""
    n = tap_state.fwd.shape[0]
    flat = torch.cat([
        tap_state.fwd.reshape(-1).double(),
        tap_state.grad.reshape(-1).double(),
        torch.stack([tap_state.first_bad_fwd.reshape(()),
                     tap_state.first_bad_grad.reshape(())]).double(),
    ]).cpu().numpy()
    k = n * TAP_STAT_DIM
    return (flat[:k].reshape(n, TAP_STAT_DIM),
            flat[k:2 * k].reshape(n, TAP_STAT_DIM),
            int(flat[2 * k]), int(flat[2 * k + 1]))


def taps_to_dict(tap_state: TapState, names: Sequence[str]) -> dict:
    """Fetch a TapState into the flight-report JSON shape:
    {"fwd": {name: {absmax, mean, rms, nonfinite}}, "grad": {...},
    "first_bad_fwd": name|None, "first_bad_grad": name|None}."""
    fwd, grad, bad_f, bad_g = _host(tap_state)
    names = list(names)

    def plane(mat):
        return {nm: {f: float(v) for f, v in zip(TAP_STAT_FIELDS, row)}
                for nm, row in zip(names, mat)}

    def badname(i):
        return names[i] if 0 <= i < len(names) else None

    return {
        "fwd": plane(fwd),
        "grad": plane(grad),
        "first_bad_fwd": badname(bad_f),
        "first_bad_grad": badname(bad_g),
    }


def provenance(tap_state: TapState,
               names: Sequence[str]) -> Optional[dict]:
    """First-nonfinite attribution, host side (ONE copy).

    Returns None when both planes are clean.  The FORWARD plane wins
    when it has a hit: a non-finite activation precedes (and causes) the
    backward corruption downstream of it.  Only when the forward was
    clean (the loss-scaling overflow, where low-precision grads blow up
    in the backward alone) does the gradient plane attribute: its first
    bad tap (closest to the loss) is where the overflow entered."""
    fwd, grad, bad_f, bad_g = _host(tap_state)
    names = list(names)
    for plane_name, idx, mat in (("fwd", bad_f, fwd), ("grad", bad_g, grad)):
        if 0 <= idx < len(names):
            return {
                "plane": plane_name,
                "tap": names[idx],
                "index": idx,
                "stats": {f: float(v) for f, v in
                          zip(TAP_STAT_FIELDS, mat[idx])},
            }
    return None
