"""Host-side rank-straggler detection over the gathered timing plane
(counterpart of apex_tpu/monitor/trace/straggler.py; host code, kept as
it is).

The train step all-gathers each rank's host-measured durations
(`taps.gather_rank_timings` — one small collective a step); this
module turns the resulting (n_ranks, k) matrices into skew numbers and
persistent-outlier flags.  ≡ the reference debugging workflow of
bisecting a slow DP rank by hand, made a first-class signal (T3, arXiv
2401.16677: fine-grained compute/collective timing visibility).

Skew convention: `skew = max / median` of the per-rank duration — 1.0
is a perfectly balanced step, 2.0 means the slowest rank took twice
the median and the whole data-parallel step waited for it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from apex_tpu_torch.monitor.trace.taps import TIMING_FIELDS


class StragglerDetector:
    """Flags ranks whose step duration is persistently skewed.

    threshold: a rank is an outlier on a step when its duration exceeds
    threshold x the step's median.  patience: consecutive outlier steps
    before the rank is flagged (one slow step is noise — a preempted
    host, a GC pause; `patience` of them is a straggler).  field:
    which timing column to detect on (default 0 = step duration).
    """

    def __init__(self, threshold: float = 1.5, patience: int = 3,
                 field: int = 0):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1.0, got {threshold}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.threshold = threshold
        self.patience = patience
        self.field = field
        self._consecutive: Optional[np.ndarray] = None
        self.steps_seen = 0
        self.last: Optional[dict] = None

    def reset(self) -> None:
        """Clear all history (counters, last summary, rank count).  The
        elastic-resume rebuild hook: after a dp=N→M topology change the
        rank count legitimately differs, and `update` otherwise refuses
        a mid-run rank-count change."""
        self._consecutive = None
        self.steps_seen = 0
        self.last = None

    def update(self, timings) -> dict:
        """Fold one step's gathered (n_ranks, k) timing matrix in.

        Returns this step's summary (also kept as `.last`):
        {"skew", "median_s", "max_s", "max_rank", "flagged": [
         {"rank", "skew", "consecutive"}]} — `flagged` lists ranks at
        or past `patience` consecutive outlier steps."""
        if hasattr(timings, "detach"):  # a tensor (device or host)
            timings = timings.detach().cpu().numpy()
        t = np.asarray(timings, np.float64)
        if t.ndim == 1:
            t = t[:, None]
        col = t[:, self.field]
        n = col.shape[0]
        if self._consecutive is None:
            self._consecutive = np.zeros(n, np.int64)
        elif self._consecutive.shape[0] != n:
            raise ValueError(
                f"rank count changed mid-run: {self._consecutive.shape[0]}"
                f" -> {n}")
        median = float(np.median(col))
        max_rank = int(np.argmax(col))
        mx = float(col[max_rank])
        floor = max(median, 1e-12)
        outlier = col > self.threshold * median if median > 0 else \
            np.zeros(n, bool)
        self._consecutive = np.where(outlier, self._consecutive + 1, 0)
        self.steps_seen += 1
        self.last = {
            "step_index": self.steps_seen,
            "n_ranks": n,
            "median_s": median,
            "max_s": mx,
            "max_rank": max_rank,
            "skew": mx / floor,
            "flagged": [
                {"rank": int(r),
                 "skew": float(col[r] / floor),
                 "consecutive": int(self._consecutive[r])}
                for r in np.nonzero(
                    self._consecutive >= self.patience)[0]],
        }
        return self.last

    @property
    def flagged_ranks(self) -> Sequence[int]:
        if self.last is None:
            return ()
        return tuple(f["rank"] for f in self.last["flagged"])

    def summary(self) -> dict:
        """The flight-report `straggler` section."""
        return {
            "threshold": self.threshold,
            "patience": self.patience,
            "field": TIMING_FIELDS[self.field]
            if self.field < len(TIMING_FIELDS) else self.field,
            "steps_seen": self.steps_seen,
            "last": self.last,
        }
