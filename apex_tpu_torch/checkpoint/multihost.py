"""Multi-host checkpoint commit (counterpart of
apex_tpu/checkpoint/multihost.py; its file protocol, so the
sub-manifests of either package are byte-compatible).

Each host can reach only its own ranks' state, so the WRITE side of the
shard-native format is distributed while the single-host commit
semantics stay: single-controller consistency with multi-host
execution.

Protocol (all hosts share one checkpoint directory):

1. **Every host** writes only its LOCAL ranks' shard files into
   ``step_{k}/`` (file names carry the global rank, so hosts never
   collide) and publishes a per-host sub-manifest
   ``manifest.host{h:03d}.json`` via tmp + ``os.replace``: byte counts
   and crc32 of exactly the files that host wrote, the step, and the
   caller's `attempt` token.
2. **Process 0** also writes the replicated (rank-0) fields, then runs
   the COMMIT BARRIER: it polls until every host's sub-manifest is
   present, matches (step, attempt), and every file it names
   crc-verifies on disk; only then does it merge them into the
   ordinary global ``manifest.json``, committed by the same rename the
   single-host writer uses.

The barrier is this file protocol, never a `torch.distributed`
collective.  The global manifest is the single-host schema, so the
readers of `checkpoint.sharded` need no multi-host awareness.  A kill
of ANY host at ANY point leaves either the previous commit or nothing.

Attempt tokens: a retry of a failed commit of step k MUST carry a
bumped `attempt`: the barrier refuses to mix a surviving host's fresh
files with a dead attempt's stale sub-manifest.

`record_hosts=False` (the `CheckpointManager` over one job's dp ranks,
each rank one process of this protocol) leaves the ``multihost`` record
out of the global manifest, which is then the one a single-controller
save of the same state writes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.checkpoint.sharded import (
    CKPT_SCHEMA_VERSION,
    MANIFEST,
    CheckpointError,
    _crc,
    as_host,
    dtype_name,
    step_dir,
    write_rank_file,
)

SUBMANIFEST_FMT = "manifest.host{:03d}.json"
SUBMANIFEST_PREFIX = "manifest.host"


class MultihostCommitError(CheckpointError):
    """The commit barrier refused: one or more hosts never produced a
    consistent sub-manifest (died, stale attempt, crc mismatch).
    `unready` maps host id -> human-readable reason."""

    def __init__(self, msg: str, unready: Optional[Dict[int, str]] = None):
        super().__init__(msg)
        self.unready = dict(unready or {})


def submanifest_path(directory_or_step_dir: str, host: int) -> str:
    return os.path.join(directory_or_step_dir, SUBMANIFEST_FMT.format(host))


def local_ranks(process_id: int, num_processes: int,
                num_shards: int) -> List[int]:
    """The contiguous block of global dp ranks host `process_id` owns
    (the placement a homogeneous fleet gets).  When
    num_shards doesn't divide evenly the first hosts take the extras."""
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} outside [0, {num_processes})")
    base, extra = divmod(num_shards, num_processes)
    counts = [base + (1 if p < extra else 0)
              for p in range(num_processes)]
    start = sum(counts[:process_id])
    return list(range(start, start + counts[process_id]))


# ---------------------------------------------------------------------------
# per-host write side
# ---------------------------------------------------------------------------

def write_host_shards(d: str, step: int, fields: Dict[str, tuple], *,
                      host: int, num_processes: int, attempt: int = 0,
                      flat_layout: Optional[dict] = None) -> dict:
    """Write this host's shard files under `d` and return its
    sub-manifest dict (NOT yet published).

    fields: ``{name: (kind, value)}`` — kind ``"sharded"`` with value a
    ``{global_rank: 1-D host array}`` dict holding only THIS host's
    ranks, or ``"replicated"`` with a single host array (only host 0
    may carry replicated fields — they are rank-0 state).  Reuses the
    single-host chaos points (``ckpt.before_shards`` /
    ``ckpt.mid_shards``) so the kill matrix covers mid-shard-write
    deaths on any host.
    """
    from apex_tpu_torch.checkpoint import chaos

    os.makedirs(d, exist_ok=True)
    sub = {
        "ckpt_schema_version": CKPT_SCHEMA_VERSION,
        "step": int(step),
        "host": int(host),
        "num_processes": int(num_processes),
        "attempt": int(attempt),
        "created_unix": time.time(),
        "fields": {},
        "flat_layout": flat_layout,
    }
    chaos.check("ckpt.before_shards")
    for name, (kind, value) in fields.items():
        if kind not in ("sharded", "replicated"):
            raise ValueError(f"field {name!r}: kind must be 'sharded' or "
                             f"'replicated', got {kind!r}")
        if kind == "replicated" and host != 0:
            raise ValueError(
                f"field {name!r}: replicated fields are rank-0 state and "
                f"may only be written by host 0, not host {host}")
        if kind == "sharded":
            items = sorted((int(r), as_host(a))
                           for r, a in dict(value).items())
        else:
            items = [(0, as_host(value))]
        if not items:
            raise ValueError(f"field {name!r}: host {host} has no ranks "
                             "to write (empty shard dict)")
        entry = {"kind": kind, "dtype": dtype_name(items[0][1]),
                 "shapes": [], "files": []}
        for r, a in items:
            fe, shape = write_rank_file(d, name, kind, r, a,
                                        expect_dtype=entry["dtype"])
            entry["shapes"].append(shape)
            entry["files"].append(fe)
            chaos.check("ckpt.mid_shards")
        sub["fields"][name] = entry
    return sub


def publish_submanifest(d: str, sub: dict) -> str:
    """Atomically publish a host's sub-manifest (tmp + ``os.replace``) —
    the per-host half-commit the barrier waits on.  A host killed
    before this point contributes nothing but overwritable orphan
    files."""
    from apex_tpu_torch.checkpoint import chaos

    chaos.check("host.before_submanifest")
    path = submanifest_path(d, sub["host"])
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(sub, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# process-0 commit barrier
# ---------------------------------------------------------------------------

def _read_submanifest(d: str, host: int) -> Optional[dict]:
    p = submanifest_path(d, host)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except ValueError:
        return None  # mid-replace on a non-atomic store: poll again


def _check_sub(d: str, sub: Optional[dict], *, step: int,
               attempt: int) -> Optional[str]:
    """None when `sub` is consistent and fully on disk; otherwise the
    human-readable not-ready reason the barrier reports."""
    if sub is None:
        return "no sub-manifest published"
    if sub.get("step") != int(step):
        return f"sub-manifest is for step {sub.get('step')}, not {step}"
    if sub.get("attempt") != int(attempt):
        return (f"sub-manifest attempt {sub.get('attempt')} != {attempt} "
                "(stale attempt — bump the attempt token on retries)")
    for name, e in sub.get("fields", {}).items():
        for fe in e["files"]:
            fp = os.path.join(d, fe["file"])
            if not os.path.exists(fp):
                return f"{fe['file']} missing"
            if os.path.getsize(fp) != fe["bytes"]:
                return f"{fe['file']} size mismatch (write in flight?)"
            with open(fp, "rb") as fh:
                if _crc(fh.read()) != fe["crc32"]:
                    return f"{fe['file']} crc mismatch"
    return None


def gather_submanifests(d: str, num_processes: int, *, step: int,
                        attempt: int = 0, timeout_s: float = 120.0,
                        poll_s: float = 0.05) -> List[dict]:
    """Process 0's barrier wait: poll until EVERY host's sub-manifest is
    present, matches (step, attempt), and crc-verifies — or raise
    `MultihostCommitError` naming each unready host after `timeout_s`.
    A crc/size mismatch is 'not ready yet' (the host may still be
    writing), never an instant failure; only the deadline turns it into
    a refusal.  A host verified once stays verified — the poll loop
    never re-reads an already-checksummed host's payload, so waiting on
    one slow host doesn't turn the barrier into an O(polls × fleet
    bytes) read storm over the shared store."""
    deadline = time.monotonic() + timeout_s
    ready: Dict[int, dict] = {}
    while True:
        unready = {}
        for h in range(num_processes):
            if h in ready:
                continue
            sub = _read_submanifest(d, h)
            why = _check_sub(d, sub, step=step, attempt=attempt)
            if why is None:
                ready[h] = sub
            else:
                unready[h] = why
        if not unready:
            return [ready[h] for h in range(num_processes)]
        if time.monotonic() >= deadline:
            raise MultihostCommitError(
                f"commit barrier for step {step} (attempt {attempt}) "
                f"timed out after {timeout_s:.1f}s — refusing to commit; "
                "unready hosts: " + "; ".join(
                    f"host {h}: {why}" for h, why in sorted(unready.items())),
                unready=unready)
        time.sleep(poll_s)


def merge_submanifests(subs: Sequence[dict], *, step: int,
                       num_shards: Optional[int] = None,
                       flat_layout: Optional[dict] = None,
                       scaler: Optional[dict] = None,
                       tuner_fingerprint: Optional[str] = None,
                       extra: Optional[dict] = None,
                       record_hosts: bool = True) -> dict:
    """Merge per-host sub-manifests into the ordinary GLOBAL manifest
    (single-host schema — `validate_manifest`-clean).  Validates exact
    rank coverage: every sharded field must assemble ranks
    ``0..num_shards-1`` with no gap and no duplicate claim.
    `record_hosts` adds the ``multihost`` record of the hosts merged."""
    if not subs:
        raise MultihostCommitError("no sub-manifests to merge")
    if flat_layout is None:
        for s in subs:
            if s.get("flat_layout"):
                flat_layout = s["flat_layout"]
                break
    for s in subs:
        sl = s.get("flat_layout")
        if sl and flat_layout and sl != flat_layout:
            raise MultihostCommitError(
                f"host {s.get('host')} recorded a different flat_layout "
                "than host 0 — the fleet is not running one optimizer "
                "configuration; refusing to commit")
    if num_shards is None and flat_layout:
        num_shards = int(flat_layout.get("num_shards", 0)) or None

    fields: Dict[str, dict] = {}
    total = 0
    for s in sorted(subs, key=lambda x: x.get("host", 0)):
        for name, e in s["fields"].items():
            tgt = fields.setdefault(
                name, {"kind": e["kind"], "dtype": e["dtype"],
                       "by_rank": {}})
            if tgt["kind"] != e["kind"] or tgt["dtype"] != e["dtype"]:
                raise MultihostCommitError(
                    f"field {name!r}: host {s.get('host')} wrote kind/"
                    f"dtype {e['kind']}/{e['dtype']}, another host wrote "
                    f"{tgt['kind']}/{tgt['dtype']} — refusing to commit")
            for fe, shape in zip(e["files"], e["shapes"]):
                r = int(fe["rank"])
                if r in tgt["by_rank"]:
                    raise MultihostCommitError(
                        f"field {name!r}: rank {r} written by two hosts "
                        "— overlapping local_ranks; refusing to commit")
                tgt["by_rank"][r] = (fe, shape)
                total += int(fe["bytes"])

    out_fields: Dict[str, dict] = {}
    for name, tgt in fields.items():
        ranks = sorted(tgt["by_rank"])
        if tgt["kind"] == "sharded":
            if not num_shards:
                # guessing n from the highest rank seen would commit a
                # missing-TAIL-rank torn fleet as "complete" — refuse
                raise MultihostCommitError(
                    f"field {name!r}: cannot validate rank coverage "
                    "without the expected shard count — pass "
                    "num_shards or a flat_layout; refusing to commit")
            n = num_shards
            missing = sorted(set(range(n)) - set(ranks))
            if missing or ranks != list(range(n)):
                raise MultihostCommitError(
                    f"field {name!r}: rank coverage {ranks} does not "
                    f"assemble 0..{n - 1}"
                    + (f" (missing {missing})" if missing else "")
                    + " — refusing to commit")
            n_files = n
        else:
            if ranks != [0]:
                raise MultihostCommitError(
                    f"replicated field {name!r} has rank entries {ranks}")
            n_files = 1
        out_fields[name] = {
            "kind": tgt["kind"], "dtype": tgt["dtype"],
            "num_shards": n_files,
            "shapes": [tgt["by_rank"][r][1] for r in ranks],
            "files": [tgt["by_rank"][r][0] for r in ranks],
        }

    manifest = {
        "ckpt_schema_version": CKPT_SCHEMA_VERSION,
        "step": int(step),
        "created_unix": time.time(),
        "fields": out_fields,
        "flat_layout": flat_layout,
        "scaler": scaler,
        "tuner_fingerprint": tuner_fingerprint,
        "extra": extra or {},
        "total_bytes": total,
    }
    if record_hosts:
        manifest["multihost"] = {
            "num_processes": len(subs),
            "hosts": sorted(int(s.get("host", 0)) for s in subs)}
    return manifest


def commit_global_manifest(d: str, manifest: dict) -> str:
    """The global atomic barrier: rename the merged manifest into place.
    ``host.before_barrier`` armed here kills process 0 with every
    host's data on disk but NO commit — the step must stay invisible."""
    from apex_tpu_torch.checkpoint import chaos
    from apex_tpu_torch.checkpoint.sharded import validate_manifest

    validate_manifest(manifest)
    chaos.check("host.before_barrier")
    tmp = os.path.join(d, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, os.path.join(d, MANIFEST))  # <-- the commit
    return os.path.join(d, MANIFEST)


# ---------------------------------------------------------------------------
# the one-call surface the manager uses
# ---------------------------------------------------------------------------

def save_sharded_multihost(
        directory: str, step: int, fields: Dict[str, tuple], *,
        process_id: int, num_processes: int, attempt: int = 0,
        flat_layout: Optional[dict] = None, scaler: Optional[dict] = None,
        tuner_fingerprint: Optional[str] = None, extra: Optional[dict] = None,
        timeout_s: float = 120.0, poll_s: float = 0.05,
        record_hosts: bool = True,
) -> Tuple[Optional[str], float]:
    """This host's half of one multi-host commit.

    Every process calls this with its LOCAL fields (sharded values as
    ``{global_rank: array}`` dicts; replicated fields only on process
    0).  Non-zero processes write shards + sub-manifest and return
    immediately with ``(None, 0.0)`` — they never wait on the barrier.
    Process 0 writes its own files, waits for every host, merges, and
    commits; it returns ``(committed_step_dir, barrier_wait_seconds)``.
    The barrier wait is the `ckpt_commit_barrier_s` telemetry stamp.

    Overwriting an already-committed step is refused: the single-host
    staged-swap overwrite cannot be made kill-anywhere-safe when N
    uncoordinated hosts would each need to observe the swap atomically.
    Fleet orchestration numbers saves past the restored step instead.
    """
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} outside [0, {num_processes})")
    d = step_dir(directory, step)
    if os.path.exists(os.path.join(d, MANIFEST)):
        raise CheckpointError(
            f"{d} already holds a COMMITTED checkpoint; multi-host "
            "overwrite is unsupported — number saves past the restored "
            "step (or prune) instead")
    sub = write_host_shards(
        d, step, fields, host=process_id, num_processes=num_processes,
        attempt=attempt, flat_layout=flat_layout)
    publish_submanifest(d, sub)
    if process_id != 0:
        return None, 0.0
    t0 = time.monotonic()
    subs = gather_submanifests(d, num_processes, step=step,
                               attempt=attempt, timeout_s=timeout_s,
                               poll_s=poll_s)
    barrier_s = time.monotonic() - t0
    manifest = merge_submanifests(
        subs, step=step, flat_layout=flat_layout, scaler=scaler,
        tuner_fingerprint=tuner_fingerprint, extra=extra,
        record_hosts=record_hosts)
    commit_global_manifest(d, manifest)
    return d, barrier_s
