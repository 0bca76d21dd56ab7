"""Shard-native checkpoint format and elastic re-layout (counterpart of
apex_tpu/checkpoint/sharded.py; its names, errors and on-disk bytes).

A checkpoint is a directory ``step_{k}/`` holding one raw little-endian
binary file per (field, rank) plus ``manifest.json``.  Three contracts:

* **Atomic commit.**  Shard files are written first; the manifest is
  written LAST through a tmp file + ``os.replace``.  The manifest IS
  the commit: a directory without one (kill mid-save) is never a
  loadable checkpoint, and `latest_committed_step` never returns it.
* **Shard-native.**  Each dp rank's ZeRO-2 flat-buffer shard is
  persisted as the sharded optimizers hold it (their
  `state_partition_specs()` say which fields shard); nothing is
  gathered at save time.  The manifest records the optimizer's
  `shard_layout()` (align / total / n_tensors / bucket boundaries /
  num_shards), the loss-scaler scalars and the tuner fingerprint.
* **Elastic restore.**  `restore_sharded` re-lays a checkpoint written
  at dp=N out for a target optimizer at dp=M: per bucket, the N rank
  chunks are concatenated, trimmed of tail padding to the CANONICAL
  align-padded flat content (bucket-count independent), then re-padded
  and re-sliced for the target's (num_shards, n_buckets).  Values are
  raw-copied: equal-topology restore is bitwise, and cross-topology
  restore moves only zero padding.

Host arrays are CPU tensors.  Dtypes are recorded under numpy's names
("float32", "bfloat16", "int32"), so either package reads the other's
files; a bf16 field is its raw 2-byte words, so neither side needs
`ml_dtypes` for this format.  The JAX package's `mesh=` placement of
`restore_sharded` becomes `device=`: a port rank holds only its own
shard, so it gets back this rank's shard of every sharded field (its
rank in the optimizer's dp, or dp x ep, group), re-laid for the
optimizer's current layout, and every replicated field whole.

Shard completeness is validated against the manifest BEFORE any
deserialization: a missing or truncated shard raises
`IncompleteCheckpointError` naming the missing ranks.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import warnings
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops._common import resolve_device

CKPT_SCHEMA_VERSION = 1
MANIFEST = "manifest.json"
# model state outside the optimizer (RNG key, BN running stats) rides
# the same manifest as replicated rank-0 fields under this name prefix;
# `restore_sharded` never feeds them to the optimizer state,
# `load_model_state` returns them
MODEL_PREFIX = "model."


class CheckpointError(RuntimeError):
    """Base class for checkpoint-format errors."""


class IncompleteCheckpointError(CheckpointError):
    """A committed manifest's shard files are missing or truncated.
    `missing` lists human-readable "field rank file (why)" entries."""

    def __init__(self, msg: str, missing: Sequence[str] = ()):
        super().__init__(msg)
        self.missing = list(missing)


class LayoutMismatchError(CheckpointError):
    """Source and target flat layouts cannot be re-laid into each other
    (different leaf population / align / dtype)."""


def _dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name (numpy's spelling)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointError(f"unknown checkpoint dtype {name!r}")
    return dt


def dtype_name(t: torch.Tensor) -> str:
    """numpy's name of a tensor's dtype ("float32", "bfloat16", ...)."""
    return str(t.dtype).replace("torch.", "")


def as_host(value) -> torch.Tensor:
    """A CPU tensor of `value`: a tensor (moved if it lives on the
    card), a numpy array (a bf16 `ml_dtypes` array by its raw words) or
    a Python scalar."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    a = np.asarray(value)
    if not a.flags.c_contiguous:    # (np.ascontiguousarray promotes 0-d)
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _raw(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes in C order, as a uint8 array over its storage (no
    copy of a contiguous tensor): `zlib.crc32` and a file's `write` take
    it and release the GIL, where a `tobytes` copy would hold it and
    stall the training thread's launches."""
    return t.reshape(-1).contiguous().view(torch.uint8).numpy()


def _crc(raw) -> int:
    return zlib.crc32(raw) & 0xFFFFFFFF


def step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{int(step)}")


def write_rank_file(d: str, name: str, kind: str, rank: int, value, *,
                    expect_dtype: Optional[str] = None) -> Tuple[dict, list]:
    """Write ONE (field, rank) shard file and return its manifest file
    entry + shape: the single definition of the on-disk format (file
    naming, byte count, crc32), shared by the single-host writer and
    the multi-host per-host writer."""
    t = as_host(value)
    if expect_dtype is not None and dtype_name(t) != expect_dtype:
        raise ValueError(
            f"field {name!r}: rank {rank} dtype {dtype_name(t)} != "
            f"{expect_dtype}")
    fn = (f"{name}.rank{rank:03d}.bin" if kind == "sharded"
          else f"{name}.bin")
    raw = _raw(t)
    with open(os.path.join(d, fn), "wb") as f:
        f.write(raw)
    return ({"rank": rank, "file": fn, "bytes": int(raw.nbytes),
             "crc32": _crc(raw)}, list(t.shape))


# ---------------------------------------------------------------------------
# write side
# ---------------------------------------------------------------------------

def save_sharded(directory: str, step: int, fields: Dict[str, tuple], *,
                 flat_layout: Optional[dict] = None,
                 scaler: Optional[dict] = None,
                 tuner_fingerprint: Optional[str] = None,
                 extra: Optional[dict] = None,
                 overwrite: bool = False) -> str:
    """Write one committed checkpoint under ``directory/step_{step}``.

    fields: ``{name: (kind, value)}``: kind ``"sharded"`` with value a
    rank-ordered list of per-rank 1-D host arrays, or ``"replicated"``
    with a single host array (tensors or numpy arrays).  Returns the
    committed step directory.

    Commit protocol (kill-anywhere safe): leftover files of an aborted
    earlier attempt are cleared, shard files land one by one, and the
    manifest (every file's byte count and crc32) is renamed into place
    LAST.  Overwriting an ALREADY-COMMITTED step writes the new attempt
    into a staging directory and swaps it in only after ITS manifest
    committed, so a kill mid-overwrite still leaves a loadable step
    (the only unguarded window is the two directory renames of the
    swap).  The named `chaos.check` points let the fault-injection
    harness kill this writer mid-save.
    """
    from apex_tpu_torch.checkpoint import chaos

    final = step_dir(directory, step)
    committed = os.path.exists(os.path.join(final, MANIFEST))
    if committed and not overwrite:
        raise CheckpointError(
            f"{final} already holds a COMMITTED checkpoint; pass "
            "overwrite=True to replace it")
    # committed target: stage the new attempt next to it (the ".tmp"
    # suffix keeps it invisible to latest_committed_step's step_N scan)
    d = final + ".tmp" if committed else final
    if os.path.isdir(d):
        # an aborted save's partials, cleared so a stale shard of another
        # size never survives next to a fresh manifest.  Only this
        # format's artifacts: a legacy save_checkpoint sharing the step
        # directory is refused, never destroyed
        for f in os.listdir(d):
            p = os.path.join(d, f)
            if os.path.isdir(p) or not (
                    f == MANIFEST or f.endswith((".bin", ".tmp"))
                    or (f.startswith("manifest.host")
                        and f.endswith(".json"))):
                raise CheckpointError(
                    f"{d} holds {f!r}, which is not a sharded-"
                    "checkpoint artifact — refusing to clear a "
                    "directory written by another format (legacy "
                    "save_checkpoint?); use a separate checkpoint root")
            os.remove(p)
    os.makedirs(d, exist_ok=True)

    manifest = {
        "ckpt_schema_version": CKPT_SCHEMA_VERSION,
        "step": int(step),
        "created_unix": time.time(),
        "fields": {},
        "flat_layout": flat_layout,
        "scaler": scaler,
        "tuner_fingerprint": tuner_fingerprint,
        "extra": extra or {},
    }
    chaos.check("ckpt.before_shards")
    total = 0
    for name, (kind, value) in fields.items():
        if kind not in ("sharded", "replicated"):
            raise ValueError(f"field {name!r}: kind must be 'sharded' or "
                             f"'replicated', got {kind!r}")
        arrs = [as_host(a) for a in value] if kind == "sharded" \
            else [as_host(value)]
        entry = {"kind": kind, "dtype": dtype_name(arrs[0]),
                 "num_shards": len(arrs) if kind == "sharded" else 1,
                 "shapes": [], "files": []}
        for r, a in enumerate(arrs):
            fe, shape = write_rank_file(d, name, kind, r, a,
                                        expect_dtype=entry["dtype"])
            entry["shapes"].append(shape)
            entry["files"].append(fe)
            total += fe["bytes"]
            chaos.check("ckpt.mid_shards")
        manifest["fields"][name] = entry
    manifest["total_bytes"] = total
    chaos.check("ckpt.before_manifest")
    tmp = os.path.join(d, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, os.path.join(d, MANIFEST))  # <-- the commit
    if d != final:
        # swap the committed staging dir over the old commit; the old
        # one stays intact on disk until the swap completes
        old = final + ".old"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(final, old)
        os.rename(d, final)
        shutil.rmtree(old, ignore_errors=True)
    return final


# ---------------------------------------------------------------------------
# validation / discovery
# ---------------------------------------------------------------------------

def validate_manifest(m: dict) -> None:
    """Schema check (raises CheckpointError)."""
    if not isinstance(m, dict):
        raise CheckpointError(f"manifest is {type(m).__name__}, not a dict")
    ver = m.get("ckpt_schema_version")
    if ver != CKPT_SCHEMA_VERSION:
        raise CheckpointError(
            f"ckpt_schema_version {ver!r} != {CKPT_SCHEMA_VERSION}")
    if not isinstance(m.get("step"), int) or m["step"] < 0:
        raise CheckpointError(f"bad step {m.get('step')!r}")
    flds = m.get("fields")
    if not isinstance(flds, dict) or not flds:
        raise CheckpointError("manifest has no fields")
    for name, e in flds.items():
        for key in ("kind", "dtype", "num_shards", "shapes", "files"):
            if key not in e:
                raise CheckpointError(f"field {name!r} missing {key!r}")
        if e["kind"] not in ("sharded", "replicated"):
            raise CheckpointError(f"field {name!r} bad kind {e['kind']!r}")
        _dtype(e["dtype"])  # resolvable
        n = len(e["files"])
        if n != (e["num_shards"] if e["kind"] == "sharded" else 1):
            raise CheckpointError(
                f"field {name!r}: {n} files for num_shards "
                f"{e['num_shards']}")
        for f in e["files"]:
            for key in ("rank", "file", "bytes", "crc32"):
                if key not in f:
                    raise CheckpointError(
                        f"field {name!r} file entry missing {key!r}")


def read_manifest(path: str) -> dict:
    """Read and validate the manifest of one step directory.  A missing
    manifest means the directory was never committed (kill mid-save);
    an unparseable one means the commit itself was corrupted."""
    mf = os.path.join(path, MANIFEST)
    if not os.path.exists(mf):
        raise CheckpointError(
            f"{path} has no {MANIFEST} — not a committed checkpoint "
            "(a save was killed before its atomic manifest rename); use "
            "latest_committed_step() to find the newest loadable step")
    try:
        with open(mf) as f:
            m = json.load(f)
    except ValueError as e:
        raise CheckpointError(
            f"{mf} is not valid JSON ({e}) — corrupted commit") from e
    validate_manifest(m)
    return m


def verify_shards(path: str, manifest: Optional[dict] = None, *,
                  crc: bool = True) -> None:
    """Validate every shard file the manifest names BEFORE anything
    deserializes: existence, exact byte count and (crc=True) checksum.
    Raises IncompleteCheckpointError listing the missing/short ranks."""
    m = manifest if manifest is not None else read_manifest(path)
    missing: List[str] = []
    for name, e in m["fields"].items():
        for f in e["files"]:
            fp = os.path.join(path, f["file"])
            if not os.path.exists(fp):
                missing.append(f"{name} rank {f['rank']} ({f['file']}: "
                               "missing)")
                continue
            sz = os.path.getsize(fp)
            if sz != f["bytes"]:
                missing.append(
                    f"{name} rank {f['rank']} ({f['file']}: {sz} bytes, "
                    f"manifest says {f['bytes']} — truncated)")
                continue
            if crc:
                with open(fp, "rb") as fh:
                    if _crc(fh.read()) != f["crc32"]:
                        missing.append(
                            f"{name} rank {f['rank']} ({f['file']}: "
                            "crc32 mismatch — corrupted)")
    if missing:
        raise IncompleteCheckpointError(
            f"checkpoint {path} is incomplete — {len(missing)} shard "
            f"file(s) failed validation: " + "; ".join(missing),
            missing=missing)


def _recover_swaps(directory: str) -> None:
    """Heal a kill between the two renames of an overwrite swap: a
    committed ``step_N.tmp`` (new attempt) or ``step_N.old`` (displaced
    original) whose final directory is missing is renamed back into
    place, .tmp preferred (it only commits after the new save
    finished)."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return
    for suffix in (".tmp", ".old"):     # .tmp = the newer attempt, wins
        for d in entries:
            if not (d.startswith("step_") and d.endswith(suffix)):
                continue
            p = os.path.join(directory, d)
            final = p[: -len(suffix)]
            if os.path.exists(os.path.join(final, MANIFEST)):
                continue                 # final is committed; leave it
            try:
                verify_shards(p, crc=False)
            except CheckpointError:
                continue                 # not a committed copy
            if os.path.isdir(final):     # uncommitted partial: clear
                shutil.rmtree(final, ignore_errors=True)
            try:
                os.rename(p, final)
            except OSError:  # pragma: no cover — racing writer wins
                pass


def _committed_steps(directory: str) -> List[int]:
    """Steps whose manifest exists and whose shard files match their
    manifested sizes (the cheap sweep; crc happens at restore).
    Interrupted overwrite swaps are healed first."""
    if not os.path.isdir(directory):
        return []
    _recover_swaps(directory)
    out = []
    for d in os.listdir(directory):
        if not d.startswith("step_"):
            continue
        try:
            s = int(d[5:])
        except ValueError:
            continue
        try:
            verify_shards(os.path.join(directory, d), crc=False)
        except CheckpointError:
            continue
        out.append(s)
    return sorted(out)


def latest_committed_step(directory: str) -> Optional[int]:
    """Newest step under `directory` whose manifest parses AND whose
    shard files all exist at their manifested sizes.  Uncommitted
    partials never count (and `restore_sharded(step=None)` also falls
    back past size-preserving corruption its crc sweep uncovers)."""
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def prune(directory: str, keep: int) -> List[int]:
    """Delete all but the newest `keep` COMMITTED steps, plus any
    uncommitted partial directories older than the newest committed
    step (aborted-save garbage).  Returns the deleted step numbers."""
    if not os.path.isdir(directory) or keep < 1:
        return []
    committed, partial = [], []
    for d in os.listdir(directory):
        if not d.startswith("step_"):
            continue
        try:
            s = int(d[5:])
        except ValueError:
            continue
        p = os.path.join(directory, d)
        (committed if os.path.exists(os.path.join(p, MANIFEST))
         else partial).append(s)
    committed.sort()
    newest = committed[-1] if committed else None
    doomed = committed[:-keep] if len(committed) > keep else []
    doomed += [s for s in partial if newest is not None and s < newest]
    for s in doomed:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)
    # aborted overwrite staging dirs, only when the FINAL directory is
    # committed: a .tmp/.old that is the sole surviving copy of its step
    # belongs to _recover_swaps
    for d in os.listdir(directory):
        p = os.path.join(directory, d)
        for suffix in (".tmp", ".old"):
            if (d.startswith("step_") and d.endswith(suffix)
                    and os.path.exists(os.path.join(
                        p[: -len(suffix)], MANIFEST))):
                shutil.rmtree(p, ignore_errors=True)
    return sorted(doomed)


# ---------------------------------------------------------------------------
# read side: host loading + elastic re-layout
# ---------------------------------------------------------------------------

def load_field_host(path: str, manifest: dict, name: str, *,
                    check_crc: bool = False):
    """Read one field's raw bytes back into CPU tensors (a rank-ordered
    list for sharded fields, a single tensor for replicated ones).
    Callers run `verify_shards` (at least the size sweep) first;
    check_crc=True checksums the same read that deserializes."""
    e = manifest["fields"][name]
    dt = _dtype(e["dtype"])
    out = []
    for f, shape in zip(e["files"], e["shapes"]):
        fp = os.path.join(path, f["file"])
        raw = bytearray(os.path.getsize(fp))
        with open(fp, "rb") as fh:
            fh.readinto(raw)
        if check_crc and _crc(raw) != f["crc32"]:
            raise IncompleteCheckpointError(
                f"checkpoint {path} is incomplete — shard file failed "
                f"validation: {name} rank {f['rank']} ({f['file']}: "
                "crc32 mismatch — corrupted)",
                missing=[f"{name} rank {f['rank']} ({f['file']}: "
                         "crc32 mismatch — corrupted)"])
        flat = (torch.frombuffer(raw, dtype=dt) if raw
                else torch.empty(0, dtype=dt))
        out.append(flat.reshape(shape))
    return out if e["kind"] == "sharded" else out[0]


def pack_model_state(tree: dict) -> Dict[str, tuple]:
    """Flatten a (possibly nested) dict of model-state arrays (RNG keys,
    BN running stats, anything outside the optimizer) into replicated
    manifest fields named ``model.<dotted.path>``.  Keys must not
    contain ``"."`` or ``"/"``."""
    out: Dict[str, tuple] = {}

    def _walk(prefix, node):
        if isinstance(node, dict):
            if not node:
                raise ValueError(
                    f"model state {prefix or '<root>'!r} is an empty dict")
            for k, v in node.items():
                k = str(k)
                if "." in k or "/" in k:
                    raise ValueError(
                        f"model state key {k!r} contains '.'/'/' — the "
                        "manifest joins nested keys with '.'")
                _walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            out[MODEL_PREFIX + prefix] = ("replicated", node)

    _walk("", dict(tree))
    return out


def unpack_model_state(fields: Dict[str, object]) -> dict:
    """Inverse of `pack_model_state`: ``model.a.b`` names back into a
    nested dict (prefix-less input keys are accepted too)."""
    root: dict = {}
    for name, value in fields.items():
        path = name[len(MODEL_PREFIX):] if name.startswith(MODEL_PREFIX) \
            else name
        parts = path.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def load_model_state(directory: str, step: Optional[int] = None, *,
                     verify_crc: bool = True) -> dict:
    """The ``model.*`` replicated fields of one committed step as a
    nested dict of CPU tensors ({} when the checkpoint carries none).
    step=None reads the latest committed step."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_committed_step(directory)
        if step is None:
            raise CheckpointError(
                f"no committed checkpoint under {directory}")
    p = step_dir(directory, step)
    m = read_manifest(p)
    names = [n for n in m["fields"] if n.startswith(MODEL_PREFIX)]
    return unpack_model_state(
        {n: load_field_host(p, m, n, check_crc=verify_crc)
         for n in names})


def _check_layouts(src: dict, dst: dict) -> None:
    src_ep = int(src.get("ep_shards", 1))
    dst_ep = int(dst.get("ep_shards", 1))
    if src_ep != dst_ep:
        # refused by name: the elastic re-shard is in dp only; re-laying
        # across ep would reassign which coordinate holds which expert
        raise LayoutMismatchError(
            f"checkpoint flat layout is expert-sharded over "
            f"ep={src_ep} but the target optimizer's layout carries "
            f"ep={dst_ep} — re-sharding is elastic in dp only; the "
            "'ep' axis cannot be re-laid (restore at the original "
            "expert-parallel size, or gather_state_dict the source "
            "run into a layout-independent checkpoint first)")
    for key in ("align", "total", "n_tensors", "master_dtype"):
        if src.get(key) != dst.get(key):
            raise LayoutMismatchError(
                f"checkpoint flat layout {key}={src.get(key)!r} does not "
                f"match the target optimizer's {dst.get(key)!r} — "
                "re-sharding can re-lay (num_shards, n_buckets), not a "
                "different leaf population / alignment / master dtype")
    if sum(src["bucket_totals"]) != src["total"]:
        raise LayoutMismatchError(
            f"inconsistent source layout: bucket totals "
            f"{src['bucket_totals']} do not sum to total {src['total']}")


def canonical_flat(shards: Sequence[torch.Tensor],
                   layout: dict) -> torch.Tensor:
    """The CANONICAL flat content (the align-padded leaf concatenation,
    tail padding trimmed) from per-rank shard buffers written under
    `layout`; bucket-count independent."""
    n = int(layout["num_shards"])
    if len(shards) != n:
        raise LayoutMismatchError(
            f"{len(shards)} shard buffers for num_shards {n}")
    shards = [as_host(sh) for sh in shards]
    buckets = []
    off = 0  # per-rank offset of this bucket's chunk inside the shard
    for padded, tot in zip(layout["bucket_padded"],
                           layout["bucket_totals"]):
        per = padded // n
        full = torch.cat([sh[off:off + per] for sh in shards])
        if full.shape[0] != padded:
            raise LayoutMismatchError(
                f"bucket reassembly got {full.shape[0]} elements, layout "
                f"says {padded} — shard buffers do not match the layout")
        buckets.append(full[:tot])
        off += per
    return torch.cat(buckets) if buckets else torch.zeros(
        (0,), dtype=_dtype(layout["master_dtype"]))


def relayout_flat(canonical: torch.Tensor, layout: dict) -> torch.Tensor:
    """The canonical flat content sliced into the GLOBAL buffer of a
    target layout: bucket-major re-padding, then rank-major shard
    concatenation (rank r's shard is the r-th 1/num_shards of it)."""
    canonical = as_host(canonical)
    m = int(layout["num_shards"])
    bucket_flats = []
    off = 0
    for padded, tot in zip(layout["bucket_padded"],
                           layout["bucket_totals"]):
        b = canonical[off:off + tot]
        if b.shape[0] != tot:
            raise LayoutMismatchError(
                f"canonical buffer has {canonical.shape[0]} elements, "
                f"target layout wants {sum(layout['bucket_totals'])}")
        bucket_flats.append(torch.cat([b, b.new_zeros(padded - tot)]))
        off += tot
    ranks = []
    for r in range(m):
        parts = []
        for bf in bucket_flats:
            per = bf.shape[0] // m
            parts.append(bf[r * per:(r + 1) * per])
        ranks.append(torch.cat(parts) if parts else canonical[:0])
    return torch.cat(ranks) if ranks else canonical[:0]


def reshard(shards: Sequence[torch.Tensor], src_layout: dict,
            dst_layout: dict) -> torch.Tensor:
    """dp=N shard buffers → the global buffer for a dp=M layout.  The
    equal-layout fast path is a bare concatenation (trivially bitwise);
    the general path moves only zero padding around the same values."""
    _check_layouts(src_layout, dst_layout)
    same = all(src_layout.get(k) == dst_layout.get(k)
               for k in ("num_shards", "n_buckets", "bucket_padded",
                         "bucket_totals"))
    if same:
        return torch.cat([as_host(sh) for sh in shards])
    return relayout_flat(canonical_flat(shards, src_layout), dst_layout)


def saved_cut(step_path: str) -> Optional[Tuple[int, int]]:
    """The (pp, tp) a save of a state cut over tp or pp was made at, as
    the port's multi-rank save records it in its host sub-manifests;
    None for any other save (the JAX package's records none)."""
    from apex_tpu_torch.checkpoint.multihost import submanifest_path

    path = submanifest_path(step_path, 0)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        cut = json.load(f).get("cut")
    return None if cut is None else (int(cut["pp"]), int(cut["tp"]))


def flat_length(optimizer) -> Optional[int]:
    """The length `init` gives a flat optimizer's buffers (its spec's
    total rounded up to FLAT_TILE); None before `init` or for an
    optimizer without a flat spec."""
    from apex_tpu_torch.ops.optimizer_kernels import FLAT_TILE

    spec = getattr(optimizer, "spec", None)
    total = getattr(spec, "total", None)
    return None if total is None else -(-int(total) // FLAT_TILE) * FLAT_TILE


def _row_of(name: str, host: torch.Tensor, row: int, n: int,
            want: Optional[int]) -> torch.Tensor:
    """Row `row` of `n` of a replicated field saved from a state cut over
    n (pp, tp) ranks (the global buffer's row-th block, as the JAX
    package's ``P(("pp", "tp"))`` sharding hands it to that rank; the
    whole field at n = 1), held to `want`, the length the optimizer's
    own buffer has (None: not checked)."""
    if host.shape[0] % n:
        raise LayoutMismatchError(
            f"checkpoint field {name!r} has global length "
            f"{host.shape[0]}, which the target's {n} (pp, tp) ranks do "
            "not divide — a state cut over tp or pp restores at the cut "
            "it was saved at")
    per = host.shape[0] // n
    if want is not None and per != want:
        raise LayoutMismatchError(
            f"checkpoint field {name!r}: a row of {per} elements at "
            f"{n} (pp, tp) ranks is not the target optimizer's flat "
            f"buffer of {want} — re-sharding can re-lay (num_shards, "
            "n_buckets), not a different tp or pp cut (restore at the "
            "(pp, tp) the state was saved at)")
    return host[row * per:(row + 1) * per]


def restore_sharded(directory: str, optimizer, *, device=None,
                    step: Optional[int] = None, verify_crc: bool = True,
                    cut: Optional[Tuple[int, int, int]] = None):
    """Restore an optimizer-state checkpoint for `optimizer`'s CURRENT
    layout and topology (`init` must have run so the layout is fixed).

    Returns ``(state, scaler_state, manifest)``: `state` is the
    optimizer's ``_STATE`` NamedTuple (a dict when its fields differ)
    on `device` (the card unless the caller asks for the CPU), each
    sharded field as this rank's shard of the target layout (its rank
    in the optimizer's group, `_rank()`; the whole global buffer for an
    optimizer without one) and each replicated field whole;
    `scaler_state` an `amp.scaler.LossScalerState` or None.

    cut=(row, pp, tp): the state is cut over pp·tp ranks and this rank
    holds row `row` of each replicated field but `step` (the JAX
    package's ``P(("pp", "tp"))`` blocks of the global buffer); None is
    an uncut state, (0, 1, 1).  Refused by name: a save whose recorded
    cut (`saved_cut`) is not this one, a field the rank count does not
    divide, and a row of the master buffer's length that is not the
    optimizer's own flat length (`flat_length`), which is how a save at
    another cut that records none (the JAX package's) shows.

    step=None resumes from the latest COMMITTED step; if that step's
    crc sweep finds size-preserving corruption, restore falls back, with
    a warning, to the next older intact commit.  An EXPLICIT step never
    falls back.  A tuner-fingerprint mismatch warns: the run resumes
    correct but under different tuned kernels.
    """
    dev = resolve_device(device)
    directory = os.path.abspath(directory)
    explicit = step is not None
    if not explicit:
        step = latest_committed_step(directory)
        if step is None:
            raise CheckpointError(
                f"no committed checkpoint under {directory}")

    def _load_step(s):
        """(manifest, host values) of one step: completeness swept
        cheaply first, content checksummed on the read that
        deserializes.  model.* fields never reach the optimizer."""
        p = step_dir(directory, s)
        m = read_manifest(p)
        verify_shards(p, m, crc=False)
        return m, {n: load_field_host(p, m, n, check_crc=verify_crc)
                   for n in m["fields"]
                   if not n.startswith(MODEL_PREFIX)}

    try:
        manifest, host_values = _load_step(step)
    except IncompleteCheckpointError:
        if explicit:
            raise
        fallback = None
        for s in sorted((x for x in _committed_steps(directory)
                         if x < step), reverse=True):
            try:
                fallback = (s,) + _load_step(s)
            except CheckpointError:
                continue
            break
        if fallback is None:
            raise
        warnings.warn(
            f"restore_sharded: newest committed step {step} failed its "
            f"checksum sweep — falling back to the next intact commit, "
            f"step {fallback[0]} (training since then is lost; "
            "investigate the damaged directory before pruning claims "
            "it)", stacklevel=2)
        step, manifest, host_values = fallback

    sharded_fields = [n for n, e in manifest["fields"].items()
                      if e["kind"] == "sharded"
                      and not n.startswith(MODEL_PREFIX)]
    dst_layout = None
    if sharded_fields:
        if not hasattr(optimizer, "shard_layout"):
            raise CheckpointError(
                f"checkpoint step {step} carries sharded fields "
                f"{sharded_fields} but {type(optimizer).__name__} has no "
                "shard_layout() — restore needs a ZeRO optimizer "
                "(init() first)")
        dst_layout = optimizer.shard_layout()
    src_layout = manifest.get("flat_layout")
    if sharded_fields and not src_layout:
        raise CheckpointError(
            f"checkpoint step {step} has sharded fields but no "
            "flat_layout record — cannot re-shard")
    rank_of = getattr(optimizer, "_rank", None)
    row, pp, tp = cut or (0, 1, 1)
    saved = saved_cut(step_dir(directory, step))
    if saved is not None and saved != (pp, tp):
        raise LayoutMismatchError(
            f"checkpoint step {step} was saved from a state cut over "
            f"(pp, tp) = {saved}, the target is cut over {(pp, tp)} — "
            "re-sharding can re-lay (num_shards, n_buckets), not a "
            "different tp or pp cut (restore at the (pp, tp) the state "
            "was saved at)")
    master = host_values.get("params")
    master_len = (None if master is None or master.dim() != 1
                  else master.shape[0])
    want = flat_length(optimizer)

    values = {}
    for name, e in manifest["fields"].items():
        if name.startswith(MODEL_PREFIX):
            continue  # model state: fetched via load_model_state
        host = host_values[name]
        if e["kind"] == "sharded":
            host = reshard(host, src_layout, dst_layout)
            if rank_of is not None:
                per = host.shape[0] // int(dst_layout["num_shards"])
                r = rank_of()
                host = host[r * per:(r + 1) * per]
        elif name != "step" and host.dim() > 0:
            host = _row_of(name, host, row, pp * tp,
                           want if host.shape[0] == master_len else None)
        values[name] = host.to(dev, copy=True)

    state_cls = getattr(optimizer, "_STATE", None)
    if state_cls is not None and set(state_cls._fields) == set(values):
        state = state_cls(**values)
    else:
        state = values

    scaler_state = None
    if manifest.get("scaler"):
        from apex_tpu_torch.amp import scaler as scaler_lib
        scaler_state = scaler_lib.load_state_dict(manifest["scaler"],
                                                  device=dev)

    fp = manifest.get("tuner_fingerprint")
    if fp:
        from apex_tpu_torch import tune
        cur = tune.fingerprint()
        if cur != fp:
            warnings.warn(
                f"restore_sharded: checkpoint was written under tuner "
                f"fingerprint {fp} but the active one is {cur} — the "
                "resumed run uses different tuned kernels, so bitwise "
                "trajectory equality with the original run is not "
                "guaranteed (allclose still holds)", stacklevel=2)
    return state, scaler_state, manifest
