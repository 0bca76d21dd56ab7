"""Persistent kernel-tuning cache (counterpart of apex_tpu/tune/cache.py).

One JSON file holds every tuned kernel config, grouped by DEVICE KIND,
in the JAX package's schema, so one file serves both packages:

    {
      "schema": 1,
      "entries": {
        "<device-kind>": {
          "<op>|k1=v1,k2=v2,...": {
            "config": {"block_q": 64, ...},      # what tuned() returns
            "meta":   {"ms": 1.23, ...}          # provenance, ignored
          }
        }
      }
    }

Path: $APEX_TPU_TUNE_CACHE if set, else ``~/.cache/apex_tpu/tune.json``;
APEX_TPU_TUNE=0 disables every lookup.  A missing, unreadable, corrupt
or wrong-schema file behaves as an EMPTY cache (warn once): lookups fall
through to the committed defaults (defaults.py) and then to each
kernel's heuristic, so a broken cache changes no numerics and crashes
no run.

The device kind is "cpu" without a card, and with one a canonical name
from `torch.cuda.get_device_name()` ("h100" for an H100).  No card's
kind can equal a TPU kind, so a config swept on a TPU never drives the
card, nor the reverse.

``lookup`` is a host-side dict access: no device work, no host sync.
``record`` is for the offline sweep (tune.search) only.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import warnings
from typing import Any, Dict, Optional

SCHEMA_VERSION = 1

ENV_CACHE_PATH = "APEX_TPU_TUNE_CACHE"
ENV_DISABLE = "APEX_TPU_TUNE"          # "0" disables all lookups

# (substring of the lower-cased CUDA device name, canonical cache key)
_DEVICE_ALIASES = (
    ("h100", "h100"),
    ("h200", "h200"),
    ("h800", "h800"),
    ("gh200", "gh200"),
    ("a100", "a100"),
)
# the JAX package's TPU kinds: a card's name never becomes one of these
_TPU_KINDS = frozenset({"v4", "v5e", "v5p", "v6e"})

_lock = threading.RLock()
_state: Dict[str, Any] = {
    "cache": None,         # merged {key: entry} for `kind`
    "kind": None,
    "fingerprint": None,   # memoized digest of `cache`
    "hits": 0,
    "misses": 0,
    "warned": set(),
}


def cache_path() -> str:
    env = os.environ.get(ENV_CACHE_PATH)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "apex_tpu",
                        "tune.json")


def canonical_kind(device_name: str) -> str:
    """The cache key of a CUDA device name: an alias where one matches
    ("NVIDIA H100 80GB HBM3" → "h100"), else the lower-cased name with
    dashes for spaces; prefixed "gpu-" if that spelled a TPU kind."""
    name = device_name.lower()
    for sub, canon in _DEVICE_ALIASES:
        if sub in name:
            return canon
    kind = "-".join(name.split()) or "gpu"
    return "gpu-" + kind if kind in _TPU_KINDS else kind


def device_kind() -> str:
    """The canonical device kind of this process: "cpu" without a card,
    else `canonical_kind` of card 0's name."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return canonical_kind(torch.cuda.get_device_name(0))


def make_key(op: str, attrs: Dict[str, Any]) -> str:
    """Canonical string key: op + sorted k=v attrs (ints/bools/strs),
    the JAX package's spelling."""
    def fmt(v):
        if isinstance(v, bool):
            return "1" if v else "0"
        return str(v)

    items = ",".join(f"{k}={fmt(v)}" for k, v in sorted(attrs.items()))
    return f"{op}|{items}"


def _warn_once(tag: str, msg: str) -> None:
    if tag not in _state["warned"]:
        _state["warned"].add(tag)
        warnings.warn(msg, stacklevel=3)


def _read_file(path: str) -> Dict[str, Dict[str, Any]]:
    """All device-kind sections of the cache file; {} on any problem."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        _warn_once("corrupt:" + path,
                   f"apex_tpu_torch.tune: ignoring unreadable/corrupt "
                   f"cache {path} ({e!r}); falling back to heuristics")
        return {}
    if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
        _warn_once("schema:" + path,
                   f"apex_tpu_torch.tune: cache {path} has schema "
                   f"{raw.get('schema') if isinstance(raw, dict) else '?'}"
                   f" != {SCHEMA_VERSION}; ignoring it")
        return {}
    entries = raw.get("entries")
    return entries if isinstance(entries, dict) else {}


def _merged_for_kind(kind: str) -> Dict[str, Any]:
    """User-cache entries layered over the committed defaults."""
    from apex_tpu_torch.tune import defaults

    merged = dict(defaults.DEFAULTS.get(kind, {}))
    file_entries = _read_file(cache_path()).get(kind, {})
    if isinstance(file_entries, dict):
        merged.update(file_entries)
    return merged


def _ensure_loaded() -> Dict[str, Any]:
    kind = device_kind()
    with _lock:
        if _state["cache"] is None or _state["kind"] != kind:
            _state["cache"] = _merged_for_kind(kind)
            _state["kind"] = kind
            _state["fingerprint"] = None
        return _state["cache"]


def lookup(op: str, attrs: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Tuned config for (op, attrs) on this device kind, or None (the
    caller keeps its heuristic).  Counts hits and misses."""
    if os.environ.get(ENV_DISABLE, "") == "0":
        return None
    cache = _ensure_loaded()
    entry = cache.get(make_key(op, attrs))
    with _lock:
        if entry is None:
            _state["misses"] += 1
            return None
        _state["hits"] += 1
    cfg = entry.get("config")
    return dict(cfg) if isinstance(cfg, dict) else None


@contextlib.contextmanager
def _file_lock(path: str):
    """Advisory cross-process lock for the cache's read-modify-write;
    where flock is refused the write goes ahead unlocked."""
    f = None
    try:
        try:
            import fcntl
            f = open(path + ".lock", "w")
            fcntl.flock(f, fcntl.LOCK_EX)
        except (ImportError, OSError):
            if f is not None:
                f.close()
            f = None
        yield
    finally:
        if f is not None:
            import fcntl
            fcntl.flock(f, fcntl.LOCK_UN)
            f.close()


def record(op: str, attrs: Dict[str, Any], config: Dict[str, Any],
           meta: Optional[Dict[str, Any]] = None,
           kind: Optional[str] = None) -> str:
    """Write one tuned entry to the cache file (read-modify-write under
    an advisory file lock).  Returns the key.  Offline only."""
    kind = kind or device_kind()
    key = make_key(op, attrs)
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _lock, _file_lock(path):
        entries = _read_file(path)
        entries.setdefault(kind, {})[key] = {
            "config": dict(config), "meta": dict(meta or {})}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"schema": SCHEMA_VERSION, "entries": entries}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)
        invalidate()
    return key


def fingerprint() -> str:
    """12-hex digest of the active merged entries (committed defaults +
    user cache for this device kind), "empty" when there are none — the
    JAX package's digest, so one file gives both packages one stamp."""
    cache = _ensure_loaded()
    with _lock:
        if _state["fingerprint"] is None:
            if not cache:
                _state["fingerprint"] = "empty"
            else:
                blob = json.dumps(cache, sort_keys=True).encode()
                _state["fingerprint"] = hashlib.sha1(blob).hexdigest()[:12]
        return _state["fingerprint"]


def stats() -> Dict[str, Any]:
    """{"hits", "misses", "fingerprint"} since the last reset."""
    with _lock:
        return {"hits": _state["hits"], "misses": _state["misses"],
                "fingerprint": fingerprint()}


def reset_stats() -> None:
    with _lock:
        _state["hits"] = 0
        _state["misses"] = 0


def invalidate() -> None:
    """Drop the in-memory memo (after `record` or an environment change)."""
    with _lock:
        _state["cache"] = None
        _state["kind"] = None
        _state["fingerprint"] = None
