"""Content-addressed job-summary memoization (the memo plane's host side),
the port's copy of the JAX package's ``utils/memocache.py``.

Traffic that repeats a small scenario library is served fastest by not
ticking at all: content-address whole jobs and serve exact repeats from a
summary cache ("Supercharging Packet-level Network Simulation via
Memoization and Fast-Forwarding", PAPERS.md). This module is that cache,
the prefix-checkpoint store of ``memo="prefix"``, the digest recipes and
the ``memo`` knob's resolution; lane coalescing, fast-forwarding and the
prefix fork live in ``parallel/batch.py``. Digests, cache lines, error
messages and the leaf encoding are the JAX package's byte for byte, so a
cache file written by either package loads in the other.

**Digest recipe** (``job_digest``): sha256 over a canonical JSON
encoding of everything that determines a job's summary bit-for-bit —
the topology spec (sorted node ids + balances + sorted links), the
job's compiled script rows (kind/arg0/arg1/do_tick), its fault
adversary key, its delay-sampler state row, the scheduler, the RESOLVED
engine knobs (queue/comm/kernel — "auto" is resolved before hashing so
a digest means the same thing on every backend), and the
semantics-affecting SimConfig fields (everything except
``trace_capacity``, which changes only observability). Two jobs with
equal digests run the identical jitted computation on identical
operands, so their summaries are interchangeable.

**Cache file format**: JSON lines, one entry per line —
``{"schema": MEMOCACHE_SCHEMA_VERSION, "digest": <64 hex>,
"summary": {...}}`` — content-addressed by digest (last write wins on
re-insert). Discipline mirrors utils/checkpoint.py, not the lenient
telemetry reader: writes are atomic (tmp-then-``os.replace``, tmp
unlinked on any failure), and a load REJECTS a poisoned, truncated or
stale-schema file with ``MemoCacheError`` naming the path — a cache
that silently skipped a torn line could silently serve a stale summary
forever.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np

from chandy_lamport_tpu_torch.config import ENGINE_KNOBS
from chandy_lamport_tpu_torch.utils.atomicio import (
    crash_failpoint,
    fsync_dir,
    fsync_file,
)
from chandy_lamport_tpu_torch.utils.filelock import locked

# the memo knob's spellings, an opt-in ladder (config.ENGINE_KNOBS)
MEMO_MODES = ENGINE_KNOBS["memo"]

# the memocache schema version (the JAX package's), bumped on any breaking
# change of the cache line layout or the digest recipe (a recipe change
# must bump it — old digests would alias different computations)
MEMOCACHE_SCHEMA_VERSION = 1

_DIGEST_HEX_LEN = 64   # sha256


class MemoCacheError(ValueError):
    """A memo cache file could not be read or validated, or a shadow
    re-execution contradicted a served summary. Always carries the path
    (or the digest, for shadow mismatches); raised instead of silently
    skipping damage — a summary cache that guesses serves stale answers
    forever."""


def resolve_memo(memo: str) -> str:
    """Validate the ``memo`` knob (``MEMO_MODES``). There is no "auto":
    the spellings are an explicit opt-in ladder (off < admit < full <
    prefix), so resolution is pure validation."""
    allowed = MEMO_MODES
    if memo not in allowed:
        raise ValueError(
            f"memo must be one of {', '.join(map(repr, allowed))}, "
            f"got {memo!r}")
    return memo


def _canon(x: Any) -> Any:
    """Canonical JSON-able form of a digest ingredient: numpy arrays
    become (dtype, shape, values) triples, scalars become python ints/
    floats, tuples become lists — stable across processes and numpy
    versions (json.dumps with sort_keys does the rest)."""
    if isinstance(x, np.ndarray):
        return ["ndarray", str(x.dtype), list(x.shape),
                x.reshape(-1).tolist()]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _canon(v) for k, v in sorted(x.items())}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    # last resort: a stable repr (delay treedefs reach here as strings
    # already; anything else unexpected still digests deterministically)
    return repr(x)


# the canonical nodes and links of the last topology digested: a pool's
# digests all hash one topology, whose encoding is most of a digest's
# host time on a wide graph (the bytes hashed are the same)
_TOPO_CANON: list = [None, None, None]


def _topo_canon(topo_spec) -> tuple:
    if _TOPO_CANON[0] is not topo_spec:
        _TOPO_CANON[:] = [
            topo_spec,
            _canon(sorted((str(k), int(v)) for k, v in topo_spec.nodes)),
            _canon(sorted((str(s), str(d)) for s, d in topo_spec.links))]
    return _TOPO_CANON[1], _TOPO_CANON[2]


def job_digest(*, topo_spec, script, fault_key, delay_row, scheduler: str,
               knobs: Dict[str, str], config_fields: Dict[str, Any]) -> str:
    """The content address of one stream job (module docstring recipe).

    ``topo_spec`` is a utils.fixtures.TopologySpec (of either package);
    ``script`` the job's
    compiled (kind, arg0, arg1, do_tick) row arrays; ``delay_row`` the
    job's delay-sampler state pytree (leaves + treedef string);
    ``knobs`` the RESOLVED engine knob spellings; ``config_fields`` the
    semantics-affecting SimConfig fields. Every ingredient goes through
    the canonical encoding so the digest is process- and
    platform-stable.
    """
    nodes, links = _topo_canon(topo_spec)
    payload = {
        "schema": MEMOCACHE_SCHEMA_VERSION,
        "nodes": nodes,
        "links": links,
        "script": _canon(list(script)),
        "fault_key": _canon(fault_key),
        "delay_row": _canon(delay_row),
        "scheduler": str(scheduler),
        "knobs": _canon(knobs),
        "config": _canon(config_fields),
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _read_entries(path: str) -> "OrderedDict[str, dict]":
    """Strict parse of a memo cache file (module docstring format) into
    an OrderedDict in file order. Raises MemoCacheError on any damage."""
    out: "OrderedDict[str, dict]" = OrderedDict()
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read()
    except OSError as exc:
        raise MemoCacheError(
            f"memo cache {path}: unreadable ({exc})") from exc
    for lineno, line in enumerate(raw.splitlines(), start=1):
        if not line.strip():
            continue
        try:
            entry = json.loads(line)
        except ValueError as exc:
            raise MemoCacheError(
                f"memo cache {path}: line {lineno} is not valid JSON "
                f"(poisoned or truncated write: {exc})") from exc
        if not isinstance(entry, dict) or not {
                "schema", "digest", "summary"} <= set(entry):
            raise MemoCacheError(
                f"memo cache {path}: line {lineno} is missing the "
                f"schema/digest/summary keys — not a memo cache entry")
        if entry["schema"] != MEMOCACHE_SCHEMA_VERSION:
            raise MemoCacheError(
                f"memo cache {path}: line {lineno} has schema version "
                f"{entry['schema']!r}; this build reads only "
                f"v{MEMOCACHE_SCHEMA_VERSION} (a schema bump changes "
                f"the digest recipe — stale entries must not be "
                f"served; delete the file to rebuild it)")
        digest = entry["digest"]
        if (not isinstance(digest, str)
                or len(digest) != _DIGEST_HEX_LEN
                or any(c not in "0123456789abcdef" for c in digest)):
            raise MemoCacheError(
                f"memo cache {path}: line {lineno} digest "
                f"{digest!r} is not a sha256 hex string")
        if not isinstance(entry["summary"], dict):
            raise MemoCacheError(
                f"memo cache {path}: line {lineno} summary is not an "
                f"object")
        out[digest] = entry["summary"]
    return out


class SummaryCache:
    """The persistent content-addressed summary store (module docstring
    format). In-memory dict keyed by digest; ``load`` is strict,
    ``flush`` is atomic. An entry's summary is the per-job result row as
    plain JSON scalars/lists (parallel/batch.stream_results row minus
    the job index, which is pool-relative, plus the producer's digest so
    telemetry can prove provenance).

    **Capacity bounds** (``max_entries``/``max_bytes``, 0 = unbounded):
    the store is an LRU — ``get`` hits and ``put`` inserts refresh
    recency; crossing either cap evicts the least-recently-used entries
    (counted in ``evictions``/``evicted_bytes``, surfaced through the
    memo books in ``summarize_stream``). The byte charge per entry is
    its serialized cache-line length, so ``max_bytes`` bounds the FILE
    the flush writes. ``flush`` persists in recency order, meaning
    recency survives restarts: a reloaded cache evicts the same entries
    a long-lived one would have."""

    def __init__(self, path: Optional[str], max_entries: int = 0,
                 max_bytes: int = 0):
        if max_entries < 0 or max_bytes < 0:
            raise ValueError("cache capacity bounds must be >= 0")
        self.path = path
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.evictions = 0
        self.evicted_bytes = 0
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._nbytes: Dict[str, int] = {}
        self._total_bytes = 0
        self._dirty = False
        if path is not None and os.path.exists(path):
            self._load(path)
            self._evict()

    @staticmethod
    def _line_bytes(digest: str, summary: dict) -> int:
        return len(json.dumps(
            {"schema": MEMOCACHE_SCHEMA_VERSION, "digest": digest,
             "summary": summary}, sort_keys=True)) + 1

    def _charge(self, digest: str, summary: dict) -> None:
        self._total_bytes -= self._nbytes.get(digest, 0)
        nb = self._line_bytes(digest, summary)
        self._nbytes[digest] = nb
        self._total_bytes += nb

    def _evict(self) -> None:
        while self._entries and (
                (self.max_entries
                 and len(self._entries) > self.max_entries)
                or (self.max_bytes
                    and self._total_bytes > self.max_bytes)):
            digest, _ = self._entries.popitem(last=False)
            nb = self._nbytes.pop(digest)
            self._total_bytes -= nb
            self.evictions += 1
            self.evicted_bytes += nb
            self._dirty = True

    def _load(self, path: str) -> None:
        with locked(path, shared=True):
            entries = _read_entries(path)
        # file order is recency order (flush writes LRU-first), so a
        # straight insert reconstructs the recency chain
        for digest, summary in entries.items():
            self._entries[digest] = summary
            self._entries.move_to_end(digest)
            self._charge(digest, summary)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, digest: str) -> bool:
        return digest in self._entries

    def get(self, digest: str) -> Optional[dict]:
        hit = self._entries.get(digest)
        if hit is not None:
            self._entries.move_to_end(digest)
        return hit

    def put(self, digest: str, summary: dict) -> None:
        self._entries[digest] = summary
        self._entries.move_to_end(digest)
        self._charge(digest, summary)
        self._dirty = True
        self._evict()

    def flush(self) -> None:
        """Atomically persist every entry (tmp-then-``os.replace``,
        checkpoint.py discipline): a kill at any instant leaves either
        the previous complete file or the new complete file, never a
        torn one. No-op without a path or pending writes.

        Cross-process safe: the whole read-merge-write runs under an
        exclusive advisory lock (utils/filelock). Entries another
        process flushed since our load are folded back in as
        older-than-ours before the rewrite, so concurrent writers to a
        shared cache path all survive instead of last-writer-wins."""
        if self.path is None or not self._dirty:
            return
        tmp = self.path + ".tmp"
        with locked(self.path):
            if os.path.exists(self.path):
                disk = _read_entries(self.path)
                for digest in reversed(disk):
                    if digest not in self._entries:
                        self._entries[digest] = disk[digest]
                        self._entries.move_to_end(digest, last=False)
                        self._charge(digest, disk[digest])
                self._evict()
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    for digest, summary in self._entries.items():
                        f.write(json.dumps(
                            {"schema": MEMOCACHE_SCHEMA_VERSION,
                             "digest": digest, "summary": summary},
                            sort_keys=True) + "\n")
                    # the tmp bytes must be on stable storage BEFORE the
                    # rename commits the name to them, or a power cut
                    # after the replace leaves the new name torn
                    fsync_file(f)
                crash_failpoint("memocache-replace")
                os.replace(tmp, self.path)
                fsync_dir(self.path)
                self._dirty = False
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise


# ---------------------------------------------------------------------------
# prefix plane: rolling phase-boundary digests + checkpointed lane states
# ---------------------------------------------------------------------------

# the prefix-cache schema version (the JAX package's), same discipline as
# MEMOCACHE_SCHEMA_VERSION above: bumped on any breaking change of the
# prefix entry layout, the leaf encoding, or the chain recipe — a recipe
# change must bump it, or old chain digests would alias checkpoints of
# different computations.
PREFIXCACHE_SCHEMA_VERSION = 1


class PrefixCacheError(MemoCacheError):
    """A prefix cache file could not be read or validated, or a forked
    job's shadow re-execution contradicted its cold run. Subclasses
    MemoCacheError (same refusal philosophy: a checkpoint store that
    guesses forks lanes into the wrong simulation)."""


def prefix_seed_digest(*, topo_spec, fault_key, delay_row, scheduler: str,
                       knobs: Dict[str, str],
                       config_fields: Dict[str, Any]) -> bytes:
    """Link zero of a job's prefix-digest chain: sha256 over the job's
    SCRIPT-FREE identity — exactly the ``job_digest`` recipe minus the
    script rows, plus a plane tag so a seed digest can never alias a
    whole-job digest. Two jobs share chain link d iff they share this
    identity AND their first d compiled script rows are byte-equal, so
    a checkpoint produced under one job's identity forks bit-exactly
    into any chain-sharing job."""
    nodes, links = _topo_canon(topo_spec)
    payload = {
        "schema": PREFIXCACHE_SCHEMA_VERSION,
        "plane": "prefix",
        "nodes": nodes,
        "links": links,
        "fault_key": _canon(fault_key),
        "delay_row": _canon(delay_row),
        "scheduler": str(scheduler),
        "knobs": _canon(knobs),
        "config": _canon(config_fields),
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).digest()


def prefix_extend(prev: bytes, row) -> bytes:
    """One chain step: c_{i+1} = sha256(c_i || canon(script row i)).
    ``row`` is the (kind, arg0, arg1, do_tick) tuple of ONE compiled
    phase. Rolling rather than hash-of-prefix so pack_jobs pays O(rows)
    per job, not O(rows^2)."""
    blob = json.dumps(_canon(list(row)), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(prev + blob.encode()).digest()


def _enc_leaf(x: Any) -> dict:
    """Exact JSON encoding of a checkpoint leaf: ndarrays become
    (dtype, shape, base64 raw bytes) — byte-lossless, unlike _canon's
    tolist (which exists for digesting, not round-tripping) — and
    tuples/lists recurse (delay-sampler states are tuples of arrays)."""
    if isinstance(x, (tuple, list)):
        return {"t": [_enc_leaf(v) for v in x]}
    a = np.asarray(x)
    return {"d": str(a.dtype), "s": list(a.shape),
            "b": base64.b64encode(a.tobytes()).decode("ascii")}


def _dec_leaf(node: Any, path: str) -> Any:
    """Strict inverse of _enc_leaf; raises PrefixCacheError on any
    malformed node (naming ``path``) instead of guessing."""
    if not isinstance(node, dict):
        raise PrefixCacheError(
            f"prefix cache {path}: checkpoint leaf is not an object")
    if "t" in node:
        if not isinstance(node["t"], list):
            raise PrefixCacheError(
                f"prefix cache {path}: checkpoint tuple node is not a "
                f"list")
        return tuple(_dec_leaf(v, path) for v in node["t"])
    try:
        dtype = np.dtype(node["d"])
        shape = tuple(int(s) for s in node["s"])
        raw = base64.b64decode(node["b"], validate=True)
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    except (KeyError, TypeError, ValueError) as exc:
        raise PrefixCacheError(
            f"prefix cache {path}: checkpoint array node is damaged "
            f"({exc})") from exc
    return arr


def _read_prefix_entries(path: str) -> "OrderedDict[str, dict]":
    """Strict parse of a prefix cache file into an OrderedDict in file
    order (file order is recency order, like SummaryCache). Entry
    layout: ``{"schema": PREFIXCACHE_SCHEMA_VERSION, "digest": <64
    hex>, "depth": <phases>, "seen": <count>, "ckpt": null |
    {"leaves": {...}}}``. Raises PrefixCacheError on any damage."""
    out: "OrderedDict[str, dict]" = OrderedDict()
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read()
    except OSError as exc:
        raise PrefixCacheError(
            f"prefix cache {path}: unreadable ({exc})") from exc
    for lineno, line in enumerate(raw.splitlines(), start=1):
        if not line.strip():
            continue
        try:
            entry = json.loads(line)
        except ValueError as exc:
            raise PrefixCacheError(
                f"prefix cache {path}: line {lineno} is not valid JSON "
                f"(poisoned or truncated write: {exc})") from exc
        if not isinstance(entry, dict) or not {
                "schema", "digest", "depth", "seen", "ckpt"} <= set(entry):
            raise PrefixCacheError(
                f"prefix cache {path}: line {lineno} is missing the "
                f"schema/digest/depth/seen/ckpt keys — not a prefix "
                f"cache entry")
        if entry["schema"] != PREFIXCACHE_SCHEMA_VERSION:
            raise PrefixCacheError(
                f"prefix cache {path}: line {lineno} has schema version "
                f"{entry['schema']!r}; this build reads only "
                f"v{PREFIXCACHE_SCHEMA_VERSION} (a schema bump changes "
                f"the chain recipe or the leaf encoding — stale "
                f"checkpoints must not be forked from; delete the file "
                f"to rebuild it)")
        digest = entry["digest"]
        if (not isinstance(digest, str)
                or len(digest) != _DIGEST_HEX_LEN
                or any(c not in "0123456789abcdef" for c in digest)):
            raise PrefixCacheError(
                f"prefix cache {path}: line {lineno} digest "
                f"{digest!r} is not a sha256 hex string")
        if not isinstance(entry["depth"], int) or entry["depth"] < 1:
            raise PrefixCacheError(
                f"prefix cache {path}: line {lineno} depth "
                f"{entry['depth']!r} is not a positive phase count")
        if not isinstance(entry["seen"], int) or entry["seen"] < 0:
            raise PrefixCacheError(
                f"prefix cache {path}: line {lineno} seen count "
                f"{entry['seen']!r} is not a non-negative int")
        ckpt = entry["ckpt"]
        if ckpt is not None and not (
                isinstance(ckpt, dict)
                and isinstance(ckpt.get("leaves"), dict)):
            raise PrefixCacheError(
                f"prefix cache {path}: line {lineno} ckpt is neither "
                f"null nor a leaves object")
        out[digest] = {"depth": entry["depth"], "seen": entry["seen"],
                       "ckpt": ckpt}
    return out


class PrefixCache:
    """The persistent prefix-checkpoint store (memo="prefix" plane's
    host side), beside SummaryCache with the same discipline: strict
    load, atomic locked flush, LRU by entries AND bytes. Content
    address = a chain digest (prefix_seed_digest + prefix_extend per
    phase row); an entry carries the boundary ``depth``, a ``seen``
    counter (how many admissions crossed this boundary without a
    checkpoint existing yet — the heat signal that promotes a boundary
    to checkpointed on its next encounter), and optionally the ``ckpt``
    itself: the lane's semantic DenseState leaves at the boundary, in the
    JAX package's dtypes (uint32 words as uint32), byte-losslessly encoded
    (_enc_leaf). ``max_bytes`` matters here far
    more than for summaries — one ring-8 checkpoint is tens of KB, so
    the LRU is the line between "cache" and "unbounded state dump"."""

    def __init__(self, path: Optional[str], max_entries: int = 0,
                 max_bytes: int = 0):
        if max_entries < 0 or max_bytes < 0:
            raise ValueError("cache capacity bounds must be >= 0")
        self.path = path
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.evictions = 0
        self.evicted_bytes = 0
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._nbytes: Dict[str, int] = {}
        self._total_bytes = 0
        self._dirty = False
        if path is not None and os.path.exists(path):
            self._load(path)
            self._evict()

    @staticmethod
    def _line_bytes(digest: str, entry: dict) -> int:
        return len(json.dumps(
            {"schema": PREFIXCACHE_SCHEMA_VERSION, "digest": digest,
             "depth": entry["depth"], "seen": entry["seen"],
             "ckpt": entry["ckpt"]}, sort_keys=True)) + 1

    def _charge(self, digest: str, entry: dict) -> None:
        self._total_bytes -= self._nbytes.get(digest, 0)
        nb = self._line_bytes(digest, entry)
        self._nbytes[digest] = nb
        self._total_bytes += nb

    def _evict(self) -> None:
        while self._entries and (
                (self.max_entries
                 and len(self._entries) > self.max_entries)
                or (self.max_bytes
                    and self._total_bytes > self.max_bytes)):
            digest, _ = self._entries.popitem(last=False)
            nb = self._nbytes.pop(digest)
            self._total_bytes -= nb
            self.evictions += 1
            self.evicted_bytes += nb
            self._dirty = True

    def _load(self, path: str) -> None:
        with locked(path, shared=True):
            entries = _read_prefix_entries(path)
        for digest, entry in entries.items():
            self._entries[digest] = entry
            self._entries.move_to_end(digest)
            self._charge(digest, entry)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, digest: str) -> bool:
        return digest in self._entries

    def seen(self, digest: str) -> int:
        entry = self._entries.get(digest)
        return int(entry["seen"]) if entry is not None else 0

    def bump_seen(self, digest: str, depth: int) -> None:
        """Record one checkpoint-less crossing of a boundary. Does NOT
        refresh LRU recency — heat alone must not out-compete real
        checkpoints for residency."""
        entry = self._entries.get(digest)
        if entry is None:
            entry = {"depth": int(depth), "seen": 1, "ckpt": None}
            self._entries[digest] = entry
            self._entries.move_to_end(digest, last=False)
        else:
            entry["seen"] = int(entry["seen"]) + 1
        self._charge(digest, entry)
        self._dirty = True
        self._evict()

    def has_ckpt(self, digest: str) -> bool:
        entry = self._entries.get(digest)
        return entry is not None and entry["ckpt"] is not None

    def get_ckpt(self, digest: str) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(depth, decoded leaves dict) of a checkpointed boundary, or
        None. A hit refreshes LRU recency."""
        entry = self._entries.get(digest)
        if entry is None or entry["ckpt"] is None:
            return None
        self._entries.move_to_end(digest)
        leaves = {
            str(name): _dec_leaf(node, self.path or "<memory>")
            for name, node in entry["ckpt"]["leaves"].items()}
        return int(entry["depth"]), leaves

    def put_ckpt(self, digest: str, depth: int,
                 leaves: Dict[str, Any]) -> None:
        prev = self._entries.get(digest)
        entry = {"depth": int(depth),
                 "seen": int(prev["seen"]) if prev else 0,
                 "ckpt": {"leaves": {str(k): _enc_leaf(v)
                                     for k, v in leaves.items()}}}
        self._entries[digest] = entry
        self._entries.move_to_end(digest)
        self._charge(digest, entry)
        self._dirty = True
        self._evict()

    def flush(self) -> None:
        """Atomic locked read-merge-write, SummaryCache.flush's
        discipline verbatim, plus a prefix-specific merge rule for
        digests both sides hold: a checkpoint beats a seen-only entry
        (never downgrade a boundary another process promoted), and
        ``seen`` merges as max — a heat signal should survive
        concurrent writers, not reset to the last writer's count."""
        if self.path is None or not self._dirty:
            return
        tmp = self.path + ".tmp"
        with locked(self.path):
            if os.path.exists(self.path):
                disk = _read_prefix_entries(self.path)
                for digest in reversed(disk):
                    mine = self._entries.get(digest)
                    if mine is None:
                        self._entries[digest] = disk[digest]
                        self._entries.move_to_end(digest, last=False)
                        self._charge(digest, disk[digest])
                        continue
                    theirs = disk[digest]
                    mine["seen"] = max(int(mine["seen"]),
                                       int(theirs["seen"]))
                    if mine["ckpt"] is None and theirs["ckpt"] is not None:
                        mine["ckpt"] = theirs["ckpt"]
                        mine["depth"] = theirs["depth"]
                    self._charge(digest, mine)
                self._evict()
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    for digest, entry in self._entries.items():
                        f.write(json.dumps(
                            {"schema": PREFIXCACHE_SCHEMA_VERSION,
                             "digest": digest, "depth": entry["depth"],
                             "seen": entry["seen"],
                             "ckpt": entry["ckpt"]},
                            sort_keys=True) + "\n")
                    fsync_file(f)
                crash_failpoint("prefixcache-replace")
                os.replace(tmp, self.path)
                fsync_dir(self.path)
                self._dirty = False
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
