"""Batched runs: B independent instances advanced together.

The port of the JAX package's ``parallel/batch.BatchedRunner`` under
``scheduler="sync"`` and ``scheduler="exact"`` (the cascade and the wave
formulations): the state carries the batch as a leading axis (in place
of ``jax.vmap``), and where the JAX runner branches per lane the port
carries a per-lane mask. Three ways to drive the lanes:

- storm programs (``run_storm``): a Python loop over the phases, then the
  drain ticks each lane until its own condition ends (ops/tick.py);
- compiled event scripts (``compile_events``, ``run``, ``run_ticks``):
  one script shared by every lane, each phase's ops then its tick count;
- the streaming job engine (``pack_jobs``, ``init_stream``,
  ``run_stream``): a queue of J compiled jobs through the B lane slots,
  each lane in its own stage (script, drain, flush, retired), a retired
  lane harvested into a results ring and refilled at once. Every job's
  row equals the same job run alone through ``run``. With the memo plane
  on (``memo=``, utils/memocache.py) duplicate jobs share one lane, jobs
  whose digest the summary cache holds take none, lanes whose state
  signature recurs in their drain are fast-forwarded, and near-duplicates
  fork from checkpointed prefix states; every served row equals the row
  the memo-off engine gives the same pool.

At ``megatick`` K > 1 the exact drain and flush (the stream's drain slice
and flush pass among them) run in K-tick megaticks through the fused
megatick kernel. Runs on the card unless the caller passes
``device="cpu"``, where the kernel wrappers take their plain PyTorch
versions. Both schedulers carry the fault adversary (``faults=``), the
snapshot supervisor (the config's ``snapshot_*`` knobs), ``quarantine=``
and the flight recorder (``trace=``, utils/tracing.py). ``run_stream``
checkpoints its ``(state, stream)`` carry every K steps
(utils/checkpoint.py), and a run resumed from the file ends bit-equal to
the uninterrupted one, under every memo mode.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.spec import (
    Event,
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.core.state import (
    ERR_CONSERVATION,
    ERR_TICK_LIMIT,
    U32_LEAVES,
    WINDOW_LEAVES,
    DenseState,
    DenseTopology,
    decode_error_bits,
    init_state,
)
from chandy_lamport_tpu_torch.ops.tick import (
    TickKernel,
    fork_lanes,
    harvest_lane_summaries,
    reset_lanes,
)
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec
from chandy_lamport_tpu_torch.utils.guards import (
    armed,
    guarded_get,
    guarded_put,
    host_sync,
    relaxed_site,
)
from chandy_lamport_tpu_torch.utils.memocache import (
    MemoCacheError,
    PrefixCache,
    PrefixCacheError,
    SummaryCache,
    job_digest,
    prefix_extend,
    prefix_seed_digest,
    resolve_memo,
)
from chandy_lamport_tpu_torch.utils.metrics import (
    lane_total_tokens,
    or_reduce,
    snapshot_lifecycle,
    straggler_waste,
    stream_counters,
)
from chandy_lamport_tpu_torch.utils.tracing import (
    EV_LANE_ADMIT,
    EV_LANE_COALESCE,
    EV_LANE_HARVEST,
    EV_MEMO_HIT,
    EV_PREFIX_FORK,
    EV_SERVE_ADMIT,
    EV_SERVE_MISS,
    armed_config,
    trace_append_lanes,
    trace_counts,
)

OP_NOP, OP_SEND, OP_SNAPSHOT = 0, 1, 2

_i32 = torch.int32
_M32 = 0xFFFFFFFF

# With memo != "off", every MEMO_SHADOW_EVERY-th job served without
# execution (a summary-cache hit or a coalesced follower) also runs alone
# on a lane, and its summary must equal the served one bit for bit, or
# MemoCacheError. Under "prefix" the same cadence re-runs forked jobs cold
# at the end of the run (PrefixCacheError on a mismatch).
# run_stream(shadow_every=...) overrides it (0 disables). The JAX value.
MEMO_SHADOW_EVERY = 16

# DenseState leaves a prefix checkpoint does not capture: fork_lanes'
# keep-set (the lane bookkeeping, the flight recorder's ring and
# fault_key, which is part of the chain identity). Everything else, the
# delay sampler's advanced words included, is captured, so a forked lane
# equals a cold lane whose cursor just crossed the boundary.
_PREFIX_KEEP_LEAVES = frozenset((
    "fault_key", "job_id", "prog_cursor", "admit_tick",
    "tr_meta", "tr_data", "tr_tick", "tr_count", "tr_on"))

# DenseState leaves the per-lane state signature leaves out: the clock
# (fast-forwarding asks whether the state is invariant under the tick
# modulo time), the recorder's ring, the signature itself and the
# admission stamp. Everything else is hashed.
_SIG_SKIP_LEAVES = frozenset((
    "time", "admit_tick", "tr_meta", "tr_data", "tr_tick", "tr_count",
    "tr_on", "sig"))


@functools.lru_cache(maxsize=64)
def _sig_weights(size: int, device: str) -> torch.Tensor:
    """The signature's per-position u32 weights ``i * 2654435761 +
    0x85EBCA6B`` (mod 2^32) of a leaf of ``size`` words, as int64."""
    i = np.arange(size, dtype=np.uint64)
    w = (i * np.uint64(2654435761) + np.uint64(0x85EBCA6B)) \
        & np.uint64(_M32)
    return torch.from_numpy(w.astype(np.int64)).to(device)


def _sig_words(leaf: torch.Tensor, itemsize: int) -> torch.Tensor:
    """One [B, ...] leaf as [B, M] u32 words held in int64 (the JAX
    ``_sig_words`` per lane): a leaf whose JAX dtype is 8 bytes wide splits
    into its lo then its hi words; every narrower one is cast to uint32
    as jnp's ``astype`` casts (an int16 -1 is 0xFFFFFFFF, a bool 0 or
    1). The port's uint32 words are int64 values in [0, 2^32) already."""
    x = leaf.reshape(leaf.shape[0], -1)
    if x.dtype.is_floating_point:
        raise TypeError("the state signature hashes integer leaves only")
    x = x.to(torch.int64)
    if itemsize == 8:
        return torch.cat([x & _M32, (x >> 32) & _M32], dim=1)
    return x & _M32


def _sig_leaves(s: DenseState, delay):
    """(leaf, JAX itemsize) of every hashed leaf of ``s``, in the JAX
    flatten order."""
    for name, val in zip(DenseState._fields, s):
        if name in _SIG_SKIP_LEAVES:
            continue
        if name == "delay_state":
            for w, dt in zip(val, delay.host_dtypes):
                yield w, np.dtype(dt).itemsize
        elif name in U32_LEAVES:
            yield val, 4
        elif name in WINDOW_LEAVES and val.dtype == torch.int16:
            # uint16 windows zero-extend, as jnp's astype(uint32) does
            yield val.to(torch.int64) & 0xFFFF, 2
        else:
            yield val, val.element_size()


def _lane_signature(s: DenseState, delay) -> torch.Tensor:
    """[B] u32 fingerprint (int64 values) of each lane's semantic state,
    bit-equal to the JAX ``_lane_signature`` of the same lane: per leaf a
    position-weighted u32 sum (positions count within one lane), then an
    FNV-style combine across leaves with a per-leaf salt. Every product
    of two u32 values goes through 16-bit halves, so no partial product
    passes 2^48 in int64. Equal states hash equal; a 32-bit collision is
    the residual risk the shadow audit (MEMO_SHADOW_EVERY) exists to
    catch. ``delay``: the sampler whose words ``delay_state`` holds (their
    JAX dtypes)."""
    acc = torch.full_like(s.time, 0x9E3779B9, dtype=torch.int64)
    for idx, (leaf, itemsize) in enumerate(_sig_leaves(s, delay)):
        w = _sig_words(leaf, itemsize)
        wt = _sig_weights(w.shape[1], str(w.device))
        prod = ((w & 0xFFFF) * wt
                + ((((w >> 16) * wt) & 0xFFFF) << 16)) & _M32
        h = prod.sum(1) & _M32
        salt = (idx * 0x9E3779B9) & _M32
        acc = ((acc * 1000003) & _M32) ^ ((h + salt) & _M32)
    return acc


def _delay_treedef(words: int, bare: bool = False) -> str:
    """The JAX ``str(tree_structure(...))`` of a sampler state of
    ``words`` words (a tuple; one bare leaf where ``bare``, the threefry
    key)."""
    inner = "*" if bare else {0: "()", 1: "(*,)"}.get(
        words, "(" + ", ".join(["*"] * words) + ")")
    return f"PyTreeDef({inner})"


def _hex(row) -> str:
    return bytes(bytearray(np.asarray(row, np.uint8).tolist())).hex()


class ScriptOps(NamedTuple):
    """A compiled event script (the JAX ``ScriptOps``): T phases of up to
    K ops, each phase followed by ``do_tick`` ticks (0 only for a
    synthetic trailing phase); numpy arrays."""

    kind: Any      # i32 [T, K]  OP_NOP | OP_SEND | OP_SNAPSHOT
    arg0: Any      # i32 [T, K]  edge index (send) | node index (snapshot)
    arg1: Any      # i32 [T, K]  token amount (send)
    do_tick: Any   # i32 [T]     ticks after the phase's ops

    @property
    def num_phases(self) -> int:
        return self.kind.shape[0]


def compile_events(topo: DenseTopology, events: List[Event]) -> ScriptOps:
    """Events -> dense op arrays (the JAX ``compile_events``). Each ``tick
    n`` closes the current phase with a tick count of n (consecutive tick
    events merge into one phase); trailing non-tick events get a final
    synthetic phase with ``do_tick=0``; an empty script is one bare
    tick."""
    phases: List[tuple] = []
    cur: List[tuple] = []
    for ev in events:
        if isinstance(ev, PassTokenEvent):
            src, dest = topo.index[ev.src], topo.index[ev.dest]
            e = topo.edge_index.get((src, dest))
            if e is None:
                raise ValueError(f"no link {ev.src} -> {ev.dest}")
            cur.append((OP_SEND, e, ev.tokens))
        elif isinstance(ev, SnapshotEvent):
            cur.append((OP_SNAPSHOT, topo.index[ev.node_id], 0))
        elif isinstance(ev, TickEvent):
            if not cur and phases and phases[-1][1]:
                phases[-1] = (phases[-1][0], phases[-1][1] + ev.n)
            else:
                phases.append((cur, ev.n))
                cur = []
        else:
            raise TypeError(f"unknown event: {ev!r}")
    if cur:
        phases.append((cur, 0))
    if not phases:
        phases.append(([], 1))
    t = len(phases)
    k = max((len(p) for p, _ in phases), default=0) or 1
    kind = np.zeros((t, k), np.int32)
    arg0 = np.zeros((t, k), np.int32)
    arg1 = np.zeros((t, k), np.int32)
    do_tick = np.array([n for _, n in phases], np.int32)
    for i, (ops, _) in enumerate(phases):
        for j, (op, a0, a1) in enumerate(ops):
            kind[i, j], arg0[i, j], arg1[i, j] = op, a0, a1
    return ScriptOps(kind, arg0, arg1, do_tick)


class JobPool(NamedTuple):
    """J compiled jobs packed into one pooled phase table (the JAX
    ``JobPool``), every leaf a tensor on the runner's device. Rows
    ``job_start[j]..job_end[j]`` are job j's phases (padded to the pool's
    K with OP_NOP); ``job_limit[j]`` is its drain budget from tick 0 (its
    scripted ticks + ``max_ticks``: a static run enters its drain at
    exactly that many ticks); ``fault_key[j]`` and ``delay_state[j]``
    are its stream identities (row j of ``init_batch_state(J)``, or under
    content keys the row of its content rank), copied into whichever lane
    admits it. ``digest[j]`` is its content address (sha256 bytes,
    utils/memocache.job_digest; zeros with content keys off).
    ``prefix_digest`` (memo "prefix" only, else None) is the rolling
    chain of phase-boundary digests, a host numpy array [P, 32]
    row-aligned with the phase table: row ``job_start[j] + i`` addresses
    job j's lane state after its first i + 1 phases. It is planning data
    and never moves to the device."""

    kind: Any        # i32 [P, K]
    arg0: Any        # i32 [P, K]
    arg1: Any        # i32 [P, K]
    do_tick: Any     # i32 [P]
    job_start: Any   # i32 [J]
    job_end: Any     # i32 [J]
    job_limit: Any   # i32 [J]
    fault_key: Any   # u32 [J] (int64 words; 0 = disarmed)
    digest: Any      # u8 [J, 32]
    delay_state: Any  # sampler tuple, leaves [J, ...]
    prefix_digest: Any = None  # numpy u8 [P, 32] (memo "prefix")

    @property
    def num_jobs(self) -> int:
        return int(self.job_start.shape[0])


class StreamState(NamedTuple):
    """The streaming engine's carry beside the lane batch (the JAX
    ``StreamState``, leaf for leaf): admission and occupancy books, the
    memo and prefix counters, the serving books (serving/server.py; a
    plain stream keeps one zero tenant) and the per-job results ring the
    harvest writes. Every leaf is an int32 tensor on the runner's
    device. ``cache_hits``,
    ``coalesced_jobs``, ``shadow_checks`` and ``prefix_hits`` are set by
    the host when a memoized run ends; ``ff_skipped_ticks``,
    ``forked_jobs`` and ``fork_depth_sum`` accumulate on the device, so a
    checkpoint carries them."""

    next_job: Any          # []  jobs admitted (memo on: exec-order slots)
    jobs_done: Any         # []  jobs harvested into the ring
    steps: Any             # []  stream steps executed
    refills: Any           # []  admissions into a recycled slot
    lane_steps_live: Any   # []  lane-steps that held a live job
    lane_steps_total: Any  # []  lane-steps charged (occupancy denominator)
    cache_hits: Any        # []  jobs served from the summary cache
    coalesced_jobs: Any    # []  duplicates served by a leader's lane
    ff_skipped_ticks: Any  # []  ticks credited by fast-forward
    shadow_checks: Any     # []  served summaries re-proven by a shadow
    prefix_hits: Any       # []  jobs planned to fork from a checkpoint
    forked_jobs: Any       # []  fork admissions made
    fork_depth_sum: Any    # []  phases skipped by forks
    deadline_misses: Any   # []  harvests past their job's deadline
    tenant_served: Any     # [T]
    tenant_quota: Any      # [T]
    res_count: Any         # []  results written (the ring wraps past R)
    res_job: Any           # [R]  job id (-1 = empty slot)
    res_time: Any          # [R]  final lane clock
    res_error: Any         # [R]  sticky error bits at harvest
    res_snap_started: Any  # [R]
    res_snap_completed: Any
    res_snap_failed: Any
    res_fault_skew: Any
    res_fault_events: Any
    res_admit_step: Any    # [R]  stream step the job was admitted at
    res_tokens: Any        # [R, N] final node balances


def _ring_rows(stream: StreamState) -> List[dict]:
    """The harvested results ring as per-job dict rows, in ring order
    (only the newest ``capacity`` rows survive a wrap)."""
    host = {name: getattr(stream, name).cpu().tolist()
            for name in StreamState._fields}
    rcap = len(host["res_job"])
    rows = []
    for i in range(min(int(host["res_count"]), rcap)):
        err = int(host["res_error"][i])
        rows.append({
            "job": host["res_job"][i],
            "time": host["res_time"][i],
            "error": err,
            "errors_decoded": decode_error_bits(err),
            "snapshots_started": host["res_snap_started"][i],
            "snapshots_completed": host["res_snap_completed"][i],
            "snapshots_failed": host["res_snap_failed"][i],
            "fault_skew": host["res_fault_skew"][i],
            "fault_events": host["res_fault_events"][i],
            "admit_step": host["res_admit_step"][i],
            "tokens": host["res_tokens"][i],
        })
    return rows


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Without CUDA and without an explicit device, raise — a run
    meant for the card never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available and no device was given; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


class BatchedRunner:
    """Runs storm programs, event scripts and job streams over ``batch``
    lanes of one topology."""

    def __init__(self, topology: TopologySpec, config: Optional[SimConfig],
                 delay, batch: int, scheduler: str = "exact",
                 check_every: int = 0, exact_impl: str = "cascade",
                 auto_layouts: bool = False, megatick: int = 1,
                 queue_engine: str = "auto",
                 kernel_engine: Optional[str] = None, faults=None,
                 quarantine: bool = False, trace=None, memo: str = "off",
                 memo_cache: Optional[str] = None,
                 memo_cache_entries: int = 0, memo_cache_bytes: int = 0,
                 prefix_cache: Optional[str] = None,
                 prefix_cache_entries: int = 0,
                 prefix_cache_bytes: int = 0, guards=None,
                 fused_tick: Optional[str] = None,
                 fused_block_edges: int = 0,
                 fused_tile: Optional[str] = None, *, device=None):
        """scheduler: "exact" (the reference's delivery semantics,
        bit-exact; the default, as in the JAX ``BatchedRunner``) or "sync"
        (simultaneous delivery, the production path).

        exact_impl: the exact tick's formulation, "cascade" (one host step
        per batched marker delivery), "wave" (one host step per wave:
        every destination's next marker at once; needs a
        position-addressable sampler, HashDelay or FixedDelay, else
        ValueError) or "fold" (the reference-literal form: one host step
        per source that delivers; no faults, no supervisor, ValueError);
        bit-identical to each other, at any megatick.

        faults: models/faults.Faults, the deterministic fault adversary,
        armed per lane by the ``fault_key`` ramp of
        ``Faults.init_batch_state`` (zero a lane's key to disarm it); None
        calls no hook. Both schedulers.

        quarantine: a lane whose sticky error bits fire stops — its storm
        phases, drain and flush ticks are skipped and its clock stays
        where it was poisoned; healthy lanes are unaffected. Both
        schedulers.

        trace: utils/tracing.Trace arms the flight recorder: every tick
        form (and, at megatick K > 1 on the card, the fused megatick's
        recorder arm) appends the reference Logger's events to each lane's
        ring, and the streaming engine its lane admits and harvests. A
        config that leaves ``trace_capacity`` at 0 is bumped to the
        trace's capacity here. None runs no recorder site.

        megatick: the exact drain and flush run K-tick megaticks (the JAX
        storm CLI's ``--megatick``; storm phases tick one at a time);
        bit-identical to 1, the default. On the card they launch the
        fused megatick kernel, on the CPU they run its plain form;
        ``self.fused`` and ``self.fused_reason`` say which, under faults
        and the supervisor as without them. Megatick > 1 raises
        ValueError on the sync scheduler (the megatick is the exact
        scheduler's).

        check_every: if > 0, evaluate token conservation every K phases
        and once after the run, setting the sticky ERR_CONSERVATION bit on
        any lane whose balances + in-flight tokens drift.

        memo: the stream's memo plane (the JAX knob; utils/memocache.py).
        "off" (default) is the memo-free engine, bit for bit. "admit":
        ``pack_jobs`` derives the jobs' stream identities from their
        content, so duplicates share digests; ``run_stream`` runs one
        leader per digest and serves its duplicates from its row, and
        serves digests the summary cache holds without a lane. "full"
        adds the per-lane state signature (``sig``) and fast-forwards a
        lane whose signature recurs in its drain. "prefix" adds the fork:
        jobs sharing a checkpointed phase-boundary digest start from the
        checkpointed lane state. Every served row is audited by shadow
        runs (``MEMO_SHADOW_EVERY``). ``memo_cache``: the summary cache's
        JSON-lines file (None keeps it in memory for one run);
        ``memo_cache_entries`` / ``memo_cache_bytes`` its LRU bounds (0 =
        none). ``prefix_cache``: the prefix-checkpoint store's file (None
        keeps one in memory on the runner, across runs);
        ``prefix_cache_entries`` / ``prefix_cache_bytes`` its bounds.

        The JAX runner's knobs, in its positions: ``auto_layouts`` (the
        XLA boundary layouts; PyTorch tensors have one, row-major, so it
        resolves to "default": ``self.layouts_effective`` and
        ``self.layouts_reason``); ``queue_engine``, ``kernel_engine``,
        ``fused_tick``, ``fused_block_edges`` and ``fused_tile`` (None:
        the config's), resolved by ``ops/tick.TickKernel``
        (``self.kernel.<knob>_reason``). ``guards``: utils/guards.
        RuntimeGuards arms the ``run_stream`` loop (no kernel build, no
        sync outside a named site; ``guards.books()``); None (default)
        arms nothing.

        device: where the state lives and the kernels run; None means the
        card (``resolve_device``); keyword-only, the port's own."""
        if scheduler not in ("sync", "exact"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if check_every < 0:
            raise ValueError("check_every must be >= 0 (0 = off)")
        self.device = resolve_device(device)
        self.topo = DenseTopology(topology)
        self.config = armed_config(config or SimConfig(), trace)
        self.trace = trace
        # the flush must cover the sampler's max delay
        if delay.max_delay != self.config.max_delay:
            self.config = dataclasses.replace(self.config,
                                              max_delay=delay.max_delay)
        self.delay = delay
        self.batch = batch
        self.guards = guards
        self.scheduler = scheduler
        self.check_every = int(check_every)
        self._topo_spec = topology
        self.memo = resolve_memo(memo)
        self.memo_cache_path = memo_cache
        self.memo_cache_entries = int(memo_cache_entries)
        self.memo_cache_bytes = int(memo_cache_bytes)
        self.prefix_cache_path = prefix_cache
        self.prefix_cache_entries = int(prefix_cache_entries)
        self.prefix_cache_bytes = int(prefix_cache_bytes)
        self._prefix_cache_handle: Optional[PrefixCache] = None
        # the books of the last memoized run, for summarize_stream
        self._memo_cache_stats = {"cache_evictions": 0,
                                  "cache_evicted_bytes": 0}
        self._prefix_stats = {"prefix_evictions": 0,
                              "prefix_evicted_bytes": 0,
                              "prefix_store_entries": 0}
        self._fork_depths: List[int] = []
        # rows the last memoized run served without a lane (job -> row)
        self._memo_rows: dict = {}
        # host seconds of the last run's memo stages (plan, finalize, the
        # fast-forward watch, the prefix plan, producer and bank) and the
        # bank's rows and bytes; the bench and chip_smoke.py read them
        self.memo_timing: dict = {}
        # sync keeps markers in the split planes; exact needs the unified
        # ring for push-order delay draws
        self.kernel = TickKernel(
            self.topo, self.config, delay,
            marker_mode="split" if scheduler == "sync" else "ring",
            exact_impl=exact_impl, megatick=megatick, device=self.device,
            faults=faults, quarantine=quarantine, trace=trace,
            queue_engine=queue_engine, kernel_engine=kernel_engine,
            fused_tick=fused_tick, fused_block_edges=fused_block_edges,
            fused_tile=fused_tile)
        self.auto_layouts = bool(auto_layouts)
        self.layouts_effective = ("default(auto-unavailable)"
                                  if self.auto_layouts else "default")
        self.layouts_reason = (
            "PyTorch tensors have one layout, row-major and contiguous: "
            "no boundary layouts to choose" if self.auto_layouts
            else "auto_layouts off")
        self.queue_engine = self.kernel.queue_engine
        self.kernel_engine = self.kernel.kernel_engine
        self.megatick = self.kernel.megatick
        self.fused = self.kernel.fused
        self.fused_reason = self.kernel.fused_reason
        self.faults = faults
        self.quarantine = bool(quarantine)
        self._tokens0_total = int(self.topo.tokens0.sum())
        self._node_ids = torch.arange(self.topo.n, dtype=torch.int32,
                                      device=self.device)

    @property
    def fused_tile(self) -> str:
        """The fused megatick's layout on the card, the kernel's: "on"
        tiled into device memory, "off" resident or no kernel."""
        return self.kernel.fused_tile

    @property
    def fused_tile_reason(self) -> str:
        return self.kernel.fused_tile_reason

    def init_batch_device(self) -> DenseState:
        """A fresh batched state, built on the runner's device (with the
        adversary's per-lane keys when faults are armed)."""
        s = init_state(self.topo, self.config, self.batch, self.delay,
                       self.device)
        if self.faults is not None:
            s = s._replace(fault_key=self.faults.init_batch_state(
                self.batch, self.device))
        return s

    def storm_phase(self, s: DenseState, amounts, snaps,
                    lanes=None) -> DenseState:
        """One storm phase: bulk sends ``amounts`` [E], snapshot
        initiations at the nodes in ``snaps`` [J] (-1 = none), one tick,
        on the lanes of ``lanes`` [B] (None = every lane; the quarantine
        gate passes the unpoisoned ones, and a lane outside it is left as
        it was, its delay stream included). The exact scheduler starts one
        snapshot at a time, in schedule order; the program is shared by
        every lane, so which entries fire is a host fact."""
        s = self.kernel._bulk_send(s, amounts, lanes)
        if self.scheduler == "exact":
            for node in np.asarray(snaps).tolist():
                if node >= 0:
                    s = self.kernel._inject_snapshot(s, node, lanes)
            return self.kernel._exact_tick(s, lanes)
        init_mask = (self._node_ids.unsqueeze(0)
                     == snaps.unsqueeze(-1)).any(0)
        s = self.kernel._bulk_snapshots(s, init_mask, lanes)
        return self.kernel._sync_tick_lanes(s, lanes)

    def _check_conservation(self, s: DenseState) -> DenseState:
        delta = (lane_total_tokens(s, self.config) - self._tokens0_total
                 - s.fault_skew)
        return s._replace(error=s.error | (delta != 0).to(torch.int32)
                          * ERR_CONSERVATION)

    @staticmethod
    def _own(state: DenseState) -> DenseState:
        """A private copy of the state: the ticks write some leaves in
        place (ops/tick.py), and the caller keeps its state."""
        return DenseState(*(tuple(w.clone() for w in leaf)
                            if isinstance(leaf, tuple) else leaf.clone()
                            for leaf in state))

    def _gated_phase(self, s: DenseState, amounts, snaps) -> DenseState:
        """A storm phase behind the quarantine gate: a lane with error
        bits at the phase's start sits the whole phase out, its state
        (delay stream included) untouched (the JAX ``_quarantine_gate``).
        Without quarantine, every lane runs the phase."""
        lanes = self._quarantine_gate(s)
        if lanes is None:
            return self.storm_phase(s, amounts, snaps)
        live = int(lanes.sum())
        if not live:
            return s
        return self.storm_phase(s, amounts, snaps,
                                None if live == self.batch else lanes)

    def _run_storm_phases(self, s: DenseState, program) -> DenseState:
        amounts = torch.as_tensor(np.asarray(program[0]), dtype=torch.int32,
                                  device=self.device)
        snap = np.asarray(program[1], dtype=np.int32)
        if self.scheduler == "sync":
            snap = torch.as_tensor(snap, device=self.device)
        k = self.check_every
        for ph in range(amounts.shape[0]):
            s = self._gated_phase(s, amounts[ph], snap[ph])
            if k and (ph + 1) % k == 0:
                s = self._check_conservation(s)
        return self._check_conservation(s) if k else s

    def run_storm(self, state: DenseState, program,
                  drain: bool = True) -> DenseState:
        """Execute a StormProgram over all lanes (bulk sends + scheduled
        snapshot initiations + one tick per phase), then drain and flush
        unless ``drain=False``. ``state`` is left as it was."""
        s = self._run_storm_phases(self._own(state), program)
        return self._drain_owned(s) if drain else s

    def drain(self, state: DenseState) -> DenseState:
        """Drain + flush every lane (and the final conservation check when
        check_every is on): the tail of a storm run in chunks. ``state``
        is left as it was."""
        return self._drain_owned(self._own(state))

    def _drain_owned(self, s: DenseState) -> DenseState:
        s = self._drain_fn(s)
        return self._check_conservation(s) if self.check_every else s

    def _drain_fn(self, s: DenseState) -> DenseState:
        """Drain and flush every lane, with this runner's scheduler."""
        if self.scheduler == "exact":
            return self.kernel._drain_and_flush(s)
        return self.kernel._sync_drain_and_flush(s)

    # ---- compiled event scripts (A6) ---------------------------------------

    def _ticks(self, s: DenseState, n) -> DenseState:
        """``n`` ticks per lane (a host int or [B] counts): the exact
        multi-tick loop with its quiescence fast-forward, or ``n`` sync
        ticks."""
        if self.scheduler == "exact":
            return self.kernel._run_ticks(s, n)
        return self.kernel._sync_run_ticks(s, n)

    def _quarantine_gate(self, s: DenseState, lanes=None):
        """The lanes that run a script phase (the JAX ``_quarantine_gate``):
        ``lanes`` [B] (None = every lane), less those with error bits at
        the phase's start under quarantine. None means every lane."""
        if not self.quarantine:
            return lanes
        ok = s.error == 0
        return ok if lanes is None else lanes & ok

    def _apply_phase(self, s: DenseState, kind, arg0, arg1, do_tick,
                     lanes=None) -> DenseState:
        """One script phase on the lanes of ``lanes`` [B] (None = every
        lane): each lane's ops in order (``kind``/``arg0``/``arg1`` [B,
        K], one row per lane: the JAX ``lax.switch`` under ``vmap``, a
        nop draws nothing), then its ``do_tick`` [B] ticks. A lane
        outside ``lanes`` is left as it was."""
        kern = self.kernel
        for j in range(kind.shape[1]):
            for op in (OP_SEND, OP_SNAPSHOT):
                m = kind[:, j] == op
                if lanes is not None:
                    m = m & lanes
                count = int(m.sum())
                if not count:
                    continue
                mask = None if count == m.shape[0] else m
                if op == OP_SEND:
                    s = kern._inject_send(s, arg0[:, j], arg1[:, j], mask)
                else:
                    s = kern._inject_snapshot(s, arg0[:, j], mask)
        n = do_tick if lanes is None else torch.where(lanes, do_tick, 0)
        if bool((n != 0).any()):
            s = self._ticks(s, n)
        return s

    def _script_rows(self, script: ScriptOps, t: int):
        """Phase ``t`` of a script shared by every lane, as per-lane
        tensors."""
        b = self.batch

        def lane(x):
            return torch.as_tensor(np.asarray(x[t]), dtype=_i32,
                                   device=self.device).expand(
                (b,) + np.shape(x[t]))

        return (lane(script.kind), lane(script.arg0), lane(script.arg1),
                lane(script.do_tick))

    def run(self, state: DenseState, script: ScriptOps,
            drain: bool = True) -> DenseState:
        """The JAX ``run``: inject and tick every phase of ``script``
        (shared by every lane) behind the quarantine gate, then, unless
        ``drain=False``, drain until every lane's snapshots complete and
        flush. ``state`` is left as it was."""
        s = self._own(state)
        for t in range(int(np.shape(script.kind)[0])):
            lanes = self._quarantine_gate(s)
            if lanes is not None and not bool(lanes.any()):
                continue
            s = self._apply_phase(s, *self._script_rows(script, t), lanes)
        return self._drain_fn(s) if drain else s

    def run_ticks(self, state: DenseState, n) -> DenseState:
        """Advance every lane ``n`` ticks (a host int, or [B] counts): the
        exact multi-tick loop (megaticks and the quiescence fast-forward)
        or sync ticks. ``state`` is left as it was."""
        return self._ticks(self._own(state), n)

    # ---- the streaming job engine (A9) -----------------------------------------
    #
    # run() amortizes ONE script over B lanes, which retire together, so a
    # heavy-tailed job mix waits for each batch's slowest member.
    # run_stream() drives a QUEUE of J jobs through the B slots: each step
    # harvests retired lanes into the results ring, admits the next queued
    # jobs into the freed slots, and advances every lane a bounded stretch
    # through its own stage (script phases, drain, flush: run()'s
    # sequence). A job's row is bit-identical to the same job run alone
    # through run(), whichever lane ran it and whenever.

    def pack_jobs(self, jobs, fault_armed=None,
                  content_keys: Optional[bool] = None) -> JobPool:
        """Compile and pack J jobs (event lists or ScriptOps) into one
        pooled phase table on the runner's device (the JAX
        ``pack_jobs``). ``fault_armed`` [J] bools arms exactly those jobs
        (keys zeroed elsewhere; default all); without an adversary every
        key is 0.

        ``content_keys`` (default: on iff the runner's memo is not
        "off"): job j's stream identities are the ``init_batch_state``
        row of its content rank (the first appearance of its compiled
        script; under memo "prefix" of its first phase row) instead of
        row j, so duplicates run the same computation, and ``digest``
        holds each job's content address (under "prefix" also
        ``prefix_digest``, the phase-boundary chain). Off, the pool is
        the memo-free one: index-derived rows, zero digests."""
        scripts = [j if isinstance(j, ScriptOps)
                   else compile_events(self.topo, j) for j in jobs]
        if not scripts:
            raise ValueError("pack_jobs: empty job list")
        jcount = len(scripts)
        kmax = max(sc.kind.shape[1] for sc in scripts)
        total = sum(sc.num_phases for sc in scripts)
        kind = np.zeros((total, kmax), np.int32)
        arg0 = np.zeros((total, kmax), np.int32)
        arg1 = np.zeros((total, kmax), np.int32)
        do_tick = np.zeros(total, np.int32)
        start = np.zeros(jcount, np.int32)
        end = np.zeros(jcount, np.int32)
        limit = np.zeros(jcount, np.int32)
        row = 0
        for j, sc in enumerate(scripts):
            t, k = sc.kind.shape
            start[j], end[j] = row, row + t
            kind[row:row + t, :k] = np.asarray(sc.kind)
            arg0[row:row + t, :k] = np.asarray(sc.arg0)
            arg1[row:row + t, :k] = np.asarray(sc.arg1)
            do_tick[row:row + t] = np.asarray(sc.do_tick)
            limit[j] = int(np.sum(np.asarray(sc.do_tick))) + \
                self.config.max_ticks
            row += t
        dev = self.device
        if content_keys is None:
            content_keys = self.memo != "off"
        if content_keys:
            # content rank: the first appearance of each distinct compiled
            # script (the bytes of its op arrays)
            u_of: dict = {}
            u_index = np.zeros(jcount, np.int64)
            for j, sc in enumerate(scripts):
                key = (sc.kind.shape, np.asarray(sc.kind).tobytes(),
                       np.asarray(sc.arg0).tobytes(),
                       np.asarray(sc.arg1).tobytes(),
                       np.asarray(sc.do_tick).tobytes())
                u_index[j] = u_of.setdefault(key, len(u_of))
            ident_index, nident = u_index, len(u_of)
            if self.memo == "prefix":
                # the identity rank of the first pooled phase row, so that
                # jobs sharing a prefix share their streams (and a
                # checkpoint forks into each); duplicates share it too
                f_of: dict = {}
                ident_index = np.zeros(jcount, np.int64)
                for j in range(jcount):
                    r = int(start[j])
                    key = (kind[r].tobytes(), arg0[r].tobytes(),
                           arg1[r].tobytes(), int(do_tick[r]))
                    ident_index[j] = f_of.setdefault(key, len(f_of))
                nident = len(f_of)
            rows = torch.as_tensor(ident_index, device=dev)
        else:
            u_index, nident, rows = None, jcount, None
        if self.faults is not None:
            keys = self.faults.init_batch_state(nident, dev)
            if rows is not None:
                keys = keys[rows]
            if fault_armed is not None:
                armed = torch.as_tensor(np.asarray(fault_armed, bool),
                                        device=dev)
                keys = torch.where(armed, keys, 0)
        else:
            keys = torch.zeros(jcount, dtype=torch.int64, device=dev)
        delay_rows = self.delay.init_batch_state(nident, dev)
        prefix_digest = None
        if content_keys:
            delay_rows = tuple(w[rows] for w in delay_rows)
            digest = torch.as_tensor(self._job_digests(
                scripts, u_index, keys, delay_rows), device=dev)
            if self.memo == "prefix":
                prefix_digest = self._prefix_chains(
                    kind, arg0, arg1, do_tick, start, end, ident_index,
                    keys, delay_rows)
        else:
            digest = torch.zeros((jcount, 32), dtype=torch.uint8,
                                 device=dev)

        def put(x):
            return torch.as_tensor(x, device=dev)

        return JobPool(put(kind), put(arg0), put(arg1), put(do_tick),
                       put(start), put(end), put(limit), keys, digest,
                       delay_rows, prefix_digest)

    def _digest_identity(self):
        """The runner's execution identity as digest ingredients (the JAX
        ``_digest_identity`` over the port's knobs): every SimConfig field
        but ``trace_capacity`` (observability only), and the resolved
        knobs. The fused megatick's layout is left out: the kernel and
        its plain form give the same bits, so a digest means the same on
        the card and on the CPU."""
        cfg_fields = dataclasses.asdict(self.config)
        cfg_fields.pop("trace_capacity")
        knobs = {
            "exact_impl": self.kernel.exact_impl,
            "megatick": self.megatick,
            "check_every": self.check_every,
            "quarantine": self.quarantine,
            "delay_kind": type(self.delay).__name__,
            "faults": (None if self.faults is None
                       else sorted(vars(self.faults).items())),
        }
        return cfg_fields, knobs

    def _host_rows(self, keys, delay_rows):
        """The pool's fault keys and delay rows on the host in the JAX
        dtypes, as the digests hash them."""
        from chandy_lamport_tpu_torch.utils.carry import words_to_numpy

        return (keys.cpu().numpy().astype(np.uint32),
                words_to_numpy(delay_rows, self.delay))

    def _job_digests(self, scripts, u_index, keys, delay_rows) -> np.ndarray:
        """[J, 32] content addresses (the JAX ``_job_digests``):
        utils/memocache.job_digest over the topology, the job's compiled
        script, its fault key and delay row, the scheduler and the
        runner's identity. A (content rank, key) pair hashes once."""
        cfg_fields, knobs = self._digest_identity()
        keys, leaves = self._host_rows(keys, delay_rows)
        treedef = _delay_treedef(len(leaves),
                                 getattr(self.delay, "bare_leaf", False))
        out = np.zeros((len(scripts), 32), np.uint8)
        seen: dict = {}
        for j, sc in enumerate(scripts):
            memo_key = (int(u_index[j]), int(keys[j]))
            hx = seen.get(memo_key)
            if hx is None:
                hx = job_digest(
                    topo_spec=self._topo_spec,
                    script=(np.asarray(sc.kind), np.asarray(sc.arg0),
                            np.asarray(sc.arg1), np.asarray(sc.do_tick)),
                    fault_key=int(keys[j]),
                    delay_row={"treedef": treedef,
                               "leaves": [lv[j] for lv in leaves]},
                    scheduler=self.scheduler, knobs=knobs,
                    config_fields=cfg_fields)
                seen[memo_key] = hx
            out[j] = np.frombuffer(bytes.fromhex(hx), np.uint8)
        return out

    def _prefix_chains(self, kind, arg0, arg1, do_tick, start, end,
                       ident_index, keys, delay_rows) -> np.ndarray:
        """[P, 32] phase-boundary digest chains (the JAX
        ``_prefix_chains``): per job, link 0 is
        utils/memocache.prefix_seed_digest of its script-free identity,
        and each pooled phase row extends it (prefix_extend), written at
        its row. Seeds are shared by (identity rank, key)."""
        cfg_fields, knobs = self._digest_identity()
        keys, leaves = self._host_rows(keys, delay_rows)
        treedef = _delay_treedef(len(leaves),
                                 getattr(self.delay, "bare_leaf", False))
        out = np.zeros((kind.shape[0], 32), np.uint8)
        seeds: dict = {}
        for j in range(len(start)):
            seed_key = (int(ident_index[j]), int(keys[j]))
            c = seeds.get(seed_key)
            if c is None:
                c = prefix_seed_digest(
                    topo_spec=self._topo_spec, fault_key=int(keys[j]),
                    delay_row={"treedef": treedef,
                               "leaves": [lv[j] for lv in leaves]},
                    scheduler=self.scheduler, knobs=knobs,
                    config_fields=cfg_fields)
                seeds[seed_key] = c
            for r in range(int(start[j]), int(end[j])):
                c = prefix_extend(
                    c, (kind[r], arg0[r], arg1[r], int(do_tick[r])))
                out[r] = np.frombuffer(c, np.uint8)
        return out

    def init_stream(self, pool: JobPool,
                    results_capacity: Optional[int] = None,
                    tenants: int = 1, tenant_quota=None) -> StreamState:
        """A fresh stream carry for ``pool``: zero counters and an empty
        results ring of ``results_capacity`` slots (default one per job;
        a smaller ring wraps, keeping the newest rows). ``tenants`` and
        ``tenant_quota`` (one cap per tenant; default zeros) size the
        serving books; a plain stream keeps one zero tenant."""
        r = int(results_capacity) if results_capacity else pool.num_jobs
        if r < 1:
            raise ValueError("results_capacity must be >= 1")
        t = max(1, int(tenants))
        quota = (np.zeros(t, np.int32) if tenant_quota is None
                 else np.asarray(tenant_quota, np.int32))
        if quota.shape != (t,):
            raise ValueError(
                f"tenant_quota must be one cap per tenant ([{t}]), "
                f"got shape {quota.shape}")

        def z(*shape):
            return torch.zeros(shape, dtype=_i32, device=self.device)

        return StreamState(
            next_job=z(), jobs_done=z(), steps=z(), refills=z(),
            lane_steps_live=z(), lane_steps_total=z(), cache_hits=z(),
            coalesced_jobs=z(), ff_skipped_ticks=z(), shadow_checks=z(),
            prefix_hits=z(), forked_jobs=z(), fork_depth_sum=z(),
            deadline_misses=z(), tenant_served=z(t),
            tenant_quota=torch.as_tensor(quota, device=self.device),
            res_count=z(),
            res_job=torch.full((r,), -1, dtype=_i32, device=self.device),
            res_time=z(r), res_error=z(r), res_snap_started=z(r),
            res_snap_completed=z(r), res_snap_failed=z(r),
            res_fault_skew=z(r), res_fault_events=z(r),
            res_admit_step=z(r), res_tokens=z(r, self.topo.n))

    def _lane_template(self) -> DenseState:
        """One lane of a fresh state (``reset_lanes``' template), built
        once on the runner's device."""
        if getattr(self, "_template", None) is None:
            self._template = init_state(self.topo, self.config, 1,
                                        self.delay, self.device)
        return self._template

    def _stage_of(self, s: DenseState, pool: JobPool):
        """[B] each lane's stage (the JAX ``stage_of``): 1 in its script,
        2 draining, 3 flushing, 0 idle or retired (or errored, under
        quarantine). ``prog_cursor`` encodes it: rows [start, end) are
        the script, end the drain, end + 1 the flush, end + 2 retired."""
        jmax = pool.num_jobs - 1
        end = pool.job_end[s.job_id.clamp(0, jmax).long()]
        run = s.job_id >= 0
        if self.quarantine:
            run = run & (s.error == 0)
        cur = s.prog_cursor
        stage = torch.zeros_like(cur)
        stage = torch.where(run & (cur < end), 1, stage)
        stage = torch.where(run & (cur == end), 2, stage)
        return torch.where(run & (cur == end + 1), 3, stage)

    def _lane_pass(self, s: DenseState, pool: JobPool, stretch: int,
                   drain_chunk: int, memo: str = "off") -> DenseState:
        """Every lane's pass through its stage (the JAX ``lane_pass``):
        ``stretch`` script substeps (one pooled phase each), then one
        drain slice of ``drain_chunk`` conditional ticks against each
        job's absolute limit, then one flush pass. A lane that ends its
        script in a substep drains in the same step, and one that ends
        its drain in the slice flushes in the same step: the stage is
        read again before each pass. Under memo "full" every lane's
        ``sig`` is then refreshed (``_lane_signature``)."""
        kern = self.kernel
        last = pool.kind.shape[0] - 1
        for _ in range(stretch):
            m = self._stage_of(s, pool) == 1
            if not bool(m.any()):
                break
            c = s.prog_cursor.clamp(0, last).long()
            s = self._apply_phase(s, pool.kind[c], pool.arg0[c],
                                  pool.arg1[c], pool.do_tick[c], m)
            s = s._replace(prog_cursor=s.prog_cursor + m.to(_i32))
        folds = kern.fold_steps
        in_drain = self._stage_of(s, pool) == 2
        limit = pool.job_limit[s.job_id.clamp(0, pool.num_jobs - 1)
                               .long()].contiguous()
        if bool(in_drain.any()):
            s = kern._stream_drain(s, in_drain, limit, drain_chunk)
        done = in_drain & ~kern._stream_more(s, in_drain, limit)
        blown = kern._pending(s)
        if self.quarantine:
            blown = blown & (s.error == 0)
        s = s._replace(
            error=s.error | (done & blown).to(_i32) * ERR_TICK_LIMIT,
            prog_cursor=s.prog_cursor + done.to(_i32))
        flush = self._stage_of(s, pool) == 3
        if bool(flush.any()):
            s = kern._stream_flush(s, flush)
            s = s._replace(prog_cursor=s.prog_cursor + flush.to(_i32))
        kern.drain_fold_steps += kern.fold_steps - folds
        if memo == "full":
            s = s._replace(sig=_lane_signature(s, self.delay))
        return s

    def _lane_event(self, s: DenseState, mask, kind: int, payload):
        """One lane event on each lane of ``mask`` (the recorder's
        append gathers its slots with ``nonzero``, a host sync: the
        ``stream-recorder`` site of utils/guards)."""
        with host_sync("stream-recorder"):
            return trace_append_lanes(s, mask, kind, payload)

    def _stream_step(self, s: DenseState, st: StreamState, pool: JobPool,
                     stretch: int, drain_chunk: int, gang: bool,
                     memo: Optional[str] = None, order=None,
                     followers=None, bank=None, fork_src=None,
                     fork_depth=None, *, serve: bool = False, limit=None,
                     tenant_of=None, arrival_of=None, deadline_of=None):
        """One streaming step (the JAX ``_build_stream_step``), in the JAX
        order: harvest retired lanes into the results ring, admit queued
        jobs into the freed slots (``reset_lanes``, then the pool's rows),
        the occupancy books, then every lane's ``_lane_pass``. Returns
        (state, stream).

        ``memo`` (default: the runner's): with it on, admission walks the
        exec order ``order`` [U] (pool job ids: one leader per digest and
        the shadow runs) rather than the pool, and ``followers`` [U]
        counts the duplicates each position's leader serves (the
        recorder's EV_LANE_COALESCE). Under "prefix" an admitted job
        whose ``fork_src`` [J] row is >= 0 takes that row of ``bank`` (a
        ``DenseState`` of checkpointed prefix states, ``fork_lanes``) and
        starts ``fork_depth`` [J] phases into its script (EV_PREFIX_FORK),
        counted in ``forked_jobs`` and ``fork_depth_sum``.

        ``serve`` (serving/server.py; the JAX ``serve=True`` step):
        admission walks the exec order ``order`` [U] only up to ``limit``
        (a 0-d tensor or an int: the positions the server marked
        admissible this step), whatever ``memo`` is (memo "prefix" still
        forks). At harvest a lane past its job's ``deadline_of`` [J] step
        counts in ``deadline_misses`` (EV_SERVE_MISS with the lateness),
        and each harvested lane adds one to its job's tenant
        (``tenant_of`` [J]) in ``tenant_served``; an idle lane charges
        nothing. An admitted lane records its wait since ``arrival_of``
        [J] (EV_SERVE_ADMIT)."""
        memo = self.memo if memo is None else memo
        b, jcount = self.batch, pool.num_jobs
        jmax = jcount - 1
        rcap = st.res_job.shape[0]
        # -- harvest: retired lanes into the results ring
        jid = s.job_id
        has_job = jid >= 0
        fin = has_job & (s.prog_cursor
                         >= pool.job_end[jid.clamp(0, jmax).long()] + 2)
        if self.quarantine:
            # a poisoned lane is frozen for good: retire it with its bits
            fin = fin | (has_job & (s.error != 0))
        h = harvest_lane_summaries(s, self.topo.n)
        nfin = fin.sum(dtype=_i32)
        rank = torch.cumsum(fin.to(_i32), 0, dtype=_i32) - 1
        # the ring's slot of each retiring lane; the others aim at a spare
        # row R that is cut off (the JAX scatter's out-of-range drop). A
        # step retiring more lanes than R slots keeps its newest R
        keep = fin & (rank >= nfin - rcap)
        widx = torch.where(keep, (st.res_count + rank) % rcap, rcap).long()
        if serve:
            # the serving books: a lane harvested past its job's deadline
            # is a miss; each harvested lane charges its job's tenant (the
            # clipped index masked to a spare row, so an idle lane
            # charges nothing)
            jc = jid.clamp(0, jmax).long()
            tcap = st.tenant_served.shape[0]
            late = st.steps - deadline_of[jc]
            missed = fin & (late > 0)
            t_of = torch.where(fin, tenant_of[jc].clamp(0, tcap - 1),
                               tcap).long()
            served = torch.zeros(tcap + 1, dtype=_i32, device=self.device)
            served.index_add_(0, t_of, torch.ones_like(jid))
            st = st._replace(
                deadline_misses=st.deadline_misses + missed.sum(dtype=_i32),
                tenant_served=st.tenant_served + served[:tcap])
            if self.kernel._trace_on:
                s = self._lane_event(s, missed, EV_SERVE_MISS,
                                     late.clamp(min=0))
        if self.kernel._trace_on:
            # before the reset: the ring spans the lane's jobs
            # (_RESET_KEEP), so the harvest survives it
            s = self._lane_event(s, fin, EV_LANE_HARVEST, jid)

        def put(ring, vals):
            spare = torch.cat([ring, ring[:1]])
            spare.index_copy_(0, widx, vals.to(ring.dtype))
            return spare[:rcap]

        st = st._replace(
            res_job=put(st.res_job, jid),
            res_time=put(st.res_time, h["time"]),
            res_error=put(st.res_error, h["error"]),
            res_snap_started=put(st.res_snap_started, h["snap_started"]),
            res_snap_completed=put(st.res_snap_completed,
                                   h["snap_completed"]),
            res_snap_failed=put(st.res_snap_failed, h["snap_failed"]),
            res_fault_skew=put(st.res_fault_skew, h["fault_skew"]),
            res_fault_events=put(st.res_fault_events, h["fault_events"]),
            res_admit_step=put(st.res_admit_step, s.admit_tick),
            res_tokens=put(st.res_tokens, h["tokens"]),
            res_count=st.res_count + nfin,
            jobs_done=st.jobs_done + nfin)
        # -- admit: reset the freed slots, copy in the jobs' identities
        idle = fin | ~has_job
        arank = torch.cumsum(idle.to(_i32), 0, dtype=_i32) - 1
        if serve:
            # serving admission: the exec order walked only up to the
            # host's admissible prefix ``limit``
            uexec = order.shape[0]
            cap = (limit.clamp(max=uexec) if torch.is_tensor(limit)
                   else min(int(limit), uexec))
            admit = idle & (arank < (cap - st.next_job).clamp(min=0))
        elif memo == "off":
            admit = idle & (arank < jcount - st.next_job)
        else:
            # memoized admission: next_job walks the exec order, and the
            # pool row admitted is order[pos]
            uexec = order.shape[0]
            admit = idle & (arank < uexec - st.next_job)
        if gang:
            # gang admission, the static-batching baseline on the same
            # engine: refill only when every lane is idle
            admit = admit & idle.all()
        if memo == "off" and not serve:
            new_jid = st.next_job + arank
        else:
            epos = (st.next_job + arank).clamp(0, max(uexec - 1, 0)).long()
            new_jid = torch.where(admit, order[epos], -1)
        pick_at = new_jid.clamp(0, jmax).long()
        reset = fin | admit
        s = reset_lanes(s, reset, self._lane_template())

        def pick(rows, old):
            # admitted: the job's row (a gathered copy, never a view of
            # the pool); reset but idle: zeros; otherwise untouched
            shape = admit.shape + (1,) * (old.dim() - 1)
            return torch.where(admit.reshape(shape), rows[pick_at],
                               torch.where(reset.reshape(shape), 0, old))

        s = s._replace(
            delay_state=tuple(pick(p, old) for p, old in zip(
                pool.delay_state, s.delay_state)),
            fault_key=pick(pool.fault_key, s.fault_key),
            job_id=torch.where(admit, new_jid, torch.where(fin, -1, jid)),
            prog_cursor=torch.where(admit, pool.job_start[pick_at],
                                    torch.where(reset, 0, s.prog_cursor)),
            admit_tick=torch.where(admit, st.steps,
                                   torch.where(reset, 0, s.admit_tick)))
        if memo == "prefix":
            # the fork: an admitted job the plan mapped to a bank row takes
            # the checkpointed state (delay words included) and resumes at
            # the divergence cursor
            fsrc = fork_src[pick_at]
            fdep = fork_depth[pick_at]
            is_fork = admit & (fsrc >= 0)
            fmax = bank.time.shape[0] - 1
            s = fork_lanes(s, is_fork, bank, fsrc.clamp(0, fmax))
            s = s._replace(prog_cursor=torch.where(
                is_fork, pool.job_start[pick_at] + fdep, s.prog_cursor))
            st = st._replace(
                forked_jobs=st.forked_jobs + is_fork.sum(dtype=_i32),
                fork_depth_sum=st.fork_depth_sum
                + torch.where(is_fork, fdep, 0).sum(dtype=_i32))
            if self.kernel._trace_on:
                s = self._lane_event(s, is_fork, EV_PREFIX_FORK, fdep)
        if self.kernel._trace_on:
            s = self._lane_event(s, admit, EV_LANE_ADMIT, new_jid)
        if self.kernel._trace_on and serve:
            # the admit wait in stream steps (arrival to admission)
            s = self._lane_event(
                s, admit, EV_SERVE_ADMIT,
                (st.steps - arrival_of[pick_at]).clamp(min=0))
        if self.kernel._trace_on and memo != "off" \
                and followers is not None:
            fcnt = followers[epos]
            s = self._lane_event(s, admit & (fcnt > 0), EV_LANE_COALESCE,
                                 fcnt)
        st = st._replace(
            next_job=st.next_job + admit.sum(dtype=_i32),
            refills=st.refills + (admit & fin).sum(dtype=_i32))
        # -- the books: a lane is live this step iff it holds a job after
        # admission; the denominator charges the whole batch whenever any
        # lane is live
        live = (s.job_id >= 0).sum(dtype=_i32)
        st = st._replace(
            steps=st.steps + 1, lane_steps_live=st.lane_steps_live + live,
            lane_steps_total=st.lane_steps_total
            + torch.where(live > 0, b, 0).to(_i32))
        # -- advance: host-driven (the stage gates, the exact tick's folds,
        # the drain's megatick gates read the card), the stream-lane-pass
        # site of utils/guards
        with host_sync("stream-lane-pass"):
            return self._lane_pass(s, pool, stretch, drain_chunk, memo), st

    # ---- the memo plane (A9b): fast-forward, plan, finalize ------------------

    def _ff_apply(self, s: DenseState, st: StreamState, skips):
        """The fast-forward credit (the JAX ``_ff_step``): add ``skips``
        [B] ticks to the clock of each lane the device finds eligible —
        no armed adversary (its stream is indexed by time), no message in
        flight in either queue plane, no armed supervisor deadline, no
        error — so every tick skipped is provably ``time += 1``; stamp
        EV_MEMO_HIT with the ticks skipped and book them in
        ``ff_skipped_ticks``."""
        eligible = ((s.fault_key == 0) & (s.error == 0)
                    & ~(s.q_len > 0).any(-1)
                    & ~s.m_pending.flatten(1).any(-1))
        if self.config.snapshot_timeout > 0:
            eligible = eligible & ~(s.snap_deadline > 0).any(-1)
        skip = torch.where(eligible, skips, 0).to(_i32)
        s = s._replace(time=s.time + skip)
        if self.kernel._trace_on:
            s = trace_append_lanes(s, skip > 0, EV_MEMO_HIT, skip)
        return s, st._replace(
            ff_skipped_ticks=st.ff_skipped_ticks + skip.sum(dtype=_i32))

    def _ff_host(self, s: DenseState, st: StreamState, watch: dict):
        """The host half of fast-forwarding (the JAX ``_ff_host``, memo
        "full"): watch each draining lane's (job, cursor, signature)
        across steps. A recurrence at the same drain cursor with the
        clock advanced means the lane's semantic state is a fixed point
        of the tick, so the wait to its tick limit is credited at once:
        whole multiples of the observed period, stopping short of the
        limit so the ERR_TICK_LIMIT edge replays tick-exactly. The four
        [B] leaves come to the host in one copy, and the watch over the
        lanes is numpy. ``watch`` holds the job tables and the last
        sighting of every lane, across steps; a lane out of its drain
        drops out of it."""
        t0 = time.perf_counter()
        jid, cur, sig, tnow = torch.stack(
            [s.job_id.long(), s.prog_cursor.long(), s.sig,
             s.time.long()]).cpu().numpy()
        jc = np.clip(jid, 0, watch["jend"].shape[0] - 1)
        valid = (jid >= 0) & (cur == watch["jend"][jc])
        skips = np.zeros(jid.shape[0], np.int64)
        prev = watch.get("prev")
        if prev is not None:
            pv, pj, pc, ps, pt = prev
            same = (valid & pv & (pj == jid) & (pc == cur) & (ps == sig)
                    & (tnow > pt))
            dt = np.where(same, tnow - pt, 1)
            k = (watch["jlim"][jc] - tnow - 1) // dt
            skips = np.where(same & (k > 0), k * dt, 0)
        watch["prev"] = (valid, jid, cur, sig, tnow)
        if skips.any():
            s, st = self._ff_apply(
                s, st, torch.as_tensor(skips, device=self.device))
        self.memo_timing["ff_watch_s"] = (
            self.memo_timing.get("ff_watch_s", 0.0)
            + time.perf_counter() - t0)
        return s, st

    def _summary_cache(self) -> SummaryCache:
        """The runner's summary cache, opened with its LRU bounds."""
        return SummaryCache(self.memo_cache_path,
                            max_entries=self.memo_cache_entries,
                            max_bytes=self.memo_cache_bytes)

    def _memo_plan(self, pool: JobPool, shadow_every: Optional[int]) -> dict:
        """The admission plan of a memoized run (the JAX ``_memo_plan``):
        each pool job by digest is a leader (runs on a lane), a coalesced
        follower (served from its leader's row) or a summary-cache hit
        (served without a lane); every ``shadow_every``-th served job
        also runs alone, for the audit. A pure function of the pool and
        the cache file, which changes only when a run ends, so a killed
        run replans identically on resume."""
        digests = [_hex(row) for row in pool.digest.cpu().numpy()]
        if pool.num_jobs and all(d == "0" * 64 for d in digests):
            raise ValueError(
                "memo != 'off' needs a content-addressed pool — pack_jobs "
                "on a memo-enabled runner (or content_keys=True) stamps "
                "the job digests")
        cache = self._summary_cache()
        se = MEMO_SHADOW_EVERY if shadow_every is None else int(shadow_every)
        leader: dict = {}      # digest -> ("exec", job) | ("cache", summary)
        exec_jobs: List[int] = []  # pool job ids in admission order
        fcounts: dict = {}         # exec job -> coalesced followers
        served: List[tuple] = []   # (job, "cache"|"coalesce", digest, ref)
        shadows: set = set()
        nserved = 0

        def maybe_shadow(j):
            nonlocal nserved
            nserved += 1
            if se and (nserved - 1) % se == 0:
                shadows.add(j)
                exec_jobs.append(j)
                fcounts.setdefault(j, 0)

        for j, dg in enumerate(digests):
            led = leader.get(dg)
            if led is None:
                hit = cache.get(dg)
                if hit is not None:
                    leader[dg] = ("cache", dict(hit))
                    served.append((j, "cache", dg, dict(hit)))
                    maybe_shadow(j)
                else:
                    leader[dg] = ("exec", j)
                    exec_jobs.append(j)
                    fcounts[j] = 0
            else:
                kind, ref = led
                if kind == "exec":
                    fcounts[ref] += 1
                    served.append((j, "coalesce", dg, ref))
                else:
                    served.append((j, "cache", dg, dict(ref)))
                maybe_shadow(j)
        return {"digests": digests, "cache": cache, "exec": exec_jobs,
                "follower_counts": [fcounts[e] for e in exec_jobs],
                "served": served, "shadows": shadows}

    @staticmethod
    def _summary_of(row: dict) -> dict:
        return {k: v for k, v in row.items()
                if k not in ("job", "admit_step")}

    def _memo_finalize(self, s: DenseState, st: StreamState, plan: dict):
        """After the exec order drained (the JAX ``_memo_finalize``): the
        leaders' rows go into the summary cache (one atomic flush), every
        served row is made with its provenance (``digest``,
        ``served_from``, ``admit_step`` -1), the shadow runs are held to
        their served rows (MemoCacheError on any difference) and the
        memo counters set."""
        ring = {r["job"]: r for r in _ring_rows(st)}
        cache = plan["cache"]
        digests = plan["digests"]
        for e in plan["exec"]:
            r = ring.get(e)
            if r is not None:
                cache.put(digests[e], self._summary_of(r))
        nshadow = 0
        for j, src, dg, ref in plan["served"]:
            if src == "cache":
                summ = dict(ref)
            else:
                r = ring.get(ref)
                if r is None:
                    # the leader's row left an undersized results ring:
                    # the follower cannot be served
                    continue
                summ = self._summary_of(r)
            if j in plan["shadows"]:
                solo = ring.get(j)
                if solo is not None:
                    nshadow += 1
                    if self._summary_of(solo) != summ:
                        raise MemoCacheError(
                            f"shadow re-execution of job {j} (digest {dg}) "
                            f"disagrees with its served summary — the "
                            f"memoized result is not bit-exact; refusing "
                            f"to serve it")
            row = dict(summ)
            row["job"] = j
            row["admit_step"] = -1
            row["digest"] = dg
            row["served_from"] = src
            self._memo_rows[j] = row
        cache.flush()
        self._memo_cache_stats = {"cache_evictions": cache.evictions,
                                  "cache_evicted_bytes": cache.evicted_bytes}
        ncache = sum(1 for it in plan["served"] if it[1] == "cache")
        ncoal = sum(1 for it in plan["served"] if it[1] == "coalesce")

        def put(v):
            return torch.tensor(v, dtype=_i32, device=self.device)

        return s, st._replace(cache_hits=put(ncache),
                              coalesced_jobs=put(ncoal),
                              shadow_checks=put(nshadow))

    # ---- memo "prefix": the fork from checkpointed prefixes -------------------

    def _prefix_cache(self) -> PrefixCache:
        """The prefix store a run plans against: with a file, a fresh
        handle per run (so checkpoints other processes flushed count);
        without, one in-memory store per runner, across runs."""
        if self.prefix_cache_path is not None:
            return PrefixCache(self.prefix_cache_path,
                               max_entries=self.prefix_cache_entries,
                               max_bytes=self.prefix_cache_bytes)
        if self._prefix_cache_handle is None:
            self._prefix_cache_handle = PrefixCache(
                None, max_entries=self.prefix_cache_entries,
                max_bytes=self.prefix_cache_bytes)
        return self._prefix_cache_handle

    def _prefix_produce(self, pool: JobPool, cands,
                        pcache: PrefixCache) -> None:
        """Run every candidate prefix cold and checkpoint its boundary
        state (the JAX ``_prefix_produce``), ``batch`` candidates a
        chunk: a producer lane is a stream lane at admission (a fresh
        lane, the job's fault key and delay row, its start cursor) that
        runs its script rows through ``_apply_phase`` up to its stop
        cursor and never drains. The captured leaves are every field
        outside ``_PREFIX_KEEP_LEAVES``, in the JAX dtypes. ``cands``:
        (digest hex, job, depth) triples."""
        from chandy_lamport_tpu_torch.utils.carry import state_to_numpy

        if not cands:
            return
        b, dev = self.batch, self.device
        capture = [f for f in DenseState._fields
                   if f not in _PREFIX_KEEP_LEAVES and f != "delay_state"]
        last = pool.kind.shape[0] - 1
        for lo in range(0, len(cands), b):
            chunk = cands[lo:lo + b]
            pad = b - len(chunk)
            idx = torch.as_tensor([j for _, j, _ in chunk]
                                  + [chunk[-1][1]] * pad, device=dev)
            deps = torch.as_tensor([d for _, _, d in chunk] + [0] * pad,
                                   dtype=_i32, device=dev)
            u = self.init_batch_device()
            u = u._replace(
                delay_state=tuple(w[idx] for w in pool.delay_state),
                fault_key=pool.fault_key[idx].to(u.fault_key.dtype),
                prog_cursor=pool.job_start[idx].to(_i32),
                job_id=idx.to(_i32))
            stop = pool.job_start[idx] + deps
            for _ in range(int(deps.max())):
                m = u.prog_cursor < stop
                c = u.prog_cursor.clamp(0, last).long()
                # the JAX _apply_phase's own quarantine gate; the cursor
                # moves on either way
                u = self._apply_phase(u, pool.kind[c], pool.arg0[c],
                                      pool.arg1[c], pool.do_tick[c],
                                      self._quarantine_gate(u, m))
                u = u._replace(prog_cursor=u.prog_cursor + m.to(_i32))
            n = len(chunk)
            host = state_to_numpy(DenseState(*(
                tuple(w[:n] for w in leaf) if isinstance(leaf, tuple)
                else leaf[:n] for leaf in u)), self.delay)
            for i, (dg, _j, d) in enumerate(chunk):
                leaves = {f: getattr(host, f)[i] for f in capture}
                leaves["delay_state"] = tuple(w[i] for w in host.delay_state)
                pcache.put_ckpt(dg, int(d), leaves)

    def _prefix_plan(self, pool: JobPool, plan: dict,
                     shadow_every: Optional[int]) -> dict:
        """The fork plan over ``_memo_plan``'s exec order (the JAX
        ``_prefix_plan``): for each leader the deepest phase boundary
        whose chain digest has a checkpoint, or is hot enough to produce
        one now (two leaders cross it in this run, or an earlier run
        counted it as seen); the producer runs the chosen boundaries;
        every fork source is decoded through the store's codec into a
        bank of a power-of-two rows on the device; ``fork_src`` /
        ``fork_depth`` per job (-1: cold). Boundaries crossed without a
        checkpoint are counted as seen, for the next run."""
        from chandy_lamport_tpu_torch.utils.carry import (
            state_from_numpy,
            state_to_numpy,
        )

        if pool.prefix_digest is None:
            raise ValueError(
                "memo='prefix' needs a prefix-chained pool — pack_jobs on "
                "the prefix runner (content_keys on) stamps the "
                "phase-boundary digest chain")
        t0 = time.perf_counter()
        chains = np.asarray(pool.prefix_digest)
        starts = pool.job_start.cpu().numpy()
        ends = pool.job_end.cpu().numpy()
        pcache = self._prefix_cache()
        exec_jobs = plan["exec"]
        shadows = plan["shadows"]
        leaders = [j for j in exec_jobs if j not in shadows]

        def chex(j, d):
            return _hex(chains[int(starts[j]) + d - 1])

        counts: dict = {}
        for j in leaders:
            for d in range(1, int(ends[j] - starts[j]) + 1):
                dg = chex(j, d)
                counts[dg] = counts.get(dg, 0) + 1
        fork_of: dict = {}    # leader job -> (digest hex, depth)
        produce: dict = {}    # digest hex -> (job, depth) to produce
        for j in leaders:
            for d in range(int(ends[j] - starts[j]), 0, -1):
                dg = chex(j, d)
                if pcache.has_ckpt(dg) or dg in produce:
                    fork_of[j] = (dg, d)
                    break
                if counts.get(dg, 0) >= 2 or pcache.seen(dg) >= 1:
                    # the first leader through seeds the checkpoint and
                    # forks from it itself: the prefix runs once either way
                    produce[dg] = (j, d)
                    fork_of[j] = (dg, d)
                    break
        bumped: set = set()
        for j in leaders:
            for d in range(1, int(ends[j] - starts[j]) + 1):
                dg = chex(j, d)
                if dg not in bumped and dg not in produce \
                        and not pcache.has_ckpt(dg):
                    bumped.add(dg)
                    pcache.bump_seen(dg, d)
        self.memo_timing["prefix_plan_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._prefix_produce(
            pool, [(dg, j, d) for dg, (j, d) in produce.items()], pcache)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.memo_timing["prefix_produce_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lane0 = state_to_numpy(self._lane_template(), self.delay)
        lane0 = DenseState(*(tuple(w[0] for w in leaf)
                             if isinstance(leaf, tuple) else leaf[0]
                             for leaf in lane0))
        rows: List[DenseState] = []
        bank_index: dict = {}
        fork_src = np.full(pool.num_jobs, -1, np.int32)
        fork_depth = np.zeros(pool.num_jobs, np.int32)
        for j in exec_jobs:
            if j in shadows or j not in fork_of:
                continue
            dg, d = fork_of[j]
            ri = bank_index.get(dg)
            if ri is None:
                got = pcache.get_ckpt(dg)
                if got is None:
                    # produced, then evicted under a tight bound: this
                    # leader falls back to a cold admission
                    del fork_of[j]
                    continue
                depth, leaves = got
                if int(depth) != int(d):
                    raise PrefixCacheError(
                        f"prefix cache entry {dg[:12]}… claims depth "
                        f"{int(depth)} but the pool's chain puts this "
                        f"digest at depth {int(d)} — refusing the fork")
                row = lane0._replace(delay_state=tuple(
                    leaves.pop("delay_state")), **leaves)
                for name, want, got_leaf in zip(DenseState._fields, lane0,
                                                row):
                    for w, g in zip(
                            want if isinstance(want, tuple) else (want,),
                            got_leaf if isinstance(got_leaf, tuple)
                            else (got_leaf,)):
                        if (np.shape(w) != np.shape(g)
                                or np.asarray(g).dtype != w.dtype):
                            raise PrefixCacheError(
                                f"prefix cache entry {dg[:12]}…: leaf "
                                f"{name} is {np.asarray(g).dtype}"
                                f"{list(np.shape(g))}, this runner's is "
                                f"{w.dtype}{list(np.shape(w))} — refusing "
                                f"the fork")
                ri = len(rows)
                rows.append(row)
                bank_index[dg] = ri
            fork_src[j] = ri
            fork_depth[j] = d
        se = (MEMO_SHADOW_EVERY if shadow_every is None
              else int(shadow_every))
        forked = [j for j in exec_jobs if j in fork_of and j not in shadows]
        fork_shadows = ([j for k, j in enumerate(forked) if k % se == 0]
                        if se else [])
        self._fork_depths = [int(fork_of[j][1]) for j in forked]
        nbank = 1 << ((len(rows) - 1).bit_length() if rows else 0)
        rows += [lane0] * (nbank - len(rows))
        bank = state_from_numpy(DenseState(*(
            tuple(np.stack(ws) for ws in zip(*leaves))
            if isinstance(leaves[0], tuple) else np.stack(leaves)
            for leaves in zip(*rows))), self.device)
        self.memo_timing.update(
            prefix_bank_s=time.perf_counter() - t0, prefix_bank_rows=nbank,
            prefix_bank_bytes=sum(
                sum(w.numel() * w.element_size() for w in leaf)
                if isinstance(leaf, tuple)
                else leaf.numel() * leaf.element_size() for leaf in bank),
            prefix_produced=len(produce))
        dev = self.device
        return {"cache": pcache, "fork_of": fork_of,
                "fork_shadows": fork_shadows, "produced": sorted(produce),
                "bank": bank,
                "fork_src": torch.as_tensor(fork_src, device=dev),
                "fork_depth": torch.as_tensor(fork_depth, device=dev)}

    def _run_cold_jobs(self, pool: JobPool, js, stretch: int,
                       drain_chunk: int) -> dict:
        """The audited forked jobs run cold together (the JAX
        ``_run_cold_jobs``): a sub-pool of exactly those jobs (the full
        phase table, so cursors address the same rows) through the
        memo-off stream step in one multi-lane run. A job's row does not
        depend on its lane, so this equals each run alone. Returns {job:
        row} by pool job id."""
        idx = np.asarray([int(j) for j in js], np.int64)
        it = torch.as_tensor(idx, device=self.device)
        sub = pool._replace(
            job_start=pool.job_start[it], job_end=pool.job_end[it],
            job_limit=pool.job_limit[it], fault_key=pool.fault_key[it],
            digest=torch.zeros((len(idx), 32), dtype=torch.uint8,
                               device=self.device),
            delay_state=tuple(w[it] for w in pool.delay_state),
            prefix_digest=None)
        s, st = self.init_batch_device(), self.init_stream(sub)
        for _ in range(1_000_000):
            s, st = self._stream_step(s, st, sub, stretch, drain_chunk,
                                      False, memo="off")
            if int(st.jobs_done) >= len(idx):
                break
        else:
            raise RuntimeError(
                f"cold re-execution of jobs {list(js)} failed to retire")
        return {int(idx[r["job"]]): dict(r, job=int(idx[r["job"]]))
                for r in _ring_rows(st)}

    def _prefix_finalize(self, s: DenseState, st: StreamState, plan: dict,
                         pplan: dict, pool: JobPool, stretch: int,
                         drain_chunk: int):
        """After ``_memo_finalize`` (the JAX ``_prefix_finalize``): the
        fork audit (the chosen forked leaders re-run cold together, each
        row held to its forked one: PrefixCacheError on any difference),
        the forked rows' provenance (``served_from="prefix:<depth>"``),
        the store's flush and the prefix books; ``prefix_hits`` (planned
        forks) equals ``forked_jobs`` (made) on a finished run."""
        ring = {r["job"]: r for r in _ring_rows(st)}
        digests = plan["digests"]
        audited = [j for j in pplan["fork_shadows"] if j in ring]
        self.memo_timing["fork_audits"] = len(audited)
        cold_rows = (self._run_cold_jobs(pool, audited, stretch,
                                         drain_chunk) if audited else {})
        for j in audited:
            dg, d = pplan["fork_of"][j]
            cold = cold_rows.get(j)
            if cold is None or (self._summary_of(cold)
                                != self._summary_of(ring[j])):
                raise PrefixCacheError(
                    f"fork shadow: job {j}, forked at depth {d} from "
                    f"prefix {dg[:12]}…, disagrees with its cold "
                    f"re-execution — the checkpointed prefix is not "
                    f"bit-exact; refusing to serve forks from it")
        for j, (dg, d) in pplan["fork_of"].items():
            r = ring.get(j)
            if r is None:
                continue
            row = dict(r)
            row["digest"] = digests[j]
            row["served_from"] = f"prefix:{d}"
            self._memo_rows[j] = row
        pcache = pplan["cache"]
        pcache.flush()
        self._prefix_stats = {
            "prefix_evictions": pcache.evictions,
            "prefix_evicted_bytes": pcache.evicted_bytes,
            "prefix_store_entries": len(pcache)}
        return s, st._replace(
            prefix_hits=torch.tensor(len(pplan["fork_of"]), dtype=_i32,
                                     device=self.device),
            shadow_checks=st.shadow_checks + len(audited))

    def run_stream(self, jobs, *, stretch: int = 4, drain_chunk: int = 32,
                   admission: str = "stream",
                   results_capacity: Optional[int] = None,
                   state: Optional[DenseState] = None,
                   stream: Optional[StreamState] = None,
                   max_steps: int = 1_000_000,
                   checkpoint: Optional[str] = None,
                   checkpoint_every: int = 0,
                   kill_after_saves: Optional[int] = None,
                   shadow_every: Optional[int] = None):
        """Drive a queue of jobs through the B lane slots (the JAX
        ``run_stream``); returns the final ``(state, stream)``. ``jobs``:
        a JobPool (``pack_jobs``) or a list of event lists / ScriptOps.
        ``admission``: "stream" refills a slot the moment its job
        retires; "gang" only when every slot is idle, the
        static-batching baseline on the same engine. Each step is
        ``_stream_step``; the loop ends when every job to execute is
        harvested, or raises after ``max_steps``. ``state`` and
        ``stream`` (default: a fresh batch and ``init_stream(pool,
        results_capacity)``) are left as they were: the run owns its
        copies, which the kernels write in place. With the flight
        recorder armed, each lane's ring records its jobs' ticks and
        their admits and harvests (and the memo plane's coalesces,
        fast-forwards and forks).

        The memo plane (the runner's ``memo``): only one leader per
        distinct digest runs; its duplicates and the summary cache's hits
        are served at the end (``stream_results`` rows with ``digest``
        and ``served_from``). Under "full" a lane whose signature recurs
        mid-drain is fast-forwarded (``_ff_host``; not with periodic
        re-initiation, which the clock drives). Under "prefix" leaders
        fork from the deepest checkpointed boundary they share
        (``_prefix_plan``). ``shadow_every`` overrides
        ``MEMO_SHADOW_EVERY`` for both audits (0 disables).

        Checkpointing (the JAX ``run_stream``'s): with ``checkpoint`` and
        ``checkpoint_every`` k, every step whose count ``steps`` is a
        multiple of k saves the ``(state, stream)`` pair atomically
        (utils/checkpoint.save_state) with ``meta`` holding
        ``stream_steps`` and ``jobs_done``. Resume by loading it with
        ``like=(runner.init_batch_device(), runner.init_stream(pool))``
        and passing ``state=`` and ``stream=`` back in: admission order,
        the per-job streams and the results ring live in the carry, and
        under memo the plan is a pure function of the pool and the cache
        files, which change only when a run ends, so the continuation is
        bit-exact. ``kill_after_saves``: return right after that many
        saves (a preemption drill), before the memo plane's end."""
        from chandy_lamport_tpu_torch.utils.checkpoint import save_state

        if admission not in ("stream", "gang"):
            raise ValueError(f"unknown admission mode {admission!r}")
        if stretch < 1 or drain_chunk < 1:
            raise ValueError("stretch and drain_chunk must be >= 1")
        pool = jobs if isinstance(jobs, JobPool) else self.pack_jobs(jobs)
        memo = self.memo
        self._memo_rows = {}
        self._fork_depths = []
        self._prefix_stats = {"prefix_evictions": 0,
                              "prefix_evicted_bytes": 0,
                              "prefix_store_entries": 0}
        self.memo_timing = {}
        arms: dict = {}
        plan = pplan = None
        if memo == "off":
            target = pool.num_jobs
        else:
            t0 = time.perf_counter()
            plan = self._memo_plan(pool, shadow_every)
            self.memo_timing["plan_s"] = time.perf_counter() - t0
            target = len(plan["exec"])
            arms = {"order": torch.as_tensor(np.asarray(plan["exec"],
                                                        np.int32),
                                             device=self.device),
                    "followers": torch.as_tensor(
                        np.asarray(plan["follower_counts"], np.int32),
                        device=self.device)}
        s = (self.init_batch_device() if state is None
             else self._own(state))
        st = (self.init_stream(pool, results_capacity) if stream is None
              else StreamState(*(x.clone() for x in stream)))
        if memo == "prefix":
            pplan = self._prefix_plan(pool, plan, shadow_every)
            arms.update(bank=pplan["bank"], fork_src=pplan["fork_src"],
                        fork_depth=pplan["fork_depth"])
        watch = None
        if memo == "full" and self.config.snapshot_every == 0:
            # fast-forward: a recurring signature means a frozen lane, but
            # periodic re-initiation is driven by the clock
            watch = {"jend": pool.job_end.cpu().numpy(),
                     "jlim": pool.job_limit.cpu().numpy()}
            self.memo_timing["ff_watch_s"] = 0.0
        guards = self.guards
        self._lane_template()   # built before the armed loop
        # the carry enters the loop through the named bulk upload, and
        # the loop's only host reads are the named sites below
        s, st = guarded_put(guards, "stream-carry-upload", (s, st),
                            self.device)
        done = int(guarded_get(guards, "stream-termination-scalars",
                               st.jobs_done))
        steps, saves = 0, 0
        with armed(guards):
            while done < target:
                if steps == max_steps:
                    raise RuntimeError(
                        f"run_stream: {target - done} of {target} executed "
                        f"jobs unfinished after {max_steps} steps; raise "
                        f"max_steps")
                s, st = self._stream_step(s, st, pool, stretch,
                                          drain_chunk, admission == "gang",
                                          memo, **arms)
                if watch is not None:
                    with relaxed_site(guards, "memo-fastforward"):
                        s, st = self._ff_host(s, st, watch)
                done, steps_now = (int(x) for x in guarded_get(
                    guards, "stream-termination-scalars",
                    (st.jobs_done, st.steps)))
                steps += 1
                if (checkpoint and checkpoint_every
                        and steps_now % int(checkpoint_every) == 0):
                    # save_state copies the whole carry to the host
                    with relaxed_site(guards, "checkpoint-save"):
                        save_state(checkpoint, (s, st),
                                   meta={"stream_steps": steps_now,
                                         "jobs_done": done},
                                   delay=self.delay)
                    saves += 1
                    if (kill_after_saves is not None
                            and saves >= int(kill_after_saves)):
                        return s, st
        if memo != "off":
            t0 = time.perf_counter()
            s, st = self._memo_finalize(s, st, plan)
            self.memo_timing["finalize_s"] = time.perf_counter() - t0
        if memo == "prefix":
            t0 = time.perf_counter()
            s, st = self._prefix_finalize(s, st, plan, pplan, pool, stretch,
                                          drain_chunk)
            self.memo_timing["prefix_finalize_s"] = time.perf_counter() - t0
        return s, st

    def stream_results(self, stream: StreamState) -> List[dict]:
        """The results as per-job rows sorted by job id (the JAX
        ``stream_results``): the harvested ring overlaid with the rows the
        last memoized run served without a lane or forked (with
        ``digest``, ``served_from``, and ``admit_step`` -1 when served); a
        ring smaller than the executed-job count keeps only its newest
        rows."""
        rows = {r["job"]: r for r in _ring_rows(stream)}
        rows.update(self._memo_rows)
        return sorted(rows.values(), key=lambda r: r["job"])

    def summarize_stream(self, stream: StreamState) -> dict:
        """The stream's host-side counters (``utils/metrics.
        stream_counters``), the results ring's accounting, and the LRU
        books of the last memoized run's summary cache and prefix store
        (the JAX ``summarize_stream``)."""
        d = stream_counters(stream)
        rcap = int(stream.res_job.shape[0])
        d["results_capacity"] = rcap
        d["results_evicted"] = max(0, int(stream.res_count) - rcap)
        d.update(self._memo_cache_stats)
        d.update(self._prefix_stats)
        return d

    @staticmethod
    def summarize(state: DenseState, stream: Optional[StreamState] = None,
                  *, runner=None) -> dict:
        """The JAX ``summarize`` counters of a batched state; given the
        ``stream`` carry, also its ``memo`` and ``serve`` books (the JAX
        keys); given the ``runner`` that ran it, also its ``megatick``,
        ``fused_tick``
        (the kernel's ``fused``: "on" or "off"), ``fused_reason``,
        ``fused_tile`` (the layout: "on" off the block's own shared
        memory, "off" resident) and ``fused_tile_reason``."""
        bits = int(or_reduce(state.error))
        fc = state.fault_counts.sum(0).tolist()
        n = state.has_local.shape[-1]
        recorded, dropped = trace_counts(state)
        out = {
            "instances": int(state.time.shape[0]),
            "total_ticks": int(state.time.sum()),
            "max_time": int(state.time.max()),
            "straggler_waste": round(float(straggler_waste(state)), 4),
            "error_lanes": int((state.error != 0).sum()),
            "error_bits": bits,
            "errors_decoded": decode_error_bits(bits),
            "snapshots_started": int(state.started.sum()),
            "snapshots_completed": int(
                (state.started & (state.completed >= n)).sum()),
            "total_tokens_resident": int(state.tokens.sum()),
            "fault_events": {"drops": fc[0], "dups": fc[1],
                             "jitters": fc[2], "crashes": fc[3],
                             "marker_drops": fc[4], "marker_dups": fc[5],
                             "marker_jitters": fc[6]},
            "fault_skew": int(state.fault_skew.sum()),
            "trace_events": recorded,
            "trace_dropped": dropped,
            "snapshot_lifecycle": {
                key: int(v) for key, v in snapshot_lifecycle(
                    state, n).items()},
        }
        if stream is not None:
            sc = stream_counters(stream)
            out["memo"] = {k: sc[k] for k in (
                "cache_hits", "coalesced_jobs", "ff_skipped_ticks",
                "shadow_checks", "memo_hit_rate")}
            out["serve"] = {k: sc[k] for k in (
                "deadline_misses", "tenant_served", "tenant_quota")}
        if runner is not None:
            out.update(megatick=runner.megatick, fused_tick=runner.fused,
                       fused_reason=runner.fused_reason,
                       fused_tile=runner.fused_tile,
                       fused_tile_reason=runner.fused_tile_reason)
        return out
