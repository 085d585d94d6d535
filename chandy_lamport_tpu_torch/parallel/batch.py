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
  row equals the same job run alone through ``run``.

At ``megatick`` K > 1 the exact drain and flush (the stream's drain slice
and flush pass among them) run in K-tick megaticks through the fused
megatick kernel. Runs on the card unless the caller passes
``device="cpu"``, where the kernel wrappers take their plain PyTorch
versions. Both schedulers carry the fault adversary (``faults=``), the
snapshot supervisor (the config's ``snapshot_*`` knobs), ``quarantine=``
and the flight recorder (``trace=``, utils/tracing.py). ``run_stream``
checkpoints its ``(state, stream)`` carry every K steps
(utils/checkpoint.py), and a run resumed from the file ends bit-equal to
the uninterrupted one. Not ported yet (ROADMAP.md): the stream's memo
plane (A9b).
"""

from __future__ import annotations

import dataclasses
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
    DenseState,
    DenseTopology,
    decode_error_bits,
    init_state,
)
from chandy_lamport_tpu_torch.ops.tick import (
    TickKernel,
    harvest_lane_summaries,
    reset_lanes,
)
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec
from chandy_lamport_tpu_torch.utils.metrics import (
    lane_total_tokens,
    or_reduce,
    snapshot_lifecycle,
    straggler_waste,
    stream_counters,
)
from chandy_lamport_tpu_torch.utils.tracing import (
    EV_LANE_ADMIT,
    EV_LANE_HARVEST,
    armed_config,
    trace_append_lanes,
    trace_counts,
)

OP_NOP, OP_SEND, OP_SNAPSHOT = 0, 1, 2

_i32 = torch.int32


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
    are its stream identities (row j of ``init_batch_state(J)``), copied
    into whichever lane admits it. ``digest`` is all zeros and
    ``prefix_digest`` None: both belong to the memo plane (A9b)."""

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
    prefix_digest: Any = None

    @property
    def num_jobs(self) -> int:
        return int(self.job_start.shape[0])


class StreamState(NamedTuple):
    """The streaming engine's carry beside the lane batch (the JAX
    ``StreamState``, leaf for leaf): admission and occupancy books, the
    memo, prefix and serving counters (zeros here: those planes are not
    ported), and the per-job results ring the harvest writes. Every leaf
    is an int32 tensor on the runner's device."""

    next_job: Any          # []  jobs admitted so far
    jobs_done: Any         # []  jobs harvested into the ring
    steps: Any             # []  stream steps executed
    refills: Any           # []  admissions into a recycled slot
    lane_steps_live: Any   # []  lane-steps that held a live job
    lane_steps_total: Any  # []  lane-steps charged (occupancy denominator)
    cache_hits: Any        # []  memo plane (A9b): 0
    coalesced_jobs: Any
    ff_skipped_ticks: Any
    shadow_checks: Any
    prefix_hits: Any
    forked_jobs: Any
    fork_depth_sum: Any
    deadline_misses: Any   # []  serving plane (A10): 0
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
                 check_every: int = 0, device=None,
                 exact_impl: str = "cascade", faults=None,
                 quarantine: bool = False, trace=None, megatick: int = 1):
        """scheduler: "exact" (the reference's delivery semantics,
        bit-exact; the default, as in the JAX ``BatchedRunner``) or "sync"
        (simultaneous delivery, the production path).

        exact_impl: the exact tick's formulation, "cascade" (one host step
        per batched marker delivery) or "wave" (one host step per wave:
        every destination's next marker at once; needs a
        position-addressable sampler, HashDelay or FixedDelay, else
        ValueError); bit-identical to each other, at any megatick.
        "fold" raises NotImplementedError (ROADMAP.md, A5b).

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

        device: where the state lives and the kernels run; None means the
        card (``resolve_device``)."""
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
        self.scheduler = scheduler
        self.check_every = int(check_every)
        # sync keeps markers in the split planes; exact needs the unified
        # ring for push-order delay draws
        self.kernel = TickKernel(
            self.topo, self.config, delay, self.device,
            marker_mode="split" if scheduler == "sync" else "ring",
            exact_impl=exact_impl, faults=faults, quarantine=quarantine,
            megatick=megatick, trace=trace)
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

    # ---- the streaming job engine (A9, memo off) -----------------------------
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
        pooled phase table on the runner's device (the JAX ``pack_jobs``
        on its memo-off path): each job's stream identities are row j of
        ``init_batch_state(J)`` of the delay sampler and the adversary.
        ``fault_armed`` [J] bools arms exactly those jobs (keys zeroed
        elsewhere; default all); without an adversary every key is 0.
        ``content_keys=True`` (content-derived identities and digests)
        belongs to the memo plane: NotImplementedError."""
        if content_keys:
            raise NotImplementedError(
                "content_keys=True derives the jobs' stream identities and "
                "digests by content for the memo plane, which is not "
                "ported yet (ROADMAP.md, A9b)")
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
        if self.faults is not None:
            keys = self.faults.init_batch_state(jcount, dev)
            if fault_armed is not None:
                armed = torch.as_tensor(np.asarray(fault_armed, bool),
                                        device=dev)
                keys = torch.where(armed, keys, 0)
        else:
            keys = torch.zeros(jcount, dtype=torch.int64, device=dev)

        def put(x):
            return torch.as_tensor(x, device=dev)

        return JobPool(put(kind), put(arg0), put(arg1), put(do_tick),
                       put(start), put(end), put(limit), keys,
                       torch.zeros((jcount, 32), dtype=torch.uint8,
                                   device=dev),
                       self.delay.init_batch_state(jcount, dev))

    def init_stream(self, pool: JobPool,
                    results_capacity: Optional[int] = None) -> StreamState:
        """A fresh stream carry for ``pool``: zero counters and an empty
        results ring of ``results_capacity`` slots (default one per job;
        a smaller ring wraps, keeping the newest rows). The serving books
        are one zero tenant."""
        r = int(results_capacity) if results_capacity else pool.num_jobs
        if r < 1:
            raise ValueError("results_capacity must be >= 1")

        def z(*shape):
            return torch.zeros(shape, dtype=_i32, device=self.device)

        return StreamState(
            next_job=z(), jobs_done=z(), steps=z(), refills=z(),
            lane_steps_live=z(), lane_steps_total=z(), cache_hits=z(),
            coalesced_jobs=z(), ff_skipped_ticks=z(), shadow_checks=z(),
            prefix_hits=z(), forked_jobs=z(), fork_depth_sum=z(),
            deadline_misses=z(), tenant_served=z(1), tenant_quota=z(1),
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
                   drain_chunk: int) -> DenseState:
        """Every lane's pass through its stage (the JAX ``lane_pass``):
        ``stretch`` script substeps (one pooled phase each), then one
        drain slice of ``drain_chunk`` conditional ticks against each
        job's absolute limit, then one flush pass. A lane that ends its
        script in a substep drains in the same step, and one that ends
        its drain in the slice flushes in the same step: the stage is
        read again before each pass."""
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
        return s

    def _stream_step(self, s: DenseState, st: StreamState, pool: JobPool,
                     stretch: int, drain_chunk: int, gang: bool):
        """One streaming step (the JAX ``_build_stream_step`` with memo
        off), in the JAX order: harvest retired lanes into the results
        ring, admit queued jobs into the freed slots (``reset_lanes``,
        then the pool's rows), the occupancy books, then every lane's
        ``_lane_pass``. Returns (state, stream)."""
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
        if self.kernel._trace_on:
            # before the reset: the ring spans the lane's jobs
            # (_RESET_KEEP), so the harvest survives it
            s = trace_append_lanes(s, fin, EV_LANE_HARVEST, jid)

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
        admit = idle & (arank < jcount - st.next_job)
        if gang:
            # gang admission, the static-batching baseline on the same
            # engine: refill only when every lane is idle
            admit = admit & idle.all()
        new_jid = st.next_job + arank
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
        if self.kernel._trace_on:
            s = trace_append_lanes(s, admit, EV_LANE_ADMIT, new_jid)
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
        # -- advance
        return self._lane_pass(s, pool, stretch, drain_chunk), st

    def run_stream(self, jobs, *, stretch: int = 4, drain_chunk: int = 32,
                   admission: str = "stream",
                   results_capacity: Optional[int] = None,
                   state: Optional[DenseState] = None,
                   stream: Optional[StreamState] = None,
                   max_steps: int = 1_000_000,
                   checkpoint: Optional[str] = None,
                   checkpoint_every: int = 0,
                   kill_after_saves: Optional[int] = None):
        """Drive a queue of jobs through the B lane slots (the JAX
        ``run_stream`` with the memo plane off); returns the final
        ``(state, stream)``. ``jobs``: a JobPool (``pack_jobs``) or a list
        of event lists / ScriptOps. ``admission``: "stream" refills a slot
        the moment its job retires; "gang" only when every slot is idle,
        the static-batching baseline on the same engine. Each step is
        ``_stream_step``; the loop ends when every job is harvested, or
        raises after ``max_steps``. ``state`` and ``stream`` (default: a
        fresh batch and ``init_stream(pool, results_capacity)``) are left
        as they were: the run owns its copies, which the kernels write in
        place. With the flight recorder armed, each lane's ring records
        its jobs' ticks and their admits and harvests. The memo plane
        (A9b) is not ported.

        Checkpointing (the JAX ``run_stream``'s): with ``checkpoint`` and
        ``checkpoint_every`` k, every step whose count ``steps`` is a
        multiple of k saves the ``(state, stream)`` pair atomically
        (utils/checkpoint.save_state) with ``meta`` holding
        ``stream_steps`` and ``jobs_done``. Resume by loading it with
        ``like=(runner.init_batch_device(), runner.init_stream(pool))``
        and passing ``state=`` and ``stream=`` back in: admission order,
        the per-job streams and the results ring live in the carry, so
        the continuation is bit-exact. ``kill_after_saves``: return right
        after that many saves (a preemption drill)."""
        from chandy_lamport_tpu_torch.utils.checkpoint import save_state

        if admission not in ("stream", "gang"):
            raise ValueError(f"unknown admission mode {admission!r}")
        if stretch < 1 or drain_chunk < 1:
            raise ValueError("stretch and drain_chunk must be >= 1")
        pool = jobs if isinstance(jobs, JobPool) else self.pack_jobs(jobs)
        target = pool.num_jobs
        s = (self.init_batch_device() if state is None
             else self._own(state))
        st = (self.init_stream(pool, results_capacity) if stream is None
              else StreamState(*(x.clone() for x in stream)))
        done, steps, saves = int(st.jobs_done), 0, 0
        while done < target:
            if steps == max_steps:
                raise RuntimeError(
                    f"run_stream: {target - done} of {target} jobs "
                    f"unfinished after {max_steps} steps; raise max_steps")
            s, st = self._stream_step(s, st, pool, stretch, drain_chunk,
                                      admission == "gang")
            done, steps = int(st.jobs_done), steps + 1
            steps_now = int(st.steps)
            if (checkpoint and checkpoint_every
                    and steps_now % int(checkpoint_every) == 0):
                save_state(checkpoint, (s, st),
                           meta={"stream_steps": steps_now,
                                 "jobs_done": done}, delay=self.delay)
                saves += 1
                if (kill_after_saves is not None
                        and saves >= int(kill_after_saves)):
                    return s, st
        return s, st

    def stream_results(self, stream: StreamState) -> List[dict]:
        """The harvested results as per-job rows sorted by job id (the
        JAX ``stream_results``); a ring smaller than the job count keeps
        only its newest rows."""
        rows = {r["job"]: r for r in _ring_rows(stream)}
        return sorted(rows.values(), key=lambda r: r["job"])

    def summarize_stream(self, stream: StreamState) -> dict:
        """The stream's host-side counters (``utils/metrics.
        stream_counters``) and the results ring's accounting, with the
        memo plane's cache and prefix books at zero (the JAX
        ``summarize_stream`` with memo off)."""
        d = stream_counters(stream)
        rcap = int(stream.res_job.shape[0])
        d["results_capacity"] = rcap
        d["results_evicted"] = max(0, int(stream.res_count) - rcap)
        d.update(cache_evictions=0, cache_evicted_bytes=0,
                 prefix_evictions=0, prefix_evicted_bytes=0,
                 prefix_store_entries=0)
        return d

    @staticmethod
    def summarize(state: DenseState, stream: Optional[StreamState] = None,
                  *, runner=None) -> dict:
        """The JAX ``summarize`` counters of a batched state; given the
        ``stream`` carry, also its ``memo`` and ``serve`` books (the JAX
        keys; zeros until the memo plane and serving are ported); given
        the ``runner`` that ran it, also its ``megatick``, ``fused_tick``
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
