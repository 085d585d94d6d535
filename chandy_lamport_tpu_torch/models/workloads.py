"""Synthetic topologies, storm traffic programs and streamed job mixes
(copied from the JAX package's ``models/workloads.py``; numpy and
``random`` only, so both packages build byte-identical graphs, programs
and job lists from the same seeds).

Every generator embeds a Hamiltonian ring, so every graph is strongly
connected and every snapshot can complete.
"""

from __future__ import annotations

import random
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from chandy_lamport_tpu_torch.core.spec import (
    Event,
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.core.state import DenseTopology
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec


def _ids(n: int) -> List[str]:
    # zero-padded so lexicographic order == numeric order at any scale
    width = len(str(n))
    return [f"N{str(i + 1).zfill(width)}" for i in range(n)]


def ring_topology(n: int, tokens: int = 100) -> TopologySpec:
    """Unidirectional ring."""
    ids = _ids(n)
    nodes = [(nid, tokens) for nid in ids]
    links = [(ids[i], ids[(i + 1) % n]) for i in range(n)]
    return TopologySpec(nodes, links)


def erdos_renyi(n: int, avg_degree: float, seed: int,
                tokens: int = 100) -> TopologySpec:
    """Ring + uniformly random extra arcs up to the requested mean
    out-degree."""
    rng = random.Random(seed)
    ids = _ids(n)
    nodes = [(nid, tokens) for nid in ids]
    links = {(ids[i], ids[(i + 1) % n]) for i in range(n)}
    extra = max(0, int(n * avg_degree) - n)
    while len(links) < n + extra:
        a, b = rng.randrange(n), rng.randrange(n)
        if a != b:
            links.add((ids[a], ids[b]))
    return TopologySpec(nodes, sorted(links))


def scale_free(n: int, attach: int, seed: int,
               tokens: int = 100) -> TopologySpec:
    """Ring + preferential attachment: each node adds ``attach`` outbound
    arcs to degree-weighted targets, so hubs concentrate traffic."""
    rng = random.Random(seed)
    ids = _ids(n)
    nodes = [(nid, tokens) for nid in ids]
    links = {(ids[i], ids[(i + 1) % n]) for i in range(n)}
    degree = [1] * n
    targets = list(range(n))  # degree-weighted sampling pool
    for i in range(n):
        for _ in range(attach):
            j = targets[rng.randrange(len(targets))]
            if j != i and (ids[i], ids[j]) not in links:
                links.add((ids[i], ids[j]))
                degree[j] += 1
                targets.append(j)
    return TopologySpec(nodes, sorted(links))


def stream_jobs(spec: TopologySpec, count: int, seed: int,
                base_phases: int = 4, tail_alpha: float = 1.1,
                max_phases: int = 64, amount: int = 1,
                snapshots_per_job: int = 1,
                dup_rate: float = 0.0,
                prefix_overlap: float = 0.0) -> List[List[Event]]:
    """A heavy-tailed job mix for the streaming engine
    (parallel/batch.run_stream), event for event the JAX
    ``stream_jobs``: ``count`` event-list jobs whose phase counts follow
    a Pareto(``tail_alpha``) tail over ``base_phases`` (clamped to
    ``max_phases``). Each phase sends ``amount`` tokens over one link
    (rotating through the link list with a per-job offset) and ticks
    once; each job initiates ``snapshots_per_job`` snapshots, the first
    at phase 1 and the rest spread, from a per-job rotating initiator.
    Deterministic in ``seed``.

    ``dup_rate``: the fraction of the jobs that are byte-identical
    repeats of a Zipf-drawn job of a library of ``max(1, round(count *
    (1 - dup_rate)))`` unique ones, shuffled in among them.
    ``prefix_overlap``: every job copies a Zipf-drawn base of a library
    of ``max(1, round(count * (1 - prefix_overlap)))`` and appends one
    unique closing tail (a one-token send over its own link and a tick
    run whose length encodes the job index), so jobs drawing the same
    base share every phase but the last. The two shapes exclude each
    other; both are traffic shapes, valid with the memo plane off."""
    if count < 1:
        raise ValueError("count must be >= 1")
    if not 0.0 <= dup_rate < 1.0:
        raise ValueError("dup_rate must be in [0, 1)")
    if not 0.0 <= prefix_overlap < 1.0:
        raise ValueError("prefix_overlap must be in [0, 1)")
    if prefix_overlap:
        if dup_rate:
            raise ValueError(
                "prefix_overlap and dup_rate are mutually exclusive "
                "traffic shapes — arm one")
        nbase = max(1, round(count * (1.0 - prefix_overlap)))
        library = stream_jobs(spec, nbase, seed, base_phases=base_phases,
                              tail_alpha=tail_alpha, max_phases=max_phases,
                              amount=amount,
                              snapshots_per_job=snapshots_per_job)
        rng = random.Random(seed + 0x9EF1)
        weights = [1.0 / (k + 1) for k in range(nbase)]
        picks = rng.choices(range(nbase), weights=weights, k=count)
        links = list(spec.links)
        out: List[List[Event]] = []
        for i, k in enumerate(picks):
            src, dest = links[i % len(links)]
            out.append(list(library[k])
                       + [PassTokenEvent(src=src, dest=dest,
                                         tokens=amount),
                          TickEvent(1 + i // len(links))])
        return out
    if dup_rate:
        nuniq = max(1, round(count * (1.0 - dup_rate)))
        library = stream_jobs(spec, nuniq, seed, base_phases=base_phases,
                              tail_alpha=tail_alpha, max_phases=max_phases,
                              amount=amount,
                              snapshots_per_job=snapshots_per_job)
        rng = random.Random(seed + 0x5EED)
        weights = [1.0 / (k + 1) for k in range(nuniq)]
        picks = rng.choices(range(nuniq), weights=weights, k=count - nuniq)
        mix = list(library) + [library[k] for k in picks]
        rng.shuffle(mix)
        return mix
    rng = random.Random(seed)
    links = list(spec.links)
    node_ids = [nid for nid, _ in spec.nodes]
    jobs: List[List[Event]] = []
    for j in range(count):
        phases = min(max_phases,
                     max(1, int(base_phases * rng.paretovariate(tail_alpha))))
        snap_at = {min(1, phases - 1)}
        for k in range(1, snapshots_per_job):
            snap_at.add((k * phases) // snapshots_per_job)
        ev: List[Event] = []
        snaps_fired = 0
        for p in range(phases):
            src, dest = links[(j * 7 + p) % len(links)]
            ev.append(PassTokenEvent(src=src, dest=dest, tokens=amount))
            if p in snap_at:
                ev.append(SnapshotEvent(
                    node_id=node_ids[(j + snaps_fired) % len(node_ids)]))
                snaps_fired += 1
            ev.append(TickEvent(1))
        jobs.append(ev)
    return jobs


class ServeRequest(NamedTuple):
    """One job of an open-loop serving workload (serving/server.py): the
    event-list payload and the service metadata the admission policy
    orders by. ``arrival_step`` and ``deadline_step`` are absolute
    stream-step clocks; ``priority`` is higher-wins."""

    job: int            # index into the packed pool (== list position)
    arrival_step: int   # stream step the job becomes visible to admission
    tenant: int         # tenant id in [0, tenants)
    priority: int       # admission class, higher admitted first
    deadline_step: int  # absolute harvest-by step (arrival + slack)
    events: List[Event]


def serve_workload(spec: TopologySpec, count: int, seed: int,
                   rate: float = 1.0, tenants: int = 4,
                   priorities: int = 2,
                   deadline_slack: Tuple[int, int] = (64, 256),
                   dup_rate: float = 0.0, base_phases: int = 4,
                   tail_alpha: float = 1.1, max_phases: int = 64,
                   amount: int = 1, snapshots_per_job: int = 1,
                   ) -> List[ServeRequest]:
    """A seeded Poisson/Zipf open-loop serving trace: ``count`` jobs whose
    scripts are the ``stream_jobs`` mix (``dup_rate`` the Zipf duplicate
    share), arriving at Poisson times (exponential inter-arrivals of mean
    ``1/rate`` stream steps, accumulated and floored onto the step
    clock). Tenants are drawn with weight 1/(t+1), priorities uniformly
    over ``priorities`` classes, and each deadline is the arrival plus a
    uniform slack from ``deadline_slack``. Deterministic in ``seed``, and
    equal to the JAX ``serve_workload`` for equal arguments. Returned in
    arrival order."""
    if count < 1:
        raise ValueError("count must be >= 1")
    if rate <= 0.0:
        raise ValueError("rate must be > 0 (jobs per stream step)")
    if tenants < 1 or priorities < 1:
        raise ValueError("tenants and priorities must be >= 1")
    lo, hi = int(deadline_slack[0]), int(deadline_slack[1])
    if not 0 < lo <= hi:
        raise ValueError("deadline_slack must be 0 < lo <= hi")
    jobs = stream_jobs(spec, count, seed, base_phases=base_phases,
                       tail_alpha=tail_alpha, max_phases=max_phases,
                       amount=amount, snapshots_per_job=snapshots_per_job,
                       dup_rate=dup_rate)
    rng = random.Random(seed + 0x5E12E)
    tweights = [1.0 / (t + 1) for t in range(tenants)]
    clock = 0.0
    reqs: List[ServeRequest] = []
    for j, ev in enumerate(jobs):
        clock += rng.expovariate(rate)
        arrival = int(clock)
        reqs.append(ServeRequest(
            job=j, arrival_step=arrival,
            tenant=rng.choices(range(tenants), weights=tweights)[0],
            priority=rng.randrange(priorities),
            deadline_step=arrival + rng.randint(lo, hi),
            events=ev))
    return reqs


def burst_workload(spec: TopologySpec, count: int, seed: int,
                   rate: float = 1.0, burst_period: int = 32,
                   burst_factor: float = 8.0,
                   **kwargs) -> List[ServeRequest]:
    """A bursty open-loop serving trace: the ``serve_workload`` mix with
    its arrivals re-timed by an on/off rate, ``burst_factor`` times
    ``rate`` in the first half of each ``burst_period`` steps and
    ``rate / burst_factor`` in the second, so the backlog builds in
    waves. Each request keeps its deadline slack; tenants, priorities
    and scripts are untouched. Deterministic in ``seed`` (the JAX
    ``burst_workload``); other keywords go to ``serve_workload``."""
    if burst_period < 2:
        raise ValueError("burst_period must be >= 2 steps")
    if burst_factor <= 1.0:
        raise ValueError("burst_factor must be > 1")
    reqs = serve_workload(spec, count, seed, rate=rate, **kwargs)
    rng = random.Random(seed + 0xB125)
    clock = 0.0
    out: List[ServeRequest] = []
    for r in reqs:
        on = (int(clock) % int(burst_period)) < int(burst_period) // 2
        eff = rate * burst_factor if on else rate / burst_factor
        clock += rng.expovariate(eff)
        arrival = int(clock)
        slack = r.deadline_step - r.arrival_step
        out.append(r._replace(arrival_step=arrival,
                              deadline_step=arrival + slack))
    return out


def crash_schedule(kills: int, period_s: float,
                   start_s: float = 1.0) -> List[float]:
    """Deterministic worker-kill times (elapsed seconds) for
    serving/fleet.fleet_run's injected crash schedule (the JAX
    ``crash_schedule``): the degraded-mode arm SIGKILLs one live worker
    at each returned instant, the first at ``start_s``, then every
    ``period_s``."""
    if kills < 0:
        raise ValueError("kills must be >= 0")
    if period_s <= 0 or start_s < 0:
        raise ValueError("period_s must be > 0 and start_s >= 0")
    return [start_s + k * period_s for k in range(kills)]


class StormProgram(NamedTuple):
    """Compiled storm traffic: T phases, each = bulk sends + snapshot
    initiations + one tick."""

    amounts: Any   # i32 [T, E] tokens to send on each edge this phase
    snap: Any      # i32 [T, J] initiator node index, -1 = none


def storm_program(topo: DenseTopology, phases: int, amount: int = 1,
                  snapshot_phases: Optional[Sequence[Tuple[int, int]]] = None,
                  ) -> StormProgram:
    """Every phase, every node sends ``amount`` on one outbound edge,
    cycling round-robin over its out-links; ``snapshot_phases`` is
    [(phase, node_index), ...]."""
    t, e = phases, topo.e
    amounts = np.zeros((t, e), np.int32)
    # a node's out-edges are its edge_table row, -1 padded at the end; each
    # edge has one source, so a phase's picks are distinct edges
    degree = (topo.edge_table >= 0).sum(1)
    senders = np.flatnonzero(degree)
    for ph in range(t):
        picks = topo.edge_table[senders, ph % degree[senders]]
        amounts[ph, picks] += amount
    sched = list(snapshot_phases or [])
    per_phase: List[List[int]] = [[] for _ in range(t)]
    for ph, node in sched:
        if not 0 <= ph < t:
            raise ValueError(
                f"snapshot scheduled at phase {ph}, but the program has "
                f"only {t} phases (raise phases or tighten the schedule)")
        per_phase[ph].append(node)
    j = max((len(p) for p in per_phase), default=0) or 1
    snap = np.full((t, j), -1, np.int32)
    for ph, nodes in enumerate(per_phase):
        snap[ph, :len(nodes)] = nodes
    return StormProgram(amounts, snap)


def staggered_snapshots(topo: DenseTopology, count: int,
                        start_phase: int = 0, stride: int = 1,
                        max_phases: Optional[int] = None,
                        ) -> List[Tuple[int, int]]:
    """Snapshot k initiated by node k at phase start + k*stride. With
    ``max_phases``, the stride shrinks (floor 1) and the schedule wraps so
    every initiation fits a ``max_phases``-phase program; wrapped
    duplicates of one (phase, node) are dropped."""
    if max_phases is not None:
        if max_phases < 1:
            raise ValueError("max_phases must be >= 1")
        start_phase = min(start_phase, max_phases - 1)
        if count > 1:
            stride = max(min(stride, (max_phases - 1 - start_phase)
                             // (count - 1)), 1)
    sched = [(start_phase + k * stride, k % topo.n) for k in range(count)]
    if max_phases is not None:
        sched = [(ph % max_phases, node) for ph, node in sched]
        seen, unique = set(), []
        for item in sched:
            if item not in seen:
                seen.add(item)
                unique.append(item)
        sched = unique
    return sched
