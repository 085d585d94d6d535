"""The crash-tolerant multi-worker serving fleet (the JAX package's
``serving/fleet.py`` on the port).

One supervisor process + N server workers (``multiprocessing`` spawn)
share durable files and nothing else: the write-ahead admission spool
(serving/spool.py), the persistent SummaryCache (utils/memocache.py) and
the kernels' build directory. No tensor crosses a process boundary — a
worker SIGKILLed in the middle of a kernel launch takes its CUDA context
with it, and nothing the supervisor holds points into it.

**Division of labor.**

* ``fleet_run`` (the supervisor) durably admits every request into the
  spool BEFORE any worker exists, spawns the workers, and then only
  watches books: it reclaims expired leases (redelivery — the takeover
  path), declares workers dead by exit code and requeues their leases
  immediately with the decoded provenance, restarts dead workers with
  doubling backoff, quarantines repeat offenders as poison, and sheds
  the lowest-priority/latest-deadline pending work
  (admission.shed_order) whenever the backlog outruns the live fleet's
  capacity. It never executes a request itself, and it opens no CUDA
  context.

* ``worker_serve`` (one worker's loop; importable in-process, wrapped by
  the spawn entry ``_worker_main``) leases a chunk, renews the
  heartbeat, serves warm digests straight from the shared SummaryCache,
  runs the cold remainder through the stream engine (``run_stream``,
  the same step the solo server drives, so fleet summaries equal solo
  execution), and commits each summary through the spool's exactly-once
  ``complete``. A worker whose lease was taken over gets ``False`` back
  and discards its late result — execution is at-least-once, serving is
  exactly-once.

**Devices.** Workers run on the card unless the caller names another
device: ``fleet_run(..., device=None)`` resolves the device once in the
supervisor (``parallel/batch.resolve_device``: without CUDA and without a
device it raises there, before any worker exists) and hands it to each
worker as a string in its config. Several workers then share one card,
each with its own CUDA context. Workers start with the ``spawn`` method,
never fork: the caller may already hold a CUDA context. Cold workers on a
cold build directory run ``nvcc`` once between them (kernels/_build.py's
file lock).

**Failure model**: a SIGKILL at ANY point loses nothing — un-acked
requests were never admitted (the caller retries admit, which is
idempotent by digest), acked requests are durable in the spool, and
in-flight leases expire and are redelivered.

Workers are rebuilt from a picklable ``recipe`` dict rather than a
pickled runner: ``recipe_runner`` maps it to a BatchedRunner, or to the
*null executor* (``kind="null"``) that serves deterministic stub
summaries — the control-plane-only arm the poison/shed chaos scenarios
and the host-logic tests use.

Telemetry rows (kinds ``fleet_interval``/``fleet_run``) extend the serve
schema with the fleet books — shed/retry/takeover counts, worker deaths
and restarts — stamped with SERVE_SCHEMA_VERSION, as in JAX. The port's
report adds ``worker_books``: the books of each worker incarnation that
ran to its end (a killed one leaves none), with its device and the CUDA
kernel launches it made — the only way the supervisor's process sees
what the workers' kernels did.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import signal
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.kernels import launch_counts
from chandy_lamport_tpu_torch.models.workloads import (
    ServeRequest,
    ring_topology,
)
from chandy_lamport_tpu_torch.ops.delay import make_fast_delay
from chandy_lamport_tpu_torch.parallel.batch import (
    BatchedRunner,
    _hex,
    resolve_device,
)
from chandy_lamport_tpu_torch.serving.admission import shed_order
from chandy_lamport_tpu_torch.serving.server import SERVE_SCHEMA_VERSION
from chandy_lamport_tpu_torch.serving.spool import (
    AdmissionSpool,
    request_digest,
)
from chandy_lamport_tpu_torch.utils.atomicio import fsync_append
from chandy_lamport_tpu_torch.utils.filelock import locked


def _is_null(recipe: Optional[dict]) -> bool:
    return not recipe or recipe.get("kind", "null") == "null"


def recipe_runner(recipe: Optional[dict], *, device=None):
    """Build a worker's engine from a picklable recipe dict (the JAX
    keys). ``None`` or ``{"kind": "null"}`` selects the null executor
    (returns None); ``{"kind": "ring-stream", ...}`` builds a
    BatchedRunner over a ring topology with the stream engine's
    tiny-shape defaults, its delay through ``make_fast_delay``. The
    recipe — not a pickled runner — crosses the spawn boundary, so every
    worker (and a restarted worker) reconstructs the IDENTICAL engine,
    which is what makes fleet summaries equal solo runs. ``device``: None
    means the card (``resolve_device``)."""
    if _is_null(recipe):
        return None
    if recipe["kind"] != "ring-stream":
        raise ValueError(f"unknown worker recipe kind {recipe['kind']!r}")
    return BatchedRunner(
        ring_topology(int(recipe.get("n", 8)),
                      tokens=int(recipe.get("tokens", 16))),
        SimConfig.for_workload(
            snapshots=int(recipe.get("snapshots", 2)),
            max_recorded=int(recipe.get("max_recorded", 32))),
        make_fast_delay(recipe.get("delay", "hash"),
                        int(recipe.get("delay_seed", 7))),
        int(recipe.get("batch", 2)),
        scheduler=recipe.get("scheduler", "sync"),
        # memo stays "off" unless the recipe opts in: the worker loop
        # serves exact duplicates from the shared SummaryCache itself;
        # memo="prefix" + a shared ``prefix_cache`` forks each cold
        # execution from the deepest boundary any worker checkpointed
        # (singleton pools pin content rank 0, so chain digests agree
        # fleet-wide)
        memo=recipe.get("memo", "off"),
        memo_cache=recipe.get("memo_cache"),
        prefix_cache=recipe.get("prefix_cache"),
        prefix_cache_entries=int(recipe.get("prefix_cache_entries", 0)),
        prefix_cache_bytes=int(recipe.get("prefix_cache_bytes", 0)),
        device=device)


def _chaos_maybe_kill(chaos: Optional[dict], leased_jobs) -> None:
    """Deterministic chaos hook: SIGKILL THIS worker the moment it
    leases ``chaos["kill_on_job"]``, at most ``kill_limit`` times
    fleet-wide — a shared counter file (under the advisory lock) makes
    "kill the first holder once" (the takeover proof) and "kill every
    holder" (the crash-loop that must end in poison quarantine) both
    expressible. No-op without a chaos config."""
    if not chaos or chaos.get("kill_on_job") not in leased_jobs:
        return
    cpath = chaos["counter_path"]
    with locked(cpath):
        try:
            with open(cpath, "r", encoding="utf-8") as f:
                count = int(f.read().strip() or 0)
        except (OSError, ValueError):
            count = 0
        if count >= int(chaos.get("kill_limit", 1)):
            return
        with open(cpath, "w", encoding="utf-8") as f:
            f.write(str(count + 1))
    os.kill(os.getpid(), signal.SIGKILL)


def _null_summary(req: ServeRequest) -> dict:
    """The null executor's deterministic stub summary — a pure function
    of the request, so redelivered executions commit identical bytes."""
    return {"served_from": "null", "events": len(req.events),
            "tenant": int(req.tenant), "priority": int(req.priority)}


def worker_serve(worker_id: str, spool: AdmissionSpool, runner=None, *,
                 stretch: int = 2, drain_chunk: int = 8,
                 lease_limit: int = 2, chaos: Optional[dict] = None,
                 poll_s: float = 0.05, max_wall_s: float = 120.0) -> dict:
    """One worker's serve loop (module docstring); returns its books (the
    JAX books, plus ``launches``: the CUDA kernel launches the loop made,
    by kernel). Runs until every admitted request is terminal, or
    ``max_wall_s``. With ``runner=None`` it is the null executor; else the
    runner's device runs the requests."""
    books = {"leased": 0, "served": 0, "late_rejected": 0,
             "cache_served": 0, "batches": 0, "idle_polls": 0}
    before = launch_counts()
    t0 = time.monotonic()
    while time.monotonic() - t0 < max_wall_s:
        reqs = spool.lease(worker_id, lease_limit)
        if not reqs:
            if spool.finished():
                break
            books["idle_polls"] += 1
            time.sleep(poll_s)
            continue
        books["leased"] += len(reqs)
        books["batches"] += 1
        _chaos_maybe_kill(chaos, {r.job for r in reqs})
        # heartbeat covering the lease -> execute window; a
        # slower-than-the-ttl worker is handled by the commit check, not
        # the heartbeat (complete() refuses a reclaimed lease)
        spool.renew(worker_id, [r.job for r in reqs])
        rows: Dict[int, dict] = {}
        if runner is None:
            for r in reqs:
                rows[r.job] = _null_summary(r)
        else:
            # a FRESH cache handle per batch: other workers' flushed
            # entries become visible, so a digest one worker already
            # served is answered from the shared cache without a lane
            cache = runner._summary_cache()
            dirty = False
            for r in reqs:
                # each cold request executes as its OWN singleton pool:
                # under content keys a job's stream identities are its
                # content RANK within its pool, so its trajectory would
                # shift with its leased companions. A singleton pool pins
                # rank 0, making every execution a pure function of the
                # request — equal across workers, redeliveries and
                # restarts, and to a solo ``run_stream`` of the request
                pool = runner.pack_jobs([r.events], content_keys=True)
                dg = _hex(pool.digest[0].cpu().numpy())
                hit = cache.get(dg)
                if hit is not None:
                    rows[r.job] = {**hit, "digest": dg,
                                   "served_from": "fleet-cache"}
                    books["cache_served"] += 1
                    continue
                _, stream = runner.run_stream(pool, stretch=stretch,
                                              drain_chunk=drain_chunk)
                (row,) = runner.stream_results(stream)
                # under memo="prefix" the executed row can carry fork
                # provenance; the committed summary stays provenance-free
                # so forked and cold executions commit identical bytes
                summ = {k: v for k, v in row.items()
                        if k not in ("job", "admit_step", "digest",
                                     "served_from")}
                cache.put(dg, summ)
                dirty = True
                rows[r.job] = {**summ, "digest": dg,
                               "served_from": "fleet-exec"}
            if dirty:
                cache.flush()
        for j, summ in rows.items():
            if spool.complete(j, worker_id, summ):
                books["served"] += 1
            else:
                # the lease was reclaimed mid-run and redelivered — the
                # takeover's copy owns the serve; discard ours
                books["late_rejected"] += 1
    after = launch_counts()
    books["launches"] = {k: after[k] - before.get(k, 0) for k in after}
    return books


def _books_path(spool_path: str) -> str:
    """The file a fleet's workers append their final books to."""
    return spool_path + ".workers"


def _worker_main(worker_id: str, spool_path: str, wcfg: dict) -> None:
    """Spawn entry: rebuild the spool handle and the engine from the
    picklable config and run the serve loop; its runner is built before
    the first lease, so start-up never eats into a lease. At the end it
    appends its books (device, kernel launches, the allocator's peak
    bytes on the card) to ``_books_path(spool_path)``."""
    spool = AdmissionSpool(spool_path,
                           lease_ttl=wcfg.get("lease_ttl", 10.0),
                           max_attempts=wcfg.get("max_attempts", 3))
    runner = recipe_runner(wcfg.get("recipe"), device=wcfg.get("device"))
    books = worker_serve(worker_id, spool, runner,
                         stretch=wcfg.get("stretch", 2),
                         drain_chunk=wcfg.get("drain_chunk", 8),
                         lease_limit=wcfg.get("lease_limit", 2),
                         chaos=wcfg.get("chaos"),
                         poll_s=wcfg.get("poll_s", 0.05),
                         max_wall_s=wcfg.get("max_wall_s", 120.0))
    books = {"worker": worker_id, "pid": os.getpid(),
             "device": None if runner is None else str(runner.device),
             **books}
    if runner is not None and runner.device.type == "cuda":
        import torch

        books["cuda_peak_allocated_bytes"] = int(
            torch.cuda.max_memory_allocated(runner.device))
    path = _books_path(spool_path)
    line = (json.dumps(books, sort_keys=True) + "\n").encode("utf-8")
    with locked(path):
        with open(path, "ab") as f:
            fsync_append(f, line)


def _read_worker_books(path: str) -> List[dict]:
    try:
        with open(path, "rb") as f:
            return [json.loads(line) for line in f.read().splitlines()
                    if line.strip()]
    except FileNotFoundError:
        return []


def _exit_provenance(code: Optional[int]) -> str:
    """Decode a Process.exitcode into human provenance for the WAL."""
    if code is None:
        return "still running"
    if code < 0:
        try:
            name = signal.Signals(-code).name
        except ValueError:
            name = f"signal {-code}"
        return f"killed by {name}"
    return f"exited with code {code}"


def _latency_percentiles(lat: Sequence[float]) -> dict:
    if not lat:
        return {"lat_p50_s": None, "lat_p99_s": None, "lat_max_s": None}
    a = np.asarray(lat, np.float64)
    return {"lat_p50_s": round(float(np.percentile(a, 50)), 4),
            "lat_p99_s": round(float(np.percentile(a, 99)), 4),
            "lat_max_s": round(float(a.max()), 4)}


def fleet_run(requests: List[ServeRequest], *, spool_path: str,
              workers: int = 2, recipe: Optional[dict] = None,
              lease_ttl: float = 10.0, max_attempts: int = 3,
              lease_limit: int = 2, stretch: int = 2,
              drain_chunk: int = 8, shed_backlog: int = 0,
              crash_schedule: Sequence[float] = (),
              chaos: Optional[dict] = None,
              restart_backoff: float = 0.2, max_restarts: int = 3,
              poll_s: float = 0.05, max_wall_s: float = 120.0,
              telemetry=None, telemetry_every: int = 20,
              device=None) -> dict:
    """Run the fleet over a request list until every request is terminal
    (served, poisoned or shed); returns the report (module docstring),
    the JAX report plus ``worker_books`` and ``device``.

    ``shed_backlog``: pending-queue capacity PER LIVE WORKER (0 = never
    shed) — when the backlog exceeds ``shed_backlog * live_workers``,
    the excess is dropped in admission.shed_order (lowest priority,
    latest deadline first). Worker loss therefore shrinks capacity and
    sheds MORE. ``crash_schedule``: elapsed-seconds at which the
    supervisor SIGKILLs a live worker (models/workloads.crash_schedule
    builds one). ``chaos`` is passed through to the workers'
    deterministic kill hook. ``telemetry``: a utils.tracing.
    TelemetryWriter — one ``fleet_interval`` row per ``telemetry_every``
    supervision polls plus a final ``fleet_run`` row. ``device``
    (keyword-only, the port's own): where a recipe's workers run; None
    means the card, resolved here (module docstring); the null executor
    runs nowhere and resolves nothing."""
    if workers < 1:
        raise ValueError("workers must be >= 1")
    if not _is_null(recipe):
        device = str(resolve_device(device))
    spool = AdmissionSpool(spool_path, lease_ttl=lease_ttl,
                           max_attempts=max_attempts)
    for r in requests:
        spool.admit(r, request_digest(r))

    books = {"takeovers": 0, "poisoned": 0, "shed": 0, "restarts": 0,
             "worker_deaths": 0, "injected_kills": 0}

    def absorb(res: dict) -> None:
        books["takeovers"] += len(res["requeued"])
        books["poisoned"] += len(res["poisoned"])

    def shed_pass(live: int) -> None:
        if not shed_backlog:
            return
        pending = spool.pending()
        cap = int(shed_backlog) * max(live, 1)
        excess = len(pending) - cap
        if excess > 0:
            victims = shed_order([spool.requests[j]
                                  for j in pending])[:excess]
            done = spool.shed_jobs(
                [v.job for v in victims],
                f"backlog {len(pending)} over capacity {cap} "
                f"({live} live worker(s))")
            books["shed"] += len(done)

    # admission-time pressure control: one shed pass BEFORE any worker
    # exists, so a burst arriving faster than the fleet can even start
    # is trimmed deterministically rather than raced
    shed_pass(workers)

    wcfg = {"recipe": recipe, "lease_ttl": lease_ttl,
            "max_attempts": max_attempts, "lease_limit": lease_limit,
            "stretch": stretch, "drain_chunk": drain_chunk,
            "chaos": chaos, "poll_s": poll_s, "max_wall_s": max_wall_s,
            "device": device}
    ctx = mp.get_context("spawn")
    procs: Dict[int, Optional[mp.Process]] = {}
    incarnation = {w: 0 for w in range(workers)}
    backoff = {w: float(restart_backoff) for w in range(workers)}
    next_start = {w: 0.0 for w in range(workers)}
    restarts = {w: 0 for w in range(workers)}

    def spawn(w: int) -> None:
        name = f"w{w}i{incarnation[w]}"
        incarnation[w] += 1
        p = ctx.Process(target=_worker_main,
                        args=(name, spool_path, wcfg), daemon=True)
        p.start()
        procs[w] = p

    t0 = time.monotonic()
    for w in range(workers):
        spawn(w)
    kills = sorted(float(t) for t in crash_schedule)
    polls = 0
    timed_out = False
    while True:
        spool.refresh()
        if spool.finished():
            break
        elapsed = time.monotonic() - t0
        if elapsed >= max_wall_s:
            timed_out = True
            break
        # injected crash schedule (the degraded-mode bench arm)
        while kills and elapsed >= kills[0]:
            kills.pop(0)
            live = [p for p in procs.values()
                    if p is not None and p.exitcode is None]
            if live:
                os.kill(live[0].pid, signal.SIGKILL)
                books["injected_kills"] += 1
        live_count = 0
        for w in range(workers):
            p = procs.get(w)
            if p is not None and p.exitcode is not None:
                # direct evidence of death: requeue its leases NOW with
                # decoded provenance instead of waiting out the ttl
                books["worker_deaths"] += 1
                absorb(spool.requeue_worker(
                    f"w{w}i{incarnation[w] - 1}",
                    f"worker w{w} {_exit_provenance(p.exitcode)}"))
                procs[w] = None
                p = None
                if restarts[w] < max_restarts:
                    next_start[w] = elapsed + backoff[w]
                    backoff[w] *= 2.0   # doubling backoff per slot
                    restarts[w] += 1
                else:
                    next_start[w] = float("inf")
            if p is None and elapsed >= next_start[w] \
                    and next_start[w] != float("inf") \
                    and not spool.finished():
                books["restarts"] += 1
                spawn(w)
                p = procs[w]
            if p is not None and p.exitcode is None:
                live_count += 1
        # leases whose worker died silently (or stalled past the ttl)
        absorb(spool.reclaim_expired())
        shed_pass(live_count)
        if live_count == 0 and all(ns == float("inf")
                                   for ns in next_start.values()):
            break   # restart budget exhausted everywhere — report it
        polls += 1
        if telemetry is not None and telemetry_every \
                and polls % int(telemetry_every) == 0:
            telemetry.write("fleet_interval", {
                "serve_schema": SERVE_SCHEMA_VERSION,
                "elapsed_s": round(elapsed, 3), "live_workers": live_count,
                **spool.counters(), **books})
        time.sleep(poll_s)

    for p in procs.values():
        if p is None:
            continue
        p.join(timeout=5.0)
        if p.exitcode is None:
            p.kill()
            p.join(timeout=5.0)
    wall_s = time.monotonic() - t0

    spool.refresh()
    audit = spool.audit()
    lat = [spool.done_t[j] - spool.admit_t[j] for j in spool.done]
    admitted = len(spool.requests)
    report = {
        "serve_schema": SERVE_SCHEMA_VERSION,
        "workers": workers, "requests": admitted,
        "served": len(spool.done), "poisoned": dict(spool.poisoned),
        "shed": dict(spool.shed),
        "stranded": len(spool.pending()) + len(spool.leases),
        "goodput": round(len(spool.done) / max(admitted, 1), 4),
        "timed_out": timed_out, "wall_s": round(wall_s, 3),
        "books": {**books, **spool.counters()},
        "audit": audit, **_latency_percentiles(lat),
        "device": device,
        "worker_books": _read_worker_books(_books_path(spool_path)),
    }
    if telemetry is not None:
        telemetry.write("fleet_run", dict(report))
    report["results"] = spool.results()
    return report
