"""The serve loop: an online, multi-tenant front-end over the stream step
(the JAX package's ``serving/server.py``).

``serve_run`` drives a timed open-loop request schedule
(models/workloads.serve_workload) through BatchedRunner's serving-mode
stream step. The division of labour with run_stream's batch loop:

* The DEVICE runs the same harvest -> admit -> advance step, plus the
  serving books (deadline misses, per-tenant service counts: StreamState
  leaves). Admission walks an exec-order tensor the host keeps on the
  device, up to a ``limit`` the host uploads each step, so the step's
  operands keep their shapes as the queue reorders. On the exact
  scheduler at megatick K > 1 the step's drain and flush go through the
  fused megatick kernel's gated stream arm, as run_stream's do.

* The HOST owns time-aware admission: each step it re-sorts the arrived
  but unadmitted requests under the ``serve_policy`` knob (EDF within
  priority class, or fifo), uploads the rewritten un-admitted suffix of
  the exec order and the admissible prefix's length, and reads the
  step's progress scalars back (the one sync per step of the loop
  itself; the port's step makes its own host reads inside the
  ``stream-lane-pass`` site, utils/guards.py).

Memo digests are taken at INGEST (admission.plan_ingest): a request whose
digest the persistent SummaryCache holds is served its summary the
moment it arrives, without a lane; duplicates coalesce onto the first
accepted leader and are fanned out at the end, as run_stream's memo
plane does. Quota refusal happens at ingest too, in the deterministic
arrival order, never against the device's drain speed.

Kill -> resume is bit-exact because every host decision is a memoryless
function of state the resumed process can rebuild: the ingest plan is
pure in (requests, cache file, quotas); the pending set is "arrived and
not admitted", where the admitted set comes back from the saved carry
(the results ring and the lanes' job ids); and the eligible order is
re-sorted from scratch each step. Exec-order positions below ``next_job``
are never read again, so their content need not survive the crash.
Admit-latency percentiles are this process's observation (they restart
on resume); every result row and every carried counter equals the
uninterrupted run's. The checkpoint is the JAX package's file, so a
serve killed in either package resumes in the other.

The step's kernels are made ready through serving.executables.
ExecutableCache: a restarted server at a seen bucket loads the built
libraries without ``nvcc`` (``warmup_source`` in the report).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from chandy_lamport_tpu_torch.models.workloads import ServeRequest
from chandy_lamport_tpu_torch.parallel.batch import StreamState, _ring_rows
from chandy_lamport_tpu_torch.serving.admission import (
    order_eligible,
    plan_ingest,
    resolve_serve_policy,
)
from chandy_lamport_tpu_torch.serving.executables import ExecutableCache
from chandy_lamport_tpu_torch.utils.guards import (
    armed,
    guarded_get,
    guarded_put,
    relaxed_site,
)

SERVE_SCHEMA_VERSION = 1

_i32 = torch.int32


def _percentiles(lat: Sequence[int]) -> dict:
    if not lat:
        return {"admit_p50": None, "admit_p99": None, "admit_max": None}
    a = np.asarray(lat)
    return {"admit_p50": float(np.percentile(a, 50)),
            "admit_p99": float(np.percentile(a, 99)),
            "admit_max": int(a.max())}


def _fused_books(runner) -> dict:
    # the port's kernel never runs emulated: on the card it launches, on
    # the CPU the plain form runs and ``fused`` says "off"
    return {"fused_tick": runner.fused, "fused_tile": runner.fused_tile,
            "fused_emulated": False}


def serve_run(runner, requests: List[ServeRequest], *,
              policy: str = "edf",
              quotas: Optional[Sequence[int]] = None,
              stretch: int = 4, drain_chunk: int = 32,
              results_capacity: Optional[int] = None,
              state=None, stream=None,
              max_steps: int = 1_000_000,
              checkpoint: Optional[str] = None,
              checkpoint_every: int = 0,
              kill_after_saves: Optional[int] = None,
              telemetry=None, telemetry_interval: int = 64,
              exec_cache: Optional[ExecutableCache] = None,
              guards=None):
    """Serve a timed request schedule; returns ``(state, stream, report)``
    (the JAX ``serve_run``, its arguments and report keys).

    ``requests`` must be serve_workload-style: ``job`` equal to its list
    index, arrivals non-decreasing. ``quotas``: per-tenant admission caps
    (0/absent = unlimited), enforced at ingest. Checkpointing and
    ``kill_after_saves`` mirror run_stream (a killed run returns early
    with ``report["killed"] = True``; resume by passing the loaded
    ``state=``/``stream=`` back with the SAME requests, quotas and
    policy). ``state`` and ``stream`` are left as they were: the run owns
    its copies. ``telemetry``: a utils.tracing.TelemetryWriter, one
    ``serve_interval`` row every ``telemetry_interval`` steps and a final
    ``serve_run`` row, each stamped with SERVE_SCHEMA_VERSION. Results
    come from ``runner.stream_results(stream)``; refused requests get no
    row (the report counts them per tenant). ``guards``: a utils/guards.
    RuntimeGuards arming the loop (default: the runner's); every
    intentional host<->device transfer in the loop goes through a named
    site.
    """
    from chandy_lamport_tpu_torch.utils.checkpoint import save_state

    policy = resolve_serve_policy(policy)
    if guards is None:
        guards = getattr(runner, "guards", None)
    if stretch < 1 or drain_chunk < 1:
        raise ValueError("stretch and drain_chunk must be >= 1")
    total = len(requests)
    for i, r in enumerate(requests):
        if r.job != i:
            raise ValueError("requests must be indexed by arrival order "
                             f"(request {i} has job id {r.job})")
        if i and r.arrival_step < requests[i - 1].arrival_step:
            raise ValueError("request arrivals must be non-decreasing")
    tenants = max([r.tenant for r in requests] or [0]) + 1
    if quotas is not None:
        tenants = max(tenants, len(quotas))
    quota_arr = np.zeros(tenants, np.int32)
    if quotas is not None:
        quota_arr[:len(quotas)] = np.asarray(quotas, np.int32)

    # ingest plan: pure in (requests, cache file, quotas), which is the
    # resume story (module docstring)
    pool = runner.pack_jobs([r.events for r in requests],
                            content_keys=True)
    digests = [bytes(row).hex() for row in pool.digest.cpu().numpy()]
    cache = runner._summary_cache()
    plan = plan_ingest(requests, digests, cache, quota_arr.tolist())
    n_exec = len(plan["exec"])
    rcap = int(results_capacity) if results_capacity else pool.num_jobs
    if rcap < n_exec:
        raise ValueError(
            f"serve needs results_capacity >= executed jobs ({n_exec}): "
            f"followers are fanned out from leaders' ring rows and resume "
            f"reconstructs the admitted set from the ring")

    dev = runner.device
    s = (runner.init_batch_device() if state is None
         else runner._own(state))
    resuming = stream is not None
    st = (runner.init_stream(pool, rcap, tenants=tenants,
                             tenant_quota=quota_arr)
          if stream is None else StreamState(*(x.clone() for x in stream)))
    runner._memo_rows = {}
    runner._fork_depths = []
    runner._prefix_stats = {"prefix_evictions": 0,
                            "prefix_evicted_bytes": 0,
                            "prefix_store_entries": 0}
    runner.memo_timing = {}

    arrival_host = np.asarray([r.arrival_step for r in requests], np.int32)

    def on_device(values):
        return torch.as_tensor(np.asarray(values, np.int32), device=dev)

    tenant_dev = on_device([r.tenant for r in requests])
    arrival_dev = on_device(arrival_host)
    deadline_dev = on_device([r.deadline_step for r in requests])
    exec_order = np.full(max(n_exec, 1), -1, np.int32)

    # prefix plane (runner memo="prefix"): the fork plan over the ingest
    # plan's exec set. The fork arrays are JOB-indexed, so the loop's
    # re-sort of the un-admitted exec-order suffix never invalidates
    # them. Planned and produced before the armed loop.
    pplan = None
    if runner.memo == "prefix":
        pplan = runner._prefix_plan(
            pool, {"exec": list(plan["exec"]), "shadows": set()}, None)

    # -- host books ------------------------------------------------------
    admitted: set = set()
    pending: set = set()
    arr_ptr = 0
    books = {"cache_served": 0, "refused_seen": 0}
    admit_all: List[int] = []
    admit_window: List[int] = []

    def ingest_upto(step_bound: int) -> None:
        """Take arrivals with arrival_step <= step_bound into the host
        books: cache hits are served on the spot, followers wait for
        their leader's harvest (the end of the run), refusals are only
        counted."""
        nonlocal arr_ptr
        while (arr_ptr < total
               and requests[arr_ptr].arrival_step <= step_bound):
            r = requests[arr_ptr]
            arr_ptr += 1
            status = plan["status"][r.job]
            if status == "exec":
                if r.job not in admitted:
                    pending.add(r.job)
            elif status == "cache":
                row = dict(plan["cache_hit"][r.job])
                row.update(job=r.job, admit_step=-1,
                           digest=digests[r.job], served_from="cache")
                runner._memo_rows[r.job] = row
                books["cache_served"] += 1
            elif status == "refused":
                books["refused_seen"] += 1

    consumed = steps_now = done_exec = 0
    if resuming:
        consumed, steps_now, done_exec = (
            int(x) for x in (st.next_job, st.steps, st.jobs_done))
        # rebuild the admitted set from the carry: every admission
        # landed either in the results ring or on a still-running lane
        ring_jobs = st.res_job.cpu().numpy()
        lane_jobs = s.job_id.cpu().numpy()
        admitted = {int(j) for j in
                    ring_jobs[:min(int(st.res_count), len(ring_jobs))]
                    if int(j) >= 0}
        admitted |= {int(j) for j in lane_jobs if int(j) >= 0}
        if len(admitted) != consumed:
            raise ValueError(
                f"resume carry inconsistent: next_job={consumed} but "
                f"{len(admitted)} admitted jobs reconstructed — was the "
                f"checkpoint taken with the same requests and capacity?")
        # order content below next_job is never read again; any fixed
        # deterministic fill keeps the array well-formed
        exec_order[:consumed] = np.asarray(sorted(admitted), np.int32)
    ingest_upto(steps_now)

    # -- warmup (serving.executables) ------------------------------------
    warm = {"warmup_s": 0.0, "source": None, "persisted": False}
    call = None
    fork_ops = (() if pplan is None
                else (pplan["bank"], pplan["fork_src"], pplan["fork_depth"]))
    if n_exec and done_exec < n_exec:
        exec_cache = exec_cache or ExecutableCache(None)
        call = exec_cache.step_for(
            runner, stretch, drain_chunk,
            (s, st, pool, exec_order, None, np.int32(0), tenant_dev,
             arrival_dev, deadline_dev) + fork_ops)
        warm = {"warmup_s": round(exec_cache.last["warmup_s"], 3),
                "source": exec_cache.last["source"],
                "persisted": exec_cache.last["persisted"]}

    def serve_books(g):
        # the port reads the books through a site of its own: a host
        # read of a CUDA tensor is a sync, which the armed loop forbids
        miss, served_t, live, lane_total = guarded_get(
            g, "serve-telemetry",
            (st.deadline_misses, st.tenant_served, st.lane_steps_live,
             st.lane_steps_total))
        return int(miss), served_t, int(live), int(lane_total)

    def telemetry_row(kind: str, extra: dict) -> None:
        if telemetry is None:
            return
        miss, served_t, live, lane_total = serve_books(guards)
        row = {"serve_schema": SERVE_SCHEMA_VERSION, "step": steps_now,
               "arrived": arr_ptr, "admitted": consumed,
               "harvested": done_exec, "pending": len(pending),
               "occupancy": round(live / max(lane_total, 1), 4),
               "deadline_misses": miss,
               "memo_hits": books["cache_served"],
               # share of the requests seen so far that the warm summary
               # cache served at ingest (followers count only in the
               # final report: they are served after their leader's
               # harvest)
               "memo_hit_rate": round(
                   books["cache_served"] / max(arr_ptr, 1), 4),
               "refused": books["refused_seen"],
               "tenant_served": np.asarray(served_t).astype(int).tolist(),
               "tenant_quota": quota_arr.astype(int).tolist()}
        row.update(extra)
        telemetry.write(kind, row)

    # -- the device loop -------------------------------------------------
    # armed when guards are on: no kernel build (the cache made them
    # ready), the exec-order suffix and limit go to the device through
    # named put sites and the one read per step is a named get site. The
    # carry and the whole exec order enter through explicit uploads.
    s, st = guarded_put(guards, "serve-carry-upload", (s, st), dev)
    order_dev = torch.as_tensor(exec_order, device=dev)
    saves = 0
    t_loop = time.perf_counter()
    with armed(guards):
        while done_exec < n_exec:
            if steps_now >= max_steps:
                raise RuntimeError(
                    f"serve_run: {n_exec - done_exec} of {n_exec} executed "
                    f"jobs unfinished after {max_steps} steps — raise "
                    f"max_steps")
            elig = order_eligible([requests[j] for j in sorted(pending)],
                                  policy)
            limit = consumed + len(elig)
            exec_order[consumed:limit] = np.asarray([r.job for r in elig],
                                                    np.int32)
            # only the rewritten suffix moves: positions below next_job
            # are never read again, those past limit not this step
            order_dev[consumed:limit] = guarded_put(
                guards, "serve-admission-order", exec_order[consumed:limit],
                dev)
            s, st = call(s, st, pool, order_dev, None,
                         guarded_put(guards, "serve-admission-limit",
                                     np.int32(limit), dev),
                         tenant_dev, arrival_dev, deadline_dev, *fork_ops)
            ingest_upto(steps_now + 1)
            prev = consumed
            consumed, steps_now, done_exec = (int(x) for x in guarded_get(
                guards, "serve-progress-scalars",
                (st.next_job, st.steps, st.jobs_done)))
            for pos in range(prev, consumed):
                j = int(exec_order[pos])
                admitted.add(j)
                pending.discard(j)
                lat = (steps_now - 1) - int(arrival_host[j])
                admit_all.append(lat)
                admit_window.append(lat)
            if (telemetry is not None and telemetry_interval
                    and steps_now % int(telemetry_interval) == 0):
                telemetry_row("serve_interval", _percentiles(admit_window))
                admit_window = []
            if (checkpoint and checkpoint_every
                    and steps_now % int(checkpoint_every) == 0):
                # save_state copies the whole carry to the host: an
                # intentional bulk read, booked by site
                with relaxed_site(guards, "checkpoint-save"):
                    save_state(checkpoint, (s, st),
                               meta={"stream_steps": steps_now,
                                     "jobs_done": done_exec,
                                     "serve_schema": SERVE_SCHEMA_VERSION},
                               delay=runner.delay)
                saves += 1
                if kill_after_saves is not None \
                        and saves >= int(kill_after_saves):
                    return s, st, {
                        "serve_schema": SERVE_SCHEMA_VERSION,
                        "killed": True, "steps": steps_now,
                        "saves": saves, **_fused_books(runner), **warm}
    wall_s = time.perf_counter() - t_loop

    # tail arrivals past the last harvest never need the device: the
    # plan makes them cache hits, followers or refusals
    ingest_upto(np.iinfo(np.int32).max)

    # -- finalize: write-back, follower fan-out, books -------------------
    ring = {r["job"]: r for r in _ring_rows(st)}
    summary_of = runner._summary_of
    for e in plan["exec"]:
        r = ring.get(e)
        if r is not None:
            cache.put(digests[e], summary_of(r))
    ncoal = 0
    for leader, fls in plan["followers"].items():
        r = ring.get(leader)
        if r is None or not fls:
            continue
        summ = summary_of(r)
        for j in fls:
            row = dict(summ)
            row.update(job=j, admit_step=-1, digest=digests[j],
                       served_from="coalesce")
            runner._memo_rows[j] = row
            ncoal += 1
    cache.flush()
    runner._memo_cache_stats = {"cache_evictions": cache.evictions,
                                "cache_evicted_bytes": cache.evicted_bytes}
    st = st._replace(
        cache_hits=torch.tensor(books["cache_served"], dtype=_i32,
                                device=dev),
        coalesced_jobs=torch.tensor(ncoal, dtype=_i32, device=dev))
    pref_books = {"prefix_hits": 0, "forked_jobs": 0,
                  "fork_depth_mean": 0.0}
    if pplan is not None:
        # fork provenance, the fork audit and the prefix store's flush:
        # run_stream's end (only plan["digests"] is read)
        s, st = runner._prefix_finalize(s, st, {"digests": digests}, pplan,
                                        pool, stretch, drain_chunk)
        fj, fds = int(st.forked_jobs), int(st.fork_depth_sum)
        pref_books = {"prefix_hits": int(st.prefix_hits),
                      "forked_jobs": fj,
                      "fork_depth_mean": round(fds / fj, 4) if fj
                      else 0.0}

    miss, served_t, live, lane_total = serve_books(None)
    nserved = n_exec + books["cache_served"] + ncoal
    report = {
        "serve_schema": SERVE_SCHEMA_VERSION, "killed": False,
        "policy": policy, "requests": total, "tenants": tenants,
        "steps": steps_now, "exec_jobs": n_exec,
        "served_cache": books["cache_served"], "served_coalesced": ncoal,
        "served_total": nserved, "refused_total": books["refused_seen"],
        "refused_by_tenant": {str(t): int(c)
                              for t, c in sorted(plan["refused"].items())},
        "occupancy": round(live / max(lane_total, 1), 4),
        "deadline_misses": miss,
        "memo_hit_rate": round(
            (books["cache_served"] + ncoal) / max(nserved, 1), 4),
        "tenant_served": np.asarray(served_t).astype(int).tolist(),
        "tenant_quota": quota_arr.astype(int).tolist(),
        "wall_s": round(wall_s, 3), **pref_books, **_percentiles(admit_all),
        "warmup_s": warm["warmup_s"], "warmup_source": warm["source"],
        "warmup_persisted": warm["persisted"],
        **_fused_books(runner),
    }
    if telemetry is not None:
        telemetry.write("serve_run", dict(report))
    return s, st, report
