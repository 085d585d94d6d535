"""The write-ahead admission spool: crash-tolerant exactly-once intake
(the port's copy of the JAX package's ``serving/spool.py``).

A fleet of server workers (serving/fleet.py) shares one append-only
journal of admission records; every request is fsync-appended
(utils/atomicio.fsync_append, under the exclusive utils/filelock lock)
BEFORE the admit call returns, so an acknowledged request survives any
worker or supervisor SIGKILL.

**The journal is the JAX package's**: the same record kinds and keys,
written with ``sort_keys`` and the same separators, stamped with the same
``WAL_SCHEMA_VERSION`` — under the same injected ``clock`` both packages
write byte-identical files, a journal written by either replays in the
other, and ``request_digest`` gives the same hex for the same request.
It is host code: no tensor reaches a record.

**Record kinds** (JSON lines, each stamped ``wal_schema``):

  admit    the request payload + its content digest + wall-clock stamp —
           the durable acknowledgement. Re-admitting an identical
           (job, digest) is an idempotent no-op; the same job with a
           DIFFERENT digest is an aliasing bug and raises SpoolError.
  lease    job -> worker with an absolute expiry and the attempt number.
  renew    heartbeat: extends a live lease's expiry (same worker only).
  done     the exactly-once commit point: the served summary, accepted
           only while the writer still holds the lease. A journal with
           two done records for one job is a double-serve and replay
           refuses it loudly.
  fail     a worker-reported execution error; releases the lease and
           records provenance.
  requeue  a reclaimed lease (expiry, or the supervisor declaring the
           worker dead) — the job returns to the pending pool and the
           reason joins its provenance trail.
  poison   quarantine after the attempt budget: the job leaves the
           pending pool forever, carrying its full decoded error
           provenance instead of crash-looping the fleet.
  shed     deadline-aware load shedding (serving/admission.shed_order):
           dropped under backlog pressure, with the reason recorded.

**Concurrency + crash model.** Every mutating operation runs the same
transaction under the exclusive lock: incrementally replay the journal
tail (other processes may have appended since we last looked), decide
against the replayed state, append, apply. Appends are whole fsynced
lines, so the only torn shape a SIGKILL can leave is a newline-less
prefix at EOF — replay truncates it away and counts it
(``torn_tail_truncated``). Damage anywhere else — unparsable records
mid-file, a missing/foreign ``wal_schema`` — raises ``SpoolError`` naming
the path: a spool that guessed would re-serve or drop requests silently.

**Exactly-once.** Execution is at-least-once (a reclaimed lease's job
runs again elsewhere), but *serving* is exactly-once: ``complete`` is
the only path to a done record, it verifies lease ownership under the
lock, and replay rejects a second done structurally. A slow-but-alive
worker whose lease was taken over gets ``False`` back and discards its
late result. ``audit()`` re-derives the whole ledger from byte zero and
proves the conservation law: admitted == served + poisoned + shed +
still-pending + still-leased, with zero double-serves.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

from chandy_lamport_tpu_torch.core.spec import (
    Event,
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.models.workloads import ServeRequest
from chandy_lamport_tpu_torch.utils.atomicio import (
    crash_failpoint,
    fsync_append,
)
from chandy_lamport_tpu_torch.utils.filelock import locked

# THE spool journal schema version: one named registry constant, bumped
# on any breaking change of the record layout (an old journal must be
# refused, not misread — it arbitrates exactly-once serving).
WAL_SCHEMA_VERSION = 1


class SpoolError(ValueError):
    """The admission spool journal could not be read, validated or
    safely appended to. Always carries the path; raised instead of
    guessing — a spool that guesses loses or double-serves requests."""


# ---------------------------------------------------------------------------
# request (de)serialization — the WAL payload encoding


def encode_events(events: Sequence[Event]) -> List[list]:
    """Event list -> JSON-able rows (``["pass", src, dest, n]``,
    ``["snap", node]``, ``["tick", n]``)."""
    rows: List[list] = []
    for ev in events:
        if isinstance(ev, PassTokenEvent):
            rows.append(["pass", ev.src, ev.dest, int(ev.tokens)])
        elif isinstance(ev, SnapshotEvent):
            rows.append(["snap", ev.node_id])
        elif isinstance(ev, TickEvent):
            rows.append(["tick", int(ev.n)])
        else:
            raise SpoolError(
                f"cannot journal event {ev!r}: unknown event type "
                f"{type(ev).__name__}")
    return rows


def decode_events(rows: Sequence[list]) -> List[Event]:
    """Inverse of encode_events; unknown tags raise SpoolError."""
    out: List[Event] = []
    for row in rows:
        tag = row[0] if row else None
        if tag == "pass":
            out.append(PassTokenEvent(src=row[1], dest=row[2],
                                      tokens=int(row[3])))
        elif tag == "snap":
            out.append(SnapshotEvent(node_id=row[1]))
        elif tag == "tick":
            out.append(TickEvent(int(row[1])))
        else:
            raise SpoolError(f"cannot decode journaled event row {row!r}")
    return out


def encode_request(req: ServeRequest) -> dict:
    return {"job": int(req.job), "arrival_step": int(req.arrival_step),
            "tenant": int(req.tenant), "priority": int(req.priority),
            "deadline_step": int(req.deadline_step),
            "events": encode_events(req.events)}


def decode_request(d: dict) -> ServeRequest:
    return ServeRequest(job=int(d["job"]),
                        arrival_step=int(d["arrival_step"]),
                        tenant=int(d["tenant"]),
                        priority=int(d["priority"]),
                        deadline_step=int(d["deadline_step"]),
                        events=decode_events(d["events"]))


def request_digest(req: ServeRequest) -> str:
    """The spool's content address for one request: sha256 over the
    canonical journal encoding, the JAX package's hex for the same
    request (the supervisor admits without building an engine); distinct
    from the memo plane's
    job_digest, which additionally folds in topology/config/knobs — this
    digest arbitrates WAL idempotency, that one arbitrates summary
    reuse."""
    blob = json.dumps({"wal_schema": WAL_SCHEMA_VERSION,
                       "request": encode_request(req)},
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# the spool


class AdmissionSpool:
    """One process's handle on the shared journal (module docstring).

    ``lease_ttl`` is the heartbeat horizon in seconds — a worker that
    neither renews nor completes within it is presumed dead and its
    jobs are redelivered. ``max_attempts`` bounds redelivery before
    quarantine. ``clock`` is injectable for deterministic tests; it must
    be a wall clock shared across cooperating processes (the default).
    """

    def __init__(self, path: str, *, lease_ttl: float = 10.0,
                 max_attempts: int = 3,
                 clock: Callable[[], float] = time.time):
        if lease_ttl <= 0:
            raise ValueError("lease_ttl must be > 0 seconds")
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.path = path
        self.lease_ttl = float(lease_ttl)
        self.max_attempts = int(max_attempts)
        self.clock = clock
        self._offset = 0
        self.requests: Dict[int, ServeRequest] = {}
        self.digests: Dict[int, str] = {}
        self.admit_t: Dict[int, float] = {}
        self.leases: Dict[int, dict] = {}     # job -> {worker, expires}
        self.attempts: Dict[int, int] = {}
        self.done: Dict[int, dict] = {}       # job -> summary
        self.done_by: Dict[int, str] = {}
        self.done_t: Dict[int, float] = {}
        self.errors: Dict[int, List[str]] = {}
        self.poisoned: Dict[int, dict] = {}   # job -> {attempts, errors}
        self.shed: Dict[int, str] = {}        # job -> reason
        self.books = {"torn_tail_truncated": 0, "requeues": 0,
                      "leases": 0, "renews": 0}
        if os.path.exists(path):
            with locked(path):
                self._replay()

    # -- journal mechanics (always under the exclusive lock) -------------

    def _replay(self) -> None:
        """Incrementally scan the journal from the last consumed offset.
        MUST run under the exclusive lock (it may truncate a torn tail,
        and the decisions layered on it assume no concurrent append)."""
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                blob = f.read()
        except FileNotFoundError:
            return
        pos = 0
        while pos < len(blob):
            nl = blob.find(b"\n", pos)
            if nl < 0:
                # a crashed writer's partial append: fsynced whole lines
                # mean a prefix-without-newline at EOF is the ONLY legal
                # torn shape — truncate it so the next append lands on a
                # record boundary (telemetry's torn-line discipline)
                os.truncate(self.path, self._offset + pos)
                self.books["torn_tail_truncated"] += 1
                self._offset += pos
                return
            line = blob[pos:nl]
            at = self._offset + pos
            pos = nl + 1
            if not line.strip():
                continue
            try:
                rec = json.loads(line.decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as exc:
                raise SpoolError(
                    f"admission spool {self.path}: corrupt record at "
                    f"byte {at} ({exc}) — damage before the final record "
                    f"cannot be a torn append; refusing to guess") from exc
            if not isinstance(rec, dict) or "kind" not in rec \
                    or "wal_schema" not in rec:
                raise SpoolError(
                    f"admission spool {self.path}: record at byte {at} "
                    f"has no kind/wal_schema keys — not a spool record")
            if rec["wal_schema"] != WAL_SCHEMA_VERSION:
                raise SpoolError(
                    f"admission spool {self.path}: record at byte {at} "
                    f"has wal_schema {rec['wal_schema']!r}; this build "
                    f"reads only v{WAL_SCHEMA_VERSION} — a stale or "
                    f"future journal must not arbitrate exactly-once "
                    f"serving; migrate or remove it")
            self._apply(rec)
        self._offset += pos

    def _apply(self, rec: dict) -> None:
        kind = rec["kind"]
        j = int(rec["job"])
        if kind == "admit":
            if j in self.requests:
                if self.digests[j] != rec["digest"]:
                    raise SpoolError(
                        f"admission spool {self.path}: job {j} admitted "
                        f"twice with different digests — job ids alias "
                        f"two distinct requests")
                return
            self.requests[j] = decode_request(rec["request"])
            self.digests[j] = rec["digest"]
            self.admit_t[j] = float(rec["t"])
            self.errors.setdefault(j, [])
            return
        if j not in self.requests:
            raise SpoolError(
                f"admission spool {self.path}: {kind} record for job {j} "
                f"which was never admitted")
        if kind == "lease":
            self.leases[j] = {"worker": rec["worker"],
                              "expires": float(rec["expires"])}
            self.attempts[j] = int(rec["attempt"])
            self.books["leases"] += 1
        elif kind == "renew":
            lease = self.leases.get(j)
            if lease is not None and lease["worker"] == rec["worker"]:
                lease["expires"] = float(rec["expires"])
            self.books["renews"] += 1
        elif kind == "done":
            if j in self.done:
                raise SpoolError(
                    f"admission spool {self.path}: two done records for "
                    f"job {j} — a double-serve reached the journal")
            self.done[j] = rec["summary"]
            self.done_by[j] = rec["worker"]
            self.done_t[j] = float(rec["t"])
            self.leases.pop(j, None)
        elif kind == "fail":
            self.errors.setdefault(j, []).append(rec["error"])
            lease = self.leases.get(j)
            if lease is not None and lease["worker"] == rec["worker"]:
                self.leases.pop(j)
        elif kind == "requeue":
            self.errors.setdefault(j, []).append(rec["reason"])
            self.leases.pop(j, None)
            self.books["requeues"] += 1
        elif kind == "poison":
            self.poisoned[j] = {"attempts": int(rec["attempts"]),
                                "errors": list(rec["errors"])}
            self.leases.pop(j, None)
        elif kind == "shed":
            self.shed[j] = rec["reason"]
            self.leases.pop(j, None)
        else:
            raise SpoolError(
                f"admission spool {self.path}: unknown record kind "
                f"{kind!r}")

    def _append(self, rec: dict) -> None:
        """Durably append one record and apply it. Lock must be held;
        the fsync completes before return, so callers may acknowledge."""
        rec = {"wal_schema": WAL_SCHEMA_VERSION, **rec}
        line = (json.dumps(rec, sort_keys=True, separators=(",", ":"))
                + "\n").encode("utf-8")
        crash_failpoint("spool-append")
        with open(self.path, "ab") as f:
            self._offset += fsync_append(f, line)
        self._apply(rec)

    # -- views (of the last replayed state; call refresh() first when
    #    cross-process freshness matters) --------------------------------

    def refresh(self) -> None:
        """Fold in records other processes appended since we last
        looked."""
        with locked(self.path):
            self._replay()

    def pending(self) -> List[int]:
        """Admitted jobs currently owned by no one — leasable."""
        return sorted(j for j in self.requests
                      if j not in self.leases and j not in self.done
                      and j not in self.poisoned and j not in self.shed)

    def finished(self) -> bool:
        """Every admitted request reached a terminal state (served,
        poisoned or shed)."""
        return (len(self.done) + len(self.poisoned) + len(self.shed)
                == len(self.requests))

    def results(self) -> Dict[int, dict]:
        return dict(self.done)

    def counters(self) -> dict:
        """Telemetry snapshot of the replayed ledger."""
        return {"admitted": len(self.requests), "served": len(self.done),
                "poisoned": len(self.poisoned), "shed": len(self.shed),
                "pending": len(self.pending()), "leased": len(self.leases),
                **self.books}

    # -- transactions ----------------------------------------------------

    def admit(self, req: ServeRequest, digest: Optional[str] = None,
              now: Optional[float] = None) -> bool:
        """Durably admit one request; returns True when this call wrote
        the record, False when an identical admit already exists (the
        idempotent re-send after a crashed ack). The fsync completes
        before return — returning IS the acknowledgement."""
        digest = digest if digest is not None else request_digest(req)
        with locked(self.path):
            self._replay()
            if req.job in self.requests:
                if self.digests[req.job] != digest:
                    raise SpoolError(
                        f"admission spool {self.path}: job {req.job} "
                        f"already admitted with a different digest — "
                        f"refusing to alias two requests onto one id")
                return False
            self._append({"kind": "admit", "job": int(req.job),
                          "digest": digest,
                          "request": encode_request(req),
                          "t": self.clock() if now is None else now})
            return True

    def lease(self, worker: str, limit: int = 1,
              now: Optional[float] = None) -> List[ServeRequest]:
        """Take up to ``limit`` pending jobs for ``worker``, in
        deterministic (arrival, job) order, each with an fsynced lease
        record expiring ``lease_ttl`` from now."""
        with locked(self.path):
            self._replay()
            now = self.clock() if now is None else now
            out: List[ServeRequest] = []
            order = sorted(self.pending(),
                           key=lambda j: (self.requests[j].arrival_step, j))
            for j in order[:max(int(limit), 0)]:
                self._append({"kind": "lease", "job": j, "worker": worker,
                              "expires": now + self.lease_ttl,
                              "attempt": self.attempts.get(j, 0) + 1,
                              "t": now})
                out.append(self.requests[j])
            return out

    def renew(self, worker: str, jobs: Sequence[int],
              now: Optional[float] = None) -> List[int]:
        """Heartbeat: extend the expiry of the leases ``worker`` still
        holds. Returns the jobs actually renewed — a job missing from
        the return was reclaimed (or finished) and the worker should
        abandon it."""
        with locked(self.path):
            self._replay()
            now = self.clock() if now is None else now
            renewed: List[int] = []
            for j in jobs:
                lease = self.leases.get(int(j))
                if lease is not None and lease["worker"] == worker:
                    self._append({"kind": "renew", "job": int(j),
                                  "worker": worker,
                                  "expires": now + self.lease_ttl,
                                  "t": now})
                    renewed.append(int(j))
            return renewed

    def complete(self, job: int, worker: str, summary: dict,
                 now: Optional[float] = None) -> bool:
        """The exactly-once commit: record the served summary iff
        ``worker`` still holds the lease and the job has no terminal
        record. Returns False (result must be discarded) when the lease
        was reclaimed — the redelivered copy owns the serve now."""
        with locked(self.path):
            self._replay()
            job = int(job)
            if job in self.done or job in self.poisoned or job in self.shed:
                return False
            lease = self.leases.get(job)
            if lease is None or lease["worker"] != worker:
                return False
            self._append({"kind": "done", "job": job, "worker": worker,
                          "summary": summary,
                          "t": self.clock() if now is None else now})
            return True

    def fail(self, job: int, worker: str, error: str,
             now: Optional[float] = None) -> None:
        """Record a worker-reported execution failure and release the
        lease; the job returns to the pending pool (or is poisoned at
        the next reclaim if its attempt budget is spent)."""
        with locked(self.path):
            self._replay()
            lease = self.leases.get(int(job))
            if lease is None or lease["worker"] != worker:
                return
            self._append({"kind": "fail", "job": int(job), "worker": worker,
                          "error": str(error),
                          "t": self.clock() if now is None else now})

    def _requeue_or_poison(self, j: int, reason: str, now: float) -> str:
        if self.attempts.get(j, 0) >= self.max_attempts:
            self._append({"kind": "poison", "job": j,
                          "attempts": self.attempts.get(j, 0),
                          "errors": self.errors.get(j, []) + [reason],
                          "t": now})
            return "poisoned"
        self._append({"kind": "requeue", "job": j, "reason": reason,
                      "from_worker": self.leases[j]["worker"], "t": now})
        return "requeued"

    def reclaim_expired(self, now: Optional[float] = None) -> dict:
        """Redeliver every job whose lease expired without a heartbeat:
        requeue (the takeover path) or poison once the attempt budget is
        spent. Returns ``{"requeued": [...], "poisoned": [...]}``."""
        with locked(self.path):
            self._replay()
            now = self.clock() if now is None else now
            out = {"requeued": [], "poisoned": []}
            for j in sorted(self.leases):
                lease = self.leases[j]
                if lease["expires"] <= now:
                    verdict = self._requeue_or_poison(
                        j, f"lease expired on worker {lease['worker']} "
                           f"(attempt {self.attempts.get(j, 0)}"
                           f"/{self.max_attempts})", now)
                    out[verdict].append(j)
            return out

    def requeue_worker(self, worker: str, reason: str,
                       now: Optional[float] = None) -> dict:
        """Redeliver every lease ``worker`` holds, without waiting for
        expiry — the supervisor's fast path when it has direct evidence
        of death (exit code / signal), which becomes the provenance."""
        with locked(self.path):
            self._replay()
            now = self.clock() if now is None else now
            out = {"requeued": [], "poisoned": []}
            for j in sorted(self.leases):
                if self.leases[j]["worker"] == worker:
                    out[self._requeue_or_poison(j, reason, now)].append(j)
            return out

    def shed_jobs(self, jobs: Sequence[int], reason: str,
                  now: Optional[float] = None) -> List[int]:
        """Drop pending (never in-flight) jobs under load pressure; the
        caller picks victims with serving/admission.shed_order."""
        with locked(self.path):
            self._replay()
            now = self.clock() if now is None else now
            pend = set(self.pending())
            out: List[int] = []
            for j in jobs:
                if int(j) in pend:
                    self._append({"kind": "shed", "job": int(j),
                                  "reason": reason, "t": now})
                    out.append(int(j))
            return out

    # -- the audit -------------------------------------------------------

    def audit(self) -> dict:
        """Re-derive the ledger from byte zero in a fresh handle and
        prove the conservation law (module docstring): no admitted
        request is lost, none is double-served. Replay itself refuses a
        journal with two done records, so a returned audit always
        carries ``double_served == 0``; ``lost`` counts admits with no
        surviving state of any kind (impossible unless the journal was
        tampered with — it is the invariant the chaos harness pins)."""
        fresh = AdmissionSpool(self.path, lease_ttl=self.lease_ttl,
                               max_attempts=self.max_attempts,
                               clock=self.clock)
        accounted = (len(fresh.done) + len(fresh.poisoned)
                     + len(fresh.shed) + len(fresh.pending())
                     + len(fresh.leases))
        return {"admitted": len(fresh.requests), "served": len(fresh.done),
                "poisoned": len(fresh.poisoned), "shed": len(fresh.shed),
                "pending": len(fresh.pending()),
                "leased": len(fresh.leases),
                "lost": len(fresh.requests) - accounted,
                "double_served": 0,
                "torn_tail_truncated": fresh.books["torn_tail_truncated"],
                "digests_ok": all(
                    fresh.digests[j] == request_digest(fresh.requests[j])
                    for j in fresh.requests)}
