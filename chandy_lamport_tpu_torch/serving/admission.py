"""Serving admission: policy resolution, queue ordering, the ingest plan
(the JAX package's ``serving/admission.py``; host code only).

Everything here is deliberately a PURE function of (requests, cache
file, quotas) or of the books the server re-derives from the device
carry — that purity is the whole kill->resume story. The server
(serving/server.py) recomputes the eligible ordering from scratch every
step, so admission decisions are memoryless: a resumed run that
reconstructs the same pending set and tenant books makes bit-identical
decisions without replaying the dead process's trajectory.

**Ingest plan** (``plan_ingest``): requests are classified in arrival
order. A tenant whose ``quota`` (0 = unlimited) is already filled by
earlier ACCEPTED requests has this request refused outright — refusal
is an ingest-time admission-control decision on the deterministic
arrival order, NOT a service-time race, so it never depends on how fast
the device happened to drain (and never starves the other tenants,
whose books are independent). Accepted requests then follow the memo
plane's classification: first appearance of a digest with a warm
``SummaryCache`` entry is served from the cache without ever burning a
lane; the first cold appearance becomes the digest's EXEC leader; later
appearances coalesce onto that leader and are served its harvested
summary.

**Queue ordering** (``order_eligible``): "edf" sorts by priority class
(higher first), then earliest absolute deadline, then arrival, then job
id — EDF within priority class; "fifo" is pure arrival order, the
baseline the bench A/Bs against.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from chandy_lamport_tpu_torch.config import ENGINE_KNOBS
from chandy_lamport_tpu_torch.models.workloads import ServeRequest
from chandy_lamport_tpu_torch.utils.memocache import SummaryCache


def resolve_serve_policy(policy: str) -> str:
    """Validate the ``serve_policy`` engine knob (config.ENGINE_KNOBS).
    Like ``memo`` there is no backend-dependent "auto": the spellings
    are explicit policies, so resolution is pure validation."""
    allowed = ENGINE_KNOBS["serve_policy"]
    if policy not in allowed:
        raise ValueError(
            f"serve_policy must be one of {', '.join(map(repr, allowed))}, "
            f"got {policy!r}")
    return policy


def admission_key(req: ServeRequest, policy: str):
    """The sort key one eligible request is ordered by. Total (job id is
    the final tiebreak), so the eligible ordering — and with it the whole
    serve trajectory — is deterministic."""
    if policy == "edf":
        return (-req.priority, req.deadline_step, req.arrival_step, req.job)
    return (req.arrival_step, req.job)


def order_eligible(eligible: Sequence[ServeRequest],
                   policy: str) -> List[ServeRequest]:
    """Order the arrived, quota-accepted, not-yet-admitted requests for
    the next stream step's admissible prefix."""
    policy = resolve_serve_policy(policy)
    return sorted(eligible, key=lambda r: admission_key(r, policy))


def shed_order(candidates: Sequence[ServeRequest]) -> List[ServeRequest]:
    """Deadline-aware load-shedding order: who to drop FIRST when the
    fleet must shrink its backlog (the JAX package's serving/fleet.py,
    not ported yet: ROADMAP A10b). The mirror image of the EDF
    admission key — the lowest priority class goes first, and within a
    class the LATEST deadline (the job with the most slack left, i.e.
    the least urgent investment) is dropped before tighter ones; latest
    arrival, then highest job id, break ties so the order is total and
    a resumed supervisor sheds the identical victims."""
    return sorted(candidates,
                  key=lambda r: (r.priority, -r.deadline_step,
                                 -r.arrival_step, -r.job))


def plan_ingest(requests: Sequence[ServeRequest], digests: Sequence[str],
                cache: SummaryCache,
                quotas: Optional[Sequence[int]] = None) -> dict:
    """Classify every request (module docstring) into
    ``exec`` (digest leader, runs on a lane), ``cache`` (served from the
    persistent summary cache at ingest), ``follower`` (coalesced onto an
    in-run leader) or ``refused`` (tenant over quota at its arrival).

    Returns a dict of parallel books:
      ``status``      [J] one of the four classifications
      ``leader_of``   [J] the follower's leader job (else -1)
      ``cache_hit``   {job: summary} for cache-served requests
      ``exec``        leader job ids, arrival order
      ``followers``   {leader: [follower jobs]}
      ``accepted``    {tenant: count accepted (not refused)}
      ``refused``     {tenant: count refused}
    Deterministic for a given (requests, cache file, quotas) — the cache
    file only changes at the END of a completed run (SummaryCache.flush),
    so a killed serve run re-plans identically on resume.
    """
    jcount = len(requests)
    if len(digests) != jcount:
        raise ValueError("one digest per request required")
    quotas = list(quotas) if quotas is not None else []
    status = ["exec"] * jcount
    leader_of = [-1] * jcount
    cache_hit: Dict[int, dict] = {}
    exec_jobs: List[int] = []
    followers: Dict[int, List[int]] = {}
    accepted: Dict[int, int] = {}
    refused: Dict[int, int] = {}
    leader: Dict[str, tuple] = {}   # digest -> ("exec", job)|("cache", summ)
    for r in requests:
        j, t = r.job, r.tenant
        quota = quotas[t] if t < len(quotas) else 0
        if quota and accepted.get(t, 0) >= quota:
            status[j] = "refused"
            refused[t] = refused.get(t, 0) + 1
            continue
        accepted[t] = accepted.get(t, 0) + 1
        dg = digests[j]
        led = leader.get(dg)
        if led is None:
            hit = cache.get(dg)
            if hit is not None:
                leader[dg] = ("cache", dict(hit))
                status[j] = "cache"
                cache_hit[j] = dict(hit)
            else:
                leader[dg] = ("exec", j)
                exec_jobs.append(j)
                followers[j] = []
        else:
            kind, ref = led
            if kind == "exec":
                status[j] = "follower"
                leader_of[j] = ref
                followers[ref].append(j)
            else:
                status[j] = "cache"
                cache_hit[j] = dict(ref)
    return {"status": status, "leader_of": leader_of,
            "cache_hit": cache_hit, "exec": exec_jobs,
            "followers": followers, "accepted": accepted,
            "refused": refused}
