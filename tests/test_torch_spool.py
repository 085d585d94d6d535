"""The port's write-ahead admission spool (``chandy_lamport_tpu_torch/
serving/spool.py``) against the JAX package's, on the CPU.

Every case of the JAX ``tests/test_spool.py`` runs on the port's spool
(the checkpoint kill of that file is the port's
``tests/test_torch_checkpoint.py``). Then the journal across the
packages: one transaction script under a fixed clock writes the same
bytes through both spools; a journal written by either package replays
in the other with equal ``counters()`` and ``audit()`` (and takes the
other's appends); ``request_digest`` is equal for 64 ``serve_workload``
requests; the JAX ``wal-append`` lint passes on the port's source; and the
``spool-append`` failpoint kill never acknowledges. Host code only; no
tolerance (bytes and integers).
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

from chandy_lamport_tpu.core import spec as jax_spec
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.serving import spool as jax_spool
from chandy_lamport_tpu_torch.core.spec import (
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.workloads import ServeRequest
from chandy_lamport_tpu_torch.serving import spool as port_spool
from chandy_lamport_tpu_torch.serving.spool import (
    WAL_SCHEMA_VERSION,
    AdmissionSpool,
    SpoolError,
    decode_events,
    decode_request,
    encode_events,
    encode_request,
    request_digest,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _req(job, arrival=0, tenant=0, priority=1, slack=32, tokens=2):
    return ServeRequest(
        job=job, arrival_step=arrival, tenant=tenant, priority=priority,
        deadline_step=arrival + slack,
        events=[PassTokenEvent(src="n0", dest="n1", tokens=tokens),
                SnapshotEvent(node_id="n0"), TickEvent(3)])


def _jreq(job, arrival=0, tenant=0, priority=1, slack=32, tokens=2):
    return jax_workloads.ServeRequest(
        job=job, arrival_step=arrival, tenant=tenant, priority=priority,
        deadline_step=arrival + slack,
        events=[jax_spec.PassTokenEvent(src="n0", dest="n1", tokens=tokens),
                jax_spec.SnapshotEvent(node_id="n0"),
                jax_spec.TickEvent(3)])


# ---- the JAX cases on the port's spool ------------------------------------

class TestEncoding:
    def test_event_roundtrip(self):
        evs = [PassTokenEvent(src="a", dest="b", tokens=5),
               SnapshotEvent(node_id="c"), TickEvent(7)]
        assert decode_events(encode_events(evs)) == evs

    def test_request_roundtrip(self):
        r = _req(3, arrival=9, tenant=2, priority=0)
        assert decode_request(encode_request(r)) == r

    def test_unknown_event_rows_refused(self):
        with pytest.raises(SpoolError):
            encode_events([object()])
        with pytest.raises(SpoolError):
            decode_events([["warp", 1]])

    def test_digest_is_content_pure(self):
        assert request_digest(_req(0)) == request_digest(_req(0))
        assert request_digest(_req(0)) != request_digest(_req(0, tokens=3))
        # job id participates (it is the journal's primary key)
        assert request_digest(_req(0)) != request_digest(_req(1))
        # and the hex is the JAX spool's
        assert request_digest(_req(4, tokens=3)) == \
            jax_spool.request_digest(_jreq(4, tokens=3))


class TestTransactions:
    def test_admit_ack_is_idempotent(self, tmp_path):
        sp = AdmissionSpool(str(tmp_path / "wal.jsonl"))
        assert sp.admit(_req(0)) is True
        assert sp.admit(_req(0)) is False
        assert sp.counters()["admitted"] == 1

    def test_admit_alias_refused(self, tmp_path):
        sp = AdmissionSpool(str(tmp_path / "wal.jsonl"))
        sp.admit(_req(0))
        with pytest.raises(SpoolError, match="different digest"):
            sp.admit(_req(0, tokens=9))

    def test_lease_order_and_exactly_once_complete(self, tmp_path):
        sp = AdmissionSpool(str(tmp_path / "wal.jsonl"))
        for j, arr in ((0, 5), (1, 0), (2, 3)):
            sp.admit(_req(j, arrival=arr))
        got = sp.lease("w0", limit=2, now=100.0)
        assert [r.job for r in got] == [1, 2]
        assert sp.complete(1, "w0", {"t": 1}, now=101.0) is True
        assert sp.complete(1, "w0", {"t": 1}, now=102.0) is False
        assert sp.complete(2, "w9", {"t": 2}, now=102.0) is False
        assert sp.pending() == [0]

    def test_renew_extends_only_own_live_leases(self, tmp_path):
        sp = AdmissionSpool(str(tmp_path / "wal.jsonl"), lease_ttl=10.0)
        sp.admit(_req(0))
        sp.admit(_req(1))
        sp.lease("w0", limit=1, now=0.0)
        assert sp.renew("w0", [0, 1], now=5.0) == [0]
        assert sp.leases[0]["expires"] == pytest.approx(15.0)
        assert sp.renew("w1", [0], now=5.0) == []

    def test_expiry_requeue_takeover_and_late_commit(self, tmp_path):
        sp = AdmissionSpool(str(tmp_path / "wal.jsonl"), lease_ttl=10.0)
        sp.admit(_req(0))
        sp.lease("w0", limit=1, now=0.0)
        assert sp.reclaim_expired(now=9.0) == {"requeued": [],
                                               "poisoned": []}
        assert sp.reclaim_expired(now=11.0)["requeued"] == [0]
        (takeover,) = sp.lease("w1", limit=1, now=12.0)
        assert takeover.job == 0
        assert sp.complete(0, "w0", {"t": 0}, now=13.0) is False
        assert sp.complete(0, "w1", {"t": 0}, now=13.0) is True
        assert sp.done_by[0] == "w1"
        assert sp.books["requeues"] == 1

    def test_poison_after_attempt_budget_with_provenance(self, tmp_path):
        sp = AdmissionSpool(str(tmp_path / "wal.jsonl"), lease_ttl=10.0,
                            max_attempts=2)
        sp.admit(_req(0))
        sp.lease("w0", limit=1, now=0.0)
        assert sp.reclaim_expired(now=11.0)["requeued"] == [0]
        sp.lease("w1", limit=1, now=12.0)
        assert sp.reclaim_expired(now=23.0)["poisoned"] == [0]
        trail = sp.poisoned[0]["errors"]
        assert len(trail) == 2
        assert "w0" in trail[0] and "attempt 1/2" in trail[0]
        assert "w1" in trail[1] and "attempt 2/2" in trail[1]
        assert sp.poisoned[0]["attempts"] == 2
        assert sp.lease("w2", limit=1, now=24.0) == []
        assert sp.complete(0, "w1", {"t": 0}, now=24.0) is False
        assert sp.finished()

    def test_requeue_worker_is_the_fast_death_path(self, tmp_path):
        sp = AdmissionSpool(str(tmp_path / "wal.jsonl"), lease_ttl=1000.0)
        sp.admit(_req(0))
        sp.admit(_req(1))
        sp.lease("w0", limit=2, now=0.0)
        out = sp.requeue_worker("w0", "worker w0 killed by SIGKILL",
                                now=1.0)
        assert out["requeued"] == [0, 1]
        assert sp.pending() == [0, 1]
        assert sp.errors[0] == ["worker w0 killed by SIGKILL"]

    def test_fail_releases_lease_and_records_provenance(self, tmp_path):
        sp = AdmissionSpool(str(tmp_path / "wal.jsonl"))
        sp.admit(_req(0))
        sp.lease("w0", limit=1, now=0.0)
        sp.fail(0, "w0", "compile exploded", now=1.0)
        assert sp.pending() == [0]
        assert sp.errors[0] == ["compile exploded"]
        sp.lease("w1", limit=1, now=2.0)
        sp.fail(0, "w0", "late report", now=3.0)
        assert sp.leases[0]["worker"] == "w1"

    def test_shed_drops_pending_only(self, tmp_path):
        sp = AdmissionSpool(str(tmp_path / "wal.jsonl"))
        for j in range(3):
            sp.admit(_req(j))
        sp.lease("w0", limit=1, now=0.0)
        assert sp.shed_jobs([0, 1, 2], "backlog over capacity",
                            now=1.0) == [1, 2]
        assert sp.shed == {1: "backlog over capacity",
                           2: "backlog over capacity"}

    def test_audit_conservation(self, tmp_path):
        sp = AdmissionSpool(str(tmp_path / "wal.jsonl"), lease_ttl=10.0,
                            max_attempts=1)
        for j in range(4):
            sp.admit(_req(j, arrival=j))
        sp.lease("w0", limit=1, now=0.0)
        sp.complete(0, "w0", {"t": 0}, now=1.0)
        sp.lease("w1", limit=1, now=2.0)
        sp.reclaim_expired(now=13.0)
        sp.shed_jobs([3], "pressure", now=14.0)
        audit = sp.audit()
        assert audit["admitted"] == 4
        assert audit["served"] == 1 and audit["poisoned"] == 1
        assert audit["shed"] == 1 and audit["pending"] == 1
        assert audit["lost"] == 0 and audit["double_served"] == 0
        assert audit["digests_ok"]

    def test_constructor_refusals(self, tmp_path):
        with pytest.raises(ValueError, match="lease_ttl"):
            AdmissionSpool(str(tmp_path / "w.jsonl"), lease_ttl=0)
        with pytest.raises(ValueError, match="max_attempts"):
            AdmissionSpool(str(tmp_path / "w.jsonl"), max_attempts=0)


class TestWalReplay:
    def test_rescan_is_idempotent_across_handles(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        sp = AdmissionSpool(path, lease_ttl=10.0)
        for j in range(3):
            sp.admit(_req(j, arrival=j))
        sp.lease("w0", limit=1, now=0.0)
        sp.complete(0, "w0", {"tokens": [1, 2]}, now=1.0)
        size = os.path.getsize(path)
        for _ in range(3):
            fresh = AdmissionSpool(path, lease_ttl=10.0)
            assert fresh.done == {0: {"tokens": [1, 2]}}
            assert fresh.pending() == [1, 2]
            assert fresh.books["torn_tail_truncated"] == 0
        assert os.path.getsize(path) == size

    def test_cross_handle_visibility(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        a = AdmissionSpool(path)
        b = AdmissionSpool(path)
        a.admit(_req(0))
        assert b.lease("wb", limit=1, now=0.0)[0].job == 0

    def test_torn_tail_truncated_and_skipped(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        sp = AdmissionSpool(path)
        sp.admit(_req(0))
        size = os.path.getsize(path)
        with open(path, "ab") as f:
            f.write(b'{"wal_schema": 1, "kind": "admit", "jo')
        fresh = AdmissionSpool(path)
        assert fresh.books["torn_tail_truncated"] == 1
        assert list(fresh.requests) == [0]
        assert os.path.getsize(path) == size
        assert fresh.admit(_req(1)) is True
        again = AdmissionSpool(path)
        assert sorted(again.requests) == [0, 1]
        assert again.books["torn_tail_truncated"] == 0

    def test_mid_file_damage_is_refused(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        sp = AdmissionSpool(path)
        sp.admit(_req(0))
        rec = {"wal_schema": WAL_SCHEMA_VERSION, "kind": "shed",
               "job": 0, "reason": "x", "t": 1.0}
        with open(path, "ab") as f:
            f.write(b"@@not json@@\n")
            f.write((json.dumps(rec) + "\n").encode())
        with pytest.raises(SpoolError, match="corrupt record at byte"):
            AdmissionSpool(path)
        with pytest.raises(SpoolError, match="corrupt record at byte"):
            sp.admit(_req(1))

    def test_stale_schema_is_refused_by_name(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        rec = {"wal_schema": WAL_SCHEMA_VERSION + 1, "kind": "admit",
               "job": 0, "digest": "0" * 64,
               "request": encode_request(_req(0)), "t": 0.0}
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
        with pytest.raises(SpoolError) as err:
            AdmissionSpool(path)
        assert "wal_schema" in str(err.value)
        assert path in str(err.value)

    def test_double_done_is_structurally_refused(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        sp = AdmissionSpool(path)
        sp.admit(_req(0))
        sp.lease("w0", limit=1, now=0.0)
        sp.complete(0, "w0", {"t": 0}, now=1.0)
        done = {"wal_schema": WAL_SCHEMA_VERSION, "kind": "done",
                "job": 0, "worker": "w1", "summary": {"t": 0}, "t": 2.0}
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(done) + "\n")
        with pytest.raises(SpoolError, match="double-serve"):
            AdmissionSpool(path)

    def test_record_for_unknown_job_refused(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        rec = {"wal_schema": WAL_SCHEMA_VERSION, "kind": "lease",
               "job": 7, "worker": "w0", "expires": 1.0, "attempt": 1,
               "t": 0.0}
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
        with pytest.raises(SpoolError, match="never admitted"):
            AdmissionSpool(path)


def _run_child(code: str, failpoint: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "CLSIM_IO_FAILPOINT": failpoint}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, timeout=120)


class TestKillInTheWindow:
    def test_memocache_kill_between_tmp_and_replace(self, tmp_path):
        from chandy_lamport_tpu_torch.utils.memocache import SummaryCache

        path = str(tmp_path / "memo.jsonl")
        old = SummaryCache(path)
        old.put("a" * 64, {"tokens": [1]})
        old.flush()
        before = open(path, encoding="utf-8").read()
        proc = _run_child(f"""
            import sys
            sys.path.insert(0, {ROOT!r})
            from chandy_lamport_tpu_torch.utils.memocache import (
                SummaryCache)
            c = SummaryCache({path!r})
            c.put("b" * 64, {{"tokens": [2]}})
            c.flush()
            raise SystemExit(3)   # unreachable: the failpoint kills us
        """, "memocache-replace")
        assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()
        assert open(path, encoding="utf-8").read() == before
        assert os.path.exists(path + ".tmp")
        nxt = SummaryCache(path)
        assert nxt.get("a" * 64) == {"tokens": [1]}
        assert nxt.get("b" * 64) is None
        nxt.put("c" * 64, {"tokens": [3]})
        nxt.flush()
        assert SummaryCache(path).get("c" * 64) == {"tokens": [3]}

    def test_spool_kill_before_append_never_acks(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        sp = AdmissionSpool(path)
        sp.admit(_req(0))
        size = os.path.getsize(path)
        proc = _run_child(f"""
            import sys
            sys.path.insert(0, {ROOT!r})
            from chandy_lamport_tpu_torch.serving.spool import (
                AdmissionSpool)
            from chandy_lamport_tpu_torch.models.workloads import (
                ServeRequest)
            from chandy_lamport_tpu_torch.core.spec import TickEvent
            sp = AdmissionSpool({path!r})
            sp.admit(ServeRequest(job=1, arrival_step=0, tenant=0,
                                  priority=1, deadline_step=32,
                                  events=[TickEvent(3)]))
            raise SystemExit(3)   # unreachable
        """, "spool-append")
        assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()
        # the ack never returned: job 1 is not in the journal, which is
        # still on a record boundary, and JAX's spool reads it the same
        assert os.path.getsize(path) == size
        fresh = AdmissionSpool(path)
        assert list(fresh.requests) == [0]
        assert fresh.books["torn_tail_truncated"] == 0
        assert list(jax_spool.AdmissionSpool(path).requests) == [0]
        assert fresh.admit(_req(1)) is True


# ---- the journal across the packages --------------------------------------

class _Clock:
    """A deterministic clock: 1000.0, 1000.5, 1001.0, ..."""

    def __init__(self):
        self.t = 999.5

    def __call__(self):
        self.t += 0.5
        return self.t


def _script(mod, reqs, path):
    """One transaction script touching every record kind, on ``mod``'s
    spool under a fixed clock (the constructor's for admit, explicit
    ``now`` for the rest). Returns the spool."""
    sp = mod.AdmissionSpool(path, lease_ttl=5.0, max_attempts=2,
                            clock=_Clock())
    for r in reqs:
        sp.admit(r)
    sp.admit(reqs[0])                                   # idempotent
    sp.lease("w0", limit=3, now=10.0)
    sp.renew("w0", [reqs[0].job, reqs[1].job], now=11.0)
    sp.complete(reqs[0].job, "w0",
                {"time": 12, "tokens": [3, 4], "errors_decoded": []},
                now=12.0)
    sp.fail(reqs[1].job, "w0", "boom", now=12.5)
    sp.requeue_worker("w0", "worker w0 killed by SIGKILL", now=13.0)
    sp.lease("w1", limit=2, now=14.0)
    sp.reclaim_expired(now=30.0)                        # requeue
    sp.lease("w2", limit=2, now=31.0)
    sp.reclaim_expired(now=40.0)                        # poison
    sp.shed_jobs([r.job for r in reqs[-2:]], "pressure", now=41.0)
    return sp


def _serve_pair(count=8, seed=5):
    """The same ``serve_workload`` requests from both packages."""
    jreqs = jax_workloads.serve_workload(
        jax_workloads.ring_topology(6), count, seed=seed, tenants=3,
        priorities=2, dup_rate=0.3, max_phases=6)
    preqs = workloads.serve_workload(
        workloads.ring_topology(6), count, seed=seed, tenants=3,
        priorities=2, dup_rate=0.3, max_phases=6)
    return jreqs, preqs


def test_fixed_clock_journals_are_byte_identical(tmp_path):
    """The same transaction script under the same injected clock writes
    the same bytes through the JAX spool and the port's."""
    jreqs, preqs = _serve_pair()
    jpath, ppath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    js = _script(jax_spool, jreqs, jpath)
    ps = _script(port_spool, preqs, ppath)
    jbytes, pbytes = open(jpath, "rb").read(), open(ppath, "rb").read()
    kinds = {json.loads(line)["kind"] for line in pbytes.splitlines()}
    assert kinds == {"admit", "lease", "renew", "done", "fail", "requeue",
                     "poison", "shed"}
    assert pbytes == jbytes
    assert ps.counters() == js.counters()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_in_the_other_package(tmp_path, writer):
    """A journal written by either package replays in the other with equal
    ``counters()``, ``audit()``, results and provenance; the reader's
    appends replay back in the writer's package."""
    jreqs, preqs = _serve_pair()
    path = str(tmp_path / "wal.jsonl")
    if writer == "jax":
        _script(jax_spool, jreqs, path)
        reader, back = port_spool, jax_spool
    else:
        _script(port_spool, preqs, path)
        reader, back = jax_spool, port_spool
    a = back.AdmissionSpool(path, lease_ttl=5.0, max_attempts=2)
    b = reader.AdmissionSpool(path, lease_ttl=5.0, max_attempts=2)
    assert b.counters() == a.counters()
    assert b.audit() == a.audit()
    assert b.audit()["lost"] == 0 and b.audit()["digests_ok"]
    assert b.results() == a.results() and b.poisoned == a.poisoned
    assert b.digests == a.digests and b.errors == a.errors
    # the reader's transactions land where the writer's package reads them
    (lease,) = b.lease("w9", limit=1, now=50.0)
    assert b.complete(lease.job, "w9", {"time": 1}, now=51.0)
    again = back.AdmissionSpool(path, lease_ttl=5.0, max_attempts=2)
    assert again.done_by[lease.job] == "w9"
    assert again.audit() == b.audit()


def test_request_digests_equal_jax():
    """``request_digest`` gives the JAX hex for 64 ``serve_workload``
    requests (duplicates among them)."""
    jreqs, preqs = _serve_pair(count=64, seed=11)
    got = [request_digest(r) for r in preqs]
    assert got == [jax_spool.request_digest(r) for r in jreqs]
    assert [encode_request(r) for r in preqs] == \
        [jax_spool.encode_request(r) for r in jreqs]


def test_wal_append_lint_passes_on_the_port_source():
    """The JAX ``wal-append`` rule (append-only, fsync discipline, under
    the lock) finds no violation in the port's spool."""
    from tools.staticcheck.ast_lint import SPOOL_PATH, check_wal_append

    with open(os.path.join(ROOT, "chandy_lamport_tpu_torch", "serving",
                           "spool.py"), encoding="utf-8") as f:
        source = f.read()
    assert check_wal_append({SPOOL_PATH: source}) == []
    # the rule bites on the same source with a raw write (a live lint)
    bad = source.replace("self._offset += fsync_append(f, line)",
                         "self._offset += f.write(line)")
    assert bad != source
    assert check_wal_append({SPOOL_PATH: bad})
