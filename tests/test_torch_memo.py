"""The port's memo plane (``BatchedRunner(memo=...)``, utils/memocache.py)
against the JAX package's, on the CPU.

What is held to the JAX package, in-process: the digest recipes
(``job_digest``, ``prefix_seed_digest``, ``prefix_extend``) byte for byte
on the same ingredients; which jobs share a digest (the port's digests
hash the port's own knobs, so their values differ from the JAX ones, but
never their equalities); the admission plan; the summary cache (its LRU,
byte bounds, the damaged-file refusals with the JAX messages, merging
flushes, and files crossing between the packages both ways); the lane
signature (the ``sig`` leaf) against the JAX ``_lane_signature`` under
``vmap``; and ``run_stream`` under "admit" and "full" on both schedulers,
every leaf of the final lane state and ``StreamState`` equal (``sig``,
the memo counters and the recorder's rings included) and every result
row equal except the ``digest`` value. Then fast-forwarding on the
livelocked drain, a killed memo stream resumed from its checkpoint, and
the recorder's EV_LANE_COALESCE and EV_MEMO_HIT sites. Tolerance: none
(integer state). The prefix plane is in test_torch_prefix.py, the
``stream --memo`` command line in test_torch_surface.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.spec import SnapshotEvent as JaxSnapshotEvent
from chandy_lamport_tpu.core.state import DenseState as JaxDenseState
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import make_fast_delay
from chandy_lamport_tpu.parallel import batch as jax_batch
from chandy_lamport_tpu.utils import memocache as jax_memocache
from chandy_lamport_tpu.utils.fixtures import TopologySpec as JaxTopologySpec
from chandy_lamport_tpu.utils.tracing import JaxTrace
from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
from chandy_lamport_tpu_torch.core.spec import SnapshotEvent
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import GoExactDelay, HashDelay
from chandy_lamport_tpu_torch.parallel.batch import (
    _lane_signature,
    compile_events,
)
from chandy_lamport_tpu_torch.utils import memocache
from chandy_lamport_tpu_torch.utils.carry import (
    pool_to_numpy,
    state_to_numpy,
    stream_to_numpy,
)
from chandy_lamport_tpu_torch.utils.checkpoint import load_state
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec
from chandy_lamport_tpu_torch.utils.tracing import (
    EV_LANE_COALESCE,
    EV_MEMO_HIT,
    Trace,
    decode_trace,
)
from test_torch_stream import _assert_leaves_equal, _port_job

# the JAX tests/test_memo.py shapes: ring-8, hash delay 11, J=10 jobs at
# duplicate rate 0.6 (4 distinct scripts) over B=4 lanes
CFG = dict(snapshots=4, max_recorded=128)
J, B, NUNIQ = 10, 4, 4
RUN = dict(stretch=3, drain_chunk=16)


def _jobs(seed=5):
    return jax_workloads.stream_jobs(jax_workloads.ring_topology(8), J,
                                     seed=seed, base_phases=3,
                                     max_phases=12, dup_rate=0.6)


def _pair(scheduler="sync", memo="admit", faults=False, trace=False,
          **kw):
    """The JAX runner and the port's twin, ring-8."""
    jr = jax_batch.BatchedRunner(
        jax_workloads.ring_topology(8), JaxSimConfig.for_workload(**CFG),
        make_fast_delay("hash", 11), B, scheduler=scheduler, memo=memo,
        faults=JaxFaults(7, drop_rate=0.05, dup_rate=0.05) if faults
        else None, quarantine=faults, trace=JaxTrace() if trace else None,
        **kw)
    pr = BatchedRunner(
        workloads.ring_topology(8), SimConfig.for_workload(**CFG),
        HashDelay(11), B, scheduler=scheduler, device="cpu", memo=memo,
        faults=Faults(7, drop_rate=0.05, dup_rate=0.05) if faults
        else None, quarantine=faults, trace=Trace() if trace else None,
        **kw)
    return jr, pr


def _strip_digest(rows):
    return [{k: v for k, v in r.items() if k != "digest"} for r in rows]


def _strip(rows):
    """The keys every memo arm shares with the memo-off oracle."""
    return [{k: v for k, v in r.items()
             if k not in ("admit_step", "digest", "served_from")}
            for r in rows]


def _assert_runs_equal(jr, jout, pr, pout):
    """Final lane state and stream carry leaf for leaf, result rows
    except the digest value, and the summary counters."""
    (js, jst), (ps, pst) = jout, pout
    _assert_leaves_equal(jax.device_get(js), state_to_numpy(ps, pr.delay),
                         "state")
    _assert_leaves_equal(jax.device_get(jst), stream_to_numpy(pst),
                         "stream")
    assert _strip_digest(pr.stream_results(pst)) == \
        _strip_digest(jr.stream_results(jst))
    assert pr.summarize_stream(pst) == jr.summarize_stream(jst)


def _equalities(digests):
    rows = [bytes(np.asarray(d, np.uint8)) for d in digests]
    return [[a == b for b in rows] for a in rows]


# ---- the digests -----------------------------------------------------------

def test_digest_functions_equal_jax():
    """``job_digest``, ``prefix_seed_digest`` and ``prefix_extend`` give
    the JAX bytes on the same ingredients (arrays, numpy scalars, a delay
    row of words and treedef, knobs with None and a sorted item list,
    each package's TopologySpec)."""
    script = (np.arange(6, dtype=np.int32).reshape(2, 3),
              np.ones((2, 3), np.int32), np.zeros((2, 3), np.int32),
              np.array([1, 9], np.int32))
    delay_row = {"treedef": "PyTreeDef((*, *, *))",
                 "leaves": [np.uint32(4294967295), np.uint32(7),
                            np.array([1, 2], np.uint32)]}
    knobs = {"megatick": 8, "faults": sorted({"seed": 3,
                                              "drop_rate": 0.05}.items()),
             "quarantine": True, "x": None}
    config = {"max_ticks": 100, "record_dtype": "int16"}
    nodes, links = [("b", 3), ("a", 2)], [("a", "b"), ("b", "a")]
    for fn, extra in (("job_digest", {"script": script}),
                      ("prefix_seed_digest", {})):
        kw = dict(fault_key=4294967295, delay_row=delay_row,
                  scheduler="exact", knobs=knobs, config_fields=config,
                  **extra)
        want = getattr(jax_memocache, fn)(
            topo_spec=JaxTopologySpec(nodes, links), **kw)
        got = getattr(memocache, fn)(topo_spec=TopologySpec(nodes, links),
                                     **kw)
        assert got == want, fn
    seed = memocache.prefix_seed_digest(
        topo_spec=TopologySpec(nodes, links), fault_key=0,
        delay_row=delay_row, scheduler="sync", knobs={}, config_fields={})
    row = (script[0][0], script[1][0], script[2][0], int(script[3][0]))
    assert memocache.prefix_extend(seed, row) == \
        jax_memocache.prefix_extend(seed, row)
    assert memocache.resolve_memo("prefix") == "prefix"
    with pytest.raises(ValueError, match="memo must be one of"):
        memocache.resolve_memo("auto")


@pytest.mark.parametrize("scheduler,faults", [
    ("sync", False), ("exact", True)], ids=["sync", "exact-faulted"])
def test_pools_share_digests_as_jax(scheduler, faults):
    """A content-keyed pool (ring-8, duplicate rate 0.6; the adversary
    armed on every third job): the same jobs share a digest in both
    packages (four distinct ones unarmed); every other leaf of the pool
    equals the JAX pool's; and a change of scheduler, seed or knob moves every
    digest."""
    jr, pr = _pair(scheduler, faults=faults)
    jobs = _jobs()
    armed = [j % 3 == 0 for j in range(J)] if faults else None
    want = jax.device_get(jr.pack_jobs(jobs, fault_armed=armed))
    pool = pr.pack_jobs([_port_job(j) for j in jobs], fault_armed=armed)
    got = pool_to_numpy(pool, pr.delay)
    assert _equalities(got.digest) == _equalities(want.digest)
    # a duplicate armed where its leader is not runs another computation
    assert len({bytes(d) for d in got.digest}) == (6 if faults else NUNIQ)
    assert not (got.digest == 0).all(axis=1).any()
    _assert_leaves_equal(want._replace(digest=(), prefix_digest=()),
                         got._replace(digest=(), prefix_digest=()), "pool")
    off = pr.pack_jobs([_port_job(j) for j in jobs], fault_armed=armed,
                       content_keys=False)
    assert int(off.digest.abs().sum()) == 0
    for other in (
            BatchedRunner(workloads.ring_topology(8),
                          SimConfig.for_workload(**CFG), HashDelay(11), B,
                          scheduler="sync" if faults else "exact",
                          device="cpu", memo="admit"),
            BatchedRunner(workloads.ring_topology(8),
                          SimConfig.for_workload(**CFG), HashDelay(12), B,
                          scheduler=scheduler, device="cpu", memo="admit"),
            BatchedRunner(workloads.ring_topology(8),
                          SimConfig.for_workload(**CFG), HashDelay(11), B,
                          scheduler=scheduler, device="cpu", memo="admit",
                          check_every=2)):
        moved = other.pack_jobs([_port_job(j) for j in jobs],
                                content_keys=True).digest.numpy()
        assert not ({bytes(d) for d in moved}
                    & {bytes(d) for d in got.digest})


def test_plan_equals_jax(tmp_path):
    """``_memo_plan`` (shadow every 3rd served job) equals the JAX plan
    on a cold cache: exec order, follower counts, served jobs with their
    source and leader, shadows; and on a cache each package warmed with
    its own run, the same hits."""
    jr, pr = _pair(memo="admit")
    jobs = _jobs()
    jpool = jr.pack_jobs(jobs)
    ppool = pr.pack_jobs([_port_job(j) for j in jobs])

    def shape(plan):
        return (plan["exec"], plan["follower_counts"],
                [(j, src, ref if src == "coalesce" else None)
                 for j, src, _, ref in plan["served"]],
                sorted(plan["shadows"]))

    assert shape(pr._memo_plan(ppool, 3)) == shape(jr._memo_plan(jpool, 3))
    for runner, pool, name in ((jr, jpool, "jax"), (pr, ppool, "port")):
        runner.memo_cache_path = str(tmp_path / f"{name}.jsonl")
        runner.run_stream(pool, **RUN)
    warm = (shape(pr._memo_plan(ppool, 3)), shape(jr._memo_plan(jpool, 3)))
    assert warm[0] == warm[1]
    assert warm[0][0] == [0, 3, 6, 9]    # the shadows alone execute
    with pytest.raises(ValueError, match="content-addressed"):
        pr._memo_plan(pr.pack_jobs([_port_job(j) for j in jobs],
                                   content_keys=False), None)


# ---- the summary cache --------------------------------------------------------

def _summ(t):
    return {"time": int(t), "error": 0, "tokens": [t, t + 1],
            "snapshots_started": 1}


def test_cache_lru_and_byte_bounds(tmp_path):
    """The LRU: a get refreshes recency, the entry bound evicts the
    least recent (counted); the byte bound caps the flushed file and
    recency survives the reload; a reload under a tighter bound evicts
    at load; negative bounds are refused."""
    c = memocache.SummaryCache(None, max_entries=2)
    d = ["a" * 64, "b" * 64, "c" * 64]
    c.put(d[0], _summ(0))
    c.put(d[1], _summ(1))
    assert c.get(d[0]) is not None
    c.put(d[2], _summ(2))
    assert c.get(d[1]) is None
    assert c.get(d[0]) is not None and c.get(d[2]) is not None
    assert c.evictions == 1 and c.evicted_bytes > 0
    path = str(tmp_path / "bounded.jsonl")
    line = memocache.SummaryCache._line_bytes("a" * 64, _summ(0))
    assert line == jax_memocache.SummaryCache._line_bytes("a" * 64,
                                                          _summ(0))
    c = memocache.SummaryCache(path, max_bytes=2 * line + 1)
    for dg in d:
        c.put(dg, _summ(0))
    assert c.evictions == 1 and c.evicted_bytes == line
    c.flush()
    assert os.path.getsize(path) <= 2 * line + 1
    c2 = memocache.SummaryCache(path, max_bytes=2 * line + 1)
    assert c2.get(d[0]) is None and c2.get(d[1]) and c2.get(d[2])
    c3 = memocache.SummaryCache(path, max_entries=1)
    assert c3.evictions == 1 and c3.get(d[2]) is not None
    for kw in ({"max_entries": -1}, {"max_bytes": -1}):
        with pytest.raises(ValueError, match=">= 0"):
            memocache.SummaryCache(None, **kw)


@pytest.mark.parametrize("poison, excerpt", [
    ("{not json", "not valid JSON"),
    ('{"digest": "ab", "summary": {}}\n', "missing the"),
    ('{"schema": 99, "digest": "%s", "summary": {}}\n' % ("a" * 64),
     "schema version 99"),
    ('{"schema": %d, "digest": "zz", "summary": {}}\n'
     % memocache.MEMOCACHE_SCHEMA_VERSION, "not a sha256 hex string"),
    ('{"schema": %d, "digest": "%s", "summary": 7}\n'
     % (memocache.MEMOCACHE_SCHEMA_VERSION, "b" * 64), "summary is not an"),
])
def test_damaged_cache_is_refused_as_jax(tmp_path, poison, excerpt):
    """Each damaged file the JAX tests poison raises MemoCacheError with
    the JAX message in both packages."""
    path = tmp_path / "cache.jsonl"
    path.write_text(poison)
    for module in (memocache, jax_memocache):
        with pytest.raises(module.MemoCacheError, match=excerpt):
            module.SummaryCache(str(path))


def test_cache_flushes_merge_and_files_cross(tmp_path):
    """Two caches over one path, loaded before either wrote: the second
    flush folds the first writer's entries in (as older). Port and JAX
    handles interleave on one file, each flush merging the other's, and
    the file each package leaves is the line-for-line file the other
    writes for the same entries."""
    path = str(tmp_path / "shared.jsonl")
    a = memocache.SummaryCache(path)
    b = jax_memocache.SummaryCache(path)
    a.put("a" * 64, _summ(1))
    a.flush()
    b.put("b" * 64, _summ(2))
    b.flush()
    c = memocache.SummaryCache(path)
    assert c.get("a" * 64) == _summ(1) and c.get("b" * 64) == _summ(2)
    c.put("c" * 64, _summ(3))
    c.flush()
    merged = jax_memocache.SummaryCache(path)
    assert [merged.get(ch * 64) for ch in "abc"] == \
        [_summ(1), _summ(2), _summ(3)]
    assert len(memocache.SummaryCache(path, max_entries=1)) == 1
    ours, theirs = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    for module, where in ((memocache, ours), (jax_memocache, theirs)):
        w = module.SummaryCache(where)
        for ch in "dca":
            w.put(ch * 64, _summ(ord(ch)))
        w.flush()
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_runner_refuses_damaged_cache(tmp_path):
    """A poisoned cache file fails the port's run before it starts."""
    _, pr = _pair(memo="admit")
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"schema": 99, "digest": "%s", "summary": {}}\n'
                   % ("c" * 64))
    pr.memo_cache_path = str(bad)
    with pytest.raises(memocache.MemoCacheError, match="schema version 99"):
        pr.run_stream([_port_job(j) for j in _jobs()], **RUN)


# ---- the lane signature ----------------------------------------------------------

def _jax_state(host):
    return JaxDenseState(*(tuple(jnp.asarray(w) for w in leaf)
                           if isinstance(leaf, tuple) else jnp.asarray(leaf)
                           for leaf in host))


def _signature_state(case):
    """A port state mid-run with int16 log entries of -1 and u32 words
    with their high bits set."""
    if case == "ring8-sync":
        runner = BatchedRunner(
            workloads.ring_topology(8),
            SimConfig.for_workload(snapshots=4, record_dtype="int16",
                                   split_markers=True),
            HashDelay(11), 3, scheduler="sync", device="cpu")
    elif case == "er16-exact-faulted":
        runner = BatchedRunner(
            workloads.erdos_renyi(16, 3.0, seed=3, tokens=24),
            SimConfig.for_workload(snapshots=4, record_dtype="int16",
                                   snapshot_timeout=16),
            HashDelay(5), 3, scheduler="exact", device="cpu",
            faults=Faults(3, drop_rate=0.1, dup_rate=0.1,
                          marker_drop_rate=0.05), quarantine=True)
    else:
        runner = BatchedRunner(
            workloads.ring_topology(6), SimConfig.for_workload(snapshots=2),
            GoExactDelay(9), 3, scheduler="exact", device="cpu")
    if case == "ring6-goexact":
        # the Go-exact sampler draws in push order: a compiled script
        spec = workloads.ring_topology(6)
        job = workloads.stream_jobs(spec, 1, seed=3, base_phases=4,
                                    max_phases=6)[0]
        s = runner.run(runner.init_batch_device(),
                       compile_events(runner.topo, job), drain=False)
    else:
        prog = workloads.storm_program(
            runner.topo, 6, 1, workloads.staggered_snapshots(
                runner.topo, 2, 1, 1, max_phases=6))
        s = runner.run_storm(runner.init_batch_device(), prog, drain=False)
    log = s.log_amt.clone()
    log[1, 0, :] = -1
    s = s._replace(log_amt=log, fault_key=torch.tensor(
        [0xFFFFFFFF, 0x80000001, 0], dtype=torch.int64),
        job_id=torch.tensor([-1, 2, 7], dtype=torch.int32))
    return runner, s


@pytest.mark.parametrize("case", ["ring8-sync", "er16-exact-faulted",
                                  "ring6-goexact"])
def test_lane_signature_equals_jax(case):
    """``_lane_signature`` equals the JAX ``_lane_signature`` vmapped
    over the lanes: a sync state, a faulted exact state under the
    supervisor, and a Go-exact state (uint64 words, hashed as lo and hi
    halves); with int16 entries of -1 and u32 words past 2^31; and it
    moves when one leaf's word does."""
    runner, s = _signature_state(case)
    host = state_to_numpy(s, runner.delay)
    if host.log_amt.dtype == np.int16:
        assert (host.log_amt == -1).any()
    got = _lane_signature(s, runner.delay)
    want = np.asarray(jax.vmap(jax_batch._lane_signature)(_jax_state(host)))
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert len(set(got.tolist())) == 3
    bumped = s._replace(tokens=s.tokens + torch.tensor([[1], [0], [0]],
                                                       dtype=torch.int32))
    moved = _lane_signature(bumped, runner.delay)
    assert moved[0] != got[0] and torch.equal(moved[1:], got[1:])


# ---- run_stream under "admit" and "full" --------------------------------------

@pytest.mark.parametrize("memo,scheduler,faults", [
    ("admit", "sync", False), ("full", "sync", False),
    ("admit", "exact", False), ("full", "exact", True),
], ids=["admit-sync", "full-sync", "admit-exact", "full-exact-faulted"])
def test_memo_stream_equals_jax(memo, scheduler, faults):
    """``run_stream`` under the memo plane, every served job shadowed
    (``shadow_every=1``): every leaf of the final state and stream equal
    to the JAX run's (``sig`` and the memo counters included), every
    row but the digest value equal, and every row equal to the memo-off
    oracle's on the same pool."""
    jr, pr = _pair(scheduler, memo, faults=faults)
    jobs = _jobs()
    armed = [j % 3 == 0 for j in range(J)] if faults else None
    jpool = jr.pack_jobs(jobs, fault_armed=armed)
    ppool = pr.pack_jobs([_port_job(j) for j in jobs], fault_armed=armed)
    jout = jr.run_stream(jpool, shadow_every=1, **RUN)
    pout = pr.run_stream(ppool, shadow_every=1, **RUN)
    _assert_runs_equal(jr, jout, pr, pout)
    summ = pr.summarize_stream(pout[1])
    # armed duplicates of unarmed leaders are distinct computations
    followers = J - (6 if faults else NUNIQ)
    assert summ["coalesced_jobs"] == summ["shadow_checks"] == followers
    served = [r for r in pr.stream_results(pout[1])
              if r.get("served_from")]
    assert len(served) == followers and all(
        r["served_from"] == "coalesce" and r["admit_step"] == -1
        and len(r["digest"]) == 64 for r in served)
    if memo == "full":
        assert int(pout[0].sig.abs().sum()) > 0
    off = BatchedRunner(workloads.ring_topology(8),
                        SimConfig.for_workload(**CFG), HashDelay(11), B,
                        scheduler=scheduler, device="cpu",
                        faults=pr.faults, quarantine=faults)
    _, ost = off.run_stream(ppool, **RUN)
    assert _strip(pr.stream_results(pout[1])) == \
        _strip(off.stream_results(ost))


def test_warm_cache_serves_every_job(tmp_path):
    """A second run on the summary cache the first flushed serves every
    job from it (or as the shadows), with rows equal to the first run's,
    and the JAX runner reads the port's file as valid."""
    jr, pr = _pair(memo="admit", memo_cache=str(tmp_path / "c.jsonl"))
    pool = pr.pack_jobs([_port_job(j) for j in _jobs()])
    _, first = pr.run_stream(pool, **RUN)
    rows = _strip(pr.stream_results(first))
    _, second = pr.run_stream(pool, **RUN)
    assert _strip(pr.stream_results(second)) == rows
    summ = pr.summarize_stream(second)
    # every job is a hit; the first served one also runs, its shadow
    assert summ["cache_hits"] == J and summ["jobs_done"] == 1
    assert {r["served_from"] for r in pr.stream_results(second)} == \
        {"cache"}
    assert len(jax_memocache.SummaryCache(str(tmp_path / "c.jsonl"))) \
        == NUNIQ


def test_fast_forward_livelocked_drain_equals_jax():
    """Two nodes, one link a->b, a snapshot at the sink: the drain can
    never complete and runs pure +1 ticks to ERR_TICK_LIMIT; memo "full"
    jumps them. Traced: leaf-equal to the JAX run (rings included), the
    ticks skipped booked and stamped EV_MEMO_HIT, fewer steps than the
    off run, and the off run's rows."""
    nodes, links = [("a", 10), ("b", 10)], [("a", "b")]
    cfg = dataclasses.replace(
        SimConfig.for_workload(snapshots=2, max_recorded=32),
        max_ticks=600)
    jcfg = dataclasses.replace(
        JaxSimConfig.for_workload(snapshots=2, max_recorded=32),
        max_ticks=600)
    jr = jax_batch.BatchedRunner(JaxTopologySpec(nodes, links), jcfg,
                                 make_fast_delay("hash", 11), 2,
                                 scheduler="exact", memo="full",
                                 trace=JaxTrace())
    pr = BatchedRunner(TopologySpec(nodes, links), cfg, HashDelay(11), 2,
                       scheduler="exact", device="cpu", memo="full",
                       trace=Trace())
    jout = jr.run_stream(jr.pack_jobs([[JaxSnapshotEvent("b")]] * 3),
                         stretch=2, drain_chunk=16)
    pool = pr.pack_jobs([[SnapshotEvent("b")]] * 3)
    pout = pr.run_stream(pool, stretch=2, drain_chunk=16)
    _assert_runs_equal(jr, jout, pr, pout)
    summ = pr.summarize_stream(pout[1])
    assert summ["ff_skipped_ticks"] > 0
    hits = [e for lane in range(2) for e in decode_trace(pout[0], lane)
            if e.kind == EV_MEMO_HIT]
    assert hits and sum(e.payload for e in hits) == summ["ff_skipped_ticks"]
    off = BatchedRunner(TopologySpec(nodes, links), cfg, HashDelay(11), 2,
                        scheduler="exact", device="cpu")
    _, ost = off.run_stream(pool, stretch=2, drain_chunk=16)
    assert int(pout[1].steps) < int(ost.steps)
    assert _strip(pr.stream_results(pout[1])) == \
        _strip(off.stream_results(ost))
    assert all(r["errors_decoded"] == ["ERR_TICK_LIMIT"]
               for r in pr.stream_results(pout[1]))


def test_kill_and_resume_replans_identically(tmp_path):
    """A memo "full" stream checkpointed every 2 steps and killed after
    its second save resumes from the file to the uninterrupted run's
    final state, stream and rows: the plan is a pure function of the
    pool and the cache file, which only a finished run flushes."""
    _, pr = _pair(memo="full", memo_cache=str(tmp_path / "c.jsonl"))
    pool = pr.pack_jobs([_port_job(j) for j in _jobs()])
    ckpt = str(tmp_path / "memo_stream.npz")
    _, killed = pr.run_stream(pool, checkpoint=ckpt, checkpoint_every=2,
                              kill_after_saves=2, **RUN)
    assert int(killed.jobs_done) < NUNIQ + 1
    assert not os.path.exists(tmp_path / "c.jsonl")
    like = (pr.init_batch_device(), pr.init_stream(pool))
    (state, stream), meta = load_state(ckpt, like, delay=pr.delay)
    assert meta["stream_steps"] == 4
    rs, rst = pr.run_stream(pool, state=state, stream=stream, **RUN)
    resumed = pr.stream_results(rst)
    os.remove(tmp_path / "c.jsonl")
    us, ust = pr.run_stream(pool, **RUN)
    assert resumed == pr.stream_results(ust)
    _assert_leaves_equal(state_to_numpy(us, pr.delay),
                         state_to_numpy(rs, pr.delay), "resumed state")
    _assert_leaves_equal(stream_to_numpy(ust), stream_to_numpy(rst),
                         "resumed stream")


def test_traced_coalesce_equals_jax():
    """The flight recorder under memo "admit": each leader with
    followers stamps EV_LANE_COALESCE with their count, after its admit;
    the rings equal the JAX run's."""
    jr, pr = _pair("exact", "admit", trace=True)
    jobs = _jobs()
    jout = jr.run_stream(jr.pack_jobs(jobs), **RUN)
    pout = pr.run_stream(pr.pack_jobs([_port_job(j) for j in jobs]), **RUN)
    _assert_runs_equal(jr, jout, pr, pout)
    events = [e for lane in range(B) for e in decode_trace(pout[0], lane)
              if e.kind == EV_LANE_COALESCE]
    assert sum(e.payload for e in events) == J - NUNIQ


def test_compiled_duplicates_share_one_rank():
    """Byte-equal compiled scripts share a content rank even when their
    event lists differ (a merged tick run), as in JAX."""
    _, pr = _pair(memo="admit")
    spec = workloads.ring_topology(8)
    ids = sorted(n for n, _ in spec.nodes)
    from chandy_lamport_tpu_torch.core.spec import TickEvent

    a = [SnapshotEvent(ids[0]), TickEvent(3)]
    b = [SnapshotEvent(ids[0]), TickEvent(1), TickEvent(2)]
    assert all(np.array_equal(x, y) for x, y in zip(
        compile_events(pr.topo, a), compile_events(pr.topo, b)))
    pool = pr.pack_jobs([a, b, [SnapshotEvent(ids[1]), TickEvent(3)]])
    d = pool.digest.numpy()
    assert (d[0] == d[1]).all() and not (d[0] == d[2]).all()
