"""The port's serving front-end (``chandy_lamport_tpu_torch/serving``,
``utils/guards.py``) against the JAX package's, on the CPU.

The JAX ``tests/test_serving.py`` shape: ring-8, hash delay 11, J = 12
requests over B = 4 lanes, 3 tenants, rate 0.5, duplicate rate 0.3,
stretch 3, drain chunk 16. Held to the JAX package in-process:
``serve_workload`` and ``burst_workload`` byte for byte; ``plan_ingest``,
``order_eligible`` and ``shed_order`` on seeded and hypothesis-drawn
request sets; ``serve_run`` on the sync scheduler under edf and under
fifo with quotas, and on a warm summary-cache file: every leaf of the
final lane state and StreamState, every result row (less the ``digest``
value: the port's digests hash the port's knobs, tests/test_torch_memo.py)
and the report (less its timing keys) equal to the JAX run's; its
telemetry rows; the guards' site books against the JAX books (the
port's own sites aside) for ``serve_run`` and ``run_stream``, and an
armed loop on the CPU that reads the tensors only at named sites (a
TorchFunctionMode stands in for the card's sync debug mode); the
``ExecutableCache``'s bucket and its memory, disk and fresh planes; the
``serve`` command line's JSON line against the JAX CLI's; ``bench
--serve``. The exact scheduler at megatick 8, the kill drill across the
packages and the recorder's serve events are in
test_torch_serving_exact.py. Tolerance: none (integer state).
"""

import collections
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst
from torch.overrides import TorchFunctionMode

from chandy_lamport_tpu import cli as jax_cli
from chandy_lamport_tpu import serving as jax_serving
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu.utils.guards import RuntimeGuards as JaxGuards
from chandy_lamport_tpu.utils.memocache import SummaryCache as JaxCache
from chandy_lamport_tpu.utils.tracing import (
    TelemetryWriter as JaxTelemetryWriter,
    read_telemetry,
)
from chandy_lamport_tpu_torch import serving
from chandy_lamport_tpu_torch.__main__ import serve_cmd
from chandy_lamport_tpu_torch.config import ENGINE_KNOBS, SimConfig
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils import guards as guards_mod
from chandy_lamport_tpu_torch.utils.carry import (
    state_to_numpy,
    stream_to_numpy,
)
from chandy_lamport_tpu_torch.utils.memocache import SummaryCache
from chandy_lamport_tpu_torch.utils.tracing import TelemetryWriter

CFG8 = dict(snapshots=4, max_recorded=128)
J, B, TENANTS = 12, 4, 3
SERVE_KW = dict(rate=0.5, tenants=TENANTS, priorities=2,
                deadline_slack=(64, 256), dup_rate=0.3, base_phases=3,
                max_phases=12)
STEP = dict(stretch=3, drain_chunk=16)
TIMING = ("wall_s", "warmup_s")
# the port's own sites (utils/guards.py): host reads the JAX jitted step
# and the JAX telemetry's unguarded device_get do not count
PORT_SITES = ("stream-lane-pass", "stream-recorder", "serve-telemetry")


def _requests(count=J, seed=3, **kw):
    kw = {**SERVE_KW, **kw}
    return (jax_workloads.serve_workload(jax_workloads.ring_topology(8),
                                         count, seed=seed, **kw),
            workloads.serve_workload(workloads.ring_topology(8), count,
                                     seed=seed, **kw))


def _as_tuples(reqs):
    """Requests as plain tuples, the events as (class name, fields):
    comparable across the two packages' classes."""
    return [(r.job, r.arrival_step, r.tenant, r.priority, r.deadline_step,
             [(type(e).__name__, dataclasses.astuple(e)) for e in r.events])
            for r in reqs]


def _rows(rows):
    """Result rows with the digest's value masked (its key kept)."""
    return [{k: ("<digest>" if k == "digest" else v) for k, v in r.items()}
            for r in rows]


def _report(rep):
    return {k: v for k, v in rep.items() if k not in TIMING}


def _assert_leaves_equal(want, got, what=""):
    for field in want._fields:
        xs = jax.tree_util.tree_leaves(getattr(want, field))
        ys = jax.tree_util.tree_leaves(getattr(got, field))
        assert len(xs) == len(ys), (what, field)
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (what, field, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {field}")


def assert_serve_equal(jr, jout, pr, pout):
    """A serve run of each package: the report (less timing), every result
    row (less the digest value), the final lane state and StreamState."""
    (js, jst, jrep), (ps, pst, prep) = jout, pout
    assert _report(prep) == _report(jrep)
    assert _rows(pr.stream_results(pst)) == _rows(jr.stream_results(jst))
    _assert_leaves_equal(jax.device_get(jst), stream_to_numpy(pst), "stream")
    _assert_leaves_equal(jax.device_get(js), state_to_numpy(ps, pr.delay),
                         "state")


def _port_runner(scheduler="sync", **kw):
    return BatchedRunner(workloads.ring_topology(8),
                         SimConfig.for_workload(**CFG8), HashDelay(11), B,
                         scheduler=scheduler, device="cpu", **kw)


@pytest.fixture(scope="module")
def pair(ring8_sync_stream_runner):
    """The JAX session runner (read only; its compiled serve step is shared
    through one JAX ExecutableCache) and the port's twin with a cache of
    its own, so both caches see the same sequence of buckets."""
    return (ring8_sync_stream_runner, jax_serving.ExecutableCache(None),
            _port_runner(), serving.ExecutableCache(None))


# ---- the workloads and the host planners --------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(seed=4, dup_rate=0.0, tenants=5, priorities=3),
    dict(count=40, seed=11, rate=2.0, deadline_slack=(1, 3))],
    ids=["jax-test", "five-tenants", "tight-deadlines"])
def test_serve_workload_equals_jax(kw):
    """``serve_workload`` gives the JAX trace, request for request."""
    want, got = _requests(**kw)
    assert _as_tuples(got) == _as_tuples(want)


def test_burst_workload_equals_jax():
    """``burst_workload`` re-times arrivals as the JAX function does, and
    refuses the JAX bad arguments with its messages."""
    args = (16, 7)
    kw = dict(rate=1.5, burst_period=8, burst_factor=4.0, tenants=3,
              max_phases=10)
    want = jax_workloads.burst_workload(jax_workloads.ring_topology(8),
                                        *args, **kw)
    got = workloads.burst_workload(workloads.ring_topology(8), *args, **kw)
    assert _as_tuples(got) == _as_tuples(want)
    for bad in (dict(burst_period=1), dict(burst_factor=1.0)):
        with pytest.raises(ValueError) as jexc:
            jax_workloads.burst_workload(jax_workloads.ring_topology(8),
                                         4, 1, **bad)
        with pytest.raises(ValueError) as pexc:
            workloads.burst_workload(workloads.ring_topology(8), 4, 1, **bad)
        assert str(pexc.value) == str(jexc.value)


def _both_requests(rows):
    """(JAX, port) ServeRequests from (arrival, tenant, priority, slack)
    rows, in arrival order, with empty scripts."""
    rows = sorted(rows, key=lambda r: r[0])
    return tuple([mod.ServeRequest(job=j, arrival_step=a, tenant=t,
                                   priority=p, deadline_step=a + d,
                                   events=[])
                  for j, (a, t, p, d) in enumerate(rows)]
                 for mod in (jax_workloads, workloads))


def _planners_agree(rows, digest_of, quotas, warm):
    jreq, preq = _both_requests(rows)
    digests = [("%02x" % digest_of[j % len(digest_of)]) * 32
               for j in range(len(rows))]
    jc, pc = JaxCache(None), SummaryCache(None)
    for d in warm:
        summ = {"time": d, "error": 0}
        jc.put(("%02x" % d) * 32, summ)
        pc.put(("%02x" % d) * 32, summ)
    assert serving.plan_ingest(preq, digests, pc, quotas) == \
        jax_serving.plan_ingest(jreq, digests, jc, quotas)
    for policy in ENGINE_KNOBS["serve_policy"]:
        assert [r.job for r in serving.order_eligible(preq, policy)] == \
            [r.job for r in jax_serving.order_eligible(jreq, policy)]
        assert [serving.admission_key(r, policy) for r in preq] == \
            [jax_serving.admission_key(r, policy) for r in jreq]
    assert [r.job for r in serving.shed_order(preq)] == \
        [r.job for r in jax_serving.shed_order(jreq)]


def test_planners_equal_jax_on_the_serve_trace():
    """The ingest plan, both orderings and the shedding order of the JAX
    test's trace (its digests' duplicates), under quotas and a warm
    cache, equal the JAX planners'; the policy knob refuses as JAX."""
    jreq, _ = _requests()
    rows = [(r.arrival_step, r.tenant, r.priority,
             r.deadline_step - r.arrival_step) for r in jreq]
    _planners_agree(rows, [0, 1, 2, 1, 3, 0], [2, 0, 1], warm=[3])
    with pytest.raises(ValueError) as jexc:
        jax_serving.resolve_serve_policy("sjf")
    with pytest.raises(ValueError) as pexc:
        serving.resolve_serve_policy("sjf")
    assert str(pexc.value) == str(jexc.value)


@settings(max_examples=40, deadline=None)
@given(rows=hst.lists(hst.tuples(hst.integers(0, 20), hst.integers(0, 3),
                                 hst.integers(0, 2), hst.integers(1, 9)),
                      min_size=1, max_size=24),
       digest_of=hst.lists(hst.integers(0, 5), min_size=1, max_size=8),
       quotas=hst.lists(hst.integers(0, 4), max_size=4),
       warm=hst.lists(hst.integers(0, 5), max_size=3))
def test_planners_equal_jax_on_drawn_requests(rows, digest_of, quotas, warm):
    """Drawn request sets (ties in arrival, priority and deadline;
    duplicate digests; quotas shorter than the tenants; warm entries):
    the port's planners give the JAX plan and orders."""
    _planners_agree(rows, digest_of, quotas, warm)


# ---- serve_run on the sync scheduler ------------------------------------------

def test_serve_equals_jax_edf(pair):
    """The JAX test's reference serve (edf): the port's run equals it leaf
    for leaf, and every accepted request is served."""
    jr, jec, pr, pec = pair
    jreq, preq = _requests()
    jout = jax_serving.serve_run(jr, jreq, policy="edf", exec_cache=jec,
                                 **STEP)
    pout = serving.serve_run(pr, preq, policy="edf", exec_cache=pec,
                             **STEP)
    assert_serve_equal(jr, jout, pr, pout)
    assert pout[2]["served_total"] == J and pout[2]["served_coalesced"] > 0
    assert pout[2]["warmup_source"] == "fresh"


def test_serve_equals_jax_fifo_with_quotas(pair):
    """fifo under quotas that refuse some of the heavy tenants' requests:
    the refusals, the rows and the carry equal the JAX run's."""
    jr, jec, pr, pec = pair
    jreq, preq = _requests()
    quotas = [3, 0, 1]
    jout = jax_serving.serve_run(jr, jreq, policy="fifo", quotas=quotas,
                                 exec_cache=jec, **STEP)
    pout = serving.serve_run(pr, preq, policy="fifo", quotas=quotas,
                             exec_cache=pec, **STEP)
    assert_serve_equal(jr, jout, pr, pout)
    assert pout[2]["refused_total"] > 0


def test_serve_equals_jax_on_a_warm_summary_cache(tmp_path):
    """A summary-cache file of the JAX format, warmed by one serve of each
    package: the second serve of each serves every request at ingest
    (no lane, no step), equal to the JAX run."""
    jreq, preq = _requests()
    outs = {}
    for pkg in ("jax", "port"):
        cache = str(tmp_path / f"{pkg}.jsonl")
        for _ in range(2):
            if pkg == "jax":
                from chandy_lamport_tpu.config import SimConfig as JaxConfig
                from chandy_lamport_tpu.ops.delay_jax import make_fast_delay

                r = JaxRunner(jax_workloads.ring_topology(8),
                              JaxConfig.for_workload(**CFG8),
                              make_fast_delay("hash", 11), B,
                              scheduler="sync", memo_cache=cache)
                out = jax_serving.serve_run(r, jreq, **STEP)
            else:
                r = _port_runner(memo_cache=cache)
                out = serving.serve_run(r, preq, **STEP)
        outs[pkg] = (r, out)
    (jr, jout), (pr, pout) = outs["jax"], outs["port"]
    assert_serve_equal(jr, jout, pr, pout)
    assert pout[2]["served_cache"] == J and pout[2]["steps"] == 0


def test_serve_telemetry_equals_jax(pair, tmp_path):
    """Telemetry every 4 steps: the port's serve_interval and serve_run
    rows equal the JAX rows, timing keys aside."""
    jr, jec, pr, pec = pair
    jreq, preq = _requests()
    rows = {}
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}.jsonl")
        if pkg == "jax":
            w = JaxTelemetryWriter(path)
            jax_serving.serve_run(jr, jreq, exec_cache=jec, telemetry=w,
                                  telemetry_interval=4, **STEP)
        else:
            w = TelemetryWriter(path)
            serving.serve_run(pr, preq, exec_cache=pec, telemetry=w,
                              telemetry_interval=4, **STEP)
        w.close()
        rows[pkg] = [_report(r) for r in read_telemetry(path)]
    assert [r["kind"] for r in rows["port"]].count("serve_interval") >= 1
    assert rows["port"] == rows["jax"]


def test_serve_refuses_as_jax(pair):
    """Bad requests and a results ring smaller than the executed jobs
    raise the JAX messages."""
    jr, jec, pr, pec = pair
    jreq, preq = _requests()
    for call in (lambda m, r, q: m.serve_run(r, [q[0]._replace(job=5)]
                                             + list(q[1:])),
                 lambda m, r, q: m.serve_run(r, q, results_capacity=2),
                 lambda m, r, q: m.serve_run(r, q, stretch=0)):
        with pytest.raises(ValueError) as jexc:
            call(jax_serving, jr, jreq)
        with pytest.raises(ValueError) as pexc:
            call(serving, pr, preq)
        assert str(pexc.value) == str(jexc.value)


# ---- the guards ----------------------------------------------------------------

def _port_books(books):
    return {**books, "transfers": {k: v for k, v in
                                   books["transfers"].items()
                                   if k not in PORT_SITES}}


def test_guard_books_equal_jax(pair, tmp_path):
    """``serve_run(guards=)`` with telemetry and a checkpoint, and
    ``BatchedRunner(guards=)`` through ``run_stream``: the port's site
    books equal the JAX books but for the port's own sites (PORT_SITES:
    the lane pass once a step, the telemetry reads) and the compile count
    (the JAX run_stream jits its step inside the armed loop; the port
    builds no kernel on the CPU)."""
    jr, jec, pr, pec = pair
    jreq, preq = _requests()
    books = {}
    for pkg in ("jax", "port"):
        g = JaxGuards() if pkg == "jax" else guards_mod.RuntimeGuards()
        ck = str(tmp_path / f"{pkg}.npz")
        w = (JaxTelemetryWriter if pkg == "jax" else TelemetryWriter)(
            str(tmp_path / f"{pkg}.jsonl"))
        kw = dict(guards=g, telemetry=w, telemetry_interval=4,
                  checkpoint=ck, checkpoint_every=5, **STEP)
        if pkg == "jax":
            jax_serving.serve_run(jr, jreq, exec_cache=jec, **kw)
        else:
            serving.serve_run(pr, preq, exec_cache=pec, **kw)
        w.close()
        books[pkg] = g.books()
    assert _port_books(books["port"]) == books["jax"]
    assert books["port"]["transfers"]["stream-lane-pass"] == \
        books["port"]["transfers"]["serve-progress-scalars"]
    # run_stream under the runner's guards
    jobs = [r.events for r in jreq]
    jg = JaxGuards()
    from chandy_lamport_tpu.config import SimConfig as JaxConfig
    from chandy_lamport_tpu.ops.delay_jax import make_fast_delay

    jrg = JaxRunner(jax_workloads.ring_topology(8),
                    JaxConfig.for_workload(**CFG8),
                    make_fast_delay("hash", 11), B, scheduler="sync",
                    guards=jg)
    prg = _port_runner(guards=guards_mod.RuntimeGuards())
    jst = jrg.run_stream(jrg.pack_jobs(jobs), **STEP)[1]
    pst = prg.run_stream(prg.pack_jobs([r.events for r in preq]), **STEP)[1]
    assert prg.stream_results(pst) == jrg.stream_results(jst)
    want, got = jg.books(), _port_books(prg.guards.books())
    assert got["transfers"] == want["transfers"]
    assert got["armed_regions"] == want["armed_regions"] == 1
    assert got["compiles"] == 0


_SYNCS = {"__bool__", "__int__", "__index__", "__float__", "item", "tolist",
          "cpu", "numpy", "nonzero", "masked_select", "unique",
          "repeat_interleave"}


class _SyncWatch(TorchFunctionMode):
    """Every tensor read that makes the host wait on the card (a D2H read,
    a boolean-mask gather) made while the innermost guard region forbids
    syncs (``guards.sync_mode() == 2``): what the card's sync debug mode
    "error" raises on, watched on the CPU."""

    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        bad = name in _SYNCS
        if name == "__getitem__" and len(args) > 1:
            bad = torch.is_tensor(args[1]) and args[1].dtype == torch.bool
        if name == "to":
            bad = "cpu" in (str(a) for a in args[1:]) or \
                str((kwargs or {}).get("device")) == "cpu"
        if bad and guards_mod.sync_mode() == 2:
            self.hits[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("scheduler,megatick,memo", [
    ("sync", 1, "off"), ("exact", 8, "off"), ("exact", 8, "full")],
    ids=["sync", "exact-megatick-8", "exact-memo-full"])
def test_armed_loops_read_only_at_named_sites(scheduler, megatick, memo,
                                              tmp_path):
    """Under ``transfers="disallow"`` the serve loop (telemetry, quotas,
    checkpoints) and ``run_stream`` (under memo "full" with its
    fast-forward watch) read tensors on the host only inside named sites,
    so the card's sync debug mode "error" has nothing to raise on; the
    books count the sites."""
    g = guards_mod.RuntimeGuards()
    kw = dict(snapshots=4, max_recorded=128,
              split_markers=scheduler == "sync")
    r = BatchedRunner(workloads.ring_topology(8),
                      SimConfig.for_workload(**kw), HashDelay(11), B,
                      scheduler=scheduler, megatick=megatick, memo=memo,
                      device="cpu", guards=g)
    _, preq = _requests()
    w = TelemetryWriter(str(tmp_path / "t.jsonl"))
    watch = _SyncWatch()
    with watch:
        serving.serve_run(r, preq, quotas=[3, 0, 2], telemetry=w,
                          telemetry_interval=4,
                          checkpoint=str(tmp_path / "ck.npz"),
                          checkpoint_every=5, **STEP)
        r.run_stream(r.pack_jobs([q.events for q in preq]), **STEP)
    w.close()
    assert not watch.hits, dict(watch.hits)
    books = g.books()
    assert books["armed_regions"] == 2 and books["compiles"] == 0
    assert books["transfers"]["stream-lane-pass"] > 0
    if memo == "full":
        assert books["transfers"]["memo-fastforward"] > 0
    # the watch sees a stray read in an armed region
    with watch, g.armed():
        bool(torch.zeros(1).any())
    assert watch.hits["__bool__"] == 1


def test_guards_refuse_and_map_as_jax():
    """The transfer policies map onto the sync debug modes; a bad policy
    raises the JAX message; ``leaks`` is accepted."""
    assert guards_mod.SYNC_MODES == {"allow": 0, "log": 1, "disallow": 2}
    with pytest.raises(ValueError) as jexc:
        JaxGuards(transfers="sometimes")
    with pytest.raises(ValueError) as pexc:
        guards_mod.RuntimeGuards(transfers="sometimes")
    assert str(pexc.value) == str(jexc.value)
    g = guards_mod.RuntimeGuards(transfers="log", leaks=False)
    with g.armed():
        assert guards_mod.sync_mode() == 1
        with guards_mod.relaxed_site(g, "x"):
            assert guards_mod.sync_mode() == 0
    assert guards_mod.sync_mode() == 0
    assert g.books() == {"compiles": 0, "transfers": {"x": 1},
                         "armed_regions": 1}


# ---- the serve-step cache -------------------------------------------------------

def test_exec_cache_bucket_sensitivity(pair):
    """The JAX test's cases: the bucket moves with the step shape and the
    operands' shapes; and with the runner's identity."""
    _, _, pr, _ = pair
    ec = serving.ExecutableCache(None)
    a = ec.bucket_digest(pr, 3, 16, (np.int32(0),))
    assert a == ec.bucket_digest(pr, 3, 16, (np.int32(0),))
    assert a != ec.bucket_digest(pr, 4, 16, (np.int32(0),))
    assert a != ec.bucket_digest(pr, 3, 8, (np.int32(0),))
    assert a != ec.bucket_digest(pr, 3, 16, (np.zeros(2, np.int32),))
    assert a != ec.bucket_digest(pr, 3, 16, (torch.zeros((), dtype=torch.
                                                         int64),))
    assert a != ec.bucket_digest(_port_runner(scheduler="exact"), 3, 16,
                                 (np.int32(0),))


def test_exec_cache_planes(tmp_path):
    """fresh, then memory in the same cache, then disk in a restarted
    cache over the same directory (rows equal to the fresh run's); a
    damaged record degrades to fresh and is rewritten."""
    _, preq = _requests()
    path = str(tmp_path / "exec")
    runs = []
    ec = serving.ExecutableCache(path)
    for cache in (ec, ec, serving.ExecutableCache(path)):
        r = _port_runner()
        _, st, rep = serving.serve_run(r, preq, exec_cache=cache, **STEP)
        runs.append((rep, r.stream_results(st), dict(cache.last)))
    assert [x[0]["warmup_source"] for x in runs] == ["fresh", "memory",
                                                     "disk"]
    assert runs[0][0]["warmup_persisted"] is True
    assert runs[1][1] == runs[0][1] == runs[2][1]
    assert all(x[2]["builds"] == 0 for x in runs)
    (record,) = [f for f in os.listdir(path) if f.endswith(".json")]
    with open(os.path.join(path, record), "w") as f:
        f.write("{torn")
    ec3 = serving.ExecutableCache(path)
    serving.serve_run(_port_runner(), preq, exec_cache=ec3, **STEP)
    assert ec3.last["source"] == "fresh" and "disk_error" in ec3.last
    assert ec3.last["persisted"] is True
    with open(os.path.join(path, record)) as f:
        assert json.load(f)["bucket"] == ec3.last["bucket"]


# ---- the command line and the bench ---------------------------------------------

SERVE_FLAGS = ["--graph", "ring", "--nodes", "8", "--batch", "4",
               "--requests", "12", "--rate", "0.5", "--tenants", "3",
               "--dup-rate", "0.3", "--max-phases", "12", "--snapshots",
               "4", "--quota", "3,0,2", "--guards"]


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_serve_command_equals_the_jax_cli(capsys, tmp_path):
    """``serve`` with quotas, guards, an exec cache and telemetry prints
    the JAX CLI's JSON line less timing and provenance (the telemetry
    path, the warmup, the port's guard sites)."""
    rows = {}
    for pkg in ("jax", "port"):
        extra = ["--exec-cache", str(tmp_path / f"{pkg}-exec"),
                 "--telemetry", str(tmp_path / f"{pkg}.jsonl")]
        if pkg == "jax":
            assert jax_cli.main(["serve"] + SERVE_FLAGS + extra) == 0
        else:
            assert serve_cmd(SERVE_FLAGS + extra + ["--device", "cpu"]) == 0
        rows[pkg] = _last_json(capsys.readouterr().out)
    drop = TIMING + ("telemetry", "warmup_persisted", "guards")
    want = {k: v for k, v in rows["jax"].items() if k not in drop}
    got = {k: v for k, v in rows["port"].items() if k not in drop}
    assert got == want
    assert _port_books(rows["port"]["guards"]) == rows["jax"]["guards"]


def test_serve_parser_has_the_jax_defaults(monkeypatch):
    """Every flag of the JAX ``serve`` subparser, with its default; the
    port adds only ``--device``."""
    from chandy_lamport_tpu_torch.__main__ import _serve_parser

    seen = []
    monkeypatch.setattr(jax_cli, "_cmd_serve",
                        lambda args: seen.append(vars(args)) or 0)
    assert jax_cli.main(["serve"]) == 0
    (want,) = seen
    want = {k: v for k, v in want.items()
            if k not in ("command", "fn", "platform")}
    got = vars(_serve_parser().parse_args([]))
    assert got.pop("device") is None
    assert got == want


def test_serve_command_kill_and_resume(capsys, tmp_path):
    """``serve --checkpoint-every 3 --kill-after-saves 1`` exits 17 and
    ``--resume-from`` prints the uninterrupted run's line (timing and
    provenance aside)."""
    ck = str(tmp_path / "ck.npz")
    base = SERVE_FLAGS[:-1] + ["--device", "cpu"]
    assert serve_cmd(base) == 0
    whole = _last_json(capsys.readouterr().out)
    assert serve_cmd(base + ["--checkpoint", ck, "--checkpoint-every", "3",
                             "--kill-after-saves", "1"]) == 17
    assert _last_json(capsys.readouterr().out)["killed_after_steps"] == 3
    assert serve_cmd(base + ["--resume-from", ck]) == 0
    resumed = _last_json(capsys.readouterr().out)
    drop = TIMING + ("admit_p50", "admit_p99", "admit_max", "warmup_source")
    assert {k: v for k, v in resumed.items() if k not in drop} == \
        {k: v for k, v in whole.items() if k not in drop}


def test_bench_serve_row(capsys):
    """``bench --serve`` on the CPU: the cold pass builds nothing there
    (no library), the warm pass finds the record on disk, and the row
    carries the fifo baseline."""
    from chandy_lamport_tpu_torch import bench

    assert bench.main(["--serve", "--device", "cpu", "--scheduler", "exact",
                       "--graph", "er", "--nodes", "12", "--batch", "3",
                       "--phases", "6", "--repeats", "1", "--megatick", "4",
                       "--rate", "0.5", "--tenants", "3", "--dup-rate",
                       "0.3"]) == 0
    row = _last_json(capsys.readouterr().out)
    assert row["metric"] == "serve_effective_jobs_per_sec"
    assert row["warmup_cold_source"] == "fresh"
    assert row["warmup_warm_source"] == "disk"
    assert row["served_total"] == row["requests"] == 9
    for key in ("deadline_misses_fifo", "admit_p99_fifo", "occupancy_fifo"):
        assert key in row


def test_stream_command_guards_and_telemetry_equal_the_jax_cli(capsys,
                                                               tmp_path):
    """``stream --guards --telemetry P`` (once missing from the port): the
    row equals the JAX CLI's less timing and the telemetry path, the
    guard books less the port's own sites, and the telemetry file holds
    the JAX records (the stream_run row and one stream_job row a job)."""
    from chandy_lamport_tpu_torch.__main__ import stream_run

    flags = ["--graph", "ring", "--nodes", "8", "--batch", "4", "--jobs",
             "8", "--max-phases", "8", "--snapshots", "2", "--guards"]
    rows, records = {}, {}
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}.jsonl")
        if pkg == "jax":
            assert jax_cli.main(["stream"] + flags
                                + ["--telemetry", path]) == 0
        else:
            assert stream_run(flags + ["--telemetry", path, "--device",
                                       "cpu"]) == 0
        rows[pkg] = _last_json(capsys.readouterr().out)
        records[pkg] = read_telemetry(path)
    clock = ("wall_seconds", "jobs_per_sec", "effective_jobs_per_sec",
             "telemetry", "guards")
    assert {k: v for k, v in rows["port"].items() if k not in clock} == \
        {k: v for k, v in rows["jax"].items() if k not in clock}
    got, want = _port_books(rows["port"]["guards"]), rows["jax"]["guards"]
    assert got["transfers"] == want["transfers"]
    assert got["armed_regions"] == want["armed_regions"] == 1
    assert got["compiles"] == 0
    assert [r["kind"] for r in records["port"]] == \
        [r["kind"] for r in records["jax"]]
    assert [{k: v for k, v in r.items() if k not in clock}
            for r in records["port"][1:]] == \
        [{k: v for k, v in r.items() if k not in clock}
         for r in records["jax"][1:]]
