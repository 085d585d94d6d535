"""The port's event scripts and streaming job engine against the JAX
package's, on the CPU: the job mixes, the compiled scripts and the job
pool, the static scripted path (``compile_events`` + ``run``, ROADMAP A6),
the sync scheduler's ``run_stream`` (A9 with the memo plane off), the
per-lane injections it rests on, and both command-line entry points.

The JAX side is the oracle, in-process; the port runs its plain PyTorch
versions on the CPU. Everything compared is integer state, so the
tolerance is none: every result row, every ``summarize_stream`` counter,
and every leaf of the final lane state and ``StreamState``, in value and
dtype. The exact scheduler's streams are in test_torch_stream_exact.py,
the faulted ones and the fused drain's lane gate in
test_torch_stream_faults.py.
"""

import dataclasses
import json
import random

import jax
import numpy as np
import pytest
import torch

from chandy_lamport_tpu import cli as jax_cli
from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.state import DenseTopology as JaxTopology
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import HashJaxDelay, make_fast_delay
from chandy_lamport_tpu.parallel import batch as jax_batch
from chandy_lamport_tpu.utils.fixtures import read_events_file as j_events
from chandy_lamport_tpu.utils.fixtures import read_topology_file as j_top
from chandy_lamport_tpu.utils.randgen import random_strongly_connected
from chandy_lamport_tpu_torch import BatchedRunner, SimConfig, bench
from chandy_lamport_tpu_torch.__main__ import stream_run
from chandy_lamport_tpu_torch.core.spec import (
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.core.state import DenseTopology
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.parallel.batch import (
    compile_events,
    StreamState,
)
from chandy_lamport_tpu_torch.utils.carry import (
    pool_from_numpy,
    pool_to_numpy,
    state_from_numpy,
    state_to_numpy,
    stream_from_numpy,
    stream_to_numpy,
)
from chandy_lamport_tpu_torch.utils.fixtures import (
    TopologySpec,
    read_events_file,
    read_topology_file,
)
from chandy_lamport_tpu_torch.utils.goldens import (
    REFERENCE_TESTS,
    fixture_path,
)

# the JAX tests/test_stream.py shapes (and conftest's
# ring8_sync_stream_runner): ring-8, hash delay 11, J=8 jobs over B=4 lanes
CFG8 = dict(snapshots=4, max_recorded=128)
J, B = 8, 4
RAND10 = random_strongly_connected(random.Random(11), 10)


def _assert_leaves_equal(want, got, what=""):
    """Every leaf of the JAX host tree ``want`` equals the port's host
    tree ``got`` in value, shape and dtype."""
    for field in want._fields:
        xs = jax.tree_util.tree_leaves(getattr(want, field))
        ys = jax.tree_util.tree_leaves(getattr(got, field))
        assert len(xs) == len(ys), (what, field)
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (what, field, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {field}")


def _port_spec(spec):
    return TopologySpec(list(spec.nodes), list(spec.links))


def _events(jobs):
    """Event lists as (class name, fields) tuples: comparable across the
    two packages' dataclasses."""
    return [[(type(ev).__name__, dataclasses.astuple(ev)) for ev in job]
            for job in jobs]


def _port_job(events):
    """A JAX event list as the port's events."""
    kinds = {"PassTokenEvent": PassTokenEvent,
             "SnapshotEvent": SnapshotEvent, "TickEvent": TickEvent}
    return [kinds[name](*fields) for name, fields in _events([events])[0]]


def _assert_stream_equal(jr, jstate, jstream, pr, pstate, pstream):
    """The whole comparison of a stream run: every result row, the
    summary counters, the final lane state and the StreamState."""
    assert pr.stream_results(pstream) == jr.stream_results(jstream)
    assert pr.summarize_stream(pstream) == jr.summarize_stream(jstream)
    _assert_leaves_equal(jax.device_get(jstate),
                         state_to_numpy(pstate, pr.delay), "state")
    _assert_leaves_equal(jax.device_get(jstream), stream_to_numpy(pstream),
                         "stream")


# ---- the job mixes and the compiled scripts ----------------------------------

@pytest.mark.parametrize("graph,kw", [
    ("ring8", dict(count=8, seed=5, base_phases=3, max_phases=12)),
    ("sf32", dict(count=24, seed=17, snapshots_per_job=2, max_phases=20)),
    ("ring8", dict(count=16, seed=3, dup_rate=0.5)),
    ("sf32", dict(count=16, seed=9, prefix_overlap=0.5)),
], ids=["ring8", "sf32-two-snapshots", "dup-rate", "prefix-overlap"])
def test_stream_jobs_equal_jax(graph, kw):
    """``stream_jobs`` gives the JAX jobs, event for event, on ring-8 and
    scale_free(32), with the duplicate and prefix-overlap traffic
    shapes; and ``compile_events`` compiles each to the JAX arrays."""
    if graph == "ring8":
        jspec, pspec = (jax_workloads.ring_topology(8),
                        workloads.ring_topology(8))
    else:
        jspec, pspec = (jax_workloads.scale_free(32, 2, seed=4),
                        workloads.scale_free(32, 2, seed=4))
    want = jax_workloads.stream_jobs(jspec, **kw)
    got = workloads.stream_jobs(pspec, **kw)
    assert _events(got) == _events(want)
    jtopo, ptopo = JaxTopology(jspec), DenseTopology(pspec)
    for jev, pev in zip(want, got):
        for a, b in zip(jax_batch.compile_events(jtopo, jev),
                        compile_events(ptopo, pev)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_compile_events_equal_jax_on_goldens():
    """``compile_events`` on the 7 reference goldens' event files (and an
    empty script, and one ending in ops with no tick) equals the JAX
    arrays."""
    for top, events, _ in REFERENCE_TESTS:
        jtopo = JaxTopology(j_top(fixture_path(top)))
        ptopo = DenseTopology(read_topology_file(fixture_path(top)))
        cases = [(j_events(fixture_path(events)),
                  read_events_file(fixture_path(events)))]
        cases.append(([], []))
        cases.append((cases[0][0][:3], cases[0][1][:3]))
        for jev, pev in cases:
            for a, b in zip(jax_batch.compile_events(jtopo, jev),
                            compile_events(ptopo, pev)):
                assert a.dtype == b.dtype, (top, events)
                np.testing.assert_array_equal(a, b, err_msg=events)


@pytest.mark.parametrize("armed", [False, True], ids=["no-faults",
                                                      "every-third"])
def test_pack_jobs_equal_jax(armed):
    """``pack_jobs`` gives the JAX pool array for array (the memo-off
    path: index-derived stream rows, zero digests, no prefix chain),
    with and without an adversary armed on every third job; and the
    pool survives ``pool_from_numpy`` of the JAX pool."""
    jspec = jax_workloads.ring_topology(8)
    jobs = jax_workloads.stream_jobs(jspec, 12, seed=5, max_phases=12)
    fault_armed = [j % 3 == 0 for j in range(12)] if armed else None
    jr = jax_batch.BatchedRunner(
        jspec, JaxSimConfig.for_workload(**CFG8), make_fast_delay("hash", 11),
        B, scheduler="exact",
        faults=JaxFaults(7, drop_rate=0.1) if armed else None)
    pr = BatchedRunner(_port_spec(jspec), SimConfig.for_workload(**CFG8),
                       HashDelay(11), B, scheduler="exact", device="cpu",
                       faults=Faults(7, drop_rate=0.1) if armed else None)
    want = jax.device_get(jr.pack_jobs(jobs, fault_armed=fault_armed))
    pool = pr.pack_jobs([_port_job(j) for j in jobs],
                        fault_armed=fault_armed)
    got = pool_to_numpy(pool, pr.delay)
    assert want.prefix_digest is None and got.prefix_digest is None
    _assert_leaves_equal(want._replace(prefix_digest=()),
                         got._replace(prefix_digest=()), "pool")
    back = pool_to_numpy(pool_from_numpy(want, "cpu"), pr.delay)
    _assert_leaves_equal(want._replace(prefix_digest=()),
                         back._replace(prefix_digest=()), "carried pool")
    assert (int((got.fault_key != 0).sum()) == (4 if armed else 0))


# ---- the static scripted path (A6) ---------------------------------------------

def _script(spec):
    """One script with every kind of phase: sends, snapshots, a merged
    multi-tick stretch past a megatick and its remainder, and trailing
    ops with no tick (the synthetic phase)."""
    ids = sorted(n for n, _ in spec.nodes)
    links = sorted(spec.links)
    ev = []
    for p in range(5):
        for k in range(3):
            src, dest = links[(3 * p + k) % len(links)]
            ev.append(jax_workloads.PassTokenEvent(src=src, dest=dest,
                                                   tokens=1 + k))
        if p in (1, 3):
            ev.append(jax_workloads.SnapshotEvent(node_id=ids[p]))
        ev.append(jax_workloads.TickEvent(1 if p % 2 else 9))
        if p == 2:
            ev.append(jax_workloads.TickEvent(2))
    src, dest = links[0]
    ev.append(jax_workloads.PassTokenEvent(src=src, dest=dest, tokens=1))
    return ev


@pytest.mark.parametrize("sched,impl,k,graph", [
    ("sync", "cascade", 1, "ring8"),
    ("sync", "cascade", 1, "rand10"),
    ("exact", "cascade", 1, "ring8"),
    ("exact", "cascade", 4, "rand10"),
    ("exact", "wave", 4, "rand10"),
    ("exact", "wave", 1, "ring8"),
], ids=["sync-ring8", "sync-rand10", "cascade-mt1-ring8",
        "cascade-mt4-rand10", "wave-mt4-rand10", "wave-mt1-ring8"])
def test_run_equal_jax(sched, impl, k, graph):
    """``BatchedRunner.run`` (a compiled script shared by every lane, then
    the drain and flush) is leaf-equal to the JAX ``run``: sync and
    exact, cascade and wave, megatick 1 and 4 (the JAX side with its
    fused megatick kernel on, in interpret mode)."""
    jspec = jax_workloads.ring_topology(8) if graph == "ring8" else RAND10
    cfg = dict(CFG8, split_markers=sched == "sync")
    kw = dict(megatick=k)
    if k > 1:
        kw.update(kernel_engine="pallas", fused_tick="on")
    jr = jax_batch.BatchedRunner(
        jspec, JaxSimConfig.for_workload(**cfg), HashJaxDelay(seed=11), B,
        scheduler=sched, exact_impl=impl, **kw)
    pr = BatchedRunner(_port_spec(jspec), SimConfig.for_workload(**cfg),
                       HashDelay(11), B, scheduler=sched, exact_impl=impl,
                       device="cpu", megatick=k)
    events = _script(jspec)
    want = jr.run(jr.init_batch(),
                  jax_batch.compile_events(jr.topo, events))
    got = pr.run(pr.init_batch_device(),
                 compile_events(pr.topo, _port_job(events)))
    _assert_leaves_equal(jax.device_get(want), state_to_numpy(got, pr.delay))
    assert int(got.error.max()) == 0


def test_run_ticks_and_no_drain_equal_jax():
    """``run(drain=False)`` then ``run_ticks`` (a shared count past the
    megatick, with its remainder) equal the JAX calls, at megatick 4."""
    jspec = RAND10
    jr = jax_batch.BatchedRunner(
        jspec, JaxSimConfig.for_workload(**CFG8), HashJaxDelay(seed=5), B,
        scheduler="exact", megatick=4, kernel_engine="pallas",
        fused_tick="on")
    pr = BatchedRunner(_port_spec(jspec), SimConfig.for_workload(**CFG8),
                       HashDelay(5), B, scheduler="exact", device="cpu",
                       megatick=4)
    events = _script(jspec)
    want = jr.run(jr.init_batch(),
                  jax_batch.compile_events(jr.topo, events), drain=False)
    got = pr.run(pr.init_batch_device(),
                 compile_events(pr.topo, _port_job(events)), drain=False)
    _assert_leaves_equal(jax.device_get(want), state_to_numpy(got, pr.delay))
    want = jr.run_ticks(want, 11)
    got = pr.run_ticks(got, 11)
    _assert_leaves_equal(jax.device_get(want), state_to_numpy(got, pr.delay))


# ---- per-lane injections --------------------------------------------------------

@pytest.mark.parametrize("mode", ["ring", "split"])
def test_masked_injections_leave_other_lanes_alone(mode):
    """A per-lane send or snapshot touches only its mask's lanes: a lane
    outside the mask keeps its delay stream (its hash counter one draw
    short of the 2^32 wrap, so a stray draw would show in the epoch),
    error bits, balances, rings and planes; a masked lane equals the same
    injection given to it alone."""
    spec = workloads.ring_topology(6)
    runner = BatchedRunner(spec, SimConfig.for_workload(snapshots=2),
                           HashDelay(3), 3,
                           scheduler="exact" if mode == "ring" else "sync",
                           device="cpu")
    tk = runner.kernel
    s = runner.init_batch_device()
    key, ctr, epoch = s.delay_state
    s = s._replace(delay_state=(key, torch.full_like(ctr, 2**32 - 1),
                                epoch))
    mask = torch.tensor([True, False, True])
    e = torch.tensor([0, 3, 4], dtype=torch.int32)
    amount = torch.tensor([7, 5, 200], dtype=torch.int32)   # lane 2 under
    node = torch.tensor([1, 2, 5], dtype=torch.int32)
    got = tk._inject_snapshot(tk._inject_send(BatchedRunner._own(s), e,
                                              amount, mask), node, mask)
    for lane in range(3):
        one = BatchedRunner._own(s)
        one = one._replace(**{
            f: (tuple(w[lane:lane + 1] for w in getattr(one, f))
                if f == "delay_state" else getattr(one, f)[lane:lane + 1])
            for f in one._fields})
        if mask[lane]:
            one = tk._inject_send(one, int(e[lane]), int(amount[lane]))
            one = tk._inject_snapshot(one, int(node[lane]))
        for f in s._fields:
            a, b = getattr(got, f), getattr(one, f)
            if f == "delay_state":
                for x, y in zip(a, b):
                    assert torch.equal(x[lane:lane + 1], y), (lane, f)
            else:
                assert torch.equal(a[lane:lane + 1], b), (lane, f)
    assert int(got.delay_state[2][0]) == 1          # lane 0 wrapped
    assert int(got.delay_state[2][1]) == 0          # lane 1 drew nothing
    assert int(got.error[2]) != 0 and int(got.error[1]) == 0


# ---- the sync scheduler's stream (A9, memo off) -------------------------------

@pytest.fixture(scope="module")
def sync_pair(ring8_sync_stream_runner):
    """The JAX session runner (read only) and the port's twin."""
    pr = BatchedRunner(workloads.ring_topology(8),
                       SimConfig.for_workload(**CFG8), HashDelay(11), B,
                       scheduler="sync", device="cpu")
    jobs = jax_workloads.stream_jobs(jax_workloads.ring_topology(8), J,
                                     seed=5, base_phases=3, max_phases=12)
    return ring8_sync_stream_runner, pr, jobs


def test_sync_stream_equal_jax(sync_pair):
    """The sync ``run_stream`` (stretch 3, drain chunk 16) equals the
    JAX run: rows, counters, final lane state and stream carry; and each
    row equals its job run alone through the port's static ``run``."""
    jr, pr, jobs = sync_pair
    jstate, jstream = jr.run_stream(jr.pack_jobs(jobs), stretch=3,
                                    drain_chunk=16)
    pjobs = [_port_job(j) for j in jobs]
    pool = pr.pack_jobs(pjobs)
    pstate, pstream = pr.run_stream(pool, stretch=3, drain_chunk=16)
    _assert_stream_equal(jr, jstate, jstream, pr, pstate, pstream)
    rows = pr.stream_results(pstream)
    assert [r["job"] for r in rows] == list(range(J))
    solo = BatchedRunner(workloads.ring_topology(8),
                         SimConfig.for_workload(**CFG8), HashDelay(11), 1,
                         scheduler="sync", device="cpu")
    for j, row in enumerate(rows):
        s = solo.init_batch_device()
        s = s._replace(delay_state=tuple(w[j:j + 1]
                                         for w in pool.delay_state))
        out = solo.run(s, compile_events(solo.topo, pjobs[j]))
        assert row["time"] == int(out.time[0])
        assert row["tokens"] == out.tokens[0].tolist()
        assert row["error"] == int(out.error[0]) == 0
        assert row["snapshots_completed"] == int(out.started[0].sum())


def test_stream_carried_mid_queue_from_jax(sync_pair):
    """A JAX stream stopped after three steps, its lane state, stream
    carry and pool carried into the port (``state_from_numpy``,
    ``stream_from_numpy``, ``pool_from_numpy``), finishes in the port
    exactly as the JAX run finishes."""
    import jax.numpy as jnp

    jr, pr, jobs = sync_pair
    jpool = jr.pack_jobs(jobs)
    step = jr._stream_step(3, 16, False)
    pool_dev = jax.tree_util.tree_map(jnp.asarray, jpool)
    s, st = jax.device_put((jr.init_batch(), jr.init_stream(jpool)))
    for _ in range(3):
        s, st = step(s, st, pool_dev)
    host_s, host_st = jax.device_get((s, st))
    assert 0 < int(host_st.next_job) and int(host_st.jobs_done) < J
    jstate, jstream = jr.run_stream(jpool, stretch=3, drain_chunk=16,
                                    state=s, stream=st)
    pstate, pstream = pr.run_stream(
        pool_from_numpy(jax.device_get(jpool), "cpu"), stretch=3,
        drain_chunk=16, state=state_from_numpy(host_s, "cpu"),
        stream=stream_from_numpy(host_st, "cpu"))
    _assert_stream_equal(jr, jstate, jstream, pr, pstate, pstream)


def test_stream_refusals_and_carry():
    """``content_keys=True`` stamps every job's digest on a memo-off
    runner (the memo plane is ported: test_torch_memo.py), an unknown
    memo mode is a ValueError; a bad admission or stretch is a
    ValueError; ``run_stream`` leaves the state and stream it is given as
    they were."""
    runner = BatchedRunner(workloads.ring_topology(4), SimConfig(),
                           HashDelay(1), 2, scheduler="exact", device="cpu")
    jobs = workloads.stream_jobs(workloads.ring_topology(4), 3, seed=1,
                                 max_phases=4)
    keyed = runner.pack_jobs(jobs, content_keys=True)
    assert bool((keyed.digest != 0).any(1).all())
    with pytest.raises(ValueError, match="memo must be one of"):
        BatchedRunner(workloads.ring_topology(4), SimConfig(), HashDelay(1),
                      2, device="cpu", memo="auto")
    with pytest.raises(ValueError, match="admission"):
        runner.run_stream(jobs, admission="fifo")
    with pytest.raises(ValueError, match="stretch"):
        runner.run_stream(jobs, stretch=0)
    pool = runner.pack_jobs(jobs)
    state, stream = runner.init_batch_device(), runner.init_stream(pool)
    before = (state_to_numpy(state), stream_to_numpy(stream))
    out_state, out_stream = runner.run_stream(pool, state=state,
                                              stream=stream)
    assert int(out_stream.jobs_done) == 3
    _assert_leaves_equal(before[0], state_to_numpy(state), "given state")
    _assert_leaves_equal(before[1], stream_to_numpy(stream), "given stream")
    assert isinstance(out_stream, StreamState)


# ---- the entry points -------------------------------------------------------------

def test_stream_command_equals_the_jax_cli(capsys):
    """``python -m chandy_lamport_tpu_torch stream`` prints the JAX CLI's
    ``stream`` row on the same flags (sync, its default scheduler): every
    counter equal, the wall-clock fields aside."""
    flags = ["--graph", "ring", "--nodes", "8", "--batch", "4", "--jobs",
             "8", "--max-phases", "10", "--snapshots", "4", "--seed", "2",
             "--stretch", "3", "--drain-chunk", "12"]
    assert jax_cli.main(["stream"] + flags) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stream_run(flags + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    clock = ("wall_seconds", "jobs_per_sec", "effective_jobs_per_sec")
    assert {k: v for k, v in got.items() if k not in clock} == \
        {k: v for k, v in want.items() if k not in clock}
    assert got["jobs_done"] == 8 and got["jobs_errored"] == 0


def test_bench_stream_row(capsys):
    """``storm --stream`` on the CPU: the JAX bench's stream row fields,
    stream and gang both retiring every job, and the steps of each equal
    to ``summarize_stream`` of a drive of the same queue."""
    flags = ["--device", "cpu", "--stream", "--scheduler", "exact",
             "--graph", "er", "--nodes", "12", "--batch", "3", "--phases",
             "6", "--snapshots", "2", "--repeats", "1", "--megatick", "4",
             "--drain-chunk", "6"]
    assert bench.main(flags) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("stream_jobs_per_sec", "jobs_per_sec_gang",
                "speedup_vs_static", "occupancy", "occupancy_gang",
                "refills", "stream_steps", "gang_steps", "scheduler",
                "megatick", "fused_tick", "fused_tile",
                "host_fold_steps"):
        assert key in row or row["metric"] == key, key
    assert row["jobs"] == 9 and row["megatick"] == 4
    assert row["scheduler"] == "exact/cascade"
    spec = workloads.erdos_renyi(12, 3.0, seed=3, tokens=16)
    runner = BatchedRunner(spec, SimConfig.for_workload(
        snapshots=2, record_dtype="int16"), HashDelay(17), 3,
        scheduler="exact", device="cpu", megatick=4)
    jobs = workloads.stream_jobs(spec, 9, seed=17, base_phases=4,
                                 tail_alpha=1.1, max_phases=8)
    for admission, key in (("stream", "stream_steps"),
                           ("gang", "gang_steps")):
        _, st = runner.run_stream(jobs, drain_chunk=6, admission=admission)
        assert runner.summarize_stream(st)["steps"] == row[key]
    with pytest.raises(SystemExit):
        bench.main(flags + ["--fault-drop", "0.1"])
