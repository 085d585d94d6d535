"""The flight recorder on the port's paths against the JAX package's, on
the CPU, bit for bit (integer work: the tolerance is none).

(a) Traced ``BatchedRunner`` storms (ER-16, B=4) equal the JAX runner's
with ``trace=JaxTrace(K)`` on every leaf, the ``tr_*`` ring included: the
cascade, the wave, the faulted cascade under the supervisor with
quarantine, and the sync scheduler, at capacities 64 and 4096, the port at
megatick 1 and 4 (its plain fused form; the JAX run at megatick 1: the
results do not depend on the megatick). (b) Recorder off: a traced run
equals the untraced run on every leaf but the ring. (c) The wave under
supervisor retries: the JAX wave re-broadcasts with a bare sid, so there
the port wave's trace is held to the port cascade's, tick by tick, as a
multiset of events (the wave orders a tick's events by wave, the cascade
by its fold). (d) A traced ``run_stream`` (memo off) equals the JAX
``run_stream(trace=JaxTrace())``: the ring, its admits and harvests, and
the rows. (e) The bench's ``--trace`` row and the ``stream --trace`` row.
"""

import collections
import dataclasses
import functools
import json
import random

import jax
import numpy as np
import pytest

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import HashJaxDelay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu.utils.randgen import random_strongly_connected
from chandy_lamport_tpu.utils.tracing import JaxTrace
from chandy_lamport_tpu_torch import BatchedRunner, SimConfig, bench
from chandy_lamport_tpu_torch.__main__ import stream_run
from chandy_lamport_tpu_torch.core.spec import (
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.utils.carry import (
    state_to_numpy,
    stream_to_numpy,
)
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec
from chandy_lamport_tpu_torch.utils.tracing import (
    EV_LANE_ADMIT,
    EV_LANE_HARVEST,
    EV_SUP_RETRY,
    Trace,
    decode_trace,
)

B = 4
RING = ("tr_meta", "tr_data", "tr_tick", "tr_count", "tr_on")
# the at-scale program at raised rates (every class, rare marker drops,
# pause crashes) under a 16-tick timeout: it retries
FAULTS = dict(drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05,
              crash_rate=0.05, crash_mode="pause", marker_drop_rate=0.02,
              marker_dup_rate=0.05, marker_jitter_rate=0.05)
CASES = {
    # scheduler, exact_impl, adversary
    "cascade": ("exact", "cascade", False),
    "wave": ("exact", "wave", False),
    "faulted": ("exact", "cascade", True),
    "sync": ("sync", "cascade", False),
}


def _assert_leaves_equal(want, got, skip=()):
    for name in want._fields:
        if name in skip:
            continue
        xs = jax.tree_util.tree_leaves(getattr(want, name))
        ys = jax.tree_util.tree_leaves(getattr(got, name))
        assert len(xs) == len(ys), name
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (name, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=name)


def _cfg(cls, case, **extra):
    sched, _, faulted = CASES[case]
    sup = dict(snapshot_timeout=16, max_snapshots=8) if faulted else {}
    return cls.for_workload(snapshots=4, split_markers=sched == "sync",
                            **sup, **extra)


def _port_runner(case, trace, megatick=1, impl=None):
    sched, cimpl, faulted = CASES[case]
    return BatchedRunner(
        workloads.erdos_renyi(16, 3.0, seed=3, tokens=50),
        _cfg(SimConfig, case), HashDelay(11), B, scheduler=sched,
        exact_impl=impl or cimpl, device="cpu",
        megatick=megatick if sched == "exact" else 1,
        faults=Faults(3, **FAULTS) if faulted else None, quarantine=faulted,
        trace=trace)


def _program(runner):
    return workloads.storm_program(runner.topo, 12, 1,
                                   workloads.staggered_snapshots(
                                       runner.topo, 4, 1, 2, max_phases=12))


@functools.lru_cache(maxsize=None)
def _jax_final(case, capacity):
    sched, impl, faulted = CASES[case]
    jr = JaxRunner(jax_workloads.erdos_renyi(16, 3.0, seed=3, tokens=50),
                   _cfg(JaxSimConfig, case), HashJaxDelay(11), B,
                   scheduler=sched, exact_impl=impl, kernel_engine="xla",
                   faults=JaxFaults(3, **FAULTS) if faulted else None,
                   quarantine=faulted, trace=JaxTrace(capacity))
    return jax.device_get(jr.run_storm(jr.init_batch_device(),
                                       _program(_port_runner(case, None))))


# ---- (a) traced storms against JAX -------------------------------------------

@pytest.mark.parametrize("megatick", [1, 4])
@pytest.mark.parametrize("capacity", [64, 4096])
@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_storm_matches_jax(case, capacity, megatick):
    runner = _port_runner(case, Trace(capacity), megatick)
    got = runner.run_storm(runner.init_batch_device(), _program(runner))
    want = _jax_final(case, capacity)
    _assert_leaves_equal(want, state_to_numpy(got, runner.delay))
    summary = BatchedRunner.summarize(got)
    assert summary["trace_events"] == int(np.minimum(
        want.tr_count, capacity).sum()) > 0
    assert summary["trace_dropped"] == int(np.maximum(
        want.tr_count - capacity, 0).sum())
    if capacity == 64:
        assert summary["trace_dropped"] > 0       # the ring wrapped


def test_faulted_case_fires_and_retries():
    """The faulted storm records faults and supervisor retries."""
    want = _jax_final("faulted", 4096)
    kinds = [ev.kind for lane in range(B)
             for ev in decode_trace(want, lane=lane)]
    assert EV_SUP_RETRY in kinds and 9 in kinds


# ---- (b) the recorder moves no other bit -------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_recorder_off_is_bit_identical(case):
    """A traced storm equals the untraced one on every leaf but the ring;
    the untraced state's ring has no slot."""
    finals = []
    for trace in (None, Trace(128)):
        runner = _port_runner(case, trace, megatick=4)
        finals.append(state_to_numpy(
            runner.run_storm(runner.init_batch_device(), _program(runner))))
    _assert_leaves_equal(finals[0], finals[1], skip=RING)
    assert finals[0].tr_meta.shape == (B, 0)
    assert finals[1].tr_count.min() > 0


# ---- (c) the wave under supervisor retries -----------------------------------

def _per_tick(state, lane):
    ticks = collections.defaultdict(collections.Counter)
    for ev in decode_trace(state, lane=lane):
        ticks[ev.tick][ev] += 1
    return ticks


def test_wave_under_retries_matches_cascade_per_tick():
    """Under the supervisor with retries the port's wave equals the
    port's cascade on every leaf but the ring, and each lane's ring holds
    the same events in every tick (as a multiset), in wave order."""
    finals = []
    for impl in ("cascade", "wave"):
        runner = _port_runner("faulted", Trace(4096), megatick=4, impl=impl)
        finals.append(runner.run_storm(runner.init_batch_device(),
                                       _program(runner)))
    cascade, wave = finals
    _assert_leaves_equal(state_to_numpy(cascade), state_to_numpy(wave),
                         skip=RING)
    assert int(cascade.snap_retries.sum()) > 0
    assert int(cascade.tr_count.max()) <= 4096
    assert cascade.tr_count.tolist() == wave.tr_count.tolist()
    reordered = False
    for lane in range(B):
        assert _per_tick(cascade, lane) == _per_tick(wave, lane)
        reordered |= (decode_trace(cascade, lane=lane)
                      != decode_trace(wave, lane=lane))
    assert reordered


# ---- (d) the stream ----------------------------------------------------------

def _port_job(events):
    kinds = {"PassTokenEvent": PassTokenEvent,
             "SnapshotEvent": SnapshotEvent, "TickEvent": TickEvent}
    return [kinds[type(ev).__name__](*dataclasses.astuple(ev))
            for ev in events]


@pytest.mark.parametrize("impl,k,capacity", [("cascade", 4, 4096),
                                             ("wave", 1, 32)],
                         ids=["cascade-mt4", "wave-mt1-wraps"])
def test_traced_stream_matches_jax(impl, k, capacity):
    """A traced ``run_stream`` equals the JAX run's rings (admits and
    harvests in them), rows and stream books; the untraced run's rows are
    the same."""
    jspec = random_strongly_connected(random.Random(11), 10)
    cfg = dict(snapshots=4, max_recorded=128)
    jr = JaxRunner(jspec, JaxSimConfig.for_workload(**cfg),
                   HashJaxDelay(seed=11), B, scheduler="exact",
                   exact_impl=impl, trace=JaxTrace(capacity))
    pspec = TopologySpec(list(jspec.nodes), list(jspec.links))
    jobs = jax_workloads.stream_jobs(jspec, 8, seed=5, base_phases=3,
                                     max_phases=12)
    jstate, jstream = jr.run_stream(jr.pack_jobs(jobs), stretch=3,
                                    drain_chunk=12)
    rows = {}
    for trace in (Trace(capacity), None):
        pr = BatchedRunner(pspec, SimConfig.for_workload(**cfg),
                           HashDelay(11), B, scheduler="exact",
                           exact_impl=impl, device="cpu", megatick=k,
                           trace=trace)
        pstate, pstream = pr.run_stream(pr.pack_jobs(
            [_port_job(j) for j in jobs]), stretch=3, drain_chunk=12)
        rows[trace is None] = pr.stream_results(pstream)
        if trace is not None:
            _assert_leaves_equal(jax.device_get(jstate),
                                 state_to_numpy(pstate, pr.delay))
            _assert_leaves_equal(jax.device_get(jstream),
                                 stream_to_numpy(pstream))
            kinds = collections.Counter(
                ev.kind for lane in range(B)
                for ev in decode_trace(pstate, lane=lane))
    assert rows[False] == rows[True] == jr.stream_results(jstream)
    if capacity == 4096:
        assert kinds[EV_LANE_ADMIT] == kinds[EV_LANE_HARVEST] == 8


# ---- (e) the entry points' rows ----------------------------------------------

def test_bench_trace_row(capsys):
    """``storm --trace`` adds the recorder's fields and the overhead
    against an untraced storm of the same arguments."""
    code = bench.main(["--device", "cpu", "--scheduler", "exact", "--graph",
                       "er", "--nodes", "16", "--batch", "4", "--phases",
                       "6", "--snapshots", "2", "--repeats", "1",
                       "--megatick", "4", "--trace-capacity", "64"])
    assert code == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["trace_capacity"] == 64 and row["trace_events"] > 0
    assert row["trace_dropped"] > 0
    assert {"trace_overhead_pct", "untraced_node_ticks_per_sec"} <= set(row)


def test_bench_stream_trace_row(capsys):
    code = bench.main(["--device", "cpu", "--stream", "--scheduler", "exact",
                       "--graph", "er", "--nodes", "16", "--batch", "4",
                       "--jobs", "8", "--repeats", "1", "--megatick", "4",
                       "--trace"])
    assert code == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["trace_capacity"] == 4096 and row["trace_events"] > 0


def test_stream_cli_trace_row(capsys):
    assert stream_run(["--device", "cpu", "--graph", "ring", "--nodes", "8",
                       "--batch", "4", "--jobs", "8", "--max-phases", "12",
                       "--snapshots", "4", "--trace"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["jobs_done"] == 8 and row["trace_events"] > 0
    assert row["trace_dropped"] == 0
