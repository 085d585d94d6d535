"""The sync scheduler under the fault adversary, the snapshot supervisor
and quarantine, against the JAX package's, leaf for leaf on the CPU.

(a) Four chaos-smoke scenarios and the at-scale program on er-16 (every
class at once, marker drops retried and exhausted, lossy crashes with
and without a completed snapshot) through ``BatchedRunner(scheduler="sync",
faults=..., quarantine=True)`` against the JAX runner: every
``DenseState`` leaf equal, ``fault_counts``, ``fault_skew``, the ``snap_*``
leaves, ``error`` and the delay stream included. (b) The split-mode
daemon with lossy crashes, the flight recorder's ring under faults, the
multi-tick loop and the faulted, quarantined sync stream. (c) The two
repairs the lifted refusal needed: a masked sync tick (a lane outside
``active``, whose own faults would fire) and a gated storm phase (a lane
poisoned mid-storm) leave every leaf of that lane as the JAX
``lax.cond`` under ``vmap`` does. Integer work: no tolerance.
"""

import dataclasses
import functools
import io
import json
import random
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
from jax import lax

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import FixedJaxDelay, HashJaxDelay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu.utils.randgen import random_strongly_connected
from chandy_lamport_tpu.utils.tracing import JaxTrace
from chandy_lamport_tpu_torch import bench
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.spec import (
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.core.state import (
    ERR_FAULT_UNRECOVERED,
    ERR_SNAPSHOT_TIMEOUT,
)
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import FixedDelay, HashDelay
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils.carry import (
    state_from_numpy,
    state_to_numpy,
    stream_to_numpy,
)
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec
from chandy_lamport_tpu_torch.utils.metrics import conservation_delta
from chandy_lamport_tpu_torch.utils.tracing import Trace

BATCH = 4


def _assert_states_equal(ref, got, what=""):
    """Every leaf equal in value, shape and dtype."""
    for name in ref._fields:
        xs = jax.tree_util.tree_leaves(getattr(ref, name))
        ys = jax.tree_util.tree_leaves(getattr(got, name))
        assert len(xs) == len(ys), (what, name)
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (what, name, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {name}")


def _graph(pkg, kind):
    if kind == "sf":
        return pkg.scale_free(16, 2, seed=5, tokens=100)
    if kind == "ring":
        return pkg.ring_topology(8, tokens=100)
    return pkg.erdos_renyi(16, 3.0, seed=3, tokens=50)


# ---- (a) the chaos-smoke scenarios on the sync scheduler ---------------------

SUP = {"retry": dict(snapshot_timeout=24, snapshot_retries=10),
       "exhaust": dict(snapshot_timeout=10, snapshot_retries=2), None: {}}

# name: (graph, delay, phases, snapshots, fault kwargs, supervisor,
#        the bits a lane may end with) — the crash and supervisor
# scenarios of tools/chaos_smoke.py:405-430 at seed 3 (its message-fault,
# pause-crash and marker-dup scenarios are in the at-scale program), and
# that program on er-16 at raised rates: every class at once
SCENARIOS = {
    "crash-lossy-recovered": ("ring", "fixed", 48, 1, dict(
        crash_rate=1.0, crash_mode="lossy", crash_start=30, crash_len=2),
        None, 0),
    "crash-lossy-unrecovered": ("ring", "fixed", 24, 1, dict(
        crash_rate=1.0, crash_mode="lossy", crash_start=5, crash_len=2),
        None, ERR_FAULT_UNRECOVERED),
    "marker-drop-retry": ("ring", "fixed", 24, 1, dict(
        marker_drop_rate=0.1), "retry", 0),
    "marker-drop-exhausted": ("ring", "fixed", 16, 1, dict(
        marker_drop_rate=1.0), "exhaust", ERR_SNAPSHOT_TIMEOUT),
    "er16-slice-program": ("er", "hash", 12, 4, dict(
        drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05, crash_rate=0.05,
        crash_mode="pause", marker_drop_rate=0.02, marker_dup_rate=0.05,
        marker_jitter_rate=0.05), dict(snapshot_timeout=16),
        ERR_SNAPSHOT_TIMEOUT),
}


@functools.lru_cache(maxsize=None)
def _pair(name, traced=False):
    """The JAX and port sync runners of one scenario (built once: the JAX
    runner's jit caches live on the instance) and its program."""
    kind, delay, phases, snaps, fkw, sup, _ = SCENARIOS[name]
    cfg = dict(sup) if isinstance(sup, dict) else dict(SUP[sup])
    if snaps > 2:
        cfg["max_snapshots"] = 8
    cfg = dict(snapshots=2, max_recorded=128, split_markers=True, **cfg)
    jdelay = HashJaxDelay(11) if delay == "hash" else FixedJaxDelay(1)
    tdelay = HashDelay(11) if delay == "hash" else FixedDelay(1)
    jr = JaxRunner(_graph(jax_workloads, kind),
                   JaxSimConfig.for_workload(**cfg), jdelay, BATCH,
                   scheduler="sync", kernel_engine="xla",
                   faults=JaxFaults(3, **fkw), quarantine=True,
                   trace=JaxTrace(capacity=64) if traced else None)
    tr = BatchedRunner(_graph(workloads, kind),
                       SimConfig.for_workload(**cfg), tdelay, BATCH,
                       scheduler="sync", faults=Faults(3, **fkw),
                       quarantine=True, device="cpu",
                       trace=Trace(capacity=64) if traced else None)
    prog = workloads.storm_program(
        tr.topo, phases, 1, workloads.staggered_snapshots(
            tr.topo, snaps, 1, 2, max_phases=phases))
    return jr, tr, prog


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_faulted_sync_storm_matches_jax(name):
    """Every leaf equal after the whole storm (phases, drain, flush); the
    scenario's fault classes fired; the books balance; no bit but the
    scenario's, and only on quarantined lanes."""
    jr, tr, prog = _pair(name)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got, tr.delay))
    summary = BatchedRunner.summarize(got)
    assert summary == JaxRunner.summarize(jax.device_put(ref))
    assert sum(summary["fault_events"].values()) > 0
    tokens0 = int(tr.topo.tokens0.sum()) * BATCH
    assert int(conservation_delta(got, tr.config, tokens0)) == 0
    allowed = SCENARIOS[name][-1]
    assert not bool((got.error & ~allowed).any())


def test_slice_program_quarantines_lanes_mid_storm():
    """The er-16 program fires every class on the sync scheduler, retries,
    and poisons some lanes (ERR_SNAPSHOT_TIMEOUT) while others run on: a
    quarantined lane stops ticking where it was poisoned (before the tick
    limit), the clean ones complete every snapshot."""
    _, tr, prog = _pair("er16-slice-program")
    got = tr.run_storm(tr.init_batch_device(), prog)
    summary = BatchedRunner.summarize(got)
    assert all(v > 0 for v in summary["fault_events"].values()), summary
    assert summary["snapshot_lifecycle"]["retried"] > 0
    poisoned = got.error != 0
    assert bool(poisoned.any()) and not bool(poisoned.all())
    assert int(got.time[poisoned].max()) < tr.config.max_ticks
    done = got.started & (got.completed >= tr.topo.n)
    assert bool((done == got.started)[~poisoned].all())


def test_traced_faulted_sync_storm_matches_jax():
    """The flight recorder under faults on the sync scheduler: the rings
    (restarts, stalls, drops, duplicates, the supervisor's decisions, in
    the JAX order) and every other leaf equal."""
    jr, tr, prog = _pair("er16-slice-program", traced=True)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got, tr.delay))
    assert int(got.tr_count.min()) > 64      # every ring wrapped


def _daemon_pair(fkw):
    spec = (jax_workloads.erdos_renyi(16, 3.0, seed=3, tokens=50),
            workloads.erdos_renyi(16, 3.0, seed=3, tokens=50))
    cfg = dict(max_snapshots=8, queue_capacity=24, max_recorded=64,
               snapshot_every=5, snapshot_timeout=40)
    jr = JaxRunner(spec[0], JaxSimConfig(**cfg), HashJaxDelay(5), BATCH,
                   scheduler="sync", kernel_engine="xla",
                   faults=JaxFaults(9, **fkw), quarantine=True)
    tr = BatchedRunner(spec[1], SimConfig(**cfg), HashDelay(5), BATCH,
                       scheduler="sync", device="cpu",
                       faults=Faults(9, **fkw), quarantine=True)
    prog = workloads.storm_program(tr.topo, 10, 1,
                                   workloads.staggered_snapshots(
                                       tr.topo, 3, 1, 2, max_phases=10))
    return jr, tr, prog


def test_split_daemon_with_lossy_crashes_matches_jax():
    """The split-mode daemon (``_bulk_snapshots`` of the rotating
    initiator, on the lanes whose clock fires) and the split re-initiation
    with lossy crashes that restore from the daemon's snapshots."""
    jr, tr, prog = _daemon_pair(dict(crash_rate=0.3, crash_mode="lossy",
                                     crash_start=60, crash_len=2,
                                     marker_drop_rate=0.01))
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got, tr.delay))
    assert int(got.next_sid.min()) > 3           # the daemon initiated
    assert int(got.fault_counts[:, 3].sum()) > 0
    assert int(got.snap_retries.sum()) > 0
    assert not bool((got.error & ERR_FAULT_UNRECOVERED).any())


@functools.lru_cache(maxsize=None)
def _jax_mid():
    """The JAX er-16 program's state after its phases, undrained."""
    jr, _, prog = _pair("er16-slice-program")
    return jax.device_get(jr.run_storm(jr.init_batch_device(), prog,
                                       drain=False))


def test_faulted_sync_run_ticks_and_drain_from_a_jax_state():
    """A JAX faulted mid-storm state carried into the port: ``run_ticks``
    (the sync loop, no quiescence exit) and the drain, whose lanes leave
    at different ticks, each equal the JAX runs of the same state."""
    jr, tr, _ = _pair("er16-slice-program")
    mid = _jax_mid()
    ref = jax.device_get(jr.run_ticks(jax.device_put(mid), 9))
    got = tr.run_ticks(state_from_numpy(mid, "cpu"), 9)
    _assert_states_equal(ref, state_to_numpy(got, tr.delay), "run_ticks")
    ref = jax.device_get(jr.drain(jax.device_put(mid)))
    got = tr.drain(state_from_numpy(mid, "cpu"))
    _assert_states_equal(ref, state_to_numpy(got, tr.delay), "drain")
    assert len(set(got.time.tolist())) > 1


# ---- (b) the faulted sync stream ---------------------------------------------

SPEC = random_strongly_connected(random.Random(11), 10)
PSPEC = TopologySpec(list(SPEC.nodes), list(SPEC.links))
STREAM_PROGRAM = dict(drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05,
                      crash_rate=0.05, crash_mode="pause", crash_len=2,
                      crash_period=8, marker_drop_rate=0.3,
                      marker_dup_rate=0.05, marker_jitter_rate=0.05)
STREAM_CFG = dict(snapshots=4, max_recorded=128, snapshot_timeout=6,
                  snapshot_retries=1, split_markers=True)


def _port_job(events):
    kinds = {"PassTokenEvent": PassTokenEvent,
             "SnapshotEvent": SnapshotEvent, "TickEvent": TickEvent}
    return [kinds[type(ev).__name__](*dataclasses.astuple(ev))
            for ev in events]


def test_faulted_sync_stream_equals_jax():
    """The supervised, quarantined sync stream with the adversary on
    every third job: every result row, the counters, the final lanes and
    the stream carry equal the JAX run; some jobs retire with error
    bits."""
    jr = JaxRunner(SPEC, JaxSimConfig.for_workload(**STREAM_CFG),
                   HashJaxDelay(seed=11), BATCH, scheduler="sync",
                   faults=JaxFaults(3, **STREAM_PROGRAM), quarantine=True)
    pr = BatchedRunner(PSPEC, SimConfig.for_workload(**STREAM_CFG),
                       HashDelay(11), BATCH, scheduler="sync", device="cpu",
                       faults=Faults(3, **STREAM_PROGRAM), quarantine=True)
    jobs = jax_workloads.stream_jobs(SPEC, 12, seed=8, base_phases=3,
                                     max_phases=14)
    armed = [j % 3 == 0 for j in range(12)]
    jstate, jstream = jr.run_stream(jr.pack_jobs(jobs, fault_armed=armed),
                                    stretch=2, drain_chunk=12)
    pool = pr.pack_jobs([_port_job(j) for j in jobs], fault_armed=armed)
    pstate, pstream = pr.run_stream(pool, stretch=2, drain_chunk=12)
    rows = pr.stream_results(pstream)
    assert rows == jr.stream_results(jstream)
    assert pr.summarize_stream(pstream) == jr.summarize_stream(jstream)
    _assert_states_equal(jax.device_get(jstate),
                         state_to_numpy(pstate, pr.delay), "state")
    _assert_states_equal(jax.device_get(jstream), stream_to_numpy(pstream),
                         "stream")
    assert any(r["error"] for r in rows)
    assert not any(r["fault_events"] for r in rows if r["job"] % 3)


# ---- (c) the repairs: masked ticks and gated phases keep every leaf ---------

def _jax_masked(fn):
    """The JAX form of a per-lane gate: ``lax.cond`` under ``vmap``."""
    return jax.vmap(lambda s, a: lax.cond(a, fn, lambda t: t, s))


def test_masked_sync_tick_keeps_every_leaf():
    """A sync tick on a lane mask, mid-storm under every class at rate
    0.5 (the restarts, stalls, drops and duplicates fire on every lane):
    the lanes outside the mask keep every leaf, their fault counts and
    delay streams included, and the whole state equals the JAX
    ``lax.cond`` of the tick under ``vmap``."""
    fkw = dict(drop_rate=0.5, dup_rate=0.5, jitter_rate=0.5, crash_rate=0.5,
               crash_period=4, crash_len=3, marker_drop_rate=0.5,
               marker_dup_rate=0.5, marker_jitter_rate=0.5)
    cfg = dict(max_snapshots=8, queue_capacity=24, max_recorded=64,
               snapshot_timeout=4, snapshot_every=3)
    jr = JaxRunner(jax_workloads.erdos_renyi(16, 3.0, seed=3, tokens=50),
                   JaxSimConfig(**cfg), HashJaxDelay(5), BATCH,
                   scheduler="sync", kernel_engine="xla",
                   faults=JaxFaults(9, **fkw), quarantine=True)
    tr = BatchedRunner(workloads.erdos_renyi(16, 3.0, seed=3, tokens=50),
                       SimConfig(**cfg), HashDelay(5), BATCH,
                       scheduler="sync", device="cpu",
                       faults=Faults(9, **fkw), quarantine=True)
    prog = workloads.storm_program(tr.topo, 6, 1, workloads.
                                   staggered_snapshots(tr.topo, 3, 1, 2,
                                                       max_phases=6))
    mid = jax.device_get(jr.run_storm(jr.init_batch_device(), prog,
                                      drain=False))
    active = np.array([True, False, True, False])
    tick = jax.jit(_jax_masked(jr.kernel._sync_tick))
    ref = jax.device_get(tick(jax.device_put(mid), active))
    s = BatchedRunner._own(state_from_numpy(mid, "cpu"))
    got = state_to_numpy(tr.kernel._sync_tick_lanes(
        s, torch.as_tensor(active)), tr.delay)
    _assert_states_equal(ref, got)
    for lane in (1, 3):
        _assert_states_equal(
            jax.tree_util.tree_map(lambda x: x[lane], mid),
            jax.tree_util.tree_map(lambda x: x[lane], got), f"lane {lane}")
    # the unmasked lanes' own faults fired in the tick
    assert (got.fault_counts[0] != mid.fault_counts[0]).any()


def test_gated_sync_phase_freezes_a_poisoned_lane():
    """A lane poisoned mid-storm (its error word set, the others cleared)
    sits out a storm phase behind the quarantine gate: its bulk sends,
    initiations, tick and delay draws all skipped, every leaf kept; the
    phase equals the JAX ``_quarantine_gate(storm_phase)`` under
    ``vmap``."""
    jr, tr, prog = _pair("er16-slice-program")
    mid = _jax_mid()
    mid = mid._replace(error=np.array([0, 256, 0, 0], np.int32))
    amounts = np.asarray(prog.amounts[3])
    snaps = np.asarray(prog.snap[3])
    phase = jax.jit(jax.vmap(jr._quarantine_gate(jr.storm_phase),
                             in_axes=(0, None, None)))
    ref = jax.device_get(phase(jax.device_put(mid), amounts, snaps))
    s = BatchedRunner._own(state_from_numpy(mid, "cpu"))
    got = state_to_numpy(tr._gated_phase(
        s, torch.as_tensor(amounts), torch.as_tensor(snaps)), tr.delay)
    _assert_states_equal(ref, got)
    _assert_states_equal(jax.tree_util.tree_map(lambda x: x[1], mid),
                         jax.tree_util.tree_map(lambda x: x[1], got),
                         "lane 1")
    assert (got.time[[0, 2, 3]] == mid.time[[0, 2, 3]] + 1).all()
    assert (got.fault_counts[0] != mid.fault_counts[0]).any()


def test_faulted_sync_bench_row_on_cpu():
    """The bench with the fault and supervisor flags on its default sync
    scheduler: quarantine on, the fault books in the row, and the faulted
    validity checks passed."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main([
            "--device", "cpu", "--graph", "er", "--nodes", "16", "--batch",
            "4", "--phases", "8", "--snapshots", "2", "--repeats", "1",
            "--fault-drop", "0.05", "--fault-crash", "0.05",
            "--marker-fault-drop", "0.02", "--snapshot-timeout", "24"])
    assert rc == 0
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    assert row["scheduler"] == "sync" and row["quarantine"]
    assert row["conservation_delta"] == 0
    assert all(row["fault_checks"].values())
    assert row["fault_events"]["drops"] > 0
    assert row["fault_events"]["marker_drops"] > 0
