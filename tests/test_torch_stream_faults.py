"""The port's faulted streams and scripts against the JAX package's, on
the CPU, and the fused megatick's lane gate in its drain and flush.

The adversary (token and marker faults, pause crashes) is armed on every
third job through ``pack_jobs(fault_armed=...)``, with the snapshot
supervisor and quarantine: a job whose error bits fire is frozen and
retired with its bits at the next harvest. Compared with no tolerance
(integer state): every result row, every ``summarize_stream`` counter,
the final lane state and ``StreamState`` leaf for leaf, at megatick 1
and at megatick 4 (the JAX side with its fused megatick kernel on, in
interpret mode: its ``_fused_stream_drain`` and ``_fused_flush``); the
static ``run`` under the same adversary, leaf for leaf.

``fused_ticks_plain`` with ``live`` in its "drain" and "flush" modes
(the stream's gate; the CUDA kernel is held to it on the card): a lane
not live is left leaf-equal to its input, and a live one equals the
same steps taken by a batch of that lane alone.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import HashJaxDelay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu.parallel.batch import compile_events as j_compile
from chandy_lamport_tpu.utils.randgen import random_strongly_connected
from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
from chandy_lamport_tpu_torch.core.spec import (
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.kernels import megatick as km
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.parallel.batch import compile_events
from chandy_lamport_tpu_torch.utils.carry import (
    state_to_numpy,
    stream_to_numpy,
)
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec

J, B = 12, 4
# message and marker faults, pause crashes, and a supervisor whose
# deadline the marker drops make some jobs miss (ERR_SNAPSHOT_TIMEOUT)
PROGRAM = dict(drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05,
               crash_rate=0.05, crash_mode="pause", crash_len=2,
               crash_period=8, marker_drop_rate=0.3, marker_dup_rate=0.05,
               marker_jitter_rate=0.05)
CFG = dict(snapshots=4, max_recorded=128, snapshot_timeout=6,
           snapshot_retries=1)
SPEC = random_strongly_connected(random.Random(11), 10)
PSPEC = TopologySpec(list(SPEC.nodes), list(SPEC.links))


def _assert_leaves_equal(want, got, what=""):
    for field in want._fields:
        xs = jax.tree_util.tree_leaves(getattr(want, field))
        ys = jax.tree_util.tree_leaves(getattr(got, field))
        assert len(xs) == len(ys), (what, field)
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (what, field, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {field}")


def _port_job(events):
    kinds = {"PassTokenEvent": PassTokenEvent,
             "SnapshotEvent": SnapshotEvent, "TickEvent": TickEvent}
    return [kinds[type(ev).__name__](*dataclasses.astuple(ev))
            for ev in events]


def _pair(k: int, batch: int = B):
    kw = dict(megatick=k)
    if k > 1:
        kw.update(kernel_engine="pallas", fused_tick="on")
    jr = JaxRunner(SPEC, JaxSimConfig.for_workload(**CFG),
                   HashJaxDelay(seed=11), batch, scheduler="exact",
                   faults=JaxFaults(3, **PROGRAM), quarantine=True, **kw)
    pr = BatchedRunner(PSPEC, SimConfig.for_workload(**CFG), HashDelay(11),
                       batch, scheduler="exact", device="cpu",
                       faults=Faults(3, **PROGRAM), quarantine=True,
                       megatick=k)
    return jr, pr


@pytest.mark.parametrize("k", [1, 4], ids=["mt1", "mt4-fused"])
def test_faulted_stream_equals_jax(k):
    """The faulted, supervised, quarantined stream (every third job
    armed) equals the JAX run; some jobs retire with error bits (the
    supervisor's deadline), the disarmed jobs suffer no fault event,
    and every row equals its job run alone through the static ``run``
    with its pool row's keys."""
    jr, pr = _pair(k)
    jobs = jax_workloads.stream_jobs(SPEC, J, seed=8, base_phases=3,
                                     max_phases=14)
    armed = [j % 3 == 0 for j in range(J)]
    jstate, jstream = jr.run_stream(jr.pack_jobs(jobs, fault_armed=armed),
                                    stretch=2, drain_chunk=12)
    pjobs = [_port_job(j) for j in jobs]
    pool = pr.pack_jobs(pjobs, fault_armed=armed)
    pstate, pstream = pr.run_stream(pool, stretch=2, drain_chunk=12)
    rows = pr.stream_results(pstream)
    assert rows == jr.stream_results(jstream)
    assert pr.summarize_stream(pstream) == jr.summarize_stream(jstream)
    _assert_leaves_equal(jax.device_get(jstate),
                         state_to_numpy(pstate, pr.delay), "state")
    _assert_leaves_equal(jax.device_get(jstream), stream_to_numpy(pstream),
                         "stream")
    assert len(rows) == J
    assert any(r["error"] for r in rows)
    assert all(r["fault_events"] == 0 for r in rows if not armed[r["job"]])
    assert sum(r["fault_events"] for r in rows) > 0
    solo = _pair(k, batch=1)[1]
    for j, job in enumerate(pjobs):
        s = solo.init_batch_device()
        s = s._replace(delay_state=tuple(w[j:j + 1]
                                         for w in pool.delay_state),
                       fault_key=pool.fault_key[j:j + 1])
        out = solo.run(s, compile_events(solo.topo, job))
        assert (rows[j]["time"], rows[j]["error"], rows[j]["tokens"],
                rows[j]["fault_events"]) == (
            int(out.time[0]), int(out.error[0]), out.tokens[0].tolist(),
            int(out.fault_counts[0].sum())), j


def test_faulted_run_equals_jax():
    """The static ``run`` under the adversary, the supervisor and
    quarantine (one script, every lane armed by the lane ramp) equals
    the JAX ``run`` leaf for leaf, at megatick 4."""
    jr, pr = _pair(4)
    events = [ev for job in jax_workloads.stream_jobs(
        SPEC, 3, seed=2, base_phases=4, max_phases=10) for ev in job]
    want = jr.run(jr.init_batch(), j_compile(jr.topo, events))
    got = pr.run(pr.init_batch_device(),
                 compile_events(pr.topo, _port_job(events)))
    _assert_leaves_equal(jax.device_get(want), state_to_numpy(got, pr.delay))
    assert int(got.fault_counts.sum()) > 0


# ---- the lane gate of the fused megatick's drain and flush (B4) --------------

def _mid_stream(runner):
    """A state with lanes in different stages: traffic and a snapshot in
    flight on some lanes, nothing on others."""
    tk = runner.kernel
    s = runner.init_batch_device()
    lanes = torch.arange(runner.batch)
    for r in range(3):
        for e in range(r % 3, runner.topo.e, 3):
            s = tk._inject_send(s, e, 1, lanes % 3 != 2)
        s = tk._inject_snapshot(s, r % runner.topo.n, lanes % 2 == 0)
        s = tk._exact_tick(s)
    return s


@pytest.mark.parametrize("impl,faulted", [("cascade", False),
                                          ("cascade", True),
                                          ("wave", False)])
@pytest.mark.parametrize("mode", ["drain", "flush"])
def test_plain_lane_gate(mode, impl, faulted):
    """``fused_ticks_plain`` with ``live`` in "drain" (per-lane limits,
    one of them already reached) and "flush": every lane outside ``live``
    is leaf-equal to its input; every live lane equals the same launch
    given to it alone; and the steps did tick the live lanes."""
    kw = dict(faults=Faults(3, **PROGRAM), quarantine=True) if faulted \
        else {}
    runner = BatchedRunner(PSPEC, SimConfig.for_workload(**CFG),
                           HashDelay(11), 6, scheduler="exact",
                           exact_impl=impl, device="cpu", megatick=4, **kw)
    tk = runner.kernel
    s0 = _mid_stream(runner)
    live = torch.tensor([True, False, True, True, False, True])
    limit = (s0.time + torch.tensor([50, 50, 50, 0, 50, 50],
                                    dtype=torch.int32))
    args = dict(mode=mode, length=4, live=live,
                limit=limit if mode == "drain" else None)
    got = km.fused_ticks_plain(tk, BatchedRunner._own(s0), **args)
    assert bool((got.time > s0.time)[live].any())
    for lane in range(6):
        one = s0._replace(**{
            f: (tuple(w[lane:lane + 1] for w in getattr(s0, f))
                if f == "delay_state" else getattr(s0, f)[lane:lane + 1])
            for f in s0._fields})
        if live[lane]:
            one = km.fused_ticks_plain(
                tk, BatchedRunner._own(one), mode=mode, length=4,
                live=None, limit=(limit[lane:lane + 1] if mode == "drain"
                                  else None))
        for f in s0._fields:
            a, b = getattr(got, f), getattr(one, f)
            pairs = zip(a, b) if f == "delay_state" else [(a, b)]
            for x, y in pairs:
                assert torch.equal(x[lane:lane + 1], y), (mode, lane, f)
    assert torch.equal(got.time[3], s0.time[3]) or mode == "flush"
    with pytest.raises(ValueError, match="live="):
        km.fused_ticks_plain(tk, s0, mode="ticks", length=1)
