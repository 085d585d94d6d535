"""The port's ``run_stream`` on the exact scheduler against the JAX
package's, on the CPU: the cascade at megatick 1 and 4, the wave at
megatick 4, gang admission, a results ring that wraps, and a drain chunk
that is not a multiple of the megatick (its remainder ticks).

At megatick 4 the JAX runner runs its fused megatick kernel in interpret
mode (``kernel_engine="pallas", fused_tick="on"``), so its stream's drain
slice and flush go through ``_fused_stream_drain`` and ``_fused_flush``;
the port runs the same steps through ``fused_ticks_plain`` with the lane
gate (on the card, ``csrc/megatick.cu``: tests/test_torch_cuda.py and
chip_smoke.py). Compared, with no tolerance (integer state): every
result row, every ``summarize_stream`` counter, the final lane state and
the ``StreamState``, leaf for leaf; and every row against its job run
alone through the port's static ``run``.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.ops.delay_jax import HashJaxDelay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu.utils.randgen import random_strongly_connected
from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
from chandy_lamport_tpu_torch.core.spec import (
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.parallel.batch import compile_events
from chandy_lamport_tpu_torch.utils.carry import (
    state_to_numpy,
    stream_to_numpy,
)
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec

CFG = dict(snapshots=4, max_recorded=128)
J, B = 8, 4


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


def _static_rows(spec, runner, pool, jobs):
    """The oracle of the stream: each job alone through the port's static
    ``run`` on a one-lane runner, with its pool row's stream identities."""
    solo = BatchedRunner(spec, runner.config, runner.delay, 1,
                         scheduler="exact",
                         exact_impl=runner.kernel.exact_impl, device="cpu",
                         megatick=runner.megatick)
    rows = []
    for j, job in enumerate(jobs):
        s = solo.init_batch_device()
        s = s._replace(delay_state=tuple(w[j:j + 1]
                                         for w in pool.delay_state))
        out = solo.run(s, compile_events(solo.topo, job))
        rows.append((int(out.time[0]), int(out.error[0]),
                     out.tokens[0].tolist(), int(out.started[0].sum())))
    return rows


@pytest.mark.parametrize("impl,k,graph,admission,rcap,chunk", [
    ("cascade", 1, "ring8", "stream", None, 16),
    ("cascade", 4, "ring8", "stream", None, 10),
    ("wave", 4, "rand10", "stream", None, 16),
    ("cascade", 1, "rand10", "gang", 5, 16),
], ids=["cascade-mt1", "cascade-mt4-chunk10", "wave-mt4",
        "gang-ring-wraps"])
def test_exact_stream_equals_jax(impl, k, graph, admission, rcap, chunk):
    """The exact ``run_stream`` equals the JAX run in every compared leaf
    and row, and each surviving row equals its job run alone."""
    if graph == "ring8":
        jspec = jax_workloads.ring_topology(8)
    else:
        jspec = random_strongly_connected(random.Random(11), 10)
    kw = dict(megatick=k)
    if k > 1:
        kw.update(kernel_engine="pallas", fused_tick="on")
    jr = JaxRunner(jspec, JaxSimConfig.for_workload(**CFG),
                   HashJaxDelay(seed=11), B, scheduler="exact",
                   exact_impl=impl, **kw)
    pspec = TopologySpec(list(jspec.nodes), list(jspec.links))
    pr = BatchedRunner(pspec, SimConfig.for_workload(**CFG), HashDelay(11),
                       B, scheduler="exact", exact_impl=impl, device="cpu",
                       megatick=k)
    jobs = jax_workloads.stream_jobs(jspec, J, seed=5, base_phases=3,
                                     max_phases=12)
    jstate, jstream = jr.run_stream(
        jr.pack_jobs(jobs), stretch=3, drain_chunk=chunk,
        admission=admission, results_capacity=rcap)
    pjobs = [_port_job(j) for j in jobs]
    pool = pr.pack_jobs(pjobs)
    pstate, pstream = pr.run_stream(pool, stretch=3, drain_chunk=chunk,
                                    admission=admission,
                                    results_capacity=rcap)
    rows = pr.stream_results(pstream)
    assert rows == jr.stream_results(jstream)
    summary = pr.summarize_stream(pstream)
    assert summary == jr.summarize_stream(jstream)
    _assert_leaves_equal(jax.device_get(jstate),
                         state_to_numpy(pstate, pr.delay), "state")
    _assert_leaves_equal(jax.device_get(jstream), stream_to_numpy(pstream),
                         "stream")
    assert summary["jobs_done"] == J
    if rcap:
        assert len(rows) == rcap and summary["results_evicted"] == J - rcap
    static = _static_rows(pspec, pr, pool, pjobs)
    for row in rows:
        assert (row["time"], row["error"], row["tokens"],
                row["snapshots_completed"]) == static[row["job"]]
