"""The reference-literal fold (``exact_impl="fold"``, ROADMAP A5b) of the
port against the JAX package's, on the CPU.

The fold steps the N sources of a tick one by one, each popping its first
eligible out-edge and handling it before the next source looks (the JAX
``TickKernel._tick``). On the same topology, program and sampler the
port's fold equals the JAX fold leaf for leaf (tolerance: none, integer
work): batched storms at megatick 1 and 4 under the hash and threefry
samplers, a stream (JAX ``run_stream`` takes the fold too), and the
flight recorder's ring of a traced ``DenseSim``. The fold also equals the
port's cascade (the cascade's docstring proves the two bit-identical),
runs the 7 goldens through ``DenseSim(exact_impl="fold")`` at megatick 8
(K single fold ticks: the fold has no fused form, and
``fused_tick="on"`` refuses it by name), and raises ValueError under the
adversary or the supervisor, as JAX does.
"""

import jax
import numpy as np
import pytest

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.dense import DenseSim as JaxDenseSim
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import HashJaxDelay, UniformJaxDelay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu.utils.tracing import JaxTrace
from chandy_lamport_tpu_torch.api import check_reference_case
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.dense import DenseSim
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import (
    FixedDelay,
    GoExactDelay,
    HashDelay,
    UniformDelay,
)
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils.carry import state_to_numpy
from chandy_lamport_tpu_torch.utils.fixtures import read_topology_file
from chandy_lamport_tpu_torch.utils.goldens import (
    REFERENCE_TESTS,
    fixture_path,
)
from chandy_lamport_tpu_torch.utils.tracing import Trace

CFG = dict(max_snapshots=4, queue_capacity=24, max_recorded=32)
CASES = {t[1].removesuffix(".events"): t for t in REFERENCE_TESTS}


def _assert_leaves_equal(want, got):
    for field in want._fields:
        xs = jax.tree_util.tree_leaves(getattr(want, field))
        ys = jax.tree_util.tree_leaves(getattr(got, field))
        assert len(xs) == len(ys), field
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (field, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=field)


def _program(runner, phases=6, snapshots=3):
    return workloads.storm_program(
        runner.topo, phases, 1, workloads.staggered_snapshots(
            runner.topo, snapshots, 1, 2, max_phases=phases))


# a ring of 3 slots that overflows (the appends clobber), its drain cut
# at 200 ticks
TIGHT = dict(max_snapshots=4, queue_capacity=3, max_recorded=8,
             max_ticks=200)


@pytest.mark.parametrize("sampler, megatick, cfg", [
    ("hash", 1, CFG), ("uniform", 4, CFG), ("hash", 1, TIGHT)],
    ids=["hash-mt1", "uniform-mt4", "overflow"])
def test_fold_storm_equals_jax(sampler, megatick, cfg):
    """A storm through the fold in both packages (ER-12, B=3): every leaf
    equal; at megatick 4 the port runs K single fold ticks; in rings that
    overflow, the same clobbers and error bits."""
    jdelay, pdelay = {"hash": (HashJaxDelay(5), HashDelay(5)),
                      "uniform": (UniformJaxDelay(5), UniformDelay(5))}[
                          sampler]
    jr = JaxRunner(jax_workloads.erdos_renyi(12, 2.5, 3, tokens=30),
                   JaxSimConfig(**cfg), jdelay, 3, exact_impl="fold",
                   megatick=megatick)
    pr = BatchedRunner(workloads.erdos_renyi(12, 2.5, 3, tokens=30),
                       SimConfig(**cfg), pdelay, 3, exact_impl="fold",
                       megatick=megatick, device="cpu")
    prog = _program(pr)
    want = jax.device_get(jr.run_storm(jr.init_batch(), prog))
    got = pr.run_storm(pr.init_batch_device(), prog)
    _assert_leaves_equal(want, state_to_numpy(got, pr.delay))
    assert (int(got.error.max()) == 0) == (cfg is CFG)
    assert pr.kernel.fold_steps > 0
    assert pr.fused == "off"
    assert ("fold" in pr.fused_reason) == (megatick > 1)


@pytest.mark.parametrize("delay", ["hash", "fixed"])
def test_fold_equals_the_port_cascade(delay):
    """The fold and the cascade give the same storm (SF-24, B=4, the hash
    or a fixed delay): every leaf equal, error-free."""
    sampler = HashDelay(9) if delay == "hash" else FixedDelay(2)
    spec = workloads.scale_free(24, 2, 5, tokens=40)
    ends = []
    for impl in ("fold", "cascade"):
        r = BatchedRunner(spec, SimConfig(**CFG), sampler, 4,
                          exact_impl=impl, device="cpu")
        ends.append(state_to_numpy(
            r.run_storm(r.init_batch_device(), _program(r, 8, 4)), sampler))
    _assert_leaves_equal(*ends)
    assert int(ends[0].error.max()) == 0


def test_fold_stream_equals_jax():
    """``run_stream`` through the fold (ring-8, 6 jobs, B=3): every row,
    the summary and the final lane state equal the JAX run's."""
    from test_torch_stream_exact import _port_job

    jspec = jax_workloads.ring_topology(8)
    jr = JaxRunner(jspec, JaxSimConfig.for_workload(snapshots=4),
                   HashJaxDelay(seed=11), 3, scheduler="exact",
                   exact_impl="fold")
    pr = BatchedRunner(workloads.ring_topology(8),
                       SimConfig.for_workload(snapshots=4), HashDelay(11), 3,
                       scheduler="exact", exact_impl="fold", device="cpu")
    jobs = jax_workloads.stream_jobs(jspec, 6, seed=5, base_phases=3,
                                     max_phases=8)
    jstate, jstream = jr.run_stream(jr.pack_jobs(jobs), stretch=3,
                                    drain_chunk=16)
    pstate, pstream = pr.run_stream(pr.pack_jobs([_port_job(j)
                                                  for j in jobs]),
                                    stretch=3, drain_chunk=16)
    assert pr.stream_results(pstream) == jr.stream_results(jstream)
    assert pr.summarize_stream(pstream) == jr.summarize_stream(jstream)
    _assert_leaves_equal(jax.device_get(jstate),
                         state_to_numpy(pstate, pr.delay))


@pytest.mark.parametrize("name", list(CASES))
def test_goldens_through_the_fold(name):
    """``DenseSim(exact_impl="fold")`` at its default megatick 8: every
    snapshot equals its ``.snap`` file."""
    sim = check_reference_case(*CASES[name], device="cpu",
                               exact_impl="fold")
    assert sim.kernel.exact_impl == "fold" and sim.kernel.megatick == 8


def test_fold_trace_ring_equals_jax():
    """A traced ``DenseSim`` through the fold (10nodes' topology and
    script, the Go-exact stream): the whole state equals the JAX traced
    fold's, the flight recorder's ring and count included, and the ring
    holds every event of the run."""
    from chandy_lamport_tpu.models.delay import GoExactDelay as HostGoExact
    from chandy_lamport_tpu.utils.fixtures import (
        read_events_file as j_events,
    )
    from chandy_lamport_tpu.utils.fixtures import (
        read_topology_file as j_top,
    )
    from chandy_lamport_tpu_torch.utils.fixtures import read_events_file

    top, events, _ = CASES["10nodes"]
    ref = JaxDenseSim(j_top(fixture_path(top)), HostGoExact(77), None,
                      "fold", megatick=1, trace=JaxTrace())
    ref.run_events(j_events(fixture_path(events)))
    sim = DenseSim(read_topology_file(fixture_path(top)), GoExactDelay(77),
                   None, "fold", 1, trace=Trace(), device="cpu")
    sim.run_events(read_events_file(fixture_path(events)))
    _assert_leaves_equal(jax.device_get(ref.state), sim.host_state())
    recorded, dropped = sim.trace.counts()
    assert recorded > 50 and dropped == 0
    assert sim.trace.pretty() == ref.trace.pretty()


def test_fold_refusals():
    """The fold refuses the adversary and the supervisor (ValueError, the
    JAX message), ``fused_tick="on"`` names it among the unmet
    requirements, and "off" and "auto" run K single fold ticks."""
    spec = workloads.ring_topology(4)
    with pytest.raises(ValueError, match="runs uninjured"):
        BatchedRunner(spec, SimConfig(), HashDelay(1), 2, exact_impl="fold",
                      faults=Faults(1, drop_rate=0.1), device="cpu")
    with pytest.raises(ValueError, match="no snapshot supervisor"):
        BatchedRunner(spec, SimConfig(snapshot_timeout=9), HashDelay(1), 2,
                      exact_impl="fold", device="cpu")
    with pytest.raises(ValueError, match="exact_impl='fold'"):
        BatchedRunner(spec, SimConfig(), HashDelay(1), 2, exact_impl="fold",
                      megatick=4, fused_tick="on", device="cpu")
    with pytest.raises(ValueError, match="runs uninjured"):
        JaxRunner(jax_workloads.ring_topology(4), JaxSimConfig(),
                  HashJaxDelay(1), 2, exact_impl="fold",
                  faults=JaxFaults(1, drop_rate=0.1))
    for knob in ("off", "auto"):
        r = BatchedRunner(spec, SimConfig(), HashDelay(1), 2,
                          exact_impl="fold", megatick=4, fused_tick=knob,
                          device="cpu")
        assert r.fused == "off"
