"""The port's exact-scheduler storm against the JAX package's, leaf for
leaf.

The JAX ``BatchedRunner(scheduler="exact", exact_impl="cascade",
kernel_engine="xla")`` and the port's ``BatchedRunner(scheduler="exact",
device="cpu")`` run the same small storms (sf-32, er-16, ring-8; B=4, S=4,
8 phases, 4 staggered snapshots, hash delay) from the same seeds; every
``DenseState`` leaf — the rings, the recording windows, the delay
sampler's stream position and the error word included — must be equal in
value and dtype. Tolerance: none. Also: the mid-storm carry from JAX into
the port, the multi-tick loop, the capacity-overflow regimes, and the
fold, which runs now and is refused only under the adversary.
"""

import functools

import jax
import numpy as np
import pytest

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.ops.delay_jax import HashJaxDelay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.state import (
    ERR_QUEUE_OVERFLOW,
    ERR_RECORD_OVERFLOW,
)
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils.carry import (
    state_from_numpy,
    state_to_numpy,
)

GRAPHS = {
    "sf32": ("scale_free", (32, 2), dict(seed=3, tokens=20), "int16"),
    "er16": ("erdos_renyi", (16, 2.5), dict(seed=11, tokens=20), "int32"),
    "ring8": ("ring_topology", (8,), dict(tokens=20), "int32"),
}
# ring mode holds the markers in the rings too, hence C=24 (for_workload)
CFG = dict(max_snapshots=4, queue_capacity=24, max_recorded=32)
BATCH, PHASES, SEED = 4, 8, 17


@functools.lru_cache(maxsize=None)
def _pair(graph, **overrides):
    """The JAX and port runners of one cell, built once per module (the
    JAX runner's jit caches live on the instance), and the program."""
    family, args, kw, rec = GRAPHS[graph]
    cfg = {**CFG, "record_dtype": rec, **overrides}
    jr = JaxRunner(getattr(jax_workloads, family)(*args, **kw),
                   JaxSimConfig(**cfg), HashJaxDelay(SEED), BATCH,
                   scheduler="exact", exact_impl="cascade",
                   kernel_engine="xla")
    tr = BatchedRunner(getattr(workloads, family)(*args, **kw),
                       SimConfig(**cfg), HashDelay(SEED), BATCH,
                       scheduler="exact", device="cpu")
    prog = workloads.storm_program(tr.topo, PHASES, 1, workloads.
                                   staggered_snapshots(tr.topo, 4, 1, 2,
                                                       max_phases=PHASES))
    return jr, tr, prog


def _assert_states_equal(ref, got):
    """Every leaf equal in value, shape and dtype."""
    for name in ref._fields:
        xs = jax.tree_util.tree_leaves(getattr(ref, name))
        ys = jax.tree_util.tree_leaves(getattr(got, name))
        assert len(xs) == len(ys), name
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (name, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_exact_storm_matches_jax(graph):
    """(a) A full exact storm with drain and flush: every leaf equal, no
    error bits, every snapshot complete, and the marker fold ran."""
    jr, tr, prog = _pair(graph)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    before = tr.kernel.fold_steps
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got))
    assert int(np.max(ref.error)) == 0
    assert tr.kernel.fold_steps > before
    # the lanes drain to different clocks: the drain froze finished lanes
    assert len(set(np.asarray(ref.time).tolist())) > 1
    summary = BatchedRunner.summarize(got)
    assert summary == JaxRunner.summarize(jax.device_put(ref))
    assert summary["snapshots_completed"] == summary["snapshots_started"] \
        == BATCH * 4


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_exact_carry_across_mid_storm(graph):
    """(b) JAX runs the phases, the port takes the state over and drains
    it; the JAX drain of the same state gives the same leaves."""
    jr, tr, prog = _pair(graph)
    mid = jax.device_get(jr.run_storm(jr.init_batch_device(), prog,
                                      drain=False))
    carried = state_from_numpy(mid, "cpu")
    _assert_states_equal(mid, state_to_numpy(carried))
    got = tr.drain(carried)
    # the drain left the state it was given as it was
    _assert_states_equal(mid, state_to_numpy(carried))
    ref = jax.device_get(jr.drain(jax.device_put(mid)))
    _assert_states_equal(ref, state_to_numpy(got))


def test_exact_run_ticks_matches_jax():
    """The multi-tick loop on a mid-storm state: each lane ticks until its
    count is done or its rings are empty, then takes the rest as one time
    increment (the JAX ``run_ticks`` under vmap, quiescence exits per
    lane)."""
    jr, tr, prog = _pair("ring8")
    mid = jax.device_get(jr.run_storm(jr.init_batch_device(), prog,
                                      drain=False))
    for n in (3, 40):
        ref = jax.device_get(jr.run_ticks(jax.device_put(mid), n))
        got = tr.kernel._run_ticks(
            BatchedRunner._own(state_from_numpy(mid, "cpu")), n)
        _assert_states_equal(ref, state_to_numpy(got))
    # after 40 ticks every lane is quiet: each took its quiet stretch as
    # one time increment
    assert int(np.asarray(ref.q_len).sum()) == 0


@pytest.mark.parametrize("overrides, bit", [
    (dict(queue_capacity=4, max_ticks=40), ERR_QUEUE_OVERFLOW),
    (dict(max_recorded=2), ERR_RECORD_OVERFLOW),
], ids=["queue_overflow", "record_overflow"])
def test_exact_error_regimes_match_jax(overrides, bit):
    """(c) Capacities too small for the storm: ring overflow (the append
    clobbers a live slot, then the drain runs into its tick limit) and
    log overflow fire the same bits on the same lanes, with the same
    state, as in the JAX run."""
    jr, tr, prog = _pair("sf32", **overrides)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got))
    assert int((got.error & bit).count_nonzero()) > 0


@pytest.mark.parametrize("impl", ["fold"])
def test_unported_exact_formulations_raise(impl):
    """(d) Every exact formulation is ported now (the wave:
    tests/test_torch_wave.py; the fold: tests/test_torch_fold.py): the
    fold builds and runs a storm equal to the cascade's, and raises only
    where the JAX fold does, under the adversary (ValueError)."""
    from chandy_lamport_tpu_torch.models.faults import Faults

    spec = workloads.ring_topology(4)
    ends = []
    for form in (impl, "cascade"):
        r = BatchedRunner(spec, SimConfig(), HashDelay(1), 2,
                          scheduler="exact", exact_impl=form, device="cpu")
        prog = workloads.storm_program(r.topo, 4, 1, workloads.
                                       staggered_snapshots(r.topo, 1))
        ends.append(state_to_numpy(r.run_storm(r.init_batch_device(), prog)))
    _assert_states_equal(*ends)
    with pytest.raises(ValueError, match="runs uninjured"):
        BatchedRunner(spec, SimConfig(), HashDelay(1), 2, scheduler="exact",
                      exact_impl=impl, device="cpu",
                      faults=Faults(1, drop_rate=0.1))
