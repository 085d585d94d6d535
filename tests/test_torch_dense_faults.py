"""Faults in the port's single-instance simulator (``DenseSim(faults=)``,
ROADMAP A3c) against the JAX package's, on the CPU.

The same topology, script, sampler and adversary go through the JAX
``DenseSim`` and the port's; after the run every leaf of the state is
equal (tolerance: none, integer work), at zero and non-zero rates, at
megatick 1 and 8 (the port's megatick 8 on the CPU is the fused
megatick's plain form). Also: the zero-rate adversary keeps the 7 goldens
(the JAX ``tests/test_faults.py:92``), the single instance's fault key is
the JAX ``init_state()`` (``base | 1``, lane 0 of ``init_batch_state``),
the fold refuses the adversary and the supervisor with ValueError as in
JAX, ``total_tokens()`` equals the JAX one mid-run, and
``run_events_file``'s keywords ``faults``, ``exact_impl``,
``delay_model`` and ``config`` run what the JAX function runs.
"""

import jax
import numpy as np
import pytest

from chandy_lamport_tpu import api as jax_api
from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.dense import DenseSim as JaxDenseSim
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.delay import GoExactDelay as HostGoExact
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import HashJaxDelay
from chandy_lamport_tpu_torch.api import (
    check_reference_case,
    run_events_file,
)
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.dense import DenseSim
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import GoExactDelay, HashDelay
from chandy_lamport_tpu_torch.utils.goldens import (
    REFERENCE_TESTS,
    fixture_path,
)

CASES = {t[1].removesuffix(".events"): t for t in REFERENCE_TESTS}
CFG = dict(max_snapshots=4, queue_capacity=24, max_recorded=32)
# every class of the adversary, pause crashes, and marker faults retried
# by the supervisor
PROGRAMS = {
    "zero": {},
    "every class": dict(drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05,
                        crash_rate=0.2, crash_period=16, crash_len=2,
                        marker_drop_rate=0.05, marker_dup_rate=0.05,
                        marker_jitter_rate=0.05),
}


def _run(sim, events):
    """``sim.run_events(events)``: the snapshots, or the error the sticky
    bits raised after the drain (the state is the drained one either
    way)."""
    try:
        return [str(s) for s in sim.run_events(events)]
    except RuntimeError as exc:
        return type(exc).__name__


# the golden's faulted run: marker faults only, so its balances stay valid
JITTER = dict(marker_jitter_rate=0.3, marker_dup_rate=0.2)


def _assert_leaves_equal(want, got):
    for field in want._fields:
        xs = jax.tree_util.tree_leaves(getattr(want, field))
        ys = jax.tree_util.tree_leaves(getattr(got, field))
        assert len(xs) == len(ys), field
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (field, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=field)


def _scripts(seed: int):
    """One stream job's script on ER-10, in both packages' event types
    (event for event equal)."""
    kw = dict(base_phases=12, max_phases=12, snapshots_per_job=2)
    jspec = jax_workloads.erdos_renyi(10, 3.0, 3, tokens=40)
    spec = workloads.erdos_renyi(10, 3.0, 3, tokens=40)
    (jev,) = jax_workloads.stream_jobs(jspec, 1, seed=seed, **kw)
    (pev,) = workloads.stream_jobs(spec, 1, seed=seed, **kw)
    assert [str(e) for e in jev] == [str(e) for e in pev]
    return jspec, jev, spec, pev


@pytest.mark.parametrize("megatick", [1, 8])
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_faulted_dense_sim_equals_jax(program, megatick):
    """A script through both ``DenseSim``s under the adversary (and the
    supervisor's timeout): every leaf equal, the snapshots equal; at the
    non-zero program the faults fire."""
    jspec, jev, spec, pev = _scripts(11)
    kw = PROGRAMS[program]
    sup = dict(snapshot_timeout=24, snapshot_retries=6) if kw else {}
    ref = JaxDenseSim(jspec, HashJaxDelay(5), JaxSimConfig(**CFG, **sup),
                      megatick=megatick, faults=JaxFaults(3, **kw))
    want = _run(ref, jev)
    sim = DenseSim(spec, HashDelay(5), SimConfig(**CFG, **sup), "cascade",
                   megatick, faults=Faults(3, **kw), device="cpu")
    got = _run(sim, pev)
    _assert_leaves_equal(jax.device_get(ref.state), sim.host_state())
    assert got == want
    assert sim.kernel.megatick == megatick and sim.faults is not None
    fired = int(sim.host_state().fault_counts.sum())
    assert (fired > 0) == bool(kw)


@pytest.mark.parametrize("name", list(CASES))
def test_zero_rate_adversary_keeps_the_goldens(name):
    """``run_events_file(faults=Faults(7))`` at megatick 8: every
    snapshot equals its ``.snap`` file (the JAX claim of
    ``tests/test_faults.py:92``), no fault fired."""
    sim = check_reference_case(*CASES[name], device="cpu",
                               faults=Faults(7))
    host = sim.host_state()
    assert int(host.fault_counts.sum()) == 0 and int(host.fault_key) != 0
    assert sim.kernel.megatick == 8


def test_zero_rate_golden_state_equals_jax():
    """On 8nodes-concurrent-snapshots the zero-rate faulted run's final
    state equals the JAX ``run_events_file(backend="jax",
    faults=JaxFaults(7))``'s leaf for leaf, the Go stream included."""
    top, events, _ = CASES["8nodes-concurrent-snapshots"]
    _, ref = jax_api.run_events_file(fixture_path(top), fixture_path(events),
                                     backend="jax", faults=JaxFaults(7))
    _, sim = run_events_file(fixture_path(top), fixture_path(events),
                             faults=Faults(7), device="cpu")
    _assert_leaves_equal(jax.device_get(ref.state), sim.host_state())


def test_single_instance_fault_key_is_lane_zero():
    """The one lane's key is the JAX ``init_state()`` = ``base | 1``,
    lane 0 of ``init_batch_state`` (both packages)."""
    spec = workloads.ring_topology(4)
    for seed in (0, 3, 7, 2**31 + 5):
        sim = DenseSim(spec, HashDelay(1), faults=Faults(seed), device="cpu")
        jkey = int(JaxFaults(seed).init_state())
        assert int(sim.state.fault_key[0]) == jkey
        assert jkey == int(np.asarray(JaxFaults(seed).init_batch_state(1))[0])
        assert jkey == int(Faults(seed).init_batch_state(1, "cpu")[0])
        assert jkey & 1


def test_fold_refuses_faults_and_the_supervisor():
    """``exact_impl="fold"`` with the adversary, and with the supervisor
    (timeout or daemon), raises ValueError in both packages, naming the
    specification form."""
    spec, jspec = workloads.ring_topology(4), jax_workloads.ring_topology(4)
    for port, jax_side in (
            (lambda: DenseSim(spec, HashDelay(1), None, "fold",
                              faults=Faults(1, drop_rate=0.1),
                              device="cpu"),
             lambda: JaxDenseSim(jspec, HashJaxDelay(1), None, "fold",
                                 faults=JaxFaults(1, drop_rate=0.1))),
            (lambda: DenseSim(spec, HashDelay(1),
                              SimConfig(snapshot_timeout=5), "fold",
                              device="cpu"),
             lambda: JaxDenseSim(jspec, HashJaxDelay(1),
                                 JaxSimConfig(snapshot_timeout=5), "fold")),
            (lambda: DenseSim(spec, HashDelay(1),
                              SimConfig(snapshot_every=5), "fold",
                              device="cpu"),
             lambda: JaxDenseSim(jspec, HashJaxDelay(1),
                                 JaxSimConfig(snapshot_every=5), "fold"))):
        with pytest.raises(ValueError, match="specification form"):
            jax_side()
        with pytest.raises(ValueError, match="specification form"):
            port()


def test_total_tokens_equals_jax_mid_run():
    """``total_tokens()`` (balances plus in-flight non-marker tokens) of
    both packages after half a faulted script, tokens and markers in
    flight; zero-rate it is the initial total."""
    jspec, jev, spec, pev = _scripts(4)
    kw = PROGRAMS["every class"]
    ref = JaxDenseSim(jspec, HashJaxDelay(2), JaxSimConfig(**CFG),
                      megatick=1, faults=JaxFaults(9, **kw))
    sim = DenseSim(spec, HashDelay(2), SimConfig(**CFG), "cascade", 1,
                   faults=Faults(9, **kw), device="cpu")
    half = len(pev) // 2
    for je, pe in zip(jev[:half], pev[:half]):
        ref.process_event(je)
        sim.process_event(pe)
    assert sim.total_tokens() == ref.total_tokens()
    assert int(sim.host_state().q_len.sum()) > 0
    clean = DenseSim(spec, HashDelay(2), SimConfig(**CFG), device="cpu")
    for pe in pev[:half]:
        clean.process_event(pe)
    assert clean.total_tokens() == int(clean.topo.tokens0.sum())


@pytest.mark.parametrize("kw", [
    dict(exact_impl="wave", delay="hash"),
    dict(exact_impl="fold", delay="go"),
    dict(delay="hash", faults=True),
], ids=["wave, delay_model, config", "fold", "faults"])
def test_run_events_file_keywords_equal_jax(kw):
    """``run_events_file(delay_model=, config=, exact_impl=, faults=)``
    runs what the JAX ``run_events_file(backend="jax", ...)`` runs: the
    same final state leaf for leaf, the same snapshots."""
    top, events, _ = CASES["3nodes-bidirectional-messages"]
    if kw["delay"] == "hash":
        jdelay, pdelay = HashJaxDelay(7), HashDelay(7)
    else:
        jdelay, pdelay = HostGoExact(99), GoExactDelay(99)
    faults = kw.get("faults")
    jsnaps, ref = jax_api.run_events_file(
        fixture_path(top), fixture_path(events), backend="jax",
        delay_model=jdelay, config=JaxSimConfig(**CFG),
        exact_impl=kw.get("exact_impl", "cascade"),
        faults=JaxFaults(5, **JITTER) if faults else None)
    snaps, sim = run_events_file(
        fixture_path(top), fixture_path(events), delay_model=pdelay,
        config=SimConfig(**CFG), exact_impl=kw.get("exact_impl", "cascade"),
        faults=Faults(5, **JITTER) if faults else None, device="cpu")
    _assert_leaves_equal(jax.device_get(ref.state), sim.host_state())
    assert [str(s) for s in snaps] == [str(s) for s in jsnaps]
    assert sim.kernel.exact_impl == kw.get("exact_impl", "cascade")
