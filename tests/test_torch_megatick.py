"""The port's megatick K > 1 against the JAX package's fused megatick, leaf
for leaf, on the CPU.

The JAX side runs ``fused_tick="on"`` with ``kernel_engine="pallas"``: its
``fused_scan`` kernel in interpret mode, as ``tests/test_megatick_fused.py``
runs it. The port side runs the same steps through ``fused_ticks_plain``
(on the CPU the megaticks take the plain form: "CPU: the plain form"; the
CUDA kernel is held to that plain form on the card, tests/test_torch_cuda.py
and chip_smoke.py). Every ``DenseState`` leaf — rings, windows, log, the
delay stream's position, error bits — must be equal in value and dtype.
Tolerance: none (integer state). Each JAX interpret-mode compile is shared
by the cases of a module-scoped fixture.
"""

import random

import jax
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.dense import DenseSim as JaxDenseSim
from chandy_lamport_tpu.core.state import DenseTopology as JaxTopology
from chandy_lamport_tpu.core.state import init_state as jax_init_state
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.delay import GoExactDelay as HostGoExact
from chandy_lamport_tpu.ops.delay_jax import HashJaxDelay
from chandy_lamport_tpu.ops.tick import TickKernel as JaxTickKernel
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu.utils.fixtures import read_events_file as j_events
from chandy_lamport_tpu.utils.fixtures import read_topology_file as j_top
from chandy_lamport_tpu.utils.randgen import random_strongly_connected
from chandy_lamport_tpu_torch import BatchedRunner, DenseSim, SimConfig
from chandy_lamport_tpu_torch.api import run_events_file
from chandy_lamport_tpu_torch.core.state import DenseState, DenseTopology
from chandy_lamport_tpu_torch.kernels import megatick as km
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import GoExactDelay, HashDelay
from chandy_lamport_tpu_torch.ops.tick import TickKernel
from chandy_lamport_tpu_torch.utils.carry import (
    state_from_numpy,
    state_to_numpy,
)
from chandy_lamport_tpu_torch.utils.fixtures import (
    TopologySpec,
    read_topology_file,
)
from chandy_lamport_tpu_torch.utils.goldens import (
    REFERENCE_TESTS,
    fixture_path,
)

CFG10 = dict(max_snapshots=4, queue_capacity=32, max_recorded=64)
K = 4


def _assert_leaves_equal(want, got):
    """Every leaf of the JAX host state ``want`` equals the port's host
    state ``got`` (state_to_numpy) in value, shape and dtype."""
    for field in want._fields:
        xs = jax.tree_util.tree_leaves(getattr(want, field))
        ys = jax.tree_util.tree_leaves(getattr(got, field))
        assert len(xs) == len(ys), field
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (field, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=field)


def _lane(host):
    """A one-lane port state from an unbatched JAX host state."""
    return state_from_numpy(DenseState(*(
        tuple(np.asarray(w)[None] for w in leaf) if isinstance(leaf, tuple)
        else np.asarray(leaf)[None] for leaf in host)), "cpu")


def _unlane(state, delay):
    host = state_to_numpy(state, delay)
    return DenseState(*(tuple(w[0] for w in leaf) if isinstance(leaf, tuple)
                        else leaf[0] for leaf in host))


@pytest.fixture(scope="module")
def pair10():
    """The JAX fused kernel of tests/test_megatick_fused.py (K=4, cascade,
    pallas, fused on, 5-edge blocks) on the strongly connected 10-node
    graph with HashDelay(7), the port's K=4 tick kernel on the same graph,
    and a loaded state: 2 tokens on every third edge, one snapshot."""
    spec = random_strongly_connected(random.Random(11), 10)
    topo = JaxTopology(spec)
    jcfg = JaxSimConfig(**CFG10)
    jdelay = HashJaxDelay(seed=7)
    fused = JaxTickKernel(topo, jcfg, jdelay, exact_impl="cascade",
                          megatick=K, kernel_engine="pallas",
                          fused_tick="on", fused_block_edges=5)
    assert fused.fused == "on"
    s = jax_init_state(topo, jcfg, jdelay.init_state())
    for e in range(0, topo.e, 3):
        s = fused.inject_send(s, np.int32(e), np.int32(2))
    s = fused.inject_snapshot(s, np.int32(0))
    delay = HashDelay(7)
    port = TickKernel(DenseTopology(TopologySpec(spec.nodes, spec.links)),
                      SimConfig(**CFG10), delay, "cpu", megatick=K)
    return fused, port, delay, jax.device_get(s)


@pytest.mark.parametrize("n", [7, 9, 40], ids=["rem3", "rem1", "quiescent"])
def test_run_ticks_matches_jax_fused(pair10, n):
    """``_run_ticks`` at K=4: the ``n % K`` remainder first, then full
    megaticks (n=40 runs far past quiescence: the quiet steps are bumps
    and the rest lands as one increment)."""
    fused, port, delay, s = pair10
    want = jax.device_get(fused.run_ticks(s, np.int32(n)))
    got = port._run_ticks(_lane(s), n)
    _assert_leaves_equal(want, _unlane(got, delay))
    if n == 40:
        assert int(np.asarray(want.q_len).sum()) == 0


def test_drain_and_flush_matches_jax_fused(pair10):
    """The fused drain (cond-gated megatick steps) and the fused flush
    (max_delay + 1 steps): the snapshot completes, leaves equal."""
    fused, port, delay, s = pair10
    want = jax.device_get(fused.drain_and_flush(s))
    got = port._drain_and_flush(_lane(s))
    _assert_leaves_equal(want, _unlane(got, delay))
    assert int(np.asarray(want.completed)[0]) == 10
    assert int(want.error) == 0


@pytest.fixture(scope="module")
def storm_er16():
    """A batched er-16 B=4 exact storm at megatick 8: the JAX runner with
    the fused kernel and the port's runner, and their final states."""
    cfg = dict(max_snapshots=4, queue_capacity=24, max_recorded=32)
    spec_args = (16, 2.5)
    spec_kw = dict(seed=11, tokens=20)
    jr = JaxRunner(jax_workloads.erdos_renyi(*spec_args, **spec_kw),
                   JaxSimConfig(**cfg), HashJaxDelay(17), 4,
                   scheduler="exact", exact_impl="cascade", megatick=8,
                   kernel_engine="pallas", fused_tick="on")
    tr = BatchedRunner(workloads.erdos_renyi(*spec_args, **spec_kw),
                       SimConfig(**cfg), HashDelay(17), 4, scheduler="exact",
                       device="cpu", megatick=8)
    prog = workloads.storm_program(
        tr.topo, 8, 1, workloads.staggered_snapshots(tr.topo, 4, 1, 2,
                                                     max_phases=8))
    want = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    return jr, tr, prog, want


def test_batched_storm_matches_jax_fused(storm_er16):
    """The whole storm: phases one tick at a time, drain and flush in
    megaticks. The lanes finish at different ticks, so in the last drain
    megatick some lanes are not draining at launch and must be left
    exactly as they were."""
    jr, tr, prog, want = storm_er16
    assert jr.fused == "on" and tr.fused == "off"
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_leaves_equal(want, state_to_numpy(got))
    clocks = np.asarray(want.time).tolist()
    assert len(set(clocks)) > 1, clocks
    assert int(np.max(want.error)) == 0
    summary = BatchedRunner.summarize(got, tr)
    assert summary["megatick"] == 8 and summary["fused_tick"] == "off"
    assert summary["fused_reason"] == "CPU: the plain form"


def test_batched_storm_megatick_equals_megatick_1(storm_er16):
    """Megatick 8 and megatick 1 end in the same leaves (the JAX claim
    of bit-identity at any K), and both equal the JAX fused run."""
    _, tr, prog, want = storm_er16
    one = BatchedRunner(workloads.erdos_renyi(16, 2.5, seed=11, tokens=20),
                        tr.config, HashDelay(17), 4, scheduler="exact",
                        device="cpu")
    got = one.run_storm(one.init_batch_device(), prog)
    _assert_leaves_equal(want, state_to_numpy(got))


@pytest.mark.parametrize("name", ["8nodes-concurrent-snapshots", "10nodes"])
def test_golden_megatick8_matches_jax_fused(name):
    """``DenseSim()`` at its default megatick 8 against the JAX
    ``DenseSim(megatick=8, kernel_engine="pallas", fused_tick="on")``
    with the Go-exact stream: the final states are equal leaf for leaf."""
    top, events, _ = next(t for t in REFERENCE_TESTS
                          if t[1] == f"{name}.events")
    seed = 8053172852482175523 + 1
    ref = JaxDenseSim(j_top(fixture_path(top)), HostGoExact(seed),
                      megatick=8, kernel_engine="pallas", fused_tick="on")
    assert ref.fused == "on"
    ref.run_events(j_events(fixture_path(events)))
    _, sim = run_events_file(fixture_path(top), fixture_path(events),
                             device="cpu")
    assert sim.kernel.megatick == 8
    _assert_leaves_equal(jax.device_get(ref.state), sim.host_state())


def test_all_goldens_through_the_default():
    """The 7 goldens, 21 snapshots, through ``DenseSim``'s default
    (megatick 8; the plain form on the CPU)."""
    from chandy_lamport_tpu_torch.api import run_reference_tests

    sim = DenseSim(read_topology_file(fixture_path("2nodes.top")),
                   GoExactDelay(1), device="cpu")
    assert sim.kernel.megatick == 8
    assert (sim.fused, sim.fused_reason) == ("off", "CPU: the plain form")
    results = run_reference_tests("cpu")
    assert [why for _, _, why in results] == [None] * 7
    assert sum(n for _, n, _ in results) == 21


def test_resolution_on_names_every_unmet_requirement():
    """The card launches the kernel or refuses, naming what it lacks: a
    lane over a block's shared memory raises NotImplementedError (ROADMAP
    A4c, the tiled kernel), whatever else holds; there is no plain form
    on the card. Megatick 1 and the CPU resolve "off" with their
    reasons."""
    cuda = torch.device("cuda")
    assert km.resolve_fused(megatick=8, device=cuda, smem_bytes=48_480) == (
        "on", "fused megatick engaged")
    with pytest.raises(NotImplementedError) as info:
        km.resolve_fused(megatick=8, device=cuda,
                         smem_bytes=km.SMEM_BUDGET + 16)
    for word in (str(km.SMEM_BUDGET + 16), "shared memory", "A4c",
                 "megatick=1"):
        assert word in str(info.value), word
    state, why = km.resolve_fused(megatick=1, device=cuda,
                                  smem_bytes=km.SMEM_BUDGET + 16)
    assert state == "off" and "megatick=1" in why
    assert km.resolve_fused(megatick=8, device=torch.device("cpu"),
                            smem_bytes=km.SMEM_BUDGET + 16) == (
        "off", "CPU: the plain form")
    # the ER-256 lane's working set fits a block (48,480 B)
    assert km.fused_smem_bytes(256, 768, 8) == 48_480


@pytest.mark.parametrize("arm", ["faults", "timeout", "every"])
def test_megatick_runs_faults_and_supervisor(arm):
    """Megatick > 1 with the adversary or the supervisor builds and runs
    (the fused megatick carries them) and ends where megatick 1 does;
    the sync scheduler still refuses megatick > 1 with ValueError."""
    spec = workloads.ring_topology(4)
    kw = {"faults": dict(faults=Faults(3, drop_rate=0.1, crash_rate=0.2,
                                       crash_mode="lossy"),
                         quarantine=True),
          "timeout": dict(config=SimConfig(snapshot_timeout=20)),
          "every": dict(config=SimConfig(snapshot_every=5))}[arm]
    cfg = kw.pop("config", SimConfig())
    finals = []
    for megatick in (8, 1):
        runner = BatchedRunner(spec, cfg, HashDelay(1), 2, scheduler="exact",
                               device="cpu", megatick=megatick, **kw)
        assert runner.megatick == megatick
        prog = workloads.storm_program(runner.topo, 6, 1,
                                       workloads.staggered_snapshots(
                                           runner.topo, 1, 1, 2,
                                           max_phases=6))
        finals.append(state_to_numpy(runner.run_storm(
            runner.init_batch_device(), prog), runner.delay))
    _assert_leaves_equal(*finals)
    # the sync scheduler has no megatick (the JAX one ignores it): it
    # refuses K > 1 rather than run K = 1 under a K = 8 label
    with pytest.raises(ValueError, match="exact scheduler"):
        BatchedRunner(spec, SimConfig(), HashDelay(1), 2, scheduler="sync",
                      device="cpu", megatick=8)


def test_card_megatick_launches_or_raises():
    """A tick kernel for the card at megatick > 1 whose lane does not fit
    a block's shared memory raises at construction (ROADMAP A4c) instead
    of taking the plain form on the card."""
    topo = DenseTopology(workloads.ring_topology(2000))
    assert km.fused_smem_bytes(topo.n, topo.e, 16) > km.SMEM_BUDGET
    with pytest.raises(NotImplementedError, match="A4c"):
        TickKernel(topo, SimConfig(max_snapshots=16), HashDelay(1), "cuda",
                   megatick=8)
