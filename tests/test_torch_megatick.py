"""The port's megatick K > 1 against the JAX package's fused megatick, leaf
for leaf, on the CPU.

The JAX side runs ``fused_tick="on"`` with ``kernel_engine="pallas"``: its
``fused_scan`` kernel in interpret mode, as ``tests/test_megatick_fused.py``
runs it, in its resident layout and, for the 10-node differentials, also in
its tiled one (``fused_tile="on"``, the ``[E, C]`` rings streamed in 5-edge
blocks, as ``tests/test_megatick_tiled.py`` runs it). The port side runs the same steps through ``fused_ticks_plain``
(on the CPU the megaticks take the plain form: "CPU: the plain form"; the
CUDA kernel, in both of its layouts, is held to that plain form only on the
card, by tests/test_torch_cuda.py and chip_smoke.py). Every ``DenseState`` leaf — rings, windows, log, the
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
from chandy_lamport_tpu.models.faults import JaxFaults
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


def _pair10(layout, extra=None, impl="cascade", fkw=None):
    """The JAX fused kernel of tests/test_megatick_fused.py (K=4, pallas,
    fused on, 5-edge blocks; ``layout`` "tiled" adds ``fused_tile="on"``)
    on the strongly connected 10-node graph with HashDelay(7) (with the
    supervisor knobs ``extra``, the ``impl`` tick and the adversary
    ``fkw``, quarantined), the port's K=4 tick kernel on the same graph,
    and a loaded state: 2 tokens on every third edge, one snapshot at node
    0, whose broadcast appends markers across every 5-edge ring-block
    seam of the tiled layout."""
    spec = random_strongly_connected(random.Random(11), 10)
    topo = JaxTopology(spec)
    jcfg = JaxSimConfig(**CFG10, **(extra or {}))
    jdelay = HashJaxDelay(seed=7)
    jfaults = JaxFaults(seed=3, **fkw) if fkw else None
    tile = {"fused_tile": "on"} if layout == "tiled" else {}
    fused = JaxTickKernel(topo, jcfg, jdelay, exact_impl=impl,
                          megatick=K, kernel_engine="pallas",
                          fused_tick="on", fused_block_edges=5,
                          faults=jfaults, quarantine=fkw is not None, **tile)
    assert fused.fused == "on"
    assert fused.fused_tile == ("on" if tile else "off")
    s = jax_init_state(topo, jcfg, jdelay.init_state(),
                       fault_key=int(jfaults.init_state()) if fkw else 0)
    for e in range(0, topo.e, 3):
        s = fused.inject_send(s, np.int32(e), np.int32(2))
    s = fused.inject_snapshot(s, np.int32(0))
    delay = HashDelay(7)
    port = TickKernel(DenseTopology(TopologySpec(spec.nodes, spec.links)),
                      SimConfig(**CFG10, **(extra or {})), delay,
                      device="cpu", megatick=K, exact_impl=impl,
                      faults=Faults(3, **fkw) if fkw else None,
                      quarantine=fkw is not None)
    return fused, port, delay, jax.device_get(s)


@pytest.fixture(scope="module", params=["resident", "tiled"])
def pair10(request):
    """``_pair10`` in each JAX layout: the cascade with markers crossing
    the ring-block seams."""
    return _pair10(request.param)


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


ARMS10 = {
    # name: (supervisor knobs, exact_impl, adversary)
    "cascade, supervised": (dict(snapshot_timeout=5, snapshot_retries=2),
                            "cascade", None),
    "wave, faulted": (None, "wave", dict(drop_rate=0.25, dup_rate=0.25)),
}


@pytest.mark.parametrize("arm", sorted(ARMS10))
def test_arms_match_jax_tiled(arm):
    """The supervised cascade and the faulted wave against the JAX tiled
    fused megatick (its resident layout is held equal to the tiled one by
    tests/test_megatick_tiled.py): ``_run_ticks`` for 9 ticks (a remainder
    of 1, then megaticks), and the drain and flush, leaves equal."""
    extra, impl, fkw = ARMS10[arm]
    fused, port, delay, s = _pair10("tiled", extra, impl, fkw)
    want = jax.device_get(fused.run_ticks(s, np.int32(9)))
    _assert_leaves_equal(want, _unlane(port._run_ticks(_lane(s), 9), delay))
    want = jax.device_get(fused.drain_and_flush(s))
    _assert_leaves_equal(want, _unlane(port._drain_and_flush(_lane(s)),
                                       delay))
    if fkw:
        assert int(np.asarray(want.fault_counts).sum()) > 0


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
    summary = BatchedRunner.summarize(got, runner=tr)
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
    """The card launches the kernel, in the layout its lane's working set
    allows, and names why: a lane that fits a block's shared memory stays
    resident, one past it takes the tiled layout (a device-memory
    workspace), as the JAX ``fused_tile="auto"`` does; there is no plain
    form on the card and no refusal. Megatick 1 and the CPU resolve "off"
    with their reasons, and so does their layout."""
    cuda = torch.device("cuda")
    fused, why, tile, tile_why = km.resolve_fused(megatick=8, device=cuda,
                                                  smem_bytes=48_480)
    assert (fused, why, tile) == ("on", "fused megatick engaged", "off")
    assert "48480" in tile_why and "resident" in tile_why
    fused, _, tile, why = km.resolve_fused(megatick=8, device=cuda,
                                           smem_bytes=km.SMEM_BUDGET + 16)
    assert (fused, tile) == ("on", "on")
    for word in (str(km.SMEM_BUDGET + 16), "shared memory", "workspace"):
        assert word in why, word
    state, why, tile, _ = km.resolve_fused(megatick=1, device=cuda,
                                           smem_bytes=km.SMEM_BUDGET + 16)
    assert state == "off" and "megatick=1" in why and tile == "off"
    assert km.resolve_fused(megatick=8, device=torch.device("cpu"),
                            smem_bytes=km.SMEM_BUDGET + 16)[:3] == (
        "off", "CPU: the plain form", "off")
    # the ER-256 lane's working set fits a block (52,416 B)
    assert km.fused_smem_bytes(256, 768, 8) == 52_416


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
    a block's shared memory resolves to the tiled layout, never to the
    plain form: on a machine with a card it is built tiled, and without
    one its construction raises instead of running on the CPU."""
    topo = DenseTopology(workloads.ring_topology(2000))
    smem = km.fused_smem_bytes(topo.n, topo.e, 16)
    assert smem > km.SMEM_BUDGET
    fused, _, tile, why = km.resolve_fused(
        megatick=8, device=torch.device("cuda"), smem_bytes=smem)
    assert (fused, tile) == ("on", "on") and "workspace" in why
    if torch.cuda.is_available():
        tk = TickKernel(topo, SimConfig(max_snapshots=16), HashDelay(1),
                        device="cuda", megatick=8)
        assert (tk.fused, tk.fused_tile) == ("on", "on")
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            TickKernel(topo, SimConfig(max_snapshots=16), HashDelay(1),
                       device="cuda", megatick=8)
