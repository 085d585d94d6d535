"""The port's wave tick (``exact_impl="wave"``) against the JAX package's
wave and against the port's own cascade, leaf for leaf, on the CPU.

The wave serves every destination's next pending marker in one host step
and reads the tick's delay draws by stream position, so it must equal
the cascade bit for bit for a position-addressable sampler (hash, fixed):
every ``DenseState`` leaf, the error bits and the sampler's stream
position. Cases: random storms on ring-8, er-24 and sf-32 (B=4) under
``HashDelay`` and ``FixedDelay``; a marker pile-up on a complete digraph
(one tick delivers markers of several sids to one destination, and two of
one sid); the wave's broadcast into a ring that is still full (the
overflow bit) and the capacity edge, through ``DenseSim``; the full
adversary with the supervisor and quarantine; megatick 3 (the plain form
of the fused megatick) against megatick 1; a hash counter a few draws
below 2^32 when a tick's draws begin; the refusal of the order-dependent
Go-exact sampler; and the host step counts (waves <= marker folds).

Under the supervisor the JAX wave re-broadcasts a marker with the bare
sid, which after a retry (epoch > 0) its receivers reject as stale: there
the port's wave follows the cascade (the epoch-tagged payload), and the
tests hold it to the JAX cascade; where no retry happens it is held to the
JAX wave too. Tolerance: none (integer state).
"""

import functools

import jax
import numpy as np
import pytest

from chandy_lamport_tpu.api import run_events as jax_run_events
from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.state import DenseState as JaxDenseState
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.delay import FixedDelay as HostFixedDelay
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import FixedJaxDelay, HashJaxDelay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.dense import DenseBackendError, DenseSim
from chandy_lamport_tpu_torch.core.spec import (
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.core.state import ERR_QUEUE_OVERFLOW
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import (
    FixedDelay,
    GoExactDelay,
    HashDelay,
)
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils.carry import (
    state_from_numpy,
    state_to_numpy,
)
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec

BATCH, PHASES, SEED = 4, 6, 99
GRAPHS = {
    "ring8": ("ring_topology", (8,), dict(tokens=40)),
    "er24": ("erdos_renyi", (24, 2.5), dict(seed=1, tokens=60)),
    "sf32": ("scale_free", (32, 2), dict(seed=2, tokens=60)),
}
CFG = dict(max_snapshots=4, queue_capacity=24, max_recorded=48)
DELAYS = {"hash": (HashDelay, HashJaxDelay, (SEED,)),
          "fixed": (FixedDelay, FixedJaxDelay, (2,))}
# the full adversary of the supervised cases (every class, pause crashes)
EVERY = dict(drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05,
             crash_rate=0.3, crash_period=4, crash_len=1,
             marker_drop_rate=0.1, marker_dup_rate=0.1,
             marker_jitter_rate=0.05)


def _assert_states_equal(ref, got):
    """Every leaf of the host state ``ref`` (JAX or the port's
    ``state_to_numpy``) equals ``got``'s in value, shape and dtype."""
    for name in ref._fields:
        xs = jax.tree_util.tree_leaves(getattr(ref, name))
        ys = jax.tree_util.tree_leaves(getattr(got, name))
        assert len(xs) == len(ys), name
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (name, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=name)


def _spec(graph, ours=True):
    family, args, kw = GRAPHS[graph]
    return getattr(workloads if ours else jax_workloads, family)(*args, **kw)


@functools.lru_cache(maxsize=None)
def _jax_runner(graph, delay, impl, faults=(), **cfg):
    """The JAX runner of one cell, built once per module (its jit caches
    live on the instance)."""
    _, jax_delay, args = DELAYS[delay]
    return JaxRunner(_spec(graph, ours=False), JaxSimConfig(**{**CFG, **cfg}),
                     jax_delay(*args), BATCH, scheduler="exact",
                     exact_impl=impl,
                     faults=JaxFaults(3, **dict(faults)) if faults else None,
                     quarantine=bool(faults))


def _port_runner(graph, delay, impl, faults=(), megatick=1, **cfg):
    ours, _, args = DELAYS[delay]
    return BatchedRunner(_spec(graph), SimConfig(**{**CFG, **cfg}),
                         ours(*args), BATCH, scheduler="exact",
                         exact_impl=impl, device="cpu",
                         faults=Faults(3, **dict(faults)) if faults else None,
                         quarantine=bool(faults), megatick=megatick)


def _program(runner, snapshots=3):
    return workloads.storm_program(runner.topo, PHASES, 2,
                                   workloads.staggered_snapshots(
                                       runner.topo, snapshots))


def _port_storm(runner, prog, state=None, drain=True):
    """(final host state, host steps taken) of a port storm."""
    before = runner.kernel.fold_steps
    if state is None:
        out = runner.run_storm(runner.init_batch_device(), prog, drain=drain)
    else:
        out = runner.drain(state)
    return state_to_numpy(out), runner.kernel.fold_steps - before


@pytest.mark.parametrize("delay", sorted(DELAYS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_wave_storm_matches_jax_wave_and_cascade(graph, delay):
    """A full exact storm with drain and flush: the port's wave equals the
    JAX wave and the port's cascade on every leaf, in fewer host steps."""
    wave = _port_runner(graph, delay, "wave")
    prog = _program(wave)
    got, waves = _port_storm(wave, prog)
    cascade, folds = _port_storm(_port_runner(graph, delay, "cascade"), prog)
    jr = _jax_runner(graph, delay, "wave")
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    _assert_states_equal(ref, got)
    _assert_states_equal(cascade, got)
    assert int(np.max(ref.error)) == 0
    assert 0 < waves <= folds


def test_wave_marker_pileup():
    """Every node of a complete 8-node digraph initiates in the first
    phase: ticks deliver markers of several sids to one destination (more
    than one wave) and two markers of one sid to one destination (a
    same-tick repeat). The wave equals the JAX wave and the cascade."""
    n = 8
    names = [f"N{i}" for i in range(n)]
    edges = sorted((a, b) for a in names for b in names if a != b)
    cfg = dict(max_snapshots=8, queue_capacity=32, max_recorded=96)
    runs = {}
    seen = {"depth": 0, "repeat": 0}
    for impl in ("cascade", "wave"):
        r = BatchedRunner(TopologySpec([(v, 200) for v in names], edges),
                          SimConfig(**cfg), HashDelay(SEED), BATCH,
                          scheduler="exact", exact_impl=impl, device="cpu")
        if impl == "wave":
            tk = r.kernel
            seg_excl = tk._seg_excl

            def spy(x, seg_excl=seg_excl):
                # each pending marker's count of earlier same-destination
                # markers: of any sid ([B, E], the wave number) and of its
                # own sid ([B, S, E])
                out = seg_excl(x)
                key = "depth" if x.dim() == 2 else "repeat"
                seen[key] = max(seen[key], int((out * x).max()))
                return out

            tk._seg_excl = spy
        prog = workloads.storm_program(r.topo, 5, 2, [(0, k)
                                                      for k in range(n)])
        runs[impl] = _port_storm(r, prog)
    jr = JaxRunner(TopologySpec([(v, 200) for v in names], edges),
                   JaxSimConfig(**cfg), HashJaxDelay(SEED), BATCH,
                   scheduler="exact", exact_impl="wave")
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    _assert_states_equal(ref, runs["wave"][0])
    _assert_states_equal(runs["cascade"][0], runs["wave"][0])
    assert int(np.max(ref.error)) == 0 and bool(np.all(ref.started))
    assert seen["depth"] >= 2 and seen["repeat"] >= 1, seen
    assert runs["wave"][1] < runs["cascade"][1]


def _two_nodes(events, cap):
    """(port wave, port cascade, JAX wave) ``DenseSim`` runs of a two-node
    script under a fixed delay of 2 at ring capacity ``cap``: each the
    (snapshots, host state) pair, or the error it raised."""
    topo = TopologySpec([("N1", 10), ("N2", 10)],
                        [("N1", "N2"), ("N2", "N1")])
    out = []
    for impl in ("wave", "cascade"):
        sim = DenseSim(topo, FixedDelay(2), SimConfig(
            queue_capacity=cap, max_recorded=16), device="cpu",
            exact_impl=impl)
        try:
            out.append((sim.run_events(events), sim.host_state()))
        except DenseBackendError as exc:
            out.append((exc, sim.host_state()))
    from chandy_lamport_tpu.core.spec import PassTokenEvent as JPass
    from chandy_lamport_tpu.core.spec import SnapshotEvent as JSnap
    from chandy_lamport_tpu.core.spec import TickEvent as JTick
    from chandy_lamport_tpu.utils.fixtures import TopologySpec as JTopo

    jev = [JPass(e.src, e.dest, e.tokens) if isinstance(e, PassTokenEvent)
           else JSnap(e.node_id) if isinstance(e, SnapshotEvent)
           else JTick(e.n) for e in events]
    try:
        snaps, sim = jax_run_events(
            "jax", JTopo([("N1", 10), ("N2", 10)],
                         [("N1", "N2"), ("N2", "N1")]), jev,
            HostFixedDelay(2), JaxSimConfig(queue_capacity=cap,
                                            max_recorded=16),
            exact_impl="wave")
        out.append((snaps, sim._host()))
    except RuntimeError as exc:
        out.append((exc, None))
    return out


def _plain(snaps):
    """Snapshots as plain tuples: the port's and the JAX package's
    ``GlobalSnapshot`` are different classes."""
    return [(g.id, g.token_map, [(m.src, m.dest, m.message.is_marker,
                                  m.message.data) for m in g.messages])
            for g in snaps]


@pytest.mark.parametrize("case", ["full_ring_broadcast", "capacity_edge"])
def test_wave_ring_capacity_matches_jax_and_cascade(case):
    """The JAX wave tests' two ring regimes (tests/test_wave.py:153,
    :176), through ``DenseSim``: a snapshot's re-broadcast onto a ring
    still full of tokens not yet due (ERR_QUEUE_OVERFLOW in both forms,
    and clean with one more slot), and C tokens popped ahead of a
    snapshot at exactly capacity C (clean). Every leaf equal."""
    C = 4
    if case == "full_ring_broadcast":
        events = ([SnapshotEvent("N1"), TickEvent(1)]
                  + [PassTokenEvent("N2", "N1", 1)] * C + [TickEvent(2)])
        caps = (C, C + 1)
    else:
        events = ([PassTokenEvent("N2", "N1", 1)] * C
                  + [SnapshotEvent("N1"), TickEvent(1)])
        caps = (C,)
    for cap in caps:
        (wres, wst), (cres, cst), (jres, jst) = _two_nodes(events, cap)
        _assert_states_equal(cst, wst)
        overflow = case == "full_ring_broadcast" and cap == C
        assert bool(wst.error & ERR_QUEUE_OVERFLOW) == overflow
        if overflow:
            assert isinstance(wres, DenseBackendError)
            assert isinstance(jres, RuntimeError)
            assert "queue capacity" in str(wres) and "queue capacity" in str(
                jres)
        else:
            assert wres == cres
            assert _plain(wres) == _plain(jres)
            _assert_states_equal(jst, wst)


def test_wave_full_adversary_matches_cascade():
    """The full adversary (every class, pause crashes), the supervisor
    with retries and quarantine on er-24: the port's wave equals the
    port's cascade and the JAX cascade on every leaf (fault books,
    supervisor vectors, stale markers and the sampler included)."""
    faults = tuple(sorted(EVERY.items()))
    sup = dict(snapshot_timeout=8, snapshot_retries=4)
    wave = _port_runner("er24", "hash", "wave", faults, **sup)
    prog = _program(wave)
    got, _ = _port_storm(wave, prog)
    cascade, _ = _port_storm(_port_runner("er24", "hash", "cascade", faults,
                                          **sup), prog)
    jr = _jax_runner("er24", "hash", "cascade", faults, **sup)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    _assert_states_equal(ref, got)
    _assert_states_equal(cascade, got)
    assert int(np.asarray(ref.snap_retries).sum()) > 0
    assert int(np.asarray(ref.fault_counts).sum()) > 0
    # the JAX wave, whose re-broadcasts carry the bare sid, parts from
    # the JAX cascade once a retry has raised an epoch
    jw = _jax_runner("er24", "hash", "wave", faults, **sup)
    jax_wave = jax.device_get(jw.run_storm(jw.init_batch_device(), prog))
    assert not all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y
                   in zip(jax.tree_util.tree_leaves(jax_wave),
                          jax.tree_util.tree_leaves(ref)))


def test_wave_adversary_without_retries_matches_jax_wave():
    """The adversary without marker drops, quarantine, the snapshot daemon
    and a timeout that never fires (no retry: every epoch 0, the payloads
    packed): the port's wave equals the JAX wave leaf for leaf."""
    faults = tuple(sorted((k, v) for k, v in EVERY.items()
                          if k != "marker_drop_rate"))
    sup = dict(snapshot_every=5, snapshot_timeout=1000, max_snapshots=6)
    wave = _port_runner("sf32", "hash", "wave", faults, **sup)
    prog = _program(wave)
    got, _ = _port_storm(wave, prog)
    jr = _jax_runner("sf32", "hash", "wave", faults, **sup)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    _assert_states_equal(ref, got)
    assert int(np.asarray(ref.fault_counts).sum()) > 0
    assert int(np.asarray(ref.snap_retries).sum()) == 0
    assert int(np.asarray(ref.next_sid).min()) > 3   # the daemon fired


def test_wave_megatick3_matches_megatick1():
    """The fused megatick's plain form at megatick 3 (a drain and flush
    of 3-tick megaticks, through the wave tick) equals megatick 1 and the
    JAX wave, on a faulted, supervised storm too."""
    for faults, sup in (((), {}),
                        (tuple(sorted(EVERY.items())),
                         dict(snapshot_timeout=8))):
        one = _port_runner("sf32", "hash", "wave", faults, **sup)
        prog = _program(one)
        three = _port_runner("sf32", "hash", "wave", faults, megatick=3,
                             **sup)
        assert three.fused == "off"              # the CPU: the plain form
        _assert_states_equal(_port_storm(one, prog)[0],
                             _port_storm(three, prog)[0])
    jr = _jax_runner("sf32", "hash", "wave")
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    three = _port_runner("sf32", "hash", "wave", megatick=3)
    _assert_states_equal(ref, _port_storm(three, prog)[0])


def test_wave_counter_wrap_inside_a_tick():
    """The drain of a storm whose hash counters stand 2 draws below 2^32:
    the first tick with three draws or more straddles the wrap, and the
    positions past it take the next epoch, as the sequential draws of the
    cascade and the JAX wave's block draws do."""
    wave = _port_runner("sf32", "hash", "wave")
    prog = _program(wave)
    mid = wave.run_storm(wave.init_batch_device(), prog, drain=False)
    key, _, epoch = mid.delay_state
    mid = mid._replace(delay_state=(key, key * 0 + 2**32 - 2, epoch))
    host = state_to_numpy(mid)
    got, _ = _port_storm(wave, prog, state=state_from_numpy(host, "cpu"))
    cascade, _ = _port_storm(_port_runner("sf32", "hash", "cascade"), prog,
                             state=state_from_numpy(host, "cpu"))
    jr = _jax_runner("sf32", "hash", "wave")
    ref = jax.device_get(jr.drain(jax.device_put(JaxDenseState(*host))))
    _assert_states_equal(ref, got)
    _assert_states_equal(cascade, got)
    assert bool((np.asarray(got.delay_state[2]) == 1).all())   # wrapped once
    assert int(np.max(got.error)) == 0


def test_wave_refuses_order_dependent_sampler():
    """The Go-exact stream draws by order, not position: the wave refuses
    it at construction (ValueError), in the batched runner and in
    ``DenseSim``; the fold, which draws in stream order, takes it."""
    spec = workloads.ring_topology(4, tokens=10)
    with pytest.raises(ValueError, match="position-addressable"):
        BatchedRunner(spec, SimConfig(max_snapshots=2), GoExactDelay(7), 2,
                      scheduler="exact", exact_impl="wave", device="cpu")
    with pytest.raises(ValueError, match="position-addressable"):
        DenseSim(spec, GoExactDelay(7), device="cpu", exact_impl="wave")
    sim = DenseSim(spec, GoExactDelay(7), device="cpu", exact_impl="fold")
    assert sim.kernel.exact_impl == "fold"


def test_wave_bench_row(capsys):
    """The bench runs the wave (its row's scheduler "exact/wave") and
    refuses it with a sampler that is not position-addressable."""
    import json

    from chandy_lamport_tpu_torch import bench

    assert bench.main(["--device", "cpu", "--scheduler", "exact",
                       "--exact-impl", "wave", "--graph", "er", "--nodes",
                       "16", "--batch", "2", "--phases", "3", "--snapshots",
                       "2", "--repeats", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["scheduler"] == "exact/wave" and row["error_bits"] == 0
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--scheduler", "exact",
                    "--exact-impl", "wave", "--delay", "uniform"])
