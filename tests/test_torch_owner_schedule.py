"""A CPU rehearsal of the fused megatick's destination-owned marker step.

The untraced instantiations of ``fused_scan`` (``csrc/megatick.cu``,
``owner_step``) run the cascade's and the wave's step 3 as one body: a
tick-start schedule (which popped markers are first receipts, and each
first receipt's draw base by a scan of the first receipts' out-degrees in
edge order), then one thread per node serving all of that node's markers
in edge order, back to back, with no barrier between nodes; the Go-exact
stream, which draws by order, is drawn for the whole tick first, in
stream order, and read by position. ``_owner_step`` below is a numpy
model of exactly that schedule, per lane and per tick, with the nodes
served in a random order each tick (the kernel's threads keep none). It
replaces the marker step of the port's exact tick (steps 0-2 and 4 are
the port's ``_tick_open`` / ``_tick_close``), and the storms it drives
are held leaf for leaf against the JAX package's cascade (the JAX runner
at megatick 1, ``_cascade_tick``): random storms on ring-8, er-24 and
sf-32 (B=4) under the hash, fixed and Go-exact samplers, a hash counter
a few draws below 2^32, a marker pile-up on a complete digraph, a
broadcast into a full ring, and the full adversary with the supervisor
and quarantine. Tolerance: none (integer state).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.state import DenseState as JaxDenseState
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import (
    FixedJaxDelay,
    GoExactJaxDelay,
    HashJaxDelay,
)
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.dense import DenseBackendError, DenseSim
from chandy_lamport_tpu_torch.core.spec import (
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.core.state import (
    ERR_QUEUE_OVERFLOW,
    ERR_VALUE_OVERFLOW,
    RTIME_PACK_LIMIT,
)
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import (
    FixedDelay,
    GoExactDelay,
    HashDelay,
    select_words,
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
          "fixed": (FixedDelay, FixedJaxDelay, (2,)),
          "go": (GoExactDelay, GoExactJaxDelay, (SEED,))}
# the full adversary (every class, pause crashes)
EVERY = dict(drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05,
             crash_rate=0.3, crash_period=4, crash_len=1,
             marker_drop_rate=0.1, marker_dup_rate=0.1,
             marker_jitter_rate=0.05)


# ---- the model ---------------------------------------------------------------

class _Tables:
    """The topology tables the kernel reads, as numpy."""

    def __init__(self, tk):
        topo = tk.topo
        self.n, self.e = topo.n, topo.e
        self.by_dst = np.asarray(topo.by_dst)
        self.dst_lo = np.asarray(topo.dst_bounds[:-1])
        self.dst_hi = np.asarray(topo.dst_bounds[1:])
        self.src_lo = tk._src_lo.numpy()
        self.src_hi = tk._src_hi.numpy()
        self.edge_dst = np.asarray(topo.edge_dst)
        self.in_degree = np.asarray(topo.in_degree)


# the state's leaves the marker step reads or writes
_LEAVES = ("tokens", "has_local", "frozen", "rem", "done_local", "recording",
           "rec_start", "rec_end", "min_prot", "rec_cnt", "completed",
           "q_meta", "q_data", "q_head", "q_len", "tok_pushed", "error",
           "snap_epoch")


def _draws(tk, s, total):
    """Every lane's ``total`` draws of the tick at stream positions 0, 1,
    ...: the hash and fixed streams by position, then advanced past them;
    the Go-exact stream drawn one at a time, in stream order, up front.
    Returns (receive times [B, max(total)], the sampler state after)."""
    b, most = len(total), max(int(total.max()), 1)
    dstate = s.delay_state
    count = torch.from_numpy(total.astype(np.int32))
    if tk.delay.position_streams:
        off = torch.arange(most, dtype=torch.int32).expand(b, most)
        rts = tk.delay.block_receive_times(dstate, s.time, off)
        return rts.numpy(), tk.delay.advance_draws(dstate, count)
    rts = torch.zeros((b, most), dtype=torch.int32)
    for i in range(most):
        rt, drawn = tk.delay.draw(dstate, s.time)
        dstate = select_words(count > i, drawn, dstate)
        rts[:, i] = rt
    return rts.numpy(), dstate


def _owner_step(tk, tab, s, tok, mk, head_data, rng):
    """Step 3 of the kernel's untraced body on every lane (module
    docstring); returns the state and the tokens left to credit, and the
    log marks ``app``."""
    S, C, b = tk.cfg.max_snapshots, tk.cfg.queue_capacity, s.time.shape[0]
    x = {name: getattr(s, name).numpy().copy() for name in _LEAVES}
    tok, mk, hd = tok.numpy().copy(), mk.numpy(), head_data.numpy()
    app = np.zeros_like(tok)
    sup = tk._sup
    sid = np.where(sup, np.mod(hd, S), np.clip(hd, 0, S - 1))
    outdeg = tab.src_hi - tab.src_lo
    # the tick-start schedule: first receipts, then their draw bases
    first = np.zeros_like(mk)
    base = np.zeros(mk.shape, np.int64)
    total = np.zeros(b, np.int64)
    for lane in range(b):
        seen = set()
        for v in range(tab.n):
            for f in tab.by_dst[tab.dst_lo[v]:tab.dst_hi[v]]:
                if mk[lane, f]:
                    cell = (sid[lane, f], v)
                    first[lane, f] = (not x["has_local"][lane][cell]
                                      and cell not in seen)
                    seen.add(cell)
        marks = mk[lane] & first[lane]
        draws = np.where(marks, outdeg[tab.edge_dst], 0)
        base[lane] = np.cumsum(draws) - draws
        total[lane] = draws.sum()
    rts, dstate = _draws(tk, s, total)
    # the owners: every node's markers in edge order, nodes in any order
    for lane in range(b):
        for d in rng.permutation(tab.n):
            ins = tab.by_dst[tab.dst_lo[d]:tab.dst_hi[d]]
            cursor = 0                    # in-edges [0, cursor) credited
            for j, f in enumerate(ins):
                if not mk[lane, f]:
                    continue
                for g in ins[cursor:j]:
                    if tok[lane, g]:
                        x["tokens"][lane, d] += hd[lane, g]
                        app[lane, g] = x["recording"][lane, :, g].any()
                        tok[lane, g] = False
                cursor = j
                _handle(tk, tab, x, lane, f, d, sid[lane, f],
                        first[lane, f], base[lane, f], rts[lane], app[lane],
                        S, C, sup)
    s = s._replace(delay_state=dstate,
                   **{name: torch.from_numpy(x[name]) for name in _LEAVES})
    return s, torch.from_numpy(tok), torch.from_numpy(app)


def _handle(tk, tab, x, lane, f, d, sid, first, base, rts, app, S, C, sup):
    """HandleMarker for the marker on edge ``f`` into ``d`` (the kernel's
    ``handle_marker``), then the finalization check; returns whether the
    cell fired."""
    cell = (lane, sid, d)
    if first:
        for g in tab.by_dst[tab.dst_lo[d]:tab.dst_hi[d]]:
            if g == f:
                continue
            cnt = x["rec_cnt"][lane, g] + int(app[g])
            x["recording"][lane, sid, g] = True
            x["rec_start"][lane, sid, g] = cnt
            x["min_prot"][lane, g] = min(x["min_prot"][lane, g], cnt)
        x["has_local"][cell] = True
        x["frozen"][cell] = x["tokens"][lane, d]
        x["rem"][cell] = tab.in_degree[d] - 1
        epoch = int(x["snap_epoch"][lane, sid]) if sup else 0
        data = _wrap32(epoch * S + int(sid))
        for k, g in enumerate(range(tab.src_lo[d], tab.src_hi[d])):
            _append(tk, x, lane, g, int(rts[base + k]), data, C)
    elif x["recording"][lane, sid, f]:
        x["recording"][lane, sid, f] = False
        x["rem"][cell] -= 1
        x["rec_end"][lane, sid, f] = x["rec_cnt"][lane, f]
    fire = bool(x["has_local"][cell] and x["rem"][cell] == 0
                and not x["done_local"][cell])
    if fire:
        x["done_local"][cell] = True
        x["completed"][lane, sid] += 1
    return fire


def _wrap32(v):
    """``v`` as int32 arithmetic wraps it."""
    return np.int32((int(v) + 2**31) % 2**32 - 2**31)


def _append(tk, x, lane, g, rt, data, C):
    """One marker at the tail of ring ``g`` (``append``)."""
    length = int(x["q_len"][lane, g])
    bits = ERR_QUEUE_OVERFLOW if length >= C else 0
    if x["tok_pushed"][lane, g] >= tk._key_limit or rt >= RTIME_PACK_LIMIT:
        bits |= ERR_VALUE_OVERFLOW
    x["error"][lane] |= bits
    slot = (int(x["q_head"][lane, g]) + length) % C
    x["q_meta"][lane, g, slot] = _wrap32(2 * rt + 1)
    x["q_data"][lane, g, slot] = data
    x["q_len"][lane, g] += 1
    x["tok_pushed"][lane, g] += 1


def _owner_tick(tk, tab, rng):
    """The port's exact tick with its marker step replaced by the
    model's."""
    def tick(s, active=None):
        s, tok, mk, head_data, _, dups = tk._tick_open(s, active)
        amt_e = torch.where(tok, head_data, 0)
        s, tok, app = _owner_step(tk, tab, s, tok, mk, head_data, rng)
        return tk._tick_close(s, tok, app, amt_e, head_data, dups, active)

    return tick


def _modelled(runner, seed=0):
    """``runner`` with its exact tick's marker step run by the model."""
    tk = runner.kernel
    tk._exact_tick = _owner_tick(tk, _Tables(tk), np.random.default_rng(seed))
    return runner


# ---- the oracles -------------------------------------------------------------

def _assert_states_equal(ref, got):
    for name in ref._fields:
        xs = jax.tree_util.tree_leaves(getattr(ref, name))
        ys = jax.tree_util.tree_leaves(getattr(got, name))
        assert len(xs) == len(ys), name
        for a, c in zip(xs, ys):
            a, c = np.asarray(a), np.asarray(c)
            assert a.dtype == c.dtype, (name, a.dtype, c.dtype)
            np.testing.assert_array_equal(a, c, err_msg=name)


def _spec(graph, ours=True):
    family, args, kw = GRAPHS[graph]
    return getattr(workloads if ours else jax_workloads, family)(*args, **kw)


@functools.lru_cache(maxsize=None)
def _jax_runner(graph, delay, faults=(), **cfg):
    _, jax_delay, args = DELAYS[delay]
    return JaxRunner(_spec(graph, ours=False), JaxSimConfig(**{**CFG, **cfg}),
                     jax_delay(*args), BATCH, scheduler="exact",
                     exact_impl="cascade", kernel_engine="xla",
                     faults=JaxFaults(3, **dict(faults)) if faults else None,
                     quarantine=bool(faults))


def _port_runner(graph, delay, faults=(), **cfg):
    ours, _, args = DELAYS[delay]
    return _modelled(BatchedRunner(
        _spec(graph), SimConfig(**{**CFG, **cfg}), ours(*args), BATCH,
        scheduler="exact", device="cpu",
        faults=Faults(3, **dict(faults)) if faults else None,
        quarantine=bool(faults)))


def _program(runner):
    return workloads.storm_program(runner.topo, PHASES, 2,
                                   workloads.staggered_snapshots(
                                       runner.topo, 3))


# ---- the cases ---------------------------------------------------------------

def _jax_events(events):
    """The port's events as the JAX package's event classes."""
    from chandy_lamport_tpu.core.spec import PassTokenEvent as JPass
    from chandy_lamport_tpu.core.spec import SnapshotEvent as JSnap
    from chandy_lamport_tpu.core.spec import TickEvent as JTick

    return [JPass(e.src, e.dest, e.tokens) if isinstance(e, PassTokenEvent)
            else JSnap(e.node_id) if isinstance(e, SnapshotEvent)
            else JTick(e.n) for e in events]


def _go_script(spec, rng, phases=PHASES):
    """A random storm as an event script: each phase one token on four
    random links, a snapshot at a random node in three of the phases, and
    one or two ticks."""
    links, names = list(spec.links), [v for v, _ in spec.nodes]
    snaps = set(rng.choice(phases, 3, replace=False).tolist())
    events = []
    for ph in range(phases):
        for k in rng.choice(len(links), 4, replace=False):
            events.append(PassTokenEvent(*links[k], 1))
        if ph in snaps:
            events.append(SnapshotEvent(names[rng.integers(len(names))]))
        events.append(TickEvent(int(rng.integers(1, 3))))
    return events


def _go_sims(spec, jspec, events, cfg, seed=0):
    """The model's ``DenseSim`` run and the JAX cascade's under the
    Go-exact stream: (port snapshots, port host state, JAX snapshots, JAX
    host state)."""
    from chandy_lamport_tpu.api import make_backend
    from chandy_lamport_tpu.models.delay import GoExactDelay as HostGoExact

    sim = DenseSim(spec, GoExactDelay(SEED), SimConfig(**cfg), device="cpu")
    tk = sim.kernel
    tk._exact_tick = _owner_tick(tk, _Tables(tk),
                                 np.random.default_rng(seed))
    snaps = sim.run_events(events)
    jsim = make_backend("jax", jspec, HostGoExact(SEED), JaxSimConfig(**cfg),
                        exact_impl="cascade")
    jsnaps = jsim.run_events(_jax_events(events))
    return snaps, sim.host_state(), jsnaps, jsim._host()


def _plain(snaps):
    """Snapshots as plain tuples (the two packages' classes differ)."""
    return [(g.id, g.token_map, [(m.src, m.dest, m.message.is_marker,
                                  m.message.data) for m in g.messages])
            for g in snaps]


@pytest.mark.parametrize("delay", sorted(DELAYS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_owner_schedule_storm_matches_jax_cascade(graph, delay):
    """A full exact storm with drain and flush through the model: every
    leaf equal to the JAX cascade's, the sampler's stream included. The
    hash and fixed samplers run the batched storm (B=4); the Go-exact
    stream, which has no block draws for the bulk sends, runs a random
    event script of the same shape through ``DenseSim``, its snapshots
    equal too."""
    if delay == "go":
        events = _go_script(_spec(graph), np.random.default_rng(5))
        snaps, got, jsnaps, ref = _go_sims(_spec(graph),
                                           _spec(graph, ours=False), events,
                                           CFG)
        _assert_states_equal(ref, got)
        assert _plain(snaps) == _plain(jsnaps) and len(snaps) == 3
        return
    runner = _port_runner(graph, delay)
    prog = _program(runner)
    got = state_to_numpy(runner.run_storm(runner.init_batch_device(), prog))
    jr = _jax_runner(graph, delay)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    _assert_states_equal(ref, got)
    assert int(np.max(ref.error)) == 0
    assert int(np.asarray(ref.completed).sum()) > 0


def test_owner_schedule_counter_wrap_inside_a_tick():
    """The drain of a storm whose hash counters stand 2 draws below 2^32:
    a tick's draw positions straddle the wrap and those past it take the
    next epoch, as the cascade's sequential draws do."""
    jr = _jax_runner("sf32", "hash")
    runner = _port_runner("sf32", "hash")
    prog = _program(runner)
    mid = jax.device_get(jr.run_storm(jr.init_batch_device(), prog,
                                      drain=False))
    key, _, epoch = mid.delay_state
    mid = mid._replace(delay_state=(key, np.full_like(key, 2**32 - 2),
                                    epoch))
    ref = jax.device_get(jr.drain(jax.device_put(JaxDenseState(*mid))))
    got = state_to_numpy(runner.drain(state_from_numpy(mid, "cpu")))
    _assert_states_equal(ref, got)
    assert bool((np.asarray(got.delay_state[2]) == 1).all())   # wrapped


@pytest.mark.parametrize("delay", ["hash", "go"])
def test_owner_schedule_marker_pileup(delay):
    """Every node of a complete 8-node digraph initiates at once: ticks
    deliver markers of several sids to one destination and two of one
    sid to one destination (a same-tick repeat), each served back to back
    by the node's owner (hash: the batched storm; Go-exact: the same
    initiations as a ``DenseSim`` script)."""
    from chandy_lamport_tpu.utils.fixtures import TopologySpec as JTopo

    n = 8
    names = [f"N{i}" for i in range(n)]
    edges = sorted((a, b) for a in names for b in names if a != b)
    spec = TopologySpec([(v, 200) for v in names], edges)
    cfg = dict(max_snapshots=8, queue_capacity=32, max_recorded=96)
    if delay == "go":
        events = ([PassTokenEvent(a, b, 2) for a, b in edges[::3]]
                  + [SnapshotEvent(v) for v in names] + [TickEvent(3)])
        snaps, got, jsnaps, ref = _go_sims(
            spec, JTopo([(v, 200) for v in names], edges), events, cfg)
        _assert_states_equal(ref, got)
        assert _plain(snaps) == _plain(jsnaps) and len(snaps) == n
        return
    runner = _modelled(BatchedRunner(spec, SimConfig(**cfg), HashDelay(SEED),
                                     BATCH, scheduler="exact",
                                     device="cpu"))
    prog = workloads.storm_program(runner.topo, 5, 2,
                                   [(0, k) for k in range(n)])
    got = state_to_numpy(runner.run_storm(runner.init_batch_device(), prog))
    jr = JaxRunner(spec, JaxSimConfig(**cfg), HashJaxDelay(SEED), BATCH,
                   scheduler="exact", exact_impl="cascade",
                   kernel_engine="xla")
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    _assert_states_equal(ref, got)
    assert int(np.max(ref.error)) == 0 and bool(np.all(ref.started))


def test_owner_schedule_broadcast_into_a_full_ring():
    """A snapshot's re-broadcast onto a ring still full of tokens not yet
    due (the JAX wave tests' regime, tests/test_wave.py:153) through
    ``DenseSim`` at capacity C: ERR_QUEUE_OVERFLOW, and every leaf equal
    to the JAX cascade's; clean at C + 1."""
    from chandy_lamport_tpu.api import make_backend
    from chandy_lamport_tpu.core.spec import PassTokenEvent as JPass
    from chandy_lamport_tpu.core.spec import SnapshotEvent as JSnap
    from chandy_lamport_tpu.core.spec import TickEvent as JTick
    from chandy_lamport_tpu.models.delay import FixedDelay as HostFixed
    from chandy_lamport_tpu.utils.fixtures import TopologySpec as JTopo

    C = 4
    events = ([SnapshotEvent("N1"), TickEvent(1)]
              + [PassTokenEvent("N2", "N1", 1)] * C + [TickEvent(2)])
    jev = [JPass(e.src, e.dest, e.tokens) if isinstance(e, PassTokenEvent)
           else JSnap(e.node_id) if isinstance(e, SnapshotEvent)
           else JTick(e.n) for e in events]
    nodes, links = [("N1", 10), ("N2", 10)], [("N1", "N2"), ("N2", "N1")]
    for cap in (C, C + 1):
        sim = DenseSim(TopologySpec(nodes, links), FixedDelay(2),
                       SimConfig(queue_capacity=cap, max_recorded=16),
                       device="cpu", megatick=1)
        tk = sim.kernel
        tk._exact_tick = _owner_tick(tk, _Tables(tk),
                                     np.random.default_rng(cap))
        try:
            sim.run_events(events)
        except DenseBackendError:
            assert cap == C
        jsim = make_backend("jax", JTopo(nodes, links), HostFixed(2),
                            JaxSimConfig(queue_capacity=cap,
                                         max_recorded=16),
                            exact_impl="cascade")
        try:
            jsim.run_events(jev)
        except RuntimeError:
            assert cap == C
        got = sim.host_state()
        assert bool(got.error & ERR_QUEUE_OVERFLOW) == (cap == C)
        _assert_states_equal(jsim._host(), got)


def test_owner_schedule_full_adversary():
    """The full adversary (every class, pause crashes), the supervisor
    with retries and quarantine on er-24: the model equals the JAX
    cascade on every leaf (fault books, supervisor vectors, stale markers
    and the sampler included)."""
    faults = tuple(sorted(EVERY.items()))
    sup = dict(snapshot_timeout=8, snapshot_retries=4)
    runner = _port_runner("er24", "hash", faults, **sup)
    prog = _program(runner)
    got = state_to_numpy(runner.run_storm(runner.init_batch_device(), prog))
    jr = _jax_runner("er24", "hash", faults, **sup)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    _assert_states_equal(ref, got)
    assert int(np.asarray(ref.snap_retries).sum()) > 0
    assert int(np.asarray(ref.fault_counts).sum()) > 0
