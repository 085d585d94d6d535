"""A CPU rehearsal of the fused megatick's traced step 3: the owner step,
then one ranked append of the tick's marker and receipt events.

The traced instantiations of ``fused_scan`` (``csrc/megatick.cu``) run
the untraced instantiations' destination-owned marker step
(``owner_step``: the tick-start schedule, then one thread per node serving
its markers in edge order, nodes in no order), which leaves each popped
marker's block (first receipt, cell fired) and each credited token behind;
after step 4's credits, ``record_step`` writes the tick's receipts,
marker-recvs, marker-sends and endSnapshots by one ranked append in the
body's key order: the cascade's (source, block before receipts, edge),
which with one pop a source is the popped edges in edge order, each
marker as its block; the wave's (wave, class, index), a token's wave the
markers of its node below it. ``_traced_step`` below is a numpy model of
exactly that, per lane and per tick: the owner step with the nodes served
in a random order, the per-marker records, the key groups and items of
each body's classes, their ranks by the kernel's [group][warp] count
table over windows of groups, a warp's chunk of each class (checked
against a stable sort by key), and the write of only the last K of the
tick's events. It replaces the marker step
of the port's traced exact tick (steps 0-2 and 4 are the port's
``_tick_open`` / ``_tick_close``, whose own receipts record is the
model's), and the storms it drives are held leaf for leaf, the ring
included: the cascade to the JAX package's traced runner at megatick 1
(``_cascade_tick``), the wave to the port's plain traced wave
(``_wave_tick``). Cases: random storms on ring-8, er-24 and sf-32 (B=4)
under the hash, fixed and Go-exact samplers (the wave refuses Go-exact), a
ring of 8 slots that one tick overflows, a count a few events below the
int32 wrap, a marker pile-up on a complete digraph, the full adversary
with the supervisor and quarantine, and lanes with ``tr_on == 0`` beside
traced ones. Tolerance: none (integer state).
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
from chandy_lamport_tpu.utils.tracing import JaxTrace
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.dense import DenseSim
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
from chandy_lamport_tpu_torch.utils.tracing import (
    EV_MRECV,
    EV_MSEND,
    EV_RECV,
    EV_SNAP_END,
    Trace,
)
# the owner step's model, shared with its untraced rehearsal
from test_torch_owner_schedule import _LEAVES as _OWNER_LEAVES
from test_torch_owner_schedule import (
    _assert_states_equal,
    _draws,
    _go_script,
    _handle,
    _jax_events,
    _Tables,
    _wrap32,
)

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
# the full adversary (every class, pause crashes) and the supervisor
EVERY = dict(drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05,
             crash_rate=0.3, crash_period=4, crash_len=1,
             marker_drop_rate=0.1, marker_dup_rate=0.1,
             marker_jitter_rate=0.05)
SUP = dict(snapshot_timeout=8, snapshot_retries=4)
# the ring's slots in the storms: it wraps across ticks
CAPACITY = 64
# the kernel's block: 8 warps of 32; the count table's floor
WARPS, RANK_MIN = 8, 8 * 32


# ---- the model ---------------------------------------------------------------

# the state's leaves the traced marker step reads or writes: the owner
# step's and the ring's
_LEAVES = _OWNER_LEAVES + ("tr_meta", "tr_data", "tr_tick", "tr_count",
                           "tr_on")


def _items(tab, recv, mk, first, fired, wnum, sid, hd, S, wave):
    """The ranked append's items on one lane: (key group, item, events)
    for every item that holds events, each event (actor, kind, payload) in
    its block's order (``rank_item`` / ``rank_emit``); the wave's item x
    is item x % E of class x // E."""
    E, per = tab.e, 3 + S

    def sends(f):
        d = tab.edge_dst[f]
        return [(g, EV_MSEND, sid[f])
                for g in range(tab.src_lo[d], tab.src_hi[d])]

    def end(f):
        return (tab.edge_dst[f], EV_SNAP_END, sid[f])

    items = []
    if not wave:
        for f in range(E):
            if recv[f]:
                items.append((0, f, [(f, EV_RECV, hd[f])]))
            elif mk[f]:
                items.append((0, f, [(f, EV_MRECV, sid[f])]
                              + (sends(f) if first[f] else [])
                              + ([end(f)] if fired[f] else [])))
        return items
    for g in range(E):
        if recv[g]:
            items.append((per * wnum[g], g, [(g, EV_RECV, hd[g])]))
    for f in range(E):
        if mk[f]:
            items.append((per * wnum[f] + 1, E + f, [(f, EV_MRECV, sid[f])]))
    for j, f in enumerate(tab.by_dst):
        if mk[f] and first[f] and sends(f):
            items.append((per * wnum[f] + 2, 2 * E + j, sends(f)))
    for j, f in enumerate(tab.by_dst):
        if mk[f] and fired[f]:
            items.append((per * wnum[f] + 3 + sid[f], 3 * E + j, [end(f)]))
    return items


def _table_ranks(items, groups, e):
    """Each item's first rank as the kernel computes it: windows of
    ``cap`` key groups; per window each warp's events per group of its
    contiguous chunk of each class's E items (item x is class x // E's
    item x % E) into the [group][warp] table, an exclusive scan of the
    table in (group, warp) order, and the warp's running count within its
    chunk."""
    chunk = -(-e // (WARPS * 32)) * 32
    cap = max(e, RANK_MIN) // WARPS
    ranks, done = {}, 0
    for g0 in range(0, groups, cap):
        gw = min(groups - g0, cap)
        table = np.zeros((gw, WARPS), np.int64)
        inside = [(g, x, len(ev)) for g, x, ev in items if g0 <= g < g0 + gw]
        for g, x, size in inside:
            table[g - g0, x % e // chunk] += size
        flat = table.reshape(-1)
        offsets = (done + np.cumsum(flat) - flat).reshape(gw, WARPS)
        for g, x, size in sorted(inside, key=lambda it: it[1]):
            ranks[x] = int(offsets[g - g0, x % e // chunk])
            offsets[g - g0, x % e // chunk] += size
        done += int(flat.sum())
    return ranks


def _record(x, lane, items, groups, e, time, k):
    """The ranked append on one lane: each item's events at its rank in
    (group, item) order, only the last K of the tick's written."""
    ranks, pos = {}, 0
    for g, xi, ev in sorted(items, key=lambda it: (it[0], it[1])):
        ranks[xi] = pos
        pos += len(ev)
    assert _table_ranks(items, groups, e) == ranks
    total, c = pos, int(x["tr_count"][lane])
    for _, xi, ev in items:
        for r, (actor, kind, payload) in enumerate(ev, start=ranks[xi]):
            if r >= total - k:
                slot = int(_wrap32(c + r)) % k
                x["tr_meta"][lane, slot] = _wrap32(actor * 32 + kind)
                x["tr_data"][lane, slot] = payload
                x["tr_tick"][lane, slot] = time
    x["tr_count"][lane] = _wrap32(c + total)
    return total


def _traced_step(tk, tab, s, tok, mk, head_data, rng, wave, seen):
    """Step 3 of the kernel's traced body and its ranked append on every
    lane (module docstring); returns the state, the tokens left to credit
    in step 4 (their receipts already recorded) and the log marks
    ``app``. ``seen`` collects each lane's events of the tick."""
    S, C, b = tk.cfg.max_snapshots, tk.cfg.queue_capacity, s.time.shape[0]
    x = {name: getattr(s, name).numpy().copy() for name in _LEAVES}
    tok, mk, hd = tok.numpy().copy(), mk.numpy(), head_data.numpy()
    recv = tok.copy()                     # every receipt of the tick
    app = np.zeros_like(tok)
    sup = tk._sup
    sid = np.where(sup, np.mod(hd, S), np.clip(hd, 0, S - 1))
    outdeg = tab.src_hi - tab.src_lo
    # the tick-start schedule: first receipts, their draw bases, and each
    # in-edge's wave (its node's markers below it)
    first = np.zeros_like(mk)
    wnum = np.zeros(mk.shape, np.int64)
    base = np.zeros(mk.shape, np.int64)
    total = np.zeros(b, np.int64)
    depth = np.zeros(b, np.int64)
    for lane in range(b):
        cells = set()
        for v in range(tab.n):
            rank = 0
            for f in tab.by_dst[tab.dst_lo[v]:tab.dst_hi[v]]:
                wnum[lane, f] = rank
                if mk[lane, f]:
                    cell = (sid[lane, f], v)
                    first[lane, f] = (not x["has_local"][lane][cell]
                                      and cell not in cells)
                    cells.add(cell)
                    rank += 1
            depth[lane] = max(depth[lane], rank)
        draws = np.where(mk[lane] & first[lane], outdeg[tab.edge_dst], 0)
        base[lane] = np.cumsum(draws) - draws
        total[lane] = draws.sum()
    rts, dstate = _draws(tk, s, total)
    # the owners: every node's markers in edge order, nodes in any order
    fired = np.zeros_like(mk)
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
                fired[lane, f] = _handle(
                    tk, tab, x, lane, f, d, sid[lane, f], first[lane, f],
                    base[lane, f], rts[lane], app[lane], S, C, sup)
    # the ranked append of the tick's events, after step 4's credits
    k = x["tr_meta"].shape[-1]
    for lane in range(b):
        if x["tr_on"][lane] <= 0:
            continue
        items = _items(tab, recv[lane], mk[lane], first[lane], fired[lane],
                       wnum[lane], sid[lane], hd[lane], S, wave)
        groups = (3 + S) * (int(depth[lane]) + 1) if wave else 1
        seen.append(_record(x, lane, items, groups, tab.e,
                            int(s.time[lane]), k))
    s = s._replace(delay_state=dstate,
                   **{name: torch.from_numpy(x[name]) for name in _LEAVES})
    return s, torch.from_numpy(tok), torch.from_numpy(app)


def _traced_tick(tk, tab, rng, seen):
    """The port's traced exact tick with its marker step and its receipts'
    record replaced by the model's."""
    wave = tk.exact_impl == "wave"

    def tick(s, active=None):
        s, tok, mk, head_data, _, dups = tk._tick_open(s, active)
        amt_e = torch.where(tok, head_data, 0)
        s, tok, app = _traced_step(tk, tab, s, tok, mk, head_data, rng, wave,
                                   seen)
        tk._trace_on = False              # the receipts are recorded
        try:
            return tk._tick_close(s, tok, app, amt_e, head_data, dups,
                                  active)
        finally:
            tk._trace_on = True

    return tick


def _modelled(runner, seed=0):
    """``runner`` with its traced exact tick's step 3 run by the model;
    ``runner.seen`` lists each traced lane's events of every tick."""
    tk = runner.kernel
    assert tk._trace_on
    runner.seen = []
    tk._exact_tick = _traced_tick(tk, _Tables(tk),
                                  np.random.default_rng(seed), runner.seen)
    return runner


# ---- the oracles -------------------------------------------------------------

def _spec(graph, ours=True):
    family, args, kw = GRAPHS[graph]
    return getattr(workloads if ours else jax_workloads, family)(*args, **kw)


@functools.lru_cache(maxsize=None)
def _jax_runner(graph, delay, faults=(), capacity=CAPACITY, **cfg):
    _, jax_delay, args = DELAYS[delay]
    return JaxRunner(_spec(graph, ours=False), JaxSimConfig(**{**CFG, **cfg}),
                     jax_delay(*args), BATCH, scheduler="exact",
                     exact_impl="cascade", kernel_engine="xla",
                     faults=JaxFaults(3, **dict(faults)) if faults else None,
                     quarantine=bool(faults), trace=JaxTrace(capacity))


def _port_runner(graph, delay, body, faults=(), capacity=CAPACITY,
                 spec=None, **cfg):
    ours, _, args = DELAYS[delay]
    return BatchedRunner(
        spec or _spec(graph), SimConfig(**{**CFG, **cfg}), ours(*args),
        BATCH, scheduler="exact", exact_impl=body, device="cpu",
        faults=Faults(3, **dict(faults)) if faults else None,
        quarantine=bool(faults), trace=Trace(capacity))


def _program(runner, phases=PHASES):
    return workloads.storm_program(runner.topo, phases, 2,
                                   workloads.staggered_snapshots(
                                       runner.topo, 3))


def _reference(body, graph, delay, prog, faults=(), start=None, **cfg):
    """The oracle's final state: the JAX traced cascade at megatick 1, or
    the port's plain traced wave; from ``start`` (a host state) it only
    drains."""
    if body == "cascade":
        jr = _jax_runner(graph, delay, faults, **cfg)
        if start is None:
            out = jr.run_storm(jr.init_batch_device(), prog)
        else:
            out = jr.drain(jax.device_put(JaxDenseState(*start)))
        return jax.device_get(out)
    runner = _port_runner(graph, delay, "wave", faults, **cfg)
    if start is None:
        out = runner.run_storm(runner.init_batch_device(), prog)
    else:
        out = runner.drain(state_from_numpy(start, "cpu"))
    return state_to_numpy(out)


# ---- the cases ---------------------------------------------------------------

STORMS = [(body, graph, delay) for body in ("cascade", "wave")
          for graph in sorted(GRAPHS) for delay in sorted(DELAYS)
          if not (body == "wave" and delay == "go")]


@pytest.mark.parametrize("body,graph,delay", STORMS)
def test_traced_schedule_storm(body, graph, delay):
    """A full traced exact storm with drain and flush through the model:
    every leaf, the ring and its count included, equal to the oracle's
    (the cascade: the JAX traced runner; the wave: the port's plain traced
    wave). The Go-exact stream, which has no block draws for the bulk
    sends, runs a random event script of the same shape through traced
    ``DenseSim``s (the port's with the model, the JAX one)."""
    if delay == "go":
        from chandy_lamport_tpu.api import make_backend
        from chandy_lamport_tpu.models.delay import GoExactDelay as HostGo

        events = _go_script(_spec(graph), np.random.default_rng(5))
        sim = DenseSim(_spec(graph), GoExactDelay(SEED), SimConfig(**CFG),
                       device="cpu", trace=Trace())
        tk = sim.kernel
        seen = []
        tk._exact_tick = _traced_tick(tk, _Tables(tk),
                                      np.random.default_rng(0), seen)
        sim.run_events(events)
        jsim = make_backend("jax", _spec(graph, ours=False), HostGo(SEED),
                            JaxSimConfig(**CFG), trace=True,
                            exact_impl="cascade")
        jsim.run_events(_jax_events(events))
        _assert_states_equal(jsim._host(), sim.host_state())
        assert sum(seen) > 0
        return
    runner = _modelled(_port_runner(graph, delay, body))
    prog = _program(runner)
    got = state_to_numpy(runner.run_storm(runner.init_batch_device(), prog))
    ref = _reference(body, graph, delay, prog)
    _assert_states_equal(ref, got)
    assert int(np.max(ref.error)) == 0
    assert int(np.asarray(ref.completed).sum()) > 0
    assert int(np.asarray(ref.tr_count).min()) > CAPACITY   # it wrapped


def _complete(n, tokens):
    names = [f"N{i}" for i in range(n)]
    edges = sorted((a, b) for a in names for b in names if a != b)
    return TopologySpec([(v, tokens) for v in names], edges), edges


@pytest.mark.parametrize("capacity", [4096, 8])
@pytest.mark.parametrize("body", ["cascade", "wave"])
def test_traced_schedule_pileup(body, capacity):
    """Every node of a complete 8-node digraph initiates at once: ticks
    deliver markers of several slots to one node and repeats of one slot
    (several waves a node), each node's owner serving them back to back.
    At 8 slots one tick's events pass the ring, which wraps inside the one
    append and keeps only its last 8."""
    from chandy_lamport_tpu.utils.fixtures import TopologySpec as JTopo

    spec, edges = _complete(8, 200)
    cfg = dict(max_snapshots=8, queue_capacity=32, max_recorded=96)
    runner = _modelled(BatchedRunner(
        spec, SimConfig(**cfg), HashDelay(SEED), BATCH, scheduler="exact",
        exact_impl=body, device="cpu", trace=Trace(capacity)))
    prog = workloads.storm_program(runner.topo, 5, 2,
                                   [(0, k) for k in range(8)])
    got = state_to_numpy(runner.run_storm(runner.init_batch_device(), prog))
    if body == "cascade":
        jr = JaxRunner(JTopo(list(spec.nodes), edges), JaxSimConfig(**cfg),
                       HashJaxDelay(SEED), BATCH, scheduler="exact",
                       exact_impl="cascade", kernel_engine="xla",
                       trace=JaxTrace(capacity))
        ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    else:
        plain = BatchedRunner(spec, SimConfig(**cfg), HashDelay(SEED), BATCH,
                              scheduler="exact", exact_impl="wave",
                              device="cpu", trace=Trace(capacity))
        ref = state_to_numpy(plain.run_storm(plain.init_batch_device(),
                                             prog))
    _assert_states_equal(ref, got)
    assert int(np.max(ref.error)) == 0 and bool(np.all(ref.started))
    assert max(runner.seen) > 8
    if capacity == 8:
        assert int(np.asarray(ref.tr_count).min()) > 8


@pytest.mark.parametrize("case", ["count-wrap", "tr_on-0"])
@pytest.mark.parametrize("body", ["cascade", "wave"])
def test_traced_schedule_drain_from_an_edited_state(body, case):
    """The drain of a storm after its phases, from a state edited first:
    every lane's count 3 events below the int32 wrap (its slots and count
    wrap as int32 arithmetic does), or lanes 1 and 2 with the recorder
    disarmed beside armed ones (they append nothing and keep their ring);
    every leaf equal to the oracle's drain of the same state."""
    runner = _modelled(_port_runner("sf32", "hash", body))
    prog = _program(runner)
    plain = _port_runner("sf32", "hash", body)
    mid = state_to_numpy(plain.run_storm(plain.init_batch_device(), prog,
                                         drain=False))
    if case == "count-wrap":
        mid = mid._replace(tr_count=np.full_like(mid.tr_count, 2**31 - 3))
    else:
        on = mid.tr_on.copy()
        on[1:3] = 0
        mid = mid._replace(tr_on=on)
    got = state_to_numpy(runner.drain(state_from_numpy(mid, "cpu")))
    ref = _reference(body, "sf32", "hash", prog, start=mid)
    _assert_states_equal(ref, got)
    count = np.asarray(ref.tr_count)
    if case == "count-wrap":
        assert bool((count < 0).all())                # wrapped
    else:
        np.testing.assert_array_equal(count[1:3], mid.tr_count[1:3])
        assert bool((count[[0, 3]] > mid.tr_count[[0, 3]]).all())


@pytest.mark.parametrize("body", ["cascade", "wave"])
def test_traced_schedule_full_adversary(body):
    """The full adversary (every class, pause crashes), the supervisor
    with retries and quarantine on er-24: the model equals the oracle on
    every leaf, the ring with its fault and supervisor events included."""
    faults = tuple(sorted(EVERY.items()))
    runner = _modelled(_port_runner("er24", "hash", body, faults, **SUP))
    prog = _program(runner)
    got = state_to_numpy(runner.run_storm(runner.init_batch_device(), prog))
    ref = _reference(body, "er24", "hash", prog, faults, **SUP)
    _assert_states_equal(ref, got)
    assert int(np.asarray(ref.snap_retries).sum()) > 0
    assert int(np.asarray(ref.fault_counts).sum()) > 0
