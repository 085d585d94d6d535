"""The graph-sharded runner of the port (parallel/graphshard.py,
parallel/mesh.py, utils/shardmap.py) against the JAX package's on the
virtual 8-device CPU mesh, in process, on the same seeded inputs.

(a) ``shard_topology`` and ``boundary_tables`` equal JAX's array for
array (hypothesis over small graphs at P in {1, 2, 4, 8}), the incidence
constants aside (the port never builds them). (b) ``run_storm`` at P in
{2, 4} under ``fixed_delay`` and under the per-shard threefry stream,
both comm engines, megatick 1, 3 and 4: every ``ShardedState`` leaf
equal to the JAX runner's (shape, dtype and value; no tolerance, integer
state). (c) The supervisor (timeout, retries, the daemon), quarantine,
the conservation cadence and the replicated flight recorder on one
storm, at megatick 3 (quarantine's stale gate reproduced). (d)
``run_storm_batched`` (the data x graph mode) against JAX's on a 2-D
mesh, fixed and per-(lane, shard) keys. (e) ``summarize``,
``comm_model``, ``gather_dense``, ``jit_tick``, the knob resolution, the
refusals, ``comm_bytes_model`` and the bench's ``--graphshard`` row.
"""

import collections
import contextlib
import functools
import io
import json

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst
from jax.sharding import Mesh as JaxMesh
from torch.overrides import TorchFunctionMode

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.state import DenseTopology as JaxTopology
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.ops.tick import (
    resolve_comm_engine as jax_resolve_comm_engine,
)
from chandy_lamport_tpu.parallel import graphshard as jax_gs
from chandy_lamport_tpu.utils.metrics import (
    comm_bytes_model as jax_comm_bytes_model,
)
from chandy_lamport_tpu.utils.tracing import JaxTrace
from chandy_lamport_tpu_torch.bench import main as bench_main
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.state import DenseTopology
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.tick import resolve_comm_engine
from chandy_lamport_tpu_torch.parallel.graphshard import (
    GraphShardedRunner,
    ShardedState,
    shard_topology,
    state_from_numpy,
    state_to_numpy,
)
from chandy_lamport_tpu_torch.parallel.mesh import Mesh, boundary_tables
from chandy_lamport_tpu_torch.utils import guards as guards_mod
from chandy_lamport_tpu_torch.utils.metrics import comm_bytes_model
from chandy_lamport_tpu_torch.utils.tracing import Trace

CFG = dict(queue_capacity=16, max_snapshots=8, max_recorded=16)


def _jax_mesh(*shape):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return JaxMesh(devs, ("data", "graph")[-len(shape):])


def _assert_leaves_equal(got, want, label=""):
    """Every leaf: shape, dtype and value."""
    for name, g, w in zip(want._fields, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, f"{label}{name}: {g.shape} != {w.shape}"
        assert g.dtype == w.dtype, f"{label}{name}: {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{label}{name}")


def _storm_case(nodes=16, seed=11, phases=10, snaps=3):
    spec = workloads.erdos_renyi(nodes, 2.5, seed=seed, tokens=80)
    topo = DenseTopology(spec)
    prog = workloads.storm_program(
        topo, phases=phases, amount=1,
        snapshot_phases=workloads.staggered_snapshots(topo, snaps))
    return spec, np.asarray(prog.amounts), np.asarray(prog.snap)


@functools.lru_cache(maxsize=None)
def _jax_storm(shards, engine, megatick, delay):
    spec, amounts, snap = _storm_case()
    kw = {"fixed_delay": 2} if delay == "fixed" else {"seed": 77}
    gs = jax_gs.GraphShardedRunner(spec, JaxSimConfig(**CFG),
                                   _jax_mesh(shards), comm_engine=engine,
                                   megatick=megatick, **kw)
    return jax.device_get(gs.run_storm(gs.init_state(), amounts, snap))


def _port(spec, shards, **kw):
    return GraphShardedRunner(spec, SimConfig(**kw.pop("cfg", CFG)),
                              Mesh({"graph": shards}, device="cpu"), **kw)


# ---- (a) the partition tables ---------------------------------------------

@settings(max_examples=30, deadline=None)
@given(shards=hst.sampled_from([1, 2, 4, 8]),
       per=hst.integers(1, 4), degree=hst.floats(1.0, 3.5),
       seed=hst.integers(0, 10_000))
def test_shard_topology_and_boundary_tables_match_jax(shards, per, degree,
                                                      seed):
    n = shards * per
    # erdos_renyi loops until its arcs reach n * degree: keep that feasible
    spec = workloads.erdos_renyi(n, min(degree, max(n - 1, 1)), seed=seed,
                                 tokens=5)
    topo, jtopo = DenseTopology(spec), JaxTopology(spec)
    st, em, bt = shard_topology(topo, shards)
    jst, jem, jbt = jax_gs.shard_topology(jtopo, shards, incidence=False)
    assert em == jem
    for name in ("edge_src", "edge_dst", "src_first", "dst_seg",
                 "seg_perm", "seg_lo", "seg_hi", "recv_idx", "in_degree"):
        np.testing.assert_array_equal(getattr(st, name),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    for name in jbt._fields:
        np.testing.assert_array_equal(np.asarray(getattr(bt, name)),
                                      np.asarray(getattr(jbt, name)),
                                      err_msg=name)
    again = boundary_tables(st.edge_src, st.edge_dst, shards,
                            topo.n // shards)
    assert again.halo == bt.halo and again.cut_rows == bt.cut_rows
    runner = _port(spec, shards, fixed_delay=1)
    nl = topo.n // shards
    np.testing.assert_array_equal(runner.edge_shard, topo.edge_src // nl)
    for p in range(shards):
        mine = np.flatnonzero(runner.edge_shard == p)
        np.testing.assert_array_equal(runner.edge_local[mine],
                                      np.arange(len(mine)))


# ---- (b) storms ------------------------------------------------------------

STORMS = [(2, "sparse", 1, "fixed"), (2, "dense", 3, "fixed"),
          (4, "sparse", 4, "fixed"), (4, "dense", 1, "fixed"),
          (2, "sparse", 3, "uniform"), (2, "dense", 1, "uniform"),
          (4, "sparse", 1, "uniform"), (4, "dense", 4, "uniform")]


@pytest.mark.parametrize("shards,engine,megatick,delay", STORMS)
def test_run_storm_matches_jax(shards, engine, megatick, delay):
    """Every leaf of the final ShardedState equals the JAX runner's, under
    the fixed delay and under the per-shard threefry streams."""
    want = _jax_storm(shards, engine, megatick, delay)
    assert int(want.error) == 0 and (want.completed[:3] == 16).all()
    spec, amounts, snap = _storm_case()
    kw = {"fixed_delay": 2} if delay == "fixed" else {"seed": 77}
    gs = _port(spec, shards, comm_engine=engine, megatick=megatick, **kw)
    got = state_to_numpy(gs.run_storm(gs.init_state(), amounts, snap))
    _assert_leaves_equal(got, want, f"{shards}/{engine}/{megatick}/{delay}:")


def test_engines_and_megaticks_agree_on_one_mesh():
    """Both engines at megatick 1 and 4 give one final state (the port's
    own differential, as the JAX ``test_megatick_bit_identical``)."""
    spec, amounts, snap = _storm_case(seed=5)
    finals = []
    for engine in ("sparse", "dense"):
        for megatick in (1, 4):
            gs = _port(spec, 4, fixed_delay=2, comm_engine=engine,
                       megatick=megatick)
            finals.append(state_to_numpy(gs.run_storm(gs.init_state(),
                                                      amounts, snap)))
    for other in finals[1:]:
        _assert_leaves_equal(other, finals[0])


def test_single_node_shards_match_jax():
    """P == N: every edge cut, every neighbour block one row wide."""
    spec, amounts, snap = _storm_case(nodes=8, phases=6, snaps=2)
    jgs = jax_gs.GraphShardedRunner(spec, JaxSimConfig(**CFG), _jax_mesh(8),
                                    fixed_delay=2)
    want = jax.device_get(jgs.run_storm(jgs.init_state(), amounts, snap))
    for engine in ("sparse", "dense"):
        gs = _port(spec, 8, fixed_delay=2, comm_engine=engine)
        assert gs.nl == 1
        got = state_to_numpy(gs.run_storm(gs.init_state(), amounts, snap))
        _assert_leaves_equal(got, want, f"{engine}:")


# ---- (c) supervisor, quarantine, cadence, recorder ---------------------------

def test_supervised_quarantined_traced_storm_matches_jax():
    """The supervisor's timeouts and retries (a timeout shorter than a
    snapshot's completion, so slots abort, retry and fail), its daemon,
    the conservation check every 2 phases, quarantine at megatick 3 (the
    gate reading the error word of the last fold) and the replicated
    recorder: every leaf equal to JAX's, the ring included."""
    spec, amounts, snap = _storm_case(nodes=16, seed=3, phases=12, snaps=3)
    cfg = dict(CFG, snapshot_timeout=3, snapshot_retries=1,
               snapshot_every=5, trace_capacity=64)
    for delay in ({"fixed_delay": 2}, {"seed": 9}):
        jgs = jax_gs.GraphShardedRunner(
            spec, JaxSimConfig(**cfg), _jax_mesh(4), check_every=2,
            megatick=3, quarantine=True, trace=JaxTrace(), **delay)
        want = jax.device_get(jgs.run_storm(jgs.init_state(), amounts,
                                            snap))
        gs = _port(spec, 4, cfg=cfg, check_every=2, megatick=3,
                   quarantine=True, trace=Trace(), **delay)
        got = state_to_numpy(gs.run_storm(gs.init_state(), amounts, snap))
        _assert_leaves_equal(got, want, f"{delay}:")
        assert int(want.tr_count) > 0
        assert int(np.asarray(want.snap_retries).sum()) > 0


def test_token_underflow_quarantine_matches_jax():
    """A storm that overdraws its senders: ERR_TOKEN_UNDERFLOW, the
    instance frozen by quarantine at the phase after, as in JAX."""
    spec = workloads.erdos_renyi(8, 2.5, seed=2, tokens=2)
    topo = DenseTopology(spec)
    prog = workloads.storm_program(
        topo, 6, 1, workloads.staggered_snapshots(topo, 2))
    amounts, snap = np.asarray(prog.amounts), np.asarray(prog.snap)
    jgs = jax_gs.GraphShardedRunner(spec, JaxSimConfig(**CFG), _jax_mesh(2),
                                    fixed_delay=2, quarantine=True)
    want = jax.device_get(jgs.run_storm(jgs.init_state(), amounts, snap))
    assert int(want.error) != 0
    gs = _port(spec, 2, fixed_delay=2, quarantine=True)
    got = state_to_numpy(gs.run_storm(gs.init_state(), amounts, snap))
    _assert_leaves_equal(got, want)


# ---- (d) the data x graph mode -----------------------------------------------

@pytest.mark.parametrize("delay", ["fixed", "uniform"])
def test_run_storm_batched_matches_jax(delay):
    """B = 4 lanes of a 2-shard instance on a 2 x 2 mesh: every leaf of
    the [B, P, ...] state equal to JAX's; under the fixed delay every lane
    equals the single-instance run."""
    spec, amounts, snap = _storm_case(nodes=8, phases=4, snaps=2)
    kw = {"fixed_delay": 2} if delay == "fixed" else {"seed": 5}
    jgs = jax_gs.GraphShardedRunner(spec, JaxSimConfig(max_snapshots=4),
                                    _jax_mesh(2, 2), **kw)
    want = jax.device_get(jgs.run_storm_batched(jgs.init_batch(4), amounts,
                                                snap))
    mesh = Mesh({"data": 2, "graph": 2}, device="cpu")
    gs = GraphShardedRunner(spec, SimConfig(max_snapshots=4), mesh, **kw)
    got = state_to_numpy(gs.run_storm_batched(gs.init_batch(4), amounts,
                                              snap))
    _assert_leaves_equal(got, want)
    if delay == "fixed":
        single = state_to_numpy(gs.run_storm(gs.init_state(), amounts, snap))
        for name, g, w in zip(ShardedState._fields, got, single):
            if name == "delay_key":     # per-(lane, shard) keys
                continue
            for lane in range(4):
                np.testing.assert_array_equal(g[lane], w, err_msg=name)
    with pytest.raises(ValueError):
        gs.init_batch(3)


# ---- (e) surfaces, knobs, refusals -------------------------------------------

def test_summarize_comm_model_and_gather_dense_match_jax():
    spec, amounts, snap = _storm_case()
    jgs = jax_gs.GraphShardedRunner(spec, JaxSimConfig(**CFG), _jax_mesh(4),
                                    fixed_delay=2)
    jfinal = jgs.run_storm(jgs.init_state(), amounts, snap)
    gs = _port(spec, 4, fixed_delay=2)
    final = gs.run_storm(gs.init_state(), amounts, snap)
    want, got = jgs.summarize(jfinal), gs.summarize(final)
    for key in want:
        if key not in ("queue_engine", "kernel_engine"):
            assert got[key] == want[key], key
    assert gs.comm_model() == jgs.comm_model()
    jd, pd = jgs.gather_dense(jfinal), gs.gather_dense(final)
    for name in jd._fields:
        a, b = getattr(jd, name), getattr(pd, name)
        if name == "delay_state":
            assert a == b == ()
            continue
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=name)
    # one more tick through the single-tick callable
    jt = jax.device_get(jgs.jit_tick()(jfinal, jgs.stopo_device()))
    pt = state_to_numpy(gs.jit_tick()(final, gs.stopo_device()))
    _assert_leaves_equal(pt, jt)


def test_state_carries_between_packages():
    """A JAX state mid-run becomes the port's (``state_from_numpy``),
    both continue, and they end equal; the port's state goes back
    unchanged; a batched state carries too."""
    spec, amounts, snap = _storm_case(nodes=8, phases=6, snaps=2)
    jgs = jax_gs.GraphShardedRunner(spec, JaxSimConfig(**CFG), _jax_mesh(2),
                                    seed=4)
    gs = _port(spec, 2, seed=4)
    mid = jax.device_get(jgs.run_storm(jgs.init_state(), amounts[:3],
                                       snap[:3]))
    want = jax.device_get(jgs.run_storm(mid, amounts[3:], snap[3:]))
    got = gs.run_storm(state_from_numpy(mid, "cpu"), amounts[3:], snap[3:])
    _assert_leaves_equal(state_to_numpy(got), want)
    _assert_leaves_equal(state_to_numpy(state_from_numpy(want, "cpu")),
                         want)
    batch = state_to_numpy(gs.init_batch(2))
    _assert_leaves_equal(state_to_numpy(state_from_numpy(batch, "cpu")),
                         batch)


def test_knobs_and_refusals_as_jax():
    spec = workloads.erdos_renyi(8, 2.0, seed=1, tokens=5)
    for engine in ("auto", "dense", "sparse"):
        assert resolve_comm_engine(engine) == jax_resolve_comm_engine(engine)
    with pytest.raises(ValueError):
        resolve_comm_engine("bogus")
    assert _port(spec, 2, cfg=dict(comm_engine="dense")).comm_engine == \
        "dense"
    assert _port(spec, 2, cfg=dict(comm_engine="dense"),
                 comm_engine="sparse").comm_engine == "sparse"
    gs = _port(spec, 2, fused_tick="off", fused_tile="auto",
               fused_block_edges=64)
    assert (gs.fused, gs.fused_tile) == ("off", "off")
    for kw in (dict(fused_tick="on"), dict(megatick=0),
               dict(check_every=-1), dict(fused_tick="bogus")):
        with pytest.raises(ValueError) as want:
            jax_gs.GraphShardedRunner(spec, JaxSimConfig(), _jax_mesh(2),
                                      **kw)
        with pytest.raises(ValueError) as got:
            _port(spec, 2, cfg={}, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_gs.GraphShardedRunner(spec, JaxSimConfig(), _jax_mesh(3))
    with pytest.raises(ValueError) as got:
        _port(spec, 3, cfg={})
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        GraphShardedRunner(spec, SimConfig(), Mesh({"graph": 2},
                                                   devices=["cpu", "cpu"]))
    # the flat layout's indices are int32: P * Em * C must stay below 2^31
    with pytest.raises(ValueError, match="int32"):
        _port(spec, 2, cfg=dict(queue_capacity=2**30))


@settings(max_examples=40, deadline=None)
@given(n=hst.integers(1, 10**6), s=hst.integers(1, 64),
       p=hst.integers(1, 64), h=hst.integers(0, 10**5),
       cut=hst.one_of(hst.none(), hst.integers(0, 10**6)),
       cb=hst.sampled_from([2, 4]))
def test_comm_bytes_model_matches_jax(n, s, p, h, cut, cb):
    assert comm_bytes_model(n, s, p, h, cut, cut, cb) == \
        jax_comm_bytes_model(n, s, p, h, cut, cut, cb)


def test_bench_graphshard_row():
    """``bench --graphshard 4 --device cpu``: one JSON row with the JAX
    row's fields, the stacked backend on one device, error 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench_main(["--graphshard", "4", "--device", "cpu", "--nodes",
                         "32", "--phases", "3", "--snapshots", "2",
                         "--repeats", "1", "--comm-engine", "sparse",
                         "--megatick", "2"])
    assert rc == 0
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "value_aggregate",
                "platform", "device_kind", "scheduler", "queue_engine",
                "kernel_engine", "fused_tick", "fused_tile",
                "fused_emulated", "comm_engine", "megatick",
                "comm_bytes_model", "mode", "graphshard", "graph", "nodes",
                "batch", "phases", "repeats", "queue_capacity",
                "record_dtype", "max_recorded", "per_tick_ms", "error_bits",
                "errors_decoded", "straggler_waste", "note"):
        assert key in row, key
    assert row["mode"] == "graphshard" and row["graphshard"] == 4
    assert (row["backend"], row["devices"]) == ("stacked", 1)
    assert row["value"] == row["value_aggregate"]
    assert row["comm_engine"] == "sparse" and row["error_bits"] == 0
    model = row["comm_bytes_model"]
    assert model["sparse_bytes_per_tick"] < model["dense_bytes_per_tick"]
    topo = JaxTopology(jax_workloads.scale_free(32, 2, seed=3, tokens=13))
    assert row["edges"] == topo.e


class _SyncWatch(TorchFunctionMode):
    """Tensor reads that make the host wait on the card (a D2H read or a
    mask gather) while the innermost guard region forbids syncs: what the
    card's sync debug mode "error" raises on, watched on the CPU."""

    READS = {"__bool__", "__int__", "__index__", "__float__", "item",
             "tolist", "numpy", "cpu", "nonzero"}

    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS and guards_mod.sync_mode() == 2:
            self.hits[name] += 1
        return func(*args, **(kwargs or {}))


def test_armed_storm_reads_the_host_only_at_named_sites():
    """Under ``RuntimeGuards()`` (transfers "disallow") a traced storm at
    megatick 2 reads the card only inside named sites: the drain's gate
    once a block (``graphshard-drain-gate``) and the recorder's appends;
    no kernel is built while armed."""
    spec, amounts, snap = _storm_case(nodes=8, phases=4, snaps=2)
    g = guards_mod.RuntimeGuards()
    gs = _port(spec, 2, cfg=dict(CFG, trace_capacity=16), fixed_delay=2,
               megatick=2, guards=g, trace=Trace())
    watch = _SyncWatch()
    with watch:
        final = gs.run_storm(gs.init_state(), amounts, snap)
    assert not watch.hits, watch.hits
    books = g.books()
    assert books["armed_regions"] == 1 and books["compiles"] == 0
    assert books["transfers"]["graphshard-drain-gate"] >= 1
    assert int(final.error) == 0 and int(final.tr_count) > 0


@pytest.mark.parametrize("seed", range(12))
def test_dense_topology_and_storm_program_match_jax(seed):
    """The port's vectorised ``DenseTopology`` and ``storm_program`` (the
    giant cell's set-up) equal the JAX package's: every array, the edge
    index, the in-edge lists, self-links dropped, duplicate arcs collapsed
    and the missing-node messages."""
    import random

    from chandy_lamport_tpu.utils.randgen import (
        random_strongly_connected as jax_random_graph,
    )
    from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec

    spec = jax_random_graph(random.Random(seed), 3 + seed % 9)
    extra = TopologySpec(list(spec.nodes), list(spec.links)
                         + [spec.links[0], (spec.nodes[0][0],) * 2])
    for case in (spec, extra, workloads.scale_free(64 + seed, 2, seed=seed)):
        mine, theirs = DenseTopology(case), JaxTopology(case)
        for name in ("ids", "index", "n", "tokens0", "e", "edge_src",
                     "edge_dst", "edge_index", "in_degree", "d",
                     "edge_table", "by_dst", "dst_bounds"):
            a, b = getattr(mine, name), getattr(theirs, name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name
        assert len(mine.in_edges) == len(theirs.in_edges)
        for a, b in zip(mine.in_edges, theirs.in_edges):
            np.testing.assert_array_equal(a, b)
        snaps = workloads.staggered_snapshots(mine, 3, 1, 2, max_phases=7)
        ours = workloads.storm_program(mine, 7, 2, snaps)
        want = jax_workloads.storm_program(theirs, 7, 2, snaps)
        np.testing.assert_array_equal(ours.amounts, want.amounts)
        np.testing.assert_array_equal(ours.snap, want.snap)
    bad = TopologySpec([("A", 1)], [("A", "Z")])
    with pytest.raises(ValueError) as want:
        JaxTopology(bad)
    with pytest.raises(ValueError) as got:
        DenseTopology(bad)
    assert str(got.value) == str(want.value)
