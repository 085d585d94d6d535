"""Event scripts and checkpoints on the port's graph-sharded runner
against the JAX package's, on the virtual CPU mesh, in process.

(a) ``run_script`` on the reference fixtures and on the JAX
``test_sparse_comm.py`` corners (cut edges both ways, a zero cut, a
remote creator), both comm engines: every ``ShardedState`` leaf equal to
the JAX runner's, and ``gather_dense`` equal to the unsharded sync
runner's; the 7 goldens through both engines (marked slow, as in JAX).
(b) ``compile_script``'s corners. (c) Checkpoints: the JAX treedef, a
JAX file resumed in the port and the port's file loaded by JAX, every
leaf equal to the uninterrupted run; a DenseState file refused.
"""

import functools

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core import spec as jax_spec
from chandy_lamport_tpu.parallel import graphshard as jax_gs
from chandy_lamport_tpu.utils import checkpoint as jax_ckpt
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.spec import (
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.core.state import DenseTopology, init_state
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.delay import FixedDelay
from chandy_lamport_tpu_torch.parallel.batch import (
    BatchedRunner,
    compile_events,
)
from chandy_lamport_tpu_torch.parallel.graphshard import (
    GraphShardedRunner,
    state_to_numpy,
)
from chandy_lamport_tpu_torch.parallel.mesh import Mesh
from chandy_lamport_tpu_torch.utils import checkpoint
from chandy_lamport_tpu_torch.utils.carry import (
    state_to_numpy as dense_to_numpy,
)
from chandy_lamport_tpu_torch.utils.fixtures import (
    TopologySpec,
    read_events_file,
    read_topology_file,
)
from chandy_lamport_tpu_torch.utils.goldens import (
    REFERENCE_TESTS,
    fixture_path,
)

CFG = dict(queue_capacity=16, max_snapshots=8, max_recorded=16)
GOLDEN_CFG = dict(queue_capacity=32, max_snapshots=16, max_recorded=32)
FIELDS = ("time", "tokens", "q_meta", "q_data", "q_head", "q_len",
          "tok_pushed", "mk_cnt", "m_pending", "m_rtime", "m_key",
          "next_sid", "started", "has_local", "frozen", "rem",
          "done_local", "recording", "rec_cnt", "min_prot", "log_amt",
          "rec_start", "rec_end", "completed", "error")


def _jax_mesh(p):
    return JaxMesh(np.array(jax.devices()[:p]), ("graph",))


def _assert_leaves_equal(got, want, label=""):
    for name, g, w in zip(want._fields, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, f"{label}{name}"
        np.testing.assert_array_equal(g, w, err_msg=f"{label}{name}")


def _jax_events(script):
    """The port's events as the JAX package's (same fields)."""
    return [getattr(jax_spec, type(ev).__name__)(**vars(ev)) for ev in script]


def _unsharded(spec, script, cfg):
    """The unsharded sync runner's final state (one lane, numpy)."""
    ref = BatchedRunner(spec, SimConfig(**cfg), FixedDelay(2), 1,
                        scheduler="sync", device="cpu")
    final = ref.run(ref.init_batch_device(), compile_events(ref.topo,
                                                            script))
    return type(final)(*(
        tuple(w[0] for w in x) if isinstance(x, tuple) else x[0]
        for x in dense_to_numpy(final)))


def _script_case(spec, script, shards, cfg=CFG):
    """The script through JAX's sharded runner once and the port's under
    both engines: every leaf equal, and each de-sharded state equal to the
    unsharded sync runner's."""
    jgs = jax_gs.GraphShardedRunner(spec, JaxSimConfig(**cfg),
                                    _jax_mesh(shards), fixed_delay=2)
    want = jax.device_get(jgs.run_script(jgs.init_state(),
                                         _jax_events(script)))
    dense = _unsharded(spec, script, cfg)
    runners = {"error": int(dense.error)}
    for engine in ("sparse", "dense"):
        gs = GraphShardedRunner(spec, SimConfig(**cfg),
                                Mesh({"graph": shards}, device="cpu"),
                                fixed_delay=2, comm_engine=engine)
        final = gs.run_script(gs.init_state(), script)
        _assert_leaves_equal(state_to_numpy(final), want, f"{engine}:")
        got = gs.gather_dense(final)
        for name in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                          np.asarray(getattr(dense, name)),
                                          err_msg=f"{engine}:{name}")
        runners[engine] = gs
    return runners


@pytest.mark.parametrize("top,events,shards", [
    ("8nodes.top", "8nodes-concurrent-snapshots.events", 4),
    ("10nodes.top", "10nodes.events", 2)])
def test_fixture_scripts_match_jax(top, events, shards):
    spec = read_topology_file(fixture_path(top))
    script = read_events_file(fixture_path(events))
    assert _script_case(spec, script, shards, GOLDEN_CFG)["error"] == 0


def test_cross_boundary_both_directions():
    """Cut edges in opposite directions in the same ticks (the JAX
    corner): both halves of the exchange carry traffic."""
    spec = TopologySpec(
        [("N1", 6), ("N2", 4), ("N3", 5), ("N4", 3)],
        [("N1", "N3"), ("N4", "N2"), ("N1", "N2"), ("N3", "N4"),
         ("N2", "N1"), ("N4", "N3")])
    script = [
        PassTokenEvent("N1", "N3", 2), PassTokenEvent("N4", "N2", 1),
        TickEvent(1), SnapshotEvent("N1"),
        PassTokenEvent("N3", "N4", 1), PassTokenEvent("N2", "N1", 1),
        TickEvent(4), SnapshotEvent("N4"),
        PassTokenEvent("N1", "N3", 1), PassTokenEvent("N4", "N2", 2),
        TickEvent(6)]
    runners = _script_case(spec, script, 2)
    assert runners["error"] == 0 and runners["sparse"].halo > 0
    model = runners["sparse"].comm_model()
    assert model["cut_edges"] == 2 and model["sparse_bytes_per_tick"] > 0


def test_zero_cut_and_remote_creator():
    """Two components, one a shard (halo 0: no exchange at all), and a
    ring whose snapshot starts on shard 1 (its markers reach shard 0's
    edges through the reverse exchange)."""
    zero = TopologySpec(
        [("N1", 5), ("N2", 5), ("N3", 5), ("N4", 5)],
        [("N1", "N2"), ("N2", "N1"), ("N3", "N4"), ("N4", "N3")])
    runners = _script_case(zero, [
        PassTokenEvent("N1", "N2", 2), PassTokenEvent("N3", "N4", 1),
        TickEvent(1), SnapshotEvent("N1"), SnapshotEvent("N3"),
        PassTokenEvent("N2", "N1", 1), PassTokenEvent("N4", "N3", 2),
        TickEvent(5)], 2, dict(CFG, max_ticks=60))
    # the foreign component's snapshot never completes: the drain's
    # budget runs out (ERR_TICK_LIMIT), in every runner alike
    assert runners["error"] == 16 and runners["sparse"].halo == 0
    ring = TopologySpec(
        [("N1", 4), ("N2", 4), ("N3", 4), ("N4", 4)],
        [("N1", "N2"), ("N2", "N3"), ("N3", "N4"), ("N4", "N1")])
    script = [PassTokenEvent("N1", "N2", 1), TickEvent(1),
              SnapshotEvent("N3"), PassTokenEvent("N2", "N3", 1),
              PassTokenEvent("N4", "N1", 1), TickEvent(8)]
    gs = _script_case(ring, script, 2)["sparse"]
    got = gs.gather_dense(gs.run_script(gs.init_state(), script))
    assert int(got.completed[0]) == 4


def test_uniform_script_matches_jax():
    """A script under the per-shard threefry streams: every op slot splits
    every shard's key, as the JAX body does."""
    spec = read_topology_file(fixture_path("8nodes.top"))
    script = read_events_file(
        fixture_path("8nodes-sequential-snapshots.events"))
    jgs = jax_gs.GraphShardedRunner(spec, JaxSimConfig(**GOLDEN_CFG),
                                    _jax_mesh(2), seed=12)
    want = jax.device_get(jgs.run_script(jgs.init_state(),
                                         _jax_events(script)))
    gs = GraphShardedRunner(spec, SimConfig(**GOLDEN_CFG),
                            Mesh({"graph": 2}, device="cpu"), seed=12,
                            check_every=1)
    _assert_leaves_equal(state_to_numpy(gs.run_script(gs.init_state(),
                                                      script)), want)


@pytest.mark.slow
@pytest.mark.parametrize("top,events,snaps", REFERENCE_TESTS,
                         ids=[t[1].removesuffix(".events")
                              for t in REFERENCE_TESTS])
def test_goldens_both_engines(top, events, snaps):
    spec = read_topology_file(fixture_path(top))
    script = read_events_file(fixture_path(events))
    shards = 2 if len(spec.nodes) % 2 == 0 else 3
    assert _script_case(spec, script, shards, GOLDEN_CFG)["error"] == 0


def test_compile_script_corners():
    """A trailing send leaves a tick count of 0; a snapshot keeps its node
    index beyond the edge count and carries no shard (the JAX
    regressions)."""
    spec = read_topology_file(fixture_path("2nodes.top"))
    gs = GraphShardedRunner(spec, SimConfig(),
                            Mesh({"graph": 2}, device="cpu"), fixed_delay=1)
    script = gs.compile_script([TickEvent(1), PassTokenEvent("N1", "N2", 1)])
    assert script.do_tick.tolist() == [1, 0]
    spec = TopologySpec([("N1", 5), ("N2", 0), ("N3", 0), ("N4", 0)],
                        [("N1", "N2"), ("N2", "N3"), ("N3", "N4")])
    gs = GraphShardedRunner(spec, SimConfig(max_ticks=50),
                            Mesh({"graph": 2}, device="cpu"), fixed_delay=1)
    script = gs.compile_script([SnapshotEvent("N4"), TickEvent(1)])
    snap = script.kind.ravel() == 2
    assert script.loc.ravel()[snap].tolist() == [3]
    assert script.shard.ravel()[snap].tolist() == [-1]
    jgs = jax_gs.GraphShardedRunner(spec, JaxSimConfig(max_ticks=50),
                                    _jax_mesh(2), fixed_delay=1)
    want = jgs.compile_script(_jax_events([SnapshotEvent("N4"),
                                           TickEvent(1)]))
    for a, b in zip(script, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@functools.lru_cache(maxsize=None)
def _storm():
    spec = workloads.erdos_renyi(8, 2.5, seed=6, tokens=40)
    topo = DenseTopology(spec)
    prog = workloads.storm_program(topo, 8, 1,
                                   workloads.staggered_snapshots(topo, 3))
    return spec, np.asarray(prog.amounts), np.asarray(prog.snap)


def test_checkpoints_cross_both_ways(tmp_path):
    """A JAX file written mid-run resumes in the port, the port's file of
    the result loads in JAX, every leaf equal to the uninterrupted runs;
    the header's treedef is the JAX one."""
    spec, amounts, snap = _storm()
    jgs = jax_gs.GraphShardedRunner(spec, JaxSimConfig(**CFG), _jax_mesh(2),
                                    seed=21)
    gs = GraphShardedRunner(spec, SimConfig(**CFG),
                            Mesh({"graph": 2}, device="cpu"), seed=21)
    mid = jgs.run_storm(jgs.init_state(), amounts[:4], snap[:4])
    want = jax.device_get(jgs.run_storm(mid, amounts[4:], snap[4:]))
    jpath = str(tmp_path / "jax.npz")
    jax_ckpt.save_state(jpath, mid, meta={"kind": "sharded", "shards": 2})
    loaded, meta = checkpoint.load_state(jpath, gs.init_state())
    assert meta == {"kind": "sharded", "shards": 2}
    _assert_leaves_equal(state_to_numpy(loaded), jax.device_get(mid))
    final = gs.run_storm(loaded, amounts[4:], snap[4:])
    _assert_leaves_equal(state_to_numpy(final), want)
    ppath = str(tmp_path / "port.npz")
    checkpoint.save_state(ppath, final, meta={"kind": "sharded",
                                              "shards": 2})
    back, meta = jax_ckpt.load_state(ppath, jgs.init_state())
    assert meta["kind"] == "sharded"
    _assert_leaves_equal(back, want)
    leaves, treedef = jax.tree_util.tree_flatten(jgs.init_state())
    assert checkpoint.treedef_string(gs.init_state()) == str(treedef)


def test_sharded_checkpoint_rejects_dense_state(tmp_path):
    """A DenseState file does not load as a ShardedState (the JAX
    treedef check), nor the other way round."""
    spec = read_topology_file(fixture_path("2nodes.top"))
    topo = DenseTopology(spec)
    dense = init_state(topo, SimConfig(), 1, FixedDelay(1), "cpu")
    path = str(tmp_path / "dense.npz")
    checkpoint.save_state(path, dense)
    gs = GraphShardedRunner(spec, SimConfig(),
                            Mesh({"graph": 2}, device="cpu"), fixed_delay=1)
    with pytest.raises(ValueError):
        checkpoint.load_state(path, gs.init_state())
    spath = str(tmp_path / "sharded.npz")
    checkpoint.save_state(spath, gs.init_state())
    with pytest.raises(ValueError):
        checkpoint.load_state(spath, dense)
