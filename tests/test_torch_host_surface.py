"""The rest of the port's host surface against the JAX package's, on the
CPU: the sync oracle (``core/syncsim.SyncOracle``), ``utils/randgen``,
``utils/compare.dense_state_mismatches``, the metric models
(``stream_occupancy``, ``max_batch_estimate``, ``tick_cost_model``), the
``run`` and ``test`` commands and the bench rows' ``cost_model``.

``SyncOracle`` runs the JAX ``tests/test_sync_differential.py`` programs
(seeded ER and scale-free graphs, random storm programs under a fixed
delay) and equals the JAX oracle field for field and the port's sync
runner on the CPU (one lane: balances, clock, frozen balances, completion
counts, every recorded window). ``randgen`` draws the JAX graphs and
scripts from the same seeds. ``dense_state_mismatches`` names exactly the
field that was changed (the JAX function on the same pair names the
same). The metric models give the JAX numbers. ``run`` prints the JAX
CLI's stdout on both backends, its trace on stderr; ``test --backend
parity`` passes 7 of 7. Tolerance: none.
"""

import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from chandy_lamport_tpu import cli as jax_cli
from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.state import DenseTopology as JaxTopology
from chandy_lamport_tpu.core.syncsim import SyncOracle as JaxOracle
from chandy_lamport_tpu.models import delay as jax_delay
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.utils import compare as jax_compare
from chandy_lamport_tpu.utils import metrics as jax_metrics
from chandy_lamport_tpu.utils import randgen as jax_randgen
from chandy_lamport_tpu_torch import bench
from chandy_lamport_tpu_torch.__main__ import golden_test, run_cmd
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.state import (
    DenseTopology,
    recorded_window,
)
from chandy_lamport_tpu_torch.core.syncsim import SyncOracle
from chandy_lamport_tpu_torch.models import delay
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.workloads import StormProgram
from chandy_lamport_tpu_torch.ops.delay import FixedDelay, HashDelay
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils import metrics, randgen
from chandy_lamport_tpu_torch.utils.carry import state_to_numpy
from chandy_lamport_tpu_torch.utils.compare import dense_state_mismatches
from chandy_lamport_tpu_torch.utils.goldens import (
    REFERENCE_TESTS,
    fixture_path,
)


# ---- the sync oracle ------------------------------------------------------

def _random_program(rng, topo, phases, max_snapshots):
    """The JAX differential's program draw (tests/test_sync_differential.
    py), verbatim."""
    amounts = np.zeros((phases, topo.e), np.int32)
    floor = topo.tokens0.astype(np.int64).copy()
    for ph in range(phases):
        for e in rng.sample(range(topo.e), k=max(1, topo.e // 3)):
            src = int(topo.edge_src[e])
            if floor[src] >= 2:
                amt = rng.randrange(1, 3)
                amounts[ph, e] += amt
                floor[src] -= amt
    n_snaps = rng.randrange(1, max_snapshots)
    snap = np.full((phases, 2), -1, np.int32)
    sched = [(rng.randrange(phases), rng.randrange(topo.n))
             for _ in range(n_snaps)]
    per_phase, used = {}, 0
    for ph, node in sched:
        per_phase.setdefault(ph, []).append(node)
    for ph, nodes in per_phase.items():
        nodes = sorted(set(nodes))[:2]
        snap[ph, :len(nodes)] = nodes
        used += len(nodes)
    return StormProgram(amounts, snap), used


def _drive(oracle, prog):
    amounts, snap = np.asarray(prog.amounts), np.asarray(prog.snap)
    for ph in range(len(amounts)):
        oracle.bulk_send([int(a) for a in amounts[ph]])
        nodes = [int(x) for x in snap[ph] if x >= 0]
        if nodes:
            oracle.start_snapshots(nodes)
        oracle.tick()
    oracle.drain_and_flush()
    return oracle


def _oracle_fields(o):
    return (o.time, o.tokens, o.next_sid, o.frozen, o.rem,
            {s: sorted(v) for s, v in o.recording.items()}, o.recorded,
            {s: sorted(v) for s, v in o.done.items()}, o.completed,
            [list(q) for q in o.queues])


@pytest.mark.parametrize("case", range(6))
def test_sync_oracle_equals_jax_and_the_port_runner(case):
    """The JAX differential's case ``case``: the port's oracle equals the
    JAX oracle in every field, and the port's sync storm (one lane, the
    CPU) equals the oracle."""
    rng = random.Random(5000 + case)
    n = rng.randrange(4, 14)
    spec = (workloads.erdos_renyi(n, 2.5, seed=case, tokens=60) if case % 2
            else workloads.scale_free(n, 2, seed=case, tokens=60))
    jspec = (jax_workloads.erdos_renyi(n, 2.5, seed=case, tokens=60)
             if case % 2 else
             jax_workloads.scale_free(n, 2, seed=case, tokens=60))
    fixed = rng.randrange(1, 5)
    topo = DenseTopology(spec)
    phases = rng.randrange(6, 16)
    prog, n_snaps = _random_program(rng, topo, phases, max_snapshots=6)

    oracle = _drive(SyncOracle(topo, delay.FixedDelay(fixed)), prog)
    joracle = _drive(JaxOracle(JaxTopology(jspec),
                               jax_delay.FixedDelay(fixed)), prog)
    assert _oracle_fields(oracle) == _oracle_fields(joracle)

    runner = BatchedRunner(spec, SimConfig(queue_capacity=32,
                                           max_recorded=64),
                           FixedDelay(fixed), 1, scheduler="sync",
                           device="cpu")
    final = runner.run_storm(runner.init_batch_device(), prog)
    host = state_to_numpy(final, runner.delay)
    lane = type(host)(*(tuple(w[0] for w in leaf) if isinstance(leaf, tuple)
                        else leaf[0] for leaf in host))
    assert int(lane.error) == 0
    assert oracle.next_sid == int(lane.next_sid) == n_snaps
    assert oracle.time == int(lane.time)
    assert oracle.tokens == [int(t) for t in lane.tokens]
    assert all(len(q) == 0 for q in oracle.queues)
    for sid in range(n_snaps):
        assert oracle.completed[sid] == int(lane.completed[sid]) == topo.n
        for node in range(topo.n):
            assert oracle.frozen[sid][node] == int(lane.frozen[sid, node])
        for e in range(topo.e):
            assert oracle.recorded[sid].get(e, []) == \
                recorded_window(lane, sid, e), (sid, e)


# ---- randgen --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_randgen_streams_equal_jax(seed):
    """The same seed draws the same graph and script in both packages,
    and leaves both generators in the same state."""
    prng, jrng = random.Random(seed), random.Random(seed)
    for n in (3, 6, 11):
        ptopo = randgen.random_strongly_connected(prng, n)
        jtopo = jax_randgen.random_strongly_connected(jrng, n)
        assert (ptopo.nodes, ptopo.links) == (jtopo.nodes, jtopo.links)
        pev = randgen.random_script(prng, ptopo, 30)
        jev = jax_randgen.random_script(jrng, jtopo, 30)
        assert [str(e) for e in pev] == [str(e) for e in jev]
        assert [type(e).__name__ for e in pev] == \
            [type(e).__name__ for e in jev]
    assert prng.random() == jrng.random()


# ---- dense_state_mismatches -----------------------------------------------

@pytest.fixture(scope="module")
def storm_final():
    spec = workloads.ring_topology(6, tokens=20)
    runner = BatchedRunner(spec, SimConfig(max_snapshots=2), HashDelay(3),
                           2, device="cpu")
    topo = runner.topo
    prog = workloads.storm_program(
        topo, phases=4, snapshot_phases=workloads.staggered_snapshots(
            topo, 1, 1, 2, max_phases=4))
    return runner, runner.run_storm(runner.init_batch_device(), prog)


@pytest.mark.parametrize("field", ["tokens", "q_meta", "rec_start",
                                   "error", "delay_state", "tr_on"])
def test_dense_state_mismatches_flags_exactly_the_changed_field(
        storm_final, field):
    """One leaf changed in one place: the port's function names that
    field and no other, as the JAX function does on the numpy twins; an
    unchanged copy (and the same state on another device) has none."""
    runner, final = storm_final
    clone = type(final)(*(tuple(w.clone() for w in leaf)
                          if isinstance(leaf, tuple) else leaf.clone()
                          for leaf in final))
    assert dense_state_mismatches(final, clone) == []
    leaf = getattr(clone, field)
    target = leaf[0] if isinstance(leaf, tuple) else leaf
    flat = target.view(-1)
    flat[0] = flat[0] + 1 if flat.dtype != torch.bool else ~flat[0]
    assert dense_state_mismatches(final, clone) == [field]
    a = state_to_numpy(final, runner.delay)
    b = state_to_numpy(clone, runner.delay)
    assert jax_compare.dense_state_mismatches(a, b) == [field]


# ---- the metric models ----------------------------------------------------

@pytest.mark.parametrize("engine", ["gather", "mask"])
@pytest.mark.parametrize("shape", [(8, 8, 4, 1), (256, 768, 8, 4096),
                                   (1024, 3066, 8, 2048)])
def test_metric_models_equal_jax(shape, engine):
    """``tick_cost_model`` and ``max_batch_estimate`` give the JAX numbers
    at bench-like shapes and configs."""
    n, e, snaps, batch = shape
    for kw in ({}, {"record_dtype": "int16", "window_dtype": "uint16",
                    "trace_capacity": 64}):
        cfg = SimConfig.for_workload(snapshots=snaps, **kw)
        jcfg = JaxSimConfig.for_workload(snapshots=snaps, **kw)
        assert metrics.tick_cost_model(n, e, cfg, batch, engine) == \
            jax_metrics.tick_cost_model(n, e, jcfg, batch, engine)
        for hbm, factor in ((80e9, 2.0), (16e9, 1.0), (1, 2.0)):
            assert metrics.max_batch_estimate(n, e, cfg, int(hbm),
                                              factor) == \
                jax_metrics.max_batch_estimate(n, e, jcfg, int(hbm), factor)


def test_stream_occupancy_equals_jax():
    """``stream_occupancy`` of a real stream equals the JAX function on
    the same counters, and the counters' own occupancy; an empty stream
    gives 0.0."""
    from chandy_lamport_tpu_torch.utils.carry import stream_to_numpy

    spec = workloads.ring_topology(4)
    runner = BatchedRunner(spec, None, HashDelay(1), 2, device="cpu")
    jobs = workloads.stream_jobs(spec, 5, seed=3, max_phases=6)
    _, stream = runner.run_stream(runner.pack_jobs(jobs))
    occ = metrics.stream_occupancy(stream)
    assert 0.0 < occ <= 1.0
    assert occ == jax_metrics.stream_occupancy(stream_to_numpy(stream))
    assert round(occ, 4) == runner.summarize_stream(stream)["occupancy"]
    empty = stream._replace(lane_steps_total=torch.tensor(0))
    assert metrics.stream_occupancy(empty) == 0.0


# ---- the commands ---------------------------------------------------------

@pytest.mark.parametrize("case", REFERENCE_TESTS,
                         ids=lambda c: c[1].removesuffix(".events"))
def test_run_stdout_equals_the_jax_cli(capsys, case):
    """``run TOP EVENTS`` on both backends prints the JAX CLI's ``run``
    stdout byte for byte; ``--trace`` adds the timeline on stderr, the
    JAX CLI's."""
    top, events, _ = case
    paths = [fixture_path(top), fixture_path(events)]
    assert jax_cli.main(["run", *paths, "--trace"]) == 0
    want = capsys.readouterr()
    for backend in ("parity", "torch"):
        assert run_cmd(paths + ["--backend", backend, "--trace",
                                "--device", "cpu"]) == 0
        got = capsys.readouterr()
        assert got.out == want.out, backend
        assert got.err == want.err, backend
    assert want.out.strip()


def test_test_command_backends(capsys):
    """``test --backend parity`` passes 7 of 7 (no device line, as in
    JAX); ``--exact-impl wave`` is refused with exit 2 on the torch
    backend and ignored on parity."""
    assert golden_test(["--backend", "parity"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "7/7 passed"
    assert sum(line.startswith("PASS ") for line in out) == 7
    assert golden_test(["--backend", "torch", "--exact-impl", "wave",
                        "--device", "cpu"]) == 2
    assert "wave" in capsys.readouterr().err
    assert golden_test(["--backend", "parity", "--exact-impl", "wave"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "7/7 passed"


# ---- the bench rows' cost model -------------------------------------------

def _row(capsys, argv):
    assert bench.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["storm", "stream", "serve"])
def test_bench_rows_carry_the_jax_cost_model(capsys, mode):
    """The storm, stream and serve rows carry ``cost_model``: the JAX
    ``tick_cost_model`` at the row's shape (its graph, config and batch)
    with the port's queue engine, "gather"."""
    flags = ["--device", "cpu", "--graph", "er", "--nodes", "12",
             "--batch", "2", "--phases", "4", "--snapshots", "2",
             "--repeats", "1", "--scheduler", "sync"]
    extra = {"storm": [], "stream": ["--stream", "--jobs", "4"],
             "serve": ["--serve", "--jobs", "4", "--rate", "0.5"]}[mode]
    row = _row(capsys, flags + extra)
    jspec = jax_workloads.erdos_renyi(12, 3.0, seed=3, tokens=14)
    jtopo = JaxTopology(jspec)
    jcfg = JaxSimConfig.for_workload(snapshots=2, max_recorded=0,
                                     record_dtype="int16",
                                     window_dtype="int32",
                                     split_markers=True,
                                     snapshot_timeout=0,
                                     snapshot_retries=3, snapshot_every=0)
    assert dataclasses.asdict(jcfg)["queue_capacity"] > 0
    want = jax_metrics.tick_cost_model(jtopo.n, jtopo.e, jcfg, batch=2,
                                       queue_engine="gather")
    assert row["cost_model"] == want
