"""The graph-sharded runner on the card (marker ``cuda``; skipped on a
machine without a GPU).

Each sharded path launches the CUDA rows 1-5 (the segment sums, spread,
head_fields, append_rows) and never rows 6-8, and its final state equals
the same run on the CPU (the plain versions) on every leaf: stacked
storms under both engines, the fixed delay and the per-shard streams, at
megatick 1 and 3; the supervisor, quarantine and the recorder; an event
script; the data x graph mode; and a two-process gloo job on the card
(the rows it exchanges staged through host memory) equal to the stacked
run. Rows 4 and 5 at the stacked [P, Em, C] shapes equal their plain
versions. Run on a GPU machine with ``python -m pytest --noconftest
tests/test_torch_graphshard_cuda.py``.
"""

import json

import numpy as np
import pytest
import torch

from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.kernels import (
    launch_counts,
    reset_launch_counts,
)
from chandy_lamport_tpu_torch.kernels import queue as kq
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.parallel import multihost
from chandy_lamport_tpu_torch.parallel.graphshard import (
    _SHARDED,
    GraphShardedRunner,
    state_to_numpy,
)
from chandy_lamport_tpu_torch.parallel.mesh import Mesh
from chandy_lamport_tpu_torch.utils.fixtures import (
    read_events_file,
    read_topology_file,
)
from chandy_lamport_tpu_torch.utils.goldens import fixture_path
from chandy_lamport_tpu_torch.utils.tracing import Trace

pytestmark = pytest.mark.cuda

PATH = ("sum_by_perm", "sum_segments", "spread", "head_fields",
        "append_rows")
IDLE = ("queue_step", "select_pop", "append_marker_rows", "fused_scan")
CFG = dict(queue_capacity=16, max_snapshots=8, max_recorded=32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _program(spec, phases=12, snaps=3):
    from chandy_lamport_tpu_torch.core.state import DenseTopology

    topo = DenseTopology(spec)
    prog = workloads.storm_program(topo, phases, 1,
                                   workloads.staggered_snapshots(topo, snaps))
    return np.asarray(prog.amounts), np.asarray(prog.snap)


def _both(spec, shards, run, cfg=CFG, mesh_shape=None, path=PATH, **kw):
    """``run(runner)`` on the card and on the CPU, every leaf equal; on
    the card every kernel of ``path`` launched and none of rows 6-8."""
    finals = {}
    for device in ("cuda", "cpu"):
        mesh = Mesh(mesh_shape or {"graph": shards}, device=device)
        runner = GraphShardedRunner(spec, SimConfig(**cfg), mesh, **kw)
        reset_launch_counts()
        finals[device] = state_to_numpy(run(runner))
        if device == "cuda":
            launches = launch_counts()
    _equal(finals["cuda"], finals["cpu"])
    assert all(launches[k] > 0 for k in path), launches
    assert all(launches[k] == 0 for k in IDLE), launches
    return finals["cuda"]


@pytest.mark.parametrize("engine,megatick,delay", [
    ("sparse", 1, {"fixed_delay": 2}), ("dense", 3, {"fixed_delay": 2}),
    ("sparse", 3, {"seed": 5}), ("dense", 1, {"seed": 5})])
def test_stacked_storm_card_equals_cpu(dev, engine, megatick, delay):
    spec = workloads.scale_free(64, 2, seed=3, tokens=30)
    amounts, snap = _program(spec)
    final = _both(spec, 4, lambda r: r.run_storm(r.init_state(), amounts,
                                                 snap),
                  comm_engine=engine, megatick=megatick, **delay)
    assert int(final.error) == 0


def test_supervised_quarantined_traced_storm_card_equals_cpu(dev):
    spec = workloads.erdos_renyi(32, 2.5, seed=3, tokens=40)
    amounts, snap = _program(spec)
    cfg = dict(CFG, snapshot_timeout=3, snapshot_retries=1,
               snapshot_every=5, trace_capacity=64)
    _both(spec, 4, lambda r: r.run_storm(r.init_state(), amounts, snap),
          cfg=cfg, seed=9, check_every=2, megatick=3, quarantine=True,
          trace=Trace())


def test_script_card_equals_cpu(dev):
    spec = read_topology_file(fixture_path("8nodes.top"))
    script = read_events_file(
        fixture_path("8nodes-concurrent-snapshots.events"))
    cfg = dict(queue_capacity=32, max_snapshots=16, max_recorded=32)
    # a script's sends are scalar pushes (no row 2 debit, no row 5 append)
    final = _both(spec, 4, lambda r: r.run_script(r.init_state(), script),
                  cfg=cfg, path=("sum_by_perm", "spread", "head_fields"),
                  fixed_delay=2)
    assert int(final.error) == 0


def test_data_x_graph_card_equals_cpu(dev):
    spec = workloads.scale_free(64, 2, seed=3, tokens=30)
    amounts, snap = _program(spec)
    final = _both(spec, 4, lambda r: r.run_storm_batched(
        r.init_batch(8), amounts, snap), mesh_shape={"data": 2, "graph": 4},
        seed=5)
    assert (final.error == 0).all()


def test_stacked_ring_kernels_equal_plain(dev):
    """head_fields and append_rows at the stacked [P, Em, C] shapes of a
    finished storm on the card, bit for bit against the plain versions."""
    spec = workloads.scale_free(256, 2, seed=3, tokens=30)
    amounts, snap = _program(spec)
    r = GraphShardedRunner(spec, SimConfig(**CFG),
                           Mesh({"graph": 4}, device=dev), seed=3)
    f = r.run_storm(r.init_state(), amounts, snap)
    got = kq.head_fields(f.q_meta, f.q_data, f.q_head)
    want = kq.head_fields_plain(f.q_meta, f.q_data, f.q_head)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    amt = r.shard_program(amounts[:1], snap[:1])[0][0]
    rt = torch.full_like(amt, int(f.time) + 3)
    leaves = (f.q_meta, f.q_data, f.q_head, f.q_len, f.tok_pushed,
              torch.zeros(4, dtype=torch.int32, device=dev))
    kw = dict(capacity=16, key_limit=r._key_limit, flag_queue_overflow=False)
    got = kq.append_rows(*(x.clone() for x in leaves), amt > 0, rt, False,
                         amt, **kw)
    want = kq.append_rows_plain(*(x.clone() for x in leaves), amt > 0, rt,
                                False, amt, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_two_gloo_processes_on_the_card_equal_stacked(dev, tmp_path):
    """Two processes on the one card over gloo (staged through host
    memory), both engines: each shard equals the stacked run's."""
    argv = ["-m", "chandy_lamport_tpu_torch.parallel.multihost", "--case",
            "--graph", "sf", "--nodes", "64", "--phases", "8",
            "--snapshots", "2", "--fixed-delay", "2", "--device", "cuda",
            "--backend", "gloo", "--out", str(tmp_path), "--engine",
            "sparse", "dense"]
    results = multihost.launch(argv, 2, timeout=300)
    for rc, out, err in results:
        assert rc == 0, err[-2000:]
        assert json.loads(out.strip().splitlines()[-1])[
            "staged_through_host"] is True

    class Case:
        graph, nodes, phases, snapshots = "sf", 64, 8, 2
        seed, megatick, fixed_delay = 17, 1, 2

    for engine in ("sparse", "dense"):
        runner, prog = multihost.case_runner(
            Case, Mesh({"graph": 2}, device=dev), engine)
        want = state_to_numpy(runner.run_storm(runner.init_state(),
                                               prog.amounts, prog.snap))
        for rank in range(2):
            with np.load(tmp_path / f"rank{rank}-{engine}.npz") as z:
                for name in want._fields:
                    w = np.asarray(getattr(want, name))
                    if name in _SHARDED:
                        w = w[rank:rank + 1]
                    np.testing.assert_array_equal(z[name], w,
                                                  err_msg=name)
