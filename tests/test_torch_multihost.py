"""The port's multi-process surface (parallel/multihost.py,
parallel/mesh.py) against the JAX package's, on the CPU.

(a) ``initialize`` is a no-op without a coordinator; ``hybrid_mesh``'s
axes and its refusals, ``process_info``'s keys, ``instance_mesh``,
``shard_batch`` and ``replicate``. (b) A two-process gloo job (the dist
mesh, one shard a process, ``batch_isend_irecv`` for the halo): each
process's final shard equals the matching shard of the stacked run and of
the JAX runner, both engines under the fixed delay and the sparse engine
under the per-shard threefry streams at megatick 3; every leaf, no
tolerance. (c) The module's two-process dry run prints its verdict.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.parallel import graphshard as jax_gs
from chandy_lamport_tpu.parallel import multihost as jax_multihost
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.parallel import multihost
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.parallel.graphshard import (
    ShardedState,
    state_to_numpy,
)
from chandy_lamport_tpu_torch.parallel.mesh import (
    Mesh,
    instance_mesh,
    replicate,
    shard_batch,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
       "LOCAL_WORLD_SIZE")


def test_initialize_is_noop_without_coordinator(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False


@pytest.mark.parametrize("call", ["process_device", "dry_run", "case",
                                  "hybrid_mesh"])
def test_entry_points_need_the_card_or_an_explicit_cpu(monkeypatch, call):
    """Without CUDA and without a device the multi-process entry points
    raise instead of running on the CPU: ``process_device``, the module's
    dry run and its ``--case`` worker, ``hybrid_mesh``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    run = {"process_device": lambda: multihost.process_device(),
           "dry_run": lambda: multihost.main([]),
           "case": lambda: multihost.main(["--case"]),
           "hybrid_mesh": lambda: multihost.hybrid_mesh(graph=1)}[call]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run()
    assert multihost.process_device("cpu") == torch.device("cpu")


def test_hybrid_mesh_axes_and_refusals():
    """A stacked 8-position mesh splits as the JAX hybrid mesh does on
    the 8-device CPU mesh; a graph size that does not divide the devices
    is refused with the JAX message."""
    want = jax_multihost.hybrid_mesh(graph=2)
    mesh = multihost.hybrid_mesh(graph=2, devices=8, device="cpu")
    assert mesh.axis_names == tuple(want.axis_names) == ("data", "graph")
    assert mesh.shape == dict(want.shape)
    assert (mesh.backend, str(mesh.device)) == ("stacked", "cpu")
    with pytest.raises(ValueError) as jerr:
        jax_multihost.hybrid_mesh(graph=3)
    with pytest.raises(ValueError) as perr:
        multihost.hybrid_mesh(graph=3, devices=8, device="cpu")
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        multihost.hybrid_mesh(graph=2, device="cpu")  # one CPU device
    with pytest.raises(ValueError):
        multihost.hybrid_mesh(graph=0, devices=8, device="cpu")


def test_process_info_single_process():
    info = multihost.process_info()
    assert set(info) == set(jax_multihost.process_info())
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["local_devices"] == info["global_devices"] >= 1


def test_instance_mesh_shard_batch_replicate():
    mesh = instance_mesh(device="cpu")
    assert mesh.shape == {"data": 1} and mesh.backend == "stacked"
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        instance_mesh(2, device="cpu")
    r = BatchedRunner(workloads.ring_topology(4), SimConfig(), HashDelay(1),
                      4, scheduler="sync", device="cpu")
    state = r.init_batch_device()
    (whole,) = shard_batch(state, mesh)
    assert int(whole.time.shape[0]) == 4
    blocks = shard_batch(state, Mesh({"data": 2}, device="cpu"))
    assert [int(b.tokens.shape[0]) for b in blocks] == [2, 2]
    assert all(np.array_equal(b.tokens.numpy(), state.tokens[2 * i:2 * i
                                                               + 2].numpy())
               for i, b in enumerate(blocks))
    with pytest.raises(ValueError):
        shard_batch(state, Mesh({"data": 3}, device="cpu"))
    (copy,) = replicate(state, mesh)
    assert np.array_equal(copy.tokens.numpy(), state.tokens.numpy())


@pytest.mark.parametrize("engines,megatick,fixed", [
    (("sparse", "dense"), 1, 2), (("sparse",), 3, 0)])
def test_two_process_gloo_equals_stacked_and_jax(tmp_path, engines,
                                                 megatick, fixed):
    """``--case`` over two gloo processes on the CPU (er-16, 6 phases, 2
    snapshots; fixed delay 2 under both engines, or the per-shard streams
    of seed 17): each process's shard equals the stacked run's and the
    JAX runner's; the balances summed across the processes are the
    graph's tokens."""
    argv = ["-m", "chandy_lamport_tpu_torch.parallel.multihost", "--case",
            "--graph", "er", "--nodes", "16", "--phases", "6",
            "--snapshots", "2", "--engine", *engines, "--megatick",
            str(megatick), "--fixed-delay", str(fixed), "--seed", "17",
            "--device", "cpu", "--out", str(tmp_path)]
    results = multihost.launch(argv, 2, timeout=150)
    for rc, out, err in results:
        assert rc == 0, err[-2000:]
        row = json.loads(out.strip().splitlines()[-1])
        assert row["world"] == 2 and row["backend"] == "gloo"
        assert not row["staged_through_host"]
        assert row["tokens_total"] == 16 * 16
        assert [r["error"] for r in row["runs"]] == [0] * len(engines)
    for engine in engines:
        stacked = _stacked(engine, megatick, fixed)
        want = _jax(engine, megatick, fixed)
        for rank in range(2):
            with np.load(tmp_path / f"rank{rank}-{engine}.npz") as z:
                got = {k: z[k] for k in z.files}
            for name in ShardedState._fields:
                sharded = name in _SHARDED_NAMES
                for ref, label in ((stacked, "stacked"), (want, "jax")):
                    w = np.asarray(getattr(ref, name))
                    w = w[rank:rank + 1] if sharded else w
                    assert got[name].dtype == w.dtype, (label, name)
                    np.testing.assert_array_equal(
                        got[name], w, err_msg=f"{engine}:{label}:{name}")


_SHARDED_NAMES = {"tokens", "q_data", "q_meta", "q_head", "q_len",
                  "tok_pushed", "mk_cnt", "m_pending", "m_rtime", "m_key",
                  "has_local", "frozen", "rem", "done_local", "recording",
                  "rec_cnt", "min_prot", "log_amt", "rec_start", "rec_end",
                  "delay_key"}


class _Args:
    graph, nodes, phases, snapshots, seed = "er", 16, 6, 2, 17

    def __init__(self, megatick, fixed):
        self.megatick, self.fixed_delay = megatick, fixed


def _stacked(engine, megatick, fixed):
    runner, prog = multihost.case_runner(
        _Args(megatick, fixed), Mesh({"graph": 2}, device="cpu"), engine)
    return state_to_numpy(runner.run_storm(runner.init_state(),
                                           prog.amounts, prog.snap))


def _jax(engine, megatick, fixed):
    spec = jax_workloads.erdos_renyi(16, 3.0, seed=3, tokens=16)
    cfg = JaxSimConfig.for_workload(snapshots=2, record_dtype="int16",
                                    split_markers=True)
    kw = {"fixed_delay": fixed} if fixed else {"seed": 17}
    gs = jax_gs.GraphShardedRunner(
        spec, cfg, JaxMesh(np.array(jax.devices()[:2]), ("graph",)),
        comm_engine=engine, megatick=megatick, **kw)
    prog = jax_workloads.storm_program(
        gs.topo, phases=6, amount=1,
        snapshot_phases=jax_workloads.staggered_snapshots(
            gs.topo, 2, 1, 2, max_phases=6))
    return jax.device_get(gs.run_storm(gs.init_state(),
                                       np.asarray(prog.amounts),
                                       np.asarray(prog.snap)))


def test_module_dry_run():
    """``python -m chandy_lamport_tpu_torch.parallel.multihost``: two gloo
    processes, the cross-process sum, the summed storm counters, sparse
    equal to dense across the processes, both data x graph layouts."""
    proc = subprocess.run(
        [sys.executable, "-m", "chandy_lamport_tpu_torch.parallel.multihost",
         "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        timeout=280)
    assert proc.returncode == 0, proc.stderr.decode(errors="replace")[-2000:]
    verdict = json.loads(proc.stdout.decode().strip().splitlines()[-1])
    assert verdict["ok"] is True and len(verdict["workers"]) == 2
    for w in verdict["workers"]:
        row = json.loads(w.splitlines()[-1])
        assert row["global_snapshots_completed"] == 8
        assert row["graph_engines_agree"] is True
        model = row["comm_bytes_model"]
        assert 0 < model["sparse_bytes_per_tick"] < \
            model["dense_bytes_per_tick"]
