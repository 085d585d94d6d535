"""Multi-process execution: ``torch.distributed`` for the mesh's dist
backend.

The port of the JAX package's ``parallel/multihost.py``. JAX brings up its
multi-controller runtime with ``jax.distributed.initialize``; here one
process drives one device and the processes join one
``torch.distributed`` process group:

  - **instance axis** (``data``): lanes split over processes, no traffic
    in steady state;
  - **graph axis** (``graph``, parallel/graphshard.py): the per-tick
    exchanges between shards, one shard a process; keep a graph group on
    one host (NVLink between cards, ``hybrid_mesh``'s second refusal),
    ``data`` outermost.

Usage (one process a card, e.g. under torchrun, which sets the env)::

    from chandy_lamport_tpu_torch.parallel import multihost
    multihost.initialize()                 # env://; no-op single-process
    mesh = multihost.hybrid_mesh(graph=4)  # dist mesh, graph innermost

Without a coordinator ``initialize()`` is a no-op returning False, and
``hybrid_mesh`` builds a stacked mesh on one device instead (every graph
shard on it). NCCL joins processes on different cards only: it does not
put two processes on one device, so on a one-card machine the dist
backend runs on gloo (its CUDA rows staged through host memory,
parallel/mesh.Mesh.staged), or on NCCL at world size 1.

``python -m chandy_lamport_tpu_torch.parallel.multihost`` is the
two-process dry run (the JAX ``tools/multihost_dryrun.py``): two local
gloo processes, a loopback coordinator, then a cross-process sum, a
batched storm per process with its counters summed, the graph-sharded
runner across both processes (sparse against dense, the sparse drain at
megatick 2, every leaf equal) and the data x graph mode on the same
mesh and across it (lanes split over the processes); one JSON verdict
line, exit 0 when every check holds. Both processes run on the card
unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from typing import List, Optional

import torch


def process_device(device=None) -> torch.device:
    """The device this process drives: ``device``, else the card (raising
    without CUDA, as ``parallel/batch.resolve_device`` does); a card
    without an index is card ``LOCAL_RANK`` (modulo the cards there are:
    processes share a card when there are more of them)."""
    from chandy_lamport_tpu_torch.parallel.batch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % max(torch.cuda.device_count(), 1))
    return dev


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None,
               backend: Optional[str] = None) -> bool:
    """Join this process to the job's process group (one call a process,
    before any collective). The arguments default from torch's env://
    variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``);
    ``coordinator_address`` is ``host:port`` or a URL. Returns True once
    a group is up (already, or now), False for the single-process no-op
    (no coordinator and no process count). ``backend``: None means NCCL
    for a process whose device (``process_device(device)``) is a card,
    gloo on the CPU."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    dev = process_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=url, world_size=num_processes, rank=process_id)
    return True


def hybrid_mesh(graph: int = 1, data_axis: str = "data",
                graph_axis: str = "graph", *, devices: Optional[int] = None,
                device=None):
    """2-D (data x graph) mesh, ``graph`` innermost. Under a process
    group: a dist mesh over every process, one device each (``device``:
    this process's, default ``process_device()``), ``graph`` dividing the
    processes on one host (``LOCAL_WORLD_SIZE``) so no graph group leaves
    a host. Without one: a stacked mesh on ``device`` over ``devices``
    positions (default: the cards, or 1 on the CPU), every shard on that
    device. The JAX refusals: ``graph`` must divide the device count and
    the per-host (per-process in JAX) device count (ValueError)."""
    import torch.distributed as dist

    from chandy_lamport_tpu_torch.parallel.mesh import Mesh, local_world_size

    if dist.is_initialized():
        count, local = dist.get_world_size(), local_world_size()
    else:
        count = devices if devices is not None else (
            torch.cuda.device_count() if torch.cuda.is_available()
            and (device is None or torch.device(device).type == "cuda")
            else 1)
        local = count
    if graph < 1 or count % graph:
        raise ValueError(f"graph={graph} must divide {count} devices")
    if local % graph:
        raise ValueError(
            f"graph={graph} must divide the {local} per-host devices so "
            f"graph collectives stay inside one host")
    shape = {data_axis: count // graph, graph_axis: graph}
    if dist.is_initialized():
        return Mesh(shape, backend="dist", device=process_device(device))
    return Mesh(shape, device=device)


def process_info() -> dict:
    """This process's rank and size and the device split (the JAX keys):
    one device a process under a process group (``local_devices``: the
    processes on this host), else every card of this process (1 on the
    CPU)."""
    import torch.distributed as dist

    from chandy_lamport_tpu_torch.parallel.mesh import local_world_size

    if dist.is_initialized():
        return {"process_index": dist.get_rank(),
                "process_count": dist.get_world_size(),
                "local_devices": local_world_size(),
                "global_devices": dist.get_world_size()}
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"process_index": 0, "process_count": 1,
            "local_devices": cards or 1, "global_devices": cards or 1}


def free_port() -> int:
    """A free loopback TCP port for a local coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv: List[str], world: int, *,
          env: Optional[dict] = None) -> list:
    """Start ``python *argv`` as ``world`` local processes of one job
    (env://: ``MASTER_ADDR``, ``MASTER_PORT`` (a free loopback port),
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), the
    package's root on their path; the processes, by rank
    (``collect`` waits for them)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = free_port()
    procs = []
    for rank in range(world):
        penv = dict(os.environ)
        penv.update(env or {})
        penv.update({
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "WORLD_SIZE": str(world), "RANK": str(rank),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "PYTHONPATH": root + os.pathsep + penv.get("PYTHONPATH", ""),
        })
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=penv, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    return procs


def collect(procs: list, timeout: float = 600.0) -> list:
    """Wait for a job's processes: [(returncode, stdout, stderr)] by
    rank; a process past ``timeout`` seconds is killed (returncode None),
    and every process is waited for."""
    out = []
    try:
        for p in procs:
            try:
                o, e = p.communicate(timeout=timeout)
                out.append((p.returncode, o.decode(errors="replace"),
                            e.decode(errors="replace")))
            except subprocess.TimeoutExpired:
                p.kill()
                o, e = p.communicate()
                out.append((None, o.decode(errors="replace"),
                            e.decode(errors="replace")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def launch(argv: List[str], world: int, *, timeout: float = 600.0,
           env: Optional[dict] = None) -> list:
    """``spawn`` a job and ``collect`` it."""
    return collect(spawn(argv, world, env=env), timeout)


def _agree(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _child(device: str) -> int:
    import torch.distributed as dist

    from chandy_lamport_tpu_torch.config import SimConfig
    from chandy_lamport_tpu_torch.models.workloads import (
        erdos_renyi,
        scale_free,
        staggered_snapshots,
        storm_program,
    )
    from chandy_lamport_tpu_torch.ops.delay import UniformDelay
    from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
    from chandy_lamport_tpu_torch.parallel.graphshard import (
        GraphShardedRunner,
    )
    from chandy_lamport_tpu_torch.utils.shardmap import psum_all

    dev = process_device(device)
    assert initialize(device=dev, backend="gloo"), "expected a group"
    info = process_info()
    assert info["process_count"] == 2 and info["global_devices"] == 2, info
    rank = info["process_index"]
    mesh = hybrid_mesh(graph=2, device=dev)
    assert mesh.shape == {"data": 1, "graph": 2}, mesh

    # a cross-process sum
    x = torch.full((4,), rank + 1, dtype=torch.int32, device=dev)
    assert int(psum_all(x, mesh).sum()) == 4 * (1 + 2)

    # the data-parallel aggregation: a storm per process, counters summed
    runner = BatchedRunner(scale_free(8, 2, seed=1, tokens=20),
                           SimConfig.for_workload(snapshots=2),
                           UniformDelay(seed=100 + rank), batch=2,
                           scheduler="sync", device=dev)
    prog = storm_program(runner.topo, phases=4, amount=1,
                         snapshot_phases=staggered_snapshots(
                             runner.topo, 2, 1, 1, max_phases=4))
    summary = BatchedRunner.summarize(
        runner.run_storm(runner.init_batch_device(), prog))
    assert summary["error_bits"] == 0, summary
    done = torch.tensor([summary["snapshots_completed"]], device=dev)
    global_done = int(psum_all(done, mesh)[0])
    assert global_done == 2 * summary["snapshots_completed"], global_done

    # (a) graph-only: one instance over both processes; sparse (drain at
    # megatick 2) and dense equal leaf for leaf, on every process
    gspec = erdos_renyi(16, 2.5, seed=13, tokens=40)
    gcfg = SimConfig(max_snapshots=4)
    finals, comm = {}, None
    for engine in ("sparse", "dense"):
        gs = GraphShardedRunner(gspec, gcfg, mesh, seed=3,
                                comm_engine=engine,
                                megatick=2 if engine == "sparse" else 1)
        gprog = storm_program(gs.topo, phases=4, amount=1,
                              snapshot_phases=staggered_snapshots(gs.topo, 2))
        finals[engine] = gs.run_storm(gs.init_state(), gprog.amounts,
                                      gprog.snap)
        if engine == "sparse":
            comm = gs.comm_model()
    same = torch.tensor([int(_agree(finals["sparse"], finals["dense"]))],
                        device=dev)
    engines_agree = int(psum_all(same, mesh)[0]) == 2
    assert engines_agree, "sparse/dense diverge across the processes"
    assert int(finals["sparse"].error) == 0
    assert int(finals["sparse"].completed[0]) == 16

    # (b) data x graph: lanes on both processes' shards, and (c) lanes
    # split over the processes, each holding a whole instance
    cspec = erdos_renyi(8, 2.5, seed=21, tokens=40)
    lanes = {}
    for name, m in (("graph2", mesh),
                    ("data2", hybrid_mesh(graph=1, device=dev))):
        cgs = GraphShardedRunner(cspec, SimConfig(max_snapshots=4), m,
                                 seed=5, comm_engine="sparse")
        cprog = storm_program(cgs.topo, phases=4, amount=1,
                              snapshot_phases=staggered_snapshots(
                                  cgs.topo, 2))
        cfinal = cgs.run_storm_batched(cgs.init_batch(4), cprog.amounts,
                                       cprog.snap)
        met = torch.tensor([int(cfinal.error.ne(0).sum()),
                            int(cfinal.completed[:, 0].sum())], device=dev)
        if name == "data2":     # each process holds a block of the lanes
            met = psum_all(met, m)
        lanes[name] = [int(v) for v in met]
    assert lanes["graph2"] == [0, 4 * 8], lanes
    assert lanes["data2"] == [0, 4 * 8], lanes
    print(json.dumps({"rank": rank, "global_snapshots_completed": global_done,
                      "graph_engines_agree": engines_agree,
                      "dp_graph_lanes": 4, "data_split_lanes": 4,
                      "comm_bytes_model": comm,
                      "staged_through_host": mesh.staged}), flush=True)
    dist.destroy_process_group()
    return 0


def case_spec(graph: str, nodes: int, phases: int):
    """The bench's graph for a case (``bench.py``: tokens phases + 10)."""
    from chandy_lamport_tpu_torch.models.workloads import (
        erdos_renyi,
        ring_topology,
        scale_free,
    )

    tokens = phases + 10
    if graph == "ring":
        return ring_topology(nodes, tokens=tokens)
    if graph == "er":
        return erdos_renyi(nodes, 3.0, seed=3, tokens=tokens)
    return scale_free(nodes, 2, seed=3, tokens=tokens)


def case_runner(args, mesh, engine: str):
    """The graph-sharded runner of a ``--case`` under ``engine`` and its
    storm program: the bench's graph and config
    (``SimConfig.for_workload``), the staggered snapshots of the JAX
    bench row."""
    from chandy_lamport_tpu_torch.config import SimConfig
    from chandy_lamport_tpu_torch.models.workloads import (
        staggered_snapshots,
        storm_program,
    )
    from chandy_lamport_tpu_torch.parallel.graphshard import (
        GraphShardedRunner,
    )

    cfg = SimConfig.for_workload(snapshots=args.snapshots,
                                 record_dtype="int16", split_markers=True)
    kw = ({"fixed_delay": args.fixed_delay} if args.fixed_delay
          else {"seed": args.seed})
    runner = GraphShardedRunner(case_spec(args.graph, args.nodes,
                                          args.phases), cfg, mesh,
                                comm_engine=engine,
                                megatick=args.megatick, **kw)
    prog = storm_program(runner.topo, phases=args.phases, amount=1,
                         snapshot_phases=staggered_snapshots(
                             runner.topo, args.snapshots, 1, 2,
                             max_phases=args.phases))
    return runner, prog


def _case(args) -> int:
    """One process of a ``--case`` run: the storm under each of
    ``--engine`` over a dist mesh of every process (graph = world size),
    this process's final shard written to ``--out``/rank<r>-<engine>.npz
    (numpy leaves, JAX dtypes); then one sum of the shards' balances
    across the processes (a collective of the group's backend on any
    world size). One JSON line."""
    import time

    import numpy as np
    import torch.distributed as dist

    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from chandy_lamport_tpu_torch.parallel.graphshard import state_to_numpy

    dev = process_device(args.device)
    initialize(device=dev, backend=args.backend)
    world = dist.get_world_size()
    mesh = hybrid_mesh(graph=world, device=dev)
    row = {"rank": mesh.rank, "world": world, "backend": dist.get_backend(),
           "device": str(dev), "staged_through_host": mesh.staged,
           "runs": []}
    for engine in args.engine:
        runner, prog = case_runner(args, mesh, engine)
        reset_launch_counts()
        t0 = time.perf_counter()
        final = runner.run_storm(runner.init_state(), prog.amounts,
                                 prog.snap)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        host = state_to_numpy(final)
        np.savez(os.path.join(args.out, f"rank{mesh.rank}-{engine}.npz"),
                 **{name: a for name, a in zip(type(host)._fields, host)})
        row["runs"].append({"engine": runner.comm_engine, "wall_s": wall,
                            "ticks": int(final.time),
                            "error": int(final.error),
                            "launches": launch_counts()})
    total = final.tokens.sum(dtype=torch.int64).reshape(1)
    if mesh.staged:
        total = total.cpu()
    dist.all_reduce(total)
    row["tokens_total"] = int(total)
    print(json.dumps(row), flush=True)
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default=None,
                    help="each process's device (default the card, both "
                         "processes on it, gloo staging through the "
                         "host; cpu for the plain versions)")
    ap.add_argument("--case", action="store_true",
                    help="as one process of a job: run one storm case "
                         "over a dist mesh of every process and write "
                         "this process's shard to --out")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--graph", default="er", choices=["ring", "er", "sf"])
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--phases", type=int, default=6)
    ap.add_argument("--snapshots", type=int, default=2)
    ap.add_argument("--engine", nargs="+", default=["sparse"],
                    choices=["auto", "dense", "sparse"])
    ap.add_argument("--megatick", type=int, default=1)
    ap.add_argument("--fixed-delay", type=int, default=0)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--out", default=".")
    args = ap.parse_args(argv)
    if args.case:
        return _case(args)
    if args.child:
        return _child(args.device)
    device = process_device(args.device).type
    results = launch(["-m", __spec__.name, "--child", "--device", device],
                     2, timeout=240)
    ok = all(rc == 0 for rc, _, _ in results)
    for rank, (rc, _, err) in enumerate(results):
        if rc != 0:
            sys.stderr.write(f"--- rank {rank} rc={rc}\n{err[-2000:]}\n")
    print(json.dumps({"ok": ok, "workers": [o.strip() for _, o, _ in
                                            results]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
