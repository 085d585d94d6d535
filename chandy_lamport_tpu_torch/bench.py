"""The storm bench of the port: node-ticks per second on one card.

``python -m chandy_lamport_tpu_torch storm`` takes the JAX bench's flags
and defaults (the bench's config 4: the sync scheduler on scale-free 1024
nodes, 2048 lanes, 32 phases, 8 snapshots, hash delay, int16 log;
``--scheduler exact`` runs the bit-exact cascade tick instead), runs
one warm storm that doubles as the validity check — with the JAX bench's
doubling retry on queue or record overflow — then ``--repeats`` timed
storms, and prints one JSON row shaped like the JAX bench's row. Log lines
go to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.state import (
    ERR_QUEUE_OVERFLOW,
    ERR_RECORD_OVERFLOW,
    decode_error_bits,
    decode_errors,
)
from chandy_lamport_tpu_torch.models.workloads import (
    erdos_renyi,
    ring_topology,
    scale_free,
    staggered_snapshots,
    storm_program,
)
from chandy_lamport_tpu_torch.ops.delay import make_fast_delay
from chandy_lamport_tpu_torch.parallel.batch import (
    BatchedRunner,
    resolve_device,
)
from chandy_lamport_tpu_torch.utils.metrics import instance_footprint_bytes


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m chandy_lamport_tpu_torch "
                                     "storm")
    p.add_argument("--nodes", type=int, default=1024)
    p.add_argument("--graph", choices=["sf", "ring", "er"], default="sf",
                   help="topology family: scale-free (config 4), ring "
                        "(config 2), Erdős–Rényi avg-degree 3 (config 3)")
    p.add_argument("--attach", type=int, default=2,
                   help="scale-free out-arcs per node")
    p.add_argument("--batch", type=int, default=2048, help="lanes")
    p.add_argument("--phases", type=int, default=32,
                   help="storm phases (ticks with traffic)")
    p.add_argument("--snapshots", type=int, default=8,
                   help="concurrent initiators per instance")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--scheduler", choices=["sync", "exact"], default="sync",
                   help="sync = simultaneous delivery (the production "
                        "path); exact = the reference's sequential fold")
    p.add_argument("--exact-impl", choices=["cascade"], default="cascade",
                   help="bit-exact tick formulation when --scheduler exact "
                        "(wave and fold are not ported yet)")
    p.add_argument("--capacity", type=int, default=0,
                   help="per-edge queue slots; 0 = size to the workload")
    p.add_argument("--max-recorded", type=int, default=0,
                   help="per-edge log slots L (0 = derived)")
    p.add_argument("--record-dtype", choices=["int16", "int32"],
                   default="int16")
    p.add_argument("--window-dtype", choices=["uint16", "int32"],
                   default="int32",
                   help="uint16 is not ported yet (SimConfig raises)")
    p.add_argument("--delay", choices=["uniform", "hash"], default="hash",
                   help="'uniform' is not ported yet")
    p.add_argument("--target", type=float, default=10e6,
                   help="north-star node-ticks/s/chip")
    p.add_argument("--profile", metavar="PATH", default=None,
                   help="after the timed runs, profile one more storm with "
                        "torch.profiler: Chrome trace JSON to PATH, the "
                        "kernels by device time as one JSON line on stderr")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain versions and is no device measurement)")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(runner, prog, device, path: str) -> None:
    """One extra storm under torch.profiler (not among the timed runs):
    the trace goes to ``path``; the device time of each kernel, their sum
    and the busy share of the run's wall time go to stderr as JSON."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    state = runner.init_batch_device()
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.run_storm(state, prog)
        _sync(device)
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    kernels = [(getattr(evt, "self_device_time_total", 0), evt.count,
                evt.key) for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    log(json.dumps({
        "profile": path, "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernels": [{"name": key[:120], "calls": n, "device_ms": us / 1e3,
                     "share": us / busy_us if busy_us else 0.0}
                    for us, n, key in kernels[:25]]}))


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    tokens = args.phases + 10
    if args.graph == "ring":
        spec = ring_topology(args.nodes, tokens=tokens)
    elif args.graph == "er":
        spec = erdos_renyi(args.nodes, 3.0, seed=3, tokens=tokens)
    else:
        spec = scale_free(args.nodes, args.attach, seed=3, tokens=tokens)
    cfg = SimConfig.for_workload(snapshots=args.snapshots,
                                 max_recorded=args.max_recorded,
                                 record_dtype=args.record_dtype,
                                 window_dtype=args.window_dtype,
                                 split_markers=args.scheduler == "sync")
    if args.capacity:
        cfg = dataclasses.replace(cfg, queue_capacity=args.capacity)

    runner = summary = prog = None
    for cap_try in range(4):
        runner = BatchedRunner(spec, cfg, make_fast_delay(args.delay, 17),
                               batch=args.batch, scheduler=args.scheduler,
                               exact_impl=args.exact_impl, device=device)
        topo = runner.topo
        log(f"graph: {topo.n} nodes, {topo.e} edges, max out-degree "
            f"{topo.d}; queue_capacity={cfg.queue_capacity}")
        per = instance_footprint_bytes(topo.n, topo.e, cfg)
        log(f"per-instance state: {per / 1e6:.3f} MB; batch resident "
            f"{per * args.batch / 1e9:.2f} GB")
        prog = storm_program(
            topo, phases=args.phases, amount=1,
            snapshot_phases=staggered_snapshots(topo, args.snapshots, 1, 2,
                                                max_phases=args.phases))
        t0 = time.perf_counter()
        try:
            final = runner.run_storm(runner.init_batch_device(), prog)
            _sync(device)
        except torch.cuda.OutOfMemoryError:
            if args.batch <= 1:
                raise
            summary = None
            args.batch //= 2
            log(f"device OOM; retrying with batch={args.batch}")
            continue
        log(f"warm run: {time.perf_counter() - t0:.1f}s")
        summary = BatchedRunner.summarize(final)
        del final
        log(f"summary: {summary}")
        bits = summary["error_bits"]
        if not bits:
            break
        for name, msg in zip(decode_error_bits(bits), decode_errors(bits)):
            log(f"error bit {name}: {msg}")
        recoverable = ERR_QUEUE_OVERFLOW | ERR_RECORD_OVERFLOW
        if (bits & ~recoverable) or cap_try == 3:
            log("ERROR: lanes with error flags — results invalid")
            return 1
        if bits & ERR_QUEUE_OVERFLOW:
            cfg = dataclasses.replace(cfg,
                                      queue_capacity=2 * cfg.queue_capacity)
        if bits & ERR_RECORD_OVERFLOW:
            cfg = dataclasses.replace(cfg, max_recorded=2 * cfg.max_recorded)
        log(f"retrying with queue_capacity={cfg.queue_capacity}, "
            f"max_recorded={cfg.max_recorded}")
    if summary is None or summary["error_bits"]:
        log("ERROR: no clean warm run")
        return 1
    if summary["snapshots_completed"] != summary["snapshots_started"]:
        log("ERROR: incomplete snapshots")
        return 1

    topo = runner.topo
    times, node_ticks = [], []
    for r in range(args.repeats):
        state = runner.init_batch_device()
        _sync(device)
        folds = runner.kernel.fold_steps
        t0 = time.perf_counter()
        final = runner.run_storm(state, prog)
        _sync(device)
        dt = time.perf_counter() - t0
        folds = runner.kernel.fold_steps - folds
        total_ticks = int(final.time.sum())
        # the batch ticks together until its slowest lane has drained
        batched_ticks = int(final.time.max())
        del state, final
        times.append(dt)
        node_ticks.append(total_ticks * topo.n)
        log(f"run {r}: {dt:.3f}s, {total_ticks} total ticks "
            f"({total_ticks / args.batch:.1f}/lane, {batched_ticks} batched "
            f"ticks at {dt / batched_ticks * 1e3:.2f}ms, {folds} marker-fold "
            f"steps) -> {node_ticks[-1] / dt / 1e6:.3f}M node-ticks/s")
    best = max(nt / dt for nt, dt in zip(node_ticks, times))
    if args.profile:
        _profile(runner, prog, device, args.profile)
    result = {
        "metric": "node_ticks_per_sec_per_chip",
        "value": best,
        "unit": "node-ticks/s/chip",
        "vs_baseline": best / args.target,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "scheduler": (args.scheduler if args.scheduler == "sync"
                      else f"exact/{args.exact_impl}"),
        "graph": args.graph,
        "nodes": args.nodes,
        "batch": args.batch,
        "phases": args.phases,
        "repeats": args.repeats,
        "queue_capacity": cfg.queue_capacity,
        "record_dtype": cfg.record_dtype,
        "max_recorded": cfg.max_recorded,
        "delay": args.delay,
        "error_bits": summary["error_bits"],
        "errors_decoded": summary["errors_decoded"],
        "straggler_waste": summary["straggler_waste"],
        "snapshot_lifecycle": summary["snapshot_lifecycle"],
    }
    if device.type != "cuda":
        result["note"] = ("CPU run of the plain PyTorch versions; not a "
                          "device measurement")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
