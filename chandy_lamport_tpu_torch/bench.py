"""The storm bench of the port: node-ticks per second on one card.

``python -m chandy_lamport_tpu_torch storm`` takes the JAX bench's flags
and defaults (the bench's config 4: the sync scheduler on scale-free 1024
nodes, 2048 lanes, 32 phases, 8 snapshots, hash delay, int16 log;
``--scheduler exact`` runs the bit-exact tick instead, in the cascade
form or, with ``--exact-impl wave``, the wave form), runs
one warm storm that doubles as the validity check — with the JAX bench's
doubling retry on queue or record overflow — then ``--repeats`` timed
storms, and prints one JSON row shaped like the JAX bench's row. Log lines
go to stderr. ``--megatick K`` runs the exact drain and flush in K-tick
megaticks (the fused megatick kernel on the card; the row stamps
``megatick``, ``fused_tick`` and ``fused_reason``, and the layout the
card takes, ``fused_tile`` and ``fused_tile_reason``: tiled into device
memory for a lane whose working set passes a block's shared memory, such
as config 5's SF-8k).

The exact scheduler takes the JAX storm CLI's fault adversary and
snapshot supervisor flags by their names (``--fault-*``, ``--crash-*``,
``--marker-fault-*``, ``--snapshot-*``, ``--quarantine``; quarantine is on
whenever a fault rate is set). With an armed adversary a row counts when
the conservation delta (fault skew subtracted) is 0, no bit other than
ERR_SNAPSHOT_TIMEOUT / ERR_FAULT_UNRECOVERED is set, every lane holding
one of those was quarantined (it stopped before the tick limit), and
every snapshot of a clean lane completed (the JAX rule, ``cli.py:309-314``).
They combine with ``--megatick K``: the faulted, supervised drain and
flush then run through the fused megatick too (the row's ``fused_tick``
says "on" on the card).
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
    ERR_FAULT_UNRECOVERED,
    ERR_QUEUE_OVERFLOW,
    ERR_RECORD_OVERFLOW,
    ERR_SNAPSHOT_TIMEOUT,
    decode_error_bits,
    decode_errors,
)
from chandy_lamport_tpu_torch.models.faults import Faults
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
from chandy_lamport_tpu_torch.utils.metrics import (
    conservation_delta,
    instance_footprint_bytes,
)

# the casualties an armed adversary is expected to cause (quarantined)
FAULT_BITS = ERR_SNAPSHOT_TIMEOUT | ERR_FAULT_UNRECOVERED


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
    p.add_argument("--exact-impl", choices=["cascade", "wave"],
                   default="cascade",
                   help="bit-exact tick formulation when --scheduler exact "
                        "(ops/tick.TickKernel): 'wave' serves every "
                        "destination's next marker in one host step; "
                        "bit-identical, and it needs --delay hash (fold is "
                        "not ported yet)")
    p.add_argument("--megatick", type=int, default=1,
                   help="K-tick megaticks for the exact drain and flush "
                        "(the JAX bench's default 1; the fused megatick "
                        "kernel on the card); bit-identical results")
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
    f = p.add_argument_group("fault adversary and snapshot supervisor "
                             "(--scheduler exact; the JAX storm CLI's flags)")
    for name, what in (("--fault-drop", "per-(edge, tick) token drop"),
                       ("--fault-dup", "per-(edge, tick) token duplicate"),
                       ("--fault-jitter", "per-(edge, tick) front stall"),
                       ("--fault-crash", "per-(node, window) crash"),
                       ("--marker-fault-drop", "per-(edge, tick) marker drop"),
                       ("--marker-fault-dup",
                        "per-(edge, tick) marker duplicate"),
                       ("--marker-fault-jitter",
                        "per-(edge, tick) marker front stall")):
        f.add_argument(name, type=float, default=0.0, metavar="R",
                       help=f"{what} probability")
    f.add_argument("--fault-seed", type=int, default=3,
                   help="adversary stream seed")
    f.add_argument("--crash-mode", choices=["pause", "lossy"],
                   default="pause",
                   help="pause: memory survives; lossy: restore from the "
                        "last completed snapshot, or ERR_FAULT_UNRECOVERED")
    f.add_argument("--crash-len", type=int, default=2,
                   help="crash window length in ticks")
    f.add_argument("--crash-period", type=int, default=32,
                   help="crash window cadence in ticks")
    f.add_argument("--snapshot-timeout", type=int, default=0, metavar="T",
                   help="abort and re-initiate a snapshot attempt not "
                        "complete within T ticks (deadline doubling per "
                        "retry); 0 = off")
    f.add_argument("--snapshot-retries", type=int, default=3,
                   help="re-initiations before ERR_SNAPSHOT_TIMEOUT")
    f.add_argument("--snapshot-every", type=int, default=0, metavar="K",
                   help="initiate a snapshot every K ticks (rotating "
                        "initiator) while slots remain; 0 = off")
    f.add_argument("--quarantine", action="store_true",
                   help="freeze a lane once its error bits fire (on "
                        "whenever a fault rate is set)")
    return p


def _faults(args):
    """The bench's fault program, or None when every rate is 0."""
    rates = (args.fault_drop, args.fault_dup, args.fault_jitter,
             args.fault_crash, args.marker_fault_drop, args.marker_fault_dup,
             args.marker_fault_jitter)
    if not any(rates):
        return None
    return Faults(args.fault_seed, drop_rate=args.fault_drop,
                  dup_rate=args.fault_dup, jitter_rate=args.fault_jitter,
                  crash_rate=args.fault_crash, crash_mode=args.crash_mode,
                  crash_len=args.crash_len, crash_period=args.crash_period,
                  marker_drop_rate=args.marker_fault_drop,
                  marker_dup_rate=args.marker_fault_dup,
                  marker_jitter_rate=args.marker_fault_jitter)


def _fault_verdict(final, runner, summary) -> dict:
    """The armed adversary's validity checks on a finished storm, and the
    row's fault fields (module docstring)."""
    err = final.error
    hit = err != 0
    clean = ~hit
    n = runner.topo.n
    done = final.started & (final.completed >= n)
    tokens0 = int(runner.topo.tokens0.sum()) * runner.batch
    delta = int(conservation_delta(final, runner.config, tokens0))
    checks = {
        "conservation_delta_zero": delta == 0,
        "only_fault_bits": not bool((err & ~FAULT_BITS).any()),
        "casualties_quarantined": runner.quarantine and not bool(
            (final.time[hit] >= runner.config.max_ticks).any()),
        "clean_lanes_complete": bool(
            (done == final.started)[clean].all()),
    }
    return {"conservation_delta": delta,
            "fault_events": summary["fault_events"],
            "fault_skew": summary["fault_skew"],
            "quarantined_lanes": int(hit.sum()),
            "fault_checks": checks}


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
                    for us, n, key in kernels]}))


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if (args.scheduler == "exact" and args.exact_impl == "wave"
            and args.delay != "hash"):
        parser.error("--exact-impl wave serves the delay draws by stream "
                     "position, which needs a position-addressable sampler:"
                     " use --delay hash")
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
                                 split_markers=args.scheduler == "sync",
                                 snapshot_timeout=args.snapshot_timeout,
                                 snapshot_retries=args.snapshot_retries,
                                 snapshot_every=args.snapshot_every)
    if args.capacity:
        cfg = dataclasses.replace(cfg, queue_capacity=args.capacity)
    faults = _faults(args)
    quarantine = args.quarantine or faults is not None
    allowed = FAULT_BITS if faults is not None else 0

    runner = summary = prog = verdict = None
    for cap_try in range(4):
        runner = BatchedRunner(spec, cfg, make_fast_delay(args.delay, 17),
                               batch=args.batch, scheduler=args.scheduler,
                               exact_impl=args.exact_impl, device=device,
                               faults=faults, quarantine=quarantine,
                               megatick=args.megatick)
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
        summary = BatchedRunner.summarize(final, runner)
        if faults is not None:
            verdict = _fault_verdict(final, runner, summary)
        del final
        log(f"summary: {summary}")
        bits = summary["error_bits"] & ~allowed
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
    if summary is None or summary["error_bits"] & ~allowed:
        log("ERROR: no clean warm run")
        return 1
    if verdict is not None:
        if not all(verdict["fault_checks"].values()):
            log(f"ERROR: the faulted run fails its checks: {verdict}")
            return 1
    elif summary["snapshots_completed"] != summary["snapshots_started"]:
        log("ERROR: incomplete snapshots")
        return 1

    topo = runner.topo
    times, node_ticks = [], []
    steps = "waves" if args.exact_impl == "wave" else "marker folds"
    for r in range(args.repeats):
        state = runner.init_batch_device()
        _sync(device)
        folds = runner.kernel.fold_steps
        drain_folds = runner.kernel.drain_fold_steps
        t0 = time.perf_counter()
        final = runner.run_storm(state, prog)
        _sync(device)
        dt = time.perf_counter() - t0
        folds = runner.kernel.fold_steps - folds
        drain_folds = runner.kernel.drain_fold_steps - drain_folds
        total_ticks = int(final.time.sum())
        # the batch ticks together until its slowest lane has drained
        batched_ticks = int(final.time.max())
        del state, final
        times.append(dt)
        node_ticks.append(total_ticks * topo.n)
        log(f"run {r}: {dt:.3f}s, {total_ticks} total ticks "
            f"({total_ticks / args.batch:.1f}/lane, {batched_ticks} batched "
            f"ticks at {dt / batched_ticks * 1e3:.2f}ms, {folds} host fold "
            f"steps ({steps}), {drain_folds} of them in the drain and "
            f"flush) -> {node_ticks[-1] / dt / 1e6:.3f}M node-ticks/s")
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
        "megatick": summary["megatick"],
        "fused_tick": summary["fused_tick"],
        "fused_reason": summary["fused_reason"],
        "fused_tile": summary["fused_tile"],
        "fused_tile_reason": summary["fused_tile_reason"],
        "error_bits": summary["error_bits"],
        "errors_decoded": summary["errors_decoded"],
        "straggler_waste": summary["straggler_waste"],
        "snapshot_lifecycle": summary["snapshot_lifecycle"],
    }
    if faults is not None:
        result.update(faults=faults.describe(), quarantine=quarantine,
                      snapshot_timeout=cfg.snapshot_timeout,
                      snapshot_retries=cfg.snapshot_retries,
                      snapshot_every=cfg.snapshot_every, **verdict)
    if device.type != "cuda":
        result["note"] = ("CPU run of the plain PyTorch versions; not a "
                          "device measurement")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
