"""The storm bench of the port: node-ticks per second on one card.

``python -m chandy_lamport_tpu_torch bench`` takes the JAX bench's flags
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

Either scheduler takes the JAX storm CLI's fault adversary and
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

``--graphshard K`` measures the graph-sharded runner instead (the JAX
bench's ``--graphshard`` row, ``bench.py:1382``): one giant instance of
the same storm over K shards, stacked on the card, or one shard a
process when ``parallel/multihost.initialize()`` finds a process group;
``--comm-engine`` picks the exchange and ``--megatick`` the drain's
blocks. The row carries the JAX row's fields (``comm_bytes_model``,
``per_tick_ms``, the doubling retry) plus ``backend`` and ``devices``,
the devices ``node_ticks_per_sec_per_chip`` divides by.

``--stream`` measures the streaming job engine instead (the JAX bench's
``--stream`` row, ``bench.py:871``): a heavy-tailed queue of ``--jobs``
jobs (``stream_jobs(seed=17, base_phases=4, tail_alpha=1.1,
max_phases=max(--phases, 8))``) driven through the ``--batch`` lane slots
by ``BatchedRunner.run_stream``, once with continuous admission and once
with gang admission (the static-batching baseline on the same engine).
One warm drive of each doubles as the check that every job retired with
no error bit; then ``--repeats`` timed drives of each, and one row:
``stream_jobs_per_sec``, ``jobs_per_sec_gang``, ``speedup_vs_static``,
occupancy, refills and steps of both, and the host fold steps of the
exact tick. At ``--megatick`` K > 1 on the exact scheduler the drain
slices and flush passes run through the fused megatick kernel.
``--memo {admit,full,prefix}`` adds the memo plane's arm (the JAX bench's,
``bench.py:913-1060``): every arm drives the same content-keyed pool (the
memo runner packs it), the memo arm's served rows must equal the off
arm's rows, and the row gains ``effective_jobs_per_sec`` (jobs served a
second), ``memo_speedup`` over the off arm, the memo books and the host
seconds of the memo stages (``memo_timing``); under ``prefix`` also a
``full`` arm on the same pool and ``prefix_speedup`` over it, with the
fork books and the prefix bank's rows and bytes.

``--serve`` measures the serving front-end instead (the JAX bench's
``--serve`` row, ``bench.py:1132``): a seeded Poisson/Zipf schedule of
``--jobs`` requests (0 = 3x ``--batch``) at ``--rate`` per stream step
over ``--tenants`` tenants and ``--priorities`` classes, served by
``serving.serve_run`` under ``--serve-policy``. A cold pass through a
fresh ``ExecutableCache`` over an empty directory doubles as the check
(no errored job, every accepted request served); ``--repeats`` warm
passes, each a fresh runner and a fresh cache over the same directory
(a restarted server: ``warmup_warm_source`` says "disk"), then one fifo
pass at the same schedule. The row: ``serve_effective_jobs_per_sec``
(served requests over the best warm pass's loop wall), occupancy, admit
p50/p99, deadline misses, the memo books, the cold and warm warmups, and
the fifo baseline's misses, p99 and occupancy.

``--fleet N`` measures the serving fleet instead (the JAX bench's
``--fleet`` row, ``bench.py:1278``; ``--graph ring`` only, since the
workers rebuild a ring-stream engine from a picklable recipe): the
``--serve`` schedule of ``--jobs`` requests (0 = 3x ``--batch``;
``max_phases=max(--phases, 4)``, seed 17) admitted into a fresh
write-ahead spool and served by N spawned workers on the card
(``serving.fleet_run``), each cold request run alone through
``run_stream``, duplicates answered from the shared summary cache.
``--fleet-crashes K`` SIGKILLs a live worker K times (at 4 s, then every
2 s); ``--fleet-lease-ttl`` is the lease expiry. The row:
``fleet_served_jobs_per_sec`` with goodput, latency p50/p99/max, the
takeover/restart books and the spool audit; exit 1 on a timed-out run
or an audit with a lost or double-served request.

The storm, stream and serve rows carry ``cost_model``
(``utils/metrics.tick_cost_model`` at the row's shape with the runner's
queue engine), as the JAX rows do.

``--trace`` (or ``--trace-capacity K``) arms the flight recorder
(utils/tracing.py) for the measured runs, as the JAX bench's ``--trace``
does: the storm row gains ``trace_capacity``, ``trace_events``,
``trace_dropped`` and ``trace_overhead_pct``, the traced rate against one
untraced storm of the same arguments run after it (negative values are
noise, not a speedup), with ``untraced_node_ticks_per_sec``; the stream
row gains the first three (the rings of the last stream drive). At
megatick K > 1 on the card the traced drain runs the fused megatick's
recorder arm.
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
    stream_jobs,
)
from chandy_lamport_tpu_torch.ops.delay import make_fast_delay
from chandy_lamport_tpu_torch.parallel.batch import (
    BatchedRunner,
    resolve_device,
)
from chandy_lamport_tpu_torch.utils.metrics import (
    conservation_delta,
    instance_footprint_bytes,
    tick_cost_model,
)
from chandy_lamport_tpu_torch.utils.tracing import Trace, trace_counts

# the casualties an armed adversary is expected to cause (quarantined)
FAULT_BITS = ERR_SNAPSHOT_TIMEOUT | ERR_FAULT_UNRECOVERED


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m chandy_lamport_tpu_torch "
                                     "bench")
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
    p.add_argument("--exact-impl", choices=["cascade", "wave", "fold"],
                   default="cascade",
                   help="bit-exact tick formulation when --scheduler exact "
                        "(ops/tick.TickKernel): 'wave' serves every "
                        "destination's next marker in one host step and "
                        "needs --delay hash; 'fold' steps the sources one "
                        "by one, the reference-literal form (no faults, no "
                        "supervisor); bit-identical")
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
                   help="uint16: the window counters modulo 2^16")
    p.add_argument("--delay", choices=["uniform", "hash"], default="hash",
                   help="'uniform': the threefry stream of jax.random; "
                        "'hash': the counter hash")
    p.add_argument("--target", type=float, default=10e6,
                   help="north-star node-ticks/s/chip")
    p.add_argument("--profile", metavar="PATH", default=None,
                   help="after the timed runs, profile one more storm with "
                        "torch.profiler: Chrome trace JSON to PATH, the "
                        "kernels by device time as one JSON line on stderr")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain versions and is no device measurement)")
    p.add_argument("--trace", action="store_true",
                   help="arm the flight recorder (utils/tracing.py) during "
                        "the measurement; the row gains trace_capacity/"
                        "trace_events/trace_dropped and, for the storm, a "
                        "trace_overhead_pct against one untraced storm of "
                        "the same arguments")
    p.add_argument("--trace-capacity", type=int, default=0, metavar="K",
                   help="ring slots per lane (0 = Trace's default when "
                        "--trace is set); implies --trace when > 0")
    g = p.add_argument_group("graph sharding (the JAX bench's "
                             "--graphshard row)")
    g.add_argument("--graphshard", type=int, default=0, metavar="K",
                   help="measure the graph-sharded runner (one giant "
                        "instance split over K shards, parallel/"
                        "graphshard.py) instead of the batched runner: "
                        "stacked on the device, or one shard a process "
                        "under a process group (parallel/multihost); "
                        "--batch is ignored (B=1). Node count must divide "
                        "by K")
    g.add_argument("--comm-engine", choices=["auto", "dense", "sparse"],
                   default="auto",
                   help="--graphshard only: the cross-shard exchange, "
                        "'dense' (whole planes summed across the shards) "
                        "or 'sparse' (the boundary halo exchange); 'auto' "
                        "= sparse. Equal results; the row records the "
                        "resolved engine and comm_bytes_model. --megatick "
                        "K runs the drain in K-tick blocks")
    q = p.add_argument_group("the streaming job engine (the JAX bench's "
                             "--stream row)")
    q.add_argument("--stream", action="store_true",
                   help="measure BatchedRunner.run_stream instead of the "
                        "storm: a heavy-tailed queue of --jobs jobs through "
                        "--batch lane slots, jobs/s with the gang-admission "
                        "(static-batching) baseline in the same row")
    q.add_argument("--jobs", type=int, default=0,
                   help="--stream: queue length (0 = 3x --batch)")
    q.add_argument("--stretch", type=int, default=4,
                   help="--stream: script substeps per stream step")
    q.add_argument("--drain-chunk", type=int, default=32,
                   help="--stream: drain ticks per stream step")
    q.add_argument("--dup-rate", type=float, default=0.0, metavar="R",
                   help="--stream: fraction of the queue that repeats a "
                        "Zipf-drawn library job byte for byte "
                        "(models/workloads.stream_jobs dup_rate)")
    q.add_argument("--prefix-overlap", type=float, default=0.0, metavar="R",
                   help="--stream: fraction of the queue that extends a "
                        "Zipf-drawn library job with a distinguishing tail "
                        "(stream_jobs prefix_overlap; excludes --dup-rate)")
    q.add_argument("--memo", choices=["off", "admit", "full", "prefix"],
                   default="off",
                   help="--stream: also drive the queue through the memo "
                        "plane at this level and report effective jobs/s "
                        "(served = executed + coalesced + cached) against "
                        "the memo-off arm on the same content-keyed pool; "
                        "'prefix' adds a 'full' arm for prefix_speedup")
    z = p.add_argument_group("the serving front-end (the JAX bench's "
                             "--serve row)")
    z.add_argument("--serve", action="store_true",
                   help="measure serving.serve_run instead of the storm: a "
                        "seeded Poisson/Zipf schedule of --jobs requests at "
                        "--rate per step, effective jobs/s with occupancy, "
                        "admit p50/p99, deadline misses and the cold and "
                        "warm warmups in one row")
    z.add_argument("--serve-policy", choices=["edf", "fifo"], default="edf",
                   help="--serve: admission ordering (config.ENGINE_KNOBS "
                        "serve_policy); the row also carries the fifo "
                        "baseline at the same schedule")
    z.add_argument("--rate", type=float, default=2.0,
                   help="--serve: open-loop Poisson arrival rate "
                        "(requests per stream step)")
    z.add_argument("--tenants", type=int, default=4,
                   help="--serve: Zipf-weighted tenant population")
    z.add_argument("--priorities", type=int, default=2,
                   help="--serve: priority classes")
    w = p.add_argument_group("the serving fleet (the JAX bench's --fleet "
                             "row)")
    w.add_argument("--fleet", type=int, default=0, metavar="N",
                   help="measure serving.fleet_run instead of the storm: N "
                        "spawned workers on the card over one write-ahead "
                        "spool serving --jobs requests at the --rate/"
                        "--tenants/--priorities schedule; served jobs/s "
                        "with goodput, latency percentiles and the spool "
                        "audit in one row; requires --graph ring")
    w.add_argument("--fleet-crashes", type=int, default=0, metavar="K",
                   help="--fleet: SIGKILL a live worker K times on a fixed "
                        "schedule mid-run (the degraded-mode row)")
    w.add_argument("--fleet-lease-ttl", type=float, default=4.0,
                   help="--fleet: lease expiry (s) before a silent "
                        "worker's in-flight requests are redelivered")
    f = p.add_argument_group("fault adversary and snapshot supervisor "
                             "(the JAX storm CLI's flags)")
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


def _profile(run, device, path: str) -> None:
    """One extra run (``run()``: a storm or a stream drive, not among the
    timed runs) under torch.profiler: the trace goes to ``path``; the
    device time of each kernel, their sum and the busy share of the run's
    wall time go to stderr as JSON."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
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


def job_rows(runner, stream) -> list:
    """A stream's per-job rows without ``admit_step``, the one field that
    depends on the admission mode."""
    return [{k: v for k, v in row.items() if k != "admit_step"}
            for row in runner.stream_results(stream)]


def _trace(args):
    """The bench's flight recorder, or None without ``--trace`` /
    ``--trace-capacity``."""
    if args.trace or args.trace_capacity:
        return Trace(capacity=args.trace_capacity)
    return None


def run_graphshard_worker(args, device, spec, cfg) -> int:
    """``--graphshard K`` (the JAX bench's row, ``bench.py:1382``): one
    giant instance over K shards with the per-shard threefry streams
    (seed 17), the storm of the batched row; a warm run doubles as the
    check (doubling queue and record capacity on their overflow bits,
    as JAX does), then ``--repeats`` timed runs. The mesh is dist when
    ``multihost.initialize()`` finds a process group (K must be its
    size; only rank 0 prints), stacked on ``device`` otherwise.
    ``node_ticks_per_sec_per_chip`` divides by the devices the shards
    occupy: 1 stacked, the world size dist."""
    from chandy_lamport_tpu_torch.parallel import multihost
    from chandy_lamport_tpu_torch.parallel.graphshard import (
        GraphShardedRunner,
    )
    from chandy_lamport_tpu_torch.parallel.mesh import Mesh

    k = args.graphshard
    if args.nodes % k:
        log(f"--nodes {args.nodes} not divisible by {k} shards")
        return 1
    if multihost.initialize(device=device):
        mesh = multihost.hybrid_mesh(graph=k, device=device)
        devices = mesh.world
    else:
        mesh = Mesh({"graph": k}, device=device)
        devices = 1

    def make(cfg):
        return GraphShardedRunner(spec, cfg, mesh, seed=17,
                                  comm_engine=args.comm_engine,
                                  megatick=args.megatick)

    runner = make(cfg)
    topo = runner.topo
    log(f"graphshard: {topo.n} nodes / {k} shards ({runner.nl} nodes, "
        f"{runner.em} edge slots a shard), {topo.e} edges, "
        f"{mesh.backend} mesh on {device}")
    prog = storm_program(
        topo, phases=args.phases, amount=1,
        snapshot_phases=staggered_snapshots(topo, args.snapshots, 1, 2,
                                            max_phases=args.phases))
    recoverable = ERR_QUEUE_OVERFLOW | ERR_RECORD_OVERFLOW
    for cap_try in range(3):
        t0 = time.perf_counter()
        final = runner.run_storm(runner.init_state(), prog.amounts,
                                 prog.snap)
        _sync(device)
        log(f"warm run: {time.perf_counter() - t0:.1f}s")
        bits = int(final.error)
        del final
        if not bits:
            break
        for name, msg in zip(decode_error_bits(bits), decode_errors(bits)):
            log(f"error bit {name}: {msg}")
        if (bits & ~recoverable) or cap_try == 2:
            log("ERROR: error flags — results invalid")
            return 1
        cfg = dataclasses.replace(cfg, queue_capacity=2 * cfg.queue_capacity,
                                  max_recorded=2 * cfg.max_recorded)
        log(f"retrying with queue_capacity={cfg.queue_capacity}, "
            f"max_recorded={cfg.max_recorded}")
        runner = make(cfg)
    times, ticks_seen, mem = [], [], {}
    for r in range(args.repeats):
        state = runner.init_state()
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        final = runner.run_storm(state, prog.amounts, prog.snap)
        _sync(device)
        dt = time.perf_counter() - t0
        ticks = int(final.time)
        if device.type == "cuda" and r == args.repeats - 1:
            mem = {"peak_allocated_bytes":
                   int(torch.cuda.max_memory_allocated(device))}
        del state, final
        times.append(dt)
        ticks_seen.append(ticks)
        log(f"run {r}: {dt:.3f}s, {ticks} ticks ({dt / ticks * 1e3:.2f}ms "
            f"a tick) -> {ticks * topo.n / dt / 1e6:.3f}M node-ticks/s")
    best = max(t * topo.n / dt for t, dt in zip(ticks_seen, times))
    per_chip = best / devices
    if args.profile:
        state = runner.init_state()
        _profile(lambda: runner.run_storm(state, prog.amounts, prog.snap),
                 device, args.profile)
    result = {
        "metric": "node_ticks_per_sec_per_chip",
        "value": per_chip,
        "unit": "node-ticks/s/chip",
        "vs_baseline": per_chip / args.target,
        "value_aggregate": best,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "scheduler": "sync",
        "queue_engine": runner.queue_engine,
        "kernel_engine": runner.kernel_engine,
        "fused_tick": runner.fused,
        "fused_tile": runner.fused_tile,
        "fused_emulated": False,
        "comm_engine": runner.comm_engine,
        "megatick": runner.megatick,
        "comm_bytes_model": runner.comm_model(),
        "mode": "graphshard",
        "graphshard": k,
        "backend": mesh.backend,
        "devices": devices,
        "staged_through_host": mesh.staged,
        "graph": args.graph,
        "nodes": args.nodes,
        "edges": topo.e,
        "batch": 1,
        "phases": args.phases,
        "repeats": args.repeats,
        "queue_capacity": runner.config.queue_capacity,
        "record_dtype": runner.config.record_dtype,
        "max_recorded": runner.config.max_recorded,
        "per_tick_ms": times[-1] / ticks_seen[-1] * 1e3,
        "error_bits": bits,
        "errors_decoded": decode_error_bits(bits),
        "straggler_waste": 0.0,
    }
    result.update(mem)
    result["note"] = (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else
                      "CPU run of the plain PyTorch versions; not a "
                      "device measurement")
    if mesh.rank == 0:
        print(json.dumps(result), flush=True)
    return 0


def run_stream_worker(args, device, spec, cfg) -> int:
    """``--stream`` (module docstring): the JAX bench's stream row on the
    port. Returns the exit code."""
    trace = _trace(args)

    def make(memo="off"):
        return BatchedRunner(spec, cfg, make_fast_delay(args.delay, 17),
                             batch=args.batch, scheduler=args.scheduler,
                             exact_impl=args.exact_impl, device=device,
                             megatick=args.megatick, trace=trace, memo=memo)

    runner = make()
    jcount = args.jobs or 3 * args.batch
    jobs = stream_jobs(spec, jcount, seed=17, base_phases=4, tail_alpha=1.1,
                       max_phases=max(args.phases, 8),
                       dup_rate=args.dup_rate,
                       prefix_overlap=args.prefix_overlap)
    # every arm runs the pool the memo runner packs (under "prefix" its
    # identities are keyed on the first phase), so the arms differ in the
    # memo plane alone
    memo_runner = make(args.memo) if args.memo != "off" else None
    pool = (memo_runner or runner).pack_jobs(jobs)
    per = instance_footprint_bytes(runner.topo.n, runner.topo.e, cfg)
    log(f"stream: {jcount} jobs over {args.batch} slots, pooled phase "
        f"table {pool.do_tick.shape[0]} rows, stretch={args.stretch}, "
        f"drain_chunk={args.drain_chunk}, dup_rate={args.dup_rate}, "
        f"prefix_overlap={args.prefix_overlap}; graph {runner.topo.n} "
        f"nodes, {runner.topo.e} edges; lane state "
        f"{per * args.batch / 1e9:.2f} GB")
    kern = runner.kernel

    def drive(admission):
        folds, drain_folds = kern.fold_steps, kern.drain_fold_steps
        _sync(device)
        t0 = time.perf_counter()
        state, stream = runner.run_stream(
            pool, stretch=args.stretch, drain_chunk=args.drain_chunk,
            admission=admission)
        _sync(device)
        return (time.perf_counter() - t0, state, stream,
                kern.fold_steps - folds, kern.drain_fold_steps - drain_folds)

    t0 = time.perf_counter()
    _, _, stream_w, _, _ = drive("stream")
    _, _, gang_w, _, _ = drive("gang")
    log(f"warm drives (stream, gang): {time.perf_counter() - t0:.1f}s")
    for name, stream in (("stream", stream_w), ("gang", gang_w)):
        bad = [r for r in runner.stream_results(stream) if r["error"]]
        if bad:
            log(f"ERROR: {len(bad)} jobs of the {name} drive retired with "
                f"error bits (first: {bad[0]}): results invalid")
            return 1
        if runner.summarize_stream(stream)["jobs_done"] != jcount:
            log(f"ERROR: the {name} drive did not retire every job")
            return 1
    if job_rows(runner, stream_w) != job_rows(runner, gang_w):
        log("ERROR: stream and gang admission gave different job rows")
        return 1
    best, summaries, folds, finals = {}, {}, {}, {}
    for admission in ("stream", "gang"):
        times = []
        for r in range(args.repeats):
            dt, finals[admission], stream, f, df = drive(admission)
            times.append(dt)
            log(f"{admission} run {r}: {dt:.3f}s -> {jcount / dt:.1f} "
                f"jobs/s, {f} host fold steps ({df} in the drain slices "
                f"and flushes)")
        best[admission] = jcount / min(times)
        summaries[admission] = runner.summarize_stream(stream)
        folds[admission] = (f, df)
    if args.profile:
        _profile(lambda: runner.run_stream(
            pool, stretch=args.stretch, drain_chunk=args.drain_chunk),
            device, args.profile)
    ss, sg = summaries["stream"], summaries["gang"]
    result = {
        "metric": "stream_jobs_per_sec",
        "value": best["stream"],
        "unit": "jobs/s",
        "jobs_per_sec_gang": best["gang"],
        "speedup_vs_static": best["stream"] / best["gang"],
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "scheduler": (args.scheduler if args.scheduler == "sync"
                      else f"exact/{args.exact_impl}"),
        "megatick": runner.megatick,
        "fused_tick": runner.fused,
        "fused_reason": runner.fused_reason,
        "fused_tile": runner.fused_tile,
        "graph": args.graph,
        "nodes": args.nodes,
        "batch": args.batch,
        "jobs": jcount,
        "stretch": args.stretch,
        "drain_chunk": args.drain_chunk,
        "repeats": args.repeats,
        "delay": args.delay,
        "occupancy": ss["occupancy"],
        "occupancy_gang": sg["occupancy"],
        "refills": ss["refills"],
        "refills_gang": sg["refills"],
        "straggler_wasted_steps": ss["straggler_wasted_steps"],
        "straggler_wasted_steps_gang": sg["straggler_wasted_steps"],
        "stream_steps": ss["steps"],
        "gang_steps": sg["steps"],
        "host_fold_steps": folds["stream"][0],
        "host_fold_steps_gang": folds["gang"][0],
        "drain_host_fold_steps": folds["stream"][1],
        "drain_host_fold_steps_gang": folds["gang"][1],
        "dup_rate": args.dup_rate,
        "prefix_overlap": args.prefix_overlap,
    }
    if trace is not None:
        recorded, dropped = trace_counts(finals["stream"])
        result.update(trace_capacity=runner.config.trace_capacity,
                      trace_events=recorded, trace_dropped=dropped)
    result["cost_model"] = tick_cost_model(
        runner.topo.n, runner.topo.e, cfg, batch=args.batch,
        queue_engine=runner.queue_engine)
    result["memo"] = args.memo
    result["effective_jobs_per_sec"] = best["stream"]
    if memo_runner is not None:
        bad = memo_arms(args, device, make, memo_runner, pool,
                        job_rows(runner, stream_w), best["stream"], result)
        if bad:
            log(f"ERROR: {bad}")
            return 1
    if device.type != "cuda":
        result["note"] = ("CPU run of the plain PyTorch versions; not a "
                          "device measurement")
    print(json.dumps(result), flush=True)
    return 0


def run_serve_worker(args, device, spec, cfg) -> int:
    """``--serve`` (module docstring): the JAX bench's serve row on the
    port. Returns the exit code."""
    import shutil
    import tempfile

    from chandy_lamport_tpu_torch.models.workloads import serve_workload
    from chandy_lamport_tpu_torch.serving import ExecutableCache, serve_run

    rcount = args.jobs or 3 * args.batch
    requests = serve_workload(spec, rcount, seed=17, rate=args.rate,
                              tenants=args.tenants,
                              priorities=args.priorities,
                              dup_rate=args.dup_rate,
                              max_phases=max(args.phases, 8))
    log(f"serve: {rcount} requests over {args.batch} slots at rate "
        f"{args.rate}/step, tenants={args.tenants}, "
        f"dup_rate={args.dup_rate}, policy={args.serve_policy}")

    def make():
        return BatchedRunner(spec, cfg, make_fast_delay(args.delay, 17),
                             batch=args.batch, scheduler=args.scheduler,
                             exact_impl=args.exact_impl, device=device,
                             megatick=args.megatick)

    cache_dir = tempfile.mkdtemp(prefix="clsim-serve-exec-")

    def drive(policy):
        runner = make()
        cache = ExecutableCache(cache_dir)
        _, stream, report = serve_run(runner, requests, policy=policy,
                                      stretch=args.stretch,
                                      drain_chunk=args.drain_chunk,
                                      exec_cache=cache)
        _sync(device)
        report["warmup_builds"] = (cache.last or {}).get("builds", 0)
        return runner, report, runner.stream_results(stream)

    try:
        # the cold pass: an empty cache directory; the check
        runner, rep_cold, rows = drive(args.serve_policy)
        bad = [r for r in rows if r["error"]]
        if bad:
            log(f"ERROR: {len(bad)} requests retired with error bits "
                f"(first: {bad[0]}): results invalid")
            return 1
        if len(rows) != rcount - rep_cold["refused_total"]:
            log("ERROR: the serve drive did not serve every accepted "
                "request")
            return 1
        log(f"cold: warmup {rep_cold['warmup_s']:.3f}s "
            f"({rep_cold['warmup_source']}, {rep_cold['warmup_builds']} "
            f"nvcc runs), serve wall {rep_cold['wall_s']:.2f}s")
        # warm passes: a restarted server each (a fresh runner and cache
        # over the same directory), so "disk" proves the record's reuse
        rep_warm = None
        for r in range(args.repeats):
            runner, rep, _ = drive(args.serve_policy)
            served_s = (rep["served_total"] / rep["wall_s"]
                        if rep["wall_s"] else 0.0)
            log(f"warm run {r}: warmup {rep['warmup_s']:.3f}s "
                f"({rep['warmup_source']}), {served_s:.1f} effective "
                f"jobs/s")
            if rep_warm is None or rep["wall_s"] < rep_warm["wall_s"]:
                rep_warm = rep
        # the fifo baseline at the same schedule (one warm run)
        _, rep_fifo, _ = drive("fifo")
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    result = {
        "metric": "serve_effective_jobs_per_sec",
        "value": round(rep_warm["served_total"] / rep_warm["wall_s"], 2)
        if rep_warm["wall_s"] else 0.0,
        "unit": "jobs/s",
        "serve_policy": args.serve_policy,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "scheduler": (args.scheduler if args.scheduler == "sync"
                      else f"exact/{args.exact_impl}"),
        "megatick": runner.megatick,
        "fused_tick": runner.fused,
        "graph": args.graph, "nodes": args.nodes, "batch": args.batch,
        "requests": rcount, "rate": args.rate, "tenants": args.tenants,
        "dup_rate": args.dup_rate, "repeats": args.repeats,
        "stretch": args.stretch, "drain_chunk": args.drain_chunk,
        "occupancy": rep_warm["occupancy"],
        "admit_p50": rep_warm["admit_p50"],
        "admit_p99": rep_warm["admit_p99"],
        "deadline_misses": rep_warm["deadline_misses"],
        "memo_hit_rate": rep_warm["memo_hit_rate"],
        "served_total": rep_warm["served_total"],
        "refused_total": rep_warm["refused_total"],
        "steps": rep_warm["steps"],
        "wall_s": rep_warm["wall_s"],
        # cold pays the kernels' build or load, warm loads what the
        # record names without nvcc
        "warmup_cold_s": rep_cold["warmup_s"],
        "warmup_cold_source": rep_cold["warmup_source"],
        "warmup_cold_builds": rep_cold["warmup_builds"],
        "warmup_warm_s": rep_warm["warmup_s"],
        "warmup_warm_source": rep_warm["warmup_source"],
        "warmup_warm_builds": rep_warm["warmup_builds"],
        # the fifo baseline's service at the identical schedule
        "deadline_misses_fifo": rep_fifo["deadline_misses"],
        "admit_p99_fifo": rep_fifo["admit_p99"],
        "occupancy_fifo": rep_fifo["occupancy"],
    }
    result["cost_model"] = tick_cost_model(
        runner.topo.n, runner.topo.e, cfg, batch=args.batch,
        queue_engine=runner.queue_engine)
    if device.type != "cuda":
        result["note"] = ("CPU run of the plain PyTorch versions; not a "
                          "device measurement")
    print(json.dumps(result), flush=True)
    return 0


def run_fleet_worker(args, device, spec, cfg) -> int:
    """``--fleet N`` (module docstring): the JAX bench's fleet row on the
    port. One seeded Poisson/Zipf schedule admitted into a fresh spool
    and served by N spawned workers on ``device``; ``--fleet-crashes K``
    adds the degraded-mode arm. Returns the exit code."""
    import os
    import shutil
    import tempfile

    from chandy_lamport_tpu_torch.models.workloads import (
        crash_schedule,
        serve_workload,
    )
    from chandy_lamport_tpu_torch.serving import fleet_run

    if args.graph != "ring":
        log("--fleet requires --graph ring: the spawn-crossing worker "
            "recipe reconstructs a ring-stream engine")
        return 1
    rcount = args.jobs or 3 * args.batch
    requests = serve_workload(spec, rcount, seed=17, rate=args.rate,
                              tenants=args.tenants,
                              priorities=args.priorities,
                              dup_rate=args.dup_rate,
                              max_phases=max(args.phases, 4))
    log(f"fleet: {rcount} requests, {args.fleet} worker(s) on {device}, "
        f"rate {args.rate}/step, crashes={args.fleet_crashes}, "
        f"lease_ttl={args.fleet_lease_ttl}s")
    run_dir = tempfile.mkdtemp(prefix="clsim-fleet-")
    recipe = {"kind": "ring-stream", "n": args.nodes,
              "tokens": args.phases + 10, "snapshots": args.snapshots,
              "max_recorded": cfg.max_recorded,
              "batch": args.batch, "scheduler": args.scheduler,
              "delay": args.delay,
              "memo_cache": os.path.join(run_dir, "memo.jsonl")}
    kills = crash_schedule(args.fleet_crashes, 2.0, start_s=4.0)
    try:
        t0 = time.perf_counter()
        rep = fleet_run(requests,
                        spool_path=os.path.join(run_dir, "wal.jsonl"),
                        workers=args.fleet, recipe=recipe,
                        lease_ttl=args.fleet_lease_ttl,
                        crash_schedule=kills, restart_backoff=0.2,
                        stretch=args.stretch, drain_chunk=args.drain_chunk,
                        max_wall_s=420.0, device=str(device))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    if rep["timed_out"]:
        log("ERROR: fleet run hit max_wall_s before every request was "
            "terminal — results invalid")
        return 1
    if rep["audit"]["lost"] or rep["audit"]["double_served"]:
        log(f"ERROR: spool audit failed — lost={rep['audit']['lost']}, "
            f"double_served={rep['audit']['double_served']}")
        return 1
    log(f"fleet: served {rep['served']}/{rcount} in {rep['wall_s']:.1f}s "
        f"(goodput {rep['goodput']:.2f}), deaths="
        f"{rep['books']['worker_deaths']} takeovers="
        f"{rep['books']['takeovers']} restarts={rep['books']['restarts']}")
    result = {
        "metric": "fleet_served_jobs_per_sec",
        "value": round(rep["served"] / rep["wall_s"], 2)
        if rep["wall_s"] else 0.0,
        "unit": "jobs/s",
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "scheduler": (args.scheduler if args.scheduler == "sync"
                      else f"exact/{args.exact_impl}"),
        "graph": args.graph, "nodes": args.nodes, "batch": args.batch,
        "requests": rcount, "rate": args.rate, "tenants": args.tenants,
        "workers": args.fleet, "crashes_injected": args.fleet_crashes,
        "lease_ttl_s": args.fleet_lease_ttl,
        "stretch": args.stretch, "drain_chunk": args.drain_chunk,
        "served": rep["served"], "goodput": rep["goodput"],
        "shed": len(rep["shed"]), "poisoned": len(rep["poisoned"]),
        "lat_p50_s": rep["lat_p50_s"], "lat_p99_s": rep["lat_p99_s"],
        "lat_max_s": rep["lat_max_s"],
        "worker_deaths": rep["books"]["worker_deaths"],
        "takeovers": rep["books"]["takeovers"],
        "restarts": rep["books"]["restarts"],
        "cache_served": sum(1 for v in rep["results"].values()
                            if v.get("served_from") == "fleet-cache"),
        "audit_lost": rep["audit"]["lost"],
        "audit_double_served": rep["audit"]["double_served"],
        "wall_total_s": round(wall, 2),
        "serve_wall_s": rep["wall_s"],
        "serve_schema": rep["serve_schema"],
    }
    if device.type != "cuda":
        result["note"] = ("CPU run of the plain PyTorch versions; not a "
                          "device measurement")
    print(json.dumps(result), flush=True)
    return 0


def served_rows(runner, stream) -> list:
    """A memoized stream's per-job rows without the fields that depend on
    admission or provenance (``admit_step``, ``digest``,
    ``served_from``): what must equal the memo-off arm's rows."""
    return [{k: v for k, v in row.items()
             if k not in ("admit_step", "digest", "served_from")}
            for row in runner.stream_results(stream)]


def memo_arms(args, device, make, memo_runner, pool, off_rows, off_rate,
              result) -> str:
    """``--memo``'s arms (module docstring) on ``pool``: a warm drive
    (its served rows held to ``off_rows``, every job served), then
    ``--repeats`` timed drives; under "prefix" the same for a "full"
    runner. Updates ``result``; returns what failed, or ""."""
    jcount = pool.num_jobs

    def drive(r):
        _sync(device)
        t0 = time.perf_counter()
        _, stream = r.run_stream(pool, stretch=args.stretch,
                                 drain_chunk=args.drain_chunk)
        _sync(device)
        return time.perf_counter() - t0, stream

    def arm(r, name):
        dt, stream = drive(r)
        served = served_rows(r, stream)
        log(f"{name} arm warm drive: {dt:.1f}s, served {len(served)}/"
            f"{jcount}")
        if len(served) != jcount:
            return None, f"the {name} arm did not serve every job"
        if served != off_rows:
            return None, f"the {name} arm's rows differ from memo off"
        times = []
        for i in range(args.repeats):
            dt, stream = drive(r)
            times.append(dt)
            log(f"{name} run {i}: {dt:.3f}s -> {jcount / dt:.1f} "
                f"effective jobs/s")
        return (jcount / min(times), r.summarize_stream(stream)), ""

    got, bad = arm(memo_runner, args.memo)
    if bad:
        return bad
    eff, sm = got
    result.update({
        "effective_jobs_per_sec": eff,
        "effective_jobs_per_sec_off": off_rate,
        "memo_speedup": eff / off_rate if off_rate else 0.0,
        **{k: sm[k] for k in ("cache_hits", "coalesced_jobs",
                              "ff_skipped_ticks", "shadow_checks",
                              "memo_hit_rate")},
        "memo_steps": sm["steps"],
        "memo_timing": dict(memo_runner.memo_timing)})
    if args.memo == "prefix":
        got, bad = arm(make("full"), "full")
        if bad:
            return bad
        eff_full, _ = got
        hist: dict = {}
        for d in memo_runner._fork_depths:
            hist[str(d)] = hist.get(str(d), 0) + 1
        result.update({
            "prefix_overlap": args.prefix_overlap,
            **{k: sm[k] for k in ("prefix_hits", "forked_jobs",
                                  "fork_depth_mean", "prefix_evictions")},
            "fork_depth_hist": hist,
            "effective_jobs_per_sec_full": eff_full,
            "prefix_speedup": eff / eff_full if eff_full else 0.0})
    return ""


def _trace_overhead(base, prog, device, best, capacity, summary) -> dict:
    """The traced row's fields (the JAX bench's): one warm and one timed
    storm of ``base``, the untraced runner of the same arguments, and the
    traced best rate ``best`` against it."""
    base.run_storm(base.init_batch_device(), prog)
    state = base.init_batch_device()
    _sync(device)
    t0 = time.perf_counter()
    final = base.run_storm(state, prog)
    _sync(device)
    rate = int(final.time.sum()) * base.topo.n / (time.perf_counter() - t0)
    del state, final
    out = {"trace_capacity": capacity,
           "trace_events": summary["trace_events"],
           "trace_dropped": summary["trace_dropped"],
           "trace_overhead_pct": (rate / best - 1.0) * 100,
           "untraced_node_ticks_per_sec": rate}
    log(f"trace overhead: {out['trace_overhead_pct']:.1f}% (untraced "
        f"{rate / 1e6:.3f}M vs traced {best / 1e6:.3f}M node-ticks/s)")
    return out


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
    if args.graphshard:
        if faults is not None or args.quarantine or args.stream \
                or args.serve or args.fleet or args.scheduler != "sync":
            parser.error("--graphshard runs the JAX bench's graphshard "
                         "row: the sync scheduler, no adversary, not "
                         "--stream/--serve/--fleet")
        return run_graphshard_worker(args, device, spec, cfg)
    if args.fleet:
        if faults is not None or args.quarantine or args.stream \
                or args.serve:
            parser.error("--fleet runs the JAX bench's fleet row, which "
                         "arms no adversary and is not --stream or --serve")
        return run_fleet_worker(args, device, spec, cfg)
    if args.serve:
        if faults is not None or args.quarantine or args.stream:
            parser.error("--serve runs the JAX bench's serve row, which "
                         "arms no adversary and is not --stream")
        return run_serve_worker(args, device, spec, cfg)
    if args.stream:
        if faults is not None or args.quarantine:
            parser.error("--stream runs the JAX bench's stream row, which "
                         "arms no adversary")
        return run_stream_worker(args, device, spec, cfg)
    quarantine = args.quarantine or faults is not None
    allowed = FAULT_BITS if faults is not None else 0
    trace = _trace(args)

    def make_runner(cfg, trace):
        return BatchedRunner(spec, cfg, make_fast_delay(args.delay, 17),
                             batch=args.batch, scheduler=args.scheduler,
                             exact_impl=args.exact_impl, device=device,
                             faults=faults, quarantine=quarantine,
                             megatick=args.megatick, trace=trace)

    runner = summary = prog = verdict = None
    for cap_try in range(4):
        runner = make_runner(cfg, trace)
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
        summary = BatchedRunner.summarize(final, runner=runner)
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
    steps = {"wave": "waves", "fold": "source steps"}.get(args.exact_impl,
                                                          "marker folds")
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
    trace_extra = {}
    if trace is not None:
        trace_extra = _trace_overhead(
            make_runner(dataclasses.replace(runner.config,
                                            trace_capacity=0), None),
            prog, device, best, runner.config.trace_capacity, summary)
    if args.profile:
        state = runner.init_batch_device()
        _profile(lambda: runner.run_storm(state, prog), device, args.profile)
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
    # the analytic per-tick cost at this shape (the JAX row's)
    result["cost_model"] = tick_cost_model(
        topo.n, topo.e, cfg, batch=args.batch,
        queue_engine=runner.queue_engine)
    if faults is not None:
        result.update(faults=faults.describe(), quarantine=quarantine,
                      snapshot_timeout=cfg.snapshot_timeout,
                      snapshot_retries=cfg.snapshot_retries,
                      snapshot_every=cfg.snapshot_every, **verdict)
    result.update(trace_extra)
    if device.type != "cuda":
        result["note"] = ("CPU run of the plain PyTorch versions; not a "
                          "device measurement")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
