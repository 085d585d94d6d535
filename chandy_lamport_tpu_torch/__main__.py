"""Command line of the port.

    python -m chandy_lamport_tpu_torch storm [flags]   a batched storm
                                                       (the JAX CLI's
                                                       ``storm``): one JSON
                                                       counters line
    python -m chandy_lamport_tpu_torch bench [flags]   the node-ticks/s
                                                       bench row (bench.py;
                                                       --stream for the
                                                       stream row)
    python -m chandy_lamport_tpu_torch stream [flags]  a streaming run: a
                                                       job queue over B
                                                       lane slots
    python -m chandy_lamport_tpu_torch serve [flags]   online multi-tenant
                                                       serving over the
                                                       stream step (the
                                                       JAX CLI's ``serve``)
    python -m chandy_lamport_tpu_torch run TOP EVENTS [--backend B]
                     [--seed S] [--trace] [--exact-impl I] [--device D]
                                                       one fixture's
                                                       snapshots (the JAX
                                                       CLI's ``run``)
    python -m chandy_lamport_tpu_torch test [--backend B] [--exact-impl I]
                     [--device D]                      the 7 reference goldens
                                                       (torch: DenseSim,
                                                       megatick 8; or the
                                                       parity oracle)
    python -m chandy_lamport_tpu_torch trace TOP EVENTS [--perfetto P]
                     [--telemetry P] [--device D]      a fixture with the
                                                       flight recorder armed:
                                                       its timeline
"""

import argparse
import json
import sys
import time

import torch

from chandy_lamport_tpu_torch.api import run_reference_tests
from chandy_lamport_tpu_torch.bench import main as bench_main
from chandy_lamport_tpu_torch.parallel.batch import resolve_device


def run_cmd(argv) -> int:
    """The JAX CLI's ``run`` (``cli.py:40``): run a fixture pair through
    ``run_events_file`` on ``--backend`` (the torch backend, ``DenseSim``
    at megatick 8, by default: the port's rule; the JAX default is the
    parity oracle) and print each snapshot as the JAX CLI does: its id,
    ``node tokens`` lines in sorted order, ``src dest message`` lines, a
    blank line. ``--trace`` prints the timeline on stderr (the parity
    backend's ``EpochTrace`` or the flight recorder: the same text)."""
    from chandy_lamport_tpu_torch.api import BACKENDS, run_events_file
    from chandy_lamport_tpu_torch.config import REFERENCE_TEST_SEED

    p = argparse.ArgumentParser(prog="python -m chandy_lamport_tpu_torch "
                                     "run")
    p.add_argument("topology")
    p.add_argument("events")
    p.add_argument("--backend", choices=BACKENDS, default="torch")
    p.add_argument("--seed", type=int, default=REFERENCE_TEST_SEED + 1)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--exact-impl", choices=["cascade", "wave", "fold"],
                   default="cascade",
                   help="torch backend: which bit-identical formulation of "
                        "the reference scheduler runs the script ('wave' "
                        "needs a position-addressable sampler, so it "
                        "refuses the default Go-exact stream)")
    p.add_argument("--device", default=None,
                   help="torch backend: torch device (default: the card)")
    args = p.parse_args(argv)
    device = (resolve_device(args.device) if args.backend == "torch"
              else None)
    snaps, sim = run_events_file(args.topology, args.events, args.backend,
                                 seed=args.seed, trace=args.trace,
                                 exact_impl=args.exact_impl, device=device)
    for snap in snaps:
        print(snap.id)
        for nid in sorted(snap.token_map):
            print(f"{nid} {snap.token_map[nid]}")
        for m in snap.messages:
            print(f"{m.src} {m.dest} {m.message}")
        print()
    if args.trace:
        print(sim.trace.pretty(), file=sys.stderr)
    return 0


def golden_test(argv) -> int:
    """Run the 7 goldens on ``--backend`` (the JAX CLI's ``test``, its
    default "torch": ``DenseSim`` at megatick 8), print PASS/FAIL per
    case and the count — on the torch backend also the device that ran
    them; exit 1 on any mismatch. ``--exact-impl wave`` on the torch
    backend is refused with exit 2, as in JAX (the goldens replay the
    order-dependent Go-exact stream); the parity backend ignores the
    flag."""
    from chandy_lamport_tpu_torch.api import BACKENDS

    p = argparse.ArgumentParser(prog="python -m chandy_lamport_tpu_torch "
                                     "test")
    p.add_argument("--backend", choices=BACKENDS, default="torch")
    p.add_argument("--exact-impl", choices=["cascade", "wave", "fold"],
                   default="cascade",
                   help="torch backend: run the golden suite through this "
                        "formulation of the reference scheduler (the "
                        "goldens replay the Go-exact stream, which 'wave' "
                        "refuses by design)")
    p.add_argument("--device", default=None,
                   help="torch backend: torch device (default: the card)")
    args = p.parse_args(argv)
    torch_backend = args.backend == "torch"
    if torch_backend and args.exact_impl == "wave":
        print("the golden suite replays the order-dependent Go-exact "
              "delay stream; exact_impl='wave' cannot serve it — use "
              "cascade or fold", file=sys.stderr)
        return 2
    device = resolve_device(args.device) if torch_backend else None
    impl = args.exact_impl if torch_backend else "cascade"
    results = run_reference_tests(device, args.backend, exact_impl=impl)
    for name, _, why in results:
        print(f"PASS {name}" if why is None else f"FAIL {name}: {why}")
    failures = sum(why is not None for _, _, why in results)
    print(f"{len(results) - failures}/{len(results)} passed")
    if torch_backend:
        print("device: " + (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else device.type))
    return 1 if failures else 0


def trace_run(argv) -> int:
    """The JAX CLI's ``trace`` (``cli.py:117-146``): run a fixture pair
    through ``run_events_file(..., trace=True)`` (``DenseSim`` at megatick
    8 with the flight recorder armed; on the card the fused megatick's
    recorder arm), print the decoded timeline on stdout and ``# R events
    recorded, D dropped`` on stderr; optionally write it as Perfetto
    trace-event JSON and as telemetry JSONL."""
    from chandy_lamport_tpu_torch.api import run_events_file
    from chandy_lamport_tpu_torch.config import REFERENCE_TEST_SEED
    from chandy_lamport_tpu_torch.utils.tracing import TelemetryWriter

    p = argparse.ArgumentParser(prog="python -m chandy_lamport_tpu_torch "
                                     "trace")
    p.add_argument("topology")
    p.add_argument("events")
    p.add_argument("--seed", type=int, default=REFERENCE_TEST_SEED + 1)
    p.add_argument("--perfetto", metavar="PATH",
                   help="write Chrome/Perfetto trace-event JSON")
    p.add_argument("--telemetry", metavar="PATH",
                   help="write the decoded events as schema-versioned JSONL")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    snaps, sim = run_events_file(args.topology, args.events, seed=args.seed,
                                 device=resolve_device(args.device),
                                 trace=True)
    recorded, dropped = sim.trace.counts()
    if args.perfetto:
        with open(args.perfetto, "w") as f:
            json.dump(sim.trace.perfetto(), f)
        print(f"wrote perfetto trace: {args.perfetto}", file=sys.stderr)
    if args.telemetry:
        with TelemetryWriter(args.telemetry) as tw:
            tw.write("trace_run", {
                "topology": args.topology, "events": args.events,
                "seed": args.seed, "snapshots": len(snaps),
                "trace_events": recorded, "trace_dropped": dropped})
            for ev in sim.trace.events:
                tw.write("event", {"tick": ev.tick, "event": ev.kind_name,
                                   "actor": ev.actor,
                                   "payload": ev.payload})
        print(f"wrote telemetry: {args.telemetry}", file=sys.stderr)
    print(sim.trace.pretty())
    print(f"# {recorded} events recorded, {dropped} dropped",
          file=sys.stderr)
    return 0


def _storm_parser() -> argparse.ArgumentParser:
    """The JAX CLI's ``storm`` flags and defaults (``cli.py:614-751``),
    plus ``--device``."""
    ps = argparse.ArgumentParser(prog="python -m chandy_lamport_tpu_torch "
                                      "storm")
    ps.add_argument("--graph", choices=["ring", "er", "sf"], default="sf")
    ps.add_argument("--nodes", type=int, default=256)
    ps.add_argument("--batch", type=int, default=128)
    ps.add_argument("--phases", type=int, default=32)
    ps.add_argument("--snapshots", type=int, default=8)
    ps.add_argument("--scheduler", choices=["sync", "exact"], default="sync")
    ps.add_argument("--exact-impl", choices=["cascade", "wave", "fold"],
                    default="cascade",
                    help="--scheduler exact: the bit-exact tick formulation "
                         "('wave' needs --delay hash; 'fold', the "
                         "reference-literal form, takes no faults and no "
                         "supervisor)")
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--megatick", type=int, default=8,
                    help="K-tick megaticks for the exact drain and flush "
                         "(the fused megatick kernel on the card); the sync "
                         "scheduler has none")
    ps.add_argument("--queue-capacity", type=int, default=0,
                    help="per-edge ring slots; 0 = size to the workload")
    ps.add_argument("--max-recorded", type=int, default=0,
                    help="per-edge log slots L; 0 = derived")
    ps.add_argument("--window-dtype", choices=["int32", "uint16"],
                    default="int32",
                    help="uint16: the window counters modulo 2^16")
    ps.add_argument("--record-dtype", choices=["int32", "int16"],
                    default="int32")
    ps.add_argument("--reduce-mode", choices=["auto", "matmul", "segsum"],
                    default="auto", help="the JAX reduction; the port "
                                         "reduces through its segment "
                                         "kernels, equal in result")
    ps.add_argument("--kernel-engine", choices=["auto", "xla", "pallas"],
                    default="auto", help="the JAX engine knob; the port has "
                                         "one engine, so every choice runs "
                                         "it")
    ps.add_argument("--fused-tick", choices=["auto", "on", "off"],
                    default="auto", help="the fused megatick: 'off' runs "
                                         "the megaticks as single ticks, "
                                         "'on' raises where it cannot run")
    ps.add_argument("--fused-block-edges", type=int, default=0,
                    help="the TPU kernel's fault-plane block width; the "
                         "card hashes the fault masks in place, so it "
                         "moves nothing")
    ps.add_argument("--check-every", type=int, default=0,
                    help="evaluate token conservation every K phases (0 = "
                         "off); violations set ERR_CONSERVATION")
    ps.add_argument("--delay", choices=["uniform", "hash"], default="hash",
                    help="'uniform': the threefry stream of jax.random; "
                         "'hash': the counter hash")
    ps.add_argument("--checkpoint", help="save the final state to this "
                                         ".npz (atomic write)")
    ps.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                    help="checkpoint to --checkpoint after every K phases "
                         "(the phases in chunks, bit-identical to one run); "
                         "a killed run resumes via --resume-from to the "
                         "same final state")
    ps.add_argument("--resume-from", metavar="PATH",
                    help="resume a storm from a checkpoint of either "
                         "package written by --checkpoint-every (pass the "
                         "same storm flags; a mismatch raises "
                         "CheckpointError)")
    for name, what in (("--fault-drop", "per-(edge, tick) token drop"),
                       ("--fault-dup", "per-(edge, tick) token duplicate"),
                       ("--fault-jitter", "per-(edge, tick) front stall"),
                       ("--fault-crash", "per-(node, window) crash")):
        ps.add_argument(name, type=float, default=0.0, metavar="R",
                        help=f"{what} probability")
    ps.add_argument("--fault-seed", type=int, default=None,
                    help="adversary stream seed (default: --seed)")
    ps.add_argument("--crash-mode", choices=["pause", "lossy"],
                    default="pause")
    ps.add_argument("--crash-len", type=int, default=2)
    ps.add_argument("--crash-period", type=int, default=32)
    for name, what in (("--marker-fault-drop", "marker drop"),
                       ("--marker-fault-dup", "marker duplicate"),
                       ("--marker-fault-jitter", "marker front stall")):
        ps.add_argument(name, type=float, default=0.0, metavar="R",
                        help=f"per-(edge, tick) {what} probability")
    ps.add_argument("--snapshot-timeout", type=int, default=0, metavar="T")
    ps.add_argument("--snapshot-retries", type=int, default=3)
    ps.add_argument("--snapshot-every", type=int, default=0, metavar="K")
    ps.add_argument("--quarantine", action="store_true",
                    help="freeze a lane once its error bits fire (on "
                         "whenever a fault rate is set)")
    # the resume drill: exit 17 right after that chunk's checkpoint lands
    ps.add_argument("--kill-after-chunk", type=int, default=None,
                    help=argparse.SUPPRESS)
    ps.add_argument("--trace", action="store_true",
                    help="arm the flight recorder; adds trace_events/"
                         "trace_dropped to the JSON row")
    ps.add_argument("--trace-capacity", type=int, default=0, metavar="K",
                    help="ring slots per lane; implies --trace when > 0")
    ps.add_argument("--telemetry", metavar="PATH",
                    help="write the run's JSON row as schema-versioned "
                         "JSONL telemetry")
    ps.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    return ps


def storm_run(argv) -> int:
    """The JAX CLI's ``storm`` (``cli.py:149-316``) on the port: one storm
    of ``--batch`` lanes through ``BatchedRunner.run_storm`` (the drain
    and flush in ``--megatick`` K-tick megaticks on the exact scheduler),
    then one JSON counters line with the JAX keys. With
    ``--checkpoint-every K`` the phases run in chunks of K with a
    checkpoint after each (meta ``next_phase``), then the drain;
    ``--resume-from`` starts from such a file (either package's);
    ``--checkpoint`` alone saves the final state (meta ``drained``).
    Exit 0 when no error bit fired, or when an armed adversary's
    casualties were quarantined; 17 after ``--kill-after-chunk``; else
    1."""
    from chandy_lamport_tpu_torch.config import SimConfig
    from chandy_lamport_tpu_torch.core.state import decode_error_bits
    from chandy_lamport_tpu_torch.models.faults import Faults
    from chandy_lamport_tpu_torch.models.workloads import (
        StormProgram,
        erdos_renyi,
        ring_topology,
        scale_free,
        staggered_snapshots,
        storm_program,
    )
    from chandy_lamport_tpu_torch.ops.delay import make_fast_delay
    from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
    from chandy_lamport_tpu_torch.utils.checkpoint import (
        load_state,
        save_state,
    )
    from chandy_lamport_tpu_torch.utils.metrics import (
        conservation_delta,
        progress_counters,
    )
    from chandy_lamport_tpu_torch.utils.tracing import (
        TelemetryWriter,
        Trace,
        trace_counts,
    )

    args = _storm_parser().parse_args(argv)
    if args.checkpoint_every and not args.checkpoint:
        print("--checkpoint-every needs --checkpoint PATH (the file "
              "the periodic snapshots land in)", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    tokens = args.phases + 10
    spec = {"ring": lambda: ring_topology(args.nodes, tokens=tokens),
            "er": lambda: erdos_renyi(args.nodes, 3.0, args.seed,
                                      tokens=tokens),
            "sf": lambda: scale_free(args.nodes, 2, args.seed,
                                     tokens=tokens)}[args.graph]()
    cfg = SimConfig.for_workload(
        snapshots=args.snapshots, max_recorded=args.max_recorded,
        record_dtype=args.record_dtype, window_dtype=args.window_dtype,
        reduce_mode=args.reduce_mode,
        split_markers=args.scheduler == "sync",
        snapshot_timeout=args.snapshot_timeout,
        snapshot_retries=args.snapshot_retries,
        snapshot_every=args.snapshot_every,
        **({"queue_capacity": args.queue_capacity}
           if args.queue_capacity else {}))
    faults = None
    if any((args.fault_drop, args.fault_dup, args.fault_jitter,
            args.fault_crash, args.marker_fault_drop, args.marker_fault_dup,
            args.marker_fault_jitter)):
        faults = Faults(
            args.fault_seed if args.fault_seed is not None else args.seed,
            drop_rate=args.fault_drop, dup_rate=args.fault_dup,
            jitter_rate=args.fault_jitter, crash_rate=args.fault_crash,
            crash_mode=args.crash_mode, crash_len=args.crash_len,
            crash_period=args.crash_period,
            marker_drop_rate=args.marker_fault_drop,
            marker_dup_rate=args.marker_fault_dup,
            marker_jitter_rate=args.marker_fault_jitter)
    quarantine = args.quarantine or faults is not None
    trace = (Trace(capacity=args.trace_capacity)
             if args.trace or args.trace_capacity else None)
    # the megatick is the exact scheduler's (the JAX sync path ignores it)
    runner = BatchedRunner(
        spec, cfg, make_fast_delay(args.delay, args.seed), batch=args.batch,
        scheduler=args.scheduler, exact_impl=args.exact_impl,
        check_every=args.check_every,
        megatick=args.megatick if args.scheduler == "exact" else 1,
        kernel_engine=args.kernel_engine, device=device, faults=faults,
        quarantine=quarantine, trace=trace, fused_tick=args.fused_tick,
        fused_block_edges=args.fused_block_edges)
    prog = storm_program(
        runner.topo, phases=args.phases, amount=1,
        snapshot_phases=staggered_snapshots(runner.topo, args.snapshots, 1,
                                            2, max_phases=args.phases))
    meta_base = {"nodes": runner.topo.n, "batch": args.batch,
                 "scheduler": args.scheduler, "phases": args.phases,
                 "delay": args.delay, "seed": args.seed}
    if faults is not None:
        meta_base["faults"] = faults.describe()

    state = runner.init_batch_device()
    start_phase = 0
    if args.resume_from:
        # a fresh state of the same flags is the template: a file of
        # another run's shape raises CheckpointError
        state, meta = load_state(args.resume_from, state, delay=runner.delay)
        start_phase = int(meta.get("next_phase", 0))
        print(f"resumed from {args.resume_from} at phase {start_phase}",
              file=sys.stderr)

    def phases(lo, hi):
        return StormProgram(prog.amounts[lo:hi], prog.snap[lo:hi])

    if args.checkpoint_every:
        k = args.checkpoint_every
        for chunk, lo in enumerate(range(start_phase, args.phases, k)):
            hi = min(lo + k, args.phases)
            state = runner.run_storm(state, phases(lo, hi), drain=False)
            save_state(args.checkpoint, state,
                       meta={**meta_base, "next_phase": hi},
                       delay=runner.delay)
            if (args.kill_after_chunk is not None
                    and chunk == args.kill_after_chunk):
                # the preemption drill: stop right after a checkpoint
                # landed, before the drain
                print(json.dumps({"killed_after_phase": hi,
                                  "checkpoint": args.checkpoint}))
                return 17
        final = runner.drain(state)
    else:
        final = runner.run_storm(state, phases(start_phase, args.phases))
    counters = {k: int(v) for k, v in progress_counters(
        final, runner.config, runner.topo.n).items()}
    counters["errors_decoded"] = decode_error_bits(counters["error_bits"])
    expected = int(runner.topo.tokens0.sum()) * args.batch
    counters["conservation_delta"] = int(
        conservation_delta(final, runner.config, expected))
    summary = BatchedRunner.summarize(final)
    counters["snapshot_lifecycle"] = summary["snapshot_lifecycle"]
    if faults is not None:
        errs = final.error.cpu()
        counters["fault_events"] = summary["fault_events"]
        counters["fault_skew"] = summary["fault_skew"]
        counters["quarantined_lanes"] = int((errs != 0).sum())
        counters["lane_errors"] = {
            int(i): decode_error_bits(int(errs[i]))
            for i in torch.nonzero(errs).flatten()[:16].tolist()}
    if trace is not None:
        counters["trace_events"], counters["trace_dropped"] = \
            trace_counts(final)
    if args.checkpoint:
        save_state(args.checkpoint, final,
                   meta={**meta_base, "next_phase": args.phases,
                         "drained": True}, delay=runner.delay)
        counters["checkpoint"] = args.checkpoint
    if args.telemetry:
        with TelemetryWriter(args.telemetry) as tw:
            tw.write("storm_run", {**meta_base, **counters})
        counters["telemetry"] = args.telemetry
    print(json.dumps(counters))
    if counters["error_bits"] == 0:
        return 0
    return 0 if (faults is not None and quarantine) else 1


def _stream_parser() -> argparse.ArgumentParser:
    """The JAX CLI's ``stream`` flags (``cli.py:753-855``), plus
    ``--device``."""
    pq = argparse.ArgumentParser(prog="python -m chandy_lamport_tpu_torch "
                                      "stream")
    pq.add_argument("--graph", choices=["ring", "er", "sf"], default="sf")
    pq.add_argument("--nodes", type=int, default=256)
    pq.add_argument("--batch", type=int, default=64,
                    help="lane slots B (device batch width)")
    pq.add_argument("--jobs", type=int, default=0,
                    help="queued jobs J (0 = 3x batch)")
    pq.add_argument("--base-phases", type=int, default=4,
                    help="heavy-tailed job lengths: Pareto(base, alpha) "
                         "phases per job (models/workloads.stream_jobs)")
    pq.add_argument("--tail-alpha", type=float, default=1.1)
    pq.add_argument("--max-phases", type=int, default=32)
    pq.add_argument("--dup-rate", type=float, default=0.0, metavar="R",
                    help="fraction of the queue that repeats a Zipf-drawn "
                         "library job byte for byte (stream_jobs): the "
                         "traffic the memo plane serves without a lane")
    pq.add_argument("--memo", choices=["off", "admit", "full", "prefix"],
                    default="off",
                    help="the memo plane: 'admit' runs one lane per "
                         "distinct job and serves duplicates and summary-"
                         "cache hits from it; 'full' adds fast-forwarding "
                         "of lanes whose state recurs; 'prefix' adds "
                         "forking near-duplicates from checkpointed "
                         "prefixes. Every served row equals the row of "
                         "'off', which is the memo-free engine")
    pq.add_argument("--memo-cache", metavar="PATH",
                    help="the persistent summary cache (JSON lines, "
                         "utils/memocache.py; the JAX package's format): "
                         "hits across runs take no lane")
    pq.add_argument("--prefix-overlap", type=float, default=0.0,
                    metavar="R",
                    help="fraction of the queue that extends a shared base "
                         "job with a unique tail (stream_jobs): the "
                         "near-duplicates memo 'prefix' forks")
    pq.add_argument("--prefix-cache", metavar="PATH",
                    help="the persistent prefix-checkpoint store of memo "
                         "'prefix' (JSON lines, utils/memocache."
                         "PrefixCache; the JAX package's format)")
    pq.add_argument("--snapshots", type=int, default=8)
    pq.add_argument("--scheduler", choices=["sync", "exact"], default="sync")
    pq.add_argument("--kernel-engine", choices=["auto", "xla", "pallas"],
                    default="auto",
                    help="the JAX tick-kernel engine knob; the port has one "
                         "engine (its CUDA kernels on the card, their plain "
                         "versions on the CPU), so every choice runs it")
    pq.add_argument("--fused-tick", choices=["auto", "on", "off"],
                    default="auto",
                    help="the JAX one-kernel megatick knob; this command "
                         "runs megatick 1, where no megatick is fused, so "
                         "every choice runs the same")
    pq.add_argument("--seed", type=int, default=0)
    pq.add_argument("--delay", choices=["uniform", "hash"], default="hash",
                    help="'uniform': the threefry stream of jax.random; "
                         "'hash': the counter hash")
    pq.add_argument("--admission", choices=["stream", "gang"],
                    default="stream",
                    help="'stream' refills a slot the moment its job "
                         "retires; 'gang' waits for every slot to idle "
                         "(the static-batching baseline)")
    pq.add_argument("--stretch", type=int, default=4,
                    help="script phases advanced per stream step")
    pq.add_argument("--drain-chunk", type=int, default=32,
                    help="drain ticks per stream step for draining lanes")
    pq.add_argument("--fault-drop", type=float, default=0.0, metavar="R",
                    help="fault adversary: per-(edge, tick) token-drop "
                         "probability, armed per job (each job replays its "
                         "own stream wherever it lands)")
    pq.add_argument("--fault-dup", type=float, default=0.0, metavar="R")
    pq.add_argument("--fault-jitter", type=float, default=0.0, metavar="R")
    pq.add_argument("--fault-seed", type=int, default=None,
                    help="adversary stream seed (default: --seed)")
    pq.add_argument("--checkpoint", help="save the (state, stream) carry "
                                         "to this .npz")
    pq.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                    help="checkpoint to --checkpoint every K stream steps; "
                         "a killed run resumes via --resume-from to a "
                         "bit-identical finish")
    pq.add_argument("--resume-from", metavar="PATH",
                    help="resume a streaming run from a checkpoint of "
                         "either package written by --checkpoint-every "
                         "(pass the same flags)")
    # the resume drill: exit 17 after that many checkpoints
    pq.add_argument("--kill-after-saves", type=int, default=None,
                    help=argparse.SUPPRESS)
    pq.add_argument("--trace", action="store_true",
                    help="arm the flight recorder (lane admits and harvests "
                         "land in the per-lane rings); adds trace_events/"
                         "trace_dropped to the row")
    pq.add_argument("--trace-capacity", type=int, default=0, metavar="K",
                    help="ring slots per lane (0 = Trace's default when "
                         "--trace is set); implies --trace when > 0")
    pq.add_argument("--telemetry", metavar="PATH",
                    help="append a stream_run row plus one stream_job row "
                         "per harvested job as schema-versioned JSONL")
    pq.add_argument("--guards", action="store_true",
                    help="arm the runtime contract guards "
                         "(utils/guards.RuntimeGuards): the steady-state "
                         "loop runs under torch.cuda.set_sync_debug_mode("
                         "'error') with a kernel-build counter; adds a "
                         "guards (compiles + per-site transfer) books dict "
                         "to the JSON row")
    pq.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    return pq


def stream_run(argv) -> int:
    """The JAX CLI's ``stream`` (``cli.py:317-439``) on the port: pack a
    ``stream_jobs`` queue, drive it through ``run_stream`` (under
    ``--memo``, with ``--memo-cache`` / ``--prefix-cache``) and print one
    JSON row (``summarize_stream``'s counters with the memo books, the
    memo mode, the wall time, jobs/s executed and served, and the errored
    jobs). ``--checkpoint-every K`` saves the ``(state,
    stream)`` carry every K steps, ``--resume-from`` continues from such a
    file. Exit 1 when a job erred without an adversary, 17 after
    ``--kill-after-saves``, 2 on ``--checkpoint-every`` without
    ``--checkpoint``."""
    from chandy_lamport_tpu_torch.config import SimConfig
    from chandy_lamport_tpu_torch.models.faults import Faults
    from chandy_lamport_tpu_torch.models.workloads import (
        erdos_renyi,
        ring_topology,
        scale_free,
        stream_jobs,
    )
    from chandy_lamport_tpu_torch.ops.delay import make_fast_delay
    from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
    from chandy_lamport_tpu_torch.utils.checkpoint import load_state
    from chandy_lamport_tpu_torch.utils.guards import RuntimeGuards
    from chandy_lamport_tpu_torch.utils.tracing import (
        TelemetryWriter,
        Trace,
        trace_counts,
    )

    args = _stream_parser().parse_args(argv)
    if args.checkpoint_every and not args.checkpoint:
        print("--checkpoint-every needs --checkpoint PATH (the file the "
              "periodic (state, stream) snapshots land in)", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    tokens = args.max_phases + 10
    spec = {"ring": lambda: ring_topology(args.nodes, tokens=tokens),
            "er": lambda: erdos_renyi(args.nodes, 3.0, args.seed,
                                      tokens=tokens),
            "sf": lambda: scale_free(args.nodes, 2, args.seed,
                                     tokens=tokens)}[args.graph]()
    cfg = SimConfig.for_workload(snapshots=args.snapshots,
                                 split_markers=args.scheduler == "sync")
    faults = None
    if any((args.fault_drop, args.fault_dup, args.fault_jitter)):
        faults = Faults(
            args.fault_seed if args.fault_seed is not None else args.seed,
            drop_rate=args.fault_drop, dup_rate=args.fault_dup,
            jitter_rate=args.fault_jitter)
    trace = (Trace(capacity=args.trace_capacity)
             if args.trace or args.trace_capacity else None)
    guards = RuntimeGuards() if args.guards else None
    runner = BatchedRunner(spec, cfg, make_fast_delay(args.delay, args.seed),
                           batch=args.batch, scheduler=args.scheduler,
                           device=device, faults=faults,
                           quarantine=faults is not None, trace=trace,
                           memo=args.memo, memo_cache=args.memo_cache,
                           prefix_cache=args.prefix_cache, guards=guards)
    jcount = args.jobs or 3 * args.batch
    jobs = stream_jobs(spec, jcount, seed=args.seed,
                       base_phases=args.base_phases,
                       tail_alpha=args.tail_alpha,
                       max_phases=args.max_phases, dup_rate=args.dup_rate,
                       prefix_overlap=args.prefix_overlap)
    pool = runner.pack_jobs(jobs)
    state = stream = None
    if args.resume_from:
        # a fresh carry of the same flags is the template: a file of
        # another queue or batch shape raises CheckpointError
        like = (runner.init_batch_device(), runner.init_stream(pool))
        (state, stream), meta = load_state(args.resume_from, like,
                                           delay=runner.delay)
        print(f"resumed from {args.resume_from} at {meta}", file=sys.stderr)
    t0 = time.perf_counter()
    state, stream = runner.run_stream(
        pool, stretch=args.stretch, drain_chunk=args.drain_chunk,
        admission=args.admission, state=state, stream=stream,
        checkpoint=args.checkpoint, checkpoint_every=args.checkpoint_every,
        kill_after_saves=args.kill_after_saves)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    done = int(stream.jobs_done)
    results = runner.stream_results(stream)
    if args.kill_after_saves is not None and len(results) < jcount:
        # the preemption drill: stop right after that many checkpoints
        print(json.dumps({"killed_after_steps": int(stream.steps),
                          "jobs_done": done,
                          "checkpoint": args.checkpoint}))
        return 17
    row = runner.summarize_stream(stream)
    row.update({"graph": args.graph, "nodes": runner.topo.n,
                "batch": args.batch, "jobs": jcount,
                "admission": args.admission, "scheduler": args.scheduler,
                "memo": runner.memo, "dup_rate": args.dup_rate,
                "prefix_overlap": args.prefix_overlap,
                "wall_seconds": round(wall, 3),
                "jobs_per_sec": round(done / wall, 2) if wall > 0 else 0.0,
                "effective_jobs_per_sec":
                    round(len(results) / wall, 2) if wall > 0 else 0.0})
    errored = [r for r in results if r["error"]]
    row["jobs_errored"] = len(errored)
    if errored:
        row["job_errors"] = {r["job"]: r["errors_decoded"]
                             for r in errored[:16]}
    if trace is not None:
        row["trace_events"], row["trace_dropped"] = trace_counts(state)
    if guards is not None:
        row["guards"] = guards.books()
    if args.telemetry:
        with TelemetryWriter(args.telemetry) as tw:
            tw.write("stream_run", row)
            for r in results:
                tw.write("stream_job", r)
        row["telemetry"] = args.telemetry
    print(json.dumps(row))
    return 0 if (faults is not None or not errored) else 1


def _serve_parser() -> argparse.ArgumentParser:
    """The JAX CLI's ``serve`` flags (``cli.py:857-946``) with its
    defaults, plus ``--device``."""
    pz = argparse.ArgumentParser(prog="python -m chandy_lamport_tpu_torch "
                                      "serve")
    pz.add_argument("--graph", choices=["ring", "er", "sf"], default="sf")
    pz.add_argument("--nodes", type=int, default=256)
    pz.add_argument("--batch", type=int, default=64,
                    help="lane slots B (device batch width)")
    pz.add_argument("--requests", type=int, default=0,
                    help="request count J (0 = 3x batch)")
    pz.add_argument("--rate", type=float, default=2.0,
                    help="open-loop Poisson arrival rate in requests per "
                         "stream step (models/workloads.serve_workload)")
    pz.add_argument("--tenants", type=int, default=4,
                    help="Zipf-weighted tenant population")
    pz.add_argument("--priorities", type=int, default=2,
                    help="priority classes (higher class admits first "
                         "under edf)")
    pz.add_argument("--deadline-slack", type=int, nargs=2,
                    default=[64, 256], metavar=("LO", "HI"),
                    help="per-request deadline = arrival + uniform[LO, HI] "
                         "stream steps; misses are counted in the carry")
    pz.add_argument("--quota", metavar="N,N,...",
                    help="per-tenant admission caps, comma-separated in "
                         "tenant order (0 = unlimited); requests over "
                         "quota are refused at ingest")
    pz.add_argument("--serve-policy", choices=["edf", "fifo"],
                    default="edf",
                    help="admission ordering (config.ENGINE_KNOBS): 'edf' "
                         "= earliest deadline first within priority "
                         "class; 'fifo' = arrival order (the baseline)")
    pz.add_argument("--dup-rate", type=float, default=0.0, metavar="R",
                    help="fraction of requests repeating a Zipf-drawn "
                         "library job byte for byte: served by the memo "
                         "plane without a lane")
    pz.add_argument("--base-phases", type=int, default=4)
    pz.add_argument("--tail-alpha", type=float, default=1.1)
    pz.add_argument("--max-phases", type=int, default=32)
    pz.add_argument("--snapshots", type=int, default=8)
    pz.add_argument("--scheduler", choices=["sync", "exact"], default="sync")
    pz.add_argument("--kernel-engine", choices=["auto", "xla", "pallas"],
                    default="auto",
                    help="the JAX tick-kernel engine knob; the port has one "
                         "engine, so every choice runs it")
    pz.add_argument("--fused-tick", choices=["auto", "on", "off"],
                    default="auto",
                    help="the JAX one-kernel megatick knob; this command "
                         "runs megatick 1, where no megatick is fused")
    pz.add_argument("--seed", type=int, default=0)
    pz.add_argument("--delay", choices=["uniform", "hash"], default="hash")
    pz.add_argument("--stretch", type=int, default=4)
    pz.add_argument("--drain-chunk", type=int, default=32)
    pz.add_argument("--results-capacity", type=int, default=0,
                    help="results-ring slots (0 = one per request; must "
                         "cover every executed job)")
    pz.add_argument("--memo-cache", metavar="PATH",
                    help="persistent summary cache (utils/memocache.py; "
                         "the JAX package's format): warm digests are "
                         "served at ingest, without a lane")
    pz.add_argument("--memo-cache-entries", type=int, default=0,
                    help="summary-cache LRU capacity in entries (0 = "
                         "unbounded)")
    pz.add_argument("--memo-cache-bytes", type=int, default=0,
                    help="summary-cache LRU capacity in serialized bytes "
                         "(0 = unbounded)")
    pz.add_argument("--exec-cache", metavar="DIR",
                    help="shape-bucketed serve-step cache directory "
                         "(serving/executables.py): a restarted server at "
                         "a seen bucket loads the built kernels without "
                         "nvcc")
    pz.add_argument("--checkpoint", help="save the (state, stream) carry "
                                         "to this .npz")
    pz.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                    help="checkpoint every K stream steps; a killed server "
                         "resumes via --resume-from bit-exactly")
    pz.add_argument("--resume-from", metavar="PATH",
                    help="resume a killed serve run of either package "
                         "(pass the same flags)")
    pz.add_argument("--kill-after-saves", type=int, default=None,
                    help=argparse.SUPPRESS)
    pz.add_argument("--telemetry", metavar="PATH",
                    help="schema-versioned JSONL: one serve_interval row "
                         "per --telemetry-interval steps, a final "
                         "serve_run row and one serve_job row per served "
                         "request")
    pz.add_argument("--telemetry-interval", type=int, default=64,
                    metavar="K")
    pz.add_argument("--guards", action="store_true",
                    help="arm the runtime contract guards "
                         "(utils/guards.RuntimeGuards) around the serve "
                         "loop; adds a guards books dict to the JSON row")
    pz.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    return pz


def serve_cmd(argv) -> int:
    """The JAX CLI's ``serve`` (``cli.py:443-555``) on the port: a
    ``serve_workload`` schedule served by ``serving.serve_run``, one JSON
    row (``summarize_stream``'s counters, the serve report, the flags'
    echo, the errored jobs and, with ``--guards``, the guard books).
    Exit 1 when a job erred, 17 after ``--kill-after-saves``, 2 on
    ``--checkpoint-every`` without ``--checkpoint``."""
    from chandy_lamport_tpu_torch.config import SimConfig
    from chandy_lamport_tpu_torch.models.workloads import (
        erdos_renyi,
        ring_topology,
        scale_free,
        serve_workload,
    )
    from chandy_lamport_tpu_torch.ops.delay import make_fast_delay
    from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
    from chandy_lamport_tpu_torch.serving import ExecutableCache, serve_run
    from chandy_lamport_tpu_torch.utils.checkpoint import load_state
    from chandy_lamport_tpu_torch.utils.guards import RuntimeGuards
    from chandy_lamport_tpu_torch.utils.tracing import TelemetryWriter

    args = _serve_parser().parse_args(argv)
    if args.checkpoint_every and not args.checkpoint:
        print("--checkpoint-every needs --checkpoint PATH (the file the "
              "periodic (state, stream) snapshots land in)", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    tokens = args.max_phases + 10
    spec = {"ring": lambda: ring_topology(args.nodes, tokens=tokens),
            "er": lambda: erdos_renyi(args.nodes, 3.0, args.seed,
                                      tokens=tokens),
            "sf": lambda: scale_free(args.nodes, 2, args.seed,
                                     tokens=tokens)}[args.graph]()
    cfg = SimConfig.for_workload(snapshots=args.snapshots,
                                 split_markers=args.scheduler == "sync")
    guards = RuntimeGuards() if args.guards else None
    runner = BatchedRunner(spec, cfg, make_fast_delay(args.delay, args.seed),
                           batch=args.batch, scheduler=args.scheduler,
                           kernel_engine=args.kernel_engine,
                           fused_tick=args.fused_tick,
                           memo_cache=args.memo_cache,
                           memo_cache_entries=args.memo_cache_entries,
                           memo_cache_bytes=args.memo_cache_bytes,
                           guards=guards, device=device)
    rcount = args.requests or 3 * args.batch
    quotas = ([int(x) for x in args.quota.split(",")] if args.quota
              else None)
    reqs = serve_workload(spec, rcount, seed=args.seed, rate=args.rate,
                          tenants=args.tenants, priorities=args.priorities,
                          deadline_slack=tuple(args.deadline_slack),
                          dup_rate=args.dup_rate,
                          base_phases=args.base_phases,
                          tail_alpha=args.tail_alpha,
                          max_phases=args.max_phases)
    state = stream = None
    if args.resume_from:
        # a fresh carry of the same flags is the template: the serving
        # books (deadline misses, per-tenant counts) ride the carry
        tenants = max(args.tenants, len(quotas) if quotas else 0)
        pool = runner.pack_jobs([r.events for r in reqs],
                                content_keys=True)
        like = (runner.init_batch_device(),
                runner.init_stream(
                    pool, args.results_capacity, tenants=tenants,
                    tenant_quota=(list(quotas)
                                  + [0] * (tenants - len(quotas))
                                  if quotas else None)))
        (state, stream), meta = load_state(args.resume_from, like,
                                           delay=runner.delay)
        print(f"resumed from {args.resume_from} at {meta}", file=sys.stderr)
    telemetry = TelemetryWriter(args.telemetry) if args.telemetry else None
    try:
        state, stream, report = serve_run(
            runner, reqs, policy=args.serve_policy, quotas=quotas,
            stretch=args.stretch, drain_chunk=args.drain_chunk,
            results_capacity=args.results_capacity, state=state,
            stream=stream, checkpoint=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            kill_after_saves=args.kill_after_saves,
            telemetry=telemetry,
            telemetry_interval=args.telemetry_interval,
            exec_cache=(ExecutableCache(args.exec_cache)
                        if args.exec_cache else None))
        if report["killed"]:
            # the preemption drill: stop right after that many saves
            print(json.dumps({"killed_after_steps": report["steps"],
                              "checkpoint": args.checkpoint}))
            return 17
        rows = runner.stream_results(stream)
        if telemetry is not None:
            for r in rows:
                telemetry.write("serve_job", r)
    finally:
        if telemetry is not None:
            telemetry.close()
    row = runner.summarize_stream(stream)
    row.update(report)
    row.update({"graph": args.graph, "nodes": runner.topo.n,
                "batch": args.batch, "rate": args.rate,
                "dup_rate": args.dup_rate, "scheduler": args.scheduler,
                "serve_policy": args.serve_policy})
    errored = [r for r in rows if r["error"]]
    row["jobs_errored"] = len(errored)
    if errored:
        row["job_errors"] = {r["job"]: r["errors_decoded"]
                             for r in errored[:16]}
    if guards is not None:
        row["guards"] = guards.books()
    if args.telemetry:
        row["telemetry"] = args.telemetry
    print(json.dumps(row))
    return 0 if not errored else 1


COMMANDS = {"storm": storm_run, "bench": bench_main, "stream": stream_run,
            "serve": serve_cmd, "run": run_cmd, "test": golden_test,
            "trace": trace_run}

if __name__ == "__main__":
    args = sys.argv[1:]
    if not args or args[0] not in COMMANDS:
        sys.exit("usage: python -m chandy_lamport_tpu_torch "
                 "{storm,bench,stream,serve,run,test,trace} [flags] (see "
                 "<command> --help)")
    sys.exit(COMMANDS[args[0]](args[1:]))
