#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (chandy_lamport_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``chandy_lamport_tpu_torch/
kernels/csrc`` (one nvcc per source, in parallel), then runs sixty-one
phases,
each printing one JSON line (a phase's with ``elapsed_s``, the
seconds since the start):

  device       nvidia-smi's name and power limit, torch / CUDA versions,
               the build seconds;
  kernels      each kernel wrapper at the shapes of each main path that
               runs it — the bench's config 4 (sf-1024, B=2048, S=8, C=16)
               for the sync storm, the exact-at-scale cell (er-256, B=4096,
               S=8, C=24) for the exact storm and the faulted exact storm —
               on inputs from a real storm state of that path plus seeded
               edge cases (ring wrap, full ring, marker at head, empty ring
               with a stale slot, a head due now beside one due next tick,
               several eligible edges per source, a source with every or
               no edge eligible after the fault gates, a lane with nothing
               eligible, partially active rows, overflow rows, a marker
               broadcast routed by append_marker_rows), and append_rows
               at 131,072 lanes of ring-10: the
               CUDA kernel must equal its plain PyTorch version on the card
               bit for bit (tolerance: none, integer work), with times.
               The segment sums (sum_by_perm at the sync arrivals and
               credits shapes, both main rows, and at the exact credits;
               sum_segments at the send debits) also get ``device_ms``
               (torch.profiler's kernel time per call) and ``host_us``
               (the wrapper's host time per call), each beside
               index_add_'s, and are held to their plain versions on
               edge cases (``segment_edge_cases``: the tiled path, the
               switch at the shared-memory limit, empty segments, a
               2,000-edge segment, R = 0, unaligned rows and tables, the
               int32 wrap); the wave tick's shapes too (sum_by_perm of its
               stacked [B, 5, E] per-wave facts, spread of its node flags);
               queue_step and select_pop also on the source layouts no
               real cell has (``select_edge_cases``: a 2,500-edge source
               past a block's tile, segments across every boundary the
               grid draws, sources of out-degree 0, E below 32 and off
               every multiple of 32, one lane, no edges);
  fused_kernel fused_scan (the fused megatick) at the exact cell's shape —
               one drain megatick (K=8) from the state after its 32 storm
               phases, fault-free and faulted (the fault_storm cell's
               adversary and supervisor) — and on small edge cases (ring
               wrap, capacity-1 rings, a single-edge graph, lanes going
               quiet mid-megatick, a lane not live at launch, an errored
               lane under quarantine, the fixed, hash and Go-exact
               samplers, the three step bodies; and the fault arm's: a
               disarmed lane (key 0), classes at rate 0 and 1, retries,
               crashes that never let a lane go quiet, lossy restarts with
               and without a completed snapshot, the daemon, the timeout
               alone, ERR_SNAPSHOT_TIMEOUT set mid-megatick under
               quarantine, duplicates re-appended into full rings, a clock
               wrapping past 2^31 - 1; and slice 17's: the threefry
               sampler, fault-free and under marker faults, and uint16
               window planes, fault-free, from counters one below 2^16,
               and under every fault class), each again through the wave where
               the sampler is position-addressable, with the wave's own (a
               marker pile-up with a same-tick repeat on a complete
               digraph, hash counters wrapping inside a tick): bit-equal
               to its plain version (untraced, the cascade and the wave
               run one destination-owned marker step, the Go-exact
               sampler through its pre-drawn buffer),
               timed per launch; its bound counts the bytes the kernel's
               design must move and the fault hash's integer operations,
               from the megatick's own steps (``fused_plain_and_bytes``).
               The wave's drain megaticks (fault-free and
               faulted) are timed and bound the same way, and each of the
               four drain megaticks again in the tiled layout (forced,
               ``fused_tile="on"``: the working planes in a device-memory
               workspace) on the same input, bit-equal to
               the same plain result (``tiled_over_resident``).
               The fault-hash check: ``fault_hash_planes`` (the kernel's
               device hash writing the JAX ``_fault_planes`` layout) equals
               ``Faults.fault_planes`` at tick times 0, 1, 31, 32, 2^20 and
               2^31 - 1 (and on past the int32 wrap);
  tiled_edge_cases the edge cases of fused_kernel through the tiled
               layout (forced, ``fused_tile="on"``), launched beside the
               resident ones against the same plain runs, bit-equal to
               the plain version, all four tiled instantiations (cascade and wave,
               with and without the fault arm) among them;
  trace_kernel fused_scan's recorder arm (the flight recorder inside the
               step, the kernel's ``kTrace`` instantiations) on the four
               drain megaticks of fused_kernel, traced at the default
               capacity (4,096 slots a lane), resident and tiled: bit-equal
               to the traced plain version (the ring included), timed per
               launch beside the untraced arm's time in this run and
               beside its bound (the untraced one plus 12 B an event
               written);
  trace_edge_cases fused_kernel's edge cases traced at 4,096 slots and at
               8 (a step's events pass the ring, which wraps inside one
               append), each launched resident and tiled against one
               plain run: every leaf equal, all eight traced
               instantiations among them;
  window16_sync_storm, window16_sync_vs_int32, window16_kernel,
  window16_fused_storm, window16_fused_vs_int32, window16_counter_wrap
               main paths 27-28, ``window_dtype="uint16"`` on the card:
               config 4's sync storm and the exact cell at megatick 8 with
               uint16 window planes, each against its int32 twin (every
               other leaf equal, every window equal modulo 2^16, two
               lanes' windows decoded equal); row 8's uint16 arm at the
               exact cell's drain megatick, resident and forced tiled,
               bit-equal to the plain form and timed beside the int32
               arm; a synthetic wrap (256 lanes from counters 3 below
               2^16, against int32) and its uint16 checkpoint saved and
               loaded bit-equal;
  storm        main path 1: the config-4 sync storm through
               ``BatchedRunner.run_storm`` on the card: zero error bits,
               every snapshot complete, conservation delta 0, and every
               kernel of the path launched during the run (launch counts
               are zeroed just before it);
  fault_sync_storm main path 18: config 4's sync storm under the
               faulted exact cell's adversary (below), its supervisor
               (timeout 64) and quarantine (``config4_runner(faulted=
               True)``, the JAX storm CLI's default scheduler under
               faults): first rows 1 and 3-5 against their plain versions
               on its own operands 8 phases in (the crash gate's spread
               of the down nodes, the closed windows' sum_by_perm, the
               faulted rings' heads, the duplicates' append_rows), then a
               warm run at 256 lanes and the timed run at B=1,024 (cut
               from config 4's 2,048 for the smoke's time), judged
               by the faulted rule (conservation delta 0, no bit but
               ERR_SNAPSHOT_TIMEOUT, every snapshot of a clean lane
               complete); rows 1-5 launched, rows 6-8 never; its wall,
               node-ticks/s, fault events, skew, lifecycle and
               quarantined lanes;
  checkpoint   ``utils/checkpoint`` on the card: fault_sync_storm (at
               256 lanes, against its own uninterrupted run) and the
               faulted ER-256 storm at megatick 8 (2,048 lanes; both cut
               for the smoke's time), each run again in
               chunks of 16 phases with a save after each, resumed from
               disk after the first by a fresh runner (the megatick-8
               one's drain in fused_scan), every leaf equal to the
               uninterrupted run; each file's bytes, the saves' and the
               load's seconds (in a temporary directory it removes);
  exact_storm  main path 2: the exact-at-scale cell through
               ``BatchedRunner(scheduler="exact").run_storm``, with the
               same checks, on its first 2,048 lanes (``M1_BATCH``, cut
               for the smoke's time: a lane's streams depend on its index
               alone, so its twins are held to it on those lanes);
  fused_storm  main path 4: the same cell at megatick 8
               (``BatchedRunner(scheduler="exact", megatick=8)``, the JAX
               storm CLI's default): the storm phases tick one at a time,
               the drain and flush run through fused_scan. The same checks,
               fused_scan launched, queue_step launched once per storm
               phase only, and a final state equal to exact_storm's leaf
               for leaf;
  wave_storm   main path 7: the exact cell with ``exact_impl="wave"`` at
               megatick 1 (one host step per wave): exact_storm's checks,
               spread launched, its final state equal to exact_storm's
               leaf for leaf, and its host steps beside the cascade's;
  wave_fused_storm main path 8: the same at megatick 8 (the drain and
               flush through fused_scan's wave arm): fused_storm's checks
               and its final state equal to fused_storm's;
  fault_storm  main path 3: the same cell under the fault adversary, the
               snapshot supervisor and quarantine (``Faults(3, ...)``
               below, ``snapshot_timeout=64``) through
               ``BatchedRunner(scheduler="exact", faults=..., quarantine=
               True).run_storm`` (warm run at a smaller batch, timed run on
               the cell's first 2,048 lanes, as exact_storm): every fault
               class fired, the supervisor retried,
               conservation delta 0, no bit but ERR_SNAPSHOT_TIMEOUT, every
               snapshot of every clean lane complete, every kernel of the
               path launched and queue_step never;
  fault_fused_storm main path 6: the same faulted cell at megatick 8
               (``BatchedRunner(..., faults=..., quarantine=True,
               megatick=8)``, the JAX storm CLI's default): the phases tick
               one at a time, the drain and flush run through fused_scan
               with the adversary and the supervisor inside. fault_storm's
               checks, and its final state equal to fault_storm's leaf for
               leaf, fused_scan launched, queue_step never, and no host
               fold step in the drain and flush;
  fault_wave_fused_storm main path 9: the faulted cell with the wave at
               megatick 8 (fused_scan's faulted wave arm in the drain):
               fault_fused_storm's checks and its final state equal to
               fault_fused_storm's;
  tiled_vs_resident fused_storm, wave_fused_storm, fault_fused_storm and
               fault_wave_fused_storm rerun in the tiled layout (forced):
               every fused_scan launch tiled, each final state equal to
               its resident twin's leaf for leaf;
  trace_fused_storm, trace_wave_fused_storm, trace_fault_wave_fused_storm
               main paths 12-14: fused_storm, wave_fused_storm and
               fault_wave_fused_storm with the flight recorder armed
               (``trace=Trace()``, 4,096 slots a lane): clean, the
               recorder arm launched, every leaf equal to the traced
               megatick-1 twin (on its first 2,048 lanes, where the twin
               runs), every leaf but the ring equal to the
               untraced run of this call; ``trace_events``,
               ``trace_dropped``, ``trace_overhead_pct`` (the wall against
               the untraced run's) and the ring's events by kind;
  sf2048_tiled_cascade_storm an oversized cascade lane: SF-2048 at S=8
               (B=256, 16 phases, 1 snapshot) at megatick 8, tiled by
               "auto", fault-free and under fault_storm's adversary less
               its marker drops (no supervisor): clean, and equal to the
               same storm at megatick 1 through the wave leaf for leaf;
  config5_wave_fused_storm main path 10: config 5 (SF-8k, N=8,192,
               E=24,572, B=512, 16 phases, 8 snapshots; the JAX
               measurement plan's exact wave row) at megatick 8, its lane
               (1,671,200 B) tiled by "auto": error bits 0, every snapshot
               complete, conservation delta 0, fused_scan launched in the
               tiled layout, equal to the same storm at megatick 1 leaf
               for leaf; its wall, node-ticks/s, host waves, tiled
               launches and workspace bytes; then one of its drain
               megaticks against the plain version, timed, beside its
               bound;
  trace_config5_wave_fused_storm main path 15: config 5 traced: clean,
               the tiled recorder arm launched, every leaf but the ring
               equal to config5_wave_fused_storm's;
  stream_kernel fused_scan's lane gate on the streaming engine's own
               inputs: the streaming cell (below) driven until its queue
               runs dry, then the first step that runs both a drain slice
               and a flush is captured (lanes in the script, the drain,
               the flush and idle); its gated drain megatick (``live`` =
               the lanes in their drain, each job's absolute limit) and
               its gated flush, resident and again through a forced-tiled
               runner, bit-equal to the plain version; the drain
               megatick timed per launch beside its bound;
  stream_exact main path 11: the streaming cell, the JAX bench's
               ``--stream`` row on the exact cell at full width (ER-256,
               B=4096, J=6,144 jobs (the row's 12,288, cut for the
               smoke's time) of ``stream_jobs(seed=17,
               base_phases=4, tail_alpha=1.1, max_phases=32)``, S=8,
               stretch 4, drain chunk 32) through ``run_stream`` at
               megatick 8 (its drain slices and flushes in fused_scan):
               every job retires with error 0; stream and gang admission
               give equal job rows; every row equals its megatick-1
               twin's (the same queue through the wave at megatick 1),
               and a queue of 4,096 jobs of at most 8 phases at the
               same width gives the same rows through the cascade at
               megatick 8 and megatick 1; 32 sampled jobs each equal the
               same job run alone
               through ``run``; fused_scan, queue_step,
               append_marker_rows and sum_by_perm launched, sum_segments
               and select_pop never;
               wall, jobs/s, steps, occupancy, host fold steps and
               launches of each drive, and ``speedup_vs_static``;
  stream_wave  the same through the wave (B=1,024, J=3,072): stream
               against gang, its megatick-1 twin and 16 sampled static
               runs;
  stream_fault the wave stream under fault_storm's adversary armed on
               every third job, with its supervisor and quarantine
               (B=512, J=768): no bit but ERR_SNAPSHOT_TIMEOUT, stream
               against gang, its megatick-1 twin and 16 sampled static
               runs;
  stream_sync  the sync scheduler's stream on config 4's graph (SF-1k,
               B=512, J=1,536), stream against gang and 16 sampled static
               runs (the sync scheduler has no megatick);
  trace_stream main path 16: stream_wave traced: every row equal to the
               untraced stream's, the recorder arm launched in its drain
               slices and flushes, its lane admits and harvests in the
               rings (a lane whose ring did not wrap holds one harvest per
               admit);
  memo_stream  main path 19: the streaming cell's queue, cut to J=6,144
               (of 12,288) for the smoke's time, at
               the README's 80 % duplicate shape, packed once with
               content keys, through memo "off", "full" (a cold
               summary-cache file in a temporary directory) and a warm
               "admit" on that file: every row of both memo arms equal
               to the off arm's (digest and provenance aside), the
               kernels of stream_exact's path launched by every arm;
               cache hits, coalesced jobs, fast-forwarded ticks, shadow
               checks, steps, wall and effective jobs/s of each arm, the
               host seconds of the memo stages, and the signature's
               device ms a step (CUDA events, the full arm's final
               state);
  prefix_stream main path 20: the same cell at prefix overlap 0.75, J
               cut to 1,024, memo "prefix" against "off" on the
               prefix-packed pool: rows equal, forked jobs equal to the
               planned ones and above 0; the mean fork depth, the bank's
               rows and bytes, the producer's seconds and the fork
               audit's count;
  serve_edf    main path 29: the serve loop (``serving.serve_run``) on
               the streaming cell (ER-256, B=4,096, the exact cascade at
               megatick 8, row 8's gated stream drain): J = 1.5 x B
               requests (the CLI's 3 x B, cut for the smoke's time) of
               the JAX serve CLI's traffic (4 Zipf tenants, 2
               priority classes, deadline slack 64-256, no duplicates)
               arriving at twice the jobs a step stream_exact's drive
               retired (printed with its derivation); an edf arm through
               a cold ``ExecutableCache`` and a fifo arm through a
               restarted one over the same directory, armed
               (``RuntimeGuards()``: the sync debug mode "error"): 32
               sampled rows equal their solo runs, the fifo rows the edf
               rows less ``admit_step``, ``deadline_misses`` and
               ``tenant_served`` the harvests read back after each step,
               fused_scan launched and its plain form never called, the
               restarted cache's source "disk" with no nvcc run, the
               armed arm's books with no kernel build; served jobs/s,
               admit p50/p99, misses, occupancy and the cold and warm
               warmups;
  serve_memo_quota main path 30: the sync scheduler (the serve CLI's
               default) on the same graph and batch, J cut to 4,096 at
               duplicate rate 0.8, under quotas, over a summary-cache
               file a serve of its first 1,024 requests warmed: the
               cache-served count and the per-tenant refusals equal
               ``plan_ingest``'s plan, every follower row its leader's,
               every cache-served row the file's entry;
  fleet        main path 31: the serving fleet (``serving.fleet_run``) at
               the JAX bench's ``--fleet`` cell (``FL_*``: ring-1024,
               2,048 lanes, the sync scheduler, hash delay, 8 snapshots,
               stretch 4, drain chunk 32; ``serve_workload(seed=17,
               rate=2.0, tenants=4, priorities=2, max_phases=32)`` at
               duplicate rate 0.5), the requests cut in depth to the
               first 2 of the bench trace's most requested content, the
               lease 360 s; 2 spawned workers on the card, each cold
               request a singleton stream drive. Arm A, clean, alone on
               the card: none lost or double-served, digests intact, no
               takeover or death, some served from the shared summary
               cache. Then arms B (the bench's crash schedule: a death
               and a restart, the audit balanced) and C (the in-flight
               takeover: a takeover, none lost or double-served) on the
               same requests over a copy of arm A's summary cache,
               beside the content's solo run here on the card. Every row
               of every arm equals the solo run, and B's and C's their
               arm-A rows; served jobs/s, latency p50/p99, the books of
               each arm and of each worker, the solo run's seconds, ticks
               and launches; the path's launches are arm A's workers'
               (their books);
  host_surface main path 32: the 7 goldens through ``run --trace`` on
               ``--backend torch`` (the card, megatick 8) and ``--backend
               parity``: equal stdout and equal stderr (the device
               recorder's timeline is the oracle's ``EpochTrace``);
               ``test --backend parity`` 7 of 7; the card's sync storm on
               ring-8 and ER-16 equal to ``SyncOracle``; the exact
               cell's cascade and wave storms (B=512, megatick 8) with
               no ``dense_state_mismatches``;
  golden       main path 5: the 7 reference goldens (21 snapshots)
               through the port's ``run_events_file`` on the card
               (``DenseSim`` at its default megatick 8), each snapshot
               equal to its ``.snap`` file (read from
               chandy_lamport_tpu/data/test_data), fused_scan launched in
               every case;
  trace_golden main path 17: the 7 goldens traced (``run_events_file(...,
               trace=True)``, megatick 8): every snapshot equal to its
               .snap file, the recorder arm launched in every case, the
               timeline (``sim.trace.pretty()``) and the ring equal to the
               card's megatick-1 traced run;
  uniform_sync_storm, uniform_kernel, uniform_fused_storm main paths
               25-26, the threefry sampler (``UniformDelay(17)``): config
               4's sync storm, clean with every snapshot complete; the
               exact cell at 2,048 lanes (cut from 4,096 for the smoke's
               time) at megatick 8, its drain megatick through row
               8's threefry kind bit-equal to the plain form and timed
               beside the hash arm, and the storm itself;
  dense_faults_golden, dense_faults_script main paths 21-22,
               ``DenseSim(faults=)``: the 7 goldens under the zero-rate
               ``Faults(7)`` at megatick 8 (fused_scan's fault arm in each),
               each equal to its .snap; an ER-256 event script under the
               faulted cell's program, single-instance, through the
               kernel at megatick 8, its plain form (``fused_tick="off"``)
               and megatick 1, every leaf equal;
  fold_golden, fold_storm, fold_vs_cascade main paths 23-24, the fold
               (``exact_impl="fold"``): the 7 goldens at megatick 8 (K
               single fold ticks; append_marker_rows in each), and the
               exact cell cut to 4 phases and 1 snapshot, equal to the
               cascade's storm leaf for leaf; ms per fold tick and row-5
               launches per tick;
  graphshard_giant_fixed, graphshard_giant_uniform main path 33, graph
               sharding at scale: ``scale_free(1_048_576, 2, seed=3)``
               (E=3,145,723) over 4 shards stacked on the card (the sparse
               exchange, megatick 4) under the bench's storm (32 phases, 8
               snapshots, C=16, L=32, int16 log): under ``fixed_delay=2``
               its ``gather_dense`` equals the unsharded sync runner's
               final state (B=1) leaf for leaf on every field it fills;
               under the per-shard threefry streams (seed 17, the
               conservation check every 8 phases) error 0, every snapshot
               complete, frozen + recorded equal to the tokens; rows 1-5
               launched, rows 6-8 never; wall, ticks, ms a tick,
               node-ticks/s, the cut, the halo, ``comm_bytes_model``, peak
               bytes; rows 4-5 at the stacked [4, Em, 16] rings bit for bit
               against their plain versions, timed beside their bounds, and
               rows 1-3 at the exchange's shapes beside index_add_ /
               index_select;
  graphshard_row_sparse, graphshard_row_dense, graphshard_row_sparse_vs_dense,
  graphshard_lanes_fixed, graphshard_lanes_uniform main path 34, the JAX
               bench's graphshard row (sf-1024 over 8 shards, megatick 4,
               seed 17): both engines, their de-sharded finals equal; the
               data x graph mode, 256 lanes x 4 shards of the same graph:
               under the fixed delay every lane equals the single-instance
               run, under the per-(lane, shard) streams every lane clean,
               complete and conserved;
  graphshard_dist_gloo, graphshard_dist_nccl main path 35, the dist
               backend on the card: two spawned processes on the one card
               over gloo (the exchanged rows staged through host memory),
               P = 2 over sf-1024, both engines under the fixed delay, each
               process's shard equal to the stacked run's on the card; NCCL
               at world size 1 (P = 1) equal to stacked P = 1 (NCCL beyond
               one process is not checked: one card, and NCCL does not put
               two processes on one device); the processes' launches;
  cpu_vs_cuda  small sync, exact, faulted exact and megatick-8 exact storms
               (4 lanes of sf-64; the faulted one with lossy crashes at a
               fixed window,
               marker drops and the supervisor with its daemon, at
               megatick 1 and 8), the wave's at megatick 8, faulted
               and not, and a faulted sync storm (every class, lossy
               crashes, the supervisor and its daemon, quarantine), on
               the card and on the CPU (plain versions): every state leaf
               identical; and a small faulted sync stream checkpointed,
               killed after its first save and resumed, each file (the
               card's and the CPU's) on both devices, every leaf of the
               state and the stream equal to the uninterrupted run; and
               a ring-8 exact stream at megatick 8 under memo "admit",
               "full" and "prefix" (every served job shadowed), every
               leaf and every row (digests included) equal between the
               card and the CPU; and a ring-8 exact serve at megatick 8
               under edf with quotas over a warm summary cache, killed
               after its first save on each device and each file resumed
               on both, every leaf and row equal to the uninterrupted
               CPU run.

Then, on lines of their own: nvidia-smi's name/power-limit line, one
``{"kernels": [...]}`` summary (rows 1-5 add ``graphshard_shapes``,
their times at the giant graphshard cell's shapes; the segment sums'
entries add the device
and host times and a ``shapes`` list of every timed shape; fused_scan's
a ``shapes`` list of its fault-free and faulted drain megaticks, cascade
and wave, resident and tiled, untraced and traced, and config 5's,
``launches_tiled``, ``launches_traced`` (by path too),
``traced_arms``, each traced drain megatick beside the untraced one, and
``arms``, the threefry and uint16 drain megaticks beside the hash and
int32 ones;
spread's a ``shapes`` list of its timed shapes, each with its device
and host time beside index_select's and both timed in turns,
``in_turns``), and last
``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero with no result line; without CUDA
it exits 2 before doing anything.

    python3 chip_smoke.py --drain-timing CELL [CELL ...] \
        [--batch B] [--package-root DIR]

times one drain megatick (K=8) of each CELL, in order: the exact or the
faulted exact cell (``fault-free``, ``faulted``; ``wave``,
``wave-faulted`` through the wave; suffix ``-tiled``: in the tiled
layout, forced), the exact cell under the threefry sampler
(``threefry``) or with uint16 windows (``uint16``), config 5's tiled
wave lane (``config5-wave``); suffix
``-traced`` (after ``-tiled`` where both): the recorder arm, the flight
recorder armed at 4,096 slots; ``--batch``: that many lanes instead of
the cell's. It prints one JSON
line a cell, nothing else, with the lane-ticks and the time per
lane-tick; ``--package-root`` imports the package from another checkout
(a parent commit unpacked into a gitignored directory), so parent and
change are timed in turns in one call.

    python3 chip_smoke.py --append-timing [--package-root DIR]

times ``append_rows`` at its three shapes (the sync and exact token
sends, the exact marker broadcast): the kernel's device time (profiler),
the wrapper's and its caller's host time and the caller's device time
(``TickKernel._append_rows``, for the broadcast ``_broadcast_markers``),
5 rounds each, and prints one JSON line, nothing else; with
``--package-root`` the package (and its API) is another checkout's.

    python3 chip_smoke.py --ptxas [--package-root DIR]

compiles each CUDA source of the package to a cubin with its build flags
and ``-Xptxas -v`` and prints one JSON line a source: nvcc's seconds and
each kernel's registers, spills and stack frame.

    python3 chip_smoke.py --queue-timing [--package-root DIR]

times ``head_fields`` at the sync and faulted shapes, ``queue_step`` at
the exact one and config 5's, and ``select_pop`` at the faulted one
(``queue_cases``): each held to its plain version, then
event ms, profiler device ms and host us per call, 5 rounds each, beside
its bound (each gathered word a 32-byte sector), one JSON line, nothing
else.

    python3 chip_smoke.py --spread-timing [--package-root DIR]

times ``spread`` against ``index_select`` at the faulted crash gate's
shape in turns (event ms and host us per call, ``in_turns``) and prints
one JSON line, nothing else.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks: HBM3 bytes/s (NVIDIA data sheet), and the rate of 32-bit
# integer operations, which is all the kernels of the port do: 132 SMs x 64
# per SM per clock (add, compare, logic, shift and multiply-add alike; the
# CUDA C++ guide's throughput table, compute capability 9.0) x the 1.98 GHz
# boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 132 * 64 * 1.98e9

# bench config 4 (README: ``python bench.py`` defaults)
NODES, ATTACH, BATCH, PHASES, SNAPSHOTS, DELAY_SEED = 1024, 2, 2048, 32, 8, 17
# the exact-at-scale cell: ``storm --scheduler exact --graph er --nodes 256
# --batch 4096 --phases 32 --snapshots 4``
X_NODES, X_BATCH, X_PHASES, X_SNAPSHOTS = 256, 4096, 32, 4
# the faulted exact path: the exact cell under this adversary, with the
# supervisor's first deadline 64 ticks after each (re-)initiation
F_TIMEOUT, F_WARM_BATCH = 64, 256
F_PROGRAM = dict(drop_rate=0.01, dup_rate=0.01, jitter_rate=0.01,
                 crash_rate=0.01, crash_mode="pause",
                 marker_drop_rate=0.0002, marker_dup_rate=0.01,
                 marker_jitter_rate=0.01)
# config 5 (BASELINE.md's SF-8k rung) as the JAX measurement plan's exact
# wave row (tools/r5_measure.py:334-338: ``--graph sf --nodes 8192 --batch
# 512 --phases 16 --snapshots 8 --scheduler exact --exact-impl wave``) at
# the JAX storm CLI's default megatick 8: its lane (1,671,200 B) tiles
C5_NODES, C5_BATCH, C5_PHASES, C5_SNAPSHOTS = 8192, 512, 16, 8
# the oversized cascade lane: SF-2048 at S=8 (386,960 B, 401,472 B
# faulted), at a batch and depth where its megatick-1 twin ends in about
# half a minute: its host fold steps follow the markers a lane pops, so
# one snapshot (S stays at for_workload's floor of 8), and the faulted
# cell's adversary without marker drops and the supervisor, whose 64-tick
# timeout on this graph exhausted the retries of 113 of 256 lanes and
# took the twin to 69,192 fold steps (231 s on the H100) at 2 snapshots
T_NODES, T_BATCH, T_PHASES, T_SNAPSHOTS = 2048, 256, 16, 1
T_PROGRAM = dict(F_PROGRAM, marker_drop_rate=0.0)
# cpu_vs_cuda's faulted sync storm (SF-64, B=8): every class at 0.02,
# lossy crashes from tick 70 (after its first snapshots completed) and
# rare marker drops, whose retries run out on 3 of its 8 lanes
# (ERR_SNAPSHOT_TIMEOUT, quarantined)
SMALL_SYNC_FAULTS = dict(drop_rate=0.02, dup_rate=0.02, jitter_rate=0.02,
                         crash_rate=0.5, crash_mode="lossy", crash_start=70,
                         marker_drop_rate=0.002, marker_dup_rate=0.02,
                         marker_jitter_rate=0.02)
# the streaming cell: the JAX bench's ``--stream`` row (bench.py:871; its
# recipe :541-547, :904-907) on the exact cell, ``storm --stream --graph er
# --nodes 256 --batch 4096 --scheduler exact --megatick 8``: J = 3 x B jobs
# of ``stream_jobs(seed=17, base_phases=4, tail_alpha=1.1, max_phases=32)``,
# 8 snapshot slots, stretch 4, drain chunk 32; 32 of its jobs are held to
# the same job run alone
ST_PHASES, ST_SNAPSHOTS, ST_STRETCH, ST_CHUNK = 32, 8, 4, 32
ST_SAMPLED = 64
# the wave and the faulted streams at a quarter and an eighth of the
# batch (J = 3 x B), 16 sampled jobs each; the sync stream on config 4's
# graph (SF-1k) at B=512, J=1,536
STW_BATCH, STF_BATCH, SS_BATCH, SMALL_SAMPLED = 1024, 512, 512, 16
# the streaming cell's cascade twin at megatick 1, cut in depth: J = 1 x B
# jobs of at most 8 phases at the cell's width and batch (the whole
# queue's cascade twin folds 30,954 host steps, 94-101 s on the H100; 2 x B
# took 27.3 s, cut to 1 x B for the slice-17 phases)
ST_TWIN_JOBS_PER_LANE, ST_TWIN_MAX_PHASES = 1, 8
# the steps after the queue runs dry in which the kernel check looks for
# one that runs both a drain slice and a flush
ST_CAPTURE_STEPS = 8
# the memo cells: the streaming cell's queue at the README's 80 %
# duplicate shape (memo_stream, J = MEMO_PER_LANE x B), and at prefix
# overlap 0.75
# (prefix_stream) with J cut to 1,024: at 4,096 (the bank near 0.18 GB on
# the card, the in-memory store ~1.33x that; one ER-256 lane at C=24 holds
# about 347 KB) its two drives took 61 s of the smoke, cut to 2,048 for the
# serve phases' time and to 1,024 for graph sharding's (slice 20)
MEMO_DUP, MEMO_OVERLAP, PREFIX_JOBS = 0.8, 0.75, 1024
# memo_stream's jobs a lane: the streaming cell's 3, cut to 1.5 (J 12,288
# -> 6,144) for the smoke's time (graph sharding's phases, slice 20)
MEMO_PER_LANE = 1.5
# the lane count of append_rows' lane-limit check (ring-10 sync storms run
# at this batch)
WIDE_LANES = 131_072

KERNELS = {
    # wrapper: (source, the Pallas function it replaces)
    "sum_by_perm": ("chandy_lamport_tpu_torch/kernels/csrc/segment.cu",
                    "chandy_lamport_tpu/kernels/segment.py:55"),
    "sum_segments": ("chandy_lamport_tpu_torch/kernels/csrc/segment.cu",
                     "chandy_lamport_tpu/kernels/segment.py:39"),
    "spread": ("chandy_lamport_tpu_torch/kernels/csrc/segment.cu",
               "chandy_lamport_tpu/kernels/segment.py:72"),
    "head_fields": ("chandy_lamport_tpu_torch/kernels/csrc/queue.cu",
                    "chandy_lamport_tpu/kernels/queue.py:63"),
    "queue_step": ("chandy_lamport_tpu_torch/kernels/csrc/queue.cu",
                   "chandy_lamport_tpu/kernels/queue.py:92"),
    "select_pop": ("chandy_lamport_tpu_torch/kernels/csrc/queue.cu",
                   "chandy_lamport_tpu/kernels/queue.py:119"),
    "append_rows": ("chandy_lamport_tpu_torch/kernels/csrc/queue.cu",
                    "chandy_lamport_tpu/kernels/queue.py:157"),
    # the marker broadcast's append, routed in the same launch (the JAX
    # _broadcast_markers routes its row, then calls append_rows)
    "append_marker_rows": ("chandy_lamport_tpu_torch/kernels/csrc/queue.cu",
                           "chandy_lamport_tpu/kernels/queue.py:157"),
    "fused_scan": ("chandy_lamport_tpu_torch/kernels/csrc/megatick.cu",
                   "chandy_lamport_tpu/kernels/megatick.py:432"),
}
# the megatick of main path 4 (the JAX storm CLI's default --megatick)
MEGATICK = 8
# the checkpoint phase's chunk: phases run between two saves
CK_CHUNK = 16
# the lanes of the checkpoint phase's faulted sync storm, whose every lane
# runs its retries out over ~970 ticks (~45 s at B=2048): 512 since the
# memo phases, 256 since graph sharding's (slice 20), for the smoke's
# time
CK_SYNC_BATCH = 256
# the lanes of main path 18's timed run, cut from config 4's 2,048 for the
# smoke's time (graph sharding's phases, slice 20): its ~970 ticks took
# 43.8 s at 2,048 lanes
FS_BATCH = 1024
# cut in depth for the same reason (slice 20): the checkpoint phase's
# faulted ER-256 storm (4,096 lanes before), the threefry cell of
# uniform_kernel / uniform_fused_storm (4,096 before; its plain drain
# megatick ~20 s there), the jobs a lane of stream_exact and stream_fault
# (3 before: J 12,288 -> 6,144 and 1,536 -> 768) and the lanes of
# cpu_vs_cuda's storms (8 before)
CK_EXACT_BATCH, U_BATCH, ST_PER_LANE, CV_BATCH = 2048, 2048, 1.5, 4
# the megatick-1 cascade storms exact_storm and fault_storm run the first
# M1_BATCH lanes of their 4,096-lane cell (a lane's streams depend on its
# index alone), and their megatick-8 and wave twins are held to them on
# those lanes; fault_storm took 61-85 s at 4,096
M1_BATCH = 2048
# launches averaged by --drain-timing
DRAIN_LAUNCHES = 10
# what split_times adds to a row
SPLIT_KEYS = ("device_ms", "host_us", "library_device_ms",
              "library_host_us")
# rounds of in_turns, and what it adds to a row
TURNS = 5
TURN_KEYS = ("ms_turns", "library_ms_turns", "vs_library",
             "host_us_turns", "library_host_us_turns")


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``elapsed_s``, the seconds
    since the script started (the smoke's time budget, by phase)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls
    after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20):
    """Device time of one call: the CUDA kernels that torch.profiler saw
    over ``reps`` calls after a warm one, summed over their names and
    divided by ``reps`` (None when it saw none); and those names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", 0)
            by_name[evt.key[:60]] = by_name.get(evt.key[:60], 0) + us
    total_us = sum(by_name.values())
    return (total_us / 1e3 / reps if total_us > 0 else None), sorted(by_name)


def host_us(fn, reps: int = 200) -> float:
    """Host time of one call: the wall time of ``reps`` calls enqueued
    back to back after a warm one, the device not waited for inside the
    window (so a call bound by its wrapper shows here, a slow kernel in
    ``device_ms``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def split_times(kernel_fn, library_fn) -> dict:
    """Device ms and host us per call of a kernel wrapper and of its
    library yardstick."""
    k_ms, k_names = device_ms(kernel_fn)
    times = {"device_ms": k_ms, "device_kernels": k_names,
             "host_us": host_us(kernel_fn)}
    if library_fn is not None:
        l_ms, l_names = device_ms(library_fn)
        times.update(library_device_ms=l_ms, library_kernels=l_names,
                     library_host_us=host_us(library_fn))
    return times


def in_turns(kernel_fn, library_fn, turns: int = TURNS) -> dict:
    """A kernel wrapper and its library call timed in turns, ``turns``
    rounds of ``time_ms`` and of ``host_us`` each, the kernel first: the
    four lists, the event times' medians as ``ms`` and ``library_ms``,
    and whether the kernel "leads" (every event reading below every
    library reading), "trails" (every one above) or the readings cross
    ("undecided")."""
    ms, lib, host, lib_host = [], [], [], []
    for _ in range(turns):
        ms.append(time_ms(kernel_fn))
        lib.append(time_ms(library_fn))
        host.append(host_us(kernel_fn))
        lib_host.append(host_us(library_fn))
    verdict = ("leads" if max(ms) < min(lib) else
               "trails" if min(ms) > max(lib) else "undecided")
    return {"ms": statistics.median(ms),
            "library_ms": statistics.median(lib), "ms_turns": ms,
            "library_ms_turns": lib, "vs_library": verdict,
            "host_us_turns": host, "library_host_us_turns": lib_host}


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the 32-bit integer rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def clones(tensors) -> tuple:
    """Copies of the state leaves an in-place kernel writes."""
    return tuple(t.clone() for t in tensors)


def append_work(rows: int, active: int, lanes: int,
                routed: bool = False) -> tuple:
    """(bytes, operations) an append must take: the [B, E] active mask
    read once (the row form), per active row its head, len, tok_pushed,
    receive time and payload read (4 B each), its two slot words each
    dirtying a 32-byte sector, its two counters written (4 B each), the
    lane's error word read and written; the routed form reads per lane
    its node, mask, payload and out-edge range instead of the mask.
    Operations: one a row for the mask, 20 an active row, 10 a lane."""
    per_lane = 8 + (17 if routed else 0)
    nbytes = rows + active * (5 * 4 + 2 * 32 + 2 * 4) + lanes * per_lane
    return nbytes, rows + 20 * active + 10 * lanes


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over every output (0 when bit-equal);
    raises when shapes or dtypes differ."""
    import torch

    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"kernel output {g.dtype} {tuple(g.shape)}"
                                 f" != plain {w.dtype} {tuple(w.shape)}")
        diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
    return err


def csr_by_dst(dst, n, dev):
    """(perm, lo, hi) of a by-destination CSR over edges whose heads are
    ``dst`` (numpy), laid out as DenseTopology's by_dst / dst_bounds, as
    views of one int32 tensor [perm | bounds]: lo starts 4E bytes in and
    hi 4 bytes after it, so the tables' starts are not 16-byte aligned."""
    import numpy as np
    import torch

    e = len(dst)
    both = torch.as_tensor(np.concatenate([
        np.argsort(dst, kind="stable"),
        [0], np.cumsum(np.bincount(dst, minlength=n))]).astype(np.int32),
        device=dev)
    return both[:e], both[e:e + n], both[e + 1:]


def segment_edge_cases(dev) -> list:
    """sum_by_perm and sum_segments (the same bounds, no perm) against
    their plain versions, bit for bit, on the shapes and inputs the main
    paths do not reach: the tiled path (an E past the staged limit, and a
    20,000-edge hub whose perm slice is past what a tiled block stages),
    the switch at exactly the shared-memory limit, nodes
    with no in-edges, a segment longer than 1,024, R = 0, and odd
    E with unaligned row starts on a view whose first row is not 16-byte
    aligned; the tables are unaligned views too (``csr_by_dst``), and
    int32 inputs span the full range, so the sums wrap."""
    import numpy as np
    import torch

    from chandy_lamport_tpu_torch.kernels import segment as ks

    rng = np.random.default_rng(11)

    def ints(shape):
        return torch.as_tensor(rng.integers(-2**31, 2**31 - 1, shape,
                                            dtype=np.int32), device=dev)

    def flags(shape):
        return torch.as_tensor(rng.random(shape) < 0.4, device=dev)

    hub = rng.integers(0, 300, 70_000)
    hub[rng.choice(70_000, 20_000, replace=False)] = 7
    long_seg = rng.integers(0, 1024, 3063)
    long_seg[:2000] = 5
    big_b, big_i = flags((65, 3063)), ints((65, 3063))
    cases = (
        # (note, x, edge heads, N, the paths sum_by_perm and sum_segments
        # must plan: the staged limit is lower with perm in shared memory)
        ("tiled: [16,40000] int32, N=5000", ints((16, 40_000)),
         rng.integers(0, 5000, 40_000), 5000, ("tiled", "tiled")),
        ("[6,70000] bool, a 20,000-edge hub", flags((6, 70_000)),
         hub, 300, ("tiled", "staged")),
        ("at the limit: [4,29040] int32, N=8 (no perm: 232,448 B)",
         ints((4, 29_040)), rng.integers(0, 8, 29_040), 8,
         ("tiled", "staged")),
        ("past the limit: [4,29041] int32, N=8", ints((4, 29_041)),
         rng.integers(0, 8, 29_041), 8, ("tiled", "tiled")),
        ("no in-edges on odd nodes: [64,3063] bool", flags((64, 3063)),
         2 * rng.integers(0, 512, 3063), 1024, ("staged", "staged")),
        ("a 2,000-edge segment: [32,3063] int32", ints((32, 3063)),
         long_seg, 1024, ("staged", "staged")),
        ("R = 0: [0,3063] bool", flags((0, 3063)),
         rng.integers(0, 1024, 3063), 1024, ("staged", "tiled")),
        ("odd E, a view at +3063 B: [64,3063] bool", big_b[1:],
         rng.integers(0, 1024, 3063), 1024, ("staged", "staged")),
        ("odd E, a view at +12252 B: [64,3063] int32", big_i[1:],
         rng.integers(0, 1024, 3063), 1024, ("staged", "staged")),
    )
    rows = []
    for note, x, dst, n, paths in cases:
        perm, lo, hi = csr_by_dst(dst, n, dev)
        for (name, has_perm), path in zip((("sum_by_perm", True),
                                           ("sum_segments", False)), paths):
            plan = ks.segment_plan(x.shape[0], x.shape[-1], n,
                                   x.element_size(), has_perm)
            if plan.path != path:
                raise AssertionError(f"{name} on {note} planned {plan}, "
                                     f"not the {path} path")
            if has_perm:
                got = ks.sum_by_perm(x, perm, lo, hi)
                want = ks.sum_by_perm_plain(x, perm, lo, hi)
            else:
                got = ks.sum_segments(x, lo, hi)
                want = ks.sum_segments_plain(x, lo, hi)
            err = max_abs_err([got], [want])
            if err:
                raise AssertionError(f"{name} != plain on {note}: max "
                                     f"|diff| {err}")
            rows.append({"kernel": name, "case": note, "path": plan.path,
                         "rows_per_group": plan.rows_per_group,
                         "smem_bytes": plan.smem_bytes,
                         "max_abs_err": err})
    return rows


# the selection's source layouts beside the real cells' (out-degree at
# most 8 on ER-256, 3 on SF-1k and SF-8k): out-degrees, 0 for a node with
# no out-edge, and the lanes. "long": a 2,500-edge source from edge 1,012
# (past a 1,024-edge tile, across three tile boundaries, leaving two
# blocks of the lane nothing to own), segments across edges 32, 256 and
# 768, E = 3,611 (no multiple of 32 or of a tile); "mid": E = 300, a
# 280-edge source across 256; "ragged": E = 13; "one-lane": B = 1, E = 45,
# a segment across 32; "empty": E = 0
SELECT_LAYOUTS = {
    "long": ([0, 30, 5, 0, 215, 12, 0, 500, 10, 240, 2500, 0]
             + [1, 4, 2, 3] * 9 + [2, 0, 3, 1, 0, 3], 3),
    "mid": ([3, 0, 280, 9, 8], 3),
    "ragged": ([0, 3, 0, 0, 6, 1, 3], 3),
    "one-lane": ([2, 31, 0, 12], 1),
    "empty": ([0, 0, 0], 2),
}


def select_inputs(degrees, lanes, capacity, seed):
    """numpy operands of queue_step and select_pop on a source layout
    (``degrees``: each node's out-degree): (q_meta, q_data, q_head, q_len,
    time, elig, src_first, src_lo, src_hi). Lanes cycle through three
    regimes: every edge eligible (a head due now on every non-empty ring
    beside empty rings whose stale slot looks due), the frozen clock
    -2^31 (nothing eligible), random rings with about half the heads due;
    ``elig`` (select_pop's) is every edge, none, and 40 % at random."""
    import numpy as np

    from chandy_lamport_tpu_torch.core.state import pack_meta

    rng = np.random.default_rng(seed)
    deg = np.asarray(degrees, np.int64)
    bounds = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    src = np.repeat(np.arange(len(deg)), deg)
    e, c = len(src), capacity
    time = rng.integers(10, 1000, lanes).astype(np.int32)
    rt = time[:, None, None] + rng.integers(-3, 4, (lanes, e, c))
    q_head = rng.integers(0, c, (lanes, e)).astype(np.int32)
    q_len = rng.integers(0, c + 1, (lanes, e)).astype(np.int32)
    elig = rng.random((lanes, e)) < 0.4
    regime = np.arange(lanes) % 3
    rt[regime == 0] = time[regime == 0, None, None]
    time[regime == 1] = -2**31
    elig[regime == 0], elig[regime == 1] = True, False
    q_meta = pack_meta(rt, rng.random((lanes, e, c)) < 0.25)
    q_data = rng.integers(-99, 100, (lanes, e, c))
    return (q_meta.astype(np.int32), q_data.astype(np.int32), q_head, q_len,
            time, elig, bounds[src], bounds[:-1], bounds[1:])


def select_edge_cases(dev) -> list:
    """queue_step and select_pop against their plain versions, bit for
    bit, on ``SELECT_LAYOUTS``: segments longer than a block's tile,
    across every boundary the grid draws, sources of out-degree 0, E
    below 32 and off every multiple of 32 and of the tile, one lane, no
    edges; on each, lanes of every edge eligible, of none (queue_step:
    the frozen clock) and random ones, and empty rings whose stale head
    word ``head_data`` must carry."""
    import torch

    from chandy_lamport_tpu_torch.kernels import queue as kq

    rows, c = [], 24
    for i, (name, (degrees, lanes)) in enumerate(SELECT_LAYOUTS.items()):
        q_meta, q_data, q_head, q_len, time, elig, first, lo, hi = (
            torch.as_tensor(x, device=dev)
            for x in select_inputs(degrees, lanes, c, seed=40 + i))
        for kernel, got, want in (
                ("queue_step",
                 kq.queue_step(q_meta, q_data, q_head, q_len, time, first,
                               lo, hi, capacity=c),
                 kq.queue_step_plain(q_meta, q_data, q_head, q_len, time,
                                     first, capacity=c)),
                ("select_pop",
                 kq.select_pop(q_head, q_len, elig, first, lo, hi,
                               capacity=c),
                 kq.select_pop_plain(q_head, q_len, elig, first,
                                     capacity=c))):
            err = max_abs_err(list(got), list(want))
            if err:
                raise AssertionError(f"{kernel} != plain on the {name} "
                                     f"layout: max |diff| {err}")
            rows.append({"kernel": kernel, "layout": name,
                         "lanes": lanes, "edges": int(first.numel()),
                         "longest_segment": max(degrees),
                         "selected": int(got[0].sum()
                                         + (got[1].sum() if kernel
                                            == "queue_step" else 0)),
                         "max_abs_err": err})
    return rows


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def config4_runner(device, faulted=False, batch=BATCH, delay=None,
                   **cfg_kw):
    """The sync storm of config 4; ``faulted``: under the faulted exact
    cell's adversary and supervisor (``F_PROGRAM``, ``F_TIMEOUT``),
    quarantined (main path 18); ``delay``: a sampler in place of the hash
    one; ``cfg_kw``: more config fields (``window_dtype``)."""
    from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
    from chandy_lamport_tpu_torch.models.faults import Faults
    from chandy_lamport_tpu_torch.models.workloads import (
        scale_free,
        staggered_snapshots,
        storm_program,
    )
    from chandy_lamport_tpu_torch.ops.delay import HashDelay

    spec = scale_free(NODES, ATTACH, seed=3, tokens=PHASES + 10)
    cfg = SimConfig.for_workload(
        snapshots=SNAPSHOTS, split_markers=True, record_dtype="int16",
        snapshot_timeout=F_TIMEOUT if faulted else 0, **cfg_kw)
    runner = BatchedRunner(spec, cfg, delay or HashDelay(DELAY_SEED), batch,
                           scheduler="sync", device=device,
                           faults=Faults(3, **F_PROGRAM) if faulted else None,
                           quarantine=faulted)
    prog = storm_program(
        runner.topo, PHASES, 1,
        staggered_snapshots(runner.topo, SNAPSHOTS, 1, 2,
                            max_phases=PHASES))
    return runner, prog


# the fused megatick in the tiled layout whatever the lane's size (a
# ValueError where the fused megatick cannot run): on a lane that fits a
# block, how the tiled arm is held against the resident one
TILED = dict(fused_tick="on", fused_tile="on")


def exact_runner(device, batch=X_BATCH, nodes=X_NODES, phases=X_PHASES,
                 snapshots=X_SNAPSHOTS, graph="er", faults=None, megatick=1,
                 exact_impl="cascade", tiled=False, trace=None, memo="off",
                 memo_cache=None, delay=None, **cfg_kw):
    """The exact-at-scale cell as the bench builds it (defaults), or a
    smaller exact storm; with ``faults`` (and supervisor knobs in
    ``cfg_kw``) the faulted exact storm, quarantined; ``megatick`` > 1
    the fused megatick's path (in the tiled layout whatever the lane's
    size with ``tiled``: ``fused_tile="on"``); ``exact_impl`` the tick's
    form; ``trace`` (utils/tracing.Trace) arms the flight recorder;
    ``memo`` / ``memo_cache`` the stream's memo plane; ``delay`` a sampler
    in place of the hash one."""
    from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
    from chandy_lamport_tpu_torch.models.workloads import (
        erdos_renyi,
        scale_free,
        staggered_snapshots,
        storm_program,
    )
    from chandy_lamport_tpu_torch.ops.delay import HashDelay

    spec = (erdos_renyi(nodes, 3.0, seed=3, tokens=phases + 10)
            if graph == "er" else
            scale_free(nodes, ATTACH, seed=3, tokens=phases + 10))
    cfg = SimConfig.for_workload(snapshots=snapshots, record_dtype="int16",
                                 **cfg_kw)
    runner = BatchedRunner(spec, cfg, delay or HashDelay(DELAY_SEED), batch,
                           scheduler="exact", device=device, faults=faults,
                           quarantine=faults is not None, megatick=megatick,
                           exact_impl=exact_impl, trace=trace, memo=memo,
                           memo_cache=memo_cache, **(TILED if tiled else {}))
    prog = storm_program(
        runner.topo, phases, 1,
        staggered_snapshots(runner.topo, snapshots, 1, 2,
                            max_phases=phases))
    return runner, prog


def fault_runner(device, batch=X_BATCH, megatick=1, exact_impl="cascade",
                 tiled=False, trace=None):
    """The faulted exact storm of main paths 3, 6 and 9 (module
    docstring)."""
    from chandy_lamport_tpu_torch.models.faults import Faults

    return exact_runner(device, batch, faults=Faults(3, **F_PROGRAM),
                        megatick=megatick, exact_impl=exact_impl,
                        tiled=tiled, trace=trace, snapshot_timeout=F_TIMEOUT)


def config5_runner(device, megatick=MEGATICK, trace=None, batch=C5_BATCH):
    """Config 5's exact wave storm (``C5_*``), tiled by "auto" on the
    card at megatick > 1."""
    return exact_runner(device, batch, C5_NODES, C5_PHASES, C5_SNAPSHOTS,
                        graph="sf", megatick=megatick, exact_impl="wave",
                        trace=trace)


def phase_kernels(runner, prog, xrunner, xprog, frunner, fprog,
                  wrunner) -> tuple:
    """Every wrapper against its plain version at the shapes of its path;
    returns the per-kernel measurements for the summary line."""
    import numpy as np
    import torch

    from chandy_lamport_tpu_torch.core.state import (
        RTIME_PACK_LIMIT,
        pack_meta,
    )
    from chandy_lamport_tpu_torch.kernels import queue as kq
    from chandy_lamport_tpu_torch.kernels import segment as ks

    kern, dev = runner.kernel, runner.device
    B, E, N = runner.batch, runner.topo.e, runner.topo.n
    C, S = runner.config.queue_capacity, runner.config.max_snapshots
    # a real mid-storm state: 6 phases in, snapshots and traffic in flight
    s = runner.run_storm(runner.init_batch_device(),
                         (prog.amounts[:6], prog.snap[:6]), drain=False)
    torch.cuda.synchronize()
    gen = torch.Generator(device="cpu").manual_seed(7)

    def rand_int(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    rows, out = {}, {}

    def record(name, shape_note, got, want, kernel_fn, plain_fn, nbytes,
               ops, library_fn=None, extra=False, split=False,
               turns=False):
        """One row of ``name``; ``extra`` rows stay out of the summary,
        ``split`` adds the device time per call (profiler) and the host
        time per call of the kernel and of the library call, ``turns``
        times the two again in turns (``in_turns``: its medians are the
        row's ``ms`` and ``library_ms``)."""
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name} ({shape_note}): kernel != plain, "
                                 f"max |diff| {err}")
        row = {"shape": shape_note, "max_abs_err": err,
               "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
               "library_ms": time_ms(library_fn) if library_fn else None,
               **bound(nbytes, ops), "main": not extra}
        if split:
            row.update(split_times(kernel_fn, library_fn))
        if turns:
            row.update(in_turns(kernel_fn, library_fn))
        rows.setdefault(name, []).append(row)
        if not extra:
            out.setdefault(name, []).append(row)

    # -- sum_by_perm: token credits [B, E] i32 and arrivals [B, S, E] bool
    perm, lo, hi = kern._by_dst, kern._dst_lo, kern._dst_hi
    dst_long = kern._edge_dst.to(torch.int64)
    head_rt, _, head_amt = kq.head_fields_plain(s.q_meta, s.q_data,
                                                s.q_head)
    credits_in = torch.where(s.q_len > 0, head_amt, 0).contiguous()
    arrivals_in = s.m_pending.clone()
    arrivals_in[:4] = torch.rand((4, S, E), generator=gen).to(dev) < 0.5
    wide = rand_int((64, E), -2**31, 2**31 - 1)   # exercises the 2^32 wrap
    for x, note, main in ((arrivals_in, f"[{B},{S},{E}] bool", True),
                          (credits_in, f"[{B},{E}] int32", True),
                          (wide, f"[64,{E}] int32 full range", False)):
        x_i = x.to(torch.int32)
        lib_out = torch.zeros(x.shape[:-1] + (N,), dtype=torch.int32,
                              device=dev)
        want = ks.sum_by_perm_plain(x, perm, lo, hi)
        lib_check = lib_out.clone().index_add_(-1, dst_long, x_i)
        if not torch.equal(lib_check, want):
            raise AssertionError("index_add_ disagrees with sum_by_perm")
        r = x.numel() // E
        record("sum_by_perm", note,
               [ks.sum_by_perm(x, perm, lo, hi)], [want],
               lambda: ks.sum_by_perm(x, perm, lo, hi),
               lambda: ks.sum_by_perm_plain(x, perm, lo, hi),
               x.numel() * x.element_size() + 4 * E + 8 * N + 4 * r * N,
               x.numel(), lambda: lib_out.index_add_(-1, dst_long, x_i),
               extra=not main, split=True)

    # -- sum_segments: the per-phase send debits, one [E] row
    slo, shi = kern._src_lo, kern._src_hi
    src_long = kern._edge_src.to(torch.int64)
    amounts = torch.as_tensor(np.asarray(prog.amounts[0]), device=dev)
    for x, note, main in ((amounts, f"[{E}] int32", True),
                          (wide, f"[64,{E}] int32 full range", False)):
        lib_out = torch.zeros(x.shape[:-1] + (N,), dtype=torch.int32,
                              device=dev)
        want = ks.sum_segments_plain(x, slo, shi)
        if not torch.equal(lib_out.clone().index_add_(-1, src_long, x),
                           want):
            raise AssertionError("index_add_ disagrees with sum_segments")
        r = x.numel() // E
        record("sum_segments", note, [ks.sum_segments(x, slo, shi)], [want],
               lambda: ks.sum_segments(x, slo, shi),
               lambda: ks.sum_segments_plain(x, slo, shi),
               4 * x.numel() + 8 * N + 4 * r * N, x.numel(),
               lambda: lib_out.index_add_(-1, src_long, x), extra=not main,
               split=True)

    segment_edges = segment_edge_cases(dev)

    # -- spread: created flags [B, S, N] bool onto in/out edges, and int32
    flags = s.has_local.clone()
    flags[:4] = torch.rand((4, S, N), generator=gen).to(dev) < 0.3
    vals = rand_int((B, N), -1000, 1000)
    for x, idx, note, main in (
            (flags, kern._edge_dst, f"[{B},{S},{N}] bool -> edge_dst", True),
            (flags, kern._edge_src, f"[{B},{S},{N}] bool -> edge_src", False),
            (vals, kern._edge_dst, f"[{B},{N}] int32 -> edge_dst", False)):
        r = x.numel() // N
        idx_long = idx.to(torch.int64)
        record("spread", note, [ks.spread(x, idx)], [ks.spread_plain(x, idx)],
               lambda: ks.spread(x, idx), lambda: ks.spread_plain(x, idx),
               x.numel() * x.element_size() + 4 * E
               + r * E * x.element_size(), 0,
               lambda: torch.index_select(x, -1, idx_long), extra=not main,
               split=True, turns=True)

    # -- head_fields: real rings, lanes 0-2 rebuilt as wrap / full /
    # marker-at-head regimes, lane 3 with random heads
    q_meta, q_data = s.q_meta.clone(), s.q_data.clone()
    q_head = s.q_head.clone()
    q_head[0] = C - 1
    q_head[1] = 1
    q_head[2] = C - 1
    q_meta[2, :, C - 1] = pack_meta(5, True)
    q_head[3] = rand_int((E,), 0, C)
    record("head_fields", f"[{B},{E},{C}] planes",
           list(kq.head_fields(q_meta, q_data, q_head)),
           list(kq.head_fields_plain(q_meta, q_data, q_head)),
           lambda: kq.head_fields(q_meta, q_data, q_head),
           lambda: kq.head_fields_plain(q_meta, q_data, q_head),
           B * E * (4 + 2 * 32 + 9), 3 * B * E)

    # -- append_rows: the next phase's send on the real rings, as
    # _bulk_send passes it (the mask computed, the [E] amounts expanded
    # over the lanes); lane 4 partially active, overflow rows on lanes 5
    # (full ring), 6 (push counter at the merge-key bound) and 7 (receive
    # time at the bound)
    key_limit = kern._key_limit
    active = (amounts > 0).expand(B, -1).clone()
    active[4] &= torch.rand(E, generator=gen).to(dev) < 0.5
    rt, _ = runner.delay.draw_many(s.delay_state, s.time, E)
    rt = rt.contiguous()
    q_len = s.q_len.clone()
    q_len[5] = C
    tok_pushed = s.tok_pushed.clone()
    tok_pushed[6] = key_limit
    rt[7, int(active[7].nonzero()[0])] = RTIME_PACK_LIMIT
    data = amounts.expand(B, -1)
    leaves = (s.q_meta, s.q_data, s.q_head, q_len, tok_pushed,
              torch.zeros(B, dtype=torch.int32, device=dev))
    rows_in = (active, rt, False, data)
    leaves_k, leaves_p = clones(leaves), clones(leaves)
    got = kq.append_rows(*leaves_k, *rows_in, capacity=C,
                         key_limit=key_limit)
    want = kq.append_rows_plain(*leaves_p, *rows_in, capacity=C,
                                key_limit=key_limit)
    bits = got[4][5:8].tolist()
    if not (bits[0] & 1 and bits[1] & 32 and bits[2] & 32):
        raise AssertionError(f"append_rows overflow bits missing: {bits}")
    n_active = int(active.sum())
    record("append_rows", f"[{B},{E},{C}] planes, {n_active} active rows",
           list(got), list(want),
           lambda: kq.append_rows(*leaves_k, *rows_in, capacity=C,
                                  key_limit=key_limit),
           lambda: kq.append_rows_plain(*leaves_p, *rows_in, capacity=C,
                                        key_limit=key_limit),
           *append_work(B * E, n_active, B))

    # -- append_rows past the old 65,535-lane limit: a ring-10 send at
    # 131,072 lanes, every other lane's ring full
    wb, we, wc = WIDE_LANES, 10, 16
    w_len = rand_int((wb, we), 0, wc)
    w_len[::2, 3] = wc
    w_leaves = (rand_int((wb, we, wc), 0, 2**30),
                rand_int((wb, we, wc), -99, 99), rand_int((wb, we), 0, wc),
                w_len, rand_int((wb, we), 0, 50),
                torch.zeros(wb, dtype=torch.int32, device=dev))
    w_rows = (torch.ones((wb, we), dtype=torch.bool, device=dev),
              rand_int((wb, we), 1, 60), False, rand_int((wb, we), 1, 9))
    w_k, w_p = clones(w_leaves), clones(w_leaves)
    got = kq.append_rows(*w_k, *w_rows, capacity=wc, key_limit=1 << 20)
    want = kq.append_rows_plain(*w_p, *w_rows, capacity=wc,
                                key_limit=1 << 20)
    if got[4][0] != 1 or got[4][1] != 0:
        raise AssertionError("append_rows overflow bits wrong past 65,535 "
                             "lanes")
    record("append_rows", f"[{wb},{we},{wc}] planes, every row active",
           list(got), list(want),
           lambda: kq.append_rows(*w_k, *w_rows, capacity=wc,
                                  key_limit=1 << 20),
           lambda: kq.append_rows_plain(*w_p, *w_rows, capacity=wc,
                                        key_limit=1 << 20),
           *append_work(wb * we, wb * we, wb), extra=True)
    del w_leaves, w_k, w_p, w_rows, leaves_k, leaves_p

    # -- queue_step at the exact-at-scale shapes: a real exact storm 4
    # phases in, lanes 0-5 rebuilt as the selection edge cases
    xk = xrunner.kernel
    xs = xrunner.run_storm(xrunner.init_batch_device(),
                           (xprog.amounts[:4], xprog.snap[:4]), drain=False)
    XB, XE, XN = xrunner.batch, xrunner.topo.e, xrunner.topo.n
    XC = xrunner.config.queue_capacity
    q_meta, q_data = xs.q_meta.clone(), xs.q_data.clone()
    q_head, q_len = xs.q_head.clone(), xs.q_len.clone()
    t = xs.time.clone()
    q_head[0], q_len[0] = XC - 1, 2                    # ring wrap
    q_head[1], q_len[1] = 1, XC                        # full ring
    q_meta[2, :, XC - 1] = pack_meta(1, True)          # marker at head
    q_head[2], q_len[2] = XC - 1, 1
    q_len[3] = 0                                       # empty, stale slot
    q_meta[3] = pack_meta(0, False)
    rows_e = torch.arange(XE, device=dev)
    for lane, late in ((4, 1), (5, 0)):
        # lane 4: heads due at time (even edges) or time + 1 (odd edges);
        # lane 5: every edge of every source eligible
        q_len[lane] = 1 + rows_e.to(torch.int32) % 3
        rt = t[lane] + late * (rows_e % 2).to(torch.int32)
        q_meta[lane, rows_e, q_head[lane].long()] = pack_meta(
            rt, (rows_e % 4 == 1).to(torch.int32))
    sargs = (q_meta, q_data, q_head, q_len, t, xk._src_first, xk._src_lo,
             xk._src_hi)
    got = kq.queue_step(*sargs, capacity=XC)
    want = kq.queue_step_plain(*sargs[:6], capacity=XC)
    sel = got[0] | got[1]
    if bool(sel[3].any()) or bool(sel[4, 1::2].any()) or not torch.equal(
            sel[5].nonzero().flatten(), torch.unique(xk._src_first).long()):
        raise AssertionError("queue_step edge cases selected wrongly")
    record("queue_step", f"[{XB},{XE},{XC}] planes, {int(sel.sum())} "
           "deliveries", list(got), list(want),
           lambda: kq.queue_step(*sargs, capacity=XC),
           lambda: kq.queue_step_plain(*sargs[:6], capacity=XC),
           86 * XB * XE + 4 * XB + 8 * XN, 8 * XB * XE)
    del q_meta, q_data, sargs

    # -- sum_by_perm, sum_segments and append_rows at the exact path's
    # shapes, on the same exact-storm state
    xperm, xlo, xhi = xk._by_dst, xk._dst_lo, xk._dst_hi
    xdst_long = xk._edge_dst.to(torch.int64)
    x_tok, x_mk, x_hd, _, _ = kq.queue_step_plain(
        xs.q_meta, xs.q_data, xs.q_head, xs.q_len, xs.time, xk._src_first,
        capacity=XC)
    rank = rand_int((XB,), 0, XN)
    x_wide = rand_int((64, XE), -2**31, 2**31 - 1)
    for x, note in (
            # the credits of one tick's token deliveries, and a fold
            # step's chunk: the tokens of sources below a per-lane rank
            (torch.where(x_tok, x_hd, 0), f"[{XB},{XE}] int32 credits"),
            (torch.where(x_tok & (xk._edge_src < rank[:, None]), x_hd, 0),
             f"[{XB},{XE}] int32 fold-step chunk"),
            (x_wide, f"[64,{XE}] int32 full range")):
        x = x.contiguous()
        lib_out = torch.zeros(x.shape[:-1] + (XN,), dtype=torch.int32,
                              device=dev)
        want = ks.sum_by_perm_plain(x, xperm, xlo, xhi)
        if not torch.equal(lib_out.clone().index_add_(-1, xdst_long, x),
                           want):
            raise AssertionError("index_add_ disagrees with sum_by_perm")
        r = x.numel() // XE
        record("sum_by_perm", f"exact: {note}",
               [ks.sum_by_perm(x, xperm, xlo, xhi)], [want],
               lambda: ks.sum_by_perm(x, xperm, xlo, xhi),
               lambda: ks.sum_by_perm_plain(x, xperm, xlo, xhi),
               4 * x.numel() + 4 * XE + 8 * XN + 4 * r * XN, x.numel(),
               lambda: lib_out.index_add_(-1, xdst_long, x), extra=True,
               split=True)

    # the wave tick's shapes on the same state (ops/tick._wave_tick): the
    # first wave's stacked per-destination facts [B, 5, E] int32, the
    # node facts spread to in-edges [B, 3, N] int32, and the tick-start
    # spread of has_local [B, S, N] bool
    wk = wrunner.kernel
    XS = xrunner.config.max_snapshots
    sid_c = x_hd.clamp(0, XS - 1).long().unsqueeze(-2)
    slots = torch.arange(XS, device=dev)[:, None]
    pend = (x_mk.unsqueeze(-2) & (slots == x_hd.unsqueeze(-2))).to(
        torch.int32)
    had = torch.gather(ks.spread_plain(xs.has_local, wk._edge_dst), -2,
                       sid_c).squeeze(-2)
    first = x_mk & ~had & (torch.gather(wk._seg_excl(pend), -2,
                                        sid_c).squeeze(-2) == 0)
    draws = torch.where(first, wk._outdeg_dst_e, 0)
    wm = x_mk & (wk._seg_excl(x_mk.to(torch.int32)) == 0)
    facts = torch.stack([wm.to(torch.int32), torch.where(wm, x_hd, 0),
                         torch.where(wm, wk._rows_e, 0),
                         (wm & first).to(torch.int32),
                         torch.where(wm, torch.cumsum(draws, -1,
                                                      dtype=torch.int32)
                                     - draws, 0)], dim=-2).contiguous()
    lib_out = torch.zeros((XB, 5, XN), dtype=torch.int32, device=dev)
    want = ks.sum_by_perm_plain(facts, xperm, xlo, xhi)
    if not torch.equal(lib_out.clone().index_add_(-1, xdst_long, facts),
                       want):
        raise AssertionError("index_add_ disagrees with sum_by_perm")
    record("sum_by_perm", f"exact/wave: [{XB},5,{XE}] int32 wave facts",
           [ks.sum_by_perm(facts, xperm, xlo, xhi)], [want],
           lambda: ks.sum_by_perm(facts, xperm, xlo, xhi),
           lambda: ks.sum_by_perm_plain(facts, xperm, xlo, xhi),
           4 * facts.numel() + 4 * XE + 8 * XN + 4 * 5 * XB * XN,
           facts.numel(), lambda: lib_out.index_add_(-1, xdst_long, facts),
           extra=True, split=True)
    node_facts = want[:, :3].contiguous()
    for x, idx, note in (
            (node_facts, wk._edge_dst,
             f"exact/wave: [{XB},3,{XN}] int32 wave node facts -> "
             "edge_dst"),
            (node_facts, wk._edge_src,
             f"exact/wave: [{XB},3,{XN}] int32 wave node facts -> "
             "edge_src"),
            (xs.has_local, wk._edge_dst,
             f"exact/wave: [{XB},{XS},{XN}] bool has_local -> edge_dst")):
        r = x.numel() // XN
        idx_long = idx.to(torch.int64)
        record("spread", note, [ks.spread(x, idx)],
               [ks.spread_plain(x, idx)], lambda: ks.spread(x, idx),
               lambda: ks.spread_plain(x, idx),
               x.numel() * x.element_size() + 4 * XE
               + r * XE * x.element_size(), 0,
               lambda: torch.index_select(x, -1, idx_long), extra=True,
               split=True, turns=True)
    del pend, had, facts, node_facts, want, lib_out

    xslo, xshi = xk._src_lo, xk._src_hi
    xsrc_long = xk._edge_src.to(torch.int64)
    x_amounts = torch.as_tensor(np.asarray(xprog.amounts[4]), device=dev)
    lib_out = torch.zeros((XN,), dtype=torch.int32, device=dev)
    want = ks.sum_segments_plain(x_amounts, xslo, xshi)
    if not torch.equal(lib_out.clone().index_add_(-1, xsrc_long, x_amounts),
                       want):
        raise AssertionError("index_add_ disagrees with sum_segments")
    record("sum_segments", f"exact: [{XE}] int32 send debits",
           [ks.sum_segments(x_amounts, xslo, xshi)], [want],
           lambda: ks.sum_segments(x_amounts, xslo, xshi),
           lambda: ks.sum_segments_plain(x_amounts, xslo, xshi),
           4 * XE + 8 * XN + 4 * XN, XE,
           lambda: lib_out.index_add_(-1, xsrc_long, x_amounts), extra=True,
           split=True)

    # the next phase's token send, then a marker broadcast as
    # _broadcast_markers passes it: a per-lane node, its block of receive
    # times, the payload; every third lane outside the broadcast, lane
    # 1's rings full, lane 2 at the push counter bound
    x_len = xs.q_len.clone()
    x_len[1] = XC
    x_pushed = xs.tok_pushed.clone()
    x_pushed[2] = xk._key_limit
    x_leaves = (xs.q_meta, xs.q_data, xs.q_head, x_len, x_pushed,
                torch.zeros(XB, dtype=torch.int32, device=dev))
    x_active = (x_amounts > 0).expand(XB, -1)
    x_rt, _ = xrunner.delay.draw_many(xs.delay_state, xs.time, XE)
    rows_in = (x_active, x_rt, False, x_amounts.expand(XB, -1))
    leaves_k, leaves_p = clones(x_leaves), clones(x_leaves)
    got = kq.append_rows(*leaves_k, *rows_in, capacity=XC,
                         key_limit=xk._key_limit)
    want = kq.append_rows_plain(*leaves_p, *rows_in, capacity=XC,
                                key_limit=xk._key_limit)
    bits = got[4][1:3].tolist()
    if not (bits[0] & 1 and bits[1] & 32):
        raise AssertionError(f"append_rows overflow bits missing at the "
                             f"exact token send: {bits}")
    n_active = int(x_active.sum())
    record("append_rows", f"exact: [{XB},{XE},{XC}] planes, token send, "
           f"{n_active} active rows", list(got), list(want),
           lambda: kq.append_rows(*leaves_k, *rows_in, capacity=XC,
                                  key_limit=xk._key_limit),
           lambda: kq.append_rows_plain(*leaves_p, *rows_in, capacity=XC,
                                        key_limit=xk._key_limit),
           *append_work(XB * XE, n_active, XB), extra=True)
    node = rand_int((XB,), 0, XN)
    mask = torch.arange(XB, device=dev) % 3 != 0
    d_max = xk._edge_table.shape[1]
    rts_k = xrunner.delay.block_receive_times(
        xs.delay_state, xs.time, xk._ord_d.expand(XB, d_max))
    sid = rand_int((XB,), 0, xrunner.config.max_snapshots)
    m_rows = (node, mask, rts_k, sid, xk._src_lo, xk._src_hi)
    leaves_k, leaves_p = clones(x_leaves), clones(x_leaves)
    got = kq.append_marker_rows(*leaves_k, *m_rows, capacity=XC,
                                key_limit=xk._key_limit)
    want = kq.append_marker_rows_plain(*leaves_p, *m_rows, capacity=XC,
                                       key_limit=xk._key_limit)
    bits = got[4][1:3].tolist()
    if not (bits[0] & 1 and bits[1] & 32):
        raise AssertionError(f"append_marker_rows overflow bits missing: "
                             f"{bits}")
    n_sent = int(torch.where(mask, xk._outdeg_n[node.long()], 0).sum())
    record("append_marker_rows", f"exact: [{XB},{XE},{XC}] planes, marker "
           f"broadcast, {n_sent} active rows (routed from [{XB},{d_max}])",
           list(got), list(want),
           lambda: kq.append_marker_rows(*leaves_k, *m_rows, capacity=XC,
                                         key_limit=xk._key_limit),
           lambda: kq.append_marker_rows_plain(*leaves_p, *m_rows,
                                               capacity=XC,
                                               key_limit=xk._key_limit),
           *append_work(0, n_sent, XB, routed=True))
    del xs, leaves_k, leaves_p, x_leaves

    # -- the faulted exact path at its shapes: a real faulted storm 6
    # phases in, the next tick's head read and fault gates as
    # _select_and_pop takes them
    from chandy_lamport_tpu_torch import BatchedRunner

    fk = frunner.kernel
    fs = frunner.run_storm(frunner.init_batch_device(),
                           (fprog.amounts[:6], fprog.snap[:6]), drain=False)
    FB, FE, FN = frunner.batch, frunner.topo.e, frunner.topo.n
    FC = frunner.config.queue_capacity
    ft = BatchedRunner._own(fs._replace(time=fs.time + 1))
    del fs
    record("head_fields", f"faulted exact: [{FB},{FE},{FC}] planes",
           list(kq.head_fields(ft.q_meta, ft.q_data, ft.q_head)),
           list(kq.head_fields_plain(ft.q_meta, ft.q_data, ft.q_head)),
           lambda: kq.head_fields(ft.q_meta, ft.q_data, ft.q_head),
           lambda: kq.head_fields_plain(ft.q_meta, ft.q_data, ft.q_head),
           FB * FE * (4 + 2 * 32 + 9), 3 * FB * FE, extra=True)
    # the crash gate's spread: this tick's down nodes, lanes 0-3 random
    down = fk.faults.down_nodes(ft.fault_key, ft.time, FN)
    down[:4] = torch.rand((4, FN), generator=gen).to(dev) < 0.3
    dst_long = fk._edge_dst.to(torch.int64)
    record("spread", f"faulted exact: [{FB},{FN}] bool -> edge_dst",
           [ks.spread(down, fk._edge_dst)],
           [ks.spread_plain(down, fk._edge_dst)],
           lambda: ks.spread(down, fk._edge_dst),
           lambda: ks.spread_plain(down, fk._edge_dst),
           FB * FN + 4 * FE + FB * FE, 0,
           lambda: torch.index_select(down, -1, dst_long), extra=True,
           split=True, turns=True)
    head_rt, head_mk, _ = kq.head_fields_plain(ft.q_meta, ft.q_data,
                                               ft.q_head)
    elig = (ft.q_len > 0) & (head_rt <= ft.time[:, None])
    (_, _, jit_e, _), (_, _, mjit_e, _) = (fk._fault_edge_masks(ft),
                                           fk._fault_marker_masks(ft))
    _, elig = fk._fault_gate_elig(ft, elig, jit_e, mjit_e, head_mk)
    f_head, f_len = ft.q_head.clone(), ft.q_len.clone()
    del ft
    # lane 0: every edge eligible; lane 1: nothing eligible; lane 2:
    # every ring at its wrap; lane 3: sources of even index with no edge
    # eligible, odd ones with all
    elig[0] = True
    elig[1] = False
    f_head[2] = FC - 1
    f_len[2] = torch.clamp(f_len[2], min=1)
    elig[3] = fk._edge_src % 2 == 1
    sel_args = (f_head, f_len, elig.contiguous(), fk._src_first, fk._src_lo,
                fk._src_hi)
    got = kq.select_pop(*sel_args, capacity=FC)
    want = kq.select_pop_plain(*sel_args[:4], capacity=FC)
    firsts = torch.unique(fk._src_first).long()
    if (not torch.equal(got[0][0].nonzero().flatten(), firsts)
            or bool(got[0][1].any())
            or bool((got[1][2][got[0][2]] != 0).any())
            or bool(got[0][3][fk._edge_src % 2 == 0].any())):
        raise AssertionError("select_pop edge cases selected wrongly")
    record("select_pop", f"[{FB},{FE}] gated elig after the fault gates, "
           f"{int(got[0].sum())} selected (faulted exact)",
           list(got), list(want),
           lambda: kq.select_pop(*sel_args, capacity=FC),
           lambda: kq.select_pop_plain(*sel_args[:4], capacity=FC),
           18 * FB * FE + 8 * FN, 4 * FB * FE)
    del sel_args, elig, f_head, f_len, down

    emit({"phase": "kernels", "tolerance": "bit-equal (integer work)",
          "rows": rows, "segment_edge_cases": segment_edges,
          "select_edge_cases": select_edge_cases(dev)})
    return out, rows


def _leaves(state) -> list:
    return [t for leaf in state
            for t in (leaf if isinstance(leaf, tuple) else (leaf,))]


def _first_lanes(state, n: int):
    """``state`` cut to its first ``n`` lanes (every leaf, the sampler's
    words included)."""
    return type(state)(*(tuple(w[:n] for w in leaf)
                         if isinstance(leaf, tuple) else leaf[:n]
                         for leaf in state))


def _mismatched(a, b) -> list:
    """Names of the leaves where two states differ (value, dtype or
    shape)."""
    import torch

    bad = []
    for name, x, y in zip(a._fields, a, b):
        pairs = zip(x, y) if isinstance(x, tuple) else [(x, y)]
        if any(u.dtype != v.dtype or u.shape != v.shape
               or not torch.equal(u, v) for u, v in pairs):
            bad.append(name)
    return bad


def time_launch_ms(fn, make_input, reps: int = 5) -> float:
    """Mean device time of one launch of ``fn(x)`` over ``reps`` fresh
    inputs (``make_input()``, the kernel writes in place), after one warm
    launch, by CUDA events. A device sleep queued ahead of each start
    event keeps the host's launch overhead out of the window."""
    import torch

    total = 0.0
    for rep in range(reps + 1):
        x = make_input()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        if rep:
            total += start.elapsed_time(end)
        del x
    return total / reps


def loaded_state(runner, rounds: int = 3):
    """A small state with traffic and snapshots in flight, built by the
    scalar injectors (every sampler has them): per round a 1-token send
    on every third edge, a snapshot at node ``round % N`` on every other
    lane, one tick."""
    import torch

    tk = runner.kernel
    s = runner.init_batch_device()
    lanes = torch.arange(runner.batch, device=s.time.device)
    for r in range(rounds):
        for e in range(r % 3, runner.topo.e, 3):
            s = tk._inject_send(s, e, 1)
        s = tk._inject_snapshot(s, r % runner.topo.n, (lanes + r) % 2 == 0)
        s = tk._exact_tick(s)
    return s


def _edge_checks(name, s, got, steps, live, seen) -> None:
    """What an edge case must show beyond bit-equality, on the kernel's
    result ``got`` of ``steps`` "ticks" steps from ``s`` on the lanes of
    ``live`` (``fused_edge_cases``); ``seen``: a wave kernel's watch
    (``_watch_waves``), None for the cascade."""
    from chandy_lamport_tpu_torch.core.state import (
        ERR_FAULT_UNRECOVERED,
        ERR_QUEUE_OVERFLOW,
        ERR_SNAPSHOT_TIMEOUT,
        FC_CRASH,
        FC_DUP,
        FC_MDUP,
    )

    fired = got.fault_counts - s.fault_counts
    ok = {
        "disarmed": bool((fired[3] == 0).all()) and bool(fired[0].any()),
        "retried": int((got.snap_retries - s.snap_retries).sum()) > 0,
        "never_quiet": bool((got.q_len.sum(-1) == 0).all())
        and bool((fired[:, FC_CRASH] > 0)[live].all()),
        "restored": int(fired[:, FC_CRASH].sum()) > 0
        and not bool((got.error & ERR_FAULT_UNRECOVERED).any()),
        "unrecovered": bool((got.error & ERR_FAULT_UNRECOVERED).any()),
        "daemon": bool((got.next_sid > s.next_sid)[live].all()),
        "quiet": bool((got.q_len.sum(-1) == 0).any()),
        "timeout": bool(((got.error & ERR_SNAPSHOT_TIMEOUT != 0)
                         & (s.error == 0)
                         & (got.time < s.time + steps)).any()),
        "overflow": bool((got.error & ERR_QUEUE_OVERFLOW).any())
        and int(fired[:, FC_DUP].sum() + fired[:, FC_MDUP].sum()) > 0,
        "wrap": bool((got.time < 0).any() & (s.time > 0).all()),
        "pileup": seen is None or (seen["depth"] >= 1
                                   and seen["repeat"] >= 1),
        "counter_wrap": len(got.delay_state) == 3 and bool(
            (got.delay_state[2] > s.delay_state[2]).any()),
        "window_wrap": bool((got.rec_cnt >= 2**16).any()),
    }[name]
    if not ok:
        raise AssertionError(f"fused_scan edge case {name!r} did not show "
                             "what it is for")


def fused_edge_cases(layouts=("resident",), capacity=None) -> list:
    """fused_scan against its plain version on small states on the card,
    in each of ``layouts`` ("resident", "tiled": forced tiled) against one
    plain run; with ``capacity`` the flight recorder armed with that many
    ring slots (the recorder arm, its ring held to the plain one's)
    (``loaded_state``), each through the three step bodies ("ticks" with
    lane 1 not live at launch, so the others go quiet mid-megatick where
    they can; "drain" against a near and a far limit; "flush"). Fault-free:
    each sampler, capacity-1 rings (every append overflows), capacity-5
    rings under quarantine with lane 2 errored at launch, a single-edge
    graph. Faulted (``_edge_checks`` holds each to what it is for):
    token faults with lane 3 disarmed (key 0) and every other class at
    rate 0 (nothing hashed); marker faults under the timeout (retries);
    every class with pause crashes; pause crashes from a fresh state,
    whose empty rings must not make it quiet (it ticks, and restarts);
    lossy crash windows mid-megatick after and before a snapshot
    completes; the daemon; the timeout alone (quiet once nothing is
    pending); marker drop at rate 1.0 with one retry, so
    ERR_SNAPSHOT_TIMEOUT fires mid-megatick and the lane stops there;
    token and marker duplicates at rate 1.0 into capacity-2 rings (the
    re-appends overflow and clobber after the fold's broadcasts); a
    clock taken past 2^31 - 1 under periodic crashes; a complete 8-node
    digraph where every node snapshots (a tick delivers several markers
    to one node, two of one sid among them: the plain run is watched for
    both); and hash counters 3 draws below 2^32, so that a tick's draws
    straddle the wrap; untraced (``capacity`` None) also the threefry
    sampler, fault-free and under marker faults with retries, and uint16
    window planes, fault-free, from counters one below 2^16 (they pass it)
    and under every fault class. Each case runs through the cascade and,
    where the sampler is position-addressable, through the wave step
    body."""
    from chandy_lamport_tpu_torch import SimConfig
    from chandy_lamport_tpu_torch.models.faults import Faults
    from chandy_lamport_tpu_torch.models.workloads import (
        ring_topology,
        scale_free,
    )
    from chandy_lamport_tpu_torch.ops.delay import (
        FixedDelay,
        GoExactDelay,
        HashDelay,
        UniformDelay,
    )
    from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec

    sf48 = scale_free(48, 2, seed=9, tokens=30)
    ring8 = ring_topology(8, tokens=100)
    one = TopologySpec([("A", 9), ("B", 0)], [("A", "B")])
    names = [f"N{i}" for i in range(8)]
    k8 = TopologySpec([(v, 50) for v in names],
                      sorted((a, b) for a in names for b in names if a != b))

    def wide(**kw):
        return SimConfig.for_workload(snapshots=3, **kw)

    every = dict(drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05,
                 marker_drop_rate=0.05, marker_dup_rate=0.05,
                 marker_jitter_rate=0.05)
    # loaded_state leaves every lane at time 3; crash windows are set
    # against that clock
    cases = (
        # (note, graph, config, sampler, adversary, quarantine, check)
        ("sf-48, fixed(2)", sf48, wide(), FixedDelay(2), None, False, None),
        ("sf-48, hash(5)", sf48, wide(), HashDelay(5), None, False, None),
        ("sf-48, go-exact(11)", sf48, wide(), GoExactDelay(11), None, False,
         None),
        ("sf-48, C=1 (appends overflow and clobber)", sf48, SimConfig(
            max_snapshots=4, queue_capacity=1, max_recorded=8),
         HashDelay(3), None, False, None),
        ("sf-48, C=5 ring wrap, quarantine", sf48, SimConfig(
            max_snapshots=4, queue_capacity=5, max_recorded=8),
         HashDelay(3), None, True, None),
        ("single edge A->B, hash(2)", one, SimConfig(
            max_snapshots=2, queue_capacity=4), HashDelay(2), None, False,
         None),
        ("faulted: token faults 0.1, lane 3 disarmed (key 0), other "
         "classes at rate 0", sf48, wide(), HashDelay(5),
         Faults(3, drop_rate=0.1, dup_rate=0.1, jitter_rate=0.1), True,
         "disarmed"),
        ("faulted: marker faults, timeout 6, go-exact(11)", sf48,
         wide(snapshot_timeout=6, snapshot_retries=6), GoExactDelay(11),
         Faults(3, marker_drop_rate=0.3, marker_dup_rate=0.2,
                marker_jitter_rate=0.2), True, "retried"),
        ("faulted: every class 0.05, pause crashes 0.3", sf48,
         wide(snapshot_timeout=8), HashDelay(7),
         Faults(5, crash_rate=0.3, crash_period=4, crash_len=1, **every),
         True, None),
        ("faulted: pause crashes 0.3 from a fresh state (never quiet)",
         sf48, wide(), HashDelay(7),
         Faults(5, crash_rate=0.3, crash_period=4, crash_len=1), True,
         "never_quiet"),
        ("faulted: ring-8, lossy crash window at 17, restored", ring8,
         wide(), FixedDelay(1), Faults(3, crash_rate=1.0, crash_mode="lossy",
                                       crash_start=17, crash_len=2),
         True, "restored"),
        ("faulted: ring-8, lossy crash window at 4, nothing complete",
         ring8, wide(), FixedDelay(1),
         Faults(3, crash_rate=1.0, crash_mode="lossy", crash_start=4,
                crash_len=2), True, "unrecovered"),
        ("supervised: daemon every 3, timeout 12", sf48,
         SimConfig.for_workload(snapshots=8, snapshot_every=3,
                                snapshot_timeout=12), HashDelay(5), None,
         True, "daemon"),
        ("supervised: timeout 30 alone", sf48, wide(snapshot_timeout=30),
         HashDelay(5), None, True, "quiet"),
        ("faulted: marker drop 1.0, timeout 3, one retry", sf48,
         wide(snapshot_timeout=3, snapshot_retries=1), HashDelay(5),
         Faults(3, marker_drop_rate=1.0), True, "timeout"),
        ("faulted: C=2, token and marker dup 1.0", sf48, SimConfig(
            max_snapshots=4, queue_capacity=2, max_recorded=8),
         HashDelay(3), Faults(3, dup_rate=1.0, marker_dup_rate=1.0), False,
         "overflow"),
        ("faulted: clock past 2^31 - 1, periodic crashes", sf48, wide(),
         HashDelay(5), Faults(3, crash_rate=0.5, crash_period=3,
                              crash_len=1, jitter_rate=0.2), False, "wrap"),
        ("pile-up: complete 8-node digraph, 8 snapshots", k8,
         SimConfig.for_workload(snapshots=8), HashDelay(3), None, False,
         "pileup"),
        ("hash counters 3 draws below 2^32", sf48, wide(), HashDelay(5),
         None, False, "counter_wrap"),
    )
    # the threefry sampler kind and the uint16 window arm, untraced (their
    # traced instantiations: tests/test_torch_cuda.py)
    cases += () if capacity is not None else (
        ("sf-48, uniform(5) (threefry)", sf48, wide(), UniformDelay(5),
         None, False, None),
        ("faulted: marker faults, timeout 6, uniform(11)", sf48,
         wide(snapshot_timeout=6, snapshot_retries=6), UniformDelay(11),
         Faults(3, marker_drop_rate=0.3, marker_dup_rate=0.2,
                marker_jitter_rate=0.2), True, "retried"),
        ("sf-48, uint16 windows, hash(5)", sf48,
         wide(window_dtype="uint16"), HashDelay(5), None, False, None),
        ("sf-48, uint16 windows, counters 1 below 2^16", sf48,
         wide(window_dtype="uint16"), HashDelay(5), None, False,
         "window_wrap"),
        ("faulted: uint16 windows, every class 0.05, pause crashes 0.3, "
         "timeout 8", sf48, wide(window_dtype="uint16", snapshot_timeout=8),
         HashDelay(7), Faults(5, crash_rate=0.3, crash_period=4,
                              crash_len=1, **every), True, None),
    )
    rows = []
    for note, spec, cfg, delay, faults, quarantine, check in cases:
        for impl in (("cascade", "wave") if delay.position_streams
                     else ("cascade",)):
            rows += _fused_edge_case(note, spec, cfg, delay, faults,
                                     quarantine, check, impl, layouts,
                                     capacity)
    return rows


def _fused_edge_case(note, spec, cfg, delay, faults, quarantine, check,
                     impl, layouts, capacity) -> list:
    """One case of ``fused_edge_cases`` through the ``impl`` step body,
    in each of ``layouts``, traced with ``capacity`` slots when given. The
    case's state is built and its plain version run on the CPU (the same
    functions on the same inputs; these small host-bound runs take about
    a third of their card time there), every launch's result copied back
    to be held to it."""
    import torch

    from chandy_lamport_tpu_torch import BatchedRunner
    from chandy_lamport_tpu_torch.core.state import ERR_QUEUE_OVERFLOW
    from chandy_lamport_tpu_torch.kernels import megatick as km
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    def build(device, layout):
        return BatchedRunner(
            spec, cfg, delay, 4, scheduler="exact", device=device,
            faults=faults, quarantine=quarantine, megatick=MEGATICK,
            exact_impl=impl,
            trace=None if capacity is None else Trace(capacity),
            **(TILED if layout == "tiled" else {}))

    runners = {layout: build("cuda", layout) for layout in layouts}
    runner = runners[layouts[0]]
    # the plain runs' kernel, and the host-bound set-up's, on the CPU
    plain = build("cpu", "resident")
    tk = plain.kernel
    s = (plain.init_batch_device() if check == "never_quiet"
         else loaded_state(plain, min(3, cfg.max_snapshots)))
    if quarantine and faults is None and check is None:
        s.error[2] |= ERR_QUEUE_OVERFLOW
    if check == "disarmed":
        s.fault_key[3] = 0
    if check == "wrap":
        s = s._replace(time=s.time + (2**31 - 8 - int(s.time.max())))
    if check == "counter_wrap":
        key, _, epoch = s.delay_state
        s = s._replace(delay_state=(key, key * 0 + 2**32 - 3, epoch))
    if check == "window_wrap":
        # every window counter 65,535 higher: the uint16 planes wrap past
        # 2^16 within the megatick
        off, wd = 2**16 - 1, s.rec_start.dtype
        s = s._replace(
            rec_cnt=s.rec_cnt + off,
            min_prot=torch.where(s.min_prot == 2**31 - 1, s.min_prot,
                                 s.min_prot + off),
            rec_start=(s.rec_start.to(torch.int32) + off).to(wd),
            rec_end=(s.rec_end.to(torch.int32) + off).to(wd))
    s = _to_device(s, runner.device)
    seen = _watch_waves(tk) if impl == "wave" else None
    live = ~runner.kernel._halted(s)
    live[1] = False
    ticks = 40 if faults is None else 24
    rows = []
    for mode, length, kw in (
            ("ticks", ticks, {"live": live}),
            ("drain", MEGATICK, {"limit": s.time + 7}),
            ("drain", MEGATICK, {"limit": s.time
                                 + runner.config.max_ticks}),
            ("flush", runner.config.max_delay + 1, {})):
        want = km.fused_ticks_plain(tk, _to_device(s, "cpu"), mode=mode,
                                    length=length,
                                    **{k: v.cpu() for k, v in kw.items()})
        for r in runners.values():
            got = km.fused_ticks(r.kernel, BatchedRunner._own(s), mode=mode,
                                 length=length, **kw)
            got_cpu = _to_device(got, "cpu")
            err = max_abs_err(_leaves(got_cpu), _leaves(want))
            if err or _mismatched(got_cpu, want):
                raise AssertionError(
                    f"fused_scan ({impl}, {_layout(r)}, capacity "
                    f"{capacity}) != plain on {note}, {mode}: "
                    f"{_mismatched(got_cpu, want)}")
            if mode == "ticks" and not all(
                    bool(torch.equal(x[1], y[1]))
                    for x, y in zip(_leaves(got), _leaves(s))):
                raise AssertionError("a lane not live at launch changed")
            if mode == "ticks" and check is not None:
                _edge_checks(check, s, got, length, live, seen)
            events = got.tr_count - s.tr_count
            rows.append({"case": note, "impl": impl, "mode": mode,
                         "layout": _layout(r),
                         "fault_arm": km.fault_arm(r.kernel),
                         "traced": r.kernel._trace_on,
                         "steps": length,
                         "lane_ticks": int((got.time - s.time).sum()),
                         "error_bits": int(got.error.max()),
                         "fault_events": int((got.fault_counts
                                              - s.fault_counts).sum()),
                         "trace_events": int(events.sum()),
                         "max_lane_events": int(events.max()),
                         "max_abs_err": err})
            del got
    return rows


def _to_device(state, device):
    """A private copy of a state on ``device`` (the sampler's words
    included)."""
    return type(state)(*(tuple(w.to(device, copy=True) for w in leaf)
                         if isinstance(leaf, tuple)
                         else leaf.to(device, copy=True) for leaf in state))


def _watch_waves(tk) -> dict:
    """Watch a wave kernel's plain runs: the most earlier markers a
    popped marker had at its node in one tick, of any sid ("depth": the
    wave it is in) and of its own ("repeat": a same-tick repeat)."""
    seen = {"depth": 0, "repeat": 0}
    seg_excl = tk._seg_excl

    def watched(x):
        out = seg_excl(x)
        key = "depth" if x.dim() == 2 else "repeat"
        seen[key] = max(seen[key], int((out * x).max()))
        return out

    tk._seg_excl = watched
    return seen


# integer operations of one lowbias32 (three xor-shifts, two multiplies)
LOWBIAS_OPS = 8
# integer instructions of one Threefry-2x32 block: 20 rounds of an add, a
# rotate (one funnel shift on sm_90) and a xor, and six key injections of
# two adds (the round constant folded into a three-input add)
THREEFRY_BLOCK_OPS = 20 * 3 + 6 * 2
# of one threefry draw (UniformDelay.draw): five blocks (two splits, the
# two halves' bits), the halves' two xors, and randint's fold into the
# span: five modulos, two multiplies and an add, one operation each
THREEFRY_OPS = 5 * THREEFRY_BLOCK_OPS + 2 + 8


def fused_plain_and_bytes(tk, s0, limit, live=None):
    """The plain version of one drain megatick from ``s0`` (gated by
    ``live`` [B] when given: the streaming engine's drain slice), step by
    step
    (the same steps as one call of length K), timed around its calls on
    the host clock; and the bytes the kernel's design must move and the
    integer operations it must do on this input, counted from the steps'
    own data:

      per lane that drains at the first step (the others return before
      loading anything): the shared-memory planes read once and written
      once (``started``/``snap_failed`` only read), ``time``, ``error``,
      ``limit`` and the hash delay words; with the fault arm also the
      supervisor's [S] vectors, the fault counts and scalars, and the
      lane's fault key; the topology tables once;
      per step: the head rtime of every non-empty edge of a stepping lane,
      the payload of every popped slot, every appended slot (rtime and
      payload), and every log and window entry that changed;
      with the flight recorder armed (the recorder arm): 12 B per event
      written to the ring (its meta, payload and tick words; an append
      of more than K events writes its last K) and, per lane that
      drains, its count read and written and its arm flag read.

    Operations: ~8 per edge of every lane-tick taken (the tick's own
    integer work); with the adversary, per lane-tick, one lowbias32 per
    edge shared by its classes plus one and a compare per armed edge
    class, two crash gates per node (now and a tick before: three
    lowbias32 each, and the floor division) when crashes are armed, and
    one lowbias32 per duplicate's receive time.

    Returns (final plain state, plain ms, bytes, operations, the
    breakdown)."""
    import torch

    from chandy_lamport_tpu_torch import BatchedRunner
    from chandy_lamport_tpu_torch.core.state import FC_DUP, FC_MDUP
    from chandy_lamport_tpu_torch.kernels import megatick as km
    from chandy_lamport_tpu_torch.ops.delay import UniformDelay

    n, e = tk.topo.n, tk.topo.e
    S = tk.cfg.max_snapshots
    if tk.cfg.queue_capacity < 2:
        raise ValueError("a pop is read off the head's move: needs C >= 2")
    ext = km.fault_arm(tk)

    def cond(s):
        c = tk._drain_cond(s, limit)
        return c if live is None else c & live

    lanes = int(cond(s0).sum())
    ints = 5 * e + n + 2 * S * n + 2 * S + 2 + (4 * S + 10 if ext else 0)
    flags = S * e + 2 * S * n
    per_lane = (2 * (4 * ints + flags) + 2 * S    # planes in and out
                + 4 + 3 * 8 + 2 * 8               # limit, delay words
                + (8 if tk.faults is not None else 0))   # the fault key
    tables = 4 * (3 * e + 5 * n) + (0 if live is None else live.numel())
    traced = tk._trace_on
    if traced:
        per_lane += 12
    parts = {"planes_and_words": lanes * per_lane, "tables": tables,
             "head_reads": 0, "popped_payloads": 0, "appended_slots": 0,
             "log_writes": 0, "window_writes": 0, "trace_events": 0}
    edge_ops = node_ops = 0
    if tk.faults is not None:
        prog = tk.faults.kernel_program()
        armed = sum(1 for k in (0, 1, 2, 4, 5, 6) if prog["arm"][k] == 1)
        edge_ops = e * (LOWBIAS_OPS + 1 + armed * (LOWBIAS_OPS + 3))
        if prog["crash_kind"]:
            node_ops = n * 2 * (3 * LOWBIAS_OPS + 8)
    log_size = s0.log_amt.element_size()
    s, plain_ms, lane_ticks, dups = BatchedRunner._own(s0), 0.0, 0, 0
    appended = 0
    for _ in range(MEGATICK):
        step = cond(s)
        lane_ticks += int(step.sum())
        before = {k: getattr(s, k).clone() for k in (
            "q_len", "q_head", "log_amt", "rec_start", "rec_end",
            "fault_counts", "tr_count")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = km.fused_ticks_plain(tk, s, mode="drain", length=1, live=live,
                                 limit=limit)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        pops = int((s.q_head != before["q_head"]).sum())
        parts["head_reads"] += 4 * int(
            ((before["q_len"] > 0) & step[:, None]).sum())
        parts["popped_payloads"] += 4 * pops
        parts["appended_slots"] += 8 * (
            int((s.q_len - before["q_len"]).sum()) + pops)
        parts["log_writes"] += log_size * int(
            (s.log_amt != before["log_amt"]).sum())
        parts["window_writes"] += s.rec_start.element_size() * int(
            (s.rec_start != before["rec_start"]).sum()
            + (s.rec_end != before["rec_end"]).sum())
        fired = s.fault_counts - before["fault_counts"]
        dups += int(fired[:, FC_DUP].sum() + fired[:, FC_MDUP].sum())
        appended += int((s.q_len - before["q_len"]).sum()) + pops
        if traced:
            parts["trace_events"] += 12 * int(torch.clamp(
                s.tr_count - before["tr_count"],
                max=tk.cfg.trace_capacity).sum())
        del before
    ops = {"tick": 8 * e * lane_ticks, "fault_hash_edges":
           edge_ops * lane_ticks, "fault_hash_nodes": node_ops * lane_ticks,
           "dup_times": (LOWBIAS_OPS + 3) * dups}
    if isinstance(tk.delay, UniformDelay):
        # every append but a duplicate's is a broadcast's draw
        ops["threefry_draws"] = THREEFRY_OPS * (appended - dups)
    return (s, plain_ms, sum(parts.values()), sum(ops.values()),
            {"draining_lanes": lanes, "lane_ticks": lane_ticks, **parts,
             "ops": ops})


def drain_setup(runner, prog):
    """The state after ``runner``'s storm phases (not drained), its drain
    limit, and one drain megatick (K=8) of a state through fused_ticks
    (in place: pass a copy)."""
    from chandy_lamport_tpu_torch.kernels import megatick as km

    s0 = runner.run_storm(runner.init_batch_device(), prog, drain=False)
    limit = s0.time + runner.config.max_ticks

    def drain(x):
        return km.fused_ticks(runner.kernel, x, mode="drain",
                              length=MEGATICK, limit=limit)

    return s0, limit, drain


def _layout(runner) -> str:
    """The fused megatick's layout of ``runner``: "tiled" or
    "resident"."""
    return "tiled" if runner.fused_tile == "on" else "resident"


def drain_megatick_rows(runner, prog, label, graph="er",
                        tiled=None) -> list:
    """One drain megatick (K=8) of ``runner``'s cell from the state after
    its storm phases: the kernel bit-equal to its plain version on the
    same input, timed per launch, beside its bound; with ``tiled`` (the
    same cell's runner, forced tiled) a second row, the tiled
    layout on the same input, held to the same plain result and timed
    the same way. The bound counts the work's bytes, whatever layout runs
    it."""
    import torch

    from chandy_lamport_tpu_torch import BatchedRunner
    from chandy_lamport_tpu_torch.kernels import megatick as km

    tk, own = runner.kernel, BatchedRunner._own
    s0, limit, drain = drain_setup(runner, prog)
    got = drain(own(s0))
    torch.cuda.synchronize()
    want, plain_ms, nbytes, ops, moved = fused_plain_and_bytes(tk, s0, limit)
    err = max_abs_err(_leaves(got), _leaves(want))
    bad = _mismatched(got, want)
    if err or bad:
        raise AssertionError(f"fused_scan != plain at the {label} drain "
                             f"megatick: {bad}")
    lane_ticks = int((got.time - s0.time).sum())
    fired = int((got.fault_counts - s0.fault_counts).sum())
    events = int((got.tr_count - s0.tr_count).sum())
    ms = time_launch_ms(drain, lambda: own(s0))
    state_bytes = sum(t.numel() * t.element_size() for t in _leaves(s0))
    del got
    E = runner.topo.e
    row = {"shape": f"[{runner.batch}] lanes of {graph}-{runner.topo.n} "
                    f"(E={E}, C={runner.config.queue_capacity}), one "
                    f"{label} drain megatick K={MEGATICK} after "
                    f"{len(prog.amounts)} phases, {lane_ticks} lane-ticks"
                    + (f", {fired} fault events" if fired else ""),
           "layout": _layout(runner), "traced": tk._trace_on,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "plain_timing": "K one-step calls, host clock",
           "library_ms": None, "state_bytes": state_bytes,
           "bytes_moved": moved, **bound(nbytes, ops)}
    if tk._trace_on:
        row["trace_events"] = events
    if _layout(runner) == "tiled":
        row["workspace_bytes"] = tk.fused_workspace.numel()
    rows = [row]
    if tiled is not None:
        def tiled_drain(x):
            return km.fused_ticks(tiled.kernel, x, mode="drain",
                                  length=MEGATICK, limit=limit)

        got = tiled_drain(own(s0))
        err = max_abs_err(_leaves(got), _leaves(want))
        bad = _mismatched(got, want)
        if err or bad or tiled.fused_tile != "on":
            raise AssertionError(f"tiled fused_scan != plain at the {label} "
                                 f"drain megatick: {bad}")
        del got
        tiled_ms = time_launch_ms(tiled_drain, lambda: own(s0))
        rows.append({**row, "layout": "tiled", "max_abs_err": err,
                     "ms": tiled_ms, "tiled_over_resident": tiled_ms / ms,
                     "workspace_bytes": tiled.kernel.fused_workspace.numel()})
    del want, s0
    return rows


def fault_hash_check() -> list:
    """``fault_hash_planes`` (the fused megatick's device hash, writing
    the JAX ``_fault_planes`` layout) against ``Faults.fault_planes`` on
    the card, bit for bit, at the exact cell's widths (E=768, N=256) over
    8 ticks from lanes whose first row is tick time 0, 1, 31, 32, 2^20
    and 2^31 - 1 (its later rows wrap past the int32 range), plus a lane
    with key 0 (disarmed) and one with key 2^32 - 1; for the fault_storm
    cell's program, every class at 0.3 with periodic crashes, every class
    at 1.0, every class at 0 (nothing hashed) and a lossy crash_start
    window whose crash rate 0 gates at 1.0."""
    import torch

    from chandy_lamport_tpu_torch.kernels import megatick as km
    from chandy_lamport_tpu_torch.models.faults import Faults

    first = [0, 1, 31, 32, 2**20, 2**31 - 1, 31, 2**31 - 1]
    base = torch.tensor([t - 1 for t in first], dtype=torch.int32,
                        device="cuda")
    every = ("drop_rate", "dup_rate", "jitter_rate", "crash_rate",
             "marker_drop_rate", "marker_dup_rate", "marker_jitter_rate")
    programs = (
        ("the fault_storm cell's program", F_PROGRAM),
        ("every class 0.3, periodic crashes (period 8, length 3)",
         dict({k: 0.3 for k in every}, crash_period=8, crash_len=3)),
        ("every class 1.0", {k: 1.0 for k in every}),
        ("every class 0", {}),
        ("lossy crash_start=31 window, crash_rate 0, drop 0.01",
         dict(crash_start=31, crash_len=2, crash_mode="lossy",
              drop_rate=0.01)))
    rows = []
    for note, kw in programs:
        faults = Faults(3, **kw)
        key = faults.init_batch_state(len(first), "cuda")
        key[6] = 0
        key[7] = 2**32 - 1
        shape = dict(steps=MEGATICK, num_edges=768, num_nodes=256,
                     max_delay=5)
        got = km.fault_hash_planes(faults, key, base, **shape)
        want = faults.fault_planes(key, base, MEGATICK, 768, 256, 5)
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"the device fault hash != plain on {note}")
        rows.append({"program": note, "first_rows": first,
                     "fired_edge_flags": int(want[0][:, :, [0, 1, 2, 4, 5, 6]]
                                             .sum()),
                     "down_and_restarts": int(want[1].sum()),
                     "max_abs_err": err})
    return rows


DRAIN_CELLS = ("fault-free", "faulted", "wave", "wave-faulted", "threefry",
               "uint16", "config5-wave")
# the ER-256 cells again in the tiled layout (forced, ``fused_tile="on"``)
TILED_CELLS = tuple(f"{c}-tiled" for c in DRAIN_CELLS[:4] + ("uint16",))


def drain_timing(cell: str, batch=None) -> None:
    """``--drain-timing CELL ...``, for each cell: one drain megatick
    (K=8) of that exact cell (``DRAIN_CELLS``: through the wave step body for the wave cells;
    config 5's tiled wave lane for ``config5-wave``; with the suffix
    ``-traced`` the flight recorder armed at its default capacity, the
    recorder arm) from the state after its storm phases, timed over
    ``DRAIN_LAUNCHES`` launches on fresh copies (``time_launch_ms``), and
    printed as one JSON line with the card's name and power limit, the
    lane-ticks the megatick runs and the time per lane-tick; with the
    suffix ``-tiled`` (``TILED_CELLS``) an ER-256 cell in the tiled
    layout, forced. ``batch`` (``--batch``) replaces the cell's lane
    count."""
    from chandy_lamport_tpu_torch import BatchedRunner
    from chandy_lamport_tpu_torch.kernels import megatick as km

    base = cell.removesuffix("-traced").removesuffix("-tiled")
    kw = {}
    if cell.endswith("-traced"):
        from chandy_lamport_tpu_torch.utils.tracing import Trace

        kw["trace"] = Trace()
    if cell.removesuffix("-traced").endswith("-tiled"):
        kw["tiled"] = True
    if base == "config5-wave":
        runner, prog = config5_runner("cuda", batch=batch or C5_BATCH, **kw)
    elif base in ("threefry", "uint16"):
        # the fault-free cascade cell under the slice-17 arms
        from chandy_lamport_tpu_torch.ops.delay import UniformDelay

        if base == "threefry":
            kw["delay"] = UniformDelay(UNIFORM_SEED)
        else:
            kw["window_dtype"] = "uint16"
        runner, prog = exact_runner("cuda", batch=batch or X_BATCH,
                                    megatick=MEGATICK, **kw)
    else:
        make = fault_runner if base.endswith("faulted") else exact_runner
        if base.startswith("wave"):
            kw["exact_impl"] = "wave"
        runner, prog = make("cuda", batch=batch or X_BATCH,
                            megatick=MEGATICK, **kw)
    s0, _, drain = drain_setup(runner, prog)
    lane_ticks = int((drain(BatchedRunner._own(s0)).time - s0.time).sum())
    ms = time_launch_ms(drain, lambda: BatchedRunner._own(s0),
                        reps=DRAIN_LAUNCHES)
    emit({"phase": "drain_timing", "cell": cell,
          "package": os.path.dirname(km.__file__), "batch": runner.batch,
          "lane_ticks": lane_ticks,
          "us_per_lane_tick": 1e3 * ms / max(lane_ticks, 1),
          "launches": DRAIN_LAUNCHES, "ms_per_drain_megatick": ms,
          "layout": getattr(runner, "fused_tile", "off"),
          # a parent checkout (``--package-root``) may predate the recorder
          "traced": getattr(runner.kernel, "_trace_on", False),
          "nvidia_smi": nvidia_smi()})


def ptxas_report() -> int:
    """``--ptxas``: each CUDA source of the imported package compiled to a
    cubin with that package's ``_build.NVCC_FLAGS`` (less the shared
    library's) and ``-Xptxas -v``, the sources in parallel; one JSON line
    a source: nvcc's seconds and, per kernel (mangled name), ptxas's
    registers, spill stores and loads, and stack frame bytes."""
    import re
    import tempfile

    from chandy_lamport_tpu_torch.kernels import _build

    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ptxas_")
    procs = {}
    for name in _build.SOURCES:
        cmd = [_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
               os.path.join(tmp, f"{name}.cubin"),
               os.path.join(_build.CSRC, f"{name}.cu")]
        procs[name] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for name, (t0, proc) in procs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode:
            print(out, file=sys.stderr)
            return 1
        kernels, fn = {}, None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
                kernels[fn] = {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and fn and "registers" not in kernels[fn]:
                kernels[fn].update(stack=int(m.group(1)),
                                   spill_stores=int(m.group(2)),
                                   spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                kernels[fn]["registers"] = int(m.group(1))
        print(json.dumps({"source": f"{name}.cu", "flags": flags,
                          "nvcc_s": seconds, "package": _build.CSRC,
                          "kernels": kernels}), flush=True)
    return 0


def spread_timing() -> int:
    """``--spread-timing``: ``spread`` at the faulted crash gate's shape
    (``X_BATCH`` lanes of one bool per ER-256 node onto its in-edges,
    ``edge_dst``) against ``index_select`` on the same input, equal, then
    timed in turns (``in_turns``), printed as one JSON line with the
    card's name and power limit. With ``--package-root`` the wrapper is
    another checkout's, so parent and change are timed in turns in one
    call."""
    import torch

    from chandy_lamport_tpu_torch.kernels import segment as ks

    runner, _ = exact_runner("cuda", batch=1)
    idx = runner.kernel._edge_dst
    idx_long = idx.to(torch.int64)
    gen = torch.Generator().manual_seed(DELAY_SEED)
    x = (torch.rand((X_BATCH, runner.topo.n), generator=gen) < 0.3).cuda()

    def kernel():
        return ks.spread(x, idx)

    def library():
        return torch.index_select(x, -1, idx_long)

    if not torch.equal(kernel(), library()):
        raise AssertionError("spread != index_select at the crash gate")
    emit({"phase": "spread_timing",
          "package": os.path.dirname(ks.__file__),
          "shape": f"[{X_BATCH},{runner.topo.n}] bool -> "
                   f"[{X_BATCH},{idx.numel()}]",
          **in_turns(kernel, library), "nvidia_smi": nvidia_smi()})
    # the giant sharded cell's created-flag spread, the direct path: 8
    # rows of its 2,101,412 segments onto its 3,145,728 stacked edges,
    # through a uniform random stand-in for dst_seg
    segs, edges = GS_SPREAD_SEGMENTS, GS_SHARDS * GS_SPREAD_EM
    flags = (torch.rand((1, SNAPSHOTS, segs), generator=gen) < 0.3).cuda()
    dst = torch.randint(0, segs, (edges,), generator=gen,
                        dtype=torch.int32).cuda()
    dst_long = dst.to(torch.int64)
    if ks.spread_plan(SNAPSHOTS, edges, segs, 1).rows_per_group:
        raise AssertionError("the giant spread is expected on the direct "
                             "path")
    if not torch.equal(ks.spread(flags, dst),
                       ks.spread_plain(flags, dst)):
        raise AssertionError("spread != its plain version at the giant "
                             "shape")
    emit({"phase": "spread_timing_giant",
          "package": os.path.dirname(ks.__file__),
          "shape": f"[1,{SNAPSHOTS},{segs}] bool -> [1,{SNAPSHOTS},{edges}]"
                   " (random idx)",
          **in_turns(lambda: ks.spread(flags, dst),
                     lambda: torch.index_select(flags, -1, dst_long)),
          **bound(flags.numel() + 4 * edges + SNAPSHOTS * edges, 0)})
    return 0


def queue_cases(dev) -> list:
    """The timed shapes of rows 4, 6 and 7 as (kernel, shape note, the
    wrapper's call, the plain call, bytes, operations): ``head_fields`` at
    the sync storm's planes (config 4, [2048,3063,16]) and the faulted
    exact cell's ([4096,768,24]); ``queue_step`` at the exact cell's, with
    ER-256's source segments, and at config 5's ([512,24572,24]), with
    SF-8k's; ``select_pop`` at the faulted exact cell's ([4096,768]). The
    rings are made from seed 7: heads anywhere in the ring, lengths 0-3,
    head receive times within 3 ticks of each lane's clock, every fourth
    head a marker, so about half the non-empty heads are due.
    ``select_pop``'s eligibility is that of the rings' heads, gated as
    ``_fault_gate_elig`` gates it (a jittered edge, 5 % of them, and the
    in-edges of a crashed node, 3 % of a lane's nodes, lose it): about
    40 % of the rows. Bytes: each row reads its head (and its length) and
    each gathered slot word as the 32-byte sector it comes in, and writes
    its outputs once; ``select_pop`` 18 B a row and the out-edge ranges."""
    import torch

    from chandy_lamport_tpu_torch.core.state import DenseTopology
    from chandy_lamport_tpu_torch.kernels import queue as kq
    from chandy_lamport_tpu_torch.models.workloads import (
        erdos_renyi,
        scale_free,
    )

    gen = torch.Generator(device="cpu").manual_seed(7)

    def rings(b, e, c):
        q_head = torch.randint(0, c, (b, e), generator=gen,
                               dtype=torch.int32)
        q_len = torch.randint(0, 4, (b, e), generator=gen,
                              dtype=torch.int32)
        time = torch.randint(10, 1000, (b,), generator=gen,
                             dtype=torch.int32)
        rt = time[:, None, None] + torch.randint(
            -3, 4, (b, e, c), generator=gen, dtype=torch.int32)
        mk = torch.randint(0, 4, (b, e, c), generator=gen,
                           dtype=torch.int32) == 0
        q_meta = rt * 2 + mk.to(torch.int32)
        q_data = torch.randint(-99, 100, (b, e, c), generator=gen,
                               dtype=torch.int32)
        return q_meta, q_data, q_head, q_len, time

    def segments(topo):
        """(src_first [E], src_lo [N], src_hi [N]) on ``dev``."""
        src = torch.as_tensor(topo.edge_src, dtype=torch.int64)
        nodes = torch.arange(topo.n)
        src_lo = torch.searchsorted(src, nodes).to(torch.int32)
        src_hi = torch.searchsorted(src, nodes, right=True).to(torch.int32)
        return tuple(x.to(dev) for x in (src_lo[src], src_lo, src_hi))

    sync_e = DenseTopology(scale_free(NODES, ATTACH, seed=3)).e
    x_topo = DenseTopology(erdos_renyi(X_NODES, 3.0, seed=3))
    cases = []
    for b, e, c, note in ((BATCH, sync_e, 16, "sync"),
                          (X_BATCH, x_topo.e, 24, "faulted exact")):
        q_meta, q_data, q_head = (x.to(dev) for x in rings(b, e, c)[:3])
        cases.append((
            "head_fields", f"{note}: [{b},{e},{c}] planes",
            lambda q_meta=q_meta, q_data=q_data, q_head=q_head:
            kq.head_fields(q_meta, q_data, q_head),
            lambda q_meta=q_meta, q_data=q_data, q_head=q_head:
            kq.head_fields_plain(q_meta, q_data, q_head),
            b * e * (4 + 2 * 32 + 9), 3 * b * e))
    c5_topo = DenseTopology(scale_free(C5_NODES, ATTACH, seed=3))
    for b, topo, note in ((X_BATCH, x_topo, "exact"),
                          (C5_BATCH, c5_topo, "config 5")):
        e, c = topo.e, 24
        args = tuple(x.to(dev) for x in rings(b, e, c))
        seg = segments(topo)
        cases.append((
            "queue_step", f"{note}: [{b},{e},{c}] planes",
            lambda args=args, seg=seg: kq.queue_step(*args, *seg,
                                                     capacity=c),
            lambda args=args, seg=seg: kq.queue_step_plain(*args, seg[0],
                                                           capacity=c),
            b * e * (4 + 4 + 2 * 32 + 14) + 4 * b + 8 * topo.n, 8 * b * e))
        del args
    b, e, c = X_BATCH, x_topo.e, 24
    q_meta, _, q_head, q_len, time = rings(b, e, c)
    head_meta = torch.gather(q_meta, -1, q_head.long().unsqueeze(-1))
    elig = (q_len > 0) & ((head_meta.squeeze(-1) >> 1) <= time[:, None])
    jittered = torch.rand((b, e), generator=gen) < 0.05
    down = torch.rand((b, x_topo.n), generator=gen) < 0.03
    dead = down[:, torch.as_tensor(x_topo.edge_dst, dtype=torch.int64)]
    elig = (elig & ~jittered & ~dead).to(dev)
    q_head, q_len = q_head.to(dev), q_len.to(dev)
    seg = segments(x_topo)
    del q_meta
    cases.append((
        "select_pop", f"faulted exact: [{b},{e}] gated elig, "
                      f"{float(elig.float().mean()):.3f} of it true",
        lambda: kq.select_pop(q_head, q_len, elig, *seg, capacity=c),
        lambda: kq.select_pop_plain(q_head, q_len, elig, seg[0],
                                    capacity=c),
        18 * b * e + 8 * x_topo.n, 4 * b * e))
    return cases


def queue_timing() -> int:
    """``--queue-timing``: ``head_fields`` (row 4), ``queue_step`` (row
    6) and ``select_pop`` (row 7) at their timed shapes
    (``queue_cases``), each first held to its plain version bit for bit,
    then in ``TURNS`` rounds of: event ms
    per call (``time_ms``), profiler device ms per call and the wrapper's
    host us per call; the medians and every round beside the bound, the
    plain version's ms and the share of the bound reached, printed as one
    JSON line with the card's name and power limit. With
    ``--package-root`` the package is another checkout's, so parent and
    change are timed in turns in one call."""
    from chandy_lamport_tpu_torch.kernels import queue as kq

    rows = []
    for kernel, note, fn, plain, nbytes, ops in queue_cases("cuda"):
        err = max_abs_err(list(fn()), list(plain()))
        if err:
            raise AssertionError(f"{kernel} ({note}) != plain: {err}")
        turns = {"ms": [], "device_ms": [], "host_us": []}
        for _ in range(TURNS):
            turns["ms"].append(time_ms(fn))
            turns["device_ms"].append(device_ms(fn)[0])
            turns["host_us"].append(host_us(fn))
        med = {k: statistics.median([x for x in v if x is not None]
                                    or [None]) for k, v in turns.items()}
        lim = bound(nbytes, ops)
        rows.append({"kernel": kernel, "shape": note, "max_abs_err": err,
                     **med, **lim, "plain_ms": time_ms(plain),
                     "bound_share": lim["bound_ms"] / med["ms"],
                     "turns": turns})
    emit({"phase": "queue_timing",
          "package": os.path.dirname(kq.__file__), "shapes": rows,
          "nvidia_smi": nvidia_smi()})
    return 0


def append_cases(dev) -> list:
    """The three timed shapes of ``append_rows`` as (note, kernel, the
    wrapper's call, the caller's call): the sync storm's token send
    (config 4, 6 phases in), and the exact cell's token send and marker
    broadcast (4 phases in). The wrapper's call passes what the caller
    passes it; the caller's call is ``TickKernel._append_rows`` for a
    send and ``_broadcast_markers`` (node per lane, a random slot, every
    third lane outside it) for the broadcast. Both write in place, so
    each repeat appends again to the same state. The wrapper's signature
    is read, so that a parent checkout (``--package-root``) is timed by
    its own API."""
    import inspect

    import numpy as np
    import torch

    from chandy_lamport_tpu_torch.core.state import pack_meta
    from chandy_lamport_tpu_torch.kernels import queue as kq

    one_launch = "error" in inspect.signature(kq.append_rows).parameters
    gen = torch.Generator(device="cpu").manual_seed(7)
    cases = []
    for name, (runner, prog), phases in (
            ("sync token send", config4_runner(dev), 6),
            ("exact token send", exact_runner(dev), 4)):
        tk = runner.kernel
        B, E, C = runner.batch, runner.topo.e, runner.config.queue_capacity
        s = runner.run_storm(runner.init_batch_device(),
                             (prog.amounts[:phases], prog.snap[:phases]),
                             drain=False)
        amounts = torch.as_tensor(np.asarray(prog.amounts[phases]),
                                  device=dev)
        active = (amounts > 0).expand(B, -1).contiguous()
        data = amounts.expand(B, -1).contiguous()
        rt, _ = runner.delay.draw_many(s.delay_state, s.time, E)
        rt = rt.contiguous()
        note = (f"[{B},{E},{C}] planes, {name}, {int(active.sum())} "
                "active rows")
        if one_launch:
            def wrapper(s=s, active=active, rt=rt, data=data, tk=tk, C=C):
                return kq.append_rows(
                    s.q_meta, s.q_data, s.q_head, s.q_len, s.tok_pushed,
                    s.error, active, rt, False, data, capacity=C,
                    key_limit=tk._key_limit)
        else:
            meta = pack_meta(rt, 0)

            def wrapper(s=s, active=active, rt=rt, data=data, tk=tk, C=C,
                        meta=meta):
                return kq.append_rows(
                    s.q_meta, s.q_data, s.q_head, s.q_len, s.tok_pushed,
                    active, meta, rt, data, capacity=C,
                    key_limit=tk._key_limit)

        def caller(s=s, active=active, rt=rt, data=data, tk=tk):
            return tk._append_rows(s, active, rt, False, data)

        cases.append((note, "append_rows", wrapper, caller))
        if name.startswith("exact"):
            xrunner, xs = runner, s
    tk, s = xrunner.kernel, xs
    B, E, N = xrunner.batch, xrunner.topo.e, xrunner.topo.n
    node = torch.randint(0, N, (B,), generator=gen,
                         dtype=torch.int32).to(dev)
    sid = torch.randint(0, xrunner.config.max_snapshots, (B,),
                        generator=gen, dtype=torch.int32).to(dev)
    mask = torch.arange(B, device=dev) % 3 != 0
    row = tk._edge_table[node.long()]
    go = (row >= 0) & mask[:, None]
    valid = (row >= 0).to(torch.int32)
    off = torch.cumsum(valid, dim=-1, dtype=torch.int32) - valid
    rts_k = xrunner.delay.block_receive_times(s.delay_state, s.time, off)
    payload = tk._marker_payload(s, sid)
    if one_launch:
        kernel = "append_marker_rows"

        def wrapper():
            return kq.append_marker_rows(
                s.q_meta, s.q_data, s.q_head, s.q_len, s.tok_pushed,
                s.error, node, mask, rts_k, payload, tk._src_lo, tk._src_hi,
                capacity=xrunner.config.queue_capacity,
                key_limit=tk._key_limit)
    else:
        kernel = "append_rows"
        tgt = torch.where(go, row, E).long()
        active = torch.zeros((B, E + 1), dtype=torch.bool, device=dev
                             ).scatter_(1, tgt, True)[:, :E].contiguous()
        rt_e = torch.zeros((B, E + 1), dtype=torch.int32, device=dev
                           ).scatter_(1, tgt, rts_k)[:, :E].contiguous()
        meta = pack_meta(rt_e, 1)
        data = payload.unsqueeze(-1).expand(B, E).contiguous()

        def wrapper():
            return kq.append_rows(
                s.q_meta, s.q_data, s.q_head, s.q_len, s.tok_pushed, active,
                meta, rt_e, data, capacity=xrunner.config.queue_capacity,
                key_limit=tk._key_limit)

    def caller():
        return tk._broadcast_markers(s, node, sid, mask)

    cases.append((f"[{B},{E},{xrunner.config.queue_capacity}] planes, "
                  f"marker broadcast, {int(go.sum())} active rows", kernel,
                  wrapper, caller))
    return cases


def append_timing() -> int:
    """``--append-timing``: ``append_rows`` at its three timed shapes
    (``append_cases``), each in ``TURNS`` rounds of: the kernel's device
    time per call (torch.profiler, the wrapper's kernels only), the
    caller's device time per call (every kernel it launches), the
    wrapper's and the caller's host time per call (``host_us``) and their
    event times (``time_ms``); the medians and every round, printed as
    one JSON line with the card's name and power limit. With
    ``--package-root`` the package is another checkout's (its own API),
    so parent and change are timed in turns in one call."""
    from chandy_lamport_tpu_torch.kernels import queue as kq

    rows = []
    for note, kernel, wrapper, caller in append_cases("cuda"):
        keys = ("kernel_device_ms", "caller_device_ms", "wrapper_host_us",
                "caller_host_us", "wrapper_ms", "caller_ms")
        turns = {k: [] for k in keys}
        names = None
        for _ in range(TURNS):
            ms, names = device_ms(wrapper)
            turns["kernel_device_ms"].append(ms)
            turns["caller_device_ms"].append(device_ms(caller)[0])
            turns["wrapper_host_us"].append(host_us(wrapper))
            turns["caller_host_us"].append(host_us(caller))
            turns["wrapper_ms"].append(time_ms(wrapper))
            turns["caller_ms"].append(time_ms(caller))
        # a profiler round that saw no kernel reads None; the median
        # takes the rounds that read
        rows.append({"shape": note, "kernel": kernel,
                     "wrapper_kernels": names,
                     **{k: statistics.median([x for x in v if x is not None]
                                             or [None])
                        for k, v in turns.items()},
                     "turns": turns})
    emit({"phase": "append_timing",
          "package": os.path.dirname(kq.__file__), "shapes": rows,
          "nvidia_smi": nvidia_smi()})
    return 0


def phase_fused_kernel(runners, prog, fprog) -> list:
    """fused_scan at the exact cell's shape: one drain megatick (K=8)
    from the state after the cell's 32 storm phases, and the same for the
    faulted cell, each through the cascade and the wave step body, in the
    resident layout and again tiled (forced) on the same
    input, against its plain version; then the edge cases, each launched
    resident and tiled against one plain run, and the fault-hash check.
    ``runners``: label -> (resident runner, tiled runner), fault-free and
    faulted, cascade and wave. Returns (the eight rows for the summary
    line, the tiled edge cases: ``phase_tiled_edge_cases``)."""
    rows = []
    for label, (resident, tiled) in runners.items():
        rows += drain_megatick_rows(
            resident, fprog if label.endswith("faulted") else prog, label,
            tiled=tiled)
    t0 = time.perf_counter()
    both = fused_edge_cases(("resident", "tiled"))
    edge_s = time.perf_counter() - t0
    edge = [r for r in both if r["layout"] == "resident"]
    hashes = fault_hash_check()
    emit({"phase": "fused_kernel", "tolerance": "bit-equal (integer work)",
          "storm_shape": rows[0], "storm_shape_tiled": rows[1],
          "faulted_storm_shape": rows[2],
          "faulted_storm_shape_tiled": rows[3],
          "wave_storm_shape": rows[4], "wave_storm_shape_tiled": rows[5],
          "wave_faulted_storm_shape": rows[6],
          "wave_faulted_storm_shape_tiled": rows[7],
          "edge_cases": edge, "fault_hash": hashes})
    return rows, ([r for r in both if r["layout"] == "tiled"], edge_s)


def phase_tiled_edge_cases(tiled_cases) -> None:
    """``fused_edge_cases`` through the tiled layout (forced), run beside
    the resident launches of ``phase_fused_kernel`` against the same
    plain runs (``tiled_cases``: the tiled rows and the seconds both
    layouts took): every case bit-equal to its plain version, and all
    four tiled instantiations (cascade and wave, with and without the
    fault arm) among them."""
    rows, run_s = tiled_cases
    arms = {(r["impl"], r["fault_arm"]) for r in rows
            if r["layout"] == "tiled"}
    emit({"phase": "tiled_edge_cases", "tolerance": "bit-equal (integer "
          "work)", "cases": len(rows), "instantiations": sorted(arms),
          "run_s_both_layouts": run_s, "edge_cases": rows})
    if len(arms) != 4 or any(r["layout"] != "tiled" for r in rows):
        raise AssertionError(f"tiled edge cases ran {sorted(arms)}")


def _timed_storm(runner, prog, warm_runner=None, warm_prog=None,
                 warm=True):
    """A warm run (of ``warm_runner``/``warm_prog`` when given; none when
    ``warm`` is false: the kernels it needs are built and loaded by an
    earlier phase), then the measured run of ``runner`` on ``prog`` with
    the launch counts zeroed just before it. Returns (final state,
    measurements)."""
    import torch

    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    t0 = time.perf_counter()
    if warm and warm_runner is None:
        runner.run_storm(runner.init_batch_device(), prog)
    elif warm:
        warm_runner.run_storm(warm_runner.init_batch_device(), warm_prog,
                              drain=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0 if warm else None
    state = runner.init_batch_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    folds = runner.kernel.fold_steps
    drain_folds = runner.kernel.drain_fold_steps
    reset_launch_counts()
    t0 = time.perf_counter()
    final = runner.run_storm(state, prog)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    folds = runner.kernel.fold_steps - folds
    drain_folds = runner.kernel.drain_fold_steps - drain_folds
    total_ticks = int(final.time.sum())
    max_ticks = int(final.time.max())
    return final, {
        "warm_run_s": warm_s, "run_s": dt, "total_ticks": total_ticks,
        "ticks_per_lane": total_ticks / runner.batch,
        "max_lane_ticks": max_ticks, "batched_ticks": max_ticks,
        "ms_per_batched_tick": dt / max_ticks * 1e3,
        "node_ticks_per_s": total_ticks * runner.topo.n / dt,
        "fold_steps": folds, "drain_fold_steps": drain_folds,
        "launches": launches,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _storm_meta(name, runner, prog, graph, snapshots) -> dict:
    return {"phase": name, "scheduler": runner.scheduler,
            "exact_impl": runner.kernel.exact_impl,
            "megatick": runner.megatick, "fused_tick": runner.fused,
            "fused_reason": runner.fused_reason,
            "fused_tile": runner.fused_tile,
            "fused_tile_reason": runner.fused_tile_reason, "graph": graph,
            "nodes": runner.topo.n, "edges": runner.topo.e,
            "batch": runner.batch, "phases": len(prog.amounts),
            "snapshots": snapshots,
            "queue_capacity": runner.config.queue_capacity,
            "max_recorded": runner.config.max_recorded,
            "record_dtype": "int16",
            "window_dtype": runner.config.window_dtype,
            "delay": f"{type(runner.delay).__name__}"
                     f"({getattr(runner.delay, 'seed', '')})"}


def _check_launches(name, launches, path_kernels, idle_kernels=()):
    idle = [k for k in path_kernels if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched by {name}: {idle}")
    busy = [k for k in idle_kernels if launches[k] != 0]
    if busy:
        raise AssertionError(f"{name} launched {busy}, which its path "
                             "must not run")


def _storm_verdict(runner, final, snapshots, faulted) -> tuple:
    """The validity checks of a storm's final state: conservation delta
    0; no error bit (under the adversary: none but ERR_SNAPSHOT_TIMEOUT,
    on quarantined lanes); every snapshot of every clean lane complete
    (without the adversary: every lane's ``snapshots``). Returns (the
    fields for the phase's line, the checks that failed)."""
    from chandy_lamport_tpu_torch import BatchedRunner
    from chandy_lamport_tpu_torch.core.state import ERR_SNAPSHOT_TIMEOUT
    from chandy_lamport_tpu_torch.utils.metrics import conservation_delta

    summary = BatchedRunner.summarize(final)
    delta = int(conservation_delta(final, runner.config, runner.batch * int(
        runner.topo.tokens0.sum())))
    clean = final.error == 0
    done = final.started & (final.completed >= runner.topo.n)
    incomplete = int((final.started & ~done)[clean].sum())
    out = {key: summary[key] for key in (
        "error_bits", "errors_decoded", "snapshots_started",
        "snapshots_completed", "fault_events", "fault_skew",
        "snapshot_lifecycle")}
    out.update(conservation_delta=delta,
               quarantined_lanes=int((~clean).sum()),
               incomplete_on_clean_lanes=incomplete)
    bad = []
    if delta:
        bad.append(f"conservation delta {delta}")
    if summary["error_bits"] & ~(ERR_SNAPSHOT_TIMEOUT if faulted else 0):
        bad.append(f"error bits {summary['errors_decoded']}")
    if incomplete:
        bad.append(f"{incomplete} snapshots incomplete on lanes without "
                   "error bits")
    expected = runner.batch * snapshots
    if not faulted and not (summary["snapshots_started"]
                            == summary["snapshots_completed"] == expected):
        bad.append(f"snapshots {summary['snapshots_started']} started, "
                   f"{summary['snapshots_completed']} completed, "
                   f"{expected} expected")
    return out, bad


def phase_storm(name, runner, prog, graph, snapshots, path_kernels):
    """A storm through the port's entry points: a warm run of its first
    4 phases (the kernels are built and loaded by then; it warms the
    allocator at the batch's sizes), then the measured run with launch
    counts zeroed just before it. Fails unless it is clean and every
    kernel of ``path_kernels`` launched. Returns (final state,
    measurements)."""
    final, m = _timed_storm(runner, prog, runner,
                            (prog.amounts[:4], prog.snap[:4]))
    out, bad = _storm_verdict(runner, final, snapshots, False)
    emit({**_storm_meta(name, runner, prog, graph, snapshots), **m, **out})
    if bad:
        raise AssertionError(f"{name}: {bad}")
    _check_launches(name, m["launches"], path_kernels)
    return final, m


def phase_fault_storm(name, runner, prog, path_kernels):
    """Main paths 3, 6 and 9, the faulted exact storm at megatick 1 and 8
    (module docstring): warm run at F_WARM_BATCH lanes over a few phases,
    timed run at the runner's batch. Returns (final state,
    measurements)."""
    warm_runner, _ = fault_runner("cuda", F_WARM_BATCH, runner.megatick,
                                  runner.kernel.exact_impl)
    final, m = _timed_storm(runner, prog, warm_runner,
                            (prog.amounts[:4], prog.snap[:4]))
    del warm_runner
    out, bad = _storm_verdict(runner, final, X_SNAPSHOTS, True)
    clean = final.error == 0
    emit({**_storm_meta(name, runner, prog, "er", X_SNAPSHOTS),
          **m, "faults": runner.faults.describe(),
          "snapshot_timeout": runner.config.snapshot_timeout,
          "snapshot_retries": runner.config.snapshot_retries,
          "quarantine": runner.quarantine,
          "max_clean_lane_ticks": (int(final.time[clean].max())
                                   if bool(clean.any()) else 0), **out})
    fired = out["fault_events"]
    if not all(v > 0 for v in fired.values()):
        bad.append(f"a fault class never fired: {fired}")
    if out["snapshot_lifecycle"]["retried"] <= 0:
        bad.append("the supervisor never retried")
    if bad:
        raise AssertionError(f"{name}: {bad}")
    _check_launches(name, m["launches"], path_kernels,
                    idle_kernels=("queue_step",))
    return final, m


def fault_sync_kernel_checks(runner, prog) -> dict:
    """Rows 1 and 3-5 against their plain versions on the faulted sync
    tick's own operands, from a state 8 phases into the faulted config-4
    storm: the crash gate's spread of the down nodes ([B, N] bool onto the
    in-edges; and of a mask with half the nodes down), the closed
    windows' sum_by_perm ([B, S, E] bool), the heads of the faulted rings
    and the duplicates' append_rows (the tick's dup mask at the tail of
    the rings, with fault-stream receive times). Returns {case: max
    |kernel - plain|}; every case must be 0."""
    import torch

    from chandy_lamport_tpu_torch.kernels import queue as kq
    from chandy_lamport_tpu_torch.kernels import segment as ks

    kern, f = runner.kernel, runner.faults
    s = runner.run_storm(runner.init_batch_device(),
                         (prog.amounts[:8], prog.snap[:8]), drain=False)
    t = s.time + 1
    down = f.down_nodes(s.fault_key, t, runner.topo.n)
    half = (torch.rand(down.shape, generator=torch.Generator().manual_seed(
        11)) < 0.5).to(down.device)
    _, dup, _, dupw = f.edge_masks(s.fault_key, t, runner.topo.e)
    closed = s.m_pending & s.recording
    out = {}
    for note, x in (("down nodes", down), ("half the nodes", half)):
        out[f"spread {list(x.shape)} bool, {note}"] = max_abs_err(
            [ks.spread(x, kern._edge_dst)],
            [ks.spread_plain(x, kern._edge_dst)])
    out[f"sum_by_perm {list(closed.shape)} bool, closed windows"] = \
        max_abs_err([kern._sum_by_dst(closed)],
                    [ks.sum_by_perm_plain(closed, kern._by_dst, kern._dst_lo,
                                          kern._dst_hi)])
    heads = kq.head_fields(s.q_meta, s.q_data, s.q_head)
    out[f"head_fields {list(s.q_meta.shape)}"] = max_abs_err(
        list(heads), list(kq.head_fields_plain(s.q_meta, s.q_data,
                                               s.q_head)))
    rt = kern._dup_times(s, dupw)
    leaves = (s.q_meta, s.q_data, s.q_head, s.q_len, s.tok_pushed, s.error)
    kw = dict(capacity=runner.config.queue_capacity,
              key_limit=kern._key_limit)
    got = kq.append_rows(*clones(leaves), dup, rt, False, heads[2], **kw)
    want = kq.append_rows_plain(*clones(leaves), dup, rt, False, heads[2],
                                **kw)
    out[f"append_rows {list(s.q_meta.shape)}, "
        f"{int(dup.sum())} duplicate rows"] = max_abs_err(got, want)
    return out


def phase_fault_sync_storm(runner, prog):
    """Main path 18: config 4's sync storm under the faulted exact cell's
    adversary, its supervisor and quarantine (the JAX storm CLI's default
    scheduler under faults): the kernel checks on its operands
    (``fault_sync_kernel_checks``), a warm run at F_WARM_BATCH lanes over
    4 phases, the timed run at FS_BATCH lanes, judged by the faulted rule; rows
    1-5 launched, rows 6-8 never. Returns (final state, measurements)."""
    checks = fault_sync_kernel_checks(runner, prog)
    warm_runner, _ = config4_runner("cuda", faulted=True,
                                    batch=F_WARM_BATCH)
    final, m = _timed_storm(runner, prog, warm_runner,
                            (prog.amounts[:4], prog.snap[:4]))
    del warm_runner
    out, bad = _storm_verdict(runner, final, SNAPSHOTS, True)
    emit({**_storm_meta("fault_sync_storm", runner, prog, "sf", SNAPSHOTS),
          **m, "faults": runner.faults.describe(),
          "snapshot_timeout": runner.config.snapshot_timeout,
          "snapshot_retries": runner.config.snapshot_retries,
          "quarantine": runner.quarantine, "kernel_checks": checks, **out})
    bad += [f"{case}: kernel != plain" for case, err in checks.items()
            if err]
    if bad:
        raise AssertionError(f"fault_sync_storm: {bad}")
    _check_launches("fault_sync_storm", m["launches"],
                    ("sum_by_perm", "sum_segments", "spread", "head_fields",
                     "append_rows"),
                    idle_kernels=("queue_step", "select_pop", "fused_scan"))
    return final, m


def _chunked_resume(name, runner, prog, whole, fresh, tmp) -> dict:
    """The storm of ``runner`` on ``prog`` in chunks of CK_CHUNK phases
    with a checkpoint after each: after the first, a fresh runner
    (``fresh()``) loads the file from disk and runs the rest, then drains.
    Returns the line's fields: the file's bytes, each save's and the
    load's seconds, the resumed run's launches and the leaves where its
    final state differs from ``whole`` (the uninterrupted run's)."""
    import torch

    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from chandy_lamport_tpu_torch.utils.checkpoint import (
        load_state,
        save_state,
    )

    path = os.path.join(tmp, f"{name}.npz")
    phases = len(prog.amounts)

    def run(r, s, lo):
        hi = min(lo + CK_CHUNK, phases)
        s = r.run_storm(s, (prog.amounts[lo:hi], prog.snap[lo:hi]),
                        drain=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state(path, s, meta={"next_phase": hi}, delay=r.delay)
        saves.append(time.perf_counter() - t0)
        sizes.append(os.path.getsize(path))
        return s, hi

    saves, sizes = [], []
    s, lo = run(runner, runner.init_batch_device(), 0)
    del s
    resumed = fresh()
    like = resumed.init_batch_device()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, meta = load_state(path, like, delay=resumed.delay)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del like
    reset_launch_counts()
    while lo < phases:
        s, lo = run(resumed, s, lo)
    final = resumed.drain(s)
    torch.cuda.synchronize()
    launches = launch_counts()
    return {"file_bytes": sizes, "save_s": saves, "load_s": load_s,
            "resumed_at_phase": meta["next_phase"],
            "resumed_launches": {k: v for k, v in launches.items() if v},
            "leaves": len(whole._fields),
            "mismatched": _mismatched(final, whole)}


def phase_checkpoint() -> None:
    """Checkpoints on the card (utils/checkpoint.py): the faulted sync
    storm of main path 18 at CK_SYNC_BATCH lanes and the faulted ER-256
    storm at megatick 8 (its drain resumed into fused_scan), each run in
    chunks of CK_CHUNK phases with a save after each and resumed from
    disk after the first by a fresh runner, equal to its uninterrupted
    run leaf for leaf. The files go to a temporary directory this phase
    removes."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_")
    try:
        line = {"phase": "checkpoint", "chunk_phases": CK_CHUNK,
                "free_bytes": shutil.disk_usage(tmp).free}
        sync_runner, sync_prog = config4_runner("cuda", faulted=True,
                                                batch=CK_SYNC_BATCH)
        sync_final = sync_runner.run_storm(sync_runner.init_batch_device(),
                                           sync_prog)
        line["fault_sync_storm"] = _chunked_resume(
            "fault_sync_storm", sync_runner, sync_prog, sync_final,
            lambda: config4_runner("cuda", faulted=True,
                                   batch=CK_SYNC_BATCH)[0], tmp)
        line["fault_sync_storm"]["batch"] = CK_SYNC_BATCH
        del sync_runner, sync_final
        f8runner, f8prog = fault_runner("cuda", CK_EXACT_BATCH,
                                        megatick=MEGATICK)
        whole = f8runner.run_storm(f8runner.init_batch_device(), f8prog)
        line["fault_fused_storm"] = _chunked_resume(
            "fault_fused_storm", f8runner, f8prog, whole,
            lambda: fault_runner("cuda", CK_EXACT_BATCH,
                                 megatick=MEGATICK)[0], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(line)
    bad = {k: line[k]["mismatched"] for k in ("fault_sync_storm",
                                              "fault_fused_storm")
           if line[k]["mismatched"]}
    if bad:
        raise AssertionError(f"resumed storms differ from their "
                             f"uninterrupted runs in {bad}")
    if not line["fault_fused_storm"]["resumed_launches"].get("fused_scan"):
        raise AssertionError("the resumed megatick-8 storm never launched "
                             "fused_scan")


def _twin_check(name, final, m, twin_name, twin, twin_m) -> None:
    """A wave storm against its cascade twin: every leaf equal; one line
    with the host steps of both (the wave's waves against the cascade's
    marker folds) and their walls."""
    bad = _mismatched(final, twin)
    emit({"phase": f"{name}_vs_{twin_name}", "leaves": len(twin._fields),
          "mismatched": bad,
          "host_steps": {"wave": m["fold_steps"],
                         "cascade": twin_m["fold_steps"]},
          "drain_host_steps": {"wave": m["drain_fold_steps"],
                               "cascade": twin_m["drain_fold_steps"]},
          "run_s": {"wave": m["run_s"], "cascade": twin_m["run_s"]}})
    if bad:
        raise AssertionError(f"{name} differs from {twin_name} in {bad}")


def phase_tiled_vs_resident(storms) -> dict:
    """The ER-256 B=4096 storms of main paths 4, 8, 6 and 9 rerun in the
    tiled layout (forced): every fused launch tiled, and each
    final state leaf-equal to its resident twin's. ``storms``: name ->
    (tiled runner, program, the resident final state, its measurements).
    Returns the launch counts of each run, by path name."""
    paths, out = {}, {}
    for name, (runner, prog, twin, twin_m) in storms.items():
        final, m = _timed_storm(runner, prog, warm=False)
        bad = _mismatched(final, twin)
        del final
        fused = m["launches"]["fused_scan"]
        tiled = m["launches"]["fused_scan_tiled"]
        out[name] = {"mismatched": bad, "fused_tile": runner.fused_tile,
                     "fused_scan_tiled": tiled, "fused_scan": fused,
                     "run_s": {"tiled": m["run_s"],
                               "resident": twin_m["run_s"]},
                     "host_steps": m["fold_steps"],
                     "workspace_bytes":
                         runner.kernel.fused_workspace.numel()}
        paths[f"tiled_{name}"] = m["launches"]
        if bad or runner.fused_tile != "on" or not 0 < tiled == fused:
            raise AssertionError(f"tiled {name}: {out[name]}")
    emit({"phase": "tiled_vs_resident", "storms": out})
    return paths


def phase_sf2048_tiled_cascade_storm() -> dict:
    """The oversized cascade lane: SF-2048 at S=8 (``T_*``), megatick 8,
    tiled by "auto", fault-free and under ``T_PROGRAM``: each clean and
    leaf-equal to the same storm at megatick 1 through the wave (which
    gives the cascade's bits without a supervisor; the cascade's own
    megatick-1 twin folded ~9,100 host steps, 30-33 s a twin). Returns
    the megatick-8 runs' launch counts, by path."""
    from chandy_lamport_tpu_torch.models.faults import Faults

    paths, out = {}, {}
    for arm, kw in (("fault_free", {}),
                    ("faulted", dict(faults=Faults(3, **T_PROGRAM)))):
        runs = {}
        for k in (MEGATICK, 1):
            runner, prog = exact_runner("cuda", T_BATCH, T_NODES, T_PHASES,
                                        T_SNAPSHOTS, graph="sf", megatick=k,
                                        exact_impl="cascade" if k > 1
                                        else "wave", **kw)
            final, m = _timed_storm(runner, prog, warm=False)
            runs[k] = (runner, final, m)
        runner, final, m = runs[MEGATICK]
        _, twin, twin_m = runs[1]
        bad = _mismatched(final, twin)
        checks, failed = _storm_verdict(runner, final, T_SNAPSHOTS,
                                        "faults" in kw)
        del runs, twin
        out[arm] = {**_storm_meta(arm, runner, prog, "sf", T_SNAPSHOTS),
                    **m, **checks, "mismatched": bad,
                    "workspace_bytes": runner.kernel.fused_workspace.numel(),
                    "megatick1_twin": {"exact_impl": "wave", **{
                        key: twin_m[key] for key in (
                            "run_s", "fold_steps", "drain_fold_steps",
                            "node_ticks_per_s")}}}
        paths[f"sf2048_tiled_cascade_{arm}"] = m["launches"]
        del final
        if failed or bad or runner.fused_tile != "on" or \
                m["launches"]["fused_scan_tiled"] <= 0:
            emit({"phase": "sf2048_tiled_cascade_storm", **out})
            raise AssertionError(f"sf2048_tiled_cascade_storm {arm}: tiled "
                                 f"{runner.fused_tile}, launches "
                                 f"{m['launches']}, mismatched {bad}, "
                                 f"{failed}")
    emit({"phase": "sf2048_tiled_cascade_storm", **out})
    return paths


def phase_config5_wave_fused_storm() -> tuple:
    """Main path 10: config 5's exact wave storm at megatick 8 (``C5_*``,
    ``config5_runner``), its lane tiled by "auto": clean, every snapshot
    complete, every kernel of its path launched (fused_scan in the tiled
    layout), and leaf-equal to the same storm at megatick 1; then one of
    its drain megaticks against the plain version, timed, beside its
    bound. Returns (the launch counts, the drain megatick's rows, the
    final state and its measurements)."""
    name = "config5_wave_fused_storm"
    runner, prog = config5_runner("cuda")
    if runner.fused_tile != "on":
        raise AssertionError(f"{name} did not tile: "
                             f"{runner.fused_tile_reason}")
    final, m = _timed_storm(runner, prog, warm=False)
    checks, failed = _storm_verdict(runner, final, C5_SNAPSHOTS, False)
    workspace = runner.kernel.fused_workspace.numel()
    twin_runner, _ = config5_runner("cuda", megatick=1)
    twin, twin_m = _timed_storm(twin_runner, prog, warm=False)
    bad = _mismatched(final, twin)
    del twin, twin_runner
    rows = drain_megatick_rows(runner, prog, "wave fault-free", graph="sf")
    emit({**_storm_meta(name, runner, prog, "sf", C5_SNAPSHOTS), **m,
          **checks, "main_path": True, "workspace_bytes": workspace,
          "host_waves": m["fold_steps"],
          "fused_scan_tiled_launches": m["launches"]["fused_scan_tiled"],
          "megatick1_twin": {"mismatched": bad, **{
              key: twin_m[key] for key in ("run_s", "fold_steps",
                                           "drain_fold_steps",
                                           "node_ticks_per_s")}},
          "drain_megatick": rows[0]})
    if failed or bad:
        raise AssertionError(f"{name}: {failed}, differs from megatick 1 "
                             f"in {bad}")
    _check_launches(name, m["launches"], (
        "fused_scan", "fused_scan_tiled", "queue_step", "append_rows",
        "append_marker_rows", "sum_by_perm", "sum_segments", "spread"))
    return m["launches"], rows, final, m


# ---- the streaming job engine (run_stream) -----------------------------------

def stream_runner(device, batch=X_BATCH, megatick=MEGATICK,
                  exact_impl="cascade", faulted=False, tiled=False,
                  trace=None, memo="off", memo_cache=None):
    """The streaming cell's runner (``ST_*``: the bench's ER-256 with 8
    snapshot slots) and its topology spec; ``faulted``: fault_storm's
    adversary and supervisor, quarantined; ``memo`` / ``memo_cache``: the
    memo plane."""
    from chandy_lamport_tpu_torch.models.faults import Faults
    from chandy_lamport_tpu_torch.models.workloads import erdos_renyi

    kw = (dict(faults=Faults(3, **F_PROGRAM), snapshot_timeout=F_TIMEOUT)
          if faulted else {})
    runner, _ = exact_runner(device, batch, X_NODES, ST_PHASES,
                             ST_SNAPSHOTS, megatick=megatick,
                             exact_impl=exact_impl, tiled=tiled,
                             trace=trace, memo=memo, memo_cache=memo_cache,
                             **kw)
    return runner, erdos_renyi(X_NODES, 3.0, seed=3, tokens=ST_PHASES + 10)


def stream_queue(runner, spec, faulted=False, per_lane=3,
                 max_phases=ST_PHASES, **traffic):
    """The bench's job queue for ``runner`` (J = ``per_lane`` x B jobs of
    at most ``max_phases`` phases; ``traffic``: stream_jobs' duplicate
    or prefix shape) and its pool (content-keyed when ``runner``'s memo
    is on: under "prefix" its identities are keyed on the first phase, so
    every arm of a memo phase drives the one pool); the adversary armed
    on every third job when ``faulted``."""
    from chandy_lamport_tpu_torch.models.workloads import stream_jobs

    jcount = int(per_lane * runner.batch)
    jobs = stream_jobs(spec, jcount, seed=DELAY_SEED, base_phases=4,
                       tail_alpha=1.1, max_phases=max(max_phases, 8),
                       **traffic)
    armed = [j % 3 == 0 for j in range(jcount)] if faulted else None
    return jobs, runner.pack_jobs(jobs, fault_armed=armed)


def drive_stream(runner, pool, admission="stream") -> tuple:
    """One ``run_stream`` drive with the launch counts zeroed just before
    it. Returns (state, stream, measurements)."""
    import torch

    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    kern = runner.kernel
    folds, drain_folds = kern.fold_steps, kern.drain_fold_steps
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, stream = runner.run_stream(pool, stretch=ST_STRETCH,
                                      drain_chunk=ST_CHUNK,
                                      admission=admission)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    summary = runner.summarize_stream(stream)
    return state, stream, {
        "run_s": dt, "jobs_per_s": pool.num_jobs / dt,
        "steps": summary["steps"], "occupancy": summary["occupancy"],
        "refills": summary["refills"], "jobs_done": summary["jobs_done"],
        "host_fold_steps": kern.fold_steps - folds,
        "drain_host_fold_steps": kern.drain_fold_steps - drain_folds,
        "launches": launch_counts()}


def static_oracle(make_solo, pool, jobs, rows, sampled) -> list:
    """The jobs of ``sampled``, each alone through ``run`` on a one-lane
    runner (``make_solo()``) with its pool row's delay stream and fault
    key: the job ids whose summary differs from its stream row."""
    from chandy_lamport_tpu_torch.ops.tick import harvest_lane_summaries
    from chandy_lamport_tpu_torch.parallel.batch import compile_events

    solo = make_solo()
    by_job = {r["job"]: r for r in rows}
    bad = []
    for j in sampled:
        s = solo.init_batch_device()
        s = s._replace(delay_state=tuple(w[j:j + 1]
                                         for w in pool.delay_state),
                       fault_key=pool.fault_key[j:j + 1])
        out = solo.run(s, compile_events(solo.topo, jobs[j]))
        h = harvest_lane_summaries(out, solo.topo.n)
        row = by_job[j]
        got = (row["time"], row["error"], row["tokens"],
               row["snapshots_started"], row["snapshots_completed"],
               row["snapshots_failed"], row["fault_skew"],
               row["fault_events"])
        want = (int(h["time"][0]), int(h["error"][0]),
                h["tokens"][0].tolist(), int(h["snap_started"][0]),
                int(h["snap_completed"][0]), int(h["snap_failed"][0]),
                int(h["fault_skew"][0]), int(h["fault_events"][0]))
        if got != want:
            bad.append(j)
    return bad


def _sample(jcount: int, k: int) -> list:
    """``k`` job ids spread over the queue, the last one included (the
    heavy tail retires last), from a fixed seed."""
    import numpy as np

    picks = np.random.default_rng(5).choice(jcount - 1, k - 1,
                                            replace=False)
    return sorted(int(j) for j in picks) + [jcount - 1]


def capture_stream_passes(runner, pool) -> tuple:
    """Drive the stream until its queue has run dry, then capture the
    inputs of the drain slice (the state, ``in_drain``, the limits) and
    of the flush pass (the state, the stage-3 mask) of the first later
    step that runs both: a mid-stream state whose lanes are in the script
    (the tail's long jobs), the drain, the flush, or idle (retired, with
    nothing left to admit). Returns (the captures, the step's number)."""
    from chandy_lamport_tpu_torch import BatchedRunner

    tk, own = runner.kernel, BatchedRunner._own
    drain, flush = tk._stream_drain, tk._stream_flush
    seen = {}

    def spy_drain(s, in_drain, limit, chunk):
        seen["drain"] = (own(s), in_drain.clone(), limit.clone(),
                         runner._stage_of(s, pool))
        return drain(s, in_drain, limit, chunk)

    def spy_flush(s, live):
        seen["flush"] = (own(s), live.clone(), runner._stage_of(s, pool))
        return flush(s, live)

    s, st = runner.init_batch_device(), runner.init_stream(pool)
    while int(st.next_job) < pool.num_jobs:
        s, st = runner._stream_step(s, st, pool, ST_STRETCH, ST_CHUNK, False)
    for _ in range(ST_CAPTURE_STEPS):
        seen.clear()
        tk._stream_drain, tk._stream_flush = spy_drain, spy_flush
        try:
            s, st = runner._stream_step(s, st, pool, ST_STRETCH, ST_CHUNK,
                                        False)
        finally:
            del tk._stream_drain, tk._stream_flush
        if len(seen) == 2:
            return dict(seen), int(st.steps)
    raise AssertionError("no stream step ran both a drain slice and a "
                         f"flush in the {ST_CAPTURE_STEPS} steps after the "
                         "queue ran dry")


def phase_stream_kernel() -> list:
    """fused_scan's lane gate on the stream's own inputs: a mid-stream
    state of the streaming cell (B=4096, ``capture_stream_passes``: lanes
    in the script, the drain, the flush and idle), its
    gated drain megatick (``live`` = the lanes in their drain, per-job
    limits) and its gated flush, each launched resident and again through
    a forced-tiled runner, bit-equal to ``fused_ticks_plain``; the
    resident drain megatick timed per launch beside its bound. Returns
    the drain megatick's row for the summary line."""
    import torch

    from chandy_lamport_tpu_torch import BatchedRunner
    from chandy_lamport_tpu_torch.kernels import megatick as km

    runner, spec = stream_runner("cuda")
    tiled, _ = stream_runner("cuda", tiled=True)
    _, pool = stream_queue(runner, spec)
    seen, step = capture_stream_passes(runner, pool)
    own, tk = BatchedRunner._own, runner.kernel
    s0, in_drain, limit, stage = seen["drain"]
    f0, flush_live, fstage = seen["flush"]

    def stages(st):
        return {name: int((st == k).sum()) for k, name in (
            (0, "idle_or_retired"), (1, "script"), (2, "drain"),
            (3, "flush"))}

    def drain(t, x):
        return km.fused_ticks(t, x, mode="drain", length=MEGATICK,
                              live=in_drain, limit=limit)

    def flush(t, x):
        return km.fused_ticks(t, x, mode="flush",
                              length=runner.config.max_delay + 1,
                              live=flush_live)

    want, plain_ms, nbytes, ops, moved = fused_plain_and_bytes(
        tk, s0, limit, live=in_drain)
    t0 = time.perf_counter()
    want_flush = km.fused_ticks_plain(tk, own(f0), mode="flush",
                                      length=runner.config.max_delay + 1,
                                      live=flush_live)
    torch.cuda.synchronize()
    plain_flush_ms = (time.perf_counter() - t0) * 1e3
    checks = {}
    for layout, r in (("resident", runner), ("tiled", tiled)):
        got = drain(r.kernel, own(s0))
        got_flush = flush(r.kernel, own(f0))
        torch.cuda.synchronize()
        checks[layout] = {
            "drain_mismatched": _mismatched(got, want),
            "drain_max_abs_err": max_abs_err(_leaves(got), _leaves(want)),
            "flush_mismatched": _mismatched(got_flush, want_flush),
            "flush_max_abs_err": max_abs_err(_leaves(got_flush),
                                             _leaves(want_flush)),
            "layout": _layout(r)}
        del got, got_flush
    ms = time_launch_ms(lambda x: drain(tk, x), lambda: own(s0))
    tiled_ms = time_launch_ms(lambda x: drain(tiled.kernel, x),
                              lambda: own(s0))
    flush_ms = time_launch_ms(lambda x: flush(tk, x), lambda: own(f0))
    lane_ticks = int((want.time - s0.time).sum())
    row = {"shape": f"[{runner.batch}] lanes of er-{runner.topo.n} "
                    f"(E={runner.topo.e}, C={runner.config.queue_capacity})"
                    f", the gated drain megatick K={MEGATICK} of stream "
                    f"step {step}, {int(in_drain.sum())} lanes"
                    f" in their drain, {lane_ticks} lane-ticks",
           "layout": "resident", "max_abs_err":
               checks["resident"]["drain_max_abs_err"], "ms": ms,
           "plain_ms": plain_ms,
           "plain_timing": "K one-step calls, host clock",
           "library_ms": None, "bytes_moved": moved, **bound(nbytes, ops)}
    emit({"phase": "stream_kernel", "tolerance": "bit-equal (integer work)",
          "drain_stages": stages(stage), "flush_stages": stages(fstage),
          "flush_lanes": int(flush_live.sum()), "checks": checks,
          "drain_megatick": row, "tiled_drain_ms": tiled_ms,
          "tiled_over_resident": tiled_ms / ms, "flush_ms": flush_ms,
          "plain_flush_ms": plain_flush_ms})
    mixed = stages(stage)
    bad = [k for k, v in checks.items()
           if v["drain_mismatched"] or v["flush_mismatched"]]
    if bad or checks["tiled"]["layout"] != "tiled":
        raise AssertionError(f"the gated drain or flush != plain: {checks}")
    if min(mixed["script"], mixed["drain"], mixed["idle_or_retired"]) <= 0 \
            or int(flush_live.sum()) <= 0 or lane_ticks <= 0:
        raise AssertionError(f"the captured state does not mix the stages: "
                             f"{mixed}, {int(flush_live.sum())} flushing")
    del seen, s0, f0, want, want_flush
    return [row]


def _stream_line(name, runner, pool, m) -> dict:
    return {"phase": name, "scheduler": runner.scheduler,
            "exact_impl": runner.kernel.exact_impl,
            "megatick": runner.megatick, "fused_tick": runner.fused,
            "fused_tile": runner.fused_tile, "nodes": runner.topo.n,
            "edges": runner.topo.e, "batch": runner.batch,
            "jobs": pool.num_jobs, "stretch": ST_STRETCH,
            "drain_chunk": ST_CHUNK,
            "queue_capacity": runner.config.queue_capacity,
            "max_snapshots": runner.config.max_snapshots,
            "delay": f"hash({DELAY_SEED})", **m}


def _cascade_twin(make) -> dict:
    """The cascade's megatick-1 twin at reduced depth: a queue of
    ``ST_TWIN_JOBS_PER_LANE`` x B jobs of at most ``ST_TWIN_MAX_PHASES``
    phases at the cell's width and batch, through ``make(MEGATICK)`` and
    ``make(1)``; their per-job rows (``admit_step`` included) must be
    equal."""
    runner, spec = make(MEGATICK)
    _, pool = stream_queue(runner, spec, per_lane=ST_TWIN_JOBS_PER_LANE,
                           max_phases=ST_TWIN_MAX_PHASES)
    stream, m = drive_stream(runner, pool)[1:]
    rows = runner.stream_results(stream)
    del runner, stream
    twin_runner, _ = make(1)
    tstream, tm = drive_stream(twin_runner, pool)[1:]
    line = {"jobs": pool.num_jobs, "max_phases": ST_TWIN_MAX_PHASES,
            "exact_impl": twin_runner.kernel.exact_impl,
            "megatick8": {k: v for k, v in m.items() if k != "launches"},
            **{k: v for k, v in tm.items() if k != "launches"},
            "rows_equal": twin_runner.stream_results(tstream) == rows}
    return line


def phase_stream(name, make, sampled: int, path_kernels, idle_kernels=(),
                 faulted=False, twin=None, cascade_twin=False,
                 per_lane=3) -> dict:
    """A streaming run through ``run_stream`` (``make(megatick)`` builds
    the runner and its spec): the stream drive with the launch counts
    zeroed just before it (the main path's), then the gang drive, the
    same queue at megatick 1 through the wave (``twin()`` builds that
    runner, None for none: the wave folds a few hundred host steps where
    the cascade folds tens of thousands, and the two give the same bits),
    with ``cascade_twin`` the cascade's own megatick-1 twin at reduced
    depth (``_cascade_twin``), and ``sampled`` jobs alone through ``run``;
    the queue holds ``per_lane`` x B jobs.
    Every job retires (with error 0, unless ``faulted``: then no bit but
    ERR_SNAPSHOT_TIMEOUT), stream and gang give equal job rows, every row
    (``admit_step`` included) equals its megatick-1 twin's and every
    sampled job its static run; every kernel of ``path_kernels`` launched
    in the stream drive, none of ``idle_kernels``. Returns the stream
    drive's launch counts."""
    from chandy_lamport_tpu_torch import bench
    from chandy_lamport_tpu_torch.core.state import ERR_SNAPSHOT_TIMEOUT

    runner, spec = make(MEGATICK)
    jobs, pool = stream_queue(runner, spec, faulted, per_lane=per_lane)
    jcount = pool.num_jobs
    _, stream, m = drive_stream(runner, pool)
    rows = runner.stream_results(stream)
    line = _stream_line(name, runner, pool, m)
    bad = []
    errored = [r for r in rows if r["error"]]
    if len(rows) != jcount or m["jobs_done"] != jcount:
        bad.append(f"{jcount - len(rows)} jobs never retired")
    if faulted:
        stray = [r["job"] for r in errored
                 if r["error"] & ~ERR_SNAPSHOT_TIMEOUT]
        if stray:
            bad.append(f"jobs with bits beyond ERR_SNAPSHOT_TIMEOUT: "
                       f"{stray[:8]}")
        line["jobs_errored"] = len(errored)
        line["fault_events"] = sum(r["fault_events"] for r in rows)
    elif errored:
        bad.append(f"{len(errored)} jobs retired with error bits "
                   f"(first {errored[0]})")
    _, gstream, gm = drive_stream(runner, pool, "gang")
    same = bench.job_rows(runner, gstream) == bench.job_rows(runner, stream)
    line["gang"] = {**{k: v for k, v in gm.items() if k != "launches"},
                    "rows_equal": same}
    line["speedup_vs_static"] = gm["run_s"] / m["run_s"]
    if not same:
        bad.append("stream and gang admission gave different job rows")
    del gstream, runner
    if twin is not None:
        twin_runner = twin()
        _, tstream, tm = drive_stream(twin_runner, pool)
        same = twin_runner.stream_results(tstream) == rows
        line["megatick1_twin"] = {
            **{k: v for k, v in tm.items() if k != "launches"},
            "exact_impl": twin_runner.kernel.exact_impl, "rows_equal": same}
        if not same:
            bad.append("rows differ from the megatick-1 twin's")
        del tstream, twin_runner
    if cascade_twin:
        line["cascade_megatick1_twin"] = _cascade_twin(make)
        if not line["cascade_megatick1_twin"]["rows_equal"]:
            bad.append("rows differ from the cascade's megatick-1 twin's")
    STREAM_JOBS_PER_STEP[name] = jcount / m["steps"]
    picks = _sample(jcount, sampled)
    t0 = time.perf_counter()
    oracle = static_oracle(lambda: make(MEGATICK, batch=1)[0], pool, jobs,
                           rows, picks)
    line["static_oracle"] = {"sampled": len(picks), "mismatched": oracle,
                             "run_s": time.perf_counter() - t0}
    if oracle:
        bad.append(f"sampled jobs differ from their static runs: {oracle}")
    emit(line)
    if bad:
        raise AssertionError(f"{name}: {bad}")
    _check_launches(name, m["launches"], path_kernels, idle_kernels)
    return m["launches"]


# each stream phase's jobs retired a step (its stream drive's J / steps):
# serve_edf's arrival rate is twice stream_exact's
STREAM_JOBS_PER_STEP: dict = {}


def sync_stream_runner(batch=SS_BATCH):
    """The sync stream: config 4's graph (SF-1k) and config (S=8, split
    markers, int16 log), hash delay 17, at ``batch`` lanes; and its
    topology spec."""
    from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
    from chandy_lamport_tpu_torch.models.workloads import scale_free
    from chandy_lamport_tpu_torch.ops.delay import HashDelay

    spec = scale_free(NODES, ATTACH, seed=3, tokens=ST_PHASES + 10)
    cfg = SimConfig.for_workload(snapshots=SNAPSHOTS, split_markers=True,
                                 record_dtype="int16")
    return BatchedRunner(spec, cfg, HashDelay(DELAY_SEED), batch,
                         scheduler="sync", device="cuda"), spec


def phase_streams() -> tuple:
    """The stream phases: the kernel check, then main path 11
    (stream_exact, the streaming cell at full width), stream_wave,
    stream_fault and stream_sync. Returns (the launch counts by path,
    the gated drain megatick's summary row)."""
    rows = phase_stream_kernel()
    # the stream's sends are scalar pushes; its appends are the
    # broadcasts (and, in the wave, each wave's)
    exact_kernels = ("fused_scan", "queue_step", "append_marker_rows",
                     "sum_by_perm")
    # the whole queues' megatick-1 twins run through the wave: the
    # cascade's twin of the streaming cell folded 30,954 host steps (94-101
    # s on the H100), the faulted cascade's ~35k at B=512 (117 s); the
    # wave folds a few hundred, and the two forms give the same bits. The
    # cascade's own twin runs a shorter queue at the cell's width.
    paths = {"stream_exact": phase_stream(
        "stream_exact", lambda k, batch=X_BATCH: stream_runner(
            "cuda", batch, k), ST_SAMPLED, exact_kernels,
        idle_kernels=("sum_segments", "select_pop"),
        twin=lambda: stream_runner("cuda", X_BATCH, 1,
                                   exact_impl="wave")[0],
        cascade_twin=True, per_lane=ST_PER_LANE)}
    paths["stream_wave"] = phase_stream(
        "stream_wave", lambda k, batch=STW_BATCH: stream_runner(
            "cuda", batch, k, exact_impl="wave"), SMALL_SAMPLED,
        exact_kernels + ("append_rows", "spread"),
        idle_kernels=("sum_segments",),
        twin=lambda: stream_runner("cuda", STW_BATCH, 1,
                                   exact_impl="wave")[0])
    paths["stream_fault"] = phase_stream(
        "stream_fault", lambda k, batch=STF_BATCH: stream_runner(
            "cuda", batch, k, exact_impl="wave", faulted=True),
        SMALL_SAMPLED, ("fused_scan", "select_pop", "head_fields",
                        "append_rows", "append_marker_rows", "sum_by_perm",
                        "spread"),
        idle_kernels=("queue_step",), faulted=True,
        twin=lambda: stream_runner("cuda", STF_BATCH, 1, exact_impl="wave",
                                   faulted=True)[0], per_lane=ST_PER_LANE)
    # the sync scheduler ticks one at a time: no megatick, so no twin
    paths["stream_sync"] = phase_stream(
        "stream_sync", lambda k, batch=SS_BATCH: sync_stream_runner(batch),
        SMALL_SAMPLED,
        ("head_fields", "sum_by_perm", "spread"),
        idle_kernels=("fused_scan", "queue_step"))
    return paths, rows


# ---- the stream's memo plane (memo_stream, prefix_stream) ---------------------

def memo_arm(name, runner, pool, off_rows, path_kernels) -> tuple:
    """One drive of ``runner`` on ``pool`` with the launch counts zeroed
    just before it (``drive_stream``): its served rows held to
    ``off_rows`` (every job served, no error bit), its launches to
    ``path_kernels``. Returns (the final state, the arm's line)."""
    from chandy_lamport_tpu_torch.bench import served_rows

    state, stream, m = drive_stream(runner, pool)
    rows = served_rows(runner, stream)
    summary = runner.summarize_stream(stream)
    line = {k: v for k, v in m.items() if k != "jobs_per_s"}
    line.update({key: summary[key] for key in (
        "cache_hits", "coalesced_jobs", "ff_skipped_ticks", "shadow_checks",
        "memo_hit_rate", "prefix_hits", "forked_jobs", "fork_depth_mean",
        "cache_evictions", "prefix_store_entries")})
    line.update(memo=runner.memo, served=len(rows),
                executed=summary["jobs_done"],
                effective_jobs_per_s=len(rows) / m["run_s"],
                memo_timing=dict(runner.memo_timing),
                rows_equal_off=rows == off_rows)
    bad = []
    if len(rows) != pool.num_jobs:
        bad.append(f"{pool.num_jobs - len(rows)} jobs never served")
    if not line["rows_equal_off"]:
        bad.append("served rows differ from the memo-off arm's")
    if bad:
        emit({"phase": name, **line})
        raise AssertionError(f"{name}: {bad}")
    _check_launches(name, m["launches"], path_kernels)
    return state, line


# the memo cells' path: the streaming cell's (stream_exact's) kernels
MEMO_KERNELS = ("fused_scan", "queue_step", "append_marker_rows",
                "sum_by_perm")


def phase_memo_stream() -> dict:
    """The streaming cell's queue cut to J = MEMO_PER_LANE x B = 6,144 at
    the README's 80 % duplicate shape, packed once with content keys,
    through three arms:
    memo "off"; "full" on a cold summary-cache file in a temporary
    directory (empty at its start, as an in-memory cache; the arm
    flushes it at its end); and a warm "admit" on that file. Every row
    of both memo arms equals the off arm's; the signature's device ms per
    step is timed on the full arm's final state. Returns the full arm's
    launch counts (the main path's)."""
    import shutil
    import tempfile

    from chandy_lamport_tpu_torch.bench import served_rows
    from chandy_lamport_tpu_torch.parallel.batch import _lane_signature

    tmp = tempfile.mkdtemp(prefix="chip_smoke_memo_")
    try:
        cache = os.path.join(tmp, "summaries.jsonl")
        full, spec = stream_runner("cuda", memo="full", memo_cache=cache)
        pool = stream_queue(full, spec, per_lane=MEMO_PER_LANE,
                            dup_rate=MEMO_DUP)[1]
        off, _ = stream_runner("cuda")
        _, ostream, om = drive_stream(off, pool)
        off_rows = served_rows(off, ostream)
        errored = [r["job"] for r in off_rows if r["error"]]
        if len(off_rows) != pool.num_jobs or errored:
            raise AssertionError(f"memo_stream: the off arm retired "
                                 f"{len(off_rows)} jobs, {len(errored)} "
                                 "with error bits")
        _check_launches("memo_stream (off)", om["launches"], MEMO_KERNELS)
        del off, ostream
        state, fl = memo_arm("memo_stream", full, pool, off_rows,
                             MEMO_KERNELS)
        sig_ms = time_ms(lambda: _lane_signature(state, full.delay), 10)
        del state, full
        admit, _ = stream_runner("cuda", memo="admit", memo_cache=cache)
        _, al = memo_arm("memo_stream (warm admit)", admit, pool, off_rows,
                         MEMO_KERNELS)
        cache_bytes = os.path.getsize(cache)
        del admit
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    off_line = {k: v for k, v in om.items() if k != "launches"}
    off_line["effective_jobs_per_s"] = pool.num_jobs / om["run_s"]
    emit({"phase": "memo_stream", "graph": f"er-{X_NODES}",
          "batch": X_BATCH, "jobs": pool.num_jobs, "dup_rate": MEMO_DUP,
          "megatick": MEGATICK, "stretch": ST_STRETCH,
          "drain_chunk": ST_CHUNK,
          "distinct_digests": len({bytes(d) for d in
                                   pool.digest.cpu().numpy()}),
          "off": off_line,
          "full": {k: v for k, v in fl.items() if k != "launches"},
          "warm_admit": {k: v for k, v in al.items() if k != "launches"},
          "full_over_off": fl["effective_jobs_per_s"]
          / off_line["effective_jobs_per_s"],
          "warm_admit_over_off": al["effective_jobs_per_s"]
          / off_line["effective_jobs_per_s"],
          "signature_ms_per_step": sig_ms,
          "signature_timing": "CUDA events, the full arm's final state",
          "cache_file_bytes": cache_bytes,
          "launches_full": fl["launches"],
          "launches_warm_admit": al["launches"]})
    if al["cache_hits"] <= 0 or fl["coalesced_jobs"] <= 0:
        raise AssertionError("memo_stream: nothing was coalesced or served "
                             "from the cache")
    return fl["launches"]


def phase_prefix_stream() -> dict:
    """The same cell at prefix overlap 0.75, J cut to 1,024
    (``PREFIX_JOBS``), packed by the "prefix" runner: memo "off" against
    "prefix" (in-memory prefix store) on that pool. Every row of the
    prefix arm equals the off arm's, and ``forked_jobs == prefix_hits >
    0``. Returns the prefix arm's launch counts."""
    from chandy_lamport_tpu_torch.bench import served_rows

    pre, spec = stream_runner("cuda", memo="prefix")
    pool = stream_queue(pre, spec, per_lane=PREFIX_JOBS / X_BATCH,
                        prefix_overlap=MEMO_OVERLAP)[1]
    off, _ = stream_runner("cuda")
    _, ostream, om = drive_stream(off, pool)
    off_rows = served_rows(off, ostream)
    if len(off_rows) != pool.num_jobs or any(r["error"] for r in off_rows):
        raise AssertionError("prefix_stream: the off arm did not retire "
                             "every job cleanly")
    _check_launches("prefix_stream (off)", om["launches"], MEMO_KERNELS)
    del off, ostream
    _, pl = memo_arm("prefix_stream", pre, pool, off_rows, MEMO_KERNELS)
    off_line = {k: v for k, v in om.items() if k != "launches"}
    off_line["effective_jobs_per_s"] = pool.num_jobs / om["run_s"]
    t = pl["memo_timing"]
    emit({"phase": "prefix_stream", "graph": f"er-{X_NODES}",
          "batch": X_BATCH, "jobs": pool.num_jobs,
          "prefix_overlap": MEMO_OVERLAP, "megatick": MEGATICK,
          "off": off_line,
          "prefix": {k: v for k, v in pl.items() if k != "launches"},
          "prefix_over_off": pl["effective_jobs_per_s"]
          / off_line["effective_jobs_per_s"],
          "fork_depth_mean": pl["fork_depth_mean"],
          "bank_rows": t.get("prefix_bank_rows"),
          "bank_bytes": t.get("prefix_bank_bytes"),
          "producer_s": t.get("prefix_produce_s"),
          "fork_audits": t.get("fork_audits"),
          "launches_prefix": pl["launches"]})
    if not pl["forked_jobs"] or pl["forked_jobs"] != pl["prefix_hits"]:
        raise AssertionError(f"prefix_stream: {pl['forked_jobs']} forks "
                             f"made, {pl['prefix_hits']} planned")
    return pl["launches"]


# ---- serving (serve_edf, serve_memo_quota) ------------------------------------

# the serve cells' traffic (the JAX serve CLI's defaults): 4 Zipf tenants,
# 2 priority classes, deadline slack 64-256 steps; serve_edf's J =
# SV_PER_LANE x B (the CLI's --requests 0 is 3 x B), 32 sampled rows held
# to their solo runs;
# serve_memo_quota on the sync scheduler with J cut to 4,096, at the
# memo cell's duplicate rate, over a summary cache warmed by its first
# SV_WARM_REQUESTS requests, with quotas that refuse part of tenants 0
# and 2
SV_TENANTS, SV_PRIORITIES, SV_SLACK = 4, 2, (64, 256)
# serve_edf's requests a lane: the CLI's 3, cut to 1.5 (J 12,288 -> 6,144)
# for the smoke's time (graph sharding's phases, slice 20)
SV_PER_LANE = 1.5
SV_SYNC_JOBS, SV_WARM_REQUESTS = 4096, 1024
SV_QUOTAS = (1500, 0, 300, 0)


def _serve_requests(spec, count, rate, dup_rate=0.0):
    from chandy_lamport_tpu_torch.models.workloads import serve_workload

    return serve_workload(spec, count, seed=DELAY_SEED, rate=rate,
                          tenants=SV_TENANTS, priorities=SV_PRIORITIES,
                          deadline_slack=SV_SLACK, dup_rate=dup_rate,
                          base_phases=4, tail_alpha=1.1,
                          max_phases=ST_PHASES)


def _serve_drive(runner, requests, spy=False, **kw) -> tuple:
    """One ``serve_run`` with the launch counts zeroed just before it and
    calls of row 8's plain form counted; with ``spy`` the jobs each step
    harvested, read from the ring after the step (the books' independent
    check). Returns (state, stream, report, measurements)."""
    import torch

    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from chandy_lamport_tpu_torch.kernels import megatick as km
    from chandy_lamport_tpu_torch.serving import serve_run

    plain, harvested = [0], []
    real_plain, real_step = km.fused_ticks_plain, runner._stream_step

    def count_plain(*a, **k):
        plain[0] += 1
        return real_plain(*a, **k)

    def spy_step(s, st, *a, **k):
        before = int(st.res_count)
        step = int(st.steps)
        s, st = real_step(s, st, *a, **k)
        after = int(st.res_count)
        ring = st.res_job.cpu().tolist()
        harvested.extend((step, ring[i % len(ring)])
                         for i in range(before, after))
        return s, st

    km.fused_ticks_plain = count_plain
    if spy:
        runner._stream_step = spy_step
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, stream, report = serve_run(runner, requests,
                                          stretch=ST_STRETCH,
                                          drain_chunk=ST_CHUNK, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        km.fused_ticks_plain = real_plain
        if spy:
            del runner._stream_step
    return state, stream, report, {
        "run_s": dt, "launches": launch_counts(), "plain_calls": plain[0],
        "harvested": harvested}


def _serve_report(report) -> dict:
    keys = ("policy", "requests", "steps", "exec_jobs", "served_total",
            "served_cache", "served_coalesced", "refused_total",
            "refused_by_tenant", "occupancy", "deadline_misses",
            "tenant_served", "admit_p50", "admit_p99", "admit_max",
            "wall_s", "warmup_s", "warmup_source", "fused_tick",
            "fused_tile")
    out = {k: report[k] for k in keys}
    out["served_jobs_per_s"] = (report["served_total"] / report["wall_s"]
                                if report["wall_s"] else None)
    return out


def phase_serve_edf(stream_jobs_per_step: float) -> dict:
    """Main path 29: the streaming cell (ER-256, B=4,096, the exact
    cascade at megatick 8) serving J = SV_PER_LANE x B requests of the JAX
    serve CLI's traffic at twice the jobs a step the off-arm streaming cell
    (stream_exact) retired, so a backlog stands for most of the run. The
    edf arm through a cold ``ExecutableCache`` over a temporary
    directory, its harvests read back after each step; then a fifo arm on
    a fresh runner through a restarted cache over that directory, armed
    (``RuntimeGuards()``: transfers "disallow", the card's sync debug
    mode "error"). Checks: 32 sampled rows equal their solo runs, the
    fifo rows the edf rows less ``admit_step``, the device's
    ``deadline_misses`` and ``tenant_served`` the harvests read back,
    fused_scan launched and its plain form never called, the restarted
    cache's source "disk" with no nvcc run, and the armed arm's books
    with no kernel build. Returns the edf arm's launch counts."""
    import shutil
    import tempfile

    from chandy_lamport_tpu_torch.kernels import _build
    from chandy_lamport_tpu_torch.serving import ExecutableCache
    from chandy_lamport_tpu_torch.utils.guards import RuntimeGuards

    rate = 2.0 * stream_jobs_per_step
    runner, spec = stream_runner("cuda")
    requests = _serve_requests(spec, int(SV_PER_LANE * runner.batch),
                               rate)
    # the pool serve_run packs (content keys), kept for the solo runs
    pools, pack = [], runner.pack_jobs
    runner.pack_jobs = lambda *a, **k: pools.append(pack(*a, **k)) or \
        pools[-1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        cold = ExecutableCache(tmp)
        _, stream, rep, m = _serve_drive(runner, requests, spy=True,
                                         policy="edf", exec_cache=cold)
        rows = runner.stream_results(stream)
        builds = _build.builds
        del stream, runner.pack_jobs
        warm = ExecutableCache(tmp)
        guards = RuntimeGuards()
        frunner, _ = stream_runner("cuda")
        _, fstream, frep, fm = _serve_drive(frunner, requests,
                                            policy="fifo", exec_cache=warm,
                                            guards=guards)
        frows = frunner.stream_results(fstream)
        warm_last = dict(warm.last)
        del fstream
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = []
    jcount = len(requests)
    if len(rows) != jcount or any(r["error"] for r in rows):
        bad.append(f"{jcount - len(rows)} requests unserved or errored")

    def no_admit(rs):
        return [{k: v for k, v in r.items() if k != "admit_step"}
                for r in rs]

    if no_admit(frows) != no_admit(rows):
        bad.append("the fifo rows differ from the edf rows")
    # the books against the harvests read back after each step
    misses = sum(1 for step, j in m["harvested"]
                 if step - requests[j].deadline_step > 0)
    served = [0] * SV_TENANTS
    for _, j in m["harvested"]:
        served[requests[j].tenant] += 1
    books = {"deadline_misses": misses, "tenant_served": served,
             "harvests": len(m["harvested"])}
    if (misses != rep["deadline_misses"] or served != rep["tenant_served"]
            or len(m["harvested"]) != rep["exec_jobs"]):
        bad.append(f"the device's books {rep['deadline_misses']}, "
                   f"{rep['tenant_served']} != the harvests' {books}")
    (pool,) = pools
    picks = _sample(jcount, ST_SAMPLED)
    t0 = time.perf_counter()
    oracle = static_oracle(lambda: stream_runner("cuda", 1)[0], pool,
                           [r.events for r in requests], rows, picks)
    oracle_s = time.perf_counter() - t0
    if oracle:
        bad.append(f"sampled rows differ from their solo runs: {oracle}")
    for arm, mm in (("edf", m), ("fifo", fm)):
        if mm["launches"]["fused_scan"] <= 0 or mm["plain_calls"]:
            bad.append(f"{arm}: fused_scan launched "
                       f"{mm['launches']['fused_scan']} times, its plain "
                       f"form called {mm['plain_calls']} times")
    if warm_last["source"] != "disk" or warm_last["builds"] \
            or _build.builds != builds:
        bad.append(f"the restarted cache: {warm_last}")
    gbooks = guards.books()
    if gbooks["compiles"] or gbooks["armed_regions"] != 1:
        bad.append(f"the armed fifo arm's books: {gbooks}")
    emit({"phase": "serve_edf", "graph": f"er-{X_NODES}",
          "batch": runner.batch, "requests": jcount,
          "scheduler": "exact/cascade", "megatick": MEGATICK,
          "stretch": ST_STRETCH, "drain_chunk": ST_CHUNK,
          "tenants": SV_TENANTS, "priorities": SV_PRIORITIES,
          "deadline_slack": list(SV_SLACK), "dup_rate": 0.0,
          "rate": rate,
          "rate_from": f"2 x {stream_jobs_per_step:.4f} jobs a step, "
                       f"stream_exact's off-arm drive (J / its steps)",
          "edf": {**_serve_report(rep), "run_s": m["run_s"],
                  "plain_calls": m["plain_calls"],
                  "warmup_builds": cold.last["builds"]},
          "fifo_armed": {**_serve_report(frep), "run_s": fm["run_s"],
                         "plain_calls": fm["plain_calls"],
                         "warmup": {k: warm_last[k] for k in (
                             "source", "warmup_s", "builds")},
                         "guards": gbooks},
          "warmup_cold_s": rep["warmup_s"],
          "warmup_warm_s": frep["warmup_s"],
          "books_from_harvests": books,
          "static_oracle": {"sampled": len(picks), "mismatched": oracle,
                            "run_s": oracle_s},
          "launches_fifo": fm["launches"]})
    if bad:
        raise AssertionError(f"serve_edf: {bad}")
    _check_launches("serve_edf", m["launches"], MEMO_KERNELS,
                    ("sum_segments", "select_pop"))
    return m["launches"]


def phase_serve_memo_quota(rate: float) -> dict:
    """Main path 30: the sync scheduler (the serve CLI's default) on the
    streaming cell's graph (ER-256, B=4,096, split markers), J cut to
    4,096 requests at duplicate rate 0.8 and serve_edf's rate, with
    quotas that refuse part of tenants 0 and 2, over a summary-cache
    file a first serve of the first 1,024 requests warmed. The main
    serve (launch counts zeroed just before it): its cache-served count
    and per-tenant refusals equal ``plan_ingest``'s plan over the warm
    file, every follower row equals its leader's row (less job, admit
    step and provenance), every cache-served row the file's entry, no
    errored job; the sync path's kernels launched, fused_scan never.
    Returns its launch counts."""
    import shutil
    import tempfile

    from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
    from chandy_lamport_tpu_torch.models.workloads import erdos_renyi
    from chandy_lamport_tpu_torch.ops.delay import HashDelay
    from chandy_lamport_tpu_torch.serving import plan_ingest
    from chandy_lamport_tpu_torch.utils.memocache import SummaryCache

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_memo_")
    try:
        cache = os.path.join(tmp, "summaries.jsonl")
        spec = erdos_renyi(X_NODES, 3.0, seed=3, tokens=ST_PHASES + 10)
        cfg = SimConfig.for_workload(snapshots=ST_SNAPSHOTS,
                                     split_markers=True,
                                     record_dtype="int16")

        def make():
            return BatchedRunner(spec, cfg, HashDelay(DELAY_SEED), X_BATCH,
                                 scheduler="sync", device="cuda",
                                 memo_cache=cache)

        requests = _serve_requests(spec, SV_SYNC_JOBS, rate, MEMO_DUP)
        t0 = time.perf_counter()
        _serve_drive(make(), requests[:SV_WARM_REQUESTS])
        warm_s = time.perf_counter() - t0
        runner = make()
        pool = runner.pack_jobs([r.events for r in requests],
                                content_keys=True)
        digests = [bytes(d).hex() for d in pool.digest.cpu().numpy()]
        plan = plan_ingest(requests, digests, SummaryCache(cache),
                           list(SV_QUOTAS))
        _, stream, rep, m = _serve_drive(runner, requests,
                                         quotas=list(SV_QUOTAS))
        rows = {r["job"]: r for r in runner.stream_results(stream)}
        warm_entries = SummaryCache(cache)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_cache = sum(1 for s in plan["status"] if s == "cache")
    want_refused = {str(t): c for t, c in sorted(plan["refused"].items())}
    summary = BatchedRunner._summary_of
    bad = []
    if rep["served_cache"] != want_cache:
        bad.append(f"{rep['served_cache']} served from the cache, the "
                   f"plan says {want_cache}")
    if rep["refused_by_tenant"] != want_refused:
        bad.append(f"refusals {rep['refused_by_tenant']} != the plan's "
                   f"{want_refused}")
    fan = 0
    for leader, fls in plan["followers"].items():
        want = {k: v for k, v in summary(rows[leader]).items()
                if k not in ("digest", "served_from")}
        for j in fls:
            got = {k: v for k, v in summary(rows[j]).items()
                   if k not in ("digest", "served_from")}
            fan += 1
            if got != want or rows[j]["served_from"] != "coalesce":
                bad.append(f"follower {j} != its leader {leader}")
                break
    cached = [j for j, s in enumerate(plan["status"]) if s == "cache"]
    for j in cached:
        if rows[j]["served_from"] != "cache" or rows[j]["time"] != \
                warm_entries.get(digests[j])["time"]:
            bad.append(f"cache-served row {j} != the file's entry")
            break
    if len(rows) != SV_SYNC_JOBS - rep["refused_total"] or any(
            r["error"] for r in rows.values()):
        bad.append("not every accepted request was served cleanly")
    if not (want_cache and fan and rep["refused_total"]):
        bad.append(f"the cell exercised too little: {want_cache} cache "
                   f"hits, {fan} followers, {rep['refused_total']} "
                   "refusals")
    emit({"phase": "serve_memo_quota", "graph": f"er-{X_NODES}",
          "batch": X_BATCH, "requests": SV_SYNC_JOBS, "scheduler": "sync",
          "dup_rate": MEMO_DUP, "rate": rate, "quotas": list(SV_QUOTAS),
          "warm_requests": SV_WARM_REQUESTS, "warm_s": warm_s,
          "plan": {"exec": len(plan["exec"]), "cache": want_cache,
                   "followers": fan, "refused": want_refused},
          "serve": {**_serve_report(rep), "run_s": m["run_s"]},
          "launches": m["launches"]})
    if bad:
        raise AssertionError(f"serve_memo_quota: {bad}")
    _check_launches("serve_memo_quota", m["launches"],
                    ("head_fields", "sum_by_perm", "spread"),
                    ("fused_scan", "queue_step"))
    return m["launches"]


# the fleet cell: the JAX bench's ``--fleet`` row (bench.py:1278-1378),
# ``bench --fleet 2 --graph ring --nodes 1024 --batch 2048 --scheduler
# sync``: ring-1024 with tokens phases + 10 = 42, 8 snapshots, the hash
# sampler, stretch 4, drain chunk 32, 2,048 lanes; the traffic of
# ``serve_workload(seed=17, rate=2.0, tenants=4, priorities=2,
# max_phases=32)`` over the bench's 3 x B requests at duplicate rate 0.5;
# 2 spawned workers on the card. One cold request is one singleton stream
# drive of ~3,080 sync ticks at the full 2,048 lanes (a snapshot's markers
# go round the ring), ~38 s on an NVIDIA H100 80GB HBM3 at 700 W, so the
# requests are cut in depth, never in width: every arm serves the first
# ``FL_REQUESTS`` requests of the trace's most requested content. The
# worker that leases first takes both, executes one and serves the other
# from the shared summary cache; from 3 requests on, the other worker
# executes an in-flight duplicate at the same time, and two executions
# take turns on the card (~40 s more: at 32 requests the phase took
# ~126 s, too close to the smoke's limit). Arms B and C run over a copy
# of arm A's summary cache (their checks are the spool's and the
# supervisor's; each cold execution would cost the card ~38 s). The lease is
# ``FL_LEASE_TTL``: the bench's 4 s would expire mid-request, and the JAX
# rule keeps the lease above a lease batch's execution
FL_NODES, FL_BATCH, FL_PHASES, FL_SNAPSHOTS = 1024, 2048, 32, 8
FL_REQUESTS = 2
FL_WORKERS, FL_LEASE_TTL, FL_DUP, FL_MAX_WALL = 2, 360.0, 0.5, 420.0
FL_DEVICE = "cuda"
# the sync oracle's graphs (tests/test_sync_differential.py's draw)
SO_CASES = (("ring", 8, 0), ("er", 16, 1))


def fleet_recipe(memo_cache) -> dict:
    """The bench's fleet recipe at ``FL_*`` (bench.py:1311-1316)."""
    from chandy_lamport_tpu_torch import SimConfig

    cfg = SimConfig.for_workload(snapshots=FL_SNAPSHOTS,
                                 record_dtype="int16", split_markers=True)
    return {"kind": "ring-stream", "n": FL_NODES,
            "tokens": FL_PHASES + 10, "snapshots": FL_SNAPSHOTS,
            "max_recorded": cfg.max_recorded, "batch": FL_BATCH,
            "scheduler": "sync", "delay": "hash",
            "memo_cache": memo_cache}


def fleet_requests() -> list:
    """The fleet cell's requests: the bench's trace of 3 x B requests,
    cut to the first ``FL_REQUESTS`` requests of its most requested
    content (the first such content on a tie)."""
    from collections import Counter

    from chandy_lamport_tpu_torch.models.workloads import (
        ring_topology,
        serve_workload,
    )

    trace = serve_workload(ring_topology(FL_NODES, tokens=FL_PHASES + 10),
                           3 * FL_BATCH, seed=DELAY_SEED, rate=2.0,
                           tenants=4, priorities=2, dup_rate=FL_DUP,
                           max_phases=FL_PHASES)
    counts = Counter(str(r.events) for r in trace)
    top = max(counts.values())
    hot = next(r.events for r in trace if counts[str(r.events)] == top)
    return [r for r in trace if r.events == hot][:FL_REQUESTS]


def _fleet_arm(requests, tmp, name, **kw) -> tuple:
    """One ``fleet_run`` of ``requests`` on a fresh spool under
    ``tmp/name``, over the summary-cache file there (empty, or a copy of
    another arm's), timed. Returns (report, seconds)."""
    from chandy_lamport_tpu_torch.serving import fleet_run

    os.makedirs(os.path.join(tmp, name), exist_ok=True)
    recipe = fleet_recipe(os.path.join(tmp, name, "memo.jsonl"))
    t0 = time.perf_counter()
    rep = fleet_run(requests,
                    spool_path=os.path.join(tmp, name, "wal.jsonl"),
                    workers=FL_WORKERS, recipe=recipe,
                    lease_ttl=FL_LEASE_TTL, restart_backoff=0.2,
                    stretch=ST_STRETCH, drain_chunk=ST_CHUNK,
                    max_wall_s=FL_MAX_WALL, device=FL_DEVICE, **kw)
    return rep, time.perf_counter() - t0


def _fleet_books(rep, seconds) -> dict:
    """What a fleet arm's line prints: the report's books and, for each
    worker incarnation that ran to its end, how many requests it leased,
    served, answered from the cache and executed."""
    return {"served": rep["served"], "requests": rep["requests"],
            "wall_s": rep["wall_s"], "run_s": seconds,
            "fleet_served_jobs_per_sec": (rep["served"] / rep["wall_s"]
                                          if rep["wall_s"] else None),
            "lat_p50_s": rep["lat_p50_s"], "lat_p99_s": rep["lat_p99_s"],
            "lat_max_s": rep["lat_max_s"], "timed_out": rep["timed_out"],
            "goodput": rep["goodput"],
            "executed": sum(1 for v in rep["results"].values()
                            if v.get("served_from") == "fleet-exec"),
            "cache_served": sum(1 for v in rep["results"].values()
                                if v.get("served_from") == "fleet-cache"),
            "books": rep["books"], "audit": rep["audit"],
            "worker_books": [{**{k: b[k] for k in (
                "worker", "device", "leased", "served", "cache_served",
                "late_rejected", "batches", "idle_polls",
                "cuda_peak_allocated_bytes") if k in b},
                "executed": b["served"] + b["late_rejected"]
                - b["cache_served"]}
                for b in rep["worker_books"]]}


def _summary_only(row) -> dict:
    """A fleet summary less its provenance (``served_from``) and its
    digest (a solo row has none)."""
    return {k: v for k, v in row.items()
            if k not in ("digest", "served_from")}


def phase_fleet() -> dict:
    """Main path 31: the serving fleet (``serving.fleet_run``) at the JAX
    bench's ``--fleet`` cell (``FL_*``: 2,048 lanes, the requests cut in
    depth to 2 of one content). Arm A, clean, alone on the card: 2 spawned
    workers, each cold request a singleton ``run_stream`` on a ring-1024
    sync runner (rows 1, 3 and 4); every request served once (audit: none
    lost or double-served, digests intact), no takeover, no death, no
    timeout, some served from the shared summary cache. Then, over a copy
    of arm A's summary cache and side by side in two threads, arm B, the
    bench's degraded arm (``crash_schedule(1, 2.0, start_s=4.0)``: a
    worker death and a restart, the audit balanced), and arm C, the
    in-flight takeover (the JAX chaos smoke's: ``kill_on_job`` = the first
    job leased, once; a takeover, none lost or double-served); beside them
    the content's solo ``run_stream`` through ``recipe_runner({**recipe,
    "memo_cache": None})`` here on the card. Every row of every arm,
    executed or from the cache, equals the solo run (less ``served_from``
    and the digest), and every row of B and C its arm-A row with the
    digest. The path's launches are arm A's workers' (their books: the
    counts start at 0 in each worker and are read at its end). Returns
    them."""
    import concurrent.futures
    import shutil
    import tempfile

    import torch

    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from chandy_lamport_tpu_torch.models.workloads import crash_schedule
    from chandy_lamport_tpu_torch.serving import recipe_runner

    requests = fleet_requests()
    first = min(requests, key=lambda r: (r.arrival_step, r.job)).job
    torch.cuda.empty_cache()   # this process's pool, for the workers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        rep_a, run_a = _fleet_arm(requests, tmp, "clean")
        for arm in ("degraded", "takeover"):
            os.makedirs(os.path.join(tmp, arm))
            shutil.copyfile(os.path.join(tmp, "clean", "memo.jsonl"),
                            os.path.join(tmp, arm, "memo.jsonl"))
        counter = os.path.join(tmp, "kills")
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            arm_b = pool.submit(
                _fleet_arm, requests, tmp, "degraded",
                crash_schedule=crash_schedule(1, 2.0, start_s=4.0))
            arm_c = pool.submit(
                _fleet_arm, requests, tmp, "takeover",
                chaos={"kill_on_job": first, "kill_limit": 1,
                       "counter_path": counter})
            solo = recipe_runner(fleet_recipe(None), device=FL_DEVICE)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            jobs = solo.pack_jobs([requests[0].events], content_keys=True)
            _, stream = solo.run_stream(jobs, stretch=ST_STRETCH,
                                        drain_chunk=ST_CHUNK)
            torch.cuda.synchronize()
            solo_s = time.perf_counter() - t0
            solo_launches = {k: n for k, n in launch_counts().items() if n}
            (row,) = solo.stream_results(stream)
            solo_steps = int(stream.steps)
            del solo, jobs, stream
            rep_b, run_b = arm_b.result()
            rep_c, run_c = arm_c.result()
        with open(counter, encoding="utf-8") as f:
            kills_c = int(f.read().strip() or 0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    solo_row = {k: v for k, v in row.items()
                if k not in ("job", "admit_step")}
    bad = []

    def audit_ok(arm, rep, want_served):
        a = rep["audit"]
        if a["lost"] or a["double_served"] or not a["digests_ok"] \
                or rep["served"] != want_served or rep["timed_out"]:
            bad.append(f"arm {arm}: audit {a}, served {rep['served']} of "
                       f"{want_served}, timed out {rep['timed_out']}")

    res_a = rep_a["results"]
    audit_ok("A", rep_a, len(requests))
    if rep_a["books"]["takeovers"] or rep_a["books"]["worker_deaths"]:
        bad.append(f"arm A (clean) books: {rep_a['books']}")
    if not any(v.get("served_from") == "fleet-cache"
               for v in res_a.values()):
        bad.append("arm A served nothing from the shared summary cache")
    audit_ok("B", rep_b, len(requests))
    if rep_b["books"]["worker_deaths"] < 1 or rep_b["books"]["restarts"] < 1:
        bad.append(f"arm B (degraded) killed or restarted nothing: "
                   f"{rep_b['books']}")
    audit_ok("C", rep_c, len(requests))
    if rep_c["books"]["takeovers"] < 1 or kills_c != 1:
        bad.append(f"arm C took nothing over: {rep_c['books']}, "
                   f"{kills_c} kills")
    vs_solo = {arm: [j for j, v in rep["results"].items()
                     if _summary_only(v) != solo_row]
               for arm, rep in (("A", rep_a), ("B", rep_b), ("C", rep_c))}
    if any(vs_solo.values()):
        bad.append(f"fleet rows differ from the solo run: {vs_solo}")
    vs_a = {arm: [j for j, v in rep["results"].items()
                  if {**v, "served_from": None}
                  != {**res_a.get(j, {}), "served_from": None}]
            for arm, rep in (("B", rep_b), ("C", rep_c))}
    if any(vs_a.values()):
        bad.append(f"arm B or C rows differ from arm A's: {vs_a}")
    launches = {k: 0 for k in launch_counts()}
    for b in rep_a["worker_books"]:
        for k, n in b["launches"].items():
            launches[k] += n
    if sorted(b["device"] for b in rep_a["worker_books"]) != \
            ["cuda"] * FL_WORKERS:
        bad.append(f"arm A's workers: {rep_a['worker_books']}")
    emit({"phase": "fleet", "main_path": True, "graph": f"ring-{FL_NODES}",
          "batch": FL_BATCH, "scheduler": "sync", "delay": "hash",
          "snapshots": FL_SNAPSHOTS, "stretch": ST_STRETCH,
          "drain_chunk": ST_CHUNK, "requests": [r.job for r in requests],
          "trace": f"the first {FL_REQUESTS} requests of the most "
          f"requested content of the bench's {3 * FL_BATCH}",
          "dup_rate": FL_DUP,
          "workers": FL_WORKERS, "lease_ttl_s": FL_LEASE_TTL,
          "clean": _fleet_books(rep_a, run_a),
          "degraded": _fleet_books(rep_b, run_b),
          "takeover": {**_fleet_books(rep_c, run_c), "kill_on_job": first,
                       "kills": kills_c},
          "solo": {"run_s": solo_s, "beside": ["degraded", "takeover"],
                   "steps": solo_steps, "ticks": solo_row["time"],
                   "ms_per_tick": solo_s / solo_row["time"] * 1e3,
                   "launches": solo_launches},
          "rows_vs_solo": vs_solo, "launches": launches})
    if bad:
        raise AssertionError(f"fleet: {bad}")
    _check_launches("fleet", launches,
                    ("head_fields", "sum_by_perm", "spread"),
                    ("fused_scan", "queue_step"))
    return launches


def _sync_program(rng, topo, phases, max_snapshots):
    """tests/test_sync_differential.py's random storm program (its
    ``_random_program``): sends within a balance floor and up to two
    initiations a phase. Returns (program, snapshots started)."""
    import numpy as np

    from chandy_lamport_tpu_torch.models.workloads import StormProgram

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
    per_phase, used = {}, 0
    for _ in range(n_snaps):
        ph, node = rng.randrange(phases), rng.randrange(topo.n)
        per_phase.setdefault(ph, []).append(node)
    for ph, nodes in per_phase.items():
        nodes = sorted(set(nodes))[:2]
        snap[ph, :len(nodes)] = nodes
        used += len(nodes)
    return StormProgram(amounts, snap), used


def sync_oracle_case(graph, nodes, case, device) -> dict:
    """One card sync storm (one lane, fixed delay) against ``SyncOracle``
    on the same program, as tests/test_sync_differential.py runs it.
    Returns the comparison's fields."""
    import random

    import numpy as np

    from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
    from chandy_lamport_tpu_torch.core.state import recorded_window
    from chandy_lamport_tpu_torch.core.syncsim import SyncOracle
    from chandy_lamport_tpu_torch.models import delay as host_delay
    from chandy_lamport_tpu_torch.models.workloads import (
        erdos_renyi,
        ring_topology,
    )
    from chandy_lamport_tpu_torch.ops.delay import FixedDelay
    from chandy_lamport_tpu_torch.utils.carry import state_to_numpy

    rng = random.Random(5000 + case)
    spec = (ring_topology(nodes, tokens=60) if graph == "ring"
            else erdos_renyi(nodes, 2.5, seed=case, tokens=60))
    fixed = rng.randrange(1, 5)
    runner = BatchedRunner(spec, SimConfig(queue_capacity=32,
                                           max_recorded=64),
                           FixedDelay(fixed), 1, scheduler="sync",
                           device=device)
    topo = runner.topo
    prog, n_snaps = _sync_program(rng, topo, rng.randrange(6, 16), 6)
    final = runner.run_storm(runner.init_batch_device(), prog)
    host = state_to_numpy(final, runner.delay)
    lane = type(host)(*(tuple(w[0] for w in leaf) if isinstance(leaf, tuple)
                        else leaf[0] for leaf in host))
    oracle = SyncOracle(topo, host_delay.FixedDelay(fixed))
    for ph in range(len(prog.amounts)):
        oracle.bulk_send([int(a) for a in np.asarray(prog.amounts[ph])])
        started = [int(x) for x in prog.snap[ph] if x >= 0]
        if started:
            oracle.start_snapshots(started)
        oracle.tick()
    oracle.drain_and_flush()
    windows = sum(
        oracle.recorded[sid].get(e, []) != recorded_window(lane, sid, e)
        for sid in range(n_snaps) for e in range(topo.e))
    frozen = sum(oracle.frozen[sid][v] != int(lane.frozen[sid, v])
                 for sid in range(n_snaps) for v in range(topo.n))
    ok = (int(lane.error) == 0 and oracle.time == int(lane.time)
          and oracle.tokens == [int(t) for t in lane.tokens]
          and oracle.next_sid == int(lane.next_sid) == n_snaps
          and all(oracle.completed[s] == int(lane.completed[s]) == topo.n
                  for s in range(n_snaps))
          and windows == 0 and frozen == 0)
    return {"graph": f"{graph}-{nodes}", "edges": topo.e, "delay": fixed,
            "snapshots": n_snaps, "ticks": int(lane.time),
            "windows_differing": windows, "frozen_differing": frozen,
            "equal": ok}


def phase_host_surface() -> dict:
    """Main path 32: the host surface on the card. The 7 goldens through
    the ``run`` command on ``--backend torch`` (the card: ``DenseSim`` at
    megatick 8, fused_scan; launch counts zeroed just before) and on
    ``--backend parity`` (the pure-Python oracle), ``--trace`` on: equal
    stdout and equal stderr, the device recorder's timeline being the
    parity oracle's ``EpochTrace.pretty()``; ``test --backend parity``
    passing 7 of 7; the card's sync storm on ring-8 and ER-16 against
    ``SyncOracle`` (``sync_oracle_case``); and ``dense_state_mismatches``
    of the exact cell's cascade and wave storms (ER-256 at B=512,
    megatick 8) empty. Returns the torch runs' launches."""
    import contextlib
    import io

    from chandy_lamport_tpu_torch.__main__ import golden_test, run_cmd
    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from chandy_lamport_tpu_torch.utils.compare import (
        dense_state_mismatches,
    )
    from chandy_lamport_tpu_torch.utils.goldens import (
        REFERENCE_TESTS,
        fixture_path,
    )

    def captured(fn, argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = fn(argv)
        return rc, out.getvalue(), err.getvalue()

    bad, cases, launches = [], {}, None
    t0 = time.perf_counter()
    for i, (top, events, _) in enumerate(REFERENCE_TESTS):
        paths = [fixture_path(top), fixture_path(events), "--trace"]
        parity = captured(run_cmd, paths + ["--backend", "parity"])
        if i == 0:
            reset_launch_counts()
        before = launch_counts()["fused_scan"]
        card = captured(run_cmd, paths + ["--backend", "torch"])
        name = events.removesuffix(".events")
        cases[name] = {"stdout_equal": card[1] == parity[1],
                       "trace_equal": card[2] == parity[2],
                       "stdout_lines": card[1].count("\n"),
                       "trace_lines": card[2].count("\n"),
                       "fused_scan": launch_counts()["fused_scan"] - before}
        if card[0] or parity[0] or card[1] != parity[1] \
                or card[2] != parity[2] or not card[2].strip():
            bad.append(f"run {name}: torch on the card != parity")
    launches = launch_counts()
    run_s = time.perf_counter() - t0
    rc, out, _ = captured(golden_test, ["--backend", "parity"])
    test_parity = out.strip().splitlines()[-1]
    if rc or test_parity != "7/7 passed":
        bad.append(f"test --backend parity: {test_parity}")
    oracle = [sync_oracle_case(g, n, c, "cuda") for g, n, c in SO_CASES]
    if not all(o["equal"] for o in oracle):
        bad.append(f"the card's sync storm != SyncOracle: {oracle}")
    finals = {}
    for impl in ("cascade", "wave"):
        runner, prog = exact_runner("cuda", batch=512, megatick=MEGATICK,
                                    exact_impl=impl)
        finals[impl] = runner.run_storm(runner.init_batch_device(), prog)
    mism = dense_state_mismatches(finals["cascade"], finals["wave"])
    if mism:
        bad.append(f"cascade and wave storms differ in {mism}")
    emit({"phase": "host_surface", "main_path": True, "run": cases,
          "run_s": run_s, "test_parity": test_parity,
          "sync_oracle": oracle,
          "cascade_vs_wave": {"graph": f"er-{X_NODES}", "batch": 512,
                              "megatick": MEGATICK, "mismatched": mism},
          "launches": launches})
    if bad:
        raise AssertionError(f"host_surface: {bad}")
    idle = [c for c, v in cases.items() if v["fused_scan"] <= 0]
    if idle:
        raise AssertionError(f"host_surface: goldens that never launched "
                             f"fused_scan: {idle}")
    _check_launches("host_surface", launches, ("fused_scan",))
    return launches


def serve_card_vs_cpu() -> dict:
    """A ring-8 exact serve at megatick 8 (B=4, 24 requests, 3 tenants,
    duplicate rate 0.4) under edf with quotas, over a summary-cache file a
    serve of its first 8 requests warmed: killed after its first save
    (checkpoint every 2 steps) on the card and on the CPU, each file
    resumed on both devices. Every resumed run and the uninterrupted CPU
    run end with every leaf of the state and the stream, and every row
    (digests included), equal. Returns the line's fields."""
    import shutil
    import tempfile

    import numpy as np

    from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
    from chandy_lamport_tpu_torch.models.workloads import (
        ring_topology,
        serve_workload,
    )
    from chandy_lamport_tpu_torch.ops.delay import HashDelay
    from chandy_lamport_tpu_torch.serving import serve_run
    from chandy_lamport_tpu_torch.utils.carry import (
        state_to_numpy,
        stream_to_numpy,
    )
    from chandy_lamport_tpu_torch.utils.checkpoint import load_state

    spec = ring_topology(8, tokens=16)
    requests = serve_workload(spec, 24, seed=DELAY_SEED, rate=1.0,
                              tenants=3, priorities=2, dup_rate=0.4,
                              base_phases=3, max_phases=10)
    quotas = [6, 0, 3]
    kw = dict(policy="edf", quotas=quotas, stretch=2, drain_chunk=8)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_card_vs_cpu_")

    def runner(device, name):
        # each run on its own copy of the warm file (a finished serve
        # flushes into its file)
        path = os.path.join(tmp, f"{name}.jsonl")
        shutil.copyfile(os.path.join(tmp, "warm.jsonl"), path)
        return BatchedRunner(spec, SimConfig.for_workload(snapshots=4),
                             HashDelay(DELAY_SEED), 4, scheduler="exact",
                             device=device, megatick=MEGATICK,
                             memo_cache=path)

    def host(r, out):
        state, stream = out[0], out[1]
        return ([x for leaf in state_to_numpy(state, r.delay)
                 for x in (leaf if isinstance(leaf, tuple) else (leaf,))]
                + list(stream_to_numpy(stream)), r.stream_results(stream))

    def equal(a, b):
        return len(a[0]) == len(b[0]) and all(
            x.dtype == y.dtype and np.array_equal(x, y)
            for x, y in zip(a[0], b[0])) and a[1] == b[1]

    try:
        open(os.path.join(tmp, "warm.jsonl"), "w").close()
        warm = runner("cpu", "warming")
        serve_run(warm, requests[:8], stretch=2, drain_chunk=8)
        shutil.copyfile(os.path.join(tmp, "warming.jsonl"),
                        os.path.join(tmp, "warm.jsonl"))
        r = runner("cpu", "whole")
        out = serve_run(r, requests, **kw)
        want, report = host(r, out), out[2]
        runs = {}
        for writer in ("cuda", "cpu"):
            path = os.path.join(tmp, f"{writer}.npz")
            r = runner(writer, f"{writer}-killed")
            killed = serve_run(r, requests, checkpoint=path,
                               checkpoint_every=2, kill_after_saves=1,
                               **kw)[2]
            for reader in ("cuda", "cpu"):
                r = runner(reader, f"{writer}-on-{reader}")
                pool = r.pack_jobs([q.events for q in requests],
                                   content_keys=True)
                (s, st), meta = load_state(
                    path, (r.init_batch_device(),
                           r.init_stream(pool, tenants=3,
                                         tenant_quota=quotas)),
                    delay=r.delay)
                got = host(r, serve_run(r, requests, state=s, stream=st,
                                        **kw))
                runs[f"{writer}_file_on_{reader}"] = {
                    "killed_at_step": killed["steps"],
                    "resumed_at_step": meta["stream_steps"],
                    "fused_tick": r.fused, "equal": equal(got, want)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [k for k, v in runs.items() if not v["equal"]]
    if bad:
        raise AssertionError(f"resumed serves differ from the "
                             f"uninterrupted run: {bad}")
    if not (report["served_cache"] and report["refused_total"]):
        raise AssertionError(f"the small serve took nothing from the warm "
                             f"cache or refused nothing: {report}")
    return {"graph": "ring-8", "batch": 4, "requests": 24,
            "quotas": quotas, "served_cache": report["served_cache"],
            "served_coalesced": report["served_coalesced"],
            "refused_total": report["refused_total"], "runs": runs}


# ---- the slice-17 phases: faults in DenseSim, the fold, the threefry
# ---- sampler, uint16 windows ------------------------------------------------

# the fold's ER-256 storm, cut in depth: the fold steps the N sources one
# by one each tick (one host step each), so 4 phases and 1 snapshot at the
# cell's width and batch
FOLD_PHASES, FOLD_SNAPSHOTS = 4, 1
# the threefry sampler's seed (UniformDelay) and the uint16 counter wrap's
# lanes and offset (every window counter starts this far below 2^16)
UNIFORM_SEED, WRAP_BATCH, WRAP_OFFSET = 17, 256, 2**16 - 3


def _golden_cases(kernel: str, **kw) -> dict:
    """The 7 reference goldens through ``check_reference_case`` on the
    card (``DenseSim`` at its default megatick 8) with ``kw`` passed to
    ``run_events_file``; launch counts are zeroed just before the first
    case. Returns the phase's fields: each case's launches of ``kernel``,
    the failures, the launches and the wall."""
    from chandy_lamport_tpu_torch.api import check_reference_case
    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from chandy_lamport_tpu_torch.utils.goldens import REFERENCE_TESTS

    failed, per_case, snapshots, megaticks = {}, {}, 0, set()
    reset_launch_counts()
    t0 = time.perf_counter()
    for top, events, snaps in REFERENCE_TESTS:
        name = events.removesuffix(".events")
        before = launch_counts()[kernel]
        try:
            sim = check_reference_case(top, events, snaps, device="cuda",
                                       **kw)
            megaticks.add((sim.kernel.megatick, sim.fused))
        except (AssertionError, ValueError, OSError, RuntimeError) as exc:
            failed[name] = str(exc)
        per_case[name] = launch_counts()[kernel] - before
        snapshots += len(snaps)
    return {"cases": len(per_case), "snapshots": snapshots,
            "passed": len(per_case) - len(failed), "failed": failed,
            "megatick_fused": sorted(megaticks),
            f"{kernel}_by_case": per_case, "launches": launch_counts(),
            "run_s": time.perf_counter() - t0}


def _golden_verdict(name: str, out: dict, kernel: str, fused: str) -> None:
    if out["failed"] or out["cases"] != 7 or out["snapshots"] != 21:
        raise AssertionError(f"{name}: goldens failed on the card: "
                             f"{out['failed']}")
    if out["megatick_fused"] != [(MEGATICK, fused)]:
        raise AssertionError(f"{name}: goldens not run at megatick 8 with "
                             f"the fused megatick {fused}: "
                             f"{out['megatick_fused']}")
    idle = [c for c, n in out[f"{kernel}_by_case"].items() if n <= 0]
    if idle:
        raise AssertionError(f"{name}: goldens that never launched "
                             f"{kernel}: {idle}")


def phase_golden() -> dict:
    """Main path 5: the 7 reference goldens on the card through
    ``check_reference_case`` (``run_events_file``, ``DenseSim`` at its
    default megatick 8); every snapshot must equal its .snap file and
    every case must launch fused_scan. Launch counts are zeroed just
    before the first case and read after each."""
    out = _golden_cases("fused_scan")
    emit({"phase": "golden", "main_path": True, **out})
    _golden_verdict("golden", out, "fused_scan", "on")
    return out["launches"]


def _dense_script(spec, seed: int):
    """One event script on ``spec``: a ``stream_jobs`` job of 32 phases
    (a send and a tick each, its snapshots among them)."""
    from chandy_lamport_tpu_torch.models.workloads import stream_jobs

    (job,) = stream_jobs(spec, 1, seed=seed, base_phases=32,
                         max_phases=32, snapshots_per_job=2)
    return job


def phase_dense_faults() -> dict:
    """Main paths 21-22, ``DenseSim(faults=)`` (A3c) on the card: the 7
    goldens through ``run_events_file(faults=Faults(7))``, the zero-rate
    adversary at megatick 8 (``fused_scan``'s fault arm in every case),
    each equal to its .snap; then one event script on ER-256 under the
    faulted exact cell's program (``F_PROGRAM``, timeout 64) run three
    ways, single-instance: at megatick 8 through the kernel, at megatick 8
    with ``fused_tick="off"`` (the plain form: its steps one tick at a
    time through the split kernels) and at megatick 1; every leaf equal,
    the faults firing. Returns the two paths' launch counts."""
    import torch

    from chandy_lamport_tpu_torch import SimConfig
    from chandy_lamport_tpu_torch.core.dense import DenseSim
    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from chandy_lamport_tpu_torch.models.faults import Faults
    from chandy_lamport_tpu_torch.models.workloads import erdos_renyi
    from chandy_lamport_tpu_torch.ops.delay import HashDelay

    out = _golden_cases("fused_scan", faults=Faults(7))
    emit({"phase": "dense_faults_golden", "main_path": True,
          "faults": "Faults(7), every rate 0", **out})
    _golden_verdict("dense_faults_golden", out, "fused_scan", "on")
    paths = {"dense_faults_golden": out["launches"]}
    spec = erdos_renyi(X_NODES, 3.0, seed=3, tokens=X_PHASES + 10)
    events = _dense_script(spec, 5)
    cfg = SimConfig.for_workload(snapshots=X_SNAPSHOTS,
                                 record_dtype="int16",
                                 snapshot_timeout=F_TIMEOUT)
    runs = {}
    for label, megatick, fused in (("kernel", MEGATICK, None),
                                   ("plain", MEGATICK, "off"),
                                   ("megatick 1", 1, None)):
        sim = DenseSim(spec, HashDelay(DELAY_SEED), cfg, "cascade",
                       megatick, faults=Faults(3, **F_PROGRAM),
                       fused_tick=fused, device="cuda")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        snaps = sim.run_events(events)
        torch.cuda.synchronize()
        runs[label] = (sim, snaps, time.perf_counter() - t0,
                       launch_counts())
    sim, snaps, dt, launches = runs["kernel"]
    bad = {label: _mismatched(sim.state, other.state)
           for label, (other, _, _, _) in runs.items() if label != "kernel"}
    same_snaps = all(o == snaps for _, o, _, _ in runs.values())
    fired = int(sim.state.fault_counts.sum())
    emit({"phase": "dense_faults_script", "main_path": True,
          "graph": f"er-{X_NODES}", "edges": sim.topo.e,
          "phases": sum(1 for ev in events if type(ev).__name__
                        == "TickEvent"), "snapshots": len(snaps),
          "program": F_PROGRAM, "snapshot_timeout": F_TIMEOUT,
          "fault_events": fired, "time": int(sim.state.time[0]),
          "error_bits": int(sim.state.error[0]),
          "total_tokens": sim.total_tokens(),
          "fused_tick": {k: v[0].fused for k, v in runs.items()},
          "run_s": {k: v[2] for k, v in runs.items()},
          "mismatched": bad, "snapshots_equal": same_snaps,
          "launches": launches,
          "plain_launches": runs["plain"][3]})
    if any(bad.values()) or not same_snaps:
        raise AssertionError(f"dense_faults_script: the kernel's run "
                             f"differs from {bad} (snapshots equal: "
                             f"{same_snaps})")
    if launches["fused_scan"] <= 0 or runs["plain"][3]["fused_scan"]:
        raise AssertionError("dense_faults_script: fused_scan launched "
                             f"{launches['fused_scan']} times in the kernel"
                             f" run, {runs['plain'][3]['fused_scan']} in "
                             "the plain one")
    if not fired:
        raise AssertionError("dense_faults_script: no fault fired")
    paths["dense_faults_script"] = launches
    return paths


def phase_fold() -> dict:
    """Main paths 23-24, the reference-literal fold (``exact_impl=
    "fold"``, A5b) on the card: the 7 goldens through ``DenseSim(
    exact_impl="fold")`` at megatick 8 (the fold has no fused form: K
    single fold ticks, no fused_scan), each equal to its .snap, every case
    launching append_marker_rows (row 5, its broadcasts); then the ER-256
    exact storm at the cell's width and batch, cut to ``FOLD_PHASES``
    phases and ``FOLD_SNAPSHOTS`` snapshot, through the fold and through
    the cascade at megatick 8: every leaf equal. Its ms per fold tick and
    row-5 launches per tick. Returns the paths' launch counts."""
    out = _golden_cases("append_marker_rows", exact_impl="fold")
    emit({"phase": "fold_golden", "main_path": True, **out})
    _golden_verdict("fold_golden", out, "append_marker_rows", "off")
    if out["launches"]["fused_scan"]:
        raise AssertionError("fold_golden launched fused_scan")
    paths = {"fold_golden": out["launches"]}
    frunner, prog = exact_runner("cuda", phases=FOLD_PHASES,
                                 snapshots=FOLD_SNAPSHOTS,
                                 megatick=MEGATICK, exact_impl="fold")
    final, m = phase_storm("fold_storm", frunner, prog, "er",
                           FOLD_SNAPSHOTS, ("append_marker_rows",
                                            "append_rows", "sum_segments"))
    paths["fold_storm"] = m["launches"]
    crunner, _ = exact_runner("cuda", phases=FOLD_PHASES,
                              snapshots=FOLD_SNAPSHOTS, megatick=MEGATICK)
    twin, tm = _timed_storm(crunner, prog, warm=False)
    bad = _mismatched(final, twin)
    ticks = m["batched_ticks"]
    emit({"phase": "fold_vs_cascade", "leaves": len(final._fields),
          "mismatched": bad, "fold_run_s": m["run_s"],
          "cascade_run_s": tm["run_s"], "batched_ticks": ticks,
          "ms_per_fold_tick": m["run_s"] / ticks * 1e3,
          "fold_source_steps": m["fold_steps"],
          "source_steps_per_tick": m["fold_steps"] / ticks,
          "append_marker_rows_per_tick":
              m["launches"]["append_marker_rows"] / ticks,
          "fused_scan_launches": m["launches"]["fused_scan"],
          "depth_cut": f"{FOLD_PHASES} phases, {FOLD_SNAPSHOTS} snapshot "
                       f"(the cell: {X_PHASES}, {X_SNAPSHOTS})"})
    if bad:
        raise AssertionError(f"the fold storm differs from the cascade's "
                             f"in {bad}")
    if m["launches"]["fused_scan"]:
        raise AssertionError("fold_storm launched fused_scan")
    return paths


def phase_uniform(hash_row: dict) -> tuple:
    """Main paths 25-26, the threefry sampler (``UniformDelay``, A7) on
    the card: config 4's sync storm under ``UniformDelay(UNIFORM_SEED)``
    (the sync tick's and the phases' draws are torch ops, as JAX draws
    them outside any Pallas kernel), error-free with every snapshot
    complete; then the ER-256 exact cascade at B=4096 and megatick 8
    under the same sampler, its drain megatick through row 8's threefry
    kind bit-equal to the plain form, timed beside the hash arm's
    (``hash_row``: fused_kernel's fault-free drain megatick of this run),
    and the storm itself. Returns (the paths' launch counts, the row 8
    row)."""
    from chandy_lamport_tpu_torch.ops.delay import UniformDelay

    runner, prog = config4_runner("cuda",
                                  delay=UniformDelay(UNIFORM_SEED))
    _, m = phase_storm("uniform_sync_storm", runner, prog, "sf", SNAPSHOTS,
                       ("sum_by_perm", "sum_segments", "spread",
                        "head_fields", "append_rows"))
    paths = {"uniform_sync_storm": m["launches"]}
    del runner
    urunner, uprog = exact_runner("cuda", U_BATCH, megatick=MEGATICK,
                                  delay=UniformDelay(UNIFORM_SEED))
    (row,) = drain_megatick_rows(urunner, uprog, "threefry")
    row = {**row, "arm": "threefry", "hash_ms": hash_row["ms"],
           "threefry_over_hash": row["ms"] / hash_row["ms"]}
    emit({"phase": "uniform_kernel", "tolerance": "bit-equal (integer "
          "work)", "delay": f"uniform({UNIFORM_SEED})", **row})
    _, m = phase_storm("uniform_fused_storm", urunner, uprog, "er",
                       X_SNAPSHOTS, ("fused_scan", "queue_step",
                                     "append_rows", "append_marker_rows"))
    paths["uniform_fused_storm"] = m["launches"]
    return paths, row


def _windows_agree(name: str, wide, narrow, sample_lanes=2) -> dict:
    """A uint16-window final against the int32 run of the same program:
    every leaf but the windows equal, each window's start and end equal
    modulo 2^16, and the windows of ``sample_lanes`` lanes decoded
    (``recorded_window``) equal; the decode reads nothing else."""
    import torch

    from chandy_lamport_tpu_torch.core.state import recorded_window
    from chandy_lamport_tpu_torch.utils.carry import state_to_numpy

    bad = [f for f in _mismatched(wide._replace(
        rec_start=narrow.rec_start, rec_end=narrow.rec_end), narrow)]
    mod = {w: bool(torch.equal(getattr(wide, w).to(torch.int32) & 0xFFFF,
                               getattr(narrow, w).to(torch.int32) & 0xFFFF))
           for w in ("rec_start", "rec_end")}
    decoded = wrapped = 0
    for lane in range(sample_lanes):
        hw, hn = (state_to_numpy(type(x)(*(
            tuple(w[lane:lane + 1] for w in leaf) if isinstance(leaf, tuple)
            else leaf[lane:lane + 1] for leaf in x))) for x in (wide, narrow))
        one = [type(h)(*(tuple(w[0] for w in leaf) if isinstance(leaf, tuple)
                         else leaf[0] for leaf in h)) for h in (hw, hn)]
        for sid in range(int(one[0].next_sid)):
            for e in range(one[0].rec_start.shape[-1]):
                a = recorded_window(one[0], sid, e)
                if a != recorded_window(one[1], sid, e):
                    bad.append(f"lane {lane} slot {sid} edge {e}")
                decoded += 1
                wrapped += int(one[1].rec_end[sid, e]
                               < one[1].rec_start[sid, e])
    out = {"phase": name, "mismatched": bad, "windows_equal_mod_2^16": mod,
           "windows_decoded": decoded, "wrapped_windows_decoded": wrapped,
           "window_dtype": str(narrow.rec_start.dtype)}
    if bad or not all(mod.values()) or narrow.rec_start.dtype \
            != torch.int16:
        raise AssertionError(f"{name}: the uint16 run disagrees with the "
                             f"int32 one: {out}")
    return out


def phase_window16(sync_final, int32_rows: dict) -> tuple:
    """Main paths 27-28, ``window_dtype="uint16"`` (A7) on the card: config
    4's sync storm and the ER-256 exact cascade at megatick 8 with uint16
    window planes, each against the int32 run of the same program
    (``sync_final``: main path 1's; the exact one run here): every other
    leaf equal and every window equal modulo 2^16, sampled lanes decoded
    equal (``_windows_agree``); row 8's uint16 arm at the drain megatick,
    resident and forced tiled, bit-equal to the plain form, timed beside
    the int32 arm in the same layout (``int32_rows``: fused_kernel's
    fault-free drain megaticks by layout); a synthetic counter wrap: the exact cell at ``WRAP_BATCH``
    lanes from a state whose window counters start at ``WRAP_OFFSET``, 3
    below 2^16, in both dtypes (the uint16 windows wrap past 2^16 on the
    card); and that state's uint16 checkpoint saved and loaded
    bit-equal, its planes uint16 in the file. Returns (the paths'
    launch counts, the row 8 rows)."""
    import tempfile

    import numpy as np
    import torch

    from chandy_lamport_tpu_torch.utils.checkpoint import (
        load_state,
        save_state,
    )

    narrow_runner, prog = config4_runner("cuda", window_dtype="uint16")
    final, m = phase_storm("window16_sync_storm", narrow_runner, prog, "sf",
                           SNAPSHOTS, ("sum_by_perm", "sum_segments",
                                       "spread", "head_fields",
                                       "append_rows"))
    paths = {"window16_sync_storm": m["launches"]}
    emit(_windows_agree("window16_sync_vs_int32", sync_final, final))
    del final, narrow_runner
    wrunner, wprog = exact_runner("cuda", megatick=MEGATICK,
                                  window_dtype="uint16")
    trunner, _ = exact_runner("cuda", megatick=MEGATICK,
                              window_dtype="uint16", tiled=True)
    rows = [{**r, "arm": "uint16",
             "int32_ms": int32_rows[r["layout"]]["ms"],
             "uint16_over_int32": r["ms"] / int32_rows[r["layout"]]["ms"]}
            for r in drain_megatick_rows(wrunner, wprog, "uint16 windows",
                                         tiled=trunner)]
    emit({"phase": "window16_kernel", "tolerance": "bit-equal (integer "
          "work)", "resident": rows[0], "tiled": rows[1]})
    del trunner
    narrow, m = phase_storm("window16_fused_storm", wrunner, wprog, "er",
                            X_SNAPSHOTS, ("fused_scan", "queue_step",
                                          "append_rows",
                                          "append_marker_rows"))
    paths["window16_fused_storm"] = m["launches"]
    irunner, _ = exact_runner("cuda", megatick=MEGATICK)
    wide, _ = _timed_storm(irunner, wprog, warm=False)
    emit(_windows_agree("window16_fused_vs_int32", wide, narrow))
    del wide, narrow, irunner, wrunner
    # the synthetic wrap
    ends = {}
    for wd in ("int32", "uint16"):
        r, p = exact_runner("cuda", batch=WRAP_BATCH, megatick=MEGATICK,
                            window_dtype=wd)
        s = r.init_batch_device()
        s = s._replace(rec_cnt=s.rec_cnt + WRAP_OFFSET)
        ends[wd] = (r, r.run_storm(s, p))
    out = _windows_agree("window16_counter_wrap", ends["int32"][1],
                         ends["uint16"][1])
    r16, f16 = ends["uint16"]
    out["max_rec_cnt"] = int(f16.rec_cnt.max())
    if out["max_rec_cnt"] <= 2**16:
        raise AssertionError("window16_counter_wrap: no counter passed "
                             "2^16")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "w16.npz")
        t0 = time.perf_counter()
        save_state(path, f16, {"note": "uint16 windows"}, delay=r16.delay)
        save_s = time.perf_counter() - t0
        with np.load(path) as z:
            dtypes = {str(z[k].dtype) for k in z.files if k != "__header__"}
        loaded, meta = load_state(path, r16.init_batch_device(),
                                  delay=r16.delay)
        out.update(checkpoint_bytes=os.path.getsize(path), save_s=save_s,
                   checkpoint_leaf_dtypes=sorted(dtypes),
                   checkpoint_mismatched=_mismatched(loaded, f16))
    emit(out)
    if out["checkpoint_mismatched"] or "uint16" not in dtypes \
            or meta["note"] != "uint16 windows":
        raise AssertionError(f"the uint16 checkpoint did not round-trip: "
                             f"{out['checkpoint_mismatched']}, {dtypes}")
    del ends, loaded, f16
    return paths, rows



CV_KINDS = ("sync", "faulted_sync", "exact", "faulted_exact",
            "faulted_exact_megatick8", "exact_megatick8",
            "exact_wave_megatick8", "faulted_exact_wave_megatick8")


def _cv_storm(kind, device) -> tuple:
    """cpu_vs_cuda's small storm ``kind`` (``CV_KINDS``) on ``device``:
    (runner, program). sf-64, ``CV_BATCH`` lanes, 6 phases, 4 snapshots;
    the faulted sync storm with every message and marker class and lossy
    crashes at tick 70 after the first snapshots completed, the
    supervisor with its daemon; the faulted exact ones with lossy crashes
    of half the nodes at tick 70 (restored from the first snapshots),
    rare marker drops and the supervisor's daemon every 12 ticks."""
    from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
    from chandy_lamport_tpu_torch.models.faults import Faults
    from chandy_lamport_tpu_torch.models.workloads import (
        scale_free,
        staggered_snapshots,
        storm_program,
    )
    from chandy_lamport_tpu_torch.ops.delay import HashDelay

    if kind in ("sync", "faulted_sync"):
        faulted = kind == "faulted_sync"
        runner = BatchedRunner(
            scale_free(64, 2, seed=3, tokens=16),
            SimConfig.for_workload(
                snapshots=4, split_markers=True, record_dtype="int16",
                **(dict(snapshot_timeout=F_TIMEOUT, snapshot_every=12)
                   if faulted else {})),
            HashDelay(DELAY_SEED), CV_BATCH, scheduler="sync", device=device,
            **(dict(faults=Faults(3, **SMALL_SYNC_FAULTS), quarantine=True)
               if faulted else {}))
        prog = storm_program(runner.topo, 6, 1, staggered_snapshots(
            runner.topo, 4, 1, 1, max_phases=6))
        return runner, prog
    kw = dict(megatick=MEGATICK if "megatick8" in kind else 1,
              exact_impl="wave" if "wave" in kind else "cascade")
    if kind.startswith("faulted"):
        kw.update(faults=Faults(3, crash_rate=0.5, crash_mode="lossy",
                                crash_start=70, marker_drop_rate=0.002),
                  snapshot_timeout=F_TIMEOUT, snapshot_every=12)
    return exact_runner(device, batch=CV_BATCH, nodes=64, phases=6,
                        snapshots=4, graph="sf", **kw)


def _cv_finals(device) -> list:
    """The final states (numpy) of every ``CV_KINDS`` storm on
    ``device``."""
    from chandy_lamport_tpu_torch.utils.carry import state_to_numpy

    out = []
    for kind in CV_KINDS:
        runner, prog = _cv_storm(kind, device)
        out.append(state_to_numpy(
            runner.run_storm(runner.init_batch_device(), prog)))
    return out


def phase_cpu_vs_cuda() -> None:
    """Small sync, faulted sync, exact, faulted exact (megatick 1 and 8),
    megatick-8 exact storms and the wave's at megatick 8 (faulted and
    not) on the card and on the CPU (the CPU's in a spawned process at the
    same time): identical leaves; then a small faulted sync stream
    checkpointed, killed and resumed (``stream_checkpoint_card_vs_cpu``),
    small streams under each memo mode (``memo_streams_card_vs_cpu``) and
    a small serve killed and resumed across the devices
    (``serve_card_vs_cpu``)."""
    import concurrent.futures
    import multiprocessing

    import numpy as np

    from chandy_lamport_tpu_torch.core.state import ERR_SNAPSHOT_TIMEOUT

    result = {"phase": "cpu_vs_cuda", "graph": "sf-64", "batch": CV_BATCH,
              "phases": 6, "snapshots": 4}
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = pool.submit(_cv_finals, "cpu")
        cuda = _cv_finals("cuda")
        cpu = cpu.result()
    for scheduler, *finals in zip(CV_KINDS, cuda, cpu):
        mismatched = []
        for name, a, b in zip(finals[0]._fields, *finals):
            pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
            if any(x.dtype != y.dtype or not np.array_equal(x, y)
                   for x, y in pairs):
                mismatched.append(name)
        bits = int(np.bitwise_or.reduce(finals[0].error))
        result[scheduler] = {"leaves": len(finals[0]._fields),
                             "mismatched": mismatched, "error_bits": bits,
                             "fault_counts": finals[0].fault_counts.sum(
                                 0).tolist(),
                             "stale_markers": int(
                                 finals[0].stale_markers.sum()),
                             "retried": int(finals[0].snap_retries.sum())}
        if mismatched:
            raise AssertionError(f"CUDA and CPU {scheduler} storms differ "
                                 f"in {mismatched}")
        allowed = ERR_SNAPSHOT_TIMEOUT if scheduler == "faulted_sync" else 0
        if bits & ~allowed:
            raise AssertionError(f"small {scheduler} storm raised error "
                                 "bits")
    result["stream_checkpoint"] = stream_checkpoint_card_vs_cpu()
    result["memo_streams"] = memo_streams_card_vs_cpu()
    result["serve"] = serve_card_vs_cpu()
    emit(result)


def memo_streams_card_vs_cpu() -> dict:
    """A ring-8 exact stream at megatick 8 (B=4, 24 jobs) under memo
    "admit" and "full" (duplicate rate 0.5) and "prefix" (prefix overlap
    0.75, two drives on one in-memory store), every served job shadowed,
    on the card and on the CPU: every leaf of the final state and the
    stream equal, and every row (digest and provenance included) equal.
    Returns the line's fields."""
    import numpy as np

    from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
    from chandy_lamport_tpu_torch.models.workloads import (
        ring_topology,
        stream_jobs,
    )
    from chandy_lamport_tpu_torch.ops.delay import HashDelay
    from chandy_lamport_tpu_torch.utils.carry import (
        state_to_numpy,
        stream_to_numpy,
    )

    spec = ring_topology(8, tokens=16)
    out = {}
    for memo in ("admit", "full", "prefix"):
        traffic = (dict(prefix_overlap=0.75) if memo == "prefix"
                   else dict(dup_rate=0.5))
        jobs = stream_jobs(spec, 24, seed=DELAY_SEED, base_phases=3,
                           max_phases=10, **traffic)
        got = []
        for device in ("cuda", "cpu"):
            r = BatchedRunner(spec, SimConfig.for_workload(snapshots=4),
                              HashDelay(DELAY_SEED), 4, scheduler="exact",
                              device=device, megatick=MEGATICK, memo=memo)
            pool = r.pack_jobs(jobs)
            for _ in range(2 if memo == "prefix" else 1):
                state, stream = r.run_stream(pool, stretch=2, drain_chunk=8,
                                             shadow_every=1)
            host = state_to_numpy(state, r.delay)
            got.append(([x for leaf in host for x in (
                leaf if isinstance(leaf, tuple) else (leaf,))]
                + list(stream_to_numpy(stream)), r.stream_results(stream),
                r.summarize_stream(stream), r.fused))
        (a, rows_a, sm, fused), (b, rows_b, _, _) = got
        equal = len(a) == len(b) and all(
            x.dtype == y.dtype and np.array_equal(x, y)
            for x, y in zip(a, b))
        out[memo] = {"leaves_equal": equal, "rows_equal": rows_a == rows_b,
                     "fused_tick": fused, **{k: sm[k] for k in (
                         "jobs_done", "coalesced_jobs", "shadow_checks",
                         "ff_skipped_ticks", "forked_jobs")}}
        if not (equal and rows_a == rows_b):
            raise AssertionError(f"the card's memo {memo!r} stream differs "
                                 f"from the CPU's: {out[memo]}")
        if fused != "on":
            raise AssertionError(f"memo {memo!r}: no fused megatick on the "
                                 "card")
    if not out["prefix"]["forked_jobs"] or not out["admit"][
            "coalesced_jobs"]:
        raise AssertionError(f"the memo streams forked or coalesced "
                             f"nothing: {out}")
    return {"graph": "ring-8", "batch": 4, "jobs": 24, "arms": out}


def stream_checkpoint_card_vs_cpu() -> dict:
    """A small faulted sync stream (SF-64, B=4, 12 jobs, every job armed,
    quarantined) checkpointed every 2 steps and killed after its first
    save, on the card and on the CPU; each file resumed on both devices.
    All four resumed runs and the uninterrupted CPU run end with every
    leaf of the state and the stream equal. Returns the line's fields."""
    import shutil
    import tempfile

    import numpy as np

    from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
    from chandy_lamport_tpu_torch.models.faults import Faults
    from chandy_lamport_tpu_torch.models.workloads import (
        scale_free,
        stream_jobs,
    )
    from chandy_lamport_tpu_torch.ops.delay import HashDelay
    from chandy_lamport_tpu_torch.utils.carry import (
        state_to_numpy,
        stream_to_numpy,
    )
    from chandy_lamport_tpu_torch.utils.checkpoint import load_state

    spec = scale_free(64, 2, seed=3, tokens=16)
    jobs = stream_jobs(spec, 12, seed=DELAY_SEED, base_phases=2,
                       max_phases=6)

    def runner(device):
        r = BatchedRunner(
            spec, SimConfig.for_workload(snapshots=4, split_markers=True,
                                         record_dtype="int16"),
            HashDelay(DELAY_SEED), 4, scheduler="sync", device=device,
            faults=Faults(3, drop_rate=0.05, dup_rate=0.05,
                          jitter_rate=0.05), quarantine=True)
        return r, r.pack_jobs(jobs)

    def host(pair):
        state, stream = pair
        return [x for leaf in state_to_numpy(state)
                for x in (leaf if isinstance(leaf, tuple) else (leaf,))] \
            + list(stream_to_numpy(stream))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_checkpoint_")
    try:
        r, pool = runner("cpu")
        want = host(r.run_stream(pool, stretch=2, drain_chunk=8))
        runs = {}
        for writer in ("cuda", "cpu"):
            path = os.path.join(tmp, f"{writer}.npz")
            r, pool = runner(writer)
            r.run_stream(pool, stretch=2, drain_chunk=8, checkpoint=path,
                         checkpoint_every=2, kill_after_saves=1)
            for reader in ("cuda", "cpu"):
                r, pool = runner(reader)
                pair, meta = load_state(
                    path, (r.init_batch_device(), r.init_stream(pool)),
                    delay=r.delay)
                got = host(r.run_stream(pool, stretch=2, drain_chunk=8,
                                        state=pair[0], stream=pair[1]))
                runs[f"{writer}_file_on_{reader}"] = {
                    "resumed_at_step": meta["stream_steps"],
                    "equal": len(got) == len(want) and all(
                        a.dtype == b.dtype and np.array_equal(a, b)
                        for a, b in zip(got, want))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [k for k, v in runs.items() if not v["equal"]]
    if bad:
        raise AssertionError(f"resumed streams differ from the "
                             f"uninterrupted run: {bad}")
    return {"graph": "sf-64", "batch": 4, "jobs": 12, "runs": runs}


# ---- the flight recorder (the recorder arm of fused_scan) --------------------

# the tiny ring of the traced edge cases: a step's events pass it, so the
# ring wraps inside one append
TRACE_SMALL = 8
# the ring leaves, which an untraced run keeps at zero slots
RING = ("tr_meta", "tr_data", "tr_tick", "tr_count", "tr_on")


def phase_trace_edge_cases() -> None:
    """``fused_edge_cases`` with the recorder armed, at the default
    capacity (4,096 slots) and at ``TRACE_SMALL``, each case launched
    resident and tiled (forced) against one plain run: every leaf equal,
    the ring included; all eight traced instantiations among them, and
    at the small capacity lanes that record more than it in a launch."""
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    t0 = time.perf_counter()
    rows = []
    for capacity in (Trace.DEFAULT_CAPACITY, TRACE_SMALL):
        for r in fused_edge_cases(("resident", "tiled"), capacity):
            rows.append({**r, "capacity": capacity})
    arms = {(r["impl"], r["fault_arm"], r["layout"]) for r in rows}
    wrapped = sum(r["max_lane_events"] > TRACE_SMALL for r in rows
                  if r["capacity"] == TRACE_SMALL)
    emit({"phase": "trace_edge_cases", "tolerance": "bit-equal (integer "
          "work)", "cases": len(rows), "instantiations": sorted(arms),
          "small_capacity_rows_past_the_ring": wrapped,
          "trace_events": sum(r["trace_events"] for r in rows),
          "run_s": time.perf_counter() - t0, "edge_cases": rows})
    if len(arms) != 8 or not all(r["traced"] for r in rows) or not wrapped:
        raise AssertionError(f"traced edge cases ran {sorted(arms)}, "
                             f"{wrapped} rows past the small ring")


def phase_trace_kernel(untraced_rows) -> list:
    """The recorder arm at the exact cell's shape: the four drain
    megaticks of ``phase_fused_kernel`` (cascade and wave, fault-free and
    faulted, from the state after the 32 storm phases) traced at the
    default capacity, resident and tiled (forced), each bit-equal to the
    traced plain version, timed per launch beside its bound (the untraced
    bound plus the ring's bytes) and beside the untraced arm's time on
    the same cell in this run (``untraced_rows``, in the same order).
    Returns the eight rows for the summary line."""
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    rows = []
    for label, make, impl in (("fault-free", exact_runner, "cascade"),
                              ("faulted", fault_runner, "cascade"),
                              ("wave fault-free", exact_runner, "wave"),
                              ("wave faulted", fault_runner, "wave")):
        resident, prog = make("cuda", megatick=MEGATICK, exact_impl=impl,
                              trace=Trace())
        tiled, _ = make("cuda", megatick=MEGATICK, exact_impl=impl,
                        tiled=True, trace=Trace())
        rows += drain_megatick_rows(resident, prog, label + " traced",
                                    tiled=tiled)
        del resident, tiled
    for row, base in zip(rows, untraced_rows):
        row["untraced_ms"] = base["ms"]
        row["traced_over_untraced"] = row["ms"] / base["ms"]
    emit({"phase": "trace_kernel", "tolerance": "bit-equal (integer work)",
          "capacity": Trace.DEFAULT_CAPACITY, "drain_megaticks": rows})
    return rows


def phase_trace_golden() -> dict:
    """The 7 goldens traced at megatick 8 on the card (``run_events_file(
    ..., trace=True)`` through ``check_reference_case``: every snapshot
    equal to its .snap file), each launching the recorder arm, their
    timelines (``sim.trace.pretty()``) and rings equal to the card's
    megatick-1 traced plain path. Returns the launch counts."""
    from chandy_lamport_tpu_torch.api import check_reference_case
    from chandy_lamport_tpu_torch.core.dense import DenseSim
    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from chandy_lamport_tpu_torch.ops.delay import GoExactDelay
    from chandy_lamport_tpu_torch.utils.fixtures import (
        read_events_file,
        read_topology_file,
    )
    from chandy_lamport_tpu_torch.utils.goldens import (
        REFERENCE_TESTS,
        fixture_path,
    )
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    # The counts are read after the 7 megatick-8 runs and before any
    # megatick-1 twin runs: the twins launch the per-tick kernels.
    sims, failed = {}, {}
    reset_launch_counts()
    t0 = time.perf_counter()
    for top, events, snaps in REFERENCE_TESTS:
        name = events.removesuffix(".events")
        before = launch_counts()["fused_scan_traced"]
        try:
            sim = check_reference_case(top, events, snaps, device="cuda",
                                       trace=True)
        except (AssertionError, ValueError, OSError, RuntimeError) as exc:
            failed[name] = str(exc)
            continue
        sims[name] = (top, events, sim,
                      launch_counts()["fused_scan_traced"] - before)
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    cases = {}
    for name, (top, events, sim, launched) in sims.items():
        twin = DenseSim(read_topology_file(fixture_path(top)),
                        GoExactDelay(sim.delay.seed), device="cuda",
                        megatick=1, trace=Trace())
        twin.run_events(read_events_file(fixture_path(events)))
        ring_bad = [n for n in RING if not bool(
            (getattr(sim.state, n) == getattr(twin.state, n)).all())]
        recorded, dropped = sim.trace.counts()
        cases[name] = {"fused_scan_traced": launched,
                       "events": recorded, "dropped": dropped,
                       "pretty_equal": sim.trace.pretty()
                       == twin.trace.pretty(),
                       "ring_mismatched": ring_bad}
        if launched <= 0 or ring_bad or not cases[name]["pretty_equal"]:
            failed[name] = str(cases[name])
    emit({"phase": "trace_golden", "main_path": True,
          "cases": cases, "failed": failed, "launches": launches,
          "run_s": run_s})
    if failed or len(cases) != 7:
        raise AssertionError(f"traced goldens failed on the card: {failed}")
    return launches


def _held_kinds(state):
    """The kind of every event each lane's ring holds, [B, K], -1 in the
    slots not yet written (a wrapped ring holds its newest K)."""
    import torch

    k = state.tr_meta.shape[-1]
    held = torch.arange(k, device=state.tr_meta.device) < \
        state.tr_count.unsqueeze(-1)
    return torch.where(held, state.tr_meta & 31, -1)


def _ring_counts(state) -> dict:
    """The recorded events of every lane's ring by kind, and the lanes
    whose ring wrapped."""
    from chandy_lamport_tpu_torch.utils.tracing import EVENT_KIND_NAMES

    k = state.tr_meta.shape[-1]
    kinds = _held_kinds(state)
    return {"by_kind": {name: int((kinds == i).sum())
                        for i, name in enumerate(EVENT_KIND_NAMES)
                        if bool((kinds == i).any())},
            "wrapped_lanes": int((state.tr_count > k).sum())}


def _trace_storm_line(name, runner, prog, graph, snapshots, final, m,
                      untraced, untraced_m, twin=None, twin_m=None) -> dict:
    """A traced storm against its twins: every leaf of its traced
    megatick-1 twin (when given), every leaf but the ring of the untraced
    run; its books, rings and its overhead against the untraced run."""
    from chandy_lamport_tpu_torch import BatchedRunner

    summary = BatchedRunner.summarize(final)
    line = {**_storm_meta(name, runner, prog, graph, snapshots), **m,
            "trace_capacity": runner.config.trace_capacity,
            "trace_events": summary["trace_events"],
            "trace_dropped": summary["trace_dropped"],
            "trace_overhead_pct": (m["run_s"] / untraced_m["run_s"] - 1)
            * 100, "untraced_run_s": untraced_m["run_s"],
            "ring": _ring_counts(final),
            "untraced_mismatched": [n for n in _mismatched(final, untraced)
                                    if n not in RING]}
    if twin is not None:
        line["megatick1_twin"] = {
            "mismatched": _mismatched(
                _first_lanes(final, int(twin.time.shape[0])), twin),
            "lanes": int(twin.time.shape[0]),
            **{key: twin_m[key] for key in ("run_s", "fold_steps",
                                            "drain_fold_steps")}}
    return line


def phase_trace_storms(resident) -> dict:
    """The traced storms of the exact cell (ER-256, B=4096) at megatick 8,
    the flight recorder at its default capacity: the cascade, the wave
    and the faulted wave (``resident``: the untraced megatick-8 runs of
    this call, name -> (program, final, measurements)). Each, with the
    launch counts zeroed just before it, launches the recorder arm, is
    clean, equals its traced megatick-1 twin (run on the first
    ``M1_BATCH`` lanes) on those lanes on every leaf and the untraced run
    on every leaf but the ring. Returns the launch counts by path."""
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    paths = {}
    for name, base, make, impl, faulted in (
            ("trace_fused_storm", "fused_storm", exact_runner, "cascade",
             False),
            ("trace_wave_fused_storm", "wave_fused_storm", exact_runner,
             "wave", False),
            ("trace_fault_wave_fused_storm", "fault_wave_fused_storm",
             fault_runner, "wave", True)):
        prog, untraced, untraced_m = resident[base]
        runner, _ = make("cuda", megatick=MEGATICK, exact_impl=impl,
                         trace=Trace())
        final, m = _timed_storm(runner, prog, warm=False)
        twin_runner, _ = make("cuda", M1_BATCH, megatick=1,
                              exact_impl=impl, trace=Trace())
        twin, twin_m = _timed_storm(twin_runner, prog, warm=False)
        line = _trace_storm_line(name, runner, prog, "er", X_SNAPSHOTS,
                                 final, m, untraced, untraced_m, twin,
                                 twin_m)
        _, bad = _storm_verdict(runner, final, X_SNAPSHOTS, faulted)
        emit({**line, "main_path": True, "checks_failed": bad})
        del final, twin, twin_runner
        if bad or line["untraced_mismatched"] or \
                line["megatick1_twin"]["mismatched"]:
            raise AssertionError(f"{name}: {bad}, {line}")
        _check_launches(name, m["launches"], (
            "fused_scan", "fused_scan_traced", "append_rows",
            "append_marker_rows", "sum_by_perm"))
        paths[name] = m["launches"]
    return paths


def phase_trace_config5(untraced, untraced_m, untraced_row) -> tuple:
    """Config 5 (``C5_*``, tiled by "auto") traced at megatick 8: clean,
    the tiled recorder arm launched, equal to the untraced run of this
    call (``untraced``) on every leaf but the ring; then one of its drain
    megaticks traced against the traced plain version, timed, beside its
    bound and the untraced drain megatick of this call
    (``untraced_row``). Returns (its launch counts, the drain megatick's
    row)."""
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    name = "trace_config5_wave_fused_storm"
    runner, prog = config5_runner("cuda", trace=Trace())
    final, m = _timed_storm(runner, prog, warm=False)
    line = _trace_storm_line(name, runner, prog, "sf", C5_SNAPSHOTS, final,
                             m, untraced, untraced_m)
    _, bad = _storm_verdict(runner, final, C5_SNAPSHOTS, False)
    del final
    if bad or line["untraced_mismatched"] or runner.fused_tile != "on":
        emit({**line, "main_path": True, "checks_failed": bad})
        raise AssertionError(f"{name}: {bad}, {line}")
    (row,) = drain_megatick_rows(runner, prog, "wave fault-free traced",
                                 graph="sf")
    row["untraced_ms"] = untraced_row["ms"]
    row["traced_over_untraced"] = row["ms"] / untraced_row["ms"]
    emit({**line, "main_path": True, "checks_failed": bad,
          "workspace_bytes": runner.kernel.fused_workspace.numel(),
          "drain_megatick": row})
    _check_launches(name, m["launches"], (
        "fused_scan", "fused_scan_tiled", "fused_scan_traced"))
    return m["launches"], row


def phase_trace_stream() -> dict:
    """The wave stream (``STW_BATCH`` lanes, J = 3 x B) traced at the
    default capacity, with the launch counts zeroed just before it: every
    job's row equal to the untraced stream's, the recorder arm launched
    in its drain slices and flushes, its admits and harvests in the
    rings (a lane whose ring did not wrap holds one harvest per admit).
    Returns its launch counts."""
    from chandy_lamport_tpu_torch.utils.tracing import (
        EV_LANE_ADMIT,
        EV_LANE_HARVEST,
        Trace,
    )

    runner, spec = stream_runner("cuda", STW_BATCH, exact_impl="wave",
                                 trace=Trace())
    _, pool = stream_queue(runner, spec)
    state, stream, m = drive_stream(runner, pool)
    rows = runner.stream_results(stream)
    plain_runner, _ = stream_runner("cuda", STW_BATCH, exact_impl="wave")
    _, ustream, um = drive_stream(plain_runner, pool)
    same = plain_runner.stream_results(ustream) == rows
    k = state.tr_meta.shape[-1]
    kinds = _held_kinds(state)
    whole = state.tr_count <= k
    admits = (kinds == EV_LANE_ADMIT).sum(-1)
    harvests = (kinds == EV_LANE_HARVEST).sum(-1)
    balanced = bool((admits == harvests)[whole].all())
    line = {**_stream_line("trace_stream", runner, pool, m),
            "trace_capacity": k, "rows_equal_untraced": same,
            "untraced_run_s": um["run_s"],
            "trace_overhead_pct": (m["run_s"] / um["run_s"] - 1) * 100,
            "ring": _ring_counts(state),
            "admits_held": int(admits.sum()),
            "harvests_held": int(harvests.sum()),
            "unwrapped_lanes": int(whole.sum()),
            "unwrapped_admits_equal_harvests": balanced}
    emit(line)
    if not same or not balanced or len(rows) != pool.num_jobs or \
            line["admits_held"] <= 0:
        raise AssertionError(f"trace_stream: rows equal {same}, admits "
                             f"balanced {balanced}, {line['ring']}")
    _check_launches("trace_stream", m["launches"],
                    ("fused_scan", "fused_scan_traced", "spread"))
    return m["launches"]


# graph sharding (slice 20): the giant cell, the JAX bench's row and the
# dist backend
GS_NODES, GS_SHARDS, GS_MEGATICK = 1_048_576, 4, 4
GS_ROW_SHARDS, GS_LANES, GS_LANE_SHARDS = 8, 256, 4
# the giant cell's shard edge width Em and its exchange's segments
# P * (Nl + R + 1) (--spread-timing's giant shape)
GS_SPREAD_EM, GS_SPREAD_SEGMENTS = 786_432, 2_101_412
# rows 1-5 run on every sharded path; rows 6-8 (and the exact broadcast's
# routed append) never do
GS_PATH = ("sum_by_perm", "sum_segments", "spread", "head_fields",
           "append_rows")
GS_IDLE = ("queue_step", "select_pop", "append_marker_rows", "fused_scan")
# the DenseState fields gather_dense fills from a ShardedState (the JAX
# tests' list)
GS_FIELDS = ("time", "tokens", "q_meta", "q_data", "q_head", "q_len",
             "tok_pushed", "mk_cnt", "m_pending", "m_rtime", "m_key",
             "next_sid", "started", "has_local", "frozen", "rem",
             "done_local", "recording", "rec_cnt", "min_prot", "log_amt",
             "rec_start", "rec_end", "completed", "error")


def _gs_config():
    """The port's bench config for ``--graph sf --snapshots 8 --phases
    32`` (C=16, S=8, L=32, int16 log)."""
    from chandy_lamport_tpu_torch.config import SimConfig

    return SimConfig.for_workload(snapshots=SNAPSHOTS, record_dtype="int16",
                                  split_markers=True)


def _gs_program(topo):
    from chandy_lamport_tpu_torch.models.workloads import (
        staggered_snapshots,
        storm_program,
    )

    return storm_program(topo, phases=PHASES, amount=1,
                         snapshot_phases=staggered_snapshots(
                             topo, SNAPSHOTS, 1, 2, max_phases=PHASES))


def _gs_recorded(final, cfg) -> list:
    """Each slot's recorded tokens summed over every edge of a
    single-instance ShardedState on the card: a slot's window on an edge
    covers ring positions (start + k) % L, k < (end or the live count) -
    start (int32 windows)."""
    import torch

    lcap = final.log_amt.shape[1]
    ll = torch.arange(lcap, dtype=torch.int32, device=final.log_amt.device)
    out = []
    for sid in range(cfg.max_snapshots):
        start = final.rec_start[:, sid].unsqueeze(1)          # [P, 1, Em]
        end = torch.where(final.recording[:, sid], final.rec_cnt,
                          final.rec_end[:, sid]).unsqueeze(1)
        inside = ((ll[None, :, None] - start) % lcap) < (end - start)
        out.append(int(torch.where(inside, final.log_amt, 0)
                       .sum(dtype=torch.int64)))
    return out


def _gs_run(name, runner, prog, extra=None) -> tuple:
    """One sharded storm on the card with the launch counts zeroed just
    before it: rows 1-5 launched, rows 6-8 never. Returns (final, the
    phase line's fields)."""
    import torch

    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    state = runner.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    final = runner.run_storm(state, prog.amounts, prog.snap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    _check_launches(name, launches, GS_PATH, GS_IDLE)
    ticks = int(final.time)
    del state
    return final, {
        "phase": name, "nodes": runner.topo.n, "edges": runner.topo.e,
        "shards": runner.shards, "backend": runner.mesh.backend,
        "comm_engine": runner.comm_engine, "megatick": runner.megatick,
        "delay": (f"fixed({runner.fixed_delay})" if runner.fixed_delay
                  else f"threefry({runner.seed})"),
        "queue_capacity": runner.config.queue_capacity,
        "max_recorded": runner.config.max_recorded, "em": runner.em,
        "nl": runner.nl, "wall_s": wall, "ticks": ticks,
        "ms_per_tick": wall / ticks * 1e3,
        "node_ticks_per_s": ticks * runner.topo.n / wall,
        "cut_edges": runner._bt.cut_edges, "halo": runner.halo,
        "comm_bytes_model": runner.comm_model(),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "error_bits": int(final.error), "launches": launches,
        **(extra or {})}


def _gs_kernel_rows(gs, final, prog) -> dict:
    """Rows 4 and 5 at the giant cell's stacked shapes ([P, Em, C] rings
    of ``final``; the append of phase 0's sends on them), bit for bit
    against their plain versions, timed beside their bounds as the kernels
    phase times them; rows 1-3 at the shapes this path gives them, beside
    index_add_ / index_select. Returns {kernel: [row, ...]}."""
    import numpy as np
    import torch

    from chandy_lamport_tpu_torch.kernels import queue as kq
    from chandy_lamport_tpu_torch.kernels import segment as ks

    p, em, c = final.q_meta.shape
    rows = {}

    def record(name, note, got, want, kernel_fn, plain_fn, nbytes, ops,
               library_fn=None):
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} ({note}): kernel != plain, max "
                                 f"|diff| {err}")
        rows.setdefault(name, []).append({
            "shape": note, "max_abs_err": err, "ms": time_ms(kernel_fn, 5),
            "plain_ms": time_ms(plain_fn, 3),
            "library_ms": time_ms(library_fn, 5) if library_fn else None,
            **bound(nbytes, ops)})

    q_meta, q_data, q_head = final.q_meta, final.q_data, final.q_head
    record("head_fields", f"[{p},{em},{c}] planes (stacked shards)",
           list(kq.head_fields(q_meta, q_data, q_head)),
           list(kq.head_fields_plain(q_meta, q_data, q_head)),
           lambda: kq.head_fields(q_meta, q_data, q_head),
           lambda: kq.head_fields_plain(q_meta, q_data, q_head),
           p * em * (4 + 2 * 32 + 9), 3 * p * em)
    amounts = gs.shard_program(np.asarray(prog.amounts[:1]),
                               np.asarray(prog.snap[:1]))[0][0]
    active = amounts > 0
    rt = torch.full((p, em), int(final.time) + 3, dtype=torch.int32,
                    device=amounts.device)
    leaves = (final.q_meta, final.q_data, final.q_head, final.q_len,
              final.tok_pushed, torch.zeros(p, dtype=torch.int32,
                                            device=amounts.device))
    rows_in = (active, rt, False, amounts)
    lk, lp = clones(leaves), clones(leaves)
    kw = dict(capacity=c, key_limit=gs._key_limit, flag_queue_overflow=False)
    got = kq.append_rows(*lk, *rows_in, **kw)
    want = kq.append_rows_plain(*lp, *rows_in, **kw)
    record("append_rows", f"[{p},{em},{c}] planes (stacked shards), "
                          f"{int(active.sum())} active rows",
           list(got), list(want),
           lambda: kq.append_rows(*lk, *rows_in, **kw),
           lambda: kq.append_rows_plain(*lp, *rows_in, **kw),
           *append_work(p * em, int(active.sum()), p))
    del lk, lp
    # rows 1-3 at the sparse exchange's shapes: the [S+1, P*Em] payload
    # into P*(Nl+R+1) segments, the debits, the created flags onto edges
    gen = torch.Generator(device="cpu").manual_seed(7)
    s1 = gs.config.max_snapshots + 1
    pe, segs = p * em, gs._t_seg_lo.numel()
    payload = torch.randint(0, 2, (1, s1, pe), generator=gen,
                            dtype=torch.int32).to(amounts.device)
    perm, lo, hi = gs._t_seg_perm, gs._t_seg_lo, gs._t_seg_hi
    seg_of = torch.empty(pe, dtype=torch.int64, device=amounts.device)
    seg_of[perm.long()] = torch.repeat_interleave(
        torch.arange(segs, device=amounts.device), (hi - lo).long())
    lib = torch.zeros((1, s1, segs), dtype=torch.int32,
                      device=amounts.device)
    record("sum_by_perm", f"[1,{s1},{pe}] int32 -> {segs} segments",
           [ks.sum_by_perm(payload, perm, lo, hi)],
           [ks.sum_by_perm_plain(payload, perm, lo, hi)],
           lambda: ks.sum_by_perm(payload, perm, lo, hi),
           lambda: ks.sum_by_perm_plain(payload, perm, lo, hi),
           payload.numel() * 4 + 4 * pe + 8 * segs + 4 * s1 * segs,
           payload.numel(), lambda: lib.index_add_(-1, seg_of, payload))
    amt = amounts.reshape(-1).contiguous()
    dlo, dhi = gs._t_dlo, gs._t_dhi
    nodes = dlo.numel()
    src_l = gs._t_src_l.long()      # pads carry 0 onto their shard's node 0
    lib1 = torch.zeros(nodes, dtype=torch.int32, device=amt.device)
    record("sum_segments", f"[{pe}] int32 -> {nodes} sources",
           [ks.sum_segments(amt, dlo, dhi)],
           [ks.sum_segments_plain(amt, dlo, dhi)],
           lambda: ks.sum_segments(amt, dlo, dhi),
           lambda: ks.sum_segments_plain(amt, dlo, dhi),
           4 * pe + 8 * nodes + 4 * nodes, pe,
           lambda: lib1.index_add_(0, src_l, amt))
    flags = (torch.rand((1, s1 - 1, segs), generator=gen) < 0.3).to(
        amounts.device)
    idx = gs._t_dst_seg
    idx_long = idx.long()
    record("spread", f"[1,{s1 - 1},{segs}] bool -> {pe} edges (dst_seg)",
           [ks.spread(flags, idx)], [ks.spread_plain(flags, idx)],
           lambda: ks.spread(flags, idx),
           lambda: ks.spread_plain(flags, idx),
           flags.numel() + 4 * pe + (s1 - 1) * pe, 0,
           lambda: torch.index_select(flags, -1, idx_long))
    return rows


def phase_graphshard_giant() -> tuple:
    """Main path 33: ``scale_free(1_048_576, 2, seed=3)`` split four ways,
    stacked on the card (sparse engine, megatick 4): under the fixed
    delay its de-sharded final state equals the unsharded sync runner's
    on the same program leaf for leaf, and under the per-shard threefry
    streams (seed 17, the conservation check every 8 phases) it is clean
    with every snapshot complete and frozen + recorded equal to the
    tokens; rows 4-5 at its stacked shapes against their plain versions.
    Returns ({path: launches}, {kernel: rows})."""
    import numpy as np
    import torch

    from chandy_lamport_tpu_torch import BatchedRunner
    from chandy_lamport_tpu_torch.models.workloads import scale_free
    from chandy_lamport_tpu_torch.ops.delay import FixedDelay
    from chandy_lamport_tpu_torch.parallel.graphshard import (
        GraphShardedRunner,
    )
    from chandy_lamport_tpu_torch.parallel.mesh import Mesh
    from chandy_lamport_tpu_torch.utils.carry import state_to_numpy

    t0 = time.perf_counter()
    spec = scale_free(GS_NODES, ATTACH, seed=3, tokens=PHASES + 10)
    cfg = _gs_config()
    ref = BatchedRunner(spec, cfg, FixedDelay(2), 1, scheduler="sync",
                        device="cuda")
    topo = ref.topo
    prog = _gs_program(topo)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_final = ref.run_storm(ref.init_batch_device(), prog)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_host = state_to_numpy(ref_final)
    want = {name: np.asarray(getattr(ref_host, name))[0]
            for name in GS_FIELDS}
    ref_ticks = int(ref_final.time[0])
    del ref, ref_final, ref_host
    mesh = Mesh({"graph": GS_SHARDS}, device="cuda")
    paths, rows = {}, {}
    total = int(topo.tokens0.sum())
    for label, kw in (("fixed", {"fixed_delay": 2}),
                      ("uniform", {"seed": DELAY_SEED, "check_every": 8})):
        t0 = time.perf_counter()
        gs = GraphShardedRunner(topo, cfg, mesh, comm_engine="sparse",
                                megatick=GS_MEGATICK, **kw)
        build_s = time.perf_counter() - t0
        name = f"graphshard_giant_{label}"
        final, line = _gs_run(name, gs, prog, {"runner_build_s": build_s})
        paths[name] = line["launches"]
        bad = []
        if label == "fixed":
            got = gs.gather_dense(final)
            mism = [f for f in GS_FIELDS if not np.array_equal(
                np.asarray(getattr(got, f)), want[f])]
            line.update(setup_s=setup_s, unsharded_run_s=ref_s,
                        unsharded_ticks=ref_ticks, leaves=len(GS_FIELDS),
                        mismatched=mism)
            if mism:
                bad.append(f"differs from the unsharded sync runner in "
                           f"{mism}")
            rows = _gs_kernel_rows(gs, final, prog)
            line["kernel_rows"] = rows
        else:
            started = final.started.cpu().numpy()
            completed = final.completed.cpu().numpy()
            frozen = final.frozen.sum(dim=(0, 2), dtype=torch.int64)
            recorded = _gs_recorded(final, gs.config)
            sums = [int(frozen[i]) + recorded[i]
                    for i in range(gs.config.max_snapshots) if started[i]]
            line.update(snapshots_started=int(started.sum()),
                        snapshots_completed=int(
                            (started & (completed >= topo.n)).sum()),
                        frozen_plus_recorded=sums, tokens_total=total)
            if int(started.sum()) != SNAPSHOTS or not (
                    completed[started] >= topo.n).all():
                bad.append("a snapshot did not complete")
            if any(x != total for x in sums):
                bad.append(f"frozen + recorded {sums} != tokens {total}")
        if line["error_bits"]:
            bad.append(f"error bits {line['error_bits']}")
        emit(line)
        if bad:
            raise AssertionError(f"{name}: {bad}")
        del final, gs
    return paths, rows


def phase_graphshard_row() -> dict:
    """Main path 34, the JAX bench's graphshard row (sf-1024 over 8
    shards, megatick 4, the per-shard streams of seed 17): the sparse and
    dense engines' de-sharded finals equal; then the data x graph mode,
    ``run_storm_batched`` over 256 lanes x 4 shards of the same graph:
    under the fixed delay every lane equals the single-instance run, under
    the per-(lane, shard) streams every lane is clean, complete and
    conserved. Returns {path: launches}."""
    import numpy as np
    import torch

    from chandy_lamport_tpu_torch.models.workloads import scale_free
    from chandy_lamport_tpu_torch.parallel.graphshard import (
        GraphShardedRunner,
        state_to_numpy,
    )
    from chandy_lamport_tpu_torch.parallel.mesh import Mesh
    from chandy_lamport_tpu_torch.utils.metrics import _occupied

    spec = scale_free(NODES, ATTACH, seed=3, tokens=PHASES + 10)
    cfg = _gs_config()
    paths, dense = {}, {}
    mesh = Mesh({"graph": GS_ROW_SHARDS}, device="cuda")
    for engine in ("sparse", "dense"):
        gs = GraphShardedRunner(spec, cfg, mesh, seed=DELAY_SEED,
                                comm_engine=engine, megatick=GS_MEGATICK)
        prog = _gs_program(gs.topo)
        name = f"graphshard_row_{engine}"
        final, line = _gs_run(name, gs, prog)
        paths[name] = line["launches"]
        dense[engine] = gs.gather_dense(final)
        emit(line)
        if line["error_bits"]:
            raise AssertionError(f"{name}: error bits {line['error_bits']}")
    mism = [f for f in GS_FIELDS if not np.array_equal(
        np.asarray(getattr(dense["sparse"], f)),
        np.asarray(getattr(dense["dense"], f)))]
    emit({"phase": "graphshard_row_sparse_vs_dense",
          "leaves": len(GS_FIELDS), "mismatched": mism})
    if mism:
        raise AssertionError(f"sparse and dense differ in {mism}")
    from chandy_lamport_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    lane_mesh = Mesh({"data": 1, "graph": GS_LANE_SHARDS}, device="cuda")
    for label, kw in (("fixed", {"fixed_delay": 2}),
                      ("uniform", {"seed": DELAY_SEED, "check_every": 8})):
        gs = GraphShardedRunner(spec, cfg, lane_mesh, comm_engine="sparse",
                                megatick=GS_MEGATICK, **kw)
        prog = _gs_program(gs.topo)
        state = gs.init_batch(GS_LANES)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        final = gs.run_storm_batched(state, prog.amounts, prog.snap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        name = f"graphshard_lanes_{label}"
        paths[name] = launch_counts()
        _check_launches(name, paths[name], GS_PATH, GS_IDLE)
        bad = []
        n = gs.topo.n
        done = (final.started & (final.completed >= n)).sum(-1)
        occ = _occupied(final._replace(q_head=final.q_head.flatten(1),
                                       q_len=final.q_len.flatten(1)),
                        gs.config)
        held = (final.tokens.sum(dim=(1, 2), dtype=torch.int64)
                + torch.where(occ, final.q_data.flatten(1, 2), 0)
                .sum(dim=(1, 2), dtype=torch.int64))
        total = int(gs.topo.tokens0.sum())
        line = {"phase": name, "lanes": GS_LANES, "shards": gs.shards,
                "wall_s": wall, "max_lane_ticks": int(final.time.max()),
                "lane_ticks": int(final.time.sum()),
                "node_ticks_per_s": int(final.time.sum()) * n / wall,
                "lanes_with_errors": int((final.error != 0).sum()),
                "lanes_complete": int((done == SNAPSHOTS).sum()),
                "lanes_conserved": int((held == total).sum()),
                "launches": paths[name]}
        if label == "fixed":
            single = state_to_numpy(gs.run_storm(gs.init_state(),
                                                 prog.amounts, prog.snap))
            host = state_to_numpy(final)
            differ = sorted({f for f, a, b in zip(single._fields, host,
                                                  single)
                             if f != "delay_key"
                             and not (a == b[None]).all()})
            line["lane_vs_single_mismatched"] = differ
            if differ:
                bad.append(f"lanes differ from the single instance in "
                           f"{differ}")
        for key in ("lanes_complete", "lanes_conserved"):
            if line[key] != GS_LANES:
                bad.append(f"{key} {line[key]} of {GS_LANES}")
        if line["lanes_with_errors"]:
            bad.append(f"{line['lanes_with_errors']} lanes with errors")
        emit(line)
        if bad:
            raise AssertionError(f"{name}: {bad}")
        del final, state
    return paths


def phase_graphshard_dist() -> dict:
    """The dist backend on the card: two processes on the one card over
    gloo (its CUDA rows staged through host memory, ``Mesh.staged``), P =
    2 over sf-1024, both engines under the fixed delay, each process's
    shard equal to the matching shard of the stacked run on the card; and
    NCCL at world size 1 (P = 1), equal to stacked P = 1. NCCL beyond one
    process is not checked here: the machine has one card, and NCCL does
    not put two processes on one device. Returns {path: launches}."""
    import tempfile

    from chandy_lamport_tpu_torch.parallel import multihost

    paths = {}
    jobs = (("gloo", 2, ("sparse", "dense")), ("nccl", 1, ("sparse",)))
    with tempfile.TemporaryDirectory() as tmp:
        # both jobs at once (their processes start up together)
        t0 = time.perf_counter()
        procs = []
        for backend, world, engines in jobs:
            os.makedirs(f"{tmp}/{backend}")
            procs.append(multihost.spawn(
                ["-m", "chandy_lamport_tpu_torch.parallel.multihost",
                 "--case", "--graph", "sf", "--nodes", str(NODES),
                 "--phases", str(PHASES), "--snapshots", str(SNAPSHOTS),
                 "--fixed-delay", "2", "--device", "cuda", "--backend",
                 backend, "--out", f"{tmp}/{backend}", "--engine",
                 *engines], world))
        try:
            _gs_dist_check(jobs, procs, tmp, t0, paths)
        finally:
            for job in procs:
                for p in job:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
    return paths


def _gs_dist_check(jobs, procs, tmp, t0, paths) -> None:
    """Collect each dist job of ``phase_graphshard_dist``, hold every
    process's shard to the stacked run on the card, emit its line and add
    its processes' launches to ``paths``."""
    import numpy as np

    from chandy_lamport_tpu_torch.kernels import launch_counts
    from chandy_lamport_tpu_torch.parallel import multihost
    from chandy_lamport_tpu_torch.parallel.graphshard import (
        _SHARDED,
        state_to_numpy,
    )
    from chandy_lamport_tpu_torch.parallel.mesh import Mesh

    class Case:
        graph, nodes, phases, snapshots = "sf", NODES, PHASES, SNAPSHOTS
        seed, megatick, fixed_delay = DELAY_SEED, 1, 2

    for (backend, world, engines), job in zip(jobs, procs):
        results = multihost.collect(job, timeout=300)
        job_s = time.perf_counter() - t0
        rows = []
        for rank, (rc, out, err) in enumerate(results):
            if rc != 0:
                raise AssertionError(f"{backend} rank {rank} rc={rc}: "
                                     f"{err[-2000:]}")
            rows.append(json.loads(out.strip().splitlines()[-1]))
        mism = {}
        for engine in engines:
            runner, prog = multihost.case_runner(
                Case, Mesh({"graph": world}, device="cuda"), engine)
            want = state_to_numpy(runner.run_storm(
                runner.init_state(), prog.amounts, prog.snap))
            for rank in range(world):
                with np.load(f"{tmp}/{backend}/rank{rank}-{engine}"
                             ".npz") as z:
                    got = {k: z[k] for k in z.files}
                bad = [f for f in want._fields if not np.array_equal(
                    got[f], np.asarray(getattr(want, f))[rank:rank + 1]
                    if f in _SHARDED else np.asarray(getattr(want, f)))]
                if bad:
                    mism[f"{engine} rank {rank}"] = bad
        name = f"graphshard_dist_{backend}"
        launches = {k: sum(r["launches"][k] for row in rows
                           for r in row["runs"])
                    for k in launch_counts()}
        paths[name] = launches
        emit({"phase": name, "world": world, "backend": backend,
              "shards": world, "engines": list(engines),
              "staged_through_host": rows[0]["staged_through_host"],
              "job_s": job_s, "ranks": rows, "mismatched": mism,
              "launches": launches,
              "nccl_beyond_one_process": "not checked: one card, and "
              "NCCL does not put two processes on one device"})
        if mism:
            raise AssertionError(f"{name}: a shard differs from the "
                                 f"stacked run: {mism}")
        _check_launches(name, launches, GS_PATH, GS_IDLE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--drain-timing", nargs="+", metavar="CELL",
                    choices=DRAIN_CELLS + TILED_CELLS
                    + tuple(f"{c}-traced" for c in DRAIN_CELLS
                            + TILED_CELLS),
                    help="only time one drain megatick of each of these "
                         "exact cells, in order (-traced: with the flight "
                         "recorder armed; -tiled: in the tiled layout)")
    ap.add_argument("--spread-timing", action="store_true",
                    help="only time spread against index_select at the "
                         "crash gate's shape, in turns")
    ap.add_argument("--append-timing", action="store_true",
                    help="only time append_rows and its callers at their "
                         "three shapes")
    ap.add_argument("--ptxas", action="store_true",
                    help="only compile each CUDA source to a cubin with "
                         "-Xptxas -v and print its kernels' registers and "
                         "spills")
    ap.add_argument("--queue-timing", action="store_true",
                    help="only time head_fields, queue_step and "
                         "select_pop at their timed shapes")
    ap.add_argument("--batch", type=int,
                    help="with --drain-timing: the lanes of the cell "
                         "(default: the cell's own)")
    ap.add_argument("--package-root",
                    help="with a timing mode: import the package from "
                         "this checkout (a parent commit unpacked beside "
                         "this one)")
    args = ap.parse_args(argv)
    timing = (args.drain_timing or args.spread_timing or args.append_timing
              or args.queue_timing or args.ptxas)
    if args.batch and not args.drain_timing:
        ap.error("--batch goes with --drain-timing")
    if args.package_root and not timing:
        ap.error("--package-root goes with a timing mode")
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from chandy_lamport_tpu_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})",
              file=sys.stderr)
        return 2

    if args.drain_timing:
        for cell in args.drain_timing:
            drain_timing(cell, args.batch)
        return 0
    if args.spread_timing:
        return spread_timing()
    if args.append_timing:
        return append_timing()
    if args.ptxas:
        return ptxas_report()
    if args.queue_timing:
        return queue_timing()
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.library("segment")
    emit({"phase": "device", "nvidia_smi": smi,
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_s": time.perf_counter() - t0,
          "nvcc_s": _build.build_seconds})

    runner, prog = config4_runner("cuda")
    xrunner, xprog = exact_runner("cuda")
    frunner, fprog = fault_runner("cuda")
    mrunner, mprog = exact_runner("cuda", megatick=MEGATICK)
    f8runner, f8prog = fault_runner("cuda", megatick=MEGATICK)
    wrunner, _ = exact_runner("cuda", exact_impl="wave")
    w8runner, _ = exact_runner("cuda", megatick=MEGATICK, exact_impl="wave")
    fw8runner, _ = fault_runner("cuda", megatick=MEGATICK, exact_impl="wave")
    # the same megatick-8 cells in the tiled layout
    tiled = {"fused_storm": exact_runner("cuda", megatick=MEGATICK,
                                         tiled=True)[0],
             "wave_fused_storm": exact_runner(
                 "cuda", megatick=MEGATICK, exact_impl="wave",
                 tiled=True)[0],
             "fault_fused_storm": fault_runner("cuda", megatick=MEGATICK,
                                               tiled=True)[0],
             "fault_wave_fused_storm": fault_runner(
                 "cuda", megatick=MEGATICK, exact_impl="wave",
                 tiled=True)[0]}
    rows, all_rows = phase_kernels(runner, prog, xrunner, xprog, frunner,
                                   fprog, wrunner)
    rows["fused_scan"], tiled_cases = phase_fused_kernel(
        {"fault-free": (mrunner, tiled["fused_storm"]),
         "faulted": (f8runner, tiled["fault_fused_storm"]),
         "wave fault-free": (w8runner, tiled["wave_fused_storm"]),
         "wave faulted": (fw8runner, tiled["fault_wave_fused_storm"])},
        mprog, f8prog)
    phase_tiled_edge_cases(tiled_cases)
    rows["fused_scan"] += phase_trace_kernel(rows["fused_scan"][:8])
    phase_trace_edge_cases()
    # each main path runs with the launch counts zeroed just before it
    sync_final, m = phase_storm("storm", runner, prog, "sf", SNAPSHOTS,
                                ("sum_by_perm", "sum_segments", "spread",
                                 "head_fields", "append_rows"))
    paths = {"sync_storm": m["launches"]}
    del runner
    w16_paths, w16_rows = phase_window16(
        sync_final, {r["layout"]: r for r in rows["fused_scan"][:2]})
    paths.update(w16_paths)
    rows["fused_scan"] += w16_rows
    del sync_final
    fsrunner, fsprog = config4_runner("cuda", faulted=True,
                                      batch=FS_BATCH)
    fs_final, m = phase_fault_sync_storm(fsrunner, fsprog)
    paths["fault_sync_storm"] = m["launches"]
    del fsrunner, fs_final
    phase_checkpoint()
    # the resident megatick-8 storms' finals, for their tiled twins
    resident = {}
    del xrunner
    exact_final, exact_m = phase_storm(
        "exact_storm", exact_runner("cuda", M1_BATCH)[0], xprog, "er",
        X_SNAPSHOTS, ("queue_step", "append_rows", "append_marker_rows",
                      "sum_by_perm", "sum_segments"))
    paths["exact_storm"] = exact_m["launches"]
    fused_final, m = phase_storm(
        "fused_storm", mrunner, mprog, "er", X_SNAPSHOTS,
        ("fused_scan", "queue_step", "append_rows", "append_marker_rows",
         "sum_by_perm", "sum_segments"))
    paths["fused_storm"] = m["launches"]
    resident["fused_storm"] = (mprog, fused_final, m)
    bad = _mismatched(_first_lanes(fused_final, M1_BATCH), exact_final)
    emit({"phase": "fused_storm_vs_exact_storm",
          "leaves": len(exact_final._fields), "mismatched": bad,
          "lanes_compared": M1_BATCH,
          "queue_step_launches": m["launches"]["queue_step"],
          "storm_phases": X_PHASES})
    if bad:
        raise AssertionError(f"megatick-8 storm differs from megatick 1 in "
                             f"{bad}")
    if m["launches"]["queue_step"] != X_PHASES:
        raise AssertionError("fused_storm ran queue_step outside its storm "
                             "phases")
    del mrunner
    # the wave twins of the two: each held to its cascade twin
    exact_kernels = ("queue_step", "append_rows", "append_marker_rows",
                     "sum_by_perm", "sum_segments", "spread")
    for name, wr, twin, twin_name, twin_m, kernels in (
            ("wave_storm", wrunner, exact_final, "exact_storm", exact_m,
             exact_kernels),
            ("wave_fused_storm", w8runner, fused_final, "fused_storm",
             m, ("fused_scan",) + exact_kernels)):
        final, wm = phase_storm(name, wr, xprog, "er", X_SNAPSHOTS, kernels)
        paths[name] = wm["launches"]
        _twin_check(name, _first_lanes(final, int(twin.time.shape[0])), wm,
                    twin_name, twin, twin_m)
        if name == "wave_fused_storm":
            if wm["launches"]["queue_step"] != X_PHASES:
                raise AssertionError("wave_fused_storm ran queue_step "
                                     "outside its storm phases")
            resident[name] = (xprog, final, wm)
        del final
    del wrunner, w8runner, exact_final, fused_final
    fault_kernels = ("select_pop", "head_fields", "spread", "append_rows",
                     "append_marker_rows", "sum_by_perm", "sum_segments")
    del frunner
    fault_final, m = phase_fault_storm(
        "fault_storm", fault_runner("cuda", M1_BATCH)[0], fprog,
        fault_kernels)
    paths["fault_storm"] = m["launches"]
    fused_final, m = phase_fault_storm("fault_fused_storm", f8runner,
                                       f8prog, ("fused_scan",)
                                       + fault_kernels)
    paths["fault_fused_storm"] = m["launches"]
    resident["fault_fused_storm"] = (f8prog, fused_final, m)
    bad = _mismatched(_first_lanes(fused_final, M1_BATCH), fault_final)
    emit({"phase": "fault_fused_storm_vs_fault_storm",
          "leaves": len(fault_final._fields), "mismatched": bad,
          "lanes_compared": M1_BATCH,
          "fused_scan_launches": m["launches"]["fused_scan"],
          "drain_fold_steps": m["drain_fold_steps"],
          "fold_steps": m["fold_steps"]})
    if bad:
        raise AssertionError(f"the megatick-8 faulted storm differs from "
                             f"megatick 1 in {bad}")
    if m["drain_fold_steps"] != 0:
        raise AssertionError("fault_fused_storm folded on the host in its "
                             "drain or flush")
    del f8runner, fault_final
    final, wm = phase_fault_storm("fault_wave_fused_storm", fw8runner,
                                  f8prog, ("fused_scan", "spread")
                                  + fault_kernels)
    paths["fault_wave_fused_storm"] = wm["launches"]
    _twin_check("fault_wave_fused_storm", final, wm, "fault_fused_storm",
                fused_final, m)
    if wm["drain_fold_steps"] != 0:
        raise AssertionError("fault_wave_fused_storm stepped on the host in "
                             "its drain or flush")
    resident["fault_wave_fused_storm"] = (f8prog, final, wm)
    del fw8runner, final, fused_final
    paths.update(phase_tiled_vs_resident(
        {name: (tiled[name], p, final, m)
         for name, (p, final, m) in resident.items()}))
    paths.update(phase_trace_storms(resident))
    del resident, tiled
    paths.update(phase_sf2048_tiled_cascade_storm())
    paths["config5_wave_fused_storm"], c5_rows, c5_final, c5_m = \
        phase_config5_wave_fused_storm()
    rows["fused_scan"] += c5_rows
    paths["trace_config5_wave_fused_storm"], c5_traced = \
        phase_trace_config5(c5_final, c5_m, c5_rows[0])
    rows["fused_scan"].append(c5_traced)
    del c5_final
    stream_paths, stream_rows = phase_streams()
    paths.update(stream_paths)
    rows["fused_scan"] += stream_rows
    paths["trace_stream"] = phase_trace_stream()
    paths["memo_stream"] = phase_memo_stream()
    paths["prefix_stream"] = phase_prefix_stream()
    per_step = STREAM_JOBS_PER_STEP["stream_exact"]
    paths["serve_edf"] = phase_serve_edf(per_step)
    paths["serve_memo_quota"] = phase_serve_memo_quota(2.0 * per_step)
    paths["fleet"] = phase_fleet()
    paths["host_surface"] = phase_host_surface()
    paths["golden"] = phase_golden()
    paths["trace_golden"] = phase_trace_golden()
    uniform_paths, uniform_row = phase_uniform(rows["fused_scan"][0])
    paths.update(uniform_paths)
    rows["fused_scan"].append(uniform_row)
    paths.update(phase_dense_faults())
    paths.update(phase_fold())
    gs_paths, gs_rows = phase_graphshard_giant()
    paths.update(gs_paths)
    paths.update(phase_graphshard_row())
    paths.update(phase_graphshard_dist())
    phase_cpu_vs_cuda()

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name][0]
        by_path = {path: counts[name] for path, counts in paths.items()}
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": row["shape"],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        # the segment sums: device and host time per call at every shape
        # of their paths, beside index_add_'s; fused_scan: its fault-free
        # and faulted drain megatick
        timed = [r for r in all_rows.get(name, ()) if "device_ms" in r]
        if name == "spread":
            # every timed shape, index_select's times beside its own
            entry["shapes"] = [{key: r[key] for key in (
                "shape", "main", "ms", "plain_ms", "bound_ms", "library_ms",
                *SPLIT_KEYS, *TURN_KEYS)} for r in all_rows[name]]
        if name == "fused_scan":
            entry["shapes"] = [{**{key: r[key] for key in (
                "shape", "layout", "ms", "plain_ms", "bound_ms",
                "bound_by")}, "traced": r.get("traced", False),
                "arm": r.get("arm", "hash sampler, int32 windows")}
                for r in rows[name]]
            # the slice-17 arms: the threefry sampler kind and the uint16
            # window planes, each beside the hash / int32 arm of this run
            entry["arms"] = [
                {key: r[key] for key in (
                    "arm", "shape", "layout", "ms", "bound_ms", "bound_by",
                    "plain_ms", "max_abs_err", "hash_ms", "int32_ms",
                    "threefry_over_hash", "uint16_over_int32") if key in r}
                for r in rows[name] if "arm" in r]
            for arm in ("tiled", "traced"):
                entry[f"launches_{arm}"] = sum(
                    counts[f"fused_scan_{arm}"] for counts in paths.values())
            # the recorder arm: the traced drain megaticks beside the
            # untraced ones, and its launches by path
            entry["traced_arms"] = [
                {key: r[key] for key in (
                    "shape", "layout", "ms", "untraced_ms",
                    "traced_over_untraced", "bound_ms", "bound_by",
                    "plain_ms", "max_abs_err")}
                for r in rows[name] if "traced_over_untraced" in r]
            entry["launches_traced_by_path"] = {
                path: counts["fused_scan_traced"]
                for path, counts in paths.items()
                if counts["fused_scan_traced"]}
        if name in gs_rows:
            # the giant graphshard cell's shapes (rows 4-5 at the stacked
            # [P, Em, C] rings, rows 1-3 at the sparse exchange's)
            entry["graphshard_shapes"] = [
                {key: r[key] for key in ("shape", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "max_abs_err")}
                for r in gs_rows[name]]
        if timed:
            entry.update({key: row[key] for key in SPLIT_KEYS})
        if timed and name != "spread":
            entry["shapes"] = [{key: r[key] for key in (
                "shape", "main", "ms", "bound_ms", "library_ms",
                *SPLIT_KEYS)} for r in timed]
        kernels.append(entry)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
