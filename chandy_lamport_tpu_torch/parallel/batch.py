"""Batched storm runs: B independent instances advanced together.

The port of the JAX package's ``parallel/batch.BatchedRunner`` for its
storm programs, under ``scheduler="sync"`` and ``scheduler="exact"`` (the
cascade and the wave formulations): the state carries the batch as a
leading axis (in place of ``jax.vmap``), a storm program runs as a
Python loop over its phases, and the drain ticks each lane until its own
condition ends (ops/tick.py); at ``megatick`` K > 1 the exact drain and flush run in
K-tick megaticks through the fused megatick kernel. Runs on the card
unless the caller passes ``device="cpu"``,
where the kernel wrappers take their plain PyTorch versions. The exact
scheduler also carries the fault adversary (``faults=``), the snapshot
supervisor (the config's ``snapshot_*`` knobs) and ``quarantine=``.
Batched event scripts (``compile_events``/``run``), the flight recorder
(``trace=``) and the sync scheduler under faults are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.state import (
    ERR_CONSERVATION,
    DenseState,
    DenseTopology,
    decode_error_bits,
    init_state,
)
from chandy_lamport_tpu_torch.ops.tick import TickKernel
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec
from chandy_lamport_tpu_torch.utils.metrics import (
    lane_total_tokens,
    or_reduce,
    snapshot_lifecycle,
    straggler_waste,
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Without CUDA and without an explicit device, raise — a run
    meant for the card never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available and no device was given; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


class BatchedRunner:
    """Runs storm programs over ``batch`` lanes of one topology."""

    def __init__(self, topology: TopologySpec, config: Optional[SimConfig],
                 delay, batch: int, scheduler: str = "sync",
                 check_every: int = 0, device=None,
                 exact_impl: str = "cascade", faults=None,
                 quarantine: bool = False, trace=None, megatick: int = 1):
        """scheduler: "sync" (simultaneous delivery, the production path)
        or "exact" (the reference's delivery semantics, bit-exact).

        exact_impl: the exact tick's formulation, "cascade" (one host step
        per batched marker delivery) or "wave" (one host step per wave:
        every destination's next marker at once; needs a
        position-addressable sampler, HashDelay or FixedDelay, else
        ValueError); bit-identical to each other, at any megatick.
        "fold" raises NotImplementedError (ROADMAP.md, A5b).

        faults: models/faults.Faults, the deterministic fault adversary,
        armed per lane by the ``fault_key`` ramp of
        ``Faults.init_batch_state`` (zero a lane's key to disarm it); None
        calls no hook. Exact scheduler only.

        quarantine: a lane whose sticky error bits fire stops — its storm
        phases, drain and flush ticks are skipped and its clock stays
        where it was poisoned; healthy lanes are unaffected. Exact
        scheduler only.

        trace: the flight recorder is not ported (NotImplementedError).

        megatick: the exact drain and flush run K-tick megaticks (the JAX
        storm CLI's ``--megatick``; storm phases tick one at a time);
        bit-identical to 1, the default. On the card they launch the
        fused megatick kernel, on the CPU they run its plain form;
        ``self.fused`` and ``self.fused_reason`` say which, under faults
        and the supervisor as without them. Megatick > 1 raises
        ValueError on the sync scheduler (the megatick is the exact
        scheduler's).

        check_every: if > 0, evaluate token conservation every K phases
        and once after the run, setting the sticky ERR_CONSERVATION bit on
        any lane whose balances + in-flight tokens drift.

        device: where the state lives and the kernels run; None means the
        card (``resolve_device``)."""
        if scheduler not in ("sync", "exact"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if check_every < 0:
            raise ValueError("check_every must be >= 0 (0 = off)")
        if trace is not None:
            raise NotImplementedError(
                "the flight recorder (trace=, utils/tracing.py) is not "
                "ported yet (ROADMAP.md, section A)")
        self.device = resolve_device(device)
        self.topo = DenseTopology(topology)
        self.config = config or SimConfig()
        # the flush must cover the sampler's max delay
        if delay.max_delay != self.config.max_delay:
            self.config = dataclasses.replace(self.config,
                                              max_delay=delay.max_delay)
        self.delay = delay
        self.batch = batch
        self.scheduler = scheduler
        self.check_every = int(check_every)
        # sync keeps markers in the split planes; exact needs the unified
        # ring for push-order delay draws
        self.kernel = TickKernel(
            self.topo, self.config, delay, self.device,
            marker_mode="split" if scheduler == "sync" else "ring",
            exact_impl=exact_impl, faults=faults, quarantine=quarantine,
            megatick=megatick)
        self.megatick = self.kernel.megatick
        self.fused = self.kernel.fused
        self.fused_reason = self.kernel.fused_reason
        self.faults = faults
        self.quarantine = bool(quarantine)
        self._tokens0_total = int(self.topo.tokens0.sum())
        self._node_ids = torch.arange(self.topo.n, dtype=torch.int32,
                                      device=self.device)

    @property
    def fused_tile(self) -> str:
        """The fused megatick's layout on the card, the kernel's: "on"
        tiled into device memory, "off" resident or no kernel."""
        return self.kernel.fused_tile

    @property
    def fused_tile_reason(self) -> str:
        return self.kernel.fused_tile_reason

    def init_batch_device(self) -> DenseState:
        """A fresh batched state, built on the runner's device (with the
        adversary's per-lane keys when faults are armed)."""
        s = init_state(self.topo, self.config, self.batch, self.delay,
                       self.device)
        if self.faults is not None:
            s = s._replace(fault_key=self.faults.init_batch_state(
                self.batch, self.device))
        return s

    def storm_phase(self, s: DenseState, amounts, snaps,
                    lanes=None) -> DenseState:
        """One storm phase: bulk sends ``amounts`` [E], snapshot
        initiations at the nodes in ``snaps`` [J] (-1 = none), one tick,
        on the lanes of ``lanes`` [B] (None = every lane; the exact
        scheduler's quarantine gate passes the unpoisoned ones). The exact
        scheduler starts one snapshot at a time, in schedule order; the
        program is shared by every lane, so which entries fire is a host
        fact."""
        s = self.kernel._bulk_send(s, amounts, lanes)
        if self.scheduler == "exact":
            for node in np.asarray(snaps).tolist():
                if node >= 0:
                    s = self.kernel._inject_snapshot(s, node, lanes)
            return self.kernel._exact_tick(s, lanes)
        init_mask = (self._node_ids.unsqueeze(0)
                     == snaps.unsqueeze(-1)).any(0)
        s = self.kernel._bulk_snapshots(s, init_mask)
        return self.kernel._sync_tick(s)

    def _check_conservation(self, s: DenseState) -> DenseState:
        delta = (lane_total_tokens(s, self.config) - self._tokens0_total
                 - s.fault_skew)
        return s._replace(error=s.error | (delta != 0).to(torch.int32)
                          * ERR_CONSERVATION)

    @staticmethod
    def _own(state: DenseState) -> DenseState:
        """A private copy of the state: the ticks write some leaves in
        place (ops/tick.py), and the caller keeps its state."""
        return DenseState(*(tuple(w.clone() for w in leaf)
                            if isinstance(leaf, tuple) else leaf.clone()
                            for leaf in state))

    def _gated_phase(self, s: DenseState, amounts, snaps) -> DenseState:
        """A storm phase behind the quarantine gate: a lane with error
        bits at the phase's start sits the whole phase out, its state
        (delay stream included) untouched (the JAX ``_quarantine_gate``).
        Without quarantine, every lane runs the phase."""
        if not self.quarantine:
            return self.storm_phase(s, amounts, snaps)
        ok = s.error == 0
        live = int(ok.sum())
        if not live:
            return s
        return self.storm_phase(s, amounts, snaps,
                                None if live == self.batch else ok)

    def _run_storm_phases(self, s: DenseState, program) -> DenseState:
        amounts = torch.as_tensor(np.asarray(program[0]), dtype=torch.int32,
                                  device=self.device)
        snap = np.asarray(program[1], dtype=np.int32)
        if self.scheduler == "sync":
            snap = torch.as_tensor(snap, device=self.device)
        k = self.check_every
        for ph in range(amounts.shape[0]):
            s = self._gated_phase(s, amounts[ph], snap[ph])
            if k and (ph + 1) % k == 0:
                s = self._check_conservation(s)
        return self._check_conservation(s) if k else s

    def run_storm(self, state: DenseState, program,
                  drain: bool = True) -> DenseState:
        """Execute a StormProgram over all lanes (bulk sends + scheduled
        snapshot initiations + one tick per phase), then drain and flush
        unless ``drain=False``. ``state`` is left as it was."""
        s = self._run_storm_phases(self._own(state), program)
        return self._drain_owned(s) if drain else s

    def drain(self, state: DenseState) -> DenseState:
        """Drain + flush every lane (and the final conservation check when
        check_every is on): the tail of a storm run in chunks. ``state``
        is left as it was."""
        return self._drain_owned(self._own(state))

    def _drain_owned(self, s: DenseState) -> DenseState:
        drain = (self.kernel._drain_and_flush if self.scheduler == "exact"
                 else self.kernel._sync_drain_and_flush)
        s = drain(s)
        return self._check_conservation(s) if self.check_every else s

    @staticmethod
    def summarize(state: DenseState, runner=None) -> dict:
        """The JAX ``summarize`` counters of a batched state; given the
        ``runner`` that ran it, also its ``megatick``, ``fused_tick`` (the
        kernel's ``fused``: "on" or "off"), ``fused_reason``,
        ``fused_tile`` (the layout: "on" tiled, "off" resident) and
        ``fused_tile_reason``."""
        bits = int(or_reduce(state.error))
        fc = state.fault_counts.sum(0).tolist()
        n = state.has_local.shape[-1]
        k = state.tr_meta.shape[-1]
        count = state.tr_count.to(torch.int64)
        out = {
            "instances": int(state.time.shape[0]),
            "total_ticks": int(state.time.sum()),
            "max_time": int(state.time.max()),
            "straggler_waste": round(float(straggler_waste(state)), 4),
            "error_lanes": int((state.error != 0).sum()),
            "error_bits": bits,
            "errors_decoded": decode_error_bits(bits),
            "snapshots_started": int(state.started.sum()),
            "snapshots_completed": int(
                (state.started & (state.completed >= n)).sum()),
            "total_tokens_resident": int(state.tokens.sum()),
            "fault_events": {"drops": fc[0], "dups": fc[1],
                             "jitters": fc[2], "crashes": fc[3],
                             "marker_drops": fc[4], "marker_dups": fc[5],
                             "marker_jitters": fc[6]},
            "fault_skew": int(state.fault_skew.sum()),
            "trace_events": int(torch.clamp(count, max=k).sum()),
            "trace_dropped": int(torch.clamp(count - k, min=0).sum()),
            "snapshot_lifecycle": {
                key: int(v) for key, v in snapshot_lifecycle(
                    state, n).items()},
        }
        if runner is not None:
            out.update(megatick=runner.megatick, fused_tick=runner.fused,
                       fused_reason=runner.fused_reason,
                       fused_tile=runner.fused_tile,
                       fused_tile_reason=runner.fused_tile_reason)
        return out
