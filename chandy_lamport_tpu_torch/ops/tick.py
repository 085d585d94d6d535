"""The tick kernels and their storm primitives, batched.

The port of the JAX package's ``ops/tick.TickKernel`` in both channel
representations: ``marker_mode="split"`` carries the sync scheduler (the
synchronous tick ``_sync_tick`` and the bulk snapshot injector), and
``marker_mode="ring"`` the bit-exact scheduler (the cascade tick
``_cascade_tick``, the wave tick ``_wave_tick`` and the reference-literal
fold ``_fold_tick``, the scalar event injectors, the multi-tick loop and
the drain). The JAX kernel is
written for one instance and ``vmap``ped; here every state leaf carries
a leading lane axis ``B`` and every function works on the whole batch
at once. Where the JAX code branches
per lane (``lax.cond`` and ``lax.while_loop`` under ``vmap``), the port
carries a per-lane mask: a lane that takes no branch, or whose loop has
ended, is left exactly as it was.

The Pallas kernels the JAX ticks reach go through the port's kernel
wrappers (``kernels/segment.py``, ``kernels/queue.py``), which run the
hand-written CUDA kernels on a CUDA state and their plain PyTorch versions
on a CPU state.

``megatick`` K > 1 runs the exact multi-tick loop and the drain in
K-tick megaticks (the JAX ``_run_ticks`` and ``_drain_and_flush_with`` at
megatick K): through the fused megatick kernel (``kernels/megatick.py``)
on the card, through its plain form on the CPU; the results equal
megatick 1 leaf for leaf, under the fault adversary and the snapshot
supervisor too (the kernel hashes the fault masks and runs the
supervisor inside the step).

``trace`` (utils/tracing.Trace) arms the flight recorder: every recorder
site of the JAX ticks on a ported tick form appends its events to the
lane's ring, in the JAX order (``utils/tracing.py``); with ``trace=None``
or ``cfg.trace_capacity == 0`` no site runs.

Every tick form carries quarantine (a lane with error bits stops
ticking), and every one but the fold the fault adversary (``faults``,
models/faults.py) and the snapshot supervisor (``cfg.snapshot_timeout``
/ ``snapshot_every``), as the JAX ticks do; with all three off they run exactly the
fault-free code (no hook is called). JAX freezes a lane with
``lax.cond`` under ``vmap``, which computes both branches and selects;
since the port writes some leaves in place, the lane mask ``active``
reaches every in-place effect: restarts and their counts, the
supervisor's scan, re-initiation and daemon, the gates, the duplicate
appends, the bulk sends and injections, and every delay draw. The sync
tick computes its functional leaves for every lane and selects the
inactive lanes back (``_sync_tick_lanes``); its in-place effects (the
fault counts, the duplicates' appends, the recorder) take ``active``.

The JAX state is immutable; here some writes are in place, so callers
hand the kernel a state they own: ``_append_rows`` and the ring-mode
``_broadcast_markers`` write the ring planes, ``q_len``, ``tok_pushed``
and the error word in one launch (kernels/queue.py), and the ring-mode
handlers write single cells of the [B, S, N] / [B, S, E] planes, the
rings and the node balances per lane instead of rebuilding whole planes
once per marker. Every call site owns what it passes: the runners clone
the caller's state once at entry (``BatchedRunner._own``) and
``DenseSim`` holds its one state; within a run each leaf flows from one
step to the next, and no step keeps an older state to select lanes back
from (the sync tick's ``select_lanes`` follows only appends masked to its
active lanes, the stream's ``reset_lanes`` returns fresh tensors and its
harvest is copied into the results ring before the lanes append again).
"""

from __future__ import annotations

import numpy as np
import torch

from chandy_lamport_tpu_torch.config import ENGINE_KNOBS, SimConfig
from chandy_lamport_tpu_torch.core.state import (
    ERR_FAULT_UNRECOVERED,
    ERR_QUEUE_OVERFLOW,
    ERR_RECORD_OVERFLOW,
    ERR_SNAPSHOT_OVERFLOW,
    ERR_SNAPSHOT_TIMEOUT,
    ERR_TICK_LIMIT,
    ERR_TOKEN_UNDERFLOW,
    ERR_VALUE_OVERFLOW,
    F32_EXACT_LIMIT,
    FC_CRASH,
    FC_DROP,
    FC_DUP,
    FC_JITTER,
    FC_MDROP,
    FC_MDUP,
    FC_MJITTER,
    INT32_MAX,
    RTIME_PACK_LIMIT,
    DenseState,
    DenseTopology,
    marker_data_epoch,
    marker_data_sid,
    pack_marker_data,
    pack_meta,
    window_dtype,
)
from chandy_lamport_tpu_torch.kernels import megatick as k_megatick
from chandy_lamport_tpu_torch.kernels import queue as k_queue
from chandy_lamport_tpu_torch.kernels import segment as k_segment
from chandy_lamport_tpu_torch.ops.delay import select_words
from chandy_lamport_tpu_torch.utils.tracing import (
    EV_FAULT,
    EV_MRECV,
    EV_MSEND,
    EV_RECV,
    EV_SEND,
    EV_SNAP_END,
    EV_SNAP_START,
    EV_SUP_ABORT,
    EV_SUP_FAIL,
    EV_SUP_RETRY,
    trace_append_many,
    trace_append_one,
)

_i32 = torch.int32
# the clock a frozen lane shows the delivery selection: every slot word's
# rtime (meta >> 1) is >= -2^30, so nothing is eligible at this time
_FROZEN_TIME = -(2**31)


# the JAX reduce_mode="auto" threshold: the largest [N, E] incidence
# matrix its matmul formulation keeps (ops/tick.py MATMUL_MAX_ELEMS), and
# the degree bound under which its bfloat16 counts are exact
MATMUL_MAX_ELEMS = 32 * 2**20
BF16_EXACT_COUNT = 256


def _knob(name: str, value) -> str:
    """An engine knob's value, checked against its JAX spellings."""
    if value not in ENGINE_KNOBS[name]:
        raise ValueError(f"unknown {name} {value!r}")
    return value


def resolve_knobs(topo: DenseTopology, cfg: SimConfig, device,
                  queue_engine: str = "auto",
                  kernel_engine=None) -> dict:
    """What the port runs for each JAX engine knob, as ``{knob: (value,
    reason)}``. The JAX package has two engines for some of its work and
    pins them equal in result (``tests/test_pallas_kernels.py``,
    ``test_queue_engine.py``); the port has one, so every spelling is
    accepted and resolves to it, and the reason says what ran:
    ``kernel_engine`` (None defers to ``cfg.kernel_engine``) to the
    port's kernels, CUDA on the card and their plain versions on the CPU;
    ``queue_engine`` to the ring kernels' gathers and scatters (rows 4-7,
    the JAX "gather"); ``reduce_mode`` and ``count_dtype`` to the segment
    kernels' integer sums (rows 1-3, the JAX "segsum"). Where the JAX
    package refuses (a forced bfloat16 count past its exact degree bound,
    on the matmul formulation its "auto" picks) the port raises the same
    ValueError. ``comm_engine`` is the graph-sharded runner's, which
    resolves it by ``resolve_comm_engine`` (parallel/graphshard.py); the
    batched ticks exchange nothing between shards and keep its
    spelling."""
    kernel_engine = _knob("kernel_engine", cfg.kernel_engine
                          if kernel_engine is None else kernel_engine)
    queue_engine = _knob("queue_engine", queue_engine)
    mode = cfg.reduce_mode
    if mode == "auto":
        mode = "matmul" if topo.n * topo.e <= MATMUL_MAX_ELEMS else "segsum"
    degree = max(int(topo.in_degree.max()) if topo.e else 0, topo.d)
    if (mode == "matmul" and cfg.count_dtype == "bfloat16"
            and degree > BF16_EXACT_COUNT):
        raise ValueError(f"count_dtype=bfloat16 is not exact: degree bound "
                         f"{degree} > {BF16_EXACT_COUNT}")
    engine = ("cuda", "its CUDA kernels on the card") \
        if torch.device(device).type == "cuda" \
        else ("plain", "its kernels' plain versions on the CPU")
    return {
        "kernel_engine": (engine[0], (
            f"kernel_engine={kernel_engine!r}: the port has one engine, "
            f"{engine[1]}")),
        "queue_engine": ("gather", (
            f"queue_engine={queue_engine!r}: the ring kernels gather the "
            "heads and scatter the appends (rows 4-7); 'mask' is equal in "
            "result in JAX")),
        "reduce_mode": ("segsum", (
            f"reduce_mode={cfg.reduce_mode!r}: the segment kernels' "
            "integer sums (rows 1-3); 'matmul' is equal in result in JAX")),
        "count_dtype": ("int32", (
            f"count_dtype={cfg.count_dtype!r}: the segment sums count in "
            "int32, exactly")),
        "comm_engine": (cfg.comm_engine, (
            f"comm_engine={cfg.comm_engine!r}: the graph-sharded runner's "
            "cross-shard exchange, resolved there (resolve_comm_engine, "
            "parallel/graphshard.py); a batched tick exchanges nothing")),
    }


def resolve_comm_engine(engine: str) -> str:
    """The graph-sharded runner's cross-shard traffic knob (the JAX
    ``resolve_comm_engine``): "dense" sums whole [S+1, N] planes across
    the shards and gathers the created flags; "sparse" moves only the
    boundary rows, one exchange per ring distance. "auto" resolves to
    "sparse" everywhere (its bytes scale with the cut,
    ``utils/metrics.comm_bytes_model``); both are equal in result."""
    if engine not in ENGINE_KNOBS["comm_engine"]:
        raise ValueError(f"unknown comm_engine {engine!r}")
    return "sparse" if engine == "auto" else engine


def merge_keymult(max_snapshots: int) -> int:
    """Split-mode FIFO merge-key multiplier: m_key = tok_before * KEYMULT +
    marker_ord, KEYMULT the next power of two above S (floor 16)."""
    return 1 << max(4, max_snapshots.bit_length())


def merge_key_limit(max_snapshots: int) -> int:
    """Largest tok_pushed for which a merge key fits int32."""
    return (1 << 31) // merge_keymult(max_snapshots) - 1


def _flag(cond, bit: int):
    """``bit`` where ``cond`` ([B] bool) holds, else 0, as int32."""
    return cond.to(_i32) * bit


def log_append_masked(log_amt, rec_cnt, min_prot, app_e, amt_e,
                      rec_dtype, rec_limit, log_slots: int):
    """Append ``amt_e[b, e]`` to edge e's ring log where ``app_e``.
    Returns (log_amt, rec_cnt, err_bits [B])."""
    pos_e = rec_cnt % log_slots                      # rec_cnt >= 0
    ll = torch.arange(log_slots, dtype=_i32, device=rec_cnt.device)
    new_cnt = rec_cnt + app_e.to(_i32)
    err = (_flag((app_e & (new_cnt - min_prot > log_slots)).any(-1),
                 ERR_RECORD_OVERFLOW)
           | _flag((app_e & (amt_e > rec_limit)).any(-1),
                   ERR_VALUE_OVERFLOW))
    hit = app_e.unsqueeze(-2) & (ll[:, None] == pos_e.unsqueeze(-2))
    log_amt = torch.where(hit, amt_e.unsqueeze(-2).to(rec_dtype), log_amt)
    return log_amt, new_cnt, err


def log_append(log_amt, rec_cnt, min_prot, recording, tok_e, amt_e,
               rec_dtype, rec_limit, log_slots: int):
    """The sync tick's shared-log append: edges that delivered a token
    while any slot records them."""
    return log_append_masked(log_amt, rec_cnt, min_prot,
                             tok_e & recording.any(-2), amt_e,
                             rec_dtype, rec_limit, log_slots)


def window_update(s: DenseState, started_se, stopped_se, rec_cnt) -> dict:
    """Open/close recording windows at the (post-append) counter; returns
    the changed fields for ``state._replace``."""
    cnt_b = rec_cnt.unsqueeze(-2).to(s.rec_start.dtype)
    out = dict(
        rec_start=torch.where(started_se, cnt_b, s.rec_start),
        min_prot=torch.where(started_se.any(-2),
                             torch.minimum(s.min_prot, rec_cnt), s.min_prot),
    )
    if stopped_se is not None:
        out.update(rec_end=torch.where(stopped_se, cnt_b, s.rec_end))
    return out


def select_lanes(mask, new: DenseState, old: DenseState) -> DenseState:
    """Per-lane ``where(mask, new, old)`` over every leaf (mask [B])."""
    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                           a, b)

    fields = {}
    for name, a, b in zip(DenseState._fields, new, old):
        if isinstance(a, tuple):
            fields[name] = tuple(pick(x, y) for x, y in zip(a, b))
        else:
            fields[name] = pick(a, b)
    return DenseState(**fields)


class TickKernel:
    """The ticks over a fixed (topology, config, delay sampler), with the
    topology tables on ``device``. ``marker_mode`` is the JAX kernel's:
    "split" (the sync scheduler: tokens in the rings, markers in the
    [S, E] pending planes; the sync entry points) or "ring" (the exact
    scheduler: tokens and markers share the rings in push order; the
    exact entry points). ``exact_impl`` picks the exact formulation,
    "cascade", "wave" or "fold" (``self._exact_tick``); a ring-mode
    kernel refuses "wave" with a sampler whose draws are order-dependent,
    and "fold" under the adversary or the supervisor (ValueError, as the
    JAX kernel does: the fold is the uninjured specification form).

    ``faults`` (models/faults.Faults or None) arms the fault adversary,
    the config's ``snapshot_timeout``/``snapshot_every`` the snapshot
    supervisor, and ``quarantine`` freezes a lane once its error bits
    fire (module docstring), in both marker modes. ``trace``
    (utils/tracing.Trace or None) arms the flight recorder when the
    config gives the ring slots (``cfg.trace_capacity > 0``).

    ``megatick`` (K) is the JAX kernel's, for the exact scheduler only:
    ``kernels/megatick.resolve_fused`` sets ``self.fused``,
    ``self.fused_reason`` and the layout of the fused megatick on the
    card, ``self.fused_tile`` and ``self.fused_tile_reason``, once here,
    before any table moves to the device. At K > 1 the megaticks launch
    the fused kernel on the card, resident in shared memory or, for a
    lane past a block's share, tiled into a device-memory workspace
    (``self.fused_workspace``), or the constructor raises; on the CPU they
    run its plain form. ``fused_tick`` and ``fused_tile`` (None defers to
    the config's) are the JAX knobs: "off" runs the megaticks as K single
    ticks of the split kernels, "on" raises naming every unmet
    requirement (``resolve_fused``); the fold has no fused form and runs K
    single ticks. ``queue_engine``, ``kernel_engine`` and the config's
    ``reduce_mode``/``count_dtype``/``comm_engine`` resolve by
    ``resolve_knobs`` (``self.<knob>`` and ``self.<knob>_reason``).
    ``fused_block_edges``, the TPU kernel's fault-plane DMA block width,
    is accepted and moves nothing: the card hashes the fault masks in
    place and has no blocks to size (``self.fused_block_edges_reason``)."""

    def __init__(self, topo: DenseTopology, cfg: SimConfig, delay,
                 marker_mode: str = "ring", exact_impl: str = "cascade",
                 megatick: int = 1, *, device, faults=None,
                 quarantine: bool = False, trace=None,
                 queue_engine: str = "auto", kernel_engine=None,
                 fused_tick=None, fused_block_edges: int = 0,
                 fused_tile=None):
        if marker_mode not in ("ring", "split"):
            raise ValueError(f"unknown marker_mode {marker_mode!r}")
        if exact_impl not in ("cascade", "wave", "fold"):
            raise ValueError(f"unknown exact_impl {exact_impl!r}")
        if (faults is not None and marker_mode == "ring"
                and exact_impl == "fold"):
            raise ValueError(
                "exact_impl='fold' is the reference-literal specification "
                "form and runs uninjured; use cascade/wave (or the sync "
                "scheduler) for fault injection")
        if (marker_mode == "ring" and exact_impl == "fold"
                and (cfg.snapshot_timeout > 0 or cfg.snapshot_every > 0)):
            raise ValueError(
                "exact_impl='fold' is the reference-literal specification "
                "form and carries no snapshot supervisor; use cascade/wave "
                "(or the sync scheduler) with snapshot_timeout/"
                "snapshot_every")
        if fused_block_edges < 0:
            raise ValueError("fused_block_edges must be >= 0 (0 = the "
                             "default)")
        # only the ring representation runs the exact tick: a split-mode
        # kernel is not refused over a formulation it never executes
        if (marker_mode == "ring" and exact_impl == "wave"
                and not delay.position_streams):
            raise ValueError(
                "exact_impl='wave' serves the tick's delay draws at their "
                "fold-order stream positions, which needs a "
                "position-addressable sampler; "
                f"{type(delay).__name__} draws are order-dependent: use "
                "FixedDelay or HashDelay (or exact_impl='cascade')")
        self._sup = bool(cfg.snapshot_timeout > 0 or cfg.snapshot_every > 0)
        if megatick < 1:
            raise ValueError(f"megatick must be >= 1, got {megatick}")
        if megatick > 1 and marker_mode == "split":
            raise ValueError(
                f"megatick={megatick}: the megatick is the exact "
                "scheduler's (as in JAX); the sync scheduler ticks one at "
                "a time, so run it at megatick=1")
        self.faults = faults
        self.quarantine = bool(quarantine)
        self.marker_mode = marker_mode
        self.topo, self.cfg, self.delay = topo, cfg, delay
        self.device = torch.device(device)
        self.megatick = int(megatick)
        self.exact_impl = exact_impl
        self._exact_tick = {"cascade": self._cascade_tick,
                            "wave": self._wave_tick,
                            "fold": self._fold_tick}[exact_impl]
        # no recorder site runs unless armed AND the ring has slots
        self._trace_on = trace is not None and cfg.trace_capacity > 0
        for knob, (value, why) in resolve_knobs(
                topo, cfg, self.device, queue_engine,
                kernel_engine).items():
            setattr(self, knob, value)
            setattr(self, f"{knob}_reason", why)
        self.fused_block_edges = int(fused_block_edges)
        self.fused_block_edges_reason = (
            f"fused_block_edges={self.fused_block_edges}: the TPU kernel's "
            "fault-plane DMA block width; the card hashes each step's "
            "fault masks in place, so nothing moves")
        (self.fused, self.fused_reason, self.fused_tile,
         self.fused_tile_reason) = k_megatick.resolve_fused(
            megatick=self.megatick, device=self.device,
            smem_bytes=k_megatick.fused_smem_bytes(
                topo.n, topo.e, cfg.max_snapshots,
                fault_arm=k_megatick.fault_arm(self),
                wave=k_megatick.wave_arm(self),
                trace=self._trace_on,
                go_exact=not delay.position_streams),
            fused_tick=_knob("fused_tick", cfg.fused_tick
                             if fused_tick is None else fused_tick),
            fused_tile=_knob("fused_tile", cfg.fused_tile
                             if fused_tile is None else fused_tile),
            marker_mode=marker_mode, exact_impl=exact_impl)
        if (self.fused == "on" and k_megatick.wave_arm(self)
                and self._trace_on):
            k_megatick.check_wave_degree(topo.in_degree)
        self.fused_workspace = None     # the tiled layout's, at first launch
        # sequential host steps of the exact tick so far (the cascade's
        # marker-fold steps, the wave's waves: one per batched step,
        # whatever the number of lanes it serves), and those of them run
        # in drains and flushes; the fused megatick steps inside its
        # kernel and counts none
        self.fold_steps = 0
        self.drain_fold_steps = 0
        self._keymult = merge_keymult(cfg.max_snapshots)
        self._key_limit = merge_key_limit(cfg.max_snapshots)

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=_i32,
                                   device=self.device).contiguous()

        n = topo.n
        self._src_bounds_host = np.concatenate(
            [[0], np.cumsum(np.bincount(topo.edge_src, minlength=n))])
        self._edge_src = t(topo.edge_src)
        self._edge_dst = t(topo.edge_dst)
        self._in_degree = t(topo.in_degree)
        # first outbound edge of each edge's source (edges are src-sorted)
        self._src_first = t(np.searchsorted(topo.edge_src, topo.edge_src,
                                            side="left"))
        self._by_dst = t(topo.by_dst)
        self._dst_lo = t(topo.dst_bounds[:-1])
        self._dst_hi = t(topo.dst_bounds[1:])
        src_bounds = self._src_bounds_host
        self._src_lo = t(src_bounds[:-1])
        self._src_hi = t(src_bounds[1:])
        self._edge_table = t(topo.edge_table)          # [N, D], -1 padded
        # each node's out-degree, and the ordinals 0..D-1 of a broadcast's
        # draws (its out-edges are src_lo + k, in dest order)
        self._outdeg_n = self._src_hi - self._src_lo
        self._ord_d = torch.arange(topo.d, dtype=_i32, device=self.device)
        # the wave tick's schedule tables (the JAX ops/tick.py:504-517):
        # the inverse of the by_dst permutation, each by_dst position's
        # segment start, each edge's ordinal among its source's out-edges,
        # and each edge's destination out-degree (its broadcast's draws)
        self._inv_by_dst = t(np.argsort(topo.by_dst, kind="stable"))
        self._pos_seg_start = t(
            topo.dst_bounds[:-1][topo.edge_dst[topo.by_dst]])
        self._edge_ord_in_src = t(np.arange(topo.e)
                                  - src_bounds[:-1][topo.edge_src])
        self._outdeg_dst_e = t((src_bounds[1:] - src_bounds[:-1])
                               [topo.edge_dst])
        self._rows_e = torch.arange(topo.e, dtype=_i32, device=self.device)
        self._node_ids = torch.arange(n, dtype=_i32, device=self.device)
        self._slot_ids = torch.arange(cfg.max_snapshots, dtype=_i32,
                                      device=self.device)
        self._rec_dtype = getattr(torch, cfg.record_dtype)
        self._rec_limit = torch.iinfo(self._rec_dtype).max
        self._win_dtype = window_dtype(cfg)

    # ---- kernel-backed primitives ------------------------------------------

    def _sum_by_dst(self, x_e):
        """Per-destination-node sums of a per-edge quantity (int32)."""
        return k_segment.sum_by_perm(x_e, self._by_dst, self._dst_lo,
                                     self._dst_hi)

    def _sum_by_src(self, x_e):
        """Per-source-node sums (edges are already src-sorted)."""
        return k_segment.sum_segments(x_e, self._src_lo, self._src_hi)

    def _spread_dst(self, x_n):
        """[..., N] -> [..., E]: a node flag on its inbound edges."""
        return k_segment.spread(x_n, self._edge_dst)

    def _spread_src(self, x_n):
        """[..., N] -> [..., E]: a node flag on its outbound edges."""
        return k_segment.spread(x_n, self._edge_src)

    def _seg_excl(self, x_e):
        """Per-destination exclusive running sums of an ``[..., E]`` int32
        operand in edge order, in edge order: the operand permuted into
        by_dst order, one cumsum rebased at each segment's start, and
        permuted back (the JAX ``_seg_excl`` with its two takes)."""
        x_d = x_e.index_select(-1, self._by_dst)
        cs0 = torch.cumsum(x_d, dim=-1, dtype=_i32) - x_d
        return (cs0 - cs0.index_select(-1, self._pos_seg_start)
                ).index_select(-1, self._inv_by_dst)

    def _head_fields(self, s: DenseState):
        """Every ring head's (rtime, is_marker, data), [B, E]."""
        return k_queue.head_fields(s.q_meta, s.q_data, s.q_head)

    def _append_rows(self, s: DenseState, active, rt_e, mk_e,
                     data_e) -> DenseState:
        """One message on every edge where ``active`` [B, E], receive
        times ``rt_e`` [B, E] already drawn, marker bit ``mk_e`` (a bool
        for the whole row, or a [B, E] mask): one launch writes the ring
        planes, q_len, tok_pushed and the error word of ``s`` in place
        (module docstring). The [B, E] operands may be expanded views."""
        q_meta, q_data, q_len, pushed, error = k_queue.append_rows(
            s.q_meta, s.q_data, s.q_head, s.q_len, s.tok_pushed, s.error,
            active, rt_e, mk_e, data_e, capacity=self.cfg.queue_capacity,
            key_limit=self._key_limit)
        return s._replace(q_meta=q_meta, q_data=q_data, q_len=q_len,
                          tok_pushed=pushed, error=error)

    # ---- storm injectors ----------------------------------------------------

    def _bulk_push(self, s: DenseState, active, is_marker: bool,
                   data, lanes=None) -> DenseState:
        """Enqueue one message on every edge where ``active`` [B, E]; one
        vectorized delay draw per (lane, edge), inactive draws discarded.
        Lanes outside ``lanes`` [B] (None = all) draw nothing."""
        rts, dstate = self.delay.draw_many(s.delay_state, s.time,
                                           self.topo.e)
        if lanes is not None:
            dstate = select_words(lanes, dstate, s.delay_state)
        s = s._replace(delay_state=dstate)
        return self._append_rows(s, active, rts, is_marker, data)

    def _bulk_send(self, s: DenseState, amounts, lanes=None) -> DenseState:
        """One token message per edge with ``amounts[e] > 0`` ([E], shared
        by every lane), debiting each sender at send time, on the lanes of
        ``lanes`` [B] (None = all)."""
        b = s.time.shape[0]
        debits = self._sum_by_src(amounts)                    # [N]
        active = (amounts > 0).expand(b, -1)
        if lanes is None:
            tokens = s.tokens - debits
            under = (tokens < 0).any(-1)
        else:
            tokens = s.tokens - torch.where(lanes.unsqueeze(-1), debits, 0)
            under = lanes & (tokens < 0).any(-1)
            active = active & lanes.unsqueeze(-1)
        s = s._replace(tokens=tokens, error=s.error | _flag(
            under, ERR_TOKEN_UNDERFLOW))
        if self._trace_on:
            s = trace_append_many(s, active, EV_SEND, self._rows_e, amounts)
        return self._bulk_push(s, active, False, amounts.expand(b, -1),
                               lanes)

    def _push_markers_split(self, s: DenseState, push_se,
                            lanes=None) -> DenseState:
        """Marker multi-push into the [B, S, E] pending planes; merge keys
        allocated in slot order on each edge. Lanes outside ``lanes`` [B]
        (None = all; ``push_se`` must be empty there) draw nothing."""
        S = self.cfg.max_snapshots
        rts_se, dstate = self.delay.draw_many(s.delay_state, s.time,
                                              (S, self.topo.e))
        if lanes is not None:
            dstate = select_words(lanes, dstate, s.delay_state)
        push_i = push_se.to(_i32)
        off_se = torch.cumsum(push_i, dim=-2, dtype=_i32) - push_i
        k_e = push_i.sum(-2, dtype=_i32)
        key_se = (s.tok_pushed * self._keymult + s.mk_cnt).unsqueeze(-2) \
            + off_se
        s = s._replace(
            m_pending=s.m_pending | push_se,
            m_rtime=torch.where(push_se, rts_se, s.m_rtime),
            m_key=torch.where(push_se, key_se, s.m_key),
            mk_cnt=s.mk_cnt + k_e,
            delay_state=dstate,
        )
        if self._trace_on:
            s = trace_append_many(s, push_se, EV_MSEND, self._rows_e,
                                  self._slot_ids[:, None])
        return s

    def _create_and_broadcast(self, s: DenseState, created,
                              lanes=None) -> DenseState:
        """CreateLocalSnapshot + marker broadcast for every True (lane,
        slot, node) of ``created`` [B, S, N]; lanes outside ``lanes`` [B]
        (None = all; ``created`` must be empty there) draw nothing."""
        created_dst_se = self._spread_dst(created)
        s = s._replace(
            recording=s.recording | created_dst_se,
            frozen=torch.where(created, s.tokens.unsqueeze(-2), s.frozen),
            rem=torch.where(created, self._in_degree, s.rem),
            has_local=s.has_local | created,
            **window_update(s, created_dst_se, None, s.rec_cnt),
        )
        return self._push_markers_split(s, self._spread_src(created), lanes)

    def _bulk_snapshots(self, s: DenseState, init_mask,
                        lanes=None) -> DenseState:
        """Start a snapshot at every node of ``init_mask`` ([N], shared by
        every lane, or [B, N], one row per lane), ids allocated in
        node-index order from next_sid, on the lanes of ``lanes`` [B]
        (None = all; the others are left as they were, their delay stream
        included). Under the supervisor, remember each slot's initiator
        and arm its first deadline (the JAX ``_bulk_snapshots``)."""
        S = self.cfg.max_snapshots
        init_mask = init_mask.expand(s.time.shape[0], self.topo.n)
        if lanes is not None:
            init_mask = init_mask & lanes.unsqueeze(-1)
        count = init_mask.sum(-1, dtype=_i32)                   # [B]
        rank = torch.cumsum(init_mask.to(_i32), dim=-1, dtype=_i32) - 1
        sid_n = s.next_sid.unsqueeze(-1) + rank                 # [B, N]
        created = init_mask.unsqueeze(-2) & (
            sid_n.unsqueeze(-2) == self._slot_ids[:, None])     # [B, S, N]
        over = s.next_sid + count > S
        if lanes is not None:
            over = over & lanes
        s = s._replace(
            next_sid=s.next_sid + count,
            started=s.started | created.any(-1),
            error=s.error | _flag(over, ERR_SNAPSHOT_OVERFLOW),
        )
        if self._sup:
            any_c = created.any(-1)                              # [B, S]
            # the first True node of each slot (argmax over bools)
            init_n = torch.where(created, self._node_ids,
                                 self.topo.n).amin(-1).clamp(
                                     max=self.topo.n - 1).to(_i32)
            s = s._replace(snap_initiator=torch.where(
                any_c, init_n, s.snap_initiator))
            if self.cfg.snapshot_timeout:
                s = s._replace(snap_deadline=torch.where(
                    any_c, s.time.unsqueeze(-1) + self.cfg.snapshot_timeout,
                    s.snap_deadline))
        if self._trace_on:
            s = trace_append_many(s, init_mask, EV_SNAP_START,
                                  self._node_ids, sid_n)
        return self._create_and_broadcast(s, created, lanes)

    # ---- the synchronous tick ----------------------------------------------

    def _stamp_done(self, s: DenseState, active=None) -> DenseState:
        """Record each snapshot's completion tick, once (on the lanes of
        ``active`` [B] only, when given)."""
        newly = (s.started & (s.completed >= self.topo.n)
                 & (s.snap_done_time < 0))
        if active is not None:
            newly = newly & active.unsqueeze(-1)
        return s._replace(snap_done_time=torch.where(
            newly, s.time.unsqueeze(-1), s.snap_done_time))

    def _sync_tick(self, s: DenseState, active=None) -> DenseState:
        """Every source delivers its first eligible channel front at once,
        all tokens before all markers (the JAX ``_sync_tick`` docstring).

        Under faults and the supervisor, in the JAX order: the crash
        restarts and the supervisor step at tick start, the jitter and
        crash gates on the eligibility, the drop/dup split of the popped
        tokens, the duplicated tokens re-appended after the log append,
        the marker drop/dup split of the consumed fronts, windows closed
        only where a channel still records (``closed_sn``; a duplicated
        marker may find its channel closed), and the duplicated markers
        re-armed in the pending planes with a fresh merge key.

        ``active`` [B] (None = every lane): the lanes that tick. This
        function computes every lane and ``_sync_tick_lanes`` selects the
        others back; ``active`` keeps its in-place effects (the fault
        counts, the duplicates' appends) off the other lanes."""
        C = self.cfg.queue_capacity
        faulted = self.faults is not None
        time = s.time + 1
        s = s._replace(time=time)
        if faulted:
            s = self._fault_restart(s, active)
        if self._sup:
            s = self._supervise(s, active)

        # channel fronts: ring head, or the pending marker with the
        # smallest merge key once every token pushed before it has popped
        head_rt, _, head_amt = self._head_fields(s)
        tok_live = s.q_len > 0
        tok_popped = s.tok_pushed - s.q_len
        m_key_live = torch.where(s.m_pending, s.m_key, INT32_MAX)
        m_front_key = m_key_live.amin(-2)                           # [B, E]
        m_is_front = s.m_pending & (m_key_live == m_front_key.unsqueeze(-2))
        m_front_rt = torch.where(m_is_front, s.m_rtime, 0).sum(-2, dtype=_i32)
        # keys are >= 0, so // floors as jnp's does
        front_is_marker = (m_front_key < INT32_MAX) & (
            m_front_key // self._keymult <= tok_popped)
        front_rt = torch.where(front_is_marker, m_front_rt, head_rt)
        elig_e = (tok_live | front_is_marker) & (
            front_rt <= time.unsqueeze(-1))
        if faulted:
            # the gates first (jitter stalls the merged front, the marker
            # jitter marker fronts on top, a down destination receives
            # nothing), then the drop/dup programs on what delivers
            if active is not None:
                elig_e = elig_e & active.unsqueeze(-1)
            drop_e, dup_e, jit_e, dup_rt = self._fault_edge_masks(s)
            mdrop_e, mdup_e, mjit_e, mdup_rt = self._fault_marker_masks(s)
            s, elig_e = self._fault_gate_elig(s, elig_e, jit_e, mjit_e,
                                              front_is_marker)
        # first eligible edge per source: exclusive prefix count re-based
        # at each source's first edge
        elig_i = elig_e.to(_i32)
        before = torch.cumsum(elig_i, dim=-1, dtype=_i32) - elig_i
        deliver_e = elig_e & (before == before.index_select(-1,
                                                            self._src_first))
        tok_e = deliver_e & ~front_is_marker
        mk_e = deliver_e & front_is_marker
        s = s._replace(q_head=(s.q_head + tok_e.to(_i32)) % C,
                       q_len=s.q_len - tok_e.to(_i32))
        if faulted:
            s, tok_e, dup_tok = self._fault_split_tokens(s, tok_e, head_amt,
                                                         drop_e, dup_e)

        # token deliveries: credit + shared-log append
        amt_e = torch.where(tok_e, head_amt, 0)
        credit = self._sum_by_dst(amt_e)                            # [B, N]
        toobig = ((amt_e >= F32_EXACT_LIMIT).any(-1)
                  | (credit >= F32_EXACT_LIMIT).any(-1))
        s = s._replace(tokens=s.tokens + credit,
                       error=s.error | _flag(toobig, ERR_VALUE_OVERFLOW))
        if self._trace_on:
            # all tokens before all markers is this tick's real order
            s = trace_append_many(s, tok_e, EV_RECV, self._rows_e, amt_e)
        log, cnt, err_bits = log_append(
            s.log_amt, s.rec_cnt, s.min_prot, s.recording, tok_e, amt_e,
            self._rec_dtype, self._rec_limit, self.cfg.max_recorded)
        s = s._replace(log_amt=log, rec_cnt=cnt, error=s.error | err_bits)
        if faulted:
            # duplicated tokens re-enter their ring at the tail, with
            # fault-stream receive times (tok_pushed advances, so this
            # tick's marker merge keys order after them)
            s = self._append_rows(s, dup_tok, dup_rt, False, head_amt)

        # marker deliveries, every slot at once (HandleMarker): every
        # delivering front is consumed, the dropped ones included
        s = s._replace(m_pending=s.m_pending & ~(m_is_front
                                                 & mk_e.unsqueeze(-2)))
        if faulted:
            s, mk_e, mk_dup_e = self._fault_split_markers(s, mk_e, mdrop_e,
                                                          mdup_e)
        mk_se = m_is_front & mk_e.unsqueeze(-2)                     # [B,S,E]
        if self._trace_on:
            # the consumed front's plane index is the snapshot id
            sid_e = torch.where(mk_se, self._slot_ids[:, None], 0).sum(
                -2, dtype=_i32)
            s = trace_append_many(s, mk_e, EV_MRECV, self._rows_e, sid_e)
        arrivals = self._sum_by_dst(mk_se)                          # [B,S,N]
        had = s.has_local
        created = (arrivals > 0) & ~had
        created_dst_se = self._spread_dst(created)
        stopped = mk_se & s.recording
        started_se = created_dst_se & ~mk_se
        # only live closes decrement rem under faults; without duplicates
        # every arrival at a node with its local snapshot closes a window
        closed_sn = self._sum_by_dst(stopped) if faulted else arrivals
        s = s._replace(
            recording=(s.recording | created_dst_se) & ~mk_se,
            frozen=torch.where(created, s.tokens.unsqueeze(-2), s.frozen),
            rem=torch.where(created, self._in_degree - arrivals,
                            s.rem - torch.where(had, closed_sn, 0)),
            has_local=had | created,
            **window_update(s, started_se, stopped, s.rec_cnt),
        )

        # re-broadcast from every node that just created its snapshot
        s = self._push_markers_split(s, self._spread_src(created))
        if faulted:
            # duplicated markers re-arm their pending entry with a
            # fault-stream receive time and a fresh merge key
            dup_se = m_is_front & mk_dup_e.unsqueeze(-2)            # [B,S,E]
            key_e = s.tok_pushed * self._keymult + s.mk_cnt
            s = s._replace(
                m_pending=s.m_pending | dup_se,
                m_rtime=torch.where(dup_se, mdup_rt.unsqueeze(-2),
                                    s.m_rtime),
                m_key=torch.where(dup_se, key_e.unsqueeze(-2), s.m_key),
                mk_cnt=s.mk_cnt + mk_dup_e.to(_i32))

        # finalize (node.go:165-170)
        fire = s.has_local & (s.rem == 0) & ~s.done_local
        if self._trace_on:
            s = self._trace_snap_ends(s, fire)
        return self._stamp_done(s._replace(
            done_local=s.done_local | fire,
            completed=s.completed + fire.sum(-1, dtype=_i32),
        ), active)

    # ---- ring mode: the exact scheduler ------------------------------------
    # Scalar-event arguments (an edge, a node, an amount) are host ints
    # shared by every lane, as the JAX runner's program is; per-lane
    # arguments are [B] tensors with the lane mask ``mask`` / ``active``.

    def _lanes(self, s: DenseState):
        return torch.arange(s.time.shape[0], device=self.device)

    def _lane_ints(self, s: DenseState, x):
        """A host int or a [B] tensor as an int32 [B] tensor, one value
        per lane (a script's op argument or tick count)."""
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=_i32).expand(
                s.time.shape[0])
        return torch.full_like(s.time, int(x))

    def _push(self, s: DenseState, e, is_marker: bool, data,
              mask=None) -> DenseState:
        """Append to edge ``e``'s ring with one delay draw (node.go:126-130,
        node.go:104-108), in place: ``e`` and ``data`` are host ints shared
        by every lane or [B] tensors, one per lane. A lane outside ``mask``
        [B] (None = every lane) draws nothing and is left as it was (the
        JAX ``lax.switch`` under ``vmap`` selects each lane's branch)."""
        C = self.cfg.queue_capacity
        lanes = self._lanes(s)
        e_l = self._lane_ints(s, e).long()
        data = self._lane_ints(s, data)
        rtime, dstate = self.delay.draw(s.delay_state, s.time)
        if mask is not None:
            dstate = select_words(mask, dstate, s.delay_state)
        length = s.q_len[lanes, e_l]
        pos = ((s.q_head[lanes, e_l] + length) % C).long()  # both >= 0
        bad = (_flag(length >= C, ERR_QUEUE_OVERFLOW)
               | _flag((s.tok_pushed[lanes, e_l] >= self._key_limit)
                       | (rtime >= RTIME_PACK_LIMIT), ERR_VALUE_OVERFLOW))
        meta = pack_meta(rtime, int(is_marker))
        step = 1
        if mask is not None:
            bad = torch.where(mask, bad, 0)
            slot = (lanes, e_l, pos)
            meta = torch.where(mask, meta, s.q_meta[slot])
            data = torch.where(mask, data, s.q_data[slot])
            step = mask.to(_i32)
        s.q_meta[lanes, e_l, pos] = meta
        s.q_data[lanes, e_l, pos] = data
        s.q_len[lanes, e_l] += step
        s.tok_pushed[lanes, e_l] += step
        return s._replace(delay_state=dstate, error=s.error | bad)

    def _push_marker_split(self, s: DenseState, e, sid, mask) -> DenseState:
        """The split-mode scalar marker enqueue (the JAX ``_push_marker``'s
        split arm) on edge ``e`` [B] for slot ``sid`` [B], on the lanes of
        ``mask``: one delay draw into the [S, E] pending planes, its merge
        key from the edge's token and marker counts. Lanes outside
        ``mask`` draw nothing."""
        if self._trace_on:
            s = trace_append_one(s, mask, EV_MSEND, e, sid)
        lanes = self._lanes(s)
        rtime, drawn = self.delay.draw(s.delay_state, s.time)
        e_l, sid_l = e.long(), sid.long()
        cell = (lanes, sid_l, e_l)
        key = s.tok_pushed[lanes, e_l] * self._keymult + s.mk_cnt[lanes, e_l]
        s.m_pending[cell] = s.m_pending[cell] | mask
        s.m_rtime[cell] = torch.where(mask, rtime.to(_i32), s.m_rtime[cell])
        s.m_key[cell] = torch.where(mask, key, s.m_key[cell])
        s.mk_cnt[lanes, e_l] += mask.to(_i32)
        return s._replace(delay_state=select_words(mask, drawn,
                                                   s.delay_state))

    def _create_local(self, s: DenseState, sid, node, exclude, mask,
                      cnt_extra=None) -> DenseState:
        """CreateLocalSnapshot (node.go:58-84) on the lanes of ``mask``:
        freeze the balance of ``node`` and record its inbound links except
        ``exclude`` (-1 for an initiator); ``sid``, ``node``, ``exclude``
        are [B]. ``cnt_extra`` [B, E] is the cascade's deferred appends so
        far this tick: windows open at the counter each edge WILL have
        once they land (the JAX ``_create_local`` docstring)."""
        lanes = self._lanes(s)
        sid_l, node_l = sid.long(), node.long()
        rec_mask = (mask.unsqueeze(-1)
                    & (self._edge_dst == node.unsqueeze(-1))
                    & (self._rows_e != exclude.unsqueeze(-1)))   # [B, E]
        links = self._in_degree[node_l] - (exclude >= 0).to(_i32)
        cnt = s.rec_cnt if cnt_extra is None else s.rec_cnt + cnt_extra
        cell = (lanes, sid_l, node_l)
        s.has_local[cell] = s.has_local[cell] | mask
        s.frozen[cell] = torch.where(mask, s.tokens[lanes, node_l],
                                     s.frozen[cell])
        s.rem[cell] = torch.where(mask, links, s.rem[cell])
        row = (lanes, sid_l)
        s.recording[row] = s.recording[row] | rec_mask
        s.rec_start[row] = torch.where(rec_mask, cnt.to(s.rec_start.dtype),
                                       s.rec_start[row])
        return s._replace(min_prot=torch.where(
            rec_mask, torch.minimum(s.min_prot, cnt), s.min_prot))

    def _broadcast_markers(self, s: DenseState, node, sid,
                           mask) -> DenseState:
        """SendToNeighbors (node.go:97-109) on the lanes of ``mask``: a
        marker for ``sid`` on every outbound link of ``node`` in dest
        order, one delay draw per real link. In ring mode the row is
        enqueued by one batched append: a position-addressable sampler
        serves its draws as a block at their sequential stream positions,
        the Go-exact stream draws them one by one. In split mode (the sync
        scheduler) each link takes one scalar push into the pending planes,
        in dest order (the JAX ``fori_loop`` of ``_push_marker``). Lanes
        outside ``mask`` draw nothing."""
        if self.marker_mode == "split":
            row = self._edge_table[node.long()]               # [B, D]
            for k in range(row.shape[1]):
                go = mask & (row[:, k] >= 0)
                if bool(go.any()):
                    s = self._push_marker_split(s, row[:, k].clamp(min=0),
                                                sid, go)
            return s
        b, d = s.time.shape[0], self._edge_table.shape[1]
        dstate = s.delay_state
        # the row's k-th draw is its out-edge src_lo + k (dest order)
        outdeg = self._outdeg_n[node.long()]                  # [B]
        if self.delay.position_streams:
            rts_k = self.delay.block_receive_times(
                dstate, s.time, self._ord_d.expand(b, d))
            dstate = self.delay.advance_draws(
                dstate, torch.where(mask, outdeg, 0))
        elif hasattr(self.delay, "draw_run"):
            # a chain of splits, the draws off it in one call (threefry)
            counts = torch.where(mask, outdeg, 0)
            width = int(counts.max())
            rts_k = torch.zeros((b, d), dtype=_i32, device=self.device)
            if width:
                rts_k[:, :width], dstate = self.delay.draw_run(
                    dstate, s.time, counts, width)
        else:
            rts_k = torch.zeros((b, d), dtype=_i32, device=self.device)
            for k in range(d):
                lane_k = mask & (outdeg > k)
                if not bool(lane_k.any()):
                    continue
                rt, drawn = self.delay.draw(dstate, s.time)
                dstate = select_words(lane_k, drawn, dstate)
                rts_k[:, k] = torch.where(lane_k, rt, 0)
        s = s._replace(delay_state=dstate)
        q_meta, q_data, q_len, pushed, error = k_queue.append_marker_rows(
            s.q_meta, s.q_data, s.q_head, s.q_len, s.tok_pushed, s.error,
            node, mask, rts_k, self._marker_payload(s, sid), self._src_lo,
            self._src_hi, capacity=self.cfg.queue_capacity,
            key_limit=self._key_limit)
        s = s._replace(q_meta=q_meta, q_data=q_data, q_len=q_len,
                       tok_pushed=pushed, error=error)
        if self._trace_on:
            # the row's edges in dest order; the trace carries the raw sid
            row = self._edge_table[node.long()]
            sent = torch.zeros((b, self.topo.e + 1), dtype=torch.bool,
                               device=self.device).scatter_(
                1, torch.where((row >= 0) & mask.unsqueeze(-1), row,
                               self.topo.e).long(), True)
            s = trace_append_many(s, sent[:, :-1], EV_MSEND, self._rows_e,
                                  sid.unsqueeze(-1))
        return s

    def _finalize_check(self, s: DenseState, sid, node, mask) -> DenseState:
        """finalizeSnapshot + NotifyCompletedSnapshot where no links of
        (sid, node) remain recording (node.go:165-170), on ``mask``."""
        lanes = self._lanes(s)
        cell = (lanes, sid.long(), node.long())
        done = s.done_local[cell]
        fire = mask & s.has_local[cell] & (s.rem[cell] == 0) & ~done
        if self._trace_on:
            s = trace_append_one(s, fire, EV_SNAP_END, node, sid)
        s.done_local[cell] = done | fire
        s.completed[lanes, sid.long()] += fire.to(_i32)
        return s

    def _handle_marker(self, s: DenseState, act, e, sid,
                       cnt_extra) -> DenseState:
        """HandleMarker (node.go:149-171) for the marker on edge ``e`` [B]
        with id ``sid`` [B], on the lanes of ``act``. A first marker for
        sid at the destination creates the local snapshot and
        re-broadcasts; a repeat stops recording the edge. Each lane takes
        only its own branch (the JAX ``lax.cond`` under ``vmap`` computes
        both and selects), then the finalization check."""
        if self._trace_on:
            # the receipt before its handling (node.go:141)
            s = trace_append_one(s, act, EV_MRECV, e, sid)
        lanes = self._lanes(s)
        dst = self._edge_dst[e]
        sid_l, dst_l = sid.long(), dst.long()
        first = act & ~s.has_local[lanes, sid_l, dst_l]
        rep = act & ~first
        if bool(first.any()):
            s = self._create_local(s, sid, dst, e.to(_i32), first,
                                   cnt_extra)
            s = self._broadcast_markers(s, dst, sid, first)
        # repeat: close the window at the live counter where the channel
        # still records (the JAX ``repeat`` branch)
        cell = (lanes, sid_l, e)
        was = rep & s.recording[cell]
        s.recording[cell] = s.recording[cell] & ~rep
        s.rem[lanes, sid_l, dst_l] -= was.to(_i32)
        s.rec_end[cell] = torch.where(
            was, s.rec_cnt[lanes, e].to(s.rec_end.dtype), s.rec_end[cell])
        return self._finalize_check(s, sid, dst, act)

    def _select_and_pop(self, s: DenseState, active=None, fmasks=None):
        """Tick-start delivery selection: every source's first eligible
        head in dest order, popped up front with its payload captured —
        the cascade's fact 1. Without faults this is the fused
        ``queue_step``, and lanes outside ``active`` see a clock at which
        nothing is eligible. With faults (``fmasks`` = this tick's
        (edge, marker) masks) it splits as the JAX form does: the head
        read, the jitter and crash gates on the eligibility (lanes outside
        ``active`` eligible nowhere), then ``select_pop``. Returns (s,
        tok_pend, mk_pend, head_data), all [B, E]."""
        C = self.cfg.queue_capacity
        if self.faults is None:
            time = (s.time if active is None
                    else torch.where(active, s.time, _FROZEN_TIME))
            tok, mk, head_data, new_head, new_len = k_queue.queue_step(
                s.q_meta, s.q_data, s.q_head, s.q_len, time,
                self._src_first, self._src_lo, self._src_hi, capacity=C)
            return (s._replace(q_head=new_head, q_len=new_len), tok, mk,
                    head_data)
        head_rt, head_mk, head_data = self._head_fields(s)
        elig = (s.q_len > 0) & (head_rt <= s.time.unsqueeze(-1))
        if active is not None:
            elig = elig & active.unsqueeze(-1)
        (_, _, jit_e, _), (_, _, mjit_e, _) = fmasks
        s, elig = self._fault_gate_elig(s, elig, jit_e, mjit_e, head_mk)
        sel, new_head, new_len = k_queue.select_pop(
            s.q_head, s.q_len, elig, self._src_first, self._src_lo,
            self._src_hi, capacity=C)
        return (s._replace(q_head=new_head, q_len=new_len), sel & ~head_mk,
                sel & head_mk, head_data)

    def _credit(self, s: DenseState, mask, amt_e) -> DenseState:
        """HandleToken's balance half (node.go:175) for the tokens of
        ``mask`` [B, E]."""
        return s._replace(tokens=s.tokens + self._sum_by_dst(
            torch.where(mask, amt_e, 0)))

    def _cascade_tick(self, s: DenseState, active=None) -> DenseState:
        """One exact tick (sim.go:71-95), bit-identical to the JAX
        ``_cascade_tick`` (its docstring proves the form): select and pop
        every source's delivery at once, then fold over the popped
        markers in source order, crediting before each marker the tokens
        of lower-ranked sources, and append the recorded tokens once at
        the end. The fold is the JAX ``while_loop`` under ``vmap``: each
        step takes every lane's lowest pending marker edge, and a lane
        with none left is frozen, not run. ``active`` [B] (None = every
        lane) ticks only those lanes; the others are left as they were.

        Under faults and the supervisor (the JAX ``_cascade_tick``
        :1597-1682): crash restarts and the supervisor step at tick start,
        the gated selection, the drop/dup split of the popped tokens and
        markers, the stale-epoch rejection, the fold on the decoded slot
        ids, and the duplicates re-appended after the fold."""
        E = self.topo.e
        s, tok, mk, head_data, sid_e, dups = self._tick_open(s, active)
        amt_e = torch.where(tok, head_data, 0)
        app = torch.zeros_like(tok)
        lanes = self._lanes(s)
        while bool(mk.any()):
            self.fold_steps += 1
            found = mk.any(-1)
            e = torch.where(mk, self._rows_e, E).amin(-1)
            e = torch.where(found, e, 0).long()
            # a frozen lane's chunk bound 0 credits nothing
            r = torch.where(found, self._edge_src[e], 0)
            tmask = tok & (self._edge_src < r.unsqueeze(-1))
            s = self._credit(s, tmask, amt_e)
            if self._trace_on:
                # the chunk's receipts in edge order, before its marker
                s = trace_append_many(s, tmask, EV_RECV, self._rows_e, amt_e)
            app = app | (tmask & s.recording.any(-2))
            sid = torch.where(found, sid_e[lanes, e], 0)
            s = self._handle_marker(s, found, e, sid, app.to(_i32))
            mk = mk & ~(found.unsqueeze(-1)
                        & (self._rows_e == e.unsqueeze(-1)))
            tok = tok & ~tmask
        return self._tick_close(s, tok, app, amt_e, head_data, dups, active)

    def _fold_tick(self, s: DenseState, active=None) -> DenseState:
        """One exact tick in the reference-literal form (sim.go:71-95, the
        JAX ``_tick`` :1459): the N sources in node order, each popping
        its first eligible out-edge in dest order and handling it before
        the next source looks (HandlePacket: a token credits its
        destination and is logged where its channel records, a marker
        runs HandleMarker, whose first receipt broadcasts through
        ``_broadcast_markers``, row 5 on the card). Each source step is
        batched over the lanes: a lane whose source has no eligible edge,
        or that is outside ``active`` [B], is left as it was (no draw, no
        write). Sources whose out-edges are empty in every lane at tick
        start are skipped: a tick's appends all carry receive times past
        it, so they cannot become eligible. The fold runs uninjured and
        unsupervised (the constructor refuses both)."""
        s = s._replace(time=s.time + (1 if active is None
                                      else active.to(_i32)))
        time = (s.time if active is None
                else torch.where(active, s.time, _FROZEN_TIME))
        lo_n = self._src_bounds_host
        busy = (s.q_len > 0).any(0).cpu().numpy()
        sources = [v for v in range(self.topo.n)
                   if busy[lo_n[v]:lo_n[v + 1]].any()]
        for v in sources:
            lo, hi = int(lo_n[v]), int(lo_n[v + 1])
            head = s.q_head[:, lo:hi].long()
            meta = torch.gather(s.q_meta[:, lo:hi], 2,
                                head.unsqueeze(-1)).squeeze(-1)
            elig = (s.q_len[:, lo:hi] > 0) & (
                (meta >> 1) <= time.unsqueeze(-1))
            found = elig.any(-1)
            if not bool(found.any()):
                continue
            self.fold_steps += 1
            # the first eligible out-edge in dest order
            k = torch.where(elig, torch.arange(hi - lo, device=self.device),
                            hi - lo).amin(-1)
            e = (lo + torch.where(found, k, 0)).long()
            s = self._fold_deliver(s, e, found)
        return self._stamp_done(s, active)

    def _fold_deliver(self, s: DenseState, e, act) -> DenseState:
        """Pop edge ``e`` [B]'s head on the lanes of ``act`` and dispatch
        it (HandlePacket, node.go:140-146; the JAX ``_deliver``)."""
        C = self.cfg.queue_capacity
        lanes = self._lanes(s)
        head = s.q_head[lanes, e]
        slot = (lanes, e, head.long())
        marker = act & ((s.q_meta[slot] & 1) == 1)
        data = s.q_data[slot]
        s.q_head[lanes, e] = torch.where(act, (head + 1) % C, head)
        s.q_len[lanes, e] -= act.to(_i32)
        token = act & ~marker
        if bool(token.any()):
            s = self._fold_token(s, e, data, token)
        if bool(marker.any()):
            # a marker's payload is its slot id (the fold is unsupervised)
            s = self._handle_marker(s, marker, e, torch.where(marker, data, 0),
                                    None)
        return s

    def _fold_token(self, s: DenseState, e, amount, act) -> DenseState:
        """HandleToken (node.go:174-185; the JAX ``_handle_token``) for
        the token ``amount`` [B] on edge ``e`` [B], on the lanes of
        ``act``: credit the destination and, where any slot records the
        edge, append the amount to its log at the live counter."""
        if self._trace_on:
            s = trace_append_one(s, act, EV_RECV, e.to(_i32), amount)
        L = self.cfg.max_recorded
        lanes = self._lanes(s)
        rec = act & s.recording[lanes, :, e].any(-1)
        cnt = s.rec_cnt[lanes, e]
        new_cnt = cnt + rec.to(_i32)
        err = (_flag(rec & (new_cnt - s.min_prot[lanes, e] > L),
                     ERR_RECORD_OVERFLOW)
               | _flag(rec & (amount > self._rec_limit), ERR_VALUE_OVERFLOW))
        dst = self._edge_dst[e].long()
        s.tokens[lanes, dst] += torch.where(act, amount, 0)
        cell = (lanes, (cnt % L).long(), e)       # rec_cnt >= 0
        s.log_amt[cell] = torch.where(rec, amount.to(self._rec_dtype),
                                      s.log_amt[cell])
        s.rec_cnt[lanes, e] = new_cnt
        return s._replace(error=s.error | err)

    def _tick_open(self, s: DenseState, active):
        """The exact tick up to its markers, shared by the cascade and the
        wave: the time increment, the crash restarts and the supervisor
        step, the selection and pop, the drop/dup split and the
        stale-epoch rejection. Returns (s, tok, mk, head_data, sid_e,
        dups): the surviving popped tokens and markers [B, E], the
        payloads, the markers' slot ids, and the duplicates to re-append
        (masks and receive times; None without faults)."""
        s = s._replace(time=s.time + (1 if active is None
                                      else active.to(_i32)))
        fmasks = dups = None
        if self.faults is not None:
            # the hash is stateless in (fault_key, time, index), so the
            # masks hashed once here equal the JAX hooks' re-hashes
            fmasks = (self._fault_edge_masks(s), self._fault_marker_masks(s))
            s = self._fault_restart(s, active)
        if self._sup:
            s = self._supervise(s, active)
        s, tok, mk, head_data = self._select_and_pop(s, active, fmasks)
        if self.faults is not None:
            (drop_e, dup_e, _, dup_rt), (mdrop_e, mdup_e, _, mdup_rt) = \
                fmasks
            s, tok, dup = self._fault_split_tokens(s, tok, head_data,
                                                   drop_e, dup_e)
            s, mk, mk_dup = self._fault_split_markers(s, mk, mdrop_e,
                                                      mdup_e)
            dups = (dup, mk_dup, dup_rt, mdup_rt)
        s, mk, sid_e = self._reject_stale(s, mk, head_data)
        return s, tok, mk, head_data, sid_e, dups

    def _tick_close(self, s: DenseState, tok, app, amt_e, head_data, dups,
                    active) -> DenseState:
        """The exact tick after its markers: the tokens left credited and
        marked for the log where their channel records, the log append,
        the duplicates re-appended and the completion stamp."""
        s = self._credit(s, tok, amt_e)
        if self._trace_on:
            s = trace_append_many(s, tok, EV_RECV, self._rows_e, amt_e)
        app = app | (tok & s.recording.any(-2))
        log, cnt, err = log_append_masked(
            s.log_amt, s.rec_cnt, s.min_prot, app, amt_e, self._rec_dtype,
            self._rec_limit, self.cfg.max_recorded)
        s = s._replace(log_amt=log, rec_cnt=cnt, error=s.error | err)
        if dups is not None:
            # duplicated tokens and markers re-enter their channel at the
            # tail with fault-stream receive times (an edge delivered one
            # or the other), markers keeping their epoch-tagged payload
            dup, mk_dup, dup_rt, mdup_rt = dups
            s = self._append_rows(s, dup | mk_dup,
                                  torch.where(mk_dup, mdup_rt, dup_rt),
                                  mk_dup, head_data)
        return self._stamp_done(s, active)

    def _wave_tick(self, s: DenseState, active=None) -> DenseState:
        """One exact tick in the wave form, bit-identical to
        ``_cascade_tick`` for a position-addressable sampler (the JAX
        ``_wave_tick`` docstring proves it): markers bound for distinct
        destinations touch disjoint cells, edges and ring rows, so each
        host step (a wave) serves every destination's next pending
        marker at once, in edge order within a destination. The only
        coupling across destinations is the sampler's draw order, and
        every broadcast's stream position is a tick-start fact: a popped
        marker is a first receipt iff (sid, dst) has no local snapshot
        and no earlier marker of this tick for the same (sid, dst); its
        draws start at the exclusive sum of the first receipts'
        out-degrees in edge order. The stream is advanced past the whole
        tick once and the waves read their draws by position.

        Each wave credits, per destination, the tokens of lower edge rank
        than its marker; a lane with no marker left is left as it was.
        The fault hooks and the supervisor are the cascade's. One
        difference from the JAX wave: a re-broadcast marker carries the
        epoch-tagged payload (``_marker_payload``), as the cascade's does;
        the JAX wave sends the bare sid, which after a supervisor retry
        (epoch > 0) its receivers reject as stale."""
        S, E = self.cfg.max_snapshots, self.topo.e
        s, tok, mk, head_data, sid_e, dups = self._tick_open(s, active)
        amt_e = torch.where(tok, head_data, 0)
        slots = self._slot_ids[:, None]                           # [S, 1]

        # the tick-start schedule: first receipts, their draw bases in
        # edge order, and each marker's wave (its rank among its
        # destination's markers); a popped marker's sid is in [0, S)
        sid_c = sid_e.clamp(0, S - 1).long().unsqueeze(-2)        # [B,1,E]
        pend_se = mk.unsqueeze(-2) & (slots == sid_e.unsqueeze(-2))
        earlier_same = torch.gather(self._seg_excl(pend_se.to(_i32)), -2,
                                    sid_c).squeeze(-2)
        had = torch.gather(self._spread_dst(s.has_local), -2,
                           sid_c).squeeze(-2)
        first = mk & ~had & (earlier_same == 0)
        draws = torch.where(first, self._outdeg_dst_e, 0)
        base = torch.cumsum(draws, dim=-1, dtype=_i32) - draws
        dstate0, time = s.delay_state, s.time
        s = s._replace(delay_state=self.delay.advance_draws(
            dstate0, draws.sum(-1, dtype=_i32)))
        wnum = self._seg_excl(mk.to(_i32))
        app = torch.zeros_like(tok)
        k = 0
        while True:
            wm = mk & (wnum == k)
            go = wm.any(-1)
            if not bool(go.any()):
                break
            self.fold_steps += 1
            # the wave marker's facts per destination (at most one marker
            # per destination per wave) in one stacked segment sum: its
            # count, sid, edge, first flag and draw base
            per_dst = self._sum_by_dst(torch.stack(
                [wm.to(_i32), torch.where(wm, sid_e, 0),
                 torch.where(wm, self._rows_e, 0), (wm & first).to(_i32),
                 torch.where(wm, base, 0)], dim=-2))              # [B,5,N]
            wdst, wsid_n = per_dst[:, 0] > 0, per_dst[:, 1]
            wfirst_n = per_dst[:, 3] > 0
            # the marker's own edge; E where the destination has none
            wrank_n = torch.where(wdst, per_dst[:, 2], E)
            at_dst = self._spread_dst(torch.stack(
                [wrank_n, wsid_n, wfirst_n.to(_i32)], dim=-2))    # [B,3,E]
            # the tokens ranked below their destination's wave marker
            tmask = (tok & (self._rows_e < at_dst[:, 0])
                     & go.unsqueeze(-1))
            s = self._credit(s, tmask, amt_e)
            if self._trace_on:
                # the wave's receipts, then its markers, each in edge
                # order (a tick's events in wave order, not the fold's)
                s = trace_append_many(s, tmask, EV_RECV, self._rows_e, amt_e)
                s = trace_append_many(s, wm, EV_MRECV, self._rows_e, sid_e)
            app = app | (tmask & s.recording.any(-2))
            tok = tok & ~tmask
            # a repeat closes its own channel where it still records (a
            # duplicated repeat may find it closed); a first receipt
            # creates the local snapshot, windows opening at the counter
            # each in-edge will have once this tick's appends land
            rep_se = ((slots == sid_e.unsqueeze(-2))
                      & (wm & ~first).unsqueeze(-2))              # [B,S,E]
            rep_live = rep_se & s.recording
            rep_sn = self._sum_by_dst(rep_live)                   # [B,S,N]
            first_sn = ((slots == wsid_n.unsqueeze(-2))
                        & wfirst_n.unsqueeze(-2))                 # [B,S,N]
            open_e = (at_dst[:, 2] > 0) & (self._rows_e != at_dst[:, 0])
            open_se = ((slots == at_dst[:, 1].unsqueeze(-2))
                       & open_e.unsqueeze(-2))                    # [B,S,E]
            cnt_open = s.rec_cnt + app.to(_i32)
            s = s._replace(
                recording=(s.recording | open_se) & ~rep_se,
                rec_end=torch.where(rep_live, s.rec_cnt.unsqueeze(-2).to(
                    s.rec_end.dtype), s.rec_end),
                rec_start=torch.where(open_se, cnt_open.unsqueeze(-2).to(
                    s.rec_start.dtype), s.rec_start),
                min_prot=torch.where(open_e, torch.minimum(s.min_prot,
                                                           cnt_open),
                                     s.min_prot),
                has_local=s.has_local | first_sn,
                frozen=torch.where(first_sn, s.tokens.unsqueeze(-2),
                                   s.frozen),
                rem=torch.where(first_sn, self._in_degree - 1,
                                s.rem - rep_sn))
            # SendToNeighbors from every first receipt: one marker per
            # out-edge, drawn at its base + the edge's ordinal
            at_src = self._spread_src(torch.stack(
                [wfirst_n.to(_i32), wsid_n, per_dst[:, 4]], dim=-2))
            rt_g = self.delay.block_receive_times(
                dstate0, time, at_src[:, 2] + self._edge_ord_in_src)
            s = self._append_rows(s, at_src[:, 0] > 0, rt_g, True,
                                  self._marker_payload(s, at_src[:, 1]))
            if self._trace_on:
                s = trace_append_many(s, at_src[:, 0] > 0, EV_MSEND,
                                      self._rows_e, at_src[:, 1])
            # finalize after every receipt (node.go:165-170)
            fire = ((slots == wsid_n.unsqueeze(-2)) & wdst.unsqueeze(-2)
                    & s.has_local & (s.rem == 0) & ~s.done_local)
            if self._trace_on:
                s = self._trace_snap_ends(s, fire)
            s = s._replace(done_local=s.done_local | fire,
                           completed=s.completed + fire.sum(-1, dtype=_i32))
            mk = mk & ~wm
            k += 1
        return self._tick_close(s, tok, app, amt_e, head_data, dups, active)

    # ---- fault adversary hooks (models/faults.py) ----------------------------
    # Called only when ``self.faults`` is set. Lanes outside the tick's
    # ``active`` mask are left exactly as they were: their eligibility is
    # all False (so nothing is popped, gated, dropped or duplicated there)
    # and their restarts are masked.

    def _dup_times(self, s: DenseState, words):
        """Duplicate receive times from the fault stream's words, folded
        into [time + 1, time + max_delay] (the JAX ``_fault_edge_masks``)."""
        md = max(self.cfg.max_delay, 1)
        return s.time.unsqueeze(-1) + 1 + (words % md).to(_i32)

    def _fault_edge_masks(self, s: DenseState):
        """(drop, dup, jitter) bool [B, E] + dup receive times i32 [B, E]
        for the current tick (``s.time`` already incremented)."""
        drop_e, dup_e, jit_e, dupw_e = self.faults.edge_masks(
            s.fault_key, s.time, self.topo.e)
        return drop_e, dup_e, jit_e, self._dup_times(s, dupw_e)

    def _fault_marker_masks(self, s: DenseState):
        """The marker-plane twin of ``_fault_edge_masks``."""
        md_e, mu_e, mj_e, mw_e = self.faults.marker_masks(
            s.fault_key, s.time, self.topo.e)
        return md_e, mu_e, mj_e, self._dup_times(s, mw_e)

    def _trace_faults(self, s: DenseState, mask, cls: int) -> DenseState:
        """One fault event of class ``cls`` per edge of ``mask`` [B, E]."""
        return trace_append_many(s, mask, EV_FAULT, self._rows_e, cls)

    def _trace_snap_ends(self, s: DenseState, fire) -> DenseState:
        """One endSnapshot per (slot, node) of ``fire`` [B, S, N], slot
        major."""
        return trace_append_many(s, fire, EV_SNAP_END, self._node_ids,
                                 self._slot_ids[:, None])

    @staticmethod
    def _count(s: DenseState, cls: int, mask) -> None:
        """Add the events of ``mask`` [B, E] or [B, N] to
        ``fault_counts[:, cls]``, in place."""
        s.fault_counts[:, cls] += mask.sum(-1, dtype=_i32)

    def _fault_split_markers(self, s: DenseState, mk_pend, mdrop_e,
                             mdup_e):
        """A dropped marker vanishes on the wire (popped, never handled);
        a duplicated one is handled and re-appended after the fold.
        Markers move no tokens, so no skew. Returns (state, surviving
        markers, dup mask)."""
        dropped = mk_pend & mdrop_e
        duped = mk_pend & mdup_e & ~dropped
        self._count(s, FC_MDROP, dropped)
        self._count(s, FC_MDUP, duped)
        if self._trace_on:
            s = self._trace_faults(s, dropped, FC_MDROP)
            s = self._trace_faults(s, duped, FC_MDUP)
        return s, mk_pend & ~dropped, duped

    def _fault_gate_elig(self, s: DenseState, elig, jit_e, mjit_e,
                         marker_front):
        """Jitter stalls the edge's front this tick (the marker-plane
        jitter stalls marker fronts on top), and a crashed destination
        receives nothing (its messages wait). Returns (state with the
        stalls counted, elig)."""
        jblocked = elig & jit_e
        mblocked = elig & marker_front & mjit_e
        self._count(s, FC_JITTER, jblocked)
        self._count(s, FC_MJITTER, mblocked)
        if self._trace_on:
            s = self._trace_faults(s, jblocked, FC_JITTER)
            s = self._trace_faults(s, mblocked, FC_MJITTER)
        down_n = self.faults.down_nodes(s.fault_key, s.time, self.topo.n)
        dead = elig & self._spread_dst(down_n)
        return s, elig & ~(jblocked | mblocked) & ~dead

    def _fault_split_tokens(self, s: DenseState, tok_e, amt_src, drop_e,
                            dup_e):
        """Dropped tokens vanish (popped, never credited or recorded);
        duplicated ones deliver and are re-appended after the fold. The
        books: ``fault_skew`` += dup amounts - dropped amounts. Returns
        (state, surviving tokens, dup mask)."""
        dropped = tok_e & drop_e
        duped = tok_e & dup_e & ~dropped   # a lost message cannot also fork
        skew = (torch.where(duped, amt_src, 0).sum(-1, dtype=_i32)
                - torch.where(dropped, amt_src, 0).sum(-1, dtype=_i32))
        self._count(s, FC_DROP, dropped)
        self._count(s, FC_DUP, duped)
        if self._trace_on:
            s = self._trace_faults(s, dropped, FC_DROP)
            s = self._trace_faults(s, duped, FC_DUP)
        return (s._replace(fault_skew=s.fault_skew + skew),
                tok_e & ~dropped, duped)

    def _fault_restart(self, s: DenseState, active=None) -> DenseState:
        """Crash-window restarts at tick start, on the lanes of
        ``active``. "pause" only counts them; "lossy" restores the
        restarting node's balance from the newest completed snapshot's
        frozen value, or zeroes it and raises ERR_FAULT_UNRECOVERED when
        none has completed. Every balance change lands in
        ``fault_skew``."""
        n = self.topo.n
        rs_n = self.faults.restarted(s.fault_key, s.time, n)
        if active is not None:
            rs_n = rs_n & active.unsqueeze(-1)
        self._count(s, FC_CRASH, rs_n)
        if self._trace_on:
            # the one fault event whose actor is a node
            s = trace_append_many(s, rs_n, EV_FAULT, self._node_ids,
                                  FC_CRASH)
        if self.faults.crash_mode != "lossy":
            return s
        S = self.cfg.max_snapshots
        done = s.started & (s.completed >= n)
        sid = torch.where(done, self._slot_ids, -1).amax(-1)        # [B]
        have = sid >= 0
        frozen = s.frozen[self._lanes(s), sid.clamp(0, S - 1).long()]
        restored = torch.where(rs_n, torch.where(have.unsqueeze(-1), frozen,
                                                 0), s.tokens)
        return s._replace(
            tokens=restored,
            fault_skew=s.fault_skew + (restored - s.tokens).sum(
                -1, dtype=_i32),
            error=s.error | _flag(rs_n.any(-1) & ~have,
                                  ERR_FAULT_UNRECOVERED))

    # ---- snapshot supervisor (cfg.snapshot_timeout / snapshot_every) ------
    # Called only when the supervisor is armed; only the re-initiation and
    # the daemon's injection differ by marker mode.

    def _marker_payload(self, s: DenseState, sid):
        """The ring payload of a marker for slot ``sid`` ([B], or [B, K]
        slots per lane): (sid, epoch) packed when the supervisor is armed
        (epoch 0 packs to the bare sid), the bare sid otherwise."""
        if not self._sup:
            return sid
        epoch = torch.gather(s.snap_epoch, -1,
                             sid.long().reshape(sid.shape[0], -1))
        return pack_marker_data(sid, epoch.reshape(sid.shape),
                                self.cfg.max_snapshots)

    def _reject_stale(self, s: DenseState, mk_pend, head_data):
        """Decode (sid, epoch) from the popped markers' payloads and drop
        the ones whose epoch the supervisor has superseded, counted in
        ``stale_markers``. Returns (state, surviving markers, sid_e [B, E]);
        the identity (``sid_e`` = the raw payload) when unsupervised."""
        if not self._sup:
            return s, mk_pend, head_data
        S = self.cfg.max_snapshots
        sid_e = marker_data_sid(head_data, S)
        epoch_now = torch.gather(s.snap_epoch, -1, sid_e.clamp(0, S - 1)
                                 .long())
        stale = mk_pend & (marker_data_epoch(head_data, S) != epoch_now)
        return (s._replace(stale_markers=s.stale_markers
                           + stale.sum(-1, dtype=_i32)),
                mk_pend & ~stale, sid_e)

    def _sup_scan(self, s: DenseState, active=None):
        """Timeout scan on the lanes of ``active``: abort every attempt
        past its deadline (slot released, windows zeroed, epoch bumped),
        then re-schedule it (deadline doubling per retry, capped at 16x)
        or fail it with ERR_SNAPSHOT_TIMEOUT. Returns (state, retry mask
        [B, S])."""
        cfg = self.cfg
        timed_out = (s.started & ~s.snap_failed
                     & (s.completed < self.topo.n) & (s.snap_deadline > 0)
                     & (s.time.unsqueeze(-1) >= s.snap_deadline))
        if active is not None:
            timed_out = timed_out & active.unsqueeze(-1)
        if not bool(timed_out.any()):
            # every update below is the identity then
            return s, timed_out
        can_retry = timed_out & (s.snap_retries < cfg.snapshot_retries)
        failed = timed_out & ~can_retry
        t_b = timed_out.unsqueeze(-1)          # over the N and E axes
        new_retries = s.snap_retries + can_retry.to(_i32)
        backoff = (torch.full_like(new_retries, max(cfg.snapshot_timeout, 1))
                   << new_retries.clamp(max=4))
        s = s._replace(
            has_local=s.has_local & ~t_b,
            done_local=s.done_local & ~t_b,
            frozen=torch.where(t_b, 0, s.frozen),
            rem=torch.where(t_b, 0, s.rem),
            recording=s.recording & ~t_b,
            rec_start=torch.where(t_b, 0, s.rec_start),
            rec_end=torch.where(t_b, 0, s.rec_end),
            completed=torch.where(timed_out, 0, s.completed),
            m_pending=s.m_pending & ~t_b,
            snap_epoch=s.snap_epoch + timed_out.to(_i32),
            snap_retries=new_retries,
            snap_failed=s.snap_failed | failed,
            snap_deadline=torch.where(
                can_retry, s.time.unsqueeze(-1) + backoff,
                torch.where(failed, 0, s.snap_deadline)),
            error=s.error | _flag(failed.any(-1), ERR_SNAPSHOT_TIMEOUT))
        if self._trace_on:
            # the decisions in decision order: every timed-out attempt
            # aborts, then retries or fails
            init_n = s.snap_initiator.clamp(0, self.topo.n - 1)
            for kind, m in ((EV_SUP_ABORT, timed_out),
                            (EV_SUP_RETRY, can_retry),
                            (EV_SUP_FAIL, failed)):
                s = trace_append_many(s, m, kind, init_n, self._slot_ids)
        return s, can_retry

    def _sup_reinitiate_ring(self, s: DenseState, retry) -> DenseState:
        """Re-initiate each retried slot from its remembered initiator,
        under the bumped epoch: a fresh local snapshot recording all
        inbound links and a marker broadcast. Each lane takes its retried
        slots lowest first (its draw order); the loop runs while any lane
        has one left, a lane with none left is frozen (the JAX
        ``while_loop`` under ``vmap``)."""
        S = self.cfg.max_snapshots
        lanes = self._lanes(s)
        while bool(retry.any()):
            go = retry.any(-1)
            sid = torch.where(retry, self._slot_ids, S).amin(-1)
            sid = torch.where(go, sid, 0)
            node = s.snap_initiator[lanes, sid.long()].clamp(
                0, self.topo.n - 1)
            s = self._create_local(s, sid, node, torch.full_like(sid, -1),
                                   go)
            s = self._broadcast_markers(s, node, sid, go)
            retry = retry & ~(go.unsqueeze(-1)
                              & (self._slot_ids == sid.unsqueeze(-1)))
        return s

    def _sup_reinitiate_split(self, s: DenseState, retry) -> DenseState:
        """The split-mode re-initiation (the sync scheduler): one
        create-and-broadcast over every retried slot's initiator, on the
        lanes with a retry; the others draw nothing (the JAX
        ``lax.cond(any(retry))`` under ``vmap``)."""
        go = retry.any(-1)
        if not bool(go.any()):
            return s
        init = s.snap_initiator.clamp(0, self.topo.n - 1)        # [B, S]
        created = retry.unsqueeze(-1) & (self._node_ids
                                         == init.unsqueeze(-1))  # [B, S, N]
        return self._create_and_broadcast(s, created, go)

    def _sup_daemon(self, s: DenseState, active=None) -> DenseState:
        """Every ``snapshot_every`` ticks, initiate a snapshot from the
        rotating initiator ``(time // every) % n`` while free slots remain
        (per lane: each lane's clock and slots are its own): the scalar
        injection in ring mode, the bulk one in split mode. A lane that
        does not fire draws nothing."""
        every = self.cfg.snapshot_every
        fire = ((s.time % every == 0) & (s.time > 0)
                & (s.next_sid < self.cfg.max_snapshots))
        if active is not None:
            fire = fire & active
        if not bool(fire.any()):
            return s
        node = torch.div(s.time, every, rounding_mode="floor") % self.topo.n
        if self.marker_mode == "ring":
            return self._inject_snapshot(s, node, fire)
        mask = fire.unsqueeze(-1) & (self._node_ids == node.unsqueeze(-1))
        return self._bulk_snapshots(s, mask, fire)

    def _supervise(self, s: DenseState, active=None) -> DenseState:
        """The per-tick supervisor step at tick start (after the time
        increment and the crash restarts, before the selection): the
        daemon, then the timeout scan and the re-initiations (by the
        kernel's marker mode), whose markers are due after this tick."""
        if self.cfg.snapshot_every:
            s = self._sup_daemon(s, active)
        if self.cfg.snapshot_timeout:
            s, retry = self._sup_scan(s, active)
            if self.marker_mode == "ring":
                s = self._sup_reinitiate_ring(s, retry)
            else:
                s = self._sup_reinitiate_split(s, retry)
        return s

    def _quiescent(self, s: DenseState):
        """[B]: an exact tick would be a pure time increment (the JAX
        ``_quiescent`` proof): every ring is empty. A crash-capable
        adversary or the snapshot daemon voids the proof (never
        quiescent); with the timeout armed, a lane with a pending
        snapshot must keep ticking to reach its deadline."""
        if (self.faults is not None and self.faults.crashes) \
                or self.cfg.snapshot_every:
            return torch.zeros_like(s.time, dtype=torch.bool)
        quiet = ~(s.q_len > 0).any(-1)
        if self.cfg.snapshot_timeout:
            quiet = quiet & ~self._pending(s)
        return quiet

    def _halted(self, s: DenseState):
        """[B]: the multi-tick loop is over for the lane — quiescent, or
        errored under quarantine."""
        h = self._quiescent(s)
        return h | (s.error != 0) if self.quarantine else h

    def _fused_steps(self, s: DenseState, mode: str, length: int,
                     live=None, limit=None) -> DenseState:
        """One megatick of ``length`` steps (``kernels/megatick`` module
        docstring): the kernel where the fused megatick is on (the card),
        else its plain form, single ticks of this kernel's tick (the CPU;
        ``fused_tick="off"`` and the fold on the card: the split
        kernels)."""
        run = (k_megatick.fused_ticks if self.fused == "on"
               else k_megatick.fused_ticks_plain)
        return run(self, s, mode=mode, length=length, live=live,
                   limit=limit)

    def _run_ticks(self, s: DenseState, n) -> DenseState:
        """``n`` exact ticks per lane (the JAX ``_run_ticks``): ``n`` is a
        host int shared by every lane or a [B] tensor of counts, one per
        lane (a stream's lanes sit at different script phases; 0 leaves a
        lane as it was). A lane ticks until its count is done or it is
        quiescent, and its remaining ticks land as one time increment.
        Under quarantine an errored lane halts too and its clock stays
        where it was poisoned. At megatick K > 1 each lane's ``n % K``
        remainder runs first as single ticks, then full megaticks while
        the lane is live, each advancing its count by K (a lane that goes
        quiet inside one is bumped); a one-tick count is never fused."""
        K = self.megatick
        n = self._lane_ints(s, n)
        single = n % K if K > 1 else n
        i = torch.zeros_like(s.time)
        live = (i < single) & ~self._halted(s)
        while bool(live.any()):
            s = self._exact_tick(s, None if bool(live.all()) else live)
            i = i + live.to(_i32)
            live = (i < single) & ~self._halted(s)
        if K > 1:
            live = (i < n) & ~self._halted(s)
            while bool(live.any()):
                s = self._fused_steps(s, "ticks", K, live=live)
                i = i + K * live.to(_i32)
                live = (i < n) & ~self._halted(s)
        rest = n - i
        if self.quarantine:
            rest = torch.where(s.error != 0, 0, rest)
        return s._replace(time=s.time + rest)

    def _sync_run_ticks(self, s: DenseState, n) -> DenseState:
        """``n`` sync ticks per lane (a host int or [B] counts): the sync
        tick draws (S, E) delays every tick, so it is never a pure time
        increment and there is no fast-forward (the JAX runner's
        ``fori_loop`` of ``_sync_tick``, per lane under ``vmap``)."""
        n = self._lane_ints(s, n)
        top = int(n.max()) if n.numel() else 0
        for k in range(top):
            live = n > k
            s = self._sync_tick_lanes(s, None if bool(live.all()) else live)
        return s

    def _inject_send(self, s: DenseState, e, amount,
                     mask=None) -> DenseState:
        """PassTokenEvent -> SendTokens (node.go:112-131) on edge ``e``:
        debit at send time, one delay draw, enqueue. ``e`` and ``amount``
        are host ints shared by every lane or [B] tensors, one per lane (a
        batched script's op); lanes outside ``mask`` [B] (None = every
        lane) are left as they were."""
        if self._trace_on:
            s = trace_append_one(s, True if mask is None else mask, EV_SEND,
                                 self._lane_ints(s, e),
                                 self._lane_ints(s, amount))
        lanes = self._lanes(s)
        src = self._edge_src[self._lane_ints(s, e).long()].long()
        amount = self._lane_ints(s, amount)
        have = s.tokens[lanes, src]
        under = have < amount
        if mask is not None:
            under = under & mask
            amount = torch.where(mask, amount, 0)
        s = s._replace(error=s.error | _flag(under, ERR_TOKEN_UNDERFLOW))
        s.tokens[lanes, src] = have - amount
        return self._push(s, e, False, amount, mask)

    def _inject_snapshot(self, s: DenseState, node, mask=None) -> DenseState:
        """SnapshotEvent -> sim.StartSnapshot (sim.go:105-123) at ``node``
        (a host int, or one node per lane [B]) on the lanes of ``mask`` [B]
        (None = every lane): allocate the next id, create the initiator's
        local snapshot recording all inbound links, broadcast markers.
        Under the supervisor, remember the initiator and arm the first
        attempt's deadline."""
        S = self.cfg.max_snapshots
        sid = s.next_sid
        go = (torch.ones_like(s.started[:, 0]) if mask is None else mask)
        s = s._replace(next_sid=s.next_sid + go.to(_i32),
                       error=s.error | _flag(go & (sid >= S),
                                             ERR_SNAPSHOT_OVERFLOW))
        sid = sid.clamp(0, S - 1)
        lanes = self._lanes(s)
        cell = (lanes, sid.long())
        s.started[cell] = s.started[cell] | go
        node_b = (torch.full_like(sid, node) if isinstance(node, int)
                  else node.to(_i32))
        if self._trace_on:
            s = trace_append_one(s, go, EV_SNAP_START, node_b, sid)
        if self._sup:
            s.snap_initiator[cell] = torch.where(go, node_b,
                                                 s.snap_initiator[cell])
            if self.cfg.snapshot_timeout:
                s.snap_deadline[cell] = torch.where(
                    go, s.time + self.cfg.snapshot_timeout,
                    s.snap_deadline[cell])
        s = self._create_local(s, sid, node_b, torch.full_like(sid, -1), go)
        return self._broadcast_markers(s, node_b, sid, go)

    # ---- drain ---------------------------------------------------------------

    def _pending(self, s: DenseState):
        """[B]: a started, unfailed snapshot has not reached every node."""
        return (s.started & ~s.snap_failed
                & (s.completed < self.topo.n)).any(-1)

    def _drain_cond(self, s: DenseState, limit):
        """[B]: the lane drains on — a snapshot is pending and its clock
        is below ``limit`` (and no error bit is set, under quarantine)."""
        c = self._pending(s) & (s.time < limit)
        return c & (s.error == 0) if self.quarantine else c

    def _drain_and_flush_with(self, s: DenseState, tick,
                              megatick: int = 1) -> DenseState:
        """Tick each lane until its snapshots complete or it reaches its own
        ``time + max_ticks`` limit, then ``max_delay + 1`` flush ticks on
        every lane. ``tick(s, active)`` ticks the lanes of ``active`` [B]
        (None = all). A lane stops ticking when ITS condition goes false —
        the semantics of the JAX while_loop under vmap — so the lanes'
        clocks end where the JAX run's do.

        Under quarantine a lane with error bits stops like a finished one
        (drain and flush ticks alike) and is not charged ERR_TICK_LIMIT
        for the ticks it was denied.

        At ``megatick`` K > 1 (the exact drain) the drain runs K-step
        megaticks, each step ticking only while the lane's condition
        holds, and the flush runs as one fused stretch: a condition-false
        step is the identity, so the result equals K = 1."""
        folds = self.fold_steps
        limit = s.time + self.cfg.max_ticks
        active = self._drain_cond(s, limit)
        b = active.shape[0]
        live = int(active.sum())
        while live:
            if megatick > 1:
                s = self._fused_steps(s, "drain", megatick, limit=limit)
            else:
                s = tick(s, None if live == b else active)
            active = self._drain_cond(s, limit)
            live = int(active.sum())
        blown = self._pending(s)
        if self.quarantine:
            blown = blown & (s.error == 0)
        s = s._replace(error=s.error | _flag(blown, ERR_TICK_LIMIT))
        if megatick > 1:
            s = self._fused_steps(s, "flush", self.cfg.max_delay + 1)
        else:
            for _ in range(self.cfg.max_delay + 1):
                active = (s.error == 0) if self.quarantine else None
                live = b if active is None else int(active.sum())
                if live:
                    s = tick(s, None if live == b else active)
        self.drain_fold_steps += self.fold_steps - folds
        return s

    def _sync_tick_lanes(self, s: DenseState, active) -> DenseState:
        """The sync tick on the lanes of ``active`` [B] (None = all): every
        lane's functional leaves are computed and the others are selected
        back. The in-place effects take ``active`` (``_sync_tick``), and
        the recorder, which writes its ring in place, is disarmed on an
        inactive lane for the tick (its ``tr_on`` is selected back with
        the rest)."""
        if active is None:
            return self._sync_tick(s)
        ticked = self._sync_tick(s._replace(
            tr_on=torch.where(active, s.tr_on, 0)), active)
        return select_lanes(active, ticked, s)

    def _sync_drain_and_flush(self, s: DenseState) -> DenseState:
        return self._drain_and_flush_with(s, self._sync_tick_lanes)

    def _drain_and_flush(self, s: DenseState) -> DenseState:
        return self._drain_and_flush_with(s, self._exact_tick,
                                          self.megatick)

    # ---- the streaming engine's drain slice and flush pass -------------------
    # (parallel/batch.BatchedRunner.run_stream: each lane is in its own
    # stage, so both passes are gated per lane)

    def _stream_more(self, s: DenseState, in_drain, limit):
        """[B]: a lane of the drain slice ticks on — in its drain stage
        (``in_drain``), a snapshot pending and its clock below its job's
        absolute ``limit`` (and no error bit, under quarantine)."""
        return in_drain & self._drain_cond(s, limit)

    def _single_tick(self, s: DenseState, active=None) -> DenseState:
        """One tick of this kernel's scheduler on the lanes of ``active``
        (None = every lane): the exact tick in ring mode, the sync tick in
        split mode."""
        if self.marker_mode == "ring":
            return self._exact_tick(s, active)
        return self._sync_tick_lanes(s, active)

    def _stream_drain(self, s: DenseState, in_drain, limit,
                      chunk: int) -> DenseState:
        """The stream's drain slice (the JAX ``lane_pass`` stage 2):
        ``chunk`` conditional drain ticks on the lanes of ``in_drain``
        [B], each against its own job's absolute ``limit`` [B]. On the
        exact scheduler at megatick K > 1 it is the JAX
        ``_fused_stream_drain`` (B4): ``chunk // K`` megaticks of the fused
        kernel's "drain" body gated by ``live=in_drain`` (on the card a
        lane not in its drain returns before it loads anything; on the CPU
        the plain form), then the ``chunk % K`` remainder as single ticks;
        otherwise ``chunk`` single ticks. A condition-false step is the
        identity, so the slice ends once no lane's condition holds."""
        fused = self.marker_mode == "ring" and self.megatick > 1
        nmega, rem = divmod(int(chunk), self.megatick) if fused \
            else (0, int(chunk))
        for _ in range(nmega):
            if not bool(self._stream_more(s, in_drain, limit).any()):
                return s
            s = self._fused_steps(s, "drain", self.megatick, live=in_drain,
                                  limit=limit)
        b = s.time.shape[0]
        for _ in range(rem):
            more = self._stream_more(s, in_drain, limit)
            live = int(more.sum())
            if not live:
                break
            s = self._single_tick(s, None if live == b else more)
        return s

    def _stream_flush(self, s: DenseState, live) -> DenseState:
        """The stream's flush pass on the lanes of ``live`` [B] (stage 3):
        ``max_delay + 1`` ticks, each gated on ``error == 0`` under
        quarantine (the JAX ``lax.cond(stage == 3, flush, ...)`` under
        ``vmap``). On the exact scheduler at megatick K > 1 one launch of
        the fused kernel's "flush" body with the lane gate (the JAX
        ``_fused_flush``); otherwise single ticks."""
        if self.marker_mode == "ring" and self.megatick > 1:
            return self._fused_steps(s, "flush", self.cfg.max_delay + 1,
                                     live=live)
        b = s.time.shape[0]
        for _ in range(self.cfg.max_delay + 1):
            step = live & (s.error == 0) if self.quarantine else live
            count = int(step.sum())
            if count:
                s = self._single_tick(s, None if count == b else step)
        return s


# ---- streaming-engine primitives (parallel/batch.run_stream) ---------------
# The streaming engine retires finished lanes and admits queued jobs into
# their slots: ``harvest_lane_summaries`` reads every per-job result field
# of a batched state as [B] values (scattered into the results ring before
# the slot is recycled), and ``reset_lanes`` puts a fresh ``init_state``
# into the masked lanes, so that an admitted job starts from exactly the
# state a static run's fresh batch gives it.


def harvest_lane_summaries(state: DenseState, num_nodes: int) -> dict:
    """Per-lane job summary fields (the JAX ``harvest_lane_summaries``):
    the final token balances [B, N] and, each [B], the clock, the error
    bits, the snapshots started, completed on every node and failed by
    the supervisor, the fault skew and the fault events of every class."""
    complete = state.started & (state.completed >= num_nodes)
    return {
        "tokens": state.tokens,
        "time": state.time,
        "error": state.error,
        "snap_started": state.started.sum(-1, dtype=_i32),
        "snap_completed": complete.sum(-1, dtype=_i32),
        "snap_failed": state.snap_failed.sum(-1, dtype=_i32),
        "fault_skew": state.fault_skew,
        "fault_events": state.fault_counts.sum(-1, dtype=_i32),
    }


# leaves reset_lanes leaves as they were: the per-job stream identities
# (the admission overwrites them from the job pool), the lane bookkeeping
# and the flight recorder's ring (a lane artifact that spans admissions)
_RESET_KEEP = ("delay_state", "fault_key", "job_id", "prog_cursor",
               "admit_tick", "tr_meta", "tr_data", "tr_tick", "tr_count",
               "tr_on")


def reset_lanes(state: DenseState, mask, template: DenseState) -> DenseState:
    """Put a fresh state into every lane where ``mask`` [B] holds (the JAX
    ``reset_lanes``): each leaf becomes ``where(mask, template, old)``
    against ``template``, one lane of the port's ``init_state`` (a
    ``DenseState`` with a leading axis of 1, on the state's device), so a
    recycled slot equals a lane of a fresh batch. The leaves of
    ``_RESET_KEEP`` are left untouched. Returns new tensors: the result
    shares no storage with ``template``."""
    def mix(old, tpl):
        m = mask.reshape(mask.shape + (1,) * (old.dim() - 1))
        return torch.where(m, tpl, old)

    return state._replace(**{
        name: mix(getattr(state, name), getattr(template, name))
        for name in DenseState._fields if name not in _RESET_KEEP})


# leaves fork_lanes leaves as they were: reset_lanes' keep-set less
# ``delay_state``, which the fork takes from the checkpoint (the sampler's
# counters advanced during the prefix)
_FORK_KEEP = ("fault_key", "job_id", "prog_cursor", "admit_tick",
              "tr_meta", "tr_data", "tr_tick", "tr_count", "tr_on")


def fork_lanes(state: DenseState, mask, bank: DenseState,
               src) -> DenseState:
    """Put checkpointed prefix states into admitted lanes (the JAX
    ``fork_lanes``): lane b where ``mask`` [B] holds takes every
    simulation leaf from row ``src[b]`` of ``bank`` (a ``DenseState`` with
    an [F] lead axis on the state's device: the decoded prefix-checkpoint
    bank), so it resumes from the phase boundary the checkpoint captured.
    ``delay_state`` is forked; ``fault_key`` (part of the prefix digest,
    so the admitted pool row already equals the checkpoint's) and the
    lane bookkeeping and flight-recorder leaves of ``_FORK_KEEP`` stay as
    they were. Every other lane is left as it was. Returns new tensors."""
    srci = torch.as_tensor(src, device=mask.device).long()

    def mix(old, rows):
        m = mask.reshape(mask.shape + (1,) * (old.dim() - 1))
        return torch.where(m, rows[srci], old)

    updates = {}
    for name in DenseState._fields:
        if name in _FORK_KEEP:
            continue
        old, rows = getattr(state, name), getattr(bank, name)
        updates[name] = (tuple(mix(o, r) for o, r in zip(old, rows))
                         if isinstance(old, tuple) else mix(old, rows))
    return state._replace(**updates)
