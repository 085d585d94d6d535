"""Graph sharding: one giant simulation spread over a mesh of shards.

The port of the JAX package's ``parallel/graphshard.py``. Where the lane
axis (parallel/batch.py) scales the number of independent simulations,
this module scales the size of one: node and edge state split over a
``graph`` mesh axis, the cross-shard effects of every tick carried by
collectives (utils/shardmap.py).

Partition (the JAX invariants): nodes in P contiguous blocks (node i on
shard i // Nl); every edge on its SOURCE node's shard, so the delivery
choice ("first eligible front per source") and all queue state are
local; per-(slot, node) snapshot state on the node's shard, per-(slot,
edge) recording state with the edge. Cross-shard traffic per tick comes
in two engines (``comm_engine``, ``ops/tick.resolve_comm_engine``):

  "dense"   the per-node token credits [N] and marker arrivals [S, N]
            summed over the shards, the created flags [S, N] gathered;
  "sparse"  (the default) the boundary halo exchange: the credits and
            arrivals reduce into each shard's combined segment space
            (its own nodes, then the packed rows it owes each
            neighbour, parallel/mesh.BoundaryTables), only those rows
            move, one exchange per ring distance d = 1..P-1, and the
            created flags come back the same way.

All exchanged quantities are integer sums and boolean ORs, so both
engines equal the unsharded sync scheduler
(``BatchedRunner(scheduler="sync")``) bit for bit; the per-slot
finalisation counts and the error words are summed / ORed too, the
error words at phase and megatick boundaries.

How the port holds the shards (parallel/mesh.Mesh): the tick body is
written once over a LOCAL shard axis — every shard on a ``stacked`` mesh
(the one-card path), this process's one on a ``dist`` mesh — and run on a
flat layout in which the local shards' edges are one axis of Pl * Em
slots and their nodes one of Pl * Nl (a ``[P, S, Em]`` plane is held as
``[B, S, Pl * Em]``, a ring ``[P, Em, C]`` as ``[B, Pl * Em, C]``, with a
lane axis B in front: B = 1 for one instance, the lanes of the data x
graph mode otherwise). On that layout the kernels take the shards as
one segment space: rows 1-3 (``kernels/segment.py``) run over tables
offset by the shard (``seg_perm[p] + p * Em``, ``dst_seg[p] + p * (Nl
+ R + 1)``), rows 4-5 (``kernels/queue.py``) take the rings as [B * Pl,
Em, C] lanes. The entry points take and return the JAX ``ShardedState``
layout (``[P, Nl]``, ``[P, Em, C]``, ``[P, S, Em]``, replicated scalars
and ``[S]`` leaves, ``delay_key`` ``[P, 2]``; ``[B, P, ...]`` batched),
and convert once at entry and exit. A ``dist`` mesh's entry points take
and return this process's shard ([1, ...] on the shard axis); the
replicated leaves are equal on every process.

Control flow that JAX keeps on the device (``lax.cond`` / ``while_loop``
under ``vmap``) is a per-lane mask here: a gated tick or phase is
computed on every lane and the lanes outside the mask are selected back,
the in-place ring appends (row 5) masked to the gated lanes. The drain
reads its mesh-global live gate on the host once per megatick block,
through the named site ``graphshard-drain-gate`` (utils/guards.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from chandy_lamport_tpu_torch.config import ENGINE_KNOBS, SimConfig
from chandy_lamport_tpu_torch.core.state import (
    ERR_CONSERVATION,
    ERR_QUEUE_OVERFLOW,
    ERR_SNAPSHOT_OVERFLOW,
    ERR_SNAPSHOT_TIMEOUT,
    ERR_TICK_LIMIT,
    ERR_TOKEN_UNDERFLOW,
    ERR_VALUE_OVERFLOW,
    F32_EXACT_LIMIT,
    INT32_MAX,
    RTIME_PACK_LIMIT,
    DenseState,
    DenseTopology,
    decode_error_bits,
    pack_meta,
    window_dtype,
)
from chandy_lamport_tpu_torch.kernels import queue as k_queue
from chandy_lamport_tpu_torch.kernels import segment as k_segment
from chandy_lamport_tpu_torch.ops.delay import (
    _lane_cols,
    key_fold_in,
    key_split,
    prng_key,
    randint,
)
from chandy_lamport_tpu_torch.ops.tick import (
    BF16_EXACT_COUNT,
    _flag,
    log_append,
    merge_key_limit,
    merge_keymult,
    resolve_comm_engine,
    resolve_knobs,
    window_update,
)
from chandy_lamport_tpu_torch.parallel.batch import (
    OP_SEND,
    OP_SNAPSHOT,
    compile_events,
)
from chandy_lamport_tpu_torch.parallel.mesh import boundary_tables
from chandy_lamport_tpu_torch.utils import shardmap
from chandy_lamport_tpu_torch.utils.guards import (
    armed,
    guarded_get,
    host_sync,
)
from chandy_lamport_tpu_torch.utils.metrics import (
    _occupied,
    comm_bytes_model,
)
from chandy_lamport_tpu_torch.utils.tracing import (
    EV_SNAP_END,
    EV_SNAP_START,
    EV_SUP_ABORT,
    EV_SUP_FAIL,
    EV_SUP_RETRY,
    armed_config,
    trace_append_many,
)

_i32 = torch.int32
_i64 = torch.int64


class ShardedTopology(NamedTuple):
    """Per-shard topology constants, stacked on the leading shard axis
    (the JAX ``ShardedTopology``; numpy, or tensors from
    ``stopo_device``). The incidence constants ``a_in``, ``a_in_c`` and
    ``a_src_c`` are [P, 1, 1] zeros under both engines: the port's dense
    engine sums through the segment kernels and never builds the
    [P, N, Em] one-hot planes."""

    edge_src: Any    # i32 [P, Em]  global src node id, -1 pad
    edge_dst: Any    # i32 [P, Em]  global dst node id, -1 pad
    a_in: Any        # f32 [P, 1, 1] zeros
    a_in_c: Any      # f32 [P, 1, 1] zeros
    a_src_c: Any     # f32 [P, 1, 1] zeros
    src_first: Any   # i32 [P, Em]  local index of the source's first edge
    dst_seg: Any     # i32 [P, Em]        (parallel/mesh.BoundaryTables)
    seg_perm: Any    # i32 [P, Em]
    seg_lo: Any      # i32 [P, Nl+R+1]
    seg_hi: Any      # i32 [P, Nl+R+1]
    recv_idx: Any    # i32 [P, P-1, H]
    in_degree: Any   # i32 [N] (replicated)


class ShardedScript(NamedTuple):
    """An event script compiled for sharded execution (the JAX
    ``ShardedScript``), numpy int32, every leaf replicated:
      kind  [T, K]  0=nop, 1=send, 2=snapshot
      shard [T, K]  owning shard of a send's edge, -1 otherwise
      loc   [T, K]  send: local edge slot on its shard; snapshot: node
      arg   [T, K]  send: token amount
      do_tick [T]   ticks after the phase
    """

    kind: Any
    shard: Any
    loc: Any
    arg: Any
    do_tick: Any


class ShardedState(NamedTuple):
    """One giant instance, sharded on the leading axis of every leaf but
    the replicated ones (the JAX ``ShardedState``: fields, order, shapes
    and dtypes; module docstring for the port's layouts). The delay keys
    are int64 words in [0, 2^32), uint32 on the host (``state_to_numpy``),
    and uint16 window planes int16 bit patterns, as in the port's
    ``DenseState``."""

    time: Any        # i32 [] (replicated)
    tokens: Any      # i32 [P, Nl]
    q_data: Any      # i32 [P, Em, C]
    q_meta: Any      # i32 [P, Em, C]  rtime << 1 (never a marker here)
    q_head: Any      # i32 [P, Em]
    q_len: Any       # i32 [P, Em]
    tok_pushed: Any  # i32 [P, Em]
    mk_cnt: Any      # i32 [P, Em]
    m_pending: Any   # bool [P, S, Em]
    m_rtime: Any     # i32 [P, S, Em]
    m_key: Any       # i32 [P, S, Em]
    next_sid: Any    # i32 [] (replicated)
    started: Any     # bool [S] (replicated)
    has_local: Any   # bool [P, S, Nl]
    frozen: Any      # i32 [P, S, Nl]
    rem: Any         # i32 [P, S, Nl]
    done_local: Any  # bool [P, S, Nl]
    recording: Any   # bool [P, S, Em]
    rec_cnt: Any     # i32 [P, Em]
    min_prot: Any    # i32 [P, Em]
    log_amt: Any     # record dtype [P, L, Em]
    rec_start: Any   # window dtype [P, S, Em]
    rec_end: Any     # window dtype [P, S, Em]
    completed: Any   # i32 [S] (replicated)
    snap_epoch: Any      # i32 [S] (replicated)
    snap_deadline: Any   # i32 [S] (replicated; 0 = unarmed)
    snap_retries: Any    # i32 [S] (replicated)
    snap_initiator: Any  # i32 [S] (replicated; -1 = unset)
    snap_failed: Any     # bool [S] (replicated)
    snap_done_time: Any  # i32 [S] (replicated; -1 until completed)
    tr_meta: Any     # i32 [K] (replicated: global protocol events only)
    tr_data: Any     # i32 [K]
    tr_tick: Any     # i32 [K]
    tr_count: Any    # i32 []
    tr_on: Any       # i32 []
    delay_key: Any   # u32 [P, 2] per-shard threefry key (int64 words)
    error: Any       # i32 [] (replicated)


# the leaves by layout: [P, X, Y] planes held as [X, Pl*Y]; rings as
# [Pl*Em, C]; per-node and per-edge rows as [Pl*N]; the keys as [Pl, 2];
# the rest replicated
_PLANES = frozenset(("m_pending", "m_rtime", "m_key", "has_local", "frozen",
                     "rem", "done_local", "recording", "log_amt",
                     "rec_start", "rec_end"))
_RINGS = frozenset(("q_data", "q_meta"))
_ROWS = frozenset(("tokens", "q_head", "q_len", "tok_pushed", "mk_cnt",
                   "rec_cnt", "min_prot"))
_SHARDED = _PLANES | _RINGS | _ROWS | {"delay_key"}
_WINDOWS = frozenset(("rec_start", "rec_end"))


def state_to_numpy(state: ShardedState) -> ShardedState:
    """A ``ShardedState`` (single or batched) as numpy leaves in the JAX
    dtypes: the keys as uint32, int16 window planes as uint16."""
    out = []
    for name, leaf in zip(ShardedState._fields, state):
        a = leaf.cpu().numpy()
        if name == "delay_key":
            a = a.astype(np.uint32)
        elif name in _WINDOWS and a.dtype == np.int16:
            a = a.view(np.uint16)
        out.append(a)
    return ShardedState(*out)


def state_from_numpy(host: ShardedState, device) -> ShardedState:
    """A host ``ShardedState`` (numpy leaves, e.g. a JAX state fetched
    with ``jax.device_get``, single or batched) as the port's on
    ``device``: uint32 widens to int64, uint16 is read as int16 bits."""
    out = []
    for leaf in host:
        a = np.array(leaf)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        elif a.dtype == np.uint16:
            a = a.view(np.int16)
        out.append(torch.from_numpy(a).to(device))
    return ShardedState(*out)


def shard_topology(topo: DenseTopology, shards: int):
    """Partition nodes into contiguous blocks and edges by source shard,
    padding every shard's edge arrays to the largest local count (the
    JAX ``shard_topology`` with ``incidence=False``; its per-edge loops
    vectorised). Returns (ShardedTopology, Em, BoundaryTables)."""
    n, e = topo.n, topo.e
    if n % shards:
        raise ValueError(f"nodes ({n}) must divide evenly into {shards} "
                         "shards")
    nl = n // shards
    shard_of = topo.edge_src // nl
    counts = np.bincount(shard_of, minlength=shards)
    em = int(counts.max()) if e else 1
    # edges are (src, dst)-sorted, so each shard's edges are one
    # contiguous run of the global order
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    local = np.arange(e) - start[shard_of]
    edge_src = np.full((shards, em), -1, np.int32)
    edge_dst = np.full((shards, em), -1, np.int32)
    edge_src[shard_of, local] = topo.edge_src
    edge_dst[shard_of, local] = topo.edge_dst
    src_first = np.tile(np.arange(em, dtype=np.int32), (shards, 1))
    first = np.searchsorted(topo.edge_src, topo.edge_src, side="left")
    src_first[shard_of, local] = first - start[shard_of]
    bt = boundary_tables(edge_src, edge_dst, shards, nl)
    zeros = np.zeros((shards, 1, 1), np.float32)
    return ShardedTopology(
        edge_src=edge_src, edge_dst=edge_dst, a_in=zeros, a_in_c=zeros,
        a_src_c=zeros, src_first=src_first, dst_seg=bt.dst_seg,
        seg_perm=bt.seg_perm, seg_lo=bt.seg_lo, seg_hi=bt.seg_hi,
        recv_idx=bt.recv_idx, in_degree=topo.in_degree.astype(np.int32),
    ), em, bt


def _select(lanes, new: ShardedState, old: ShardedState) -> ShardedState:
    """``where(lanes, new, old)`` per lane over every leaf; a leaf the
    step left as it was (the same tensor, or one it wrote in place on
    the gated lanes only) is kept."""
    return ShardedState(*(a if a is b else torch.where(_lane_cols(lanes, a),
                                                       a, b)
                          for a, b in zip(new, old)))


class GraphShardedRunner:
    """Storm programs and event scripts for one giant instance over a
    graph mesh (the JAX ``GraphShardedRunner``): the semantics of
    ``BatchedRunner(scheduler="sync")`` at batch 1, bit for bit, every
    array split over the ``axis`` of ``mesh`` (parallel/mesh.Mesh, stacked
    or dist) and the tick communicating through utils/shardmap.py.

    The constructor takes the JAX keywords in the JAX positions, with the
    JAX refusals: ``check_every < 0``, ``megatick < 1``, a node count that
    does not divide by the shard count and ``fused_tick="on"`` (a kernel
    body cannot hold the halo exchange) raise ValueError.

    ``fixed_delay``: a constant delay instead of the per-shard threefry
    stream (``ops/delay.UniformDelay``'s draws on keys ``fold_in(
    PRNGKey(seed), shard)``). ``check_every`` K > 0: the conservation
    check every K storm phases and after the drain (ERR_CONSERVATION).
    ``megatick`` K: the drain runs K gated ticks per block and reads its
    live gate once per block; results equal K = 1, except under
    quarantine, whose gate reads the error word folded at the last block
    boundary (up to K-1 ticks stale, as in JAX). ``quarantine``: the
    instance (or lane) stops at its first error bit. ``trace``: the
    replicated flight recorder (snapshot starts and ends, supervisor
    actions). ``guards``: utils/guards.RuntimeGuards arms the storm and
    script dispatches. ``queue_engine``, ``kernel_engine`` and
    ``comm_engine`` (None: the config's) resolve as the JAX knobs do, the
    first two to what the port runs (``ops/tick.resolve_knobs``);
    ``fused_tile`` resolves "off" and ``fused_block_edges`` moves nothing
    (no fused kernel here). ``topology``: a TopologySpec, or a
    DenseTopology already built from one."""

    def __init__(self, topology, config: Optional[SimConfig], mesh,
                 axis: str = "graph", seed: int = 0, max_delay: int = 5,
                 fixed_delay: Optional[int] = None, check_every: int = 0,
                 queue_engine: str = "auto",
                 comm_engine: Optional[str] = None,
                 kernel_engine: Optional[str] = None, megatick: int = 1,
                 quarantine: bool = False, trace=None, guards=None,
                 fused_tick: Optional[str] = None,
                 fused_block_edges: int = 0,
                 fused_tile: Optional[str] = None):
        self.topo = (topology if isinstance(topology, DenseTopology)
                     else DenseTopology(topology))
        self.config = config or SimConfig()
        self.guards = guards
        self.mesh = mesh
        self.axis = axis
        self.shards = mesh.shape[axis]
        if mesh.backend == "stacked" and len(mesh.devices) != 1:
            raise ValueError("a stacked mesh holds every shard on one "
                             f"device; this one has {len(mesh.devices)}")
        self.device = mesh.device
        self.seed = seed
        if check_every < 0:
            raise ValueError("check_every must be >= 0 (0 = off)")
        self.check_every = int(check_every)
        self.quarantine = bool(quarantine)
        self.comm_engine = resolve_comm_engine(
            self.config.comm_engine if comm_engine is None else comm_engine)
        degree = max(int(self.topo.in_degree.max()) if self.topo.e else 0,
                     self.topo.d)
        if (self.config.count_dtype == "bfloat16"
                and degree > BF16_EXACT_COUNT):
            raise ValueError(f"count_dtype=bfloat16 is not exact: degree "
                             f"bound {degree} > {BF16_EXACT_COUNT}")
        knobs = resolve_knobs(self.topo, self.config, self.device,
                              queue_engine, kernel_engine)
        for knob in ("queue_engine", "kernel_engine"):
            setattr(self, knob, knobs[knob][0])
            setattr(self, f"{knob}_reason", knobs[knob][1])
        ft = self.config.fused_tick if fused_tick is None else fused_tick
        if ft not in ENGINE_KNOBS["fused_tick"]:
            raise ValueError(f"unknown fused_tick {ft!r}")
        if ft == "on":
            raise ValueError(
                "fused_tick='on' impossible: the sharded tick exchanges "
                "boundary rows (halo/psum) inside every tick body, which "
                "a single Pallas kernel cannot contain")
        self.fused = "off"
        self.fused_reason = ("sharded tick crosses shard boundaries "
                             "inside the tick body")
        tile = self.config.fused_tile if fused_tile is None else fused_tile
        if tile not in ENGINE_KNOBS["fused_tile"]:
            raise ValueError(f"unknown fused_tile {tile!r}")
        self.fused_tile = "off"
        self.fused_tile_reason = (f"fused_tile={tile!r}: no fused kernel "
                                  "on the sharded tick to tile")
        self.fused_block_edges = int(fused_block_edges)
        if megatick < 1:
            raise ValueError("megatick must be >= 1")
        self.megatick = int(megatick)
        self._sup = bool(self.config.snapshot_timeout > 0
                         or self.config.snapshot_every > 0)
        self.max_delay = fixed_delay if fixed_delay is not None else max_delay
        self.fixed_delay = fixed_delay
        if self.config.max_delay != self.max_delay:
            self.config = dataclasses.replace(self.config,
                                              max_delay=self.max_delay)
        self.trace = trace
        self.config = armed_config(self.config, trace)
        self._trace_on = (trace is not None
                          and self.config.trace_capacity > 0)
        self._rec_dtype = getattr(torch, self.config.record_dtype)
        self._rec_limit = torch.iinfo(self._rec_dtype).max
        self._win_dtype = window_dtype(self.config)
        self._keymult = merge_keymult(self.config.max_snapshots)
        self._key_limit = merge_key_limit(self.config.max_snapshots)
        self.stopo, self.em, self._bt = shard_topology(self.topo,
                                                       self.shards)
        self.nl = self.topo.n // self.shards
        self.halo = self._bt.halo
        # global edge -> (owning shard, local slot), for shard_program,
        # the script compiler and gather_dense
        self.edge_shard = (self.topo.edge_src // self.nl).astype(np.int32)
        counts = np.bincount(self.edge_shard, minlength=self.shards)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self.edge_local = (np.arange(self.topo.e)
                           - start[self.edge_shard]).astype(np.int32)
        p, em = self.shards, self.em
        width = self.nl + (p - 1) * self.halo + 1
        for what, size in (("P*Em*C", p * em * self.config.queue_capacity),
                           ("P*(Nl+R+1)", p * width)):
            if size >= 2**31:
                raise ValueError(f"{what} = {size} passes the int32 flat "
                                 "index range of the sharded layout")
        self._tokens0_total = int(self.topo.tokens0.sum())
        self._tables()

    # -- tables on the device, flat over the local shards ----------------

    def _tables(self) -> None:
        mesh, st = self.mesh, self.stopo
        p, em, nl, n = self.shards, self.em, self.nl, self.topo.n
        if mesh.backend == "stacked":
            loc = np.arange(p)
        else:
            loc = np.array([mesh.index(self.axis)])
        self._local = loc
        self._pl = pl = len(loc)
        self._node_lo = int(loc[0]) * nl
        dev = self.device

        def t(x, dtype=_i32):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=dev)

        es, ed = st.edge_src[loc], st.edge_dst[loc]
        valid = es >= 0
        off_e = (np.arange(pl) * em)[:, None]
        self._t_valid = t(valid.ravel(), torch.bool)
        self._t_src_first = t((st.src_first[loc] + off_e).ravel())
        self._t_dst_clip = t(np.clip(ed, 0, n - 1).ravel())
        self._t_src_clip = t(np.clip(es, 0, n - 1).ravel())
        src_l = np.clip(es - (loc * nl)[:, None], 0, nl - 1)
        self._t_src_l = t((src_l + (np.arange(pl) * nl)[:, None]).ravel())
        # each local node's outbound edges: a contiguous run of its shard
        # (edges keep source order), offset to the flat edge axis
        lo = np.empty((pl, nl), np.int64)
        hi = np.empty((pl, nl), np.int64)
        for i in range(pl):
            bounds = np.concatenate([[0], np.cumsum(np.bincount(
                src_l[i][valid[i]], minlength=nl))])
            lo[i], hi[i] = bounds[:-1] + i * em, bounds[1:] + i * em
        self._t_dlo, self._t_dhi = t(lo.ravel()), t(hi.ravel())
        self._t_in_deg = t(self.topo.in_degree[
            self._node_lo:self._node_lo + pl * nl])
        self._node_ids = torch.arange(n, dtype=_i32, device=dev)
        self._slot_ids = torch.arange(self.config.max_snapshots, dtype=_i32,
                                      device=dev)
        if self.comm_engine == "sparse":
            width = nl + (p - 1) * self.halo + 1
            self._width = width
            self._t_seg_perm = t((st.seg_perm[loc] + off_e).ravel())
            self._t_seg_lo = t((st.seg_lo[loc] + off_e).ravel())
            self._t_seg_hi = t((st.seg_hi[loc] + off_e).ravel())
            self._t_dst_seg = t((st.dst_seg[loc]
                                 + (np.arange(pl) * width)[:, None]).ravel())
            self._t_recv_idx = t(st.recv_idx[loc].reshape(pl, -1), _i64)
        else:
            # the local edges by global destination, pads in a last
            # (trash) segment: one segment sum gives the shards' share of
            # every node's credit and arrivals
            keys = np.where(valid, ed, n).ravel()
            perm = np.argsort(keys, kind="stable")
            bounds = np.concatenate([[0], np.cumsum(np.bincount(
                keys, minlength=n + 1))])
            self._t_dn_perm = t(perm)
            self._t_dn_lo, self._t_dn_hi = t(bounds[:-1]), t(bounds[1:])

    # -- state construction ----------------------------------------------

    def init_state(self) -> ShardedState:
        """A fresh instance in the JAX layout, this process's shards
        (every shard on a stacked mesh), with per-shard keys
        ``fold_in(PRNGKey(seed), shard)``."""
        cfg, topo, dev = self.config, self.topo, self.device
        loc, pl, em, nl = self._local, self._pl, self.em, self.nl
        c, s, m, k = (cfg.queue_capacity, cfg.max_snapshots,
                      cfg.max_recorded, cfg.trace_capacity)

        def z(*shape, dtype=_i32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def full(value, *shape):
            return torch.full(shape, value, dtype=_i32, device=dev)

        shard_ids = torch.as_tensor(loc, dtype=_i64, device=dev)
        keys = key_fold_in(prng_key(self.seed, self.device).expand(pl, 2), shard_ids)
        tokens = topo.tokens0.reshape(self.shards, nl)[loc]
        return ShardedState(
            time=z(), tokens=torch.as_tensor(tokens.copy(), device=dev),
            q_data=z(pl, em, c), q_meta=z(pl, em, c), q_head=z(pl, em),
            q_len=z(pl, em), tok_pushed=z(pl, em), mk_cnt=z(pl, em),
            m_pending=z(pl, s, em, dtype=torch.bool), m_rtime=z(pl, s, em),
            m_key=z(pl, s, em), next_sid=z(), started=z(s, dtype=torch.bool),
            has_local=z(pl, s, nl, dtype=torch.bool), frozen=z(pl, s, nl),
            rem=z(pl, s, nl), done_local=z(pl, s, nl, dtype=torch.bool),
            recording=z(pl, s, em, dtype=torch.bool), rec_cnt=z(pl, em),
            min_prot=full(INT32_MAX, pl, em),
            log_amt=z(pl, m, em, dtype=self._rec_dtype),
            rec_start=z(pl, s, em, dtype=self._win_dtype),
            rec_end=z(pl, s, em, dtype=self._win_dtype), completed=z(s),
            snap_epoch=z(s), snap_deadline=z(s), snap_retries=z(s),
            snap_initiator=full(-1, s), snap_failed=z(s, dtype=torch.bool),
            snap_done_time=full(-1, s), tr_meta=z(k), tr_data=z(k),
            tr_tick=z(k), tr_count=z(), tr_on=full(1), delay_key=keys,
            error=z())

    def init_batch(self, batch: int, data_axis: str = "data"):
        """The data x graph mode's state: every leaf gains a leading lane
        axis ([B, P, ...] sharded, [B, ...] replicated), with
        per-(lane, shard) keys ``fold_in(PRNGKey(seed), lane * P +
        shard)``. The lanes must divide by the mesh's ``data_axis`` (as
        JAX's sharding requires); a dist mesh holds its data block of
        them."""
        d = self.mesh.shape.get(data_axis, 1)
        if batch % d:
            raise ValueError(f"batch {batch} does not divide into {d} "
                             f"'{data_axis}' blocks")
        lanes = np.arange(batch)
        if self.mesh.backend == "dist" and data_axis in self.mesh.shape:
            per = batch // d
            first = self.mesh.index(data_axis) * per
            lanes = lanes[first:first + per]
        single = self.init_state()
        b = len(lanes)
        out = ShardedState(*(x.unsqueeze(0).expand((b,) + tuple(x.shape))
                             .clone() for x in single))
        ids = (torch.as_tensor(lanes, dtype=_i64, device=self.device)
               [:, None] * self.shards
               + torch.as_tensor(self._local, dtype=_i64,
                                 device=self.device)[None, :])
        keys = key_fold_in(prng_key(self.seed, self.device).expand(b, self._pl, 2), ids)
        return out._replace(delay_key=keys)

    def shard_program(self, amounts: np.ndarray, snap: np.ndarray):
        """A StormProgram's [T, E] amounts split into per-shard [T, P, Em]
        (this process's shards) and the snapshot schedule [T, J], both on
        the runner's device."""
        t = amounts.shape[0]
        out = np.zeros((t, self.shards, self.em), np.int32)
        out[:, self.edge_shard, self.edge_local] = amounts
        return (torch.as_tensor(out[:, self._local], device=self.device),
                torch.as_tensor(np.asarray(snap, np.int32),
                                device=self.device))

    def compile_script(self, events) -> ShardedScript:
        """Compile an event script for sharded execution: the dense
        compiler (parallel/batch.compile_events), then each send's global
        edge remapped to (owning shard, local slot); numpy, replicated."""
        ops = compile_events(self.topo, events)
        kind, arg0 = np.asarray(ops.kind), np.asarray(ops.arg0)
        e_safe = np.clip(arg0, 0, max(self.topo.e - 1, 0))
        shard = np.where(kind == OP_SEND, self.edge_shard[e_safe], -1)
        loc = np.where(kind == OP_SEND, self.edge_local[e_safe],
                       np.where(kind == OP_SNAPSHOT, arg0, 0))
        return ShardedScript(*(np.asarray(x, np.int32) for x in (
            kind, shard, loc, ops.arg1, ops.do_tick)))

    # -- the flat layout ---------------------------------------------------

    @staticmethod
    def _flat(state: ShardedState, batched: bool) -> ShardedState:
        """The entry layout -> a private copy in the flat layout (module
        docstring), with a lane axis."""
        out = []
        for name, x in zip(ShardedState._fields, state):
            if not batched:
                x = x.unsqueeze(0)
            b = x.shape[0]
            if name in _PLANES:
                x = x.transpose(1, 2).clone(
                    memory_format=torch.contiguous_format).view(
                        b, x.shape[2], -1)
            elif name in _RINGS:
                x = x.reshape(b, -1, x.shape[-1]).clone()
            elif name in _ROWS:
                x = x.reshape(b, -1).clone()
            else:
                x = x.clone()
            out.append(x)
        return ShardedState(*out)

    def _unflat(self, s: ShardedState, batched: bool) -> ShardedState:
        pl = self._pl
        out = []
        for name, x in zip(ShardedState._fields, s):
            b = x.shape[0]
            if name in _PLANES:
                x = x.view(b, x.shape[1], pl, -1).transpose(1, 2).contiguous()
            elif name in _RINGS:
                x = x.view(b, pl, -1, x.shape[-1])
            elif name in _ROWS:
                x = x.view(b, pl, -1)
            out.append(x if batched else x[0])
        return ShardedState(*out)

    # -- collective helpers ------------------------------------------------

    def _my_slice(self, x):
        """This process's [..., Pl*Nl] block of a replicated [..., N]."""
        return x[..., self._node_lo:self._node_lo + self._pl * self.nl]

    def _fold_err(self, s: ShardedState, erl) -> ShardedState:
        """Union the deferred error bits (``erl`` [B], already ORed over
        the local shards) into the replicated sticky word across the
        shards, bit by bit."""
        return s._replace(error=s.error | shardmap.por(erl, self.mesh,
                                                       self.axis))

    def _erl(self, s: ShardedState):
        return torch.zeros_like(s.error)

    # -- kernel pieces -----------------------------------------------------

    def _draw(self, s: ShardedState, shape: str):
        """Receive times for every local shard (the JAX ``_draw_many``):
        ``time + fixed_delay``, or each shard's key split in two, the
        first half kept, ``time + 1 + randint(second, 0, max_delay)``
        drawn per shard. ``shape``: "edge" ([B, Pl*Em]), "slot" ([B, S,
        Pl*Em]) or "shard" ([B, Pl]). Returns (rt, state)."""
        b, pl = s.delay_key.shape[:2]
        t = s.time
        if self.fixed_delay is not None:
            rt = t + self.fixed_delay
            return rt.view((b,) + {"edge": (1,), "slot": (1, 1),
                                    "shard": (1,)}[shape]), s
        per = {"edge": (self.em,),
               "slot": (self.config.max_snapshots, self.em),
               "shard": ()}[shape]
        keys = key_split(s.delay_key)
        d = randint(keys[..., 1, :], per, 0, self.max_delay)  # [B, Pl, *per]
        rt = t.view((b, 1) + (1,) * len(per)) + 1 + d
        if shape == "edge":
            rt = rt.reshape(b, -1)
        elif shape == "slot":
            rt = rt.transpose(1, 2).reshape(b, per[0], -1)
        return rt, s._replace(delay_key=keys[..., 0, :].contiguous())

    def _ring_views(self, s: ShardedState):
        """The rings as [B*Pl, Em, C] lanes and their counters as [B*Pl,
        Em] (views of the state's tensors)."""
        rows = s.q_head.shape[0] * self._pl
        c = self.config.queue_capacity
        return (s.q_meta.view(rows, self.em, c),
                s.q_data.view(rows, self.em, c),
                *(x.view(rows, self.em)
                  for x in (s.q_head, s.q_len, s.tok_pushed)))

    def _head_fields(self, s: ShardedState):
        """Every local ring head's (rtime, amount), [B, Pl*Em] (row 4)."""
        q_meta, q_data, q_head = self._ring_views(s)[:3]
        rt, _, amt = k_queue.head_fields(q_meta, q_data, q_head)
        b = s.q_head.shape[0]
        return rt.view(b, -1), amt.view(b, -1)

    def _append_active(self, s: ShardedState, active, rt_e, data_e):
        """The shard-local ring append of one token on every ``active``
        [B, Pl*Em] edge (row 5, in place, ``flag_queue_overflow=False``:
        the caller books queue overflow). Returns (state, the lanes'
        value-overflow bits [B])."""
        b, pe = active.shape
        rows = b * self._pl
        q_meta, q_data, q_head, q_len, pushed = self._ring_views(s)
        err = torch.zeros(rows, dtype=_i32, device=self.device)

        def lanes(x):
            return x.expand(b, pe).reshape(rows, self.em)

        k_queue.append_rows(q_meta, q_data, q_head, q_len, pushed, err,
                            lanes(active), lanes(rt_e), False,
                            lanes(data_e), capacity=self.config.queue_capacity,
                            key_limit=self._key_limit,
                            flag_queue_overflow=False)
        return s, shardmap.bits_or(err.view(b, self._pl), -1)

    def _trace(self, s, mask, kind, actor, payload):
        with host_sync("graphshard-recorder"):
            return trace_append_many(s, mask, kind, actor, payload)

    def _push_markers_split(self, s: ShardedState, push_se,
                            lanes=None) -> ShardedState:
        """Set the pending planes where ``push_se`` [B, S, Pl*Em], merge
        keys in slot order per edge; every local shard's key splits once
        (lanes outside ``lanes`` keep theirs)."""
        rts, s2 = self._draw(s, "slot")
        push_i = push_se.to(_i32)
        off = torch.cumsum(push_i, dim=-2, dtype=_i32) - push_i
        key_se = (s.tok_pushed * self._keymult + s.mk_cnt).unsqueeze(-2) + off
        s2 = s2._replace(
            m_pending=s.m_pending | push_se,
            m_rtime=torch.where(push_se, rts, s.m_rtime),
            m_key=torch.where(push_se, key_se, s.m_key),
            mk_cnt=s.mk_cnt + push_i.sum(-2, dtype=_i32))
        if lanes is not None and s2.delay_key is not s.delay_key:
            s2 = s2._replace(delay_key=torch.where(
                _lane_cols(lanes, s.delay_key), s2.delay_key, s.delay_key))
        return s2

    def _create_and_broadcast(self, s: ShardedState, created,
                              lanes=None) -> ShardedState:
        """Freeze, record and broadcast for every created (lane, slot,
        node) of ``created`` [B, S, N] (replicated): the edges' endpoint
        flags by spread (row 3); lanes outside ``lanes`` (whose
        ``created`` is empty) keep their keys."""
        valid = self._t_valid
        created_dst_se = k_segment.spread(created, self._t_dst_clip) & valid
        push_se = k_segment.spread(created, self._t_src_clip) & valid
        created_l = self._my_slice(created)
        s = s._replace(
            recording=s.recording | created_dst_se,
            frozen=torch.where(created_l, s.tokens.unsqueeze(-2), s.frozen),
            rem=torch.where(created_l, self._t_in_deg, s.rem),
            has_local=s.has_local | created_l,
            **window_update(s, created_dst_se, None, s.rec_cnt))
        return self._push_markers_split(s, push_se, lanes)

    def _bulk_send(self, s: ShardedState, amounts, erl, lanes=None):
        """amounts [Pl*Em] (sends leave from this process's sources; pads
        carry 0): debit the senders by segment sums over their contiguous
        edge runs (row 2), then append (row 5). The guard flags
        ERR_VALUE_OVERFLOW where an amount or a sender's debit reaches
        2^24, the JAX f32 verdict. Returns (state, erl)."""
        b = s.time.shape[0]
        active = amounts > 0
        debits = k_segment.sum_segments(amounts, self._t_dlo, self._t_dhi)
        tokens = s.tokens - debits
        act = active.expand(b, -1)
        if lanes is not None:
            tokens = torch.where(lanes.unsqueeze(-1), tokens, s.tokens)
            act = act & lanes.unsqueeze(-1)
        big = (amounts >= F32_EXACT_LIMIT).any() | (
            debits >= F32_EXACT_LIMIT).any()
        err = (_flag((tokens < 0).any(-1), ERR_TOKEN_UNDERFLOW)
               | _flag((act & (s.q_len >= self.config.queue_capacity))
                       .any(-1), ERR_QUEUE_OVERFLOW)
               | _flag(big.expand(b), ERR_VALUE_OVERFLOW))
        rts, s = self._draw(s._replace(tokens=tokens), "edge")
        s, err_app = self._append_active(s, act, rts, amounts)
        return s, erl | err | err_app

    def _bulk_snapshots(self, s: ShardedState, init_mask,
                        lanes=None) -> ShardedState:
        """Start a snapshot at every node of ``init_mask`` ([N] or [B,
        N], replicated), ids in node order (the JAX ``_bulk_snapshots``);
        on the lanes of ``lanes`` only (None: all)."""
        S, n = self.config.max_snapshots, self.topo.n
        b = s.time.shape[0]
        init = init_mask.expand(b, n)
        if lanes is not None:
            init = init & lanes.unsqueeze(-1)
        count = init.sum(-1, dtype=_i32)
        rank = torch.cumsum(init.to(_i32), dim=-1, dtype=_i32) - 1
        sid_n = s.next_sid.unsqueeze(-1) + rank
        created = init.unsqueeze(-2) & (sid_n.unsqueeze(-2)
                                        == self._slot_ids[:, None])
        over = s.next_sid + count > S
        if lanes is not None:
            over = over & lanes
        s = s._replace(next_sid=s.next_sid + count,
                       started=s.started | created.any(-1),
                       error=s.error | _flag(over, ERR_SNAPSHOT_OVERFLOW))
        if self._sup:
            any_c = created.any(-1)
            init_n = torch.where(created, self._node_ids, n).amin(-1).clamp(
                max=n - 1).to(_i32)
            s = s._replace(snap_initiator=torch.where(any_c, init_n,
                                                      s.snap_initiator))
            if self.config.snapshot_timeout:
                s = s._replace(snap_deadline=torch.where(
                    any_c, s.time.unsqueeze(-1)
                    + self.config.snapshot_timeout, s.snap_deadline))
        if self._trace_on:
            s = self._trace(s, created, EV_SNAP_START, self._node_ids,
                            self._slot_ids[:, None])
        return self._create_and_broadcast(s, created, lanes)

    def _inject_send(self, s: ShardedState, shard: int, loc: int, amt: int,
                     active: bool, erl):
        """One script send (host ints): every local shard draws, only the
        owning shard debits and enqueues (the JAX ``_inject_send_local``).
        Writes the owned flat state in place. Returns (state, erl)."""
        rt, s = self._draw(s, "shard")
        where = np.flatnonzero(self._local == shard)
        if not active or not len(where):
            return s, erl
        i = int(where[0])
        b = s.time.shape[0]
        e_loc = min(max(int(loc), 0), self.em - 1)
        e = i * self.em + e_loc
        src = int(self.stopo.edge_src[shard, e_loc])
        src_l = i * self.nl + min(max(src - shard * self.nl, 0), self.nl - 1)
        c = self.config.queue_capacity
        rt_b = rt.expand(b, self._pl)[:, i]
        pushed = s.tok_pushed[:, e]
        err = (_flag(s.tokens[:, src_l] < amt, ERR_TOKEN_UNDERFLOW)
               | _flag(s.q_len[:, e] >= c, ERR_QUEUE_OVERFLOW)
               | (ERR_VALUE_OVERFLOW if amt >= F32_EXACT_LIMIT else 0)
               | _flag((pushed >= self._key_limit)
                       | (rt_b >= RTIME_PACK_LIMIT), ERR_VALUE_OVERFLOW))
        pos = ((s.q_head[:, e] + s.q_len[:, e]) % c).to(_i64)
        rows = torch.arange(b, device=self.device)
        s.tokens[:, src_l] -= amt
        s.q_data[rows, e, pos] = amt
        s.q_meta[rows, e, pos] = pack_meta(rt_b, False)
        s.q_len[:, e] += 1
        s.tok_pushed[:, e] += 1
        return s, erl | err

    def _supervise(self, s: ShardedState) -> ShardedState:
        """The snapshot supervisor (the JAX ``_supervise``): the daemon's
        initiation, then the timeout scan: abort (plane clears), retry
        through the create+broadcast, or ERR_SNAPSHOT_TIMEOUT once the
        retries are spent. Every predicate is replicated."""
        cfg = self.config
        S, n = cfg.max_snapshots, self.topo.n
        if cfg.snapshot_every:
            every = cfg.snapshot_every
            node = (s.time // every) % n
            fire = (s.time % every == 0) & (s.time > 0) & (s.next_sid < S)
            mask = fire.unsqueeze(-1) & (self._node_ids == node.unsqueeze(-1))
            s = self._bulk_snapshots(s, mask, lanes=fire)
        if not cfg.snapshot_timeout:
            return s
        timed_out = (s.started & ~s.snap_failed & (s.completed < n)
                     & (s.snap_deadline > 0)
                     & (s.time.unsqueeze(-1) >= s.snap_deadline))
        can_retry = timed_out & (s.snap_retries < cfg.snapshot_retries)
        failed = timed_out & ~can_retry
        t_b = timed_out.unsqueeze(-1)
        new_retries = s.snap_retries + can_retry.to(_i32)
        backoff = torch.full_like(new_retries, max(cfg.snapshot_timeout, 1)) \
            << new_retries.clamp(max=4)
        zero_w = torch.zeros((), dtype=s.rec_start.dtype, device=self.device)
        s = s._replace(
            has_local=s.has_local & ~t_b,
            done_local=s.done_local & ~t_b,
            frozen=torch.where(t_b, 0, s.frozen),
            rem=torch.where(t_b, 0, s.rem),
            recording=s.recording & ~t_b,
            rec_start=torch.where(t_b, zero_w, s.rec_start),
            rec_end=torch.where(t_b, zero_w, s.rec_end),
            completed=torch.where(timed_out, 0, s.completed),
            m_pending=s.m_pending & ~t_b,
            snap_epoch=s.snap_epoch + timed_out.to(_i32),
            snap_retries=new_retries,
            snap_failed=s.snap_failed | failed,
            snap_deadline=torch.where(
                can_retry, s.time.unsqueeze(-1) + backoff,
                torch.where(failed, 0, s.snap_deadline)),
            error=s.error | _flag(failed.any(-1), ERR_SNAPSHOT_TIMEOUT))
        init_n = s.snap_initiator.clamp(0, n - 1)
        if self._trace_on:
            for mask, kind in ((timed_out, EV_SUP_ABORT),
                               (can_retry, EV_SUP_RETRY),
                               (failed, EV_SUP_FAIL)):
                s = self._trace(s, mask, kind, init_n, self._slot_ids)
        created = can_retry.unsqueeze(-1) & (self._node_ids
                                             == init_n.unsqueeze(-1))
        return self._create_and_broadcast(s, created,
                                          lanes=can_retry.any(-1))

    def _sparse_reduce_exchange(self, amt, mk_se):
        """The sparse engine's forward half: one [B, S+1, Pl*Em] payload
        (row 0 the token amounts, rows 1.. the marker arrivals) summed
        into the shards' combined segment spaces (row 1), then for each
        ring distance d one exchange of the [S+1, H] rows owed to shard
        p + d, added into the local planes through ``recv_idx`` (pad rows
        land in a dropped column). Returns (credit [B, Pl*Nl], arrivals
        [B, S, Pl*Nl])."""
        b, S = amt.shape[0], self.config.max_snapshots
        pl, nl, h, p = self._pl, self.nl, self.halo, self.shards
        payload = torch.cat([amt.unsqueeze(1), mk_se.to(_i32)], dim=1)
        segs = k_segment.sum_by_perm(payload, self._t_seg_perm,
                                     self._t_seg_lo, self._t_seg_hi)
        segs = segs.view(b, S + 1, pl, self._width)
        local = segs[..., :nl]
        if p > 1 and h:
            r = (p - 1) * h
            out = segs[..., nl:nl + r].reshape(b, S + 1, pl, p - 1, h)
            recv = torch.stack([
                shardmap.ppermute(out[..., d - 1, :], self.mesh, self.axis,
                                  d, dim=2) for d in range(1, p)], dim=3)
            buf = torch.cat([local, local.new_zeros(b, S + 1, pl, 1)], -1)
            buf.scatter_add_(-1, self._t_recv_idx.expand(b, S + 1, pl, r),
                             recv.reshape(b, S + 1, pl, r))
            local = buf[..., :nl]
        return (local[:, 0].reshape(b, pl * nl),
                local[:, 1:].reshape(b, S, pl * nl))

    def _sparse_created_spread(self, created_l):
        """The reverse half: the created flags of the rows each shard
        received credit for go back to their senders (the same
        ``recv_idx`` gathers them, pad rows False), and ``dst_seg`` reads
        every edge's destination flag from [own flags ++ received blocks
        ++ one zero column] (row 3); the source side is local (row 3).
        Returns (created_dst_se, push_se), [B, S, Pl*Em]."""
        b, S = created_l.shape[:2]
        pl, nl, h, p = self._pl, self.nl, self.halo, self.shards
        c4 = created_l.view(b, S, pl, nl)
        blocks = [c4]
        if p > 1 and h:
            for d in range(1, p):
                idx = self._t_recv_idx[:, (d - 1) * h:d * h]
                send = (torch.gather(c4, -1, idx.clamp(max=nl - 1)
                                     .expand(b, S, pl, h))
                        & (idx < nl))
                blocks.append(shardmap.ppermute(send, self.mesh, self.axis,
                                                -d, dim=2))
        blocks.append(c4.new_zeros(b, S, pl, 1))
        flags = torch.cat(blocks, dim=-1).view(b, S, pl * self._width)
        created_dst_se = k_segment.spread(flags, self._t_dst_seg)
        push_se = k_segment.spread(created_l, self._t_src_l) & self._t_valid
        return created_dst_se, push_se

    def _dense_sums(self, x):
        """The dense engine's per-node sums of a per-edge quantity [...,
        Pl*Em] over every shard (row 1, then summed across the
        processes): [..., N]."""
        sums = k_segment.sum_by_perm(x, self._t_dn_perm, self._t_dn_lo,
                                     self._t_dn_hi)[..., :self.topo.n]
        return shardmap.psum(sums, self.mesh, self.axis)

    def _sync_tick(self, s: ShardedState, erl):
        """The sync scheduler with the cross-shard steps as collectives
        (the JAX ``_sync_tick``, under both engines). Returns (state,
        erl): local error bits defer to the caller's fold."""
        cfg = self.config
        C, S = cfg.queue_capacity, cfg.max_snapshots
        time = s.time + 1
        s = s._replace(time=time)
        if self._sup:
            s = self._supervise(s)
        head_rt, head_amt = self._head_fields(s)
        tok_live = s.q_len > 0
        tok_popped = s.tok_pushed - s.q_len
        m_key_live = torch.where(s.m_pending, s.m_key, INT32_MAX)
        m_front_key = m_key_live.amin(-2)
        m_is_front = s.m_pending & (m_key_live == m_front_key.unsqueeze(-2))
        m_front_rt = torch.where(m_is_front, s.m_rtime, 0).sum(-2, dtype=_i32)
        front_is_marker = (m_front_key < INT32_MAX) & (
            m_front_key // self._keymult <= tok_popped)
        front_rt = torch.where(front_is_marker, m_front_rt, head_rt)
        elig = (tok_live | front_is_marker) & (front_rt <= time.unsqueeze(-1))
        elig_i = elig.to(_i32)
        before = torch.cumsum(elig_i, dim=-1, dtype=_i32) - elig_i
        deliver = elig & (before == before.index_select(-1,
                                                        self._t_src_first))
        tok = deliver & ~front_is_marker
        mk = deliver & front_is_marker
        s = s._replace(q_head=(s.q_head + tok.to(_i32)) % C,
                       q_len=s.q_len - tok.to(_i32))
        mk_se = m_is_front & mk.unsqueeze(-2)
        amt = torch.where(tok, head_amt, 0)
        big = (amt >= F32_EXACT_LIMIT).any(-1)
        if self.comm_engine == "sparse":
            credit_l, arrivals_l = self._sparse_reduce_exchange(amt, mk_se)
            big = big | (credit_l >= F32_EXACT_LIMIT).any(-1)
        else:
            credit_n = self._dense_sums(amt)
            big = big | (credit_n >= F32_EXACT_LIMIT).any(-1)
            credit_l = self._my_slice(credit_n)
        s = s._replace(tokens=s.tokens + credit_l)
        erl = erl | _flag(big, ERR_VALUE_OVERFLOW)
        log, cnt, err_bits = log_append(
            s.log_amt, s.rec_cnt, s.min_prot, s.recording, tok, amt,
            self._rec_dtype, self._rec_limit, cfg.max_recorded)
        s = s._replace(log_amt=log, rec_cnt=cnt,
                       m_pending=s.m_pending & ~mk_se)
        erl = erl | err_bits
        had = s.has_local
        if self.comm_engine == "sparse":
            created_l = (arrivals_l > 0) & ~had
            created_dst_se, push_se = self._sparse_created_spread(created_l)
        else:
            arrivals_l = self._my_slice(self._dense_sums(mk_se))
            created_l = (arrivals_l > 0) & ~had
            created_n = shardmap.all_gather(created_l, self.mesh,
                                            self.axis).contiguous()
            valid = self._t_valid
            created_dst_se = k_segment.spread(created_n,
                                              self._t_dst_clip) & valid
            push_se = k_segment.spread(created_n, self._t_src_clip) & valid
        stopped = mk_se & s.recording
        started_se = created_dst_se & ~mk_se
        s = s._replace(
            recording=(s.recording | created_dst_se) & ~mk_se,
            frozen=torch.where(created_l, s.tokens.unsqueeze(-2), s.frozen),
            rem=torch.where(created_l, self._t_in_deg - arrivals_l,
                            s.rem - torch.where(had, arrivals_l, 0)),
            has_local=had | created_l,
            **window_update(s, started_se, stopped, s.rec_cnt))
        s = self._push_markers_split(s, push_se)
        fire = s.has_local & (s.rem == 0) & ~s.done_local
        fired = shardmap.psum(fire.sum(-1, dtype=_i32), self.mesh, self.axis)
        completed = s.completed + fired
        newly = (s.started & (completed >= self.topo.n)
                 & (s.snap_done_time < 0))
        if self._trace_on:
            s = self._trace(s, newly, EV_SNAP_END,
                            s.snap_initiator.clamp(0, self.topo.n - 1),
                            self._slot_ids)
        return s._replace(
            done_local=s.done_local | fire, completed=completed,
            snap_done_time=torch.where(newly, s.time.unsqueeze(-1),
                                       s.snap_done_time)), erl

    def _tick(self, s: ShardedState, erl, lanes=None):
        """One sync tick on the lanes of ``lanes`` [B] (None: all): every
        lane is computed (the collectives run on every process alike) and
        the others selected back, the recorder disarmed on them."""
        if lanes is None:
            return self._sync_tick(s, erl)
        ticked, erl2 = self._sync_tick(
            s._replace(tr_on=torch.where(lanes, s.tr_on, 0)), erl)
        return _select(lanes, ticked, s), torch.where(lanes, erl2, erl)

    # -- program execution -----------------------------------------------

    def _pending(self, s: ShardedState):
        return (s.started & ~s.snap_failed
                & (s.completed < self.topo.n)).any(-1)

    def _check_conservation(self, s: ShardedState) -> ShardedState:
        """One sum of the shards' balances and in-flight ring tokens
        against the initial total, per lane (ERR_CONSERVATION)."""
        occ = _occupied(s, self.config)
        local = (s.tokens.sum(-1, dtype=_i64)
                 + torch.where(occ, s.q_data, 0).sum((-2, -1), dtype=_i64))
        total = shardmap.psum(local, self.mesh, self.axis)
        return s._replace(error=s.error | _flag(
            total != self._tokens0_total, ERR_CONSERVATION))

    def _storm_phase(self, s: ShardedState, amts, snaps,
                     lanes=None) -> ShardedState:
        """One storm phase (bulk sends, the scheduled initiations, one
        tick, one error fold) on the lanes of ``lanes`` (None: all)."""
        old = s
        if lanes is not None:
            s = s._replace(tr_on=torch.where(lanes, s.tr_on, 0))
        erl = self._erl(s)
        s, erl = self._bulk_send(s, amts, erl, lanes)
        init_mask = (self._node_ids.unsqueeze(0)
                     == snaps.unsqueeze(-1)).any(0)
        s = self._bulk_snapshots(s, init_mask)
        s, erl = self._sync_tick(s, erl)
        s = self._fold_err(s, erl)
        return s if lanes is None else _select(lanes, s, old)

    def _storm_scan(self, s: ShardedState, amounts, snap) -> ShardedState:
        """The storm phases with the conservation cadence, then the drain
        and flush and the final check (one definition for the single and
        batched modes, as in JAX)."""
        k = self.check_every
        for ph in range(amounts.shape[0]):
            lanes = (s.error == 0) if self.quarantine else None
            s = self._storm_phase(s, amounts[ph], snap[ph], lanes)
            if k and (ph + 1) % k == 0:
                s = self._check_conservation(s)
        s = self._drain_flush(s)
        return self._check_conservation(s) if k else s

    def _drain_flush(self, s: ShardedState) -> ShardedState:
        """Tick until every started snapshot completes (budgeted), in
        blocks of ``megatick`` gated ticks, then max_delay + 1 flush ticks
        (test_common.go:124-137). The loop runs while the gate holds on any
        lane of any process (a sum over the whole mesh), so every process
        runs the same number of blocks and exchanges; a lane whose gate is
        false is selected back on every tick."""
        limit = s.time + self.config.max_ticks

        def gate(s):
            g = self._pending(s) & (s.time < limit)
            return g & (s.error == 0) if self.quarantine else g

        while True:
            g = gate(s)
            live, whole = guarded_get(
                self.guards, "graphshard-drain-gate",
                (shardmap.psum_all(g.sum(dtype=_i64), self.mesh), g.all()))
            if not int(live):
                break
            erl = self._erl(s)
            for k in range(self.megatick):
                lanes = (None if k == 0 and bool(whole)
                         else g if k == 0 else gate(s))
                s, erl = self._tick(s, erl, lanes)
            s = self._fold_err(s, erl)
        blown = self._pending(s)
        if self.quarantine:
            blown = blown & (s.error == 0)
        s = s._replace(error=s.error | _flag(blown, ERR_TICK_LIMIT))
        for _ in range(self.config.max_delay + 1):
            lanes = (s.error == 0) if self.quarantine else None
            s, erl = self._tick(s, self._erl(s), lanes)
            s = self._fold_err(s, erl)
        return s

    def _script_body(self, s: ShardedState,
                     script: ShardedScript) -> ShardedState:
        """Event-script execution: per phase, every op slot in order (a
        send on its owning shard, a snapshot's initiation; every slot
        splits every shard's key, as the JAX body's do), one fold, then
        the phase's ticks and one fold; then the drain and flush."""
        n = self.topo.n
        empty = torch.zeros(n, dtype=torch.bool, device=self.device)
        for t in range(script.kind.shape[0]):
            erl = self._erl(s)
            for j in range(script.kind.shape[1]):
                kind = int(script.kind[t, j])
                s, erl = self._inject_send(
                    s, int(script.shard[t, j]), int(script.loc[t, j]),
                    int(script.arg[t, j]), kind == OP_SEND, erl)
                mask = empty
                if kind == OP_SNAPSHOT:
                    mask = self._node_ids == int(script.loc[t, j])
                s = self._bulk_snapshots(s, mask)
            s = self._fold_err(s, erl)
            ticks = int(script.do_tick[t])
            if ticks:
                erl = self._erl(s)
                for _ in range(ticks):
                    s, erl = self._sync_tick(s, erl)
                s = self._fold_err(s, erl)
        s = self._drain_flush(s)
        return self._check_conservation(s) if self.check_every else s

    def run_script(self, state: ShardedState, events) -> ShardedState:
        """Execute an event script (the reference .events semantics under
        the sync scheduler) + drain + flush; with ``fixed_delay`` equal to
        the unsharded sync runner's ``run``. ``state`` is left as it
        was."""
        script = self.compile_script(events)
        s = self._flat(state, False)
        with armed(self.guards):
            s = self._script_body(s, script)
        return self._unflat(s, False)

    def _run_storm(self, state, amounts, snap, batched: bool):
        amounts_s, snap_r = self.shard_program(np.asarray(amounts),
                                               np.asarray(snap))
        amounts_s = amounts_s.reshape(amounts_s.shape[0], -1)
        s = self._flat(state, batched)
        with armed(self.guards):
            s = self._storm_scan(s, amounts_s, snap_r)
        return self._unflat(s, batched)

    def run_storm(self, state: ShardedState, amounts: np.ndarray,
                  snap: np.ndarray) -> ShardedState:
        """amounts [T, E] (global edge order), snap [T, J]: the whole
        program + drain + flush over the graph mesh. The program moves to
        the device before the dispatch is armed (``guards``). ``state``
        is left as it was."""
        return self._run_storm(state, amounts, snap, False)

    def run_storm_batched(self, state: ShardedState, amounts: np.ndarray,
                          snap: np.ndarray,
                          data_axis: str = "data") -> ShardedState:
        """B independent lanes, each a whole graph-sharded instance (the
        data x graph mode; ``state`` from ``init_batch``): within a lane
        the collectives ride the graph axis exactly as in ``run_storm``;
        the drain's live gate spans every lane and process."""
        del data_axis  # the lanes' block is fixed by init_batch
        return self._run_storm(state, amounts, snap, True)

    # -- metrics / profiling surfaces ------------------------------------

    def comm_model(self) -> dict:
        """Per-shard per-tick cross-shard bytes of both engines at this
        partition's cut (utils/metrics.comm_bytes_model; the port counts
        in int32, 4 bytes)."""
        return comm_bytes_model(
            self.topo.n, self.config.max_snapshots, self.shards, self.halo,
            cut_edges=self._bt.cut_edges, cut_rows=self._bt.cut_rows,
            count_bytes=4)

    def summarize(self, final: ShardedState) -> dict:
        """Host digest (single instance or a batch): the error decode,
        snapshot counts and the comm engine's byte model."""
        err = np.asarray(final.error.cpu()).reshape(-1)
        bits = int(np.bitwise_or.reduce(err)) if err.size else 0
        started = final.started.cpu().numpy()
        completed = final.completed.cpu().numpy()
        return {
            "nodes": self.topo.n,
            "edges": self.topo.e,
            "shards": self.shards,
            "comm_engine": self.comm_engine,
            "queue_engine": self.queue_engine,
            "kernel_engine": self.kernel_engine,
            "fused_tick": self.fused,
            "megatick": self.megatick,
            "total_ticks": int(final.time.sum()),
            "error_bits": bits,
            "errors_decoded": decode_error_bits(bits),
            "snapshots_started": int(started.sum()),
            "snapshots_completed": int(
                (started & (completed >= self.topo.n)).sum()),
            "comm_bytes_model": self.comm_model(),
        }

    def jit_tick(self):
        """A single-tick callable ``(state, stopo=None) -> state`` (the
        JAX ``jit_tick``'s unit of the dense/sparse A/B): one sync tick
        and the error fold on one instance."""
        def tick(state: ShardedState, stopo=None) -> ShardedState:
            s = self._flat(state, False)
            s, erl = self._sync_tick(s, self._erl(s))
            return self._unflat(self._fold_err(s, erl), False)

        return tick

    def gather_shards(self, state: ShardedState) -> ShardedState:
        """Every shard of a (single-instance) state in the global layout:
        the state itself on a stacked mesh; gathered across the processes
        on a dist one (a collective: every process calls it)."""
        if self.mesh.backend == "stacked":
            return state
        return ShardedState(*(
            shardmap.all_gather(x, self.mesh, self.axis, dim=0)
            if name in _SHARDED else x
            for name, x in zip(ShardedState._fields, state)))

    def gather_dense(self, final: ShardedState) -> DenseState:
        """De-shard a finished single-instance state into a host
        ``DenseState`` of numpy leaves in global node and edge order, one
        instance without a lane axis, the JAX dtypes (the JAX
        ``gather_dense``: no adversary, idle stream and memo fields)."""
        h = state_to_numpy(self.gather_shards(final))
        p, es, el = self.shards, self.edge_shard, self.edge_local

        def nodes(x):      # [P, .., Nl] -> [.., N]
            return np.concatenate([x[i] for i in range(p)], axis=-1)

        def edges(x):      # [P, Em, ...] -> [E, ...]
            return x[es, el]

        def slot_edges(x):  # [P, S, Em] -> [S, E]
            return np.moveaxis(x[es, :, el], 1, 0)

        return DenseState(
            time=h.time, tokens=nodes(h.tokens), q_meta=edges(h.q_meta),
            q_data=edges(h.q_data), q_head=edges(h.q_head),
            q_len=edges(h.q_len), tok_pushed=edges(h.tok_pushed),
            mk_cnt=edges(h.mk_cnt), m_pending=slot_edges(h.m_pending),
            m_rtime=slot_edges(h.m_rtime), m_key=slot_edges(h.m_key),
            next_sid=h.next_sid, started=h.started,
            has_local=nodes(h.has_local), frozen=nodes(h.frozen),
            rem=nodes(h.rem), done_local=nodes(h.done_local),
            recording=slot_edges(h.recording), rec_cnt=edges(h.rec_cnt),
            min_prot=edges(h.min_prot), log_amt=slot_edges(h.log_amt),
            rec_start=slot_edges(h.rec_start),
            rec_end=slot_edges(h.rec_end), completed=h.completed,
            delay_state=(), fault_key=np.uint32(0),
            fault_skew=np.int32(0), fault_counts=np.zeros(7, np.int32),
            snap_epoch=h.snap_epoch, snap_deadline=h.snap_deadline,
            snap_retries=h.snap_retries, snap_initiator=h.snap_initiator,
            snap_failed=h.snap_failed, snap_done_time=h.snap_done_time,
            stale_markers=np.int32(0), job_id=np.int32(-1),
            prog_cursor=np.int32(0), admit_tick=np.int32(0),
            tr_meta=h.tr_meta, tr_data=h.tr_data, tr_tick=h.tr_tick,
            tr_count=h.tr_count, tr_on=h.tr_on, sig=np.uint32(0),
            error=h.error)

    def stopo_device(self) -> ShardedTopology:
        """The topology constants as tensors on the runner's device."""
        if not hasattr(self, "_stopo_dev"):
            self._stopo_dev = ShardedTopology(*(
                torch.as_tensor(x, device=self.device) for x in self.stopo))
        return self._stopo_dev


__all__ = ["GraphShardedRunner", "ShardedScript", "ShardedState",
           "ShardedTopology", "shard_topology", "state_from_numpy",
           "state_to_numpy"]
