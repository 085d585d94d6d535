"""Dense tensor encoding of the simulator: topology and batched state.

The same encoding as the JAX package's ``core/state.py`` (its module and
``DenseState`` docstrings describe the layout in full): node index =
lexicographic rank of the node id, edges sorted by (src, dst), per-edge
ring buffers with packed slot words, split-mode marker planes, and a
shared per-edge recording log with per-(snapshot, edge) windows.

What differs is the batch: where the JAX package ``vmap``s one instance,
every leaf here carries an explicit leading ``B`` axis, so a per-instance
scalar is a ``[B]`` tensor and an ``[S, E]`` plane is ``[B, S, E]``.
Field names, order and dtypes are the JAX ``DenseState``'s, with one
representation change: PyTorch has no usable unsigned 32-bit arithmetic,
so every uint32 word (``fault_key``, ``sig`` and the delay sampler's
words) is held as an int64 tensor with values in ``[0, 2^32)``
(``utils/carry.py`` converts to and from the JAX dtypes).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.spec import (
    GlobalSnapshot,
    Message,
    MsgSnapshot,
)
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec

# error bitmask flags
ERR_QUEUE_OVERFLOW = 1
ERR_SNAPSHOT_OVERFLOW = 2
ERR_RECORD_OVERFLOW = 4
ERR_TOKEN_UNDERFLOW = 8
ERR_TICK_LIMIT = 16
ERR_VALUE_OVERFLOW = 32
ERR_CONSERVATION = 64
ERR_FAULT_UNRECOVERED = 128
ERR_SNAPSHOT_TIMEOUT = 256

ERROR_NAMES: Dict[int, Tuple[str, str]] = {
    ERR_QUEUE_OVERFLOW: (
        "ERR_QUEUE_OVERFLOW",
        "per-edge queue capacity exceeded (raise SimConfig.queue_capacity)"),
    ERR_SNAPSHOT_OVERFLOW: (
        "ERR_SNAPSHOT_OVERFLOW",
        "concurrent snapshot slots exceeded (raise SimConfig.max_snapshots)"),
    ERR_RECORD_OVERFLOW: (
        "ERR_RECORD_OVERFLOW",
        "recorded-message capacity exceeded (raise SimConfig.max_recorded)"),
    ERR_TOKEN_UNDERFLOW: (
        "ERR_TOKEN_UNDERFLOW",
        "node sent more tokens than it had (reference log.Fatal, "
        "node.go:113-116)"),
    ERR_TICK_LIMIT: (
        "ERR_TICK_LIMIT",
        "drain loop hit max_ticks (graph not strongly connected?)"),
    ERR_VALUE_OVERFLOW: (
        "ERR_VALUE_OVERFLOW",
        "a value-range bound was exceeded: token amount >= 2^24, a "
        "recorded amount beyond the record_dtype range, an edge's "
        "token-push counter at the FIFO merge-key bound, or a receive "
        "time at the packed ring-slot bound (RTIME_PACK_LIMIT)"),
    ERR_CONSERVATION: (
        "ERR_CONSERVATION",
        "in-run token-conservation check failed (node balances + "
        "in-flight != initial total; BatchedRunner check_every)"),
    ERR_FAULT_UNRECOVERED: (
        "ERR_FAULT_UNRECOVERED",
        "a lossy node crash restarted with no completed snapshot"),
    ERR_SNAPSHOT_TIMEOUT: (
        "ERR_SNAPSHOT_TIMEOUT",
        "a snapshot attempt missed its deadline snapshot_retries times"),
}

# fault_counts[7] event-class indices (models/faults.py): token drops,
# duplicates, jitter stalls, crash restarts, and the marker-plane drops,
# duplicates and jitter stalls
FC_DROP, FC_DUP, FC_JITTER, FC_CRASH = 0, 1, 2, 3
FC_MDROP, FC_MDUP, FC_MJITTER = 4, 5, 6
NUM_FAULT_CLASSES = 7

# largest token amount the sync scheduler's value-range contract admits;
# amounts at or beyond it fire ERR_VALUE_OVERFLOW
F32_EXACT_LIMIT = 1 << 24
# error bits in the word (the JAX ``NUM_ERROR_BITS``): the graph-sharded
# runner ORs the word across shards bit by bit
NUM_ERROR_BITS = len(ERROR_NAMES)

# largest receive time a packed ring slot (rtime << 1 | is_marker in one
# int32) can carry; push sites fire ERR_VALUE_OVERFLOW at the bound
RTIME_PACK_LIMIT = 1 << 30

INT32_MAX = 2**31 - 1

# DenseState leaves that hold uint32 words (as int64, module docstring)
U32_LEAVES = ("fault_key", "sig")

# the window planes: with SimConfig.window_dtype="uint16" the port holds
# them as int16 tensors carrying the uint16 bits (PyTorch's uint16 has no
# subtraction or index_put_), and they are uint16 on the host
# (utils/carry.py); an int16 cast of an int32 counter keeps its low 16
# bits, which is the JAX ``astype(uint16)``
WINDOW_LEAVES = ("rec_start", "rec_end")


def window_dtype(cfg: SimConfig) -> torch.dtype:
    """The torch dtype of the window planes under ``cfg``."""
    return torch.int16 if cfg.window_dtype == "uint16" else torch.int32

# Checkpoint-format version history (utils/checkpoint.py writes the live
# version into each file's header), copied row for row from the JAX
# package's core/state.py: the port's DenseState and StreamState have the
# JAX fields in the JAX order, so its files are the JAX package's files
# and each package loads the other's. One row per breaking layout change;
# versions run consecutively from 1 and the live version is the last row.
CHECKPOINT_FORMAT_HISTORY: Tuple[Tuple[int, str], ...] = (
    (1, "round-2 DenseState (q_seq/seq_next/m_seq/rec_len/rec_data leaves)"),
    (2, "window-log/merge-key state (tok_pushed/mk_cnt/m_key/rec_cnt/"
        "min_prot/log_amt/rec_start/rec_end) + three-word hash-delay state"),
    (3, "packed ring slots: q_marker/q_data/q_rtime became "
        "q_meta (rtime << 1 | is_marker) + full-range q_data"),
    (4, "fault-adversary leaves (fault_key/fault_skew/fault_counts) join "
        "the carry; writes became atomic (tmp-then-os.replace)"),
    (5, "snapshot-supervisor leaves (snap_epoch/snap_deadline/snap_retries/"
        "snap_initiator/snap_failed/snap_done_time + stale_markers); "
        "fault_counts widens to [7] with the marker-plane classes"),
    (6, "streaming-engine leaves (job_id/prog_cursor/admit_tick): per-lane "
        "job identity resumes mid-queue admission bit-exactly"),
    (7, "flight-recorder leaves (tr_meta/tr_data/tr_tick/tr_count/tr_on): "
        "the device trace ring and its dropped-events accounting survive "
        "a kill mid-run"),
    (8, "memo-plane leaf (sig: per-lane rolling state signature for "
        "transition fast-forwarding) + StreamState memo counters "
        "(cache_hits/coalesced_jobs/ff_skipped_ticks/shadow_checks): a "
        "kill mid-stream resumes the fast-forward memo and hit "
        "accounting bit-exactly"),
    (9, "serving-plane StreamState leaves (deadline_misses + per-tenant "
        "tenant_served/tenant_quota books): a killed serve run resumes "
        "its deadline-miss and fairness accounting bit-exactly"),
    (10, "prefix-fork StreamState counters (prefix_hits/forked_jobs/"
         "fork_depth_sum): a killed memo=\"prefix\" run resumes its "
         "speculative-fork accounting bit-exactly"),
)
CHECKPOINT_FORMAT_VERSION = CHECKPOINT_FORMAT_HISTORY[-1][0]


def pack_meta(rtime, marker):
    """One packed ring-slot metadata word: ``rtime << 1 | is_marker``."""
    return rtime * 2 + marker


def meta_rtime(meta):
    """Delivery-eligible time of a packed slot word (arithmetic shift)."""
    return meta >> 1


def meta_marker(meta):
    """Marker bit of a packed slot word (bool)."""
    return (meta & 1) == 1


def pack_marker_data(sid, epoch, max_snapshots: int):
    """Ring-mode marker payload word under the snapshot supervisor:
    ``epoch * S + sid``; epoch 0 packs to the bare sid."""
    return epoch * max_snapshots + sid


def marker_data_sid(data, max_snapshots: int):
    """Snapshot id of a packed marker payload word (floor modulus, as
    jnp's)."""
    return data % max_snapshots


def marker_data_epoch(data, max_snapshots: int):
    """Epoch of a packed marker payload word (floor division, as jnp's)."""
    return torch.div(data, max_snapshots, rounding_mode="floor")


class DenseTopology:
    """Static graph arrays (numpy); node index = lexicographic rank of the
    node id, edges sorted by (src, dst)."""

    def __init__(self, spec: TopologySpec):
        self.ids: List[str] = sorted(spec.node_ids)
        if len(set(self.ids)) != len(self.ids):
            raise ValueError("duplicate node ids in topology")
        self.index: Dict[str, int] = {nid: i for i, nid in enumerate(self.ids)}
        self.n = len(self.ids)
        tokens0 = dict(spec.nodes)
        self.tokens0 = np.array([tokens0[nid] for nid in self.ids],
                                dtype=np.int32)
        src = [self.index.get(a) for a, _ in spec.links]
        dst = [self.index.get(b) for _, b in spec.links]
        if None in src or None in dst:
            for (a, b), i, j in zip(spec.links, src, dst):
                if i is None:
                    raise ValueError(f"node {a} does not exist")
                if j is None:
                    raise ValueError(f"node {b} does not exist")
        # self-links ignored, duplicate arcs collapse (node.go:88-93): the
        # distinct (src, dst) pairs in order, as one int64 code each
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        keep = src != dst
        code = np.unique(src[keep] * self.n + dst[keep])
        self.e = len(code)
        self.edge_src = (code // max(self.n, 1)).astype(np.int32)
        self.edge_dst = (code % max(self.n, 1)).astype(np.int32)
        out_count = np.bincount(self.edge_src, minlength=self.n)
        self.in_degree = np.bincount(self.edge_dst,
                                     minlength=self.n).astype(np.int32)
        self.d = int(out_count.max()) if self.e else 1
        self.edge_table = np.full((self.n, self.d), -1, dtype=np.int32)
        # each source's edges in dest order (edges are (src, dst)-sorted)
        first = np.concatenate([[0], np.cumsum(out_count)[:-1]])
        self.edge_table[self.edge_src,
                        np.arange(self.e) - first[self.edge_src]] = \
            np.arange(self.e, dtype=np.int32)
        # dst-sorted edge permutation (stable: src order kept within a
        # destination) + per-node segment bounds in that order
        self.by_dst = np.argsort(self.edge_dst, kind="stable")
        self.dst_bounds = np.concatenate(
            [[0], np.cumsum(np.bincount(self.edge_dst, minlength=self.n))])

    # built on first use: at a million nodes each takes seconds, and the
    # storm paths read neither
    @functools.cached_property
    def edge_index(self) -> Dict[Tuple[int, int], int]:
        """(src, dst) node indices -> edge index."""
        return dict(zip(zip(self.edge_src.tolist(), self.edge_dst.tolist()),
                        range(self.e)))

    @functools.cached_property
    def in_edges(self) -> List[np.ndarray]:
        """Each node's inbound edges, in source order."""
        return np.split(self.by_dst, self.dst_bounds[1:-1])


class DenseState(NamedTuple):
    """The batched carry. Shapes: B lanes, N nodes, E edges, C queue slots,
    S snapshot slots, L log slots, K trace slots (``cfg.trace_capacity``:
    the flight recorder's ring, utils/tracing.py; 0 when it is off).
    Comments give the per-lane dtype and shape; every leaf has a leading
    B axis (the JAX ``DenseState`` docstring explains each field)."""

    time: Any          # i32 []
    tokens: Any        # i32 [N]
    q_meta: Any        # i32 [E, C]   rtime << 1 | is_marker
    q_data: Any        # i32 [E, C]   token amount
    q_head: Any        # i32 [E]
    q_len: Any         # i32 [E]
    tok_pushed: Any    # i32 [E]      tokens ever pushed
    mk_cnt: Any        # i32 [E]      markers ever pushed
    m_pending: Any     # bool [S, E]  marker in flight
    m_rtime: Any       # i32 [S, E]
    m_key: Any         # i32 [S, E]   FIFO merge key
    next_sid: Any      # i32 []
    started: Any       # bool [S]
    has_local: Any     # bool [S, N]
    frozen: Any        # i32 [S, N]
    rem: Any           # i32 [S, N]
    done_local: Any    # bool [S, N]
    recording: Any     # bool [S, E]
    rec_cnt: Any       # i32 [E]
    min_prot: Any      # i32 [E]      earliest window start (INT32_MAX = none)
    log_amt: Any       # record_dtype [L, E]
    rec_start: Any     # window_dtype [S, E] (int16 bits of uint16)
    rec_end: Any       # window_dtype [S, E]
    completed: Any     # i32 [S]
    delay_state: Any   # sampler tuple (ops/delay.py)
    fault_key: Any     # u32 []
    fault_skew: Any    # i32 []
    fault_counts: Any  # i32 [7]
    snap_epoch: Any    # i32 [S]
    snap_deadline: Any  # i32 [S]
    snap_retries: Any  # i32 [S]
    snap_initiator: Any  # i32 [S]   -1 = unset
    snap_failed: Any   # bool [S]
    snap_done_time: Any  # i32 [S]   -1 until complete
    stale_markers: Any  # i32 []
    job_id: Any        # i32 []      -1 = not a streamed job
    prog_cursor: Any   # i32 []
    admit_tick: Any    # i32 []
    tr_meta: Any       # i32 [K]
    tr_data: Any       # i32 [K]
    tr_tick: Any       # i32 [K]
    tr_count: Any      # i32 []
    tr_on: Any         # i32 []      1 = recorder armed
    sig: Any           # u32 []
    error: Any         # i32 []      sticky bitmask


def init_state(topo: DenseTopology, cfg: SimConfig, batch: int, delay,
               device) -> DenseState:
    """A fresh batched state built on ``device``: zeros except the token
    balances, ``min_prot`` (INT32_MAX), the unset ``snap_initiator`` /
    ``snap_done_time`` / ``job_id`` (-1), ``tr_on`` (1) and the per-lane
    delay sampler state — the JAX ``BatchedRunner``'s on-device init
    (parallel/batch.py:747-782)."""
    n, e, b = topo.n, topo.e, batch
    c, s, m = cfg.queue_capacity, cfg.max_snapshots, cfg.max_recorded
    k = cfg.trace_capacity
    i32, i64, bl = torch.int32, torch.int64, torch.bool

    def z(*shape, dtype=i32):
        return torch.zeros((b,) + shape, dtype=dtype, device=device)

    def full(value, *shape):
        return torch.full((b,) + shape, value, dtype=i32, device=device)

    return DenseState(
        time=z(),
        tokens=torch.as_tensor(topo.tokens0, device=device)
        .expand(b, n).clone(),
        q_meta=z(e, c), q_data=z(e, c), q_head=z(e), q_len=z(e),
        tok_pushed=z(e), mk_cnt=z(e),
        m_pending=z(s, e, dtype=bl), m_rtime=z(s, e), m_key=z(s, e),
        next_sid=z(), started=z(s, dtype=bl),
        has_local=z(s, n, dtype=bl), frozen=z(s, n), rem=z(s, n),
        done_local=z(s, n, dtype=bl), recording=z(s, e, dtype=bl),
        rec_cnt=z(e), min_prot=full(INT32_MAX, e),
        log_amt=z(m, e, dtype=getattr(torch, cfg.record_dtype)),
        rec_start=z(s, e, dtype=window_dtype(cfg)),
        rec_end=z(s, e, dtype=window_dtype(cfg)), completed=z(s),
        delay_state=delay.init_batch_state(b, device),
        fault_key=z(dtype=i64), fault_skew=z(),
        fault_counts=z(NUM_FAULT_CLASSES),
        snap_epoch=z(s), snap_deadline=z(s), snap_retries=z(s),
        snap_initiator=full(-1, s), snap_failed=z(s, dtype=bl),
        snap_done_time=full(-1, s), stale_markers=z(),
        job_id=full(-1), prog_cursor=z(), admit_tick=z(),
        tr_meta=z(k), tr_data=z(k), tr_tick=z(k), tr_count=z(),
        tr_on=full(1), sig=z(dtype=i64), error=z(),
    )


def init_single_state(topo: DenseTopology, cfg: SimConfig, delay,
                      device) -> DenseState:
    """One simulation's fresh state (a batch of one lane): ``init_state``
    with the sampler's single-instance stream where it has its own (the
    threefry key ``PRNGKey(seed)``, the JAX ``init_state()``; lane 0 of
    ``init_batch_state`` is ``fold_in(PRNGKey(seed), 0)``)."""
    state = init_state(topo, cfg, 1, delay, device)
    single = getattr(delay, "init_state", None)
    if single is not None:
        state = state._replace(delay_state=single(device))
    return state


def recorded_window(host: DenseState, sid: int, eidx: int) -> List[int]:
    """The amounts snapshot ``sid`` recorded on edge ``eidx``, in arrival
    order: the ``[rec_start, rec_end)`` window of the edge's ring log
    (``rec_end`` falls back to the live ``rec_cnt`` for a still-recording
    channel). ``host`` is ONE lane's state as numpy arrays.

    With uint16 window planes (``window_dtype="uint16"``) the counters are
    held modulo 2^16: the length is (end - start) mod 2^16 and the log
    positions (start + k) mod L, equal to the absolute decode because L
    divides 2^16 (the JAX ``recorded_window``)."""
    lcap = host.log_amt.shape[-2]
    start = int(host.rec_start[sid, eidx])
    end = (int(host.rec_cnt[eidx]) if host.recording[sid, eidx]
           else int(host.rec_end[sid, eidx]))
    if np.dtype(host.rec_start.dtype) != np.int32:   # modular planes
        bits = 8 * np.dtype(host.rec_start.dtype).itemsize
        length = (end - start) & ((1 << bits) - 1)
        return [int(host.log_amt[(start + k) % lcap, eidx])
                for k in range(length)]
    return [int(host.log_amt[j % lcap, eidx]) for j in range(start, end)]


def decode_snapshot(topo: DenseTopology, host: DenseState,
                    sid: int) -> GlobalSnapshot:
    """One lane's state -> GlobalSnapshot, the reference's CollectSnapshot
    (sim.go:134-173): token map from the frozen balances, messages per
    node over its inbound edges in src-rank order, each edge's recordings
    in arrival order (golden-compatible, test_common.go:253-284)."""
    token_map = {nid: int(host.frozen[sid, i])
                 for i, nid in enumerate(topo.ids)}
    messages: List[MsgSnapshot] = []
    for nidx, nid in enumerate(topo.ids):
        for eidx in topo.in_edges[nidx]:
            src = topo.ids[int(topo.edge_src[eidx])]
            for amt in recorded_window(host, sid, eidx):
                messages.append(MsgSnapshot(
                    src, nid, Message(is_marker=False, data=amt)))
    return GlobalSnapshot(sid, token_map, messages)


def decode_error_bits(mask: int) -> List[str]:
    """Short ERR_* names for a bitmask (bench rows, logs)."""
    mask = int(mask)
    return [name for bit, (name, _) in ERROR_NAMES.items() if mask & bit]


def decode_errors(error_bits: int) -> List[str]:
    """Long diagnostic messages for a bitmask (the JAX ``decode_errors``,
    its parameter name too)."""
    error_bits = int(error_bits)
    return [msg for bit, (_, msg) in ERROR_NAMES.items()
            if error_bits & bit]
