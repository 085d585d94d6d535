"""Event tracing: the parity backend's epoch log and the flight recorder,
a per-lane ring of packed event words written inside the ticks at the
sites where the reference Logger records (logger.go:12-76,
common.go:75-122), and its host side.

``EpochTrace`` (with ``TraceEvent``) is the JAX package's copy of the
reference Logger for the parity oracle (core/parity.py): events bucketed
per time step, each with the node's balance when recorded (a send records
the balance before the debit, node.go:118-120), printed in the
reference's record strings. Host-only.

The port of the JAX package's ``utils/tracing.py`` device ring, with its
own copy of the vocabulary. Three int32 planes of ``SimConfig.
trace_capacity`` (K) slots ride on the state, ``tr_meta`` (actor << 5 |
kind), ``tr_data`` (the payload) and ``tr_tick`` (the lane's clock), with
the lane's total-events counter ``tr_count`` (an event goes to slot
``count % K``; dropped = max(0, count - K): the ring wraps, it never
truncates in silence) and the arm flag ``tr_on``. With ``trace=None``, or
K = 0, no recorder site runs.

The appenders work on a batched state (every leaf with a leading lane
axis B), take a lane mask and write the ring in place (the caller owns
the state, as the ticks' other in-place writes require); ``tr_count`` is
a new tensor. A multi-event append ranks its events in flattened row
order; when one append holds more events than the ring's K slots, only
its last K are written (the targets are then distinct, so no two writes
race for a slot; the JAX scatter keeps the last write on the CPU, which
is the same ring).

Host side: ``decode_trace`` unrolls one lane's ring chronologically,
``trace_pretty`` renders the reference Logger's record strings (the
parity backend's ``EpochTrace.pretty()`` format), ``trace_to_perfetto``
emits Chrome/Perfetto trace-event JSON, ``TelemetryWriter`` and
``read_telemetry`` write and read schema-versioned JSONL.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

# Event kinds (5 bits of the packed meta word). The actor is an EDGE index
# for the four message events, a NODE index for the snapshot, supervisor
# and crash events, and 0 for the lane events (the lane is the ring).
EV_SEND = 0          # payload = token amount          actor = edge
EV_RECV = 1          # payload = token amount          actor = edge
EV_MSEND = 2         # payload = snapshot id           actor = edge
EV_MRECV = 3         # payload = snapshot id           actor = edge
EV_SNAP_START = 4    # payload = snapshot id           actor = node
EV_SNAP_END = 5      # payload = snapshot id           actor = node
EV_SUP_ABORT = 6     # payload = snapshot slot         actor = initiator node
EV_SUP_RETRY = 7     # payload = snapshot slot         actor = initiator node
EV_SUP_FAIL = 8      # payload = snapshot slot         actor = initiator node
EV_FAULT = 9         # payload = FC_* class            actor = edge (node for
#                                                      FC_CRASH)
EV_LANE_ADMIT = 10   # payload = job id                actor = 0
EV_LANE_HARVEST = 11  # payload = job id               actor = 0
EV_LANE_COALESCE = 12  # payload = follower count      actor = 0
EV_MEMO_HIT = 13     # payload = ticks fast-forwarded  actor = 0
EV_SERVE_ADMIT = 14  # payload = admit wait (steps)    actor = 0
EV_SERVE_MISS = 15   # payload = lateness (steps)      actor = 0
EV_PREFIX_FORK = 16  # payload = fork depth (phases)   actor = 0

EVENT_KIND_NAMES = (
    "send", "recv", "marker-send", "marker-recv", "snapshot-start",
    "snapshot-end", "supervisor-abort", "supervisor-retry",
    "supervisor-fail", "fault", "lane-admit", "lane-harvest",
    "lane-coalesce", "memo-hit", "serve-admit", "serve-miss",
    "prefix-fork")

_KIND_BITS = 5
_KIND_MASK = (1 << _KIND_BITS) - 1


@dataclasses.dataclass
class TraceEvent:
    node_id: str
    node_tokens: int  # balance when recorded (logger.go:18-23)
    text: str


class EpochTrace:
    """The reference Logger (logger.go:12-76) for the parity oracle: one
    epoch of events per time step; a no-op unless ``enabled``."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.epochs: List[List[TraceEvent]] = []

    def new_epoch(self) -> None:
        if self.enabled:
            self.epochs.append([])

    def _record(self, node, text: str) -> None:
        if self.enabled:
            self.epochs[-1].append(TraceEvent(node.id, node.tokens, text))

    def sent(self, node, dest: str, msg) -> None:
        if not self.enabled:
            return
        if msg.is_marker:
            self._record(node, f"{node.id} sent marker({msg.data}) to {dest}")
        else:
            self._record(node, f"{node.id} sent {msg.data} tokens to {dest}")

    def received(self, node, src: str, msg) -> None:
        if not self.enabled:
            return
        if msg.is_marker:
            self._record(node,
                         f"{node.id} received marker({msg.data}) from {src}")
        else:
            self._record(node,
                         f"{node.id} received {msg.data} tokens from {src}")

    def start_snapshot(self, node, snapshot_id: int) -> None:
        self._record(node, f"{node.id} startSnapshot({snapshot_id})")

    def end_snapshot(self, node, snapshot_id: int) -> None:
        self._record(node, f"{node.id} endSnapshot({snapshot_id})")

    def pretty(self) -> str:
        out = []
        for t, events in enumerate(self.epochs):
            if events:
                out.append(f"Time {t}:")
                out.extend(f"\t{e.node_id}: {e.text}" for e in events)
        return "\n".join(out)

_i32 = torch.int32


def pack_event(actor, kind):
    """meta word = actor << 5 | kind (plain arithmetic: Python ints,
    numpy arrays and tensors alike)."""
    return actor * (1 << _KIND_BITS) + kind


def unpack_event(meta):
    return meta >> _KIND_BITS, meta & _KIND_MASK


class Trace:
    """Arms the flight recorder (the JAX ``JaxTrace``): pass
    ``trace=Trace()`` to ``DenseSim`` or ``BatchedRunner``. ``capacity``
    sizes the ring when the config leaves ``trace_capacity`` at 0 (the
    runner bumps the config before it builds any state)."""

    DEFAULT_CAPACITY = 4096

    def __init__(self, capacity: int = 0):
        if capacity < 0:
            raise ValueError("trace capacity must be >= 0")
        self.capacity = int(capacity)

    def describe(self) -> Dict[str, Any]:
        return {"capacity": self.capacity or self.DEFAULT_CAPACITY}


def armed_config(cfg, trace):
    """``cfg`` with ``trace_capacity`` bumped to the trace's capacity (or
    ``Trace.DEFAULT_CAPACITY``) when a trace is armed and the config
    leaves it at 0; otherwise ``cfg`` itself."""
    if trace is None or cfg.trace_capacity:
        return cfg
    return dataclasses.replace(
        cfg, trace_capacity=getattr(trace, "capacity", 0)
        or Trace.DEFAULT_CAPACITY)


# ---- the appenders (batched states, in place) --------------------------------

def _rows(x, mask):
    """``x`` (a host int or a tensor broadcastable to ``mask``'s [B, ...]
    shape) as int32 [B, M], M the events per lane of ``mask``."""
    t = torch.as_tensor(x, dtype=_i32, device=mask.device)
    return t.expand(mask.shape).reshape(mask.shape[0], -1)


def _append(s, on, meta, data):
    """The ranked append of the events ``on`` [B, M] (meta, data [B, M])
    in row order per lane: event r of a lane's m goes to slot (count + r)
    % K, only the last K of them written."""
    k = s.tr_meta.shape[-1]
    oni = on.to(_i32)
    total = oni.sum(-1, dtype=_i32)
    rank = torch.cumsum(oni, dim=-1, dtype=_i32) - oni
    keep = on & (rank >= (total - k).unsqueeze(-1))
    rows, cols = keep.nonzero(as_tuple=True)
    if rows.numel():
        slot = ((s.tr_count[rows] + rank[rows, cols]) % k).long()
        s.tr_meta[rows, slot] = meta[rows, cols]
        s.tr_data[rows, slot] = data[rows, cols]
        s.tr_tick[rows, slot] = s.time[rows]
    return s._replace(tr_count=s.tr_count + total)


def trace_append_many(s, mask, kind: int, actor, payload):
    """Every True entry of ``mask`` [B, ...] appends one event to its
    lane's ring, in flattened row order (the JAX ``trace_append_many``
    per lane). ``actor`` and ``payload``: host ints or tensors that
    broadcast to ``mask`` (a per-lane value [B] as [B, 1]). The identity
    when K is 0."""
    if s.tr_meta.shape[-1] == 0:
        return s
    on = mask.reshape(mask.shape[0], -1) & (s.tr_on > 0).unsqueeze(-1)
    return _append(s, on, pack_event(_rows(actor, mask), kind),
                   _rows(payload, mask))


def trace_append_one(s, fire, kind: int, actor, payload):
    """One event on each lane where ``fire`` ([B], or a bool for every
    lane) holds (the JAX ``trace_append_one`` per lane); ``actor`` and
    ``payload`` host ints or [B] values."""
    if s.tr_meta.shape[-1] == 0:
        return s
    b = s.time.shape[0]
    fire = torch.as_tensor(fire, device=s.time.device).expand(b)

    def col(x):
        return x.reshape(b, 1) if torch.is_tensor(x) and x.dim() else x

    return trace_append_many(s, fire.reshape(b, 1), kind, col(actor),
                             col(payload))


def trace_append_lanes(s, mask_b, kind: int, payload_b):
    """One lane event (actor 0) on each lane of ``mask_b`` [B] with its
    ``payload_b`` [B] (the JAX ``trace_append_lanes``: the streaming
    engine's harvest and admit)."""
    return trace_append_one(s, mask_b, kind, 0, payload_b)


# ---- host side: decoding and exporters ---------------------------------------

class TraceRecord(NamedTuple):
    tick: int
    kind: int
    actor: int
    payload: int

    @property
    def kind_name(self) -> str:
        return (EVENT_KIND_NAMES[self.kind]
                if 0 <= self.kind < len(EVENT_KIND_NAMES)
                else f"kind{self.kind}")


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def trace_counts(state):
    """(recorded, dropped) summed over the state's lanes: recorded =
    min(count, K), dropped = max(0, count - K)."""
    count = _host(state.tr_count).astype(np.int64)
    k = int(state.tr_meta.shape[-1])
    return (int(np.minimum(count, k).sum()),
            int(np.maximum(count - k, 0).sum()))


def decode_trace(state, lane: Optional[int] = None) -> List[TraceRecord]:
    """One lane's ring unrolled chronologically. ``state``'s tr_* leaves
    are tensors or numpy arrays, one lane's (no lane axis) or batched with
    ``lane`` naming one. Events lost to the wrap are absent (their count
    survives in tr_count: ``trace_counts``)."""
    meta, data, tick, count = (_host(state.tr_meta), _host(state.tr_data),
                               _host(state.tr_tick), _host(state.tr_count))
    if lane is not None:
        meta, data, tick, count = meta[lane], data[lane], tick[lane], \
            count[lane]
    if meta.ndim != 1:
        raise ValueError("batched trace state needs an explicit lane=")
    k = meta.shape[0]
    count = int(count)
    out = []
    for i in range(count - min(count, k), count):
        pos = i % k
        actor, kind = unpack_event(int(meta[pos]))
        out.append(TraceRecord(int(tick[pos]), int(kind), int(actor),
                               int(data[pos])))
    return out


def _event_line(ev: TraceRecord, topo) -> str:
    """One decoded event as the reference Logger's record string
    (common.go:75-122), prefixed with the acting node: the line shape of
    the parity backend's ``EpochTrace.pretty()``."""
    ids = topo.ids
    if ev.kind in (EV_SEND, EV_RECV, EV_MSEND, EV_MRECV):
        src = ids[int(topo.edge_src[ev.actor])]
        dst = ids[int(topo.edge_dst[ev.actor])]
        if ev.kind == EV_SEND:
            return f"\t{src}: {src} sent {ev.payload} tokens to {dst}"
        if ev.kind == EV_RECV:
            return f"\t{dst}: {dst} received {ev.payload} tokens from {src}"
        if ev.kind == EV_MSEND:
            return f"\t{src}: {src} sent marker({ev.payload}) to {dst}"
        return f"\t{dst}: {dst} received marker({ev.payload}) from {src}"
    nid = ids[ev.actor] if 0 <= ev.actor < len(ids) else str(ev.actor)
    if ev.kind == EV_SNAP_START:
        return f"\t{nid}: {nid} startSnapshot({ev.payload})"
    if ev.kind == EV_SNAP_END:
        return f"\t{nid}: {nid} endSnapshot({ev.payload})"
    if ev.kind in (EV_SUP_ABORT, EV_SUP_RETRY, EV_SUP_FAIL):
        verb = {EV_SUP_ABORT: "supervisorAbort", EV_SUP_RETRY:
                "supervisorRetry", EV_SUP_FAIL: "supervisorFail"}[ev.kind]
        return f"\t{nid}: {nid} {verb}(slot {ev.payload})"
    if ev.kind == EV_FAULT:
        return f"\t{nid}: fault(class {ev.payload})"
    lane = {EV_LANE_ADMIT: "admit(job {})", EV_LANE_HARVEST: "harvest(job {})",
            EV_LANE_COALESCE: "coalesce({} followers)",
            EV_MEMO_HIT: "memo-hit(fast-forwarded {} ticks)",
            EV_SERVE_ADMIT: "serve-admit(waited {} steps)",
            EV_SERVE_MISS: "serve-miss({} steps late)"}.get(ev.kind)
    if lane is not None:
        return "\tlane: " + lane.format(ev.payload)
    return f"\t?: {ev.kind_name}({ev.payload})"


def trace_pretty(events: List[TraceRecord], topo) -> str:
    """Decoded events in ``EpochTrace.pretty()``'s format: a ``Time t:``
    header for each tick that has events, then one tab-indented record
    line per event."""
    out: List[str] = []
    last_tick = None
    for ev in events:
        if ev.tick != last_tick:
            out.append(f"Time {ev.tick}:")
            last_tick = ev.tick
        out.append(_event_line(ev, topo))
    return "\n".join(out)


def trace_to_perfetto(events: List[TraceRecord], topo, lane: int = 0,
                      tick_us: int = 1000) -> Dict[str, Any]:
    """Chrome/Perfetto trace-event JSON of one lane's decoded events: one
    track (pid = lane, tid = node) per node and one for the lane and its
    supervisor, message and lane events as instants, snapshot attempts as
    async spans keyed by snapshot id, faults as instants; ticks scaled to
    ``tick_us`` microseconds."""
    ids = topo.ids
    tev: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": lane,
         "args": {"name": f"lane {lane}"}}]
    for i, nid in enumerate(ids):
        tev.append({"name": "thread_name", "ph": "M", "pid": lane,
                    "tid": i, "args": {"name": f"node {nid}"}})
    sup_tid = len(ids)
    tev.append({"name": "thread_name", "ph": "M", "pid": lane,
                "tid": sup_tid, "args": {"name": "lane/supervisor"}})
    for ev in events:
        if ev.kind in (EV_SEND, EV_MSEND):
            tid = int(topo.edge_src[ev.actor])
        elif ev.kind in (EV_RECV, EV_MRECV):
            tid = int(topo.edge_dst[ev.actor])
        elif ev.kind in (EV_SNAP_START, EV_SNAP_END, EV_SUP_ABORT,
                         EV_SUP_RETRY, EV_SUP_FAIL, EV_FAULT):
            tid = ev.actor if 0 <= ev.actor < len(ids) else sup_tid
        else:
            tid = sup_tid
        base = {"pid": lane, "tid": tid, "ts": ev.tick * tick_us,
                "cat": ev.kind_name,
                "args": {"actor": ev.actor, "payload": ev.payload,
                         "tick": ev.tick}}
        if ev.kind in (EV_SNAP_START, EV_SNAP_END):
            tev.append({**base, "name": f"snapshot {ev.payload}",
                        "ph": "b" if ev.kind == EV_SNAP_START else "e",
                        "id": ev.payload, "cat": "snapshot"})
        elif ev.kind == EV_FAULT:
            tev.append({**base, "name": f"fault class {ev.payload}",
                        "ph": "i", "s": "t"})
        else:
            tev.append({**base, "name": ev.kind_name, "ph": "i", "s": "t"})
    return {"traceEvents": tev, "displayTimeUnit": "ms"}


TELEMETRY_SCHEMA_VERSION = 1


class TelemetryWriter:
    """Schema-versioned JSONL telemetry: one record per line, each stamped
    with the schema version and its ``kind`` (run metadata, per-event or
    per-step records, a final summary)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")

    def write(self, kind: str, record: Dict[str, Any]) -> None:
        row = {"schema": TELEMETRY_SCHEMA_VERSION, "kind": kind, **record}
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_telemetry(path: str) -> List[Dict[str, Any]]:
    """A telemetry JSONL file's records, skipping lines that do not parse
    (a killed writer can leave a torn tail) and refusing a record of a
    newer schema than this reader's."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if row.get("schema", 0) > TELEMETRY_SCHEMA_VERSION:
                raise ValueError(
                    f"telemetry schema v{row['schema']} is newer than this "
                    f"reader (v{TELEMETRY_SCHEMA_VERSION})")
            out.append(row)
    return out
