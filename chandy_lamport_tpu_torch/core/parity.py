"""Parity backend: a pure-Python, single-instance oracle simulator (the
port's copy of the JAX package's ``core/parity.py``, rule for rule).

This is the reference semantics (SURVEY.md §7.0) distilled into plain Python
with zero concurrency: the Go version's goroutines/WaitGroups/mutexes exist
only to *collect* results and collapse into simple counters here (the whole
simulation is already single-threaded-deterministic in the reference — ticks
run on one goroutine, sim.go:71-95).

Its roles: (1) the reference semantics in their plainest form, (2) the
differential-testing oracle for the port's dense backend — on the card an
oracle that owes nothing to the dense engine or to the JAX package, (3)
the trace mode (utils/tracing.EpochTrace) matching the reference Logger.

Bit-exactness-critical rules replicated (citations into the reference):
  R1 lexicographic node/dest iteration everywhere      sim.go:76,78; node.go:98
  R2 at most ONE delivery per source per tick, first eligible head in sorted
     dest order, sequential fold across sorted sources (mid-tick cascades
     visible to later sources)                          sim.go:71-95
  R3 per-channel FIFO with head-of-line blocking       queue.go; sim.go:82-84
  R4 PRNG draw order: one draw per send (node.go:130), one per outbound link
     in sorted-dest order on marker broadcast (node.go:98-107)
  R5 snapshot ids allocated in event order             sim.go:107-108
  R6 marker-source link excluded from recording on marker-triggered snapshot
     creation                                          node.go:61-69
  R7 tokens frozen at snapshot creation; debit at send time
     node.go:77,120
  R8 finalize when links_remaining hits 0, checked after EVERY marker
     receipt (including immediately after creation)    node.go:165-170
  R9 recorded messages flattened in sorted-src order — a deliberate,
     golden-compatible determinization of Go's random map order
     (node.go:188-195; SURVEY.md §2.2)
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Tuple

from chandy_lamport_tpu_torch.config import MAX_DELAY
from chandy_lamport_tpu_torch.core.spec import (
    Event,
    GlobalSnapshot,
    Message,
    MsgSnapshot,
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.models.delay import DelayModel
from chandy_lamport_tpu_torch.utils.tracing import EpochTrace


class _LocalSnapshot:
    """Per-(node, snapshot) recording state (reference node.go:34-43)."""

    __slots__ = ("id", "num_tokens", "incoming", "recording", "links_remaining",
                 "done", "msg_snapshots")

    def __init__(self, snapshot_id: int, num_tokens: int,
                 recording: Dict[str, bool], links_remaining: int):
        self.id = snapshot_id
        self.num_tokens = num_tokens          # frozen at creation (node.go:77)
        self.incoming: Dict[str, List[Message]] = {}
        self.recording = recording            # src id -> still recording?
        self.links_remaining = links_remaining
        self.done = False
        self.msg_snapshots: List[MsgSnapshot] = []


class _Node:
    """Protocol participant (reference node.go:14-22), dict/deque state."""

    def __init__(self, node_id: str, tokens: int, sim: "ParitySim"):
        self.sim = sim
        self.id = node_id
        self.tokens = tokens
        # dest id -> FIFO of (src, dest, Message, receive_time); append right,
        # pop left == reference Push/PushFront + Pop/Back (queue.go:18-24)
        self.outbound: Dict[str, Deque[Tuple[str, str, Message, int]]] = {}
        self.inbound_srcs: List[str] = []
        self.active: Dict[int, _LocalSnapshot] = {}

    # -- topology ---------------------------------------------------------
    def add_outbound_link(self, dest: "_Node") -> None:
        """reference node.go:87-94 (self-links silently ignored)."""
        if dest is self:
            return
        self.outbound[dest.id] = deque()
        dest.inbound_srcs.append(self.id)

    # -- sends ------------------------------------------------------------
    def send_tokens(self, num_tokens: int, dest: str) -> None:
        """reference node.go:112-131: debit at send, one PRNG draw."""
        if self.tokens < num_tokens:
            raise ValueError(
                f"node {self.id} attempted to send {num_tokens} tokens "
                f"when it only has {self.tokens}")
        msg = Message(is_marker=False, data=num_tokens)
        self.sim.trace.sent(self, dest, msg)
        self.tokens -= num_tokens
        if dest not in self.outbound:
            raise ValueError(f"unknown dest {dest} from node {self.id}")
        self.outbound[dest].append((self.id, dest, msg, self.sim.receive_time()))

    def send_to_neighbors(self, msg: Message) -> None:
        """reference node.go:97-109: sorted-dest order, one draw per link."""
        for dest in sorted(self.outbound):
            self.sim.trace.sent(self, dest, msg)
            self.outbound[dest].append((self.id, dest, msg, self.sim.receive_time()))

    # -- snapshot protocol ------------------------------------------------
    def create_local_snapshot(self, snapshot_id: int, src_link: str) -> None:
        """reference node.go:58-84. src_link=='' => initiator (record ALL
        inbound links); marker-triggered => exclude the marker's link (R6)."""
        recording = {src: True for src in self.inbound_srcs}
        links = len(self.inbound_srcs)
        if src_link:
            recording[src_link] = False
            links -= 1
        self.active[snapshot_id] = _LocalSnapshot(
            snapshot_id, self.tokens, recording, links)

    def start_snapshot(self, snapshot_id: int) -> None:
        """reference node.go:198-212 (minus the dead inboundBuffers block)."""
        if snapshot_id not in self.active:
            self.create_local_snapshot(snapshot_id, "")
        self.send_to_neighbors(Message(is_marker=True, data=snapshot_id))

    def handle_packet(self, src: str, msg: Message) -> None:
        """reference node.go:140-146."""
        if msg.is_marker:
            self.handle_marker(src, msg)
        else:
            self.handle_token(src, msg)

    def handle_marker(self, src: str, msg: Message) -> None:
        """reference node.go:149-171 (finalize check after every receipt, R8)."""
        sid = msg.data
        snap = self.active.get(sid)
        if snap is None:
            self.create_local_snapshot(sid, src)
            self.start_snapshot(sid)
        else:
            snap.recording[src] = False
            snap.links_remaining -= 1
        snap = self.active[sid]
        if snap.links_remaining == 0 and not snap.done:
            self._finalize_snapshot(sid)
            self.sim.notify_completed(self.id, sid)

    def handle_token(self, src: str, msg: Message) -> None:
        """reference node.go:174-185: credit first, then record into every
        active snapshot still recording this link."""
        self.tokens += msg.data
        for snap in self.active.values():
            if snap.recording.get(src):
                snap.incoming.setdefault(src, []).append(msg)

    def _finalize_snapshot(self, snapshot_id: int) -> None:
        """reference node.go:188-195, flattened in sorted-src order (R9)."""
        snap = self.active[snapshot_id]
        for src in sorted(snap.incoming):
            for m in snap.incoming[src]:
                snap.msg_snapshots.append(MsgSnapshot(src, self.id, m))
        snap.done = True


class ParitySim:
    """The simulation runtime (reference sim.go), minus all concurrency."""

    def __init__(self, delay_model: DelayModel, max_delay: int = MAX_DELAY,
                 trace: bool = False):
        self.time = 0
        self.next_snapshot_id = 0
        self.nodes: Dict[str, _Node] = {}
        self.delay_model = delay_model
        self.max_delay = max_delay
        # snapshot id -> count of nodes completed; complete at len(nodes)
        # (replaces the reference's per-snapshot WaitGroup, sim.go:116-117)
        self.completed_counts: Dict[int, int] = {}
        self.trace = EpochTrace(enabled=trace)
        self.trace.new_epoch()  # epoch 0 exists before any tick (test_common.go:35)

    # -- construction -----------------------------------------------------
    def add_node(self, node_id: str, tokens: int) -> None:
        self.nodes[node_id] = _Node(node_id, tokens, self)

    def add_link(self, src: str, dest: str) -> None:
        if src not in self.nodes:
            raise ValueError(f"node {src} does not exist")
        if dest not in self.nodes:
            raise ValueError(f"node {dest} does not exist")
        self.nodes[src].add_outbound_link(self.nodes[dest])

    # -- events -----------------------------------------------------------
    def process_event(self, event: Event) -> None:
        """reference sim.go:58-68 (+ tick, which the reference test harness
        issues directly, test_common.go:109-117)."""
        if isinstance(event, PassTokenEvent):
            self.nodes[event.src].send_tokens(event.tokens, event.dest)
        elif isinstance(event, SnapshotEvent):
            self.start_snapshot(event.node_id)
        elif isinstance(event, TickEvent):
            for _ in range(event.n):
                self.tick()
        else:
            raise TypeError(f"unknown event: {event!r}")

    # -- the hot loop -----------------------------------------------------
    def tick(self) -> None:
        """reference sim.go:71-95 — R1/R2/R3 exactly: sequential fold over
        sorted sources; per source scan sorted dests; deliver the first
        eligible queue head; break (per source) only on delivery."""
        self.time += 1
        self.trace.new_epoch()
        for src_id in sorted(self.nodes):
            node = self.nodes[src_id]
            for dest in sorted(node.outbound):
                q = node.outbound[dest]
                if q:
                    s, d, msg, rt = q[0]
                    if rt <= self.time:
                        q.popleft()
                        self.trace.received(self.nodes[d], s, msg)
                        self.nodes[d].handle_packet(s, msg)
                        break

    def receive_time(self) -> int:
        """reference sim.go:100-102."""
        return self.delay_model.receive_time(self.time)

    # -- snapshot lifecycle ----------------------------------------------
    def start_snapshot(self, node_id: str) -> int:
        """reference sim.go:105-123 (id allocation order = event order, R5)."""
        sid = self.next_snapshot_id
        self.next_snapshot_id += 1
        self.trace.start_snapshot(self.nodes[node_id], sid)
        self.completed_counts[sid] = 0
        self.nodes[node_id].start_snapshot(sid)
        return sid

    def notify_completed(self, node_id: str, snapshot_id: int) -> None:
        """reference sim.go:126-131."""
        self.trace.end_snapshot(self.nodes[node_id], snapshot_id)
        self.completed_counts[snapshot_id] += 1

    def snapshot_complete(self, snapshot_id: int) -> bool:
        return self.completed_counts.get(snapshot_id, -1) == len(self.nodes)

    def collect_snapshot(self, snapshot_id: int) -> GlobalSnapshot:
        """reference sim.go:134-173; the goroutine fan-out collapses into a
        gather in sorted-node order (per-destination order preserved, which is
        all the golden comparator requires, test_common.go:253-284)."""
        assert self.snapshot_complete(snapshot_id), "collect before completion"
        token_map: Dict[str, int] = {}
        messages: List[MsgSnapshot] = []
        for nid in sorted(self.nodes):
            local = self.nodes[nid].active[snapshot_id]
            token_map[nid] = local.num_tokens
            messages.extend(local.msg_snapshots)
        return GlobalSnapshot(snapshot_id, token_map, messages)

    # -- introspection ----------------------------------------------------
    def node_tokens(self) -> Dict[str, int]:
        return {nid: n.tokens for nid, n in self.nodes.items()}

    def total_tokens(self) -> int:
        """Node balances + in-flight (non-marker) tokens: the conserved
        quantity (test_common.go:298-328 counts both)."""
        total = sum(n.tokens for n in self.nodes.values())
        for n in self.nodes.values():
            for q in n.outbound.values():
                total += sum(m.data for _, _, m, _ in q if not m.is_marker)
        return total

    def pending_snapshot_ids(self) -> List[int]:
        return [sid for sid in self.completed_counts if not self.snapshot_complete(sid)]


def run_events(sim: ParitySim, events: List[Event]) -> List[GlobalSnapshot]:
    """Execute an event script + drain, reference test_common.go:79-140:
    run all events; tick while any snapshot incomplete (the reference's
    nondeterministic-count drain loop is outcome-equivalent to this minimal
    deterministic one — extra ticks deliver nothing relevant and draw no
    randomness, SURVEY.md §3.5); then max_delay+1 flush ticks; then collect
    in snapshot-id order."""
    started: List[int] = []
    for ev in events:
        if isinstance(ev, SnapshotEvent):
            started.append(sim.next_snapshot_id)
        sim.process_event(ev)
    guard = 0
    while sim.pending_snapshot_ids():
        sim.tick()
        guard += 1
        if guard > 1_000_000:
            raise RuntimeError(
                f"snapshots never completed: {sim.pending_snapshot_ids()} "
                "(graph not strongly connected?)")
    for _ in range(sim.max_delay + 1):
        sim.tick()
    return [sim.collect_snapshot(sid) for sid in started]
