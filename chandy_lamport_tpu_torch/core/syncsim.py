"""Independent pure-Python oracle for the SYNC scheduler semantics (the
port's copy of the JAX package's ``core/syncsim.py``).

The dense sync tick (ops/tick.py) is heavily vectorized; this module is a
deliberately naive re-implementation of the same scheduler contract, written
with dicts and lists, used only by differential tests. The contract:

  1. Per tick, every source delivers the head of its first (dest-sorted)
     outbound channel whose head is eligible (receive_time <= time); at most
     one delivery per source; per-channel FIFO and head-of-line blocking as
     in the reference (sim.go:71-95, queue.go).
  2. Within a tick, all token deliveries apply before all marker deliveries
     ("tokens-then-markers"): credits land first; a token is recorded into
     every snapshot slot that was recording its channel at tick START.
  3. Marker deliveries are processed grouped by ascending snapshot id. A
     node's first marker(s) for an id create its local snapshot excluding
     ALL of this tick's marker channels for that id (k simultaneous markers
     -> links_remaining = in_degree - k), then the node broadcasts markers
     on its outbound edges in edge order; queued broadcasts for multiple ids
     on one edge stack in ascending id order. Later markers decrement
     links_remaining. Finalization fires as soon as links_remaining == 0.
  4. Snapshot initiation (between ticks) allocates ids in node-index order
     and records ALL inbound channels (sim.go:105-123 semantics).

Delay model: any host-side DelayModel; differential tests use FixedDelay so
the oracle and the dense kernel see identical receive times (counter-based
streams cannot be replicated host-side).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Tuple

from chandy_lamport_tpu_torch.core.state import DenseTopology
from chandy_lamport_tpu_torch.models.delay import DelayModel


class SyncOracle:
    """Sequential reference implementation of the sync scheduler."""

    def __init__(self, topo: DenseTopology, delay: DelayModel):
        self.topo = topo
        self.delay = delay
        self.time = 0
        self.tokens = [int(t) for t in topo.tokens0]
        # per edge: FIFO of (is_marker, data, receive_time)
        self.queues: List[Deque[Tuple[bool, int, int]]] = [
            deque() for _ in range(topo.e)]
        self.next_sid = 0
        # per sid: per-node dicts
        self.frozen: Dict[int, Dict[int, int]] = {}
        self.rem: Dict[int, Dict[int, int]] = {}
        self.recording: Dict[int, set] = {}       # sid -> set of edge ids
        self.recorded: Dict[int, Dict[int, List[int]]] = {}  # sid -> edge -> amounts
        self.done: Dict[int, set] = {}
        self.completed: Dict[int, int] = {}

    # -- injection ---------------------------------------------------------

    def bulk_send(self, amounts: List[int]) -> None:
        """amounts[e] > 0 enqueues one token message on edge e; every edge
        draws a receive time in edge order (matching draw_many's
        one-draw-per-edge fast-path semantics under a fixed delay)."""
        for e in range(self.topo.e):
            rt = self.delay.receive_time(self.time)
            if amounts[e] > 0:
                src = int(self.topo.edge_src[e])
                self.tokens[src] -= amounts[e]
                assert self.tokens[src] >= 0, "underflow in oracle workload"
                self.queues[e].append((False, int(amounts[e]), rt))

    def start_snapshots(self, nodes: List[int]) -> List[int]:
        """Initiate at the given nodes; ids allocated in node-index order."""
        sids = []
        for node in sorted(set(nodes)):
            sid = self.next_sid
            self.next_sid += 1
            sids.append(sid)
            self.frozen[sid] = {node: self.tokens[node]}
            self.rem[sid] = {node: int(self.topo.in_degree[node])}
            self.recording[sid] = {e for e in range(self.topo.e)
                                   if int(self.topo.edge_dst[e]) == node}
            self.recorded[sid] = {}
            self.done[sid] = set()
            self.completed[sid] = 0
            self._broadcast({node: [sid]})
        return sids

    def _broadcast(self, sids_by_node: Dict[int, List[int]]) -> None:
        """Push marker(sid) on every outbound edge of each node; multiple
        sids on one edge stack in ascending sid order; one delay draw per
        (sid-slot, edge) in sid-major order (draw_many((S, E)) layout)."""
        for sid in sorted({s for sids in sids_by_node.values() for s in sids}):
            for e in range(self.topo.e):
                rt = self.delay.receive_time(self.time)
                src = int(self.topo.edge_src[e])
                if src in sids_by_node and sid in sids_by_node[src]:
                    self.queues[e].append((True, sid, rt))

    # -- the tick ----------------------------------------------------------

    def tick(self) -> None:
        self.time += 1
        # 1. choose deliveries: first eligible head per source in edge order
        delivered: List[Tuple[int, bool, int]] = []   # (edge, is_marker, data)
        chosen_src = set()
        for e in range(self.topo.e):                  # edges sorted (src, dst)
            src = int(self.topo.edge_src[e])
            if src in chosen_src:
                continue
            if self.queues[e] and self.queues[e][0][2] <= self.time:
                is_marker, data, _ = self.queues[e].popleft()
                delivered.append((e, is_marker, data))
                chosen_src.add(src)
        # 2. tokens first: credit + record against tick-start recording sets
        rec_at_start = {sid: set(edges) for sid, edges in self.recording.items()}
        for e, is_marker, data in delivered:
            if is_marker:
                continue
            dst = int(self.topo.edge_dst[e])
            self.tokens[dst] += data
            for sid, edges in rec_at_start.items():
                if e in edges:
                    self.recorded[sid].setdefault(e, []).append(data)
        # 3. markers grouped by ascending sid
        marker_edges: Dict[int, List[int]] = {}
        for e, is_marker, data in delivered:
            if is_marker:
                marker_edges.setdefault(data, []).append(e)
        to_broadcast: Dict[int, List[int]] = {}
        for sid in sorted(marker_edges):
            arrivals: Dict[int, List[int]] = {}
            for e in marker_edges[sid]:
                arrivals.setdefault(int(self.topo.edge_dst[e]), []).append(e)
            for node, edges in arrivals.items():
                self.recording[sid] -= set(edges)
                if node not in self.frozen[sid]:
                    # create: freeze post-credit balance, record all other
                    # inbound channels, schedule re-broadcast
                    self.frozen[sid][node] = self.tokens[node]
                    self.rem[sid][node] = int(self.topo.in_degree[node]) - len(edges)
                    for e2 in range(self.topo.e):
                        if (int(self.topo.edge_dst[e2]) == node
                                and e2 not in edges):
                            self.recording[sid].add(e2)
                    to_broadcast.setdefault(node, []).append(sid)
                else:
                    self.rem[sid][node] -= len(edges)
        self._broadcast(to_broadcast)
        # 4. finalize
        for sid in list(self.frozen):
            for node, r in self.rem[sid].items():
                if r == 0 and node not in self.done[sid]:
                    self.done[sid].add(node)
                    self.completed[sid] += 1

    # -- drain -------------------------------------------------------------

    def drain_and_flush(self, max_ticks: int = 100_000) -> None:
        guard = 0
        while any(c < self.topo.n for c in self.completed.values()):
            self.tick()
            guard += 1
            if guard > max_ticks:
                raise RuntimeError("oracle drain did not converge")
        for _ in range(self.delay.max_delay + 1):
            self.tick()
