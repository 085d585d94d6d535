"""Parsers for the ``.top`` / ``.events`` / ``.snap`` fixture formats and
the parsed-topology type (a copy of the JAX package's
``utils/fixtures.py``).

Format specs (reference test_common.go:22-28, 70-78, 142-148):
  .top     first non-comment line = N; next N lines ``nodeId numTokens``;
           remaining lines ``src dest`` unidirectional links; ``#`` comments.
  .events  commands ``send SRC DEST K``, ``snapshot NODE``, ``tick [N]``
           (default N=1). Events between ticks share the same sim time.
  .snap    1 field = snapshot id; 2 fields = ``nodeId numTokens``;
           3 fields = ``src dest token(K)``. Goldens never contain markers
           (test_common.go:176-187 only parses token messages).
"""

from __future__ import annotations

import re
from typing import List, Tuple

from chandy_lamport_tpu_torch.core.spec import (
    Event,
    GlobalSnapshot,
    Message,
    MsgSnapshot,
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)


class TopologySpec:
    """Node ids with initial tokens + directed links."""

    def __init__(self, nodes: List[Tuple[str, int]],
                 links: List[Tuple[str, str]]):
        self.nodes = nodes
        self.links = links

    @property
    def node_ids(self) -> List[str]:
        return [n for n, _ in self.nodes]


def _lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln for ln in (raw.strip() for raw in f)
                if ln and not ln.startswith("#")]


def read_topology_file(path: str) -> TopologySpec:
    """Parse a ``.top`` file (reference test_common.go:29-68)."""
    lines = _lines(path)
    n = int(lines[0])
    nodes: List[Tuple[str, int]] = []
    links: List[Tuple[str, str]] = []
    for ln in lines[1:]:
        parts = ln.split()
        if len(parts) != 2:
            raise ValueError(f"expected 2 fields in line: {ln!r}")
        if len(nodes) < n:
            nodes.append((parts[0], int(parts[1])))
        else:
            links.append((parts[0], parts[1]))
    if len(nodes) != n:
        raise ValueError(f"expected {n} nodes, got {len(nodes)}")
    return TopologySpec(nodes, links)


def read_events_file(path: str) -> List[Event]:
    """Parse a ``.events`` file into a typed event list
    (reference test_common.go:79-121, execution factored out)."""
    events: List[Event] = []
    for ln in _lines(path):
        parts = ln.split()
        cmd = parts[0]
        if cmd == "send":
            events.append(PassTokenEvent(parts[1], parts[2], int(parts[3])))
        elif cmd == "snapshot":
            events.append(SnapshotEvent(parts[1]))
        elif cmd == "tick":
            events.append(TickEvent(int(parts[1]) if len(parts) > 1 else 1))
        else:
            raise ValueError(f"unknown event command: {cmd!r}")
    return events


_TOKEN_RE = re.compile(r"[0-9]+")


def read_snapshot_file(path: str) -> GlobalSnapshot:
    """Parse a ``.snap`` golden file (reference test_common.go:149-193)."""
    snap = GlobalSnapshot(0, {}, [])
    for ln in _lines(path):
        parts = ln.split()
        if len(parts) == 1:
            snap.id = int(parts[0])
        elif len(parts) == 2:
            snap.token_map[parts[0]] = int(parts[1])
        elif len(parts) == 3:
            if "token" not in parts[2]:
                raise ValueError(f"unknown message: {parts[2]!r}")
            m = _TOKEN_RE.findall(parts[2])
            if len(m) != 1:
                raise ValueError(
                    f"unable to parse token message: {parts[2]!r}")
            snap.messages.append(MsgSnapshot(
                parts[0], parts[1], Message(is_marker=False, data=int(m[0]))))
        else:
            raise ValueError(f"bad snapshot line: {ln!r}")
    return snap
