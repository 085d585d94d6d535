"""Protocol data types (a copy of the JAX package's ``core/spec.py``).

These mirror the reference's L0 types (common.go) as plain Python
dataclasses; the dense backend encodes the same information as tensors
(core/state.py) and decodes back to these types at the API boundary.

Reference citations:
  - Message            common.go:28-39  (one struct for tokens AND markers)
  - MsgSnapshot        common.go:20-24
  - GlobalSnapshot     common.go:13-17
  - PassTokenEvent     common.go:58-62
  - SnapshotEvent      common.go:66-68
  - "tick" is a command in .events files (test_common.go:109-117), modeled
    here as TickEvent so an event script is a single typed list.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Union


@dataclasses.dataclass(frozen=True)
class Message:
    """A message on a channel: a token transfer or a snapshot marker.

    ``data`` is the token count for tokens, the snapshot id for markers
    (reference common.go:28-31). ``str()`` matches the Go rendering
    ``token(n)`` / ``marker(n)`` (common.go:33-39), which the golden-file
    format round-trips through.
    """

    is_marker: bool
    data: int

    def __str__(self) -> str:
        return f"marker({self.data})" if self.is_marker else f"token({self.data})"


@dataclasses.dataclass(frozen=True)
class MsgSnapshot:
    """A message recorded in-flight on the channel src->dest during a snapshot
    (reference common.go:20-24)."""

    src: str
    dest: str
    message: Message


@dataclasses.dataclass
class GlobalSnapshot:
    """The output of the Chandy-Lamport algorithm (reference common.go:13-17).

    ``token_map`` maps node id -> tokens frozen at that node's snapshot point;
    ``messages`` are all recorded in-flight messages. Cross-destination
    ordering of ``messages`` is not part of the contract (the golden
    comparator only requires per-destination order, test_common.go:253-284);
    our backends emit them grouped by lexicographically sorted destination
    node, each destination's messages in arrival order.
    """

    id: int
    token_map: Dict[str, int]
    messages: List[MsgSnapshot]


@dataclasses.dataclass(frozen=True)
class PassTokenEvent:
    """Injected event: src sends ``tokens`` tokens to dest (common.go:58-62)."""

    src: str
    dest: str
    tokens: int


@dataclasses.dataclass(frozen=True)
class SnapshotEvent:
    """Injected event: start the snapshot protocol at ``node_id``
    (common.go:66-68)."""

    node_id: str


@dataclasses.dataclass(frozen=True)
class TickEvent:
    """Advance simulation time by ``n`` steps (.events ``tick [N]`` command,
    test_common.go:109-117)."""

    n: int = 1


Event = Union[PassTokenEvent, SnapshotEvent, TickEvent]
