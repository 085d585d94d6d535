"""Golden snapshot comparison + token-conservation invariant (a copy of
the JAX package's ``utils/compare.py``).

The exact comparison semantics of the reference test harness:
  - assert_snapshots_equal   test_common.go:222-285
  - sort_snapshots           test_common.go:288-294
  - check_tokens             test_common.go:298-328
"""

from __future__ import annotations

from typing import Dict, List

from chandy_lamport_tpu_torch.core.spec import GlobalSnapshot, MsgSnapshot


class SnapshotMismatch(AssertionError):
    pass


def sort_snapshots(snaps: List[GlobalSnapshot]) -> List[GlobalSnapshot]:
    """Ascending by snapshot id (test_common.go:288-294)."""
    return sorted(snaps, key=lambda s: s.id)


def assert_snapshots_equal(expected: GlobalSnapshot, actual: GlobalSnapshot) -> None:
    """Equality up to cross-destination message interleaving.

    Per the reference (test_common.go:253-284): ids, token maps and total
    message counts must match exactly; messages are bucketed by destination
    and each destination's sequence must match exactly in order, while
    interleaving across destinations is ignored (collection order across
    nodes is nondeterministic in the reference, sim.go:146-166).
    """
    if expected.id != actual.id:
        raise SnapshotMismatch(f"snapshot ids differ: {expected.id} != {actual.id}")
    if len(expected.token_map) != len(actual.token_map):
        raise SnapshotMismatch(
            f"snapshot {expected.id}: node counts differ: "
            f"{sorted(expected.token_map)} vs {sorted(actual.token_map)}"
        )
    if len(expected.messages) != len(actual.messages):
        raise SnapshotMismatch(
            f"snapshot {expected.id}: message counts differ: "
            f"{_msgs_str(expected.messages)} vs {_msgs_str(actual.messages)}"
        )
    for nid, tok in expected.token_map.items():
        if actual.token_map.get(nid) != tok:
            raise SnapshotMismatch(
                f"snapshot {expected.id}: tokens on {nid} differ: "
                f"{tok} != {actual.token_map.get(nid)}"
            )
    exp_by_dest = _bucket_by_dest(expected.messages)
    act_by_dest = _bucket_by_dest(actual.messages)
    for dest, ems in exp_by_dest.items():
        ams = act_by_dest.get(dest, [])
        if ems != ams:
            raise SnapshotMismatch(
                f"snapshot {expected.id}: messages at {dest} differ:\n"
                f"expected: {_msgs_str(ems)}\nactual:   {_msgs_str(ams)}"
            )


def _bucket_by_dest(messages: List[MsgSnapshot]) -> Dict[str, List[MsgSnapshot]]:
    out: Dict[str, List[MsgSnapshot]] = {}
    for m in messages:
        out.setdefault(m.dest, []).append(m)
    return out


def _msgs_str(messages: List[MsgSnapshot]) -> str:
    return "[" + ", ".join(f"{m.src}->{m.dest}: {m.message}" for m in messages) + "]"


def check_tokens(current_node_tokens: Dict[str, int], snapshots: List[GlobalSnapshot]) -> None:
    """Token conservation (test_common.go:298-328): for every snapshot,
    sum(frozen node balances) + sum(non-marker recorded message tokens)
    must equal the simulator's current total token count."""
    expected = sum(current_node_tokens.values())
    for snap in snapshots:
        got = sum(snap.token_map.values()) + sum(
            m.message.data for m in snap.messages if not m.message.is_marker
        )
        if got != expected:
            raise SnapshotMismatch(
                f"snapshot {snap.id}: simulator has {expected} tokens, snapshot has {got}"
            )

