"""Random workload generators for differential tests (the port's copy of
the JAX package's ``utils/randgen.py``: the same ``random.Random`` calls in
the same order, so both packages draw equal graphs and scripts from equal
seeds).

The reference has only 7 hand-written cases (snapshot_test.go:46-108); the
randomized suites need topologies that are strongly connected (snapshot
completion requires it, reference sim.go:116-117) and scripts whose sends can
never trip the insufficient-balance fatal (node.go:113-116), so any observed
divergence is a real kernel bug.
"""

from __future__ import annotations

import random
from typing import List

from chandy_lamport_tpu_torch.core.spec import (
    Event,
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec


def random_strongly_connected(rng: random.Random, n: int) -> TopologySpec:
    """Ring (guarantees strong connectivity) + random extra arcs; node ids
    deliberately collide lexicographically (N1, N10, N2...) to exercise the
    sort rule R1."""
    ids = [f"N{i + 1}" for i in range(n)]
    nodes = [(nid, rng.randrange(50, 200)) for nid in ids]
    order = ids[:]
    rng.shuffle(order)
    links = {(order[i], order[(i + 1) % n]) for i in range(n)}
    for _ in range(rng.randrange(0, 2 * n)):
        a, b = rng.sample(ids, 2)
        links.add((a, b))
    return TopologySpec(nodes, sorted(links))


def random_script(rng: random.Random, topo: TopologySpec,
                  n_events: int) -> List[Event]:
    """Random sends/snapshots/ticks. Send amounts stay within a pessimistic
    balance floor (credits ignored) so the reference's insufficient-balance
    fatal (node.go:113-116) can never fire."""
    floor = {nid: tok for nid, tok in topo.nodes}
    out = {}
    for s, d in topo.links:
        out.setdefault(s, []).append(d)
    events: List[Event] = []
    snapshots = 0
    for _ in range(n_events):
        r = rng.random()
        if r < 0.5:
            src = rng.choice(list(out))
            dest = rng.choice(out[src])
            amt = rng.randrange(1, 4)
            if floor[src] >= amt:
                floor[src] -= amt
                events.append(PassTokenEvent(src, dest, amt))
        elif r < 0.7 and snapshots < 12:
            events.append(SnapshotEvent(rng.choice([n for n, _ in topo.nodes])))
            snapshots += 1
        else:
            events.append(TickEvent(rng.randrange(1, 4)))
    if snapshots == 0:
        events.append(SnapshotEvent(topo.nodes[0][0]))
    return events
