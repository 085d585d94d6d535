"""Run an event script: the port's front door to the golden path (the JAX
package's ``api.run_events_file`` with its dense backend, ``DenseSim`` at
its default megatick 8 — the fused megatick kernel on the card).

Bit-exact golden reproduction replays Go's PRNG stream seeded with
``REFERENCE_TEST_SEED + 1`` (snapshot_test.go:20) through the exact tick.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from chandy_lamport_tpu_torch.config import REFERENCE_TEST_SEED, SimConfig
from chandy_lamport_tpu_torch.core.dense import DenseSim
from chandy_lamport_tpu_torch.core.spec import GlobalSnapshot
from chandy_lamport_tpu_torch.ops.delay import GoExactDelay
from chandy_lamport_tpu_torch.utils.compare import (
    assert_snapshots_equal,
    check_tokens,
    sort_snapshots,
)
from chandy_lamport_tpu_torch.utils.fixtures import (
    read_events_file,
    read_snapshot_file,
    read_topology_file,
)
from chandy_lamport_tpu_torch.utils.goldens import (
    REFERENCE_TESTS,
    fixture_path,
)
from chandy_lamport_tpu_torch.utils.tracing import Trace


def run_events_file(top_path: str, events_path: str, *,
                    seed: int = REFERENCE_TEST_SEED + 1,
                    delay_model=None, config: Optional[SimConfig] = None,
                    trace: bool = False, exact_impl: str = "cascade",
                    faults=None, device=None) -> Tuple[List[GlobalSnapshot],
                                                       DenseSim]:
    """Parse fixture files and run them to completion — the ``runTest``
    equivalent (snapshot_test.go:11-44) minus the assertions — through
    ``DenseSim`` (the JAX function on its dense backend). Returns
    (snapshots, sim). The two paths are the JAX function's leading
    positional parameters; its third, ``backend``, waits for the parity
    backend (ROADMAP A12), so the rest are keyword-only, with the JAX
    names, defaults and meanings: ``delay_model`` (a port sampler; None
    is ``GoExactDelay(seed)``), ``config`` (None is ``SimConfig()``),
    ``trace=True`` (the flight recorder, ``Trace()`` at its default
    capacity: ``sim.trace.pretty()`` is then the run's timeline),
    ``exact_impl`` ("cascade", "wave" or "fold") and ``faults`` (a
    models/faults.Faults adversary). ``device=None`` means the card;
    without CUDA, pass ``device="cpu"``."""
    delay = delay_model if delay_model is not None else GoExactDelay(seed)
    sim = DenseSim(read_topology_file(top_path), delay,
                   config or SimConfig(), exact_impl, faults=faults,
                   device=device, trace=Trace() if trace else None)
    return sim.run_events(read_events_file(events_path)), sim


def check_reference_case(top: str, events: str, snaps: List[str],
                         device=None, trace: bool = False,
                         **kw) -> DenseSim:
    """One reference golden case (a ``REFERENCE_TESTS`` row) through
    ``run_events_file`` (``trace``: with the flight recorder armed; ``kw``
    its other keywords, e.g. ``faults`` or ``exact_impl``): raises unless
    the token check passes and every snapshot equals its ``.snap`` file
    under the reference comparator. Returns the finished simulation."""
    actual, sim = run_events_file(fixture_path(top), fixture_path(events),
                                  device=device, trace=trace, **kw)
    if len(actual) != len(snaps):
        raise AssertionError(f"{len(actual)} snapshots, expected "
                             f"{len(snaps)}")
    check_tokens(sim.node_tokens(), actual)
    expected = [read_snapshot_file(fixture_path(f)) for f in snaps]
    for e, a in zip(sort_snapshots(expected), sort_snapshots(actual)):
        assert_snapshots_equal(e, a)
    return sim


def run_reference_tests(device=None) -> List[Tuple[str, int, Optional[str]]]:
    """The 7 reference golden cases (snapshot_test.go:46-108) through
    ``check_reference_case``: per case (name, snapshots compared, None
    when it passes, else the reason it failed)."""
    results = []
    for top, events, snaps in REFERENCE_TESTS:
        name = events.removesuffix(".events")
        try:
            check_reference_case(top, events, snaps, device=device)
            results.append((name, len(snaps), None))
        except (AssertionError, ValueError, OSError, RuntimeError) as exc:
            # AssertionError covers SnapshotMismatch, RuntimeError the
            # sticky error bits (DenseBackendError)
            results.append((name, len(snaps), str(exc)))
    return results
