"""Run event scripts against either backend: the port's front door to the
golden path (the JAX package's ``api.py``).

  - ``parity``  the pure-Python oracle (core/parity.py), host only
  - ``torch``   ``DenseSim`` at its default megatick 8 — the fused
                megatick kernel on the card (the JAX package's "jax")

Both accept a host delay model (models/delay.py; ``DenseSim`` maps it to
its device twin); ``torch`` also a device sampler (ops/delay.py).
Bit-exact golden reproduction replays Go's PRNG stream seeded with
``REFERENCE_TEST_SEED + 1`` (snapshot_test.go:20). The one deliberate
difference from the JAX functions: the default backend is ``torch``, not
``parity``, since the port's entry points run on the card; a bare call
on a machine without CUDA raises unless it names ``device="cpu"`` or
``backend="parity"``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from chandy_lamport_tpu_torch.config import (
    MAX_DELAY,
    REFERENCE_TEST_SEED,
    SimConfig,
)
from chandy_lamport_tpu_torch.core.dense import DenseSim
from chandy_lamport_tpu_torch.core.spec import Event, GlobalSnapshot
from chandy_lamport_tpu_torch.models.delay import DelayModel, GoExactDelay
from chandy_lamport_tpu_torch.utils.compare import (
    assert_snapshots_equal,
    check_tokens,
    sort_snapshots,
)
from chandy_lamport_tpu_torch.utils.fixtures import (
    TopologySpec,
    read_events_file,
    read_snapshot_file,
    read_topology_file,
)
from chandy_lamport_tpu_torch.utils.goldens import (
    REFERENCE_TESTS,
    fixture_path,
)
from chandy_lamport_tpu_torch.utils.tracing import Trace

BACKENDS = ("parity", "torch")


def make_backend(name: str, topology: TopologySpec, delay_model,
                 config: Optional[SimConfig] = None, trace: bool = False,
                 exact_impl: str = "cascade", faults=None, *, device=None):
    """A simulation of ``topology`` on backend ``name`` (the JAX
    ``make_backend``, "torch" in the place of "jax"): a ``ParitySim``
    (whose delay must be a host model; it refuses ``exact_impl`` other
    than "cascade" and ``faults``, as in JAX) or a ``DenseSim`` with the
    flight recorder armed when ``trace`` (``sim.trace.pretty()`` prints
    the same timeline on either backend). ``device`` (keyword-only, the
    port's own): where ``DenseSim`` runs, None meaning the card; the
    parity oracle runs on the host and ignores it."""
    if name == "parity":
        if exact_impl != "cascade":
            raise ValueError(
                "exact_impl is a torch-backend knob (the parity oracle has "
                "one reference-literal implementation); use "
                "backend='torch'")
        if faults is not None:
            raise ValueError(
                "the fault adversary is a torch-backend feature (the "
                "parity oracle is the uninjured reference); use "
                "backend='torch'")
        if not isinstance(delay_model, DelayModel):
            raise TypeError(
                f"the parity oracle draws from a host delay model "
                f"(models/delay.py), not {type(delay_model).__name__}")
        from chandy_lamport_tpu_torch.core.parity import ParitySim

        sim = ParitySim(delay_model,
                        max_delay=getattr(delay_model, "max_delay",
                                          MAX_DELAY),
                        trace=trace)
        for nid, tokens in topology.nodes:
            sim.add_node(nid, tokens)
        for src, dest in topology.links:
            sim.add_link(src, dest)
        return sim
    if name == "torch":
        return DenseSim(topology, delay_model, config or SimConfig(),
                        exact_impl, faults=faults, device=device,
                        trace=Trace() if trace else None)
    raise ValueError(f"unknown backend {name!r} (expected 'parity' or "
                     f"'torch')")


def run_events(backend_name: str, topology: TopologySpec,
               events: List[Event], delay_model,
               config: Optional[SimConfig] = None, trace: bool = False,
               exact_impl: str = "cascade", faults=None, *, device=None):
    """Run a parsed event script to completion on ``backend_name`` (the
    JAX ``run_events``); returns (snapshots, sim). ``exact_impl``
    ("cascade", "wave" or "fold") and ``faults`` (a models/faults.Faults
    adversary) are the torch backend's; ``device`` its device."""
    sim = make_backend(backend_name, topology, delay_model, config,
                       trace=trace, exact_impl=exact_impl, faults=faults,
                       device=device)
    if backend_name == "parity":
        from chandy_lamport_tpu_torch.core.parity import run_events as _run

        return _run(sim, events), sim
    return sim.run_events(events), sim


def run_events_file(top_path: str, events_path: str, backend: str = "torch",
                    *, seed: int = REFERENCE_TEST_SEED + 1,
                    delay_model=None, config: Optional[SimConfig] = None,
                    trace: bool = False, exact_impl: str = "cascade",
                    faults=None, device=None) -> Tuple[List[GlobalSnapshot],
                                                       object]:
    """Parse fixture files and run them to completion — the ``runTest``
    equivalent (snapshot_test.go:11-44) minus the assertions. Returns
    (snapshots, sim). The JAX function's parameters, names and defaults
    but one: ``backend`` defaults to "torch" (module docstring). The
    keywords: ``delay_model`` (None is the host ``GoExactDelay(seed)``,
    which the torch backend maps to its device twin), ``config`` (None is
    ``SimConfig()``), ``trace=True`` (the parity backend's
    ``EpochTrace`` or the flight recorder: ``sim.trace.pretty()`` is the
    run's timeline on either), ``exact_impl`` ("cascade", "wave" or
    "fold") and ``faults`` (a models/faults.Faults adversary), both the
    torch backend's. ``device=None`` means the card; without CUDA, pass
    ``device="cpu"``."""
    delay = delay_model if delay_model is not None else GoExactDelay(seed)
    return run_events(backend, read_topology_file(top_path),
                      read_events_file(events_path), delay, config,
                      trace=trace, exact_impl=exact_impl, faults=faults,
                      device=device)


def check_reference_case(top: str, events: str, snaps: List[str],
                         device=None, trace: bool = False,
                         backend: str = "torch", **kw):
    """One reference golden case (a ``REFERENCE_TESTS`` row) through
    ``run_events_file`` on ``backend`` (``trace``: with the flight
    recorder or the parity trace armed; ``kw`` its other keywords, e.g.
    ``faults`` or ``exact_impl``): raises unless the token check passes
    and every snapshot equals its ``.snap`` file under the reference
    comparator. Returns the finished simulation."""
    actual, sim = run_events_file(fixture_path(top), fixture_path(events),
                                  backend, device=device, trace=trace,
                                  **kw)
    if len(actual) != len(snaps):
        raise AssertionError(f"{len(actual)} snapshots, expected "
                             f"{len(snaps)}")
    check_tokens(sim.node_tokens(), actual)
    expected = [read_snapshot_file(fixture_path(f)) for f in snaps]
    for e, a in zip(sort_snapshots(expected), sort_snapshots(actual)):
        assert_snapshots_equal(e, a)
    return sim


def run_reference_tests(device=None, backend: str = "torch",
                        **kw) -> List[Tuple[str, int, Optional[str]]]:
    """The 7 reference golden cases (snapshot_test.go:46-108) through
    ``check_reference_case`` on ``backend`` (``kw``: its other keywords,
    e.g. ``exact_impl``): per case (name, snapshots compared, None when it
    passes, else the reason it failed)."""
    results = []
    for top, events, snaps in REFERENCE_TESTS:
        name = events.removesuffix(".events")
        try:
            check_reference_case(top, events, snaps, device=device,
                                 backend=backend, **kw)
            results.append((name, len(snaps), None))
        except (AssertionError, ValueError, OSError, RuntimeError) as exc:
            # AssertionError covers SnapshotMismatch, RuntimeError the
            # sticky error bits (DenseBackendError)
            results.append((name, len(snaps), str(exc)))
    return results
