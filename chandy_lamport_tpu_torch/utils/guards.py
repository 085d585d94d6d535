"""Runtime contract guards: no kernel builds and no un-sited host syncs in
a steady-state loop (the JAX package's ``utils/guards.py``, its three
contracts in PyTorch terms).

  transfers   ``"disallow"`` / ``"log"`` / ``"allow"`` set
              ``torch.cuda.set_sync_debug_mode("error" / "warn" /
              "default")`` inside the armed region: an operation that
              makes the host wait for the card (a read such as
              ``.cpu()``, ``.item()`` or ``bool()`` of a CUDA tensor, a
              copy from pageable host memory, ``nonzero``) raises or
              warns at the offending line. Every intentional one goes
              through a NAMED SITE (``guarded_get``, ``guarded_put``,
              ``relaxed_site``, ``host_sync``), which runs with the mode
              relaxed and is counted per site in ``books()["transfers"]``.
  retraces    eager PyTorch traces nothing; what a steady-state loop must
              not do is build a kernel. ``books()["compiles"]`` counts the
              kernel library builds (``kernels/_build._build_all``, one
              per ``nvcc`` run) made while armed: 0 once warm.
  leaks       eager PyTorch has no tracer to leak: ``leaks=`` is accepted
              and nothing is checked.

On the CPU there is no sync mode to set; the site books are kept all the
same.

The port's stream step is host-driven: its lane pass reads its stage
gates and the exact tick's folds on the host every step, where the JAX
step is one jitted program. Those reads run inside the ``host_sync``
site ``"stream-lane-pass"``, and the recorder's appends, which gather
their slots with ``nonzero``, inside ``"stream-recorder"``; both are
counted on every armed guard (they have no JAX counterpart).

Wiring, as in JAX: ``BatchedRunner(..., guards=RuntimeGuards())`` arms
the ``run_stream`` loop and ``serve_run(..., guards=...)`` the serve loop
(defaulting to the runner's). The module-level helpers are no-ops on the
books when ``guards`` is None.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

# the transfer policy's sync debug mode (torch.cuda.set_sync_debug_mode)
SYNC_MODES = {"allow": 0, "log": 1, "disallow": 2}

# guards inside an ``armed()`` region, innermost last
_ACTIVE: List["RuntimeGuards"] = []
# the sync modes of the open regions, innermost last (kept on the CPU too)
_MODES: List[int] = []


def _cuda():
    import torch

    return torch.cuda if torch.cuda.is_available() else None


def sync_mode() -> int:
    """The sync mode the innermost open region asks for (0 outside any):
    what the card enforces, and what a CPU test can check against."""
    return _MODES[-1] if _MODES else 0


@contextlib.contextmanager
def _sync_mode(mode: int):
    """The CUDA sync debug mode set to ``mode`` for a region (on a
    machine without CUDA only ``sync_mode()`` says so)."""
    cuda = _cuda()
    prev = cuda.get_sync_debug_mode() if cuda is not None else None
    _MODES.append(mode)
    if cuda is not None:
        cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        _MODES.pop()
        if cuda is not None:
            cuda.set_sync_debug_mode(prev)


def _relaxed():
    """Syncs allowed for a region, when an armed region forbids them."""
    return _sync_mode(0) if _ACTIVE else contextlib.nullcontext()


def _build_count() -> int:
    from chandy_lamport_tpu_torch.kernels import _build

    return _build.builds


class RuntimeGuards:
    """Armable runtime contract checker (module docstring). One instance
    per drive; ``reset()`` between a warmup pass and the guarded pass
    separates build noise from the steady state."""

    def __init__(self, transfers: str = "disallow", leaks: bool = True):
        if transfers not in ("allow", "log", "disallow"):
            raise ValueError(
                f"transfers must be allow|log|disallow, got {transfers!r}")
        self.transfers = transfers
        self.leaks = bool(leaks)
        self._compiles = 0
        self._transfer_counts: Dict[str, int] = {}
        self._armed_regions = 0

    # -- books -----------------------------------------------------------

    def reset(self) -> None:
        self._compiles = 0
        self._transfer_counts = {}
        self._armed_regions = 0

    def books(self) -> dict:
        """JSON-able guard books: kernel builds made while armed, per-site
        transfer counts, armed-region count (the JAX keys)."""
        return {
            "compiles": int(self._compiles),
            "transfers": dict(sorted(self._transfer_counts.items())),
            "armed_regions": int(self._armed_regions),
        }

    def count(self, site: str) -> None:
        self._transfer_counts[site] = self._transfer_counts.get(site, 0) + 1

    # -- arming ----------------------------------------------------------

    @contextlib.contextmanager
    def armed(self):
        """Arm the sync debug mode and the build counter for a region (the
        steady-state device loop)."""
        self._armed_regions += 1
        builds = _build_count()
        _ACTIVE.append(self)
        try:
            with _sync_mode(SYNC_MODES[self.transfers]):
                yield self
        finally:
            _ACTIVE.remove(self)
            self._compiles += _build_count() - builds

    @contextlib.contextmanager
    def relaxed(self, site: str):
        """Allow syncs for one named site (e.g. a checkpoint save that
        copies the whole carry to the host), counted like any site."""
        self.count(site)
        with _relaxed():
            yield


def _map(tree, leaf):
    """``tree`` (tensors, arrays and scalars in tuples, named tuples,
    lists and dicts; None passes) with ``leaf`` applied to every leaf."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(x, leaf) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(x, leaf) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(v, leaf) for k, v in tree.items()}
    return leaf(tree)


def guarded_get(guards: Optional[RuntimeGuards], site: str, tree):
    """Explicit device-to-host read through a named site: every tensor of
    ``tree`` as a numpy array (a tuple of 0-d tensors on one device in one
    copy). With guards None this is just the read: the hot loops use it
    unconditionally, so arming changes accounting, never behaviour."""
    import torch

    if guards is not None:
        guards.count(site)
    with _relaxed():
        if (isinstance(tree, tuple) and not hasattr(tree, "_fields")
                and tree and all(torch.is_tensor(x) and x.dim() == 0
                                 for x in tree)
                and len({(x.device, x.dtype) for x in tree}) == 1):
            return tuple(torch.stack(tree).cpu().numpy())
        return _map(tree, lambda x: x.cpu().numpy() if torch.is_tensor(x)
                    else x)


def guarded_put(guards: Optional[RuntimeGuards], site: str, tree, device):
    """Explicit host-to-device copy through a named site: every leaf of
    ``tree`` as a tensor on ``device`` (``torch.as_tensor``; a tensor
    already there is passed through)."""
    import torch

    if guards is not None:
        guards.count(site)
    with _relaxed():
        return _map(tree, lambda x: torch.as_tensor(x, device=device))


def armed(guards: Optional[RuntimeGuards]):
    """``guards.armed()`` or a null context when guards is None."""
    return guards.armed() if guards is not None else contextlib.nullcontext()


def relaxed_site(guards: Optional[RuntimeGuards], site: str):
    """``guards.relaxed(site)``, or when guards is None a region that
    allows syncs only if another guard is armed (uncounted)."""
    return guards.relaxed(site) if guards is not None else _relaxed()


def host_sync(site: str):
    """A host-driven sync of the port's own engine, which the JAX jitted
    step does not make (module docstring): counted on every armed guard
    and run with syncs allowed. A null context when nothing is armed."""
    if not _ACTIVE:
        return contextlib.nullcontext()
    for g in _ACTIVE:
        g.count(site)
    return _sync_mode(0)
