"""PyTorch + CUDA port of chandy_lamport_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference: the same
dense encoding (``core/state.py``), the same sync and exact (cascade,
wave and fold) ticks (``ops/tick.py``) over an explicit lane axis
(``parallel/batch.py``), the delay samplers (hash, Go-exact, fixed and
threefry, ``ops/delay.py``), the fault adversary (``models/faults.py``),
snapshot supervisor and quarantine,
the single-instance golden runner (``core/dense.py``, ``api.py``),
compiled event scripts and the streaming job engine
(``BatchedRunner.run``, ``run_stream``), the flight recorder
(``utils/tracing.py``, ``trace=``), checkpoints (``utils/checkpoint.py``),
the stream's memo plane (``BatchedRunner(memo=...)``,
``utils/memocache.py``), the serving front-end (``serving/``) with the
runtime guards (``utils/guards.py``), and the Pallas kernels of those paths
hand-written in CUDA C++ (``kernels/csrc``).
It imports neither jax nor chandy_lamport_tpu.

Entry points run on the card unless the caller passes ``device="cpu"``::

    from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
    from chandy_lamport_tpu_torch.models.workloads import scale_free
    from chandy_lamport_tpu_torch.ops.delay import HashDelay

    snaps, sim = run_events_file("x.top", "x.events")   # Go-exact delays

A batched storm with the JAX CLI's defaults and counters line: ``python
-m chandy_lamport_tpu_torch storm``; the bench row: ``python -m
chandy_lamport_tpu_torch bench`` (``--stream`` for the streaming row); a
job stream: ``python -m chandy_lamport_tpu_torch stream``; a served
schedule (``serving.serve_run``): ``python -m chandy_lamport_tpu_torch
serve``; the 7
reference goldens: ``python -m chandy_lamport_tpu_torch test``; a
fixture's timeline: ``python -m chandy_lamport_tpu_torch trace TOP
EVENTS``.
"""

from chandy_lamport_tpu_torch.api import run_events_file
from chandy_lamport_tpu_torch.config import MAX_DELAY, SimConfig
from chandy_lamport_tpu_torch.core.dense import DenseSim
from chandy_lamport_tpu_torch.core.spec import (
    GlobalSnapshot,
    Message,
    MsgSnapshot,
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "MAX_DELAY",
    "Message",
    "MsgSnapshot",
    "GlobalSnapshot",
    "PassTokenEvent",
    "SnapshotEvent",
    "TickEvent",
    "run_events_file",
    "BatchedRunner",
    "DenseSim",
    "__version__",
]
