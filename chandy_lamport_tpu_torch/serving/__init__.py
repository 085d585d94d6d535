"""The online serving front-end over the stream engine (the JAX package's
``serving/``).

Layers (each its own module, host-side unless noted):

  admission    policy resolution (``serve_policy`` in config.
               ENGINE_KNOBS), the EDF/fifo queue ordering, and the
               deterministic ingest plan (quota refusal, summary-cache
               hits, duplicate coalescing, all decided in arrival order,
               never against device timing).
  executables  the shape-bucketed serve-step cache: memory, then a
               record on disk naming the built kernel libraries, then a
               fresh build; a restarted server at a seen bucket loads
               the libraries without ``nvcc``.
  server       ``serve_run``: the host loop driving BatchedRunner's
               serving-mode stream step (the device half is
               ``_stream_step(serve=True)`` in parallel/batch.py).
  spool        the write-ahead admission spool: an fsync-appended
               journal of admit/lease/done records arbitrating
               exactly-once serving across worker crashes (the JAX
               journal byte for byte; ``WAL_SCHEMA_VERSION`` stamps every
               record, a stale journal is refused with ``SpoolError``).
  fleet        the multi-process worker fleet over the spool: the
               supervisor (lease reclaim, doubling-backoff restart,
               poison quarantine, deadline-aware shedding) and the
               worker serve loop, its workers on the card.

``SERVE_SCHEMA_VERSION`` stamps every serve telemetry record
(``serve_schema`` key) and checkpoint meta, as in JAX.
"""

from chandy_lamport_tpu_torch.serving.admission import (
    admission_key,
    order_eligible,
    plan_ingest,
    resolve_serve_policy,
    shed_order,
)
from chandy_lamport_tpu_torch.serving.executables import (
    EXEC_CACHE_SCHEMA_VERSION,
    ExecutableCache,
)
from chandy_lamport_tpu_torch.serving.fleet import (
    fleet_run,
    recipe_runner,
    worker_serve,
)
from chandy_lamport_tpu_torch.serving.server import (
    SERVE_SCHEMA_VERSION,
    serve_run,
)
from chandy_lamport_tpu_torch.serving.spool import (
    WAL_SCHEMA_VERSION,
    AdmissionSpool,
    SpoolError,
    request_digest,
)

__all__ = [
    "EXEC_CACHE_SCHEMA_VERSION",
    "ExecutableCache",
    "SERVE_SCHEMA_VERSION",
    "WAL_SCHEMA_VERSION",
    "AdmissionSpool",
    "SpoolError",
    "admission_key",
    "fleet_run",
    "order_eligible",
    "plan_ingest",
    "recipe_runner",
    "request_digest",
    "resolve_serve_policy",
    "serve_run",
    "shed_order",
    "worker_serve",
]
