"""The online serving front-end over the stream engine (the JAX package's
``serving/``, less its spool and fleet: ROADMAP A10b).

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
from chandy_lamport_tpu_torch.serving.server import (
    SERVE_SCHEMA_VERSION,
    serve_run,
)

__all__ = [
    "EXEC_CACHE_SCHEMA_VERSION",
    "ExecutableCache",
    "SERVE_SCHEMA_VERSION",
    "admission_key",
    "order_eligible",
    "plan_ingest",
    "resolve_serve_policy",
    "serve_run",
    "shed_order",
]
