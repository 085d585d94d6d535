"""Shape-bucketed serve-step cache: the port's counterpart of the JAX
package's ``jax.export`` executable cache.

The port's serve step is eager PyTorch over the hand-written kernels of
``kernels/csrc``; what a cold server pays before its first step is
building and loading those kernel libraries (``nvcc``, seconds to a
minute), not tracing. What the step runs is a pure function of a small
identity: the runner's resolved execution identity (the memo plane's
``job_digest`` recipe less per-job content), the step shape
(``stretch``, ``drain_chunk``), the dtypes and shapes of every operand,
torch's version, the card's compute capability and the kernel sources'
digests (``kernels/_build._target``). That identity is the BUCKET.

Three planes, consulted in order:

  memory  a bucket already made ready in this process: nothing to do.
  disk    a record of the bucket under the cache directory names the
          built libraries; when they are all in ``kernels/build/`` a
          restarted server loads them without running ``nvcc``.
  fresh   build (``nvcc``) and load the libraries, then write the
          bucket's record for the next process.

``step_for`` returns the serve step bound to the runner it is given, and
records what happened in ``self.last`` (``bucket``, ``source``,
``warmup_s``, ``persisted``, ``builds``: the ``nvcc`` runs it made).
``warmup_s`` brackets the libraries' build and load and the lane
template's construction. A damaged or stale record degrades to the fresh
plane (``disk_error`` in ``self.last``); a failed build or load raises,
and nothing falls back to the kernels' plain forms.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import time
from dataclasses import asdict
from typing import Optional

import numpy as np

from chandy_lamport_tpu_torch.utils.atomicio import (
    crash_failpoint,
    fsync_dir,
    fsync_file,
)
from chandy_lamport_tpu_torch.utils.filelock import locked
from chandy_lamport_tpu_torch.utils.memocache import _canon

EXEC_CACHE_SCHEMA_VERSION = 1


def _leaves(tree) -> list:
    """The leaves of ``tree`` (tuples, named tuples, lists, dicts), None
    kept as a leaf."""
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _aval(x):
    import torch

    if x is None:
        return None
    if torch.is_tensor(x):
        return (str(x.dtype).replace("torch.", ""), list(x.shape))
    a = np.asarray(x)
    return (str(a.dtype), list(a.shape))


def _libraries(runner) -> tuple:
    """The kernel sources the runner's step launches: all of them on the
    card, none on the CPU (the wrappers take their plain forms)."""
    from chandy_lamport_tpu_torch.kernels import _build

    return _build.SOURCES if runner.device.type == "cuda" else ()


def _serve_step(runner, stretch, drain_chunk, s, st, pool, order,
                followers, limit, tenant_of, arrival_of, deadline_of,
                bank=None, fork_src=None, fork_depth=None):
    """The serve step (``BatchedRunner._stream_step(serve=True)``) in the
    JAX serve step's operand order. Coalescing is host work at ingest, so
    admission is memo-free except under "prefix", whose forks are made in
    the step."""
    return runner._stream_step(
        s, st, pool, stretch, drain_chunk, False,
        "prefix" if runner.memo == "prefix" else "off", order=order,
        followers=followers, bank=bank, fork_src=fork_src,
        fork_depth=fork_depth, serve=True, limit=limit,
        tenant_of=tenant_of, arrival_of=arrival_of,
        deadline_of=deadline_of)


class ExecutableCache:
    """See module docstring. ``path`` is a DIRECTORY (created lazily);
    ``path=None`` keeps the memory plane only."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mem: set = set()
        # books of the most recent step_for
        self.last: Optional[dict] = None

    # -- bucket identity -------------------------------------------------

    def bucket_digest(self, runner, stretch: int, drain_chunk: int,
                      example_args) -> str:
        """sha256 over everything that decides what the serve step runs:
        torch's version, the device and the card's compute capability,
        the kernel sources' digests, the runner's resolved identity, the
        step shape and the operands' dtypes and shapes."""
        import torch

        from chandy_lamport_tpu_torch.kernels import _build

        dev = runner.device
        payload = {
            "schema": EXEC_CACHE_SCHEMA_VERSION,
            "torch": torch.__version__,
            "device": dev.type,
            "capability": (list(torch.cuda.get_device_capability(dev))
                           if dev.type == "cuda" else None),
            "kernels": {name: os.path.basename(_build._target(name))
                        for name in _build.SOURCES},
            "nodes": _canon(sorted((str(k), int(v))
                                   for k, v in runner._topo_spec.nodes)),
            "links": _canon(sorted((str(s), str(d))
                                   for s, d in runner._topo_spec.links)),
            "scheduler": str(runner.scheduler),
            "knobs": _canon({
                "queue_engine": runner.queue_engine,
                "kernel_engine": runner.kernel_engine,
                "exact_impl": runner.kernel.exact_impl,
                "megatick": runner.megatick,
                "fused": runner.fused,
                "fused_tile": runner.fused_tile,
                "check_every": runner.check_every,
                "quarantine": runner.quarantine,
                "memo": runner.memo,
                "delay_kind": type(runner.delay).__name__,
                "faults": (None if runner.faults is None
                           else sorted(vars(runner.faults).items())),
            }),
            "config": _canon(asdict(runner.config)),
            "batch": int(runner.batch),
            "stretch": int(stretch),
            "drain_chunk": int(drain_chunk),
            "avals": [_aval(x) for x in _leaves(example_args)],
        }
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()

    def _record_path(self, key: str) -> Optional[str]:
        if not self.path:
            return None
        return os.path.join(self.path, f"serve-step-{key}.json")

    # -- the cache lookup ------------------------------------------------

    def step_for(self, runner, stretch: int, drain_chunk: int,
                 example_args):
        """The serve step for this bucket, bound to ``runner``, with its
        kernel libraries loaded (built first on the fresh plane);
        ``self.last`` records the books."""
        from chandy_lamport_tpu_torch.kernels import _build

        key = self.bucket_digest(runner, stretch, drain_chunk, example_args)
        call = functools.partial(_serve_step, runner, int(stretch),
                                 int(drain_chunk))
        t0 = time.perf_counter()
        builds = _build.builds
        if key in self._mem:
            runner._lane_template()
            self.last = {"bucket": key, "source": "memory",
                         "warmup_s": time.perf_counter() - t0,
                         "persisted": False, "builds": 0}
            return call
        libs = _libraries(runner)
        source, disk_error, persisted = "fresh", None, False
        rpath = self._record_path(key)
        if rpath and os.path.exists(rpath):
            try:
                with locked(rpath, shared=True):
                    with open(rpath, "rb") as f:
                        rec = json.loads(f.read())
                want = {n: os.path.basename(_build._target(n)) for n in libs}
                if (rec.get("schema") != EXEC_CACHE_SCHEMA_VERSION
                        or rec.get("bucket") != key
                        or rec.get("libraries") != want):
                    raise ValueError("record does not describe this bucket")
                missing = [n for n in libs
                           if not os.path.exists(_build._target(n))]
                if missing:
                    raise FileNotFoundError(
                        f"libraries not built: {', '.join(missing)}")
                source = "disk"
            except (OSError, ValueError, AttributeError, TypeError) as exc:
                # a damaged or stale record: degrade to the fresh plane
                disk_error = f"{type(exc).__name__}: {exc}"
        # a build or a load failure raises: no plain-form fallback
        for name in libs:
            _build.library(name)
        runner._lane_template()
        if source == "fresh" and rpath:
            persisted, err = self._persist(rpath, key, libs)
            disk_error = disk_error or err
        self._mem.add(key)
        self.last = {"bucket": key, "source": source,
                     "warmup_s": time.perf_counter() - t0,
                     "persisted": persisted,
                     "builds": _build.builds - builds}
        if disk_error:
            self.last["disk_error"] = disk_error
        return call

    @staticmethod
    def _persist(rpath: str, key: str, libs) -> tuple:
        """Write the bucket's record atomically (tmp + rename) under an
        exclusive advisory lock (utils/filelock), so a killed server never
        leaves a torn record and two servers never race the rename."""
        import torch

        from chandy_lamport_tpu_torch.kernels import _build

        try:
            rec = {"schema": EXEC_CACHE_SCHEMA_VERSION, "bucket": key,
                   "torch": torch.__version__,
                   "libraries": {n: os.path.basename(_build._target(n))
                                 for n in libs}}
            os.makedirs(os.path.dirname(rpath) or ".", exist_ok=True)
            tmp = rpath + ".tmp"
            with locked(rpath):
                with open(tmp, "w") as f:
                    f.write(json.dumps(rec, sort_keys=True))
                    fsync_file(f)
                crash_failpoint("execcache-replace")
                os.replace(tmp, rpath)
                fsync_dir(rpath)
            return True, None
        except OSError as exc:
            return False, f"{type(exc).__name__}: {exc}"
