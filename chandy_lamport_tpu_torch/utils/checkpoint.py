"""Checkpoints of the port's state, in the JAX package's file format.

The port of the JAX package's ``utils/checkpoint.py``: ``save_state`` and
``load_state`` for a batched ``DenseState``, the streaming engine's
``(DenseState, StreamState)`` pair or a graph-sharded ``ShardedState``
(parallel/graphshard.py; its 0-d replicated leaves included, the JAX
package writing ``meta={"kind": "sharded", "shards": P}`` beside it), ``restore_from_snapshot`` for the
protocol's own recovery line, and ``CheckpointError``.

The file is the JAX package's: one ``.npz`` holding every leaf as
``leaf_<i>`` in the JAX flatten order (the fields in order, the delay
sampler's words in place of ``delay_state``) and a ``__header__`` JSON
with ``format_version``, ``num_leaves``, ``treedef`` and ``meta``. The
leaves carry the JAX dtypes (uint32 words as uint32, ``utils/carry.py``
converts), and ``treedef`` is the string the JAX package's
``str(tree_structure(...))`` gives for the same structure, built here from
the field lists and the sampler's word count. So a file written by either
package loads in the other and resumes bit-exactly; a file written on the
card loads on the CPU and the other way round.

Preemption safety: ``save_state`` writes ``path + '.tmp'``, fsyncs it and
renames it over ``path``, so a kill at any instant leaves the previous
complete file or the new one (utils/atomicio.py). ``load_state`` raises
``CheckpointError`` naming the path for every damaged file: unreadable,
truncated, header-less, of another format version, structure, shape or
dtype.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib
from typing import List, Tuple

import numpy as np
import torch

from chandy_lamport_tpu_torch.core.state import (
    CHECKPOINT_FORMAT_VERSION,
    U32_LEAVES,
    WINDOW_LEAVES,
    DenseState,
    init_single_state,
    pack_meta,
    recorded_window,
)
from chandy_lamport_tpu_torch.parallel.batch import StreamState, resolve_device
from chandy_lamport_tpu_torch.parallel.graphshard import ShardedState
from chandy_lamport_tpu_torch.parallel.graphshard import (
    state_from_numpy as sharded_from_numpy,
)
from chandy_lamport_tpu_torch.parallel.graphshard import (
    state_to_numpy as sharded_to_numpy,
)
from chandy_lamport_tpu_torch.utils.atomicio import (
    crash_failpoint,
    fsync_dir,
    fsync_file,
)
from chandy_lamport_tpu_torch.utils.carry import (
    state_from_numpy,
    state_to_numpy,
    stream_from_numpy,
    stream_to_numpy,
)

_FORMAT_VERSION = CHECKPOINT_FORMAT_VERSION
# every layout change so far was breaking, so one version is live; a range
# keeps the error message true if a compatible revision widens the floor
_MIN_SUPPORTED_VERSION = _FORMAT_VERSION


class CheckpointError(ValueError):
    """A checkpoint file could not be read or validated; the message names
    the path."""


def _node(name: str, fields, words: int = -1, bare: bool = False) -> str:
    """The JAX ``str(treedef)`` of a NamedTuple node: ``*`` per leaf, the
    ``delay_state`` tuple of ``words`` leaves in place (one bare leaf
    where ``bare``: the threefry key)."""
    kids = []
    for field in fields:
        if field == "delay_state":
            kids.append("*" if bare else "(*,)" if words == 1
                        else "(" + ", ".join(["*"] * words) + ")")
        else:
            kids.append("*")
    return f"CustomNode(namedtuple[{name}], [{', '.join(kids)}])"


def _split(tree):
    """(state, stream or None) of a DenseState, a ShardedState or a
    (state, stream) pair."""
    if isinstance(tree, (DenseState, ShardedState)):
        return tree, None
    state, stream = tree
    if not (isinstance(state, DenseState)
            and isinstance(stream, StreamState)):
        raise TypeError("a checkpoint holds a DenseState or a "
                        "(DenseState, StreamState) pair")
    return state, stream


def treedef_string(tree, delay=None) -> str:
    """The JAX package's ``str(jax.tree_util.tree_structure(tree))`` for
    the same structure (the header's ``treedef``); ``delay``: the sampler
    whose words ``delay_state`` holds (a ``bare_leaf`` sampler's key is
    one leaf in the JAX tree)."""
    state, stream = _split(tree)
    if isinstance(state, ShardedState):
        return f"PyTreeDef({_node('ShardedState', ShardedState._fields)})"
    node = _node("DenseState", DenseState._fields, len(state.delay_state),
                 getattr(delay, "bare_leaf", False))
    if stream is None:
        return f"PyTreeDef({node})"
    return (f"PyTreeDef(({node}, "
            f"{_node('StreamState', StreamState._fields)}))")


def _flatten_host(tree, delay) -> List[np.ndarray]:
    """The tree's leaves as numpy arrays with the JAX dtypes, in the JAX
    flatten order."""
    state, stream = _split(tree)
    if isinstance(state, ShardedState):
        return list(sharded_to_numpy(state))
    host = state_to_numpy(state, delay)
    leaves = []
    for leaf in host:
        leaves.extend(leaf if isinstance(leaf, tuple) else (leaf,))
    if stream is not None:
        leaves.extend(stream_to_numpy(stream))
    return leaves


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _expected(like, delay) -> List[Tuple[tuple, np.dtype]]:
    """(shape, JAX dtype) of every leaf of ``like`` in the JAX flatten
    order, read off the tensors without copying them to the host."""
    state, stream = _split(like)
    out = []
    if isinstance(state, ShardedState):
        for name, leaf in zip(ShardedState._fields, state):
            dtype = (np.dtype(np.uint32) if name == "delay_key"
                     else np.dtype(np.uint16)
                     if name in WINDOW_LEAVES and leaf.dtype == torch.int16
                     else _np_dtype(leaf))
            out.append((tuple(leaf.shape), dtype))
        return out
    for name, leaf in zip(DenseState._fields, state):
        if name == "delay_state":
            dtypes = (delay.host_dtypes if delay is not None
                      else ("uint32",) * len(leaf))
            out.extend((tuple(w.shape), np.dtype(d))
                       for w, d in zip(leaf, dtypes))
        elif name in U32_LEAVES:
            out.append((tuple(leaf.shape), np.dtype(np.uint32)))
        elif name in WINDOW_LEAVES and leaf.dtype == torch.int16:
            out.append((tuple(leaf.shape), np.dtype(np.uint16)))
        else:
            out.append((tuple(leaf.shape), _np_dtype(leaf)))
    if stream is not None:
        out.extend((tuple(x.shape), np.dtype(np.int32)) for x in stream)
    return out


def save_state(path: str, state, meta: dict | None = None, *,
               delay=None) -> None:
    """Write a batched ``DenseState``, a ``(DenseState, StreamState)``
    pair or a ``ShardedState`` to ``path`` (.npz) atomically: the bytes land in ``path +
    '.tmp'``, are fsynced and renamed over ``path``. ``delay``: the port
    sampler whose words ``delay_state`` holds (their JAX dtypes; default
    uint32 words, as the hash sampler's)."""
    host = _flatten_host(state, delay)
    header = {
        "format_version": _FORMAT_VERSION,
        "num_leaves": len(host),
        "treedef": treedef_string(state, delay),
        "meta": meta or {},
    }
    arrays = {f"leaf_{i}": a for i, a in enumerate(host)}
    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    try:
        # a file handle, not a path: np.savez would append ".npz" to the
        # tmp name and break the rename
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            fsync_file(f)
        crash_failpoint("checkpoint-replace")
        os.replace(tmp, path)
        fsync_dir(path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_state(path: str, like, *, delay=None):
    """Restore what ``save_state`` (of either package) wrote. ``like``: a
    ``DenseState``, ``(DenseState, StreamState)`` pair or ``ShardedState``
    of the same
    topology, config, batch and sampler (its values are not read); the
    result lands on ``like``'s device. ``delay`` as in ``save_state``.
    Returns (tree, meta). Every damaged file raises ``CheckpointError``
    naming the path, with the JAX package's messages."""
    try:
        with np.load(path) as z:
            if "__header__" not in z.files:
                raise CheckpointError(
                    f"checkpoint {path}: no __header__ entry — truncated "
                    f"write or not a clsim checkpoint")
            header = json.loads(bytes(z["__header__"]).decode())
            version = header["format_version"]
            if not _MIN_SUPPORTED_VERSION <= version <= _FORMAT_VERSION:
                raise CheckpointError(
                    f"checkpoint {path}: unsupported format version "
                    f"{version} (this build reads the supported version "
                    f"range v{_MIN_SUPPORTED_VERSION}..v{_FORMAT_VERSION}; "
                    f"see CHECKPOINT_FORMAT_HISTORY in core/state.py)")
            leaves = [z[f"leaf_{i}"] for i in range(header["num_leaves"])]
    except CheckpointError:
        raise
    except (OSError, ValueError, KeyError, zipfile.BadZipFile, zlib.error,
            EOFError, UnicodeDecodeError) as exc:
        raise CheckpointError(
            f"checkpoint {path}: unreadable or corrupt "
            f"({type(exc).__name__}: {exc})") from exc
    want = treedef_string(like, delay)
    if header["treedef"] != want:
        raise CheckpointError(
            f"checkpoint {path}: treedef {header['treedef']!r} != expected "
            f"{want!r} — different state structure (backend/delay "
            f"model mismatch?)")
    expected = _expected(like, delay)
    if len(expected) != len(leaves):
        raise CheckpointError(
            f"checkpoint {path}: has {len(leaves)} leaves, expected "
            f"{len(expected)} — topology/config mismatch?")
    for i, (a, (shape, dtype)) in enumerate(zip(leaves, expected)):
        if np.shape(a) != shape:
            raise CheckpointError(
                f"checkpoint {path}: leaf {i} shape {np.shape(a)} != "
                f"expected {shape} — topology/config/batch mismatch?")
        if np.asarray(a).dtype != dtype:
            raise CheckpointError(
                f"checkpoint {path}: leaf {i} dtype {np.asarray(a).dtype} "
                f"!= expected {dtype}")
    state_like, stream_like = _split(like)
    device = state_like.time.device
    if isinstance(state_like, ShardedState):
        return sharded_from_numpy(ShardedState(*leaves), device), \
            header["meta"]
    fields, k = {}, 0
    for name, leaf in zip(DenseState._fields, state_like):
        if name == "delay_state":
            fields[name] = tuple(leaves[k:k + len(leaf)])
            k += len(leaf)
        else:
            fields[name] = leaves[k]
            k += 1
    state = state_from_numpy(DenseState(**fields), device)
    if stream_like is None:
        return state, header["meta"]
    return (state, stream_from_numpy(StreamState(*leaves[k:]), device)), \
        header["meta"]


def restore_from_snapshot(topo, cfg, host: DenseState, sid: int, delay,
                          fault_key: int = 0, *,
                          device=None) -> DenseState:
    """Snapshot-rollback recovery (the JAX ``restore_from_snapshot``):
    rebuild a runnable state from completed snapshot ``sid``'s consistent
    cut. Node balances are the snapshot's frozen values; each channel
    holds exactly its recorded in-flight messages, in their recorded
    order, deliverable from tick 1. With no traffic after the cut,
    replaying it to quiescence gives the original run's final balances.

    ``host``: one lane's state as numpy arrays with no lane axis (a lane
    of ``state_to_numpy``, or ``DenseSim.host_state()``). ``delay``: the
    sampler whose fresh stream the state starts with; ``fault_key`` arms
    the adversary's stream (0 = disarmed). Returns a fresh single-lane
    ``DenseState`` (a batch of one, as ``DenseSim`` holds) on ``device``
    (default: the card). Raises ``CheckpointError`` when ``sid`` never
    completed (a partial snapshot is not a consistent cut) or an edge's
    recorded backlog exceeds ``cfg.queue_capacity``."""
    n = topo.n
    started = bool(np.asarray(host.started)[sid])
    completed = int(np.asarray(host.completed)[sid])
    if not started or completed < n:
        raise CheckpointError(
            f"snapshot {sid} is not a completed recovery line "
            f"(started={started}, completed={completed}/{n}) — a partial "
            f"snapshot is not a consistent cut")
    c = cfg.queue_capacity
    q_meta = np.zeros((1, topo.e, c), np.int32)
    q_data = np.zeros((1, topo.e, c), np.int32)
    q_len = np.zeros((1, topo.e), np.int32)
    for e in range(topo.e):
        amts = recorded_window(host, sid, e)
        if len(amts) > c:
            raise CheckpointError(
                f"snapshot {sid}: edge {e} recorded {len(amts)} in-flight "
                f"messages > queue_capacity {c} — restore with a larger "
                f"SimConfig.queue_capacity")
        for k, amt in enumerate(amts):
            q_meta[0, e, k] = pack_meta(1, False)   # deliverable from tick 1
            q_data[0, e, k] = amt
        q_len[0, e] = len(amts)
    device = resolve_device(device)
    fresh = init_single_state(topo, cfg, delay, device)

    def put(x):
        return torch.as_tensor(x, device=device)

    tokens = np.asarray(host.frozen)[sid].astype(np.int32)[None]
    return fresh._replace(
        tokens=put(tokens), q_meta=put(q_meta), q_data=put(q_data),
        q_len=put(q_len), tok_pushed=put(q_len.copy()),
        fault_key=torch.full_like(fresh.fault_key, int(fault_key)))
