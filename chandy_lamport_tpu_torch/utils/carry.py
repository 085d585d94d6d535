"""Carry a batched state, a job pool and a stream carry between the JAX
package and the port.

``state_from_numpy`` takes a host state whose leaves are numpy arrays —
a JAX ``DenseState`` fetched with ``jax.device_get``, or the output of
``state_to_numpy`` — and builds the port's ``DenseState`` on ``device``;
``state_to_numpy`` goes back, restoring each leaf's JAX dtype. PyTorch has
no usable unsigned arithmetic, so the port holds uint32 words as int64
values in [0, 2^32) and uint64 words (the Go-exact stream) as int64 bit
for bit (core/state.py, ops/delay.py), and uint16 window planes as int16
bit patterns (``core/state.WINDOW_LEAVES``). Field order is the same in both
packages, so a JAX run can hand its state to the port mid-storm and the
two can be compared leaf for leaf. ``pool_from_numpy``/``pool_to_numpy``
and ``stream_from_numpy``/``stream_to_numpy`` do the same for the
streaming engine's ``JobPool`` and ``StreamState`` (JAX dtypes: int32
tables, uint32 fault keys, uint8 digests, the sampler's words).
"""

from __future__ import annotations

import numpy as np
import torch

from chandy_lamport_tpu_torch.core.state import (
    U32_LEAVES,
    WINDOW_LEAVES,
    DenseState,
)
from chandy_lamport_tpu_torch.parallel.batch import JobPool, StreamState


def _tensor(array, device):
    """One host leaf as a port tensor: uint32 widens to int64, uint64 and
    uint16 are reinterpreted as int64 and int16. np.array copies, so the
    port never aliases (or writes into) the host arrays it was given."""
    array = np.array(array)
    if array.dtype == np.uint64:
        array = array.view(np.int64)
    elif array.dtype == np.uint16:
        array = array.view(np.int16)
    elif array.dtype == np.uint32:
        array = array.astype(np.int64)
    return torch.from_numpy(array).to(device)


def _host(leaf, dtype: str):
    array = leaf.cpu().numpy()
    if dtype == "uint64":
        return array.view(np.uint64)
    return array.astype(dtype)


def words_to_numpy(words, delay=None) -> tuple:
    """A sampler state's words (a tuple of tensors) as numpy arrays in the
    JAX dtypes: ``delay.host_dtypes`` names each word's (without a
    sampler every word is taken as uint32, as the hash sampler's are)."""
    dtypes = (delay.host_dtypes if delay is not None
              else ("uint32",) * len(words))
    return tuple(_host(w, d) for w, d in zip(words, dtypes))


def _words(leaf) -> tuple:
    """A host sampler state as its tuple of words: the JAX tree holds the
    threefry key as one bare array (ops/delay.UniformDelay)."""
    return tuple(leaf) if isinstance(leaf, tuple) else (leaf,)


def state_from_numpy(host_state, device) -> DenseState:
    fields = {}
    for name, leaf in zip(DenseState._fields, host_state):
        if name == "delay_state":
            fields[name] = tuple(_tensor(w, device) for w in _words(leaf))
        else:
            fields[name] = _tensor(leaf, device)
    return DenseState(**fields)


def state_to_numpy(state: DenseState, delay=None) -> DenseState:
    """The host state with the JAX dtypes. ``delay`` is the port sampler
    whose state ``delay_state`` holds (its ``host_dtypes`` name the JAX
    dtype of each word); without it every word is taken as uint32, as the
    hash sampler's are."""
    fields = {}
    for name, leaf in zip(DenseState._fields, state):
        if name == "delay_state":
            fields[name] = words_to_numpy(leaf, delay)
        elif name in U32_LEAVES:
            fields[name] = _host(leaf, "uint32")
        elif name in WINDOW_LEAVES and leaf.dtype == torch.int16:
            fields[name] = leaf.cpu().numpy().view(np.uint16)
        else:
            fields[name] = leaf.cpu().numpy()
    return DenseState(**fields)


def pool_from_numpy(host_pool, device) -> JobPool:
    """A host ``JobPool`` (numpy leaves, e.g. a JAX pool through
    ``jax.device_get``) as the port's, on ``device``. ``prefix_digest``
    stays a host numpy array (or None), as the port keeps it."""
    fields = {}
    for name in JobPool._fields:
        leaf = getattr(host_pool, name)
        if name == "delay_state":
            fields[name] = tuple(_tensor(w, device) for w in _words(leaf))
        elif name == "prefix_digest":
            fields[name] = None if leaf is None else np.array(leaf)
        else:
            fields[name] = _tensor(leaf, device)
    return JobPool(**fields)


def pool_to_numpy(pool: JobPool, delay=None) -> JobPool:
    """The host pool with the JAX dtypes (``delay``: the port sampler
    whose words ``delay_state`` holds, as in ``state_to_numpy``)."""
    fields = {}
    for name in JobPool._fields:
        leaf = getattr(pool, name)
        if name == "delay_state":
            fields[name] = words_to_numpy(leaf, delay)
        elif name == "prefix_digest":
            fields[name] = None if leaf is None else np.array(leaf)
        elif name == "fault_key":
            fields[name] = _host(leaf, "uint32")
        else:
            fields[name] = leaf.cpu().numpy()
    return JobPool(**fields)


def stream_from_numpy(host_stream, device) -> StreamState:
    """A host ``StreamState`` (numpy int32 leaves) as the port's."""
    return StreamState(*(_tensor(x, device) for x in host_stream))


def stream_to_numpy(stream: StreamState) -> StreamState:
    """The stream carry as numpy int32 leaves (the JAX layout)."""
    return StreamState(*(x.cpu().numpy().astype(np.int32) for x in stream))
