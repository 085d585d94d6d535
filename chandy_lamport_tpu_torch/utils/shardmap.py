"""The collectives of the graph-sharded tick, for both mesh backends.

The counterpart of the JAX package's ``utils/shardmap.py``: where JAX runs
the tick body once per shard under ``shard_map`` with ``psum``,
``all_gather`` and ``ppermute`` between the shards, the port writes the
body once over a LOCAL shard axis (parallel/graphshard.py) and these
functions carry what crosses it:

  stacked  every shard is local (parallel/mesh.Mesh backend "stacked"):
           a sum or OR taken over the local shards is already the global
           one, so ``psum``/``por``/``all_gather`` return their input,
           and ``ppermute`` rolls the local shard axis;
  dist     one shard a process: ``psum`` is ``all_reduce``, ``por`` a
           per-bit ``all_reduce`` (a max is not an OR: with bit 8 on one
           shard and bit 1 on another, a max would drop bit 1),
           ``all_gather`` is ``all_gather_into_tensor``, and ``ppermute``
           one ``batch_isend_irecv`` to (r+d) % P and from (r-d) % P, all
           over the axis's subgroup. On a gloo group with CUDA tensors the
           operands are copied to the host and back (``Mesh.staged``).

Every function takes the mesh and the axis it reduces over; ``psum_all``
reduces over every axis (the drain's mesh-global gate).
"""

from __future__ import annotations

import contextlib

import torch

from chandy_lamport_tpu_torch.core.state import NUM_ERROR_BITS
from chandy_lamport_tpu_torch.utils.guards import host_sync

_i32 = torch.int32


def _dist():
    import torch.distributed as dist

    return dist


def _staging(mesh):
    """The named host-sync site of a staged collective (its copies through
    host memory wait for the card), or nothing."""
    return (host_sync("graphshard-exchange") if mesh.staged
            else contextlib.nullcontext())


def _out(mesh, x):
    """A private copy of ``x`` for a collective that works in place: on
    the host when the mesh stages through it."""
    return x.to("cpu", copy=True) if mesh.staged else x.clone()


def _back(mesh, y, like):
    return y.to(like.device) if mesh.staged else y


def _reduce(mesh, x, group):
    dist = _dist()
    with _staging(mesh):
        y = _out(mesh, x)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return _back(mesh, y, x)


def psum(x, mesh, axis: str):
    """Sum across the processes along ``axis``: the identity on a stacked
    mesh (the caller summed the local shards)."""
    if mesh.backend == "stacked" or mesh.shape[axis] == 1:
        return x
    return _reduce(mesh, x, mesh.group(axis))


def psum_all(x, mesh):
    """Sum across every process of the mesh."""
    if mesh.backend == "stacked" or mesh.world == 1:
        return x
    return _reduce(mesh, x, None)


def bits_or(mask, dim: int):
    """Bitwise OR of an int32 error word along ``dim``."""
    shifts = torch.arange(NUM_ERROR_BITS, dtype=_i32, device=mask.device)
    bits = ((mask.to(_i32).unsqueeze(-1) >> shifts) & 1).any(dim % mask.dim())
    return (bits.to(_i32) << shifts).sum(-1, dtype=_i32)


def por(mask, mesh, axis: str):
    """Bitwise OR of an int32 error word across the processes along
    ``axis``, bit by bit (the JAX ``_por``)."""
    if mesh.backend == "stacked" or mesh.shape[axis] == 1:
        return mask
    shifts = torch.arange(NUM_ERROR_BITS, dtype=_i32, device=mask.device)
    bits = (mask.to(_i32).unsqueeze(-1) >> shifts) & 1
    anyb = psum(bits, mesh, axis) > 0
    return (anyb.to(_i32) << shifts).sum(-1, dtype=_i32)


def all_gather(x, mesh, axis: str, dim: int = -1):
    """Every process's ``x`` along ``axis`` concatenated along ``dim``, in
    axis order: the identity on a stacked mesh (``x`` holds every
    shard)."""
    if mesh.backend == "stacked" or mesh.shape[axis] == 1:
        return x
    dist = _dist()
    p = mesh.shape[axis]
    moved = x.movedim(dim, 0).contiguous()
    with _staging(mesh):
        src = moved.cpu() if mesh.staged else moved
        out = src.new_empty((p * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=mesh.group(axis))
        out = _back(mesh, out, x)
    return out.movedim(0, dim)


def ppermute(x, mesh, axis: str, shift: int, dim: int):
    """The block of shard i (``x``'s local shard axis ``dim``) moved to
    shard (i + shift) % P: ``torch.roll`` on a stacked mesh, a send to
    (r + shift) % P and a receive from (r - shift) % P on a dist one."""
    p = mesh.shape[axis]
    if mesh.backend == "stacked":
        return torch.roll(x, shifts=shift, dims=dim)
    if p == 1 or shift % p == 0:
        return x
    dist = _dist()
    me = mesh.index(axis)
    send = x.contiguous()
    with _staging(mesh):
        if mesh.staged:
            send = send.cpu()
        recv = torch.empty_like(send)
        group = mesh.group(axis)
        ops = [dist.P2POp(dist.isend, send, mesh.peer(axis, (me + shift) % p),
                          group=group),
               dist.P2POp(dist.irecv, recv, mesh.peer(axis, (me - shift) % p),
                          group=group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return _back(mesh, recv, x)
