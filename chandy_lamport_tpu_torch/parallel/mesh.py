"""Device meshes for the port: the instance axis and the graph axis.

The port of the JAX package's ``parallel/mesh.py``. The JAX package runs
SPMD over a ``jax.sharding.Mesh``: lanes shard over a ``"data"`` axis
(no traffic in steady state), and one giant graph's node and edge state
shards over a ``"graph"`` axis with collectives every tick
(``parallel/graphshard.py``). PyTorch has no global array across devices,
so the port's ``Mesh`` names the axes and says how the shards are held:

  ``stacked``  every shard lives on one device, the shard axis leading,
               which is the JAX ``ShardedState``'s own global layout; the
               collectives are tensor operations on that axis
               (``utils/shardmap.py``). This is the port's counterpart of
               the JAX tests' virtual CPU mesh, and what a single card
               runs.
  ``dist``     one process a mesh position, through
               ``torch.distributed`` (``parallel/multihost.initialize``):
               each process holds one graph shard, and the collectives go
               over the process group (gloo on the CPU, NCCL with one
               process a card). Gloo is given host tensors: on a CUDA
               device the exchanged rows are staged through host memory
               (``Mesh.staged``), a property of gloo, not a fallback.

The caller picks the backend: a ``Mesh`` is built as one or the other, and
nothing switches between them. ``BoundaryTables`` / ``boundary_tables``
are the JAX package's partition-time tables of the sparse halo exchange,
copied (numpy).
"""

from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

BACKENDS = ("stacked", "dist")


class BoundaryTables(NamedTuple):
    """Partition-time constants of the sparse halo exchange (the JAX
    ``BoundaryTables``, whose docstring gives the layout in full). For
    an ordered shard pair (p, q), B[p][q] is the sorted set of nodes owned
    by q that an edge on p targets; H is the largest |B[p][q]|, R =
    (P-1)*H. Shard p's segment space has Nl + R + 1 slots: its own nodes,
    then P-1 blocks of H rows by ring distance d (block d-1 holds
    B[p][(p+d) % P]), then one trash slot for pad edges.

      dst_seg   i32 [P, Em]       each edge's segment / flags index
      seg_perm  i32 [P, Em]       stable permutation into segment order
      seg_lo    i32 [P, Nl+R+1]   segment bounds in the permuted order
      seg_hi    i32 [P, Nl+R+1]
      recv_idx  i32 [P, P-1, H]   step d: local slots of B[(p-d)%P][p]
                                  (pad rows = Nl); also the gather list
                                  of the reverse created-flags send
      halo      int               H (0: no edge crosses a shard)
      cut_edges int               edges whose destination is remote
      cut_rows  int               sum of |B[p][q]| over all pairs
    """

    dst_seg: np.ndarray
    seg_perm: np.ndarray
    seg_lo: np.ndarray
    seg_hi: np.ndarray
    recv_idx: np.ndarray
    halo: int
    cut_edges: int
    cut_rows: int


def boundary_tables(edge_src: np.ndarray, edge_dst: np.ndarray,
                    shards: int, nl: int) -> BoundaryTables:
    """The sparse-exchange tables from the per-shard padded edge arrays
    ([P, Em] global node ids, -1 pads) of a contiguous-block partition
    (node i -> shard i // nl); the JAX ``boundary_tables``."""
    p_, em = edge_src.shape
    pair = {}
    for p in range(p_):
        dst = edge_dst[p]
        valid = dst >= 0
        owner = np.where(valid, dst // max(nl, 1), p)
        for d in range(1, p_):
            q = (p + d) % p_
            pair[(p, d)] = np.unique(dst[valid & (owner == q)])
    halo = max((len(v) for v in pair.values()), default=0)
    r = (p_ - 1) * halo
    nseg = nl + r + 1
    dst_seg = np.full((p_, em), nl + r, np.int32)
    seg_perm = np.zeros((p_, em), np.int32)
    seg_lo = np.zeros((p_, nseg), np.int32)
    seg_hi = np.zeros((p_, nseg), np.int32)
    recv_idx = np.full((p_, max(p_ - 1, 0), halo), nl, np.int32)
    cut_edges = 0
    for p in range(p_):
        dst = edge_dst[p]
        valid = dst >= 0
        owner = np.where(valid, dst // max(nl, 1), p)
        seg = np.full(em, nl + r, np.int64)
        local = valid & (owner == p)
        seg[local] = dst[local] - p * nl
        for d in range(1, p_):
            q = (p + d) % p_
            remote = valid & (owner == q)
            cut_edges += int(remote.sum())
            seg[remote] = (nl + (d - 1) * halo
                           + np.searchsorted(pair[(p, d)], dst[remote]))
            rows = pair[((p - d) % p_, d)]
            recv_idx[p, d - 1, :len(rows)] = rows - p * nl
        order = np.argsort(seg, kind="stable")
        seg_perm[p] = order.astype(np.int32)
        bounds = np.concatenate(
            [[0], np.cumsum(np.bincount(seg, minlength=nseg))])
        seg_lo[p] = bounds[:-1].astype(np.int32)
        seg_hi[p] = bounds[1:].astype(np.int32)
        dst_seg[p] = seg.astype(np.int32)
    return BoundaryTables(
        dst_seg=dst_seg, seg_perm=seg_perm, seg_lo=seg_lo, seg_hi=seg_hi,
        recv_idx=recv_idx, halo=int(halo), cut_edges=cut_edges,
        cut_rows=sum(len(v) for v in pair.values()))


def _cards(device) -> list:
    """The physical devices a mesh may use: every card (``device`` None
    or a CUDA device without an index; None raises without CUDA, as
    ``parallel/batch.resolve_device`` does), else the one device named."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available and no device was given; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


class Mesh:
    """A named device mesh (the JAX ``Mesh``'s surface the runners read:
    ``shape[axis]``, ``axis_names``) with its backend and device.

    ``Mesh({"graph": 4}, device="cpu")`` is a stacked mesh: four graph
    shards held on one device. ``Mesh({"data": 2, "graph": 2},
    backend="dist", device=...)`` maps the ranks of the initialized
    process group onto the axes row-major (the last axis innermost, rank
    = data * 2 + graph), one process a position; it makes a process
    subgroup along every axis, so every process must build it, in the same
    order. ``device``: where this process's shards live (None: the card,
    or raise without CUDA); ``devices``: the physical devices of a stacked
    instance mesh (``instance_mesh``)."""

    def __init__(self, shape: Dict[str, int], *, backend: str = "stacked",
                 device=None, devices: Optional[Sequence] = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown mesh backend {backend!r}")
        self.shape = {str(k): int(v) for k, v in dict(shape).items()}
        if not self.shape or min(self.shape.values()) < 1:
            raise ValueError(f"mesh axes must have sizes >= 1, got "
                             f"{self.shape}")
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.backend = backend
        if devices is not None:
            self.devices = tuple(torch.device(d) for d in devices)
        else:
            self.devices = tuple(_cards(device))[:1]
        self.device = self.devices[0]
        self.rank, self.world = 0, 1
        self.coords = {a: 0 for a in self.axis_names}
        self.staged = False
        self._groups: Dict[str, object] = {}
        self._peers: Dict[str, list] = {}
        if backend == "dist":
            self._init_dist()

    def _init_dist(self) -> None:
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "a dist mesh needs an initialized process group "
                "(parallel/multihost.initialize)")
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        if self.size != self.world:
            raise ValueError(f"mesh {self.shape} has {self.size} positions "
                             f"but the process group has {self.world}")
        strides, step = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = step
            step *= self.shape[a]
        self.coords = {a: (self.rank // strides[a]) % self.shape[a]
                       for a in self.axis_names}
        self.staged = (dist.get_backend() == "gloo"
                       and self.device.type == "cuda")
        # one subgroup along every axis: the processes that differ from
        # each other only in that coordinate (every process makes every
        # subgroup, in the same order, as new_group requires)
        for a in self.axis_names:
            lines = {}
            for r in range(self.world):
                key = tuple((r // strides[b]) % self.shape[b]
                            for b in self.axis_names if b != a)
                lines.setdefault(key, []).append(r)
            mine = None
            for ranks in lines.values():
                group = (None if len(ranks) == self.world
                         else dist.new_group(ranks))
                if self.rank in ranks:
                    mine = (group, ranks)
            self._groups[a], self._peers[a] = mine

    def index(self, axis: str) -> int:
        """This process's coordinate along ``axis`` (0 on a stacked
        mesh, which holds every position)."""
        return self.coords[axis]

    def group(self, axis: str):
        """The process subgroup along ``axis`` (None: the whole world)."""
        return self._groups.get(axis)

    def peer(self, axis: str, j: int) -> int:
        """The global rank at coordinate ``j`` along ``axis``, the other
        coordinates this process's."""
        return self._peers[axis][j]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, backend={self.backend!r}, "
                f"device={str(self.device)!r})")


def instance_mesh(n_devices: Optional[int] = None,
                  axis_name: str = "data", *, device=None) -> Mesh:
    """1-D stacked mesh over the first ``n_devices`` of the caller's
    devices (default: all): the cards, or the one device ``device``
    names. Asking for more than there are raises the JAX ValueError."""
    devs = _cards(device)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have "
                             f"{len(devs)}")
        devs = devs[:n_devices]
    return Mesh({axis_name: len(devs)}, devices=devs)


def _blocks(mesh: Mesh, axis_name: str) -> list:
    """(block index, device) of each position along ``axis_name``: on a
    stacked mesh every block, each on device i of the mesh's devices
    (round robin); on a dist mesh this process's block."""
    if mesh.backend == "dist":
        return [(mesh.index(axis_name), mesh.device)]
    n = mesh.shape[axis_name]
    return [(i, mesh.devices[i % len(mesh.devices)]) for i in range(n)]


def shard_batch(state, mesh: Mesh, axis_name: str = "data") -> list:
    """A batched ``DenseState`` cut along its lane axis into the blocks
    of ``axis_name`` (the JAX ``shard_batch``; a PyTorch tensor lives on
    one device, so the result is the list of lane blocks, block i on its
    device, in mesh order; a dist mesh gives this process's block). The
    lanes must divide evenly, as JAX's sharding requires."""
    b = int(state.time.shape[0])
    n = mesh.shape[axis_name]
    if b % n:
        raise ValueError(f"batch {b} does not divide into {n} "
                         f"'{axis_name}' blocks")
    per = b // n

    def take(leaf, i, dev):
        if isinstance(leaf, tuple):
            return tuple(take(w, i, dev) for w in leaf)
        return leaf[i * per:(i + 1) * per].to(dev)

    return [type(state)(*(take(leaf, i, dev) for leaf in state))
            for i, dev in _blocks(mesh, axis_name)]


def replicate(tree, mesh: Mesh) -> list:
    """A copy of ``tree`` (tensors in tuples and named tuples) on each of
    the mesh's devices (the JAX ``replicate``; a dist mesh: this
    process's device)."""
    def put(x, dev):
        if isinstance(x, tuple):
            return type(x)(*(put(y, dev) for y in x)) \
                if hasattr(x, "_fields") else tuple(put(y, dev) for y in x)
        return torch.as_tensor(x).to(dev)

    devs = (mesh.device,) if mesh.backend == "dist" else mesh.devices
    return [put(tree, d) for d in devs]


def local_world_size() -> int:
    """Processes of the job on this host (``LOCAL_WORLD_SIZE``, which
    torchrun and ``parallel/multihost`` set; the whole world without
    it)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))
