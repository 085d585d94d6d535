"""Edge <-> node segment reductions over the CSR sorted-edge layout.

The port of the JAX package's ``kernels/segment.py`` (Pallas
``sum_segments`` :39, ``sum_by_perm`` :55, ``spread`` :72). Each function
dispatches on the device of its input: a CPU tensor takes the plain
PyTorch version beside it, a CUDA tensor launches the hand-written kernel
of ``csrc/segment.cu`` (or raises). Operands may carry leading batch axes;
all work is along the trailing axis. Outputs follow the JAX dtypes: sums
are int32 (a bool input is summed as int32), a spread keeps its dtype.

The segment sums take one of two CUDA paths, chosen by ``segment_plan``
(the source note of ``csrc/segment.cu`` gives the design): "staged" keeps
the index tables and two groups of rows in a block's shared memory,
"tiled" takes the shapes that do not fit. ``spread`` stages its index
table and groups of rows the same way (``spread_plan``), or reads them
through the caches where they do not fit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from chandy_lamport_tpu_torch.kernels import _build

# launches of each CUDA kernel wrapper (plain versions are not counted)
LAUNCHES = {"sum_segments": 0, "sum_by_perm": 0, "spread": 0}

# shared memory one block may use on an H100 (227 KB)
SMEM_BUDGET = 232_448
# bytes of x one staged group aims at, and rows one thread sums at once
# (csrc/segment.cu's kRowChunk)
GROUP_BYTES = 16_384
ROW_CHUNK = 4
# int32 entries of perm a tiled block stages (48 KB); a longer slice, one
# hub, is read from device memory
TILED_PERM_CAP = 12_288
PATHS = {"staged": 0, "tiled": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
# outputs one staged group of spread aims at, and the share a spread
# block may take (two blocks an SM)
SPREAD_GROUP = 4096
SPREAD_SMEM = SMEM_BUDGET // 2 - 1024
# (x, perm, lo, hi, out, rows, e, n, path, rows_per_group, smem_bytes,
# stream) and (x, idx, out, rows, n, e, rows_per_group, smem_bytes,
# stream); the u8 and i32 entry points differ only in x's element type
_SEGMENT_ARGS = [_P] * 5 + [ctypes.c_longlong] + [_I] * 5 + [_P]
_SPREAD_ARGS = [_P] * 3 + [ctypes.c_longlong] + [_I] * 4 + [_P]
_SIGS = {"clsim_segment_sum_i32": _SEGMENT_ARGS,
         "clsim_segment_sum_u8": _SEGMENT_ARGS,
         "clsim_spread_i32": _SPREAD_ARGS,
         "clsim_spread_u8": _SPREAD_ARGS}


@functools.cache
def _fn(name: str):
    """The entry point ``name``, bound once: its argument types are set
    when it is first loaded, not on every call."""
    fn = getattr(_build.library("segment"), name)
    fn.argtypes = _SIGS[name]
    fn.restype = ctypes.c_int
    return fn


class SegmentPlan(NamedTuple):
    path: str             # "staged" or "tiled"
    rows_per_group: int   # rows of x one staged group copies (tiled: 1)
    smem_bytes: int       # dynamic shared memory of one block


def _align16(v: int) -> int:
    return (v + 15) // 16 * 16


def staged_smem_bytes(e: int, n: int, k: int, elem_size: int,
                      has_perm: bool) -> int:
    """Shared memory of a staged block, the one reckoning of it (the
    kernel checks its own layout against it): perm (when given), lo and
    hi as int32, and two buffers of k rows each; each with the 15 bytes of
    slack that align a copy starting anywhere."""
    return ((_align16(4 * e + 15) if has_perm else 0)
            + 2 * _align16(4 * n + 15) + 2 * _align16(k * e * elem_size + 15))


@functools.lru_cache(maxsize=256)
def segment_plan(rows: int, e: int, n: int, elem_size: int,
                 has_perm: bool) -> SegmentPlan:
    """How the CUDA kernel sums ``rows`` rows of ``e`` elements into ``n``
    segments: "staged" with groups of ~GROUP_BYTES of x, at least
    ROW_CHUNK rows and a multiple of it (fewer rows when the tables leave
    less room, never more than ``rows``), when the block's layout fits
    SMEM_BUDGET; "tiled" otherwise, staging up to TILED_PERM_CAP entries
    of perm. Fewer rows than ROW_CHUNK without perm (the send debits, one
    row) are tiled too: no rows share the staged tables, and the tiled
    grid spreads the nodes over blocks where a staged group is one
    block."""
    if rows < ROW_CHUNK and not has_perm:
        return SegmentPlan("tiled", 1, 0)
    k = max(1, min(rows, max(ROW_CHUNK,
                             GROUP_BYTES // max(e * elem_size, 1))))
    if k > ROW_CHUNK:
        k -= k % ROW_CHUNK
    while k > 1 and staged_smem_bytes(e, n, k, elem_size,
                                      has_perm) > SMEM_BUDGET:
        k -= ROW_CHUNK if k > ROW_CHUNK else 1
    smem = staged_smem_bytes(e, n, k, elem_size, has_perm)
    if smem <= SMEM_BUDGET:
        return SegmentPlan("staged", k, smem)
    return SegmentPlan("tiled", 1,
                       4 * min(e, TILED_PERM_CAP) if has_perm else 0)


def spread_smem_bytes(e: int, n: int, k: int, elem_size: int) -> int:
    """Shared memory of a staged spread block, the one reckoning of it
    (the kernel checks its own layout against it): idx as int32 and two
    buffers of k rows of x, each with 15 bytes of slack."""
    return _align16(4 * e + 15) + 2 * _align16(k * n * elem_size + 15)


class SpreadPlan(NamedTuple):
    rows_per_group: int   # rows of x one staged group copies; 0: direct
    smem_bytes: int


def spread_plan(rows: int, e: int, n: int, elem_size: int) -> SpreadPlan:
    """How the CUDA kernel spreads ``rows`` rows of ``n`` values onto
    ``e`` edges: staged groups of ~SPREAD_GROUP outputs (at least one
    row, never more than ``rows``) when the block's layout fits
    SPREAD_SMEM; else direct (``rows_per_group`` 0), reading idx and x
    through the caches."""
    k = max(1, min(rows, -(-SPREAD_GROUP // max(e, 1))))
    while k > 1 and spread_smem_bytes(e, n, k, elem_size) > SPREAD_SMEM:
        k //= 2
    smem = spread_smem_bytes(e, n, k, elem_size)
    return SpreadPlan(k, smem) if smem <= SPREAD_SMEM else SpreadPlan(0, 0)


# ---- plain versions ---------------------------------------------------------

def sum_segments_plain(xs, lo, hi):
    """[..., E] -> [..., N] int32: exclusive-cumsum bounds difference (the
    JAX form). The cumsum runs in int64; the int32 cast wraps mod 2^32,
    which equals the int32-wrapping cumsum difference of the JAX form."""
    cs = torch.cumsum(xs.to(torch.int64), dim=-1)
    cs0 = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    return (cs0.index_select(-1, hi) - cs0.index_select(-1, lo)).to(
        torch.int32)


def sum_by_perm_plain(x_e, perm, lo, hi):
    """Permute [..., E] into segment order, then segment-sum."""
    return sum_segments_plain(x_e.index_select(-1, perm), lo, hi)


def spread_plain(x_n, idx_e):
    """[..., N] -> [..., E]: gather through ``idx_e``."""
    return x_n.index_select(-1, idx_e)


# ---- CUDA wrappers ----------------------------------------------------------

def _check_index(t, name, device):
    if t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


def _check_operand(x, name, dtypes):
    if x.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {x.dtype} not in {dtypes}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _segment_sum_cuda(x, perm, lo, hi, counter):
    _check_operand(x, counter, (torch.int32, torch.bool))
    device = x.device
    _check_index(lo, "lo", device)
    _check_index(hi, "hi", device)
    if perm is not None:
        _check_index(perm, "perm", device)
    e, n = x.shape[-1], lo.shape[0]
    if hi.shape != lo.shape or (perm is not None and perm.shape[0] != e):
        raise ValueError("segment bounds / permutation shape mismatch")
    out = x.new_empty(x.shape[:-1] + (n,), dtype=torch.int32)
    rows = math.prod(x.shape[:-1])
    plan = segment_plan(rows, e, n, x.element_size(), perm is not None)
    name = ("clsim_segment_sum_u8" if x.dtype == torch.bool
            else "clsim_segment_sum_i32")
    code = _fn(name)(x.data_ptr(), perm.data_ptr() if perm is not None
                     else None, lo.data_ptr(), hi.data_ptr(),
                     out.data_ptr(), rows, e, n, PATHS[plan.path],
                     plan.rows_per_group, plan.smem_bytes,
                     _build.stream_ptr(x))
    _build.check(code, name)
    LAUNCHES[counter] += 1
    return out


def sum_segments(xs, lo, hi):
    """[..., E] -> [..., N] per-segment sums; ``xs`` is already in segment
    order (edges are src-sorted: the send-debit case)."""
    if xs.device.type == "cpu":
        return sum_segments_plain(xs, lo, hi)
    return _segment_sum_cuda(xs, None, lo, hi, "sum_segments")


def sum_by_perm(x_e, perm, lo, hi):
    """[..., E] -> [..., N]: permute into segment order (``by_dst``) and
    segment-sum (token credits, marker-arrival counts)."""
    if x_e.device.type == "cpu":
        return sum_by_perm_plain(x_e, perm, lo, hi)
    return _segment_sum_cuda(x_e, perm, lo, hi, "sum_by_perm")


_SPREAD_FN = {torch.bool: ("clsim_spread_u8", 1),
              torch.int32: ("clsim_spread_i32", 4)}


class _SpreadCall(NamedTuple):
    fn: object         # the bound entry point
    name: str
    out_shape: tuple
    args: tuple        # rows, n, e, rows_per_group, smem_bytes


@functools.lru_cache(maxsize=256)
def _spread_call(dtype, shape, e: int) -> _SpreadCall:
    """What a spread of x (``dtype``, ``shape``) onto ``e`` edges passes
    its entry point besides the pointers and the stream, worked out once
    per shape: on the small calls the wrapper's host time is the call's
    time."""
    name, size = _SPREAD_FN.get(dtype, (None, 0))
    if name is None:
        raise ValueError(f"spread: a bool or int32 tensor, got {dtype}")
    n = shape[-1]
    rows = math.prod(shape[:-1]) if n else 0
    plan = spread_plan(rows, e, n, size)
    return _SpreadCall(_fn(name), name, tuple(shape[:-1]) + (e,),
                       (rows, n, e, plan.rows_per_group, plan.smem_bytes))


def spread(x_n, idx_e):
    """[..., N] -> [..., E]: a per-node value on each incident edge
    (``idx_e`` = edge_dst for inbound, edge_src for outbound edges)."""
    if not x_n.is_cuda:
        if x_n.device.type == "cpu":
            return spread_plain(x_n, idx_e)
        raise ValueError(f"spread: no kernel for {x_n.device}")
    call = _spread_call(x_n.dtype, x_n.shape, idx_e.shape[0])
    if not (x_n.is_contiguous() and idx_e.dtype == torch.int32
            and idx_e.is_contiguous()
            and idx_e.get_device() == x_n.get_device()):
        raise ValueError(f"spread: x contiguous and idx_e a contiguous int32 "
                         f"tensor on {x_n.device}, got {idx_e.dtype} on "
                         f"{idx_e.device}")
    out = x_n.new_empty(call.out_shape)
    code = call.fn(x_n.data_ptr(), idx_e.data_ptr(), out.data_ptr(),
                   *call.args, _build.stream_ptr(x_n))
    _build.check(code, call.name)
    LAUNCHES["spread"] += 1
    return out
