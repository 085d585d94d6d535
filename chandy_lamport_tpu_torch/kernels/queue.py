"""Ring-queue kernels of the sync, exact and faulted exact storms.

The port of the JAX package's ``kernels/queue.py`` Pallas ``head_fields``
(:63), ``queue_step`` (:92), ``select_pop`` (:119) and ``append_rows``
(:157). Each function dispatches on the device of its input: a CPU
tensor takes the plain PyTorch version beside it, a CUDA tensor launches
the hand-written kernel of ``csrc/queue.cu`` (or raises). Planes are
``[..., E, C]`` with any leading batch axes.

``append_rows`` is the whole append of the JAX caller in one launch: the
JAX ``append_rows`` (which returns new planes) and its caller's
``q_len``/``tok_pushed`` adds and error OR (``ops/tick.py:1111-1170``).
It writes its slots, the two counters and the lane's error word IN
PLACE (writing one slot per edge instead of the whole plane is the point
of the kernel) and returns the same tensors, so the caller must own the
planes and counters it passes (``ops/tick.py``'s module docstring lists
the call sites). ``append_marker_rows`` is the marker broadcast's form:
each lane's node's out-edge row, routed onto its edges in the same
launch. The CUDA forms take one lane axis: planes ``[B, E, C]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from chandy_lamport_tpu_torch.core.state import (
    ERR_QUEUE_OVERFLOW,
    ERR_VALUE_OVERFLOW,
    RTIME_PACK_LIMIT,
    meta_marker,
    meta_rtime,
    pack_meta,
)
from chandy_lamport_tpu_torch.kernels import _build

# launches of each CUDA kernel wrapper (plain versions are not counted)
LAUNCHES = {"head_fields": 0, "queue_step": 0, "select_pop": 0,
            "append_rows": 0, "append_marker_rows": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# the pointer fields of ``_AppendArgs``, in order
_APPEND_PTRS = ("q_meta", "q_data", "q_head", "q_len", "tok_pushed", "error",
                "active", "rt", "mk", "data", "node", "src_lo", "src_hi")
_SIGS = {
    "clsim_head_fields": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _P],
    "clsim_queue_step": [_P] * 11 + [ctypes.c_longlong, _I, _I, _P],
    "clsim_select_pop": [_P] * 7 + [ctypes.c_longlong, _I, _I, _P],
}


class _AppendArgs(ctypes.Structure):
    """``struct AppendArgs`` of ``csrc/queue.cu``, field for field."""

    _fields_ = ([(n, _P) for n in _APPEND_PTRS]
                + [(n, ctypes.c_longlong) for n in (
                    "act_sb", "act_se", "rt_sb", "rt_se", "mk_sb", "mk_se",
                    "data_sb", "data_se", "node_sb", "b")]
                + [(n, _I) for n in ("e", "c", "key_limit",
                                     "flag_queue_overflow", "mk_all",
                                     "width")])


_SIGS["clsim_append_rows"] = [ctypes.POINTER(_AppendArgs), _I, _P]


@functools.cache
def _fn(name: str):
    fn = getattr(_build.library("queue"), name)
    fn.argtypes = _SIGS[name]
    fn.restype = ctypes.c_int
    return fn


# ---- plain versions ---------------------------------------------------------

def head_fields_plain(q_meta, q_data, q_head):
    """Every ring head's (rtime i32, is_marker bool, data i32)."""
    at = q_head.to(torch.int64).unsqueeze(-1)
    head_meta = torch.gather(q_meta, -1, at).squeeze(-1)
    head_data = torch.gather(q_data, -1, at).squeeze(-1)
    return meta_rtime(head_meta), meta_marker(head_meta), head_data


def queue_step_plain(q_meta, q_data, q_head, q_len, time, src_first, *,
                     capacity: int):
    """The exact tick's delivery selection, transcribing the Pallas body
    (``_queue_step_kernel``): gather the head words, ``elig = len > 0 &
    rtime <= time`` (``time`` has the leading axes, one per lane), keep
    the first eligible edge of each source by the exclusive prefix count
    re-based at the source's first edge, pop it. Returns (tok bool,
    mk bool, head_data i32, new_head i32, new_len i32)."""
    at = q_head.to(torch.int64).unsqueeze(-1)
    head_meta = torch.gather(q_meta, -1, at).squeeze(-1)
    head_data = torch.gather(q_data, -1, at).squeeze(-1)
    head_mk = meta_marker(head_meta)
    elig = (q_len > 0) & (meta_rtime(head_meta) <= time.unsqueeze(-1))
    elig_i = elig.to(torch.int32)
    before = torch.cumsum(elig_i, dim=-1, dtype=torch.int32) - elig_i
    sel = elig & (before == before.index_select(-1, src_first))
    sel_i = sel.to(torch.int32)
    return (sel & ~head_mk, sel & head_mk, head_data,
            (q_head + sel_i) % capacity, q_len - sel_i)


def select_pop_plain(q_head, q_len, elig, src_first, *, capacity: int):
    """Selection + pop over an externally gated eligibility mask,
    transcribing the Pallas body (``_select_pop_kernel``): keep the first
    eligible edge of each source by the exclusive prefix count re-based at
    the source's first edge, pop it. Returns (sel bool, new_head i32,
    new_len i32)."""
    elig_i = elig.to(torch.int32)
    before = torch.cumsum(elig_i, dim=-1, dtype=torch.int32) - elig_i
    sel = elig & (before == before.index_select(-1, src_first))
    sel_i = sel.to(torch.int32)
    return sel, (q_head + sel_i) % capacity, q_len - sel_i


def append_rows_plain(q_meta, q_data, q_head, q_len, tok_pushed, error,
                      active, rt_e, marker, data_e, *, capacity: int,
                      key_limit: int, flag_queue_overflow: bool = True):
    """One message at ``(head + len) % C`` on every ``active`` edge, in
    place: the slot word ``rt_e << 1 | marker`` (``marker`` a bool for
    every row or a bool mask) and ``data_e``, then ``q_len`` and
    ``tok_pushed`` advanced and the lane's overflow bits ORed into
    ``error`` (the JAX ``append_rows`` and its caller's adds). ``active``,
    ``rt_e``, ``marker`` and ``data_e`` broadcast to ``q_head``'s shape.
    Returns (q_meta, q_data, q_len, tok_pushed, error)."""
    lead = q_head.shape
    active, rt_e, data_e = (x.expand(lead) for x in (active, rt_e, data_e))
    mk = marker.expand(lead).to(torch.int32) if torch.is_tensor(marker) \
        else int(marker)
    err = ((active & (tok_pushed >= key_limit)).any(-1)
           | (active & (rt_e >= RTIME_PACK_LIMIT)).any(-1)
           ).to(torch.int32) * ERR_VALUE_OVERFLOW
    if flag_queue_overflow:
        err = err | ((active & (q_len >= capacity)).any(-1).to(torch.int32)
                     * ERR_QUEUE_OVERFLOW)
    # head and len are non-negative, so % needs no sign care
    pos = ((q_head + q_len) % capacity).to(torch.int64).unsqueeze(-1)
    hit = active.unsqueeze(-1)
    for plane, val in ((q_meta, pack_meta(rt_e, mk)), (q_data, data_e)):
        old = torch.gather(plane, -1, pos)
        plane.scatter_(-1, pos, torch.where(hit, val.unsqueeze(-1), old))
    step = active.to(torch.int32)
    q_len.add_(step)
    tok_pushed.add_(step)
    error.bitwise_or_(err)
    return q_meta, q_data, q_len, tok_pushed, error


def append_marker_rows_plain(q_meta, q_data, q_head, q_len, tok_pushed,
                             error, node, mask, rt_k, data, src_lo, src_hi,
                             *, capacity: int, key_limit: int):
    """SendToNeighbors on the lanes of ``mask`` [B], in place: lane b's
    node ``node[b]`` sends a marker with payload ``data[b]`` on each of its
    out-edges ``src_lo[v] + k`` (dest order), ``k`` < its out-degree, at
    receive time ``rt_k[b, k]`` ([B, D]); routed onto the [B, E] rows and
    appended by ``append_rows_plain``. Returns what it returns."""
    b, e = q_head.shape
    v = node.long()
    lo = src_lo[v].unsqueeze(-1)
    k = torch.arange(rt_k.shape[-1], dtype=torch.int32, device=node.device)
    go = mask.unsqueeze(-1) & (k < (src_hi[v].unsqueeze(-1) - lo))
    # padding and masked-out lanes aim at a spare column E that is dropped
    tgt = torch.where(go, lo + k, e).long()
    active = torch.zeros((b, e + 1), dtype=torch.bool,
                         device=node.device).scatter_(1, tgt, True)
    rt_e = torch.zeros((b, e + 1), dtype=torch.int32,
                       device=node.device).scatter_(1, tgt, rt_k)
    return append_rows_plain(q_meta, q_data, q_head, q_len, tok_pushed,
                             error, active[:, :e], rt_e[:, :e], True,
                             data.unsqueeze(-1), capacity=capacity,
                             key_limit=key_limit)


# ---- CUDA wrappers ----------------------------------------------------------

def _check(tensors, dtype, shape, device):
    for name, t in tensors.items():
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def head_fields(q_meta, q_data, q_head):
    """Every ring head's (rtime, is_marker, data): the sync tick's head
    read."""
    if q_meta.device.type == "cpu":
        return head_fields_plain(q_meta, q_data, q_head)
    lead = tuple(q_head.shape)
    c = q_meta.shape[-1]
    _check({"q_meta": q_meta, "q_data": q_data}, torch.int32, lead + (c,),
           q_meta.device)
    _check({"q_head": q_head}, torch.int32, lead, q_meta.device)
    rtime = torch.empty(lead, dtype=torch.int32, device=q_meta.device)
    marker = torch.empty(lead, dtype=torch.bool, device=q_meta.device)
    data = torch.empty(lead, dtype=torch.int32, device=q_meta.device)
    code = _fn("clsim_head_fields")(
        q_meta.data_ptr(), q_data.data_ptr(), q_head.data_ptr(),
        rtime.data_ptr(), marker.data_ptr(), data.data_ptr(),
        q_head.numel(), c, _build.stream_ptr(q_meta))
    _build.check(code, "clsim_head_fields")
    LAUNCHES["head_fields"] += 1
    return rtime, marker, data


@functools.lru_cache(maxsize=256)
def _select_plan(gather: bool, capacity: int, sigs) -> tuple:
    """(lanes, E) of one ``queue_step`` (``gather``) or ``select_pop``
    call, its operands checked, worked out once per
    (capacity, operand dtypes, shapes, strides and devices): on the
    megatick-1 paths the wrapper's host time is the call's time."""
    name = "queue_step" if gather else "select_pop"
    lead = tuple(sigs[0][1])[:-1] if gather else tuple(sigs[0][1])
    dev = sigs[0][3]
    if dev < 0:
        raise ValueError(f"{name}: operands on the CPU or a CUDA device")
    i32 = torch.int32
    if gather:
        names = ("q_meta", "q_data", "q_head", "q_len", "time", "src_first")
        want = [(i32, lead + (capacity,))] * 2 + [(i32, lead)] * 2 + [
            (i32, lead[:-1])]
    else:
        names = ("q_head", "q_len", "elig", "src_first")
        want = [(i32, lead)] * 2 + [(torch.bool, lead)]
    e = lead[-1] if lead else -1
    want.append((i32, (e,)))
    for sig, nm, (dtype, shape) in zip(sigs, names, want):
        if not (sig[0] == dtype and tuple(sig[1]) == shape and sig[3] == dev
                and _row_major(shape, sig[2])):
            raise ValueError(f"{name}: {nm} must be a contiguous {dtype} "
                             f"{shape} on cuda:{dev}, got {sig[0]} "
                             f"{tuple(sig[1])} strides {tuple(sig[2])} on "
                             f"device {sig[3]}")
    lanes = 1
    for d in lead[:-1]:
        lanes *= d
    return lanes, e


def queue_step(q_meta, q_data, q_head, q_len, time, src_first, src_lo,
               src_hi, *, capacity: int):
    """The fused delivery selection of the exact tick (``queue_step_plain``
    says what it computes), one clock per lane in ``time``. ``src_first``
    [E] gives each edge's segment; ``src_lo``/``src_hi`` [N], the same
    segments as ranges, are not read."""
    if q_meta.device.type == "cpu":
        return queue_step_plain(q_meta, q_data, q_head, q_len, time,
                                src_first, capacity=capacity)
    lanes, e = _select_plan(True, capacity, (
        _sig(q_meta), _sig(q_data), _sig(q_head), _sig(q_len), _sig(time),
        _sig(src_first)))
    # q_head is a contiguous int32 [..., E]: the outputs are laid out so
    tok = torch.empty_like(q_head, dtype=torch.bool)
    mk = torch.empty_like(q_head, dtype=torch.bool)
    head_data = torch.empty_like(q_head)
    new_head = torch.empty_like(q_head)
    new_len = torch.empty_like(q_head)
    code = _fn("clsim_queue_step")(
        q_meta.data_ptr(), q_data.data_ptr(), q_head.data_ptr(),
        q_len.data_ptr(), time.data_ptr(), src_first.data_ptr(),
        tok.data_ptr(), mk.data_ptr(), head_data.data_ptr(),
        new_head.data_ptr(), new_len.data_ptr(), lanes, e, capacity,
        _build.stream_ptr(q_meta))
    _build.check(code, "clsim_queue_step")
    LAUNCHES["queue_step"] += 1
    return tok, mk, head_data, new_head, new_len


def select_pop(q_head, q_len, elig, src_first, src_lo, src_hi, *,
               capacity: int):
    """The selection + pop of the faulted exact tick (``select_pop_plain``
    says what it computes). ``src_first`` [E] gives each edge's segment;
    ``src_lo``/``src_hi`` [N], the same segments as ranges, are not
    read."""
    if q_head.device.type == "cpu":
        return select_pop_plain(q_head, q_len, elig, src_first,
                                capacity=capacity)
    lanes, e = _select_plan(False, capacity, (
        _sig(q_head), _sig(q_len), _sig(elig), _sig(src_first)))
    sel = torch.empty_like(q_head, dtype=torch.bool)
    new_head = torch.empty_like(q_head)
    new_len = torch.empty_like(q_head)
    code = _fn("clsim_select_pop")(
        q_head.data_ptr(), q_len.data_ptr(), elig.data_ptr(),
        src_first.data_ptr(), sel.data_ptr(), new_head.data_ptr(),
        new_len.data_ptr(), lanes, e, capacity, _build.stream_ptr(q_head))
    _build.check(code, "clsim_select_pop")
    LAUNCHES["select_pop"] += 1
    return sel, new_head, new_len


def _row_major(shape, stride) -> bool:
    """Whether ``stride`` lays ``shape`` out contiguously (the stride of a
    dimension of size 1 is free, and a tensor with no element is
    contiguous, as in ``Tensor.is_contiguous``)."""
    if 0 in shape:
        return True
    step = 1
    for dim, st in zip(reversed(shape), reversed(stride)):
        if dim != 1 and st != step:
            return False
        step *= dim
    return True


def _sig(t):
    """What the cached launch set-up keys a tensor operand by."""
    return t.dtype, t.shape, t.stride(), t.get_device()


@functools.lru_cache(maxsize=256)
def _append_args(routed: bool, capacity: int, key_limit: int, flag: bool,
                 mk_all, sigs) -> _AppendArgs:
    """The launch struct of one append, its operands checked, worked out
    once per (form, constants, operand dtypes, shapes, strides and
    devices): on the host-bound paths the wrapper's host time is the
    append's time. The caller fills the pointer fields per call (the
    entry point copies the struct into the launch)."""
    (meta, data_p, head, length, pushed, err), ops = sigs[:6], sigs[6:]
    dev = meta[3]
    if len(meta[1]) != 3 or meta[1][-1] != capacity:
        raise ValueError(f"append_rows: planes [B, E, {capacity}], got "
                         f"{tuple(meta[1])}")
    b, e, _ = meta[1]
    i32, u8 = torch.int32, torch.bool

    def need(sig, name, dtype, shape, contiguous=True):
        ok = (sig[0] == dtype and tuple(sig[1]) == shape and sig[3] == dev
              and (not contiguous or _row_major(shape, sig[2])))
        if not ok:
            raise ValueError(f"append_rows: {name} must be "
                             f"{'a contiguous ' if contiguous else ''}"
                             f"{dtype} {shape} on cuda:{dev}, got {sig[0]} "
                             f"{tuple(sig[1])} strides {tuple(sig[2])} on "
                             f"device {sig[3]}")

    need(meta, "q_meta", i32, (b, e, capacity))
    need(data_p, "q_data", i32, (b, e, capacity))
    for sig, name in ((head, "q_head"), (length, "q_len"),
                      (pushed, "tok_pushed")):
        need(sig, name, i32, (b, e))
    need(err, "error", i32, (b,))
    args = _AppendArgs(b=b, e=e, c=capacity, key_limit=key_limit,
                       flag_queue_overflow=int(flag))
    if routed:
        node, mask, rt, data, lo, hi = ops
        for sig, name, dtype in ((node, "node", i32), (mask, "mask", u8),
                                 (data, "data", i32)):
            need(sig, name, dtype, (b,), contiguous=False)
        args.node_sb, args.act_sb, args.data_sb = (
            s[2][0] for s in (node, mask, data))
        need(lo, "src_lo", i32, tuple(lo[1]))
        need(hi, "src_hi", i32, tuple(lo[1]))
        need(rt, "rt_k", i32, (b, tuple(rt[1])[-1]), contiguous=False)
        args.rt_sb, args.rt_se = rt[2]
        args.width = tuple(rt[1])[-1]
        args.mk_all = 1
        return args
    names = ("active", "rt_e", "data_e", "marker")
    for sig, name, dtype in zip(ops, names, (u8, i32, i32, u8)):
        need(sig, name, dtype, (b, e), contiguous=False)
    (args.act_sb, args.act_se), (args.rt_sb, args.rt_se), \
        (args.data_sb, args.data_se) = (s[2] for s in ops[:3])
    if len(ops) > 3:
        args.mk_sb, args.mk_se = ops[3][2]
    else:
        args.mk_all = int(mk_all)
    args.width = e
    return args


def _launch_append(args, ptrs, routed: bool, like, name: str) -> None:
    """Fill ``args``' pointer fields from ``ptrs`` (``_APPEND_PTRS``
    order, None for a null pointer) and launch on ``like``'s stream."""
    for field, t in zip(_APPEND_PTRS, ptrs):
        setattr(args, field, t.data_ptr() if t is not None else None)
    code = _fn("clsim_append_rows")(ctypes.byref(args), int(routed),
                                    _build.stream_ptr(like))
    _build.check(code, "clsim_append_rows")
    LAUNCHES[name] += 1


def append_rows(q_meta, q_data, q_head, q_len, tok_pushed, error, active,
                rt_e, marker, data_e, *, capacity: int, key_limit: int,
                flag_queue_overflow: bool = True):
    """The batched ring append with its counters and overflow bits, in
    place, in one launch (``append_rows_plain`` says what it computes).
    On the card the per-row operands ``active``, ``rt_e``, ``data_e`` and a
    tensor ``marker`` are [B, E] of any strides (an expanded [E] or [B]
    operand is read in place). Returns (q_meta, q_data, q_len,
    tok_pushed, error)."""
    if not q_meta.is_cuda:
        if q_meta.device.type == "cpu":
            return append_rows_plain(
                q_meta, q_data, q_head, q_len, tok_pushed, error, active,
                rt_e, marker, data_e, capacity=capacity, key_limit=key_limit,
                flag_queue_overflow=flag_queue_overflow)
        raise ValueError(f"append_rows: no kernel for {q_meta.device}")
    mk = marker if torch.is_tensor(marker) else None
    ops = (active, rt_e, data_e) if mk is None else (active, rt_e, data_e,
                                                     mk)
    args = _append_args(False, capacity, key_limit,
                        bool(flag_queue_overflow),
                        None if mk is not None else bool(marker),
                        tuple(_sig(t) for t in (q_meta, q_data, q_head, q_len,
                                                tok_pushed, error) + ops))
    _launch_append(args, (q_meta, q_data, q_head, q_len, tok_pushed, error,
                          active, rt_e, mk, data_e, None, None, None),
                   False, q_meta, "append_rows")
    return q_meta, q_data, q_len, tok_pushed, error


def append_marker_rows(q_meta, q_data, q_head, q_len, tok_pushed, error,
                       node, mask, rt_k, data, src_lo, src_hi, *,
                       capacity: int, key_limit: int):
    """The marker broadcast's append, routed and appended in place in one
    launch (``append_marker_rows_plain`` says what it computes): ``node``,
    ``mask`` and ``data`` [B] and ``rt_k`` [B, D], of any strides, the
    out-edge ranges ``src_lo``/``src_hi`` [N]; a masked lane's node must
    be a node. Returns (q_meta, q_data, q_len, tok_pushed, error)."""
    if not q_meta.is_cuda:
        if q_meta.device.type == "cpu":
            return append_marker_rows_plain(
                q_meta, q_data, q_head, q_len, tok_pushed, error, node, mask,
                rt_k, data, src_lo, src_hi, capacity=capacity,
                key_limit=key_limit)
        raise ValueError(f"append_marker_rows: no kernel for "
                         f"{q_meta.device}")
    args = _append_args(True, capacity, key_limit, True, None, tuple(
        _sig(t) for t in (q_meta, q_data, q_head, q_len, tok_pushed, error,
                          node, mask, rt_k, data, src_lo, src_hi)))
    _launch_append(args, (q_meta, q_data, q_head, q_len, tok_pushed, error,
                          mask, rt_k, None, data, node, src_lo, src_hi),
                   True, q_meta, "append_marker_rows")
    return q_meta, q_data, q_len, tok_pushed, error
