"""Ring-queue kernels of the sync, exact and faulted exact storms.

The port of the JAX package's ``kernels/queue.py`` Pallas ``head_fields``
(:63), ``queue_step`` (:92), ``select_pop`` (:119) and ``append_rows``
(:157). Each function dispatches on the device of its input: a CPU
tensor takes the plain PyTorch version beside it, a CUDA tensor launches
the hand-written kernel of ``csrc/queue.cu`` (or raises). Planes are
``[..., E, C]`` with any leading batch axes.

``append_rows`` writes its slots IN PLACE into ``q_meta``/``q_data`` (the
JAX form returns new planes; writing one slot per edge instead of the
whole plane is the point of the kernel) and returns the same tensors,
so the caller must own the planes it passes.
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
)
from chandy_lamport_tpu_torch.kernels import _build

# launches of each CUDA kernel wrapper (plain versions are not counted)
LAUNCHES = {"head_fields": 0, "queue_step": 0, "select_pop": 0,
            "append_rows": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "clsim_head_fields": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _P],
    "clsim_queue_step": [_P] * 12 + [ctypes.c_longlong, _I, _I, _I, _P],
    "clsim_select_pop": [_P] * 8 + [ctypes.c_longlong, _I, _I, _I, _P],
    "clsim_append_rows": [_P] * 10 + [ctypes.c_longlong] + [_I] * 4 + [_P],
}


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


def append_rows_plain(q_meta, q_data, q_head, q_len, tok_pushed, active,
                      meta_e, rt_e, data_e, *, capacity: int, key_limit: int,
                      flag_queue_overflow: bool = True):
    """One slot at ``(head + len) % C`` on every active edge, written in
    place; returns (q_meta, q_data, err) with err the per-lane error word
    (shape of the leading axes, int32)."""
    err = ((active & (tok_pushed >= key_limit)).any(-1)
           | (active & (rt_e >= RTIME_PACK_LIMIT)).any(-1)
           ).to(torch.int32) * ERR_VALUE_OVERFLOW
    if flag_queue_overflow:
        err = err | ((active & (q_len >= capacity)).any(-1).to(torch.int32)
                     * ERR_QUEUE_OVERFLOW)
    # head and len are non-negative, so % needs no sign care
    pos = ((q_head + q_len) % capacity).to(torch.int64).unsqueeze(-1)
    hit = active.unsqueeze(-1)
    for plane, val in ((q_meta, meta_e), (q_data, data_e)):
        old = torch.gather(plane, -1, pos)
        plane.scatter_(-1, pos, torch.where(hit, val.unsqueeze(-1), old))
    return q_meta, q_data, err


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


def queue_step(q_meta, q_data, q_head, q_len, time, src_first, src_lo,
               src_hi, *, capacity: int):
    """The fused delivery selection of the exact tick (``queue_step_plain``
    says what it computes). ``src_first`` [E] drives the plain version;
    the kernel walks each source's edges between ``src_lo`` and
    ``src_hi`` [N] (the same segments). ``time`` holds one clock per
    lane."""
    if q_meta.device.type == "cpu":
        return queue_step_plain(q_meta, q_data, q_head, q_len, time,
                                src_first, capacity=capacity)
    lead = tuple(q_head.shape)
    dev = q_meta.device
    if q_meta.shape[-1] != capacity:
        raise ValueError(f"q_meta has {q_meta.shape[-1]} slots, capacity "
                         f"is {capacity}")
    _check({"q_meta": q_meta, "q_data": q_data}, torch.int32,
           lead + (capacity,), dev)
    _check({"q_head": q_head, "q_len": q_len}, torch.int32, lead, dev)
    _check({"time": time}, torch.int32, lead[:-1], dev)
    n = src_lo.shape[0]
    _check({"src_lo": src_lo, "src_hi": src_hi}, torch.int32, (n,), dev)
    e = lead[-1]
    rows = (q_head.numel() // e) * n if e else 0
    tok = torch.empty(lead, dtype=torch.bool, device=dev)
    mk = torch.empty(lead, dtype=torch.bool, device=dev)
    head_data = torch.empty(lead, dtype=torch.int32, device=dev)
    new_head = torch.empty(lead, dtype=torch.int32, device=dev)
    new_len = torch.empty(lead, dtype=torch.int32, device=dev)
    code = _fn("clsim_queue_step")(
        q_meta.data_ptr(), q_data.data_ptr(), q_head.data_ptr(),
        q_len.data_ptr(), time.data_ptr(), src_lo.data_ptr(),
        src_hi.data_ptr(), tok.data_ptr(), mk.data_ptr(),
        head_data.data_ptr(), new_head.data_ptr(), new_len.data_ptr(),
        rows, n, e, capacity, _build.stream_ptr(q_meta))
    _build.check(code, "clsim_queue_step")
    LAUNCHES["queue_step"] += 1
    return tok, mk, head_data, new_head, new_len


def select_pop(q_head, q_len, elig, src_first, src_lo, src_hi, *,
               capacity: int):
    """The selection + pop of the faulted exact tick (``select_pop_plain``
    says what it computes): ``src_first`` [E] drives the plain version,
    the kernel walks each source's edges between ``src_lo`` and ``src_hi``
    [N] (the same segments)."""
    if q_head.device.type == "cpu":
        return select_pop_plain(q_head, q_len, elig, src_first,
                                capacity=capacity)
    lead = tuple(q_head.shape)
    dev = q_head.device
    _check({"q_head": q_head, "q_len": q_len}, torch.int32, lead, dev)
    _check({"elig": elig}, torch.bool, lead, dev)
    n = src_lo.shape[0]
    _check({"src_lo": src_lo, "src_hi": src_hi}, torch.int32, (n,), dev)
    e = lead[-1]
    rows = (q_head.numel() // e) * n if e else 0
    sel = torch.empty(lead, dtype=torch.bool, device=dev)
    new_head = torch.empty(lead, dtype=torch.int32, device=dev)
    new_len = torch.empty(lead, dtype=torch.int32, device=dev)
    code = _fn("clsim_select_pop")(
        q_head.data_ptr(), q_len.data_ptr(), elig.data_ptr(),
        src_lo.data_ptr(), src_hi.data_ptr(), sel.data_ptr(),
        new_head.data_ptr(), new_len.data_ptr(), rows, n, e, capacity,
        _build.stream_ptr(q_head))
    _build.check(code, "clsim_select_pop")
    LAUNCHES["select_pop"] += 1
    return sel, new_head, new_len


def append_rows(q_meta, q_data, q_head, q_len, tok_pushed, active,
                meta_e, rt_e, data_e, *, capacity: int, key_limit: int,
                flag_queue_overflow: bool = True):
    """The batched ring append with overflow flagging, in place (module
    docstring). ``meta_e`` is the packed slot word, ``rt_e`` the raw
    receive time for the RTIME_PACK_LIMIT check. Returns (q_meta, q_data,
    err) with err [leading axes] int32."""
    if q_meta.device.type == "cpu":
        return append_rows_plain(
            q_meta, q_data, q_head, q_len, tok_pushed, active, meta_e, rt_e,
            data_e, capacity=capacity, key_limit=key_limit,
            flag_queue_overflow=flag_queue_overflow)
    lead = tuple(q_head.shape)
    dev = q_meta.device
    if q_meta.shape[-1] != capacity:
        raise ValueError(f"q_meta has {q_meta.shape[-1]} slots, capacity "
                         f"is {capacity}")
    _check({"q_meta": q_meta, "q_data": q_data}, torch.int32,
           lead + (capacity,), dev)
    _check({"q_head": q_head, "q_len": q_len, "tok_pushed": tok_pushed,
            "meta_e": meta_e, "rt_e": rt_e, "data_e": data_e},
           torch.int32, lead, dev)
    _check({"active": active}, torch.bool, lead, dev)
    e = lead[-1]
    b = q_head.numel() // e if e else 0
    err = torch.zeros(lead[:-1], dtype=torch.int32, device=dev)
    code = _fn("clsim_append_rows")(
        q_meta.data_ptr(), q_data.data_ptr(), q_head.data_ptr(),
        q_len.data_ptr(), tok_pushed.data_ptr(), active.data_ptr(),
        meta_e.data_ptr(), rt_e.data_ptr(), data_e.data_ptr(),
        err.data_ptr(), b, e, capacity, key_limit,
        int(flag_queue_overflow), _build.stream_ptr(q_meta))
    _build.check(code, "clsim_append_rows")
    LAUNCHES["append_rows"] += 1
    return q_meta, q_data, err
