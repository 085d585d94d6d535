"""The fused megatick: K exact ticks of every lane in one CUDA launch.

The port of the JAX package's ``kernels/megatick.py`` Pallas ``fused_scan``
(:432, ``pl.pallas_call`` :641, with ``RingStream.commit_and_heads``
:380): the cascade and wave ticks — what the golden runs
(``DenseSim``, megatick 8) and the exact storm's drain and flush at
megatick K run — with its recorder arm (the flight recorder's sites inside
the step, run when ``TickKernel._trace_on``: the JAX kernel traces the
stock tick, recorder included, ``kernels/megatick.py:83-84``) and its
fault arm: the adversary (``models/faults.Faults``) and the snapshot
supervisor run inside the step. The JAX kernel streams the adversary's next K ticks in as
``edge_plane`` [K, 8, E] / ``aux_plane`` [K, 2, N] (``_fault_planes``,
``ops/tick.py:854``); the hash is stateless in (key, time, index), so the
CUDA kernel hashes each step's masks in place instead
(``Faults.kernel_program`` gives it the thresholds), and
``fault_hash_planes`` fills the JAX planes from that same device hash for
the chip check against ``Faults.fault_planes``.

``fused_ticks`` runs ``length`` steps of one of three step bodies on every
lane (the JAX ``_run_ticks`` megatick and ``_drain_and_flush_with``'s
fused drain and flush, ``ops/tick.py:2204-2237``, :2549-2624):

  "ticks"  ``quiet |= halted`` at each step, a quiet step is a bare
           ``time += 1`` (+ 0 on an errored lane under quarantine), any
           other step one cascade tick;
  "drain"  a step ticks while ``pending & time < limit`` [B] (and
           ``error == 0`` under quarantine), else it is the identity;
  "flush"  every step ticks (gated on ``error == 0`` under quarantine).

``live`` [B] gates the lanes in every mode (required for "ticks"; for
"drain" and "flush" None means every lane): a lane not live at launch is
left exactly as it was. The streaming engine's drain slice passes its
lanes in the drain stage, with each job's absolute ``limit``, and its
flush its lanes in the flush stage (the JAX ``_fused_stream_drain`` and
``_fused_flush`` under ``lax.cond``, ``ops/tick.py:2606-2672``).

On a CPU state it takes ``fused_ticks_plain``, the same steps through the
port's PyTorch cascade tick; on a CUDA state it launches
``csrc/megatick.cu`` (or raises). The kernel writes the state's leaves in
place, so the caller must own the state it passes.

Layout on the card: a lane's whole state does not fit in a block's shared
memory (the ER-256 lane holds 0.347 MB), so the JAX resident layout
(``fused_vmem_bytes``, :163) does not carry over. The kernel keeps the
``[E, C]`` rings, the ``[L, E]`` log and the ``[S, E]`` windows in device
memory, read and written in place (the JAX tiled idea, :48-78, without
its deferred appends: ``ring_append_slots``, :131, has no counterpart
here), and lays the tick's working planes (``fused_smem_bytes``: the
``[E]`` vectors, the ``[S, N]`` planes, ``recording`` [S, E]) out in one
of two layouts, chosen from the lane's working set alone by
``resolve_fused`` (the JAX ``fused_tile``, :263: "auto" by the working
set, "on" and "off" forced):

  resident  the planes in the block's shared memory (up to
            ``SMEM_BUDGET``; ER-256: 52,416 B, SF-1k at S=8: 208,736 B);
  tiled     the planes in a device-memory workspace, one
            ``fused_smem_bytes`` stride per lane (``fused_workspace``,
            kept on the ``TickKernel``), for lanes past a block's share
            (config 5, SF-8k at S=8: 1,671,200 B). The
            step bodies are the same code; on the card the TPU's problem,
            rings past VMEM, is already solved, and what overflows is the
            working set, so that is what this layout moves off chip.

Every plane is loaded from the state at launch and written back at exit
in both layouts; no launch reads what an earlier one left in the
workspace.

The samplers: fixed, hash, Go-exact and threefry (``UniformDelay``, the
kernel's ``kThreefry`` kind, its key's two words a lane); an
order-dependent one (Go-exact, threefry) is drawn by thread 0 in stream
order into a buffer of the tick's draws. The window planes: int32, or
under ``window_dtype="uint16"`` the kernel's uint16 arm, which writes the
2-byte planes in place (``rec_start16`` / ``rec_end16``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from chandy_lamport_tpu_torch.kernels import _build
from chandy_lamport_tpu_torch.ops.delay import (
    FixedDelay,
    GoExactDelay,
    HashDelay,
    UniformDelay,
)
from chandy_lamport_tpu_torch.ops.gorand import LEN as GO_LEN

# dynamic shared memory one block may use on an H100 (227 KB)
SMEM_BUDGET = 232_448

MODES = {"ticks": 0, "drain": 1, "flush": 2}

# launches of the CUDA kernel wrapper (the plain version is not counted);
# "fused_scan_tiled" counts the launches of the tiled layout again, and
# "fused_scan_traced" those of the recorder arm
LAUNCHES = {"fused_scan": 0, "fused_scan_tiled": 0, "fused_scan_traced": 0}

# the traced wave keeps each in-edge's wave (its node's markers of a tick
# below it) in int16: a node may have at most this many in-edges
WAVE_MAX_IN_DEGREE = 32_768

# traced, the draw bases' plane (the ranked append's count table once the
# owner step has read the bases) holds at least this many words: 8 warps
# by 32 key groups (``csrc/megatick.cu`` kRankMin)
RANK_MIN_WORDS = 8 * 32


def fault_arm(tk) -> bool:
    """Whether ``tk``'s fused megatick runs the fault arm: the adversary
    or the snapshot supervisor armed (the kernel's ``ext`` instantiation,
    and its larger share of shared memory)."""
    return tk.faults is not None or tk._sup


def wave_arm(tk) -> bool:
    """Whether ``tk``'s fused megatick runs the wave (``exact_impl=
    "wave"``). The kernel runs one destination-owned step for the cascade
    and the wave alike, so untraced this only names the tick form; traced,
    it picks the wave's key order for the recorder's ranked append (the
    kernel's traced ``kWave`` instantiations) over the cascade's, and its
    share."""
    return tk.exact_impl == "wave"


def fused_smem_bytes(n: int, e: int, s: int, *,
                     fault_arm: bool = False, wave: bool = False,
                     trace: bool = False, go_exact: bool = False) -> int:
    """One lane's working set, the one reckoning of it: the block's share
    of shared memory in the resident layout, the lane's stride in the
    workspace in the tiled one (the wrapper passes it to the kernel, which
    checks its own layout against it). It holds the ``[E]`` vectors
    q_head, q_len, tok_pushed, rec_cnt, min_prot and the tick's head_data
    (int32) and tok/mk/app (bool); ``tokens`` [N]; the ``[S, N]`` planes
    frozen, rem (int32), has_local, done_local (bool); ``recording`` [S,
    E] (bool); completed, snap_done_time (int32), started, snap_failed
    (bool) [S]; 4 words of control. ``fault_arm`` (``fault_arm(tk)``: the
    adversary or the supervisor armed) adds the supervisor's ``[S]``
    vectors snap_epoch, snap_deadline, snap_retries,
    snap_initiator, the 7 fault counts, next_sid, fault_skew and
    stale_markers (int32); the step's fault flags and duplicate kind per
    edge, the down flag per node and a retry flag per slot (bytes).
    The tick-start schedule of the owner step adds each edge's draw base
    (int32; traced, at least ``RANK_MIN_WORDS`` of them: the plane holds
    the ranked append's count table after the step) and first-receipt flag
    (byte) and 24 words of control; the traced wave (``wave``,
    ``wave_arm(tk)``, with ``trace``) adds each edge's wave number
    (int16). ``go_exact`` (an order-dependent sampler: Go-exact,
    threefry) adds a buffer of the tick's draws, at most one broadcast per (slot, node): S x E words.
    ``trace`` (``tk._trace_on``) adds the recorder's word per edge and its
    9 control words (the lane's count and the block scan's 8 warp sums).
    The rings, the log, the windows, the trace ring and the delay stream
    stay in device memory. Rounded up to 16 B."""
    ints = 6 * e + n + 2 * s * n + 2 * s + 4
    flags = 3 * e + s * e + 2 * s * n + 2 * s
    if fault_arm:
        ints += 4 * s + 10
        flags += 2 * e + n + s
    # the draw bases (traced, the count table's floor) and the control
    # words; the first-receipt flag
    ints += (max(e, RANK_MIN_WORDS) if trace else e) + 24
    flags += e
    if wave and trace:
        flags += 2 * e          # the int16 wave number
    if go_exact:
        ints += s * e
    if trace:
        ints += e + 9
    return (4 * ints + flags + 15) // 16 * 16


def resolve_fused(*, megatick: int, device: torch.device, smem_bytes: int,
                  fused_tick: str = "auto", fused_tile: str = "auto",
                  marker_mode: str = "ring", exact_impl: str = "cascade",
                  budget: int = SMEM_BUDGET) -> tuple[str, str, str, str]:
    """Where the megatick-K loops of the exact tick run, and in which
    layout, as (fused, reason, tile, tile reason), each "on"|"off" (the
    JAX ``resolve_fused_tick`` and ``resolve_fused_tile``, :193, :263).
    The fused megatick needs megatick > 1, the ring representation and a
    vectorised formulation (the cascade or the wave; the fold is the
    specification form), and its layout: resident exactly when the lane's
    working set ``smem_bytes`` fits the ``budget`` of a block's shared
    memory (``fused_tile`` "auto": at the budget resident, one byte over
    tiled), tiled into device memory under "on", resident under "off".
    ``fused_tick`` "auto" takes it where it applies, "off" never (the
    megaticks run single ticks of the split kernels), "on" raises
    ValueError naming every unmet requirement. Where it applies it runs
    the kernel on the card, which has no plain form (a launch or a raise),
    and its plain form (``fused_ticks_plain``) on the CPU."""
    if fused_tick == "off":
        return ("off", "fused_tick='off': the split kernels, one tick at "
                "a time", "off", "fused megatick off: no kernel to tile")
    unmet = []
    if megatick <= 1:
        unmet.append(f"megatick={megatick}: one tick at a time")
    if marker_mode != "ring":
        unmet.append(f"marker_mode={marker_mode!r}: the exact tick runs "
                     "on the ring representation only")
    if exact_impl not in ("cascade", "wave"):
        unmet.append(f"exact_impl={exact_impl!r}: the fold is the "
                     "reference-literal specification form")
    if fused_tile == "off" and smem_bytes > budget:
        unmet.append(f"working set {smem_bytes} B exceeds the {budget} B "
                     "of shared memory a block can have and "
                     "fused_tile='off' forbids the workspace")
    if unmet:
        if fused_tick == "on":
            raise ValueError(
                f"fused_tick='on' impossible — {len(unmet)} unmet "
                "requirement(s): " + "; ".join(unmet))
        return "off", unmet[0], "off", "fused megatick off: no kernel to tile"
    if device.type == "cpu":
        return ("off", "CPU: the plain form", "off",
                "fused megatick off: no kernel to tile")
    why = "fused megatick engaged"
    if fused_tile == "on":
        return "on", why, "on", ("fused_tile='on': the planes lie in a "
                                 "device-memory workspace")
    if fused_tile == "off":
        return "on", why, "off", ("fused_tile='off': resident, working set "
                                  f"{smem_bytes} B")
    if smem_bytes > budget:
        return "on", why, "on", (
            f"working set {smem_bytes} B exceeds the {budget} B of shared "
            "memory a block can have: the planes lie in a device-memory "
            "workspace")
    return "on", why, "off", (
        f"working set {smem_bytes} B fits the {budget} B of shared memory "
        "a block can have: resident")


def check_wave_degree(in_degree) -> None:
    """Refuse a graph for the traced wave of the kernel when a node has
    more in-edges than the kernel's int16 wave numbers count
    (``WAVE_MAX_IN_DEGREE``), naming the first such node."""
    in_degree = np.asarray(in_degree)
    over = np.flatnonzero(in_degree > WAVE_MAX_IN_DEGREE)
    if over.size:
        raise ValueError(
            f"node {over[0]} has {in_degree[over[0]]} in-edges; the "
            "fused megatick's traced wave numbers a node's markers of a "
            f"tick in int16, so at most {WAVE_MAX_IN_DEGREE}: use "
            "exact_impl='cascade', megatick=1 or no trace")


def _check_gates(mode: str, live, limit) -> None:
    """Refuse a mode without the lane inputs it takes: "ticks" needs
    ``live``, "drain" needs ``limit`` and no other mode takes it;
    ``live`` is optional for "drain" and "flush"."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if (mode == "ticks" and live is None) or (
            (mode == "drain") != (limit is not None)):
        raise ValueError("mode 'ticks' takes live=, 'drain' takes limit=; "
                         "live= is optional for 'drain' and 'flush'")


# ---- plain version ----------------------------------------------------------

def fused_ticks_plain(tk, s, *, mode: str, length: int, live=None,
                      limit=None):
    """The fused steps (module docstring) through the port's PyTorch
    exact tick ``tk._exact_tick`` (the cascade or the wave) with per-lane
    masks: a lane that takes no tick at a step is left as it was
    (``lax.cond`` under ``vmap``). ``tk`` is the ring-mode
    ``ops/tick.TickKernel``."""
    _check_gates(mode, live, limit)
    b = s.time.shape[0]
    quiet = torch.zeros_like(s.error, dtype=torch.bool)
    for _ in range(length):
        if mode == "ticks":
            quiet = quiet | tk._halted(s)
            bump = live & quiet
            if tk.quarantine:
                bump = bump & (s.error == 0)
            s = s._replace(time=s.time + bump.to(torch.int32))
            step = live & ~quiet
        elif mode == "drain":
            step = tk._drain_cond(s, limit)
        else:
            step = (s.error == 0) if tk.quarantine else None
        if mode != "ticks" and live is not None:
            step = live if step is None else step & live
        count = b if step is None else int(step.sum())
        if count:
            s = tk._exact_tick(s, None if count == b else step)
    return s


# ---- CUDA wrapper -----------------------------------------------------------

# leaves of the state the kernel reads or writes, in ``_Args`` order, with
# their dtype and per-lane shape ("N", "E", ... resolved per call)
_LEAVES = (
    ("time", torch.int32, ()), ("tokens", torch.int32, ("n",)),
    ("q_meta", torch.int32, ("e", "c")), ("q_data", torch.int32, ("e", "c")),
    ("q_head", torch.int32, ("e",)), ("q_len", torch.int32, ("e",)),
    ("tok_pushed", torch.int32, ("e",)), ("started", torch.bool, ("s",)),
    ("has_local", torch.bool, ("s", "n")), ("frozen", torch.int32, ("s", "n")),
    ("rem", torch.int32, ("s", "n")), ("done_local", torch.bool, ("s", "n")),
    ("recording", torch.bool, ("s", "e")), ("rec_cnt", torch.int32, ("e",)),
    ("min_prot", torch.int32, ("e",)), ("log_amt", None, ("l", "e")),
    # the window planes: int32, or int16 holding uint16 bits (the kernel's
    # uint16 arm takes them through ``rec_start16`` / ``rec_end16``)
    ("rec_start", "window", ("s", "e")),
    ("rec_end", "window", ("s", "e")),
    ("completed", torch.int32, ("s",)), ("snap_failed", torch.bool, ("s",)),
    ("snap_done_time", torch.int32, ("s",)), ("error", torch.int32, ()),
    ("fault_key", torch.int64, ()), ("fault_skew", torch.int32, ()),
    ("fault_counts", torch.int32, ("fc",)),
    ("snap_epoch", torch.int32, ("s",)),
    ("snap_deadline", torch.int32, ("s",)),
    ("snap_retries", torch.int32, ("s",)),
    ("snap_initiator", torch.int32, ("s",)), ("next_sid", torch.int32, ()),
    ("stale_markers", torch.int32, ()),
)
_TABLES = ("_edge_src", "_edge_dst", "_in_degree", "_src_lo", "_src_hi",
           "_dst_lo", "_dst_hi", "_by_dst")
_INTS = ("b", "n", "e", "c", "s", "l", "log16", "rec_limit", "key_limit",
         "sampler", "max_delay", "fixed_delay", "mode", "length",
         "quarantine", "smem_bytes", "faulted", "ext", "wave", "crash_kind",
         "crash_lossy", "crash_len", "crash_period", "crash_start", "dup_mod",
         "snapshot_timeout", "snapshot_retries", "snapshot_every")
# the flight recorder's leaves, in ``_Args`` order (traced launches only)
_RING = ("tr_meta", "tr_data", "tr_tick", "tr_count", "tr_on")
_CLASSES = 7   # core/state.NUM_FAULT_CLASSES, in FC_* order
_WINDOWS = ("rec_start", "rec_end")
# the crash schedule's ints when no adversary is armed
_NO_CRASH = dict(crash_kind=0, crash_lossy=0, crash_len=0, crash_period=1,
                 crash_start=0)


class _Program(ctypes.Structure):
    """``struct ClsimFaultRates`` of ``csrc/megatick.cu``: the rate
    classes of ``Faults.kernel_program``."""

    _fields_ = [("thresh", ctypes.c_uint32 * _CLASSES),
                ("arm", ctypes.c_int * _CLASSES)]


class _Args(ctypes.Structure):
    """``struct Args`` of ``csrc/megatick.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name, _, _ in _LEAVES]
                + [(f"dw{i}", ctypes.c_void_p) for i in range(3)]
                + [("live", ctypes.c_void_p), ("limit", ctypes.c_void_p)]
                + [(t.lstrip("_"), ctypes.c_void_p) for t in _TABLES]
                + [(name, ctypes.c_int) for name in _INTS]
                + [("rates", _Program), ("workspace", ctypes.c_void_p),
                   ("workspace_bytes", ctypes.c_longlong),
                   ("tiled", ctypes.c_int)]
                + [(name, ctypes.c_void_p) for name in _RING]
                + [("tr_k", ctypes.c_int), ("traced", ctypes.c_int)]
                + [(f"{name}16", ctypes.c_void_p) for name in _WINDOWS])


_SIGS = {
    "clsim_fused_ticks": [ctypes.POINTER(_Args), ctypes.c_void_p],
    # key, time, edge plane, node plane; b, k, e, n, crash kind, len,
    # period, start, dup_mod; the rates; the stream
    "clsim_fault_planes": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
    + [ctypes.POINTER(_Program), ctypes.c_void_p],
}


@functools.cache
def _fn(name: str):
    fn = getattr(_build.library("megatick"), name)
    fn.argtypes = _SIGS[name]
    fn.restype = ctypes.c_int
    return fn


def _program(faults) -> tuple:
    """(the crash schedule's ints, the rate classes) of ``faults``
    (``Faults.kernel_program``); nothing armed when it is None."""
    if faults is None:
        return dict(_NO_CRASH), _Program()
    prog = faults.kernel_program()
    rates = _Program((ctypes.c_uint32 * _CLASSES)(*prog.pop("thresh")),
                     (ctypes.c_int * _CLASSES)(*prog.pop("arm")))
    return prog, rates


def _sampler(delay, b, dev, words):
    """(kind, fixed delay, the three state words as tensors or None)."""
    if isinstance(delay, FixedDelay):
        return 0, delay.delay, (None, None, None)
    if isinstance(delay, HashDelay):
        shapes = ((torch.int64, (b,)),) * 3
        kind = 1
    elif isinstance(delay, GoExactDelay):
        shapes = ((torch.int64, (b, GO_LEN)), (torch.int32, (b,)),
                  (torch.int32, (b,)))
        kind = 2
    elif isinstance(delay, UniformDelay):
        shapes = ((torch.int64, (b, 2)),)
        kind = 3
    else:
        raise NotImplementedError(f"no fused megatick for the "
                                  f"{type(delay).__name__} sampler")
    out = []
    for w, (dtype, shape) in zip(words, shapes):
        if w.dtype != dtype or tuple(w.shape) != shape or w.device != dev:
            raise ValueError(f"delay word: expected {dtype} {shape} on {dev},"
                             f" got {w.dtype} {tuple(w.shape)} on {w.device}")
        out.append(w.contiguous())
    return kind, 0, tuple(out) + (None,) * (3 - len(out))


def fused_workspace(tk, nbytes: int, dev: torch.device) -> torch.Tensor:
    """The tiled layout's workspace of ``tk`` (``tk.fused_workspace``):
    at least ``nbytes`` bytes on ``dev``, allocated when the one kept is
    missing, smaller or elsewhere, and kept on the kernel so that it
    outlives the launches queued on it. Its contents are never read
    before the launch writes them."""
    ws = tk.fused_workspace
    if ws is None or ws.numel() < nbytes or ws.device != dev:
        tk.fused_workspace = ws = None    # free the old one first
        ws = tk.fused_workspace = torch.empty(nbytes, dtype=torch.uint8,
                                              device=dev)
    return ws


def fused_ticks(tk, s, *, mode: str, length: int, live=None, limit=None):
    """``length`` fused steps of every lane (module docstring) in one
    launch on a CUDA state, in place; ``fused_ticks_plain`` on a CPU
    state. ``tk`` is the ring-mode ``ops/tick.TickKernel`` whose tables,
    config, adversary, supervisor, flight recorder and layout
    (``tk.fused_tile``) the kernel reads; a traced kernel launches the
    traced instantiation, which writes the state's ring. Returns the state
    (its leaves made contiguous where they were not)."""
    if s.time.device.type == "cpu":
        return fused_ticks_plain(tk, s, mode=mode, length=length, live=live,
                                 limit=limit)
    _check_gates(mode, live, limit)
    dev = s.time.device
    cfg, topo = tk.cfg, tk.topo
    b = s.time.shape[0]
    dims = {"n": topo.n, "e": topo.e, "c": cfg.queue_capacity,
            "s": cfg.max_snapshots, "l": cfg.max_recorded, "fc": _CLASSES}
    fields, ptrs = {}, {}
    for name, dtype, shape in _LEAVES:
        t = getattr(s, name)
        want = (b,) + tuple(dims[d] for d in shape)
        dtype = (tk._win_dtype if dtype == "window"
                 else dtype or tk._rec_dtype)
        if t.dtype != dtype or tuple(t.shape) != want or t.device != dev:
            raise ValueError(f"{name}: expected {dtype} {want} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        fields[name] = t.contiguous()
        ptrs[name] = fields[name].data_ptr()
    kind, fixed, words = _sampler(tk.delay, b, dev, s.delay_state)
    lane_in = {"live": live, "limit": limit}
    for name, t in lane_in.items():
        if t is not None:
            want = torch.bool if name == "live" else torch.int32
            if t.dtype != want or tuple(t.shape) != (b,) or t.device != dev:
                raise ValueError(f"{name}: expected {want} ({b},) on {dev}")
            lane_in[name] = t.contiguous()
    crash, rates = _program(tk.faults)
    ext, wave, traced = fault_arm(tk), wave_arm(tk), tk._trace_on
    share = fused_smem_bytes(topo.n, topo.e, cfg.max_snapshots,
                             fault_arm=ext, wave=wave, trace=traced,
                             go_exact=kind in (2, 3))
    k = cfg.trace_capacity if traced else 0
    for name in _RING if traced else ():
        t = getattr(s, name)
        want = (b, k) if name in _RING[:3] else (b,)
        if (t.dtype != torch.int32 or tuple(t.shape) != want
                or t.device != dev):
            raise ValueError(f"{name}: expected int32 {want} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        fields[name] = t.contiguous()
    tiled = tk.fused_tile == "on"
    if share >= 2**31:
        raise ValueError(f"one lane's working set {share} B passes the "
                         "kernel's int32 stride")
    ws = fused_workspace(tk, b * share, dev) if tiled else None
    ints = dict(b=b, log16=int(tk._rec_dtype == torch.int16),
                rec_limit=tk._rec_limit, key_limit=tk._key_limit,
                sampler=kind, max_delay=tk.delay.max_delay,
                fixed_delay=fixed, mode=MODES[mode], length=length,
                quarantine=int(tk.quarantine), smem_bytes=share,
                faulted=int(tk.faults is not None), ext=int(ext),
                wave=int(wave), **crash,
                dup_mod=max(cfg.max_delay, 1),
                snapshot_timeout=cfg.snapshot_timeout,
                snapshot_retries=cfg.snapshot_retries,
                snapshot_every=cfg.snapshot_every, **dims)
    win16 = tk._win_dtype == torch.int16
    for name in _WINDOWS if win16 else ():
        ptrs[name + "16"], ptrs[name] = ptrs[name], None
    args = _Args(
        *(ptrs[name] for name, _, _ in _LEAVES),
        *(w.data_ptr() if w is not None else None for w in words),
        *(t.data_ptr() if t is not None else None
          for t in (lane_in["live"], lane_in["limit"])),
        *(getattr(tk, t).data_ptr() for t in _TABLES),
        *(ints[name] for name in _INTS), rates,
        ws.data_ptr() if tiled else None, ws.numel() if tiled else 0,
        int(tiled),
        *(fields[name].data_ptr() if traced else None for name in _RING),
        k, int(traced), *(ptrs.get(name + "16") for name in _WINDOWS))
    code = _fn("clsim_fused_ticks")(ctypes.byref(args),
                                    _build.stream_ptr(s.time))
    _build.check(code, "clsim_fused_ticks")
    LAUNCHES["fused_scan"] += 1
    LAUNCHES["fused_scan_tiled"] += int(tiled)
    LAUNCHES["fused_scan_traced"] += int(traced)
    if words[0] is not None:
        fields["delay_state"] = tuple(w for w in words if w is not None)
    return s._replace(**fields)


def fault_hash_planes(faults, key, time, *, steps: int, num_edges: int,
                      num_nodes: int, max_delay: int):
    """``faults.fault_planes`` (the JAX ``_fault_planes`` layout: [B, K, 8,
    E] and [B, K, 2, N] int32, row j at tick time ``time + 1 + j``) filled
    on the card by the fused megatick's own device hash, one thread per
    (lane, step, edge or node): the check that the hash the kernel runs
    inside its step equals the plain masks. ``key`` [B] int64 uint32
    words, ``time`` [B] int32, both on the card."""
    dev = key.device
    if dev.type != "cuda":
        raise ValueError("fault_hash_planes runs the CUDA hash; it needs "
                         "tensors on the card")
    b = key.shape[0]
    if (key.dtype != torch.int64 or time.dtype != torch.int32
            or tuple(time.shape) != (b,) or time.device != dev):
        raise ValueError("key: int64 [B] and time: int32 [B] on one card")
    key, time = key.contiguous(), time.contiguous()
    edge = torch.empty((b, steps, 8, num_edges), dtype=torch.int32,
                       device=dev)
    node = torch.empty((b, steps, 2, num_nodes), dtype=torch.int32,
                       device=dev)
    crash, rates = _program(faults)
    code = _fn("clsim_fault_planes")(
        key.data_ptr(), time.data_ptr(), edge.data_ptr(), node.data_ptr(),
        b, steps, num_edges, num_nodes, crash["crash_kind"],
        crash["crash_len"], crash["crash_period"], crash["crash_start"],
        max(int(max_delay), 1), ctypes.byref(rates),
        _build.stream_ptr(key))
    _build.check(code, "clsim_fault_planes")
    return edge, node
