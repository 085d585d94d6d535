"""The deterministic, replayable fault adversary of the exact scheduler.

The port of the JAX package's ``models/faults.JaxFaults`` (its module
docstring describes the fault classes: token drop / duplicate / jitter,
node crashes in "pause" or "lossy" mode, and the marker-plane drop /
duplicate / jitter the snapshot supervisor exists to survive). Every fault
is a pure function of (per-lane stream key, tick, index) through the same
counter hash, so a faulted run replays bit for bit from its seed, and the
port's masks equal the JAX masks word for word.

The uint32 words are int64 tensors holding values in ``[0, 2^32)``, as
everywhere in the port (``ops/delay.py``): a time or index is masked to 32
bits before any multiply, so a negative time (``restarted`` hashes
``time - 1``, which is -1 at time 0, and ``down_nodes`` the window
``time // crash_period``, -1 there) wraps to ``0xFFFFFFFF`` as jnp's
``astype(uint32)`` does. ``//`` and ``%`` on the clock floor, as jnp's do.

Shapes: ``key`` and ``time`` are per lane, ``[B]``; a mask over edges or
nodes is ``[B, E]`` or ``[B, N]``.
"""

from __future__ import annotations

import torch

from chandy_lamport_tpu_torch.config import MAX_DELAY
from chandy_lamport_tpu_torch.ops.delay import _lowbias32, _mul32

_M32 = 0xFFFFFFFF

# per-class hash domains (the JAX module's, in its order)
(_CLS_DROP, _CLS_DUP, _CLS_JITTER, _CLS_CRASH, _CLS_DUP_DELAY,
 _CLS_MDROP, _CLS_MDUP, _CLS_MJITTER, _CLS_MDUP_DELAY) = range(1, 10)


def _u32(x) -> torch.Tensor:
    """An integer tensor as a uint32 word held in int64 (two's-complement
    wrap for negative values)."""
    return x.to(torch.int64) & _M32


def _word(key, cls: int, time, idx):
    """One uint32 fault word per (lane, index): ``key``/``time`` [B],
    ``idx`` [K] -> [B, K]."""
    t = _lowbias32(_mul32(_u32(time), 2654435769))
    h = _lowbias32(_u32(idx) ^ t.unsqueeze(-1))
    return _lowbias32(h ^ key.unsqueeze(-1)
                      ^ ((cls * 0x9E3779B9) & _M32))


class Faults:
    """Seeded fault program (the JAX ``JaxFaults``: same arguments, same
    validation, same streams). A zero-rate class gives all-False masks
    without hashing; ``crash_start`` switches the crash schedule from
    hashed periodic windows to one window [crash_start, crash_start +
    crash_len)."""

    def __init__(self, seed: int, *, drop_rate: float = 0.0,
                 dup_rate: float = 0.0, jitter_rate: float = 0.0,
                 crash_rate: float = 0.0, crash_len: int = 2,
                 crash_period: int = 32, crash_mode: str = "pause",
                 crash_start: int | None = None,
                 marker_drop_rate: float = 0.0,
                 marker_dup_rate: float = 0.0,
                 marker_jitter_rate: float = 0.0,
                 max_delay: int = MAX_DELAY):
        for name, r in (("drop_rate", drop_rate), ("dup_rate", dup_rate),
                        ("jitter_rate", jitter_rate),
                        ("crash_rate", crash_rate),
                        ("marker_drop_rate", marker_drop_rate),
                        ("marker_dup_rate", marker_dup_rate),
                        ("marker_jitter_rate", marker_jitter_rate)):
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {r}")
        if crash_mode not in ("pause", "lossy"):
            raise ValueError(f"unknown crash_mode {crash_mode!r}")
        if crash_len < 1 or crash_period < 2 or crash_len >= crash_period:
            raise ValueError(
                "need 1 <= crash_len < crash_period (a window must end "
                "before the next can start, or restarts never fire)")
        self.seed = int(seed)
        self.drop_rate = float(drop_rate)
        self.dup_rate = float(dup_rate)
        self.jitter_rate = float(jitter_rate)
        self.crash_rate = float(crash_rate)
        self.crash_len = int(crash_len)
        self.crash_period = int(crash_period)
        self.crash_mode = crash_mode
        self.crash_start = None if crash_start is None else int(crash_start)
        self.marker_drop_rate = float(marker_drop_rate)
        self.marker_dup_rate = float(marker_dup_rate)
        self.marker_jitter_rate = float(marker_jitter_rate)
        self.max_delay = int(max_delay)

    @property
    def crashes(self) -> bool:
        """True when crash windows can ever fire (a lossy restart changes
        a drained lane, so the exact path's quiescence exit is off)."""
        return self.crash_rate > 0.0 or self.crash_start is not None

    def describe(self) -> dict:
        """The fault program as JSON (bench rows)."""
        return {"seed": self.seed, "drop": self.drop_rate,
                "dup": self.dup_rate, "jitter": self.jitter_rate,
                "crash": self.crash_rate, "crash_len": self.crash_len,
                "crash_period": self.crash_period,
                "crash_mode": self.crash_mode,
                "crash_start": self.crash_start,
                "marker_drop": self.marker_drop_rate,
                "marker_dup": self.marker_dup_rate,
                "marker_jitter": self.marker_jitter_rate}

    # -- stream keys (DenseState.fault_key) ----------------------------------

    def _base_key(self) -> int:
        x = (self.seed ^ 0x243F6A88) & _M32
        for mul in (0x7FEB352D, 0x846CA68B):
            x ^= x >> 16
            x = (x * mul) & _M32
        x ^= x >> 16
        return x

    def init_batch_state(self, batch: int, device="cuda") -> torch.Tensor:
        """Per-lane keys [B]: odd base + stride-2 ramp mod 2^32, never zero
        (a zero key disarms its lane)."""
        lane = torch.arange(batch, dtype=torch.int64, device=device)
        return ((self._base_key() | 1) + 2 * lane) & _M32

    # -- per-tick masks --------------------------------------------------------

    def _rate_mask(self, key, cls: int, rate: float, time, idx):
        shape = key.shape + idx.shape
        if rate <= 0.0:
            return torch.zeros(shape, dtype=torch.bool, device=key.device)
        armed = (key != 0).unsqueeze(-1)
        if rate >= 1.0:
            return armed.expand(shape)
        thresh = min(int(rate * 2.0**32), 2**32 - 1)
        return armed & (_word(key, cls, time, idx) < thresh)

    def _idx(self, key, n: int):
        return torch.arange(n, dtype=torch.int64, device=key.device)

    def edge_masks(self, key, time, num_edges: int):
        """This tick's token program: (drop, dup, jitter) bool [B, E] and
        the dup re-enqueue delay words [B, E]."""
        idx = self._idx(key, num_edges)
        return (self._rate_mask(key, _CLS_DROP, self.drop_rate, time, idx),
                self._rate_mask(key, _CLS_DUP, self.dup_rate, time, idx),
                self._rate_mask(key, _CLS_JITTER, self.jitter_rate, time,
                                idx),
                _word(key, _CLS_DUP_DELAY, time, idx))

    def marker_masks(self, key, time, num_edges: int):
        """The marker-plane twin of ``edge_masks``."""
        idx = self._idx(key, num_edges)
        return (self._rate_mask(key, _CLS_MDROP, self.marker_drop_rate,
                                time, idx),
                self._rate_mask(key, _CLS_MDUP, self.marker_dup_rate,
                                time, idx),
                self._rate_mask(key, _CLS_MJITTER, self.marker_jitter_rate,
                                time, idx),
                _word(key, _CLS_MDUP_DELAY, time, idx))

    def down_nodes(self, key, time, num_nodes: int):
        """[B, N] bool: nodes down at ``time`` ([B] int32)."""
        idx = self._idx(key, num_nodes)
        if not self.crashes:
            return torch.zeros(key.shape + (num_nodes,), dtype=torch.bool,
                               device=key.device)
        if self.crash_start is not None:
            in_window = ((time >= self.crash_start)
                         & (time < self.crash_start + self.crash_len))
            gate = self._rate_mask(key, _CLS_CRASH, self.crash_rate or 1.0,
                                   torch.zeros_like(time), idx)
            return gate & in_window.unsqueeze(-1)
        # torch's // and % floor on integer tensors, as jnp's do
        window = torch.div(time, self.crash_period, rounding_mode="floor")
        gate = self._rate_mask(key, _CLS_CRASH, self.crash_rate, window, idx)
        return gate & ((time % self.crash_period)
                       < self.crash_len).unsqueeze(-1)

    def restarted(self, key, time, num_nodes: int):
        """[B, N] bool: nodes whose crash window ended exactly at
        ``time`` (down at time - 1, up now)."""
        prev = self.down_nodes(key, time - 1, num_nodes)
        now = self.down_nodes(key, time, num_nodes)
        return prev & ~now & (time >= 1).unsqueeze(-1)

    # -- the fused megatick's view of the program -------------------------------

    def fault_planes(self, key, time, steps: int, num_edges: int,
                     num_nodes: int, max_delay: int):
        """The next ``steps`` ticks' program as the JAX ``_fault_planes``
        (``ops/tick.py:854``) lays it out, per lane: an edge plane [B, K,
        8, E] int32 with rows (drop, dup, jit, dup_rt, mdrop, mdup, mjit,
        mdup_rt) and a node plane [B, K, 2, N] int32 with rows (down_n,
        rs_n); row j is tick time ``time + 1 + j`` (int32, wrapping), and
        a receive time is ``t + 1 + word % max(max_delay, 1)``. The tick
        path never builds these: the fused kernel hashes the same words
        in place. They serve the tests and the chip check of that
        hash."""
        md = max(int(max_delay), 1)
        i32 = torch.int32
        eps, nps = [], []
        for j in range(steps):
            t = time + (1 + j)
            tt = t.unsqueeze(-1)
            drop, dup, jit, dupw = self.edge_masks(key, t, num_edges)
            mdrop, mdup, mjit, mw = self.marker_masks(key, t, num_edges)
            eps.append(torch.stack([
                drop.to(i32), dup.to(i32), jit.to(i32),
                tt + 1 + (dupw % md).to(i32),
                mdrop.to(i32), mdup.to(i32), mjit.to(i32),
                tt + 1 + (mw % md).to(i32)], dim=-2))
            nps.append(torch.stack([
                self.down_nodes(key, t, num_nodes).to(i32),
                self.restarted(key, t, num_nodes).to(i32)], dim=-2))
        return torch.stack(eps, dim=1), torch.stack(nps, dim=1)

    def kernel_program(self) -> dict:
        """The program as ``csrc/megatick.cu`` takes it: per class in
        ``core/state.FC_*`` order (drop, dup, jitter, crash, marker drop,
        dup, jitter) a uint32 threshold and an arm flag, derived as
        ``_rate_mask`` derives them (0: the class never fires and nothing
        is hashed; 1: it fires where the word is below the threshold; 2:
        rate >= 1, it fires on every armed lane), the crash gate's rate
        being ``crash_rate or 1.0`` in the ``crash_start`` window mode;
        and the crash schedule: ``crash_kind`` 0 (no crashes), 1 (hashed
        periodic windows) or 2 (the one ``crash_start`` window)."""
        crash_rate = self.crash_rate
        if self.crash_start is not None:
            crash_rate = crash_rate or 1.0
        arms, thresh = [], []
        for rate in (self.drop_rate, self.dup_rate, self.jitter_rate,
                     crash_rate, self.marker_drop_rate,
                     self.marker_dup_rate, self.marker_jitter_rate):
            if rate <= 0.0:
                arms.append(0)
                thresh.append(0)
            elif rate >= 1.0:
                arms.append(2)
                thresh.append(0)
            else:
                arms.append(1)
                thresh.append(min(int(rate * 2.0**32), 2**32 - 1))
        kind = (0 if not self.crashes
                else 2 if self.crash_start is not None else 1)
        return {"arm": arms, "thresh": thresh, "crash_kind": kind,
                "crash_lossy": int(self.crash_mode == "lossy"),
                "crash_len": self.crash_len,
                "crash_period": self.crash_period,
                "crash_start": self.crash_start or 0}
