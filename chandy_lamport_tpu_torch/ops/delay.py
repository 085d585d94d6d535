"""Message-delay samplers of the port (the JAX package's
``ops/delay_jax.py``: ``HashJaxDelay``, ``FixedJaxDelay`` and
``GoExactJaxDelay``).

A sampler is a stateless object; its state rides in
``DenseState.delay_state`` as a tuple of tensors with a leading lane axis
``[B]``. Every draw is a pure function of that state, so the port
reproduces the JAX stream bit for bit. ``host_dtypes`` names the numpy
dtype of each state word in the JAX package (``utils/carry.py`` converts).

Position streams: a sampler whose draw value depends only on its stream
position (``position_streams = True``: hash, fixed) also serves a block of
draws at ``current + offsets`` out of order (``block_receive_times``) and
skips the stream past them (``advance_draws``), which is what the exact
tick's marker broadcast uses. The Go-exact stream is order-dependent and
draws one at a time.

uint32 arithmetic: PyTorch has no usable uint32 tensor arithmetic, so the
32-bit words are int64 tensors holding values in ``[0, 2^32)``. Every
operation masks back to 32 bits; a multiply by a 32-bit constant is split
into its 16-bit halves so no intermediate leaves int64's positive range
(``_mul32``), and shifts are logical because the values are non-negative.
"""

from __future__ import annotations

import numpy as np
import torch

from chandy_lamport_tpu_torch.config import MAX_DELAY
from chandy_lamport_tpu_torch.ops.gorand import LEN as _GO_LEN
from chandy_lamport_tpu_torch.ops.gorand import GoRand

_M32 = 0xFFFFFFFF
_M63 = (1 << 63) - 1


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant ``c``: each partial product stays below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    """The "lowbias32" mixer on uint32 words held in int64 (delay_jax.py
    ``_lowbias32``): three xor-shifts and two wrapping multiplies."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _lane_cols(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-lane tensor reshaped to broadcast against ``like``, whose
    leading axes are the lane axes."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


class FixedDelay:
    """Constant delay; stateless (``delay_state == ()``)."""

    position_streams = True   # every position draws the same constant
    host_dtypes = ()

    def __init__(self, delay: int = 1):
        if delay < 1:
            raise ValueError("delay must be >= 1")
        self.delay = delay
        self.max_delay = delay

    def init_batch_state(self, batch: int, device="cuda"):
        return ()

    def draw(self, dstate, time):
        return time + self.delay, dstate

    def draw_many(self, dstate, time, shape):
        """Receive times of shape ``time.shape + shape``."""
        shape = _shape(shape)
        out = (time + self.delay).reshape(time.shape + (1,) * len(shape))
        return out.expand(time.shape + shape).clone(), dstate

    def block_receive_times(self, dstate, time, offsets):
        return (_lane_cols(time, offsets) + self.delay).expand(
            offsets.shape).clone()

    def advance_draws(self, dstate, count):
        return dstate


class HashDelay:
    """Uniform delay in {1..max_delay} from a counter hash:
    ``mix(mix(ctr) ^ key ^ mix(epoch)) % max_delay``. State is
    ``(key, ctr, epoch)``; the epoch advances when the counter wraps, and
    elements of one ``draw_many`` past the wrap take the next epoch
    (the JAX ``HashJaxDelay`` docstring)."""

    _LANE_MULT = 0x85EBCA6B  # odd, so lane -> key is injective mod 2^32
    position_streams = True   # value = hash(key, counter, epoch) only
    host_dtypes = ("uint32", "uint32", "uint32")

    def __init__(self, seed: int, max_delay: int = MAX_DELAY):
        self.seed = seed
        self.max_delay = max_delay

    def _base_key(self, device) -> torch.Tensor:
        return _lowbias32(torch.tensor((self.seed ^ 0x9E3779B9) & _M32,
                                       dtype=torch.int64, device=device))

    def init_batch_state(self, batch: int, device="cuda"):
        lane = torch.arange(batch, dtype=torch.int64, device=device)
        key = self._base_key(device) ^ _mul32(lane, self._LANE_MULT)
        zero = torch.zeros(batch, dtype=torch.int64, device=device)
        return (key, zero, zero.clone())

    def _delays(self, key, idx, epoch) -> torch.Tensor:
        mixed = _lowbias32(_lowbias32(idx) ^ key ^ _lowbias32(epoch))
        return (mixed % self.max_delay).to(torch.int32)

    def draw(self, dstate, time):
        key, ctr, epoch = dstate
        new_ctr = (ctr + 1) & _M32
        return (time + 1 + self._delays(key, ctr, epoch),
                (key, new_ctr, (epoch + (new_ctr == 0)) & _M32))

    def draw_many(self, dstate, time, shape):
        """Receive times of shape ``time.shape + shape``: one counter per
        element, in row-major order from the lane's counter."""
        shape = _shape(shape)
        key, ctr, epoch = dstate
        n = 1
        for dim in shape:
            n *= dim
        lanes = ctr.shape
        col = (1,) * len(shape)
        ctr_b = ctr.reshape(lanes + col)
        idx = (ctr_b + torch.arange(n, dtype=torch.int64, device=ctr.device)
               .reshape(shape)) & _M32
        elem_epoch = (epoch.reshape(lanes + col) + (idx < ctr_b)) & _M32
        new_ctr = (ctr + n) & _M32
        rts = (time.reshape(lanes + col) + 1
               + self._delays(key.reshape(lanes + col), idx, elem_epoch))
        return rts, (key, new_ctr, (epoch + (new_ctr < ctr)) & _M32)

    def block_receive_times(self, dstate, time, offsets):
        """Receive times at stream positions ``counter + offsets`` (offsets
        ``[B, ...]``, any order) without advancing the stream; an element
        past the counter wrap takes the next epoch, as in draw_many."""
        key, ctr, epoch = dstate
        ctr_b = _lane_cols(ctr, offsets)
        idx = (ctr_b + offsets.to(torch.int64)) & _M32
        elem_epoch = (_lane_cols(epoch, offsets) + (idx < ctr_b)) & _M32
        return (_lane_cols(time, offsets) + 1
                + self._delays(_lane_cols(key, offsets), idx, elem_epoch))

    def advance_draws(self, dstate, count):
        """The state after ``count`` ([B]) more draws."""
        key, ctr, epoch = dstate
        new_ctr = (ctr + count.to(torch.int64)) & _M32
        return key, new_ctr, (epoch + (new_ctr < ctr)) & _M32


def _add64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b mod 2^64`` on int64 tensors holding uint64 bit patterns,
    computed in 32-bit halves so that no signed operation overflows: the
    low halves sum below 2^33, the high half is reduced mod 2^32 and
    re-signed, and ``hi * 2^32 + lo`` stays inside int64's range."""
    lo = (a & _M32) + (b & _M32)
    hi = ((a >> 32) + (b >> 32) + (lo >> 32)) & _M32
    hi = hi - ((hi >> 31) << 32)          # [0, 2^32) -> [-2^31, 2^31)
    return hi * (1 << 32) + (lo & _M32)


class GoExactDelay:
    """The reference's delays, bit for bit: ``time + 1 + Intn(max_delay)``
    from Go's ``math/rand`` seeded with ``seed`` (reference sim.go:100-102;
    the JAX ``GoExactJaxDelay`` over ``ops/gorand_jax.py``).

    The host ``GoRand`` seeds the generator; the state is ``(vec [B, 607]
    int64 holding the uint64 words bit for bit, tap [B] int32, feed [B]
    int32)``, one seeded stream broadcast to every lane (the JAX default:
    a shared conformance stream). The stream is order-dependent, so
    ``position_streams`` is False and draws go one at a time."""

    position_streams = False
    host_dtypes = ("uint64", "int32", "int32")

    def __init__(self, seed: int, max_delay: int = MAX_DELAY):
        if not 0 < max_delay < 1 << 31:
            raise ValueError(f"max_delay must be in [1, 2^31), got "
                             f"{max_delay}")
        self.seed = seed
        self.max_delay = max_delay

    def init_batch_state(self, batch: int, device="cuda"):
        vec, tap, feed = GoRand(self.seed).state_arrays()
        vec = torch.from_numpy(vec.view(np.int64)).to(device)
        return (vec.expand(batch, -1).clone(),
                torch.full((batch,), tap, dtype=torch.int32, device=device),
                torch.full((batch,), feed, dtype=torch.int32, device=device))

    @staticmethod
    def _int31(dstate):
        """One Uint64 step per lane, as Int31 = (x & (2^63-1)) >> 32."""
        vec, tap, feed = dstate
        tap = (tap - 1) % _GO_LEN               # torch's % floors
        feed = (feed - 1) % _GO_LEN
        lanes = torch.arange(vec.shape[0], device=vec.device)
        x = _add64(vec[lanes, feed.long()], vec[lanes, tap.long()])
        vec = vec.index_put((lanes, feed.long()), x)
        return ((x & _M63) >> 32).to(torch.int32), (vec, tap, feed)

    def _intn(self, dstate):
        """Go ``Intn(max_delay)`` per lane: the power-of-two mask, or
        rejection sampling that redraws only the lanes still rejected."""
        n = self.max_delay
        v, dstate = self._int31(dstate)
        if n & (n - 1) == 0:
            return v & (n - 1), dstate
        vmax = (1 << 31) - 1 - (1 << 31) % n
        rejected = v > vmax
        while bool(rejected.any()):
            v2, redrawn = self._int31(dstate)
            dstate = select_words(rejected, redrawn, dstate)
            v = torch.where(rejected, v2, v)
            rejected = rejected & (v > vmax)
        return v % n, dstate

    def draw(self, dstate, time):
        d, dstate = self._intn(dstate)
        return time + 1 + d, dstate


def select_words(mask, new, old):
    """Per-lane ``where(mask, new, old)`` over a sampler state's words
    (mask ``[B]``)."""
    return tuple(torch.where(_lane_cols(mask, a), a, b)
                 for a, b in zip(new, old))


def make_fast_delay(name: str, seed: int, max_delay: int = MAX_DELAY):
    """The bench's ``--delay`` choices; only "hash" is ported."""
    if name == "hash":
        return HashDelay(seed, max_delay)
    if name == "uniform":
        raise NotImplementedError(
            "the threefry 'uniform' sampler is not ported yet; use "
            "--delay hash")
    raise ValueError(f"unknown fast delay sampler {name!r}")
