"""Message-delay samplers of the port (the JAX package's
``ops/delay_jax.py``: ``HashJaxDelay``, ``FixedJaxDelay``,
``GoExactJaxDelay`` and ``UniformJaxDelay``, the last over a torch
threefry2x32 that reproduces ``jax.random``'s keys and ``randint``).

A sampler is a stateless object; its state rides in
``DenseState.delay_state`` as a tuple of tensors with a leading lane axis
``[B]``. Every draw is a pure function of that state, so the port
reproduces the JAX stream bit for bit. ``host_dtypes`` names the numpy
dtype of each state word in the JAX package (``utils/carry.py`` converts).

Position streams: a sampler whose draw value depends only on its stream
position (``position_streams = True``: hash, fixed) also serves a block of
draws at ``current + offsets`` out of order (``block_receive_times``) and
skips the stream past them (``advance_draws``), which is what the exact
tick's marker broadcast uses. The Go-exact and threefry streams are
order-dependent (each draw splits the key the next one splits again) and
draw one at a time.

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


# ---- threefry2x32 and the jax.random key functions -------------------------
# The JAX package's reference is jax.random with its default
# jax_threefry_partitionable=True and 64-bit seeds (jax_enable_x64, as its
# tests run): a key is two uint32 words; ``split`` and ``random_bits``
# address the counter pairs (hi, lo) of a 64-bit iota over the output
# shape (jax/_src/prng.py iota_2x32_shape, _threefry_split_foldlike,
# _threefry_random_bits_partitionable); ``fold_in`` hashes the counter
# pair (0, data) (threefry_fold_in). Words are int64 tensors in [0, 2^32).

_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _i32(x) -> torch.Tensor:
    """uint32 words (int64 in [0, 2^32), or a Python int) as int32 bit
    patterns."""
    if not torch.is_tensor(x):
        return torch.tensor(x - (1 << 32) if x >= 1 << 31 else x,
                            dtype=torch.int32)
    return x.to(torch.int32)


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) of key ``(k1, k2)`` on the
    counter pair ``(x1, x2)``, every argument broadcast against the
    others; returns the two output words (jax/_src/prng.py
    ``_threefry2x32_lowering``). The rounds run on int32 bit patterns,
    whose adds wrap at 2^32 as uint32's do and take half the bytes of
    the int64 words; a logical right shift masks off the sign's
    copies."""
    k1, k2 = _i32(k1), _i32(k2)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = _i32(x1) + ks[0]
    x1 = _i32(x2) + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << r) | ((x1 >> (32 - r)) & ((1 << r) - 1))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + (ks[(i + 2) % 3] + (i + 1))
    return x0.to(torch.int64) & _M32, x1.to(torch.int64) & _M32


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: [2] words, the seed's high and low 32
    bits (two's complement for a negative seed)."""
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=device)


def _iota(count: int, like: torch.Tensor) -> torch.Tensor:
    """The low words of a 64-bit iota of ``count`` elements (the high
    words are 0 below 2^32 elements)."""
    if count >= 1 << 32:
        raise ValueError("threefry: 2^32 or more counters in one call")
    return torch.arange(count, dtype=torch.int64, device=like.device)


def key_split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for keys ``[..., 2]``: [..., num, 2],
    key i the block of counter (0, i)."""
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], 0, _iota(num, key))
    return torch.stack([b1, b2], dim=-1)


def key_fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for keys ``[..., 2]`` and uint32
    ``data`` broadcast against the key's lead axes."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & _M32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits``: [..., *shape] words of keys [..., 2],
    element i the xor of the block of counter (0, i), row-major."""
    shape = _shape(shape)
    count = int(np.prod(shape, dtype=np.int64))
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], 0,
                          _iota(count, key))
    return (b1 ^ b2).reshape(key.shape[:-1] + shape)


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 ``jax.random.randint(key, shape, minval, maxval)`` for keys
    [..., 2]: the key splits in two, each gives 32 random bits per
    element, and the pair is folded into the span as
    ``(hi % span * m + lo % span) % span``, ``m = (2^16 % span)^2 %
    span``, every product and sum wrapping at 2^32 as uint32 arithmetic
    does (jax/_src/random.py ``_randint``); int32 bounds, so the span is
    below 2^32."""
    minval, maxval = int(minval), int(maxval)
    span = maxval - minval if maxval > minval else 1
    halves = key_split(key)
    hi = random_bits(halves[..., 0, :], shape)
    lo = random_bits(halves[..., 1, :], shape)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    off = (off & _M32) % span
    return (off + minval).to(torch.int32)


class UniformDelay:
    """Uniform delay in {1..max_delay} from the threefry stream of
    ``jax.random`` (the JAX ``UniformJaxDelay``): each draw splits the
    lane's key, keeps the first half and draws ``randint(second, 0,
    max_delay)``; ``draw_many`` splits once and draws the whole shape.
    State is ``(key,)``, key [B, 2] words; a lane's key is
    ``fold_in(PRNGKey(seed), lane)`` (``init_batch_state``), a single
    instance's ``PRNGKey(seed)`` (``init_state``, what ``DenseSim``
    seeds). On the host the state is one uint32 [..., 2] leaf
    (``bare_leaf``), not a tuple, as in the JAX tree."""

    position_streams = False   # a draw's key depends on every split before
    host_dtypes = ("uint32",)
    bare_leaf = True

    def __init__(self, seed: int, max_delay: int = MAX_DELAY):
        if not 0 < max_delay < 1 << 31:
            raise ValueError(f"max_delay must be in [1, 2^31), got "
                             f"{max_delay}")
        self.seed = seed
        self.max_delay = max_delay

    def init_state(self, device="cuda"):
        """One lane's state: ``PRNGKey(seed)``."""
        return (prng_key(self.seed, device).unsqueeze(0),)

    def init_batch_state(self, batch: int, device="cuda"):
        lane = torch.arange(batch, dtype=torch.int64, device=device)
        return (key_fold_in(prng_key(self.seed, device).expand(batch, 2),
                            lane),)

    def draw(self, dstate, time):
        keys = key_split(dstate[0])
        d = randint(keys[..., 1, :], (), 0, self.max_delay)
        return time + 1 + d, (keys[..., 0, :].contiguous(),)

    def draw_many(self, dstate, time, shape):
        """Receive times of shape ``time.shape + shape``."""
        shape = _shape(shape)
        keys = key_split(dstate[0])
        d = randint(keys[..., 1, :], shape, 0, self.max_delay)
        return (time.reshape(time.shape + (1,) * len(shape)) + 1 + d,
                (keys[..., 0, :].contiguous(),))

    def draw_run(self, dstate, time, counts, width: int):
        """``counts[b]`` draws one after another on lane b (``width`` >=
        every count): [B, width] receive times (0 past a lane's count) and
        the state after them, equal to ``counts[b]`` calls of ``draw``.
        The key chain is split ``width`` times in turn; the draws off its
        second halves are one ``randint`` over [B, width]."""
        key = dstate[0]
        chain, subs = [key], []
        for _ in range(width):
            halves = key_split(chain[-1])
            chain.append(halves[..., 0, :])
            subs.append(halves[..., 1, :])
        d = randint(torch.stack(subs, dim=-2), (), 0, self.max_delay)
        ks = torch.stack(chain, dim=-2)                      # [B, W+1, 2]
        end = torch.gather(ks, -2, counts.long().reshape(-1, 1, 1)
                           .expand(-1, 1, 2)).squeeze(-2)
        live = torch.arange(width, device=key.device) < counts.unsqueeze(-1)
        rts = torch.where(live, time.unsqueeze(-1) + 1 + d, 0)
        return rts, (end.contiguous(),)


def select_words(mask, new, old):
    """Per-lane ``where(mask, new, old)`` over a sampler state's words
    (mask ``[B]``)."""
    return tuple(torch.where(_lane_cols(mask, a), a, b)
                 for a, b in zip(new, old))


def make_fast_delay(name: str, seed: int, max_delay: int = MAX_DELAY):
    """The CLI and bench ``--delay`` choices: "uniform" (threefry) or
    "hash" (the counter hash)."""
    if name == "uniform":
        return UniformDelay(seed, max_delay)
    if name == "hash":
        return HashDelay(seed, max_delay)
    raise ValueError(f"unknown fast delay sampler {name!r}")
