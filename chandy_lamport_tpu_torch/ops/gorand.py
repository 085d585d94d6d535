"""Bit-exact reimplementation of Go's legacy ``math/rand`` generator, on
the host (a copy of the JAX package's ``ops/gorand.py``).

The reference's only randomness is ``rand.Intn(5)`` draws from Go's global
PRNG seeded once per test (reference sim.go:100-102, snapshot_test.go:20).
Reproducing the 21 golden fixtures therefore requires this generator exactly:

  - ``rngSource``: 607-lag / 273-tap additive lagged-Fibonacci over Z/2^64;
    Uint64: tap--, feed-- (mod 607), vec[feed] += vec[tap], return vec[feed].
  - ``Seed``: Schrage-LCG chain (A=48271, Q=44488, R=3399, M=2^31-1), seed
    reduced mod M (0 -> 89482311), 20 warm-up draws, then per slot three
    draws packed ``x<<s1 ^ x<<s2 ^ x`` XORed with the 607-entry ``rngCooked``
    table.
  - ``Int63 = Uint64 & (2^63-1)``; ``Int31 = Int63 >> 32``; ``Int31n(n)``
    rejection-samples (reject v > 2^31-1 - 2^31%n) then ``v % n``;
    ``Intn(n) = Int31n(n)`` for n < 2^31.

``rngCooked`` is generated data, validated against the golden fixtures;
the port carries its own copy of the table at
``chandy_lamport_tpu_torch/data/gorand_cooked.npy`` (607 uint64 words).
The device-side stream (``ops/delay.GoExactDelay``) starts from the state
this class exports.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

LEN = 607
_TAP = 273
_FEED0 = LEN - _TAP  # 334
_MASK64 = (1 << 64) - 1
_MASK63 = (1 << 63) - 1
_A, _M, _Q, _R = 48271, (1 << 31) - 1, 44488, 3399

COOKED_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                           "gorand_cooked.npy")
_cooked_cache: Optional[Tuple[int, ...]] = None


def load_cooked_table() -> Tuple[int, ...]:
    """The golden-validated rngCooked table as python ints."""
    global _cooked_cache
    if _cooked_cache is None:
        _cooked_cache = tuple(int(x) for x in np.load(COOKED_PATH))
    return _cooked_cache


def seedrand(x: int) -> int:
    """One Lehmer LCG step via Schrage's trick (x' = 48271*x mod 2^31-1)."""
    hi, lo = divmod(x, _Q)
    x = _A * lo - _R * hi
    if x < 0:
        x += _M
    return x


class GoRand:
    """Stateful generator matching Go ``math/rand`` bit for bit."""

    def __init__(self, seed: int):
        self._cooked = load_cooked_table()
        self._vec = [0] * LEN
        self._tap = 0
        self._feed = _FEED0
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self._tap = 0
        self._feed = _FEED0
        # Go truncates then adds _M if negative; python floor-mod lands on the
        # same representative in [0, _M) directly.
        seed %= _M
        if seed == 0:
            seed = 89482311
        x = seed
        for i in range(-20, LEN):
            x = seedrand(x)
            if i >= 0:
                u = (x << 40) & _MASK64
                x = seedrand(x)
                u ^= (x << 20) & _MASK64
                x = seedrand(x)
                u ^= x
                u ^= self._cooked[i]
                self._vec[i] = u

    def uint64(self) -> int:
        self._tap = (self._tap - 1) % LEN
        self._feed = (self._feed - 1) % LEN
        x = (self._vec[self._feed] + self._vec[self._tap]) & _MASK64
        self._vec[self._feed] = x
        return x

    def int63(self) -> int:
        return self.uint64() & _MASK63

    def int31(self) -> int:
        return self.int63() >> 32

    def int31n(self, n: int) -> int:
        if n <= 0:
            raise ValueError("invalid argument to int31n")
        if n & (n - 1) == 0:
            return self.int31() & (n - 1)
        vmax = (1 << 31) - 1 - (1 << 31) % n
        v = self.int31()
        while v > vmax:
            v = self.int31()
        return v % n

    def intn(self, n: int) -> int:
        if not 0 < n < 1 << 31:
            raise ValueError(f"intn requires 0 < n < 2^31, got {n}")
        return self.int31n(n)

    def state_arrays(self) -> Tuple[np.ndarray, int, int]:
        """(vec uint64 [607], tap, feed): the seeded state the device
        stream starts from."""
        return np.array(self._vec, dtype=np.uint64), self._tap, self._feed
