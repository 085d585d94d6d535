"""Host-side message-delay models (the JAX package's ``models/delay.py``).

The reference's only nondeterminism is the random delivery delay
``receiveTime = time + 1 + rand.Intn(maxDelay)`` drawn from Go's global
PRNG (reference sim.go:100-102). A host model exposes ``receive_time(now)
-> int`` for the parity oracle (core/parity.py) and the sync oracle
(core/syncsim.py); ``ops/delay.from_host_model`` maps one to its device
sampler for ``DenseSim``.

The device samplers live in ``ops/delay.py``; one of them shares a name
with a class here (``ops/delay.GoExactDelay`` is the device twin of
``models/delay.GoExactDelay``), as the JAX package's two modules do not:
there the device twin is ``GoExactJaxDelay``.
"""

from __future__ import annotations

import numpy as np

from chandy_lamport_tpu_torch.config import MAX_DELAY
from chandy_lamport_tpu_torch.ops.gorand import GoRand


class DelayModel:
    def receive_time(self, now: int) -> int:
        raise NotImplementedError


class GoExactDelay(DelayModel):
    """Bit-exact reference delays: now + 1 + GoRand.Intn(max_delay).

    Matches reference sim.go:100-102 with the global PRNG seeded as in
    snapshot_test.go:20 (rand.Seed(seed+1) — the caller passes the already
    incremented seed). The JAX model's ``gorand_kwargs`` (a cooked table
    and seed shifts for its table-search tooling) are not ported: the
    port's ``GoRand`` has the one vendored table."""

    def __init__(self, seed: int, max_delay: int = MAX_DELAY):
        self.seed = seed
        self.rng = GoRand(seed)
        self.max_delay = max_delay

    def receive_time(self, now: int) -> int:
        return now + 1 + self.rng.intn(self.max_delay)


class FixedDelay(DelayModel):
    """Deterministic constant delay — for unit tests and docs examples."""

    def __init__(self, delay: int = 1):
        if delay < 1:
            raise ValueError("delay must be >= 1 (messages are never "
                             "delivered same-tick)")
        self.delay = delay
        self.max_delay = delay

    def receive_time(self, now: int) -> int:
        return now + self.delay


class NumpyUniformDelay(DelayModel):
    """Fast host-side uniform delays in {1..max_delay} — the reference's
    distribution, another stream (numpy's ``default_rng``). Used by
    property tests; it has no device twin."""

    def __init__(self, seed: int, max_delay: int = MAX_DELAY):
        self.rng = np.random.default_rng(seed)
        self.max_delay = max_delay

    def receive_time(self, now: int) -> int:
        return now + 1 + int(self.rng.integers(0, self.max_delay))
