"""The port's delay samplers against the JAX package's streams.

``HashDelay``/``FixedDelay`` (chandy_lamport_tpu_torch/ops/delay.py)
against ``HashJaxDelay``/``FixedJaxDelay``: per-lane state, 10k
sequential draws, 10k-element bulk draws and position-addressed block
draws, with lanes whose counter starts at 2^32 - 5 so draws straddle the
counter wrap (the epoch rule). ``GoExactDelay`` against
``GoExactJaxDelay`` and the host ``GoRand`` from the reference seed, and
its 64-bit wrapping add against Python integers. Tolerance: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from chandy_lamport_tpu.config import REFERENCE_TEST_SEED
from chandy_lamport_tpu.ops.delay_jax import (
    FixedJaxDelay,
    GoExactJaxDelay,
    HashJaxDelay,
)
from chandy_lamport_tpu.ops import gorand as j_gorand
from chandy_lamport_tpu.ops.gorand import GoRand
from chandy_lamport_tpu_torch.ops import gorand as t_gorand
from chandy_lamport_tpu_torch.ops.delay import (
    FixedDelay,
    GoExactDelay,
    HashDelay,
    _add64,
)

LANES = 100
NEAR_WRAP = 2**32 - 5


def _u32(words):
    return tuple(np.asarray(w).astype(np.uint32) for w in words)


def _to_torch(words):
    return tuple(torch.from_numpy(np.asarray(w).astype(np.int64))
                 for w in words)


def _from_torch(words):
    return tuple(w.numpy().astype(np.uint32) for w in words)


def _start_state(jd, seed_ctr):
    """Batched JAX state with some counters parked just below the wrap."""
    key, ctr, epoch = jd.init_batch_state(LANES)
    ctr = np.asarray(ctr).copy()
    ctr[::3] = NEAR_WRAP
    ctr[1::7] = seed_ctr
    return (np.asarray(key), ctr, np.asarray(epoch))


@pytest.mark.parametrize("seed", [17, -3, 2**40 + 5])
def test_hash_init_batch_state(seed):
    jd, td = HashJaxDelay(seed), HashDelay(seed)
    ref = jd.init_batch_state(LANES)
    got = td.init_batch_state(LANES, device="cpu")
    for r, g in zip(_u32(ref), _from_torch(got)):
        assert r.dtype == g.dtype
        np.testing.assert_array_equal(r, g)
    # lane 0 carries the single-instance stream's key
    assert _u32(jd.init_state())[0] == _from_torch(got)[0][0]


def test_hash_sequential_draws_cross_the_wrap():
    """100 lanes x 100 sequential draws = 10k draws; a third of the lanes
    cross the counter wrap (epoch 0 -> 1) after five draws."""
    jd, td = HashJaxDelay(29), HashDelay(29)
    start = _start_state(jd, 12345)
    time0 = np.arange(LANES, dtype=np.int32) * 3

    def lane(dstate, t):
        def step(d, _):
            rt, d = jd.draw(d, t)
            return d, rt
        return lax.scan(step, dstate, None, length=100)

    ref_state, ref_rts = jax.vmap(lane)(
        tuple(jnp.asarray(w, jnp.uint32) for w in start), time0)
    state, rts = _to_torch(start), []
    t = torch.from_numpy(time0)
    for _ in range(100):
        rt, state = td.draw(state, t)
        rts.append(rt)
    got = torch.stack(rts, dim=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref_rts), got.numpy())
    for r, g in zip(_u32(ref_state), _from_torch(state)):
        np.testing.assert_array_equal(r, g)
    assert _from_torch(state)[2][0] == 1          # lane 0 crossed the wrap


@pytest.mark.parametrize("shape", [10_000, (4, 2_500)])
def test_hash_draw_many_straddles_the_wrap(shape):
    """Bulk draws of 10k elements per lane: lanes starting at 2^32 - 5
    take the post-wrap epoch from their sixth element on."""
    jd, td = HashJaxDelay(7), HashDelay(7)
    start = _start_state(jd, 99)
    time0 = np.arange(LANES, dtype=np.int32)
    ref_rts, ref_state = jax.vmap(lambda d, t: jd.draw_many(d, t, shape))(
        tuple(jnp.asarray(w, jnp.uint32) for w in start), time0)
    rts, state = td.draw_many(_to_torch(start), torch.from_numpy(time0),
                              shape)
    assert rts.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref_rts), rts.numpy())
    for r, g in zip(_u32(ref_state), _from_torch(state)):
        np.testing.assert_array_equal(r, g)


def test_fixed_delay_matches():
    jd, td = FixedJaxDelay(3), FixedDelay(3)
    assert td.init_batch_state(LANES, device="cpu") == () == tuple(
        jd.init_batch_state(LANES))
    time0 = np.arange(LANES, dtype=np.int32)
    ref, _ = jax.vmap(lambda t: jd.draw_many((), t, (4, 2_500)))(time0)
    got, state = td.draw_many((), torch.from_numpy(time0), (4, 2_500))
    assert state == () and got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    rt, _ = td.draw((), torch.from_numpy(time0))
    np.testing.assert_array_equal(np.asarray(jax.vmap(
        lambda t: jd.draw((), t)[0])(time0)), rt.numpy())


def _offsets(rng, d=9):
    """[LANES, d] block offsets: each lane's row ranks (a prefix of real
    links), shuffled so positions are served out of order."""
    off = np.tile(np.arange(d, dtype=np.int32), (LANES, 1))
    return rng.permuted(off, axis=1)


def test_hash_block_draws_straddle_the_wrap():
    """block_receive_times at ``counter + offsets`` equals sequential
    draws in offset order, and advance_draws lands on the sequential
    state, for lanes whose 9-draw block crosses the counter wrap."""
    jd, td = HashJaxDelay(41), HashDelay(41)
    start = _start_state(jd, 777)
    time0 = np.arange(LANES, dtype=np.int32) + 5
    off = _offsets(np.random.default_rng(9))
    count = np.random.default_rng(10).integers(0, 10, LANES).astype(
        np.int32)
    jstate = tuple(jnp.asarray(w, jnp.uint32) for w in start)
    ref_rts = jax.vmap(jd.block_receive_times)(jstate, time0, off)
    ref_state = jax.vmap(jd.advance_draws)(jstate, count)
    got = td.block_receive_times(_to_torch(start), torch.from_numpy(time0),
                                 torch.from_numpy(off))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref_rts), got.numpy())
    state = td.advance_draws(_to_torch(start), torch.from_numpy(count))
    for r, g in zip(_u32(ref_state), _from_torch(state)):
        np.testing.assert_array_equal(r, g)
    # the block is the sequential stream, served out of order
    seq, _ = td.draw_many(_to_torch(start), torch.from_numpy(time0), 9)
    np.testing.assert_array_equal(
        np.take_along_axis(seq.numpy(), off.astype(np.int64), axis=1),
        got.numpy())
    assert (_from_torch(state)[2][::3] > 0).any()     # a wrap happened


def test_fixed_block_draws_match():
    jd, td = FixedJaxDelay(2), FixedDelay(2)
    time0 = np.arange(LANES, dtype=np.int32)
    off = _offsets(np.random.default_rng(11))
    ref = jax.vmap(lambda t, o: jd.block_receive_times((), t, o))(time0, off)
    got = td.block_receive_times((), torch.from_numpy(time0),
                                 torch.from_numpy(off))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert td.advance_draws((), torch.zeros(LANES, dtype=torch.int32)) == ()


def test_go_exact_matches_jax_and_host():
    """10k draws from the reference seed (REFERENCE_TEST_SEED + 1) on 3
    lanes sharing the stream: equal to the JAX Go stream and to the host
    generator draw for draw, and the final (vec, tap, feed) equal to the
    JAX state (uint64 words carried bit for bit in int64)."""
    seed, n = REFERENCE_TEST_SEED + 1, 10_000
    jd, td = GoExactJaxDelay(seed), GoExactDelay(seed)
    host = GoRand(seed)
    want = np.array([1 + host.intn(5) for _ in range(n)], np.int32)

    def lane(dstate):
        def step(d, _):
            rt, d = jd.draw(d, jnp.int32(0))
            return d, rt
        return lax.scan(step, dstate, None, length=n)

    ref_state, ref_rts = jax.jit(lane)(jd.init_state())
    np.testing.assert_array_equal(np.asarray(ref_rts), want)
    state = td.init_batch_state(3, device="cpu")
    vec0 = state[0][0].numpy().view(np.uint64)
    np.testing.assert_array_equal(vec0, np.asarray(jd.init_state()[0]))
    rts, t0 = [], torch.zeros(3, dtype=torch.int32)
    for _ in range(n):
        rt, state = td.draw(state, t0)
        rts.append(rt)
    got = torch.stack(rts, dim=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.tile(want, (3, 1)))
    vec, tap, feed = state
    for lane_i in range(3):
        np.testing.assert_array_equal(vec[lane_i].numpy().view(np.uint64),
                                      np.asarray(ref_state[0]))
    assert tap.dtype == feed.dtype == torch.int32
    assert tap.tolist() == [int(ref_state[1])] * 3
    assert feed.tolist() == [int(ref_state[2])] * 3
    # the port reads its own copy of the table, byte-identical
    with open(t_gorand.COOKED_PATH, "rb") as mine, \
            open(j_gorand._COOKED_PATH, "rb") as theirs:
        assert mine.read() == theirs.read()


def test_go_exact_rejection_redraws_only_rejected_lanes():
    """Intn(5) rejects Int31 values above 2^31 - 4 (probability 3/2^31,
    so no seeded stream shows it): lane 0's state is set up so its first
    Uint64 is rejected and redrawn, lane 1's is left as seeded. Each lane
    follows the host generator with the same state draw for draw."""
    seed = REFERENCE_TEST_SEED + 1
    td = GoExactDelay(seed)
    hosts = [GoRand(seed), GoRand(seed)]
    # the first Uint64 reads vec[333] + vec[606]; make it 0x7fffffff << 32
    vec = hosts[0]._vec
    vec[606] = ((0x7FFFFFFF << 32) - vec[333]) % 2**64
    state = td.init_batch_state(2, device="cpu")
    words = state[0].clone()
    words[0] = torch.from_numpy(np.array(vec, np.uint64).view(np.int64))
    state = (words, state[1], state[2])
    t0 = torch.zeros(2, dtype=torch.int32)
    for _ in range(50):
        rt, state = td.draw(state, t0)
        assert rt.tolist() == [1 + h.intn(5) for h in hosts]
    for lane, host in enumerate(hosts):
        vec, tap, feed = host.state_arrays()
        np.testing.assert_array_equal(
            state[0][lane].numpy().view(np.uint64), vec)
        assert (int(state[1][lane]), int(state[2][lane])) == (tap, feed)
    assert int(state[2][0]) != int(state[2][1])   # lane 0 drew once more


def test_add64_wraps_like_uint64():
    """The Go recurrence's ``vec[feed] += vec[tap]`` mod 2^64, on words
    with the top bit set (the seeded table holds many) and on random
    pairs, against Python integers."""
    cooked = np.load(t_gorand.COOKED_PATH)
    top = cooked[cooked >= np.uint64(2**63)]
    assert len(top) > 100
    rng = np.random.default_rng(12)
    a = np.concatenate([top, rng.integers(0, 2**64, 5000, dtype=np.uint64),
                        np.array([2**64 - 1, 2**63, 0], np.uint64)])
    b = np.concatenate([top[::-1], rng.integers(0, 2**64, 5000,
                                                dtype=np.uint64),
                        np.array([1, 2**63, 0], np.uint64)])
    got = _add64(torch.from_numpy(a.view(np.int64)),
                 torch.from_numpy(b.view(np.int64)))
    want = [(int(x) + int(y)) % 2**64 for x, y in zip(a, b)]
    assert got.numpy().view(np.uint64).tolist() == want
