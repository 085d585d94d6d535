"""The threefry ``uniform`` sampler of the port (``ops/delay.UniformDelay``,
ROADMAP A7) against ``jax.random`` and the JAX ``UniformJaxDelay``, on the
CPU.

The port's threefry2x32 is plain integer arithmetic in torch (no jax). Its
keys and draws equal ``jax.random``'s bit for bit (JAX 0.9.0 with its
default ``jax_threefry_partitionable=True`` and 64-bit seeds, as the JAX
package's tests run): ``PRNGKey``, ``split``, ``fold_in`` and ``randint``
over seeds, shapes and spans that are not powers of two, with a
hypothesis case over the whole int32 range of bounds. ``UniformDelay``
equals ``UniformJaxDelay`` draw for draw; sync and exact storms under it
equal the JAX runs leaf for leaf at megatick 1 and 8 (tolerance: none);
``DenseSim`` seeds its one lane with ``PRNGKey(seed)`` as the JAX one
does (not ``fold_in(PRNGKey(seed), 0)``), and the stream's pool takes its
per-job rows from ``init_batch_state(J)``. The wave refuses it, as JAX's
does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.dense import DenseSim as JaxDenseSim
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.ops.delay_jax import UniformJaxDelay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.dense import DenseSim
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops import delay as pd
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils.carry import state_to_numpy

CFG = dict(max_snapshots=4, queue_capacity=24, max_recorded=32)
SEEDS = [0, 17, -1, 2**31 + 5, 2**40 + 7, -(2**40)]


def _assert_leaves_equal(want, got):
    for field in want._fields:
        xs = jax.tree_util.tree_leaves(getattr(want, field))
        ys = jax.tree_util.tree_leaves(getattr(got, field))
        assert len(xs) == len(ys), field
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (field, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=field)


def _eq(want, got):
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax_random(seed):
    """``PRNGKey``, ``split`` (2 and 5 keys, and of a batch of keys) and
    ``fold_in`` (0, 1, 2^32 - 1) equal ``jax.random``'s."""
    key = jax.random.PRNGKey(seed)
    mine = pd.prng_key(seed)
    _eq(key, mine)
    _eq(jax.random.split(key), pd.key_split(mine))
    _eq(jax.random.split(key, 5), pd.key_split(mine, 5))
    for data in (0, 1, 2**32 - 1):
        _eq(jax.random.fold_in(key, data), pd.key_fold_in(mine, data))
    keys = jax.random.split(key, 3)
    _eq(jax.vmap(jax.random.split)(keys), pd.key_split(torch.from_numpy(
        np.asarray(keys).astype(np.int64))))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(), (3,), (2, 5), (4, 1, 3)])
def test_randint_equals_jax_random(seed, shape):
    """``randint`` over spans that are and are not powers of two, up to
    2^31 - 1 (where the two-word fold wraps at 2^32), and a negative
    lower bound."""
    key = jax.random.PRNGKey(seed)
    mine = pd.prng_key(seed)
    for lo, hi in ((0, 1), (0, 2), (0, 5), (0, 7), (0, 100), (0, 65537),
                   (0, 2**31 - 1), (-9, 4), (3, 3)):
        want = jax.random.randint(key, shape, lo, hi, dtype=jnp.int32)
        got = pd.randint(mine, shape, lo, hi)
        assert got.dtype == torch.int32
        _eq(want, got)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(-(2**63), 2**63 - 1),
       lo=st.integers(-(2**31), 2**31 - 1),
       span=st.integers(1, 2**31 - 1),
       n=st.integers(0, 9))
def test_randint_hypothesis(seed, lo, span, n):
    """Any 64-bit seed, any int32 bounds and shape: the port's randint
    equals ``jax.random.randint``."""
    hi = min(lo + span, 2**31 - 1)
    key = jax.random.PRNGKey(seed)
    want = jax.random.randint(key, (n,), lo, hi, dtype=jnp.int32)
    _eq(want, pd.randint(pd.prng_key(seed), (n,), lo, hi))


@pytest.mark.parametrize("max_delay", [1, 5, 7])
def test_sampler_equals_uniform_jax_delay(max_delay):
    """``init_batch_state``, ``draw`` and ``draw_many`` of ``UniformDelay``
    equal ``UniformJaxDelay``'s over 4 lanes (vmapped), three draws in a
    row; the single instance's state is ``PRNGKey(seed)``."""
    jd, mine = UniformJaxDelay(23, max_delay), pd.UniformDelay(23, max_delay)
    jstate = jd.init_batch_state(4)
    (state,) = mine.init_batch_state(4, "cpu")
    _eq(jstate, state)
    _eq(jd.init_state(), mine.init_state("cpu")[0][0])
    time = np.arange(4, dtype=np.int32) * 3
    jt, pt = jnp.asarray(time), torch.as_tensor(time)
    words = (state,)
    for _ in range(3):
        want, jstate = jax.vmap(jd.draw)(jstate, jt)
        got, words = mine.draw(words, pt)
        _eq(want, got)
        _eq(jstate, words[0])
    want, jstate = jax.vmap(lambda k, t: jd.draw_many(k, t, (3, 5)))(
        jstate, jt)
    got, words = mine.draw_many(words, pt, (3, 5))
    _eq(want, got)
    _eq(jstate, words[0])
    assert pd.make_fast_delay("uniform", 3).__class__ is pd.UniformDelay
    assert not pd.UniformDelay.position_streams


@pytest.mark.parametrize("scheduler, megatick", [
    ("sync", 1), ("exact", 1), ("exact", 8)])
def test_uniform_storm_equals_jax(scheduler, megatick):
    """A storm under the threefry sampler (ER-12, B=3) through both
    packages: every leaf equal, the lanes' keys included; the exact
    scheduler's broadcasts draw one at a time."""
    jr = JaxRunner(jax_workloads.erdos_renyi(12, 2.5, 3, tokens=30),
                   JaxSimConfig(**CFG), UniformJaxDelay(5), 3,
                   scheduler=scheduler, megatick=megatick)
    pr = BatchedRunner(workloads.erdos_renyi(12, 2.5, 3, tokens=30),
                       SimConfig(**CFG), pd.UniformDelay(5), 3,
                       scheduler=scheduler, megatick=megatick, device="cpu")
    prog = workloads.storm_program(pr.topo, 6, 1, workloads.
                                   staggered_snapshots(pr.topo, 3, 1, 2,
                                                       max_phases=6))
    want = jax.device_get(jr.run_storm(jr.init_batch(), prog))
    got = pr.run_storm(pr.init_batch_device(), prog)
    _assert_leaves_equal(want, state_to_numpy(got, pr.delay))
    assert int(got.error.max()) == 0


def test_dense_sim_seeds_prng_key():
    """``DenseSim`` under ``UniformDelay(seed)`` starts from
    ``PRNGKey(seed)`` (the JAX ``init_state``), and a script through both
    ``DenseSim``s ends leaf-equal at megatick 8."""
    jspec = jax_workloads.erdos_renyi(10, 3.0, 3, tokens=40)
    spec = workloads.erdos_renyi(10, 3.0, 3, tokens=40)
    from test_torch_stream_exact import _port_job

    (jev,) = jax_workloads.stream_jobs(jspec, 1, seed=2, base_phases=10,
                                       max_phases=10)
    sim = DenseSim(spec, pd.UniformDelay(41), SimConfig(**CFG),
                   device="cpu")
    _eq(jax.random.PRNGKey(41), sim.state.delay_state[0][0])
    ref = JaxDenseSim(jspec, UniformJaxDelay(41), JaxSimConfig(**CFG))
    want = [str(x) for x in ref.run_events(jev)]
    got = [str(x) for x in sim.run_events(_port_job(jev))]
    assert got == want
    _assert_leaves_equal(jax.device_get(ref.state), sim.host_state())


def test_stream_rows_and_run_equal_jax():
    """``pack_jobs`` gives each job the ``init_batch_state(J)`` row of
    the JAX pool, and an exact ``run_stream`` (ring-8, 6 jobs, B=3) under
    the threefry sampler equals the JAX run: rows, summary, final lanes."""
    from test_torch_stream_exact import _port_job

    jspec = jax_workloads.ring_topology(8)
    jr = JaxRunner(jspec, JaxSimConfig.for_workload(snapshots=4),
                   UniformJaxDelay(11), 3, scheduler="exact")
    pr = BatchedRunner(workloads.ring_topology(8),
                       SimConfig.for_workload(snapshots=4),
                       pd.UniformDelay(11), 3, scheduler="exact",
                       device="cpu")
    jobs = jax_workloads.stream_jobs(jspec, 6, seed=5, base_phases=3,
                                     max_phases=8)
    jpool = jr.pack_jobs(jobs)
    pool = pr.pack_jobs([_port_job(j) for j in jobs])
    _eq(jax.device_get(jpool.delay_state), pool.delay_state[0])
    jstate, jstream = jr.run_stream(jpool, stretch=3, drain_chunk=16)
    pstate, pstream = pr.run_stream(pool, stretch=3, drain_chunk=16)
    assert pr.stream_results(pstream) == jr.stream_results(jstream)
    _assert_leaves_equal(jax.device_get(jstate),
                         state_to_numpy(pstate, pr.delay))


def test_wave_refuses_the_threefry_stream():
    """The wave serves draws by stream position: the threefry chain is
    order-dependent, so it raises ValueError in both packages."""
    with pytest.raises(ValueError, match="position-addressable"):
        BatchedRunner(workloads.ring_topology(4), SimConfig(),
                      pd.UniformDelay(1), 2, exact_impl="wave",
                      device="cpu")
    with pytest.raises(ValueError):
        JaxRunner(jax_workloads.ring_topology(4), JaxSimConfig(),
                  UniformJaxDelay(1), 2, exact_impl="wave")


def test_draw_run_equals_draws():
    """``draw_run`` (the broadcast's chain of splits, its draws in one
    call) equals ``counts[b]`` calls of ``draw`` on lane b, counts 0 to
    the width included: the receive times and the state after them."""
    mine = pd.UniformDelay(8, 7)
    words = mine.init_batch_state(5, "cpu")
    time = torch.tensor([3, 0, 9, 1, 4], dtype=torch.int32)
    counts = torch.tensor([0, 1, 4, 2, 4], dtype=torch.int32)
    rts, after = mine.draw_run(words, time, counts, 4)
    for b in range(5):
        w = tuple(x[b:b + 1] for x in words)
        for k in range(4):
            if k < int(counts[b]):
                rt, w = mine.draw(w, time[b:b + 1])
                assert int(rt[0]) == int(rts[b, k])
            else:
                assert int(rts[b, k]) == 0
        assert torch.equal(w[0][0], after[0][b])


def test_uniform_checkpoint_crosses_both_ways(tmp_path):
    """A storm state under the threefry sampler saved by the port loads in
    the JAX package (its key one bare uint32 [B, 2] leaf, the JAX tree's
    ``treedef``) and back, every leaf equal."""
    from chandy_lamport_tpu.utils import checkpoint as jax_ck
    from chandy_lamport_tpu_torch.utils.checkpoint import (
        load_state,
        save_state,
    )

    pr = BatchedRunner(workloads.ring_topology(6), SimConfig(**CFG),
                       pd.UniformDelay(3), 2, device="cpu")
    jr = JaxRunner(jax_workloads.ring_topology(6), JaxSimConfig(**CFG),
                   UniformJaxDelay(3), 2)
    prog = workloads.storm_program(pr.topo, 4, 1, workloads.
                                   staggered_snapshots(pr.topo, 1))
    final = pr.run_storm(pr.init_batch_device(), prog)
    path = str(tmp_path / "port.npz")
    save_state(path, final, {"k": 1}, delay=pr.delay)
    jstate, meta = jax_ck.load_state(path, jr.init_batch())
    assert meta == {"k": 1}
    assert np.asarray(jstate.delay_state).dtype == np.uint32
    _assert_leaves_equal(jax.device_get(jstate),
                         state_to_numpy(final, pr.delay))
    back = str(tmp_path / "jax.npz")
    jax_ck.save_state(back, jstate, {"k": 2})
    got, _ = load_state(back, pr.init_batch_device(), delay=pr.delay)
    _assert_leaves_equal(state_to_numpy(final, pr.delay),
                         state_to_numpy(got, pr.delay))


def test_restore_from_snapshot_seeds_the_single_instance_key():
    """``restore_from_snapshot`` under the threefry sampler starts the
    rebuilt lane from ``PRNGKey(seed)``, the single instance's stream, as
    ``DenseSim`` does."""
    from chandy_lamport_tpu_torch.utils.checkpoint import (
        restore_from_snapshot,
    )
    from chandy_lamport_tpu_torch.utils.goldens import fixture_path
    from chandy_lamport_tpu_torch.api import run_events_file

    _, sim = run_events_file(fixture_path("3nodes.top"),
                             fixture_path("3nodes-simple.events"),
                             delay_model=pd.UniformDelay(9), device="cpu")
    state = restore_from_snapshot(sim.topo, sim.config, sim.host_state(), 0,
                                  pd.UniformDelay(9), device="cpu")
    _eq(jax.random.PRNGKey(9), state.delay_state[0][0])
    _eq(jax.random.PRNGKey(9), sim.kernel.delay.init_state("cpu")[0][0])
