"""uint16 window planes (``SimConfig.window_dtype="uint16"``, ROADMAP A7)
in the port against the JAX package, on the CPU.

The port holds the modular window counters as int16 tensors carrying the
uint16 bits (PyTorch's uint16 has no subtraction or ``index_put_``); on
the host, in checkpoints and in the state signature they are uint16, as
in JAX. The cases of the JAX ``tests/test_window_dtype.py`` (:30, :39,
:64, :83, :107) run on the port against the JAX package: the config's
check, a sync storm equal to the JAX uint16 storm leaf for leaf and to
the int32 run window for window, the exact scheduler through ``DenseSim``
equal to the JAX one (and its snapshots to the parity backend's), the
checkpoint round trip, and a window straddling the 2^16 wrap decoded as
an absolute counter would. Also: exact storms past the wrap on the
device-side planes, checkpoints crossing both ways, the counters line,
and the memo signature equal to the JAX one with uint16 leaves.
Tolerance: none (integer work).
"""

import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.api import run_events
from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.state import DenseState as JaxDenseState
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.delay import GoExactDelay as HostGoExact
from chandy_lamport_tpu.ops.delay_jax import FixedJaxDelay, HashJaxDelay
from chandy_lamport_tpu.parallel import batch as jax_batch
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu.utils import checkpoint as jax_ck
from chandy_lamport_tpu.utils.metrics import progress_counters as jax_pc
from chandy_lamport_tpu.utils.randgen import (
    random_script,
    random_strongly_connected,
)
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.dense import DenseSim
from chandy_lamport_tpu_torch.core.state import recorded_window
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.delay import (
    FixedDelay,
    GoExactDelay,
    HashDelay,
)
from chandy_lamport_tpu_torch.parallel.batch import (
    BatchedRunner,
    _lane_signature,
)
from chandy_lamport_tpu_torch.utils.carry import (
    state_from_numpy,
    state_to_numpy,
)
from chandy_lamport_tpu_torch.utils.checkpoint import load_state, save_state
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec
from chandy_lamport_tpu_torch.utils.metrics import progress_counters

W16 = dict(queue_capacity=32, max_recorded=32, max_snapshots=8)


def _assert_leaves_equal(want, got):
    for field in want._fields:
        xs = jax.tree_util.tree_leaves(getattr(want, field))
        ys = jax.tree_util.tree_leaves(getattr(got, field))
        assert len(xs) == len(ys), field
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (field, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=field)


def _lane(host, b):
    return type(host)(*(tuple(w[b] for w in leaf) if isinstance(leaf, tuple)
                        else leaf[b] for leaf in host))


def test_config_rejects_bad_log_capacity():
    """(:30) uint16 windows need a power-of-two log of at most 2^15
    slots, with the JAX message; ``for_workload`` derives one."""
    for bad in (48, 65536):
        with pytest.raises(ValueError, match="power of two"):
            SimConfig(window_dtype="uint16", max_recorded=bad)
        with pytest.raises(ValueError, match="power of two"):
            JaxSimConfig(window_dtype="uint16", max_recorded=bad)
    SimConfig(window_dtype="uint16", max_recorded=64)
    for snaps in (3, 9, 20):
        assert (SimConfig.for_workload(snapshots=snaps,
                                       window_dtype="uint16").max_recorded
                == JaxSimConfig.for_workload(
                    snapshots=snaps, window_dtype="uint16").max_recorded)


@pytest.mark.parametrize("scheduler, megatick", [("sync", 1), ("exact", 4)])
def test_uint16_storm_equals_jax_and_int32(scheduler, megatick):
    """(:39) A storm at uint16 (ER-24, B=2): every leaf equal to the JAX
    uint16 run (the planes uint16 on the host), the counters line equal
    to the JAX one, and every recorded window decodes as the int32 run's
    does."""
    kw = dict(scheduler=scheduler, megatick=megatick)
    finals = {}
    for wd in ("int32", "uint16"):
        pr = BatchedRunner(workloads.erdos_renyi(24, 2.5, 6, tokens=80),
                           SimConfig(window_dtype=wd, **W16), FixedDelay(2),
                           2, device="cpu", **kw)
        prog = workloads.storm_program(pr.topo, 10, 1, workloads.
                                       staggered_snapshots(pr.topo, 3))
        finals[wd] = pr.run_storm(pr.init_batch_device(), prog)
        assert int(finals[wd].error.max()) == 0
    jr = JaxRunner(jax_workloads.erdos_renyi(24, 2.5, 6, tokens=80),
                   JaxSimConfig(window_dtype="uint16", **W16),
                   FixedJaxDelay(2), 2, **kw)
    want = jax.device_get(jr.run_storm(jr.init_batch(), prog))
    narrow = state_to_numpy(finals["uint16"], pr.delay)
    assert narrow.rec_start.dtype == np.uint16
    _assert_leaves_equal(want, narrow)
    got = {k: int(v) for k, v in progress_counters(
        finals["uint16"], pr.config, pr.topo.n).items()}
    assert got == {k: int(v) for k, v in jax_pc(want, jr.config,
                                                 pr.topo.n).items()}
    wide = state_to_numpy(finals["int32"], pr.delay)
    for b in range(2):
        a, n = _lane(wide, b), _lane(narrow, b)
        for sid in range(int(a.next_sid)):
            for e in range(pr.topo.e):
                assert recorded_window(a, sid, e) == \
                    recorded_window(n, sid, e), (b, sid, e)


@pytest.mark.parametrize("case_seed", [0, 1])
def test_uint16_exact_scheduler_vs_jax_and_parity(case_seed):
    """(:64) A random script through the port's ``DenseSim`` at uint16
    windows: the same snapshots and balances as the JAX parity backend
    and every leaf of the JAX ``DenseSim``'s state."""
    rng = random.Random(7700 + case_seed)
    topo = random_strongly_connected(rng, rng.randrange(3, 10))
    events = random_script(rng, topo, rng.randrange(12, 35))
    jcfg = JaxSimConfig(queue_capacity=64, max_recorded=64,
                        window_dtype="uint16")
    p_snaps, p_sim = run_events("parity", topo, events,
                                HostGoExact(55 + case_seed))
    d_snaps, d_sim = run_events("jax", topo, events,
                                HostGoExact(55 + case_seed), jcfg)
    from test_torch_stream_exact import _port_job

    sim = DenseSim(TopologySpec(list(topo.nodes), list(topo.links)),
                   GoExactDelay(55 + case_seed),
                   SimConfig(queue_capacity=64, max_recorded=64,
                             window_dtype="uint16"), device="cpu")
    snaps = sim.run_events(_port_job(events))
    assert sim.node_tokens() == p_sim.node_tokens()
    assert [(s.token_map, [repr(m) for m in s.messages]) for s in snaps] \
        == [(s.token_map, [repr(m) for m in s.messages]) for s in p_snaps]
    _assert_leaves_equal(jax.device_get(d_sim.state), sim.host_state())
    assert len(d_snaps) == len(snaps)


def _exact_wrap_runner(wd):
    return BatchedRunner(workloads.erdos_renyi(16, 3.0, 2, tokens=60),
                         SimConfig(window_dtype=wd, **W16), HashDelay(3),
                         3, device="cpu", megatick=4)


def test_exact_storm_past_the_wrap():
    """An exact storm from counters 3 below 2^16, at megatick 4: the port
    at uint16 equals the JAX uint16 run from the same state leaf for leaf,
    and its windows decode as the int32 run's, some of them straddling
    the wrap."""
    ends = {}
    for wd in ("int32", "uint16"):
        pr = _exact_wrap_runner(wd)
        s = pr.init_batch_device()
        s = s._replace(rec_cnt=s.rec_cnt + (2**16 - 3))
        prog = workloads.storm_program(pr.topo, 8, 1, workloads.
                                       staggered_snapshots(pr.topo, 3))
        ends[wd] = (s, pr.run_storm(s, prog))
    start, narrow = ends["uint16"]
    jr = JaxRunner(jax_workloads.erdos_renyi(16, 3.0, 2, tokens=60),
                   JaxSimConfig(window_dtype="uint16", **W16),
                   HashJaxDelay(3), 3, megatick=4)
    jstart = state_to_numpy(start, pr.delay)
    jstart = JaxDenseState(*(tuple(jnp.asarray(w) for w in leaf)
                             if isinstance(leaf, tuple) else jnp.asarray(leaf)
                             for leaf in jstart))
    want = jax.device_get(jr.run_storm(jstart, prog))
    narrow_h = state_to_numpy(narrow, pr.delay)
    _assert_leaves_equal(want, narrow_h)
    wide_h = state_to_numpy(ends["int32"][1], pr.delay)
    wrapped = 0
    for b in range(3):
        a, n = _lane(wide_h, b), _lane(narrow_h, b)
        for sid in range(int(a.next_sid)):
            for e in range(pr.topo.e):
                assert recorded_window(a, sid, e) == \
                    recorded_window(n, sid, e)
                wrapped += int(n.rec_end[sid, e] < n.rec_start[sid, e])
    assert wrapped > 0 and int(narrow.rec_cnt.max()) > 2**16


def test_uint16_checkpoint_crosses_both_ways(tmp_path):
    """(:83) A uint16 sync storm's state saved by the port loads in the
    JAX package and back: every leaf equal, the planes uint16 in the file
    and after each load."""
    pr = BatchedRunner(workloads.erdos_renyi(12, 2.5, 2, tokens=40),
                       SimConfig(queue_capacity=16, max_recorded=32,
                                 max_snapshots=4, window_dtype="uint16"),
                       FixedDelay(2), 2, scheduler="sync", device="cpu")
    prog = workloads.storm_program(pr.topo, 6, 1, workloads.
                                   staggered_snapshots(pr.topo, 2))
    final = pr.run_storm(pr.init_batch_device(), prog)
    jr = JaxRunner(jax_workloads.erdos_renyi(12, 2.5, 2, tokens=40),
                   JaxSimConfig(queue_capacity=16, max_recorded=32,
                                max_snapshots=4, window_dtype="uint16"),
                   FixedJaxDelay(2), 2, scheduler="sync")
    path = str(tmp_path / "port.npz")
    save_state(path, final, {"note": "uint16 windows"}, delay=pr.delay)
    with np.load(path) as z:
        assert any(z[k].dtype == np.uint16 for k in z.files)
    jstate, meta = jax_ck.load_state(path, jr.init_batch())
    assert meta["note"] == "uint16 windows"
    assert np.asarray(jstate.rec_start).dtype == np.uint16
    _assert_leaves_equal(jax.device_get(jstate),
                         state_to_numpy(final, pr.delay))
    back = str(tmp_path / "jax.npz")
    jax_ck.save_state(back, jstate, {"note": "back"})
    got, meta = load_state(back, pr.init_batch_device(), delay=pr.delay)
    assert meta["note"] == "back" and got.rec_start.dtype == torch.int16
    _assert_leaves_equal(state_to_numpy(final, pr.delay),
                         state_to_numpy(got, pr.delay))


def test_recorded_window_decodes_across_uint16_wrap():
    """(:107) A window straddling the 2^16 counter wrap decodes the same
    arrivals an absolute counter would, through the port's
    ``recorded_window`` as through the JAX one; a live window ends at the
    int32 counter."""
    from chandy_lamport_tpu.core.state import recorded_window as jax_rw

    L, true_start, length = 16, 65533, 5
    amounts = [7, 11, 13, 17, 19]
    log = np.zeros((L, 1), np.int32)
    for k, amt in enumerate(amounts):
        log[(true_start + k) % L, 0] = amt
    host = SimpleNamespace(
        log_amt=log,
        rec_cnt=np.array([true_start + length], np.int32),
        recording=np.array([[False]]),
        rec_start=np.array([[true_start & 0xFFFF]], np.uint16),
        rec_end=np.array([[(true_start + length) & 0xFFFF]], np.uint16))
    assert int(host.rec_end[0, 0]) < int(host.rec_start[0, 0])
    assert recorded_window(host, 0, 0) == amounts == jax_rw(host, 0, 0)
    host.recording[0, 0] = True
    assert recorded_window(host, 0, 0) == amounts == jax_rw(host, 0, 0)


def test_signature_hashes_uint16_windows_as_jax():
    """The memo signature of a uint16 state (windows past 2^15, whose
    int16 bits are negative) equals the JAX ``_lane_signature`` vmapped
    over the lanes: the planes zero-extend as jnp's astype(uint32)."""
    pr = _exact_wrap_runner("uint16")
    s = pr.init_batch_device()
    s = s._replace(rec_cnt=s.rec_cnt + 40000)
    prog = workloads.storm_program(pr.topo, 6, 1, workloads.
                                   staggered_snapshots(pr.topo, 2))
    s = pr.run_storm(s, prog, drain=False)
    assert bool((s.rec_start < 0).any())
    host = state_to_numpy(s, pr.delay)
    jstate = JaxDenseState(*(tuple(jnp.asarray(w) for w in leaf)
                             if isinstance(leaf, tuple) else jnp.asarray(leaf)
                             for leaf in host))
    want = np.asarray(jax.vmap(jax_batch._lane_signature)(jstate))
    got = _lane_signature(s, pr.delay)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    back = state_from_numpy(host, "cpu")
    assert back.rec_start.dtype == torch.int16
    assert torch.equal(back.rec_start, s.rec_start)
