"""The port's fault adversary, snapshot supervisor and quarantine against
the JAX package's, leaf for leaf.

(a) ``Faults`` against ``JaxFaults``: every mask, the duplicate delay
words, ``down_nodes``/``restarted`` and the per-lane keys, at rates 0, 0.3
and 1.0, times 0, 1, 31, 32 and 2^20 (time 0 hashes ``time - 1 = -1`` and
the window ``-1``), periodic and ``crash_start`` schedules, and a disarmed
(zero) key. (b) The faulted exact storm through the port's
``BatchedRunner(scheduler="exact", faults=..., quarantine=True,
device="cpu")`` against the JAX runner on the seven scenarios of
``tools/chaos_smoke.py`` (batch 4) and an er-16 run of the at-scale fault
program at raised rates: every ``DenseState`` leaf equal — ``fault_key``,
``fault_counts``, ``fault_skew``, the ``snap_*`` leaves, ``stale_markers``,
``error`` and the delay stream included. (c) An armed but idle supervisor
leaves the unsupervised storm as it was, and the ``snapshot_every`` daemon
equals the JAX one. (d) A JAX faulted state carried into the port drains
to the same leaves. (e) What is not ported raises by name. Integer work
throughout: the tolerance is none.
"""

import dataclasses
import functools
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import FixedJaxDelay, HashJaxDelay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu_torch import bench
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.dense import DenseSim
from chandy_lamport_tpu_torch.core.state import (
    ERR_FAULT_UNRECOVERED,
    ERR_SNAPSHOT_TIMEOUT,
)
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import FixedDelay, HashDelay
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils.carry import (
    state_from_numpy,
    state_to_numpy,
)
from chandy_lamport_tpu_torch.utils.metrics import conservation_delta

BATCH = 4

# ---- (a) the fault streams ---------------------------------------------------

RATES = (0.0, 0.3, 1.0)
TIMES = (0, 1, 31, 32, 2**20)


def _programs():
    for rate in RATES:
        yield f"periodic-{rate}", dict(
            drop_rate=rate, dup_rate=rate, jitter_rate=rate,
            crash_rate=rate, marker_drop_rate=rate, marker_dup_rate=rate,
            marker_jitter_rate=rate)
        yield f"window-{rate}", dict(crash_rate=rate, crash_start=1,
                                     crash_len=3, crash_mode="lossy")


@pytest.mark.parametrize("name, kw", list(_programs()),
                         ids=[n for n, _ in _programs()])
def test_fault_streams_match_jax(name, kw):
    jf, tf = JaxFaults(7, **kw), Faults(7, **kw)
    assert tf.describe() == jf.describe() and tf.crashes == jf.crashes
    jkeys = np.asarray(jf.init_batch_state(5))
    tkeys = tf.init_batch_state(5, "cpu")
    np.testing.assert_array_equal(jkeys.astype(np.int64), tkeys.numpy())
    # lane 2 disarmed
    jkeys = jkeys.copy()
    jkeys[2] = 0
    tkeys[2] = 0
    for t in TIMES:
        tt = torch.full((5,), t, dtype=torch.int32)
        for fn, n in (("edge_masks", 11), ("marker_masks", 11),
                      ("down_nodes", 9), ("restarted", 9)):
            ref = jax.vmap(lambda k, f=fn, n=n: getattr(jf, f)(
                k, jnp.int32(t), n))(jnp.asarray(jkeys))
            got = getattr(tf, fn)(tkeys, tt, n)
            ref, got = ((ref,), (got,)) if fn in ("down_nodes",
                                                  "restarted") else (ref,
                                                                     got)
            for r, g in zip(ref, got):
                r, g = np.asarray(r), g.numpy()
                assert r.shape == g.shape, (fn, t)
                np.testing.assert_array_equal(r.astype(g.dtype), g,
                                              err_msg=f"{fn} t={t}")
        # a disarmed lane draws no fault
        assert not any(m[2].any() for m in tf.edge_masks(tkeys, tt, 11)[:3])


def test_fault_streams_fire_at_their_rates():
    """The rates mean something: at 0.3 about 30 % of a large draw fires,
    and rate 1.0 fires on every armed lane only."""
    tf = Faults(1, drop_rate=0.3, jitter_rate=1.0)
    keys = tf.init_batch_state(64, "cpu")
    keys[0] = 0
    drop, _, jit, _ = tf.edge_masks(keys, torch.arange(64, dtype=torch.int32)
                                    , 512)
    assert 0.28 < float(drop[1:].float().mean()) < 0.32
    assert bool(jit[1:].all()) and not bool(jit[0].any())


def test_fault_program_validation():
    with pytest.raises(ValueError, match="drop_rate"):
        Faults(1, drop_rate=1.5)
    with pytest.raises(ValueError, match="crash_mode"):
        Faults(1, crash_mode="halt")
    with pytest.raises(ValueError, match="crash_len"):
        Faults(1, crash_len=4, crash_period=4)


# ---- (b) faulted exact storms against the JAX runner -------------------------

def _graph(pkg, kind):
    if kind == "sf":
        return pkg.scale_free(16, 2, seed=5, tokens=100)
    if kind == "ring":
        return pkg.ring_topology(8, tokens=100)
    return pkg.erdos_renyi(16, 3.0, seed=3, tokens=50)


def _cfg(cls, sup=None, **extra):
    """The chaos smoke's config (``for_workload(snapshots=2,
    max_recorded=128)``) with its supervisor settings."""
    over = {"retry": dict(snapshot_timeout=24, snapshot_retries=10),
            "exhaust": dict(snapshot_timeout=10, snapshot_retries=2),
            None: {}}[sup]
    return cls.for_workload(snapshots=2, max_recorded=128,
                            **{**over, **extra})


# name: (graph, delay, phases, snapshots, fault kwargs, supervisor,
#        expected error bits) — tools/chaos_smoke.py:405-430 at seed 3,
# plus the at-scale program (every class, marker drops rare, pause
# crashes, timeout 64) on er-16 at raised rates
SCENARIOS = {
    "msg-faults": ("sf", "hash", 16, 1, dict(
        drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05), None, 0),
    "crash-pause": ("sf", "hash", 16, 1, dict(
        crash_rate=0.5, crash_mode="pause", crash_period=8, crash_len=2),
        None, 0),
    "crash-lossy-recovered": ("ring", "fixed", 48, 1, dict(
        crash_rate=1.0, crash_mode="lossy", crash_start=30, crash_len=2),
        None, 0),
    "crash-lossy-unrecovered": ("ring", "fixed", 24, 1, dict(
        crash_rate=1.0, crash_mode="lossy", crash_start=5, crash_len=2),
        None, ERR_FAULT_UNRECOVERED),
    "marker-drop-retry": ("ring", "fixed", 24, 1, dict(
        marker_drop_rate=0.1), "retry", 0),
    "marker-dup-storm": ("ring", "fixed", 24, 1, dict(
        marker_dup_rate=0.4), "retry", 0),
    "marker-drop-exhausted": ("ring", "fixed", 16, 1, dict(
        marker_drop_rate=1.0), "exhaust", ERR_SNAPSHOT_TIMEOUT),
    "er16-slice-program": ("er", "hash", 12, 4, dict(
        drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05, crash_rate=0.05,
        crash_mode="pause", marker_drop_rate=0.02, marker_dup_rate=0.05,
        marker_jitter_rate=0.05), dict(snapshot_timeout=16), None),
}


@functools.lru_cache(maxsize=None)
def _pair(name, quarantine=True):
    """The JAX and port runners of one scenario (built once per module:
    the JAX runner's jit caches live on the instance) and the program."""
    kind, delay, phases, snaps, fkw, sup, _ = SCENARIOS[name]
    extra = sup if isinstance(sup, dict) else {}
    sup = None if isinstance(sup, dict) else sup
    if snaps > 2:
        extra = {**extra, "max_snapshots": 8}
    jcfg = _cfg(JaxSimConfig, sup, **extra)
    tcfg = _cfg(SimConfig, sup, **extra)
    jdelay = HashJaxDelay(11) if delay == "hash" else FixedJaxDelay(1)
    tdelay = HashDelay(11) if delay == "hash" else FixedDelay(1)
    jr = JaxRunner(_graph(jax_workloads, kind), jcfg, jdelay, BATCH,
                   scheduler="exact", kernel_engine="xla",
                   faults=JaxFaults(3, **fkw), quarantine=quarantine)
    tr = BatchedRunner(_graph(workloads, kind), tcfg, tdelay, BATCH,
                       scheduler="exact", faults=Faults(3, **fkw),
                       quarantine=quarantine, device="cpu")
    prog = workloads.storm_program(
        tr.topo, phases, 1, workloads.staggered_snapshots(
            tr.topo, snaps, 1, 2, max_phases=phases))
    return jr, tr, prog


def _assert_states_equal(ref, got):
    """Every leaf equal in value, shape and dtype."""
    for name in ref._fields:
        xs = jax.tree_util.tree_leaves(getattr(ref, name))
        ys = jax.tree_util.tree_leaves(getattr(got, name))
        assert len(xs) == len(ys), name
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (name, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_faulted_storm_matches_jax(name):
    """Every leaf equal after the full storm (phases, drain, flush); the
    scenario's fault classes fired; the books balance; only the expected
    bits are set, on quarantined lanes."""
    jr, tr, prog = _pair(name)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got, tr.delay))
    summary = BatchedRunner.summarize(got)
    assert summary == JaxRunner.summarize(jax.device_put(ref))
    assert sum(summary["fault_events"].values()) > 0
    tokens0 = int(tr.topo.tokens0.sum()) * BATCH
    assert int(conservation_delta(got, tr.config, tokens0)) == 0
    want = SCENARIOS[name][-1]
    if want is not None:
        err = got.error.numpy()
        assert not np.any(err & ~want)
        assert bool(np.all(err & want)) == bool(want)


def test_slice_program_fires_every_class_and_retries():
    """The er-16 run of the at-scale program exercises all seven classes
    and the supervisor's retry."""
    jr, tr, prog = _pair("er16-slice-program")
    got = tr.run_storm(tr.init_batch_device(), prog)
    summary = BatchedRunner.summarize(got)
    assert all(v > 0 for v in summary["fault_events"].values()), summary
    assert summary["snapshot_lifecycle"]["retried"] > 0
    assert summary["snapshot_lifecycle"]["stale_markers"] > 0


def test_quarantine_freezes_the_poisoned_lanes():
    """The lossy crash before any snapshot completes poisons every lane
    with ERR_FAULT_UNRECOVERED: with quarantine the lanes stop at their
    poisoning tick; without it they run on. Both equal the JAX runs."""
    for quarantine in (True, False):
        jr, tr, prog = _pair("crash-lossy-unrecovered", quarantine)
        ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
        got = tr.run_storm(tr.init_batch_device(), prog)
        _assert_states_equal(ref, state_to_numpy(got, tr.delay))
        assert bool((got.error & ERR_FAULT_UNRECOVERED).all())
        stopped = int(got.time.max()) < 24
        assert stopped == quarantine


# ---- (c) the supervisor armed but idle, and the daemon -----------------------

def _plain_pair(cfg_kw, faults_kw=None, quarantine=False):
    spec = (jax_workloads.erdos_renyi(16, 3.0, seed=3, tokens=50),
            workloads.erdos_renyi(16, 3.0, seed=3, tokens=50))
    jr = JaxRunner(spec[0], JaxSimConfig(**cfg_kw), HashJaxDelay(5), BATCH,
                   scheduler="exact", kernel_engine="xla",
                   faults=None if faults_kw is None
                   else JaxFaults(9, **faults_kw), quarantine=quarantine)
    tr = BatchedRunner(spec[1], SimConfig(**cfg_kw), HashDelay(5), BATCH,
                       scheduler="exact", device="cpu",
                       faults=None if faults_kw is None
                       else Faults(9, **faults_kw), quarantine=quarantine)
    prog = workloads.storm_program(tr.topo, 10, 1,
                                   workloads.staggered_snapshots(
                                       tr.topo, 3, 1, 2, max_phases=10))
    return jr, tr, prog


BASE = dict(max_snapshots=8, queue_capacity=24, max_recorded=32)


def test_idle_supervisor_is_bit_identical():
    """A deadline far past the run (2^20 ticks) never fires: the storm's
    leaves equal the unsupervised storm's, but for the deadlines and
    initiators the supervisor remembers."""
    _, plain, prog = _plain_pair(BASE)
    _, armed, _ = _plain_pair({**BASE, "snapshot_timeout": 2**20})
    a = state_to_numpy(plain.run_storm(plain.init_batch_device(), prog))
    b = state_to_numpy(armed.run_storm(armed.init_batch_device(), prog))
    own = ("snap_deadline", "snap_initiator")
    _assert_states_equal(a._replace(**{f: 0 for f in own}),
                         b._replace(**{f: 0 for f in own}))
    assert (b.snap_deadline[b.started] > 2**20 - 1).all()


@pytest.mark.parametrize("faulted", [False, True],
                         ids=["unfaulted", "faulted"])
def test_snapshot_daemon_matches_jax(faulted):
    """The snapshot_every daemon (rotating initiator, per-lane fire) with
    the timeout armed, without and with a lossy crash adversary that
    restores from the daemon's snapshots."""
    fkw = (dict(crash_rate=0.3, crash_mode="lossy", crash_start=100,
                crash_len=2, marker_drop_rate=0.01) if faulted else None)
    jr, tr, prog = _plain_pair({**BASE, "snapshot_every": 5,
                                "snapshot_timeout": 40}, fkw,
                               quarantine=faulted)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got, tr.delay))
    assert int(got.next_sid.min()) > 3      # the daemon initiated
    if faulted:
        # the crash restored balances from the daemon's snapshots
        assert int(got.fault_counts[:, 3].sum()) > 0
        assert not bool((got.error & ERR_FAULT_UNRECOVERED).any())


# ---- (d) carry-across --------------------------------------------------------

@pytest.mark.parametrize("name", ["er16-slice-program", "marker-drop-retry"])
def test_faulted_carry_across(name):
    """JAX runs the phases, the port takes the faulted state over and
    drains it; the JAX drain of the same state gives the same leaves."""
    jr, tr, prog = _pair(name)
    mid = jax.device_get(jr.run_storm(jr.init_batch_device(), prog,
                                      drain=False))
    got = tr.drain(state_from_numpy(mid, "cpu"))
    ref = jax.device_get(jr.drain(jax.device_put(mid)))
    _assert_states_equal(ref, state_to_numpy(got, tr.delay))


def test_faulted_run_ticks_matches_jax():
    """The multi-tick loop under faults and quarantine (no quiescence
    exit: crashes can fire on a drained lane)."""
    jr, tr, prog = _pair("er16-slice-program")
    mid = jax.device_get(jr.run_storm(jr.init_batch_device(), prog,
                                      drain=False))
    ref = jax.device_get(jr.run_ticks(jax.device_put(mid), 7))
    got = tr.kernel._run_ticks(
        BatchedRunner._own(state_from_numpy(mid, "cpu")), 7)
    _assert_states_equal(ref, state_to_numpy(got, tr.delay))


# ---- (e) what is not ported --------------------------------------------------

def test_unported_fault_paths_raise():
    """``DenseSim(faults=)`` is ported (tests/test_torch_dense_faults.py):
    it arms the one lane with the JAX single instance's key; what raises
    now is the fold under faults (ValueError, as in JAX)."""
    spec = workloads.ring_topology(4)
    sim = DenseSim(spec, FixedDelay(1), faults=Faults(1, drop_rate=0.1),
                   device="cpu")
    assert int(sim.state.fault_key[0]) == int(
        Faults(1).init_batch_state(1, "cpu")[0])
    with pytest.raises(ValueError, match="runs uninjured"):
        DenseSim(spec, FixedDelay(1), None, "fold",
                 faults=Faults(1, drop_rate=0.1), device="cpu")


def test_faulted_runner_needs_cuda_or_cpu():
    """Without CUDA and without device="cpu" the faulted runner raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedRunner(workloads.ring_topology(4), SimConfig(), HashDelay(1),
                      2, scheduler="exact", faults=Faults(1, drop_rate=0.1),
                      quarantine=True)


def test_supervisor_config_validation():
    with pytest.raises(ValueError, match="snapshot_timeout"):
        SimConfig(snapshot_timeout=-1)
    cfg = SimConfig.for_workload(snapshots=4, snapshot_timeout=64,
                                 snapshot_every=8)
    assert (cfg.snapshot_timeout, cfg.snapshot_retries,
            cfg.snapshot_every) == (64, 3, 8)
    assert dataclasses.replace(cfg, snapshot_retries=0).snapshot_retries == 0


def test_faulted_bench_row_on_cpu():
    """The bench with the JAX storm CLI's fault and supervisor flags: an
    armed adversary turns quarantine on, and the row carries the fault
    books and passes the faulted validity checks."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main([
            "--device", "cpu", "--scheduler", "exact", "--graph", "er",
            "--nodes", "16", "--batch", "4", "--phases", "8",
            "--snapshots", "2", "--repeats", "1", "--fault-drop", "0.05",
            "--fault-crash", "0.05", "--marker-fault-drop", "0.02",
            "--snapshot-timeout", "24"])
    assert rc == 0
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    assert row["quarantine"] and row["faults"]["drop"] == 0.05
    assert row["conservation_delta"] == 0
    assert all(row["fault_checks"].values())
    assert row["fault_events"]["drops"] > 0
    assert row["snapshot_lifecycle"]["retried"] > 0
