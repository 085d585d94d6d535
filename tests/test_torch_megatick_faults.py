"""The port's fused megatick under the fault adversary and the snapshot
supervisor against the JAX package's, leaf for leaf, on the CPU.

The JAX side runs ``BatchedRunner(..., kernel_engine="pallas",
fused_tick="on", megatick=K)`` with ``faults=`` and quarantine: its
``fused_scan`` kernel in interpret mode, the adversary's next K ticks
streamed in as ``edge_plane``/``aux_plane`` (``_fault_planes``), as
``tests/test_megatick_fused.py`` runs it. The port side runs the same
storm at megatick K through ``fused_ticks_plain`` (on the CPU the
megaticks take the plain form; the CUDA kernel, which hashes the same
masks in place, is held to that plain form on the card,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``). The programs are
``tools/chaos_smoke.py``'s (:405-433) at small size — message faults,
lossy crash windows with and without a completed snapshot, marker drops
under the timeout (retried and exhausted) — and the snapshot daemon, on
ring-8 and sf-16 at batch 4. Every ``DenseState`` leaf must be equal in
value and dtype: ``fault_counts``, ``fault_skew``, ``stale_markers``, the
supervisor's vectors, the error bits and the delay stream included.
Tolerance: none (integer state). Each JAX interpret-mode compile is
shared through a module-level cache. Also: the port at megatick 8 equals
its megatick 1, the plain ``Faults.fault_planes`` equals the JAX
``_fault_planes``, and the kernel's view of a program
(``Faults.kernel_program``) is pinned.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.state import DenseTopology as JaxTopology
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import FixedJaxDelay, HashJaxDelay
from chandy_lamport_tpu.ops.tick import TickKernel as JaxTickKernel
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.state import (
    ERR_FAULT_UNRECOVERED,
    ERR_SNAPSHOT_TIMEOUT,
    FC_CRASH,
)
from chandy_lamport_tpu_torch.kernels import megatick as km
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

# name: (graph, delay, phases, snapshots, fault kwargs, supervisor,
#        expected error bits) — tools/chaos_smoke.py:405-433 at seed 3,
# and the daemon with lossy crashes restored from its snapshots
SCENARIOS = {
    "msg-faults": ("sf", "hash", 16, 1, dict(
        drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05), None, 0),
    "crash-lossy-recovered": ("ring", "fixed", 48, 1, dict(
        crash_rate=1.0, crash_mode="lossy", crash_start=30, crash_len=2),
        None, 0),
    "crash-lossy-unrecovered": ("ring", "fixed", 24, 1, dict(
        crash_rate=1.0, crash_mode="lossy", crash_start=5, crash_len=2),
        None, ERR_FAULT_UNRECOVERED),
    "marker-drop-retry": ("ring", "fixed", 24, 1, dict(
        marker_drop_rate=0.1), "retry", 0),
    "marker-drop-exhausted": ("ring", "fixed", 16, 1, dict(
        marker_drop_rate=1.0), "exhaust", ERR_SNAPSHOT_TIMEOUT),
    "daemon": ("sf", "hash", 10, 3, dict(
        crash_rate=0.3, crash_mode="lossy", crash_start=45, crash_len=2,
        marker_drop_rate=0.01), "daemon", 0),
}
SUPERVISOR = {"retry": dict(snapshot_timeout=24, snapshot_retries=10),
              "exhaust": dict(snapshot_timeout=10, snapshot_retries=2),
              "daemon": dict(snapshot_every=5, snapshot_timeout=40,
                             max_snapshots=8),
              None: {}}


def _graph(pkg, kind):
    if kind == "sf":
        return pkg.scale_free(16, 2, seed=5, tokens=100)
    return pkg.ring_topology(8, tokens=100)


def _cfg(cls, sup):
    """The chaos smoke's config (``for_workload(snapshots=2,
    max_recorded=128)``) with its supervisor settings."""
    return cls.for_workload(snapshots=2, max_recorded=128,
                            **SUPERVISOR[sup])


def _port(name, megatick):
    kind, delay, phases, snaps, fkw, sup, _ = SCENARIOS[name]
    tr = BatchedRunner(_graph(workloads, kind), _cfg(SimConfig, sup),
                       HashDelay(11) if delay == "hash" else FixedDelay(1),
                       BATCH, scheduler="exact", faults=Faults(3, **fkw),
                       quarantine=True, device="cpu", megatick=megatick)
    prog = workloads.storm_program(
        tr.topo, phases, 1, workloads.staggered_snapshots(
            tr.topo, snaps, 1, 2, max_phases=phases))
    return tr, prog


@functools.lru_cache(maxsize=None)
def _jax(name, megatick):
    """The JAX runner of one scenario with the fused kernel on (built
    once: its jit caches live on the instance) and its final state."""
    kind, delay, phases, snaps, fkw, sup, _ = SCENARIOS[name]
    jr = JaxRunner(_graph(jax_workloads, kind), _cfg(JaxSimConfig, sup),
                   HashJaxDelay(11) if delay == "hash" else FixedJaxDelay(1),
                   BATCH, scheduler="exact", exact_impl="cascade",
                   megatick=megatick, kernel_engine="pallas",
                   fused_tick="on", faults=JaxFaults(3, **fkw),
                   quarantine=True)
    assert jr.fused == "on"
    _, prog = _port(name, megatick)
    return jr, jax.device_get(jr.run_storm(jr.init_batch_device(), prog))


def _assert_states_equal(ref, got):
    """Every leaf equal in value, shape and dtype."""
    for field in ref._fields:
        xs = jax.tree_util.tree_leaves(getattr(ref, field))
        ys = jax.tree_util.tree_leaves(getattr(got, field))
        assert len(xs) == len(ys), field
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (field, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=field)


CASES = [(name, 8) for name in SCENARIOS] + [
    ("msg-faults", 4), ("marker-drop-retry", 4), ("daemon", 4)]


@pytest.mark.parametrize("name, megatick", CASES,
                         ids=[f"{n}-K{k}" for n, k in CASES])
def test_faulted_storm_matches_jax_fused(name, megatick):
    """The whole storm (phases one tick at a time, the drain and flush in
    megaticks under the adversary and the supervisor): every leaf equal
    to the JAX fused run; the scenario's faults fired; the books balance;
    only the expected bits are set."""
    _, ref = _jax(name, megatick)
    tr, prog = _port(name, megatick)
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got, tr.delay))
    summary = BatchedRunner.summarize(got, runner=tr)
    assert summary["megatick"] == megatick
    assert summary["fused_reason"] == "CPU: the plain form"
    assert sum(summary["fault_events"].values()) > 0
    tokens0 = int(tr.topo.tokens0.sum()) * BATCH
    assert int(conservation_delta(got, tr.config, tokens0)) == 0
    want = SCENARIOS[name][-1]
    err = got.error.numpy()
    assert not np.any(err & ~want)
    assert bool(np.all(err & want)) == bool(want)
    if name == "daemon":
        assert int(got.next_sid.min()) > 3
        assert int(got.fault_counts[:, FC_CRASH].sum()) > 0
    if name.startswith("marker-drop"):
        assert int(got.snap_retries.sum()) > 0


@pytest.mark.parametrize("name", ["daemon", "marker-drop-retry"])
def test_faulted_run_ticks_matches_jax_fused(name):
    """The fused multi-tick loop (mode "ticks") from the state after the
    storm phases: 53 ticks, so the K=8 loop runs a 5-tick remainder and
    six megaticks. Under the daemon and lossy crashes a lane never goes
    quiet (the crash window at 45 falls in the run); under the timeout
    alone a lane goes quiet only with no snapshot pending (the dropped
    markers' snapshot retries)."""
    jr, _ = _jax(name, 8)
    tr, prog = _port(name, 8)
    mid = jax.device_get(jr.run_storm(jr.init_batch_device(), prog,
                                      drain=False))
    ref = jax.device_get(jr.run_ticks(jax.device_put(mid), 53))
    got = tr.kernel._run_ticks(
        BatchedRunner._own(state_from_numpy(mid, "cpu")), 53)
    _assert_states_equal(ref, state_to_numpy(got, tr.delay))
    if name == "daemon":
        assert int(got.fault_counts[:, FC_CRASH].sum()) > int(
            np.asarray(mid.fault_counts)[:, FC_CRASH].sum())
    else:
        assert int(got.snap_retries.sum()) > int(
            np.asarray(mid.snap_retries).sum())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_megatick8_equals_megatick1(name):
    """The port's faulted storm at megatick 8 ends in the leaves of its
    megatick 1."""
    finals = []
    for megatick in (1, 8):
        tr, prog = _port(name, megatick)
        finals.append(state_to_numpy(
            tr.run_storm(tr.init_batch_device(), prog), tr.delay))
    _assert_states_equal(*finals)


# ---- the program as the kernel takes it ---------------------------------------

PLANE_PROGRAMS = {
    "every-class-0.3": dict(drop_rate=0.3, dup_rate=0.3, jitter_rate=0.3,
                            crash_rate=0.3, marker_drop_rate=0.3,
                            marker_dup_rate=0.3, marker_jitter_rate=0.3,
                            crash_period=8, crash_len=3),
    "every-class-1.0": dict(drop_rate=1.0, dup_rate=1.0, jitter_rate=1.0,
                            crash_rate=1.0, marker_drop_rate=1.0,
                            marker_dup_rate=1.0, marker_jitter_rate=1.0),
    "window-lossy-rate-0": dict(crash_start=31, crash_len=2,
                                crash_mode="lossy", drop_rate=0.01),
}


@pytest.mark.parametrize("name", sorted(PLANE_PROGRAMS))
def test_fault_planes_match_jax(name):
    """``Faults.fault_planes`` equals the JAX ``_fault_planes`` (the fused
    kernel's input planes) for 4 ticks from times 0, 1, 31, 2^20 and
    2^31 - 2 (past the int32 wrap), on an armed and a disarmed key."""
    kw = PLANE_PROGRAMS[name]
    spec = jax_workloads.scale_free(16, 2, seed=5, tokens=100)
    jtk = JaxTickKernel(JaxTopology(spec), JaxSimConfig(),
                        HashJaxDelay(1), faults=JaxFaults(3, **kw))
    tf = Faults(3, **kw)
    topo = _port("msg-faults", 8)[0].topo
    keys = [int(tf.init_batch_state(1, "cpu")[0]), 0]
    times = [-1, 0, 30, 2**20 - 1, 2**31 - 2]
    key_t = torch.tensor([k for k in keys for _ in times])
    time_t = torch.tensor([t for _ in keys for t in times],
                          dtype=torch.int32)
    got_e, got_n = tf.fault_planes(key_t, time_t, 4, topo.e, topo.n, 5)
    lane = 0
    for key in keys:
        for t in times:
            s = types.SimpleNamespace(fault_key=jnp.uint32(key),
                                      time=jnp.int32(t))
            want_e, want_n = jtk._fault_planes(s, 4)
            np.testing.assert_array_equal(np.asarray(want_e),
                                          got_e[lane].numpy())
            np.testing.assert_array_equal(np.asarray(want_n),
                                          got_n[lane].numpy())
            lane += 1
    assert got_e.shape == (10, 4, 8, topo.e)
    assert got_n.shape == (10, 4, 2, topo.n)


def test_kernel_program_pinned():
    """The thresholds and arm flags the kernel hashes against, as
    ``_rate_mask`` derives them: rate 0 never fires and hashes nothing,
    rate >= 1 fires on every armed lane, a rate in between compares
    against ``min(int(rate * 2^32), 2^32 - 1)``; the crash gate of a
    ``crash_start`` window runs at ``crash_rate or 1.0``."""
    prog = Faults(3, drop_rate=0.3, dup_rate=1.0, crash_rate=2**-40,
                  marker_jitter_rate=0.5).kernel_program()
    assert prog["arm"] == [1, 2, 0, 1, 0, 0, 1]
    assert prog["thresh"] == [int(0.3 * 2**32), 0, 0, 0, 0, 0, 2**31]
    assert (prog["crash_kind"], prog["crash_lossy"]) == (1, 0)
    prog = Faults(3, crash_start=7, crash_len=3,
                  crash_mode="lossy").kernel_program()
    assert prog["arm"] == [0, 0, 0, 2, 0, 0, 0]
    assert (prog["crash_kind"], prog["crash_lossy"], prog["crash_start"],
            prog["crash_len"]) == (2, 1, 7, 3)
    assert Faults(3, drop_rate=0.1).kernel_program()["crash_kind"] == 0


def test_fused_smem_bytes_with_the_fault_arm():
    """The fault arm's planes ride the one reckoning: the ER-256 lane
    (S=8) takes 54,384 B with them (52,416 B without,
    tests/test_torch_megatick.py), within a block's share."""
    assert km.fused_smem_bytes(256, 768, 8, fault_arm=True) == 54_384
    assert km.fused_smem_bytes(256, 768, 8, fault_arm=True) <= km.SMEM_BUDGET
