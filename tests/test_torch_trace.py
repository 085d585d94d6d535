"""The port's flight recorder (``utils/tracing.py``) against the JAX
package's, on the CPU, bit for bit (integer work: the tolerance is none).

(a) The appenders on the same rings, masks and payloads as the JAX
``trace_append_many`` / ``trace_append_one`` (per lane under ``vmap``) and
``trace_append_lanes``: a capacity above a call's events and below them
(the ring wraps inside one call), a lane with ``tr_on = 0``, K = 0 (the
identity). (b) ``decode_trace``, ``trace_counts``, ``trace_pretty`` and
``trace_to_perfetto`` equal JAX's on the same rings; telemetry round-trips.
(c) The goldens: ``DenseSim(trace=Trace()).trace.pretty()`` at megatick 1
and 8 (the plain fused form) equals the parity backend's
``EpochTrace.pretty()`` on all seven, and the JAX ``DenseSim(trace=
JaxTrace())`` on three. (d) The ``trace`` subcommand prints the JAX
CLI's stdout and its ``# 9 events recorded, 0 dropped`` on
2nodes-message.
"""

import json
import subprocess
import sys
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.api import run_events_file as jax_run_events_file
from chandy_lamport_tpu.core.state import DenseTopology as JaxTopology
from chandy_lamport_tpu.utils import tracing as jtr
from chandy_lamport_tpu.utils.goldens import REFERENCE_TESTS, fixture_path
from chandy_lamport_tpu_torch.api import run_events_file
from chandy_lamport_tpu_torch.core.dense import DenseSim
from chandy_lamport_tpu_torch.core.state import DenseTopology
from chandy_lamport_tpu_torch.ops.delay import GoExactDelay
from chandy_lamport_tpu_torch.utils import tracing as ptr
from chandy_lamport_tpu_torch.utils.fixtures import (
    read_events_file,
    read_topology_file,
)

GOLDEN_IDS = [events.removesuffix(".events") for _, events, _ in
              REFERENCE_TESTS]


class Ring(NamedTuple):
    """The leaves the appenders read and write (either package's)."""
    time: Any
    tr_meta: Any
    tr_data: Any
    tr_tick: Any
    tr_count: Any
    tr_on: Any


def _rings(b, k, seed):
    """Matching rings: random history, counts past the capacity on some
    lanes, lane 2 disarmed."""
    rng = np.random.default_rng(seed)
    arrs = dict(
        time=rng.integers(0, 50, b).astype(np.int32),
        tr_meta=rng.integers(0, 2**20, (b, k)).astype(np.int32),
        tr_data=rng.integers(-9, 9, (b, k)).astype(np.int32),
        tr_tick=rng.integers(0, 50, (b, k)).astype(np.int32),
        tr_count=rng.integers(0, 3 * max(k, 1) + 2, b).astype(np.int32),
        tr_on=np.ones(b, np.int32))
    arrs["tr_on"][2] = 0
    return (Ring(**{n: jnp.asarray(a) for n, a in arrs.items()}),
            Ring(**{n: torch.from_numpy(a.copy()) for n, a in arrs.items()}))


def _assert_rings_equal(jring, pring):
    for name in Ring._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jring, name)),
                                      getattr(pring, name).numpy(),
                                      err_msg=name)


def _jax_many(s, mask, kind, actor, payload):
    """The JAX ``trace_append_many`` on each lane (its state is one
    instance's), with per-lane actor and payload rows."""
    return jax.vmap(lambda r, m, a, p: jtr.trace_append_many(
        r, m, kind, a, p))(s, mask, actor, payload)


@pytest.mark.parametrize("k", [64, 5, 0], ids=["K-above", "K-below-wraps",
                                                "K-0-identity"])
def test_appenders_match_jax(k):
    """A sequence of appends (a [S, E]-shaped multi-event append, a
    per-lane single event, lane events) on the same rings: equal after
    every call. At K = 5 one call's 12-odd events wrap the ring."""
    b, s_, e = 4, 3, 7
    jring, pring = _rings(b, k, seed=k + 1)
    rng = np.random.default_rng(k)
    for step in range(3):
        mask = rng.random((b, s_, e)) < 0.6
        actor = rng.integers(0, 40, (b, s_, e)).astype(np.int32)
        payload = rng.integers(-5, 5, (b, s_, e)).astype(np.int32)
        jring = _jax_many(jring, jnp.asarray(mask), jtr.EV_MSEND,
                          jnp.asarray(actor), jnp.asarray(payload))
        pring = ptr.trace_append_many(pring, torch.from_numpy(mask),
                                      ptr.EV_MSEND, torch.from_numpy(actor),
                                      torch.from_numpy(payload))
        _assert_rings_equal(jring, pring)
        fire = rng.random(b) < 0.7
        node = rng.integers(0, 9, b).astype(np.int32)
        sid = rng.integers(0, 4, b).astype(np.int32)
        jring = jax.vmap(lambda r, f, a, p: jtr.trace_append_one(
            r, f, jtr.EV_SNAP_END, a, p))(jring, jnp.asarray(fire),
                                          jnp.asarray(node),
                                          jnp.asarray(sid))
        pring = ptr.trace_append_one(pring, torch.from_numpy(fire),
                                     ptr.EV_SNAP_END,
                                     torch.from_numpy(node),
                                     torch.from_numpy(sid))
        _assert_rings_equal(jring, pring)
        jring = jtr.trace_append_lanes(jring, jnp.asarray(fire),
                                       jtr.EV_LANE_ADMIT, jnp.asarray(sid))
        pring = ptr.trace_append_lanes(pring, torch.from_numpy(fire),
                                       ptr.EV_LANE_ADMIT,
                                       torch.from_numpy(sid))
        _assert_rings_equal(jring, pring)
        jring = jring._replace(time=jring.time + 1)
        pring = pring._replace(time=pring.time + 1)
    # the disarmed lane kept its ring and its count
    _, fresh = _rings(b, k, seed=k + 1)
    for name in ("tr_meta", "tr_data", "tr_tick", "tr_count"):
        assert torch.equal(getattr(pring, name)[2], getattr(fresh, name)[2])


def test_append_keeps_the_last_k_of_one_call():
    """12 events into a 5-slot ring in one call: the last 5 are in the
    ring, the count moved by 12."""
    _, ring = _rings(4, 5, seed=3)
    ring = ring._replace(tr_on=torch.ones(4, dtype=torch.int32),
                         tr_count=torch.zeros(4, dtype=torch.int32))
    payload = torch.arange(12, dtype=torch.int32)
    got = ptr.trace_append_many(ring, torch.ones((4, 12), dtype=torch.bool),
                                ptr.EV_RECV, 3, payload)
    assert got.tr_count.tolist() == [12] * 4
    assert sorted(got.tr_data[0].tolist()) == [7, 8, 9, 10, 11]
    events = ptr.decode_trace(got, lane=0)
    assert [ev.payload for ev in events] == [7, 8, 9, 10, 11]


def test_trace_config_and_arming():
    from chandy_lamport_tpu_torch.config import SimConfig

    with pytest.raises(ValueError, match="trace_capacity"):
        SimConfig(trace_capacity=-1)
    with pytest.raises(ValueError, match="capacity"):
        ptr.Trace(-1)
    assert ptr.Trace().describe() == jtr.JaxTrace().describe()
    assert ptr.Trace(7).describe() == {"capacity": 7}
    assert ptr.armed_config(SimConfig(), None).trace_capacity == 0
    assert ptr.armed_config(SimConfig(), ptr.Trace()).trace_capacity == 4096
    assert ptr.armed_config(SimConfig(trace_capacity=9),
                            ptr.Trace(5)).trace_capacity == 9
    assert ptr.EVENT_KIND_NAMES == jtr.EVENT_KIND_NAMES
    # the ring's 12 B a slot in the per-lane footprint, as in JAX
    from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
    from chandy_lamport_tpu.utils.metrics import (
        instance_footprint_bytes as jax_footprint,
    )
    from chandy_lamport_tpu_torch.utils.metrics import (
        instance_footprint_bytes,
    )

    for k in (0, 64, 4096):
        assert instance_footprint_bytes(256, 768, SimConfig(
            trace_capacity=k)) == jax_footprint(256, 768, JaxSimConfig(
                trace_capacity=k))
    assert ptr.pack_event(37, ptr.EV_FAULT) == jtr.pack_event(37,
                                                               jtr.EV_FAULT)


def _decoded_pair(k, seed):
    """One lane's ring (wrapped, every kind of event) for both
    packages' host side, on a topology the actors index."""
    rng = np.random.default_rng(seed)
    top = read_topology_file(fixture_path("3nodes.top"))
    n_kinds = len(jtr.EVENT_KIND_NAMES) + 1   # and one unknown kind
    kinds = rng.integers(0, n_kinds, k)
    topo = DenseTopology(top)
    actors = np.where(kinds <= jtr.EV_MRECV, rng.integers(0, topo.e, k),
                      rng.integers(0, topo.n + 1, k))
    ring = Ring(time=np.int32(0),
                tr_meta=jtr.pack_event(actors, kinds).astype(np.int32),
                tr_data=rng.integers(0, 20, k).astype(np.int32),
                tr_tick=np.sort(rng.integers(0, 30, k)).astype(np.int32),
                tr_count=np.int32(k + 3), tr_on=np.int32(1))
    return top, ring


def test_decoding_and_exporters_match_jax():
    top, ring = _decoded_pair(40, seed=2)
    jtopo, ptopo = JaxTopology(top), DenseTopology(top)
    jev = jtr.decode_trace(ring)
    pev = ptr.decode_trace(ring)
    assert [tuple(e) for e in pev] == [tuple(e) for e in jev]
    assert [e.kind_name for e in pev] == [e.kind_name for e in jev]
    assert ptr.trace_pretty(pev, ptopo) == jtr.trace_pretty(jev, jtopo)
    assert ptr.trace_to_perfetto(pev, ptopo, lane=3) == \
        jtr.trace_to_perfetto(jev, jtopo, lane=3)
    batched = ring._replace(
        tr_meta=np.stack([ring.tr_meta] * 3), tr_data=np.stack(
            [ring.tr_data] * 3), tr_tick=np.stack([ring.tr_tick] * 3),
        tr_count=np.array([0, 41, 7], np.int32))
    assert ptr.trace_counts(batched) == jtr.trace_counts(batched)
    assert ptr.decode_trace(batched, lane=2) == jtr.decode_trace(batched,
                                                                 lane=2)
    with pytest.raises(ValueError, match="lane="):
        ptr.decode_trace(batched)


def test_telemetry_round_trips(tmp_path):
    path = tmp_path / "t.jsonl"
    with ptr.TelemetryWriter(str(path)) as tw:
        tw.write("trace_run", {"trace_events": 9})
        tw.write("event", {"tick": 3, "event": "recv"})
    with open(path, "a") as f:
        f.write('{"schema": 1, "kind": "torn"')      # a killed writer's tail
    rows = ptr.read_telemetry(str(path))
    assert rows == jtr.read_telemetry(str(path))
    assert [r["kind"] for r in rows] == ["trace_run", "event"]
    with open(path, "a") as f:
        f.write("\n" + json.dumps({"schema": 99, "kind": "x"}) + "\n")
    with pytest.raises(ValueError, match="newer"):
        ptr.read_telemetry(str(path))


# ---- (c) the goldens ---------------------------------------------------------

def _port_pretty(top, events, megatick):
    sim = DenseSim(read_topology_file(fixture_path(top)),
                   GoExactDelay(8053172852482175524), device="cpu",
                   megatick=megatick, trace=ptr.Trace())
    sim.run_events(read_events_file(fixture_path(events)))
    return sim


@pytest.mark.parametrize("top,events,snaps", REFERENCE_TESTS,
                         ids=GOLDEN_IDS)
def test_golden_timelines_match_parity(top, events, snaps):
    """Every golden's timeline at megatick 1 and 8 equals the parity
    backend's ``EpochTrace.pretty()``; nothing dropped."""
    _, psim = jax_run_events_file(fixture_path(top), fixture_path(events),
                                  backend="parity", trace=True)
    want = psim.trace.pretty()
    for k in (1, 8):
        sim = _port_pretty(top, events, k)
        assert sim.trace.pretty() == want, k
        recorded, dropped = sim.trace.counts()
        assert recorded == len(sim.trace.events) > 0 and dropped == 0


@pytest.mark.parametrize("top,events,snaps", REFERENCE_TESTS[:3],
                         ids=GOLDEN_IDS[:3])
def test_golden_rings_match_jax_densesim(top, events, snaps):
    """The JAX ``DenseSim`` with ``JaxTrace()`` (its dense backend): the
    same timeline, events and perfetto export as the port's at megatick
    8, and the same ring planes."""
    _, jsim = jax_run_events_file(fixture_path(top), fixture_path(events),
                                  backend="jax", trace=True)
    sim = _port_pretty(top, events, 8)
    assert sim.trace.pretty() == jsim.trace.pretty()
    assert sim.trace.events == jsim.trace.events
    assert sim.trace.counts() == jsim.trace.counts()
    assert sim.trace.perfetto() == jsim.trace.perfetto()
    host = sim.host_state()
    jhost = jax.device_get(jsim.state)
    for name in ("tr_meta", "tr_data", "tr_tick", "tr_count", "tr_on"):
        np.testing.assert_array_equal(getattr(host, name),
                                      np.asarray(getattr(jhost, name)),
                                      err_msg=name)


def test_untraced_densesim_has_no_trace():
    top = read_topology_file(fixture_path("2nodes.top"))
    sim = DenseSim(top, GoExactDelay(1), device="cpu")
    assert sim.trace is None and sim.state.tr_meta.shape == (1, 0)
    snaps, traced = run_events_file(fixture_path("2nodes.top"),
                                    fixture_path("2nodes-message.events"),
                                    device="cpu", trace=True)
    assert traced.state.tr_meta.shape == (1, ptr.Trace.DEFAULT_CAPACITY)
    assert len(snaps) == 1


# ---- (d) the trace subcommand ------------------------------------------------

def test_trace_cli_matches_jax_cli(tmp_path):
    """``python -m chandy_lamport_tpu_torch trace --device cpu`` prints
    the JAX CLI's timeline and the expected count; its perfetto and
    telemetry files hold the same events."""
    top = fixture_path("2nodes.top")
    events = fixture_path("2nodes-message.events")
    perf, tele = tmp_path / "p.json", tmp_path / "t.jsonl"
    port = subprocess.run(
        [sys.executable, "-m", "chandy_lamport_tpu_torch", "trace", top,
         events, "--device", "cpu", "--perfetto", str(perf), "--telemetry",
         str(tele)], capture_output=True, text=True, check=True)
    ref = subprocess.run(
        [sys.executable, "-m", "chandy_lamport_tpu", "trace", top, events],
        capture_output=True, text=True, check=True)
    assert port.stdout == ref.stdout
    assert "# 9 events recorded, 0 dropped" in port.stderr
    assert port.stderr.splitlines()[-1] == ref.stderr.splitlines()[-1]
    rows = ptr.read_telemetry(str(tele))
    assert rows[0]["trace_events"] == 9 and len(rows) == 10
    trace = json.loads(perf.read_text())
    assert sum(ev.get("ph") != "M" for ev in trace["traceEvents"]) == 9
