"""The 7 reference golden tests (snapshot_test.go:46-108) through the
port's exact scheduler, on the CPU.

Each case runs through ``chandy_lamport_tpu_torch.api.check_reference_case``
(``run_events_file``: ``DenseSim`` over the cascade tick with the Go-exact
delay stream): every decoded snapshot must equal the reference's ``.snap``
file under the reference comparator, with the token-conservation check
passing. On two
cases the port's final state must also equal the JAX ``DenseSim``'s
(megatick 1) leaf for leaf, the Go stream's position included, and a
script the JAX simulator starts can be finished by the port from the
carried state. Tolerance: none.
"""

import jax
import numpy as np
import pytest

from chandy_lamport_tpu.config import REFERENCE_TEST_SEED
from chandy_lamport_tpu.core.dense import DenseSim as JaxDenseSim
from chandy_lamport_tpu.models.delay import GoExactDelay as HostGoExact
from chandy_lamport_tpu.utils.fixtures import read_events_file as j_events
from chandy_lamport_tpu.utils.fixtures import read_topology_file as j_top
from chandy_lamport_tpu_torch.api import (
    check_reference_case,
    run_events_file,
)
from chandy_lamport_tpu_torch.core.dense import DenseSim
from chandy_lamport_tpu_torch.core.state import DenseState
from chandy_lamport_tpu_torch.ops.delay import GoExactDelay
from chandy_lamport_tpu_torch.utils.carry import state_from_numpy
from chandy_lamport_tpu_torch.utils.fixtures import (
    read_events_file,
    read_topology_file,
)
from chandy_lamport_tpu_torch.utils.goldens import (
    REFERENCE_TESTS,
    fixture_path,
)

CASES = {t[1].removesuffix(".events"): t for t in REFERENCE_TESTS}
SEED = REFERENCE_TEST_SEED + 1


def _assert_leaves_equal(want, got):
    for field in want._fields:
        xs = jax.tree_util.tree_leaves(getattr(want, field))
        ys = jax.tree_util.tree_leaves(getattr(got, field))
        assert len(xs) == len(ys), field
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (field, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("name", list(CASES))
def test_golden_through_the_port(name):
    """The comparison the ``test`` subcommand and ``chip_smoke.py`` run:
    every snapshot equals its ``.snap`` file, tokens are conserved."""
    sim = check_reference_case(*CASES[name], device="cpu")
    assert sim.device.type == "cpu"


@pytest.mark.parametrize("name", ["8nodes-concurrent-snapshots", "10nodes"])
def test_golden_final_state_matches_jax(name):
    """The whole final state — rings, windows, log, Go stream — equals
    the JAX DenseSim's after the same script, drain and flush."""
    top, events, _ = CASES[name]
    _, sim = run_events_file(fixture_path(top), fixture_path(events),
                             device="cpu")
    ref = JaxDenseSim(j_top(fixture_path(top)), HostGoExact(SEED),
                      megatick=1)
    ref.run_events(j_events(fixture_path(events)))
    want = jax.device_get(ref.state)
    _assert_leaves_equal(want, sim.host_state())
    assert int(want.time) > 0 and int(np.asarray(want.next_sid)) > 1


def test_golden_carry_mid_script():
    """The JAX DenseSim runs the first half of 10nodes' script; the port
    takes its state over — the Go stream's uint64 words as int64 bit for
    bit — and runs the rest, drain and flush; the JAX simulator finishing
    the same script ends in the same leaves."""
    top, events, _ = CASES["10nodes"]
    j_script = j_events(fixture_path(events))
    script = read_events_file(fixture_path(events))
    half = len(script) // 2
    ref = JaxDenseSim(j_top(fixture_path(top)), HostGoExact(SEED),
                      megatick=1)
    for ev in j_script[:half]:
        ref.process_event(ev)
    mid = jax.device_get(ref.state)
    assert np.asarray(mid.delay_state[0]).dtype == np.uint64
    sim = DenseSim(read_topology_file(fixture_path(top)), GoExactDelay(SEED),
                   device="cpu")
    sim.state = state_from_numpy(DenseState(*(
        tuple(np.asarray(w)[None] for w in leaf) if isinstance(leaf, tuple)
        else np.asarray(leaf)[None] for leaf in mid)), "cpu")
    _assert_leaves_equal(mid, sim.host_state())
    for j_ev, ev in zip(j_script[half:], script[half:]):
        ref.process_event(j_ev)
        sim.process_event(ev)
    ref.state = ref.kernel.drain_and_flush(ref.state)
    sim.state = sim.kernel._drain_and_flush(sim.state)
    _assert_leaves_equal(jax.device_get(ref.state), sim.host_state())


@pytest.mark.parametrize("snaps", [
    [],                                  # the wrong number of snapshots
    ["2nodes-simple.snap"],              # another case's snapshot
], ids=["count", "content"])
def test_reference_case_refuses_a_wrong_golden(snaps):
    """The shared comparison fails where the goldens do not match."""
    with pytest.raises(AssertionError):
        check_reference_case("2nodes.top", "2nodes-message.events", snaps,
                             device="cpu")
