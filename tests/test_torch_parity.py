"""The port's parity oracle (``core/parity.py``) and its ``api`` surface
against the JAX package's, on the CPU.

The port's ``ParitySim`` passes the 7 reference goldens; it equals the
JAX ``ParitySim`` (every snapshot, the node balances and the
``EpochTrace.pretty()`` timeline) on 20 ``randgen`` scripts drawn from
the same seeds in both packages, under the Go-exact stream and under
fixed delays; ``run_events_file(..., "parity")`` equals ``"torch"`` (the
dense backend on ``device="cpu"``, megatick 8: the plain form) on every
golden, snapshots and trace; ``make_backend`` keeps the JAX refusals.
Tolerance: none (integers and strings).
"""

import random

import pytest

from chandy_lamport_tpu import api as jax_api
from chandy_lamport_tpu.models import delay as jax_delay
from chandy_lamport_tpu.utils import randgen as jax_randgen
from chandy_lamport_tpu_torch import api, make_backend, run_events
from chandy_lamport_tpu_torch.core.parity import ParitySim
from chandy_lamport_tpu_torch.core.parity import run_events as parity_run
from chandy_lamport_tpu_torch.models import delay
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.utils import randgen
from chandy_lamport_tpu_torch.utils.goldens import (
    REFERENCE_TESTS,
    fixture_path,
)

GOLDENS = [events.removesuffix(".events") for _, events, _ in
           REFERENCE_TESTS]


def _snaps(snaps) -> list:
    """Snapshots in a package-free form."""
    return [(s.id, dict(s.token_map),
             [(m.src, m.dest, str(m.message)) for m in s.messages])
            for s in snaps]


@pytest.mark.parametrize("case", REFERENCE_TESTS, ids=GOLDENS)
def test_parity_passes_the_goldens(case):
    """Each golden through ``run_events_file(..., "parity")``: the token
    check and every snapshot equal to its .snap file."""
    top, events, snaps = case
    sim = api.check_reference_case(top, events, snaps, backend="parity")
    assert isinstance(sim, ParitySim)


def _random_case(pkg_randgen, seed):
    rng = random.Random(seed)
    topo = pkg_randgen.random_strongly_connected(rng, rng.randrange(3, 9))
    return topo, pkg_randgen.random_script(rng, topo, rng.randrange(8, 40))


@pytest.mark.parametrize("seed", range(20))
def test_parity_equals_jax_on_random_scripts(seed):
    """The port's oracle and the JAX one on the same drawn graph and
    script: equal snapshots, balances and timelines (Go-exact delays on
    even seeds, fixed delay 2 on odd ones)."""
    ptopo, pevents = _random_case(randgen, seed)
    jtopo, jevents = _random_case(jax_randgen, seed)
    assert (ptopo.nodes, ptopo.links) == (jtopo.nodes, jtopo.links)
    assert [str(e) for e in pevents] == [str(e) for e in jevents]
    if seed % 2 == 0:
        pd = delay.GoExactDelay(seed + 1)
        jd = jax_delay.GoExactDelay(seed + 1)
    else:
        pd, jd = delay.FixedDelay(2), jax_delay.FixedDelay(2)
    psnaps, psim = run_events("parity", ptopo, pevents, pd, trace=True)
    jsnaps, jsim = jax_api.run_events("parity", jtopo, jevents, jd,
                                      trace=True)
    assert _snaps(psnaps) == _snaps(jsnaps)
    assert psim.node_tokens() == jsim.node_tokens()
    assert psim.total_tokens() == jsim.total_tokens()
    assert psim.trace.pretty() == jsim.trace.pretty()
    assert psim.trace.pretty()


@pytest.mark.parametrize("case", REFERENCE_TESTS, ids=GOLDENS)
def test_parity_equals_the_torch_backend(case):
    """``run_events_file(top, events, "parity")`` and ``"torch"`` on the
    CPU: equal snapshots, balances and traced timelines (the parity
    backend's ``EpochTrace`` and the flight recorder's decoding)."""
    top, events, _ = case
    paths = fixture_path(top), fixture_path(events)
    psnaps, psim = api.run_events_file(*paths, "parity", trace=True)
    tsnaps, tsim = api.run_events_file(*paths, "torch", trace=True,
                                       device="cpu")
    assert _snaps(psnaps) == _snaps(tsnaps)
    assert psim.node_tokens() == tsim.node_tokens()
    assert psim.trace.pretty() == tsim.trace.pretty()


def test_make_backend_refusals_and_forms():
    """The JAX refusals on parity (``exact_impl`` other than cascade,
    ``faults``), the port's on a device sampler, an unknown name; the
    torch backend's ``DenseSim`` on the device named, a host model mapped
    to its device twin."""
    spec = randgen.random_strongly_connected(random.Random(1), 4)
    with pytest.raises(ValueError, match="exact_impl"):
        make_backend("parity", spec, delay.FixedDelay(1), exact_impl="wave")
    with pytest.raises(ValueError, match="fault adversary"):
        make_backend("parity", spec, delay.FixedDelay(1), faults=Faults(3))
    with pytest.raises(TypeError, match="host delay model"):
        make_backend("parity", spec, HashDelay(1))
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("jax", spec, delay.FixedDelay(1))
    sim = make_backend("torch", spec, delay.FixedDelay(2), device="cpu")
    assert sim.device.type == "cpu"
    assert type(sim.delay).__module__.endswith("ops.delay")
    assert sim.delay.delay == 2
    with pytest.raises(TypeError, match="no device twin"):
        make_backend("torch", spec, delay.NumpyUniformDelay(1),
                     device="cpu")
    psim = make_backend("parity", spec, delay.GoExactDelay(5))
    assert isinstance(psim, ParitySim) and sorted(psim.nodes) == \
        sorted(n for n, _ in spec.nodes)
    assert parity_run(psim, randgen.random_script(random.Random(2), spec,
                                                  10))
