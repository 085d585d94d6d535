"""The port's sync storm against the JAX package's, leaf for leaf.

The JAX ``BatchedRunner(scheduler="sync", kernel_engine="xla")`` (the
repo pins "xla" bit-identical to "pallas", tests/test_pallas_kernels.py)
and the port's ``BatchedRunner(device="cpu")`` run the same small storms
from the same seeds; every ``DenseState`` leaf — the delay sampler's
stream position and the error word included — must be equal in value
and dtype. Tolerance: none. Also: the mid-storm carry from JAX into the
port, the in-run conservation check, the CUDA-by-default entry point, the
bench row, and the port's import isolation.
"""

import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.ops.delay_jax import HashJaxDelay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu.utils import metrics as jax_metrics
from chandy_lamport_tpu_torch import bench
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.state import (
    ERR_CONSERVATION,
    ERR_QUEUE_OVERFLOW,
    ERR_RECORD_OVERFLOW,
    ERR_TICK_LIMIT,
)
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils import metrics
from chandy_lamport_tpu_torch.utils.carry import (
    state_from_numpy,
    state_to_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "chandy_lamport_tpu_torch")

# (graph family, generator args, record dtype): sf-32 and er-16, B=4, S=4
GRAPHS = {
    "sf32": ("scale_free", (32, 2), dict(seed=3, tokens=20), "int16"),
    "er16": ("erdos_renyi", (16, 2.5), dict(seed=11, tokens=20), "int32"),
}
CFG = dict(max_snapshots=4, queue_capacity=16, max_recorded=32)
BATCH, PHASES, SEED = 4, 8, 17


def _pair(graph, check_every=0, **overrides):
    family, args, kw, rec = GRAPHS[graph]
    cfg = {**CFG, "record_dtype": rec, **overrides}
    jr = JaxRunner(getattr(jax_workloads, family)(*args, **kw),
                   JaxSimConfig(**cfg), HashJaxDelay(SEED),
                   BATCH, scheduler="sync", kernel_engine="xla",
                   check_every=check_every)
    tr = BatchedRunner(getattr(workloads, family)(*args, **kw),
                       SimConfig(**cfg), HashDelay(SEED),
                       BATCH, scheduler="sync", check_every=check_every,
                       device="cpu")
    sched = workloads.staggered_snapshots(tr.topo, 4, 1, 2,
                                          max_phases=PHASES)
    prog = workloads.storm_program(tr.topo, PHASES, 1, sched)
    jprog = jax_workloads.storm_program(jr.topo, PHASES, 1, sched)
    for a, b in zip(prog, jprog):
        np.testing.assert_array_equal(a, b)
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


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_storm_matches_jax(graph):
    """(a) A full storm with drain and flush: every leaf equal."""
    jr, tr, prog = _pair(graph)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got))
    assert int(np.max(ref.error)) == 0
    # the lanes drain to different clocks (per-lane while_loop exits)
    assert len(set(np.asarray(ref.time).tolist())) > 1
    assert BatchedRunner.summarize(got) == {
        k: v for k, v in JaxRunner.summarize(jax.device_put(ref)).items()}
    # the metrics read the same numbers off both states
    host = jax.device_put(ref)
    cfg = tr.config
    assert int(metrics.total_tokens(got, cfg)) == int(
        jax_metrics.total_tokens(host, jr.config))
    assert int(metrics.conservation_delta(
        got, cfg, BATCH * int(tr.topo.tokens0.sum()))) == 0
    j_counters = jax_metrics.progress_counters(host, jr.config, jr.topo.n)
    t_counters = metrics.progress_counters(got, cfg, tr.topo.n)
    assert {k: int(v) for k, v in j_counters.items()} == {
        k: int(v) for k, v in t_counters.items()}
    assert metrics.instance_footprint_bytes(
        tr.topo.n, tr.topo.e, cfg) == jax_metrics.instance_footprint_bytes(
        jr.topo.n, jr.topo.e, jr.config)


@pytest.mark.parametrize("overrides, bit", [
    (dict(max_ticks=3), ERR_TICK_LIMIT),
    (dict(queue_capacity=2), ERR_QUEUE_OVERFLOW),
    (dict(max_recorded=1), ERR_RECORD_OVERFLOW),
], ids=["tick_limit", "queue_overflow", "record_overflow"])
def test_error_regimes_match_jax(overrides, bit):
    """Capacities too small for the storm: the per-lane drain limit, ring
    overflow (the append clobbers a live slot) and log overflow fire on
    the same lanes with the same state as in the JAX run."""
    jr, tr, prog = _pair("sf32", **overrides)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got))
    assert int((got.error & bit).count_nonzero()) > 0


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_carry_across_mid_storm(graph):
    """(b) JAX runs the phases, the port takes the state over and drains
    it; the JAX drain of the same state gives the same leaves."""
    jr, tr, prog = _pair(graph)
    mid = jax.device_get(jr.run_storm(jr.init_batch_device(), prog,
                                      drain=False))
    carried = state_from_numpy(mid, "cpu")
    _assert_states_equal(mid, state_to_numpy(carried))
    got = tr.drain(carried)
    ref = jax.device_get(jr.drain(jax.device_put(mid)))
    _assert_states_equal(ref, state_to_numpy(got))
    # the port's own phases reach the same mid-storm state
    _assert_states_equal(mid, state_to_numpy(
        tr.run_storm(tr.init_batch_device(), prog, drain=False)))


def test_check_every_conservation():
    """(c) check_every=2 keeps the conservation bit clear on a healthy
    storm (leaf-equal to JAX's checked run) and sets it on a lane whose
    balance was tampered with."""
    jr, tr, prog = _pair("sf32", check_every=2)
    ref = jax.device_get(jr.run_storm(jr.init_batch_device(), prog))
    got = tr.run_storm(tr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got))
    assert int(got.error.max()) == 0
    mid = tr.run_storm(tr.init_batch_device(), prog, drain=False)
    tokens = mid.tokens.clone()
    tokens[1, 0] += 1
    bad = tr.drain(mid._replace(tokens=tokens))
    assert (bad.error & ERR_CONSERVATION).tolist() == [
        0, ERR_CONSERVATION, 0, 0]


def test_runner_defaults_to_cuda():
    """(d) With no device the runner means the card; on a box without
    CUDA it raises, naming the argument that runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    spec = workloads.ring_topology(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedRunner(spec, SimConfig(), HashDelay(1), 2)


def test_bench_row_on_cpu():
    """The bench's JSON row, on the CPU at a tiny size; a queue capacity
    too small for the storm doubles until the warm run is clean."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(["--device", "cpu", "--nodes", "16", "--batch", "2",
                         "--phases", "6", "--snapshots", "2", "--repeats",
                         "1", "--capacity", "2"])
    assert rc == 0
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    assert row["metric"] == "node_ticks_per_sec_per_chip"
    assert row["platform"] == "cpu" and row["error_bits"] == 0
    assert row["queue_capacity"] > 2 and row["value"] > 0


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "chandy_lamport_tpu")


def test_port_imports_no_jax():
    """(e) Importing every port module loads neither jax nor the JAX
    package, and no port source imports either."""
    code = (
        "import pkgutil, sys, chandy_lamport_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'chandy_lamport_tpu')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for root, _, files in os.walk(PORT_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                elif (isinstance(node, ast.Constant)
                      and isinstance(node.value, str)):
                    names = [node.value] if _forbidden(node.value) and \
                        node.value.replace(".", "").isidentifier() else []
                else:
                    continue
                assert not any(_forbidden(n) for n in names), (path, names)
