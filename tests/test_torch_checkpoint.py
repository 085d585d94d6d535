"""The port's checkpoints (utils/checkpoint.py, utils/atomicio.py) against
the JAX package's, on the CPU.

(a) The header's ``treedef`` is the JAX package's ``str(tree_structure)``
for the storm state and the ``(state, stream)`` pair under every sampler.
(b) A file written by either package loads in the other, leaf for leaf
with the JAX dtypes, and resumes bit-exactly: a faulted sync storm cut
after its first chunk and a faulted sync stream killed after its first
save, in both directions, each equal to the other package's
uninterrupted run. (c) Every damaged file (garbage, truncated,
header-less, another format version, structure, shape, dtype) raises
``CheckpointError`` naming the path with the JAX package's message; a
save leaves no tmp file, and a writer killed at the failpoint leaves the
previous file loadable. (d) The port's ``storm`` and ``stream`` killed
and resumed through their command lines equal their uninterrupted runs
and the JAX CLI's lines. (e) ``restore_from_snapshot`` equals the JAX
one, replays to the original balances, and refuses what is no recovery
line. Integer work: no tolerance.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from chandy_lamport_tpu import cli as jax_cli
from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.state import DenseState as JaxDenseState
from chandy_lamport_tpu.core.state import DenseTopology as JaxTopology
from chandy_lamport_tpu.core.state import init_state as jax_init_state
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.models.faults import JaxFaults
from chandy_lamport_tpu.ops.delay_jax import (
    FixedJaxDelay,
    GoExactJaxDelay,
    HashJaxDelay,
)
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu.utils import checkpoint as jax_ckpt
from chandy_lamport_tpu_torch.__main__ import storm_run, stream_run
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.state import (
    CHECKPOINT_FORMAT_HISTORY,
    DenseTopology,
    init_state,
)
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.ops.delay import (
    FixedDelay,
    GoExactDelay,
    HashDelay,
)
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils.carry import (
    state_to_numpy,
    stream_to_numpy,
)
from chandy_lamport_tpu_torch.utils.checkpoint import (
    CheckpointError,
    load_state,
    restore_from_snapshot,
    save_state,
    treedef_string,
)

BATCH, PHASES, CUT = 4, 12, 6
FAULTS = dict(drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05,
              crash_rate=0.05, marker_drop_rate=0.02, marker_dup_rate=0.05,
              marker_jitter_rate=0.05)
CFG = dict(snapshots=4, max_recorded=128, split_markers=True,
           snapshot_timeout=16, max_snapshots=8)


def _host_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(tree))]


def _port_leaves(tree, delay):
    state, stream = tree if type(tree) is tuple else (tree, None)
    out = _host_leaves(state_to_numpy(state, delay))
    return out + (_host_leaves(stream_to_numpy(stream)) if stream else [])


def _assert_leaves_equal(want, got):
    assert len(want) == len(got)
    for i, (x, y) in enumerate(zip(want, got)):
        assert x.dtype == y.dtype, (i, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


# ---- (a) the header's treedef ------------------------------------------------

@pytest.mark.parametrize("jdelay, tdelay", [
    (HashJaxDelay(3), HashDelay(3)), (FixedJaxDelay(1), FixedDelay(1)),
    (GoExactJaxDelay(3), GoExactDelay(3))], ids=["hash", "fixed", "goexact"])
def test_treedef_string_is_the_jax_one(jdelay, tdelay):
    """``treedef_string`` of the port's state and of the (state, stream)
    pair is ``str(jax.tree_util.tree_structure(...))`` of the JAX ones,
    built without jax: the field lists and the sampler's word count."""
    spec = workloads.ring_topology(4)
    cfg = SimConfig()
    jstate = jax_init_state(JaxTopology(spec), JaxSimConfig(),
                            jdelay.init_state())
    tstate = init_state(DenseTopology(spec), cfg, 2, tdelay, "cpu")
    assert treedef_string(tstate) == str(
        jax.tree_util.tree_structure(jstate))
    jr = JaxRunner(spec, JaxSimConfig(), HashJaxDelay(1), 2,
                   kernel_engine="xla")
    pool = jr.pack_jobs(jax_workloads.stream_jobs(spec, 3, seed=1,
                                                  max_phases=4))
    pr = BatchedRunner(spec, cfg, HashDelay(1), 2, device="cpu")
    jstream = jr.init_stream(pool)
    tstream = pr.init_stream(pr.pack_jobs(workloads.stream_jobs(
        spec, 3, seed=1, max_phases=4)))
    assert treedef_string((tstate, tstream)) == str(
        jax.tree_util.tree_structure((jstate, jstream)))


# ---- (b) across the packages -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _storm_pair():
    spec = (jax_workloads.erdos_renyi(12, 3.0, seed=3, tokens=50),
            workloads.erdos_renyi(12, 3.0, seed=3, tokens=50))
    jr = JaxRunner(spec[0], JaxSimConfig.for_workload(**CFG), HashJaxDelay(7),
                   BATCH, scheduler="sync", kernel_engine="xla",
                   faults=JaxFaults(5, **FAULTS), quarantine=True)
    pr = BatchedRunner(spec[1], SimConfig.for_workload(**CFG), HashDelay(7),
                       BATCH, scheduler="sync", device="cpu",
                       faults=Faults(5, **FAULTS), quarantine=True)
    prog = workloads.storm_program(pr.topo, PHASES, 1, workloads.
                                   staggered_snapshots(pr.topo, 4, 1, 2,
                                                       max_phases=PHASES))
    first = (prog.amounts[:CUT], prog.snap[:CUT])
    rest = (prog.amounts[CUT:], prog.snap[CUT:])
    whole = jax.device_get(jr.drain(jr.run_storm(
        jr.run_storm(jr.init_batch_device(), first, drain=False), rest,
        drain=False)))
    return jr, pr, first, rest, whole


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_storm_checkpoint_crosses_packages_and_resumes(writer, tmp_path):
    """A faulted sync storm cut after its first chunk: the writer's file
    loads in the other package leaf for leaf (the JAX dtypes, the uint32
    words included), and the reader runs the rest and drains to the
    uninterrupted JAX run's leaves; the port's own uninterrupted run
    equals it too."""
    jr, pr, first, rest, whole = _storm_pair()
    path = str(tmp_path / f"{writer}.npz")
    if writer == "jax":
        mid = jr.run_storm(jr.init_batch_device(), first, drain=False)
        jax_ckpt.save_state(path, mid, meta={"next_phase": CUT})
        state, meta = load_state(path, pr.init_batch_device(),
                                 delay=pr.delay)
        _assert_leaves_equal(_host_leaves(mid), _port_leaves(state, pr.delay))
        final = _port_leaves(pr.drain(pr.run_storm(state, rest,
                                                   drain=False)), pr.delay)
    else:
        mid = pr.run_storm(pr.init_batch_device(), first, drain=False)
        save_state(path, mid, meta={"next_phase": CUT}, delay=pr.delay)
        state, meta = jax_ckpt.load_state(path, jr.init_batch())
        _assert_leaves_equal(_port_leaves(mid, pr.delay), _host_leaves(state))
        final = _host_leaves(jr.drain(jr.run_storm(
            jax.device_put(state), rest, drain=False)))
    assert meta == {"next_phase": CUT}
    _assert_leaves_equal(_host_leaves(whole), final)
    if writer == "port":
        prog = tuple(np.concatenate([a, b]) for a, b in zip(first, rest))
        _assert_leaves_equal(_host_leaves(whole), _port_leaves(
            pr.run_storm(pr.init_batch_device(), prog), pr.delay))


STREAM_FAULTS = dict(drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05)


@functools.lru_cache(maxsize=None)
def _stream_pair():
    spec = workloads.ring_topology(8, tokens=20)
    cfg = dict(snapshots=2, max_recorded=64, split_markers=True)
    jr = JaxRunner(jax_workloads.ring_topology(8, tokens=20),
                   JaxSimConfig.for_workload(**cfg), HashJaxDelay(7), BATCH,
                   scheduler="sync", kernel_engine="xla",
                   faults=JaxFaults(5, **STREAM_FAULTS), quarantine=True)
    pr = BatchedRunner(spec, SimConfig.for_workload(**cfg), HashDelay(7),
                       BATCH, scheduler="sync", device="cpu",
                       faults=Faults(5, **STREAM_FAULTS), quarantine=True)
    jobs = workloads.stream_jobs(spec, 10, seed=4, base_phases=2,
                                 max_phases=6)
    jjobs = jax_workloads.stream_jobs(jax_workloads.ring_topology(
        8, tokens=20), 10, seed=4, base_phases=2, max_phases=6)
    jpool, ppool = jr.pack_jobs(jjobs), pr.pack_jobs(jobs)
    whole = jr.run_stream(jpool, stretch=2, drain_chunk=8)
    return jr, pr, jpool, ppool, _host_leaves(whole)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stream_checkpoint_crosses_packages_and_resumes(writer, tmp_path):
    """A faulted sync stream checkpointed every 2 steps and killed after
    its first save (``run_stream(checkpoint=..., checkpoint_every=2,
    kill_after_saves=1)``): the (state, stream) pair loads in the other
    package and resumes to the uninterrupted JAX run's leaves; the port's
    uninterrupted run equals it too."""
    jr, pr, jpool, ppool, whole = _stream_pair()
    path = str(tmp_path / f"{writer}.npz")
    kw = dict(stretch=2, drain_chunk=8)
    if writer == "jax":
        jr.run_stream(jpool, checkpoint=path, checkpoint_every=2,
                      kill_after_saves=1, **kw)
        (s, st), meta = load_state(
            path, (pr.init_batch_device(), pr.init_stream(ppool)),
            delay=pr.delay)
        final = _port_leaves(pr.run_stream(ppool, state=s, stream=st, **kw),
                             pr.delay)
    else:
        pr.run_stream(ppool, checkpoint=path, checkpoint_every=2,
                      kill_after_saves=1, **kw)
        (s, st), meta = jax_ckpt.load_state(
            path, (jr.init_batch(), jr.init_stream(jpool)))
        final = _host_leaves(jr.run_stream(jpool, state=s, stream=st, **kw))
    assert meta["stream_steps"] == 2 and meta["jobs_done"] < 10
    _assert_leaves_equal(whole, final)
    if writer == "port":
        _assert_leaves_equal(whole, _port_leaves(
            pr.run_stream(ppool, **kw), pr.delay))


# ---- (c) damaged files, atomic writes ----------------------------------------

def _small():
    spec = workloads.ring_topology(8, tokens=100)
    cfg = dict(snapshots=2, max_recorded=128)
    jr = JaxRunner(jax_workloads.ring_topology(8, tokens=100),
                   JaxSimConfig.for_workload(**cfg), HashJaxDelay(11), 2,
                   scheduler="exact", kernel_engine="xla")
    pr = BatchedRunner(spec, SimConfig.for_workload(**cfg), HashDelay(11), 2,
                       scheduler="exact", device="cpu")
    return jr, pr


def _rewrite(src, dst, header=None, leaf0=None):
    """Copy checkpoint ``src`` to ``dst`` with its header or first leaf
    replaced (a file this build did not write)."""
    with np.load(src) as z:
        arrays = {k: z[k] for k in z.files}
    if header is not None:
        head = json.loads(bytes(arrays["__header__"]).decode())
        head.update(header)
        arrays["__header__"] = np.frombuffer(json.dumps(head).encode(),
                                             dtype=np.uint8)
    if leaf0 is not None:
        arrays["leaf_0"] = leaf0(arrays["leaf_0"])
    with open(dst, "wb") as f:
        np.savez(f, **arrays)


def _damaged(kind, tmp_path):
    jr, pr = _small()
    good = str(tmp_path / "good.npz")
    save_state(good, pr.init_batch_device(), delay=pr.delay)
    path = str(tmp_path / f"{kind}.npz")
    if kind == "garbage":
        with open(path, "wb") as f:
            f.write(b"this is not a zip archive at all")
    elif kind == "truncated":
        blob = open(good, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2])
    elif kind == "headless":
        np.savez(path, leaf_0=np.zeros(4))
    elif kind == "stale":
        stale = CHECKPOINT_FORMAT_HISTORY[2][0]
        _rewrite(good, path, header={"format_version": stale})
    elif kind == "dtype":
        _rewrite(good, path, leaf0=lambda a: a.astype(np.int64))
    else:
        path = good
    return jr, pr, path


@pytest.mark.parametrize("kind", ["garbage", "truncated", "headless",
                                  "stale", "dtype", "shape", "structure"])
def test_damaged_files_raise_checkpoint_error(kind, tmp_path):
    """Each damaged file raises ``CheckpointError`` naming its path, with
    the message the JAX package gives for the same file (a shape from
    another batch, a structure from another sampler)."""
    jr, pr, path = _damaged(kind, tmp_path)
    plike, jlike = pr.init_batch_device(), jr.init_batch()
    pdelay = pr.delay
    if kind == "shape":
        plike = BatchedRunner(workloads.ring_topology(8, tokens=100),
                              pr.config, HashDelay(11), 3,
                              device="cpu").init_batch_device()
        jlike = jax.tree_util.tree_map(
            lambda x: np.concatenate([x, x[:1]]), jlike)
    elif kind == "structure":
        pdelay = FixedDelay(1)
        plike = init_state(pr.topo, pr.config, 2, pdelay, "cpu")
        jlike = jax.device_get(JaxRunner(
            jax_workloads.ring_topology(8, tokens=100), jr.config,
            FixedJaxDelay(1), 2, scheduler="exact",
            kernel_engine="xla").init_batch())
    with pytest.raises(CheckpointError, match=os.path.basename(path)) as got:
        load_state(path, plike, delay=pdelay)
    with pytest.raises(jax_ckpt.CheckpointError) as want:
        jax_ckpt.load_state(path, jlike)
    assert str(got.value) == str(want.value)
    if kind == "stale":
        assert "format version 3" in str(got.value)


def test_save_is_atomic_and_a_killed_writer_leaves_the_old_file(tmp_path):
    """A save leaves no tmp file; a writer SIGKILLed at the
    ``checkpoint-replace`` failpoint (``CLSIM_IO_FAILPOINT``), between its
    fsynced tmp file and the rename, leaves the previous file whole and
    loadable."""
    _, pr = _small()
    path = str(tmp_path / "ck.npz")
    first = pr.init_batch_device()
    save_state(path, first, meta={"which": "first"}, delay=pr.delay)
    assert os.listdir(tmp_path) == ["ck.npz"]
    script = (
        "from chandy_lamport_tpu_torch.config import SimConfig\n"
        "from chandy_lamport_tpu_torch.models import workloads\n"
        "from chandy_lamport_tpu_torch.ops.delay import HashDelay\n"
        "from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner\n"
        "from chandy_lamport_tpu_torch.utils.checkpoint import save_state\n"
        "r = BatchedRunner(workloads.ring_topology(8, tokens=100), "
        "SimConfig.for_workload(snapshots=2, max_recorded=128), "
        "HashDelay(11), 2, scheduler='exact', device='cpu')\n"
        "s = r.run_ticks(r.init_batch_device(), 3)\n"
        f"save_state({path!r}, s, meta={{'which': 'second'}})\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CLSIM_IO_FAILPOINT="checkpoint-replace",
               PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          cwd=str(tmp_path), capture_output=True)
    assert proc.returncode == -9, proc.stderr.decode()[-2000:]
    assert os.path.exists(path + ".tmp")
    state, meta = load_state(path, pr.init_batch_device(), delay=pr.delay)
    assert meta == {"which": "first"}
    _assert_leaves_equal(_port_leaves(first, pr.delay),
                         _port_leaves(state, pr.delay))


# ---- (d) the command lines ---------------------------------------------------

def _capture(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def _file_leaves(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__header__"}


STORM = ["--graph", "ring", "--nodes", "8", "--batch", "2", "--phases", "9",
         "--snapshots", "1", "--seed", "3", "--marker-fault-drop", "0.15",
         "--snapshot-timeout", "16", "--snapshot-retries", "8"]


def test_storm_cli_kill_and_resume_under_marker_faults(tmp_path):
    """The JAX package's kill-and-resume acceptance case
    (tests/test_recovery.py:246, the default sync storm under marker
    drops with the supervisor) through the port's ``storm``: killed right
    after its first 3-phase chunk's checkpoint (exit 17), resumed with
    ``--resume-from``, it ends with the uninterrupted run's final file and
    counters line, which equal the JAX CLI's."""
    ref, mid, fin = (str(tmp_path / f) for f in ("ref.npz", "mid.npz",
                                                 "fin.npz"))
    jref = str(tmp_path / "jref.npz")
    dev = ["--device", "cpu"]
    rc, want = _capture(storm_run, STORM + dev + ["--checkpoint", ref])
    assert rc == 0 and want["snapshot_lifecycle"]["retried"] > 0
    rc, killed = _capture(storm_run, STORM + dev + [
        "--checkpoint", mid, "--checkpoint-every", "3",
        "--kill-after-chunk", "0"])
    assert rc == 17 and killed == {"killed_after_phase": 3,
                                   "checkpoint": mid}
    rc, got = _capture(storm_run, STORM + dev + [
        "--checkpoint", fin, "--checkpoint-every", "3", "--resume-from",
        mid])
    assert rc == 0
    assert {**got, "checkpoint": ref} == want
    a, b = _file_leaves(ref), _file_leaves(fin)
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    rc, jax_row = _capture(jax_cli.main, ["storm"] + STORM + [
        "--checkpoint", jref])
    assert rc == 0 and {**jax_row, "checkpoint": ref} == want
    for name, x in _file_leaves(jref).items():
        assert x.dtype == a[name].dtype
        np.testing.assert_array_equal(x, a[name], err_msg=name)


STREAM = ["--graph", "ring", "--nodes", "8", "--batch", "4", "--jobs", "10",
          "--max-phases", "6", "--snapshots", "2", "--scheduler", "sync",
          "--fault-drop", "0.05", "--fault-dup", "0.05", "--fault-jitter",
          "0.05", "--seed", "2"]
TIMING = ("wall_seconds", "jobs_per_sec", "effective_jobs_per_sec")


def test_stream_cli_kill_and_resume(tmp_path):
    """The port's faulted sync ``stream`` killed after its first
    checkpoint (``--checkpoint-every 2 --kill-after-saves 1``, exit 17)
    and resumed with ``--resume-from``: its row equals the uninterrupted
    run's and the JAX CLI's, timings aside; a JAX checkpoint of the same
    run resumes in the port to the same row."""
    ck, jck = str(tmp_path / "ck.npz"), str(tmp_path / "jck.npz")
    dev = ["--device", "cpu"]

    def row(r):
        return {k: v for k, v in r.items() if k not in TIMING}

    rc, want = _capture(stream_run, STREAM + dev)
    assert rc == 0 and want["jobs_done"] == 10
    rc, killed = _capture(stream_run, STREAM + dev + [
        "--checkpoint", ck, "--checkpoint-every", "2",
        "--kill-after-saves", "1"])
    assert rc == 17 and killed["checkpoint"] == ck
    assert killed["killed_after_steps"] == 2 and killed["jobs_done"] < 10
    rc, got = _capture(stream_run, STREAM + dev + ["--resume-from", ck])
    assert rc == 0 and row(got) == row(want)
    rc, jkilled = _capture(jax_cli.main, ["stream"] + STREAM + [
        "--checkpoint", jck, "--checkpoint-every", "2",
        "--kill-after-saves", "1"])
    assert rc == 17 and {**jkilled, "checkpoint": ck} == killed
    rc, got = _capture(stream_run, STREAM + dev + ["--resume-from", jck])
    assert rc == 0 and row(got) == row(want)
    rc, jrow = _capture(jax_cli.main, ["stream"] + STREAM + [
        "--resume-from", jck])
    assert rc == 0
    assert {k: jrow[k] for k in row(want)} == row(want)
    assert stream_run(STREAM + dev + ["--checkpoint-every", "2"]) == 2


# ---- (e) snapshot-rollback recovery ------------------------------------------

def _snapshot_run(phases_done, delay=1):
    """A one-lane exact ring-8 run whose snapshot starts at the last send
    phase (every message is before the cut), stopped after
    ``phases_done`` phases (10 = run whole and drained), each message
    ``delay`` ticks on the wire."""
    spec = workloads.ring_topology(8, tokens=100)
    cfg = SimConfig.for_workload(snapshots=2, max_recorded=128)
    r = BatchedRunner(spec, cfg, FixedDelay(delay), 1, scheduler="exact",
                      device="cpu")
    prog = workloads.storm_program(
        r.topo, phases=10, amount=1,
        snapshot_phases=workloads.staggered_snapshots(r.topo, 1, 9, 1,
                                                      max_phases=10))
    if phases_done == 10:
        final = r.run_storm(r.init_batch_device(), prog)
    else:
        final = r.run_storm(r.init_batch_device(),
                            (prog.amounts[:phases_done],
                             prog.snap[:phases_done]), drain=False)
    host = state_to_numpy(final, r.delay)
    lane0 = type(host)(*(tuple(w[0] for w in leaf) if isinstance(leaf, tuple)
                         else leaf[0] for leaf in host))
    return r, lane0


def test_restore_from_snapshot_replays_to_the_original_balances():
    """The cut of a completed snapshot (frozen balances, the recorded
    in-flight messages deliverable at tick 1) equals the JAX
    ``restore_from_snapshot`` leaf for leaf, and replayed to quiescence it
    gives the uninterrupted run's final balances."""
    r, final = _snapshot_run(10)
    assert int(final.error) == 0 and int(final.completed[0]) == r.topo.n
    restored = restore_from_snapshot(r.topo, r.config, final, 0,
                                     FixedDelay(1), device="cpu")
    want = jax_ckpt.restore_from_snapshot(
        JaxTopology(workloads.ring_topology(8, tokens=100)),
        JaxSimConfig(**dataclasses.asdict(r.config)),
        JaxDenseState(*final), 0, delay_state=FixedJaxDelay(1).init_state())
    got = state_to_numpy(restored, FixedDelay(1))
    _assert_leaves_equal(
        _host_leaves(want),
        _host_leaves(type(got)(*(tuple(w[0] for w in leaf)
                                 if isinstance(leaf, tuple) else leaf[0]
                                 for leaf in got))))
    assert int(restored.q_len.sum()) > 0       # messages were in flight
    replayed = r.run_ticks(restored, 200)
    assert int(replayed.q_len.sum()) == 0
    np.testing.assert_array_equal(replayed.tokens[0].numpy(), final.tokens)


def test_restore_from_snapshot_refuses_what_is_no_recovery_line():
    """An incomplete snapshot is no consistent cut, and a backlog past the
    queue capacity does not fit: both raise CheckpointError by name."""
    r, mid = _snapshot_run(9)
    with pytest.raises(CheckpointError, match="not a completed recovery"):
        restore_from_snapshot(r.topo, r.config, mid, 0, FixedDelay(1),
                              device="cpu")
    r, final = _snapshot_run(10, delay=4)
    small = dataclasses.replace(r.config, queue_capacity=1)
    with pytest.raises(CheckpointError, match="queue_capacity 1"):
        restore_from_snapshot(r.topo, small, final, 0, FixedDelay(1),
                              device="cpu")
