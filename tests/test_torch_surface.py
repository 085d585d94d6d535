"""The port's public surface against the JAX package's, call for call.

Each test builds the same call in both packages and compares what it
does: ``BatchedRunner``'s default scheduler (a storm run through both
with no ``scheduler`` argument, every state leaf equal),
``BatchedRunner.summarize(state, stream=...)`` on one state and stream
carry, the leading positional parameters of ``DenseSim`` and
``run_events_file`` (``inspect.signature``), and the ``storm`` command
line: its parser's defaults against the JAX ``storm`` subparser's, one
tiny storm whose counters line equals the JAX CLI's on the shared keys
(tolerance: none), each flag whose machinery the port lacks refused by
name with its ROADMAP item, and each flag the port once refused (the
checkpoint flags; the fault, supervisor and quarantine flags on the sync
scheduler) run through both CLIs with equal counters lines. Then the
repairs C5-C7 (``BatchedRunner``'s and ``TickKernel``'s positional
order, the JAX top-level names, ``decode_errors(error_bits=)``) and the
``stream --memo --memo-cache`` row against the JAX CLI's.
"""

import inspect
import json

import jax
import numpy as np
import pytest

from chandy_lamport_tpu import api as jax_api
from chandy_lamport_tpu import cli as jax_cli
from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.dense import DenseSim as JaxDenseSim
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.ops.delay_jax import HashJaxDelay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu_torch import api
from chandy_lamport_tpu_torch.__main__ import (
    _UNPORTED_STORM,
    _storm_parser,
    storm_run,
)
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.dense import DenseSim
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils.carry import (
    state_to_numpy,
    stream_to_numpy,
)
from chandy_lamport_tpu_torch.utils.tracing import read_telemetry

CFG = dict(max_snapshots=4, queue_capacity=24, max_recorded=32)
BATCH, PHASES, SEED = 4, 8, 17
TINY_STORM = ["--graph", "ring", "--nodes", "8", "--batch", "4", "--phases",
              "12", "--snapshots", "1"]


def _assert_states_equal(ref, got):
    for name in ref._fields:
        xs = jax.tree_util.tree_leaves(getattr(ref, name))
        ys = jax.tree_util.tree_leaves(getattr(got, name))
        assert len(xs) == len(ys), name
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (name, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=name)


# ---- C1: the default scheduler -------------------------------------------

def test_default_scheduler_is_the_jax_default():
    """``BatchedRunner(spec, cfg, delay, B)`` with no scheduler runs the
    exact scheduler in both packages: the same storm, every leaf equal."""
    jr = JaxRunner(jax_workloads.ring_topology(8, tokens=20),
                   JaxSimConfig(**CFG), HashJaxDelay(SEED), BATCH,
                   kernel_engine="xla")
    pr = BatchedRunner(workloads.ring_topology(8, tokens=20),
                       SimConfig(**CFG), HashDelay(SEED), BATCH,
                       device="cpu")
    assert jr.scheduler == pr.scheduler == "exact"
    prog = workloads.storm_program(pr.topo, PHASES, 1, workloads.
                                   staggered_snapshots(pr.topo, 4, 1, 2,
                                                       max_phases=PHASES))
    ref = jax.device_get(jr.run_storm(jr.init_batch(), prog))
    got = pr.run_storm(pr.init_batch_device(), prog)
    _assert_states_equal(ref, state_to_numpy(got))


# ---- C3: summarize(state, stream=...) -------------------------------------

def test_summarize_takes_the_stream_as_jax_does():
    """``summarize(state, stream)`` (positional, as the JAX signature
    has it) and ``summarize(state, stream=stream)`` add the JAX ``memo``
    and ``serve`` books; on the same state and stream carry the whole
    summary equals the JAX ``summarize``'s. The runner's stamps are
    keyword-only."""
    pr = BatchedRunner(workloads.ring_topology(4), SimConfig(),
                       HashDelay(1), 2, device="cpu")
    jobs = workloads.stream_jobs(workloads.ring_topology(4), 3, seed=1,
                                 max_phases=4)
    state, stream = pr.run_stream(pr.pack_jobs(jobs))
    got = BatchedRunner.summarize(state, stream)
    assert got == BatchedRunner.summarize(state, stream=stream)
    want = JaxRunner.summarize(state_to_numpy(state),
                               stream_to_numpy(stream))
    assert got == want
    assert got["memo"]["cache_hits"] == 0 and "serve" in got
    assert "memo" not in BatchedRunner.summarize(state)
    stamped = BatchedRunner.summarize(state, runner=pr)
    assert stamped["megatick"] == 1 and "memo" not in stamped
    assert list(inspect.signature(BatchedRunner.summarize).parameters) == \
        list(inspect.signature(JaxRunner.summarize).parameters) + ["runner"]
    assert inspect.signature(BatchedRunner.summarize).parameters[
        "runner"].kind is inspect.Parameter.KEYWORD_ONLY


# ---- C4: the positional order ---------------------------------------------

def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD
            and p.name != "self"]


@pytest.mark.parametrize("port, ref, renamed", [
    (DenseSim.__init__, JaxDenseSim.__init__, {"delay": "delay_model"}),
    (api.run_events_file, jax_api.run_events_file, {}),
], ids=["DenseSim", "run_events_file"])
def test_positional_parameters_lead_as_in_jax(port, ref, renamed):
    """The port's positional parameters are the JAX function's leading
    ones, in its order (``delay`` is the JAX ``delay_model``); every
    port-only parameter is keyword-only."""
    mine = [renamed.get(name, name) for name in _positional(port)]
    assert mine == _positional(ref)[:len(mine)]
    assert len(mine) >= 2
    for name in ("device", "trace", "faults", "seed"):
        p = inspect.signature(port).parameters.get(name)
        assert p is None or p.kind is inspect.Parameter.KEYWORD_ONLY, name


def test_densesim_fourth_argument_is_exact_impl():
    """``DenseSim(top, delay, None, "wave")`` picks the wave as the JAX
    call does, not a device."""
    sim = DenseSim(workloads.ring_topology(4), HashDelay(1), None, "wave",
                   1, device="cpu")
    assert sim.kernel.exact_impl == "wave" and sim.kernel.megatick == 1


# ---- C2: the storm command line ------------------------------------------

def _jax_storm_defaults(monkeypatch):
    seen = []
    monkeypatch.setattr(jax_cli, "_cmd_storm",
                        lambda args: seen.append(vars(args)) or 0)
    assert jax_cli.main(["storm"]) == 0
    (args,) = seen
    return {k: v for k, v in args.items()
            if k not in ("command", "fn", "platform")}


def test_storm_parser_has_the_jax_defaults(monkeypatch):
    """Every flag of the JAX ``storm`` subparser, with its default; the
    port adds only ``--device``."""
    want = _jax_storm_defaults(monkeypatch)
    got = vars(_storm_parser().parse_args([]))
    assert got.pop("device") is None
    assert got == want


def test_tiny_storm_prints_the_jax_counters(capsys, tmp_path):
    """``storm --graph ring --nodes 8 --batch 4 --phases 12 --snapshots
    1``: the port's counters line equals the JAX CLI's on every shared
    key (the port prints no other), and both exit 0; with ``--telemetry``
    the line also lands in the JSONL file as one ``storm_run`` record."""
    assert jax_cli.main(["storm"] + TINY_STORM) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert storm_run(TINY_STORM + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) <= set(want)
    assert got == {k: want[k] for k in got}
    assert got["error_bits"] == 0 and got["conservation_delta"] == 0
    assert got["snapshots_completed"] == 4
    path = str(tmp_path / "storm.jsonl")
    assert storm_run(TINY_STORM + ["--device", "cpu", "--telemetry",
                                   path]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (record,) = read_telemetry(path)
    assert record["kind"] == "storm_run" and line["telemetry"] == path
    assert {k: record[k] for k in got} == got and record["nodes"] == 8


def _away_from_default(flag):
    """A value of ``flag`` other than its default."""
    values = {"--delay": "uniform", "--window-dtype": "uint16",
              "--reduce-mode": "segsum", "--kernel-engine": "pallas",
              "--fused-tick": "on"}
    if flag in values:
        return [flag, values[flag]]
    return [flag, "2"]


@pytest.mark.parametrize("flag, item", _UNPORTED_STORM,
                         ids=[f[0] for f in _UNPORTED_STORM])
def test_storm_refuses_unported_flags_by_name(flag, item, capsys):
    """A flag whose machinery is not ported, set away from its default,
    is refused before anything runs, naming the flag and its ROADMAP
    item."""
    with pytest.raises(SystemExit) as exc:
        storm_run(TINY_STORM + _away_from_default(flag)
                  + ["--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and f"ROADMAP {item}" in err


# the flags the port refused before the checkpoints (A8) and the sync
# scheduler under faults (A3a) were ported, each with what makes it act on
# the tiny sync storm; "{ck}" is a checkpoint path of the case's own
MARKER_FAULTS = ["--marker-fault-drop", "0.15", "--snapshot-timeout", "16",
                 "--snapshot-retries", "8"]
LIFTED = {
    "--checkpoint": ["--checkpoint", "{ck}"] + MARKER_FAULTS,
    "--checkpoint-every": ["--checkpoint", "{ck}", "--checkpoint-every",
                           "5"] + MARKER_FAULTS,
    "--resume-from": ["--resume-from", "{mid}"] + MARKER_FAULTS,
    "--kill-after-chunk": ["--checkpoint", "{ck}", "--checkpoint-every",
                           "5", "--kill-after-chunk", "0"] + MARKER_FAULTS,
    "--fault-drop": ["--fault-drop", "0.1"],
    "--fault-dup": ["--fault-dup", "0.1"],
    "--fault-jitter": ["--fault-jitter", "0.2"],
    "--fault-crash": ["--fault-crash", "0.5", "--crash-mode", "lossy"],
    "--fault-seed": ["--fault-seed", "7", "--fault-drop", "0.1"],
    "--marker-fault-drop": MARKER_FAULTS,
    "--marker-fault-dup": ["--marker-fault-dup", "0.3"],
    "--marker-fault-jitter": ["--marker-fault-jitter", "0.3"],
    "--snapshot-timeout": ["--snapshot-timeout", "6",
                           "--marker-fault-drop", "0.3"],
    "--snapshot-retries": ["--snapshot-retries", "1", "--snapshot-timeout",
                           "8", "--marker-fault-drop", "0.3"],
    "--snapshot-every": ["--snapshot-every", "5"],
    "--quarantine": ["--quarantine", "--queue-capacity", "2"],
}


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _without_paths(row):
    return {k: v for k, v in row.items() if k != "checkpoint"}


@pytest.mark.parametrize("flag", list(LIFTED))
def test_storm_runs_the_lifted_flags(flag, capsys, tmp_path):
    """Each flag the port once refused runs the tiny sync storm through
    the port's and the JAX ``storm`` on the CPU: equal exit codes and
    counters lines (the checkpoint path aside), and where a checkpoint is
    written, equal leaves in the two files. The resumed case starts both
    from one file the port wrote after its first chunk."""
    mid = str(tmp_path / "mid.npz")
    if flag == "--resume-from":
        assert storm_run(TINY_STORM + MARKER_FAULTS + [
            "--device", "cpu", "--checkpoint", mid, "--checkpoint-every",
            "5", "--kill-after-chunk", "0"]) == 17
        capsys.readouterr()
    runs = {}
    for pkg in ("jax", "port"):
        ck = str(tmp_path / f"{pkg}.npz")
        extra = [a.format(ck=ck, mid=mid) for a in LIFTED[flag]]
        if pkg == "jax":
            rc = jax_cli.main(["storm"] + TINY_STORM + extra)
        else:
            rc = storm_run(TINY_STORM + extra + ["--device", "cpu"])
        runs[pkg] = (rc, _last_json(capsys.readouterr().out), ck)
    (jrc, jrow, jck), (prc, prow, pck) = runs["jax"], runs["port"]
    assert prc == jrc
    assert _without_paths(prow) == _without_paths(jrow)
    assert prow.get("checkpoint", pck) == pck
    if "{ck}" in LIFTED[flag]:
        with np.load(jck) as za, np.load(pck) as zb:
            assert set(za.files) == set(zb.files)
            for name in za.files:
                if name != "__header__":
                    assert za[name].dtype == zb[name].dtype, name
                    np.testing.assert_array_equal(za[name], zb[name])


def test_storm_refuses_the_fold_and_runs_faults_on_exact(capsys):
    """``--exact-impl fold`` is refused naming A5b; the fault flags run on
    the exact scheduler too, whose counters line then carries the
    adversary's books."""
    with pytest.raises(SystemExit):
        storm_run(TINY_STORM + ["--scheduler", "exact", "--exact-impl",
                                "fold", "--device", "cpu"])
    assert "ROADMAP A5b" in capsys.readouterr().err
    assert storm_run(TINY_STORM + ["--scheduler", "exact", "--megatick",
                                   "4", "--fault-drop", "0.05",
                                   "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["conservation_delta"] == 0
    assert row["fault_events"]["drops"] > 0 and "lane_errors" in row


# ---- C5-C7: BatchedRunner's positional order, the top-level names, ----------
# ---- decode_errors' keyword -------------------------------------------------

def test_batched_runner_positional_order_as_jax():
    """``BatchedRunner(topo, cfg, delay, 4, "exact", 0, "wave")`` takes
    the wave in both packages (the JAX 7th positional parameter is
    ``exact_impl``), and the two give equal stream rows on a ring-8 pool;
    the port's parameters after ``exact_impl`` are keyword-only (the JAX
    8th is ``auto_layouts``, which the port lacks), ``device`` among
    them."""
    jspec = jax_workloads.ring_topology(8)
    jr = JaxRunner(jspec, JaxSimConfig.for_workload(snapshots=4),
                   HashJaxDelay(seed=11), 4, "exact", 0, "wave")
    pr = BatchedRunner(workloads.ring_topology(8),
                       SimConfig.for_workload(snapshots=4), HashDelay(11),
                       4, "exact", 0, "wave", device="cpu")
    assert pr.kernel.exact_impl == jr.kernel.exact_impl == "wave"
    assert _positional(BatchedRunner.__init__) == \
        _positional(JaxRunner.__init__)[:7]
    params = inspect.signature(BatchedRunner.__init__).parameters
    for name in ("device", "faults", "quarantine", "trace", "megatick",
                 "memo", "memo_cache", "memo_cache_entries",
                 "memo_cache_bytes", "prefix_cache", "prefix_cache_entries",
                 "prefix_cache_bytes"):
        assert params[name].kind is inspect.Parameter.KEYWORD_ONLY, name
    with pytest.raises(TypeError):
        BatchedRunner(workloads.ring_topology(8), None, HashDelay(1), 4,
                      "exact", 0, "cascade", "cpu")
    jobs = jax_workloads.stream_jobs(jspec, 8, seed=5, max_phases=10)
    _, jst = jr.run_stream(jr.pack_jobs(jobs), stretch=3, drain_chunk=16)
    from test_torch_stream import _port_job

    _, pst = pr.run_stream(pr.pack_jobs([_port_job(j) for j in jobs]),
                           stretch=3, drain_chunk=16)
    assert pr.stream_results(pst) == jr.stream_results(jst)


def test_tick_kernel_positional_order_as_jax():
    """``TickKernel``'s leading positional parameters are the JAX ones
    (``marker_mode`` 4th), through ``megatick``; ``device`` and the rest
    are keyword-only."""
    from chandy_lamport_tpu.ops.tick import TickKernel as JaxTickKernel
    from chandy_lamport_tpu_torch.core.state import DenseTopology
    from chandy_lamport_tpu_torch.ops.tick import TickKernel

    assert _positional(TickKernel.__init__) == \
        _positional(JaxTickKernel.__init__)[:6]
    params = inspect.signature(TickKernel.__init__).parameters
    for name in ("device", "faults", "quarantine", "trace"):
        assert params[name].kind is inspect.Parameter.KEYWORD_ONLY, name
    tk = TickKernel(DenseTopology(workloads.ring_topology(4)),
                    SimConfig(), HashDelay(1), "split", device="cpu")
    assert tk.marker_mode == "split"


def test_top_level_names_as_jax():
    """The JAX package's top-level names import from the port (less
    ``run_events`` and ``make_backend``, ROADMAP A12), each the port's
    own and equal in use: ``MAX_DELAY``, the event and snapshot types,
    ``__version__``."""
    import chandy_lamport_tpu as jax_pkg
    import chandy_lamport_tpu_torch as pkg
    from chandy_lamport_tpu_torch import (  # noqa: F401
        MAX_DELAY,
        GlobalSnapshot,
        Message,
        MsgSnapshot,
        PassTokenEvent,
        SnapshotEvent,
        TickEvent,
        __version__,
    )

    missing = set(jax_pkg.__all__) - set(pkg.__all__)
    assert missing == {"run_events", "make_backend"}
    assert __version__ == jax_pkg.__version__ == "0.1.0"
    assert MAX_DELAY == jax_pkg.MAX_DELAY
    for name in ("Message", "MsgSnapshot", "GlobalSnapshot",
                 "PassTokenEvent", "SnapshotEvent", "TickEvent"):
        assert getattr(pkg, name).__module__.startswith(
            "chandy_lamport_tpu_torch"), name
    assert str(TickEvent(3)) == str(jax_pkg.TickEvent(3))
    assert str(Message(True, 2)) == str(jax_pkg.Message(True, 2))


@pytest.mark.parametrize("bits", [0, 1, 2 | 4 | 8 | 16, 511])
def test_decode_errors_keyword_as_jax(bits):
    """``decode_errors(error_bits=...)`` is the JAX call: one message per
    bit set, in bit order, the JAX message for bits 0-4 (the port words
    bits 5-8, whose JAX text names JAX machinery, its own way)."""
    from chandy_lamport_tpu.core.state import decode_errors as jax_decode
    from chandy_lamport_tpu_torch.core.state import decode_errors

    got, want = decode_errors(error_bits=bits), jax_decode(error_bits=bits)
    assert len(got) == len(want) == bin(bits).count("1")
    assert got[:5] == want[:5] if bits == 511 else got == want
    assert list(inspect.signature(decode_errors).parameters) == \
        ["error_bits"]


def test_stream_command_memo_equals_the_jax_cli(capsys, tmp_path):
    """``stream --memo admit --memo-cache PATH`` prints the JAX CLI's row
    (every counter, ``"memo": "admit"``), and the second run of each CLI
    on its own cache file serves every job from it."""
    from chandy_lamport_tpu_torch.__main__ import stream_run

    flags = ["--graph", "ring", "--nodes", "8", "--batch", "4", "--jobs",
             "10", "--max-phases", "10", "--snapshots", "4", "--seed", "2",
             "--dup-rate", "0.6", "--memo", "admit"]
    clock = ("wall_seconds", "jobs_per_sec", "effective_jobs_per_sec")
    for _ in range(2):
        assert jax_cli.main(["stream"] + flags + [
            "--memo-cache", str(tmp_path / "j.jsonl")]) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stream_run(flags + ["--memo-cache", str(tmp_path / "p.jsonl"),
                                   "--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert {k: v for k, v in got.items() if k not in clock} == \
            {k: v for k, v in want.items() if k not in clock}
        assert got["memo"] == "admit" and got["jobs_errored"] == 0
    assert got["cache_hits"] == 10 and got["shadow_checks"] == 1
