"""The port's public surface against the JAX package's, call for call.

Each test builds the same call in both packages and compares what it
does: ``BatchedRunner``'s default scheduler (a storm run through both
with no ``scheduler`` argument, every state leaf equal),
``BatchedRunner.summarize(state, stream=...)`` on one state and stream
carry, the leading positional parameters of ``DenseSim`` and
``run_events_file`` (``inspect.signature``), and the ``storm`` command
line: its parser's defaults against the JAX ``storm`` subparser's, one
tiny storm whose counters line equals the JAX CLI's on the shared keys
(tolerance: none), and each flag the port once refused (the checkpoint
flags; the fault, supervisor and quarantine flags on the sync scheduler;
the A7 flags ``--delay uniform``, ``--window-dtype``, ``--reduce-mode``,
``--kernel-engine``, ``--fused-tick``, ``--fused-block-edges``; and
``--exact-impl fold``) run through both CLIs with equal counters lines.
Then the repairs C5-C7 (``BatchedRunner``'s and ``TickKernel``'s
positional order, the JAX top-level names, ``decode_errors(
error_bits=)``) and the ``stream --memo --memo-cache`` row against the
JAX CLI's. Then A7's surface: ``SimConfig``'s fields in the JAX order with
the JAX checks, each engine knob accepted and resolved (or refused) by
name on ``DenseSim`` and ``BatchedRunner`` in the JAX positions,
``run_events_file``'s keywords, and ``stream``/``bench`` under the
threefry sampler and uint16 windows.
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
from chandy_lamport_tpu_torch.__main__ import _storm_parser, storm_run
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
    # the port's own parameters, and those the missing ``backend`` shifts
    own = ("device",) if port is DenseSim.__init__ else (
        "device", "trace", "faults", "seed")
    for name in own:
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


# the storm flags the port refused by name until A7 was ported
A7_FLAGS = ("--delay", "--window-dtype", "--reduce-mode", "--kernel-engine",
            "--fused-tick", "--fused-block-edges")


@pytest.mark.parametrize("flag", A7_FLAGS, ids=list(A7_FLAGS))
def test_storm_refuses_unported_flags_by_name(flag, capsys):
    """The A7 flags, once refused by name, are ported: set away from its
    default each runs the tiny storm through the port's and the JAX
    ``storm`` with equal exit codes and counters lines, or raises the
    same error in both (``--fused-tick on`` on the sync scheduler, which
    has no megatick to fuse)."""
    out = {}
    for pkg in ("jax", "port"):
        try:
            rc = (jax_cli.main(["storm"] + TINY_STORM
                               + _away_from_default(flag))
                  if pkg == "jax" else
                  storm_run(TINY_STORM + _away_from_default(flag)
                            + ["--device", "cpu"]))
            out[pkg] = (rc, _last_json(capsys.readouterr().out))
        except ValueError as exc:
            out[pkg] = ("ValueError", "fused_tick='on' impossible" in str(
                exc))
    assert out["port"] == out["jax"]
    assert out["port"][0] == (
        "ValueError" if flag == "--fused-tick" else 0)


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
    """``--exact-impl fold`` runs (A5b) and prints the JAX CLI's counters
    line; under a fault flag both CLIs refuse it (ValueError: the fold
    runs uninjured); the fault flags run on the cascade, whose counters
    line then carries the adversary's books."""
    fold = TINY_STORM + ["--scheduler", "exact", "--exact-impl", "fold"]
    assert jax_cli.main(["storm"] + fold) == 0
    want = _last_json(capsys.readouterr().out)
    assert storm_run(fold + ["--device", "cpu"]) == 0
    assert _last_json(capsys.readouterr().out) == want
    for run in (lambda: jax_cli.main(["storm"] + fold
                                     + ["--fault-drop", "0.1"]),
                lambda: storm_run(fold + ["--fault-drop", "0.1",
                                          "--device", "cpu"])):
        with pytest.raises(ValueError, match="runs uninjured"):
            run()
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
    every parameter has the JAX position and default (``auto_layouts``
    8th), and the port's own ``device`` is keyword-only."""
    jspec = jax_workloads.ring_topology(8)
    jr = JaxRunner(jspec, JaxSimConfig.for_workload(snapshots=4),
                   HashJaxDelay(seed=11), 4, "exact", 0, "wave")
    pr = BatchedRunner(workloads.ring_topology(8),
                       SimConfig.for_workload(snapshots=4), HashDelay(11),
                       4, "exact", 0, "wave", device="cpu")
    assert pr.kernel.exact_impl == jr.kernel.exact_impl == "wave"
    # every JAX parameter in its position (A7 brought auto_layouts, the
    # 8th, so the tail is positional too); the port's device keyword-only
    assert _positional(BatchedRunner.__init__) == \
        _positional(JaxRunner.__init__)
    params = inspect.signature(BatchedRunner.__init__).parameters
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
    for name, p in inspect.signature(JaxRunner.__init__).parameters.items():
        assert params[name].default == p.default, name
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
    """The JAX package's top-level names import from the port, every one
    of them (``run_events`` and ``make_backend`` with the parity backend),
    each the port's own and equal in use: ``MAX_DELAY``, the event and
    snapshot types, ``__version__``."""
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
    assert missing == set()
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


# ---- A7: the config knobs, the constructors' keywords, run_events_file -----

def test_simconfig_fields_in_the_jax_order():
    """``SimConfig``'s fields are the JAX ones in the JAX order, with its
    defaults, so a positional call lands on the same fields."""
    import dataclasses

    fields = [f.name for f in dataclasses.fields(SimConfig)]
    assert fields == [f.name for f in dataclasses.fields(JaxSimConfig)]
    assert dataclasses.asdict(SimConfig()) == dataclasses.asdict(
        JaxSimConfig())
    args = (24, 4, 64, 5, 900, "int16", "uint16", "float32", "segsum",
            "dense", "pallas", "off", "on", 30, 2, 7, 16)
    assert dataclasses.asdict(SimConfig(*args)) == dataclasses.asdict(
        JaxSimConfig(*args))


@pytest.mark.parametrize("field, bad", [
    ("count_dtype", "int8"), ("reduce_mode", "sum"),
    ("comm_engine", "mesh"), ("kernel_engine", "cuda"),
    ("fused_tick", "yes"), ("fused_tile", "maybe"),
    ("window_dtype", "int16")])
def test_config_knobs_checked_as_jax(field, bad):
    """A knob's unknown spelling raises ValueError with the JAX message."""
    with pytest.raises(ValueError) as want:
        JaxSimConfig(**{field: bad})
    with pytest.raises(ValueError) as got:
        SimConfig(**{field: bad})
    assert str(got.value) == str(want.value)


def test_engine_knob_rows_are_the_jax_rows():
    """``config.ENGINE_KNOBS`` has every JAX row, ``memo`` and
    ``serve_policy`` included, in the JAX order with its spellings; the
    memo and serve-policy resolvers validate against them with the JAX
    messages."""
    from chandy_lamport_tpu import config as jax_config
    from chandy_lamport_tpu.serving import admission as jax_admission
    from chandy_lamport_tpu.utils import memocache as jax_memocache
    from chandy_lamport_tpu_torch.config import ENGINE_KNOBS
    from chandy_lamport_tpu_torch.serving import admission
    from chandy_lamport_tpu_torch.utils import memocache

    assert list(ENGINE_KNOBS.items()) == \
        list(jax_config.ENGINE_KNOBS.items())
    for mine, theirs, good in (
            (memocache.resolve_memo, jax_memocache.resolve_memo, "prefix"),
            (admission.resolve_serve_policy,
             jax_admission.resolve_serve_policy, "fifo")):
        assert mine(good) == theirs(good) == good
        with pytest.raises(ValueError) as want:
            theirs("auto")
        with pytest.raises(ValueError) as got:
            mine("auto")
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knob, values", [
    ("kernel_engine", ("auto", "xla", "pallas")),
    ("queue_engine", ("auto", "gather", "mask")),
    ("reduce_mode", ("auto", "matmul", "segsum")),
    ("count_dtype", ("auto", "bfloat16", "float32")),
    ("comm_engine", ("auto", "dense", "sparse"))])
def test_engine_knobs_resolve_to_the_port_engine(knob, values):
    """Every spelling of each knob is accepted, on the constructor or the
    config, and resolves to what the port runs with a reason naming the
    spelling; the storms are equal whichever is set."""
    spec = workloads.ring_topology(6)
    ends = []
    for value in values:
        ctor = {k: value for k in ("kernel_engine", "queue_engine")
                if k == knob}
        cfg = SimConfig(**{k: value for k in ("reduce_mode", "count_dtype",
                                              "comm_engine") if k == knob})
        r = BatchedRunner(spec, cfg, HashDelay(3), 2, device="cpu", **ctor)
        got, why = getattr(r.kernel, knob), getattr(r.kernel, f"{knob}_reason")
        if knob == "comm_engine":
            assert got == value
        else:
            assert got == {"kernel_engine": "plain", "queue_engine": "gather",
                           "reduce_mode": "segsum",
                           "count_dtype": "int32"}[knob]
            assert repr(value) in why
        prog = workloads.storm_program(r.topo, 4, 1, workloads.
                                       staggered_snapshots(r.topo, 1))
        ends.append(state_to_numpy(r.run_storm(r.init_batch_device(), prog)))
    for other in ends[1:]:
        _assert_states_equal(ends[0], other)


def test_bfloat16_counts_refused_as_jax():
    """A forced bfloat16 count past its exact degree bound raises the JAX
    ValueError on the matmul formulation its "auto" picks (a 300-node
    star's hub), not on "segsum"."""
    from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec

    nodes = [("H", 1)] + [(f"L{i}", 1) for i in range(300)]
    links = ([(f"L{i}", "H") for i in range(300)]
             + [("H", f"L{i}") for i in range(300)])
    spec = TopologySpec(nodes, links)
    from chandy_lamport_tpu.ops.tick import TickKernel as JaxTickKernel
    from chandy_lamport_tpu.core.state import DenseTopology as JaxTopo
    from chandy_lamport_tpu.utils.fixtures import TopologySpec as JaxSpec

    with pytest.raises(ValueError) as want:
        JaxTickKernel(JaxTopo(JaxSpec(nodes, links)),
                      JaxSimConfig(count_dtype="bfloat16"),
                      HashJaxDelay(1), "split")
    with pytest.raises(ValueError) as got:
        BatchedRunner(spec, SimConfig(count_dtype="bfloat16"), HashDelay(1),
                      2, scheduler="sync", device="cpu")
    assert str(got.value) == str(want.value)
    BatchedRunner(spec, SimConfig(count_dtype="bfloat16",
                                  reduce_mode="segsum"), HashDelay(1), 2,
                  scheduler="sync", device="cpu")


def test_fused_knobs_on_the_runners():
    """``fused_tick`` (constructor or config): "off" runs the megaticks
    as single ticks, equal to "auto"; "on" raises naming every unmet
    requirement; ``fused_tile`` "on" forces the workspace, "off" refuses
    a lane past shared memory under "on" (``resolve_fused``);
    ``fused_block_edges`` moves nothing and says so; ``auto_layouts``
    resolves to the one layout, labelled."""
    import torch

    from chandy_lamport_tpu_torch.kernels import megatick as km

    spec = workloads.ring_topology(6)
    ends = []
    for knob in ("off", "auto"):
        r = BatchedRunner(spec, SimConfig(fused_tick=knob), HashDelay(3), 2,
                          megatick=4, device="cpu", fused_block_edges=64)
        assert r.fused == "off" and "nothing moves" in \
            r.kernel.fused_block_edges_reason
        prog = workloads.storm_program(r.topo, 4, 1, workloads.
                                       staggered_snapshots(r.topo, 1))
        ends.append(state_to_numpy(r.run_storm(r.init_batch_device(), prog)))
    _assert_states_equal(*ends)
    with pytest.raises(ValueError) as exc:
        BatchedRunner(spec, None, HashDelay(3), 2, scheduler="sync",
                      device="cpu", fused_tick="on")
    assert "2 unmet" in str(exc.value) and "megatick=1" in str(exc.value)
    cuda = torch.device("cuda")
    assert km.resolve_fused(megatick=8, device=cuda, smem_bytes=100,
                            fused_tile="on")[2] == "on"
    with pytest.raises(ValueError, match="fused_tile='off'"):
        km.resolve_fused(megatick=8, device=cuda, smem_bytes=km.SMEM_BUDGET
                         + 1, fused_tick="on", fused_tile="off")
    assert km.resolve_fused(megatick=8, device=cuda, smem_bytes=km.
                            SMEM_BUDGET + 1, fused_tile="off")[0] == "off"
    r = BatchedRunner(spec, None, HashDelay(3), 2, "exact", 0, "cascade",
                      True, device="cpu")
    assert r.auto_layouts and r.layouts_effective == \
        "default(auto-unavailable)" and "row-major" in r.layouts_reason
    with pytest.raises(ValueError, match="fused_block_edges"):
        BatchedRunner(spec, None, HashDelay(3), 2, device="cpu",
                      fused_block_edges=-1)


def test_constructors_take_the_jax_keywords():
    """``DenseSim`` and ``BatchedRunner`` take every JAX keyword in the
    JAX position; ``guards`` (utils/guards.RuntimeGuards) arms the
    runner's stream loop with the JAX site books (the port's own lane-pass
    site aside); the resolutions are on the objects."""
    spec = workloads.ring_topology(4)
    sim = DenseSim(spec, HashDelay(1), None, "cascade", 4, "mask", "xla",
                   None, None, "off", 32, device="cpu")
    assert (sim.kernel.queue_engine, sim.kernel_engine, sim.fused) == (
        "gather", "plain", "off")
    assert "fused_tick='off'" in sim.fused_reason
    jnames = [p for p in inspect.signature(JaxDenseSim.__init__).parameters
              if p != "self"]
    mine = [{"delay": "delay_model"}.get(p, p)
            for p in inspect.signature(DenseSim.__init__).parameters
            if p not in ("self", "device")]
    assert mine == jnames
    from chandy_lamport_tpu.utils.guards import RuntimeGuards as JaxGuards
    from chandy_lamport_tpu_torch.utils.guards import RuntimeGuards

    jobs = workloads.stream_jobs(spec, 4, seed=2, max_phases=6)
    jspec = jax_workloads.ring_topology(4)
    books = []
    for runner in (JaxRunner(jspec, None, HashJaxDelay(1), 2,
                             guards=JaxGuards()),
                   BatchedRunner(spec, None, HashDelay(1), 2, device="cpu",
                                 guards=RuntimeGuards())):
        pool = runner.pack_jobs(jax_workloads.stream_jobs(
            jspec, 4, seed=2, max_phases=6) if isinstance(runner, JaxRunner)
            else jobs)
        runner.run_stream(pool, stretch=2, drain_chunk=8)
        books.append(runner.guards.books())
    want, got = books
    lane_pass = got["transfers"].pop("stream-lane-pass")
    assert got["transfers"] == want["transfers"]
    assert lane_pass == want["transfers"]["stream-termination-scalars"] - 1
    assert got["armed_regions"] == want["armed_regions"] == 1


def test_run_events_file_keywords_are_the_jax_ones():
    """``run_events_file``'s parameters are the JAX function's, with its
    defaults, ``backend`` in the JAX third position, plus the port's
    ``device``. The one pinned difference: the default backend is
    "torch" (the port's dense backend, on the card), where JAX's is
    "parity"."""
    mine = inspect.signature(api.run_events_file).parameters
    want = inspect.signature(jax_api.run_events_file).parameters
    assert set(mine) - {"device"} == set(want)
    assert list(mine)[:3] == list(want)[:3] == \
        ["top_path", "events_path", "backend"]
    assert (mine["backend"].default, want["backend"].default) == \
        ("torch", "parity")
    for name, p in want.items():
        if name not in ("backend", "top_path", "events_path"):
            assert mine[name].default == p.default, name


def test_stream_and_bench_take_uniform_and_uint16(capsys):
    """``stream --delay uniform`` prints the JAX CLI's row; ``bench
    --delay uniform --window-dtype uint16 --exact-impl fold`` runs a
    clean storm."""
    from chandy_lamport_tpu_torch import bench
    from chandy_lamport_tpu_torch.__main__ import stream_run

    flags = ["--graph", "ring", "--nodes", "8", "--batch", "4", "--jobs",
             "8", "--max-phases", "8", "--snapshots", "2", "--delay",
             "uniform", "--scheduler", "exact"]
    clock = ("wall_seconds", "jobs_per_sec", "effective_jobs_per_sec")
    assert jax_cli.main(["stream"] + flags) == 0
    want = _last_json(capsys.readouterr().out)
    assert stream_run(flags + ["--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert {k: v for k, v in got.items() if k not in clock} == \
        {k: v for k, v in want.items() if k not in clock}
    assert bench.main(["--device", "cpu", "--scheduler", "exact",
                       "--exact-impl", "fold", "--graph", "er", "--nodes",
                       "12", "--batch", "2", "--phases", "4", "--snapshots",
                       "2", "--repeats", "1", "--megatick", "4", "--delay",
                       "uniform", "--window-dtype", "uint16"]) == 0
    row = _last_json(capsys.readouterr().out)
    assert row["error_bits"] == 0 and row["scheduler"] == "exact/fold"
    assert row["delay"] == "uniform"
