"""The port's serving fleet (``chandy_lamport_tpu_torch/serving/fleet.py``)
against the JAX package's, on the CPU.

The JAX ``tests/test_fleet.py`` cases on the port: the host logic (shed
ordering, exit provenance, recipes, the burst and crash-schedule
generators, each against the JAX function), the worker loop in-process
(the null executor, a reclaimed lease's late commit, the identity with a
solo ``run_stream``, the shared summary cache), ``fleet_run`` with one
spawned null worker, zero workers refused, and the shed before spawn.
Then the port's ``worker_serve`` against the JAX ``worker_serve`` on the
same requests in-process (ring-8, B = 2, the sync scheduler and the exact
cascade): equal committed summaries, less the digest's value (the port's
digests hash the port's knobs, tests/test_torch_memo.py). Then the chaos
trio of the JAX ``tools/chaos_smoke.py`` with spawned workers on
``device="cpu"``: a worker killed on leasing a job is taken over with
nothing lost or double-served and every summary equal to a solo run; a
job that kills every holder is poisoned with one provenance entry per
attempt; the shed victims equal the JAX ``shed_order``'s prediction.
The spawned tests keep to ring-8, B = 2 and at most two workers.
Tolerance: none (integer summaries).
"""

import dataclasses
import os
import signal

import pytest

from chandy_lamport_tpu.core import spec as jax_spec
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.serving import admission as jax_admission
from chandy_lamport_tpu.serving import fleet as jax_fleet
from chandy_lamport_tpu.serving.spool import AdmissionSpool as JaxSpool
from chandy_lamport_tpu_torch.core.spec import (
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.models.workloads import (
    ServeRequest,
    burst_workload,
    crash_schedule,
    ring_topology,
    serve_workload,
)
from chandy_lamport_tpu_torch.serving import (
    AdmissionSpool,
    fleet_run,
    recipe_runner,
    worker_serve,
)
from chandy_lamport_tpu_torch.serving.admission import (
    order_eligible,
    shed_order,
)
from chandy_lamport_tpu_torch.serving.fleet import _exit_provenance

RECIPE = {"kind": "ring-stream", "n": 8, "tokens": 16, "snapshots": 2,
          "max_recorded": 32, "batch": 2, "scheduler": "sync"}


def _req(job, arrival=0, tenant=0, priority=1, slack=32, tokens=2):
    return ServeRequest(
        job=job, arrival_step=arrival, tenant=tenant, priority=priority,
        deadline_step=arrival + slack,
        events=[PassTokenEvent(src="N1", dest="N2", tokens=tokens),
                SnapshotEvent(node_id="N3"), TickEvent(4)])


def _jreq(job, arrival=0, tenant=0, priority=1, slack=32, tokens=2):
    return jax_workloads.ServeRequest(
        job=job, arrival_step=arrival, tenant=tenant, priority=priority,
        deadline_step=arrival + slack,
        events=[jax_spec.PassTokenEvent(src="N1", dest="N2", tokens=tokens),
                jax_spec.SnapshotEvent(node_id="N3"),
                jax_spec.TickEvent(4)])


def _solo_rows(runner, reqs, results):
    """Each served summary against a solo singleton ``run_stream`` of its
    request: returns the jobs whose summaries differ."""
    bad = []
    for j, row in results.items():
        pool = runner.pack_jobs([reqs[int(j)].events], content_keys=True)
        _, stream = runner.run_stream(pool, stretch=2, drain_chunk=8)
        (solo,) = runner.stream_results(stream)
        solo = {k: v for k, v in solo.items()
                if k not in ("job", "admit_step")}
        got = {k: v for k, v in row.items()
               if k not in ("digest", "served_from")}
        if got != solo:
            bad.append(j)
    return bad


# ---- host logic -----------------------------------------------------------

class TestHostLogic:
    def test_shed_order_drops_least_urgent_first(self):
        reqs = [ServeRequest(0, 0, 0, 1, 100, []),
                ServeRequest(1, 0, 0, 0, 50, []),
                ServeRequest(2, 0, 0, 0, 90, []),
                ServeRequest(3, 5, 0, 0, 90, [])]
        assert [r.job for r in shed_order(reqs)] == [3, 2, 1, 0]

    def test_shed_order_mirrors_edf_admission(self):
        reqs = serve_workload(ring_topology(4), 8, seed=5, priorities=3)
        shed = [r.job for r in shed_order(reqs)]
        admit = [r.job for r in order_eligible(reqs, "edf")]
        assert shed[0] != admit[0]
        assert sorted(shed) == sorted(admit)
        jreqs = jax_workloads.serve_workload(jax_workloads.ring_topology(4),
                                             8, seed=5, priorities=3)
        assert shed == [r.job for r in jax_admission.shed_order(jreqs)]

    def test_recipe_runner_null_forms(self):
        assert recipe_runner(None) is None
        assert recipe_runner({}) is None
        assert recipe_runner({"kind": "null"}, device="cpu") is None
        with pytest.raises(ValueError, match="unknown worker recipe"):
            recipe_runner({"kind": "warp-drive"}, device="cpu")

    def test_recipe_runner_builds_the_jax_engine(self):
        """A ring-stream recipe builds the JAX recipe's runner: the same
        topology, config, sampler, batch and scheduler, on the device
        named."""
        pr = recipe_runner(RECIPE, device="cpu")
        jr = jax_fleet.recipe_runner(RECIPE)
        assert pr.device.type == "cpu" and pr.batch == jr.batch == 2
        assert pr.scheduler == jr.scheduler == "sync"
        assert (pr.topo.n, pr.topo.e) == (jr.topo.n, jr.topo.e)
        assert (pr.topo.tokens0 == jr.topo.tokens0).all()
        assert dataclasses.asdict(pr.config) == \
            dataclasses.asdict(jr.config)
        assert pr.config.max_recorded == 32
        assert type(pr.delay).__name__ == "HashDelay"
        assert pr.memo == "off" and pr.memo_cache_path is None

    def test_exit_provenance_decodes_signals(self):
        assert "SIGKILL" in _exit_provenance(-int(signal.SIGKILL))
        assert _exit_provenance(0) == "exited with code 0"
        assert _exit_provenance(None) == "still running"
        assert "signal 250" in _exit_provenance(-250)
        for code in (-int(signal.SIGKILL), -250, 0, 3, None):
            assert _exit_provenance(code) == \
                jax_fleet._exit_provenance(code)

    def test_burst_workload_keeps_clock_and_slack(self):
        spec = ring_topology(4)
        base = serve_workload(spec, 12, seed=7, rate=1.0)
        burst = burst_workload(spec, 12, seed=7, rate=1.0,
                               burst_period=16, burst_factor=8.0)
        arrivals = [r.arrival_step for r in burst]
        assert arrivals == sorted(arrivals)
        for b, o in zip(burst, base):
            assert b.events == o.events
            assert (b.deadline_step - b.arrival_step
                    == o.deadline_step - o.arrival_step)
        gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
        assert min(gaps) == 0 or min(gaps) < max(gaps)

    def test_crash_schedule(self):
        assert crash_schedule(3, 2.0, start_s=1.0) == [1.0, 3.0, 5.0]
        assert crash_schedule(0, 2.0) == []
        for args in ((3, 2.0, 1.0), (2, 0.5, 4.0), (0, 1.0, 0.0)):
            assert crash_schedule(*args) == \
                jax_workloads.crash_schedule(*args)
        for bad in ((-1, 1.0), (1, 0.0)):
            with pytest.raises(ValueError):
                crash_schedule(*bad)


# ---- the worker loop, in-process ------------------------------------------

@pytest.fixture(scope="module")
def sync_runner():
    return recipe_runner(RECIPE, device="cpu")


class TestWorkerLoop:
    def test_null_worker_serves_everything(self, tmp_path):
        spool = AdmissionSpool(str(tmp_path / "wal.jsonl"))
        for j in range(5):
            spool.admit(_req(j, arrival=j))
        books = worker_serve("w0", spool, None, lease_limit=2,
                             max_wall_s=30)
        assert books["served"] == 5 and books["leased"] == 5
        assert books["late_rejected"] == 0
        assert spool.finished()
        assert spool.results()[0]["served_from"] == "null"
        assert set(books["launches"].values()) == {0}

    def test_reclaimed_lease_result_is_discarded(self, tmp_path):
        spool = AdmissionSpool(str(tmp_path / "wal.jsonl"), lease_ttl=5.0)
        spool.admit(_req(0))
        spool.lease("w-slow", limit=1, now=0.0)
        spool.reclaim_expired(now=10.0)
        spool.lease("w-takeover", limit=1, now=11.0)
        assert spool.complete(0, "w-takeover", {"t": 1}, now=12.0)
        assert spool.complete(0, "w-slow", {"t": 1}, now=13.0) is False
        assert spool.done_by[0] == "w-takeover"

    def test_inprocess_worker_equals_solo(self, tmp_path, sync_runner):
        reqs = [_req(j, arrival=j, tokens=j + 1) for j in range(3)]
        spool = AdmissionSpool(str(tmp_path / "wal.jsonl"))
        for r in reqs:
            spool.admit(r)
        books = worker_serve("w0", spool, sync_runner, lease_limit=2,
                             max_wall_s=60)
        assert books["served"] == 3 and spool.finished()
        assert _solo_rows(sync_runner, reqs, spool.results()) == []
        assert {r["served_from"] for r in spool.results().values()} == \
            {"fleet-exec"}

    def test_duplicate_content_served_from_shared_cache(self, tmp_path):
        runner = recipe_runner({**RECIPE,
                                "memo_cache": str(tmp_path / "memo.jsonl")},
                               device="cpu")
        reqs = [_req(0, tokens=7), _req(1, tokens=7)]
        spool = AdmissionSpool(str(tmp_path / "wal.jsonl"))
        spool.admit(reqs[0])
        b0 = worker_serve("w0", spool, runner, lease_limit=1, max_wall_s=60)
        spool.admit(reqs[1])
        b1 = worker_serve("w1", spool, runner, lease_limit=1, max_wall_s=60)
        assert b0["cache_served"] == 0 and b1["cache_served"] == 1
        res = spool.results()
        assert res[0]["served_from"] == "fleet-exec"
        assert res[1]["served_from"] == "fleet-cache"
        a = {k: v for k, v in res[0].items() if k != "served_from"}
        b = {k: v for k, v in res[1].items() if k != "served_from"}
        assert a == b


@pytest.mark.parametrize("scheduler", ["sync", "exact"])
def test_worker_serve_commits_the_jax_summaries(tmp_path, scheduler):
    """The port's ``worker_serve`` and the JAX ``worker_serve``, each on
    its own spool over the same requests (a duplicate among them, served
    from each package's shared summary cache), commit equal summaries
    (less the digest's value) with equal books and provenance."""
    recipe = {**RECIPE, "scheduler": scheduler}
    jobs = [(0, 0, 1), (1, 1, 3), (2, 2, 1), (3, 3, 2)]
    out = {}
    for name, make_req, fleet_mod, spool_cls, kw in (
            ("jax", _jreq, jax_fleet, JaxSpool, {}),
            ("port", _req, None, AdmissionSpool, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        spool = spool_cls(str(d / "wal.jsonl"))
        reqs = [make_req(j, arrival=a, tokens=t) for j, a, t in jobs]
        for r in reqs:
            spool.admit(r)
        full = {**recipe, "memo_cache": str(d / "memo.jsonl")}
        if fleet_mod is None:
            runner = recipe_runner(full, **kw)
            books = worker_serve("w0", spool, runner, lease_limit=2,
                                 max_wall_s=120)
        else:
            runner = fleet_mod.recipe_runner(full)
            books = fleet_mod.worker_serve("w0", spool, runner,
                                           lease_limit=2, max_wall_s=120)
        books.pop("launches", None)
        out[name] = (books, spool.results())
    (jbooks, jres), (pbooks, pres) = out["jax"], out["port"]
    assert pbooks == jbooks
    assert pbooks["cache_served"] == 1 and pbooks["served"] == 4

    def strip(res):
        return {j: {k: ("<digest>" if k == "digest" else v)
                    for k, v in row.items()} for j, row in res.items()}

    assert strip(pres) == strip(jres)
    # the duplicate shares its leader's digest in both packages
    assert pres[0]["digest"] == pres[2]["digest"]
    assert jres[0]["digest"] == jres[2]["digest"]


# ---- fleet_run, spawned ---------------------------------------------------

class TestFleetRun:
    def test_one_null_worker_fleet(self, tmp_path):
        reqs = [_req(j, arrival=j) for j in range(4)]
        rep = fleet_run(reqs, spool_path=str(tmp_path / "wal.jsonl"),
                        workers=1, recipe=None, lease_ttl=5.0,
                        max_wall_s=60)
        assert rep["served"] == 4 and rep["goodput"] == 1.0
        assert rep["audit"]["lost"] == 0
        assert rep["audit"]["double_served"] == 0
        assert rep["books"]["worker_deaths"] == 0
        assert not rep["timed_out"]
        assert rep["serve_schema"] >= 1
        assert rep["lat_p50_s"] is not None
        assert rep["device"] is None
        (wb,) = rep["worker_books"]
        assert wb["worker"] == "w0i0" and wb["served"] == 4
        assert wb["device"] is None

    def test_rejects_zero_workers(self, tmp_path):
        with pytest.raises(ValueError, match="workers"):
            fleet_run([], spool_path=str(tmp_path / "w.jsonl"), workers=0)

    def test_recipe_fleet_resolves_the_card_first(self, tmp_path,
                                                  monkeypatch):
        """Without CUDA and without a device, a recipe fleet raises in the
        supervisor, before it admits or spawns anything."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        path = tmp_path / "w.jsonl"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fleet_run([_req(0)], spool_path=str(path), workers=1,
                      recipe=RECIPE)
        assert not path.exists()

    def test_shed_happens_before_spawn(self, tmp_path):
        reqs = serve_workload(ring_topology(4), 8, seed=3, rate=4.0,
                              priorities=3)
        rep = fleet_run(reqs, spool_path=str(tmp_path / "wal.jsonl"),
                        workers=1, recipe=None, shed_backlog=3,
                        max_wall_s=60)
        victims = sorted(r.job for r in shed_order(reqs)[:5])
        assert sorted(int(j) for j in rep["shed"]) == victims
        assert rep["served"] == 3
        assert rep["books"]["shed"] == 5


# ---- the chaos trio (tools/chaos_smoke.py's fleet scenarios) ---------------

SEED = 0


def _chaos_requests(pkg, count, seed, rate):
    return pkg.serve_workload(pkg.ring_topology(8, tokens=16), count,
                              seed=seed, rate=rate, tenants=2, priorities=3,
                              max_phases=4, deadline_slack=(8, 64))


def test_chaos_kill_takeover(tmp_path):
    """Two spawned workers on the CPU; the first to lease job 2 is
    SIGKILLed (once, fleet-wide). The lease is taken over, nothing is
    lost or double-served, and every summary equals a solo run."""
    reqs = _chaos_requests(workloads, 5, SEED + 8, 2.0)
    recipe = {**RECIPE, "memo_cache": str(tmp_path / "memo.jsonl")}
    counter = str(tmp_path / "kills")
    rep = fleet_run(reqs, spool_path=str(tmp_path / "takeover.jsonl"),
                    workers=2, recipe=recipe, lease_ttl=3.0, lease_limit=2,
                    chaos={"kill_on_job": 2, "kill_limit": 1,
                           "counter_path": counter},
                    restart_backoff=0.2, max_wall_s=120, device="cpu")
    audit = rep["audit"]
    assert rep["served"] == len(reqs) and not rep["timed_out"]
    assert audit["lost"] == 0 and audit["double_served"] == 0
    assert audit["digests_ok"]
    assert rep["books"]["worker_deaths"] >= 1
    assert rep["books"]["takeovers"] >= 1
    with open(counter, encoding="utf-8") as f:
        assert int(f.read().strip()) == 1
    solo = recipe_runner(RECIPE, device="cpu")
    assert _solo_rows(solo, reqs, rep["results"]) == []
    assert rep["device"] == "cpu"
    assert {wb["device"] for wb in rep["worker_books"]} == {"cpu"}


def test_chaos_poison_quarantine(tmp_path):
    """Every holder of job 1 is SIGKILLed (null executor): after its two
    attempts it is poisoned with one SIGKILL provenance entry each, and
    everything else is served."""
    reqs = _chaos_requests(workloads, 5, SEED + 8, 2.0)
    rep = fleet_run(reqs, spool_path=str(tmp_path / "poison.jsonl"),
                    workers=2, recipe=None, lease_ttl=0.5, max_attempts=2,
                    lease_limit=1,
                    chaos={"kill_on_job": 1, "kill_limit": 99,
                           "counter_path": str(tmp_path / "kills")},
                    restart_backoff=0.1, max_wall_s=60)
    poisoned = {int(k): v for k, v in rep["poisoned"].items()}
    assert sorted(poisoned) == [1]
    assert len(poisoned[1]["errors"]) == 2
    assert all("SIGKILL" in e for e in poisoned[1]["errors"])
    assert rep["served"] == len(reqs) - 1
    assert rep["audit"]["lost"] == 0
    assert rep["audit"]["double_served"] == 0
    assert rep["books"]["worker_deaths"] >= 2


def test_chaos_shed_victims_are_the_jax_prediction(tmp_path):
    """Six requests against one worker whose backlog capacity is two: the
    four victims are the JAX ``shed_order``'s prediction on the JAX
    package's copy of the requests, shed at admission."""
    reqs = _chaos_requests(workloads, 6, SEED + 9, 4.0)
    jreqs = _chaos_requests(jax_workloads, 6, SEED + 9, 4.0)
    rep = fleet_run(reqs, spool_path=str(tmp_path / "shed.jsonl"),
                    workers=1, recipe=None, lease_ttl=2.0, shed_backlog=2,
                    max_wall_s=60)
    victims = sorted(r.job for r in jax_admission.shed_order(jreqs)[:4])
    shed = sorted(int(k) for k in rep["shed"])
    assert shed == victims
    assert rep["served"] == len(reqs) - len(victims)
    assert rep["served"] + len(shed) == len(reqs)
    assert rep["audit"]["lost"] == 0
    assert os.path.exists(str(tmp_path / "shed.jsonl"))


# ---- the kernels' build across processes ----------------------------------

FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
time.sleep(0.5)                      # a window for the others to race
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(os.path.basename(sys.argv[-1]) + "\\n")
with open(out, "wb") as f:
    f.write(b"not a library")
"""

BUILD_CHILD = """
import sys
sys.path.insert(0, {root!r})
from chandy_lamport_tpu_torch.kernels import _build
_build.BUILD_DIR = {build!r}
_build._build_all()
print(_build.builds)
"""


def test_kernel_build_runs_nvcc_once_across_processes(tmp_path):
    """Four processes that start together on a cold build directory (the
    fleet's workers) run nvcc once between them: one process builds every
    source, the others wait on the directory's lock, find the targets and
    count no build. nvcc is stubbed by a script on PATH."""
    import subprocess
    import sys

    from chandy_lamport_tpu_torch.kernels import _build

    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    build = str(tmp_path / "build")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PATH": f"{bindir}{os.pathsep}{os.environ['PATH']}",
           "FAKE_NVCC_LOG": str(log)}
    code = BUILD_CHILD.format(root=root, build=build)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    builds = sorted(int(out.strip()) for out, _ in outs)
    assert builds == [0, 0, 0, len(_build.SOURCES)]
    compiled = log.read_text().split()
    assert sorted(compiled) == sorted(f"{n}.cu" for n in _build.SOURCES)
    assert sorted(os.listdir(build)) == sorted(
        [os.path.basename(_build._target(n)) for n in _build.SOURCES]
        + ["nvcc.lock"])
