"""The port's serve loop on the exact scheduler at megatick 8 (the fused
megatick's plain form on the CPU: its gated stream drain), against the
JAX package's ``serve_run``, on the CPU.

The JAX ``tests/test_serving.py`` shape (ring-8, hash delay 11, J = 12
over B = 4, 3 tenants, stretch 3, drain chunk 16) on ``scheduler=
"exact", megatick=8``: edf, fifo under quotas, a warm summary cache and
the memo plane's "prefix" fork, each equal to the JAX run leaf for leaf
(rows less the digest value, the report less timing); the kill drill
(killed after its first save) resumed in the other package, both ways,
to the uninterrupted JAX run's leaves; and a traced serve under tight
deadlines whose rings hold the JAX EV_SERVE_ADMIT and EV_SERVE_MISS
records (every ring leaf equal). Tolerance: none (integer state).
"""

import jax
import numpy as np
import pytest

from chandy_lamport_tpu import serving as jax_serving
from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.ops.delay_jax import make_fast_delay
from chandy_lamport_tpu.parallel.batch import BatchedRunner as JaxRunner
from chandy_lamport_tpu.utils import checkpoint as jax_ckpt
from chandy_lamport_tpu.utils.tracing import JaxTrace
from chandy_lamport_tpu_torch import serving
from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.parallel.batch import BatchedRunner
from chandy_lamport_tpu_torch.utils.carry import (
    state_to_numpy,
    stream_to_numpy,
)
from chandy_lamport_tpu_torch.utils.checkpoint import load_state
from chandy_lamport_tpu_torch.utils.tracing import (
    EV_SERVE_ADMIT,
    EV_SERVE_MISS,
    Trace,
    decode_trace,
)
from test_torch_serving import (
    CFG8,
    J,
    STEP,
    TENANTS,
    _requests,
    assert_serve_equal,
)

B, MEGATICK = 4, 8
QUOTAS = [3, 0, 2]


def _runners(trace=False, **kw):
    """A JAX and a port runner: ring-8, exact at megatick 8."""
    cfg = dict(CFG8, split_markers=False)
    jr = JaxRunner(jax_workloads.ring_topology(8),
                   JaxSimConfig.for_workload(**cfg),
                   make_fast_delay("hash", 11), B, scheduler="exact",
                   megatick=MEGATICK, trace=JaxTrace() if trace else None,
                   **kw)
    pr = BatchedRunner(workloads.ring_topology(8),
                       SimConfig.for_workload(**cfg), HashDelay(11), B,
                       scheduler="exact", megatick=MEGATICK, device="cpu",
                       trace=Trace() if trace else None, **kw)
    return jr, pr


@pytest.fixture(scope="module")
def exact_pair():
    jr, pr = _runners()
    return jr, jax_serving.ExecutableCache(None), pr, \
        serving.ExecutableCache(None)


@pytest.mark.parametrize("policy,quotas", [("edf", None),
                                           ("fifo", QUOTAS)],
                         ids=["edf", "fifo-quotas"])
def test_exact_serve_equals_jax(exact_pair, policy, quotas):
    """edf, and fifo under quotas: leaf-equal to the JAX serve, every
    accepted request served, the drain through row 8's plain form."""
    jr, jec, pr, pec = exact_pair
    jreq, preq = _requests()
    jout = jax_serving.serve_run(jr, jreq, policy=policy, quotas=quotas,
                                 exec_cache=jec, **STEP)
    pout = serving.serve_run(pr, preq, policy=policy, quotas=quotas,
                             exec_cache=pec, **STEP)
    assert_serve_equal(jr, jout, pr, pout)
    rep = pout[2]
    assert rep["served_total"] == J - rep["refused_total"]
    assert pr.fused == "off" and pr.megatick == MEGATICK


def test_exact_serve_on_a_warm_cache_equals_jax(tmp_path):
    """Under quotas on a summary-cache file the first serve warmed, the
    second serve of each package takes every accepted digest from the
    file; equal to the JAX run."""
    jreq, preq = _requests()
    outs = {}
    for pkg in ("jax", "port"):
        cache = str(tmp_path / f"{pkg}.jsonl")
        for _ in range(2):
            jr, pr = _runners(memo_cache=cache)
            r, reqs, mod = ((jr, jreq, jax_serving) if pkg == "jax"
                            else (pr, preq, serving))
            outs[pkg] = (r, mod.serve_run(r, reqs, quotas=QUOTAS, **STEP))
    (jr, jout), (pr, pout) = outs["jax"], outs["port"]
    assert_serve_equal(jr, jout, pr, pout)
    assert pout[2]["exec_jobs"] == 0 and pout[2]["served_cache"] > 0


def test_exact_serve_under_prefix_memo_equals_jax():
    """The runner's memo "prefix": the serve step takes the fork operands
    (bank, fork_src, fork_depth); equal to the JAX run."""
    jr, pr = _runners(memo="prefix")
    jreq, preq = _requests(count=16, seed=5, dup_rate=0.5)
    jout = jax_serving.serve_run(jr, jreq, **STEP)
    pout = serving.serve_run(pr, preq, **STEP)
    assert_serve_equal(jr, jout, pr, pout)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exact_serve_killed_resumes_across_packages(exact_pair, writer,
                                                    tmp_path):
    """edf with quotas, checkpointed every 3 steps and killed after its
    first save by one package: the file (format 10 with the serving
    leaves) resumes in both packages; the two resumed runs are equal
    (report less timing), and their carry and rows equal the
    uninterrupted runs' (the admit percentiles restart on resume), which
    equal each other."""
    jr, jec, pr, pec = exact_pair
    jreq, preq = _requests()
    kw = dict(quotas=QUOTAS, **STEP)
    whole = jax_serving.serve_run(jr, jreq, exec_cache=jec, **kw)
    assert_serve_equal(jr, whole, pr, serving.serve_run(
        pr, preq, exec_cache=pec, **kw))
    path = str(tmp_path / f"{writer}.npz")
    kill = dict(checkpoint=path, checkpoint_every=3, kill_after_saves=1)
    if writer == "jax":
        rep = jax_serving.serve_run(jr, jreq, exec_cache=jec, **kw,
                                    **kill)[2]
    else:
        rep = serving.serve_run(pr, preq, exec_cache=pec, **kw, **kill)[2]
    assert rep["killed"] and rep["steps"] == 3
    quota = np.asarray(QUOTAS, np.int32)
    ppool = pr.pack_jobs([r.events for r in preq], content_keys=True)
    (ps, pst), pmeta = load_state(
        path, (pr.init_batch_device(),
               pr.init_stream(ppool, tenants=TENANTS, tenant_quota=quota)),
        delay=pr.delay)
    jpool = jr.pack_jobs([r.events for r in jreq], content_keys=True)
    (js, jst), jmeta = jax_ckpt.load_state(
        path, (jr.init_batch(),
               jr.init_stream(jpool, tenants=TENANTS, tenant_quota=quota)))
    assert pmeta == jmeta and pmeta["stream_steps"] == 3
    assert pmeta["serve_schema"] == serving.SERVE_SCHEMA_VERSION
    assert int(pst.jobs_done) < int(whole[1].jobs_done)
    jres = jax_serving.serve_run(jr, jreq, state=js, stream=jst,
                                 exec_cache=jec, **kw)
    pres = serving.serve_run(pr, preq, state=ps, stream=pst,
                             exec_cache=pec, **kw)
    assert_serve_equal(jr, jres, pr, pres)
    assert_serve_equal(jr, (whole[0], whole[1], pres[2]), pr,
                       (pres[0], pres[1], pres[2]))


def test_traced_serve_records_the_jax_serve_events():
    """A traced serve under tight deadlines (slack 1-3 steps at rate 2):
    every ring leaf equals the JAX run's, and the rings hold
    EV_SERVE_ADMIT and EV_SERVE_MISS records."""
    jr, pr = _runners(trace=True)
    jreq, preq = _requests(count=16, seed=7, rate=2.0,
                           deadline_slack=(1, 3))
    jout = jax_serving.serve_run(jr, jreq, **STEP)
    pout = serving.serve_run(pr, preq, **STEP)
    assert_serve_equal(jr, jout, pr, pout)
    assert pout[2]["deadline_misses"] > 0
    kinds = {ev.kind for lane in range(B)
             for ev in decode_trace(pout[0], lane)}
    assert {EV_SERVE_ADMIT, EV_SERVE_MISS} <= kinds
    assert stream_to_numpy(pout[1]).deadline_misses == \
        pout[2]["deadline_misses"]
