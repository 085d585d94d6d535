"""The port's memo "prefix" plane against the JAX package's, on the CPU:
the rolling phase-boundary digest chains, the prefix-checkpoint store
(``PrefixCache``), ``fork_lanes``, and the fork itself.

Held to the JAX package in-process: which chain links jobs share (the
values hash the port's own knobs), the store's LRU by entries and bytes,
its heat rule and schema refusal, its file crossing between the packages
both ways (checkpoint leaves in the JAX dtypes), ``fork_lanes`` leaf for
leaf, and ``run_stream`` under "prefix" — two drives on one store file,
then the store cut to one entry so that evicted prefixes fall back to
cold admission — with every leaf of the final state and stream equal to
the JAX run's and every row equal except the ``digest`` value. A
tampered checkpoint is refused by the fork audit (PrefixCacheError), and
the recorder stamps EV_PREFIX_FORK. Tolerance: none (integer state).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.config import SimConfig as JaxSimConfig
from chandy_lamport_tpu.core.state import DenseState as JaxDenseState
from chandy_lamport_tpu.models import workloads as jax_workloads
from chandy_lamport_tpu.ops import tick as jax_tick
from chandy_lamport_tpu.ops.delay_jax import make_fast_delay
from chandy_lamport_tpu.parallel import batch as jax_batch
from chandy_lamport_tpu.utils import memocache as jax_memocache
from chandy_lamport_tpu.utils.tracing import JaxTrace
from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
from chandy_lamport_tpu_torch.core.spec import PassTokenEvent, TickEvent
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.ops.tick import fork_lanes
from chandy_lamport_tpu_torch.utils import memocache
from chandy_lamport_tpu_torch.utils.carry import (
    state_from_numpy,
    state_to_numpy,
    stream_to_numpy,
)
from chandy_lamport_tpu_torch.utils.tracing import (
    EV_PREFIX_FORK,
    Trace,
    decode_trace,
)
from test_torch_stream import _assert_leaves_equal, _port_job

# the JAX tests/test_prefix.py shapes: ring-8 of 16 tokens, S=2, hash
# delay 7, B=2 lanes at megatick 2 (the port's sync scheduler refuses a
# megatick, which the JAX one ignores: 1 there)
SPEC_ARGS = dict(tokens=16)
CFG = dict(snapshots=2, max_recorded=32)
RUN = dict(stretch=2, drain_chunk=8)


def _pair(memo="prefix", delay_seed=7, scheduler="sync", trace=False,
          batch=2, **kw):
    jr = jax_batch.BatchedRunner(
        jax_workloads.ring_topology(8, **SPEC_ARGS),
        JaxSimConfig.for_workload(**CFG), make_fast_delay("hash",
                                                          delay_seed),
        batch, scheduler=scheduler, megatick=2, memo=memo,
        trace=JaxTrace() if trace else None, **kw)
    pr = BatchedRunner(
        workloads.ring_topology(8, **SPEC_ARGS),
        SimConfig.for_workload(**CFG), HashDelay(delay_seed), batch,
        scheduler=scheduler, megatick=2 if scheduler == "exact" else 1,
        memo=memo, device="cpu",
        trace=Trace() if trace else None, **kw)
    return jr, pr


def _links(pool):
    """Each job's chain links as bytes."""
    chains = np.asarray(pool.prefix_digest)
    starts, ends = np.asarray(pool.job_start), np.asarray(pool.job_end)
    return [[bytes(chains[r]) for r in range(int(a), int(b))]
            for a, b in zip(starts, ends)]


def _sharing(links):
    """Which (job, depth) pairs share a link: the chains' structure,
    independent of the digest values."""
    first: dict = {}
    return [[first.setdefault(link, (j, d)) for d, link in enumerate(chain)]
            for j, chain in enumerate(links)]


def _node(i):
    return sorted({s for s, _ in workloads.ring_topology(8).links})[i]


def _jobs(count=6, seed=9):
    return jax_workloads.stream_jobs(
        jax_workloads.ring_topology(8, **SPEC_ARGS), count, seed=seed,
        base_phases=2, max_phases=5, prefix_overlap=0.5)


# ---- the chains ------------------------------------------------------------------

def test_chains_align_diverge_and_share_as_jax():
    """B extends A by a phase, C duplicates A: B's chain shares A's links
    and diverges right after; C shares A's whole chain and digest; the
    near-duplicates share their first-phase stream identity; and on a
    prefix-overlap queue the links jobs share are the JAX chains'."""
    a = [PassTokenEvent(_node(0), _node(1), 1), TickEvent(1)]
    b = a + [PassTokenEvent(_node(1), _node(2), 1), TickEvent(1)]
    _, pr = _pair()
    pool = pr.pack_jobs([a, b, list(a)])
    assert pool.prefix_digest.shape == (pool.kind.shape[0], 32)
    ca, cb, cc = _links(pool)
    assert all(any(link) for link in ca + cb + cc)
    assert cb[:len(ca)] == ca and cb[len(ca)] not in ca and cc == ca
    assert torch.equal(pool.digest[2], pool.digest[0])
    for w in pool.delay_state:
        assert torch.equal(w[0], w[1])
    jr, pr = _pair()
    jobs = _jobs(12, seed=5)
    want = jr.pack_jobs(jobs)
    got = pr.pack_jobs([_port_job(j) for j in jobs])
    assert _sharing(_links(got)) == _sharing(_links(want))
    assert len({link for chain in _links(got) for link in chain}) < sum(
        len(chain) for chain in _links(got))


def test_chains_reseed_on_identity_change():
    """The same script under another scheduler or delay seed shares no
    link of its chain."""
    a = [PassTokenEvent(_node(0), _node(1), 1), TickEvent(1)]
    base = _links(_pair()[1].pack_jobs([a]))[0]
    for kw in (dict(scheduler="exact"), dict(delay_seed=8)):
        rows = _links(_pair(**kw)[1].pack_jobs([a]))[0]
        assert not set(rows) & set(base)


# ---- the store -----------------------------------------------------------------------

def _leaves(v):
    return {"tokens": np.full((8,), v, np.int32),
            "nested": (np.arange(4, dtype=np.uint32), np.int16(-v))}


def test_prefix_cache_lru_heat_and_schema(tmp_path):
    """Insertion order is eviction order under the byte bound (counted),
    ``get_ckpt`` refreshes recency and ``bump_seen`` heat does not
    outcompete a checkpoint; flush and reload round-trip the leaves;
    a schema from another build is refused with the JAX message."""
    path = str(tmp_path / "prefix.jsonl")
    probe = memocache.PrefixCache(None)
    probe.put_ckpt("a" * 64, 1, _leaves(1))
    line = probe._line_bytes("a" * 64, probe._entries["a" * 64])
    cache = memocache.PrefixCache(path, max_bytes=2 * line + line // 2)
    for i, dg in enumerate(("a" * 64, "b" * 64, "c" * 64)):
        cache.put_ckpt(dg, i + 1, _leaves(i))
    assert "a" * 64 not in cache and cache.evictions == 1
    assert cache.evicted_bytes >= line
    depth, leaves = cache.get_ckpt("b" * 64)
    assert depth == 2 and np.array_equal(leaves["tokens"],
                                          _leaves(1)["tokens"])
    cache.put_ckpt("d" * 64, 4, _leaves(3))
    assert "c" * 64 not in cache and "b" * 64 in cache
    cache.flush()
    back = memocache.PrefixCache(path)
    _, got = back.get_ckpt("d" * 64)
    assert got["nested"][1] == np.int16(-3)
    assert got["nested"][0].dtype == np.uint32
    heat = memocache.PrefixCache(None, max_bytes=line + line // 2)
    heat.put_ckpt("a" * 64, 1, _leaves(1))
    heat.bump_seen("b" * 64, 2)
    heat.bump_seen("c" * 64, 2)
    assert heat.has_ckpt("a" * 64)
    with open(path, encoding="utf-8") as f:
        entries = [json.loads(x) for x in f.read().splitlines()]
    entries[0]["schema"] = memocache.PREFIXCACHE_SCHEMA_VERSION + 1
    with open(path, "w", encoding="utf-8") as f:
        f.write("".join(json.dumps(e) + "\n" for e in entries))
    for module in (memocache, jax_memocache):
        with pytest.raises(module.PrefixCacheError, match="schema version"):
            module.PrefixCache(path)


def test_prefix_store_files_cross(tmp_path):
    """A store flushed by either package loads in the other with every
    leaf, dtype and seen count, and the two packages' files of the same
    entries are byte-equal; a JAX flush merges the port's checkpoint
    over its own seen-only entry (the merge rule)."""
    files = {}
    for name, module in (("port", memocache), ("jax", jax_memocache)):
        path = str(tmp_path / f"{name}.jsonl")
        c = module.PrefixCache(path)
        c.bump_seen("e" * 64, 3)
        c.put_ckpt("f" * 64, 2, _leaves(5))
        c.flush()
        files[name] = path
    with open(files["port"], "rb") as f, open(files["jax"], "rb") as g:
        assert f.read() == g.read()
    for reader, path in ((jax_memocache, files["port"]),
                         (memocache, files["jax"])):
        c = reader.PrefixCache(path)
        assert c.seen("e" * 64) == 1 and c.has_ckpt("f" * 64)
        depth, got = c.get_ckpt("f" * 64)
        assert depth == 2 and got["nested"][0].dtype == np.uint32
    shared = str(tmp_path / "shared.jsonl")
    j = jax_memocache.PrefixCache(shared)
    p = memocache.PrefixCache(shared)
    j.bump_seen("1" * 64, 1)
    j.bump_seen("1" * 64, 1)
    p.put_ckpt("1" * 64, 1, _leaves(2))
    p.flush()
    j.flush()
    merged = memocache.PrefixCache(shared)
    assert merged.has_ckpt("1" * 64) and merged.seen("1" * 64) == 2


# ---- fork_lanes -----------------------------------------------------------------------

def test_fork_lanes_equals_jax():
    """``fork_lanes`` on a mid-run batch and a bank of other states: the
    masked lanes take their bank row's simulation leaves (delay words
    included), keep fault_key, the lane bookkeeping and the rings; equal
    to the JAX ``fork_lanes`` leaf for leaf."""
    _, pr = _pair("off", batch=4, trace=True)
    jobs = [_port_job(j) for j in _jobs(4)]
    pool = pr.pack_jobs(jobs)
    s, _ = pr.run_stream(pool, **RUN)
    bank_runner = BatchedRunner(
        workloads.ring_topology(8, **SPEC_ARGS),
        SimConfig.for_workload(**CFG), HashDelay(3), 2, scheduler="sync",
        device="cpu", trace=Trace())
    bank, _ = bank_runner.run_stream(
        bank_runner.pack_jobs(jobs[:2]), **RUN)
    s = s._replace(fault_key=torch.tensor([5, 0xFFFFFFF0, 7, 9]),
                   job_id=torch.tensor([3, -1, 0, 1], dtype=torch.int32))
    mask = torch.tensor([True, False, True, True])
    src = torch.tensor([1, 0, 0, 1])
    got = fork_lanes(s, mask, bank, src)
    host = [state_to_numpy(x, pr.delay) for x in (s, bank)]
    jax_states = [JaxDenseState(*(
        tuple(jnp.asarray(w) for w in leaf) if isinstance(leaf, tuple)
        else jnp.asarray(leaf) for leaf in h)) for h in host]
    want = jax_tick.fork_lanes(jax_states[0], jnp.asarray(mask.numpy()),
                               jax_states[1], jnp.asarray(src.numpy()))
    _assert_leaves_equal(jax.device_get(want), state_to_numpy(got, pr.delay),
                         "forked")
    assert torch.equal(got.tokens[1], s.tokens[1])
    assert torch.equal(got.tokens[0], bank.tokens[1])
    assert torch.equal(got.tr_meta, s.tr_meta)
    assert torch.equal(got.fault_key, s.fault_key)


# ---- the fork ------------------------------------------------------------------------------

def _drive(runner, pool, n=2, **kw):
    for _ in range(n):
        out = runner.run_stream(pool, shadow_every=1, **RUN, **kw)
    return out


def _assert_equal(jr, jout, pr, pout):
    (js, jst), (ps, pst) = jout, pout
    _assert_leaves_equal(jax.device_get(js), state_to_numpy(ps, pr.delay),
                         "state")
    _assert_leaves_equal(jax.device_get(jst), stream_to_numpy(pst),
                         "stream")
    strip = [[{k: v for k, v in r.items() if k != "digest"}
              for r in runner.stream_results(st)]
             for runner, st in ((jr, jst), (pr, pst))]
    assert strip[0] == strip[1]
    assert pr.summarize_stream(pst) == jr.summarize_stream(jst)


@pytest.mark.parametrize("scheduler", ["sync", "exact"])
def test_fork_equals_jax_with_eviction_fallback(tmp_path, scheduler):
    """The JAX tier-1 fork keeper in both packages, each on its own store
    file: two drives (seed, then fork from the file), every fork audited
    against a cold run; leaf-equal, rows equal but the digest, forked
    rows ``served_from="prefix:<depth>"``, ``prefix_hits ==
    forked_jobs``; equal to the memo-off run of the same pool; then the
    store cut to one entry: evictions counted, evicted prefixes run cold,
    rows unchanged."""
    jr, pr = _pair(scheduler=scheduler,
                   prefix_cache=str(tmp_path / "j.jsonl"))
    pr.prefix_cache_path = str(tmp_path / "p.jsonl")
    jobs = _jobs()
    jpool = jr.pack_jobs(jobs)
    ppool = pr.pack_jobs([_port_job(j) for j in jobs])
    pout = _drive(pr, ppool)
    _assert_equal(jr, _drive(jr, jpool), pr, pout)
    sm = pr.summarize_stream(pout[1])
    assert sm["jobs_done"] == 6 and sm["forked_jobs"] > 0
    assert sm["prefix_hits"] == sm["forked_jobs"]
    assert sm["shadow_checks"] >= sm["forked_jobs"]
    rows = {r["job"]: r for r in pr.stream_results(pout[1])}
    forked = [r for r in rows.values()
              if str(r.get("served_from", "")).startswith("prefix:")]
    assert len(forked) == sm["forked_jobs"]
    off = _pair("off", scheduler=scheduler)[1]
    _, ost = off.run_stream(ppool, **RUN)
    keep = ("job", "admit_step", "digest", "served_from")
    assert [{k: v for k, v in r.items() if k not in keep}
            for r in pr.stream_results(pout[1])] == \
        [{k: v for k, v in r.items() if k not in keep}
         for r in off.stream_results(ost)]
    for runner in (jr, pr):
        runner.prefix_cache_entries = 1
    pout = _drive(pr, ppool, 1)
    _assert_equal(jr, _drive(jr, jpool, 1), pr, pout)
    sm = pr.summarize_stream(pout[1])
    assert sm["prefix_evictions"] > 0 and sm["prefix_store_entries"] <= 1


def test_tampered_checkpoint_is_refused(tmp_path):
    """A checkpoint whose leaves were rewritten (valid encoding, wrong
    balances) forks a job into another computation: the fork audit
    raises PrefixCacheError before any row is served from it."""
    _, pr = _pair(prefix_cache=str(tmp_path / "p.jsonl"))
    pool = pr.pack_jobs([_port_job(j) for j in _jobs()])
    _drive(pr, pool)
    cache = memocache.PrefixCache(pr.prefix_cache_path)
    for dg, entry in list(cache._entries.items()):
        if entry["ckpt"] is None:
            continue
        depth, leaves = cache.get_ckpt(dg)
        leaves["tokens"] = leaves["tokens"] + 1
        cache.put_ckpt(dg, depth, leaves)
    cache.flush()
    with pytest.raises(memocache.PrefixCacheError, match="fork shadow"):
        pr.run_stream(pool, shadow_every=1, **RUN)


def test_traced_fork_equals_jax():
    """The flight recorder under "prefix" (in-memory stores, three
    drives so that the heat promotes boundaries): EV_PREFIX_FORK stamped
    with each fork's depth, before the admit; the rings equal the JAX
    run's."""
    jr, pr = _pair(trace=True, batch=3)
    jobs = _jobs(9, seed=5)
    jpool = jr.pack_jobs(jobs)
    ppool = pr.pack_jobs([_port_job(j) for j in jobs])
    pout = _drive(pr, ppool, 3)
    _assert_equal(jr, _drive(jr, jpool, 3), pr, pout)
    forks = [e for lane in range(3) for e in decode_trace(pout[0], lane)
             if e.kind == EV_PREFIX_FORK]
    assert forks and all(e.payload >= 1 for e in forks)
    assert sorted(e.payload for e in forks) == sorted(pr._fork_depths)


def test_prefix_needs_a_chained_pool():
    """Memo "prefix" refuses a pool without the chain, as JAX does."""
    _, pr = _pair()
    pool = pr.pack_jobs([_port_job(j) for j in _jobs()])
    with pytest.raises(ValueError, match="prefix-chained pool"):
        pr.run_stream(pool._replace(prefix_digest=None), **RUN)
    bank = state_from_numpy(state_to_numpy(pr.init_batch_device(),
                                           pr.delay), "cpu")
    assert bank.time.shape == (2,)
