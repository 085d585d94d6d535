"""The port's kernel wrappers against the JAX package's Pallas kernels.

Rows 1-7 of the port's kernel table — ``sum_by_perm``, ``sum_segments``,
``spread``, ``head_fields``, ``append_rows``, ``queue_step``,
``select_pop`` — on
numpy-seeded inputs with leading lane axes. The JAX side calls the
Pallas function itself in interpret mode, ``jax.vmap``ped over the lane
axes as the JAX package's own tests run it; the port side calls its
wrapper on CPU tensors, which runs the plain PyTorch version. Tolerance:
none (integer work, every value and dtype must be equal). The segment
sums also run on bounds with empty segments, with one segment longer
than 1,024 edges, and with no rows (where the Pallas call refuses a
zero-size grid, the oracle is its kernel body, ``_bounded_sums``, on the
whole array); int32 inputs span the full range, so the sums wrap. The
segment kernels' planner (``segment_plan``) is pinned at the main paths'
shapes and at the switch between its staged and tiled paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.kernels import queue as pl_queue
from chandy_lamport_tpu.kernels import segment as pl_segment
from chandy_lamport_tpu_torch.core.state import (
    ERR_QUEUE_OVERFLOW,
    ERR_VALUE_OVERFLOW,
    RTIME_PACK_LIMIT,
    DenseTopology,
    pack_meta,
)
from chandy_lamport_tpu_torch.kernels import queue as t_queue
from chandy_lamport_tpu_torch.kernels import segment as t_segment
from chandy_lamport_tpu_torch.models.workloads import scale_free

TOPO = DenseTopology(scale_free(24, 2, seed=5, tokens=40))
E, N = TOPO.e, TOPO.n
C = 8
KEY_LIMIT = 1000


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_same(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _segment_input(rng, lead, dtype, e=E):
    if dtype == "bool":
        return rng.random(lead + (e,)) < 0.4
    # full int32 range: the JAX cumsum wraps, the port's sums must too
    return rng.integers(-2**31, 2**31 - 1, lead + (e,), dtype=np.int32)


# edges of the "hub" bounds; 1,030 of them meet node 3
HUB_E = 1100


def _heads(direction, case):
    """The per-edge node (dst or src) of the bounds ``case``: the sf-24
    topology; its edges moved onto even nodes, so odd nodes have empty
    segments; or HUB_E edges with one segment longer than 1,024."""
    if case == "sf":
        return TOPO.edge_dst if direction == "dst" else TOPO.edge_src
    rng = np.random.default_rng(9 if direction == "dst" else 10)
    if case == "empty":
        heads = 2 * rng.integers(0, N // 2, E)
    else:
        heads = rng.integers(0, N, HUB_E)
        heads[rng.choice(HUB_E, 1030, replace=False)] = 3
    return heads if direction == "dst" else np.sort(heads)


def _bounds(direction, case="sf"):
    """(perm, lo, hi): by destination (perm = a stable sort by dst, as
    ``DenseTopology.by_dst``), or by source (no perm: edges src-sorted)."""
    heads = _heads(direction, case)
    bounds = np.concatenate([[0], np.cumsum(np.bincount(heads,
                                                        minlength=N))])
    perm = (np.argsort(heads, kind="stable").astype(np.int32)
            if direction == "dst" else None)
    return perm, bounds[:-1].astype(np.int32), bounds[1:].astype(np.int32)


def _pallas_or_body(call, body, x):
    """The Pallas function vmapped over the lane axis; with no rows, where
    the Pallas call refuses a zero-size grid, its kernel body on the whole
    array."""
    if x.shape[0] == 0:
        return body(pl_segment._cast(jnp.asarray(x)))
    return jax.vmap(call)(x)


# (leading axes, bounds case); the first two ids are the original cases
SEGMENT_CASES = pytest.mark.parametrize(
    "lead,case", [((3,), "sf"), ((2, 4), "sf"), ((3,), "empty"),
                  ((2, 3), "hub"), ((0,), "sf")],
    ids=["lead0", "lead1", "empty", "hub", "rows0"])


@pytest.mark.parametrize("dtype", ["int32", "bool"])
@SEGMENT_CASES
def test_sum_by_perm_matches_pallas(dtype, lead, case):
    """Row 1: token credits ([B, E] int32) and marker arrivals
    ([B, S, E] bool) per destination node."""
    perm, lo, hi = _bounds("dst", case)
    x = _segment_input(np.random.default_rng(1), lead, dtype, len(perm))
    ref = _pallas_or_body(
        lambda v: pl_segment.sum_by_perm(v, perm, lo, hi, interpret=True),
        lambda v: pl_segment._bounded_sums(jnp.take(v, perm, axis=-1), lo,
                                           hi), x)
    _assert_same(ref, t_segment.sum_by_perm(_t(x), _t(perm), _t(lo),
                                            _t(hi)))


@pytest.mark.parametrize("dtype", ["int32", "bool"])
@SEGMENT_CASES
def test_sum_segments_matches_pallas(dtype, lead, case):
    """Row 2: per-source sums over the src-sorted edges (send debits)."""
    _, lo, hi = _bounds("src", case)
    x = _segment_input(np.random.default_rng(2), lead, dtype, int(hi[-1]))
    ref = _pallas_or_body(
        lambda v: pl_segment.sum_segments(v, lo, hi, interpret=True),
        lambda v: pl_segment._bounded_sums(v, lo, hi), x)
    _assert_same(ref, t_segment.sum_segments(_t(x), _t(lo), _t(hi)))


# (rows, E, N, element bytes, perm given) -> (path, rows per group, smem)
PLANS = {
    # the main paths: sync arrivals and credits (sf-1024, B=2048, S=8),
    # exact credits (er-256, B=4096), the send debits of both
    "sync_arrivals": ((16384, 3063, 1024, 1, True), ("staged", 4, 45040)),
    "sync_credits": ((2048, 3063, 1024, 4, True), ("staged", 4, 118544)),
    "exact_credits": ((4096, 768, 256, 4, True), ("staged", 4, 29776)),
    "sync_debits": ((1, 3063, 1024, 4, False), ("tiled", 1, 0)),
    "exact_debits": ((1, 768, 256, 4, False), ("tiled", 1, 0)),
    # the switch at exactly the shared-memory budget, and one edge past
    "at_limit": ((64, 29040, 8, 4, False), ("staged", 1, 232448)),
    "past_limit": ((64, 29041, 8, 4, False), ("tiled", 1, 0)),
    "past_limit_perm": ((64, 29041, 8, 4, True), ("tiled", 1, 49152)),
    # wide rows: staged while one row and the tables fit, else tiled
    "wide_rows": ((4, 65536, 8, 1, False), ("staged", 1, 131200)),
    "wide_rows_perm": ((3, 65536, 8, 1, True), ("tiled", 1, 4 * 12288)),
    "no_rows": ((0, 3063, 1024, 1, True), ("staged", 1, 26672)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_segment_plan_pinned(name):
    """The path, rows per group and shared-memory bytes the CUDA segment
    kernel gets at each pinned shape."""
    args, want = PLANS[name]
    plan = t_segment.segment_plan(*args)
    assert tuple(plan) == want
    if plan.path == "staged":
        assert plan.smem_bytes == t_segment.staged_smem_bytes(
            args[1], args[2], plan.rows_per_group, args[3], args[4])
    assert plan.smem_bytes <= t_segment.SMEM_BUDGET


def test_segment_plan_fits_every_shape():
    """Over seeded shapes: a staged plan fits the budget with its rows per
    group (a multiple of ROW_CHUNK past ROW_CHUNK, at most the rows);
    a shape is tiled only when one row does not fit, or when it has fewer
    rows than ROW_CHUNK and no perm."""
    rng = np.random.default_rng(12)
    for _ in range(400):
        rows = int(rng.integers(0, 5000))
        e = int(rng.choice([0, 1, 7, 768, 3063, 29048, 40000, 70000])
                + rng.integers(0, 50))
        n = int(rng.choice([1, 8, 256, 1024, 5000, 60000]))
        size, has_perm = int(rng.choice([1, 4])), bool(rng.random() < 0.5)
        plan = t_segment.segment_plan(rows, e, n, size, has_perm)
        k = plan.rows_per_group
        assert plan.smem_bytes <= t_segment.SMEM_BUDGET
        if plan.path == "staged":
            assert 1 <= k <= max(rows, 1)
            assert k <= t_segment.ROW_CHUNK or k % t_segment.ROW_CHUNK == 0
            assert plan.smem_bytes == t_segment.staged_smem_bytes(
                e, n, k, size, has_perm)
        else:
            assert (rows < t_segment.ROW_CHUNK and not has_perm) or \
                t_segment.staged_smem_bytes(e, n, 1, size, has_perm) \
                > t_segment.SMEM_BUDGET


def test_sum_segments_unbatched_debits():
    """The storm's debit call is one [E] row shared by every lane."""
    x = np.random.default_rng(3).integers(0, 5, E, dtype=np.int32)
    _, lo, hi = _bounds("src")
    ref = pl_segment.sum_segments(x, lo, hi, interpret=True)
    _assert_same(ref, t_segment.sum_segments(_t(x), _t(lo), _t(hi)))


@pytest.mark.parametrize("dtype", ["int32", "bool"])
@pytest.mark.parametrize("direction", ["dst", "src"])
def test_spread_matches_pallas(dtype, direction):
    """Row 3: a node quantity onto inbound / outbound edges."""
    rng = np.random.default_rng(4)
    x = (rng.random((3, 4, N)) < 0.3 if dtype == "bool"
         else rng.integers(-50, 50, (3, 4, N), dtype=np.int32))
    idx = (TOPO.edge_dst if direction == "dst" else TOPO.edge_src).astype(
        np.int32)
    ref = jax.vmap(lambda v: pl_segment.spread(v, idx, interpret=True))(x)
    _assert_same(ref, t_segment.spread(_t(x), _t(idx)))


def _rings(rng, b):
    """Per-lane ring regimes: lane 0 wraps (head C-1, two slots), lane 1
    is full with its head mid-ring, lane 2 has a marker at the head,
    later lanes are random. Returns q_meta, q_data, q_head, q_len."""
    q_meta = pack_meta(rng.integers(0, 50, (b, E, C)),
                       rng.random((b, E, C)) < 0.2).astype(np.int32)
    q_data = rng.integers(-1000, 1000, (b, E, C), dtype=np.int32)
    q_head = rng.integers(0, C, (b, E), dtype=np.int32)
    q_len = rng.integers(0, C, (b, E), dtype=np.int32)
    q_head[0], q_len[0] = C - 1, 2
    q_head[1], q_len[1] = 1, C
    q_head[2], q_len[2] = C - 1, 2
    q_meta[2, :, C - 1] = pack_meta(1, True)
    return q_meta, q_data, q_head, q_len


def test_head_fields_matches_pallas():
    """Row 4: every ring head's (rtime, is_marker, data) on the wrap, full,
    marker-at-head and random regimes."""
    q_meta, q_data, q_head, _ = _rings(np.random.default_rng(5), 5)
    ref = jax.vmap(lambda m, d, h: pl_queue.head_fields(
        m, d, h, interpret=True))(q_meta, q_data, q_head)
    got = t_queue.head_fields(_t(q_meta), _t(q_data), _t(q_head))
    for r, g in zip(ref, got):
        _assert_same(r, g)
    assert bool(got[1][2].all())      # lane 2: marker at every head


@pytest.mark.parametrize("flag_queue_overflow", [True, False])
def test_append_rows_matches_pallas(flag_queue_overflow):
    """Row 5: partially active rows on the wrap / full / marker-at-head
    regimes, plus overflow rows — a full ring (lane 1), a token-push
    counter at the merge-key bound (lane 3) and a receive time at the
    packed-rtime bound (lane 4). Planes and per-lane error words equal."""
    rng = np.random.default_rng(6)
    b = 6
    q_meta, q_data, q_head, q_len = _rings(rng, b)
    tok_pushed = rng.integers(0, KEY_LIMIT, (b, E), dtype=np.int32)
    active = rng.random((b, E)) < 0.5
    rt = rng.integers(1, 60, (b, E), dtype=np.int32)
    tok_pushed[3, active[3].argmax()] = KEY_LIMIT
    rt[4, active[4].argmax()] = RTIME_PACK_LIMIT
    meta = pack_meta(rt, False).astype(np.int32)
    data = rng.integers(1, 9, (b, E), dtype=np.int32)
    ref = jax.vmap(lambda *a: pl_queue.append_rows(
        *a, capacity=C, key_limit=KEY_LIMIT,
        flag_queue_overflow=flag_queue_overflow, interpret=True))(
        q_meta, q_data, q_head, q_len, tok_pushed, active, meta, rt, data)
    got = t_queue.append_rows(
        _t(q_meta), _t(q_data), _t(q_head), _t(q_len), _t(tok_pushed),
        torch.zeros(b, dtype=torch.int32), _t(active), _t(rt), False,
        _t(data), capacity=C, key_limit=KEY_LIMIT,
        flag_queue_overflow=flag_queue_overflow)
    _assert_same(ref[0], got[0])
    _assert_same(ref[1], got[1])
    # the JAX caller's adds, now in the same launch
    _assert_same(q_len + active, got[2])
    _assert_same(tok_pushed + active, got[3])
    _assert_same(np.asarray(ref[2])[:, 0], got[4])
    err = got[4].tolist()
    assert err[1] == (ERR_QUEUE_OVERFLOW if flag_queue_overflow else 0)
    assert err[3] & ERR_VALUE_OVERFLOW and err[4] & ERR_VALUE_OVERFLOW


def test_append_rows_writes_in_place():
    """The port's append writes the planes and counters it was given (the
    CUDA kernel's contract, shared by the plain version) and returns
    them."""
    q_meta, q_data, q_head, q_len = _rings(np.random.default_rng(7), 3)
    leaves = (_t(q_meta), _t(q_data), _t(q_head), _t(q_len),
              _t(np.ones((3, E), np.int32)), torch.zeros(3, dtype=torch.int32))
    active = np.ones((3, E), bool)
    ones = np.ones((3, E), np.int32)
    out = t_queue.append_rows(*leaves, _t(active), _t(ones), False,
                              _t(ones), capacity=C, key_limit=KEY_LIMIT)
    assert out[0] is leaves[0] and out[1] is leaves[1]
    assert all(o is x for o, x in zip(out[2:], leaves[3:]))
    assert not np.array_equal(leaves[0].numpy(), q_meta)


def _step_inputs(rng, lead):
    """Rings for queue_step with one clock per lane, on the ring regimes
    of ``_rings`` (lanes 0-2) plus, where the batch has the lanes, the
    selection edge cases: an empty ring whose stale head slot looks
    eligible (lane 3), heads due exactly now (eligible) beside heads due
    next tick (not; lane 4), and sources whose every outbound edge is
    eligible, of which only the first in dest order is popped (lane 5)."""
    b = int(np.prod(lead))
    q_meta, q_data, q_head, q_len = _rings(rng, b)
    time = rng.integers(0, 50, b, dtype=np.int32)
    if b > 3:
        q_len[3] = 0
        q_meta[3] = pack_meta(0, False)
    for lane, late in ((4, 1), (5, 0)):
        if lane >= b:
            continue
        q_len[lane] = 1 + (np.arange(E) % 3)
        rt = np.full(E, time[lane], np.int64)
        rt[1::2] += late
        mk = np.arange(E) % 4 == 1
        q_meta[lane, np.arange(E), q_head[lane]] = pack_meta(rt, mk)
    shape = lead + (E,)
    return (q_meta.reshape(shape + (C,)), q_data.reshape(shape + (C,)),
            q_head.reshape(shape), q_len.reshape(shape), time.reshape(lead))


@pytest.mark.parametrize("lead", [(3,), (2, 4)])
def test_queue_step_matches_pallas(lead):
    """Row 6: the exact tick's fused head read + eligibility + first
    eligible edge per source + pop, bit-equal to the Pallas kernel in
    interpret mode (vmapped over every lane axis), dtypes included."""
    src_first = np.searchsorted(TOPO.edge_src, TOPO.edge_src,
                                side="left").astype(np.int32)
    args = _step_inputs(np.random.default_rng(8), lead)

    def one(m, d, h, n, t):
        return pl_queue.queue_step(m, d, h, n, t, src_first, capacity=C,
                                   interpret=True)

    fn = one
    for _ in lead:
        fn = jax.vmap(fn)
    ref = fn(*args)
    got = t_queue.queue_step_plain(*map(_t, args), _t(src_first),
                                   capacity=C)
    for r, g in zip(ref, got):
        _assert_same(r, g)
    tok, mk, _, new_head, new_len = (g.reshape((-1, E)) for g in got)
    sel = tok | mk
    assert bool(mk.any()) and bool(tok.any())
    flat_head = args[2].reshape((-1, E))
    assert torch.equal(new_head[1], (_t(flat_head[1]) + sel[1]) % C)
    assert torch.equal(new_len, _t(args[3].reshape((-1, E))) - sel.int())
    if sel.shape[0] >= 6:
        assert not bool(sel[3].any())             # empty rings: nothing
        # lane 5: exactly one delivery per source, its first edge; lane 4:
        # the odd (late) edges never deliver
        firsts = np.unique(src_first)
        assert sel[5].nonzero().flatten().tolist() == firsts.tolist()
        assert not bool(sel[4, 1::2].any())


def _select_inputs(rng, lead):
    """Heads, lengths and a gated eligibility mask for select_pop: lane 0
    wraps (heads at C-1), lane 1 has every edge eligible, lane 2 none,
    lane 3 every other edge, later lanes random."""
    b = int(np.prod(lead))
    q_head = rng.integers(0, C, (b, E), dtype=np.int32)
    q_len = rng.integers(1, C + 1, (b, E), dtype=np.int32)
    elig = rng.random((b, E)) < 0.4
    q_head[0] = C - 1
    elig[1] = True
    elig[2] = False
    elig[3] = np.arange(E) % 2 == 1
    shape = lead + (E,)
    return (q_head.reshape(shape), q_len.reshape(shape), elig.reshape(shape))


@pytest.mark.parametrize("lead", [(5,), (2, 4)])
def test_select_pop_matches_pallas(lead):
    """Row 7: selection + pop over an externally gated eligibility mask
    (the faulted exact tick), bit-equal to the Pallas kernel in interpret
    mode (vmapped over every lane axis), dtypes included."""
    src_first = np.searchsorted(TOPO.edge_src, TOPO.edge_src,
                                side="left").astype(np.int32)
    args = _select_inputs(np.random.default_rng(9), lead)

    def one(h, n, el):
        return pl_queue.select_pop(h, n, el, src_first, capacity=C,
                                   interpret=True)

    fn = one
    for _ in lead:
        fn = jax.vmap(fn)
    ref = fn(*args)
    got = t_queue.select_pop_plain(*map(_t, args), _t(src_first),
                                   capacity=C)
    for r, g in zip(ref, got):
        _assert_same(r, g)
    sel, new_head, new_len = (g.reshape((-1, E)) for g in got)
    firsts = np.unique(src_first).tolist()
    assert sel[1].nonzero().flatten().tolist() == firsts   # all eligible
    assert not bool(sel[2].any())                           # none eligible
    assert bool((new_head[0][sel[0]] == 0).all())           # wrap to 0
    assert torch.equal(new_len, _t(args[1].reshape((-1, E))) - sel.int())
