"""The port's CUDA kernels on the card (marker ``cuda``; skipped on a
machine without a GPU).

Each wrapper on CUDA tensors launches its hand-written kernel; it must
equal the plain PyTorch version on the same inputs bit for bit
(tolerance: none, integer work), refuse operands it does not take, take
more lanes than a grid's y axis holds (append_rows), and small sync,
exact and faulted exact storms on the card must equal the same storms on
the CPU; the fused megatick (row 8) must equal its plain form on every
step body, sampler and ring edge case, and an exact storm at megatick 8
must equal megatick 1, with the fault arm too (the adversary and the
supervisor inside the kernel; its device fault hash equals the plain
planes), and with the wave step body (``exact_impl="wave"``, fault-free
and faulted) on its edge cases: a marker pile-up, a broadcast into a
full ring, a hash counter wrapping inside a tick; and in the tiled
layout (the planes in a device-memory workspace): all
four instantiations on a forced-tiled ER-64 lane equal the plain form
and the resident layout, an SF-2048 storm past a block's shared memory
tiles and equals megatick 1, and a workspace left full of 0xFF is never
read; and the lane gate of its drain and flush (the streaming engine's):
on every arm, resident and tiled, a gated drain (per-lane limits) and a
gated flush equal the plain form and leave the lanes outside the gate
as they were, and small streams (sync; exact at megatick 8, cascade and
wave, faulted, gang) on the card equal the same streams on the CPU; and
its recorder arm (the flight recorder inside the step, the ``kTrace``
instantiations): on every arm, resident and tiled, at a capacity above
and below a step's events (the ring wrapping inside one append), with a
lane disarmed (``tr_on = 0``) and on a dirty tiled workspace, it equals
the plain form on every leaf, the ring included, and small traced storms
and streams on the card equal the CPU's; the sync scheduler under
every fault arm (with its supervisor, daemon and quarantine, traced and
not) equals the CPU on every leaf, and a checkpoint written on either
device loads on the other and resumes to the uninterrupted run. The
segment sums
(rows 1-2) take two paths, staged and tiled (``segment_plan``); each, on
both dtypes, with and without perm, must equal the plain version, and
every C entry point must load. A 2-worker ring-8 fleet runs its spawned
workers on the card, every summary equal to a solo CPU run, and ``run
--backend torch`` on the card prints what ``--backend parity`` prints.
Run on a GPU machine with ``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
from chandy_lamport_tpu_torch.core.state import DenseTopology, pack_meta
from chandy_lamport_tpu_torch.kernels import launch_counts
from chandy_lamport_tpu_torch.kernels import queue as kq
from chandy_lamport_tpu_torch.kernels import segment as ks
from chandy_lamport_tpu_torch.models.faults import Faults
from chandy_lamport_tpu_torch.models.workloads import (
    scale_free,
    staggered_snapshots,
    storm_program,
)
from chandy_lamport_tpu_torch.ops.delay import FixedDelay, HashDelay
from chandy_lamport_tpu_torch.utils.carry import state_to_numpy

pytestmark = pytest.mark.cuda

TOPO_SPEC = scale_free(48, 2, seed=9, tokens=30)
TOPO = DenseTopology(TOPO_SPEC)
E, N, C = TOPO.e, TOPO.n, 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _i32(a, dev):
    return torch.as_tensor(np.asarray(a, np.int32), device=dev)


def _copies(*leaves):
    """Clones of the state leaves an append writes in place."""
    return tuple(x.clone() for x in leaves)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
def test_segment_kernels_equal_plain(dev, dtype):
    gen = torch.Generator().manual_seed(3)
    x = (torch.rand((5, 3, E), generator=gen) < 0.4 if dtype == torch.bool
         else torch.randint(-2**31, 2**31 - 1, (5, 3, E), generator=gen,
                            dtype=torch.int32)).to(dev)
    perm = _i32(TOPO.by_dst, dev)
    lo, hi = _i32(TOPO.dst_bounds[:-1], dev), _i32(TOPO.dst_bounds[1:], dev)
    before = launch_counts()
    _equal([ks.sum_by_perm(x, perm, lo, hi)],
           [ks.sum_by_perm_plain(x, perm, lo, hi)])
    _equal([ks.sum_segments(x, lo, hi)], [ks.sum_segments_plain(x, lo, hi)])
    nodes = x[..., :N].contiguous()
    idx = _i32(TOPO.edge_src, dev)
    _equal([ks.spread(nodes, idx)], [ks.spread_plain(nodes, idx)])
    after = launch_counts()
    assert all(after[k] == before[k] + 1
               for k in ("sum_by_perm", "sum_segments", "spread"))


@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
@pytest.mark.parametrize("rows, n, e, skew", [
    (7, 5, 13, 0), (7, 5, 13, 1), (33, 64, 3063, 3), (4, 9, 0, 0),
    (6, 1, 11, 2), (0, 8, 5, 0), (3, 8192, 24_572, 1), (1, 256, 768, 0)],
    ids=["odd_e", "odd_e_unaligned", "sync_width_unaligned", "e0", "n1",
         "rows0", "direct", "one_row"])
def test_spread_edge_cases_equal_plain(dev, dtype, rows, n, e, skew):
    """The redesigned spread (staged groups, or direct for rows too wide
    for its share) equals index_select bit for bit on odd E, E=0, N=1,
    zero rows and x and idx starting off a 16-byte boundary (``skew``
    elements into a larger tensor), on both dtypes; its plan is the
    one the kernel checks."""
    gen = torch.Generator().manual_seed(rows * 7 + e)
    size = rows * n + skew
    base = (torch.rand((size,), generator=gen) < 0.4 if dtype == torch.bool
            else torch.randint(-2**31, 2**31 - 1, (size,), generator=gen,
                               dtype=torch.int32)).to(dev)
    x = base[skew:].view(rows, n)
    idx_base = torch.randint(0, n, (e + skew,), generator=gen,
                             dtype=torch.int32).to(dev)
    idx = idx_base[skew:]
    direct = ks.spread_plan(rows, e, n, x.element_size()).rows_per_group == 0
    assert direct == ((n, dtype) == (8192, torch.int32))
    before = launch_counts()["spread"]
    _equal([ks.spread(x, idx)], [ks.spread_plain(x, idx)])
    assert launch_counts()["spread"] == before + 1


def _csr(heads, n, dev):
    """(perm, lo, hi) of the by-head CSR of ``heads`` (numpy), as views of
    one tensor [perm | bounds], so lo and hi do not start 16-byte
    aligned."""
    e = len(heads)
    both = _i32(np.concatenate([np.argsort(heads, kind="stable"), [0],
                                np.cumsum(np.bincount(heads, minlength=n))]),
                dev)
    return both[:e], both[e:e + n], both[e + 1:]


# (E, N, leading axes, hub in-edges) of a shape each segment path takes:
# config 4's width, and rows too wide for two to share a block's shared
# memory (the hub's tile reads perm from device memory, the others stage
# their slices)
SEGMENT_SHAPES = {"staged": (3063, 1024, (5, 3), 2000),
                  "tiled": (120_000, 4096, (2, 3), 20_000)}


@pytest.mark.parametrize("has_perm", [True, False], ids=["perm", "no_perm"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
@pytest.mark.parametrize("path", ["staged", "tiled"])
def test_segment_sum_paths_equal_plain(dev, path, dtype, has_perm):
    """Each CUDA path of the segment sums, each dtype, with perm
    (sum_by_perm) and without (sum_segments): bit-equal to the plain
    version on bounds where odd nodes have no edges and one segment is
    longer than 1,024, with full-range int32 (the sums wrap), on a view
    whose rows start off 16-byte alignment, with unaligned tables."""
    e, n, lead, hub = SEGMENT_SHAPES[path]
    rng = np.random.default_rng(21)
    heads = 2 * rng.integers(0, n // 2, e)
    heads[rng.choice(e, hub, replace=False)] = 4
    perm, lo, hi = _csr(heads, n, dev)
    shape = (lead[0] + 1,) + lead[1:] + (e,)
    base = (torch.as_tensor(rng.random(shape) < 0.4, device=dev)
            if dtype == torch.bool
            else _i32(rng.integers(-2**31, 2**31 - 1, shape), dev))
    x = base[1:]
    plan = ks.segment_plan(x.numel() // e, e, n, x.element_size(), has_perm)
    assert plan.path == path
    counter = "sum_by_perm" if has_perm else "sum_segments"
    before = launch_counts()[counter]
    if has_perm:
        got = ks.sum_by_perm(x, perm, lo, hi)
        want = ks.sum_by_perm_plain(x, perm, lo, hi)
    else:
        got, want = ks.sum_segments(x, lo, hi), ks.sum_segments_plain(x, lo,
                                                                      hi)
    _equal([got], [want])
    assert launch_counts()[counter] == before + 1


def test_segment_sum_without_rows_or_edges(dev):
    """R = 0 gives an empty result; E = 0 (every segment empty) gives
    zeros, where the plain version's cumsum has no column to pad."""
    perm = _i32(TOPO.by_dst, dev)
    lo, hi = _i32(TOPO.dst_bounds[:-1], dev), _i32(TOPO.dst_bounds[1:], dev)
    none = _i32(np.zeros(5), dev)
    zeros = torch.zeros((3, 5), dtype=torch.int32, device=dev)
    for dtype in (torch.int32, torch.bool):
        x0 = torch.zeros((0, E), dtype=dtype, device=dev)
        assert ks.sum_by_perm(x0, perm, lo, hi).shape == (0, N)
        assert ks.sum_segments(x0, lo, hi).shape == (0, N)
        xe = torch.ones((3, 0), dtype=dtype, device=dev)
        assert torch.equal(ks.sum_segments(xe, none, none), zeros)
        assert torch.equal(ks.sum_by_perm(xe, _i32(np.zeros(0), dev), none,
                                          none), zeros)


def test_segment_plan_checked_by_kernel(dev, monkeypatch):
    """The staged kernel lays its shared memory out itself and refuses a
    launch whose share (``segment_plan``'s, passed in) is short of that
    layout."""
    x = torch.zeros((4, E), dtype=torch.int32, device=dev)
    perm = _i32(TOPO.by_dst, dev)
    lo, hi = _i32(TOPO.dst_bounds[:-1], dev), _i32(TOPO.dst_bounds[1:], dev)
    plan = ks.segment_plan(4, E, N, 4, True)
    assert plan.path == "staged"
    monkeypatch.setattr(ks, "segment_plan", lambda *a: plan._replace(
        smem_bytes=plan.smem_bytes - 16))
    with pytest.raises(RuntimeError, match="clsim_segment_sum_i32"):
        ks.sum_by_perm(x, perm, lo, hi)


def test_every_entry_point_loads(dev):
    """Every C entry point of the three libraries is exported (ctypes
    finds only symbols with external linkage) and bound once."""
    from chandy_lamport_tpu_torch.kernels import megatick as km

    for name, sig in ks._SIGS.items():
        fn = ks._fn(name)
        assert tuple(fn.argtypes) == tuple(sig)
        assert fn.restype is ctypes.c_int
        assert ks._fn(name) is fn
    for book in (kq, km):
        for name, sig in book._SIGS.items():
            fn = book._fn(name)
            assert tuple(fn.argtypes) == tuple(sig)
            assert fn.restype is ctypes.c_int
            assert book._fn(name) is fn


def test_queue_kernels_equal_plain(dev):
    rng = np.random.default_rng(4)
    b = 4
    q_meta = _i32(pack_meta(rng.integers(0, 40, (b, E, C)),
                            rng.random((b, E, C)) < 0.3), dev)
    q_data = _i32(rng.integers(-99, 99, (b, E, C)), dev)
    q_head = _i32(rng.integers(0, C, (b, E)), dev)
    q_len = _i32(rng.integers(0, C + 1, (b, E)), dev)
    _equal(kq.head_fields(q_meta, q_data, q_head),
           kq.head_fields_plain(q_meta, q_data, q_head))
    active = torch.as_tensor(rng.random((b, E)) < 0.5, device=dev)
    tok = _i32(rng.integers(0, 60, (b, E)), dev)
    rt = _i32(rng.integers(1, 50, (b, E)), dev)
    data = _i32(rng.integers(1, 9, (b, E)), dev)
    err = torch.zeros(b, dtype=torch.int32, device=dev)
    got = kq.append_rows(*_copies(q_meta, q_data, q_head, q_len, tok, err),
                         active, rt, False, data, capacity=C, key_limit=50)
    want = kq.append_rows_plain(*(x.cpu() for x in (
        q_meta, q_data, q_head, q_len, tok, err, active, rt)), False,
        data.cpu(), capacity=C, key_limit=50)
    _equal([g.cpu() for g in got], want)
    assert int(got[4].max()) > 0          # full rings and tok >= 50 flag


@pytest.mark.parametrize("b,e,c", [(1, 1, 8), (3, 7, 16), (4, 768, 24),
                                   (2, 3063, 16)],
                         ids=["one-edge-one-lane", "ragged", "er256", "sf1k"])
def test_head_fields_edge_cases(dev, b, e, c):
    """Row 4 on the card, bit for bit against the plain version: empty
    rings (the stale slot word is read), heads at slot C - 1, negative
    packed receive times (arithmetic >> 1), row counts that are and are
    not a multiple of a thread's 4 rows, and heads read through a view
    whose first row is not 16-byte aligned."""
    rng = np.random.default_rng(b * e + c)
    q_meta = _i32(rng.integers(-2**31, 2**31, (b, e, c), dtype=np.int64),
                  dev)
    q_data = _i32(rng.integers(-2**31, 2**31, (b, e, c), dtype=np.int64),
                  dev)
    q_head = _i32(rng.integers(0, c, (b, e)), dev)
    q_head[:, ::3] = c - 1
    q_meta[0, :, c - 1] = -5                  # negative: rtime -3, a marker
    for heads in (q_head, torch.cat([q_head.new_zeros(1),
                                     q_head.flatten()])[1:].view(b, e)):
        got = kq.head_fields(q_meta, q_data, heads)
        _equal(got, kq.head_fields_plain(q_meta, q_data, heads))
    assert int(got[0].min()) < 0 and bool(got[1].any())


def test_queue_step_equals_plain(dev):
    """Row 6 on the card: the exact tick's selection + pop, with one
    clock per lane, bit-equal to the plain version."""
    rng = np.random.default_rng(5)
    b = 6
    q_meta = _i32(pack_meta(rng.integers(0, 40, (b, E, C)),
                            rng.random((b, E, C)) < 0.3), dev)
    q_data = _i32(rng.integers(-99, 99, (b, E, C)), dev)
    q_head = _i32(rng.integers(0, C, (b, E)), dev)
    q_len = _i32(rng.integers(0, C + 1, (b, E)), dev)
    time = _i32(rng.integers(0, 45, b), dev)
    src_first = _i32(np.searchsorted(TOPO.edge_src, TOPO.edge_src), dev)
    bounds = np.concatenate([[0], np.cumsum(np.bincount(TOPO.edge_src,
                                                        minlength=N))])
    lo, hi = _i32(bounds[:-1], dev), _i32(bounds[1:], dev)
    before = launch_counts()["queue_step"]
    got = kq.queue_step(q_meta, q_data, q_head, q_len, time, src_first, lo,
                        hi, capacity=C)
    _equal(got, kq.queue_step_plain(q_meta, q_data, q_head, q_len, time,
                                    src_first, capacity=C))
    assert launch_counts()["queue_step"] == before + 1
    assert bool(got[0].any()) and bool(got[1].any())


def test_select_pop_equals_plain(dev):
    """Row 7 on the card: selection + pop over a gated eligibility mask;
    lane 0 every edge eligible, lane 1 none, lane 2 heads at the wrap."""
    rng = np.random.default_rng(8)
    b = 6
    q_head = rng.integers(0, C, (b, E))
    q_head[2] = C - 1
    q_head, q_len = _i32(q_head, dev), _i32(rng.integers(1, C + 1, (b, E)),
                                            dev)
    elig = rng.random((b, E)) < 0.4
    elig[0], elig[1] = True, False
    elig = torch.as_tensor(elig, device=dev)
    src_first = _i32(np.searchsorted(TOPO.edge_src, TOPO.edge_src), dev)
    bounds = np.concatenate([[0], np.cumsum(np.bincount(TOPO.edge_src,
                                                        minlength=N))])
    lo, hi = _i32(bounds[:-1], dev), _i32(bounds[1:], dev)
    before = launch_counts()["select_pop"]
    got = kq.select_pop(q_head, q_len, elig, src_first, lo, hi, capacity=C)
    _equal(got, kq.select_pop_plain(q_head, q_len, elig, src_first,
                                    capacity=C))
    assert launch_counts()["select_pop"] == before + 1
    assert not bool(got[0][1].any()) and bool(got[0][0].any())


@pytest.mark.parametrize("layout", sorted(chip_smoke.SELECT_LAYOUTS))
def test_selection_layouts_equal_plain(dev, layout):
    """Rows 6 and 7 on the layouts no real cell has (``chip_smoke.
    SELECT_LAYOUTS``): a 2,500-edge source past a block's tile, segments
    across every boundary the grid draws, sources of out-degree 0, E
    below 32 and off every multiple of 32 and of the tile, one lane, no
    edges; lanes of every edge eligible, of none (the frozen clock) and
    random ones, empty rings' stale head words: bit-equal to the plain
    versions, one launch each."""
    degrees, lanes = chip_smoke.SELECT_LAYOUTS[layout]
    q_meta, q_data, q_head, q_len, time, elig, first, lo, hi = (
        torch.as_tensor(x, device=dev)
        for x in chip_smoke.select_inputs(degrees, lanes, C, seed=3))
    before = launch_counts()
    got = kq.queue_step(q_meta, q_data, q_head, q_len, time, first, lo, hi,
                        capacity=C)
    _equal(got, kq.queue_step_plain(q_meta, q_data, q_head, q_len, time,
                                    first, capacity=C))
    got = kq.select_pop(q_head, q_len, elig, first, lo, hi, capacity=C)
    _equal(got, kq.select_pop_plain(q_head, q_len, elig, first,
                                    capacity=C))
    after = launch_counts()
    assert after["queue_step"] == before["queue_step"] + 1
    assert after["select_pop"] == before["select_pop"] + 1


def test_selection_refuses_what_it_does_not_take(dev):
    """The selection wrappers raise on a wrong dtype, shape or layout of
    any operand, ``src_first`` included."""
    q_meta, q_data, q_head, q_len, time, elig, first, lo, hi = (
        torch.as_tensor(x, device=dev) for x in chip_smoke.select_inputs(
            [3, 0, 5, 2], 2, C, seed=4))
    with pytest.raises(ValueError, match="src_first"):
        kq.queue_step(q_meta, q_data, q_head, q_len, time, first[:-1], lo,
                      hi, capacity=C)
    with pytest.raises(ValueError, match="q_meta"):
        kq.queue_step(q_meta, q_data, q_head, q_len, time, first, lo, hi,
                      capacity=C + 1)
    with pytest.raises(ValueError, match="time"):
        kq.queue_step(q_meta, q_data, q_head, q_len, time.long(), first, lo,
                      hi, capacity=C)
    with pytest.raises(ValueError, match="elig"):
        kq.select_pop(q_head, q_len, elig.int(), first, lo, hi, capacity=C)
    with pytest.raises(ValueError, match="q_len"):
        kq.select_pop(q_head, q_len.t().contiguous().t(), elig, first, lo,
                      hi, capacity=C)


def test_append_rows_past_65535_lanes(dev):
    """The append grid folds the lane into its 1-D index: 70,000 lanes of
    a 10-edge ring, bit-equal to the plain version, overflow flagged on
    exactly the lanes with a full ring."""
    b, e, c = 70_000, 10, 16
    gen = torch.Generator().manual_seed(6)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    q_meta, q_data = ints((b, e, c), 0, 2**30), ints((b, e, c), -9, 9)
    q_len = ints((b, e), 0, c)
    q_len[::3, 7] = c
    rt = ints((b, e), 1, 60)
    leaves = (q_meta, q_data, ints((b, e), 0, c), q_len, ints((b, e), 0, 50),
              torch.zeros(b, dtype=torch.int32, device=dev))
    rows = (torch.ones((b, e), dtype=torch.bool, device=dev), rt, False,
            ints((b, e), 1, 9))
    got = kq.append_rows(*_copies(*leaves), *rows, capacity=c,
                         key_limit=1 << 20)
    want = kq.append_rows_plain(*(x.cpu() for x in leaves), *(
        x.cpu() if torch.is_tensor(x) else x for x in rows), capacity=c,
        key_limit=1 << 20)
    _equal([g.cpu() for g in got], want)
    flagged = (got[4] & 1).nonzero().flatten()
    assert torch.equal(flagged.cpu(), torch.arange(0, b, 3))


# the three timed shapes of the append (B, E, C, active share)
APPEND_SHAPES = {"sync send [2048,3063,16]": (2048, 3063, 16, 0.33),
                 "exact send [4096,768,24]": (4096, 768, 24, 0.33)}


@pytest.mark.parametrize("shape", sorted(APPEND_SHAPES))
def test_one_launch_append_at_the_timed_shapes(dev, shape):
    """Row 5 at the sends of the sync and exact cells: one launch writes
    the planes, both counters and the error word, bit-equal to the plain
    version; the per-row operands passed as the callers pass them (an [E]
    send expanded over the lanes, the mask computed); rings full on every
    fifth lane, a push counter at the key limit and a receive time at the
    packed bound on two lanes; one launch counted."""
    from chandy_lamport_tpu_torch.core.state import RTIME_PACK_LIMIT

    b, e, c, share = APPEND_SHAPES[shape]
    gen = torch.Generator().manual_seed(b + e)

    def ints(shape_, lo, hi):
        return torch.randint(lo, hi, shape_, generator=gen,
                             dtype=torch.int32).to(dev)

    q_len = ints((b, e), 0, c)
    q_len[::5] = c
    pushed = ints((b, e), 0, 500)
    pushed[3, :] = 1000
    rt = ints((b, e), 1, 60)
    rt[4, :] = RTIME_PACK_LIMIT
    leaves = (ints((b, e, c), 0, 2**30), ints((b, e, c), -9, 9),
              ints((b, e), 0, c), q_len, pushed, ints((b,), 0, 3) * 2)
    amounts = (torch.rand(e, generator=gen) < share).to(torch.int32).to(dev)
    lanes = torch.arange(b, device=dev) % 7 != 6
    active = (amounts > 0).expand(b, -1) & lanes[:, None]
    rows = (active, rt, False, amounts.expand(b, -1))
    before = launch_counts()["append_rows"]
    got = kq.append_rows(*_copies(*leaves), *rows, capacity=c,
                         key_limit=1000)
    assert launch_counts()["append_rows"] == before + 1
    want = kq.append_rows_plain(*(x.cpu() for x in leaves), *(
        x.cpu() if torch.is_tensor(x) else x for x in rows), capacity=c,
        key_limit=1000)
    _equal([g.cpu() for g in got], want)
    assert int(got[4][3]) & 32 and int(got[4][4]) & 32 and int(got[4][0]) & 1


@pytest.mark.parametrize("b", [4096, 70_000])
def test_marker_rows_equal_plain(dev, b):
    """The marker broadcast's append, routed in the launch, at the exact
    cell's width (ER-256, C=24) and past 65,535 lanes: each masked lane's
    node's out-edges in dest order, bit-equal to the plain version; every
    third lane outside the mask, one lane's rings full."""
    from chandy_lamport_tpu_torch.models.workloads import erdos_renyi

    topo = DenseTopology(erdos_renyi(256, 3.0, seed=3, tokens=10))
    e, c = topo.e, 24
    lo = np.searchsorted(topo.edge_src, np.arange(topo.n), "left")
    hi = np.searchsorted(topo.edge_src, np.arange(topo.n), "right")
    gen = torch.Generator().manual_seed(b)

    def ints(shape_, lo_, hi_):
        return torch.randint(lo_, hi_, shape_, generator=gen,
                             dtype=torch.int32).to(dev)

    q_len = ints((b, e), 0, c)
    q_len[1] = c
    leaves = (ints((b, e, c), 0, 2**30), ints((b, e, c), -9, 9),
              ints((b, e), 0, c), q_len, ints((b, e), 0, 500),
              torch.zeros(b, dtype=torch.int32, device=dev))
    node = ints((b,), 0, topo.n)
    mask = torch.arange(b, device=dev) % 3 != 0
    rt_k = ints((b, int((hi - lo).max())), 1, 60)
    rows = (node, mask, rt_k, ints((b,), 0, 8), _i32(lo, dev), _i32(hi, dev))
    before = launch_counts()["append_marker_rows"]
    got = kq.append_marker_rows(*_copies(*leaves), *rows, capacity=c,
                                key_limit=1000)
    assert launch_counts()["append_marker_rows"] == before + 1
    want = kq.append_marker_rows_plain(*(x.cpu() for x in leaves),
                                       *(x.cpu() for x in rows), capacity=c,
                                       key_limit=1000)
    _equal([g.cpu() for g in got], want)
    assert int(got[4][1]) & 1 and not int(got[4][0])


def test_wrappers_refuse_bad_operands(dev):
    x = torch.zeros((2, E), dtype=torch.int64, device=dev)
    lo = _i32(TOPO.dst_bounds[:-1], dev)
    with pytest.raises(ValueError):
        ks.sum_segments(x, lo, lo)
    strided = torch.zeros((E, 2), dtype=torch.int32, device=dev).t()
    with pytest.raises(ValueError):
        ks.sum_segments(strided, lo, lo)
    planes = torch.zeros((2, E, C), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kq.head_fields(planes, planes, torch.zeros((2, E), dtype=torch.int64,
                                                   device=dev))


def test_small_storm_cuda_equals_cpu(dev):
    finals = []
    for device in (dev, "cpu"):
        runner = BatchedRunner(
            TOPO_SPEC, SimConfig.for_workload(snapshots=3,
                                              split_markers=True),
            HashDelay(5), 4, scheduler="sync", device=device)
        prog = storm_program(runner.topo, 5, 1, staggered_snapshots(
            runner.topo, 3, 1, 1, max_phases=5))
        finals.append(state_to_numpy(
            runner.run_storm(runner.init_batch_device(), prog)))
    for name, a, b in zip(finals[0]._fields, *finals):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert x.dtype == y.dtype and np.array_equal(x, y), name



def test_small_exact_storm_cuda_equals_cpu(dev):
    finals = []
    for device in (dev, "cpu"):
        runner = BatchedRunner(
            TOPO_SPEC, SimConfig.for_workload(snapshots=3), HashDelay(5), 4,
            scheduler="exact", device=device)
        prog = storm_program(runner.topo, 5, 1, staggered_snapshots(
            runner.topo, 3, 1, 1, max_phases=5))
        finals.append(state_to_numpy(
            runner.run_storm(runner.init_batch_device(), prog)))
    for name, a, b in zip(finals[0]._fields, *finals):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert int(finals[0].error.max()) == 0


def test_small_faulted_storm_cuda_equals_cpu(dev):
    """A faulted exact storm with lossy crashes, marker drops, the
    supervisor and its daemon, quarantined: every leaf equal on the card
    and the CPU, and the faulted path never ran queue_step."""
    finals = []
    for device in (dev, "cpu"):
        runner = BatchedRunner(
            TOPO_SPEC, SimConfig.for_workload(snapshots=3,
                                              snapshot_timeout=40,
                                              snapshot_every=6),
            FixedDelay(1), 4, scheduler="exact", device=device,
            faults=Faults(3, drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05,
                          crash_rate=0.5, crash_mode="lossy",
                          crash_start=30, marker_drop_rate=0.01,
                          marker_dup_rate=0.05, marker_jitter_rate=0.05),
            quarantine=True)
        prog = storm_program(runner.topo, 5, 1, staggered_snapshots(
            runner.topo, 3, 1, 1, max_phases=5))
        before = launch_counts()
        finals.append(state_to_numpy(
            runner.run_storm(runner.init_batch_device(), prog)))
        if device == dev:
            after = launch_counts()
            assert after["queue_step"] == before["queue_step"]
            assert after["select_pop"] > before["select_pop"]
    for name, a, b in zip(finals[0]._fields, *finals):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert int(finals[0].fault_counts.sum()) > 0


# ---- the fused megatick (row 8) ---------------------------------------------

def _own(s):
    return BatchedRunner._own(s)


def _leaves_equal(a, b):
    a, b = state_to_numpy(a), state_to_numpy(b)
    for name, x, y in zip(a._fields, a, b):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert u.dtype == v.dtype and np.array_equal(u, v), name


def _loaded(dev, spec, cfg, delay, quarantine=False, faults=None,
            exact_impl="cascade", tiled=False, trace=None):
    """A megatick-8 exact runner on the card (with ``faults`` armed, if
    given; the wave step body for ``exact_impl="wave"``; with ``tiled``
    the tiled layout forced, ``fused_tile="on"``, on a lane that fits a
    block) and a small state
    with traffic and snapshots in flight, built by the scalar injectors
    (every sampler has them): per round a 1-token send on every third
    edge, a snapshot at node ``round % N`` on every other lane, one
    tick. ``trace``: a utils/tracing.Trace to arm the recorder."""
    runner = BatchedRunner(spec, cfg, delay, 4, scheduler="exact",
                           device=dev, quarantine=quarantine, megatick=8,
                           faults=faults, exact_impl=exact_impl, trace=trace,
                           fused_tile="on" if tiled else None)
    tk = runner.kernel
    s = runner.init_batch_device()
    lanes = torch.arange(4, device=dev)
    for r in range(min(3, cfg.max_snapshots)):
        for e in range(r % 3, runner.topo.e, 3):
            s = tk._inject_send(s, e, 1)
        s = tk._inject_snapshot(s, r % runner.topo.n, (lanes + r) % 2 == 0)
        s = tk._exact_tick(s)
    return runner, s


def _fused_equals_plain(runner, s, mode, length, **lanes):
    """The kernel and its plain version from the same state: every leaf
    equal, one launch."""
    from chandy_lamport_tpu_torch.kernels import megatick as km

    tk = runner.kernel
    before = launch_counts()
    got = km.fused_ticks(tk, _own(s), mode=mode, length=length, **lanes)
    after = launch_counts()
    assert after["fused_scan"] == before["fused_scan"] + 1
    assert after["fused_scan_tiled"] == before["fused_scan_tiled"] + (
        tk.fused_tile == "on")
    assert after["fused_scan_traced"] == before["fused_scan_traced"] + (
        tk._trace_on)
    want = km.fused_ticks_plain(tk, _own(s), mode=mode, length=length,
                                **lanes)
    _leaves_equal(got, want)
    return got


@pytest.mark.parametrize("delay", ["fixed", "hash", "go"])
def test_fused_megatick_equals_plain(dev, delay):
    """Row 8 on the card: the three step bodies from a loaded state,
    bit-equal to the plain form, under each sampler. Lane 1 is not live
    at the "ticks" launch (left exactly as it was); 40 steps outlast the
    traffic, so the other lanes go quiet mid-megatick and are bumped."""
    from chandy_lamport_tpu_torch.ops.delay import GoExactDelay

    sampler = {"fixed": FixedDelay(2), "hash": HashDelay(5),
               "go": GoExactDelay(11)}[delay]
    runner, s = _loaded(dev, TOPO_SPEC, SimConfig.for_workload(snapshots=3),
                        sampler)
    assert runner.fused == "on"
    live = ~runner.kernel._halted(s)
    live[1] = False
    got = _fused_equals_plain(runner, s, "ticks", 40, live=live)
    flat = [(x, y) for a, b in zip(got, s)
            for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)])]
    assert all(torch.equal(x[1], y[1]) for x, y in flat)   # lane 1 as it was
    assert int(got.q_len[0].sum()) == 0        # lane 0 drained and bumped
    limit = s.time + 7                          # the limit stops the drain
    _fused_equals_plain(runner, s, "drain", 8, limit=limit)
    _fused_equals_plain(runner, s, "drain", 8,
                        limit=s.time + runner.config.max_ticks)
    _fused_equals_plain(runner, s, "flush", runner.config.max_delay + 1)


def test_fused_megatick_ring_edge_cases(dev):
    """Capacity-1 rings (every append wraps and overflows; the clobber
    and the error bits match); ring wraps at C=5 under quarantine with
    one lane errored at launch; a single-edge graph."""
    from chandy_lamport_tpu_torch.core.state import ERR_QUEUE_OVERFLOW
    from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec

    for cap, quarantine in ((1, False), (5, True)):
        runner, s = _loaded(dev, TOPO_SPEC, SimConfig(
            max_snapshots=4, queue_capacity=cap, max_recorded=8),
            HashDelay(3), quarantine=quarantine)
        if quarantine:
            s.error[2] |= ERR_QUEUE_OVERFLOW
        live = ~runner.kernel._halted(s)
        got = _fused_equals_plain(runner, s, "ticks", 16, live=live)
        if quarantine:                      # frozen, not bumped
            assert int(got.time[2]) == int(s.time[2])
        else:
            assert int(got.error.max()) & ERR_QUEUE_OVERFLOW
        _fused_equals_plain(runner, s, "flush", 6)
        _fused_equals_plain(runner, s, "drain", 8,
                            limit=s.time + runner.config.max_ticks)
    one = TopologySpec([("A", 9), ("B", 0)], [("A", "B")])
    runner, s = _loaded(dev, one, SimConfig(max_snapshots=2,
                                            queue_capacity=4), HashDelay(2))
    _fused_equals_plain(runner, s, "ticks", 8, live=~runner.kernel._halted(s))
    _fused_equals_plain(runner, s, "flush", 6)


def test_fused_smem_reckoning_checked_by_kernel(dev, monkeypatch):
    """The kernel lays its planes out itself and refuses a launch whose
    shared-memory share (``fused_smem_bytes``, passed in) is short of
    that layout."""
    from chandy_lamport_tpu_torch.kernels import megatick as km

    runner, s = _loaded(dev, TOPO_SPEC, SimConfig.for_workload(snapshots=3),
                        HashDelay(5))
    reckoned = km.fused_smem_bytes
    monkeypatch.setattr(km, "fused_smem_bytes",
                        lambda n, e, k, **arms: reckoned(n, e, k, **arms)
                        - 16)
    with pytest.raises(RuntimeError, match="clsim_fused_ticks"):
        km.fused_ticks(runner.kernel, _own(s), mode="flush", length=2)
    # the fault arm's planes and the Go-exact draw buffer count too: the
    # share without them is short
    from chandy_lamport_tpu_torch.ops.delay import GoExactDelay

    for delay, kw in ((HashDelay(5), dict(faults=Faults(3, drop_rate=0.1))),
                      (GoExactDelay(11), {})):
        runner, s = _loaded(dev, TOPO_SPEC, SimConfig.for_workload(
            snapshots=3), delay, **kw)
        monkeypatch.setattr(km, "fused_smem_bytes",
                            lambda n, e, k, **arms: reckoned(n, e, k))
        with pytest.raises(RuntimeError, match="clsim_fused_ticks"):
            km.fused_ticks(runner.kernel, _own(s), mode="flush", length=2)


FAULT_ARMS = {
    "token faults": (dict(drop_rate=0.1, dup_rate=0.1, jitter_rate=0.1),
                     {}),
    "marker faults, timeout": (dict(marker_drop_rate=0.3,
                                    marker_dup_rate=0.2,
                                    marker_jitter_rate=0.2),
                               dict(snapshot_timeout=6,
                                    snapshot_retries=6)),
    "pause crashes, every class": (dict(
        crash_rate=0.3, crash_period=4, crash_len=1, drop_rate=0.05,
        dup_rate=0.05, jitter_rate=0.05, marker_drop_rate=0.05,
        marker_dup_rate=0.05, marker_jitter_rate=0.05),
        dict(snapshot_timeout=8)),
    "lossy crash window, daemon": (dict(crash_rate=0.5, crash_mode="lossy",
                                        crash_start=9, crash_len=2),
                                   dict(snapshot_every=3,
                                        snapshot_timeout=12)),
    "marker drop 1.0, one retry": (dict(marker_drop_rate=1.0),
                                   dict(snapshot_timeout=3,
                                        snapshot_retries=1)),
}


@pytest.mark.parametrize("arm", sorted(FAULT_ARMS))
def test_fused_megatick_fault_arm_equals_plain(dev, arm):
    """Row 8's fault arm on the card: the adversary and the supervisor
    inside the step, under quarantine, through the three step bodies from
    a loaded state, bit-equal to the plain form (fault books, supervisor
    vectors, stale markers, error bits and the sampler included)."""
    fkw, sup = FAULT_ARMS[arm]
    runner, s = _loaded(dev, TOPO_SPEC,
                        SimConfig.for_workload(snapshots=8, **sup),
                        HashDelay(5), quarantine=True,
                        faults=Faults(3, **fkw))
    assert runner.fused == "on"
    live = ~runner.kernel._halted(s)
    live[1] = False
    _fused_equals_plain(runner, s, "ticks", 24, live=live)
    _fused_equals_plain(runner, s, "drain", 8, limit=s.time + 7)
    _fused_equals_plain(runner, s, "drain", 8,
                        limit=s.time + runner.config.max_ticks)
    _fused_equals_plain(runner, s, "flush", runner.config.max_delay + 1)


def test_fault_hash_planes_equal_plain(dev):
    """The kernel's device fault hash writes the JAX ``_fault_planes``
    layout equal to ``Faults.fault_planes``: rows from tick times 0, 1,
    31, 32, 2^20 and 2^31 - 1 on (past the int32 wrap), a disarmed lane,
    periodic and crash_start schedules, rates 0, 0.3 and 1."""
    from chandy_lamport_tpu_torch.kernels import megatick as km

    base = torch.tensor([-1, 0, 30, 31, 2**20 - 1, 2**31 - 2, 5, 7],
                        dtype=torch.int32, device=dev)
    for rate in (0.0, 0.3, 1.0):
        for kw in (dict(drop_rate=rate, dup_rate=rate, jitter_rate=rate,
                        crash_rate=rate, marker_drop_rate=rate,
                        marker_dup_rate=rate, marker_jitter_rate=rate),
                   dict(crash_rate=rate, crash_start=1, crash_len=3,
                        crash_mode="lossy", drop_rate=rate / 2)):
            faults = Faults(7, **kw)
            key = faults.init_batch_state(8, dev)
            key[6] = 0
            key[7] = 2**32 - 1
            got = km.fault_hash_planes(faults, key, base, steps=3,
                                       num_edges=E, num_nodes=N,
                                       max_delay=5)
            _equal(got, faults.fault_planes(key, base, 3, E, N, 5))


def test_faulted_megatick_storm_on_the_card(dev):
    """A faulted, supervised storm at megatick 8 on the card launches
    fused_scan and equals megatick 1 on the card and on the CPU."""
    fkw, sup = FAULT_ARMS["pause crashes, every class"]
    finals = []
    for device, k in ((dev, 8), (dev, 1), ("cpu", 8)):
        runner = BatchedRunner(TOPO_SPEC, SimConfig.for_workload(
            snapshots=3, **sup), HashDelay(5), 4, scheduler="exact",
            device=device, megatick=k, faults=Faults(3, **fkw),
            quarantine=True)
        prog = storm_program(runner.topo, 5, 1, staggered_snapshots(
            runner.topo, 3, 1, 1, max_phases=5))
        before = launch_counts()["fused_scan"]
        finals.append(runner.run_storm(runner.init_batch_device(), prog))
        assert (launch_counts()["fused_scan"] > before) == (
            device == dev and k == 8)
    _leaves_equal(finals[0], finals[1])
    _leaves_equal(finals[0], finals[2])
    assert int(finals[0].fault_counts.sum()) > 0


def test_megatick_storm_and_goldens_on_the_card(dev):
    """An exact storm at megatick 8 on the card equals megatick 1 on the
    card and on the CPU, launching fused_scan; the goldens at megatick 8
    pass through the kernel."""
    from chandy_lamport_tpu_torch.api import run_reference_tests

    finals = []
    for device, k in ((dev, 8), (dev, 1), ("cpu", 8)):
        runner = BatchedRunner(TOPO_SPEC, SimConfig.for_workload(snapshots=3),
                               HashDelay(5), 4, scheduler="exact",
                               device=device, megatick=k)
        prog = storm_program(runner.topo, 5, 1, staggered_snapshots(
            runner.topo, 3, 1, 1, max_phases=5))
        before = launch_counts()["fused_scan"]
        finals.append(runner.run_storm(runner.init_batch_device(), prog))
        assert (launch_counts()["fused_scan"] > before) == (
            device == dev and k == 8)
    _leaves_equal(finals[0], finals[1])
    _leaves_equal(finals[0], finals[2])
    before = launch_counts()["fused_scan"]
    results = run_reference_tests(dev)
    assert all(why is None for _, _, why in results), results
    assert launch_counts()["fused_scan"] > before


@pytest.mark.parametrize("case", ["loaded", "pile-up"])
def test_owner_step_go_exact_equals_plain(dev, case):
    """The untraced step with the Go-exact sampler, whose tick's draws
    thread 0 draws up front in stream order and the nodes' owners read by
    position: from a loaded state and on a complete 8-node digraph with
    every node initiating (markers of several sids and two of one sid to
    one destination), the three step bodies bit-equal to the plain form
    (the port's cascade), resident and tiled."""
    from chandy_lamport_tpu_torch.ops.delay import GoExactDelay

    spec, snaps = ((TOPO_SPEC, 3) if case == "loaded"
                   else (_complete(8, 50), 8))
    for tiled in (False, True):
        runner, s = _loaded(dev, spec, SimConfig.for_workload(
            snapshots=snaps), GoExactDelay(11), tiled=tiled)
        if case == "pile-up":
            for v in range(1, 8):
                s = runner.kernel._inject_snapshot(s, v)
        _fused_equals_plain(runner, s, "ticks", 24,
                            live=~runner.kernel._halted(s))
        _fused_equals_plain(runner, s, "drain", 8,
                            limit=s.time + runner.config.max_ticks)
        _fused_equals_plain(runner, s, "flush", runner.config.max_delay + 1)


def test_goldens_megatick8_equal_megatick1_on_the_card(dev):
    """The 7 goldens through ``DenseSim`` with the Go-exact stream: at
    megatick 8 (the untraced step, its draws pre-drawn) every snapshot and
    every state leaf equal megatick 1's on the card, fused_scan launched
    in every case."""
    from chandy_lamport_tpu_torch.config import REFERENCE_TEST_SEED
    from chandy_lamport_tpu_torch.core.dense import DenseSim
    from chandy_lamport_tpu_torch.ops.delay import GoExactDelay
    from chandy_lamport_tpu_torch.utils.fixtures import (
        read_events_file,
        read_topology_file,
    )
    from chandy_lamport_tpu_torch.utils.goldens import (
        REFERENCE_TESTS,
        fixture_path,
    )

    for top, events, _ in REFERENCE_TESTS:
        runs = []
        for k in (8, 1):
            sim = DenseSim(read_topology_file(fixture_path(top)),
                           GoExactDelay(REFERENCE_TEST_SEED + 1),
                           device=dev, megatick=k)
            before = launch_counts()["fused_scan"]
            snaps = sim.run_events(read_events_file(fixture_path(events)))
            assert (launch_counts()["fused_scan"] > before) == (k == 8)
            runs.append(([(g.id, g.token_map, [(m.src, m.dest,
                                                 m.message.data)
                                                for m in g.messages])
                          for g in snaps], sim.state))
        assert runs[0][0] == runs[1][0], events
        _leaves_equal(runs[0][1], runs[1][1])


# ---- the wave step body of the fused megatick (row 8's wave arm) ----------

def _complete(n, tokens):
    from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec

    names = [f"N{i}" for i in range(n)]
    return TopologySpec([(v, tokens) for v in names],
                        sorted((a, b) for a in names for b in names
                               if a != b))


WAVE_ARMS = {
    # (graph, config, sampler, adversary, quarantine)
    "fixed": (TOPO_SPEC, dict(snapshots=3), FixedDelay(2), None, False),
    "hash": (TOPO_SPEC, dict(snapshots=3), HashDelay(5), None, False),
    "pile-up: complete 8-node digraph, 8 snapshots": (
        _complete(8, 50), dict(snapshots=8), HashDelay(3), None, False),
    "full rings: C=2": (TOPO_SPEC, dict(snapshots=3, queue_capacity=2),
                        HashDelay(3), None, False),
    "marker faults, timeout": (TOPO_SPEC, dict(
        snapshots=8, snapshot_timeout=6, snapshot_retries=6), HashDelay(5),
        Faults(3, **FAULT_ARMS["marker faults, timeout"][0]), True),
    "pause crashes, every class": (TOPO_SPEC, dict(
        snapshots=8, snapshot_timeout=8), HashDelay(5),
        Faults(3, **FAULT_ARMS["pause crashes, every class"][0]), True),
}


@pytest.mark.parametrize("arm", sorted(WAVE_ARMS))
def test_fused_megatick_wave_arm_equals_plain(dev, arm):
    """Row 8's wave arm on the card: the three step bodies from a loaded
    state, bit-equal to the plain form (the port's wave tick), with lane 1
    not live at the "ticks" launch; the hash counters stand 3 draws below
    2^32 in a second pass, so a tick's draws straddle the wrap."""
    from chandy_lamport_tpu_torch.core.state import ERR_QUEUE_OVERFLOW

    spec, cfg, delay, faults, quarantine = WAVE_ARMS[arm]
    runner, s = _loaded(dev, spec, SimConfig.for_workload(**cfg), delay,
                        quarantine=quarantine, faults=faults,
                        exact_impl="wave")
    assert runner.fused == "on"
    starts = [s]
    if isinstance(delay, HashDelay):
        key, _, epoch = s.delay_state
        starts.append(s._replace(delay_state=(key, key * 0 + 2**32 - 3,
                                              epoch)))
    ticked = []
    for s in starts:
        live = ~runner.kernel._halted(s)
        live[1] = False
        ticked.append(_fused_equals_plain(runner, s, "ticks", 24, live=live))
        _fused_equals_plain(runner, s, "drain", 8, limit=s.time + 7)
        _fused_equals_plain(runner, s, "drain", 8,
                            limit=s.time + runner.config.max_ticks)
        _fused_equals_plain(runner, s, "flush", runner.config.max_delay + 1)
    if arm.startswith("full rings"):
        assert int(ticked[0].error.max()) & ERR_QUEUE_OVERFLOW
    if len(starts) == 2:                     # the counters wrapped
        assert bool((ticked[1].delay_state[2]
                     > starts[1].delay_state[2]).any())


@pytest.mark.parametrize("faulted", [False, True], ids=["fault_free",
                                                        "faulted"])
def test_wave_storm_on_the_card(dev, faulted):
    """A wave storm at megatick 8 on the card launches fused_scan, and at
    megatick 1 the segment kernels (spread too); both equal the cascade
    at megatick 1 on the card and the wave on the CPU."""
    fkw, sup = FAULT_ARMS["pause crashes, every class"]
    finals = []
    for device, impl, k in ((dev, "wave", 8), (dev, "wave", 1),
                            (dev, "cascade", 1), ("cpu", "wave", 8)):
        runner = BatchedRunner(
            TOPO_SPEC, SimConfig.for_workload(snapshots=3,
                                              **(sup if faulted else {})),
            HashDelay(5), 4, scheduler="exact", device=device, megatick=k,
            exact_impl=impl, faults=Faults(3, **fkw) if faulted else None,
            quarantine=faulted)
        prog = storm_program(runner.topo, 5, 1, staggered_snapshots(
            runner.topo, 3, 1, 1, max_phases=5))
        before = launch_counts()
        finals.append(runner.run_storm(runner.init_batch_device(), prog))
        after = launch_counts()
        assert (after["fused_scan"] > before["fused_scan"]) == (
            device == dev and k == 8)
        if device == dev and impl == "wave" and k == 1:
            assert after["spread"] > before["spread"]
    for other in finals[1:]:
        _leaves_equal(finals[0], other)


# ---- the tiled layout of the fused megatick --------------------------------

TILED_ARMS = {
    # the four tiled instantiations: (exact_impl, adversary, supervisor)
    "cascade": ("cascade", None, {}),
    "cascade, faulted": ("cascade", FAULT_ARMS["pause crashes, every "
                                               "class"][0],
                         dict(snapshot_timeout=8)),
    "wave": ("wave", None, {}),
    "wave, faulted": ("wave", FAULT_ARMS["pause crashes, every class"][0],
                      dict(snapshot_timeout=8)),
}


@pytest.mark.parametrize("arm", sorted(TILED_ARMS))
def test_forced_tiled_er64_equals_plain_and_resident(dev, arm):
    """The tiled layout forced on an ER-64 lane that fits a block: the
    three step bodies from a loaded state equal the plain form and the
    resident layout leaf for leaf, each launch counted as tiled."""
    from chandy_lamport_tpu_torch.kernels import megatick as km
    from chandy_lamport_tpu_torch.models.workloads import erdos_renyi

    impl, fkw, sup = TILED_ARMS[arm]
    spec = erdos_renyi(64, 3.0, seed=3, tokens=40)
    cfg = SimConfig.for_workload(snapshots=8, **sup)
    faults = Faults(3, **fkw) if fkw else None
    runner, s = _loaded(dev, spec, cfg, HashDelay(5), quarantine=bool(fkw),
                        faults=faults, exact_impl=impl, tiled=True)
    resident, _ = _loaded(dev, spec, cfg, HashDelay(5), quarantine=bool(fkw),
                          faults=faults, exact_impl=impl)
    assert (runner.fused_tile, resident.fused_tile) == ("on", "off")
    live = ~runner.kernel._halted(s)
    live[1] = False
    for mode, length, kw in (("ticks", 24, {"live": live}),
                             ("drain", 8, {"limit": s.time + 7}),
                             ("flush", runner.config.max_delay + 1, {})):
        got = _fused_equals_plain(runner, s, mode, length, **kw)
        _leaves_equal(got, km.fused_ticks(resident.kernel, _own(s),
                                          mode=mode, length=length, **kw))


def test_tiled_sf2048_storm_equals_megatick_1(dev):
    """An SF-2048 lane at S=8 (386,960 B, past a block's shared memory)
    tiles under "auto": a 4-lane storm at megatick 8 launches the tiled
    arm and equals megatick 1 on the card; one drain megatick from its
    phases equals the plain form."""
    from chandy_lamport_tpu_torch.kernels import megatick as km

    spec = scale_free(2048, 2, seed=3, tokens=16)
    finals = []
    for k in (8, 1):
        # 2 snapshots keep S at for_workload's floor of 8 and the
        # megatick-1 twin's host fold steps few
        runner = BatchedRunner(spec, SimConfig.for_workload(snapshots=2),
                               HashDelay(5), 4, scheduler="exact",
                               device=dev, megatick=k)
        prog = storm_program(runner.topo, 6, 1, staggered_snapshots(
            runner.topo, 2, 1, 1, max_phases=6))
        before = launch_counts()["fused_scan_tiled"]
        finals.append(runner.run_storm(runner.init_batch_device(), prog))
        assert (launch_counts()["fused_scan_tiled"] > before) == (k == 8)
        if k == 8:
            assert runner.fused_tile == "on"
            s = runner.run_storm(runner.init_batch_device(), prog,
                                 drain=False)
            _fused_equals_plain(runner, s, "drain", 8,
                                limit=s.time + runner.config.max_ticks)
            assert km.fused_smem_bytes(runner.topo.n, runner.topo.e, 8) \
                > km.SMEM_BUDGET
    _leaves_equal(finals[0], finals[1])
    assert int(finals[0].error.max()) == 0


def test_tiled_workspace_left_dirty_is_never_read(dev):
    """Two launches on a workspace filled with 0xFF end where two launches
    on a zeroed one do: every plane is loaded before it is read."""
    from chandy_lamport_tpu_torch.kernels import megatick as km

    for impl, fkw in (("cascade", None), ("wave", TILED_ARMS["wave, "
                                                             "faulted"][1])):
        runner, s = _loaded(dev, TOPO_SPEC, SimConfig.for_workload(
            snapshots=8, snapshot_timeout=8), HashDelay(5),
            quarantine=True, faults=Faults(3, **fkw) if fkw else None,
            exact_impl=impl, tiled=True)
        tk = runner.kernel
        ends = []
        for fill in (0x00, 0xFF):
            x = _own(s)
            for _ in range(2):
                share = km.fused_smem_bytes(
                    runner.topo.n, runner.topo.e, 8,
                    fault_arm=km.fault_arm(tk), wave=km.wave_arm(tk))
                km.fused_workspace(tk, 4 * share, x.time.device).fill_(fill)
                x = km.fused_ticks(tk, x, mode="ticks", length=8,
                                   live=~tk._halted(x))
            ends.append(x)
        _leaves_equal(*ends)


# ---- the streaming engine's gated drain and flush (row 8, B4) ----------------

@pytest.mark.parametrize("tiled", [False, True], ids=["resident", "tiled"])
@pytest.mark.parametrize("arm", sorted(TILED_ARMS))
def test_fused_stream_gate_equals_plain(dev, arm, tiled):
    """``live`` in the "drain" and "flush" modes: from a loaded state on
    every arm, a gated drain with per-lane limits (one already reached)
    and a gated flush equal the plain form leaf for leaf; the lanes
    outside the gate are left exactly as they were."""
    from chandy_lamport_tpu_torch.models.workloads import erdos_renyi

    impl, fkw, sup = TILED_ARMS[arm]
    spec = erdos_renyi(64, 3.0, seed=3, tokens=40)
    cfg = SimConfig.for_workload(snapshots=8, **sup)
    runner, s = _loaded(dev, spec, cfg, HashDelay(5), quarantine=bool(fkw),
                        faults=Faults(3, **fkw) if fkw else None,
                        exact_impl=impl, tiled=tiled)
    live = torch.tensor([True, False, True, True], device=dev)
    limit = s.time + torch.tensor([40, 40, 0, 40], dtype=torch.int32,
                                  device=dev)
    for mode, length, kw in (
            ("drain", 8, {"limit": limit}),
            ("flush", runner.config.max_delay + 1, {})):
        got = _fused_equals_plain(runner, s, mode, length, live=live, **kw)
        flat = [(x, y) for a, b in zip(got, s)
                for x, y in (zip(a, b) if isinstance(a, tuple)
                             else [(a, b)])]
        assert all(torch.equal(x[1], y[1]) for x, y in flat)
        assert int(got.time[0]) > int(s.time[0])


@pytest.mark.parametrize("case", ["sync", "cascade", "wave", "faulted",
                                  "gang"])
def test_small_stream_cuda_equals_cpu(dev, case):
    """A small ``run_stream`` on the card equals the same stream on the
    CPU in every result row and every leaf of the final state; on the
    exact scheduler at megatick 8 its drain slices and flushes launch
    ``fused_scan``."""
    from chandy_lamport_tpu_torch.kernels import reset_launch_counts
    from chandy_lamport_tpu_torch.models.workloads import (
        erdos_renyi,
        stream_jobs,
    )
    from chandy_lamport_tpu_torch.utils.carry import stream_to_numpy

    spec = erdos_renyi(24, 3.0, seed=3, tokens=30)
    sync = case == "sync"
    faulted = case == "faulted"
    cfg = SimConfig.for_workload(snapshots=2, split_markers=sync,
                                 snapshot_timeout=16 if faulted else 0)
    kw = dict(scheduler="sync") if sync else dict(
        scheduler="exact", megatick=8, quarantine=faulted,
        exact_impl="wave" if case == "wave" else "cascade",
        faults=Faults(3, drop_rate=0.05, dup_rate=0.05, jitter_rate=0.05,
                      crash_rate=0.05, marker_drop_rate=0.05)
        if faulted else None)
    jobs = stream_jobs(spec, 16, seed=4, max_phases=12)
    armed = [j % 3 == 0 for j in range(16)] if faulted else None
    admission = "gang" if case == "gang" else "stream"
    out = {}
    for where in ("cpu", dev):
        runner = BatchedRunner(spec, cfg, HashDelay(7), 5, device=where,
                               **kw)
        pool = runner.pack_jobs(jobs, fault_armed=armed)
        reset_launch_counts()
        state, stream = runner.run_stream(pool, drain_chunk=12,
                                          admission=admission)
        out[str(where)] = (runner.stream_results(stream), state, stream,
                           launch_counts()["fused_scan"])
    rows, state, stream, _ = out["cpu"]
    rows_c, state_c, stream_c, launched = out[str(dev)]
    assert rows_c == rows and len(rows) == 16
    _leaves_equal(state_c, state)
    for x, y in zip(stream_to_numpy(stream_c), stream_to_numpy(stream)):
        assert np.array_equal(x, y)
    assert (launched > 0) != sync


@pytest.mark.parametrize("memo", ["admit", "full", "prefix"])
def test_memo_stream_cuda_equals_cpu(dev, memo):
    """A ring-8 stream at megatick 8 under each memo mode, every served
    job shadowed (under "prefix" two drives on one in-memory store) on
    the card equals the same on the CPU: every result row (digest and
    provenance included) and every leaf of the final state and stream;
    its drains launch ``fused_scan``."""
    from chandy_lamport_tpu_torch.kernels import reset_launch_counts
    from chandy_lamport_tpu_torch.models.workloads import (
        ring_topology,
        stream_jobs,
    )
    from chandy_lamport_tpu_torch.utils.carry import stream_to_numpy

    spec = ring_topology(8, tokens=16)
    traffic = (dict(prefix_overlap=0.75) if memo == "prefix"
               else dict(dup_rate=0.5))
    jobs = stream_jobs(spec, 24, seed=17, base_phases=3, max_phases=10,
                       **traffic)
    out = {}
    for where in ("cpu", dev):
        runner = BatchedRunner(spec, SimConfig.for_workload(snapshots=4),
                               HashDelay(17), 4, scheduler="exact",
                               device=where, megatick=8, memo=memo)
        pool = runner.pack_jobs(jobs)
        reset_launch_counts()
        for _ in range(2 if memo == "prefix" else 1):
            state, stream = runner.run_stream(pool, stretch=2,
                                              drain_chunk=8, shadow_every=1)
        out[str(where)] = (runner.stream_results(stream), state, stream,
                           launch_counts()["fused_scan"],
                           runner.summarize_stream(stream))
    rows, state, stream, _, summary = out["cpu"]
    rows_c, state_c, stream_c, launched, _ = out[str(dev)]
    assert rows_c == rows and len(rows) == 24
    _leaves_equal(state_c, state)
    for x, y in zip(stream_to_numpy(stream_c), stream_to_numpy(stream)):
        assert np.array_equal(x, y)
    assert launched > 0
    assert summary["forked_jobs" if memo == "prefix"
                   else "coalesced_jobs"] > 0


# ---- the recorder arm of the fused megatick (the flight recorder) ----------

@pytest.mark.parametrize("capacity", [4096, 8])
@pytest.mark.parametrize("tiled", [False, True], ids=["resident", "tiled"])
@pytest.mark.parametrize("arm", sorted(TILED_ARMS))
def test_traced_megatick_equals_plain(dev, arm, tiled, capacity):
    """The traced instantiations on every arm, resident and tiled: the
    three step bodies from a loaded state equal the plain form on every
    leaf, the ring and its count included; at capacity 8 a step's events
    pass the ring, which wraps inside one append; lane 1 is not live at
    the "ticks" launch and its ring is left as it was."""
    from chandy_lamport_tpu_torch.models.workloads import erdos_renyi
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    impl, fkw, sup = TILED_ARMS[arm]
    runner, s = _loaded(dev, erdos_renyi(64, 3.0, seed=3, tokens=40),
                        SimConfig.for_workload(snapshots=8, **sup),
                        HashDelay(5), quarantine=bool(fkw),
                        faults=Faults(3, **fkw) if fkw else None,
                        exact_impl=impl, tiled=tiled, trace=Trace(capacity))
    assert runner.kernel._trace_on and s.tr_meta.shape == (4, capacity)
    live = ~runner.kernel._halted(s)
    live[1] = False
    got = _fused_equals_plain(runner, s, "ticks", 24, live=live)
    assert torch.equal(got.tr_count[1], s.tr_count[1])
    assert bool((got.tr_count > s.tr_count)[live].all())
    if capacity == 8:
        assert int((got.tr_count - s.tr_count).max()) > 8
    _fused_equals_plain(runner, s, "drain", 8, limit=s.time + 7)
    _fused_equals_plain(runner, s, "flush", runner.config.max_delay + 1)


@pytest.mark.parametrize("tiled", [False, True], ids=["resident", "tiled"])
@pytest.mark.parametrize("arm", sorted(TILED_ARMS))
def test_traced_megatick_pileup_wraps_inside_one_step(dev, arm, tiled):
    """A complete 8-node digraph where every node snapshots, at capacity
    4: one step's marker and receipt events (several markers a node, one
    ranked append) pass the ring within a single step; every traced
    instantiation, resident and tiled, bit-equal to the plain form."""
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    impl, fkw, sup = TILED_ARMS[arm]
    runner, s = _loaded(dev, _complete(8, 50),
                        SimConfig.for_workload(snapshots=8, **sup),
                        HashDelay(3), quarantine=bool(fkw),
                        faults=Faults(3, **fkw) if fkw else None,
                        exact_impl=impl, tiled=tiled, trace=Trace(4))
    got = _fused_equals_plain(runner, s, "ticks", 16,
                              live=~runner.kernel._halted(s))
    assert int((got.tr_count - s.tr_count).max()) > 4


@pytest.mark.parametrize("tiled", [False, True], ids=["resident", "tiled"])
@pytest.mark.parametrize("impl", ["cascade", "wave"])
def test_traced_megatick_count_wraps(dev, impl, tiled):
    """Every lane's count 3 events below the int32 wrap: the ranked
    append's slots and the count wrap as the plain form's int32
    arithmetic does."""
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    runner, s = _loaded(dev, TOPO_SPEC, SimConfig.for_workload(snapshots=8),
                        HashDelay(5), exact_impl=impl, tiled=tiled,
                        trace=Trace(64))
    s = s._replace(tr_count=torch.full_like(s.tr_count, 2**31 - 3))
    got = _fused_equals_plain(runner, s, "ticks", 16,
                              live=~runner.kernel._halted(s))
    assert bool((got.tr_count < 0).all())


def test_traced_megatick_disarmed_lane(dev):
    """A lane with ``tr_on = 0`` records nothing and keeps its count,
    on the cascade and the faulted wave; the armed lanes record as the
    plain form does."""
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    for impl, fkw, sup in (TILED_ARMS["cascade"], TILED_ARMS["wave, "
                                                             "faulted"]):
        runner, s = _loaded(dev, TOPO_SPEC,
                            SimConfig.for_workload(snapshots=8, **sup),
                            HashDelay(5), quarantine=bool(fkw),
                            faults=Faults(3, **fkw) if fkw else None,
                            exact_impl=impl, trace=Trace(64))
        s.tr_on[2] = 0
        got = _fused_equals_plain(runner, s, "ticks", 16,
                                  live=~runner.kernel._halted(s))
        for name in ("tr_meta", "tr_data", "tr_tick", "tr_count"):
            assert torch.equal(getattr(got, name)[2], getattr(s, name)[2])
        assert int(got.tr_count[0]) > int(s.tr_count[0])


def test_traced_tiled_workspace_left_dirty(dev):
    """The traced tiled arms on a workspace filled with 0xFF end where
    they end on a zeroed one: the recorder's planes are written before
    they are read, the count loaded at launch."""
    from chandy_lamport_tpu_torch.kernels import megatick as km
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    for impl, fkw in (("cascade", None), ("wave", TILED_ARMS["wave, "
                                                             "faulted"][1])):
        runner, s = _loaded(dev, TOPO_SPEC, SimConfig.for_workload(
            snapshots=8, snapshot_timeout=8), HashDelay(5),
            quarantine=True, faults=Faults(3, **fkw) if fkw else None,
            exact_impl=impl, tiled=True, trace=Trace(256))
        tk = runner.kernel
        ends = []
        for fill in (0x00, 0xFF):
            x = _own(s)
            for _ in range(2):
                share = km.fused_smem_bytes(
                    runner.topo.n, runner.topo.e, 8,
                    fault_arm=km.fault_arm(tk), wave=km.wave_arm(tk),
                    trace=True)
                km.fused_workspace(tk, 4 * share, x.time.device).fill_(fill)
                x = km.fused_ticks(tk, x, mode="ticks", length=8,
                                   live=~tk._halted(x))
            ends.append(x)
        _leaves_equal(*ends)
        want = _own(s)
        for _ in range(2):
            want = km.fused_ticks_plain(tk, want, mode="ticks", length=8,
                                        live=~tk._halted(want))
        _leaves_equal(ends[0], want)


@pytest.mark.parametrize("case", ["sync", "cascade", "wave", "faulted"])
def test_traced_storm_cuda_equals_cpu(dev, case):
    """Small traced storms (the sync tick's recorder sites; the exact
    scheduler at megatick 8, its drain in the recorder arm) on the card
    equal the same storms on the CPU on every leaf."""
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    sync, faulted = case == "sync", case == "faulted"
    fkw, sup = FAULT_ARMS["pause crashes, every class"]
    finals = []
    for device in (dev, "cpu"):
        kw = dict(scheduler="sync") if sync else dict(
            scheduler="exact", megatick=8, quarantine=faulted,
            exact_impl="wave" if case == "wave" else "cascade",
            faults=Faults(3, **fkw) if faulted else None)
        runner = BatchedRunner(TOPO_SPEC, SimConfig.for_workload(
            snapshots=3, split_markers=sync, **(sup if faulted else {})),
            HashDelay(5), 4, device=device, trace=Trace(512), **kw)
        prog = storm_program(runner.topo, 5, 1, staggered_snapshots(
            runner.topo, 3, 1, 1, max_phases=5))
        before = launch_counts()["fused_scan_traced"]
        finals.append(runner.run_storm(runner.init_batch_device(), prog))
        assert (launch_counts()["fused_scan_traced"] > before) == (
            device == dev and not sync)
    _leaves_equal(*finals)
    assert int(finals[0].tr_count.min()) > 0


# ---- the sync scheduler under faults, and checkpoints across devices -------

@pytest.mark.parametrize("arm", sorted(FAULT_ARMS))
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_faulted_sync_storm_cuda_equals_cpu(dev, arm, traced):
    """The sync scheduler under each fault arm, with its supervisor (the
    split re-initiation, the daemon every 5 ticks unless the arm sets its
    own) and quarantine, on
    the card equals the CPU on every leaf, the recorder's ring too; rows
    1-5 launch and the exact rows never."""
    from chandy_lamport_tpu_torch.kernels import reset_launch_counts
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    fkw, sup = FAULT_ARMS[arm]
    finals = []
    for device in (dev, "cpu"):
        runner = BatchedRunner(TOPO_SPEC, SimConfig.for_workload(
            snapshots=3, split_markers=True,
            **{"snapshot_every": 5, **sup}),
            HashDelay(5), 4, scheduler="sync", device=device,
            faults=Faults(3, **fkw), quarantine=True,
            trace=Trace(512) if traced else None)
        prog = storm_program(runner.topo, 6, 1, staggered_snapshots(
            runner.topo, 3, 1, 1, max_phases=6))
        reset_launch_counts()
        finals.append(runner.run_storm(runner.init_batch_device(), prog))
        if device == dev:
            launched = launch_counts()
    _leaves_equal(*finals)
    assert int(finals[1].fault_counts.sum()) > 0
    assert all(launched[k] > 0 for k in ("sum_by_perm", "spread",
                                         "head_fields", "append_rows"))
    assert not any(launched[k] for k in ("queue_step", "select_pop",
                                         "fused_scan"))


def test_checkpoint_crosses_devices(dev, tmp_path):
    """A faulted sync storm's mid-storm state saved on the card loads on
    the CPU and the other way round, leaf for leaf; each resumed on the
    other device ends equal to the uninterrupted run."""
    from chandy_lamport_tpu_torch.utils.checkpoint import (
        load_state,
        save_state,
    )

    fkw, sup = FAULT_ARMS["pause crashes, every class"]

    def runner(device):
        r = BatchedRunner(TOPO_SPEC, SimConfig.for_workload(
            snapshots=3, split_markers=True, **sup), HashDelay(5), 4,
            scheduler="sync", device=device, faults=Faults(3, **fkw),
            quarantine=True)
        return r, storm_program(r.topo, 8, 1, staggered_snapshots(
            r.topo, 3, 1, 1, max_phases=8))

    r, prog = runner("cpu")
    whole = r.run_storm(r.init_batch_device(), prog)
    first = (prog.amounts[:4], prog.snap[:4])
    rest = (prog.amounts[4:], prog.snap[4:])
    for writer, reader in ((dev, "cpu"), ("cpu", dev)):
        w, _ = runner(writer)
        mid = w.run_storm(w.init_batch_device(), first, drain=False)
        path = str(tmp_path / f"{writer}.npz")
        save_state(path, mid, delay=w.delay)
        rd, _ = runner(reader)
        state, _ = load_state(path, rd.init_batch_device(), delay=rd.delay)
        _leaves_equal(state, mid)
        _leaves_equal(rd.drain(rd.run_storm(state, rest, drain=False)),
                      whole)


# the threefry sampler kind and the uint16 window arm of row 8: (sampler,
# window dtype, adversary program, supervisor knobs)
ARMS_A7 = {
    "threefry": ("uniform", "int32", None, {}),
    "uint16": ("hash", "uint16", None, {}),
    "threefry, uint16": ("uniform", "uint16", None, {}),
    "threefry, faulted": ("uniform", "int32",
                          dict(marker_drop_rate=0.3, marker_dup_rate=0.2,
                               drop_rate=0.1), dict(snapshot_timeout=6,
                                                    snapshot_retries=6)),
    "uint16, faulted": ("hash", "uint16",
                        dict(drop_rate=0.05, dup_rate=0.05, crash_rate=0.3,
                             crash_period=4, crash_len=1,
                             marker_drop_rate=0.1),
                        dict(snapshot_timeout=8)),
}


@pytest.mark.parametrize("traced", [False, True], ids=["untraced",
                                                        "traced"])
@pytest.mark.parametrize("tiled", [False, True], ids=["resident", "tiled"])
@pytest.mark.parametrize("arm", sorted(ARMS_A7))
def test_threefry_and_uint16_arms_equal_plain(dev, arm, tiled, traced):
    """Row 8's threefry sampler kind (``UniformDelay``: the tick's draws
    by thread 0 into the draw buffer) and its uint16 window arm (2-byte
    window planes written in place), resident and forced tiled, traced
    (a 16-slot ring) and not, fault-free and under the adversary with the
    supervisor (whose aborts clear windows): the three step bodies from a
    loaded state equal the plain form on every leaf, the key words and
    the uint16 planes included."""
    from chandy_lamport_tpu_torch.ops.delay import UniformDelay
    from chandy_lamport_tpu_torch.utils.tracing import Trace

    kind, window, fkw, sup = ARMS_A7[arm]
    delay = UniformDelay(5) if kind == "uniform" else HashDelay(5)
    cfg = SimConfig.for_workload(snapshots=3, window_dtype=window, **sup)
    faults = Faults(3, **fkw) if fkw else None
    runner, s = _loaded(dev, TOPO_SPEC, cfg, delay, quarantine=bool(fkw),
                        faults=faults, tiled=tiled,
                        trace=Trace(16) if traced else None)
    assert s.rec_start.dtype == (torch.int16 if window == "uint16"
                                 else torch.int32)
    live = ~runner.kernel._halted(s)
    live[1] = False
    for mode, length, kw in (("ticks", 24, {"live": live}),
                             ("drain", 8, {"limit": s.time + 7}),
                             ("drain", 8, {"limit": s.time + 10_000}),
                             ("flush", runner.config.max_delay + 1, {})):
        _fused_equals_plain(runner, s, mode, length, **kw)


def test_fold_dense_faults_and_uint16_on_the_card(dev):
    """The fold, DenseSim under the zero-rate adversary and a uint16
    exact storm on the card: the 7 goldens through ``DenseSim(
    exact_impl="fold")`` and ``DenseSim(faults=Faults(7))`` at megatick 8
    pass (the latter through fused_scan's fault arm), and a small fold
    storm and a uniform uint16 megatick-8 storm equal the same storms on
    the CPU leaf for leaf."""
    from chandy_lamport_tpu_torch.api import check_reference_case
    from chandy_lamport_tpu_torch.models.workloads import erdos_renyi
    from chandy_lamport_tpu_torch.ops.delay import UniformDelay
    from chandy_lamport_tpu_torch.utils.goldens import REFERENCE_TESTS

    for top, events, snaps in REFERENCE_TESTS:
        before = launch_counts()["fused_scan"]
        check_reference_case(top, events, snaps, device=dev,
                             faults=Faults(7))
        assert launch_counts()["fused_scan"] > before
        check_reference_case(top, events, snaps, device=dev,
                             exact_impl="fold")
    spec = erdos_renyi(24, 3.0, seed=3, tokens=30)
    for kw in (dict(exact_impl="fold", megatick=4),
               dict(megatick=8, window="uint16", uniform=True)):
        ends = []
        for device in (dev, "cpu"):
            cfg = SimConfig.for_workload(snapshots=3, window_dtype=kw.get(
                "window", "int32"))
            delay = UniformDelay(7) if kw.get("uniform") else HashDelay(7)
            runner = BatchedRunner(spec, cfg, delay, 4, scheduler="exact",
                                   device=device, megatick=kw["megatick"],
                                   exact_impl=kw.get("exact_impl",
                                                     "cascade"))
            prog = storm_program(runner.topo, 6, 1, staggered_snapshots(
                runner.topo, 3, 1, 2, max_phases=6))
            ends.append(runner.run_storm(runner.init_batch_device(), prog))
        _leaves_equal(*ends)
        assert int(ends[0].error.max()) == 0


# ---- serving (serving/server.py) on the card ---------------------------------

@pytest.mark.parametrize("scheduler,megatick", [("sync", 1), ("exact", 8)],
                         ids=["sync", "exact-megatick-8"])
def test_serve_cuda_equals_cpu_armed(dev, scheduler, megatick):
    """A ring-8 serve (24 requests, 3 tenants, quotas, duplicate rate 0.4)
    on the card under ``RuntimeGuards()`` (transfers "disallow": the sync
    debug mode "error", so any sync outside a named site raises) equals
    the same serve on the CPU: every result row, every leaf of the state
    and the stream, the report less its timing; the two devices' site
    books are equal, with no kernel build while armed; at megatick 8 its
    drains launch ``fused_scan``."""
    from chandy_lamport_tpu_torch.kernels import reset_launch_counts
    from chandy_lamport_tpu_torch.models.workloads import (
        ring_topology,
        serve_workload,
    )
    from chandy_lamport_tpu_torch.serving import serve_run
    from chandy_lamport_tpu_torch.utils.carry import stream_to_numpy
    from chandy_lamport_tpu_torch.utils.guards import RuntimeGuards

    spec = ring_topology(8, tokens=16)
    requests = serve_workload(spec, 24, seed=17, rate=1.0, tenants=3,
                              dup_rate=0.4, base_phases=3, max_phases=10)
    out = {}
    for where in ("cpu", dev):
        guards = RuntimeGuards()
        runner = BatchedRunner(
            spec, SimConfig.for_workload(snapshots=4,
                                         split_markers=scheduler == "sync"),
            HashDelay(17), 4, scheduler=scheduler, device=where,
            megatick=megatick, guards=guards)
        reset_launch_counts()
        state, stream, report = serve_run(runner, requests,
                                          quotas=[6, 0, 3], stretch=2,
                                          drain_chunk=8)
        out[str(where)] = (runner.stream_results(stream), state, stream,
                           {k: v for k, v in report.items()
                            if k not in ("wall_s", "warmup_s",
                                         "fused_tick")},
                           guards.books(), launch_counts()["fused_scan"])
    rows, state, stream, report, books, _ = out["cpu"]
    rows_c, state_c, stream_c, report_c, books_c, launched = out[str(dev)]
    assert rows_c == rows and report_c == report
    _leaves_equal(state_c, state)
    for x, y in zip(stream_to_numpy(stream_c), stream_to_numpy(stream)):
        assert np.array_equal(x, y)
    assert books_c == books and books_c["compiles"] == 0
    assert (launched > 0) == (megatick > 1)


def test_guards_disallow_raises_on_a_stray_sync(dev):
    """Inside an armed region of ``RuntimeGuards()`` a read of a CUDA
    tensor outside a named site raises; inside ``relaxed_site`` it is
    counted and allowed; the mode is restored after the region."""
    from chandy_lamport_tpu_torch.utils.guards import (
        RuntimeGuards,
        relaxed_site,
    )

    g = RuntimeGuards()
    x = torch.arange(4, device=dev)
    before = torch.cuda.get_sync_debug_mode()
    with g.armed():
        with pytest.raises(RuntimeError):
            int(x.sum())
        with relaxed_site(g, "probe"):
            assert int(x.sum()) == 6
    assert torch.cuda.get_sync_debug_mode() == before
    assert g.books()["transfers"] == {"probe": 1}


def test_exec_cache_restart_loads_without_nvcc(dev, tmp_path):
    """The serve-step cache on the card: a fresh cache over an empty
    directory makes the kernels ready and writes its record; a restarted
    cache over the directory finds the record and the built libraries
    ("disk") and runs no nvcc; a changed step shape is another bucket."""
    from chandy_lamport_tpu_torch.kernels import _build
    from chandy_lamport_tpu_torch.models.workloads import (
        ring_topology,
        serve_workload,
    )
    from chandy_lamport_tpu_torch.serving import ExecutableCache, serve_run

    spec = ring_topology(8, tokens=16)
    requests = serve_workload(spec, 8, seed=3, rate=1.0, max_phases=8)

    def serve(cache, stretch=2):
        runner = BatchedRunner(spec, SimConfig.for_workload(snapshots=4),
                               HashDelay(17), 4, scheduler="exact",
                               device=dev, megatick=8)
        serve_run(runner, requests, stretch=stretch, drain_chunk=8,
                  exec_cache=cache)
        return dict(cache.last)

    path = str(tmp_path / "exec")
    first = serve(ExecutableCache(path))
    builds = _build.builds
    again = serve(ExecutableCache(path))
    other = serve(ExecutableCache(path), stretch=3)
    assert first["source"] == "fresh" and first["persisted"]
    assert again["source"] == "disk" and again["builds"] == 0
    assert again["bucket"] == first["bucket"] != other["bucket"]
    assert other["source"] == "fresh" and _build.builds == builds


def test_fleet_on_the_card_equals_solo(dev, tmp_path):
    """A 2-worker ring-8 fleet whose spawned workers run on the card
    (``device=None``: the supervisor resolves the card): every request
    served once, the books balanced, every summary equal to a solo run of
    its request on the CPU (less the digest's value, which hashes the
    same knobs on both devices), and the workers' launches of rows 1, 3
    and 4 (the sync stream's kernels) in their books."""
    from chandy_lamport_tpu_torch.models.workloads import (
        ring_topology,
        serve_workload,
    )
    from chandy_lamport_tpu_torch.serving import fleet_run, recipe_runner

    recipe = {"kind": "ring-stream", "n": 8, "tokens": 16, "snapshots": 2,
              "max_recorded": 32, "batch": 2, "scheduler": "sync",
              "memo_cache": str(tmp_path / "memo.jsonl")}
    reqs = serve_workload(ring_topology(8, tokens=16), 6, seed=13,
                          rate=2.0, tenants=2, priorities=3, max_phases=4,
                          deadline_slack=(8, 64), dup_rate=0.5)
    rep = fleet_run(reqs, spool_path=str(tmp_path / "wal.jsonl"),
                    workers=2, recipe=recipe, lease_ttl=30.0,
                    max_wall_s=240)
    assert rep["device"] == "cuda" and not rep["timed_out"]
    assert rep["served"] == len(reqs)
    assert rep["audit"]["lost"] == 0 and rep["audit"]["double_served"] == 0
    solo = recipe_runner({**recipe, "memo_cache": None}, device="cpu")
    for j, row in rep["results"].items():
        pool = solo.pack_jobs([reqs[int(j)].events], content_keys=True)
        _, stream = solo.run_stream(pool, stretch=2, drain_chunk=8)
        (srow,) = solo.stream_results(stream)
        assert {k: v for k, v in row.items()
                if k not in ("digest", "served_from")} == \
            {k: v for k, v in srow.items()
             if k not in ("job", "admit_step")}, j
    books = rep["worker_books"]
    assert {b["device"] for b in books} == {"cuda"}
    for name in ("sum_by_perm", "spread", "head_fields"):
        assert sum(b["launches"][name] for b in books) > 0, name


@pytest.mark.parametrize("case", range(7))
def test_run_torch_on_the_card_equals_parity(dev, case, capsys):
    """``run --backend torch`` on the card (DenseSim at megatick 8,
    fused_scan) prints what ``run --backend parity`` prints, trace
    included, for each golden."""
    from chandy_lamport_tpu_torch.__main__ import run_cmd
    from chandy_lamport_tpu_torch.kernels import reset_launch_counts
    from chandy_lamport_tpu_torch.utils.goldens import (
        REFERENCE_TESTS,
        fixture_path,
    )

    top, events, _ = REFERENCE_TESTS[case]
    paths = [fixture_path(top), fixture_path(events)]
    assert run_cmd(paths + ["--backend", "parity", "--trace"]) == 0
    want = capsys.readouterr()
    reset_launch_counts()
    assert run_cmd(paths + ["--backend", "torch", "--trace"]) == 0
    got = capsys.readouterr()
    assert launch_counts()["fused_scan"] > 0
    assert (got.out, got.err) == (want.out, want.err)
