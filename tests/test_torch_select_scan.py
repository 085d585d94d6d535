"""A numpy model of the selection walk of ``queue_step`` and ``select_pop``
(Pallas rows 6 and 7, ``csrc/queue.cu``), held to the JAX Pallas kernels.

The CUDA kernel runs only on the card; its walk is rehearsed here step by
step as the kernel takes it: a lane's edges cut into tiles of T =
threads x items, block k owning the edges whose segment starts in [k T,
(k + 1) T) (read off ``src_first`` alone) and scanning from k T, tile by
tile, while the next tile's first edge is its own; thread ``tid`` taking
the striped items ``base + j * threads + tid``; the eligibility ballot of
each warp and the highest set bit below a thread's lane; one word a chunk
of 32 edges, scanned by warp 0 with ``__shfl_up_sync`` steps into each
chunk's "last eligible edge before it"; the running maximum carried from
tile to tile. An edge is selected when it is eligible and the last
eligible edge before it lies before its ``src_first``.

The model runs at the kernel's tile (256 threads x ceil(E / 256) items,
at most 4) and at tiles of 32 and 256 edges, on the real cells' source
layouts (ER-256, SF-1k) and on ``chip_smoke.SELECT_LAYOUTS`` (a
2,500-edge source across three 1,024-edge tiles, segments across every
boundary the grid draws, sources of out-degree 0, E below 32 and off
every multiple of 32, one lane, no edges). Its outputs must equal the
Pallas ``queue_step`` / ``select_pop`` in interpret mode, ``jax.vmap``ped
over the lanes, bit for bit (tolerance: none, integer work), and it must
write every edge exactly once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from chandy_lamport_tpu.kernels import queue as pl_queue
from chandy_lamport_tpu_torch.core.state import DenseTopology
from chandy_lamport_tpu_torch.models.workloads import erdos_renyi, scale_free

WARP = 32
THREADS = 256   # csrc/queue.cu kThreads
CAPACITY = 24


def kernel_items(e: int) -> int:
    """The kernel's items a thread (``launch_select``)."""
    return 4 if e > 3 * THREADS else max(1, -(-e // THREADS))


def _top_bit(x):
    """31 - __clz(x) for uint32 words (-1 for 0), elementwise."""
    x = np.asarray(x, np.uint64)
    return np.where(x > 0, np.frexp(x.astype(np.float64))[1] - 1, -1)


def _shfl_up(v, d):
    """__shfl_up_sync over one warp: lane l reads lane l - d, lanes below d
    their own value."""
    return np.concatenate([v[:d], v[:-d]])


def select_walk(elig, src_first, threads, items):
    """The kernel's walk over one lane: (sel [E] bool, the writes of each
    edge [E] int)."""
    e = len(src_first)
    tile = threads * items
    chunks = tile // WARP
    assert chunks <= WARP
    sel = np.zeros(e, bool)
    writes = np.zeros(e, np.int64)
    lane_bits = np.uint64(1) << np.arange(WARP, dtype=np.uint64)

    def owned(edge, lo):
        first = np.where(edge < e, src_first[np.minimum(edge, e - 1)], -1)
        # (uint32)first - (uint32)lo < tile
        off = (first.astype(np.int64) - lo) % 2**32
        return (edge < e) & (off < tile), first

    for k in range(-(-e // tile)):
        lo = k * tile
        carry = -1
        base = lo
        while True:
            # position p = j * threads + tid, in edge order: chunk p // 32
            edge = base + np.arange(tile)
            own, first = owned(edge, lo)
            nxt = base + tile
            more = bool(nxt < e and owned(np.array([nxt]), lo)[0][0])
            el = own & elig[np.minimum(edge, max(e - 1, 0))]
            ballot = (el.reshape(chunks, WARP) * lane_bits).sum(1)
            top = _top_bit(ballot)
            chunk_last = np.where(ballot > 0,
                                  base + np.arange(chunks) * WARP + top, -1)
            # warp 0: inclusive max-scan of the chunk words, then shifted
            v = np.full(WARP, -1, np.int64)
            v[:chunks] = chunk_last
            for d in (1, 2, 4, 8, 16):
                u = _shfl_up(v, d)
                v = np.where(np.arange(WARP) >= d, np.maximum(v, u), v)
            before = _shfl_up(v, 1)
            before[0] = -1
            chunk_before = np.maximum(before[:chunks], carry)
            carry = max(carry, int(v[WARP - 1]))
            ln = np.arange(tile) % WARP
            below = ballot[np.arange(tile) // WARP] & (
                (np.uint64(1) << ln.astype(np.uint64)) - np.uint64(1))
            last = np.where(below > 0,
                            base + (np.arange(tile) // WARP) * WARP
                            + _top_bit(below),
                            chunk_before[np.arange(tile) // WARP])
            s = el & (last < first)
            sel[edge[own]] = s[own]
            writes[edge[own]] += 1
            if not more:
                break
            base += tile
    return sel, writes


def model_queue_step(q_meta, q_data, q_head, q_len, time, src_first, threads,
                     items):
    """The kernel's outputs of ``queue_step`` from the walk: (tok, mk,
    head_data, new_head, new_len), and the writes an edge."""
    lanes = q_head.shape[0]
    meta = np.take_along_axis(q_meta, q_head[..., None], -1)[..., 0]
    data = np.take_along_axis(q_data, q_head[..., None], -1)[..., 0]
    elig = (q_len > 0) & ((meta >> 1) <= time[:, None])
    out = [np.zeros(q_head.shape, bool), np.zeros(q_head.shape, bool)]
    writes = np.zeros(q_head.shape, np.int64)
    for b in range(lanes):
        sel, writes[b] = select_walk(elig[b], src_first, threads, items)
        out[0][b] = sel & ((meta[b] & 1) == 0)
        out[1][b] = sel & ((meta[b] & 1) == 1)
    sel_i = (out[0] | out[1]).astype(np.int32)
    return (out[0], out[1], data, (q_head + sel_i) % CAPACITY,
            q_len - sel_i), writes


def model_select_pop(q_head, q_len, elig, src_first, threads, items):
    """The kernel's (sel, new_head, new_len) of ``select_pop``, and the
    writes an edge."""
    sel = np.zeros(q_head.shape, bool)
    writes = np.zeros(q_head.shape, np.int64)
    for b in range(q_head.shape[0]):
        sel[b], writes[b] = select_walk(elig[b], src_first, threads, items)
    sel_i = sel.astype(np.int32)
    return (sel, (q_head + sel_i) % CAPACITY, q_len - sel_i), writes


def _degrees(topo):
    return np.bincount(topo.edge_src, minlength=topo.n).tolist()


@functools.cache
def _layout(name):
    """(degrees, lanes) of a layout."""
    if name == "er256":
        return _degrees(DenseTopology(erdos_renyi(256, 3.0, seed=3))), 3
    if name == "sf1k":
        return _degrees(DenseTopology(scale_free(1024, 2, seed=3))), 3
    return chip_smoke.SELECT_LAYOUTS[name]


@functools.cache
def _case(name):
    """The layout's inputs and the Pallas outputs of both kernels."""
    degrees, lanes = _layout(name)
    ins = chip_smoke.select_inputs(degrees, lanes, CAPACITY, seed=7)
    q_meta, q_data, q_head, q_len, time, elig, first = ins[:7]
    if len(first) == 0:
        # the Pallas call refuses a zero-size block: with no edges both
        # kernels return empty rows
        empty = np.zeros((lanes, 0), np.int32)
        return ins, ((empty.astype(bool),) * 2 + (empty,) * 3,
                     (empty.astype(bool), empty, empty))
    step = jax.vmap(lambda m, d, h, n, t: pl_queue.queue_step(
        m, d, h, n, t, jnp.asarray(first), capacity=CAPACITY,
        interpret=True))(q_meta, q_data, q_head, q_len, time)
    pop = jax.vmap(lambda h, n, el: pl_queue.select_pop(
        h, n, el, jnp.asarray(first), capacity=CAPACITY,
        interpret=True))(q_head, q_len, elig)
    return ins, (tuple(np.asarray(x) for x in step),
                 tuple(np.asarray(x) for x in pop))


LAYOUTS = ("long", "mid", "ragged", "one-lane", "empty", "er256", "sf1k")


@pytest.mark.parametrize("tile", ["32", "256", "kernel"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kernel", ["queue_step", "select_pop"])
def test_walk_matches_pallas(kernel, layout, tile):
    """The walk at the kernel's tile and at tiles of 32 and 256 edges
    equals the Pallas kernel on every output, writes each edge once, and
    keeps at most one edge a source."""
    ins, (want_step, want_pop) = _case(layout)
    q_meta, q_data, q_head, q_len, time, elig, first = ins[:7]
    e = len(first)
    threads, items = {"32": (WARP, 1), "256": (THREADS, 1),
                      "kernel": (THREADS, kernel_items(e))}[tile]
    if kernel == "queue_step":
        got, writes = model_queue_step(q_meta, q_data, q_head, q_len, time,
                                       first, threads, items)
        want = want_step
        sel = got[0] | got[1]
    else:
        got, writes = model_select_pop(q_head, q_len, elig, first, threads,
                                       items)
        want = want_pop
        sel = got[0]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)
    assert (writes == 1).all()
    per_source = np.zeros((q_head.shape[0], e), np.int64)
    for b, row in enumerate(sel):
        np.add.at(per_source[b], first, row)
    assert per_source.max(initial=0) <= 1


def test_kernel_tiles_cover_the_layouts():
    """The kernel's tile at each layout, and the long layout's 2,500-edge
    source longer than it and across its boundaries, so the carry and the
    owner-less blocks are walked."""
    tiles = {n: THREADS * kernel_items(sum(_layout(n)[0])) for n in LAYOUTS}
    assert tiles == {"long": 1024, "mid": 512, "ragged": 256,
                     "one-lane": 256, "empty": 256, "er256": 768,
                     "sf1k": 1024}
    degrees = np.asarray(_layout("long")[0])
    start = int(np.cumsum(degrees)[np.argmax(degrees) - 1])
    assert degrees.max() >= 600 and degrees.max() > tiles["long"]
    assert start // 1024 < (start + degrees.max() - 1) // 1024 - 1
    # the real cells' segments fit in a warp: the layouts above make the
    # long ones
    assert max(_layout("er256")[0]) == 8 and max(_layout("sf1k")[0]) == 3
