"""The one-launch append (row 5) on the CPU: ``append_rows`` and
``append_marker_rows`` against the JAX package.

The reference is what the JAX ``TickKernel._append_rows`` does with the
Pallas kernel (``chandy_lamport_tpu/ops/tick.py:1111-1170``): the Pallas
``append_rows`` in interpret mode, ``jax.vmap``ped over the lanes, then
the caller's elementwise adds of ``q_len`` and ``tok_pushed`` and its OR
of the lane's error bits; the port does all of it in one call, in place.
The marker broadcast's routed form is held to the same reference on the
rows it routes. Inputs are numpy-seeded; tolerance: none (integer work).
The launch set-up's checks and strides (``_append_args``) are pure
Python over operand signatures and run here too; the kernels themselves
run on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import numpy as np
import pytest
import torch

from chandy_lamport_tpu.kernels import queue as pl_queue
from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
from chandy_lamport_tpu_torch.core.state import (
    ERR_QUEUE_OVERFLOW,
    ERR_VALUE_OVERFLOW,
    RTIME_PACK_LIMIT,
    DenseTopology,
    pack_meta,
)
from chandy_lamport_tpu_torch.kernels import queue as t_queue
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.delay import HashDelay

TOPO = DenseTopology(workloads.scale_free(24, 2, seed=5, tokens=40))
E, N = TOPO.e, TOPO.n
C = 8
KEY_LIMIT = 1000
SRC_LO = np.searchsorted(TOPO.edge_src, np.arange(N), "left").astype(np.int32)
SRC_HI = np.searchsorted(TOPO.edge_src, np.arange(N), "right").astype(
    np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _state(rng, b):
    """Rings on the wrap / full / marker-at-head / random regimes (lanes
    0-3 and on), push counters below the key limit and error words with
    bits already set on odd lanes."""
    q_meta = pack_meta(rng.integers(0, 50, (b, E, C)),
                       rng.random((b, E, C)) < 0.2).astype(np.int32)
    q_data = rng.integers(-1000, 1000, (b, E, C), dtype=np.int32)
    q_head = rng.integers(0, C, (b, E), dtype=np.int32)
    q_len = rng.integers(0, C, (b, E), dtype=np.int32)
    q_head[0], q_len[0] = C - 1, 2
    q_head[1], q_len[1] = 1, C
    q_head[2], q_len[2] = C - 1, 2
    q_meta[2, :, C - 1] = pack_meta(1, True)
    pushed = rng.integers(0, KEY_LIMIT, (b, E), dtype=np.int32)
    error = np.where(np.arange(b) % 2 == 1, 8, 0).astype(np.int32)
    return q_meta, q_data, q_head, q_len, pushed, error


def _reference(q_meta, q_data, q_head, q_len, pushed, error, active, rt,
               marker, data, flag=True):
    """The JAX caller's append: the Pallas kernel, then its adds and OR."""
    b = q_head.shape[0]
    active = np.broadcast_to(active, (b, E))
    rt = np.broadcast_to(rt, (b, E)).astype(np.int32)
    data = np.broadcast_to(data, (b, E)).astype(np.int32)
    meta = pack_meta(rt, np.broadcast_to(marker, (b, E))).astype(np.int32)
    m, d, err = jax.vmap(lambda *a: pl_queue.append_rows(
        *a, capacity=C, key_limit=KEY_LIMIT, flag_queue_overflow=flag,
        interpret=True))(q_meta, q_data, q_head, q_len, pushed,
                         np.ascontiguousarray(active), meta, rt, data)
    step = active.astype(np.int32)
    return (np.asarray(m), np.asarray(d), q_len + step, pushed + step,
            error | np.asarray(err)[:, 0])


def _port(leaves, *row_args, flag=True):
    return t_queue.append_rows(*(_t(x) for x in leaves), *row_args,
                               capacity=C, key_limit=KEY_LIMIT,
                               flag_queue_overflow=flag)


def _same(want, got):
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        assert np.asarray(w).dtype == g.numpy().dtype


@pytest.mark.parametrize("marker", ["token", "marker", "mask"])
@pytest.mark.parametrize("flag", [True, False])
def test_plain_equals_jax_append_and_the_callers_adds(marker, flag):
    """Partially active rows on every ring regime, with a scalar marker
    bit of either value or a per-row mask: planes, counters and error
    words equal the JAX caller's, the error bits set before kept."""
    rng = np.random.default_rng(11)
    b = 6
    leaves = _state(rng, b)
    active = rng.random((b, E)) < 0.5
    rt = rng.integers(1, 60, (b, E), dtype=np.int32)
    data = rng.integers(1, 9, (b, E), dtype=np.int32)
    mk = {"token": False, "marker": True,
          "mask": rng.random((b, E)) < 0.5}[marker]
    want = _reference(*leaves, active, rt, mk, data, flag)
    got = _port(leaves, _t(active), _t(rt),
                _t(mk) if marker == "mask" else mk, _t(data), flag=flag)
    _same(want, got)


def test_overflow_bits():
    """A full ring (lane 1), a push counter at the merge-key bound (lane
    3) and a receive time at the packed-rtime bound (lane 4) set their
    bits; a lane without either sets none; the slots are written anyway,
    as the Pallas kernel writes them."""
    rng = np.random.default_rng(12)
    b = 6
    q_meta, q_data, q_head, q_len, pushed, _ = _state(rng, b)
    error = np.zeros(b, np.int32)
    active = np.ones((b, E), bool)
    rt = rng.integers(1, 60, (b, E), dtype=np.int32)
    pushed[1] = 0
    pushed[3, 5] = KEY_LIMIT
    rt[4, 7] = RTIME_PACK_LIMIT
    q_len[3:] = 0
    leaves = (q_meta, q_data, q_head, q_len, pushed, error)
    data = np.full((b, E), 3, np.int32)
    want = _reference(*leaves, active, rt, False, data)
    got = _port(leaves, _t(active), _t(rt), False, _t(data))
    _same(want, got)
    bits = got[4].tolist()
    assert bits[1] == ERR_QUEUE_OVERFLOW
    assert bits[3] == ERR_VALUE_OVERFLOW and bits[4] == ERR_VALUE_OVERFLOW
    assert bits[5] == 0


def test_masked_and_inactive_lanes_are_left_as_they_were():
    """A lane with no active row (lane 2) and rows outside the mask keep
    their slots, counters and error word; expanded operands (an [E] send
    shared by every lane, a [B] payload) read as the dense ones do."""
    rng = np.random.default_rng(13)
    b = 5
    leaves = _state(rng, b)
    amounts = rng.integers(0, 3, E).astype(np.int32)
    lanes = np.array([True, True, False, True, False])
    active = (amounts > 0)[None, :] & lanes[:, None]
    rt = rng.integers(1, 60, (b, E), dtype=np.int32)
    got = _port(leaves, _t(active), _t(rt), False,
                _t(amounts).expand(b, -1))
    want = _reference(*leaves, active, rt, False, amounts)
    _same(want, got)
    kept = leaves[:2] + leaves[3:]     # the leaves returned: no q_head
    for lane in (2, 4):
        for before, after in zip(kept, got):
            np.testing.assert_array_equal(before[lane], after[lane].numpy())
    payload = rng.integers(0, 4, b).astype(np.int32)
    leaves = _state(rng, b)
    got = _port(leaves, _t(active), _t(rt), True,
                _t(payload).unsqueeze(-1).expand(b, E))
    _same(_reference(*leaves, active, rt, True, payload[:, None]), got)


@pytest.mark.parametrize("seed", [21, 22])
def test_marker_rows_route_each_lanes_node(seed):
    """``append_marker_rows``: each masked lane's node sends on its
    out-edges in dest order, the k-th at the row's k-th receive time,
    with the lane's payload; held to the JAX append on the rows it routes
    (a lane outside the mask, a node with no out-edge beyond its first
    ordinals, the hub)."""
    rng = np.random.default_rng(seed)
    b = 6
    leaves = _state(rng, b)
    d = int((SRC_HI - SRC_LO).max())
    node = rng.integers(0, N, b).astype(np.int32)
    node[0] = int(np.argmax(SRC_HI - SRC_LO))
    mask = np.array([True, True, False, True, True, True])
    rt_k = rng.integers(1, 60, (b, d), dtype=np.int32)
    payload = rng.integers(0, 4, b).astype(np.int32)
    active = np.zeros((b, E), bool)
    rt = np.zeros((b, E), np.int32)
    for lane in range(b):
        lo, hi = SRC_LO[node[lane]], SRC_HI[node[lane]]
        if mask[lane]:
            active[lane, lo:hi] = True
            rt[lane, lo:hi] = rt_k[lane, :hi - lo]
    want = _reference(*leaves, active, rt, True, payload[:, None])
    got = t_queue.append_marker_rows(
        *(_t(x) for x in leaves), _t(node), _t(mask), _t(rt_k), _t(payload),
        _t(SRC_LO), _t(SRC_HI), capacity=C, key_limit=KEY_LIMIT)
    _same(want, got)


def test_launch_setup_checks_and_strides():
    """The cached set-up of a launch reads each per-row operand through
    its strides (an [E] operand expanded over the lanes has lane stride 0,
    a [B] payload edge stride 0) and refuses a counter that is not
    contiguous, a wrong dtype and planes of another capacity, naming the
    operand."""
    b = 4
    planes = torch.zeros((b, E, C), dtype=torch.int32)
    rows = torch.zeros((b, E), dtype=torch.int32)
    err = torch.zeros(b, dtype=torch.int32)
    amounts = torch.ones(E, dtype=torch.int32)
    payload = torch.ones(b, dtype=torch.int32)
    ops = (amounts.expand(b, -1) > 0, rows, payload.unsqueeze(-1).expand(
        b, E))
    sigs = tuple(t_queue._sig(t) for t in (planes, planes, rows, rows, rows,
                                           err) + ops)
    args = t_queue._append_args(False, C, KEY_LIMIT, True, False, sigs)
    assert (args.act_sb, args.act_se) == (E, 1)   # the mask is computed
    assert (args.data_sb, args.data_se) == (1, 0)
    assert (args.b, args.e, args.c, args.width, args.mk_all) == (b, E, C, E,
                                                                 0)
    sigs_x = tuple(t_queue._sig(t) for t in (planes, planes, rows, rows,
                                             rows, err)
                   + (ops[0], rows, amounts.expand(b, -1)))
    args = t_queue._append_args(False, C, KEY_LIMIT, True, True, sigs_x)
    assert (args.data_sb, args.data_se, args.mk_all) == (0, 1, 1)
    bad = [(3, rows.t().contiguous().t(), "q_len"),
           (5, err.to(torch.int64), "error"),
           (0, torch.zeros((b, E, C + 1), dtype=torch.int32), "planes")]
    for at, t, name in bad:
        wrong = list(sigs)
        wrong[at] = t_queue._sig(t)
        with pytest.raises(ValueError, match=name):
            t_queue._append_args(False, C, KEY_LIMIT, True, False,
                                 tuple(wrong))


@pytest.mark.parametrize("scheduler,megatick", [("sync", 1), ("exact", 1),
                                                ("exact", 4)])
def test_callers_state_is_left_unchanged(scheduler, megatick):
    """The appends write in place, so a caller that does not own a state
    must not see it change: the runner's entry points own a copy
    (``BatchedRunner._own``), and the state handed to ``run_storm`` is
    unchanged in every leaf after the storm, while the storm itself sent,
    broadcast and advanced its counters."""
    runner = BatchedRunner(workloads.ring_topology(8),
                           SimConfig(max_snapshots=2), HashDelay(3), 3,
                           scheduler=scheduler, device="cpu",
                           megatick=megatick)
    prog = workloads.storm_program(runner.topo, 6, 1,
                                   workloads.staggered_snapshots(
                                       runner.topo, 2, 1, 1, max_phases=6))
    s0 = runner.init_batch_device()
    before = [x.clone() for x in _flat(s0)]
    end = runner.run_storm(s0, prog)
    for x, y in zip(before, _flat(s0)):
        assert torch.equal(x, y)
    assert int(end.tok_pushed.sum()) > 0 and int(end.completed.sum()) > 0


def _flat(state):
    out = []
    for leaf in state:
        out.extend(leaf if isinstance(leaf, tuple) else [leaf])
    return out
