"""The port's CUDA kernels on the card (marker ``cuda``; skipped on a
machine without a GPU).

Each wrapper on CUDA tensors launches its hand-written kernel; it must
equal the plain PyTorch version on the same inputs bit for bit
(tolerance: none, integer work), refuse operands it does not take, take
more lanes than a grid's y axis holds (append_rows), and small sync,
exact and faulted exact storms on the card must equal the same storms on
the CPU. Run on a
GPU machine with ``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

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
    args = (q_head, q_len, tok, active, pack_meta(rt, 0), rt, data)
    got = kq.append_rows(q_meta.clone(), q_data.clone(), *args, capacity=C,
                         key_limit=50)
    want = kq.append_rows_plain(q_meta.clone(), q_data.clone(), *args,
                                capacity=C, key_limit=50)
    _equal(got, want)
    assert int(got[2].max()) > 0          # full rings and tok >= 50 flag


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
    args = (ints((b, e), 0, c), q_len, ints((b, e), 0, 50),
            torch.ones((b, e), dtype=torch.bool, device=dev),
            pack_meta(rt, 0), rt, ints((b, e), 1, 9))
    got = kq.append_rows(q_meta.clone(), q_data.clone(), *args, capacity=c,
                         key_limit=1 << 20)
    want = kq.append_rows_plain(q_meta.clone(), q_data.clone(), *args,
                                capacity=c, key_limit=1 << 20)
    _equal(got, want)
    flagged = (got[2] & 1).nonzero().flatten()
    assert torch.equal(flagged.cpu(), torch.arange(0, b, 3))


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
            HashDelay(5), 4, device=device)
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
