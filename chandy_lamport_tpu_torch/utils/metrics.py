"""Invariants and aggregate counters over a batched state (the JAX
package's ``utils/metrics.py``). Every function reduces over all lanes
unless its name says per lane; results are tensors on the state's
device (sums of int32 leaves come back as int64, exact)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.state import DenseState


def _occupied(state: DenseState, cfg: SimConfig):
    """Live ring slots: positions head..head+len-1 (torch's % floors, as
    jnp's does, so the negative differences wrap the same way)."""
    c = cfg.queue_capacity
    cc = torch.arange(c, dtype=torch.int32, device=state.q_head.device)
    return ((cc - state.q_head.unsqueeze(-1)) % c) < state.q_len.unsqueeze(-1)


def _lane_in_flight(state: DenseState, cfg: SimConfig):
    """[B]: tokens in each lane's channels (live non-marker ring slots)."""
    occ = _occupied(state, cfg) & ((state.q_meta & 1) == 0)
    return torch.where(occ, state.q_data, 0).sum(dim=(-2, -1))


def lane_total_tokens(state: DenseState, cfg: SimConfig):
    """[B]: each lane's node balances + in-flight tokens."""
    return state.tokens.sum(-1) + _lane_in_flight(state, cfg)


def in_flight_tokens(state: DenseState, cfg: SimConfig):
    """Total tokens inside channels, all lanes."""
    return _lane_in_flight(state, cfg).sum()


def total_tokens(state: DenseState, cfg: SimConfig):
    """Node balances + in-flight tokens — the conserved quantity."""
    return lane_total_tokens(state, cfg).sum()


def conservation_delta(state: DenseState, cfg: SimConfig,
                       expected_total: int):
    """0 iff conservation holds; ``expected_total`` is the initial tokens
    summed over the lanes. The injected fault delta is subtracted."""
    return (total_tokens(state, cfg) - expected_total
            - state.fault_skew.sum())


def snapshot_lifecycle(state: DenseState, num_nodes: int) -> Dict:
    """Initiated / completed / retried / failed / aborted / stale markers
    and the worst lane's recovery-line age (-1 until a snapshot
    completed)."""
    started = state.started
    complete = started & (state.completed >= num_nodes)
    done_t = torch.where(complete, state.snap_done_time, -1)
    any_done = complete.any(-1)
    age = torch.where(any_done, state.time - done_t.amax(-1), -1)
    retried = state.snap_retries.sum()
    failed = state.snap_failed.sum()
    return {
        "initiated": started.sum(),
        "completed": complete.sum(),
        "retried": retried,
        "failed": failed,
        "aborted": retried + failed,
        "stale_markers": state.stale_markers.sum(),
        "recovery_line_age_max": age.max(),
    }


def progress_counters(state: DenseState, cfg: SimConfig,
                      num_nodes: int) -> Dict:
    """Aggregate lifecycle counters."""
    started = state.started
    complete = started & (state.completed >= num_nodes)
    # a window's length, subtracted in the window dtype (uint16's modular
    # wrap recovers it, as the JAX counter does): the int16 bits of a
    # uint16 plane widen, subtract and keep 16 bits
    live_end = torch.where(state.recording,
                           state.rec_cnt.unsqueeze(-2).to(
                               state.rec_end.dtype), state.rec_end)
    lengths = live_end.to(torch.int32) - state.rec_start.to(torch.int32)
    if state.rec_start.dtype == torch.int16:
        lengths = lengths & 0xFFFF
    return {
        "time_total": state.time.sum(),
        "time_max": state.time.max(),
        "queued_messages": state.q_len.sum() + state.m_pending.sum(),
        "snapshots_started": started.sum(),
        "snapshots_completed": complete.sum(),
        "snapshots_pending": (started & ~complete).sum(),
        "nodes_finalized": state.done_local.sum(),
        "recorded_messages": lengths.sum(),
        "error_bits": or_reduce(state.error),
    }


def straggler_waste(state: DenseState):
    """Fraction of the batch's tick budget spent waiting for the slowest
    lane: ``1 - mean(time) / max(time)`` (0 when nothing ticked)."""
    t = state.time.to(torch.float32)
    mx = t.max()
    return torch.where(mx > 0, 1.0 - t.mean() / torch.clamp(mx, min=1.0),
                       torch.zeros_like(mx))


def stream_occupancy(stream) -> float:
    """Fraction of lane-steps that held a live job during a
    ``run_stream`` drive (the JAX ``stream_occupancy``; one lane-step =
    one slot for one stream step): 1.0 means every slot held working
    jobs the whole run."""
    total = int(stream.lane_steps_total)
    return float(int(stream.lane_steps_live)) / total if total else 0.0


def stream_counters(stream) -> Dict[str, Any]:
    """Host-side scalars of a ``StreamState`` (the JAX
    ``stream_counters``): jobs admitted and harvested, refills
    (admissions into a recycled slot), occupancy (live lane-steps over
    charged ones) and the straggler-wasted lane-steps, beside the memo
    and prefix books and the serving books (zeros: serving is not
    ported)."""
    total = int(stream.lane_steps_total)
    live = int(stream.lane_steps_live)
    done = int(stream.jobs_done)
    hits = int(stream.cache_hits)
    coalesced = int(stream.coalesced_jobs)
    served = done + hits + coalesced
    forked = int(stream.forked_jobs)
    depth = int(stream.fork_depth_sum)
    return {
        "steps": int(stream.steps),
        "jobs_admitted": int(stream.next_job),
        "jobs_done": done,
        "refills": int(stream.refills),
        "occupancy": round(live / total, 4) if total else 0.0,
        "lane_steps_live": live,
        "lane_steps_total": total,
        "straggler_wasted_steps": total - live,
        "cache_hits": hits,
        "coalesced_jobs": coalesced,
        "ff_skipped_ticks": int(stream.ff_skipped_ticks),
        "shadow_checks": int(stream.shadow_checks),
        "memo_hit_rate": (round((hits + coalesced) / served, 4)
                          if served else 0.0),
        "prefix_hits": int(stream.prefix_hits),
        "forked_jobs": forked,
        "fork_depth_sum": depth,
        "fork_depth_mean": round(depth / forked, 4) if forked else 0.0,
        "deadline_misses": int(stream.deadline_misses),
        "tenant_served": [int(x) for x in stream.tenant_served.tolist()],
        "tenant_quota": [int(x) for x in stream.tenant_quota.tolist()],
    }


def instance_footprint_bytes(num_nodes: int, num_edges: int,
                             cfg: SimConfig) -> int:
    """Per-instance device bytes of a DenseState excluding the delay
    state (the JAX formula): 8·E·C + (24 + rec·L)·E + 4·N + S·(22 + 10·N
    + (10+2·win)·E) + 12·K + 12, K the flight recorder's
    ``trace_capacity`` (three int32 planes of K slots)."""
    n, e = num_nodes, num_edges
    c, s, m = cfg.queue_capacity, cfg.max_snapshots, cfg.max_recorded
    rec = np.dtype(cfg.record_dtype).itemsize
    win = np.dtype(cfg.window_dtype).itemsize
    queues = e * c * (4 + 4) + e * (4 + 4 + 4 + 4)
    nodes = 4 * n
    rec_log = e * (4 + 4) + rec * m * e
    snaps = s * (1 + n * (1 + 4 + 4 + 1)
                 + e * (1 + win * 2) + e * (1 + 4 + 4)
                 + 5 * 4 + 1)
    scalars = 4 * 3 + 4 * 10 + s * 4 + 4 * 3 + 4
    trace = 12 * cfg.trace_capacity + 8   # the ring, tr_count / tr_on
    return queues + nodes + rec_log + snaps + scalars + trace


def max_batch_estimate(num_nodes: int, num_edges: int, cfg: SimConfig,
                       hbm_bytes: int, working_set_factor: float = 2.0) -> int:
    """Instances that fit one card's device memory (the JAX
    ``max_batch_estimate``): capacity / (footprint x factor), the factor
    covering a second live copy of the state (2.0, as in JAX)."""
    per = instance_footprint_bytes(num_nodes, num_edges, cfg)
    return max(1, int(hbm_bytes / (per * working_set_factor)))


def comm_bytes_model(num_nodes: int, max_snapshots: int, shards: int,
                     halo_rows: int, cut_edges: int | None = None,
                     cut_rows: int | None = None,
                     count_bytes: int = 4) -> Dict[str, Any]:
    """Per-shard, per-tick cross-shard payload bytes of the graph-sharded
    runner's two comm engines (the JAX ``comm_bytes_model``, the same
    numbers for the same arguments; parallel/graphshard.py):

      dense  = 4*N credit sums + cb*S*N marker-arrival sums (``count_bytes``)
             + S*N created-flags gather (bool) + 4*S finalization sum
      sparse = (P-1) * ((S+1)*H*4 forward rows, int32 + S*H reverse
               rows, bool) + 4*S finalization sum

    H = ``halo_rows``, the most boundary rows one shard owes another
    (parallel/mesh.BoundaryTables): sparse scales with the partition's
    cut, dense with N. The error-bit folds are the same on both sides and
    left out. ``cut_edges`` / ``cut_rows`` ride along when known."""
    n, s, p, h = num_nodes, max_snapshots, shards, halo_rows
    neighbors = max(p - 1, 0)
    dense = 4 * n + count_bytes * s * n + s * n + 4 * s
    sparse = neighbors * ((s + 1) * h * 4 + s * h) + 4 * s
    out: Dict[str, Any] = {
        "dense_bytes_per_tick": int(dense),
        "sparse_bytes_per_tick": int(sparse),
        "halo_rows": int(h),
        "neighbors": int(neighbors),
        "sparse_over_dense": round(sparse / dense, 4) if dense else 0.0,
    }
    if cut_edges is not None:
        out["cut_edges"] = int(cut_edges)
    if cut_rows is not None:
        out["cut_rows"] = int(cut_rows)
    return out


def tick_cost_model(num_nodes: int, num_edges: int, cfg: SimConfig,
                    batch: int = 1,
                    queue_engine: str = "gather") -> Dict[str, Any]:
    """Analytic per-tick cost of the dense engine at a bench shape (the
    JAX ``tick_cost_model``, the same numbers for the same arguments):
    ``hbm_bytes_per_tick`` = 2 x instance_footprint_bytes x batch (every
    state leaf read and written once a tick), ``elem_ops_per_tick`` the
    queue engine's head touch ("gather": ~4 x E element ops a lane,
    "mask": 2 x E x C) x batch. The bench rows carry it with the runner's
    resolved ``queue_engine`` (the port's is "gather")."""
    per = instance_footprint_bytes(num_nodes, num_edges, cfg)
    e, c = num_edges, cfg.queue_capacity
    elem = (2 * e * c if queue_engine == "mask" else 4 * e) * batch
    return {
        "instance_bytes": int(per),
        "hbm_bytes_per_tick": int(2 * per * batch),
        "elem_ops_per_tick": int(elem),
        "queue_engine": queue_engine,
        "batch": int(batch),
    }


def or_reduce(mask):
    """Bitwise OR of an int32 bitmask over all elements (0-d int64)."""
    flat = mask.reshape(-1).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    bits = ((flat.unsqueeze(-1) >> shifts) & 1).any(0)
    return (bits.to(torch.int64) << shifts).sum()
