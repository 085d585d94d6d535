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


def or_reduce(mask):
    """Bitwise OR of an int32 bitmask over all elements (0-d int64)."""
    flat = mask.reshape(-1).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    bits = ((flat.unsqueeze(-1) >> shifts) & 1).any(0)
    return (bits.to(torch.int64) << shifts).sum()
