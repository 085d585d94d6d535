"""Static capacities and knobs of the PyTorch port.

A copy of the JAX package's ``config.py`` cut to what the ported paths
(the sync and exact batch storms, the golden driver, the snapshot
supervisor of the exact scheduler, the flight recorder) read. The
capacities bound every
structure the Go reference grows dynamically (per-link queues, snapshot
slots, recorded-message logs), so the state is fixed-shape tensors on the
device. The supervisor knobs (``snapshot_timeout``, ``snapshot_retries``,
``snapshot_every``) and the flight recorder's ``trace_capacity`` mean
what they mean in the JAX config. The JAX config's engine knobs
(``count_dtype``, ``reduce_mode``, ``comm_engine``, ``kernel_engine``,
``fused_tick``, ``fused_tile``) are fields here too, in the JAX order and
with its spellings and messages; ``ops/tick.TickKernel`` resolves each to
what the port runs and says why (``resolve_knobs``).
"""

import dataclasses

# Max random delay added to packet delivery: receive_time = time + 1 +
# Intn(MAX_DELAY) (reference sim.go:10, sim.go:100-102).
MAX_DELAY = 5

# Fixed seed of the reference test suite (reference snapshot_test.go:9,20:
# rand.Seed(seed + 1)).
REFERENCE_TEST_SEED = 8053172852482175523

# the engine knobs' spellings (the JAX ``ENGINE_KNOBS`` rows, in its
# order, that the port's config and constructors validate against)
ENGINE_KNOBS = {
    "queue_engine": ("auto", "gather", "mask"),
    "comm_engine": ("auto", "dense", "sparse"),
    "kernel_engine": ("auto", "xla", "pallas"),
    # explicit policies, not "auto"-first: resolution is validation
    # (utils/memocache.resolve_memo, serving/admission.resolve_serve_policy)
    "memo": ("off", "admit", "full", "prefix"),
    "serve_policy": ("edf", "fifo"),
    "fused_tick": ("auto", "on", "off"),
    "fused_tile": ("auto", "on", "off"),
}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static capacities; field meanings match the JAX ``SimConfig``."""

    queue_capacity: int = 16       # per-edge ring buffer slots (C)
    max_snapshots: int = 16        # concurrent snapshot slots (S)
    max_recorded: int = 32         # per-edge recorded-arrival log slots (L)
    max_delay: int = MAX_DELAY
    max_ticks: int = 100_000       # drain-loop budget
    record_dtype: str = "int32"    # dtype of log_amt[L, E]
    # dtype of rec_start/rec_end [S, E]: "uint16" keeps the window
    # counters modulo 2^16 (a window's length is bounded by max_recorded,
    # and L divides 2^16, so the modular decode equals the absolute one);
    # the port stores them as int16 tensors holding the uint16 bits
    # (core/state.py), uint16 on the host
    window_dtype: str = "int32"
    # the JAX engine knobs (ops/tick.resolve_knobs): count_dtype and
    # reduce_mode pick the JAX reduction (equal in result); the port
    # reduces through its segment kernels. comm_engine is the graph-sharded
    # runner's (stored). kernel_engine: the port has one engine. fused_tick
    # and fused_tile: the fused megatick and its layout
    # (kernels/megatick.resolve_fused)
    count_dtype: str = "auto"
    reduce_mode: str = "auto"
    comm_engine: str = "auto"
    kernel_engine: str = "auto"
    fused_tick: str = "auto"
    fused_tile: str = "auto"
    # snapshot supervisor: an attempt not complete within snapshot_timeout
    # ticks of its (re-)initiation is aborted and re-initiated under a new
    # epoch, the deadline doubling per retry (capped at 16x); after
    # snapshot_retries failed attempts the slot fails with
    # ERR_SNAPSHOT_TIMEOUT. 0 = off.
    snapshot_timeout: int = 0
    snapshot_retries: int = 3
    # snapshot daemon: initiate a snapshot every snapshot_every ticks from
    # a rotating initiator while free slots remain. 0 = off.
    snapshot_every: int = 0
    # flight recorder (utils/tracing.py): K slots of the per-lane event
    # ring (tr_meta / tr_data / tr_tick [K] plus a count). 0 gives
    # zero-size planes and no recorder site runs; the runners bump it to
    # Trace.DEFAULT_CAPACITY when a trace is armed with the knob left at
    # 0. The ring wraps: the oldest events are overwritten and the loss is
    # the dropped count max(0, tr_count - K).
    trace_capacity: int = 0

    def __post_init__(self):
        if (self.queue_capacity <= 0 or self.max_snapshots <= 0
                or self.max_recorded <= 0):
            raise ValueError("capacities must be positive")
        if self.record_dtype not in ("int32", "int16"):
            raise ValueError("record_dtype must be 'int32' or 'int16'")
        if self.window_dtype not in ("int32", "uint16"):
            raise ValueError("window_dtype must be 'int32' or 'uint16'")
        if self.window_dtype == "uint16" and (
                self.max_recorded > 32768
                or self.max_recorded & (self.max_recorded - 1)):
            # a full window (length L) must not alias length 0 mod 2^16
            raise ValueError(
                "window_dtype='uint16' needs max_recorded to be a power of "
                "two <= 32768 (modular window decode requires L | 2^16 and "
                "full-window lengths < 2^16)")
        if self.count_dtype not in ("auto", "bfloat16", "float32"):
            raise ValueError(
                "count_dtype must be 'auto', 'bfloat16' or 'float32'")
        if self.reduce_mode not in ("auto", "matmul", "segsum"):
            raise ValueError(
                "reduce_mode must be 'auto', 'matmul' or 'segsum'")
        for knob in ("comm_engine", "kernel_engine", "fused_tick",
                     "fused_tile"):
            allowed = ENGINE_KNOBS[knob]
            if getattr(self, knob) not in allowed:
                raise ValueError(
                    f"{knob} must be one of {', '.join(map(repr, allowed))}")
        if (self.snapshot_timeout < 0 or self.snapshot_retries < 0
                or self.snapshot_every < 0):
            raise ValueError(
                "snapshot_timeout/snapshot_retries/snapshot_every must be "
                ">= 0 (0 disables the supervisor / daemon)")
        if self.trace_capacity < 0:
            raise ValueError(
                "trace_capacity must be >= 0 (0 disables the flight "
                "recorder)")

    @classmethod
    def for_workload(cls, *, snapshots: int, max_delay: int = MAX_DELAY,
                     sends_per_edge_per_phase: int = 1, hol_slack: int = 8,
                     split_markers: bool = False,
                     **overrides) -> "SimConfig":
        """A config whose queue capacity is sized to the workload: per-edge
        in-flight is bounded by the marker slots (dropped with
        ``split_markers``, the sync scheduler's representation), the tokens
        pending delay at a steady send rate, and a head-of-line slack. The
        result is rounded up to a multiple of 8 with a floor of 16; the
        log capacity is 4 slots per snapshot with a floor of 32. Overflow
        still flags ERR_QUEUE_OVERFLOW / ERR_RECORD_OVERFLOW. Other fields
        (the supervisor knobs among them) pass through ``overrides``."""
        analytic = ((0 if split_markers else snapshots)
                    + sends_per_edge_per_phase * (max_delay + 1))
        c = max(16, analytic + hol_slack)
        overrides.setdefault("max_snapshots", max(8, snapshots))
        if not overrides.get("max_recorded"):
            derived = max(32, 4 * snapshots)
            if overrides.get("window_dtype") == "uint16":
                # the modular planes need a power of two, at most 2^15
                derived = min(1 << (derived - 1).bit_length(), 32768)
            overrides["max_recorded"] = derived
        capacity = overrides.pop("queue_capacity", (c + 7) // 8 * 8)
        return cls(queue_capacity=capacity, max_delay=max_delay, **overrides)
