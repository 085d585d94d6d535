"""DenseSim — the single-instance driver around the exact tick.

The port of the JAX package's ``core/dense.DenseSim``: one simulation,
held as a batch of one lane on the same ring-mode kernel as the batched
exact storm (ops/tick.py). Event scripts are orchestrated from the host
(events are few and happen between ticks, reference test_common.go:79-140);
snapshots are decoded back to ``GlobalSnapshot`` once at the end.

``megatick`` defaults to 8, as in the JAX ``DenseSim``: ``tick N``
events and the drain run in 8-tick megaticks, which on the card go
through the fused megatick kernel (``kernels/megatick.py``, the CUDA
counterpart of the JAX ``fused_scan``) and on the CPU through its plain
form. ``megatick=1`` is the one-tick-per-iteration form; the results are
the same.

``trace`` (utils/tracing.Trace) arms the flight recorder: ``sim.trace``
is then a ``DenseTraceView`` of the lane's ring (the JAX
``DenseTraceView``), whose ``pretty()`` is the reference Logger's
timeline, as the parity backend's ``EpochTrace.pretty()`` prints it.

``faults`` (models/faults.Faults) arms the adversary on the one lane with
the JAX single instance's key, ``faults.init_state()`` = ``base | 1``
(lane 0 of ``init_batch_state``); its ``tick N`` stretches, drain and
flush run through the fused megatick's fault arm on the card.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from chandy_lamport_tpu_torch.config import SimConfig
from chandy_lamport_tpu_torch.core.spec import (
    Event,
    GlobalSnapshot,
    PassTokenEvent,
    SnapshotEvent,
    TickEvent,
)
from chandy_lamport_tpu_torch.core.state import (
    DenseState,
    DenseTopology,
    decode_errors,
    decode_snapshot,
    init_single_state,
)
from chandy_lamport_tpu_torch.ops.tick import TickKernel
from chandy_lamport_tpu_torch.parallel.batch import resolve_device
from chandy_lamport_tpu_torch.utils.carry import state_to_numpy
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec
from chandy_lamport_tpu_torch.utils.tracing import (
    armed_config,
    decode_trace,
    trace_counts,
    trace_pretty,
    trace_to_perfetto,
)


class DenseBackendError(RuntimeError):
    """Raised when the sticky error bitmask is non-zero after a run (the
    stand-in for the reference's log.Fatal calls)."""


class DenseTraceView:
    """The host view of a ``DenseSim``'s flight-recorder ring (the JAX
    ``DenseTraceView``): ``events`` decodes it (``decode_trace``),
    ``counts()`` gives (recorded, dropped), ``pretty()`` the reference
    Logger's epoch format and ``perfetto()`` Chrome/Perfetto trace-event
    JSON."""

    def __init__(self, sim: "DenseSim"):
        self._sim = sim

    @property
    def events(self):
        return decode_trace(self._sim.state, lane=0)

    def counts(self):
        return trace_counts(self._sim.state)

    def pretty(self) -> str:
        return trace_pretty(self.events, self._sim.topo)

    def perfetto(self) -> dict:
        return trace_to_perfetto(self.events, self._sim.topo)


class DenseSim:
    """One dense simulation on the exact scheduler, on the card unless
    ``device`` names another."""

    def __init__(self, topology: TopologySpec, delay,
                 config: Optional[SimConfig] = None,
                 exact_impl: str = "cascade", megatick: int = 8,
                 queue_engine: str = "auto",
                 kernel_engine: Optional[str] = None, faults=None,
                 trace=None, fused_tick: Optional[str] = None,
                 fused_block_edges: int = 0, *, device=None):
        """The parameters are the JAX ``DenseSim``'s, in its order; the
        port's own (``device``) is keyword-only.
        ``megatick``: the K of the multi-tick loops (module docstring);
        ``self.fused`` and ``self.fused_reason`` say whether they run
        through the kernel. ``exact_impl``: the exact tick's formulation,
        "cascade", "wave" or "fold" (``ops/tick.TickKernel``; the wave
        refuses the Go-exact and threefry samplers, the fold faults and
        the supervisor). ``faults``: models/faults.Faults or None, the
        adversary (module docstring). ``trace``: utils/tracing.Trace or
        None, the flight recorder; ``self.trace`` is its
        ``DenseTraceView`` when armed, else None. ``queue_engine``,
        ``kernel_engine``, ``fused_tick`` (None: the config's) and
        ``fused_block_edges`` are the JAX knobs, resolved by
        ``TickKernel`` (``self.kernel_engine`` and the kernel's
        ``*_reason`` attributes)."""
        self.device = resolve_device(device)
        self.config = config or SimConfig()
        self.topo = DenseTopology(topology)
        self.delay = delay
        # the flush must cover the sampler's max delay
        if delay.max_delay != self.config.max_delay:
            self.config = dataclasses.replace(self.config,
                                              max_delay=delay.max_delay)
        self.config = armed_config(self.config, trace)
        self.kernel = TickKernel(self.topo, self.config, delay,
                                 marker_mode="ring", megatick=megatick,
                                 exact_impl=exact_impl, device=self.device,
                                 faults=faults, trace=trace,
                                 queue_engine=queue_engine,
                                 kernel_engine=kernel_engine,
                                 fused_tick=fused_tick,
                                 fused_block_edges=fused_block_edges)
        self.faults = faults
        self.kernel_engine = self.kernel.kernel_engine
        self.fused = self.kernel.fused
        self.fused_reason = self.kernel.fused_reason
        self.trace = DenseTraceView(self) if self.kernel._trace_on else None
        # the single instance's streams (the JAX ``init_state``s): the
        # sampler's own and the adversary's base | 1
        state = init_single_state(self.topo, self.config, delay,
                                  self.device)
        if faults is not None:
            state = state._replace(
                fault_key=faults.init_batch_state(1, self.device))
        self.state: DenseState = state
        # host mirror of next_sid (ids are allocated sequentially,
        # sim.go:107-108) so collection knows which slots this run started
        self._next_sid = 0

    # -- event execution ---------------------------------------------------

    def process_event(self, event: Event) -> None:
        if isinstance(event, PassTokenEvent):
            e = self.topo.edge_index.get((self._node_index(event.src),
                                          self._node_index(event.dest)))
            if e is None:
                raise ValueError(f"no link {event.src} -> {event.dest}")
            self.state = self.kernel._inject_send(self.state, e,
                                                  event.tokens)
        elif isinstance(event, SnapshotEvent):
            self._next_sid += 1
            self.state = self.kernel._inject_snapshot(
                self.state, self._node_index(event.node_id))
        elif isinstance(event, TickEvent):
            self.state = self.kernel._run_ticks(self.state, event.n)
        else:
            raise TypeError(f"unknown event: {event!r}")

    def run_events(self, events: List[Event]) -> List[GlobalSnapshot]:
        """Execute a script + drain + flush (reference
        test_common.go:79-140); returns the started snapshots."""
        started: List[int] = []
        for ev in events:
            if isinstance(ev, SnapshotEvent):
                started.append(self._next_sid)
            self.process_event(ev)
        self.state = self.kernel._drain_and_flush(self.state)
        self.check_errors()
        host = self.host_state()
        return [decode_snapshot(self.topo, host, sid) for sid in started]

    # -- introspection -------------------------------------------------------

    def host_state(self) -> DenseState:
        """The simulation's state as numpy arrays with the JAX dtypes and
        no lane axis — the JAX ``DenseSim``'s ``state`` layout."""
        host = state_to_numpy(self.state, self.delay)
        return DenseState(*(tuple(w[0] for w in leaf)
                            if isinstance(leaf, tuple) else leaf[0]
                            for leaf in host))

    def node_tokens(self):
        tokens = self.state.tokens[0].tolist()
        return {nid: tokens[i] for i, nid in enumerate(self.topo.ids)}

    def total_tokens(self) -> int:
        """Node balances + in-flight non-marker tokens (the conserved
        quantity, test_common.go:298-328; the JAX ``total_tokens``)."""
        host = self.host_state()
        total = int(host.tokens.sum())
        C = self.config.queue_capacity
        for e in range(self.topo.e):
            head, length = int(host.q_head[e]), int(host.q_len[e])
            for k in range(length):
                slot = (head + k) % C
                if not int(host.q_meta[e, slot]) & 1:
                    total += int(host.q_data[e, slot])
        return total

    def check_errors(self) -> None:
        bits = int(self.state.error[0])
        if bits:
            raise DenseBackendError(
                "dense backend error(s): " + "; ".join(decode_errors(bits)))

    def _node_index(self, node_id: str) -> int:
        idx = self.topo.index.get(node_id)
        if idx is None:
            raise ValueError(f"node {node_id} does not exist")
        return idx
