"""The tiled layout of the port's fused megatick on the CPU: its
resolution at the byte boundary (the port picks the layout from a lane's
working set alone, as the JAX ``fused_tile="auto"`` does), the per-lane
working sets it is chosen from, the traced wave's in-degree limit, the
kernel's argument struct, and the layout's stamps on the storm summary
and the bench row.

The resolution tests are pure functions of byte counts on
``torch.device("cuda")`` values: they allocate nothing on a card. The
tiled CUDA arm itself runs only on the card, where
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it to the plain
form and to the resident layout; the plain form is held to the JAX tiled
fused megatick by ``tests/test_torch_megatick.py``.
"""

import json

import numpy as np
import pytest
import torch

from chandy_lamport_tpu_torch import BatchedRunner, SimConfig
from chandy_lamport_tpu_torch.core.state import DenseTopology
from chandy_lamport_tpu_torch.kernels import megatick as km
from chandy_lamport_tpu_torch.models import workloads
from chandy_lamport_tpu_torch.ops.delay import HashDelay
from chandy_lamport_tpu_torch.ops.tick import TickKernel
from chandy_lamport_tpu_torch.utils.carry import state_to_numpy
from chandy_lamport_tpu_torch.utils.fixtures import TopologySpec
from chandy_lamport_tpu_torch.utils.tracing import Trace

CUDA = torch.device("cuda")
CPU = torch.device("cpu")
BUDGET = km.SMEM_BUDGET


# ---- the resolution, at its boundaries -------------------------------------

@pytest.mark.parametrize("smem,tile", [(BUDGET - 16, "off"), (BUDGET, "off"),
                                       (BUDGET + 1, "on"),
                                       (1_720_352, "on")])
def test_auto_tiles_exactly_past_the_budget(smem, tile):
    """"auto" keeps a lane resident up to a block's shared memory
    inclusive and tiles it one byte over, with a reason that names the
    working set and the budget."""
    fused, why, got, tile_why = km.resolve_fused(megatick=8, device=CUDA,
                                                 smem_bytes=smem)
    assert (fused, why, got) == ("on", "fused megatick engaged", tile)
    assert str(smem) in tile_why and str(BUDGET) in tile_why


def test_budget_is_the_only_input():
    """The layout follows the working set against the budget and nothing
    else: the ER-256 lane (52,416 B) is resident under a block's shared
    memory and tiled under a budget below it."""
    smem = km.fused_smem_bytes(256, 768, 8)
    assert smem == 52_416
    assert km.resolve_fused(megatick=8, device=CUDA,
                            smem_bytes=smem)[2] == "off"
    assert km.resolve_fused(megatick=8, device=CUDA, smem_bytes=smem,
                            budget=smem - 1)[2] == "on"


@pytest.mark.parametrize("device,megatick,why", [
    (CPU, 8, "CPU: the plain form"),
    (CUDA, 1, "megatick=1: one tick at a time")])
def test_cpu_and_megatick_1_take_no_layout(device, megatick, why):
    """The CPU takes the plain form and megatick 1 ticks one at a time,
    whatever the lane's size: no layout to choose."""
    assert km.resolve_fused(megatick=megatick, device=device,
                            smem_bytes=BUDGET * 10) == (
        "off", why, "off", "fused megatick off: no kernel to tile")


def test_cpu_state_takes_the_plain_form_in_either_layout():
    """A CPU state runs the plain form because it lies on the CPU, even
    under a kernel whose layout is set to tiled: the same leaves, and no
    launch counted."""
    runner = BatchedRunner(workloads.ring_topology(6),
                           SimConfig(max_snapshots=2), HashDelay(3), 2,
                           scheduler="exact", device="cpu", megatick=8)
    prog = workloads.storm_program(runner.topo, 4, 1,
                                   workloads.staggered_snapshots(
                                       runner.topo, 2, 1, 1, max_phases=4))
    s = runner.run_storm(runner.init_batch_device(), prog, drain=False)
    before = dict(km.LAUNCHES)
    ends = []
    for tile in ("off", "on"):
        runner.kernel.fused_tile = tile
        ends.append(state_to_numpy(km.fused_ticks(
            runner.kernel, runner._own(s), mode="drain", length=8,
            limit=s.time + 16)))
    assert km.LAUNCHES == before and runner.kernel.fused_workspace is None
    for x, y in zip(*ends):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            np.testing.assert_array_equal(u, v)


# ---- the working sets the layout is chosen from ----------------------------

# (graph, S): (cascade, wave, cascade faulted, wave faulted) bytes a lane,
# untraced (one step body for the cascade and the wave, so the pairs are
# equal); the SF graphs are the bench's scale_free(N, 2, seed=3)
WORKING_SETS = {
    ("er-256", 8): (52_416, None, 54_384, None),
    ("sf-1024", 8): (208_736, 208_736, 216_064, 216_064),
    ("sf-1024", 16): (315_232, 315_232, 322_704, 322_704),
    ("sf-2048", 8): (417_744, 417_744, 432_256, 432_256),
    ("sf-8192", 8): (1_671_200, 1_671_200, 1_728_720, 1_728_720),
}
EDGES = {"er-256": 768, "sf-1024": 3063, "sf-2048": 6138, "sf-8192": 24572}


@pytest.mark.parametrize("graph,s", sorted(WORKING_SETS))
def test_working_sets_of_the_ladder(graph, s):
    """``fused_smem_bytes`` at the repo's lanes, with the layout "auto"
    gives each on the card: everything past SF-1k at S=8 tiles."""
    family, n = graph.split("-")
    n = int(n)
    if family == "sf":
        assert DenseTopology(workloads.scale_free(n, 2, seed=3)).e == \
            EDGES[graph]
    arms = ((False, False), (False, True), (True, False), (True, True))
    for want, (fault_arm, wave) in zip(WORKING_SETS[graph, s], arms):
        if want is None:
            continue
        got = km.fused_smem_bytes(n, EDGES[graph], s, fault_arm=fault_arm,
                                  wave=wave)
        assert got == want and got % 16 == 0
        tile = km.resolve_fused(megatick=8, device=CUDA, smem_bytes=got)[2]
        assert tile == ("on" if got > BUDGET else "off")


def test_config5_tiles_with_a_reason():
    """Config 5's wave lane (SF-8k, S=8, 1,671,200 B) resolves to the
    tiled layout on the card, with a reason that names the working set
    and the workspace; its faulted lane too."""
    topo = DenseTopology(workloads.scale_free(8192, 2, seed=3))
    assert SimConfig.for_workload(snapshots=8).max_snapshots == 8
    for fault_arm, want in ((False, 1_671_200), (True, 1_728_720)):
        smem = km.fused_smem_bytes(topo.n, topo.e, 8, wave=True,
                                   fault_arm=fault_arm)
        assert smem == want
        fused, _, tile, why = km.resolve_fused(megatick=8, device=CUDA,
                                               smem_bytes=smem)
        assert (fused, tile) == ("on", "on")
        assert str(want) in why and "workspace" in why


def test_wave_arm_refuses_a_node_past_int16_waves():
    """The traced wave's wave numbers are int16: a node with more than
    ``WAVE_MAX_IN_DEGREE`` in-edges is refused at construction of a
    traced wave for the card, naming the node, before any table moves;
    the limit itself passes, the untraced step (one body for the cascade
    and the wave, which numbers no waves) and the CPU have no such
    limit."""
    limit = km.WAVE_MAX_IN_DEGREE
    km.check_wave_degree(np.array([3, limit, 0]))
    with pytest.raises(ValueError, match="node 2 has 32769 in-edges"):
        km.check_wave_degree(np.array([3, limit, limit + 1]))
    # a star: every leaf sends to the hub "H", the hub to one leaf
    leaves = [f"L{i}" for i in range(limit + 1)]
    spec = TopologySpec([("H", 0)] + [(v, 1) for v in leaves],
                        [(v, "H") for v in leaves] + [("H", leaves[0])])
    topo = DenseTopology(spec)
    hub = int(np.argmax(topo.in_degree))
    assert int(topo.in_degree[hub]) == limit + 1
    with pytest.raises(ValueError, match=f"node {hub} has {limit + 1}"):
        TickKernel(topo, SimConfig(max_snapshots=2, trace_capacity=16),
                   HashDelay(1), device="cuda", megatick=8,
                   exact_impl="wave",
                   trace=Trace())
    tk = TickKernel(topo, SimConfig(max_snapshots=2), HashDelay(1),
                    device="cpu", megatick=8, exact_impl="wave")
    assert tk.fused == "off"


def test_args_mirror_the_c_struct():
    """``_Args`` mirrors ``struct ClsimMegatickArgs`` of
    ``csrc/megatick.cu`` field for field, in name, order and kind
    (pointer, 64-bit or 32-bit integer, the rates), the workspace, its
    size and the tiled flag included: ctypes lays the struct out from
    this list, so a field out of place shifts every field after it."""
    import ctypes
    import os
    import re

    with open(os.path.join(os.path.dirname(km.__file__), "csrc",
                           "megatick.cu")) as f:
        text = f.read()
    body = text[text.index("struct ClsimMegatickArgs {"):]
    body = re.sub(r"//[^\n]*", "", body[body.index("{") + 1:body.index("};")])
    want = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        kind = ("ptr" if "*" in decl else "i64" if "long long" in decl
                else "rates" if decl.startswith("ClsimFaultRates")
                else "i32")
        names = decl.replace("*", " ").split()[-1] if "," not in decl \
            else decl
        for name in (n.strip().split()[-1].lstrip("*")
                     for n in names.split(",")):
            want.append((name, kind))
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_longlong: "i64",
             ctypes.c_int: "i32", km._Program: "rates"}
    got = [(name, kinds[t]) for name, t in km._Args._fields_]
    assert got == want
    assert ("workspace", "ptr") in got and ("tiled", "i32") in got


# ---- the layout on the storm summary and the bench row ---------------------

def test_summary_and_bench_row_stamp_the_layout(capsys):
    """``BatchedRunner`` exposes ``fused_tile`` and its reason (its
    kernel's), its summary stamps them beside ``fused_reason``, and so
    does the bench row; the CPU takes the plain form, so no layout. The
    bench takes no layout flag."""
    from chandy_lamport_tpu_torch import bench

    runner = BatchedRunner(workloads.ring_topology(4), SimConfig(),
                           HashDelay(1), 2, scheduler="exact", device="cpu",
                           megatick=8)
    no_layout = ("off", "fused megatick off: no kernel to tile")
    assert (runner.fused_tile, runner.fused_tile_reason) == no_layout
    summary = BatchedRunner.summarize(runner.init_batch_device(),
                                     runner=runner)
    assert (summary["fused_tile"], summary["fused_tile_reason"]) == no_layout
    assert summary["fused_reason"] == "CPU: the plain form"
    assert bench.main(["--device", "cpu", "--scheduler", "exact",
                       "--exact-impl", "wave", "--graph", "er", "--nodes",
                       "16", "--batch", "2", "--phases", "3", "--snapshots",
                       "2", "--repeats", "1", "--megatick", "8"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (row["fused_tile"], row["fused_tile_reason"]) == no_layout
    assert row["megatick"] == 8 and row["error_bits"] == 0
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--fused-tile", "on"])
