"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

``segment.py`` (sum_segments, sum_by_perm, spread), ``queue.py``
(head_fields, queue_step, select_pop, append_rows and its routed form
append_marker_rows) and ``megatick.py``
(fused_ticks, the fused megatick ``fused_scan``) port the eight Pallas
kernels of the JAX package.
Every wrapper runs its plain version on a CPU tensor and its CUDA kernel
on a CUDA tensor; each CUDA
launch adds one to the wrapper's count in ``launch_counts()`` (a launch
of fused_scan's tiled layout also to ``fused_scan_tiled``, one of its
recorder arm to ``fused_scan_traced``).
"""

from chandy_lamport_tpu_torch.kernels import megatick, queue, segment


def launch_counts() -> dict:
    """CUDA launches of every kernel wrapper so far, by wrapper name."""
    return {**segment.LAUNCHES, **queue.LAUNCHES, **megatick.LAUNCHES}


def reset_launch_counts() -> None:
    for book in (segment.LAUNCHES, queue.LAUNCHES, megatick.LAUNCHES):
        for name in book:
            book[name] = 0


__all__ = ["launch_counts", "megatick", "queue", "reset_launch_counts",
           "segment"]
