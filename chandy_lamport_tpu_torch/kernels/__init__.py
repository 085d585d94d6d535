"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

``segment.py`` (sum_segments, sum_by_perm, spread) and ``queue.py``
(head_fields, queue_step, select_pop, append_rows) port the seven Pallas
kernels the JAX package's sync, exact and faulted exact storms reach.
Every wrapper runs its plain version on a CPU tensor and its CUDA kernel
on a CUDA tensor; each CUDA
launch adds one to the wrapper's count in ``launch_counts()``.
"""

from chandy_lamport_tpu_torch.kernels import queue, segment


def launch_counts() -> dict:
    """CUDA launches of every kernel wrapper so far, by wrapper name."""
    return {**segment.LAUNCHES, **queue.LAUNCHES}


def reset_launch_counts() -> None:
    for book in (segment.LAUNCHES, queue.LAUNCHES):
        for name in book:
            book[name] = 0


__all__ = ["launch_counts", "queue", "reset_launch_counts", "segment"]
