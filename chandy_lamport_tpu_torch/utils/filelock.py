"""Advisory cross-process file locking for shared on-disk caches (the
port's copy of the JAX package's ``utils/filelock.py``).

The summary cache and the prefix-checkpoint store (``utils/memocache.py``)
are shared mutable files: several processes pointed at one cache path
race their atomic-rename flushes, and last-writer-wins drops the other
writers' entries. ``locked(path)`` takes an advisory ``fcntl.flock`` on a
sidecar ``<path>.lock`` file — exclusive for read-merge-write flushes,
shared for loads — so cooperating processes serialize around the same
path without ever locking the data file itself (the data file is still
replaced atomically, so non-cooperating readers keep working). The
sidecar's name is the JAX package's, so processes of both packages
serialize around one cache.

On platforms without ``fcntl`` (or filesystems refusing flock) the lock
degrades to a no-op, the single-process behaviour.
"""

from __future__ import annotations

import contextlib
import os

try:  # pragma: no cover - fcntl is always present on the POSIX CI hosts
    import fcntl as _fcntl
except ImportError:  # pragma: no cover
    _fcntl = None


def lock_path(path: str) -> str:
    """Sidecar lock-file path for a cache data file."""
    return path + ".lock"


@contextlib.contextmanager
def locked(path: str, shared: bool = False):
    """Hold an advisory flock on ``lock_path(path)`` for the block.

    shared=True takes a read (LOCK_SH) lock — concurrent loads may
    overlap each other but not an exclusive flush. Blocks until granted.
    Yields True when a real lock is held, False when degraded to no-op.
    """
    if _fcntl is None or not path:
        yield False
        return
    lp = lock_path(path)
    parent = os.path.dirname(lp)
    if parent:
        os.makedirs(parent, exist_ok=True)
    try:
        fd = os.open(lp, os.O_RDWR | os.O_CREAT, 0o644)
    except OSError:
        yield False
        return
    try:
        try:
            _fcntl.flock(fd, _fcntl.LOCK_SH if shared else _fcntl.LOCK_EX)
        except OSError:
            yield False
            return
        yield True
        # flock drops with the fd; no explicit LOCK_UN needed
    finally:
        os.close(fd)
