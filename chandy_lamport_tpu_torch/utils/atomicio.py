"""Durable write primitives of the port (the JAX package's
``utils/atomicio.py``, the same four functions and failpoint variable).

The atomic rename of a checkpoint (tmp file, then ``os.replace``,
utils/checkpoint.py) protects readers from a killed writer: the previous
complete file survives any SIGKILL. The fsyncs here make the bytes and
the rename durable as well:

``fsync_file(f)`` / ``fsync_dir(path)``
    flush and fsync an open handle; fsync the parent directory so the
    rename itself is durable. The directory fsync is best-effort: some
    filesystems refuse it, and it only narrows the power-cut window,
    never the kill window.

``fsync_append(f, data)``
    write, flush and fsync before returning, for write-ahead logs whose
    append is the acknowledgement. Returns the byte count.

``crash_failpoint(name)``
    SIGKILL this process iff ``CLSIM_IO_FAILPOINT`` names this site, so a
    test can kill a writer inside its tmp-write -> replace window and
    prove the previous file still loads. A no-op with the variable unset.
"""

from __future__ import annotations

import os
import signal

# set to a site name ("checkpoint-replace") to SIGKILL the process there
FAILPOINT_ENV = "CLSIM_IO_FAILPOINT"


def crash_failpoint(name: str) -> None:
    """Die by SIGKILL iff the failpoint variable names this site."""
    if os.environ.get(FAILPOINT_ENV) == name:
        os.kill(os.getpid(), signal.SIGKILL)


def fsync_file(f) -> None:
    """Flush Python's buffers and fsync the file: the caller's bytes are
    on stable storage when this returns."""
    f.flush()
    os.fsync(f.fileno())


def fsync_dir(path: str) -> None:
    """Best-effort fsync of ``path``'s parent directory, making a rename
    just committed there durable; a filesystem that refuses it is left
    as it is."""
    parent = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(parent, os.O_RDONLY)
    except OSError:
        return
    try:
        try:
            os.fsync(fd)
        except OSError:
            pass
    finally:
        os.close(fd)


def fsync_append(f, data: bytes) -> int:
    """Append ``data`` to the open binary handle ``f`` durably: the write,
    a flush and an fsync complete before return. A kill mid-append can
    leave only a prefix of ``data`` at the end of the file. Returns
    ``len(data)``."""
    f.write(data)
    f.flush()
    os.fsync(f.fileno())
    return len(data)
