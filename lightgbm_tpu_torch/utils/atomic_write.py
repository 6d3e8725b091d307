"""Crash-safe file writes: tmp + fsync + rename.

Every model/checkpoint write in the package routes through here so a kill
at ANY byte offset leaves either the old file or the new file — never a
truncated hybrid that parses into a silently shorter model (the failure
mode of the reference's in-place ``ofstream`` saves, gbdt.cpp:277-281).

``os.replace`` is atomic on POSIX (rename(2) within a filesystem) and on
Windows (MoveFileEx with MOVEFILE_REPLACE_EXISTING). The directory fsync
after the rename makes the new directory entry itself durable — without
it a power loss can roll back the rename even though the data blocks were
flushed.
"""

from __future__ import annotations

import contextlib
import os
import tempfile


@contextlib.contextmanager
def atomic_open(path: str, mode: str = "wb"):
    """Context manager yielding a tmp-file handle that atomically replaces
    ``path`` on clean exit (flush + fsync + rename + dir-fsync) and is
    discarded on error. For STREAMING writers (np.savez, chunked dumps)
    that must not materialize the whole payload in memory first."""
    path = os.fspath(path)
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(path)}.",
                               suffix=".tmp", dir=dirname)
    try:
        with os.fdopen(fd, mode) as fh:
            yield fh
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(dirname)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically (tmp file in the same
    directory -> flush -> fsync -> rename -> fsync dir)."""
    with atomic_open(path, "wb") as fh:
        fh.write(data)


def atomic_write_text(path: str, text: str, encoding: str = "utf-8") -> None:
    """Text-mode wrapper over :func:`atomic_write_bytes`."""
    atomic_write_bytes(path, text.encode(encoding))


def _fsync_dir(dirname: str) -> None:
    """Durably record a rename in its directory (best-effort: some
    platforms/filesystems refuse O_RDONLY opens of directories)."""
    try:
        dfd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)
