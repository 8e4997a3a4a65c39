"""Atomic (and optionally durable) file writes, the port of
``ncnet_tpu/utils/io.py``.

An artifact whose existence marks its work unit done (the resume-by-artifact
contract of the eval and localization stages) must appear atomically: a
process killed mid-write must not leave a truncated file a rerun then skips.

  * Atomicity (every writer here): a reader never sees a partial file.
    Temp file + same-directory ``os.replace``; a crash leaves a ``.tmp``
    carcass at worst.
  * Durability (``durable=True``): the committed bytes also survive a power
    loss: the temp file is fsynced before the rename and the parent
    directory after it.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional


def fsync_dir(path: str) -> None:
    """Best-effort fsync of directory ``path`` (makes a just-renamed entry
    durable); filesystems that refuse ``open(dir)`` or the fsync degrade
    silently: the rename is still atomic."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _discard(tmp: str) -> None:
    try:
        os.remove(tmp)
    except OSError:
        pass


def atomic_savemat(path: str, mdict: dict, **kwargs) -> None:
    """``scipy.io.savemat`` to ``path`` via a same-directory temp file +
    ``os.replace``, so the file exists only once fully written."""
    from scipy.io import savemat

    tmp = path + ".tmp"
    try:
        savemat(tmp, mdict, **kwargs)
        os.replace(tmp, path)
    except BaseException:
        _discard(tmp)
        raise


def atomic_write_json(path: str, obj, durable: bool = False) -> None:
    """``json.dump`` to ``path`` via a same-directory temp file +
    ``os.replace``; ``durable=True`` also fsyncs the temp file before and
    the parent directory after the rename."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1, sort_keys=True)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if durable:
            fsync_dir(os.path.dirname(os.path.abspath(path)))
    except BaseException:
        _discard(tmp)
        raise


def atomic_write_bytes(path: str, data, *, durable: bool = False,
                       commit_hook: Optional[Callable[[str], None]] = None
                       ) -> None:
    """Write ``data`` (bytes, or a sequence of byte chunks written back to
    back) to ``path`` by the two-phase commit: a pid-suffixed temp file
    (concurrent writers of one entry must not clobber each other's),
    optional fsync, ``os.replace``, optional parent-directory fsync.
    ``commit_hook(path)`` runs between the payload write and the rename:
    a process killed there leaves a temp carcass and no visible entry."""
    tmp = f"{path}.tmp.{os.getpid()}"
    parts = (data,) if isinstance(data, (bytes, bytearray)) else data
    try:
        with open(tmp, "wb") as f:
            for chunk in parts:
                f.write(chunk)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        if commit_hook is not None:
            commit_hook(path)
        os.replace(tmp, path)
        if durable:
            fsync_dir(os.path.dirname(os.path.abspath(path)))
    except BaseException:
        _discard(tmp)
        raise
