"""Durable small-file writes for the checkpoint tier.

Port of ``deepspeed_tpu/utils/fs.py``. A pointer file ('latest', a
checkpoint's ``metadata.json``) must never be observable half-written: a
reader that races a plain ``open(...).write`` — or a crash mid-write — sees
a torn file. The POSIX recipe is write-to-temp + fsync + atomic
``os.replace`` into place; readers then see either the old content or the
new, never a prefix of the new.
"""

import json
import os
import tempfile
from typing import Any


def fsync_write_text(path: str, data: str) -> None:
    """Atomically replace ``path`` with ``data`` (temp + fsync + rename)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix="." + os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def fsync_write_json(path: str, obj: Any, **json_kw) -> None:
    fsync_write_text(path, json.dumps(obj, **json_kw))


def fsync_dir(path: str) -> None:
    """fsync a directory so that a just-renamed entry survives a crash (best
    effort: some filesystems refuse read-only directory descriptors)."""
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
