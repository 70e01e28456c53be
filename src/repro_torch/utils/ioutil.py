"""Crash-safe artifact I/O.

Every JSON artifact the simulator emits (sweep cache files,
``analysis.report.save_json`` payloads, ``BENCH_engine.json``,
``results/bench/*.json``, Perfetto traces) used to be written with a bare
``open(path, "w")`` — a process killed mid-write (sweep worker OOM, CI
timeout, ctrl-C) leaves a torn file that poisons the next run.  The
helpers here write to a temporary file *in the same directory* (same
filesystem, so the final rename is atomic) and ``os.replace`` it over the
destination: readers observe either the old complete file or the new
complete file, never a prefix.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Callable, Optional


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically (tempfile + ``os.replace``)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj: Any, *, indent: Optional[int] = 1,
                      default: Optional[Callable] = None,
                      separators=None) -> None:
    """Serialize ``obj`` as JSON and write it atomically.

    Serialization happens *before* the file exists, so a ``TypeError`` from
    an unserializable object cannot leave a truncated artifact behind."""
    text = json.dumps(obj, indent=indent, default=default,
                      separators=separators)
    atomic_write_text(path, text)
