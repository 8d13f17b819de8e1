"""Exclusive use of a build directory, shared by the kernels' ``nvcc``
builds (``ops/_kernels.py``) and the store library's ``g++`` build
(``object_store/plasma.py``). Imports no torch: the node manager builds
the store without it."""

from __future__ import annotations

import contextlib
import fcntl
from pathlib import Path


@contextlib.contextmanager
def exclusive_build_dir(build_dir: Path):
    """Hold ``build_dir``'s ``.build.lock`` file (``flock``) against other
    processes. A file lock between processes: neither the lint's lock
    graph nor the lock-order witness, which follow this process's
    threading locks, models it."""
    build_dir.mkdir(parents=True, exist_ok=True)
    path = build_dir / ".build.lock"
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
