"""Run the port's own runtime in a test module whose fixture holds a
``ray_tpu`` cluster, one runtime after the other, never both at once.

``ports_runtime(restore=...)`` shuts the ``ray_tpu`` cluster down, starts
``ray_tpu_torch`` with ``init_kw`` (the workers take ``OMP_NUM_THREADS=1``
from this environment, as the modules' fixtures give theirs), yields the
module, shuts it down, and starts ``ray_tpu`` again with ``restore`` for
the module's later tests. The whole block runs under ``deadline``.

``deadline(seconds)`` bounds a block run on the main thread: past it, the
stacks of every thread go to stderr and the block raises ``TimeoutError``,
so a stuck runtime fails its test instead of stalling the suite.
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import signal
import sys
import threading

BLOCK_TIMEOUT_S = 300.0


@contextlib.contextmanager
def deadline(seconds: float = BLOCK_TIMEOUT_S, what: str = "block"):
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _expired(signum, frame):
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        raise TimeoutError(f"{what} did not finish within {seconds:.0f} s")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@contextlib.contextmanager
def ports_runtime(restore=None, **init_kw):
    import ray_tpu
    import ray_tpu_torch

    with deadline(what="a block on the port's runtime"):
        was_up = ray_tpu.is_initialized()
        if was_up:
            ray_tpu.shutdown()
        old = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            ray_tpu_torch.init(**init_kw)
            try:
                yield ray_tpu_torch
            finally:
                ray_tpu_torch.shutdown()
                if was_up:
                    ray_tpu.init(**(restore or {}))
        finally:
            if old is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = old
