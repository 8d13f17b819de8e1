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

``reference_results(script, args, workdir)`` runs a program script of this
directory on ``ray_tpu`` in a fresh interpreter, which exits before the
port's runtime starts, and returns what it printed after ``RESULTS``. Its
output goes to files, not pipes: a daemon the script leaves would hold a
pipe open.

``group_results(programs, group, tmp_path_factory)`` runs a group of a
program module of this directory both ways: on ``ray_tpu`` through
``reference_results``, then on ``ray_tpu_torch`` in this process under
``deadline``, its workers on one thread each; it returns
``{"ray_tpu": results, "ray_tpu_torch": results}``.
"""

from __future__ import annotations

import ast
import contextlib
import faulthandler
import os
import pathlib
import signal
import subprocess
import sys
import threading

BLOCK_TIMEOUT_S = 300.0
# A program script's own deadline in ``reference_results``' interpreter:
# inside that call's 280 s, so the stacks print before the kill.
REFERENCE_BLOCK_S = 250.0
TESTS = pathlib.Path(__file__).resolve().parent


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


def reference_results(script: str, args, workdir, timeout: float = 280.0):
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(TESTS.parent), str(TESTS)] + [p for p in [os.environ.get(
            "PYTHONPATH")] if p]))
    out, err = workdir / "stdout.txt", workdir / "stderr.txt"
    with open(out, "w") as fo, open(err, "w") as fe:
        rc = subprocess.run(
            [sys.executable, str(TESTS / script), *map(str, args)],
            env=env, stdout=fo, stderr=fe, stdin=subprocess.DEVNULL,
            timeout=timeout).returncode
    lines = [ln for ln in out.read_text().splitlines()
             if ln.startswith("RESULTS ")]
    assert rc == 0 and lines, f"rc {rc}: {err.read_text()[-3000:]}"
    return ast.literal_eval(lines[-1][len("RESULTS "):])


def group_results(programs, group, tmp_path_factory):
    ref = reference_results(f"{programs.__name__}.py",
                            [group, tmp_path_factory.mktemp("ref")],
                            tmp_path_factory.mktemp("ref_out"))
    import ray_tpu_torch

    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        with deadline(what=f"the {group} programs on the port's runtime"):
            port = programs.run_group(ray_tpu_torch, "GPU", group, str(
                tmp_path_factory.mktemp("port")))
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old
    return {"ray_tpu": ref, "ray_tpu_torch": port}


def same_result(results, name):
    """Program ``name``'s value, after holding that it ran on both
    runtimes and gave the same result on each."""
    ref = results["ray_tpu"][name]
    port = results["ray_tpu_torch"][name]
    assert ref[0] == "ok", ref
    assert port == ref, (port, ref)
    return port[1]
