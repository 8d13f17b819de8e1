"""Worker fork-server ("zygote"): pre-imported CPU workers at fork cost.

The node manager's classic spawn pays a full python interpreter start +
ray_tpu_torch import per worker (~150-400 ms of CPU). The reference amortizes
this with prestarted pools (worker_pool.h:344); under an actor-creation
burst the pool drains and cold spawns dominate. This process preloads
the worker stack ONCE and forks per request — a child costs one fork +
registration (~10-30 ms), so bursts scale with fork throughput, not
interpreter startup.

GPU-bound workers do NOT fork from here: a CUDA context does not survive
a fork, and the device set is read from CUDA_VISIBLE_DEVICES when the
context is created, so they keep the classic spawn path — and have their
own reuse pool in the node manager. The zygote imports torch (the
package does not) but never initializes CUDA, and sees no GPU
(CUDA_VISIBLE_DEVICES="").

Protocol: one JSON object per line over a unix socket.
  request : {"env": {..}, "stdout": path, "stderr": path,
             "cwd": path|null, "sys_path": [..]}
  reply   : {"pid": N}
The zygote exits when its socket path's listener is told {"op":"exit"}
or its stdin/parent dies (node manager shutdown kills it explicitly).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import traceback


_exit_dir = ""   # markers for reaped children (see _ForkedProc.poll)


def _reap(signum, frame):
    """Collect exited children; write one exit-marker file per reaped
    pid so the node manager's liveness check is AUTHORITATIVE (a bare
    kill(pid, 0) is fooled by PID reuse after the zombie is gone)."""
    try:
        while True:
            pid, status = os.waitpid(-1, os.WNOHANG)
            if pid == 0:
                break
            if _exit_dir:
                try:
                    with open(os.path.join(_exit_dir, str(pid)), "w") as f:
                        f.write(str(status))
                except OSError:
                    pass
    except ChildProcessError:
        pass


def _spawn(req, close_fds) -> int:
    pid = os.fork()
    if pid != 0:
        # A recycled pid must not inherit its predecessor's exit marker.
        try:
            os.unlink(os.path.join(_exit_dir, str(pid)))
        except OSError:
            pass
        return pid
    # ---- child: becomes a worker process ----
    try:
        for fd in close_fds:
            try:
                fd.close()
            except OSError:
                pass
        os.setsid()
        out = os.open(req["stdout"],
                      os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        err = os.open(req["stderr"],
                      os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.dup2(out, 1)
        os.dup2(err, 2)
        os.close(out)
        os.close(err)
        os.environ.update(req.get("env") or {})
        if req.get("cwd"):
            os.chdir(req["cwd"])
        # fork() clones PRNG state: without reseeding, every worker on
        # the node would produce IDENTICAL "random" streams (sampling,
        # augmentation, exploration noise) — a silent-correlation bug
        # the classic per-process spawn can never have.
        import random

        random.seed()
        if "numpy" in sys.modules:
            sys.modules["numpy"].random.seed()
        if "torch" in sys.modules:
            sys.modules["torch"].seed()
        # PYTHONPATH is read at interpreter start, which already
        # happened in the zygote: apply the entries directly.
        for p in reversed(req.get("sys_path") or []):
            if p and p not in sys.path:
                sys.path.insert(0, p)
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        from ray_tpu_torch._private import worker_main

        worker_main.main()
    except BaseException:
        traceback.print_exc()
    finally:
        os._exit(0)
    return 0  # unreachable


def main() -> None:
    # Preload the worker stack (protocol, serialization, plasma client
    # library, CoreWorker machinery) so every forked child skips it.
    # Import only — no instantiation, no threads: fork() must happen
    # from a single-threaded process.
    import ray_tpu_torch._private.worker_main  # noqa: F401
    # The package itself loads no torch (the control plane runs without
    # it); a CPU worker's tasks mostly do, so the zygote pays that import
    # once for all of its children.
    import torch  # noqa: F401

    global _exit_dir

    # raylint: disable-next=config-knob-drift (bootstrap identity: the
    # NM points its zygote at a per-session socket path at spawn)
    path = os.environ["RAY_TPU_TORCH_ZYGOTE_SOCKET"]
    _exit_dir = path + ".exits"
    os.makedirs(_exit_dir, exist_ok=True)
    try:
        os.unlink(path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(8)
    signal.signal(signal.SIGCHLD, _reap)
    while True:
        conn, _ = srv.accept()
        f = conn.makefile("rwb")
        try:
            for line in f:
                try:
                    req = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if req.get("op") == "exit":
                    os._exit(0)
                pid = _spawn(req, close_fds=(f, conn, srv))
                f.write((json.dumps({"pid": pid}) + "\n").encode())
                f.flush()
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


if __name__ == "__main__":
    main()
