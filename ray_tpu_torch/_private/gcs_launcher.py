"""Spawn and manage the out-of-process GCS (reference: the head node
starting the ``gcs_server`` binary beside the raylet —
``_private/node.py:1145`` / ``services.py:1273``, collapsed here into a
``python -m ray_tpu_torch._private.gcs`` subprocess).

Bootstrap handshake: the child binds its listener, then atomically
writes ``gcs_bootstrap.json`` (address + pid) into the session dir; the
spawner polls for that file (bounded by ``gcs_bootstrap_timeout_s``)
while watching child liveness, so a crashed child surfaces as a launch
error carrying the log tail instead of a silent timeout.

The spawner's non-default config knobs ship to the child as a JSON
``--system-config`` blob (programmatic ``config.set`` overrides survive
the process boundary the way env vars do on their own), and the child
watches its parent pid so a spawner that dies without cleanup never
leaks a GCS process.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, Optional

BOOTSTRAP_FILENAME = "gcs_bootstrap.json"


class GcsLaunchError(RuntimeError):
    """The GCS subprocess failed to come up (or exited during boot)."""


class GcsProcess:
    """Handle on a spawned GCS subprocess: address/pid after the
    bootstrap handshake, liveness probes, graceful terminate (SIGTERM →
    drain) and hard kill (SIGKILL, the fault-tolerance chaos hook)."""

    def __init__(self, session_dir: str, host: str = "127.0.0.1",
                 port: int = 0, storage_path: Optional[str] = None,
                 system_config: Optional[Dict[str, Any]] = None):
        from ray_tpu_torch._private.config import config as _cfg

        os.makedirs(session_dir, exist_ok=True)
        self.session_dir = session_dir
        self.bootstrap_path = os.path.join(session_dir, BOOTSTRAP_FILENAME)
        try:
            os.unlink(self.bootstrap_path)  # stale handshake must not win
        except OSError:
            pass
        blob = _cfg.diff_nondefault()
        if system_config:
            blob.update(system_config)
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.gcs",
               "--host", host, "--port", str(port),
               "--bootstrap-file", self.bootstrap_path,
               "--check-parent-pid", str(os.getpid())]
        if storage_path:
            cmd += ["--storage-path", storage_path]
        if blob:
            cmd += ["--system-config", json.dumps(blob)]
        self.log_path = os.path.join(session_dir, "logs", "gcs.log")
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
        env = dict(os.environ)
        # The repo may be imported off sys.path without an install; the
        # child must resolve the same ray_tpu_torch tree.
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        log_f = open(self.log_path, "ab")
        try:
            self.proc = subprocess.Popen(
                cmd, stdin=subprocess.DEVNULL, stdout=log_f, stderr=log_f,
                env=env)
        finally:
            log_f.close()
        timeout = float(_cfg.gcs_bootstrap_timeout_s)
        self.address, self.pid = self._wait_bootstrap(timeout)

    # ----------------------------------------------------------- bootstrap

    def _log_tail(self, limit: int = 2000) -> str:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - limit))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return "<no log>"

    def _wait_bootstrap(self, timeout: float):
        from ray_tpu_torch._private import lockdep

        # Bootstrap blocks on the child: witness (lockdep) that the
        # calling thread holds no control-plane lock here.
        lockdep.note_blocking_region("gcs bootstrap wait")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if os.path.exists(self.bootstrap_path):
                try:
                    with open(self.bootstrap_path) as f:
                        info = json.load(f)
                    return info["address"], int(info["pid"])
                except (OSError, ValueError, KeyError):
                    pass  # mid-replace; retry
            if self.proc.poll() is not None:
                raise GcsLaunchError(
                    f"gcs subprocess exited rc={self.proc.returncode} "
                    f"before bootstrap; log tail:\n{self._log_tail()}")
            time.sleep(0.02)
        self.kill()
        raise GcsLaunchError(
            f"gcs subprocess did not bootstrap within {timeout:.1f}s; "
            f"log tail:\n{self._log_tail()}")

    # ------------------------------------------------------------ lifecycle

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def alive(self) -> bool:
        return self.proc.poll() is None

    def terminate(self, timeout: float = 10.0) -> Optional[int]:
        """Graceful stop: SIGTERM → the child drains (GcsServer.close,
        storage flush) and exits; escalate to SIGKILL past ``timeout``."""
        from ray_tpu_torch._private import lockdep

        lockdep.note_blocking_region("gcs terminate wait")
        if self.proc.poll() is None:
            try:
                self.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.kill()
        return self.proc.returncode

    def kill(self) -> None:
        """SIGKILL, no drain — the fault-tolerance tests' chaos hook
        (the process analog of GcsServer.crash_for_test)."""
        if self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    close = terminate
