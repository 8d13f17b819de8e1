"""Job manager actor + client (reference: ``dashboard/modules/job/
job_manager.py:490`` JobManager, ``sdk.py:40`` JobSubmissionClient).

**A job's driver environment.** The manager is an actor in a CPU worker of
the port's runtime, forked from its node's zygote: its environment has
``CUDA_VISIBLE_DEVICES=""``, no ``TPU_*``/``JAX_*``/``XLA_FLAGS``, and the
``RAY_TPU_TORCH_*`` identity of that worker (worker id, node manager,
store, session). A job's driver is a user's program, not a pool worker.
It starts from the manager's environment with:

- every ``RAY_TPU_TORCH_*`` variable removed: a driver must not pose as
  the worker that spawned it;
- ``RAY_TPU_TORCH_ADDRESS`` set to the cluster's GCS address, which
  ``ray_tpu_torch.init(address="auto")`` reads;
- ``CUDA_VISIBLE_DEVICES=""`` kept: the driver holds no GPU. Its GPU work
  runs in ``num_gpus=1`` tasks and actors, each given its own GPU by the
  node manager; a driver that opened a card itself would share it behind
  the scheduler's back;
- ``runtime_env["env_vars"]`` applied last, so a job may set any of the
  above itself.

Each job's output goes to ``<session>/logs/jobs/<submission id>.log`` of
the manager's node.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading
import time
import uuid
from typing import Dict, List, Optional

_MANAGER_NAME = "_JOB_MANAGER"


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


def driver_env(base: Dict[str, str], gcs_address: str,
               runtime_env: Optional[dict]) -> Dict[str, str]:
    """A job driver's environment from the manager's ``base`` (see the
    module docstring)."""
    env = {k: v for k, v in base.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    env["RAY_TPU_TORCH_ADDRESS"] = gcs_address
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.update((runtime_env or {}).get("env_vars", {}))
    return env


class _JobManager:
    """Detached actor owning job driver subprocesses."""

    def __init__(self, gcs_address: str):
        self.gcs_address = gcs_address
        from ray_tpu_torch._private.config import config

        session = config.refresh_from_env("session_dir") or \
            os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
        self.log_dir = os.path.join(session, "logs", "jobs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._jobs: Dict[str, dict] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def submit(self, entrypoint: str, submission_id: Optional[str],
               runtime_env: Optional[dict], metadata: Optional[dict],
               cwd: Optional[str]) -> str:
        sid = submission_id or f"raytpu_job_{uuid.uuid4().hex[:10]}"
        with self._lock:
            if sid in self._jobs:
                raise ValueError(f"job {sid!r} already exists")
            log_path = os.path.join(self.log_dir, f"{sid}.log")
            self._jobs[sid] = {
                "submission_id": sid,
                "entrypoint": entrypoint,
                "status": JobStatus.PENDING,
                "metadata": metadata or {},
                "start_time": time.time(),
                "end_time": None,
                "log_path": log_path,
                "return_code": None,
            }
        env = driver_env(dict(os.environ), self.gcs_address, runtime_env)
        wd = (runtime_env or {}).get("working_dir") or cwd or os.getcwd()
        log_f = open(log_path, "wb")
        try:
            proc = subprocess.Popen(
                entrypoint, shell=True, cwd=wd, env=env,
                stdout=log_f, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, start_new_session=True)
        except OSError as e:
            with self._lock:
                self._jobs[sid].update(status=JobStatus.FAILED,
                                       end_time=time.time())
            log_f.write(str(e).encode())
            log_f.close()
            return sid
        log_f.close()  # child holds its own fd
        with self._lock:
            self._jobs[sid]["status"] = JobStatus.RUNNING
            self._procs[sid] = proc
        threading.Thread(target=self._reap, args=(sid, proc),
                         daemon=True, name=f"job-reap-{sid}").start()
        return sid

    def _reap(self, sid: str, proc: subprocess.Popen):
        rc = proc.wait()
        with self._lock:
            job = self._jobs.get(sid)
            if job is None:
                return
            if job["status"] != JobStatus.STOPPED:
                job["status"] = (JobStatus.SUCCEEDED if rc == 0
                                 else JobStatus.FAILED)
            job["end_time"] = time.time()
            job["return_code"] = rc
            self._procs.pop(sid, None)

    def status(self, sid: str) -> Optional[str]:
        with self._lock:
            job = self._jobs.get(sid)
            return job["status"] if job else None

    def info(self, sid: str) -> Optional[dict]:
        with self._lock:
            job = self._jobs.get(sid)
            return dict(job) if job else None

    def logs(self, sid: str) -> str:
        with self._lock:
            job = self._jobs.get(sid)
        if job is None:
            raise ValueError(f"no such job {sid!r}")
        try:
            with open(job["log_path"], "rb") as f:
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def stop(self, sid: str) -> bool:
        with self._lock:
            proc = self._procs.get(sid)
            job = self._jobs.get(sid)
            if job is None:
                return False
            if proc is None:
                return job["status"] in JobStatus.TERMINAL
            job["status"] = JobStatus.STOPPED
        try:
            os.killpg(os.getpgid(proc.pid), 15)
        except OSError:
            pass
        return True

    def list(self) -> List[dict]:
        with self._lock:
            return [dict(j) for j in self._jobs.values()]


class JobSubmissionClient:
    """Reference: ``dashboard/modules/job/sdk.py:40`` (HTTP there; the
    manager actor is the endpoint here — connectivity via the GCS)."""

    def __init__(self, address: Optional[str] = None):
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address or "auto",
                               ignore_reinit_error=True)
        self._manager = self._get_or_create_manager()

    @staticmethod
    def _get_or_create_manager():
        import ray_tpu_torch
        from ray_tpu_torch._private import worker as worker_mod

        try:
            return ray_tpu_torch.get_actor(_MANAGER_NAME)
        except ValueError:
            pass
        gcs_address = worker_mod.require_worker().gcs_address
        cls = ray_tpu_torch.remote(_JobManager)
        try:
            return cls.options(name=_MANAGER_NAME,
                               lifetime="detached").remote(gcs_address)
        except Exception:
            return ray_tpu_torch.get_actor(_MANAGER_NAME)  # creation race

    # -------------------------------------------------------------- API

    def _call(self, method: str, *args):
        import ray_tpu_torch

        return ray_tpu_torch.get(getattr(self._manager, method).remote(*args))

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[dict] = None,
                   cwd: Optional[str] = None) -> str:
        return self._call("submit", entrypoint, submission_id, runtime_env,
                          metadata, cwd)

    def get_job_status(self, submission_id: str) -> Optional[str]:
        return self._call("status", submission_id)

    def get_job_info(self, submission_id: str) -> Optional[dict]:
        return self._call("info", submission_id)

    def get_job_logs(self, submission_id: str) -> str:
        return self._call("logs", submission_id)

    def stop_job(self, submission_id: str) -> bool:
        return self._call("stop", submission_id)

    def list_jobs(self) -> List[dict]:
        return self._call("list")

    def wait_until_finish(self, submission_id: str,
                          timeout: float = 120) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.get_job_status(submission_id)
            if st in JobStatus.TERMINAL:
                return st
            time.sleep(0.25)
        raise TimeoutError(
            f"job {submission_id} not finished after {timeout}s")
