"""The reference's fast-path A/B tests as programs, run on both runtimes.

Each program starts its own 2-CPU cluster with one fast path turned off
through ``_system_config`` (the driver, the in-process GCS and node
manager take it at ``init``; the node manager ships the non-default
config to every worker it starts), runs one workload, and returns the
workload's results with the probes the reference's test reads:
``test_lease.py::test_lease_disabled_still_works``,
``test_inline_returns.py::test_elastic_pool_grows_and_shrinks``'s
centralized mode, ``test_submit_fastpath.py``'s template and ring tests,
``test_completion_fastpath.py``'s absorb, steal, ring and worker-segment
tests, and a probe each for the toggles those files do not reach (batch
frames, batched task_done, inline returns, local actor creation, the
zygote). ``fp_all_on`` and ``fp_all_off`` run the workload with every
fast path on and off. The runtimes' private attributes read here have the
same names on both (the port's runtime is the reference's with its names
swapped), so each program's results compare with ``==``.

The module imports neither runtime, nor jax: a worker of the port's
runtime that unpickles one of its functions by name imports it and stays
free of both.
"""

from __future__ import annotations

import importlib
import platform
import sys
import threading
import time
import traceback

T = 60    # seconds: every get is bounded, so a stuck runtime fails fast

# Every fast-path toggle the reference's code reads, off.
ALL_OFF = {
    "lease_enabled": False, "local_scheduling_enabled": False,
    "local_actor_creation_enabled": False,
    "submit_spec_template_enabled": False,
    "submit_batch_frames_enabled": False, "submit_ring_enabled": False,
    "task_done_batch_enabled": False, "completion_ring_enabled": False,
    "completion_absorb_enabled": False, "completion_steal_enabled": False,
    "worker_completion_ring_enabled": False,
    "worker_inline_returns_enabled": False, "worker_zygote_enabled": False,
}
X86 = platform.machine() in ("x86_64", "AMD64")


def double(x):
    return 2 * x


def boom():
    raise ValueError("boom")


def arange_sum(n):
    import numpy as np

    return np.arange(n, dtype=np.int64)


class Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}._private.{name}")


def _worker(rt):
    return _mod(rt, "worker").global_worker()


def _cluster(rt):
    return _mod(rt, "worker")._global_cluster


def workload(rt):
    """Tasks on the lease path and on the scheduled path (``SPREAD`` is
    never leased), a dependency chain, a store-path return, an error, a
    wait, an actor and a put."""
    f = rt.remote(double)
    leased = rt.get([f.remote(i) for i in range(64)], timeout=T)
    spread = f.options(scheduling_strategy="SPREAD")
    scheduled = rt.get([spread.remote(i) for i in range(8)], timeout=T)
    chain = rt.get(f.remote(f.remote(f.remote(1))), timeout=T)
    arr = rt.get(rt.remote(arange_sum).remote(10_000), timeout=T)
    try:
        rt.get(rt.remote(boom).remote(), timeout=T)
        err = None
    except Exception as e:   # the runtime's task error
        err = "boom" in str(e)
    refs = [f.remote(i) for i in range(4)]
    ready, rest = rt.wait(refs, num_returns=4, timeout=T)
    c = rt.remote(Counter).remote()
    counts = [rt.get(c.incr.remote(), timeout=T) for _ in range(3)]
    rt.kill(c)
    put = rt.get(rt.put({"a": [1, 2, 3]}), timeout=T)
    return {"leased": leased, "scheduled": scheduled, "chain": chain,
            "arr": [int(arr.sum()), int(arr.shape[0])], "err": err,
            "wait": [len(ready), len(rest)], "counts": counts, "put": put}


def _run(rt, knobs, probe):
    """``init`` with ``knobs``, the workload, then ``probe(rt, f)`` where
    ``f`` is a remote function already called 20 times; one cluster."""
    rt.init(num_cpus=2, object_store_memory=128 * 1024 * 1024,
            _system_config=dict(knobs) or None)
    try:
        out = workload(rt)
        f = rt.remote(double)
        assert rt.get([f.remote(i) for i in range(20)], timeout=T) == \
            [2 * i for i in range(20)]
        return out, probe(rt, f)
    finally:
        rt.shutdown()


def _absorb_threads():
    return any(t.name.startswith("rtpu-completion-absorb")
               for t in threading.enumerate())


def _local_placement(rt):
    """Whether the GCS placed a fresh actor through its node manager's
    ledger (local actor creation)."""
    c = rt.remote(Counter).remote()
    rt.get(c.incr.remote(), timeout=T)
    gcs = _cluster(rt).gcs
    entry = gcs._actors[c._actor_id.binary()]
    rt.kill(c)
    return bool(entry.local_placement)


# ------------------------------------------------------------ programs


def fp_all_on(rt, accel, tmp):
    def probe(rt, f):
        w = _worker(rt)
        lm = w._lease_mgr
        return {"lease_mgr": lm is not None,
                "template": f._submit_template.tpl is not None,
                "batch_frames": lm._batch_frames,
                "submit_ring": lm._ring_enabled == X86,
                "absorb": lm._absorb_exec is not None,
                "steal": lm.steal_enabled(),
                "completion_ring": w._comp_ring_enabled == X86,
                "worker_ring": w._worker_ring_enabled == X86,
                "zygotes": bool(_cluster(rt).nm._zygotes),
                "local_actor": _local_placement(rt)}
    return _run(rt, {}, probe)


def fp_lease_off(rt, accel, tmp):
    """test_lease.py::test_lease_disabled_still_works: no lease manager;
    every task takes the GCS-scheduled path."""
    return _run(rt, {"lease_enabled": False},
                lambda rt, f: _worker(rt)._lease_mgr is None)


def fp_local_scheduling_off(rt, accel, tmp):
    """The fully centralized mode of the elastic-pool test: no lease
    manager, and actors created by the central scheduler."""
    return _run(rt, {"local_scheduling_enabled": False},
                lambda rt, f: (_worker(rt)._lease_mgr is None,
                               _local_placement(rt)))


def fp_local_actor_creation_off(rt, accel, tmp):
    return _run(rt, {"local_actor_creation_enabled": False},
                lambda rt, f: _local_placement(rt))


def fp_spec_template_off(rt, accel, tmp):
    """test_submit_fastpath.py::test_remote_uses_template_and_matches_
    classic: results identical, and no template is ever built."""
    return _run(rt, {"submit_spec_template_enabled": False},
                lambda rt, f: f._submit_template.tpl is None)


def fp_batch_frames_off(rt, accel, tmp):
    """One frame a spec: the lease manager never batches, and the submit
    ring (which carries batched blobs) stays off with it."""
    def probe(rt, f):
        lm = _worker(rt)._lease_mgr
        return lm._batch_frames, lm._ring_enabled, lm._ring is None
    return _run(rt, {"submit_batch_frames_enabled": False}, probe)


def fp_submit_ring_off(rt, accel, tmp):
    """test_submit_fastpath.py::test_ring_disabled_never_registers: the
    scheduled-path submissions never register a ring."""
    def probe(rt, f):
        lm = _worker(rt)._lease_mgr
        return lm._ring_enabled, lm._ring is None, lm._ring_state
    return _run(rt, {"submit_ring_enabled": False}, probe)


def fp_task_done_batch_off(rt, accel, tmp):
    """One task_done notify a task on the scheduled path: the scheduled
    tasks of the workload complete through the node manager's
    ``task_done`` handler."""
    return _run(rt, {"task_done_batch_enabled": False},
                lambda rt, f: True)


def fp_completion_ring_off(rt, accel, tmp):
    """test_completion_fastpath.py::test_ring_disabled_never_registers
    and ::test_worker_ring_without_main_ring."""
    def probe(rt, f):
        w = _worker(rt)
        return (w._comp_ring_state, w._comp_ring is None,
                not any(_cluster(rt).nm._completion_rings.values()),
                not w._comp_segments)
    return _run(rt, {"completion_ring_enabled": False}, probe)


def fp_completion_absorb_off(rt, accel, tmp):
    """test_completion_fastpath.py::test_absorb_disabled_classic_wire: no
    absorb executor; the conn thread absorbs lease_tasks_done frames."""
    def probe(rt, f):
        lm = _worker(rt)._lease_mgr
        return lm._absorb_exec is None, len(lm._ingest), _absorb_threads()
    return _run(rt, {"completion_absorb_enabled": False}, probe)


def fp_completion_steal_off(rt, accel, tmp):
    """test_completion_fastpath.py::test_steal_disabled_gate."""
    def probe(rt, f):
        lm = _worker(rt)._lease_mgr
        return lm._steal, lm.steal_enabled(), lm.steal_absorb()
    return _run(rt, {"completion_steal_enabled": False}, probe)


def fp_worker_completion_ring_off(rt, accel, tmp):
    """test_completion_fastpath.py::test_worker_ring_disabled_socket_only."""
    def probe(rt, f):
        w = _worker(rt)
        time.sleep(0.3)
        return w._worker_ring_enabled, not w._comp_segments
    return _run(rt, {"worker_completion_ring_enabled": False}, probe)


def fp_inline_returns_off(rt, accel, tmp):
    """Every small return pays a store put: the store's object count grows
    with a burst of gets (with inline returns on it does not move)."""
    def probe(rt, f):
        store = _worker(rt).store
        before = store.stats()["num_objects"]
        assert rt.get([f.remote(i) for i in range(16)], timeout=T) == \
            [2 * i for i in range(16)]
        return store.stats()["num_objects"] - before >= 16
    return _run(rt, {"worker_inline_returns_enabled": False}, probe)


def fp_zygote_off(rt, accel, tmp):
    return _run(rt, {"worker_zygote_enabled": False},
                lambda rt, f: _cluster(rt).nm._zygotes == [])


def fp_all_off(rt, accel, tmp):
    def probe(rt, f):
        w = _worker(rt)
        return (w._lease_mgr is None, f._submit_template.tpl is None,
                w._comp_ring is None, _cluster(rt).nm._zygotes == [],
                _local_placement(rt))
    return _run(rt, ALL_OFF, probe)


# --------------------------------------------------------------- runners

PROGRAMS = {
    "submit": [fp_all_on, fp_lease_off, fp_local_scheduling_off,
               fp_local_actor_creation_off, fp_spec_template_off,
               fp_batch_frames_off, fp_submit_ring_off],
    "completion": [fp_task_done_batch_off, fp_completion_ring_off,
                   fp_completion_absorb_off, fp_completion_steal_off,
                   fp_worker_completion_ring_off, fp_inline_returns_off,
                   fp_zygote_off, fp_all_off],
}


def run_group(rt, accel, group, tmp):
    """Every program of ``group`` on ``rt``, one after the other, each on
    its own cluster."""
    out = {}
    for prog in PROGRAMS[group]:
        try:
            out[prog.__name__] = ("ok", prog(rt, accel, tmp))
        except Exception:
            out[prog.__name__] = ("error", traceback.format_exc())
    return out


if __name__ == "__main__":
    import ray_tpu
    from torch_runtimes import REFERENCE_BLOCK_S, deadline

    with deadline(REFERENCE_BLOCK_S,
                  what=f"the {sys.argv[1]} programs on ray_tpu"):
        results = run_group(ray_tpu, "TPU", sys.argv[1], sys.argv[2])
    print("RESULTS " + repr(results), flush=True)
