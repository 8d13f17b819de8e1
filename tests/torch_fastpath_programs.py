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
swapped), so each program's results compare with ``==``. The
"submit_tests" and "inline" groups hold the tests of
``test_submit_fastpath.py`` and ``test_inline_returns.py`` whose result
is a value, each the body of the reference test of the same name, as in
``torch_api_programs``.

The module imports neither runtime, nor jax: a worker of the port's
runtime that unpickles one of its functions by name imports it and stays
free of both.
"""

from __future__ import annotations

import importlib
import os
import platform
import sys
import threading
import time
import traceback

from torch_api_programs import MiB, cluster, raises

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


# What ``workload`` returns on either runtime, with any fast path on or
# off.
WORKLOAD_RESULT = {
    "leased": [2 * i for i in range(64)],
    "scheduled": [2 * i for i in range(8)], "chain": 8,
    "arr": [49995000, 10000], "err": True, "wait": [4, 0],
    "counts": [1, 2, 3], "put": {"a": [1, 2, 3]}}


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


def _leases_returned(rt):
    """Wait, up to ``T``, until the driver's lease manager holds no lease
    and its node's ledger has every CPU back. The leases of the calls just
    made stay held for ``lease_idle_timeout_s`` after their last task, and
    an actor made while they hold the node's CPUs is placed centrally:
    what ``_local_placement`` reads would then be the timing of the lease
    returns, not local actor creation."""
    lm = _worker(rt)._lease_mgr
    if lm is None:
        return
    nm = _cluster(rt).nm
    total = nm._total_resources["CPU"]
    deadline = time.time() + T
    while True:
        with lm._lock:
            held = any(st.leases for st in lm._shapes.values())
        with nm._lock:
            free = nm._local_avail.get("CPU")
        if not held and free >= total:
            return
        if time.time() > deadline:
            raise AssertionError(f"leases still held after {T} s: "
                                 f"{free} of {total} CPUs free")
        time.sleep(0.05)


def _local_placement(rt):
    """Whether the GCS placed a fresh actor through its node manager's
    ledger (local actor creation), once the caller's leases are back in
    that ledger."""
    _leases_returned(rt)
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


# ------------------------------------------- the fast-path files' programs
# The tests of tests/test_submit_fastpath.py and test_inline_returns.py
# whose result is a value, each the body of the reference test of the
# same name (without ``test_``) on the cluster its fixture starts.

FASTPATH = dict(num_cpus=2, object_store_memory=128 * MiB)
INLINE_PAYLOAD = b"p" * 512


def _fastpath(**system_config):
    return dict(FASTPATH, _system_config=system_config or None)


@cluster(**FASTPATH)
def remote_uses_template_and_matches_classic(rt, accel, tmp):
    config = _mod(rt, "config").config

    @rt.remote
    def double(x):
        return 2 * x

    on = rt.get([double.remote(i) for i in range(20)], timeout=T)
    built = double._submit_template.tpl is not None
    old = config.submit_spec_template_enabled
    config.set("submit_spec_template_enabled", False)
    try:
        off = rt.get([double.remote(i) for i in range(20)], timeout=T)
    finally:
        config.set("submit_spec_template_enabled", old)
    return on, built, off


@cluster(**FASTPATH)
def closure_captured_remote_function_after_template_build(rt, accel, tmp):
    @rt.remote
    def inner(x):
        return x * 2

    # Build inner's template in the driver first.
    first = rt.get([inner.remote(i) for i in range(4)], timeout=T)
    built = inner._submit_template.tpl is not None

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 1

    return first, built, rt.get(outer.remote(5), timeout=60)


def _store_objects(rt):
    return _worker(rt).store.stats()["num_objects"]


@cluster(**FASTPATH)
def inline_roundtrip_zero_store_puts(rt, accel, tmp):
    @rt.remote
    def nop():
        return 41

    warm = rt.get(nop.remote(), timeout=60)   # warm the lease
    before = _store_objects(rt)
    refs = [nop.remote() for _ in range(40)]
    vals = rt.get(refs, timeout=60)
    return warm, vals, _store_objects(rt) - before


@cluster(**FASTPATH)
def inline_result_feeds_downstream_task(rt, accel, tmp):
    @rt.remote
    def produce():
        return {"k": 41}

    @rt.remote
    def consume(d):
        return d["k"] + 1

    return rt.get(consume.remote(produce.remote()), timeout=60)


def inline_threshold_boundary(rt, accel, tmp):
    """Both of the reference's cases, ``delta`` 0 and -1, each on its own
    cluster: {delta: (values right, store objects grown)}."""
    size = _mod(rt, "serialization").serialize(
        INLINE_PAYLOAD).total_size()
    out = {}
    for delta in (0, -1):
        rt.init(**_fastpath(worker_inline_return_max=size + delta))
        try:
            @rt.remote
            def pay():
                return INLINE_PAYLOAD

            warm = rt.get(pay.remote(), timeout=60) == INLINE_PAYLOAD
            before = _store_objects(rt)
            refs = [pay.remote() for _ in range(5)]
            vals = rt.get(refs, timeout=60) == [INLINE_PAYLOAD] * 5
            out[delta] = (warm and vals, _store_objects(rt) - before)
        finally:
            rt.shutdown()
    return out


@cluster(**FASTPATH)
def get_of_inline_error_raises_original(rt, accel, tmp):
    @rt.remote(num_returns=3)
    def fail():
        raise ValueError("original message")

    a, b, c = fail.remote()
    before = _store_objects(rt)
    errs = [raises(lambda r=r: rt.get(r, timeout=60), ValueError,
                   "original message") for r in (a, b, c)]
    return errs, _store_objects(rt) - before


def inline_table_pressure_spill_bit_identical(rt, accel, tmp):
    # ~1.2 KiB per result against a 4 KiB per-job table: most results must
    # materialize into the store, and get() must not notice.
    rt.init(**_fastpath(gcs_inline_table_bytes=4096))
    try:
        @rt.remote
        def pay(i):
            return bytes([i % 256]) * 1200

        refs = [pay.remote(i) for i in range(24)]
        vals = rt.get(refs, timeout=120)
        right = vals == [bytes([i % 256]) * 1200 for i in range(24)]
        # The table settles under its per-job budget once the spills' store
        # copies confirm (keep-until-confirmed is async).
        w = _worker(rt)
        deadline = time.time() + 30
        while time.time() < deadline:
            stats = w.gcs.request("control_plane_stats", timeout=30)
            if stats["inline_bytes"] <= 4096:
                break
            time.sleep(0.2)
        # Spilled results are REAL store objects now: still readable.
        vals2 = rt.get(refs, timeout=120)
        return right, stats["inline_bytes"] <= 4096, vals2 == vals
    finally:
        rt.shutdown()


@cluster(**FASTPATH)
def worker_death_between_batched_completions(rt, accel, tmp):
    @rt.remote(max_retries=4)
    def slow(i):
        time.sleep(0.05)
        return i * 3

    nm = _cluster(rt).nm
    refs = [slow.remote(i) for i in range(30)]
    time.sleep(0.4)   # let the burst start executing
    with nm._lock:
        victims = [x for x in nm._workers.values()
                   if x.current_tasks and x.proc.poll() is None]
    for v in victims[:1]:
        try:
            os.kill(v.proc.pid, 9)
        except OSError:
            pass
    return rt.get(refs, timeout=120)


@cluster(**_fastpath(worker_inline_cache_bytes=0))
def inline_cache_disabled_still_resolves(rt, accel, tmp):
    @rt.remote
    def nop(i):
        return ("v", i)

    refs = [nop.remote(i) for i in range(10)]
    return rt.get(refs, timeout=60)


@cluster(num_cpus=1, object_store_memory=64 * MiB)
def completion_not_held_behind_slow_successor(rt, accel, tmp):
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(4.0)
        return "slow"

    rt.get(fast.remote(), timeout=60)   # warm the worker
    f = fast.remote()
    s = slow.remote()
    t0 = time.perf_counter()
    got = rt.get(f, timeout=10)
    waited = time.perf_counter() - t0
    return got, waited < 2.0, rt.get(s, timeout=30)


# --------------------------------------------------------------- runners

PROGRAMS = {
    "submit": [fp_all_on, fp_lease_off, fp_local_scheduling_off,
               fp_local_actor_creation_off, fp_spec_template_off,
               fp_batch_frames_off, fp_submit_ring_off],
    "completion": [fp_task_done_batch_off, fp_completion_ring_off,
                   fp_completion_absorb_off, fp_completion_steal_off,
                   fp_worker_completion_ring_off, fp_inline_returns_off,
                   fp_zygote_off, fp_all_off],
    "submit_tests": [remote_uses_template_and_matches_classic,
                     closure_captured_remote_function_after_template_build],
    "inline": [inline_roundtrip_zero_store_puts,
               inline_result_feeds_downstream_task,
               inline_threshold_boundary,
               get_of_inline_error_raises_original,
               inline_table_pressure_spill_bit_identical,
               worker_death_between_batched_completions,
               inline_cache_disabled_still_resolves,
               completion_not_held_behind_slow_successor],
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
