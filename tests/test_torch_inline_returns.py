"""``tests/test_inline_returns.py`` on the port's runtime, test by test.

The tests whose result is a value run as programs of
``torch_fastpath_programs``' "inline" group on both runtimes, each on the
cluster its reference fixture starts (the threshold's two cases in one
program, a cluster each): the results must be equal and pass the
reference's assertions. The checks of pure modules (the inline table and
cache, an executor's error returns, a GCS with no node) run on both
packages in this process. The tests that read the driver's lease manager,
its pending-returns window, the node manager's pool or the GCS's table
run on the port alone, translated name for name. The device-object test
returns a ``torch.Tensor`` (the port's device object) where the reference
returns a ``jax.Array``, and the pool-pressure stub queues GPU specs where
the reference's queues TPU ones.
"""

import importlib
import time

import pytest

import torch_fastpath_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _priv(pkg, name):
    return importlib.import_module(f"{pkg}._private.{name}")


def _both(check):
    """``check(package)`` for ``ray_tpu``, then ``ray_tpu_torch``; the two
    results must be equal."""
    ref, port = (check(p) for p in PACKAGES)
    assert port == ref, (port, ref)
    return port


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "inline", tmp_path_factory)


def _cluster(**system_config):
    import ray_tpu_torch

    return ray_tpu_torch.init(num_cpus=2,
                              object_store_memory=128 * 1024 * 1024,
                              _system_config=system_config or None)


@pytest.fixture
def ray_cluster():
    import ray_tpu_torch

    ctx = _cluster()
    yield ctx
    ray_tpu_torch.shutdown()


def _worker():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.global_worker()


def _store_objects() -> int:
    return _worker().store.stats()["num_objects"]


# ------------------------------------------------- zero-plasma fast path


def test_inline_roundtrip_zero_store_puts(results):
    warm, vals, grew = same_result(results,
                                   "inline_roundtrip_zero_store_puts")
    assert warm == 41 and vals == [41] * 40
    assert grew == 0, "sub-threshold results must never touch the store"


def test_inline_result_feeds_downstream_task(results):
    assert same_result(results, "inline_result_feeds_downstream_task") == 42


# ------------------------------------------------- threshold boundary ±1


@pytest.mark.parametrize("delta,expect_inline", [(0, True), (-1, False)])
def test_inline_threshold_boundary(results, delta, expect_inline):
    right, grew = same_result(results, "inline_threshold_boundary")[delta]
    assert right
    if expect_inline:
        assert grew == 0, "at-threshold result must inline"
    else:
        assert grew >= 5, "one-byte-over result must take the store"


def test_device_objects_always_store_path(ray_cluster):
    """A tensor result takes the store path: the port's device objects
    ride out of band, so even a tiny one is inline-ineligible."""
    import numpy as np
    import torch

    import ray_tpu_torch

    @ray_tpu_torch.remote
    def mk():
        import torch

        return torch.arange(16, dtype=torch.float32)

    ref = mk.remote()
    back = ray_tpu_torch.get(ref, timeout=120)
    assert isinstance(back, torch.Tensor)
    np.testing.assert_array_equal(
        back.numpy(), np.arange(16, dtype=np.float32))
    # Tiny (64 data bytes) yet store-resident: out-of-band buffers make
    # device objects inline-ineligible regardless of size.
    assert _worker().store.contains(ref.binary())


# ------------------------------------------------------- error returns


def test_get_of_inline_error_raises_original(results):
    errs, grew = same_result(results, "get_of_inline_error_raises_original")
    assert all(e is not None and e[1] and e[2] for e in errs), errs
    assert grew == 0, "a small error return must inline, not store"


def test_error_blob_aliased_across_return_ids():
    """_store_error_returns serializes ONCE and aliases the same bytes object
    across every return id (the completion pickle memoizes it, so an
    N-return failure ships one copy)."""
    def check(pkg):
        exceptions = importlib.import_module(f"{pkg}.exceptions")
        ids = _priv(pkg, "ids")
        ser = _priv(pkg, "serialization")
        ts = _priv(pkg, "task_spec")
        ex = object.__new__(_priv(pkg, "worker_main").WorkerExecutor)
        ex._inline_max = 8192
        spec = ts.TaskSpec(task_id=ids.TaskID.for_task(ids.JobID.from_int(1)),
                           job_id=ids.JobID.from_int(1), function_key="k",
                           args=b"", arg_deps=[], num_returns=4,
                           resources={"CPU": 1})
        err = exceptions.RayTaskError("f", "boom")
        objects, inline = ex._store_error_returns(spec, err)
        blobs = list(inline.values())
        back = ser.loads_oob(blobs[0])
        return (len(objects), len(inline),
                all(b is blobs[0] for b in blobs),
                isinstance(back, exceptions.RayTaskError))

    assert _both(check) == (4, 4, True, True), \
        "every return id must alias ONE serialized blob"


# ------------------------------------------- table pressure spill


def test_inline_table_pressure_spill_bit_identical(results):
    right, settled, same = same_result(
        results, "inline_table_pressure_spill_bit_identical")
    assert right
    assert settled
    assert same, "spill must preserve results bit-identically"


# --------------------------------------- redelivery + GCS-side dedup


def test_duplicate_completion_batch_is_idempotent(ray_cluster):
    """At-least-once delivery: the same task_done_batch frame applied twice
    (worker died after the NM relayed but before the ack-side bookkeeping,
    NM retried) must leave one consistent copy."""
    import pickle

    import ray_tpu_torch
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.ids import ObjectID, TaskID

    gcs = worker_mod._global_cluster.gcs
    assert gcs is not None, "test requires the in-process GCS"
    w = worker_mod.global_worker()
    tid = TaskID.for_task(w.job_id)
    oid = ObjectID.for_return(tid, 0).binary()
    blob = serialization.serialize("dup-value").to_bytes()
    rec = {"task_id": tid.binary(), "status": "ok",
           "objects": [(oid, len(blob))], "inline": {oid: blob},
           "error": None}
    frame = {"node_id": w.node_id, "blobs": [pickle.dumps(rec, protocol=5)]}
    gcs._h_task_done_batch(None, frame, 0)
    gcs._h_task_done_batch(None, frame, 0)   # duplicate delivery
    assert gcs._inline_tbl.get(oid) == blob
    assert ray_tpu_torch.get(worker_mod.ObjectRef(ObjectID(oid)),
                             timeout=30) == "dup-value"


def test_worker_death_between_batched_completions(results):
    assert same_result(results, "worker_death_between_batched_completions") \
        == [i * 3 for i in range(30)]


# ------------------------------------------------- elastic worker pool


def test_elastic_pool_grows_and_shrinks():
    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod

    ray_tpu_torch.init(num_cpus=2, object_store_memory=128 * 1024 * 1024,
                       _system_config={"num_workers_soft_limit": 5,
                                       "worker_idle_timeout_s": 1.0,
                                       "lease_enabled": 0,
                                       "local_scheduling_enabled": 0})
    try:
        nm = worker_mod._global_cluster.nm

        def pool_size():
            with nm._lock:
                return len([x for x in nm._workers.values()
                            if not x.dedicated and x.state != "dead"
                            and x.proc.poll() is None])

        @ray_tpu_torch.remote(num_cpus=0)
        def hold():
            time.sleep(0.6)
            return 1

        refs = [hold.remote() for _ in range(8)]
        peak = pool_size()
        deadline = time.time() + 20
        while time.time() < deadline and peak < 4:
            peak = max(peak, pool_size())
            time.sleep(0.05)
        assert peak >= 4, \
            f"queue pressure should grow the pool past its base (got {peak})"
        assert peak <= 5, "growth must respect num_workers_soft_limit"
        assert sum(ray_tpu_torch.get(refs, timeout=120)) == 8
        # Idle shrink: back to the base pool within the idle timeout
        # (+ reaper cadence headroom).
        deadline = time.time() + 20
        while time.time() < deadline and pool_size() > nm._max_pool:
            time.sleep(0.2)
        assert pool_size() <= nm._max_pool, \
            "idle workers above the base pool must retire"
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------------------ cache-pressure paths


def test_inline_cache_disabled_still_resolves(results):
    assert same_result(results, "inline_cache_disabled_still_resolves") == \
        [("v", i) for i in range(10)]


def test_inline_eligibility_unit():
    import numpy as np

    def check(pkg):
        io = _priv(pkg, "inline_objects")
        ser = _priv(pkg, "serialization")
        small = ser.serialize(41)
        oob = ser.serialize(np.zeros(8, dtype=np.float32))
        return (io.eligible(small, 8192), io.eligible(small, 0),
                io.eligible(small, small.total_size() - 1),
                bool(oob.buffers),
                # numpy rides out-of-band under protocol 5
                bool(oob.buffers) and io.eligible(oob, 1 << 20))

    got = _both(check)
    assert got[:3] == (True, False, False)
    assert got[4] is False


def test_inline_table_insert_evicts_oldest_of_same_job():
    def check(pkg):
        tbl = _priv(pkg, "inline_objects").InlineTable(per_job_bytes=1000)
        job_a, job_b = b"A", b"B"
        first = tbl.insert(b"o1", b"x" * 600, job_a, "n1")
        second = [s[0] for s in tbl.insert(b"o2", b"y" * 600, job_a, "n1")]
        # Job B has its own budget.
        third = tbl.insert(b"o3", b"z" * 600, job_b, "n2")
        # Keep-until-confirmed: the selected entry is still readable...
        kept = tbl.get(b"o1")
        # ...until the store copy confirms and the caller drops it.
        dropped = tbl.drop(b"o1")
        return first, second, third, kept, dropped, tbl.get(b"o1"), \
            tbl.stats()

    first, second, third, kept, dropped, gone, stats = _both(check)
    assert first == []
    assert second == [b"o1"], \
        "over-budget insert must select the job's oldest entry"
    assert third == []
    assert kept == b"x" * 600
    assert dropped and gone is None
    assert stats == (2, 1200)


def test_completion_not_held_behind_slow_successor(results):
    fast, bounded, slow = same_result(
        results, "completion_not_held_behind_slow_successor")
    assert fast == "fast"
    assert bounded, "fast result held behind slow()"
    assert slow == "slow"


def test_inline_table_pressure_sweep_reselects_lost_spills():
    """A store_inline_objects notify lost in flight must be re-sent by the
    periodic pressure sweep: insert() only re-selects when the same job
    inserts again, so a job that went quiet after a lost notify would
    otherwise hold its over-budget bytes forever."""
    def check(pkg):
        io = _priv(pkg, "inline_objects")
        tbl = io.InlineTable(per_job_bytes=1000)
        out = [tbl.insert(b"o1", b"x" * 600, b"J", "n1"),
               [s[0] for s in tbl.insert(b"o2", b"y" * 600, b"J", "n1")],
               # Within the retry window the in-flight spill is not re-sent.
               tbl.pressure_spills()]
        # Once it goes stale (lost notify), the sweep re-selects it.
        tbl._spilling[b"o1"] -= io.InlineTable.SPILL_RETRY_S + 1
        out.append([s[0] for s in tbl.pressure_spills()])
        # Confirmation drops it; an under-budget job has nothing to spill.
        out.append(tbl.drop(b"o1"))
        out.append(tbl.pressure_spills())
        return out

    assert _both(check) == [[], [b"o1"], [], [b"o1"], True, []]


def test_free_mid_spill_late_confirm_deletes_not_resurrects():
    """free() racing an in-flight pressure spill: the spill target is not in
    the directory yet (keep-until-confirmed), so the free's delete fan-out
    misses it — the late add_object_locations confirm must queue a delete
    for the freed store copy instead of re-registering a location that
    would leak it forever."""
    def check(pkg):
        io = _priv(pkg, "inline_objects")
        gcs = _priv(pkg, "gcs").GcsServer()
        out = []
        try:
            tbl = gcs._inline_tbl
            tbl._budget = 1000
            job = b"J"
            o1, o2, o3 = b"a" * 28, b"b" * 28, b"c" * 28
            with gcs._obj_lock:
                out.append(tbl.insert(o1, b"x" * 600, job, "nodeX"))
                gcs._obj_locations[o1].add(io.INLINE_LOCATION)
                spills = tbl.insert(o2, b"y" * 600, job, "nodeX")
                gcs._obj_locations[o2].add(io.INLINE_LOCATION)
            out.append([s[0] for s in spills])   # o1's spill in flight
            with gcs._obj_lock:
                gcs._free_now([o1])
            out.append(o1 in gcs._freed_mid_spill)
            with gcs._sched_lock, gcs._obj_lock:
                out.append(gcs._add_location_obj_quiet(o1, "nodeX", 600))
            out += [o1 not in gcs._obj_locations,
                    gcs._deferred_deletes.get("nodeX"),
                    o1 not in gcs._freed_mid_spill]
            # An unrelated fresh object on the same node registers normally.
            with gcs._sched_lock, gcs._obj_lock:
                gcs._add_location_obj_quiet(o3, "nodeX", 10)
            out.append("nodeX" in gcs._obj_locations[o3])
            # Re-targeted spill (producer dead, sent to another live node):
            # the tombstone must follow the REAL target or the fallback
            # node's confirm bypasses it.
            tbl._spilling[o2] = time.monotonic()   # select o2's spill
            out += [tbl.spill_inflight(o2), tbl.note_spill_target(o2, "nodeY"),
                    tbl.spill_inflight(o2)]
            with gcs._obj_lock:
                gcs._free_now([o2])
            out.append(gcs._freed_mid_spill[o2][0])
            with gcs._sched_lock, gcs._obj_lock:
                out.append(gcs._add_location_obj_quiet(o2, "nodeY", 600))
            out += [o2 not in gcs._obj_locations,
                    o2 in gcs._deferred_deletes.get("nodeY", [])]
            return out
        finally:
            gcs.close()

    o1, o2 = b"a" * 28, b"b" * 28
    assert _both(check) == [
        [], [o1], True, [], True, [o1], True, True,
        "nodeX", True, "nodeY", "nodeY", [], True, True], \
        "freed object resurrected or its delete lost"


def test_wait_pops_resolved_pending_returns(ray_cluster):
    """wait() must retire resolved oids from the pending-returns window: a
    poll loop re-waiting on a completed ref otherwise pays the GCS
    wait_for_objects round trip on every iteration forever (the window
    entry shadows the local store probe)."""
    import ray_tpu_torch

    w = _worker()

    @ray_tpu_torch.remote
    def f():
        return 1

    ref = f.remote()
    ready, rest = ray_tpu_torch.wait([ref], timeout=30)
    assert ready and not rest
    assert ref._id.binary() not in w._pending_returns


def test_wait_stops_probing_after_num_returns_satisfied(ray_cluster):
    """wait(num_returns=k) must stop scanning once k refs are ready: the
    result only takes the first k ready refs, so probing the rest re-pays a
    store.contains per ref on every poll iteration for refs the caller
    already collected."""
    import ray_tpu_torch

    w = _worker()
    refs = [ray_tpu_torch.put(i) for i in range(16)]
    calls = []
    real = w.store.contains

    def counting(oid):
        calls.append(oid)
        return real(oid)

    w.store.contains = counting
    try:
        ready, rest = ray_tpu_torch.wait(refs, num_returns=1, timeout=10)
    finally:
        w.store.contains = real
    assert len(ready) == 1 and len(rest) == 15
    # fetch_local may legitimately re-probe the ONE ready ref; the scan
    # must not have touched the other fifteen.
    assert len(set(calls)) <= 1, \
        f"scanned past num_returns: {len(set(calls))} distinct probes"


def test_pool_pressure_ignores_chip_starved_tpu_specs():
    """A queue holding only GPU specs waiting for GPUs must not grow the
    shared CPU pool: a pool worker spawned for them could never run them,
    and each dispatch pass would ramp the pool to its cap."""
    from ray_tpu_torch._private.node_manager import NodeManager

    class _Spec:
        def __init__(self, res):
            self.resources = res

    class _Stub:
        _workers = {}
        _pool_cap = 8
        _task_queue = [_Spec({"GPU": 4.0})]

    assert not NodeManager._pool_pressure_locked(_Stub())
    _Stub._task_queue.append(_Spec({"CPU": 1.0}))
    assert NodeManager._pool_pressure_locked(_Stub())


def test_failed_report_flush_requeues_inline_blobs(ray_cluster):
    """A lease_task_events notify failure must RE-QUEUE the completion
    reports: with inline returns the report carries the only durable copy
    of the value — dropping it would turn a transient GCS hiccup into data
    loss once the driver's inline cache churns."""
    import ray_tpu_torch

    w = _worker()

    @ray_tpu_torch.remote
    def f():
        return "requeue-me"

    assert ray_tpu_torch.get(f.remote(), timeout=60) == "requeue-me"
    lm = w._lease_mgr
    real_notify = w.gcs.notify
    dropped = {"n": 0}

    def flaky(verb, payload=None, **kw):
        if verb == "lease_task_events":
            dropped["n"] += 1
            raise ConnectionError("injected GCS hiccup")
        return real_notify(verb, payload, **kw)

    w.gcs.notify = flaky
    try:
        ref = f.remote()
        # In-band delivery serves the local get regardless of the GCS.
        assert ray_tpu_torch.get(ref, timeout=30) == "requeue-me"
        deadline = time.time() + 10
        while dropped["n"] == 0 and time.time() < deadline:
            lm._flush_reports()
            time.sleep(0.01)
        assert dropped["n"] >= 1
        requeued = False
        for _ in range(200):
            with lm._lock:
                if lm._reports:
                    requeued = True
                    break
            time.sleep(0.01)
        assert requeued, "failed lease report was dropped, not re-queued"
    finally:
        w.gcs.notify = real_notify
    # GCS reachable again: the retry must land the blob in the inline
    # table, so the value survives driver-cache eviction.
    for _ in range(200):
        lm._flush_reports()
        with lm._lock:
            if not lm._reports:
                break
        time.sleep(0.01)
    w._inline.pop(ref._id.binary())
    assert ray_tpu_torch.get(ref, timeout=30) == "requeue-me"


def test_mirrors_every_reference_test():
    assert_mirrored("inline_returns")
