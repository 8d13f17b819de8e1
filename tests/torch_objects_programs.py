"""The reference's tests of the runtime core's objects as programs, run
on both runtimes: ``tests/test_spilling.py``, ``test_refcount_lineage.py``
and ``test_chunked_pull.py``, one group each.

As in ``torch_api_programs``: each program is the body of the reference
test of the same name (without ``test_``), on the cluster its fixture
starts, and returns what the test asserts on as plain values. Only the
tests whose result is a value are here; those that read the store or the
node manager run on the port alone, in their test files.

The module imports neither runtime, nor jax. ``python
tests/torch_objects_programs.py GROUP DIR`` runs a group on ``ray_tpu``.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from torch_api_programs import (
    MiB, T, cluster, main, pinned, raises, run_programs, sub,
    two_node_cluster,
)

# ---------------------------------------------------------------- spilling


@cluster(num_cpus=2, object_store_memory=8 * MiB)
def spilled_objects_served_to_tasks(rt, accel, tmp):
    big = [rt.put(np.full(2 * MiB // 8, i, np.int64)) for i in range(6)]
    nm = sub(rt, "_private.worker")._global_cluster.nm
    end = time.time() + 15
    while time.time() < end and not nm._spilled:
        time.sleep(0.2)

    @rt.remote
    def total(arr):
        return int(arr[0])

    # Workers fetch (possibly spilled) args through the store/NM path.
    return rt.get([total.remote(r) for r in big], timeout=60)


# ---------------------------------------------------------------- refcount
# The reference's ``two_node_cluster`` fixture labels its worker node.


@two_node_cluster(labels={"zone": "b"})
def lineage_reconstruction_on_node_death(rt, c, worker_node):
    """An object whose only copy lived on a dead node is rebuilt by
    re-running its producing task on a surviving node."""
    @rt.remote(max_retries=2)
    def produce(seed):
        return np.full((1 << 16,), seed, np.uint8)

    ref = produce.options(
        scheduling_strategy=pinned(rt, worker_node)).remote(9)
    first = int(rt.get(ref, timeout=T)[0])
    c.remove_node(worker_node)
    out = rt.get(ref, timeout=30)
    return first, int(out[0]), out.shape


@two_node_cluster(labels={"zone": "b"})
def chained_lineage_reconstruction(rt, c, worker_node):
    """Losing both links of a task chain rebuilds recursively."""
    strat = pinned(rt, worker_node)

    @rt.remote(max_retries=2)
    def base():
        return np.full((1 << 14,), 3, np.uint8)

    @rt.remote(max_retries=2)
    def double(x):
        return (x.astype(np.uint16) * 2).astype(np.uint8)

    a = base.options(scheduling_strategy=strat).remote()
    b = double.options(scheduling_strategy=strat).remote(a)
    first = int(rt.get(b, timeout=T)[0])
    c.remove_node(worker_node)
    return first, int(rt.get(b, timeout=30)[0])


@two_node_cluster(labels={"zone": "b"})
def lost_put_object_fails_cleanly(rt, c, worker_node):
    """put() objects have no lineage: losing every copy surfaces a clear
    error instead of hanging."""
    @rt.remote
    class Putter:
        def make(self):
            return [rt.put(np.ones(1 << 14, np.uint8))]

    p = Putter.options(scheduling_strategy=pinned(rt, worker_node)).remote()
    (ref,) = rt.get(p.make.remote(), timeout=T)
    # The put's location reaches the GCS on the putter's own connection,
    # after its return may already be here: a node removed in between
    # takes the notification with it, and the object then never shows as
    # lost, only as never ready (a race both runtimes share; ROADMAP §3).
    # Wait until the directory has the copy, as the reference test
    # assumes.
    located, _ = rt.wait([ref], timeout=T, fetch_local=False)
    c.remove_node(worker_node)
    return located == [ref], raises(lambda: rt.get(ref, timeout=20),
                                    Exception, "[lL]ost")


@cluster(num_cpus=2, object_store_memory=64 * MiB,
         _system_config={"free_grace_s": 0.2, "refcount_flush_ms": 30})
def actor_task_args_pinned_in_flight(rt, accel, tmp):
    """An ObjectRef passed to a busy actor and dropped at once by the
    caller survives until the actor runs the task."""
    @rt.remote
    class Slowpoke:
        def block(self, sec):
            time.sleep(sec)
            return "done"

        def read(self, arr):
            return int(np.asarray(arr).sum())

    a = Slowpoke.remote()
    rt.get(a.block.remote(0.0), timeout=T)   # actor up
    blocker = a.block.remote(2.0)      # occupy the actor > grace window
    payload = rt.put(np.ones(1024, np.int64))
    res = a.read.remote(payload)
    del payload                        # caller's last ref dies NOW
    gc.collect()
    return rt.get(res, timeout=60), rt.get(blocker, timeout=60)


# ----------------------------------------------------------------- chunked


def two_node_small_chunks(prog):
    """The reference's ``two_node_small_chunks`` fixture: 256 KiB chunks
    and 4 in flight, two 2-CPU nodes of 256 MiB stores."""
    def run(rt, accel, tmp):
        config = sub(rt, "_private.config").config
        config.set("fetch_chunk_bytes", 256 * 1024)
        config.set("pull_max_inflight_chunks", 4)
        try:
            cu = sub(rt, "cluster_utils")
            c = cu.Cluster(initialize_head=True, head_node_args={
                "num_cpus": 2, "object_store_memory": 256 * MiB})
            c.add_node(num_cpus=2, object_store_memory=256 * MiB)
            c.connect(object_store_memory=256 * MiB)
            c.wait_for_nodes()
            try:
                return prog(rt, c)
            finally:
                rt.shutdown()
                c.shutdown()
        finally:
            config.set("fetch_chunk_bytes", 5 * MiB)
            config.set("pull_max_inflight_chunks", 8)
    run.__name__ = prog.__name__
    return run


@two_node_small_chunks
def chunked_pull_roundtrip(rt, c):
    """A multi-chunk object produced on the remote node arrives intact."""
    @rt.remote(num_cpus=1, scheduling_strategy="SPREAD")
    def make(seed):
        rng = np.random.default_rng(seed)
        return rng.integers(0, 255, 3 * MiB, dtype=np.uint8)

    vals = rt.get([make.remote(s) for s in range(4)], timeout=120)
    return [bool(np.array_equal(v, np.random.default_rng(s).integers(
        0, 255, 3 * MiB, dtype=np.uint8))) for s, v in enumerate(vals)]


@two_node_small_chunks
def chunked_pull_bounded_memory(rt, c):
    """Pulling a 96 MiB object does not buffer a second whole copy on
    the Python heap: the peak growth stays under 16 MiB."""
    import tracemalloc

    @rt.remote(num_cpus=1)
    def make_big():
        return np.zeros(96 * MiB, dtype=np.uint8)

    ref = make_big.remote()
    rt.wait([ref], timeout=120)
    tracemalloc.start()
    try:
        val = rt.get(ref, timeout=180)
        _cur, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return val.nbytes, peak < 16 * MiB


@two_node_small_chunks
def concurrent_pulls_do_not_blow_store(rt, c):
    """8 concurrent multi-chunk pulls complete with a bounded shared
    admission window (no OOM, no deadlock)."""
    @rt.remote(num_cpus=1, scheduling_strategy="SPREAD")
    def chunk_blob(seed):
        return np.full(4 * MiB, seed, dtype=np.uint8)

    vals = rt.get([chunk_blob.remote(s) for s in range(8)], timeout=180)
    return [(int(v[0]), int(v[-1]), v.nbytes) for v in vals]


PROGRAMS = {
    "spilling": [spilled_objects_served_to_tasks],
    "refcount": [lineage_reconstruction_on_node_death,
                 chained_lineage_reconstruction,
                 lost_put_object_fails_cleanly,
                 actor_task_args_pinned_in_flight],
    "chunked": [chunked_pull_roundtrip, chunked_pull_bounded_memory,
                concurrent_pulls_do_not_blow_store],
}


def run_group(rt, accel, group, tmp):
    return run_programs(PROGRAMS[group], rt, accel, tmp)


if __name__ == "__main__":
    main(run_group)
