"""``tests/test_ids.py`` on the port's ids, test by test.

An id's format is a value: each test runs its check on both
``_private/ids`` modules (and ``task_spec.ResourceSet``) in this process
and holds that they give the same sizes, embeddings and bytes where the
bytes are deterministic, and that the port's pass the reference test's
own assertions.
"""

import importlib
import pickle

from torch_mirror import assert_mirrored

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _both(check, module="ids"):
    """``check(module)`` on the reference's, then on the port's; the two
    results must be equal."""
    ref, port = (check(importlib.import_module(f"{p}._private.{module}"))
                 for p in PACKAGES)
    assert port == ref, (port, ref)
    return port


def test_sizes():
    def check(ids):
        job = ids.JobID.from_int(7)
        actor = ids.ActorID.of(job)
        task = ids.TaskID.for_actor_task(actor)
        obj = ids.ObjectID.for_return(task, 0)
        return (len(ids.JobID.from_int(1).binary()), len(actor.binary()),
                len(task.binary()), len(obj.binary()), job.binary())

    assert _both(check)[:4] == (4, 16, 24, 28)


def test_embedding_roundtrip():
    def check(ids):
        job = ids.JobID.from_int(42)
        actor = ids.ActorID.of(job)
        task = ids.TaskID.for_actor_task(actor)
        obj = ids.ObjectID.for_return(task, 3)
        put = ids.ObjectID.for_put(task, 1)
        return (actor.job_id() == job, task.actor_id() == actor,
                task.job_id() == job, obj.task_id() == task, obj.index(),
                obj.job_id() == job, obj.is_put(), put.is_put(),
                put.task_id() == task)

    assert _both(check) == (True, True, True, True, 3, True, False, True,
                            True)


def test_normal_task_has_nil_actor():
    def check(ids):
        job = ids.JobID.from_int(1)
        task = ids.TaskID.for_task(job)
        return task.job_id() == job, task.actor_id().binary()[:12]

    assert _both(check) == (True, b"\xff" * 12)


def test_hex_and_equality():
    def check(ids):
        n = ids.NodeID.from_random()
        return (ids.NodeID.from_hex(n.hex()) == n,
                n != ids.NodeID.from_random(),
                len({n, ids.NodeID(n.binary())}), len(n.hex()))

    assert _both(check)[:3] == (True, True, 1)


def test_nil():
    def check(ids):
        return (ids.TaskID.nil().is_nil(),
                ids.TaskID.for_task(ids.JobID.from_int(1)).is_nil(),
                ids.TaskID.nil().binary())

    assert _both(check)[:2] == (True, False)


def test_placement_group_id():
    def check(ids):
        job = ids.JobID.from_int(9)
        pg = ids.PlacementGroupID.of(job)
        return len(pg.binary()), pg.job_id() == job

    assert _both(check) == (18, True)


def test_pickle_roundtrip():
    def check(ids):
        obj = ids.ObjectID.for_return(ids.TaskID.for_task(
            ids.JobID.from_int(5)), 2)
        back = pickle.loads(pickle.dumps(obj))
        return back == obj, back.index(), type(back).__name__

    assert _both(check) == (True, 2, "ObjectID")


def test_resource_set_fixed_point_exact_restoration():
    """Integer-scaled arithmetic: 10k fractional acquire/release cycles
    restore capacity exactly, and 40 x 0.1 CPU pack with zero drift."""
    def check(ts):
        rs = ts.ResourceSet({"CPU": 4.0, "custom": 1.0})
        ok = True
        for _ in range(10_000):
            ok &= rs.acquire({"CPU": 0.1, "custom": 0.3})
            ok &= rs.acquire({"CPU": 0.2})
            rs.release({"CPU": 0.2})
            rs.release({"CPU": 0.1, "custom": 0.3})
        restored = rs.to_dict()
        packed = all(rs.acquire({"CPU": 0.1}) for _ in range(40))
        return ok, restored, packed, rs.acquire({"CPU": 0.1}), rs.get("CPU")

    assert _both(check, "task_spec") == (
        True, {"CPU": 4.0, "custom": 1.0}, True, False, 0.0)


def test_entropy_fork_safety():
    """Forked children must not replay the parent's buffered ID entropy
    (the port's ids alone: the child's id is random)."""
    import multiprocessing as mp

    from ray_tpu_torch._private import ids

    ids.TaskID.for_task(ids.JobID.from_int(1))  # warm the buffer

    def child(q):
        q.put(ids.TaskID.for_task(ids.JobID.from_int(1)).binary())

    ctx = mp.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=child, args=(q,))
    p.start()
    child_id = q.get(timeout=10)
    p.join(timeout=10)
    parent_id = ids.TaskID.for_task(ids.JobID.from_int(1)).binary()
    assert child_id != parent_id


def test_mirrors_every_reference_test():
    assert_mirrored("ids")
