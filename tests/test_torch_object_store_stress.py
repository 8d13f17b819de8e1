"""``tests/test_object_store_stress.py`` on the port's shm arena
(``ray_tpu_torch/object_store/store.cpp``): create/seal/get/evict/delete
races with clients SIGKILLed mid-operation.

The arena's index lives in shared memory behind one process-shared
ROBUST mutex; a client killed while holding it must leave the store
usable for every survivor (EOWNERDEAD -> ``pthread_mutex_consistent``).
It reads the store's client API and stats, so it runs on the port alone.
"""

import multiprocessing
import os
import random
import signal
import time

from ray_tpu_torch.object_store import plasma
from torch_mirror import assert_mirrored

_POOL = 48              # shared object-id space => maximum contention
_CAPACITY = 1024 * 1024  # small arena => constant eviction pressure


def _oid(i: int) -> bytes:
    return b"ST" + i.to_bytes(4, "little") + b"\x00" * 22


def _hammer(path: str, seed: int):
    """Loop create/seal/get/release/delete over a shared oid pool until
    killed. Every op may race with a sibling's op on the same object."""
    rng = random.Random(seed)
    c = plasma.PlasmaClient(path)
    while True:
        o = _oid(rng.randrange(_POOL))
        r = rng.random()
        try:
            if r < 0.45:
                buf = c.create(o, rng.randrange(256, 48 * 1024))
                buf[:4] = b"data"
                del buf
                c.seal(o)
            elif r < 0.80:
                v = c.get_buffer(o, timeout_ms=0)
                if v is not None:
                    assert bytes(v[:4]) == b"data"
                    del v
                    c.release(o)
            else:
                c.delete(o)
        except plasma.ObjectExistsError:
            pass
        except plasma.StoreFullError:
            time.sleep(0.001)   # all pinned; let eviction catch up
        except Exception:
            pass   # racing delete/evict of the object mid-op


def _verify(path: str, q):
    """Full create/seal/get/delete round trip on a fresh client — run in
    a subprocess so a wedged arena mutex shows up as a join timeout, not
    a hung test suite."""
    try:
        c = plasma.PlasmaClient(path)
        o = _oid(_POOL + 7)   # outside the hammered pool
        c.delete(o)
        buf = c.create(o, 11)
        buf[:] = b"still-alive"
        del buf
        c.seal(o)
        v = c.get_buffer(o, timeout_ms=2000)
        ok = v is not None and bytes(v) == b"still-alive"
        if v is not None:
            del v
            c.release(o)
        c.delete(o)
        s = c.stats()
        ok = ok and 0 <= s["used_bytes"] <= s["capacity_bytes"]
        c.close()
        q.put(("ok" if ok else f"bad state: {s}", s))
    except BaseException as e:
        q.put((f"error: {e!r}", None))


def test_store_survives_client_sigkill(tmp_path):
    path = str(tmp_path / "stress-arena")
    plasma.create_store(path, capacity=_CAPACITY, max_objects=256)
    ctx = multiprocessing.get_context("fork")
    rng = random.Random(0xC0FFEE)
    stats = None
    for round_no in range(3):
        procs = [ctx.Process(target=_hammer,
                             args=(path, round_no * 10 + i), daemon=True)
                 for i in range(4)]
        for p in procs:
            p.start()
        time.sleep(0.4)   # let contention build
        for p in procs:
            time.sleep(rng.uniform(0.0, 0.15))   # land kills mid-op
            os.kill(p.pid, signal.SIGKILL)
        for p in procs:
            p.join(timeout=10)
            assert not p.is_alive()
        q = ctx.Queue()
        v = ctx.Process(target=_verify, args=(path, q), daemon=True)
        v.start()
        v.join(timeout=20)
        if v.is_alive():
            v.kill()
            raise AssertionError(
                f"round {round_no}: verifier hung — arena mutex not "
                f"recovered after client SIGKILL")
        status, stats = q.get(timeout=5)
        assert status == "ok", f"round {round_no}: {status}"
    # The pressure was real: the eviction path ran under the races.
    assert stats is not None and stats["evictions"] > 0


def test_mirrors_every_reference_test():
    assert_mirrored("object_store_stress")
