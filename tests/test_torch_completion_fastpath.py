"""``tests/test_completion_fastpath.py`` on the port's runtime, test by
test.

Every test but the ring's own reads the driver's lease manager, its
completion ring and segments, or the node manager's producers, so it runs
on the port alone, translated name for name; the ring files and their
segments live under the port's session directory
(``$TMPDIR/ray_tpu_torch``), which is where the unlink tests look. The
four doorbell tests drive ``_private/completion_ring.py`` by itself: each
runs its check on both packages' rings in this process, and the results
must be equal and pass the reference's assertions.
"""

import glob
import os
import pickle
import signal
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import node_manager as nm_mod
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.exceptions import CompletionAbsorbError
from torch_mirror import assert_mirrored


def _cluster(**system_config):
    return ray_tpu_torch.init(num_cpus=2,
                              object_store_memory=128 * 1024 * 1024,
                              _system_config=system_config or None)


@pytest.fixture
def ray_cluster():
    ctx = _cluster()
    yield ctx
    ray_tpu_torch.shutdown()


def _worker():
    return worker_mod.global_worker()


def _nm():
    return worker_mod._global_cluster.nm


def _wait_for(pred, timeout=15, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if pred():
                return
        except Exception:
            pass
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _record_blob(oid: bytes, value_blob: bytes) -> bytes:
    """A completion record exactly as worker_main pickles them into
    task_done_batch frames (the NM relays these blobs verbatim)."""
    return pickle.dumps({
        "task_id": b"\x01" * 24,
        "status": "ok",
        "objects": [(oid, len(value_blob))],
        "error": None,
        "node_id": "test-node",
        "inline": {oid: value_blob},
    }, protocol=5)


def _activate_ring(w):
    """Run one task (registration triggers off _note_pending_returns)
    and wait until the driver's consumer loop AND the NM's producer
    are both live."""

    @ray_tpu_torch.remote
    def _poke():
        return 0

    assert ray_tpu_torch.get(_poke.remote()) == 0
    _wait_for(lambda: w._comp_ring_state in (2, 3), msg="ring registration")
    assert w._comp_ring_state == 2, "ring registration failed"
    _wait_for(lambda: any(_nm()._completion_rings.values()),
              msg="NM producer registration")


# --------------------------------------------- stage 1: absorb split


def test_absorb_split_executes_identically():
    """Socket framing path (worker segments pinned off so completions
    arrive as lease_tasks_done_b frames): frames park in the ingest
    deque and a dedicated absorb thread (not the conn thread)
    unpickles them — and every result comes back exactly as the
    classic path would deliver it."""
    _cluster(worker_completion_ring_enabled=False)
    try:
        w = _worker()
        lm = w._lease_mgr
        assert lm is not None and lm._absorb_exec is not None

        @ray_tpu_torch.remote
        def f(x):
            return x * 2

        assert ray_tpu_torch.get([f.remote(i) for i in range(64)]) == [
            i * 2 for i in range(64)]
        # The executor actually ran (its worker thread only spawns on
        # the first submitted frame) and drained everything it parked.
        assert any(t.name.startswith("rtpu-completion-absorb")
                   for t in threading.enumerate())
        assert len(lm._ingest) == 0
    finally:
        ray_tpu_torch.shutdown()


def test_absorb_disabled_classic_wire():
    """Knob off: no absorb executor exists, the ingest deque is never
    touched, and the worker ships the legacy lease_tasks_done dict —
    results still correct (off-path byte-identical behavior)."""
    _cluster(completion_absorb_enabled=False)
    try:
        w = _worker()
        lm = w._lease_mgr

        @ray_tpu_torch.remote
        def f(x):
            return x * 3

        assert ray_tpu_torch.get([f.remote(i) for i in range(64)]) == [
            i * 3 for i in range(64)]
        assert lm._absorb_exec is None
        assert len(lm._ingest) == 0
        assert not any(t.name.startswith("rtpu-completion-absorb")
                       for t in threading.enumerate())
    finally:
        ray_tpu_torch.shutdown()


def test_absorb_failure_raises_typed_error(ray_cluster):
    """A frame the absorb stage cannot decode fails the lease's pending
    returns with CompletionAbsorbError — get() raises it promptly
    instead of hanging on a completion event nobody will ever set."""
    w = _worker()
    lm = w._lease_mgr

    @ray_tpu_torch.remote
    def stall():
        time.sleep(60)

    ref = stall.remote()
    lm.flush_sends()
    _wait_for(lambda: len(lm._task_lease) >= 1, msg="lease in flight")
    lease = next(iter(lm._task_lease.values()))[0]
    # Drive the absorb path exactly as _drain_ingest would, with a
    # frame that cannot unpickle.
    lm._absorb_frame(lease, [b"\x80garbage-not-a-pickle"])
    with pytest.raises(CompletionAbsorbError):
        ray_tpu_torch.get(ref, timeout=10)


# ------------------------------------------ stage 2: completion ring


def test_ring_records_absorb_into_inline_cache(ray_cluster):
    """An NM-relayed record lands its inline blob in the driver's
    process cache and retires the pending-returns window entry without
    any socket traffic."""
    w = _worker()
    _activate_ring(w)
    oid = os.urandom(28)
    w._pending_returns[oid] = None
    _nm()._relay_completion_rings([_record_blob(oid, b"payload-bytes")])
    _wait_for(lambda: oid in w._inline, msg="ring record absorbed")
    assert w._inline.get(oid) == b"payload-bytes"
    assert oid not in w._pending_returns


def test_ring_full_falls_back_counted(ray_cluster):
    """With the consumer stalled, a full ring makes append() refuse —
    the NM counts the drop (driver_completion_ring_full_total) and
    relies on the unconditional GCS relay; once the consumer resumes
    it drains the backlog and appends succeed again."""
    w = _worker()
    _activate_ring(w)
    nm = _nm()
    ent = next(ents[0] for ents in nm._completion_rings.values() if ents)
    producer = ent["producer"]

    w._comp_ring_pause = True   # consumer idles; head stops moving
    try:
        big = _record_blob(os.urandom(28), b"x" * 65536)
        for _ in range(4096):
            if not producer.append(big):
                break
        else:
            pytest.fail("ring never filled")

        counter = nm_mod._comp_ring_full_counter()
        before = sum(counter._values.values())
        nm._relay_completion_rings([_record_blob(os.urandom(28),
                                                 b"y" * 65536)])
        assert sum(counter._values.values()) > before
    finally:
        w._comp_ring_pause = False
    # Consumer catches up: the backlog drains and the ring takes
    # appends again.
    _wait_for(lambda: producer.append(_record_blob(os.urandom(28), b"z")),
              msg="ring drained after stall")


def test_nm_death_unconsumed_records_recovered(ray_cluster):
    """Records a dead NM left in the ring are plain shared memory: the
    driver finishes draining them (no stranded record) and redelivered
    blobs are idempotent (no double-deliver)."""
    w = _worker()
    _activate_ring(w)
    nm = _nm()
    ent = next(ents[0] for ents in nm._completion_rings.values() if ents)
    producer = ent["producer"]
    ring = w._comp_ring
    ring_path = ring.path

    oids = [os.urandom(28) for _ in range(3)]
    blobs = [_record_blob(o, b"val-%d" % i) for i, o in enumerate(oids)]

    w._comp_ring_pause = True
    try:
        for b in blobs:
            assert producer.append(b)
        # "NM dies": the producer goes away mid-ring. close() flags the
        # ring closed and rings the bell but NEVER unlinks — the
        # unconsumed records stay valid shm for the driver to finish.
        producer.close()
        with nm._lock:
            for ents in nm._completion_rings.values():
                ents[:] = [e for e in ents if e is not ent]
    finally:
        w._comp_ring_pause = False

    for i, o in enumerate(oids):
        _wait_for(lambda o=o: o in w._inline, msg="post-death drain")
        assert w._inline.get(o) == b"val-%d" % i
    # Redelivery (the GCS copy arriving later, or a replayed frame) is
    # a no-op, not a double-deliver.
    for b in blobs:
        w._absorb_completion_record(b)
    for i, o in enumerate(oids):
        assert w._inline.get(o) == b"val-%d" % i
    # Producer closed + drained => the consumer loop exits and unlinks.
    _wait_for(lambda: not os.path.exists(ring_path),
              msg="ring unlink after producer close")


def test_driver_shutdown_unlinks_ring_files():
    """Driver shutdown must unlink both the ring file and the doorbell
    socket — a leaked mmap would have the NM producing into a file no
    one will ever drain."""
    _cluster()
    try:
        w = _worker()
        _activate_ring(w)
        path = w._comp_ring.path
        assert os.path.exists(path)
    finally:
        ray_tpu_torch.shutdown()
    deadline = time.time() + 5
    while time.time() < deadline and os.path.exists(path):
        time.sleep(0.05)
    assert not os.path.exists(path), "ring file leaked"
    assert not os.path.exists(path + ".bell"), "doorbell socket leaked"


def test_ring_disabled_never_registers():
    """Knob off: the driver never creates a ring file and the NM never
    gains a producer — the socket/GCS path carries everything."""
    _cluster(completion_ring_enabled=False)
    try:
        w = _worker()

        @ray_tpu_torch.remote
        def f():
            return 7

        assert ray_tpu_torch.get(f.remote()) == 7
        time.sleep(0.2)
        assert w._comp_ring_state == 0
        assert w._comp_ring is None
        assert not any(_nm()._completion_rings.values())
    finally:
        ray_tpu_torch.shutdown()


# --------------------------------- stage 3: parallel wave collection


def test_get_and_wait_steal_parked_frames():
    """With the absorb executor wedged (frames park but nothing drains
    them), a caller blocking on a lease completion steals the parked
    frame onto its OWN thread: get() returns the value and wait()
    reports readiness without the GCS round trip — neither idles on an
    event only the dead executor would have set. (Worker segments
    pinned off: the stall under test is the SOCKET frame path.)"""
    _cluster(worker_completion_ring_enabled=False)
    try:
        w = _worker()
        lm = w._lease_mgr
        real_submit = lm._absorb_submit
        lm._absorb_submit = lambda: None   # frames park; nothing drains
        try:

            @ray_tpu_torch.remote
            def f(x):
                return x + 100

            ref = f.remote(7)
            lm.flush_sends()
            _wait_for(lambda: len(lm._ingest) > 0, msg="parked frame")
            assert ray_tpu_torch.get(ref, timeout=15) == 107
            assert len(lm._ingest) == 0  # the caller thread absorbed it

            ref2 = f.remote(8)
            lm.flush_sends()
            _wait_for(lambda: len(lm._ingest) > 0,
                      msg="second parked frame")
            ready, rest = ray_tpu_torch.wait([ref2], num_returns=1, timeout=15)
            assert ready == [ref2] and not rest
            assert ray_tpu_torch.get(ref2, timeout=15) == 108
        finally:
            lm._absorb_submit = real_submit
    finally:
        ray_tpu_torch.shutdown()


def test_steal_disabled_gate():
    """completion_steal_enabled=False: steal_absorb() is a hard no-op
    and blocking collection leans on the absorb executor alone."""
    _cluster(completion_steal_enabled=False)
    try:
        w = _worker()
        lm = w._lease_mgr
        assert lm._steal is False
        assert lm.steal_absorb() is False

        @ray_tpu_torch.remote
        def f(x):
            return x - 1

        assert ray_tpu_torch.get([f.remote(i) for i in range(16)]) == [
            i - 1 for i in range(16)]
    finally:
        ray_tpu_torch.shutdown()


# -------------------- stage 4: worker->driver segment transport


def _activate_segment(w):
    """Run lease traffic until the driver's ring is live AND at least
    one same-node worker has attached its completion segment (the
    advertise -> create -> map -> ack handshake is async with respect
    to task completion, so poke until it lands)."""

    @ray_tpu_torch.remote
    def _poke(x):
        return x

    assert ray_tpu_torch.get(_poke.remote(1)) == 1
    _wait_for(lambda: w._comp_ring_state in (2, 3), msg="ring registration")
    assert w._comp_ring_state == 2, "ring registration failed"

    def seg_live():
        ray_tpu_torch.get([_poke.remote(i) for i in range(4)])
        return bool(w._comp_segments)

    _wait_for(seg_live, timeout=20, msg="worker segment attach")


def test_worker_segment_roundtrip(ray_cluster):
    """Default knobs: same-node leased workers attach per-worker
    segments under the driver's ring path and sustained lease traffic
    flows through them with correct results; the segments drain to
    empty when the wave completes."""
    w = _worker()
    _activate_segment(w)
    ring_path = w._comp_ring.path
    assert all(p.startswith(ring_path + ".w") for p in w._comp_segments)

    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    assert ray_tpu_torch.get([f.remote(i) for i in range(300)]) == [
        i + 1 for i in range(300)]
    # Wave done => every record was absorbed and committed.
    _wait_for(lambda: all(not e["seg"].pending()
                          for e in w._comp_segments.values()),
              msg="segments drained")


def test_worker_sigkill_midstream_no_loss_no_leak(ray_cluster):
    """SIGKILL every leased worker mid-wave: records the workers
    published before dying drain from their segments (tail publishes
    after payload, so a torn append is invisible — never a corrupt
    record), the unfinished remainder re-runs via the scheduled
    fallback, and NO segment file outlives its worker (driver
    force-unlink + NM registry backstop)."""
    w = _worker()
    _activate_segment(w)
    ring_path = w._comp_ring.path
    nm = _nm()

    @ray_tpu_torch.remote
    def f(x):
        return x * 7

    refs = [f.remote(i) for i in range(80)]
    with nm._lock:
        pids = [h.proc.pid for h in nm._workers.values()]
    assert pids
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    # At-least-once: every result arrives (segment drain for completed
    # records, scheduled re-run for the rest) and none is corrupt.
    assert ray_tpu_torch.get(refs, timeout=90) == [i * 7 for i in range(80)]
    # The dead workers' segment files are gone (replacement workers may
    # have attached fresh ones; those are live, not leaks).
    _wait_for(lambda: set(glob.glob(ring_path + ".w*")) <=
              set(w._comp_segments),
              msg="dead-worker segment cleanup")


def test_worker_segment_full_falls_back():
    """A tiny segment + a stalled consumer: the worker fills the
    segment, overflow records fall back to the socket
    (lease_tasks_done_b), and when the consumer resumes the backlogged
    ring records are redelivery-idempotent against the socket copies —
    every result correct exactly once."""
    _cluster(worker_completion_ring_bytes=4096)
    try:
        w = _worker()
        _activate_segment(w)

        @ray_tpu_torch.remote
        def f(x):
            # ~1 KiB inlined record: THREE completions fill the 4 KiB
            # segment regardless of pipeline depth, so the stall test
            # never depends on how many tasks are in flight at once.
            return (x, b"v" * 1024)

        w._comp_ring_pause = True   # head stops: segment backlog grows
        try:
            refs = [f.remote(i) for i in range(150)]
            # The segment actually filled (fallback engaged): with the
            # consumer paused, published bytes approach the 4 KiB cap.
            _wait_for(lambda: any(
                e["seg"].backlog_bytes() > 2048
                for e in w._comp_segments.values()),
                msg="segment backlog under stall")
        finally:
            w._comp_ring_pause = False
        assert ray_tpu_torch.get(refs, timeout=60) == [
            (i, b"v" * 1024) for i in range(150)]
    finally:
        ray_tpu_torch.shutdown()


def test_driver_shutdown_unlinks_segments():
    """Driver shutdown with live worker producers: the consumer loop
    force-unlinks every mapped segment and glob-sweeps the ring's
    namespace — no comring_* file (main ring, bell, or segment)
    survives the driver."""
    _cluster()
    try:
        w = _worker()
        _activate_segment(w)
        ring_path = w._comp_ring.path
        seg_paths = list(w._comp_segments)
        assert seg_paths
    finally:
        ray_tpu_torch.shutdown()
    deadline = time.time() + 5
    leftovers = lambda: ([p for p in seg_paths + [ring_path,
                                                  ring_path + ".bell"]
                          if os.path.exists(p)]
                         + glob.glob(ring_path + ".w*"))
    while time.time() < deadline and leftovers():
        time.sleep(0.05)
    assert not leftovers(), f"leaked shm files: {leftovers()}"


def test_worker_ring_disabled_socket_only():
    """worker_completion_ring_enabled=False: no segment ever attaches
    (the driver never advertises) while the NM-relay main ring keeps
    working — the socket carries every lease completion, results
    identical."""
    _cluster(worker_completion_ring_enabled=False)
    try:
        w = _worker()

        @ray_tpu_torch.remote
        def f(x):
            return x - 5

        assert ray_tpu_torch.get([f.remote(i) for i in range(64)]) == [
            i - 5 for i in range(64)]
        time.sleep(0.3)
        assert not w._comp_segments
        assert not w._worker_ring_enabled
    finally:
        ray_tpu_torch.shutdown()


def test_worker_ring_without_main_ring():
    """completion_ring_enabled=False with the worker knob on: there is
    no driver ring for segments to attach next to, so the whole shm
    family stays off and the socket path carries everything — knob
    drift across the pair is safe in both directions."""
    _cluster(completion_ring_enabled=False)
    try:
        w = _worker()

        @ray_tpu_torch.remote
        def f(x):
            return x * 11

        assert ray_tpu_torch.get([f.remote(i) for i in range(64)]) == [
            i * 11 for i in range(64)]
        time.sleep(0.3)
        assert w._comp_ring is None
        assert not w._comp_segments
    finally:
        ray_tpu_torch.shutdown()


# --------------------------------------------------------------------------
# Doorbell coalescing: append_batch publishes a whole flush
# batch with ONE tail store and AT MOST ONE bell write, vs one bell per
# record on the per-append path while the consumer is parked.


def _raw_ring(cr, tmp_path, capacity=1 << 16):
    path = str(tmp_path / "ring")
    cons = cr.RingConsumer(path, capacity=capacity)
    prod = cr.RingProducer(path)
    prod.connect_bell()
    return cons, prod


def _count_bells(prod):
    bells = {"n": 0}
    orig = prod._ring_bell

    def counting():
        bells["n"] += 1
        orig()

    prod._ring_bell = counting
    return bells


def _both(check, tmp_path):
    """``check(completion_ring, dir)`` on the reference's ring, then on the
    port's, each in a directory of its own; the results must be equal."""
    import importlib

    out = []
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        out.append(check(importlib.import_module(
            f"{pkg}._private.completion_ring"), d))
    assert out[1] == out[0], out
    return out[1]


def test_batch_flush_rings_at_most_one_bell(tmp_path):
    """64 records through append_batch while the consumer is parked:
    exactly ONE bell write for the whole flush, every record published and
    drainable — versus the per-append path, which (shallow backlog) rings
    once per record."""
    blobs = [b"r%03d" % i for i in range(64)]

    def check(cr, d):
        cons, prod = _raw_ring(cr, d)
        try:
            cons.set_parked(True)
            bells = _count_bells(prod)
            n = prod.append_batch(blobs)
            batch_bells = bells["n"]
            got, new_head = cons.drain(max_records=128)
            cons.commit(new_head)
            # The one datagram actually landed on the consumer's bell
            # socket: the wakeup was sent, not just counted.
            cons._bell.settimeout(1.0)
            datagram = cons._bell.recv(64)
            # Contrast: the same 64 records via per-record append ring 64
            # bells (backlog stays shallow, so no rate limit applies).
            bells["n"] = 0
            appended = all(prod.append(b) for b in blobs)
            got2, new_head = cons.drain(max_records=128)
            cons.commit(new_head)
            return (n, batch_bells, got == blobs, datagram, appended,
                    bells["n"], got2 == blobs)
        finally:
            prod.close()
            cons.close()

    assert _both(check, tmp_path) == (64, 1, True, b"!", True, 64, True)


def test_batch_flush_unparked_consumer_no_bell(tmp_path):
    """An actively-draining (unparked) consumer costs a batch append zero
    bell writes — pure memcpy plus one tail publish."""
    def check(cr, d):
        cons, prod = _raw_ring(cr, d)
        try:
            bells = _count_bells(prod)
            n = prod.append_batch([b"a", b"b", b"c"])
            got, new_head = cons.drain()
            cons.commit(new_head)
            return n, bells["n"], got
        finally:
            prod.close()
            cons.close()

    assert _both(check, tmp_path) == (3, 0, [b"a", b"b", b"c"])


def test_batch_flush_no_lost_wakeup(tmp_path):
    """A consumer genuinely parked in park_wait() is woken by the one
    coalesced bell and drains the whole batch — coalescing must never
    strand records behind a missing wakeup."""
    blobs = [b"wake%02d" % i for i in range(16)]

    def check(cr, d):
        cons, prod = _raw_ring(cr, d)
        drained: list = []
        woke = threading.Event()

        def consumer_loop():
            while not cons.stopped:
                got, new_head = cons.drain()
                if got:
                    drained.extend(got)
                    cons.commit(new_head)
                    woke.set()
                    return
                cons.park_wait()

        t = threading.Thread(target=consumer_loop, daemon=True)
        try:
            t.start()
            # Wait until the consumer is actually parked (flag visible)
            # before appending, so the bell is load-bearing for the wakeup.
            deadline = time.time() + 5
            while not cons._get(32) and time.time() < deadline:
                time.sleep(0.001)
            bells = _count_bells(prod)
            n = prod.append_batch(blobs)
            return (n, bells["n"] <= 1, woke.wait(timeout=5),
                    drained == blobs)
        finally:
            cons.stopped = True
            t.join(timeout=5)
            prod.close()
            cons.close()

    n, one_bell, woke, all_drained = _both(check, tmp_path)
    assert n == 16 and one_bell
    assert woke, "parked consumer never woke"
    assert all_drained


def test_batch_flush_partial_on_full_ring(tmp_path):
    """A batch that overflows the ring publishes its leading records (short
    count back to the caller for socket fallback) and still rings at most
    one bell; records never tear."""
    blobs = [b"x" * 60 for _ in range(8)]   # 64 B/record: 4 fit

    def check(cr, d):
        cons, prod = _raw_ring(cr, d, capacity=256)
        try:
            cons.set_parked(True)
            bells = _count_bells(prod)
            appended = prod.append_batch(blobs)
            batch_bells = bells["n"]
            got, new_head = cons.drain()
            cons.commit(new_head)
            # Drained ring takes the remainder; a fresh batch on an empty
            # ring appends fully.
            rest = prod.append_batch(blobs[appended:])
            return (appended, batch_bells, got == blobs[:appended],
                    rest == 8 - appended)
        finally:
            prod.close()
            cons.close()

    appended, bells, head_right, rest_right = _both(check, tmp_path)
    assert 0 < appended < 8
    assert bells == 1
    assert head_right and rest_right


def test_mirrors_every_reference_test():
    assert_mirrored("completion_fastpath")
