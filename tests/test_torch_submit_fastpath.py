"""``tests/test_submit_fastpath.py`` on the port's runtime, test by test.

The checks of pure modules (the spec template, the protocol's framing,
the refcount batching) run on both packages in this process, and each
package's results must be equal and pass the reference's assertions. The
two tests whose result is a value run as programs of
``torch_fastpath_programs``' "submit_tests" group on both runtimes, each
on the 2-CPU cluster of the reference's fixture. The tests that read the
driver's lease manager, its submit ring, the node manager's ring drains
or the GCS's queues run on the port alone, translated name for name.
"""

import importlib
import os
import pickle
import threading
import time

import pytest

import torch_fastpath_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mods(pkg):
    def m(name):
        return importlib.import_module(f"{pkg}._private.{name}")
    return m("spec_template"), m("ids"), m("task_spec")


def _both(check):
    """``check(spec_template, ids, task_spec)`` on the reference's
    modules, then on the port's; the two results must be equal."""
    ref, port = (check(*_mods(p)) for p in PACKAGES)
    assert port == ref, (port, ref)
    return port


# ----------------------------------------------------------- template unit

def _const(job, **over):
    base = dict(job_id=job, function_key="fn:0123456789abcdef", arg_deps=[],
                num_returns=1, resources={"CPU": 1.0}, name="nop",
                max_retries=3, retries_left=0, caller_id="client-1",
                owner_node="node-1", scheduling_strategy=None,
                placement_group_id=None, placement_group_bundle_index=-1,
                runtime_env=None, donate_result=False, trace_ctx=None)
    base.update(over)
    return base


def _field_combos(ids):
    return [
        {},
        {"num_returns": 0},
        {"num_returns": 3},
        {"num_returns": "dynamic"},
        {"resources": {"CPU": 2.0, "impossible": 1.0, "memory": 1e9}},
        {"name": ""},
        {"name": "a-much-longer-task-name-" * 8},
        {"max_retries": 0},
        {"donate_result": True},
        {"scheduling_strategy": "SPREAD"},
        {"placement_group_id": ids.PlacementGroupID.of(ids.JobID.from_int(7)),
         "placement_group_bundle_index": 2},
        {"caller_id": "", "owner_node": None},
    ]


N_COMBOS = 12
ARGS_VALUES = [b"", b"x" * 10, b"y" * 255, b"z" * 256, os.urandom(4096)]


@pytest.mark.parametrize("combo", range(N_COMBOS))
def test_template_byte_equal_field_matrix(combo):
    """Template-patched bytes must equal pickle.dumps of an equivalently
    constructed spec, for every field combination and args sizes spanning
    the SHORT_BINBYTES/BINBYTES opcode boundary."""
    def check(st, ids, ts):
        combos = _field_combos(ids)
        assert len(combos) == N_COMBOS
        job = ids.JobID.from_int(3)
        const = _const(job, **combos[combo])
        tpl = st.build(const)
        out = [tpl is not None]
        for args in ARGS_VALUES:
            tid = ids.TaskID.for_task(job)
            t = time.time()
            accepts = tpl.accepts(args, [], None)
            spec = tpl.make(tid, args, t)
            fresh = ts.TaskSpec(task_id=tid, args=args, submitted_at=t,
                                **const)
            want = pickle.dumps(fresh, protocol=5)
            wire = st.spec_wire(spec)
            back = pickle.loads(wire)
            out.append((accepts, wire == want,
                        [f for f in ts.TaskSpec._STATE_FIELDS
                         if getattr(back, f) != getattr(fresh, f)]))
        return out

    got = _both(check)
    assert got[0] is True
    assert all(g == (True, True, []) for g in got[1:]), got


def test_template_declines_out_of_domain():
    def check(st, ids, ts):
        job = ids.JobID.from_int(3)
        tpl = st.build(_const(job))
        return (tpl is not None,
                tpl.accepts(b"", [ids.ObjectID.for_return(
                    ids.TaskID.for_task(job), 0)], None),
                tpl.accepts(b"", [], {"trace_id": 1, "parent_span_id": 2}),
                tpl.accepts(("ref", b"\x00" * 28), [], None),
                tpl.accepts(b"b" * (64 * 1024), [], None))

    # Dep-carrying, traced, spilled-args, and frame-breaking calls all
    # decline (classic construction covers them).
    assert _both(check) == (True, False, False, False, False)


def test_template_verify_mode_catches_drift():
    """submit_template_verify re-checks every patched blob against a fresh
    pickle; a template whose frozen constants no longer match must raise,
    not ship wrong bytes."""
    def check(st, ids, ts):
        job = ids.JobID.from_int(3)
        tpl = st.build(_const(job))
        tpl.set_verify(True)
        tpl.make(ids.TaskID.for_task(job), b"ok", time.time())  # passes
        tpl._const["name"] = "drifted"   # simulate constant drift
        with pytest.raises(AssertionError):
            tpl.make(ids.TaskID.for_task(job), b"ok", time.time())
        return True

    assert _both(check) is True


def test_wire_cache_invalidation():
    def check(st, ids, ts):
        job = ids.JobID.from_int(3)
        tpl = st.build(_const(job))
        spec = tpl.make(ids.TaskID.for_task(job), b"", time.time())
        cached = spec.__dict__.get("_wire") is not None
        spec.max_retries = 1   # retry-path mutation
        st.invalidate_wire(spec)
        return (cached, spec.__dict__.get("_wire") is None,
                # spec_wire now re-pickles the mutated spec.
                pickle.loads(st.spec_wire(spec)).max_retries)

    assert _both(check) == (True, True, 1)


# -------------------------------------------------------- protocol framing

def test_notify_carries_no_msg_id_and_batches_deliver_in_order():
    """Notifies skip id allocation (msg_id 0 on the wire) and a burst of
    queued frames drains through the gathered write in order."""
    def check(protocol):
        got = []
        ev = threading.Event()

        def handler(conn, mtype, payload, msg_id):
            got.append((mtype, payload, msg_id))
            if len(got) >= 201:
                ev.set()

        srv = protocol.Server(handler, name="t-batch")
        conn = protocol.connect(srv.address, name="t-batch-c")
        try:
            for i in range(200):
                conn.notify("n", i)
            # A request after the burst: replies still match their future.
            conn.request_nowait("n", "last")
            woke = ev.wait(10)
            fut2 = conn.request_nowait("n", None)
            return (woke, [p for _m, p, _i in got[:201]],
                    all(i == 0 for _m, _p, i in got[:200]),
                    fut2.msg_id != 0)
        finally:
            conn.close()
            srv.close()

    ref, port = (check(importlib.import_module(f"{p}._private.protocol"))
                 for p in PACKAGES)
    assert port == ref
    assert port == (True, list(range(200)) + ["last"], True, True)


# ------------------------------------------------------------ cluster glue

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "submit_tests", tmp_path_factory)


@pytest.fixture
def cluster():
    import ray_tpu_torch

    ctx = ray_tpu_torch.init(num_cpus=2,
                             object_store_memory=128 * 1024 * 1024)
    yield ctx
    ray_tpu_torch.shutdown()


def _worker():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.global_worker()


def _gcs():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod._global_cluster.gcs


def _nm():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod._global_cluster.nm


def _exported_spec(w, fn_key, name, max_retries=0, resources=None):
    from ray_tpu_torch._private.ids import TaskID
    from ray_tpu_torch._private.task_spec import TaskSpec

    args_blob, _deps = w._serialize_args((), {})
    return TaskSpec(
        task_id=TaskID.for_task(w.job_id), job_id=w.job_id,
        function_key=fn_key, args=args_blob, arg_deps=[], num_returns=1,
        resources=resources or {"CPU": 1.0}, name=name,
        max_retries=max_retries, caller_id=w.client_id,
        owner_node=w.node_id)


def _export(w, fn):
    from ray_tpu_torch._private import pickler

    return w.export_function(pickler.dumps(fn))


def test_remote_uses_template_and_matches_classic(results):
    """The RemoteFunction holder builds a template on first eligible call,
    and results are identical with the template path off."""
    on, built, off = same_result(
        results, "remote_uses_template_and_matches_classic")
    assert on == off == [2 * i for i in range(20)]
    assert built is True


def test_gcs_batch_preserves_fifo_vs_single_frames(cluster):
    """Interleaved single-spec and batch frames on one conn land in the GCS
    shape queue in exact submission order."""
    from ray_tpu_torch._private import protocol

    w = _worker()
    gcs = _gcs()
    shape = {"CPU": 1.0, "impossible": 1.0}
    order = []
    conn = protocol.connect(w.gcs_address, name="t-fifo")
    try:
        for i in range(30):
            spec = _exported_spec(w, "fk", f"t{i}", resources=shape)
            order.append(f"t{i}")
            if i % 3 == 0:
                conn.notify("submit_task", spec)
            else:
                conn.notify("submit_task_batch",
                            [pickle.dumps(spec, protocol=5)])
        deadline = time.time() + 15
        while time.time() < deadline:
            names = [s.name for _k, q in gcs._queued_tasks.buckets()
                     for s in q if s.name.startswith("t")]
            if len(names) >= 30:
                break
            time.sleep(0.05)
        assert names == order
    finally:
        conn.close()


def test_gcs_batch_dedups_on_task_id(cluster):
    """At-least-once ring delivery: a spec arriving twice through the batch
    handler is enqueued once."""
    from ray_tpu_torch._private import protocol

    w = _worker()
    gcs = _gcs()
    spec = _exported_spec(w, "fk", "dup-probe",
                          resources={"CPU": 1.0, "impossible": 1.0})
    blob = pickle.dumps(spec, protocol=5)
    conn = protocol.connect(w.gcs_address, name="t-dedup")
    try:
        conn.notify("submit_task_batch", [blob])
        conn.notify("submit_task_batch", [blob])
        deadline = time.time() + 10
        count = 0
        while time.time() < deadline:
            count = sum(1 for _k, q in gcs._queued_tasks.buckets()
                        for s in q if s.name == "dup-probe")
            if count:
                time.sleep(0.5)   # let a duplicate land if it would
                count = sum(1 for _k, q in gcs._queued_tasks.buckets()
                            for s in q if s.name == "dup-probe")
                break
            time.sleep(0.05)
        assert count == 1
    finally:
        conn.close()


def test_lease_death_mid_batch_fails_exactly_that_batch(cluster, tmp_path):
    """A transport failure on a batch send fails the specs of THAT batch
    only: zero-retry specs materialize WorkerCrashedError, specs with
    budget fall back and run EXACTLY once, and queued-but-unsent specs are
    not stranded."""
    import ray_tpu_torch
    from ray_tpu_torch import exceptions as exc
    from ray_tpu_torch._private import lease as lease_mod
    from ray_tpu_torch._private import protocol
    from ray_tpu_torch._private.worker import ObjectRef

    w = _worker()
    lm = w._lease_mgr
    marker = str(tmp_path / "runs.txt")

    def tracked(marker=marker):
        with open(marker, "a") as f:
            f.write("ran\n")
        return 99

    fn_key = _export(w, tracked)

    class BoomConn:
        closed = False

        def notify(self, *a, **k):
            raise protocol.ConnectionClosed()

        def close(self):
            pass

    key = (("CPU", 1.0),)
    lease = lease_mod._Lease(b"lid-t", b"wid-t", BoomConn(), w.node_id,
                             None, key, local=True)
    doomed = [_exported_spec(w, fn_key, "doomed-0"),
              _exported_spec(w, fn_key, "doomed-1")]
    retryable = _exported_spec(w, fn_key, "retry-1", max_retries=1)
    queued = _exported_spec(w, fn_key, "queued-1")
    with lm._lock:
        st = lm._shapes.get(key)
        if st is None:
            st = lm._shapes[key] = lease_mod._ShapeState()
        st.leases.append(lease)
        for s in doomed + [retryable]:
            lm._reserve_locked(lease, s)
        st.queue.append(queued)
    lm._send(lease, doomed + [retryable])

    # Zero-retry specs fail with WorkerCrashedError, not re-execution.
    for s in doomed:
        ref = ObjectRef(s.return_ids()[0])
        with pytest.raises(exc.WorkerCrashedError):
            ray_tpu_torch.get(ref, timeout=30)
    # The budgeted spec and the queued spec run exactly once each.
    assert ray_tpu_torch.get(ObjectRef(retryable.return_ids()[0]),
                             timeout=30) == 99
    assert ray_tpu_torch.get(ObjectRef(queued.return_ids()[0]),
                             timeout=30) == 99
    with open(marker) as f:
        assert len(f.read().splitlines()) == 2


# ------------------------------------------------------------- submit ring

def _force_ring(lm, timeout=10.0):
    lm.submit_classic(_exported_spec(
        _worker(), "fk", "ring-warm",
        resources={"CPU": 1.0, "impossible": 1.0}))
    deadline = time.time() + timeout
    while time.time() < deadline and lm._ring_state in (0, 1):
        time.sleep(0.05)
    return lm._ring


def test_ring_submitted_specs_execute_identically(cluster):
    """Specs shipped through the shm ring run to the same results as
    socket-submitted ones (and with the ring off, the same entry point uses
    the socket batch path)."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import ObjectRef

    w = _worker()
    lm = w._lease_mgr

    def triple(x=3):
        return 3 * x

    fn_key = _export(w, triple)
    ring = _force_ring(lm)
    assert ring is not None and ring.active
    tail0 = ring._tail
    specs = [_exported_spec(w, fn_key, f"ring-{i}") for i in range(8)]
    for s in specs:
        assert lm.submit_classic(s)
    assert ring._tail > tail0   # they really rode the ring
    got = ray_tpu_torch.get([ObjectRef(s.return_ids()[0]) for s in specs],
                            timeout=60)
    assert got == [9] * 8

    # Off-toggle: same entry point, socket path, same results.
    ring_enabled = lm._ring_enabled
    lm._ring_enabled = False
    try:
        tail_before = ring._tail
        specs2 = [_exported_spec(w, fn_key, f"sock-{i}") for i in range(4)]
        for s in specs2:
            assert lm.submit_classic(s)
        lm.flush_sends()
        got2 = ray_tpu_torch.get(
            [ObjectRef(s.return_ids()[0]) for s in specs2], timeout=60)
        assert got2 == [9] * 4
        assert ring._tail == tail_before  # untouched by the off path
    finally:
        lm._ring_enabled = ring_enabled


def test_ring_full_falls_back_to_socket(cluster):
    """Appends beyond capacity decline; the submission still lands via the
    socket batch path and the ring-full counter moves."""
    import ray_tpu_torch
    from ray_tpu_torch._private import lease as lease_mod
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch._private.worker import ObjectRef

    w = _worker()
    lm = w._lease_mgr
    old_bytes = config.submit_ring_bytes
    config.set("submit_ring_bytes", 16384)   # tiny: fills in ~80 records
    try:
        ring = _force_ring(lm)
        assert ring is not None

        def one():
            return 1

        fn_key = _export(w, one)
        # Stop the NM's drain thread so the ring can actually fill.
        nm = _nm()
        ents = [e for ents in nm._submit_rings.values() for e in ents]
        assert ents
        for e in ents:
            e["stop"] = True
        time.sleep(0.3)
        m = lease_mod._submit_metrics_get()
        full_before = sum(v for _n, _t, v in m[2].samples())
        # Fill with VALID spec blobs (one identity: the GCS dedups the
        # eventual recovery resubmission down to a single enqueue).
        filler = pickle.dumps(_exported_spec(
            w, "fk", "filler",
            resources={"CPU": 1.0, "impossible": 1.0}), protocol=5)
        n_fit = 0
        while ring.append(filler):
            n_fit += 1
            assert n_fit < 100_000
        assert n_fit > 0
        # Ring full: a real submission falls back to the socket path.
        spec = _exported_spec(w, fn_key, "spilled")
        assert lm.submit_classic(spec)
        lm.flush_sends()
        assert ray_tpu_torch.get(ObjectRef(spec.return_ids()[0]),
                                 timeout=60) == 1
        full_after = sum(v for _n, _t, v in m[2].samples())
        assert full_after >= full_before + 1
    finally:
        config.set("submit_ring_bytes", old_bytes)


def test_ring_consumer_death_recovers_unconsumed(cluster):
    """NM-side drain death: the driver notices the stale heartbeat,
    recovers unconsumed records, and resubmits them over the socket — the
    tasks still run."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import ObjectRef

    w = _worker()
    lm = w._lease_mgr
    ring = _force_ring(lm)
    assert ring is not None

    def four():
        return 4

    fn_key = _export(w, four)
    nm = _nm()
    ents = [e for ents in nm._submit_rings.values() for e in ents]
    assert ents
    for e in ents:
        e["stop"] = True
    time.sleep(0.3)
    specs = [_exported_spec(w, fn_key, f"orphan-{i}") for i in range(5)]
    for s in specs:
        assert lm.submit_classic(s)
    assert ring._tail > 0
    # The flush loop detects the stale consumer within ~_RING_STALE_S and
    # resubmits; the records then execute.
    got = ray_tpu_torch.get([ObjectRef(s.return_ids()[0]) for s in specs],
                            timeout=60)
    assert got == [4] * 5
    assert lm._ring is None and lm._ring_state == 3


def test_ring_disabled_never_registers(cluster):
    lm = _worker()._lease_mgr
    old = lm._ring_enabled
    lm._ring_enabled = False
    try:
        lm.submit_classic(_exported_spec(
            _worker(), "fk", "noring",
            resources={"CPU": 1.0, "impossible": 1.0}))
        time.sleep(0.2)
        assert lm._ring is None
    finally:
        lm._ring_enabled = old


def test_closure_captured_remote_function_after_template_build(results):
    """A RemoteFunction whose template is already BUILT (holder referencing
    this process's CoreWorker) must still pickle into a worker via closure
    capture — the holder ships fresh."""
    first, built, nested = same_result(
        results, "closure_captured_remote_function_after_template_build")
    assert first == [0, 2, 4, 6]
    assert built is True
    assert nested == 11


# ------------------------------------------------------- refcount batching

def test_incref_many_batches_under_one_lock():
    def check(pkg):
        worker_mod = importlib.import_module(f"{pkg}._private.worker")

        class _StubGcs:
            def __init__(self):
                self.sent = []

            def notify(self, mtype, payload):
                self.sent.append((mtype, payload))

        class _StubWorker:
            client_id = "stub"

            def __init__(self):
                self.gcs = _StubGcs()

        tr = worker_mod._RefTracker(_StubWorker())
        try:
            tr.incref_many([b"a", b"a", b"b"])
            tr.decref_many([b"b", b"c"])
            tr.flush()
            merged, verbs = {}, set()
            for mtype, payload in tr._worker.gcs.sent:
                verbs.add(mtype)
                for oid, d in payload["deltas"].items():
                    merged[oid] = merged.get(oid, 0) + d
            return (sorted(verbs), merged,
                    not tr._inc_log and not tr._dec_log)
        finally:
            tr.stop()

    ref, port = (check(p) for p in PACKAGES)
    assert port == ref
    # Net-zero deltas still ship (they create the GCS count entry).
    assert port == (["update_refcounts"], {b"a": 2, b"b": 0, b"c": -1},
                    True)


def test_mirrors_every_reference_test():
    assert_mirrored("submit_fastpath")
