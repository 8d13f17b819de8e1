"""The port's repairs found by its observability twins
(``test_torch_{tracing,profiler,observability_agent}.py``), ROADMAP §3.

1. The store group's collective ops and the device-object hops emitted no
spans on the port: ``collective_ops_emit_spans_under_task`` and
``serve_device_object_round_trip_single_trace`` held the reference's
spans against none. ``StoreGroup._exchange``, ``send`` and ``recv`` now
run under a ``collective`` span, and a staged tensor (``device_put``), a
rebuilt one and a by-reference hit (``device_get``) emit theirs inside a
running trace, as the reference's do. The twins hold both.

2. A deployment's replica set grew past its target: ``deploy`` and the
controller's reconcile loop both ran ``_scale_to_target``, each read the
same deficit before either's spawn was in the set, and both filled it;
the next tick drained and killed the extra replica, and a request it
had served lost the spans it had not flushed yet
(``errored_serve_round_trip_keeps_all_spans`` failed so). The reference's
controller keeps the race. The port's claims a spawn in flight
(``_DeploymentState.spawning``) under the controller's lock.

3. The port's gang supervisor poisoned its group without asking the
nodes to dump their flight recorders, so a gang death left no dump
(``flight_recorder_dump_on_gang_death``). ``WorkerGroup.poison`` now
sends the GCS ``flight_dump``, as the reference's supervisor does, through
``runtime_gcs``: the port's own worker, or the runtime's loaded one.
"""

import threading
import time


def test_deploy_and_reconcile_fill_one_deficit_once(monkeypatch):
    import ray_tpu_torch
    from ray_tpu_torch.serve import controller as ctl

    spawned = []

    class _Replica:
        def options(self, **kw):
            return self

        def remote(self, *args, **kwargs):
            time.sleep(0.3)   # an actor creation still in flight
            handle = object()
            spawned.append(handle)
            return handle

    monkeypatch.setattr(ray_tpu_torch, "remote", lambda cls: _Replica())
    c = ctl.ServeController.__new__(ctl.ServeController)
    c._lock = threading.RLock()
    c._replacing = {}
    c._versions = {}
    c._change_cv = threading.Condition()
    drained = []
    c._begin_drain = lambda name, replicas: drained.extend(replicas)
    st = ctl._DeploymentState({"name": "d", "num_replicas": 1}, b"", (), {})
    scalers = [threading.Thread(target=c._scale_to_target, args=("d", st))
               for _ in range(2)]   # deploy() and one reconcile tick
    for t in scalers:
        t.start()
    for t in scalers:
        t.join(timeout=10)
    assert len(spawned) == 1, f"{len(spawned)} replicas for a target of 1"
    assert st.replicas == spawned and not drained
    assert st.spawning == 0
