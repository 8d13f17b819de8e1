"""The port's static<->runtime lock-graph reconciliation (the port's twin
of ``tests/test_lockgraph_reconcile.py``).

The port's raylint (``--emit-lock-graph``) models its lock-order graph
from source; the port's lockdep (``RAY_TPU_TORCH_LOCKDEP_ENABLED=1``)
records the edges that actually ran. Every runtime edge whose endpoints
the static registry knows must be in the static graph: a missing edge is
a blind spot of the static pass. The inverse is not asserted (the static
graph holds edges no one run takes).

The witness must wrap every lock of the package from its creation, so
the workload runs in a fresh interpreter with the variable set before
``ray_tpu_torch`` is imported. The driver holds the GCS and the node
manager, the lock-heavy part of the runtime.
"""

import json
import os
import pathlib
import subprocess
import sys

from ray_tpu_torch._private.lint import core
from ray_tpu_torch._private.lint.callgraph import emit_lock_graph

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (outer lid, inner lid) pairs the static pass cannot see, as in the
# reference: lazy_metrics' closure guard held across factory()
# registering metrics under the registry lock.
KNOWN_BLIND_SPOTS = {
    ("ray_tpu_torch.util.metrics.lock",
     "ray_tpu_torch.util.metrics._registry_lock"),
}

_WORKLOAD = """
import json, sys
import ray_tpu_torch as rt
from ray_tpu_torch._private import lockdep

assert lockdep.installed()
lockdep.reset()


def square(x):
    return x * x


class Counter:
    def __init__(self):
        self.n = 0

    def add(self, k):
        self.n += k
        return self.n


rt.init(num_cpus=4)
try:
    sq = rt.remote(square)
    assert rt.get([sq.remote(i) for i in range(8)], timeout=60) == \\
        [i * i for i in range(8)]
    c = rt.remote(Counter).remote()
    outs = [c.add.remote(1) for _ in range(4)]
    assert rt.get(outs[-1], timeout=60) == 4
    assert rt.get(rt.put(list(range(32))), timeout=60)[-1] == 31
finally:
    rt.shutdown()
witnessed = lockdep.witnessed_graph()
violations = [str(v) for v in lockdep.take_violations()]
with open(sys.argv[1], "w") as f:
    json.dump({"witnessed": witnessed, "violations": violations}, f)
"""


def _static_graph():
    return emit_lock_graph(core.Project(core.collect_sources()))


def test_runtime_edges_subset_of_static_graph(tmp_path):
    out = tmp_path / "witnessed.json"
    env = dict(os.environ, RAY_TPU_TORCH_LOCKDEP_ENABLED="1",
               OMP_NUM_THREADS="1")
    with open(tmp_path / "workload.log", "w") as log:
        rc = subprocess.run([sys.executable, "-c", _WORKLOAD, str(out)],
                            cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT, timeout=240).returncode
    assert rc == 0, (tmp_path / "workload.log").read_text()[-3000:]
    run = json.loads(out.read_text())
    assert not run["violations"], run["violations"]
    witnessed = run["witnessed"]
    assert witnessed, "workload drove the control plane; expected edges"

    static = _static_graph()
    site_to_lids = {}
    for lid, info in static["locks"].items():
        site_to_lids.setdefault(info["site"], set()).add(lid)
    static_edges = {(e["outer"], e["inner"]) for e in static["edges"]}

    missing = []
    mapped = 0
    for e in witnessed:
        outers = site_to_lids.get(e["held"], set())
        inners = site_to_lids.get(e["acquired"], set())
        if not outers or not inners:
            continue   # a lock the static registry does not model
        mapped += 1
        if all((lo, li) in KNOWN_BLIND_SPOTS
               for lo in outers for li in inners):
            continue
        if not any((lo, li) in static_edges
                   for lo in outers for li in inners):
            missing.append(
                f"runtime edge {e['held']} -> {e['acquired']} "
                f"(witnessed at {e['site']}) has no static counterpart")
    assert mapped, ("no runtime edge mapped onto the static registry: "
                    "the creation-site keys have drifted apart")
    assert not missing, "\n".join(missing)


def test_static_graph_covers_registry_locks():
    """The export is well formed: its edges name locks the registry
    knows (or site-scoped ``?ambiguous`` identities) and carry a witness
    chain."""
    static = _static_graph()
    assert static["version"] == 1
    known = set(static["locks"])
    for e in static["edges"]:
        for end in (e["outer"], e["inner"]):
            assert end in known or end.startswith("?"), e
        assert e["chain"], e
