"""Programs of the autoscaler, data and tune slice, run on either runtime.

Each program takes the runtime module (``ray_tpu`` or ``ray_tpu_torch``),
the name of its accelerator resource (``"TPU"`` for ``ray_tpu``, ``"GPU"``
for the port) and a scratch directory, and returns plain values that
compare with ``==``. The programs of a group run one after the other;
``run_group`` returns ``{name: ("ok", value)}`` or ``("error", text)``.

This module imports neither runtime at import time (the port's workers
import it by name, and must not load jax). ``python
tests/torch_cluster_programs.py GROUP DIR`` runs a group on ``ray_tpu``
and prints its results as a Python literal on the last line.
"""

from __future__ import annotations

import importlib
import os
import sys
import tempfile
import time
import traceback

import numpy as np

GROUPS = ("autoscaler", "data", "tune", "tune_search")
# The data and tune groups share one cluster of this size.
CLUSTER = dict(num_cpus=4, object_store_memory=128 * 1024 * 1024)
GET_TIMEOUT_S = 120
# One wait of the autoscaler's scale-up/down program: four of them fit in
# the group's deadline.
SCALE_WAIT_S = 60


def _sub(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _accel(accel, n):
    """The task/actor option that asks for ``n`` accelerators."""
    return {"num_tpus" if accel == "TPU" else "num_gpus": n}


def _plain(x):
    """numpy scalars and arrays as Python values, recursively."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _trainer_kw(rt):
    """The port's trainer runs on a runtime it is given, on the CPU here;
    the reference's always runs on ``ray_tpu``."""
    return {"runtime": rt, "device": "cpu"} if rt.__name__ == \
        "ray_tpu_torch" else {}


# ------------------------------------------------------------ autoscaler


def _cluster(rt, head=None, connect=True):
    cu = _sub(rt, "cluster_utils")
    c = cu.Cluster(initialize_head=True,
                   head_node_args=head or {"num_cpus": 1})
    if connect:
        c.connect(object_store_memory=64 * 1024 * 1024)
    return c


def _down(rt, c):
    rt.shutdown()
    c.shutdown()


def p_multinode_scheduling(rt, accel, tmp):
    """Tasks spill to a second node that has the resource they ask for."""
    c = _cluster(rt)
    try:
        c.add_node(num_cpus=2, resources={"special": 1.0})
        ready = c.wait_for_nodes()

        @rt.remote(resources={"special": 1.0})
        def where():
            return rt.get_runtime_context().get_node_id()

        node_id = rt.get(where.remote(), timeout=GET_TIMEOUT_S)
        return ready, node_id == c.nodes[1].node_id
    finally:
        _down(rt, c)


def p_remove_node_fails_tasks_over(rt, accel, tmp):
    c = _cluster(rt)
    try:
        node = c.add_node(num_cpus=2, resources={"doomed": 1.0})
        ready = c.wait_for_nodes()

        @rt.remote(resources={"doomed": 0.5}, max_retries=0)
        def stuck():
            time.sleep(60)

        ref = stuck.remote()
        time.sleep(1.0)
        c.remove_node(node)
        try:
            rt.get(ref, timeout=20)
            raised = False
        except Exception:
            raised = True
        return ready, raised
    finally:
        _down(rt, c)


def _scaler(rt, provider, **config):
    a = _sub(rt, "autoscaler")
    worker_mod = _sub(rt, "_private.worker")
    return a.StandardAutoscaler(worker_mod.require_worker().gcs, provider,
                                a.AutoscalerConfig(**config))


def p_autoscaler_scales_up_and_down(rt, accel, tmp):
    """A saturated head (1 CPU) scales out onto fake nodes; all tasks
    finish; idle nodes go after ``idle_timeout_s``.

    The tasks are ``SPREAD``, which the caller never leases: on the lease
    path the driver pipelines queued tasks onto its one leased worker,
    out of the GCS's pending demand, so how many nodes a reconcile asks
    for hung on when it ran (both runtimes; ROADMAP §3). Here every task
    the head cannot run waits in the GCS's queue until a node takes it,
    and the first reconcile waits until the demand shows all three."""
    a = _sub(rt, "autoscaler")
    c = _cluster(rt)
    try:
        provider = a.FakeMultiNodeProvider(c)
        scaler = _scaler(
            rt, provider,
            node_types=[a.NodeType("cpu_worker", {"CPU": 2.0},
                                   max_workers=3)],
            max_workers=3, idle_timeout_s=1.5)

        @rt.remote(num_cpus=1, scheduling_strategy="SPREAD")
        def hold(t):
            time.sleep(t)
            return 1

        refs = [hold.remote(3) for _ in range(4)]
        # Each wait ends when its condition holds, within ``SCALE_WAIT_S``.
        # A miss returns, in place of the value compared, what it saw and
        # how long it waited: the failing comparison names the window and
        # the runtime. The waits' times go to stderr either way.
        waits = {}
        launched = 0
        gcs = _sub(rt, "_private.worker").require_worker().gcs
        demand, waits["demand"] = _timed_wait(
            lambda: len(gcs.request("pending_demand")["tasks"]) >= 3)

        def reconcile():
            nonlocal launched
            launched += scaler.run_once()["launched"]
            return launched >= 2

        up, waits["launch"] = _timed_wait(reconcile)
        t0 = time.time()
        ready = c.wait_for_nodes(timeout=SCALE_WAIT_S)
        waits["ready"] = time.time() - t0
        t0 = time.time()
        results = rt.get(refs, timeout=SCALE_WAIT_S)
        waits["tasks"] = time.time() - t0

        def scaled_down():
            scaler.run_once()
            return not provider.non_terminated_nodes()

        _, waits["scale_down"] = _timed_wait(scaled_down)
        left = provider.non_terminated_nodes()
        print(f"p_autoscaler_scales_up_and_down on {rt.__name__}: "
              f"{launched} launched; waits (s) {waits}", file=sys.stderr)
        return ((up and demand) or ("demand shown", demand, "in",
                                    waits["demand"], "launched", launched,
                                    "in", waits["launch"]),
                ready or ("not ready in", waits["ready"]), results,
                left and (left, "left after", waits["scale_down"]))
    finally:
        _down(rt, c)


def _timed_wait(cond, timeout_s: float = SCALE_WAIT_S, every_s: float = 0.5):
    """Poll ``cond()`` until it is truthy or ``timeout_s`` ends: its last
    value and the seconds waited."""
    t0 = time.time()
    while True:
        got = cond()
        waited = time.time() - t0
        if got or waited > timeout_s:
            return got, waited
        time.sleep(every_s)


def p_autoscaler_respects_max_workers(rt, accel, tmp):
    a = _sub(rt, "autoscaler")
    c = _cluster(rt)
    try:
        provider = a.FakeMultiNodeProvider(c)
        scaler = _scaler(
            rt, provider,
            node_types=[a.NodeType("cpu_worker", {"CPU": 1.0},
                                   max_workers=2)],
            max_workers=2, idle_timeout_s=60)

        @rt.remote(num_cpus=1)
        def hold():
            time.sleep(2)

        _refs = [hold.remote() for _ in range(10)]
        time.sleep(0.5)
        scaler.run_once()
        scaler.run_once()
        return len(provider.non_terminated_nodes()) <= 2
    finally:
        _down(rt, c)


def p_min_workers_launched(rt, accel, tmp):
    a = _sub(rt, "autoscaler")
    c = _cluster(rt)
    try:
        provider = a.FakeMultiNodeProvider(c)
        scaler = _scaler(
            rt, provider,
            node_types=[a.NodeType("warm", {"CPU": 1.0}, min_workers=2,
                                   max_workers=4)],
            max_workers=4, idle_timeout_s=60)
        summary = scaler.run_once()
        return summary["launched"], len(provider.non_terminated_nodes())
    finally:
        _down(rt, c)


def p_pg_prefers_single_pool(rt, accel, tmp):
    """Accelerator placement groups pack onto one pool (slice): bundles do
    not straddle ``slice`` labels when one pool can host the gang."""
    c = _cluster(rt, connect=False)
    try:
        nodes = {}
        for sl in ("slice-a", "slice-b"):
            for _h in range(2):
                nm = c.add_node(num_cpus=2, labels={"slice": sl},
                                **_accel(accel, 4))
                nodes[nm.node_id] = sl
        c.connect(object_store_memory=64 * 1024 * 1024)
        c.wait_for_nodes()
        pg_mod = _sub(rt, "util.placement_group")
        pg = pg_mod.placement_group([{accel: 4, "CPU": 1}] * 2,
                                    strategy="STRICT_SPREAD")
        ready = pg.wait(timeout_seconds=30)
        table = _sub(rt, "_private.worker").require_worker().gcs.request(
            "pg_table", {})
        bundles = table[pg.id.binary()]["bundles"]
        return ready, len({nodes[b["node_id"]] for b in bundles})
    finally:
        _down(rt, c)


CLUSTER_YAML = """
cluster_name: t
max_workers: 3
idle_timeout_s: 300
update_interval_s: 0.2
provider:
  type: local_process
  object_store_memory: 67108864
head_node_type:
  CPU: 1
available_node_types:
  cpu_worker:
    resources: {CPU: 2}
    min_workers: 1
    max_workers: 3
"""


def p_launch_min_workers_and_autoscale(rt, accel, tmp):
    """The YAML launcher: min_workers start a node daemon process at
    once; demand beyond capacity scales up within max_workers."""
    cl = _sub(rt, "autoscaler.cluster_launcher")
    path = os.path.join(tmp, "cluster.yaml")
    with open(path, "w") as f:
        f.write(CLUSTER_YAML)
    launched = cl.launch_cluster(cl.load_cluster_config(path))
    try:
        rt.init(address=launched.address)
        deadline = time.time() + 60
        alive = 0
        while time.time() < deadline:
            alive = sum(1 for n in rt.nodes() if n["Alive"])
            if alive >= 2:
                break
            time.sleep(0.2)

        @rt.remote(num_cpus=2)
        def hold():
            time.sleep(2)
            return 1

        out = rt.get([hold.remote() for _ in range(4)],
                     timeout=GET_TIMEOUT_S)
        return (alive >= 2, out,
                len(launched.provider.non_terminated_nodes()) >= 2)
    finally:
        rt.shutdown()
        launched.shutdown()


def p_bad_yaml_rejected(rt, accel, tmp):
    cl = _sub(rt, "autoscaler.cluster_launcher")
    path = os.path.join(tmp, "bad.yaml")
    with open(path, "w") as f:
        f.write("cluster_name: x\n")
    try:
        cl.load_cluster_config(path)
    except ValueError:
        return "ValueError"
    return "accepted"


def _pool_cloud(rt, accel, cluster, capacity):
    """The queued-resources cloud and provider of the runtime: TPU slices
    in the reference, GPU host pools in the port."""
    a = _sub(rt, "autoscaler")
    if accel == "TPU":
        cloud = a.FakeTpuCloud(cluster, capacity_slices=capacity)
        return cloud, a.TpuPodProvider(cloud)
    cloud = a.FakeGpuCloud(cluster, capacity_pools=capacity)
    return cloud, a.GpuPoolProvider(cloud)


def p_pool_fifo_granting(rt, accel, tmp):
    """Requests beyond the cloud's capacity queue and are granted FIFO as
    capacity frees; pending requests count as non-terminated."""
    c = _cluster(rt, head={"num_cpus": 2, **_accel(accel, 0)})
    try:
        cloud, provider = _pool_cloud(rt, accel, c, 1)
        shape = {"CPU": 2.0, accel: 4.0, "hosts": 1}
        first = provider.create_node("pool", shape, 1)[0]
        second = provider.create_node("pool", shape, 1)[0]
        listing = cloud.list_queued_resources()
        states = [listing[first]["state"], listing[second]["state"]]
        both = set(provider.non_terminated_nodes()) == {first, second}
        provider.terminate_node(first)
        states.append(cloud.list_queued_resources()[second]["state"])
        provider.terminate_node(second)
        return states, both, provider.non_terminated_nodes()
    finally:
        _down(rt, c)


def p_two_pool_scale_up_and_down(rt, accel, tmp):
    """Gang demand for two pools' worth of accelerators scales up two
    pools, whose hosts register with their pool's ``slice`` label; a task
    on each sees its own accelerator; idle pools go pool-atomically and
    the cluster's accelerators return to 0."""
    c = _cluster(rt, head={"num_cpus": 2, **_accel(accel, 0)})
    try:
        a = _sub(rt, "autoscaler")
        cloud, provider = _pool_cloud(rt, accel, c, 2)
        scaler = _scaler(
            rt, provider,
            node_types=[a.NodeType("pool", {"CPU": 4.0, accel: 8.0,
                                            "hosts": 2}, max_workers=4)],
            max_workers=4, idle_timeout_s=2.0)
        pg_mod = _sub(rt, "util.placement_group")
        pg = pg_mod.placement_group([{accel: 4.0} for _ in range(4)],
                                    strategy="SPREAD")
        summary = scaler.run_once()
        ready = pg.wait(timeout_seconds=60)
        slices = {n["Labels"].get("slice") for n in rt.nodes()
                  if n["Alive"] and n["Labels"].get("slice")}
        total = rt.cluster_resources().get(accel, 0)
        pg_mod.remove_placement_group(pg)
        var = "TPU_VISIBLE_CHIPS" if accel == "TPU" else \
            "CUDA_VISIBLE_DEVICES"

        @rt.remote(**_accel(accel, 1))
        def visible():
            return os.environ.get(var, "?")

        seen = rt.get([visible.remote() for _ in range(2)],
                      timeout=GET_TIMEOUT_S)
        deadline = time.time() + 45
        while time.time() < deadline:
            scaler.run_once()
            if not provider.non_terminated_nodes():
                break
            time.sleep(0.5)
        deadline = time.time() + 15
        while time.time() < deadline and \
                rt.cluster_resources().get(accel, 0):
            time.sleep(0.2)
        return (summary["launched"], ready, len(slices), total,
                [len(s.split(",")) for s in seen],
                provider.non_terminated_nodes(),
                rt.cluster_resources().get(accel, 0.0))
    finally:
        _down(rt, c)


class _Clock:
    """A clock the program steps by hand, for the autoscaler's idle and
    boot-grace judgements."""

    def __init__(self):
        self.now = time.time()

    def time(self):
        return self.now


def p_local_node_busy_past_boot_grace(rt, accel, tmp):
    """A node daemon process that registered and runs a task past
    ``boot_grace_s`` stays up until the task ends; idle, it goes after
    ``idle_timeout_s``, and exactly one node was launched. The autoscaler's
    clock is stepped by hand, so how long the daemon takes to boot (slow
    on a loaded machine) does not count."""
    a = _sub(rt, "autoscaler")
    amod = _sub(rt, "autoscaler.autoscaler")
    lp = _sub(rt, "autoscaler.local_provider")
    c = _cluster(rt)
    provider = lp.LocalProcessNodeProvider(
        c.address, {"object_store_memory": 64 * 1024 * 1024})
    clock = amod.time = _Clock()
    started = os.path.join(tmp, "started")
    release = os.path.join(tmp, "release")
    try:
        scaler = _scaler(
            rt, provider,
            node_types=[a.NodeType("worker", {"CPU": 1.0, "special": 1.0},
                                   max_workers=1)],
            max_workers=1, idle_timeout_s=1.0, boot_grace_s=3.0)

        @rt.remote(resources={"special": 1.0}, max_retries=0)
        def busy():
            open(started, "w").close()
            deadline = time.time() + GET_TIMEOUT_S
            while not os.path.exists(release) and time.time() < deadline:
                time.sleep(0.05)
            return rt.get_runtime_context().get_node_id()

        ref = busy.remote()
        launched = terminated = 0
        deadline = time.time() + GET_TIMEOUT_S
        while not os.path.exists(started) and time.time() < deadline:
            s = scaler.run_once()
            launched += s["launched"]
            terminated += s["terminated"]
            time.sleep(0.2)
        # Busy well past the boot grace: the node must stay.
        clock.now += 10 * scaler.config.boot_grace_s
        for _ in range(3):
            s = scaler.run_once()
            launched += s["launched"]
            terminated += s["terminated"]
        busy_terminations = terminated
        open(release, "w").close()
        try:
            ran = rt.get(ref, timeout=30) != c.nodes[0].node_id
        except Exception as e:
            ran = f"failed: {type(e).__name__}"
        deadline = time.time() + 30
        while time.time() < deadline and provider.non_terminated_nodes():
            s = scaler.run_once()
            launched += s["launched"]
            terminated += s["terminated"]
            clock.now += 0.5
            time.sleep(0.1)
        return (ran, launched, busy_terminations, terminated,
                provider.non_terminated_nodes())
    finally:
        amod.time = time
        provider.shutdown()
        _down(rt, c)


# ------------------------------------------------------------------ data


def d_range_and_transforms(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.range(100, parallelism=4)
    out = ds.map(lambda x: x * 2).filter(lambda x: x % 10 == 0).take_all()
    return ds.count(), ds.num_blocks(), out


def d_flat_map_and_fusion(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.range(10, parallelism=2).flat_map(lambda x: [x, x])
    ds2 = ds.map(lambda x: x + 1).filter(lambda x: x % 2 == 0)
    return ds.count(), len(ds2._execute()), ds2.take_all()


def d_map_batches_numpy(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.from_items([{"x": i, "y": i * 2} for i in range(32)],
                       parallelism=4)

    def double(batch):
        return {"x": batch["x"] * 2, "y": batch["y"]}

    return _plain(ds.map_batches(double, batch_size=8).take_all())


def d_iter_batches_formats(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.from_items([{"a": i} for i in range(10)], parallelism=3)
    batches = list(ds.iter_batches(batch_size=4, batch_format="numpy"))
    dfs = list(ds.iter_batches(batch_size=5, batch_format="pandas"))
    return ([_plain(b) for b in batches],
            [list(map(int, df["a"])) for df in dfs])


def d_repartition_shuffle_sort(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.range(20, parallelism=2).repartition(5)
    sh = rd.range(50, parallelism=2).random_shuffle(seed=0)
    srt = rd.from_items([{"k": i % 7, "v": i} for i in range(21)],
                        parallelism=3).sort("k", descending=True)
    return (ds.num_blocks(), ds.take_all(), sh.take_all(),
            [r["k"] for r in srt.take_all()])


def d_zip_union_split(rt, accel, tmp):
    rd = _sub(rt, "data")
    a = rd.from_items([{"a": i} for i in range(6)])
    b = rd.from_items([{"b": i * 10} for i in range(6)])
    return (a.zip(b).take_all(), rd.range(5).union(rd.range(3)).count(),
            [p.count() for p in rd.range(10).split(2)])


def d_groupby(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.from_items([{"k": i % 3, "v": float(i)} for i in range(12)],
                       parallelism=4)
    return (ds.groupby("k").count().take_all(),
            ds.groupby("k").sum("v").take_all(),
            ds.groupby("k").mean("v").take_all())


def d_aggregates_and_schema(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.from_items([{"x": i} for i in range(10)])
    return ds.sum("x"), ds.min("x"), ds.max("x"), ds.mean("x"), ds.schema()


def d_read_write_roundtrip(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.from_items([{"a": i, "b": f"s{i}"} for i in range(10)],
                       parallelism=2)
    ds.write_json(os.path.join(tmp, "j"))
    back = sorted(rd.read_json(os.path.join(tmp, "j")).take_all(),
                  key=lambda r: r["a"])
    ds.write_parquet(os.path.join(tmp, "p"))
    n_parquet = rd.read_parquet(os.path.join(tmp, "p")).count()
    with open(os.path.join(tmp, "t.txt"), "w") as f:
        f.write("hello\nworld\n")
    text = rd.read_text(os.path.join(tmp, "t.txt")).take_all()
    return back == ds.take_all(), n_parquet, text


def d_from_numpy_pandas_arrow(rt, accel, tmp):
    import pandas as pd
    import pyarrow as pa

    rd = _sub(rt, "data")
    arr = np.arange(12).reshape(4, 3)
    df = pd.DataFrame({"x": [1, 2], "y": ["a", "b"]})
    return (_plain(rd.from_numpy(arr).take_all()),
            rd.from_pandas(df).take_all(),
            rd.from_arrow(pa.table({"q": [7, 8]})).count(),
            rd.from_items([{"x": 1}]).to_pandas().to_dict("list"))


def d_logical_plan_explain_and_rules(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = (rd.range(100, parallelism=4)
          .map(lambda x: {"a": x, "b": -x, "c": 2 * x})
          .select_columns(["a", "b", "c"])
          .select_columns(["a", "b"])
          .limit(5))
    ds2 = (rd.range(100, parallelism=4)
           .map(lambda x: {"a": x, "b": -x})
           .filter(lambda r: r["a"] % 2 == 0)
           .limit(5))
    return ds.explain(), ds.take_all(), ds2.explain(), ds2.take_all()


def d_limit_pushdown_skips_blocks(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.range(80, parallelism=8).map(lambda x: x + 1).limit(3)
    return len(ds._execute()), sorted(ds.take_all())


def d_leading_limit_caps_input_not_output(rt, accel, tmp):
    rd = _sub(rt, "data")
    empty = rd.range(100, parallelism=1).limit(5).filter(
        lambda x: x >= 10).take_all()
    doubled = sorted(rd.range(100, parallelism=2).limit(5).flat_map(
        lambda x: [x, x]).take_all())
    streamed = list(rd.range(100, parallelism=4).map(lambda x: x).limit(
        5).iter_rows())
    shards = rd.range(40, parallelism=4).limit(6).streaming_split(2)
    pipe = rd.range(40, parallelism=4).limit(6).window(blocks_per_window=2)
    return (empty, doubled, streamed,
            sum(len(sh.take_all()) for sh in shards),
            sum(1 for _ in pipe.iter_rows()))


def d_limit_blocked_by_flat_map(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.range(10, parallelism=2).flat_map(lambda x: [x, x]).limit(4)
    return ds.explain(), ds.take_all()


def d_target_rows_per_block(rt, accel, tmp):
    """``DataContext.target_max_rows_per_block``: block tasks run as
    dynamic generator tasks and split their output."""
    rd = _sub(rt, "data")
    ctx = rd.DataContext.get_current()
    old = ctx.target_max_rows_per_block
    ctx.target_max_rows_per_block = 3
    try:
        ds = rd.range(20, parallelism=2).map(lambda x: x * 2)
        return len(ds._execute()), ds.take_all()
    finally:
        ctx.target_max_rows_per_block = old


class NumpyPredictor:
    """A model-loading UDF: its constructor (the expensive part) marks a
    file with its pid; ``__call__`` maps a batch."""

    def __init__(self, path):
        with open(path, "a") as f:
            f.write(f"{os.getpid()}\n")
        self.w = np.random.default_rng(0).normal(size=(4, 2))

    def __call__(self, batch):
        return {"y": np.tanh(batch["x"] @ self.w)}


def d_actor_pool_init_once_per_actor(rt, accel, tmp):
    rd = _sub(rt, "data")
    marker = os.path.join(tmp, "inits.txt")
    ds = rd.from_items([{"x": np.ones(4) * i} for i in range(32)]
                       ).map_batches(
        NumpyPredictor, batch_size=4,
        compute=rd.ActorPoolStrategy(min_size=1, max_size=2),
        fn_constructor_args=(marker,))
    rows = ds.take_all()
    with open(marker) as f:
        inits = f.read().splitlines()
    return (len(rows), [np.round(r["y"], 12).tolist() for r in rows],
            1 <= len(inits) <= 2, len(set(inits)) == len(inits))


class PidUdf:
    def __call__(self, batch):
        return {"pid": np.full(len(batch["v"]), os.getpid())}


def d_actor_pool_respects_max_size(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.from_items([{"v": i} for i in range(40)]).map_batches(
        PidUdf, batch_size=5,
        compute=rd.ActorPoolStrategy(min_size=1, max_size=2))
    pids = {int(r["pid"]) for r in ds.take_all()}
    return 1 <= len(pids) <= 2


class AddTen:
    def __call__(self, batch):
        return {"v": batch["v"] + 10}


def d_actor_pool_composes_with_task_stages(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = (rd.range(20, parallelism=4)
          .map(lambda x: {"v": x})
          .map_batches(AddTen, compute="actors")
          .filter(lambda r: r["v"] % 2 == 0))
    return sorted(int(r["v"]) for r in ds.take_all())


def d_actor_pool_explain_and_plain_callable(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.range(8, parallelism=2).map(lambda x: {"v": x}).map_batches(
        lambda b: {"v": b["v"] * 2},
        compute=rd.ActorPoolStrategy(min_size=1, max_size=3))
    return ds.explain(), sorted(int(r["v"]) for r in ds.take_all())


class Ident:
    def __call__(self, batch):
        return batch


def d_actor_pool_streaming_iter_batches(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.range(24, parallelism=6).map(lambda x: {"v": x}).map_batches(
        Ident, compute="actors")
    return sorted(int(v) for b in ds.iter_batches(batch_size=8)
                  for v in b["v"])


def d_streaming_matches_bulk(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.range(100, parallelism=8).map(lambda x: x * 3)
    streamed = [r for rows in ds.iter_block_results() for r in rows]
    return streamed, ds.take_all()


def d_streaming_bounded_in_flight(rt, accel, tmp):
    """With prefetch_blocks=1, the first block does not execute them all."""
    rd = _sub(rt, "data")
    marker_dir = os.path.join(tmp, "marks")
    os.makedirs(marker_dir)

    def touch(x):
        open(os.path.join(marker_dir, f"b{os.getpid()}_{x}"), "w").close()
        return x

    it = rd.range(8, parallelism=8).map(touch).iter_block_results(
        prefetch_blocks=1)
    first = next(it)
    time.sleep(0.3)
    early = len(os.listdir(marker_dir))
    return first, early <= 4, sum(len(rows) for rows in it)


def d_iter_batches_streams(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.range(64, parallelism=8).map(lambda x: {"v": x})
    out = []
    for batch in ds.iter_batches(batch_size=16):
        out.append((sorted(batch), batch["v"].tolist()))
    return out


def d_streaming_split_is_lazy_and_disjoint(rt, accel, tmp):
    rd = _sub(rt, "data")
    ds = rd.range(40, parallelism=8).map(lambda x: x + 1000)
    return [s.take_all() for s in ds.streaming_split(4)]


def ingest_loop(config):
    """A rank's loop: stream its shard, report what it consumed."""
    train = importlib.import_module(config["pkg"] + ".train")
    shard = train.get_dataset_shard("train")
    total, n = 0, 0
    for batch in shard.iter_batches(batch_size=8):
        total += int(batch["x"].sum())
        n += len(batch["x"])
    train.report({"n": n, "total": total, "rank": train.get_world_rank()})


def d_train_ingest_with_dataset_shard(rt, accel, tmp):
    """``get_dataset_shard`` in a 2-rank gang: each rank streams its own
    blocks; rank 0 consumes a strict subset."""
    rd = _sub(rt, "data")
    tr = _sub(rt, "train")
    ds = rd.range(60, parallelism=6).map(lambda x: {"x": x})
    trainer = tr.DataParallelTrainer(
        ingest_loop, train_loop_config={"pkg": rt.__name__},
        scaling_config=tr.ScalingConfig(num_workers=2),
        run_config=tr.RunConfig(name="ingest", storage_path=tmp),
        datasets={"train": ds}, backend="store", **_trainer_kw(rt))
    result = trainer.fit()
    if result.error is not None:
        raise result.error
    last = result.metrics_history[-1]
    return last["n"], last["total"], last["rank"]


def d_dataset_pipeline_windows(rt, accel, tmp):
    rd = _sub(rt, "data")
    pipe = rd.range(40, parallelism=8).window(blocks_per_window=2).map(
        lambda x: x * 2)
    return list(pipe.iter_rows()), pipe.length, repr(pipe)


def d_dataset_pipeline_repeat_epochs(rt, accel, tmp):
    rd = _sub(rt, "data")
    return list(rd.range(10, parallelism=2).repeat(3).iter_rows())


def d_dataset_pipeline_batches_across_windows(rt, accel, tmp):
    rd = _sub(rt, "data")
    pipe = rd.range(24, parallelism=4).window(blocks_per_window=1)
    return [b["item"].tolist() for b in pipe.iter_batches(batch_size=6)]


def d_train_batches_of_a_token_table(rt, accel, tmp):
    """The main path's pipeline at a small size: seeded tokens, one row
    per sequence repeated for 3 steps, inputs and targets cut by
    ``map_batches``; the batches read back, and a seeded shuffle."""
    rd = _sub(rt, "data")
    toks = np.random.default_rng(0).integers(0, 256, (4, 17))
    ds = rd.from_numpy(np.tile(toks, (3, 1))).map_batches(
        lambda b: {"inputs": b["data"][:, :-1], "targets": b["data"][:, 1:]})
    batches = [_plain(b) for b in ds.iter_batches(batch_size=4)]
    shuffled = rd.from_numpy(np.tile(toks, (3, 1))).random_shuffle(seed=0)
    return batches, [r["data"].tolist() for r in shuffled.take_all()]


# ------------------------------------------------------------------ tune


def t_tuner_grid(rt, accel, tmp):
    tune = _sub(rt, "tune")
    tr = _sub(rt, "train")

    def objective(config):
        loss = 10.0 / config["lr"]
        for i in range(3):
            tune.report({"loss": loss / (i + 1)})

    grid = tune.Tuner(
        objective, param_space={"lr": tune.grid_search([1.0, 2.0, 5.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=2),
        run_config=tr.RunConfig(name="grid", storage_path=tmp)).fit()
    best = grid.get_best_result()
    return (len(grid), best.metrics, len(grid.errors),
            sorted(r.metrics["loss"] for r in grid))


def t_asha_stops_bad_trials(rt, accel, tmp):
    tune = _sub(rt, "tune")
    tr = _sub(rt, "train")

    def objective(config):
        for i in range(1, 10):
            tune.report({"score": config["quality"] * i,
                         "training_iteration": i})
            time.sleep(0.01)

    grid = tune.Tuner(
        objective, param_space={"quality": tune.grid_search([1.0, 10.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2,
            scheduler=tune.ASHAScheduler(metric="score", mode="max",
                                         max_t=9, grace_period=2,
                                         reduction_factor=2)),
        run_config=tr.RunConfig(name="asha", storage_path=tmp)).fit()
    states = sorted(t.state for t in grid._trials)
    return ("STOPPED" in states or all(s == "TERMINATED" for s in states),
            grid.get_best_result().metrics["score"])


def t_trial_retry(rt, accel, tmp):
    tune = _sub(rt, "tune")
    tr = _sub(rt, "train")

    def flaky(config):
        if not os.path.exists(config["marker"]):
            open(config["marker"], "w").write("x")
            raise RuntimeError("first attempt fails")
        tune.report({"loss": 1.0})

    grid = tune.Tuner(
        flaky, param_space={"marker": os.path.join(tmp, "m1")},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=tr.RunConfig(
            name="flaky", storage_path=tmp,
            failure_config=tr.FailureConfig(max_failures=1))).fit()
    return (len(grid.errors), grid.get_best_result().metrics["loss"],
            [t.retries for t in grid._trials])


def t_pbt_exploits_toward_better_config(rt, accel, tmp):
    tune = _sub(rt, "tune")
    tr = _sub(rt, "train")

    def train_fn(config):
        ckpt = tr.get_checkpoint()
        score = ckpt.to_dict()["score"] if ckpt else 0.0
        for _ in range(25):
            score += config["lr"]
            tr.report({"score": score},
                      checkpoint=tr.Checkpoint.from_dict({"score": score}))
            time.sleep(0.12)

    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": lambda: 1.0}, quantile_fraction=0.34,
        seed=0)
    grid = tune.Tuner(
        train_fn, param_space={"lr": tune.grid_search([0.01, 0.02, 1.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=pbt, num_samples=1),
        run_config=tr.RunConfig(name="pbt", storage_path=tmp)).fit()
    scores = sorted(r.metrics["score"] for r in grid)
    return pbt.num_exploits >= 1, scores[1] > 1.0, len(grid.errors)


def gang_trial_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    ws = train.get_world_size()
    total = float(np.asarray(train.session.allreduce(np.ones(1)))[0])
    train.report({"world": ws, "lr": config["lr"], "sum": total})


def t_tune_trial_as_multiworker_gang(rt, accel, tmp):
    """A trial that is a 2-rank gang reserves its driver and workers at
    once through a PlacementGroupFactory; every group goes afterwards."""
    tune = _sub(rt, "tune")
    tr = _sub(rt, "train")
    trainer = tr.DataParallelTrainer(
        gang_trial_loop, train_loop_config={"pkg": rt.__name__},
        scaling_config=tr.ScalingConfig(num_workers=2),
        run_config=tr.RunConfig(storage_path=os.path.join(tmp, "inner")),
        backend="store", **_trainer_kw(rt))
    grid = tune.Tuner(
        trainer,
        param_space={"train_loop_config": {
            "lr": tune.grid_search([0.1, 0.2])}},
        tune_config=tune.TuneConfig(
            metric="sum", mode="max",
            resources_per_trial=tune.PlacementGroupFactory(
                [{"CPU": 1.0}, {"CPU": 1.0}, {"CPU": 1.0}])),
        run_config=tr.RunConfig(storage_path=tmp)).fit()
    deadline = time.time() + 10
    while time.time() < deadline and \
            rt.available_resources().get("CPU", 0) < CLUSTER["num_cpus"]:
        time.sleep(0.1)
    return (len(grid), len(grid.errors),
            sorted((r.metrics["lr"], r.metrics["world"], r.metrics["sum"])
                   for r in grid),
            rt.available_resources().get("CPU", 0))


def gpu_trial_loop(config):
    """A GPU trial's rank (the port's): when it ran, on which node, with
    which GPU, and whether it shared the GPU node with another trial."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    t0 = time.time()
    time.sleep(config["hold_s"])
    train.report({"lr": config["lr"], "start": t0, "end": time.time(),
                  "node": rt.get_runtime_context().get_node_id(),
                  "cuda_visible_devices":
                      os.environ.get("CUDA_VISIBLE_DEVICES")})


def gpt_trial_loop(config):
    """The tiny GPT in a trial's rank (the port's): its params from
    ``config["params"]`` (numpy), SGD with decoupled weight decay, one
    step per batch the rank reads from its dataset shard; a report per
    step with the loss and the rank's GPU and node."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import models as tm
    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tt

    dev = train.get_device()
    cfg = tm.GPTConfig.preset("tiny", dtype=torch.float32,
                              flash_attention=True)
    params = tm.params_from_numpy(config["params"], cfg, device=dev)
    leaves = tt.tree_leaves(params)
    opt = torch.optim.SGD(leaves, lr=config["lr"], weight_decay=config["wd"])
    shard = train.get_dataset_shard("train")
    for step, b in enumerate(shard.iter_batches(
            batch_size=config["batch"], batch_format="numpy")):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        opt.zero_grad(set_to_none=True)
        loss = tm.loss_fn(params, batch, cfg)
        loss.backward()
        opt.step()
        train.report({"step": step, "loss": float(loss),
                      "batch": b["inputs"].tolist(),
                      "node": rt.get_runtime_context().get_node_id(),
                      "cuda_visible_devices":
                          os.environ.get("CUDA_VISIBLE_DEVICES")})


# ----------------------------------------------------------- tune search
# The Tuner tests of tests/test_tune_search.py; the same 4-CPU cluster.


def ts_tpe_drives_tuner_end_to_end(rt, accel, tmp):
    """TPE through the full Tuner loop (configs suggested at launch,
    completions fed back) reaches the bowl's floor."""
    tune = _sub(rt, "tune")
    tr = _sub(rt, "train")

    def bowl(config):
        x, y = config["x"], config["y"]
        tune.report({"loss": (x - 0.2) ** 2 + (y + 0.4) ** 2})

    searcher = tune.TPESearcher(metric="loss", mode="min", n_initial=5,
                                seed=0)
    grid = tune.Tuner(
        bowl,
        param_space={"x": tune.uniform(-1.0, 1.0),
                     "y": tune.uniform(-1.0, 1.0)},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=16,
            max_concurrent_trials=2, search_alg=searcher),
        run_config=tr.RunConfig(name="tpe", storage_path=tmp)).fit()
    return (len(grid), len(searcher._obs),
            grid.get_best_result().metrics["loss"] < 0.05)


def ts_tpe_composes_with_asha(rt, accel, tmp):
    """Searcher + scheduler: ASHA prunes mid-trial while TPE keeps
    learning from (possibly pruned) completions."""
    tune = _sub(rt, "tune")
    tr = _sub(rt, "train")

    def train_fn(config):
        m = config["m"]
        for i in range(8):
            tune.report({"loss": (m - 0.5) ** 2 + 1.0 / (i + 1)})

    searcher = tune.TPESearcher(metric="loss", mode="min", n_initial=4,
                                seed=1)
    grid = tune.Tuner(
        train_fn, param_space={"m": tune.uniform(0.0, 1.0)},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=10,
            max_concurrent_trials=2, search_alg=searcher,
            scheduler=tune.ASHAScheduler(
                metric="loss", mode="min", max_t=8, grace_period=2)),
        run_config=tr.RunConfig(name="tpe_asha", storage_path=tmp)).fit()
    return (len(grid), len(searcher._obs) >= 5,
            grid.get_best_result().metrics["loss"] < 0.5)


def ts_hyperband_in_tuner(rt, accel, tmp):
    tune = _sub(rt, "tune")
    tr = _sub(rt, "train")

    def train_fn(config):
        for i in range(9):
            tune.report({"loss": config["m"] + 1.0 / (i + 1)})

    grid = tune.Tuner(
        train_fn,
        param_space={"m": tune.grid_search([0.1 * i for i in range(6)])},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min",
            scheduler=tune.HyperBandScheduler(metric="loss", mode="min",
                                              max_t=9, reduction_factor=3)),
        run_config=tr.RunConfig(name="hyperband", storage_path=tmp)).fit()
    states = {t.state for t in grid._trials}
    return (states <= {"TERMINATED", "STOPPED"},
            grid.get_best_result().metrics["loss"] < 0.35)


# --------------------------------------------------------------- runners

PROGRAMS = {
    "autoscaler": [p_multinode_scheduling, p_remove_node_fails_tasks_over,
                   p_autoscaler_scales_up_and_down,
                   p_autoscaler_respects_max_workers,
                   p_min_workers_launched, p_pg_prefers_single_pool,
                   p_launch_min_workers_and_autoscale, p_bad_yaml_rejected,
                   p_pool_fifo_granting],
    # The gang's program first, on the fresh cluster: after the others, on
    # either runtime, its rendezvous outwaits the test (ROADMAP §3).
    "data": [d_train_ingest_with_dataset_shard,
             d_range_and_transforms, d_flat_map_and_fusion,
             d_map_batches_numpy, d_iter_batches_formats,
             d_repartition_shuffle_sort, d_zip_union_split, d_groupby,
             d_aggregates_and_schema, d_read_write_roundtrip,
             d_from_numpy_pandas_arrow, d_logical_plan_explain_and_rules,
             d_limit_pushdown_skips_blocks,
             d_leading_limit_caps_input_not_output,
             d_limit_blocked_by_flat_map, d_target_rows_per_block,
             d_actor_pool_init_once_per_actor,
             d_actor_pool_respects_max_size,
             d_actor_pool_composes_with_task_stages,
             d_actor_pool_explain_and_plain_callable,
             d_actor_pool_streaming_iter_batches, d_streaming_matches_bulk,
             d_streaming_bounded_in_flight, d_iter_batches_streams,
             d_streaming_split_is_lazy_and_disjoint,
             d_dataset_pipeline_windows,
             d_dataset_pipeline_repeat_epochs,
             d_dataset_pipeline_batches_across_windows,
             d_train_batches_of_a_token_table],
    "tune": [t_tuner_grid, t_asha_stops_bad_trials, t_trial_retry,
             t_pbt_exploits_toward_better_config,
             t_tune_trial_as_multiworker_gang],
    "tune_search": [ts_tpe_drives_tuner_end_to_end, ts_tpe_composes_with_asha,
                    ts_hyperband_in_tuner],
}
# Groups whose programs share one cluster (the autoscaler's make their own).
SHARED_CLUSTER = ("data", "tune", "tune_search")


def run_group(rt, accel, group, tmp):
    """Every program of ``group`` on ``rt``, one after the other."""
    out = {}
    if group in SHARED_CLUSTER:
        rt.init(**CLUSTER)
    try:
        for prog in PROGRAMS[group]:
            d = tempfile.mkdtemp(prefix=prog.__name__ + "_", dir=tmp)
            try:
                out[prog.__name__] = ("ok", _plain(prog(rt, accel, d)))
            except Exception:
                out[prog.__name__] = ("error", traceback.format_exc())
    finally:
        if group in SHARED_CLUSTER:
            rt.shutdown()
    return out


if __name__ == "__main__":
    import ray_tpu
    from torch_runtimes import REFERENCE_BLOCK_S, deadline

    with deadline(REFERENCE_BLOCK_S,
                  what=f"the {sys.argv[1]} programs on ray_tpu"):
        results = run_group(ray_tpu, "TPU", sys.argv[1], sys.argv[2])
    print("RESULTS " + repr(results), flush=True)
