"""The reference's last test files as programs, run on both runtimes:
``tests/test_util_queue.py``, ``test_util_extras.py``,
``test_dag_workflow.py``, ``test_data_actor_pool.py``,
``test_data_streaming.py``, ``test_apex.py``, ``test_collective_dist.py``,
``test_cluster_launcher.py``, ``test_tpu_pod_provider.py`` and
``test_cluster_autoscaler.py``, one group each, named after the file
(without ``test_``).

As in ``torch_api_programs``: each program is the body of the reference
test of the same name and returns what that test asserts on as plain
values; where a value differs between runs (a pid, a loss, a count that
hangs on timing) it returns whether the reference's assertion held. The
bodies that earlier slices already wrote (``torch_tools_programs``'
queue, pool, ``check_serialize`` and workflow programs,
``torch_cluster_programs``' data and autoscaler programs) are reused
under the reference test's name. A group whose reference tests each start
the same cluster runs on one cluster of that size (``CLUSTERS``); the
launcher, pool and autoscaler programs start their own, as the reference's
do.

Where the reference reaches TPU chips or JAX, the port reaches GPUs or
torch: ``xla_dist`` groups and ``JaxTrainer`` become ``torch_dist`` (gloo,
one process a rank) and ``TorchDistTrainer``; a JAX model UDF becomes a
torch one; TPU slices become GPU host pools (``gpu_pool_provider``).

The module imports neither runtime, nor jax, nor torch at import time.
``python tests/torch_libs_programs.py GROUP DIR`` runs a group on
``ray_tpu``.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

import torch_cluster_programs as cp
import torch_tools_programs as tp

MiB = 1024 * 1024
T = 120     # seconds: every get is bounded
# One wait of a program that polls for what the reference's test races on.
WAIT_S = 60.0

CLUSTERS = {
    "util_queue": dict(num_cpus=2, object_store_memory=64 * MiB),
    "util_extras": dict(num_cpus=4, object_store_memory=256 * MiB),
    "dag_workflow": dict(num_cpus=4, object_store_memory=128 * MiB),
    "data_actor_pool": dict(num_cpus=4, object_store_memory=128 * MiB),
    "data_streaming": dict(num_cpus=4, object_store_memory=128 * MiB),
    "apex": dict(num_cpus=4, object_store_memory=128 * MiB),
    "collective_dist": dict(num_cpus=4, object_store_memory=128 * MiB),
}


def _sub(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _named(name, prog):
    """``prog`` under the reference test's name (without ``test_``)."""
    def run(rt, accel, tmp):
        return prog(rt, accel, tmp)
    run.__name__ = run.__qualname__ = name
    return run


def _wait(cond, timeout_s=WAIT_S, every_s=0.25):
    """Poll ``cond()`` until it is truthy or ``timeout_s`` ends; its last
    value."""
    deadline = time.time() + timeout_s
    while True:
        got = cond()
        if got or time.time() > deadline:
            return got
        time.sleep(every_s)


# ------------------------------------------------------------ util_extras


def usage_stats(rt, accel, tmp):
    usage = _sub(rt, "_private.usage")
    _sub(rt, "train")     # records library usage
    usage.record_library_usage("train")
    usage.record_extra_usage_tag("test_tag", "on")
    stats = usage.get_usage_stats()
    path = usage.write_usage_report()
    with open(path) as f:
        version = json.load(f)["ray_tpu_version"]
    return (stats is not None, "train" in stats["libraries_used"],
            stats["extra_tags"].get("test_tag"), path is not None,
            bool(version))


def usage_stats_opt_out(rt, accel, tmp):
    """The opt-out variable of the runtime (``RAY_TPU_...`` or
    ``RAY_TPU_TORCH_...``) turns stats off and on; the variable and the
    knob are put back whatever happens, as the reference's ``finally``
    does."""
    usage = _sub(rt, "_private.usage")
    config = _sub(rt, "_private.config").config
    var = f"{rt.__name__.upper()}_USAGE_STATS_ENABLED"
    old = os.environ.get(var)
    try:
        os.environ[var] = "0"
        off = (usage.usage_stats_enabled(), usage.write_usage_report())
        os.environ[var] = "1"
        return off, usage.usage_stats_enabled()
    finally:
        if old is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = old
        config.set("usage_stats_enabled", True)


# ----------------------------------------------------------- data (actors)


class ModelPredictor:
    """A model UDF: its constructor builds the model (JAX on ``ray_tpu``,
    torch on the port) and notes its pid; a call applies it."""

    def __init__(self, path, pkg):
        with open(path, "a") as f:
            f.write(f"{os.getpid()}\n")
        if pkg == "ray_tpu":
            import jax
            import jax.numpy as jnp

            self.w = jax.random.normal(jax.random.key(0), (4, 2))
            self.apply = jax.jit(lambda w, x: jnp.tanh(x @ w))
        else:
            import torch

            self.w = torch.randn(4, 2, generator=torch.Generator(
            ).manual_seed(0))
            self.apply = lambda w, x: torch.tanh(
                torch.as_tensor(x, dtype=torch.float32) @ w)

    def __call__(self, batch):
        return {"y": np.asarray(self.apply(self.w, batch["x"]))}


def actor_pool_init_once_per_actor(rt, accel, tmp):
    rd = _sub(rt, "data")
    marker = os.path.join(tmp, "inits.txt")
    ds = rd.from_items([{"x": np.ones(4, np.float32) * i}
                        for i in range(32)]).map_batches(
        ModelPredictor, batch_size=4,
        compute=rd.ActorPoolStrategy(min_size=1, max_size=2),
        fn_constructor_args=(marker, rt.__name__))
    rows = ds.take_all()
    with open(marker) as f:
        inits = f.read().splitlines()
    return (len(rows), all(r["y"].shape == (2,) for r in rows),
            1 <= len(inits) <= 2, len(set(inits)) == len(inits))


def actor_pool_explain_and_plain_callable(rt, accel, tmp):
    text, values = cp.d_actor_pool_explain_and_plain_callable(rt, accel, tmp)
    return "ActorPool" in text and "max=3" in text, values


# --------------------------------------------------------- data streaming


def streaming_matches_bulk(rt, accel, tmp):
    streamed, bulk = cp.d_streaming_matches_bulk(rt, accel, tmp)
    return sorted(streamed), sorted(bulk)


def iter_batches_streams(rt, accel, tmp):
    out = cp.d_iter_batches_streams(rt, accel, tmp)
    return ([keys for keys, _ in out],
            sorted(v for _, vs in out for v in vs))


def streaming_split_is_lazy_and_disjoint(rt, accel, tmp):
    got = [sorted(s) for s in cp.d_streaming_split_is_lazy_and_disjoint(
        rt, accel, tmp)]
    return sorted(r for g in got for r in g), sum(len(g) for g in got)


def train_ingest_with_dataset_shard(rt, accel, tmp):
    n0, total0, rank = cp.d_train_ingest_with_dataset_shard(rt, accel, tmp)
    return 0 < n0 < 60, rank


def dataset_pipeline_windows(rt, accel, tmp):
    rows, length, _ = cp.d_dataset_pipeline_windows(rt, accel, tmp)
    return sorted(rows), length


def dataset_pipeline_repeat_epochs(rt, accel, tmp):
    rows = cp.d_dataset_pipeline_repeat_epochs(rt, accel, tmp)
    return len(rows), sorted(set(rows))


def dataset_pipeline_batches_across_windows(rt, accel, tmp):
    batches = cp.d_dataset_pipeline_batches_across_windows(rt, accel, tmp)
    return sum(len(b) for b in batches)


# ------------------------------------------------------------------- apex


def _cartpole():
    import gymnasium as gym

    return gym.make("CartPole-v1")


def prioritized_shard_math(rt, accel, tmp):
    """The prioritized shard alone: sampling follows the priorities,
    importance weights correct for it, and a priority update takes
    effect."""
    shard = _sub(rt, "rllib.apex")._ReplayShard(
        capacity=64, obs_dim=2, alpha=1.0, eps=1e-6, seed=0)
    batch = {"obs": np.zeros((10, 2), np.float32),
             "actions": np.arange(10, dtype=np.int32),
             "rewards": np.zeros(10, np.float32),
             "next_obs": np.zeros((10, 2), np.float32),
             "dones": np.zeros(10, np.float32)}
    prios = np.ones(10)
    prios[3] = 100.0     # one dominant transition
    shard.add_batch(batch, prios)
    out, _ = shard.sample(512, beta=1.0)
    frac_3 = float(np.mean(out["actions"] == 3))
    w3 = out["weights"][out["actions"] == 3]
    w_other = out["weights"][out["actions"] != 3]
    shard.update_priorities(np.arange(10), np.ones(10))
    out2, _ = shard.sample(512, beta=1.0)
    return (frac_3 > 0.7, bool(w3.max() < w_other.min()),
            float(np.mean(out2["actions"] == 3)) < 0.3)


def apex_end_to_end(rt, accel, tmp):
    """The Ape-X loop on CartPole with the reference's configuration; the
    port's learner and rollout workers on the CPU here."""
    rllib = _sub(rt, "rllib")
    kw = ({} if rt.__name__ == "ray_tpu" else
          {"runtime": rt, "device": "cpu", "worker_device": "cpu"})
    algo = (rllib.ApexDQNConfig(
                buffer_size=8000, learning_starts=200,
                train_batch_size=32, num_sgd_iters=8,
                num_replay_shards=2, rollout_fragment_length=100)
            .environment(_cartpole)
            .rollouts(num_rollout_workers=2)
            .build(**kw))
    try:
        total_updates = 0
        for _ in range(4):
            m = algo.train()
            total_updates += m.get("learner_updates_this_iter", 0)
        sizes = rt.get([s.stats.remote() for s in algo.replay_shards],
                       timeout=T)
        return (m["replay_total"] >= 200, m["replay_shards"],
                total_updates > 0, "td_abs" not in m,
                all(s["size"] > 0 for s in sizes),
                any(s["prio_max"] > s["prio_mean"] for s in sizes))
    finally:
        algo.stop()


# -------------------------------------------------------- collective_dist


class DistWorker:
    """One rank of a cross-process group: ``xla_dist`` on ``ray_tpu``,
    ``torch_dist`` on gloo on the port. It joins in a method, so the group
    forms inside the ranks' concurrent calls."""

    def __init__(self, pkg):
        self.pkg = pkg

    def join(self, world, rank, name):
        collective = importlib.import_module(f"{self.pkg}.parallel.collective")
        if self.pkg == "ray_tpu":
            self._g = collective.init_collective_group(
                world, rank, backend="xla_dist", group_name=name)
        else:
            self._g = collective.init_collective_group(
                world, rank, backend="torch_dist", group_name=name,
                device="cpu", runtime=importlib.import_module(self.pkg))
        return True

    def world_info(self):
        if self.pkg == "ray_tpu":
            import jax

            return {"process_count": jax.process_count(),
                    "process_index": jax.process_index(),
                    "mesh_devices": int(np.prod(
                        self._g.mesh.devices.shape))}
        import torch.distributed as dist

        return {"process_count": dist.get_world_size(),
                "process_index": dist.get_rank(),
                "mesh_devices": self._g.world_size}

    def allreduce(self, value, shape=(8,)):
        out = self._g.allreduce(np.full(shape, value, np.float32))
        return np.asarray(out).tolist()

    def allgather(self, value):
        return np.asarray(
            self._g.allgather(np.full((2,), value, np.float32))).tolist()

    def broadcast(self, rank):
        payload = (np.arange(4, dtype=np.float32) if rank == 0
                   else np.zeros(4, np.float32))
        return np.asarray(self._g.broadcast(payload, src_rank=0)).tolist()

    def reducescatter(self, rank, world):
        t = np.full((2 * world, 3), float(rank + 1), np.float32)
        return np.asarray(self._g.reducescatter(t)).tolist()

    def p2p(self, rank):
        if rank == 0:
            self._g.send(np.full((4,), 7.0, np.float32), dst_rank=1)
            return None
        return np.asarray(
            self._g.recv((4,), np.float32, src_rank=0)).tolist()

    def barrier(self):
        self._g.barrier()
        return True


def xla_dist_group(rt, accel, tmp):
    world = 2
    cls = rt.remote(DistWorker)
    workers = [cls.remote(rt.__name__) for _ in range(world)]
    out = {"join": rt.get([w.join.remote(world, r, "tdist")
                           for r, w in enumerate(workers)], timeout=180)}
    infos = rt.get([w.world_info.remote() for w in workers], timeout=T)
    out["process_count"] = [i["process_count"] for i in infos]
    out["process_index"] = sorted(i["process_index"] for i in infos)
    out["mesh_devices"] = [i["mesh_devices"] for i in infos]
    out["allreduce"] = rt.get([w.allreduce.remote(float(r + 1))
                               for r, w in enumerate(workers)], timeout=T)
    out["allgather"] = rt.get([w.allgather.remote(float(r))
                               for r, w in enumerate(workers)], timeout=T)
    out["broadcast"] = rt.get([w.broadcast.remote(r)
                               for r, w in enumerate(workers)], timeout=T)
    out["reducescatter"] = rt.get([w.reducescatter.remote(r, world)
                                   for r, w in enumerate(workers)],
                                  timeout=T)
    out["p2p"] = rt.get([w.p2p.remote(r) for r, w in enumerate(workers)],
                        timeout=T)[1]
    out["barrier"] = rt.get([w.barrier.remote() for w in workers],
                            timeout=T)
    for w in workers:
        rt.kill(w)
    return out


def dist_train_loop(config):
    """The trainer's loop whose gradient allreduce goes through the
    cross-process group: the compiled XLA collective (``JaxTrainer``) on
    ``ray_tpu``, gloo's (``TorchDistTrainer``) on the port. Rank 0 reports
    the group's kind, whether the world spans the gang, and the loss."""
    pkg = config["pkg"]
    train = importlib.import_module(f"{pkg}.train")
    collective = importlib.import_module(f"{pkg}.parallel.collective")
    g = collective.get_group(
        train.session._get_session().collective_group_name)
    rank, ws = train.get_world_rank(), train.get_world_size()
    x = np.random.default_rng(rank).normal(size=(8, 4)).astype(np.float32)
    if pkg == "ray_tpu":
        import jax
        import jax.numpy as jnp

        spans = jax.process_count() == ws
        w = jnp.zeros((4,), jnp.float32)
        xj = jnp.asarray(x)

        def loss(w):
            return jnp.mean((xj @ w - 1.0) ** 2)

        def grad(w):
            return np.asarray(jax.grad(loss)(w))
    else:
        import torch
        import torch.distributed as dist

        spans = dist.get_world_size() == ws
        w = torch.zeros(4)
        xt = torch.as_tensor(x)

        def loss(w):
            return torch.mean((xt @ w - 1.0) ** 2)

        def grad(w):
            w = w.clone().requires_grad_(True)
            loss(w).backward()
            return w.grad.numpy()
    kind = type(g).__name__
    for step in range(config["steps"]):
        gsum = np.asarray(g.allreduce(grad(w)), np.float32) / ws
        w = w - 0.1 * (jnp.asarray(gsum) if pkg == "ray_tpu"
                       else torch.as_tensor(gsum))
        if rank == 0:
            train.report({"step": step, "loss": float(loss(w)),
                          "kind": kind, "spans": spans})


def jax_trainer_uses_xla_dist(rt, accel, tmp):
    tr = _sub(rt, "train")
    if rt.__name__ == "ray_tpu":
        trainer_cls, kw = tr.JaxTrainer, {}
    else:
        trainer_cls = tr.TorchDistTrainer
        kw = {"runtime": rt, "device": "cpu"}
    trainer = trainer_cls(
        dist_train_loop,
        train_loop_config={"steps": 3, "pkg": rt.__name__},
        scaling_config=tr.ScalingConfig(num_workers=2),
        run_config=tr.RunConfig(name="xd", storage_path=tmp), **kw)
    result = trainer.fit()
    if result.error is not None:
        raise result.error
    hist = result.metrics_history
    kinds = {m["kind"] for m in hist}
    want = "XlaDistributedGroup" if rt.__name__ == "ray_tpu" else \
        "TorchDistGroup"
    return (kinds == {want}, all(m["spans"] for m in hist),
            hist[-1]["loss"] < hist[0]["loss"])


# ------------------------------------------------------- cluster_launcher


def yaml_launch_min_workers_and_autoscale(rt, accel, tmp):
    cl = _sub(rt, "autoscaler.cluster_launcher")
    path = os.path.join(tmp, "cluster.yaml")
    with open(path, "w") as f:
        f.write(cp.CLUSTER_YAML)
    launched = cl.launch_cluster(cl.load_cluster_config(path))
    try:
        rt.init(address=launched.address)
        w = _sub(rt, "_private.worker").require_worker()
        alive = _wait(lambda: sum(1 for n in w.nodes() if n["Alive"]) >= 2)

        @rt.remote(num_cpus=2)
        def hold():
            time.sleep(3)
            return 1

        out = rt.get([hold.remote() for _ in range(4)], timeout=T)
        return (alive, out,
                len(launched.provider.non_terminated_nodes()) >= 2)
    finally:
        rt.shutdown()
        launched.shutdown()


# ------------------------------------------------------- tpu_pod_provider


def two_slice_scale_up_and_slice_affine_pg(rt, accel, tmp):
    """Gang demand for two pools' (slices') worth of accelerators; the
    reference's reads, with its last one waited for: the cluster's
    accelerators return to 0 once the GCS has seen the pools' hosts go
    (the reference's test reads it once, before)."""
    (launched, ready, pools, total, seen, left,
     after) = cp.p_two_pool_scale_up_and_down(rt, accel, tmp)
    return (launched >= 2, ready, pools, total, len(seen), left, after)


# ----------------------------------------------------- cluster_autoscaler


def autoscaler_scales_up_and_down(rt, accel, tmp):
    """A saturated head (1 CPU) and four leased 6 s tasks, as the
    reference submits them. The reference reconciles once, 0.5 s after
    the submit, and asks for two launches then; a lease's pipelined
    backlog shows in the GCS's demand only as the lease requests reach it,
    so this program reconciles until two nodes are launched, within
    ``WAIT_S``, and returns whether they were."""
    a = _sub(rt, "autoscaler")
    c = cp._cluster(rt)
    try:
        provider = a.FakeMultiNodeProvider(c)
        scaler = cp._scaler(
            rt, provider,
            node_types=[a.NodeType("cpu_worker", {"CPU": 2.0},
                                   max_workers=3)],
            max_workers=3, idle_timeout_s=1.5)

        @rt.remote(num_cpus=1)
        def hold(t):
            time.sleep(t)
            return 1

        refs = [hold.remote(6) for _ in range(4)]
        time.sleep(0.5)
        launched = 0

        def reconcile():
            nonlocal launched
            launched += scaler.run_once()["launched"]
            return launched >= 2

        t0 = time.time()
        up = _wait(reconcile, every_s=0.5)
        print(f"autoscaler_scales_up_and_down on {rt.__name__}: {launched} "
              f"launched in {time.time() - t0:.1f} s", file=sys.stderr)
        ready = c.wait_for_nodes()
        results = rt.get(refs, timeout=60)

        def scaled_down():
            scaler.run_once()
            return not provider.non_terminated_nodes()

        down = _wait(scaled_down, timeout_s=30, every_s=0.5)
        return up, ready, results, down
    finally:
        cp._down(rt, c)


def autoscaler_respects_max_workers(rt, accel, tmp):
    a = _sub(rt, "autoscaler")
    c = cp._cluster(rt)
    try:
        provider = a.FakeMultiNodeProvider(c)
        scaler = cp._scaler(
            rt, provider,
            node_types=[a.NodeType("cpu_worker", {"CPU": 1.0},
                                   max_workers=2)],
            max_workers=2, idle_timeout_s=60)

        @rt.remote(num_cpus=1)
        def hold():
            time.sleep(5)

        _refs = [hold.remote() for _ in range(10)]
        time.sleep(0.5)
        scaler.run_once()
        scaler.run_once()
        return len(provider.non_terminated_nodes()) <= 2
    finally:
        cp._down(rt, c)


def pg_prefers_single_slice_for_tpu_bundles(rt, accel, tmp):
    ready, n_slices = cp.p_pg_prefers_single_pool(rt, accel, tmp)
    return ready, n_slices


# ---------------------------------------------------------------- groups


PROGRAMS = {
    "util_queue": [_named("fifo_roundtrip", tp.u_fifo_roundtrip),
                   _named("maxsize_blocks_and_full",
                          tp.u_maxsize_blocks_and_full),
                   _named("queue_across_tasks", tp.u_queue_across_tasks),
                   _named("batch_ops", tp.u_batch_ops)],
    "util_extras": [_named("pool_map", tp.u_pool_map),
                    _named("pool_apply_and_async", tp.u_pool_apply_and_async),
                    _named("pool_starmap_imap", tp.u_pool_starmap_imap),
                    _named("pool_error_and_callbacks",
                           tp.u_pool_error_and_callbacks),
                    _named("pool_initializer", tp.u_pool_initializer),
                    _named("pool_lifecycle", tp.u_pool_lifecycle),
                    _named("pool_join_waits_for_outstanding",
                           tp.u_pool_join_waits_for_outstanding),
                    _named("check_serialize_ok", tp.u_check_serialize_ok),
                    _named("check_serialize_finds_capture",
                           tp.u_check_serialize_finds_capture),
                    usage_stats, usage_stats_opt_out],
    "dag_workflow": [_named("dag_basic", tp.w_dag_basic),
                     _named("dag_diamond_single_execution",
                            tp.w_dag_diamond_single_execution),
                     _named("actor_method_bind", tp.w_actor_method_bind),
                     _named("workflow_run_and_output",
                            tp.w_workflow_run_and_output),
                     _named("workflow_resume_skips_completed_steps",
                            tp.w_workflow_resume_skips_completed_steps)],
    "data_actor_pool": [actor_pool_init_once_per_actor,
                        _named("actor_pool_respects_max_size",
                               cp.d_actor_pool_respects_max_size),
                        _named("actor_pool_composes_with_task_stages",
                               cp.d_actor_pool_composes_with_task_stages),
                        actor_pool_explain_and_plain_callable,
                        _named("actor_pool_streaming_iter_batches",
                               cp.d_actor_pool_streaming_iter_batches)],
    # The gang's program first, on the fresh cluster, as the data group
    # of ``torch_cluster_programs`` runs it.
    "data_streaming": [train_ingest_with_dataset_shard,
                       streaming_matches_bulk,
                       _named("streaming_bounded_in_flight",
                              cp.d_streaming_bounded_in_flight),
                       iter_batches_streams,
                       streaming_split_is_lazy_and_disjoint,
                       dataset_pipeline_windows,
                       dataset_pipeline_repeat_epochs,
                       dataset_pipeline_batches_across_windows],
    "apex": [prioritized_shard_math, apex_end_to_end],
    "collective_dist": [xla_dist_group, jax_trainer_uses_xla_dist],
    "cluster_launcher": [yaml_launch_min_workers_and_autoscale,
                         _named("bad_yaml_rejected", cp.p_bad_yaml_rejected)],
    "tpu_pod_provider": [two_slice_scale_up_and_slice_affine_pg,
                         _named("capacity_gated_fifo_granting",
                                cp.p_pool_fifo_granting)],
    "cluster_autoscaler": [_named("multinode_scheduling",
                                  cp.p_multinode_scheduling),
                           _named("remove_node_fails_tasks_over",
                                  cp.p_remove_node_fails_tasks_over),
                           autoscaler_scales_up_and_down,
                           autoscaler_respects_max_workers,
                           _named("min_workers_launched",
                                  cp.p_min_workers_launched),
                           pg_prefers_single_slice_for_tpu_bundles],
}


def run_group(rt, accel, group, tmp):
    """Every program of ``group`` on ``rt``, one after the other, each in
    its own directory: ``{name: ("ok", value) or ("error", text)}``."""
    out = {}
    shared = CLUSTERS.get(group)
    if shared is not None:
        rt.init(**shared)
    try:
        for prog in PROGRAMS[group]:
            d = tempfile.mkdtemp(prefix=prog.__name__ + "_", dir=tmp)
            try:
                out[prog.__name__] = ("ok", prog(rt, accel, d))
            except Exception:
                out[prog.__name__] = ("error", traceback.format_exc())
    finally:
        if shared is not None:
            rt.shutdown()
    return out


if __name__ == "__main__":
    from torch_api_programs import main

    main(run_group)
