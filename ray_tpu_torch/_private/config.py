"""Typed runtime configuration registry.

Equivalent in role to the reference's ``RAY_CONFIG`` macro registry
(reference: src/ray/common/ray_config_def.h, ray_config.h:47): every knob has
a typed default, can be overridden per-process with a ``RAY_TPU_TORCH_<NAME>``
environment variable, and can be shipped cluster-wide as a JSON system-config
blob at node start. The port's copy of ``ray_tpu/_private/config.py``: the
runtime's knobs and those of the port's serving tier and gang trainer,
under their reference names, with the port's own prefix, so that neither
runtime reads the other's variables.

Every fast-path toggle of the reference is here with its default (on), and
each selects the reference's off-branch: ``RAY_TPU_TORCH_<KNOB>=0`` before
``init`` (workers inherit the variable) turns one fast path off.

Knobs of the reference left out, each because nothing of the reference's
code reads it (its name appears only where it is defined, or as a
parameter or a word of a docstring, never as ``config.<name>``):
``actor_creation_min_workers``, ``default_max_retries``,
``get_timeout_poll_ms``, ``log_dir``, ``log_to_driver`` (a parameter of
``CoreWorker``/``connect``, not a knob read), ``max_direct_call_object_size``
(named in a docstring only), ``maximum_gcs_dead_node_cache``,
``object_store_dir``, ``object_store_eviction``, ``object_store_memory``
(a parameter of ``init``, the node daemon and the cluster launcher, not a
knob read), ``scheduler_spread_threshold``, ``task_events_max_buffer``,
``task_retry_delay_ms``, ``worker_lease_timeout_s`` and
``tpu_chips_per_host``. The reference's ``tpu_topology`` and
``tpu_worker_idle_timeout_s`` are ``gpu_topology`` and
``gpu_worker_idle_timeout_s`` here (GPUs take the place of TPU chips).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_TORCH_"


@dataclass
class _ConfigEntry:
    name: str
    default: Any
    type: type
    doc: str


class Config:
    """Singleton-style config registry with env / JSON overrides."""

    def __init__(self) -> None:
        self._entries: Dict[str, _ConfigEntry] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, doc: str = "") -> None:
        entry = _ConfigEntry(name, default, type(default), doc)
        self._entries[name] = entry
        self._values[name] = self._load_env(entry)

    def _load_env(self, entry: _ConfigEntry) -> Any:
        raw = os.environ.get(_ENV_PREFIX + entry.name.upper())
        if raw is None or raw == "":
            # Set-but-empty (`RAY_TPU_TORCH_FOO= cmd`) means unset: coercing
            # "" would crash int/float knobs and silently flip bool
            # knobs to False.
            return entry.default
        return self._coerce(entry, raw)

    def refresh_from_env(self, name: str) -> Any:
        """Re-read ``RAY_TPU_TORCH_<NAME>`` into the registry (typed) and
        return the current value. For the few knobs whose consumers
        historically honored env changes made AFTER import (address,
        store_so, usage_stats_enabled): the env, when present, wins over
        the import-time snapshot; an unset env leaves programmatic
        ``set()`` values untouched."""
        entry = self._entries[name]
        raw = os.environ.get(_ENV_PREFIX + name.upper())
        if raw is not None and raw != "":
            with self._lock:
                self._values[name] = self._coerce(entry, raw)
        return self._values[name]

    @staticmethod
    def _coerce(entry: _ConfigEntry, raw: Any) -> Any:
        if entry.type is bool:
            if isinstance(raw, bool):
                return raw
            return str(raw).lower() in ("1", "true", "yes", "on")
        if entry.type is int:
            return int(raw)
        if entry.type is float:
            return float(raw)
        return entry.type(raw)

    def get(self, name: str) -> Any:
        return self._values[name]

    def __getattr__(self, name: str) -> Any:
        # Called only when normal attribute lookup fails.
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(name) from None

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            if name not in self._entries:
                raise KeyError(f"unknown config: {name}")
            self._values[name] = self._coerce(self._entries[name], value)

    def apply_system_config(self, blob: str | Dict[str, Any]) -> None:
        """Apply a cluster-wide JSON config blob (unknown keys ignored)."""
        if isinstance(blob, str):
            blob = json.loads(blob) if blob else {}
        for k, v in blob.items():
            if k in self._entries:
                self.set(k, v)

    def dump(self) -> Dict[str, Any]:
        return dict(self._values)

    def diff_nondefault(self) -> Dict[str, Any]:
        """Knobs whose current value differs from the registered default
        — the blob a spawner ships to a child control-plane process so
        programmatic ``set()`` overrides (tests, system_config) survive
        the process boundary the way env vars do on their own."""
        return {k: v for k, v in self._values.items()
                if v != self._entries[k].default}


config = Config()
_d = config.define

# --- core worker / task submission -----------------------------------------
_d("fetch_chunk_bytes", 5 * 1024 * 1024,
   "Chunk size for node-to-node object transfer (reference uses 5 MiB, "
   "object_manager.proto / ray_config_def.h:332).")
_d("pull_max_inflight_chunks", 8,
   "Admission control: chunks in flight per pulling process across ALL "
   "concurrent pulls (reference: pull_manager.h:52 bounded pull quota). "
   "Bounds heap use to chunks * fetch_chunk_bytes on top of the arena "
   "allocation.")

# --- object store -----------------------------------------------------------
_d("zero_copy_min", 1 * 1024 * 1024,
   "Objects at or above this many bytes deserialize zero-copy out of the "
   "shm arena (read-only views, object pinned until the last view is "
   "collected); below it they are copied out before unpickling. The "
   "tradeoff: a lower threshold saves memcpy bandwidth on mid-size "
   "objects but pays pin bookkeeping (a weakref.finalize + a store "
   "refcount hold per get) and couples eviction to consumer GC — a "
   "long-lived small view can pin its slot for the life of the process. "
   "Raise it if the store thrashes on pinned slots; lower it for "
   "read-heavy numeric workloads. Env: RAY_TPU_TORCH_ZERO_COPY_MIN.")
_d("device_objects_enabled", True,
   "Treat torch.Tensor as a store object: put stages the tensor's bytes "
   "out of band, once, into the object's arena slab (JSON header + raw "
   "bytes); get rebuilds it with one copy onto the producer's device "
   "when this process has it (_private/device_objects.py); a get of a "
   "ref this process itself put returns the tensor itself. Off = "
   "torch's own pickling, the bytes in band.")
_d("store_so", "",
   "Override path of the native store library (librtpu_store.so). Used "
   "by the sanitizer harnesses (benchmarks/run_tsan_store.sh, "
   "run_asan_store.sh) to inject an instrumented build without "
   "touching the tracked one. Empty = the bundled library.")
_d("object_spilling_threshold", 0.8,
   "Store fill fraction above which sealed objects spill to disk "
   "(reference: ray_config_def.h object_spilling_threshold).")

# --- raylet / scheduling ----------------------------------------------------
_d("num_workers_soft_limit", -1,
   "Elastic ceiling of the shared CPU worker pool: queue-depth "
   "pressure grows the pool up to this many workers, and idle workers "
   "above the num_cpus base retire after worker_idle_timeout_s. "
   "-1 means num_cpus plus a small burst headroom.")
_d("worker_start_timeout_s", 30.0, "Timeout for a worker process to register.")
_d("worker_idle_timeout_s", 300.0, "Idle workers above the soft limit exit.")
_d("raylet_heartbeat_period_ms", 1000, "Node -> GCS liveness report period.")
_d("health_check_period_ms", 3000,
   "Health-check evaluation period: the death budget is threshold * this "
   "(reference: ray_config_def.h health_check_period_ms=3000).")
_d("health_check_failure_threshold", 5,
   "Missed health checks before the GCS declares a node dead "
   "(reference default 5 -> a 15s budget; a node must be silent that "
   "long while its socket stays open to be declared dead).")

# --- distributed refcounting / lineage -------------------------------------
_d("refcount_enabled", True,
   "Track ObjectRef lifetimes cluster-wide and free store memory when the "
   "last reference dies (reference: core_worker/reference_count.h:61).")
_d("refcount_flush_ms", 100,
   "Batch interval for shipping local ref-count deltas to the GCS.")
_d("free_grace_s", 1.0,
   "Seconds a zero-ref object is kept before its locations are freed "
   "(absorbs in-flight borrower registrations, e.g. a ref pickled to "
   "another process whose incref hasn't landed yet).")
_d("max_lineage_entries", 10000,
   "Task specs retained for lineage reconstruction (LRU-evicted beyond "
   "this; reconstructing evicted lineage fails cleanly as ObjectLost).")
_d("max_lineage_reconstructions", 3,
   "Times a lost object may be rebuilt by re-running its producing task "
   "(reference: object_recovery_manager.h:41 + task_manager resubmit).")

# --- local-first scheduling (node-manager lease grants) ---------------------
# Every fast path is on by default; each toggle below selects the
# reference's off-branch (RAY_TPU_TORCH_<KNOB>=0), the baseline its A/B
# tests compare with.
_d("lease_enabled", True,
   "Stream same-shape tasks directly to leased workers, bypassing the "
   "GCS scheduler on the hot path (reference: "
   "core_worker/transport/direct_task_transport.h:75 lease reuse).")
_d("local_scheduling_enabled", True,
   "Bottom-up local-first task scheduling (reference: "
   "raylet/scheduling/policy/hybrid_scheduling_policy.h:50): a caller's "
   "own node manager grants worker leases from its local free-resource "
   "ledger without touching the GCS lock; the GCS is informed "
   "asynchronously (resource deltas riding heartbeats) and is consulted "
   "synchronously only on spillback. Off = fully centralized: every task "
   "placement serializes through the GCS scheduler, and the worker-lease "
   "direct transport is disabled with it.")
_d("local_actor_creation_enabled", True,
   "Decentralized actor creation: the driver asks its OWN node manager "
   "to place eligible actors (no PG/affinity/name/GPU/runtime_env) from "
   "the node's local ledger, and the GCS learns of the placement "
   "asynchronously (actor_placed). Declines spill back to the classic "
   "GCS-scheduled creation path. Off = every actor creation serializes "
   "through the central scheduler.")
_d("local_lease_backoff_s", 1.0,
   "After the GCS signals classic-queue pressure (revoke_local_lease), "
   "the node manager declines overlapping local grants for this long so "
   "spilled-back work drains through the fair central queue first.")

# --- driver submit fast path (spec templates / batch frames / shm ring) -----
_d("submit_spec_template_enabled", True,
   "Pre-serialized task-spec templates: a RemoteFunction freezes its "
   "constant TaskSpec fields into a pickled skeleton once, and each "
   "submission patches only the variable slots (task id, args blob, "
   "submit time) into a copy of the bytes. Off = every submission "
   "builds and pickles its spec from scratch.")
_d("submit_batch_frames_enabled", True,
   "Multi-spec submit framing end-to-end: driver->GCS classic-path "
   "submissions coalesce into submit_task_batch frames of pre-pickled "
   "spec blobs, and lease-path dispatch ships lease_run_tasks_b blob "
   "batches instead of re-pickling every spec inside the frame "
   "envelope. Off = one frame per spec (submit_task / submit_tasks / "
   "lease_run_tasks).")
_d("submit_ring_enabled", True,
   "Shared-memory submit ring to the same-node node manager: classic-"
   "path, dep-free submissions become a template-patched blob appended "
   "to a per-client SPSC ring the NM drains and relays to the GCS in "
   "batches. Needs batch frames; x86-64 only. Off = the socket batch "
   "path.")
_d("submit_template_verify", False,
   "Template correctness mode: every template-patched spec blob is "
   "compared against a fresh pickle.dumps of an equivalently "
   "constructed TaskSpec and must match BYTE-FOR-BYTE (raises on "
   "mismatch). The equivalence tests turn this on; leave it off in "
   "production — it re-pays exactly the per-call cost the template "
   "exists to remove. Env: RAY_TPU_TORCH_SUBMIT_TEMPLATE_VERIFY.")
_d("submit_ring_bytes", 4 * 1024 * 1024,
   "Data capacity of the per-client submit ring. At ~200 bytes per "
   "nop-task spec blob the default holds ~20k in-flight submissions "
   "before ring-full spills to the socket path.")

# --- worker turnaround fast path (inline returns / batched completions) ----
_d("worker_inline_returns_enabled", True,
   "In-band small-object returns: a result whose framed serialization "
   "is OOB-free and at or under worker_inline_return_max skips the "
   "store put and ships as a blob inside the completion message. Off = "
   "every return pays a store put and every get() a store read.")
_d("task_done_batch_enabled", True,
   "Batched completion framing end-to-end: workers coalesce classic-"
   "path task_done notifies into task_done_batch frames of pre-pickled "
   "records (flushed the moment the worker's queue empties), the node "
   "manager relays the blobs to the GCS without unpickling, and the GCS "
   "processes the batch under one lock acquisition. Off = one task_done "
   "notify per task.")
_d("worker_inline_return_max", 8192,
   "Largest framed result (bytes) that may travel in-band. Results "
   "over it — and ALL results carrying pickle-5 out-of-band buffers "
   "(numpy, device tensors) — take the store path. 0 disables "
   "inline returns.")
_d("worker_inline_cache_bytes", 32 * 1024 * 1024,
   "Byte budget of each process's local inline-object LRU (delivered "
   "lease results + object_locations inline replies). Eviction is "
   "safe — the GCS inline table / store path serves a miss — so this "
   "only bounds driver memory, not correctness.")
_d("gcs_inline_table_bytes", 64 * 1024 * 1024,
   "Per-job byte budget of the GCS inline-object table. Pressure "
   "materializes the job's oldest inline entries into a node's object "
   "store (worker_inline_spills_total counts them); entries are "
   "dropped only after the store copy's location report confirms.")
_d("task_done_flush_slack_s", 0.002,
   "Upper bound on how long a worker may hold a finished task's "
   "completion record while its queue is non-empty (a slack-timer "
   "thread flushes past it). Within the window, back-to-back fast "
   "tasks coalesce into one completion frame; a slow successor task "
   "can delay a finished predecessor's result by at most this long. "
   "Queue-empty still flushes immediately — a lone task never waits.")

# --- driver completion ingestion fast path (absorb split / shm ring) -------
_d("completion_ring_enabled", True,
   "Shared-memory completion ring from the same-node node manager: the "
   "NM relays classic-path task_done_batch record blobs into a "
   "per-driver SPSC ring (besides the authoritative GCS relay) and the "
   "driver's consumer thread absorbs them locally, so wave get()/wait() "
   "resolves without a GCS round trip. x86-64 only. Off = the GCS path "
   "alone.")
_d("completion_absorb_enabled", True,
   "Split completion absorption from sending on the driver: leased "
   "workers ship lease_tasks_done_b frames of pre-pickled per-record "
   "blobs, the lease conn thread only parks the raw frame, and a "
   "dedicated rtpu-completion-absorb executor unpickles and absorbs. "
   "Off = workers send the lease_tasks_done dict frame and the conn "
   "thread absorbs inline.")
_d("completion_steal_enabled", True,
   "Parallel wave collection: a get()/wait() caller about to block "
   "drains the completion ingest queue on its own thread. Off = callers "
   "park on the completion event and only the absorb executor drains.")
_d("worker_completion_ring_enabled", True,
   "Worker->driver shm completion segments: a same-node leased worker "
   "appends its lease-completion record blobs directly into a "
   "per-worker SPSC segment beside the caller driver's completion ring. "
   "Needs the completion ring; x86-64 only. Off = the socket "
   "lease_tasks_done_b path.")
_d("completion_ring_bytes", 4 * 1024 * 1024,
   "Data capacity of the per-driver completion ring. At ~300 bytes "
   "per small-return completion record the default holds ~13k "
   "undrained completions before appends spill to the GCS-only path.")
_d("worker_completion_ring_bytes", 1024 * 1024,
   "Data capacity of each per-worker completion segment. At ~300 "
   "bytes per small-return completion record the default holds ~3k "
   "undrained completions per worker before appends spill to the "
   "socket path.")

# --- direct task transport (worker leases) ---------------------------------
_d("lease_pipeline_depth", 10,
   "Tasks in flight per leased worker before queueing at the caller "
   "(reference: max_tasks_in_flight_per_worker, direct_task_transport).")
_d("lease_idle_timeout_s", 2.0,
   "A leased worker idle this long is returned to the node's pool and "
   "its resources released (reference: worker lease idle return).")
_d("lease_max_workers_per_shape", 16,
   "Cap on concurrently leased workers per scheduling shape per caller.")
_d("lease_report_flush_ms", 100,
   "Batch interval for reporting lease-task completions (object "
   "locations + lineage specs) to the GCS.")

_d("worker_zygote_enabled", True,
   "Fork CPU workers from a pre-imported zygote process instead of a "
   "fresh python interpreter per spawn. GPU workers always use the "
   "classic spawn path (a CUDA context does not survive a fork). Off = "
   "every worker is spawned.")
_d("worker_zygote_count", 4,
   "Fork-servers per node manager. One zygote serializes spawns behind "
   "a single ~10-30ms fork conversation (fork of a torch-preloaded image "
   "is page-table-bound); K zygotes let an actor-churn or scale-out "
   "burst fork K workers concurrently. Each zygote is one idle "
   "pre-imported python process of resident memory — lower this on "
   "memory-tight nodes.")
_d("gpu_worker_idle_timeout_s", 300.0,
   "A GPU-bound worker parked between same-shape GPU tasks is retired "
   "after this idle time (its GPUs return to the node free list). "
   "Generous by default: re-spawning pays a torch import and CUDA init.")

# --- gang fault tolerance (collective groups / train worker gangs) ----------
_d("gang_heartbeat_s", 1.0,
   "Liveness/poison heartbeat for gang-scheduled groups: the WorkerGroup "
   "supervisor pings each member actor at this period, and every "
   "collective member polls the group coordinator's poison flag at this "
   "period (so a pending collective raises GangMemberDiedError within "
   "~2x this interval of the gang being poisoned, instead of waiting "
   "out the full collective op timeout). Env: RAY_TPU_TORCH_GANG_HEARTBEAT_S.")
_d("gang_ping_miss_limit", 30,
   "Consecutive missed liveness pings before the gang supervisor "
   "declares a wedged-but-alive member dead. Deliberately generous "
   "(30 s at the default heartbeat): a rank whose main thread is "
   "GIL-starved by a long compile or step must not be declared dead "
   "— an actor whose PROCESS died is detected within ~1 heartbeat via "
   "the GCS actor-failure notification, not this budget, so this only "
   "bounds truly wedged-alive ranks (vs the old 300 s op deadline).")
_d("gang_poll_timeout_s", 30.0,
   "Deadline for one WorkerGroup.poll() round (shared across all "
   "members; polls are submitted in parallel). A rank whose reply "
   "misses the round is treated as still running — its in-flight poll "
   "is re-awaited next round (~100ms later) so no drained report is "
   "lost — and a dead rank surfaces as state='dead' instead of "
   "aborting the whole poll batch (the supervisor owns death "
   "detection).")
_d("gang_restart_backoff_s", 0.5,
   "Base of the exponential backoff between gang re-formation attempts "
   "after a gang-member death (doubles per restart).")
_d("gang_restart_backoff_max_s", 30.0,
   "Cap on the gang re-formation backoff.")
_d("gang_poison_teardown_enabled", True,
   "On poison, after a grace of 2x the gang heartbeat with a collective "
   "still in flight, abort the wedged torch.distributed world so "
   "survivors blocked in a collective unwedge (what aborting a NCCL "
   "communicator does).")
_d("collective_op_timeout_s", 300.0,
   "Deadline for one collective operation (was a hardcoded 300 s); "
   "poisoned groups raise GangMemberDiedError long before this.")
_d("collective_rendezvous_timeout_s", 60.0,
   "Deadline for group-formation rendezvous (coordinator actor lookup, "
   "address exchange, world join).")

# --- memory monitor ---------------------------------------------------------
_d("memory_monitor_refresh_ms", 250,
   "Node memory sampling period; 0 disables the monitor "
   "(reference: memory_monitor.h:52 kMonitorIntervalMs).")
_d("memory_usage_threshold", 0.95,
   "Fraction of the node memory limit above which the worker-killing "
   "policy engages (reference: ray_config_def.h memory_usage_threshold).")
_d("memory_limit_bytes", 0,
   "Absolute node memory budget for workers+store; 0 derives it from "
   "system MemTotal. Tests set a small value to trigger OOM kills.")

# --- gcs --------------------------------------------------------------------
_d("address", "",
   "Default cluster address for init()/CLI when none is given "
   "explicitly (the RAY_TPU_TORCH_ADDRESS of the classic `ray start` "
   "workflow). Empty = start a new local cluster.")
_d("gcs_rpc_timeout_s", 60.0,
   "Bound on driver/worker -> GCS control RPCs (register, actor "
   "bookkeeping, KV, state queries). A wedged GCS then surfaces as a "
   "TimeoutError at the call site instead of a forever-parked control "
   "thread; paths with their own deadline semantics (e.g. blocking "
   "named-actor lookup) pass an explicit timeout instead.")
_d("gcs_storage", "memory", "GCS table storage backend: memory | file.")
_d("gcs_file_storage_path", "", "Path for the file storage backend.")
_d("gcs_out_of_process", False,
   "Run the GCS in its own subprocess (its own interpreter/GIL) instead "
   "of inside the head process (reference: the standalone gcs_server "
   "beside the raylet). The head node manager and the driver then talk "
   "to it purely over the protocol socket, exactly like worker nodes — "
   "GCS handler concurrency stops competing with the head NM and the "
   "driver for one GIL. Default off so unit tests don't pay a process "
   "spawn per init(); `ray_tpu_torch start --head` and the scale bench turn "
   "it on. Env: RAY_TPU_TORCH_GCS_OUT_OF_PROCESS.")
_d("gcs_bootstrap_timeout_s", 30.0,
   "How long the spawner waits for the GCS subprocess to bind its "
   "listener and write the bootstrap file (address + pid) into the "
   "session dir before declaring the launch failed.")
_d("gcs_recovery_grace_s", 10.0,
   "After a GCS restart, how long restored actors wait for their node to "
   "re-register before being treated as node-dead (restart budget applies).")

# --- observability (per-node agent) -----------------------------------------
_d("flight_recorder_events", 4096,
   "Ring-buffer capacity of the per-node flight recorder (recent task "
   "events/spans, hardware samples, worker lifecycle events). The ring "
   "auto-dumps to <session_dir>/flight_recorder/ when a worker dies "
   "unexpectedly or a gang supervisor declares slice death, so every "
   "gang restart leaves a postmortem artifact.")
_d("agent_stack_timeout_s", 5.0,
   "Bound on one cluster-wide in-band stack capture (ray_tpu_torch stack): "
   "per-worker dump_stacks RPCs are fanned out in parallel and workers "
   "that cannot answer within it are reported as errors, not waited on.")
_d("profiler_hz", 67,
   "Sampling rate of the in-process profiler (ray_tpu_torch profile): the "
   "daemon sampler thread walks sys._current_frames() this many times "
   "per second. 67 Hz is the py-spy-style default — off the 100 Hz "
   "beat of periodic loops, cheap enough to leave on (the 'profiler' "
   "toggle in benchmarks/microbench_compare.py is the overhead A/B).")
_d("profiler_max_frames", 64,
   "Frames kept per sampled stack (leaf side wins; deeper stacks get a "
   "<truncated> root marker). Bounds folded-key size under recursion.")
_d("profiler_max_stacks", 2048,
   "Distinct folded stacks held by the profiler's per-process table. A "
   "new stack arriving at a full table evicts the smallest-count entry "
   "and accounts its samples in profiler_dropped_samples_total — deep/"
   "churning workloads see a truncated-but-honest profile, never "
   "unbounded memory.")
_d("profiler_always_on", False,
   "Start the background sampler in every ray_tpu_torch process at init: "
   "the driver, the GCS, the node manager and every worker "
   "(always-available flamegraphs; `ray_tpu_torch profile` then reads a "
   "window of the running sampler instead of starting one). "
   "Env: RAY_TPU_TORCH_PROFILER_ALWAYS_ON.")

# --- gpu --------------------------------------------------------------------
_d("gpu_ids", "",
   "The GPUs the node manager assigned this worker, comma-separated "
   "(the worker's CUDA_VISIBLE_DEVICES holds the same ids); empty for a "
   "CPU worker and the driver. Set per worker at spawn; read with "
   "config.refresh_from_env. Env: RAY_TPU_TORCH_GPU_IDS.")
_d("session_dir", "",
   "The session directory of the node this worker runs on (logs, "
   "sockets, the job manager's job logs). Set per worker at spawn; read "
   "with config.refresh_from_env, since a worker forked from a zygote "
   "gets it after the config module was imported. "
   "Env: RAY_TPU_TORCH_SESSION_DIR.")
_d("gpu_topology", "",
   "Slice label of a node with GPUs (its NVLink domain): placement groups "
   "whose bundles all want GPUs try to fit inside one slice first.")

# --- tracing ----------------------------------------------------------------
_d("trace_sample_rate", 1.0,
   "Head-based span sampling for high-rate traffic: the probability "
   "that a NEW trace root (serve ingress/handle request, driver-side "
   "root span) is kept. Decided ONCE at the root and propagated with "
   "the trace context, so a trace is never half-kept; FAILURE spans "
   "(errored requests, ingress sheds) are ALWAYS emitted regardless of "
   "the decision, while routine consumer cancels sample like 'ok'. "
   "1.0 keeps everything (the default); task events themselves are "
   "never sampled out — only spans.")

# --- serve ingress (HTTP/SSE front door) ------------------------------------
_d("serve_ingress_max_inflight", 256,
   "Per-proxy concurrency budget: requests admitted past the front door "
   "and not yet answered (streams count until their last SSE frame). "
   "Arrivals beyond it wait in per-tenant queues served deficit-round-"
   "robin. Size it to what one proxy's downstream replicas can hold "
   "in flight; the watermark below bounds the waiting room.")
_d("serve_ingress_queue_watermark", 128,
   "Waiting-room high watermark: arrivals that would push the admission "
   "queue past this are SHED immediately with 429 + Retry-After "
   "(typed ServeOverloadedError) instead of building an unbounded "
   "backlog in front of saturated replicas — the graceful-saturation "
   "contract the open-loop bench measures.")
_d("serve_ingress_queue_timeout_s", 10.0,
   "Longest a request may wait in the admission queue before it is shed "
   "with 503 (it was admitted to the waiting room but never won a "
   "slot): bounds client-perceived queueing delay under sustained "
   "overload.")
_d("serve_ingress_executor_threads", 32,
   "Headroom threads of the proxy's dedicated data-plane pool (the old "
   "data path ran every request on the asyncio DEFAULT executor and "
   "exhausted it under load). The pool is sized max_inflight + this: "
   "admitted streams each hold one pump thread for their lifetime "
   "(covered by the max_inflight share), and this margin keeps "
   "short-lived calls — route resolution, stream opens, non-streaming "
   "requests — from queueing behind a full house of streams.")
_d("serve_ingress_tenant_header", "x-tenant",
   "HTTP header naming the tenant for fair admission; absent means the "
   "shared 'default' tenant.")
_d("serve_ingress_tenant_rate", 0.0,
   "Per-tenant token-bucket refill (requests/second) at the ingress; "
   "0 disables rate limiting (fairness then comes only from "
   "deficit-round-robin queue service).")
_d("serve_ingress_tenant_burst", 16.0,
   "Per-tenant token-bucket capacity (burst size) when "
   "serve_ingress_tenant_rate is set.")
_d("serve_ingress_request_timeout_s", 120.0,
   "Bound on one non-streaming proxy->handle call (maps to 503, not a "
   "parked proxy thread).")
_d("serve_ingress_stream_item_timeout_s", 120.0,
   "Bound on EACH item pull of a streaming (SSE) response; a wedged "
   "replica generator surfaces as a terminated stream, not a "
   "forever-open socket.")

_d("serve_handle_stats_rpc", False,
   "Legacy handle routing: issue two blocking stats.remote() probes per "
   "request for power-of-two choices. Default off: handles route on "
   "per-replica loads pushed over the controller's long-poll channel "
   "(plus local optimistic in-flight deltas), zero hot-path RPCs. Kept "
   "as the A/B baseline. Env: RAY_TPU_TORCH_SERVE_HANDLE_STATS_RPC.")

# --- serve fault tolerance -------------------------------------------------
_d("serve_request_max_migrations", 3,
   "How many times one admitted request may be migrated to another "
   "replica after a replica death / engine failure / drain before it is "
   "shed with a typed 503 (RequestMigrationExhaustedError). Streaming "
   "migrations rebuild the resume descriptor from tokens already "
   "delivered client-side and continue at the next token — never a "
   "duplicate, never a gap; unary calls are retried from scratch "
   "(deterministic per-request sampling keys make both bit-identical).")
_d("serve_drain_timeout_s", 10.0,
   "Rolling-restart drain budget: a draining replica stops admitting "
   "new requests and gets this long to finish its in-flight work before "
   "the controller kills it; stragglers hand off through the same "
   "migration path as a crash (client-side resume, bit-identical).")
_d("serve_kv_adopt_timeout_s", 60.0,
   "Bound on resolving a prefill->decode KV handoff in adopt_kv; "
   "expiry raises typed KVAdoptTimeoutError (dead prefill replica) so "
   "the disaggregated router re-runs prefill on a healthy replica "
   "instead of failing the request.")
_d("serve_fault_inject", "",
   "Deterministic serve-tier fault injection for tests and chaos "
   "benches, honored by the LLM engine (also settable per-engine via "
   "EngineConfig.fault_inject, which is how it reaches replica "
   "processes). 'step_error:after=N' raises from the Nth decode step "
   "(exercises _poison -> resume-descriptor migration); "
   "'die:after_tokens=N' hard-exits the process after N emitted tokens "
   "(exercises the ActorDiedError migration path). Each spec fires "
   "once per process. Empty disables.")

# --- correctness tooling ----------------------------------------------------
_d("lockdep_enabled", False,
   "Runtime lock-order witness (ray_tpu_torch._private.lockdep): wrap "
   "every threading.Lock/RLock created by ray_tpu_torch code, record the "
   "actual acquisition order per thread into a creation-site-keyed graph, "
   "and capture the witness cycle the first time an acquisition closes "
   "one (the interleaving that WOULD deadlock, caught on a run that "
   "merely inverted order). Violations are recorded, not raised. "
   "Installed at import; the GCS, node manager and workers inherit the "
   "variable. Env: RAY_TPU_TORCH_LOCKDEP_ENABLED.")

# --- logging ----------------------------------------------------------------
_d("log_follow_interval_s", 1.0,
   "Poll interval of `ray_tpu_torch logs -f` / state.get_log(follow=True): "
   "each tick re-reads every matched log file from its byte-offset "
   "cursor (tail -f semantics over the agent fan-in).")
_d("usage_stats_enabled", True,
   "Anonymous usage-stats reporting toggle "
   "(RAY_TPU_TORCH_USAGE_STATS_ENABLED=0 opts out, matching the reference's "
   "RAY_USAGE_STATS_ENABLED contract).")
