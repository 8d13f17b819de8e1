#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one H100.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build and kernel checks only
    python3 chip_smoke.py --profile  # also profile one train step of each
                                     # model and one decode step into
                                     # chiprun_out/
    python3 chip_smoke.py --seed N   # the serve run's weights and prompts
    python3 chip_smoke.py --only sharded  # phases 1-5 and 15 only
    python3 chip_smoke.py --only runtime  # phases 1-5 and 16 only
    python3 chip_smoke.py --only serve    # phases 1-5 and 17 only
    python3 chip_smoke.py --only tune     # phases 1-5 and 18 only
    python3 chip_smoke.py --only jobs     # phases 1-5 and 19 only
    python3 chip_smoke.py --only correctness  # phases 1-5 and 20 only
    python3 chip_smoke.py --only gaps     # phases 1-5 and 21 only
    python3 chip_smoke.py --only core     # phases 1-5 and 22 only
    python3 chip_smoke.py --only failures # phases 1-5 and 23 only
    python3 chip_smoke.py --only observability  # phases 1-5 and 24 only
    python3 chip_smoke.py --only pools    # phases 1-5 and 25 only

Phases, each printed on its own line, each fatal when it fails:

1. build: every ``ray_tpu_torch/csrc/*.cu``, one ``nvcc`` each, in parallel;
   then the SASS of each library (``cuobjdump``): the bf16 forward, dQ and
   dK/dV kernels must run on the tensor cores (``HGMMA``).
2. check: each flash-attention kernel against its plain PyTorch version on
   the card, both fed the same inputs in the kernel's dtype (the plain
   versions round where the kernels round): at small shapes in f32 and
   bf16, head dims 64 and 128, causal and not, a ragged length (80), q and
   k/v of different lengths (non-causal, both ways); then at the training
   shape [8, 1024, 12, 64] bf16 causal.
3. forward: GPT-2 125M at two layers, seq 256 (the shape of the JAX
   package's ``__graft_entry__.entry``), f32, flash kernels against the
   reference attention.
4. train: the main path. GPT-2 125M at full width and depth, seq 1024,
   batch 8, bf16 compute, f32 params, remat "full", AdamW(3e-4, wd 0.1) as
   ``bench.py::measure``; 2 warm-up and 5 timed steps on one seeded batch.
   The kernels' launch counts are zeroed just before and read just after.
5. time: each kernel at the training shape, its plain version, and the
   PyTorch library call of the same function where there is one (SDPA; a
   yardstick the port never calls): its forward for K1, its flash
   backend's backward op alone, on the forward's saved outputs, for K2 and
   K3 (it computes dQ, dK and dV at once).
6. moe-train: gpt2-125m-moe8 (``GPTConfig.preset("gpt2-125m",
   moe_experts=8, moe_capacity_factor=1.25, max_seq=1024,
   flash_attention=True)``, Switch top-1) at full width and depth, as
   phase 4 otherwise. The first loss against the one-hot plain MoE FFN on
   the same params and batch; the flash launches per step; prints step
   time, MFU over the 124,549,632 active params, peak memory and the share
   of tokens dropped at the first step.
7. remat: phase 4's gpt2-125m from one init and one batch under each remat
   policy ("full", "matmuls", "dots"): the same first loss and gradient
   norm, the same flash launches, and the kept tensors' memory (1.21 GB
   over 12 layers) on top of "full"'s peak.
8. moe-serve: the paged engine on gpt2-125m-moe8, bf16, 8 slots, max_len
   1024, block 16, chunk 256, prefix cache on; 16 greedy requests of
   64-512 prompt tokens from ``--seed``, 64 new tokens each, submitted at
   once. Then one decode step with half the slots idle, 3 times, each
   against the same step with the one-hot plain MoE FFN: the same tokens
   dropped (idle slots take expert capacity, as in the reference), the
   same logits, with no deterministic-algorithms switch (idle slots write
   one slot's K/V to scratch row 0, so the card's write order is moot).
9. serve-check: llama-7b widths at two layers, f32, token-exact. The paged
   engine (block 16, chunk 64) on 4 prompts of 37-300 tokens gives the
   greedy tokens of an argmax rollout by ``models.forward``; the prefix
   cache on and off gives the same tokens (two prompts share 128 tokens);
   a contended pool that preempts gives a solo engine's sampled streams;
   threefry on the card gives the CPU's bits and jax.random's.
10. serve: the serving path's main run. llama-7b at full width, 16 of
   its 32 layers (``SERVE_LAYERS``), bf16 compute, the block weights cast
   once; the paged engine with 8 slots, max_len 2048, block 16, chunk
   512, prefix cache on. 16 requests
   of 128-1024 prompt tokens (4 share a 256-token prefix), 128 new tokens
   each, all submitted at once: once to a greedy engine and once to a
   sampled one (temperature 0.8, top_k 50; the engine's temperature is
   per engine, as the reference's). Checks each prompt's chunked-prefill
   first-token logits against ``models.forward``, every budget met, every
   KV block returned; prints TTFT, decode and prefill rates, decode-step
   time, prefix-cache hits and peak memory. ``--profile`` also writes a
   profile of one decode step to chiprun_out/profile_decode_step.txt.
11. rl: RLlib's learners and rollout workers (``ray_tpu_torch/rllib``) at
   the JAX package's defaults, CartPole-v1's sizes (4 obs, 2 actions,
   hidden 64, 64) and Pendulum-v1's (3 obs, 1 action in [-2, 2], hidden
   128, 128), batches from numpy with ``--seed``: PPO (2 fragments of 200,
   minibatch 128, 4 epochs), A2C (one step, and microbatches of 128),
   IMPALA (one 200-step fragment), BC (400 rows), DQN (32 updates of 64),
   Ape-X (one weighted update of 64 rows from a prioritized shard), SAC (32
   updates of 128). Each update on the card against the CPU from the same
   state; its median ms over 5 after 2 warm-up, its kernels and copies from
   torch.profiler. Then a CartPole-v1 and a Pendulum-v1 fragment of 200
   steps with the policy on the card, against the CPU's (gymnasium's envs
   when it imports, else numpy ones with their dynamics).
12. rl-algo: RLlib's algorithms through ``config.build(device="cuda")`` on
   the in-process runtime (``ray_tpu_torch/runtime.py``), learners and
   rollout actors on the card, on the numpy CartPole and Pendulum and a
   numpy two-agent env, at the JAX package's defaults: a few ``train()``
   iterations of PPO, A2C, IMPALA, DQN and Ape-X (past
   ``learning_starts``), SAC (past ``learning_starts``), multi-agent PPO and
   BC (from JSON shards it writes first); each iteration's ms, env steps/s
   and the learner's share. One PPO and one A2C iteration on the card
   against the same iteration on the CPU from one seed (actions equal
   unless a draw is a near-tie; metrics and params to phase 11's
   tolerances); a 2-learner ``LearnerGroup`` on the card, replicas
   bit-identical after an update; a checkpoint taken on the card restored
   on the CPU with equal weights.
13. serve-app: the serving tier (``ray_tpu_torch/serve/llm``: router,
   prefill, decode and combined replicas, the KV handoff) on the in-process
   runtime, through its ``serve`` facet. (a) One KV block at llama-7b width
   and bucket 1024 ([32, 1, 1024, 32, 128], bf16 and f32) pickled with
   protocol 5, the port's device-object hook as ``reducer_override`` and a
   buffer callback: exactly one host staging copy, the bytes out of band,
   metadata under 64 KiB; rebuilt on the card and on the CPU, each bit for
   bit, with the copies' ms and GB/s. (b) Phase 9's sizes (llama-7b widths,
   two layers, f32): the combined and the disaggregated app (router, one
   prefill replica, one paged decode replica) streaming 4 prompts from 4
   client threads give the argmax rollout of ``models.forward`` (greedy)
   and a solo engine's streams (temperature 0.8, top_k 50);
   ``prefill_batch_size`` 4 (one ``prefill_slots`` run) gives batch 1's
   tokens; the first chunk is the prefill token; every adopted K/V is on
   the card and is the published tensor itself; every KV block returned.
   (c) llama-7b at full width, 16 layers, bf16: the disaggregated app
   (prefill replica with ``prefill_batch_size`` 4; decode replica paged, 8
   slots, max_len 2048, block 16) serves phase 10's 16 prompts, 128 new
   tokens each, greedy, from 16 client threads through ``generate_stream``.
   Every budget met, every KV block returned, each prompt's first-token
   logits from ``prefill_slot``'s products within ``SERVE_LOGIT_ATOL`` of
   ``models.forward``; prints TTFT p50 and p99 (the prefill token's
   arrival), decode tokens/s, publish + adopt ms a request, the prefill
   replica's batched count and peak memory.
14. gang: the gang trainer and DD-PPO over the port's collectives
   (``ray_tpu_torch/train``, ``parallel/collective.py``). (a)
   ``TorchDistTrainer`` on the in-process runtime, one rank on NCCL
   (``ScalingConfig(num_workers=1, use_gpu=True)``), trains phase 4's
   gpt2-125m, batch and AdamW for 7 steps (loss_fn, backward,
   ``train.torch.backward_allreduce``, the optimizer), reporting every step
   and checkpointing at step 3: the losses equal phase 4's (to 1e-6, or to
   phase 4's own spread between two runs in this call), the flash kernels
   launch 24/12/12 a step under the trainer, the group's allreduce (SUM,
   AVG, MAX), broadcast, allgather and reducescatter on a CUDA tensor are
   exact at world 1, and a second ``fit()`` from the checkpoint gives steps
   4-6's losses; prints the step time against phase 4's and peak memory.
   (b) Two ranks in two ``python -c`` children on the one card, each
   holding gpt2-125m from seed 0 and taking one step on its half of phase
   4's batch, the gradients averaged through a ``TorchDistGroup``: NCCL
   refuses two ranks on one device, so this world is gloo over host-staged
   f32 buckets. Against one process's step on the whole batch: the mean
   loss, the gradient norm and the params after AdamW; prints the buckets'
   time. (c) DD-PPO (``collective_backend="torch_dist"``, one member) on
   the numpy CartPole, 2 iterations on the card against the CPU from one
   seed (phase 12's tolerances and near-tie rule).

15. sharded: the slice of meshes (``ray_tpu_torch/parallel``: meshes,
   sharding rules, ring attention, the pipeline; ``models`` with ``mesh=``)
   on 4 ranks in 4 child processes sharing the card over gloo (the card
   holds one NCCL rank; ``backend="gloo"`` is explicit). Phase 4's seed,
   batch, bf16 compute, f32 params, remat "full" and AdamW(3e-4, wd 0.1),
   each rank drawing phase 4's init and keeping its shards; 2 steps a
   mesh, the second timed. (a) gpt2-125m on {fsdp 2, tp 2} with the flash
   kernels: the first loss within 1e-3 of phase 4's and the grad norm
   within 1e-3 relative, 24/12/12 launches a step on every rank, K1-K3
   against their plain versions at the local shape [4, 1024, 6, 64]; (b)
   {sp 2, tp 2} with ring attention: the same gates and no flash launch;
   (c) gpt2-125m-moe8 (phase 6) on {pp 2, ep 2}: the first loss and grad
   norm against the model run microbatch by microbatch (M = 2) in this
   process, at the same gates, and 36/18/18 launches a step (each stage's
   6 layers on 3 ticks); (d) ``graft_entry.dryrun_multichip(4)`` on the
   card (gloo) against the CPU to 1e-4. Prints each mesh's step ms (the
   median of the slowest rank's timed steps), the bytes and ms gloo moved
   a rank a step, and peak memory per rank.

16. runtime: the port's own runtime (``ray_tpu_torch.init``, its node
   manager handing each GPU worker its ``CUDA_VISIBLE_DEVICES``) on the card,
   4 CPUs and the card's GPU. (a) ``cluster_resources()["GPU"]`` is 1; a
   ``num_gpus=1`` task runs in a spawned worker (its parent is this
   process, not a zygote) that sees one device, loads the kernel library
   from ``ray_tpu_torch/_build`` and holds K1-K3 at [8, 1024, 12, 64] bf16
   causal to their plain versions under phase 2's tolerances; prints the
   worker's cold start. (b) Phase 14a's cell through ``TorchDistTrainer``
   on ``runtime=ray_tpu_torch``: the rank in a ``num_gpus=1`` worker with
   the node manager's ``CUDA_VISIBLE_DEVICES``, NCCL at world 1, phase 14a's
   gates (losses, 24/12/12 launches a step counted in the rank, the
   checkpoint at step 3 and the resume); prints the step ms beside phase
   4's and the rank's peak memory. (c) Phase 13a's bf16 KV frame (268 MB)
   put on the card by a ``num_gpus=1`` actor and got on the card here, bit
   for bit, the arena's ``device_staged_bytes`` charged with its bytes, a
   second get in the actor a local hit; prints staging and rebuild GB/s
   beside 13a's in-process numbers. (d) PPO on the numpy CartPole with its
   learner on the card in the same ``num_gpus=1`` actor and two rollout
   workers in CPU processes: one iteration against the in-process runtime's on the
   CPU (phase 12's tolerances and near-tie rule); prints each iteration's
   ms, env steps/s and the learner's share beside phase 12's PPO.

17. serve-plane: the serve control plane (``ray_tpu_torch/serve``: the
   controller reconciling replica actors, handles routing on pushed loads,
   the ``asyncio`` HTTP/SSE ingress with admission) on the port's own
   runtime, 4 CPUs and the card's GPU: ``serve.start(http_port=<free
   port>)``, then ``serve.run(build_llm_app(..., runtime=ray_tpu_torch,
   mode="combined", ray_actor_options={"num_gpus": 1}))``, the engine in a
   GPU replica actor of its own process; the controller, the proxy and
   the router take no GPU. (a) 13(b)'s sizes: every prompt over HTTP
   unary, HTTP SSE and the handle's ``generate_stream``, 4 client threads
   each, gives the argmax rollout of ``models.forward`` (greedy) and a
   solo engine's streams (temperature 0.8, top_k 50); every KV block
   returned. (b) llama-7b at full width, 16 layers, bf16, 13(c)'s engine
   config: phase 10's 16 prompts from 16 client threads over HTTP SSE, then
   through the handle; 13(c)'s gates (every budget met, every token in the
   vocabulary, every KV block returned, first-token logits within
   ``SERVE_LOGIT_ATOL`` of ``models.forward``, and each served first
   token forward's argmax where that is clear); prints the replica's cold
   start, TTFT p50/p99 and output tokens/s on both paths, the replica's
   peak memory read in the actor, the ingress's admitted and shed counts,
   and 13(c)'s in-process numbers of this call beside them. (c) At (a)'s
   size, the GPU replica is killed: the controller replaces it through the
   GCS's ``actor_state`` push, the replacement waits for the freed GPU,
   and the next requests over HTTP give (a)'s greedy tokens; prints the
   time from the kill to the replacement's first answer.

18. tune: the autoscaler, ``ray_tpu_torch.data`` and ``ray_tpu_torch.tune``
   on the port's own runtime. ``cluster_launcher.launch_cluster`` of a plain
   dict starts a head of 4 CPUs and no GPU, and a ``local_process`` provider
   with one node type, ``gpu_host`` ({CPU 2, GPU 1}, 0 to 1 workers, idle
   timeout 5 s, a reconcile every second); this process joins with
   ``init(address=...)``. (b) Phase 4's seeded tokens become a dataset:
   ``from_numpy``, one row per sequence, repeated for 5 steps,
   ``map_batches`` cutting inputs and targets; a ``random_shuffle(seed=0)``
   of it is a permutation of its rows. (a) A ``num_gpus=1`` task makes the
   autoscaler launch exactly one ``gpu_host`` node, a ``node_daemon``
   process of its own: the task runs there with
   ``CUDA_VISIBLE_DEVICES=0`` and holds K1-K3 at [8, 1024, 12, 64] bf16
   causal to their plain versions with phase 2's errors, bit for bit; prints
   the time from the demand to the node's registration and from submit to
   the task's first line. (c) ``Tuner`` over a ``TorchDistTrainer``
   (``runtime=ray_tpu_torch``, one NCCL rank, the dataset as ``"train"``)
   sweeps lr over {3e-4, 1e-3} with ``PlacementGroupFactory([{CPU 1},
   {CPU 1, GPU 1}])``: each trial runs phase 4's gpt2-125m step (2 warm-up,
   3 timed) on the batches its rank reads from
   ``get_dataset_shard("train")``, each equal to phase 4's batch; both
   trials on the autoscaled node, one after the other; the lr 3e-4 trial's
   losses are phase 4's first five within 16b's tolerance and the lr 1e-3
   trial's first loss is phase 4's; 24/12/12 launches a step in each rank,
   none here; ``get_best_result`` is the trial of the lower last loss.
   Prints each trial's cold start, median step ms beside phase 4's and the
   rank's peak memory. (d) The idle node goes within 5 + 15 s of the last
   trial's end: ``cluster_resources()`` has no GPU left and only the head
   is alive; prints that time.

19. jobs: the way a user drives the port's cluster. (a) ``python -m
   ray_tpu_torch start --head --num-cpus 4 --num-gpus 1`` in a subprocess
   (its files and sessions in a temporary TMPDIR), then ``status`` and
   ``list nodes`` show one GPU; this process joins and starts the
   dashboard head (``start_dashboard``), whose ``/api/nodes`` shows
   ``gpus_total`` 1. (b) ``JobSubmissionClient`` submits a driver script
   written here: in its own process (no GPU of its own, no worker
   variables, ``RAY_TPU_TORCH_ADDRESS`` set) it runs ``workflow.run`` on a
   DAG of ``num_gpus=1`` tasks: ``init`` draws phase 4's state, ``train``
   takes steps 0-2, ``train`` takes steps 3-6 and raises once after them;
   each returns the state (params and AdamW moments, 1.5 GB) as CPU
   tensors, which the workflow checkpoints. The script sees FAILED, calls
   ``workflow.resume`` and prints its results; read from
   ``get_job_logs``, they must show the job SUCCEEDED, ``init`` and the
   first ``train`` run once, the 7 losses phase 4's within 16b's
   tolerance, and 24/12/12 flash launches counted inside each step. While
   the first ``train`` holds its state on the card (it waits for this
   phase's probes), the dashboard's ``/api/tasks`` lists the GPU tasks,
   ``/api/profile?duration_s=2&format=folded`` has stacks of that worker,
   and ``/metrics`` serves the GPU gauges (1 total, 0 free). (c) A
   ``util.client.ClientServer`` here and a thin client in a process with
   ``CUDA_VISIBLE_DEVICES=""``: its ``num_gpus=1`` task holds K1-K3 at [8,
   1024, 12, 64] bf16 causal to their plain versions with phase 2's
   errors, bit for bit. (d) ``python -m ray_tpu_torch stop``: no process
   of the session is left, and the card's free memory is back to what it
   was before (a). Prints the phase's parts: head start, job start, each
   node's start, the resume, the thin client, stop.

20. correctness: the port's correctness tooling on its torch-free
   control plane. (a) ``python -m ray_tpu_torch._private.lint --json`` in
   a fresh interpreter: no violation, no stale baseline entry, and torch,
   jax and ``ray_tpu`` never loaded; prints its time. Then phase 19's
   ``start --head`` and ``stop``, timed, and the GCS child's and the
   head's RSS, neither process mapping torch; printed beside 14.47 s,
   11.09 s and 4,554 MiB, the same head's when each of these
   interpreters imported torch. (b) The port's runtime (4 CPUs, the
   card's GPU, the GCS in a process of its own) with
   ``RAY_TPU_TORCH_PROFILER_ALWAYS_ON=1`` and
   ``RAY_TPU_TORCH_SUBMIT_TEMPLATE_VERIFY=1``: one sampler in this
   process while up, none after ``shutdown``. Phase 4's step in a
   ``num_gpus=1`` task: 24/12/12 launches a step counted there, the
   losses phase 4's within 16b's tolerance; while it steps on, ``python -m
   ray_tpu_torch profile --duration 2`` reads a window of the running
   sampler of every process (the GCS, the node manager, both drivers,
   every live worker; none starts one), and the GPU worker's stacks hold
   the step's frames. Then 1,000 small tasks through the template path,
   every blob equal to a fresh pickle of its spec. Prints the step's
   median ms with both modes on beside 16b's and phase 4's, and in the
   GPU task blocks of 5 steps with the sampler running, stopped, stopped,
   running.

21. gaps: the port runtime's last gaps (4 CPUs, the card's GPU). 16a's GPU
   task first, its K1-K3 errors phase 2's. (a) Donation: a ``num_gpus=1``
   task makes 13a's bf16 KV frame (268 MB) on the card from its seed,
   keeps it in a module global and returns it with
   ``_donate_result=True``; here it is got on the card bit for bit; a
   follow-up ``num_gpus=1`` task in the same worker (same pid, or the
   phase fails) sees the kept tensor's storage at 0 bytes and
   ``torch.cuda.memory_allocated()`` at least the frame's size below the
   same probe after the same run without donation. Prints the staging
   GB/s (the task's return to the ref's readiness) beside 16c's. (b) The
   death push: 16b's trainer cell with ``FailureConfig(max_failures=1)``;
   after the step-3 checkpoint reached the run directory the rank's
   process is SIGKILLed; the gang error carries the GCS's death cause
   ("actor worker died") within one gang heartbeat plus 3 s; the trainer
   re-forms on the freed GPU from the checkpoint; every step's loss is
   phase 4's within 16b's tolerance, with 24/12/12 launches a step counted
   in the rank before and after the kill. Prints the time to detection, to
   the re-formed loop and the step ms beside phase 4's. (c) The
   off-switches: a fresh ``init`` with every fast-path toggle off through
   ``RAY_TPU_TORCH_*`` variables: 16a's GPU task gives phase 2's K1-K3
   errors bit for bit, 16b's trainer phase 4's losses with 24/12/12
   launches a step. Prints the GPU task's cold start and the step ms with
   the toggles on and off.
22. core: the runtime core's GPU paths, twins of the reference's tests of
   its API, objects and scheduling; every GPU task holds K1-K3 against
   their plain versions at the training shape, to phase 2's errors. (a)
   Worker reuse: three ``num_gpus=1`` probes (16a's task) one after
   another on a fresh runtime (4 CPUs, the card's GPU, a 1 GiB store);
   the 2nd runs in the 1st's pid with its
   ``CUDA_VISIBLE_DEVICES``, the 3rd (``runtime_env`` env var ``MARK``) in
   a fresh pid. Prints each probe's ``spawn_ms``, reused against cold. (b)
   A ``num_gpus=1, num_returns="dynamic", max_retries=2`` generator yields
   K1's (O, LSE) for 4 seeded inputs at [96, 1024, 64] bf16 causal; its
   first attempt SIGKILLs itself after the 2nd yield (a marker file in the
   session directory tells the attempts apart); the 4 yields equal the
   driver's own K1 bit for bit (within phase 2's tolerances, said so, if
   the kernels are not bit-deterministic run to run). Prints kill -> last
   yield. (c) A two-node ``cluster_utils.Cluster`` (head and worker node
   of {CPU 2, GPU 1} each, both naming the card): a K1-K3 task (O, dQ, dK,
   dV, 12.6 MB each) and a base -> double chain of GPU tasks, pinned to the
   worker node; got on the head (a chunked pull at 5 MiB chunks: prints
   its GB/s and the head store's peak); the head's pulled copies dropped
   from its store and the worker node removed; each got again within
   120 s, rebuilt on the head's GPU from its lineage, equal to the first
   get. Prints kill -> value for each. (d) 6 of 13a's frames (268 MB each,
   seeds 13-18) put from the card into a 1 GiB store: the node manager
   spills; each comes back on the card bit for bit; a ``num_gpus=1`` task
   given a spilled frame returns its checksum; ``device_staged_bytes`` is
   charged once a put and not again on a restore. Prints the spill and
   restore GB/s. (c) runs first; (d) on (a)'s runtime after (b), its
   task in the GPU worker (b)'s retry left; that runtime stays up for
   phase 23's (a) and (b). Each kernel row of the ``{"kernels": ...}``
   line gets the phase's launches in its GPU tasks as ``core_launches``.
23. failures: the runtime's fast paths and failure paths with a GPU, twins
   of the reference's fast-path, GCS fault-tolerance and OOM tests. (a)
   Phase 22's runtime (its 1 GiB store aside), still up, with every knob
   at its default: 64 ``num_gpus=1`` tasks, each K1 on its own seeded
   [96, 1024, 64] bf16 causal input (seeds 0-63) returning the f64 sum of
   its LSE, all in one reused GPU worker (the one 22b's retry left warm),
   every sum the driver's own K1 bit for bit; the results come
   back inline (the GCS's inline entries rise by 64, the store's objects
   do not); then a task returning K1's (O, LSE) as CUDA tensors takes the
   store path (in the store, no inline entry, ``device_staged_bytes`` up
   by exactly its bytes) and comes back on the card bit for bit. Prints
   the burst's tasks/s. (b) On the same runtime: the warm GPU worker's
   host RSS from the node manager's sampler (torch and the CUDA context
   included); ``memory_limit_bytes`` set to the node's usage plus 1 GiB
   at the default threshold; a ``num_gpus=1, max_retries=1`` task whose
   first attempt holds 2 GiB of host memory (a marker in the session
   directory tells the attempts apart) is killed by the memory monitor
   (``oom_kills`` up by 1), its retry's sum is the driver's K1 bit for bit,
   and the node's ``gpus_free`` is 1 after: the GPU was freed once.
   Prints kill -> result. (c) A GCS subprocess with durable storage and one
   node {CPU 2, GPU 1}: a ``num_gpus=1`` actor holding phase 4's train
   state takes 2 steps, the GCS is SIGKILLed and restarted on its port and
   storage, the actor takes 2 more; the 4 losses are phase 4's first 4
   (within 1e-6; bit for bit said so), 24/12/12 launches a step in the
   actor; after the node rejoined the GCS shows the GPU held, a
   ``num_gpus=1`` probe stays pending 3 s while the actor lives and, once
   it is killed, runs K1 = the driver's bit for bit. Prints kill -> rejoin
   and kill -> the next step. Each kernel row gets the phase's launches in
   its GPU tasks and actor as ``failures_launches``.
24. observability: tracing, the profiler, logs, metrics, the flight
   recorder and runtime envs with a GPU worker, twins of the reference's
   observability and runtime-env tests. One runtime {CPU 2, GPU 1}, log
   streaming on, the dashboard on a free port. (a) A driver span wraps a
   ``num_gpus=1`` task that runs K1 on phase 23's input shape (seed 24),
   times it with CUDA events and calls a CPU actor's method: one trace id
   over the three spans, parented driver -> task -> method, the chrome
   export connects them (two flow pairs), the task's span outlasts its
   K1, its LSE sum is the driver's K1 bit for bit. (c) The task prints a
   marker with the card's name, which reaches the driver's stdout with
   the worker's prefix and ``get_log(follow=True)``; a user ``Counter``
   it increments shows its sum on ``/metrics``. (b) The same worker builds
   phase 4's train state and steps on phase 4's batch while a 2 s
   ``state.profile`` window covers the cluster: every process kind is in
   it, the GPU worker's stacks hold the flash ``autograd.Function`` and
   the model's ``_attention``, its first 7 losses are phase 4's (phases
   16b and 18c's gate); while it holds the GPU the node's hardware sample
   and ``/metrics`` read ``gpus_total`` 1 and ``gpus_free`` 0, and 1
   after. Prints the samples and the step ms with the window on and off.
   (d) The same worker, looping K1, is SIGKILLed: a ``flight-*.json``
   dump appears in the session's ``flight_recorder`` holding its task
   events and an ``hw_sample``, and ``gpus_free`` is 1 again (the GPU
   freed once). Prints kill -> dump. (e) A ``num_gpus=1`` task with a
   ``working_dir``, a ``py_modules`` module that calls K1, ``env_vars``
   and ``pip`` with a wheel built here (installed with ``--no-index``):
   a new process in the env's venv, its cwd, variable, wheel version and
   module as set, CUDA visible, its LSE sum the driver's K1 bit for bit.
   Prints its cold start. Two GPU workers in all. Each kernel row gets
   the phase's launches in its GPU tasks as ``observability_launches``.
   The runtime stays up for phase 25's Ape-X.
25. pools: the two paths of the mirrored tests that reach a GPU and that
   no earlier phase drives, at full width. (b) Ape-X as
   ``tests/test_apex.py::test_apex_end_to_end`` configures it (buffer
   8000, learning starts 200, batch 32, 8 SGD iterations, 2 replay shards,
   fragments of 100, 2 rollout workers) on phase 24's runtime: the shards
   and the workers CPU actors, the learner on the card in this process; 4
   iterations hold that test's assertions. Prints each iteration's ms,
   and learner updates/s and env steps/s over the iterations after the
   first (which starts the actors). (a) Then ``GpuPoolProvider`` over
   ``FakeGpuCloud`` and a ``cluster_utils.Cluster`` whose head has no GPU:
   a placement group of one ``{"GPU": 1}`` bundle makes the autoscaler
   launch one pool {CPU 2, GPU 1, hosts 1} (the card); its host registers
   with the pool's ``slice`` label; a ``num_gpus=1`` task in the bundle
   runs K1 on phase 2's inputs at [96, 1024, 64] bf16 causal on that host
   against ``flash_forward_plain`` under phase 2's bf16 tolerances, with
   phase 2's error; once the group is removed the idle pool is deleted
   and the cluster's GPUs are 0.
   Prints demand -> pool active, placement group ready, the task's cold
   start and idle -> deleted. Each kernel row gets the task's launches as
   ``pool_launches``.

Every process the script starts keeps the bytecode it compiles under
``ray_tpu_torch/_build/pycache`` (``cache_bytecode``): the card's machine
writes none, and each torch import compiled torch again.

After the phases, ``phase seconds:`` gives each phase's wall seconds and
``gpu cold starts:`` the GPU workers of the port started in each (every
process of ``ray_tpu_torch._private.worker_main`` spawned for a GPU,
counted from ``/proc``).

The last two lines are the card's name and power limit, as nvidia-smi
prints them, and ``{"ok": true, "device": {...}}``. Without a CUDA card the
script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense): the least time a kernel could
# take is the larger of bytes / memory rate and operations / peak rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Training shape of the main path: batch 8, seq 1024, 12 heads of 64.
B, L, H, D = 8, 1024, 12, 64
WARMUP_STEPS, TIMED_STEPS = 2, 5
# Seeds on which phase 2 and 25a hold K1 alone at that shape, beside phase
# 2's seed 0 (25 is the one whose O first showed P's rounding flips).
K1_SEEDS = (25, 26, 27)

SOURCE = "ray_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "ray_tpu/ops/flash_attention.py:47",
    "flash_bwd_dq": "ray_tpu/ops/flash_attention.py:132",
    "flash_bwd_dkv": "ray_tpu/ops/flash_attention.py:175",
}
# The design each kernel runs on the main path (bf16).
DESIGN = {"flash_fwd": "wgmma+tma", "flash_bwd_dq": "wgmma+tma",
          "flash_bwd_dkv": "wgmma+tma"}


def log(msg: str) -> None:
    print(msg, flush=True)


def cache_bytecode() -> str:
    """Let every process this script starts keep the bytecode it compiles,
    under the checkout's build directory. The card's machine sets
    ``PYTHONDONTWRITEBYTECODE=1`` and its torch has no ``__pycache__``, so
    each process that imports torch compiled its sources again: about 8 of
    the 10 s of every GPU worker's cold start. With
    ``PYTHONPYCACHEPREFIX`` the first import writes the cache and the later
    ones read it; this process's own later imports write it too."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ray_tpu_torch", "_build", "pycache")
    os.makedirs(path, exist_ok=True)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = path
    sys.dont_write_bytecode = False
    sys.pycache_prefix = path
    return path


class GpuColdStarts:
    """Counts the port's GPU workers as they start, whatever session or
    cluster spawns them: every 0.1 s a thread lists the processes of this
    host that run ``ray_tpu_torch._private.worker_main`` with
    ``RAY_TPU_TORCH_GPU_IDS`` in their environment (the node manager sets
    it on a worker it spawns for GPUs only), each by pid and start tick. A
    worker lives seconds at least (torch's import alone takes 6-10 s), so
    none is missed. ``take()`` returns the count since its last call."""

    def __init__(self):
        import threading

        self.seen, self.counted = set(), 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gpu-cold-starts")
        self._thread.start()

    def _poll(self):
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    if b"ray_tpu_torch._private.worker_main" not in f.read():
                        continue
                with open(f"/proc/{pid}/environ", "rb") as f:
                    if b"\0RAY_TPU_TORCH_GPU_IDS=" not in b"\0" + f.read():
                        continue
                with open(f"/proc/{pid}/stat") as f:
                    start = int(f.read().rsplit(")", 1)[1].split()[19])
            except (OSError, ValueError, IndexError):
                continue
            self.seen.add((int(pid), start))

    def _run(self):
        while not self._stop.is_set():
            self._poll()
            self._stop.wait(0.1)

    def take(self) -> int:
        self._poll()
        n, self.counted = len(self.seen) - self.counted, len(self.seen)
        return n

    def stop(self):
        self._stop.set()
        self._thread.join()


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def kernel_label(mangled: str):
    """"flash_fwd_wgmma_kernel<64,128>" or "flash_fwd_kernel<64>" for a
    mangled kernel name of csrc/flash_attention.cu, else None."""
    # The name follows its length, after the namespaces'.
    m = re.search(r"\d(flash_[a-z0-9_]*?_kernel)I((?:Li\d+E)+)E", mangled)
    if not m:
        return None
    return f"{m[1]}<{','.join(re.findall(r'Li(\d+)E', m[2]))}>"


def ptxas_summary(build_log: str) -> str:
    """Registers and spills of each kernel in ``nvcc -Xptxas -v`` output,
    as "kernel<args> regs/spill-store-bytes"."""
    out, kernel, spill = [], None, "?"
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = kernel_label(m[1])
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m[1]
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append(f"{kernel} {m[1]}r/{spill}B")
            kernel = None
    return " ".join(out)


def hgmma_counts(lib) -> dict:
    """kernel label -> number of HGMMA (wgmma) instructions in its SASS,
    from ``cuobjdump --dump-sass`` beside nvcc."""
    from ray_tpu_torch.ops import _kernels

    tool = os.path.join(os.path.dirname(_kernels.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, label = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            label = kernel_label(m[1])
            if label:
                counts[label] = 0
        elif label and "HGMMA" in line:
            counts[label] += 1
    return counts


def check_tensor_cores(lib) -> None:
    """The bf16 forward, dQ and dK/dV kernels (every head dim) must contain
    HGMMA; prints each kernel's count."""
    counts = hgmma_counts(lib)
    log("sass HGMMA: " + " ".join(f"{k} {v}" for k, v in sorted(
        counts.items())))
    for name in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel"):
        got = {k: v for k, v in counts.items() if k.startswith(name + "<")}
        if len(got) != 2 or not all(got.values()):
            raise AssertionError(f"sass: {name} lacks HGMMA or a head dim: "
                                 f"{got}")


def close(name, got, want, atol, rtol, slack=None) -> float:
    """Assert |got - want| <= atol + rtol |want| (+ ``slack``, a bound of
    the same shape) elementwise (all in f32); return the largest absolute
    difference."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    allowed = atol + rtol * want.abs()
    if slack is not None:
        allowed = allowed + slack
    excess = (err - allowed).max().item()
    if excess > 0:
        raise AssertionError(f"{name}: max |diff| {err.max().item():.3e} "
                             f"over atol {atol} + rtol {rtol}")
    return err.max().item()


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version on the same inputs.


def kernel_inputs(bh, lq, lk, d, dtype, seed):
    """q, k, v, dO: [bh, lq, d], [bh, lk, d] twice, [bh, lq, d]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, l, d, generator=gen, device="cuda").to(dtype)
            for l in (lq, lk, lk, lq)]


def p_round_slack(fa, q, k, v, kw, p_round):
    """The bound on |K1's O - its plain version's| that P's rounding
    allows, elementwise: both round each P element to bf16 from f32 values
    that differ in the last bits, so it may land an ulp apart (at most
    ``p_round`` = 2^-7 of the element), and O moves by at most
    ``p_round`` (softmax(Q K^T) |V|), computed here in f32. None when P is
    not rounded (f32)."""
    if not p_round:
        return None
    return p_round * fa.flash_forward_plain(
        q.float(), k.float(), v.float().abs(), **kw)[0]


def check_k1(fa, seed, tol_out, tol_row, p_round, **_):
    """K1 alone at the training shape on ``seed``'s inputs against
    ``flash_forward_plain``: its largest abs error over O and lse."""
    q, k, v, _ = kernel_inputs(B * H, L, L, D, torch.bfloat16, seed)
    kw = dict(scale=D ** -0.5, causal=True)
    o, lse = fa.flash_forward(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_forward_plain(q, k, v, **kw)
    slack = p_round_slack(fa, q, k, v, kw, p_round)
    torch.cuda.synchronize()
    tag = f"seed {seed}"
    return max(close(f"K1 O {tag}", o, o_ref, *tol_out, slack=slack),
               close(f"K1 lse {tag}", lse, lse_ref, *tol_row))


def check_kernels(fa, bh, lq, lk, d, dtype, causal, tol_out, tol_row,
                  tol_grad, p_round=0.0, seed=0, outputs=None):
    """Run the three kernels on q of [bh, lq, d] and k, v of [bh, lk, d] in
    ``dtype``; compare with the plain versions on the same tensors (they
    compute in f32 and round where the kernels round). The backward kernels
    get the plain forward's lse and delta, so each kernel is held to its own
    arithmetic; O's bound adds ``p_round_slack``. Returns the kernels'
    largest abs errors; the kernels' own outputs go into ``outputs`` when
    it is a dict."""
    q, k, v, do = kernel_inputs(bh, lq, lk, d, dtype, seed)
    scale = d ** -0.5
    kw = dict(scale=scale, causal=causal)

    o_ref, lse_ref = fa.flash_forward_plain(q, k, v, **kw)
    o, lse = fa.flash_forward(q, k, v, **kw)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq_ref = fa.flash_backward_dq_plain(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = fa.flash_backward_dkv_plain(q, k, v, do, lse_ref, delta,
                                                 **kw)
    dq = fa.flash_backward_dq(q, k, v, do, lse_ref, delta, **kw)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse_ref, delta, **kw)
    torch.cuda.synchronize()

    lens = lq if lq == lk else f"{lq}/{lk}"
    tag = f"{dtype} [{bh}, {lens}, {d}] causal={causal}"
    err_o = close(f"O {tag}", o, o_ref, *tol_out,
                  slack=p_round_slack(fa, q, k, v, kw, p_round))
    err_lse = close(f"lse {tag}", lse, lse_ref, *tol_row)
    err_dq = close(f"dQ {tag}", dq, dq_ref, *tol_grad)
    err_dk = close(f"dK {tag}", dk, dk_ref, *tol_grad)
    err_dv = close(f"dV {tag}", dv, dv_ref, *tol_grad)
    log(f"check ok {tag}: max |diff| O {err_o:.3e} lse {err_lse:.3e} "
        f"dQ {err_dq:.3e} dK {err_dk:.3e} dV {err_dv:.3e}")
    if outputs is not None:
        outputs.update(o=o, lse=lse, dq=dq, dk=dk, dv=dv)
    return {"flash_fwd": max(err_o, err_lse), "flash_bwd_dq": err_dq,
            "flash_bwd_dkv": max(err_dk, err_dv)}


# ---------------------------------------------------------------------------
# Phase 5: timing with CUDA events, L2 flushed before every call.


def time_ms(fn, iters, warmup=2):
    """Median device time of ``fn`` in ms. Each call runs between two
    events after a 256 MB write that evicts the 50 MB L2, as the training
    step leaves it cold for the attention kernels."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(kernel, bh, l, d, dtype, causal):
    """(least ms on an H100 SXM, "bytes" or "operations") for one launch:
    each input read once, each output written once; operations are the
    matrix products over the (q, k) pairs the causal mask keeps."""
    pairs = bh * (l * (l + 1) // 2 if causal else l * l)
    seq = bh * l * d * torch.finfo(dtype).bits // 8   # one [BH, L, D] tensor
    row = bh * l * 4                                  # one f32 [BH, L]
    flops, nbytes = {
        # S = QK^T, O = PV; reads q, k, v; writes o, lse
        "flash_fwd": (4 * d * pairs, 4 * seq + row),
        # S, dP = dO V^T, dQ = dS K; reads q, k, v, dO, lse, delta; writes dQ
        "flash_bwd_dq": (6 * d * pairs, 5 * seq + 2 * row),
        # S, dP, dV = P^T dO, dK = dS^T Q; writes dK, dV
        "flash_bwd_dkv": (8 * d * pairs, 6 * seq + 2 * row),
    }[kernel]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_backward(q4, k4, v4, do4):
    """The ms of SDPA's backward alone at the training shape: the
    flash backend's forward op once, then its backward op on the saved
    outputs, timed as ``time_ms`` times the port's kernels. The grads are
    held against autograd's through ``scaled_dot_product_attention``, so
    the op timed is the one SDPA's backward runs."""
    aten = torch.ops.aten
    scale = D ** -0.5
    fwd = aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, True, False, scale=scale)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]

    def backward():
        return aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, out, lse, cum_q, cum_k, max_q, max_k, 0.0,
            True, seed, offset, scale=scale)

    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q4, k4, v4))
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                        scale=scale)
    want = torch.autograd.grad(og, (qg, kg, vg), do4)
    errs = [close(f"sdpa backward op {name}", g, w, 2e-2, 1e-2)
            for name, g, w in zip(("dq", "dk", "dv"), backward(), want)]
    ms = time_ms(backward, iters=20)
    log(f"sdpa backward op: flash backend's, max |diff| against autograd's "
        f"dq, dk, dv {errs}; {ms:.4f} ms")
    return ms


def time_kernels(fa):
    """Kernel, plain and library times at the training shape."""
    bh, dtype, causal = B * H, torch.bfloat16, True
    q, k, v, do = kernel_inputs(bh, L, L, D, dtype, seed=1)
    kw = dict(scale=D ** -0.5, causal=causal)
    o, lse = fa.flash_forward(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta)
    fns = {
        "flash_fwd": (lambda: fa.flash_forward(q, k, v, **kw),
                      lambda: fa.flash_forward_plain(q, k, v, **kw)),
        "flash_bwd_dq": (lambda: fa.flash_backward_dq(*bwd, **kw),
                         lambda: fa.flash_backward_dq_plain(*bwd, **kw)),
        "flash_bwd_dkv": (lambda: fa.flash_backward_dkv(*bwd, **kw),
                          lambda: fa.flash_backward_dkv_plain(*bwd, **kw)),
    }
    times = {}
    for name, (kernel, plain) in fns.items():
        times[name] = {"ms": time_ms(kernel, iters=20),
                       "plain_ms": time_ms(plain, iters=5)}

    # Yardsticks: PyTorch's fused attention on the same values, [B, H, L, D]
    # views of the [BH, L, D] tensors. Its forward computes what flash_fwd
    # does. Its backward computes dQ, dK and dV at once, which neither
    # backward kernel does alone: it is the yardstick of K2 + K3, timed as
    # they are, by calling the flash backend's backward op on the saved
    # outputs of its forward between the two events (no autograd engine on
    # the host in the window).
    q4, k4, v4, do4 = (x.view(B, H, L, D) for x in (q, k, v, do))
    times["flash_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        iters=20)
    sdpa_bwd = sdpa_backward(q4, k4, v4, do4)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        times[name]["library_ms"] = sdpa_bwd
    for name in times:
        times[name]["bound_ms"], times[name]["bound_by"] = bound(
            name, bh, L, D, dtype, causal)
    return times, sdpa_bwd


# ---------------------------------------------------------------------------
# Phases 3 and 4: the model.


def check_forward(tm):
    """GPT-2 125M widths at 2 layers, seq 256, f32: the flash-kernel path
    against the reference-attention path on the same weights."""
    cfg = tm.GPTConfig.preset("gpt2-125m", n_layers=2, max_seq=256,
                              dtype=torch.float32, flash_attention=True)
    params = tm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256))).cuda()
    with torch.no_grad():
        logits = tm.forward(params, tokens, cfg)
        ref = tm.forward(params, tokens,
                         dataclasses.replace(cfg, flash_attention=False))
    err = close("forward logits", logits, ref, 2e-4, 0.0)
    log(f"forward ok: logits {tuple(logits.shape)} f32, flash vs reference "
        f"attention max |diff| {err:.3e} (atol 2e-4)")


def train_batch(vocab: int):
    """The seeded batch of the training phases: [B, L] inputs and targets."""
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, vocab, (B, L + 1))).cuda()
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def new_state(tm, cfg, lr=3e-4):
    """Fresh params from seed 0 on the card and AdamW(lr, wd 0.1), as
    ``bench.py::measure`` (lr 3e-4)."""
    opt = functools.partial(torch.optim.AdamW, lr=lr, weight_decay=0.1)
    return tm.make_train_state(
        cfg, opt, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")


class Run(NamedTuple):
    losses: list
    grad_norm: float    # of the first step
    times: list         # seconds per step
    launches: dict      # flash kernel -> launches over the run
    peak: int           # bytes allocated at most during the steps

    @property
    def step_ms(self) -> float:
        return statistics.median(self.times[WARMUP_STEPS:]) * 1e3


def run_steps(fa, state, step, batch, label, n_layers,
              first=contextlib.nullcontext):
    """WARMUP_STEPS + TIMED_STEPS steps on one batch, step 0 inside
    ``first()``, the flash kernels' counts zeroed before and read after.
    Fails unless the losses are finite and fall and each step launched the
    flash forward twice per layer (the forward, then remat's recompute)
    and dQ and dK/dV once each."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, times, gnorm = [], [], None
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        with first() if i == 0 else contextlib.nullcontext():
            state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())   # waits for the step
        times.append(time.perf_counter() - t0)
        if i == 0:
            gnorm = metrics["grad_norm"].item()
    launches = {k.symbol.removeprefix("rtt_"): k.launches for k in fa.KERNELS}
    steps = WARMUP_STEPS + TIMED_STEPS
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall {losses}")
    want = {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers,
            "flash_bwd_dkv": n_layers}
    for name, per_step in want.items():
        if launches[name] != per_step * steps:
            raise AssertionError(f"{label}: {name} launched {launches[name]}"
                                 f" times in {steps} steps, want "
                                 f"{per_step} per step")
    return Run(losses, gnorm, times, launches,
               torch.cuda.max_memory_allocated())


def log_run(label, run, n_params, tokens_per_param=6):
    """The step time, tokens/s, MFU (``tokens_per_param`` x params FLOPs a
    token at 989 TFLOP/s) and peak memory of ``run``."""
    tokens_per_s = B * L / (run.step_ms / 1e3)
    mfu = tokens_per_s * tokens_per_param * n_params / PEAK_FLOPS[
        torch.bfloat16]
    log(f"{label} step_ms {run.step_ms:.2f} (median of {TIMED_STEPS}; all "
        f"{[round(t * 1e3, 2) for t in run.times]}), tokens/s "
        f"{tokens_per_s:.1f}, MFU {mfu:.4f} of 989 TFLOP/s over {n_params}"
        f" params, peak memory {run.peak / 2**30:.2f} GiB")


def train(tm, fa):
    """The main path: returns its state, step, batch and ``Run``."""
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    state = new_state(tm, cfg)
    step = tm.make_train_step(cfg)
    batch = train_batch(cfg.vocab_size)
    n_params = tm.count_params(state.params)
    with torch.no_grad():
        ref_loss = tm.loss_fn(state.params, batch, dataclasses.replace(
            cfg, flash_attention=False)).item()
    run = run_steps(fa, state, step, batch, "train", cfg.n_layers)
    # bf16 attention probabilities (reference) vs f32 (kernels): the first
    # loss of ~10.9 agrees to 2e-2.
    if abs(run.losses[0] - ref_loss) > 2e-2:
        raise AssertionError(f"train: first loss {run.losses[0]} vs "
                             f"reference attention {ref_loss}")
    log(f"train ok: gpt2-125m {n_params} params, batch {B} seq {L}, "
        f"losses {[round(x, 4) for x in run.losses]} (reference attention "
        f"{ref_loss:.4f}), launches {run.launches} in "
        f"{WARMUP_STEPS + TIMED_STEPS} steps")
    log_run("train", run, n_params)
    return state, step, batch, run


# ---------------------------------------------------------------------------
# Phases 6-8: the MoE FFN and the remat policies.

MOE = dict(moe_experts=8, moe_capacity_factor=1.25, max_seq=L,
           flash_attention=True)
MOE_PARAMS = 521_233_920
MOE_ACTIVE_PARAMS = 124_549_632     # one expert per layer, plus the router
MOE_SERVE_REQUESTS, MOE_SERVE_NEW = 16, 64
# Index and one-hot MoE FFN: the same bf16 products, and each token's
# output is one term (its gate times its slot's output) in both, so the
# logits agree to f32 summation order in the LM head; a token dropped by
# one and not the other moves its slot's logits by about 0.1.
MOE_LOGIT_ATOL = 1e-3
MOE_DECODE_REPEATS = 3


@contextlib.contextmanager
def moe_routes(tt, plain=False):
    """Yields a list that collects (expert [T], capacity C) of every MoE
    layer call inside the block; ``plain`` runs the layers as the one-hot
    plain version (``_moe_ffn_onehot``) meanwhile."""
    seen, route, moe = [], tt._route, tt._moe_ffn

    def spy(x, bp, cfg, tape):
        gate, expert, C = route(x, bp, cfg, tape)
        seen.append((expert, C))
        return gate, expert, C

    tt._route = spy
    if plain:
        tt._moe_ffn = tt._moe_ffn_onehot
    try:
        yield seen
    finally:
        tt._route, tt._moe_ffn = route, moe


def dropped(seen, n_experts):
    """Per MoE call of ``moe_routes``, the mask of tokens past capacity:
    a token's rank among those routed to its expert exceeds C."""
    return [F.one_hot(e, n_experts).cumsum(0).gather(1, e[:, None])[:, 0] > c
            for e, c in seen]


def moe_train(tm, fa, profile_path):
    """Phase 6: gpt2-125m-moe8 training at full width and depth;
    ``profile_path`` (or None) takes a profile of one more step."""
    cfg = tm.GPTConfig.preset("gpt2-125m", **MOE)
    state = new_state(tm, cfg)
    step = tm.make_train_step(cfg)
    batch = train_batch(cfg.vocab_size)
    n_params = tm.count_params(state.params)
    if n_params != MOE_PARAMS:
        raise AssertionError(f"moe-train: {n_params} params")
    with torch.no_grad(), moe_routes(tm.transformer, plain=True):
        ref_loss = tm.loss_fn(state.params, batch, cfg).item()
    first = []

    @contextlib.contextmanager
    def spy():
        with moe_routes(tm.transformer) as seen:
            yield
        first.extend(seen[:cfg.n_layers])      # the forward's, not remat's
    run = run_steps(fa, state, step, batch, "moe-train", cfg.n_layers, spy)
    share = (sum(m.sum().item() for m in dropped(first, cfg.moe_experts)) /
             (cfg.n_layers * B * L))
    # Both sides run the same flash kernels and bf16 products; the loss
    # differs only by summation order.
    if abs(run.losses[0] - ref_loss) > 2e-2:
        raise AssertionError(f"moe-train: first loss {run.losses[0]} vs "
                             f"one-hot plain MoE {ref_loss}")
    log(f"moe-train ok: gpt2-125m-moe8 {n_params} params "
        f"({MOE_ACTIVE_PARAMS} active a token), batch {B} seq {L}, losses "
        f"{[round(x, 4) for x in run.losses]} (one-hot plain MoE "
        f"{ref_loss:.6f}), launches {run.launches} in "
        f"{WARMUP_STEPS + TIMED_STEPS} steps; tokens dropped at step 0: "
        f"{share:.4f} of {cfg.n_layers} x {B * L}")
    log_run("moe-train", run, MOE_ACTIVE_PARAMS)
    if profile_path:
        profile_step(state, step, batch, profile_path, run.step_ms,
                     "profile moe-train")


def remat(tm, fa):
    """Phase 7: phase 4's configuration under each remat policy, from one
    init and one batch."""
    runs = {}
    for policy in ("full", "matmuls", "dots"):
        cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L,
                                  flash_attention=True, remat_policy=policy)
        state = new_state(tm, cfg)
        runs[policy] = run_steps(fa, state, tm.make_train_step(cfg),
                                 train_batch(cfg.vocab_size),
                                 f"remat {policy}", cfg.n_layers)
        n_params = tm.count_params(state.params)
        del state
        torch.cuda.empty_cache()
    full = runs["full"]
    for policy, run in runs.items():
        extra = (run.peak - full.peak) / 1e9
        log(f"remat {policy}: first loss {run.losses[0]:.6f}, grad norm "
            f"{run.grad_norm:.6f}, peak {run.peak / 1e9:.3f} GB "
            f"(+{extra:.3f} GB on full)")
        log_run(f"remat {policy}", run, n_params)
        if policy == "full":
            continue
        if abs(run.losses[0] - full.losses[0]) > 1e-6 * full.losses[0]:
            raise AssertionError(f"remat {policy}: first loss "
                                 f"{run.losses[0]} vs full {full.losses[0]}")
        if abs(run.grad_norm - full.grad_norm) > 1e-3 * full.grad_norm:
            raise AssertionError(f"remat {policy}: grad norm "
                                 f"{run.grad_norm} vs full {full.grad_norm}")
        # Each layer keeps qkv, attn_out and mlp_up (or their products):
        # 100.7 MB at batch 8 x seq 1024, 1.21 GB over 12 layers.
        if not 0.9 <= extra <= 1.5:
            raise AssertionError(f"remat {policy}: peak {extra:.3f} GB above"
                                 f" full's, want 0.9-1.5")
    log("remat ok: matmuls and dots give full's first loss (1e-6) and grad"
        " norm (1e-3) with 24/12/12 flash launches a step")


@contextlib.contextmanager
def sampled_logits(gen):
    """Yields a list that collects the logits ``generate._sample_one`` is
    handed inside the block."""
    seen, real = [], gen._sample_one

    def spy(logits, *args, **kw):
        seen.append(logits.clone())
        return real(logits, *args, **kw)

    gen._sample_one = spy
    try:
        yield seen
    finally:
        gen._sample_one = real


def check_moe_decode(tm, gen, params, cfg, prompts):
    """One decode step with slots 1, 3, 4 and 6 live (their first 256
    prompt tokens prefilled) and the others idle, with the index and the
    one-hot plain MoE FFN: the same tokens dropped in every layer, the
    same next tokens, logits within MOE_LOGIT_ATOL."""
    S, bs, width, n = 8, 16, 1024 // 16, 256
    live = (1, 3, 4, 6)
    pool = gen.init_paged_pool(cfg, 1 + len(live) * width, bs, S, width)
    kv = {"k": pool["k"], "v": pool["v"]}
    bt = torch.zeros(S, width, dtype=torch.int64, device="cuda")
    lengths = torch.zeros(S, dtype=torch.int64, device="cuda")
    tokens = torch.zeros(S, dtype=torch.int64, device="cuda")
    for i, slot in enumerate(live):
        bt[slot] = torch.arange(1 + i * width, 1 + (i + 1) * width)
        p = prompts[i][:n]
        padded = torch.zeros(1, n, dtype=torch.int64, device="cuda")
        padded[0, :len(p)] = torch.tensor(p)
        first, kv = gen.prefill_chunk_paged(
            params, kv, bt[slot], padded, 0, len(p), 0, cfg=cfg,
            block_size=bs)
        tokens[slot], lengths[slot] = first[0], len(p)
    active = torch.zeros(S, dtype=torch.bool, device="cuda")
    active[list(live)] = True

    def step(plain):
        cache = {"k": kv["k"].clone(), "v": kv["v"].clone(),
                 "block_tables": bt, "lengths": lengths.clone()}
        with moe_routes(tm.transformer, plain) as seen, \
                sampled_logits(gen) as logits:
            nxt, _ = gen.decode_step_paged(params, cache, tokens, active,
                                           torch.zeros_like(tokens), cfg=cfg,
                                           block_size=bs)
        return nxt, logits[0], dropped(seen, cfg.moe_experts)

    # Every idle slot writes to scratch row 0 and attends to it (the
    # reference's rule), and idle slots take expert capacity from live
    # ones. The port gives each duplicate write the K/V row of one idle slot
    # (generate._one_writer), so the order in which the card applies them
    # cannot move the drops: 3 repeats, no global switch, each against the
    # one-hot plain version.
    nxt_p, logits_p, drops_p = step(True)
    errs = []
    for rep in range(MOE_DECODE_REPEATS):
        nxt, logits, drops = step(False)
        if not all(torch.equal(a, b) for a, b in zip(drops, drops_p)):
            raise AssertionError(f"moe decode repeat {rep}: index and one-hot "
                                 f"drop different tokens")
        errs.append(close(f"moe decode logits, repeat {rep}", logits,
                          logits_p, MOE_LOGIT_ATOL, 0.0))
        if not torch.equal(nxt, nxt_p):
            raise AssertionError(f"moe decode repeat {rep}: tokens "
                                 f"{nxt.tolist()} vs one-hot "
                                 f"{nxt_p.tolist()}")
    n_drop = sum(int(m.sum()) for m in drops)
    live_drop = sum(int(m[list(live)].sum()) for m in drops)
    if not n_drop:
        raise AssertionError("moe decode: no token dropped; the check needs "
                             "capacity to bind")
    log(f"moe decode ok: slots {list(live)} live of {S} (capacity 1 per "
        f"expert); {n_drop} tokens dropped over {cfg.n_layers} layers "
        f"({live_drop} of live slots), the same as the one-hot version in "
        f"{MOE_DECODE_REPEATS} of {MOE_DECODE_REPEATS} repeats without "
        f"deterministic algorithms; logits max |diff| {max(errs):.3e} (atol "
        f"{MOE_LOGIT_ATOL})")


def moe_serve(tm, gen, se, seed):
    """Phase 8: the paged engine on gpt2-125m-moe8."""
    ec = se.EngineConfig(
        preset="gpt2-125m", model_overrides=tuple(sorted(MOE.items())),
        max_slots=8, max_len=L, paged_kv=True, kv_block_size=16,
        prefill_chunk=256, prefix_cache_enabled=True,
        max_new_tokens=MOE_SERVE_NEW)
    cfg = ec.gpt_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = gen.serving_params(tm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed),
        device="cuda"), cfg)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(64, 513, MOE_SERVE_REQUESTS)]
    _, out = serve_run(gen, se, params, cfg, prompts, "moe", ec,
                       MOE_SERVE_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_moe_decode(tm, gen, params, cfg, prompts)
    log(f"moe-serve ok: gpt2-125m-moe8 bf16, prompts "
        f"{sorted(len(p) for p in prompts)}, peak memory {peak:.2f} GiB")
    log("moe-serve metrics: " + json.dumps(dict(out, peak_gib=peak)))


def union_ms(ranges) -> float:
    """Total length in ms of the union of profiler intervals (in us)."""
    total, end = 0.0, float("-inf")
    for r in sorted(ranges, key=lambda r: r.start):
        if r.end > end:
            total += r.end - max(r.start, end)
            end = r.end
    return total / 1e3


def top_ops(device, n=6) -> str:
    """The ``n`` device ops of most total time among profiler events."""
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return "; ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in top)


def profile_step(state, step, batch, path, step_ms, label="profile"):
    """One train step under torch.profiler; the table of device time by
    kernel goes to ``path``. Prints the device's busy time (the union of
    its kernels' and copies' intervals) against the unprofiled median
    ``step_ms``, the flash kernels' share of it and the top ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, batch)
        metrics["loss"].item()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40))
    # Busy time is the union of the device's intervals: an annotation on
    # the device (the optimizer step's) spans its own kernels.
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = union_ms([e.time_range for e in device])
    flash = union_ms([e.time_range for e in device if "flash_" in e.name])
    log(f"{label}: device busy {busy:.2f} ms per step, {step_ms:.2f} ms "
        f"step (idle share {1 - busy / step_ms:.4f}); flash kernels "
        f"{flash:.2f} ms ({flash / busy:.4f} of busy); top: "
        f"{top_ops(device)}; table in {path}")


# ---------------------------------------------------------------------------
# Phases 9-10: the serving path (models/generate.py, serve/llm/engine.py).

# jax.random's output for these keys (jax 0.9.0: threefry2x32, partitionable
# bits), computed with jax beside the JAX package; the card's machine has no
# jax. request_key(s, c) is generate._request_key: fold_in(fold_in(key(0),
# s), c).
THREEFRY_GOLDEN = {
    "fold_in(key(0), 42)": [2814562516, 111458285],
    "request_key(1234, 567)": [1107522705, 3439138719],
    "split(key(7), 4)": [3625411723, 1954958720, 195045567, 4062205631,
                         966301609, 1948237315, 276534068, 1641862660],
    "bits(request_key(3, 100), (8,))": [
        3212792654, 426997502, 673008669, 990225976, 3630513346,
        2515621064, 686453317, 2203328511],
    # categorical(request_key(9, 300), linspace(-2, 2, 64).reshape(2, 32))
    "categorical": [8, 31],
}
SERVE_CHECK_LENS = (37, 94, 171, 300)   # prompts 3 and 4 share 128 tokens
SERVE_REQUESTS, SERVE_NEW, SERVE_PREFIX = 16, 128, 256
# llama-7b's depth in phases 10, 13(c) and 17(b): 16 of its 32 layers at
# full width, so that the whole script keeps well inside its time limit.
SERVE_LAYERS = 16
SERVE_DEPTH = {"n_layers": SERVE_LAYERS}
SERVE_SHARED = (0, 5, 10, 15)           # requests that share the prefix


def threefry_outputs(device):
    """THREEFRY_GOLDEN's functions computed by the port on ``device``."""
    from ray_tpu_torch import random as rnd
    from ray_tpu_torch.models.generate import _request_key

    def rk(s, c):
        return _request_key(s, c, device=device)

    logits = torch.linspace(-2, 2, 64, device=device).reshape(2, 32)
    return {
        "fold_in(key(0), 42)": rnd.fold_in(rnd.key(0, device=device), 42),
        "request_key(1234, 567)": rk(1234, 567),
        "split(key(7), 4)": rnd.split(rnd.key(7, device=device), 4),
        "bits(request_key(3, 100), (8,))": rnd.random_bits(rk(3, 100), (8,)),
        "categorical": rnd.categorical(rk(9, 300), logits),
    }


def check_threefry():
    """The port's threefry on the card: jax.random's golden words, and the
    CPU's bits for a batch of decode-step sized draws."""
    from ray_tpu_torch import random as rnd
    from ray_tpu_torch.models.generate import _request_key

    got, cpu = ({k: v.flatten().tolist()
                 for k, v in threefry_outputs(dev).items()}
                for dev in ("cuda", "cpu"))
    for name, want in THREEFRY_GOLDEN.items():
        if got[name] != want or cpu[name] != want:
            raise AssertionError(f"threefry {name}: cuda {got[name]}, cpu "
                                 f"{cpu[name]}, jax.random {want}")
    seeds, ctrs = torch.arange(8) * 7919, torch.arange(8) + 1000
    bits = [rnd.random_bits(_request_key(seeds.to(d), ctrs.to(d)), (32000,))
            for d in ("cpu", "cuda")]
    if not torch.equal(bits[0], bits[1].cpu()):
        raise AssertionError("threefry: random_bits differ on cuda and cpu")
    log(f"threefry ok: {len(THREEFRY_GOLDEN)} golden jax.random outputs on "
        f"cuda and cpu; [8, 32000] bits equal on both")


def serve_requests(eng, prompts, n, seeds, timeout_s):
    """Submit every prompt at once, then poll ``collect`` every 10 ms until
    all are done (a tighter poll takes the interpreter lock from the
    engine's thread more often). Returns (tokens per request, time to first
    token per request in s, wall s from the first submit)."""
    t0 = time.perf_counter()
    rids, t_submit = [], {}
    for p, s in zip(prompts, seeds):
        rids.append(eng.submit(p, n, seed=s))
        t_submit[rids[-1]] = time.perf_counter()
    toks = {r: [] for r in rids}
    ttft, live = {}, set(rids)
    while live:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"serve: {len(live)} requests not done in "
                                 f"{timeout_s} s")
        out = eng.collect(sorted(live))
        now = time.perf_counter()
        for rid, o in out.items():
            if "error" in o:
                raise AssertionError(f"serve: request {rid}: {o['error']}")
            if o["tokens"] and rid not in ttft:
                ttft[rid] = now - t_submit[rid]
            toks[rid] += o["tokens"]
            if o["done"]:
                live.discard(rid)
        time.sleep(0.01)
    return ([toks[r] for r in rids], [ttft[r] for r in rids],
            time.perf_counter() - t0)


def serve_check(tm, gen, se):
    """Phase 9: llama-7b widths at two layers in f32, token-exact."""
    base = dict(preset="llama-7b",
                model_overrides={"n_layers": 2, "dtype": "float32"},
                max_slots=4, max_len=320, paged_kv=True, kv_block_size=16,
                prefill_chunk=64, max_new_tokens=16)
    cfg = se.EngineConfig.from_dict(base).gpt_config()
    params = gen.serving_params(tm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda"), cfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVE_CHECK_LENS]
    prompts[3] = prompts[2][:128] + prompts[3][128:]
    fwd_cfg = dataclasses.replace(cfg, remat=False)

    def engine(replica, **kw):
        return se.InflightBatchEngine(
            params, cfg, se.EngineConfig.from_dict(dict(base, **kw)),
            replica_id=replica)

    n = 8
    eng = engine("check-greedy")
    try:
        greedy, _, _ = serve_requests(eng, prompts, n, [0] * 4, 300)
        if eng.stats()["kv_blocks_used"] != 0:
            raise AssertionError(f"serve-check: blocks left {eng.stats()}")
    finally:
        eng.stop()
    with torch.no_grad():
        for p, got in zip(prompts, greedy):
            seq = list(p)
            for _ in range(n):
                logits = tm.forward(params, torch.tensor([seq], device="cuda"),
                                    fwd_cfg)
                seq.append(int(logits[0, -1].argmax()))
            if got != seq[len(p):]:
                raise AssertionError(f"serve-check: engine {got} != rollout "
                                     f"{seq[len(p):]} (prompt {len(p)})")

    eng = engine("check-prefix", prefix_cache_enabled=True)
    try:
        cached = [eng.generate(p, n) for p in prompts]   # one at a time
        hits = eng.stats()["prefix_cache_hit_tokens"]
    finally:
        eng.stop()
    if cached != greedy or hits < 128:
        raise AssertionError(f"serve-check: prefix cache on {cached} vs off "
                             f"{greedy}, hit tokens {hits}")

    sampled = dict(temperature=0.9, top_k=50)
    seeds = [11, 12, 13, 14]
    eng = engine("check-solo", **sampled)
    try:
        solo = [eng.generate(p, 16, seed=s) for p, s in zip(prompts, seeds)]
    finally:
        eng.stop()
    # 20 usable blocks: the first three prompts take them all at admission,
    # so the first slot to grow is preempted and resumed by recompute.
    tight = engine("check-tight", kv_num_blocks=21, **sampled)
    try:
        crowd, _, _ = serve_requests(tight, prompts, 16, seeds, 300)
        preempts = se.engine_metrics()["preempts"].value(
            {"deployment": "llm", "replica": "check-tight"})
        left = tight.stats()["kv_blocks_used"]
    finally:
        tight.stop()
    if crowd != solo or preempts < 1 or left:
        raise AssertionError(f"serve-check: contended {crowd} vs solo {solo}, "
                             f"{preempts} preemptions, {left} blocks left")
    check_threefry()
    log(f"serve-check ok: llama-7b widths, 2 layers, f32; paged engine = "
        f"argmax rollout on prompts {list(SERVE_CHECK_LENS)} ({n} tokens "
        f"each); prefix cache on = off ({hits} hit tokens); contended pool "
        f"({int(preempts)} preemptions) = solo sampled streams")


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def serve_prompts(seed, vocab):
    """16 prompts of 128-1024 tokens from ``seed``; SERVE_SHARED start with
    one 256-token prefix (those are at least 257 tokens long)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(128, 1025, SERVE_REQUESTS)
    prefix = rng.integers(0, vocab, SERVE_PREFIX).tolist()
    prompts = []
    for i, n in enumerate(lens):
        if i in SERVE_SHARED:
            n = max(n, SERVE_PREFIX + 1)
            prompts.append(prefix + rng.integers(
                0, vocab, n - SERVE_PREFIX).tolist())
        else:
            prompts.append(rng.integers(0, vocab, n).tolist())
    return prompts


def serve_run(gen, se, params, cfg, prompts, label, ec, n_new):
    """One engine of configuration ``ec`` over ``prompts``, ``n_new``
    tokens each; returns its metrics. Wraps the engine's decode and
    chunk-prefill calls to time them: the host's time to launch a call's
    work, and the time to its end on the device (a synchronise, which the
    engine does right after anyway)."""
    steps, chunks = [], []

    def timed(fn, record, count):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            t_launch = time.perf_counter() - t0
            torch.cuda.synchronize()
            record.append((time.perf_counter() - t0, count(args), t_launch))
            return out
        return call

    decode, chunk = gen.decode_step_paged, gen.prefill_chunk_paged
    gen.decode_step_paged = timed(decode, steps, lambda a: int(a[3].sum()))
    gen.prefill_chunk_paged = timed(chunk, chunks, lambda a: int(a[5]))
    eng = se.InflightBatchEngine(params, cfg, ec, replica_id=label)
    try:
        seeds = list(range(len(prompts)))
        toks, ttft, wall = serve_requests(eng, prompts, n_new, seeds, 600)
        stats = eng.stats()
    finally:
        eng.stop()
        gen.decode_step_paged, gen.prefill_chunk_paged = decode, chunk
    short = [i for i, t in enumerate(toks) if len(t) != n_new]
    if short or stats["kv_blocks_used"] != 0:
        raise AssertionError(f"serve {label}: requests {short} short of "
                             f"{n_new} tokens; stats {stats}")
    if not all(0 <= x < cfg.vocab_size for t in toks for x in t):
        raise AssertionError(f"serve {label}: token out of the vocabulary")
    step_s = sum(t for t, _, _ in steps)
    out = {
        "ttft_p50_ms": percentile(ttft, 50) * 1e3,
        "ttft_p99_ms": percentile(ttft, 99) * 1e3,
        "decode_tokens_per_s": sum(n for _, n, _ in steps) / step_s,
        "decode_step_ms": step_s / len(steps) * 1e3,
        "decode_step_p50_ms": statistics.median(t for t, _, _ in steps) * 1e3,
        "decode_launch_ms": sum(t for _, _, t in steps) / len(steps) * 1e3,
        "decode_steps": len(steps),
        "prefill_tokens_per_s": (sum(n for _, n, _ in chunks) /
                                 sum(t for t, _, _ in chunks)),
        "prefill_chunks": len(chunks),
        "output_tokens_per_s": sum(map(len, toks)) / wall,
        "wall_s": wall,
        "prefix_hit_tokens": stats["prefix_cache_hit_tokens"],
        "prefill_tokens_computed": stats["prefill_tokens_computed"],
    }
    log(f"serve {label}: {len(prompts)} requests x {n_new} tokens in "
        f"{wall:.3f} s; TTFT p50 {out['ttft_p50_ms']:.1f} ms p99 "
        f"{out['ttft_p99_ms']:.1f} ms; decode {out['decode_tokens_per_s']:.1f}"
        f" tokens/s, step {out['decode_step_ms']:.3f} ms mean (p50 "
        f"{out['decode_step_p50_ms']:.3f}, host launch "
        f"{out['decode_launch_ms']:.3f}) over {len(steps)} steps; prefill "
        f"{out['prefill_tokens_per_s']:.1f} tokens/s over {len(chunks)} "
        f"chunks; output {out['output_tokens_per_s']:.1f} tokens/s; "
        f"prefix-cache hit tokens {out['prefix_hit_tokens']} of "
        f"{out['prefill_tokens_computed'] + out['prefix_hit_tokens']}")
    return toks, out


def check_first_logits(tm, gen, params, cfg, prompts, tol):
    """Each prompt's first-token logits from chunked prefill (chunks of 512
    against pages of a fresh pool, as the engine runs them) against
    ``models.forward`` on the prompt; both bf16. Returns the largest
    difference and, per prompt, ``models.forward``'s argmax and its margin
    over the runner-up."""
    bs, width = 16, 2048 // 16
    pool = gen.init_paged_pool(cfg, 1 + 1024 // bs, bs, 1, width)
    table = torch.zeros(width, dtype=torch.int64, device="cuda")
    table[:1024 // bs] = torch.arange(1, 1 + 1024 // bs)
    fwd_cfg = dataclasses.replace(cfg, remat=False)
    errs, agree, spread, firsts = [], 0, 0.0, []
    with torch.no_grad():
        for p in prompts:
            kv = {"k": pool["k"], "v": pool["v"]}
            for start in range(0, len(p), 512):
                chunk = p[start:start + 512]
                padded = torch.zeros(1, 512, dtype=torch.int64, device="cuda")
                padded[0, :len(chunk)] = torch.tensor(chunk)
                logits, kv = gen._prefill_chunk_logits(
                    params, kv, table, padded, start, len(chunk), cfg=cfg,
                    block_size=bs)
            ref = tm.forward(params, torch.tensor([p], device="cuda"),
                             fwd_cfg)[0, -1]
            errs.append(close(f"first-token logits ({len(p)} tokens)",
                              logits, ref, tol, 0.0))
            agree += int(logits.argmax() == ref.argmax())
            spread = max(spread, ref.std().item())
            top2 = ref.float().topk(2).values
            firsts.append((int(ref.argmax()), float(top2[0] - top2[1])))
    del pool
    log(f"serve logits ok: chunked-prefill first-token logits vs "
        f"models.forward, {len(prompts)} prompts, max |diff| "
        f"{max(errs):.4f} (atol {tol}), median {statistics.median(errs):.4f}"
        f", logits' std up to {spread:.4f}; argmax agrees on "
        f"{agree}/{len(prompts)}")
    return max(errs), firsts


def profile_decode(gen, params, cfg, path):
    """One decode step of the serve configuration (8 active slots, 1024
    tokens of context each, block tables 128 pages wide) under
    torch.profiler; the table goes to ``path``. Prints device busy against
    the step's wall time (median of 5 unprofiled steps) and the top ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    S, bs, width, ctx = 8, 16, 2048 // 16, 1024
    pool = gen.init_paged_pool(cfg, 1 + S * ctx // bs, bs, S, width)
    bt = torch.zeros(S, width, dtype=torch.int64, device="cuda")
    bt[:, :ctx // bs] = torch.arange(1, 1 + S * ctx // bs).view(S, -1)
    tokens = torch.arange(S, device="cuda")
    active = torch.ones(S, dtype=torch.bool, device="cuda")

    def step():
        pool["block_tables"] = bt
        pool["lengths"] = torch.full((S,), ctx - 1, device="cuda")
        nxt, _ = gen.decode_step_paged(params, pool, tokens, active,
                                       tokens, cfg=cfg, block_size=bs)
        return nxt.cpu()

    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls[2:]) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=30)
    with open(path, "w") as f:
        f.write(table)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = union_ms([e.time_range for e in device])
    log(f"profile decode step: device busy {busy:.3f} ms, step {wall_ms:.3f}"
        f" ms (idle share {1 - busy / wall_ms:.4f}); top: {top_ops(device)}"
        f"; table in {path}")


# First-token logits, chunked prefill vs models.forward, both bf16 at
# llama-7b: the tolerance and its reason are in PERF.md ("Serving").
SERVE_LOGIT_ATOL = 0.25


def serve(tm, gen, se, fa, seed, profile_path):
    """Phase 10: llama-7b at full width, ``SERVE_LAYERS`` deep, bf16, the
    paged engine; the flash kernels' counts are zeroed before and read
    after (the serving path launches none of them)."""
    cfg = se.EngineConfig.from_dict(
        dict(preset="llama-7b", model_overrides=SERVE_DEPTH)).gpt_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    master = tm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed),
        device="cuda")
    n_params = tm.count_params(master)
    params = gen.serving_params(master, cfg)
    del master
    torch.cuda.empty_cache()
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    prompts = serve_prompts(seed, cfg.vocab_size)

    fa.reset_launches()
    results = {}
    for label, sampling in (("greedy", {}),
                            ("sampled", dict(temperature=0.8, top_k=50))):
        torch.cuda.reset_peak_memory_stats()
        ec = se.EngineConfig.from_dict(dict(
            preset="llama-7b", model_overrides=SERVE_DEPTH, max_slots=8,
            max_len=2048, paged_kv=True, kv_block_size=16,
            prefill_chunk=512, prefix_cache_enabled=True,
            max_new_tokens=SERVE_NEW, **sampling))
        _, results[label] = serve_run(gen, se, params, cfg, prompts, label,
                                      ec, SERVE_NEW)
        results[label]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
    flash = {k.symbol.removeprefix("rtt_"): k.launches for k in fa.KERNELS}
    check_first_logits(tm, gen, params, cfg, prompts, SERVE_LOGIT_ATOL)
    if profile_path:
        profile_decode(gen, params, cfg, profile_path)
    log(f"serve ok: llama-7b {n_params} params, bf16, {cfg.n_layers} "
        f"layers; prompts {sorted(len(p) for p in prompts)}; flash kernel "
        f"launches in the "
        f"serve runs {flash} (its attention is plain products over the "
        f"cache); peak memory: f32 init and cast {init_peak:.2f} GiB, "
        f"greedy run {results['greedy']['peak_gib']:.2f} GiB, sampled run "
        f"{results['sampled']['peak_gib']:.2f} GiB")
    log("serve metrics: " + json.dumps(results))


# ---------------------------------------------------------------------------
# Phase 11: RLlib's learners and rollout workers (ray_tpu_torch/rllib/).

RL_WARMUP, RL_TIMED = 2, 5
RL_FRAGMENT = 200
# One update on the card and one on the CPU from the same state and batch,
# both f32 with TF32 off: cuBLAS and the CPU's BLAS sum in other orders, so
# each op differs by float32 rounding. Metrics (means over the batch) keep
# that relative size; through Adam's normalised steps (lr 3e-4 to 1e-3, up
# to 32 steps) a param moves by its rounding-level gradient difference times
# lr, far below 1e-5. The tolerances leave room for an argmax or clamp
# boundary crossed on one side only, which moves one term.
RL_METRIC_TOL = (1e-5, 1e-4)      # (atol, rtol)
RL_PARAM_TOL = (1e-5, 1e-4)
# The card's and the CPU's worker pick the same action unless the CPU's two
# best gumbel + logits scores are closer than this (logits differ by a few
# f32 ulp on each side); the episodes part there.
RL_TIE_MARGIN = 1e-5


class NumpyCartPole:
    """CartPole-v1's dynamics, sizes and limits (gymnasium's
    ``cartpole.py``: Euler steps of 0.02 s, force 10, failure past 2.4 or
    12 degrees, 500 steps), for a machine without gymnasium. Its spaces are
    stand-ins with what ``AlgorithmConfig.infer_spaces`` reads."""

    observation_space = SimpleNamespace(shape=(4,))
    action_space = SimpleNamespace(n=2)

    def __init__(self):
        self._rng = np.random.default_rng(0)

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._s = self._rng.uniform(-0.05, 0.05, 4)
        self._t = 0
        return self._s.astype(np.float32), {}

    def step(self, action):
        x, x_dot, th, th_dot = self._s
        force = 10.0 if action == 1 else -10.0
        cos, sin = np.cos(th), np.sin(th)
        temp = (force + 0.05 * th_dot ** 2 * sin) / 1.1
        th_acc = (9.8 * sin - cos * temp) / (0.5 * (4 / 3 - 0.1 * cos ** 2
                                                     / 1.1))
        x_acc = temp - 0.05 * th_acc * cos / 1.1
        self._s = np.array([x + 0.02 * x_dot, x_dot + 0.02 * x_acc,
                            th + 0.02 * th_dot, th_dot + 0.02 * th_acc])
        self._t += 1
        term = bool(abs(self._s[0]) > 2.4 or abs(self._s[2]) > 12 * 2 *
                    math.pi / 360)
        return (self._s.astype(np.float32), 1.0, term,
                self._t >= 500 and not term, {})


class NumpyPendulum:
    """Pendulum-v1's dynamics, sizes and limits (gymnasium's
    ``pendulum.py``: torque in [-2, 2], speed in [-8, 8], steps of 0.05 s,
    200 steps), with stand-in spaces as ``NumpyCartPole``'s."""

    observation_space = SimpleNamespace(shape=(3,))
    action_space = SimpleNamespace(shape=(1,),
                                   low=np.array([-2.0], np.float32),
                                   high=np.array([2.0], np.float32))

    def __init__(self):
        self._rng = np.random.default_rng(0)

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._s = self._rng.uniform([-math.pi, -1.0], [math.pi, 1.0])
        self._t = 0
        return self._obs(), {}

    def _obs(self):
        th, th_dot = self._s
        return np.array([np.cos(th), np.sin(th), th_dot], np.float32)

    def step(self, u):
        th, th_dot = self._s
        u = float(np.clip(u, -2.0, 2.0)[0])
        cost = ((th + math.pi) % (2 * math.pi) - math.pi) ** 2 + \
            0.1 * th_dot ** 2 + 0.001 * u ** 2
        th_dot = np.clip(th_dot + (15.0 * np.sin(th) + 3.0 * u) * 0.05, -8, 8)
        self._s = np.array([th + th_dot * 0.05, th_dot])
        self._t += 1
        return self._obs(), -cost, False, self._t >= 200, {}


def rl_envs():
    """(CartPole-v1 creator, Pendulum-v1 creator, which): gymnasium's when
    it imports, else the numpy versions above."""
    try:
        import gymnasium as gym
    except ImportError:
        return NumpyCartPole, NumpyPendulum, "numpy CartPole/Pendulum"
    return (lambda: gym.make("CartPole-v1"), lambda: gym.make("Pendulum-v1"),
            f"gymnasium {gym.__version__} CartPole-v1/Pendulum-v1")


def rl_batch(rng, n):
    """An on-policy batch at CartPole's sizes: every column a learner
    reads, from numpy."""
    from ray_tpu_torch.rllib import sample_batch as sb

    values = rng.normal(size=n).astype(np.float32)
    return sb.SampleBatch({
        sb.OBS: rng.normal(size=(n, 4)).astype(np.float32),
        sb.ACTIONS: rng.integers(0, 2, n).astype(np.int32),
        sb.LOGPS: np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
        sb.ADVANTAGES: rng.normal(size=n).astype(np.float32),
        sb.RETURNS: rng.normal(size=n).astype(np.float32),
        sb.REWARDS: np.ones(n, np.float32),
        sb.DONES: rng.random(n) < 0.05,
        sb.NEXT_VALUES: np.append(values[1:], np.float32(0.0)),
        sb.VALUES: values,
    })


def rl_transitions(rng, n, obs_dim, act):
    """Replay transitions; ``act`` is the number of discrete actions, or
    None for one continuous action in [-2, 2]."""
    obs = rng.normal(size=(n, obs_dim)).astype(np.float32)
    actions = (rng.integers(0, act, n).astype(np.int32) if act else
               rng.uniform(-2, 2, (n, 1)).astype(np.float32))
    return (obs, actions, rng.normal(size=n).astype(np.float32),
            (obs + 0.1 * rng.normal(size=obs.shape)).astype(np.float32),
            (rng.random(n) < 0.05).astype(np.float32))


def rl_cases(seed):
    """name -> (make(device) -> learner, update(learner) -> metrics) at the
    JAX package's defaults; every batch from numpy with ``seed``."""
    from ray_tpu_torch import rllib as rl
    from ray_tpu_torch.rllib import apex, sample_batch as sb

    rng = np.random.default_rng(seed)
    spec = rl.PolicySpec(4, 2)                  # CartPole-v1, hidden (64, 64)
    frag = rl_batch(rng, RL_FRAGMENT)
    batch = sb.concat_batches([frag, rl_batch(rng, RL_FRAGMENT)])
    bc_rows = {sb.OBS: batch[sb.OBS], sb.ACTIONS: batch[sb.ACTIONS]}
    dqn_cfg = rl.DQNConfig(seed=seed)
    buf = rl.ReplayBuffer(dqn_cfg.buffer_size, 4)
    buf.add_batch(*rl_transitions(rng, 2000, 4, 2))
    apex_cfg = rl.ApexDQNConfig(seed=seed)
    shard = apex._ReplayShard(apex_cfg.buffer_size // 2, 4,
                              apex_cfg.prioritized_replay_alpha,
                              apex_cfg.prioritized_replay_eps, seed)
    obs, act, rew, nxt, done = rl_transitions(rng, 2000, 4, 2)
    shard.add_batch({"obs": obs, "actions": act, "rewards": rew,
                     "next_obs": nxt, "dones": done},
                    rng.uniform(0.1, 2.0, 2000))
    apex_batch, _ = shard.sample(apex_cfg.train_batch_size,
                                 apex_cfg.prioritized_replay_beta)
    cspec = rl.ContinuousPolicySpec(3, 1, -2.0, 2.0)   # Pendulum-v1, 128x2
    sac_cfg = rl.SACConfig(seed=seed)
    cbuf = rl.ContinuousReplayBuffer(sac_cfg.buffer_size, 3, 1)
    cbuf.add_batch(*rl_transitions(rng, 2000, 3, None))

    def fresh():
        return np.random.default_rng(seed)

    ppo = rl.PPOConfig(seed=seed)
    return {
        "ppo": (lambda d: rl.PPOLearner(spec, ppo, device=d),
                lambda lr: lr.update_from_batch(
                    batch, num_epochs=ppo.num_sgd_epochs,
                    minibatch_size=ppo.sgd_minibatch_size, rng=fresh())),
        "a2c": (lambda d: rl.A2CLearner(spec, rl.A2CConfig(seed=seed),
                                        device=d),
                lambda lr: lr.update_from_batch(batch)),
        "a2c-micro128": (lambda d: rl.A2CLearner(
                             spec, rl.A2CConfig(seed=seed), device=d),
                         lambda lr: lr.update_from_batch(
                             batch, microbatch_size=128)),
        "impala": (lambda d: rl.IMPALALearner(
                       spec, rl.IMPALAConfig(seed=seed), device=d),
                   lambda lr: lr.update_from_fragment(frag)),
        "bc": (lambda d: rl.BCLearner(spec, rl.BCConfig(seed=seed),
                                      device=d),
               lambda lr: lr.step(bc_rows)),
        "dqn": (lambda d: rl.DQNLearner(spec, dqn_cfg, device=d),
                lambda lr: lr.update_from_buffer(
                    buf, iters=dqn_cfg.num_sgd_iters,
                    batch_size=dqn_cfg.train_batch_size, rng=fresh())),
        "apex": (lambda d: apex.ApexDQNLearner(spec, apex_cfg, device=d),
                 lambda lr: lr.weighted_update(apex_batch)),
        "sac": (lambda d: rl.SACLearner(cspec, sac_cfg, device=d),
                lambda lr: lr.update_from_buffer(
                    cbuf, sac_cfg.num_sgd_iters, sac_cfg.train_batch_size,
                    fresh())),
    }


def state_tensors(state, prefix=""):
    """(name, tensor) of every param-like tensor in a learner's state: the
    params, the target nets and log_alpha (not the optimizer's moments)."""
    for k, v in state.items():
        if k.endswith("opt_state"):
            continue
        if isinstance(v, dict):
            yield from state_tensors(v, f"{prefix}{k}.")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


def device_profile(fn):
    """(kernels, copies, device busy ms, wall ms) of one ``fn()`` under
    torch.profiler (device activity only): the CUDA kernels and memory
    copies/sets it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = sum(e.name.startswith("Memcpy") or e.name.startswith("Memset")
                 for e in device)
    return (len(device) - copies, copies,
            union_ms([e.time_range for e in device]), wall)


def rl_learner(name, make, update):
    """One update on the card against one on the CPU from the CPU
    learner's state; then the card's update time and launches."""
    cpu, dev = make("cpu"), make("cuda")
    dev.set_state(cpu.get_state())
    want, got = update(cpu), update(dev)
    if set(got) != set(want):
        raise AssertionError(f"rl {name}: metrics {sorted(got)} vs cpu "
                             f"{sorted(want)}")
    m_err = max(close(f"rl {name} {k}", torch.as_tensor(got[k]),
                      torch.as_tensor(want[k]), *RL_METRIC_TOL)
                for k in want)
    ref = dict(state_tensors(cpu.get_state()))
    p_err = max(close(f"rl {name} {k}", v.cpu(), ref[k], *RL_PARAM_TOL)
                for k, v in state_tensors(dev.get_state()))
    times = []
    for i in range(RL_WARMUP + RL_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update(dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    kernels, copies, busy, wall = device_profile(lambda: update(dev))
    ms = statistics.median(times[RL_WARMUP:])
    log(f"rl {name}: cuda = cpu, metrics max |diff| {m_err:.3e}, params "
        f"{p_err:.3e} (atol, rtol {RL_METRIC_TOL} / {RL_PARAM_TOL}); update "
        f"{ms:.3f} ms (median of {RL_TIMED}; all "
        f"{[round(t, 3) for t in times]}), {kernels} kernels + {copies} "
        f"copies an update, device busy {busy:.3f} of {wall:.3f} ms "
        f"profiled")
    return {"update_ms": ms, "kernels": kernels, "copies": copies,
            "busy_ms": busy, "profiled_wall_ms": wall, "metric_err": m_err,
            "param_err": p_err}, dev


def rl_step_parts(learner, batch):
    """Where one learner step's time goes on the host: the batch's copies
    to the card, the loss's forward, the backward, Adam, and the metrics'
    read back, each ended by a synchronise; medians of 5 after 2."""
    from ray_tpu_torch.rllib.algorithm import backward, floats, to_device

    parts = {"to_device": [], "forward": [], "backward": [], "adam": [],
             "read": []}
    for i in range(RL_WARMUP + RL_TIMED):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        b = to_device(batch, learner.device)
        mark()
        loss, aux = learner._loss_fn(learner.policy, b)
        mark()
        backward(loss, learner.policy)
        mark()
        learner.optimizer.step()
        mark()
        floats(aux)
        mark()
        if i >= RL_WARMUP:
            for name, t0, t1 in zip(parts, marks, marks[1:]):
                parts[name].append((t1 - t0) * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def rl_tie(weights, obs, keys, t):
    """The CPU's top-two gap of gumbel + logits at step ``t``."""
    from ray_tpu_torch import random as rnd
    from ray_tpu_torch.rllib import MLPPolicy, PolicySpec

    pol = MLPPolicy(PolicySpec(4, 2), rnd.key(0, device="cpu"),
                    device="cpu")
    pol.load_state_dict({k: v.cpu() for k, v in weights.items()})
    with torch.no_grad():
        logits, _ = pol(torch.from_numpy(obs[t][None]))
        score = (rnd.gumbel(keys[t], logits.shape) + logits)[0].sort().values
    return float(score[-1] - score[-2])


def rl_fragments(seed, weights, sac_weights):
    """One RolloutWorker and one SAC worker fragment with the policy on the
    card, against the same workers on the CPU; returns their times."""
    from ray_tpu_torch import random as rnd
    from ray_tpu_torch import rllib as rl
    from ray_tpu_torch.rllib import sac

    cartpole, pendulum, which = rl_envs()
    out = {}
    workers = {d: rl.RolloutWorker(cartpole, rl.PolicySpec(4, 2),
                                   rollout_fragment_length=RL_FRAGMENT,
                                   seed=seed, device=d)
               for d in ("cuda", "cpu")}
    frags = {}
    for d, w in workers.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frags[d] = w.sample(weights)
        out[f"{d}_fragment_ms"] = (time.perf_counter() - t0) * 1e3
    got, want = frags["cuda"], frags["cpu"]
    keys, k = [], rnd.key(seed, device="cpu")
    for _ in range(RL_FRAGMENT):
        k, sub = rnd.split(k)
        keys.append(sub)
    stop = RL_FRAGMENT
    for t in range(RL_FRAGMENT):
        if got["actions"][t] != want["actions"][t]:
            margin = rl_tie(weights, want["obs"], keys, t)
            if margin >= RL_TIE_MARGIN:
                raise AssertionError(f"rl fragment: step {t} action "
                                     f"{got['actions'][t]} vs cpu "
                                     f"{want['actions'][t]}, margin {margin}")
            stop = t
            break
    for col in ("obs", "actions", "dones"):
        if not (got[col][:stop] == want[col][:stop]).all():
            raise AssertionError(f"rl fragment: {col} differ before step "
                                 f"{stop}")
    err = max(close(f"rl fragment {col}", torch.from_numpy(got[col][:stop]),
                    torch.from_numpy(want[col][:stop]), 1e-5, 1e-5)
              for col in ("action_logp", "values", "advantages",
                          "value_targets"))
    # the card worker's second fragment, warm: the one timed
    t0 = time.perf_counter()
    workers["cuda"].sample(weights)
    out["fragment_ms"] = (time.perf_counter() - t0) * 1e3
    out["ms_per_env_step"] = out["fragment_ms"] / RL_FRAGMENT
    log(f"rl fragment ok ({which}): {RL_FRAGMENT} CartPole steps, policy on "
        f"the card = on the CPU for {stop} steps (logp, value, GAE max "
        f"|diff| {err:.3e}), {len(got.completed_returns)} episodes; warm "
        f"fragment {out['fragment_ms']:.1f} ms, "
        f"{out['ms_per_env_step']:.3f} ms an env step")

    swork = {d: sac._SACRolloutWorker(
                 pendulum, rl.ContinuousPolicySpec(3, 1, -2.0, 2.0),
                 RL_FRAGMENT, seed, device=d) for d in ("cuda", "cpu")}
    sfr = {d: w.sample(sac_weights) for d, w in swork.items()}
    for col in ("obs", "actions", "rewards", "next_obs", "dones"):
        a = np.asarray(sfr["cuda"][col], np.float32)
        if a.shape != np.shape(sfr["cpu"][col]) or not np.isfinite(a).all():
            raise AssertionError(f"rl sac fragment: {col} {a.shape}")
    if np.abs(sfr["cuda"]["actions"]).max() > 2.0:
        raise AssertionError("rl sac fragment: action out of [-2, 2]")
    # The draws differ by the few ulp of random.normal's erfinv on each
    # device; the pendulum carries that forward, so hold the fragment to
    # 1e-3 and print how far it got.
    s_err = close("rl sac fragment actions",
                  torch.from_numpy(sfr["cuda"]["actions"]),
                  torch.from_numpy(sfr["cpu"]["actions"]), 1e-3, 0.0)
    t0 = time.perf_counter()
    swork["cuda"].sample(sac_weights)
    out["sac_fragment_ms"] = (time.perf_counter() - t0) * 1e3
    out["sac_ms_per_env_step"] = out["sac_fragment_ms"] / RL_FRAGMENT
    log(f"rl sac fragment ok: {RL_FRAGMENT} Pendulum steps, card vs cpu "
        f"actions max |diff| {s_err:.3e} (atol 1e-3); warm fragment "
        f"{out['sac_fragment_ms']:.1f} ms, "
        f"{out['sac_ms_per_env_step']:.3f} ms an env step")
    return out


def rl_phase(seed):
    """Phase 11: every learner's update on the card against the CPU, its
    time and launches; then the workers' fragments."""
    t0 = time.perf_counter()
    results, learners = {}, {}
    for name, (make, update) in rl_cases(seed).items():
        results[name], learners[name] = rl_learner(name, make, update)
    ppo = results["ppo"]
    ppo["step_parts_ms"] = rl_step_parts(learners["ppo"], rl_batch(
        np.random.default_rng(seed), 128))
    log(f"rl ppo update: device busy {ppo['busy_ms']:.3f} ms of "
        f"{ppo['profiled_wall_ms']:.3f} ms profiled wall ({ppo['kernels']} "
        f"kernels), unprofiled {ppo['update_ms']:.3f} ms: bound by the "
        f"host's launches at these widths; one minibatch step's host ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in ppo["step_parts_ms"].items()))
    results["fragments"] = rl_fragments(
        seed, learners["ppo"].get_weights(), learners["sac"].get_weights())
    log(f"rl ok: 8 learner updates and 2 fragments in "
        f"{time.perf_counter() - t0:.1f} s")
    log("rl metrics: " + json.dumps(results))


# ---------------------------------------------------------------------------
# Phase 12: RLlib's algorithms (ray_tpu_torch/rllib/*.py Algorithm subclasses)
# through config.build(), on the in-process runtime, learners and rollout
# actors on the card.

CARD = "cuda"


class TagTeamEnv:
    """Toy 2-agent env (tests/test_rllib_algorithms.py's ``_TagTeamEnv``):
    each agent sees a +/-1 cue and must answer with the matching action; one
    agent's cue is INVERTED so the two agents need different policies."""

    def __init__(self):
        self._rng = np.random.default_rng(0)
        self._t = 0

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._draw(), {}

    def _draw(self):
        self._cue = int(self._rng.integers(0, 2))
        obs = np.asarray([2.0 * self._cue - 1.0], np.float32)
        return {"a0": obs, "a1": -obs}

    def step(self, actions):
        rew = {"a0": float(actions["a0"] == self._cue),
               "a1": float(actions["a1"] == self._cue)}
        self._t += 1
        done = self._t >= 16
        obs = self._draw()
        term = {"a0": done, "a1": done, "__all__": done}
        trunc = {"__all__": False}
        return obs, rew, term, trunc, {}


def tag_team_mapping(agent):
    return "even" if agent == "a0" else "odd"


def write_expert(path, seed):
    """BC's dataset: 6 batches of 128 CartPole-sized observations, action
    1 iff obs[0] > 0, to JSONL shards."""
    from ray_tpu_torch import rllib as rl
    from ray_tpu_torch.rllib import sample_batch as sb

    rng = np.random.default_rng(seed)
    writer = rl.JsonWriter(path)
    for _ in range(6):
        obs = rng.normal(size=(128, 4)).astype(np.float32)
        writer.write(sb.SampleBatch({
            sb.OBS: obs, sb.ACTIONS: (obs[:, 0] > 0).astype(np.int32)}))
    writer.close()


def rl_algo_configs(seed, data_path):
    """name -> (config, iterations, the learner update to time). The JAX
    package's defaults, except IMPALA's fragments (100, 4 an iteration:
    its 8 of 200 would take 5 s an iteration); DQN, Ape-X and SAC run past
    ``learning_starts``."""
    from ray_tpu_torch import rllib as rl

    spec = rl.PolicySpec(1, 2, (16,))
    return {
        "ppo": (rl.PPOConfig(seed=seed).environment(NumpyCartPole), 2,
                "update_from_batch"),
        "a2c": (rl.A2CConfig(seed=seed).environment(NumpyCartPole), 2,
                "update_from_batch"),
        "impala": (rl.IMPALAConfig(seed=seed, max_fragments_per_step=4)
                   .environment(NumpyCartPole)
                   .rollouts(rollout_fragment_length=100), 2,
                   "update_from_fragment"),
        "dqn": (rl.DQNConfig(seed=seed).environment(NumpyCartPole), 3,
                "update_from_buffer"),
        "apex": (rl.ApexDQNConfig(seed=seed).environment(NumpyCartPole), 4,
                 "weighted_update"),
        "sac": (rl.SACConfig(seed=seed).environment(NumpyPendulum), 2,
                "update_from_buffer"),
        "multi-agent": (rl.MultiAgentPPOConfig(seed=seed)
                        .environment(TagTeamEnv)
                        .multi_agent(policies={"even": spec, "odd": spec},
                                     policy_mapping_fn=tag_team_mapping), 2,
                        "update_from_batch"),
        "bc": (rl.BCConfig(input_path=data_path, seed=seed,
                           evaluation_episodes=1)
               .environment(NumpyCartPole), 2, "step"),
    }


def learners_of(algo):
    return list(getattr(algo, "learners", {"": algo.learner}).values())


def time_updates(algo, method):
    """Wrap ``method`` of the algorithm's learners: each call's seconds
    (ended by a synchronise) and arguments go to the returned list."""
    calls = []
    for learner in learners_of(algo):
        fn = getattr(learner, method)

        def timed(*args, _fn=fn, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0, args))
            return out
        setattr(learner, method, timed)
    return calls


def rl_algo_run(name, cfg, iters, method):
    """``iters`` iterations of ``cfg.build(device=CARD)``: each one's ms,
    env steps/s and the learner's share of it; metrics finite."""
    t0 = time.perf_counter()
    algo = cfg.build(device=CARD)
    build_s = time.perf_counter() - t0
    calls = time_updates(algo, method)
    rows = []
    for it in range(iters):
        calls.clear()
        t0 = time.perf_counter()
        m = algo.train()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        learner_ms = sum(t for t, _ in calls) * 1e3
        bad = [k for k, v in m.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad or m["training_iteration"] != it + 1:
            raise AssertionError(f"rl-algo {name}: iteration {it} {m}")
        rows.append({"ms": ms, "env_steps": m["timesteps_this_iter"],
                     "env_steps_per_sec": m.get("env_steps_per_sec"),
                     "learner_ms": learner_ms,
                     "learner_share": learner_ms / ms,
                     "updates": len(calls)})
        log(f"rl-algo {name} iteration {it + 1}: {ms:.1f} ms, "
            f"{m['timesteps_this_iter']} env steps "
            f"({(m.get('env_steps_per_sec') or 0):.1f}/s), learner "
            f"{learner_ms:.1f} ms in {len(calls)} calls (share "
            f"{learner_ms / ms:.3f}), episode return "
            f"{m.get('episode_return_mean')}")
    if sum(r["updates"] for r in rows) == 0:
        raise AssertionError(f"rl-algo {name}: the learner never updated")
    return algo, {"build_s": build_s, "iterations": rows}, m


def rl_first_action_split(cfg, weights, got, want):
    """The first index where the card's iteration batch and the CPU's took
    other actions, checked to be a near-tie of the CPU's draw; None when
    they agree throughout."""
    from ray_tpu_torch import random as rnd

    diff = np.flatnonzero(got["actions"] != want["actions"])
    if not len(diff):
        return None
    t = int(diff[0])
    frag = cfg.rollout_fragment_length
    keys, k = [], rnd.key(cfg.seed + 1 + t // frag, device="cpu")
    for _ in range(t % frag + 1):
        k, sub = rnd.split(k)
        keys.append(sub)
    start = t - t % frag
    margin = rl_tie(weights, want["obs"][start:start + frag], keys, t % frag)
    if margin >= RL_TIE_MARGIN:
        raise AssertionError(f"rl-algo parity: action {t} differs "
                             f"(margin {margin})")
    return t


def rl_algo_parity(name, make_cfg):
    """One iteration of ``make_cfg()`` built on the card and on the CPU from
    one seed: the same batch (actions equal unless a draw is a near-tie),
    metrics and params to RL_METRIC_TOL / RL_PARAM_TOL."""
    runs = {}
    for dev in (CARD, "cpu"):
        algo = make_cfg().build(device=dev)
        weights = algo.get_weights()
        calls = time_updates(algo, "update_from_batch")
        runs[dev] = (algo.train(), calls[0][1][0], algo.get_weights())
        algo.stop()
    (got, gbatch, gw), (want, wbatch, ww) = runs[CARD], runs["cpu"]
    split = rl_first_action_split(make_cfg(), weights, gbatch, wbatch)
    if split is not None:
        log(f"rl-algo parity {name}: near-tie at batch row {split}; the "
            f"iterations part there, so only rows before it are compared")
        return {"near_tie_row": split}
    if (got["timesteps_this_iter"], got["episode_return_mean"]) != \
            (want["timesteps_this_iter"], want["episode_return_mean"]):
        raise AssertionError(f"rl-algo parity {name}: {got} vs {want}")
    keys = set(want) - {"env_steps_per_sec", "episode_return_mean"}
    if set(got) != set(want):
        raise AssertionError(f"rl-algo parity {name}: metrics {sorted(got)}")
    m_err = max(close(f"rl-algo {name} {k}", torch.tensor(float(got[k])),
                      torch.tensor(float(want[k])), *RL_METRIC_TOL)
                for k in keys)
    p_err = max(close(f"rl-algo {name} {k}", v.cpu(), ww[k], *RL_PARAM_TOL)
                for k, v in gw.items())
    log(f"rl-algo parity {name}: one iteration on the card = on the CPU, "
        f"{got['timesteps_this_iter']} env steps with the same actions, "
        f"metrics max |diff| {m_err:.3e}, params {p_err:.3e}")
    return {"metric_err": m_err, "param_err": p_err}


def rl_learner_group(seed):
    """LearnerGroup(num_learners=2) on the card: after one update the two
    replicas' weights are bit-identical."""
    from ray_tpu_torch import rllib as rl
    from ray_tpu_torch.runtime import LocalRuntime

    spec, cfg, rt = rl.PolicySpec(4, 2), rl.PPOConfig(seed=seed), \
        LocalRuntime()
    group = rl.LearnerGroup(functools.partial(
        rl.PPOLearner, spec, cfg, device=CARD), 2, runtime=rt)
    start = group.get_weights()
    group.update_from_batch(rl_batch(np.random.default_rng(seed), 256),
                            num_epochs=1, minibatch_size=256,
                            rng=np.random.default_rng(seed))
    w0, w1 = rt.get([s.get_weights.remote() for s in group._shards])
    for k in w0:
        if not torch.equal(w0[k], w1[k]):
            raise AssertionError(f"rl-algo learner group: replicas differ "
                                 f"at {k}")
    if all(torch.equal(w0[k], start[k]) for k in w0):
        raise AssertionError("rl-algo learner group: no update")
    group.stop()
    log("rl-algo learner group: 2 PPO learners on the card, replicas "
        "bit-identical after one update")


def rl_checkpoint(algo, make_cfg, path):
    """A checkpoint taken on the card restores on the CPU, weights equal."""
    file = algo.save_checkpoint(path)
    cpu = make_cfg().build(device="cpu")
    cpu.restore_checkpoint(path)
    want = algo.get_weights()
    for k, v in cpu.get_weights().items():
        if not torch.equal(v, want[k].cpu()):
            raise AssertionError(f"rl-algo checkpoint: {k} differs")
    if cpu.iteration != algo.iteration:
        raise AssertionError("rl-algo checkpoint: iteration differs")
    cpu.stop()
    log(f"rl-algo checkpoint: {os.path.basename(file)} from the card "
        f"restores on the CPU, weights equal")


def rl_algo_phase(seed):
    """Phase 12: every algorithm's train() on the card; PPO and A2C against
    the CPU; the learner group's replicas; a checkpoint card -> CPU."""
    from ray_tpu_torch import rllib as rl

    t0 = time.perf_counter()
    os.makedirs("chiprun_out", exist_ok=True)
    results = {}
    with tempfile.TemporaryDirectory(dir="chiprun_out") as tmp:
        data = os.path.join(tmp, "expert")
        write_expert(data, seed)
        cfgs = rl_algo_configs(seed, data)
        for name in ("ppo", "a2c"):
            results[f"{name}_parity"] = rl_algo_parity(
                name, lambda name=name: rl_algo_configs(seed, data)[name][0])
        algos = {}
        for name, (cfg, iters, method) in cfgs.items():
            algos[name], results[name], last = rl_algo_run(
                name, cfg, iters, method)
        rl_learner_group(seed)
        rl_checkpoint(algos["ppo"],
                      lambda: rl.PPOConfig(seed=seed).environment(
                          NumpyCartPole), os.path.join(tmp, "ckpt"))
        for algo in algos.values():
            algo.stop()
    results["phase_s"] = time.perf_counter() - t0
    log(f"rl-algo ok: 8 algorithms, 2 parity iterations, the learner group "
        f"and a checkpoint in {results['phase_s']:.1f} s")
    log("rl-algo metrics: " + json.dumps(results))
    return results


# ---------------------------------------------------------------------------
# Phase 13: the serving tier (replicas, router, KV handoff) on the
# in-process runtime, through its serve facet.

KV_FRAME_SHAPE = (32, 1, 1024, 32, 128)    # llama-7b K block at bucket 1024
APP_BUCKETS = (128, 256, 512, 1024)
# llama-7b's params at SERVE_LAYERS layers: 131,080,192 outside the
# blocks and 157,334,272 a block (5,165,776,896 at all 32).
SERVE_PARAMS = 131_080_192 + SERVE_LAYERS * 157_334_272


def kv_frame():
    """13(a): one KV block at llama-7b width through the device-object frame
    (pickle protocol 5, the port's hook as ``reducer_override``, buffers out
    of band), no store: one host staging copy, then a rebuild on the card
    and one on the CPU, each bit for bit."""
    import io
    import pickle

    from ray_tpu_torch._private import device_objects as tdo

    slot = {}
    tdo.install(lambda fn: slot.update(hook=fn))
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(13)
    for dtype in (torch.bfloat16, torch.float32):
        k = torch.randn(KV_FRAME_SHAPE, generator=gen, device="cuda").to(dtype)
        reduced, buffers = [], []

        class Pickler(pickle.Pickler):
            def reducer_override(self, obj):
                r = slot["hook"](obj)
                if r is None:
                    return NotImplemented
                reduced.append(r)
                return r

        tdo.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with io.BytesIO() as f:
            Pickler(f, protocol=5, buffer_callback=buffers.append).dump(k)
            meta = f.getvalue()
        put_ms = (time.perf_counter() - t0) * 1e3
        stats = tdo.stats()
        oob = sum(b.raw().nbytes for b in buffers)
        if stats["host_materializations"] != 1 or stats["puts"] != 1 or \
                oob < k.nbytes or len(meta) >= 64 * 1024:
            raise AssertionError(f"kv frame {dtype}: stats {stats}, "
                                 f"out of band {oob} B of {k.nbytes}, "
                                 f"metadata {len(meta)} B")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = pickle.loads(meta, buffers=[b.raw() for b in buffers])
        torch.cuda.synchronize()
        cuda_ms = (time.perf_counter() - t0) * 1e3
        header = json.loads(reduced[0][1][0])
        header["device"] = "cpu"
        t0 = time.perf_counter()
        host = tdo.rebuild_tensor(json.dumps(header).encode(),
                                  buffers[0].raw())
        cpu_ms = (time.perf_counter() - t0) * 1e3
        if not (back.is_cuda and back.dtype == dtype and host.dtype == dtype
                and host.device.type == "cpu"
                and torch.equal(back.view(torch.uint8), k.view(torch.uint8))
                and torch.equal(host.view(torch.uint8),
                                k.cpu().view(torch.uint8))):
            raise AssertionError(f"kv frame {dtype}: rebuilds differ")
        gb = k.nbytes / 1e9
        name = str(dtype).removeprefix("torch.")
        out[name] = {"bytes": k.nbytes, "put_ms": put_ms,
                     "put_gb_per_s": gb / put_ms * 1e3, "cuda_rebuild_ms":
                     cuda_ms, "cuda_gb_per_s": gb / cuda_ms * 1e3,
                     "cpu_rebuild_ms": cpu_ms,
                     "cpu_gb_per_s": gb / cpu_ms * 1e3,
                     "metadata_bytes": len(meta)}
        log(f"serve-app kv frame {name} {list(KV_FRAME_SHAPE)} ({k.nbytes} B):"
            f" 1 host staging copy, {oob} B out of band, metadata "
            f"{len(meta)} B; put {put_ms:.3f} ms ({out[name]['put_gb_per_s']:.2f}"
            f" GB/s), rebuild on cuda {cuda_ms:.3f} ms "
            f"({out[name]['cuda_gb_per_s']:.2f} GB/s), on the CPU "
            f"{cpu_ms:.3f} ms ({out[name]['cpu_gb_per_s']:.2f} GB/s); both "
            f"bit for bit")
        del k, back, host, buffers, reduced
    return out


class HandoffProbe:
    """Wraps the replicas' ``publish_kv`` and ``adopt_kv`` for one app run:
    times each (device work synchronised), and checks every adopted K/V is
    on the card and, in process, the tensor that was published."""

    def __init__(self, rp):
        self.rp = rp
        self.published, self.publish_ms, self.adopt_ms = {}, [], []
        self.adopted = 0

    def __enter__(self):
        pub, adopt = self.rp.publish_kv, self.rp.adopt_kv

        def publish_kv(kv, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            handoff = pub(kv, *args, **kw)
            torch.cuda.synchronize()
            self.publish_ms.append((time.perf_counter() - t0) * 1e3)
            self.published[id(handoff["k_ref"])] = (kv["k"], kv["v"])
            return handoff

        def adopt_kv(handoff, **kw):
            t0 = time.perf_counter()
            out = adopt(handoff, **kw)
            self.adopt_ms.append((time.perf_counter() - t0) * 1e3)
            k, v = self.published.pop(id(handoff["k_ref"]))
            if not (out["k"] is k and out["v"] is v):
                raise AssertionError("serve-app: adopted K/V is not the "
                                     "published tensor")
            if out["k"].device.type != CARD or out["v"].device.type != CARD:
                raise AssertionError(f"serve-app: adopted K/V on "
                                     f"{out['k'].device}")
            self.adopted += 1
            return out

        self.saved = pub, adopt
        self.rp.publish_kv, self.rp.adopt_kv = publish_kv, adopt_kv
        return self

    def __exit__(self, *exc):
        self.rp.publish_kv, self.rp.adopt_kv = self.saved
        self.published.clear()


def app_streams(handle, prompts, n, seeds):
    """Every prompt through ``handle.generate_stream`` from its own client
    thread, all at once. Returns (chunks per request, seconds from the
    request to its first chunk)."""
    import threading

    chunks, ttft, errors = [None] * len(prompts), [None] * len(prompts), []
    start = threading.Barrier(len(prompts))

    def client(i):
        try:
            start.wait(timeout=60)
            t0 = time.perf_counter()
            stream = handle.generate_stream.remote_gen(
                {"prompt": prompts[i], "n": n, "seed": seeds[i]})
            got = [next(stream)]
            ttft[i] = time.perf_counter() - t0
            got += list(stream)
            chunks[i] = got
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(c is None for c in chunks):
        raise AssertionError(f"serve-app: client failed: {errors!r}")
    return chunks, ttft


def engine_stats(rt, name):
    return rt.serve.get_deployment_handle(name).serve_stats.remote().result()


APP_CHECK_SAMPLING = dict(temperature=0.8, top_k=50)


def app_check_refs(tm, gen, preset="llama-7b"):
    """Phase 9's sizes (two layers, f32) and what an app must give there:
    (engine config, prompts, tokens a request, sampled seeds, the argmax
    rollout of ``models.forward``, a solo engine's sampled streams)."""
    from ray_tpu_torch.serve.llm import EngineConfig
    from ray_tpu_torch.serve.llm import replicas as rp
    from ray_tpu_torch.serve.llm.engine import InflightBatchEngine

    base = dict(preset=preset,
                model_overrides={"n_layers": 2, "dtype": "float32"},
                max_slots=4, max_len=320, paged_kv=True, kv_block_size=16,
                prefill_chunk=64, max_new_tokens=16, prompt_buckets=(320,))
    ec = EngineConfig.from_dict(base)
    cfg, params = rp._build_model(ec, device=CARD)
    params = gen.serving_params(params, cfg, CARD)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVE_CHECK_LENS]
    n, seeds = 8, [11, 12, 13, 14]
    fwd_cfg = dataclasses.replace(cfg, remat=False)
    rollout = []
    with torch.no_grad():
        for p in prompts:
            seq = list(p)
            for _ in range(n):
                logits = tm.forward(params, torch.tensor([seq], device=CARD),
                                    fwd_cfg)
                seq.append(int(logits[0, -1].argmax()))
            rollout.append(seq[len(p):])
    solo = InflightBatchEngine(params, cfg, EngineConfig.from_dict(
        dict(base, **APP_CHECK_SAMPLING)), replica_id="app-solo",
        device=CARD)
    try:
        solo_streams = [solo.generate(p, n, seed=s)
                        for p, s in zip(prompts, seeds)]
    finally:
        solo.stop()
    del params
    return base, prompts, n, seeds, rollout, solo_streams


def serve_app_check(tm, gen, preset="llama-7b"):
    """13(b): phase 9's sizes (two layers, f32) through the combined and the
    disaggregated app on the in-process runtime, token-exact."""
    from ray_tpu_torch._private import device_objects as tdo
    from ray_tpu_torch.runtime import LocalRuntime
    from ray_tpu_torch.serve.llm import build_llm_app
    from ray_tpu_torch.serve.llm import replicas as rp

    base, prompts, n, seeds, rollout, solo_streams = app_check_refs(
        tm, gen, preset)
    sampled = APP_CHECK_SAMPLING

    rt = LocalRuntime()
    results, batches = {}, []

    def run_app(label, mode, **kw):
        name = f"app-{label}"
        handle = rt.serve.run(build_llm_app(
            dict(base, **kw), runtime=rt, device=CARD, mode=mode, name=name))
        tdo.reset_stats()
        with HandoffProbe(rp) as probe:
            chunks, _ = app_streams(handle, prompts, n,
                                    seeds if kw.get("temperature") else
                                    [0] * len(prompts))
            tokens = [[t for c in cs for t in c] for cs in chunks]
            adopted = probe.adopted
        pool = f"{name}-decode" if mode == "disaggregated" else \
            f"{name}-engine"
        left = engine_stats(rt, pool)["kv_blocks_used"]
        stats = tdo.stats()
        batched = engine_stats(rt, f"{name}-prefill")[
            "prefill_batched_total"] if mode == "disaggregated" else 0
        for dep in (name, f"{name}-prefill", f"{name}-decode",
                    f"{name}-engine"):
            rt.serve.delete(dep)
        if left:
            raise AssertionError(f"serve-app {label}: {left} blocks left")
        if mode == "disaggregated":
            firsts_ok = all(len(cs[0]) == 1 and cs[0][0] == t[0]
                            for cs, t in zip(chunks, tokens))
            if not firsts_ok or adopted != len(prompts) or \
                    stats["local_hits"] != 2 * len(prompts) or \
                    stats["rebuilds"] or stats["puts"]:
                raise AssertionError(
                    f"serve-app {label}: first chunks {chunks}, adopted "
                    f"{adopted}, device objects {stats}")
        results[label] = tokens
        return tokens, batched

    real = gen.prefill_slots

    def spy(params, prompts_, *args, **kw):
        batches.append(int(prompts_.shape[0]))
        return real(params, prompts_, *args, **kw)

    for label, mode in (("combined", "combined"),
                        ("disagg", "disaggregated")):
        got, _ = run_app(label, mode)
        if got != rollout:
            raise AssertionError(f"serve-app {label}: {got} != argmax "
                                 f"rollout {rollout}")
        got, _ = run_app(f"{label}-sampled", mode, **sampled)
        if got != solo_streams:
            raise AssertionError(f"serve-app {label} sampled: {got} != solo "
                                 f"engine {solo_streams}")
    gen.prefill_slots = spy
    try:
        got, batched = run_app("disagg-batch4", "disaggregated",
                               prefill_batch_size=4,
                               prefill_batch_window_ms=200.0)
    finally:
        gen.prefill_slots = real
    if got != results["disagg"] or batched != len(prompts) or \
            batches != [4]:
        raise AssertionError(f"serve-app batch 4: {got} vs batch 1 "
                             f"{results['disagg']}, batched {batched}, "
                             f"prefill_slots runs {batches}")
    log(f"serve-app check ok: {preset} widths, 2 layers, f32, prompts "
        f"{list(SERVE_CHECK_LENS)}: combined and disaggregated apps = argmax "
        f"rollout (greedy) and = a solo engine (temperature 0.8, top_k 50), "
        f"streamed from {len(prompts)} client threads; the first chunk is "
        f"the prefill token; prefill_batch_size 4 (one prefill_slots run of "
        f"{batches[0]}) = batch 1; every adopted K/V on {CARD} and the "
        f"published tensor itself; every KV block returned")


def serve_app(tm, gen, fa, seed):
    """13(c): the disaggregated app at full llama-7b width, ``SERVE_LAYERS``
    deep, bf16, on phase 10's 16 prompts from 16 client threads."""
    from ray_tpu_torch._private import device_objects as tdo
    from ray_tpu_torch.runtime import LocalRuntime
    from ray_tpu_torch.serve.llm import build_llm_app
    from ray_tpu_torch.serve.llm import replicas as rp

    gc_collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ec = dict(preset="llama-7b", model_overrides=SERVE_DEPTH, param_seed=seed,
              max_slots=8, max_len=2048, paged_kv=True, kv_block_size=16,
              prefill_chunk=512, prompt_buckets=APP_BUCKETS,
              max_new_tokens=SERVE_NEW,
              prefill_batch_size=4, prefill_batch_window_ms=5.0)
    rt = LocalRuntime()
    t0 = time.perf_counter()
    handle = rt.serve.run(build_llm_app(ec, runtime=rt, mode="disaggregated",
                                        name="llm7b"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    prefill = rt.serve._replicas["llm7b-prefill"][0].instance
    cfg = prefill._cfg
    n_params = tm.count_params(prefill._params)
    if n_params != SERVE_PARAMS:
        raise AssertionError(f"serve-app: {n_params} params")
    prompts = serve_prompts(seed, cfg.vocab_size)
    steps = []
    decode = gen.decode_step_paged

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = decode(*args, **kw)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0, int(args[3].sum())))
        return out

    fa.reset_launches()
    tdo.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    gen.decode_step_paged = timed
    try:
        with HandoffProbe(rp) as probe:
            t0 = time.perf_counter()
            chunks, ttft = app_streams(handle, prompts, SERVE_NEW,
                                       [0] * len(prompts))
            wall = time.perf_counter() - t0
            adopted = probe.adopted
            handoff_ms = [p + a for p, a in zip(probe.publish_ms,
                                                probe.adopt_ms)]
    finally:
        gen.decode_step_paged = decode
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    flash = {k.symbol.removeprefix("rtt_"): k.launches for k in fa.KERNELS}
    tokens = [[t for c in cs for t in c] for cs in chunks]
    short = [i for i, t in enumerate(tokens) if len(t) != SERVE_NEW]
    decode_stats = engine_stats(rt, "llm7b-decode")
    batched = engine_stats(rt, "llm7b-prefill")["prefill_batched_total"]
    if short or decode_stats["kv_blocks_used"] or adopted != len(prompts) \
            or not all(0 <= x < cfg.vocab_size for t in tokens for x in t):
        raise AssertionError(f"serve-app: requests {short} short of "
                             f"{SERVE_NEW}, adopted {adopted}, decode "
                             f"stats {decode_stats}")
    # prefill_slot's first-token logits (the bucket-padded one-shot
    # prefill the prefill replica runs) against models.forward.
    fwd_cfg = dataclasses.replace(cfg, remat=False)
    errs = []
    with torch.no_grad():
        for p in prompts:
            bucket = prefill._bucket_for(len(p))
            padded = torch.zeros(1, bucket, dtype=torch.int64, device="cuda")
            padded[0, :len(p)] = torch.tensor(p)
            cache = gen.init_cache(cfg, 1, bucket, device="cuda")
            logits, _ = gen._forward_cached(prefill._params, padded, cache,
                                            cfg)
            ref = tm.forward(prefill._params, torch.tensor([p], device="cuda"),
                             fwd_cfg)[0, -1]
            errs.append(close(f"prefill_slot logits ({len(p)} tokens)",
                              logits[0, len(p) - 1], ref, SERVE_LOGIT_ATOL,
                              0.0))
            del cache, logits
    for dep in ("llm7b", "llm7b-prefill", "llm7b-decode"):
        rt.serve.delete(dep)
    del prefill, handle
    gc_collect()
    step_s = sum(t for t, _ in steps)
    out = {
        "ttft_p50_ms": percentile(ttft, 50) * 1e3,
        "ttft_p99_ms": percentile(ttft, 99) * 1e3,
        "decode_tokens_per_s": sum(n for _, n in steps) / step_s,
        "decode_step_ms": step_s / len(steps) * 1e3,
        "decode_steps": len(steps),
        "handoff_ms_p50": percentile(handoff_ms, 50),
        "publish_ms_p50": percentile(probe.publish_ms, 50),
        "adopt_ms_p50": percentile(probe.adopt_ms, 50),
        "prefill_batched_total": batched,
        "output_tokens_per_s": sum(map(len, tokens)) / wall,
        "wall_s": wall, "build_s": build_s,
        "build_peak_gb": build_peak, "serve_peak_gb": serve_peak,
        "peak_gb": max(build_peak, serve_peak),
        "first_logits_max_abs_err": max(errs),
        "device_objects": tdo.stats(),
    }
    if out["peak_gb"] > 80:
        raise AssertionError(f"serve-app: peak {out['peak_gb']:.2f} GB")
    log(f"serve-app ok: llama-7b {n_params} params, bf16, disaggregated "
        f"(router, 1 prefill replica with prefill_batch_size 4, 1 decode "
        f"replica: paged, 8 slots, max_len 2048, block 16); {len(prompts)} "
        f"prompts of {min(map(len, prompts))}-{max(map(len, prompts))} "
        f"tokens x {SERVE_NEW} from {len(prompts)} client threads in "
        f"{wall:.3f} s; TTFT p50 {out['ttft_p50_ms']:.1f} ms p99 "
        f"{out['ttft_p99_ms']:.1f} ms; decode "
        f"{out['decode_tokens_per_s']:.1f} tokens/s over {len(steps)} steps "
        f"({out['decode_step_ms']:.3f} ms a step); publish + adopt "
        f"{out['handoff_ms_p50']:.3f} ms a request (p50); prefill batched "
        f"{batched} of {len(prompts)}; every budget met, every KV block "
        f"returned, every adopted K/V on cuda; first-token logits vs "
        f"models.forward max |diff| {max(errs):.4f} (atol "
        f"{SERVE_LOGIT_ATOL}); flash launches {flash}; peak memory "
        f"{out['peak_gb']:.2f} GB (build {build_peak:.2f}, serving "
        f"{serve_peak:.2f})")
    return out


def gc_collect():
    import gc

    gc.collect()
    if CARD == "cuda":
        torch.cuda.empty_cache()


def serve_app_phase(tm, gen, fa, seed):
    """Phase 13: (a) the KV frame, (b) the exact check, (c) full width."""
    t0 = time.perf_counter()
    results = {"kv_frame": kv_frame()}
    gc_collect()
    serve_app_check(tm, gen)
    gc_collect()
    results["app"] = serve_app(tm, gen, fa, seed)
    results["phase_s"] = time.perf_counter() - t0
    log(f"serve-app phase ok in {results['phase_s']:.1f} s")
    log("serve-app metrics: " + json.dumps(results))
    return results


# ---------------------------------------------------------------------------
# Phase 14: the gang trainer (``ray_tpu_torch/train``) and DD-PPO over the
# port's collectives (``ray_tpu_torch/parallel/collective.py``).

GANG_CKPT_STEP = 3
# The trainer's loop is phase 4's step written out (loss_fn, backward,
# AdamW), so its losses are phase 4's to float32 determinism: 1e-6, or
# phase 4's own spread between two runs in this call where that is larger.
GANG_LOSS_ATOL = 1e-6
# 14b: two ranks on half batches against one process on the whole batch.
# The halves' bf16 products run other cuBLAS tilings than the whole
# batch's, so logits differ by bf16 rounding (2^-8 relative) here and there;
# over 8,192 tokens the mean loss (about 10.9) moves by far less than 1e-3,
# and the gradient norm by well under 1e-2 relative. Each leaf's averaged
# gradient is held to the whole batch's in relative L2 norm: rounding at
# 2^-8 per product, spread over the leaf's entries, keeps that under
# 2^-8 ~ 4e-3, so 1e-2; a bucket slice written into the wrong leaf gives
# an error of order 1. AdamW's first step moves a param by about
# lr * sign(g) whatever the gradient's size, so the params are not checked
# against the whole batch's: the ranks' params after their step are held,
# bit for bit, to one AdamW step taken here on the gradients rank 0
# averaged, which shows the step consumed exactly those gradients.
HALVES_LOSS_ATOL, HALVES_GNORM_RTOL, HALVES_GRAD_RTOL = 1e-3, 1e-2, 1e-2
HALVES_STEP_ATOL = 0.0


def gang_loop(config):
    """Phase 4's model, batch and AdamW on the gang's one rank: loss_fn,
    backward, ``train.torch.backward_allreduce``, the optimizer; a report
    every step and a checkpoint (params and optimizer state) at
    GANG_CKPT_STEP. Resumes after a checkpoint's step. On its first step it
    checks the group's ops on a CUDA tensor through NCCL at world 1."""
    import torch.distributed as dist

    from ray_tpu_torch import models as tm
    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.parallel import collective
    from ray_tpu_torch.train import torch as rt_torch

    dev = rt_train.get_device()
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    state = new_state(tm, cfg)
    leaves = tt.tree_leaves(state.params)
    opt = state.opt_state
    start = 0
    ckpt = rt_train.get_checkpoint()
    if ckpt is not None:
        saved = ckpt.to_pytree(device=dev)
        with torch.no_grad():
            for p, q in zip(leaves, tt.tree_leaves(saved["params"])):
                p.copy_(q)
        opt.load_state_dict(saved["opt"])
        start = ckpt.to_dict()["step"] + 1
    else:
        g = collective.get_group(
            rt_train.session._get_session().collective_group_name)
        if not (isinstance(g, collective.TorchDistGroup)
                and dist.get_backend() == "nccl" and g.world_size == 1):
            raise AssertionError(f"gang: group {type(g).__name__} on "
                                 f"{dist.get_backend()}")
        x = torch.arange(8.0, device=dev)
        outs = {f"allreduce-{op}": g.allreduce(x, op=collective.ReduceOp[op])
                for op in ("SUM", "AVG", "MAX")}
        outs.update(broadcast=g.broadcast(x), allgather=g.allgather(x)[0],
                    reducescatter=g.reducescatter(x))
        for name, out in outs.items():
            if out.device != dev or not torch.equal(out, x):
                raise AssertionError(f"gang: NCCL {name} gave {out}")
    batch = train_batch(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    for step in range(start, config["steps"]):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = tm.loss_fn(state.params, batch, cfg)
        loss.backward()
        rt_torch.backward_allreduce(leaves)
        opt.step()
        value = loss.item()                      # waits for the step
        dt = time.perf_counter() - t0
        rt_train.report(
            {"step": step, "loss": value, "s": dt,
             "peak": torch.cuda.max_memory_allocated()},
            checkpoint=rt_train.Checkpoint.from_pytree(
                {"params": state.params, "opt": opt.state_dict()},
                extra={"step": step}) if step == GANG_CKPT_STEP else None)


def gang_fit(fa, storage, resume=None):
    """One ``TorchDistTrainer.fit()`` of ``gang_loop`` on the in-process
    runtime, NCCL, one GPU rank; (result, flash launches in it)."""
    from ray_tpu_torch import train as rt_train

    trainer = rt_train.TorchDistTrainer(
        gang_loop, train_loop_config={"steps": WARMUP_STEPS + TIMED_STEPS},
        scaling_config=rt_train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=rt_train.RunConfig(name="gang", storage_path=storage),
        backend="torch_dist", resume_from_checkpoint=resume)
    torch.cuda.synchronize()
    fa.reset_launches()
    result = trainer.fit()
    launches = {k.symbol.removeprefix("rtt_"): k.launches for k in fa.KERNELS}
    if not result.ok:
        raise AssertionError(f"gang: fit failed: {result.error}")
    return result, launches


def gang_trainer(tm, fa, run, spread):
    """14a: the gang trainer on the card at phase 4's size."""
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    tol = max(GANG_LOSS_ATOL, spread)
    with tempfile.TemporaryDirectory(dir="chiprun_out") as storage:
        result, launches = gang_fit(fa, storage)
        hist = result.metrics_history
        losses = [m["loss"] for m in hist]
        steps = WARMUP_STEPS + TIMED_STEPS
        want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
                "flash_bwd_dkv": cfg.n_layers}
        for name, per_step in want.items():
            if launches[name] != per_step * steps:
                raise AssertionError(f"gang: {name} launched "
                                     f"{launches[name]} times in {steps} "
                                     f"steps, want {per_step} per step")
        err = max(abs(a - b) for a, b in zip(losses, run.losses))
        if len(losses) != steps or err > tol:
            raise AssertionError(f"gang: losses {losses} vs phase 4's "
                                 f"{run.losses} (tol {tol})")
        if result.checkpoint.to_dict()["step"] != GANG_CKPT_STEP:
            raise AssertionError("gang: no checkpoint at step 3")
        gc_collect()
        resumed, resumed_launches = gang_fit(fa, storage, result.checkpoint)
        for name, per_step in want.items():
            if resumed_launches[name] != per_step * (steps - GANG_CKPT_STEP
                                                     - 1):
                raise AssertionError(f"gang: resumed {name} launched "
                                     f"{resumed_launches[name]} times")
        tail = [m["loss"] for m in resumed.metrics_history]
        resume_err = max(abs(a - b) for a, b in
                         zip(tail, losses[GANG_CKPT_STEP + 1:]))
        if [m["step"] for m in resumed.metrics_history] != list(
                range(GANG_CKPT_STEP + 1, steps)) or resume_err > tol:
            raise AssertionError(f"gang: resumed losses {tail} vs "
                                 f"{losses[GANG_CKPT_STEP + 1:]}")
    step_ms = statistics.median(m["s"] for m in hist[WARMUP_STEPS:]) * 1e3
    out = {"losses": losses, "loss_err": err, "tol": tol,
           "phase4_spread": spread, "resume_err": resume_err,
           "launches": launches, "resumed_launches": resumed_launches,
           "step_ms": step_ms, "phase4_step_ms": run.step_ms,
           "overhead_ms": step_ms - run.step_ms,
           "peak_gb": max(m["peak"] for m in hist) / 1e9}
    log(f"gang-train ok: TorchDistTrainer, 1 rank on NCCL, gpt2-125m "
        f"batch {B} seq {L}: losses = phase 4's within {err:.3e} (tol "
        f"{tol:.1e}; phase 4 against itself {spread:.3e}); launches "
        f"{launches} in {steps} steps; resumed at step {GANG_CKPT_STEP + 1} "
        f"within {resume_err:.3e}; NCCL allreduce SUM/AVG/MAX, broadcast, "
        f"allgather, reducescatter at world 1 exact")
    log(f"gang-train step_ms {step_ms:.2f} (median of {TIMED_STEPS}; all "
        f"{[round(m['s'] * 1e3, 2) for m in hist]}), phase 4 "
        f"{run.step_ms:.2f} ms, trainer overhead {step_ms - run.step_ms:.2f}"
        f" ms a step, peak memory {out['peak_gb']:.2f} GB; card: "
        f"{gpu_line()}")
    return out


GANG_RANK_SRC = """
import json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from ray_tpu_torch import models as tm
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.train import torch as rt_torch
import functools
rank, world, addr, out = int(sys.argv[1]), 2, sys.argv[2], sys.argv[3]
g = collective.TorchDistGroup(world, rank, "halves", device="cpu",
                              address=addr)
cfg = tm.GPTConfig.preset("gpt2-125m", max_seq={L}, flash_attention=True)
state = tm.make_train_state(
    cfg, functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.1),
    generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
toks = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab_size, ({B}, {L} + 1))).cuda().chunk(world)[rank]
leaves = tt.tree_leaves(state.params)
loss = tm.loss_fn(state.params, {{"inputs": toks[:, :-1],
                                  "targets": toks[:, 1:]}}, cfg)
loss.backward()
torch.cuda.synchronize()
t0 = time.perf_counter()
rt_torch.backward_allreduce(leaves, group=g)
torch.cuda.synchronize()
bucket_s = time.perf_counter() - t0
gnorm = torch.linalg.vector_norm(torch.stack(
    [torch.linalg.vector_norm(p.grad) for p in leaves])).item()
if rank == 0:
    torch.save([p.grad.detach().cpu() for p in leaves],
               os.path.join(out, "grads.pt"))
state.opt_state.step()
mean = g.allreduce(loss.detach().cpu().reshape(1),
                   op=collective.ReduceOp.AVG).item()
marks = torch.stack([torch.stack([p.double().sum(), p.double().square().sum()])
                     for p in leaves]).cpu()
same = torch.equal(g.allreduce(marks, op=collective.ReduceOp.MAX),
                   g.allreduce(marks, op=collective.ReduceOp.MIN))
if rank == 0:
    torch.save([p.detach().cpu() for p in leaves],
               os.path.join(out, "params.pt"))
with open(os.path.join(out, f"rank{{rank}}.json"), "w") as f:
    json.dump({{"loss": loss.item(), "mean_loss": mean, "grad_norm": gnorm,
               "bucket_s": bucket_s, "ranks_equal": same,
               "backend": torch.distributed.get_backend()}}, f)
g.destroy()
"""


def gang_halves(tm):
    """14b: two ranks in two processes on the one card, each on half of
    phase 4's batch, gradients averaged through a ``TorchDistGroup``,
    against one process's step on the whole batch. NCCL refuses two ranks
    on one device, so this world is gloo over host-staged f32 buckets
    (``backward_allreduce`` copies each bucket to the group's device, the
    CPU, and back); NCCL across ranks is not exercised on one card."""
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.parallel.collective import _free_port

    repo = os.path.dirname(os.path.abspath(__file__))
    src = GANG_RANK_SRC.format(repo=repo, B=B, L=L)
    addr = f"127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory(dir="chiprun_out") as out:
        logs = [open(os.path.join(out, f"rank{r}.log"), "w")
                for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", src, str(r), addr,
                                   out], stdout=f, stderr=subprocess.STDOUT)
                 for r, f in enumerate(logs)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        wall_s = time.perf_counter() - t0
        if rcs != [0, 0]:
            tails = [open(os.path.join(out, f"rank{r}.log")).read()[-3000:]
                     for r in range(2)]
            raise AssertionError(f"gang-halves: ranks exited {rcs}: {tails}")
        ranks = [json.load(open(os.path.join(out, f"rank{r}.json")))
                 for r in range(2)]
        got = torch.load(os.path.join(out, "params.pt"), weights_only=True)
        grads = torch.load(os.path.join(out, "grads.pt"), weights_only=True)
    # One process, the whole batch, the same model.
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    state = new_state(tm, cfg)
    loss = tm.loss_fn(state.params, train_batch(cfg.vocab_size), cfg)
    loss.backward()
    leaves = tt.tree_leaves(state.params)
    gnorm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in leaves])).item()
    grad_errs = []
    for i, (a, p) in enumerate(zip(grads, leaves)):
        a = a.cuda()
        if a.shape != p.grad.shape or not torch.isfinite(a).all():
            raise AssertionError(f"gang-halves grad {i}: shape "
                                 f"{tuple(a.shape)} or non-finite values")
        grad_errs.append((torch.linalg.vector_norm(a - p.grad) / max(
            torch.linalg.vector_norm(p.grad).item(), 1e-30)).item())
    worst = max(range(len(grad_errs)), key=grad_errs.__getitem__)
    if grad_errs[worst] > HALVES_GRAD_RTOL:
        raise AssertionError(f"gang-halves: leaf {worst}'s averaged gradient"
                             f" is {grad_errs[worst]:.3e} from the whole "
                             f"batch's in relative L2 (rtol "
                             f"{HALVES_GRAD_RTOL})")
    # AdamW's step on the gradients the ranks averaged.
    with torch.no_grad():
        for a, p in zip(grads, leaves):
            p.grad.copy_(a)
    state.opt_state.step()
    if not all(r["ranks_equal"] and r["backend"] == "gloo" for r in ranks):
        raise AssertionError(f"gang-halves: ranks differ {ranks}")
    loss_err = abs(ranks[0]["mean_loss"] - loss.item())
    gnorm_err = abs(ranks[0]["grad_norm"] - gnorm) / gnorm
    if loss_err > HALVES_LOSS_ATOL or gnorm_err > HALVES_GNORM_RTOL:
        raise AssertionError(f"gang-halves: loss {ranks[0]['mean_loss']} vs "
                             f"{loss.item()}, grad norm "
                             f"{ranks[0]['grad_norm']} vs {gnorm}")
    param_err = max(close(f"gang-halves param {i}", a.cuda(), b.detach(),
                          HALVES_STEP_ATOL, 0.0)
                    for i, (a, b) in enumerate(zip(got, leaves)))
    nbytes = sum(p.numel() for p in leaves) * 4
    out = {"mean_loss": ranks[0]["mean_loss"], "full_loss": loss.item(),
           "loss_err": loss_err, "grad_norm": ranks[0]["grad_norm"],
           "full_grad_norm": gnorm, "grad_norm_rel_err": gnorm_err,
           "leaf_grad_rel_err_max": grad_errs[worst],
           "leaf_grad_rel_err_median": statistics.median(grad_errs),
           "step_param_err": param_err,
           "bucket_s": [r["bucket_s"] for r in ranks],
           "grad_bytes": nbytes, "wall_s": wall_s}
    log(f"gang-halves ok: 2 ranks x {B // 2} x {L} on one card over gloo, "
        f"mean loss {ranks[0]['mean_loss']:.6f} vs whole batch "
        f"{loss.item():.6f} (|diff| {loss_err:.3e}, atol "
        f"{HALVES_LOSS_ATOL}), grad norm rel err {gnorm_err:.3e} (rtol "
        f"{HALVES_GNORM_RTOL}), {len(grad_errs)} leaves' averaged gradients"
        f" within {grad_errs[worst]:.3e} relative L2 of the whole batch's "
        f"(median {out['leaf_grad_rel_err_median']:.3e}, rtol "
        f"{HALVES_GRAD_RTOL}), params after AdamW = AdamW of those "
        f"gradients within {param_err:.3e} (atol {HALVES_STEP_ATOL}); "
        f"ranks equal")
    log(f"gang-halves buckets: {nbytes / 1e6:.1f} MB of f32 gradients "
        f"through gloo in {[round(s * 1e3, 1) for s in out['bucket_s']]} ms"
        f" ({nbytes / 1e9 / max(out['bucket_s']):.3f} GB/s); both ranks "
        f"{wall_s:.1f} s from spawn to exit; card: {gpu_line()}")
    return out


def ddppo_run(dev, seed):
    """Two iterations of DD-PPO on ``torch_dist`` with one member on the
    in-process runtime: each iteration's metrics and ms, each fragment's
    first key, weights and batch, and the final weights."""
    from ray_tpu_torch import rllib as rl

    algo = rl.DDPPOConfig(collective_backend="torch_dist",
                          num_rollout_workers=1, seed=seed).environment(
        NumpyCartPole).build(device=dev)
    sampler = algo.workers[0]._instance.sampler   # an in-process actor
    sample, samples = sampler.sample, []

    def recorded(weights):
        key = sampler._rng.cpu()
        batch = sample(weights)
        samples.append((key, {k: v.cpu() for k, v in weights.items()},
                        batch))
        return batch

    sampler.sample = recorded
    iters = []
    for _ in range(2):
        t0 = time.perf_counter()
        m = algo.train()
        if dev == CARD:
            torch.cuda.synchronize()
        iters.append((m, (time.perf_counter() - t0) * 1e3))
    weights = {k: v.cpu() for k, v in algo.get_weights().items()}
    algo.stop()
    return iters, samples, weights


def ddppo_phase(seed):
    """14c: DD-PPO on the card against the same run on the CPU."""
    from ray_tpu_torch import random as rnd
    from ray_tpu_torch.rllib.sample_batch import ACTIONS, OBS

    card = ddppo_run(CARD, seed)
    cpu = ddppo_run("cpu", seed)
    out = {"iteration_ms": [ms for _, ms in card[0]],
           "cpu_iteration_ms": [ms for _, ms in cpu[0]]}
    m_err = 0.0
    for it in range(2):
        (got, _), (want, _) = card[0][it], cpu[0][it]
        key, weights, want_b = cpu[1][it]
        diff = np.flatnonzero(card[1][it][2][ACTIONS] != want_b[ACTIONS])
        if len(diff):
            t, keys = int(diff[0]), []
            for _ in range(t + 1):
                key, sub = rnd.split(key)
                keys.append(sub)
            margin = rl_tie(weights, want_b[OBS], keys, t)
            if margin >= RL_TIE_MARGIN:
                raise AssertionError(f"ddppo: iteration {it} action {t} "
                                     f"differs (margin {margin})")
            log(f"ddppo parity: near-tie at iteration {it} row {t}; the "
                f"runs part there, so only what came before is compared")
            out["near_tie"] = [it, t]
            break
        if got["timesteps_this_iter"] != want["timesteps_this_iter"]:
            raise AssertionError(f"ddppo: {got} vs {want}")
        for k in set(want) - {"env_steps_per_sec", "episode_return_mean"}:
            m_err = max(m_err, close(f"ddppo {k}", torch.tensor(
                float(got[k])), torch.tensor(float(want[k])),
                *RL_METRIC_TOL))
    else:
        out["param_err"] = max(close(f"ddppo {k}", v, cpu[2][k],
                                     *RL_PARAM_TOL)
                               for k, v in card[2].items())
    out["metric_err"] = m_err
    log(f"ddppo ok: DDPPOConfig(collective_backend='torch_dist', 1 member) "
        f"on the card = on the CPU over 2 iterations (metrics {m_err:.3e}, "
        f"params {out.get('param_err')}); iteration ms "
        f"{[round(x, 1) for x in out['iteration_ms']]} (CPU "
        f"{[round(x, 1) for x in out['cpu_iteration_ms']]}); card: "
        f"{gpu_line()}")
    return out


def gang_phase(tm, fa, run, spread, seed):
    """Phase 14: (a) the gang trainer, (b) two ranks on one card, (c)
    DD-PPO."""
    t0 = time.perf_counter()
    os.makedirs("chiprun_out", exist_ok=True)
    results = {"trainer": gang_trainer(tm, fa, run, spread)}
    gc_collect()
    results["halves"] = gang_halves(tm)
    gc_collect()
    results["ddppo"] = ddppo_phase(seed)
    results["phase_s"] = time.perf_counter() - t0
    log(f"gang phase ok in {results['phase_s']:.1f} s")
    log("gang metrics: " + json.dumps(results))
    return results


# ---------------------------------------------------------------------------
# Phase 15: the sharded step on a mesh of 4 ranks sharing the card.

SHARDED_WORLD = 4
SHARDED_WARMUP, SHARDED_STEPS = 1, 2     # the steps after the first timed
# name, mesh axes, config overrides of gpt2-125m (max_seq L, bf16, remat
# "full"): (a) FSDP x TP with the flash kernels on each rank's local
# [B/2, L, H/2, D]; (b) sequence x TP with ring attention; (c) phase 6's
# MoE as a GPipe pipeline of 2 stages with its experts over ep.
SHARDED_MESHES = (
    ("fsdp2_tp2", {"fsdp": 2, "tp": 2}, dict(flash_attention=True)),
    ("sp2_tp2", {"sp": 2, "tp": 2}, dict(ring_attention=True)),
    ("pp2_ep2", {"pp": 2, "ep": 2}, MOE),
)
# The first loss against the one-process reference on the same params and
# batch, and the first step's grad norm relative to the reference's: bf16
# products and all-reduces land in other orders (1.5e-4 and 1.4e-4 at
# most on the card, (a) and (b); 4.8e-7 on the loss for (c)).
SHARDED_LOSS_ATOL, SHARDED_GNORM_RTOL = 1e-3, 1e-3
PIPE_MICROBATCHES = 2                    # the pipeline's default M = pp
DRYRUN_ATOL = 1e-4


def sharded_launches(name, n_layers):
    """The flash launches a rank makes a step on mesh ``name``: remat
    "full" runs each layer's forward twice; under the pipeline each stage
    runs its n_layers / 2 layers on each of M + 1 ticks."""
    if name == "sp2_tp2":
        return {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    runs = (n_layers if name == "fsdp2_tp2" else
            n_layers // 2 * (PIPE_MICROBATCHES + 1))
    return {"flash_fwd": 2 * runs, "flash_bwd_dq": runs,
            "flash_bwd_dkv": runs}


def sharded_rank(rank, addr, out):
    """One rank of phase 15 (run in its own process): joins the gloo
    world, then for each mesh of SHARDED_MESHES builds the state from seed
    0 on every rank (phase 4's init), takes SHARDED_STEPS steps of phase
    4's batch and writes its losses, grad norms, step times, the transport
    of each step, flash launches and peak memory to ``out``."""
    import gc

    from ray_tpu_torch import models as tm
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import collective as col
    from ray_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = col.join_world(addr, SHARDED_WORLD, rank, device="cuda",
                         backend="gloo", timeout_s=300.0)
    results = {}
    for name, axes, kw in SHARDED_MESHES:
        mesh = make_mesh(axes=axes, device=dev)
        cfg = tm.GPTConfig.preset("gpt2-125m", **{**kw, "max_seq": L})
        opt = functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.1)
        state = tm.make_train_state(
            cfg, opt, generator=torch.Generator(device=dev).manual_seed(0),
            device=dev, mesh=mesh)
        step = tm.make_train_step(cfg, mesh=mesh)
        batch = train_batch(cfg.vocab_size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        r = {"losses": [], "grad_norms": [], "step_s": [], "transport": []}
        for _ in range(SHARDED_STEPS):
            col.reset_transport_stats()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            r["losses"].append(m["loss"].item())
            r["grad_norms"].append(m["grad_norm"].item())
            torch.cuda.synchronize()
            r["step_s"].append(time.perf_counter() - t0)
            r["transport"].append(col.transport_stats())
        r["launches"] = {k.symbol.removeprefix("rtt_"): k.launches
                         for k in fa.KERNELS}
        r["peak"] = torch.cuda.max_memory_allocated()
        results[name] = r
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    col.leave_world()


def spawn_sharded(out):
    from ray_tpu_torch.parallel.collective import _free_port

    repo = os.path.dirname(os.path.abspath(__file__))
    addr = f"127.0.0.1:{_free_port()}"
    src = (f"import sys; sys.path.insert(0, {repo!r}); import chip_smoke; "
           f"chip_smoke.sharded_rank(int(sys.argv[1]), {addr!r}, {out!r})")
    logs = [open(os.path.join(out, f"rank{r}.log"), "w")
            for r in range(SHARDED_WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)], cwd=repo,
                              stdout=f, stderr=subprocess.STDOUT)
             for r, f in enumerate(logs)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if rcs != [0] * SHARDED_WORLD:
        tails = [open(os.path.join(out, f"rank{r}.log")).read()[-3000:]
                 for r in range(SHARDED_WORLD)]
        raise AssertionError(f"sharded: ranks exited {rcs}: {tails}")
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(SHARDED_WORLD)]


def moe_microbatch_reference(tm):
    """The one-process reference of mesh (c): phase 6's model from seed 0
    run microbatch by microbatch (M = 2, each microbatch its own
    capacity). Returns the mean of the microbatch losses and the norm of
    its gradient."""
    from ray_tpu_torch.models.transformer import global_norm, tree_leaves

    cfg = tm.GPTConfig.preset("gpt2-125m", **MOE)
    params = tm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = train_batch(cfg.vocab_size)
    n = B // PIPE_MICROBATCHES
    loss = sum(tm.loss_fn(params, {k: v[i * n:(i + 1) * n]
                                   for k, v in batch.items()}, cfg)
               for i in range(PIPE_MICROBATCHES)) / PIPE_MICROBATCHES
    loss.backward()
    gnorm = global_norm(p.grad for p in leaves).item()
    return loss.item(), gnorm


def sharded_phase(tm, fa, run):
    """Phase 15: K1-K3 against their plain versions at mesh (a)'s local
    shape; the three meshes of SHARDED_MESHES on 4 ranks over gloo (the
    card holds one NCCL rank), their first losses and grad norms against
    phase 4's ``run`` (mesh (c)'s against the model run microbatch by
    microbatch); then ``dryrun_multichip(4)`` on the card against the
    CPU."""
    from ray_tpu_torch import graft_entry

    t0 = time.perf_counter()
    errors = check_kernels(fa, B // 2 * H // 2, L, L, D, torch.bfloat16,
                           True, tol_out=(1e-3, 1e-2),
                           tol_row=(1e-4, 1e-5), tol_grad=(2e-2, 1e-2),
                           p_round=2 ** -7)
    moe_loss, moe_gnorm = moe_microbatch_reference(tm)
    gc_collect()
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out") as out:
        ranks = spawn_sharded(out)
    results = {"kernel_errors": errors,
               "moe_microbatch": {"loss": moe_loss, "grad_norm": moe_gnorm}}
    n_layers = tm.GPTConfig.preset("gpt2-125m").n_layers
    for name, axes, kw in SHARDED_MESHES:
        per = [r[name] for r in ranks]
        losses, gnorm = per[0]["losses"], per[0]["grad_norms"][0]
        if any(p["losses"] != losses for p in per):
            raise AssertionError(f"sharded {name}: ranks' losses differ "
                                 f"{[p['losses'] for p in per]}")
        want, want_gnorm = ((moe_loss, moe_gnorm) if name == "pp2_ep2"
                            else (run.losses[0], run.grad_norm))
        loss_err = abs(losses[0] - want)
        gnorm_err = abs(gnorm - want_gnorm) / want_gnorm
        if not loss_err <= SHARDED_LOSS_ATOL:
            raise AssertionError(f"sharded {name}: first loss {losses[0]} "
                                 f"vs one process {want}")
        if not gnorm_err <= SHARDED_GNORM_RTOL:
            raise AssertionError(f"sharded {name}: grad norm {gnorm} vs one"
                                 f" process {want_gnorm}")
        launches = [p["launches"] for p in per]
        a_step = sharded_launches(name, n_layers)
        for r, got in enumerate(launches):
            if any(got[k] != v * SHARDED_STEPS for k, v in a_step.items()):
                raise AssertionError(
                    f"sharded {name} rank {r}: launches {got} in "
                    f"{SHARDED_STEPS} steps, want {a_step} a step")
        # A rank's timed steps; the step's time is the slowest rank's.
        timed = [[t * 1e3 for t in p["step_s"][SHARDED_WARMUP:]]
                 for p in per]
        step_ms = statistics.median(max(ts) for ts in zip(*timed))
        moved = [p["transport"][-1] for p in per]
        results[name] = {
            "axes": axes, "losses": losses, "grad_norm": gnorm,
            "reference_loss": want, "reference_grad_norm": want_gnorm,
            "loss_err": loss_err, "grad_norm_rel_err": gnorm_err,
            "step_ms": step_ms, "step_ms_ranks": timed,
            "launches": launches,
            "transport_bytes": [t["bytes"] for t in moved],
            "transport_ms": [t["seconds"] * 1e3 for t in moved],
            "transport_calls": [t["calls"] for t in moved],
            "peak_gb": [p["peak"] / 1e9 for p in per]}
        log(f"sharded {name} ok: {axes}, losses {losses} (one process "
            f"{want:.6f}, |diff| {loss_err:.3e}, atol {SHARDED_LOSS_ATOL}),"
            f" grad norm {gnorm:.6f} (one process {want_gnorm:.6f}, rel "
            f"{gnorm_err:.3e}, rtol {SHARDED_GNORM_RTOL}); step "
            f"{step_ms:.1f} ms (median of {len(timed[0])}, the slowest "
            f"rank's; ranks {[[round(t, 1) for t in ts] for ts in timed]});"
            f" gloo a rank a step: "
            f"{[round(t['bytes'] / 1e6, 1) for t in moved]} MB in "
            f"{[round(t['seconds'] * 1e3, 1) for t in moved]} ms "
            f"({moved[0]['calls']} calls); flash launches rank 0 "
            f"{launches[0]} in {SHARDED_STEPS} steps; peak "
            f"{[round(p['peak'] / 1e9, 2) for p in per]} GB")
    dry = graft_entry.dryrun_multichip(SHARDED_WORLD, device="cuda",
                                       backend="gloo")
    dry_cpu = graft_entry.dryrun_multichip(SHARDED_WORLD, device="cpu")
    for k in dry_cpu:
        if not (math.isfinite(dry[k])
                and abs(dry[k] - dry_cpu[k]) <= DRYRUN_ATOL):
            raise AssertionError(f"dryrun {k}: cuda {dry[k]} vs cpu "
                                 f"{dry_cpu[k]}")
    results["dryrun"] = {"card": dry, "cpu": dry_cpu}
    results["phase_s"] = time.perf_counter() - t0
    log(f"sharded dryrun ok: dryrun_multichip({SHARDED_WORLD}) on cuda "
        f"{dry} vs cpu {dry_cpu} (atol {DRYRUN_ATOL})")
    log(f"sharded phase ok in {results['phase_s']:.1f} s; card: "
        f"{gpu_line()}")
    log("sharded metrics: " + json.dumps(results))
    return results


# ---------------------------------------------------------------------------
# Phase 16: the port's own runtime (``ray_tpu_torch.init``) on the card: a
# GPU worker process with its CUDA_VISIBLE_DEVICES from the node manager,
# the main path's trainer rank in one, a CUDA tensor across processes, and
# a card learner with CPU rollout processes.

RUNTIME_CPUS = 4


def _process_age_s():
    """Seconds since this process started: its start time in clock ticks
    after boot (field 22 of /proc/self/stat) against the boot clock."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - \
        start_ticks / os.sysconf("SC_CLK_TCK")


def runtime_gpu_probe(t_submit, tol):
    """16a, in a ``num_gpus=1`` worker: its GPU, parent and cold start
    (the process's age when the task began, from /proc; torch's import in
    a fresh interpreter of this worker's environment; the first CUDA
    call), then K1-K3 at the training shape against their plain versions,
    from the kernel library in ``ray_tpu_torch/_build``."""
    t_enter = time.time()
    age_s = _process_age_s()
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    t_cuda = time.time()
    import_s = float(subprocess.run(
        [sys.executable, "-c", "import time; t = time.perf_counter(); "
         "import torch; print(time.perf_counter() - t)"],
        check=True, capture_output=True, text=True).stdout)
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    errors = check_kernels(fa, B * H, L, L, D, torch.bfloat16, True, **tol)
    return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count(),
            "pid": os.getpid(), "ppid": os.getppid(),
            "mark": os.environ.get("MARK"),
            "spawn_ms": (t_enter - t_submit) * 1e3,
            "process_age_ms": age_s * 1e3,
            "torch_import_ms": import_s * 1e3,
            "first_cuda_ms": (t_cuda - t_enter) * 1e3,
            "errors": errors,
            "launches": {k.symbol.removeprefix("rtt_"): k.launches
                         for k in fa.KERNELS},
            "library": _kernels._libs["flash_attention"]._name,
            "build_dir": str(_kernels.BUILD_DIR)}


def runtime_gang_loop(config):
    """16b: ``gang_loop`` in the rank's own process, each report carrying
    the rank's flash launches since the loop began (counted there) and the
    GPU the node manager gave the rank."""
    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.ops import flash_attention as fa

    report = rt_train.report

    def counted(metrics, checkpoint=None):
        return report(dict(
            metrics, launches={k.symbol.removeprefix("rtt_"): k.launches
                               for k in fa.KERNELS},
            cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
            gpu_ids=os.environ.get("RAY_TPU_TORCH_GPU_IDS"),
            device_count=torch.cuda.device_count()), checkpoint=checkpoint)

    fa.reset_launches()
    rt_train.report = counted
    try:
        gang_loop(config)
    finally:
        rt_train.report = report


def runtime_fit(rt, fa, storage, resume=None):
    """One ``TorchDistTrainer.fit()`` of ``runtime_gang_loop`` on the port's
    runtime: one rank in a ``num_gpus=1`` worker, NCCL. The driver's own
    flash counts stay 0: the kernels run in the rank."""
    from ray_tpu_torch import train as rt_train

    trainer = rt_train.TorchDistTrainer(
        runtime_gang_loop,
        train_loop_config={"steps": WARMUP_STEPS + TIMED_STEPS},
        scaling_config=rt_train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=rt_train.RunConfig(name="runtime-gang",
                                      storage_path=storage),
        backend="torch_dist", resume_from_checkpoint=resume, runtime=rt)
    fa.reset_launches()
    result = trainer.fit()
    if not result.ok:
        raise AssertionError(f"runtime-train: fit failed: {result.error}")
    here = {k.symbol: k.launches for k in fa.KERNELS}
    if any(here.values()):
        raise AssertionError(f"runtime-train: the driver launched {here}")
    return result


def runtime_train(rt, tm, fa, run, nm, spread):
    """16b: the main path through the port's runtime, at phase 14a's cell
    and gates."""
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    tol = max(GANG_LOSS_ATOL, spread)
    steps = WARMUP_STEPS + TIMED_STEPS
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    with tempfile.TemporaryDirectory(
            dir=os.path.abspath("chiprun_out")) as storage:
        t0 = time.perf_counter()
        result = runtime_fit(rt, fa, storage)
        fit_s = time.perf_counter() - t0
        hist = result.metrics_history
        losses = [m["loss"] for m in hist]
        last = hist[-1]
        ids = last["gpu_ids"]
        if not ids or last["cuda_visible_devices"] != ",".join(
                nm._gpu_tokens[int(i)] for i in ids.split(",")) or \
                last["device_count"] != 1:
            raise AssertionError(f"runtime-train: the rank saw "
                                 f"{last['cuda_visible_devices']} for GPU "
                                 f"ids {ids}, {last['device_count']} devices")
        for name, per_step in want.items():
            if last["launches"][name] != per_step * steps:
                raise AssertionError(f"runtime-train: {name} launched "
                                     f"{last['launches'][name]} times in "
                                     f"{steps} steps in the rank")
        err = max(abs(a - b) for a, b in zip(losses, run.losses))
        if len(losses) != steps or err > tol:
            raise AssertionError(f"runtime-train: losses {losses} vs phase "
                                 f"4's {run.losses} (tol {tol})")
        if result.checkpoint.to_dict()["step"] != GANG_CKPT_STEP:
            raise AssertionError("runtime-train: no checkpoint at step 3")
        resumed = runtime_fit(rt, fa, storage, result.checkpoint)
        rest = steps - GANG_CKPT_STEP - 1
        rlast = resumed.metrics_history[-1]
        for name, per_step in want.items():
            if rlast["launches"][name] != per_step * rest:
                raise AssertionError(f"runtime-train: resumed {name} "
                                     f"launched {rlast['launches'][name]}")
        tail = [m["loss"] for m in resumed.metrics_history]
        resume_err = max(abs(a - b) for a, b in
                         zip(tail, losses[GANG_CKPT_STEP + 1:]))
        if [m["step"] for m in resumed.metrics_history] != list(
                range(GANG_CKPT_STEP + 1, steps)) or resume_err > tol:
            raise AssertionError(f"runtime-train: resumed losses {tail} vs "
                                 f"{losses[GANG_CKPT_STEP + 1:]}")
    step_ms = statistics.median(m["s"] for m in hist[WARMUP_STEPS:]) * 1e3
    out = {"losses": losses, "loss_err": err, "tol": tol,
           "resume_err": resume_err, "launches": last["launches"],
           "resumed_launches": rlast["launches"],
           "cuda_visible_devices": last["cuda_visible_devices"],
           "step_ms": step_ms, "phase4_step_ms": run.step_ms,
           "fit_s": fit_s, "peak_gb": max(m["peak"] for m in hist) / 1e9}
    log(f"runtime-train ok: TorchDistTrainer on runtime=ray_tpu_torch, 1 "
        f"rank in a num_gpus=1 worker (CUDA_VISIBLE_DEVICES="
        f"{out['cuda_visible_devices']} from the node manager), NCCL, "
        f"gpt2-125m batch {B} seq {L}: losses = phase 4's within {err:.3e} "
        f"(tol {tol:.1e}); launches in the rank {last['launches']} in "
        f"{steps} steps; resumed at step {GANG_CKPT_STEP + 1} within "
        f"{resume_err:.3e}, launches {rlast['launches']}")
    log(f"runtime-train step_ms {step_ms:.2f} (median of {TIMED_STEPS}; all "
        f"{[round(m['s'] * 1e3, 2) for m in hist]}), phase 4 "
        f"{run.step_ms:.2f} ms; the rank's peak memory {out['peak_gb']:.2f} "
        f"GB; first fit {fit_s:.1f} s; card: {gpu_line()}")
    return out


class FrameHolder:
    """16c: a ``num_gpus=1`` actor that puts phase 13a's bf16 KV frame from
    its card and gets it back in its own process."""

    def put_frame(self):
        import ray_tpu_torch as rt
        from ray_tpu_torch._private import device_objects as tdo

        gen = torch.Generator(device="cuda").manual_seed(13)
        self.k = torch.randn(KV_FRAME_SHAPE, generator=gen,
                             device="cuda").to(torch.bfloat16)
        torch.cuda.synchronize()
        tdo.reset_stats()
        t0 = time.perf_counter()
        ref = rt.put(self.k)
        put_ms = (time.perf_counter() - t0) * 1e3
        return [ref], put_ms, tdo.stats(), self.k.nbytes

    def get_again(self, refs):
        import ray_tpu_torch as rt
        from ray_tpu_torch._private import device_objects as tdo

        tdo.reset_stats()
        back = rt.get(refs[0])
        return back is self.k, tdo.stats()

    def drop_frame(self):
        del self.k
        torch.cuda.empty_cache()


def runtime_frame(rt, in_process, holder):
    """16c: the 268 MB bf16 frame put on the card by one process (the
    ``num_gpus=1`` actor ``holder``), got on the card by another, bit for
    bit, and charged to the arena."""
    from ray_tpu_torch._private import device_objects as tdo
    from ray_tpu_torch._private import worker as tworker

    arena = tworker.global_worker().store
    before = arena.stats_ex()["device_staged_bytes"]
    refs, put_ms, put_stats, nbytes = rt.get(holder.put_frame.remote())
    staged = arena.stats_ex()["device_staged_bytes"] - before
    gen = torch.Generator(device="cuda").manual_seed(13)
    want = torch.randn(KV_FRAME_SHAPE, generator=gen,
                       device="cuda").to(torch.bfloat16)
    tdo.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = rt.get(refs[0])
    torch.cuda.synchronize()
    get_ms = (time.perf_counter() - t0) * 1e3
    got_stats = tdo.stats()
    if not (back.is_cuda and back.dtype == torch.bfloat16
            and torch.equal(back.view(torch.uint8), want.view(torch.uint8))):
        raise AssertionError("runtime-frame: the frame differs across "
                             "processes")
    if staged != nbytes or put_stats["puts"] != 1 or \
            got_stats["rebuilds"] != 1:
        raise AssertionError(f"runtime-frame: staged {staged} B of {nbytes};"
                             f" put {put_stats}, get {got_stats}")
    hit, again = rt.get(holder.get_again.remote(refs))
    if not hit or again["local_hits"] != 1 or again["rebuilds"] != 0:
        raise AssertionError(f"runtime-frame: second get in the actor's "
                             f"process {again}, same tensor {hit}")
    rt.get(holder.drop_frame.remote())
    gb = nbytes / 1e9
    out = {"bytes": nbytes, "put_ms": put_ms, "put_gb_per_s": gb / put_ms
           * 1e3, "get_ms": get_ms, "get_gb_per_s": gb / get_ms * 1e3,
           "device_staged_bytes": staged,
           "in_process": in_process["bfloat16"]}
    log(f"runtime-frame ok: {list(KV_FRAME_SHAPE)} bf16 ({nbytes} B) put on "
        f"the card by a num_gpus=1 actor, got on the card here bit for bit;"
        f" arena device_staged_bytes +{staged}; the actor's second get a "
        f"local hit, no copy. Put (staging) {put_ms:.1f} ms "
        f"({out['put_gb_per_s']:.2f} GB/s), get (rebuild) {get_ms:.1f} ms "
        f"({out['get_gb_per_s']:.2f} GB/s); in process (13a) put "
        f"{in_process['bfloat16']['put_gb_per_s']:.2f} GB/s, rebuild "
        f"{in_process['bfloat16']['cuda_gb_per_s']:.2f} GB/s; card: "
        f"{gpu_line()}")
    return out


class PPOHost:
    """16d: PPO with its learner on the card, in a ``num_gpus=1`` actor;
    its two rollout workers are CPU processes of the same runtime."""

    def start_ppo(self, seed):
        import ray_tpu_torch as rt
        from ray_tpu_torch import rllib as rl

        self.algo = rl.PPOConfig(seed=seed).environment(
            NumpyCartPole).build(runtime=rt, device="cuda",
                                 worker_device="cpu")
        self.calls = time_updates(self.algo, "update_from_batch")

    def weights(self):
        return {k: v.cpu() for k, v in self.algo.get_weights().items()}

    def train(self):
        self.calls.clear()
        t0 = time.perf_counter()
        m = self.algo.train()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return (m, ms, sum(t for t, _ in self.calls) * 1e3,
                dict(self.calls[0][1][0]), self.weights())

    def stop(self):
        self.algo.stop()


class GpuHost(FrameHolder, PPOHost):
    """16c, then 16d, in one ``num_gpus=1`` actor: one GPU worker where two
    actors would each pay a cold start."""


def runtime_rl(rt, seed, phase12, host):
    """16d: PPO's card learner (in the ``num_gpus=1`` actor ``host``) with
    CPU rollout processes against the same iteration on the in-process
    runtime on the CPU."""
    from ray_tpu_torch import rllib as rl

    def make_cfg():
        return rl.PPOConfig(seed=seed).environment(NumpyCartPole)

    rt.get(host.start_ppo.remote(seed))
    weights = rt.get(host.weights.remote())
    rows = [rt.get(host.train.remote()) for _ in range(2)]
    rt.get(host.stop.remote())
    rt.kill(host)
    cpu = make_cfg().build(device="cpu")
    calls = time_updates(cpu, "update_from_batch")
    want = cpu.train()
    wbatch, ww = dict(calls[0][1][0]), cpu.get_weights()
    cpu.stop()
    got, _, _, gbatch, gw = rows[0]
    split = rl_first_action_split(make_cfg(), weights, gbatch, wbatch)
    if split is not None:
        log(f"runtime-rl: near-tie at batch row {split}; the iterations "
            f"part there, so only rows before it are compared")
        m_err = p_err = None
    else:
        if (got["timesteps_this_iter"], got["episode_return_mean"]) != \
                (want["timesteps_this_iter"], want["episode_return_mean"]):
            raise AssertionError(f"runtime-rl: {got} vs {want}")
        if set(got) != set(want):
            raise AssertionError(f"runtime-rl: metrics {sorted(got)}")
        keys = set(want) - {"env_steps_per_sec", "episode_return_mean"}
        m_err = max(close(f"runtime-rl {k}", torch.tensor(float(got[k])),
                          torch.tensor(float(want[k])), *RL_METRIC_TOL)
                    for k in keys)
        p_err = max(close(f"runtime-rl {k}", v, ww[k], *RL_PARAM_TOL)
                    for k, v in gw.items())
    its = [{"ms": ms, "env_steps": m["timesteps_this_iter"],
            "env_steps_per_sec": m["env_steps_per_sec"],
            "learner_ms": lms, "learner_share": lms / ms}
           for m, ms, lms, _, _ in rows]
    out = {"iterations": its, "metric_err": m_err, "param_err": p_err,
           "near_tie_row": split, "phase12_ppo": phase12}
    ref = "not run in this call" if phase12 is None else json.dumps(
        phase12["iterations"])
    log(f"runtime-rl ok: PPO on runtime=ray_tpu_torch, learner on cuda in a"
        f" num_gpus=1 actor, 2 rollout workers in CPU processes; one "
        f"iteration = the in-process runtime's on the CPU (metrics max "
        f"|diff| {m_err}, params {p_err}); iterations "
        f"{[{k: round(v, 3) for k, v in r.items()} for r in its]}; phase "
        f"12's PPO (in process, on the card): {ref}; card: {gpu_line()}")
    return out


def runtime_phase(tm, fa, run, spread, tol, seed, phase12=None,
                  in_process=None):
    """Phase 16: the port's own runtime on the card."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker as tworker

    t0 = time.perf_counter()
    if in_process is None:
        in_process = kv_frame()
        gc_collect()
    rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    try:
        res = rt.cluster_resources()
        if res.get("GPU") != 1:
            raise AssertionError(f"runtime: the node counts GPUs {res}")
        nm = tworker._global_cluster.nm
        zygotes = {z["proc"].pid for z in nm._zygotes}
        probe = rt.remote(runtime_gpu_probe).options(num_gpus=1)
        t_submit = time.time()
        p = rt.get(probe.remote(t_submit, tol), timeout=300)
        cold_ms = (time.time() - t_submit) * 1e3
        want = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
        if p["cuda_visible_devices"] != nm._gpu_tokens[0] or \
                p["device_count"] != 1 or p["ppid"] != os.getpid() or \
                p["ppid"] in zygotes or p["launches"] != want or \
                not p["library"].startswith(p["build_dir"] + os.sep):
            raise AssertionError(f"runtime: GPU worker {p}")
        log(f"runtime start-up ok: GPU {res['GPU']:.0f} detected; a num_gpus"
            f"=1 task in pid {p['pid']} (parent {p['ppid']}, this process, "
            f"no zygote) with CUDA_VISIBLE_DEVICES="
            f"{p['cuda_visible_devices']}, {p['device_count']} device; K1-K3 "
            f"at [{B}, {L}, {H}, {D}] bf16 causal against their plain "
            f"versions in that worker: max |diff| {p['errors']}, launches "
            f"{p['launches']}, library {p['library']}; cold start "
            f"{p['spawn_ms']:.0f} ms from submit to the task's first line "
            f"(the process {p['process_age_ms']:.0f} ms old then: "
            f"interpreter, imports, registration, dispatch; torch's import "
            f"alone {p['torch_import_ms']:.0f} ms in a fresh interpreter "
            f"there), then {p['first_cuda_ms']:.0f} ms for the first CUDA "
            f"call; first result back after {cold_ms:.0f} ms; card: "
            f"{gpu_line()}")
        out = {"gpu_worker": {k: p[k] for k in (
            "spawn_ms", "process_age_ms", "torch_import_ms",
            "first_cuda_ms", "errors", "launches")}}
        out["train"] = runtime_train(rt, tm, fa, run, nm, spread)
        gc_collect()
        host = rt.remote(GpuHost).options(num_gpus=1).remote()
        out["frame"] = runtime_frame(rt, in_process, host)
        gc_collect()
        out["rl"] = runtime_rl(rt, seed, phase12, host)
    finally:
        rt.shutdown()
    out["phase_s"] = time.perf_counter() - t0
    log(f"runtime phase ok in {out['phase_s']:.1f} s")
    log("runtime metrics: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 17: the serve control plane (``ray_tpu_torch/serve``: the controller,
# replica actors, handles, the asyncio HTTP/SSE ingress with admission) on
# the port's own runtime, the LLM engine in a ``num_gpus=1`` replica actor.

PLANE_START_TIMEOUT_S = 900.0   # a replica's build at llama-7b width


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_completion(port, body, timeout=600):
    """One ``POST /v1/completions`` to the ingress. Unary: (status, parsed
    body, seconds). ``stream: true``: (status, token chunks in order,
    seconds to the first ``data:`` frame); the stream must end in
    ``data: [DONE]``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/completions",
                     body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if not body.get("stream") or resp.status != 200:
            raw = resp.read()
            return resp.status, json.loads(raw), time.perf_counter() - t0
        chunks, first, buf, done = [], None, b"", False
        while not done:
            data = resp.read1(65536)
            if not data:
                break
            buf += data
            while b"\n\n" in buf and not done:
                frame, buf = buf.split(b"\n\n", 1)
                if not frame.startswith(b"data: "):
                    continue
                payload = frame[len(b"data: "):]
                if payload == b"[DONE]":
                    done = True
                    break
                msg = json.loads(payload)
                if "error" in msg:
                    raise AssertionError(f"serve-plane: stream error {msg}")
                if first is None:
                    first = time.perf_counter() - t0
                chunks.append(msg["choices"][0]["tokens"])
        if not done:
            raise AssertionError("serve-plane: an SSE stream ended without "
                                 "data: [DONE]")
        return resp.status, chunks, first
    finally:
        conn.close()


def http_clients(port, bodies):
    """Every body from its own client thread, all at once. Returns (each
    request's ``http_completion``, wall seconds)."""
    import threading

    out, errors = [None] * len(bodies), []
    start = threading.Barrier(len(bodies) + 1)

    def client(i):
        try:
            start.wait(timeout=60)
            out[i] = http_completion(port, bodies[i])
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    start.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(o is None for o in out):
        raise AssertionError(f"serve-plane: HTTP client failed: {errors!r}")
    bad = [o[:2] for o in out if o[0] != 200]
    if bad:
        raise AssertionError(f"serve-plane: HTTP answers {bad}")
    return out, wall


def plane_replica(rt, name, not_id=None, timeout_s=PLANE_START_TIMEOUT_S):
    """The one replica of deployment ``name`` (another than ``not_id``) once
    it answers a stats probe: (actor handle, its stats, seconds waited)."""
    from ray_tpu_torch.serve.api import _controller

    ctrl = _controller()
    t0 = time.perf_counter()
    while True:
        reps = rt.get(ctrl.get_replicas.remote(name), timeout=60)
        if reps and reps[0]._actor_id.hex() != not_id:
            try:
                stats = rt.get(reps[0].stats.remote(), timeout=5)
                return reps[0], stats, time.perf_counter() - t0
            except Exception:  # noqa: BLE001 — building, or just replaced
                pass
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"serve-plane: no replica of {name} answered "
                                 f"within {timeout_s:.0f} s")
        time.sleep(0.1)


def plane_deploy(rt, serve, ec, name="llm"):
    """``build_llm_app`` in combined mode, its engine in a ``num_gpus=1``
    replica actor. Returns (root handle, seconds ``serve.run`` took,
    seconds from ``serve.run`` to the engine replica's first answer, that
    replica's handle and stats)."""
    from ray_tpu_torch.serve.llm import build_llm_app

    t0 = time.perf_counter()
    handle = serve.run(build_llm_app(ec, runtime=rt, device=CARD,
                                     mode="combined", name=name,
                                     ray_actor_options={"num_gpus": 1}))
    run_s = time.perf_counter() - t0
    replica, stats, _ = plane_replica(rt, f"{name}-engine")
    return handle, run_s, time.perf_counter() - t0, replica, stats


def plane_tokens(unary=None, streamed=None, chunks=None):
    if unary is not None:
        return [body["choices"][0]["tokens"] for _, body, _ in unary]
    if streamed is not None:
        return [[t for c in ch for t in c] for _, ch, _ in streamed]
    return [[t for c in cs for t in c] for cs in chunks]


def plane_replace(rt, port, bodies, want):
    """17(c): kill the engine's GPU replica; the controller learns of it from
    the GCS's ``actor_state`` push and starts a replacement, which waits for
    the freed GPU, builds, and serves 17(a)'s greedy tokens."""
    from ray_tpu_torch.serve.api import _controller

    ctrl = _controller()
    (victim,) = rt.get(ctrl.get_replicas.remote("llm-engine"), timeout=60)
    before = rt.get(ctrl.fault_stats.remote(), timeout=60)
    old_pid = rt.get(victim.stats.remote(), timeout=60)["pid"]
    t0 = time.perf_counter()
    rt.kill(victim)
    _, stats, _ = plane_replica(rt, "llm-engine",
                                not_id=victim._actor_id.hex())
    replace_s = time.perf_counter() - t0
    res, _ = http_clients(port, bodies)
    got = plane_tokens(unary=res)
    faults = rt.get(ctrl.fault_stats.remote(), timeout=60)
    restarts = faults["replica_restarts_total"] - \
        before["replica_restarts_total"]
    if got != want or restarts != 1 or stats["pid"] == old_pid:
        raise AssertionError(f"serve-plane replace: tokens {got} vs {want}, "
                             f"restarts {restarts}, pid {stats['pid']}")
    ttr = faults["time_to_replace_s"][-1] if faults["time_to_replace_s"] \
        else None
    log(f"serve-plane replace ok: killed the GPU replica (pid {old_pid}); "
        f"the controller saw its death through the actor_state push and "
        f"started a replacement (pid {stats['pid']}) that waited for the "
        f"freed GPU, built the model and answered in {replace_s:.2f} s from "
        f"the kill (the controller's own clock, death to first probe: "
        f"{ttr if ttr is None else round(ttr, 2)} s); the next requests over "
        f"HTTP = the greedy rollout")
    return {"replace_s": replace_s, "controller_time_to_replace_s": ttr,
            "restarts": restarts}


def plane_check(tm, gen, rt, serve, port):
    """17(a): 13(b)'s sizes (llama-7b widths, two layers, f32) in a GPU
    replica actor: every request over HTTP (unary and SSE) and through the
    handle gives the argmax rollout of ``models.forward`` (greedy) and a
    solo engine's streams (temperature 0.8, top_k 50). Then 17(c)."""
    base, prompts, n, seeds, rollout, solo = app_check_refs(tm, gen)
    gc_collect()
    out = {}
    for label, extra, want, sd in (
            ("greedy", {}, rollout, [0] * len(prompts)),
            ("sampled", APP_CHECK_SAMPLING, solo, seeds)):
        handle, run_s, cold_s, replica, _ = plane_deploy(
            rt, serve, dict(base, **extra))
        bodies = [{"model": "llm", "prompt": p, "max_tokens": n, "seed": s}
                  for p, s in zip(prompts, sd)]
        unary, _ = http_clients(port, bodies)
        streamed, _ = http_clients(port, [dict(b, stream=True)
                                          for b in bodies])
        chunks, _ = app_streams(handle, prompts, n, sd)
        got = {"http": plane_tokens(unary=unary),
               "sse": plane_tokens(streamed=streamed),
               "handle": plane_tokens(chunks=chunks)}
        wrong = {k: v for k, v in got.items() if v != want}
        left = engine_stats(rt, "llm-engine")["kv_blocks_used"]
        if wrong or left:
            raise AssertionError(f"serve-plane {label}: {wrong} != {want}, "
                                 f"{left} KV blocks left")
        out[label] = {"run_s": run_s, "cold_start_s": cold_s}
        log(f"serve-plane check {label} ok: llama-7b widths, 2 layers, f32, "
            f"engine in a num_gpus=1 replica actor (cold start {cold_s:.2f} "
            f"s, serve.run {run_s:.2f} s); {len(prompts)} requests over HTTP "
            f"unary, over HTTP SSE and through the handle's generate_stream, "
            f"{len(prompts)} client threads each: all = "
            + ("the argmax rollout of models.forward" if label == "greedy"
               else "a solo engine (temperature 0.8, top_k 50)")
            + "; every KV block returned")
        if label == "greedy":
            out["replace"] = plane_replace(rt, port, bodies, rollout)
        serve.delete("llm")
        serve.delete("llm-engine")
        del handle, replica
    return out


def plane_full(tm, gen, rt, serve, port, seed, in_process):
    """17(b): llama-7b at full width, ``SERVE_LAYERS`` deep, bf16, 13(c)'s
    engine config, in a GPU replica actor: 16 prompts from 16 client
    threads over HTTP SSE, then through the handle's ``generate_stream``."""
    from ray_tpu_torch.serve.api import _controller
    from ray_tpu_torch.serve.llm import EngineConfig
    from ray_tpu_torch.serve.llm import replicas as rp

    gc_collect()
    ec = dict(preset="llama-7b", model_overrides=SERVE_DEPTH, param_seed=seed,
              max_slots=8, max_len=2048, paged_kv=True, kv_block_size=16,
              prefill_chunk=512, prompt_buckets=APP_BUCKETS,
              max_new_tokens=SERVE_NEW,
              prefill_batch_size=4, prefill_batch_window_ms=5.0)
    cfg = EngineConfig.from_dict(ec).gpt_config()
    prompts = serve_prompts(seed, cfg.vocab_size)
    handle, run_s, cold_s, replica, _ = plane_deploy(rt, serve, ec)
    # One short request first, so that neither timed path pays the
    # replica's first products (cuBLAS's plans, the allocator's pool).
    handle.remote({"prompt": prompts[0][:128], "n": 2}).result(timeout=600)
    bodies = [{"model": "llm", "prompt": p, "max_tokens": SERVE_NEW,
               "seed": 0, "stream": True} for p in prompts]
    streamed, http_wall = http_clients(port, bodies)
    http_tokens = plane_tokens(streamed=streamed)
    t0 = time.perf_counter()
    chunks, handle_ttft = app_streams(handle, prompts, SERVE_NEW,
                                      [0] * len(prompts))
    handle_wall = time.perf_counter() - t0
    handle_tokens = plane_tokens(chunks=chunks)
    stats = rt.get(replica.stats.remote(), timeout=60)
    ingress = rt.get(_controller().ingress_stats.remote(), timeout=60)
    admitted = sum(s["admitted_total"] for s in ingress.values())
    shed = sum(s["shed_total"] for s in ingress.values())
    short = [i for i, t in enumerate(http_tokens + handle_tokens)
             if len(t) != SERVE_NEW]
    if short or stats["kv_blocks_used"] or not all(
            0 <= x < cfg.vocab_size for t in http_tokens + handle_tokens
            for x in t) or shed or admitted < len(prompts):
        raise AssertionError(f"serve-plane full: requests {short} short of "
                             f"{SERVE_NEW}, replica stats {stats}, ingress "
                             f"{ingress}")
    serve.delete("llm")
    serve.delete("llm-engine")
    del handle, replica
    gc_collect()
    # The replica's weights again, here: its first-token logits (chunked
    # prefill) against models.forward, and each served first token against
    # forward's argmax wherever that is clear of the runner-up by 2 atol.
    cfg, master = rp._build_model(EngineConfig.from_dict(ec), device=CARD)
    params = gen.serving_params(master, cfg, CARD)
    del master
    gc_collect()
    max_err, firsts = check_first_logits(tm, gen, params, cfg, prompts,
                                         SERVE_LOGIT_ATOL)
    del params
    gc_collect()
    clear = [i for i, (_, margin) in enumerate(firsts)
             if margin > 2 * SERVE_LOGIT_ATOL]
    off = [i for i in clear if http_tokens[i][0] != firsts[i][0]
           or handle_tokens[i][0] != firsts[i][0]]
    if off:
        raise AssertionError(f"serve-plane full: first tokens of {off} are "
                             f"not models.forward's argmax {firsts}")
    http_ttft = [first for _, _, first in streamed]
    out = {
        "run_s": run_s, "cold_start_s": cold_s,
        "http_ttft_p50_ms": percentile(http_ttft, 50) * 1e3,
        "http_ttft_p99_ms": percentile(http_ttft, 99) * 1e3,
        "handle_ttft_p50_ms": percentile(handle_ttft, 50) * 1e3,
        "handle_ttft_p99_ms": percentile(handle_ttft, 99) * 1e3,
        "http_output_tokens_per_s": sum(map(len, http_tokens)) / http_wall,
        "handle_output_tokens_per_s":
            sum(map(len, handle_tokens)) / handle_wall,
        "http_wall_s": http_wall, "handle_wall_s": handle_wall,
        "replica_peak_gb": stats.get("device_memory_peak_bytes", 0) / 1e9,
        "ingress_admitted": admitted, "ingress_shed": shed,
        "http_handle_same_tokens": sum(a == b for a, b in
                                       zip(http_tokens, handle_tokens)),
        "first_logits_max_abs_err": max_err,
        "first_tokens_checked": len(clear),
    }
    if in_process:
        out["in_process"] = {k: in_process[k] for k in (
            "ttft_p50_ms", "ttft_p99_ms", "output_tokens_per_s")}
        beside = (f"; phase 13(c) in process in this call: TTFT p50 "
                  f"{in_process['ttft_p50_ms']:.1f} ms p99 "
                  f"{in_process['ttft_p99_ms']:.1f} ms, "
                  f"{in_process['output_tokens_per_s']:.1f} tokens/s "
                  f"(disaggregated)")
    else:
        beside = "; phase 13 not run in this call"
    log(f"serve-plane full ok: llama-7b, bf16, combined app with its engine "
        f"in a num_gpus=1 replica actor (13(c)'s engine config); replica "
        f"cold start {cold_s:.2f} s (serve.run {run_s:.2f} s); "
        f"{len(prompts)} prompts x {SERVE_NEW} from {len(prompts)} client "
        f"threads: over HTTP SSE TTFT p50 {out['http_ttft_p50_ms']:.1f} ms "
        f"p99 {out['http_ttft_p99_ms']:.1f} ms, "
        f"{out['http_output_tokens_per_s']:.1f} output tokens/s; through the "
        f"handle TTFT p50 {out['handle_ttft_p50_ms']:.1f} ms p99 "
        f"{out['handle_ttft_p99_ms']:.1f} ms, "
        f"{out['handle_output_tokens_per_s']:.1f} tokens/s; the same tokens "
        f"on both paths for {out['http_handle_same_tokens']}/{len(prompts)} "
        f"requests; every budget met, every token in the vocabulary, every "
        f"KV block returned; first-token logits vs models.forward max |diff| "
        f"{max_err:.4f} (atol {SERVE_LOGIT_ATOL}), the first token = "
        f"forward's argmax on all {len(clear)} clear prompts; replica peak "
        f"memory {out['replica_peak_gb']:.2f} GB (read in the actor); "
        f"ingress admitted {admitted}, shed {shed}{beside}")
    return out


def serve_plane_phase(tm, gen, seed, in_process=None):
    """Phase 17: the serve control plane on the port's own runtime."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    gc_collect()
    rt.init(num_cpus=RUNTIME_CPUS, num_gpus=1, log_to_driver=False)
    try:
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.api import _controller

        if rt.cluster_resources().get("GPU") != 1:
            raise AssertionError(f"serve-plane: {rt.cluster_resources()}")
        serve.start(http_port=free_port())
        ports = {}
        deadline = time.perf_counter() + 60
        while not ports and time.perf_counter() < deadline:
            ports = rt.get(_controller().proxy_addresses.remote(), timeout=60)
            time.sleep(0.1)
        if not ports:
            raise AssertionError("serve-plane: the ingress never came up")
        port = next(iter(ports.values()))
        out = {"check": plane_check(tm, gen, rt, serve, port)}
        gc_collect()
        out["full"] = plane_full(tm, gen, rt, serve, port, seed, in_process)
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    out["phase_s"] = time.perf_counter() - t0
    log(f"serve-plane phase ok in {out['phase_s']:.1f} s")
    log("serve-plane metrics: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 18: the autoscaler, ray_tpu_torch.data and ray_tpu_torch.tune: a
# two-trial sweep of the main path's step on an autoscaled GPU node.

TUNE_LRS = (3e-4, 1e-3)
TUNE_STEPS = 5                 # 2 warm-up, 3 timed
TUNE_IDLE_S = 5.0              # the node type's idle timeout
TUNE_DOWN_SLACK_S = 15.0       # the scale-down gate: idle timeout + this
TUNE_UP_TIMEOUT_S = 300.0


def tune_gpu_probe(t_submit, tol):
    """18a, on the autoscaled node: 16a's probe, and the node it ran on."""
    import ray_tpu_torch as rt

    return dict(runtime_gpu_probe(t_submit, tol),
                node=rt.get_runtime_context().get_node_id())


def tune_loop(config):
    """18c: a trial's rank. Phase 4's gpt2-125m step (``make_train_step``,
    AdamW(lr, wd 0.1), seed 0) on each batch the rank reads from its
    dataset shard; each report carries the loss, the step's seconds,
    whether the batch is phase 4's, the rank's flash launches so far
    (counted here), its GPU, node and peak memory."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import models as tm
    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.ops import flash_attention as fa

    t_start = time.time()
    dev = rt_train.get_device()
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    state = new_state(tm, cfg, lr=config["lr"])
    step = tm.make_train_step(cfg)
    want = train_batch(cfg.vocab_size)
    node = rt.get_runtime_context().get_node_id()
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    shard = rt_train.get_dataset_shard("train")
    for i, b in enumerate(shard.iter_batches(batch_size=B,
                                             batch_format="numpy")):
        batch = {k: torch.tensor(v, device=dev) for k, v in b.items()}
        same = set(batch) == set(want) and all(
            torch.equal(batch[k], want[k]) for k in want)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = metrics["loss"].item()          # waits for the step
        dt = time.perf_counter() - t0
        rt_train.report({
            "step": i, "loss": loss, "s": dt, "batch_equal": same,
            "launches": {k.symbol.removeprefix("rtt_"): k.launches
                         for k in fa.KERNELS},
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count(), "node": node,
            "peak": torch.cuda.max_memory_allocated(), "t": time.time(),
            "t_start": t_start})


def tune_dataset(rd, vocab):
    """18b: phase 4's seeded tokens, one row per sequence, repeated for
    TUNE_STEPS steps, cut into inputs and targets. The shuffled copy has
    2 blocks: its 2 mergers and 2 map tasks fit the head's 4 CPUs, so its
    demand launches no node."""
    toks = np.random.default_rng(0).integers(0, vocab, (B, L + 1))
    rows = np.tile(toks, (TUNE_STEPS, 1))
    ds = rd.from_numpy(rows).map_batches(
        lambda b: {"inputs": b["data"][:, :-1], "targets": b["data"][:, 1:]})
    shuffled = sorted(
        r["data"].tobytes() for r in rd.from_numpy(
            rows, parallelism=2).random_shuffle(seed=0).take_all())
    if shuffled != sorted(r.tobytes() for r in rows):
        raise AssertionError("tune-data: the shuffled rows are not a "
                             "permutation of the rows")
    return ds


class NodeLog:
    """The cluster's nodes as the GCS sees them, sampled every 0.25 s on a
    thread, and the autoscaler's reconcile summaries; written to
    ``chiprun_out/tune_nodes.jsonl``."""

    def __init__(self, rt, autoscaler):
        import threading

        self.rows, self._stop = [], threading.Event()
        once = autoscaler.run_once

        def logged():
            out = once()
            self.rows.append({"t": time.time(), "autoscaler": out})
            return out

        autoscaler.run_once = logged

        def sample():
            while not self._stop.wait(0.25):
                try:
                    self.rows.append({"t": time.time(), "nodes": [
                        {k: n[k] for k in ("NodeID", "Alive", "Resources",
                                           "Available", "LocallyHeld")}
                        for n in rt.nodes()]})
                except Exception as e:
                    self.rows.append({"t": time.time(), "error": repr(e)})

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()

    def close(self, path):
        self._stop.set()
        self._thread.join(5)
        with open(path, "w") as f:
            for row in self.rows:
                f.write(json.dumps(row) + "\n")


def tune_phase(tm, fa, run, spread, tol, errors):
    """Phase 18: the sweep on an autoscaled GPU node."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch import tune
    from ray_tpu_torch.autoscaler.cluster_launcher import launch_cluster

    t0 = time.perf_counter()
    os.makedirs("chiprun_out", exist_ok=True)
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    # 16b's tolerance: 1e-6, or phase 4's own spread in this call.
    loss_tol = max(GANG_LOSS_ATOL, spread)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    launched = launch_cluster({
        "max_workers": 1, "idle_timeout_s": TUNE_IDLE_S,
        "update_interval_s": 1.0,
        "provider": {"type": "local_process"},
        "head_node_type": {"CPU": RUNTIME_CPUS, "GPU": 0},
        "available_node_types": {"gpu_host": {
            "resources": {"CPU": 2, "GPU": 1},
            "min_workers": 0, "max_workers": 1}}})
    out = {}
    nlog = None
    try:
        rt.init(address=launched.address, log_to_driver=False)
        nlog = NodeLog(rt, launched.autoscaler)
        head = rt.get_runtime_context().get_node_id()
        if rt.cluster_resources().get("GPU", 0) or \
                launched.provider.non_terminated_nodes():
            raise AssertionError(f"tune: the head starts with "
                                 f"{rt.cluster_resources()}")

        # (b) the dataset, on the head's CPUs.
        tb = time.perf_counter()
        ds = tune_dataset(rd, cfg.vocab_size)
        if launched.provider.non_terminated_nodes():
            raise AssertionError("tune-data: the dataset's demand launched "
                                 "a node")
        log(f"tune-data ok: from_numpy of phase 4's tokens [{B}, {L + 1}] "
            f"x {TUNE_STEPS} steps ({ds.num_blocks()} blocks), map_batches "
            f"cutting inputs and targets; random_shuffle(seed=0) a "
            f"permutation of the rows; {time.perf_counter() - tb:.2f} s")

        # (a) autoscale up: a GPU task's demand launches the node.
        probe = rt.remote(tune_gpu_probe).options(num_gpus=1)
        t_submit = time.time()
        ref = probe.remote(t_submit, tol)
        t_reg = None
        while t_reg is None and time.time() - t_submit < TUNE_UP_TIMEOUT_S:
            if any(n["Alive"] and n["NodeID"] != head for n in rt.nodes()):
                t_reg = time.time()
            else:
                time.sleep(0.05)
        p = rt.get(ref, timeout=TUNE_UP_TIMEOUT_S)
        first_ms = (time.time() - t_submit) * 1e3
        gpu_nodes = [n["NodeID"] for n in rt.nodes() if n["NodeID"] != head]
        provider_nodes = launched.provider.non_terminated_nodes()
        if t_reg is None or len(gpu_nodes) != 1 or \
                len(provider_nodes) != 1 or p["node"] != gpu_nodes[0]:
            raise AssertionError(f"tune-up: nodes {rt.nodes()}, provider "
                                 f"{provider_nodes}, task on {p['node']}")
        if p["cuda_visible_devices"] != "0" or p["device_count"] != 1 or \
                p["errors"] != errors or p["launches"] != {
                    k: 1 for k in want}:
            raise AssertionError(f"tune-up: GPU task {p} (phase 2's errors "
                                 f"{errors})")
        out["up"] = {"demand_to_registration_ms": (t_reg - t_submit) * 1e3,
                     "submit_to_first_line_ms": p["spawn_ms"],
                     "first_result_ms": first_ms,
                     "torch_import_ms": p["torch_import_ms"],
                     "first_cuda_ms": p["first_cuda_ms"],
                     "errors": p["errors"]}
        log(f"tune-up ok: the num_gpus=1 task's demand launched one "
            f"gpu_host node ({provider_nodes[0]}, a node_daemon process; "
            f"GCS node {gpu_nodes[0][:12]}); the task ran there (not on the "
            f"head {head[:12]}) with CUDA_VISIBLE_DEVICES="
            f"{p['cuda_visible_devices']}, K1-K3 at [{B}, {L}, {H}, {D}] "
            f"bf16 causal against their plain versions: max |diff| "
            f"{p['errors']} = phase 2's; demand to registration "
            f"{(t_reg - t_submit) * 1e3:.0f} ms, submit to the task's first "
            f"line {p['spawn_ms']:.0f} ms, first result {first_ms:.0f} ms; "
            f"card: {gpu_line()}")

        # (c) the sweep.
        with tempfile.TemporaryDirectory(
                dir=os.path.abspath("chiprun_out")) as storage:
            trainer = rt_train.TorchDistTrainer(
                tune_loop,
                scaling_config=rt_train.ScalingConfig(num_workers=1,
                                                      use_gpu=True),
                run_config=rt_train.RunConfig(name="tune-gang",
                                              storage_path=storage),
                datasets={"train": ds}, backend="torch_dist", runtime=rt)
            fa.reset_launches()
            t_fit = time.time()
            grid = tune.Tuner(
                trainer,
                param_space={"train_loop_config": {
                    "lr": tune.grid_search(list(TUNE_LRS))}},
                tune_config=tune.TuneConfig(
                    metric="loss", mode="min",
                    resources_per_trial=tune.PlacementGroupFactory(
                        [{"CPU": 1}, {"CPU": 1, "GPU": 1}])),
                run_config=rt_train.RunConfig(name="tune",
                                              storage_path=storage)).fit()
            fit_s = time.time() - t_fit
        here = {k.symbol: k.launches for k in fa.KERNELS}
        if any(here.values()):
            raise AssertionError(f"tune: the driver launched {here}")
        if len(grid) != 2 or grid.errors:
            raise AssertionError(f"tune: {len(grid)} results, errors "
                                 f"{grid.errors}")
        trials = []
        for r, lr in zip(grid, TUNE_LRS):
            hist = r.metrics_history
            last = hist[-1]
            if [m["step"] for m in hist] != list(range(TUNE_STEPS)) or \
                    not all(m["batch_equal"] for m in hist):
                raise AssertionError(f"tune lr {lr}: steps "
                                     f"{[m['step'] for m in hist]}, phase "
                                     f"4's batch {[m['batch_equal'] for m in hist]}")
            if {m["node"] for m in hist} != {gpu_nodes[0]} or \
                    last["cuda_visible_devices"] != "0" or \
                    last["device_count"] != 1:
                raise AssertionError(f"tune lr {lr}: rank on "
                                     f"{ {m['node'] for m in hist} } with "
                                     f"{last['cuda_visible_devices']}")
            for name, per_step in want.items():
                if last["launches"][name] != per_step * TUNE_STEPS:
                    raise AssertionError(
                        f"tune lr {lr}: {name} launched "
                        f"{last['launches'][name]} times in {TUNE_STEPS} "
                        f"steps in the rank")
            losses = [m["loss"] for m in hist]
            trials.append({
                "lr": lr, "losses": losses,
                "cold_start_s": hist[0]["t"] - t_fit if not trials else
                hist[0]["t"] - trials[-1]["end"],
                "rank_start_to_first_report_s": hist[0]["t"] -
                hist[0]["t_start"],
                "start": hist[0]["t_start"], "end": last["t"],
                "step_ms": statistics.median(
                    m["s"] for m in hist[WARMUP_STEPS:]) * 1e3,
                "all_step_ms": [m["s"] * 1e3 for m in hist],
                "peak_gb": max(m["peak"] for m in hist) / 1e9,
                "launches_per_step": {k: v // TUNE_STEPS for k, v in
                                      last["launches"].items()}})
        a, b_ = trials
        if not a["end"] <= b_["start"]:
            raise AssertionError(f"tune: the trials overlapped {trials}")
        err = max(abs(x - y) for x, y in zip(a["losses"], run.losses))
        first_err = abs(b_["losses"][0] - run.losses[0])
        if err > loss_tol or first_err > loss_tol:
            raise AssertionError(
                f"tune: lr 3e-4 losses {a['losses']} vs phase 4's "
                f"{run.losses[:TUNE_STEPS]} (max |diff| {err}); lr 1e-3 "
                f"first loss {b_['losses'][0]} (|diff| {first_err}); tol "
                f"{loss_tol}")
        best = grid.get_best_result("loss", "min")
        lower = min(trials, key=lambda x: x["losses"][-1])
        if best.metrics["loss"] != lower["losses"][-1]:
            raise AssertionError(f"tune: best {best.metrics} is not the "
                                 f"lr {lower['lr']} trial")
        out["trials"] = trials
        out.update(loss_err=err, first_loss_err=first_err, loss_tol=loss_tol,
                   fit_s=fit_s, best_lr=lower["lr"],
                   phase4_step_ms=run.step_ms)
        for x in trials:
            log(f"tune trial lr {x['lr']:g} ok: {TUNE_STEPS} steps of "
                f"gpt2-125m batch {B} seq {L} on the autoscaled node, "
                f"CUDA_VISIBLE_DEVICES=0, losses "
                f"{[round(v, 6) for v in x['losses']]}; launches a step in "
                f"the rank {x['launches_per_step']}; cold start "
                f"{x['cold_start_s']:.1f} s (from "
                f"{'fit()' if x is a else 'the first trial end'} to the "
                f"first report; the rank's own start to it "
                f"{x['rank_start_to_first_report_s']:.1f} s), step_ms "
                f"{x['step_ms']:.2f} (median of {TUNE_STEPS - WARMUP_STEPS}"
                f"; phase 4 {run.step_ms:.2f}), the rank's peak memory "
                f"{x['peak_gb']:.2f} GB")
        log(f"tune ok: 2 trials, no errors, one after the other on node "
            f"{gpu_nodes[0][:12]}; lr 3e-4 losses = phase 4's first "
            f"{TUNE_STEPS} within {err:.3e}, lr 1e-3 first loss within "
            f"{first_err:.3e} (tol {loss_tol:.1e}); best: lr "
            f"{lower['lr']:g}; none launched here; fit {fit_s:.1f} s; card: "
            f"{gpu_line()}")

        # (d) scale down.
        t_end = b_["end"]
        t_gone = None
        while time.time() - t_end < TUNE_IDLE_S + TUNE_DOWN_SLACK_S:
            alive = [n["NodeID"] for n in rt.nodes() if n["Alive"]]
            if alive == [head] and not rt.cluster_resources().get("GPU", 0) \
                    and not launched.provider.non_terminated_nodes():
                t_gone = time.time()
                break
            time.sleep(0.1)
        if t_gone is None:
            raise AssertionError(
                f"tune-down: after {TUNE_IDLE_S + TUNE_DOWN_SLACK_S:.0f} s "
                f"nodes {rt.nodes()}, resources {rt.cluster_resources()}")
        if len([n for n in rt.nodes() if n["NodeID"] != head]) != 1:
            raise AssertionError(f"tune: more than one node launched "
                                 f"{rt.nodes()}")
        out["down_s"] = t_gone - t_end
        log(f"tune-down ok: the idle gpu_host node terminated "
            f"{t_gone - t_end:.1f} s after the last trial's end (idle "
            f"timeout {TUNE_IDLE_S:.0f} s); GPUs 0, only the head alive; one"
            f" node launched in the phase")
    finally:
        try:
            if nlog is not None:
                nlog.close(os.path.join("chiprun_out", "tune_nodes.jsonl"))
            rt.shutdown()
        finally:
            launched.shutdown()
    out["phase_s"] = time.perf_counter() - t0
    log(f"tune phase ok in {out['phase_s']:.1f} s")
    log("tune metrics: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 19: a user's way into the port's cluster. The head started from the
# port's CLI, the dashboard head over it, a submitted job whose driver runs
# a durable workflow of GPU training steps (one fails once and the job
# resumes it), a thin client's GPU task from a process that sees no GPU,
# and the CLI's stop.

JOBS_CPUS = 4
JOBS_STORE_BYTES = 8 << 30   # the head's store: a step's state in and out
JOBS_FIRST, JOBS_SECOND = 3, 4       # train's steps: 0-2, then 3-6
JOBS_HOLD_TIMEOUT_S = 300.0
JOBS_TIMEOUT_S = 300.0
JOBS_WORKFLOW = "gpt2-steps"

JOBS_DRIVER = """\
import json, os, sys, time
t_start = time.time()
sys.path.insert(0, {repo!r})
import ray_tpu_torch as rt
from ray_tpu_torch import workflow
import chip_smoke as cs

env = {{"cuda": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "ours": sorted(k for k in os.environ
                       if k.startswith("RAY_TPU_TORCH_"))}}
rt.init(address="auto", log_to_driver=False)
workflow.init({store!r})
init = rt.remote(cs.jobs_init).options(num_gpus=1)
train = rt.remote(cs.jobs_train).options(num_gpus=1)
first = train.bind(init.bind({work!r}), 0, {first}, {work!r}, "hold")
dag = train.bind(first, {first}, {second}, {work!r}, "fail_once")
t_run = time.time()
try:
    workflow.run(dag, workflow_id={wid!r})
    error = None
except Exception as e:
    error = repr(e)
failed = workflow.get_status({wid!r})
t_resume = time.time()
out = workflow.resume({wid!r})
t_end = time.time()
with open(os.path.join({work!r}, "nodes.jsonl")) as f:
    nodes = [json.loads(line) for line in f]
print("JOB " + json.dumps({{
    "env": env, "error": error, "failed_status": failed,
    "status": workflow.get_status({wid!r}), "nodes": nodes,
    "out_start": out["start"], "out_losses": out["losses"],
    "t_start": t_start, "t_run": t_run, "t_resume": t_resume,
    "t_end": t_end}}), flush=True)
rt.shutdown()
"""


def _tree(fn, x):
    """``fn`` on every tensor of nested dicts and lists."""
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(fn, v) for v in x)
    return fn(x) if isinstance(x, torch.Tensor) else x


def _node_facts(t_enter):
    """What a workflow node of 19b reports of its process."""
    return {"t_enter": t_enter, "process_age_s": _process_age_s(),
            "pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count()}


def _node_record(work, rec):
    """One line of ``<work>/nodes.jsonl`` for each run of a node."""
    with open(os.path.join(work, "nodes.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def jobs_init(work):
    """19b's first node, in a ``num_gpus=1`` worker: phase 4's state (seed
    0, AdamW(3e-4, wd 0.1)) drawn on the card and returned as CPU
    tensors, which the workflow checkpoints."""
    t_enter = time.time()
    from ray_tpu_torch import models as tm

    facts = _node_facts(t_enter)
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    state = new_state(tm, cfg)
    cpu = functools.partial(_tree, lambda t: t.detach().cpu())
    out = {"params": cpu(state.params),
           "opt": cpu(state.opt_state.state_dict())}
    _node_record(work, dict(facts, name="init", t_exit=time.time()))
    return out


def jobs_train(state, start, n, work, mode):
    """19b's training node, in a ``num_gpus=1`` worker: the state onto the
    card, ``n`` of phase 4's steps (``make_train_step``, phase 4's batch)
    from step ``start``, each step's flash launches counted around it,
    the state back as CPU tensors. ``mode`` "hold" waits after the load
    until the phase has probed the cluster (``<work>/probed``);
    "fail_once" raises after its steps the first time it runs."""
    t_enter = time.time()
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.ops import flash_attention as fa

    facts = _node_facts(t_enter)
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    params = _tree(lambda t: t.cuda().requires_grad_(), state["params"])
    ts = tm.new_train_state(params, functools.partial(
        torch.optim.AdamW, lr=3e-4, weight_decay=0.1))
    ts.opt_state.load_state_dict(state["opt"])
    step = tm.make_train_step(cfg)
    batch = train_batch(cfg.vocab_size)
    torch.cuda.synchronize()
    t_loaded = time.time()
    if mode == "hold":
        with open(os.path.join(work, "running"), "w") as f:
            f.write(str(os.getpid()))
        probed = os.path.join(work, "probed")
        while not os.path.exists(probed):
            if time.time() - t_loaded > JOBS_HOLD_TIMEOUT_S:
                raise TimeoutError("jobs: the phase never probed")
            time.sleep(0.05)
    t_steps = time.time()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, launches = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        ts, metrics = step(ts, batch)
        losses.append(metrics["loss"].item())    # waits for the step
        seconds.append(time.perf_counter() - t0)
        launches.append({k.symbol.removeprefix("rtt_"): k.launches
                         for k in fa.KERNELS})
    marker = os.path.join(work, "failed_once")
    fail = mode == "fail_once" and not os.path.exists(marker)
    cpu = functools.partial(_tree, lambda t: t.detach().cpu())
    out = {"params": cpu(ts.params), "opt": cpu(ts.opt_state.state_dict()),
           "start": start, "losses": losses}
    _node_record(work, dict(
        facts, name=f"train{start}", raised=fail, losses=losses,
        step_s=seconds, launches=launches,
        peak=torch.cuda.max_memory_allocated(), t_loaded=t_loaded,
        t_steps=t_steps, t_exit=time.time()))
    if fail:
        with open(marker, "w") as f:
            f.write(str(os.getpid()))
        raise RuntimeError(f"jobs: steps {start}-{start + n - 1} fail once")
    return out


def _cli(env, out_dir, *args, timeout=120, with_err=False):
    """``python -m ray_tpu_torch ARGS`` from the repo's root, output to
    files (the head daemon keeps whatever it inherits open). Returns its
    output and seconds, with its error output between when asked."""
    name = os.path.join(out_dir, "cli-" + "-".join(args[:2]))
    with open(name + ".out", "w+") as fo, open(name + ".err", "w+") as fe:
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            env=env, stdout=fo, stderr=fe,
                            stdin=subprocess.DEVNULL,
                            timeout=timeout).returncode
        s = time.perf_counter() - t0
        fo.seek(0)
        fe.seek(0)
        out, err = fo.read(), fe.read()
    if rc != 0:
        raise AssertionError(f"cli: `{' '.join(args)}` exited {rc}: "
                             f"{out[-2000:]} {err[-2000:]}")
    return (out, err, s) if with_err else (out, s)


def _http(port, path, timeout=120):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.read().decode()


JOBS_CLIENT = """\
import json, os, sys, time
sys.path.insert(0, {repo!r})
from ray_tpu_torch.util.client import connect
import chip_smoke as cs

c = connect({address!r})
t_submit = time.time()
ref = c.submit(cs.runtime_gpu_probe, t_submit, {tol!r},
               options={{"num_gpus": 1}})
p = c.get(ref, timeout=600)
print("CLIENT " + json.dumps(dict(
    p, client_cuda=os.environ.get("CUDA_VISIBLE_DEVICES"),
    client_device_count=cs.torch.cuda.device_count())), flush=True)
c.disconnect()
"""


def jobs_phase(tm, fa, run, spread, tol, errors):
    """Phase 19: the head from the CLI, the dashboard, a job's durable
    workflow of GPU steps with a resume, a thin client's GPU task, stop."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.test_utils import session_pids
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient
    from ray_tpu_torch.util.client import ClientServer

    t_phase = time.perf_counter()
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    loss_tol = max(GANG_LOSS_ATOL, spread)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    steps = JOBS_FIRST + JOBS_SECOND
    out = {"parts_s": {}}
    parts = out["parts_s"]
    with tempfile.TemporaryDirectory(prefix="jobs-") as tmp:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("RAY_TPU_TORCH_")}
        env["TMPDIR"] = tmp          # the head's files, sessions and jobs
        torch.cuda.synchronize()
        free_before = torch.cuda.mem_get_info()[0]

        # (a) the head from the shell, its status, the dashboard over it.
        started, parts["head_start"] = _cli(
            env, tmp, "start", "--head", "--num-cpus", str(JOBS_CPUS),
            "--num-gpus", "1", "--object-store-memory",
            str(JOBS_STORE_BYTES))
        head_pid = int(open(os.path.join(
            tmp, "ray_tpu_torch", "head.pid")).read())
        address = open(os.path.join(
            tmp, "ray_tpu_torch", "head.addr")).read().strip()
        session = None
        srv = None
        try:
            status, _ = _cli(env, tmp, "status")
            listed, _ = _cli(env, tmp, "list", "nodes")
            nodes = json.loads(listed)
            if "1 alive" not in status or "GPU: 1 / 1 available" not in \
                    status or len(nodes) != 1 or \
                    nodes[0]["Resources"].get("GPU") != 1.0:
                raise AssertionError(f"jobs-head: status {status!r}, nodes "
                                     f"{nodes}")
            session = os.path.dirname(nodes[0]["StorePath"])
            rt.init(address=address, log_to_driver=False)
            _, dash = start_dashboard(port=free_port())
            t0 = time.time()
            while True:
                api_nodes = json.loads(_http(dash, "/api/nodes"))
                hw = api_nodes[0].get("Hardware") or {}
                if hw.get("gpus_total") is not None or time.time() - t0 > 60:
                    break
                time.sleep(0.2)
            if len(api_nodes) != 1 or hw.get("gpus_total") != 1:
                raise AssertionError(f"jobs-dashboard: /api/nodes "
                                     f"{api_nodes}")
            log(f"jobs-head ok: `python -m ray_tpu_torch start --head "
                f"--num-cpus {JOBS_CPUS} --num-gpus 1` at {address} (pid "
                f"{head_pid}) in {parts['head_start']:.2f} s; status: "
                f"{' '.join(status.split())[:200]}; list nodes: 1 node, "
                f"GPU 1; the dashboard's /api/nodes: gpus_total "
                f"{hw['gpus_total']}, gpus_free {hw.get('gpus_free')}")

            # (b) a job whose driver runs the workflow, and resumes it.
            work = os.path.join(tmp, "work")
            os.makedirs(work)
            script = os.path.join(tmp, "job.py")
            with open(script, "w") as f:
                f.write(JOBS_DRIVER.format(
                    repo=os.path.dirname(os.path.abspath(__file__)),
                    store=os.path.join(tmp, "workflows"), work=work,
                    first=JOBS_FIRST, second=JOBS_SECOND,
                    wid=JOBS_WORKFLOW))
            client = JobSubmissionClient()
            t_submit = time.time()
            sid = client.submit_job(entrypoint=f"{sys.executable} {script}")
            running = os.path.join(work, "running")
            while not os.path.exists(running):
                if client.get_job_status(sid) in JobStatus.TERMINAL or \
                        time.time() - t_submit > JOBS_TIMEOUT_S:
                    raise AssertionError(
                        f"jobs: the first train node never ran: "
                        f"{client.get_job_logs(sid)[-3000:]}")
                time.sleep(0.05)
            pid = int(open(running).read())
            tasks = json.loads(_http(dash, "/api/tasks"))
            gpu_tasks = [(t.get("name"), t.get("state")) for t in tasks
                         if t.get("name") in ("jobs_init", "jobs_train")]
            folded = _http(dash, "/api/profile?duration_s=2&format=folded")
            mine = [ln for ln in folded.splitlines() if f"pid={pid};" in ln]
            t0 = time.time()
            while True:
                gauges = {}
                for ln in _http(dash, "/metrics").splitlines():
                    if ln.startswith(("ray_tpu_node_gpus_total{",
                                      "ray_tpu_node_gpus_free{")):
                        gauges[ln.split("{")[0]] = float(ln.rsplit(" ")[-1])
                if gauges.get("ray_tpu_node_gpus_free") == 0 or \
                        time.time() - t0 > 10:
                    break
                time.sleep(0.2)
            with open(os.path.join(work, "probed"), "w") as f:
                f.write("x")
            if ("jobs_train", "RUNNING") not in gpu_tasks or \
                    not any("jobs_train" in ln for ln in mine) or \
                    gauges != {"ray_tpu_node_gpus_total": 1.0,
                               "ray_tpu_node_gpus_free": 0.0}:
                raise AssertionError(
                    f"jobs-probe: GPU tasks {gpu_tasks}; folded lines of "
                    f"pid {pid}: {mine[:5]} (of {len(folded.splitlines())}"
                    f"); GPU gauges {gauges}")
            log(f"jobs-probe ok, while the first train node holds the GPU: "
                f"/api/tasks lists {gpu_tasks}; /api/profile?duration_s=2"
                f"&format=folded has {len(mine)} stacks of the node's "
                f"worker (pid {pid}), in jobs_train; /metrics {gauges}")
            status = client.wait_until_finish(sid, timeout=JOBS_TIMEOUT_S)
            t_done = time.time()
            logs = client.get_job_logs(sid)
            lines = [ln for ln in logs.splitlines() if ln.startswith("JOB ")]
            if status != JobStatus.SUCCEEDED or not lines:
                raise AssertionError(f"jobs: status {status}: "
                                     f"{logs[-4000:]}")
            job = json.loads(lines[-1][len("JOB "):])
            nodes = job["nodes"]
            runs = [n["name"] for n in nodes]
            init_n, first_n, failed_n, second_n = nodes
            losses = first_n["losses"] + second_n["losses"]
            err = max(abs(a - b) for a, b in zip(losses, run.losses))
            per_step = first_n["launches"] + second_n["launches"]
            if job["failed_status"] != "FAILED" or not job["error"] or \
                    job["status"] != "SUCCESSFUL" or runs != [
                        "init", "train0", f"train{JOBS_FIRST}",
                        f"train{JOBS_FIRST}"] or not failed_n["raised"] \
                    or second_n["raised"] or \
                    job["out_losses"] != second_n["losses"]:
                raise AssertionError(f"jobs-workflow: {job}")
            if len(losses) != steps or err > loss_tol or any(
                    x != want for x in per_step):
                raise AssertionError(
                    f"jobs-workflow: losses {losses} vs phase 4's "
                    f"{run.losses} (max |diff| {err}, tol {loss_tol}); "
                    f"launches a step {per_step}")
            for node in nodes:
                if node["cuda_visible_devices"] != "0" or \
                        node["device_count"] != 1:
                    raise AssertionError(f"jobs: a node saw {node}")
            if job["env"] != {"cuda": "", "ours": ["RAY_TPU_TORCH_ADDRESS"]}:
                raise AssertionError(f"jobs: the driver's env {job['env']}")
            starts = {"init": init_n["t_enter"] - job["t_run"],
                      "train0": first_n["t_enter"] - init_n["t_exit"],
                      "train3": failed_n["t_enter"] - first_n["t_exit"],
                      "train3 resumed":
                          second_n["t_enter"] - job["t_resume"]}
            parts.update(
                job_start=job["t_start"] - t_submit,
                driver_to_run=job["t_run"] - job["t_start"],
                node_start=starts,
                state_load=[n["t_loaded"] - n["t_enter"]
                            for n in (first_n, failed_n, second_n)],
                resume=job["t_end"] - job["t_resume"],
                job=t_done - t_submit)
            out["workflow"] = {
                "losses": losses, "loss_err": err, "loss_tol": loss_tol,
                "launches_per_step": per_step[0],
                "step_ms": [x * 1e3 for x in
                            first_n["step_s"] + second_n["step_s"]],
                "peak_gb": max(first_n["peak"], second_n["peak"]) / 1e9,
                "process_age_s": [n["process_age_s"] for n in nodes],
                "pids": [n["pid"] for n in nodes], "runs": runs}
            log(f"jobs-workflow ok: job {sid} SUCCEEDED; its driver (env "
                f"CUDA_VISIBLE_DEVICES='', {job['env']['ours']}) ran "
                f"workflow {JOBS_WORKFLOW!r}: init, train steps 0-"
                f"{JOBS_FIRST - 1}, train steps {JOBS_FIRST}-{steps - 1} "
                f"(num_gpus=1 each, CUDA_VISIBLE_DEVICES=0); the last "
                f"failed once ({job['error'][:80]}), status FAILED; resume "
                f"ran only it again (runs {runs}); losses "
                f"{[round(x, 6) for x in losses]} = phase 4's within "
                f"{err:.3e} (tol {loss_tol:.1e}); launches a step "
                f"{per_step[0]} in each of the {steps} steps; nodes in pids "
                f"{out['workflow']['pids']}")
            log(f"jobs-workflow times: submit to the driver's first line "
                f"{parts['job_start']:.2f} s, then "
                f"{parts['driver_to_run']:.2f} s to workflow.run; each "
                f"node's start (init from run, the next from the previous "
                f"one's end, the resumed one from resume) "
                f"{({k: round(v, 2) for k, v in starts.items()})} s "
                f"(process ages {[round(a, 1) for a in out['workflow']['process_age_s']]} s); "
                f"state onto the card "
                f"{[round(x, 2) for x in parts['state_load']]} s; resume "
                f"{parts['resume']:.2f} s; job {parts['job']:.2f} s; step "
                f"ms {[round(x, 2) for x in out['workflow']['step_ms']]} "
                f"(phase 4 {run.step_ms:.2f}); the nodes' peak "
                f"{out['workflow']['peak_gb']:.2f} GB")

            # (c) a thin client with no GPU submits a GPU task.
            srv = ClientServer()
            cscript = os.path.join(tmp, "client.py")
            with open(cscript, "w") as f:
                f.write(JOBS_CLIENT.format(
                    repo=os.path.dirname(os.path.abspath(__file__)),
                    address=srv.address, tol=tol))
            cenv = dict(env, CUDA_VISIBLE_DEVICES="")
            t0 = time.perf_counter()
            with open(os.path.join(tmp, "client.out"), "w+") as fo, \
                    open(os.path.join(tmp, "client.err"), "w+") as fe:
                rc = subprocess.run([sys.executable, cscript], env=cenv,
                                    stdout=fo, stderr=fe,
                                    stdin=subprocess.DEVNULL,
                                    timeout=600).returncode
                fo.seek(0)
                fe.seek(0)
                cout, cerr = fo.read(), fe.read()
            parts["client"] = time.perf_counter() - t0
            clines = [ln for ln in cout.splitlines()
                      if ln.startswith("CLIENT ")]
            if rc != 0 or not clines:
                raise AssertionError(f"jobs-client: rc {rc}: {cout[-2000:]}"
                                     f" {cerr[-3000:]}")
            p = json.loads(clines[-1][len("CLIENT "):])
            if p["client_cuda"] != "" or p["client_device_count"] != 0 or \
                    p["cuda_visible_devices"] != "0" or \
                    p["device_count"] != 1 or p["errors"] != errors or \
                    p["launches"] != {k: 1 for k in want}:
                raise AssertionError(f"jobs-client: {p} (phase 2's errors "
                                     f"{errors})")
            out["client"] = {k: p[k] for k in ("errors", "spawn_ms")}
            log(f"jobs-client ok: a process with CUDA_VISIBLE_DEVICES='' "
                f"(0 devices) connected to the ClientServer at "
                f"{srv.address} and submitted a num_gpus=1 task: it ran "
                f"with CUDA_VISIBLE_DEVICES=0 and held K1-K3 at [{B}, {L}, "
                f"{H}, {D}] bf16 causal to their plain versions, max |diff|"
                f" {p['errors']} = phase 2's; the client's run "
                f"{parts['client']:.2f} s")
        finally:
            if srv is not None:
                srv.close()
            rt.shutdown()
            # (d) stop: the head and every process of its session go.
            before = session_pids(head_pid, session) if session else []
            _, parts["stop"] = _cli(env, tmp, "stop")
        left = session_pids(head_pid, session)
        if head_pid not in before or len(before) < 3 or left:
            raise AssertionError(f"jobs-stop: session processes {before} "
                                 f"before, {left} after")
        t0 = time.time()
        while torch.cuda.mem_get_info()[0] < free_before and \
                time.time() - t0 < 30:
            time.sleep(0.2)
        free_after = torch.cuda.mem_get_info()[0]
        if free_after < free_before:
            raise AssertionError(f"jobs-stop: the card's free memory "
                                 f"{free_after} after, {free_before} before")
        log(f"jobs-stop ok: `python -m ray_tpu_torch stop` in "
            f"{parts['stop']:.2f} s; {len(before)} processes of the session"
            f" before (the head {head_pid}, its GCS, zygotes, workers), none"
            f" after; the card's free memory {free_after / 2**30:.2f} GiB, "
            f"{free_before / 2**30:.2f} GiB before 19a")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"jobs phase ok in {out['phase_s']:.1f} s; card: {gpu_line()}")
    log("jobs metrics: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 20: the correctness tooling on the port's torch-free control plane:
# its raylint, and the main path's step under the reference's two
# correctness modes (the always-on sampling profiler, the spec-template
# verify mode).

CORRECTNESS_TASKS = 1000
CORRECTNESS_HOLD_S = 8.0     # the GPU task steps on this long after its checks
CORRECTNESS_PROFILE_S = 2
# The same head's `start --head`, `stop` and GCS child's RSS when each of
# these interpreters imported torch (NVIDIA H100 80GB HBM3, 700.00 W).
CLI_WITH_TORCH = {"start_s": 14.47, "stop_s": 11.09, "gcs_rss_mib": 4554}

LINT_PROBE = """\
import json, runpy, sys, time
t0 = time.perf_counter()
sys.argv = ["lint", "--json"]
try:
    runpy.run_module("ray_tpu_torch._private.lint", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
print("LINT " + json.dumps({"rc": rc, "s": time.perf_counter() - t0,
                           "modules": sorted({m.split(".")[0]
                                              for m in sys.modules})}))
"""


def phase4_spread(tm, fa, run):
    """Phase 4's own spread in this call: its steps once more, from the
    same seed, against ``run``. The later phases hold their losses to
    phase 4's within 1e-6 or this, whichever is larger."""
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    again = run_steps(fa, new_state(tm, cfg), tm.make_train_step(cfg),
                      train_batch(cfg.vocab_size), "phase-4 again",
                      cfg.n_layers)
    spread = max(abs(a - b) for a, b in zip(again.losses, run.losses))
    del again
    gc_collect()
    return spread


def _rss_mib(pid):
    """A process's resident MiB from /proc: all of it (``VmRSS``), and its
    anonymous and shared-memory parts (the store's arena is shared)."""
    out = {}
    with open(f"/proc/{pid}/status") as f:
        for ln in f:
            key = ln.split(":")[0]
            if key in ("VmRSS", "RssAnon", "RssShmem"):
                out[key] = int(ln.split()[1]) / 1024
    if "VmRSS" not in out:
        raise AssertionError(f"correctness: no VmRSS for pid {pid}")
    return out


def _maps_torch(pid):
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def correctness_lint():
    """20a: the port's lint in a fresh interpreter (this machine has no
    jax), then the CLI's head: its start and stop, and what its processes
    hold."""
    from ray_tpu_torch._private.test_utils import session_pids

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", LINT_PROBE], cwd=repo,
                          capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    lines = done.stdout.splitlines()
    tail = [ln for ln in lines if ln.startswith("LINT ")]
    if done.returncode != 0 or not tail:
        raise AssertionError(f"correctness-lint: exited {done.returncode}: "
                             f"{done.stdout[-2000:]} {done.stderr[-2000:]}")
    probe = json.loads(tail[-1][len("LINT "):])
    report = json.loads("\n".join(ln for ln in lines
                                  if not ln.startswith("LINT ")))
    if probe["rc"] != 0 or report["violations"] or \
            report["stale_baseline"] or {"torch", "jax", "ray_tpu"} & set(
                probe["modules"]):
        raise AssertionError(f"correctness-lint: rc {probe['rc']}, "
                             f"{report}, modules {probe['modules']}")
    out = {"lint_s": probe["s"], "lint_wall_s": wall_s,
           "lint_total": report["total_current"]}
    log(f"correctness-lint ok: `python -m ray_tpu_torch._private.lint "
        f"--json` in a fresh interpreter: 0 violations, 0 stale baseline "
        f"entries; torch, jax and ray_tpu not loaded; lint "
        f"{probe['s']:.2f} s, the interpreter {wall_s:.2f} s; card: "
        f"{gpu_line()}")

    with tempfile.TemporaryDirectory(prefix="correctness-head-") as tmp:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("RAY_TPU_TORCH_")}
        env["TMPDIR"] = tmp
        _, out["start_s"] = _cli(
            env, tmp, "start", "--head", "--num-cpus", str(JOBS_CPUS),
            "--num-gpus", "1", "--object-store-memory",
            str(JOBS_STORE_BYTES))
        try:
            head = int(open(os.path.join(
                tmp, "ray_tpu_torch", "head.pid")).read())
            gcs = []
            for pid in session_pids(head, tmp):
                with contextlib.suppress(OSError):
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        if b"ray_tpu_torch._private.gcs" in f.read():
                            gcs.append(pid)
            if len(gcs) != 1:
                raise AssertionError(f"correctness-cli: GCS children {gcs}")
            out["gcs_rss_mib"] = _rss_mib(gcs[0])
            out["head_rss_mib"] = _rss_mib(head)
            torch_in = [pid for pid in (head, gcs[0]) if _maps_torch(pid)]
        finally:
            _, out["stop_s"] = _cli(env, tmp, "stop")
    if torch_in:
        raise AssertionError(f"correctness-cli: torch mapped in {torch_in} "
                             f"(head {head}, GCS {gcs[0]})")
    def parts(rss):
        # Some kernels' /proc gives VmRSS and no breakdown.
        if "RssAnon" not in rss:
            return "no breakdown in /proc"
        return (f"anonymous {rss['RssAnon']:.1f}, shared memory "
                f"{rss.get('RssShmem', 0):.1f}")

    gcs_rss, head_rss = out["gcs_rss_mib"], out["head_rss_mib"]
    log(f"correctness-cli ok: `start --head --num-cpus {JOBS_CPUS} "
        f"--num-gpus 1 --object-store-memory {JOBS_STORE_BYTES}` "
        f"{out['start_s']:.2f} s (with torch: {CLI_WITH_TORCH['start_s']} "
        f"s), `stop` {out['stop_s']:.2f} s (with torch: "
        f"{CLI_WITH_TORCH['stop_s']} s); the GCS child's RSS "
        f"{gcs_rss['VmRSS']:.1f} MiB (with torch: "
        f"{CLI_WITH_TORCH['gcs_rss_mib']:,} MiB; {parts(gcs_rss)}), the "
        f"head's (node manager and the store's arena) "
        f"{head_rss['VmRSS']:.1f} MiB "
        f"({parts(head_rss)}); neither maps torch; card: {gpu_line()}")
    return out


def correctness_gpu_step(marker, hold_s):
    """20b, in a ``num_gpus=1`` worker: phase 4's step (2 warm-up, 5 timed,
    the flash launches counted here), then the same step again for
    ``hold_s`` seconds once this process's pid is in ``marker``: the
    profile window's."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    step = tm.make_train_step(cfg)
    batch = train_batch(cfg.vocab_size)
    run = run_steps(fa, new_state(tm, cfg), step, batch, "correctness-step",
                    cfg.n_layers)
    state = new_state(tm, cfg)
    with open(marker + ".tmp", "w") as f:
        f.write(str(os.getpid()))
    os.replace(marker + ".tmp", marker)
    held = 0
    end = time.time() + hold_s
    while time.time() < end:
        state, metrics = step(state, batch)
        metrics["loss"].item()
        held += 1
    # The sampler's share of the step, in this process: blocks of
    # TIMED_STEPS steps with it running, stopped, stopped, running.
    from ray_tpu_torch._private import profiler

    sampler = profiler.get_profiler()
    blocks = []
    for on in (True, False, False, True):
        if on:
            sampler.start()
        else:
            sampler.stop()
        times = []
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            metrics["loss"].item()
            times.append(time.perf_counter() - t0)
        blocks.append((on, statistics.median(times) * 1e3))
    return {"losses": run.losses, "times": run.times,
            "launches": run.launches, "peak": run.peak, "held_steps": held,
            "sampler_blocks": blocks, "pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


def correctness_echo(i):
    return i


def _profile_threads():
    import threading

    return [t for t in threading.enumerate() if t.name == "rtpu-profiler"]


def correctness_modes(tm, fa, run, tol, step16_ms):
    """20b: the port's runtime with both modes on and its GCS in a process
    of its own; phase 4's step in a GPU task, profiled through the CLI
    while it runs; 1,000 submissions, each blob verified."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import spec_template
    from ray_tpu_torch._private import worker as tworker
    from ray_tpu_torch._private.config import config

    knobs = ("profiler_always_on", "submit_template_verify",
             "gcs_out_of_process")
    saved = {k: config.get(k) for k in knobs}
    saved_env = {k: os.environ.get("RAY_TPU_TORCH_" + k.upper())
                 for k in knobs}
    made = []
    real_make = spec_template.SpecTemplate.make

    def counted_make(self, task_id, args, submitted_at):
        made.append(self._verify)
        return real_make(self, task_id, args, submitted_at)

    steps = WARMUP_STEPS + TIMED_STEPS
    want = {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
    out = {}
    for k in knobs:
        os.environ["RAY_TPU_TORCH_" + k.upper()] = "1"
        config.set(k, True)
    spec_template.SpecTemplate.make = counted_make
    try:
        with tempfile.TemporaryDirectory(prefix="correctness-") as tmp:
            rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
            try:
                cluster = tworker._global_cluster
                gcs_pid, nm = cluster.gcs_proc.pid, cluster.nm
                if len(_profile_threads()) != 1:
                    raise AssertionError(f"correctness: samplers here "
                                         f"{_profile_threads()}")
                marker = os.path.join(tmp, "stepping")
                t_submit = time.time()
                ref = rt.remote(correctness_gpu_step).options(
                    num_gpus=1).remote(marker, CORRECTNESS_HOLD_S)
                while not os.path.exists(marker):
                    ready, _ = rt.wait([ref], timeout=0.1)
                    if ready:
                        rt.get(ref, timeout=60)    # raises the task's error
                        raise AssertionError("correctness: the GPU task "
                                             "ended before its hold")
                    if time.time() - t_submit > 600:
                        raise AssertionError("correctness: no GPU step")
                gpu_pid = int(open(marker).read())
                with nm._lock:
                    workers = {w.proc.pid for w in nm._workers.values()
                               if w.conn is not None and not w.conn.closed
                               and w.proc.poll() is None}
                folded = os.path.join(tmp, "profile.folded")
                _, err, out["profile_s"] = _cli(
                    dict(os.environ), tmp, "profile", "--duration",
                    str(CORRECTNESS_PROFILE_S), "--format", "folded",
                    "--output", folded, "--address", cluster.address,
                    with_err=True)
                got = rt.get(ref, timeout=600)
                lines = open(folded).read().splitlines()
                kinds = {}
                for ln in lines:
                    label = ln.split(";", 1)[0]
                    pid = int(re.search(r"pid=(\d+)", label).group(1))
                    kinds.setdefault(label.split()[0], set()).add(pid)
                mine = [ln for ln in lines if f"pid={gpu_pid};" in ln]
                summary = re.search(r"sampler already running in (\d+) of "
                                    r"(\d+) processes", err)
                if kinds.get("gcs") != {gcs_pid} or \
                        kinds.get("node_manager") != {os.getpid()} or \
                        os.getpid() not in kinds.get("driver", ()) or \
                        len(kinds.get("driver", ())) != 2 or \
                        not workers <= kinds.get("worker", set()) or \
                        gpu_pid not in workers or not summary or \
                        summary.group(1) != summary.group(2) or \
                        not any("correctness_gpu_step" in ln for ln in mine) \
                        or not any("transformer.py" in ln for ln in mine):
                    raise AssertionError(
                        f"correctness-profile: processes {kinds}, GCS "
                        f"{gcs_pid}, workers {workers}, GPU worker "
                        f"{gpu_pid} ({len(mine)} stacks); {err[-500:]}")
                out["profile"] = {k: len(v) for k, v in kinds.items()}
                out["gpu_stacks"] = len(mine)

                err_loss = max(abs(a - b)
                               for a, b in zip(got["losses"], run.losses))
                launches = got["launches"]
                if len(got["losses"]) != steps or err_loss > tol or \
                        launches != {k: v * steps for k, v in want.items()}:
                    raise AssertionError(
                        f"correctness-step: losses {got['losses']} vs phase "
                        f"4's {run.losses} (tol {tol}); launches {launches}")
                out.update(
                    losses=got["losses"], loss_err=err_loss, tol=tol,
                    launches=launches, held_steps=got["held_steps"],
                    step_ms=statistics.median(
                        got["times"][WARMUP_STEPS:]) * 1e3,
                    peak_gb=got["peak"] / 1e9,
                    sampler_blocks=got["sampler_blocks"],
                    first_result_s=time.time() - t_submit)

                echo = rt.remote(correctness_echo)
                del made[:]
                t0 = time.perf_counter()
                vals = rt.get([echo.remote(i)
                               for i in range(CORRECTNESS_TASKS)],
                              timeout=600)
                out["tasks_s"] = time.perf_counter() - t0
                tpl = echo._submit_template.tpl
                out["verified"] = len(made)
                least = CORRECTNESS_TASKS - tworker.SubmitTemplate.WARMUP_CALLS
                if vals != list(range(CORRECTNESS_TASKS)) or tpl is None \
                        or not tpl._verify or not all(made) or \
                        len(made) < least:
                    raise AssertionError(
                        f"correctness-verify: {len(made)} verified blobs of "
                        f"{CORRECTNESS_TASKS} submissions, template {tpl}")
            finally:
                rt.shutdown()
        end = time.time() + 5
        while _profile_threads() and time.time() < end:
            time.sleep(0.05)
        if _profile_threads():
            raise AssertionError(f"correctness: samplers left after "
                                 f"shutdown {_profile_threads()}")
    finally:
        spec_template.SpecTemplate.make = real_make
        for k in knobs:
            config.set(k, saved[k])
            if saved_env[k] is None:
                os.environ.pop("RAY_TPU_TORCH_" + k.upper(), None)
            else:
                os.environ["RAY_TPU_TORCH_" + k.upper()] = saved_env[k]
    log(f"correctness-profile ok: `python -m ray_tpu_torch profile "
        f"--duration {CORRECTNESS_PROFILE_S}` in {out['profile_s']:.2f} s "
        f"read every process's running sampler ({summary.group(0)}): "
        f"{out['profile']} (the GCS in its own process, the node manager "
        f"in this one, this driver and the CLI's), every live worker; "
        f"{out['gpu_stacks']} stacks of the GPU worker (pid {gpu_pid}) in "
        f"correctness_gpu_step and models/transformer.py; one sampler here "
        f"while up, none after shutdown")
    log(f"correctness-step ok, both modes on: phase 4's step in a num_gpus"
        f"=1 task (CUDA_VISIBLE_DEVICES={got['cuda_visible_devices']}): "
        f"losses = phase 4's within {out['loss_err']:.3e} (tol {tol:.1e}); "
        f"launches {launches} in {steps} steps; {out['held_steps']} more "
        f"steps while profiled")
    log(f"correctness-verify ok: {CORRECTNESS_TASKS} tasks returned in "
        f"{out['tasks_s']:.2f} s, {out['verified']} template blobs each "
        f"equal to a fresh pickle of its spec")
    beside = (f"16b {step16_ms:.2f} ms" if step16_ms is not None
              else "16b not run in this call")
    log(f"correctness step_ms {out['step_ms']:.2f} with both modes on "
        f"(median of {TIMED_STEPS}; all "
        f"{[round(t * 1e3, 2) for t in got['times']]}), {beside}, phase 4 "
        f"{run.step_ms:.2f} ms; the task's peak memory {out['peak_gb']:.2f} "
        f"GB; card: {gpu_line()}")
    log("correctness sampler in the GPU task, median step ms of "
        f"{TIMED_STEPS} a block: " + ", ".join(
            f"{'running' if on else 'stopped'} {ms:.2f}"
            for on, ms in out["sampler_blocks"]))
    return out


def correctness_phase(tm, fa, run, spread, step16_ms=None):
    """Phase 20: the port's lint and its two correctness modes."""
    t0 = time.perf_counter()
    out = {"lint": correctness_lint()}
    tol = max(GANG_LOSS_ATOL, spread)
    out["modes"] = correctness_modes(tm, fa, run, tol, step16_ms)
    out["phase_s"] = time.perf_counter() - t0
    log(f"correctness phase ok in {out['phase_s']:.1f} s")
    log("correctness metrics: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 21: the port runtime's last gaps on the card: donation of a CUDA
# result, the gang supervisor's GCS death push, the reference's fast-path
# off-switches.

# Every fast-path toggle of the reference that the port's runtime reads.
GAPS_TOGGLES = (
    "lease_enabled", "local_scheduling_enabled",
    "local_actor_creation_enabled", "submit_spec_template_enabled",
    "submit_batch_frames_enabled", "submit_ring_enabled",
    "task_done_batch_enabled", "completion_ring_enabled",
    "completion_absorb_enabled", "completion_steal_enabled",
    "worker_completion_ring_enabled", "worker_inline_returns_enabled",
    "worker_zygote_enabled")
# The GCS's death cause for an actor whose worker process died.
GAPS_DEATH_CAUSE = "actor worker died"
GAPS_DETECT_SLACK_S = 3.0
# How long 21b's first rank waits to be killed after its checkpoint.
GAPS_HOLD_S = 300.0


def gaps_make_frame():
    """21a, in a ``num_gpus=1`` worker: 13a's bf16 KV frame from its seed on
    the card, kept in a module global of this worker and returned; the
    time of the return goes beside it, for the staging rate."""
    import builtins

    gen = torch.Generator(device="cuda").manual_seed(13)
    k = torch.randn(KV_FRAME_SHAPE, generator=gen,
                    device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    builtins._chip_smoke_kept = {"frame": k, "pid": os.getpid(),
                                 "returned_at": time.time()}
    return k


def gaps_probe_frame():
    """21a's follow-up in the same worker (the kept frame is absent from
    any other): the kept frame's storage and the card's allocated bytes."""
    import builtins

    from ray_tpu_torch._private import device_objects as tdo

    kept = builtins._chip_smoke_kept
    torch.cuda.synchronize()
    return {"pid": os.getpid(), "maker_pid": kept["pid"],
            "returned_at": kept["returned_at"],
            "storage_bytes": kept["frame"].untyped_storage().nbytes(),
            "allocated": torch.cuda.memory_allocated(),
            "donations": tdo.stats()["donations"]}


def gaps_donation(rt, frame16):
    """21a: the frame returned with ``_donate_result=True``, then without;
    each got here on the card bit for bit, each followed by a probe in the
    producer's worker."""
    make = rt.remote(gaps_make_frame).options(num_gpus=1)
    probe = rt.remote(gaps_probe_frame).options(num_gpus=1)
    gen = torch.Generator(device="cuda").manual_seed(13)
    want = torch.randn(KV_FRAME_SHAPE, generator=gen,
                       device="cuda").to(torch.bfloat16)
    runs = {}
    for donate in (True, False):
        ref = make.options(_donate_result=donate).remote()
        ready, _ = rt.wait([ref], num_returns=1, timeout=300)
        t_ready = time.time()
        if not ready:
            raise AssertionError("gaps-donation: the frame never arrived")
        p = rt.get(probe.remote(), timeout=300)
        back = rt.get(ref, timeout=300)
        if not (back.is_cuda and back.dtype == torch.bfloat16 and
                torch.equal(back.view(torch.uint8), want.view(torch.uint8))):
            raise AssertionError(f"gaps-donation: the frame (donate="
                                 f"{donate}) differs from its seed's")
        p["staging_s"] = t_ready - p["returned_at"]
        runs[donate] = p
        del back, ref
        gc_collect()
    nbytes = want.nbytes
    on, off = runs[True], runs[False]
    freed = off["allocated"] - on["allocated"]
    if not (on["pid"] == on["maker_pid"] == off["pid"] == off["maker_pid"]):
        raise AssertionError(f"gaps-donation: the tasks ran in processes "
                             f"{on['maker_pid']}, {on['pid']}, "
                             f"{off['maker_pid']}, {off['pid']}")
    if on["storage_bytes"] != 0 or off["storage_bytes"] != nbytes or \
            off["donations"] != on["donations"] or on["donations"] < 1 or \
            freed < nbytes:
        raise AssertionError(f"gaps-donation: donated {on}, kept {off}; "
                             f"{freed} B freed of {nbytes}")
    gb = nbytes / 1e9
    out = {"bytes": nbytes, "freed_bytes": freed,
           "allocated_donated": on["allocated"],
           "allocated_kept": off["allocated"],
           "staging_gb_per_s_donated": gb / on["staging_s"],
           "staging_gb_per_s_kept": gb / off["staging_s"],
           "frame16_put_gb_per_s": None if frame16 is None
           else frame16["put_gb_per_s"]}
    beside = ("16c not run in this call" if frame16 is None else
              f"16c's put {frame16['put_gb_per_s']:.2f} GB/s")
    log(f"gaps-donation ok: {list(KV_FRAME_SHAPE)} bf16 ({nbytes} B) made "
        f"on the card by a num_gpus=1 task and returned with "
        f"_donate_result=True, got here bit for bit; the follow-up task in "
        f"the same worker (pid {on['pid']}) sees the kept tensor's storage "
        f"at {on['storage_bytes']} B and torch.cuda.memory_allocated() "
        f"{on['allocated']} B, against {off['allocated']} B after the same "
        f"run without donation: {freed / 1e6:.1f} MB freed (the frame is "
        f"{nbytes / 1e6:.1f} MB); staging from the task's return to the "
        f"ref's readiness {out['staging_gb_per_s_donated']:.2f} GB/s "
        f"donated, {out['staging_gb_per_s_kept']:.2f} GB/s kept, {beside}; "
        f"card: {gpu_line()}")
    return out


def gaps_gang_loop(config):
    """21b: 16b's rank loop (``runtime_gang_loop``), with the rank's pid in
    a side file and each report stamped with the time the attempt's loop
    began. A first attempt waits to be killed after its checkpoint."""
    from ray_tpu_torch import train as rt_train

    side = config["side_dir"]
    tmp = os.path.join(side, "rank.pid.tmp")
    with open(tmp, "w") as f:
        f.write(str(os.getpid()))
    os.replace(tmp, os.path.join(side, "rank.pid"))
    fresh = rt_train.get_checkpoint() is None
    t_loop = time.time()
    report = rt_train.report

    def stamped(metrics, checkpoint=None):
        out = report(dict(metrics, t_loop=t_loop, pid=os.getpid()),
                     checkpoint=checkpoint)
        if fresh and metrics["step"] == GANG_CKPT_STEP:
            open(os.path.join(side, "checkpointed"), "w").close()
            time.sleep(GAPS_HOLD_S)
            raise AssertionError("gaps-gang: the rank was never killed")
        return out

    rt_train.report = stamped
    try:
        runtime_gang_loop(config)
    finally:
        rt_train.report = report


def gaps_death_push(rt, fa, run, tol):
    """21b: 16b's trainer cell with ``FailureConfig(max_failures=1)``; the
    rank SIGKILLed after its step-3 checkpoint reached the run directory.
    The gang error carries the GCS's death cause within a heartbeat plus
    slack; the trainer re-forms on the freed GPU from the checkpoint."""
    import signal
    import threading

    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch._private.config import config as tconfig
    from ray_tpu_torch.train import worker_group as wg

    steps = WARMUP_STEPS + TIMED_STEPS
    heartbeat = float(tconfig.gang_heartbeat_s)
    per_step = {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
    # Whichever sees the death first: the supervisor (the GCS's push, or
    # a ping) or the trainer's poll of the ranks.
    notes, kill = [], {}
    note_dead, poll = wg.WorkerGroup._note_dead, wg.WorkerGroup.poll

    def noted(self, rank, reason):
        # The push's reason is the GCS's death cause itself; a ping's
        # names the runtime's error around it.
        how = "GCS push" if reason == GAPS_DEATH_CAUSE else "ping"
        notes.append((time.time(), f"supervisor ({how})", reason))
        return note_dead(self, rank, reason)

    def polled(self):
        states = poll(self)
        for st in states:
            if st["state"] == "dead":
                notes.append((time.time(), "poll", st["error"] or ""))
        return states

    with tempfile.TemporaryDirectory(
            dir=os.path.abspath("chiprun_out")) as storage:
        side = os.path.join(storage, "side")
        os.makedirs(side)
        run_dir = os.path.join(storage, "gaps-gang")

        def checkpointed():
            return os.path.exists(os.path.join(side, "checkpointed")) and \
                os.path.isdir(run_dir) and any(
                    d.startswith("checkpoint_") for d in os.listdir(run_dir))

        def killer():
            end = time.time() + GAPS_HOLD_S
            while time.time() < end and not kill.get("stop"):
                if checkpointed():
                    pid = int(open(os.path.join(side, "rank.pid")).read())
                    kill["t"], kill["pid"] = time.time(), pid
                    os.kill(pid, signal.SIGKILL)
                    return
                time.sleep(0.02)

        trainer = rt_train.TorchDistTrainer(
            gaps_gang_loop,
            train_loop_config={"steps": steps, "side_dir": side},
            scaling_config=rt_train.ScalingConfig(num_workers=1,
                                                  use_gpu=True),
            run_config=rt_train.RunConfig(
                name="gaps-gang", storage_path=storage,
                failure_config=rt_train.FailureConfig(max_failures=1)),
            backend="torch_dist", runtime=rt)
        th = threading.Thread(target=killer, daemon=True,
                              name="gaps-killer")
        wg.WorkerGroup._note_dead, wg.WorkerGroup.poll = noted, polled
        fa.reset_launches()
        th.start()
        try:
            t0 = time.perf_counter()
            result = trainer.fit()
            fit_s = time.perf_counter() - t0
        finally:
            wg.WorkerGroup._note_dead, wg.WorkerGroup.poll = note_dead, poll
            kill["stop"] = True
            th.join(5)
    here = {k.symbol: k.launches for k in fa.KERNELS}
    if any(here.values()):
        raise AssertionError(f"gaps-gang: the driver launched {here}")
    if "t" not in kill:
        raise AssertionError("gaps-gang: the rank was never killed")
    if not result.ok or result.num_restarts != 1:
        raise AssertionError(f"gaps-gang: fit {result.error}, "
                             f"{result.num_restarts} restarts")
    notes.sort()
    noted = [n for n in notes if n[1].startswith("supervisor")]
    detect_s = noted[0][0] - kill["t"] if noted else None
    seen_s = notes[0][0] - kill["t"]
    reason = result.restart_reasons[0]
    if detect_s is None or detect_s > heartbeat + GAPS_DETECT_SLACK_S or \
            GAPS_DEATH_CAUSE not in reason:
        raise AssertionError(f"gaps-gang: the gang error {detect_s} s after "
                             f"the kill, notes {notes}, restart {reason}")
    hist = result.metrics_history
    first = [m for m in hist if m["pid"] == kill["pid"]]
    second = [m for m in hist if m["pid"] != kill["pid"]]
    if [m["step"] for m in first] != list(range(GANG_CKPT_STEP + 1)) or \
            [m["step"] for m in second] != list(
                range(GANG_CKPT_STEP + 1, steps)):
        raise AssertionError(f"gaps-gang: steps {[m['step'] for m in first]}"
                             f" then {[m['step'] for m in second]}")
    if second[0]["cuda_visible_devices"] != first[0][
            "cuda_visible_devices"]:
        raise AssertionError(f"gaps-gang: re-formed on "
                             f"{second[0]['cuda_visible_devices']}")
    for attempt, start in ((first, 0), (second, GANG_CKPT_STEP + 1)):
        for m in attempt:
            want = {k: v * (m["step"] + 1 - start)
                    for k, v in per_step.items()}
            if m["launches"] != want:
                raise AssertionError(f"gaps-gang: step {m['step']} counted "
                                     f"{m['launches']} in the rank, not "
                                     f"{want}")
    err = max(abs(m["loss"] - run.losses[m["step"]]) for m in hist)
    if err > tol:
        raise AssertionError(f"gaps-gang: losses {[m['loss'] for m in hist]}"
                             f" vs phase 4's {run.losses} (tol {tol})")
    reform_s = second[0]["t_loop"] - kill["t"]
    step1 = statistics.median(m["s"] for m in first[WARMUP_STEPS:]) * 1e3
    step2 = statistics.median(m["s"] for m in second[1:]) * 1e3
    out = {"detect_s": detect_s, "detected_by": noted[0][1],
           "first_seen_s": seen_s, "first_seen_by": notes[0][1],
           "reform_s": reform_s, "reason": reason,
           "loss_err": err, "tol": tol, "step_ms_before": step1,
           "step_ms_after": step2, "phase4_step_ms": run.step_ms,
           "launches_per_step": per_step, "fit_s": fit_s,
           "steps_ms": [round(m["s"] * 1e3, 2) for m in hist]}
    log(f"gaps-gang ok: TorchDistTrainer on runtime=ray_tpu_torch, 1 NCCL "
        f"rank in a num_gpus=1 worker, FailureConfig(max_failures=1): the "
        f"rank (pid {kill['pid']}) SIGKILLed after its step-{GANG_CKPT_STEP}"
        f" checkpoint; the {notes[0][1]} saw it first, {seen_s:.3f} s after "
        f"the kill; the {noted[0][1]} recorded the gang error "
        f"{detect_s:.3f} s after it (bound {heartbeat} s heartbeat + "
        f"{GAPS_DETECT_SLACK_S} s), "
        f"the gang error: {reason!r}; re-formed on the freed GPU "
        f"(CUDA_VISIBLE_DEVICES={second[0]['cuda_visible_devices']}) from "
        f"the checkpoint, its loop began {reform_s:.2f} s after the kill; "
        f"losses of steps 0-{steps - 1} = phase 4's within {err:.3e} (tol "
        f"{tol:.1e}); 24/12/12 launches a step in the rank before and after")
    log(f"gaps-gang step_ms {step1:.2f} before the kill, {step2:.2f} after "
        f"(steps {out['steps_ms']}), phase 4 {run.step_ms:.2f} ms; fit "
        f"{fit_s:.1f} s; card: {gpu_line()}")
    return out


@contextlib.contextmanager
def gaps_toggles_off():
    """Every fast-path toggle off through its ``RAY_TPU_TORCH_*`` variable
    (the workers inherit it) and in this process's registry, which read
    the variables at import; both back as they were after."""
    from ray_tpu_torch._private.config import config as tconfig

    names = {k: "RAY_TPU_TORCH_" + k.upper() for k in GAPS_TOGGLES}
    old_env = {v: os.environ.get(v) for v in names.values()}
    old = {k: tconfig.get(k) for k in GAPS_TOGGLES}
    for k, var in names.items():
        os.environ[var] = "0"
        tconfig.refresh_from_env(k)
    try:
        yield
    finally:
        for var, v in old_env.items():
            if v is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = v
        for k, v in old.items():
            tconfig.set(k, v)


def gaps_gpu_probe(rt, ktol, label):
    """16a's GPU task: K1-K3 against their plain versions at the training
    shape with the kernel tolerances ``ktol``, in a ``num_gpus=1`` worker;
    its result holds its cold start (``spawn_ms``)."""
    probe = rt.remote(runtime_gpu_probe).options(num_gpus=1)
    t_submit = time.time()
    p = rt.get(probe.remote(t_submit, ktol), timeout=300)
    want = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    if p["device_count"] != 1 or p["launches"] != want:
        raise AssertionError(f"gaps-{label}: GPU task {p}")
    return p


def gaps_off_switches(tm, fa, run, tol, ktol, errors, on):
    """21c: a fresh ``init`` with every fast-path toggle off: 16a's GPU
    task gives phase 2's errors bit for bit, 16b's trainer phase 4's
    losses with 24/12/12 launches a step."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker as tworker

    steps = WARMUP_STEPS + TIMED_STEPS
    per_step = {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
    with gaps_toggles_off():
        rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
        try:
            w, nm = tworker.global_worker(), tworker._global_cluster.nm
            if w._lease_mgr is not None or nm._zygotes or \
                    w._comp_ring_enabled:
                raise AssertionError("gaps-off: a fast path is still on")
            p = gaps_gpu_probe(rt, ktol, "off")
            if p["errors"] != errors or p["errors"] != on["errors"]:
                raise AssertionError(f"gaps-off: K1-K3 errors {p['errors']}"
                                     f", toggles on {on['errors']}, phase 2 "
                                     f"{errors}")
            with tempfile.TemporaryDirectory(
                    dir=os.path.abspath("chiprun_out")) as storage:
                result = runtime_fit(rt, fa, storage)
        finally:
            rt.shutdown()
    hist = result.metrics_history
    err = max(abs(m["loss"] - run.losses[m["step"]]) for m in hist)
    last = hist[-1]
    want = {k: v * steps for k, v in per_step.items()}
    if len(hist) != steps or err > tol or last["launches"] != want:
        raise AssertionError(f"gaps-off: losses {[m['loss'] for m in hist]}"
                             f" vs {run.losses} (tol {tol}), launches "
                             f"{last['launches']}")
    step_ms = statistics.median(m["s"] for m in hist[WARMUP_STEPS:]) * 1e3
    out = {"cold_start_ms": p["spawn_ms"], "errors": p["errors"],
           "loss_err": err, "step_ms": step_ms,
           "launches": last["launches"]}
    log(f"gaps-off ok: {len(GAPS_TOGGLES)} fast-path toggles off through "
        f"RAY_TPU_TORCH_* before init (no lease manager, no zygote, no "
        f"completion ring): the num_gpus=1 task's K1-K3 at [{B}, {L}, {H}, "
        f"{D}] bf16 causal = phase 2's errors bit for bit {p['errors']}; "
        f"the trainer's losses = phase 4's within {err:.3e} (tol "
        f"{tol:.1e}), launches {last['launches']} in {steps} steps")
    log(f"gaps-off GPU task cold start {p['spawn_ms']:.0f} ms off, "
        f"{on['spawn_ms']:.0f} ms on; step_ms {step_ms:.2f} off, "
        f"{on['step_ms']:.2f} on (21b before the kill), phase 4 "
        f"{run.step_ms:.2f} ms; card: {gpu_line()}")
    return out


def gaps_phase(tm, fa, run, spread, ktol, errors, frame16=None):
    """Phase 21: donation, the death push and the off-switches on the port's
    runtime (4 CPUs, the card's GPU). ``ktol``: phase 2's bf16 kernel
    tolerances; ``errors``: phase 2's errors at the training shape."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    tol = max(GANG_LOSS_ATOL, spread)
    out = {}
    rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    try:
        on = gaps_gpu_probe(rt, ktol, "on")
        if on["errors"] != errors:
            raise AssertionError(f"gaps-on: K1-K3 errors {on['errors']} vs "
                                 f"phase 2's {errors}")
        out["donation"] = gaps_donation(rt, frame16)
        gc_collect()
        out["death_push"] = gaps_death_push(rt, fa, run, tol)
    finally:
        rt.shutdown()
    gc_collect()
    out["off"] = gaps_off_switches(
        tm, fa, run, tol, ktol, errors,
        {"errors": on["errors"], "spawn_ms": on["spawn_ms"],
         "step_ms": out["death_push"]["step_ms_before"]})
    out["on_cold_start_ms"] = on["spawn_ms"]
    out["phase_s"] = time.perf_counter() - t0
    log(f"gaps phase ok in {out['phase_s']:.1f} s")
    log("gaps metrics: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 22: the runtime core's GPU paths on the card, twins of the
# reference's runtime-core tests: a GPU worker reused across tasks of one
# shape (test_worker_pool), a GPU generator retried after a kill
# (test_generators), lineage rebuild of a lost K1-K3 result and of a chain
# of GPU tasks with a chunked pull between nodes (test_refcount_lineage,
# test_chunked_pull), and CUDA frames spilled to disk (test_spilling).

CORE_GEN_SEEDS = (0, 1, 2, 3)
CORE_KILL_AFTER = 2            # yields of the generator's first attempt
CORE_REBUILD_TIMEOUT_S = 120.0
CORE_FRAMES = 6                # 13a's frame, seeds 13 .. 18
CORE_STORE_BYTES = 1 << 30
CORE_SPILL_WAIT_S = 60.0
CORE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def core_launches(fa):
    return {k.symbol.removeprefix("rtt_"): k.launches for k in fa.KERNELS}


def core_log_run(runs, what, fa, errors, **extra):
    """One line of a GPU task's facts, appended to the file ``runs``: its
    process, node and GPU, its K1-K3 errors against their plain versions
    and its kernels' launches since it began."""
    rec = {"what": what, "pid": os.getpid(),
           "node": os.environ.get("RAY_TPU_TORCH_NODE_ID", ""),
           "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "errors": errors, "launches": core_launches(fa), "t": time.time(),
           **extra}
    with open(runs, "a") as f:
        f.write(json.dumps(rec) + "\n")


def core_runs(runs):
    with open(runs) as f:
        return [json.loads(line) for line in f]


def core_same(name, got, want, exact, tol):
    """``got`` equals ``want``: bit for bit when the kernels are
    bit-deterministic run to run, else within ``tol``; the largest
    difference."""
    if not got.is_cuda or got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.device} {got.dtype} "
                             f"{tuple(got.shape)} vs {want.dtype} "
                             f"{tuple(want.shape)}")
    if exact:
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"{name}: not bit for bit")
        return 0.0
    return close(name, got, want, *tol)


def core_deterministic(fa):
    """Whether K1-K3 give the same bits twice on the same inputs at the
    training shape (the driver's own runs; comparisons, not counted)."""
    q, k, v, do = kernel_inputs(B * H, L, L, D, torch.bfloat16, 0)
    kw = dict(scale=D ** -0.5, causal=True)
    runs = []
    for _ in range(2):
        o, lse = fa.flash_forward(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        dq = fa.flash_backward_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, delta, **kw)
        runs.append([o, lse, dq, dk, dv])
    torch.cuda.synchronize()
    return all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(*runs))


def core_reuse(rt, ktol, errors):
    """22a: three ``num_gpus=1`` probes one after another (16a's task:
    K1-K3 against their plain versions at the training shape). The 2nd
    runs in the 1st's parked worker, on its GPU; the 3rd, with another
    spawn environment, in a fresh one."""
    probe = rt.remote(runtime_gpu_probe).options(num_gpus=1)
    marked = rt.remote(runtime_gpu_probe).options(
        num_gpus=1, runtime_env={"env_vars": {"MARK": "x"}})
    got = []
    for fn in (probe, probe, marked):
        got.append(rt.get(fn.remote(time.time(), ktol), timeout=300))
    cold, reused, fresh = got
    one = {k: 1 for k in CORE_KERNELS}
    for label, p in zip(("cold", "reused", "marked"), got):
        if p["launches"] != one or p["errors"] != errors or \
                p["device_count"] != 1:
            raise AssertionError(f"core-a {label}: {p}; phase 2's errors "
                                 f"{errors}")
    if reused["pid"] != cold["pid"] or reused["cuda_visible_devices"] != \
            cold["cuda_visible_devices"] or cold["cuda_visible_devices"] \
            is None:
        raise AssertionError(f"core-a: the 2nd probe ran in pid "
                             f"{reused['pid']} on {reused['cuda_visible_devices']}"
                             f", the 1st in {cold['pid']} on "
                             f"{cold['cuda_visible_devices']}")
    if fresh["pid"] in (cold["pid"], reused["pid"]) or fresh["mark"] != "x" \
            or cold["mark"] is not None:
        raise AssertionError(f"core-a: the env-marked probe ran in pid "
                             f"{fresh['pid']} (MARK {fresh['mark']!r}), the "
                             f"1st in {cold['pid']}")
    out = {"spawn_ms": {"cold": cold["spawn_ms"],
                        "reused": reused["spawn_ms"],
                        "marked": fresh["spawn_ms"]},
           "pids": [p["pid"] for p in got],
           "cuda_visible_devices": [p["cuda_visible_devices"] for p in got],
           "launches": {k: sum(p["launches"][k] for p in got)
                        for k in CORE_KERNELS}}
    log(f"core-a ok: worker reuse by GPU shape and spawn env: probe 1 pid "
        f"{cold['pid']} (CUDA_VISIBLE_DEVICES={cold['cuda_visible_devices']})"
        f" spawn_ms {cold['spawn_ms']:.1f} cold; probe 2 the same pid and "
        f"GPU, spawn_ms {reused['spawn_ms']:.1f} reused; probe 3 "
        f"(env MARK=x) pid {fresh['pid']}, spawn_ms {fresh['spawn_ms']:.1f}"
        f" cold; each probe's K1-K3 = phase 2's errors {errors}; card: "
        f"{gpu_line()}")
    return out


def core_generator(marker, seeds, ktol):
    """22b, a ``num_gpus=1`` dynamic generator: K1-K3 against their plain
    versions, then K1's (O, LSE) for each seed's inputs at the training
    shape, one yield each. Its first attempt (no ``marker`` yet) writes
    the marker and SIGKILLs its own process after ``CORE_KILL_AFTER``
    yields; the attempt that ends writes ``marker + ".done"``."""
    import signal

    from ray_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    errors = check_kernels(fa, B * H, L, L, D, torch.bfloat16, True, **ktol)
    first = not os.path.exists(marker)
    for i, seed in enumerate(seeds):
        q, k, v, _ = kernel_inputs(B * H, L, L, D, torch.bfloat16, seed)
        o, lse = fa.flash_forward(q, k, v, scale=D ** -0.5, causal=True)
        torch.cuda.synchronize()
        yield o, lse
        if first and i + 1 == CORE_KILL_AFTER:
            with open(marker, "w") as f:
                json.dump({"pid": os.getpid(), "killed_at": time.time()}, f)
            os.kill(os.getpid(), signal.SIGKILL)
    with open(marker + ".done", "w") as f:
        json.dump({"pid": os.getpid(), "last_yield_at": time.time(),
                   "errors": errors, "launches": core_launches(fa)}, f)


def core_generator_run(rt, fa, ktol, errors, exact):
    """22b: the generator's yields, before and after its first attempt's
    kill, against the driver's own K1 on the same inputs."""
    from ray_tpu_torch._private import worker as tworker

    marker = os.path.join(tworker._global_cluster.session_dir,
                          "core_generator_attempt")
    want = []
    for seed in CORE_GEN_SEEDS:
        q, k, v, _ = kernel_inputs(B * H, L, L, D, torch.bfloat16, seed)
        want.append(fa.flash_forward(q, k, v, scale=D ** -0.5, causal=True))
    gen = rt.remote(core_generator).options(
        num_gpus=1, num_returns="dynamic", max_retries=2)
    t0 = time.time()
    g = rt.get(gen.remote(marker, CORE_GEN_SEEDS, ktol), timeout=600)
    resolved = time.time()
    yields = rt.get(list(g), timeout=300)
    with open(marker) as f:
        kill = json.load(f)
    with open(marker + ".done") as f:
        done = json.load(f)
    if len(yields) != len(CORE_GEN_SEEDS) or done["pid"] == kill["pid"] or \
            done["errors"] != errors:
        raise AssertionError(f"core-b: {len(yields)} yields, killed pid "
                             f"{kill['pid']}, done {done}, phase 2's errors "
                             f"{errors}")
    worst = 0.0
    for i, ((o, lse), (wo, wlse)) in enumerate(zip(yields, want)):
        worst = max(worst,
                    core_same(f"core-b yield {i} O", o, wo, exact,
                              ktol["tol_out"]),
                    core_same(f"core-b yield {i} LSE", lse, wlse, exact,
                              ktol["tol_row"]))
    want_launches = {"flash_fwd": 1 + len(CORE_GEN_SEEDS), "flash_bwd_dq": 1,
                     "flash_bwd_dkv": 1}
    if done["launches"] != want_launches:
        raise AssertionError(f"core-b: the retried attempt's launches "
                             f"{done['launches']}, want {want_launches}")
    out = {"kill_to_last_yield_s": done["last_yield_at"] - kill["killed_at"],
           "kill_to_resolved_s": resolved - kill["killed_at"],
           "submit_to_resolved_s": resolved - t0,
           "max_abs_err": worst, "bit_for_bit": exact,
           "launches": done["launches"]}
    log(f"core-b ok: a num_gpus=1 dynamic generator of K1's (O, LSE) for "
        f"seeds {list(CORE_GEN_SEEDS)} at [{B * H}, {L}, {D}] bf16 causal "
        f"killed itself (pid {kill['pid']}) after {CORE_KILL_AFTER} yields "
        f"and was retried in pid {done['pid']}; its {len(yields)} yields = "
        f"the driver's K1 " + ("bit for bit" if exact else
                               f"within phase 2's tolerances ({worst:.3e})")
        + f"; kill -> last yield {out['kill_to_last_yield_s']:.2f} s, kill "
        f"-> generator resolved {out['kill_to_resolved_s']:.2f} s; card: "
        f"{gpu_line()}")
    return out


def core_checked(what, seed, ktol, runs, **extra):
    """In a 22c or 22d GPU task: K1-K3 for ``seed``'s inputs at the
    training shape, each held against its plain version on the same
    inputs (``check_kernels``' dataflow); the task's line goes to
    ``runs``. Returns the kernels' outputs."""
    from ray_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    outs = {}
    errors = check_kernels(fa, B * H, L, L, D, torch.bfloat16, True,
                           seed=seed, outputs=outs, **ktol)
    core_log_run(runs, what, fa, errors, **extra)
    return outs


def core_kernel_outputs(seed, ktol, runs):
    """22c, a ``num_gpus=1`` task: K1's O and K2-K3's dQ, dK and dV."""
    outs = core_checked("kernels", seed, ktol, runs)
    return outs["o"], outs["dq"], outs["dk"], outs["dv"]


def core_chain_base(seed, ktol, runs):
    """22c, the chain's first link (``num_gpus=1``): K1's O."""
    return core_checked("base", seed, ktol, runs)["o"]


def core_chain_double(x, ktol, runs):
    """22c, the chain's second link (``num_gpus=1``): 2x (exact in bf16)
    the first link's O, which arrives on this worker's GPU."""
    core_checked("double", 0, ktol, runs, arg_on_cuda=x.is_cuda)
    return x * 2


class StorePeak:
    """The largest ``used_bytes`` of a store, sampled every 2 ms on a
    thread while the block runs."""

    def __init__(self, store):
        import threading

        self.store, self.peak = store, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self.store.stats()["used_bytes"])
            self._stop.wait(0.002)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.store.stats()["used_bytes"])


def core_lineage(ktol, errors, exact):
    """22c: a head of {CPU 2, GPU 1} and a worker node of {CPU 2, GPU 1},
    both naming the card. A K1-K3 task and a two-link chain of GPU tasks
    pinned to the worker node; their results got on the head (a chunked
    pull at the default 5 MiB chunks); the head's pulled copies dropped
    from its store (as an eviction would drop them), so each result's one
    copy lives on the worker node; the node removed; each result got again
    within ``CORE_REBUILD_TIMEOUT_S``, rebuilt on the head's GPU from its
    lineage, equal to the first get."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker as tworker
    from ray_tpu_torch._private.config import config as tconfig
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 2, "num_gpus": 1})
    try:
        other = c.add_node(num_cpus=2, num_gpus=1)
        c.connect(log_to_driver=False)
        c.wait_for_nodes()
        head = c.nodes[0]
        runs = os.path.join(c.session_dir, "core_runs.jsonl")
        pin = dict(num_gpus=1, max_retries=2,
                   scheduling_strategy=NodeAffinitySchedulingStrategy(
                       node_id=other.node_id, soft=False))
        kern = rt.remote(core_kernel_outputs).options(num_returns=4, **pin)
        base = rt.remote(core_chain_base).options(**pin)
        double = rt.remote(core_chain_double).options(**pin)
        refs = list(kern.remote(7, ktol, runs))
        a = base.remote(8, ktol, runs)
        b = double.remote(a, ktol, runs)
        ready, _ = rt.wait(refs + [b], num_returns=len(refs) + 1,
                           timeout=600, fetch_local=False)
        if len(ready) != len(refs) + 1:
            raise AssertionError(f"core-c: {len(ready)} results ready")
        w = tworker.global_worker()
        with StorePeak(w.store) as peak:
            t0 = time.perf_counter()
            first = rt.get(refs, timeout=300)
            torch.cuda.synchronize()
            pull_s = time.perf_counter() - t0
        first_b = rt.get(b, timeout=300)
        pulled = sum(x.nbytes for x in first)
        before = core_runs(runs)
        for r in refs + [b]:
            if not w.store.delete(r.binary()):
                raise AssertionError("core-c: a pulled copy is still pinned")
        t_kill = time.time()
        c.remove_node(other)
        again = rt.get(refs, timeout=CORE_REBUILD_TIMEOUT_S)
        kernels_s = time.time() - t_kill
        again_b = rt.get(b, timeout=CORE_REBUILD_TIMEOUT_S)
        chain_s = time.time() - t_kill
        worst = 0.0
        for name, got, want in zip(("O", "dQ", "dK", "dV"), again, first):
            worst = max(worst, core_same(f"core-c rebuilt {name}", got, want,
                                         exact, ktol["tol_grad"]))
        worst = max(worst, core_same("core-c rebuilt chain", again_b,
                                     first_b, exact, ktol["tol_out"]))
        every = core_runs(runs)
    finally:
        rt.shutdown()
        c.shutdown()
    after = every[len(before):]
    where = {(r["what"], r["node"]) for r in every}
    want_where = {(what, node) for what in ("kernels", "base", "double")
                  for node in (other.node_id, head.node_id)}
    by_what = {}
    for r in every:
        by_what.setdefault(r["what"], []).append(r["errors"])
    # A rebuilt task's K1-K3 errors are its first run's (the same seed);
    # the second link checks seed 0's inputs, phase 2's.
    if len(before) != 3 or len(after) != 3 or where != want_where or \
            any(e[0] != e[1] for e in by_what.values()) or \
            by_what["double"][0] != errors or \
            not all(r.get("arg_on_cuda", True) for r in every):
        raise AssertionError(f"core-c: runs {every}; phase 2's errors "
                             f"{errors}")
    launches = {k: sum(r["launches"][k] for r in every)
                for k in CORE_KERNELS}
    chunk = int(tconfig.fetch_chunk_bytes)
    out = {"pull_bytes": pulled, "pull_s": pull_s,
           "pull_gb_per_s": pulled / pull_s / 1e9,
           "chunks_per_result": math.ceil(first[0].nbytes / chunk),
           "head_store_peak_bytes": peak.peak,
           "kill_to_kernels_s": kernels_s, "kill_to_chain_s": chain_s,
           "max_abs_err": worst, "bit_for_bit": exact,
           "launches": launches}
    log(f"core-c ok: K1-K3 on the worker node ({pulled} B in 4 results of "
        f"{first[0].nbytes} B, {out['chunks_per_result']} chunks of {chunk} "
        f"B each) pulled to the head in {pull_s:.3f} s "
        f"({out['pull_gb_per_s']:.2f} GB/s, rebuilt on cuda), head store "
        f"peak {peak.peak} B; the head's pulled copies dropped and the "
        f"worker node removed: the K1-K3 results rebuilt on the head's GPU "
        f"in {kernels_s:.2f} s and the base -> double chain (both links "
        f"lost) in {chain_s:.2f} s after the removal, " +
        ("bit for bit" if exact else f"within phase 2's tolerances "
                                     f"({worst:.3e})") +
        f" the first get; each GPU task's K1-K3 within phase 2's "
        f"tolerances of their plain versions, a rebuilt task's errors its "
        f"first run's; card: {gpu_line()}")
    return out


def core_checksum(frame, ktol, runs):
    """22d, a ``num_gpus=1`` task: the sum of a frame's bf16 bit patterns
    as int16 (exact, in int64); the frame arrives on this worker's GPU."""
    core_checked("checksum", 0, ktol, runs, arg_on_cuda=frame.is_cuda)
    return int(frame.view(torch.int16).sum(dtype=torch.int64))


def core_frame(seed):
    """13a's bf16 KV frame at llama-7b width, from ``seed``, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(KV_FRAME_SHAPE, generator=gen,
                       device="cuda").to(torch.bfloat16)


def core_spill(rt, ktol, errors):
    """22d, on a runtime ``rt`` whose store is 1 GiB: ``CORE_FRAMES`` of
    13a's frames, each from its own seed, put from the card into the
    store: the node manager spills them to disk; each comes back on the
    card through the store, bit for bit against the frame made again from
    its seed; a ``num_gpus=1`` task given a spilled one returns its
    checksum. The store's ``device_staged_bytes`` is charged once a put,
    and not again on a restore. The node manager's disk writes and reads
    are timed."""
    from ray_tpu_torch._private import device_objects as tdo
    from ray_tpu_torch._private import worker as tworker

    w, nm = tworker.global_worker(), tworker._global_cluster.nm
    st = nm.external_storage
    spill, restore = st.spill, st.restore
    try:
        runs = os.path.join(tworker._global_cluster.session_dir,
                            "core_runs.jsonl")
        disk = {"spill": [0, 0.0], "restore": [0, 0.0]}

        def timed_spill(oid, data):
            t0 = time.perf_counter()
            url = spill(oid, data)
            disk["spill"][0] += len(data)
            disk["spill"][1] += time.perf_counter() - t0
            return url

        def timed_restore(url):
            t0 = time.perf_counter()
            data = restore(url)
            disk["restore"][0] += len(data)
            disk["restore"][1] += time.perf_counter() - t0
            return data

        st.spill, st.restore = timed_spill, timed_restore
        staged0 = w.store.stats_ex()["device_staged_bytes"]
        refs, put_s = [], 0.0
        for i in range(CORE_FRAMES):
            frame = core_frame(13 + i)
            nbytes = frame.nbytes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refs.append(rt.put(frame))
            put_s += time.perf_counter() - t0
            # The driver's same-process registry holds a put tensor only
            # as long as the tensor lives: with it gone, a get reads the
            # store (restoring from disk what was spilled).
            del frame
        staged1 = w.store.stats_ex()["device_staged_bytes"]
        end = time.time() + CORE_SPILL_WAIT_S
        while not nm._spilled and time.time() < end:
            time.sleep(0.1)
        spilled_at_put = len(nm._spilled)
        if not spilled_at_put:
            raise AssertionError("core-d: nothing spilled")
        get_s = []
        hits = tdo.stats()["local_hits"]
        for i, ref in enumerate(refs):
            t0 = time.perf_counter()
            back = rt.get(ref, timeout=120)
            torch.cuda.synchronize()
            get_s.append(time.perf_counter() - t0)
            core_same(f"core-d frame {i}", back, core_frame(13 + i), True,
                      None)
            del back
        if tdo.stats()["local_hits"] != hits:
            raise AssertionError("core-d: a get was a same-process hit")
        staged2 = w.store.stats_ex()["device_staged_bytes"]
        # A frame with its header is more than a quarter of the store, so
        # the store holds at most 3 of the 6: after the gets at least 3
        # are out of it, each on disk.
        gone = [i for i, r in enumerate(refs) if r.binary() in nm._spilled
                and not w.store.contains(r.binary())]
        if not gone:
            raise AssertionError("core-d: no frame is spilled out of the "
                                 "store")
        pick = gone[0]
        want = int(core_frame(13 + pick).view(torch.int16).sum(
            dtype=torch.int64))
        task = rt.remote(core_checksum).options(num_gpus=1)
        got = rt.get(task.remote(refs[pick], ktol, runs), timeout=300)
        (run,) = core_runs(runs)
        del refs
    finally:
        st.spill, st.restore = spill, restore
    if got != want or run["errors"] != errors or not run["arg_on_cuda"]:
        raise AssertionError(f"core-d: checksum {got} vs {want}, task {run},"
                             f" phase 2's errors {errors}")
    if staged1 - staged0 != CORE_FRAMES * nbytes or staged2 != staged1:
        raise AssertionError(f"core-d: device_staged_bytes {staged0} -> "
                             f"{staged1} after the puts -> {staged2} after "
                             f"the restores; {CORE_FRAMES} x {nbytes} B put")
    total = CORE_FRAMES * nbytes
    out = {"frames": CORE_FRAMES, "frame_bytes": nbytes,
           "store_bytes": CORE_STORE_BYTES, "spilled_objects": spilled_at_put,
           "put_s": put_s, "put_gb_per_s": total / put_s / 1e9,
           "spilled_bytes": disk["spill"][0],
           "spill_gb_per_s": disk["spill"][0] / disk["spill"][1] / 1e9
           if disk["spill"][1] else None,
           "restored_bytes": disk["restore"][0],
           "restore_gb_per_s": disk["restore"][0] / disk["restore"][1] / 1e9
           if disk["restore"][1] else None,
           "get_gb_per_s": total / sum(get_s) / 1e9,
           "device_staged_bytes": [staged0, staged1, staged2],
           "checksum_frame": pick, "launches": run["launches"]}
    log(f"core-d ok: {CORE_FRAMES} bf16 frames of {nbytes} B put from "
        f"cuda:0 into a {CORE_STORE_BYTES} B store in {put_s:.2f} s "
        f"({out['put_gb_per_s']:.2f} GB/s); {spilled_at_put} spilled by "
        f"then; the node manager wrote {disk['spill'][0]} B to disk at "
        f"{out['spill_gb_per_s']} GB/s and read {disk['restore'][0]} B at "
        f"{out['restore_gb_per_s']} GB/s; every frame got back on cuda bit "
        f"for bit ({out['get_gb_per_s']:.2f} GB/s with restores); a "
        f"num_gpus=1 task given spilled frame {pick} returned its checksum "
        f"{got}; device_staged_bytes {staged0} -> {staged1} -> {staged2} "
        f"(charged once a put, not on a restore); card: {gpu_line()}")
    return out


def core_phase(fa, ktol, errors, keep=False):
    """Phase 22: the runtime core's GPU paths on the port's runtime. (c) on
    a two-node ``Cluster``, then (a), (b) and (d) on one runtime of 4 CPUs,
    the card's GPU and a 1 GiB store: (d)'s checksum task runs in the GPU
    worker (b)'s retry left warm. With ``keep`` that runtime stays up for
    phase 23's (a) and (b), whose burst runs in that worker too. ``ktol``:
    phase 2's bf16 kernel tolerances; ``errors``: phase 2's errors at the
    training shape."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    exact = core_deterministic(fa)
    log(f"core: K1-K3 at [{B * H}, {L}, {D}] bf16 causal are "
        + ("bit-deterministic run to run: results are compared bit for bit"
           if exact else "not bit-deterministic run to run: results are "
           "held to phase 2's tolerances"))
    out = {"bit_deterministic": exact}
    out["lineage"] = core_lineage(ktol, errors, exact)
    gc_collect()
    rt.init(num_cpus=RUNTIME_CPUS, object_store_memory=CORE_STORE_BYTES,
            log_to_driver=False)
    try:
        out["reuse"] = core_reuse(rt, ktol, errors)
        out["generator"] = core_generator_run(rt, fa, ktol, errors, exact)
        gc_collect()
        out["spill"] = core_spill(rt, ktol, errors)
    except BaseException:
        rt.shutdown()
        raise
    if not keep:
        rt.shutdown()
        gc_collect()
    out["launches"] = {k: sum(out[p]["launches"][k] for p in
                              ("reuse", "generator", "lineage", "spill"))
                       for k in CORE_KERNELS}
    out["phase_s"] = time.perf_counter() - t0
    log(f"core phase ok in {out['phase_s']:.1f} s; K1-K3 launches in its GPU"
        f" tasks {out['launches']}")
    log("core metrics: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 23: the fast paths and the failure paths with a GPU.

FAIL_BURST = 64                # 23a's tasks, seeds 0 .. 63
FAIL_TENSOR_SEED = 64          # 23a's task that returns CUDA tensors
FAIL_OOM_SEED = 65             # 23b's task
FAIL_PROBE_SEED = 66           # 23c's probe
FAIL_HEADROOM = 1 << 30        # 23b: the limit is the usage plus this
FAIL_BALLAST = 2 << 30         # 23b: host bytes of the first attempt
FAIL_OOM_TIMEOUT_S = 120.0
FAIL_STEPS = 2                 # 23c: steps before the kill and after it
FAIL_PENDING_S = 3.0           # 23c: the probe waits this long, pending
FAIL_REJOIN_TIMEOUT_S = 60.0


def failures_k1(seed):
    """K1's (O, LSE) for ``seed``'s inputs at the training shape (q, k, v
    of [B * H, L, D] bf16, causal)."""
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = kernel_inputs(B * H, L, L, D, torch.bfloat16, seed)
    return fa.flash_forward(q, k, v, scale=D ** -0.5, causal=True)


def failures_lse_sum(seed):
    """In a ``num_gpus=1`` task: K1 on ``seed``'s inputs, and the f64 sum
    of its LSE, with this process and its K1-K3 launches in the task."""
    from ray_tpu_torch.ops import flash_attention as fa

    before = core_launches(fa)
    _, lse = failures_k1(seed)
    total = lse.double().sum().item()
    after = core_launches(fa)
    return {"sum": total, "pid": os.getpid(),
            "launches": {k: after[k] - before[k] for k in after},
            "t": time.time()}


def failures_k1_tensors(seed):
    """In a ``num_gpus=1`` task: K1's (O, LSE) as CUDA tensors, and its
    K1-K3 launches in the task."""
    from ray_tpu_torch.ops import flash_attention as fa

    before = core_launches(fa)
    o, lse = failures_k1(seed)
    after = core_launches(fa)
    return o, lse, {k: after[k] - before[k] for k in after}


def failures_ballast(marker, seed):
    """23b, ``num_gpus=1, max_retries=1``: the first attempt (no ``marker``
    yet) writes the marker and holds ``FAIL_BALLAST`` bytes of host memory
    until the memory monitor kills its process; a later attempt runs
    ``failures_lse_sum``."""
    if not os.path.exists(marker):
        with open(marker, "w") as f:
            json.dump({"pid": os.getpid(), "t": time.time()}, f)
        ballast = np.ones(FAIL_BALLAST // 8, np.float64)
        time.sleep(FAIL_OOM_TIMEOUT_S)
        raise AssertionError(f"failures-b: {ballast.nbytes} bytes held and "
                             f"never killed")
    return failures_lse_sum(seed)


def failures_want(seeds):
    """The driver's own K1 LSE sums for ``seeds`` (comparisons, not
    counted)."""
    out = {}
    for seed in seeds:
        _, lse = failures_k1(seed)
        out[seed] = lse.double().sum().item()
    return out


def failures_burst(rt, nm, want):
    """23a: ``FAIL_BURST`` GPU tasks through the fast paths at their
    defaults, then one task whose result is CUDA tensors."""
    from ray_tpu_torch._private import worker as tworker

    w = tworker.global_worker()
    fn = rt.remote(failures_lse_sum).options(num_gpus=1)
    # The burst's worker, warm: its cold start is not the burst's rate.
    # The warm-up's ref stays held, so its inline entry stays counted.
    warm_ref = fn.remote(0)
    warm = rt.get(warm_ref, timeout=300)
    objects0 = w.store.stats()["num_objects"]
    inline0 = w.gcs.request("control_plane_stats")["inline_objects"]
    t0 = time.perf_counter()
    refs = [fn.remote(seed) for seed in range(FAIL_BURST)]
    got = rt.get(refs, timeout=300)
    burst_s = time.perf_counter() - t0
    objects1 = w.store.stats()["num_objects"]
    end = time.time() + 10
    while True:
        inline1 = w.gcs.request("control_plane_stats")["inline_objects"]
        if inline1 - inline0 >= FAIL_BURST or time.time() > end:
            break
        time.sleep(0.05)
    cached = sum(r.binary() in w._inline for r in refs)
    del warm_ref
    pids = sorted({g["pid"] for g in got} | {warm["pid"]})
    wrong = [s for s, g in zip(range(FAIL_BURST), got)
             if g["sum"] != want[s]]
    one = {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if len(pids) != 1 or wrong or any(g["launches"] != one for g in got):
        raise AssertionError(f"failures-a: pids {pids}, seeds off the "
                             f"driver's K1 {wrong}, launches "
                             f"{[g['launches'] for g in got][:3]}")
    if objects1 != objects0 or inline1 - inline0 < FAIL_BURST:
        raise AssertionError(f"failures-a: store objects {objects0} -> "
                             f"{objects1}, GCS inline entries {inline0} -> "
                             f"{inline1}")
    staged0 = w.store.stats_ex()["device_staged_bytes"]
    ref = rt.remote(failures_k1_tensors).options(num_gpus=1).remote(
        FAIL_TENSOR_SEED)
    o, lse, tensor_launches = rt.get(ref, timeout=300)
    staged1 = w.store.stats_ex()["device_staged_bytes"]
    wo, wlse = failures_k1(FAIL_TENSOR_SEED)
    core_same("failures-a O", o, wo, True, None)
    core_same("failures-a LSE", lse, wlse, True, None)
    nbytes = o.nbytes + lse.nbytes
    stored = w.store.contains(ref.binary())
    if not stored or ref.binary() in w._inline or \
            staged1 - staged0 != nbytes or tensor_launches != one:
        raise AssertionError(f"failures-a: the tensor result in the store "
                             f"{stored}, inline {ref.binary() in w._inline}, "
                             f"staged {staged1 - staged0} bytes of {nbytes}, "
                             f"launches {tensor_launches}")
    out = {"tasks_per_s": FAIL_BURST / burst_s, "burst_s": burst_s,
           "pid": pids[0], "inline_entries": inline1 - inline0,
           "driver_cached": cached, "store_objects": [objects0, objects1],
           "tensor_bytes": nbytes, "staged_bytes": staged1 - staged0,
           "launches": {k: sum(g["launches"][k] for g in got)
                        + warm["launches"][k] + tensor_launches[k]
                        for k in CORE_KERNELS}}
    log(f"failures-a ok: {FAIL_BURST} num_gpus=1 tasks (K1 at [{B * H}, {L}"
        f", {D}] bf16 causal, seeds 0-{FAIL_BURST - 1}) in one reused GPU "
        f"worker (pid {pids[0]}), every LSE sum = the driver's K1 bit for "
        f"bit; results inline ({inline1 - inline0} GCS inline entries, "
        f"{cached} in the driver's cache, store objects {objects0} -> "
        f"{objects1}); {out['tasks_per_s']:.1f} tasks/s over the burst "
        f"({burst_s:.3f} s); a task's CUDA (O, LSE) took the store path "
        f"({nbytes} bytes staged, no inline entry) and came back bit for "
        f"bit; card: {gpu_line()}")
    return out


def failures_oom(rt, nm, want):
    """23b: the memory monitor kills a GPU task's worker past a limit set
    from the node's usage with its warm GPU worker (23a's), and the task's
    retry runs K1 in a fresh one."""
    import threading

    from ray_tpu_torch._private import worker as tworker
    from ray_tpu_torch._private.config import config as tconfig

    w = tworker.global_worker()
    with nm._lock:
        workers = [x for x in nm._workers.values() if x.proc.poll() is None]
        gpu = [x for x in workers if x.gpu_ids]
    usage = sum(nm._proc_rss(x.proc.pid) for x in workers) + \
        w.store.stats().get("used_bytes", 0)
    gpu_rss = [nm._proc_rss(x.proc.pid) for x in gpu]
    threshold = float(tconfig.memory_usage_threshold)
    limit = int((usage + FAIL_HEADROOM) / threshold)
    kills0 = nm.oom_kills
    marker = os.path.join(tworker._global_cluster.session_dir,
                          "failures_oom_attempt")
    seen = {}

    def watch():
        end = time.time() + FAIL_OOM_TIMEOUT_S
        while time.time() < end and "stop" not in seen:
            if nm.oom_kills > kills0:
                seen["t"] = time.time()
                return
            time.sleep(0.01)

    th = threading.Thread(target=watch, daemon=True, name="failures-oom")
    th.start()
    tconfig.set("memory_limit_bytes", limit)
    try:
        got = rt.get(rt.remote(failures_ballast).options(
            num_gpus=1, max_retries=1).remote(marker, FAIL_OOM_SEED),
            timeout=FAIL_OOM_TIMEOUT_S + 60)
        t_result = time.time()
    finally:
        tconfig.set("memory_limit_bytes", 0)
        seen["stop"] = True
        th.join(5)
    with open(marker) as f:
        first = json.load(f)
    hw = nm._sample_hardware(None, None)
    if nm.oom_kills - kills0 != 1 or "t" not in seen or \
            got["pid"] == first["pid"] or got["sum"] != want[FAIL_OOM_SEED] \
            or hw["gpus_free"] != 1:
        raise AssertionError(f"failures-b: {nm.oom_kills - kills0} OOM "
                             f"kills, first attempt {first}, retry {got}, "
                             f"want sum {want[FAIL_OOM_SEED]}, gpus_free "
                             f"{hw['gpus_free']}")
    out = {"usage_bytes": usage, "gpu_worker_rss_bytes": gpu_rss,
           "limit_bytes": limit, "threshold": threshold,
           "kill_to_result_s": t_result - seen["t"],
           "alloc_to_kill_s": seen["t"] - first["t"],
           "gpus_free": hw["gpus_free"], "launches": got["launches"]}
    log(f"failures-b ok: the warm GPU worker's host RSS "
        f"{[r >> 20 for r in gpu_rss]} MiB (torch and the CUDA context), "
        f"node usage {usage >> 20} MiB; memory_limit_bytes {limit >> 20} "
        f"MiB (usage + {FAIL_HEADROOM >> 20} MiB at threshold {threshold});"
        f" a num_gpus=1, max_retries=1 task's first attempt (pid "
        f"{first['pid']}) held {FAIL_BALLAST >> 20} MiB and the monitor "
        f"killed it {out['alloc_to_kill_s']:.2f} s after it began (1 OOM "
        f"kill); the retry (pid {got['pid']}) = the driver's K1 bit for "
        f"bit, kill -> result {out['kill_to_result_s']:.2f} s; gpus_free "
        f"{hw['gpus_free']} after; card: {gpu_line()}")
    return out


class FailuresTrainer:
    """23c, a ``num_gpus=1`` actor: phase 4's train state (gpt2-125m from
    seed 0, AdamW, the seeded batch) on its card."""

    def __init__(self):
        from ray_tpu_torch import models as tm

        cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L,
                                  flash_attention=True)
        self.state = new_state(tm, cfg)
        self.step = tm.make_train_step(cfg)
        self.batch = train_batch(cfg.vocab_size)

    def steps(self, n):
        from ray_tpu_torch.ops import flash_attention as fa

        before = core_launches(fa)
        losses = []
        for _ in range(n):
            self.state, metrics = self.step(self.state, self.batch)
            losses.append(metrics["loss"].item())
        after = core_launches(fa)
        return {"losses": losses, "pid": os.getpid(), "t": time.time(),
                "launches": {k: after[k] - before[k] for k in after}}


def failures_gcs(run, want):
    """23c: a GCS subprocess with durable storage and one node {CPU 2,
    GPU 1}; the GCS SIGKILLed and restarted on its port and storage under
    a ``num_gpus=1`` actor that trains."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.gcs_launcher import GcsProcess
    from ray_tpu_torch._private.node_manager import NodeManager

    with tempfile.TemporaryDirectory(
            dir=os.path.abspath("chiprun_out")) as tmp:
        storage = os.path.join(tmp, "gcs.db")
        session = os.path.join(tmp, "session")
        box = {"gcs": GcsProcess(session_dir=session,
                                 storage_path=storage)}
        nm = NodeManager(gcs_address=box["gcs"].address, session_dir=session,
                         num_cpus=2, num_gpus=1,
                         object_store_memory=256 << 20, is_head=True,
                         node_name="head")
        try:
            rt.init(address=box["gcs"].address, log_to_driver=False)
            try:
                return failures_gcs_run(rt, box, nm, session, storage, run,
                                        want)
            finally:
                rt.shutdown()
        finally:
            nm.shutdown()
            box["gcs"].terminate()


def failures_gcs_run(rt, box, nm, session, storage, run, want):
    """23c's steps, kill and restart; ``box["gcs"]`` is the live GCS."""
    import signal

    from ray_tpu_torch._private.gcs_launcher import GcsProcess

    gcs = box["gcs"]
    actor = rt.remote(FailuresTrainer).options(num_gpus=1).remote()
    before = rt.get(actor.steps.remote(FAIL_STEPS), timeout=600)
    port = int(gcs.address.rsplit(":", 1)[1])
    old_conn = nm.gcs
    t_kill = time.time()
    os.kill(gcs.pid, signal.SIGKILL)
    gcs.proc.wait(timeout=30)
    box["gcs"] = GcsProcess(session_dir=session, port=port,
                            storage_path=storage)
    while nm.gcs is old_conn:
        if time.time() - t_kill > FAIL_REJOIN_TIMEOUT_S:
            raise AssertionError("failures-c: the node never rejoined")
        time.sleep(0.01)
    t_rejoin = time.time()
    after = rt.get(actor.steps.remote(FAIL_STEPS), timeout=600)
    avail = rt.available_resources().get("GPU", 0.0)
    total = rt.cluster_resources().get("GPU", 0.0)
    probe = rt.remote(failures_lse_sum).options(num_gpus=1).remote(
        FAIL_PROBE_SEED)
    ready, _ = rt.wait([probe], timeout=FAIL_PENDING_S)
    losses = before["losses"] + after["losses"]
    rt.kill(actor)
    got = rt.get(probe, timeout=300)
    per_step = {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
    want_launches = {k: v * FAIL_STEPS for k, v in per_step.items()}
    exact = losses == run.losses[:2 * FAIL_STEPS]
    err = max(abs(a - b) for a, b in zip(losses, run.losses))
    if err > GANG_LOSS_ATOL or before["pid"] != after["pid"] or \
            before["launches"] != want_launches or \
            after["launches"] != want_launches:
        raise AssertionError(f"failures-c: losses {losses} vs phase 4's "
                             f"{run.losses[:2 * FAIL_STEPS]}, pids "
                             f"{before['pid']} {after['pid']}, launches "
                             f"{before['launches']} {after['launches']}")
    if avail != 0.0 or total != 1.0 or ready or \
            got["sum"] != want[FAIL_PROBE_SEED]:
        raise AssertionError(f"failures-c: after the rejoin GPU available "
                             f"{avail} of {total}; the probe ready while "
                             f"the actor lived {bool(ready)}; its sum "
                             f"{got['sum']} vs {want[FAIL_PROBE_SEED]}")
    out = {"kill_to_rejoin_s": t_rejoin - t_kill,
           "kill_to_next_step_s": after["t"] - t_kill,
           "losses": losses, "bit_for_bit": exact, "loss_err": err,
           "launches": {k: before["launches"][k] + after["launches"][k]
                        + got["launches"][k] for k in CORE_KERNELS}}
    log(f"failures-c ok: a num_gpus=1 actor (pid {before['pid']}) holding "
        f"phase 4's train state took {FAIL_STEPS} steps, the GCS subprocess"
        f" was SIGKILLed and restarted on its port and storage, the node "
        f"rejoined {out['kill_to_rejoin_s']:.2f} s after the kill and the "
        f"actor's next {FAIL_STEPS} steps ended "
        f"{out['kill_to_next_step_s']:.2f} s after it; its 4 losses = phase "
        f"4's first 4 " + ("bit for bit" if exact else f"within {err:.3e}")
        + f"; after the rejoin the GCS held the GPU (available {avail} of "
        f"{total}), a num_gpus=1 probe stayed pending {FAIL_PENDING_S} s "
        f"while the actor lived, then ran K1 = the driver's bit for bit; "
        f"24/12/12 launches a step in the actor; card: {gpu_line()}")
    return out


def failures_phase(fa, run, shared=False):
    """Phase 23: a GPU task burst through the fast paths and an OOM-killed
    GPU task on one runtime at its defaults (4 CPUs, the card's GPU; with
    ``shared``, phase 22's, still up), then a GCS SIGKILL under a GPU actor
    on a split cluster."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker as tworker

    t0 = time.perf_counter()
    want = failures_want(list(range(FAIL_BURST))
                         + [FAIL_OOM_SEED, FAIL_PROBE_SEED])
    out = {}
    if not shared:
        rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    try:
        nm = tworker._global_cluster.nm
        out["burst"] = failures_burst(rt, nm, want)
        out["oom"] = failures_oom(rt, nm, want)
    finally:
        rt.shutdown()
    gc_collect()
    out["gcs"] = failures_gcs(run, want)
    gc_collect()
    out["launches"] = {k: sum(out[p]["launches"][k] for p in
                              ("burst", "oom", "gcs"))
                       for k in CORE_KERNELS}
    if not all(out["launches"].values()):
        raise AssertionError(f"failures: launches {out['launches']}")
    out["phase_s"] = time.perf_counter() - t0
    log(f"failures phase ok in {out['phase_s']:.1f} s; K1-K3 launches in "
        f"its GPU tasks and actor {out['launches']}")
    log("failures metrics: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 24: observability and runtime envs with a GPU worker.

OBS_SEED = 24                  # K1's input seed at phase 23's shape
OBS_PROFILE_S = 2.0            # 24b's profile window
OBS_PROFILE_HZ = 250           # its sampling rate (the default is ~67 Hz)
OBS_STEP_MAX_S = 60.0          # 24b's stepping, until the driver's stop
OBS_LOOP_MAX_S = 60.0          # 24d's K1 loop, until the SIGKILL
OBS_WAIT_S = 30.0              # every poll of this phase
OBS_TIMEOUT_S = 300.0          # every get (a GPU worker's cold start)
OBS_MARKER = "OBS_GPU_MARKER"
OBS_COUNTER = "obs_gpu_task_total"
OBS_WHEEL = ("obswheel", "0.2.4")
OBS_ENV_VAR = ("OBS_ENV_FLAG", "on")
OBS_DATA = "phase-24 working dir"
OBS_MODULE = '''\
"""Phase 24e's py_module: the port's K1 on given inputs."""


def lse_sum(q, k, v, scale):
    from ray_tpu_torch.ops import flash_attention as fa

    _, lse = fa.flash_forward(q, k, v, scale=scale, causal=True)
    return lse.double().sum().item()
'''


class ObsPing:
    """24a's CPU actor: the hop after the GPU task."""

    def ping(self, x):
        return {"pid": os.getpid(), "x": x}


def obs_wait(cond, what, timeout=OBS_WAIT_S):
    end = time.time() + timeout
    while time.time() < end:
        got = cond()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"observability: timed out waiting for {what}")


def obs_gpu_hop(seed, actor):
    """24a/c, in a ``num_gpus=1`` task: K1 on ``seed``'s inputs timed by
    CUDA events, the f64 sum of its LSE, a call of ``actor``; prints the
    marker with the card's name and adds 3 to a user counter."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.util import metrics

    before = core_launches(fa)
    q, k, v, _ = kernel_inputs(B * H, L, L, D, torch.bfloat16, seed)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, lse = fa.flash_forward(q, k, v, scale=D ** -0.5, causal=True)
    end.record()
    torch.cuda.synchronize()
    total = lse.double().sum().item()
    after = core_launches(fa)
    pong = rt.get(actor.ping.remote(seed), timeout=60)
    print(f"{OBS_MARKER} {torch.cuda.get_device_name()}", flush=True)
    metrics.Counter(OBS_COUNTER, "phase 24's GPU task").inc(3)
    reported = metrics.report_to_gcs()
    return {"sum": total, "k1_ms": start.elapsed_time(end),
            "pid": os.getpid(), "actor_pid": pong["pid"],
            "reported": reported,
            "launches": {k: after[k] - before[k] for k in after}}


def obs_train(marker, stop):
    """24b, in the GPU worker: phase 4's train state and steps on phase
    4's batch; after the first 7 its pid goes to ``marker``, and it steps
    on until ``stop`` exists. Returns the first 7 losses, every step's
    (start, end) and the flash launches."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    state = new_state(tm, cfg)
    step = tm.make_train_step(cfg)
    batch = train_batch(cfg.vocab_size)
    first = WARMUP_STEPS + TIMED_STEPS
    before = core_launches(fa)
    losses, steps = [], []
    end = time.time() + OBS_STEP_MAX_S
    while True:
        t0 = time.time()
        state, out = step(state, batch)
        loss = out["loss"].item()   # waits for the step
        steps.append((t0, time.time()))
        if len(losses) < first:
            losses.append(loss)
        if len(steps) == first:
            with open(marker + ".tmp", "w") as f:
                f.write(str(os.getpid()))
            os.replace(marker + ".tmp", marker)
        if len(steps) >= first and os.path.exists(stop) or \
                time.time() > end:
            break
    after = core_launches(fa)
    return {"losses": losses, "steps": steps, "pid": os.getpid(),
            "launches": {k: after[k] - before[k] for k in after}}


def obs_k1_loop(marker, seed):
    """24d, in the GPU worker: K1 on ``seed``'s inputs in a loop, its pid
    in ``marker`` after the first; the driver SIGKILLs it."""
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = kernel_inputs(B * H, L, L, D, torch.bfloat16, seed)
    end = time.time() + OBS_LOOP_MAX_S
    n = 0
    while time.time() < end:
        fa.flash_forward(q, k, v, scale=D ** -0.5, causal=True)
        torch.cuda.synchronize()
        n += 1
        if n == 1:
            with open(marker + ".tmp", "w") as f:
                f.write(str(os.getpid()))
            os.replace(marker + ".tmp", marker)
    raise AssertionError(f"observability-d: {n} K1 loops and never killed")


def obs_env_task(seed):
    """24e, in a ``num_gpus=1`` task with a runtime env: what the env set
    up, and K1's LSE sum through the env's py_module."""
    import obsk1
    import obswheel
    from ray_tpu_torch.ops import flash_attention as fa

    before = core_launches(fa)
    q, k, v, _ = kernel_inputs(B * H, L, L, D, torch.bfloat16, seed)
    total = obsk1.lse_sum(q, k, v, D ** -0.5)
    after = core_launches(fa)
    with open("obs_data.txt") as f:
        data = f.read()
    return {"sum": total, "pid": os.getpid(), "cwd": os.getcwd(),
            "data": data, "flag": os.environ.get(OBS_ENV_VAR[0]),
            "wheel": obswheel.__version__, "wheel_file": obswheel.__file__,
            "module_file": obsk1.__file__,
            "venv": os.environ.get("VIRTUAL_ENV"),
            "cuda": torch.cuda.is_available(),
            "devices": torch.cuda.device_count(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "launches": {k: after[k] - before[k] for k in after}}


def obs_wheel(where):
    """A minimal pure-python wheel, installable offline (the reference's
    ``_make_wheel``)."""
    import zipfile

    name, version = OBS_WHEEL
    whl = os.path.join(where, f"{name}-{version}-py3-none-any.whl")
    dist = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(whl, "w") as zf:
        zf.writestr(f"{name}/__init__.py", f"__version__ = {version!r}\n")
        zf.writestr(f"{dist}/METADATA", f"Metadata-Version: 2.1\nName: "
                    f"{name}\nVersion: {version}\n")
        zf.writestr(f"{dist}/WHEEL", "Wheel-Version: 1.0\nGenerator: "
                    "chip_smoke\nRoot-Is-Purelib: true\nTag: py3-none-any\n")
        zf.writestr(f"{dist}/RECORD", "")
    return whl


def obs_gpu_metrics(port):
    """``(gpus_total, gpus_free)`` of the node on ``/metrics``."""
    text = _http(port, "/metrics", timeout=30)
    got = {}
    for name in ("gpus_total", "gpus_free"):
        m = re.search(rf"^ray_tpu_node_{name}(?:{{[^}}]*}})? (\S+)$", text,
                      re.M)
        got[name] = float(m.group(1)) if m else None
    return got["gpus_total"], got["gpus_free"]


def obs_hw(rt):
    hw = rt.nodes()[0].get("Hardware") or {}
    return hw.get("gpus_total"), hw.get("gpus_free")


class ObsTee:
    """The driver's stdout, with the lines written to it kept."""

    def __init__(self, stream):
        self.stream, self.text = stream, []

    def write(self, s):
        self.text.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def obs_trace(rt, want):
    """24a, and 24c's marker on the driver's stdout."""
    from ray_tpu_torch.scripts.cli import build_chrome_trace
    from ray_tpu_torch.util import tracing

    actor = rt.remote(ObsPing).remote()
    hop = rt.remote(obs_gpu_hop).options(num_gpus=1)
    tee = ObsTee(sys.stdout)
    sys.stdout = tee
    try:
        t0 = time.perf_counter()
        with tracing.span("obs_root", kind="obs") as root_sid:
            got = rt.get(hop.remote(OBS_SEED, actor), timeout=OBS_TIMEOUT_S)
        cold_s = time.perf_counter() - t0
        tracing.flush_spans()

        def spans():
            evs = rt.timeline()
            root = [e for e in evs if e.get("span_id") == root_sid]
            if not root:
                return None
            mine = [e for e in evs
                    if e.get("trace_id") == root[0]["trace_id"]]
            got = {n: [e for e in mine if e.get("name") == n]
                   for n in ("obs_root", "obs_gpu_hop", "ping")}
            if all(got.values()):
                return {n: (v[0] if len(v) == 1 else None)
                        for n, v in got.items()}
            return None

        evs = obs_wait(spans, "the three spans of 24a")
        line = obs_wait(lambda: next(
            (ln for ln in "".join(tee.text).splitlines()
             if OBS_MARKER in ln), None), "the marker on the driver")
    finally:
        sys.stdout = tee.stream
    if None in evs.values():
        raise AssertionError(f"observability-a: more than one span of a "
                             f"name in the root's trace: {evs}")
    root, task, call = evs["obs_root"], evs["obs_gpu_hop"], evs["ping"]
    chrome = build_chrome_trace([root, task, call])
    flows = sorted((t["ph"], t["id"]) for t in chrome if t["ph"] in "sf")
    linked = {task["span_id"], call["span_id"]}
    span_s = task["end"] - task["start"]
    name = torch.cuda.get_device_name(0)
    problems = []
    if len({root["trace_id"], task["trace_id"], call["trace_id"]}) != 1 or \
            task["parent_span_id"] != root["span_id"] or \
            call["parent_span_id"] != task["span_id"] or \
            root["parent_span_id"] is not None:
        problems.append(f"trace {[(e['trace_id'], e['span_id'], e['parent_span_id']) for e in (root, task, call)]}")
    if len(flows) != 4 or {i for _, i in flows} != linked:
        problems.append(f"chrome flows {flows}")
    if span_s < got["k1_ms"] / 1e3:
        problems.append(f"task span {span_s:.6f} s < K1 {got['k1_ms']} ms")
    if got["sum"] != want[OBS_SEED] or got["actor_pid"] == got["pid"]:
        problems.append(f"LSE sum {got['sum']} vs {want[OBS_SEED]}")
    prefix = re.match(r"\((\w+) pid=(\d+) node=\w+\) " + OBS_MARKER, line)
    if not prefix or int(prefix.group(2)) != got["pid"] or name not in line:
        problems.append(f"marker line {line!r}")
    if problems:
        raise AssertionError("observability-a: " + "; ".join(problems))
    out = {"gpu_pid": got["pid"], "cold_s": cold_s, "k1_ms": got["k1_ms"],
           "task_span_s": span_s, "worker_id": prefix.group(1),
           "launches": got["launches"], "line": line,
           "reported": got["reported"]}
    log(f"observability-a ok: one trace over the driver's span, the "
        f"num_gpus=1 task (pid {got['pid']}) and the CPU actor's method "
        f"(pid {got['actor_pid']}), parented in that order, 2 chrome flow "
        f"pairs; the task's span {span_s * 1e3:.2f} ms >= its K1 "
        f"{got['k1_ms']:.4f} ms by CUDA events; LSE sum = the driver's K1 "
        f"bit for bit; the first GPU task took {cold_s:.2f} s (cold start)")
    return out


def obs_logs(trace, port):
    """24c: the marker through ``get_log(follow=True)``, the counter on
    ``/metrics``."""
    from ray_tpu_torch.experimental import state

    name, line = torch.cuda.get_device_name(0), trace["line"]
    gen = state.get_log(ident=trace["worker_id"], stream="stdout",
                        follow=True, interval_s=0.25)
    followed = False
    end = time.time() + OBS_WAIT_S
    try:
        for entry in gen:
            if any(OBS_MARKER in ln and name in ln
                   for ln in entry.get("lines") or []):
                followed = True
            if followed or time.time() > end:
                break
    finally:
        gen.close()
    counted = f"{OBS_COUNTER} 3.0" in _http(port, "/metrics", timeout=30)
    if not followed or not trace["reported"] or not counted:
        raise AssertionError(f"observability-c: followed {followed}, "
                             f"counter reported {trace['reported']}, 3.0 on "
                             f"/metrics {counted}")
    log(f"observability-c logs ok: {line.strip()!r} on the driver's stdout "
        f"and in get_log(follow=True); {OBS_COUNTER} 3.0 on /metrics")


def obs_profile(rt, run, spread, port, gpu_pid, tmp, ref, trace):
    """24b, with 24c's GPU gauges while the step holds the GPU: ``ref`` is
    ``obs_train``'s task, stepping in ``tmp``; 24c's logs are read while
    it builds its state."""
    from ray_tpu_torch.experimental import state

    tol = max(GANG_LOSS_ATOL, spread)
    marker, stop = os.path.join(tmp, "stepping"), os.path.join(tmp, "stop")
    obs_logs(trace, port)
    obs_wait(lambda: os.path.exists(marker), "24b's first 7 steps",
             OBS_TIMEOUT_S)
    t_on = time.time()
    processes = state.profile(duration_s=OBS_PROFILE_S, hz=OBS_PROFILE_HZ)
    t_off = time.time()
    held_hw = obs_wait(lambda: obs_hw(rt) == (1, 0) and obs_hw(rt),
                       "gpus_free 0 in the hardware sample")
    held_metrics = obs_wait(
        lambda: obs_gpu_metrics(port) == (1.0, 0.0) and
        obs_gpu_metrics(port), "gpus_free 0 on /metrics")
    with open(stop, "w"):
        pass
    got = rt.get(ref, timeout=OBS_TIMEOUT_S)
    freed_hw = obs_wait(lambda: obs_hw(rt) == (1, 1) and obs_hw(rt),
                        "gpus_free 1 in the hardware sample")
    freed_metrics = obs_wait(
        lambda: obs_gpu_metrics(port) == (1.0, 1.0) and
        obs_gpu_metrics(port), "gpus_free 1 on /metrics")
    kinds = {p.get("kind") for p in processes if not p.get("error")}
    mine = [p for p in processes if p.get("pid") == got["pid"]
            and not p.get("error")]
    stacks = [s for p in mine for s in p.get("stacks") or {}]
    flash = [s for s in stacks if "ops/flash_attention.py" in s]
    attention = [s for s in stacks if "_attention (models/transformer.py"
                 in s]
    samples = sum(p.get("samples", 0) for p in mine)
    err = max(abs(a - b) for a, b in zip(got["losses"], run.losses))
    steps = got["steps"]
    on = [b - a for a, b in steps[WARMUP_STEPS:] if a >= t_on and b <= t_off]
    off = [b - a for a, b in steps[WARMUP_STEPS:] if b <= t_on or a >= t_off]
    problems = []
    if not {"gcs", "node_manager", "driver", "worker"} <= kinds:
        problems.append(f"process kinds {kinds}")
    if got["pid"] != gpu_pid or not flash or not attention:
        problems.append(f"GPU worker pid {got['pid']} (24a's {gpu_pid}), "
                        f"{len(stacks)} stacks, {len(flash)} with the "
                        f"flash Function, {len(attention)} with _attention")
    if len(got["losses"]) != len(run.losses) or err > tol:
        problems.append(f"losses {got['losses']} vs phase 4's "
                        f"{run.losses} (tol {tol})")
    if not on or not off:
        problems.append(f"{len(on)} steps in the window, {len(off)} out")
    if problems:
        raise AssertionError("observability-b: " + "; ".join(problems))
    out = {"samples": samples, "stacks": len(stacks),
           "flash_stacks": len(flash), "attention_stacks": len(attention),
           "kinds": sorted(kinds), "processes": len(processes),
           "loss_err": err, "tol": tol, "steps": len(steps),
           "step_ms_on": statistics.median(on) * 1e3,
           "step_ms_off": statistics.median(off) * 1e3,
           "steps_on": len(on), "steps_off": len(off),
           "gpus_held": [held_hw, held_metrics],
           "gpus_after": [freed_hw, freed_metrics],
           "launches": got["launches"]}
    log(f"observability-b ok: a {OBS_PROFILE_S} s profile at "
        f"{OBS_PROFILE_HZ} Hz over {len(processes)} processes ({sorted(kinds)}"
        f"); the GPU worker (pid {got['pid']}, 24a's) gave {samples} "
        f"samples, {len(flash)} of its {len(stacks)} stacks through the "
        f"flash autograd.Function, {len(attention)} through _attention; "
        f"gpt2-125m losses = phase 4's within {err:.3e} (tol {tol:.1e}); "
        f"step {out['step_ms_on']:.2f} ms with the window on ({len(on)} "
        f"steps), {out['step_ms_off']:.2f} ms off ({len(off)}); launches "
        f"{got['launches']} in {len(steps)} steps")
    log(f"observability-c gauges ok: gpus (total, free) {held_hw} in the "
        f"hardware sample and {held_metrics} on /metrics while the step "
        f"held the GPU, {freed_hw} and {freed_metrics} after")
    return out


def obs_flight(rt, port, gpu_pid):
    """24d."""
    import glob
    import signal

    from ray_tpu_torch._private import worker as tworker

    flight = os.path.join(tworker._global_cluster.session_dir,
                          "flight_recorder")
    before = set(glob.glob(os.path.join(flight, "flight-*.json")))
    with tempfile.TemporaryDirectory() as tmp:
        marker = os.path.join(tmp, "looping")
        ref = rt.remote(obs_k1_loop).options(
            num_gpus=1, max_retries=0).remote(marker, OBS_SEED)
        obs_wait(lambda: os.path.exists(marker), "24d's K1 loop",
                 OBS_TIMEOUT_S)
        with open(marker) as f:
            pid = int(f.read())
        t_kill = time.time()
        os.kill(pid, signal.SIGKILL)
        dumps = obs_wait(lambda: sorted(set(glob.glob(os.path.join(
            flight, "flight-*.json"))) - before), "a flight dump")
        dump_s = time.time() - t_kill
    err = None
    try:
        rt.get(ref, timeout=OBS_TIMEOUT_S)
    except Exception as e:
        err = type(e).__name__
    events = []
    for path in dumps:
        with open(path) as f:
            events += json.load(f)["events"]
    mine = [e for e in events if e.get("pid") == pid
            and e.get("kind") in ("task", "actor_task")]
    hw = [e for e in events if e.get("kind") == "hw_sample"]
    freed = obs_wait(lambda: obs_hw(rt) == (1, 1) and obs_hw(rt),
                     "gpus_free 1 after the kill")
    freed_metrics = obs_wait(
        lambda: obs_gpu_metrics(port) == (1.0, 1.0) and
        obs_gpu_metrics(port), "gpus_free 1 on /metrics after the kill")
    if pid != gpu_pid or err is None or not mine or not hw:
        raise AssertionError(f"observability-d: killed pid {pid} (24a's "
                             f"{gpu_pid}), get raised {err}, {len(mine)} of "
                             f"its task events and {len(hw)} hw samples in "
                             f"{len(dumps)} dumps")
    out = {"dump_s": dump_s, "dumps": len(dumps), "task_events": len(mine),
           "hw_samples": len(hw), "error": err, "gpus": [freed,
                                                        freed_metrics]}
    log(f"observability-d ok: the GPU worker (pid {pid}) SIGKILLed in its "
        f"K1 loop; {len(dumps)} flight dump(s) {dump_s:.3f} s after the "
        f"kill, holding {len(mine)} of its task events and {len(hw)} "
        f"hw_sample events; its get raised {err}; gpus (total, free) "
        f"{freed} after: the GPU freed once")
    return out


def obs_pip_env(tmp):
    """24e's ``pip`` entry: the wheel built in ``tmp``, installed with no
    index and no version check (nothing is fetched)."""
    return {"packages": [obs_wheel(tmp)],
            "pip_install_options": ["--no-index",
                                    "--disable-pip-version-check"]}


def obs_venv():
    """A CPU task in 24e's pip env: its venv, built while 24a-d run."""
    return os.environ.get("VIRTUAL_ENV")


def obs_runtime_env(rt, want, gpu_pid, tmp, pip):
    """24e: its env is ``tmp``'s working dir and module and ``pip``."""
    wd = os.path.join(tmp, "workdir")
    mod = os.path.join(tmp, "obsk1")
    os.makedirs(wd)
    os.makedirs(mod)
    with open(os.path.join(wd, "obs_data.txt"), "w") as f:
        f.write(OBS_DATA)
    with open(os.path.join(mod, "__init__.py"), "w") as f:
        f.write(OBS_MODULE)
    env = {"working_dir": wd, "py_modules": [mod],
           "env_vars": dict([OBS_ENV_VAR]), "pip": pip}
    t0 = time.perf_counter()
    got = rt.get(rt.remote(obs_env_task).options(
        num_gpus=1, runtime_env=env).remote(OBS_SEED),
        timeout=OBS_TIMEOUT_S)
    cold_s = time.perf_counter() - t0
    venv = got["venv"] or ""
    problems = []
    if got["data"] != OBS_DATA or os.path.realpath(got["cwd"]) == \
            os.path.realpath(os.getcwd()):
        problems.append(f"cwd {got['cwd']}, data {got['data']!r}")
    if got["flag"] != OBS_ENV_VAR[1] or got["wheel"] != OBS_WHEEL[1]:
        problems.append(f"env var {got['flag']}, wheel {got['wheel']}")
    if not venv or not got["wheel_file"].startswith(venv) or \
            got["pid"] == gpu_pid:
        problems.append(f"venv {venv}, wheel at {got['wheel_file']}, pid "
                        f"{got['pid']} (24a-d's {gpu_pid})")
    if not got["cuda"] or got["devices"] != 1 or \
            not got["cuda_visible_devices"]:
        problems.append(f"CUDA {got['cuda']}, {got['devices']} devices, "
                        f"CUDA_VISIBLE_DEVICES {got['cuda_visible_devices']}")
    if got["sum"] != want[OBS_SEED]:
        problems.append(f"LSE sum {got['sum']} vs {want[OBS_SEED]}")
    if problems:
        raise AssertionError("observability-e: " + "; ".join(problems))
    out = {"cold_s": cold_s, "pid": got["pid"], "venv": venv,
           "launches": got["launches"]}
    log(f"observability-e ok: a num_gpus=1 task with working_dir, "
        f"py_modules (obsk1 -> K1), env_vars and pip ({OBS_WHEEL[0]} "
        f"{OBS_WHEEL[1]} from a local wheel) ran in a new process (pid "
        f"{got['pid']}) in the env's venv, CUDA_VISIBLE_DEVICES="
        f"{got['cuda_visible_devices']}; LSE sum = the driver's K1 bit for "
        f"bit; {cold_s:.2f} s from submit to result (a cold start; the "
        f"venv was built beside 24a-d)")
    return out


def observability_phase(fa, run, spread, keep=False):
    """Phase 24: tracing, the profiler, logs, metrics, the flight recorder
    and runtime envs with a GPU worker, on one runtime {CPU 2, GPU 1},
    which stays up for phase 25's Ape-X with ``keep``."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dashboard import start_dashboard

    import threading

    t0 = time.perf_counter()
    want = failures_want([OBS_SEED])
    out = {}
    rt.init(num_cpus=2, num_gpus=1, log_to_driver=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # Beside 24a's cold start: the dashboard, and 24e's venv,
            # built by a CPU task in its pip env.
            dash = {}
            started = threading.Thread(target=lambda: dash.update(
                port=start_dashboard(port=free_port())[1]))
            started.start()
            pip = obs_pip_env(tmp)
            venv_ref = rt.remote(obs_venv).options(
                runtime_env={"pip": pip}).remote()
            out["trace"] = obs_trace(rt, want)
            gpu_pid = out["trace"]["gpu_pid"]
            stepping = os.path.join(tmp, "steps")
            os.makedirs(stepping)
            ref = rt.remote(obs_train).options(num_gpus=1).remote(
                os.path.join(stepping, "stepping"),
                os.path.join(stepping, "stop"))
            started.join(timeout=OBS_TIMEOUT_S)
            port = dash["port"]
            out["profile"] = obs_profile(rt, run, spread, port, gpu_pid,
                                         stepping, ref, out["trace"])
            out["flight"] = obs_flight(rt, port, gpu_pid)
            venv = rt.get(venv_ref, timeout=OBS_TIMEOUT_S)
            out["env"] = obs_runtime_env(rt, want, gpu_pid, tmp, pip)
            if out["env"]["venv"] != venv:
                raise AssertionError(f"observability-e: venv "
                                     f"{out['env']['venv']}, the CPU task's "
                                     f"{venv}")
    except BaseException:
        rt.shutdown()
        raise
    if not keep:
        rt.shutdown()
    gc_collect()
    out["launches"] = {k: sum(out[p]["launches"][k] for p in
                              ("trace", "profile", "env"))
                       for k in CORE_KERNELS}
    if not all(out["launches"].values()):
        raise AssertionError(f"observability: launches {out['launches']}")
    out["phase_s"] = time.perf_counter() - t0
    log(f"observability phase ok in {out['phase_s']:.1f} s; K1-K3 launches "
        f"in its GPU tasks {out['launches']}; card: {gpu_line()}")
    log("observability metrics: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 25: the two paths of the mirrored tests that reach a GPU and that no
# earlier phase drives: a GPU host pool that the autoscaler launches for a
# placement group and deletes when idle, and Ape-X with its learner on the
# card.

POOL_WAIT_S = 120.0
# One pool shape: a host with the card, as tests/test_tpu_pod_provider.py
# declares its slices ({"CPU": ..., "TPU": ..., "hosts": ...}).
POOL_SHAPE = {"CPU": 2.0, "GPU": 1.0, "hosts": 1}
APEX_ITERS = 4


def pool_k1(tol, t_submit):
    """25a, in a ``num_gpus=1`` task in the pool's bundle: K1 on each of
    ``K1_SEEDS``' inputs at the training shape against
    ``flash_forward_plain`` on the same inputs (``check_k1``), K1's
    launches in this task, the node and the worker's cold start."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import flash_attention as fa

    t_enter = time.time()
    age_s = _process_age_s()
    before = core_launches(fa)
    errs = {seed: check_k1(fa, seed, **tol) for seed in K1_SEEDS}
    after = core_launches(fa)
    return {"errs": errs, "pid": os.getpid(),
            "node_id": rt.get_runtime_context().get_node_id(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "spawn_ms": (t_enter - t_submit) * 1e3,
            "process_age_ms": age_s * 1e3,
            "launches": {n: after[n] - before[n] for n in after}}


def pools_gpu_pool(tol, k1_errors):
    """25a: ``GpuPoolProvider`` over ``FakeGpuCloud`` and a
    ``cluster_utils.Cluster`` whose head has no GPU: a one-bundle
    ``{"GPU": 1}`` placement group makes the autoscaler request a pool of
    one host with the card; a task in the bundle holds K1 there on
    ``K1_SEEDS``' inputs, with phase 2's errors on them (``k1_errors``);
    the pool goes once idle."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import autoscaler as a
    from ray_tpu_torch._private import worker as tworker
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.placement_group import (
        placement_group, remove_placement_group,
    )
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        c.connect(log_to_driver=False)
        c.wait_for_nodes()
        if rt.cluster_resources().get("GPU", 0):
            raise AssertionError(f"pools: the head counts GPUs "
                                 f"{rt.cluster_resources()}")
        cloud = a.FakeGpuCloud(c, capacity_pools=1)
        provider = a.GpuPoolProvider(cloud)
        scaler = a.StandardAutoscaler(
            tworker.require_worker().gcs, provider, a.AutoscalerConfig(
                node_types=[a.NodeType("h100_pool", dict(POOL_SHAPE),
                                       max_workers=1)],
                max_workers=1, idle_timeout_s=2.0))
        t0 = time.time()
        pg = placement_group([{"GPU": 1.0}])
        launched = [0]

        def active():
            launched[0] += scaler.run_once()["launched"]
            return [n for n, r in cloud.list_queued_resources().items()
                    if r["state"] == "ACTIVE"]

        pools = obs_wait(active, "the pool ACTIVE", POOL_WAIT_S)
        active_s = time.time() - t0
        if not pg.wait(timeout_seconds=POOL_WAIT_S):
            raise AssertionError("pools: the bundle was never placed")
        ready_s = time.time() - t0
        hosts = [n for n in rt.nodes()
                 if n["Alive"] and n["Labels"].get("slice") in pools]
        if launched[0] != 1 or len(pools) != 1 or len(hosts) != 1 or \
                hosts[0]["Resources"].get("GPU") != 1.0:
            raise AssertionError(f"pools: launched {launched[0]}, pools "
                                 f"{pools}, hosts {hosts}")
        t_submit = time.time()
        # The bundle holds the GPU only: the task asks for no CPU.
        got = rt.get(rt.remote(pool_k1).options(
            num_cpus=0, num_gpus=1,
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                pg, placement_group_bundle_index=0)).remote(tol, t_submit),
            timeout=300)
        cold_s = time.time() - t_submit
        want = {"flash_fwd": len(K1_SEEDS), "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
        if got["node_id"] != hosts[0]["NodeID"] or got["launches"] != want \
                or got["errs"] != k1_errors:
            raise AssertionError(f"pools: the task ran {got} on "
                                 f"{hosts[0]['NodeID']}")
        remove_placement_group(pg)
        t_idle = time.time()

        def deleted():
            scaler.run_once()
            return not provider.non_terminated_nodes()

        obs_wait(deleted, "the idle pool deleted", POOL_WAIT_S)
        deleted_s = time.time() - t_idle
        obs_wait(lambda: not rt.cluster_resources().get("GPU", 0),
                 "the pool's GPU gone from the cluster", POOL_WAIT_S)
        if cloud.list_queued_resources():
            raise AssertionError(f"pools: left {cloud.list_queued_resources()}")
    finally:
        rt.shutdown()
        c.shutdown()
    out = {"active_s": active_s, "pg_ready_s": ready_s, "task_s": cold_s,
           "spawn_ms": got["spawn_ms"],
           "process_age_ms": got["process_age_ms"],
           "deleted_s": deleted_s, "errs": got["errs"],
           "launches": got["launches"]}
    log(f"pools-a ok: a {{'GPU': 1}} bundle launched one pool "
        f"{POOL_SHAPE} through GpuPoolProvider/FakeGpuCloud (demand -> "
        f"pool ACTIVE {active_s:.2f} s, placement group ready "
        f"{ready_s:.2f} s); a num_gpus=1 task in the bundle on the pool's "
        f"host (CUDA_VISIBLE_DEVICES={got['cuda_visible_devices']}) ran K1 "
        f"at [{B * H}, {L}, {D}] bf16 causal against flash_forward_plain on "
        f"seeds {list(K1_SEEDS)}: max |diff| {got['errs']} (= phase 2's), "
        f"launches {got['launches']}; cold "
        f"start {got['spawn_ms']:.0f} ms from submit to the task's first "
        f"line (the process {got['process_age_ms']:.0f} ms old), result "
        f"after {cold_s:.2f} s; idle -> pool deleted {deleted_s:.2f} s, no "
        f"GPU left; card: {gpu_line()}")
    return out


def pools_apex(rt):
    """25b: Ape-X as ``tests/test_apex.py::test_apex_end_to_end``
    configures it, on the port's runtime: 2 rollout workers and 2 replay
    shards as CPU actors, the learner on the card in this process; 4
    iterations, and that test's assertions."""
    from ray_tpu_torch import rllib as rl

    env, _, which = rl_envs()
    algo = (rl.ApexDQNConfig(
                buffer_size=8000, learning_starts=200,
                train_batch_size=32, num_sgd_iters=8,
                num_replay_shards=2, rollout_fragment_length=100)
            .environment(env)
            .rollouts(num_rollout_workers=2)
            .build(runtime=rt, device="cuda", worker_device="cpu"))
    try:
        if algo.learner.device.type != "cuda":
            raise AssertionError(f"pools-b: learner on {algo.learner.device}")
        its, total_updates = [], 0
        for _ in range(APEX_ITERS):
            t0 = time.perf_counter()
            m = algo.train()
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            total_updates += m.get("learner_updates_this_iter", 0)
            its.append({"ms": s * 1e3,
                        "updates": m.get("learner_updates_this_iter", 0),
                        "env_steps": m["timesteps_this_iter"]})
        sizes = rt.get([sh.stats.remote() for sh in algo.replay_shards],
                       timeout=120)
    finally:
        algo.stop()
    if not (m["replay_total"] >= 200 and m["replay_shards"] == 2
            and total_updates > 0 and "td_abs" not in m
            and "_td_abs" not in m
            and all(x["size"] > 0 for x in sizes)
            and any(x["prio_max"] > x["prio_mean"] for x in sizes)):
        raise AssertionError(f"pools-b: {m}, shards {sizes}")
    # The rates leave out the first iteration, which starts the actors.
    steady = its[1:]
    secs = sum(x["ms"] for x in steady) / 1e3
    out = {"iterations": its,
           "updates_per_s": sum(x["updates"] for x in steady) / secs,
           "env_steps_per_s": sum(x["env_steps"] for x in steady) / secs,
           "replay_total": m["replay_total"]}
    log(f"pools-b ok: Ape-X ({which}; 2 rollout workers and 2 replay shards "
        f"as CPU actors of ray_tpu_torch, the learner on cuda here) held "
        f"test_apex_end_to_end's assertions after {APEX_ITERS} iterations "
        f"(replay {m['replay_total']}, {total_updates} learner updates, "
        f"shards {[int(x['size']) for x in sizes]}); iteration ms "
        f"{[round(x['ms'], 1) for x in its]}; over iterations 2-"
        f"{APEX_ITERS} {out['updates_per_s']:.1f} learner updates/s, "
        f"{out['env_steps_per_s']:.0f} env steps/s; "
        f"card: {gpu_line()}")
    return out


def pools_phase(tol, k1_errors, shared=False):
    """Phase 25: 25b on the live runtime with ``shared`` (phase 24's), else
    on one of its own, then 25a on a cluster of its own."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    out = {}
    if not shared:
        rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    try:
        out["apex"] = pools_apex(rt)
    finally:
        rt.shutdown()
    gc_collect()
    out["pool"] = pools_gpu_pool(tol, k1_errors)
    out["launches"] = out["pool"]["launches"]
    out["phase_s"] = time.perf_counter() - t0
    log(f"pools phase ok in {out['phase_s']:.1f} s; card: {gpu_line()}")
    log("pools metrics: " + json.dumps(out))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels, then stop")
    ap.add_argument("--profile", action="store_true",
                    help="profile one train step of each model and one "
                         "decode step into chiprun_out/")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serve run's prompts and weights")
    ap.add_argument("--only", choices=["sharded", "runtime", "serve", "tune",
                                       "jobs", "correctness", "gaps", "core",
                                       "failures", "observability",
                                       "pools"],
                    help="run the build, the kernel checks, the main path "
                         "and this phase only")
    args = ap.parse_args()
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1

    from ray_tpu_torch import models as tm
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops import flash_attention as fa

    cache_bytecode()
    cold = GpuColdStarts()

    # f32 references in full f32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")

    t0 = time.perf_counter()
    libs = _kernels.build_all()
    log(f"build ok: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        log(f"ptxas {name}: " + ptxas_summary(
            lib.with_suffix(".log").read_text()))
    check_tensor_cores(libs["flash_attention"])

    # Same tolerances as tests/test_flash_attention.py for f32. bf16: both
    # sides round P (and dS) and their outputs to bf16, but from f32 values
    # that differ in the last bits (ex2.approx with the scale in log2 units,
    # other summation orders). An output lands at most an ulp or so apart
    # (rtol 1e-2). A P or dS element that rounds to the other side of a
    # bf16 boundary moves one term of a gradient sum by an ulp of the
    # element (2^-8 of a P near 1) times dO or Q (|x| < 5 for these normal
    # inputs): atol 2e-2 for the gradients. The same flip in O's P.V sum
    # is bounded per element (``p_round_slack``): 2^-7 softmax . |V|.
    # lse stays f32.
    f32 = dict(tol_out=(2e-5, 1e-4), tol_row=(2e-5, 1e-4),
               tol_grad=(1e-4, 1e-3), p_round=0.0)
    bf16 = dict(tol_out=(1e-3, 1e-2), tol_row=(1e-4, 1e-5),
                tol_grad=(2e-2, 1e-2), p_round=2 ** -7)
    # Small shapes: both dtypes, both head dims, causal and not, a length
    # (80) that leaves every kernel's tile ragged, and q against k/v of
    # another length both ways (non-causal; 320 leaves the last 128-row q
    # block half empty): the kernels index K and V by lk, Q, dO, lse,
    # delta and the outputs by lq.
    for bh, lq, lk, d, dtype, causal, tol in [
            (8, 256, 256, 64, torch.float32, True, f32),
            (8, 256, 256, 64, torch.float32, False, f32),
            (8, 80, 80, 64, torch.float32, True, f32),
            (8, 256, 256, 128, torch.float32, True, f32),
            (8, 320, 448, 64, torch.float32, False, f32),
            (8, 448, 320, 64, torch.float32, False, f32),
            (8, 256, 256, 64, torch.bfloat16, False, bf16),
            (8, 256, 256, 128, torch.bfloat16, False, bf16),
            (8, 256, 256, 128, torch.bfloat16, True, bf16),
            (8, 80, 80, 64, torch.bfloat16, True, bf16),
            (8, 80, 80, 128, torch.bfloat16, False, bf16),
            (8, 320, 448, 64, torch.bfloat16, False, bf16),
            (8, 448, 320, 64, torch.bfloat16, False, bf16),
            (8, 320, 448, 128, torch.bfloat16, False, bf16),
            (8, 448, 320, 128, torch.bfloat16, False, bf16)]:
        check_kernels(fa, bh, lq, lk, d, dtype, causal, **tol)
    errors = check_kernels(fa, B * H, L, L, D, torch.bfloat16, True, **bf16)
    k1_errors = {seed: check_k1(fa, seed, **bf16) for seed in K1_SEEDS}
    log(f"check ok K1 at [{B * H}, {L}, {D}] bf16 causal on seeds "
        f"{list(K1_SEEDS)}: max |diff| {k1_errors}")
    if args.quick:
        log("quick: stopping after the kernel checks")
        return 0

    check_forward(tm)
    state, step, batch, run = train(tm, fa)
    launches, step_ms = run.launches, run.step_ms
    if args.profile:
        profile_step(state, step, batch,
                     os.path.join("chiprun_out", "profile_train_step.txt"),
                     step_ms)
    del state, step, batch
    torch.cuda.empty_cache()
    spread = phase4_spread(tm, fa, run)
    log(f"phase 4 against itself: losses within {spread:.3e}")

    times, sdpa_bwd = time_kernels(fa)
    rows = []
    for kern in fa.KERNELS:
        name = kern.symbol.removeprefix("rtt_")
        t = times[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "design": DESIGN[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errors[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        log(f"time {name}: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library "
            f"{t['library_ms']}, {launches[name]} launches in the train run")
    k23 = times["flash_bwd_dq"]["ms"] + times["flash_bwd_dkv"]["ms"]
    log(f"time sdpa backward op alone (dQ, dK, dV at once, the K2 and K3 "
        f"rows' library_ms): {sdpa_bwd:.4f} ms against K2 + K3 {k23:.4f} "
        f"ms; train step {step_ms:.2f} ms; card: {card}")
    torch.cuda.empty_cache()

    if args.only == "sharded":
        sharded_phase(tm, fa, run)
        log(gpu_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.only == "runtime":
        runtime = runtime_phase(tm, fa, run, spread, bf16, args.seed)
        for row in rows:
            row["runtime_launches"] = runtime["train"]["launches"][
                row["name"]]
        log(json.dumps({"kernels": rows}))
        log(gpu_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.only == "tune":
        tuned = tune_phase(tm, fa, run, spread, bf16, errors)
        for row in rows:
            row["tune_launches"] = [x["launches_per_step"][row["name"]]
                                    for x in tuned["trials"]]
        log(json.dumps({"kernels": rows}))
        log(gpu_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.only == "jobs":
        jobs = jobs_phase(tm, fa, run, spread, bf16, errors)
        for row in rows:
            row["job_launches"] = jobs["workflow"]["launches_per_step"][
                row["name"]]
        log(json.dumps({"kernels": rows}))
        log(gpu_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.only == "correctness":
        correct = correctness_phase(tm, fa, run, spread)
        for row in rows:
            row["correctness_launches"] = correct["modes"]["launches"][
                row["name"]]
        log(json.dumps({"kernels": rows}))
        log(gpu_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.only == "gaps":
        gaps = gaps_phase(tm, fa, run, spread, bf16, errors)
        for row in rows:
            row["gaps_launches"] = gaps["death_push"]["launches_per_step"][
                row["name"]]
        log(json.dumps({"kernels": rows}))
        log(gpu_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.only == "core":
        core = core_phase(fa, bf16, errors)
        for row in rows:
            row["core_launches"] = core["launches"][row["name"]]
        log(json.dumps({"kernels": rows}))
        log(gpu_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.only == "failures":
        failures = failures_phase(fa, run)
        for row in rows:
            row["failures_launches"] = failures["launches"][row["name"]]
        log(json.dumps({"kernels": rows}))
        log(gpu_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.only == "observability":
        observed = observability_phase(fa, run, spread)
        for row in rows:
            row["observability_launches"] = observed["launches"][row["name"]]
        log(json.dumps({"kernels": rows}))
        log(gpu_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.only == "pools":
        pools = pools_phase(bf16, k1_errors)
        log(f"gpu cold starts: {cold.take()} in phase 25")
        for row in rows:
            row["pool_launches"] = pools["launches"][row["name"]]
        log(json.dumps({"kernels": rows}))
        log(gpu_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    from ray_tpu_torch.models import generate as gen
    from ray_tpu_torch.serve.llm import engine as se

    if args.only == "serve":
        serve_plane_phase(tm, gen, args.seed)
        log(json.dumps({"kernels": rows}))
        log(gpu_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # Each later phase's wall seconds and GPU workers started, logged at
    # the end: what to cut first when the whole script nears its limit.
    phase_s = {"1-5": time.perf_counter() - t_main}
    phase_cold = {"1-5": cold.take()}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        gc_collect()
        phase_s[name] = time.perf_counter() - t0
        phase_cold[name] = cold.take()
        return out

    timed("6 moe-train", moe_train, tm, fa, os.path.join(
        "chiprun_out", "profile_moe_train_step.txt") if args.profile
        else None)
    timed("7 remat", remat, tm, fa)
    timed("8 moe-serve", moe_serve, tm, gen, se, args.seed)
    timed("9 serve-check", serve_check, tm, gen, se)
    timed("10 serve", serve, tm, gen, se, fa, args.seed,
          os.path.join("chiprun_out", "profile_decode_step.txt")
          if args.profile else None)
    timed("11 rl", rl_phase, args.seed)
    rl_algo = timed("12 rl-algo", rl_algo_phase, args.seed)
    serve_app = timed("13 serve-app", serve_app_phase, tm, gen, fa,
                      args.seed)
    gang = timed("14 gang", gang_phase, tm, fa, run, spread, args.seed)
    sharded = timed("15 sharded", sharded_phase, tm, fa, run)
    runtime = timed("16 runtime", runtime_phase, tm, fa, run, spread, bf16,
                    args.seed, phase12=rl_algo["ppo"],
                    in_process=serve_app["kv_frame"])
    timed("17 serve-plane", serve_plane_phase, tm, gen, args.seed,
          in_process=serve_app["app"])
    tuned = timed("18 tune", tune_phase, tm, fa, run, spread, bf16, errors)
    jobs = timed("19 jobs", jobs_phase, tm, fa, run, spread, bf16, errors)
    correct = timed("20 correctness", correctness_phase, tm, fa, run, spread,
                    step16_ms=runtime["train"]["step_ms"])
    gaps = timed("21 gaps", gaps_phase, tm, fa, run, spread, bf16, errors,
                 frame16=runtime["frame"])
    core = timed("22 core", core_phase, fa, bf16, errors, keep=True)
    failures = timed("23 failures", failures_phase, fa, run, shared=True)
    observed = timed("24 observability", observability_phase, fa, run,
                     spread, keep=True)
    pools = timed("25 pools", pools_phase, bf16, k1_errors, shared=True)
    cold.stop()
    log(f"phase seconds: {json.dumps(phase_s)}; all "
        f"{time.perf_counter() - t_main:.1f} s")
    log(f"gpu cold starts: {json.dumps(phase_cold)}; all "
        f"{sum(phase_cold.values())}")
    for row in rows:
        row["pool_launches"] = pools["launches"][row["name"]]
        row["observability_launches"] = observed["launches"][row["name"]]
        row["failures_launches"] = failures["launches"][row["name"]]
        row["core_launches"] = core["launches"][row["name"]]
        row["gaps_launches"] = gaps["death_push"]["launches_per_step"][
            row["name"]]
        row["correctness_launches"] = correct["modes"]["launches"][
            row["name"]]
        row["job_launches"] = jobs["workflow"]["launches_per_step"][
            row["name"]]
        row["tune_launches"] = [x["launches_per_step"][row["name"]]
                                for x in tuned["trials"]]
        row["runtime_launches"] = runtime["train"]["launches"][row["name"]]
        row["trainer_launches"] = gang["trainer"]["launches"][row["name"]]
        row["sharded_launches"] = {
            name: [r[row["name"]] for r in sharded[name]["launches"]]
            for name, _, _ in SHARDED_MESHES}
    log(json.dumps({"kernels": rows}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
