#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one H100.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build and kernel checks only
    python3 chip_smoke.py --profile  # also profile one train step of each
                                     # model and one decode step into
                                     # chiprun_out/
    python3 chip_smoke.py --seed N   # the serve run's weights and prompts

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
   yardstick the port never calls).
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
10. serve: the serving path's main run. llama-7b at full width and depth,
   bf16 compute, the block weights cast once; the paged engine with 8
   slots, max_len 2048, block 16, chunk 512, prefix cache on. 16 requests
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
   (c) llama-7b at full width and depth, bf16: the disaggregated app
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


def close(name, got, want, atol, rtol) -> float:
    """Assert |got - want| <= atol + rtol |want| elementwise (both in f32);
    return the largest absolute difference."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    excess = (err - (atol + rtol * want.abs())).max().item()
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


def check_kernels(fa, bh, lq, lk, d, dtype, causal, tol_out, tol_row,
                  tol_grad, seed=0):
    """Run the three kernels on q of [bh, lq, d] and k, v of [bh, lk, d] in
    ``dtype``; compare with the plain versions on the same tensors (they
    compute in f32 and round where the kernels round). The backward kernels
    get the plain forward's lse and delta, so each kernel is held to its own
    arithmetic. Returns the kernels' largest abs errors."""
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
    err_o = close(f"O {tag}", o, o_ref, *tol_out)
    err_lse = close(f"lse {tag}", lse, lse_ref, *tol_row)
    err_dq = close(f"dQ {tag}", dq, dq_ref, *tol_grad)
    err_dk = close(f"dK {tag}", dk, dk_ref, *tol_grad)
    err_dv = close(f"dV {tag}", dv, dv_ref, *tol_grad)
    log(f"check ok {tag}: max |diff| O {err_o:.3e} lse {err_lse:.3e} "
        f"dQ {err_dq:.3e} dK {err_dk:.3e} dV {err_dv:.3e}")
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
    # does; its backward computes dQ, dK and dV at once, which neither
    # backward kernel does alone.
    q4, k4, v4, do4 = (x.view(B, H, L, D) for x in (q, k, v, do))
    times["flash_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        iters=20)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q4, k4, v4))
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        og, (qg, kg, vg), do4, retain_graph=True), iters=20)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        times[name]["library_ms"] = None
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


def new_state(tm, cfg):
    """Fresh params from seed 0 on the card and AdamW(3e-4, wd 0.1), as
    ``bench.py::measure``."""
    opt = functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.1)
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
    ``models.forward`` on the prompt; both bf16."""
    bs, width = 16, 2048 // 16
    pool = gen.init_paged_pool(cfg, 1 + 1024 // bs, bs, 1, width)
    table = torch.zeros(width, dtype=torch.int64, device="cuda")
    table[:1024 // bs] = torch.arange(1, 1 + 1024 // bs)
    fwd_cfg = dataclasses.replace(cfg, remat=False)
    errs, agree, spread = [], 0, 0.0
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
    del pool
    log(f"serve logits ok: chunked-prefill first-token logits vs "
        f"models.forward, {len(prompts)} prompts, max |diff| "
        f"{max(errs):.4f} (atol {tol}), median {statistics.median(errs):.4f}"
        f", logits' std up to {spread:.4f}; argmax agrees on "
        f"{agree}/{len(prompts)}")


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
    """Phase 10: llama-7b at full width and depth, bf16, the paged engine;
    the flash kernels' counts are zeroed before and read after (the
    serving path launches none of them)."""
    cfg = se.EngineConfig(preset="llama-7b").gpt_config()
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
        ec = se.EngineConfig(
            preset="llama-7b", max_slots=8, max_len=2048, paged_kv=True,
            kv_block_size=16, prefill_chunk=512, prefix_cache_enabled=True,
            max_new_tokens=SERVE_NEW, **sampling)
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


# ---------------------------------------------------------------------------
# Phase 13: the serving tier (replicas, router, KV handoff) on the
# in-process runtime, through its serve facet.

KV_FRAME_SHAPE = (32, 1, 1024, 32, 128)    # llama-7b K block at bucket 1024
APP_BUCKETS = (128, 256, 512, 1024)
# Peak device memory phase 13(c) is reckoned to need (PERF.md): two
# replicas' bf16 weights, the decode pool, the handoffs in flight, and a
# replica's f32 draw while it is built.
APP_PEAK_EXPECTED_GB = 55.0


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


def serve_app_check(tm, gen, preset="llama-7b"):
    """13(b): phase 9's sizes (two layers, f32) through the combined and the
    disaggregated app on the in-process runtime, token-exact."""
    from ray_tpu_torch._private import device_objects as tdo
    from ray_tpu_torch.runtime import LocalRuntime
    from ray_tpu_torch.serve.llm import EngineConfig, build_llm_app
    from ray_tpu_torch.serve.llm import replicas as rp

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
    sampled = dict(temperature=0.8, top_k=50)
    from ray_tpu_torch.serve.llm.engine import InflightBatchEngine
    solo = InflightBatchEngine(params, cfg, EngineConfig.from_dict(
        dict(base, **sampled)), replica_id="app-solo", device=CARD)
    try:
        solo_streams = [solo.generate(p, n, seed=s)
                        for p, s in zip(prompts, seeds)]
    finally:
        solo.stop()
    del params

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
    """13(c): the disaggregated app at full llama-7b width and depth, bf16,
    on phase 10's 16 prompts from 16 client threads."""
    from ray_tpu_torch._private import device_objects as tdo
    from ray_tpu_torch.runtime import LocalRuntime
    from ray_tpu_torch.serve.llm import build_llm_app
    from ray_tpu_torch.serve.llm import replicas as rp

    gc_collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ec = dict(preset="llama-7b", param_seed=seed, max_slots=8, max_len=2048,
              paged_kv=True, kv_block_size=16, prefill_chunk=512,
              prompt_buckets=APP_BUCKETS, max_new_tokens=SERVE_NEW,
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
    if n_params != 5_165_776_896:
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
        f"{serve_peak:.2f}; reckoned {APP_PEAK_EXPECTED_GB} of 80)")
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


def gang_trainer(tm, fa, run):
    """14a: the gang trainer on the card at phase 4's size."""
    # Phase 4's own spread: its steps again, from the same seed.
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    again = run_steps(fa, new_state(tm, cfg), tm.make_train_step(cfg),
                      train_batch(cfg.vocab_size), "gang phase-4 again",
                      cfg.n_layers)
    spread = max(abs(a - b) for a, b in zip(again.losses, run.losses))
    tol = max(GANG_LOSS_ATOL, spread)
    del again
    gc_collect()
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


def gang_phase(tm, fa, run, seed):
    """Phase 14: (a) the gang trainer, (b) two ranks on one card, (c)
    DD-PPO."""
    t0 = time.perf_counter()
    os.makedirs("chiprun_out", exist_ok=True)
    results = {"trainer": gang_trainer(tm, fa, run)}
    gc_collect()
    results["halves"] = gang_halves(tm)
    gc_collect()
    results["ddppo"] = ddppo_phase(seed)
    results["phase_s"] = time.perf_counter() - t0
    log(f"gang phase ok in {results['phase_s']:.1f} s")
    log("gang metrics: " + json.dumps(results))
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels, then stop")
    ap.add_argument("--profile", action="store_true",
                    help="profile one train step of each model and one "
                         "decode step into chiprun_out/")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serve run's prompts and weights")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1

    from ray_tpu_torch import models as tm
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops import flash_attention as fa

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
    # inputs): atol 2e-2 for the gradients. lse stays f32.
    f32 = dict(tol_out=(2e-5, 1e-4), tol_row=(2e-5, 1e-4),
               tol_grad=(1e-4, 1e-3))
    bf16 = dict(tol_out=(1e-3, 1e-2), tol_row=(1e-4, 1e-5),
                tol_grad=(2e-2, 1e-2))
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
    log(f"time sdpa backward (dQ, dK, dV at once, yardstick): "
        f"{sdpa_bwd:.4f} ms against K2 + K3 {k23:.4f} ms; train step "
        f"{step_ms:.2f} ms")
    torch.cuda.empty_cache()

    from ray_tpu_torch.models import generate as gen
    from ray_tpu_torch.serve.llm import engine as se

    moe_train(tm, fa, os.path.join("chiprun_out",
                                   "profile_moe_train_step.txt")
              if args.profile else None)
    torch.cuda.empty_cache()
    remat(tm, fa)
    moe_serve(tm, gen, se, args.seed)
    torch.cuda.empty_cache()
    serve_check(tm, gen, se)
    torch.cuda.empty_cache()
    serve(tm, gen, se, fa, args.seed,
          os.path.join("chiprun_out", "profile_decode_step.txt")
          if args.profile else None)
    torch.cuda.empty_cache()
    rl_phase(args.seed)
    rl_algo_phase(args.seed)
    serve_app_phase(tm, gen, fa, args.seed)
    gang = gang_phase(tm, fa, run, args.seed)
    for row in rows:
        row["trainer_launches"] = gang["trainer"]["launches"][row["name"]]
    log(json.dumps({"kernels": rows}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
