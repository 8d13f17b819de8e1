#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one H100.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build and kernel checks only
    python3 chip_smoke.py --profile  # also write a profile of one train step
                                     # to chiprun_out/profile_train_step.txt

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

The last two lines are the card's name and power limit, as nvidia-smi
prints them, and ``{"ok": true, "device": {...}}``. Without a CUDA card the
script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

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


def train(tm, fa):
    """The main path: returns the launch counts of its steps and the step
    time."""
    cfg = tm.GPTConfig.preset("gpt2-125m", max_seq=L, flash_attention=True)
    opt = functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.1)
    state = tm.make_train_state(
        cfg, opt, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    step = tm.make_train_step(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, L + 1))).cuda()
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    n_params = tm.count_params(state.params)
    with torch.no_grad():
        ref_loss = tm.loss_fn(state.params, batch, dataclasses.replace(
            cfg, flash_attention=False)).item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launches()
    losses, times = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())   # waits for the step
        times.append(time.perf_counter() - t0)
    launches = {k.symbol.removeprefix("rtt_"): k.launches for k in fa.KERNELS}

    steps = WARMUP_STEPS + TIMED_STEPS
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall {losses}")
    # bf16 attention probabilities (reference) vs f32 (kernels): the first
    # loss of ~10.9 agrees to 2e-2.
    if abs(losses[0] - ref_loss) > 2e-2:
        raise AssertionError(f"train: first loss {losses[0]} vs reference "
                             f"attention {ref_loss}")
    # Per step: the forward in each of 12 layers, again in remat's
    # recompute, then dQ and dK/dV once each.
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    for name, per_step in want.items():
        if launches[name] != per_step * steps:
            raise AssertionError(f"train: {name} launched {launches[name]} "
                                 f"times in {steps} steps, want "
                                 f"{per_step} per step")
    step_ms = statistics.median(times[WARMUP_STEPS:]) * 1e3
    tokens_per_s = B * L / (step_ms / 1e3)
    mfu = tokens_per_s * 6 * n_params / PEAK_FLOPS[torch.bfloat16]
    log(f"train ok: gpt2-125m {n_params} params, batch {B} seq {L}, "
        f"losses {[round(x, 4) for x in losses]} (reference attention "
        f"{ref_loss:.4f}), launches {launches} in {steps} steps")
    log(f"train step_ms {step_ms:.2f} (median of {TIMED_STEPS}; all "
        f"{[round(t * 1e3, 2) for t in times]}), tokens/s "
        f"{tokens_per_s:.1f}, MFU {mfu:.4f} of 989 TFLOP/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return state, step, batch, launches, step_ms


def union_ms(ranges) -> float:
    """Total length in ms of the union of profiler intervals (in us)."""
    total, end = 0.0, float("-inf")
    for r in sorted(ranges, key=lambda r: r.start):
        if r.end > end:
            total += r.end - max(r.start, end)
            end = r.end
    return total / 1e3


def profile_step(state, step, batch, path, step_ms):
    """One train step under torch.profiler; the table of device time by
    kernel goes to ``path``. Prints the device's busy time (the union of
    its kernels' and copies' intervals) against the unprofiled median
    ``step_ms``, and the flash kernels' share of it."""
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
    log(f"profile: device busy {busy:.2f} ms per step, {step_ms:.2f} ms "
        f"step (idle share {1 - busy / step_ms:.4f}); flash kernels "
        f"{flash:.2f} ms ({flash / busy:.4f} of busy); table in {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels, then stop")
    ap.add_argument("--profile", action="store_true",
                    help="profile one train step into chiprun_out/")
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
    state, step, batch, launches, step_ms = train(tm, fa)
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
    log(f"time sdpa backward (dQ, dK, dV at once, yardstick): "
        f"{sdpa_bwd:.4f} ms; train step {step_ms:.2f} ms")
    log(json.dumps({"kernels": rows}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
