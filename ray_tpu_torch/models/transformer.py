"""GPT-family decoder transformer (port of ``ray_tpu/models/transformer.py``,
the single-device path: dense or mixture-of-experts FFN, every remat
policy).

Kept from the reference:

- **Plain-dict params** with the reference's names and layouts: block
  params stacked on a leading ``layers`` dim, ``wqkv`` [L, D, 3, H, Dh],
  ``wo`` [L, H, Dh, D], the experts' ``w_up`` [L, E, D, F]. ``models.
  convert.params_from_numpy`` carries JAX params over by name alone.
- **bf16 compute, f32 master params**: params live in ``param_dtype``
  and are cast to ``dtype`` for use, once per step; layer norm runs in f32.
- **Switch top-1 MoE** (``moe_experts > 0``): the reference's routing,
  capacity and dropping rule for rule (``_moe_ffn``), computed by index
  where the reference multiplies by one-hot dispatch and combine tensors
  (``_moe_ffn_onehot`` keeps that form as the plain version).
- **Remat** under ``cfg.remat``: each block runs as ``_Remat``, which keeps
  the block's input, its params and what the policy names, and recomputes
  the rest in backward, attention (and its flash forward) included under
  every policy. The kept sets are those of the reference's
  ``jax.checkpoint`` policies, as ``print_saved_residuals`` lists them:
  ``"full"`` nothing more; ``"matmuls"`` the products after their biases
  that the reference names and its backward reads (``qkv``, ``attn_out``
  and, dense, ``mlp_up``); ``"dots"`` every product without batch axes
  that the backward reads, before its bias: the qkv, output-projection
  and (dense) up-projection products, and (MoE) the router logits and the
  dispatched ``expert_in`` [E, C, D]. The reference's comment calls
  ``"dots"`` "mostly a no-op" for this model; it keeps as much as
  ``"matmuls"``.
- **f32 logits**: the tied LM head multiplies operands in ``dtype`` and
  keeps the f32 sums as logits (the reference's
  ``preferred_element_type=float32``).

- **Meshes** (``mesh=``, ``rules=``): one SPMD program with the reference's
  global semantics; sharding moves data and never changes the answer.
  Params are DTensors laid out by ``param_logical_axes`` and the rules;
  the model runs as a ``collective.shard_map_compat`` body on each rank's
  local shards (``_Shards``): the batch split over the rules' "batch" mesh
  dims, the sequence over "seq" (ring attention there when
  ``cfg.ring_attention``, else K/V gathered), heads and the FFN width over
  "heads"/"mlp" with a psum after the row-parallel products, experts over
  "experts" with a psum of the combine. Those are the layouts the
  reference's ``with_logical_constraint`` calls pin. The flash kernels
  take each rank's local [B/(dp*fsdp), L, H/tp, Dh]. The tied LM head runs
  per batch shard over the whole vocabulary: the reference constrains the
  logits' vocab dim onto tp, a layout, not a result. Under a "pp" dim the
  blocks run GPipe-style (``parallel/pipeline.py``) unsharded inside each
  stage, as the reference's do.

What changes: ``lax.scan`` over the stacked layers is a Python loop; the
train step updates params in place with a ``torch.optim`` optimizer.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import (
    mha_reference, ring_attention,
)
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.parallel.collective import all_gather, psum

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # gpt2 50257 padded to a multiple of 128
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 1024
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    rotary: bool = False      # learned positions (GPT-2 parity) by default
    remat: bool = True
    # What a block keeps for backward under cfg.remat (_REMAT_KEEPS):
    #   "full"    — its input and params only; backward recomputes it all.
    #   "matmuls" — also qkv and attn_out after their biases, and the
    #               dense FFN's mlp_up (before gelu): 100.7 MB a layer at
    #               batch 8 x seq 1024, gpt2-125m widths, in bf16.
    #   "dots"    — the reference's dots_with_no_batch_dims_saveable: the
    #               same three products before their biases (dense), or
    #               the qkv and wo products, router logits [T, E] and
    #               expert_in [E, C, D] (MoE).
    remat_policy: str = "full"
    ring_attention: bool = False   # ring attention over "seq" when sharded
    eps: float = 1e-5
    # Switch top-1 mixture of experts (0 = dense): tokens past each
    # expert's capacity C = max(1, int(cf * T / E)) of a call's T tokens
    # are dropped (FFN output 0), so the rows of a batch share capacity.
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    # Pipeline parallelism: microbatches per step when the mesh has pp>1
    # (None -> pp). Layers shard over pp; embed/head replicate.
    pp_microbatches: Optional[int] = None
    # Flash attention (ops/flash_attention.py): True/False force it; "auto"
    # uses it from flash_min_seq on. The default threshold is the
    # reference's; the crossover on the GPU has not been measured.
    flash_attention: Any = False
    flash_min_seq: int = 4096

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def preset(name: str, **overrides) -> "GPTConfig":
        presets = {
            # test-sized
            "tiny": dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4,
                         d_ff=256, max_seq=128),
            "gpt2-125m": dict(n_layers=12, d_model=768, n_heads=12, d_ff=3072),
            "gpt2-350m": dict(n_layers=24, d_model=1024, n_heads=16, d_ff=4096),
            "gpt2-774m": dict(n_layers=36, d_model=1280, n_heads=20, d_ff=5120),
            "gpt2-1.5b": dict(n_layers=48, d_model=1600, n_heads=25, d_ff=6400),
            # llama-style (rotary, longer context)
            "llama-tiny": dict(vocab_size=32000, n_layers=4, d_model=256,
                               n_heads=8, d_ff=688, max_seq=2048, rotary=True),
            "llama-7b": dict(vocab_size=32000, n_layers=32, d_model=4096,
                             n_heads=32, d_ff=11008, max_seq=4096, rotary=True),
        }
        if name not in presets:
            raise ValueError(f"unknown preset {name!r}; have {list(presets)}")
        kw = dict(presets[name])
        kw.update(overrides)
        return GPTConfig(**kw)


def _check_supported(cfg: GPTConfig) -> None:
    if cfg.remat and cfg.remat_policy not in _REMAT_KEEPS:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def param_logical_axes(cfg: GPTConfig) -> Params:
    """Logical axis names per parameter, same tree structure as params.

    The block params carry a leading ``layers`` axis (never sharded by
    default; a pipeline schedule claims it). ``tok_embed`` is replicated,
    as in the reference, whose comment explains it for XLA: a sharded table
    makes the embedding gather unpartitionable."""
    ax = {
        "tok_embed": (None, None),
        "blocks": {
            "ln1_scale": ("layers", "embed"),
            "ln1_bias": ("layers", "embed"),
            "wqkv": ("layers", "embed", None, "heads", "kv"),
            "bqkv": ("layers", None, "heads", "kv"),
            "wo": ("layers", "heads", "kv", "embed"),
            "bo": ("layers", "embed"),
            "ln2_scale": ("layers", "embed"),
            "ln2_bias": ("layers", "embed"),
            **({
                "wg": ("layers", "embed", None),
                "w_up": ("layers", "experts", "embed", "mlp"),
                "b_up": ("layers", "experts", "mlp"),
                "w_down": ("layers", "experts", "mlp", "embed"),
                "b_down": ("layers", "experts", "embed"),
            } if cfg.moe_experts else {
                "w_up": ("layers", "embed", "mlp"),
                "b_up": ("layers", "mlp"),
                "w_down": ("layers", "mlp", "embed"),
                "b_down": ("layers", "embed"),
            }),
        },
        "lnf_scale": ("embed",),
        "lnf_bias": ("embed",),
    }
    if not cfg.rotary:
        ax["pos_embed"] = (None, "embed")
    return ax


def shard_params(params: Params, cfg: GPTConfig, mesh,
                 rules=None) -> Params:
    """``params`` (the same on every rank) as DTensors laid out on ``mesh``
    by ``param_logical_axes`` and ``rules`` (default
    ``sharding.DEFAULT_RULES``); each rank keeps its shards."""
    from ray_tpu_torch.parallel.sharding import shard_pytree

    return shard_pytree(params, mesh, param_logical_axes(cfg), rules=rules)


def init_params(cfg: GPTConfig, *, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """GPT-2 init: N(0, 0.02), residual-out projections scaled by
    1/sqrt(2L). Draws on ``generator``'s device, then moves to ``device``
    (default ``cuda``); ``device="meta"`` gives shapes only."""
    _check_supported(cfg)
    device = resolve_device(device)
    L, D, H, Dh, Fd = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
                       cfg.d_ff)
    pd = cfg.param_dtype
    std = 0.02
    res_std = std / math.sqrt(2 * L)
    draw_device = device if device.type == "meta" else generator.device

    def norm(*shape, s=std):
        x = torch.empty(shape, dtype=torch.float32, device=draw_device)
        return x.normal_(0.0, s, generator=generator).to(device, pd)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=device)

    E = cfg.moe_experts
    params: Params = {
        "tok_embed": norm(cfg.vocab_size, D),
        "blocks": {
            "ln1_scale": ones(L, D),
            "ln1_bias": zeros(L, D),
            "wqkv": norm(L, D, 3, H, Dh),
            "bqkv": zeros(L, 3, H, Dh),
            "wo": norm(L, H, Dh, D, s=res_std),
            "bo": zeros(L, D),
            "ln2_scale": ones(L, D),
            "ln2_bias": zeros(L, D),
            **({
                "wg": norm(L, D, E),
                "w_up": norm(L, E, D, Fd),
                "b_up": zeros(L, E, Fd),
                "w_down": norm(L, E, Fd, D, s=res_std),
                "b_down": zeros(L, E, D),
            } if E else {
                "w_up": norm(L, D, Fd),
                "b_up": zeros(L, Fd),
                "w_down": norm(L, Fd, D, s=res_std),
                "b_down": zeros(L, D),
            }),
        },
        "lnf_scale": ones(D),
        "lnf_bias": zeros(D),
    }
    if not cfg.rotary:
        params["pos_embed"] = norm(cfg.max_seq, D)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def tree_leaves(params: Params) -> List[torch.Tensor]:
    """The tensors of a params dict in sorted-key order (the order of
    ``jax.tree.leaves`` on the reference's params)."""
    out: List[torch.Tensor] = []
    for key in sorted(params):
        val = params[key]
        out.extend(tree_leaves(val) if isinstance(val, dict) else [val])
    return out


def count_params(params: Params) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))


def _layer_norm(x, scale, bias, eps):
    """The reference's f32 layer norm (biased variance), as one op."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                        eps).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embeddings on [B, L, H, Dh], half-split (not interleaved);
    positions [L] global indices."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    angles = positions[:, None].float() * freqs[None, :]     # [L, half]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attention(q, k, v, cfg: GPTConfig, shards=None):
    """Causal attention of local q/k/v [B, L, H, Dh]. With the sequence
    sharded (``shards.seq``): ring attention under ``cfg.ring_attention``
    over one mesh dim; else q, k and v gathered over it, attention over
    the whole sequence, and this rank's queries kept, as GSPMD runs the
    reference's kernel that it cannot partition."""
    if shards is not None and shards.seq:
        if cfg.ring_attention and shards.ring is not None:
            return ring_attention(q, k, v, mesh_dim=shards.ring, causal=True)
        q, k, v = (shards.gather(t, shards.seq, 1) for t in (q, k, v))
        out = _attention(q, k, v, cfg)
        return _split(out, 1, shards, shards.seq)
    use_flash = cfg.flash_attention
    if use_flash == "auto":
        use_flash = q.shape[1] >= cfg.flash_min_seq
    if use_flash:
        return flash_attention(q, k, v, causal=True)
    return mha_reference(q, k, v, causal=True)


# ---------------------------------------------------------------------------
# Remat: what a block keeps for backward.

# The tensors each policy keeps besides the block's input and params: a
# product after its bias under its name, before it under name + ".dot";
# "expert_in" is the MoE dispatch [E, C, D]. The reference's "matmuls" also
# names the FFN's output (mlp_down), which its backward never reads, so
# nothing keeps it; its "dots" saves every product without batch axes that
# the backward reads (attention's and the experts' products have them).
_REMAT_KEEPS = {
    "full": frozenset(),
    "matmuls": frozenset({"qkv", "attn_out", "mlp_up"}),
    "dots": frozenset({"qkv.dot", "attn_out.dot", "mlp_up.dot",
                       "router.dot", "expert_in"}),
}


class _Tape:
    """The tensors of one block that its remat policy keeps: filled by the
    forward, read by the recompute in backward (``kept`` given)."""

    def __init__(self, names, kept=None):
        self.names = names
        self.recompute = kept is not None
        self.kept = {} if kept is None else kept


def _keep(tape: Optional[_Tape], name: str, compute, vjp, *inputs):
    """``compute()``, unless the policy keeps ``name``: then the forward
    stores the result, and the recompute returns the stored tensor without
    computing it and backpropagates through ``vjp(grad, *inputs)``, the
    op's own gradients from its recomputed inputs."""
    if tape is None or name not in tape.names:
        return compute()
    if tape.recompute:
        return _Kept.apply(vjp, tape.kept[name], *inputs)
    out = tape.kept[name] = compute()
    return out


class _Kept(torch.autograd.Function):
    """A kept tensor standing in for the op that made it (``_keep``)."""

    @staticmethod
    def forward(ctx, vjp, out, *inputs):
        ctx.vjp = vjp
        ctx.save_for_backward(*inputs)
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *ctx.vjp(grad, *ctx.saved_tensors))


def _product_vjp(grad, a, w, b=None):
    """Gradients of ``_project``'s ``(a @ w) + b`` for its inputs."""
    w2 = w.reshape(w.shape[0], -1)
    g2 = grad.reshape(-1, w2.shape[1])
    da = (g2 @ w2.t()).view(a.shape)
    dw = (a.reshape(-1, a.shape[-1]).t() @ g2).view(w.shape)
    return (da, dw) if b is None else (da, dw, grad.sum_to_size(b.shape))


def _reduced_vjp(reduce, grad, a, w, b):
    """Gradients of ``reduce(a @ w) + b``; ``reduce`` (a psum) is its own
    transpose."""
    return (*_product_vjp(reduce(grad), a, w), grad.sum_to_size(b.shape))


def _project(a, w, b, tape: Optional[_Tape] = None, name: str = "",
             reduce=None):
    """``a @ w + b`` for a [..., K], w [K, *out] and b [*out] (or None):
    the reference's einsum as one matmul over the flattened out axes. A
    remat policy may keep it as ``name`` after the bias or ``name + ".dot"``
    before it. ``reduce`` sums a row-parallel product's partial sums over
    the mesh before the bias (``.dot`` then keeps the local partial)."""
    def product():
        return (a @ w.reshape(w.shape[0], -1)).view(*a.shape[:-1],
                                                     *w.shape[1:])

    def dot():
        return _keep(tape, name + ".dot", product, _product_vjp, a, w)

    if b is None:
        return dot()
    if reduce is not None:
        return _keep(tape, name, lambda: reduce(dot()) + b,
                     functools.partial(_reduced_vjp, reduce), a, w, b)
    return _keep(tape, name, lambda: dot() + b, _product_vjp, a, w, b)


class _Remat(torch.autograd.Function):
    """One block under ``cfg.remat_policy``: the forward runs without a
    graph and keeps the block's input, its params and the policy's tensors
    (``_REMAT_KEEPS``); backward recomputes the block from them and
    backpropagates through the recompute."""

    @staticmethod
    def forward(ctx, cfg, positions, names, shards, x, *weights):
        tape = _Tape(_REMAT_KEEPS[cfg.remat_policy])
        out = _block(x, dict(zip(names, weights)), cfg, positions, tape,
                     shards)
        ctx.cfg, ctx.positions, ctx.names = cfg, positions, names
        ctx.shards = shards
        ctx.kept_names = tuple(tape.kept)
        ctx.save_for_backward(x, *weights, *tape.kept.values())
        return out

    @staticmethod
    def backward(ctx, grad):
        n = len(ctx.names) + 1
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in saved[:n]]
        tape = _Tape(_REMAT_KEEPS[ctx.cfg.remat_policy],
                     dict(zip(ctx.kept_names, saved[n:])))
        with torch.enable_grad():
            out = _block(inputs[0], dict(zip(ctx.names, inputs[1:])),
                         ctx.cfg, ctx.positions, tape, ctx.shards)
        grads = torch.autograd.grad(out, inputs, grad, allow_unused=True)
        return (None, None, None, None, *grads)


# ---------------------------------------------------------------------------
# The FFN: dense, or Switch top-1 mixture of experts.


def _ffn(h, bp, cfg: GPTConfig, tape: Optional[_Tape] = None, shards=None):
    if cfg.moe_experts:
        return _moe_ffn(h, bp, cfg, tape, shards)
    cd = cfg.dtype
    up = _project(h, bp["w_up"].to(cd), bp["b_up"].to(cd), tape, "mlp_up")
    # jax.nn.gelu's default is the tanh approximation.
    up = F.gelu(up, approximate="tanh")
    down = up @ bp["w_down"].to(cd)
    if shards is not None:
        down = shards.psum(down, shards.mlp)
    return down + bp["b_down"].to(cd)


def _route(x, bp, cfg: GPTConfig, tape: Optional[_Tape]):
    """Top-1 routing of x [T, D]: (gate [T] f32, expert [T], capacity C).
    The router logits are a product in the compute dtype, the softmax runs
    in f32; the gate is the top probability (``amax`` shares the gradient
    among ties, as ``jnp.max``) and the expert its first index
    (``argmax``, as ``jnp.argmax``)."""
    C = _capacity(cfg, x.shape[0])
    logits = _project(x, bp["wg"].to(cfg.dtype), None, tape, "router")
    gates = torch.softmax(logits.float(), dim=-1)
    return gates.amax(-1), gates.argmax(-1), C


def _capacity(cfg: GPTConfig, n_tokens: int) -> int:
    """Slots an expert takes of a call's ``n_tokens`` (the whole batch's,
    also when the batch is sharded)."""
    return max(1, int(cfg.moe_capacity_factor * n_tokens / cfg.moe_experts))


def _experts(expert_in, bp, cfg: GPTConfig, shards=None):
    """Each expert's FFN on its slots, expert_in [E, C, D] -> [E, C, D]."""
    cd = cfg.dtype
    up = torch.bmm(expert_in, bp["w_up"].to(cd)) + bp["b_up"].to(cd)[:, None]
    up = F.gelu(up, approximate="tanh")
    down = torch.bmm(up, bp["w_down"].to(cd))
    if shards is not None:
        down = shards.psum(down, shards.mlp)
    return down + bp["b_down"].to(cd)[:, None]


def _expert_rank(expert, E: int, B: int, L: int, shards=None):
    """Each token's rank among the tokens routed to its expert, counted in
    the flattened global [B*L] order. With the batch or the sequence
    sharded the expert ids [T] of every shard are gathered (they are
    small) and ranked as one batch, as the reference's global cumsum."""
    split = shards is not None and bool(shards.batch or shards.seq)
    ids = expert
    if split:
        ids = shards.gather(expert.view(B, L), shards.seq, 1)
        ids = shards.gather(ids, shards.batch, 0)
    # Running count of each expert's tokens, scanned along the contiguous
    # token axis of [E, T]: a scan down the E columns of [T, E] runs on too
    # few threads (34 ms of a gpt2-125m-moe8 train step on an NVIDIA H100
    # 80GB HBM3 at 700.00 W; PERF.md's MoE findings).
    flat = ids.reshape(-1)
    counts = (flat == torch.arange(E, device=flat.device)[:, None]).cumsum(1)
    rank = counts.gather(0, flat[None])[0] - 1
    if not split:
        return rank
    rank = rank.view(ids.shape)
    b0 = shards.index(shards.batch) * B
    l0 = shards.index(shards.seq) * L
    return rank[b0:b0 + B, l0:l0 + L].reshape(-1)


def _gather_vjp(grad, x_pad, src):
    dx = torch.zeros_like(x_pad).index_add_(
        0, src, grad.reshape(-1, x_pad.shape[1]))
    return dx, None


def _moe_ffn(h, bp, cfg: GPTConfig, tape: Optional[_Tape] = None,
             shards=None):
    """The reference's ``_moe_ffn`` (Switch top-1, GShard capacity) by
    index. A token's slot is its rank among the tokens routed to its
    expert, counted in flattened [B*L] order; tokens past the capacity C
    are dropped (output 0, the residual carries them). Each kept token's
    row is copied into its [E, C, D] slot, the experts run as batched
    products, and each token takes its slot's output times its gate
    rounded to the compute dtype: the reference's dispatch and combine
    einsums, without their [T, E, C] one-hot tensors and their products.

    Under a mesh the capacity and the ranks are the whole batch's
    (``_expert_rank``); with the experts sharded each rank runs its own
    experts on its tokens (replicated over the experts' dims) and the
    combine is summed over those dims."""
    cd = cfg.dtype
    B, L, D = h.shape
    x = h.reshape(-1, D)
    T = x.shape[0]
    gate, expert, C = _route(x, bp, cfg, tape)
    E, e0 = cfg.moe_experts, 0
    if shards is not None:
        C = _capacity(cfg, T * shards.size(shards.batch + shards.seq))
        E = bp["w_up"].shape[0]
        e0 = shards.index(shards.experts) * E
    rank = _expert_rank(expert, cfg.moe_experts, B, L, shards)
    local = expert - e0
    kept = (rank < C) & (local >= 0) & (local < E)
    # Each token's slot row in [E*C], or the zero row E*C when dropped (or
    # another rank's expert's).
    row = torch.where(kept, local * C + rank, E * C)
    # The token in each slot; T (x_pad's zero row) for an empty slot. The
    # dropped tokens all write the row past the end, which is cut off.
    src = torch.full((E * C + 1,), T, dtype=torch.int64, device=x.device)
    src[row] = torch.arange(T, device=x.device)
    src = src[:E * C]
    # index_select, not x[idx]: its backward is index_add_, where indexing
    # backward sorts and sums each row's duplicates in one serial loop, and
    # the zero rows here take every empty slot and every dropped token.
    x_pad = torch.cat([x, x.new_zeros(1, D)])
    expert_in = _keep(tape, "expert_in",
                      lambda: x_pad.index_select(0, src).view(E, C, D),
                      _gather_vjp, x_pad, src)
    down = _experts(expert_in, bp, cfg, shards)
    out = torch.cat([down.reshape(E * C, D),
                     down.new_zeros(1, D)]).index_select(0, row)
    y = gate.to(cd)[:, None] * out
    if shards is not None:
        y = shards.psum(y, shards.experts)
    return y.view(B, L, D)


def _dispatch_vjp(grad, dispatch, x):
    return None, torch.einsum("tec,ecd->td", dispatch, grad)


def _moe_ffn_onehot(h, bp, cfg: GPTConfig, tape: Optional[_Tape] = None,
                    shards=None):
    """The plain version of ``_moe_ffn``: the reference's one-hot
    dispatch [T, E, C] and its dispatch and combine einsums, line for
    line (``ray_tpu/models/transformer.py:265-303``), on one device."""
    if shards is not None:
        raise NotImplementedError("the one-hot MoE runs on one device")
    cd = cfg.dtype
    B, L, D = h.shape
    E = cfg.moe_experts
    x = h.reshape(-1, D)
    gate, expert, C = _route(x, bp, cfg, tape)
    mask = F.one_hot(expert, E).float()                    # [T, E]
    pos = torch.cumsum(mask, 0) * mask                     # 1-based slot
    mask = mask * (pos <= C)
    pos = (pos - 1.0) * mask                               # 0-based
    dispatch = mask[:, :, None] * F.one_hot(pos.long(), C).float()
    dispatch_cd = dispatch.to(cd)
    expert_in = _keep(
        tape, "expert_in",
        lambda: torch.einsum("tec,td->ecd", dispatch_cd, x),
        _dispatch_vjp, dispatch_cd, x)
    down = _experts(expert_in, bp, cfg)
    combine = (dispatch * gate[:, None, None]).to(cd)
    return torch.einsum("tec,ecd->td", combine, down).view(B, L, D)


def _block(x, bp, cfg: GPTConfig, positions, tape: Optional[_Tape] = None,
           shards=None):
    """One pre-LN transformer block. x: [B, L, D], positions [L] global;
    under a mesh (``shards``) every tensor is this rank's local shard."""
    cd = cfg.dtype
    b, l, d = x.shape
    h = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.eps)
    qkv = _project(h, bp["wqkv"].to(cd), bp["bqkv"].to(cd), tape, "qkv")
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if cfg.rotary:
        q, k = _rope(q, positions), _rope(k, positions)
    attn = _attention(q, k, v, cfg, shards)
    reduce = None
    if shards is not None and shards.heads:
        reduce = functools.partial(shards.psum, axes=shards.heads)
    proj = _project(attn.reshape(b, l, -1), bp["wo"].to(cd).reshape(-1, d),
                    bp["bo"].to(cd), tape, "attn_out", reduce)
    x = x + proj
    h = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.eps)
    return x + _ffn(h, bp, cfg, tape, shards)


# Block params that layer norm reads in f32; the rest feed bf16 products.
_LN_PARAMS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


def _layer_params(blocks: Params, cd: torch.dtype) -> List[Params]:
    """The stacked block params as one dict per layer, the weights and
    biases cast to the compute dtype once per step. A cast inside the block
    would run again in remat's recompute, and indexing a layer out of the
    stack would give each layer a backward that writes a full-size zero
    gradient; unbind's backward stacks the layers' gradients once."""
    split = {name: (w if name in _LN_PARAMS else w.to(cd)).unbind(0)
             for name, w in blocks.items()}
    n_layers = len(next(iter(split.values())))
    return [{name: ws[i] for name, ws in split.items()}
            for i in range(n_layers)]


def _run_blocks(x, layers: List[Params], cfg: GPTConfig, positions,
                shards=None):
    for bp in layers:
        if cfg.remat and torch.is_grad_enabled():
            x = _Remat.apply(cfg, positions, tuple(bp), shards, x,
                             *bp.values())
        else:
            x = _block(x, bp, cfg, positions, None, shards)
    return x


def _forward_local(params: Params, tokens: torch.Tensor, cfg: GPTConfig,
                   shards=None) -> torch.Tensor:
    """Logits [B, L, V] f32 of ``tokens``: the whole model on one device
    (``shards`` None) or this rank's shard of it under a mesh."""
    cd = cfg.dtype
    L = tokens.shape[1]
    start = shards.index(shards.seq) * L if shards is not None else 0
    positions = torch.arange(start, start + L, device=tokens.device)

    x = params["tok_embed"][tokens].to(cd)
    if not cfg.rotary:
        x = x + params["pos_embed"][start:start + L].to(cd)

    if shards is not None and shards.pp > 1:
        x = _pipeline(x, params["blocks"], cfg, shards)
    else:
        x = _run_blocks(x, _layer_params(params["blocks"], cd), cfg,
                        positions, shards)

    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.eps)
    return _lm_head(x, params["tok_embed"].to(cd))


def _pipeline(x, blocks: Params, cfg: GPTConfig, shards) -> torch.Tensor:
    """The blocks as a GPipe pipeline over pp (``pipeline.pipeline_body``),
    laid out as the reference's ``pipeline_apply`` lays them out: the
    microbatch stack [M, B/M, L, D] with B/M over dp and fsdp and nothing
    else sharded, each stage's blocks running unsharded (no mesh inside).
    This rank's batch and sequence shard is gathered into that layout and
    taken back out of it after."""
    from ray_tpu_torch.parallel.pipeline import pipeline_body

    x = shards.gather(shards.gather(x, shards.seq, 1), shards.batch, 0)
    B, L, D = x.shape
    M = cfg.pp_microbatches or shards.pp
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    data = shards.pipe_data
    x_mb = _split(x.reshape(M, B // M, L, D), 1, shards, data)
    positions = torch.arange(L, device=x.device)
    layers = _layer_params(blocks, cfg.dtype)

    def stage(layers, h):
        return _run_blocks(h, layers, cfg, positions)

    out = pipeline_body(stage, layers, x_mb, shards.mesh["pp"])
    out = shards.gather(out, data, 1).reshape(B, L, D)
    return _split(_split(out, 0, shards, shards.batch), 1, shards,
                  shards.seq)


def _split(x, dim: int, shards, axes):
    """This rank's chunk of ``x``'s ``dim`` over mesh dims ``axes``."""
    n = shards.size(axes)
    size = x.shape[dim] // n
    return x.narrow(dim, shards.index(axes) * size, size)


class _Shards:
    """A mesh as the model's local program sees it: the mesh dims (of more
    than one rank) that split the batch, the sequence, the heads, the FFN
    width and the experts under ``rules``; this rank's coordinate over
    them; their collectives."""

    def __init__(self, mesh, rules=None):
        from torch.distributed.device_mesh import DeviceMesh

        from ray_tpu_torch.parallel.mesh import axis_size
        from ray_tpu_torch.parallel.sharding import DEFAULT_RULES

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh),"
                            f" got {type(mesh).__name__}")
        rules = rules if rules is not None else DEFAULT_RULES
        self.mesh = mesh

        def axes(name):
            return tuple(a for a in rules.mesh_axes(mesh, name)
                         if axis_size(mesh, a) > 1)

        self.batch, self.seq = axes("batch"), axes("seq")
        self.heads, self.mlp = axes("heads"), axes("mlp")
        self.experts = axes("experts")
        self.pp = axis_size(mesh, "pp")
        # The pipeline shards its microbatches over dp and fsdp, whatever
        # "batch" maps to, as the reference's pipeline branch does.
        self.pipe_data = tuple(a for a in ("dp", "fsdp")
                               if axis_size(mesh, a) > 1)
        used = (self.batch + self.seq + self.experts
                + tuple(set(self.heads + self.mlp)) + (
                    ("pp",) if self.pp > 1 else ()))
        if len(set(used)) != len(used):
            raise ValueError(
                f"rules map two of batch {self.batch}, seq {self.seq}, "
                f"heads/mlp {self.heads}/{self.mlp}, experts "
                f"{self.experts} and pp to one mesh dim")
        self.ring = mesh[self.seq[0]] if len(self.seq) == 1 else None
        self._dims: Dict[tuple, Any] = {}

    def dims(self, axes):
        if axes not in self._dims:
            self._dims[axes] = self.mesh[axes]
        return self._dims[axes]

    def size(self, axes) -> int:
        from ray_tpu_torch.parallel.mesh import axis_size

        return math.prod(axis_size(self.mesh, a) for a in axes)

    def index(self, axes) -> int:
        """This rank's coordinate over ``axes``, the first outermost."""
        idx = 0
        for a in axes:
            idx = (idx * self.size((a,))
                   + self.mesh.get_local_rank(mesh_dim=a))
        return idx

    def psum(self, x, axes):
        return psum(x, self.dims(axes)) if axes else x

    def gather(self, x, axes, dim: int):
        return all_gather(x, self.dims(axes), dim) if axes else x

    def _entry(self, axes):
        return None if not axes else axes[0] if len(axes) == 1 else axes

    def token_spec(self):
        from ray_tpu_torch.parallel.sharding import PartitionSpec

        return PartitionSpec(self._entry(self.batch), self._entry(self.seq))

    def param_specs(self, cfg: GPTConfig) -> Params:
        """Each param's layout in the local program: the dims the body
        splits (heads, FFN width, experts) sharded, the rest whole (an
        "embed" shard over fsdp is gathered on the way in); under a
        pipeline the blocks' layers over pp and nothing else."""
        from ray_tpu_torch.parallel.sharding import PartitionSpec

        split = {"heads": self.heads, "mlp": self.mlp,
                 "experts": self.experts}

        def spec(axes, block):
            if self.pp > 1:
                return PartitionSpec("pp") if block else PartitionSpec()
            return PartitionSpec(*(self._entry(split.get(a, ()))
                                   for a in axes))

        return {k: ({n: spec(a, True) for n, a in v.items()}
                    if isinstance(v, dict) else spec(v, False))
                for k, v in param_logical_axes(cfg).items()}


def forward(params: Params, tokens: torch.Tensor, cfg: GPTConfig,
            *, mesh=None, rules=None):
    """Logits [B, L, V] f32 for token ids [B, L] (int64 or int32). Under
    ``mesh`` (a ``DeviceMesh`` from ``parallel.make_mesh``; ``rules``
    default ``sharding.DEFAULT_RULES``) ``params`` are DTensors
    (``shard_params``), ``tokens`` the whole batch on every rank or a
    DTensor, and the logits a DTensor sharded over batch and sequence.
    Collective over the mesh."""
    if mesh is None:
        return _forward_local(params, tokens, cfg)
    from ray_tpu_torch.parallel.collective import shard_map_compat
    from ray_tpu_torch.parallel.sharding import PartitionSpec

    shards = _Shards(mesh, rules)
    tok = shards.token_spec()
    fn = shard_map_compat(
        lambda p, t: _forward_local(p, t, cfg, shards), mesh=mesh,
        in_specs=(shards.param_specs(cfg), tok),
        out_specs=PartitionSpec(*tok, None))
    return fn(params, tokens)


def _lm_head(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Tied LM head: f32 logits [B, L, V] from x [B, L, D] and the
    embedding [V, D], both in the compute dtype, with the products summed
    and returned in f32 (no rounding of the logits to the compute dtype)."""
    b, l, d = x.shape
    x2 = x.reshape(b * l, d)
    if x.dtype == torch.float32:
        logits = torch.mm(x2, embed.t())
    else:
        logits = _F32Logits.apply(x2, embed)
    return logits.reshape(b, l, -1)


class _F32Logits(torch.autograd.Function):
    """x2 [N, D] @ embed [V, D]^T in f32 from low-precision operands. On
    CUDA one cuBLAS call with an f32 output (``aten::mm.dtype``, which has
    no derivative of its own); the CPU has no kernel for it, so there the
    operands are upcast, which is the same arithmetic. The backward rounds
    the f32 cotangent to the operands' dtype and multiplies in it, as a
    TPU's default-precision product of the reference's transpose does."""

    @staticmethod
    def forward(ctx, x2, embed):
        ctx.save_for_backward(x2, embed)
        if x2.is_cuda:
            return torch.mm(x2, embed.t(), out_dtype=torch.float32)
        return torch.mm(x2.float(), embed.float().t())

    @staticmethod
    def backward(ctx, g):
        x2, embed = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ embed, g.t() @ x2


def _token_losses(logits, targets):
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - tgt


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: GPTConfig,
            *, mesh=None, rules=None) -> torch.Tensor:
    """Mean next-token cross entropy. batch: inputs/targets [B, L] ints.
    Under ``mesh`` (see ``forward``) the whole batch's mean, the same
    tensor on every rank; collective over the mesh."""
    if mesh is None:
        logits = forward(params, batch["inputs"], cfg)
        return _token_losses(logits, batch["targets"]).mean()
    from ray_tpu_torch.parallel.collective import shard_map_compat
    from ray_tpu_torch.parallel.sharding import PartitionSpec

    shards = _Shards(mesh, rules)
    data = shards.batch + shards.seq

    def body(p, inputs, targets):
        logits = _forward_local(p, inputs, cfg, shards)
        total = shards.psum(_token_losses(logits, targets).sum(), data)
        return total / (targets.numel() * shards.size(data))

    tok = shards.token_spec()
    fn = shard_map_compat(body, mesh=mesh,
                          in_specs=(shards.param_specs(cfg), tok, tok),
                          out_specs=PartitionSpec())
    return fn(params, batch["inputs"], batch["targets"]).to_local()


# ---------------------------------------------------------------------------
# Training


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: torch.optim.Optimizer


OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def _local(p: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor backing it), else ``p``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return p
    with torch.no_grad():
        return p.to_local()


def new_train_state(params: Params,
                    optimizer: OptimizerFactory) -> TrainState:
    """``optimizer`` over ``params``. For DTensor params it steps each
    rank's local shards, the tensors backing the DTensors: the update is
    elementwise, and DTensor's own dispatch would plan every op of every
    param over the mesh (minutes a step on a 6-dim mesh on the CPU)."""
    return TrainState(step=0, params=params,
                      opt_state=optimizer([_local(p)
                                           for p in tree_leaves(params)]))


def make_train_state(cfg: GPTConfig, optimizer: OptimizerFactory, *,
                     generator: torch.Generator,
                     device: DeviceLike = None, mesh=None,
                     rules=None) -> TrainState:
    """Fresh params (``init_params``) and ``optimizer(params)``, e.g.
    ``functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.1)``.
    Pass ``weight_decay`` explicitly: torch's AdamW defaults to 1e-2,
    optax's ``adamw`` to 1e-4. Under ``mesh`` every rank draws the same
    params from its ``generator`` and keeps its shards (``shard_params``,
    ``new_train_state``)."""
    params = init_params(cfg, generator=generator, device=device)
    if mesh is not None:
        params = shard_params(params, cfg, mesh, rules)
    return new_train_state(params, optimizer)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all ``grads`` in f32; for DTensors the whole
    tensors' norm, the same on every rank (collective over the dims that
    shard them)."""
    from torch.distributed.tensor import DTensor

    grads = list(grads)
    if not grads or not isinstance(grads[0], DTensor):
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    mesh = grads[0].device_mesh
    by_dims: Dict[tuple, List[torch.Tensor]] = {}
    for g in grads:
        dims = tuple(mesh.mesh_dim_names[i]
                     for i, p in enumerate(g.placements) if p.is_shard())
        by_dims.setdefault(dims, []).append(
            torch.linalg.vector_norm(g.to_local().float()).square())
    total = sum(psum(torch.stack(sq).sum(), mesh[dims]) if dims
                else torch.stack(sq).sum() for dims, sq in by_dims.items())
    return total.sqrt()


def make_train_step(cfg: GPTConfig, *, mesh=None, rules=None):
    """Build a ``(state, batch) -> (state, metrics)`` step. The optimizer
    updates ``state.params`` in place; metrics hold the loss at the params
    the step started from and the global gradient norm. Under ``mesh`` the
    gradients come back laid out as the params (the body's edges reduce
    them), so the step adds no collective of its own."""

    def train_step(state: TrainState, batch):
        opt = state.opt_state
        leaves = tree_leaves(state.params)
        opt.zero_grad(set_to_none=True)
        for p in leaves:
            p.grad = None
        loss = loss_fn(state.params, batch, cfg, mesh=mesh, rules=rules)
        loss.backward()
        gnorm = global_norm(p.grad for p in leaves)
        for p in leaves:
            if p is not _local(p):
                _local(p).grad = _local(p.grad)
        opt.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step
