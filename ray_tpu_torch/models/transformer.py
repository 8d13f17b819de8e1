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

What changes: ``lax.scan`` over the stacked layers is a Python loop; the
train step updates params in place with a ``torch.optim`` optimizer. Mesh
sharding, ring attention and pipeline parallelism need more than one
device, belong to later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import mha_reference
from ray_tpu_torch.ops.flash_attention import flash_attention

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
    ring_attention: bool = False   # not ported: needs collectives
    eps: float = 1e-5
    # Switch top-1 mixture of experts (0 = dense): tokens past each
    # expert's capacity C = max(1, int(cf * T / E)) of a call's T tokens
    # are dropped (FFN output 0), so the rows of a batch share capacity.
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    pp_microbatches: Optional[int] = None   # not ported
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


def _check_supported(cfg: GPTConfig, mesh=None, rules=None) -> None:
    """Raise for what the reference supports and this slice does not."""
    if mesh is not None or rules is not None:
        raise NotImplementedError("mesh sharding is not ported yet")
    if cfg.ring_attention:
        raise NotImplementedError("ring attention is not ported yet")
    if cfg.pp_microbatches is not None:
        raise NotImplementedError("pipeline parallelism is not ported yet")
    if cfg.remat and cfg.remat_policy not in _REMAT_KEEPS:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


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


def _attention(q, k, v, cfg: GPTConfig):
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


def _project(a, w, b, tape: Optional[_Tape] = None, name: str = ""):
    """``a @ w + b`` for a [..., K], w [K, *out] and b [*out] (or None):
    the reference's einsum as one matmul over the flattened out axes. A
    remat policy may keep it as ``name`` after the bias or ``name + ".dot"``
    before it."""
    def product():
        return (a @ w.reshape(w.shape[0], -1)).view(*a.shape[:-1],
                                                     *w.shape[1:])

    def dot():
        return _keep(tape, name + ".dot", product, _product_vjp, a, w)

    if b is None:
        return dot()
    return _keep(tape, name, lambda: dot() + b, _product_vjp, a, w, b)


class _Remat(torch.autograd.Function):
    """One block under ``cfg.remat_policy``: the forward runs without a
    graph and keeps the block's input, its params and the policy's tensors
    (``_REMAT_KEEPS``); backward recomputes the block from them and
    backpropagates through the recompute."""

    @staticmethod
    def forward(ctx, cfg, positions, names, x, *weights):
        tape = _Tape(_REMAT_KEEPS[cfg.remat_policy])
        out = _block(x, dict(zip(names, weights)), cfg, positions, tape)
        ctx.cfg, ctx.positions, ctx.names = cfg, positions, names
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
                         ctx.cfg, ctx.positions, tape)
        grads = torch.autograd.grad(out, inputs, grad, allow_unused=True)
        return (None, None, None, *grads)


# ---------------------------------------------------------------------------
# The FFN: dense, or Switch top-1 mixture of experts.


def _ffn(h, bp, cfg: GPTConfig, tape: Optional[_Tape] = None):
    if cfg.moe_experts:
        return _moe_ffn(h, bp, cfg, tape)
    cd = cfg.dtype
    up = _project(h, bp["w_up"].to(cd), bp["b_up"].to(cd), tape, "mlp_up")
    # jax.nn.gelu's default is the tanh approximation.
    up = F.gelu(up, approximate="tanh")
    return up @ bp["w_down"].to(cd) + bp["b_down"].to(cd)


def _route(x, bp, cfg: GPTConfig, tape: Optional[_Tape]):
    """Top-1 routing of x [T, D]: (gate [T] f32, expert [T], capacity C).
    The router logits are a product in the compute dtype, the softmax runs
    in f32; the gate is the top probability (``amax`` shares the gradient
    among ties, as ``jnp.max``) and the expert its first index
    (``argmax``, as ``jnp.argmax``)."""
    E = cfg.moe_experts
    C = max(1, int(cfg.moe_capacity_factor * x.shape[0] / E))
    logits = _project(x, bp["wg"].to(cfg.dtype), None, tape, "router")
    gates = torch.softmax(logits.float(), dim=-1)
    return gates.amax(-1), gates.argmax(-1), C


def _experts(expert_in, bp, cfg: GPTConfig):
    """Each expert's FFN on its slots, expert_in [E, C, D] -> [E, C, D]."""
    cd = cfg.dtype
    up = torch.bmm(expert_in, bp["w_up"].to(cd)) + bp["b_up"].to(cd)[:, None]
    up = F.gelu(up, approximate="tanh")
    return (torch.bmm(up, bp["w_down"].to(cd))
            + bp["b_down"].to(cd)[:, None])


def _gather_vjp(grad, x_pad, src):
    dx = torch.zeros_like(x_pad).index_add_(
        0, src, grad.reshape(-1, x_pad.shape[1]))
    return dx, None


def _moe_ffn(h, bp, cfg: GPTConfig, tape: Optional[_Tape] = None):
    """The reference's ``_moe_ffn`` (Switch top-1, GShard capacity) by
    index. A token's slot is its rank among the tokens routed to its
    expert, counted in flattened [B*L] order; tokens past the capacity C
    are dropped (output 0, the residual carries them). Each kept token's
    row is copied into its [E, C, D] slot, the experts run as batched
    products, and each token takes its slot's output times its gate
    rounded to the compute dtype: the reference's dispatch and combine
    einsums, without their [T, E, C] one-hot tensors and their products."""
    cd = cfg.dtype
    B, L, D = h.shape
    E = cfg.moe_experts
    x = h.reshape(-1, D)
    T = x.shape[0]
    gate, expert, C = _route(x, bp, cfg, tape)
    # Running count of each expert's tokens, scanned along the contiguous
    # token axis of [E, T]: a scan down the E columns of [T, E] runs on too
    # few threads (34 ms of a gpt2-125m-moe8 train step on an NVIDIA H100
    # 80GB HBM3 at 700.00 W; PERF.md, PR 5).
    counts = (expert == torch.arange(E, device=x.device)[:, None]).cumsum(1)
    rank = counts.gather(0, expert[None])[0] - 1
    # Each token's slot row in [E*C], or the zero row E*C when dropped.
    row = torch.where(rank < C, expert * C + rank, E * C)
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
    down = _experts(expert_in, bp, cfg)
    out = torch.cat([down.reshape(E * C, D),
                     down.new_zeros(1, D)]).index_select(0, row)
    return (gate.to(cd)[:, None] * out).view(B, L, D)


def _dispatch_vjp(grad, dispatch, x):
    return None, torch.einsum("tec,ecd->td", dispatch, grad)


def _moe_ffn_onehot(h, bp, cfg: GPTConfig, tape: Optional[_Tape] = None):
    """The plain version of ``_moe_ffn``: the reference's one-hot
    dispatch [T, E, C] and its dispatch and combine einsums, line for
    line (``ray_tpu/models/transformer.py:265-303``)."""
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


def _block(x, bp, cfg: GPTConfig, positions, tape: Optional[_Tape] = None):
    """One pre-LN transformer block. x: [B, L, D]."""
    cd = cfg.dtype
    b, l, d = x.shape
    h = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.eps)
    qkv = _project(h, bp["wqkv"].to(cd), bp["bqkv"].to(cd), tape, "qkv")
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if cfg.rotary:
        q, k = _rope(q, positions), _rope(k, positions)
    attn = _attention(q, k, v, cfg)
    proj = _project(attn.reshape(b, l, -1), bp["wo"].to(cd).reshape(-1, d),
                    bp["bo"].to(cd), tape, "attn_out")
    x = x + proj
    h = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.eps)
    return x + _ffn(h, bp, cfg, tape)


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


def forward(params: Params, tokens: torch.Tensor, cfg: GPTConfig,
            *, mesh=None, rules=None) -> torch.Tensor:
    """Logits [B, L, V] f32 for token ids [B, L] (int64 or int32)."""
    _check_supported(cfg, mesh, rules)
    cd = cfg.dtype
    L = tokens.shape[1]
    positions = torch.arange(L, device=tokens.device)

    x = params["tok_embed"][tokens].to(cd)
    if not cfg.rotary:
        x = x + params["pos_embed"][:L].to(cd)

    for bp in _layer_params(params["blocks"], cd):
        if cfg.remat and torch.is_grad_enabled():
            x = _Remat.apply(cfg, positions, tuple(bp), x, *bp.values())
        else:
            x = _block(x, bp, cfg, positions)

    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.eps)
    return _lm_head(x, params["tok_embed"].to(cd))


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


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: GPTConfig,
            *, mesh=None, rules=None) -> torch.Tensor:
    """Mean next-token cross entropy. batch: inputs/targets [B, L] ints."""
    logits = forward(params, batch["inputs"], cfg, mesh=mesh, rules=rules)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch["targets"][..., None].long())[..., 0]
    return (logz - tgt).mean()


# ---------------------------------------------------------------------------
# Training


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: torch.optim.Optimizer


OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def make_train_state(cfg: GPTConfig, optimizer: OptimizerFactory, *,
                     generator: torch.Generator,
                     device: DeviceLike = None) -> TrainState:
    """Fresh params (``init_params``) and ``optimizer(params)``, e.g.
    ``functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.1)``.
    Pass ``weight_decay`` explicitly: torch's AdamW defaults to 1e-2,
    optax's ``adamw`` to 1e-4."""
    params = init_params(cfg, generator=generator, device=device)
    return TrainState(step=0, params=params,
                      opt_state=optimizer(tree_leaves(params)))


def make_train_step(cfg: GPTConfig):
    """Build a ``(state, batch) -> (state, metrics)`` step. The optimizer
    updates ``state.params`` in place; metrics hold the loss at the params
    the step started from and the global gradient norm."""

    def train_step(state: TrainState, batch):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, batch, cfg)
        loss.backward()
        grads = [p.grad for p in tree_leaves(state.params)]
        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        opt.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step
