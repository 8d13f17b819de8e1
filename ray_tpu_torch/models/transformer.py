"""GPT-family decoder transformer (port of ``ray_tpu/models/transformer.py``,
the dense single-device path).

Kept from the reference:

- **Plain-dict params** with the reference's names and layouts: block
  params stacked on a leading ``layers`` dim, ``wqkv`` [L, D, 3, H, Dh],
  ``wo`` [L, H, Dh, D]. ``models.convert.params_from_numpy`` carries JAX
  params over by name alone.
- **bf16 compute, f32 master params**: params live in ``param_dtype``
  and are cast to ``dtype`` for use, once per step; layer norm runs in f32.
- **Remat**: ``remat_policy="full"`` checkpoints each block
  (``torch.utils.checkpoint``), so backward recomputes it, flash-attention
  forward included.
- **f32 logits**: the tied LM head multiplies operands in ``dtype`` and
  keeps the f32 sums as logits (the reference's
  ``preferred_element_type=float32``).

What changes: ``lax.scan`` over the stacked layers is a Python loop; the
train step updates params in place with a ``torch.optim`` optimizer. Mesh
sharding, ring attention, MoE, pipeline parallelism and the
``"matmuls"``/``"dots"`` remat policies belong to later slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    # "full" recomputes each block in backward; "matmuls" and "dots" are
    # the reference's selective policies, not ported yet.
    remat_policy: str = "full"
    ring_attention: bool = False   # not ported: needs collectives
    eps: float = 1e-5
    moe_experts: int = 0           # not ported: 0 = dense
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
    if cfg.moe_experts:
        raise NotImplementedError("MoE FFN is not ported yet")
    if cfg.pp_microbatches is not None:
        raise NotImplementedError("pipeline parallelism is not ported yet")
    if cfg.remat and cfg.remat_policy != "full":
        if cfg.remat_policy in ("matmuls", "dots"):
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r} is not ported yet")
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
            "w_up": norm(L, D, Fd),
            "b_up": zeros(L, Fd),
            "w_down": norm(L, Fd, D, s=res_std),
            "b_down": zeros(L, D),
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


def _ffn(h, bp, cfg: GPTConfig):
    cd = cfg.dtype
    up = h @ bp["w_up"].to(cd) + bp["b_up"].to(cd)
    # jax.nn.gelu's default is the tanh approximation.
    up = F.gelu(up, approximate="tanh")
    return up @ bp["w_down"].to(cd) + bp["b_down"].to(cd)


def _block(x, bp, cfg: GPTConfig, positions):
    """One pre-LN transformer block. x: [B, L, D]."""
    cd = cfg.dtype
    b, l, d = x.shape
    # The reference's einsums, as matmuls over flattened head axes: each is
    # one cuBLAS call with fewer ops around it for the host to launch.
    h = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.eps)
    wqkv = bp["wqkv"].to(cd)
    qkv = ((h @ wqkv.reshape(d, -1)).view(b, l, *wqkv.shape[1:])
           + bp["bqkv"].to(cd))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if cfg.rotary:
        q, k = _rope(q, positions), _rope(k, positions)
    attn = _attention(q, k, v, cfg)
    wo = bp["wo"].to(cd)
    proj = attn.reshape(b, l, -1) @ wo.reshape(-1, d) + bp["bo"].to(cd)
    x = x + proj
    h = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.eps)
    return x + _ffn(h, bp, cfg)


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
        if cfg.remat:
            x = checkpoint(_block, x, bp, cfg, positions, use_reentrant=False)
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
