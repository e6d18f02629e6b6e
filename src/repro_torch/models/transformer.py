"""Model substrate (counterpart of ``repro.models.transformer``) at ring
degree 1: parameter trees, the dense attention block and the MLP block.

The parameter tree keeps the reference's layout and names, so weights
convert leaf for leaf: ``embed [Vp, D]``, ``final_ln [D]``,
``lm_head [D, Vp]`` (untied heads) and ``layers/u<pos>/<name>`` stacked on
a leading rep axis; weights are ``[in, out]``.

Zamba2's shared attention+MLP block (layer kind ``S``) keeps one
unstacked parameter set under ``shared``, used by every ``S`` slot.

In the ``prefill``/``train`` phases every linear runs through
:func:`repro_torch.core.tatp.tatp_matmul` on the hand-written GEMM,
self-attention on the hand-written flash kernel and the Mamba-2 SSD
intra-chunk pass on the hand-written SSD kernel; ``RunCtx.dot``,
``RunCtx.attention`` and ``RunCtx.ssd`` hold those three hooks (parity
checks swap in the plain versions).  Decode linears, decode attention and
the SSM decode step are plain torch, as in the reference.

MoE models (``cfg.is_moe``) replace the MLP of every ``G``/``L`` slot with
:func:`moe_block` (:mod:`repro_torch.models.moe`); their expert leaves are
``mlp.w_up``/``mlp.w_gate`` ``[E, D, F]``, ``mlp.w_down`` ``[E, F, D]`` and
``mlp.router`` ``[D, E]``.

An encoder-decoder (``cfg.n_enc_layers``) adds the encoder's blocks under
``enc`` (bidirectional self-attention + MLP, ``bidir_self``) and one
cross-attention block (layer kind ``X``: the attention leaves only) per
decoder rep under ``cross`` (:func:`attn_block` with ``is_cross``).

Above model degree 1 (strategy ``tatp``) each rank holds the shards
:func:`param_specs` gives it (the K-block of every weight, a vocab block
of the embedding and head).  ``train`` and ``prefill`` are
sequence-sharded: every
linear is the TATP ring (:func:`repro_torch.core.tatp.tatp_matmul`, each
round's tile on the ``dot`` hook) and self-attention the ring attention
(:func:`repro_torch.models.attention.ring_attention`, each round on the
``attention`` hook) at the rank's global positions.  ``decode`` is
column-parallel: each linear's local block, then an all-gather of the
columns (:func:`_gather_cols`); the K/V cache stays sequence-sharded.

MoE blocks above degree 1 (``tatp``) are expert-parallel: each rank
holds ``E / R`` experts and the slots reach their owners by an all-to-all
(:func:`repro_torch.models.moe.moe_ffn`).  The Mamba-2 block runs over
the ring (:func:`mamba_block`).

``megatron`` above degree 1 (the reference's tensor-parallel baseline):
the tokens are replicated over ``model``; ``wq`` (with ``wk``/``wv``
from 16 kv heads up), ``w_up`` and ``w_gate`` are column-parallel and
``wo`` and ``w_down`` row-parallel, each rank's product one local tile on
the GEMM hook (the degree-1 TATP linear, no ring), the row-parallel
output psummed; below 16 kv heads ``wk``/``wv`` are replicated and each
rank takes its kv group's columns; attention runs over the rank's ``hq /
R`` heads on the ``attention`` hook, causal over the whole sequence.
The forward is the reference's; its gradients are the degree-1 ones, by
Megatron's conjugate operators (:meth:`Dist.id_psum_bwd` at the input of
each column-parallel group, :meth:`Dist.psum_id_bwd` after each
row-parallel product), where the reference's psums transpose to psums
and scale its sharded gradients by R (ROADMAP.md C).  ``megatron`` and
``fsdp`` at degree 1 compute what ``tatp`` does (:func:`_linear`).

What the reference itself cannot run raises ``NotImplementedError``
naming ROADMAP.md C5 (:func:`check_strategy`): ``fsdp`` above degree 1,
and under ``megatron`` above degree 1 the decode, fewer kv heads than
ranks (below 16), MoE and Mamba-2 layers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch import not_ported
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import tatp
from repro_torch.core.dist import Dist
from repro_torch.kernels.flash_attention.ops import attention as flash
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.kernels.tatp_matmul.ops import tatp_dot
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (act_fn, apply_rope, dense_init,
                                       embed_init, is_gated, rms_norm)

VOCAB_PAD_MULTIPLE = 512
CONV_K = 4  # mamba2 depthwise conv width


def padded_vocab(cfg: ModelConfig) -> int:
    m = VOCAB_PAD_MULTIPLE
    return ((cfg.vocab_size + m - 1) // m) * m


@dataclass(frozen=True)
class RunCtx:
    cfg: ModelConfig
    par: ParallelConfig
    dist: Dist
    phase: str = "train"  # train | prefill | decode
    # kernel hooks: the GEMM under every prefill/train linear, the
    # prefill/train self-attention core ([B, H, S, D] layout) and the
    # chunked SSD of the prefill/train Mamba-2 blocks
    dot: Callable = tatp_dot
    attention: Callable = flash
    ssd: Callable = ssd_chunked
    # if a list, every MoE block appends its moe.Routing (expert ids, keep
    # mask, capacity), so a check can compare two runs' routing
    routing: Optional[list] = None

    @property
    def axis(self) -> str:
        return self.dist.model_axis

    @property
    def r(self) -> int:
        return self.dist.model_degree

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    @property
    def device(self) -> torch.device:
        return self.dist.device


# ===========================================================================
# parameter initialisation
# ===========================================================================


def _attn_shapes(cfg: ModelConfig):
    d = cfg.d_model
    sh = {
        "wq": (d, cfg.q_dim),
        "wk": (d, cfg.kv_dim),
        "wv": (d, cfg.kv_dim),
        "wo": (cfg.q_dim, d),
        "ln": (d,),
    }
    if cfg.qkv_bias:
        sh.update(bq=(cfg.q_dim,), bk=(cfg.kv_dim,), bv=(cfg.kv_dim,))
    return sh


def _mlp_shapes(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    sh = {"w_up": (d, f), "w_down": (f, d), "ln": (d,)}
    if is_gated(cfg.act):
        sh["w_gate"] = (d, f)
    return sh


def _moe_shapes(cfg: ModelConfig):
    sh = dict(moe_lib.moe_param_shapes(cfg, cfg.n_experts))
    sh["ln"] = (cfg.d_model,)
    return sh


def _mamba_shapes(cfg: ModelConfig):
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dip = 2 * di + 2 * n + nh
    conv_dim = di + 2 * n
    return {
        "in_proj": (d, dip),
        "conv_w": (CONV_K, conv_dim),
        "conv_b": (conv_dim,),
        "a_log": (nh,),
        "d_skip": (nh,),
        "dt_bias": (nh,),
        "out_proj": (di, d),
        "ln": (d,),
        "gln": (di,),  # gated RMSNorm scale before out_proj
    }


def _block_shapes(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("G", "L", "S"):  # S: zamba2's shared attention+MLP block
        sh = dict(_attn_shapes(cfg))
        moe = cfg.is_moe and kind != "S"
        mlp = _moe_shapes(cfg) if moe else _mlp_shapes(cfg)
        sh.update({f"mlp.{k}": v for k, v in mlp.items()})
        return sh
    if kind == "M":
        return _mamba_shapes(cfg)
    if kind == "X":  # attention-only (the decoder's cross-attention) block
        return dict(_attn_shapes(cfg))
    raise ValueError(kind)


def _unit_and_reps(cfg: ModelConfig) -> tuple[str, int]:
    unit = cfg.layer_pattern
    if cfg.n_layers % len(unit):
        raise ValueError(
            f"{cfg.name}: n_layers {cfg.n_layers} not a multiple of "
            f"pattern {unit!r}"
        )
    return unit, cfg.n_layers // len(unit)


def _stacked(cfg: ModelConfig, kind: str, n: int) -> dict:
    return {name: (n, *shape) for name, shape in
            _block_shapes(cfg, kind).items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's leaf shapes (no allocation).  An
    encoder-decoder also has ``enc`` (``blocks``: ``n_enc_layers``
    stacked attention + MLP blocks, and its own ``final_ln``) and
    ``cross`` (one cross-attention block per decoder rep, stacked)."""
    vp = padded_vocab(cfg)
    unit, reps = _unit_and_reps(cfg)
    shapes: dict[str, Any] = {
        "embed": (vp, cfg.d_model),
        "final_ln": (cfg.d_model,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, vp)
    shapes["layers"] = {f"u{pos}": _stacked(cfg, kind, reps)
                        for pos, kind in enumerate(unit) if kind != "S"}
    if "S" in unit:  # shared blocks are not stacked
        shapes["shared"] = _block_shapes(cfg, "S")
    if cfg.n_enc_layers:
        shapes["enc"] = {"blocks": _stacked(cfg, "G", cfg.n_enc_layers),
                         "final_ln": (cfg.d_model,)}
        shapes["cross"] = _stacked(cfg, "X", reps)
    return shapes


# ===========================================================================
# sharding specs: per leaf, the mesh axis (or None) of each dim
# ===========================================================================


def _block_specs(cfg: ModelConfig, kind: str, strategy: str,
                 stacked: bool) -> dict:
    """The reference's ``_block_specs``: a spec is a tuple naming, for each
    dim of the leaf, the mesh axis that shards it (or None)."""
    mx = "model"
    specs = {}
    for name, shape in _block_shapes(cfg, kind).items():
        nd = len(shape)
        if strategy == "fsdp":
            specs[name] = (mx,) + (None,) * (nd - 1)
        elif name.endswith("ln") or nd == 1 or name == "conv_w" \
                or name == "mlp.router":
            specs[name] = (None,) * nd
        elif name.startswith("mlp.w_") and cfg.is_moe and kind in ("G",
                                                                   "L"):
            specs[name] = (mx, None, None)  # expert-sharded [E, D, F]
        elif strategy == "megatron" and name in ("wo", "mlp.w_down",
                                                 "out_proj"):
            specs[name] = (mx,) + (None,) * (nd - 1)  # row-parallel
        elif strategy == "megatron" and name in ("wk", "wv") \
                and cfg.n_kv_heads and cfg.n_kv_heads < 16:
            specs[name] = (None,) * nd  # kv replicated
        else:
            specs[name] = (None,) * (nd - 1) + (mx,)  # column block
    if stacked:
        specs = {k: (None, *v) for k, v in specs.items()}
    return specs


def param_specs(cfg: ModelConfig, strategy: str = "tatp") -> dict:
    """Each leaf's sharding over the ``(data, model)`` mesh, in
    :func:`param_shapes`' layout (the reference's ``param_specs``): the
    embedding's vocab rows and the head's vocab columns over ``model``,
    and per block its weights' output columns (``tatp``)."""
    unit, _ = _unit_and_reps(cfg)
    specs: dict[str, Any] = {"embed": ("model", None), "final_ln": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "model")
    specs["layers"] = {f"u{pos}": _block_specs(cfg, kind, strategy, True)
                       for pos, kind in enumerate(unit) if kind != "S"}
    if "S" in unit:
        specs["shared"] = _block_specs(cfg, "S", strategy, False)
    if cfg.n_enc_layers:
        specs["enc"] = {"blocks": _block_specs(cfg, "G", strategy, True),
                        "final_ln": (None,)}
        specs["cross"] = _block_specs(cfg, "X", strategy, True)
    return specs


def _init_leaf(name, shape, generator, dtype, device):
    """One (unstacked) leaf by the reference's rules
    (``repro.models.transformer._init_block``)."""
    if name.endswith("ln"):  # norm scales, gated-norm scale included
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "a_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[0],
                                        device=device)).to(dtype)
    if name == "d_skip":
        return torch.ones(shape, dtype=dtype, device=device)
    if name == "dt_bias":  # inverse softplus of a log-uniform [1e-3, 1e-1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        return torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u))).to(
            dtype)
    if len(shape) == 1:  # biases (bq/bk/bv, conv_b)
        return torch.zeros(shape, dtype=dtype, device=device)
    return dense_init(generator, shape, in_dim=shape[-2], dtype=dtype,
                      device=device)


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Random parameters with the reference's shapes and distributions:
    norm scales and biases zero, weights normal x 1/sqrt(fan_in) (the conv
    taps' fan-in is ``CONV_K``), the embedding normal x 0.02, and the SSM
    leaves ``a_log = log(linspace(1, 16))``, ``d_skip = 1`` and
    ``dt_bias`` the inverse softplus of a log-uniform draw in
    [1e-3, 1e-1].  (The draws differ from the reference's: JAX keys cannot
    be replayed in torch; ``weights.params_from_jax`` converts the
    reference's own tree where bit-equal weights are needed.)"""
    dtype = getattr(torch, cfg.dtype)
    shapes = param_shapes(cfg)

    def kw():
        return dict(dtype=dtype, device=device)

    d = cfg.d_model
    params: dict[str, Any] = {
        "embed": embed_init(generator, shapes["embed"], **kw()),
        "final_ln": torch.zeros(shapes["final_ln"], **kw()),
    }
    if "lm_head" in shapes:
        params["lm_head"] = dense_init(generator, shapes["lm_head"],
                                       in_dim=d, **kw())
    def stacked(block):
        out = {}
        for name, shape in sorted(block.items()):
            w = torch.empty(shape, **kw())
            for i in range(shape[0]):  # one rep at a time: small staging
                w[i] = _init_leaf(name, shape[1:], generator, **kw())
            out[name] = w
        return out

    params["layers"] = {unit: stacked(block)
                        for unit, block in shapes["layers"].items()}
    if "shared" in shapes:
        params["shared"] = {
            name: _init_leaf(name, shape, generator, **kw())
            for name, shape in sorted(shapes["shared"].items())
        }
    if "enc" in shapes:
        params["enc"] = {"blocks": stacked(shapes["enc"]["blocks"]),
                         "final_ln": torch.zeros(d, **kw())}
        params["cross"] = stacked(shapes["cross"])
    return params


# ===========================================================================
# building blocks
# ===========================================================================


def check_strategy(cfg: ModelConfig, strategy: str, r: int,
                   phase: str = "train") -> None:
    """Raise ``NotImplementedError`` naming ROADMAP.md C5 where the
    reference itself cannot run ``strategy`` at model degree ``r`` in
    ``phase`` (probed on fake devices): ``fsdp`` above degree 1 (its specs
    shard the norm scales' dim 0 too), and under ``megatron`` above degree
    1 the decode (its prefill's head-sharded K/V under a
    sequence-sharded cache layout), replicated kv heads (below 16) fewer
    than the ranks, MoE layers (an expert-sharded FFN at axis size 1) and
    Mamba-2 layers.  There is nothing to port there.  Called before any
    collective."""
    if r <= 1 or strategy == "tatp":
        return
    what = None
    if strategy == "fsdp":
        what = "strategy 'fsdp' above model degree 1"
    elif strategy != "megatron":
        raise ValueError(f"unknown strategy {strategy!r}")
    elif phase == "decode":
        what = "the 'megatron' decode above model degree 1"
    elif cfg.is_moe:
        what = "MoE layers under 'megatron' above model degree 1"
    elif "M" in cfg.layer_pattern:
        what = "Mamba-2 layers under 'megatron' above model degree 1"
    elif cfg.n_kv_heads < 16 and cfg.n_kv_heads < r:
        what = (f"{cfg.n_kv_heads} replicated kv heads over {r} ranks "
                f"under 'megatron'")
    if what is not None:
        raise not_ported(what, "C5")


def _megatron(ctx: RunCtx) -> bool:
    """Tensor parallelism over the ring (``megatron`` above degree 1)."""
    return ctx.par.strategy == "megatron" and ctx.r > 1


def _linear(ctx: RunCtx, x, w, b=None):
    """Phase-aware linear.  x: [B, s, in].

    At model degree 1 the three strategies compute one product: the
    reference's ``megatron`` and ``fsdp`` branches are a local einsum in
    fp32 cast to x's dtype (fsdp's weight all-gather and megatron's
    row-parallel psum and head split are identities at r = 1), which is
    the TATP linear's one local tile, so all three take the GEMM hook.
    Above degree 1: ``megatron``'s column- or row-parallel product is
    that one local tile too (the caller psums a row-parallel output);
    ``tatp`` in decode takes the rank's column block (the caller gathers
    the columns, :func:`_gather_cols`, and a bias is sliced to the block),
    otherwise the TATP ring over the sequence-sharded rows, every round's
    tile on the GEMM hook.  Only ``tatp``'s outputs are saved under the
    ``tatp_outputs`` policy, as the reference names only those."""
    check_strategy(ctx.cfg, ctx.par.strategy, ctx.r, ctx.phase)
    if ctx.phase == "decode":
        # plain product (the reference's einsum accumulates in fp32 and
        # casts to x.dtype; cuBLAS accumulates bf16 products in fp32)
        y = torch.matmul(x, w)
    else:  # the TATP linear on the GEMM hook: one local tile but above
        # degree 1 under tatp, where it streams the ring
        bsz, s, din = x.shape
        xf = x.reshape(bsz * s, din)
        streamed = ctx.par.strategy == "tatp"
        yf = tatp.tatp_matmul(xf, w, ctx.axis, ctx.r if streamed else 1,
                              ctx.par.bidirectional, ctx.par.stream_dtype,
                              dot=ctx.dot, dist=ctx.dist, save=streamed)
        y = yf.reshape(bsz, s, -1)
    if b is not None:
        if y.shape[-1] != b.shape[0]:  # column-parallel: the local block
            blk = b.shape[0] // ctx.r
            i = ctx.dist.axis_index(ctx.axis)
            b = b[i * blk:(i + 1) * blk]
        y = y + b
    return y


def _gather_cols(ctx: RunCtx, y):
    """All-gather a column-parallel output to full width (decode)."""
    return ctx.dist.all_gather(y, ctx.axis, dim=-1)


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def attn_block(ctx: RunCtx, p, x, *, kind: str, pos_offset, cache=None,
               cache_len=None, xattn_kv=None, is_cross=False,
               bidir_self=False):
    """Pre-norm attention block with residual.  Returns (y, new_cache): in
    ``prefill`` the new cache is this block's K/V; in ``decode`` the given
    cache (updated in place for self-attention).

    ``is_cross``: cross-attention (no rope, no mask); its keys and values
    come from ``xattn_kv`` (the encoder's output [B, T, D], normed with
    this block's ``ln``) in ``train``/``prefill`` and from the static cross
    cache, read at its full length, in ``decode``.  ``bidir_self``:
    non-causal self-attention (the encoder's blocks)."""
    cfg = ctx.cfg
    check_strategy(cfg, ctx.par.strategy, ctx.r, ctx.phase)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if kind == "L" else None
    causal = not (is_cross or bidir_self)
    decode = ctx.phase == "decode"
    megatron = _megatron(ctx)
    seq_sharded = ctx.par.strategy == "tatp" and ctx.r > 1
    if megatron:  # this rank's heads
        hq, hkv = hq // ctx.r, hkv // ctx.r

    def proj(x, w, b=None):  # decode gathers the column blocks
        y = _linear(ctx, x, w, b)
        return _gather_cols(ctx, y) if decode else y

    def kv_proj(x, w, b=None):  # megatron: this rank's kv group
        if megatron and cfg.n_kv_heads < 16:  # replicated wk / wv
            lo = ctx.dist.axis_index(ctx.axis) * hkv * hd
            cols = slice(lo, lo + hkv * hd)
            w, b = w[:, cols], None if b is None else b[cols]
        return proj(x, w, b)

    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if megatron:  # a column-parallel group's input
        h = ctx.dist.id_psum_bwd(h, ctx.axis)
    q = _split_heads(proj(h, p["wq"], p.get("bq")), hq, hd)

    if decode and is_cross:
        # the encoder's K/V were cached by prefill; the reference also
        # computes this step's (unused) K/V products, which change nothing
        new_cache = cache
        out = attn_lib.decode_attention(
            q, cache["k"], cache["v"], cache["k"].shape[1] * ctx.r,
            axis=ctx.axis, axis_size=ctx.r, cap=cfg.attn_softcap,
            dist=ctx.dist)
    else:
        src = h
        if is_cross:
            src = rms_norm(xattn_kv, p["ln"], cfg.norm_eps)
            if megatron:
                src = ctx.dist.id_psum_bwd(src, ctx.axis)
        k = _split_heads(kv_proj(src, p["wk"], p.get("bk")), hkv, hd)
        v = _split_heads(kv_proj(src, p["wv"], p.get("bv")), hkv, hd)
        new_cache = cache
        if decode:
            # cache_len: scalar (uniform batch) or [B] (per-row positions)
            qpos = torch.as_tensor(cache_len, device=x.device) - 1
            rope_pos = qpos[:, None] if qpos.ndim else qpos.reshape(1)
            q = apply_rope(q, rope_pos, cfg.rope_theta)
            k = apply_rope(k, rope_pos, cfg.rope_theta)
            kc, vc = attn_lib.write_kv_cache(cache["k"], cache["v"], k, v,
                                             qpos, axis=ctx.axis,
                                             axis_size=ctx.r, dist=ctx.dist)
            new_cache = {"k": kc, "v": vc}
            out = attn_lib.decode_attention(q, kc, vc, cache_len,
                                            axis=ctx.axis, axis_size=ctx.r,
                                            window=window,
                                            cap=cfg.attn_softcap,
                                            dist=ctx.dist)
        else:
            sl = x.shape[1]
            zig = (ctx.par.zigzag and causal and ctx.phase == "train"
                   and seq_sharded and sl % 2 == 0)
            if not is_cross:  # this rank's global positions
                if zig:
                    qp = pos_offset + attn_lib.zigzag_local_positions(
                        ctx.axis, ctx.r, sl, dist=ctx.dist, device=x.device)
                else:
                    i = ctx.dist.axis_index(ctx.axis) if seq_sharded else 0
                    qp = pos_offset + i * sl + torch.arange(sl,
                                                            device=x.device)
                q = apply_rope(q, qp, cfg.rope_theta)
                k = apply_rope(k, qp, cfg.rope_theta)
            if zig:
                out = attn_lib.zigzag_ring_attention(
                    q, k, v, axis=ctx.axis, axis_size=ctx.r, window=window,
                    cap=cfg.attn_softcap,
                    bidirectional=ctx.par.bidirectional,
                    wire=ctx.par.stream_dtype, dist=ctx.dist,
                    attention=ctx.attention)
            elif seq_sharded:
                out = attn_lib.ring_attention(
                    q, k, v, axis=ctx.axis, axis_size=ctx.r, causal=causal,
                    window=window, cap=cfg.attn_softcap,
                    bidirectional=ctx.par.bidirectional,
                    wire=ctx.par.stream_dtype, dist=ctx.dist,
                    attention=ctx.attention)
            else:
                # [B, S, H, D] viewed as [B, H, S, D]: the kernel reads
                # the strides
                out = ctx.attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=causal,
                                    window=window,
                                    cap=cfg.attn_softcap).transpose(1, 2)
            if ctx.phase == "prefill":
                new_cache = {"k": k, "v": v}

    b, s = out.shape[:2]
    y = proj(out.reshape(b, s, -1), p["wo"])
    if megatron:  # row-parallel
        y = ctx.dist.psum_id_bwd(y, ctx.axis)
    return x + y.to(x.dtype), new_cache


def mlp_block(ctx: RunCtx, p, x, prefix="mlp."):
    """Pre-norm MLP with residual; in decode above degree 1 the hidden
    and output column blocks are gathered, as the reference's; under
    ``megatron`` above degree 1 ``w_up``/``w_gate`` are column-parallel
    and ``w_down`` row-parallel, its output psummed."""
    cfg = ctx.cfg
    gather = ctx.phase == "decode"
    megatron = _megatron(ctx)
    h = rms_norm(x, p[prefix + "ln"], cfg.norm_eps)
    if megatron:
        h = ctx.dist.id_psum_bwd(h, ctx.axis)
    f = act_fn(cfg.act)
    up = _linear(ctx, h, p[prefix + "w_up"])
    if is_gated(cfg.act):
        up = f(_linear(ctx, h, p[prefix + "w_gate"])) * up
    else:
        up = f(up)
    if gather:
        up = _gather_cols(ctx, up)
    y = _linear(ctx, up, p[prefix + "w_down"])
    if gather:
        y = _gather_cols(ctx, y)
    if megatron:
        y = ctx.dist.psum_id_bwd(y, ctx.axis)
    return x + y.to(x.dtype)


def moe_block(ctx: RunCtx, p, x, layer: int = 0):
    """Pre-norm MoE FFN with residual, the model's layer ``layer`` (which
    labels its routing record).  Returns (y, aux_loss).  Above degree 1
    (``tatp``) the experts are sharded over the ring and the slots travel
    by all-to-all (:func:`repro_torch.models.moe.moe_ffn`)."""
    cfg = ctx.cfg
    check_strategy(cfg, ctx.par.strategy, ctx.r, ctx.phase)
    h = rms_norm(x, p["mlp.ln"], cfg.norm_eps)
    sub = {k.split(".", 1)[1]: v for k, v in p.items()
           if k.startswith("mlp.") and k != "mlp.ln"}
    out = moe_lib.moe_ffn(
        h, sub, n_experts=cfg.n_experts, top_k=cfg.top_k, act=cfg.act,
        axis=ctx.axis, axis_size=ctx.r if ctx.par.strategy == "tatp" else 1,
        capacity_factor=cfg.capacity_factor, routing=ctx.routing,
        layer=layer, dist=ctx.dist)
    return x + out.y.to(x.dtype), out.aux_loss


def mamba_block(ctx: RunCtx, p, x, cache=None, cache_len=None):
    """Pre-norm Mamba-2 block with residual.  Returns (y, new_cache): in
    ``prefill`` the new cache is the final SSM state (fp32) and the conv's
    last ``CONV_K - 1`` inputs (activation dtype); in ``decode`` the given
    cache updated in place.  The dtype flow is the reference's: the SSD
    inputs and the skip are fp32, the conv runs in the activation dtype.

    Above model degree 1 (``tatp``), as the reference's: ``train`` and
    ``prefill`` are sequence-sharded, the conv with its one-hop halo and
    the SSD through :func:`repro_torch.models.ssm.ssd_sequence_sharded`
    (the local pass on the ``ssd`` hook, ``par.ssm_scan_mode`` and
    ``par.ssm_state_wire``); prefill's final state and conv tail come
    from the ring's last rank by a psum of a masked tensor (the tail in
    the activation dtype), and each rank keeps its block of ``nh / R``
    heads of the state.  ``decode`` gathers ``in_proj``'s and
    ``out_proj``'s column blocks, runs the conv replicated, updates this
    rank's heads of the state and all-gathers their outputs over the
    heads."""
    cfg = ctx.cfg
    check_strategy(cfg, ctx.par.strategy, ctx.r, ctx.phase)
    r, axis, dist = ctx.r, ctx.axis, ctx.dist
    di, n, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    nh_l = nh // r
    i = dist.axis_index(axis)
    heads = slice(i * nh_l, (i + 1) * nh_l)  # this rank's state heads
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = _linear(ctx, h, p["in_proj"])
    if ctx.phase == "decode":
        zxbcdt = _gather_cols(ctx, zxbcdt)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt_raw = zxbcdt[..., di + di + 2 * n:]
    a = -torch.exp(p["a_log"].float())
    d_skip = p["d_skip"].float()
    dt_bias = p["dt_bias"].float()

    if ctx.phase == "decode":
        conv_out, conv_cache = ssm_lib.conv_decode_step(
            xbc[:, 0, :], cache["conv"], p["conv_w"], p["conv_b"])
        conv_out = F.silu(conv_out)
        xs = conv_out[:, :di]
        bmat = conv_out[:, di:di + n]
        cmat = conv_out[:, di + n:]
        dt = F.softplus(dt_raw[:, 0, :].float() + dt_bias)
        y, state_new = ssm_lib.ssd_decode_step(
            xs.reshape(-1, nh, hd)[:, heads].float(), dt[:, heads],
            a[heads], bmat.float(), cmat.float(), d_skip[heads],
            cache["state"])
        y = dist.all_gather(y, axis, dim=1)
        y = y.reshape(-1, 1, di).to(x.dtype)
        cache["state"].copy_(state_new)
        cache["conv"].copy_(conv_cache)
        new_cache = cache
    else:
        seq_sharded = ctx.par.strategy == "tatp" and r > 1
        conv_out = ssm_lib.causal_conv1d(
            xbc, p["conv_w"], p["conv_b"], axis=axis,
            axis_size=r if seq_sharded else 1, dist=dist)
        conv_out = F.silu(conv_out)
        xs = conv_out[..., :di]
        bmat = conv_out[..., di:di + n].float()
        cmat = conv_out[..., di + n:].float()
        dt = F.softplus(dt_raw.float() + dt_bias)
        b_, l_ = xs.shape[:2]
        xh = xs.reshape(b_, l_, nh, hd).float()
        if seq_sharded:
            y, state = ssm_lib.ssd_sequence_sharded(
                xh, dt, a, bmat, cmat, cfg.ssm_chunk, axis=axis,
                axis_size=r, scan_mode=ctx.par.ssm_scan_mode,
                wire=ctx.par.ssm_state_wire, dist=dist, ssd=ctx.ssd)
        else:
            out = ctx.ssd(xh, dt, a, bmat, cmat, cfg.ssm_chunk)
            y, state = out.y, out.state
        y = y + d_skip[None, None, :, None] * xh
        y = y.reshape(b_, l_, di).to(x.dtype)
        new_cache = None
        if ctx.phase == "prefill":
            tail = xbc[:, -(CONV_K - 1):, :]
            if seq_sharded:  # both live on the ring's last rank
                last = ssm_lib.rank_mask(i == r - 1, x.device)
                state = dist.psum(torch.where(last, state,
                                              torch.zeros_like(state)), axis)
                tail = dist.psum(torch.where(last, tail,
                                             torch.zeros_like(tail)), axis)
            # copies, so the cache holds neither the whole state nor the
            # whole in_proj output
            new_cache = {"state": state[:, heads].float().contiguous(),
                         "conv": tail.clone()}

    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["gln"], cfg.norm_eps)
    out = _linear(ctx, y, p["out_proj"])
    if ctx.phase == "decode":
        out = _gather_cols(ctx, out)
    return x + out.to(x.dtype), new_cache
