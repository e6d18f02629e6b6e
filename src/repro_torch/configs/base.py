"""Config dataclasses for models, shapes and parallelism.

A copy of ``repro.configs.base`` (the port imports nothing of ``repro``):
``ModelConfig``, ``ShapeConfig``, ``ParallelConfig`` and ``reduced_config``
keep the reference's fields, defaults and arithmetic, so a configuration
means the same model in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # attention options
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    layer_pattern: str = "G"  # G global · L local · M mamba2 · S shared
    # mlp options
    act: str = "swiglu"  # swiglu | geglu | gelu
    # MoE (d_ff is the per-expert hidden dim for MoE archs)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    n_expert_groups: int = 0
    top_k_groups: int = 0
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # encoder-decoder
    n_enc_layers: int = 0
    # modality frontend stub
    frontend: Optional[str] = None  # vision | audio
    frontend_tokens: int = 0
    # misc
    tie_embeddings: bool = True
    scale_embed: bool = False  # multiply embeddings by sqrt(d_model)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""  # provenance note

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        if not self.n_heads:  # attention-free (mamba2)
            return 0
        return self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def pattern_for_layers(self) -> str:
        p = self.layer_pattern
        reps = (self.n_layers + len(p) - 1) // len(p)
        return (p * reps)[: self.n_layers]

    def param_count(self, active_only: bool = False) -> int:
        d, h = self.d_model, self.head_dim
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        if self.act in ("swiglu", "geglu"):
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        n_params = 0
        pat = self.pattern_for_layers()
        shared_attn_counted = False
        for kind in pat:
            if kind in ("G", "L"):
                n_params += attn + self.norm_params()
                if self.is_moe:
                    experts = self.n_experts if not active_only else self.top_k
                    n_params += experts * 3 * d * self.d_ff + d * self.n_experts
                else:
                    n_params += mlp_dense
            elif kind == "M":
                di, ns = self.d_inner, self.ssm_state
                nh = self.ssm_heads
                # in_proj: d -> 2*di + 2*ns + nh (z, x, B, C, dt)
                n_params += d * (2 * di + 2 * ns + nh) + di * d + self.norm_params()
                n_params += nh * 2 + di  # A_log, D, dt_bias-ish / conv skipped
            elif kind == "S":
                if not shared_attn_counted or active_only:
                    n_params += attn + mlp_dense + self.norm_params()
                    shared_attn_counted = True
        # encoder stack (same block shape as decoder global layers)
        n_params += self.n_enc_layers * (attn + mlp_dense + self.norm_params())
        # embeddings (+ output head if untied)
        n_params += self.vocab_size * d
        if not self.tie_embeddings:
            n_params += self.vocab_size * d
        n_params += d  # final norm
        return n_params

    def norm_params(self) -> int:
        return 2 * self.d_model

    # -- serving-side cache accounting (shared by the decode cost model and
    # the continuous-batching engine's KV-budget admission) -----------------
    def cache_bytes_per_seq(self, ctx_len: int, *, bytes_act: int = 2,
                            bytes_state: int = 4) -> float:
        """Decode-cache bytes one sequence holds at context ``ctx_len``,
        summed over layers: per-token KV for attention layers (sliding
        windows cap at the window), O(1) recurrent state for SSM layers.
        The wafer decode objective and the serve engine's admission both
        price a request through this one function, so the solver's KV
        budget and the runtime's occupancy accounting cannot diverge."""
        total = 0.0
        kv_tok = 2 * self.kv_dim * bytes_act
        for kind in self.pattern_for_layers():
            if kind in ("G", "S"):
                total += kv_tok * ctx_len
            elif kind == "L":
                w = min(ctx_len, self.sliding_window or ctx_len)
                total += kv_tok * w
            elif kind == "M":
                # SSM recurrent state + conv tail: context-length-free
                total += (self.d_inner * self.ssm_state
                          + 4 * self.d_inner) * bytes_state
        return total

    def cache_bytes_per_token(self, ctx_len: int, *,
                              bytes_act: int = 2) -> float:
        """Marginal cache bytes appended per generated token at context
        ``ctx_len`` (zero once every attention layer's window is full —
        SSM state never grows)."""
        grown = self.cache_bytes_per_seq(ctx_len + 1, bytes_act=bytes_act)
        return grown - self.cache_bytes_per_seq(ctx_len, bytes_act=bytes_act)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


@dataclass(frozen=True)
class ParallelConfig:
    """Degrees of each parallel dimension and the runnable strategy knobs
    (the same fields as the reference; the port runs ``tatp`` at degree 1).
    """

    dp: int = 1
    tp: int = 1
    sp: int = 1
    cp: int = 1
    tatp: int = 1
    pp: int = 1

    strategy: str = "tatp"  # tatp | megatron | fsdp
    stream: str = "auto"  # weights | inputs | auto
    bidirectional: bool = True
    stream_dtype: str = "native"  # native | fp8
    ssm_scan_mode: str = "seq"
    ssm_state_wire: str = "fp32"
    remat: bool = True
    remat_policy: str = "full"
    zigzag: bool = False
    zero1: bool = True
    grad_compress: bool = False
    unroll_scan: bool = False

    @property
    def degree(self) -> int:
        return self.dp * self.tp * self.sp * self.cp * self.tatp * self.pp

    def as_tuple(self) -> Tuple[int, int, int, int]:
        return (self.dp, self.tp, self.sp, self.tatp)


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (the reference's
    shrink rules, MoE derivation included)."""
    pat = cfg.layer_pattern
    top_k_red = min(4, cfg.top_k) if cfg.top_k else 0
    n_experts_red = (
        min(cfg.n_experts, max(8, 2 * top_k_red)) if cfg.n_experts else 0
    )
    groups_red = top_k_groups_red = 0
    if cfg.n_expert_groups:
        for g in range(min(cfg.n_expert_groups, n_experts_red), 0, -1):
            tkg = min(cfg.top_k_groups, g)
            if (
                n_experts_red % g == 0
                and tkg * (n_experts_red // g) >= top_k_red
            ):
                groups_red, top_k_groups_red = g, tkg
                break
    small = dict(
        n_layers=max(2, min(4, len(pat))),
        d_model=64,
        n_heads=4,
        n_kv_heads=(
            min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4
        ),
        d_head=16,
        d_ff=128,
        vocab_size=128,
        sliding_window=16 if cfg.sliding_window else None,
        n_experts=n_experts_red,
        top_k=top_k_red,
        n_expert_groups=groups_red,
        top_k_groups=top_k_groups_red,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8 if cfg.ssm_state else 256,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        frontend_tokens=4 if cfg.frontend else 0,
        dtype="float32",
    )
    small.update(overrides)
    out = replace(cfg, name=cfg.name + "-smoke", **small)
    if out.n_experts and out.top_k > out.n_experts:
        out = replace(out, top_k=out.n_experts)
    return out
