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
