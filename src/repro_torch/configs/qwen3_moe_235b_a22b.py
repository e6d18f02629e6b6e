"""Qwen3-MoE-235B-A22B — MoE, 128 experts top-8, per-expert d_ff=1536.
[hf:Qwen/Qwen3-30B-A3B family; hf]  (A copy of
``repro.configs.qwen3_moe_235b_a22b``; its reduced config keeps grouped
queries: 4 query heads over 2 K/V heads.)"""

from repro_torch.configs.base import ModelConfig, reduced_config

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,  # per-expert hidden dim
    vocab_size=151936,
    d_head=128,
    n_experts=128,
    top_k=8,
    act="swiglu",
    rope_theta=1_000_000.0,
    layer_pattern="G",
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-235B-A22B",
)


def reduced():
    return reduced_config(CONFIG, n_kv_heads=2)
