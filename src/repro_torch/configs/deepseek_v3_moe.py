"""DeepSeek-V3-style MoE — 64 routed experts top-6 with grouped routing
(8 device groups, top-3 groups per token), per-expert d_ff=1408.
[arXiv:2412.19437]  (A copy of ``repro.configs.deepseek_v3_moe``.)

The model path routes flat, top-6 over all 64 experts, as the
reference's does: ``n_expert_groups`` / ``top_k_groups`` are read only by
the reference's serve-engine router simulation (ROADMAP.md §C)."""

from repro_torch.configs.base import ModelConfig, reduced_config

CONFIG = ModelConfig(
    name="deepseek-v3-moe",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per-expert hidden dim
    vocab_size=102400,
    n_experts=64,
    top_k=6,
    n_expert_groups=8,
    top_k_groups=3,
    act="swiglu",
    layer_pattern="G",
    tie_embeddings=False,
    source="arXiv:2412.19437 (routing shape; scaled-down expert pool)",
)


def reduced():
    return reduced_config(CONFIG)
