"""OLMoE-1B-7B — MoE, 64 experts top-8, per-expert d_ff=1024.
[arXiv:2409.02060; hf]  (A copy of ``repro.configs.olmoe_1b_7b``.)"""

from repro_torch.configs.base import ModelConfig, reduced_config

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,  # per-expert hidden dim
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    act="swiglu",
    layer_pattern="G",
    tie_embeddings=False,
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
)


def reduced():
    return reduced_config(CONFIG)
