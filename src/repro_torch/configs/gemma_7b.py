"""Gemma-7B — dense, GeGLU, head_dim=256. [arXiv:2403.08295; hf]
(A copy of ``repro.configs.gemma_7b``.)"""

from repro_torch.configs.base import ModelConfig, reduced_config

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    d_head=256,
    act="geglu",
    layer_pattern="G",
    tie_embeddings=True,
    scale_embed=True,
    source="arXiv:2403.08295; hf:google/gemma-7b",
)


def reduced():
    return reduced_config(CONFIG, d_head=16)
