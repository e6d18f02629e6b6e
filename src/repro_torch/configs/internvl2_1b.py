"""InternVL2-1B — InternViT (stub) + Qwen2-0.5B-class LM backbone.
[arXiv:2404.16821; hf]

The vision frontend is a stub: the batch's ``prefix_embeds`` carry
precomputed patch embeddings, which take the sequence's first
``frontend_tokens`` positions (``models/lm.py:embed_tokens``).

(A copy of ``repro.configs.internvl2_1b``.)
"""

from repro_torch.configs.base import ModelConfig, reduced_config

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    act="swiglu",
    layer_pattern="G",
    frontend="vision",
    frontend_tokens=256,  # precomputed ViT patch embeddings per image
    tie_embeddings=True,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B",
)


def reduced():
    return reduced_config(CONFIG, n_heads=4, n_kv_heads=2)
