"""Zamba2-2.7B — hybrid Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

Pattern: five Mamba2 blocks then one *shared* attention+MLP block (its weights
are shared across every ``S`` slot, the Zamba signature).  A copy of
``repro.configs.zamba2_2_7b``.
"""

from repro_torch.configs.base import ModelConfig, reduced_config

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    layer_pattern="MMMMMS",
    ssm_state=64,
    ssm_head_dim=64,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B",
)


def reduced():
    return reduced_config(CONFIG, layer_pattern="MMS", n_layers=3)
