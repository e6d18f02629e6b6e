"""Mamba2-780m — attention-free SSM, SSD (state-space duality).
[arXiv:2405.21060; unverified]

A copy of ``repro.configs.mamba2_780m``."""

from repro_torch.configs.base import ModelConfig, reduced_config

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=0,  # no MLP — mamba blocks only
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    layer_pattern="M",
    tie_embeddings=True,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-780m",
)


def reduced():
    return reduced_config(CONFIG, n_heads=0, n_kv_heads=0, d_ff=0, ssm_state=16)
