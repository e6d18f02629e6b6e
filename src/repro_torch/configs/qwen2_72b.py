"""Qwen2-72B — dense GQA transformer with QKV bias. [arXiv:2407.10671; hf]
(A copy of ``repro.configs.qwen2_72b``.)"""

from repro_torch.configs.base import ModelConfig, reduced_config

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="swiglu",
    layer_pattern="G",
    tie_embeddings=False,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-72B",
)


def reduced():
    return reduced_config(CONFIG, n_kv_heads=2)
