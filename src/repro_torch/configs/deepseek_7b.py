"""DeepSeek-7B — llama-architecture dense transformer. [arXiv:2401.02954; hf]"""

from repro_torch.configs.base import ModelConfig, reduced_config

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    act="swiglu",
    layer_pattern="G",
    tie_embeddings=False,
    source="arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-7b-base",
)


def reduced():
    return reduced_config(CONFIG, n_kv_heads=4)
