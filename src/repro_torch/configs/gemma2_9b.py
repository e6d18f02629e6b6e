"""Gemma2-9B — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]
(A copy of ``repro.configs.gemma2_9b``.)"""

from repro_torch.configs.base import ModelConfig, reduced_config

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    d_head=256,
    act="geglu",
    layer_pattern="LG",  # alternating sliding-window / global
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    scale_embed=True,
    source="arXiv:2408.00118; hf:google/gemma-2-9b",
)


def reduced():
    return reduced_config(CONFIG, d_head=16, n_kv_heads=2)
