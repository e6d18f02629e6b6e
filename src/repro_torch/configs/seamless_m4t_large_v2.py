"""SeamlessM4T-large-v2 — encoder-decoder, multimodal (audio frontend stub).
[arXiv:2308.11596; hf]

The modality frontend is a stub: the batch's ``enc_embeds`` carry
precomputed speech-frame embeddings for the encoder; the text decoder is the
transformer backbone specified (24L, d=1024, 16H, d_ff=8192, vocab=256206).

(A copy of ``repro.configs.seamless_m4t_large_v2``.)
"""

from repro_torch.configs.base import ModelConfig, reduced_config

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,  # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    act="gelu",
    layer_pattern="G",
    frontend="audio",
    frontend_tokens=1024,  # precomputed speech-frame embeddings per item
    tie_embeddings=True,
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large",
)


def reduced():
    return reduced_config(CONFIG)
