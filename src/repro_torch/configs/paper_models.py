"""The paper's own workloads (Table II) used by the wafer-simulator benchmarks.

Copy of ``repro.configs.paper_models``.

| Model        | Heads | Batch | Hidden | Layers | Seq  |
|--------------|-------|-------|--------|--------|------|
| GPT-3 6.7B   | 32    | 128   | 4096   | 32     | 2048 |
| Llama2 7B    | 32    | 128   | 4096   | 32     | 4096 |
| Llama3 70B   | 64    | 128   | 8192   | 80     | 4096 |
| GPT-3 76B    | 80    | 128   | 10240  | 60     | 2048 |
| GPT-3 175B   | 96    | 128   | 12288  | 96     | 2048 |
| OPT 175B     | 96    | 128   | 12288  | 96     | 4096 |

Plus the multi-wafer scaling set (§VIII-E): Grok-1 341B, Llama3 405B, GPT-3
504B variant.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _gpt(name, heads, hidden, layers, seq, batch, vocab=50257, d_ff=None,
         kv_heads=None) -> tuple[ModelConfig, ShapeConfig]:
    cfg = ModelConfig(
        name=name,
        family="dense",
        n_layers=layers,
        d_model=hidden,
        n_heads=heads,
        n_kv_heads=kv_heads or heads,
        d_ff=d_ff or 4 * hidden,
        vocab_size=vocab,
        act="gelu",
        layer_pattern="G",
        source="paper Table II",
    )
    return cfg, ShapeConfig(name + f"-s{seq}", "train", seq, batch)


GPT3_6_7B = _gpt("gpt3-6.7b", 32, 4096, 32, 2048, 128)
LLAMA2_7B = _gpt("llama2-7b", 32, 4096, 32, 4096, 128, vocab=32000, d_ff=11008)
LLAMA3_70B = _gpt("llama3-70b", 64, 8192, 80, 4096, 128, vocab=128256,
                  d_ff=28672, kv_heads=8)
GPT3_76B = _gpt("gpt3-76b", 80, 10240, 60, 2048, 128)
GPT3_175B = _gpt("gpt3-175b", 96, 12288, 96, 2048, 128)
OPT_175B = _gpt("opt-175b", 96, 12288, 96, 4096, 128)

# §VIII-E multi-wafer models
GROK1_341B = _gpt("grok1-341b", 48, 6144, 64, 8192, 128, vocab=131072,
                  d_ff=32768)  # MoE in reality; dense-equivalent FLOPs model
LLAMA3_405B = _gpt("llama3-405b", 128, 16384, 126, 4096, 64, vocab=128256,
                   d_ff=53248, kv_heads=8)
GPT3_504B = _gpt("gpt3-504b", 128, 16384, 140, 2048, 64)

TABLE_II = {
    "gpt3-6.7b": GPT3_6_7B,
    "llama2-7b": LLAMA2_7B,
    "llama3-70b": LLAMA3_70B,
    "gpt3-76b": GPT3_76B,
    "gpt3-175b": GPT3_175B,
    "opt-175b": OPT_175B,
}

MULTI_WAFER = {
    "gpt3-175b": (GPT3_175B, 2),   # model -> wafers
    "grok1-341b": (GROK1_341B, 4),
    "llama3-405b": (LLAMA3_405B, 4),
    "gpt3-504b": (GPT3_504B, 6),
}
