"""mixtral-8x7b [moe] (arXiv:2401.04088).

32L, d_model 4096, 32 heads (GQA kv=8), expert d_ff 14336, vocab 32000,
8 experts top-2, sliding-window attention (4096).
"""
from repro_torch.models.config import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=32000,
    pattern=(ATTN,), swa_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
    notes="SWA window 4096 -> long_500k RUNS (rolling KV cache); "
          "8 experts not divisible by model=16 -> expert d_ff is TP-sharded",
)
