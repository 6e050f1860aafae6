"""recurrentgemma-9b [hybrid]: RG-LRU + local attention 1:2
(arXiv:2402.19427 Griffin).

38L, d_model 4096, 16 heads (GQA kv=1) for the attention layers,
d_ff 12288, vocab 256000; pattern (rglru, rglru, local-attn).
"""
from repro_torch.models.config import LOCAL, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288, vocab=256000,
    pattern=(RGLRU, RGLRU, LOCAL), local_window=2048,
    notes="38 = 12 full (r,r,a) periods + 2 remainder rglru layers; "
          "O(window) decode -> long_500k RUNS",
)
