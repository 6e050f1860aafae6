"""qwen3-1.7b [dense]: qk-norm + GQA (hf:Qwen/Qwen3 family).

28L, d_model 2048, 16 heads (GQA kv=8), d_ff 6144, vocab 151936.
"""
from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv=8, d_ff=6144, vocab=151936,
    pattern=(ATTN,), qk_norm=True,
    notes="per-head RMS q/k norm; full attention -> long_500k skipped",
)
