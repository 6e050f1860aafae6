"""mistral-nemo-12b [dense] (hf:mistralai/Mistral-Nemo-Base-2407).

40L, d_model 5120, 32 heads (GQA kv=8, head_dim 128), d_ff 14336,
vocab 131072, 128k context (rope theta 1e6).
"""
from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=14336, vocab=131072,
    head_dim=128, pattern=(ATTN,), rope_theta=1e6,
    notes="explicit head_dim=128 (H*hd != d_model); long_500k skipped",
)
