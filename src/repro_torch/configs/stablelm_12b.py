"""stablelm-12b [dense] (hf:stabilityai/stablelm family).

40L, d_model 5120, 32 heads (GQA kv=8), d_ff 13824, vocab 100352.
"""
from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=13824, vocab=100352,
    pattern=(ATTN,),
    notes="head_dim 160; full attention -> long_500k skipped",
)
