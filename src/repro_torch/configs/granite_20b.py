"""granite-20b [dense]: llama-arch code model (arXiv:2405.04324).

52L, d_model 6144, 48 heads (GQA kv=1 -- MQA), d_ff 24576, vocab 49152.
"""
from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, d_ff=24576, vocab=49152,
    pattern=(ATTN,),
    train_accum=16,   # 52L x d6144: 1 seq/device/microbatch to fit HBM
    notes="MQA (single KV head); full attention -> long_500k skipped",
)
