"""rwkv6-3b [ssm]: RWKV-6 Finch, data-dependent decay (arXiv:2404.05892).

32L, d_model 2560, attention-free, d_ff 8960, vocab 65536.
"""
from repro_torch.models.config import RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv=40, d_ff=8960, vocab=65536,
    pattern=(RWKV,), rwkv_head_dim=64,
    notes="attn-free; O(1) decode state -> long_500k RUNS",
)
