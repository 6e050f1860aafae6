"""moonshot-v1-16b-a3b [moe] (hf:moonshotai/Moonlight-16B-A3B).

48L, d_model 2048, 16 heads (GQA kv=16 -- MHA), per-expert d_ff 1408,
vocab 163840, 64 experts top-6.
"""
from repro_torch.models.config import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=163840,
    pattern=(ATTN,),
    moe=MoEConfig(n_experts=64, top_k=6),
    notes="64 experts shard over model axis (EP); full attention -> "
          "long_500k skipped",
)
