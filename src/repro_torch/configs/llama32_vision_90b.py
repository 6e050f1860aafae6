"""llama-3.2-vision-90b [vlm] (hf:meta-llama/Llama-3.2-*-Vision).

100L total, d_model 8192, 64 heads (GQA kv=8), d_ff 28672, vocab 128256;
cross-attention image layers every 5th layer; vision frontend is a stub
(precomputed patch embeddings via input_specs).
"""
from repro_torch.models.config import ATTN, XATTN, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv=8, d_ff=28672, vocab=128256,
    pattern=(ATTN, ATTN, ATTN, ATTN, XATTN), encoder_len=1024,
    train_accum=16,   # 100L x d8192: 1 seq/device/microbatch to fit HBM
    notes="cross-attn every 5th layer; stub encoder 1024 patch tokens; "
          "full attention -> long_500k skipped",
)
