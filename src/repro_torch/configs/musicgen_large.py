"""musicgen-large [audio] (arXiv:2306.05284).

48L decoder-only over EnCodec tokens; d_model 2048, 32 heads (MHA),
d_ff 8192, vocab 2048.  The EnCodec frontend is a stub: input_specs
provides precomputed frame embeddings.
"""
from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv=32, d_ff=8192, vocab=2048,
    pattern=(ATTN,), embed_input="embeddings",
    notes="stub EnCodec frontend (frame embeddings in); head predicts "
          "codebook tokens (vocab 2048); full attention -> long_500k skipped",
)
