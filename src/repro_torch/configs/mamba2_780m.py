"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified] 48L d_model=1536, d_inner=3072 (48 heads x
headdim 64), ssm_state=128, n_groups=1, vocab=50280 padded to 50288 (the
official impl's pad_vocab_size_multiple=16), tied embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,  # d_inner / ssm_headdim
    n_kv_heads=48,
    head_dim=64,
    d_ff=0,
    vocab_size=50_288,  # 50280 + pad_vocab_size_multiple=16 (official impl)
    pattern=(("ssm", None),),
    ssm_state=128,
    ssm_headdim=64,
    ssm_groups=1,
    tie_embeddings=True,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
