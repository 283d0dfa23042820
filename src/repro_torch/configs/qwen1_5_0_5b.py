"""qwen1.5-0.5b [dense] — MHA (kv == heads) with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf] 24L d_model=1024 16H (kv=16, head_dim 64)
d_ff=2816 vocab=151936, QKV bias, tied embeddings. Pure full attention ->
long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)
