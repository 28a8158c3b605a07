"""gemma3-27b [dense]: 62L d=5376 32H (kv 16) ff 21504, vocab 262144,
5:1 local:global sliding window, GeGLU, head_dim 128.
[hf:google/gemma-3; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense", num_layers=62, d_model=5376,
    num_heads=32, num_kv_heads=16, d_ff=21504, vocab_size=262144,
    head_dim=128, act="geglu", embed_scale=True, tie_embeddings=True,
    sliding_window=1024, global_every=6, rope_theta=1e6,
    seq_shard_activations=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense", num_layers=6, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        act="geglu", embed_scale=True, tie_embeddings=True,
        sliding_window=16, global_every=6)
