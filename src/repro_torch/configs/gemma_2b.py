"""gemma-2b [dense]: 18L d=2048 8H MQA (kv 1) ff 16384, vocab 256000, GeGLU,
head_dim 256. [arXiv:2403.08295; hf-verified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense", num_layers=18, d_model=2048,
    num_heads=8, num_kv_heads=1, d_ff=16384, vocab_size=256000,
    head_dim=256, act="geglu", embed_scale=True, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke", family="dense", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=256, head_dim=32,
        act="geglu", embed_scale=True, tie_embeddings=True)
