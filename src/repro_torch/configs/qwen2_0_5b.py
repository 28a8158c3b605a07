"""qwen2-0.5b [dense]: 24L d=896 14H (kv 2) ff 4864, vocab 151936, QKV bias,
tied embeddings. [arXiv:2407.10671; hf-verified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", family="dense", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
        qkv_bias=True, tie_embeddings=True)
