"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (kv 8) expert-ff 512,
vocab 49155, 40 experts top-8. [hf:ibm-granite; hf-verified]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=256,
        tie_embeddings=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32))
