"""internlm2-20b [dense]: 48L d=6144 48H (kv 8) ff 16384, vocab 92544.
[arXiv:2403.17297; hf-verified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense", num_layers=48, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=92544,
    rope_theta=1e6,
    seq_shard_activations=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-smoke", family="dense", num_layers=4, d_model=64,
        num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=256)
