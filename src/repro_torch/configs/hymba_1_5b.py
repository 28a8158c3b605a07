"""hymba-1.5b [hybrid]: 32L d=1600 25H (kv 5) ff 5504, vocab 32001,
parallel attention + mamba heads, SSM state 16, sliding window 1024 with
3 global layers (first/middle/last). [arXiv:2411.13676; hf-verified]"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", num_layers=32, d_model=1600,
    num_heads=25, num_kv_heads=5, d_ff=5504, vocab_size=32001,
    head_dim=64, ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
    sliding_window=1024, global_layers=(0, 15, 31))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        ssm=SSMConfig(state_dim=4, conv_dim=4, expand=2),
        sliding_window=16, global_layers=(0, 3))
