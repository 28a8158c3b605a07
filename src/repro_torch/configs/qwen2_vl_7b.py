"""qwen2-vl-7b [vlm]: 28L d=3584 28H (kv 4) ff 18944, vocab 152064, M-RoPE,
dynamic-resolution vision frontend as a STUB (input_specs provides
precomputed patch embeddings). [arXiv:2409.12191; hf-verified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm", num_layers=28, d_model=3584,
    num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
    qkv_bias=True, mrope=True, mrope_sections=(16, 24, 24),
    frontend="vision_stub", vision_patches=1024, rope_theta=1e6,
    seq_shard_activations=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        qkv_bias=True, mrope=True, mrope_sections=(2, 3, 3),
        frontend="vision_stub", vision_patches=8)
