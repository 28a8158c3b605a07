"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA, 1 shared + 256 routed top-8,
first 3 layers dense (d_ff 18432), MTP depth 1, vocab 129280.
[arXiv:2412.19437; hf-verified]"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                  num_shared_experts=1, first_k_dense=3, d_ff_dense=18432),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    mtp_depth=1,
    param_dtype="bfloat16",   # 671B: bf16 params + 8-bit Adam (optimizer.py)
    seq_shard_activations=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe", num_layers=5, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=48, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32,
                      num_shared_experts=1, first_k_dense=1, d_ff_dense=48),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        mtp_depth=1)
