"""whisper-tiny [audio]: 4+4L enc-dec d=384 6H ff 1536, vocab 51865,
conv frontend STUB (input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio", num_layers=4, d_model=384,
    num_heads=6, num_kv_heads=6, d_ff=1536, vocab_size=51865,
    norm="layernorm", act="gelu", use_rope=False, enc_dec=True,
    enc_layers=4, enc_frames=1500, frontend="audio_stub", max_seq=65536,
    train_accum_override=8)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        norm="layernorm", act="gelu", use_rope=False, enc_dec=True,
        enc_layers=2, enc_frames=32, frontend="audio_stub", max_seq=512)
