"""xlstm-125m [ssm]: 12L d=768 4H, vocab 50304, mLSTM blocks with sLSTM at
the 1/4 and 3/4 positions (xLSTM[7:1]-style mix). [arXiv:2405.04517;
unverified]"""

from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", num_layers=12, d_model=768,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(slstm_at=(3, 9)))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm", num_layers=4, d_model=64,
        num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=256,
        xlstm=XLSTMConfig(slstm_at=(1,)))
