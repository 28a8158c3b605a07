"""Model configuration schema covering the 10 assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # expert FFN hidden size
    num_shared_experts: int = 0   # DeepSeek-style always-on experts
    first_k_dense: int = 0        # leading layers with dense FFN
    d_ff_dense: int = 0           # hidden size of those dense FFNs
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001
    router_scale: bool = True     # normalize top-k gate weights to sum 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims (arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (used by hymba's parallel heads)."""
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2               # inner = expand * d_model (attn+ssm share)
    dt_min: float = 1e-3
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_at: tuple[int, ...] = ()     # layer indices using sLSTM blocks
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_dim: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    act: Literal["silu", "gelu", "geglu"] = "silu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    rope_theta: float = 1e4
    rms_eps: float = 1e-6
    max_seq: int = 131072
    # sliding-window pattern: window size for "local" layers; every
    # `global_every`-th layer (0-based, i % global_every == global_every-1)
    # is global. global_every=0 -> all layers global (full attention).
    sliding_window: int = 0
    global_every: int = 0
    global_layers: tuple[int, ...] = ()   # explicit global-attention layers
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    use_rope: bool = True          # whisper uses absolute positions instead
    embed_scale: bool = False      # gemma multiplies embeddings by sqrt(d)
    mrope: bool = False            # qwen2-vl multimodal rotary
    mrope_sections: tuple[int, ...] = (16, 24, 24)  # t/h/w splits (half-dim)
    mtp_depth: int = 0             # DeepSeek multi-token-prediction layers
    enc_dec: bool = False
    enc_layers: int = 0
    enc_frames: int = 1500         # whisper stub frame count (train/prefill)
    frontend: Literal["none", "vision_stub", "audio_stub"] = "none"
    vision_patches: int = 0        # vlm stub: leading patch-embedding slots
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: Literal["none", "full", "dots", "names"] = "full"
    train_accum_override: int = 0   # force gradient-accumulation steps
    attn_scores_dtype: str = "float32"   # bf16 halves S^2 score traffic
    # Megatron-SP-style: keep residual-stream activations (and the layer
    # scan stash) sharded over the model axis along the sequence dim;
    # GSPMD inserts the gather/reduce-scatter pairs around attention/MLP.
    seq_shard_activations: bool = False

    # -- derived -------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports O(seq) decode state (long_500k eligible):
        recurrent state and/or bounded attention windows on *every* layer."""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            # hymba: sliding-window attention + SSM; global layers are the
            # exception — eligible if windows bound every attention layer.
            return self.sliding_window > 0 and self.global_every == 0
        return False

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoder-bearing (enc-dec incl.)

    def layer_window(self, i: int) -> int:
        """Static per-layer attention window (0 = full/global attention)."""
        if self.sliding_window <= 0:
            return 0
        if i in self.global_layers:
            return 0
        if self.global_every and (i % self.global_every
                                  == self.global_every - 1):
            return 0
        return self.sliding_window

    def window_array(self):
        return tuple(self.layer_window(i) for i in range(self.num_layers))

    def validate(self) -> None:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.moe:
            assert self.moe.top_k <= self.moe.num_experts
        if self.family == "vlm":
            assert self.frontend == "vision_stub"
        if self.enc_dec:
            assert self.enc_layers > 0

    # -- parameter counting (for roofline MODEL_FLOPS) -----------------------

    def param_counts(self) -> dict[str, float]:
        """Approximate parameter counts: total and *active* (MoE-aware)."""
        d, hd = self.d_model, self.head_dim_
        nq, nkv = self.num_heads, self.num_kv_heads
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> float:
            if self.mla:
                m = self.mla
                q = d * m.q_lora_rank + m.q_lora_rank * nq * (
                    m.qk_nope_head_dim + m.qk_rope_head_dim)
                kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) \
                    + m.kv_lora_rank * nq * (m.qk_nope_head_dim
                                             + m.v_head_dim)
                o = nq * m.v_head_dim * d
                return q + kv + o
            return d * nq * hd + 2 * d * nkv * hd + nq * hd * d

        def mlp_params(ff: int) -> float:
            mult = 3 if self.act in ("silu", "geglu") else 2
            return mult * d * ff

        total = embed
        active = embed
        for i in range(self.num_layers):
            a = attn_params()
            if self.moe and i >= self.moe.first_k_dense:
                e = mlp_params(self.moe.d_expert)
                total += a + e * (self.moe.num_experts
                                  + self.moe.num_shared_experts)
                active += a + e * (self.moe.top_k
                                   + self.moe.num_shared_experts)
            else:
                ff = (self.moe.d_ff_dense if self.moe and self.moe.d_ff_dense
                      else self.d_ff)
                if self.xlstm is not None:
                    pf = (self.xlstm.slstm_proj_factor if i in
                          self.xlstm.slstm_at else self.xlstm.mlstm_proj_factor)
                    blk = 4 * d * nq * hd + 2 * d * int(pf * d)
                    total += blk
                    active += blk
                    continue
                if self.ssm is not None:  # hybrid adds a parallel SSM path
                    inner = self.ssm.expand * d
                    a += 2 * d * inner + inner * (2 * self.ssm.state_dim + 1)
                total += a + mlp_params(ff)
                active += a + mlp_params(ff)
        if self.enc_dec:
            # encoder layers + decoder cross-attention
            enc = self.enc_layers * (attn_params() + mlp_params(self.d_ff))
            cross = self.num_layers * attn_params()
            total += enc + cross
            active += enc + cross
        return {"total": float(total), "active": float(active)}
