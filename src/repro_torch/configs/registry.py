"""Architecture registry and the LM shapes (port of
``repro.configs.registry``).

The ids are the reference's ten, and every config is a copy of the
reference's. ``LM`` builds the dense family (``qwen2-0.5b``, ``gemma-2b``,
``internlm2-20b``, ``gemma3-27b``), the MoE family
(``granite-moe-3b-a800m``, ``deepseek-v3-671b``) and the VLM
(``qwen2-vl-7b``); the hybrid, SSM and encoder-decoder families
(``hymba-1.5b``, ``xlstm-125m``, ``whisper-tiny``) raise in ``LM`` until
their model lands (ROADMAP queue 1 item 9c), but their configs serve the
placement layer (a geometry needs only the config). ``step_fn`` gives
the train, prefill and decode steps (decode's batch is ``{"cache",
"tokens", "position"}``, as the reference's). ``input_specs``
(``jax.ShapeDtypeStruct`` stand-ins) has no counterpart.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM

ARCH_IDS = [
    "granite-moe-3b-a800m",
    "deepseek-v3-671b",
    "qwen2-0.5b",
    "internlm2-20b",
    "gemma3-27b",
    "gemma-2b",
    "hymba-1.5b",
    "xlstm-125m",
    "qwen2-vl-7b",
    "whisper-tiny",
]

def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def make_model(cfg: ModelConfig) -> LM:
    """The LM (``LM`` raises for a family that is not ported)."""
    return LM(cfg)


def cell_supported(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """Whether (arch x shape) is a valid cell; the reason if skipped."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("quadratic full attention at 524288 tokens "
                       "(assignment: long_500k only for SSM/hybrid)")
    return True, ""


def step_fn(cfg: ModelConfig, shape: Shape, model=None):
    """The cell's step (no optimizer): the train branch returns the loss
    and metrics, the prefill branch the last token's logits, the decode
    branch ``(logits, cache)`` of one token."""
    model = model or make_model(cfg)
    if shape.kind == "train":
        def train_loss(params, batch):
            return model.loss(params, batch)
        return train_loss
    if shape.kind == "prefill":
        def prefill(params, batch):
            return model.prefill(params, batch)
        return prefill

    def decode(params, batch):
        return model.decode_step(params, batch["cache"], batch["tokens"],
                                 batch["position"])
    return decode
