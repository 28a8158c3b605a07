"""Architecture registry and the LM shapes (port of
``repro.configs.registry``).

The ids are the reference's ten, and every config is a copy of the
reference's. ``make_model`` builds each: ``LM`` for the dense family
(``qwen2-0.5b``, ``gemma-2b``, ``internlm2-20b``, ``gemma3-27b``), the MoE
family (``granite-moe-3b-a800m``, ``deepseek-v3-671b``), the VLM
(``qwen2-vl-7b``), the hybrid (``hymba-1.5b``) and the SSM family
(``xlstm-125m``), and ``EncDecLM`` for the encoder-decoder
(``whisper-tiny``). ``step_fn`` gives the train, prefill and decode steps
(decode's batch is ``{"cache", "tokens", "position"}``, as the
reference's; whisper's train and prefill batches also bring ``frames``).
``input_specs`` gives every input of a cell's step as tensors on the
``meta`` device (shapes and dtypes, no storage), where the reference gives
``jax.ShapeDtypeStruct``s; the dry-run (``launch/dryrun.py``) reads them.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.device import dtype_of
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.models.whisper import EncDecLM

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


def make_model(cfg: ModelConfig) -> LM | EncDecLM:
    """``EncDecLM`` for an encoder-decoder config, else ``LM``."""
    return EncDecLM(cfg) if cfg.enc_dec else LM(cfg)


def cell_supported(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """Whether (arch x shape) is a valid cell; the reason if skipped."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("quadratic full attention at 524288 tokens "
                       "(assignment: long_500k only for SSM/hybrid)")
    return True, ""


def _scale_batch(cfg: ModelConfig, shape: Shape,
                 scale: float) -> tuple[int, int]:
    b = max(1, int(shape.global_batch * scale))
    s = max(8, int(shape.seq_len * scale)) if scale < 1 else shape.seq_len
    return b, s


def input_specs(cfg: ModelConfig, shape: Shape, *, batch: int | None = None,
                seq: int | None = None) -> dict[str, Any]:
    """Every model input of the cell's step as a ``meta`` tensor (the
    reference's ``ShapeDtypeStruct`` stand-ins: shapes and dtypes, no
    storage) at the global batch and sequence, or at ``batch`` / ``seq``.
    A decode cell's cache is ``model.init_cache`` on the meta device."""
    b = batch if batch is not None else shape.global_batch
    s = seq if seq is not None else shape.seq_len
    i32 = torch.int32
    cdt = dtype_of(cfg.compute_dtype)

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.enc_dec:
            return {"frames": meta((b, cfg.enc_frames, cfg.d_model), cdt),
                    "tokens": meta((b, s), i32)}
        batch_d: dict[str, Any] = {}
        if cfg.frontend == "vision_stub":
            p = min(cfg.vision_patches, s // 2)
            batch_d["patch_embeds"] = meta((b, p, cfg.d_model), cdt)
            batch_d["tokens"] = meta((b, s - p), i32)
            if cfg.mrope:
                batch_d["positions"] = meta((3, b, s), i32)
        else:
            batch_d["tokens"] = meta((b, s), i32)
        return batch_d

    # decode: one new token against a cache of capacity == seq_len
    model = make_model(cfg)
    if cfg.enc_dec:
        cache = model.init_cache(None, b, s, cfg.enc_frames, device="meta")
    else:
        cache = model.init_cache(b, s, device="meta")
    return {"cache": cache, "tokens": meta((b, 1), i32),
            "position": meta((), i32)}


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
