"""Page geometry — what one physical page *is* for a model group
(DESIGN.md §12).

`BwapPagePool` historically baked in the dense-transformer layout
``[nl, pages, page_size, nkv, hd]`` twice over (one array for K, a
``zeros_like`` clone for V) and derived ``page_bytes`` from
``2 * page_size * nkv * hd``.  That is wrong for every other cache the
repo already carries configs for:

* **MLA latent K/V** (deepseek_v3, granite_moe): the per-token cache is
  one shared rope key of width ``qk_rope_head_dim`` plus one latent
  vector of width ``kv_lora_rank`` — asymmetric k/v widths, an order of
  magnitude smaller than materialized heads.
* **SSM recurrent state** (hymba/xlstm, ``models/ssm.py``): a sequence
  is ONE page of constant-size state that migrates between domains but
  never appends; "fork" means copy the state, not extend a CoW chain.
* **Encoder cross-attention K/V** (whisper): written once per
  utterance, read-only afterwards, shareable across every decode
  session of the same audio — a fixed page count set by the encoder
  frame budget, not by generated tokens.

`PageGeometry` captures exactly the three facts the placement stack
needs — bytes per page, the pages-for-tokens growth law, and the
shareability class — so pool/pagetable/fabric/scheduler stay
geometry-agnostic.  The default constructed from a `ModelConfig`
(:func:`geometry_for`) reproduces the historical layout bit-for-bit,
which is what keeps the whole single-group test surface unchanged.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.device import dtype_of


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Shape and growth law of one model group's physical pages.

    ``k_block`` / ``v_block`` are the trailing array dims of one page;
    the pool materializes ``(num_layers, total_pages) + k_block`` and
    ``(num_layers, total_pages) + v_block``.  They may differ (MLA) —
    nothing in the stack may assume ``v = zeros_like(k)``.

    ``fixed_pages`` non-None marks a constant-footprint geometry: a
    "sequence" owns exactly that many pages from birth and never grows
    (SSM state, encoder K/V).  ``shareable`` gates the prefix trie and
    CoW forks — non-shareable groups fork by copying state into fresh
    pages instead of refcounting a chain.
    """

    kind: str
    page_size: int                       # tokens per page (growth unit)
    num_layers: int
    itemsize: int                        # bytes per element
    k_block: tuple[int, ...]
    v_block: tuple[int, ...]
    shareable: bool = True
    fixed_pages: int | None = None

    def __post_init__(self):
        assert self.page_size >= 1 and self.num_layers >= 1
        assert self.itemsize >= 1 and self.k_block and self.v_block
        if self.fixed_pages is not None:
            assert self.fixed_pages >= 1

    # -- the three facts the stack consumes -----------------------------------

    @property
    def page_bytes(self) -> int:
        """Physical bytes of one page across all layers (k + v arrays)."""
        return ((math.prod(self.k_block) + math.prod(self.v_block))
                * self.itemsize * self.num_layers)

    @property
    def grows(self) -> bool:
        """Whether sequences of this geometry append pages as they decode."""
        return self.fixed_pages is None

    def pages_for_tokens(self, tokens: int) -> int:
        """Growth law: pages a sequence of ``tokens`` tokens occupies.
        Constant-footprint geometries hold ``fixed_pages`` regardless."""
        if self.fixed_pages is not None:
            return self.fixed_pages
        return -(-int(tokens) // self.page_size)

    def array_shapes(self, total_pages: int) -> tuple[tuple[int, ...],
                                                      tuple[int, ...]]:
        """(k_pool shape, v_pool shape) for a pool of ``total_pages``."""
        lead = (self.num_layers, int(total_pages))
        return lead + self.k_block, lead + self.v_block


# -- concrete geometries -------------------------------------------------------

def paged_kv_geometry(cfg, page_size: int) -> PageGeometry:
    """Standard dense-transformer paged K/V: symmetric
    ``[page_size, nkv, hd]`` blocks.  ``page_bytes`` reduces to the
    historical ``2 * page_size * nkv * hd * itemsize * num_layers``."""
    block = (page_size, cfg.num_kv_heads, cfg.head_dim_)
    return PageGeometry(
        kind="paged_kv", page_size=page_size, num_layers=cfg.num_layers,
        itemsize=dtype_of(cfg.compute_dtype).itemsize,
        k_block=block, v_block=block, shareable=True)


def mla_latent_geometry(cfg, page_size: int) -> PageGeometry:
    """MLA latent-compressed K/V (arXiv:2412.19437): per token the cache
    holds one shared rope key (``qk_rope_head_dim``) in the k array and
    one latent vector (``kv_lora_rank``) in the v array — asymmetric
    widths, far below ``2 * nkv * hd``."""
    assert cfg.mla is not None, f"{cfg.name}: no MLA config"
    return PageGeometry(
        kind="mla_latent", page_size=page_size, num_layers=cfg.num_layers,
        itemsize=dtype_of(cfg.compute_dtype).itemsize,
        k_block=(page_size, 1, cfg.mla.qk_rope_head_dim),
        v_block=(page_size, 1, cfg.mla.kv_lora_rank), shareable=True)


def ssm_state_geometry(cfg) -> PageGeometry:
    """Constant-size recurrent state as a 1-page never-growing
    "sequence".  The page migrates under BWAP like any other, but the
    growth law pins it at one page and the shareability class is off:
    recurrent state is mutated in place every step, so a fork must COPY
    the state into a fresh page — a CoW chain would alias live state.

    Mamba-style (``cfg.ssm``): k holds the ``[d_inner, state_dim]`` SSM
    state, v the ``[conv_dim, d_inner]`` conv tail.  xLSTM
    (``cfg.xlstm``): k holds per-head ``[dh, dh]`` mLSTM matrix memory,
    v the ``[dh]`` normalizer."""
    itemsize = dtype_of(cfg.compute_dtype).itemsize
    if cfg.xlstm is not None:
        nh, dh = cfg.num_heads, cfg.head_dim_
        k_block, v_block = (1, nh, dh * dh), (1, nh, dh)
    else:
        assert cfg.ssm is not None, f"{cfg.name}: no SSM/xLSTM config"
        inner = cfg.ssm.expand * cfg.d_model
        k_block = (1, inner, cfg.ssm.state_dim)
        v_block = (1, cfg.ssm.conv_dim, inner)
    return PageGeometry(
        kind="ssm_state", page_size=1, num_layers=cfg.num_layers,
        itemsize=itemsize, k_block=k_block, v_block=v_block,
        shareable=False, fixed_pages=1)


def encoder_kv_geometry(cfg, page_size: int) -> PageGeometry:
    """Read-only encoder cross-attention K/V (whisper): written once by
    the encoder, then a fixed ``ceil(enc_frames / page_size)`` pages
    shared by every decode session of the same utterance — a shareable
    tier like the prefix trie, but with a constant footprint."""
    assert cfg.enc_dec, f"{cfg.name}: not an encoder-decoder config"
    block = (page_size, cfg.num_kv_heads, cfg.head_dim_)
    return PageGeometry(
        kind="encoder_kv", page_size=page_size, num_layers=cfg.enc_layers,
        itemsize=dtype_of(cfg.compute_dtype).itemsize,
        k_block=block, v_block=block, shareable=True,
        fixed_pages=-(-cfg.enc_frames // page_size))


def geometry_for(cfg, page_size: int) -> PageGeometry:
    """Default geometry for a model config's *decode-path* cache.

    MLA configs get the latent layout, pure-SSM families the 1-page
    state, everything else (dense/vlm/hybrid attention, whisper
    *decoder* self-attention) the standard paged K/V — so every pool
    constructed before this module existed resolves to a geometry whose
    shapes and ``page_bytes`` are bit-identical to the old hardcoded
    layout.  Encoder K/V is never a default: it is a second cache
    alongside the decoder's, requested explicitly via
    :func:`encoder_kv_geometry`."""
    if cfg.mla is not None:
        return mla_latent_geometry(cfg, page_size)
    if cfg.family == "ssm":
        return ssm_state_geometry(cfg)
    return paged_kv_geometry(cfg, page_size)
