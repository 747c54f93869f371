"""Model configuration for all supported architecture families.

A single ``ModelConfig`` describes dense / MoE / SSM / hybrid / enc-dec
(audio) / VLM backbones.  Layer heterogeneity (Jamba's 1:7 attn:mamba
interleave, MoE strides) is expressed as a *block pattern*: the layer stack
is ``n_blocks`` repetitions of a short per-block pattern, which lets the
forward pass ``lax.scan`` over blocks (keeping HLO size independent of depth)
while still supporting interleaved layer kinds inside the block body.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # hidden width of each routed expert
    n_shared: int = 0             # always-on shared experts (Qwen2-MoE)
    d_shared: int = 0             # hidden width of the shared expert block
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    ngroups: int = 1


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating block pattern."""
    mixer: str = "attn"           # "attn" | "mamba"
    ffn: str = "dense"            # "dense" | "moe" | "none"
    cross_attn: bool = False      # decoder layers of enc-dec models


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # --- block pattern -----------------------------------------------------
    # pattern of LayerSpec repeated n_layers/len(pattern) times; default:
    # a single uniform layer.
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # --- attention ---------------------------------------------------------
    rope_type: str = "standard"   # standard | partial | mrope | none
    rope_theta: float = 1e4
    partial_rotary_factor: float = 1.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    sliding_window: Optional[int] = None        # native SWA (Mixtral)
    # Beyond-paper: SWA window applied ONLY for the long_500k shape on
    # otherwise-full-attention archs (see DESIGN.md §Arch-applicability).
    long_context_window: Optional[int] = None
    qkv_bias: bool = False
    # For TPU 16-way tensor parallelism, head counts that do not divide the
    # model axis are padded (phi4: 24 -> 32).  Zero-initialised pad heads do
    # not change logits; the FLOP overhead is reported in the roofline.
    pad_heads_to: int = 0
    # --- mlp ---------------------------------------------------------------
    mlp_type: str = "swiglu"      # swiglu | relu2 | gelu
    # --- families ----------------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- enc-dec (whisper backbone) -----------------------------------------
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    cross_kv_len: int = 1500      # stubbed audio frontend frame count
    # --- embeddings ---------------------------------------------------------
    pos_embedding: str = "rope"   # rope | learned
    max_position: int = 1 << 20
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # citation for the assigned-architecture pool
    source: str = ""

    # ------------------------------------------------------------------ api
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"pattern length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def is_attention_free(self) -> bool:
        return all(s.mixer != "attn" for s in self.pattern)

    @property
    def has_subquadratic_path(self) -> bool:
        """True if long_500k decode is supported (see DESIGN.md)."""
        if self.encoder_decoder:
            return False
        return (self.is_attention_free
                or any(s.mixer == "mamba" for s in self.pattern)
                or self.sliding_window is not None
                or self.long_context_window is not None)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, dh, h, kv = self.d_model, self.head_dim_, self.padded_heads, self.n_kv_heads
        total = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.pos_embedding == "learned":
            total += min(self.max_position, 1 << 16) * d
        per_block = 0
        for spec in self.pattern:
            if spec.mixer == "attn":
                per_block += d * h * dh + 2 * d * kv * dh + h * dh * d
                if spec.cross_attn:
                    per_block += d * h * dh + 2 * d * kv * dh + h * dh * d
            else:
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                per_block += d * (2 * d_in + 2 * s.ngroups * s.d_state + nheads)
                per_block += d_in * d + s.d_conv * (d_in + 2 * s.ngroups * s.d_state)
            if spec.ffn == "dense":
                n_mats = 3 if self.mlp_type == "swiglu" else 2
                per_block += n_mats * d * self.d_ff
            elif spec.ffn == "moe":
                m = self.moe
                n_mats = 3 if self.mlp_type == "swiglu" else 2
                per_block += m.n_experts * n_mats * d * m.d_expert + d * m.n_experts
                if m.n_shared:
                    per_block += n_mats * d * m.d_shared
            per_block += 2 * d  # norms
        total += per_block * self.n_blocks
        if self.encoder_decoder:
            enc_per_layer = (d * h * dh + 2 * d * kv * dh + h * dh * d
                             + 2 * d * self.d_ff + 2 * d)
            total += enc_per_layer * self.n_encoder_layers
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n_mats = 3 if self.mlp_type == "swiglu" else 2
        moe_layers = sum(1 for s in self.pattern if s.ffn == "moe") * self.n_blocks
        inactive = (m.n_experts - m.top_k) * n_mats * self.d_model * m.d_expert
        return self.param_count() - moe_layers * inactive

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 pattern-blocks, d_model<=256, <=4 experts."""
        d = min(self.d_model, 256)
        dh = 32
        h = max(2, min(4, self.n_heads))
        kv = max(1, min(h, self.n_kv_heads if self.n_kv_heads < self.n_heads else h))
        if h % kv:
            kv = 1
        moe = None
        if self.moe is not None:
            n_e = min(4, self.moe.n_experts)
            k = min(2, self.moe.top_k)
            moe = dataclasses.replace(
                self.moe, n_experts=n_e, top_k=k, d_expert=64,
                d_shared=64 if self.moe.n_shared else 0,
                n_shared=min(1, self.moe.n_shared),
                # dropless in smoke tests: decode-vs-full consistency must
                # not depend on capacity-based token dropping
                capacity_factor=float(n_e) / k)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                      chunk_size=32)
        n_layers = 2 * len(self.pattern)
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=n_layers, d_model=d,
            n_heads=h, n_kv_heads=kv, head_dim=dh, d_ff=128,
            vocab_size=min(self.vocab_size, 512), moe=moe, ssm=ssm,
            n_encoder_layers=2 if self.encoder_decoder else 0,
            cross_kv_len=16 if self.encoder_decoder else self.cross_kv_len,
            pad_heads_to=0, max_position=1 << 15, dtype="float32",
            sliding_window=(8 if self.sliding_window else None),
            long_context_window=(8 if self.long_context_window else None))


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}
