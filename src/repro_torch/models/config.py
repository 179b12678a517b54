"""Model configuration for every supported architecture family (a copy of
the reference's ``repro.models.config``: the same fields, defaults and
derived properties, so the two packages read one config alike)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention / block flavour
    qk_norm: bool = False
    partial_rotary: float = 1.0    # fraction of head_dim that rotates
    use_bias: bool = False
    tie_embeddings: bool = False
    act: str = "silu"
    mlp_gated: bool = True
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    pos: str = "rope"              # rope | learned | none
    parallel_block: bool = False   # cohere-style attn ∥ mlp
    logit_scale: float = 1.0
    rope_theta: float = 10000.0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    moe_every: int = 1             # MoE on layers with (i % moe_every == moe_offset)
    moe_offset: int = 0
    first_dense: int = 0           # leading dense layers (DeepSeek/Kimi style)
    norm_topk: bool = False
    capacity_factor: float = 1.25

    # SSM / hybrid (Jamba)
    attn_every: int = 0            # 1 attention layer per `attn_every` (0 = all attn)
    attn_offset: int = 0
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    # RWKV6
    rwkv: bool = False

    # encoder-decoder (Whisper)
    encoder_layers: int = 0
    cross_attention: bool = False

    # modality frontend stub (audio frames / vision patches)
    num_prefix_embeds: int = 0

    max_seq: int = 532_480
    dtype: str = "bfloat16"

    # the reference lays all layers out explicitly instead of scanning
    # periods when set (its roofline instrumentation); the port runs one
    # module a layer eagerly either way, and keeps the field so that the two
    # configs have the same fields
    unroll_layers: bool = False

    # which shape cells apply (full-attention archs skip long_500k)
    supports_long_context: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        return (self.vocab_size + 127) // 128 * 128

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0 or i < self.first_dense:
            return False
        return (i % self.moe_every) == self.moe_offset

    def is_attn_layer(self, i: int) -> bool:
        """hybrid (Jamba): one attention layer per `attn_every` block."""
        if self.rwkv:
            return False
        if self.attn_every == 0:
            return True
        return (i % self.attn_every) == self.attn_offset

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family (per spec: small
        layers/width, few experts, tiny vocab)."""
        small = dict(
            num_layers=max(2, self.attn_every or 2) if self.family == "hybrid" else 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            max_seq=512,
            dtype="float32",
        )
        if self.num_experts:
            small.update(num_experts=4, top_k=min(self.top_k, 2), moe_d_ff=64)
        if self.encoder_layers:
            small.update(encoder_layers=2)
        if self.num_prefix_embeds:
            small.update(num_prefix_embeds=4)
        small.update(overrides)
        return dataclasses.replace(self, **small)
