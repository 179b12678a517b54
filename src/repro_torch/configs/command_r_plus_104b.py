"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000, no-bias [hf:CohereForAI/c4ai-command-r-v01;
unverified]. Cohere flavour: parallel attn∥mlp block, LayerNorm,
logit scaling, full rotary."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    norm="layernorm", act="silu", mlp_gated=True, use_bias=False,
    parallel_block=True, logit_scale=0.0625, pos="rope", rope_theta=75000.0,
    tie_embeddings=True,
)
