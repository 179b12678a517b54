"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) expert
d_ff=2048 vocab=163840, MoE 384e top-8 + 1 shared expert, first layer
dense (DeepSeek-V3 lineage)  [arXiv:2501.kimi2; unverified, paper-table].
NOTE: the assignment specifies GQA kv=8 (not MLA); we follow the
assignment."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    norm="rmsnorm", act="silu", mlp_gated=True, use_bias=False,
    pos="rope", rope_theta=50000.0,
    num_experts=384, top_k=8, moe_d_ff=2048, num_shared_experts=1,
    first_dense=1, norm_topk=True, capacity_factor=1.25,
)
