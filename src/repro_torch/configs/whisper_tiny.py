"""whisper-tiny [audio] — 4L d_model=384 6H d_ff=1536 vocab=51865,
enc-dec, conv frontend STUB (input_specs provides precomputed frame
embeddings) [arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865,
    norm="layernorm", act="gelu", mlp_gated=False, use_bias=True,
    pos="learned", encoder_layers=4, cross_attention=True,
    num_prefix_embeds=0, max_seq=65536,
)
# encoder frame count used by input_specs (30 s of audio at 50 Hz)
NUM_FRAMES = 1500
