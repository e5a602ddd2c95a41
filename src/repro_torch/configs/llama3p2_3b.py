"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256. [hf:meta-llama/Llama-3.2-1B family]"""

from .base import AttnConfig, Block, ModelConfig, Stage

CONFIG = ModelConfig(
    name="llama3.2-3b",
    arch_type="dense",
    d_model=3072,
    vocab_size=128256,
    d_ff=8192,
    stages=(Stage(pattern=(Block("attn", "mlp"),), repeats=28),),
    attn=AttnConfig(num_heads=24, num_kv_heads=8, head_dim=128,
                    rope_theta=500000.0, causal=True),
    mlp_act="swiglu",
    tie_embeddings=True,
    max_seq_len=131072,
    citation="hf:meta-llama/Llama-3.2-1B",
)
