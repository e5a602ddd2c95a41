"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
RWKV-6 "Finch": data-dependent decay linear recurrence. [arXiv:2404.05892]"""

from .base import AttnConfig, Block, ModelConfig, SSMConfig, Stage

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    d_model=2560,
    vocab_size=65536,
    d_ff=8960,
    stages=(Stage(pattern=(Block("rwkv", "mlp"),), repeats=32),),
    # attn config unused by rwkv blocks but harmless (head_dim for specs)
    attn=AttnConfig(num_heads=40, num_kv_heads=40, head_dim=64,
                    rope_theta=None, causal=True),
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    mlp_act="gelu",   # rwkv channel-mix uses squared-relu; gelu stands in
    max_seq_len=1 << 20,
    citation="arXiv:2404.05892",
)
