"""zamba2-1.2b [hybrid] — Mamba2 core + shared attention blocks
[arXiv:2411.15242]. Shared GQA block applied every 6 core layers; its KV
cache uses a 4096 sliding window so the hybrid runs long_500k natively."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_version=2,
    attn_every=6,
    sliding_window=4096,
    source="arXiv:2411.15242",
)


def smoke():
    return FULL.with_(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                      d_ff=256, vocab_size=512, ssm_state=16, ssm_head_dim=32,
                      attn_every=2, sliding_window=64, remat=False)
