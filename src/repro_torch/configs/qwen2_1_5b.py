"""qwen2-1.5b [dense] — GQA kv=2, QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-1.5b",
    arch_type="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    source="arXiv:2407.10671",
)


def smoke():
    return FULL.with_(n_layers=2, d_model=192, n_heads=6, n_kv_heads=2,
                      d_ff=384, vocab_size=512, remat=False)
