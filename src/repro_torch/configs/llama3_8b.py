"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783",
)


def smoke():
    return FULL.with_(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                      d_ff=512, vocab_size=512, remat=False)
