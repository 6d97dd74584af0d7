"""internlm2-1.8b [dense] — GQA [arXiv:2403.17297]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    source="arXiv:2403.17297",
)


def smoke():
    return FULL.with_(n_layers=2, d_model=256, n_heads=8, n_kv_heads=4,
                      d_ff=512, vocab_size=512, remat=False)
