"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-3-8b",
    arch_type="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    source="hf:ibm-granite/granite-3.0-2b-base",
)


def smoke():
    return FULL.with_(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                      d_ff=512, vocab_size=512, remat=False)
