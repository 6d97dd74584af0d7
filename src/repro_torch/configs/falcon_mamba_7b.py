"""falcon-mamba-7b [ssm] — Mamba1, attention-free [arXiv:2410.05355]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    n_layers=64,
    d_model=4096,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_version=1,
    source="arXiv:2410.05355",
)


def smoke():
    return FULL.with_(n_layers=2, d_model=128, vocab_size=512, ssm_state=16,
                      remat=False)
