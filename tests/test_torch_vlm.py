"""The port's VLM family (internvl2-26b) against the JAX package, on the
CPU: the smoke model (2 layers, d_model 256, 8/2 heads, 16 patches, vocab
512) in fp32 compute through the registry: ``forward_train`` (text
positions only), the loss and its gradient (the vocab leaves, the patch
projector and a layer leaf), ``prefill`` over patches and text, decode
steps at a scalar position and at one position per row, the batch and
cache specs, two federated StoCFL rounds set up as ``run_llm`` sets them
up, and the training driver on the CPU. The reference's parameters cross
over through ``repro_torch.convert``; patches and tokens are made with
numpy. Floats within 1e-5 of the largest |value|
(``_torch_family.close``).
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_family as fam  # noqa: E402
from repro_torch import serve  # noqa: E402

ARCH = "internvl2-26b"
SEQ = 28                    # 16 patches + 12 text tokens
N_TEXT = 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke models: one intra-op thread, so a parallel test run's
    oversubscribed CPU does not stall the thread pool's barriers."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def case():
    c = fam.make_case(ARCH, SEQ)
    assert c.batch["patches"].shape == (2, 16, 256) and c.batch["tokens"].shape == (2, N_TEXT)
    return c


def test_init_layout_matches_reference(case):
    fam.check_init_layout(case)
    assert tuple(case.tparams["patch_proj"].shape) == (256, 256)


def test_forward_train_gives_text_logits_matching_reference(case):
    fam.check_forward(case)
    logits, _ = case.tmodel.forward_train(case.tparams, case.tbatch())
    assert tuple(logits.shape) == (2, N_TEXT, case.tcfg.vocab_size)


def test_patches_reach_the_text_logits(case):
    """The text logits depend on the vision prefix (the stack is causal
    over patches then text)."""
    b = case.tbatch()
    other = dict(b, patches=b["patches"].flip(0))
    with torch.no_grad():
        a, _ = case.tmodel.forward_train(case.tparams, b)
        c, _ = case.tmodel.forward_train(case.tparams, other)
    assert not torch.allclose(a, c)


def test_loss_and_gradient_match_reference(case):
    fam.check_loss_and_gradient(case, [("patch_proj",), ("layers", "attn", "wq")])


def test_prefill_logits_and_caches_match_reference(case):
    fam.check_prefill(case)


def test_decode_steps_at_a_scalar_position_match_reference(case):
    fam.check_decode_scalar(case, SEQ)


def test_decode_steps_with_a_position_per_row_match_reference(case):
    fam.check_decode_per_row(case, SEQ)


def test_specs_and_caches_have_the_reference_shapes(case):
    fam.check_specs(case, 40)
    specs = case.tmodel.input_specs(fam.InputShape("short", 10, 1, "train"))
    assert specs["tokens"].shape == (1, 8)          # n_text = max(seq_len - n_patches, 8)


@pytest.fixture(scope="module")
def rounds(case):
    return fam.run_rounds(case, SEQ)


def test_federated_rounds_match_reference(rounds):
    fam.check_rounds(rounds)


def test_psi_leaf_filter_keeps_the_vocab_leaves():
    fam.check_leaf_filter(ARCH, 1_137_291_264)


def test_training_driver_runs_on_the_cpu(capsys):
    fam.check_driver(capsys, ARCH)


def test_serving_engine_refuses_the_family(case):
    with pytest.raises(ValueError, match="token-LM only"):
        serve.ServeEngine(case.tmodel, None, serve.ServeConfig())
