"""The port's encoder-decoder family (whisper-medium) against the JAX
package, on the CPU: LayerNorm, the GELU MLP, bidirectional and cross
attention, then the smoke model (2 encoder and 2 decoder layers, d_model
128, 64 frames, vocab 512) in fp32 compute through the registry:
``forward_train``, the loss and its gradient, ``prefill``, decode steps
at a scalar position and at one position per row, the batch and cache
specs, two federated StoCFL rounds set up as ``run_llm`` sets them up,
and the training driver on the CPU. The reference's parameters cross over
through ``repro_torch.convert``; frames and tokens are made with numpy.
Floats within 1e-5 of the largest |value| (``_torch_family.close``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_family as fam  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

ARCH = "whisper-medium"
SEQ = 12                    # decoder tokens; the encoder runs the config's 64 frames


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
    return fam.make_case(ARCH, SEQ)


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("offset", [0.0, 30.0])
def test_layernorm_matches_reference(offset):
    """The population variance in fp32 (an offset row is where the sample
    variance, ``torch.var``'s default, would show)."""
    rng = np.random.default_rng(1)
    x = _np(rng, 3, 5, 48) + offset
    p = {"scale": _np(rng, 48), "bias": _np(rng, 48)}
    got = tlayers.layernorm(convert.to_torch(p), torch.as_tensor(x))
    fam.close(got, jax.jit(jlayers.layernorm)(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    init = tlayers.layernorm_init(48)
    assert sorted(init) == ["bias", "scale"] and torch.equal(init["scale"], torch.ones(48))


def test_gelu_mlp_matches_reference():
    """The tanh approximation (``jax.nn.gelu``'s default), with biases."""
    rng = np.random.default_rng(2)
    p = {"w_up": _np(rng, 32, 80, scale=0.3), "b_up": _np(rng, 80),
         "w_down": _np(rng, 80, 32, scale=0.2), "b_down": _np(rng, 32)}
    x = _np(rng, 2, 7, 32)
    got = tlayers.gelu_mlp(convert.to_torch(p), torch.as_tensor(x))
    fam.close(got, jax.jit(jlayers.gelu_mlp)(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    init = tlayers.gelu_mlp_init(torch.Generator().manual_seed(0), 32, 80)
    assert {k: tuple(v.shape) for k, v in init.items()} == {k: v.shape for k, v in p.items()}


def test_bidirectional_and_cross_attention_match_reference():
    rng = np.random.default_rng(3)
    cfg = fam.cfgs(ARCH)[1].with_(n_kv_heads=2)      # GQA: 4 query heads over 2 kv heads
    tp = {k: torch.as_tensor(_np(rng, *v.shape, scale=0.1)) for k, v in
          tattn.gqa_init(torch.Generator().manual_seed(0), cfg).items()}
    x, enc = _np(rng, 2, 9, cfg.d_model), _np(rng, 2, 20, cfg.d_model)
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(tp))
    fam.close(tattn.bidir_attention(tp, torch.as_tensor(x), cfg),
              jax.jit(lambda p, x: jattn.bidir_attention(p, x, cfg))(jp, jnp.asarray(x)))
    cp = {k: torch.as_tensor(_np(rng, *v.shape, scale=0.1)) for k, v in
          tattn.cross_attn_init(torch.Generator().manual_seed(0), cfg).items()}
    jcp = jax.tree.map(jnp.asarray, convert.to_numpy(cp))
    tkv = tattn.cross_kv(cp, torch.as_tensor(enc), cfg)
    jkv = jax.jit(lambda p, e: jattn.cross_kv(p, e, cfg))(jcp, jnp.asarray(enc))
    for k in ("k", "v"):
        fam.close(tkv[k], jkv[k])
    fam.close(tattn.cross_attend(cp, torch.as_tensor(x), tkv, cfg),
              jax.jit(lambda p, x, kv: jattn.cross_attend(p, x, kv, cfg))(jcp, jnp.asarray(x), jkv))


def test_init_layout_matches_reference(case):
    fam.check_init_layout(case)


def test_forward_train_matches_reference(case):
    fam.check_forward(case)


def test_loss_and_gradient_match_reference(case):
    fam.check_loss_and_gradient(case, [("dec_layers", "cross", "wq"),
                                       ("enc_layers", "attn", "wk")])


def test_prefill_logits_and_caches_match_reference(case):
    fam.check_prefill(case)


def test_decode_steps_at_a_scalar_position_match_reference(case):
    fam.check_decode_scalar(case, SEQ)


def test_decode_steps_with_a_position_per_row_match_reference(case):
    fam.check_decode_per_row(case, SEQ)


def test_specs_and_caches_have_the_reference_shapes(case):
    fam.check_specs(case, 40)


@pytest.fixture(scope="module")
def rounds(case):
    return fam.run_rounds(case, SEQ)


def test_federated_rounds_match_reference(rounds):
    fam.check_rounds(rounds)


def test_psi_leaf_filter_keeps_the_vocab_leaves():
    fam.check_leaf_filter(ARCH, 106_219_520)


def test_training_driver_runs_on_the_cpu(capsys):
    fam.check_driver(capsys, ARCH)


def test_serving_engine_refuses_the_family(case):
    with pytest.raises(ValueError, match="token-LM only"):
        serve.ServeEngine(case.tmodel, None, serve.ServeConfig())
