"""``cfg.remat`` in every family of the port: the layer checkpoint
(``models.layers.remat``) gives the same loss and gradient as the plain
layers, through the registry's ``loss_fn`` and through the cohort update
(``core.bilevel.make_cohort_update``, fused and tree, under
``torch.func.vmap``), and runs only where a gradient may be taken. Smoke
configs in fp32 on the CPU; falcon-mamba with ``use_pallas=True``, so
the ``SSMScan`` function (its plain versions here) runs inside the
recompute. Tolerance rtol 1e-5, atol 1e-6: the recompute repeats the
same operations on the same inputs. One ``cuda`` case measures the peak
memory of a loss and gradient with and without remat on the card.

This file imports only torch and the port.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.bilevel import make_cohort_update  # noqa: E402
from repro_torch.data.tokens import synthetic_lm_batch  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

ARCHS = {"dense": ("qwen2-1.5b", {}), "moe": ("phi3.5-moe-42b-a6.6b", {}),
         "moe_mla": ("deepseek-v2-236b", {}), "ssm": ("falcon-mamba-7b", {"use_pallas": True}),
         "hybrid": ("zamba2-1.2b", {}), "audio": ("whisper-medium", {}),
         "vlm": ("internvl2-26b", {})}
SEQ, BATCH = 24, 2
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _setting(family, remat, seed=0):
    arch, kw = ARCHS[family]
    cfg = get_config(arch, smoke=True, dtype="float32", remat=remat, **kw)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in
             synthetic_lm_batch(cfg, SEQ + (cfg.n_patches or 0), BATCH, seed=seed).items()}
    return model, params, batch


def _loss_and_grad(model, params, batch):
    p = trees.tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss = model.loss_fn(p, batch)
    return loss.detach(), torch.autograd.grad(loss, trees.leaves(p))


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_loss_and_gradient_equal_with_remat(family):
    plain, params, batch = _setting(family, remat=False)
    rematted = build(plain.cfg.with_(remat=True))
    l0, g0 = _loss_and_grad(plain, params, batch)
    l1, g1 = _loss_and_grad(rematted, params, batch)
    torch.testing.assert_close(l1, l0, **TOL)
    assert len(g0) == len(g1)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "tree"])
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_cohort_update_under_vmap_equal_with_remat(family, fused):
    """Two clients, two local steps of the bilevel update: θ and ω equal."""
    plain, params, batch = _setting(family, remat=False)
    other = _setting(family, remat=False, seed=1)[2]
    batches = {k: torch.stack([batch[k], other[k]]) for k in batch}
    thetas = trees.tree_map(lambda x: torch.stack([x, 1.01 * x]), params)
    out = []
    for remat in (False, True):
        model = build(plain.cfg.with_(remat=remat))
        update = make_cohort_update(model.loss_fn, lr=0.05, lam=0.05, local_steps=2,
                                    fused=fused)
        out.append(update(thetas, params, batches))
    for a, b in zip(trees.leaves(out[1]), trees.leaves(out[0])):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid", "audio"])
def test_prefill_under_a_gradient_equal_with_remat(family):
    """Prefill's logits and caches equal, and a gradient through them
    within 1e-5 of each leaf's largest |gradient|: a leaf read in several
    places (zamba2's embedding feeds the stack and every shared-block
    application) sums its parts in another order when some come through
    the checkpoint."""
    plain, params, batch = _setting(family, remat=False)
    out = []
    for remat in (False, True):
        model = build(plain.cfg.with_(remat=remat))
        p = trees.tree_map(lambda x: x.detach().requires_grad_(True), params)
        logits, cache = model.prefill(p, batch)
        total = logits.square().sum() + sum(c.square().sum() for c in trees.leaves(cache)
                                            if c.is_floating_point())
        out.append([logits.detach()] + [c.detach() for c in trees.leaves(cache)]
                   + list(torch.autograd.grad(total, trees.leaves(p))))
    n = 1 + len(trees.leaves(cache))
    for a, b in zip(out[1][:n], out[0][:n]):
        torch.testing.assert_close(a, b, **TOL)
    for a, b in zip(out[1][n:], out[0][n:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_remat_runs_only_where_a_gradient_may_be_taken(monkeypatch, family):
    """With remat set, each layer of a loss under grad goes through the
    checkpoint; under ``no_grad`` (serving, evaluation) none does, and
    neither does any with remat off."""
    calls = []
    real = layers._Remat.apply
    monkeypatch.setattr(layers._Remat, "apply", lambda *a: calls.append(1) or real(*a))
    plain, params, batch = _setting(family, remat=False)
    cfg = plain.cfg
    rematted = build(cfg.with_(remat=True))
    with torch.no_grad():
        rematted.loss_fn(params, batch)
    assert not calls
    _loss_and_grad(plain, params, batch)
    assert not calls
    _loss_and_grad(rematted, params, batch)
    want = cfg.n_layers + (cfg.n_enc_layers if cfg.arch_type == "audio" else 0)
    assert len(calls) == want


@pytest.mark.parametrize("cohort", [False, True], ids=["loss", "cohort_update"])
def test_scan_kernel_operands_have_storage_under_remat(monkeypatch, cohort):
    """On the card K5's wrappers hand each operand's pointer to the kernel.
    Under remat the scan's forward and backward run again inside
    ``torch.func.vjp`` (and the cohort update's vmap), whose wrapped
    tensors have no storage. Here the plain versions take every operand's
    pointer first, as the kernel call does, so a wrapped operand fails on
    the CPU too; the results must equal the plain layers'."""
    from repro_torch.kernels import ssm_scan

    def taking_pointers(real):
        def call(*operands):
            for x in operands:
                x.data_ptr()
            return real(*operands)
        return call

    plain, params, batch = _setting("ssm", remat=False)
    rematted = build(plain.cfg.with_(remat=True))
    out = []
    for model in (plain, rematted):
        with monkeypatch.context() as mp:
            for name in ("scan_fwd", "scan_bwd"):
                mp.setattr(ssm_scan, name, taking_pointers(getattr(ssm_scan, name)))
            if cohort:
                batches = {k: torch.stack([v, v.flip(0)]) for k, v in batch.items()}
                thetas = trees.tree_map(lambda x: torch.stack([x, 1.01 * x]), params)
                update = make_cohort_update(model.loss_fn, lr=0.05, lam=0.05, local_steps=1,
                                            fused=True)
                out.append(trees.leaves(update(thetas, params, batches)))
            else:
                out.append(list(_loss_and_grad(model, params, batch)[1]))
    for a, b in zip(out[1], out[0]):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
def test_remat_lowers_the_peak_of_a_loss_and_gradient_on_the_card():
    """qwen2's smoke family widened to 8 layers, d_model 512, 8/2 heads,
    d_ff 2048, over 4 x 1024 tokens in fp32: without remat every layer
    keeps its attention logits and probabilities (2 x 128 MB) for the
    backward; with it only the (4, 1024, 512) boundaries and one layer's
    recompute. The peak with remat must be below the peak without, by at
    least half."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = get_config("qwen2-1.5b", smoke=True, dtype="float32").with_(
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=2, d_ff=2048)
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    peaks, grads = [], []
    for remat in (False, True):
        model = build(cfg.with_(remat=remat))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, g = _loss_and_grad(model, params, {"tokens": tokens})
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        grads.append(g)
        del g
    assert peaks[1] < 0.5 * peaks[0], peaks
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
