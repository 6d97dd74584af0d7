"""Checks shared by ``test_torch_encdec.py`` and ``test_torch_vlm.py``: one
model family of the port against the JAX package's, on the CPU.

``Case`` holds both packages' fp32 smoke models, the reference's
parameters (carried across by ``repro_torch.convert``) and one batch made
with numpy. Floats are held within 1e-5 of the largest |value| of the
reference's side (``close``): the same fp32 arithmetic summed in another
order by PyTorch's and XLA's CPU kernels.
"""
from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import engine as jengine
from repro.core import extractor as jextractor
from repro.data import tokens as jtokens
from repro.models import registry as jregistry
from repro.models.config import InputShape as JInputShape
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import engine as tengine
from repro_torch.core import extractor as textractor
from repro_torch.launch import train as ttrain
from repro_torch.models import registry as tregistry
from repro_torch.models.config import InputShape
from repro_torch.utils import trees

RTOL = 1e-5                 # of the largest |value| on the reference's side
STEPS = 4                   # decode steps
ROUNDS = 2                  # federated rounds
CLIENTS, DOMAINS, PER_CLIENT = 4, 2, 2
# run_llm's engine settings (launch/train.py), at path 3's knobs and 2 local steps
ENGINE = dict(tau=0.12, lam=0.05, lr=0.05, local_steps=2, sample_rate=0.5, seed=0,
              project_dim=8192, fused_step=True)


def close(got, want, rtol=RTOL):
    """|got - want| within ``rtol`` of the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rtol * scale, f"max |diff| {err:.3e} > {rtol:g} x {scale:.3e}"


def _jitted(jmodel):
    """The reference model with its entry points compiled whole."""
    return jmodel._replace(**{f: jax.jit(getattr(jmodel, f)) for f in
                              ("init", "forward_train", "loss_fn", "prefill", "decode")})


class Case(NamedTuple):
    jcfg: object
    tcfg: object
    jmodel: object
    tmodel: object
    jparams: object
    tparams: object
    batch: dict             # numpy

    def jbatch(self):
        return {k: jnp.asarray(v) for k, v in self.batch.items()}

    def tbatch(self):
        return {k: torch.as_tensor(v) for k, v in self.batch.items()}


def cfgs(arch, **kw):
    kw = {"dtype": "float32", **kw}
    return (jconfigs.get_config(arch, smoke=True, **kw),
            tconfigs.get_config(arch, smoke=True, **kw))


def make_case(arch, seq_len, batch=2) -> Case:
    jcfg, tcfg = cfgs(arch)
    jmodel, tmodel = _jitted(jregistry.build(jcfg)), tregistry.build(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    data = jtokens.synthetic_lm_batch(jcfg, seq_len, batch, seed=3, domain=1)
    return Case(jcfg, tcfg, jmodel, tmodel, jparams, convert.to_torch(jparams), data)


def check_init_layout(case):
    """The port's own init has the reference's tree, shapes and dtypes."""
    got = case.tmodel.init(torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_flatten_with_path(case.jparams)[0]
    assert textractor.leaf_paths(got) == ["/".join(str(k.key) for k in kp) for kp, _ in want]
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in trees.leaves(got)] == \
        [(tuple(w.shape), str(w.dtype)) for _, w in want]


def check_forward(case):
    want, jaux = case.jmodel.forward_train(case.jparams, case.jbatch())
    got, aux = case.tmodel.forward_train(case.tparams, case.tbatch())
    close(got, want)
    assert got.dtype == torch.float32 and float(aux) == float(jaux) == 0.0


def check_loss_and_gradient(case, layer_leaves):
    """The loss, and its gradient on the vocab leaves and on
    ``layer_leaves`` (paths into the parameter tree)."""
    jg = jax.jit(jax.value_and_grad(case.jmodel.loss_fn))(case.jparams, case.jbatch())
    params = trees.tree_map(lambda x: x.clone().requires_grad_(True), case.tparams)
    loss = case.tmodel.loss_fn(params, case.tbatch())
    close(loss.detach(), jg[0])
    paths = [("embed",), ("lm_head",)] + list(layer_leaves)
    pick = lambda tree, path: tree if not path else pick(tree[path[0]], path[1:])
    grads = torch.autograd.grad(loss, [pick(params, p) for p in paths])
    for path, g in zip(paths, grads):
        close(g, pick(jg[1], path))


def check_prefill(case):
    jlog, jcache = case.jmodel.prefill(case.jparams, case.jbatch())
    with torch.no_grad():
        tlog, tcache = case.tmodel.prefill(case.tparams, case.tbatch())
    close(tlog, jlog)
    assert textractor.leaf_paths(tcache) == [
        "/".join(str(k.key) for k in kp) for kp, _ in jax.tree_util.tree_flatten_with_path(jcache)[0]]
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        close(a, b)
    return jlog, jcache, tcache


def check_decode_scalar(case, prefix_len):
    """STEPS greedy steps at one scalar position, both caches grown to
    ``prefix_len + STEPS`` first, each step from the reference's token."""
    jlog, jcache, tcache = check_prefill(case)
    B, total = jlog.shape[0], prefix_len + STEPS
    jcache = jregistry.grow_cache(case.jmodel, jcache, B, total)
    tcache = tregistry.grow_cache(case.tmodel, tcache, B, total)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    with torch.no_grad():
        for t in range(STEPS):
            jlog, jcache = case.jmodel.decode(case.jparams, jnp.asarray(tok), jcache,
                                              jnp.int32(prefix_len + t))
            tlog, tcache = case.tmodel.decode(case.tparams, torch.as_tensor(tok), tcache,
                                              prefix_len + t)
            close(tlog, jlog)
            tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        close(a, b)


def check_decode_per_row(case, prefix_len):
    """STEPS steps with one position per row (row b at ``prefix_len - 2b``,
    so each row writes and reads its own entry) against ``jax.vmap`` of
    the reference's batch-1 decode at each row's scalar position."""
    jlog, jcache, tcache = check_prefill(case)
    B, total = jlog.shape[0], prefix_len + STEPS
    jcache = jregistry.grow_cache(case.jmodel, jcache, B, total)
    tcache = tregistry.grow_cache(case.tmodel, tcache, B, total)

    def one(tok, cache, pos):
        cache = jax.tree.map(lambda x: x[:, None], cache)
        logits, new = case.jmodel.decode(case.jparams, tok[None], cache, pos)
        return logits[0], jax.tree.map(lambda x: x[:, 0], new)

    row_decode = jax.jit(jax.vmap(one, in_axes=(0, 1, 0), out_axes=(0, 1)))
    pos = np.array([prefix_len - 2 * b for b in range(B)], np.int32)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    with torch.no_grad():
        for t in range(STEPS):
            jlog, jcache = row_decode(jnp.asarray(tok), jcache, jnp.asarray(pos + t))
            tlog, tcache = case.tmodel.decode(case.tparams, torch.as_tensor(tok), tcache,
                                              torch.as_tensor(pos + t))
            close(tlog, jlog)
            tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        close(a, b)


def check_specs(case, seq_len):
    """``input_specs``, ``decode_specs``, ``grow_cache`` and
    ``serve_cache_specs`` give the reference's shapes and dtypes."""
    jm, tm = jregistry.build(case.jcfg), tregistry.build(case.tcfg)
    shape = (InputShape("s", seq_len, 3, "train"), JInputShape("s", seq_len, 3, "train"))
    got, want = tm.input_specs(shape[0]), jm.input_specs(shape[1])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape)
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    for got, want in ((tregistry.serve_cache_specs(tm, 3, 4, 40),
                       jregistry.serve_cache_specs(jm, 3, 4, 40)),
                      (tregistry.decode_specs(tm, InputShape("d", 40, 4, "decode"))["cache"],
                       jregistry.decode_specs(jm, JInputShape("d", 40, 4, "decode"))["cache"])):
        assert [(s.shape, str(s.dtype).split(".")[-1]) for s in trees.leaves(got)] == \
            [(tuple(w.shape), str(w.dtype)) for w in jax.tree.leaves(want)]
    with torch.no_grad():
        _, cache = case.tmodel.prefill(case.tparams, case.tbatch())
    grown = tregistry.grow_cache(case.tmodel, cache, 2, 50)
    jgrown = jax.eval_shape(lambda: jm.make_cache(2, 50))
    assert [tuple(x.shape) for x in trees.leaves(grown)] == \
        [tuple(w.shape) for w in jax.tree.leaves(jgrown)]
    for g, c in zip(trees.leaves(grown), trees.leaves(cache)):
        assert torch.equal(g[tuple(slice(0, n) for n in c.shape)], c)


def _jax_draws(n, dim, seed):
    """The reference's ``_jl_sketch`` draws, as ``jl_draws`` returns them."""
    kb, ks = jax.random.split(jax.random.PRNGKey(seed))
    buckets = np.array(jax.random.randint(kb, (n,), 0, dim))
    signs = np.array(jax.random.rademacher(ks, (n,), dtype=jnp.float32))
    return (torch.as_tensor(buckets, dtype=torch.int32),
            torch.as_tensor(signs).to(torch.int8))


def run_rounds(case, seq_len):
    """ROUNDS StoCFL rounds of both engines from the reference's
    parameters, set up as ``run_llm`` sets them up (the vocab-leaf filter,
    Ψ sketched to 8192, ``fused_step``), with the reference's sketch draws
    fed to the port. Returns one (cohorts, records, states) tuple a round."""
    clients = [jtokens.synthetic_lm_batch(case.jcfg, seq_len, PER_CLIENT, seed=i,
                                          domain=i % DOMAINS) for i in range(CLIENTS)]
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(textractor, "jl_draws", _jax_draws)
        js = jengine.init("stocfl", case.jmodel.loss_fn, case.jparams,
                          [jax.tree.map(jnp.asarray, c) for c in clients],
                          jengine.EngineConfig(**ENGINE), leaf_filter=jextractor.llm_leaf_filter)
        ts = tengine.init("stocfl", case.tmodel.loss_fn, case.tparams, clients,
                          tengine.EngineConfig(**ENGINE), device="cpu",
                          leaf_filter=textractor.llm_leaf_filter)
        for _ in range(ROUNDS):
            _, jids = jengine.sample_clients(js)
            _, tids = tengine.sample_clients(ts)
            js, jrec = jengine.run_round(js)
            ts, trec = tengine.run_round(ts)
            out.append((np.asarray(jids), np.asarray(tids), jrec, trec, js, ts))
    return out


def check_rounds(rounds):
    """Cohorts, n_clusters and partitions equal; ω and the bank rows
    within 1e-5."""
    for jids, tids, jrec, trec, js, ts in rounds:
        assert np.array_equal(jids, tids) and len(tids) == CLIENTS // 2
        assert jrec["n_clusters"] == trec["n_clusters"]
        assert js.clusters.assignment() == ts.clusters.assignment()
        assert tuple(js.models.roots) == tuple(ts.models.roots)
        for jtree, ttree in [(js.omega, ts.omega)] + [(js.models[r], ts.models[r])
                                                      for r in js.models.roots]:
            for a, b in zip(jax.tree.leaves(jtree), trees.leaves(ttree)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)


def check_leaf_filter(arch, want_kept):
    """Ψ's vocab-leaf filter keeps the reference's leaves (``embed`` and
    ``lm_head``), and at the full config those hold ``want_kept`` entries
    (shapes from ``jax.eval_shape``: nothing is allocated)."""
    jcfg, tcfg = cfgs(arch)
    tpaths = textractor.leaf_paths(tregistry.build(tcfg).init(torch.Generator().manual_seed(0)))
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(jregistry.build(jcfg).init, jax.random.PRNGKey(0)))[0]
    jpaths = ["/".join(str(k.key) for k in kp) for kp, _ in jflat]
    assert tpaths == jpaths
    assert [textractor.llm_leaf_filter(p) for p in tpaths] == \
        [jextractor.llm_leaf_filter(p) for p in jpaths]
    assert [p for p in tpaths if textractor.llm_leaf_filter(p)] == ["embed", "lm_head"]
    full = jax.eval_shape(jregistry.build(jconfigs.get_config(arch)).init, jax.random.PRNGKey(0))
    kept = sum(int(np.prod(s.shape)) for kp, s in jax.tree_util.tree_flatten_with_path(full)[0]
               if textractor.llm_leaf_filter("/".join(str(k.key) for k in kp)))
    assert kept == want_kept


def check_driver(capsys, arch):
    """``python -m repro_torch.launch.train --arch <arch> --smoke --device
    cpu`` runs and prints the reference's JSON keys last."""
    out = ttrain.main(["--arch", arch, "--smoke", "--rounds", "1", "--clients", "2",
                       "--seq-len", "24", "--batch", "1", "--fused-step", "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.startswith("round 0: clusters=")
    last = json.loads(text[text.rindex("{\n"):])
    assert last == out and set(out) == {"arch", "ari", "n_clusters", "rounds", "wall_s"}
    assert out["arch"] == arch and np.isfinite(out["ari"])
