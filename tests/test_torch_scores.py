"""Scores and losses of the port against the JAX package (values and grads).

Inputs are made with numpy and handed to both. Tolerances: 2e-5 for f32
forward values, 2e-4 for gradients (the two frameworks sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as JL
from repro.core import scores as JS
from repro_torch.core import losses as TL
from repro_torch.core import scores as TS

torch.set_num_threads(2)

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
B, K, D, NG = 6, 5, 8, 2
REL_DIM = {"transr": 4, "rescal": D}


def _inputs(model, seed, lead=()):
    rng = np.random.default_rng(seed)
    rd = REL_DIM.get(model, D)
    f = lambda *s: (0.5 * rng.standard_normal(lead + s)).astype(np.float32)
    x = {"h": f(B, D), "r": f(B, rd), "t": f(B, D), "negs": f(K, D),
         "w_pos": f(B), "w_neg": f(B, K)}
    if model in REL_DIM:
        x["proj"] = f(B, D * rd)
    return x, rd


def _t(a):
    return torch.tensor(a, requires_grad=True)


def _grad(a):
    # an input the score does not use (RESCAL's r) has no grad; JAX's is 0
    return np.zeros(a.shape, np.float32) if a.grad is None else a.grad.numpy()


@pytest.mark.parametrize("model", JS.MODELS)
def test_positive_score_and_grads(model):
    x, rd = _inputs(model, 0)
    jctx = JS.ShardCtx(None)
    names = ["h", "r", "t"] + (["proj"] if "proj" in x else [])

    def jf(*args):
        kw = dict(zip(names, args))
        s = JS.positive_score(model, kw["h"], kw["r"], kw["t"], 12.0, jctx,
                              r_proj=kw.get("proj"), rel_dim=rd, emb_scale=0.3)
        return jnp.sum(s * x["w_pos"]), s

    jargs = [jnp.asarray(x[n]) for n in names]
    (_, js), jg = jax.value_and_grad(jf, argnums=tuple(range(len(names))),
                                     has_aux=True)(*jargs)
    targs = [_t(x[n]) for n in names]
    kw = dict(zip(names, targs))
    ts = TS.positive_score(model, kw["h"], kw["r"], kw["t"], 12.0, TS.ShardCtx(),
                           r_proj=kw.get("proj"), rel_dim=rd, emb_scale=0.3)
    (ts * torch.tensor(x["w_pos"])).sum().backward()
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **FWD)
    for n, a, g in zip(names, targs, jg):
        np.testing.assert_allclose(_grad(a), np.asarray(g), **GRAD, err_msg=n)


@pytest.mark.parametrize("corrupt", ["tail", "head"])
@pytest.mark.parametrize("model", JS.MODELS)
def test_negative_score_grouped_and_grads(model, corrupt):
    """The port scores all negative groups in one call with a leading group
    dimension; the reference vmaps one call per group."""
    x, rd = _inputs(model, 1, lead=(NG,))
    jctx = JS.ShardCtx(None)
    names = ["e", "r", "negs"] + (["proj"] if "proj" in x else [])
    x["e"] = x["h"]

    def one(e, r, negs, proj=None):
        return JS.negative_score(model, e, r, negs, corrupt, 12.0, jctx,
                                 r_proj=proj, rel_dim=rd, emb_scale=0.3)

    def jf(*args):
        s = jax.vmap(one)(*args)
        return jnp.sum(s * x["w_neg"]), s

    jargs = [jnp.asarray(x[n]) for n in names]
    (_, js), jg = jax.value_and_grad(jf, argnums=tuple(range(len(names))),
                                     has_aux=True)(*jargs)
    targs = [_t(x[n]) for n in names]
    kw = dict(zip(names, targs))
    ts = TS.negative_score(model, kw["e"], kw["r"], kw["negs"], corrupt, 12.0,
                           TS.ShardCtx(), r_proj=kw.get("proj"), rel_dim=rd,
                           emb_scale=0.3)
    assert ts.shape == (NG, B, K)
    (ts * torch.tensor(x["w_neg"])).sum().backward()
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **FWD)
    for n, a, g in zip(names, targs, jg):
        np.testing.assert_allclose(_grad(a), np.asarray(g), **GRAD, err_msg=n)


@pytest.mark.parametrize("mode", ["dot", "l2sq", "l1"])
def test_plain_pairwise_scores(mode):
    rng = np.random.default_rng(2)
    o = rng.standard_normal((B, D)).astype(np.float32)
    n = rng.standard_normal((K, D)).astype(np.float32)
    np.testing.assert_allclose(
        TS.pairwise_scores(mode, torch.tensor(o), torch.tensor(n)).numpy(),
        np.asarray(JS.pairwise_scores(mode, jnp.asarray(o), jnp.asarray(n))), **FWD)


def test_shard_ctx_is_single_device_only():
    assert TS.ShardCtx().psum(3.0) == 3.0
    with pytest.raises(NotImplementedError):
        TS.ShardCtx(axis="model")


@pytest.mark.parametrize("kind", ["logistic", "ranking", "self_adv"])
def test_losses_and_grads(kind):
    rng = np.random.default_rng(3)
    pos = (3 * rng.standard_normal(B)).astype(np.float32)
    neg = (3 * rng.standard_normal((B, K))).astype(np.float32)
    jl, (jgp, jgn) = jax.value_and_grad(
        lambda p, n: JL.kge_loss(kind, p, n, margin=2.0), argnums=(0, 1))(
            jnp.asarray(pos), jnp.asarray(neg))
    tp, tn = _t(pos), _t(neg)
    tl = TL.kge_loss(kind, tp, tn, margin=2.0)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **FWD)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), **GRAD)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jgn), **GRAD)
