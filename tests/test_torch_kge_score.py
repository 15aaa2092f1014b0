"""The port's pairwise kge_score path against the JAX package.

On the CPU the port's wrapper runs the plain versions (kernels/kge_score/
ref.py) inside the autograd.Function whose backward the card also uses.
Both are held to JAX's ``pairwise_scores_kernel`` (the Pallas kernels,
l1_bwd_pallas included, in interpret mode, as tests/test_kernels.py runs
them) and to the JAX oracle. Tolerances: 2e-5 forward, 2e-4 grads. The CUDA
kernels are held to the plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kge_score.ops import pairwise_scores_kernel
from repro.kernels.kge_score.ref import l1_grads_ref as jax_l1_grads
from repro.kernels.kge_score.ref import pairwise_ref as jax_pairwise_ref
from repro_torch.kernels.kge_score import ops
from repro_torch.kernels.kge_score.ref import l1_grads_ref

torch.set_num_threads(2)

FWD = dict(rtol=2e-5, atol=2e-4)  # atol: |values| reach ~100 at D=48
GRAD = dict(rtol=2e-4, atol=2e-4)
MODES = ["dot", "l2sq", "l1"]


def _data(B, K, D, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(lead + (B, D)).astype(np.float32),
            rng.standard_normal(lead + (K, D)).astype(np.float32),
            rng.standard_normal(lead + (B, K)).astype(np.float32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(64, 32, 48), (100, 130, 33), (1, 1, 1)])
def test_plain_pairwise_matches_pallas_interpret(mode, shape):
    o, n, _ = _data(*shape)
    out = ops.pairwise_scores(mode, torch.tensor(o), torch.tensor(n))
    jk = pairwise_scores_kernel(mode, jnp.asarray(o), jnp.asarray(n))
    jr = jax_pairwise_ref(mode, jnp.asarray(o), jnp.asarray(n))
    np.testing.assert_allclose(out.numpy(), np.asarray(jk), **FWD)
    np.testing.assert_allclose(out.numpy(), np.asarray(jr), **FWD)


@pytest.mark.parametrize("mode", MODES)
def test_pairwise_grads_match_jax(mode):
    o, n, g = _data(48, 72, 56, seed=1)
    to, tn = torch.tensor(o, requires_grad=True), torch.tensor(n, requires_grad=True)
    (ops.pairwise_scores(mode, to, tn) * torch.tensor(g)).sum().backward()
    f = lambda o_, n_: jnp.sum(pairwise_scores_kernel(mode, o_, n_) * g)
    do, dn = jax.grad(f, argnums=(0, 1))(jnp.asarray(o), jnp.asarray(n))
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(do), **GRAD)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(dn), **GRAD)
    if mode == "l1":
        rdo, rdn = l1_grads_ref(torch.tensor(o), torch.tensor(n), torch.tensor(g))
        jdo, jdn = jax_l1_grads(jnp.asarray(o), jnp.asarray(n), jnp.asarray(g))
        np.testing.assert_allclose(rdo.numpy(), np.asarray(jdo), **GRAD)
        np.testing.assert_allclose(rdn.numpy(), np.asarray(jdn), **GRAD)


@pytest.mark.parametrize("mode", MODES)
def test_grouped_pairwise_equals_per_group(mode):
    """One call with a leading group dimension == one call per group (the
    reference's vmap), values and grads."""
    o, n, g = _data(20, 12, 16, seed=2, lead=(3,))
    to, tn = torch.tensor(o, requires_grad=True), torch.tensor(n, requires_grad=True)
    out = ops.pairwise_scores(mode, to, tn)
    (out * torch.tensor(g)).sum().backward()
    f = lambda o_, n_: jnp.sum(jax.vmap(
        lambda a, b: pairwise_scores_kernel(mode, a, b))(o_, n_) * g)
    do, dn = jax.grad(f, argnums=(0, 1))(jnp.asarray(o), jnp.asarray(n))
    for gi in range(3):
        np.testing.assert_allclose(
            out[gi].detach().numpy(),
            np.asarray(jax_pairwise_ref(mode, jnp.asarray(o[gi]), jnp.asarray(n[gi]))),
            **FWD)
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(do), **GRAD)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(dn), **GRAD)


def test_kernel_wrapper_refuses_cpu_tensors():
    o, n, _ = _data(4, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.pairwise_kernel("l2sq", torch.tensor(o), torch.tensor(n))


def _l1_case(case):
    """(o, n, g, lead) for the l1 backward cases; "ties" has small-integer
    entries and negatives that copy rows of o, so many o - n are exactly 0
    (sign 0, as jnp.sign gives)."""
    if case == "2d":
        return _data(48, 72, 56, seed=3)
    if case == "grouped":
        return _data(20, 12, 16, seed=4, lead=(3,))
    rng = np.random.default_rng(5)
    o = rng.integers(-2, 3, (2, 24, 40)).astype(np.float32)
    n = rng.integers(-2, 3, (2, 18, 40)).astype(np.float32)
    n[:, :6] = o[:, :6]
    g = rng.standard_normal((2, 24, 18)).astype(np.float32)
    return o, n, g


@pytest.mark.parametrize("case", ["2d", "grouped", "ties"])
def test_l1_function_grads_match_pallas_interpret(case):
    """The l1 backward of the autograd.Function the card also runs (on the
    CPU through l1_grads_ref) against JAX's custom VJP, whose l1 backward is
    l1_bwd_pallas in interpret mode."""
    o, n, g = _l1_case(case)
    to, tn = torch.tensor(o, requires_grad=True), torch.tensor(n, requires_grad=True)
    (ops._Pairwise.apply("l1", to, tn) * torch.tensor(g)).sum().backward()
    one = lambda a, b: pairwise_scores_kernel("l1", a, b)
    kern = one if o.ndim == 2 else jax.vmap(one)
    f = lambda o_, n_: jnp.sum(kern(o_, n_) * g)
    do, dn = jax.grad(f, argnums=(0, 1))(jnp.asarray(o), jnp.asarray(n))
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(do), **GRAD)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(dn), **GRAD)


def test_l1_backward_computes_what_autograd_asks_for():
    o, n, g = _data(6, 5, 4, seed=6)
    to = torch.tensor(o, requires_grad=True)
    tn = torch.tensor(n)  # no grad wanted
    (ops.pairwise_scores("l1", to, tn) * torch.tensor(g)).sum().backward()
    want, _ = l1_grads_ref(torch.tensor(o), tn, torch.tensor(g))
    torch.testing.assert_close(to.grad, want)
    assert tn.grad is None


@pytest.mark.parametrize("need_do", [True, False], ids=["d_o", "d_n"])
def test_l1_grads_ref_computes_one_product(need_do):
    """The plain version, like the kernel, returns only the product asked
    for, equal bit for bit to that product of the call that computes both."""
    o, n, g = (torch.tensor(a) for a in _data(9, 7, 5, seed=7, lead=(2,)))
    both = l1_grads_ref(o, n, g)
    one = l1_grads_ref(o, n, g, need_do=need_do, need_dn=not need_do)
    keep = 0 if need_do else 1
    assert one[1 - keep] is None
    assert torch.equal(one[keep], both[keep])


def test_l1_bwd_wrapper_refuses_cpu_tensors():
    o, n, g = _data(4, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.l1_bwd_kernel(torch.tensor(o), torch.tensor(n), torch.tensor(g))
