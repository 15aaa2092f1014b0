"""The port's Mixture-of-Experts layer (models/moe.py) against the JAX
package's: the dense route (``_moe_dense_ref``, JAX's route with no mesh)
and the capacity-bounded one (``_moe_local``, JAX's route under a mesh),
with JAX's weights and numpy inputs. f32 within 2e-5; bf16 under the
routing rule (tokens whose top-k expert set differs between the two runs
are counted and left out) within 5e-2, the bf16 bound of
tests/test_torch_flash_attention.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.common import compat
from repro.common.compat import set_mesh
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.common.config import FFNKind
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import ProcessGrid, run_world
from repro_torch.models import moe as M
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)

EK = [(4, 2), (2, 1), (8, 2), (16, 4)]


def _cfgs(E, k, cf=8.0, arch="mixtral-8x7b"):
    """JAX's tests/test_models.py MoE config in both packages."""
    kw = dict(n_experts=E, moe_top_k=k, d_model=64, d_ff=128, capacity_factor=cf)
    return (dataclasses.replace(JAX_ARCHS[arch].reduced(), **kw),
            dataclasses.replace(ARCHS[arch].reduced(), **kw))


def _weights(jcfg, seed=0, dtype=None):
    jp = JL.materialize(JM.moe_defs(jcfg, model_par=1), jax.random.key(seed))
    if dtype is not None:
        jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    p = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in jp.items()}
    return jp, p if dtype is None else {k: v.to(dtype) for k, v in p.items()}


def _x(shape, seed=1):
    """Tokens around a common direction, as hidden states share one: the
    router then favours some experts, and at factor 1.25 they overflow."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + rng.standard_normal(shape[-1])).astype(np.float32)


def _jax_topi(jp, x, jcfg):
    """JAX's expert choices, as ``_moe_local`` and ``_moe_dense_ref`` make
    them."""
    xf = x.reshape(-1, x.shape[-1])
    gates = jax.nn.softmax((xf @ jp["router"]).astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(gates, jcfg.moe_top_k)[1])


def _dropped(topi, E, cap):
    """(T, k): True for a token-choice past its expert's capacity."""
    out = np.zeros(topi.shape, bool)
    for e in range(E):
        hit = topi == e
        pos = np.cumsum(hit.any(-1)) - 1
        out |= hit & (pos >= cap)[:, None]
    return out


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _jax_local(jp, x, jcfg, mesh):
    """JAX's ``_moe_local`` under ``moe_apply``'s shard_map on ``mesh``:
    (out, aux)."""
    ep = jcfg.n_experts % mesh.shape["model"] == 0
    espec = P("model", None, None) if ep else P(None, None, "model")
    dspec = P("model", None, None) if ep else P(None, "model", None)
    specs = {"router": P(None, None), "w_up": espec, "w_down": dspec, "w_gate": espec}
    body = functools.partial(JM._moe_local, cfg=jcfg, model_par=mesh.shape["model"],
                             expert_par=ep)
    fm = compat.shard_map(lambda p, xx: body(p, xx), mesh=mesh,
                          in_specs=(specs, P(("data",), None, None)),
                          out_specs=(P(("data",), None, None), P()), check_vma=False)
    with set_mesh(mesh):
        out, aux = jax.jit(fm)(jp, jnp.asarray(x))
        applied = jax.jit(lambda p, xx: JM.moe_apply(p, xx, jcfg, mesh, ("data",)))(
            jp, jnp.asarray(x))
    return np.asarray(out), float(aux), np.asarray(applied)


# ---------------------------------------------------------------------- defs
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("reduced", [True, False])
def test_moe_defs_match_jax(arch, reduced):
    jcfg, cfg = JAX_ARCHS[arch], ARCHS[arch]
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = JM.moe_defs(jcfg, model_par=1)
    got = M.moe_defs(cfg)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape) and got[k].init == want[k].init


# ---------------------------------------------------------------- the routes
@pytest.mark.parametrize("E,k", EK)
def test_moe_dense_ref_matches_jax(E, k):
    jcfg, cfg = _cfgs(E, k)
    jp, p = _weights(jcfg)
    x = _x((4, 8, 64))
    want, _ = JM._moe_dense_ref(jp, jnp.asarray(x), jcfg)
    got, aux = M.moe_dense_ref(p, torch.tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert float(aux) == 0.0


@pytest.mark.parametrize("E,k", EK)
def test_moe_dense_ref_bf16_matches_jax(E, k):
    """In bf16, the router product rounds to bf16 as in JAX, where equal
    logits are common; a token whose expert set differs is left out (the
    routing rule), and at most 2% of them may."""
    jcfg, cfg = _cfgs(E, k)
    jp, p = _weights(jcfg, dtype=torch.bfloat16)
    x = _x((4, 8, 64))
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    want, _ = JM._moe_dense_ref(jp, xj, jcfg)
    got, _ = M.moe_dense_ref(p, xt, cfg)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    jtopi = _jax_topi(jp, xj, jcfg)
    topi = M.route(p, xt.reshape(-1, 64), cfg)[2]
    off = M.flipped([torch.tensor(jtopi)], [topi], (4, 8)).numpy().reshape(-1)
    assert off.mean() <= 0.02
    g = got.float().numpy().reshape(32, 64)[~off]
    w = np.asarray(want, np.float32).reshape(32, 64)[~off]
    np.testing.assert_allclose(g, w, rtol=5e-2, atol=5e-2 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.1])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 2)])
def test_moe_local_matches_jax_one_device_mesh(E, k, cf):
    """The capacity-bounded route against JAX's ``moe_apply`` under a
    one-device mesh: the same expert choices, the same token-choices
    dropped (at 0.1 and 1.25 some are), outputs within 2e-5, and ``aux``
    equal to JAX's ``_moe_local``'s under the same shard_map."""
    jcfg, cfg = _cfgs(E, k, cf)
    jp, p = _weights(jcfg)
    x = _x((4, 16, 64))
    want, want_aux, applied = _jax_local(jp, x, jcfg, _mesh1())
    got, aux = M.moe_local(p, torch.tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), applied, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux), want_aux, rtol=2e-6)
    jtopi = _jax_topi(jp, x, jcfg)
    topi = M.route(p, torch.tensor(x).reshape(-1, 64), cfg)[2]
    assert np.array_equal(topi.numpy(), jtopi)
    cap = M.capacity(cfg, 64)
    assert cap == int(jcfg.capacity_factor * 64 * k / E) + 1
    got_drop = np.zeros(topi.shape, bool)
    for e in range(E):
        sel, slot = M.slots(topi, e, cap)
        got_drop |= (topi == e).numpy() & (sel & (slot == cap)).numpy()[:, None]
    want_drop = _dropped(jtopi, E, cap)
    assert np.array_equal(got_drop, want_drop)
    assert M.dropped_share(topi, cfg) == want_drop.mean()
    assert want_drop.any() == (cf < 8.0)
    if cf == 8.0:  # nothing dropped: the dense route's numbers
        dense, _ = M.moe_dense_ref(p, torch.tensor(x), cfg)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("E,k", EK)
def test_moe_local_matches_jax_expert_parallel(mesh8, E, k):
    """JAX's expert-parallel ``moe_apply`` on ``mesh8`` (4 data shards, 2
    model ranks owning disjoint experts, a psum over them) against the
    port's ``moe_local`` on each data shard with every expert, and against
    the sum of two ``moe_local`` calls over the two halves of the experts
    (``e0``), JAX's split. Capacity is per data shard; only the order of
    the f32 sums differs, so within 2e-5 x max(1, max|out|). At factor
    1.25 tokens drop."""
    jcfg, cfg = _cfgs(E, k, cf=1.25)
    jp, p = _weights(jcfg)
    x = _x((8, 8, 64), seed=2)
    want, _, applied = _jax_local(jp, x, jcfg, mesh8)
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    half = E // 2
    for b in range(4):
        xs = torch.tensor(x[2 * b:2 * b + 2])
        got, _ = M.moe_local(p, xs, cfg)
        parts = [M.moe_local({n: (t if n == "router" else t[s * half:(s + 1) * half])
                              for n, t in p.items()}, xs, cfg, e0=s * half)[0]
                 for s in range(2)]
        for out in (got, parts[0] + parts[1]):
            np.testing.assert_allclose(out.numpy(), want[2 * b:2 * b + 2], rtol=0, atol=tol)
    np.testing.assert_allclose(applied, want, rtol=0, atol=tol)


def _grid_body(grid, p, x, cfg):
    got = M.moe_apply(p, x, cfg, grid)
    want, _ = M.moe_local(p, x, cfg, group=grid.model_group)
    alone, _ = M.moe_local(p, x, cfg)
    return got, want, alone


def test_moe_apply_with_a_grid_is_moe_local():
    """``moe_apply(grid=...)`` in a 1x1 gloo world is ``moe_local`` over the
    grid's model group (a psum over one rank), bit for bit, and equals the
    call with no group."""
    jcfg, cfg = _cfgs(4, 2, cf=1.25)
    _, p = _weights(jcfg)
    x = torch.tensor(_x((2, 16, 64)))
    got, want, alone = run_world(1, 1, _grid_body, (p, x, cfg), timeout_s=120)
    assert torch.equal(got, want) and torch.equal(got, alone)
    assert not torch.equal(got, M.moe_apply(p, x, cfg))  # tokens dropped


def test_grid_of_two_servers_refuses(monkeypatch):
    """A grid of two servers now builds (A10.1b; its numbers are held to
    JAX's mesh program in tests/test_torch_moe_world.py): each rank's defs
    hold its half of the experts. What still refuses is a CUDA world of
    more ranks than cards: NCCL places one rank a card."""
    _, cfg = _cfgs(4, 2)
    for s in range(2):
        grid = ProcessGrid(M=1, S=2, rank=s, machine_group=None, model_group=None,
                           device=torch.device("cpu"))
        m = build_model(cfg, grid=grid)
        assert m.kinds[0][1] == FFNKind.MOE
        assert m.defs["layers"]["l0"]["moe"]["w_up"].shape == (2, 64, 128)
        assert m.defs["layers"]["l0"]["moe"]["router"].shape == (64, 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        run_world(1, 2, _grid_body, (None, None, cfg), device="cuda")


# ---------------------------------------------------------------------- ties
def test_top_k_breaks_ties_as_lax_top_k():
    """Equal gates take the lower expert index first, as ``lax.top_k``."""
    rows = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                     [0.4, 0.1, 0.4, 0.1], [0.2, 0.2, 0.5, 0.1]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(rows), k)
        gv, gi = M.top_k(torch.tensor(rows), k)
        assert np.array_equal(gi.numpy(), np.asarray(wi))
        assert np.array_equal(gv.numpy(), np.asarray(wv))


def test_tied_router_columns_route_as_jax():
    """A router with two equal columns gives every token two equal gates;
    both packages send it to the lower of the two experts."""
    jcfg, cfg = _cfgs(4, 1)
    jp, p = _weights(jcfg)
    router = np.asarray(jp["router"]).copy()
    router[:, 3] = router[:, 1]
    jp = {**jp, "router": jnp.asarray(router)}
    p = {**p, "router": torch.tensor(router)}
    x = _x((2, 16, 64), seed=3)
    jtopi = _jax_topi(jp, x, jcfg)
    topi = M.route(p, torch.tensor(x).reshape(-1, 64), cfg)[2]
    assert np.array_equal(topi.numpy(), jtopi) and 3 not in jtopi
    want, _ = JM._moe_dense_ref(jp, jnp.asarray(x), jcfg)
    got, _ = M.moe_dense_ref(p, torch.tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
