"""The port's dense optimizers (optim/dense.py, optim/api.py) against the
JAX package's: SGD with and without momentum, AdamW with and without
weight decay, Adafactor on 1-D, 2-D and stacked 3-D leaves, three steps
from the same parameters and gradients (numpy seeds), within 1e-6
relative; the factory; JAX's state carried across; and Adafactor's
reductions on a leaf split over ranks against the whole leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.api import make_optimizer as jax_make
from repro_torch.models.layers import ParamDef, tree_map
from repro_torch.optim import dense as D
from repro_torch.optim import make_optimizer

torch.set_num_threads(2)

SHAPES = {"vec": (7,), "mat": (6, 5), "stack": (3, 4, 5)}
STEPS = 3
TOL = 1e-6


def _tree(rng, scale=1.0):
    return {"a": {"vec": rng.standard_normal(SHAPES["vec"]).astype(np.float32) * scale},
            "mat": rng.standard_normal(SHAPES["mat"]).astype(np.float32) * scale,
            "stack": rng.standard_normal(SHAPES["stack"]).astype(np.float32) * scale}


def _torch(tree):
    return tree_map(lambda a: torch.tensor(a), tree)


def _close(got, want):
    """Leaf by leaf, matched by key (JAX orders a dict's keys)."""
    def check(g, w):
        np.testing.assert_allclose(g.detach().cpu().numpy(), np.asarray(w),
                                   rtol=TOL, atol=TOL)

    tree_map(check, got, want)


def _run(name, kw):
    """Three steps of both packages on one parameter tree and one gradient
    tree a step; returns (port params, port state, JAX params, JAX state)."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=10.0 ** -i) for i in range(STEPS)]
    jopt, opt = jax_make(name, 1e-2, **kw), make_optimizer(name, 1e-2, **kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = _torch(p0)
    ts = opt.init(tp)
    for g in grads:
        jp, js = jax.jit(jopt.update)(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = opt.update(tp, _torch(g), ts)
    return tp, ts, jp, js


CASES = {
    "sgd": ("sgd", {}),
    "sgd_momentum": ("sgd", {"momentum": 0.9}),
    "adamw": ("adamw", {}),
    "adamw_decay": ("adamw", {"weight_decay": 0.1}),
    "adafactor": ("adafactor", {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax(case):
    name, kw = CASES[case]
    tp, ts, jp, js = _run(name, kw)
    _close(tp, jp)
    assert set(ts) == set(js) and int(ts["step"]) == int(js["step"]) == STEPS
    assert ts["step"].dtype == torch.int32
    for k in ts:
        if k != "step":
            _close(ts[k], js[k])


def test_adafactor_state_tree_matches_jax():
    """Factored stats of the 2-D and stacked 3-D leaves over their last two
    axes (the stack's vr (3, 4), vc (3, 5): one stat per stored leaf, not
    per layer), a full second moment of the vector."""
    tp, ts, _, js = _run("adafactor", {})
    st, jst = ts["stats"], js["stats"]
    assert set(st["a"]["vec"]) == {"v"} and set(st["mat"]) == {"vr", "vc"}
    for key, want in (("vr", (3, 4)), ("vc", (3, 5))):
        assert tuple(st["stack"][key].shape) == want == jst["stack"][key].shape


def test_make_optimizer_names():
    for name in ("sgd", "adamw", "adafactor"):
        assert isinstance(make_optimizer(name, 1e-3), D.Optimizer)
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        make_optimizer("lion", 1e-3)
    with pytest.raises(ValueError):
        jax_make("lion", 1e-3)


@pytest.mark.parametrize("name,kw", [("adamw", {}), ("adafactor", {}),
                                     ("sgd", {"momentum": 0.9})])
def test_state_from_arrays_carries_jax_state(name, kw):
    """JAX's state after one step, carried across, steps on as JAX's does;
    ``state_to_arrays`` gives JAX's layout back."""
    rng = np.random.default_rng(1)
    p0, g1, g2 = _tree(rng), _tree(rng), _tree(rng)
    jopt, opt = jax_make(name, 1e-2, **kw), make_optimizer(name, 1e-2, **kw)
    jp, js = jopt.update(jax.tree.map(jnp.asarray, p0), jax.tree.map(jnp.asarray, g1),
                         jopt.init(jax.tree.map(jnp.asarray, p0)))
    ts = D.state_from_arrays(jax.tree.map(np.asarray, js))
    back = D.state_to_arrays(ts)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, js))
    tp = _torch(jax.tree.map(np.asarray, jp))
    jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g2), js)
    tp, ts = opt.update(tp, _torch(g2), ts)
    _close(tp, jp)
    assert int(ts["step"]) == 2


def test_state_from_arrays_keeps_a_rank_slice():
    """With the model's defs, a sliced leaf's state keeps the rank's slice:
    AdamW's m like the parameter; Adafactor's vc along the sliced last
    axis, vr whole (a mean over that axis)."""
    d = ParamDef((4, 3), parts=2, part=1, axis=-1)
    m = np.arange(24, dtype=np.float32).reshape(4, 6)
    st = D.state_from_arrays({"step": np.int32(1), "m": {"w": m}, "v": {"w": m}},
                             defs={"w": d})
    assert torch.equal(st["m"]["w"], torch.tensor(m[:, 3:]))
    st = D.state_from_arrays({"step": np.int32(1), "stats": {"w": {
        "vr": m[:, 0], "vc": m[0]}}}, defs={"w": d})
    assert torch.equal(st["stats"]["w"]["vr"], torch.tensor(m[:, 0]))
    assert torch.equal(st["stats"]["w"]["vc"], torch.tensor(m[0, 3:]))


@pytest.mark.parametrize("axis", [-1, -2, -3])
def test_adafactor_reduces_a_split_leaf_over_its_group(axis, monkeypatch):
    """A stacked expert-like leaf (2, 4, 6, 8) cut into two slices along
    ``axis``, each stepped with ``sliced=(axis, 2)``, gives the slices of
    the whole leaf's step: every mean that crosses the cut (vr or vc, the
    row factor's mean, the RMS clip) is taken over both slices. Two
    threads stand for the two ranks; the group's sum is a barrier exchange
    of their partial sums."""
    import threading

    rng = np.random.default_rng(2)
    shape = (2, 4, 6, 8)
    p = rng.standard_normal(shape).astype(np.float32)
    gs = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    whole = make_optimizer("adafactor", 1e-2)
    wp = {"w": torch.tensor(p)}
    ws = whole.init(wp)
    for g in gs:
        whole.update(wp, {"w": torch.tensor(g)}, ws)

    me, slots, barrier = threading.local(), [None, None], threading.Barrier(2, timeout=30)

    def group_sum(x, group):
        slots[me.rank] = x
        barrier.wait()
        out = slots[0] + slots[1]
        barrier.wait()
        return out

    monkeypatch.setattr(D.collectives, "all_reduce_sum", group_sum)
    n = shape[axis] // 2
    out = [None, None]

    def rank(r):
        me.rank = r
        opt = make_optimizer("adafactor", 1e-2, sliced={"w": (axis, 2)}, group=None)
        lp = {"w": torch.tensor(np.take(p, range(r * n, (r + 1) * n), axis=axis))}
        st = opt.init(lp)
        for g in gs:
            opt.update(lp, {"w": torch.tensor(np.take(g, range(r * n, (r + 1) * n),
                                                      axis=axis))}, st)
        out[r] = lp["w"]

    ts = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts) and all(o is not None for o in out)
    got = torch.cat(out, dim=axis)
    np.testing.assert_allclose(got.numpy(), wp["w"].numpy(), rtol=TOL, atol=TOL)
