"""The port's LM-zoo modules (models/*) against the JAX package's, on the
reduced Qwen1.5-0.5B (MHA, QKV bias), H2O-Danube-1.8B (GQA, SWA),
MiniCPM3-4B (MLA), Mamba2-2.7B (SSD mixer, no FFN), Mixtral-8x7B (SWA,
MoE), DBRX (MoE) and Jamba-1.5-Large (a Mamba2 layer with a dense FFN,
then an attention layer with MoE) in f32,
with JAX's weights carried across by ``params_from_arrays``. Inputs from
numpy seeds; 2e-5 for single ops, 2e-3 for attention and whole models (the
bound of tests/test_flash_serving.py and tests/test_models.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models.transformer import build_model as jax_build
from repro_torch.configs import ARCHS
from repro_torch.kernels import build
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.steps import build_prefill_step, build_serve_step
from repro_torch.models.transformer import (
    build_model, params_from_arrays, params_to_arrays,
)

torch.set_num_threads(2)

ARCH = {"qwen": "qwen1.5-0.5b", "danube": "h2o-danube-1.8b", "mamba": "mamba2-2.7b",
        "mixtral": "mixtral-8x7b", "dbrx": "dbrx-132b", "jamba": "jamba-1.5-large-398b",
        "minicpm": "minicpm3-4b"}
MOE = ["mixtral", "dbrx", "jamba"]


def _cfgs(name, **kw):
    """The reduced config in f32, in both packages."""
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(JAX_ARCHS[ARCH[name]].reduced(), **kw),
            dataclasses.replace(ARCHS[ARCH[name]].reduced(), **kw))


def _carried(jcfg, cfg, seed=0):
    """Both models, with JAX's weights in the port."""
    jm, m = jax_build(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(seed))
    return jm, jp, m, params_from_arrays(m, jax.tree.map(np.asarray, jp))


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# ------------------------------------------------------------------- layers
def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    _close(L.rmsnorm(torch.tensor(x), torch.tensor(w), 1e-5),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5), 2e-5)


@pytest.mark.parametrize("theta,offset", [(1e4, 0), (1e6, 0), (1e6, 37)])
def test_rope_matches_jax(theta, offset):
    x = np.random.default_rng(1).standard_normal((2, 16, 4, 64)).astype(np.float32)
    pos = np.arange(16) + offset
    _close(L.rope(torch.tensor(x), torch.tensor(pos), theta),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), theta), 2e-5)


@pytest.mark.parametrize("name", ["qwen", "danube"])
def test_ffn_apply_matches_jax(name):
    jcfg, cfg = _cfgs(name)
    jp = JL.materialize(JM.ffn_defs(jcfg), jax.random.key(2))
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    assert set(p) == set(M.ffn_defs(cfg))
    x = np.random.default_rng(2).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    _close(M.ffn_apply(p, torch.tensor(x), cfg),
           JM.ffn_apply(jp, jnp.asarray(x), jcfg), 2e-5)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("name", ["qwen", "danube"])
def test_attention_train_matches_jax_chunked(name, use_flash):
    """Both of the port's routes against JAX's chunked route (its default
    without a mesh). Danube's window is cut to 24 so that it masks at T 64."""
    jcfg, cfg = _cfgs(name, window=24)
    jp = JL.materialize(JA.attn_defs(jcfg), jax.random.key(3))
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    assert set(p) == set(A.attn_defs(cfg))
    x = np.random.default_rng(3).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    want = JA.attention_train(jp, jnp.asarray(x) * 0.3, jcfg, causal=True)
    got = A.attention_train(p, torch.tensor(x) * 0.3, cfg, causal=True,
                            use_flash=use_flash)
    _close(got, want, 2e-3)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("name", ["qwen", "danube", "mamba", *MOE, "minicpm"])
def test_forward_matches_jax(name, use_flash):
    jm, jp, m, p = _carried(*_cfgs(name, window=24))
    tok = _tokens(m.cfg, 2, 48)
    want = jm.forward(jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    got = build_prefill_step(m, use_flash=use_flash)(p, {"tokens": torch.tensor(tok)})
    assert got.shape == (2, 48, m.padded_vocab) == want.shape
    _close(got, want, 2e-3)


def test_flash_forward_matches_jax_flash_on_mesh(mesh8):
    """The port's flash route against JAX's, which runs the Pallas kernel
    (interpret mode) under shard_map on the 8-device mesh, as
    tests/test_flash_serving.py runs it."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.common.compat import set_mesh

    jcfg, cfg = _cfgs("danube", window=32)
    jm = jax_build(jcfg, mesh=mesh8)
    m = build_model(cfg)
    tok = _tokens(cfg, 4, 64, seed=4)
    with set_mesh(mesh8):
        jp = jm.init(jax.random.key(0))
        p = params_from_arrays(m, jax.tree.map(np.asarray, jp))
        jp = jax.device_put(jp, jax.tree.map(
            lambda s: NamedSharding(mesh8, s), jm.param_specs(),
            is_leaf=lambda x: isinstance(x, P)))
        want = jax.jit(lambda q, t: jm.forward(q, {"tokens": t}, use_flash=True))(
            jp, jnp.asarray(tok, jnp.int32))
    got = m.forward(p, {"tokens": torch.tensor(tok)}, use_flash=True)
    _close(got, want, 2e-3)


def _routed_forward(grid, cfg, p, tok):
    from repro_torch.models.transformer import forward_routes

    return forward_routes(build_model(cfg, grid=grid), p, {"tokens": torch.tensor(tok)})


@pytest.mark.parametrize("name,cf", [("mixtral", 1.25), ("dbrx", 1.25), ("jamba", 0.5)])
def test_routed_forward_matches_jax_on_one_device_mesh(name, cf):
    """With a grid (a 1x1 gloo world), every MoE layer takes the
    capacity-bounded route, as JAX's takes ``_moe_local`` under a mesh; at
    factor ``cf`` token-choices drop (Jamba's one MoE layer routes evenly
    enough to keep them all at 1.25). Against JAX's forward under a
    one-device mesh (the chunked attention route), within 2e-3; the dense
    route, from the same weights, lies farther off."""
    from jax.sharding import Mesh

    from repro.common.compat import set_mesh
    from repro_torch.launch.mesh import run_world

    jcfg, cfg = _cfgs(name, window=24, capacity_factor=cf)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jm = jax_build(jcfg, mesh=mesh)
    m = build_model(cfg)
    jp = jm.init(jax.random.key(0))
    p = params_from_arrays(m, jax.tree.map(np.asarray, jp))
    tok = _tokens(cfg, 2, 48, seed=8)
    with set_mesh(mesh):
        want = jax.jit(lambda q, t: jm.forward(q, {"tokens": t}))(
            jp, jnp.asarray(tok, jnp.int32))
    got, sets = run_world(1, 1, _routed_forward, (cfg, p, tok), timeout_s=120)
    assert max(M.dropped_share(s, cfg) for s in sets) > 0
    _close(got, want, 2e-3)
    dense = m.forward(p, {"tokens": torch.tensor(tok)})
    assert float((dense - torch.tensor(np.asarray(want))).abs().max()) > 2e-3


def _decode(m, p, tok, steps):
    caches = m.init_caches(tok.shape[0], steps)
    serve = build_serve_step(m)
    out = []
    for i in range(steps):
        lg, caches = serve(p, caches, torch.tensor(tok[:, i:i + 1]), i)
        out.append(lg[:, 0])
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("name,window,steps", [("qwen", 64, 12), ("danube", 6, 16),
                                               ("mamba", 0, 12), ("mixtral", 6, 16),
                                               ("dbrx", 0, 12), ("jamba", 0, 12),
                                               ("minicpm", 0, 12)])
def test_decode_matches_jax(name, window, steps):
    """Teacher-forced decode against JAX's decode_step; Danube with window 6
    over 16 steps, so that its ring cache wraps (tests/test_models.py);
    Mamba2 through the conv windows and the SSM state."""
    jm, jp, m, p = _carried(*_cfgs(name, window=window))
    tok = _tokens(m.cfg, 2, steps, seed=5)
    caches = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype),
                          jm.cache_defs(2, steps),
                          is_leaf=lambda x: hasattr(x, "materialize"))
    want = []
    for i in range(steps):
        lg, caches = jm.decode_step(jp, caches, jnp.asarray(tok[:, i:i + 1], jnp.int32),
                                    jnp.asarray(i, jnp.int32))
        want.append(np.asarray(lg[:, 0], np.float32))
    if name in ("danube", "mixtral"):
        assert m.init_caches(2, steps)["l0"]["k"].shape[1] == 6  # a ring of 6
    _close(_decode(m, p, tok, steps), np.stack(want, axis=1), 2e-3)


@pytest.mark.parametrize("name,window,steps", [("qwen", 64, 12), ("danube", 6, 16),
                                               ("mamba", 0, 12), ("mixtral", 6, 16),
                                               ("jamba", 0, 12), ("minicpm", 0, 12)])
def test_decode_matches_forward(name, window, steps):
    """The port's own teacher-forced decode equals its flash prefill (for
    Mamba2: the recurrence equals the chunked scan; for MiniCPM3 the
    absorbed MLA decode equals the chunked prefill, as JAX's
    test_decode_matches_forward_mla; JAX's bound, 2e-3). The MoE configs at
    capacity factor 8, as JAX's test_decode_matches_forward_hybrid_moe."""
    _, cfg = _cfgs(name, window=window, capacity_factor=8.0)
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    tok = _tokens(cfg, 2, steps, seed=6)
    full = m.forward(p, {"tokens": torch.tensor(tok)}, use_flash=True)
    _close(_decode(m, p, tok, steps), full, 2e-3)


# ---------------------------------------------------- weights and dtypes
def _round_trip(name, scan_layers, leaf, width, n_layers=3):
    """JAX's tree -> port -> numpy gives it back, for the stacked layout
    (a full config's defs, here at reduced width with ``n_layers`` layers)
    and the per-layer one (a reduced config). ``width(cfg)`` is the shape
    of one layer's ``leaf`` (layer, module, key)."""
    jcfg, cfg = _cfgs(name, scan_layers=scan_layers, n_layers=n_layers)
    jm, jp, m, p = _carried(jcfg, cfg, seed=7)
    stacked = len(p["layers"]) < n_layers
    assert stacked == scan_layers and m.n_groups == jm.n_groups
    if stacked:
        layer, mixer, key = leaf
        assert p["layers"][layer][mixer][key].shape == (m.n_groups, *width(cfg))
    back = params_to_arrays(p)
    flat = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, want in flat:
        got = back
        for key in path:
            got = got[key.key]
        assert got.dtype == np.float32 and np.array_equal(got, want)
    bad = jax.tree.map(np.asarray, jp)
    bad["final_ln"] = bad["final_ln"][:-1]
    with pytest.raises(ValueError, match="final_ln"):
        params_from_arrays(m, bad)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_params_round_trip(scan_layers):
    _round_trip("qwen", scan_layers, ("l0", "attn", "bq"), lambda c: (c.n_heads * c.head_dim,))


@pytest.mark.parametrize("scan_layers", [True, False])
def test_params_round_trip_mamba(scan_layers):
    """Mamba2's ``layers/l0/mamba/*`` stacked, and its per-layer tree."""
    _round_trip("mamba", scan_layers, ("l0", "mamba", "A_log"), lambda c: (c.n_mamba_heads,))


@pytest.mark.parametrize("scan_layers", [True, False])
def test_params_round_trip_moe(scan_layers):
    """Mixtral's ``layers/l0/moe/w_up`` stacked to (L, E, d, ff), and its
    per-layer tree."""
    _round_trip("mixtral", scan_layers, ("l0", "moe", "w_up"),
                lambda c: (c.n_experts, c.d_model, c.d_ff))


@pytest.mark.parametrize("scan_layers", [True, False])
def test_params_round_trip_mla(scan_layers):
    """MiniCPM3's ``layers/l0/attn/{wq_a, q_norm, ...}`` stacked, and its
    per-layer tree."""
    _round_trip("minicpm", scan_layers, ("l0", "attn", "q_norm"),
                lambda c: (c.q_lora_rank,))


@pytest.mark.parametrize("scan_layers", [True, False])
def test_params_round_trip_jamba(scan_layers):
    """Jamba's four layers: stacked, a period of two ((Mamba2, dense),
    (attention, MoE)) in two groups, ``l1/moe/w_down`` (2, E, ff, d)."""
    _round_trip("jamba", scan_layers, ("l1", "moe", "w_down"),
                lambda c: (c.n_experts, c.d_ff, c.d_model), n_layers=4)


@pytest.mark.parametrize("name,scan_layers", [("qwen", False), ("danube", False),
                                              ("qwen", True), ("mamba", False),
                                              ("mamba", True), ("mixtral", False),
                                              ("mixtral", True), ("dbrx", True),
                                              ("jamba", False), ("minicpm", False),
                                              ("minicpm", True)])
def test_bf16_logit_dtype_matches_jax(name, scan_layers):
    """JAX's promotion decides the types: the reduced Qwen's 1-D f32 biases
    promote its activations to f32 (f32 logits); Danube has none (bf16);
    with stacked layers Qwen's biases are 2-D, cast to bf16 (bf16). Mamba2's
    1-D A_log, dt_bias, D_skip and norm_z do the same."""
    jcfg = dataclasses.replace(JAX_ARCHS[ARCH[name]].reduced(), scan_layers=scan_layers)
    cfg = dataclasses.replace(ARCHS[ARCH[name]].reduced(), scan_layers=scan_layers)
    jm, jp, m, p = _carried(jcfg, cfg)
    tok = _tokens(cfg, 1, 8)
    want = jm.forward(jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    got = m.forward(m.cast(p), {"tokens": torch.tensor(tok)}, use_flash=True)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert bool(torch.isfinite(got.float()).all())


def test_full_mamba_logit_dtype_matches_jax_eval_shape():
    """The full Mamba2-2.7B (64 stacked layers, d 2560, bf16): jax.eval_shape
    of its forward against the port's forward on the meta device (no
    memory); both give bf16 logits of the padded vocab. The stacked 2-D
    A_log, dt_bias, D_skip, norm_z and ln1 are cast to bf16 with the
    matrices. T 256 keeps the meta run short."""
    from repro_torch.models.layers import tree_map

    shape = (4, 256)
    jm = jax_build(JAX_ARCHS[ARCH["mamba"]])
    want = jax.eval_shape(lambda q, t: jm.forward(q, {"tokens": t}),
                          jm.abstract_params(), jax.ShapeDtypeStruct(shape, jnp.int32))
    m = build_model(ARCHS[ARCH["mamba"]])
    assert (m.period, m.n_groups) == (jm.period, jm.n_groups) == (1, 64)
    p = tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), m.defs)
    got = build_prefill_step(m)(p, {"tokens": torch.zeros(shape, dtype=torch.long,
                                                           device="meta")})
    assert tuple(got.shape) == want.shape == (*shape, 50280)
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == "bfloat16"


def test_full_minicpm_logit_dtype_matches_jax_eval_shape():
    """The full MiniCPM3-4B (62 stacked layers, d 2560, 40 heads, bf16):
    jax.eval_shape of its forward against the port's forward on the meta
    device; both give bf16 logits of the padded vocab (the stacked 2-D
    q_norm and kv_norm cast with the matrices)."""
    from repro_torch.models.layers import tree_map

    shape = (2, 64)
    jm = jax_build(JAX_ARCHS[ARCH["minicpm"]])
    want = jax.eval_shape(lambda q, t: jm.forward(q, {"tokens": t}),
                          jm.abstract_params(), jax.ShapeDtypeStruct(shape, jnp.int32))
    m = build_model(ARCHS[ARCH["minicpm"]])
    assert (m.period, m.n_groups) == (jm.period, jm.n_groups) == (1, 62)
    assert m.defs["layers"]["l0"]["attn"]["q_norm"].shape == (62, 768)
    p = tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), m.defs)
    got = build_prefill_step(m, use_flash=True)(
        p, {"tokens": torch.zeros(shape, dtype=torch.long, device="meta")})
    assert tuple(got.shape) == want.shape == (*shape, 73448)
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == "bfloat16"


def test_cast_once_keeps_forward():
    _, cfg = _cfgs("qwen", dtype="bfloat16", scan_layers=True)
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(1))
    cast = m.cast(p)
    assert cast["layers"]["l0"]["attn"]["wq"].dtype == torch.bfloat16
    assert cast["final_ln"].dtype == torch.float32
    assert m.cast(cast)["tok_emb"] is cast["tok_emb"]  # nothing left to cast
    tok = torch.tensor(_tokens(cfg, 1, 8))
    assert torch.equal(m.forward(p, {"tokens": tok}), m.forward(cast, {"tokens": tok}))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "whisper-large-v3",
                                  "llava-next-mistral-7b"],
                         ids=["minicpm3-4b", "whisper-large-v3", "llava-next-mistral-7b"])
def test_build_model_refuses_unported(arch):
    """The models once refused now build, with JAX's parameter tree:
    MiniCPM3 (MLA, A10.2), Whisper (the encoder-decoder, A10.3) and LLaVA
    (the vision frontend, A10.4). Only an unknown layer pattern is still
    refused."""
    jm, m = jax_build(JAX_ARCHS[arch].reduced()), build_model(ARCHS[arch].reduced())
    flat = jax.tree_util.tree_leaves_with_path(jm.defs, is_leaf=lambda x: hasattr(
        x, "materialize"))
    for path, want in flat:
        node = m.defs
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(want.shape)
    assert len(flat) == _leaf_count(m.defs)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A10"):
        build_model(dataclasses.replace(ARCHS[arch].reduced(), mixer_pattern="rwkv"))


def _leaf_count(tree):
    return sum(_leaf_count(v) for v in tree.values()) if isinstance(tree, dict) else 1


def test_cpu_path_launches_no_kernel():
    _, cfg = _cfgs("qwen")
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    before = dict(build.LAUNCHES)
    m.forward(p, {"tokens": torch.tensor(_tokens(cfg, 1, 8))}, use_flash=True)
    assert build.LAUNCHES == before
