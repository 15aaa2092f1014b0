"""The port's dry run (launch/dryrun.py) against the JAX package's: the LM
steps' matmul FLOPs against JAX's ``dot``/``convolution`` FLOPs of the
compiled programs, the per-rank relation at S > 1, the microbatch
extrapolation against the full count, and the CLI.

The JAX side is compiled as tests/test_hlo_analysis.py compiles
(``jax.jit(...).lower(...).compile()``) on no mesh or on the conftest's
CPU devices, and its dots are counted loop-aware from the HLO text with
the JAX package's own parser. ``repro.launch.dryrun`` is not imported: it
sets ``XLA_FLAGS`` when imported; its flags and its rows' keys are read
from its source.
"""

import ast
import dataclasses
import json
import re
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist

from repro.common import compat as jcompat
from repro.common.config import InputShape as JShape
from repro.configs import ARCHS as JAX_ARCHS
from repro.launch import roofline as jroofline
from repro.launch.hlo_analysis import _SHAPE_RE, _dot_flops, _trip_count, parse_computations
from repro.launch.mesh import make_mesh
from repro.models import steps as JS
from repro.models.transformer import build_model as jax_build
from repro_torch.common.config import InputShape
from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun as D

torch.set_num_threads(2)

JAX_DRYRUN = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" / "dryrun.py"
KINDS = {"train": (16, 4), "prefill": (16, 2), "decode": (16, 2)}  # (T, batch)


def _dot_flops_of(text: str) -> float:
    """JAX's dot and convolution FLOPs of compiled HLO text, each while
    body multiplied by its trip count (``analyze_hlo``'s walk)."""
    comps, entry = parse_computations(text)
    shapes = {}
    for instrs in comps.values():
        for ins in instrs:
            m = _SHAPE_RE.search(ins.shape_tok)
            dims = [int(d) for d in m.group(2).split(",")] if m and m.group(2) else []
            shapes[ins.name] = (ins.out_bytes, ins.out_elems, dims)
    memo = {}

    def walk(comp):
        if comp not in memo:
            total = 0.0
            for ins in comps.get(comp, []):
                if ins.op == "while":
                    m = re.search(r"condition=%?([\w.\-]+), body=%?([\w.\-]+)", ins.attrs)
                    total += _trip_count(ins, comps.get(m.group(1), [])) * walk(m.group(2))
                elif ins.op in ("call", "conditional", "async-start"):
                    for m in re.finditer(r"(?:to_apply|called_computation|branch_computations"
                                         r"=\{|true_computation|false_computation)=?%?"
                                         r"([\w.\-]+)", ins.attrs):
                        total += walk(m.group(1)) if m.group(1) in comps else 0.0
                elif ins.op in ("dot", "convolution"):
                    total += _dot_flops(ins, shapes)
            memo[comp] = total
        return memo[comp]

    return walk(entry)


def _jax_lowered(jcfg, shape, mesh=None):
    model = jax_build(jcfg, mesh=mesh)
    ctx = jcompat.set_mesh(mesh) if mesh is not None else _Null()
    with ctx:
        if shape.kind == "train":
            step, _ = JS.build_train_step(model, shape=shape)
            return jax.jit(step).lower(*JS.train_abstract_args(model, shape))
        if shape.kind == "prefill":
            aps = model.abstract_params()
            if mesh is not None:
                aps = jax.tree.map(
                    lambda a, s: jax.ShapeDtypeStruct(
                        a.shape, a.dtype, sharding=jax.sharding.NamedSharding(mesh, s)),
                    aps, model.param_specs(),
                    is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            batch = JS.abstract_inputs(JS.input_defs(jcfg, shape, model), mesh)
            return jax.jit(JS.build_prefill_step(model)).lower(aps, batch)
        return jax.jit(JS.build_serve_step(model)).lower(*JS.serve_abstract_args(model, shape))


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _jax_flops(name, kind, mesh=None, B=None):
    T, b = KINDS[kind]
    lowered = _jax_lowered(JAX_ARCHS[name].reduced(), JShape("x", T, B or b, kind), mesh)
    return _dot_flops_of(lowered.compile().as_text())


def _port(name, kind, grid=None, B=None, cfg=None):
    T, b = KINDS[kind]
    return D.count_arch(cfg or ARCHS[name].reduced(), InputShape("x", T, B or b, kind), grid)


def _ssd_dots(cfg, rows, T):
    """The dots of JAX's chunked SSD scan in a prefill (one chunk of T <=
    64 rows, from the zero state, whose inter-chunk product XLA folds
    away): C B^T, the intra-chunk product and the state update, a Mamba2
    layer. The port's prefill runs the scan as the ssd_scan kernel (a
    kernel record, no matmul)."""
    H, P, N = cfg.n_mamba_heads, cfg.mamba_headdim, cfg.ssm_state
    return cfg.n_mamba_layers * 2 * rows * (T * T * N + T * T * H * P + T * H * P * N)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", list(ARCHS))
def test_lm_matmul_flops_match_jax(name, kind):
    """At no mesh: the port's matmul FLOPs against JAX's dots within 1%.
    Reckoned by hand: a Mamba2 layer's prefill scan, which the port runs
    as a kernel (``_ssd_dots``). Training takes the plain chunked scan in
    both; there JAX's three-operand einsums contract in another order than
    the port's two-operand ones, within the 1%."""
    got = _port(name, kind)
    want = _jax_flops(name, kind)
    cfg = ARCHS[name].reduced()
    extra = _ssd_dots(cfg, KINDS[kind][1], KINDS[kind][0]) if kind == "prefill" else 0
    if kind == "prefill" and cfg.n_mamba_layers:
        assert got.mode.kernels["ssd_scan"].launches == cfg.n_mamba_layers
    assert abs(got.mode.matmul_flops + extra - want) / want < 0.01


# on the data-only mesh every config once, prefill and decode in turn, and
# one train step (an MoE config: its gradients' sum over the machines)
ON_MESH = [(n, ("prefill", "decode")[i % 2]) for i, n in enumerate(ARCHS)] + [
    ("mixtral-8x7b", "train")]


@pytest.mark.parametrize("name,kind", ON_MESH)
def test_lm_matmul_flops_match_jax_data_mesh(name, kind):
    """At a data-only mesh (2, 1) of the conftest's devices, where both
    packages run one program a device on its machine's rows, batch 4.
    Reckoned by hand: JAX's decode computes every device's logits for the
    whole batch (its partitioner replicates the unembedding's output),
    the port a rank's for its machine's rows: 2 (B - B/M) d V more in
    JAX; and a Mamba2 layer's prefill scan (``_ssd_dots``)."""
    M, B = 2, 4
    mesh = make_mesh((M, 1), ("data", "model"))
    want = _jax_flops(name, kind, mesh, B=B)
    with D.fake_world(M, 1) as grid:
        got = _port(name, kind, grid, B=B)
    assert not dist.is_initialized()
    cfg = ARCHS[name].reduced()
    from repro_torch.models.transformer import Model

    extra = 0
    if kind == "decode":
        extra = 2 * (B - B // M) * cfg.d_model * Model(cfg).padded_vocab
    if kind == "prefill":
        extra = _ssd_dots(cfg, B // M, KINDS[kind][0])
    assert abs(got.mode.matmul_flops + extra - want) / want < 0.01


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_per_rank_relation_at_two_servers(kind):
    """The stated divergence in numbers (module docstring of
    launch/dryrun.py): on a (2, 2) grid a rank of the dense Qwen computes
    every layer whole on its machine's rows, so its matmul FLOPs equal a
    rank's of (2, 1) and twice a device's of JAX's (2, 2) mesh, where
    GSPMD splits the same layers over ``model``."""
    B = 4
    want = _jax_flops("qwen1.5-0.5b", kind, make_mesh((2, 2), ("data", "model")), B=B)
    with D.fake_world(2, 2) as grid:
        got = _port("qwen1.5-0.5b", kind, grid, B=B).mode.matmul_flops
    with D.fake_world(2, 1) as grid:
        data_only = _port("qwen1.5-0.5b", kind, grid, B=B).mode.matmul_flops
    assert got == data_only
    assert abs(got - 2 * want) / got < 0.01


def _fields(t):
    c = t.cost
    return dict(flops=c.flops, hbm=c.hbm_bytes, matmul=t.mode.matmul_flops,
                n_ops=t.mode.n_ops, peak=t.mode.peak_bytes, fc=t.torch_flop_counter,
                args=t.argument_bytes, out=t.output_bytes, alias=t.alias_bytes,
                cross=t.mode.cross_node_bytes,
                coll={k: (s.count, s.bytes, s.raw_bytes) for k, s in c.collectives.items()},
                kernels={k: (r.launches, r.flops, r.bytes) for k, r in t.mode.kernels.items()})


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "dbrx-132b", "mixtral-8x7b"])
def test_microbatch_extrapolation_equals_full_count(name):
    """A train step of 8 microbatches counted from steps of 2 and 3 equals
    its full count in every field: f32 parameters (Qwen), bf16 ones with
    the f32 sums beside them (DBRX), and the MoE layer over a (2, 2)
    world's model group with its collectives (Mixtral)."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), microbatches=8)
    shape = InputShape("x", 8, 16, "train")
    if name == "mixtral-8x7b":
        with D.fake_world(2, 2) as grid:
            full = D._count_arch(cfg, shape, grid, False, False)
            fast = D.count_arch(cfg, shape, grid)
    else:
        full = D._count_arch(cfg, shape, None, False, False)
        fast = D.count_arch(cfg, shape)
    assert _fields(fast) == _fields(full)


# ----------------------------------------------------------------- the CLI
def _reference_source():
    return ast.parse(JAX_DRYRUN.read_text())


def test_flags_are_the_reference_flags_and_all():
    flags = {node.args[0].value for node in ast.walk(_reference_source())
             if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"}
    ours = {a.option_strings[0] for a in D.parser()._actions if a.option_strings
            and a.option_strings[0] != "-h"}
    assert ours == flags | {"--all"}


def _reference_row_keys():
    """JAX's row of ``dryrun_arch``: ``Roofline.row()`` and the keys its
    dryrun.py adds (``row[...] =`` and ``row.update(...)``)."""
    rl = jroofline.Roofline("a", "s", "m", 1, 0.0, 0.0, 0.0, {}, 0.0, 0.0, 0.0, 0.0, 0.0)
    keys = set(rl.row())
    fn = next(n for n in ast.walk(_reference_source())
              if isinstance(n, ast.FunctionDef) and n.name == "dryrun_arch")
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) and getattr(node.value, "id", "") == "row" \
                and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "update":
            keys |= {k.arg for k in node.keywords}
    return keys


def test_row_has_the_reference_keys(tmp_path):
    out = tmp_path / "row.json"
    assert D.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                   "--out", str(out)]) == 0
    row = json.loads(out.read_text())
    want = (_reference_row_keys() - {"lower_s", "compile_s", "xla_cost_analysis"}) | {
        "trace_s", "torch_flop_counter", "fits_hbm", "matmul_flops", "kernels"}
    assert set(row) == want
    assert row["mesh"] == "16x16" and row["chips"] == 256 and row["fits_hbm"] is True
    assert row["torch_flop_counter"]["flops"] == row["matmul_flops"] > 0
    assert not dist.is_initialized()


def test_kge_row_and_the_fake_world_is_gone(tmp_path):
    out = tmp_path / "kge.json"
    assert D.main(["--kge", "fb15k", "--kge-model", "transe_l1", "--out", str(out)]) == 0
    row = json.loads(out.read_text())
    assert row["arch"] == "kge-fb15k-transe_l1" and row["shape"] == "kge_step"
    assert {k: v["launches"] for k, v in row["kernels"].items()} == {
        "pairwise_l1": 2, "l1_bwd_pair": 2, "dedup_aggregate": 2, "fused_update": 2}
    assert set(row["collectives"]) == {"all-to-all", "all-gather", "reduce-scatter",
                                       "all-reduce"}
    assert not dist.is_initialized()


def test_failure_writes_the_error_row_and_a_gloo_world_runs_after(tmp_path):
    """A failing arch exits 1 with the reference's error row; the fake
    world is torn down after the exception, and a gloo world then runs in
    the same process (xdist workers run other files' worlds)."""
    out = tmp_path / "err.json"
    assert D.main(["--arch", "qwen1.5-0.5b", "--shape", "prefill_32k",
                   "--set", "n_kv_heads=3", "--out", str(out)]) == 1
    row = json.loads(out.read_text())
    assert set(row) == {"arch", "shape", "error", "traceback"}
    assert row["arch"] == "qwen1.5-0.5b" and row["shape"] == "prefill_32k"
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        x = torch.ones(3)
        dist.all_reduce(x)
        assert x.tolist() == [1.0, 1.0, 1.0]
        with pytest.raises(RuntimeError, match="default process group"):
            D.dryrun_kge("fb15k", False)
    finally:
        dist.destroy_process_group()


def test_unsupported_shape_is_skipped():
    row = D.dryrun_arch("qwen1.5-0.5b", "long_500k", False)
    assert set(row) == {"arch", "shape", "skipped"}
