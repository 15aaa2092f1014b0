"""The port's cost analysis (launch/hlo_analysis.py) against the JAX
package's HLO analyzer: the twins of tests/test_hlo_analysis.py, then the
KGE step's dry run at 2x2 and 4x2 against JAX's ``build_dist_train_step``
compiled on a mesh of the same shape.

The JAX side runs as tests/test_hlo_analysis.py runs it: ``jax.jit(...)
.lower(...).compile()`` and ``analyze_hlo`` of the compiled text, on the
conftest's 8 CPU devices. The port counts on meta tensors, in a
``"fake"``-backend world where it needs ranks (``launch/dryrun.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.common.compat import set_mesh, shard_map
from repro.configs import KGE_DATASETS as JAX_KGE
from repro.core.distributed import build_dist_train_step, make_program as jax_program
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_mesh
from repro_torch.common import collectives as C
from repro_torch.launch.dryrun import count_kge, fake_world, kge_program
from repro_torch.launch.hlo_analysis import analyze, trace

torch.set_num_threads(2)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ----------------------------------------------------------- the counter
def _tanh_loop(x, ws):
    for i in range(ws.shape[0]):
        x = torch.tanh(x @ ws[i])
    return x


def test_loop_flops_counted():
    """A loop of 6 tanh(x @ w) steps counts 6 x 2·128·256·256 FLOPs, as
    JAX's scan does once its trip count is read; torch's FlopCounterMode
    (the framework's own count) gives the products alone."""
    t = trace(_tanh_loop, _meta(128, 256), _meta(6, 256, 256))
    want = 6 * 2 * 128 * 256 * 256
    assert abs(t.cost.flops - want) / want < 0.01
    assert t.mode.matmul_flops == want == t.torch_flop_counter

    def f(x, ws):
        def body(x, w):
            return jnp.tanh(x @ w), None

        return jax.lax.scan(body, x, ws)[0]

    compiled = jax.jit(f).lower(jax.ShapeDtypeStruct((128, 256), jnp.float32),
                                jax.ShapeDtypeStruct((6, 256, 256), jnp.float32)).compile()
    jax_flops = analyze_hlo(compiled.as_text()).flops
    assert abs(t.cost.flops - jax_flops) / jax_flops < 0.01


def test_loop_equals_unroll():
    def unrolled(x, ws):
        x = torch.tanh(x @ ws[0])
        x = torch.tanh(x @ ws[1])
        x = torch.tanh(x @ ws[2])
        x = torch.tanh(x @ ws[3])
        return torch.tanh(x @ ws[4])

    args = (_meta(64, 64), _meta(5, 64, 64))
    looped, flat = analyze(_tanh_loop, *args), analyze(unrolled, *args)
    assert looped.flops == flat.flops and looped.hbm_bytes == flat.hbm_bytes
    # and JAX's scan against its unrolled form counts the same
    jax_scan = analyze_hlo(jax.jit(lambda x, ws: jax.lax.scan(
        lambda x, w: (jnp.tanh(x @ w), None), x, ws)[0]).lower(
        jax.ShapeDtypeStruct((64, 64), jnp.float32),
        jax.ShapeDtypeStruct((5, 64, 64), jnp.float32)).compile().as_text())
    assert abs(jax_scan.flops - looped.flops) / looped.flops < 0.01


def _ring_body(grid, x, ws):
    for i in range(ws.shape[0]):
        y = x @ ws[i]
        y = C.all_gather(y, grid.model_group, axis=1)
        y = C.psum(y, grid.model_group) / 2.0
        x = torch.tanh(y)
    return x


def test_collectives_counted_with_ring_factors(mesh8):
    """In a fake world of 8 (4 x 2), an all-gather and an all-reduce of a
    (16, 128) f32 shard over groups of 2, six times, give JAX's counts and
    ring bytes exactly: all-reduce 2 (n-1)/n x 8192 B, all-gather (n-1)/n
    of the gathered 8192 B."""
    def g(x, ws):
        def body(x, w):
            y = x @ w
            y = jax.lax.all_gather(y, "model", axis=1, tiled=True)
            y = jax.lax.psum(y, "model") / 2.0
            return jnp.tanh(y), None

        return jax.lax.scan(body, x, ws)[0]

    sm = shard_map(g, mesh=mesh8, in_specs=(P("data", None), P(None, None, "model")),
                   out_specs=P("data", None), check_vma=False)
    with set_mesh(mesh8):
        txt = jax.jit(sm).lower(jax.ShapeDtypeStruct((64, 128), jnp.float32),
                                jax.ShapeDtypeStruct((6, 128, 128), jnp.float32)
                                ).compile().as_text()
    want = analyze_hlo(txt, total_devices=8).collectives
    with fake_world(4, 2) as grid:
        got = analyze(lambda x, ws: _ring_body(grid, x, ws), _meta(16, 128),
                      _meta(6, 128, 64), total_devices=8).collectives
    assert not dist.is_initialized()
    for kind in ("all-reduce", "all-gather"):
        assert got[kind].count == want[kind].count == 6
        assert got[kind].bytes == want[kind].bytes
        assert got[kind].raw_bytes == want[kind].raw_bytes
    np.testing.assert_allclose(got["all-reduce"].bytes, 6 * 1.0 * 16 * 128 * 4)
    np.testing.assert_allclose(got["all-gather"].bytes, 6 * 0.5 * 16 * 128 * 4)


def test_bytes_of_a_small_program_by_hand():
    """Twice the output bytes of each op, nothing for a view or an
    allocation, three times the update for an in-place scatter or a copy
    into a slice, twice the target of a whole-tensor copy."""
    def prog(x, table, idx, rows):
        y = x + 1.0  # 2 x 4096 B
        z = y.view(-1)  # a view: 0
        s = z.sum()  # 2 x 4 B
        table.index_put_((idx,), rows)  # 3 x (8 rows x 64 x 4 B)
        out = torch.empty(4, 64, device=x.device)  # an allocation: 0
        out[0:2].copy_(table[:2])  # into a slice: 3 x 512 B
        out.copy_(table[4:8])  # whole: 2 x 1024 B
        return s, out

    args = (_meta(16, 64), _meta(32, 64), _meta(8, dtype=torch.int64), _meta(8, 64))
    c = analyze(prog, *args)
    assert c.hbm_bytes == 2 * 4096 + 2 * 4 + 3 * 8 * 64 * 4 + 3 * 512 + 2 * 1024
    # the add is on the reference's elementwise list: one FLOP an element
    assert c.flops == 16 * 64


# ----------------------------------------------------------- KGE parity
def _jax_kge(cfg, prog, mesh):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    jprog = jax_program(dataclasses.replace(JAX_KGE["fb15k"], **fields),
                        prog.rows_per_part, prog.rel_slots, n_shared=8)
    step, state_sh, batch_sh = build_dist_train_step(jprog, mesh)

    def sds(shapes, sh):
        return {k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=sh[k])
                for k, v in shapes.items()}

    with set_mesh(mesh):
        txt = step.lower(sds(jprog.state_shapes(), state_sh),
                         sds(jprog.batch_shapes(), batch_sh)).compile().as_text()
    return analyze_hlo(txt, total_devices=int(np.prod(mesh.devices.shape)))


@pytest.mark.parametrize("M,S", [(2, 2), (4, 2)])
@pytest.mark.parametrize("model", ["transe_l2", "transe_l1"])
def test_kge_step_matches_jax(M, S, model):
    """``dryrun_kge``'s count of FB15k against JAX's compiled step on an
    M x S mesh of the conftest's devices.

    FLOPs: XLA fuses every elementwise op of this program on the CPU, so
    the reference counts the products alone (TransE_l2: the pairwise dot
    forward and its two backward products; TransE_l1: none, its distance
    and sign sums are fusions). The port's products are the matmul
    formulas plus the pairwise kernel's tensor-core product (2 B K D a
    call; its l1 work runs on the fp32 units), within 1%.

    Collectives: all-gather and reduce-scatter (the negative-sharded
    route) equal in count and ring bytes. All-reduce: XLA's combiner
    merges the port's 7 into 3 (the psums of the loss terms), so only its
    ring bytes are held. All-to-all: the port's push re-sends the request
    ids its pull sent (``kvstore.push_remote_grads``), which XLA computes
    once (the same all-to-all of the same operand); so the port has 2
    more, the entity and relation ids, whose ring bytes are reckoned by
    hand."""
    mesh = make_mesh((M, S), ("data", "model"))
    cfg, prog = kge_program("fb15k", M, S, model)
    want = _jax_kge(cfg, prog, mesh)
    with fake_world(M, S) as grid:
        t = count_kge(prog, grid)
    assert not dist.is_initialized()
    pw = t.mode.kernels.get(f"pairwise_{'l1' if model == 'transe_l1' else 'l2sq'}")
    assert pw is not None and pw.launches == 2  # head and tail corruption
    tensor_core = 0.0
    if model == "transe_l2":
        # the product part of each call: 2 G B K D of the kernel's cost
        k_loc = cfg.neg_sample_size // S
        tensor_core = pw.launches * 2.0 * cfg.batch_size * k_loc * cfg.dim
    products = t.mode.matmul_flops + tensor_core
    if want.flops == 0:
        assert products == 0
    else:
        assert abs(products - want.flops) / want.flops < 0.01
    got = t.cost.collectives
    for kind in ("all-gather", "reduce-scatter"):
        assert got[kind].count == want.collectives[kind].count
        assert got[kind].bytes == want.collectives[kind].bytes
    assert got["all-reduce"].bytes == want.collectives["all-reduce"].bytes
    ids = 4 * M * (prog.Rp + prog.Rrp)  # the two id buffers, int32
    assert got["all-to-all"].count == want.collectives["all-to-all"].count + 2
    assert got["all-to-all"].bytes - want.collectives["all-to-all"].bytes == \
        pytest.approx((M - 1) / M * ids)
