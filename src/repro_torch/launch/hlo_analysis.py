"""Cost analysis of the port's programs: the twin of the JAX package's
launch/hlo_analysis.py.

JAX lowers and compiles a program and reads its HLO. Eager PyTorch has no
HLO, so this module **counts the aten ops the program dispatches**, under
a ``TorchDispatchMode`` (``CostMode``), usually on meta tensors, where
nothing is computed or allocated. A dispatched op stands where an HLO
instruction stands in the reference. For each one it counts:

  * **flops** -- ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
    baddbmm, convolution, SDPA: the reference's ``dot``/``convolution``),
    kept apart as ``matmul_flops`` too; plus one FLOP an output element for
    the reference's elementwise list (``ELEMENTWISE``: add, multiply, ...,
    compare, select);
  * **hbm_bytes** -- the reference's model, so that the two roofline
    tables read the same yardstick: twice the output bytes of every op (a
    write and one later read; operand reads belong to their producer);
    three times the update bytes for an in-place scatter (``index_put_``,
    ``index_copy_``, ``index_add_``, ``scatter_*``) or a ``copy_`` into a
    slice (the reference's ``_inplace_bytes`` of a scatter or
    dynamic-update-slice under donation); nothing for views, which stand
    where the reference skips bitcasts, nor for allocations;
  * **collectives** -- reported by ``common/collectives.py`` where the
    port issues them (the KVStore's all_to_alls go through it too), with
    the group's size and the reference's ring factors: all-reduce
    2(n-1)/n of the shard, all-gather (n-1)/n of the gathered output,
    reduce-scatter (n-1) x the output, all-to-all (n-1)/n, permute 1x; and
    twice the shard in HBM bytes, as the reference adds.

A kernel of ``csrc/`` launched through ``ctypes`` is invisible to any
dispatch mode, so each wrapper reports its ``KernelCost`` instead
(``common/cost.py``): on CUDA after its launch, on meta in its place. Its
operations add to ``flops``, its bytes to ``hbm_bytes``, and ``kernels``
keeps them by name with the launch count.

The reference multiplies a while loop's body by its trip count; eager
code dispatches every layer and every microbatch, so there is nothing to
multiply. All numbers are this rank's, as the reference's are per device.

``CostMode`` also tracks the bytes of live tensors that the program
allocates (each fresh output until it is freed) and their peak: the
twin of XLA's ``memory_analysis`` temp bytes (``launch/roofline.py``).

``analyze(fn, *args, total_devices=)`` is the twin of ``analyze_hlo``;
the twin of ``xla_cost_analysis`` is torch's own ``FlopCounterMode``
(``common/compat.py``), whose total ``trace`` keeps beside the count.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common import compat, cost
from repro_torch.common.cost import KernelCost
from repro_torch.common.hw import H100_SXM


@dataclasses.dataclass
class CollectiveStat:
    kind: str
    count: float = 0.0
    bytes: float = 0.0  # per-device link bytes (ring model)
    raw_bytes: float = 0.0  # shard bytes without ring factor


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, CollectiveStat] = dataclasses.field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return sum(c.bytes for c in self.collectives.values())

    def add(self, other: "HloCost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for k, c in other.collectives.items():
            s = self.collectives.setdefault(k, CollectiveStat(kind=k))
            s.count += c.count * mult
            s.bytes += c.bytes * mult
            s.raw_bytes += c.raw_bytes * mult


@dataclasses.dataclass
class KernelRecord:
    launches: int = 0
    flops: float = 0.0
    bytes: float = 0.0


# the reference's elementwise list (one FLOP an output element), by aten name
ELEMENTWISE = frozenset((
    "add", "add_", "mul", "mul_", "sub", "sub_", "rsub", "div", "div_", "exp", "exp_",
    "tanh", "tanh_", "rsqrt", "rsqrt_", "maximum", "minimum", "where", "eq", "ne",
    "lt", "le", "gt", "ge", "neg", "neg_", "pow", "pow_", "log", "log_", "sin", "cos",
))
# in-place scatters: three times the update bytes
SCATTERS = frozenset(("index_put_", "_index_put_impl_", "index_copy_", "index_add_",
                      "scatter_", "scatter_add_", "scatter_reduce_"))
# allocations: no bytes moved
ALLOCATIONS = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "lift_fresh", "_local_scalar_dense"))
# views whose schemas carry no alias annotation (matmul's reshape of its
# product): counted as views
UNANNOTATED_VIEWS = frozenset(("_unsafe_view",))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
          torch.memory_format)


def _flat(x, out: list) -> list:
    """The leaves of nested tuples, lists and dicts, in order."""
    if isinstance(x, (tuple, list)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    else:
        out.append(x)
    return out


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in _flat(tree, []) if isinstance(x, torch.Tensor)]


def _update_bytes(name: str, args) -> int:
    """The update's bytes of an in-place scatter."""
    self_ = args[0]
    isz = self_.element_size()
    if name in ("index_put_", "_index_put_impl_"):
        idx = [i for i in args[1] if i is not None]
        if not idx:
            return _nbytes(self_)
        rows = torch.broadcast_shapes(*(i.shape for i in idx)).numel()
        if idx[0].dtype == torch.bool:
            rows = idx[0].numel()  # a mask: every position it may write
        rest = self_.shape[len(args[1]):].numel()
        return rows * rest * isz
    if name in ("index_copy_", "index_add_"):
        return _nbytes(args[3])
    return args[2].numel() * isz  # scatter*: the index tensor's positions


class CostMode(TorchDispatchMode):
    """Counts what the ops dispatched inside it do (module docstring) and
    takes the kernels' and collectives' reports (``common/cost.py``) while
    it is entered. ``total_devices`` is the world's size (no collective's
    group exceeds it); ``keep_ops`` keeps one text line an op
    (``--hlo-out``)."""

    def __init__(self, total_devices: int = 1, keep_ops: bool = False):
        super().__init__()
        self.total_devices = total_devices
        self.cost = HloCost()
        self.matmul_flops = 0.0
        self.kernels: Dict[str, KernelRecord] = {}
        self.n_ops = 0
        self.ops: Optional[List[str]] = [] if keep_ops else None
        self.cross_node_bytes = 0.0  # link bytes of groups that span nodes
        self.live_bytes = 0
        self.peak_bytes = 0
        self._kinds: Dict[Any, tuple] = {}
        self._meta_outs: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ the seam
    def __enter__(self):
        if cost.ACTIVE is not None:
            raise RuntimeError("a cost analysis is active already")
        cost.ACTIVE = self
        try:
            return super().__enter__()
        except BaseException:
            cost.ACTIVE = None
            raise

    def __exit__(self, *exc):
        cost.ACTIVE = None
        return super().__exit__(*exc)

    def kernel(self, kc: KernelCost) -> None:
        with self._lock:
            r = self.kernels.setdefault(kc.name, KernelRecord())
            r.launches += 1
            r.flops += kc.total_flops
            r.bytes += kc.bytes
            self.cost.flops += kc.total_flops
            self.cost.hbm_bytes += kc.bytes
            if self.ops is not None:
                self.ops.append(f"kernel {kc.name} flops={kc.total_flops:.0f} "
                                f"bytes={kc.bytes:.0f}")

    def collective(self, kind: str, ranks, out_bytes: int, operand_bytes: int) -> None:
        """One collective over the group of global ``ranks``, by the
        reference's ring model (``analyze_hlo``). Its link bytes go to
        ``cross_node_bytes`` too when the group spans nodes (more ranks
        than one node's NVLink domain joins, ``common/hw.py``)."""
        n = len(ranks)
        if n > self.total_devices:
            raise ValueError(f"a {kind} over {n} ranks in a count of "
                             f"{self.total_devices} devices")
        shard = out_bytes if kind == "all-gather" else max(out_bytes, operand_bytes)
        if kind == "all-reduce":
            link = 2.0 * (n - 1) / n * shard
        elif kind == "all-gather":
            link = (n - 1) / n * out_bytes
        elif kind == "reduce-scatter":
            link = float((n - 1) * out_bytes)
        elif kind == "all-to-all":
            link = (n - 1) / n * shard
        else:  # collective-permute
            link = float(shard)
        with self._lock:
            s = self.cost.collectives.setdefault(kind, CollectiveStat(kind=kind))
            s.count += 1
            s.bytes += link
            s.raw_bytes += shard
            if len({r // H100_SXM.nvlink_domain for r in ranks}) > 1:
                self.cross_node_bytes += link
            self.cost.hbm_bytes += 2 * shard
            if self.ops is not None:
                self.ops.append(f"collective {kind} n={n} shard={shard} link={link:.0f}")

    # ------------------------------------------------------------ the ops
    def _kind(self, func):
        k = self._kinds.get(func)
        if k is None:
            name = func.overloadpacket.__name__
            rets = func._schema.returns
            alias = [r.alias_info for r in rets if r.alias_info is not None]
            if name in ALLOCATIONS:
                kind = "alloc"
            elif any(a.is_write for a in alias) or func._schema.is_mutable:
                kind = "scatter" if name in SCATTERS else (
                    "copy" if name == "copy_" else "inplace")
            elif alias or name in UNANNOTATED_VIEWS:
                kind = "view"
            else:
                kind = "op"
            k = (kind, name, compat.flop_formula(func), name in ELEMENTWISE)
            self._kinds[func] = k
        return k

    def _free(self, n: int) -> None:
        with self._lock:
            self.live_bytes -= n

    def _meta_op(self, func, leaves, args, kwargs):
        """A functional op on meta tensors, by its inputs' metadata: torch's
        meta kernels of elementwise ops run as Python references (~100 us
        a call), so each output's shape, strides and dtype are kept the
        first time and fresh meta tensors of them are made after."""
        if not any(isinstance(x, torch.Tensor) for x in leaves):
            return func(*args, **kwargs)  # a factory: its device is an argument
        key = [func]
        for x in leaves:
            if isinstance(x, torch.Tensor):
                if not x.is_meta:
                    return func(*args, **kwargs)
                key.append((x.shape, x.stride(), x.dtype, x.storage_offset()))
            elif isinstance(x, _PLAIN):
                key.append((type(x), x))
            else:
                return func(*args, **kwargs)
        key = tuple(key)
        spec = self._meta_outs.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                spec = (out.shape, out.stride(), out.dtype)
            elif isinstance(out, tuple) and all(isinstance(t, torch.Tensor) for t in out):
                spec = [(t.shape, t.stride(), t.dtype) for t in out]
            else:
                spec = False  # another structure: not kept
            self._meta_outs[key] = spec
            return out
        if spec is False:
            return func(*args, **kwargs)
        if isinstance(spec, tuple):
            return torch.empty_strided(spec[0], spec[1], dtype=spec[2], device="meta")
        return tuple(torch.empty_strided(sh, st, dtype=dt, device="meta")
                     for sh, st, dt in spec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind, name, formula, elementwise = self._kind(func)
        leaves = _flat((args, kwargs), [])
        if kind == "op" and formula is None:  # torch's FlopCounterMode sees the rest
            out = self._meta_op(func, leaves, args, kwargs)
        else:
            out = func(*args, **kwargs)
        outs = [out] if isinstance(out, torch.Tensor) else _tensors(out)
        flops = 0.0
        if formula is not None:
            flops = float(formula(args, kwargs, out))
            self.matmul_flops += flops
        elif elementwise:
            flops = float(sum(t.numel() for t in outs))
        if kind == "alloc" or kind == "view":
            nbytes = 0
        elif kind == "scatter":
            nbytes = 3 * _update_bytes(name, args)
        elif kind == "copy":
            dst = args[0]
            nb = _nbytes(dst)
            nbytes = 3 * nb if nb < dst.untyped_storage().nbytes() else 2 * nb
        else:
            nbytes = 2 * sum(_nbytes(t) for t in outs)
        with self._lock:
            self.n_ops += 1
            self.cost.flops += flops
            self.cost.hbm_bytes += nbytes
            if kind in ("op", "alloc"):
                for t in outs:
                    if any(t is x for x in leaves):  # an op that hands back an input
                        continue
                    n = t.untyped_storage().nbytes()
                    self.live_bytes += n
                    weakref.finalize(t, self._free, n)
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            if self.ops is not None:
                shapes = " ".join(f"{str(t.dtype)[6:]}{list(t.shape)}" for t in outs)
                self.ops.append(f"{func} -> {shapes} flops={flops:.0f} bytes={nbytes}")
        return out


@dataclasses.dataclass
class Trace:
    """What ``trace`` counted: the mode (cost, matmul FLOPs, kernels, ops,
    peak live bytes), torch's ``FlopCounterMode`` total beside it, and the
    bytes of the arguments and of the outputs (fresh or aliasing an
    argument)."""

    mode: CostMode
    torch_flop_counter: int
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    result: Any = None

    @property
    def cost(self) -> HloCost:
        return self.mode.cost

    @property
    def bytes_per_device(self) -> int:
        """argument + output - alias + temp, as the reference reads XLA's
        memory analysis: the arguments, and the peak of what the program
        allocated (which holds its fresh outputs)."""
        fresh = self.output_bytes - self.alias_bytes
        return self.argument_bytes + max(self.mode.peak_bytes, fresh)

    @property
    def temp_bytes(self) -> int:
        return max(0, self.mode.peak_bytes - (self.output_bytes - self.alias_bytes))


def _storage(t: torch.Tensor) -> int:
    """A key of the tensor's storage (the same for every view of it)."""
    return t.untyped_storage()._cdata


def trace(fn, *args, total_devices: int = 1, keep_ops: bool = False) -> Trace:
    """Run ``fn(*args)`` under ``CostMode`` and torch's ``FlopCounterMode``;
    return the count. The arguments' bytes count once per storage."""
    arg_storages = {}
    for t in _tensors(args):
        arg_storages[_storage(t)] = t.untyped_storage().nbytes()
    fc = compat.flop_counter_mode()
    mode = CostMode(total_devices=total_devices, keep_ops=keep_ops)
    with fc, mode:
        result = fn(*args)
    outs = _tensors(result)
    alias = sum(_nbytes(t) for t in outs if _storage(t) in arg_storages)
    return Trace(mode=mode, torch_flop_counter=int(fc.get_total_flops()),
                 argument_bytes=sum(arg_storages.values()),
                 output_bytes=sum(_nbytes(t) for t in outs), alias_bytes=alias,
                 result=result)


def analyze(fn, *args, total_devices: int = 1) -> HloCost:
    """The cost of ``fn(*args)`` on this rank: the twin of ``analyze_hlo``."""
    return trace(fn, *args, total_devices=total_devices).cost
