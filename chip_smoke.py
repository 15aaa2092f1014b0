#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. environment: the card's name and power limit, torch, capability (9, 0);
  2. build: every CUDA kernel of the training path, compiled from csrc/;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the training path's shapes and a ragged one, with its time, the plain
     version's time, one PyTorch library call's time as a yardstick, and the
     least time the card could take for the same work (bound);
  4. agreement: three dim-400 training steps at batch 256 and k 64 on a
     small synthetic graph, on the card (kernels) and on the CPU (plain
     versions), from the same tables and batches;
  5. main path: ``python -m repro_torch.launch.train --dataset fb15k --model
     transe_l2`` (14,951 x 400 entities, batch 1024, 256 joint negatives, T5
     deferred update on) for 200 steps; the loss must fall and every kernel
     must have launched at least twice a step.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository around it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
TOL_REL = 2e-5  # kernel vs plain: fp32 sums taken in another order
MAIN_PATH_STEPS = 200

TPU_KERNEL = {
    "pairwise": "src/repro/kernels/kge_score/kge_score.py:57",
    "dedup_aggregate": "src/repro/kernels/sparse_adagrad/sparse_adagrad.py:152",
    "fused_update": "src/repro/kernels/sparse_adagrad/sparse_adagrad.py:74",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps=50, warmup=5):
    """Mean time of ``fn`` over ``reps`` back-to-back calls between two CUDA
    events. For a kernel of a few microseconds this is the host's launch
    rate (Python, ctypes, the wrapper's checks), not the kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _self_device_us(evt) -> float:
    """Device time of a kernel, memcpy or memset event; 0 for a host event."""
    import torch

    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(evt.self_device_time_total)


def device_ms(torch, fn, reps=50, warmup=5):
    """Device time of one call of ``fn``: the kernels' own durations, traced
    by torch.profiler (CUPTI) over ``reps`` calls, summed, divided by
    ``reps``. Inputs stay warm in L2, as on the training path, where each
    kernel reads what the step just wrote."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_self_device_us(e) for e in prof.key_averages())
    check(total_us > 0, "torch.profiler saw no device time")
    return total_us / reps / 1e3


def timings(torch, kernel, plain, library, reps=50):
    return dict(ms=device_ms(torch, kernel, reps), plain_ms=device_ms(torch, plain, 20),
                library_ms=device_ms(torch, library, 20),
                event_ms=event_ms(torch, kernel, reps))


def _fmt(r) -> str:
    return (f"ms {r['ms']:.5f}  plain_ms {r['plain_ms']:.5f}  library_ms "
            f"{r['library_ms']:.5f}  event_ms {r['event_ms']:.5f}  bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_pairwise(torch, dev, gen):
    from repro_torch.kernels.kge_score.ops import pairwise_kernel
    from repro_torch.kernels.kge_score.ref import pairwise_ref

    rows = []
    path, ragged = (1, 1024, 256, 400), (2, 1000, 250, 300)
    data = {s: (torch.randn(s[0], s[1], s[3], generator=gen).to(dev),
                torch.randn(s[0], s[2], s[3], generator=gen).to(dev))
            for s in (path, ragged)}
    library = {
        "dot": lambda o, n: o @ n.transpose(-1, -2),
        "l2sq": lambda o, n: torch.cdist(o, n) ** 2,
        "l1": lambda o, n: torch.cdist(o, n, p=1),
    }
    for mode in ("dot", "l2sq", "l1"):
        err, tol = 0.0, 0.0
        for shape, (o, n) in data.items():
            out = pairwise_kernel(mode, o, n)
            ref = pairwise_ref(mode, o, n)
            torch.cuda.synchronize()
            e = float((out - ref).abs().max())
            t = TOL_REL * max(1.0, float(ref.abs().max()))
            print(f"  pairwise {mode:4s} {shape}: max_abs_err {e:.3e} (tol {t:.3e})")
            check(out.shape == ref.shape and math.isfinite(e) and e <= t,
                  f"pairwise {mode} {shape} disagrees: {e} > {t}")
            err, tol = max(err, e), max(tol, t)
        G, B, K, D = path
        o, n = data[path]
        tm = timings(torch, lambda: pairwise_kernel(mode, o, n),
                     lambda: pairwise_ref(mode, o, n), lambda: library[mode](o, n))
        n_bytes = 4 * G * (B * D + K * D + B * K)
        n_ops = {"dot": 2 * B * K * D,
                 "l2sq": 2 * B * K * D + 2 * (B + K) * D + 3 * B * K,
                 "l1": 3 * B * K * D}[mode] * G
        b_ms, b_by = bound(n_bytes, n_ops)
        rows.append(dict(name=f"pairwise_{mode}", source="src/repro_torch/csrc/pairwise.cu",
                         replaces=TPU_KERNEL["pairwise"], max_abs_err=err, tol=tol,
                         bound_ms=b_ms, bound_by=b_by, shape=f"{G}x{B}x{K}x{D}", **tm))
    return rows


def _dedup_ids(torch, gen, n, n_rows):
    """ids like a step's workspace: uniform rows, repeats of earlier slots
    (in-batch negatives, popular entities) and pads."""
    ids = torch.randint(0, n_rows, (n,), generator=gen)
    rep = torch.rand(n, generator=gen) < 0.3
    src = (torch.rand(n, generator=gen) * torch.arange(n)).long()
    ids = torch.where(rep, ids[src], ids)
    ids[torch.rand(n, generator=gen) < 0.1] = -1
    return ids.to(torch.int32)


def path_batch_ids(torch, np, dev):
    """The entity and relation ids one FB15k main-path step hands the dedup
    kernel: a JointSampler batch on the full-scale synthetic graph, whose
    ids are Zipf-skewed (one relation fills 100-140 of 1024 slots)."""
    import dataclasses

    from repro_torch.configs import FB15K
    from repro_torch.core import kge_model as K
    from repro_torch.core.sampling import JointSampler
    from repro_torch.data.kg_synth import fb15k_like

    kg = fb15k_like(scale=1.0, seed=0)
    cfg = dataclasses.replace(FB15K, n_entities=kg.n_entities,
                              n_relations=kg.n_relations)
    batch = JointSampler(kg.train, cfg.n_entities, cfg, np.random.default_rng(0)).sample()
    ws = K.dense_step_batch(K.batch_to_device(batch, dev))
    return ws["ent_ids"].to(torch.int32), ws["rel_ids"].to(torch.int32)


def check_dedup(torch, np, dev, gen):
    from repro_torch.kernels.sparse_adagrad.ops import dedup_aggregate
    from repro_torch.kernels.sparse_adagrad.ref import dedup_aggregate_ref

    ent, rel = path_batch_ids(torch, np, dev)
    cases = {"entity": ent, "relation": rel,
             "entity_pads": _dedup_ids(torch, gen, 2560, 14951),
             "relation_pads": _dedup_ids(torch, gen, 1024, 1345)}
    err, tol, timed = 0.0, 0.0, {}
    for case, ids in cases.items():
        n, D = ids.numel(), 400
        ids = ids.to(dev)
        g = torch.randn(n, D, generator=gen).to(dev)
        uid, agg = dedup_aggregate(ids, g)
        ru, ra = dedup_aggregate_ref(ids, g)
        torch.cuda.synchronize()
        e = float((agg - ra).abs().max())
        t = TOL_REL * max(1.0, float(ra.abs().max()))
        n_first = int((ru >= 0).sum())
        most = int(torch.bincount(ids[ids >= 0].long()).max())
        print(f"  dedup_aggregate {case} n={n} D={D}: {n_first} first occurrences, "
              f"most repeated id x{most}, max_abs_err {e:.3e} (tol {t:.3e})")
        check(torch.equal(uid, ru), f"dedup_aggregate {case}: ids disagree")
        check(math.isfinite(e) and e <= t, f"dedup_aggregate {case} disagrees: {e} > {t}")
        err, tol = max(err, e), max(tol, t)
        # the yardstick: index_add_ of every slot into its first occurrence
        match = (ids[:, None] == ids[None, :]) & (ids >= 0)[:, None]
        inv = torch.where(ids >= 0, match.int().argmax(1), n)
        tm = timings(torch, lambda: dedup_aggregate(ids, g),
                     lambda: dedup_aggregate_ref(ids, g),
                     lambda: torch.zeros(n + 1, D, device=dev).index_add_(0, inv, g))
        n_bytes = 4 * (2 * n + 2 * n * D)
        n_ops = n * n + n * D  # id compares + row adds
        b_ms, b_by = bound(n_bytes, n_ops)
        timed[case] = dict(shape=f"n={n} D={D}", bound_ms=b_ms, bound_by=b_by, **tm)
        print(f"    {_fmt(timed[case])}")
    return [dict(name="dedup_aggregate", source="src/repro_torch/csrc/dedup_aggregate.cu",
                 replaces=TPU_KERNEL["dedup_aggregate"], max_abs_err=err, tol=tol,
                 **timed["entity"], other_shapes={k: timed[k] for k in
                                                 ("relation", "entity_pads",
                                                  "relation_pads")})]


def check_update(torch, dev, gen):
    from repro_torch.kernels.sparse_adagrad.ops import fused_sparse_adagrad
    from repro_torch.kernels.sparse_adagrad.ref import fused_update_ref

    lr, eps, err, tol, timed = 0.25, 1e-10, 0.0, 0.0, {}
    for n, n_rows in ((2560, 14951), (1024, 1345)):
        D = 400
        table = torch.randn(n_rows, D, generator=gen).to(dev)
        gsq = torch.rand(n_rows, D, generator=gen).to(dev)
        ids = torch.randperm(n_rows, generator=gen)[:n].to(torch.int32)
        ids[torch.rand(n, generator=gen) < 0.15] = -1  # duplicates after dedup
        ids = ids.to(dev)
        g = torch.randn(n, D, generator=gen).to(dev)
        kt, kq, pt, pq = table.clone(), gsq.clone(), table.clone(), gsq.clone()
        fused_sparse_adagrad(kt, kq, ids, g, lr, eps)
        fused_update_ref(pt, pq, ids, g, lr, eps)
        torch.cuda.synchronize()
        e = max(float((kt - pt).abs().max()), float((kq - pq).abs().max()))
        t = TOL_REL * max(1.0, float(pt.abs().max()), float(pq.abs().max()))
        untouched = torch.ones(n_rows, dtype=torch.bool, device=dev)
        untouched[ids[ids >= 0].long()] = False
        same = torch.equal(kt[untouched], table[untouched]) and \
            torch.equal(kq[untouched], gsq[untouched])
        print(f"  fused_update {n_rows}x{D}, n={n}: max_abs_err {e:.3e} "
              f"(tol {t:.3e}), untouched rows bit-identical {same}")
        check(same and math.isfinite(e) and e <= t,
              f"fused_update n={n} disagrees: {e} > {t} or untouched rows moved")
        err, tol = max(err, e), max(tol, t)
        valid = ids >= 0
        rows, gv = ids[valid].long(), g[valid]
        v = int(rows.numel())

        def library():
            q = gsq.index_select(0, rows) + gv * gv
            gsq.index_copy_(0, rows, q)
            table.index_add_(0, rows, -(lr * gv / (q.sqrt() + eps)))

        tm = timings(torch, lambda: fused_sparse_adagrad(kt, kq, ids, g, lr, eps),
                     lambda: fused_update_ref(pt, pq, ids, g, lr, eps), library)
        n_bytes = 4 * (n + 5 * v * D)  # ids; grad, table, gsq rows in; two rows out
        n_ops = 7 * v * D
        b_ms, b_by = bound(n_bytes, n_ops)
        timed[n] = dict(bound_ms=b_ms, bound_by=b_by, **tm)
        print(f"    {_fmt(timed[n])}, {v} valid rows")
    return [dict(name="fused_update", source="src/repro_torch/csrc/fused_update.cu",
                 replaces=TPU_KERNEL["fused_update"], max_abs_err=err, tol=tol,
                 shape="14951x400, n=2560", **timed[2560],
                 other_shapes={"relation": {"shape": "1345x400, n=1024", **timed[1024]}})]


# ---------------------------------------------------------------------------
# phase 4: a few dim-400 steps on a small graph, card vs CPU
# ---------------------------------------------------------------------------
def check_agreement(torch, np, dev):
    import dataclasses

    from repro_torch.configs import FB15K
    from repro_torch.core import kge_model as K
    from repro_torch.core.sampling import JointSampler
    from repro_torch.data.kg_synth import fb15k_like

    kg = fb15k_like(scale=0.05, seed=1)
    cfg = dataclasses.replace(FB15K, n_entities=kg.n_entities,
                              n_relations=kg.n_relations, batch_size=256,
                              neg_sample_size=64)
    steps = 3
    states = {d: K.init_state(cfg, torch.Generator().manual_seed(1), overlap=True,
                              device=d) for d in (dev, "cpu")}
    sampler = JointSampler(kg.train, cfg.n_entities, cfg, np.random.default_rng(1))
    losses = {dev: [], "cpu": []}
    for _ in range(steps):
        batch = sampler.sample()
        for d in states:
            states[d], m = K.train_step(cfg, states[d], K.batch_to_device(batch, d))
            losses[d].append(float(m["loss"]))
    for d in states:
        states[d] = K.flush_state(cfg, states[d])
    got, want = K.state_to_arrays(states[dev]), K.state_to_arrays(states["cpu"])
    print(f"  losses card {losses[dev]} cpu {losses['cpu']}")
    check(np.allclose(losses[dev], losses["cpu"], rtol=1e-5, atol=1e-5),
          "card and CPU losses disagree")
    # Adagrad's first step is ~+-lr for any nonzero grad: an entry whose grad
    # is near zero may flip; allow 0.1% of entries, by at most 2 lr steps
    for name in ("entity", "ent_gsq", "r_emb", "rel_gsq"):
        diff = np.abs(got[name] - want[name])
        off = float((diff > 1e-5 + 1e-5 * np.abs(want[name])).mean())
        print(f"  {name}: max diff {diff.max():.3e}, share off {off:.2e}")
        check(off <= 1e-3 and diff.max() <= 2 * cfg.lr * steps,
              f"card and CPU {name} disagree")


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------
def run_main_path(torch, np, steps):
    from repro_torch.kernels import build
    from repro_torch.launch import engine, train

    class Window(engine.Hook):
        """Device-synchronised wall time of steps ``a+1..b``; with
        ``profile``, also the device time of their kernels (torch.profiler)."""

        def __init__(self, a, b, profile=False):
            self.a, self.b, self.profile = a, b, profile
            self.ms = self.prof = None

        def on_step(self, i, state, metrics, stats):
            if i == self.a:
                torch.cuda.synchronize()
                if self.profile:
                    from torch.profiler import ProfilerActivity, profile

                    self.prof = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                    self.prof.start()
                self.t0 = time.perf_counter()
            elif i == self.b:
                torch.cuda.synchronize()
                self.ms = (time.perf_counter() - self.t0) / (self.b - self.a) * 1e3
                if self.prof is not None:
                    self.prof.stop()

    metrics = engine.MetricsHook(("loss", "pos_score", "neg_score", "pend_dropped"))
    timing = Window(20, steps - 50)  # steady state, untraced
    traced = Window(steps - 40, steps - 20, profile=True)
    build.reset_launches()
    t0 = time.perf_counter()
    cfg, state = train.main(["--dataset", "fb15k", "--model", "transe_l2",
                             "--steps", str(steps), "--log-every", "50"],
                            hooks=[metrics, timing, traced])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    hist = metrics.history
    loss = np.asarray(hist["loss"])
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    step_ms = timing.ms
    n_traced = traced.b - traced.a
    kern = [e for e in traced.prof.key_averages() if _self_device_us(e) > 0]
    device_step_ms = sum(_self_device_us(e) for e in kern) / n_traced / 1e3
    busy = device_step_ms / step_ms
    print(f"  config: {cfg.n_entities} x {cfg.dim} entities, {cfg.n_relations} "
          f"relations, batch {cfg.batch_size}, k {cfg.neg_sample_size}, "
          f"groups {cfg.n_neg_groups}, gamma {cfg.gamma}, lr {cfg.lr}, "
          f"overlap {cfg.overlap_update}")
    print(f"  loss: first-10 mean {first:.4f} -> last-10 mean {last:.4f}")
    print(f"  step {step_ms:.4f} ms over steps {timing.a + 1}..{timing.b}, "
          f"{cfg.batch_size / step_ms * 1e3:.0f} triplets/s; whole run "
          f"{wall:.1f} s incl. graph generation")
    print(f"  device time {device_step_ms:.4f} ms a step (traced steps "
          f"{traced.a + 1}..{traced.b}; traced step {traced.ms:.4f} ms): device "
          f"busy {busy:.1%} of the untraced step, idle {1 - busy:.1%}")
    print("  device time a step by kernel:")
    for e in sorted(kern, key=_self_device_us, reverse=True)[:12]:
        print(f"    {_self_device_us(e) / n_traced:9.2f} us  x{e.count / n_traced:4.1f}  "
              f"{e.key[:90]}")
    print(f"  launches in the run: {launches}")
    check(np.isfinite(loss).all(), "non-finite loss")
    check(last < first, f"loss did not fall: {first} -> {last}")
    check(max(hist["pend_dropped"]) == 0, "deferred update dropped rows")
    check(tuple(state.entity.shape) == (cfg.n_entities, cfg.dim)
          and bool(torch.isfinite(state.entity).all())
          and bool(torch.isfinite(state.r_emb).all()), "tables not finite")
    for name in ("pairwise_l2sq", "dedup_aggregate", "fused_update"):
        check(launches[name] >= 2 * steps,
              f"{name} launched {launches[name]} times in {steps} steps")
    return launches, dict(step_ms=step_ms, device_ms_per_step=device_step_ms,
                          device_busy=busy, loss_first10=first, loss_last10=last,
                          triplets_per_s=cfg.batch_size / step_ms * 1e3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.kernels import build

    # fp32 everywhere: the plain versions' matmuls must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== 1. environment")
    smi = nvidia_smi_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"  {smi}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"capability {cap}; {torch.cuda.device_count()} device(s)")
    check(cap == (9, 0), f"needs a Hopper card (capability (9, 0)), got {cap}")
    dev = torch.device("cuda", 0)

    print("== 2. build")
    t0 = time.perf_counter()
    paths = build.build(verbose=True)
    print(f"  built {len(paths)} libraries in {time.perf_counter() - t0:.2f} s")

    print("== 3. kernels vs plain versions")
    gen = torch.Generator().manual_seed(0)
    rows = check_pairwise(torch, dev, gen) + check_dedup(torch, np, dev, gen) \
        + check_update(torch, dev, gen)
    for r in rows:
        print(f"  {r['name']:16s} {r['shape']:>18s}: {_fmt(r)}  err "
              f"{r['max_abs_err']:.2e} <= {r['tol']:.2e}")

    print("== 4. card vs CPU, three dim-400 steps at batch 256, k 64")
    check_agreement(torch, np, dev)

    print(f"== 5. main path: FB15k TransE_l2, {MAIN_PATH_STEPS} steps")
    launches, path = run_main_path(torch, np, MAIN_PATH_STEPS)

    kernels = []
    for r in rows:
        kernels.append(dict(
            name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
            launches=launches[r["name"]], max_abs_err=r["max_abs_err"], tol=r["tol"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], event_ms=r["event_ms"],
            shape=r["shape"],
            **({"other_shapes": r["other_shapes"]} if "other_shapes" in r else {})))
    print(json.dumps({"main_path": path}))
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
