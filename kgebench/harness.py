"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic, ``workloads/<cell>.json`` its step counts
and the limits of its check, ``configs/<config>.json`` the model and its
sizes, ``traffic/<traffic>.json`` the batch stream, ``metrics/<metric>.py``
the reader of each metric, ``reference/<model>.py`` the model's plain
scores. A later cell, configuration or metric adds files of its own.

The program under test is the port (``repro_torch``), driven on its normal
path as ``launch/train.py``'s single-machine training builds it: the port's
``JointSampler`` through the ``Prefetcher`` of ``engine.train_loop``,
``kge_model.batch_to_device``, ``kge_model.train_step`` on a state with the
deferred entity update (T5), ``kge_model.flush_state`` after the window.
The benchmark draws the tables on the card from ``--seed`` and hands them
to the port, draws them again for the reference, and reads the port's
state and losses only to judge them.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from kgebench import load_module

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level names
CHECKED = ("batch_ids", "loss", "grad_norm", "param_change", "nonfinite_loss")
# how each model's projection table starts, as the port's init_state draws
# it; a model not listed has no projection table
PROJECTION_INIT = {"rescal": "uniform", "transr": "identity"}
# configuration keys whose every other value the program and the reference
# here do not implement: a configuration that states another is refused
SUPPORTED = {"optimizer": ("sparse_adagrad",), "dtype": ("float32",),
             "corrupt_both": (True,), "loss": ("self_adv",),
             "adversarial_temperature": (1.0,), "regularization_coef": (0.0,)}


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]  # the manifest's entries this cell reports
    per_layer: List[dict]
    bench: Path = HERE  # the folder of the cell's files

    @property
    def spec(self) -> dict:
        """The numbers the program, the reference and the cost formulas
        share."""
        c, t = self.config, self.traffic
        ds = c["dataset"]
        return {"model": c["model"], "n_entities": ds["n_entities"],
                "n_relations": ds["n_relations"], "dim": c["dim"],
                "rel_dim": c["rel_dim"], "gamma": c["gamma"], "lr": c["lr"],
                "eps": c["eps"], "loss": c["loss"], "batch_size": c["batch_size"],
                "neg_sample_size": c["neg_sample_size"],
                "neg_group_size": c["neg_group_size"],
                "overlap_update": c["overlap_update"],
                "projection_init": PROJECTION_INIT.get(c["model"]),
                "neg_deg_ratio": t["neg_deg_ratio"]}


def _reports(entry: dict, cell: str) -> bool:
    return cell in entry.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files read
    from ``root``'s copy of this folder."""
    bench = root / HERE.name
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = cells[name]
    work = load_json(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if work[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} {work[key]!r} is "
                             f"not BENCHMARK.json's {entry[key]!r}")
    conf = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    config = load_json(root / conf["file"])
    for key, ok in SUPPORTED.items():
        if config[key] not in ok:
            raise ValueError(f"{conf['file']}: {key} {config[key]!r}; the benchmark "
                             f"implements {ok}")
    traffic = load_json(bench / "traffic" / f"{entry['traffic']}.json")
    if (traffic["loop"], traffic["sampler"], traffic["samplers"],
            traffic["trainers"]) != ("closed", "joint", 1, 1):
        raise ValueError(f"traffic {entry['traffic']!r}: the generator drives a "
                         "closed loop of one trainer on one joint sampler")
    return Cell(name, entry["chips"], config, traffic, work,
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)], bench)


# --------------------------------------------------------------------------
# inputs, drawn from the seed
def draw_tables(spec: dict, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """The initial tables, uniform in (-s, s) with s = (gamma + 2) / dim as
    the port's ``init_state`` draws them (TransR's projection 0.1 of that
    plus the identity), but on ``device`` from a generator there: the same
    seed gives the same tables on one kind of device."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    d, rd = spec["dim"], spec["rel_dim"]
    s = (spec["gamma"] + 2.0) / d

    def uniform(rows, width):
        return torch.empty((rows, width), device=device).uniform_(-s, s, generator=gen)

    out = {"entity": uniform(spec["n_entities"], d),
           "relation": uniform(spec["n_relations"], rd)}
    init = spec["projection_init"]  # None: the model has no projection table
    if init is not None:
        out["projection"] = uniform(spec["n_relations"], d * rd)
    if init == "identity":
        eye = torch.eye(d, rd, device=device).reshape(-1)
        out["projection"].mul_(0.1).add_(eye)
    return out


def graph_train(cell: Cell) -> np.ndarray:
    from kgebench.graph import train_triplets

    return train_triplets(cell.config["dataset"])


def kge_config(spec: dict):
    """The port's ``KGEConfig`` for the spec."""
    from repro_torch.common.config import KGEConfig

    return KGEConfig(
        name="kgebench", model=spec["model"], n_entities=spec["n_entities"],
        n_relations=spec["n_relations"], dim=spec["dim"], rel_dim=spec["rel_dim"],
        loss=spec["loss"], gamma=spec["gamma"], batch_size=spec["batch_size"],
        neg_sample_size=spec["neg_sample_size"],
        neg_group_size=spec["neg_group_size"], neg_deg_ratio=spec["neg_deg_ratio"],
        overlap_update=spec["overlap_update"], lr=spec["lr"])


# --------------------------------------------------------------------------
# the device's clock, or the host's where the run is on the CPU (tests)
class _HostEvent:
    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class Clock:
    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.torch = torch

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def event(self):
        return (self.torch.cuda.Event(enable_timing=True) if self.cuda
                else _HostEvent())


# --------------------------------------------------------------------------
class Program:
    """The port, set up for one seed: tables, state, sampler, step."""

    def __init__(self, spec: dict, train: np.ndarray, seed: int, device):
        import torch
        from repro_torch.core import kge_model as K
        from repro_torch.core.sampling import JointSampler

        self.K, self.spec, self.seed, self.device = K, spec, seed, device
        self.cfg = cfg = kge_config(spec)
        t = draw_tables(spec, seed, device)
        arrays = {"entity": t["entity"], "r_emb": t["relation"],
                  "r_proj": t.get("projection")}
        if cfg.overlap_update:  # T5 buffers, as init_state(overlap=True)
            slots = K.ent_workspace_slots(cfg)
            arrays["pend_ids"] = torch.full((slots,), -1, dtype=torch.int32,
                                            device=device)
            arrays["pend_grads"] = torch.zeros((slots, cfg.dim), device=device)
        self.state = K.state_from_arrays(cfg, arrays, device)
        self.sampler = JointSampler(train, cfg.n_entities, cfg,
                                    np.random.default_rng(seed))
        self.step = functools.partial(K.train_step, cfg)
        self.batches: list = []  # host batches, in the order steps took them

    def make_batch(self):
        batch = self.sampler.sample()
        self.batches.append(batch)
        return self.K.batch_to_device(batch, self.device), None

    def loop(self, n: int, hooks, step=None):
        """``n`` steps of ``engine.train_loop``; ``batches`` then ends with
        the ``n`` this loop stepped (its prefetcher's leftovers dropped)."""
        from repro_torch.launch.engine import train_loop

        first = len(self.batches)
        self.state = train_loop(step or self.step, self.state, self.make_batch, n,
                                hooks=hooks)
        del self.batches[first + n:]

    def tables(self) -> dict:
        s = self.state
        out = {"entity": s.entity, "relation": s.r_emb, "projection": s.r_proj}
        return {k: v for k, v in out.items() if v is not None}


class CheckHook:
    """Reads the program over its first ``n`` steps: each step's loss, each
    table's first gradient as the optimizer got it (the square root of its
    Adagrad accumulator once that gradient landed: after step 1, the
    entity table's after step 2 when T5 defers it) and each table's change
    after step ``n`` and the port's ``flush_state``, which applies step
    ``n``'s deferred entity gradient (T5) as the end of a run does; step
    ``n + 1`` then starts from the flushed state with nothing pending."""

    def __init__(self, prog: Program, n: int):
        self.prog, self.n = prog, n
        self.losses, self.grad_sq, self.change = [], {}, {}

    def on_step(self, i, state, metrics, stats):
        import torch

        if i <= self.n:
            self.losses.append(metrics["loss"].detach())
        gsq = {"entity": state.ent_gsq, "relation": state.rel_gsq,
               "projection": state.proj_gsq}
        deferred = state.pend_ids is not None  # T5: entity grads land a step late
        landed = {1: ["relation", "projection"] + ([] if deferred else ["entity"]),
                  2: ["entity"] if deferred else []}
        for name in landed.get(i, ()):
            if gsq[name] is not None:
                self.grad_sq[name] = gsq[name].sum(dtype=torch.float64)
        if i == self.n:
            self.prog.K.flush_state(self.prog.cfg, state)
            t0 = draw_tables(self.prog.spec, self.prog.seed, self.prog.device)
            for name, table in self.prog.tables().items():
                self.change[name] = torch.linalg.vector_norm(
                    table - t0[name], dtype=torch.float64)
            del t0

    def on_end(self, i, state):
        return None

    def readings(self) -> dict:
        return {"losses": [float(v) for v in self.losses],
                "grad_norms": {k: math.sqrt(float(v)) for k, v in self.grad_sq.items()},
                "change_norms": {k: float(v) for k, v in self.change.items()}}


class RateHook:
    """The synchronised host time of steps ``a+1..b``, a step."""

    def __init__(self, clock: Clock, a: int, b: int):
        self.clock, self.a, self.b = clock, a, b
        self.step_s = None

    def on_step(self, i, state, metrics, stats):
        if i == self.a:
            self.clock.sync()
            self.t0 = time.perf_counter()
        elif i == self.b:
            self.clock.sync()
            self.step_s = (time.perf_counter() - self.t0) / (self.b - self.a)

    def on_end(self, i, state):
        return None


class WindowHook:
    """The measured window: a device sync after step 1 and after step ``n``,
    a CUDA event at every step boundary; then the next ``traced`` (> 0)
    steps under torch.profiler (the device's activity alone), and the port's
    registry's counters read at the syncs that bound them."""

    def __init__(self, clock: Clock, n: int, traced: int):
        self.clock, self.n, self.traced = clock, n, traced
        self.events = [clock.event() for _ in range(n)]
        self.losses = []
        self.prof = None
        self.counts: List[Dict[str, float]] = []  # at the traced slice's syncs

    def on_step(self, i, state, metrics, stats):
        if i <= self.n:
            self.events[i - 1].record()
            if i > 1:
                self.losses.append(metrics["loss"].detach())
        if i == 1:
            self.clock.sync()
            self.t0 = time.perf_counter()
        elif i == self.n:
            self.clock.sync()
            self.t1 = time.perf_counter()
            from torch.profiler import ProfilerActivity, profile

            self.counts.append(_counters())

            # the device's activity alone: tracing the host's ops too slows
            # the host, which paces RESCAL's step, and shows as device idle
            # time the untraced window does not have
            acts = [ProfilerActivity.CUDA if self.clock.cuda
                    else ProfilerActivity.CPU]
            self.prof = profile(activities=acts)
            self.prof.start()
            self.tp0 = time.perf_counter()
        elif i == self.n + self.traced:
            self.clock.sync()
            self.tp1 = time.perf_counter()
            self.counts.append(_counters())
            self.prof.stop()

    def on_end(self, i, state):
        return None

    def step_ms(self) -> List[float]:
        """The device timeline between consecutive step boundaries."""
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]

    def slice_counters(self) -> Dict[str, float]:
        """Each registry counter's increase over the traced steps."""
        a, b = self.counts
        return {k: v - a.get(k, 0.0) for k, v in b.items()}


def _counters() -> Dict[str, float]:
    from repro_torch.common import telemetry

    return telemetry.get_registry().snapshot()["counters"]


@dataclasses.dataclass
class Record:
    """What the metric readers read (``metrics/<name>.py``)."""

    spec: dict
    setup_s: float
    window_s: float  # host clock, device sync to device sync
    steps: int  # steps in the window
    step_ms: List[float]  # each window step on the device's timeline
    batches: list  # the window steps' host batches
    call_s: List[float] = dataclasses.field(default_factory=list)  # host clock
    return_s: List[float] = dataclasses.field(default_factory=list)
    sample_s: List[float] = dataclasses.field(default_factory=list)  # spans
    trace: Optional[object] = None  # trace.Trace of the steps after the window
    traced_batches: list = dataclasses.field(default_factory=list)
    rates: Optional[Dict[str, float]] = None  # the card's data-sheet rates
    # the port's spans (spans.Span) that overlap the traced steps, on the
    # profiler's timebase, and each registry counter's increase over them
    spans: Optional[list] = None
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    # spans.Attribution of the traced steps; None where the trace holds no
    # device op or the registry lost spans
    phases: Optional[object] = None


# --------------------------------------------------------------------------
def compare(got: dict, want: dict) -> Dict[str, float]:
    """The gaps between the program's readings and the reference's: the
    largest relative gap of a step's loss; by the worst table, the gap of
    the first gradient's norm and of the change's norm, against the
    reference's norm of that table or of the median table, the larger.
    Tables whose reference gradient is under a thousandth of the median
    table's (RESCAL's relation table, which its score never reads) are
    left out."""
    loss = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
    rg = want["grad_norms"]
    med_g = statistics.median(rg.values())
    tables = [n for n in rg if rg[n] >= 1e-3 * med_g]

    def worst(key):
        ref = want[key]
        med = statistics.median(ref[n] for n in tables)
        return max(abs(got[key][n] - ref[n]) / max(ref[n], med) for n in tables)

    return {"loss": loss, "grad_norm": worst("grad_norms"),
            "param_change": worst("change_norms")}


def judge(got: dict, want: dict, got_batches: list, want_batches: list,
          failed: int, limits: Dict[str, float]):
    """``correct`` and each number compared beside its limit: the gaps of
    ``compare``, the batches' ids that differ, and the window's losses that
    are not finite."""
    gaps = compare(got, want)
    gaps["batch_ids"] = batch_id_diff(got_batches, want_batches)
    gaps["nonfinite_loss"] = failed
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in CHECKED}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def batch_id_diff(got: list, want: list) -> int:
    """Ids that differ between two lists of batches."""
    n = 0
    for a, b in zip(got, want):
        for f in ("h", "r", "t", "neg"):
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            n += int(x.size) if x.shape != y.shape else int((x != y).sum())
    return n + abs(len(got) - len(want))


def reference_readings(cell: Cell, train: np.ndarray, seed: int, device,
                       tf32: bool = False, fault: Optional[str] = None):
    """The reference's first steps from the seed: (readings, its batches);
    with ``tf32``, the control: its products in TF32."""
    import torch

    from kgebench.reference import train as ref_train
    from kgebench.sampler import JointSampler

    spec = cell.spec
    ng = spec["batch_size"] // spec["neg_group_size"]
    sampler = JointSampler(train, spec["n_entities"], spec["batch_size"],
                           spec["neg_sample_size"], ng, spec["neg_deg_ratio"],
                           np.random.default_rng(seed))
    batches = [sampler.sample() for _ in range(cell.workload["check_steps"])]
    on_dev = [tuple(torch.from_numpy(np.asarray(x)).to(device) for x in bt)
              for bt in batches]
    model = load_module(cell.bench / "reference" / f"{spec['model']}.py")
    out = ref_train.run(model.scores, spec, draw_tables(spec, seed, device), on_dev,
                        tf32=tf32, fault=fault)
    return out, batches


def set_precision(config: dict):
    """The configuration's precision: float32, and TF32 as it states."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])


def program_check(cell: Cell, prog: Program, clock: Clock):
    """Set-up's steps: the check steps, then the warm-up; returns the
    check's readings and the warm-up's seconds a step."""
    w = cell.workload
    n_check, n_warm = w["check_steps"], w["warmup_steps"]
    check = CheckHook(prog, n_check)
    rate = RateHook(clock, n_check + n_warm // 2, n_check + n_warm)
    prog.loop(n_check + n_warm, hooks=[check, rate])
    return check.readings(), rate.step_s


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, window_steps: Optional[int] = None,
             log: Callable[[str], None] = lambda s: None) -> dict:
    """One run; returns the result line's object. ``window_steps`` fixes the
    window's steps (tests) instead of sizing it to ``seconds``."""
    import torch

    from repro_torch.common import telemetry
    from repro_torch.core.kge_model import flush_state

    from kgebench import cost as C
    from kgebench import spans as S
    from kgebench import trace as T

    set_precision(cell.config)
    clock = Clock(device)
    if clock.cuda:
        from repro_torch.kernels import build

        build.build(cell.workload["kernels"])
        log("kernels built or loaded")
    train = graph_train(cell)
    log("graph generated or loaded")
    spec = cell.spec
    prog = Program(spec, train, seed, device)
    log("tables drawn")
    got, step_s = program_check(cell, prog, clock)
    check_batches = prog.batches[:cell.workload["check_steps"]]
    log(f"set-up steps done; warm step {step_s * 1e3:.3f} ms")

    # every run profiles the device over the steps after the window, which
    # step_device_ms reads; --trace 1 adds the port's spans and counters
    traced = cell.workload["traced_steps"]
    n = window_steps or max(cell.workload["min_window_steps"],
                            math.ceil(seconds / step_s)) + 1
    window = WindowHook(clock, n, traced)
    calls, rets = [], []
    step = prog.step
    if trace:
        def step(state, batch, _step=prog.step):
            calls.append(time.perf_counter())
            out = _step(state, batch)
            rets.append(time.perf_counter())
            return out
        prev = telemetry.set_registry(telemetry.MetricsRegistry(enabled=True,
                                                                trace=True))
    first = len(prog.batches)
    try:
        prog.loop(n + traced, hooks=[window], step=step)
    finally:
        if trace:
            reg = telemetry.set_registry(prev)
    flush_state(prog.cfg, prog.state)
    clock.sync()
    peak = int(torch.cuda.max_memory_allocated(device)) if clock.cuda else 0
    losses = torch.stack(window.losses)
    failed = int((~torch.isfinite(losses)).sum())
    batches = [(b.h, b.r, b.t, b.neg) for b in prog.batches[first:]]
    rec = Record(spec=spec, setup_s=window.t0 - t_start,
                 window_s=window.t1 - window.t0, steps=n - 1,
                 step_ms=window.step_ms(), batches=batches[1:n])
    rec.trace = T.from_profiler(window.prof, traced, window.tp1 - window.tp0)
    if trace:
        rec.call_s, rec.return_s = calls[1:n], rets[1:n]
        doc = reg.trace_json()
        samples = sorted((e for e in doc["traceEvents"]
                          if e.get("ph") == "X" and e["name"] == "pipeline/sample"),
                         key=lambda e: e["ts"])
        rec.sample_s = [e["dur"] / 1e6 for e in samples[1:n]]
        rec.counters = window.slice_counters()
        rec.spans, att = S.slice_attribution(
            S.from_profiler(window.prof), doc, window.tp0, window.tp1,
            window.counts[1].get(S.DROPPED, 0.0))
        rec.phases = att if rec.trace.device else None
        rec.traced_batches = batches[n - 1:n + traced]
        rec.rates = (C.peaks(torch.cuda.get_device_name(device)) if clock.cuda
                     else None)
    log(f"window: {n - 1} steps in {rec.window_s:.3f} s")

    # the program's state goes before the reference runs
    del prog, window, losses, step
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()

    want, ref_batches = reference_readings(cell, train, seed, device)
    log("reference done")
    correct, checks = judge(got, want, check_batches, ref_batches, failed,
                            cell.workload["limits"])

    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        v = load_module(cell.bench / "metrics" / f"{m['name']}.py").read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if clock.cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if clock.cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": n - 1, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        busy = T.busy_us(rec.trace.device) / 1e6
        dev["busy_s"], dev["window_s"] = busy, rec.trace.window_s
        out["breakdown"] = {"device_ops": T.top_ops(rec.trace.device),
                            "idle_gaps": T.idle_gaps(rec.trace)}
    out["checks"] = checks
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unknown ({exc})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
