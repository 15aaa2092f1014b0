"""The port's example twins (``python -m repro_torch.examples.<name>``) on
the CPU at their smallest flags, and the H100 spec the bounds read.

Each twin keeps its original's own check: the quickstart's filtered MRR
above 0.2 after its 900 steps, METIS cutting fewer edges than random in
``distributed_kge`` (8 gloo ranks, two samplers each), and the CLIs'
exit codes for ``train_fb15k_scale`` and ``serve_lm``, and
``train_lm_smoke``'s last loss below ln 64 - 0.5 after its 150 steps of
the reduced H2O-Danube-1.8B on the planted bigram stream.
"""

import importlib.util
import math
from pathlib import Path

import torch

from repro.common.hw import HwSpec as JaxHwSpec
from repro_torch.common.hw import H100_SXM, HwSpec
from repro_torch.examples import (
    distributed_kge, quickstart, serve_lm, train_fb15k_scale, train_lm_smoke,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_learns_the_planted_structure(capsys):
    met = quickstart.main(["--device", "cpu"])
    assert met.mrr > 0.2
    assert capsys.readouterr().out.strip().endswith("OK")


def test_distributed_kge_metis_cuts_less_than_random(capsys):
    results = distributed_kge.main(["--device", "cpu", "--steps", "8"])
    (cm, lm, _, _), (cr, lr, _, _) = results["metis"], results["random"]
    assert cm < cr
    assert len(lm) == len(lr) == 8 and lm[-1] < lm[0] and lr[-1] < lr[0]
    assert "OK — min-cut partitioning" in capsys.readouterr().out


def test_train_fb15k_scale_runs_the_cli(capfd):
    train_fb15k_scale.main(["--device", "cpu", "--steps", "4", "--scale", "0.02"])
    out = capfd.readouterr().out
    assert "-m repro_torch.launch.train --dataset fb15k" in out
    assert "; device cpu" in out and "eval: MRR" in out


def test_serve_lm_runs_the_cli(capfd):
    serve_lm.main(["--device", "cpu", "--arch", "qwen1.5-0.5b"])
    out = capfd.readouterr().out
    assert "arch=qwen1.5-0.5b reduced=True batch=4" in out
    assert "24 steps in " in out


def test_train_lm_smoke_beats_the_uniform_floor(capsys):
    losses = train_lm_smoke.main(["--device", "cpu"])
    assert len(losses) == 150 and losses[-1] < math.log(64) - 0.5 < losses[0]
    assert capsys.readouterr().out.strip().endswith("OK")


def test_hw_spec_holds_the_rates_the_bounds_use():
    """The H100 SXM's data-sheet rates, as PERF.md's bounds took them, and
    the ones ``chip_smoke.py`` reads; the reference's field names where they
    mean the same."""
    assert (H100_SXM.hbm_bandwidth, H100_SXM.peak_fp32_flops, H100_SXM.peak_tf32_flops,
            H100_SXM.peak_bf16_flops) == (3.35e12, 67e12, 494.7e12, 989e12)
    assert (H100_SXM.hbm_bytes, H100_SXM.sm_count) == (80 * 1024**3, 132)
    shared = set(JaxHwSpec.__dataclass_fields__) & set(HwSpec.__dataclass_fields__)
    assert shared == {"name", "peak_bf16_flops", "hbm_bandwidth", "hbm_bytes"}

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # imports the standard library only
    assert smoke.load_rates() == dict(
        HBM_BYTES_PER_S=3.35e12, FP32_OPS_PER_S=67e12,
        TF32X3_OPS_PER_S=494.7e12 / 3, BF16_OPS_PER_S=989e12)
    # 1 GB at the HBM rate against 1 TFLOP at fp32's
    assert smoke.bound(1e9, 1e12) == (1e12 / 67e12 * 1e3, "operations")
    assert smoke.bound(1e12, 1e9) == (1e12 / 3.35e12 * 1e3, "bytes")
