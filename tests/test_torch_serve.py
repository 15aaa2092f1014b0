"""The port's serve driver (launch/serve.py, engine.run_loop,
ThroughputHook) against the JAX package's serve loop on the reduced
Qwen1.5-0.5B and Mamba2-2.7B in their config dtype, and on the reduced
Mixtral-8x7B and Jamba-1.5-Large (MoE, the dense route of JAX's serve) and
MiniCPM3-4B (MLA, the absorbed decode) in f32, from JAX's weights."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models.transformer import build_model as jax_build
from repro_torch.configs import ARCHS
from repro_torch.kernels import build
from repro_torch.launch import engine, serve
from repro_torch.models.transformer import build_model, params_from_arrays

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-3  # logits; a greedy token is compared where its top-2 gap exceeds it


def _jax_serve_loop(jm, jp, tokens, gen):
    """The loop of the JAX package's launch/serve.py main(), with given
    weights: the prompt token by token, then greedy tokens."""
    B, T = tokens.shape
    caches = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype),
                          jm.cache_defs(B, T + gen),
                          is_leaf=lambda x: hasattr(x, "materialize"))
    dec = jax.jit(jm.decode_step)
    out, logs, logits = [], [], None
    for i in range(T + gen):
        if i < T:
            tok = jnp.asarray(tokens[:, i:i + 1], jnp.int32)
        else:
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
            out.append(np.asarray(tok))
        logits, caches = dec(jp, caches, tok, jnp.asarray(i, jnp.int32))
        logs.append(np.asarray(logits[:, 0], np.float32))
    return np.concatenate(out, axis=1), logs


def _serve_loop_matches_jax(arch, tol=TOL, **kw):
    """Teacher-forced logits within ``tol``; the greedy tokens equal up to
    the first near-tie (a top-2 gap within ``tol``). ``kw`` overrides fields
    of both reduced configs."""
    jm = jax_build(dataclasses.replace(JAX_ARCHS[arch].reduced(), **kw))
    m = build_model(dataclasses.replace(ARCHS[arch].reduced(), **kw))
    jp = jm.init(jax.random.key(0))
    params = m.cast(params_from_arrays(m, jax.tree.map(np.asarray, jp)))
    B, T, gen = 2, 8, 6
    tokens = np.random.default_rng(0).integers(0, m.cfg.vocab_size, (B, T))
    want, want_logits = _jax_serve_loop(jm, jp, tokens, gen)
    before = dict(build.LAUNCHES)
    got, logits = serve.generate(m, params, tokens, gen)
    assert build.LAUNCHES == before  # decode launches no kernel
    assert got.shape == (B, gen) and len(logits) == T + gen
    for i in range(T):  # teacher-forced: the same inputs in both
        np.testing.assert_allclose(logits[i][:, 0].float().numpy(), want_logits[i],
                                   rtol=tol, atol=tol)
    for b in range(B):
        for t in range(gen):
            top2 = np.sort(want_logits[T - 1 + t][b])[-2:]
            if top2[1] - top2[0] <= tol:
                break  # a near-tie: the two may pick either, and then diverge
            assert got[b, t] == want[b, t], (b, t)


def test_serve_loop_matches_jax():
    _serve_loop_matches_jax("qwen1.5-0.5b")


def test_serve_loop_matches_jax_mamba():
    """Mamba2's recurrence (conv windows, SSM state), in f32, within 2e-3."""
    _serve_loop_matches_jax("mamba2-2.7b", dtype="float32")


def test_serve_loop_matches_jax_mamba_bf16():
    """The same in the config's dtype, bf16, as the CLI serves it. The two
    packages' teacher-forced logits differ by 4.6e-3 to 7.2e-3 here
    (max|logit| 1.36), about as much as JAX's own jitted and eager loops
    differ from each other (2.4e-3 to 5.3e-3): bf16 rounding in a different
    order, so the bound is 1.5e-2, about 3x the typical gap."""
    _serve_loop_matches_jax("mamba2-2.7b", tol=1.5e-2)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b"])
def test_serve_loop_matches_jax_moe(arch):
    """Decode through the MoE layers (every expert on every token, as JAX's
    serve without a mesh), Mixtral's SWA ring and Jamba's Mamba2 state, in
    f32, within 2e-3."""
    _serve_loop_matches_jax(arch, dtype="float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_loop_matches_jax_mla(dtype):
    """MiniCPM3's absorbed decode through the serve loop: in f32 within
    2e-3; in the config's dtype, bf16 (the reduced config's 1-D norms keep
    their input's type, so every product rounds to bf16), within 5e-2, the
    bf16 bound of tests/test_torch_{flash_attention,mla}.py: the logits
    near 4 differ by up to 1.5 of their bf16 steps (0.0234), bf16
    rounding in another order, as in the bf16 Mamba2 case."""
    _serve_loop_matches_jax("minicpm3-4b", tol=TOL if dtype == "float32" else 5e-2,
                            dtype=dtype)


def test_serve_cli_on_cpu_minicpm3():
    """``python -m repro_torch.launch.serve --arch minicpm3-4b --device cpu``
    as README gives it: the reduced MiniCPM3 in bf16, MLA decode."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "minicpm3-4b", "--batch", "2", "--prompt-len", "8", "--gen", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("12 steps in ") and lines[0].endswith(" tok/s")
    assert lines[1] == "arch=minicpm3-4b reduced=True batch=2"
    rows = [ln.strip(" []").split() for ln in lines[3:5]]
    assert [len(r) for r in rows] == [4, 4]


def test_serve_cli_on_cpu_mixtral():
    """``python -m repro_torch.launch.serve --arch mixtral-8x7b --device cpu``
    as README gives it: the reduced Mixtral in bf16."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "mixtral-8x7b", "--batch", "2", "--prompt-len", "8", "--gen", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("12 steps in ") and lines[0].endswith(" tok/s")
    assert lines[1] == "arch=mixtral-8x7b reduced=True batch=2"
    rows = [ln.strip(" []").split() for ln in lines[3:5]]
    assert [len(r) for r in rows] == [4, 4]


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen1.5-0.5b", "--batch", "2", "--prompt-len", "8", "--gen", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("12 steps in ") and lines[0].endswith(" tok/s")
    assert lines[1] == "arch=qwen1.5-0.5b reduced=True batch=2"
    assert lines[2] == "generated tokens:"
    rows = [ln.strip(" []").split() for ln in lines[3:5]]
    assert [len(r) for r in rows] == [4, 4]


def test_serve_cli_on_cpu_mamba():
    """The reduced Mamba2 through the CLI, as README gives the command."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "mamba2-2.7b", "--batch", "2", "--prompt-len", "8", "--gen", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("12 steps in ") and lines[0].endswith(" tok/s")
    assert lines[1] == "arch=mamba2-2.7b reduced=True batch=2"
    rows = [ln.strip(" []").split() for ln in lines[3:5]]
    assert [len(r) for r in rows] == [4, 4]


def test_serve_main_on_danube(capsys):
    """GQA with a ring cache through the CLI's function: the generated ids
    are tokens of the padded vocab and every step's logits are finite."""
    gen, logits = serve.main(["--device", "cpu", "--arch", "h2o-danube-1.8b",
                              "--batch", "3", "--prompt-len", "5", "--gen", "3"])
    assert gen.shape == (3, 3) and gen.min() >= 0 and gen.max() < 1024
    assert all(bool(torch.isfinite(lg.float()).all()) for lg in logits)
    assert "arch=h2o-danube-1.8b reduced=True batch=3" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--metrics-out", "--trace-out"])
def test_serve_refuses_unported_flags(flag, tmp_path, monkeypatch, capsys):
    """Once refused (the telemetry files were not ported), each flag now
    writes its file as JAX's serve does: a TelemetryHook every 16 steps
    after the ThroughputHook. The file passes both packages' validators,
    and a metrics file holds as many snapshots as JAX's serve writes at the
    same --prompt-len/--gen; the registry is restored after the run."""
    from repro.common import telemetry as jax_telemetry
    from repro.launch import serve as jax_serve
    from repro_torch.common import telemetry

    args = ["--arch", "qwen1.5-0.5b", "--batch", "2", "--prompt-len", "12",
            "--gen", "8"]
    path = tmp_path / ("m.jsonl" if flag == "--metrics-out" else "t.json")
    serve.main(["--device", "cpu", *args, flag, str(path)])
    assert not telemetry.get_registry().enabled
    if flag == "--trace-out":
        for mod in (telemetry, jax_telemetry):
            assert mod.validate_trace(str(path)) > 0
        return
    n = [mod.validate_metrics_jsonl(str(path), require=("engine/steps",))
         for mod in (telemetry, jax_telemetry)]
    last = json.loads(path.read_text().splitlines()[-1])
    assert last["step"] == 20 and last["counters"]["engine/steps"] == 20
    jax_path = tmp_path / "jax_m.jsonl"
    monkeypatch.setattr(sys, "argv", ["serve", *args, flag, str(jax_path)])
    prev = jax_telemetry.get_registry()
    try:
        jax_serve.main()
    finally:
        jax_telemetry.set_registry(prev)  # JAX's serve enables it for good
    assert n == [jax_telemetry.validate_metrics_jsonl(str(jax_path))] * 2 == [2, 2]
    capsys.readouterr()


def test_serve_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--batch", "1", "--prompt-len", "2", "--gen", "1"])


def test_run_loop_and_throughput_hook():
    lines, seen = [], []

    class Seen(engine.Hook):
        def on_step(self, i, state, metrics, stats):
            seen.append((i, state, metrics, stats))

        def on_end(self, i, state):
            seen.append(("end", i, state))

    out = engine.run_loop(lambda i, s: (s + [i], {"i": i}), [], 3,
                          hooks=[Seen(), engine.ThroughputHook(4, "tok", lines.append)])
    assert out == [0, 1, 2]
    assert [s[0] for s in seen] == [1, 2, 3, "end"] and seen[-1][1] == 3
    assert seen[0] == (1, [0], {"i": 0}, None)  # i is 0-based in the step
    assert len(lines) == 1 and lines[0].startswith("3 steps in ")
    assert lines[0].endswith(" tok/s")
