"""LM serving driver of the port: batched greedy decoding for an ``--arch``
of the zoo, reduced or full.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --full --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
        --full --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --metrics-out build/serve_m.jsonl --trace-out build/serve_t.json

A port of the JAX package's launch/serve.py: the prompt goes in token by
token through ``build_serve_step`` to fill the decode caches (the KV
caches of attention layers; the conv windows and SSM state of Mamba2
layers), then ``--gen`` tokens are greedy-decoded, through ``run_loop``
and ``ThroughputHook`` (and, with ``--metrics-out``/``--trace-out``, a
``TelemetryHook`` that writes a JSONL snapshot every 16 steps and at the
end, and the Chrome trace, as the JAX driver does). The prompts are
``np.random.default_rng(seed).integers(0, vocab, (B, T))``, as the JAX
package makes them; the weights are drawn from a
``torch.Generator`` seeded with ``--seed``. Without ``--full`` the reduced
config runs. ``--device`` defaults to cuda and raises without a GPU;
``--device cpu`` runs the same code on the CPU. This path launches no
kernel of the port: decode attention and the Mamba2 recurrence are plain
PyTorch, as they are plain jnp in JAX. Batched prefill is
``models.steps.build_prefill_step(model, use_flash=True)``, through the
flash kernel (attention) and the ssd_scan kernel (Mamba2); Whisper's
prefill also takes ``enc_frames`` and LLaVA's ``patch_embeds``.
"""

from __future__ import annotations

import argparse
from typing import List, Sequence, Tuple

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true", help="full (not reduced) config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--metrics-out", default="",
                    help="write JSONL telemetry snapshots here "
                         "(schema: docs/TELEMETRY.md)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON here (Perfetto)")
    return ap


def generate(model, params, tokens: np.ndarray, gen: int, hooks: Sequence = ()
             ) -> Tuple[np.ndarray, List[torch.Tensor]]:
    """Feed ``tokens`` (B, T) one position a step, then greedy-decode
    ``gen`` tokens. Returns the generated ids (B, gen) and the logits of
    every step (T + gen tensors of (B, 1, padded_vocab); step i's are the
    next-token logits after position i). The argmax runs over the padded
    vocab, as in JAX. ``params`` may be the model's cast copy.

    Whisper's cross caches (``xk``/``xv``) stay zero, so its decoder
    cross-attends to zero keys and values: a copy of JAX's serve, which
    never fills them (it has no encoder input). LLaVA is fed tokens only,
    as JAX's serve feeds it."""
    from repro_torch.launch.engine import run_loop
    from repro_torch.models.steps import build_serve_step

    B, T = tokens.shape
    dev = params["tok_emb"].device
    prompt = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    caches = model.init_caches(B, T + gen, device=dev)
    serve = build_serve_step(model)
    out, step_logits = [], []

    def step(i, carry):
        logits, caches = carry
        if i < T:
            tok = prompt[:, i:i + 1]
        else:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(tok.cpu().numpy())  # the host reads each new token
        logits, caches = serve(params, caches, tok, i)
        step_logits.append(logits)
        return (logits, caches), {}

    run_loop(step, (None, caches), T + gen, hooks=hooks)
    generated = np.concatenate(out, axis=1) if out else np.zeros((B, 0), np.int64)
    return generated, step_logits


def serve(args):
    """Returns the generated ids and the logits of every step. With
    ``--metrics-out`` or ``--trace-out`` an enabled telemetry registry is
    installed for the run and the previous one restored after it."""
    from repro_torch.common import telemetry

    if not (args.metrics_out or args.trace_out):
        return _serve(args)
    prev = telemetry.set_registry(
        telemetry.MetricsRegistry(enabled=True, trace=bool(args.trace_out)))
    try:
        return _serve(args)
    finally:
        telemetry.set_registry(prev)


def _serve(args):
    from repro_torch.common.device import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.launch.engine import TelemetryHook, ThroughputHook
    from repro_torch.models.transformer import build_model

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg)
    # cast once at load; the f32 draw is not kept
    params = model.cast(model.init(torch.Generator().manual_seed(args.seed),
                                   device=dev))
    rng = np.random.default_rng(args.seed)
    B, T = args.batch, args.prompt_len
    tokens = rng.integers(0, cfg.vocab_size, (B, T))

    hooks = [ThroughputHook(items_per_step=B, label="tok")]
    if args.metrics_out or args.trace_out:
        hooks.append(TelemetryHook(metrics_out=args.metrics_out or None,
                                   trace_out=args.trace_out or None, every=16))
    gen, logits = generate(model, params, tokens, args.gen, hooks=hooks)
    print(f"arch={cfg.name} reduced={not args.full} batch={B}")
    print(f"generated tokens:\n{gen}")
    if not bool(torch.isfinite(logits[-1]).all()):
        raise RuntimeError("non-finite logits")
    return gen, logits


def main(argv=None):
    return serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
