"""Train a (reduced) architecture of the LM zoo end to end on a synthetic
token stream with planted bigram structure; the loss must drop below the
uniform floor. The twin of examples/train_lm_smoke.py: the same stream,
reduced config (vocab 64, one microbatch), learning rates and assertion,
through the port's ``build_train_step``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_smoke \\
        --arch h2o-danube-1.8b [--device cpu]
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

_PROBS = {}


def bigram_stream(vocab: int, batch: int, seq: int, rng, sharp: float = 8.0):
    """Markov chain with a sharp planted transition matrix (low entropy)."""
    if vocab not in _PROBS:
        g = np.random.default_rng(1234)
        logits = g.standard_normal((vocab, vocab)) * sharp
        p = np.exp(logits - logits.max(1, keepdims=True))
        _PROBS[vocab] = np.cumsum(p / p.sum(1, keepdims=True), axis=1)
    cum = _PROBS[vocab]
    out = np.empty((batch, seq), np.int64)
    out[:, 0] = rng.integers(0, vocab, batch)
    for t in range(1, seq):
        u = rng.random(batch)
        rowcum = cum[out[:, t - 1]]
        out[:, t] = (u[:, None] > rowcum).sum(1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm_smoke")
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.common.device import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.models.steps import build_train_step
    from repro_torch.models.transformer import build_model

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_arch(args.arch).reduced(), vocab_size=64,
                              microbatches=1)
    if args.lr == 0.0:
        # SSM/hybrid dynamics want a gentler rate (dt/A recurrence)
        args.lr = 3e-3 if cfg.mixer_pattern in ("mamba", "jamba") else 1e-2
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, device=dev)
    step, opt = build_train_step(model, lr=args.lr)
    opt_state = opt.init(params)

    rng = np.random.default_rng(0)
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        toks = torch.from_numpy(bigram_stream(64, 8, 32, rng)).to(dev, torch.int32)
        batch = {"tokens": toks, "labels": toks}
        if cfg.frontend.value == "vision":
            batch["patch_embeds"] = torch.zeros(
                (8, min(cfg.n_frontend_tokens, 32), cfg.d_model), device=dev)
        if cfg.enc_dec:
            batch["enc_frames"] = torch.zeros((8, cfg.encoder_ctx, cfg.d_model),
                                              device=dev)
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if (i + 1) % 20 == 0:
            print(f"step {i+1:4d} loss {losses[-1]:.4f} "
                  f"({(i+1)/(time.time()-t0):.1f} steps/s)")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(uniform={np.log(64):.3f})")
    assert losses[-1] < np.log(64) - 0.5, "should beat the uniform floor"
    print("OK")
    return losses


if __name__ == "__main__":
    main()
