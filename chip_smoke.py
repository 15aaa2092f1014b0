#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. environment: the card's name and power limit, torch, capability (9, 0);
  2. build: every CUDA kernel of the port, compiled from csrc/ in parallel;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main paths' shapes and ragged ones (the l1 pairwise forward also at
     eval's 512 x 14,951 x 400, called twice for the same bits, with the
     tile each launch plans; the l1 backward's
     products alone and as the pair the path asks for, each called twice
     for the same bits, with the tile height and split each launch plans;
     flash attention at Qwen1.5-0.5B's prefill in bf16 and f32,
     H2O-Danube-1.8B's GQA and window, a ragged and a decode-like shape in
     f32 and in bf16, with SDPA's own error beside
     the kernel's; the SSD scan at Mamba2-2.7B's prefill, a long
     sequence, a ragged T, T = 1 and Jamba-1.5-Large's 1 x 4096 x 256
     heads, also against the step-by-step ``ssd_ref``; flash also at
     Mixtral-8x7B's 1 x 32 x 8 x 8192 x 128 in bf16 with its window of
     4096, DBRX's 1 x 48 x 8 x 4096 x 128, Jamba's 1 x 64 x 8 x 4096 x
     128, Whisper-large-v3's decoder self-attention 4 x 20 x 20 x 448 x 64
     and LLaVA-NeXT-Mistral-7B's prefill 2 x 32 x 8 x 4096 x 128; dedup
     and the update also at phase 13's shapes, the
     5,632-slot T5 flush and the 1,280-slot relation apply), with its
     time, the plain version's time, one PyTorch
     library call's time as a yardstick where one computes the same
     function, and the least time the card could take for the same work
     (bound);
  4. agreement: three dim-400 training steps at batch 256 and k 64 on a
     small synthetic graph, on the card (kernels) and on the CPU (plain
     versions), from the same tables and batches, for TransE_l2, TransE_l1,
     DistMult and RESCAL (whose relation rows, which its score never reads,
     must come out unchanged; at lr 0.05, because at FB15k's 0.25 two CPU
     runs that differ only in the rounding of the dedup sums already part
     in more entries than the rule allows, which the phase checks and
     prints beside the card's share with the kernels and with the plain
     pairwise product); and (1, 256) prefills of Qwen1.5-0.5B (flash) and
     Mamba2-2.7B (ssd_scan) at full width cut to 2 layers, in f32, on the
     card and on the CPU from the same weights (logits within 2e-3);
     the reduced Mixtral-8x7B, DBRX and Jamba-1.5-Large in f32, (1, 256)
     flash prefills on the card and on the CPU, then their MoE layers'
     capacity-bounded route at factor 0.5 in a 1x1 NCCL world on the card
     and a 1x1 gloo world on the CPU, under the routing rule below;
     MiniCPM3-4B at full width cut to 2 layers in f32, a (1, 256) prefill
     on the card and on the CPU (logits within 2e-3 x max(1, max|logit|),
     no kernel launch), and the card's absorbed decode of the first 32
     tokens against its prefill under the same bound; Whisper-large-v3 at
     full width cut to 2 encoder and 2 decoder layers in f32, a prefill on
     (2, 64) tokens and (2, 1500, 1280) frames on the card and on the CPU,
     then 8 teacher-forced decode steps on cross caches filled from the
     encoder, card vs CPU and against the prefill; LLaVA-NeXT-Mistral-7B
     cut to 2 layers, a (2, 128) prefill whose first 64 positions are
     patch embeddings, card vs CPU (each within 2e-3 x max(1, max|logit|),
     one flash launch a decoder layer, none in decode);
  5. TransE_l2 path: ``python -m repro_torch.launch.train --dataset fb15k
     --model transe_l2`` (14,951 x 400 entities, batch 1024, 256 joint
     negatives, T5 deferred update on) for 200 steps; the loss must fall and
     every kernel of the path must have launched at least twice a step;
  6. TransE_l1 path: the same with ``--model transe_l1 --eval --eval-n 2000
     --ckpt-dir build/chip_smoke_ckpt --save-every 100``; the loss must fall,
     the pairwise l1 and the l1 backward pair (both products) launch at
     least twice a step, the final filtered eval prints finite metrics, the
     trained tables rank better than fresh ones, the card's filtered ranks
     equal the CPU path's except where near-ties explain the difference,
     the checkpoint of step 200 holds the final state and restores on the
     card bit for bit,
     and ``--resume --steps 210`` goes on from step 200.
  7. DistMult path: the same as phase 5 with ``--model distmult``: the
     pairwise dot forward (its backward is plain matmuls), dedup and update;
     the loss must fall and each of the three kernels launch at least twice
     a step;
  8. Qwen prefill: Qwen1.5-0.5B at full width in its config dtype,
     ``build_prefill_step(model, use_flash=True)`` on (4, 2048) tokens
     from numpy seed 0: 24 flash launches a forward, finite logits, close to
     the chunked route from the same weights; the same in f32 within 2e-3;
     prefill tokens/s and the forward's device time by kernel
     (torch.profiler);
  9. Qwen serve: ``python -m repro_torch.launch.serve --full --batch 4
     --prompt-len 32 --gen 16`` in process: (4, 16) tokens, finite logits,
     its tok/s line, no flash launch; its teacher-forced logits at the 32
     prompt positions against the flash prefill's from the same weights
     (and in f32 within 2e-3); decode tokens/s with the card synchronised.
 10. Mamba2 prefill: Mamba2-2.7B at full width in its config dtype,
     ``build_prefill_step(model)`` on (4, 2048) tokens from numpy seed 0: 64
     ssd_scan launches a forward and no flash launch, finite logits,
     prefill tokens/s and the forward's device time by kernel;
 11. Mamba2 serve: ``python -m repro_torch.launch.serve --arch mamba2-2.7b
     --full --batch 4 --prompt-len 32 --gen 16`` in process: finite logits,
     its tok/s line, no kernel launch; in f32 from the same weights, its
     teacher-forced logits at the 32 prompt positions within 2e-3 x max(1,
     max|logit|) of the kernel-route prefill's (the recurrence against the
     kernel, which share no code); decode tokens/s with the card
     synchronised.
 12. Hogwild: ``python -m repro_torch.launch.train --dataset fb15k --model
     transe_l2 --trainers 4 --samplers 4 --steps 200 --metrics-out
     build/chip_smoke_hogwild/m.jsonl --trace-out build/chip_smoke_hogwild/t.json``
     in process: the final state's step and both step counters 200, the
     loss falls, exactly 400 launches each of pairwise_l2sq, dedup_aggregate
     and fused_update (T5 off, no flush), both files valid under the
     port's validators with tracks trainer-0..3 and the runtime's spans;
     TransE_l1 with ``--trainers 2 --steps 50``: exactly 100 launches each
     of pairwise_l1 and l1_bwd_pair, a finite falling loss; on the card,
     ``grad_step`` + ``apply_step`` equal ``train_step`` bit for bit
     (TransE_l2, TransE_l1) and a stale apply keeps the rows only the
     earlier apply touched; 1, 2 and 4 trainers (as many samplers, T5 off)
     for 240 steps each: the means of the losses of steps 171-200 within
     15% between 1 and 4 trainers, triplets/s over steps 51-200 and the
     card's busy share from a torch.profiler window in steps 211-235.
 13. distributed: ``python -m repro_torch.launch.train --dataset fb15k
     --model transe_l2 --distributed --mesh 1x1 --ckpt-dir
     build/chip_smoke_dist/ckpt --save-every 100 --metrics-out
     build/chip_smoke_dist/m.jsonl`` in process: a world of one rank on NCCL
     (the KVStore's all_to_alls and the servers' psums run over groups of
     one), 200 steps at phase 5's full width with T5 on; the loss falls and
     pairwise_l2sq, dedup_aggregate and fused_update each launch at least
     twice a step; step time, device time and idle share as in phase 5, and
     the kvstore/* counters of the metrics file (printed, not gated); the
     checkpoint of step 200 holds the final global state and restores on
     the card bit for bit, and ``--resume --steps 210`` goes on from step
     200; ``--mesh 2x2`` is refused with the card count; TransE_l1 for 50
     steps launches pairwise_l1 and l1_bwd_pair at least twice a step with
     a falling loss; three dim-400 steps of TransE_l2 and DistMult at lr
     0.05 through ``run_batches`` in a 1x1 world on the card and in a gloo
     world of one on the CPU, from one carried-over state and one batch
     list, under phase 4's rule (TransE_l1's card reading printed beside
     two CPU runs that differ only in the order of the batch's triplets,
     which must already part beyond the rule).
 14. pipelined KVStore I/O: phase 13's world with ``--pipeline-depth 1
     --push-every 4`` (T5 off): exactly 400 pairwise_l2sq and 450 each of
     dedup_aggregate and fused_update (50 flushes, each the
     ``kvstore/coalesced_push_flushes`` counter's), the checkpoint of step
     200 with its prefetch and merge buffers (merge ids all pads) restored
     bit for bit, a resume to 210, TransE_l1 at K 2 (exactly 100 each of
     pairwise_l1 and l1_bwd_pair), three pipelined steps against the CPU
     under phase 4's rule, the sort-based merge of one step timed by
     kernel; step time, device time and idle share beside phase 13's.
 15. distributed Hogwild: phase 13's world with ``--trainers 2 --samplers
     2`` (the runtime's ordered mode: step t takes sampler t mod 2's batch;
     T5 on), 200 TransE_l2 steps with ``--ckpt-dir ... --save-every 100
     --metrics-out ... --trace-out ...``: exactly 400 pairwise_l2sq and
     phase 13's counts of dedup_aggregate and fused_update, both files valid
     (step counters 200, trainer and sampler tracks, the turnstile's
     ``runtime/wait_turn`` span), the checkpoint of step 200 restored bit for
     bit and a resume from step 201; the final tables and every loss
     against a ``--trainers 1 --samplers 2`` run of the same world (the same
     batch order; its times printed too) under phase 4's rule; three
     dim-400 steps of TransE_l2 and DistMult through the ordered runtime on
     the card and in a gloo world of one on the CPU, under phase 4's rule;
     step time, device time and idle share beside phase 13's.
 16. MoE prefill at full width: Mixtral-8x7B cut to 2 layers (4 before
     phase 25) on (1, 8192) tokens from numpy seed 0 (its window of 4096
     masks), then DBRX cut to 2 layers (4 before) on (1, 4096), weights drawn on the card from seed 0, in bf16
     through ``build_prefill_step(model, use_flash=True)``: exactly one
     flash launch per layer a forward, finite logits, the chunked route
     beside it (flipped tokens by layer); Mixtral also in f32 from the same
     weights (flash vs chunked: at most 0.1% of tokens flipped, 90% within
     2e-3 x max(1, max|logit|); each bf16 route's median distance from the
     f32 logits, the flash route's at most twice the chunked route's); the
     capacity-bounded route in a 1x1 NCCL world at the config's factor
     (each layer's dropped share) and at E / k, where nothing drops,
     against the dense route (Mixtral in f32 under the f32 rule, DBRX in
     bf16 no farther apart than the two attention routes); forward ms,
     prefill tokens/s and device time by kernel (flash, GEMMs, the rest)
     for both routes, and the peak device memory.
 17. MoE serve: ``repro_torch.launch.serve.generate`` (the CLI's loop and
     its ThroughputHook) on the 2-layer Mixtral at batch 4, 32 + 16
     tokens: finite logits, no kernel launch; in f32 from the same
     weights, the teacher-forced logits at the prompt positions against the
     f32 flash prefill, 90% of the tokens within 2e-3 x max(1,
     max|logit|) (the chunked prefill's distance beside it); decode
     tokens/s with the card synchronised.
 18. Jamba at full width: Jamba-1.5-Large's first 5 layers (four Mamba2,
     MoE on layers 1 and 3, then attention), in bf16: a (1, 4096) prefill
     with exactly 4 ssd_scan wrapper calls and 1 flash launch a forward,
     the chunked route beside it; then ``generate`` at batch 4, 32 + 16:
     finite logits, no kernel launch, decode tokens/s.
 19. MLA prefill: MiniCPM3-4B at full width, 16 of its 62 layers (all
     62 before phase 25), weights
     drawn on the card from seed 0, in bf16, on (4, 2048) tokens from numpy
     seed 0 through ``build_prefill_step(model, use_flash=True)`` (MLA
     takes the chunked route, as in JAX): no kernel launch, finite logits;
     forward ms, prefill tokens/s, the device time split into GEMMs, the
     chunked attention's elementwise work and the rest, the peak device
     memory, and the f32 forward's distance from the bf16 one.
 20. MLA serve: ``repro_torch.launch.serve.generate`` on the 16-layer
     MiniCPM3-4B at batch 4, 32 + 16 tokens: finite logits, no kernel
     launch; in f32 from the same weights, the absorbed decode's
     teacher-forced logits at the 32 prompt positions against the f32
     prefill, every token within 2e-3 x max(1, max|logit|); decode tokens/s
     with the card synchronised and the cache bytes a token.
 21. Whisper prefill: Whisper-large-v3 at 8 + 8 of its 32 + 32 layers
     (all before phase 25) and full
     width, weights drawn on the card from seed 0, in bf16, on (4, 448)
     decoder tokens (its published text context) and (4, 1500, 1280)
     encoder frames from numpy seed 0 through ``build_prefill_step(model,
     use_flash=True)``: one flash launch a decoder layer and nothing
     else (the encoder and cross-attention take the chunked route, as in
     JAX), finite logits, the chunked route's logits beside them, the f32
     forward's distance from the bf16 one; forward ms, decoder tokens/s,
     the device time split into the encoder, flash, the chunked
     cross-attention, the decoder's GEMMs and the rest; the peak memory.
 22. Whisper serve: ``repro_torch.launch.serve.generate`` at batch 4, 32 +
     16 tokens, against zero cross caches as JAX's serve decodes: finite
     logits, no kernel launch; decode tokens/s, the cache bytes a token
     and the cross cache's fixed bytes a sequence; in f32, the
     teacher-forced decode on cross caches filled from the f32 encoder
     against the f32 prefill, every token within 2e-3 x max(1,
     max|logit|), at the cut depth with the layers kept apart (the served,
     stacked weights are chaotic under JAX's init: their reading is
     printed beside the f32 chunked-vs-flash prefill's;
     ``run_frontend_serve`` says why).
 23. LLaVA prefill: LLaVA-NeXT-Mistral-7B at 8 of its 32 layers (all
     before phase 25), bf16, on (2,
     4096) tokens whose first 2,880 positions are patch embeddings (one
     anyres image and its text): one flash launch a layer,
     finite logits, other logits when the patches change, the f32
     forward's distance; forward ms, tokens/s, device time split into
     flash, GEMMs and the rest; the peak memory.
 24. LLaVA serve: ``generate`` at batch 4, 32 + 16 (tokens only, as JAX's
     decode): no launch, finite logits; decode tokens/s; the f32
     teacher-forced decode against the f32 prefill within the plain bound,
     as phase 22 holds it.
 25. LM training (``models/steps.py::build_train_step``, the route JAX's
     training takes: the chunked attention, the plain SSD scan, no kernel
     launch anywhere): (a) Qwen1.5-0.5B and Mamba2-2.7B at full width cut
     to 2 layers and the reduced DBRX (Adafactor), in f32, two steps of 2
     microbatches of (2, 128) on the card and on the CPU from the same
     weights and batches, under ``train_rule`` (losses within 2e-5 x
     max(1, |loss|), the first step's gradients within 2e-4 x max(1,
     max|g|), parameters under the flip rule, the optimizer state); (b)
     Qwen1.5-0.5B at full width and depth (0.62 B parameters, f32 weights,
     bf16 compute, AdamW, its 8 microbatches of a (16, 2048) batch, remat):
     a warm-up step and 3 timed ones on one fixed batch, one more traced:
     finite losses, every leaf moved; step ms, tokens/s, device time split
     into GEMMs, the chunked attention's elementwise work and the rest,
     peak memory and 6 N D model FLOPs against the bf16 peak; (c) the same
     for DBRX-132B cut to 1 layer (4.49 B parameters, bf16 weights,
     Adafactor, 16 microbatches of (1, 1024), 2 timed steps); (b) and (c)
     each run in a process of its own (``run_train_child``); (d)
     ``repro_torch.examples.train_lm_smoke`` on the card, with its own
     assertion; (e) A10.5b: JAX's ``test_train_step_fsdp_moe`` Mixtral
     (reduced, f32), one step in a 1x1 NCCL world on the card and a 1x1
     gloo world on the CPU under ``train_rule``.
 26. tooling: (a) phase 8's Qwen1.5-0.5B (4, 2048) flash prefill counted
     on the card and on meta (``launch/hlo_analysis.trace``): equal matmul
     FLOPs and flash records, 24 launches, the roofline's compute term at
     most the measured device time, the meta peak bytes beside
     ``max_memory_allocated``; (b) a TransE_l1 FB15k step of a 1x1 NCCL
     world and the 2-layer Mamba2 (1, 256) prefill, card against meta; the
     seam's host cost a wrapper call; (c) last, alone on the host's CPU,
     ``python -m repro_torch.launch.dryrun`` of ``DRYRUN_CASES`` on the
     production grid, each exiting 0.

The routing rule, for every comparison that involves MoE layers: a token
whose top-k expert set differs between the two runs in any MoE layer sits
at a near-tie (bf16 rounds the router's logits, and equal ones are common)
and is left out; the share of such tokens is printed, and the logits are
compared on the others. At full width JAX's init rule makes these models
chaotic (one-hot attention, saturated routers), so phases 16-18 gate
shares of tokens and medians, not the largest error (``run_moe_prefill``
says how); phase 4 and the reduced models keep the plain bounds.

Phase 9 also passes ``--metrics-out`` and ``--trace-out``: a snapshot every
16 steps and one ``engine/step`` span a step, under the port's validators.
Launch counts are set to 0 just before each path and read just after it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository around it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the card's peak rates, from the port's H100 SXM spec (load_rates)
HBM_BYTES_PER_S = FP32_OPS_PER_S = TF32X3_OPS_PER_S = BF16_OPS_PER_S = None
TOL_REL = 2e-5  # kernel vs plain: fp32 sums taken in another order
AGREEMENT_STEPS = 3  # phase 4
MAIN_PATH_STEPS = 200
RESUME_STEPS = 210
# (G, B, K, D): the training path's pairwise call, a ragged one, eval's
# chunk of 512 queries against every entity, and the l1 backward's shapes
# (B and K swapped reads g both ways at both sizes of reduction; the last
# one's reductions, 777 and 300 long, end inside a split's slice)
PATH_SHAPE = (1, 1024, 256, 400)
RAGGED_SHAPE = (2, 1000, 250, 300)
EVAL_SHAPE = (1, 512, 14951, 400)
L1_BWD_SHAPES = (PATH_SHAPE, RAGGED_SHAPE, (3, 65, 129, 33), (1, 256, 1024, 400),
                 (1, 777, 300, 401))
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
HOGWILD_DIR = ROOT / "build" / "chip_smoke_hogwild"
HOGWILD_STEPS = 200
HOGWILD_L1_STEPS = 50
HOGWILD_TIMED = (50, 200)  # triplets/s over steps 51-200
HOGWILD_TRACED = (210, 235)  # the profiler window, on trainer 0's steps
HOGWILD_SCALING_STEPS = 240
HOGWILD_TOL = 0.15  # 1 vs 4 trainers, last-30 loss means: JAX's rule
DIST_DIR = ROOT / "build" / "chip_smoke_dist"
DIST_L1_STEPS = 50
DIST_AGREEMENT_STEPS = 3
PIPE_DIR = ROOT / "build" / "chip_smoke_pipe"
PIPE_PUSH_EVERY = 4
DIST_HOG_DIR = ROOT / "build" / "chip_smoke_dist_hogwild"
DIST_HOG_TIMED = (100, 150)  # step time over steps 101-150, as phase 13's
DIST_HOG_TRACED = (160, 180)  # the profiler window, on trainer 0's steps
# flash attention, (B, H, Hkv, T, S, dh, window, q_offset, dtype); the first
# is what the Qwen prefill path launches
FLASH_SHAPES = {
    "qwen_prefill_bf16": (4, 16, 16, 2048, 2048, 64, 0, 0, "bfloat16"),
    "qwen_prefill_f32": (4, 16, 16, 2048, 2048, 64, 0, 0, "float32"),
    "danube_gqa_swa_bf16": (1, 32, 8, 8192, 8192, 80, 4096, 0, "bfloat16"),
    "ragged_f32": (2, 4, 2, 100, 100, 64, 0, 0, "float32"),
    "decode_like_f32": (1, 4, 2, 1, 512, 64, 0, 511, "float32"),
    "ragged_bf16": (2, 4, 2, 100, 100, 64, 0, 0, "bfloat16"),
    "decode_like_bf16": (1, 4, 2, 1, 512, 64, 0, 511, "bfloat16"),
    "mixtral_prefill_bf16": (1, 32, 8, 8192, 8192, 128, 4096, 0, "bfloat16"),
    "dbrx_prefill_bf16": (1, 48, 8, 4096, 4096, 128, 0, 0, "bfloat16"),
    "jamba_prefill_bf16": (1, 64, 8, 4096, 4096, 128, 0, 0, "bfloat16"),
    "whisper_decoder_bf16": (4, 20, 20, 448, 448, 64, 0, 0, "bfloat16"),
    "llava_prefill_bf16": (2, 32, 8, 4096, 4096, 128, 0, 0, "bfloat16"),
}
QWEN = "qwen1.5-0.5b"
PREFILL_SHAPE = (4, 2048)
SERVE_ARGS = ["--arch", QWEN, "--full", "--batch", "4", "--prompt-len", "32",
              "--gen", "16"]
SERVE_DIR = ROOT / "build" / "chip_smoke_serve"  # phase 9's telemetry files
LM_TOL = 2e-3  # logits, f32: JAX's bound (tests/test_flash_serving.py)
MAMBA = "mamba2-2.7b"
MAMBA_SERVE_ARGS = ["--arch", MAMBA, "--full", "--batch", "4", "--prompt-len", "32",
                    "--gen", "16"]
# the SSD scan, (B, T, H, P, N); the first is what the Mamba2 prefill launches
SSD_SHAPES = {
    "mamba2_prefill": (4, 2048, 80, 64, 128),
    "long_8192": (1, 8192, 80, 64, 128),
    "ragged_100": (1, 100, 4, 32, 16),
    "t1": (4, 1, 80, 64, 128),
    "jamba_prefill": (1, 4096, 256, 64, 128),
}
MIXTRAL, DBRX, JAMBA = "mixtral-8x7b", "dbrx-132b", "jamba-1.5-large-398b"
# phases 16-18: full width, cut in depth to fit one card (PERF.md §4): Jamba's
# first five layers are four Mamba2 ones (MoE on 1 and 3) and its attention
MOE_CUTS = {MIXTRAL: 2, DBRX: 2, JAMBA: 5}
MOE_TOKENS = {MIXTRAL: (1, 8192), DBRX: (1, 4096), JAMBA: (1, 4096)}
MOE_SERVE = (4, 32, 16)  # batch, prompt tokens, generated tokens
MINICPM = "minicpm3-4b"  # phases 19-20: MLA at full width
MLA_TOKENS = (4, 2048)
MLA_SERVE = (4, 32, 16)
# phases 21-24: all layers at full width; Whisper's decoder context is its
# published n_text_ctx, 448; LLaVA's prompt is one anyres image (2,880 patch
# positions) and its text
WHISPER, LLAVA = "whisper-large-v3", "llava-next-mistral-7b"
# phases 19-24 at full width cut in depth (since phase 25 came;
# PERF.md §4 names each cut and the seconds it gave back)
LM_CUTS = {MINICPM: dict(n_layers=16), WHISPER: dict(n_layers=8, n_encoder_layers=8),
           LLAVA: dict(n_layers=8)}
WHISPER_TOKENS = (4, 448)
LLAVA_TOKENS = (2, 4096)
FRONTEND_SERVE = (4, 32, 16)
# the routing rule's largest share of tokens whose top-k expert set differs
ROUTE_TOL_F32 = 1e-3
# at full width, the share of tokens two f32 runs must keep within 2e-3 x
# max(1, max|logit|) (the rest move through near-ties; run_moe_prefill)
AGREE_SHARE = 0.9
SSD_REF_TOL = 1e-4  # against ssd_ref: JAX's bound (tests/test_kernels.py:94-99)
# phase 25: LM training. (a) card vs CPU in f32: full width cut to 2 layers
# on (4, 128) tokens in 2 microbatches; (b) Qwen1.5-0.5B at all 24 layers on
# its 8 microbatches of a (16, 2048) batch; (c) DBRX cut to 1 layer on its 16
# microbatches of (16, 1024); the step's rule (train_rule)
TRAIN_AGREE_TOKENS, TRAIN_AGREE_MB = (4, 128), 2
TRAIN_QWEN_TOKENS, TRAIN_QWEN_TIMED = (16, 2048), 3
TRAIN_DBRX_LAYERS, TRAIN_DBRX_TOKENS, TRAIN_DBRX_TIMED = 1, (16, 1024), 2
TRAIN_LR = 1e-4  # build_train_step's default, JAX's
DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"  # phase 26 (c): rows and logs
DRYRUN_CASES = {  # phase 26 (c): the CLI on the production grid
    "qwen_prefill_32k": ["--arch", "qwen1.5-0.5b", "--shape", "prefill_32k"],
    "mixtral_train_4k": ["--arch", "mixtral-8x7b", "--shape", "train_4k"],
    "kge_fb15k_transe_l1": ["--kge", "fb15k", "--kge-model", "transe_l1"],
}
LOSS_TOL, GRAD_TOL, PARAM_TOL = 2e-5, 2e-4, 1e-6

TPU_KERNEL = {
    "pairwise": "src/repro/kernels/kge_score/kge_score.py:57",
    "dedup_aggregate": "src/repro/kernels/sparse_adagrad/sparse_adagrad.py:152",
    "fused_update": "src/repro/kernels/sparse_adagrad/sparse_adagrad.py:74",
    # l1_bwd_pallas (:119), its two pallas_calls
    "l1_bwd_do": "src/repro/kernels/kge_score/kge_score.py:123",
    "l1_bwd_dn": "src/repro/kernels/kge_score/kge_score.py:135",
    "l1_bwd_pair": "src/repro/kernels/kge_score/kge_score.py:119",
    # flash_attention_pallas (:90), its pallas_call at :116
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:90",
    # ssd_scan_pallas (:67), its pallas_call at :85
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:67",
}


# ---------------------------------------------------------------------------
# phase 25: LM training (A10.5, A10.5b)
# ---------------------------------------------------------------------------
def train_run(torch, model, params, batches, lr):
    """``build_train_step(model, lr)`` for one step a batch, from
    ``params``, with each step's gradient as the step hands it to its
    optimizer (the microbatches' f32 sum over mb; recorded by wrapping
    ``make_optimizer`` while the step is built). Returns dict(losses,
    grads, params, state) with the tensors on the CPU, by path."""
    from repro_torch.models import steps
    from repro_torch.models.layers import tree_map
    from repro_torch.optim.dense import Optimizer

    grads, make = [], steps.make_optimizer

    def recording(name, lr, **kw):
        opt = make(name, lr, **kw)

        def update(p, g, s):
            grads.append({k: v.detach().float().cpu() for k, v in _named_leaves(
                tree_map(lambda x, y: torch.zeros_like(x) if y is None else y, p, g))})
            return opt.update(p, g, s)

        return Optimizer(opt.init, update)

    steps.make_optimizer = recording
    try:
        step, opt = steps.build_train_step(model, lr=lr)
    finally:
        steps.make_optimizer = make
    state = opt.init(params)
    losses = []
    for b in batches:
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
    return dict(losses=losses, grads=grads,
                params={k: v.float().cpu() for k, v in _named_leaves(params)},
                state={k: v.float().cpu() for k, v in _named_leaves(state) if k != ("step",)})


def train_rule(label, got, want, lr):
    """Phase 25's rule, card (``got``) against the CPU (``want``), as
    ``train_run`` gives them: each loss within 2e-5 x max(1, |loss|); each
    gradient leaf of the first step (the same weights on both) within 2e-4
    x max(1, max|g|); the parameters under the flip rule: an entry whose
    CPU gradient at some step lies within that tolerance of 0 may move the
    other way that step, as Adam's first step is lr x sign(g) (counted,
    printed, and within 2 lr a step); every other entry within 1e-6 x
    max(1, max|p|) + 1% of lr a step; the optimizer state within 2e-4 x
    max(1, max|s|). Returns the summary (printed)."""
    n = len(want["losses"])
    loss_err = max(abs(g - w) / max(1.0, abs(w))
                   for g, w in zip(got["losses"], want["losses"]))
    grad_ratio, near0 = 0.0, {}
    for s, (gg, gw) in enumerate(zip(got["grads"], want["grads"])):
        for k, w in gw.items():
            tol = GRAD_TOL * max(1.0, float(w.abs().max()))
            near0[k] = (w.abs() <= tol) | near0.get(k, False)
            if s == 0:
                grad_ratio = max(grad_ratio, float((gg[k] - w).abs().max()) / tol)
    flips, params_ok = 0, True
    for k, w in want["params"].items():
        d = (got["params"][k] - w).abs()
        bad = d > PARAM_TOL * max(1.0, float(w.abs().max())) + 1e-2 * lr * n
        z = near0[k]
        params_ok &= not bool((bad & ~z).any()) and bool((d[z] <= 2 * lr * n + 1e-7).all())
        flips += int((bad & z).sum())
    state_ratio = max(float((got["state"][k] - w).abs().max())
                      / (GRAD_TOL * max(1.0, float(w.abs().max())))
                      for k, w in want["state"].items())
    a = dict(steps=n, losses_card=got["losses"], losses_cpu=want["losses"],
             loss_rel_err=loss_err, grad_share_of_tol=grad_ratio, flipped=flips,
             params_ok=params_ok, state_share_of_tol=state_ratio)
    print(f"  {label}: losses card {[f'{x:.6f}' for x in got['losses']]}, CPU "
          f"{[f'{x:.6f}' for x in want['losses']]} (rel err {loss_err:.2e}); the first "
          f"step's gradients at {grad_ratio:.3f} of 2e-4 x max(1, max|g|); "
          f"{flips} parameter entries flipped, the rest within the rule: {params_ok}; "
          f"state at {state_ratio:.3f} of its bound")
    check(loss_err <= LOSS_TOL and grad_ratio <= 1.0 and params_ok and state_ratio <= 1.0,
          f"{label}: card and CPU train steps disagree")
    return a


def train_batches(np, cfg, B, T, mb, n, seed=0):
    """``n`` global batches of random tokens and labels (numpy seed ``seed``),
    (mb, B / mb, T) or (B, T) with one microbatch."""
    rng = np.random.default_rng(seed)
    shape = (B, T) if mb == 1 else (mb, B // mb, T)
    return [{k: rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(n)]


def check_train_agreement(torch, np, dev, arch, reduced=False):
    """Phase 25(a): ``arch`` in f32, at full width cut to 2 layers (kept
    apart, as phase 4's prefills keep theirs) with TRAIN_AGREE's tokens and
    microbatches, or reduced (DBRX, whose config picks Adafactor), from the
    same weights and batches: two ``build_train_step`` steps on the card
    and on the CPU, under ``train_rule``; no kernel launch on the card
    (the train route is JAX's: chunked attention, the plain SSD scan)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import build_model

    (B, T), mb = TRAIN_AGREE_TOKENS, TRAIN_AGREE_MB
    base = get_arch(arch).reduced() if reduced else dataclasses.replace(
        get_arch(arch), n_layers=2, scan_layers=False)
    cfg = dataclasses.replace(base, dtype="float32", param_dtype="float32",
                              microbatches=mb)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    card = tree_map(lambda t: t.to(dev, copy=True), params)
    batches = train_batches(np, cfg, B, T, mb, 2, seed=1)
    build.reset_launches()
    got = train_run(torch, model, card,
                    [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batches],
                    TRAIN_LR)
    _sync(torch, dev)
    launches = dict(build.LAUNCHES)
    want = train_run(torch, model, params,
                     [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
                     TRAIN_LR)
    label = (f"{arch} {'reduced' if reduced else 'full width, 2 layers'}, f32, "
             f"{cfg.optimizer}, {mb} microbatches of {(B // mb, T)}")
    print(f"  {label}: {sum(launches.values())} kernel launches")
    check(sum(launches.values()) == 0, f"{arch}: the train route launched {launches}")
    return train_rule(label, got, want, TRAIN_LR)


def train_world_body(grid, cfg, params, batches, lr):
    """In a world of one rank: ``train_run`` of ``cfg`` with the grid (its
    MoE layers on the capacity-bounded route over the model group, the
    gradients averaged over the machine group)."""
    import torch

    from repro_torch.models.transformer import build_model

    return train_run(torch, build_model(cfg, grid=grid), params, batches, lr)


def check_train_world(torch, np, dev):
    """Phase 25(e), A10.5b: JAX's ``test_train_step_fsdp_moe`` Mixtral
    (reduced, 2 microbatches, capacity factor 4), in f32, one
    ``build_train_step`` step in a 1x1 NCCL world on the card and in a 1x1
    gloo world on the CPU from the same weights and batch, under
    ``train_rule``; no kernel launch."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_world
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(get_arch(MIXTRAL).reduced(), microbatches=2, fsdp=True,
                              capacity_factor=4.0, dtype="float32")
    mb, (T, B) = 2, (8, 32)
    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    batches = train_batches(np, cfg, B, T, mb, 1, seed=2)
    build.reset_launches()
    got = run_world(1, 1, train_world_body,
                    (cfg, tree_map(lambda t: t.to(dev, copy=True), params),
                     [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                      for b in batches], TRAIN_LR), device=dev.type)
    launches = dict(build.LAUNCHES)
    want = run_world(1, 1, train_world_body,
                     (cfg, params, [{k: torch.from_numpy(v) for k, v in b.items()}
                                    for b in batches], TRAIN_LR))
    label = f"{MIXTRAL} reduced, f32, one step in a 1x1 world, NCCL card vs gloo CPU"
    print(f"  {label}: {sum(launches.values())} kernel launches")
    check(sum(launches.values()) == 0, f"the 1x1 train world launched {launches}")
    return train_rule(label, got, want, TRAIN_LR), launches


def attention_train_alone(torch, dev, cfg, rows, T, reps=3):
    """Device ms of one layer's chunked attention on a microbatch, traced
    alone at the train route's shapes: the forward (remat runs it again in
    the backward pass) and the forward with its backward, each split into
    (GEMMs, the rest)."""
    from repro_torch.models.attention import _sdpa_chunked
    from repro_torch.models.layers import torch_dtype

    dt = torch_dtype(cfg.dtype)
    g = torch.Generator(device=dev).manual_seed(2)
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn(rows, T, H, dh, generator=g, device=dev).to(dt).requires_grad_(True)
    k = torch.randn(rows, T, Hkv, dh, generator=g, device=dev).to(dt).requires_grad_(True)
    v = torch.randn(rows, T, Hkv, dh, generator=g, device=dev).to(dt).requires_grad_(True)

    def fwd():
        with torch.no_grad():
            _sdpa_chunked(q, k, v, causal=True, window=0, q_offset=0)

    def fwd_bwd():
        o = _sdpa_chunked(q, k, v, causal=True, window=0, q_offset=0)
        o.float().sum().backward()

    out = []
    for label, fn in (("one layer's chunked attention forward", fwd),
                      ("the same with its backward", fwd_bwd)):
        fn()
        kern = trace_events(torch, fn, reps)
        # each kernel's mean over the launches the trace holds (PERF.md §7)
        per = {k: us / n * max(1, round(n / reps)) / 1e3 for k, (us, n) in kern.items()}
        total = sum(per.values())
        gemm = sum(ms for k, ms in per.items()
                   if any(w in k for w in ("nvjet", "gemm", "cutlass")))
        print(f"  {label} alone: {total:.2f} ms traced (GEMMs {gemm:.2f} ms)")
        out.append((gemm, total - gemm))
    return out


def step_by_kernel(torch, model, opt, params, state, batch, mb):
    """{kernel: device us} of one train step, as ``mb`` times one
    microbatch (its loss and backward into ``.grad``, which holds the
    earlier microbatches' sum, and the f32 sum of a leaf stored below f32)
    plus the optimizer's update, each traced alone: a whole step's trace
    holds ~60 k kernels, which torch.profiler takes tens of seconds to
    read. The division of the sums by mb and the host's gaps are left
    out. Updates ``params`` and ``state`` once more."""
    leaves = [p for _, p in _named_leaves(params)]
    mbatch = {k: v[0] for k, v in batch.items()} if mb > 1 else batch
    sums = {}

    def microbatch():
        for p in leaves:
            p.requires_grad_(True)
        try:
            model.loss(params, mbatch).backward()
        finally:
            for p in leaves:
                p.requires_grad_(False)
        for p in leaves:
            if mb > 1 and p.dtype != torch.float32:
                g = p.grad.float()
                sums[id(p)] = g if id(p) not in sums else sums[id(p)].add_(g)
                p.grad = None

    from repro_torch.models.layers import tree_map

    microbatch()  # the next one adds into the sums, as every later one does
    per_mb = trace_by_kernel(torch, microbatch)
    grads = tree_map(lambda p: sums.get(id(p), p.grad), params)
    upd = trace_by_kernel(torch, lambda: opt.update(params, grads, state))
    for p in leaves:
        p.grad = None
    out = {k: us * mb for k, us in per_mb.items()}
    for k, us in upd.items():
        out[k] = out.get(k, 0.0) + us
    return out


def run_train_main(torch, np, dev, arch, n_layers, tokens, timed):
    """Phase 25(b) (Qwen1.5-0.5B, all 24 layers) and (c) (DBRX cut to 1
    layer): ``arch`` at full width in its config's dtypes (``param_dtype``
    for the stored weights, ``dtype`` for compute), weights drawn on the
    card from seed 0, its optimizer and microbatches, ``build_train_step``
    on one fixed global batch of ``tokens`` (numpy seed 0): one warm-up
    step, ``timed`` steps on the host clock (synchronised), then one
    step's device time by kernel (``step_by_kernel``). Gates: finite
    losses, every leaf moved, no kernel launch.
    Prints step ms, tokens/s, the device time split into GEMMs (cuBLAS),
    the chunked attention's elementwise work (one layer's forward and
    forward-with-backward traced alone, times the layers and microbatches:
    remat runs each forward twice) and the rest, the peak memory, and
    6 N D model FLOPs (``ArchConfig.model_flops``) over the step against
    the bf16 peak. Returns (launches, summary)."""
    import dataclasses

    from repro_torch.common.config import InputShape
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.steps import build_train_step
    from repro_torch.models.transformer import build_model

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in _named_leaves(params))
    B, T = tokens
    shape = InputShape("train", T, B, "train")
    step, opt = build_train_step(model, shape=shape)
    from repro_torch.models.steps import effective_microbatches

    mb = effective_microbatches(cfg, shape, model)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in train_batches(np, cfg, B, T, mb, 1, seed=0)[0].items()}
    print(f"  {cfg.name} at {n_layers} of {get_arch(arch).n_layers} layers, full width: "
          f"{n_params / 1e9:.3f} B parameters (param_dtype {cfg.param_dtype}, dtype "
          f"{cfg.dtype}), {cfg.optimizer}, {mb} microbatches of {(B // mb, T)}, remat "
          f"{cfg.remat}; drawn on the card in {init_s:.1f} s")
    first = {k: v.clone() for k, v in _named_leaves(params)}
    build.reset_launches()
    losses = []
    t0 = time.perf_counter()
    params, state, met = step(params, state, batch)
    losses.append(float(met["loss"]))
    warm_s = time.perf_counter() - t0
    moved = [k for k, v in _named_leaves(params) if not torch.equal(v, first[k])]
    del first
    t0 = time.perf_counter()
    for _ in range(timed):
        params, state, met = step(params, state, batch)
        losses.append(met["loss"])
    _sync(torch, dev)
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    losses = [float(x) for x in losses]
    launches = dict(build.LAUNCHES)
    kern = step_by_kernel(torch, model, opt, params, state, batch, mb)
    dev_ms = sum(kern.values()) / 1e3
    gemm = sum(us for key, us in kern.items()
               if any(w in key for w in ("nvjet", "gemm", "cutlass"))) / 1e3
    (f_gemm, f_rest), (b_gemm, b_rest) = attention_train_alone(torch, dev, cfg, B // mb, T)
    n_attn = sum(k[0].value == "attn" for k in model.kinds)
    runs = 1 if cfg.remat else 0  # remat runs each forward once more
    attn_rest = n_attn * mb * (runs * f_rest + b_rest)
    attn_gemm = n_attn * mb * (runs * f_gemm + b_gemm)
    rest = dev_ms - gemm - attn_rest
    tok_s = B * T / step_ms * 1e3
    flops = cfg.model_flops(shape)
    mfu = flops / (step_ms / 1e3) / BF16_OPS_PER_S
    peak = _peak_gb(torch, dev)
    print(f"  losses {[f'{x:.4f}' for x in losses]}; warm-up step {warm_s:.2f} s; "
          f"step {step_ms:.1f} ms ({tok_s:.0f} tokens/s); device {dev_ms:.1f} ms a "
          f"traced step: GEMMs {gemm:.1f} ms ({gemm / dev_ms:.1%}; the chunked "
          f"attention's of them {attn_gemm:.1f}), the chunked "
          f"attention's elementwise work {attn_rest:.1f} ms ({attn_rest / dev_ms:.1%}), "
          f"the rest {rest:.1f} ms ({rest / dev_ms:.1%}); peak {peak:.1f} GB; "
          f"6 N D = {flops / 1e12:.1f} TFLOP a step, {mfu:.1%} of the bf16 peak "
          f"({BF16_OPS_PER_S / 1e12:.0f} TFLOP/s)")
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    for key, us in top:
        print(f"    {us / 1e3:9.3f} ms  {key[:100]}")
    n_leaves = len(_named_leaves(params))
    check(all(math.isfinite(x) for x in losses), f"{arch}: train losses not finite")
    check(len(moved) == n_leaves, f"{arch}: {n_leaves - len(moved)} leaves did not move")
    check(sum(launches.values()) == 0, f"{arch}: the train route launched {launches}")
    summary = dict(layers=n_layers, params=n_params, tokens=(B, T), microbatches=mb,
                   optimizer=cfg.optimizer, losses=losses, init_s=init_s,
                   warmup_s=warm_s, step_ms=step_ms, tokens_per_s=tok_s,
                   device_ms=dev_ms, device_busy=dev_ms / step_ms, gemm_ms=gemm,
                   attention_gemm_ms=attn_gemm, attention_elementwise_ms=attn_rest,
                   rest_ms=rest,
                   model_tflop=flops / 1e12, model_flops_share=mfu, peak_gb=peak)
    return launches, summary


TRAIN_MAIN_FLAG = "--train-main"  # phase 25 (b), (c): the child's argument
TRAIN_RESULT = "TRAIN_MAIN_RESULT "  # the child's last line: launches, summary


def run_train_child(arch, n_layers, tokens, timed):
    """Phase 25 (b) or (c) in a process of its own: ``python3 chip_smoke.py
    --train-main '[arch, n_layers, [B, T], timed]'`` runs ``run_train_main``
    on the card, its lines printed here as they come, and hands back the
    launches and the summary on its last line. In the process of the whole
    run, torch.profiler's stop crashed it now and then (SIGSEGV) at this
    phase's trace of a Qwen microbatch; a fresh process never did."""
    cmd = [sys.executable, "-X", "faulthandler", str(Path(__file__).resolve()),
           TRAIN_MAIN_FLAG, json.dumps([arch, n_layers, list(tokens), timed])]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True)
    result = None
    try:
        for line in proc.stdout:
            if line.startswith(TRAIN_RESULT):
                result = json.loads(line[len(TRAIN_RESULT):])
            else:
                print(line, end="", flush=True)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(rc == 0 and result is not None,
          f"phase 25, {arch}: its process exited {rc} without a result")
    return result["launches"], result["summary"]


def train_child_main(spec: str) -> int:
    """The child of ``run_train_child``: ``main``'s set-up, then one
    ``run_train_main``."""
    import torch

    check(torch.cuda.is_available(), "phase 25's process sees no CUDA device")
    arch, n_layers, tokens, timed = json.loads(spec)
    sys.path.insert(0, str(ROOT / "src"))
    load_rates()
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.init()  # reset_peak_memory_stats needs the allocator up
    torch.zeros(1, device=dev)
    launches, summary = run_train_main(torch, np, dev, arch, n_layers, tuple(tokens), timed)
    print(TRAIN_RESULT + json.dumps({"launches": launches, "summary": summary},
                                    default=float), flush=True)
    return 0


def run_train_smoke(torch, dev):
    """Phase 25(d): ``python -m repro_torch.examples.train_lm_smoke`` in
    process on the card, with its own assertion (the last loss below ln 64
    - 0.5); no kernel launch."""
    from repro_torch.examples import train_lm_smoke
    from repro_torch.kernels import build

    build.reset_launches()
    t0 = time.perf_counter()
    losses = train_lm_smoke.main(["--device", dev.type])
    _sync(torch, dev)
    launches = dict(build.LAUNCHES)
    check(sum(launches.values()) == 0, f"train_lm_smoke launched {launches}")
    return launches, dict(first_loss=losses[0], last_loss=losses[-1], steps=len(losses),
                          seconds=time.perf_counter() - t0)


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
    """Device time of a kernel, memcpy or memset event; 0 for a host event
    and for a user annotation's span on the device timeline (a
    ``record_function`` range such as ``nccl:all_gather``, recorded when
    the CPU activity is traced too), which covers kernels counted on their
    own, as torch.profiler's own table leaves them out of its device
    total."""
    import torch

    if (evt.device_type != torch.autograd.DeviceType.CUDA
            or getattr(evt, "is_user_annotation", False)):
        return 0.0
    return float(evt.self_device_time_total)


def trace_events(torch, fn, reps=1):
    """{kernel: (device us, events)} of ``reps`` calls of ``fn``, traced by
    torch.profiler (CUPTI). On this card a trace now and then comes back
    holding no device event at all; such a trace is taken again, up to
    three times, and then the run fails."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = {e.key: (_self_device_us(e), e.count) for e in prof.key_averages()
                if _self_device_us(e) > 0}
        if kern:
            return kern
        print(f"  (torch.profiler saw no device time; trace {attempt + 2} of 3)")
    raise SmokeFailure("torch.profiler saw no device time in three traces")


def trace_by_kernel(torch, fn, reps=1):
    """{kernel: device us} of ``reps`` calls of ``fn`` (``trace_events``)."""
    return {k: us for k, (us, _) in trace_events(torch, fn, reps).items()}


def device_ms(torch, fn, reps=50, warmup=5):
    """Device time of one call of ``fn``: the kernels' own durations, traced
    by torch.profiler (CUPTI) over ``reps`` calls. Inputs stay warm in L2,
    as on the training path, where each kernel reads what the step just
    wrote. A trace may hold fewer of a kernel's launches than ran (PERF.md
    §7), so each kernel counts the mean of the launches it holds, times
    its launches a call (at least one)."""
    for _ in range(warmup):
        fn()
    return sum(us / n * max(1, round(n / reps))
               for us, n in trace_events(torch, fn, reps).values()) / 1e3


def timings(torch, kernel, plain, library, reps=50, plain_reps=20):
    """Device times of the kernel, its plain version and the library call
    (None where no single PyTorch call computes the function)."""
    lib = (None if library is None
           else device_ms(torch, library, plain_reps, min(5, plain_reps)))
    return dict(ms=device_ms(torch, kernel, reps),
                plain_ms=device_ms(torch, plain, plain_reps, min(5, plain_reps)),
                library_ms=lib, event_ms=event_ms(torch, kernel, reps))


def _fmt(r) -> str:
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
    fp32 = (f"; {r['fp32_bound_ms'] * 1e3:.2f} us at fp32's rate"
            if "fp32_bound_ms" in r else "")
    return (f"ms {r['ms']:.5f}  plain_ms {r['plain_ms']:.5f}  library_ms "
            f"{lib}  event_ms {r['event_ms']:.5f}  bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}{fp32})")


def load_rates() -> dict:
    """Set the peak rates the bounds use from ``src/repro_torch/common/hw.py``
    (NVIDIA's H100 SXM data sheet, dense): HBM bytes/s, fp32 outside the
    tensor cores, TF32 taken three times for one fp32-accurate product
    (3xTF32: the dot and l2sq products, the f32 flash-attention kernel and
    the SSD scan), bf16 tensor cores. Returns them by name."""
    from repro_torch.common.hw import H100_SXM as hw

    rates = dict(HBM_BYTES_PER_S=hw.hbm_bandwidth, FP32_OPS_PER_S=hw.peak_fp32_flops,
                 TF32X3_OPS_PER_S=hw.peak_tf32_flops / 3,
                 BF16_OPS_PER_S=hw.peak_bf16_flops)
    globals().update(rates)
    return rates


def bound(n_bytes: float, n_ops: float, ops_per_s: float = None, more=()):
    """(least ms, what bounds it): the bytes over the memory rate against the
    operations over their units' rate (fp32's by default); ``more`` holds
    (ops, rate) pairs of work on other units, which may run at the same
    time."""
    if HBM_BYTES_PER_S is None:
        load_rates()
    ops_per_s = FP32_OPS_PER_S if ops_per_s is None else ops_per_s
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max([n_ops / ops_per_s * 1e3] + [o / r * 1e3 for o, r in more])
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_of(kc):
    """``bound`` of a kernel's work as its ``cost()`` function gives it
    (``kernels/*/cost.py``: the one formula the dry run reads too)."""
    rate = {"fp32": FP32_OPS_PER_S, "tf32x3": TF32X3_OPS_PER_S, "bf16": BF16_OPS_PER_S}
    return bound(kc.bytes, kc.flops, rate[kc.unit],
                 more=[(ops, rate[unit]) for ops, unit in kc.more])


def _max_err(torch, got, want):
    """(max |got - want|, the tolerance 2e-5 x max(1, max |want|))."""
    torch.cuda.synchronize()
    return (float((got - want).abs().max()),
            TOL_REL * max(1.0, float(want.abs().max())))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_pairwise(torch, dev, gen):
    from repro_torch.kernels.kge_score.cost import pairwise_cost
    from repro_torch.kernels.kge_score.ops import pairwise_kernel, pairwise_l1_plan
    from repro_torch.kernels.kge_score.ref import pairwise_ref

    rows = []
    # eval's shape for l1 only: TransE_l1 is the model that evaluates
    path, evals = PATH_SHAPE, EVAL_SHAPE

    def operands(s):
        return (torch.randn(s[0], s[1], s[3], generator=gen).to(dev),
                torch.randn(s[0], s[2], s[3], generator=gen).to(dev))

    data = {s: operands(s) for s in (path, RAGGED_SHAPE)}
    library = {
        "dot": lambda o, n: o @ n.transpose(-1, -2),
        "l2sq": lambda o, n: torch.cdist(o, n) ** 2,
        "l1": lambda o, n: torch.cdist(o, n, p=1),
    }

    def timed(mode, shape, o, n, plain_reps):
        G, B, K, D = shape
        tm = timings(torch, lambda: pairwise_kernel(mode, o, n),
                     lambda: pairwise_ref(mode, o, n), lambda: library[mode](o, n),
                     plain_reps=plain_reps)
        # l1 on the fp32 units; dot and l2sq's product on the tensor cores
        # (3xTF32), l2sq's norms and epilogue beside it on the fp32 units
        b_ms, b_by = bound_of(pairwise_cost(mode, G, B, K, D))
        return dict(bound_ms=b_ms, bound_by=b_by, shape=f"{G}x{B}x{K}x{D}", **tm)

    for mode in ("dot", "l2sq", "l1"):
        err, tol = 0.0, 0.0
        shapes = dict(data)
        if mode == "l1":
            shapes[evals] = operands(evals)
        for shape, (o, n) in shapes.items():
            out = pairwise_kernel(mode, o, n)
            ref = pairwise_ref(mode, o, n)  # at eval's shape it builds 2 x 12 GB
            e, t = _max_err(torch, out, ref)
            plan = ""
            if mode == "l1":  # the launch's tile, rows of o x negatives
                plan = ", plan %dx%d" % ((pairwise_l1_plan(*shape),) * 2)
                check(torch.equal(out, pairwise_kernel(mode, o, n)),
                      f"pairwise l1 {shape}: two calls differ")
            print(f"  pairwise {mode:4s} {shape}: max_abs_err {e:.3e} (tol {t:.3e}){plan}")
            check(out.shape == (shape[0], shape[1], shape[2]) and math.isfinite(e)
                  and e <= t, f"pairwise {mode} {shape} disagrees: {e} > {t}")
            err, tol = max(err, e), max(tol, t)
        row = dict(name=f"pairwise_{mode}", source="src/repro_torch/csrc/pairwise.cu",
                   replaces=TPU_KERNEL["pairwise"], max_abs_err=err, tol=tol,
                   **timed(mode, path, *data[path], 20))
        if mode == "l1":
            row["plan"] = "%dx%d" % ((pairwise_l1_plan(*path),) * 2)
            row["other_shapes"] = {"eval": dict(timed(mode, evals, *shapes[evals], 2),
                                                plan="%dx%d" % ((pairwise_l1_plan(*evals),) * 2))}
            print(f"  pairwise_l1 at eval's shape {evals}: {_fmt(row['other_shapes']['eval'])}")
        rows.append(row)
    return rows


def check_l1_bwd(torch, dev, gen):
    """Both products of the l1 backward against the plain ``l1_grads_ref``,
    each called twice at every shape (the same bits both times), then timed
    at the training path's shape: each product alone (the kernel, the plain
    version asked for that product only, and the yardstick, ATen's cdist
    backward, which is the same function for p = 1: d_o =
    _cdist_backward(g, o, n, 1, cdist), d_n the same with the roles swapped
    and g, cdist transposed), and the pair as the path asks for it (both
    products; the yardstick the two cdist backward calls in sequence), with
    the plan each launch takes there."""
    from repro_torch.kernels.kge_score.cost import l1_bwd_cost
    from repro_torch.kernels.kge_score.ops import (
        l1_bwd_kernel, l1_bwd_pair_plan, l1_bwd_plan,
    )
    from repro_torch.kernels.kge_score.ref import l1_grads_ref

    path = PATH_SHAPE
    # the products alone, and both from the pair launch
    errs = {"l1_bwd_do": (0.0, 0.0), "l1_bwd_dn": (0.0, 0.0), "l1_bwd_pair": (0.0, 0.0)}
    data = {}
    for shape in L1_BWD_SHAPES:
        G, B, K, D = shape
        o = torch.randn(G, B, D, generator=gen).to(dev)
        n = torch.randn(G, K, D, generator=gen).to(dev)
        g = torch.randn(G, B, K, generator=gen).to(dev)
        data[shape] = (o, n, g)
        got = l1_bwd_kernel(o, n, g)
        again = l1_bwd_kernel(o, n, g)
        want = l1_grads_ref(o, n, g)
        alone = (l1_bwd_kernel(o, n, g, need_dn=False)[0],
                 l1_bwd_kernel(o, n, g, need_do=False)[1])
        plans = [l1_bwd_plan(G, B, K, D, False), l1_bwd_plan(G, K, B, D, True)]
        print(f"  l1_bwd {shape}: both products in one pass, K split "
              f"{l1_bwd_pair_plan(G, B, K, D)} ways; alone, tile rows x split "
              f"d_o {plans[0][0]}x{plans[0][1]}, d_n {plans[1][0]}x{plans[1][1]}")
        for name, a, a2, a1, b in zip(("l1_bwd_do", "l1_bwd_dn"), got, again, alone, want):
            for key, x in (("l1_bwd_pair", a), (name, a1)):
                e, t = _max_err(torch, x, b)
                print(f"  {name} {shape} {'pair' if key == 'l1_bwd_pair' else 'alone'}: "
                      f"max_abs_err {e:.3e} (tol {t:.3e})")
                check(x.shape == b.shape and math.isfinite(e) and e <= t,
                      f"{name} {shape} disagrees ({key}): {e} > {t}")
                errs[key] = (max(errs[key][0], e), max(errs[key][1], t))
            check(torch.equal(a, a2), f"{name} {shape}: two calls differ")

    G, B, K, D = path
    o, n, g = data[path]
    cd = torch.cdist(o, n, p=1)
    gt, cdt = g.transpose(-1, -2).contiguous(), cd.transpose(-1, -2).contiguous()
    cdist_bwd = torch.ops.aten._cdist_backward
    library = {"l1_bwd_do": lambda: cdist_bwd(g, o, n, 1.0, cd),
               "l1_bwd_dn": lambda: cdist_bwd(gt, n, o, 1.0, cdt)}
    library["l1_bwd_pair"] = lambda: (library["l1_bwd_do"](), library["l1_bwd_dn"]())
    need = {"l1_bwd_do": dict(need_dn=False), "l1_bwd_dn": dict(need_do=False),
            "l1_bwd_pair": {}}
    want = dict(zip(errs, l1_grads_ref(o, n, g)))
    rows = []
    for name in need:
        if name in want:
            lib_err, _ = _max_err(torch, library[name](), want[name])
        else:
            lib_err = max(_max_err(torch, a, want[k])[0] for a, k in
                          zip(library[name](), ("l1_bwd_do", "l1_bwd_dn")))
        print(f"  {name}: _cdist_backward vs plain max_abs_err {lib_err:.3e}")
        tm = timings(torch, lambda: l1_bwd_kernel(o, n, g, **need[name]),
                     lambda: l1_grads_ref(o, n, g, **need[name]), library[name])
        # a sign, a product and a sum an element for each product; the
        # pair's least work takes the sign once
        b_ms, b_by = bound_of(l1_bwd_cost(G, B, K, D, **need[name]))
        rows.append(dict(name=name, source="src/repro_torch/csrc/l1_bwd.cu",
                         replaces=TPU_KERNEL[name], max_abs_err=errs[name][0],
                         tol=errs[name][1], bound_ms=b_ms, bound_by=b_by,
                         shape=f"{G}x{B}x{K}x{D}", library_err=lib_err, **tm))

    plans = {"l1_bwd_do": "%dx%d" % l1_bwd_plan(G, B, K, D, False),
             "l1_bwd_dn": "%dx%d" % l1_bwd_plan(G, K, B, D, True),
             "l1_bwd_pair": "64x%d" % l1_bwd_pair_plan(G, B, K, D)}
    for row in rows:
        row["plan"] = plans[row["name"]]
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


def fb15k_config(kg, model):
    import dataclasses

    from repro_torch.configs import FB15K

    return dataclasses.replace(FB15K, model=model, n_entities=kg.n_entities,
                               n_relations=kg.n_relations)


def path_batch_ids(torch, np, dev, kg):
    """The entity and relation ids one FB15k main-path step hands the dedup
    kernel: a JointSampler batch on the full-scale synthetic graph, whose
    ids are Zipf-skewed (one relation fills 100-140 of 1024 slots)."""
    from repro_torch.core import kge_model as K
    from repro_torch.core.sampling import JointSampler

    cfg = fb15k_config(kg, "transe_l2")
    batch = JointSampler(kg.train, cfg.n_entities, cfg, np.random.default_rng(0)).sample()
    ws = K.dense_step_batch(K.batch_to_device(batch, dev))
    return ws["ent_ids"].to(torch.int32), ws["rel_ids"].to(torch.int32)


def dist_path_ids(torch, np, kg):
    """The ids phase 13's 1x1 world hands the dedup kernel a step: the T5
    flush of the entity pend buffer (a DistBatch's 3,584 local slots, then
    2,048 remote slots, all pads on one machine) and the relation apply
    (1,024 local + 256 remote slots)."""
    import dataclasses

    from repro_torch.core.graph_part import partition
    from repro_torch.core.rel_part import relation_partition
    from repro_torch.core.sampling import DistSampler

    cfg = dataclasses.replace(fb15k_config(kg, "transe_l2"), n_parts=1)
    db = DistSampler(kg.train, partition(kg.train, cfg.n_entities, 1),
                     relation_partition(kg.rel_counts(), 1), cfg,
                     np.random.default_rng(0)).sample()
    ent = np.concatenate([db.ent_local_ids[0], db.ent_remote_req[0].reshape(-1)])
    rel = np.concatenate([db.rel_local_ids[0], db.rel_remote_req[0].reshape(-1)])
    return torch.from_numpy(ent), torch.from_numpy(rel)


def check_dedup(torch, np, dev, gen, kg):
    from repro_torch.kernels.sparse_adagrad.cost import dedup_cost
    from repro_torch.kernels.sparse_adagrad.ops import dedup_aggregate
    from repro_torch.kernels.sparse_adagrad.ref import dedup_aggregate_ref

    ent, rel = path_batch_ids(torch, np, dev, kg)
    cases = {"entity": ent, "relation": rel,
             "entity_pads": _dedup_ids(torch, gen, 2560, 14951),
             "relation_pads": _dedup_ids(torch, gen, 1024, 1345)}
    cases["dist_entity_flush"], cases["dist_relation"] = dist_path_ids(torch, np, kg)
    # phase 14: the entity apply of its local slots, and the coalesced
    # push's flush of P * Ck = 4,096 merged slots (all pads on one card;
    # here unique rows and pads, as a flush of several machines holds,
    # drawn apart so that the other cases' inputs stay as they were)
    cases["pipe_entity_local"] = cases["dist_entity_flush"][:3584]
    own = torch.Generator().manual_seed(6)
    flush = torch.randperm(14952, generator=own)[:4096].to(torch.int32)
    flush[torch.rand(4096, generator=own) < 0.5] = -1
    cases["pipe_flush"] = flush
    err, tol, timed = 0.0, 0.0, {}
    for case, ids in cases.items():
        n, D = ids.numel(), 400
        ids = ids.to(dev)
        g = torch.randn(n, D, generator=gen).to(dev)
        uid, agg = dedup_aggregate(ids, g)
        uid2, agg2 = dedup_aggregate(ids, g)
        ru, ra = dedup_aggregate_ref(ids, g)
        torch.cuda.synchronize()
        check(torch.equal(uid, uid2) and torch.equal(agg, agg2),
              f"dedup_aggregate {case}: two calls differ")
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
        b_ms, b_by = bound_of(dedup_cost(n, D))  # id compares + row adds
        timed[case] = dict(shape=f"n={n} D={D}", bound_ms=b_ms, bound_by=b_by, **tm)
        print(f"    {_fmt(timed[case])}")
    return [dict(name="dedup_aggregate", source="src/repro_torch/csrc/dedup_aggregate.cu",
                 replaces=TPU_KERNEL["dedup_aggregate"], max_abs_err=err, tol=tol,
                 **timed["entity"], other_shapes={k: timed[k] for k in cases
                                                 if k != "entity"})]


def check_update(torch, dev, gen):
    from repro_torch.kernels.sparse_adagrad.cost import update_cost
    from repro_torch.kernels.sparse_adagrad.ops import fused_sparse_adagrad
    from repro_torch.kernels.sparse_adagrad.ref import fused_update_ref

    lr, eps, err, tol, timed = 0.25, 1e-10, 0.0, 0.0, {}
    # the single path's entity and relation applies, then phase 13's flush
    # of 5,632 pend slots into its 14,952-row block and its 1,280-slot
    # relation apply, then phase 14's apply of its 3,584 local slots and
    # its coalesced push's flush of 4,096
    for n, n_rows in ((2560, 14951), (1024, 1345), (5632, 14952), (1280, 1352),
                      (3584, 14952), (4096, 14952)):
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
        # ids; grad, table, gsq rows in; two rows out: this run's valid rows
        b_ms, b_by = bound_of(update_cost(n, D, valid=v))
        timed[n] = dict(bound_ms=b_ms, bound_by=b_by, **tm)
        print(f"    {_fmt(timed[n])}, {v} valid rows")
    return [dict(name="fused_update", source="src/repro_torch/csrc/fused_update.cu",
                 replaces=TPU_KERNEL["fused_update"], max_abs_err=err, tol=tol,
                 shape="14951x400, n=2560", **timed[2560],
                 other_shapes={"relation": {"shape": "1345x400, n=1024", **timed[1024]},
                               "dist_entity_flush": {"shape": "14952x400, n=5632",
                                                     **timed[5632]},
                               "dist_relation": {"shape": "1352x400, n=1280",
                                                 **timed[1280]},
                               "pipe_entity_local": {"shape": "14952x400, n=3584",
                                                     **timed[3584]},
                               "pipe_flush": {"shape": "14952x400, n=4096",
                                              **timed[4096]}})]


def _attn_mask(torch, dev, T, S, window, q_offset):
    """The causal (and window) mask of query row i at position i + q_offset."""
    qpos = torch.arange(T, device=dev)[:, None] + q_offset
    kpos = torch.arange(S, device=dev)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def check_flash(torch, dev, gen):
    """flash_attention.cu against ``mha_ref`` at FLASH_SHAPES (causal). f32
    within 2e-5 x max(1, max|plain|); bf16 within one bf16 rounding,
    2^-7 |plain| + 2e-5 x max(1, max|plain|). The yardstick is
    scaled_dot_product_attention with enable_gqa, is_causal or the boolean
    mask of the window and offset cases."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.cost import flash_cost
    from repro_torch.kernels.flash_attention.ops import flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import mha_ref

    err, tol, timed = 0.0, 0.0, {}
    for name, (B, H, Hkv, T, S, dh, win, qoff, dt) in FLASH_SHAPES.items():
        dtype = getattr(torch, dt)
        q = torch.randn(B, H, T, dh, generator=gen).to(dev, dtype)
        k, v = (torch.randn(B, Hkv, S, dh, generator=gen).to(dev, dtype) for _ in "kv")
        out = flash_attention_kernel(q, k, v, True, win, qoff)
        want = mha_ref(q, k, v, causal=True, window=win, q_offset=qoff).float()
        torch.cuda.synchronize()
        got = out.float()
        scaled = TOL_REL * max(1.0, float(want.abs().max()))
        allowed = scaled + (2.0 ** -7 * want.abs() if dtype == torch.bfloat16 else 0.0)
        diff = (got - want).abs()
        e, t = float(diff.max()), float(torch.as_tensor(allowed).max())
        ok = bool((diff <= allowed).all())
        mask = _attn_mask(torch, dev, T, S, win, qoff)
        pairs = int(mask.sum()) * B * H
        lib_mask = None if (win == 0 and qoff == 0 and T == S) else mask

        def library(q=q, k=k, v=v, lib_mask=lib_mask):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, is_causal=lib_mask is None,
                enable_gqa=True)

        # the largest share of the gate each uses; SDPA, which rounds p to
        # bf16, shows what the kernel's split of p buys
        lib_diff = (library().float() - want).abs()
        lib_err = float(lib_diff.max())
        share = float((diff / allowed).max())
        lib_share = float((lib_diff / allowed).max())
        del lib_diff
        print(f"  flash_attention {name} {(B, H, Hkv, T, S, dh, win, qoff)}: "
              f"max_abs_err {e:.3e} (largest allowed {t:.3e}), largest share of the "
              f"gate {share:.3f}; sdpa vs plain {lib_err:.3e}, share {lib_share:.3f}")
        check(out.shape == q.shape and out.dtype == dtype and math.isfinite(e) and ok,
              f"flash_attention {name} disagrees with mha_ref")
        err, tol = max(err, e), max(tol, t)
        big = T * S * B * H > 1 << 24
        tm = timings(torch, lambda: flash_attention_kernel(q, k, v, True, win, qoff),
                     lambda: mha_ref(q, k, v, causal=True, window=win, q_offset=qoff),
                     library, reps=10 if big else 50, plain_reps=3 if big else 20)
        kc = flash_cost(B, H, Hkv, T, S, dh, True, win, qoff, q.element_size())
        check(kc.flops == 4 * dh * pairs, f"flash_cost's pairs are not the mask's ({name})")
        # f32 runs as 3xTF32 on the tensor cores; its bound at fp32's rate
        # outside them is kept beside it
        f32 = dtype == torch.float32
        b_ms, b_by = bound_of(kc)
        more = dict(fp32_bound_ms=bound(kc.bytes, kc.flops)[0]) if f32 else {}
        timed[name] = dict(shape=f"{B}x{H}x{Hkv}x{T}x{S}x{dh} w{win} off{qoff} {dt}",
                           bound_ms=b_ms, bound_by=b_by, **more, pairs=pairs, err=e,
                           gate_share=share, sdpa_err=lib_err, sdpa_gate_share=lib_share,
                           **tm)
        print(f"    {_fmt(timed[name])}")
    main = next(iter(FLASH_SHAPES))
    return [dict(name="flash_attention", source="src/repro_torch/csrc/flash_attention.cu",
                 replaces=TPU_KERNEL["flash_attention"], max_abs_err=err, tol=tol,
                 **timed[main], other_shapes={k: timed[k] for k in FLASH_SHAPES
                                              if k != main})]


def check_ssd(torch, dev, gen):
    """ssd_scan.cu against the plain chunked version within 2e-5 x max(1,
    max|plain|), and against the step-by-step ``ssd_ref`` within 1e-4 x
    max(1, max|ref|), at SSD_SHAPES, on inputs of JAX's sweep (dt in [0.05,
    0.15], A in [-2, -1], B and C of std 0.5). No single PyTorch call
    computes the scan, so the row has no library time."""
    from repro_torch.kernels.ssd_scan.cost import ssd_cost
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_batched, ssd_ref

    err = tol = ref_err = ref_tol = 0.0
    timed = {}
    for name, (B, T, H, P, N) in SSD_SHAPES.items():
        ins = (torch.randn(B, T, H, P, generator=gen),
               0.05 + 0.1 * torch.rand(B, T, H, generator=gen),
               -1.0 - torch.rand(H, generator=gen),
               0.5 * torch.randn(B, T, N, generator=gen),
               0.5 * torch.randn(B, T, N, generator=gen))
        x, dt, A, Bm, Cm = (t.to(dev) for t in ins)
        y = ssd_scan_kernel(x, dt, A, Bm, Cm)
        plain = ssd_chunked_batched(x, dt, A, Bm, Cm)
        ref = torch.stack([ssd_ref(x[b], dt[b], A, Bm[b], Cm[b])[0] for b in range(B)])
        e, t = _max_err(torch, y, plain)
        re_ = float((y - ref).abs().max())
        rt = SSD_REF_TOL * max(1.0, float(ref.abs().max()))
        print(f"  ssd_scan {name} {(B, T, H, P, N)}: max_abs_err {e:.3e} (tol {t:.3e}) "
              f"vs plain; {re_:.3e} (tol {rt:.3e}) vs ssd_ref")
        check(y.shape == x.shape and math.isfinite(e) and e <= t and re_ <= rt,
              f"ssd_scan {name} disagrees: {e} > {t} or {re_} > {rt}")
        err, tol = max(err, e), max(tol, t)
        ref_err, ref_tol = max(ref_err, re_), max(ref_tol, rt)
        del ref
        big = B * T * H > 1 << 16
        tm = timings(torch, lambda: ssd_scan_kernel(x, dt, A, Bm, Cm),
                     lambda: ssd_chunked_batched(x, dt, A, Bm, Cm), None,
                     reps=10 if big else 50, plain_reps=3 if big else 20)
        kc = ssd_cost(B, T, H, P, N)  # the products as 3xTF32, the causal pairs
        b_ms, b_by = bound_of(kc)
        timed[name] = dict(shape=f"{B}x{T}x{H}x{P}x{N}", bound_ms=b_ms, bound_by=b_by,
                           fp32_bound_ms=bound(kc.bytes, kc.flops)[0], **tm)
        print(f"    {_fmt(timed[name])}")
    main = next(iter(SSD_SHAPES))
    return [dict(name="ssd_scan", source="src/repro_torch/csrc/ssd_scan.cu",
                 replaces=TPU_KERNEL["ssd_scan"], max_abs_err=err, tol=tol,
                 ref_err=ref_err, ref_tol=ref_tol,
                 library="none: no single PyTorch call computes the SSD scan",
                 **timed[main], other_shapes={k: timed[k] for k in SSD_SHAPES
                                              if k != main})]


# ---------------------------------------------------------------------------
# phase 4: a few dim-400 steps on a small graph, card vs CPU
# ---------------------------------------------------------------------------
def agreement_run(torch, np, model, lr, devices):
    """Phase 4's run: three dim-400 steps of ``model`` at batch 256 and k 64
    on a small synthetic graph, from one seeded state and one batch stream
    on each of ``devices``. Returns (cfg, initial arrays, {device: (losses,
    final arrays)})."""
    import dataclasses

    from repro_torch.core import kge_model as K
    from repro_torch.core.sampling import JointSampler
    from repro_torch.data.kg_synth import fb15k_like

    kg = fb15k_like(scale=0.05, seed=1)
    cfg = dataclasses.replace(fb15k_config(kg, model), batch_size=256,
                              neg_sample_size=64)
    if lr is not None:
        cfg = dataclasses.replace(cfg, lr=lr)
    states = {d: K.init_state(cfg, torch.Generator().manual_seed(1), overlap=True,
                              device=d) for d in devices}
    init = K.state_to_arrays(next(iter(states.values())))
    sampler = JointSampler(kg.train, cfg.n_entities, cfg, np.random.default_rng(1))
    losses = {d: [] for d in devices}
    for _ in range(AGREEMENT_STEPS):
        batch = sampler.sample()
        for d in states:
            states[d], m = K.train_step(cfg, states[d], K.batch_to_device(batch, d))
            losses[d].append(float(m["loss"]))
    out = {}
    for d in states:
        K.flush_state(cfg, states[d])
        out[d] = (losses[d], K.state_to_arrays(states[d]))
    return cfg, init, out


def share_off(np, got, want):
    """{table: (max |got - want|, share of entries off rtol = atol = 1e-5)}"""
    out = {}
    for name in ("entity", "ent_gsq", "r_emb", "rel_gsq", "r_proj", "proj_gsq"):
        if want[name] is not None:
            diff = np.abs(got[name] - want[name])
            out[name] = (float(diff.max()),
                         float((diff > 1e-5 + 1e-5 * np.abs(want[name])).mean()))
    return out


def check_agreement(torch, np, dev, model, lr=None):
    cfg, init, runs = agreement_run(torch, np, model, lr, (dev, "cpu"))
    (l_dev, got), (l_cpu, want) = runs[dev], runs["cpu"]
    print(f"  {model}: losses card {l_dev} cpu {l_cpu}")
    check(np.allclose(l_dev, l_cpu, rtol=1e-5, atol=1e-5),
          f"{model}: card and CPU losses disagree")
    # Adagrad's first step is ~+-lr for any nonzero grad: an entry whose grad
    # is near zero may flip; allow 0.1% of entries, by at most 2 lr steps
    if model == "rescal":  # the score reads only the projection rows
        same = all(np.array_equal(a[k], init[k]) for a in (got, want)
                   for k in ("r_emb", "rel_gsq"))
        print(f"  rescal relation rows and accumulator unchanged on both: {same}")
        check(same, "rescal: relation rows moved though the score never reads them")
    for name, (most, off) in share_off(np, got, want).items():
        print(f"  {model} {name}: max diff {most:.3e}, share off {off:.2e}")
        check(off <= 1e-3 and most <= 2 * cfg.lr * AGREEMENT_STEPS,
              f"{model}: card and CPU {name} disagree")


def sum_order_witness(torch, np, dev, model):
    """What phase 4's rule reads at FB15k's lr when only the rounding of some
    sums differs. Against the CPU run: the card (kernels); the card with the
    pairwise kernel's plain version (cuBLAS fp32 in place of 3xTF32); the
    CPU with every dedup sum taken in float64 and rounded once. Returns the
    largest share off of the last, which no kernel touches."""
    from unittest import mock

    from repro_torch.kernels.kge_score import ops as score_ops
    from repro_torch.kernels.kge_score.ref import pairwise_ref
    from repro_torch.kernels.sparse_adagrad import ops as adagrad_ops
    from repro_torch.kernels.sparse_adagrad.ref import dedup_aggregate_ref

    def dedup_f64(ids, grads):
        uid, _ = dedup_aggregate_ref(ids, grads)
        match = (ids[:, None] == ids[None, :]) & (uid >= 0)[:, None]
        return uid, (match.double() @ grads.double()).float()

    _, _, runs = agreement_run(torch, np, model, None, (dev, "cpu"))
    want = runs["cpu"][1]
    with mock.patch.object(score_ops, "pairwise_kernel",
                           lambda mode, o, n: pairwise_ref(mode, o, n)):
        plain_dot = agreement_run(torch, np, model, None, (dev,))[2][dev][1]
    with mock.patch.object(adagrad_ops, "dedup_aggregate_ref", dedup_f64):
        f64 = agreement_run(torch, np, model, None, ("cpu",))[2]["cpu"][1]
    shares = {what: share_off(np, got, want) for what, got in
              (("card", runs[dev][1]), ("card, plain pairwise", plain_dot),
               ("cpu, float64 dedup sums", f64))}
    for what, by_table in shares.items():
        print(f"  {model} at lr 0.25, {what} vs cpu: share off " + ", ".join(
            f"{name} {off:.2e}" for name, (_, off) in by_table.items()))
    return max(off for _, off in shares["cpu, float64 dedup sums"].values())


def logits_agree(torch, got, want, rtol, atol):
    """(max |got - want|, max of |got - want| / (atol + rtol |want|)), one
    batch row at a time to bound the temporaries; agreement is a ratio <= 1."""
    err = ratio = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.to(g.device).float()
        d = (g - w).abs()
        err = max(err, float(d.max()))
        ratio = max(ratio, float((d / (atol + rtol * w.abs())).max()))
    return err, ratio


def check_lm_agreement(torch, np, dev, arch, counter, use_flash):
    """``arch`` at full width cut to 2 layers, in f32: a (1, 256) prefill on
    the card through the ``counter`` kernel (flash attention for Qwen, with
    ``use_flash``; ssd_scan for Mamba2) and on the CPU through its plain
    version, from the same weights, within 2e-3. The two layers are kept
    apart (``scan_layers=False``, as the reduced configs keep theirs):
    stacked, ``fan_in`` would read the layer count, 2, and draw matrices of
    std 0.71 whose activations turn the comparison into a test of rounding
    chaos (a stacked Qwen run came within 1% of the bound)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.layers import tree_map
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(get_arch(arch), n_layers=2, dtype="float32",
                              scan_layers=False)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    card = tree_map(lambda t: t.to(dev), params)
    tok = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 256)))
    prefill = build_prefill_step(model, use_flash=use_flash)
    build.reset_launches()
    got = prefill(card, {"tokens": tok.to(dev)})
    torch.cuda.synchronize()
    n = build.LAUNCHES[counter]
    want = prefill(params, {"tokens": tok})
    err, ratio = logits_agree(torch, got, want, LM_TOL, LM_TOL)
    print(f"  {arch} 2-layer full-width f32 prefill (1, 256): {n} {counter} launches; "
          f"card vs CPU logits max_abs_err {err:.3e}, largest share of the 2e-3 "
          f"bound {ratio:.3f}")
    check(n == cfg.n_layers and got.shape == want.shape and ratio <= 1.0,
          f"{arch} card and CPU logits disagree")


def check_moe_agreement(torch, np, dev, arch):
    """Phase 4's MoE rows: the reduced ``arch`` in f32, a (1, 256) flash
    prefill on the card (flash attention, and ssd_scan for Jamba's Mamba2
    layer) and on the CPU (plain versions) from the same weights, then the
    capacity-bounded route at factor 0.5 in a 1x1 NCCL world on the card
    and a 1x1 gloo world on the CPU (each layer's dropped share printed;
    at the configs' 1.25 these reduced models route evenly enough to drop
    nothing), both under the routing rule (``run_moe_prefill``): at most
    0.1% of the tokens flipped, the others' logits within 2e-3."""
    import dataclasses

    from repro_torch.common.config import MixerKind
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_world
    from repro_torch.models.layers import tree_map
    from repro_torch.models.moe import dropped_share
    from repro_torch.models.transformer import build_model, forward_routes, routing_rule

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    card = tree_map(lambda t: t.to(dev), params)
    tok = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 256)))
    n_attn = sum(k[0] == MixerKind.ATTN for k in model.kinds)
    build.reset_launches()
    got, got_sets = forward_routes(model, card, {"tokens": tok.to(dev)}, use_flash=True)
    _sync(torch, dev)
    n = (build.LAUNCHES["flash_attention"], build.LAUNCHES["ssd_scan"])
    want, want_sets = forward_routes(model, params, {"tokens": tok}, use_flash=True)
    a = routing_rule(got, want, got_sets, want_sets)
    rcfg = dataclasses.replace(cfg, capacity_factor=0.5)
    r_got, r_got_sets, _ = run_world(1, 1, moe_world_body,
                                     (rcfg, card, {"tokens": tok.to(dev)}, True),
                                     device=dev.type)
    r_want, r_want_sets, _ = run_world(1, 1, moe_world_body,
                                       (rcfg, params, {"tokens": tok}, True))
    r = routing_rule(r_got, r_want, r_got_sets, r_want_sets)
    drops = [dropped_share(s, rcfg) for s in r_want_sets]
    print(f"  {arch} reduced f32 prefill (1, 256): {n[0]} flash, {n[1]} ssd_scan "
          f"launches; card vs CPU {a['flipped']:.3%} of tokens flipped, logits "
          f"max_abs_err {a['max_other']:.3e} on the others; routed at factor 0.5 "
          f"(dropped by layer {[f'{d:.1%}' for d in drops]}): NCCL card vs gloo CPU "
          f"{r['flipped']:.3%} flipped, {r['max_other']:.3e}")
    check(n == (n_attn, cfg.n_layers - n_attn) and min(drops) > 0
          and max(a["flipped"], r["flipped"]) <= ROUTE_TOL_F32
          and max(a["max_other"], r["max_other"]) <= LM_TOL,
          f"{arch}: card and CPU MoE prefills disagree")


# ---------------------------------------------------------------------------
# phases 5-7: the training paths
# ---------------------------------------------------------------------------
class _Tee:
    """Standard output that is also kept, to read the run's eval lines."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def run_path(torch, np, model, extra, timed_from, hooks=()):
    """``python -m repro_torch.launch.train --dataset fb15k --model <model>``
    for MAIN_PATH_STEPS steps with launch counts set to 0 just before; the
    loss must fall and the tables stay finite. Returns the launches, a
    summary (step time over steps timed_from+1..150, device time and busy
    share from a torch.profiler window of steps 161..180), the final state
    and what the run printed."""
    from repro_torch.kernels import build
    from repro_torch.launch import engine, train

    steps = MAIN_PATH_STEPS

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

    metrics = engine.MetricsHook(("loss", "pos_score", "neg_score", "pend_dropped",
                                  "push_dropped"))
    timing = Window(timed_from, steps - 50)  # steady state, untraced
    traced = Window(steps - 40, steps - 20, profile=True)
    tee = _Tee(sys.stdout)
    build.reset_launches()
    t0 = time.perf_counter()
    sys.stdout = tee
    try:
        cfg, state = train.main(["--dataset", "fb15k", "--model", model, "--steps",
                                 str(steps), "--log-every", "50", *extra],
                                hooks=[metrics, timing, traced, *hooks])
        torch.cuda.synchronize()
    finally:
        sys.stdout = tee.out
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
    print(f"  config: {cfg.model}, {cfg.n_entities} x {cfg.dim} entities, "
          f"{cfg.n_relations} relations, batch {cfg.batch_size}, k "
          f"{cfg.neg_sample_size}, groups {cfg.n_neg_groups}, gamma {cfg.gamma}, "
          f"lr {cfg.lr}, overlap {cfg.overlap_update}")
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
    # a key a path does not report reads nan: T5 off, or no coalesced push
    for key, what in (("pend_dropped", "deferred update"),
                      ("push_dropped", "coalesced push")):
        check(all(v == 0 for v in hist[key] if not math.isnan(v)),
              f"{what} dropped rows")
    if isinstance(state, dict):  # --distributed: the global state, numpy
        check(state["entity"].shape[1] == cfg.dim
              and all(np.isfinite(state[k]).all() for k in ("entity", "r_emb")),
              "tables not finite")
    else:
        check(tuple(state.entity.shape) == (cfg.n_entities, cfg.dim)
              and bool(torch.isfinite(state.entity).all())
              and bool(torch.isfinite(state.r_emb).all()), "tables not finite")
    summary = dict(step_ms=step_ms, device_ms_per_step=device_step_ms,
                   device_busy=busy, loss_first10=first, loss_last10=last,
                   triplets_per_s=cfg.batch_size / step_ms * 1e3,
                   whole_run_s=wall)
    return launches, summary, cfg, state, "".join(tee.parts)


def check_launched(launches, names, steps):
    for name in names:
        check(launches[name] >= 2 * steps,
              f"{name} launched {launches[name]} times in {steps} steps")


def near_ties(torch, np, E, cfg, state, test, fm, j):
    """For rank ``j`` of ``E.ranks_against_all(cfg, state, test, fm)`` (the
    tail-side ranks of every query, then the head-side ones): the unfiltered
    candidates whose card score lies within the kernel tolerance of the
    positive's. Only these can move the rank when the card and the CPU
    round differently."""
    q = test[j % len(test)]
    corrupt = "tail" if j < len(test) else "head"
    h, r, t = (torch.tensor([int(v)], device=state.entity.device) for v in q)
    with torch.no_grad():
        cand = E._candidate_scores(cfg, state, h, r, t, None, corrupt)[0].cpu().numpy()
        pos = float(E._pos_scores(cfg, state, h, r, t)[0])
    key = ("t", int(q[0]), int(q[1])) if corrupt == "tail" else ("h", int(q[2]), int(q[1]))
    cand[list(fm.get(key, ()))] = -np.inf
    return int((np.abs(cand - pos) <= TOL_REL * max(1.0, abs(pos))).sum())


def run_l1_path(torch, np, dev, kg):
    """Phase 6: TransE_l1 through train.py with eval and checkpoints, then
    the checks on what it left behind, then a resumed run."""
    from repro_torch.common.checkpoint import latest_step, restore_checkpoint
    from repro_torch.core import eval as E
    from repro_torch.core import kge_model as K
    from repro_torch.launch import engine, train

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ckpt = ["--ckpt-dir", str(CKPT_DIR), "--save-every", "100"]
    # the step time is taken after the save at step 100
    launches, summary, cfg, state, out = run_path(
        torch, np, "transe_l1", ["--eval", "--eval-n", "2000", *ckpt], 100)
    check_launched(launches, ("pairwise_l1", "l1_bwd_do", "l1_bwd_dn", "l1_bwd_pair",
                              "dedup_aggregate", "fused_update"), MAIN_PATH_STEPS)

    evals = re.findall(r"eval: MRR (\S+) \| MR (\S+) \| Hit@1 (\S+) \| Hit@3 (\S+) "
                       r"\| Hit@10 (\S+) \(n=(\d+)\)", out)
    check(len(evals) == 1, f"expected one eval line, got {len(evals)}")
    final = [float(x) for x in evals[0]]
    check(all(math.isfinite(x) for x in final) and final[5] == 4000,
          f"eval metrics not finite or not 2 x 2000 ranks: {evals[0]}")
    check(latest_step(str(CKPT_DIR)) == MAIN_PATH_STEPS,
          f"latest checkpoint {latest_step(str(CKPT_DIR))}, not {MAIN_PATH_STEPS}")

    # the state came back flushed by the final eval; rank against a fresh one
    fm = E.build_filter_map(kg.triplets)
    fresh = K.init_state(cfg, torch.Generator().manual_seed(0), overlap=True, device=dev)
    mrr = {name: E.metrics_from_ranks(E.ranks_against_all(
        cfg, st, kg.test[:256], filter_map=fm)).mrr
        for name, st in (("trained", state), ("fresh", fresh))}
    print(f"  filtered MRR on 256 test queries: trained {mrr['trained']:.4f}, "
          f"fresh {mrr['fresh']:.4f}")
    check(mrr["trained"] > mrr["fresh"], "training did not raise the MRR")

    # card (pairwise kernel) vs CPU (plain version) from the same tables
    test = kg.test[:128]
    t0 = time.perf_counter()
    card = E.ranks_against_all(cfg, state, test, filter_map=fm)
    cpu_state = K.state_from_arrays(cfg, K.state_to_arrays(state), device="cpu")
    cpu = E.ranks_against_all(cfg, cpu_state, test, filter_map=fm, chunk=32)
    diff = np.abs(card - cpu)
    ties = {int(j): near_ties(torch, np, E, cfg, state, test, fm, int(j))
            for j in np.flatnonzero(diff)}
    queries = float((diff.reshape(2, -1) == 0).all(0).mean())
    print(f"  filtered ranks of {len(test)} test queries, card vs CPU: "
          f"{float((diff == 0).mean()):.2%} of ranks and {queries:.2%} of queries "
          f"(both sides) equal; unequal ranks (index: |diff|, near-ties) "
          f"{ {j: (int(diff[j]), n) for j, n in ties.items()} } "
          f"({time.perf_counter() - t0:.1f} s)")
    check(all(diff[j] <= n for j, n in ties.items()),
          "card and CPU ranks differ where no near-tie explains it")

    # the checkpoint of step 200 holds the state the run ended with (flushed
    # by the save), and restores on the card bit for bit
    def leaves(st):  # the checkpoint's leaves: int32 step and ids
        return {k: v for k, v in K.state_to_arrays(st).items() if v is not None}

    def equal(x, y):
        return set(x) == set(y) and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in x)

    saved = CKPT_DIR / f"step_{MAIN_PATH_STEPS:010d}"
    files = {p.stem: np.load(p) for p in saved.glob("*.npy")}
    same = equal(files, leaves(state))
    restored = equal(files, leaves(restore_checkpoint(str(CKPT_DIR), K.init_state(
        cfg, torch.Generator().manual_seed(1), overlap=True, device=dev),
        step=MAIN_PATH_STEPS)))
    print(f"  {saved.name} holds the final state bit for bit: {same} "
          f"({sorted(files)}); restored on the card bit for bit: {restored}")
    check(same and restored, "the checkpoint does not hold or restore the final state")

    class First(engine.Hook):
        i = None

        def on_step(self, i, state, metrics, stats):
            self.i = self.i or i

    first = First()
    train.main(["--dataset", "fb15k", "--model", "transe_l1", "--steps",
                str(RESUME_STEPS), "--log-every", "5", "--resume", *ckpt],
               hooks=[first])
    print(f"  resumed run's first step {first.i}, latest checkpoint "
          f"{latest_step(str(CKPT_DIR))}")
    check(first.i == MAIN_PATH_STEPS + 1, "the resumed run did not start after step 200")
    check(latest_step(str(CKPT_DIR)) == RESUME_STEPS, "the resumed run did not save")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    summary.update(eval_mrr=final[0], eval_mr=final[1], eval_hits10=final[4],
                   mrr_256_trained=mrr["trained"], mrr_256_fresh=mrr["fresh"],
                   ranks_card_cpu_equal=float((diff == 0).mean()),
                   queries_card_cpu_equal=queries)
    return launches, summary


# ---------------------------------------------------------------------------
# phases 8 and 9: LM serving of Qwen1.5-0.5B at full width
# ---------------------------------------------------------------------------
def run_qwen_prefill(torch, np, dev):
    """Phase 8. Returns (launches, summary, the models and weights phase 9
    reuses)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.layers import matmul
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model

    cfg = get_arch(QWEN)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), device=dev)  # f32
    cast = model.cast(params)  # once at load: bf16 matrices, f32 1-D norms
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                             PREFILL_SHAPE), device=dev)
    inputs = {"tokens": tok}
    flash = build_prefill_step(model, use_flash=True)

    # f32 first: the same weights in f32, where JAX's 2e-3 bound applies
    # between the routes; its flash logits are the yardstick of the bf16 ones
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    flash32 = build_prefill_step(model32, use_flash=True)
    build.reset_launches()
    truth = flash32(params, inputs)
    torch.cuda.synchronize()
    n32 = build.LAUNCHES["flash_attention"]
    chunked32 = build_prefill_step(model32, use_flash=False)(params, inputs)
    err32, ratio32 = logits_agree(torch, truth, chunked32, LM_TOL, LM_TOL)
    del chunked32
    print(f"  f32: {n32} flash launches; flash vs chunked route logits max_abs_err "
          f"{err32:.4e}, largest share of the 2e-3 bound {ratio32:.3f}")
    check(n32 == cfg.n_layers and bool(torch.isfinite(truth).all()) and ratio32 <= 1.0,
          "f32 flash and chunked prefill disagree")

    # the main path: the config's dtype
    build.reset_launches()
    logits = flash(cast, inputs)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.head_dim}, vocab {cfg.vocab_size}, dtype {cfg.dtype}; "
          f"weights drawn and cast in {init_s:.1f} s")
    print(f"  prefill {PREFILL_SHAPE}: logits {tuple(logits.shape)} {logits.dtype}, "
          f"{launches['flash_attention']} flash launches")
    check(launches["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times, not "
          f"{cfg.n_layers}, in one forward")
    check(tuple(logits.shape) == (*PREFILL_SHAPE, model.padded_vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    chunked = build_prefill_step(model, use_flash=False)(cast, inputs)
    err, _ = logits_agree(torch, logits, chunked, LM_TOL, LM_TOL)
    top1 = float((logits.argmax(-1) == chunked.argmax(-1)).float().mean())
    # each route's distance from the f32 logits of the same weights: bf16
    # rounding through 24 layers is far above 2e-3, so the kernel's route
    # is held to the reference's (chunked) route, not to a fixed bound
    e_flash, _ = logits_agree(torch, logits, truth, LM_TOL, LM_TOL)
    e_chunked, _ = logits_agree(torch, chunked, truth, LM_TOL, LM_TOL)
    del chunked
    print(f"  {cfg.dtype}: flash vs chunked route logits max_abs_err {err:.4e}, "
          f"argmax equal at {top1:.4%} of positions; distance from the f32 "
          f"logits: flash {e_flash:.4e}, chunked {e_chunked:.4e}")
    check(e_flash <= 2 * e_chunked,
          "the flash route is more than twice as far from f32 as the chunked one")
    del logits
    summary = dict(init_s=init_s, f32_flash_vs_chunked_err=err32,
                   f32_flash_vs_chunked_ratio=ratio32, flash_vs_chunked_err=err,
                   argmax_equal=top1, flash_from_f32_err=e_flash,
                   chunked_from_f32_err=e_chunked)
    del truth

    # speed: host clock around synchronised forwards, then one traced forward
    reps = 5
    for _ in range(2):
        flash(cast, inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        flash(cast, inputs)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / reps * 1e3
    tokens = PREFILL_SHAPE[0] * PREFILL_SHAPE[1]
    kern = trace_by_kernel(torch, lambda: flash(cast, inputs))
    dev_ms = sum(kern.values()) / 1e3
    flash_ms = sum(us for key, us in kern.items() if "flash_kernel" in key) / 1e3
    # cuBLAS's kernels: nvjet (this toolkit), gemm, cutlass
    mm_ms = sum(us for key, us in kern.items()
                if any(w in key for w in ("nvjet", "gemm", "cutlass"))) / 1e3
    # alone, between CUDA events: a ms-long kernel, and a profiler trace
    # may drop events
    hid = torch.randn(*PREFILL_SHAPE, cfg.d_model, device=dev).to(cast["unembed"].dtype)
    unembed_ms = event_ms(torch, lambda: matmul(hid, cast["unembed"]), reps=10)
    other_ms = dev_ms - flash_ms - mm_ms
    print(f"  prefill forward {fwd_ms:.2f} ms ({tokens / fwd_ms * 1e3:.0f} tokens/s); "
          f"device time {dev_ms:.2f} ms: flash kernel {flash_ms:.2f} ms "
          f"({flash_ms / dev_ms:.1%}), matmuls {mm_ms:.2f} ms ({mm_ms / dev_ms:.1%}; "
          f"the unembedding alone {unembed_ms:.2f} ms), elementwise and copies "
          f"{other_ms:.2f} ms ({other_ms / dev_ms:.1%})")
    print("  device time of the forward by kernel:")
    for key, us in sorted(kern.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.3f} ms  {key[:100]}")
    summary.update(forward_ms=fwd_ms, prefill_tokens_per_s=tokens / fwd_ms * 1e3,
                   device_ms=dev_ms, flash_ms=flash_ms, flash_share=flash_ms / dev_ms,
                   matmul_ms=mm_ms, other_ms=other_ms, unembed_ms=unembed_ms,
                   device_busy=dev_ms / fwd_ms)
    return launches, summary, (model, cast, flash, model32, params, flash32)


def run_serve(torch, np, dev, serve_args, counter, reuse, scaled_f32, files=None):
    """Phases 9 and 11: the serve CLI in process (it draws its weights from
    seed 0, as the prefill phase before it does); its decode launches no
    kernel. Then, in f32 from the same weights, its teacher-forced decode
    against the prefill of the same prompt through the ``counter`` kernel:
    within 2e-3 of each logit (atol and rtol; Qwen) or, with ``scaled_f32``,
    within 2e-3 x max(1, max|logit|) (Mamba2: its 64 stacked layers of
    random weights grow the activations). The CLI's own logits, in the
    config's dtype, are held like that dtype's prefill to their distance
    from the f32 logits. Last, decode tokens/s with the card synchronised.
    ``reuse`` is (model, cast weights, prefill, f32 model, f32 weights, f32
    prefill) from the prefill phase. With ``files`` (a directory) the CLI
    also writes ``--metrics-out`` and ``--trace-out`` there, which must pass
    the port's validators: a snapshot every 16 steps and a trace with the
    loop's step spans."""
    from repro_torch.common import telemetry
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    model, cast, prefill, model32, params32, prefill32 = reuse
    extra = []
    if files is not None:
        shutil.rmtree(files, ignore_errors=True)
        files.mkdir(parents=True)
        m_path, t_path = files / "m.jsonl", files / "t.json"
        extra = ["--metrics-out", str(m_path), "--trace-out", str(t_path)]
    tee = _Tee(sys.stdout)
    build.reset_launches()
    sys.stdout = tee
    try:
        gen, logits = serve.main([*serve_args, *extra])
        torch.cuda.synchronize()
    finally:
        sys.stdout = tee.out
    launches = dict(build.LAUNCHES)
    files_summary = None
    if files is not None:
        n_lines = telemetry.validate_metrics_jsonl(str(m_path), require=("engine/steps",))
        n_events = telemetry.validate_trace(str(t_path))
        last = json.loads(m_path.read_text().splitlines()[-1])
        steps = [e for e in json.loads(t_path.read_text())["traceEvents"]
                 if e.get("name") == "engine/step"]
        print(f"  {m_path.name}: {n_lines} snapshots, last at step {last['step']} "
              f"(engine/steps {last['counters'].get('engine/steps')}); {t_path.name}: "
              f"{n_events} events, {len(steps)} engine/step spans")
        files_summary = dict(snapshots=n_lines, trace_events=n_events)
        shutil.rmtree(files, ignore_errors=True)
    rate = re.findall(r"^(\d+) steps in (\S+)s -> (\S+) tok/s$", "".join(tee.parts), re.M)
    args = serve.build_parser().parse_args(serve_args)
    B, T, G = args.batch, args.prompt_len, args.gen
    check(len(rate) == 1 and int(rate[0][0]) == T + G, "no throughput line")
    if files is not None:
        check(n_lines == -(-(T + G) // 16) and last["step"] == T + G
              and last["counters"].get("engine/steps") == T + G
              and len(steps) == T + G, "the serve telemetry files miss steps")
    check(sum(launches.values()) == 0, f"the decode path launched kernels: {launches}")
    check(gen.shape == (B, G) and len(logits) == T + G
          and all(bool(torch.isfinite(lg).all()) for lg in logits),
          f"serve did not generate finite ({B}, {G}) tokens")

    prompt = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (B, T))
    pt = {"tokens": torch.as_tensor(prompt, device=dev)}
    _, logits32 = serve.generate(model32, params32, prompt, 0)  # f32 caches
    decoded = torch.cat(logits32, dim=1)
    del logits32
    build.reset_launches()
    truth = prefill32(params32, pt)
    torch.cuda.synchronize()
    n32 = build.LAUNCHES[counter]
    err32, ratio32 = logits_agree(torch, decoded, truth, LM_TOL, LM_TOL)
    del decoded
    if scaled_f32:
        ratio32 = err32 / (LM_TOL * max(1.0, float(truth.abs().max())))
        rule = "2e-3 x max(1, max|logit|)"
    else:
        rule = "2e-3 of each logit"
    print(f"  f32 teacher-forced decode vs {counter} prefill ({n32} launches): "
          f"max_abs_err {err32:.4e}, largest share of the bound ({rule}) {ratio32:.3f}")
    check(n32 == model.cfg.n_layers and ratio32 <= 1.0,
          f"f32 teacher-forced decode and {counter} prefill disagree")
    # the CLI's own logits: held, like the prefill of the same prompt in the
    # same dtype, to their distance from the f32 logits
    served = torch.cat(logits[:T], dim=1)
    pre = prefill(cast, pt)
    err, _ = logits_agree(torch, served, pre, LM_TOL, LM_TOL)
    top1 = float((served.argmax(-1) == pre.argmax(-1)).float().mean())
    e_dec, _ = logits_agree(torch, served, truth, LM_TOL, LM_TOL)
    e_pre, _ = logits_agree(torch, pre, truth, LM_TOL, LM_TOL)
    print(f"  {model.cfg.dtype} teacher-forced decode vs {counter} prefill: max_abs_err "
          f"{err:.4e}, argmax equal at {top1:.2%}; distance from the f32 logits: "
          f"decode {e_dec:.4e}, prefill {e_pre:.4e}")
    check(e_dec <= 2 * e_pre,
          "the decode path is more than twice as far from f32 as the prefill")

    # decode speed with the card synchronised: the whole loop, host clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, _ = serve.generate(model, cast, prompt, G)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    print(f"  CLI line: {rate[0][0]} steps in {rate[0][1]} s -> {rate[0][2]} tok/s; "
          f"synchronised loop of {T + G} steps {loop_s * 1e3:.1f} ms "
          f"({loop_s / (T + G) * 1e3:.2f} ms a step, {B * (T + G) / loop_s:.0f} tok/s); "
          f"the same tokens as the CLI's: {bool(np.array_equal(again, gen))}")
    summary = dict(cli_tok_per_s=float(rate[0][2]), step_ms=loop_s / (T + G) * 1e3,
                   decode_tok_per_s=B * (T + G) / loop_s,
                   f32_decode_vs_prefill_err=err32, f32_decode_vs_prefill_ratio=ratio32,
                   decode_vs_prefill_err=err, argmax_equal=top1,
                   decode_from_f32_err=e_dec, prefill_from_f32_err=e_pre)
    if files_summary is not None:
        summary["telemetry_files"] = files_summary
    return launches, summary


# ---------------------------------------------------------------------------
# phases 10 and 11: LM serving of Mamba2-2.7B at full width
# ---------------------------------------------------------------------------
def run_mamba_prefill(torch, np, dev):
    """Phase 10. Returns (launches, summary, the models and weights phase 11
    reuses)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model

    cfg = get_arch(MAMBA)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), device=dev)  # f32
    cast = model.cast(params)  # once at load: bf16, the stacked 1-D params too
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                             PREFILL_SHAPE), device=dev)
    inputs = {"tokens": tok}
    prefill = build_prefill_step(model)
    build.reset_launches()
    logits = prefill(cast, inputs)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_inner "
          f"{cfg.d_inner}, {cfg.n_mamba_heads} SSD heads of {cfg.mamba_headdim}, state "
          f"{cfg.ssm_state}, vocab {cfg.vocab_size}, dtype {cfg.dtype}; weights drawn "
          f"and cast in {init_s:.1f} s")
    print(f"  prefill {PREFILL_SHAPE}: logits {tuple(logits.shape)} {logits.dtype}, "
          f"{launches['ssd_scan']} ssd_scan launches, {launches['flash_attention']} "
          f"flash launches")
    check(launches["ssd_scan"] == cfg.n_layers and launches["flash_attention"] == 0,
          f"ssd_scan launched {launches['ssd_scan']} times (flash "
          f"{launches['flash_attention']}), not {cfg.n_layers}, in one forward")
    check(tuple(logits.shape) == (*PREFILL_SHAPE, model.padded_vocab)
          and logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all()),
          "prefill logits not finite bf16 of the padded vocab")
    del logits

    # speed: host clock around synchronised forwards, then one traced forward
    reps = 3
    prefill(cast, inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        prefill(cast, inputs)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / reps * 1e3
    tokens = PREFILL_SHAPE[0] * PREFILL_SHAPE[1]
    kern = trace_by_kernel(torch, lambda: prefill(cast, inputs))
    dev_ms = sum(kern.values()) / 1e3
    ssd_ms = sum(us for key, us in kern.items() if "ssd_kernel" in key) / 1e3
    mm_ms = sum(us for key, us in kern.items()
                if any(w in key for w in ("nvjet", "gemm", "cutlass"))) / 1e3
    other_ms = dev_ms - ssd_ms - mm_ms
    print(f"  prefill forward {fwd_ms:.2f} ms ({tokens / fwd_ms * 1e3:.0f} tokens/s); "
          f"device time {dev_ms:.2f} ms: ssd_scan kernel {ssd_ms:.2f} ms "
          f"({ssd_ms / dev_ms:.1%}), matmuls {mm_ms:.2f} ms ({mm_ms / dev_ms:.1%}), "
          f"elementwise and copies {other_ms:.2f} ms ({other_ms / dev_ms:.1%})")
    print("  device time of the forward by kernel:")
    for key, us in sorted(kern.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.3f} ms  {key[:100]}")
    summary = dict(init_s=init_s, forward_ms=fwd_ms,
                   prefill_tokens_per_s=tokens / fwd_ms * 1e3, device_ms=dev_ms,
                   ssd_ms=ssd_ms, ssd_share=ssd_ms / dev_ms, matmul_ms=mm_ms,
                   other_ms=other_ms, device_busy=dev_ms / fwd_ms)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    return launches, summary, (model, cast, prefill, model32, params,
                               build_prefill_step(model32))


# ---------------------------------------------------------------------------
# phase 12: Hogwild trainers on one card
# ---------------------------------------------------------------------------
def hogwild_cli(torch, np, model, n_trainers, steps, extra=(), hooks=()):
    """``train.main`` with ``--trainers n_trainers --samplers n_trainers``,
    launch counts set to 0 just before and read just after. Returns
    (launches, cfg, state, losses in step order, wall s incl. graph)."""
    from repro_torch.kernels import build
    from repro_torch.launch import engine, train

    metrics = engine.MetricsHook(("loss",))
    build.reset_launches()
    t0 = time.perf_counter()
    cfg, state = train.main(
        ["--dataset", "fb15k", "--model", model, "--steps", str(steps),
         "--trainers", str(n_trainers), "--samplers", str(n_trainers),
         "--log-every", "50", *extra], hooks=[metrics, *hooks])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    loss = np.asarray(metrics.history["loss"])
    check(state.step == steps and len(loss) == steps,
          f"{model} x{n_trainers}: state at step {state.step}, {len(loss)} hook "
          f"steps, not {steps}")
    check(np.isfinite(loss).all(), f"{model} x{n_trainers}: non-finite loss")
    check(bool(torch.isfinite(state.entity).all()), f"{model} x{n_trainers}: "
          "tables not finite")
    return launches, cfg, state, loss, wall


def check_hogwild_files(torch, launches, cfg, state, loss, metrics_path, trace_path):
    """Phase 12's checks on the 4-trainer TransE_l2 run and its files."""
    from repro_torch.common import telemetry

    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    print(f"  loss: first-10 mean {first:.4f} -> last-10 mean {last:.4f}; "
          f"launches {launches}")
    check(last < first, f"hogwild loss did not fall: {first} -> {last}")
    check(state.pend_ids is None, "hogwild ran with T5 on")
    for name in ("pairwise_l2sq", "dedup_aggregate", "fused_update"):
        check(launches[name] == 2 * HOGWILD_STEPS,
              f"{name} launched {launches[name]} times, not {2 * HOGWILD_STEPS}")
    n_lines = telemetry.validate_metrics_jsonl(
        str(metrics_path), require=("engine/steps", "runtime/steps"))
    n_events = telemetry.validate_trace(str(trace_path))
    snap = json.loads(metrics_path.read_text().splitlines()[-1])
    counters, hists = snap["counters"], snap["hists"]
    print(f"  {metrics_path.name}: {n_lines} snapshots, final counters {counters}, "
          f"staleness {hists.get('runtime/staleness')}")
    check(counters["runtime/steps"] == counters["engine/steps"] == HOGWILD_STEPS,
          f"step counters {counters.get('runtime/steps')} / "
          f"{counters.get('engine/steps')}, not {HOGWILD_STEPS}")
    doc = json.loads(trace_path.read_text())
    tracks = {e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M"}
    spans = {}  # name -> [count, total us]
    for e in doc["traceEvents"]:
        if e.get("ph") == "X":
            c = spans.setdefault(e["name"], [0, 0.0])
            c[0] += 1
            c[1] += e["dur"]
    span_us = {name: round(total / n, 1) for name, (n, total) in spans.items()}
    print(f"  {trace_path.name}: {n_events} events, tracks {sorted(tracks)}; "
          f"spans (count, mean us on the host clock) "
          f"{ {name: (n, span_us[name]) for name, (n, _) in spans.items()} }")
    check({f"trainer-{t}" for t in range(4)} <= tracks,
          f"trace lacks a trainer track: {sorted(tracks)}")
    check({"runtime/grad", "runtime/apply", "runtime/wait_batch"} <= set(spans),
          f"trace lacks a runtime span: {sorted(spans)}")
    return dict(loss_first10=first, loss_last10=last, snapshots=n_lines,
                trace_events=n_events, stale_steps=counters.get("runtime/stale_steps", 0.0),
                staleness=hists.get("runtime/staleness"), span_mean_us=span_us)


def check_two_phase(torch, np, dev, kg):
    """On the card, from the same tables and batches with T5 off:
    ``grad_step`` + ``apply_step`` against ``train_step`` bit for bit
    (TransE_l2, TransE_l1); then the staleness contract (JAX's
    tests/test_runtime.py): A and B read the same tables, A applies, B's
    stale gradient applies onto A's result; rows only A touched keep A's
    update, rows only B touched move."""
    from repro_torch.core import kge_model as K
    from repro_torch.core.sampling import JointSampler

    for model in ("transe_l2", "transe_l1"):
        cfg = fb15k_config(kg, model)
        sampler = JointSampler(kg.train, cfg.n_entities, cfg, np.random.default_rng(2))
        one = K.init_state(cfg, torch.Generator().manual_seed(2), device=dev)
        two = K.state_from_arrays(cfg, K.state_to_arrays(one), device=dev)
        grad_fn, apply_fn = K.make_hogwild_step(cfg)
        same_loss = True
        for _ in range(3):
            batch = K.batch_to_device(sampler.sample(), dev)
            one, m1 = K.train_step(cfg, one, batch)
            grads, m2 = grad_fn(two, batch)
            two = apply_fn(two, batch, grads)
            same_loss &= bool(torch.equal(m1["loss"], m2["loss"]))
        torch.cuda.synchronize()
        same = {name: bool(torch.equal(getattr(one, name), getattr(two, name)))
                for name in ("entity", "ent_gsq", "r_emb", "rel_gsq")}
        print(f"  {model}: grad_step + apply_step vs train_step, 3 steps: losses "
              f"equal {same_loss}, tables bit for bit {same}")
        check(same_loss and all(same.values()) and one.step == two.step == 3,
              f"{model}: the two-phase step differs from train_step")

    cfg = fb15k_config(kg, "transe_l2")
    sampler = JointSampler(kg.train, cfg.n_entities, cfg, np.random.default_rng(3))
    st = K.init_state(cfg, torch.Generator().manual_seed(3), device=dev)
    batch_a = K.batch_to_device(sampler.sample(), dev)
    batch_b = K.batch_to_device(sampler.sample(), dev)
    grads_a, _ = K.grad_step(cfg, st, batch_a)
    grads_b, _ = K.grad_step(cfg, st, batch_b)  # stale: A's apply comes first
    t0 = st.entity.clone()
    st = K.apply_step(cfg, st, batch_a, grads_a)
    t1 = st.entity.clone()
    st = K.apply_step(cfg, st, batch_b, grads_b)
    ws_a = K.dense_step_batch(batch_a)["ent_ids"].unique()
    ws_b = K.dense_step_batch(batch_b)["ent_ids"].unique()
    only_a = ws_a[~torch.isin(ws_a, ws_b)]
    only_b = ws_b[~torch.isin(ws_b, ws_a)]
    kept = bool(torch.equal(st.entity[only_a], t1[only_a]))
    a_moved = bool((t1[only_a] != t0[only_a]).any(1).all())
    b_moved = bool((st.entity[only_b] != t1[only_b]).any(1).all())
    print(f"  stale apply: {only_a.numel()} rows only A touched keep A's update "
          f"{kept} (all moved by A {a_moved}); {only_b.numel()} rows only B "
          f"touched all moved {b_moved}; step {st.step}")
    check(only_a.numel() > 0 and only_b.numel() > 0 and kept and a_moved and b_moved
          and st.step == 2, "the staleness contract does not hold on the card")


class TrainerWindow:
    """A hook for runs of several trainers: host-clock times of steps
    ``timed`` (the card synchronised at each), and a torch.profiler window
    (CUDA activity) opened and closed on the caller's thread (trainer 0) at
    its first steps past ``traced[0]`` and ``traced[1]``: ``window`` is
    (first step, last step, host clock at each)."""

    def __init__(self, torch, timed, traced):
        self.torch, self.timed, self.traced = torch, timed, traced
        self.t = {}
        self.prof = self.window = None

    def on_step(self, i, state, metrics, stats):
        torch = self.torch
        if i in self.timed:
            torch.cuda.synchronize()
            self.t[i] = time.perf_counter()
        if threading.current_thread() is not threading.main_thread():
            return
        a, b = self.traced
        if self.prof is None and i > a:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self.window = [i, None, time.perf_counter(), None]
        elif self.window is not None and self.window[1] is None and i > b:
            torch.cuda.synchronize()
            self.window[1], self.window[3] = i, time.perf_counter()
            self.prof.stop()

    def on_end(self, i, state):
        return None

    def step_ms(self):
        a, b = self.timed
        return (self.t[b] - self.t[a]) / (b - a) * 1e3

    def device(self):
        """(device ms a step in the window, busy share of the window, the
        window's wall ms, its kernels)."""
        check(self.window is not None and self.window[1] is not None,
              "the profiler window did not close")
        i0, i1, w0, w1 = self.window
        kern = [e for e in self.prof.key_averages() if _self_device_us(e) > 0]
        dev_ms = sum(_self_device_us(e) for e in kern) / 1e3
        return dev_ms / (i1 - i0), dev_ms / ((w1 - w0) * 1e3), (w1 - w0) * 1e3, kern


def hogwild_scaling(torch, np, n_trainers):
    """``n_trainers`` trainers and samplers, T5 off, HOGWILD_SCALING_STEPS
    steps: triplets/s over steps 51-200 (host clock between synchronises),
    then the card's busy share in a torch.profiler window (CUDA activity)
    opened and closed on trainer 0's thread, the caller's, at its first
    steps past 210 and 235. Returns (losses, summary)."""
    timed = TrainerWindow(torch, HOGWILD_TIMED, HOGWILD_TRACED)
    launches, cfg, state, loss, wall = hogwild_cli(
        torch, np, "transe_l2", n_trainers, HOGWILD_SCALING_STEPS,
        ["--no-overlap"], hooks=[timed])
    a, b = HOGWILD_TIMED
    step_ms = timed.step_ms()
    dev_step_ms, busy, window_ms, _ = timed.device()
    i0, i1 = timed.window[:2]
    rate = cfg.batch_size / step_ms * 1e3
    print(f"  {n_trainers} trainer(s), {n_trainers} sampler(s): {step_ms:.4f} ms a "
          f"step over steps {a + 1}..{b}, {rate:.0f} triplets/s; traced steps "
          f"{i0}..{i1}: device {dev_step_ms * 1e3:.1f} us a step, busy "
          f"{busy:.1%} of {window_ms:.1f} ms; whole run {wall:.1f} s; launches "
          f"pairwise_l2sq {launches['pairwise_l2sq']}, fused_update "
          f"{launches['fused_update']}")
    check(launches["pairwise_l2sq"] == 2 * HOGWILD_SCALING_STEPS,
          f"pairwise_l2sq launched {launches['pairwise_l2sq']} times")
    return loss, dict(step_ms=step_ms, triplets_per_s=rate, device_busy=busy,
                      device_us_per_step=dev_step_ms * 1e3,
                      traced_steps=[i0, i1], whole_run_s=wall)


def run_hogwild(torch, np, dev, kg):
    """Phase 12. Returns ({run: launches}, summary)."""
    shutil.rmtree(HOGWILD_DIR, ignore_errors=True)
    HOGWILD_DIR.mkdir(parents=True)
    m, t = HOGWILD_DIR / "m.jsonl", HOGWILD_DIR / "t.json"
    print(f"  4 trainers, 4 samplers, TransE_l2, {HOGWILD_STEPS} steps, "
          f"--metrics-out {m.relative_to(ROOT)} --trace-out {t.relative_to(ROOT)}")
    l2_launches, cfg, state, loss, wall = hogwild_cli(
        torch, np, "transe_l2", 4, HOGWILD_STEPS,
        ["--metrics-out", str(m), "--trace-out", str(t)])
    summary = dict(transe_l2_x4=check_hogwild_files(torch, l2_launches, cfg, state,
                                                    loss, m, t))
    summary["transe_l2_x4"]["whole_run_s"] = wall

    print(f"  2 trainers, 2 samplers, TransE_l1, {HOGWILD_L1_STEPS} steps")
    l1_launches, _, _, loss, _ = hogwild_cli(torch, np, "transe_l1", 2, HOGWILD_L1_STEPS)
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    print(f"  loss: first-10 mean {first:.4f} -> last-10 mean {last:.4f}; launches "
          f"{l1_launches}")
    check(last < first, f"hogwild TransE_l1 loss did not fall: {first} -> {last}")
    for name in ("pairwise_l1", "l1_bwd_pair"):
        check(l1_launches[name] == 2 * HOGWILD_L1_STEPS,
              f"{name} launched {l1_launches[name]} times, not {2 * HOGWILD_L1_STEPS}")
    summary["transe_l1_x2"] = dict(loss_first10=first, loss_last10=last)

    check_two_phase(torch, np, dev, kg)

    losses, scaling = {}, {}
    for n in (1, 2, 4):
        losses[n], scaling[n] = hogwild_scaling(torch, np, n)
    a, b = HOGWILD_STEPS - 30, HOGWILD_STEPS
    base, hog = float(losses[1][a:b].mean()), float(losses[4][a:b].mean())
    gap = abs(hog - base) / base
    print(f"  convergence: mean loss of steps {a + 1}..{b}, 1 trainer {base:.4f}, "
          f"4 trainers {hog:.4f}: {gap:.1%} apart (limit {HOGWILD_TOL:.0%}); "
          f"triplets/s x1 {scaling[1]['triplets_per_s']:.0f}, x2 "
          f"{scaling[2]['triplets_per_s']:.0f}, x4 {scaling[4]['triplets_per_s']:.0f}")
    check(gap < HOGWILD_TOL, f"4 trainers end {gap:.1%} from 1 trainer's loss")
    summary.update(scaling={f"x{n}": v for n, v in scaling.items()},
                   convergence=dict(loss_1=base, loss_4=hog, gap=gap))
    return {"hogwild_transe_l2": l2_launches, "hogwild_transe_l1": l1_launches}, summary


# ---------------------------------------------------------------------------
# phase 13: distributed training, a 1x1 NCCL world on the card
# ---------------------------------------------------------------------------
DIST_TABLES = ("entity", "ent_gsq", "r_emb", "rel_gsq", "shared_rel", "shared_gsq",
               "pend_grads")
DIST_BUFFERS = ("pf_ent_ws", "pf_rel_ws", "co_grads")  # pipelined I/O (phase 14)


def dist_case(np, model, pipeline_depth=0, push_every=1):
    """Phase 13's agreement case: ``model`` at dim 400, batch 256, k 64 and
    lr 0.05 on a small synthetic graph, n_parts 1: (prog, initial global
    arrays, DIST_AGREEMENT_STEPS DistBatches, one more to prefetch at
    depth 1). Phase 14 passes the pipelined program's flags."""
    import dataclasses

    from repro_torch.core import distributed as D
    from repro_torch.core.graph_part import partition
    from repro_torch.core.rel_part import relation_partition
    from repro_torch.core.sampling import DistSampler
    from repro_torch.data.kg_synth import fb15k_like

    kg = fb15k_like(scale=0.05, seed=1)
    cfg = dataclasses.replace(fb15k_config(kg, model), batch_size=256,
                              neg_sample_size=64, lr=0.05, n_parts=1)
    if pipeline_depth or push_every > 1:  # T5 off, as the CLI turns it off
        cfg = dataclasses.replace(cfg, overlap_update=False)
    book = partition(kg.train, cfg.n_entities, 1)
    rp = relation_partition(kg.rel_counts(), 1)
    prog = D.make_program(cfg, book.rows_per_part, rp.slots_per_part, rp.n_shared,
                          pipeline_depth=pipeline_depth, push_every=push_every)
    sampler = DistSampler(kg.train, book, rp, cfg, np.random.default_rng(1))
    return (prog, D.init_dist_arrays(prog, 1),
            [sampler.sample() for _ in range(DIST_AGREEMENT_STEPS + pipeline_depth)])


def dist_compare(np, what, got, want, lr):
    """Phase 4's rule on two ``run_batches`` results: (losses within 1e-5,
    {table: (max diff, share of entries off 1e-5)}, every table within the
    rule, pend ids equal). A pipelined state's prefetch and merge buffers
    count as tables, and its merge ids must be equal too."""
    (h_got, s_got), (h_want, s_want) = got, want
    l_got, l_want = [m["loss"] for m in h_got], [m["loss"] for m in h_want]
    if len(l_got) <= DIST_AGREEMENT_STEPS:
        print(f"  {what}: losses {l_got} vs {l_want}")
    else:
        print(f"  {what}: {len(l_got)} losses, the largest difference "
              f"{np.abs(np.subtract(l_got, l_want)).max():.3e}; the last "
              f"{l_got[-1]} vs {l_want[-1]}")
    tables = {}
    for name in DIST_TABLES + tuple(k for k in DIST_BUFFERS if k in s_want):
        diff = np.abs(s_got[name] - s_want[name])
        tables[name] = (float(diff.max()),
                        float((diff > 1e-5 + 1e-5 * np.abs(s_want[name])).mean()))
    print(f"  {what}: (max diff, share off) " + ", ".join(
        f"{name} ({most:.3e}, {off:.2e})" for name, (most, off) in tables.items()))
    return (np.allclose(l_got, l_want, rtol=1e-5, atol=1e-5), tables,
            all(off <= 1e-3 and most <= 2 * lr * DIST_AGREEMENT_STEPS
                for most, off in tables.values()),
            all(np.array_equal(s_got[k], s_want[k]) for k in ("pend_ids", "co_ids")
                if k in s_want))


def dist_agreement(torch, np, dev, model, gate=True, **prog_kw):
    """``run_batches`` of ``dist_case(model, **prog_kw)`` in a 1x1 world on
    the card (NCCL, kernels) and in a 1x1 gloo world on the CPU (plain
    versions), from one carried-over global state and one list of
    DistBatches; with ``gate``, phase 4's rule must hold."""
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import run_world

    prog, init, batches = dist_case(np, model, **prog_kw)
    what = f"dist {model}" + "".join(f" {k}={v}" for k, v in prog_kw.items())
    runs = {d: run_world(1, 1, D.run_batches, (prog, init, batches), device=d)
            for d in (dev, "cpu")}
    losses_ok, tables, tables_ok, ids_ok = dist_compare(
        np, f"{what} card vs cpu", runs[dev], runs["cpu"], prog.cfg.lr)
    if gate:
        check(losses_ok, f"{what}: card and CPU losses disagree")
        check(tables_ok, f"{what}: card and CPU tables disagree")
        check(ids_ok, f"{what}: card and CPU pend or merge ids differ")
    return {name: dict(max_diff=most, share_off=off)
            for name, (most, off) in tables.items()}


def dist_sum_order_witness(np, model):
    """What phase 4's rule reads between two CPU runs of ``dist_case(model)``
    that differ only in the order of the batch's triplets (the same loss
    function, its sums taken in another order). Returns the largest share
    off."""
    import dataclasses

    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import run_world

    prog, init, batches = dist_case(np, model)
    perm = np.random.default_rng(0).permutation(prog.cfg.batch_size)
    shuffled = [dataclasses.replace(db, **{k: getattr(db, k)[:, perm] for k in
                                           ("h_slot", "t_slot", "rel_slot",
                                            "rel_shared")}) for db in batches]
    runs = [run_world(1, 1, D.run_batches, (prog, init, b), device="cpu")
            for b in (batches, shuffled)]
    _, tables, _, _ = dist_compare(np, f"dist {model} cpu vs cpu, triplets permuted",
                                   runs[1], runs[0], prog.cfg.lr)
    return max(off for _, off in tables.values())


def dist_checkpoint_holds(np, dev, cfg, final, ckpt_dir, **prog_kw):
    """Phases 13-15: the checkpoint of step MAIN_PATH_STEPS holds the final
    global state (the reference's keys, shapes and dtypes) bit for bit and
    restores in a 1x1 world on the card bit for bit. ``prog_kw`` are the
    program's pipelining flags. Returns (the saved arrays, held, restored)."""
    from repro_torch.common.checkpoint import restore_checkpoint
    from repro_torch.core import distributed as D
    from repro_torch.core.graph_part import partition
    from repro_torch.core.rel_part import relation_partition
    from repro_torch.data.kg_synth import fb15k_like
    from repro_torch.launch.mesh import run_world

    saved = ckpt_dir / f"step_{MAIN_PATH_STEPS:010d}"
    files = {p.stem: np.load(p) for p in saved.glob("*.npy")}
    kg = fb15k_like(scale=1.0, seed=0)
    book = partition(kg.train, cfg.n_entities, 1)
    rp = relation_partition(kg.rel_counts(), 1)
    prog = D.make_program(cfg, book.rows_per_part, rp.slots_per_part, rp.n_shared,
                          **prog_kw)
    like = {k: np.zeros(shape, dt) for k, (shape, dt) in prog.state_shapes().items()}

    def restore_on_card(grid):
        arrays = restore_checkpoint(str(ckpt_dir), like, step=MAIN_PATH_STEPS)
        return D.gather_dist_state(prog, grid, D.dist_state_from_arrays(prog, grid, arrays))

    def equal(x, y):
        return set(x) == set(y) and all(
            np.asarray(x[k]).dtype == np.asarray(y[k]).dtype
            and np.array_equal(x[k], y[k]) for k in x)

    held = equal(files, final) and set(files) == set(like)
    restored = equal(run_world(1, 1, restore_on_card, device=dev), final)
    print(f"  {saved.name} holds the final state bit for bit: {held} "
          f"({sorted(files)}); restored on the card bit for bit: {restored}")
    return files, held, restored


def resumed_first_step(argv, ckpt_dir):
    """``train.main(argv)`` (a ``--resume`` run); the first step it ran,
    checked to be the one after MAIN_PATH_STEPS, and its save checked to be
    the latest checkpoint."""
    from repro_torch.common.checkpoint import latest_step
    from repro_torch.launch import engine, train

    class First(engine.Hook):
        i = None

        def on_step(self, i, state, metrics, stats):
            self.i = self.i or i

    first = First()
    train.main(argv, hooks=[first])
    latest = latest_step(str(ckpt_dir))
    print(f"  resumed run's first step {first.i}, latest checkpoint {latest}")
    check(first.i == MAIN_PATH_STEPS + 1, "the resumed run did not start after step 200")
    check(latest == RESUME_STEPS, "the resumed run did not save")
    return first.i


def run_distributed(torch, np, dev):
    """Phase 13. Returns ({run: launches}, summary)."""
    from repro_torch.kernels import build
    from repro_torch.launch import engine, train

    base = ["--distributed", "--mesh", "1x1"]
    try:
        train.main(["--dataset", "fb15k", "--distributed", "--mesh", "2x2", "--steps", "1"])
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    print(f"  --mesh 2x2 on {torch.cuda.device_count()} card(s): {refused!r}")
    check("needs 4 CUDA devices" in refused, "a 2x2 CUDA world was not refused")

    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    ckpt_dir, m_path = DIST_DIR / "ckpt", DIST_DIR / "m.jsonl"
    ckpt = ["--ckpt-dir", str(ckpt_dir), "--save-every", "100"]
    print(f"  TransE_l2, {MAIN_PATH_STEPS} steps, {' '.join(base)} {' '.join(ckpt)} "
          f"--metrics-out {m_path.relative_to(ROOT)}")
    l2_launches, summary, cfg, final, out = run_path(
        torch, np, "transe_l2", [*base, *ckpt, "--metrics-out", str(m_path)], 100)
    check_launched(l2_launches, ("pairwise_l2sq", "dedup_aggregate", "fused_update"),
                   MAIN_PATH_STEPS)
    cut = re.findall(r"partitioner=(\S+) cut=(\S+)", out)
    check(cut == [("metis", "0.000")], f"partitioner line {cut}")
    snap = json.loads(m_path.read_text().splitlines()[-1])
    kv = {k: v for k, v in {**snap["counters"], **snap["gauges"]}.items()
          if k.startswith("kvstore/")}
    print(f"  kvstore counters at step {snap.get('step')}: {kv}")
    summary["kvstore"] = kv

    # the checkpoint of step 200 holds the final global state, under the
    # reference's keys, and restores in a 1x1 world on the card bit for bit
    _, held, restored = dist_checkpoint_holds(np, dev, cfg, final, ckpt_dir)
    check(held and restored, "the distributed checkpoint does not hold or restore "
          "the final state")
    resumed_first_step(["--dataset", "fb15k", "--model", "transe_l2", *base, "--steps",
                        str(RESUME_STEPS), "--log-every", "5", "--resume", *ckpt],
                       ckpt_dir)

    print(f"  TransE_l1, {DIST_L1_STEPS} steps, {' '.join(base)}")
    metrics = engine.MetricsHook(("loss",))
    build.reset_launches()
    train.main(["--dataset", "fb15k", "--model", "transe_l1", *base, "--steps",
                str(DIST_L1_STEPS), "--log-every", "25"], hooks=[metrics])
    torch.cuda.synchronize()
    l1_launches = dict(build.LAUNCHES)
    loss = np.asarray(metrics.history["loss"])
    first10, last10 = float(loss[:10].mean()), float(loss[-10:].mean())
    print(f"  loss: first-10 mean {first10:.4f} -> last-10 mean {last10:.4f}; "
          f"launches {l1_launches}")
    check(np.isfinite(loss).all() and last10 < first10,
          f"dist TransE_l1 loss did not fall: {first10} -> {last10}")
    check_launched(l1_launches, ("pairwise_l1", "l1_bwd_pair", "dedup_aggregate",
                                 "fused_update"), DIST_L1_STEPS)

    print(f"  card (NCCL) vs CPU (gloo), 1x1 worlds, {DIST_AGREEMENT_STEPS} dim-400 "
          "steps at batch 256, k 64, lr 0.05")
    summary["agreement"] = {m: dist_agreement(torch, np, dev, m)
                            for m in ("transe_l2", "distmult")}
    # TransE_l1's gradient is a sum of signs: a last-bit change flips terms,
    # and two CPU runs whose sums differ only in order already part beyond
    # the rule (checked here); its card reading is printed, not gated
    summary["agreement"]["transe_l1"] = dist_agreement(torch, np, dev, "transe_l1",
                                                       gate=False)
    floor = dist_sum_order_witness(np, "transe_l1")
    summary["transe_l1_cpu_order_floor"] = floor
    check(floor > 1e-3, "dist transe_l1: two CPU runs agree within phase 4's rule "
          f"({floor:.2e} off), so the card should be gated on it")
    summary["transe_l1"] = dict(loss_first10=first10, loss_last10=last10)
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return {"dist_transe_l2": l2_launches, "dist_transe_l1": l1_launches}, summary


# ---------------------------------------------------------------------------
# phase 14: pipelined KVStore I/O, a 1x1 NCCL world on the card
# ---------------------------------------------------------------------------
def merge_time(torch, dev):
    """The coalesced push's merge of one step at phase 14's shapes (one
    peer, Ck = 4,096 buffered slots, Rp = 2,048 arriving, D = 400), by
    kernel, printed and not gated: the sort-based route of the reference
    runs as plain PyTorch ops, no hand-written kernel. Half the buffer
    holds unique rows and half the arrivals are pads, as a world of
    several machines would send."""
    from repro_torch.embeddings.store import _coalesce_remote

    gen = torch.Generator().manual_seed(7)
    ck, rp, D, rows = 4096, 2048, 400, 14952
    co_ids = torch.full((1, ck), -1, dtype=torch.int32)
    co_ids[0, :ck // 2] = torch.randperm(rows, generator=gen)[:ck // 2].to(torch.int32)
    co_grads = torch.randn(1, ck, D, generator=gen) * (co_ids >= 0).unsqueeze(-1)
    req = torch.randint(0, rows, (1, rp), generator=gen, dtype=torch.int32)
    req[torch.rand(1, rp, generator=gen) < 0.5] = -1
    g = torch.randn(1, rp, D, generator=gen)
    co_ids, co_grads, req, g = (x.to(dev) for x in (co_ids, co_grads, req, g))

    def merge():  # on copies: every call merges into the same buffer
        _coalesce_remote(co_ids.clone(), co_grads.clone(), req, g)

    by_kernel = {k: us / 20 for k, us in trace_by_kernel(torch, merge, 20).items()}
    total = sum(by_kernel.values())
    print(f"  the merge of one step (sort-based, 6,144 x {D} rows in, {ck} kept): "
          f"device {total:.1f} us a call (two buffer copies included), "
          f"{event_ms(torch, merge, 20) * 1e3:.1f} us by CUDA events; by kernel:")
    for k, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us:8.2f} us  {k[:90]}")
    return dict(device_us=total, by_kernel=by_kernel)


def run_pipelined(torch, np, dev, eager):
    """Phase 14, beside phase 13's summary ``eager``. Returns ({run:
    launches}, summary)."""
    from repro_torch.kernels import build
    from repro_torch.launch import engine, train

    base = ["--distributed", "--mesh", "1x1", "--pipeline-depth", "1"]
    k = PIPE_PUSH_EVERY
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    PIPE_DIR.mkdir(parents=True)
    ckpt_dir, m_path = PIPE_DIR / "ckpt", PIPE_DIR / "m.jsonl"
    ckpt = ["--ckpt-dir", str(ckpt_dir), "--save-every", "100"]
    print(f"  TransE_l2, {MAIN_PATH_STEPS} steps, {' '.join(base)} --push-every {k} "
          f"{' '.join(ckpt)} --metrics-out {m_path.relative_to(ROOT)}")
    launches, summary, cfg, final, out = run_path(
        torch, np, "transe_l2",
        [*base, "--push-every", str(k), *ckpt, "--metrics-out", str(m_path)], 100)
    check("pipelined KVStore I/O: T5 overlap off" in out, "no T5-off line")
    flushes = MAIN_PATH_STEPS // k
    want = {"pairwise_l2sq": 2 * MAIN_PATH_STEPS,
            "dedup_aggregate": 2 * MAIN_PATH_STEPS + flushes,
            "fused_update": 2 * MAIN_PATH_STEPS + flushes}
    got = {name: n for name, n in launches.items() if n}
    print(f"  launches {got}, expected exactly {want}")
    check(got == want, f"pipelined launches {got} != {want}")
    snap = json.loads(m_path.read_text().splitlines()[-1])
    kv = {name: v for name, v in {**snap["counters"], **snap["gauges"]}.items()
          if name.startswith("kvstore/")}
    print(f"  kvstore counters at step {snap.get('step')}: {kv}")
    check(kv.get("kvstore/coalesced_push_flushes") == flushes,
          f"{kv.get('kvstore/coalesced_push_flushes')} flushes, not {flushes}")
    check(kv.get("kvstore/prefetch_rows", 0) > 0, "no kvstore/prefetch_rows")
    summary["kvstore"] = kv
    for what, run in (("pipelined", summary), ("eager (phase 13)", eager)):
        print(f"  {what}: step {run['step_ms']:.4f} ms, device "
              f"{run['device_ms_per_step'] * 1e3:.1f} us a step, idle "
              f"{1 - run['device_busy']:.1%}")
    summary["eager"] = {name: eager[name] for name in
                        ("step_ms", "device_ms_per_step", "device_busy")}
    summary["merge"] = merge_time(torch, dev)

    # the checkpoint of step 200 (after its flush: merge ids all pads)
    # holds the final global state and restores on the card bit for bit
    _, held, restored = dist_checkpoint_holds(np, dev, cfg, final, ckpt_dir,
                                              pipeline_depth=1, push_every=k)
    pads = bool((final["co_ids"] == -1).all())
    print(f"  merge ids all pads: {pads}")
    check(held and restored and pads, "the pipelined checkpoint does not hold or "
          "restore the final state")
    resumed_first_step(["--dataset", "fb15k", "--model", "transe_l2", *base,
                        "--push-every", str(k), "--steps", str(RESUME_STEPS),
                        "--log-every", "5", "--resume", *ckpt], ckpt_dir)

    print(f"  TransE_l1, {DIST_L1_STEPS} steps, {' '.join(base)} --push-every 2")
    metrics = engine.MetricsHook(("loss",))
    build.reset_launches()
    train.main(["--dataset", "fb15k", "--model", "transe_l1", *base, "--push-every", "2",
                "--steps", str(DIST_L1_STEPS), "--log-every", "25"], hooks=[metrics])
    torch.cuda.synchronize()
    l1_launches = dict(build.LAUNCHES)
    loss = np.asarray(metrics.history["loss"])
    first10, last10 = float(loss[:10].mean()), float(loss[-10:].mean())
    print(f"  loss: first-10 mean {first10:.4f} -> last-10 mean {last10:.4f}; "
          f"launches {l1_launches}")
    check(np.isfinite(loss).all() and last10 < first10,
          f"pipelined TransE_l1 loss did not fall: {first10} -> {last10}")
    for name in ("pairwise_l1", "l1_bwd_pair"):
        check(l1_launches[name] == 2 * DIST_L1_STEPS,
              f"{name} launched {l1_launches[name]} times in {DIST_L1_STEPS} steps")

    print(f"  card (NCCL) vs CPU (gloo), 1x1 worlds, {DIST_AGREEMENT_STEPS} dim-400 "
          "steps at batch 256, k 64, lr 0.05, --pipeline-depth 1 --push-every 2")
    pipe = dict(pipeline_depth=1, push_every=2)
    summary["agreement"] = {m: dist_agreement(torch, np, dev, m, **pipe)
                            for m in ("transe_l2", "distmult")}
    # TransE_l1 printed, not gated: phase 13's reason
    summary["agreement"]["transe_l1"] = dist_agreement(torch, np, dev, "transe_l1",
                                                       gate=False, **pipe)
    summary["transe_l1"] = dict(loss_first10=first10, loss_last10=last10)
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    return {"pipe_transe_l2": launches, "pipe_transe_l1": l1_launches}, summary


# ---------------------------------------------------------------------------
# phase 15: two trainers and two samplers in the 1x1 NCCL world
# ---------------------------------------------------------------------------
def dist_hogwild_cli(torch, np, n_trainers, steps, extra=(), hooks=()):
    """``train.main`` of phase 13's world with ``--trainers n_trainers
    --samplers 2``, launch counts set to 0 just before and read just after.
    Returns (launches, cfg, final global state, losses, wall s)."""
    from repro_torch.kernels import build
    from repro_torch.launch import engine, train

    metrics = engine.MetricsHook(("loss",))
    build.reset_launches()
    t0 = time.perf_counter()
    cfg, final = train.main(
        ["--dataset", "fb15k", "--model", "transe_l2", "--distributed", "--mesh", "1x1",
         "--trainers", str(n_trainers), "--samplers", "2", "--steps", str(steps),
         "--log-every", "50", *extra], hooks=[metrics, *hooks])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    loss = np.asarray(metrics.history["loss"])
    check(int(final["step"]) == steps and len(loss) == steps,
          f"x{n_trainers}: final step {final['step']}, {len(loss)} hook steps")
    check(np.isfinite(loss).all() and np.isfinite(final["entity"]).all(),
          f"x{n_trainers}: non-finite loss or tables")
    return launches, cfg, final, loss, wall


def ordered_batches(grid, prog, arrays, batches):
    """``run_batches``'s contract through the runtime's ordered mode: two
    trainers, two samplers, sampler w giving ``batches[w::2]``, so step t
    takes batch t. Returns (each step's metrics as floats, the global final
    state on rank 0)."""
    from repro_torch.core import distributed as D
    from repro_torch.launch import engine

    def factory(wid):
        own = iter(batches[wid::2] * 2)  # more than the loop takes
        return lambda: (D.batch_to_rank(next(own), grid), None)

    history = []

    class Record(engine.Hook):
        def on_step(self, i, state, metrics, stats):
            history.append({k: float(v) for k, v in metrics.items()})

    state = engine.train_loop(
        D.build_dist_train_step(prog, grid), D.dist_state_from_arrays(prog, grid, arrays),
        None, len(batches), hooks=[Record()], n_trainers=2, n_samplers=2,
        sampler_factory=factory, ordered=True)
    return history, D.gather_dist_state(prog, grid, state)


def run_dist_hogwild(torch, np, dev, eager, eager_launches):
    """Phase 15, beside phase 13's summary ``eager`` and launches
    ``eager_launches``. Returns ({run: launches}, summary)."""
    from repro_torch.common import telemetry
    from repro_torch.launch.mesh import run_world

    shutil.rmtree(DIST_HOG_DIR, ignore_errors=True)
    DIST_HOG_DIR.mkdir(parents=True)
    ckpt_dir = DIST_HOG_DIR / "ckpt"
    m_path, t_path = DIST_HOG_DIR / "m.jsonl", DIST_HOG_DIR / "t.json"
    ckpt = ["--ckpt-dir", str(ckpt_dir), "--save-every", "100"]
    files = ["--metrics-out", str(m_path), "--trace-out", str(t_path)]
    print(f"  TransE_l2, {MAIN_PATH_STEPS} steps, --distributed --mesh 1x1 --trainers 2 "
          f"--samplers 2 {' '.join(ckpt)} --metrics-out {m_path.relative_to(ROOT)} "
          f"--trace-out {t_path.relative_to(ROOT)}")
    window = TrainerWindow(torch, DIST_HOG_TIMED, DIST_HOG_TRACED)
    launches, cfg, final, loss, wall = dist_hogwild_cli(
        torch, np, 2, MAIN_PATH_STEPS, [*ckpt, *files], hooks=[window])
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    got = {name: n for name, n in launches.items() if n}
    want = {name: n for name, n in eager_launches.items() if n}
    print(f"  loss: first-10 mean {first:.4f} -> last-10 mean {last:.4f}; launches "
          f"{got}, phase 13's {want}; T5 {cfg.overlap_update}")
    check(last < first, f"dist hogwild loss did not fall: {first} -> {last}")
    check(cfg.overlap_update, "T5 turned off")
    check(got.get("pairwise_l2sq") == 2 * MAIN_PATH_STEPS and got == want,
          f"dist hogwild launches {got}, not phase 13's {want}")

    step_ms = window.step_ms()
    dev_step_ms, busy, window_ms, kern = window.device()
    i0, i1 = window.window[:2]
    summary = dict(step_ms=step_ms, device_ms_per_step=dev_step_ms, device_busy=busy,
                   triplets_per_s=cfg.batch_size / step_ms * 1e3, traced_steps=[i0, i1],
                   loss_first10=first, loss_last10=last, whole_run_s=wall)
    a, b = DIST_HOG_TIMED
    for what, run in (("2 trainers, 2 samplers", summary), ("eager (phase 13)", eager)):
        print(f"  {what}: step {run['step_ms']:.4f} ms, device "
              f"{run['device_ms_per_step'] * 1e3:.1f} us a step, idle "
              f"{1 - run['device_busy']:.1%}")
    print(f"  (steps {a + 1}..{b} on the host clock; traced steps {i0}..{i1}, "
          f"{window_ms:.1f} ms; whole run {wall:.1f} s incl. graph generation)")
    print("  device time a step by kernel:")
    for e in sorted(kern, key=_self_device_us, reverse=True)[:8]:
        print(f"    {_self_device_us(e) / (i1 - i0):9.2f} us  "
              f"x{e.count / (i1 - i0):4.1f}  {e.key[:90]}")

    n_lines = telemetry.validate_metrics_jsonl(
        str(m_path), require=("engine/steps", "runtime/steps"))
    n_events = telemetry.validate_trace(str(t_path))
    counters = json.loads(m_path.read_text().splitlines()[-1])["counters"]
    events = json.loads(t_path.read_text())["traceEvents"]
    tracks = {e["args"]["name"] for e in events if e.get("ph") == "M"}
    spans = {e["name"] for e in events if e.get("ph") == "X"}
    print(f"  {m_path.name}: {n_lines} snapshots, runtime/steps "
          f"{counters.get('runtime/steps')}, engine/steps {counters.get('engine/steps')}; "
          f"{t_path.name}: {n_events} events, tracks {sorted(tracks)}, spans "
          f"{sorted(spans)}")
    check(counters.get("runtime/steps") == counters.get("engine/steps") == MAIN_PATH_STEPS,
          "the step counters of the metrics file")
    check({"trainer-0", "trainer-1", "sampler-0", "sampler-1"} <= tracks,
          f"trace lacks a trainer or sampler track: {sorted(tracks)}")
    check({"runtime/step", "runtime/wait_batch", "runtime/wait_turn"} <= spans,
          f"trace lacks a runtime span: {sorted(spans)}")
    summary.update(snapshots=n_lines, trace_events=n_events)

    _, held, restored = dist_checkpoint_holds(np, dev, cfg, final, ckpt_dir)
    check(held and restored, "the checkpoint does not hold or restore the final state")
    resumed_first_step(["--dataset", "fb15k", "--model", "transe_l2", "--distributed",
                        "--mesh", "1x1", "--trainers", "2", "--samplers", "2", "--steps",
                        str(RESUME_STEPS), "--log-every", "5", "--resume", *ckpt],
                       ckpt_dir)

    print(f"  the same world with --trainers 1 --samplers 2 (the same batch order), "
          f"{MAIN_PATH_STEPS} steps")
    one_window = TrainerWindow(torch, DIST_HOG_TIMED, DIST_HOG_TRACED)
    _, _, one, one_loss, _ = dist_hogwild_cli(torch, np, 1, MAIN_PATH_STEPS,
                                              hooks=[one_window])
    one_dev_ms, one_busy, _, _ = one_window.device()
    summary["one_trainer"] = dict(step_ms=one_window.step_ms(),
                                  device_ms_per_step=one_dev_ms, device_busy=one_busy)
    print(f"  1 trainer, 2 samplers: step {one_window.step_ms():.4f} ms, device "
          f"{one_dev_ms * 1e3:.1f} us a step, idle {1 - one_busy:.1%}")
    losses_ok, tables, tables_ok, ids_ok = dist_compare(
        np, "2 trainers vs 1", ([{"loss": float(v)} for v in loss], final),
        ([{"loss": float(v)} for v in one_loss], one), cfg.lr)
    check(losses_ok and tables_ok and ids_ok,
          "2 trainers and 1 trainer on one batch order part beyond phase 4's rule")
    summary["vs_one_trainer"] = {name: dict(max_diff=most, share_off=off)
                                 for name, (most, off) in tables.items()}

    print(f"  card (NCCL) vs CPU (gloo), 1x1 worlds, 2 trainers and 2 samplers, "
          f"{DIST_AGREEMENT_STEPS} dim-400 steps at batch 256, k 64, lr 0.05")
    summary["agreement"] = {}
    for model in ("transe_l2", "distmult"):
        prog, init, batches = dist_case(np, model)
        runs = {d: run_world(1, 1, ordered_batches, (prog, init, batches), device=d)
                for d in (dev, "cpu")}
        losses_ok, tables, tables_ok, ids_ok = dist_compare(
            np, f"dist hogwild {model} card vs cpu", runs[dev], runs["cpu"], prog.cfg.lr)
        check(losses_ok and tables_ok and ids_ok,
              f"dist hogwild {model}: card and CPU disagree")
        summary["agreement"][model] = {name: dict(max_diff=most, share_off=off)
                                       for name, (most, off) in tables.items()}
    shutil.rmtree(DIST_HOG_DIR, ignore_errors=True)
    return {"hogwild_dist_transe_l2": launches}, summary


# ---------------------------------------------------------------------------
# phases 16-18: the MoE layer at full width (Mixtral-8x7B, DBRX, Jamba)
# ---------------------------------------------------------------------------
def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def moe_world_body(grid, cfg, params, inputs, use_flash, reps=0):
    """In a world of one rank: the forward of ``cfg`` with the grid, so
    that every MoE layer takes the capacity-bounded route over the grid's
    model group. Returns (logits, expert choices of each MoE layer, timing
    of ``reps`` more forwards through the prefill step, or None)."""
    import torch

    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model, forward_routes

    model = build_model(cfg, grid=grid)
    logits, sets = forward_routes(model, params, inputs, use_flash=use_flash)
    timed = None
    if reps:
        prefill = build_prefill_step(model, use_flash=use_flash)
        timed = time_prefill(torch, grid.device, lambda: prefill(params, inputs), reps)
    return logits, sets, timed


def time_prefill(torch, dev, fn, reps):
    """(forward ms on the host clock around ``reps`` synchronised calls
    after one warm-up, device ms of one traced call, {flash, ssd_scan,
    gemm, other: device ms}, the top kernels)."""
    fn()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(torch, dev)
    fwd_ms = (time.perf_counter() - t0) / reps * 1e3
    kern = trace_by_kernel(torch, fn)
    dev_ms = sum(kern.values()) / 1e3
    groups = {"flash": ("flash_kernel",), "ssd_scan": ("ssd_kernel",),
              "gemm": ("nvjet", "gemm", "cutlass")}  # cuBLAS's kernels
    split = {g: sum(us for key, us in kern.items() if any(w in key for w in words)) / 1e3
             for g, words in groups.items()}
    split["other"] = dev_ms - sum(split.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    return fwd_ms, dev_ms, split, top


def _print_timed(label, tokens, timed):
    fwd_ms, dev_ms, split, top = timed
    print(f"  {label}: forward {fwd_ms:.2f} ms ({tokens / fwd_ms * 1e3:.0f} tokens/s); "
          f"device {dev_ms:.2f} ms: " + ", ".join(
              f"{g} {ms:.2f} ms ({ms / dev_ms:.1%})" for g, ms in split.items()))
    for key, us in top:
        print(f"    {us / 1e3:9.3f} ms  {key[:100]}")
    return dict(forward_ms=fwd_ms, prefill_tokens_per_s=tokens / fwd_ms * 1e3,
                device_ms=dev_ms, device_busy=dev_ms / fwd_ms,
                **{f"{g}_ms": ms for g, ms in split.items()},
                **{f"{g}_share": ms / dev_ms for g, ms in split.items()})


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def moe_model(torch, dev, arch, n_layers=None, **cut):
    """``arch`` at full width cut to ``n_layers`` (MOE_CUTS[arch] by
    default; stacked, as the config's ``scan_layers`` stacks them), its
    weights drawn on the card by
    a generator there, seeded 0, and cast once. The full configs stack
    every layer's norms and biases into 2-D tensors, which ``cast`` turns
    to the config's dtype with the matrices, so they compute in it; a cut
    whose pattern does not repeat (Jamba's five layers) stays unstacked,
    and its 1-D f32 parameters would promote every activation to f32
    (JAX's promotion), so there they are cast too, as the full config's
    are. Returns (model, the drawn weights, the cast ones, init seconds)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers or MOE_CUTS[arch], **cut)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    cast = model.cast(params)
    if model.n_groups == 1:
        cast = tree_map(lambda a: a.to(model.dtype) if a.dtype == torch.float32 else a,
                        cast)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in _leaves(params))
    kinds = [f"{k[0].value}/{k[1].value}" for k in model.kinds]
    if len(kinds) > 8:
        kinds = sorted(set(kinds))
    ffn = (f"{cfg.n_experts} experts top-{cfg.moe_top_k} of d_ff {cfg.d_ff}"
           if cfg.n_experts else f"d_ff {cfg.d_ff}")
    extra = (f", MLA q_lora {cfg.q_lora_rank} kv_lora {cfg.kv_lora_rank} rope "
             f"{cfg.rope_head_dim}" if cfg.attention.value == "mla" else "")
    if cfg.enc_dec:
        extra += (f", encoder of {cfg.n_encoder_layers} layers over {cfg.encoder_ctx} "
                  f"frames, cross-attention in every decoder layer")
    if cfg.n_frontend_tokens:
        extra += f", {cfg.n_frontend_tokens} patch positions"
    print(f"  {cfg.name} at {cfg.n_layers} of {get_arch(arch).n_layers} layers "
          f"({kinds}): "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} (kv "
          f"{cfg.n_kv_heads}){extra}, {ffn}, window "
          f"{cfg.window if cfg.attention.value == 'swa' else 0}, vocab {cfg.vocab_size}; "
          f"{n / 1e9:.2f} B parameters, param_dtype {cfg.param_dtype}, dtype "
          f"{cfg.dtype}; drawn on the card and cast in {init_s:.1f} s")
    return model, params, cast, init_s


def _peak_gb(torch, dev):
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0


def _json_safe(a):
    """``a`` with every infinite float as None (the result lines are JSON)."""
    return {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
            for k, v in a.items()}


def _print_agreement(label, a):
    print(f"  {label}: {a['flipped']:.4%} of tokens flipped; per-token max |diff| "
          f"median {a['median']:.3e}, 90% {a['q90']:.3e}, largest unflipped "
          f"{a['max_other']:.3e}; {a['within']:.2%} of tokens within 2e-3 x max(1, "
          f"max|logit|) = {a['bound']:.3e}")


def run_moe_prefill(torch, np, dev, arch, f32_yardstick, reps=3):
    """Phase 16 (Mixtral, DBRX) and phase 18's prefill (Jamba): the cut model
    in its config dtype through ``build_prefill_step(model, use_flash=True)``
    on MOE_TOKENS[arch] tokens from numpy seed 0 (the dense MoE route, JAX's
    route with no mesh): launches, finite logits; the chunked route beside
    it; with ``f32_yardstick`` (Mixtral) also the f32 flash and chunked
    forwards from the same weights; then, but for Jamba, the
    capacity-bounded route in a 1x1 world on the card at the config's
    capacity factor (each layer's dropped share, timed) and at E / k, where
    nothing drops, against the dense route (in f32 with the yardstick, else
    in bf16).

    Every comparison follows the routing rule (``routing_rule``): tokens
    whose top-k expert set differs between the two runs are counted and
    left out. At full width JAX's init rule makes the model chaotic
    (attention scores of std ~1000, so one-hot attention; router logits of
    std ~32; expert outputs ~1e4): a near-tie that rounding decides moves a
    token wholly, and later tokens through attention. So the gates read the
    tokens, not the largest error: two f32 runs must flip at most 0.1% of
    the tokens and keep 90% of them within 2e-3 x max(1, max|logit|); in
    bf16, where 24-42% of the tokens flip between two routes (printed, by
    layer), the flash route's median per-token distance from the f32
    logits is held to twice the chunked route's (phase 8's rule, on the
    median), and with no f32 copy (DBRX) the routed route with nothing to
    drop to the dense one no farther apart, at the median, than the two
    attention routes. Returns (launches, summary)."""
    import dataclasses

    from repro_torch.common.config import FFNKind, MixerKind
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_world
    from repro_torch.models.moe import capacity, dropped_share, flipped
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model, forward_routes, routing_rule

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model, params, cast, init_s = moe_model(torch, dev, arch)
    cfg = model.cfg
    B, T = MOE_TOKENS[arch]
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T)),
                          device=dev)
    inputs = {"tokens": tok}
    n_attn = sum(k[0] == MixerKind.ATTN for k in model.kinds)
    n_mamba = cfg.n_layers - n_attn
    n_moe = sum(k[1] == FFNKind.MOE for k in model.kinds)
    summary = dict(layers=cfg.n_layers, params=sum(t.numel() for t in _leaves(params)),
                   tokens=(B, T), init_s=init_s)

    def agree(label, key, *args):
        a = routing_rule(*args, tol=LM_TOL)
        _print_agreement(label, a)
        summary[key] = _json_safe(a)
        return a

    truth = None
    if f32_yardstick:
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        build.reset_launches()
        truth, t_sets = forward_routes(model32, params, inputs, use_flash=True)
        _sync(torch, dev)
        n32 = build.LAUNCHES["flash_attention"]
        print(f"  f32: {n32} flash launches, logits finite: "
              f"{bool(torch.isfinite(truth).all())}")
        chunked32, c_sets = forward_routes(model32, params, inputs, use_flash=False)
        a = agree("f32 flash vs chunked route", "f32_flash_vs_chunked", truth, chunked32,
                  t_sets, c_sets)
        del chunked32
        check(n32 == n_attn and bool(torch.isfinite(truth).all())
              and a["flipped"] <= ROUTE_TOL_F32 and a["within"] >= AGREE_SHARE,
              f"{arch}: f32 flash and chunked prefill disagree")
        rcfg = dataclasses.replace(cfg, dtype="float32",
                                   capacity_factor=cfg.n_experts / cfg.moe_top_k)
        check(capacity(rcfg, B * T) > B * T, "capacity E/k leaves cap <= T")
        routed, r_sets, _ = run_world(1, 1, moe_world_body, (rcfg, params, inputs, True),
                                      device=dev.type)
        a = agree(f"f32 routed at capacity factor {rcfg.capacity_factor:g} (cap "
                  f"{capacity(rcfg, B * T)} > T {B * T}) vs dense", "f32_routed_vs_dense",
                  routed, truth, r_sets, t_sets)
        del routed
        check(a["flipped"] <= ROUTE_TOL_F32 and a["within"] >= AGREE_SHARE,
              f"{arch}: f32 routed (no drops) and dense prefill disagree")

    # the main path: the config's dtype, the dense route
    prefill = build_prefill_step(model, use_flash=True)
    build.reset_launches()
    logits = prefill(cast, inputs)
    _sync(torch, dev)
    launches = dict(build.LAUNCHES)
    print(f"  prefill {(B, T)}: logits {tuple(logits.shape)} {logits.dtype}, "
          f"{launches['flash_attention']} flash launches, {launches['ssd_scan']} ssd_scan "
          f"wrapper calls ({n_attn} attention, {n_mamba} Mamba2, {n_moe} MoE layers)")
    check(launches["flash_attention"] == n_attn and launches["ssd_scan"] == n_mamba
          and sum(launches.values()) == n_attn + n_mamba,
          f"{arch}: launches {launches} in one forward, not {n_attn} flash and "
          f"{n_mamba} ssd_scan")
    check(tuple(logits.shape) == (B, T, model.padded_vocab)
          and logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all()),
          f"{arch}: prefill logits not finite bf16 of the padded vocab")
    walked, sets = forward_routes(model, cast, inputs, use_flash=True)
    same = bool(torch.equal(walked, logits))
    del walked
    print(f"  the walked forward (forward_routes) equals the prefill step's bit for "
          f"bit: {same}")
    chunked, c_sets = forward_routes(model, cast, inputs, use_flash=False)
    fc = agree(f"{cfg.dtype} flash vs chunked route", "flash_vs_chunked", logits, chunked,
               sets, c_sets)
    print("    flipped by layer (cumulative): " + ", ".join(
        f"{float(flipped(sets[:i + 1], c_sets[:i + 1], (B, T)).float().mean()):.2%}"
        for i in range(len(sets))))
    summary["walked_equals_prefill"] = same
    if truth is not None:
        af = agree("  its flash route vs the f32 logits", "flash_from_f32", logits, truth,
                   sets, t_sets)
        ac = agree("  its chunked route vs the f32 logits", "chunked_from_f32", chunked,
                   truth, c_sets, t_sets)
        check(af["median"] <= 2 * ac["median"],
              f"{arch}: the flash route's median distance from f32 is more than twice "
              f"the chunked route's")
        del truth
    del chunked
    summary["dense"] = _print_timed("dense route (every expert on every token)", B * T,
                                    time_prefill(torch, dev, lambda: prefill(cast, inputs),
                                                 reps))

    if arch != JAMBA:
        routed, r_sets, timed = run_world(1, 1, moe_world_body,
                                          (cfg, cast, inputs, True, reps), device=dev.type)
        drops = [dropped_share(s, cfg) for s in r_sets]
        print(f"  routed at capacity factor {cfg.capacity_factor:g} (cap "
              f"{capacity(cfg, B * T)} of T {B * T} a expert): dropped token-choices by "
              f"layer {[f'{d:.2%}' for d in drops]}")
        check(bool(torch.isfinite(routed).all()), f"{arch}: routed logits not finite")
        agree("  vs the dense route", "routed_vs_dense_at_factor", routed, logits, r_sets,
              sets)
        del routed
        summary["routed"] = _print_timed(
            f"routed at capacity factor {cfg.capacity_factor:g}", B * T, timed)
        summary["routed"]["dropped_by_layer"] = drops
        if not f32_yardstick:
            rcfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
            routed, r_sets, _ = run_world(1, 1, moe_world_body, (rcfg, cast, inputs, True),
                                          device=dev.type)
            a = agree(f"{cfg.dtype} routed at capacity factor {rcfg.capacity_factor:g} "
                      f"(cap {capacity(rcfg, B * T)} > T {B * T}) vs dense",
                      "routed_vs_dense", routed, logits, r_sets, sets)
            del routed
            check(a["median"] <= fc["median"],
                  f"{arch}: routed (no drops) and dense prefill lie farther apart than "
                  f"the flash and chunked routes")
    del logits
    summary["peak_gb"] = _peak_gb(torch, dev)
    print(f"  peak device memory {summary['peak_gb']:.1f} GB")
    return launches, summary


def run_moe_serve(torch, np, dev, arch):
    """Phase 17 (Mixtral) and phase 18's serve (Jamba): the cut model drawn
    again from seed 0, ``repro_torch.launch.serve.generate`` (the CLI's
    loop, with its ThroughputHook) at MOE_SERVE: finite logits, no kernel
    launch (decode is plain PyTorch, as JAX's is jnp; the MoE layers take
    the dense route, JAX's serve with no mesh). Where the config stores f32
    weights (Mixtral), the f32 teacher-forced logits at the prompt
    positions against the f32 flash prefill of the prompt: 90% of the
    tokens within 2e-3 x max(1, max|logit|), the chunked prefill's
    distance printed beside it (``run_moe_prefill`` says why not all).
    Then decode tokens/s with the card synchronised."""
    import dataclasses

    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.launch.engine import ThroughputHook
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model, routing_rule

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model, params, cast, _ = moe_model(torch, dev, arch)
    cfg = model.cfg
    B, T, G = MOE_SERVE
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T))
    lines = []
    build.reset_launches()
    gen, logits = serve.generate(model, cast, prompt, G,
                                 hooks=[ThroughputHook(B, "tok", lines.append)])
    _sync(torch, dev)
    launches = dict(build.LAUNCHES)
    rate = re.findall(r"^(\d+) steps in (\S+)s -> (\S+) tok/s$", "\n".join(lines), re.M)
    print(f"  generate {(B, T, G)}: {lines[0] if lines else 'no throughput line'}")
    check(len(rate) == 1 and int(rate[0][0]) == T + G, "no throughput line")
    check(sum(launches.values()) == 0, f"the decode path launched kernels: {launches}")
    check(gen.shape == (B, G) and len(logits) == T + G
          and all(bool(torch.isfinite(lg).all()) for lg in logits),
          f"{arch}: serve did not generate finite ({B}, {G}) tokens")
    summary = dict(cli_tok_per_s=float(rate[0][2]))
    if cfg.param_dtype == "float32":
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        _, logits32 = serve.generate(model32, params, prompt, 0)  # f32 caches
        decoded = torch.cat(logits32, dim=1)
        del logits32
        pt = {"tokens": torch.as_tensor(prompt, device=dev)}
        build.reset_launches()
        truth = build_prefill_step(model32, use_flash=True)(params, pt)
        _sync(torch, dev)
        n32 = build.LAUNCHES["flash_attention"]
        a = routing_rule(decoded, truth)
        _print_agreement(f"f32 teacher-forced decode vs flash prefill ({n32} launches) "
                         f"of the prompt", a)
        witness = routing_rule(build_prefill_step(model32)(params, pt), truth)
        _print_agreement("  the chunked prefill vs the flash prefill, beside it", witness)
        check(a["within"] >= AGREE_SHARE,
              f"{arch}: f32 teacher-forced decode and prefill disagree")
        summary.update(f32_decode_vs_prefill=_json_safe(a),
                       f32_chunked_vs_flash_prefill=_json_safe(witness))
        del decoded, truth
    del params
    _sync(torch, dev)
    t0 = time.perf_counter()
    again, _ = serve.generate(model, cast, prompt, G)
    _sync(torch, dev)
    loop_s = time.perf_counter() - t0
    print(f"  synchronised loop of {T + G} steps {loop_s * 1e3:.1f} ms ({loop_s / (T + G) * 1e3:.2f} "
          f"ms a step, {B * (T + G) / loop_s:.0f} tok/s); the same tokens as the first "
          f"run's: {bool(np.array_equal(again, gen))}")
    summary.update(step_ms=loop_s / (T + G) * 1e3, decode_tok_per_s=B * (T + G) / loop_s,
                   peak_gb=_peak_gb(torch, dev))
    print(f"  peak device memory {summary['peak_gb']:.1f} GB")
    return launches, summary


# ---------------------------------------------------------------------------
# phases 19-20: MLA (MiniCPM3-4B) at full width and full depth
# ---------------------------------------------------------------------------
def _print_distance(label, d):
    """One line of ``routing_rule``'s reading of two runs without MoE
    layers (no token flips)."""
    print(f"  {label}: per-token max |diff| median {d['median']:.3e}, 90% "
          f"{d['q90']:.3e}, largest {d['max_other']:.3e}; {d['within']:.2%} of tokens "
          f"within 2e-3 x max(1, max|logit| {d['max_logit']:.2f}) = {d['bound']:.3e}")


def check_mla_agreement(torch, np, dev):
    """Phase 4's MLA row: MiniCPM3-4B at full width cut to 2 layers, kept
    apart (``scan_layers=False``: stacked, ``fan_in`` would read the layer
    count; ``check_lm_agreement`` says why), in f32: a (1, 256) prefill on
    the card and on the CPU from the same weights, within 2e-3 x max(1,
    max|logit|), no kernel launch (JAX's MLA prefill takes the chunked
    route); then, on the card, the absorbed decode teacher-forced over the
    first 32 tokens against the card's prefill, under the same bound (phase
    20 holds the same at full depth)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models.layers import tree_map
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model, routing_rule

    cfg = dataclasses.replace(get_arch(MINICPM), n_layers=2, dtype="float32",
                              scan_layers=False)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    card = tree_map(lambda t: t.to(dev), params)
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 256))
    prefill = build_prefill_step(model, use_flash=True)
    build.reset_launches()
    got = prefill(card, {"tokens": torch.as_tensor(tok, device=dev)})
    _, decoded = serve.generate(model, card, tok[:, :32], 0)
    _sync(torch, dev)
    n = sum(build.LAUNCHES.values())
    want = prefill(params, {"tokens": torch.as_tensor(tok)})
    a = routing_rule(got, want)
    d = routing_rule(torch.cat(decoded, dim=1), got[:, :32])
    print(f"  {MINICPM} 2-layer full-width f32 prefill (1, 256): {n} kernel launches; "
          f"card vs CPU logits max_abs_err {a['max_other']:.3e} (bound {a['bound']:.3e}); "
          f"card decode of 32 tokens vs card prefill {d['max_other']:.3e} (bound "
          f"{d['bound']:.3e})")
    check(n == 0 and got.shape == want.shape and a["max_other"] <= a["bound"]
          and d["max_other"] <= d["bound"], f"{MINICPM}: card and CPU (or decode and "
          f"prefill) logits disagree at the 2-layer cut")


def held_event_ms(torch, fn, reps):
    """``event_ms`` of ``reps`` calls that the host enqueues while a
    device-side sleep holds the stream (``compat.device_sleep``, ~50 ms),
    so the calls run back to back whatever the host's speed: their CUDA-
    event time is their device time."""
    from repro_torch.common.compat import device_sleep

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    device_sleep(10 ** 8)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traced_alone(torch, label, fn, reps=3):
    """(device ms, of which GEMMs) of one call of ``fn``, traced alone. Its
    CUDA-event time, taken with the calls held back to back
    (``held_event_ms``), is its device time: a trace whose kernels sum to
    less than 90% of it has dropped events (as torch.profiler now and then
    does) and is taken again, up to three times."""
    ev = held_event_ms(torch, fn, reps)
    for _ in range(3):
        kern = trace_by_kernel(torch, fn, reps)
        total = sum(kern.values()) / 1e3 / reps
        if total >= 0.9 * ev:
            gemm = sum(us for key, us in kern.items()
                       if any(w in key for w in ("nvjet", "gemm", "cutlass"))) / 1e3 / reps
            print(f"  {label} alone: {ev:.2f} ms by CUDA events, {total:.2f} ms traced "
                  f"(GEMMs {gemm:.2f} ms)")
            return total, gemm
        print(f"  (the trace of {label} holds {total:.2f} ms of its {ev:.2f} ms: "
              f"events dropped; traced again)")
    raise SmokeFailure(f"three traces of {label} dropped events")


def chunked_alone(torch, dev, dt, q_shape, kv_shape, dv, causal, label, reps=3):
    """Device ms of one ``_sdpa_chunked`` call on random q (``q_shape``), k
    (``kv_shape``) and v (``kv_shape`` with head dim ``dv``) in ``dt``,
    traced alone: (its GEMMs, the rest: the elementwise passes over the f32
    score chunks and the casts)."""
    from repro_torch.models.attention import _sdpa_chunked

    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(*q_shape, generator=g, device=dev).to(dt)
    k = torch.randn(*kv_shape, generator=g, device=dev).to(dt)
    v = torch.randn(*kv_shape[:-1], dv, generator=g, device=dev).to(dt)
    total, gemm = traced_alone(torch, label, lambda: _sdpa_chunked(
        q, k, v, causal=causal, window=0, q_offset=0), reps)
    return gemm, total - gemm


def mla_attention_split(torch, dev, cfg, B, T, reps=3):
    """Device ms of one layer's chunked attention (``_sdpa_chunked`` at the
    MLA prefill's shapes: q and k of hd + rd, v of hd, causal, in the
    config's dtype), traced alone: (its GEMMs, the rest)."""
    from repro_torch.models.layers import torch_dtype

    H, dqk = cfg.n_heads, cfg.head_dim + cfg.rope_head_dim
    return chunked_alone(torch, dev, torch_dtype(cfg.dtype), (B, T, H, dqk),
                         (B, T, H, dqk), cfg.head_dim, True,
                         "one layer's chunked attention", reps)


def run_mla_prefill(torch, np, dev, reps=3):
    """Phase 19: MiniCPM3-4B at all 62 layers and full width, its weights
    drawn on the card from seed 0 (f32, then cast once: bf16 matrices and,
    stacked, bf16 norms), ``build_prefill_step(model, use_flash=True)`` on
    MLA_TOKENS tokens from numpy seed 0: no kernel launch (MLA prefill is
    the chunked route in JAX and here), finite bf16 logits of the padded
    vocab; the f32 forward from the same weights and its distance from the
    bf16 logits (printed); forward ms, prefill tokens/s, the device time
    split into GEMMs (cuBLAS: the bf16 projections and the attention's f32
    products), the chunked attention's elementwise work (one layer's
    ``_sdpa_chunked`` traced alone, times the layer count) and the rest;
    the peak device memory. Returns (launches, summary)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model, routing_rule

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model, params, cast, init_s = moe_model(torch, dev, MINICPM, **LM_CUTS[MINICPM])
    cfg = model.cfg
    B, T = MLA_TOKENS
    inputs = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T)), device=dev)}
    prefill = build_prefill_step(model, use_flash=True)
    build.reset_launches()
    logits = prefill(cast, inputs)
    _sync(torch, dev)
    launches = dict(build.LAUNCHES)
    print(f"  prefill {(B, T)}: logits {tuple(logits.shape)} {logits.dtype}, "
          f"{sum(launches.values())} kernel launches")
    check(sum(launches.values()) == 0, f"{MINICPM}: the MLA prefill launched {launches}")
    check(tuple(logits.shape) == (B, T, model.padded_vocab)
          and logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all()),
          f"{MINICPM}: prefill logits not finite bf16 of the padded vocab")
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    truth = build_prefill_step(model32, use_flash=True)(params, inputs)
    _sync(torch, dev)
    dist32 = routing_rule(logits, truth)
    dist32["argmax_equal"] = float((logits.argmax(-1) == truth.argmax(-1)).float().mean())
    _print_distance("bf16 forward vs the f32 forward of the same weights", dist32)
    print(f"    argmax equal at {dist32['argmax_equal']:.2%} of tokens")
    check(bool(torch.isfinite(truth).all()), f"{MINICPM}: f32 logits not finite")
    del truth, logits
    timed = time_prefill(torch, dev, lambda: prefill(cast, inputs), reps)
    fwd_ms, dev_ms, split, top = timed
    attn_gemm, attn_rest = mla_attention_split(torch, dev, cfg, B, T)
    attn_gemm, attn_rest = attn_gemm * cfg.n_layers, attn_rest * cfg.n_layers
    rest = dev_ms - split["gemm"] - attn_rest
    print(f"  forward {fwd_ms:.2f} ms ({B * T / fwd_ms * 1e3:.0f} prefill tokens/s); "
          f"device {dev_ms:.2f} ms: GEMMs {split['gemm']:.2f} ms "
          f"({split['gemm'] / dev_ms:.1%}; the attention's f32 products "
          f"{attn_gemm:.2f} ms of them), chunked attention elementwise {attn_rest:.2f} "
          f"ms ({attn_rest / dev_ms:.1%}), the rest {rest:.2f} ms ({rest / dev_ms:.1%})")
    for key, us in top:
        print(f"    {us / 1e3:9.3f} ms  {key[:100]}")
    summary = dict(layers=cfg.n_layers, params=sum(t.numel() for t in _leaves(params)),
                   tokens=(B, T), init_s=init_s, forward_ms=fwd_ms,
                   prefill_tokens_per_s=B * T / fwd_ms * 1e3, device_ms=dev_ms,
                   device_busy=dev_ms / fwd_ms, gemm_ms=split["gemm"],
                   attention_gemm_ms=attn_gemm, attention_elementwise_ms=attn_rest,
                   rest_ms=rest, bf16_from_f32=dist32, peak_gb=_peak_gb(torch, dev))
    print(f"  peak device memory {summary['peak_gb']:.1f} GB")
    return launches, summary


def run_mla_serve(torch, np, dev):
    """Phase 20: MiniCPM3-4B at all 62 layers drawn again from seed 0,
    ``repro_torch.launch.serve.generate`` (the CLI's loop, with its
    ThroughputHook) at MLA_SERVE in bf16: finite logits, no kernel launch
    (the absorbed MLA decode is plain PyTorch, as JAX's is jnp). In f32
    from the same weights, the teacher-forced logits of the absorbed
    decode at the prompt positions against the f32 prefill (``_mla_train``:
    the two share no attention code), every token within 2e-3 x max(1,
    max|logit|), the plain bound, at full depth. Then decode
    tokens/s with the card synchronised, and the cache bytes a token read
    from the cache tensors. Returns (launches, summary)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.launch.engine import ThroughputHook
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model, routing_rule

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model, params, cast, _ = moe_model(torch, dev, MINICPM, **LM_CUTS[MINICPM])
    cfg = model.cfg
    B, T, G = MLA_SERVE
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T))
    lines = []
    build.reset_launches()
    gen, logits = serve.generate(model, cast, prompt, G,
                                 hooks=[ThroughputHook(B, "tok", lines.append)])
    _sync(torch, dev)
    launches = dict(build.LAUNCHES)
    rate = re.findall(r"^(\d+) steps in (\S+)s -> (\S+) tok/s$", "\n".join(lines), re.M)
    print(f"  generate {(B, T, G)}: {lines[0] if lines else 'no throughput line'}")
    check(len(rate) == 1 and int(rate[0][0]) == T + G, "no throughput line")
    check(sum(launches.values()) == 0, f"the MLA decode path launched kernels: {launches}")
    check(gen.shape == (B, G) and len(logits) == T + G
          and all(bool(torch.isfinite(lg).all()) for lg in logits),
          f"{MINICPM}: serve did not generate finite ({B}, {G}) tokens")
    del logits
    caches = _leaves(model.init_caches(B, T + G, device=dev))
    cache_bytes = sum(t.numel() * t.element_size() for t in caches) / (B * (T + G))
    cache_elt = caches[0].element_size()
    del caches
    summary = dict(cli_tok_per_s=float(rate[0][2]), cache_bytes_per_token=cache_bytes)

    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    _, logits32 = serve.generate(model32, params, prompt, 0)  # f32 caches
    decoded = torch.cat(logits32, dim=1)
    del logits32
    pt = {"tokens": torch.as_tensor(prompt, device=dev)}
    truth = build_prefill_step(model32, use_flash=True)(params, pt)
    a = routing_rule(decoded, truth)
    _print_distance("f32 teacher-forced absorbed decode vs f32 prefill of the prompt", a)
    check(a["max_other"] <= a["bound"], f"{MINICPM}: f32 teacher-forced decode and prefill "
          f"disagree beyond 2e-3 x max(1, max|logit|)")
    summary.update(f32_decode_vs_prefill=a)
    del decoded, truth, params
    _sync(torch, dev)
    t0 = time.perf_counter()
    again, _ = serve.generate(model, cast, prompt, G)
    _sync(torch, dev)
    loop_s = time.perf_counter() - t0
    print(f"  synchronised loop of {T + G} steps {loop_s * 1e3:.1f} ms ({loop_s / (T + G) * 1e3:.2f} "
          f"ms a step, {B * (T + G) / loop_s:.0f} tok/s); the same tokens as the first "
          f"run's: {bool(np.array_equal(again, gen))}; cache {cache_bytes:.0f} bytes a "
          f"token ({cfg.n_layers} layers x (kv_lora {cfg.kv_lora_rank} + rope "
          f"{cfg.rope_head_dim}) x {cache_elt} bytes)")
    summary.update(step_ms=loop_s / (T + G) * 1e3, decode_tok_per_s=B * (T + G) / loop_s,
                   peak_gb=_peak_gb(torch, dev))
    print(f"  peak device memory {summary['peak_gb']:.1f} GB")
    return launches, summary


# ---------------------------------------------------------------------------
# phases 21-24: Whisper-large-v3 and LLaVA-NeXT-Mistral-7B, full width and depth
# ---------------------------------------------------------------------------
def frontend_inputs(np, cfg, B, T, dev, seed=0, nf=None):
    """Prompt tokens (B, T) from numpy seed ``seed``, then Whisper's encoder
    frames (B, encoder_ctx, d_model) or LLaVA's patch embeddings (B, nf,
    d_model; nf = min(n_frontend_tokens, T) by default) from the same
    generator, f32, on ``dev``."""
    import torch

    rng = np.random.default_rng(seed)
    inputs = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                                        device=dev)}
    if cfg.enc_dec:
        shape, key = (B, cfg.encoder_ctx, cfg.d_model), "enc_frames"
    else:
        nf = min(cfg.n_frontend_tokens, T) if nf is None else nf
        shape, key = (B, nf, cfg.d_model), "patch_embeds"
    inputs[key] = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)
    return inputs


def fill_cross(model, params, caches, frames):
    """Whisper's cross caches from the encoder's output, in the cache dtype:
    ``enc_out @ xattn.wk`` and ``@ xattn.wv`` of every decoder layer, as
    JAX's tests/test_models.py ``_prefill_cross`` fills them (the package
    has no cross-cache prefill, in JAX or here)."""
    cfg = model.cfg
    cast = model.cast(params)
    enc = model._encode(cast, frames)
    B = frames.shape[0]
    for p, c in zip(model._layers(cast["layers"]), model._layers(caches)):
        c["xk"].copy_((enc @ p["xattn"]["wk"]).reshape(B, -1, cfg.n_kv_heads, cfg.head_dim))
        c["xv"].copy_((enc @ p["xattn"]["wv"]).reshape(B, -1, cfg.n_kv_heads, cfg.head_dim))
    return caches


def teacher_forced(model, params, caches, tokens):
    """The decode logits (B, T, V) of ``tokens`` (B, T) fed one a step into
    ``caches`` through ``build_serve_step``."""
    import torch

    from repro_torch.models.steps import build_serve_step

    step = build_serve_step(model)
    return torch.cat([step(params, caches, tokens[:, i:i + 1], i)[0]
                      for i in range(tokens.shape[1])], dim=1)


def check_frontend_agreement(torch, np, dev, arch):
    """Phase 4's Whisper and LLaVA rows: ``arch`` at full width cut to 2
    layers (Whisper 2 encoder and 2 decoder layers), kept apart
    (``scan_layers=False``; ``check_lm_agreement`` says why), in f32. Whisper:
    a prefill on (2, 64) tokens and (2, 1500, 1280) frames on the card and
    on the CPU from the same weights, then 8 teacher-forced decode steps
    with the cross caches filled from each device's encoder output, card
    against CPU and, on the card, against the card's prefill. LLaVA: a
    (2, 128) prefill whose first 64 positions are patch embeddings. Each
    within 2e-3 x max(1, max|logit|); one flash launch a decoder layer,
    none for the encoder, cross-attention or decode."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.layers import tree_map
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model, routing_rule

    cut = dict(n_layers=2, dtype="float32", scan_layers=False)
    if arch == WHISPER:
        cut["n_encoder_layers"] = 2
    cfg = dataclasses.replace(get_arch(arch), **cut)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    card = tree_map(lambda t: t.to(dev), params)
    T = 64 if cfg.enc_dec else 128
    inputs = frontend_inputs(np, cfg, 2, T, "cpu", seed=1, nf=None if cfg.enc_dec else 64)
    prefill = build_prefill_step(model, use_flash=True)
    build.reset_launches()
    got = prefill(card, {k: v.to(dev) for k, v in inputs.items()})
    _sync(torch, dev)
    n = dict(build.LAUNCHES)
    want = prefill(params, inputs)
    a = routing_rule(got, want)
    line = (f"  {arch} 2-layer full-width f32 prefill {tuple(inputs['tokens'].shape)}"
            + (f" with {tuple(inputs['enc_frames'].shape)} frames" if cfg.enc_dec
               else f", {inputs['patch_embeds'].shape[1]} patch positions")
            + f": {n['flash_attention']} flash launches; card vs CPU logits max_abs_err "
            f"{a['max_other']:.3e} (bound {a['bound']:.3e})")
    ok = (n["flash_attention"] == cfg.n_layers and sum(n.values()) == cfg.n_layers
          and got.shape == want.shape and a["max_other"] <= a["bound"])
    if cfg.enc_dec:
        steps = 8
        build.reset_launches()
        dec = teacher_forced(model, card, fill_cross(
            model, card, model.init_caches(2, steps, device=dev),
            inputs["enc_frames"].to(dev)), inputs["tokens"][:, :steps].to(dev))
        _sync(torch, dev)
        n_dec = sum(build.LAUNCHES.values())
        dec_cpu = teacher_forced(model, params, fill_cross(
            model, params, model.init_caches(2, steps), inputs["enc_frames"]),
            inputs["tokens"][:, :steps])
        d = routing_rule(dec, dec_cpu)
        dp = routing_rule(dec, got[:, :steps])
        line += (f"; {steps} decode steps on filled cross caches ({n_dec} launches): "
                 f"card vs CPU {d['max_other']:.3e} (bound {d['bound']:.3e}), card "
                 f"decode vs card prefill {dp['max_other']:.3e} (bound {dp['bound']:.3e})")
        ok = ok and n_dec == 0 and d["max_other"] <= d["bound"] \
            and dp["max_other"] <= dp["bound"]
    print(line)
    check(ok, f"{arch}: card and CPU (or decode and prefill) logits disagree at the "
          f"2-layer cut")


def _cache_bytes(model, B, seq, dev):
    """(bytes a token of the self-attention caches, bytes a sequence of the
    cross caches) of ``model.init_caches(B, seq)``."""
    per_token = cross = 0
    for path, t in _named_leaves(model.init_caches(B, seq, device=dev)):
        n = t.numel() * t.element_size()
        if path[-1] in ("xk", "xv"):
            cross += n / B
        else:
            per_token += n / (B * seq)
    return per_token, cross


def _named_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_leaves(v, path + (k,))]
    return [(path, tree)]


def run_frontend_prefill(torch, np, dev, arch, reps=3):
    """Phase 21 (Whisper) and phase 23 (LLaVA): the model at full width and
    full depth in bf16 through ``build_prefill_step(model, use_flash=True)``
    on WHISPER_TOKENS decoder tokens and (4, 1500, 1280) encoder frames, or
    on LLAVA_TOKENS tokens whose first 2,880 positions are patch
    embeddings (2, 2880, 4096), all from numpy seed 0: exactly one flash
    launch a decoder layer and nothing else (the encoder's non-causal
    attention and cross-attention take the chunked route, as in JAX),
    finite bf16 logits of the padded vocab. Whisper: the chunked route's
    logits beside it. LLaVA: the patches plus one give other logits
    (JAX's ``test_vlm_patch_embedding_injection``). Both: the f32 forward
    from the same weights and its distance from the bf16 logits (printed);
    forward ms, tokens/s (Whisper's: decoder tokens) and the device time
    split: Whisper into the encoder (traced alone), flash, the chunked
    cross-attention (one layer's ``_sdpa_chunked`` traced alone, times 32),
    the decoder's GEMMs and the rest; LLaVA into flash, GEMMs and the rest;
    the peak device memory. Returns (launches, summary)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model, routing_rule

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model, params, cast, init_s = moe_model(torch, dev, arch, **LM_CUTS[arch])
    cfg = model.cfg
    B, T = WHISPER_TOKENS if cfg.enc_dec else LLAVA_TOKENS
    inputs = frontend_inputs(np, cfg, B, T, dev)
    prefill = build_prefill_step(model, use_flash=True)
    build.reset_launches()
    logits = prefill(cast, inputs)
    _sync(torch, dev)
    launches = dict(build.LAUNCHES)
    n = launches["flash_attention"]
    print(f"  prefill {(B, T)}: logits {tuple(logits.shape)} {logits.dtype}, {n} flash "
          f"launches, {sum(launches.values()) - n} others")
    check(n == cfg.n_layers and sum(launches.values()) == n,
          f"{arch}: launches {launches} in one forward, not {cfg.n_layers} flash")
    check(tuple(logits.shape) == (B, T, model.padded_vocab)
          and logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all()),
          f"{arch}: prefill logits not finite bf16 of the padded vocab")
    summary = dict(layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers,
                   params=sum(t.numel() for t in _leaves(params)), tokens=(B, T),
                   init_s=init_s)
    if cfg.enc_dec:
        chunked = build_prefill_step(model)(cast, inputs)
        d = routing_rule(logits, chunked)
        _print_distance("bf16 flash vs chunked route", d)
        summary["flash_vs_chunked"] = d
        del chunked
    else:
        moved = prefill(cast, {**inputs, "patch_embeds": inputs["patch_embeds"] + 1.0})
        diff = (moved.float() - logits.float()).abs().amax(-1)
        summary.update(patch_change_max=float(diff.max()),
                       patch_change_positions=float((diff > 0).float().mean()))
        print(f"  the patches plus one: logits move by up to {summary['patch_change_max']:.3f}"
              f", at {summary['patch_change_positions']:.2%} of positions")
        check(summary["patch_change_max"] > 1e-3, f"{arch}: the patches change nothing")
        del moved, diff
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    truth = build_prefill_step(model32, use_flash=True)(params, inputs)
    _sync(torch, dev)
    dist32 = routing_rule(logits, truth)
    dist32["argmax_equal"] = float((logits.argmax(-1) == truth.argmax(-1)).float().mean())
    _print_distance("bf16 forward vs the f32 forward of the same weights", dist32)
    print(f"    argmax equal at {dist32['argmax_equal']:.2%} of tokens")
    check(bool(torch.isfinite(truth).all()), f"{arch}: f32 logits not finite")
    summary["bf16_from_f32"] = dist32
    del truth, logits
    fwd_ms, dev_ms, split, top = time_prefill(torch, dev, lambda: prefill(cast, inputs),
                                              reps)
    summary.update(forward_ms=fwd_ms, prefill_tokens_per_s=B * T / fwd_ms * 1e3,
                   device_ms=dev_ms, device_busy=dev_ms / fwd_ms, flash_ms=split["flash"])
    if cfg.enc_dec:
        frames = inputs["enc_frames"]
        enc_ms, enc_gemm = traced_alone(torch, "the encoder", lambda: model._encode(
            cast, frames), reps)
        H, hd, S = cfg.n_heads, cfg.head_dim, cfg.encoder_ctx
        x_gemm, x_rest = chunked_alone(torch, dev, model.dtype, (B, T, H, hd),
                                       (B, S, cfg.n_kv_heads, hd), hd, False,
                                       "one layer's chunked cross-attention", reps)
        x_gemm, x_rest = x_gemm * cfg.n_layers, x_rest * cfg.n_layers
        dec_gemm = split["gemm"] - enc_gemm - x_gemm
        rest = dev_ms - enc_ms - split["flash"] - x_gemm - x_rest - dec_gemm
        parts = dict(encoder=enc_ms, flash=split["flash"], cross_chunked=x_gemm + x_rest,
                     decoder_gemm=dec_gemm, rest=rest)
        summary.update(encoder_ms=enc_ms, encoder_gemm_ms=enc_gemm,
                       cross_chunked_ms=x_gemm + x_rest, cross_gemm_ms=x_gemm,
                       decoder_gemm_ms=dec_gemm, rest_ms=rest)
    else:
        parts = dict(flash=split["flash"], gemm=split["gemm"], rest=split["other"])
        summary.update(gemm_ms=split["gemm"], rest_ms=split["other"])
    what = "decoder tokens/s" if cfg.enc_dec else "prefill tokens/s"
    print(f"  forward {fwd_ms:.2f} ms ({B * T / fwd_ms * 1e3:.0f} {what}); device "
          f"{dev_ms:.2f} ms: " + ", ".join(f"{k} {v:.2f} ms ({v / dev_ms:.1%})"
                                           for k, v in parts.items()))
    for key, us in top:
        print(f"    {us / 1e3:9.3f} ms  {key[:100]}")
    summary["peak_gb"] = _peak_gb(torch, dev)
    print(f"  peak device memory {summary['peak_gb']:.1f} GB")
    return launches, summary


def f32_decode_vs_prefill(torch, model32, params, inputs):
    """(the teacher-forced decode logits of ``inputs["tokens"]`` against the
    f32 flash prefill of them, under ``routing_rule``; the chunked f32
    prefill against the flash one, the distance that the order of the sums
    alone makes). Whisper's cross caches are filled from the f32 encoder
    output of ``inputs["enc_frames"]``."""
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import routing_rule

    tok = inputs["tokens"]
    caches = model32.init_caches(*tok.shape, device=tok.device)
    pt = {"tokens": tok}
    if model32.cfg.enc_dec:
        caches = fill_cross(model32, params, caches, inputs["enc_frames"])
        pt["enc_frames"] = inputs["enc_frames"]
    decoded = teacher_forced(model32, params, caches, tok)
    del caches
    truth = build_prefill_step(model32, use_flash=True)(params, pt)
    witness = routing_rule(build_prefill_step(model32)(params, pt), truth)
    return routing_rule(decoded, truth), witness


def run_frontend_serve(torch, np, dev, arch):
    """Phase 22 (Whisper) and phase 24 (LLaVA): the model at full depth drawn
    again from seed 0, ``repro_torch.launch.serve.generate`` (the CLI's
    loop, with its ThroughputHook) at FRONTEND_SERVE in bf16: finite
    logits, no kernel launch (decode is plain PyTorch, as JAX's is jnp);
    Whisper decodes against zero cross caches, as JAX's serve does, and
    LLaVA takes tokens only. Then decode tokens/s with the card
    synchronised, and the cache bytes a token (Whisper's fixed cross cache
    beside them).

    In f32, the teacher-forced decode logits at the 32 prompt positions
    against the f32 flash prefill of the prompt (Whisper's on (4, 1500,
    1280) frames drawn after the prompt from numpy seed 0, its cross caches
    filled from the f32 encoder output of them), every token within 2e-3 x
    max(1, max|logit|), at full depth with the layers kept apart
    (``scan_layers=False``), whose JAX init draws each matrix at 1 /
    sqrt(its input width). With the served, stacked weights ``fan_in``
    reads the layer count, 32: every matrix at std 0.177, one-hot
    attention, and a forward so chaotic that the order of the sums alone
    moves the logits past that bound; their reading is printed beside the
    f32 chunked-vs-flash prefill's, which shows the chaos (phase 4 holds
    the stacked-free 2-layer cuts to the plain bound too). Returns
    (launches, summary)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.launch.engine import ThroughputHook
    from repro_torch.models.transformer import build_model

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    full = dataclasses.replace(get_arch(arch), **LM_CUTS[arch])
    model, params, cast, _ = moe_model(torch, dev, arch, **LM_CUTS[arch])
    cfg = model.cfg
    B, T, G = FRONTEND_SERVE
    inputs = frontend_inputs(np, cfg, B, T, dev)
    prompt = inputs["tokens"].cpu().numpy()
    lines = []
    build.reset_launches()
    gen, logits = serve.generate(model, cast, prompt, G,
                                 hooks=[ThroughputHook(B, "tok", lines.append)])
    _sync(torch, dev)
    launches = dict(build.LAUNCHES)
    rate = re.findall(r"^(\d+) steps in (\S+)s -> (\S+) tok/s$", "\n".join(lines), re.M)
    print(f"  generate {(B, T, G)}: {lines[0] if lines else 'no throughput line'}")
    check(len(rate) == 1 and int(rate[0][0]) == T + G, "no throughput line")
    check(sum(launches.values()) == 0, f"{arch}: the decode path launched {launches}")
    check(gen.shape == (B, G) and len(logits) == T + G
          and all(bool(torch.isfinite(lg).all()) for lg in logits),
          f"{arch}: serve did not generate finite ({B}, {G}) tokens")
    del logits
    _sync(torch, dev)
    t0 = time.perf_counter()
    again, _ = serve.generate(model, cast, prompt, G)
    _sync(torch, dev)
    loop_s = time.perf_counter() - t0
    per_token, cross = _cache_bytes(model, B, T + G, dev)
    fixed = (f", and {cross / 1e6:.2f} MB a sequence of cross cache ({cfg.n_layers} "
             f"layers x {cfg.encoder_ctx} frames)" if cfg.enc_dec else "")
    print(f"  synchronised loop of {T + G} steps {loop_s * 1e3:.1f} ms ({loop_s / (T + G) * 1e3:.2f} "
          f"ms a step, {B * (T + G) / loop_s:.0f} tok/s); the same tokens as the first "
          f"run's: {bool(np.array_equal(again, gen))}; cache {per_token:.0f} bytes a "
          f"token{fixed}")
    summary = dict(cli_tok_per_s=float(rate[0][2]), step_ms=loop_s / (T + G) * 1e3,
                   decode_tok_per_s=B * (T + G) / loop_s, cache_bytes_per_token=per_token,
                   cross_cache_bytes_per_sequence=cross)

    what = "f32 teacher-forced decode vs f32 prefill of the prompt" + (
        " (cross caches from the f32 encoder)" if cfg.enc_dec else "")
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    a, witness = f32_decode_vs_prefill(torch, model32, params, inputs)
    _print_distance(f"stacked weights, {what}", a)
    _print_distance("  beside it, the f32 chunked prefill vs the flash prefill", witness)
    summary.update(stacked_f32_decode_vs_prefill=a, stacked_f32_chunked_vs_flash=witness)
    del params, cast, model
    free_card(torch)
    apart = build_model(dataclasses.replace(full, dtype="float32", scan_layers=False))
    params = apart.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    a, witness = f32_decode_vs_prefill(torch, apart, params, inputs)
    _print_distance(f"layers kept apart, {what}", a)
    _print_distance("  beside it, the f32 chunked prefill vs the flash prefill", witness)
    check(a["max_other"] <= a["bound"], f"{arch}: f32 teacher-forced decode and prefill "
          f"disagree beyond 2e-3 x max(1, max|logit|)")
    summary.update(f32_decode_vs_prefill=a, f32_chunked_vs_flash=witness,
                   peak_gb=_peak_gb(torch, dev))
    print(f"  peak device memory {summary['peak_gb']:.1f} GB")
    return launches, summary


T_START = time.perf_counter()


# ---------------------------------------------------------------------------
# phase 26: the dry run's counts on the card against meta; the CLI
# ---------------------------------------------------------------------------
def start_dryruns():
    """Phase 26 (c): ``python -m repro_torch.launch.dryrun`` of each
    ``DRYRUN_CASES`` entry on the production grid, one process each, all at
    once, on the host's CPU (the card hidden from them: a dry run counts on
    the meta device). Started once the card work of phase 26 is done and
    read by ``finish_dryruns``; ``stop_dryruns`` ends them."""
    import os

    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    procs = {}
    try:
        for name, args in DRYRUN_CASES.items():
            log = open(DRYRUN_DIR / f"{name}.log", "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                   "--out", str(DRYRUN_DIR / f"{name}.json")]
            procs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                            stderr=subprocess.STDOUT), log,
                           time.perf_counter())
    except BaseException:
        stop_dryruns(procs)
        raise
    return procs


def stop_dryruns(procs):
    for proc, log, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        log.close()


def finish_dryruns(procs, timeout_s=600):
    """Wait for phase 26 (c)'s dry runs; print each one's row; each must
    exit 0 with a row that fits the card."""
    rows = {}
    for name, (proc, log, t0) in procs.items():
        rc = proc.wait(timeout=timeout_s)
        log.flush()
        text = (DRYRUN_DIR / f"{name}.log").read_text()
        check(rc == 0, f"dryrun {' '.join(DRYRUN_CASES[name])} exited {rc}:\n{text[-3000:]}")
        row = json.loads((DRYRUN_DIR / f"{name}.json").read_text())
        line = [ln for ln in text.splitlines() if "(trace " in ln]
        print(f"  {' '.join(DRYRUN_CASES[name])}: exit 0 "
              f"({time.perf_counter() - t0:.1f} s from its start)")
        print(f"    {line[-1] if line else ''}")
        print(f"    flops/rank {row['flops_per_dev']:.4e}, HBM bytes {row['hbm_bytes_per_dev']:.4e}, "
              f"collective bytes {row['coll_bytes_per_dev']:.4e}, {row['bytes_per_device'] / 2**30:.2f} "
              f"GiB a rank, fits 80 GB {row['fits_hbm']}; kernels "
              f"{ {k: v['launches'] for k, v in row['kernels'].items()} }; modelled from "
              "H100_SXM's data sheet rates")
        rows[name] = {k: row[k] for k in ("mesh", "flops_per_dev", "hbm_bytes_per_dev",
                                          "coll_bytes_per_dev", "compute_s", "memory_s",
                                          "collective_s", "dominant", "useful_ratio",
                                          "bytes_per_device", "fits_hbm", "trace_s",
                                          "kernels")}
    return rows


def _as_meta(torch, tree):
    """A tree of dicts of tensors (other leaves kept) as meta tensors."""
    if isinstance(tree, dict):
        return {k: _as_meta(torch, v) for k, v in tree.items()}
    return torch.empty_like(tree, device="meta") if torch.is_tensor(tree) else tree


def _records(t):
    return {k: (r.launches, r.flops, r.bytes) for k, r in t.mode.kernels.items()}


def card_and_meta(torch, label, fn, args, names, launches):
    """``fn(*args)`` counted on the card (``hlo_analysis.trace``), then on
    meta twins of ``args``: their matmul FLOPs and the records of the
    kernels ``names`` must be equal, and each record's launches must be
    what ``build.LAUNCHES`` counted on the card (``launches``)."""
    from repro_torch.kernels import build
    from repro_torch.launch.hlo_analysis import trace

    build.reset_launches()
    card = trace(fn, *args)
    torch.cuda.synchronize()
    counted = dict(build.LAUNCHES)
    meta = trace(fn, *_as_meta(torch, list(args)))
    rc, rm = _records(card), _records(meta)
    print(f"  {label}: matmul FLOPs card {card.mode.matmul_flops:.6e}, meta "
          f"{meta.mode.matmul_flops:.6e}; torch's FlopCounterMode {card.torch_flop_counter:.6e}")
    for name in names:
        print(f"    {name}: card (launches, FLOPs, bytes) {rc.get(name)}, meta {rm.get(name)}, "
              f"build.LAUNCHES {counted[name]}")
        check(name in rc and rc[name] == rm.get(name),
              f"{label}: {name}'s records differ on the card and on meta")
        check(rc[name][0] == counted[name] == launches[name],
              f"{label}: {name} launched {counted[name]} times, recorded "
              f"{rc[name][0]}, expected {launches[name]}")
    check(card.mode.matmul_flops == meta.mode.matmul_flops,
          f"{label}: matmul FLOPs differ on the card and on meta")
    check(card.torch_flop_counter == card.mode.matmul_flops,
          f"{label}: FlopCounterMode counts another total")
    card.result = meta.result = None  # the outputs: not held past the count
    return card, meta


def tooling_qwen(torch, np, dev, model, cast):
    """Phase 26 (a): phase 8's Qwen1.5-0.5B weights, one (4, 2048) prefill
    through flash counted on the card and on meta; the compute term of
    the roofline against the measured device time; the meta estimate of
    the peak bytes beside the card's."""
    from repro_torch.common.hw import H100_SXM as hw
    from repro_torch.models.steps import build_prefill_step

    cfg = model.cfg
    flash = build_prefill_step(model, use_flash=True)
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, PREFILL_SHAPE),
                          device=dev)
    inputs = {"tokens": tok}
    flash(cast, inputs)
    torch.cuda.synchronize()
    card, meta = card_and_meta(torch, f"{QWEN} prefill {PREFILL_SHAPE}, flash", flash,
                               (cast, inputs), ["flash_attention"],
                               {"flash_attention": cfg.n_layers})
    kern = trace_by_kernel(torch, lambda: flash(cast, inputs))
    dev_ms = sum(kern.values()) / 1e3
    ev_ms = event_ms(torch, lambda: flash(cast, inputs), reps=5, warmup=1)
    compute_ms = card.cost.flops / hw.peak_bf16_flops * 1e3
    memory_ms = card.cost.hbm_bytes / hw.hbm_bandwidth * 1e3
    roof_ms = max(compute_ms, memory_ms)
    print(f"  roofline (modelled from H100_SXM's data sheet rates): compute "
          f"{compute_ms:.3f} ms ({card.cost.flops:.4e} FLOPs at the bf16 peak), memory "
          f"{memory_ms:.3f} ms ({card.cost.hbm_bytes:.4e} bytes); measured device time "
          f"{dev_ms:.3f} ms (CUDA events {ev_ms:.3f} ms): measured/roofline "
          f"{dev_ms / roof_ms:.3f}")
    check(compute_ms <= dev_ms, f"the compute term {compute_ms:.3f} ms exceeds the "
          f"measured device time {dev_ms:.3f} ms")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash(cast, inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak bytes: meta estimate {meta.bytes_per_device:.4e} (arguments "
          f"{meta.argument_bytes:.4e}, live peak {meta.mode.peak_bytes:.4e}), card "
          f"max_memory_allocated {peak:.4e} (ratio {meta.bytes_per_device / peak:.3f})")
    return dict(matmul_flops=card.mode.matmul_flops, flops=card.cost.flops,
                hbm_bytes=card.cost.hbm_bytes, flash=_records(card)["flash_attention"],
                compute_ms=compute_ms, memory_ms=memory_ms, device_ms=dev_ms,
                event_ms=ev_ms, measured_over_roofline=dev_ms / roof_ms,
                meta_bytes=meta.bytes_per_device, card_peak_bytes=peak)


def tooling_kge_body(grid, prog, arrays, db):
    """Phase 26 (b)'s rank body: one TransE_l1 step of ``prog`` counted on
    the card in a 1x1 NCCL world (after one step that builds the kernels)."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.kernels import build
    from repro_torch.launch.hlo_analysis import trace

    state = D.dist_state_from_arrays(prog, grid, arrays)
    batch = D.batch_to_rank(db, grid)
    step = D.build_dist_train_step(prog, grid)
    step(state, batch)
    torch.cuda.synchronize()
    build.reset_launches()
    card = trace(step, state, batch, total_devices=grid.world)
    torch.cuda.synchronize()
    return card, dict(build.LAUNCHES)


def tooling_kge(torch, np, kg):
    """Phase 26 (b): one TransE_l1 FB15k step of a 1x1 NCCL world (phase
    13's world, as the CLI sizes it) on the card, against ``count_kge`` of
    the same program on meta in a fake world of one."""
    import dataclasses

    from repro_torch.core import distributed as D
    from repro_torch.core.graph_part import partition
    from repro_torch.core.rel_part import relation_partition
    from repro_torch.core.sampling import DistSampler
    from repro_torch.launch.dryrun import count_kge, fake_world
    from repro_torch.launch.mesh import run_world

    cfg = dataclasses.replace(fb15k_config(kg, "transe_l1"), n_parts=1)
    book = partition(kg.train, cfg.n_entities, 1)
    rp = relation_partition(kg.rel_counts(), 1)
    prog = D.make_program(cfg, book.rows_per_part, rp.slots_per_part, rp.n_shared)
    db = DistSampler(kg.train, book, rp, cfg, np.random.default_rng(0)).sample()
    card, counted = run_world(1, 1, tooling_kge_body, (prog, D.init_dist_arrays(prog, 0), db),
                              device="cuda")
    with fake_world(1, 1) as grid:
        meta = count_kge(prog, grid)
    rc, rm = _records(card), _records(meta)
    names = ("pairwise_l1", "l1_bwd_pair", "dedup_aggregate", "fused_update")
    print(f"  TransE_l1 FB15k step, 1x1 NCCL world: collectives card "
          f"{ {k: s.count for k, s in card.cost.collectives.items()} }, meta "
          f"{ {k: s.count for k, s in meta.cost.collectives.items()} }")
    for name in names:
        print(f"    {name}: card (launches, FLOPs, bytes) {rc.get(name)}, meta {rm.get(name)}, "
              f"build.LAUNCHES {counted[name]}")
        check(name in rc and rc[name] == rm.get(name) and rc[name][0] == counted[name],
              f"TransE_l1 step: {name}'s card and meta records or launches differ")
    check(set(rc) == set(rm), f"kernels recorded: card {sorted(rc)}, meta {sorted(rm)}")
    check({k: s.count for k, s in card.cost.collectives.items()}
          == {k: s.count for k, s in meta.cost.collectives.items()},
          "TransE_l1 step: collectives differ on the card and on meta")
    return {k: list(v) for k, v in rc.items()}


def tooling_mamba(torch, np, dev):
    """Phase 26 (b): phase 4's 2-layer Mamba2-2.7B at full width, a (1, 256)
    f32 prefill through the SSD scan, on the card and on meta."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(get_arch(MAMBA), n_layers=2, dtype="float32",
                              scan_layers=False)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device=dev)
    tok = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 256)),
                          device=dev)
    prefill = build_prefill_step(model)
    card, _ = card_and_meta(torch, f"{MAMBA} 2-layer prefill (1, 256)", prefill,
                            (params, {"tokens": tok}), ["ssd_scan"], {"ssd_scan": 2})
    return list(_records(card)["ssd_scan"])


def seam_cost(torch, dev):
    """The kernels' seam with no analysis active: the host time of the
    statements it adds to a wrapper call (the device test and the check of
    ``common/cost.ACTIVE``) against the host time of one wrapper call
    (``pairwise_kernel`` on a tiny input, enqueued back to back)."""
    import timeit

    from repro_torch.common import cost
    from repro_torch.kernels.kge_score.ops import pairwise_kernel

    o = torch.randn(1, 8, 16, device=dev)
    n = torch.randn(1, 8, 16, device=dev)
    n_calls = 2000
    for _ in range(50):
        pairwise_kernel("dot", o, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        pairwise_kernel("dot", o, n)
    host_us = (time.perf_counter() - t0) / n_calls * 1e6
    torch.cuda.synchronize()
    reps = 1_000_000
    seam_ns = timeit.timeit("o.is_cuda\nif cost.ACTIVE is not None: pass",
                            globals={"o": o, "cost": cost}, number=reps) / reps * 1e9
    print(f"  the seam with no analysis: {seam_ns:.1f} ns a call (the device test and "
          f"the check of cost.ACTIVE) against {host_us:.2f} us of host time a wrapper "
          f"call: {seam_ns / (host_us * 1e3):.3%}")
    return dict(seam_ns=seam_ns, wrapper_host_us=host_us)


def _depth(arch) -> str:
    """``arch``'s depth cut (LM_CUTS), for a phase's title."""
    from repro_torch.configs import get_arch

    full, cut = get_arch(arch), LM_CUTS[arch]
    text = f"{cut['n_layers']} of {full.n_layers} layers"
    if "n_encoder_layers" in cut:
        text += f" (encoder {cut['n_encoder_layers']} of {full.n_encoder_layers})"
    return text


def elapsed() -> str:
    return f"{time.perf_counter() - T_START:.0f} s"


def free_card(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


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
    load_rates()
    import numpy as np

    from repro_torch.data.kg_synth import fb15k_like
    from repro_torch.kernels import build

    # fp32 everywhere: the plain versions' matmuls must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(f"  ({elapsed()} since the start)")
    print("== 1. environment")
    smi = nvidia_smi_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"  {smi}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"capability {cap}; {torch.cuda.device_count()} device(s)")
    check(cap == (9, 0), f"needs a Hopper card (capability (9, 0)), got {cap}")
    dev = torch.device("cuda", 0)

    print(f"  ({elapsed()} since the start)")
    print("== 2. build")
    t0 = time.perf_counter()
    paths = build.build(verbose=True)
    print(f"  built {len(paths)} libraries in {time.perf_counter() - t0:.2f} s")

    print(f"  ({elapsed()} since the start)")
    print("== 3. kernels vs plain versions")
    kg = fb15k_like(scale=1.0, seed=0)
    # each check draws from a generator of its own, so that a shape added to
    # one check leaves every other check's inputs as they were
    def gen(seed):
        return torch.Generator().manual_seed(seed)

    rows = check_pairwise(torch, dev, gen(0)) + check_l1_bwd(torch, dev, gen(1)) \
        + check_dedup(torch, np, dev, gen(2), kg) + check_update(torch, dev, gen(3)) \
        + check_flash(torch, dev, gen(4)) + check_ssd(torch, dev, gen(5))
    for r in rows:
        print(f"  {r['name']:16s} {r['shape']:>18s}: {_fmt(r)}  err "
              f"{r['max_abs_err']:.2e} <= {r['tol']:.2e}")
        for name, o in r.get("other_shapes", {}).items():
            print(f"  {'':16s} {name:>18s}: {_fmt(o)}")

    print(f"  ({elapsed()} since the start)")
    print("== 4. card vs CPU: three dim-400 steps at batch 256, k 64; 2-layer "
          "Qwen, Mamba2, MiniCPM3, Whisper and LLaVA prefills; reduced Mixtral, DBRX "
          "and Jamba prefills")
    for model in ("transe_l2", "transe_l1", "distmult"):
        check_agreement(torch, np, dev, model)
    # RESCAL diverges at FB15k's lr 0.25 (loss 1.39 -> 18.1 in three steps)
    # and carries any change in the rounding of a sum into more entries than
    # the rule allows, between two CPU runs too; at 0.05 its loss falls
    check_agreement(torch, np, dev, "rescal", lr=0.05)
    for model in ("transe_l2", "distmult", "rescal"):
        floor = sum_order_witness(torch, np, dev, model)
    check(floor > 1e-3, "rescal at lr 0.25: two CPU runs agree within phase 4's "
          f"rule ({floor:.2e} off), so it should run there at FB15k's lr")
    check_lm_agreement(torch, np, dev, QWEN, "flash_attention", use_flash=True)
    check_lm_agreement(torch, np, dev, MAMBA, "ssd_scan", use_flash=False)
    for arch in (MIXTRAL, DBRX, JAMBA):
        check_moe_agreement(torch, np, dev, arch)
    check_mla_agreement(torch, np, dev)
    for arch in (WHISPER, LLAVA):
        check_frontend_agreement(torch, np, dev, arch)

    print(f"  ({elapsed()} since the start)")
    print(f"== 5. TransE_l2 path: FB15k, {MAIN_PATH_STEPS} steps")
    l2_launches, l2_path, *_ = run_path(torch, np, "transe_l2", [], 20)
    check_launched(l2_launches, ("pairwise_l2sq", "dedup_aggregate", "fused_update"),
                   MAIN_PATH_STEPS)

    print(f"  ({elapsed()} since the start)")
    print(f"== 6. TransE_l1 path: FB15k, {MAIN_PATH_STEPS} steps, eval, "
          f"checkpoint, resume to {RESUME_STEPS}")
    l1_launches, l1_path = run_l1_path(torch, np, dev, kg)

    print(f"  ({elapsed()} since the start)")
    print(f"== 7. DistMult path: FB15k, {MAIN_PATH_STEPS} steps")
    dm_launches, dm_path, *_ = run_path(torch, np, "distmult", [], 20)
    check_launched(dm_launches, ("pairwise_dot", "dedup_aggregate", "fused_update"),
                   MAIN_PATH_STEPS)

    print(f"  ({elapsed()} since the start)")
    print(f"== 8. Qwen prefill: {QWEN} at full width, {PREFILL_SHAPE} tokens, flash")
    pre_launches, pre_path, reuse = run_qwen_prefill(torch, np, dev)

    print(f"  ({elapsed()} since the start)")
    print(f"== 9. Qwen serve: python -m repro_torch.launch.serve {' '.join(SERVE_ARGS)}")
    serve_launches, serve_path = run_serve(torch, np, dev, SERVE_ARGS, "flash_attention",
                                           reuse, scaled_f32=False, files=SERVE_DIR)
    qwen_weights = reuse[:2]  # phase 26 (a) counts a prefill of the same weights
    del reuse
    torch.cuda.empty_cache()

    print(f"  ({elapsed()} since the start)")
    print(f"== 10. Mamba2 prefill: {MAMBA} at full width, {PREFILL_SHAPE} tokens, ssd_scan")
    m_pre_launches, m_pre_path, reuse = run_mamba_prefill(torch, np, dev)

    print(f"  ({elapsed()} since the start)")
    print(f"== 11. Mamba2 serve: python -m repro_torch.launch.serve "
          f"{' '.join(MAMBA_SERVE_ARGS)}")
    m_serve_launches, m_serve_path = run_serve(torch, np, dev, MAMBA_SERVE_ARGS,
                                               "ssd_scan", reuse, scaled_f32=True)
    del reuse

    print(f"  ({elapsed()} since the start)")
    print("== 12. Hogwild: python -m repro_torch.launch.train --dataset fb15k "
          "--trainers 4 --samplers 4 --metrics-out ... --trace-out ...")
    hog_launches, hog_path = run_hogwild(torch, np, dev, kg)

    print(f"  ({elapsed()} since the start)")
    print("== 13. distributed: python -m repro_torch.launch.train --dataset fb15k "
          "--distributed --mesh 1x1 (NCCL, one rank)")
    dist_launches, dist_path = run_distributed(torch, np, dev)

    print(f"  ({elapsed()} since the start)")
    print("== 14. pipelined KVStore I/O: python -m repro_torch.launch.train --dataset "
          f"fb15k --distributed --mesh 1x1 --pipeline-depth 1 --push-every "
          f"{PIPE_PUSH_EVERY} (NCCL, one rank)")
    pipe_launches, pipe_path = run_pipelined(torch, np, dev, dist_path)

    print(f"  ({elapsed()} since the start)")
    print("== 15. distributed Hogwild: python -m repro_torch.launch.train --dataset "
          "fb15k --distributed --mesh 1x1 --trainers 2 --samplers 2 (NCCL, one rank)")
    dh_launches, dh_path = run_dist_hogwild(torch, np, dev, dist_path,
                                            dist_launches["dist_transe_l2"])

    free_card(torch)
    print(f"  ({elapsed()} since the start)")
    print(f"== 16. MoE prefill at full width: {MIXTRAL} {MOE_TOKENS[MIXTRAL]} (window "
          f"4096), then {DBRX} {MOE_TOKENS[DBRX]}, flash, dense and routed")
    mx_pre_launches, mx_pre_path = run_moe_prefill(torch, np, dev, MIXTRAL, True)
    free_card(torch)
    dbrx_pre_launches, dbrx_pre_path = run_moe_prefill(torch, np, dev, DBRX, False)
    free_card(torch)

    print(f"  ({elapsed()} since the start)")
    print(f"== 17. MoE serve: repro_torch.launch.serve.generate, {MIXTRAL} cut to "
          f"{MOE_CUTS[MIXTRAL]} layers, batch {MOE_SERVE[0]}, {MOE_SERVE[1]} + "
          f"{MOE_SERVE[2]} tokens")
    mx_serve_launches, mx_serve_path = run_moe_serve(torch, np, dev, MIXTRAL)
    free_card(torch)

    print(f"  ({elapsed()} since the start)")
    print(f"== 18. Jamba at full width: {JAMBA} cut to {MOE_CUTS[JAMBA]} layers, "
          f"prefill {MOE_TOKENS[JAMBA]} (ssd_scan and flash), then generate")
    jb_pre_launches, jb_pre_path = run_moe_prefill(torch, np, dev, JAMBA, False)
    free_card(torch)
    jb_serve_launches, jb_serve_path = run_moe_serve(torch, np, dev, JAMBA)
    free_card(torch)

    print(f"  ({elapsed()} since the start)")
    print(f"== 19. MLA prefill: {MINICPM} at full width, {_depth(MINICPM)}, {MLA_TOKENS} tokens, "
          f"bf16, the chunked route")
    mla_pre_launches, mla_pre_path = run_mla_prefill(torch, np, dev)
    free_card(torch)

    print(f"  ({elapsed()} since the start)")
    print(f"== 20. MLA serve: repro_torch.launch.serve.generate, {MINICPM}, {_depth(MINICPM)}, "
          f"batch {MLA_SERVE[0]}, {MLA_SERVE[1]} + {MLA_SERVE[2]} tokens, absorbed decode")
    mla_serve_launches, mla_serve_path = run_mla_serve(torch, np, dev)
    free_card(torch)

    print(f"  ({elapsed()} since the start)")
    print(f"== 21. Whisper prefill: {WHISPER} at full width, {_depth(WHISPER)}, {WHISPER_TOKENS} "
          f"decoder tokens and 1500 encoder frames, bf16, flash")
    wh_pre_launches, wh_pre_path = run_frontend_prefill(torch, np, dev, WHISPER)
    free_card(torch)

    print(f"  ({elapsed()} since the start)")
    print(f"== 22. Whisper serve: repro_torch.launch.serve.generate, {WHISPER}, "
          f"{_depth(WHISPER)}, batch {FRONTEND_SERVE[0]}, {FRONTEND_SERVE[1]} + {FRONTEND_SERVE[2]} "
          f"tokens, zero cross caches")
    wh_serve_launches, wh_serve_path = run_frontend_serve(torch, np, dev, WHISPER)
    free_card(torch)

    print(f"  ({elapsed()} since the start)")
    print(f"== 23. LLaVA prefill: {LLAVA} at full width, {_depth(LLAVA)}, {LLAVA_TOKENS} tokens, "
          f"the first 2880 patch embeddings, bf16, flash")
    lv_pre_launches, lv_pre_path = run_frontend_prefill(torch, np, dev, LLAVA)
    free_card(torch)

    print(f"  ({elapsed()} since the start)")
    print(f"== 24. LLaVA serve: repro_torch.launch.serve.generate, {LLAVA}, "
          f"{_depth(LLAVA)}, batch {FRONTEND_SERVE[0]}, {FRONTEND_SERVE[1]} + {FRONTEND_SERVE[2]} "
          f"tokens")
    lv_serve_launches, lv_serve_path = run_frontend_serve(torch, np, dev, LLAVA)
    free_card(torch)

    print(f"  ({elapsed()} since the start)")
    print(f"== 25. LM training: (a) card vs CPU, f32, two build_train_step steps; (b) "
          f"{QWEN} at full width and depth, {TRAIN_QWEN_TOKENS} tokens; (c) {DBRX} cut "
          f"to {TRAIN_DBRX_LAYERS} layer, {TRAIN_DBRX_TOKENS} tokens, adafactor; (d) "
          f"train_lm_smoke; (e) one step in a 1x1 NCCL world")
    train_agree = {}
    for arch, reduced in ((QWEN, False), (MAMBA, False), (DBRX, True)):
        train_agree[arch] = check_train_agreement(torch, np, dev, arch, reduced=reduced)
        print(f"  ({elapsed()} since the start)")
    free_card(torch)
    print(f"  ({elapsed()} since the start)")
    tq_launches, tq_path = run_train_child(QWEN, 24, TRAIN_QWEN_TOKENS, TRAIN_QWEN_TIMED)
    free_card(torch)
    print(f"  ({elapsed()} since the start)")
    td_launches, td_path = run_train_child(DBRX, TRAIN_DBRX_LAYERS, TRAIN_DBRX_TOKENS,
                                           TRAIN_DBRX_TIMED)
    free_card(torch)
    print(f"  ({elapsed()} since the start)")
    ts_launches, ts_path = run_train_smoke(torch, dev)
    tw_rule, tw_launches = check_train_world(torch, np, dev)
    free_card(torch)

    print(f"  ({elapsed()} since the start)")
    t26 = time.perf_counter()
    print(f"== 26. tooling: (a) {QWEN} {PREFILL_SHAPE} flash prefill counted on the card "
          f"and on meta, its roofline; (b) a TransE_l1 FB15k step of a 1x1 NCCL world and "
          f"the 2-layer {MAMBA} (1, 256) prefill, card against meta; the seam's host cost; "
          f"(c) python -m repro_torch.launch.dryrun on the production grid")
    tooling = dict(qwen=tooling_qwen(torch, np, dev, *qwen_weights))
    del qwen_weights
    free_card(torch)
    tooling["kge"] = tooling_kge(torch, np, kg)
    tooling["mamba"] = tooling_mamba(torch, np, dev)
    tooling["seam"] = seam_cost(torch, dev)
    free_card(torch)
    # (c) last, alone: with the dry runs beside phase 25, torch.profiler's
    # stop crashed the process (SIGSEGV) in the full Qwen step's trace
    dryruns = start_dryruns()
    try:
        tooling["dryrun"] = finish_dryruns(dryruns)
    finally:
        stop_dryruns(dryruns)
    tooling["seconds"] = time.perf_counter() - t26
    print(f"  phase 26 took {tooling['seconds']:.1f} s")

    launches_of = {"transe_l2": l2_launches, "transe_l1": l1_launches,
                   "distmult": dm_launches, "qwen_prefill": pre_launches,
                   "qwen_serve": serve_launches, "mamba2_prefill": m_pre_launches,
                   "mamba2_serve": m_serve_launches, **hog_launches,
                   **dist_launches, **pipe_launches, **dh_launches,
                   "mixtral_prefill": mx_pre_launches, "dbrx_prefill": dbrx_pre_launches,
                   "jamba_prefill": jb_pre_launches, "mixtral_serve": mx_serve_launches,
                   "jamba_serve": jb_serve_launches, "minicpm3_prefill": mla_pre_launches,
                   "minicpm3_serve": mla_serve_launches,
                   "whisper_prefill": wh_pre_launches, "whisper_serve": wh_serve_launches,
                   "llava_prefill": lv_pre_launches, "llava_serve": lv_serve_launches,
                   "qwen_train": tq_launches, "dbrx_train": td_launches,
                   "train_lm_smoke": ts_launches, "moe_train_world": tw_launches}
    kernels = []
    for r in rows:
        by_path = {p: n[r["name"]] for p, n in launches_of.items()}
        kernels.append(dict(
            name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=r["max_abs_err"], tol=r["tol"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], event_ms=r["event_ms"],
            shape=r["shape"],
            **{k: r[k] for k in ("fp32_bound_ms", "ref_err", "ref_tol", "library",
                                 "other_shapes", "plan") if k in r}))
        if r["name"] in ("l1_bwd_do", "l1_bwd_dn"):
            # the counter counts each product computed; on a path that asks
            # for both, the product ran inside the l1_bwd_pair launch, whose
            # row holds its time
            alone = {p: n[r["name"]] - n["l1_bwd_pair"] for p, n in launches_of.items()}
            kernels[-1].update(runs_in="l1_bwd_pair", launches_alone=sum(alone.values()),
                               launches_alone_by_path=alone)
    print(json.dumps({"paths": {"transe_l2": l2_path, "transe_l1": l1_path,
                                "distmult": dm_path, "qwen_prefill": pre_path, "qwen_serve": serve_path,
                                "mamba2_prefill": m_pre_path,
                                "mamba2_serve": m_serve_path, "hogwild": hog_path,
                                "distributed": dist_path, "pipelined": pipe_path,
                                "dist_hogwild": dh_path, "mixtral_prefill": mx_pre_path,
                                "dbrx_prefill": dbrx_pre_path,
                                "mixtral_serve": mx_serve_path,
                                "jamba_prefill": jb_pre_path,
                                "jamba_serve": jb_serve_path,
                                "minicpm3_prefill": mla_pre_path,
                                "minicpm3_serve": mla_serve_path,
                                "whisper_prefill": wh_pre_path,
                                "whisper_serve": wh_serve_path,
                                "llava_prefill": lv_pre_path,
                                "llava_serve": lv_serve_path,
                                "train": {"agreement": train_agree, "qwen": tq_path,
                                          "dbrx": td_path, "train_lm_smoke": ts_path,
                                          "moe_world": tw_rule},
                                "tooling": tooling}}, default=float))
    print(f"chip_smoke: 26 phases in {elapsed()}")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == TRAIN_MAIN_FLAG:
        sys.exit(train_child_main(sys.argv[2]))
    sys.exit(main())
