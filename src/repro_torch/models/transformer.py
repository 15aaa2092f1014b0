"""Architecture assembly of the LM zoo: decoders of attention or Mamba2
layers with dense or Mixture-of-Experts FFNs, an encoder-decoder, and a
vision frontend.

A port of the JAX package's models/transformer.py for every config of the
zoo: Qwen1.5-0.5B, H2O-Danube-1.8B (SWA), Minitron-4B, MiniCPM3-4B (MLA),
Mamba2-2.7B (attention-free, no FFN), Mixtral-8x7B (SWA, MoE), DBRX (MoE),
Jamba-1.5-Large (Mamba2 and attention 7:1, MoE every other layer),
Whisper-large-v3 (encoder-decoder) and LLaVA-NeXT-Mistral-7B (patch
embeddings over the leading positions). The layer kinds follow JAX's
``_pattern`` and the stacking its ``_period``. ``build_model(cfg,
grid=None)`` returns a ``Model`` exposing

    defs / init(gen, device) / cast(params)  parameters (JAX's tree layout)
    forward(params, inputs, use_flash)       logits for prefill
    hidden(params, inputs)                   final hidden states
    loss(params, inputs)                     next-token CE (JAX's train route)
    embed(params, tokens, inputs)            token (and patch) embeddings
    cache_defs(batch, seq) / init_caches     decode caches
    decode_step(params, caches, token, index) -> (logits, caches)

A Mamba2 layer runs the SSD scan through ``kernels.ssd_scan`` in
``forward`` (the CUDA kernel for tensors on the card, whatever
``use_flash`` says) and the recurrence in ``decode_step``; its decode
cache is the conv windows and the SSM state, written in place. An MLA
layer (``models/attention.py``) prefills on the chunked route and decodes
in the absorbed form against a cache of latents.

The parameter tree has JAX's keys and layout: with ``scan_layers`` (full
configs) the layers are stacked on a leading axis under ``layers/l0``; the
reduced configs keep ``layers/l0 .. l{n-1}`` apart. Where JAX scans over
the stack, the port loops in Python over views of it. ``forward`` casts
every f32 parameter of two or more dimensions to the config's dtype, as JAX
does; a stacked norm weight or bias is 2-D, so under ``scan_layers`` it is
cast too, and a full config computes in its dtype where the reduced one
promotes to f32 at its 1-D biases and norms. ``cast(params)`` does that
once, so a server holds the cast copy and the cast in ``forward`` finds
nothing left to do.

An MoE layer (``models/moe.py``) takes JAX's no-mesh route, every expert
on every token, unless the model has a ``grid`` (a ``launch/mesh.py``
``ProcessGrid``, where JAX has its mesh; the machine group is JAX's
``data`` axis, the model group its ``model`` axis): then it takes the
capacity-bounded route over the grid's model group, which may drop
token-choices, on this rank's experts (``moe.moe_defs(cfg, grid.S,
grid.s)``). Every other layer is whole on every rank and computes this
machine's batch rows (``machine_rows``): JAX shards attention, the dense
FFN and the embeddings over ``model`` only as a layout, so the numbers are
those of unsharded layers (a stated divergence: more memory a rank). The
vocab pads to ``128 * S`` with S > 1, else to 8, as JAX's does.
``forward_routes`` gives the logits with each MoE layer's expert choices,
which the routing rule compares.

Whisper (``enc_dec``): ``inputs["enc_frames"]`` (B, encoder_ctx, d_model),
precomputed frame embeddings as in JAX (the audio frontend is a stub),
go through the encoder once (``_encode``: rmsnorm, non-causal
self-attention with rope, rmsnorm, the dense FFN; then ``enc_final_ln``;
stacked under ``encoder`` with ``scan_layers``, else ``encoder/e{i}``);
every decoder layer adds ``ln_x`` and cross-attention to the encoder
output (``xattn``) between its mixer and its FFN, as JAX's
``_apply_layer`` does. Neither the encoder nor cross-attention launches a
kernel: JAX's flash branch needs causal self-attention. Its decode cache
adds ``xk``/``xv`` of ``encoder_ctx`` positions a layer, which
``decode_step`` reads; nothing in the package fills them (JAX's has no
cross-cache prefill either), so serving decodes against zero caches, as
JAX's serve does. LLaVA (``frontend == vision``): ``embed`` writes
``inputs["patch_embeds"]`` (B, nf, d_model) over the first nf positions;
decode feeds tokens only, as JAX's does.

Training (``loss``, ``models/steps.py::build_train_step``) takes JAX's
train route: attention and MLA on the chunked route, Mamba2 on the plain
chunked scan (``ssm.mamba_train(scan=)``), so no kernel of the port runs
under autograd; with ``cfg.remat`` each layer group, and each stacked
encoder layer, runs under ``torch.utils.checkpoint``, as JAX remats its
scan bodies. With a grid the MoE layers' collectives give JAX's
gradients (``moe.moe_local``).

``params_from_arrays`` / ``params_to_arrays`` carry weights between the
JAX package (nested numpy arrays) and the port; with a grid,
``params_from_arrays`` keeps this rank's slice of JAX's global arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ArchConfig, FFNKind, Frontend, MixerKind
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_batched
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import (
    ParamDef, chunked_cross_entropy, cross_entropy_logits, materialize, matmul, rmsnorm,
    stack_defs, torch_dtype, tree_map,
)

Params = Dict[str, Any]


def unported(cfg: ArchConfig) -> Optional[str]:
    """Why ``cfg`` does not run in the port, or None: only a layer pattern
    that JAX's ``mixer_of`` does not know."""
    if cfg.mixer_pattern in ("attn", "mamba", "jamba"):
        return None
    return (f"{cfg.name}: the {cfg.mixer_pattern} layer pattern is not ported to "
            "repro_torch: ROADMAP Queue A10")


Kind = Tuple[MixerKind, FFNKind]


def _pattern(cfg: ArchConfig) -> List[Kind]:
    return [(cfg.mixer_of(i), cfg.ffn_of(i)) for i in range(cfg.n_layers)]


def _encoder_layer_defs(cfg: ArchConfig) -> Dict[str, Any]:
    """One encoder layer: ln1, self-attention, ln2, the dense FFN."""
    d = cfg.d_model
    return {"ln1": ParamDef((d,), init="ones"), "attn": A.attn_defs(cfg),
            "ln2": ParamDef((d,), init="ones"), "ffn": M.ffn_defs(cfg)}


def _period(pat: List[Kind]) -> int:
    n = len(pat)
    for p in range(1, n + 1):
        if n % p == 0 and all(pat[i] == pat[i % p] for i in range(n)):
            return p
    return n


def _layer_defs(cfg: ArchConfig, kind: Kind, model_par: int = 1, part: int = 0,
                cross: bool = False) -> Dict[str, Any]:
    """One layer: ln1 and its mixer (``attn`` or ``mamba``), with ``cross``
    (a Whisper decoder layer) ``ln_x`` and the cross-attention ``xattn``,
    then ``ln2`` and the ``moe`` of an MoE layer (rank ``part``'s experts of
    a model group of ``model_par``), or the dense ``ffn`` when d_ff > 0
    (Mamba2 has none)."""
    mixer, ffn = kind
    d = cfg.d_model
    out: Dict[str, Any] = {"ln1": ParamDef((d,), init="ones")}
    if mixer == MixerKind.ATTN:
        out["attn"] = A.attn_defs(cfg)
    else:
        out["mamba"] = SSM.mamba_defs(cfg)
    if cross:
        out["ln_x"] = ParamDef((d,), init="ones")
        out["xattn"] = A.attn_defs(cfg, cross=True)
    if ffn == FFNKind.MOE:
        out["ln2"] = ParamDef((d,), init="ones")
        out["moe"] = M.moe_defs(cfg, model_par, part)
    elif cfg.d_ff > 0:
        out["ln2"] = ParamDef((d,), init="ones")
        out["ffn"] = M.ffn_defs(cfg)
    return out


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    grid: Any = None  # a ProcessGrid: the MoE layers' capacity-bounded route

    def __post_init__(self):
        why = unported(self.cfg)
        if why:
            raise NotImplementedError(why)
        cfg = self.cfg
        self.pattern = _pattern(cfg)
        self.period = _period(self.pattern) if cfg.scan_layers else cfg.n_layers
        self.n_groups = cfg.n_layers // self.period
        self.kinds = [self.pattern[i % self.period] for i in range(cfg.n_layers)]
        self.dtype = torch_dtype(cfg.dtype)
        if cfg.parallel == "dp" and cfg.moe_period:
            raise ValueError(f"{cfg.name}: dp mode takes no MoE layer (its experts "
                             "need the model group), as JAX's asserts")
        self._build_defs()

    # ---------------------------------------------------------------- params
    def _build_defs(self):
        cfg = self.cfg
        S = self.grid.S if self.grid is not None else 1
        part = self.grid.s if self.grid is not None else 0
        # JAX pads so the table shards evenly over 'model' (and 128-aligns)
        mult = 128 * S if S > 1 else 8
        self.padded_vocab = -(-cfg.vocab_size // mult) * mult
        d: Dict[str, Any] = {
            "tok_emb": ParamDef((self.padded_vocab, cfg.d_model), init="normal",
                                scale=0.02)}
        if not cfg.tie_embeddings:
            d["unembed"] = ParamDef((cfg.d_model, self.padded_vocab), init="fan_in")
        d["final_ln"] = ParamDef((cfg.d_model,), init="ones")
        per_group = {f"l{j}": _layer_defs(cfg, self.pattern[j], S, part,
                                          cross=cfg.enc_dec)
                     for j in range(self.period)}
        d["layers"] = (stack_defs([per_group] * self.n_groups) if self.n_groups > 1
                       else per_group)
        # JAX stacks the encoder with scan_layers, else keeps e0 .. e{n-1}
        n_enc = cfg.n_encoder_layers
        self.enc_scan = cfg.enc_dec and n_enc > 1 and cfg.scan_layers
        if cfg.enc_dec:
            d["encoder"] = (stack_defs([_encoder_layer_defs(cfg)] * n_enc) if self.enc_scan
                            else {f"e{i}": _encoder_layer_defs(cfg) for i in range(n_enc)})
            d["enc_final_ln"] = ParamDef((cfg.d_model,), init="ones")
        if cfg.param_dtype != "float32":
            pd = torch_dtype(cfg.param_dtype)
            d = tree_map(lambda x: dataclasses.replace(x, dtype=pd)
                         if len(x.shape) >= 2 else x, d)
        self.defs = d

    def init(self, gen: torch.Generator, device="cpu") -> Params:
        """Parameters drawn from ``gen`` (on its device) by the JAX package's
        init rules, then moved to ``device``. With a grid of S > 1 ranks,
        this rank's slice of what the model without a grid draws from the
        same generator (at the same padded vocab): each expert tensor is
        drawn whole, in f32, then sliced, so a rank's draw needs one
        layer's global expert tensor beside its own slices."""
        return materialize(self.defs, gen, device)

    def cast(self, params: Params) -> Params:
        """Every f32 tensor of two or more dimensions in the config's dtype;
        a tensor already in it is kept, not copied."""
        return tree_map(lambda a: a.to(self.dtype)
                        if a.dtype == torch.float32 and a.dim() >= 2 else a, params)

    def sliced(self):
        """Per parameter, ``(axis, parts)`` where it is this rank's slice of
        a global tensor (an expert tensor over the grid's model group),
        else None: what ``optim.dense.adafactor`` takes its group means
        by."""
        return tree_map(lambda d: (d.axis, d.parts) if d.parts > 1 else None, self.defs)

    def _layers(self, layers) -> Iterator[Dict[str, Any]]:
        """Each layer's tree, in order: views into the stack under
        ``scan_layers``."""
        for gi in range(self.n_groups):
            pg = layers if self.n_groups == 1 else tree_map(lambda a: a[gi], layers)
            for j in range(self.period):
                yield pg[f"l{j}"]

    # --------------------------------------------------------------- forward
    def _ffn(self, x, p, kind: Kind):
        cfg = self.cfg
        if kind[1] == FFNKind.MOE:
            h = rmsnorm(x, p["ln2"], cfg.norm_eps)
            return x + M.moe_apply(p["moe"], h, cfg, self.grid)
        if cfg.d_ff <= 0:
            return x
        return x + M.ffn_apply(p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)

    def _mix(self, x, p, kind: Kind, use_flash=False, enc_out=None, scan=ssd_scan):
        """x plus the layer's mixer of it, then plus its cross-attention to
        ``enc_out`` when given (the FFN's input). ``scan`` is a Mamba2
        layer's SSD scan (``ssm.mamba_train``)."""
        cfg = self.cfg
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        if kind[0] == MixerKind.ATTN:
            h = A.attention_train(p["attn"], h, cfg, causal=True, use_flash=use_flash)
        else:
            h = SSM.mamba_train(p["mamba"], h, cfg, scan=scan)
        x = x + h
        if enc_out is not None:
            h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
            x = x + A.attention_train(p["xattn"], h, cfg, kv_src=enc_out)
        return x

    def _apply_layer(self, x, p, kind: Kind, use_flash=False, enc_out=None, scan=ssd_scan):
        return self._ffn(self._mix(x, p, kind, use_flash=use_flash, enc_out=enc_out,
                                   scan=scan), p, kind)

    def _remat(self) -> bool:
        """JAX's ``cfg.remat``: recompute in the backward pass. Only where
        autograd records (serving builds no graph)."""
        return self.cfg.remat and torch.is_grad_enabled()

    def _unembed(self, cast, x):
        w = cast["tok_emb"].T if self.cfg.tie_embeddings else cast["unembed"]
        return matmul(x, w)

    def embed(self, params, tokens, inputs=None):
        """The token embeddings in the config's dtype; with the vision
        frontend and ``inputs["patch_embeds"]`` (B, nf, d_model), those of
        the first nf positions replaced by the patches, cast to the same
        type (JAX's ``dynamic_update_slice``, which takes no nf > T)."""
        x = params["tok_emb"][tokens.long()].to(self.dtype)
        if self.cfg.frontend == Frontend.VISION and inputs and "patch_embeds" in inputs:
            pe = inputs["patch_embeds"]
            if pe.dim() != 3 or pe.shape[1] > x.shape[1] or pe.shape[0] != x.shape[0] \
                    or pe.shape[2] != x.shape[2]:
                raise ValueError(f"patch_embeds {tuple(pe.shape)} do not fit over the "
                                 f"leading positions of embeddings {tuple(x.shape)}")
            x[:, :pe.shape[1]] = pe.to(x.dtype)  # x is the gather's own copy
        return x

    def _encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The Whisper encoder on precomputed frame embeddings (B, S,
        d_model), cast to the config's dtype: each layer rmsnorm,
        non-causal self-attention (rope, the chunked route), residual,
        rmsnorm, the dense FFN, residual; then ``enc_final_ln``."""
        cfg = self.cfg
        x = frames.to(self.dtype)
        enc = params["encoder"]
        layers = ((tree_map(lambda a: a[i], enc) for i in range(cfg.n_encoder_layers))
                  if self.enc_scan else
                  (enc[f"e{i}"] for i in range(cfg.n_encoder_layers)))
        def layer(x, p):
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            x = x + A.attention_train(p["attn"], h, cfg, causal=False)
            h = rmsnorm(x, p["ln2"], cfg.norm_eps)
            return x + M.ffn_apply(p["ffn"], h, cfg)

        # JAX remats the encoder layer only where it scans the stack
        remat = self.enc_scan and self._remat()
        for p in layers:
            x = checkpoint(layer, x, p, use_reentrant=False) if remat else layer(x, p)
        return rmsnorm(x, params["enc_final_ln"], cfg.norm_eps)

    def _inputs(self, cast, inputs):
        """(the embeddings, the encoder's output or None) of ``inputs``."""
        x = self.embed(cast, inputs["tokens"], inputs)
        enc_out = self._encode(cast, inputs["enc_frames"]) if self.cfg.enc_dec else None
        return x, enc_out

    def hidden(self, params: Params, inputs: Dict[str, torch.Tensor],
               use_flash: bool = False, scan=ssd_scan) -> torch.Tensor:
        """Final hidden states (forward minus unembedding). With
        ``cfg.remat`` under autograd each layer group (the ``period``
        layers JAX's scan body holds; all layers where JAX does not scan)
        runs under ``torch.utils.checkpoint``, as JAX's ``_run_layers``
        remats it: the same numbers, its activations recomputed in the
        backward pass."""
        cast = self.cast(params)
        x, enc_out = self._inputs(cast, inputs)
        layers = list(zip(self.kinds, self._layers(cast["layers"])))

        def group(x, *span):
            for kind, p in span:
                x = self._apply_layer(x, p, kind, use_flash=use_flash, enc_out=enc_out,
                                      scan=scan)
            return x

        remat = self._remat()
        for g0 in range(0, len(layers), self.period):
            span = layers[g0:g0 + self.period]
            x = checkpoint(group, x, *span, use_reentrant=False) if remat else group(x, *span)
        return rmsnorm(x, cast["final_ln"], self.cfg.norm_eps)

    def forward(self, params: Params, inputs: Dict[str, torch.Tensor],
                use_flash: bool = False) -> torch.Tensor:
        """Logits (B, T, padded_vocab) of ``inputs["tokens"]`` (B, T), with
        Whisper's ``enc_frames`` and LLaVA's ``patch_embeds`` where given."""
        cast = self.cast(params)
        return self._unembed(cast, self.hidden(cast, inputs, use_flash=use_flash))

    def loss(self, params: Params, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """JAX's ``Model.loss``: the mean next-token CE of
        ``inputs["labels"]`` (position t predicts label t + 1), over the
        full logits, or with ``cfg.ce_chunk`` over the hidden states and
        ``chunked_cross_entropy``. The CE alone: JAX's docstring says "+
        MoE aux implicitly", but its ``moe_apply`` drops ``aux``. The train
        route is JAX's: attention and MLA on the chunked route (no flash),
        Mamba2 on the plain ``ssd_chunked_batched``; no kernel of the port
        runs, as JAX's training reaches no Pallas kernel."""
        cfg = self.cfg
        labels = inputs["labels"]
        cast = self.cast(params)
        x = self.hidden(cast, inputs, use_flash=False, scan=ssd_chunked_batched)
        if cfg.ce_chunk:
            w = cast["tok_emb"].T if cfg.tie_embeddings else cast["unembed"]
            return chunked_cross_entropy(x[:, :-1], w.to(self.dtype), labels[:, 1:],
                                         cfg.ce_chunk)
        logits = self._unembed(cast, x)
        return cross_entropy_logits(logits[:, :-1], labels[:, 1:], cfg.vocab_size)

    # ---------------------------------------------------------------- decode
    def cache_defs(self, batch: int, seq: int) -> Dict[str, Any]:
        """Per layer: the k and v cache of an attention layer (the latents
        and rope keys of an MLA one), the conv windows and SSM state of a
        Mamba2 layer; with ``enc_dec`` also the cross cache of
        ``encoder_ctx`` positions. Under a grid ``batch`` is this machine's
        rows."""
        cross = self.cfg.encoder_ctx if self.cfg.enc_dec else 0

        def one(kind):
            if kind[0] == MixerKind.ATTN:
                return A.cache_defs(self.cfg, batch, seq, cross_len=cross)
            return SSM.mamba_state_defs(self.cfg, batch)

        per_group = {f"l{j}": one(self.pattern[j]) for j in range(self.period)}
        if self.n_groups > 1:
            return stack_defs([per_group] * self.n_groups)
        return per_group

    def init_caches(self, batch: int, seq: int, device="cpu") -> Dict[str, Any]:
        """Zeroed decode caches for ``batch`` sequences of ``seq`` tokens."""
        return materialize(self.cache_defs(batch, seq), None, device)

    def decode_step(self, params: Params, caches, token: torch.Tensor, index: int):
        """token: (B, 1) ids at position ``index``. Writes the caches in
        place (JAX returns new ones) and returns (logits, caches). A
        decoder layer of ``enc_dec`` cross-attends to its ``xk``/``xv``
        after its self-attention; no patches are fed, as in JAX."""
        cfg = self.cfg
        cast = self.cast(params)
        x = self.embed(cast, token)  # (B, 1, D)
        for kind, p, c in zip(self.kinds, self._layers(cast["layers"]),
                              self._layers(caches)):
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            if kind[0] == MixerKind.ATTN:
                h, _ = A.attention_decode(p["attn"], h, c, index, cfg)
            else:
                h, _ = SSM.mamba_decode(p["mamba"], h, c, cfg)
            x = x + h
            if cfg.enc_dec:
                h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
                x = x + A.cross_attention_decode(p["xattn"], h, c, cfg)
            x = self._ffn(x, p, kind)
        x = rmsnorm(x, cast["final_ln"], cfg.norm_eps)
        return self._unembed(cast, x), caches


def build_model(cfg: ArchConfig, grid=None) -> Model:
    return Model(cfg=cfg, grid=grid)


# ------------------------------------------------------------- the batch rows
def machine_rows(grid, batch: int) -> slice:
    """The rows of a global batch that this rank computes: with the batch
    split over the grid's M machines (``batch % M == 0``) machine m's
    ``batch / M``, so an MoE layer's capacity is per data shard; otherwise
    every row, replicated over the machines, as JAX replicates a decode
    batch that does not split (``decode_step``'s ``moe_axes``) and its
    caches with it. The same rule for prefill, decode and caches."""
    if grid is None or batch % grid.M:
        return slice(0, batch)
    n = batch // grid.M
    return slice(grid.m * n, (grid.m + 1) * n)


def gather_rows(grid, x: torch.Tensor, batch: int) -> torch.Tensor:
    """The global batch (``batch`` rows along axis 0) from each machine's
    ``machine_rows`` of it: an all_gather over the machine group when the
    batch is split, else ``x`` as it is."""
    from repro_torch.common import collectives

    if grid is None or batch % grid.M or grid.M == 1:
        return x
    return collectives.all_gather_plain(x, grid.machine_group, axis=0)


# ------------------------------------------------------------ weights across
def params_from_arrays(model: Model, tree, device="cpu") -> Params:
    """The port's parameters from the JAX package's tree of numpy arrays
    (``jax.tree.map(np.asarray, params)``) of the same config: stacked
    under ``layers/l0`` for a config with ``scan_layers``, per layer
    (``layers/l0 .. l{n-1}``) for a reduced one, an MoE layer's expert
    tensors then (L, E, d, ff) and (E, d, ff). Keys and global shapes must
    match the model's defs; a def that is this rank's slice (a grid of S >
    1) keeps its slice of JAX's global array."""

    def conv(defs, arrs, path):
        if isinstance(defs, dict):
            if not isinstance(arrs, dict) or set(arrs) != set(defs):
                got = sorted(arrs) if isinstance(arrs, dict) else type(arrs).__name__
                raise ValueError(f"params{path}: expected keys {sorted(defs)}, got {got}")
            return {k: conv(defs[k], arrs[k], f"{path}/{k}") for k in defs}
        a = np.asarray(arrs, dtype=np.float32)
        if a.shape != defs.global_shape:
            raise ValueError(f"params{path}: expected shape {defs.global_shape}, "
                             f"got {a.shape}")
        return torch.tensor(defs.local(a), dtype=defs.dtype, device=device)

    return conv(model.defs, tree, "")


def params_to_arrays(params: Params):
    """The JAX package's layout as nested numpy arrays (f32)."""
    return tree_map(lambda t: t.detach().cpu().float().numpy(), params)


# ------------------------------------------------------------ the routing rule
@torch.no_grad()
def forward_routes(model: Model, params: Params, inputs: Dict[str, torch.Tensor],
                   use_flash: bool = False):
    """``model.forward`` walked layer by layer, with the expert choices of
    each MoE layer: (logits, [expert ids (B*T, k) per MoE layer]). The
    choices are ``moe.route``'s on the same input the layer routes, so a
    comparison of two runs can leave out the tokens whose choices differ
    (``moe.flipped``)."""
    cfg = model.cfg
    cast = model.cast(params)
    x, enc_out = model._inputs(cast, inputs)
    sets = []
    for kind, p in zip(model.kinds, model._layers(cast["layers"])):
        x = model._mix(x, p, kind, use_flash=use_flash, enc_out=enc_out)
        if kind[1] == FFNKind.MOE:
            h = rmsnorm(x, p["ln2"], cfg.norm_eps)
            sets.append(M.route(p["moe"], h.reshape(-1, cfg.d_model), cfg)[2])
        x = model._ffn(x, p, kind)
    x = rmsnorm(x, cast["final_ln"], cfg.norm_eps)
    return model._unembed(cast, x), sets


def routing_rule(got, want, got_sets=None, want_sets=None, tol: float = 2e-3):
    """Two runs' logits (B, T, V) compared under the routing rule: a token
    whose top-k expert set differs between the runs in any MoE layer
    (``got_sets``/``want_sets``, as ``forward_routes`` gives them) sits at a
    near-tie and is counted as off, not compared. Per token, the largest
    |got - want| over the vocab, one batch row at a time. Returns {flipped:
    the share of flipped tokens; within: the share of all tokens unflipped
    and within ``bound`` = tol x max(1, max|want|); median, q90: quantiles
    of the per-token errors, a flipped token's counted as infinite;
    max_other: the largest error of an unflipped token; max_logit}."""
    import math

    B, T = want.shape[:2]
    err = torch.cat([(g.float() - w.to(g.device).float()).abs().amax(-1).cpu()
                     for g, w in zip(got, want)]).reshape(-1)
    off = (M.flipped(got_sets, want_sets, (B, T)).reshape(-1) if got_sets is not None
           else torch.zeros(B * T, dtype=torch.bool))
    top = float(want.float().abs().max())
    bound = tol * max(1.0, top)
    ranked = torch.where(off, torch.full_like(err, math.inf), err).double()
    q50, q90 = (float(v) for v in torch.quantile(
        ranked, torch.tensor([0.5, 0.9], dtype=torch.float64), interpolation="higher"))
    return dict(flipped=float(off.float().mean()),
                within=float(((~off) & (err <= bound)).float().mean()), bound=bound,
                median=q50, q90=q90,
                max_other=float(err[~off].max()) if bool((~off).any()) else math.inf,
                max_logit=top)
