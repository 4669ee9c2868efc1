"""Decoder LM of the port: stages of attention, MLA or Mamba + dense-FFN
or MoE layers.

Counterpart of ``repro.models.transformer`` for its decoder-only
subset.  A model is a sequence of *stages*; each stage is a pattern of layers
(``LayerSpec``) repeated ``repeat`` times with STACKED params and caches
(leading axis = repeat), exactly the reference's layout, so params and
caches compare leaf for leaf across the two packages.  The reference
scans the repeats with ``lax.scan``; here a Python loop indexes the
stacks.

Layer = pre-norm mixer + pre-norm FFN, both residual; the norm is
RMSNorm or LayerNorm (``TransformerCfg.norm``).  The ``attn``, ``mla``
and ``mamba`` mixers and the ``dense`` and ``moe`` FFNs are ported; a
MoE layer adds its load-balance loss to the model's.  A Mamba layer has
no chunked-prefill path (its recurrent state depends on every value
before it): a chunked call on one raises, as the reference's does.
``mtp`` adds deepseek-v3's multi-token-prediction head to the loss.
``embed_inputs=False`` (qwen2-vl-7b) drops the embedding table: the
batch carries ``inputs_embeds`` from a frontend instead of ``tokens``,
and its ``positions`` ((3, B, S) under M-RoPE) reach every attention
layer, in prefill and decode alike.  ``remat`` / ``remat_policy`` are
the reference's: the training forward checkpoints each stage's block
(``apply_stage``, ``models.remat``); the MTP block runs outside the
stages and is not checkpointed, as in the reference.

Tensor parallelism (``tp_index``, the rank's coordinate on "model"):
``cfg`` is then the rank's local config (``local_config``: its
attention, MLA or Mamba heads, its FFN columns, its vocabulary block)
and the params its shard (``parallel.sharding``; a MoE layer's experts
split over "model", see ``models.moe.moe_forward_sharded``, a Mamba
mixer's heads ``models.mamba``).  The embedding is vocab-parallel (a
model without an embedding table takes its ``inputs_embeds`` and
``positions`` whole on every rank), each pre-norm output enters its
column-parallel product through *f* and each row-parallel product leaves
through *g*, the residual stream is cut ahead of each norm for the
staged backward, and the loss is the vocab-parallel cross-entropy over
the rank's ``lm_head`` columns.  MLA's latents are computed whole on
every rank from the *f* of the normed input, so its low-rank leaves'
gradients are partial sums.  The MTP head embeds the next tokens
vocab-parallel, runs its block over the shard and reads the final
normed hidden ahead of the head's *f* (``loss_fn``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import remat as R
from repro_torch.parallel import sharding as S
from repro_torch.tree import map_tree

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"            # attn | mla | mamba
    ffn: str = "dense"             # dense | moe | none


@dataclasses.dataclass(frozen=True)
class StageSpec:
    layers: Tuple[LayerSpec, ...]
    repeat: int


@dataclasses.dataclass(frozen=True)
class TransformerCfg:
    name: str
    d_model: int
    vocab_size: int
    stages: Tuple[StageSpec, ...]
    attn: Optional[L.AttentionCfg] = None
    mla: Optional[MLA.MLACfg] = None
    mamba: Optional[M.MambaCfg] = None
    mlp: Optional[L.MLPCfg] = None
    moe: Optional[MOE.MoECfg] = None
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    embed_inputs: bool = True      # False: caller feeds inputs_embeds (VLM)
    mtp: bool = False              # deepseek-v3 multi-token prediction head
    mtp_loss_weight: float = 0.3
    param_dtype: Any = torch.float32
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots
    block_k: int = 512             # training attention kv block
    #: the port's: the parts a model rank's local config holds whole
    #: (``sharding.TPLayout.whole``: "attn", "vocab")
    tp_whole: Tuple[str, ...] = ()

    @property
    def num_layers(self) -> int:
        return sum(len(st.layers) * st.repeat for st in self.stages)


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in ("attn", "mla", "mamba"):
        raise NotImplementedError(
            f"mixer {spec.mixer!r} arrives with the port's "
            "remaining-model-families slice")
    if spec.ffn not in ("dense", "moe", "none"):
        raise NotImplementedError(
            f"ffn {spec.ffn!r} arrives with the port's "
            "remaining-model-families slice")


# ---------------------------------------------------------------------------
# Norm dispatch
# ---------------------------------------------------------------------------


def _init_norm(cfg: TransformerCfg, device, lead: Tuple[int, ...] = ()):
    if cfg.norm == "layernorm":
        return L.init_layernorm(cfg.d_model, cfg.param_dtype, device, lead)
    return L.init_rmsnorm(cfg.d_model, cfg.param_dtype, device, lead)


def _norm(cfg: TransformerCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return L.layernorm(p, x)
    return L.rmsnorm(p, x)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def init_layer(gen, cfg: TransformerCfg, spec: LayerSpec, device,
               lead: Tuple[int, ...] = ()) -> Params:
    _check_spec(spec)
    dt = cfg.param_dtype
    p: Params = {"norm_mixer": _init_norm(cfg, device, lead)}
    if spec.mixer == "attn":
        p["attn"] = L.init_attention(gen, cfg.attn, dt, device, lead)
    elif spec.mixer == "mla":
        p["mla"] = MLA.init_mla(gen, cfg.mla, dt, device, lead)
    else:
        p["mamba"] = M.init_mamba(gen, cfg.mamba, dt, device, lead)
    if spec.ffn != "none":
        p["norm_ffn"] = _init_norm(cfg, device, lead)
    if spec.ffn == "dense":
        p["mlp"] = L.init_mlp(gen, cfg.mlp, dt, device, lead)
    elif spec.ffn == "moe":
        p["moe"] = MOE.init_moe(gen, cfg.moe, dt, device, lead)
    return p


def local_config(cfg: TransformerCfg, lay: S.TPLayout) -> TransformerCfg:
    """The config one model rank computes: its query and KV heads (MLA's
    and Mamba's heads too), its FFN columns or its experts, and its
    vocabulary block (the shapes of its shard; routing still scores
    every expert)."""
    return dataclasses.replace(
        cfg, vocab_size=lay.vocab, tp_whole=lay.whole,
        attn=None if cfg.attn is None
        else L.local_attention(cfg.attn, lay.heads, lay.kv_heads),
        mla=None if cfg.mla is None
        else dataclasses.replace(cfg.mla, num_heads=lay.mla_heads),
        mamba=None if cfg.mamba is None
        else dataclasses.replace(cfg.mamba, head_shards=lay.model),
        mlp=None if cfg.mlp is None
        else dataclasses.replace(cfg.mlp, d_ff=lay.d_ff),
        moe=None if cfg.moe is None
        else dataclasses.replace(cfg.moe, expert_shards=lay.model))


def _identity(x):
    return x


def _tp_ops(tp: bool):
    """(cut, f, g): the staged-backward cut (the identity without a tape;
    a step that splits over "data" has one without a model axis too)
    and the two Megatron operators with a model axis, identities
    without."""
    if tp:
        return S.cut, S.copy_to_model, S.reduce_from_model
    return S.cut, _identity, _identity


def apply_layer(params: Params, cfg: TransformerCfg, spec: LayerSpec,
                x: torch.Tensor, *, positions: Optional[torch.Tensor] = None,
                q_offset: int = 0,
                cache: Optional[Params] = None, decode: bool = False,
                chunked: bool = False, valid_len: Optional[int] = None,
                train: bool = False, tp: bool = False
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (x_out, new_cache, aux_loss).  ``positions``: the batch's
    (B, S) or M-RoPE (3, B, S) positions for an attention mixer (None:
    text positions).  ``tp``: the params are a model rank's shard (see
    the module doc)."""
    _check_spec(spec)
    cut, f, g = _tp_ops(tp)
    x = cut(x)
    # an attention every model rank holds whole runs without f and g
    fm, gm = ((_identity, _identity)
              if spec.mixer == "attn" and "attn" in cfg.tp_whole else (f, g))
    h = fm(_norm(cfg, params["norm_mixer"], x))
    if spec.mixer == "mamba":
        if chunked:
            raise ValueError(
                "mamba mixers have value-dependent recurrent state and "
                "no chunked-prefill path (Model.supports_chunked_prefill "
                "gates this)")
        if decode:
            out, new_cache = M.mamba_decode(params["mamba"], cfg.mamba, h,
                                            cache)
        else:
            out, new_cache = M.mamba_forward(params["mamba"], cfg.mamba, h,
                                             cache=cache)
    elif spec.mixer == "mla":
        if decode:
            out, new_cache = MLA.mla_decode(params["mla"], cfg.mla, h, cache)
        else:
            out, new_cache = MLA.mla_forward(
                params["mla"], cfg.mla, h, q_offset=q_offset, kv_cache=cache,
                chunked=chunked, valid_len=valid_len, train=train,
                block_k=cfg.block_k)
    elif decode:
        out, new_cache = L.attention_decode(params["attn"], cfg.attn, h,
                                            cache, positions=positions)
    else:
        out, new_cache = L.attention_forward(
            params["attn"], cfg.attn, h, positions=positions,
            q_offset=q_offset, kv_cache=cache,
            chunked=chunked, valid_len=valid_len, train=train,
            block_k=cfg.block_k)
    x = x + gm(out)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "dense":
        x = cut(x)
        h = f(_norm(cfg, params["norm_ffn"], x))
        x = x + g(L.mlp_forward(params["mlp"], cfg.mlp, h))
    elif spec.ffn == "moe":
        x = cut(x)
        y, aux = MOE.moe_apply(params["moe"], cfg.moe,
                               _norm(cfg, params["norm_ffn"], x))
        x = x + y
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Stages (stacked params, a loop over repeat)
# ---------------------------------------------------------------------------


def init_stage(gen, cfg: TransformerCfg, stage: StageSpec, device) -> Params:
    return {f"layer{i}": init_layer(gen, cfg, spec, device, (stage.repeat,))
            for i, spec in enumerate(stage.layers)}


#: The cache leaves a mixer's step returns anew, to be stacked over the
#: stage's repeats; the others (K/V rows, MLA's latents) it writes in
#: place.
_CARRIED = {"attn": ("len",), "mla": ("len",), "mamba": ("conv", "ssm")}


def apply_stage(params_stage: Params, cfg: TransformerCfg, stage: StageSpec,
                x: torch.Tensor, *, positions: Optional[torch.Tensor] = None,
                q_offset: int = 0,
                caches: Optional[Params] = None, decode: bool = False,
                chunked: bool = False, valid_len: Optional[int] = None,
                train: bool = False, tp: bool = False
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Run the stage's ``repeat`` blocks; returns (x, caches, the sum of
    their aux losses).  ``caches``: stacked cache tree with leading dim
    = repeat (or None).  Cache rows (K/V, or MLA's latents) are written
    into the stacked tensors in place; the ``len`` counters and Mamba's
    ``conv`` / ``ssm`` state come back stacked.

    With ``cfg.remat`` the training forward checkpoints each block (one
    repeat of all of ``stage.layers``, the reference's scanned ``block``)
    under ``cfg.remat_policy`` (``models.remat``): through
    ``torch.utils.checkpoint`` without a model axis, and on the staged
    backward's tape over one (``tp``), whose rerun runs on the rank's
    thread and issues the block's collectives again in order."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if caches is None and R.active(cfg.remat, train):

        def block(x, layer_params):
            auxes = []
            for i, spec in enumerate(stage.layers):
                x, _, aux = apply_layer(layer_params[f"layer{i}"], cfg, spec,
                                        x, positions=positions,
                                        q_offset=q_offset, train=True, tp=tp)
                auxes.append(aux)
            return (x, *auxes)

        def repeat(x, r):
            y, *auxes = block(x, S.gathered(params_stage, r))
            return y, auxes

        for r in range(stage.repeat):
            if tp or S.on_tape():
                x, auxes = R.staged(functools.partial(repeat, r=r), x,
                                    policy=cfg.remat_policy)
            else:
                x, *auxes = R.checkpointed(
                    block, x, map_tree(lambda t: t[r], params_stage),
                    policy=cfg.remat_policy)
            for aux in auxes:            # in layer order, as without remat
                aux_total = aux_total + aux
        return x, None, aux_total
    carried = {f"layer{i}": {k: [] for k in _CARRIED[spec.mixer]}
               for i, spec in enumerate(stage.layers)}
    for r in range(stage.repeat):
        for i, spec in enumerate(stage.layers):
            name = f"layer{i}"
            cache_r = None if caches is None else \
                map_tree(lambda t: t[r], caches[name])
            x, nc, aux = apply_layer(
                S.gathered(params_stage[name], r), cfg, spec, x,
                positions=positions, q_offset=q_offset, cache=cache_r,
                decode=decode, chunked=chunked, valid_len=valid_len,
                train=train, tp=tp)
            aux_total = aux_total + aux
            if caches is not None:
                for k, acc in carried[name].items():
                    acc.append(nc[k])
    if caches is None:
        return x, None, aux_total
    return x, {name: {**caches[name],
                      **{k: torch.stack(acc)
                         for k, acc in carried[name].items()}}
               for name in caches}, aux_total


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


def init_params(gen: Optional[torch.Generator], cfg: TransformerCfg,
                device) -> Params:
    """Random params on ``device`` from ``gen`` (``None``: uninitialised,
    for shape probes on the ``meta`` device).  No ``embed`` leaf when
    ``embed_inputs`` is False.  With ``mtp`` the MTP head too: two norms,
    the (2D, D) projection and one layer of the last stage's spec,
    unstacked (the reference's ``init_params``)."""
    dt = cfg.param_dtype
    p: Params = {}
    if cfg.embed_inputs:
        p["embed"] = L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                  device)
    for i, stage in enumerate(cfg.stages):
        p[f"stage{i}"] = init_stage(gen, cfg, stage, device)
    p["final_norm"] = _init_norm(cfg, device)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                    device)
    if cfg.mtp:
        p["mtp_norm1"] = _init_norm(cfg, device)
        p["mtp_norm2"] = _init_norm(cfg, device)
        p["mtp_proj"] = L.dense_init(gen, (2 * cfg.d_model, cfg.d_model), dt,
                                     device)
        p["mtp_block"] = init_layer(gen, cfg, _mtp_spec(cfg), device)
    return p


def _mtp_spec(cfg: TransformerCfg) -> LayerSpec:
    """The MTP block's layer: the last stage's last spec."""
    return cfg.stages[-1].layers[-1]


def _unembed(params: Params, cfg: TransformerCfg, h: torch.Tensor
             ) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ S.gathered(params["embed"]).T
    return h @ S.gathered(params["lm_head"])


def forward(params: Params, cfg: TransformerCfg,
            batch: Dict[str, torch.Tensor], *,
            caches: Optional[Params] = None, q_offset: int = 0,
            decode: bool = False, chunked: bool = False,
            valid_len: Optional[int] = None, train: bool = False,
            tp_index: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (hidden (B, S, D), new_caches, aux_loss).  ``batch``
    holds ``tokens`` (B, S), or ``inputs_embeds`` (B, S, D) when
    ``cfg.embed_inputs`` is False, and optionally ``positions``.
    ``train=True`` is the differentiable training forward (see
    ``layers.train_attention``); ``tp_index`` the rank's model coordinate
    when ``params`` is its shard (the hidden state then enters the
    unembedding through *f*)."""
    h, new_caches, aux = _final_hidden(
        params, cfg, batch, caches=caches, q_offset=q_offset, decode=decode,
        chunked=chunked, valid_len=valid_len, train=train, tp_index=tp_index)
    _, f, _ = _tp_ops(tp_index is not None)
    return f(h), new_caches, aux


def _final_hidden(params: Params, cfg: TransformerCfg,
                  batch: Dict[str, torch.Tensor], *,
                  caches: Optional[Params] = None, q_offset: int = 0,
                  decode: bool = False, chunked: bool = False,
                  valid_len: Optional[int] = None, train: bool = False,
                  tp_index: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """``forward`` up to the final norm's output, ahead of the head's
    *f* (whole on every model rank)."""
    tp = tp_index is not None
    if not cfg.embed_inputs:
        h = batch["inputs_embeds"].to(cfg.param_dtype)
    elif tp and "vocab" not in cfg.tp_whole:
        h = S.vocab_parallel_embed(S.gathered(params["embed"]),
                                   batch["tokens"], tp_index)
    else:
        h = S.gathered(params["embed"])[batch["tokens"].long()]
    positions = batch.get("positions")
    new_caches = {} if caches is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, stage in enumerate(cfg.stages):
        name = f"stage{i}"
        h, nc, aux = apply_stage(
            params[name], cfg, stage, h, positions=positions,
            q_offset=q_offset,
            caches=None if caches is None else caches[name], decode=decode,
            chunked=chunked, valid_len=valid_len, train=train, tp=tp)
        aux_total = aux_total + aux
        if new_caches is not None:
            new_caches[name] = nc
    cut, _, _ = _tp_ops(tp)
    return _norm(cfg, params["final_norm"], cut(h)), new_caches, aux_total


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token NLL in f32; labels < 0 are ignored.  The label's
    log-prob is picked with ``gather``: the reference's one-hot
    contraction adds only zeros to it, so the value is the same."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = labels >= 0
    nll = torch.where(valid, lse - ll, 0.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def _lm_loss(params: Params, cfg: TransformerCfg, h: torch.Tensor,
             labels: torch.Tensor, tp_index: Optional[int]) -> torch.Tensor:
    """The cross-entropy of the head over the normed hidden ``h`` (whole
    on every model rank): with ``tp_index`` ``h`` enters the rank's
    vocabulary columns through *f* and the loss is the vocab-parallel
    cross-entropy."""
    if tp_index is None or "vocab" in cfg.tp_whole:
        return cross_entropy(_unembed(params, cfg, h), labels)
    return S.vocab_parallel_cross_entropy(
        _unembed(params, cfg, S.copy_to_model(h)), labels, tp_index)


def loss_fn(params: Params, cfg: TransformerCfg,
            batch: Dict[str, torch.Tensor], tp_index: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Language-model loss plus the MoE layers' aux loss and, with
    ``cfg.mtp`` (and an embedding table to embed the next tokens with),
    the multi-token-prediction term (the reference's
    ``loss_fn``): returns (nll [+ w * mtp] + aux, {"nll", "aux", ["mtp"],
    "loss"}); "aux" is the main stack's, as the reference reports it.
    With ``tp_index`` the params are the rank's shard and the NLL is the
    vocab-parallel cross-entropy (the same value on every model rank, and
    so is the aux loss).  The MTP term reads the normed hidden ahead of
    the head's *f*: its gradient into it is whole on every rank already,
    and through *f* it would be summed over "model" once more."""
    h, _, aux = _final_hidden(params, cfg, batch, train=True,
                              tp_index=tp_index)
    if cfg.mtp:
        h = S.cut(h)          # read by the head and the MTP block
    nll = _lm_loss(params, cfg, h, batch["labels"], tp_index)
    metrics = {"nll": nll, "aux": aux}
    loss = nll
    if cfg.mtp and cfg.embed_inputs:
        mtp = _mtp_loss(params, cfg, batch, h, tp_index)
        aux = aux + mtp[1]
        loss = loss + cfg.mtp_loss_weight * mtp[0]
        metrics["mtp"] = mtp[0]
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


def _mtp_loss(params: Params, cfg: TransformerCfg,
              batch: Dict[str, torch.Tensor], h: torch.Tensor,
              tp_index: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(MTP cross-entropy, the MTP block's aux loss): token t + 2 is
    predicted from the final hidden state at t joined with the embedding
    of token t + 1, through one more layer and the shared unembedding.
    With ``tp_index`` the next tokens' embedding is vocab-parallel, the
    block runs over the rank's shard (``apply_layer(tp=True)``), and its
    output enters the head as the main stack's does; the two norms and
    the projection are whole on every rank."""
    tokens = batch["tokens"]
    embed = S.gathered(params["embed"])
    if tp_index is None or "vocab" in cfg.tp_whole:
        emb_next = embed[tokens.long()][:, 1:]
    else:
        emb_next = S.vocab_parallel_embed(embed, tokens, tp_index)[:, 1:]
    h_in = torch.cat([_norm(cfg, params["mtp_norm1"], h[:, :-1]),
                      _norm(cfg, params["mtp_norm2"], emb_next)], dim=-1)
    h_mtp, _, aux = apply_layer(S.gathered(params["mtp_block"]), cfg,
                                _mtp_spec(cfg),
                                h_in @ S.gathered(params["mtp_proj"]),
                                train=True, tp=tp_index is not None)
    return (_lm_loss(params, cfg, h_mtp, batch["labels"][:, 1:],
                     tp_index), aux)


def init_caches(cfg: TransformerCfg, batch: int, max_len: int, dtype,
                device) -> Params:
    caches: Params = {}
    for i, stage in enumerate(cfg.stages):
        block = {}
        for j, spec in enumerate(stage.layers):
            _check_spec(spec)
            if spec.mixer == "mla":
                block[f"layer{j}"] = MLA.init_mla_cache(
                    batch, max_len, cfg.mla, dtype, device, (stage.repeat,))
            elif spec.mixer == "mamba":
                block[f"layer{j}"] = M.init_mamba_cache(
                    batch, cfg.mamba, dtype, device, (stage.repeat,))
            else:
                block[f"layer{j}"] = L.init_kv_cache(
                    batch, max_len, cfg.attn, dtype, device, (stage.repeat,))
        caches[f"stage{i}"] = block
    return caches
