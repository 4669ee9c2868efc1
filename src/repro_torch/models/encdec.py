"""Encoder-decoder backbone (SeamlessM4T-v2's text/speech translator).

Counterpart of ``repro.models.encdec``.  The modality frontend is a stub
(precomputed frame embeddings, ``repro_torch.models.frontends``); this
module is the transformer backbone: a non-causal encoder over frames and
a causal decoder with cross-attention.  Both stacks keep the reference's
STACKED params (leading axis = layer) and its tree names, so params and
caches compare leaf for leaf across the two packages; a Python loop over
the stack replaces ``lax.scan``.

Attention goes through the flash op outside training (the CUDA kernel
on the card: the encoder non-causal with ``Sq = Skv`` = frames, the
decoder's self-attention causal, its cross-attention non-causal over the
frames) and through the differentiable ``layers.train_attention`` in
``loss_fn`` (``train=True``).  Cross-attention projects the memory's K
and V anew at every call, decode steps included, as the reference does.
The decoder's self-attention KV cache is written in place, as the
decoder LM's is.  With ``remat`` (the reference's field and default) the
training forward checkpoints each encoder and each decoder layer under
policy "nothing", as the reference's ``encode`` / ``decode_train`` do
(``models.remat``), over a "model" axis too; prefill and decode never
do.

Over a "model" axis (``loss_fn(..., tp_index=)``, and serving a rank of
a ``sharding.ServeSplit``: ``prefill`` / ``decode_step(...,
tp_index=)``; ``cfg`` the rank's ``local_config``) every layer runs as
the decoder LM's do (``transformer.apply_layer``): the residual cut ahead of each norm, each
normed input entering the rank's heads or MLP columns through *f*, each
output leaving through *g*; the cross-attention splits by heads over
the whole memory, which enters every decoder layer through one *f*
after ``enc_norm``; the embedding and the loss are vocab-parallel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import remat as R
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as S

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    name: str
    d_model: int
    vocab_size: int
    enc_layers: int
    dec_layers: int
    attn: L.AttentionCfg = None          # self-attention (enc: non-causal)
    cross: L.AttentionCfg = None         # decoder cross-attention
    mlp: L.MLPCfg = None
    norm: str = "layernorm"
    param_dtype: Any = torch.float32
    remat: bool = True
    block_k: int = 512                   # training attention kv block
    #: the port's: the parts a model rank's local config holds whole
    #: (``sharding.TPLayout.whole``: "vocab")
    tp_whole: Tuple[str, ...] = ()

    @property
    def num_layers(self) -> int:
        return self.enc_layers + self.dec_layers


def _init_norm(cfg: EncDecCfg, device, lead: Tuple[int, ...] = ()):
    if cfg.norm == "layernorm":
        return L.init_layernorm(cfg.d_model, cfg.param_dtype, device, lead)
    return L.init_rmsnorm(cfg.d_model, cfg.param_dtype, device, lead)


def _norm(cfg: EncDecCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return L.layernorm(p, x)
    return L.rmsnorm(p, x)


def _enc_attn(cfg: EncDecCfg) -> L.AttentionCfg:
    return dataclasses.replace(cfg.attn, causal=False)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _init_enc_layers(gen, cfg: EncDecCfg, device) -> Params:
    lead, dt = (cfg.enc_layers,), cfg.param_dtype
    return {"norm1": _init_norm(cfg, device, lead),
            "attn": L.init_attention(gen, _enc_attn(cfg), dt, device, lead),
            "norm2": _init_norm(cfg, device, lead),
            "mlp": L.init_mlp(gen, cfg.mlp, dt, device, lead)}


def _apply_enc_layer(params: Params, cfg: EncDecCfg, x: torch.Tensor, *,
                     train: bool = False, tp: bool = False) -> torch.Tensor:
    cut, f, g = T._tp_ops(tp)
    x = cut(x)
    h = f(_norm(cfg, params["norm1"], x))
    out, _ = L.attention_forward(params["attn"], _enc_attn(cfg), h,
                                 train=train, block_k=cfg.block_k)
    x = cut(x + g(out))
    h = f(_norm(cfg, params["norm2"], x))
    return x + g(L.mlp_forward(params["mlp"], cfg.mlp, h))


def _init_dec_layers(gen, cfg: EncDecCfg, device) -> Params:
    lead, dt = (cfg.dec_layers,), cfg.param_dtype
    return {"norm1": _init_norm(cfg, device, lead),
            "self_attn": L.init_attention(gen, cfg.attn, dt, device, lead),
            "norm_x": _init_norm(cfg, device, lead),
            "cross": L.init_cross_attention(gen, cfg.cross, dt, device,
                                            lead),
            "norm2": _init_norm(cfg, device, lead),
            "mlp": L.init_mlp(gen, cfg.mlp, dt, device, lead)}


def _apply_dec_layer(params: Params, cfg: EncDecCfg, x: torch.Tensor,
                     memory: torch.Tensor, *, q_offset: int = 0,
                     cache: Optional[Params] = None, decode: bool = False,
                     train: bool = False, tp: bool = False,
                     memory_axes: Tuple[str, ...] = ()
                     ) -> Tuple[torch.Tensor, Optional[Params]]:
    """``memory_axes``: the axes the rank's ``memory`` block splits its
    frames over (serving from a split cache; ``()``: whole)."""
    cut, f, g = T._tp_ops(tp)
    x = cut(x)
    h = f(_norm(cfg, params["norm1"], x))
    if decode:
        out, new_cache = L.attention_decode(params["self_attn"], cfg.attn, h,
                                            cache)
    else:
        out, new_cache = L.attention_forward(
            params["self_attn"], cfg.attn, h, q_offset=q_offset,
            kv_cache=cache, train=train, block_k=cfg.block_k)
    x = cut(x + g(out))
    h = f(_norm(cfg, params["norm_x"], x))
    x = cut(x + g(L.cross_attention_forward(
        params["cross"], cfg.cross, h, memory, train=train,
        block_k=cfg.block_k, memory_axes=memory_axes)))
    h = f(_norm(cfg, params["norm2"], x))
    return x + g(L.mlp_forward(params["mlp"], cfg.mlp, h)), new_cache


def _layer(stack: Params, i: int) -> Params:
    return S.gathered(stack, i)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def init_params(gen: Optional[torch.Generator], cfg: EncDecCfg,
                device) -> Params:
    """Random params on ``device`` from ``gen`` (``None``: uninitialised,
    for shape probes on the ``meta`` device)."""
    dt = cfg.param_dtype
    return {
        "embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                              device),
        "encoder": _init_enc_layers(gen, cfg, device),
        "decoder": _init_dec_layers(gen, cfg, device),
        "enc_norm": _init_norm(cfg, device),
        "dec_norm": _init_norm(cfg, device),
        "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                device),
    }


def local_config(cfg: EncDecCfg, lay) -> EncDecCfg:
    """The config one model rank computes (``parallel.sharding``'s
    ``TPLayout``): its self- and cross-attention heads, its MLP columns
    and its vocabulary block."""
    c = cfg.cross
    return dataclasses.replace(
        cfg, vocab_size=lay.vocab, tp_whole=lay.whole,
        attn=L.local_attention(cfg.attn, lay.heads, lay.kv_heads),
        cross=L.local_attention(
            c, c.num_heads // lay.model,
            c.num_kv_heads if lay.kv_replicated
            else c.num_kv_heads // lay.model),
        mlp=dataclasses.replace(cfg.mlp, d_ff=lay.d_ff))


def encode(params: Params, cfg: EncDecCfg, frame_embeds: torch.Tensor, *,
           train: bool = False, tp: bool = False) -> torch.Tensor:
    """frame_embeds: (B, S_enc, D) from the stub frontend -> the memory
    (B, S_enc, D) in the param dtype.  ``tp``: the params are a model
    rank's shard (``cfg`` its local config); the frames enter whole, and
    the memory leaves through one *f*, whose staged backward sums every
    decoder layer's and every rank's share of its gradient before the
    encoder's segments run.  With remat each layer is checkpointed
    (``models.remat``: on the staged backward's tape over "model")."""
    x = frame_embeds.to(cfg.param_dtype)
    remat = R.active(cfg.remat, train)
    staged = tp or S.on_tape()
    for i in range(cfg.enc_layers):
        if remat and staged:
            x = R.staged(functools.partial(_enc_block, params, cfg, i,
                                           tp=tp), x)[0]
            continue
        args = (_layer(params["encoder"], i), cfg, x)
        x = (R.checkpointed(_apply_enc_layer, *args, train=True) if remat
             else _apply_enc_layer(*args, train=train, tp=tp))
    cut, f, _ = T._tp_ops(tp)
    memory = f(_norm(cfg, params["enc_norm"], cut(x)))
    # every decoder block's rerun reads the memory: on a tape without
    # *f* it is cut all the same, so that its graph runs once
    return memory if tp else S.cut(memory)


def _enc_block(params: Params, cfg: EncDecCfg, i: int, x: torch.Tensor,
               tp: bool = True):
    """Encoder layer ``i`` as a block of the staged tape (over "model",
    or over a data split only: ``tp=False``)."""
    return _apply_enc_layer(_layer(params["encoder"], i), cfg, x,
                            train=True, tp=tp), ()


def _dec_block(params: Params, cfg: EncDecCfg, i: int, memory: torch.Tensor,
               x: torch.Tensor, tp: bool = True):
    """Decoder layer ``i`` as a block of the staged tape (the memory, a
    leaf of the tape, gathers its gradient in the rerun)."""
    return _apply_dec_layer(_layer(params["decoder"], i), cfg, x, memory,
                            train=True, tp=tp)[0], ()


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return S.gathered(params["embed"])[tokens.long()]


def decode_train(params: Params, cfg: EncDecCfg, tokens: torch.Tensor,
                 memory: torch.Tensor, *, train: bool = False,
                 tp_index: Optional[int] = None) -> torch.Tensor:
    """Teacher-forced decoder pass -> logits (B, S_dec, V); with
    ``tp_index`` (the rank's model coordinate, ``memory`` from
    ``encode(tp=True)``) the rank's vocabulary columns of them, from the
    vocab-parallel embedding and the rank's heads and MLP columns."""
    tp = tp_index is not None
    vocab_tp = tp and "vocab" not in cfg.tp_whole
    x = (S.vocab_parallel_embed(S.gathered(params["embed"]), tokens,
                                tp_index)
         if vocab_tp else _embed(params, tokens))
    remat = R.active(cfg.remat, train)
    staged = tp or S.on_tape()
    for i in range(cfg.dec_layers):
        if remat and staged:
            x = R.staged(functools.partial(_dec_block, params, cfg, i,
                                           memory, tp=tp), x)[0]
            continue
        args = (_layer(params["decoder"], i), cfg, x, memory)
        x, _ = (R.checkpointed(_apply_dec_layer, *args, train=True) if remat
                else _apply_dec_layer(*args, train=train, tp=tp))
    cut, f, _ = T._tp_ops(tp)
    h = _norm(cfg, params["dec_norm"], cut(x))
    return (f(h) if vocab_tp else h) @ S.gathered(params["lm_head"])


def loss_fn(params: Params, cfg: EncDecCfg, batch: Dict[str, torch.Tensor],
            tp_index: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token NLL of ``labels`` given ``frame_embeds`` and the teacher-forced
    ``tokens``: (loss, {"nll", "loss"}), differentiable in ``params``.
    With ``tp_index`` the params are the rank's shard and the NLL is the
    vocab-parallel cross-entropy (the same value on every model rank)."""
    tp = tp_index is not None
    memory = encode(params, cfg, batch["frame_embeds"], train=True, tp=tp)
    logits = decode_train(params, cfg, batch["tokens"], memory, train=True,
                          tp_index=tp_index)
    loss = (S.vocab_parallel_cross_entropy(logits, batch["labels"], tp_index)
            if tp and "vocab" not in cfg.tp_whole
            else T.cross_entropy(logits, batch["labels"]))
    return loss, {"nll": loss, "loss": loss}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with self-attn KV cache (+ stored memory)
# ---------------------------------------------------------------------------


def init_caches(cfg: EncDecCfg, batch: int, max_len: int, enc_len: int,
                dtype, device) -> Params:
    """{"self": the decoder's stacked KV caches, "memory": (B, enc_len,
    D)}, both in ``dtype``."""
    return {"self": L.init_kv_cache(batch, max_len, cfg.attn, dtype, device,
                                    (cfg.dec_layers,)),
            "memory": torch.zeros((batch, enc_len, cfg.d_model), dtype=dtype,
                                  device=device)}


def _decoder_pass(params: Params, cfg: EncDecCfg, x: torch.Tensor,
                  memory: torch.Tensor, caches: Params, *,
                  q_offset: int = 0, decode: bool,
                  tp_index: Optional[int] = None,
                  memory_axes: Tuple[str, ...] = ()
                  ) -> Tuple[torch.Tensor, Params]:
    """Logits (B, S, V) and the stacked self-attention caches (K/V rows
    written in place, ``len`` anew).  ``tp_index``: the params are a
    model rank's shard, the logits its vocabulary columns."""
    tp = tp_index is not None
    lens = []
    for i in range(cfg.dec_layers):
        x, nc = _apply_dec_layer(_layer(params["decoder"], i), cfg, x,
                                 memory, q_offset=q_offset,
                                 cache=_layer(caches, i), decode=decode,
                                 tp=tp, memory_axes=memory_axes)
        lens.append(nc["len"])
    x = _norm(cfg, params["dec_norm"], x)
    if tp and "vocab" not in cfg.tp_whole:
        x = S.copy_to_model(x)
    return (x @ S.gathered(params["lm_head"]),
            {**caches, "len": torch.stack(lens)})


def _serve_embed(params: Params, cfg: EncDecCfg, tokens: torch.Tensor,
                 tp_index: Optional[int]) -> torch.Tensor:
    if tp_index is not None and "vocab" not in cfg.tp_whole:
        return S.vocab_parallel_embed(S.gathered(params["embed"]), tokens,
                                      tp_index)
    return _embed(params, tokens)


def prefill(params: Params, cfg: EncDecCfg, batch: Dict[str, torch.Tensor],
            caches: Params, tp_index: Optional[int] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Encode ``frame_embeds``, store the memory in the cache's dtype, and
    run the decoder over the prompt ``tokens``; returns (last-position
    logits (B, V), caches).  With ``tp_index`` (serving a rank of a
    ``sharding.ServeSplit``) the rank's heads run over the whole memory
    of its rows, and the cache keeps its block of the memory's frames."""
    memory = encode(params, cfg, batch["frame_embeds"],
                    tp=tp_index is not None)
    memory = memory.to(caches["memory"].dtype)
    logits, new_self = _decoder_pass(
        params, cfg, _serve_embed(params, cfg, batch["tokens"], tp_index),
        memory, caches["self"], decode=False, tp_index=tp_index)
    sp = S.serve_split()
    if sp is not None:
        if memory.shape[1] != sp.enc_len:
            raise ValueError(f"{memory.shape[1]} frames for a split cache "
                             f"of {sp.enc_len}")
        w = caches["memory"].shape[1]
        i = sp.index("memory", -2)[1]
        memory = memory[:, i * w:(i + 1) * w]
    return logits[:, -1], {"self": new_self, "memory": memory}


def decode_step(params: Params, cfg: EncDecCfg, tokens: torch.Tensor,
                caches: Params, tp_index: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
    """tokens: (B, 1) -> (logits (B, V), caches); the stored memory is
    cast back to the param dtype for cross-attention.  Serving a rank of
    a ``sharding.ServeSplit``, the cross-attention attends over the
    rank's block of the memory's frames and combines the blocks."""
    sp = S.serve_split()
    axes = () if sp is None else sp.axes("memory", -2)
    logits, new_self = _decoder_pass(
        params, cfg, _serve_embed(params, cfg, tokens, tp_index),
        caches["memory"].to(cfg.param_dtype), caches["self"], decode=True,
        tp_index=tp_index, memory_axes=axes)
    return logits[:, 0], {"self": new_self, "memory": caches["memory"]}
