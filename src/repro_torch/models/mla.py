"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437) of the port.

Counterpart of ``repro.models.mla``.  Q is low-rank (d -> q_lora ->
heads); K/V are compressed to a per-token latent ``c_kv`` (kv_lora) plus
one shared RoPE key (dh_rope), so the cache holds kv_lora + dh_rope
values a token (``ckv``, ``krope``) whatever the head count.

Two forms of the same attention, as in the reference:

- *materialized* (``mla_forward`` for training and the one-shot
  prefill): per-head K/V are expanded from the latent and attention runs
  with dh_qk = dh_nope + dh_rope (192) scores against dh_v (128) values:
  through the flash op (``layers.flash_attention``, the CUDA kernel at
  (192, 128) on the card) when prefilling, through the differentiable
  ``layers.train_attention`` when training;
- *absorbed* (``mla_decode``, and ``mla_forward(chunked=True)`` for a
  paged prefill chunk): the K up-projection is folded into the query and
  the V up-projection applied after attending over latents, in f32 and
  plain PyTorch, as the reference computes it in jnp outside any kernel.

Caches are written IN PLACE, as ``layers``' K/V caches are: a prefill or
decode step writes its rows into the ``ckv``/``krope`` tensors it is
handed and returns them with a new ``len``.

Over a "model" axis ``cfg.num_heads`` is the rank's share
(``transformer.local_config``) and ``params`` hold its columns of
``w_uq`` / ``w_ukv`` and rows of ``w_o``: ``mla_forward`` runs the
rank's heads over the latent ``ckv`` and ``k_rope``, which every rank
computes whole from the low-rank leaves it holds whole
(``parallel.sharding``).  Serving so (``sharding.ServeSplit``), a rank
holds a block of the latent cache's positions: prefill writes the
block, and ``mla_decode`` gathers every head's absorbed query over
"model", attends over the block and combines the partial softmaxes
(``_split_absorbed_attention``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.parallel import sharding as S

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MLACfg:
    d_model: int
    num_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    dh_nope: int = 128
    dh_rope: int = 64
    dh_v: int = 128
    rope_theta: float = 1e4

    @property
    def dh_qk(self) -> int:
        return self.dh_nope + self.dh_rope


def init_mla(gen, cfg: MLACfg, dtype, device, lead: Tuple[int, ...] = ()
             ) -> Params:
    D, H = cfg.d_model, cfg.num_heads
    p: Params = {
        "w_dq": L.dense_init(gen, lead + (D, cfg.q_lora), dtype, device),
        "w_uq": L.dense_init(gen, lead + (cfg.q_lora, H * cfg.dh_qk), dtype,
                             device),
        "w_dkv": L.dense_init(gen, lead + (D, cfg.kv_lora), dtype, device),
        "w_kr": L.dense_init(gen, lead + (D, cfg.dh_rope), dtype, device),
        "w_ukv": L.dense_init(
            gen, lead + (cfg.kv_lora, H * (cfg.dh_nope + cfg.dh_v)), dtype,
            device),
        "w_o": L.dense_init(gen, lead + (H * cfg.dh_v, D), dtype, device),
    }
    p["q_norm"] = L.init_rmsnorm(cfg.q_lora, dtype, device, lead)
    p["kv_norm"] = L.init_rmsnorm(cfg.kv_lora, dtype, device, lead)
    return p


def _project_q(params: Params, cfg: MLACfg, x: torch.Tensor, cos, sin):
    b, s, _ = x.shape
    cq = L.rmsnorm(params["q_norm"], x @ params["w_dq"])
    q = (cq @ params["w_uq"]).reshape(b, s, cfg.num_heads, cfg.dh_qk)
    q_nope = q[..., :cfg.dh_nope]
    q_rope = L.apply_rope(q[..., cfg.dh_nope:], cos, sin)
    return q_nope, q_rope


def _latent_kv(params: Params, cfg: MLACfg, x: torch.Tensor, cos, sin):
    """Per-token compressed latent (B, S, kv_lora) and shared rotated key
    (B, S, dh_rope)."""
    ckv = L.rmsnorm(params["kv_norm"], x @ params["w_dkv"])
    krope = L.apply_rope((x @ params["w_kr"])[:, :, None, :], cos, sin)
    return ckv, krope[:, :, 0, :]


def _w_ukv(params: Params, cfg: MLACfg):
    """(W_uk (kv_lora, H, dh_nope), W_uv (kv_lora, H, dh_v)) in f32."""
    w_ukv = params["w_ukv"].reshape(cfg.kv_lora, cfg.num_heads,
                                    cfg.dh_nope + cfg.dh_v).float()
    return w_ukv[..., :cfg.dh_nope], w_ukv[..., cfg.dh_nope:]


def _absorbed_attention(params: Params, cfg: MLACfg, q_nope, q_rope,
                        ckv_c: torch.Tensor, kr_c: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Absorbed attention of Sq queries over the whole latent cache, in
    f32: scores q_nope·W_uk·c_kv + q_rope·k_rope, values W_uv·c_kv.
    ``mask`` (B, Sq, Smax) says which cache positions each query sees.
    Returns (B, Sq, H * dh_v) f32."""
    b, sq = q_nope.shape[:2]
    w_uk, w_uv = _w_ukv(params, cfg)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope.float(), w_uk)
    ckv = ckv_c.float()
    s_nope = torch.einsum("bqhl,bkl->bhqk", q_lat, ckv)
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr_c.float())
    s = (s_nope + s_rope) * (1.0 / math.sqrt(cfg.dh_qk))   # (B,H,Sq,Smax)
    s = s.masked_fill(~mask[:, None], -math.inf)
    p = torch.softmax(s, dim=-1)
    out_lat = torch.einsum("bhqk,bkl->bqhl", p, ckv)
    out = torch.einsum("bqhl,lhd->bqhd", out_lat, w_uv)
    return out.reshape(b, sq, cfg.num_heads * cfg.dh_v)


def _split_absorbed_attention(params: Params, cfg: MLACfg, q_nope, q_rope,
                              ckv_c: torch.Tensor, kr_c: torch.Tensor,
                              valid: torch.Tensor,
                              axes: Tuple[str, ...]) -> torch.Tensor:
    """``_absorbed_attention`` of the rank's heads over its block of a
    latent cache split by sequence over ``axes``: the absorbed queries
    and the rotary ones are one query of kv_lora + dh_rope values a head
    against the latent and the rotary key (one K/V head), the values the
    latents; ``layers.split_attention`` gathers every head over "model",
    attends over the block and combines.  ``valid`` (B, S_block).
    Returns (B, Sq, H * dh_v) f32."""
    b, sq = q_nope.shape[:2]
    w_uk, w_uv = _w_ukv(params, cfg)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope.float(), w_uk)
    q = torch.cat([q_lat, q_rope.float()], dim=-1)
    k = torch.cat([ckv_c.float(), kr_c.float()], dim=-1)[:, :, None]
    # a model split always splits MLA's heads over every model rank
    shards = S.serve_split().mesh_sizes.get(S.MODEL_AXIS, 1)
    out_lat = L.split_attention(q, k, ckv_c.float()[:, :, None], axes,
                                shards, valid,
                                sm_scale=1.0 / math.sqrt(cfg.dh_qk))
    out = torch.einsum("bqhl,lhd->bqhd", out_lat, w_uv)
    return out.reshape(b, sq, cfg.num_heads * cfg.dh_v)


def mla_forward(params: Params, cfg: MLACfg, x: torch.Tensor, *,
                q_offset: int = 0,
                kv_cache: Optional[Dict[str, torch.Tensor]] = None,
                chunked: bool = False, valid_len: Optional[int] = None,
                train: bool = False, block_k: int = 512
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Training / prefill path; returns (out, new_cache).

    Materialized form: per-head K/V from the latent, attention through
    the flash op (``train=True``: ``train_attention``, differentiable,
    ``block_k`` keys a block).  ``chunked=True`` (paged prefill): the
    chunk's latents are written into ``kv_cache`` in place and the chunk
    attends the whole latent cache in the absorbed form under the
    absolute causal mask, so pad positions and unwritten pages never
    enter; ``valid_len`` clamps the length counter for a chunk
    right-padded to the page boundary."""
    b, s, _ = x.shape
    H = cfg.num_heads
    positions = L.text_positions(b, s, q_offset, x.device)
    cos, sin = L.rope_cos_sin(positions, cfg.dh_rope, cfg.rope_theta)
    q_nope, q_rope = _project_q(params, cfg, x, cos, sin)
    ckv, krope = _latent_kv(params, cfg, x, cos, sin)

    new_cache = None
    if kv_cache is not None:
        cc, kc = kv_cache["ckv"], kv_cache["krope"]
        start = L.seq_block_start("ckv", cc, q_offset + s, chunked)
        L.put_positions(cc, ckv, q_offset - start)
        L.put_positions(kc, krope, q_offset - start)
        new_len = kv_cache["len"] + s
        if valid_len is not None:
            new_len = torch.clamp(new_len, max=valid_len)
        new_cache = {"ckv": cc, "krope": kc, "len": new_len}

    if chunked:
        if new_cache is None:
            raise ValueError("chunked MLA prefill needs a cache")
        smax = new_cache["ckv"].shape[1]
        mask = (torch.arange(smax, device=x.device)[None, None, :]
                <= positions[:, :, None])
        out = _absorbed_attention(params, cfg, q_nope, q_rope,
                                  new_cache["ckv"], new_cache["krope"], mask)
        return out.to(x.dtype) @ params["w_o"], new_cache

    kv = (ckv @ params["w_ukv"]).reshape(b, s, H, cfg.dh_nope + cfg.dh_v)
    k_nope, v = kv[..., :cfg.dh_nope], kv[..., cfg.dh_nope:]
    k = torch.cat([k_nope, krope[:, :, None, :].expand(b, s, H,
                                                         cfg.dh_rope)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = 1.0 / math.sqrt(cfg.dh_qk)
    if train:
        out = L.train_attention(q, k, v, causal=True, q_offset=q_offset,
                                block_k=block_k, sm_scale=scale)
    else:
        out = L.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                                sm_scale=scale)
    return out.reshape(b, s, H * cfg.dh_v) @ params["w_o"], new_cache


def mla_decode(params: Params, cfg: MLACfg, x: torch.Tensor,
               kv_cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed one-token decode with in-place cache update.  x: (B, 1,
    D); each sequence writes at its own length (ragged batch)."""
    b = x.shape[0]
    idx = kv_cache["len"]                                 # (B,)
    cos, sin = L.rope_cos_sin(idx[:, None], cfg.dh_rope, cfg.rope_theta)
    q_nope, q_rope = _project_q(params, cfg, x, cos, sin)
    ckv_new, krope_new = _latent_kv(params, cfg, x, cos, sin)
    sp = S.serve_split()
    axes, start = (), 0
    if sp is not None:        # the rank's block of a split latent cache
        axes, blk = sp.index("ckv", -2)
        start = blk * kv_cache["ckv"].shape[1]
    cc = L._scatter_token(kv_cache["ckv"], ckv_new, idx - start)
    kc = L._scatter_token(kv_cache["krope"], krope_new, idx - start)
    new_len = idx + 1
    smax = cc.shape[1]
    mask = (torch.arange(smax, device=x.device)[None, :]
            < (new_len - start)[:, None])                 # (B, S_block)
    if axes:
        out = _split_absorbed_attention(params, cfg, q_nope, q_rope, cc,
                                        kc, mask, axes)
    else:
        out = _absorbed_attention(params, cfg, q_nope, q_rope, cc, kc,
                                  mask[:, None, :])
    return (out.reshape(b, 1, cfg.num_heads * cfg.dh_v).to(x.dtype)
            @ params["w_o"], {"ckv": cc, "krope": kc, "len": new_len})


def init_mla_cache(batch: int, max_len: int, cfg: MLACfg, dtype, device,
                   lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    return {"ckv": torch.zeros(lead + (batch, max_len, cfg.kv_lora),
                               dtype=dtype, device=device),
            "krope": torch.zeros(lead + (batch, max_len, cfg.dh_rope),
                                 dtype=dtype, device=device),
            "len": torch.zeros(lead + (batch,), dtype=torch.int32,
                               device=device)}
