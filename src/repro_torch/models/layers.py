"""Dense layers of the port: RMSNorm, LayerNorm, RoPE and Qwen2-VL's
M-RoPE, GQA/MQA attention (with qwen3's optional per-head q/k norm),
the encoder-decoder's cross-attention, SwiGLU, squared-ReLU and
tanh-GELU MLPs.

Counterpart of ``repro.models.layers``.

Conventions
-----------
- Params are nested dicts of tensors with the reference's layout:
  weights are ``(in, out)`` and ``x @ w`` applies them.  ``init_*`` take
  a ``torch.Generator`` (``None`` gives uninitialised tensors, for the
  ``meta`` device) and the same distributions as the reference
  (``repro/models/layers.py:37-44``); the numbers differ, since JAX's
  threefry is not reproduced.
- Prefill attention (chunked and one-shot) goes through the flash op
  ``repro_torch.kernels.flash_attention``: the hand-written CUDA kernel
  on the card, its plain version on the CPU.  Decode attention is a
  plain matvec in PyTorch, as the reference computes it outside any
  kernel.
- Training attention (``train_attention``) is the reference's
  ``flash_attention_jnp`` with its custom VJP (``_flash_vjp``): a
  blockwise online-softmax forward that keeps only ``out`` and the
  log-sum-exp, and a backward that recomputes the scores block by block.
  The reference computes it in jnp, outside any Pallas kernel; here it is
  a ``torch.autograd.Function`` in plain PyTorch.
- KV caches are written IN PLACE (the reference returns updated copies):
  a prefill or decode step mutates the ``k``/``v`` tensors it is handed
  and returns them with a new ``len``.  This keeps one arena, not two, on
  the card.
- Serving a rank of a ``sharding.ServeSplit``, a cache may be the rank's
  block of the positions: prefill writes the positions that fall in it
  (``put_positions``), decode writes its token where the block holds it
  and attends over the block, the ranks' partial softmaxes combined
  (``partial_attention``, ``split_attention``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import trace
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.parallel import sharding as S

Params = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _normal(gen: Optional[torch.Generator], shape, std: float, dtype,
            device) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def dense_init(gen, shape, dtype, device, fan_in: Optional[int] = None):
    """``shape`` may carry leading stack axes; ``fan_in`` defaults to the
    second-to-last axis (the ``in`` of ``(in, out)``)."""
    fan_in = fan_in if fan_in is not None else shape[-2]
    return _normal(gen, shape, 1.0 / math.sqrt(fan_in), dtype, device)


def embed_init(gen, shape, dtype, device):
    return _normal(gen, shape, 0.02, dtype, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, dtype, device, lead: Tuple[int, ...] = ()):
    return {"scale": torch.ones(lead + (dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6,
            shards: int = 1) -> torch.Tensor:
    """With ``shards`` > 1, ``x`` is this model rank's 1/``shards`` of the
    normed dim (a Mamba mixer's gated norm over a rank's heads): the mean
    square's sum is summed over "model" as *f* of *g*, so that its
    backward too sums every rank's share of its gradient (*g*'s identity
    alone would hand each rank its own share only)."""
    xf = x.float()
    if shards == 1:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        var = S.copy_to_model(S.reduce_from_model(torch.sum(
            xf * xf, dim=-1, keepdim=True))) / (xf.shape[-1] * shards)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(dim: int, dtype, device, lead: Tuple[int, ...] = ()):
    return {"scale": torch.ones(lead + (dim,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (dim,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """Scale and bias, statistics in f32 (the biased variance, as
    ``jnp.var``)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float()
            + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float = 1e4
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin (..., S, dim/2) f32."""
    ang = positions[..., None].float() * rope_freqs(dim, theta,
                                                    positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) — rotate-half convention."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def mrope_cos_sin(positions_3d: torch.Tensor, dim: int,
                  sections: Tuple[int, ...], theta: float = 1e6
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE.  positions_3d: (3, B, S) for (t, h, w);
    ``sections`` partitions dim/2 into per-component frequency bands
    (e.g. (16, 24, 24) for D=128).  Returns cos/sin (B, S, dim/2)."""
    if sum(sections) != dim // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to "
                         f"dim / 2 = {dim // 2}")
    freqs = rope_freqs(dim, theta, positions_3d.device)
    ang_all = positions_3d[..., None].float() * freqs    # (3, B, S, dim/2)
    parts, lo = [], 0
    for comp, sec in enumerate(sections):
        parts.append(ang_all[comp, :, :, lo:lo + sec])
        lo += sec
    ang = torch.cat(parts, dim=-1)                       # (B, S, dim/2)
    return torch.cos(ang), torch.sin(ang)


def text_positions(batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device) + offset
    return pos.expand(batch, seq)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    sm_scale: float | None = None) -> torch.Tensor:
    """One-shot prefill attention (the reference's ``flash_attention_jnp``).

    q: (B, Sq, H, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv) (MLA's Dv
    differs from D); query 0 at ``q_offset``."""
    return flash_ops.attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               q_offset=q_offset)


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, q_offset: int,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Chunked-prefill attention: a chunk of queries against the FULL
    cache (prior chunks + this one already written), causal by absolute
    position, so positions above a query (pad tail, unwritten pages)
    never enter the softmax.

    q: (B, Sq, H, D) at absolute positions ``q_offset + i``; caches:
    (B, Smax, Hkv, D).  ``q_offset`` is a runtime int: one compiled kernel
    serves every chunk index.  The reference takes a (B, Sq) position
    array; its serving path always passes ``arange(Sq) + q_offset``."""
    return flash_ops.attention(q, k_cache, v_cache, causal=True,
                               sm_scale=sm_scale, q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor,
                     sm_scale: float | None = None) -> torch.Tensor:
    """Single-token attention against a ragged cache, in float32.

    q: (B, 1, H, D); caches: (B, Smax, Hkv, D); kv_len: (B,)."""
    b, _, h, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, group, d).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    mask = (torch.arange(smax, device=q.device)[None, :]
            < kv_len[:, None])                              # (B, Smax)
    s = s.masked_fill(~mask[:, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: Optional[torch.Tensor] = None,
                      sm_scale: float | None = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention of ``q`` (B, Sq, H, D) over one block of the keys, ``k``
    (B, Sk, Hkv, D) and ``v`` (B, Sk, Hkv, Dv), left unnormalized, in
    float32: (o (B, Sq, H, Dv), the row max m (B, Sq, H), the row sum l
    of exp(s - m)), ``sharding.combine_partials``' operands.  ``valid``
    (B, Sk) says which keys each row sees (None: all); a row that sees
    none gives m = -inf, l = 0 and o = 0."""
    b, sq, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    group = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, group, d).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if valid is not None:
        s = s.masked_fill(~valid[:, None, None, None, :], -math.inf)
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return (o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv),
            m.permute(0, 3, 1, 2).reshape(b, sq, h),
            l.permute(0, 3, 1, 2).reshape(b, sq, h))


def split_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    axes: Tuple[str, ...], head_shards: int,
                    valid: Optional[torch.Tensor] = None,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Attention of a rank's query heads ``q`` (B, Sq, H, D) over keys
    split over ``axes``, of which ``k`` / ``v`` are the rank's block (a
    serving cache split by its sequence, or a memory by its frames).
    Where the keys split over "model" and the query heads do too
    (``head_shards`` > 1), the block holds every K/V head: the rank
    gathers every query head over "model" (a few KB a row), attends
    them all over its block and keeps its own heads' share of the
    combined output.  -> (B, Sq, H, Dv) float32."""
    gather = "model" in axes and head_shards > 1
    if gather:
        q = S.gather_axes(q, (S.MODEL_AXIS,), dim=2)
    out = S.combine_partials(*partial_attention(q, k, v, valid, sm_scale),
                             axes)
    if gather:
        h = q.shape[2] // head_shards
        out = out[:, :, S.model_index() * h:(S.model_index() + 1) * h]
    return out


#: the ``trace.region`` of the training attention's blockwise loops: the
#: score and probability tiles that a fused kernel keeps on chip
ATTN_TILES = "attn_tiles"


def _kv_blocks(k, v, block_k: int):
    """K/V zero-padded to a multiple of ``block_k`` keys."""
    pad = (-k.shape[1]) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v


def _block_mask(j: int, block_k: int, skv: int, sq: int, q_offset: int,
                causal: bool, device) -> torch.Tensor:
    """(1 or Sq, block_k) visibility of keys j*block_k.. to queries."""
    kpos = j * block_k + torch.arange(block_k, device=device)
    mask = (kpos < skv)[None, :]
    if causal:
        q_pos = torch.arange(sq, device=device) + q_offset
        mask = mask & (q_pos[:, None] >= kpos[None, :])
    return mask[None, :, None, None, :]          # (1, Sq|1, 1, 1, Bk)


def _flash_blocks(q, k, v, skv, causal, q_offset, block_k, scale):
    """Blockwise forward: (out f32 (B,Sq,Hkv,G,Dv), lse f32
    (B,Sq,Hkv,G,1)).  Contractions take the inputs in their dtype and
    accumulate in f32; P is cast to V's dtype before P·V, as the
    reference does."""
    b, sq, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, d).float()
    m = torch.full((b, sq, hkv, group, 1), -math.inf, device=q.device)
    l = torch.zeros((b, sq, hkv, group, 1), device=q.device)
    acc = torch.zeros((b, sq, hkv, group, dv), device=q.device)
    for j in range(k.shape[1] // block_k):
        kblk = k[:, j * block_k:(j + 1) * block_k].float()
        vblk = v[:, j * block_k:(j + 1) * block_k]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kblk) * scale
        mask = _block_mask(j, block_k, skv, sq, q_offset, causal, q.device)
        s = torch.where(mask, s, -math.inf)
        m_cur = s.amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m, m_cur)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / l_safe
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    return out, m_safe + torch.log(l_safe)


class _TrainAttention(torch.autograd.Function):
    """Blockwise attention whose backward recomputes the scores from
    (q, k, v, out, lse) — the FlashAttention-2 backward of the
    reference's ``_flash_vjp`` — so no (Sq, Skv) matrix is kept."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, block_k, scale):
        skv = k.shape[1]
        kp, vp = _kv_blocks(k, v, block_k)
        with trace.region(ATTN_TILES):
            out, lse = _flash_blocks(q, kp, vp, skv, causal, q_offset,
                                     block_k, scale)
        b, sq, hkv, group, dv = out.shape
        o = out.reshape(b, sq, hkv * group, dv).to(q.dtype)
        ctx.save_for_backward(q, kp, vp, o, lse)
        ctx.meta = (skv, causal, q_offset, block_k, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        skv, causal, q_offset, block_k, scale = ctx.meta
        b, sq, h, d = q.shape
        hkv, dv = k.shape[2], v.shape[-1]
        group = h // hkv
        qg = q.reshape(b, sq, hkv, group, d)
        og = o.reshape(b, sq, hkv, group, dv).float()
        dog = do.reshape(b, sq, hkv, group, dv).float()
        delta = (og * dog).sum(dim=-1, keepdim=True)   # FA-2 eq. 19
        qf = qg.float()
        dq = torch.zeros((b, sq, hkv, group, d), device=q.device)
        dks, dvs = [], []
        with trace.region(ATTN_TILES):
            for j in range(k.shape[1] // block_k):
                kblk = k[:, j * block_k:(j + 1) * block_k]
                vblk = v[:, j * block_k:(j + 1) * block_k].float()
                s = torch.einsum("bqhgd,bkhd->bqhgk", qf,
                                 kblk.float()) * scale
                mask = _block_mask(j, block_k, skv, sq, q_offset, causal,
                                   q.device)
                p = torch.where(mask, torch.exp(s - lse), 0.0)  # recompute
                dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, vblk)
                ds = p * (dp - delta) * scale
                dvs.append(torch.einsum("bqhgk,bqhgd->bkhd", p, dog))
                dks.append(torch.einsum("bqhgk,bqhgd->bkhd",
                                        ds.to(qg.dtype).float(), qf))
                dq = dq + torch.einsum("bqhgk,bkhd->bqhgd",
                                       ds.to(kblk.dtype).float(),
                                       kblk.float())
        dk = torch.cat(dks, dim=1)[:, :skv]
        dv_ = torch.cat(dvs, dim=1)[:, :skv]
        return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
                dv_.to(v.dtype), None, None, None, None)


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    block_k: int = 512,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Differentiable attention for the training forward (the
    reference's ``flash_attention_jnp``).  q: (B, Sq, H, D); k: (B, Skv,
    Hkv, D); v: (B, Skv, Hkv, Dv) -> (B, Sq, H, Dv) in q's dtype."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    return _TrainAttention.apply(q, k, v, causal, int(q_offset),
                                 int(block_k), float(scale))


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionCfg:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False          # qwen3-style per-head RMS q/k norm
    rope_theta: float = 1e4
    causal: bool = True
    mrope_sections: Optional[Tuple[int, ...]] = None   # Qwen2-VL M-RoPE
    #: the port's: in a model rank's local config whose K/V heads every
    #: rank holds whole (``num_kv_heads`` does not split over "model",
    #: and is above 1), the model's query heads a KV head serves; the
    #: rank's ``num_heads`` query heads, from ``model_index() *
    #: num_heads`` on, each read theirs (``_rank_kv``).  0 otherwise.
    kv_group: int = 0
    #: the port's: the model ranks a local config's query heads and its
    #: K/V heads split over (1: whole on every rank)
    head_shards: int = 1
    kv_shards: int = 1


def local_attention(cfg: AttentionCfg, heads: int, kv_heads: int
                    ) -> AttentionCfg:
    """A model rank's attention config: its ``heads`` query heads and
    ``kv_heads`` KV heads (all of them when they do not split, with
    ``kv_group`` set where there are several)."""
    replicated = kv_heads == cfg.num_kv_heads and heads < cfg.num_heads
    return dataclasses.replace(
        cfg, num_heads=heads, num_kv_heads=kv_heads,
        kv_group=(cfg.num_heads // cfg.num_kv_heads
                  if replicated and kv_heads > 1 else 0),
        head_shards=cfg.num_heads // heads,
        kv_shards=cfg.num_kv_heads // kv_heads)


def init_attention(gen, cfg: AttentionCfg, dtype, device,
                   lead: Tuple[int, ...] = ()):
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p: Params = {
        "wq": dense_init(gen, lead + (D, H * Dh), dtype, device),
        "wk": dense_init(gen, lead + (D, Hkv * Dh), dtype, device),
        "wv": dense_init(gen, lead + (D, Hkv * Dh), dtype, device),
        "wo": dense_init(gen, lead + (H * Dh, D), dtype, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh)):
            p[name] = torch.zeros(lead + (n,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(Dh, dtype, device, lead)
        p["k_norm"] = init_rmsnorm(Dh, dtype, device, lead)
    return p


def _project_qkv(params: Params, cfg: AttentionCfg, x: torch.Tensor):
    b, sq, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, sq, H, Dh)
    k = k.reshape(b, sq, Hkv, Dh)
    if cfg.qk_norm:               # ahead of RoPE: the cache holds normed k
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    return q, k, v.reshape(b, sq, Hkv, Dh)


def _rank_kv(cfg: AttentionCfg, k: torch.Tensor, v: torch.Tensor):
    """K and V (B, S, Hkv, D) cut to one head a query head of this model
    rank (``cfg.kv_group``): a rank's query heads need not start at a KV
    group's first head, nor cover a group."""
    lo = S.model_index() * cfg.num_heads
    idx = torch.arange(lo, lo + cfg.num_heads,
                       device=k.device) // cfg.kv_group
    return k.index_select(2, idx), v.index_select(2, idx)


def _rope_for(cfg: AttentionCfg, positions: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin (B, S, D/2) of ``positions``: (B, S), or (3, B, S) for
    M-RoPE.  An M-RoPE layer given (B, S) text positions rotates all
    three components by them (t == h == w), as the reference does."""
    if cfg.mrope_sections is not None:
        if positions.dim() == 2:
            positions = positions.expand((3,) + tuple(positions.shape))
        return mrope_cos_sin(positions, cfg.head_dim, cfg.mrope_sections,
                             cfg.rope_theta)
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def attention_forward(params: Params, cfg: AttentionCfg, x: torch.Tensor, *,
                      positions: Optional[torch.Tensor] = None,
                      q_offset: int = 0,
                      kv_cache: Optional[Dict[str, torch.Tensor]] = None,
                      chunked: bool = False,
                      valid_len: Optional[int] = None,
                      train: bool = False, block_k: int = 512
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence (prefill or training) path.  Returns (out,
    new_cache).  ``train=True`` computes attention with
    ``train_attention`` (differentiable, ``block_k`` keys a block)
    instead of the forward-only flash kernel.  ``positions`` (B, S), or
    (3, B, S) under M-RoPE, rotate q and k; ``None`` gives the text
    positions ``q_offset + i``.

    ``chunked=True`` is the paged-prefill variant: queries attend the
    whole cache through ``chunk_attention`` (earlier chunks included),
    and ``valid_len`` clamps the length counter so a chunk right-padded
    to the page boundary doesn't count its pad positions.  The chunk's
    K/V are written into ``kv_cache`` in place."""
    b, sq, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x)
    if positions is None:
        positions = text_positions(b, sq, q_offset, x.device)
    cos, sin = _rope_for(cfg, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    new_cache = None
    if kv_cache is not None:
        kc, vc = kv_cache["k"], kv_cache["v"]
        start = seq_block_start("k", kc, q_offset + sq, chunked)
        put_positions(kc, k, q_offset - start)
        put_positions(vc, v, q_offset - start)
        new_len = kv_cache["len"] + sq
        if valid_len is not None:
            new_len = torch.clamp(new_len, max=valid_len)
        new_cache = {"k": kc, "v": vc, "len": new_len}
    if cfg.kv_group:
        k, v = _rank_kv(cfg, k, v)
    if chunked:
        if new_cache is None:
            raise ValueError("chunked prefill needs a cache")
        out = chunk_attention(q, new_cache["k"], new_cache["v"], q_offset)
    elif train:
        out = train_attention(q, k, v, causal=cfg.causal, q_offset=q_offset,
                              block_k=block_k)
    else:
        out = flash_attention(q, k, v, causal=cfg.causal, q_offset=q_offset)
    out = out.reshape(b, sq, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"], new_cache


def seq_block_start(name: str, cache: torch.Tensor, end: int,
                    chunked: bool = False) -> int:
    """The position of the first row of ``cache`` (B, S_block, ...; the
    leaves called ``name``): 0, or under a ``sharding.ServeSplit`` the
    rank's block's start along its sequence (dim 1).  Raises where the
    positions up to ``end`` do not fit the whole cache, and for a
    chunked prefill over a split (the serving scheduler's path, which
    serves over "data" only)."""
    sp = S.serve_split()
    whole = cache.shape[1]
    start = 0
    if sp is not None:
        if chunked:
            raise NotImplementedError("chunked prefill over a split "
                                      "serving layout")
        whole = sp.max_len
        start = sp.index(name, 1 - cache.dim())[1] * cache.shape[1]
    if end > whole:
        raise ValueError(f"positions up to {end} past the cache's {whole}")
    return start


def put_positions(cache: torch.Tensor, x: torch.Tensor, at: int) -> None:
    """Write ``x`` (B, S, ...) into ``cache`` (B, S_block, ...) from row
    ``at`` on, in place: the rows that fall inside the block (all of
    them where the cache is whole)."""
    lo, hi = max(at, 0), min(at + x.shape[1], cache.shape[1])
    if lo < hi:
        cache[:, lo:hi] = x[:, lo - at:hi - at].to(cache.dtype)


def attention_decode(params: Params, cfg: AttentionCfg, x: torch.Tensor,
                     kv_cache: Dict[str, torch.Tensor], *,
                     positions: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode with in-place cache update.  x: (B, 1, D);
    ``positions`` (B, 1), or (3, B, 1) under M-RoPE, rotate q and k
    (``None``: each sequence's cache length)."""
    b = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x)
    idx = kv_cache["len"]                                 # (B,)
    cos, sin = _rope_for(cfg, idx[:, None] if positions is None
                         else positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # Scatter the new kv at each sequence's own length (ragged batch);
    # over a split cache at its position in the rank's block, which
    # writes nothing where the block does not hold it.
    sp = S.serve_split()
    axes, start = (), 0
    if sp is not None:
        axes, blk = sp.index("k", -3)
        start = blk * kv_cache["k"].shape[1]
    kc = _scatter_token(kv_cache["k"], k, idx - start)
    vc = _scatter_token(kv_cache["v"], v, idx - start)
    new_len = idx + 1
    if sp is None:
        out = decode_attention(q, kc, vc, new_len)
    else:
        gather = "model" in axes and cfg.head_shards > 1
        kr, vr = ((kc, vc) if gather or not cfg.kv_group
                  else _rank_kv(cfg, kc, vc))
        valid = (torch.arange(kc.shape[1], device=x.device)[None, :]
                 < (new_len - start)[:, None])
        out = split_attention(q, kr, vr, axes, cfg.head_shards,
                              valid).to(q.dtype)
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"], {"k": kc, "v": vc, "len": new_len}


def _scatter_token(cache: torch.Tensor, token: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """cache: (B, Smax, ...); token: (B, 1, ...); idx: (B,).  Writes
    row ``idx[b]`` of each sequence in place; an index past the cache
    writes nothing, as the reference's one-hot select does."""
    b, smax = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    at = idx.long().clamp(0, smax - 1)
    inside = ((idx >= 0) & (idx < smax)).view(
        (b,) + (1,) * (cache.dim() - 2))
    cache[rows, at] = torch.where(inside, token[:, 0].to(cache.dtype),
                                  cache[rows, at])
    return cache


def init_kv_cache(batch: int, max_len: int, cfg: AttentionCfg, dtype,
                  device, lead: Tuple[int, ...] = ()
                  ) -> Dict[str, torch.Tensor]:
    shape = lead + (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros(lead + (batch,), dtype=torch.int32,
                               device=device)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLPCfg:
    d_model: int
    d_ff: int
    activation: str = "swiglu"


ACTIVATIONS = ("swiglu", "squared_relu", "gelu")


def _check_activation(cfg: MLPCfg) -> None:
    if cfg.activation not in ACTIVATIONS:
        raise NotImplementedError(
            f"MLP activation {cfg.activation!r} arrives with the port's "
            "remaining-model-families slice")


def init_mlp(gen, cfg: MLPCfg, dtype, device, lead: Tuple[int, ...] = ()):
    _check_activation(cfg)
    D, Fd = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {"w_gate": dense_init(gen, lead + (D, Fd), dtype, device),
                "w_up": dense_init(gen, lead + (D, Fd), dtype, device),
                "w_down": dense_init(gen, lead + (Fd, D), dtype, device)}
    return {"w_up": dense_init(gen, lead + (D, Fd), dtype, device),
            "w_down": dense_init(gen, lead + (Fd, D), dtype, device)}


def mlp_forward(params: Params, cfg: MLPCfg, x: torch.Tensor
                ) -> torch.Tensor:
    """SwiGLU, squared ReLU (nemotron's), or GELU in its tanh form
    (``jax.nn.gelu``'s default)."""
    _check_activation(cfg)
    if cfg.activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif cfg.activation == "squared_relu":
        h = F.relu(x @ params["w_up"])
        h = h * h
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec decoder)
# ---------------------------------------------------------------------------


def init_cross_attention(gen, cfg: AttentionCfg, dtype, device,
                         lead: Tuple[int, ...] = ()):
    return init_attention(gen, cfg, dtype, device, lead)


def cross_attention_forward(params: Params, cfg: AttentionCfg,
                            x: torch.Tensor, memory: torch.Tensor, *,
                            train: bool = False, block_k: int = 512,
                            memory_axes: Tuple[str, ...] = ()
                            ) -> torch.Tensor:
    """x: (B, Sq, D) queries; memory: (B, Skv, D) encoder states.  No
    RoPE; every query sees every memory position.  The memory's K and V
    are projected anew at every call (the reference keeps no cross-KV
    cache).  A memory in another dtype than the weights (an f32 cache's
    over bf16 weights, at prefill) is projected in the wider of the two,
    as JAX promotes the reference's product.  ``train=True`` attends
    through ``train_attention`` (differentiable), otherwise through the
    forward-only flash op.  Over a "model" axis ``cfg`` holds the rank's
    heads and ``params`` its columns of ``wq``/``wk``/``wv`` and rows of
    ``wo``; ``memory`` is whole, or (serving) the rank's block of its
    frames split over ``memory_axes``: the rank then attends over its
    frames (``split_attention``), with the K/V projections of every
    head gathered over "model" where the frames split over it too."""
    b, sq, _ = x.shape
    skv = memory.shape[1]
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wk, wv = params["wk"], params["wv"]
    bk, bv = params.get("bk"), params.get("bv")
    gather = "model" in memory_axes and cfg.head_shards > 1
    if gather and cfg.kv_shards > 1:     # every head's K/V of the frames
        wk, wv = (S.gather_axes(w, (S.MODEL_AXIS,), -1) for w in (wk, wv))
        if cfg.qkv_bias:
            bk, bv = (S.gather_axes(t, (S.MODEL_AXIS,), -1)
                      for t in (bk, bv))
        Hkv = Hkv * cfg.kv_shards
    dt = torch.promote_types(memory.dtype, wk.dtype)
    memory = memory.to(dt)
    q = (x @ params["wq"]).reshape(b, sq, H, Dh)
    k = (memory @ wk.to(dt)).reshape(b, skv, Hkv, Dh)
    v = (memory @ wv.to(dt)).reshape(b, skv, Hkv, Dh)
    if cfg.qkv_bias:
        q = q + params["bq"].reshape(H, Dh)
        k = k + bk.reshape(Hkv, Dh)
        v = v + bv.reshape(Hkv, Dh)
    if cfg.kv_group and not gather:
        k, v = _rank_kv(cfg, k, v)
    if memory_axes:
        out = split_attention(q, k, v, memory_axes,
                              cfg.head_shards).to(q.dtype)
        return out.reshape(b, sq, H * Dh) @ params["wo"]
    if train:
        out = train_attention(q, k, v, causal=False, block_k=block_k)
    else:
        out = flash_attention(q, k, v, causal=False)
    return out.reshape(b, sq, H * Dh) @ params["wo"]
