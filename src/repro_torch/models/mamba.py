"""Mamba2 (state-space duality / SSD, arXiv:2405.21060) of the port: the
chunked matmul form.

Counterpart of ``repro.models.mamba``.  The SSD scan is re-expressed as
(a) an intra-chunk masked product S = (C . B^T) * decay, (b) each chunk's
final state by products, and (c) a short recurrence over the chunk
boundaries (a Python loop here, ``lax.scan`` in the reference).  The
reference computes all of it in jnp, outside any Pallas kernel, so its
port is plain PyTorch, in f32 where the reference upcasts.

Decode is the O(1) recurrent step on a per-sequence (H, P, N) state.
The cache of a Mamba layer holds no position axis: ``conv`` (the last
``d_conv - 1`` raw conv inputs, in the cache's dtype) and ``ssm`` (the
state, f32 whatever the cache's dtype).  Unlike the attention caches,
which are written in place, a step returns both leaves anew.

``ssd_chunked`` takes only sequence lengths that are a multiple of
``chunk``: the reference asserts it (``ssd_chunked``'s ``nc * chunk ==
s``), so the port raises a ``ValueError`` where it does.

Over a "model" axis (training; ``MambaCfg.head_shards`` > 1, a rank's
local config) a rank holds its heads: its columns of each section of
``in_proj`` and the conv (``parallel.sharding.leaf_sections``), its
``A_log``, ``D``, ``dt_bias``, gated-norm scale and ``out_proj`` rows.
B and C are gathered whole on every rank, and the gated RMSNorm's mean
square, which spans all of d_inner, is summed over "model" (each as *f*
of *g*: every collective of the backward is a cut of the staged
backward, none waits inside an autograd node).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.parallel import sharding as S

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_model: int
    d_state: int = 128          # N
    expand: int = 2
    headdim: int = 64           # P
    ngroups: int = 1            # G (B/C projections shared per group)
    d_conv: int = 4
    chunk: int = 128            # SSD chunk length Q
    #: the port's: the model ranks the heads split over (a model rank's
    #: local config, ``parallel.sharding``): ``d_inner``, ``nheads`` and
    #: the B/C width are then the rank's share, ``expand`` and
    #: ``d_model`` stay the model's
    head_shards: int = 1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model // self.head_shards

    @property
    def nheads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def d_bc(self) -> int:
        """The B (and C) channels of the conv a rank holds."""
        return self.ngroups * self.d_state // self.head_shards

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.d_bc

    @property
    def proj_width(self) -> int:
        return 2 * self.d_inner + 2 * self.d_bc + self.nheads


def init_mamba(gen, cfg: MambaCfg, dtype, device,
               lead: Tuple[int, ...] = ()) -> Params:
    """The reference's tree and distributions; ``A_log``, ``D`` and
    ``dt_bias`` are f32 whatever ``dtype``."""
    D, H = cfg.d_model, cfg.nheads
    f32 = torch.float32
    if gen is None:
        dt_bias = torch.empty(lead + (H,), dtype=f32, device=device)
    else:
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(lead + (H,), generator=gen, dtype=f32, device=device)
        dt_bias = torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u)))
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=device))
    p: Params = {
        "in_proj": L.dense_init(gen, lead + (D, cfg.proj_width), dtype,
                                device),
        "conv_w": L._normal(gen, lead + (cfg.d_conv, cfg.conv_channels),
                            1.0 / math.sqrt(cfg.d_conv), dtype, device),
        "conv_b": torch.zeros(lead + (cfg.conv_channels,), dtype=dtype,
                              device=device),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), dtype=f32, device=device),
        "dt_bias": dt_bias,
        "out_proj": L.dense_init(gen, lead + (cfg.d_inner, D), dtype, device,
                                 fan_in=cfg.d_inner),
    }
    p["norm"] = L.init_rmsnorm(cfg.d_inner, dtype, device, lead)
    return p


def _split_proj(cfg: MambaCfg, zxbcdt: torch.Tensor):
    di, gn = cfg.d_inner, cfg.d_bc
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    return z, xbc, dt


def _join(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.concatenate`` along the sequence: the wider dtype wins."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dt), b.to(dt)], dim=1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d.  xbc: (B, S, C); w: (K, C).  ``tail``:
    (B, K-1, C) raw inputs of a previous segment (prefill and decode
    chaining); zeros of ``xbc``'s dtype without one."""
    k = w.shape[0]
    if tail is None:
        tail = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    xp = _join(tail, xbc)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return F.silu(out + b)


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) with out[t, s] = sum_{r=s+1..t} log_a_r
    for t >= s, -inf above the diagonal."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                device=log_a.device))
    return diff.masked_fill(~tri, -math.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan in chunked matmul form, in f32.

    x: (B, S, H, P); dt: (B, S, H); A: (H,) negative; Bm/Cm: (B, S, G,
    N); h0: optional initial state (B, H, P, N).  Returns (y (B, S, H, P)
    in x's dtype, h_final (B, H, P, N) f32).  ``S`` must be a multiple of
    ``chunk``."""
    b, s, h, pdim = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(
            f"sequence length {s} is not a multiple of the SSD chunk "
            f"{chunk} (the reference's ssd_chunked asserts it)")

    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, pdim).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    Bh = Bm.reshape(b, nc, chunk, g, n).to(f32).repeat_interleave(rep, 3)
    Ch = Cm.reshape(b, nc, chunk, g, n).to(f32).repeat_interleave(rep, 3)

    la_t = torch.movedim(dtc * A, -1, 2)           # (B,nc,H,Q) log-decay
    Lseg = torch.exp(_segsum(la_t))                # (B,nc,H,Q,Q)
    xdt = xc * dtc[..., None]                      # dt folded into inputs

    # (a) intra-chunk: S_ts = (C_t . B_s) * L_ts, Y_diag = S @ xdt
    scores = torch.einsum("bcqhn,bcshn->bchqs", Ch, Bh) * Lseg
    del Lseg
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores, xdt)
    del scores

    # (b) per-chunk final states: H_c = sum_s exp(sum_{r>s} la) B_s^T xdt_s
    cs_full = torch.cumsum(la_t, dim=-1)                   # (B,nc,H,Q)
    decay_states = torch.exp(cs_full[..., -1:] - cs_full)  # (B,nc,H,Q)
    states = torch.einsum("bcshn,bchs,bcshp->bchpn", Bh, decay_states,
                          xdt)                             # (B,nc,H,P,N)

    # (c) the recurrence over chunk boundaries, keeping the state BEFORE
    # each chunk
    chunk_decay = torch.exp(cs_full[..., -1])              # (B,nc,H)
    state = (torch.zeros((b, h, pdim, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    before = []
    for c in range(nc):
        before.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(before, dim=1)                   # (B,nc,H,P,N)

    # (d) the carried state's part: y_off[t] = exp(cs[t]) C_t . H_prev
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Ch, h_prevs,
                         torch.exp(cs_full))
    y = (y_diag + y_off).reshape(b, s, h, pdim)
    return y.to(x.dtype), state


def _heads(cfg: MambaCfg, xbc: torch.Tensor):
    """(x (.., H, P), B (.., G, N), C (.., G, N)) of the conv output.  Over
    a rank's heads B and C are gathered whole (``_whole_bc``) and cut to
    the groups of its heads (``_groups_of_heads``)."""
    di, gn = cfg.d_inner, cfg.d_bc
    lead = xbc.shape[:-1]
    xs = xbc[..., :di].reshape(lead + (cfg.nheads, cfg.headdim))
    if cfg.head_shards > 1:
        return (xs,) + _groups_of_heads(cfg, *_whole_bc(cfg, xbc[..., di:]))
    return (xs,
            xbc[..., di:di + gn].reshape(lead + (cfg.ngroups, cfg.d_state)),
            xbc[..., di + gn:].reshape(lead + (cfg.ngroups, cfg.d_state)))


def _gate_out(params: Params, cfg: MambaCfg, y: torch.Tensor,
              z: torch.Tensor, xs: torch.Tensor, x: torch.Tensor
              ) -> torch.Tensor:
    """The skip term, the gated RMSNorm and the output projection (over a
    rank's heads: the norm over all of d_inner, and its partial of the
    projection, summed over "model" by the layer's *g*)."""
    b, s = x.shape[:2]
    y = y + xs.float() * params["D"][:, None]
    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)
    y = L.rmsnorm(params["norm"], S.cut(y * F.silu(z)),
                  shards=cfg.head_shards)
    return y @ params["out_proj"]


def _whole_bc(cfg: MambaCfg, bc: torch.Tensor):
    """B and C (.., G, N) whole on every model rank from each rank's block
    of their channels (``bc``: the conv output's (.., 2 * ``d_bc``) B and
    C block): the block placed in zeros of the whole width and summed
    over "model" (*g*), entered through *f*, so the backward sums the
    ranks' partial gradients (each rank's heads read all of B and C) and
    hands each rank its block's."""
    lead = bc.shape[:-1]
    gn = cfg.d_bc
    lo = S.model_index() * gn
    bc = bc.reshape(lead + (2, gn))
    whole = gn * cfg.head_shards
    bc = S.copy_to_model(S.reduce_from_model(
        F.pad(bc, (lo, whole - lo - gn))))
    g = cfg.ngroups
    return (bc[..., 0, :].reshape(lead + (g, cfg.d_state)),
            bc[..., 1, :].reshape(lead + (g, cfg.d_state)))


def _groups_of_heads(cfg: MambaCfg, Bm: torch.Tensor, Cm: torch.Tensor):
    """The whole B and C (.., G, N) cut to the groups of this rank's heads,
    one a head (.., H_rank, N), unless every head shares one group."""
    if cfg.ngroups == 1:
        return Bm, Cm
    rep = cfg.nheads * cfg.head_shards // cfg.ngroups
    lo = S.model_index() * cfg.nheads
    idx = torch.arange(lo, lo + cfg.nheads, device=Bm.device) // rep
    return Bm.index_select(-2, idx), Cm.index_select(-2, idx)


def mamba_forward(params: Params, cfg: MambaCfg, x: torch.Tensor, *,
                  cache: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence path (training, prefill).  x: (B, S, D).  With a
    cache the conv tail and the state chain from it, and the new cache
    comes back: ``conv`` in the cache's dtype, ``ssm`` f32.

    A rank's local config (``cfg.head_shards`` > 1; ``params`` its shard,
    ``x`` whole after the layer's *f*) runs its heads; its cache, if any,
    is its block under a ``sharding.ServeSplit`` (``_conv_tail``,
    ``_conv_block``).  Under its ``StagedBackward`` the
    projection, the conv's output and the gated norm's input are cut
    (``sharding.cut``, the identity without one): each is read on two
    paths of which one crosses a cut (B and C's *f*, the mean square's
    *f*), so each segment of the backward runs its nodes once."""
    z, xbc_raw, dt = _split_proj(cfg, S.cut(x @ params["in_proj"]))
    conv_tail = None if cache is None else _conv_tail(cfg, cache["conv"])
    xbc = S.cut(_causal_conv(xbc_raw, params["conv_w"], params["conv_b"],
                             conv_tail))
    xs, Bm, Cm = _heads(cfg, xbc)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    h0 = None if cache is None else cache["ssm"]
    y, h_final = ssd_chunked(xs, dt, A, Bm, Cm, cfg.chunk, h0)
    out = _gate_out(params, cfg, y, z, xs, x)

    new_cache = None
    if cache is not None:
        k = cfg.d_conv - 1
        if cfg.head_shards > 1:
            tail = _join(_conv_whole(cfg, cache["conv"]),
                         _sections_whole(cfg, xbc_raw[:, -k:]))[:, -k:]
            tail = _conv_block(cfg, tail)
        else:
            tail = _join(cache["conv"], xbc_raw)[:, -k:]
        new_cache = {"conv": tail.to(cache["conv"].dtype), "ssm": h_final}
    return out, new_cache


# -- a split serving cache (``sharding.ServeSplit``): the reference's
# ``conv`` spec splits the (x, B, C) channels, joined, over its axes
# ("model"), while a rank's mixer holds its block of each section

def _conv_axes(cfg: MambaCfg) -> Tuple[str, ...]:
    sp = S.serve_split()
    if sp is None:
        raise ValueError("a Mamba mixer split over \"model\" serves from "
                         "a split cache only (Model.init_caches)")
    if sp.axes("ssm", -3) != (S.MODEL_AXIS,):
        raise NotImplementedError(
            f"an ssm state split {sp.axes('ssm', -3)} over its heads")
    return sp.axes("conv", -1)


def _conv_whole(cfg: MambaCfg, block: torch.Tensor) -> torch.Tensor:
    """The conv state (B, K-1, channels) of every channel from the rank's
    block of it."""
    return S.gather_axes(block, _conv_axes(cfg), dim=-1)


def _conv_block(cfg: MambaCfg, whole: torch.Tensor) -> torch.Tensor:
    """The rank's block of a conv state of every channel."""
    sp = S.serve_split()
    axes = _conv_axes(cfg)
    i, n = S.block_index(axes, sp.mesh_sizes, sp.mesh_coords)
    w = whole.shape[-1] // n
    return whole[..., i * w:(i + 1) * w]


def _section_widths(cfg: MambaCfg) -> Tuple[int, int, int]:
    return (cfg.d_inner, cfg.d_bc, cfg.d_bc)


def _sections_whole(cfg: MambaCfg, xbc: torch.Tensor) -> torch.Tensor:
    """Conv channels of every rank from this rank's sections (x, B, C)
    of them (``xbc`` (B, S, channels of the rank)): gathered over
    "model" and joined section by section."""
    parts = S.gather_axes(xbc[None], (S.MODEL_AXIS,), dim=0)
    out, lo = [], 0
    for w in _section_widths(cfg):
        out += [p[..., lo:lo + w] for p in parts]
        lo += w
    return torch.cat(out, dim=-1)


def _sections_of(cfg: MambaCfg, whole: torch.Tensor) -> torch.Tensor:
    """This rank's sections (x, B, C) of conv channels of every rank."""
    m, lo, out = S.model_index(), 0, []
    for w in _section_widths(cfg):
        out.append(whole[..., lo + m * w:lo + (m + 1) * w])
        lo += w * cfg.head_shards
    return torch.cat(out, dim=-1)


def _conv_tail(cfg: MambaCfg, conv: torch.Tensor) -> torch.Tensor:
    """The conv state a mixer chains from: the cache's, or over "model"
    this rank's sections of the whole state its block is part of."""
    if cfg.head_shards == 1:
        return conv
    return _sections_of(cfg, _conv_whole(cfg, conv))


def mamba_decode(params: Params, cfg: MambaCfg, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step.  x: (B, 1, D); O(1) in sequence length."""
    zxbcdt = x @ params["in_proj"]
    z, xbc_new, dt = _split_proj(cfg, zxbcdt)

    if cfg.head_shards > 1:      # the whole window, then the rank's part
        whole = _join(_conv_whole(cfg, cache["conv"]),
                      _sections_whole(cfg, xbc_new))
        window, conv = _sections_of(cfg, whole), _conv_block(cfg, whole)
    else:
        window = _join(cache["conv"], xbc_new)              # (B, K, C)
        conv = window
    w = params["conv_w"]
    ct = torch.promote_types(window.dtype, w.dtype)
    conv_out = torch.einsum("bkc,kc->bc", window.to(ct), w.to(ct))
    xbc = F.silu(conv_out + params["conv_b"])

    xs, Bm, Cm = _heads(cfg, xbc)                           # (B, H, P) ...
    rep = cfg.nheads // Bm.shape[1]        # a rank's heads: one B a head
    Bh = Bm.repeat_interleave(rep, 1).float()
    Ch = Cm.repeat_interleave(rep, 1).float()
    dt = F.softplus(dt[:, 0].float() + params["dt_bias"])   # (B, H)
    a = torch.exp(dt * -torch.exp(params["A_log"]))

    h = cache["ssm"].float()
    h = (h * a[..., None, None]
         + torch.einsum("bhp,bhn,bh->bhpn", xs.float(), Bh, dt))
    y = torch.einsum("bhpn,bhn->bhp", h, Ch)
    out = _gate_out(params, cfg, y[:, None], z, xs[:, None], x)
    return out, {"conv": conv[:, 1:].to(cache["conv"].dtype), "ssm": h}


def init_mamba_cache(batch: int, cfg: MambaCfg, dtype, device,
                     lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """``conv`` in ``dtype``; ``ssm`` f32 whatever ``dtype``."""
    return {
        "conv": torch.zeros(lead + (batch, cfg.d_conv - 1,
                                    cfg.conv_channels),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, cfg.nheads, cfg.headdim,
                                   cfg.d_state),
                           dtype=torch.float32, device=device),
    }
