"""``Model``: one API over the decoder stack and the encoder-decoder
(counterpart of ``repro.models.model``).

  init / abstract_params / param_count / shard  — parameters
  loss / loss_and_grads / logits                — training
  init_caches / prefill / prefill_chunk / decode_step — serving

``kind`` is ``"encdec"`` for an ``EncDecCfg`` (seamless-m4t-large-v2:
its batches carry ``frame_embeds`` beside ``tokens``, its caches the
encoder's ``memory`` beside the decoder's KV) and ``"decoder"``
otherwise.  A decoder without an embedding table (qwen2-vl-7b) takes
``inputs_embeds`` and its M-RoPE ``positions`` where the others take
``tokens``.

Prefill and decode write the caches they are given in place (see
``repro_torch.models.layers``) and return them; the state leaves (the
``len`` counters, a Mamba layer's ``conv`` and ``ssm``) come back as new
tensors.

``model_parallel > 1`` builds the model a rank of a mesh with a "model"
axis of that size computes (``parallel.sharding``): ``init`` still gives
the full params, ``shard`` a rank's block of them, and ``loss`` /
``loss_and_grads`` run on that block inside the rank.  Every family
the reference splits over "model" splits so: attention, MLA and Mamba
heads, FFN columns and experts, the encoder-decoder's self- and
cross-attention; a model without an embedding table takes its
``inputs_embeds`` and ``positions`` whole on every rank.

Such a model also serves as a rank of a ``("data", "model")`` or
``("pod", "data", "model")`` mesh, as the reference's dry-run cells
place its prefill and decode: ``rank_params`` gives the rank its "data"
block of its "model" block of every param (the reference's
``param_specs``; each block gathered over "data" as its layer runs),
``init_caches`` (called inside the rank, or given ``mesh`` and
``rank``) the rank's blocks of the caches as the reference's
``serve_cache_shardings`` places them (``sharding.cache_split``: heads
over "model", or the sequence where the K/V heads do not divide), and
``prefill`` / ``decode_step`` on the rank's rows (``sharding.row_axes``)
return its vocabulary block of the logits; ``argmax`` joins a row's
blocks.  The reference's serving launcher runs ``model_parallel=1``
only, and so does the port's scheduler.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.core import trace
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as S
from repro_torch.runtime import substrate
from repro_torch.tree import flatten, leaves, unflatten

Params = Dict[str, Any]
Cfg = Union[T.TransformerCfg, ED.EncDecCfg]


@dataclasses.dataclass
class Model:
    cfg: Cfg
    model_parallel: int = 1

    def __post_init__(self):
        self.layout = (S.layout(self.cfg, self.model_parallel)
                       if self.model_parallel > 1 else None)
        local = ED.local_config if self.kind == "encdec" else T.local_config
        self.local_cfg = (self.cfg if self.layout is None
                          else local(self.cfg, self.layout))
        # the serving split's shape arithmetic, once a layout (probing
        # shapes allocates ``meta`` tensors, which a step's meter counts)
        self._memo: Dict[Any, Any] = {}

    @property
    def kind(self) -> str:
        return ("encdec" if isinstance(self.cfg, ED.EncDecCfg)
                else "decoder")

    @property
    def name(self) -> str:
        return self.cfg.name

    def _init_params(self, gen, cfg, device) -> Params:
        if self.kind == "encdec":
            return ED.init_params(gen, cfg, device)
        return T.init_params(gen, cfg, device)

    # -- parameters -----------------------------------------------------

    def init(self, generator: torch.Generator) -> Params:
        """Random full params on the generator's device."""
        return self._init_params(generator, self.cfg, generator.device)

    def abstract_params(self) -> Params:
        """One rank's params as ``meta`` tensors: shapes and dtypes, no
        memory (its shard with a model axis)."""
        return self._init_params(None, self.local_cfg,
                                 torch.device("meta"))

    def param_count(self) -> int:
        """Parameters of the whole model."""
        return sum(math.prod(t.shape) for t in leaves(
            self._init_params(None, self.cfg, torch.device("meta"))))

    def shard(self, params: Params, index: int) -> Params:
        """Model rank ``index``'s params from the full ``params``: a copy
        of its shard, or (no model axis) ``params`` itself."""
        if self.layout is None:
            return params
        return S.shard_params(params, self.layout, index)

    # -- training ---------------------------------------------------------

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(scalar f32 loss, metrics) of a {"tokens", "labels"} batch
        ({"inputs_embeds", "positions", "labels"} without an embedding
        table; {"frame_embeds", "tokens", "labels"} for the enc-dec),
        differentiable in ``params`` (with a model axis: the calling
        rank's shard)."""
        loss_fn = ED.loss_fn if self.kind == "encdec" else T.loss_fn
        if self.layout is None:
            return loss_fn(params, self.cfg, batch)
        return loss_fn(params, self.local_cfg, batch,
                       tp_index=S.model_index())

    def loss_and_grads(self, params: Params, batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Params]:
        """(detached loss, gradient of every leaf of ``params``).  With a
        model axis the backward is staged (``sharding.StagedBackward``):
        its all-reduces run on the rank's own thread.  Inside a step that
        splits params over "data" (``sharding.DataSplit``, the calling
        thread's) the backward is staged too, the model reads each split
        leaf as a ``sharding.DataBlock``, and that leaf's gradient is
        reduce-scattered into the split's accumulator instead: its entry
        here is None."""
        ps, paths = flatten(params)
        split = S.active_data_split()
        xs = [S.DataBlock(split, i, p, split.dims[i])
              if split is not None and split.dims[i] is not None
              else p.detach().requires_grad_(True)
              for i, p in enumerate(ps)]
        if self.layout is None and split is None:
            loss, _ = self.loss(unflatten(paths, xs), batch)
            grads = list(torch.autograd.grad(loss, xs))
        else:
            with S.StagedBackward() as tape:
                loss, _ = self.loss(unflatten(paths, xs), batch)
            tape.backward(loss)
            grads = [None if isinstance(x, S.DataBlock)
                     else x.grad if x.grad is not None
                     else torch.zeros_like(x) for x in xs]
        return loss.detach(), unflatten(paths, grads)

    def logits(self, params: Params, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
        """Teacher-forced logits (B, S, V) of a loss batch (forward-only
        attention: the flash op)."""
        if self.kind == "encdec":
            memory = ED.encode(params, self.cfg, batch["frame_embeds"])
            return ED.decode_train(params, self.cfg, batch["tokens"], memory)
        h, _, _ = T.forward(params, self.cfg, batch)
        return T._unembed(params, self.cfg, h)

    # -- serving ----------------------------------------------------------

    def cache_shapes(self, batch: int, max_len: int, *, enc_len: int = 0,
                     dtype=torch.bfloat16) -> Params:
        """The whole caches on ``meta`` (the reference's ``init_caches``
        shapes; a model split over "model" holds blocks of them)."""
        meta = torch.device("meta")
        if self.kind == "encdec":
            return ED.init_caches(self.cfg, batch, max_len, enc_len, dtype,
                                  meta)
        return T.init_caches(self.cfg, batch, max_len, dtype, meta)

    def init_caches(self, batch: int, max_len: int, *, enc_len: int = 0,
                    dtype=torch.bfloat16, device="cuda", mesh=None,
                    rank=None) -> Params:
        """Decode caches of ``batch`` rows of ``max_len`` positions; the
        enc-dec's also hold the encoder's memory of ``enc_len`` frames.
        Split over "model": the rank's blocks of them (``batch`` is the
        global batch), a ``sharding.CacheBlocks`` carrying the split, for
        the calling rank or rank ``rank`` of ``mesh``."""
        if self.layout is None:
            if self.kind == "encdec":
                return ED.init_caches(self.cfg, batch, max_len, enc_len,
                                      dtype, resolve_device(device))
            return T.init_caches(self.cfg, batch, max_len, dtype,
                                 resolve_device(device))
        split = self.serve_split(batch, max_len, enc_len=enc_len, mesh=mesh,
                                 rank=rank)
        key = ("leaves", batch, max_len, enc_len, dtype)
        if key not in self._memo:
            whole = flatten(self.cache_shapes(batch, max_len,
                                              enc_len=enc_len, dtype=dtype))
            self._memo[key] = [(tuple(w.shape), w.dtype) for w in whole[0]]
        dev = resolve_device(device)
        blocks = [torch.zeros(tuple(s.stop - s.start
                                    for s in split.block(i, shape)),
                              dtype=dt, device=dev)
                  for i, (shape, dt) in enumerate(self._memo[key])]
        caches = S.CacheBlocks(unflatten(list(split.paths), blocks), split)
        trace.label(caches, "caches")
        return caches

    def serve_split(self, batch: int, max_len: int, *, enc_len: int = 0,
                    mesh=None, rank=None) -> S.ServeSplit:
        """Rank ``rank``'s ``sharding.ServeSplit`` of ``mesh`` (default:
        the calling rank's) serving ``batch`` rows of ``max_len``
        positions."""
        if mesh is None:
            mesh, rank = substrate.current_mesh(), substrate.current_rank()
        sizes = mesh.shape
        if sizes.get(S.MODEL_AXIS, 1) != self.model_parallel:
            raise ValueError(f"a model split over {self.model_parallel} "
                             f"model ranks on a mesh of {sizes}")
        key = ("split", tuple(sizes.items()), batch, max_len, enc_len)
        if key not in self._memo:
            specs, whole = S.cache_split(self, sizes, batch, max_len,
                                         enc_len)
            self._memo[key] = (tuple(flatten(whole)[1]), tuple(specs))
        paths, specs = self._memo[key]
        return S.ServeSplit(
            sizes=tuple(sizes.items()), coords=tuple(mesh.coords(rank)
                                                     .items()),
            max_len=max_len, enc_len=enc_len, paths=paths, specs=specs)

    def _data_dims(self, data: int):
        """Per param leaf, the dim the reference's specs split over
        ``data`` ranks (``sharding.data_split`` of the rank's model
        block)."""
        key = ("data", data)
        if key not in self._memo:
            ps, paths = flatten(self.abstract_params())
            self._memo[key] = [S.data_split(p, self.layout, data, l.shape)
                               for p, l in zip(paths, ps)]
        return self._memo[key]

    def rank_params(self, params: Params, mesh, rank: int) -> Params:
        """Rank ``rank``'s serving params on ``mesh`` from the full
        ``params``: of its model shard, the "data" block of each leaf the
        reference's specs split over "data", as contiguous copies."""
        if self.layout is None:
            raise ValueError("serving params split over a mesh need a "
                             "model split over \"model\"")
        c = mesh.coords(rank)
        data = mesh.shape.get(S.DATA_AXIS, 1)
        ps, paths = flatten(self.shard(params, c[S.MODEL_AXIS]))
        return unflatten(paths, [
            S.data_block(p, d, data, c.get(S.DATA_AXIS, 0)).contiguous()
            .clone() if d is not None else p
            for p, d in zip(ps, self._data_dims(data))])

    def _serve(self, params: Params, batch, caches: Params, *, decode: bool
               ) -> Tuple[torch.Tensor, Params]:
        """A prefill or decode step of a rank of a split layout: the
        rank's data blocks gathered over "data" as their layer runs, its
        heads (or its block of a cache's positions) over "model"."""
        if not isinstance(caches, S.CacheBlocks):
            raise ValueError("a model split over \"model\" serves from the "
                             "blocks Model.init_caches makes")
        split = caches.split
        data = split.mesh_sizes.get(S.DATA_AXIS, 1)
        ps, paths = flatten(params)
        if data > 1:
            holder = S.DataSplit(self._data_dims(data), [])
            ps = [p if d is None else S.DataBlock(holder, i, p, d)
                  for i, (p, d) in enumerate(zip(ps, holder.dims))]
        p, tp, cfg = unflatten(paths, ps), S.model_index(), self.local_cfg
        with torch.no_grad(), split.active():
            if self.kind == "encdec":
                if decode:
                    logits, new = ED.decode_step(p, cfg, batch["tokens"],
                                                 caches, tp_index=tp)
                else:
                    logits, new = ED.prefill(p, cfg, batch, caches,
                                             tp_index=tp)
            else:
                h, new, _ = T.forward(p, cfg, batch, caches=caches,
                                      decode=decode, tp_index=tp)
                logits = T._unembed(p, cfg, h[:, -1:])[:, 0]
        return logits, S.CacheBlocks(new, split)

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """Each row's vocabulary index of its largest logit.  A rank's
        block of a split step's logits: the blocks' maxima gathered over
        "model", the first of the largest taken (ties to the lowest
        index, as ``torch.argmax``)."""
        if self.layout is None or "vocab" in self.layout.whole:
            return logits.argmax(dim=-1)
        lf = logits.double()
        best = (lf.argmax(dim=-1) + S.model_index() * lf.shape[-1]).double()
        both = S.gather_axes(torch.stack([lf.amax(dim=-1), best],
                                         dim=-1)[None], (S.MODEL_AXIS,), 0)
        pick = both[..., 0].argmax(dim=0)
        return both[..., 1].gather(0, pick[None])[0].long()

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                caches: Params) -> Tuple[torch.Tensor, Params]:
        """Fill the cache from a prompt ({"tokens"}, {"inputs_embeds",
        "positions"}, or the enc-dec's {"frame_embeds", "tokens"});
        returns (last-position logits, caches).  Split over "model" (see
        the module doc): the rank's rows, its blocks, its logits' block."""
        if self.layout is not None:
            return self._serve(params, batch, caches, decode=False)
        if self.kind == "encdec":
            return ED.prefill(params, self.cfg, batch, caches)
        h, new_caches, _ = T.forward(params, self.cfg, batch, caches=caches,
                                  q_offset=0)
        logits = T._unembed(params, self.cfg, h[:, -1:])
        return logits[:, 0], new_caches

    @property
    def supports_chunked_prefill(self) -> bool:
        """Whether every mixer has an absolute-position chunked prefill
        path (attention, MLA).  A Mamba layer's recurrent state depends
        on every value before it, so its models prefill one-shot, as
        does the encoder-decoder."""
        if self.kind == "encdec":
            return False
        return all(spec.mixer in ("attn", "mla")
                   for st in self.cfg.stages for spec in st.layers)

    def prefill_chunk(self, params: Params, batch: Dict[str, torch.Tensor],
                      caches: Params, *, q_offset: int, valid_len: int,
                      last_index: int) -> Tuple[torch.Tensor, Params]:
        """One page-sized prefill chunk at ``q_offset``.  The chunk is
        right-padded to the page boundary; ``valid_len`` clamps the cache
        length counters so pad positions don't count, and ``last_index``
        (chunk-local) picks which position's logits to return —
        meaningful on the final chunk, where it is the prompt's last real
        token."""
        h, new_caches, _ = T.forward(params, self.cfg, batch, caches=caches,
                                  q_offset=q_offset, chunked=True,
                                  valid_len=valid_len)
        logits = T._unembed(params, self.cfg,
                            h[:, last_index:last_index + 1])
        return logits[:, 0], new_caches

    def decode_step(self, params: Params, batch: Dict[str, torch.Tensor],
                    caches: Params) -> Tuple[torch.Tensor, Params]:
        """One token for every sequence.  batch: {"tokens": (B, 1)}, or
        {"inputs_embeds": (B, 1, D)} with optional "positions" ((B, 1),
        or (3, B, 1) under M-RoPE; by default each row's cache length).
        Split over "model" as ``prefill``."""
        if self.layout is not None:
            return self._serve(params, batch, caches, decode=True)
        if self.kind == "encdec":
            return ED.decode_step(params, self.cfg, batch["tokens"], caches)
        h, new_caches, _ = T.forward(params, self.cfg, batch, caches=caches,
                                  decode=True)
        logits = T._unembed(params, self.cfg, h)
        return logits[:, 0], new_caches


def build_model(cfg: Cfg, model_parallel: int = 1) -> Model:
    """The model a rank computes on a mesh whose "model" axis has
    ``model_parallel`` ranks (1: no model axis)."""
    return Model(cfg=cfg, model_parallel=model_parallel)
