"""Stub modality frontends: precomputed embeddings for the ``[vlm]`` and
``[audio]`` architectures.

Counterpart of ``repro.models.frontends``.  qwen2-vl-7b's decoder takes
``inputs_embeds`` and 3-D M-RoPE positions from ``vision_patch_embeds``;
seamless-m4t-large-v2's encoder takes frame embeddings from
``audio_frame_embeds``.  The transformer backbone is the system under
test; these stubs define its input contract.

The embeddings are drawn from an explicit ``torch.Generator`` (on its
device), so they differ from the reference's ``jax.random`` draws; the
positions carry no randomness and equal the reference's bit for bit.
The reference's ``*_input_specs`` (shape structs for its dry-run) have
no counterpart yet.
"""

from __future__ import annotations

from typing import Dict

import torch


def vision_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    """Qwen2-VL's 3-D (t, h, w) positions, (3, B, S) int32: a leading
    quarter of image patches on a (1, side, side) grid, then text
    positions continuing from ``side`` (equal in all three components)."""
    n_img = seq // 4                       # leading quarter is "image"
    side = max(int(n_img ** 0.5), 1)
    idx = torch.arange(seq, dtype=torch.int32, device=device)
    in_img = idx < n_img
    text = idx - n_img + side
    t_pos = torch.where(in_img, torch.zeros_like(idx), text)
    h_pos = torch.where(in_img, torch.clamp(idx // side, max=side - 1), text)
    w_pos = torch.where(in_img, idx % side, text)
    pos = torch.stack([t_pos, h_pos, w_pos])             # (3, S)
    return pos[:, None, :].expand(3, batch, seq)


def vision_patch_embeds(gen: torch.Generator, batch: int, seq: int,
                        d_model: int, dtype=torch.float32
                        ) -> Dict[str, torch.Tensor]:
    """Qwen2-VL stub: {"inputs_embeds": (B, S, D) N(0, 0.02^2) in
    ``dtype``, "positions": (3, B, S) int32} on ``gen``'s device."""
    embeds = torch.randn((batch, seq, d_model), generator=gen,
                         dtype=torch.float32, device=gen.device)
    return {"inputs_embeds": embeds.mul_(0.02).to(dtype),
            "positions": vision_positions(batch, seq, gen.device)}


def audio_frame_embeds(gen: torch.Generator, batch: int, frames: int,
                       d_model: int, dtype=torch.float32) -> torch.Tensor:
    """Seamless stub: w2v-BERT-style frame embeddings (already
    downsampled), (B, frames, D) N(0, 0.05^2) in ``dtype``."""
    x = torch.randn((batch, frames, d_model), generator=gen,
                    dtype=torch.float32, device=gen.device)
    return x.mul_(0.05).to(dtype)


__all__ = ["audio_frame_embeds", "vision_patch_embeds", "vision_positions"]
