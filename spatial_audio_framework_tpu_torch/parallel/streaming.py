"""Streaming engine: run a long signal through a block processor
(counterpart of ``spatial_audio_framework_tpu/parallel/streaming.py``).

The JAX package scans the blocks with ``lax.scan``; here the blocks are a
Python loop, each block's launches enqueued behind the previous ones.
Nothing in the loop reads the device back, so the host never waits for the
card (the blocks are views of the input and the outputs are joined once).
"""
from __future__ import annotations

from typing import Callable

import torch


def render_signal(process_fn: Callable, state, x: torch.Tensor,
                  block_size: int):
    """Run ``process_fn(state, block) -> (out_block, state)`` over a long
    signal x: (..., C, T) in blocks of ``block_size`` samples.

    T must be a multiple of block_size.  Returns (y: (..., C_out, T), state).
    """
    T = x.shape[-1]
    n_blocks = T // block_size
    if n_blocks * block_size != T:
        raise ValueError(f"render_signal: T={T} is not a multiple of "
                         f"block_size={block_size}")
    outs = []
    for b in range(n_blocks):
        out, state = process_fn(state,
                                x[..., b * block_size:(b + 1) * block_size])
        outs.append(out)
    return torch.cat(outs, dim=-1), state
