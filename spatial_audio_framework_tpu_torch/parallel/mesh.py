"""Device grids for multi-stream rendering (counterpart of
``spatial_audio_framework_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` with a 'dp' axis (streams,
data-parallel) and a 'tp' axis (the SH / input-channel dimension of the
per-band decode, tensor-parallel), and XLA partitions a jitted function
over the sharded arrays.  The port has no such compiler, so the grid is
explicit: a (dp, tp) array of ``torch.device``s in one process (no
``torch.distributed``), and :func:`run_sharded` runs a batched process on
each shard on its device and gathers the outputs on the grid's first
device.

With tp > 1 each device of a row holds a slice of the input channels, the
weights' matching slice and a partial output; the row's partial outputs
are summed.  That is exact for the linear renders (``ambi_bin``,
``binauraliser``: the output is a sum over input channels), and their
overlap-add tails stay partial on each device, summing to the unsharded
tail, so the state is split the same way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (dp, tp) grid of devices, axis names ('dp', 'tp')."""
    devices: np.ndarray   # (dp, tp) object array of torch.device

    axis_names = ("dp", "tp")

    @property
    def shape(self) -> dict:
        dp, tp = self.devices.shape
        return {"dp": dp, "tp": tp}


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """Where the axes of an array go: ``spec[i]`` is the mesh axis its
    axis i is split over ('dp', 'tp' or None: whole on every device);
    an empty spec replicates the array."""
    mesh: Mesh
    spec: tuple

    def place(self, x: torch.Tensor) -> np.ndarray:
        """(dp, tp) object array of x's pieces, each on its device."""
        grid = np.empty(self.mesh.devices.shape, dtype=object)
        for (i, j), dev in np.ndenumerate(self.mesh.devices):
            piece = x
            for ax, name in enumerate(self.spec):
                if name is not None:
                    k, n = (i, grid.shape[0]) if name == "dp" else (
                        j, grid.shape[1])
                    piece = piece.tensor_split(n, dim=ax)[k]
            grid[i, j] = piece.to(dev).contiguous()
        return grid


def _visible_cards() -> list:
    default_device()          # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """Create a ('dp', 'tp') grid over ``devices`` (default: the visible
    CUDA cards; tests pass CPU devices).  Default: all devices on 'dp'.
    Raises ValueError when dp·tp is not the number of devices."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else _visible_cards()
    n = n_devices or len(devs)
    if dp is None:
        dp = n // tp
    if dp * tp != n or n > len(devs) or dp < 1:
        raise ValueError(f"make_mesh: a ({dp}, {tp}) grid does not factor "
                         f"{n} devices (of {len(devs)})")
    grid = np.empty((dp, tp), dtype=object)
    for k, d in enumerate(devs[:n]):
        grid[k // tp, k % tp] = d
    return Mesh(grid)


def stream_sharding(mesh: Mesh, shard_channels: bool = False
                    ) -> NamedSharding:
    """Sharding for (streams, channels, time) blocks: streams on 'dp', and
    optionally channels on 'tp'."""
    return NamedSharding(mesh, ("dp", "tp" if shard_channels else None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _map(fn, tree):
    """Apply ``fn`` to every tensor of a tuple / NamedTuple / list / dict
    tree, keeping its structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _grid_map(fn, mesh: Mesh, tree) -> np.ndarray:
    """(dp, tp) object array of ``_map(lambda t: fn(t, i, j, dev), tree)``."""
    grid = np.empty(mesh.devices.shape, dtype=object)
    for (i, j), dev in np.ndenumerate(mesh.devices):
        grid[i, j] = _map(lambda t: fn(t, i, j, dev), tree)
    return grid


def shard_leading(tree, mesh: Mesh) -> np.ndarray:
    """Place every leaf of a batched state tree with its leading (stream)
    axis split over 'dp' (whole across 'tp') → (dp, tp) object array of
    trees, each on its device."""
    dp = mesh.shape["dp"]
    return _grid_map(
        lambda t, i, j, dev: t.tensor_split(dp, 0)[i].to(dev).contiguous(),
        mesh, tree)


@dataclass(frozen=True, eq=False)
class ShardedState:
    """A batched state on a grid: ``grid[i, j]`` is device (i, j)'s tree;
    ``split[k]`` says whether leaf k's axis 1 (the input channels) is
    split over 'tp' (else the leaf is partial: the row sums to it)."""
    grid: np.ndarray
    split: tuple

    def gather(self):
        """The unsharded state on the grid's first device: 'dp' pieces
        joined along the leading axis, split leaves joined along axis 1,
        partial leaves summed."""
        first = self.grid[0, 0]
        dev = _leaves(first)[0].device
        rows = []
        for i in range(self.grid.shape[0]):
            row = [_leaves(self.grid[i, j])
                   for j in range(self.grid.shape[1])]
            rows.append([
                torch.cat([p.to(dev) for p in parts], dim=1) if split
                else torch.stack([p.to(dev) for p in parts]).sum(0)
                for split, parts in zip(self.split, zip(*row))])
        it = iter([torch.cat(parts, dim=0) for parts in zip(*rows)])
        return _map(lambda _: next(it), first)


def _shard_state(state, mesh: Mesh, n_channels: int,
                 shard_channels: bool) -> ShardedState:
    """A batched state on the grid: leading axis over 'dp'; with
    ``shard_channels`` a leaf whose axis 1 holds the input channels is
    split over 'tp' as the input is,
    every other leaf (the output side, e.g. the overlap-add tail) is kept
    by the row's first device and zero on the others, so the row's
    partial states sum to the unsharded one."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    split = tuple(shard_channels and tp > 1 and t.ndim >= 2
                  and t.shape[1] == n_channels for t in _leaves(state))

    grid = np.empty(mesh.devices.shape, dtype=object)
    for (i, j), dev in np.ndenumerate(mesh.devices):
        flags = iter(split)

        def put(t):
            t = t.tensor_split(dp, 0)[i]
            if next(flags):
                t = t.tensor_split(tp, 1)[j]
            elif j > 0:
                t = torch.zeros_like(t)
            return t.to(dev).contiguous()

        grid[i, j] = _map(put, state)
    return ShardedState(grid, split)


def _shard_weights(weights, mesh: Mesh, shard_channels: bool) -> np.ndarray:
    """The weights on every device: whole, or with tp > 1 split along each
    leaf's last axis (the input channels, as in ``design_ri``'s (B, 2,
    nSH) matrices) over 'tp'."""
    tp = mesh.shape["tp"]

    def put(t, i, j, dev):
        if shard_channels and tp > 1:
            t = t.tensor_split(tp, -1)[j]
        return t.to(dev).contiguous()

    return _grid_map(put, mesh, weights)


def _leaves(tree) -> list:
    out = []
    _map(lambda t: out.append(t) or t, tree)
    return out


def run_sharded(process: Callable, weights, state, x: torch.Tensor,
                mesh: Mesh, shard_channels: bool = False):
    """Run ``process(weights, state, x) -> (y, state)`` on every device of
    the grid with its shard, as ``jax.jit`` does on sharded inputs.

    x: (S, C, T) on any device, streams split over 'dp' (and, with
    ``shard_channels``, the C input channels over 'tp'); ``weights``: a
    tree replicated to every device (with ``shard_channels``, each leaf's
    last axis split over 'tp'); ``state``: a batched state tree
    (placed here) or the :class:`ShardedState` a previous call returned.
    Returns (y (S, C_out, T) on the grid's first device: the 'dp' pieces
    joined and the 'tp' partial outputs summed, ShardedState).  Without
    ``shard_channels`` each row's first device does the row's work (the
    others would repeat it).  The devices' calls are enqueued one after
    another; nothing waits for a device.
    """
    n_channels = x.shape[1]
    xs = stream_sharding(mesh, shard_channels).place(x)
    ws = _shard_weights(weights, mesh, shard_channels)
    sts = state if isinstance(state, ShardedState) else _shard_state(
        state, mesh, n_channels, shard_channels)
    new = sts.grid.copy()
    first = mesh.devices[0, 0]
    rows = []
    for i in range(mesh.shape["dp"]):
        part = None
        for j in range(mesh.shape["tp"] if shard_channels else 1):
            y, new[i, j] = process(ws[i, j], sts.grid[i, j], xs[i, j])
            y = y.to(first)
            part = y if part is None else part + y
        rows.append(part)
    return torch.cat(rows, dim=0), ShardedState(new, sts.split)
