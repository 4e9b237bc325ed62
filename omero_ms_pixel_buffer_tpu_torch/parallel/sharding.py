"""The sharded device programs over a mesh (counterpart of
``omero_ms_pixel_buffer_tpu/parallel/sharding.py``).

Each JAX ``shard_map`` program becomes the same recipe in torch: pad the
lanes to a multiple of the mesh width (``pad_batch``), split them into
contiguous per-slot blocks, run the port's single-device chain on each
slot's device (so every slot launches the same ``ops/kernels`` wrappers:
the filter kernel and the SP or dense packer), then gather the results
on the first slot's device. The per-lane math does not depend on the
slot, so every sharded output is byte-equal to the single-device chain
on the same lanes, and to the JAX program's.

- ``sharded_batch_filter``: byteswap + PNG filter, lanes sharded.
- ``distributed_filter_plane``: one plane's rows sharded; each slot gets
  the previous slot's last row (zeros for slot 0), the counterpart of
  the JAX ``ppermute`` halo, runs the filter kernel in ``up`` mode on
  halo + rows and drops the first output row.
- ``sharded_filter_deflate``, ``sharded_render_filter_deflate`` (an
  optional ROI mask sharded with its lanes), ``sharded_filter_histogram``
  and ``sharded_dynamic_emit`` (the two passes of ``dynamic``, the
  per-lane tables sharded with their lanes) and
  ``sharded_supertile_carve_deflate`` (each slot composites its own
  overlapped window of a super-tile and carves its lanes).

The slots run one after another on the calling thread; their device
work is asynchronous, so slots on different GPUs overlap. Launches made
for a slot are counted under its index (``ops.kernels.slot_scope``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.convert import bits_tensor
from ..ops.device_deflate import (
    dynamic_emit,
    fused_filter_deflate_batch,
    fused_filter_histogram_batch,
    tables_from_numpy,
)
from ..ops.kernels import slot_scope
from ..ops.kernels.filter import filter_tiles
from ..render.engine import fused_render_filter_deflate_batch
from ..render.supertile import composite_carve_torch
from .mesh import Mesh

__all__ = ["distributed_filter_plane", "gather", "pad_batch", "shard_blocks",
           "sharded_batch_filter", "sharded_dynamic_emit", "sharded_filter_deflate",
           "sharded_filter_histogram", "sharded_render_filter_deflate",
           "sharded_supertile_carve_deflate"]


def pad_batch(tiles: torch.Tensor, multiple: int):
    """Zero lanes up to a multiple of ``multiple``: (padded, real count).
    The pad lanes are sliced off after the sharded call."""
    b = tiles.shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return tiles, b
    zeros = torch.zeros((pad,) + tuple(tiles.shape[1:]), dtype=tiles.dtype, device=tiles.device)
    return torch.cat([tiles, zeros]), b


def shard_blocks(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """``x``'s leading axis in ``mesh.size`` equal contiguous blocks, each
    on its slot's device."""
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} lanes do not split over {n} slots; pad_batch first")
    per = x.shape[0] // n
    return [x[i * per:(i + 1) * per].to(s.device, non_blocking=True)
            for i, s in enumerate(mesh.slots)]


def gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The slots' results, in slot order, on the first slot's device."""
    dev = mesh.slots[0].device
    return torch.cat([p.to(dev) for p in parts])


def _per_slot(mesh: Mesh, fn, *blocks):
    """``fn(slot, *its blocks)`` for every slot, in the slot's launch
    scope (a block list of None passes None); the results in slot order."""
    out = []
    for i, slot in enumerate(mesh.slots):
        with slot_scope(slot.index):
            out.append(fn(slot, *(None if b is None else b[i] for b in blocks)))
    return out


def sharded_batch_filter(mesh: Mesh, tiles: torch.Tensor, bpp: int,
                         mode: str = "up") -> torch.Tensor:
    """(B, H, W) grey or (B, H, W, S) interleaved tiles, B a multiple of
    the mesh width -> (B, H, 1 + W*bpp) filtered big-endian scanlines,
    each slot's lanes through the filter kernel on its device. ``bpp``
    must be the tiles' samples x itemsize."""
    samples = tiles.shape[3] if tiles.ndim == 4 else 1
    if bpp != samples * tiles.element_size():
        raise ValueError(f"bpp {bpp} does not match the tiles' {samples} sample(s) of "
                         f"{tiles.element_size()} byte(s)")
    parts = _per_slot(mesh, lambda _s, blk: filter_tiles(blk, mode), shard_blocks(mesh, tiles))
    return gather(mesh, parts)


def distributed_filter_plane(mesh: Mesh, plane: torch.Tensor, mode: str = "up") -> torch.Tensor:
    """One plane's rows over the mesh: (H, W) 8/16-bit, H a multiple of
    the width -> (H, 1 + W*itemsize) ``up``-filtered scanlines. Slot i
    receives slot i-1's last row (slot 0: a zero row, PNG's row above
    the image), filters halo + rows with the filter kernel and drops the
    halo's output row."""
    if mode != "up":
        raise ValueError("distributed filtering supports mode='up'")
    blocks = shard_blocks(mesh, plane)
    halos = [torch.zeros_like(blocks[0][:1])]
    halos += [blocks[i - 1][-1:].to(mesh.slots[i].device) for i in range(1, mesh.size)]

    def local(_slot, rows, halo):
        return filter_tiles(torch.cat([halo, rows])[None], "up")[0, 1:]

    return gather(mesh, _per_slot(mesh, local, blocks, halos))


def _gather_pairs(mesh: Mesh, parts):
    return gather(mesh, [p[0] for p in parts]), gather(mesh, [p[1] for p in parts])


def sharded_filter_deflate(mesh: Mesh, tiles: torch.Tensor, rows: int, row_bytes: int, bpp: int,
                           filter_mode: str = "up", deflate_mode: str = "rle",
                           packer: Optional[str] = None):
    """The one-pass encode chain (``rle`` or ``stored``) over the mesh:
    tiles (B, H, W[, S]), B a multiple of the width -> ((B, cap) uint8
    zlib streams, (B,) lengths); each slot builds its lanes' whole
    streams (filter kernel, tokens, packer, framing)."""
    parts = _per_slot(mesh, lambda _s, blk: fused_filter_deflate_batch(
        blk, rows, row_bytes, bpp, filter_mode=filter_mode, mode=deflate_mode, packer=packer),
        shard_blocks(mesh, tiles))
    return _gather_pairs(mesh, parts)


def sharded_render_filter_deflate(mesh: Mesh, planes: torch.Tensor, index_tables, color_luts,
                                  rows: int, row_bytes: int, filter_mode: str = "up",
                                  deflate_mode: str = "rle", packer: Optional[str] = None,
                                  mask: Optional[torch.Tensor] = None):
    """The render chain over the mesh: (B, C, H, W) unsigned planes, B a
    multiple of the width, the per-channel tables replicated to every
    slot and an optional (B, H, W) uint8 ROI mask sharded with its lanes
    -> ((B, cap) uint8 streams, (B,) lengths)."""
    def local(_slot, blk, msk):
        return fused_render_filter_deflate_batch(
            blk, index_tables, color_luts, rows, row_bytes, filter_mode=filter_mode,
            mode=deflate_mode, packer=packer, mask=msk)

    masks = None if mask is None else shard_blocks(mesh, mask)
    return _gather_pairs(mesh, _per_slot(mesh, local, shard_blocks(mesh, planes), masks))


def sharded_filter_histogram(mesh: Mesh, tiles: torch.Tensor, rows: int, row_bytes: int,
                             bpp: int, filter_mode: str = "up"):
    """``dynamic`` pass 1 over the mesh: tiles (B, H, W[, S]) -> ((B, L)
    uint8 filtered payloads, (B, 286) int32 symbol counts, (B,) extra
    bits). Only the counts need to reach the host for the plan."""
    def local(_slot, blk):
        flat, counts, extras, b = fused_filter_histogram_batch(
            blk, rows, row_bytes, bpp, filter_mode=filter_mode)
        return flat[:b], counts[:b], extras[:b]

    parts = _per_slot(mesh, local, shard_blocks(mesh, tiles))
    return tuple(gather(mesh, [p[k] for p in parts]) for k in range(3))


def sharded_dynamic_emit(mesh: Mesh, flat: torch.Tensor, tables: tuple,
                         packer: Optional[str] = None):
    """``dynamic`` pass 2 over the mesh: the (B, L) payloads and the 8
    host-built (B, ...) table arrays (``build_dynamic_tables``) sharded
    together -> ((B, cap) uint8 streams, (B,) lengths)."""
    n = mesh.size
    per = flat.shape[0] // n
    table_blocks = [[np.asarray(t)[i * per:(i + 1) * per] for t in tables] for i in range(n)]

    def local(slot, blk, tabs):
        return dynamic_emit(blk, tables_from_numpy(tabs, slot.device), packer=packer)

    return _gather_pairs(mesh, _per_slot(mesh, local, shard_blocks(mesh, flat), table_blocks))


def sharded_supertile_carve_deflate(mesh: Mesh, sub_stacks: np.ndarray, index_tables,
                                    color_luts, coords, bh: int, bw: int,
                                    filter_mode: str = "up", deflate_mode: str = "rle",
                                    packer: Optional[str] = None):
    """The fused super-tile over the mesh: ``sub_stacks`` (n, C, Hs, Ws)
    host unsigned pixels, each slot's overlapped window of the bounding
    stack (``render/supertile.plan_mesh_partition``), and ``coords`` (n,
    L, 2) window-local (y, x) tile origins. Each slot composites its
    window, carves its L (bh, bw) tiles, filters and deflates them ->
    ((n*L, cap) uint8 streams, (n*L,) lengths), slot-major (the caller
    keeps its real rows)."""
    coords = np.asarray(coords)

    def local(slot, window, origins):
        planes = bits_tensor(np.ascontiguousarray(window)).to(slot.device)
        carved = composite_carve_torch(planes, index_tables, color_luts,
                                       [tuple(c) for c in origins.tolist()], bh, bw)
        return fused_filter_deflate_batch(carved, bh, 1 + bw * 3, 3, filter_mode=filter_mode,
                                          mode=deflate_mode, packer=packer)

    return _gather_pairs(mesh, _per_slot(mesh, local, sub_stacks, coords))
