"""Tile meshes and scene replicas (port of ``rfw_tpu.parallel.mesh``).

Image tiles go to devices, and the scene is copied to each (it is MBs,
not GBs). A mesh is a tuple of ``torch.device``, one a tile, in tile
order. One host process drives every tile, as one JAX controller drives
rfw_tpu's shard_map; ``replicate`` stands in for the replicated
sharding and ``row_block`` for the row-sharded one.
"""

from __future__ import annotations

import torch

from ..render.context import resolve_device
from ..utils import logger, tracing


def make_tile_mesh(n_devices: int | None = None, device="cuda") -> tuple:
    """``n_devices`` tiles (every card when None) on the cards: tile i on
    ``cuda:i``. With more tiles than cards the tiles go round-robin
    (``cuda:{i % count}``) and one warning names the cards; rfw_tpu's
    mesh would hold fewer tiles. Raises without a card. For ``"cpu"``,
    ``n_devices`` tiles (one when None) on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (dev,) * (n_devices or 1)
    if dev.type != "cuda":
        raise ValueError(f"no tile mesh on {dev}")
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        names = ", ".join(f"cuda:{i} ({torch.cuda.get_device_name(i)})"
                          for i in range(count))
        logger.warning("%d tiles on %d card(s) %s: placed round-robin", n,
                       count, names)
    return tuple(torch.device("cuda", i % count) for i in range(n))


def row_block(n_total: int, n_tiles: int) -> int:
    """The pixels of each tile's contiguous row block; ValueError when
    ``n_tiles`` does not divide ``n_total``."""
    if n_tiles < 1 or n_total % n_tiles:
        raise ValueError(f"pixel count {n_total} must divide by "
                         f"{n_tiles} tiles")
    return n_total // n_tiles


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tree_bytes(tree) -> int:
    """The bytes of ``tree``'s tensors, from their shapes (no device
    read)."""
    return sum(t.nbytes for t in _tensors(tree))


def moved_bytes(tree, device) -> int:
    """The bytes a copy of ``tree`` to ``device`` moves: those of its
    tensors not already there, from their shapes."""
    device = torch.device(device)
    return sum(t.nbytes for t in _tensors(tree) if t.device != device)


def replicate(tree, device, cache: dict | None = None):
    """``tree`` (nested dicts, lists and tuples of tensors) with every
    tensor on ``device``; tensors already there are not copied. With
    ``cache``, a dict its owner clears when the tree changes, the copy
    is made once per device and kept while ``tree`` is the same object;
    a miss is the span ``tiles.replicate`` and adds the bytes it copies
    to the counter ``tiles.replica_bytes``."""
    device = torch.device(device)
    if cache is None:
        return _to(tree, device)
    ent = cache.get(device)
    if ent is None or ent[0] is not tree:
        with tracing.span("tiles.replicate"):
            tracing.count("tiles.replica_bytes", moved_bytes(tree, device))
            ent = (tree, _to(tree, device))
        cache[device] = ent
    return ent[1]
