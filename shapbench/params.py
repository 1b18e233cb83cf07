"""The weights of a cell, made on the device from the run seed: one
``torch.randn`` into one buffer from a ``torch.Generator`` on the device,
each leaf a view of it scaled to its (std, mean). The tree is the port's
params layout, given by the family's ``param_specs``; the same tree goes
to the port and to the reference."""

from __future__ import annotations

from typing import Any, Dict

import torch

from shapbench.traffic.prng import seed64

ALIGN = 64  # floats: every leaf starts on a 256-byte boundary


def make_params(specs, seed: int, device) -> Dict[str, Any]:
    """A float32 params tree from ``specs`` ((path, shape, std, mean)
    tuples) drawn from (seed, 7)."""
    sizes = [_numel(shape) for _, shape, _, _ in specs]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(seed64(seed, 7))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    tree: Dict[str, Any] = {}
    for (path, shape, std, mean), off, n in zip(specs, offsets, sizes):
        leaf = flat[off:off + n].view(shape)
        leaf.mul_(std).add_(mean)
        _put(tree, path, leaf)
    return _lists(tree)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _put(tree, path, leaf):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = leaf


def _lists(node):
    """Dicts keyed 0..n-1 become lists (the encoder's layers)."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out

