"""Single-source-of-truth parameter declaration — the counterpart of
``repro.models.param``.

Modules declare nested dicts of ``Param(shape, axes, init)`` descriptors;
``init_tree`` materialises tensors from an explicit ``torch.Generator``
on an explicit device, ``axes_tree`` yields the parallel logical-axes
tree read by ``distributed.sharding``, and ``stack_specs`` prepends a
"layers" axis for stacked layers.  The generator gives other numbers
than ``jax.random`` for the same seed, so tests initialise with the JAX
package and carry the tensors across with ``from_numpy``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.integration import _leaves


@dataclasses.dataclass(frozen=True)
class Param:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "fan_in"      # fan_in | zeros | ones | normal | embed
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_param(x) -> bool:
    return isinstance(x, Param)


def _map(fn, tree):
    """Apply ``fn`` to every leaf of nested dicts / lists / tuples,
    keeping the structure (dict keys in sorted order, as pytrees)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def _normal(p: Param, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randn(p.shape, generator=gen, dtype=torch.float32,
                       device=device)


def _materialise(p: Param, gen: torch.Generator, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    if p.init in ("normal", "embed"):
        return (p.scale * _normal(p, gen, device)).to(p.dtype)
    if p.init == "fan_in":
        fan_in = p.shape[0] if len(p.shape) == 1 else math.prod(p.shape[:-1])
        std = p.scale / math.sqrt(max(fan_in, 1))
        return (std * _normal(p, gen, device)).to(p.dtype)
    raise ValueError(p.init)


def init_tree(gen: torch.Generator, specs, *, device=None):
    """Nested dict of Param -> nested dict of tensors on ``device``
    (default: the generator's device), drawn from ``gen`` leaf by leaf
    in sorted-key order."""
    device = gen.device if device is None else torch.device(device)
    return _map(lambda p: _materialise(p, gen, device), specs)


def axes_tree(specs):
    return _map(lambda p: p.axes, specs)


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype (``jax.ShapeDtypeStruct``'s role)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def shapes_tree(specs):
    """Nested dict of ShapeDtype: what ``init_tree`` would make, without
    making it."""
    return _map(lambda p: ShapeDtype(tuple(p.shape), p.dtype), specs)


def stack_specs(specs, n: int):
    """Prepend a 'layers' axis of size n to every Param."""
    return _map(lambda p: Param((n,) + p.shape, ("layers",) + p.axes,
                                p.init, p.scale, p.dtype), specs)


def init_stacked(gen: torch.Generator, specs, n: int, *, device=None):
    """n independent copies of ``init_tree(specs)`` stacked on a leading
    'layers' dim (one draw per copy, in order)."""
    copies = [init_tree(gen, specs, device=device) for _ in range(n)]
    return _map_many(lambda *ts: torch.stack(ts), copies)


def _map_many(fn, trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_many(fn, [t[k] for t in trees]) for k in sorted(first)}
    if isinstance(first, (list, tuple)):
        return type(first)(_map_many(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    return fn(*trees)


def count_params(tree) -> int:
    """Elements over every leaf with a shape (tensors, arrays)."""
    return sum(int(math.prod(leaf.shape)) for leaf in _leaves(tree))


def from_numpy(tree, *, device=None, dtype: Optional[torch.dtype] = None):
    """The weight bridge: nested dicts / lists of numpy arrays (another
    package's parameters after ``np.asarray`` on each leaf) -> the same
    structure of tensors on ``device`` (default: the card when present),
    cast to ``dtype`` when given."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":     # ml_dtypes: numpy has no bf16
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(device=device, dtype=dtype)
    return _map(one, tree)
