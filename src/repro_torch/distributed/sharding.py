"""Logical-axis sharding, the one-device part — the counterpart of
``repro.distributed.sharding`` that the model layers need.

Model code annotates parameters and activations with logical axes
("batch", "embed", "mlp", ...).  A context carries (mesh, rules); with no
mesh every constraint is the identity, which is all a single card needs.
Placing tensors on a mesh is ROADMAP item 14: until then a mesh that is
not None is refused, never accepted and ignored.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

# Logical axis -> preference-ordered candidate mesh axes (the reference's
# table, copied).
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    "seq_sp": ("data",),
    "seq_mp": ("model",),
    # params
    "vocab": ("model",),
    "embed": ("data",),
    "embed_no_fsdp": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("data",),
    "expert_mlp": ("model",),
    "experts_2d": ("data", "model"),
    "q_lora": ("model",),
    "kv_lora": (),
    "lru": ("model",),
    "layers": (),
    "conv": (),
    "stats": (),
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, tuple[str, ...]] = dict(DEFAULT_RULES)


_CTX = _Ctx()


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "repro_torch runs on one card: sharding over a mesh is "
            "ROADMAP item 14 (distributed); pass mesh=None")


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[dict] = None):
    """Install (mesh, rules) for model code executed inside.  Only
    ``mesh=None`` is served."""
    _refuse_mesh(mesh)
    old_mesh, old_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES if rules is None else rules)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old_mesh, old_rules


def current_mesh():
    """The installed mesh: always None on one card."""
    return _CTX.mesh


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """A sharding constraint by logical axes: the identity without a
    mesh."""
    _refuse_mesh(_CTX.mesh)
    return x
