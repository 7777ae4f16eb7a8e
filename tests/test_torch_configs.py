"""The port's ``configs`` package against the JAX package's, on the CPU:
every architecture's ``FULL`` and ``SMOKE`` field for field (dtypes
compared by name, nested configs recursively), the shapes, the
registry's listing, its runnable cells and its refusal of an unknown
arch."""

import dataclasses

import pytest

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core import precision as tp

ARCHS = jreg.list_archs()


def _fields(cfg) -> dict:
    """A config as plain values: nested configs as dicts, dtypes by name."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = (type(v).__name__, _fields(v))
        elif f.name.endswith("_dtype"):
            v = tp.dtype_name(v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("smoke", [False, True], ids=["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_equals_the_reference(arch, smoke):
    got = treg.get_config(arch, smoke=smoke)
    want = jreg.get_config(arch, smoke=smoke)
    assert type(got).__name__ == type(want).__name__ == "ModelConfig"
    assert _fields(got) == _fields(want)
    assert got.layer_kinds == want.layer_kinds
    assert got.is_encdec == want.is_encdec


def test_shapes_train_config_and_registry_match_the_reference():
    assert treg.list_archs() == jreg.list_archs()
    assert len(ARCHS) == 10
    assert treg.SUBQUADRATIC == jreg.SUBQUADRATIC
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert tbase.SHAPES["decode_32k"].is_decode
    assert _fields(tbase.TrainConfig()) == _fields(jbase.TrainConfig())
    for arch in ARCHS:
        for shape in tbase.SHAPES:
            assert treg.cell_is_runnable(arch, shape) \
                == jreg.cell_is_runnable(arch, shape), (arch, shape)
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("no-such-arch")
    # The port's dtypes are torch's.
    import torch
    cfg = treg.get_config("gemma2-2b")
    assert (cfg.param_dtype, cfg.compute_dtype) == (torch.float32,
                                                    torch.bfloat16)
