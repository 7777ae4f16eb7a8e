"""The port's checkpoints (``repro_torch.checkpoint.manager``) and the
reference's (``repro.checkpoint.manager``): one on-disk layout,
``step_<N>/manifest.json`` + ``arrays.npz`` and the atomic ``LATEST``
pointer, with the same leaf keys (a dataclass field as ``.<name>``, as
JAX's ``GetAttrKey`` prints it).

Covered: the round trip (bit for bit, f32 / bf16 / int leaves, nested
dicts and lists, a ``TrainState``), the atomic pointer and ``cleanup``,
the async saver (its snapshot taken at the call, its errors raised at
``wait``), ``restore`` onto the template's dtype and device and in
place, and trees written by one package and read by the other:

  * f32 and int32 trees both ways, bit for bit;
  * bf16 trees written by the reference read by the port, bit for bit
    (the words ``ml_dtypes`` writes, numpy ``V2``, and the manifest's
    ``bfloat16``), and the port's bf16 files hold the same bytes and
    manifest as the reference's.  The other direction is not tested:
    the reference cannot restore a bf16 leaf at all, its own files
    included (numpy has no cast from ``V2`` to ``ml_dtypes.bfloat16``:
    "No cast function available"), which the last test records.

Tolerance: none (bits).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.launch import train as JT
from repro.optim import adamw as JA
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core.integration import _leaves
from repro_torch.launch import train as TT
from repro_torch.models.param import ShapeDtype
from repro_torch.optim import adamw


def _tree():
    rng = np.random.default_rng(0)
    return {"a": torch.from_numpy(rng.normal(size=(3, 4))
                                  .astype(np.float32)),
            "b": {"c": torch.tensor(7, dtype=torch.int32),
                  "h": torch.from_numpy(rng.normal(size=(5,))
                                        .astype(np.float32))
                  .to(torch.bfloat16)},
            "l": [torch.arange(6, dtype=torch.int64), torch.ones(2)]}


def _zeros_like(tree):
    """A template of ``tree``'s structure, dtypes and devices, all zeros
    (``restore`` writes a tensor template in place)."""
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _same(a, b):
    assert isinstance(b, torch.Tensor) and a.dtype == b.dtype \
        and a.shape == b.shape and torch.equal(a, b), (a, b)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 5, tree)
    assert path.endswith("step_00000005")
    assert ckpt.latest_step(str(tmp_path)) == 5
    got, step = ckpt.restore(str(tmp_path), _zeros_like(tree))
    assert step == 5
    for a, b in zip(_leaves(tree), _leaves(got)):
        _same(a, b)
    assert got["b"]["c"].ndim == 0 and int(got["b"]["c"]) == 7
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 5 and man["leaves"]["b/h"] == {
        "shape": [5], "dtype": "bfloat16"}
    assert sorted(man["leaves"]) == ["a", "b/c", "b/h", "l/0", "l/1"]


def test_restore_takes_the_template_dtype_and_device(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 1, tree)
    template = {"a": ShapeDtype((3, 4), torch.float64),
                "b": {"c": torch.zeros((), dtype=torch.int64,
                                       device="meta"),
                      "h": torch.zeros(5, dtype=torch.float32)},
                "l": [torch.zeros(6, dtype=torch.int64),
                      torch.zeros(2)]}
    got, _ = ckpt.restore(str(tmp_path), template)
    assert got["a"].dtype == torch.float64 and got["a"].device.type == "cpu"
    assert torch.equal(got["a"], tree["a"].double())
    assert got["b"]["c"].dtype == torch.int64
    assert torch.equal(got["b"]["h"], tree["b"]["h"].float())
    # a tensor template is written in place and returned
    keep = template["b"]["h"]
    assert got["b"]["h"] is keep and got["l"][1] is template["l"][1]
    assert torch.equal(template["l"][0], tree["l"][0])


def test_checkpoint_atomic_pointer(tmp_path):
    tree = {"x": torch.ones(2)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, tree)
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    ckpt.cleanup(str(tmp_path), keep=1)
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert not os.path.isdir(os.path.join(str(tmp_path), "step_00000001"))
    # a pointer to a missing directory is no checkpoint
    with open(os.path.join(tmp_path, "LATEST"), "w") as f:
        f.write("step_00000009")
    assert ckpt.latest_step(str(tmp_path)) is None
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)
    ckpt.cleanup(str(tmp_path / "none"))


def test_async_saver(tmp_path):
    saver = ckpt.AsyncSaver()
    x = torch.ones(4)
    saver.save_async(str(tmp_path), 3, {"x": x})
    x.add_(1.0)                         # after the call: not in the file
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    got, _ = ckpt.restore(str(tmp_path), {"x": torch.zeros(4)})
    assert torch.equal(got["x"], torch.ones(4))
    # a failed write surfaces at the next wait
    blocker = tmp_path / "file"
    blocker.write_text("")
    saver.save_async(str(blocker), 4, {"x": x})
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                        # the error was raised once


def _train_states():
    """A port TrainState and a reference one with the same values."""
    rng = np.random.default_rng(1)
    params = {"embed": {"table": rng.normal(size=(6, 4)).astype(np.float32)},
              "stacks": {"S0": [rng.normal(size=(2, 3)).astype(np.float32)]}}
    # copies: jnp.asarray may share the numpy buffers
    tp = {"embed": {"table": torch.tensor(params["embed"]["table"])},
          "stacks": {"S0": [torch.tensor(params["stacks"]["S0"][0])]}}
    t = TT.TrainState(tp, adamw.init(tp), torch.tensor(3, dtype=torch.int32))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    j = JT.TrainState(jp, JA.init(jp), jnp.asarray(3, jnp.int32))
    return t, j


def test_train_state_keys_match_the_reference(tmp_path):
    t, j = _train_states()
    ckpt.save(str(tmp_path / "t"), 3, t)
    jckpt.save(str(tmp_path / "j"), 3, j)
    man = [json.load(open(os.path.join(tmp_path, w, "step_00000003",
                                       "manifest.json")))
           for w in ("t", "j")]
    assert man[0] == man[1]
    assert ".params/embed/table" in man[0]["leaves"]
    assert ".opt/.count" in man[0]["leaves"] and ".step" in man[0]["leaves"]


def test_f32_trees_cross_between_the_packages(tmp_path):
    t, j = _train_states()
    for leaf in _leaves(t.params):
        leaf.mul_(-1.5)
    j = JT.TrainState(jax.tree_util.tree_map(
        lambda a: a * -1.5, j.params), j.opt, j.step)
    # the reference reads the port's file
    ckpt.save(str(tmp_path / "t"), 3, t)
    template = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), j)
    got, step = jckpt.restore(str(tmp_path / "t"), template)
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    ckpt._flatten(t)):
        np.testing.assert_array_equal(np.asarray(a), b[1].numpy())
    # the port reads the reference's file
    jckpt.save(str(tmp_path / "j"), 3, j)
    fresh, _ = _train_states()
    back, step = ckpt.restore(str(tmp_path / "j"), fresh)
    assert step == 3
    for (ka, a), (kb, b) in zip(ckpt._flatten(back), ckpt._flatten(t)):
        assert ka == kb
        _same(b, a)


def test_the_port_reads_reference_bf16_bit_for_bit(tmp_path):
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(4, 9)).astype(np.float32)
    vals[0, :4] = [0.0, -0.0, 3.0e38, 1e-40]       # zeros, large, subnormal
    jtree = {"w": jnp.asarray(vals, jnp.bfloat16),
             "m": [jnp.asarray(vals[1], jnp.bfloat16)]}
    jckpt.save(str(tmp_path / "j"), 7, jtree)
    template = {"w": torch.zeros(4, 9, dtype=torch.bfloat16),
                "m": [torch.zeros(9, dtype=torch.bfloat16)]}
    got, step = ckpt.restore(str(tmp_path / "j"), template)
    assert step == 7
    for a, b in ((got["w"], jtree["w"]), (got["m"][0], jtree["m"][0])):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            a.view(torch.int16).numpy(),
            np.asarray(b).view(np.int16))
    # the port's own bf16 file: the same bytes and manifest
    ckpt.save(str(tmp_path / "t"), 7, got)
    for name in ("manifest.json",):
        assert json.load(open(tmp_path / "t" / "step_00000007" / name)) \
            == json.load(open(tmp_path / "j" / "step_00000007" / name))
    zt = np.load(tmp_path / "t" / "step_00000007" / "arrays.npz")
    zj = np.load(tmp_path / "j" / "step_00000007" / "arrays.npz")
    for key in zj.files:
        assert zt[key].dtype == zj[key].dtype
        assert zt[key].tobytes() == zj[key].tobytes()
    # and round trips its own bits, onto an f32 template too
    back, _ = ckpt.restore(str(tmp_path / "t"), _zeros_like(template))
    assert torch.equal(back["w"].view(torch.int16),
                       got["w"].view(torch.int16))
    wide, _ = ckpt.restore(str(tmp_path / "t"),
                           {"w": torch.zeros(4, 9), "m": [torch.zeros(9)]})
    assert torch.equal(wide["w"], got["w"].float())


def test_the_reference_cannot_restore_bf16():
    """Why no test has the reference read a bf16 file: it cannot read its
    own."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        tree = {"w": jnp.ones((2,), jnp.bfloat16)}
        jckpt.save(d, 1, tree)
        template = {"w": jax.ShapeDtypeStruct((2,), jnp.bfloat16)}
        with pytest.raises(ValueError, match="No cast function"):
            jckpt.restore(d, template)
