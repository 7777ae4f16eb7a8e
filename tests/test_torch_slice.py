"""The port's main path as a whole: the framework hooks of
``repro_torch.core.integration`` against the JAX package's on shared
numpy inputs, the package's import boundary, and ``chip_smoke.py``'s
refusal to run without a card.

Tolerances are the registry sweep's (``tests/test_dispatch.py``): f32
inputs 1e-4 relative and 1e-4 * sqrt(n) absolute, bf16 inputs 2e-2.
"""

import ast
import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import integration as ji
from repro.core import precision as jp
from repro_torch import kernels as tk
from repro_torch.core import autotune as tat
from repro_torch.core import integration as ti

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.dirname(repro_torch.__file__)
SMOKE = os.path.join(ROOT, "chip_smoke.py")
METHODS = ("auto", "mma", "mma_chained", "pallas", "vpu")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import check_error_budget as gates  # noqa: E402


@pytest.fixture()
def fresh_registries(fresh_plan_registry):
    tat.reset_default_registry()
    yield
    tat.reset_default_registry()


def _pair(x: np.ndarray, dtype: str = "float32"):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return (jnp.asarray(x).astype(jdt),
            torch.from_numpy(x.copy()).to(getattr(torch, dtype)))


def _close(got, want, dtype: str, n: int):
    rtol, atol = (2e-2, 2e-2) if dtype == "bfloat16" else (1e-4, 1e-4)
    got = got.to(torch.float64).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    np.testing.assert_allclose(got, np.asarray(want, np.float64),
                               rtol=rtol, atol=atol * np.sqrt(n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", METHODS)
def test_full_reductions_match_the_reference(method, dtype,
                                             fresh_registries):
    x = np.random.default_rng(1).normal(size=(5, 7, 131)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    for hook in ("reduce_sum", "squared_sum", "reduce_mean"):
        got = getattr(ti, hook)(tx, method=method)
        assert got.dtype == torch.float32 and got.dim() == 0
        _close(got, getattr(ji, hook)(jx, method=method), dtype, x.size)
    kept = ti.reduce_sum(tx, keepdims=True, method=method)
    assert tuple(kept.shape) == (1, 1, 1)


@pytest.mark.parametrize("axis", [-1, 0, (0, 2), (1,), ()])
@pytest.mark.parametrize("keepdims", [False, True])
def test_axis_reductions_match_the_reference(axis, keepdims):
    x = np.random.default_rng(2).normal(size=(4, 6, 33)).astype(np.float32)
    jx, tx = _pair(x)
    for method in ("mma", "vpu", "auto"):
        for hook in ("reduce_sum", "squared_sum", "reduce_mean"):
            got = getattr(ti, hook)(tx, axis=axis, keepdims=keepdims,
                                    method=method)
            want = getattr(ji, hook)(jx, axis=axis, keepdims=keepdims,
                                     method=method)
            assert tuple(got.shape) == tuple(want.shape)
            _close(got, want, "float32", x.size)
    with pytest.raises(ValueError, match="out of bounds"):
        ti.reduce_sum(tx, axis=3)
    with pytest.raises(ValueError, match="duplicate"):
        ti.reduce_sum(tx, axis=(1, -2))


@pytest.mark.parametrize("method", METHODS)
def test_masked_mean_global_norm_and_counts_match_the_reference(
        method, fresh_registries):
    rng = np.random.default_rng(3)
    v = rng.normal(size=999).astype(np.float32)
    mask = (rng.random(999) > 0.3).astype(np.float32)
    _close(ti.masked_mean(torch.from_numpy(v), mask, method=method),
           ji.masked_mean(jnp.asarray(v), jnp.asarray(mask), method=method),
           "float32", v.size)
    assert float(ti.masked_mean(torch.ones(4), torch.zeros(4),
                                method=method)) == 0.0
    tree = {"w": rng.normal(size=(16, 8)).astype(np.float32),
            "b": [rng.normal(size=8).astype(np.float32),
                  (rng.normal(size=3).astype(np.float32),)]}
    ttree = {"w": torch.from_numpy(tree["w"]),
             "b": [torch.from_numpy(tree["b"][0]),
                   (torch.from_numpy(tree["b"][1][0]),)]}
    jtree = {"w": jnp.asarray(tree["w"]),
             "b": [jnp.asarray(tree["b"][0]),
                   (jnp.asarray(tree["b"][1][0]),)]}
    _close(ti.global_norm(ttree, method=method),
           ji.global_norm(jtree, method=method), "float32", 147)
    onehot = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 300)]
    if method in ("mma", "vpu", "auto"):
        got = ti.expert_counts(torch.from_numpy(onehot), method=method)
        want = ji.expert_counts(jnp.asarray(onehot), method=method)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        with pytest.raises(ValueError, match="unknown"):
            ti.expert_counts(torch.from_numpy(onehot), method=method)


@pytest.mark.parametrize("seed", gates.SEEDS)
def test_every_hook_holds_the_reference_ceilings(seed, fresh_registries):
    """The slice end to end at the gate's probe: uniform [0, 1] f32
    through the public hooks, against the fp64 oracle of the cast
    input, under each engine's ceiling (``auto`` under the loosest)."""
    x32 = jp.uniform_input(gates.PROBE_N, seed=seed).astype(np.float32)
    ceilings = {label: c for label, op, _, c in gates.GATES
                if op == "reduce_sum"}
    ceilings["auto"] = max(ceilings[m] for m in METHODS[1:])
    for method in METHODS:
        for hook in ("reduce_sum", "squared_sum"):
            got = getattr(ti, hook)(torch.from_numpy(x32), method=method)
            err = jp.percent_error(float(got), gates.oracle_for(x32, hook))
            assert err <= ceilings[method], (hook, method, err)
    for variant in ("single_pass", "recurrence", "split"):
        got = tk.mma_reduce(torch.from_numpy(x32), variant=variant)
        err = jp.percent_error(float(got),
                               gates.oracle_for(x32, "reduce_sum"))
        assert err <= ceilings["pallas"], (variant, err)


def test_smoke_script_ceilings_are_the_reference_gates():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = {label: c for label, op, _, c in gates.GATES
            if op == "reduce_sum" and label in smoke.CEILINGS}
    assert smoke.CEILINGS == want
    tier = {c for label, _, plan, c in gates.GATES
            if plan.method in ("mma_ec", "pallas_ec", "mma_dd",
                               "pallas_dd")}
    assert tier == {smoke.EC_CEILING, smoke.DD_CEILING}
    for label, _, plan, c in gates.GATES:
        if "_ec" in plan.method:
            assert c == smoke.EC_CEILING, label
        if "_dd" in plan.method:
            assert c == smoke.DD_CEILING, label
    assert smoke.N_MAIN == 1 << 28


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_the_port_imports_neither_jax_nor_the_reference():
    files = [SMOKE]
    for dirpath, _, filenames in os.walk(PORT):
        files += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), \
                (path, name)


def test_the_package_exports_this_slice():
    from repro_torch import core
    # Functions only: importing the package also binds its kernel
    # modules (mma_compensated) as attributes.
    assert {n for n in dir(tk) if n.startswith("mma")
            and callable(getattr(tk, n))} \
        == {"mma_reduce", "mma_reduce_partials", "mma_squared_sum",
            "mma_ec_reduce", "mma_ec_squared_sum", "mma_dd_reduce",
            "mma_dd_squared_sum", "mma_scan", "mma_segment_sum",
            "mma_rmsnorm", "mma_norm_matmul"}
    for name in ("tc_reduce", "tc_contract", "tc_reduce_axes",
                 "tc_reduce_lastdim", "tc_reduce_rows", "tc_reduce_ec",
                 "tc_reduce_dd", "tc_scan", "tc_scan_ec", "tc_cumprod",
                 "reduce_sum", "reduce_mean", "squared_sum", "masked_mean",
                 "global_norm", "expert_counts", "cumsum", "masked_cumsum",
                 "MmaPolicy", "ACCUM_DTYPE", "dispatch", "theory",
                 "precision"):
        assert hasattr(core, name), name
    # The segmented half of the scan family, ported with kernel B7.
    for name in ("tc_segment_reduce", "tc_linear_recurrence",
                 "segment_sum"):
        assert callable(getattr(core, name)), name


def test_smoke_script_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run([sys.executable, SMOKE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert got.returncode != 0 and got.stdout == ""
    assert "no CUDA device" in got.stderr


def test_smoke_script_refuses_without_the_repository(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(SMOKE).read())
    # Pretend a card is present: the script must still find no port.
    sitecustom = tmp_path / "sitecustomize.py"
    sitecustom.write_text("import torch\n"
                          "torch.cuda.is_available = lambda: True\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    got = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert got.returncode != 0 and got.stdout == ""
    assert "repro_torch not found" in got.stderr
