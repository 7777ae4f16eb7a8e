"""Gradients of the port's ``Model.loss`` against ``jax.grad`` of the
reference's at the configs' own defaults (bf16 activations, f32
parameters), on the CPU, at SMOKE size, for the six attention archs
(the MoE and recurrent four are in
``tests/test_torch_grads_bf16_mixers.py``, which shares these bounds): the reference's
parameters carried across (``models.param.from_numpy``), one numpy batch
of 2 x 16 from a seed (``tests/test_torch_grads.py`` holds them in f32).

Tolerance: both packages round activations to bf16, in another order
in places (bf16 products, softmax, norms), so the gradients agree only
to bf16's few bits: the loss within 1e-3 relative, each leaf's
‖g_port - g_ref‖ <= 0.25 ‖g_ref‖ (the worst measured, 0.164, is Llama
3.2 Vision's cross-attention gate) and the whole tree's within 0.1 of
its norm (the worst measured 0.077, RWKV-6's).
"""

import numpy as np
import pytest

from test_torch_grads import leaf_gaps, port_grads, reference

ARCHS = ("gemma3-27b", "gemma2-2b", "glm4-9b", "mistral-large-123b",
         "llama-3.2-vision-90b", "seamless-m4t-large-v2")

LOSS_RTOL = 1e-3
LEAF_RTOL = 0.25
TREE_RTOL = 0.1


def check_default_dtype_gradients(arch):
    _, _, want_loss, want = reference(arch, False)
    loss, got = port_grads(arch, False)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert max(leaf_gaps(got, want)) <= LEAF_RTOL, arch
    tree = np.sqrt(sum(np.sum((a - b) ** 2) for a, b in zip(got, want)))
    norm = np.sqrt(sum(np.sum(b ** 2) for b in want))
    assert tree <= TREE_RTOL * norm, (arch, tree / norm)


@pytest.mark.parametrize("arch", ARCHS)
def test_default_dtype_gradients_match_jax_grad(arch):
    check_default_dtype_gradients(arch)
