"""Gradients of the port's ``Model.loss`` against ``jax.grad`` of the
reference's at the configs' own defaults (bf16 activations, f32
parameters), on the CPU, at SMOKE size, for the MoE archs (DeepSeek-V3:
MLA, MoE and MTP; Arctic) and the recurrent ones (RWKV-6, RecurrentGemma),
under the bounds ``tests/test_torch_grads_bf16.py`` states: the loss
within 1e-3 relative, each leaf within 0.25 of its norm, the whole tree
within 0.1.
"""

import pytest

from test_torch_grads_bf16 import check_default_dtype_gradients

ARCHS = ("deepseek-v3-671b", "arctic-480b", "rwkv6-7b", "recurrentgemma-2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_default_dtype_gradients_match_jax_grad(arch):
    check_default_dtype_gradients(arch)
