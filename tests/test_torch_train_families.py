"""The port's training loss and gradients against the JAX package's for
the MoE (qwen3-moe, dbrx: the load-balance aux summed over layers), RG-LRU
(recurrentgemma), RWKV6 and encoder-decoder (whisper, on frames) smoke
configs, in float32 (``torch_parity.loss_grad_parity``: the loss to rtol
1e-5, each gradient leaf within 1e-4 * its own max |g| of JAX's).  The
attention-only configs are in ``test_torch_train.py``.
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import torch

import torch_parity


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", torch_parity.FAMILY_ARCHS)
def test_loss_and_grads_match_jax_float32(arch):
    torch_parity.loss_grad_parity(arch)
