"""``xbd_dpn92_loc`` against the JAX package in training and in bf16, and
``dual_hrnet``'s bf16 forward, on the CPU: the checks of
``tests/test_torch_xbd_zoo_grads.py`` (whose docstring gives the weights,
inputs and bounds), in a file of their own so that each file stays near a
minute alone (Dual-HRNet's train step is in
``tests/test_torch_xbd_zoo_grads_hrnet.py``).
"""
import pytest
import torch

from test_torch_xbd_zoo_grads import check_bf16_forward, check_train_step

KEY = "xbd_dpn92_loc"


@pytest.fixture(autouse=True)
def few_threads():
    """torch on at most 4 CPU threads (the suite runs six workers on eight
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_train_step_grads_match_jax():
    """Loss 1e-5; gradients max(1e-3, the median of JAX's own moves under
    four 1e-6 input moves) of the whole gradient's scale (rule 5); BN
    statistics max(1e-4, the median of JAX's own moves)."""
    check_train_step(KEY)


def test_bf16_forward_matches_jax():
    """Within 1.25 times JAX's own bf16-to-fp32 distance of both JAX
    logits, at least half of it from the port's fp32 logits."""
    check_bf16_forward(KEY)


def test_dual_hrnet_bf16_forward_matches_jax():
    """Both heads within 1.25 times JAX's own bf16-to-fp32 distance of both
    JAX outputs, at least half of it from the port's fp32 ones (the JAX
    forwards un-jitted: jitted, each compiles for 20 s)."""
    check_bf16_forward("dual_hrnet", jit=False)
