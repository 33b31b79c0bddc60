"""``dual_hrnet``'s train step against the JAX package, on the CPU: the
check of ``tests/test_torch_xbd_zoo_grads.py`` (whose docstring gives the
weights, inputs and bounds) on Dual-HRNet's dict of ``loc`` and ``cls``
heads under ``dual_hrnet_loss``, and its train-mode BatchNorm statistics,
whose flax momentum is 0.99. The loc head's parameters take no gradient in
the port (the loss reads its argmax); JAX's are zero there. Its bf16
forward is in ``tests/test_torch_xbd_zoo_grads_dpn.py``: this file's time
is mostly the JAX step's compile, which no split shortens.
"""
import pytest
import torch

from dahitra_tpu_torch.nn.blocks import BatchNorm
from test_torch_xbd_zoo_grads import case, check_train_step, port_model

KEY = "dual_hrnet"


@pytest.fixture(autouse=True)
def few_threads():
    """torch on at most 4 CPU threads (the suite runs six workers on eight
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_train_step_grads_and_statistics_match_jax():
    """Every BatchNorm of the port's Dual-HRNet at flax momentum 0.99; loss
    1e-5; gradients max(1e-3, the median of JAX's own moves under four 1e-6
    input moves) of the whole gradient's scale (rule 5); the train-mode
    running statistics of every BatchNorm max(1e-4, the median of JAX's own
    moves)."""
    _, _, params, stats = case(KEY)
    bns = [m for m in port_model(KEY, params, stats).modules()
           if isinstance(m, BatchNorm)]
    assert bns and all(m.momentum == 0.99 for m in bns)
    check_train_step(KEY)
