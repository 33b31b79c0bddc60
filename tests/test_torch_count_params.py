"""``count_params`` (dahitra_tpu_torch/cli/count_params.py) against the JAX
package's ``count()`` for every ported key, on the CPU.

The port builds each model on the ``meta`` device and counts its
parameters; the JAX count is its ``jax.eval_shape`` of the flax init (for
the single-image ResNet34 UNets, which its pair call refuses, the same
``eval_shape`` on one image; ROADMAP.md section 3, fault 7).
"""
import jax
import jax.numpy as jnp
import pytest

from dahitra_tpu.cli.count_params import count as jax_count
from dahitra_tpu.models.registry import define_g as jax_define_g
from dahitra_tpu_torch.cli import count_params
from dahitra_tpu_torch.models.registry import PORTED

IMG = 64


def _jax_params(key):
    try:
        return jax_count(key, IMG)
    except TypeError:  # the single-image models: one image, as they take
        x = jnp.zeros((1, IMG, IMG, 3))
        variables = jax.eval_shape(lambda: jax_define_g(
            key, img_size=IMG).init(jax.random.PRNGKey(0), x))
        return sum(p.size for p in jax.tree.leaves(variables["params"]))


@pytest.mark.parametrize("key", PORTED)
def test_count_params_matches_jax(key):
    """Every ported key at 64 px: the port's trainable parameters, counted
    on the meta device, equal the JAX count."""
    assert count_params.count(key, IMG) == _jax_params(key)


def test_count_params_cli_prints_counts(capsys):
    counts = count_params.main(["changeFormerV6", "siamUnet_conc",
                                "no_such_key"])
    assert set(counts) == {"changeFormerV6", "siamUnet_conc"}
    out = capsys.readouterr().out
    assert "changeFormerV6: 41,026,674 trainable parameters" in out
    assert "no_such_key: failed" in out
