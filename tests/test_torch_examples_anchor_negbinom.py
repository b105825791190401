"""The port's NegBinom example against the JAX package's on the CPU, at two
data seeds and cut sweeps: the mean over the chains of one model of each
package, within four standard errors from the JAX chains' spread on the
same data and counts (tests/test_torch_examples_anchor.py says more)."""
import pytest

from tests import examples_jax
from tests.test_torch_constrained import torch_one_thread  # noqa: F401

SEEDS = tuple(examples_jax.anchors_data()["cpu_test"]["seeds"])


@pytest.mark.parametrize("seed", SEEDS)
def test_example_agrees_with_the_jax_package(seed):
    for g in examples_jax.agree("negbinom", seed):
        assert g["ok"], g
