"""The port's Gaussian example (functionalmf_tpu_torch/examples/) against
the JAX package's (examples/) on the CPU, at two data seeds and cut
sweeps: the mean over the chains of one model of each package that left
the mode that reads the signal as noise, within four standard errors
from the JAX chains' spread on the same data and counts
(functionalmf_tpu_torch/examples/anchors.py, tests/examples_jax.py,
tests/examples_anchors.json); and each example's data, drawn by the
port, equal to the JAX example's. The Binomial and NegBinom have files of
their own, so that xdist spreads them."""
import numpy as np
import pytest

from functionalmf_tpu_torch.examples import anchors
from tests import examples_jax
from tests.test_torch_constrained import torch_one_thread  # noqa: F401

SEEDS = tuple(examples_jax.anchors_data()["cpu_test"]["seeds"])


@pytest.mark.parametrize("example", anchors.EXAMPLES)
@pytest.mark.parametrize("seed", SEEDS)
def test_example_data_matches_the_jax_example(example, seed):
    port, port_truth = anchors.example_module(example).make_data(
        np.random.default_rng(seed))
    jax, jax_truth = examples_jax.make_data(example, seed)
    pairs = zip(port, jax) if isinstance(port, tuple) else [(port, jax)]
    for a, b in pairs:
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_truth, jax_truth)


@pytest.mark.parametrize("seed", SEEDS)
def test_example_agrees_with_the_jax_package(seed):
    for g in examples_jax.agree("gaussian", seed):
        assert g["ok"], g
