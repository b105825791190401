"""The Poisson example's Poisson BTF arm of the port against the JAX
package's on the CPU, at two data seeds and cut sweeps: the mean of each
gated metric (RMSE against the true rate, 90% coverage of it) over the
chains of one port model, within four standard errors from the JAX chains'
spread on the same data and counts (anchors.compare). The JAX chains' centre
and spread are the record in tests/examples_anchors.json
(tests/examples_jax.py remakes it); what both packages draw before the
chain, the data and the NMF warm start, is held equal live."""
import numpy as np
import pytest

from functionalmf_tpu_torch.examples import anchors
from tests import examples_jax
from tests.test_torch_constrained import torch_one_thread  # noqa: F401

SEEDS = tuple(examples_jax.anchors_data()["cpu_test"]["seeds"])


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_arm_data_and_warm_start_match_the_jax_example(seed):
    port, port_Y, port_truth = anchors.setup("poisson", seed, seed, 2, "cpu")
    jax, jax_Y, jax_truth = examples_jax.setup("poisson", seed, seed, 2)
    np.testing.assert_array_equal(port_Y, jax_Y)
    np.testing.assert_array_equal(port_truth, jax_truth)
    np.testing.assert_allclose(port.W, jax.W, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(port.V, jax.V, rtol=1e-6, atol=1e-12)
    assert port.W.shape == (2, 11, 3) and port.V.shape == (2, 12, 20, 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_arm_agrees_with_the_jax_package(seed):
    for g in examples_jax.agree_with_record("poisson", seed):
        print(g)
        assert g["ok"], g
