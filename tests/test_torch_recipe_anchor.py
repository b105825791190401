"""bench.py's red-black production recipe (tf_order=2, ngrid=100, blocks of
8, interweave and factor_rebalance on) on the port against the JAX
package's on the CPU, at two data seeds of bench.py's generator, a shape
cut to 6x5x24, k=2 (three blocks of 8) and cut sweeps: the mean of each
gated metric (RMSE against the true rate, 90% coverage of it, the
posterior means of log lam2 and log sigma2, which the scale moves set)
over the chains of one port model, within four standard errors from the
JAX chains' spread on the same data and counts (anchors.compare). The JAX
chains' centre and spread are the record in tests/examples_anchors.json
(tests/examples_jax.py remakes it); the data and the warm start, which
both packages draw from bench.py's generator, are held equal live."""
import numpy as np
import pytest

from functionalmf_tpu_torch.examples import anchors, recipe
from tests import examples_jax
from tests.test_torch_constrained import torch_one_thread  # noqa: F401

CFG = examples_jax.anchors_data()["cpu_test"]
SEEDS = tuple(CFG["seeds"])


@pytest.mark.parametrize("seed", SEEDS)
def test_recipe_data_and_warm_start_match_the_jax_recipe(seed):
    shape = CFG["shape"]["recipe"]
    port, port_truth = recipe.make_data(np.random.default_rng(seed), shape)
    jax, jax_truth = examples_jax.make_data("recipe", seed, shape)
    for a, b in zip(port, jax):        # Y, W0, V0
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_truth, jax_truth)
    model, Y, _ = anchors.setup("recipe", seed, seed, 2, "cpu", shape)
    np.testing.assert_array_equal(Y, port[0])
    np.testing.assert_array_equal(model.W[0], port[1].astype(np.float32))
    np.testing.assert_array_equal(model.V[1], port[2].astype(np.float32))
    assert (model.v_schedule, model.tf_order, model.gass_ngrid,
            model.interweave, model.factor_rebalance) == \
        ("redblack", 2, 100, True, True)
    assert [ph.size for ph in model._phases] == [8, 8]


@pytest.mark.parametrize("seed", SEEDS)
def test_recipe_agrees_with_the_jax_package(seed):
    for g in examples_jax.agree_with_record("recipe", seed):
        print(g)
        assert g["ok"], g
