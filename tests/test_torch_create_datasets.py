"""The port's two ``create_datasets.create`` against the JAX package's on
small input files of the reference's form, written here (the real
``flu_US.mat`` and ``gdelt.npz`` are not in the repository), and the
flu-trends app's ``load_data`` on a directory that holds only the raw
``flu_US.mat``."""
import os

import numpy as np
import pytest
from scipy.io import loadmat, savemat

from functionalmf_tpu.apps.flutrends import benchmark as jbench
from functionalmf_tpu.apps.flutrends import create_datasets as jflu
from functionalmf_tpu.apps.politics import create_datasets as jpol
from functionalmf_tpu_torch.apps.flutrends import benchmark as tbench
from functionalmf_tpu_torch.apps.flutrends import create_datasets as tflu
from functionalmf_tpu_torch.apps.politics import create_datasets as tpol


def write_flu_mat(path, weeks=160, seed=0):
    """A ``flu_US.mat`` of the reference's form: ``data`` (weeks, 1 + 50 +
    2), a leading national column and then the states; ``USnames``;
    ``dates`` as strings starting YYYY, weekly over about three years. Some
    states start late or miss a year (NaN), so the (state, year) spans
    differ from year to year."""
    rng = np.random.default_rng(seed)
    data = np.exp(rng.normal(5, 0.5, size=(weeks, 53)))
    data[:40, 3] = np.nan                  # a state that starts late
    data[60:110, 7] = np.nan               # a state without 2004
    data[rng.random(data.shape) < 0.02] = np.nan
    day0 = np.datetime64("2003-09-28")
    dates = np.empty((weeks, 1), dtype=object)
    for w in range(weeks):
        dates[w, 0] = str(day0 + np.timedelta64(7 * w, "D"))
    names = np.empty((53, 1), dtype=object)
    for i in range(53):
        names[i, 0] = f"Region {i}"
    savemat(str(path), {"data": data, "USnames": names, "dates": dates})


def write_gdelt(path, n=50, actions=4, T=12, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.poisson(3.0, size=(n, n, actions, T))
    dates = np.array([f"2016-{m:02d}".encode() for m in range(1, T + 1)])
    np.savez(str(path), Y=Y, dates=dates)


@pytest.mark.parametrize("seed", [42, 3])
def test_flu_create_matches_jax(tmp_path, seed):
    raw = tmp_path / "flu_US.mat"
    write_flu_mat(raw)
    got = tflu.create(str(raw), str(tmp_path / "port"), seed=seed)
    want = jflu.create(str(raw), str(tmp_path / "jax"), seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (160, 50) and got[2].shape[1] == 3
    assert np.isnan(got[1]).sum() > np.isnan(got[0]).sum()
    for name in ("flu_US_states.mat", "flu_US_states_train.mat"):
        g = loadmat(str(tmp_path / "port" / name))
        w = loadmat(str(tmp_path / "jax" / name))
        np.testing.assert_array_equal(g["data"], w["data"])
        assert [x[0][0] for x in g["dates"]] == [x[0][0] for x in w["dates"]]
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "held_out_years.npy"),
        np.load(tmp_path / "jax" / "held_out_years.npy"))


def test_politics_create_matches_jax(tmp_path):
    src = tmp_path / "gdelt.npz"
    write_gdelt(src)
    tpol.create(str(src), str(tmp_path / "port"), action_idx=1)
    jpol.create(str(src), str(tmp_path / "jax"), action_idx=1)
    for name in ("cooperate", "cooperate_train", "held_out", "dates",
                 "nations"):
        g = np.load(tmp_path / "port" / f"{name}.npy")
        w = np.load(tmp_path / "jax" / f"{name}.npy")
        np.testing.assert_array_equal(g, w, err_msg=name)
    Y = np.load(tmp_path / "port" / "cooperate.npy")
    assert Y.shape == (19, 19, 12)
    assert np.isnan(np.load(tmp_path / "port" / "cooperate_train.npy")).sum() \
        == 37 * 12                          # ceil(0.1 * 19 * 19) pairs


def test_load_data_prepares_a_raw_flu_mat_as_jax_does(tmp_path):
    """With only ``flu_US.mat`` in the data directory, both packages'
    ``load_data`` prepare it with ``create``: equal Y, Y_train and
    held-out spans (the port synthesised data here before)."""
    write_flu_mat(tmp_path / "flu_US.mat")
    got = tbench.load_data(str(tmp_path), np.random.default_rng(0))
    want = jbench.load_data(str(tmp_path), np.random.default_rng(0))
    assert got[0].shape == (50, 1, 160)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["flu_US.mat"]


def test_clis_write_what_create_writes(tmp_path):
    """Each CLI with its arguments writes what ``create`` writes; the
    default paths are the apps' data directories, under the working
    directory."""
    raw, src = tmp_path / "flu_US.mat", tmp_path / "gdelt.npz"
    write_flu_mat(raw)
    write_gdelt(src)
    tflu.main(["--flu-mat", str(raw), "--outdir", str(tmp_path / "flu"),
               "--seed", "3"])
    want = jflu.create(str(raw), str(tmp_path / "jflu"), seed=3)
    np.testing.assert_array_equal(
        np.load(tmp_path / "flu" / "held_out_years.npy"), want[2])
    tpol.main(["--gdelt", str(src), "--outdir", str(tmp_path / "pol"),
               "--action-idx", "3", "--seed", "5"])
    jpol.create(str(src), str(tmp_path / "jpol"), 3, seed=5)
    for name in ("cooperate_train", "held_out"):
        np.testing.assert_array_equal(
            np.load(tmp_path / "pol" / f"{name}.npy"),
            np.load(tmp_path / "jpol" / f"{name}.npy"))
    flu, pol = tflu.parse_args([]), tpol.parse_args([])
    assert flu.flu_mat == os.path.join("data", "flutrends", "flu_US.mat")
    assert flu.outdir == tbench.parse_args([]).data_dir or \
        "FLU_DATA_DIR" in os.environ
    assert pol.gdelt == os.path.join("data", "politics", "gdelt.npz")
    assert (pol.action_idx, pol.seed, flu.seed) == (2, 42, 42)
