"""Google Flu Trends dataset preparation on the port.

Counterpart of functionalmf_tpu/apps/flutrends/create_datasets.py
(reference flutrends/create_datasets.py:1-40), host numpy and scipy: the
state columns of ``flu_US.mat``, with about 10% of the (state, year)
spans that have data held out. Writes ``flu_US_states.mat``,
``flu_US_states_train.mat`` and ``held_out_years.npy`` to ``outdir``,
the files the flu-trends app reads from its ``--data-dir``.

    python -m functionalmf_tpu_torch.apps.flutrends.create_datasets \\
        --flu-mat data/flutrends/flu_US.mat --outdir data/flutrends
"""
from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.io import loadmat, savemat

__all__ = ["create"]


def create(flu_mat, outdir, seed=42):
    """Returns (data, train, to_hold): the (weeks, 50) state series, the
    same with the held-out spans NaN, and the (state, start, end) rows of
    those spans."""
    rng = np.random.default_rng(seed)
    df = loadmat(flu_mat)
    data = df["data"][:, 1:51]  # state columns only
    names = df["USnames"][1:51]
    dates = df["dates"]

    years = np.array([int(x[0][0][:4]) for x in dates])
    weeks = np.arange(years.shape[0])
    has_week = ~np.isnan(data)
    state_idx, year_start, year_end = [], [], []
    for yr in range(years.min(), years.max() + 1):
        has_year = np.any(has_week[years == yr], axis=0)
        state_idx.extend(np.arange(data.shape[1])[has_year])
        year_start.extend([weeks[years == yr][0]] * has_year.sum())
        year_end.extend([weeks[years == yr][-1] + 1] * has_year.sum())
    indices = np.array([state_idx, year_start, year_end]).T
    to_hold = indices[rng.choice(indices.shape[0], replace=False,
                                 size=int(np.ceil(indices.shape[0] * 0.1)))]
    train = data.copy()
    for i, j, k in to_hold:
        train[j:k, i] = np.nan

    os.makedirs(outdir, exist_ok=True)
    savemat(os.path.join(outdir, "flu_US_states.mat"),
            {"data": data, "USnames": names, "dates": dates})
    savemat(os.path.join(outdir, "flu_US_states_train.mat"),
            {"data": train, "USnames": names, "dates": dates})
    np.save(os.path.join(outdir, "held_out_years"), to_hold)
    return data, train, to_hold


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Prepare the flu-trends data")
    p.add_argument("--flu-mat",
                   default=os.path.join("data", "flutrends", "flu_US.mat"))
    p.add_argument("--outdir", default=os.path.join("data", "flutrends"))
    p.add_argument("--seed", type=int, default=42)
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    return create(a.flu_mat, a.outdir, a.seed)


if __name__ == "__main__":
    main()
