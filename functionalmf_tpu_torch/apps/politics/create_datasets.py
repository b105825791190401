"""GDELT dataset preparation on the port.

Counterpart of functionalmf_tpu/apps/politics/create_datasets.py
(reference politics/create_datasets.py:1-80), host numpy: the raw
``gdelt.npz`` event tensor cut to the G20 nations and one action ("Intend
to Cooperate" by default), with 10% of the nation-nation pairs held out.
Writes ``cooperate.npy``, ``cooperate_train.npy``, ``held_out.npy``,
``dates.npy`` and ``nations.npy`` to ``outdir``, the files the politics
app reads from its ``--data-dir``.

    python -m functionalmf_tpu_torch.apps.politics.create_datasets \\
        --gdelt data/politics/gdelt.npz --outdir data/politics
"""
from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["G20", "create"]

G20 = [(0, "United States"), (1, "Russian Federation"), (2, "China"),
       (4, "Japan"), (6, "United Kingdom"), (8, "South Korea"), (9, "India"),
       (10, "Turkey"), (11, "France"), (16, "Germany"), (18, "Australia"),
       (25, "Indonesia"), (28, "Italy"), (31, "Saudi Arabia"),
       (32, "South Africa"), (34, "Brazil"), (38, "Mexico"), (44, "Canada"),
       (48, "Argentina")]


def create(gdelt_npz, outdir, action_idx=2, holdout_frac=0.1, seed=42):
    rng = np.random.default_rng(seed)
    df = np.load(gdelt_npz)
    idx = np.array([x[0] for x in G20])
    names = np.array([x[1] for x in G20])
    dates = np.array([x.decode("UTF-8") if isinstance(x, bytes) else str(x)
                      for x in df["dates"]])
    Y = df["Y"][idx][:, idx][:, :, action_idx].astype(float)

    n = Y.shape[0]
    indices = np.array([np.repeat(np.arange(n), n),
                        np.tile(np.arange(n), n)]).T
    to_hold = indices[rng.choice(indices.shape[0], replace=False,
                                 size=int(np.ceil(n * n * holdout_frac)))]
    Y_train = np.copy(Y)
    for i, j in to_hold:
        Y_train[i, j] = np.nan
    print("Held out {} nation pairs total".format(to_hold.shape[0]))

    os.makedirs(outdir, exist_ok=True)
    np.save(os.path.join(outdir, "cooperate"), Y)
    np.save(os.path.join(outdir, "cooperate_train"), Y_train)
    np.save(os.path.join(outdir, "held_out"), to_hold)
    np.save(os.path.join(outdir, "dates"), dates)
    np.save(os.path.join(outdir, "nations"), names)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Prepare the GDELT data")
    p.add_argument("--gdelt",
                   default=os.path.join("data", "politics", "gdelt.npz"))
    p.add_argument("--outdir", default=os.path.join("data", "politics"))
    p.add_argument("--action-idx", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    create(a.gdelt, a.outdir, a.action_idx, seed=a.seed)


if __name__ == "__main__":
    main()
