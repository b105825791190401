"""Plotting tools for the dose-response pipeline.

Counterpart of functionalmf_tpu/apps/doseresponse/plots.py (the
reference's plot_embeddings.py, plot_example.py and plot_results.py in
one module): a 2-D scatter of the row embeddings (PCA by numpy's SVD;
t-SNE and UMAP where scikit-learn or umap is installed), optionally
coloured by feature, and example posterior curve panels with credible and
posterior-predictive bands. Every function takes arrays and writes files;
matplotlib is imported when a function runs, never with the module.
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np


def _reduce_2d(W, reducer="pca"):
    if W.shape[1] == 2:
        return W
    if reducer == "umap":
        import umap
        return umap.UMAP().fit_transform(W)
    if reducer == "tsne":
        from sklearn.manifold import TSNE
        return TSNE(n_components=2).fit_transform(W)
    Wc = W - W.mean(axis=0)
    _, _, Vt = np.linalg.svd(Wc, full_matrices=False)
    return Wc @ Vt[:2].T


def plot_embeddings(Ws, plotdir, labels=None, features=None,
                    feature_names=None, reducer="pca", use_last=True):
    """2-D scatter of row embeddings (reference plot_embeddings.py:33-120)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    W = Ws[-1] if (use_last and Ws.ndim == 3) else np.asarray(Ws)
    W2 = _reduce_2d(W, reducer)
    os.makedirs(plotdir, exist_ok=True)

    plt.figure(figsize=(6, 6))
    plt.scatter(W2[:, 0], W2[:, 1], c="gray")
    if labels is not None:
        for (x, y), lbl in zip(W2, labels):
            plt.annotate(str(lbl), (x, y), fontsize=6)
    plt.savefig(os.path.join(plotdir, "embeddings.pdf"), bbox_inches="tight")
    plt.close()

    if features is not None:
        names = (feature_names if feature_names is not None
                 else [f"feature{i}" for i in range(features.shape[1])])
        for i, name in enumerate(names):
            plt.figure(figsize=(6, 6))
            plt.scatter(W2[:, 0], W2[:, 1], c=features[:, i], cmap="coolwarm")
            plt.colorbar()
            plt.title(str(name))
            plt.savefig(os.path.join(plotdir,
                                     "embeddings-{}.pdf".format(name)),
                        bbox_inches="tight")
            plt.close()
    return W2


def plot_curves(Y, Mu_hat, plotdir, likelihood=None, held_out=None,
                Mu_init=None, big_plot=False, prefix="curve"):
    """Posterior curve panels with 90% credible and posterior-predictive
    bands (reference plot_example.py / fit.py:442-486)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(plotdir, exist_ok=True)
    nrows, ncols = Y.shape[:2]
    ndepth = Y.shape[2]
    X = np.arange(ndepth)
    mean = Mu_hat.mean(axis=0)
    lower = np.percentile(Mu_hat, 5, axis=0)
    upper = np.percentile(Mu_hat, 95, axis=0)

    if big_plot:
        fig, axarr = plt.subplots(nrows, ncols,
                                  figsize=(5 * ncols, 5 * nrows),
                                  sharex=True, sharey=True, squeeze=False)
    for i in range(nrows):
        for j in range(ncols):
            ax = axarr[i, j] if big_plot else plt.gca()
            ax.axhline(1, color="darkgray", alpha=0.5)
            if Mu_init is not None:
                ax.plot(X, Mu_init[i, j], color="blue", label="init")
            if Y.ndim > 3:
                for t in range(ndepth):
                    ax.scatter(np.full(Y.shape[-1], X[t]), Y[i, j, t],
                               color="black", s=8)
            else:
                ax.scatter(X, Y[i, j], color="black", s=8)
            ax.plot(X, mean[i, j], color="orange")
            ax.fill_between(X, lower[i, j], upper[i, j], color="orange",
                            alpha=0.6)
            if likelihood is not None:
                draws = likelihood.sample(
                    np.broadcast_to(mean[i, j], (200, ndepth)),
                    size=(200, ndepth))
                ax.fill_between(X, np.percentile(draws, 5, axis=0),
                                np.percentile(draws, 95, axis=0),
                                color="orange", alpha=0.3)
            if held_out is not None and np.any(
                    (held_out[0] == i) & (held_out[1] == j)):
                ax.axvspan(X[0] - 0.5, X[-1] + 0.5, color="gray", alpha=0.3)
            if not big_plot:
                plt.savefig(os.path.join(
                    plotdir, "{}-{}-{}.pdf".format(prefix, i, j)),
                    bbox_inches="tight")
                plt.close()
    if big_plot:
        plt.savefig(os.path.join(plotdir, "all.pdf"), bbox_inches="tight")
        plt.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Dose-response plots.")
    parser.add_argument("--outdir", default="doseresponse/data/sim/")
    parser.add_argument("--plotdir", default="doseresponse/plots/sim/")
    parser.add_argument("--reducer", default="pca")
    parser.add_argument("--big_plot", action="store_true")
    parser.add_argument("--features")
    args = parser.parse_args(argv)

    Ws = np.load(os.path.join(args.outdir, "btf_w.npy"))
    features = names = None
    if args.features:
        with open(args.features, newline="") as f:
            reader = csv.reader(f)
            names = next(reader)[1:]
            features = np.array([[float(x) for x in row[1:]]
                                 for row in reader])
    plot_embeddings(Ws, args.plotdir, features=features, feature_names=names,
                    reducer=args.reducer)

    Y = np.load(os.path.join(args.outdir, "y.npy"))
    Mu_hat = np.load(os.path.join(args.outdir, "btf.npy"))
    held = None
    ho_path = os.path.join(args.outdir, "held_out.npy")
    if os.path.exists(ho_path):
        held = np.load(ho_path)
    plot_curves(Y, Mu_hat, args.plotdir, held_out=held,
                big_plot=args.big_plot)


if __name__ == "__main__":
    main()
