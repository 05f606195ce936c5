"""Figures: the reference notebooks' plots as functions.

Counterpart of ``vargp_tpu/experiments/plots.py``: the toy's per-class
predictive-density contours after each task (toy.ipynb, the README
figure), the accuracy and normalised-entropy matrices, the inducing
inputs as images and the accuracy against M (mnist.ipynb), and the
method-comparison curves.  Inputs are numpy arrays (a caller converts a
tensor with ``.cpu().numpy()``).  matplotlib is imported inside each
function, with the ``Agg`` backend, so that a run without it (the card's
machine has none) needs it only when it draws; the analyses catch the
``ImportError`` and write their JSON alone.
"""

import importlib.util

import numpy as np


def plot_toy_densities(gx, gy, probs, dataset=None, out_path="toy_density.png"):
    """Contour plots of per-class predictive probability after each task
    (toy.ipynb cells 3-6).  probs: (T, n, n, C) from
    ``analysis.toy_density_grid``; ``dataset`` (an ``ArrayDataset``) is
    scattered over each panel."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    T, _, _, C = probs.shape
    fig, axes = plt.subplots(T, C, figsize=(3 * C, 3 * T), squeeze=False)
    for t in range(T):
        for c in range(C):
            ax = axes[t][c]
            cs = ax.contourf(gx, gy, probs[t, :, :, c], levels=10, cmap="viridis")
            if dataset is not None:
                ax.scatter(
                    dataset.data[:, 0], dataset.data[:, 1],
                    c=dataset.targets, s=4, cmap="tab10", alpha=0.5,
                )
            ax.set_title(f"after task {t}: p(y={c})")
    fig.colorbar(cs, ax=axes.ravel().tolist(), shrink=0.6)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_matrices(acc, ent, out_path="matrices.png"):
    """T x T accuracy + normalized-entropy heatmaps (mnist.ipynb cells
    12/21)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    for ax, mat, title in ((ax1, acc, "accuracy"), (ax2, ent, "entropy / ln C")):
        im = ax.imshow(mat, vmin=0, vmax=1, cmap="viridis")
        ax.set_xlabel("test task")
        ax.set_ylabel("after training task")
        ax.set_title(title)
        for (i, j), v in np.ndenumerate(np.asarray(mat)):
            ax.text(j, i, f"{v:.2f}", ha="center", va="center", fontsize=8,
                    color="white" if v < 0.6 else "black")
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_inducing_images(
    z, out_path="inducing.png", img_shape=(28, 28), max_per_class=10
):
    """Learned inducing points rendered as images, one row per class head
    (mnist.ipynb cell 10: the paper's 'inducing inputs look like digits'
    figure).  z: (out_size, M, D) with D == prod(img_shape)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z = np.asarray(z)
    O, M, D = z.shape
    if D != int(np.prod(img_shape)):
        raise ValueError(f"inducing inputs of {D} features are not images of {img_shape}")
    n_cols = min(M, max_per_class)
    fig, axes = plt.subplots(
        O, n_cols, figsize=(1.1 * n_cols, 1.1 * O), squeeze=False
    )
    for o in range(O):
        for m in range(n_cols):
            ax = axes[o][m]
            ax.imshow(z[o, m].reshape(img_shape), cmap="gray_r")
            ax.set_xticks([])
            ax.set_yticks([])
            if m == 0:
                ax.set_ylabel(f"class {o}", fontsize=8)
    fig.suptitle("inducing inputs")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_accuracy_vs_m(results: dict, out_path="varying_M.png"):
    """Final average accuracy vs number of inducing points
    (mnist.ipynb cell 17).  results: {M: final_avg_acc}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ms = sorted(results)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(ms, [results[m] for m in ms], marker="o")
    ax.set_xlabel("inducing points M")
    ax.set_ylabel("final average accuracy")
    ax.grid(alpha=0.3)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_method_comparison(curves: dict, out_path="method_comparison.png"):
    """Average accuracy (over tasks seen so far) after each task, one line
    per method — the mnist.ipynb VCL-comparison figure (cells 6/15/19/24).
    curves: {method_name: [avg_acc_after_task_0, ...]}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 3.5))
    for name, ys in curves.items():
        ax.plot(range(len(ys)), ys, marker="o", label=name)
    ax.set_xlabel("task")
    ax.set_ylabel("avg accuracy on tasks seen so far")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def draw_or_skip(draw, *args, out_path: str, **kwargs):
    """``draw(*args, out_path=out_path, **kwargs)``, or, where matplotlib is
    not installed (the card's machine), one printed line saying the figure
    was skipped; returns the figure's path or None."""
    if importlib.util.find_spec("matplotlib") is None:
        print(f"[plots] {out_path} skipped: matplotlib is not installed")
        return None
    return draw(*args, out_path=out_path, **kwargs)
