"""2D plots (counterpart of `gluefactory_tpu/visualization/viz2d.py`): so far
the cumulative error curves of the evals. matplotlib is imported where a
plot is drawn; without it, `plot_cumulative` raises ImportError."""

from __future__ import annotations

import numpy as np


def plot_cumulative(errors: dict, x_limits, unit="px", title=""):
    """Recall (%) against error, one curve per entry of `errors`, the
    non-finite errors left out."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=[5, 8])
    for name, errs in errors.items():
        errs = np.sort(np.asarray(errs, float))
        errs = errs[np.isfinite(errs)]
        if errs.size == 0:
            continue
        recall = (np.arange(len(errs)) + 1) / len(errs)
        ax.plot(errs, recall * 100, label=name)
    ax.set_xlim(x_limits)
    ax.set_ylim([0, 100])
    ax.set_xlabel(f"error ({unit})")
    ax.set_ylabel("recall (%)")
    ax.set_title(title)
    ax.legend()
    ax.grid(alpha=0.3)
    return fig
