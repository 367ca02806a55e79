"""2D plots (counterpart of `gluefactory_tpu/visualization/viz2d.py`): image
rows and grids, keypoints, matches, line segments, colour-coded line
matches, heatmaps, epipolar lines, outlined text, cumulative error curves,
and the datasets' viewers' grids written to a file.

Every function takes numpy arrays or tensors on any device (moved to the
host by `utils.tensor.to_numpy`). Images are HWC (the port's batches carry
them so), or CHW with 1 or 3 channels, which is shown as the same HWC
pixels; a single channel is shown through `cmaps`.

matplotlib is imported inside each function that draws, never when the
module is imported: the card's host has none, and there a drawing function
raises ImportError.
"""

from __future__ import annotations

import numpy as np

from ..utils.tensor import to_numpy


def _image(img) -> np.ndarray:
    """HWC (or HW) numpy from an HWC or CHW array or tensor, one channel
    squeezed."""
    img = to_numpy(img)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = img.transpose(1, 2, 0)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    return img


def cm_RdGn(x):
    """Red-green colormap for correctness: 0 -> red, 1 -> green (N, 3)."""
    x = np.clip(np.asarray(to_numpy(x), float), 0, 1)[..., None] * 2
    c = x * np.array([[0.0, 1.0, 0.0]]) + (2 - x) * np.array([[1.0, 0.0, 0.0]])
    return np.clip(c, 0, 1)


def cm_ranking(sc, ths=(512, 1024, 2048, 4096)):
    """Colour points by score-rank tier: for a score-sorted (top-k) input
    the `ths[0]` best are red, the next tiers yellow / lime / cyan, the rest
    blue (gray past a fifth tier). Tiers go by array index, then are
    reordered score-descending, as upstream does: tier by rank only for a
    sorted input."""
    sc = to_numpy(sc)
    palette = np.array(["red", "yellow", "lime", "cyan", "blue", "gray"])
    tier = np.searchsorted(np.asarray(ths), np.arange(sc.shape[0]), side="right")
    by_rank = palette[np.minimum(tier, len(palette) - 1)]
    return by_rank[np.argsort(sc, axis=0)[::-1]]


def plot_images(imgs, titles=None, cmaps="gray", dpi=100, pad=0.5, adaptive=True):
    """Images side by side in a new figure; returns the axes."""
    import matplotlib.pyplot as plt

    n = len(imgs)
    if not isinstance(cmaps, (list, tuple)):
        cmaps = [cmaps] * n
    imgs = [_image(im) for im in imgs]
    ratios = [im.shape[1] / im.shape[0] for im in imgs] if adaptive else [4 / 3] * n
    figsize = [sum(ratios) * 4.5, 4.5]
    fig, ax = plt.subplots(1, n, figsize=figsize, dpi=dpi, gridspec_kw={"width_ratios": ratios})
    if n == 1:
        ax = [ax]
    for i in range(n):
        ax[i].imshow(imgs[i], cmap=plt.get_cmap(cmaps[i]))
        ax[i].set_axis_off()
        if titles:
            ax[i].set_title(titles[i])
    fig.tight_layout(pad=pad)
    return ax


def plot_image_grid(imgs, titles=None, cmaps="gray", dpi=100, pad=0.5, return_fig=False):
    """A grid of image rows in a new figure; returns the (rows, cols) axes,
    and the figure first with `return_fig`."""
    import matplotlib.pyplot as plt

    n_rows, n_cols = len(imgs), len(imgs[0])
    fig, ax = plt.subplots(n_rows, n_cols, figsize=[n_cols * 4.5, n_rows * 4.5], dpi=dpi,
                           squeeze=False)
    for r in range(n_rows):
        for c in range(n_cols):
            cmap = cmaps if isinstance(cmaps, str) else cmaps[c]
            ax[r][c].imshow(_image(imgs[r][c]), cmap=plt.get_cmap(cmap))
            ax[r][c].set_axis_off()
            if titles:
                ax[r][c].set_title(titles[r][c])
    fig.tight_layout(pad=pad)
    if return_fig:
        return fig, ax
    return ax


def add_text(idx, text, axes=None, pos=(0.01, 0.99), fs=15, color="w", lcolor="k", lwidth=2,
             ha="left", va="top", visible=True):
    """Outlined text on axis `idx` of `axes` (the current figure's)."""
    import matplotlib.patheffects as path_effects
    import matplotlib.pyplot as plt

    if axes is None:
        axes = plt.gcf().axes
    ax = axes[idx] if not hasattr(axes, "ndim") else axes.ravel()[idx]
    t = ax.text(*pos, text, fontsize=fs, ha=ha, va=va, color=color, transform=ax.transAxes,
                visible=visible)
    if lcolor is not None:
        t.set_path_effects([path_effects.Stroke(linewidth=lwidth, foreground=lcolor),
                            path_effects.Normal()])
    return t


def plot_keypoints(kpts, colors="lime", ps=4, axes=None, a=1.0):
    """One scatter of keypoints (N, 2) on each axis."""
    import matplotlib.pyplot as plt

    if axes is None:
        axes = plt.gcf().axes
    if not isinstance(colors, list):
        colors = [colors] * len(kpts)
    for ax, k, c in zip(axes, kpts, colors):
        k = to_numpy(k)
        ax.scatter(k[:, 0], k[:, 1], c=c, s=ps, linewidths=0, alpha=a)


def plot_matches(kpts0, kpts1, color=None, lw=1.5, ps=4, a=1.0, axes=None):
    """Match lines across two axes (the current figure's first two), drawn
    on their figure, and the matched points; `color` None draws random hues
    from numpy's global generator."""
    import matplotlib
    import matplotlib.patches  # noqa: F401  (ConnectionPatch)
    import matplotlib.pyplot as plt

    ax0, ax1 = plt.gcf().axes[:2] if axes is None else axes
    fig = ax0.figure
    kpts0, kpts1 = to_numpy(kpts0), to_numpy(kpts1)
    if color is None:
        color = matplotlib.cm.hsv(np.random.rand(len(kpts0))).tolist()
    elif not isinstance(color, (list, np.ndarray)):
        color = [color] * len(kpts0)
    if lw > 0:
        for i in range(len(kpts0)):
            fig.add_artist(matplotlib.patches.ConnectionPatch(
                xyA=(kpts0[i, 0], kpts0[i, 1]), xyB=(kpts1[i, 0], kpts1[i, 1]),
                coordsA=ax0.transData, coordsB=ax1.transData, axesA=ax0, axesB=ax1, zorder=1,
                color=color[i], linewidth=lw, alpha=a))
    if ps > 0:
        ax0.scatter(kpts0[:, 0], kpts0[:, 1], c=color, s=ps)
        ax1.scatter(kpts1[:, 0], kpts1[:, 1], c=color, s=ps)


def plot_lines(lines_per_axis, line_colors="orange", point_colors="cyan", ps=4, lw=2, alpha=1.0,
               indices=(0, 1), axes=None):
    """Line segments (N, 2, 2) and their end points on each axis."""
    import matplotlib.pyplot as plt

    if not isinstance(line_colors, list):
        line_colors = [line_colors] * len(lines_per_axis)
    if not isinstance(point_colors, list):
        point_colors = [point_colors] * len(lines_per_axis)
    if axes is None:
        axes = [plt.gcf().axes[i] for i in indices]
    for ax, lines, lc, pc in zip(axes, lines_per_axis, line_colors, point_colors):
        lines = to_numpy(lines)
        for seg in lines:
            ax.plot((seg[0, 0], seg[1, 0]), (seg[0, 1], seg[1, 1]), c=lc, linewidth=lw, alpha=alpha)
        pts = lines.reshape(-1, 2)
        ax.scatter(pts[:, 0], pts[:, 1], c=pc, s=ps, linewidths=0, zorder=2, alpha=alpha)


def plot_color_line_matches(lines_per_axis, correct_matches=None, lw=2, indices=(0, 1), axes=None):
    """Matched line pairs in one colour each across the two axes (hues
    shuffled by RandomState(0)); with `correct_matches`, green / red."""
    import matplotlib
    import matplotlib.pyplot as plt

    n_lines = len(to_numpy(lines_per_axis[0]))
    if correct_matches is not None:
        colors = cm_RdGn(np.asarray(to_numpy(correct_matches), float))
    else:
        colors = matplotlib.cm.hsv(np.linspace(0, 1, n_lines))
        np.random.RandomState(0).shuffle(colors)
    if axes is None:
        axes = [plt.gcf().axes[i] for i in indices]
    for ax, lines in zip(axes, lines_per_axis):
        for i, seg in enumerate(to_numpy(lines)):
            ax.plot((seg[0, 0], seg[1, 0]), (seg[0, 1], seg[1, 1]), c=colors[i], linewidth=lw)


def plot_heatmaps(heatmaps, vmin=0.0, vmax=None, cmap="Spectral", a=0.5, axes=None):
    """Each (H, W) map over its axis, translucent."""
    import matplotlib.pyplot as plt

    if axes is None:
        axes = plt.gcf().axes
    for ax, h in zip(axes, heatmaps):
        ax.imshow(np.asarray(to_numpy(h), float), alpha=a, vmin=vmin, vmax=vmax, cmap=cmap)


def plot_epipolar_lines(pts0, pts1, F, axes=None, color="orange", lw=1.0):
    """The epipolar lines of pts0 in image 1 and of pts1 in image 0 (F maps
    image 0 to image 1), across each axis's x range."""
    import matplotlib.pyplot as plt

    if axes is None:
        axes = plt.gcf().axes[:2]
    ax0, ax1 = axes

    def draw(ax, lines):
        xlim = ax.get_xlim()
        for a_, b_, c_ in lines:
            if abs(b_) > 1e-8:
                x = np.array(xlim)
                ax.plot(x, -(a_ * x + c_) / b_, c=color, linewidth=lw, alpha=0.6)
        ax.set_xlim(xlim)

    pts0, pts1, F = to_numpy(pts0), to_numpy(pts1), to_numpy(F)
    pts0_h = np.concatenate([pts0, np.ones((len(pts0), 1))], 1)
    pts1_h = np.concatenate([pts1, np.ones((len(pts1), 1))], 1)
    draw(ax1, pts0_h @ F.T)
    draw(ax0, pts1_h @ F)


def save_image_grid(path, rows, depths=None, dpi=100, save_dpi=None, **savefig_kw):
    """The datasets' viewers: `rows` of images by `plot_image_grid` on Agg,
    each row's `depths` over it where every view of the row has one, the
    figure written to `path`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    axes = plot_image_grid(rows, dpi=dpi)
    for row_axes, row_depths in zip(axes, depths or []):
        if all(d is not None for d in row_depths):
            plot_heatmaps(row_depths, axes=row_axes)
    plt.savefig(path, dpi=save_dpi or dpi, **savefig_kw)
    print(f"wrote {path}")


def plot_cumulative(errors: dict, x_limits, unit="px", title=""):
    """Recall (%) against error, one curve per entry of `errors`, the
    non-finite errors left out."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=[5, 8])
    for name, errs in errors.items():
        errs = np.sort(np.asarray(to_numpy(errs), float))
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


def save_plot(path, **kw):
    """The current figure to `path`, cropped to its content."""
    import matplotlib.pyplot as plt

    plt.savefig(path, bbox_inches="tight", pad_inches=0, **kw)
