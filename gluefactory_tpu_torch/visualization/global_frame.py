"""The cross-experiment scatter of per-item metrics (counterpart of
`gluefactory_tpu/visualization/global_frame.py`): one point per eval item
and experiment, the legend with each experiment's medians.

    hover          the item's name and its (x, y)
    click          the pair's `TwoViewFrame`
    x / X, y / Y   the next / previous metric on x / y
    d              diff mode (two experiments or more: y minus the first's)

matplotlib is imported when a frame is made.
"""

from __future__ import annotations

import numpy as np

from ..utils.tensor import map_tensor, to_numpy


class GlobalFrame:
    default_conf = {"x": None, "y": None, "diff": False}

    child_frames = []

    def __init__(self, conf, results: dict, loader, predictions, child_frame=None):
        """results: {experiment: {metric: per-item array, "names": [...]}};
        predictions: {experiment: name -> pred dict}."""
        import matplotlib.pyplot as plt

        self.conf = {**self.default_conf, **(conf or {})}
        self.results = results
        self.loader = loader
        self.predictions = predictions
        self.child_frame = child_frame
        first = next(iter(results.values()))
        self.names = list(first["names"])
        self.metrics = [k for k, v in first.items()
                        if isinstance(v, (list, np.ndarray)) and len(v) == len(self.names)
                        and np.issubdtype(np.asarray(v).dtype, np.number)]
        self.x = self.conf["x"] or self.metrics[0]
        self.y = self.conf["y"] or (self.metrics[1] if len(self.metrics) > 1 else self.metrics[0])
        self.diff = bool(self.conf["diff"]) and len(results) > 1
        self.fig, self.ax = plt.subplots()
        self.scatters = {}
        self.annot = None
        self.draw()
        self.fig.canvas.mpl_connect("pick_event", self.on_pick)
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.fig.canvas.mpl_connect("motion_notify_event", self.on_hover)

    def _series(self, name):
        """(xs, ys) of one experiment in the current mode."""
        res = self.results[name]
        xs = np.asarray(res[self.x], float)
        ys = np.asarray(res[self.y], float)
        if self.diff:
            ys = ys - np.asarray(next(iter(self.results.values()))[self.y], float)
        return xs, ys

    def draw(self):
        self.ax.clear()
        self.scatters = {}
        for name in self.results:
            xs, ys = self._series(name)
            label = f"{name} (med {np.nanmedian(xs):.3g}, {np.nanmedian(ys):.3g})"
            self.scatters[self.ax.scatter(xs, ys, label=label, picker=5, alpha=0.6)] = name
        self.ax.set_xlabel(self.x)
        self.ax.set_ylabel(self.y if not self.diff else f"Δ{self.y} vs {next(iter(self.results))}")
        if self.diff:
            self.ax.axhline(0.0, color="k", lw=0.8, alpha=0.5)
        self.ax.legend(fontsize="small")
        self.ax.grid(alpha=0.3)
        self.ax.set_title("hover: info | click: open pair | x/X y/Y: cycle metrics | d: diff",
                          fontsize="small")
        self.annot = self.ax.annotate("", xy=(0, 0), xytext=(12, 12), textcoords="offset points",
                                      bbox=dict(boxstyle="round", fc="w", alpha=0.9),
                                      arrowprops=dict(arrowstyle="->"))
        self.annot.set_visible(False)
        self.fig.canvas.draw_idle()

    def set_axes(self, x=None, y=None):
        if x:
            self.x = x
        if y:
            self.y = y
        self.draw()

    def on_key(self, event):
        if event.key in ("x", "X", "y", "Y"):
            step = 1 if event.key.islower() else -1
            axis = event.key.lower()
            cur = self.x if axis == "x" else self.y
            nxt = self.metrics[(self.metrics.index(cur) + step) % len(self.metrics)]
            self.set_axes(**{axis: nxt})
        elif event.key == "d" and len(self.results) > 1:
            self.diff = not self.diff
            self.draw()

    def on_hover(self, event):
        if event.inaxes != self.ax or self.annot is None:
            return
        for sc, name in self.scatters.items():
            hit, info = sc.contains(event)
            if hit:
                idx = int(info["ind"][0])
                xs, ys = self._series(name)
                self.annot.xy = (xs[idx], ys[idx])
                self.annot.set_text(f"{self.names[idx]}\n{name}\n"
                                    f"{self.x}={xs[idx]:.4g}\n{self.y}={ys[idx]:.4g}")
                self.annot.set_visible(True)
                self.fig.canvas.draw_idle()
                return
        if self.annot.get_visible():
            self.annot.set_visible(False)
            self.fig.canvas.draw_idle()

    def on_pick(self, event):
        """The picked item's pair (the loader's batch of that index, its
        first item) with every experiment's prediction, in `child_frame`."""
        import matplotlib.pyplot as plt

        idx = int(event.ind[0])
        name = self.names[idx]
        if self.child_frame is None:
            print(f"picked item {idx}: {name}")
            return
        data = None
        for i, batch in enumerate(self.loader):
            if i == idx:
                data = map_tensor(to_numpy(batch), lambda t: t[0])
                break
        preds = {exp: self.predictions[exp](name) for exp in self.predictions}
        frame = self.child_frame({}, data, preds, title=str(name))
        self.child_frames.append(frame)
        plt.show()
