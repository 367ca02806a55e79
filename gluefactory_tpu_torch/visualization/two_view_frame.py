"""The per-pair view (counterpart of
`gluefactory_tpu/visualization/two_view_frame.py`): one row of two axes per
experiment, so that predictions compare side by side; the plot modes of
`tools.__plot_dict__` that every experiment can draw; left / right cycle
them, `t` shows or hides each row's summary; the background is the colour
images, the depths, or the colour with the depths over it (`event` 1, 2, 3).
matplotlib is imported when a frame is made.
"""

from __future__ import annotations

import numpy as np

from ..utils.tensor import to_numpy
from . import tools


def _flat_keys(d, pre=""):
    out = set()
    for k, v in d.items():
        if isinstance(v, dict):
            out |= _flat_keys(v, f"{pre}{k}.")
        out.add(f"{pre}{k}" if pre else k)
    return out


class TwoViewFrame:
    default_conf = {"default": "matches", "summary_visible": False}

    plot_dict = tools.__plot_dict__
    childs = []
    event_to_image = [None, "color", "depth", "color+depth"]

    def __init__(self, conf, data, preds, title=None, event=1, summaries=None):
        from .viz2d import add_text, plot_heatmaps, plot_image_grid

        self.conf = {**self.default_conf, **(conf or {})}
        self.data = data
        if not isinstance(preds, dict) or "keypoints0" in preds:
            preds = {"prediction": preds}
        self.preds = preds
        self.names = list(preds)
        self.summaries = summaries
        self.plot = self.event_to_image[event] or "color"

        imgs = self._background_images()
        self.fig, self.axes = plot_image_grid([imgs for _ in self.names], return_fig=True)
        for i, name in enumerate(self.names):
            add_text(0, name, axes=self.axes[i])
        if self.plot == "color+depth" and "depth" in data.get("view0", {}):
            hmaps = [to_numpy(data["view0"]["depth"]), to_numpy(data["view1"]["depth"])]
            for row in self.axes:
                plot_heatmaps(hmaps, axes=row, cmap="Spectral")
        if title:
            self.fig.suptitle(title)

        # the modes every experiment can draw
        keys = None
        for pred in preds.values():
            pk = _flat_keys(pred)
            keys = pk if keys is None else keys & pk
        keys |= _flat_keys(data)
        self.options = [name for name, tool in self.plot_dict.items()
                        if set(getattr(tool, "required_keys", [])).issubset(keys)]
        default = self.conf.get("default", "matches")
        if default not in self.options and self.options:
            default = self.options[0]
        self.summary_arts = self._summary_artists()
        self.radio = tools.RadioHideTool(
            self.fig, self.axes, data, preds,
            {k: self.plot_dict[k] for k in self.options} or self.plot_dict, default=default)
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)

    def _background_images(self):
        view0, view1 = self.data["view0"], self.data["view1"]
        if self.plot == "depth" and "depth" in view0:
            return [to_numpy(view0["depth"]), to_numpy(view1["depth"])]
        return [view0["image"], view1["image"]]

    def _summary_artists(self):
        from .viz2d import add_text

        if self.summaries is None:
            return []
        arts = []
        for i, name in enumerate(self.names):
            txt = "\n".join(f"{k}: {v:.4f}" if isinstance(v, (float, np.floating)) else f"{k}: {v}"
                            for k, v in dict(self.summaries.get(name, {})).items())
            arts.append(add_text(0, txt, axes=self.axes[i], pos=(0.01, 0.01), va="bottom",
                                 visible=bool(self.conf.get("summary_visible"))))
        return arts

    def set_summary_visible(self, visible):
        self.conf["summary_visible"] = visible
        for art in self.summary_arts:
            art.set_visible(visible)
        self.fig.canvas.draw_idle()

    def on_key(self, event):
        names = list(self.radio.plot_dict)
        if event.key in ("right", "left"):
            idx = names.index(self.radio.current)
            idx = (idx + (1 if event.key == "right" else -1)) % len(names)
            self.radio.draw(names[idx])
        elif event.key == "t":
            self.set_summary_visible(not self.conf.get("summary_visible"))
