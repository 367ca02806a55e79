"""LightGlue's early-exit serving path (counterpart of
`gluefactory_tpu/models/matchers/lightglue_serving.py`).

The masked pruned forward (`LightGlue._pruned_forward`) gives the exact
outputs but runs every layer. This function runs the same rules and stops
at the exit: a batch whose items all exit after layer k runs k layers, and
launches each attention kernel k times.

- the depth rule, the width keep-rule, the prune counters and the frozen
  descriptors of stopped items are `_pruned_forward`'s, so the outputs are
  its outputs; the last layer forces the exit of every item still running,
  and runs no width round;
- the loop indexes the model's own per-layer modules (no stacked copy);
- after each layer the host reads the items' `stopped` flags, one read a
  layer (the JAX while-loop decides on the device): the card idles from
  the end of that layer until the host has launched the next;
- the final (M+1) x (N+1) assignment is computed once per item, at its own
  exit layer: one assignment-head call for each distinct exit layer, on
  the items that exited there.

Below the model's pruning guard (`LightGlue.pruning_min_kpts`) the dense
forward runs, with every item exiting at the last layer.
"""

from __future__ import annotations

import torch

from .lightglue import LightGlue, _exits, _width_round


def make_serving_fn(model: LightGlue):
    """`fn(data) -> pred` running the early-exit serving path of `model`:
    the masked pruned forward's keys plus `exit_layer` (B,) int32. Needs
    `depth_confidence > 0`: without an exit rule the dense forward is the
    serving path."""
    c = model.conf
    n = int(c.n_layers)
    if not c.depth_confidence > 0:
        raise ValueError("the serving path needs depth_confidence > 0")
    thresholds = [model._confidence_threshold(i) for i in range(n)]
    depth_conf, width_conf = float(c.depth_confidence), float(c.width_confidence)

    def fn(data: dict) -> dict:
        desc0, desc1, enc0, enc1, mask0, mask1 = model._encode(data)
        B, M, _ = desc0.shape
        N = desc1.shape[1]
        dev = desc0.device
        active0 = mask0 if mask0 is not None else torch.ones(B, M, dtype=torch.bool, device=dev)
        active1 = mask1 if mask1 is not None else torch.ones(B, N, dtype=torch.bool, device=dev)
        full0 = torch.full((B, M), n, dtype=torch.int32, device=dev)
        full1 = torch.full((B, N), n, dtype=torch.int32, device=dev)

        if max(M, N) < model.pruning_min_kpts(data["keypoints0"].device):
            for layer in model.transformers:
                desc0, desc1 = layer(desc0, desc1, enc0, enc1, active0, active1)
            scores, _, _, _ = model.log_assignment[n - 1](desc0, desc1, active0, active1)
            return {**model.match_outputs(scores, mask0, mask1), "prune0": full0, "prune1": full1,
                    "exit_layer": torch.full((B,), n - 1, dtype=torch.int32, device=dev)}

        prune0, prune1 = torch.ones_like(full0), torch.ones_like(full1)
        stopped = torch.zeros(B, dtype=torch.bool, device=dev)
        exit_layer = torch.full((B,), n - 1, dtype=torch.int32, device=dev)
        exits = [n - 1] * B  # the host's copy, from the flags it reads
        for i in range(n):
            nd0, nd1 = model.transformers[i](desc0, desc1, enc0, enc1, active0, active1)
            # a layer may return another dtype than it was given: the
            # frozen descriptors take the layer's, as the JAX carry does
            desc0 = torch.where(stopped[:, None, None], desc0.to(nd0.dtype), nd0)
            desc1 = torch.where(stopped[:, None, None], desc1.to(nd1.dtype), nd1)
            if i == n - 1:  # forced exit; no width round after it
                exit_layer = torch.where(stopped, exit_layer, i)
                break
            conf_th = thresholds[i]
            c0, c1 = model.token_confidence[i](desc0, desc1)
            stop_now = _exits(c0, c1, active0, active1, conf_th, depth_conf) & ~stopped
            exit_layer = torch.where(stop_now, i, exit_layer)
            stopped = stopped | stop_now
            if width_conf > 0:
                z0 = model.log_assignment[i].get_matchability(desc0)
                z1 = model.log_assignment[i].get_matchability(desc1)
                active0, p0 = _width_round(active0, z0, c0, conf_th, width_conf, stopped)
                active1, p1 = _width_round(active1, z1, c1, conf_th, width_conf, stopped)
                prune0, prune1 = prune0 + p0, prune1 + p1
            flags = stopped.tolist()  # the one host read of the layer
            exits = [min(e, i) if f else e for e, f in zip(exits, flags)]
            if all(flags):
                break

        scores = None
        for layer_index in sorted(set(exits)):
            items = [b for b, e in enumerate(exits) if e == layer_index]
            head = model.log_assignment[layer_index]
            if len(items) == B:
                scores, _, _, _ = head(desc0, desc1, active0, active1)
                break
            idx = torch.tensor(items, device=dev)
            s, _, _, _ = head(desc0[idx], desc1[idx], active0[idx], active1[idx])
            if scores is None:
                scores = s.new_empty(B, M + 1, N + 1)
            scores[idx] = s
        if not width_conf > 0:
            prune0, prune1 = full0, full1
        return {**model.match_outputs(scores, mask0, mask1), "prune0": prune0, "prune1": prune1,
                "exit_layer": exit_layer}

    return fn
