"""MegaDepth scene lists from a local `scene_info/` directory (counterpart of
`gluefactory_tpu/scripts/make_scene_lists.py`), for corpora other than the
one upstream's packaged lists describe.

    python -m gluefactory_tpu_torch.scripts.make_scene_lists \\
        [--data_dir megadepth] [--val_fraction 0.02] [--test_scenes 0015 0022]

Writes `train_scenes_clean.txt`, `valid_scenes_clean.txt` and
`test_scenes_clean.txt` under `DATA_PATH/<data_dir>/scene_lists/`, which
`data/megadepth.py` reads before its packaged lists. The test scenes
(by default 0015 and 0022, which MegaDepth-1500 is drawn from) are held
out; the rest is split by a hash of the scene id.
"""

from __future__ import annotations

import argparse
import hashlib

from .. import settings


def bucket(scene: str) -> float:
    """The scene's place in [0, 1) by the SHA-1 of its id."""
    return int(hashlib.sha1(scene.encode()).hexdigest(), 16) % 10_000 / 10_000


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default="megadepth")
    parser.add_argument("--info_dir", type=str, default="scene_info")
    parser.add_argument("--val_fraction", type=float, default=0.02)
    parser.add_argument("--test_scenes", nargs="*", default=["0015", "0022"],
                        help="scenes held out entirely (MegaDepth-1500 overlap)")
    args = parser.parse_args(argv)

    root = settings.DATA_PATH / args.data_dir
    info = root / args.info_dir
    if not info.exists():
        raise FileNotFoundError(f"{info} not found")
    scenes = sorted(p.stem for p in info.glob("*.npz"))
    test = [s for s in scenes if s in set(args.test_scenes)]
    rest = [s for s in scenes if s not in set(args.test_scenes)]
    val = [s for s in rest if bucket(s) < args.val_fraction]
    train = [s for s in rest if s not in set(val)]

    out = root / "scene_lists"
    out.mkdir(exist_ok=True, parents=True)
    (out / "train_scenes_clean.txt").write_text("\n".join(train) + "\n")
    (out / "valid_scenes_clean.txt").write_text("\n".join(val) + "\n")
    (out / "test_scenes_clean.txt").write_text("\n".join(test) + "\n")
    print(f"wrote {len(train)} train / {len(val)} val / {len(test)} test scenes to {out}")


if __name__ == "__main__":
    main()
