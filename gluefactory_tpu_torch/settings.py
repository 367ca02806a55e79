"""Path settings (counterpart of `gluefactory_tpu/settings.py`): where
training runs write, overridable by `GLUEFACTORY_TRAINING`."""

import os
from pathlib import Path

root = Path(__file__).parent.parent  # repo root

TRAINING_PATH = Path(os.environ.get("GLUEFACTORY_TRAINING", root / "outputs" / "training"))
