"""Path settings (counterpart of `gluefactory_tpu/settings.py`): where
datasets are read (`GLUEFACTORY_DATA`), training runs write
(`GLUEFACTORY_TRAINING`) and evals write (`GLUEFACTORY_EVAL`)."""

import os
from pathlib import Path

root = Path(__file__).parent.parent  # repo root

DATA_PATH = Path(os.environ.get("GLUEFACTORY_DATA", root / "data"))
TRAINING_PATH = Path(os.environ.get("GLUEFACTORY_TRAINING", root / "outputs" / "training"))
EVAL_PATH = Path(os.environ.get("GLUEFACTORY_EVAL", root / "outputs" / "results"))
