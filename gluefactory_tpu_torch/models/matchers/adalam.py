"""AdaLAM matcher placeholder (counterpart of
`gluefactory_tpu/models/matchers/adalam.py`, itself a placeholder, as the
reference's is): no model."""
