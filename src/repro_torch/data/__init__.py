"""Training data: ``pipeline`` (the deterministic synthetic LM stream, numpy
only).  Importing the package imports it not."""
