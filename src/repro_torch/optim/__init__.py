"""Optimizer and gradient compression of the training path: ``adamw``
(AdamW, the warmup + cosine schedule, the global norm) and
``compression`` (per-tensor int8 with error feedback).  Importing the
package imports neither."""
