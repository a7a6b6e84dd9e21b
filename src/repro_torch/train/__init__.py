"""The training step and loop: ``trainer`` (state, train and eval steps with
microbatches and int8-compressed gradients) and ``loop`` (checkpoints,
failure recovery, straggler watchdog).  Importing the package imports
neither."""
