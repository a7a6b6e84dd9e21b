"""Launchers of the port: ``serve`` (batched prefill + greedy decode),
``train`` (the training loop) and ``energy_sched`` (a day of LM jobs
scheduled on a DVFS fleet); ``mesh`` builds their device meshes."""
