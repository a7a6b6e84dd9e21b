"""Launchers of the port: ``serve`` (batched prefill + greedy decode) and
``energy_sched`` (a day of LM jobs scheduled on a DVFS fleet)."""
