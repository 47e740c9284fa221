"""What a window drives: one module a kind of entry, found by name.

A driver has ``run(cell, seed, seconds, trace, device, started) ->
Outcome`` (``portbench/outcome.py``).
"""
