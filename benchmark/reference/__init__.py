"""Plain references, one module per query: ``answer(tables, params,
precision)`` over the benchmark's own device copy of the generated
columns. They import torch and nothing of the program. ``precision``
is ``"exact"`` (64-bit integers for decimals, float64 for averages)
or ``"float32"``, the control's precision."""
