"""Traffic: each mix a data file (``<mix>.json``: the generator that reads
it and its parameters), each generator a module (``<driver>.py``) with a
``Driver(cell, device)`` that sets up the cell, ``run(seconds, tracer)``
the measured window and ``check(window)`` the numbers compared with the
cell's limits."""
