"""The loops that serve a traffic mix, one per ``kind`` a mix names.

A kind's ``Job(conf, mix, seed, device, fault=None)`` has ``setup()``,
``step(i)`` (one request or step of the window, returning its work units
once its result is complete), ``close_window()`` (frees the program's
state), ``compare()`` (the numbers the cell's limits file holds, from the
plain reference), ``end_to_end(window)`` and ``failed``."""
