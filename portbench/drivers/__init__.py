"""One driver per kind of configuration (the configuration file's
``driver``).  ``setup(config, traffic, seed, device)`` returns a session
with ``step()`` (one unit of the window's work), ``counters()``,
``end_to_end(window)``, ``stats``, ``release()``, ``check()`` and
``failed_units(checks)``; and ``control_readings(cell, seed, device)``
gives the checks of each stand-in for the program (``portbench.control``)."""
