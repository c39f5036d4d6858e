"""One traffic driver per kind of entry into the program.

A traffic file (``traffic/<name>.json``) names its driver; the driver's
``Driver(ctx)`` sets the program up and warms every shape its traffic
uses, ``measure()`` runs the window and returns the counters the metric
readers read, ``release()`` drops the program's state, and ``check()``
returns the numbers compared with the cell's limits."""

WEIGHTS, INPUTS, TRAFFIC = 0, 1, 2  # streams of the run's seed (inputs.child_seed)
