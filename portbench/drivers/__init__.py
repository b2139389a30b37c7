"""Drivers, one module per kind of traffic mix: a mix file's ``kind``
names ``portbench/drivers/<kind>.py``, which ``registry.driver`` finds by
that name. A driver module holds a class ``Cell(cfg, mix, seed, device,
trace=False)`` that ``run.run_cell`` drives so:

* ``setup()``: everything before the window (counted in ``setup_s``);
  ``phases`` is a dict of its parts' seconds;
* ``window(seconds)``: the measured window; returns a dict with at least
  ``seconds``, ``attempted`` and ``failed``, which the metric readers
  read as ``ctx.window``; with ``trace`` the driver sets
  ``trace_summary`` (``trace.summarize``'s dict), else leaves it None;
* ``close()``: reads what it needs of the program and frees its state;
* ``judge()``: the numbers compared with the cell's limits
  (``portbench/limits/<workload>.json``), against the plain reference;
* ``context()``: a dict of what the metric readers read besides
  ``setup_s``, ``window``, ``memory_peak_bytes``, ``trace`` and
  ``config``.
"""
