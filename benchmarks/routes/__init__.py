"""Routes: how a cell drives the program, one module a route.

A traffic file names its route (``"route": "library"``); the harness
imports ``routes/<route>.py`` by that name. A route module defines:

* ``TRACKING``: ``(module, attribute)`` of the program function that the
  route's entry calls to track; in a traced run the harness wraps it to
  time each call as a span and to hand it a ``stage_times``;
* ``warm(ctx)``: the set-up pass, which builds and loads every kernel and
  touches every shape the window uses;
* ``call(ctx, index, out_dir)``: one call of the user entry, which writes
  its tables into ``out_dir``; returns the indices (into ``ctx.paths``)
  of the recordings it was due to process. The check finds which of
  them it delivered; only those count.

``ctx`` carries ``paths`` (the recordings' metadata files), ``source``
(the program's source configuration), ``detector`` (its detector
configuration) and ``device``.
"""
