"""Traffic kinds: the closed loops a traffic file names by its ``kind``.

Each module here has ``setup(ctx) -> state`` (the program's objects for
the cell, warmed up at the cell's own shapes), ``call(ctx, state, i) ->
record`` (one closed-loop call, its answer on the host before it
returns), ``end_to_end(records, window_s) -> {metric: value}`` and
``check(ctx, state, records) -> {number: value}`` (the comparison with
the plain reference, run after the window).
"""
