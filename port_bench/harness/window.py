"""The measured window: whole units of work back to back.

A window ends with the first unit that finishes once ``seconds`` have passed
since it opened.  Its rate is every unit's time over the count of units, so
no unit is cut and no median of pieces is taken.
"""

import time


def run_window(unit, seconds, clock=time.perf_counter, between=None):
    """Call ``unit(i)`` for i = 0, 1, ... until ``seconds`` have passed at the end of a unit.

    ``unit`` returns once its work is done on the device as well (it reads its
    result back).  ``between(i)``, if given, runs before unit i and is timed
    with it (it is where a traced run starts and stops its profiler).
    Returns (results, [(start, end) of each unit], window seconds).
    """
    results, spans = [], []
    t_open = clock()
    while True:
        i = len(results)
        if between is not None:
            between(i)
        t0 = clock()
        results.append(unit(i))
        spans.append((t0, clock()))
        if spans[-1][1] - t_open >= seconds:
            break
    if between is not None:
        between(len(results))
    return results, spans, spans[-1][1] - t_open


def per_unit(window_s, n_units):
    """The window's seconds over its whole units."""
    if n_units < 1:
        raise ValueError("a window holds at least one whole unit")
    return window_s / n_units
