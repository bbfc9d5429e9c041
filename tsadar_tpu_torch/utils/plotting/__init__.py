"""The figures of a run, and the one rule for whether they can be drawn.

The figures are the JAX package's (``tsadar_tpu.utils.plotting`` and
``tsadar_tpu.utils.data_handling.data_visualizer``), drawn with matplotlib on
the host from numpy arrays: ``plotters``, ``lineout_plot``, ``edf_movie`` and
``utils.data_handling.data_visualizer``.  matplotlib is imported here alone,
lazily and once, never when a module is imported: the card's machine has no
matplotlib, and the port runs there all the same.

* ``available()``: whether matplotlib can be imported, with the
  ``ImportError``'s text where it cannot;
* ``figures()``: whether the caller draws the run's figures now, asked by
  every caller (the postprocess, the forward and series modes, the data
  preparation).  Figures are kept only as a run's artifacts, so they are
  drawn where a run is open in this process (the writing rank's,
  ``mlflow_shim.writer``) and matplotlib imports.  The open run is told once:
  its tag ``figures`` says ``drawn`` or ``not drawn: <reason>``, and a run
  whose figures cannot be drawn also logs one line naming the missing module;
* ``mpl()`` and ``subplots()``: matplotlib for the figure functions, which
  draw on ``matplotlib.figure.Figure`` objects (no pyplot, no global figure
  state, no backend to choose).  A figure function called where matplotlib
  cannot be imported raises the ``ImportError``.
"""

from .. import mlflow_shim as mlflow
from ..console import log_info

DRAWN = "drawn"

_import = {}  # the one attempt's outcome: {"error": None or the ImportError}
_told = set()  # the runs whose tag is set


def _attempt():
    if "error" not in _import:
        try:
            import matplotlib
            import matplotlib.animation
            import matplotlib.colors
            import matplotlib.figure

            _import.update(error=None, module=matplotlib)
        except ImportError as e:
            _import.update(error=e, module=None)
    return _import


def available():
    """``(True, "")`` where matplotlib can be imported, else ``(False, the ImportError's text)``."""
    error = _attempt()["error"]
    return error is None, "" if error is None else str(error)


def mpl():
    """The ``matplotlib`` package with its ``figure``, ``colors`` and ``animation`` modules loaded; raises the
    ``ImportError`` where it cannot be imported."""
    state = _attempt()
    if state["error"] is not None:
        error = state["error"]
        raise ImportError(str(error), name=error.name, path=error.path)
    return state["module"]


def subplots(*args, figsize=None, tight_layout=None, **kw):
    """``(figure, axes)`` as ``matplotlib.pyplot.subplots(*args, figsize=, tight_layout=, **kw)`` makes them, on a
    ``Figure`` of its own."""
    fig = mpl().figure.Figure(figsize=figsize, tight_layout=tight_layout)
    return fig, fig.subplots(*args, **kw)


def figures():
    """Whether the caller draws the open run's figures: a run is open in this process and matplotlib imports.

    The open run is tagged once, ``figures``: ``drawn`` or ``not drawn: <the ImportError's text>``; a run
    whose figures cannot be drawn logs that once too.
    """
    ok, reason = available()
    run = mlflow.active_run()
    if run is None:
        return False
    if run.info.run_id not in _told:
        _told.add(run.info.run_id)
        mlflow.set_tag("figures", DRAWN if ok else f"not drawn: {reason}")
        if not ok:
            log_info(f"figures not drawn: matplotlib cannot be imported ({reason})")
    return ok
