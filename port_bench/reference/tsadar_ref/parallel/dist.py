"""The reference runs in one process: no rank shares its work (``sharded`` is never entered)."""


def point_ranks():
    return None


def _one_process(*args, **kwargs):
    raise NotImplementedError("the reference runs in one process")


sum_replicated = scatter_points = replicated_input = gather_points = _one_process
