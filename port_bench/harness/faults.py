"""Faults planted underneath the timed path, each of which the correctness check has to catch.

Each is a context manager that patches the program (``tsadar_tpu_torch``) in
this process and puts it back on exit:

* ``state_unchanged``: every optimizer step leaves the parameters as they were;
* ``half_batch``: the loss's masked means leave out the second half of the rows
  and take the mean over the rest;
* ``answer_altered``: the answer is changed where it is produced: the 1D fit loop returns
  every eighth lineout's normed Te moved by 0.2; a run's files give its fitted Te 5 % high.
"""

import contextlib

import numpy as np


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def state_unchanged():
    from tsadar_tpu_torch.inverse import loops

    real = loops.optimizer

    def frozen(method, leaves, lr):
        opt = real(method, leaves, lr)
        opt.step = lambda *args, **kwargs: None
        return opt

    with patched(loops, "optimizer", frozen):
        yield


@contextlib.contextmanager
def half_batch():
    import torch

    from tsadar_tpu_torch.inverse import loss

    real = loss._masked_reduce

    def halved(err, mask, reduce_func, ranks=None):
        if reduce_func == "mean" and err.dim() == 2 and err.shape[0] > 1:
            keep = torch.arange(err.shape[0], device=err.device)[:, None] < err.shape[0] // 2
            mask = torch.broadcast_to(mask, err.shape) & keep
        return real(err, mask, reduce_func, ranks)

    with patched(loss, "_masked_reduce", halved):
        yield


@contextlib.contextmanager
def answer_altered():
    import torch

    from tsadar_tpu_torch.inverse import loops
    from tsadar_tpu_torch.utils import artifacts

    real_1d, real_file = loops._1d_adam_loop_, artifacts.get_final_params

    def moved_1d(*args, **kwargs):
        best_loss, weights = real_1d(*args, **kwargs)
        with torch.no_grad():
            weights.electron.params.normed["Te"][::8] += 0.2
        return best_loss, weights

    def moved_file(config, all_params, *args, **kwargs):
        all_params = {g: dict(v) for g, v in all_params.items()}
        te = all_params["electron"]["Te"]  # one array a batch (a list for an image's fit)
        all_params["electron"]["Te"] = [np.asarray(t) * 1.05 for t in te] if isinstance(te, list) else np.asarray(te) * 1.05
        return real_file(config, all_params, *args, **kwargs)

    with patched(loops, "_1d_adam_loop_", moved_1d), patched(artifacts, "get_final_params", moved_file):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch, "answer_altered": answer_altered}
