"""What the benchmark's correctness check asks of the reference: data, losses, adam steps and sigmas.

Everything here runs the frozen copy ``tsadar_ref`` (plain PyTorch, float64 by
default) from the deck and the shot file alone.  The program's answers reach
it only as numpy arrays to be judged: a state dict of fitted leaves, or the
fitted values a run wrote to its CSV.
"""

import copy
import math

import numpy as np
import torch

from .tsadar_ref.core.params.ts_params import ThomsonParams, get_filter_spec, ravel_order
from .tsadar_ref.inverse.loss import LossFunction
from .tsadar_ref.utils.process.batches import angular_batch
from .tsadar_ref.utils.process.prepare import prepare_data

ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}  # optax.adam's defaults, which the deck's "adam" names


def lineout_selection(deck):
    """The deck's pixels ``data.lineouts.val`` from start/end/skip, trimmed to whole batches."""
    sel = deck["data"]["lineouts"]
    pixels = list(range(sel["start"], sel["end"], sel["skip"]))
    bs = deck["optimizer"]["batch_size"]
    sel["val"] = pixels[: len(pixels) - len(pixels) % bs]
    return deck


class Problem:
    """One deck's fit problem as the reference sees it: the prepared data, the scattering angles, the loss.

    ``angular`` decks are cut to their resolution-unit window and fitted as one unbatched image.
    """

    def __init__(self, deck, device, dtype=torch.float64):
        self.cfg = lineout_selection(copy.deepcopy(deck))
        self.angular = "angular" in self.cfg["other"]["extraoptions"]["spectype"]
        self.all_data, self.sa, _ = prepare_data(self.cfg, self.cfg["data"]["shotnum"])
        self.device, self.dtype = torch.device(device), dtype
        if self.angular:
            self.cfg["optimizer"]["batch_size"] = 1
            lineouts, unit = self.cfg["data"]["lineouts"], self.cfg["other"]["ang_res_unit"]
            lineouts["start"], lineouts["end"] = int(lineouts["start"] / unit), int(lineouts["end"] / unit)
            self.batch = angular_batch(self.all_data, slice(lineouts["start"], lineouts["end"]))
        else:
            d = self.all_data
            self.batch = {"e_data": d["e_data"], "e_amps": d["e_amps"], "i_data": d["i_data"], "i_amps": d["i_amps"],
                          "noise_e": d["noiseE"], "noise_i": d["noiseI"]}
        self.n = 1 if self.angular else len(self.cfg["data"]["lineouts"]["val"])
        self.loss_fn = LossFunction(self.cfg, self.sa, self.batch, device=device, dtype=dtype)
        self.device_batch = self.loss_fn.device_batch(self.batch)

    def params(self, values=None, state=None):
        """Parameters from the deck's start values, with ``values`` ({(group, name): value}) put in their place
        first, and then, if given, the leaves of ``state`` ({leaf: numpy array}) loaded over them."""
        cfg = copy.deepcopy(self.cfg["parameters"])
        for (group, name), v in (values or {}).items():
            entry = cfg[group]["fe"]["params"][name] if name == "m" else cfg[group][name]
            entry["val"] = float(v)
        p = ThomsonParams.create(cfg, self.n, activate=True, device=self.device, dtype=self.dtype, batch=not self.angular)
        if state is not None:
            p.load_state_dict({k: torch.as_tensor(np.asarray(v), dtype=self.dtype, device=self.device)
                               for k, v in state.items()}, strict=False)
        return p

    def params_at(self, fitted):
        """Parameters whose values are ``fitted`` ({(group, name): value}, as a run's CSV file gives them): each
        normed leaf is the exact logit of its value, where the deck's start values went through the stabilized
        logit that ``ThomsonParams.create`` applies."""
        p = self.params()
        with torch.no_grad():
            for (group, name), v in fitted.items():
                module = getattr(p, group)
                if name == "m":
                    dist = module.distribution_functions
                    x = (v - dist.m_shift) / dist.m_scale
                    dist.normed_m.fill_(math.log(x / (1.0 - x)))
                else:
                    grp = module.params
                    x = (v - grp.shifts[name]) / grp.scales[name]
                    grp.normed[name].fill_(math.log(x / (1.0 - x)))
        return p

    def loss(self, params):
        """The loss of ``params``."""
        with torch.no_grad():
            return float(self.loss_fn.__loss__(params, self.device_batch)[0])

    def answer_losses(self, params):
        """The postprocess's per-row losses of ``params`` (theory-normalized row means), as numpy."""
        return self.loss_fn.array_loss(params, self.device_batch)[0].double().cpu().numpy().reshape(-1)

    def fit(self, params, lr, epochs, chunk=8):
        """A whole adam fit from ``params`` (changed in place to the best): (every counted pre-update loss, params).

        The fit loops' semantics: each step's pre-update loss is credited to the post-update parameters and the
        best so far is kept; an image's fit replays the angular loop's stop rules over each chunk of ``chunk``
        steps (more than five improvements under 1e-6 in a row, or more than five rising epochs, end it).
        """
        trainable = get_filter_spec(self.cfg["parameters"], params)
        leaves = list(trainable.values())
        m = [torch.zeros_like(p) for p in leaves]
        v = [torch.zeros_like(p) for p in leaves]
        best_loss, best = (100.0 if self.angular else math.inf), [p.detach().clone() for p in leaves]
        counted, seen, stalled, rising, t, stop = [], 100.0, 0, 0, 0, False
        while t < epochs and not stop:
            chunk_losses = []
            for _ in range(min(chunk, epochs - t)):
                t += 1
                (value, _), grads = self.loss_fn.value_and_grad(params, self.device_batch, trainable)
                with torch.no_grad():
                    for p, g, mi, vi in zip(leaves, grads.values(), m, v):
                        g = g.to(p.dtype)
                        mi.mul_(ADAM["b1"]).add_(g, alpha=1 - ADAM["b1"])
                        vi.mul_(ADAM["b2"]).addcmul_(g, g, value=1 - ADAM["b2"])
                        p.sub_(lr * (mi / (1 - ADAM["b1"] ** t)) / ((vi / (1 - ADAM["b2"] ** t)).sqrt() + ADAM["eps"]))
                value = float(value)
                if value < best_loss:
                    best_loss, best = value, [p.detach().clone() for p in leaves]
                chunk_losses.append(value)
            n_counted = len(chunk_losses)
            for j, loss in enumerate(chunk_losses if self.angular else ()):
                if loss < seen:
                    stalled, rising = (stalled + 1, rising) if seen - loss < 1e-6 else (0, 0)
                    seen, stop = loss, stalled > 5
                elif loss > seen:
                    rising += 1
                    stop = rising > 5
                if stop:
                    n_counted = j + 1
                    break
            counted += chunk_losses[:n_counted]
        with torch.no_grad():
            for p, b in zip(leaves, best):
                p.copy_(b)
        return counted, params

    def sigmas(self, params):
        """[P] sigmas of one unbatched image: sign(diag) sqrt(|diag|) of the inverse of the sigma-loss Hessian over
        the active parameters, on the CPU in float64."""
        host = LossFunction(self.cfg, self.sa, self.batch, device="cpu", dtype=torch.float64)
        p64 = copy.deepcopy(params).to(device="cpu", dtype=torch.float64)
        batch64 = {k: np.asarray(v, dtype=np.float64) for k, v in self.batch.items()}
        n = sum(q.numel() for q in get_filter_spec(self.cfg["parameters"], p64).values())
        hess = host.hvp_rows(p64, batch64, torch.eye(n, dtype=torch.float64)).numpy()
        inv = np.diag(np.linalg.inv(hess))
        return np.sign(inv) * np.sqrt(np.abs(inv))

    def active_order(self, params):
        return ravel_order(get_filter_spec(self.cfg["parameters"], params))
