"""Loss function of the inverse problem, for a batch of lineouts or one angular (ARTS) image.

Counterpart of ``tsadar_tpu.inverse.loss``: fit-range windows for the IAW,
EPW-blue and EPW-red features, the loss functionals (l1, l2, log-cosh,
poisson), masked means instead of NaN writes, per-lineout row losses for
best-so-far tracking, and the bound, moment and monotonicity penalties.
Where JAX partitions the parameters into (diff, static) pytrees, the port
marks the active leaves ``requires_grad`` (``core.params.get_filter_spec``)
and ``value_and_grad`` differentiates with ``torch.autograd``; on the card the
backward runs through the hand-written kernels.

The angular arm is the same code on unbatched parameters: ``e_data`` holds the
lineout window of the image in resolution units [n_units, wavelengths].  With a
list ``data.shotnum`` the loss is multiplexed: the batch is ``{"b1", "b2"}``,
two images of one plasma, and the second image's theory is that of the EDF
turned by ``data.shot_rot`` degrees (``utils.vector_tools.rotate_edf``); the
errors of both images are summed.

The scipy interface (``vg_loss``, ``loss``) takes and gives float64 numpy
vectors of the active parameters in JAX's ``ravel_pytree`` order
(``core.params.ravel_order``).  ``array_loss`` is the per-lineout loss of the
postprocess, and ``hvp_rows`` / ``h_loss_wrt_params`` the Hessian of the
sigma loss ``_loss_for_hess_fn_`` over that vector, by a second backward pass
(autograd of autograd): they run on CPU float64 parameters inside
``interp.plain_forms()``, as the JAX package's Hessian runs with its Pallas
kernels disabled.

Inside ``sharded(ranks)`` (a 1D fit whose lineout batch is split between
ranks, ``parallel.dist``) the loss of each rank's rows is the loss of the
whole batch: the masked means' numerators and counts are summed over the
ranks (their shards hold different counts), and so are the penalties' sums
over per-lineout leaves before their non-linear steps (``fe_decrease_strict``'s
tan, the moment losses' means): a sharded fit's parameters are batched, one
entry a lineout in every leaf of the penalties.  The row losses stay the
rank's own.  ``y_norm`` comes from the batch the loss
is built with: the whole batch's.
"""

import contextlib
import math

import numpy as np
import torch

from ..core.diagnostic import ThomsonScatteringDiagnostic
from ..core.params.distributions import act
from ..core.params.ts_params import get_filter_spec, ravel_order
from ..parallel import dist as par
from ..utils import trace
from ..utils.vector_tools import rotate_edf


def _masked_reduce(err, mask, reduce_func, ranks=None):
    """``reduce_func`` over the masked entries (what ``nanmean`` gave the reference); with ``ranks``, over the
    entries of every rank's rows for "mean" and "sum"."""
    if reduce_func in ("mean", "sum"):
        num = torch.sum(torch.where(mask, err, 0.0))
        if ranks is not None:
            num = par.sum_replicated(num, ranks)
        if reduce_func == "sum":
            return num
        den = torch.sum(mask)  # the mask's own entries: an angular [L] mask counts once (JAX's arithmetic)
        if ranks is not None:  # as the working dtype, which every backend reduces (the count is exact in it)
            den = par.sum_replicated(den.to(err.dtype), ranks)
        return num / torch.clamp(den, min=1)
    if reduce_func == "mean_axis1":
        # an unbatched [L] spectrum is one row, so callers can always index a lineout axis
        bmask = torch.atleast_2d(torch.broadcast_to(mask, err.shape))
        num = torch.sum(torch.where(bmask, torch.atleast_2d(err), 0.0), dim=1)
        return num / torch.clamp(torch.sum(bmask, dim=1), min=1)
    raise NotImplementedError(reduce_func)


class LossFunction:
    """Loss of a lineout batch; runs on the GPU unless ``device="cpu"`` is given."""

    def __init__(self, cfg, scattering_angles, dummy_batch, device=None, dtype=None, mode_2v="table"):
        self.cfg, self.mode_2v = cfg, mode_2v
        if cfg["optimizer"]["y_norm"]:
            self.i_norm = float(torch.as_tensor(dummy_batch["i_data"]).max())
            self.e_norm = float(torch.as_tensor(dummy_batch["e_data"]).max())
        else:
            self.i_norm = self.e_norm = 1.0
        # the multiplexed two-shot angular fit: the second image's EDF is turned by data.shot_rot
        self.multiplex_ang = isinstance(cfg["data"].get("shotnum"), list)
        self.ts_diag = ThomsonScatteringDiagnostic(cfg, scattering_angles, device=device, dtype=dtype, mode_2v=mode_2v,
                                                   shard_2v_points=cfg["other"].get("shard_2v_points", False))
        self.scattering_angles, self._dummy_batch, self._host_f64 = scattering_angles, dummy_batch, None
        self.ranks = None  # inside sharded(): the ranks that share the lineout batch

    @contextlib.contextmanager
    def sharded(self, ranks):
        """Inside the block the loss of this rank's rows is the whole batch's (``ranks``: ``parallel.dist.Ranks``;
        None leaves the loss as it is)."""
        prev, self.ranks = self.ranks, ranks
        try:
            yield self
        finally:
            self.ranks = prev

    def host_f64(self):
        """This loss on the CPU in float64 (itself if it is that already): the sigma-Hessian's."""
        if self.ts_diag.device.type == "cpu" and self.ts_diag.dtype == torch.float64:
            return self
        if self._host_f64 is None:
            self._host_f64 = LossFunction(self.cfg, self.scattering_angles, self._dummy_batch, device="cpu",
                                          mode_2v=self.mode_2v)
        return self._host_f64

    def device_batch(self, batch):
        """The batch as tensors on the loss's device (both images of a multiplexed batch): convert once per fit,
        not per call."""
        if self.multiplex_ang:
            return {k: self.ts_diag.device_batch(b) for k, b in batch.items()}
        return self.ts_diag.device_batch(batch)

    # ------------------------------------------------------------------ errors

    def loss_functionals(self, d, t, uncert, method="l2"):
        if method == "l1":
            return torch.abs(d - t) / uncert
        if method == "l2":
            return torch.square(d - t) / uncert
        if method == "log-cosh":
            return torch.log(torch.cosh(d - t))
        if method == "poisson":
            # the floor must survive the working dtype: 1e-300 underflows to 0 in float32
            return t - d * torch.log(torch.clamp(t, min=torch.finfo(t.dtype).tiny))
        raise NotImplementedError(method)

    def calc_ei_error(self, batch, ThryI, lamAxisI, ThryE, lamAxisE, uncert, reduce_func="mean"):
        """Windowed IAW/EPW errors, the masked error arrays, and the per-lineout row means."""
        i_error = e_error = 0.0
        i_data, e_data = batch["i_data"], batch["e_data"]
        i_row = torch.zeros(i_data.shape[0] if i_data.dim() > 1 else 1, dtype=i_data.dtype, device=i_data.device)
        e_row = torch.zeros(e_data.shape[0] if e_data.dim() > 1 else 1, dtype=e_data.dtype, device=e_data.device)
        sqdev = {"ele": torch.zeros_like(e_data), "ion": torch.zeros_like(i_data)}
        fr = self.cfg["data"]["fit_rng"]
        method = self.cfg["optimizer"]["loss_method"]
        opts = self.cfg["other"]["extraoptions"]

        if opts["fit_IAW"]:
            err = self.loss_functionals(i_data, ThryI, uncert[0], method=method)
            mask = ((lamAxisI > fr["iaw_min"]) & (lamAxisI < fr["iaw_cf_min"])) | (
                (lamAxisI > fr["iaw_cf_max"]) & (lamAxisI < fr["iaw_max"])
            )
            i_error = i_error + _masked_reduce(err, mask, reduce_func, self.ranks)
            i_row = i_row + _masked_reduce(err, mask, "mean_axis1")
            sqdev["ion"] = torch.where(mask, err, 0.0)

        if opts["fit_EPWb"]:
            err = self.loss_functionals(e_data, ThryE, uncert[1], method=method)
            mask = (lamAxisE > fr["blue_min"]) & (lamAxisE < fr["blue_max"])
            e_error = e_error + _masked_reduce(err, mask, reduce_func, self.ranks)
            e_row = e_row + _masked_reduce(err, mask, "mean_axis1")
            sqdev["ele"] = sqdev["ele"] + torch.where(mask, err, 0.0)

        if opts["fit_EPWr"]:
            err = self.loss_functionals(e_data, ThryE, uncert[1], method=method)
            mask = (lamAxisE > fr["red_min"]) & (lamAxisE < fr["red_max"])
            e_error = e_error + _masked_reduce(err, mask, reduce_func, self.ranks)
            e_row = e_row + _masked_reduce(err, mask, "mean_axis1")
            if opts["fit_EPWb"]:
                e_error = e_error * 0.5
                e_row = e_row * 0.5
            sqdev["ele"] = sqdev["ele"] + torch.where(mask, err, 0.0)

        return i_error, e_error, sqdev, i_row, e_row

    def calc_loss(self, ts_params, batch, denom, reduce_func="mean"):
        """(total loss, sqdev, ThryE, ThryI, physical parameters, per-lineout row losses)."""
        batch = self.device_batch(batch)
        physical = ts_params()
        if self.multiplex_ang:
            ThryE, ThryI, lamAxisE, lamAxisI = self.ts_diag.spectra(physical, batch["b1"])
            electron = physical["electron"]
            fe = rotate_edf(torch.squeeze(electron["fe"]), torch.squeeze(electron["v"]), self.cfg["data"]["shot_rot"] * math.pi / 180.0)
            ThryE_rot = self.ts_diag.spectra(physical | {"electron": electron | {"fe": fe}}, batch["b2"])[0]
            # as in the JAX package: the first image's ion theory for both, the second image's sqdev, and
            # ``denom`` as given (a multiplexed postprocess, denom None, cannot run there)
            i1, e1, _, ir1, er1 = self.calc_ei_error(batch["b1"], ThryI, lamAxisI, ThryE, lamAxisE, denom, reduce_func)
            i2, e2, sqdev, ir2, er2 = self.calc_ei_error(batch["b2"], ThryI, lamAxisI, ThryE_rot, lamAxisE, denom, reduce_func)
            i_error, e_error, i_row, e_row = i1 + i2, e1 + e2, ir1 + ir2, er1 + er2
        else:
            ThryE, ThryI, lamAxisE, lamAxisI = self.ts_diag.spectra(physical, batch)
            if denom is None:
                denom = [ThryI, ThryE]
            with trace.span("loss.reduce"):
                i_error, e_error, sqdev, i_row, e_row = self.calc_ei_error(
                    batch, ThryI, lamAxisI, ThryE, lamAxisE, denom, reduce_func
                )
        ion_scale = self.cfg["data"]["ion_loss_scale"]
        total_loss = ion_scale * i_error + e_error + self.penalties(physical, ts_params)
        # the (global) penalty term is left out of the per-lineout selection criterion
        row_loss = ion_scale * i_row + e_row
        return total_loss, sqdev, ThryE, ThryI, physical, row_loss

    # -------------------------------------------------------------- interfaces

    def __loss__(self, ts_params, batch):
        """(total loss, [ThryE, physical parameters, row losses]) with the y-normed squared denominators."""
        total_loss, _, ThryE, _, params, row_loss = self.calc_loss(
            ts_params, batch, denom=[self.i_norm**2, self.e_norm**2], reduce_func="mean"
        )
        return total_loss, [ThryE, params, row_loss]

    def value_and_grad(self, ts_params, batch, trainable=None):
        """((loss, aux), {JAX leaf path: gradient}) over the deck's active parameters.

        ``trainable`` is ``get_filter_spec(cfg["parameters"], ts_params)``;
        a loop passes it in so that the leaves are marked once.
        """
        if trainable is None:
            trainable = get_filter_spec(self.cfg["parameters"], ts_params)
        with torch.enable_grad():
            with trace.span("loss.forward"):
                value, aux = self.__loss__(ts_params, batch)
            with trace.span("loss.backward"):
                grads = torch.autograd.grad(value, list(trainable.values()))
        aux = [aux[0].detach(), {g: {k: v.detach() for k, v in d.items()} for g, d in aux[1].items()}, aux[2].detach()]
        return (value.detach(), aux), dict(zip(trainable, grads))

    def post_loss(self, ts_params, batch):
        """Per-lineout loss array for postprocessing: theory-normalized, row means."""
        total_loss, sqdev, ThryE, ThryI, params, _ = self.calc_loss(ts_params, batch, denom=None, reduce_func="mean_axis1")
        return total_loss, sqdev, ThryE, ThryI, params

    def array_loss(self, ts_params, batch):
        """``post_loss`` without autograd's bookkeeping: (per-lineout loss, sqdev, ThryE, ThryI, parameters)."""
        with torch.no_grad():
            return self.post_loss(ts_params, batch)

    # the scipy interface: float64 numpy vectors of the active parameters, in JAX's ravel order

    def vg_loss(self, x, ts_params, batch):
        """(loss, flat gradient) at the flat active parameters ``x``, written into ``ts_params`` first."""
        trainable = get_filter_spec(self.cfg["parameters"], ts_params)
        order = ravel_order(trainable)
        unravel_into(x, [trainable[k] for k in order])
        (value, _), grads = self.value_and_grad(ts_params, batch, trainable)
        return float(value), ravel([grads[k] for k in order])

    def loss(self, x, ts_params, batch):
        """The loss at the flat active parameters ``x`` (scipy without gradients: ``grad_method`` not AD)."""
        trainable = get_filter_spec(self.cfg["parameters"], ts_params)
        unravel_into(x, [trainable[k] for k in ravel_order(trainable)])
        with torch.no_grad():
            return float(self.__loss__(ts_params, batch)[0])

    # the sigma-Hessian

    def _loss_for_hess_fn_(self, ts_params, batch):
        """The sigma loss: the windowed errors summed, each pixel weighed by 1 / (|data| + 1e-10)."""
        batch = self.device_batch(batch)
        ThryE, ThryI, lamAxisE, lamAxisI = self.ts_diag.spectra(ts_params(), batch)
        uncert = [torch.abs(batch["i_data"]) + 1e-10, torch.abs(batch["e_data"]) + 1e-10]
        i_error, e_error, *_ = self.calc_ei_error(batch, ThryI, lamAxisI, ThryE, lamAxisE, uncert, reduce_func="sum")
        return i_error + e_error

    def hvp_rows(self, ts_params, batch, tangents):
        """[T, P]: the Hessian of ``_loss_for_hess_fn_`` over the flat active parameters (ravel order) times each
        tangent of ``tangents`` [T, P], by reverse over reverse (run inside ``interp.plain_forms()``)."""
        trainable = get_filter_spec(self.cfg["parameters"], ts_params)
        leaves = [trainable[k] for k in ravel_order(trainable)]
        tangents = torch.as_tensor(tangents, dtype=leaves[0].dtype, device=leaves[0].device)
        with torch.enable_grad():
            value = self._loss_for_hess_fn_(ts_params, batch)
            grad = torch.cat([g.reshape(-1) for g in torch.autograd.grad(value, leaves, create_graph=True)])
            rows = []
            for v in tangents:
                hv = torch.autograd.grad(grad, leaves, grad_outputs=v, retain_graph=True, allow_unused=True)
                rows.append(torch.cat([(torch.zeros_like(p) if h is None else h).reshape(-1) for p, h in zip(leaves, hv)]))
        return torch.stack(rows).detach()

    def h_loss_wrt_params(self, ts_params, batch):
        """[P, P]: the dense Hessian of ``_loss_for_hess_fn_`` over the flat active parameters, as numpy (the JAX
        package gives it over its whole parameter pytree; here over the vector that the sigmas read)."""
        n = sum(p.numel() for p in get_filter_spec(self.cfg["parameters"], ts_params).values())
        return self.hvp_rows(ts_params, batch, torch.eye(n, dtype=torch.float64)).cpu().numpy()

    # -------------------------------------------------------------- penalties

    def penalties(self, params, ts_module=None):
        """Optional regularization terms; each contributes 0 unless its config flag is set."""
        total = 0.0
        if self.cfg["optimizer"].get("bound_penalty", False) and ts_module is not None:
            total = total + self.bound_penalty(ts_module)
        if self.cfg["optimizer"].get("moment_loss", False):
            total = total + sum(self.moment_penalties(params))
        fe_cfg = self.cfg["parameters"]["electron"]["fe"]
        if fe_cfg.get("fe_decrease_strict", False) and fe_cfg.get("dim", 1) == 1:
            v, fe = params["electron"]["v"], params["electron"]["fe"]
            gradfe = torch.sign(v[..., 1:]) * torch.diff(fe, dim=-1)
            vals = self._summed(torch.sum(torch.where(gradfe > 0.0, gradfe, 0.0)))  # a 1V EDF is per lineout
            total = total + torch.tan(torch.clamp(vals, max=math.pi / 2 - 1e-3))
        return total

    def _summed(self, x):
        """``x``, a sum over this rank's rows, summed over the ranks that share the batch (as it is unsharded)."""
        return x if self.ranks is None else par.sum_replicated(x, self.ranks)

    def _row_mean(self, x):
        """The mean of the per-lineout values ``x`` over the whole batch."""
        if self.ranks is None:
            return torch.mean(x)
        return self._summed(torch.sum(x)) / self._summed(x.new_tensor(float(x.numel())))

    def bound_penalty(self, ts_module):
        """Log-based out-of-bounds penalty on the normalized scalar parameters.

        In-bounds normalized values lie in [0, 1], where ``log(|w - 0.5| + 0.5)
        <= 0`` is relu'd to zero; outside, the penalty grows like ``log|w|``.
        Activated (sigmoid) parameters are measured in their activated [0, 1]
        space, so the penalty is a no-op guard there.  The EDF is left out.
        """
        groups = [ts_module.electron.params, ts_module.general.params] + [ion.params for ion in ts_module.ions]
        total = 0.0
        for g in groups:
            for name, v in g.normed.items():
                w = act(v, g.activated[name])
                total = total + torch.sum(torch.clamp(torch.log(torch.abs(w - 0.5) + 0.5), min=0.0))
        return self._summed(total)  # a sharded fit's groups are batched: every leaf holds one entry a lineout

    def moment_penalties(self, params):
        """(density, temperature, momentum) moment losses of the physical EDF.

        1V: per lineout, the zeroth, second and first moments against 1, 1
        and 0, averaged.  2V (the unbatched [N, N] EDF on the square grid v
        [N]): the zeroth moment against 1, the second moment sum(f |v|^2)
        dv^2 against 2 (unit variance a dimension), and both first moments
        against 0, as the JAX package forms them.
        """
        fe, v = params["electron"]["fe"], params["electron"]["v"]
        if self.cfg["parameters"]["electron"]["fe"].get("dim", 1) == 2:
            dv = v[1] - v[0]
            density_loss = torch.square(1.0 - torch.sum(fe) * dv**2)
            vsq = v[:, None] ** 2 + v[None, :] ** 2
            temperature_loss = torch.square(1.0 - torch.sum(fe * vsq) * dv**2 / 2.0)
            momentum_loss = torch.square(torch.sum(fe * v[:, None]) * dv**2) + torch.square(torch.sum(fe * v[None, :]) * dv**2)
            return density_loss, temperature_loss, momentum_loss
        dv = (v[..., 1] - v[..., 0])[..., None]
        density_loss = self._row_mean(torch.square(1.0 - torch.sum(fe * dv, dim=-1)))
        temperature_loss = self._row_mean(torch.square(1.0 - torch.sum(fe * v**2 * dv, dim=-1)))
        momentum_loss = self._row_mean(torch.square(torch.sum(fe * v * dv, dim=-1)))
        return density_loss, temperature_loss, momentum_loss


def ravel(tensors):
    """The tensors flattened and joined, as a float64 numpy vector (the scipy side)."""
    return torch.cat([t.detach().reshape(-1) for t in tensors]).double().cpu().numpy()


def unravel_into(x, leaves):
    """Write the flat float64 vector ``x`` into ``leaves`` in order, in their own dtype and device."""
    x = torch.from_numpy(np.asarray(x, dtype=np.float64)).to(device=leaves[0].device, dtype=leaves[0].dtype)
    with torch.no_grad():
        start = 0
        for p in leaves:
            p.copy_(x[start : start + p.numel()].view_as(p))
            start += p.numel()
    if start != x.numel():
        raise ValueError(f"a vector of {x.numel()} values for {start} parameters")
