"""L-BFGS with a zoom line search on one flat parameter vector: ``optax.lbfgs()`` in torch.

A transcription of what ``optax.lbfgs()`` builds (optax 0.2.6), with the
defaults of that call: ``scale_by_lbfgs`` (a memory of 10 differences, the
two-loop recursion, the identity scaled by the last secant pair and, at the
first step, by min(1, 1 / |g|)), then ``scale(-1)``, then
``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one")``: Nocedal and Wright's interval search and zoom
(Algorithms 3.5 and 3.6) with cubic, quadratic and bisection steps and their
safeguards, the Armijo test or Hager and Zhang's approximate decrease test
(``approx_dec_rtol`` 1e-6), the curvature test, and the fallback to the best
step with sufficient decrease when the search fails.  The value and gradient
that the line search ends on are kept and reused at the next step, as
``optax.value_and_grad_from_state`` does: a step costs one evaluation per
line-search trial and no more.

The parameters are one flat tensor (JAX's ``ravel_pytree`` order for a fit,
``core.params.ravel_order``) on the loss's device; the vectors of the memory
live there too, and the memory update and the two-loop recursion run there
without reading anything back.  The line search's branch decisions read its
scalars (the trial's value and slope) on the host, in float64: so this
"device" L-BFGS has no scipy round trip, but it synchronizes once per
line-search trial.  The JAX package takes a backtracking line search on the
TPU only, where zoom's nested loops fault that runtime; the port takes zoom on
every device.

Every inner product goes through ``dot`` (``torch.dot`` unless the caller
gives another): a fit whose vector is split between ranks passes the product
over all of them (``parallel.dist.global_dot``), so that each rank takes the
unsharded steps on its own rows.
"""

import math
from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4  # sufficient decrease (Armijo)
CURV_RTOL = 0.9  # small curvature
APPROX_DEC_RTOL = 1e-6  # Hager and Zhang's approximate decrease
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5  # the zoom's interval threshold
TOL = 0.0


@dataclass
class LBFGSState:
    """``scale_by_lbfgs``'s state and the line search's result of the last step."""

    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params: torch.Tensor  # [memory, n]
    diff_updates: torch.Tensor  # [memory, n]
    weights: torch.Tensor  # [memory]
    value: float = math.inf  # value and gradient where the last line search ended
    grad: torch.Tensor = None
    learning_rate: float = 1.0
    linesearch_steps: int = 0


def init(x, memory_size=MEMORY_SIZE):
    """The state before the first step at the flat parameters ``x``."""
    zeros = torch.zeros((memory_size,) + x.shape, dtype=x.dtype, device=x.device)
    return LBFGSState(
        count=0, params=torch.zeros_like(x), updates=torch.zeros_like(x), diff_params=zeros,
        diff_updates=zeros.clone(), weights=torch.zeros(memory_size, dtype=x.dtype, device=x.device),
        grad=torch.zeros_like(x),
    )


def _precondition(updates, dw_mem, du_mem, rhos, identity_scale, memory_idx, dot=torch.dot):
    """The two-loop recursion: the memory's inverse-Hessian estimate times ``updates``."""
    m = rhos.shape[0]
    indices = [(memory_idx + i) % m for i in range(m)]
    vec, alphas = updates, [None] * m
    for j in reversed(range(m)):  # newest to oldest
        i = indices[j]
        alphas[j] = rhos[i] * dot(dw_mem[i], vec)
        vec = vec - alphas[j] * du_mem[i]
    vec = identity_scale * vec
    for j in range(m):  # oldest to newest
        i = indices[j]
        beta = rhos[i] * dot(du_mem[i], vec)
        vec = vec + (alphas[j] - beta) * dw_mem[i]
    return vec


def scale_by_lbfgs(grad, state, x, dot=None):
    """(preconditioned gradient, the state's memory after this step's secant pair); ``dot``: the inner product
    (default ``torch.dot``, and the norm ``vector_norm``)."""
    norm = torch.linalg.vector_norm if dot is None else (lambda v: torch.sqrt(dot(v, v)))  # noqa: E731
    dot = torch.dot if dot is None else dot
    m = state.weights.shape[0]
    memory_idx, prev_idx = state.count % m, (state.count - 1) % m
    dw, du = x - state.params, grad - state.updates
    vdot = dot(du, dw)
    weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
    if state.count == 0:  # no secant pair yet
        dw, du, weight = torch.zeros_like(dw), torch.zeros_like(du), torch.zeros_like(weight)
    dw_mem, du_mem, rhos = state.diff_params.clone(), state.diff_updates.clone(), state.weights.clone()
    dw_mem[prev_idx], du_mem[prev_idx], rhos[prev_idx] = dw, du, weight

    if state.count > 0:
        denominator = dot(du, du)
        identity_scale = torch.where(denominator > 0.0, dot(du, dw) / denominator, torch.ones_like(denominator))
    else:  # the first step's trust region: a ball of radius 1
        identity_scale = torch.clamp(1.0 / norm(grad), max=1.0)
    precond = _precondition(grad, dw_mem, du_mem, rhos, identity_scale, memory_idx, dot)
    return precond, replace(state, count=state.count + 1, params=x, updates=grad, diff_params=dw_mem,
                            diff_updates=du_mem, weights=rhos)


# ------------------------------------------------------------------ the zoom line search


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """A critical point of the cubic through (a, fa), (b, fb), (c, fc) with slope fpa at a; NaN if none."""
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb, c, fc = map(np.float64, (a, fa, fpa, b, fb, c, fc))
        C = fpa
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        r0, r1 = fb - fa - C * db, fc - fa - C * dc
        A = (dc**2 * r0 + -(db**2) * r1) / denom
        B = (-(dc**3) * r0 + db**3 * r1) / denom
        radical = B * B - 3.0 * A * C
        return float(a + (-B + np.sqrt(radical)) / (3.0 * A))


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with slope fpa at a."""
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb = map(np.float64, (a, fa, fpa, b, fb))
        db = b - a
        B = (fb - fa - fpa * db) / (db**2)
        return float(a - fpa / (2.0 * B))


def _nan_to_inf(x):
    return math.inf if math.isnan(x) else x


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    """The Armijo error, or Hager and Zhang's approximate one near a minimum, whichever is smaller; >= 0."""
    error = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    approx = _fmax(approx, value_step - value_init - APPROX_DEC_RTOL * abs(value_init))
    return _nan_to_inf(_fmax(_fmin(approx, error), 0.0))


def _curvature_error(slope_step, slope_init):
    return _nan_to_inf(_fmax(abs(slope_step) - CURV_RTOL * abs(slope_init), 0.0))


def _fmax(a, b):
    """jnp.maximum: NaN if either is NaN."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def _fmin(a, b):
    return math.nan if math.isnan(a) or math.isnan(b) else min(a, b)


@dataclass
class _Search:
    """The zoom line search's state (optax's ``ZoomLinesearchState``); scalars on the host."""

    count: int
    stepsize_guess: float
    stepsize: float
    value: float
    grad: torch.Tensor
    slope: float
    value_init: float
    slope_init: float
    decrease_error: float = math.inf
    curvature_error: float = math.inf
    interval_found: bool = False
    done: bool = False
    failed: bool = False
    low: float = 0.0
    value_low: float = 0.0
    slope_low: float = 0.0
    high: float = 0.0
    value_high: float = 0.0
    slope_high: float = 0.0
    cubic_ref: float = 0.0
    value_cubic_ref: float = 0.0
    safe_stepsize: float = 0.0
    safe_value: float = 0.0
    safe_grad: torch.Tensor = None


def _on_line(value_and_grad, x, stepsize, d, dot=torch.dot):
    """(value, gradient, slope) at x + stepsize d; the host reads the value and the slope."""
    value, grad = value_and_grad(x + stepsize * d)
    return float(value), grad, float(dot(grad, d))


def _search_interval(s, value_and_grad, x, d, dot=torch.dot):
    """Algorithm 3.5 of Nocedal and Wright: grow the step until an interval holds an acceptable one."""
    new_stepsize = s.stepsize_guess if s.count == 0 else INCREASE_FACTOR * s.stepsize
    new_value, new_grad, new_slope = _on_line(value_and_grad, x, new_stepsize, d, dot)
    dec = _decrease_error(new_stepsize, new_value, new_slope, s.value_init, s.slope_init)
    curv = _curvature_error(new_slope, s.slope_init)
    new_error = max(dec, curv)
    safe = dec <= TOL
    set_high = dec > 0.0 or (new_value >= s.value and s.count > 0)
    set_low = new_slope >= 0.0 and not set_high
    if set_low:
        low, value_low, slope_low = new_stepsize, new_value, new_slope
        high, value_high, slope_high = s.stepsize, s.value, s.slope
    else:
        low, value_low, slope_low = s.stepsize, s.value, s.slope
        high, value_high, slope_high = new_stepsize, new_value, new_slope
    interval_found = set_high or set_low or new_error <= TOL
    done = new_error <= TOL  # no maximal step size: the search grows until it finds an interval
    return replace(
        s, count=s.count + 1, stepsize=new_stepsize, value=new_value, grad=new_grad, slope=new_slope,
        decrease_error=dec, curvature_error=curv, interval_found=interval_found, done=done,
        failed=(s.count + 1 >= MAX_LINESEARCH_STEPS) and not done,
        low=low, value_low=value_low, slope_low=slope_low, high=high, value_high=value_high, slope_high=slope_high,
        cubic_ref=low, value_cubic_ref=value_low,
        safe_stepsize=new_stepsize if safe else s.safe_stepsize, safe_value=new_value if safe else s.safe_value,
        safe_grad=new_grad if safe else s.safe_grad,
    )


def _zoom_into_interval(s, value_and_grad, x, d, dot=torch.dot):
    """Algorithm 3.6 of Nocedal and Wright: shrink the interval by a cubic, quadratic or bisection step."""
    low, high = s.low, s.high
    delta = abs(high - low)
    left, right = min(high, low), max(high, low)
    too_small = delta <= STEPSIZE_PRECISION
    middle_cubic = _cubicmin(low, s.value_low, s.slope_low, high, s.value_high, s.cubic_ref, s.value_cubic_ref)
    if left + 0.2 * delta < middle_cubic < right - 0.2 * delta:
        middle = middle_cubic
    else:
        middle_quad = _quadmin(low, s.value_low, s.slope_low, high, s.value_high)
        if left + 0.1 * delta < middle_quad < right - 0.1 * delta:
            middle = middle_quad
        else:
            middle = (low + high) / 2.0

    value_middle, grad_middle, slope_middle = _on_line(value_and_grad, x, middle, d, dot)
    dec = _decrease_error(middle, value_middle, slope_middle, s.value_init, s.slope_init)
    curv = _curvature_error(slope_middle, s.slope_init)
    new_error = max(dec, curv)
    update_safe = dec <= TOL and value_middle < s.safe_value
    done = new_error <= TOL

    set_high_to_middle = dec > 0.0 or value_middle >= s.value_low
    set_high_to_low = slope_middle * (high - low) >= 0.0 and not set_high_to_middle
    new_high, new_value_high, new_slope_high = high, s.value_high, s.slope_high
    if set_high_to_middle:
        new_high, new_value_high, new_slope_high = middle, value_middle, slope_middle
    if set_high_to_low:
        new_high, new_value_high, new_slope_high = low, s.value_low, s.slope_low
    new_low, new_value_low, new_slope_low = low, s.value_low, s.slope_low
    if not set_high_to_middle:
        new_low, new_value_low, new_slope_low = middle, value_middle, slope_middle
    if set_high_to_middle or set_high_to_low:
        cubic_ref, value_cubic_ref = high, s.value_high
    else:
        cubic_ref, value_cubic_ref = low, s.value_low
    new_safe_stepsize = middle if update_safe else s.safe_stepsize
    presumably_failed = s.count + 1 >= MAX_LINESEARCH_STEPS or (too_small and new_safe_stepsize > 0.0)
    return replace(
        s, count=s.count + 1, stepsize=middle, value=value_middle, grad=grad_middle, slope=slope_middle,
        decrease_error=dec, curvature_error=curv, done=done, failed=presumably_failed and not done,
        low=new_low, value_low=new_value_low, slope_low=new_slope_low,
        high=new_high, value_high=new_value_high, slope_high=new_slope_high,
        cubic_ref=cubic_ref, value_cubic_ref=value_cubic_ref,
        safe_stepsize=new_safe_stepsize, safe_value=value_middle if update_safe else s.safe_value,
        safe_grad=grad_middle if update_safe else s.safe_grad,
    )


def _try_safe_step(s):
    """optax's fallback when the search fails: the best step with sufficient decrease found, if any."""
    if s.safe_stepsize > 0.0 or math.isinf(s.decrease_error):
        return replace(s, stepsize=s.safe_stepsize, value=s.safe_value, grad=s.safe_grad)
    return s


def zoom_linesearch(value_and_grad, x, d, value, grad, stepsize_guess=1.0, dot=torch.dot):
    """The zoom line search along ``d`` from ``x`` (value, gradient given there): its final state."""
    slope = float(dot(d, grad))
    s = _Search(count=0, stepsize_guess=stepsize_guess, stepsize=0.0, value=value, grad=grad, slope=slope,
                value_init=value, slope_init=slope, value_low=value, slope_low=slope, value_high=value,
                slope_high=slope, value_cubic_ref=value, safe_value=value, safe_grad=grad)
    while not (s.done or s.failed):
        s = (_zoom_into_interval if s.interval_found else _search_interval)(s, value_and_grad, x, d, dot)
        if s.failed:
            s = _try_safe_step(s)
    return s


def step(x, state: LBFGSState, value_and_grad: Callable, dot=None):
    """One L-BFGS step: ``(x_next, value at x, state)``; ``dot``: the inner product (default ``torch.dot``).

    ``value_and_grad(x) -> (scalar tensor, flat gradient)``.  The value and
    gradient at ``x`` are the ones the last line search ended on, unless that
    value is not finite (the first step): then they are evaluated.
    """
    if math.isfinite(state.value):
        value, grad = state.value, state.grad
    else:
        value, grad = value_and_grad(x)
        value = float(value)
    precond, state = scale_by_lbfgs(grad, state, x, dot)
    d = -precond
    s = zoom_linesearch(value_and_grad, x, d, value, grad, stepsize_guess=1.0, dot=dot or torch.dot)
    state = replace(state, value=s.value, grad=s.grad, learning_rate=s.stepsize, linesearch_steps=s.count)
    return x + s.stepsize * d, value, state
