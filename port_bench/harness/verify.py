"""The comparison that decides ``correct``: what the window's units produced, against the plain reference.

For each checked unit (the window's first and one more drawn from the seed) the
reference (``reference/fits.py``: the frozen plain copy, float64, on the card
once the program's state is freed) prepares the deck's data anew from the shot
file, starts from the unit's own start values and reads:

* ``loss_steps``: the widest relative gap between the program's pre-update losses of
  the first three adam steps (the unit's own record) and the reference's three steps;
* ``final_loss`` (fits): the relative gap between the program's best loss and the
  reference's loss at the parameters the program returned;
* ``answer_loss`` (runs): the relative gap between the losses the run's postprocess
  reports at its fitted parameters (its record's ``losses``) and the reference's at
  the values of the run's CSV file.  A run's best loss is credited to the parameters
  one adam step later, and the ARTS loss moves by up to a quarter in a step near its
  end, so a run is judged where it evaluates its own answer;
* ``fit_drop``: the reference's loss at the returned parameters over its loss at the start
  (1 where nothing moved);
* ``sigmas_bad`` (runs): the sigmas of the run's files (``binary/sigmas_fe.npz``) that are
  not finite or are zero, and 1 more where the Hessian failed; ``sigmas_gap`` (runs, not
  compared): their widest relative gap to the reference's float64 Hessian sigmas at the
  values of the run's CSV file.  Those values are float32, and the Hessian's condition
  (~2e6) turns their rounding into gaps of order 1, so the gap is printed, not judged.

A unit that raised, or a number that is not finite, is not correct.
"""

import math

import numpy as np


def checked_units(n_units, seed, count=2):
    """The window's first unit and ``count - 1`` more drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([abs(int(seed)), 7]))
    rest = list(range(1, n_units))
    extra = sorted(rng.choice(rest, size=min(count - 1, len(rest)), replace=False).tolist()) if rest else []
    return [0] + extra


def rel(a, b):
    return abs(a - b) / abs(b)


def unit_numbers(problem, units, result, answer, lr, steps=3):
    """The numbers of one unit (see the module's docstring)."""
    values = units.values(result["index"])
    ref_losses = problem.fit(problem.params(values), lr, steps)[0]
    out = {"loss_steps": max(rel(p, r) for p, r in zip(result["losses"][:steps], ref_losses))}
    if units.kind == "fit":
        fitted = problem.params(values, state=answer)
        final = problem.loss(fitted)
        out["final_loss"] = rel(result["loss"], final)
    else:
        fitted = problem.params_at(answer["fitted"])
        final = problem.loss(fitted)
        out["answer_loss"] = rel(float(np.sum(result["answer_losses"])), float(np.sum(problem.answer_losses(fitted))))
        sigmas, ref = np.asarray(answer["sigmas"], dtype=float), problem.sigmas(fitted)
        out["sigmas_bad"] = float(np.sum(~np.isfinite(sigmas) | (sigmas == 0.0)) + (result.get("sigma_error") is not None))
        out["sigmas_gap"] = float(np.max(np.abs(sigmas - ref) / np.abs(ref)))
    out["fit_drop"] = final / ref_losses[0]
    return out


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}): each limited number's worst over the checked units against its limit."""
    worst = {}
    for per_unit in numbers:
        for k, v in per_unit.items():
            prev = worst.get(k)
            worst[k] = v if prev is None or not math.isfinite(v) or (math.isfinite(prev) and v > prev) else prev
    table = {k: {"value": worst[k], "limit": limits[k]} for k in sorted(worst) if k in limits}
    ok = bool(numbers) and all(math.isfinite(t["value"]) and t["value"] <= t["limit"] for t in table.values())
    return ok, table
