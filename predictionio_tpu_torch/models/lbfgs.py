"""The optimizers the JAX package's logistic regression runs, on tensors.

A copy of ``optax.lbfgs()`` (optax 0.2.6: ``memory_size=10``,
``scale_init_precond=True``, then ``scale(-1)``, then
``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')`` with its defaults) and of
``optax.adam(lr)``, as plain functions over one flat f32 parameter
vector. ``torch.optim.LBFGS`` searches differently and would not give
the JAX package's iterates, so it is not used.

- :func:`lbfgs_direction` is ``scale_by_lbfgs``: the memory update with
  its curvature safeguard (a zero ``Δuᵀ Δw`` stores weight 0; a
  subnormal one counts as zero, as XLA flushes it), the
  identity scale (``Δwᵀ Δu / |Δu|²``, or ``min(1, 1/|g|)`` on the first
  step) and the two-loop recursion over all ``memory_size`` slots, oldest
  first. It runs on the device and never syncs.
- :func:`zoom_linesearch` is optax's zoom line search branch for branch:
  the interval search (Nocedal and Wright 3.5), the zoom (3.6) with its
  cubic, quadratic and bisection candidates, the safe-step fallback when
  no step meets both conditions. Its scalars are float32 on the host
  (numpy), as they are f32 in the JAX program; the value and slope at
  each trial step come back from the device in one copy, so each
  line-search step syncs once.
- :func:`minimize` runs exactly ``iterations`` steps, as the JAX
  package's ``lax.scan`` does, including the steps after convergence
  (a zero gradient gives a zero, finite update). Each step recomputes
  the value and gradient at the current point, as ``_optimize`` does,
  and the line search evaluates the loss again at its trial steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

#: (value 0-d f32 tensor, gradient like the parameters) at a point
ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5   # the zoom's interval_threshold
INCREASE_FACTOR = 2.0
TOL = 0.0

_F32 = np.float32


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


def _ftz(v: torch.Tensor) -> torch.Tensor:
    """``v`` with a subnormal value flushed to 0, as XLA computes f32 (the
    JAX program stores weight 0 for a product that underflows; 1/v of a
    subnormal v would be inf here)."""
    return torch.where(v.abs() < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(v), v)


# -- scale_by_lbfgs ------------------------------------------------------------


@dataclass
class LBFGSState:
    count: int
    params: torch.Tensor          # the previous step's parameters
    updates: torch.Tensor         # the previous step's gradient
    diff_params: torch.Tensor     # (m, P) Δw memory
    diff_updates: torch.Tensor    # (m, P) Δu memory
    weights: torch.Tensor         # (m,) ρ = 1 / Δuᵀ Δw (0 when that is 0)


def lbfgs_init(params: torch.Tensor, memory_size: int = MEMORY_SIZE) -> LBFGSState:
    z = torch.zeros((memory_size,) + tuple(params.shape), dtype=params.dtype,
                    device=params.device)
    return LBFGSState(0, torch.zeros_like(params), torch.zeros_like(params),
                      z, z.clone(),
                      torch.zeros(memory_size, dtype=torch.float32,
                                  device=params.device))


def lbfgs_direction(grad: torch.Tensor, state: LBFGSState,
                    params: torch.Tensor) -> Tuple[torch.Tensor, LBFGSState]:
    """``P_k g`` (not yet negated) and the new state: optax's
    ``scale_by_lbfgs`` update at ``params`` with gradient ``grad``."""
    m = state.weights.shape[0]
    memory_idx = state.count % m
    prev_idx = (state.count - 1) % m
    zero = torch.zeros((), dtype=torch.float32, device=grad.device)
    if state.count > 0:
        dp = params - state.params
        du = grad - state.updates
        v = _ftz(_vdot(du, dp))
        weight = torch.where(v == 0.0, zero, 1.0 / v)
    else:
        dp = torch.zeros_like(params)
        du = torch.zeros_like(grad)
        weight = zero
    diff_params = state.diff_params.clone()
    diff_updates = state.diff_updates.clone()
    weights = state.weights.clone()
    diff_params[prev_idx] = dp
    diff_updates[prev_idx] = du
    weights[prev_idx] = weight
    if state.count > 0:
        den = _ftz(_vdot(du, du))
        scale = torch.where(den > 0.0, v / den, torch.ones_like(v))
    else:
        # the first step: a capped reciprocal of the gradient norm
        scale = torch.minimum(torch.ones_like(zero),
                              1.0 / torch.linalg.vector_norm(grad))
    order = [(memory_idx + j) % m for j in range(m)]
    vec = grad
    alphas = {}
    for idx in reversed(order):
        alpha = weights[idx] * _vdot(diff_params[idx], vec)
        vec = vec - alpha * diff_updates[idx]
        alphas[idx] = alpha
    vec = scale * vec
    for idx in order:
        beta = weights[idx] * _vdot(diff_updates[idx], vec)
        vec = vec + (alphas[idx] - beta) * diff_params[idx]
    return vec, LBFGSState(state.count + 1, params, grad, diff_params,
                           diff_updates, weights)


# -- scale_by_zoom_linesearch ----------------------------------------------------


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's ``_cubicmin`` in f32 (NaN when the radical is negative)."""
    C = fpa
    db = b - a
    dc = c - a
    dbdc = db * dc
    denom = (dbdc * dbdc) * (db - dc)
    d00, d01 = dc * dc, -(db * db)
    d10, d11 = -(dc * (dc * dc)), db * (db * db)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (d00 * v0 + d01 * v1) / denom
    B = (d10 * v0 + d11 * v1) / denom
    radical = B * B - _F32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (_F32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (_F32(2.0) * B)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    decrease_error = (value_step - value_init
                      - _F32(SLOPE_RTOL) * stepsize * slope_init)
    # the approximate sufficient decrease of Hager and Zhang
    approx = slope_step - (_F32(2 * SLOPE_RTOL) - _F32(1.0)) * slope_init
    delta_values = (value_step - value_init
                    - _F32(APPROX_DEC_RTOL) * np.abs(value_init))
    approx = np.maximum(approx, delta_values)
    decrease_error = np.maximum(np.minimum(approx, decrease_error), _F32(0.0))
    return _F32(np.inf) if np.isnan(decrease_error) else decrease_error


def _curvature_error(slope_step, slope_init):
    err = np.maximum(np.abs(slope_step) - _F32(CURV_RTOL) * np.abs(slope_init),
                     _F32(0.0))
    return _F32(np.inf) if np.isnan(err) else err


@dataclass
class _Search:
    count: int
    stepsize: np.float32
    value: np.float32
    grad: torch.Tensor
    slope: np.float32
    decrease_error: np.float32
    curvature_error: np.float32
    interval_found: bool
    done: bool
    failed: bool
    low: np.float32
    value_low: np.float32
    slope_low: np.float32
    high: np.float32
    value_high: np.float32
    slope_high: np.float32
    cubic_ref: np.float32
    value_cubic_ref: np.float32
    safe_stepsize: np.float32
    safe_value: np.float32
    safe_grad: torch.Tensor


def _on_line(value_and_grad: ValueAndGrad, params, stepsize, updates):
    """(value, grad, slope) at ``params + stepsize · updates``; one copy
    brings the two scalars to the host."""
    value, grad = value_and_grad(params + float(stepsize) * updates)
    pair = torch.stack([value.float(), _vdot(grad, updates)]).cpu().numpy()
    return pair[0], grad, pair[1]


def zoom_linesearch(value_and_grad: ValueAndGrad, params: torch.Tensor,
                    updates: torch.Tensor, value: np.float32,
                    grad: torch.Tensor, slope: np.float32,
                    max_steps: int = MAX_LINESEARCH_STEPS) -> _Search:
    """optax's zoom line search from ``params`` along ``updates``, with
    ``value``, ``grad`` and ``slope = updatesᵀ grad`` at ``params``; the
    final state's ``stepsize`` is the step to take."""
    value_init, slope_init = _F32(value), _F32(slope)
    zero, inf = _F32(0.0), _F32(np.inf)
    s = _Search(0, zero, value_init, grad, slope_init, inf, inf, False, False,
                False, zero, value_init, slope_init, zero, value_init,
                slope_init, zero, value_init, zero, value_init, grad)
    with np.errstate(all="ignore"):
        while not (s.done or s.failed):
            if s.interval_found:
                _zoom_into_interval(s, value_and_grad, params, updates,
                                    value_init, slope_init, max_steps)
            else:
                _search_interval(s, value_and_grad, params, updates,
                                 value_init, slope_init, max_steps)
            if s.failed:
                _try_safe_step(s)
    return s


def _try_safe_step(s: _Search) -> None:
    """A step with at least sufficient decrease, when the search failed."""
    outside_domain = np.isinf(s.decrease_error)
    if s.safe_stepsize > 0.0 or outside_domain:
        s.stepsize, s.value, s.grad = s.safe_stepsize, s.safe_value, s.safe_grad


def _search_interval(s: _Search, value_and_grad, params, updates,
                     value_init, slope_init, max_steps) -> None:
    """The interval search, Algorithm 3.5 of Nocedal and Wright."""
    iter_num = s.count
    prev_stepsize, prev_value, prev_slope = s.stepsize, s.value, s.slope
    new_stepsize = (_F32(1.0) if iter_num == 0
                    else _F32(INCREASE_FACTOR) * prev_stepsize)
    new_value, new_grad, new_slope = _on_line(value_and_grad, params,
                                              new_stepsize, updates)
    dec = _decrease_error(new_stepsize, new_value, new_slope, value_init,
                          slope_init)
    curv = _curvature_error(new_slope, slope_init)
    new_error = max(dec, curv)
    if dec <= TOL:
        s.safe_stepsize, s.safe_value, s.safe_grad = new_stepsize, new_value, new_grad
    set_high_to_new = bool(dec > 0.0) or (bool(new_value >= prev_value)
                                          and iter_num > 0)
    set_low_to_new = bool(new_slope >= 0.0) and not set_high_to_new
    if set_low_to_new:
        low, vlow, slow = new_stepsize, new_value, new_slope
        high, vhigh, shigh = prev_stepsize, prev_value, prev_slope
    else:
        low, vlow, slow = prev_stepsize, prev_value, prev_slope
        high, vhigh, shigh = new_stepsize, new_value, new_slope
    s.interval_found = set_high_to_new or set_low_to_new or bool(new_error <= TOL)
    # no max_learning_rate: the maximal step is never reached
    s.done = bool(new_error <= TOL)
    s.failed = iter_num + 1 >= max_steps and not s.done
    s.count = iter_num + 1
    s.stepsize, s.value, s.grad, s.slope = new_stepsize, new_value, new_grad, new_slope
    s.decrease_error, s.curvature_error = dec, curv
    s.low, s.value_low, s.slope_low = low, vlow, slow
    s.high, s.value_high, s.slope_high = high, vhigh, shigh
    s.cubic_ref, s.value_cubic_ref = low, vlow


def _zoom_into_interval(s: _Search, value_and_grad, params, updates,
                        value_init, slope_init, max_steps) -> None:
    """The zoom, Algorithm 3.6 of Nocedal and Wright."""
    iter_num = s.count
    low, vlow, slow = s.low, s.value_low, s.slope_low
    high, vhigh, shigh = s.high, s.value_high, s.slope_high
    delta = np.abs(high - low)
    left, right = np.minimum(high, low), np.maximum(high, low)
    cubic_chk = _F32(0.2) * delta
    quad_chk = _F32(0.1) * delta
    too_small_int = bool(delta <= _F32(STEPSIZE_PRECISION))
    middle_cubic = _cubicmin(low, vlow, slow, high, vhigh, s.cubic_ref,
                             s.value_cubic_ref)
    use_cubic = bool((middle_cubic > left + cubic_chk)
                     & (middle_cubic < right - cubic_chk))
    middle_quad = _quadmin(low, vlow, slow, high, vhigh)
    use_quad = (not use_cubic) and bool((middle_quad > left + quad_chk)
                                        & (middle_quad < right - quad_chk))
    if use_cubic:
        middle = middle_cubic
    elif use_quad:
        middle = middle_quad
    else:
        middle = (low + high) / _F32(2.0)
    vm, gm, sm = _on_line(value_and_grad, params, middle, updates)
    dec = _decrease_error(middle, vm, sm, value_init, slope_init)
    curv = _curvature_error(sm, slope_init)
    new_error = max(dec, curv)
    if dec <= TOL and vm < s.safe_value:
        s.safe_stepsize, s.safe_value, s.safe_grad = middle, vm, gm
    done = bool(new_error <= TOL)
    set_high_to_middle = bool(dec > 0.0) or bool(vm >= vlow)
    set_high_to_low = bool(sm * (high - low) >= 0.0) and not set_high_to_middle
    set_low_to_middle = not set_high_to_middle
    new_high, new_vhigh, new_shigh = ((middle, vm, sm) if set_high_to_middle
                                      else (high, vhigh, shigh))
    if set_high_to_low:
        new_high, new_vhigh, new_shigh = low, vlow, slow
    new_low, new_vlow, new_slow = ((middle, vm, sm) if set_low_to_middle
                                   else (low, vlow, slow))
    if set_high_to_middle or set_high_to_low:
        s.cubic_ref, s.value_cubic_ref = high, vhigh
    else:
        s.cubic_ref, s.value_cubic_ref = low, vlow
    presumably_failed = (iter_num + 1 >= max_steps
                         or (too_small_int and s.safe_stepsize > 0.0))
    s.failed = presumably_failed and not done
    s.done = done
    s.count = iter_num + 1
    s.stepsize, s.value, s.grad, s.slope = middle, vm, gm, sm
    s.decrease_error, s.curvature_error = dec, curv
    s.low, s.value_low, s.slope_low = new_low, new_vlow, new_slow
    s.high, s.value_high, s.slope_high = new_high, new_vhigh, new_shigh


# -- the optimization loops ------------------------------------------------------


def minimize(value_and_grad: ValueAndGrad, x0: torch.Tensor, iterations: int,
             use_lbfgs: bool = True, learning_rate: float = 0.1) -> torch.Tensor:
    """``iterations`` steps of L-BFGS (``optax.lbfgs()``) or Adam
    (``optax.adam(learning_rate)``) from ``x0``; returns the parameters."""
    x = x0
    if use_lbfgs:
        state = lbfgs_init(x)
        for _ in range(iterations):
            x, state, _, _ = lbfgs_step(value_and_grad, x, state)
        return x
    return _adam(value_and_grad, x, iterations, learning_rate)


def lbfgs_step(value_and_grad: ValueAndGrad, x: torch.Tensor, state: LBFGSState
               ) -> Tuple[torch.Tensor, LBFGSState, np.float32, _Search]:
    """One step of ``optax.lbfgs()`` from ``x``: (the next point, the new
    state, the value at ``x``, the line search's final state)."""
    value, grad = value_and_grad(x)
    direction, state = lbfgs_direction(grad, state, x)
    updates = -direction
    pair = torch.stack([value.float(), _vdot(updates, grad)]).cpu().numpy()
    ls = zoom_linesearch(value_and_grad, x, updates, pair[0], grad, pair[1])
    return x + float(ls.stepsize) * updates, state, pair[0], ls


def _adam(value_and_grad: ValueAndGrad, x: torch.Tensor, iterations: int,
          learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> torch.Tensor:
    """``optax.adam(learning_rate)``: the moments, their bias corrections
    at the step count, ``m̂ / (√v̂ + eps)`` scaled by ``-learning_rate``."""
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    lr = float(_F32(learning_rate))
    for count in range(1, iterations + 1):
        _, grad = value_and_grad(x)
        mu = (1 - b1) * grad + b1 * mu
        nu = (1 - b2) * (grad * grad) + b2 * nu
        mu_hat = mu / float(_F32(1 - _F32(b1) ** _F32(count)))
        nu_hat = nu / float(_F32(1 - _F32(b2) ** _F32(count)))
        x = x + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return x
