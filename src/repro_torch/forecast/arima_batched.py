"""Batched fixed-order CSS ARIMA fitting, in PyTorch.

The port of ``repro/forecast/arima_batched.py``. The paper's hybrid policy
falls back to an ARIMA forecast of the next idle time for apps whose idle
times are mostly out of the histogram's range; this module fits every
(series, order) pair of a batch at once:

  * a damped Gauss-Newton (Levenberg-Marquardt) minimisation of the
    conditional sum of squares, 24 iterations from four starts, over the
    17-order ``(p, d, q)`` grid, with the AR and MA pairs projected into
    the shrunken stationary / invertible triangle;
  * the (window, order, start) axes live on tensors; Python loops only over
    the steps of the residual recursion and the LM iterations. The
    Jacobian is the recursion's forward derivative, written out: each step
    carries the residual and its four partial derivatives (the reference
    takes ``jax.jacfwd`` through the same recursion and projection, and
    splits a tie of the projection's clip evenly, as JAX does);
  * orders are scored by AIC in the same pass; the order is chosen on the
    host by :func:`repro_torch.forecast.forecaster.select_order_step`.

Everything is float32, as in the reference, and every row's result is
independent of its batch: the fit uses elementwise operations only (no
matrix product, so TF32 cannot touch it, and no library solve, whose
algorithm may change with the batch). Sums over a window run in one fixed
order, halving the window until one element is left; the 4x4 damped solve
is Gaussian elimination with partial pivoting written out elementwise; the
log in the AIC is computed in float64 from elementary operations and
rounded once (PyTorch's CPU log takes another routine for the last
elements of a tensor than for the rest). So a window fitted alone
(:func:`fit_window`, the scalar forecaster's call) and in a batch of
thousands (:func:`fit_arima_grid`, the replay's) agree bit for bit, on one
device. Against the reference the fit agrees within the bounds that
``tests/test_torch_forecast_conformance.py`` states, not bit for bit (XLA
fuses and orders its float32 sums in its own way).

Rows are fitted in chunks whose size is set by memory: rows are grouped by
the power of two that covers their length (the recursion runs only as many
steps as the longest row of a chunk), then cut to ``CHUNK_BYTES`` of the
device's type.
"""
from __future__ import annotations

import itertools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "MAX_OBS", "ORDER_GRID", "GridFit", "fit_arima_grid", "fit_window",
    "fit_chunks",
]

#: Rolling observation window (the same value as the reference).
MAX_OBS = 64

#: The static order grid, in the reference's enumeration order (AIC ties
#: resolve to the earliest grid entry).
ORDER_GRID: Tuple[Tuple[int, int, int], ...] = tuple(
    (p, d, q)
    for p, d, q in itertools.product(range(3), range(2), range(3))
    if (p, d, q) != (0, 0, 0))

_N_ORDERS = len(ORDER_GRID)
_GN_ITERS = 24          # Levenberg-Marquardt iterations (fixed, branchless)
_COEF_BOUND = 0.98      # stationarity/invertibility triangle shrink factor
_SSE_FLOOR = 1e-12

#: The LM starts, (ar1, ar2, ma1, ma2): zeros; the lag-1 autocorrelation of
#: the centred series ("r1", the moment init: CSS in the MA direction is
#: flat around zero, so a zero start alone stalls on MA-heavy orders); and
#: opposed-sign AR/MA pairs (mixed ARMA objectives have a near-cancellation
#: valley along ar ~ -ma that one start cannot cross). They run in
#: parallel and are chosen in this order.
_STARTS = ((0.0, 0.0, 0.0, 0.0), ("r1", 0.0, "r1", 0.0),
           (0.5, 0.0, -0.5, 0.0), (-0.5, 0.0, 0.5, 0.0))

_ORD_P = np.asarray([o[0] for o in ORDER_GRID], np.int32)
_ORD_D = np.asarray([o[1] for o in ORDER_GRID], np.int32)
_ORD_Q = np.asarray([o[2] for o in ORDER_GRID], np.int32)

#: Working memory a chunk of rows may take, by device type (the recursion's
#: tensors and the Jacobian products scale with rows x steps). On the card
#: a chunk of a few thousand rows keeps each elementwise launch busy; on
#: the CPU larger chunks buy nothing.
CHUNK_BYTES = {"cuda": 4 << 30, "cpu": 256 << 20}


class GridFit(NamedTuple):
    """Per-(task, order) fit results, host numpy.

    ``aic``/``pred`` are float32 [B, n_orders]; ``valid`` marks usable fits
    (long enough series, finite inputs, finite forecast and AIC); invalid
    entries carry ``aic = +inf``. ``coef`` is float32 [B, n_orders, 4], the
    projected ``(ar1, ar2, ma1, ma2)`` (inactive lags exactly 0), and
    ``mu`` [B, n_orders] the mean of the differenced series."""
    aic: np.ndarray
    pred: np.ndarray
    valid: np.ndarray
    coef: np.ndarray
    mu: np.ndarray


# --------------------------------------------------------------------------
# Elementwise building blocks
# --------------------------------------------------------------------------


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (a power of two long) by halving: element i plus
    element i + half, until one is left. The order depends only on the
    length, and trailing zeros drop out exactly, so a window padded with
    zeros to any longer power of two sums to the same value."""
    n = x.shape[dim]
    while n > 1:
        n //= 2
        x = x.narrow(dim, 0, n) + x.narrow(dim, n, n)
    return x.squeeze(dim)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive finite float32 ``x``, the same on every
    device and at every position of a tensor: computed in float64 from
    frexp and a series in ``s = (m - 1) / (m + 1)`` (|s| <= 0.172, 11
    terms, about 1e-16 relative) and rounded once to float32. Other inputs
    take ``torch.log`` (the results are non-finite either way)."""
    x64 = x.double()
    mant, expo = torch.frexp(x64)                  # x = mant * 2**expo
    low = mant < math.sqrt(0.5)
    mant = torch.where(low, mant * 2.0, mant)      # mant in [0.707, 1.414)
    expo = (expo - low.to(expo.dtype)).double()
    s = (mant - 1.0) / (mant + 1.0)
    z = s * s
    poly = torch.full_like(z, 1.0 / 21.0)
    for k in range(19, 0, -2):
        poly = poly * z + 1.0 / k
    out = (expo * math.log(2.0) + 2.0 * s * poly).float()
    ok = torch.isfinite(x) & (x > 0)
    return torch.where(ok, out, torch.log(torch.where(ok, 1.0, x)))


def _balanced(x: torch.Tensor, ans: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """JAX's weight of ``x``'s tangent in ``max``/``min(x, y) = ans``: 1
    where ``x`` is the result, 0 where ``y`` is, 0.5 at a tie."""
    half = torch.where(y == ans, 0.5, 1.0).to(ans.dtype)
    return torch.where(x == ans, half, 0.0).to(ans.dtype)


def _project_dual(c1, dc1, c2, dc2):
    """Project (lag-1, lag-2) into ``{|c2| < 1, |c1| < 1 - c2}`` shrunk by
    ``_COEF_BOUND``, with the forward derivatives ``dc1``, ``dc2`` (leading
    axis: the four coefficients) carried through the clips as JAX carries
    them (``jnp.clip`` is ``minimum(hi, maximum(lo, x))``)."""
    b = torch.full_like(c2, _COEF_BOUND)
    t = torch.maximum(-b, c2)
    dt = dc2 * _balanced(c2, t, -b)
    c2p = torch.minimum(b, t)
    dc2p = dt * _balanced(t, c2p, b)
    lim = b * (1.0 - c2p)
    dlim = b * (-dc2p)
    nlim, dnlim = -lim, -dlim
    s = torch.maximum(nlim, c1)
    ds = dnlim * _balanced(nlim, s, c1) + dc1 * _balanced(c1, s, nlim)
    c1p = torch.minimum(lim, s)
    dc1p = dlim * _balanced(lim, c1p, s) + ds * _balanced(s, c1p, lim)
    return c1p, dc1p, c2p, dc2p


def _project(c1, c2):
    """:func:`_project_dual` without derivatives."""
    b = torch.full_like(c2, _COEF_BOUND)
    c2 = torch.minimum(b, torch.maximum(-b, c2))
    lim = b * (1.0 - c2)
    return torch.minimum(lim, torch.maximum(-lim, c1)), c2


def _solve4(a: List[List[torch.Tensor]],
            b: List[torch.Tensor]) -> List[torch.Tensor]:
    """Solve the 4x4 systems ``a x = b`` lane by lane: Gaussian elimination
    with partial pivoting (the first row of largest magnitude) on the
    augmented rows, the column scaled by the pivot's reciprocal, then back
    substitution by columns (LAPACK's getrf/getrs order of operations)."""
    m = [list(a[r]) + [b[r]] for r in range(4)]
    for k in range(4):
        piv = m[k][k].abs()
        at = torch.zeros_like(piv, dtype=torch.int8)
        for r in range(k + 1, 4):
            v = m[r][k].abs()
            take = v > piv
            piv = torch.where(take, v, piv)
            at = torch.where(take, r, at).to(torch.int8)
        for r in range(k + 1, 4):           # swap rows k and at
            sel = at == r
            for c in range(k, 5):
                m[k][c], m[r][c] = (torch.where(sel, m[r][c], m[k][c]),
                                    torch.where(sel, m[k][c], m[r][c]))
        rcp = torch.ones_like(m[k][k]) / m[k][k]
        for r in range(k + 1, 4):
            l_rk = m[r][k] * rcp
            for c in range(k + 1, 5):
                m[r][c] = m[r][c] - l_rk * m[k][c]
    x = [m[r][4] for r in range(4)]
    for k in range(3, -1, -1):
        x[k] = x[k] / m[k][k]
        for i in range(k):
            x[i] = x[i] - x[k] * m[i][k]
    return x


# --------------------------------------------------------------------------
# One chunk of rows against the whole grid
# --------------------------------------------------------------------------


class _Window(NamedTuple):
    """A chunk's centred series per order, as the recursion reads them."""
    steps: int             # recursion steps: the longest row's length
    w1: torch.Tensor       # [steps, 1, C, O, 1] lag-1 of wc
    w2: torch.Tensor       # [steps, 1, C, O, 1] lag-2 of wc
    w5: torch.Tensor       # [steps, 5, C, O, 1] wc in row 0, zeros below
    mt: torch.Tensor       # [steps, 1, C, O, 1] step t < m
    pmask: torch.Tensor    # [4, 1, O, 1] active (ar1, ar2, ma1, ma2)


def _residual_scan(win: _Window, theta: torch.Tensor, buf: torch.Tensor):
    """CSS residuals and their derivatives in the coefficients for every
    (row, order, start) lane of ``theta`` [4, C, O, K].

    Zero pre-sample convention: lags before the first observation are 0.
    Each step's residual goes to row 0 of ``buf[t]`` and its four
    derivatives to rows 1-4 (``buf`` [span, 5, C, O, K], zero past
    ``steps``). Returns (sse [C, O, K], g = J^T e [4, C, O, K], H = J^T J
    [4, 4, C, O, K]), each a sum over the window in the fixed halving
    order."""
    pm = win.pmask
    zero_t = torch.zeros_like(theta)

    def dual(j1, j2):
        c1, c2 = theta[j1] * pm[j1], theta[j2] * pm[j2]
        dc1, dc2 = zero_t.clone(), zero_t.clone()
        dc1[j1] = pm[j1].expand_as(c1)
        dc2[j2] = pm[j2].expand_as(c2)
        return _project_dual(c1, dc1, c2, dc2)

    a1, da1, a2, da2 = dual(0, 1)
    b1, db1, b2, db2 = dual(2, 3)
    zero = torch.zeros_like(a1)[None]
    c1 = torch.cat([a1[None], da1])        # [5, C, O, K]: value, d/dtheta
    c2 = torch.cat([a2[None], da2])
    d1 = torch.cat([zero, db1])            # the MA lags' own coefficients
    d2 = torch.cat([zero, db2])
    b1, b2 = b1[None], b2[None]
    ar = c1 * win.w1 + c2 * win.w2         # [steps, 5, C, O, K]
    s1 = s2 = torch.zeros_like(c1)
    fill = torch.zeros((), dtype=buf.dtype, device=buf.device)
    for t in range(win.steps):
        f = ar[t] + (d1 * s1[:1] + b1 * s1)
        f = f + (d2 * s2[:1] + b2 * s2)
        torch.where(win.mt[t], win.w5[t] - f, fill, out=buf[t])
        s1, s2 = buf[t], s1
    e = buf[:, 0]
    jac = buf[:, 1:]
    sse = _tree_sum(e * e, 0)
    g = _tree_sum(jac * e[:, None], 0)
    h = _tree_sum(jac[:, :, None] * jac[:, None, :], 0)
    return sse, g, h


def _lm_solve(h: torch.Tensor, g: torch.Tensor, lam: torch.Tensor,
              pmask: torch.Tensor) -> torch.Tensor:
    """The damped step ``delta = (H + diag(lam (diag H + 1e-6)) + diag(1 -
    pmask))^-1 g``; inactive coefficients get identity rows (delta 0)."""
    a = [[h[i, j] for j in range(4)] for i in range(4)]
    for i in range(4):
        damp = lam * (h[i, i] + 1e-6)
        a[i][i] = (h[i, i] + damp) + (1.0 - pmask[i])
    return torch.stack(_solve4(a, [g[i] for i in range(4)]))


def _fit_chunk(y: torch.Tensor, n: torch.Tensor):
    """Fit one chunk: ``y`` [C, MAX_OBS] float32 rows (left-aligned),
    ``n`` [C] int32 lengths. Returns (aic, pred, valid, coef, mu) tensors
    [C, O(, 4)]."""
    dev = y.device
    C, width = y.shape
    steps = max(int(n.max()), 0) if C else 0
    span = _pow2(steps)
    idx = torch.arange(width, device=dev, dtype=torch.int32)
    obs = idx < n[:, None]
    y = torch.where(obs, y, 0.0)
    finite_in = torch.where(obs, torch.isfinite(y), True).all(-1)

    # the two differencings, d = 0 and d = 1: [C, 2, MAX_OBS] (the window
    # sums run over the full window, the wrap of the lag-1 product
    # included, as in the reference)
    w = torch.stack([y, torch.roll(y, -1, -1) - y], 1)
    m = n[:, None] - torch.arange(2, device=dev, dtype=torch.int32)
    mask = idx < m[..., None]
    w = torch.where(mask, w, 0.0)
    mf = torch.clamp(m.float(), min=1.0)
    mu = _tree_sum(w, -1) / mf
    wc = torch.where(mask, w - mu[..., None], 0.0)
    sse0 = _tree_sum(wc * wc, -1)
    r1_num = _tree_sum(wc * torch.roll(wc, 1, -1) * mask
                       * torch.roll(mask, 1, -1), -1)

    # per order: [C, O(, MAX_OBS)]
    ordd = torch.from_numpy(_ORD_D).to(dev).long()
    p = torch.from_numpy(_ORD_P).to(dev)
    d = torch.from_numpy(_ORD_D).to(dev)
    q = torch.from_numpy(_ORD_Q).to(dev)
    wc_o, mask_o = wc[:, ordd], mask[:, ordd]
    mu_o, mf_o, m_o = mu[:, ordd], mf[:, ordd], m[:, ordd]
    sse0_o = sse0[:, ordd]
    r1 = torch.clamp(r1_num[:, ordd] / torch.clamp(sse0_o, min=_SSE_FLOOR),
                     -0.9, 0.9)
    pmask = torch.stack([p >= 1, p >= 2, q >= 1, q >= 2]).float()
    pmask = pmask[:, None, :, None]                       # [4, 1, O, 1]

    # the recursion's inputs, time-major over the chunk's span
    wt = wc_o.permute(2, 0, 1)[:span].contiguous()        # [span, C, O]
    lag = lambda k: torch.cat([torch.zeros_like(wt[:k]),
                               wt[:max(steps - k, 0)]])[:steps, None, ...,
                                                        None]
    w5 = torch.zeros((steps, 5) + wt.shape[1:] + (1,), device=dev)
    w5[:, 0] = wt[:steps, ..., None]
    win = _Window(steps=steps, w1=lag(1), w2=lag(2), w5=w5, pmask=pmask,
                  mt=mask_o.permute(2, 0, 1)[:steps, None, ..., None])

    theta = torch.zeros((4,) + r1.shape + (len(_STARTS),), device=dev)
    for k, start in enumerate(_STARTS):
        for j, v in enumerate(start):
            theta[j, ..., k] = r1 if v == "r1" else v
    buf = torch.zeros((span, 5) + theta.shape[1:], device=dev)
    best, g, h = _residual_scan(win, theta, buf)
    lam = torch.full_like(best, 1e-2)
    for _ in range(_GN_ITERS):
        cand = theta - _lm_solve(h, g, lam, pmask)
        new_sse, g_c, h_c = _residual_scan(win, cand, buf)
        better = new_sse < best
        theta = torch.where(better, cand, theta)
        g = torch.where(better, g_c, g)
        h = torch.where(better, h_c, h)
        best = torch.where(better, new_sse, best)
        lam = torch.clamp(torch.where(better, lam * 0.3, lam * 4.0),
                          1e-8, 1e8)

    # the best start in order, against the zero model's sse0 (strict <)
    th = torch.zeros_like(theta[..., 0])
    sse = sse0_o
    for s in range(theta.shape[-1]):
        take = best[..., s] < sse
        th = torch.where(take, theta[..., s], th)
        sse = torch.where(take, best[..., s], sse)

    pm = pmask[..., 0]                                     # [4, 1, O]
    a1, a2 = _project(th[0] * pm[0], th[1] * pm[1])
    b1, b2 = _project(th[2] * pm[2], th[3] * pm[3])
    coef = torch.stack([a1, a2, b1, b2], -1) * pm.permute(1, 2, 0)
    # the last valid lags (w1, w2, e1, e2) at the chosen coefficients
    w1 = w2 = e1 = e2 = torch.zeros_like(a1)
    for t in range(steps):
        wct, mt = wt[t], mask_o[..., t]
        fit = ((a1 * w1 + a2 * w2) + b1 * e1) + b2 * e2
        e = torch.where(mt, wct - fit, 0.0)
        w2, w1 = torch.where(mt, w1, w2), torch.where(mt, wct, w1)
        e2, e1 = torch.where(mt, e1, e2), torch.where(mt, e, e1)
    pred_w = (((mu_o + a1 * w1) + a2 * w2) + b1 * e1) + b2 * e2
    last = torch.gather(y, 1, torch.clamp(n - 1, min=0).long()[:, None])
    pred = torch.where(d == 1, last + pred_w, pred_w)

    sse = torch.clamp(sse, min=_SSE_FLOOR)
    k = (p + q + 1).float()
    aic = mf_o * _log_f32(sse / mf_o) + 2.0 * k
    long_enough = (n[:, None] >= d + torch.maximum(p, q) + 2) \
        & (m_o >= p + q + 1)
    valid = long_enough & finite_in[:, None] & torch.isfinite(pred) \
        & torch.isfinite(aic)
    aic = torch.where(valid, aic, math.inf)
    return aic, pred, valid, coef, mu_o


# --------------------------------------------------------------------------
# The batched entry points
# --------------------------------------------------------------------------


def _as_rows(series, lengths) -> Tuple[np.ndarray, np.ndarray]:
    rows = np.asarray(series, np.float32)
    if rows.ndim != 2:
        raise ValueError(f"series must be [batch, obs], got shape "
                         f"{rows.shape}")
    lens = np.asarray(lengths, np.int32)
    if lens.shape != (rows.shape[0],):
        raise ValueError("lengths must be one int per series row")
    if rows.shape[1] > MAX_OBS:
        raise ValueError(f"series wider than MAX_OBS={MAX_OBS}; pass the "
                         f"trailing window")
    if rows.shape[1] < MAX_OBS:
        rows = np.pad(rows, ((0, 0), (0, MAX_OBS - rows.shape[1])))
    return rows, np.minimum(lens, rows.shape[1])


def _row_bytes(span: int) -> int:
    """Bytes one row takes while its chunk is fitted: per (step, order,
    start) lane the recursion's buffer and AR part (5 + 5 floats), the
    Jacobian products and their halving sums (16 + 16, 4 + 4) and the
    squared residuals (1 + 1)."""
    return 4 * max(span, 1) * _N_ORDERS * len(_STARTS) * 52


def fit_chunks(lengths, chunk_rows: Optional[int] = None,
               device_type: str = "cuda") -> List[np.ndarray]:
    """The chunks :func:`fit_arima_grid` fits, as row indices: rows sorted
    by length (stably), grouped by the power of two that covers their
    length, and each group cut to ``chunk_rows`` rows (default: as many as
    ``CHUNK_BYTES[device_type]`` holds at the group's length)."""
    lens = np.asarray(lengths, np.int64)
    order = np.argsort(lens, kind="stable")
    spans = np.asarray([_pow2(max(x, 0)) for x in lens[order]], np.int64)
    budget = CHUNK_BYTES.get(device_type, CHUNK_BYTES["cpu"])
    chunks = []
    for span in np.unique(spans):
        rows = order[spans == span]
        size = chunk_rows or max(budget // _row_bytes(int(span)), 1)
        chunks.extend(rows[lo:lo + size] for lo in range(0, len(rows), size))
    return chunks


def fit_arima_grid(series, lengths, *,
                   device: Union[None, str, torch.device] = None,
                   chunk_rows: Optional[int] = None) -> GridFit:
    """Fit every series against the whole order grid on ``device`` (the
    card unless told otherwise; ``"cpu"`` runs on the CPU).

    ``series`` is [B, <=MAX_OBS] float-like (rows left-aligned, anything
    past ``lengths[b]`` ignored); returns a :class:`GridFit` of host
    arrays. Rows are fitted in the chunks :func:`fit_chunks` gives
    (``chunk_rows`` caps their size); each row's result is independent of
    its chunk, bit for bit."""
    rows, lens = _as_rows(series, lengths)
    dev = resolve_device(device)
    B = rows.shape[0]
    aic = np.empty((B, _N_ORDERS), np.float32)
    pred = np.empty((B, _N_ORDERS), np.float32)
    valid = np.empty((B, _N_ORDERS), bool)
    coef = np.empty((B, _N_ORDERS, 4), np.float32)
    mu = np.empty((B, _N_ORDERS), np.float32)
    with torch.no_grad():
        for sel in fit_chunks(lens, chunk_rows, dev.type):
            out = _fit_chunk(torch.from_numpy(rows[sel]).to(dev),
                             torch.from_numpy(lens[sel]).to(dev))
            for dst, src in zip((aic, pred, valid, coef, mu), out):
                dst[sel] = src.cpu().numpy()
    return GridFit(aic=aic, pred=pred, valid=valid, coef=coef, mu=mu)


def fit_window(obs: Sequence[float], *,
               device: Union[None, str, torch.device] = None) -> GridFit:
    """Grid-fit one observation window (the scalar forecaster's call: the
    same per-row program as the batched replay, at batch size 1)."""
    window = list(obs)[-MAX_OBS:]
    row = np.zeros((1, MAX_OBS), np.float32)
    row[0, :len(window)] = window
    return fit_arima_grid(row, [len(window)], device=device)
