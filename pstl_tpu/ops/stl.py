"""Differentiable Signal Temporal Logic (STL) robustness.

Capability parity with the reference's ``stl_d_lib.py`` (operators: AP, And,
ListAnd, Or, Not, Imply, Eventually, Always, Once, Until/UntimedUntil; soft
semantics ``logsumexp(x*tau)/tau`` with a hard-max escape hatch), re-designed
for XLA:

- A formula is a *static* expression tree.  Evaluating it traces to pure
  ``jnp`` ops, so any formula can live inside ``jit`` / ``grad`` / ``vmap`` /
  ``lax.scan`` bodies (the guidance inner loop fuses it into the sampler).
- The reference's per-timestep Python window slicing
  (``stl_d_lib.py:148-169``, O(T^2) host loop) becomes a single masked
  reduction against a precomputed (T, T) window mask — one fused elementwise op.
- ``UntimedUntil``'s forward/backward ``logcumsumexp`` scans
  (``stl_d_lib.py:186-192``) become ``jax.lax.associative_scan`` over
  ``logaddexp`` — O(log T) depth on device.
- Robustness is computed in float32 regardless of network dtype (tau=100 soft
  semantics is too stiff for bf16).

Semantics notes (verified against brute-force oracles in tests/test_stl.py):
- soft max over an *empty* window is -inf, matching ``stl_d_lib.py:7-8``.
- ``softmax(x) = logsumexp(x * tau) / tau``; ``softmin(x) = -softmax(-x)``.
- hard mode swaps in exact max/min (used for semantics checks and accuracy
  metrics).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

Array = jax.Array
_NEG_INF = -jnp.inf


# ---------------------------------------------------------------------------
# soft reductions
# ---------------------------------------------------------------------------

def soft_max(x: Array, tau: float, axis: int = -1, hard: bool = False,
             keepdims: bool = False, dtype=jnp.float32) -> Array:
    """Soft maximum ``logsumexp(x * tau) / tau`` (exact max when hard=True).

    All -inf inputs along ``axis`` produce -inf (empty-window semantics).
    ``dtype`` is the accumulation dtype (cfg.robustness_dtype; fp32 default —
    tau=100 soft semantics is stiff, bf16 is opt-in for speed studies).
    """
    if hard:
        return jnp.max(x, axis=axis, keepdims=keepdims)
    x = x.astype(dtype)
    return jax.scipy.special.logsumexp(x * tau, axis=axis,
                                       keepdims=keepdims) / tau


def soft_min(x: Array, tau: float, axis: int = -1, hard: bool = False,
             keepdims: bool = False, dtype=jnp.float32) -> Array:
    if hard:
        return jnp.min(x, axis=axis, keepdims=keepdims)
    return -soft_max(-x, tau, axis=axis, hard=False, keepdims=keepdims,
                     dtype=dtype)


def _masked_soft_max(x: Array, mask: Array, tau: float, hard: bool) -> Array:
    """Soft max over the last axis restricted to ``mask`` (False -> ignored).

    x: (..., W), mask: broadcastable to x. Empty mask -> -inf.
    """
    neg = jnp.where(mask, x.astype(jnp.float32), _NEG_INF)
    if hard:
        return jnp.max(neg, axis=-1)
    return jax.scipy.special.logsumexp(neg * tau, axis=-1) / tau


def cumulative(op, x: Array, axis: int = -1, reverse: bool = False) -> Array:
    """Associative cumulative reduction (axis normalized — reverse scans
    require a nonnegative axis)."""
    axis = axis % x.ndim
    return jax.lax.associative_scan(op, x, axis=axis, reverse=reverse)


def logcumsumexp(x: Array, axis: int = -1, reverse: bool = False) -> Array:
    """Numerically-stable cumulative logsumexp via an associative scan."""
    return cumulative(jnp.logaddexp, x, axis=axis, reverse=reverse)


@functools.lru_cache(maxsize=256)
def _window_mask(T: int, ts: int, te: int):
    """(T, T) bool mask: row t selects columns [clip(t+ts,0,T), clip(t+te,0,T)).

    Mirrors the reference's per-t slice ``s[:, clip(t+ts,0,T):clip(t+te,0,T)]``
    (stl_d_lib.py:151,164,179) as one static mask.

    Returns numpy (never a traced jnp array) so the lru_cache stays valid
    across jit traces.
    """
    import numpy as np
    t = np.arange(T)[:, None]
    j = np.arange(T)[None, :]
    lo = np.clip(t + ts, 0, T)
    hi = np.clip(t + te, 0, T)
    return (j >= lo) & (j < hi)


def window_soft_max(s: Array, ts: int, te: int, tau: float,
                    hard: bool = False) -> Array:
    """For each t: soft max of s over window [t+ts, t+te) (clipped). s: (..., T)."""
    T = s.shape[-1]
    if ts == 0 and te >= T:
        # suffix window [t, T): reverse cumulative reduction — O(T) instead
        # of the (T, T) masked reduce (the Always(0, nt) clauses all hit this)
        if hard:
            return cumulative(jnp.maximum, s.astype(jnp.float32), axis=-1,
                              reverse=True)
        return logcumsumexp(s.astype(jnp.float32) * tau, axis=-1,
                            reverse=True) / tau
    mask = _window_mask(T, ts, te)            # (T, T)
    return _masked_soft_max(s[..., None, :], mask, tau, hard)   # (..., T)


def window_soft_min(s: Array, ts: int, te: int, tau: float,
                    hard: bool = False) -> Array:
    return -window_soft_max(-s, ts, te, tau, hard)


# ---------------------------------------------------------------------------
# formula tree
# ---------------------------------------------------------------------------

class STLFormula:
    """Base node.  Calling evaluates robustness over batched signals.

    ``signals`` is an arbitrary pytree (usually a dict of (n, T) arrays); each
    AP extracts one (n, T) robustness trace from it.  All operators map
    (n, T) -> (n, T); the scalar robustness of the run is trace[:, 0].
    """

    symbol = "?"

    def __call__(self, signals, tau: float, hard: bool = False) -> Array:
        raise NotImplementedError

    # convenience: robustness at t=0
    def robustness(self, signals, tau: float, hard: bool = False) -> Array:
        return self(signals, tau, hard)[..., 0]

    def __str__(self):
        return self.symbol


class AP(STLFormula):
    """Atomic predicate: ``expr(signals) -> (n, T)`` margin trace."""

    def __init__(self, expr: Callable, comment: str = ""):
        self.expr = expr
        self.comment = comment
        self.symbol = comment or "AP"

    def __call__(self, signals, tau, hard=False):
        return self.expr(signals).astype(jnp.float32)


class Not(STLFormula):
    def __init__(self, node: STLFormula):
        self.node = node
        self.symbol = f"¬({node})"

    def __call__(self, signals, tau, hard=False):
        return -self.node(signals, tau, hard)


class And(STLFormula):
    def __init__(self, lhs: STLFormula, rhs: STLFormula):
        self.lhs, self.rhs = lhs, rhs
        self.symbol = f"({lhs}) & ({rhs})"

    def __call__(self, signals, tau, hard=False):
        v = jnp.stack([self.lhs(signals, tau, hard),
                       self.rhs(signals, tau, hard)], axis=-1)
        return soft_min(v, tau, axis=-1, hard=hard)


class Or(STLFormula):
    def __init__(self, lhs: STLFormula, rhs: STLFormula):
        self.lhs, self.rhs = lhs, rhs
        self.symbol = f"({lhs}) | ({rhs})"

    def __call__(self, signals, tau, hard=False):
        v = jnp.stack([self.lhs(signals, tau, hard),
                       self.rhs(signals, tau, hard)], axis=-1)
        return soft_max(v, tau, axis=-1, hard=hard)


class Imply(STLFormula):
    def __init__(self, lhs: STLFormula, rhs: STLFormula):
        self.eval = Or(Not(lhs), rhs)
        self.symbol = f"({lhs}) -> ({rhs})"

    def __call__(self, signals, tau, hard=False):
        return self.eval(signals, tau, hard)


class ListAnd(STLFormula):
    """n-ary conjunction; ``full=True`` also returns the per-clause traces
    (used for clause-level diagnostics, cf. stl_d_lib.py:97-112)."""

    def __init__(self, nodes: Sequence[STLFormula]):
        self.nodes = list(nodes)
        self.symbol = " & ".join(f"|{n}|" for n in nodes)

    def __call__(self, signals, tau, hard=False, full=False):
        v = jnp.stack([n(signals, tau, hard) for n in self.nodes], axis=-2)
        s = soft_min(v, tau, axis=-2, hard=hard)        # (n, T)
        if full:
            return s, v
        return s


class Eventually(STLFormula):
    def __init__(self, ts: int, te: int, node: STLFormula):
        self.ts, self.te, self.node = ts, te, node
        self.symbol = f"♢[{ts}:{te}]({node})"

    def __call__(self, signals, tau, hard=False):
        s = self.node(signals, tau, hard)
        return window_soft_max(s, self.ts, self.te, tau, hard)


class Always(STLFormula):
    def __init__(self, ts: int, te: int, node: STLFormula):
        self.ts, self.te, self.node = ts, te, node
        self.symbol = f"◻[{ts}:{te}]({node})"

    def __call__(self, signals, tau, hard=False):
        s = self.node(signals, tau, hard)
        return window_soft_min(s, self.ts, self.te, tau, hard)


class Once(STLFormula):
    """Past-time eventually (ts < 0, ts <= te <= 0), cf. stl_d_lib.py:171-180."""

    def __init__(self, ts: int, te: int, node: STLFormula):
        assert ts < 0 and te >= ts and te <= 0
        self.ts, self.te, self.node = ts, te, node
        self.symbol = f"O[{ts}:{te}]({node})"

    def __call__(self, signals, tau, hard=False):
        s = self.node(signals, tau, hard)
        return window_soft_max(s, self.ts, self.te, tau, hard)


class UntimedUntil(STLFormula):
    """scores[t] = softmax_{t'>=t} softmin(rhs[t'], softmin_{s<=t'} lhs[s]).

    Reference computes this with torch.logcumsumexp forward/backward
    (stl_d_lib.py:186-192); here both cumulative reductions are
    ``associative_scan``s.
    """

    def __init__(self, lhs: STLFormula, rhs: STLFormula):
        self.lhs, self.rhs = lhs, rhs
        self.symbol = f"({lhs}) U ({rhs})"

    def __call__(self, signals, tau, hard=False):
        ls = self.lhs(signals, tau, hard).astype(jnp.float32)
        rs = self.rhs(signals, tau, hard).astype(jnp.float32)
        if hard:
            inf_ls = cumulative(jnp.minimum, ls, axis=-1)
            mn = jnp.minimum(rs, inf_ls)
            return cumulative(jnp.maximum, mn, axis=-1, reverse=True)
        # running prefix soft-min of lhs
        inf_ls = -logcumsumexp(-ls * tau, axis=-1) / tau
        mn = soft_min(jnp.stack([rs, inf_ls], axis=-1), tau, axis=-1)
        # reverse suffix soft-max
        return logcumsumexp(mn * tau, axis=-1, reverse=True) / tau


class Until(STLFormula):
    """Timed until, decomposed exactly as the reference (stl_d_lib.py:194-203)."""

    def __init__(self, ts: int, te: int, lhs: STLFormula, rhs: STLFormula):
        if ts == 0:
            self.eval = UntimedUntil(lhs, rhs)
        else:
            self.eval = And(Eventually(ts, te, rhs),
                            Always(0, ts, UntimedUntil(lhs, rhs)))
        self.symbol = f"({lhs}) U[{ts}:{te}] ({rhs})"

    def __call__(self, signals, tau, hard=False):
        return self.eval(signals, tau, hard)
