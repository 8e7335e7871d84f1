"""HDR tonemap curves (reference: include/kernel/color.h).

Device-side utilities in the reference (the default PNG path uses plain
sRGB); provided for parity and for the Debug/preview paths.
"""

from __future__ import annotations

import jax.numpy as jnp

from henjou.math.vec import smoothstep, step


def tonemap_uchimura(
    x: jnp.ndarray,
    P: float = 1.0,
    a: float = 1.0,
    m: float = 0.22,
    l: float = 0.4,
    c: float = 1.33,
    b: float = 0.0,
) -> jnp.ndarray:
    """Uchimura GT tonemap (reference: color.h:10-53)."""
    l0 = ((P - m) * l) / a
    S1 = m + a * l0
    C2 = (a * P) / (P - S1)
    CP = -C2 / P

    w0 = 1.0 - smoothstep(0.0, m, x)
    w2 = step(m + l0, x)
    w1 = 1.0 - w0 - w2

    T = m * jnp.power(jnp.maximum(x, 0.0) / m, c) + b
    S = P - (P - S1) * jnp.exp(CP * (x - (m + l0)))
    L = m + a * (x - m)
    return T * w0 + L * w1 + S * w2


def tonemap_aces(x: jnp.ndarray) -> jnp.ndarray:
    """ACES filmic fit (reference: color.h:55-63)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
