"""Global numeric constants (float32 semantics, pbrt's Pi family,
ShadowEpsilon, MachineEpsilon and the gamma(n) conservative rounding-error
bound used by the watertight triangle test).  Plain Python floats."""

import numpy as np

Float = np.float32

MACHINE_EPSILON = float(np.finfo(np.float32).eps) * 0.5

SHADOW_EPSILON = 0.0001
PI = 3.14159265358979323846
INV_PI = 0.31830988618379067154
INV_2PI = 0.15915494309189533577
INV_4PI = 0.07957747154594766788
PI_OVER_2 = 1.57079632679489661923
PI_OVER_4 = 0.78539816339744830961
SQRT_2 = 1.41421356237309504880

# Largest float32 strictly less than 1 (pbrt's OneMinusEpsilon).
ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))

INFINITY = float(np.finfo(np.float32).max)


def gamma(n):
    """Conservative rounding-error bound (n * eps/2) / (1 - n * eps/2)."""
    return (n * MACHINE_EPSILON) / (1.0 - n * MACHINE_EPSILON)
