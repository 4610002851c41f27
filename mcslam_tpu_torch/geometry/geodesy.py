"""WGS84 geodetic -> ECEF -> local ENU conversion (counterpart of
mcslam_tpu/geometry/geodesy.py). The ENU reference point is fixed from
the first GPS message.

Computed in float64 numpy on the host (Earth-scale coordinates do not fit
in float32) and handed on as local ENU float32.
"""

from __future__ import annotations

import numpy as np
import torch

# WGS84 constants
_A = 6378137.0  # semi-major axis [m]
_F = 1.0 / 298.257223563  # flattening
_E2 = _F * (2.0 - _F)  # first eccentricity squared


def geodetic_to_ecef(lat_deg, lon_deg, alt):
    """Degrees / metres -> ECEF metres, float64."""
    lat = np.radians(np.asarray(lat_deg, np.float64))
    lon = np.radians(np.asarray(lon_deg, np.float64))
    alt = np.asarray(alt, np.float64)
    sl, cl = np.sin(lat), np.cos(lat)
    n = _A / np.sqrt(1.0 - _E2 * sl * sl)
    x = (n + alt) * cl * np.cos(lon)
    y = (n + alt) * cl * np.sin(lon)
    z = (n * (1.0 - _E2) + alt) * sl
    return np.stack([x, y, z], axis=-1)


def ecef_to_enu_matrix(lat0_deg, lon0_deg):
    """Rotation from ECEF deltas to local ENU at the reference point."""
    lat = np.radians(float(lat0_deg))
    lon = np.radians(float(lon0_deg))
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array(
        [
            [-so, co, 0.0],
            [-sl * co, -sl * so, cl],
            [cl * co, cl * so, sl],
        ],
        np.float64,
    )


class EnuConverter:
    """Local-cartesian converter anchored at the first observed fix."""

    def __init__(self, lat0_deg, lon0_deg, alt0):
        self.ref_geodetic = (float(lat0_deg), float(lon0_deg), float(alt0))
        self._ref_ecef = geodetic_to_ecef(lat0_deg, lon0_deg, alt0)
        self._R = ecef_to_enu_matrix(lat0_deg, lon0_deg)

    def to_enu(self, lat_deg, lon_deg, alt):
        """-> (..., 3) float32 ENU metres."""
        d = geodetic_to_ecef(lat_deg, lon_deg, alt) - self._ref_ecef
        return (d @ self._R.T).astype(np.float32)

    def to_enu_torch(self, lat_deg, lon_deg, alt, device="cuda"):
        return torch.from_numpy(self.to_enu(lat_deg, lon_deg, alt)).to(device)
