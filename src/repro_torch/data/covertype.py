"""Synthetic Covertype-like generator (offline stand-in for UCI Covertype).

The real dataset (n=581 012, 10 continuous terrain variables) is not available
offline; this generator reproduces its statistical challenges that motivate the
paper's experiment: multimodality (cover types → mixture), heavy skew
(distances), bounded indices (hillshade), and non-linear cross-dependence
(elevation ↔ hydrology ↔ hillshade).

A copy of ``repro.data.covertype`` (pure numpy): the port imports nothing of the
JAX package, and importing ``repro.data`` would import JAX. The generator
must stay identical to the reference's, draw for draw.
"""
from __future__ import annotations

import numpy as np

__all__ = ["generate_covertype", "COVERTYPE_COLUMNS"]

COVERTYPE_COLUMNS = (
    "elevation",
    "aspect",
    "slope",
    "horiz_dist_hydrology",
    "vert_dist_hydrology",
    "horiz_dist_roadways",
    "hillshade_9am",
    "hillshade_noon",
    "hillshade_3pm",
    "horiz_dist_fire_points",
)


def generate_covertype(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # 3 latent terrain regimes (cover types) with distinct elevations
    regime = rng.choice(3, n, p=[0.45, 0.35, 0.2])
    elev_mu = np.array([2400.0, 2900.0, 3300.0])[regime]
    elevation = rng.normal(elev_mu, 180.0)
    aspect = rng.uniform(0, 360, n)
    slope = np.clip(rng.gamma(2.5, 5.0, n), 0, 60)
    hd_hydro = rng.gamma(1.5, 180.0, n) * (1 + 0.0004 * (elevation - 2400))
    vd_hydro = rng.normal(0.12 * hd_hydro, 30.0)
    hd_road = rng.gamma(2.0, 900.0, n)
    # hillshade: bounded [0,254], nonlinear in aspect/slope
    az = np.deg2rad(aspect)
    sl = np.deg2rad(slope)
    def shade(sun_az_deg, sun_alt_deg):
        sa, sh = np.deg2rad(sun_az_deg), np.deg2rad(sun_alt_deg)
        v = np.cos(sh) * np.cos(sl) + np.sin(sh) * np.sin(sl) * np.cos(sa - az)
        return np.clip(254 * np.clip(v, 0, 1) + rng.normal(0, 6, n), 0, 254)
    hs9, hs12, hs15 = shade(90, 45), shade(180, 60), shade(270, 45)
    hd_fire = rng.gamma(1.8, 700.0, n) * (1 + 0.3 * (regime == 2))
    return np.stack(
        [elevation, aspect, slope, hd_hydro, vd_hydro, hd_road, hs9, hs12, hs15, hd_fire],
        axis=1,
    )
