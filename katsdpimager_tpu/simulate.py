"""Interferometer simulator: synthesise visibilities for a point-source sky
over an earth-rotation track and write a native dataset.

Replaces the reference's RASCIL/casacore-based ``tests/simulate.py`` with a
self-contained DFT simulation (same physics: katpoint-grade UVW from antenna
geometry, point-source DFT with the measurement-equation convention
``V = sum_s S_s exp(-2 pi i (u l + v m + w(n-1)))``, linear (XX,XY,YX,YY)
correlation products from IQUV fluxes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

from . import polarization


@dataclasses.dataclass
class Source:
    """Point source: position in radians, IQUV flux in Jy (flat spectrum)."""

    ra: float
    dec: float
    flux_iquv: Tuple[float, float, float, float]


def lmn(ra: np.ndarray, dec: np.ndarray, ra0: float, dec0: float):
    """Direction cosines of (ra, dec) relative to phase centre (ra0, dec0)."""
    dra = np.asarray(ra) - ra0
    dec = np.asarray(dec)
    l = np.cos(dec) * np.sin(dra)
    m = (np.sin(dec) * np.cos(dec0) - np.cos(dec) * np.sin(dec0) * np.cos(dra))
    n = np.sqrt(1.0 - l * l - m * m)
    return l, m, n


def enu_to_xyz(enu: np.ndarray, latitude: float) -> np.ndarray:
    """Local ENU offsets -> local equatorial XYZ (X toward meridian/equator,
    Y east, Z toward north celestial pole)."""
    e, n, u = enu[..., 0], enu[..., 1], enu[..., 2]
    x = -math.sin(latitude) * n + math.cos(latitude) * u
    y = e
    z = math.cos(latitude) * n + math.sin(latitude) * u
    return np.stack([x, y, z], axis=-1)


def xyz_to_uvw(xyz: np.ndarray, hour_angle: np.ndarray, dec: float):
    """Baseline XYZ -> UVW for given hour angle(s) and declination."""
    H = np.asarray(hour_angle)[..., None]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    u = np.sin(H) * x + np.cos(H) * y
    v = -np.sin(dec) * np.cos(H) * x + np.sin(dec) * np.sin(H) * y + np.cos(dec) * z
    w = np.cos(dec) * np.cos(H) * x - np.cos(dec) * np.sin(H) * y + np.sin(dec) * z
    return u, v, w


def random_array(num_antennas: int, max_radius: float, seed: int = 1,
                 core_fraction: float = 0.5) -> np.ndarray:
    """Synthetic array layout: denser core plus outer scatter (ENU, metres).
    Loosely MeerKAT-like in its radial profile, but core-light enough that
    the naturally-weighted beam stays within a few times lambda/D."""
    rng = np.random.default_rng(seed)
    n_core = int(num_antennas * core_fraction)
    ants = []
    for i in range(num_antennas):
        r = (rng.uniform(0.05, 0.3) * max_radius if i < n_core
             else max_radius * (0.3 + 0.7 * rng.uniform(0, 1) ** 1.5))
        theta = rng.uniform(0, 2 * math.pi)
        ants.append([r * math.cos(theta), r * math.sin(theta),
                     rng.uniform(-5, 5)])
    return np.array(ants)


def simulate_vis(antennas_enu: np.ndarray, latitude: float,
                 phase_centre: Tuple[float, float],
                 frequencies: Sequence[float],
                 sources: List[Source],
                 hour_angles: np.ndarray,
                 noise_jy: float = 0.0, seed: int = 2):
    """Simulate (uvw, vis) for all baselines x times.

    Returns (uvw (N,3) metres, vis (C, N, 4) complex64 in XX,XY,YX,YY),
    with N = num_times * num_baselines, baseline-major within each time.
    """
    ra0, dec0 = phase_centre
    na = len(antennas_enu)
    a1, a2 = np.triu_indices(na, k=1)
    xyz = enu_to_xyz(antennas_enu, latitude)
    bl_xyz = xyz[a2] - xyz[a1]  # position2 - position1 convention
    u, v, w = xyz_to_uvw(bl_xyz, hour_angles - ra0 * 0, dec0)
    # hour angle is already relative to the source transit in this idealised
    # simulation; caller supplies the range.
    uvw = np.stack([u, v, w], axis=-1).reshape(-1, 3)  # (T*B, 3)

    # Source geometry
    ras = np.array([s.ra for s in sources])
    decs = np.array([s.dec for s in sources])
    l, m, n = lmn(ras, decs, ra0, dec0)
    lmn1 = np.stack([l, m, n - 1.0], axis=-1)  # (S, 3)
    iquv = np.array([s.flux_iquv for s in sources], np.float64)  # (S, 4)
    # linear products from IQUV
    products = [polarization.STOKES_XX, polarization.STOKES_XY,
                polarization.STOKES_YX, polarization.STOKES_YY]
    coeff = polarization.STOKES_COEFF[products]  # (4, 4) complex
    flux_products = iquv @ coeff.T  # (S, 4) complex

    rng = np.random.default_rng(seed)
    C = len(frequencies)
    vis = np.empty((C, uvw.shape[0], 4), np.complex64)
    from .units import C_M_PER_S

    for ci, freq in enumerate(frequencies):
        wavelength = C_M_PER_S / freq
        phase = uvw @ lmn1.T / wavelength  # (N, S)
        rot = np.exp(-2j * np.pi * phase)
        val = rot @ flux_products  # (N, 4)
        if noise_jy:
            val = val + (rng.normal(scale=noise_jy, size=val.shape)
                         + 1j * rng.normal(scale=noise_jy, size=val.shape))
        vis[ci] = val.astype(np.complex64)
    return uvw.astype(np.float32), vis


def write_dataset(filename: str, uvw, vis, frequencies, phase_centre,
                  antenna_diameter: float, longest_baseline: float,
                  weights=None, polarizations=None, weight_scale=None,
                  band=None):
    """Write the native interchange layout (:mod:`.loader_hdf5`): an HDF5
    file when ``filename`` ends in ``.h5``/``.hdf5`` (needs h5py), else
    the numpy-only directory form of :mod:`.loader_npy`."""
    if polarizations is None:
        polarizations = [polarization.STOKES_XX, polarization.STOKES_XY,
                         polarization.STOKES_YX, polarization.STOKES_YY]
    if not filename.endswith((".h5", ".hdf5")):
        from . import loader_npy

        loader_npy.write(filename, uvw=uvw, vis=vis, weights=weights,
                         frequencies=frequencies, attrs=dict(
                             phase_centre=list(map(float, phase_centre)),
                             antenna_diameter=float(antenna_diameter),
                             longest_baseline=float(longest_baseline),
                             polarizations=[int(p) for p in polarizations],
                             weight_scale=weight_scale, band=band))
        return
    import h5py

    with h5py.File(filename, "w") as f:
        f.create_dataset("uvw", data=np.asarray(uvw, np.float32))
        f.create_dataset("vis", data=np.asarray(vis, np.complex64),
                         chunks=(1, min(1 << 16, vis.shape[1]), vis.shape[2]))
        if weights is not None:
            f.create_dataset("weights", data=np.asarray(weights, np.float32),
                             chunks=(1, min(1 << 16, vis.shape[1]), vis.shape[2]))
        f.create_dataset("frequencies", data=np.asarray(frequencies, np.float64))
        f.attrs["phase_centre"] = np.asarray(phase_centre, np.float64)
        f.attrs["antenna_diameter"] = float(antenna_diameter)
        f.attrs["longest_baseline"] = float(longest_baseline)
        f.attrs["polarizations"] = np.asarray(polarizations, np.int32)
        if weight_scale is not None:
            f.attrs["weight_scale"] = float(weight_scale)
        if band is not None:
            f.attrs["band"] = band


#: Default test sky (parity with reference tests/lsm.txt: four point
#: sources near the phase centre with I/Q/U structure).
DEFAULT_PHASE_CENTRE = (math.radians(52.5), math.radians(-35.0))
DEFAULT_SOURCES = [
    Source(math.radians(52.5), math.radians(-35.0), (1.0, 0.0, 0.0, 0.0)),
    Source(math.radians(52.625), math.radians(-35.1167), (1.5, 0.0, 0.0, 0.0)),
    Source(math.radians(53.0), math.radians(-35.0333), (1.5, 1.0, 0.0, 0.0)),
    Source(math.radians(52.75), math.radians(-35.25), (1.2, 0.0, -1.2, 0.0)),
]


def make_sim_dataset(filename: str, num_antennas: int = 16,
                     num_times: int = 16, num_channels: int = 1,
                     max_radius: float = 500.0,
                     frequencies=None, sources=None, noise_jy: float = 0.0,
                     seed: int = 1, band: str = "L"):
    """Create a simulated dataset (BASELINE config 1 by default: 16
    antennas, 1 channel, CPU-runnable).  ``filename`` picks the layout as
    in :func:`write_dataset`."""
    ants = random_array(num_antennas, max_radius, seed=seed)
    latitude = math.radians(-30.7)
    if frequencies is None:
        frequencies = 856e6 + 214e6 * (np.arange(num_channels) + 0.5)
    if sources is None:
        sources = DEFAULT_SOURCES
    hour_angles = np.linspace(-0.5, 0.5, num_times)
    uvw, vis = simulate_vis(ants, latitude, DEFAULT_PHASE_CENTRE,
                            frequencies, sources, hour_angles,
                            noise_jy=noise_jy, seed=seed + 1)
    # Bounds both the UV extent (pixel sizing) and the default max_w.
    bl = np.linalg.norm(uvw, axis=1).max() * 1.01
    write_dataset(filename, uvw, vis, frequencies, DEFAULT_PHASE_CENTRE,
                  antenna_diameter=13.5, longest_baseline=float(bl),
                  band=band)
    return filename
