"""Sampled-spectrum arithmetic, CIE/XYZ/RGB conversion, SPD files, blackbody.

Re-designs the reference's spectrum machinery (ref: src/core/spectrum.{h,cpp}
— CoefficientSpectrum/SampledSpectrum/RGBSpectrum, AverageSpectrumSamples
spectrum.cpp:66, SampledSpectrum::ToXYZ/FromRGB spectrum.cpp:175-319,
BlackbodyNormalized spectrum.cpp:45) in table-free numpy form:

- The reference embeds ~470-entry CIE curves and Smits RGB-basis tables;
  here the CIE 1931 color-matching functions come from the published
  piecewise-Gaussian analytic fits (Wyman, Sloan & Shirley 2013, JCGT,
  "Simple Analytic Approximations to the CIE XYZ Color Matching
  Functions" — multi-lobe fit, <1% error), and the Smits-style RGB->
  spectrum basis (white/cyan/magenta/yellow/red/green/blue) is computed
  once at first use by a tiny projected-gradient smoothness-regularized
  least-squares solve, exactly the construction Smits used offline.
  This mirrors the repo-wide policy of computing tables the reference
  hard-codes (cf. ops/lds.py for Sobol matrices).

- The render hot path stays RGB (the reference's own default build:
  pbrt.h `Spectrum = RGBSpectrum` unless PBRT_SAMPLED_SPECTRUM); this
  module makes scene-file spectral *inputs* exact: `"spectrum Kd"`
  (lambda,value) pair lists and .spd files are integrated against the
  CIE curves and converted to linear RGB the same way the reference's
  RGBSpectrum::FromSampled does (spectrum.cpp:379-392), and full
  SampledSpectrum arithmetic is available for tools/tests.

All functions are vectorized numpy; SampledSpectrum wraps a trailing
(..., N_SPECTRAL_SAMPLES) axis so batches of spectra are first-class.
"""

from __future__ import annotations

import numpy as np

N_SPECTRAL_SAMPLES = 60
LAMBDA_START = 400.0
LAMBDA_END = 700.0

# CIE_Y_integral: integral of the y-bar curve over the visible range,
# used to normalize XYZ so a constant spectrum of 1 has Y = 1
# (ref: spectrum.h CIE_Y_integral = 106.856895).  Computed from the
# analytic fit below at module load (value ~= 106.86).


def _gauss_piecewise(lam, alpha, mu, s1, s2):
    s = np.where(lam < mu, s1, s2)
    return alpha * np.exp(-((lam - mu) ** 2) / (2.0 * s * s))


def cie_xyz_curves(lam):
    """CIE 1931 2-deg color matching functions at wavelengths `lam` (nm).

    Multi-lobe piecewise-Gaussian fits from Wyman, Sloan & Shirley 2013
    (public analytic formulas; replaces ref's embedded CIE_X/Y/Z tables,
    spectrum.cpp:1933+)."""
    lam = np.asarray(lam, dtype=np.float64)
    x = (_gauss_piecewise(lam, 1.056, 599.8, 37.9, 31.0)
         + _gauss_piecewise(lam, 0.362, 442.0, 16.0, 26.7)
         + _gauss_piecewise(lam, -0.065, 501.1, 20.4, 26.2))
    y = (_gauss_piecewise(lam, 0.821, 568.8, 46.9, 40.5)
         + _gauss_piecewise(lam, 0.286, 530.9, 16.3, 31.1))
    z = (_gauss_piecewise(lam, 1.217, 437.0, 11.8, 36.0)
         + _gauss_piecewise(lam, 0.681, 459.0, 26.0, 13.8))
    return x, y, z


# bucket edges and midpoint wavelengths of the N sampled bins
_EDGES = np.linspace(LAMBDA_START, LAMBDA_END, N_SPECTRAL_SAMPLES + 1)
LAMBDAS = 0.5 * (_EDGES[:-1] + _EDGES[1:])

# CIE curves averaged over each bucket (8 sub-samples per bucket)
_SUB = np.linspace(0, 1, 9)[:-1] + 1.0 / 16.0
_SUBLAM = _EDGES[:-1, None] + (_EDGES[1:] - _EDGES[:-1])[:, None] * _SUB[None, :]
_CX, _CY, _CZ = (c.mean(axis=1) for c in cie_xyz_curves(_SUBLAM))

_FULLLAM = np.arange(360.0, 831.0)
_trapz = getattr(np, "trapezoid", None) or np.trapz
CIE_Y_INTEGRAL = float(_trapz(cie_xyz_curves(_FULLLAM)[1], _FULLLAM))

_DLAM = (LAMBDA_END - LAMBDA_START) / N_SPECTRAL_SAMPLES

# sRGB / Rec.709 primaries, D65 white (ref: spectrum.h XYZToRGB/RGBToXYZ)
_XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
])
_RGB_TO_XYZ = np.array([
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227],
])


def xyz_to_rgb(xyz):
    return np.asarray(xyz) @ _XYZ_TO_RGB.T


def rgb_to_xyz(rgb):
    return np.asarray(rgb) @ _RGB_TO_XYZ.T


def average_spectrum_samples(lam, vals, lo, hi):
    """Average of the piecewise-linear SPD (lam, vals) over [lo, hi]
    with constant extension beyond the ends (ref: spectrum.cpp:66
    AverageSpectrumSamples). Vectorized over (lo, hi) arrays."""
    lam = np.asarray(lam, dtype=np.float64)
    vals = np.asarray(vals, dtype=np.float64)
    order = np.argsort(lam, kind="stable")
    lam, vals = lam[order], vals[order]
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    if lam.size == 1:
        return np.broadcast_to(vals[0], lo.shape).copy()

    # integral of the piecewise-linear function from lam[0] to x, for
    # arbitrary x, via cumulative trapezoids + interpolated partial bins
    cumint = np.concatenate(
        [[0.0], np.cumsum(0.5 * (vals[1:] + vals[:-1]) * np.diff(lam))])

    def integral_to(x):
        x = np.asarray(x, dtype=np.float64)
        xc = np.clip(x, lam[0], lam[-1])
        idx = np.clip(np.searchsorted(lam, xc, side="right") - 1, 0,
                      lam.size - 2)
        l0, l1 = lam[idx], lam[idx + 1]
        v0, v1 = vals[idx], vals[idx + 1]
        t = np.where(l1 > l0, (xc - l0) / np.where(l1 > l0, l1 - l0, 1.0), 0.0)
        vx = v0 + t * (v1 - v0)
        partial = 0.5 * (v0 + vx) * (xc - l0)
        base = cumint[idx] + partial
        # constant extension outside the sampled range
        below = np.where(x < lam[0], (x - lam[0]) * vals[0], 0.0)
        above = np.where(x > lam[-1], (x - lam[-1]) * vals[-1], 0.0)
        return base + below + above

    width = np.where(hi > lo, hi - lo, 1.0)
    avg = (integral_to(hi) - integral_to(lo)) / width
    return np.where(hi > lo, avg, np.interp(lo, lam, vals))


class SampledSpectrum:
    """An (..., N_SPECTRAL_SAMPLES) bucketed spectrum with arithmetic and
    conversions (ref: spectrum.h CoefficientSpectrum/SampledSpectrum)."""

    __slots__ = ("c",)

    def __init__(self, c):
        c = np.asarray(c, dtype=np.float64)
        if c.ndim == 0:
            c = np.full(N_SPECTRAL_SAMPLES, float(c))
        if c.shape[-1] != N_SPECTRAL_SAMPLES:
            raise ValueError(f"trailing axis must be {N_SPECTRAL_SAMPLES}")
        self.c = c

    # ---- constructors ----
    @staticmethod
    def from_sampled(lam, vals):
        """Bucket-average an arbitrary (lambda, value) SPD
        (ref: SampledSpectrum::FromSampled, spectrum.cpp:134)."""
        c = average_spectrum_samples(lam, vals, _EDGES[:-1], _EDGES[1:])
        return SampledSpectrum(c)

    @staticmethod
    def from_rgb(rgb, kind="reflectance"):
        """Smits-style RGB -> smooth spectrum (ref: spectrum.cpp:229-319
        SampledSpectrum::FromRGB with the reflectance/illuminant bases)."""
        rgb = np.asarray(rgb, dtype=np.float64)
        basis = _smits_basis(kind)
        r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
        w = np.minimum(np.minimum(r, g), b)
        # Smits' decomposition: white for the common part, then the
        # secondary (cyan/magenta/yellow) between the two larger
        # channels, then the remaining primary.
        out = w * basis["white"]
        m1 = (r <= g) & (r <= b)   # red smallest
        m2 = (g < r) & (g <= b)    # green smallest
        m3 = ~(m1 | m2)            # blue smallest
        out = out + np.where(
            m1,
            np.where(g <= b,
                     (g - r) * basis["cyan"] + (b - g) * basis["blue"],
                     (b - r) * basis["cyan"] + (g - b) * basis["green"]),
            0.0)
        out = out + np.where(
            m2,
            np.where(r <= b,
                     (r - g) * basis["magenta"] + (b - r) * basis["blue"],
                     (b - g) * basis["magenta"] + (r - b) * basis["red"]),
            0.0)
        out = out + np.where(
            m3,
            np.where(r <= g,
                     (r - b) * basis["yellow"] + (g - r) * basis["green"],
                     (g - b) * basis["yellow"] + (r - g) * basis["red"]),
            0.0)
        # no extra scale: the bases are optimized so to_rgb(from_rgb(c))
        # ~= c exactly (the reference's tables bake their normalization
        # the same way; its white reflectance basis also peaks ~1.06)
        return SampledSpectrum(np.maximum(out, 0.0))

    @staticmethod
    def blackbody(t, scale=1.0, normalized=True):
        """Planck emission spectrum at temperature t Kelvin; normalized
        divides by the peak (Wien) so `scale` sets the maximum value
        (ref: BlackbodyNormalized, spectrum.cpp:45-57)."""
        le = planck(LAMBDAS, t)
        if normalized:
            lam_max = 2.8977721e-3 / t * 1e9
            peak = planck(np.asarray([lam_max]), t)[0]
            le = le / np.maximum(peak, 1e-300)
        return SampledSpectrum(le * scale)

    # ---- conversions ----
    def to_xyz(self):
        f = self.c * _DLAM / CIE_Y_INTEGRAL
        return np.stack([(f * _CX).sum(-1), (f * _CY).sum(-1),
                         (f * _CZ).sum(-1)], axis=-1)

    def to_rgb(self):
        return xyz_to_rgb(self.to_xyz())

    def y(self):
        return (self.c * _CY).sum(-1) * _DLAM / CIE_Y_INTEGRAL

    # ---- arithmetic (ref: CoefficientSpectrum operators) ----
    def _bin(self, other, op):
        o = other.c if isinstance(other, SampledSpectrum) else other
        return SampledSpectrum(op(self.c, o))

    def __add__(self, o): return self._bin(o, np.add)
    __radd__ = __add__
    def __sub__(self, o): return self._bin(o, np.subtract)
    def __mul__(self, o): return self._bin(o, np.multiply)
    __rmul__ = __mul__
    def __truediv__(self, o): return self._bin(o, np.divide)
    def __neg__(self): return SampledSpectrum(-self.c)

    def sqrt(self): return SampledSpectrum(np.sqrt(np.maximum(self.c, 0.0)))
    def exp(self): return SampledSpectrum(np.exp(self.c))
    def pow(self, e): return SampledSpectrum(np.power(np.maximum(self.c, 0.0), e))
    def clamp(self, lo=0.0, hi=np.inf):
        return SampledSpectrum(np.clip(self.c, lo, hi))

    def lerp(self, other, t):
        return SampledSpectrum((1.0 - t) * self.c + t * other.c)

    def is_black(self):
        return not np.any(self.c != 0.0)

    def max_component(self):
        return self.c.max(-1)

    def __repr__(self):
        return f"SampledSpectrum(mean={self.c.mean():.4g})"


def planck(lam_nm, t):
    """Planck's law spectral radiance at wavelengths lam_nm (nm), W/(m^2 sr m)
    (ref: Blackbody, spectrum.cpp:33-43)."""
    lam = np.asarray(lam_nm, dtype=np.float64) * 1e-9
    h, c, kb = 6.62606957e-34, 299792458.0, 1.3806488e-23
    x = h * c / (lam * kb * t)
    # guard overflow for UV buckets at low temperatures
    x = np.minimum(x, 700.0)
    return (2.0 * h * c * c) / (lam ** 5 * np.expm1(x))


def blackbody_rgb(t, scale=1.0):
    """Blackbody -> linear RGB through full spectral integration, peak-
    normalized to max channel 1 before scaling (replaces the 3-wavelength
    approximation; matches the reference's blackbody param path,
    paramset.cpp AddBlackbodySpectrum -> RGB)."""
    rgb = SampledSpectrum.blackbody(t, 1.0, normalized=True).to_rgb()
    rgb = np.maximum(rgb, 0.0)
    m = rgb.max()
    return (rgb / m if m > 0 else rgb) * scale


def spd_pairs_to_rgb(values):
    """`"spectrum name" [lam0 v0 lam1 v1 ...]` -> linear RGB
    (ref: paramset.cpp AddSampledSpectrum -> Spectrum::FromSampled)."""
    v = np.ravel(np.asarray(values, dtype=np.float64))
    if v.size % 2:
        raise ValueError("spectrum pair list must have even length")
    lam, vals = v[0::2], v[1::2]
    return np.maximum(SampledSpectrum.from_sampled(lam, vals).to_rgb(), 0.0)


def read_spd(path):
    """Read a .spd file: whitespace-separated lambda/value pairs, with
    '#' comments (ref: paramset.cpp AddSampledSpectrumFiles ->
    ReadFloatFile, floatfile.cpp)."""
    nums = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0]
            nums.extend(float(tok) for tok in line.split())
    v = np.asarray(nums, dtype=np.float64)
    if v.size % 2:
        raise ValueError(f"{path}: odd float count in SPD file")
    return v[0::2], v[1::2]


def spd_file_to_rgb(path):
    lam, vals = read_spd(path)
    return np.maximum(SampledSpectrum.from_sampled(lam, vals).to_rgb(), 0.0)


# ---------------------------------------------------------------------------
# Smits-style RGB basis spectra, computed at first use.
#
# For each target color in {white, cyan, magenta, yellow, red, green, blue}
# solve for a smooth spectrum s >= 0 minimizing
#     || to_rgb(s) - target ||^2  +  w_s * || D2 s ||^2
# (D2 = second difference), by projected gradient descent.  This is the
# same offline construction Smits used for the tables the reference
# embeds (spectrum.cpp:1933+ RGB2SpectLambda etc.); computing instead of
# embedding keeps the repo table-free.  The illuminant variant weights
# the conversion by a 6504K blackbody (D65 stand-in), as the reference's
# illuminant tables do.
# ---------------------------------------------------------------------------

_SMITS_CACHE = {}

_TARGETS = {
    "white": (1.0, 1.0, 1.0), "cyan": (0.0, 1.0, 1.0),
    "magenta": (1.0, 0.0, 1.0), "yellow": (1.0, 1.0, 0.0),
    "red": (1.0, 0.0, 0.0), "green": (0.0, 1.0, 0.0),
    "blue": (0.0, 0.0, 1.0),
}


def _smits_basis(kind):
    if kind in _SMITS_CACHE:
        return _SMITS_CACHE[kind]
    # spectrum -> rgb linear map M (3, N)
    m_xyz = np.stack([_CX, _CY, _CZ]) * _DLAM / CIE_Y_INTEGRAL
    if kind == "illuminant":
        # solve for u with s = w * u (w = 6504K blackbody, the D65
        # stand-in): the smoothness prior acts on u, so the white
        # illuminant basis comes out D65-shaped, as the reference's
        # illuminant tables are
        w = SampledSpectrum.blackbody(6504.0, 1.0).c
        w = w / w.mean()
    else:
        w = np.ones(N_SPECTRAL_SAMPLES)
    m = (_XYZ_TO_RGB @ m_xyz) * w[None, :]  # (3, N), map from u

    # smoothness operator
    n = N_SPECTRAL_SAMPLES
    d2 = (np.eye(n, k=-1) - 2 * np.eye(n) + np.eye(n, k=1))[1:-1]
    ws = 8.0e-3
    h = m.T @ m + ws * (d2.T @ d2)       # (N, N) PSD
    lip = np.linalg.eigvalsh(h)[-1]

    basis = {}
    for name, tgt in _TARGETS.items():
        b = m.T @ np.asarray(tgt)
        s = np.full(n, np.mean(tgt))
        for _ in range(4000):  # tiny problem; runs in ~10ms total
            s = np.maximum(s - (h @ s - b) / lip, 0.0)
        basis[name] = s * w
    _SMITS_CACHE[kind] = basis
    return basis
