"""FourierBSDF: the pbrt ``.bsdf`` table loader, its exact host
evaluation, the lobe projection, and the exact evaluation on the
wavefront (port of ``ops/fourierbsdf.py``).

The reference evaluates measured or layered BSDFs stored as Fourier
series in the azimuth-difference angle over a (mu_i, mu_o) grid
(reflection.cpp FourierBSDFTable::Read and FourierBSDF::f,
interpolation.cpp Fourier and CatmullRomWeights, materials/fourier.cpp).
The table is read and evaluated exactly on the host in numpy (for the
tests and the lobe fit); ``fit_lobes`` projects it onto the wavefront's
lobe system (diffuse albedo plus a Trowbridge-Reitz glossy lobe), whose
pdf importance-samples it; ``densify`` packs every table of a scene into
one dense array and ``evaluate_device`` evaluates f exactly on the
wavefront.  The host half is a copy of the reference module's numpy code
(that module imports jax in its device half).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, fields

import numpy as np
import torch


class FourierTable:
    """In-memory .bsdf table (reflection.h FourierBSDFTable)."""

    def __init__(self):
        self.eta = 1.0
        self.m_max = 0
        self.n_channels = 1
        self.mu = np.zeros(0)          # (nMu,)
        self.cdf = np.zeros((0, 0))    # (nMu, nMu)
        self.m = np.zeros((0, 0), np.int32)        # orders per pair
        self.a_offset = np.zeros((0, 0), np.int64)  # offsets into a
        self.a = np.zeros(0)           # coefficient pool


_HEADER = b"SCATFUN\x01"


def read_bsdf(path: str) -> FourierTable:
    """Parse the binary .bsdf layout (ref: reflection.cpp
    FourierBSDFTable::Read: 8-byte magic, 9 int32 header words, float
    eta, 4 reserved int32, then mu / cdf / offset+length / coefficient
    arrays)."""
    with open(path, "rb") as f:
        if f.read(8) != _HEADER:
            raise ValueError(f"{path}: not a SCATFUN v1 .bsdf file")
        flags, n_mu, n_coeffs, m_max, n_channels, n_bases = struct.unpack(
            "<6i", f.read(24))
        f.read(12)                       # reserved
        (eta,) = struct.unpack("<f", f.read(4))
        f.read(16)                       # reserved
        if flags != 1 or n_bases != 1 or n_channels not in (1, 3):
            raise ValueError(f"{path}: unsupported .bsdf variant "
                             f"(flags={flags} bases={n_bases} "
                             f"channels={n_channels})")
        t = FourierTable()
        t.eta = float(eta)
        t.m_max = m_max
        t.n_channels = n_channels
        t.mu = np.frombuffer(f.read(4 * n_mu), "<f4").astype(np.float64)
        t.cdf = np.frombuffer(f.read(4 * n_mu * n_mu),
                              "<f4").reshape(n_mu, n_mu).astype(np.float64)
        ol = np.frombuffer(f.read(8 * n_mu * n_mu),
                           "<i4").reshape(n_mu, n_mu, 2)
        t.a_offset = ol[..., 0].astype(np.int64)
        t.m = ol[..., 1].astype(np.int32)
        t.a = np.frombuffer(f.read(4 * n_coeffs), "<f4").astype(np.float64)
    return t


def write_bsdf(path: str, table: FourierTable):
    """Inverse of read_bsdf (test fixture generator)."""
    n_mu = len(table.mu)
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(struct.pack("<6i", 1, n_mu, len(table.a), table.m_max,
                            table.n_channels, 1))
        f.write(b"\0" * 12)
        f.write(struct.pack("<f", table.eta))
        f.write(b"\0" * 16)
        f.write(table.mu.astype("<f4").tobytes())
        f.write(table.cdf.astype("<f4").tobytes())
        ol = np.stack([table.a_offset, table.m], axis=-1).astype("<i4")
        f.write(ol.tobytes())
        f.write(table.a.astype("<f4").tobytes())


def _catmull_rom_weights(nodes: np.ndarray, x: float):
    """4-point Catmull-Rom interpolation weights (ref:
    interpolation.cpp CatmullRomWeights)."""
    n = len(nodes)
    if not (x >= nodes[0] and x <= nodes[-1]):
        return None
    i = int(np.searchsorted(nodes, x, side="right") - 1)
    i = min(max(i, 0), n - 2)
    x0, x1 = nodes[i], nodes[i + 1]
    t = (x - x0) / (x1 - x0) if x1 > x0 else 0.0
    t2, t3 = t * t, t * t * t
    w = np.zeros(4)
    w[1] = 2 * t3 - 3 * t2 + 1
    w[2] = -2 * t3 + 3 * t2
    if i > 0:
        w0 = (t3 - 2 * t2 + t) * (x1 - x0) / (x1 - nodes[i - 1])
        w[0] = -w0
        w[2] += w0
    else:
        w0 = t3 - 2 * t2 + t
        w[1] -= w0
        w[2] += w0
    if i + 2 < n:
        w3 = (t3 - t2) * (x1 - x0) / (nodes[i + 2] - x0)
        w[3] = w3
        w[1] -= w3
    else:
        w3 = t3 - t2
        w[1] -= w3
        w[2] += w3
    return i - 1, w


def evaluate(table: FourierTable, mu_i: float, mu_o: float,
             cos_phi: float) -> np.ndarray:
    """Exact table evaluation -> RGB (ref: reflection.cpp
    FourierBSDF::f).  mu_i is measured on the incident side as pbrt does
    (muI = CosTheta(-wi)); the returned value includes the 1/|mu_i|
    factor."""
    r_i = _catmull_rom_weights(table.mu, mu_i)
    r_o = _catmull_rom_weights(table.mu, mu_o)
    if r_i is None or r_o is None:
        return np.zeros(3)
    oi, wi = r_i
    oo, wo = r_o
    m_max = 0
    ak = np.zeros((table.n_channels, table.m_max))
    n_mu = len(table.mu)
    for a in range(4):
        ia = oi + a
        if not (0 <= ia < n_mu) or wi[a] == 0.0:
            continue
        for b in range(4):
            ib = oo + b
            if not (0 <= ib < n_mu) or wo[b] == 0.0:
                continue
            w = wi[a] * wo[b]
            m = int(table.m[ia, ib])
            off = int(table.a_offset[ia, ib])
            if m == 0:
                continue
            m_max = max(m_max, m)
            for c in range(table.n_channels):
                ak[c, :m] += w * table.a[off + c * m: off + c * m + m]
    if m_max == 0:
        return np.zeros(3)
    # cosine series (ref: interpolation.cpp Fourier — double-angle
    # recurrence for cos(k*phi))
    cos_k_minus = cos_phi
    cos_k = 1.0
    vals = np.zeros(table.n_channels)
    for k in range(m_max):
        vals += ak[:, k] * cos_k
        cos_k, cos_k_minus = 2 * cos_phi * cos_k - cos_k_minus, cos_k
    scale = 1.0 / abs(mu_i) if mu_i != 0 else 0.0
    # refraction radiance scaling (reflection.cpp FourierBSDF::f:
    # transport==radiance and transmission -> 1/eta^2)
    if mu_i * mu_o > 0:
        eta = 1.0 / table.eta if mu_i > 0 else table.eta
        scale *= eta * eta
    y = max(0.0, vals[0] * scale)
    if table.n_channels == 1:
        return np.array([y, y, y])
    r = vals[1] * scale
    b = vals[2] * scale
    g = 1.39829 * y - 0.100913 * b - 0.297375 * r
    return np.maximum(np.array([r, g, b]), 0.0)


def make_lambertian_table(albedo=0.5, n_mu: int = 16) -> FourierTable:
    """Analytic Lambertian reflection table: f = albedo/pi, i.e. the
    order-0 coefficient a0(mu_i, mu_o) = albedo/pi * |mu_i| (the table
    stores f * |mu_i|).  Test fixture."""
    t = FourierTable()
    t.eta = 1.0
    t.m_max = 1
    t.n_channels = 1
    # pbrt tables span mu in [-1,1] (muI = CosTheta(-wi) is negative for
    # reflection); constant-albedo in both hemispheres for simplicity
    t.mu = np.linspace(-1.0, 1.0, n_mu)
    t.m = np.ones((n_mu, n_mu), np.int32)
    t.a_offset = np.arange(n_mu * n_mu, dtype=np.int64).reshape(n_mu, n_mu)
    a = np.zeros(n_mu * n_mu)
    for i in range(n_mu):
        for o in range(n_mu):
            a[i * n_mu + o] = albedo / np.pi * abs(t.mu[i])
    t.a = a
    t.cdf = np.zeros((n_mu, n_mu))
    return t


def fit_lobes(table: FourierTable, n_dirs: int = 24):
    """Project the table onto (diffuse rgb, glossy rgb, alpha, eta) for
    the wavefront lobe system.  Least squares over a cosine-weighted
    direction grid; returns (kd, ks, roughness_alpha, eta, residual)."""
    rng = np.random.default_rng(7)
    mu = np.sqrt(rng.uniform(0.02, 1.0, n_dirs))       # cos theta
    phi = rng.uniform(0.0, np.pi, n_dirs)
    rows = []
    targets = []
    alphas = [0.01, 0.05, 0.1, 0.2, 0.4]

    def tr_d(cos_h, alpha):
        c2 = cos_h * cos_h
        den = c2 * (alpha * alpha - 1.0) + 1.0
        return alpha * alpha / np.maximum(np.pi * den * den, 1e-9)

    feats = {a: [] for a in alphas}
    for ii in range(n_dirs):
        for oo in range(n_dirs):
            mi, mo = mu[ii], mu[oo]
            cp = np.cos(phi[ii] - phi[oo])
            val = evaluate(table, -mi, mo, cp)   # reflection: opposite signs
            if not np.isfinite(val).all():
                continue
            targets.append(val)
            rows.append(1.0 / np.pi)
            # half-vector cos for each candidate alpha
            si, so = np.sqrt(1 - mi * mi), np.sqrt(1 - mo * mo)
            wi = np.array([si * np.cos(phi[ii]), si * np.sin(phi[ii]), mi])
            wo = np.array([so * np.cos(phi[oo]), so * np.sin(phi[oo]), mo])
            h = wi + wo
            nh = np.linalg.norm(h)
            ch = h[2] / nh if nh > 0 else 1.0
            for a in alphas:
                feats[a].append(tr_d(ch, a) / max(4.0 * mi * mo, 1e-3))
    T = np.asarray(targets)                      # (S,3)
    diff = np.asarray(rows)                      # (S,)
    best = None
    for a in alphas:
        A = np.stack([diff, np.asarray(feats[a])], axis=-1)   # (S,2)
        coef, *_ = np.linalg.lstsq(A, T, rcond=None)
        coef = np.clip(coef, 0.0, None)
        resid = float(np.mean((A @ coef - T) ** 2))
        if best is None or resid < best[-1]:
            best = (coef[0], coef[1], a, resid)
    kd, ks, alpha, resid = best
    # the diffuse feature is 1/pi, so the coefficient IS the albedo
    return (np.clip(kd, 0.0, 1.0), np.clip(ks, 0.0, None), alpha,
            table.eta, resid)


# ---------------------------------------------------------------------------
# Exact evaluation on the wavefront
#
# The variable-length coefficient lists of each (mu_i, mu_o) pair are
# densified at scene build into a (T, P, P, m_cap, 3) array (orders above
# m_cap truncated: azimuthal detail only; a0, the energy, is always
# exact).  evaluate_device() mirrors FourierBSDF::f with vectorized
# Catmull-Rom weights and the cosine series.
# ---------------------------------------------------------------------------

@dataclass
class FourierDev:
    """Every Fourier table of a scene, dense, on one device."""
    mu: torch.Tensor    # (T, P) f32, padded by repeating the last node
    n_mu: torch.Tensor  # (T,) i32 node counts
    a: torch.Tensor     # (T, P, P, m_cap, 3) f32 coefficients (Y, R, B)
    eta: torch.Tensor   # (T,) f32

    def leaves(self) -> dict:
        return {f"fourier.{f.name}": getattr(self, f.name)
                for f in fields(self)}


def densify_np(tables, m_cap: int = 128) -> dict:
    """Host FourierTables -> the numpy arrays of a FourierDev (keys as
    its fields)."""
    P = max(len(t.mu) for t in tables)
    cap = max(min(max(t.m_max for t in tables), m_cap), 1)
    T = len(tables)
    mu = np.zeros((T, P), np.float32)
    n_mu = np.zeros(T, np.int32)
    a = np.zeros((T, P, P, cap, 3), np.float32)
    eta = np.ones(T, np.float32)
    for ti, t in enumerate(tables):
        n = len(t.mu)
        mu[ti, :n] = t.mu
        mu[ti, n:] = t.mu[-1]
        n_mu[ti] = n
        eta[ti] = t.eta
        for i in range(n):
            for j in range(n):
                m = int(t.m[i, j])
                if m == 0:
                    continue
                mm = min(m, cap)
                off = int(t.a_offset[i, j])
                if t.n_channels == 1:
                    a[ti, i, j, :mm, :] = t.a[off:off + mm, None]
                else:
                    for c in range(3):
                        a[ti, i, j, :mm, c] = t.a[off + c * m:
                                                  off + c * m + mm]
    return dict(mu=mu, n_mu=n_mu, a=a, eta=eta)


def fourier_from_numpy(leaves: dict, device) -> FourierDev:
    """densify_np's arrays (or a reference FourierDev's, as numpy) ->
    FourierDev on ``device``."""
    return FourierDev(
        mu=torch.as_tensor(np.array(leaves["mu"], np.float32), device=device),
        n_mu=torch.as_tensor(np.array(leaves["n_mu"], np.int32),
                             device=device),
        a=torch.as_tensor(np.array(leaves["a"], np.float32),
                          device=device).contiguous(),
        eta=torch.as_tensor(np.array(leaves["eta"], np.float32),
                            device=device))


def densify(tables, m_cap: int = 128, device="cuda") -> FourierDev:
    """Pack host FourierTables into one dense FourierDev on ``device``."""
    return fourier_from_numpy(densify_np(tables, m_cap), device)


def _crw_device(mu, n_mu, x):
    """Catmull-Rom weights over per-ray node arrays (the host twin is
    _catmull_rom_weights).  mu (N,P), n_mu (N,), x (N,) -> (offset (N,),
    weights (N,4), valid (N,))."""
    N, P = mu.shape
    cols = torch.arange(P, device=mu.device)[None, :]
    in_range = cols < n_mu[:, None]
    last = torch.gather(mu, 1, (n_mu - 1).long()[:, None])[:, 0]
    valid = (x >= mu[:, 0]) & (x <= last)
    idx = torch.sum(((mu <= x[:, None]) & in_range).to(torch.int32), dim=1) - 1
    i = torch.minimum(torch.clamp(idx, min=0), n_mu - 2)   # jnp.clip order

    def node(k):
        return torch.gather(mu, 1, torch.clamp(k, 0, P - 1).long()[:, None])[:, 0]

    x0, x1 = node(i), node(i + 1)
    xm, xp = node(i - 1), node(i + 2)
    one = torch.ones_like(x0)
    t = torch.where(x1 > x0, (x - x0) / torch.where(x1 > x0, x1 - x0, one),
                    torch.zeros_like(x0))
    t2, t3 = t * t, t * t * t
    w0 = torch.zeros_like(t)
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    w3 = torch.zeros_like(t)
    has_prev = i > 0
    wp = (t3 - 2 * t2 + t) * torch.where(
        has_prev, (x1 - x0) / torch.clamp(x1 - xm, min=1e-12), one)
    w0 = torch.where(has_prev, -wp, w0)
    w2 = w2 + wp
    w1 = torch.where(has_prev, w1, w1 - wp)
    has_next = (i + 2) < n_mu
    wn = (t3 - t2) * torch.where(
        has_next, (x1 - x0) / torch.clamp(xp - x0, min=1e-12), one)
    w3 = torch.where(has_next, wn, w3)
    w1 = w1 - wn
    w2 = torch.where(has_next, w2, w2 + wn)
    w = torch.stack([w0, w1, w2, w3], dim=-1)
    return i - 1, torch.where(valid[:, None], w, torch.zeros_like(w)), valid


def evaluate_device(ftab: FourierDev, fid, wo, wi):
    """Exact FourierBSDF::f for the wavefront.  fid (N,) table ids
    (clamped; callers mask by material kind); wo/wi (N,3) in the shading
    frame.  Returns f (N,3) with the 1/|mu_i| and radiance-transport
    eta^2 factors."""
    lead = wo.shape[:-1]
    if len(lead) != 1:   # lanes of any shape: evaluated flat
        return evaluate_device(ftab, fid.reshape(-1), wo.reshape(-1, 3),
                               wi.reshape(-1, 3)).reshape(*lead, 3)
    T, P = ftab.mu.shape
    N = wo.shape[0]
    fid = torch.clamp(fid, 0, T - 1).long()
    mu_i = -wi[..., 2]          # CosTheta(-wi)
    mu_o = wo[..., 2]
    # CosDPhi(-wi, wo) on the xy projections
    ax, ay = -wi[..., 0], -wi[..., 1]
    bx, by = wo[..., 0], wo[..., 1]
    den = torch.sqrt(torch.clamp((ax * ax + ay * ay) * (bx * bx + by * by),
                                 min=1e-20))
    cos_phi = torch.clamp((ax * bx + ay * by) / den, -1.0, 1.0)

    mu_r = ftab.mu[fid]         # (N,P)
    n_r = ftab.n_mu[fid]        # (N,)
    oi, w_i, ok_i = _crw_device(mu_r, n_r, mu_i)
    oo, w_o, ok_o = _crw_device(mu_r, n_r, mu_o)

    # the 16 node pairs' coefficients in one gather, (N, 4, 4, m_cap, 3),
    # summed in the reference's order (a major, b minor)
    k4 = torch.arange(4, device=wo.device)
    ia, ib = oi[:, None] + k4, oo[:, None] + k4                  # (N,4)
    va, vb = (ia >= 0) & (ia < n_r[:, None]), (ib >= 0) & (ib < n_r[:, None])
    w = w_i[:, :, None] * w_o[:, None, :]                        # (N,4,4)
    use = va[:, :, None] & vb[:, None, :] & (w != 0.0)
    coef = ftab.a[fid[:, None, None], torch.clamp(ia, 0, P - 1).long()[:, :, None],
                  torch.clamp(ib, 0, P - 1).long()[:, None, :]]
    terms = torch.where(use[..., None, None], w[..., None, None] * coef,
                        torch.zeros_like(coef)).reshape(N, 16, *coef.shape[3:])
    ak = torch.zeros_like(terms[:, 0])
    for k in range(16):
        ak = ak + terms[:, k]

    # cosine series: cos(k phi) = T_k(cos_phi), through arccos
    phi = torch.arccos(cos_phi)
    k = torch.arange(ftab.a.shape[3], dtype=torch.float32, device=wo.device)
    cos_k = torch.cos(k[None, :] * phi[..., None])      # (N, m_cap)
    vals = torch.sum(ak * cos_k[..., None], dim=-2)     # (N,3) Y, R, B

    scale = torch.where(torch.abs(mu_i) > 1e-9,
                        1.0 / torch.clamp(torch.abs(mu_i), min=1e-9),
                        torch.zeros_like(mu_i))
    eta_t = ftab.eta[fid]
    # radiance transport: transmission (mu_i * mu_o > 0 in pbrt's signs)
    eta_s = torch.where(mu_i > 0, 1.0 / eta_t, eta_t)
    scale = scale * torch.where(mu_i * mu_o > 0, eta_s * eta_s,
                                torch.ones_like(eta_s))
    y = torch.clamp(vals[..., 0] * scale, min=0.0)
    r = vals[..., 1] * scale
    b = vals[..., 2] * scale
    g = 1.39829 * y - 0.100913 * b - 0.297375 * r
    f = torch.stack([r, g, b], dim=-1)
    return torch.where((ok_i & ok_o)[..., None], torch.clamp(f, min=0.0),
                       torch.zeros_like(f))
