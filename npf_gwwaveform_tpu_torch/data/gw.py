"""Batched gravitational-waveform generator and the matched-filter metric,
the counterpart of `npf_gwwaveform_tpu/data/gw.py` on `torch.fft`.

IMRPhenomD-style (2,2) frequency-domain approximant: TaylorF2 3.5PN
aligned-spin inspiral phasing matched to an arctan merger-ringdown phase, an
f^-7/6 inspiral amplitude blended into a Lorentzian around the ringdown
frequency (Berti-style QNM fits), band edges from the chirp time, then irfft
to the time domain. Everything runs in float32 with the JAX module's
expressions in the same order, so the two packages round alike.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = ["GWParameterSpace", "GWWaveformGenerator", "match", "mismatch"]

MSUN_S = 4.925490947641267e-06  # G M_sun / c^3 in seconds
EULER_GAMMA = 0.5772156649015329
_PI = math.pi


@dataclass(frozen=True)
class GWParameterSpace:
    """Uniform box over (m1, m2, chi1, chi2): masses in M_sun, aligned spins."""

    m_min: float = 10.0
    m_max: float = 80.0
    chi_min: float = -0.8
    chi_max: float = 0.8

    def sample(self, n: int, generator: torch.Generator, device=None) -> torch.Tensor:
        """[n, 4] float32 with m1 >= m2, drawn from `generator`."""
        device = device if device is not None else generator.device
        ms = self.m_min + (self.m_max - self.m_min) * torch.rand(
            (n, 2), generator=generator, device=device)
        chis = self.chi_min + (self.chi_max - self.chi_min) * torch.rand(
            (n, 2), generator=generator, device=device)
        return torch.stack([ms.amax(dim=1), ms.amin(dim=1), chis[:, 0], chis[:, 1]], dim=-1)

    def normalize(self, theta: torch.Tensor) -> torch.Tensor:
        """Physical parameters -> [-1, 1]^4 conditioning inputs."""
        m1 = (theta[..., 0] - self.m_min) / (self.m_max - self.m_min) * 2 - 1
        m2 = (theta[..., 1] - self.m_min) / (self.m_max - self.m_min) * 2 - 1
        c1 = (theta[..., 2] - self.chi_min) / (self.chi_max - self.chi_min) * 2 - 1
        c2 = (theta[..., 3] - self.chi_min) / (self.chi_max - self.chi_min) * 2 - 1
        return torch.stack([m1, m2, c1, c2], dim=-1)


def _taylorf2_phase(v, eta, delta, chi_s, chi_a, v_ref):
    """3.5PN TaylorF2 phasing plus the leading aligned-spin spin-orbit and
    spin-spin terms; v = (pi M f)^(1/3)."""
    eta2 = eta * eta
    eta3 = eta2 * eta

    beta = (113.0 / 12.0) * (chi_s + delta * chi_a - (76.0 * eta / 113.0) * chi_s)
    sigma = eta * (721.0 / 48.0 * (chi_s**2 - chi_a**2)) - (
        (1.0 - 2.0 * eta) * (247.0 / 48.0) * (chi_s**2 + chi_a**2)
    )

    a2 = 3715.0 / 756.0 + 55.0 * eta / 9.0
    a3 = -16.0 * _PI + 4.0 * beta
    a4 = 15293365.0 / 508032.0 + 27145.0 * eta / 504.0 + 3085.0 * eta2 / 72.0 - 10.0 * sigma
    a5_const = _PI * (38645.0 / 756.0 - 65.0 * eta / 9.0)
    a6 = (
        11583231236531.0 / 4694215680.0
        - 640.0 * _PI**2 / 3.0
        - 6848.0 * EULER_GAMMA / 21.0
        + (-15737765635.0 / 3048192.0 + 2255.0 * _PI**2 / 12.0) * eta
        + 76055.0 * eta2 / 1728.0
        - 127825.0 * eta3 / 1296.0
    )
    a7 = _PI * (77096675.0 / 254016.0 + 378515.0 * eta / 1512.0 - 74045.0 * eta2 / 756.0)

    logv = torch.log(v)
    series = (
        1.0
        + a2 * v**2
        + a3 * v**3
        + a4 * v**4
        + a5_const * (1.0 + 3.0 * (logv - torch.log(v_ref))) * v**5
        + (a6 - 6848.0 / 21.0 * torch.log(4.0 * v)) * v**6
        + a7 * v**7
    )
    return 3.0 / (128.0 * eta * v**5) * series


def _final_state(eta, chi_eff):
    """Remnant mass fraction and spin (Rezzolla et al. 2008 aligned-spin fit)."""
    s4, s5, t0, t2, t3 = -0.1229, 0.4537, -2.8904, -3.5171, 2.5763
    a_f = (
        chi_eff
        + s4 * chi_eff**2 * eta
        + s5 * chi_eff * eta**2
        + t0 * chi_eff * eta
        + 2.0 * math.sqrt(3.0) * eta
        + t2 * eta**2
        + t3 * eta**3
    )
    a_f = a_f.clamp(-0.998, 0.998)
    m_f = 1.0 + (math.sqrt(8.0 / 9.0) - 1.0) * eta - 0.498 * eta**2
    return m_f, a_f


def _qnm_22(m_f_sec, a_f):
    """(2,2,0) QNM frequency and damping (Berti+ 2006 fits)."""
    omega = 1.5251 - 1.1568 * (1.0 - a_f) ** 0.1292
    quality = 0.7000 + 1.4187 * (1.0 - a_f) ** (-0.4990)
    f_rd = omega / (2.0 * _PI * m_f_sec)
    f_damp = f_rd / (2.0 * quality)
    return f_rd, f_damp


@dataclass(frozen=True)
class GWWaveformGenerator:
    """(2,2) waveform on a fixed time grid via irfft, merger at
    `t_merge_frac` of the window, peak-normalised."""

    f_min: float = 20.0
    f_max: float = 1024.0
    duration: float = 2.0
    sample_rate: float = 2048.0
    t_merge_frac: float = 0.8

    @property
    def n_time(self) -> int:
        return int(self.duration * self.sample_rate)

    def _hf(self, theta: torch.Tensor, freqs: torch.Tensor):
        """theta [B,4], freqs [F] -> amplitude and phase [B,F]."""
        m1, m2, chi1, chi2 = (theta[:, i:i + 1] for i in range(4))
        m_total = (m1 + m2) * MSUN_S
        eta = m1 * m2 / (m1 + m2) ** 2
        delta = (m1 - m2) / (m1 + m2)
        chi_s = 0.5 * (chi1 + chi2)
        chi_a = 0.5 * (chi1 - chi2)
        chi_eff = (m1 * chi1 + m2 * chi2) / (m1 + m2)
        mchirp = m_total * eta ** (3.0 / 5.0)

        m_f, a_f = _final_state(eta, chi_eff)
        f_rd, f_damp = _qnm_22(m_f * m_total, a_f)

        f_safe = freqs.clamp_min(1.0)
        v = (_PI * m_total * f_safe) ** (1.0 / 3.0)
        v_rd = (_PI * m_total * f_rd) ** (1.0 / 3.0)

        # phase: TaylorF2 inspiral, C^1-matched arctan merger-ringdown
        psi_insp = _taylorf2_phase(v, eta, delta, chi_s, chi_a, v_rd)
        f_t = 0.75 * f_rd
        v_t = (_PI * m_total * f_t) ** (1.0 / 3.0)
        psi_t = _taylorf2_phase(v_t, eta, delta, chi_s, chi_a, v_rd)
        df = 0.01 * f_damp
        v_t2 = (_PI * m_total * (f_t + df)) ** (1.0 / 3.0)
        dpsi_t = (_taylorf2_phase(v_t2, eta, delta, chi_s, chi_a, v_rd) - psi_t) / df

        kappa = 2.2 / eta
        atan_t = torch.atan((f_t - f_rd) / f_damp)
        datan_t = f_damp / ((f_t - f_rd) ** 2 + f_damp**2)
        b_lin = dpsi_t - kappa * datan_t
        a_lin = psi_t - b_lin * f_t - kappa * atan_t
        psi_mr = a_lin + b_lin * freqs + kappa * torch.atan((freqs - f_rd) / f_damp)

        w = torch.sigmoid((freqs - f_t) / (0.5 * f_damp))
        psi = (1.0 - w) * psi_insp + w * psi_mr

        # amplitude: f^-7/6 inspiral -> Lorentzian ringdown
        amp_insp = mchirp ** (5.0 / 6.0) * f_safe ** (-7.0 / 6.0)
        lorentz = f_damp**2 / ((freqs - f_rd) ** 2 + f_damp**2)
        amp_t = mchirp ** (5.0 / 6.0) * f_t ** (-7.0 / 6.0)
        lorentz_t = f_damp**2 / ((f_t - f_rd) ** 2 + f_damp**2)
        amp_mr = amp_t * lorentz / lorentz_t
        amp = (1.0 - w) * amp_insp + w * amp_mr

        # band edges: the start frequency rises so the in-band chirp time fits
        # the window (no irfft wraparound for long low-mass signals)
        tau_fit = 0.85 * self.t_merge_frac * self.duration
        f_fit = (5.0 * m_total / (256.0 * eta * tau_fit)) ** (3.0 / 8.0) / (_PI * m_total)
        f_start = f_fit.clamp_min(self.f_min)
        lo = torch.sigmoid((freqs - f_start) / (0.02 * f_start + 0.25))
        hi = torch.sigmoid((f_rd + 6.0 * f_damp - freqs) / (2.0 * f_damp))
        return amp * lo * hi, psi

    def time_domain(self, theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """theta [B,4] float32 -> (times [n_time], h [B, n_time])."""
        n = self.n_time
        delta_f = 1.0 / self.duration
        freqs = torch.arange(n // 2 + 1, dtype=torch.float32, device=theta.device) * delta_f
        amp, psi = self._hf(theta.float(), freqs)
        t_shift = (1.0 - self.t_merge_frac) * self.duration
        phase = psi - 2.0 * _PI * freqs * t_shift
        hf = torch.complex(amp * torch.cos(phase), -(amp * torch.sin(phase)))
        hf[:, 0] = 0.0
        h = torch.fft.irfft(hf, n=n, dim=-1)
        h = h / h.abs().amax(dim=-1, keepdim=True)
        times = torch.arange(n, dtype=torch.float32, device=theta.device) / self.sample_rate
        return times, h


def match(h1: torch.Tensor, h2: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """White-noise overlap of two waveforms [..., N], maximised over time and
    phase shifts with one FFT."""
    n = h1.shape[dim]
    f1 = torch.fft.rfft(h1, dim=dim)
    f2 = torch.fft.rfft(h2, dim=dim)
    corr = torch.fft.irfft(f1 * torch.conj(f2), n=n, dim=dim)
    num = corr.abs().amax(dim=dim)
    n1 = torch.sqrt((h1 * h1).sum(dim=dim))
    n2 = torch.sqrt((h2 * h2).sum(dim=dim))
    return num / (n1 * n2).clamp_min(1e-30)


def mismatch(h1: torch.Tensor, h2: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return 1.0 - match(h1, h2, dim=dim)
