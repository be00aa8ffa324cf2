"""Batched gravitational-waveform generator, the matched-filter metrics and
the NP dataset, the counterpart of `npf_gwwaveform_tpu/data/gw.py` on
`torch.fft`.

IMRPhenomD-style (2,2) frequency-domain approximant: TaylorF2 3.5PN
aligned-spin inspiral phasing matched to an arctan merger-ringdown phase, an
f^-7/6 inspiral amplitude blended into a Lorentzian around the ringdown
frequency (Berti-style QNM fits), band edges from the chirp time. The
waveform comes either as amplitude and de-trended phase on a uniform
frequency grid (`frequency_domain`) or through irfft in the time domain
(`time_domain`). Everything runs in float32 with the JAX module's
expressions in the same order, so the two packages round alike, and on the
device of its inputs without a copy from the host, so that a CUDA graph can
capture it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.helpers import linspace

__all__ = ["GWParameterSpace", "GWWaveformGenerator", "GWWaveformDataset", "make_batch",
           "FrequencyDomainWaveform", "psd_aligo", "match", "mismatch", "match_fd",
           "mismatch_fd", "polar_conj", "standardize_phase"]

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

    def grid(self, n_per_axis: int) -> np.ndarray:
        """[n, 4] float64 regular (m1, m2) grid with m1 >= m2 and zero spins:
        the mass grid evaluation set."""
        m = np.linspace(self.m_min, self.m_max, n_per_axis)
        m1, m2 = np.meshgrid(m, m, indexing="ij")
        sel = m1 >= m2
        zeros = np.zeros(sel.sum())
        return np.stack([m1[sel], m2[sel], zeros, zeros], axis=-1)

    def normalize(self, theta: torch.Tensor) -> torch.Tensor:
        """Physical parameters -> [-1, 1]^4 conditioning inputs."""
        m1 = (theta[..., 0] - self.m_min) / (self.m_max - self.m_min) * 2 - 1
        m2 = (theta[..., 1] - self.m_min) / (self.m_max - self.m_min) * 2 - 1
        c1 = (theta[..., 2] - self.chi_min) / (self.chi_max - self.chi_min) * 2 - 1
        c2 = (theta[..., 3] - self.chi_min) / (self.chi_max - self.chi_min) * 2 - 1
        return torch.stack([m1, m2, c1, c2], dim=-1)


class FrequencyDomainWaveform(NamedTuple):
    freqs: torch.Tensor  # [Nf]
    amplitude: torch.Tensor  # [..., Nf]
    phase: torch.Tensor  # [..., Nf], continuous, not wrapped

    @property
    def h(self) -> torch.Tensor:
        """amplitude * exp(-i phase), complex64."""
        return polar_conj(self.amplitude, self.phase)


def polar_conj(amp: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """amp * exp(-i phase) for real float32 amp and phase."""
    return torch.complex(amp * torch.cos(phase), -(amp * torch.sin(phase)))


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

    def freqs(self, n_f: int, device=None) -> torch.Tensor:
        """[n_f] float32 uniform grid from f_min to f_max (`jnp.linspace`'s
        arithmetic, made on `device`)."""
        return linspace(self.f_min, self.f_max, n_f, device=device)

    def frequency_domain(self, theta: torch.Tensor, n_f: int = 256) -> FrequencyDomainWaveform:
        """theta [B,4] -> amplitude and phase [B, n_f] on `freqs(n_f)`. The
        amplitude is peak-normalised per waveform; the phase loses its
        amplitude-weighted linear best fit in f (the time and phase origin),
        so that a network sees the chirp's own structure."""
        freqs = self.freqs(n_f, device=theta.device)
        amp, psi = self._hf(theta.float(), freqs)
        amp = amp / amp.amax(dim=-1, keepdim=True)
        wgt = amp + 1e-8
        wsum = wgt.sum(dim=-1, keepdim=True)
        f0 = (wgt * freqs).sum(dim=-1, keepdim=True) / wsum
        p0 = (wgt * psi).sum(dim=-1, keepdim=True) / wsum
        cov = (wgt * (freqs - f0) * (psi - p0)).sum(dim=-1, keepdim=True)
        var = (wgt * (freqs - f0) ** 2).sum(dim=-1, keepdim=True)
        slope = cov / var.clamp_min(1e-12)
        psi = psi - (p0 + slope * (freqs - f0))
        return FrequencyDomainWaveform(freqs, amp, psi)

    def time_domain(self, theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """theta [B,4] float32 -> (times [n_time], h [B, n_time])."""
        n = self.n_time
        delta_f = 1.0 / self.duration
        freqs = torch.arange(n // 2 + 1, dtype=torch.float32, device=theta.device) * delta_f
        amp, psi = self._hf(theta.float(), freqs)
        t_shift = (1.0 - self.t_merge_frac) * self.duration
        phase = psi - 2.0 * _PI * freqs * t_shift
        hf = polar_conj(amp, phase)
        hf[:, 0] = 0.0
        h = torch.fft.irfft(hf, n=n, dim=-1)
        h = h / h.abs().amax(dim=-1, keepdim=True)
        times = torch.arange(n, dtype=torch.float32, device=theta.device) / self.sample_rate
        return times, h


def psd_aligo(freqs: torch.Tensor) -> torch.Tensor:
    """Analytic Advanced-LIGO design PSD fit (Ajith & Bose 2009 form) in
    units of 1e-49 Hz^-1: x^-4.14 - 5 x^-2 + 111 (1 - x^2 + x^4/2) / (1 +
    x^2/2) with x = f / 215 Hz, f clamped below at 10 Hz and the result at
    1e-6. The physical 1e-49 prefactor would underflow float32, and the
    match does not depend on the PSD's scale."""
    x = freqs.clamp_min(10.0) / 215.0
    s = x ** (-4.14) - 5.0 / (x**2) + 111.0 * (1.0 - x**2 + 0.5 * x**4) / (1.0 + 0.5 * x**2)
    return s.clamp_min(1e-6)


def match(h1: torch.Tensor, h2: torch.Tensor, dim: int = -1,
          psd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Overlap of two time-domain waveforms [..., N], maximised over time and
    phase shifts with one FFT. `psd` ([N//2 + 1], e.g. `psd_aligo` of the
    rfft frequencies) weights the inner product by 1/psd; None: white
    noise."""
    n = h1.shape[dim]
    f1 = torch.fft.rfft(h1, dim=dim)
    f2 = torch.fft.rfft(h2, dim=dim)
    if psd is not None:
        w = 1.0 / psd
        corr = torch.fft.irfft(f1 * w * torch.conj(f2), n=n, dim=dim)
        n1 = torch.sqrt((f1.abs() ** 2 * w).sum(dim=dim))
        n2 = torch.sqrt((f2.abs() ** 2 * w).sum(dim=dim))
    else:
        corr = torch.fft.irfft(f1 * torch.conj(f2), n=n, dim=dim)
        n1 = torch.sqrt((h1 * h1).sum(dim=dim))
        n2 = torch.sqrt((h2 * h2).sum(dim=dim))
    num = corr.abs().amax(dim=dim)
    return num / (n1 * n2).clamp_min(1e-30)


def mismatch(h1: torch.Tensor, h2: torch.Tensor, dim: int = -1,
             psd: Optional[torch.Tensor] = None) -> torch.Tensor:
    return 1.0 - match(h1, h2, dim=dim, psd=psd)


def match_fd(h1f: torch.Tensor, h2f: torch.Tensor, psd: Optional[torch.Tensor] = None,
             pad_factor: int = 4) -> torch.Tensor:
    """Match of two frequency-domain waveforms, complex [..., Nf] on a
    uniform grid, maximised over relative time and phase shifts: the
    modulus of the DFT of h1f conj(h2f) w, zero-padded to Nf * pad_factor
    for sub-bin time resolution, over the two w-weighted norms. w is 1/psd
    ([Nf]; None: white) over its mean, since the match does not depend on
    its scale and a physical PSD's reciprocal would overflow float32."""
    n_f = h1f.shape[-1]
    w = 1.0 / psd if psd is not None else torch.ones(n_f, device=h1f.device)
    w = w / w.mean()
    corr = torch.fft.fft(h1f * torch.conj(h2f) * w, n=n_f * pad_factor, dim=-1)
    num = corr.abs().amax(dim=-1)
    n1 = torch.sqrt((h1f.abs() ** 2 * w).sum(dim=-1))
    n2 = torch.sqrt((h2f.abs() ** 2 * w).sum(dim=-1))
    return num / (n1 * n2).clamp_min(1e-30)


def mismatch_fd(h1f: torch.Tensor, h2f: torch.Tensor, psd: Optional[torch.Tensor] = None,
                pad_factor: int = 4) -> torch.Tensor:
    return 1.0 - match_fd(h1f, h2f, psd=psd, pad_factor=pad_factor)


def standardize_phase(psi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """psi [..., Nf] -> ((psi - mean) / (std + 1e-8), std [..., 1]), per
    waveform, the std without Bessel's correction as `jnp.std`."""
    sigma = psi.std(dim=-1, keepdim=True, correction=0)
    return (psi - psi.mean(dim=-1, keepdim=True)) / (sigma + 1e-8), sigma


def make_batch(theta: torch.Tensor, generator: GWWaveformGenerator, space: GWParameterSpace,
               n_points: int = 256, mode: str = "time"):
    """theta [B,4] -> (x [B,n_points,1] on [-1, 1], y [B,n_points,y_dim],
    normalised parameters [B,4], aux), as `experiments/reproduce_gw.py`'s
    `make_batch` builds them. "time": y = every `n_time // n_points`-th of
    the waveform's last samples, aux None. "freq_ap": y = (amplitude,
    standardised phase) on `n_points` frequencies, aux = each waveform's
    phase std [B], with which the scorer turns both prediction and truth
    back into h(f)."""
    if mode == "time":
        stride = max(1, generator.n_time // n_points)
        _, h = generator.time_domain(theta)
        y, aux = h[:, h.shape[-1] - n_points * stride::stride][:, :n_points, None], None
    elif mode == "freq_ap":
        fd = generator.frequency_domain(theta, n_f=n_points)
        psi, sigma = standardize_phase(fd.phase)
        y, aux = torch.stack([fd.amplitude, psi], dim=-1), sigma[:, 0]
    else:
        raise ValueError(f"mode={mode!r}: 'time' or 'freq_ap'")
    x = linspace(-1.0, 1.0, n_points, device=theta.device)
    return x[None, :, None].expand(theta.shape[0], n_points, 1), y, space.normalize(theta), aux


class GWWaveformDataset:
    """NP-ready GW function dataset with the JAX package's API.

    mode="time": x = the time grid on [-1, 1], y = h(t) (y_dim 1), every
    `n_time // n_points`-th of the generator's last samples.
    mode="freq_ap": x = the frequency grid on [-1, 1], y = (amplitude,
    standardised phase) (y_dim 2).

    Draws come from `rng`, a `torch.Generator` whose device is the data's
    (default: a CPU generator seeded `seed`; JAX's dataset splits a PRNG key
    of `seed` instead, a stream Philox cannot reproduce): fresh waveforms
    for each `get_samples` call and each batch of `epoch_batches*`, or, once
    `set_samples_` (or `is_reuse_across_epochs`) fixes them, the same
    `n_samples` every epoch. Each sample carries the normalised physical
    parameters for conditioned models."""

    def __init__(self, generator: Optional["GWWaveformGenerator"] = None,
                 param_space: Optional[GWParameterSpace] = None, mode: str = "time",
                 n_points: int = 256, n_samples: int = 50_000,
                 is_reuse_across_epochs: bool = False, seed: int = 0,
                 rng: Optional[torch.Generator] = None):
        if mode not in ("time", "freq_ap"):
            raise ValueError(f"mode={mode!r}: 'time' or 'freq_ap'")
        self.generator = generator if generator is not None else GWWaveformGenerator()
        self.param_space = param_space if param_space is not None else GWParameterSpace()
        self.mode = mode
        self.n_points = n_points
        self.n_samples = n_samples
        self.is_reuse_across_epochs = is_reuse_across_epochs
        self.rng = rng if rng is not None else torch.Generator().manual_seed(seed)
        self._fixed = self.get_samples(n_samples) if is_reuse_across_epochs else None

    @property
    def y_dim(self) -> int:
        return 1 if self.mode == "time" else 2

    def samples_of(self, theta: torch.Tensor):
        """theta [n, 4] -> (x [n, n_points, 1], y [n, n_points, y_dim],
        normalised parameters [n, 4])."""
        return make_batch(theta, self.generator, self.param_space, self.n_points, self.mode)[:3]

    def get_samples(self, n_samples: Optional[int] = None):
        """(x, y, parameters) of `n_samples` (default `self.n_samples`) fresh draws."""
        n = self.n_samples if n_samples is None else n_samples
        return self.samples_of(self.param_space.sample(n, self.rng))

    def set_samples_(self, data, targets, params=None) -> None:
        """Fix the samples every epoch yields."""
        self.is_reuse_across_epochs = True
        self._fixed = (data, targets, params)
        self.n_samples = data.shape[0]

    def epoch_batches(self, batch_size: int) -> Iterator:
        """(x, y) of each batch of one epoch."""
        for x, y, _ in self.epoch_batches_conditioned(batch_size):
            yield x, y

    def epoch_batches_conditioned(self, batch_size: int) -> Iterator:
        """(x, y, parameters or None) of each whole batch of one epoch: the
        fixed samples in order, or `n_samples // batch_size` fresh batches."""
        if self.is_reuse_across_epochs:
            x, y, p = self._fixed
            for i in range(0, x.shape[0] - batch_size + 1, batch_size):
                yield (x[i:i + batch_size], y[i:i + batch_size],
                       p[i:i + batch_size] if p is not None else None)
        else:
            for _ in range(self.n_samples // batch_size):
                yield self.get_samples(batch_size)
