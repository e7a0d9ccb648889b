"""Seeded traffic samplers (`repro.traffic.samplers`, DESIGN.md §13).

Every sampler is a function of an explicit `core.prng` key plus static
shape/config arguments, with no hidden state:

  * key popularity is Zipfian: P(rank r) ∝ (r+1)^-s, sampled by inverse
    CDF search against the normalized cumulative weights;
  * arrivals are a renewal process on exponential gaps with mean
    `gap_mean`, modulated by an on/off burst envelope: runs of
    `burst_len` requests flip a fair coin between an ON phase (gaps
    divided by `burstiness`) and an OFF phase (gaps multiplied by it);
    `burstiness=1.0` is plain Poisson with the same draws;
  * the read/write mix is a Bernoulli(`write_frac`) per request.

The integer draws (threefry bits, the uniform's bits, bernoulli) are the
reference's bit for bit.  The float arithmetic on top of them is not:
PyTorch's `log1p` (the exponential gap) and `pow` (the Zipf weights) can
differ from XLA's by an ulp, and `torch.cumsum` adds in another order
than XLA's, so arrival clocks agree to a few ulps and a rank can move
where a draw lies on a CDF edge.  Bitwise parity with a JAX run goes
through the trace it generated (`trace.load`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Frozen description of one request stream per agent."""
    requests_per_agent: int = 24
    zipf_s: float = 1.1         # key-popularity skew exponent
    gap_mean: float = 32.0      # mean inter-arrival gap (cycles)
    burstiness: float = 1.0     # 1.0 = Poisson; B>1 = on/off with rate x/÷B
    burst_len: int = 8          # requests per on/off phase
    write_frac: float = 0.5     # P(local request is a write)
    remote_frac: float = 0.125  # P(request targets the global key space)


def zipf_cdf(n_keys: int, s: float, device=None) -> torch.Tensor:
    """Normalized cumulative Zipf weights over ranks 0..n_keys-1."""
    ranks = torch.arange(n_keys, dtype=torch.float32, device=device)
    c = torch.cumsum((ranks + 1.0) ** -s, dim=0)
    return c / c[-1]


def zipf_ranks(key: torch.Tensor, n: int, n_keys: int,
               s: float) -> torch.Tensor:
    """[..., n] int32 Zipf(s)-distributed ranks in [0, n_keys) by inverse
    CDF, one row per key of `key [..., 2]`."""
    u = prng.uniform(key, (n,))
    cdf = zipf_cdf(n_keys, s, key.device)
    r = torch.searchsorted(cdf, u.contiguous(), right=True)
    return r.clamp(0, n_keys - 1).to(torch.int32)


def arrival_clocks(key: torch.Tensor, n: int,
                   cfg: TrafficConfig) -> torch.Tensor:
    """[..., n] float32 sorted, non-negative arrival clocks, one stream
    per key of `key [..., 2]`."""
    kg, kp = prng.split(key).unbind(-2)
    f32 = dict(dtype=torch.float32, device=key.device)
    gaps = prng.exponential(kg, (n,)) * torch.tensor(cfg.gap_mean, **f32)
    n_phases = -(-n // cfg.burst_len)   # ceil
    on = prng.bernoulli(kp, 0.5, (n_phases,))
    b = torch.tensor(cfg.burstiness, **f32)
    envelope = torch.where(on, torch.ones((), **f32) / b, b)
    phase = torch.arange(n, device=key.device) // cfg.burst_len
    return torch.cumsum(gaps * envelope[..., phase], dim=-1)


def request_kinds(key: torch.Tensor, n: int, write_frac: float
                  ) -> torch.Tensor:
    """[..., n] int32 request kinds: 0 = read, 1 = write."""
    return prng.bernoulli(key, write_frac, (n,)).to(torch.int32)


def remote_draws(key: torch.Tensor, n: int, remote_frac: float
                 ) -> torch.Tensor:
    """[..., n] bool: which requests target the global key space."""
    return prng.bernoulli(key, remote_frac, (n,))
