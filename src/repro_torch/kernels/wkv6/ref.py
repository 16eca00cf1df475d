"""Plain PyTorch versions of the WKV6 kernels, in the kernels' (B, H, S, hd)
layout: ``wkv6_ref``, the chunked recurrence the forward kernel computes
(the JAX package's ``models/rwkv6.py::wkv_chunked`` with the chunk as an
argument); ``wkv6_bwd_ref``, its explicit backward, which the backward
kernel computes (the reference leaves that to XLA's differentiation of
its ``lax.scan``); and ``wkv6_naive``, the token-by-token definition the
chunked forms are held against."""
from __future__ import annotations

from typing import Tuple

import torch

CLAMP = 25.0       # exponent clamp of the intra-chunk relative decays


def _clip_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.clamp(-CLAMP, CLAMP))


def _inside(x: torch.Tensor) -> torch.Tensor:
    """Where the clamp passes a gradient (autograd's rule for ``clamp``):
    d e^clip(x) / dx is e^clip(x) there and 0 outside."""
    return ((x >= -CLAMP) & (x <= CLAMP)).float()


def chunk_of(S: int, chunk: int) -> int:
    """The chunk length a call uses: ``chunk``, or S when shorter; it must
    divide S."""
    C = min(chunk, S)
    if C <= 0 or S % C:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {C}")
    return C


def wkv6_ref(r, k, v, logw, u, s0, *, chunk: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v (B, H, S, hd) any float dtype; logw (B, H, S, hd) float32;
    u (H, hd); s0 (B, H, hd, hd) -> (y (B, H, S, hd) float32, state
    (B, H, hd, hd) float32). Exponents are clamped to +-25 inside each
    chunk, so the result depends (slightly) on the chunk."""
    B, H, S, hd = r.shape
    C = chunk_of(S, chunk)
    rf, kf, vf, lw = (t.float() for t in (r, k, v, logw))
    uf = u.float()[None, :, None, :]
    state = s0.float()
    lower = torch.tril(torch.ones(C, C, dtype=torch.bool, device=r.device),
                       -1)
    ys = []
    for c0 in range(0, S, C):
        rr, kk, vv, w = (t[:, :, c0:c0 + C] for t in (rf, kf, vf, lw))
        clw = torch.cumsum(w, dim=2)                   # inclusive
        ecl = clw - w                                  # exclusive
        q_ = rr * _clip_exp(ecl)
        k_ = kk * _clip_exp(-clw)
        A = (q_ @ k_.transpose(-1, -2)).masked_fill(~lower, 0.0)
        diag = (rr * (uf * kk)).sum(-1, keepdim=True)  # (B, H, C, 1)
        y = A @ vv
        y = y + diag * vv
        y = y + q_ @ state
        total = clw[:, :, -1]                          # (B, H, hd)
        kdecay = kk * _clip_exp(total[:, :, None] - clw)
        state = (_clip_exp(total)[..., None] * state
                 + kdecay.transpose(-1, -2) @ vv)
        ys.append(y)
    return torch.cat(ys, dim=2), state


def wkv6_bwd_ref(r, k, v, logw, u, s0, dy, ds=None, *, chunk: int = 64
                 ) -> Tuple[torch.Tensor, ...]:
    """The backward of ``wkv6_ref`` at the same chunk: r/k/v (B, H, S, hd),
    logw (B, H, S, hd) float32, u (H, hd), s0 (B, H, hd, hd), dy (B, H, S,
    hd) the gradient of y, ds (B, H, hd, hd) that of the final state (None:
    zero) -> (dr, dk, dv in r's dtype, dlogw (B, H, S, hd), du (H, hd) and
    ds0 (B, H, hd, hd) in float32).

    It recomputes the chunk-start states S_{c-1} in a forward walk, then
    runs a reverse scan of the state gradient over the chunks. Per chunk,
    with G the gradient of the chunk's end state and, from the forward,
    q_ = r E1, k_ = k E2, kd = k E3 (E1 = e^clip(ecl), E2 = e^clip(-clw),
    E3 = e^clip(total - clw), E4 = e^clip(total)):

      dA   = strictly_lower(dy v^T)          dq_ = dy S_{c-1}^T + dA k_
      dk_  = dA^T q_                         dkd = v G^T
      dv   = A^T dy + diag dy + kd G         ddiag = sum_j dy v
      dr   = ddiag u k + dq_ E1              dk = ddiag u r + dk_ E2 + dkd E3
      du  += sum_t ddiag r k                 G  <- E4 G + q_^T dy

    and, for logw, each exponent's gradient where its clamp passes one:
    decl = dq_ q_ (through ecl), g2 = dk_ k_ (through -clw), g3 = dkd kd
    (through total - clw), g4 = E4 sum_j G S_{c-1} (through total). clw is
    the inclusive cumsum and total its last row, so

      dlogw[t] = g4 + sum_{t' < t} g3[t'] + sum_{t' > t} decl[t']
                 - sum_{t' >= t} g2[t']

    over the tokens of the chunk. The final G is ds0."""
    B, H, S, hd = r.shape
    C = chunk_of(S, chunk)
    rf, kf, vf, lw, g = (t.float() for t in (r, k, v, logw, dy))
    uf = u.float()[None, :, None, :]
    lower = torch.tril(torch.ones(C, C, dtype=torch.bool, device=r.device),
                       -1)
    starts, state = [], s0.float()
    for c0 in range(0, S, C):                      # S_{c-1} of every chunk
        starts.append(state)
        kk, vv, w = (t[:, :, c0:c0 + C] for t in (kf, vf, lw))
        clw = torch.cumsum(w, dim=2)
        total = clw[:, :, -1]
        kd = kk * _clip_exp(total[:, :, None] - clw)
        state = (_clip_exp(total)[..., None] * state
                 + kd.transpose(-1, -2) @ vv)
    grad = (torch.zeros_like(state) if ds is None else ds.float().clone())
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros((B, H, hd), dtype=torch.float32, device=r.device)
    for n in reversed(range(S // C)):
        at = slice(n * C, (n + 1) * C)
        rr, kk, vv, w, gy = (t[:, :, at] for t in (rf, kf, vf, lw, g))
        sp = starts[n]
        clw = torch.cumsum(w, dim=2)
        ecl = clw - w
        total = clw[:, :, -1]
        rel = total[:, :, None] - clw
        e1, e2, e3 = _clip_exp(ecl), _clip_exp(-clw), _clip_exp(rel)
        e4 = _clip_exp(total)
        q_, k_, kd = rr * e1, kk * e2, kk * e3
        A = (q_ @ k_.transpose(-1, -2)).masked_fill(~lower, 0.0)
        dA = (gy @ vv.transpose(-1, -2)).masked_fill(~lower, 0.0)
        diag = (rr * (uf * kk)).sum(-1, keepdim=True)
        ddiag = (gy * vv).sum(-1, keepdim=True)
        dq_ = gy @ sp.transpose(-1, -2) + dA @ k_
        dk_ = dA.transpose(-1, -2) @ q_
        dkd = vv @ grad.transpose(-1, -2)
        dv[:, :, at] = A.transpose(-1, -2) @ gy + diag * gy + kd @ grad
        dr[:, :, at] = ddiag * uf * kk + dq_ * e1
        dk[:, :, at] = ddiag * uf * rr + dk_ * e2 + dkd * e3
        du += (ddiag * rr * kk).sum(2)
        decl = dq_ * q_ * _inside(ecl)
        g2 = dk_ * k_ * _inside(-clw)
        g3 = dkd * kd * _inside(rel)
        g4 = (grad * sp).sum(-1) * e4 * _inside(total)
        dclw = decl - g2 - g3
        dclw[:, :, -1] += g3.sum(2) + g4
        dw[:, :, at] = dclw.flip(2).cumsum(2).flip(2) - decl
        grad = e4[..., None] * grad + q_.transpose(-1, -2) @ gy
    dt = r.dtype
    return (dr.to(dt), dk.to(dt), dv.to(dt), dw, du.sum(0), grad)


def wkv6_naive(r, k, v, logw, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence (the mathematical definition)."""
    rf, kf, vf, lw = (t.float() for t in (r, k, v, logw))
    uf = u.float()[None, :, :, None]
    state = s0.float()
    ys = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = (x[:, :, t] for x in (rf, kf, vf, lw))
        kv = kt[..., None] * vt[..., None, :]          # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, state + uf * kv))
        state = torch.exp(wt)[..., None] * state + kv
    return torch.stack(ys, dim=2), state


__all__ = ["CLAMP", "chunk_of", "wkv6_bwd_ref", "wkv6_naive", "wkv6_ref"]
