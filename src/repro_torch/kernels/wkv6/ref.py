"""Plain PyTorch WKV6 recurrence: the CPU path and the kernel's oracle.

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv6_chunked`` is the port of ``repro.models.rwkv6.wkv6_chunked`` (the
function the model calls); ``wkv6_ref`` is the per-step oracle of
``repro.kernels.wkv6.ref``. Both start from a zero state and return
(y (B, S, H, dh) in r's dtype, state (B, H, dh, dh) fp32), where
``state[b, h, i, j]`` accumulates ``k_i v_j``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def wkv6_chunked(r, k, v, w, u, chunk: int):
    """Chunked WKV6 over a full sequence. r/k/v/w: (B, S, H, dh); u: (H, dh).

    Within a chunk the pairwise decay exp(ecw_t - cw_s) for s < t (exponents
    <= 0) weights r_t k_s; across chunks the state carries the rest. A ragged
    S is padded to the chunk with k = v = 0 and w = 1, which leaves the state
    unchanged.
    """
    B, S, H, dh = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    T = r.shape[1]
    n = T // chunk

    def resh(x):  # (n, B, H, C, dh)
        return x.reshape(B, n, chunk, H, dh).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc = resh(r), resh(k), resh(v)
    lw = torch.log(torch.clamp_min(resh(w), 1e-12))
    cw = torch.cumsum(lw, dim=-2)                                 # inclusive
    ecw = cw - lw                                                 # exclusive
    uf = u.float()
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=r.device), diagonal=-1)    # s < t
    state = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
    ys = []
    for c in range(n):
        rf, kf, vf, cwb, ecwb = rc[c], kc[c], vc[c], cw[c], ecw[c]
        diff = ecwb[..., :, None, :] - cwb[..., None, :, :]       # (B,H,C,C,dh)
        dec = torch.exp(torch.where(tri[:, :, None], diff, -torch.inf))
        scores = torch.einsum("bhti,bhsi,bhtsi->bhts", rf, kf, dec)
        diag = torch.einsum("bhti,bhti,hi->bht", rf, kf, uf)
        y = scores @ vf + diag[..., None] * vf
        y = y + (rf * torch.exp(ecwb)) @ state                    # inter-chunk
        total = cwb[..., -1:, :]                                  # (B,H,1,dh)
        kdec = kf * torch.exp(total - cwb)
        state = torch.exp(total[..., 0, :])[..., None] * state \
            + kdec.transpose(-1, -2) @ vf
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, T, H, dh)
    return y[:, :S].to(r.dtype).contiguous(), state


def wkv6_ref(r, k, v, w, u):
    """Per-step recurrence (the ground truth). r/k/v/w: (B, S, H, dh);
    u: (H, dh)."""
    B, S, H, dh = r.shape
    state = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(S):
        rt, kt, vt, wt = (x[:, t].float() for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]                  # (B,H,dh,dh)
        ys.append((rt[..., None, :] @ (state + uf * kv))[..., 0, :])
        state = wt[..., None] * state + kv
    return torch.stack(ys, dim=1).to(r.dtype), state
