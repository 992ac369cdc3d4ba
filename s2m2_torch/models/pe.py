"""Sinc-kernel contextual relative positional encoding, factorized.

The reference materializes a dense (H*W, H*W, 32) relative-PE table
(reference: core/model/utils.py:32-60, attentions.py:42-48). The table is
separable:

    pe[i, j, :] = 0.5 * concat(TX[x_i - x_j + W - 1], TY[y_i - y_j + H - 1])

so its contraction with the attention matrix splits into two per-axis
contractions after marginalizing the attention over the other axis. Only
the (W, W, d/2) and (H, H, d/2) tables are ever built.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def custom_sinc(x):
    # The reference uses 3.1415, not pi (reference: core/model/utils.py:5-6).
    px = 3.1415 * x
    return np.where(np.abs(x) < 1e-6, np.ones_like(x), np.sin(px) / px)


@functools.lru_cache(maxsize=32)
def _axis_table(n: int, pe_dim: int) -> np.ndarray:
    """Relative table T[n_q, n_k, pe_dim//2] for one spatial axis of length n."""
    half = pe_dim // 2
    L = 2 * n + 1
    sig = 5.0 / pe_dim
    pos = np.tanh(np.linspace(-3.0, 3.0, L, dtype=np.float32))
    dim_t = np.linspace(-1.0, 1.0, half, dtype=np.float32)
    tab = custom_sinc((dim_t[None, :] - pos[:, None]) / sig).astype(np.float32)
    tab = tab / np.clip(np.linalg.norm(tab, axis=-1, keepdims=True), 1e-12, None)
    q = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    table = tab[q - k + n - 1]  # (n, n, half)
    table.setflags(write=False)  # shared by every caller through the cache
    return table


def pe_tables(h: int, w: int, pe_dim: int = 32, device=None):
    """Per-axis relative PE tables (TY: (h,h,d/2), TX: (w,w,d/2)), float32."""
    return (torch.tensor(_axis_table(h, pe_dim), device=device),
            torch.tensor(_axis_table(w, pe_dim), device=device))


def pe_contract(attn, ty, tx, h: int, w: int):
    """Contract attention probabilities with the factorized relative PE.

    attn: (..., N, N) with N = h*w in row-major (y, x) token order. Returns
    (..., N, pe_dim), equal to the reference's
    einsum('...nij,ijc->...nic', attn, pe) (reference: attentions.py:47).
    The marginals accumulate in float32 whatever attn's dtype."""
    lead = attn.shape[:-2]
    a = attn.reshape(*lead, h, w, h, w).float()
    ax = a.sum(dim=-2)  # (..., hq, wq, wk)
    ay = a.sum(dim=-1)  # (..., hq, wq, hk)
    ps_x = torch.einsum("...hqk,qkc->...hqc", ax, tx)
    ps_y = torch.einsum("...qwk,qkc->...qwc", ay, ty)
    ps_x = ps_x.reshape(*lead, h * w, -1)
    ps_y = ps_y.reshape(*lead, h * w, -1)
    return (0.5 * torch.cat([ps_x, ps_y], dim=-1)).to(attn.dtype)
