"""Token-by-token oracle of the RWKV-6 wkv scan (port of
``repro/kernels/rwkv6_scan/ref.py``):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
"""
from __future__ import annotations

import torch


def reference(r, k, v, w_log, u, state=None):
    """r,k,v,w_log [BH,S,D]; u [BH,D]; state [BH,D,D] -> (o [BH,S,D] in r's
    dtype, state [BH,D,D] f32)."""
    bh, s, d = r.shape
    rf, kf, vf = (a.float() for a in (r, k, v))
    w = torch.exp(w_log.float())
    uf = u.float()
    S = torch.zeros((bh, d, d), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    outs = []
    for t in range(s):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], w[:, t]
        outs.append(torch.einsum("bd,bde->be", rt, S)
                    + torch.einsum("bd,bd->b", rt * uf, kt)[:, None] * vt)
        S = wt[..., None] * S + torch.einsum("bd,be->bde", kt, vt)
    return torch.stack(outs, 1).to(r.dtype), S
