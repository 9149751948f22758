"""The panel loop's one-hot formulation, a plain reference for the tests.

A copy of `ops/panel._lu_select_loop_t` as it was before the pivot lanes
moved by index: between K1 blocks every pivot-lane read and write is a
one-hot matrix product over all m lanes (the JAX package's form, since a
TPU kernel cannot index lanes). It calls the package's own K1 dispatch
and pivot-triangle solve, so on the same tensors it must give the
package's loop bit for bit (a one-hot product in IEEE arithmetic returns
the selected value exactly, a -0 as +0). Imports no jax, so the card
tests use it too.
"""

import torch

from conflux_tpu_torch.ops.panel import (
    _BLOCK,
    _GROUP,
    _pivot_solve_t,
    _rank1_dispatch,
)


def onehot_select_loop_t(panel: torch.Tensor, active: torch.Tensor,
                         npiv: int, forced: bool, block: int | None = None,
                         finish: bool = False):
    """(piv, ok, Pt) as `ops/panel._lu_select_loop_t` returns them."""
    m, n = panel.shape
    assert n == npiv
    block = block or _BLOCK
    group = max(_GROUP, block)
    dev, dt = panel.device, panel.dtype

    availf = active.to(dt)[None, :]
    Pt = panel.T.contiguous()
    piv = torch.zeros(npiv, dtype=torch.int64, device=dev)
    ok = torch.zeros(npiv, dtype=torch.bool, device=dev)
    lanes = torch.arange(m, device=dev)

    def onehot_of(pivw, okb):
        return ((lanes[None, :] == pivw[:, None]) & okb[:, None]).to(dt)

    for g0 in range(0, npiv, group):
        g1 = min(g0 + group, npiv)
        for b0 in range(g0, g1, block):
            b1 = min(b0 + block, g1)
            Bt2, availf2, pivw, okb = _rank1_dispatch(
                Pt[b0:b1], availf, b0, forced, finish)
            piv[b0:b1] = pivw
            ok[b0:b1] = okb
            Pt[b0:b1] = Bt2
            availf = availf2
            if b1 < g1:
                T_t = Pt[b1:g1]
                onehot = onehot_of(pivw, okb)                     # [bw, m]
                Tpiv_t = T_t @ onehot.T                           # [rest, bw]
                lu_blk = (Bt2 @ onehot.T).T                       # [bw, bw]
                U12t = _pivot_solve_t(Tpiv_t, lu_blk, group=False)
                Lmul_t = torch.where(availf2 > 0, Bt2, 0.0)       # [bw, m]
                T_new = T_t - U12t @ Lmul_t
                if forced:
                    T_new[:, b0:b1] = U12t
                elif finish:
                    anyp = onehot.sum(dim=0, keepdim=True) > 0
                    T_new = torch.where(anyp, U12t @ onehot, T_new)
                Pt[b1:g1] = T_new
        if g1 < npiv:
            onehot_g = onehot_of(piv[g0:g1], ok[g0:g1])           # [gw, m]
            Bt_g = Pt[g0:g1]
            T_t = Pt[g1:npiv]
            Tpiv_t = T_t @ onehot_g.T                             # [rest, gw]
            lu_g = (Bt_g @ onehot_g.T).T                          # [gw, gw]
            U12t = _pivot_solve_t(Tpiv_t, lu_g, group=True)
            Lmul_g = torch.where(availf > 0, Bt_g, 0.0)           # [gw, m]
            T_new = T_t - U12t @ Lmul_g
            if forced:
                T_new[:, g0:g1] = U12t
            elif finish:
                anyp = onehot_g.sum(dim=0, keepdim=True) > 0
                T_new = torch.where(anyp, U12t @ onehot_g, T_new)
            Pt[g1:npiv] = T_new
    return piv, ok, Pt


def updates_of(npiv: int, block: int) -> tuple:
    """(inner, outer) deferred updates of one npiv-wide panel in
    `block`-wide K1 blocks: one per block that is not the last of its
    group, one per group that is not the panel's last."""
    group = max(_GROUP, block)
    groups = range(0, npiv, group)
    inner = sum(len(range(g0, min(g0 + group, npiv), block)) - 1
                for g0 in groups)
    return inner, len(groups) - 1
