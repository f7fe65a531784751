"""The SSD scan's backward: the port's plain version against the reference.

``repro_torch.kernels.ref.ssd_scan_bwd_ref`` is the plain backward that the
CPU path of ``SSDScanFn`` runs and that ``chip_smoke.py`` holds the CUDA
kernel (``csrc/ssd_scan_bwd.cu``) against.  Here it meets ``jax.vjp`` of
the reference's ``ssd_chunked`` (what ``jax.value_and_grad`` runs in the
reference's training) on the same numpy inputs, with B / C as G groups
that the reference takes head-expanded (``jnp.repeat``), with and without
an initial state: 1e-5 of each gradient's scale (f32, other summation
order).  The kernel's own formulation of the gradient (the state pass run
forward and backward, then per chunk the pair terms and the carried terms,
``dcum`` and its suffix sum) is written out below in float64 and held
against the plain backward at 1e-6 of scale (the plain version sums in
f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

NH = 4


def _inputs(B, T, nh, hd, N, G, with_h0, seed=0):
    """numpy f32 inputs drawn as tests/test_kernels.py draws the scan's
    (dt in [0.01, 0.2], A in [-2, -0.5]), plus dy and the final state's
    gradient dh."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.normal(size=shape).astype(np.float32)
    x = rnd(B, T, nh, hd)
    dt = rng.uniform(0.01, 0.2, size=(B, T, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(nh,)).astype(np.float32)
    Bm, Cm = rnd(B, T, G, N), rnd(B, T, G, N)
    h0 = rnd(B, nh, hd, N) if with_h0 else None
    return (x, dt, A, Bm, Cm, h0), rnd(B, T, nh, hd), rnd(B, nh, hd, N)


def _scaled(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("G", [1, 2, NH])
def test_plain_backward_matches_jax_vjp_of_ssd_chunked(G, with_h0):
    """dx, d dt, dA, dB, dC (per group) and dh0 of the plain backward
    against ``jax.vjp`` of the reference's chunked scan, given dy and
    d h_final, over three 32-row chunks: 1e-5 of each gradient's scale."""
    B, T, hd, N, Q = 2, 96, 16, 16, 32
    (x, dt, A, Bm, Cm, h0), dy, dh = _inputs(B, T, NH, hd, N, G, with_h0,
                                             seed=G)
    rep = NH // G

    def fwd(x, dt, A, Bg, Cg, *h0_):
        return jax_ssd_chunked(x, dt, A, jnp.repeat(Bg, rep, axis=2),
                               jnp.repeat(Cg, rep, axis=2), Q,
                               h0=h0_[0] if h0_ else None)

    primals = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)] + \
        ([jnp.asarray(h0)] if with_h0 else [])
    _, vjp = jax.vjp(fwd, *primals)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    got = tref.ssd_scan_bwd_ref(*t, torch.from_numpy(dy),
                                torch.from_numpy(dh), chunk=Q,
                                h0=torch.from_numpy(h0) if with_h0 else None)
    assert (got[5] is None) == (not with_h0)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        _scaled(g.numpy(), w, 1e-5, name)


def _kernel_formulation(x, dt, A, Bm, Cm, dy, dh, Q, h0):
    """The gradient as ``csrc/ssd_scan_bwd.cu`` computes it, in float64:
    chunk states S_c and E_c, the forward and reverse state passes, then
    per chunk the pair matrices M = s L, W = L dt D and P = s W, the
    carried and state terms, dcum and its suffix sum da."""
    Bsz, T, nh, hd = x.shape
    G, N = Bm.shape[2:]
    nc, hpg = T // Q, nh // G
    f64 = torch.float64
    x, dt, A, dy = x.to(f64), dt.to(f64), A.to(f64), dy.to(f64)
    Bh = Bm.to(f64).repeat_interleave(hpg, 2)
    Ch = Cm.to(f64).repeat_interleave(hpg, 2)
    dx, ddt, dA = torch.zeros_like(x), torch.zeros_like(dt), torch.zeros_like(A)
    dBh, dCh = torch.zeros_like(Bh), torch.zeros_like(Ch)
    dh0 = torch.zeros((Bsz, nh, hd, N), dtype=f64)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    for b in range(Bsz):
        for h in range(nh):
            rows = [slice(c * Q, (c + 1) * Q) for c in range(nc)]
            cums = [torch.cumsum(dt[b, r, h] * A[h], 0) for r in rows]
            S = [(dt[b, r, h] * torch.exp(cum[-1] - cum))[:, None].mul(
                x[b, r, h]).T @ Bh[b, r, h] for r, cum in zip(rows, cums)]
            E = [(torch.exp(cum)[:, None] * dy[b, r, h]).T @ Ch[b, r, h]
                 for r, cum in zip(rows, cums)]
            hv = torch.zeros((hd, N), dtype=f64) if h0 is None \
                else h0[b, h].to(f64)
            Hp = []
            for c in range(nc):
                Hp.append(hv)
                hv = torch.exp(cums[c][-1]) * hv + S[c]
            gv = torch.zeros((hd, N), dtype=f64) if dh is None \
                else dh[b, h].to(f64)
            Gs = [None] * nc
            for c in reversed(range(nc)):
                Gs[c] = gv
                gv = torch.exp(cums[c][-1]) * gv + E[c]
            dh0[b, h] = gv
            for c, r in enumerate(rows):
                cum, hp, g = cums[c], Hp[c], Gs[c]
                X, Y, Bc, Cc, d = (x[b, r, h], dy[b, r, h], Bh[b, r, h],
                                   Ch[b, r, h], dt[b, r, h])
                seg = torch.where(mask, cum[:, None] - cum[None, :], -1e30)
                L = torch.where(mask, torch.exp(seg), 0.0)
                s = Cc @ Bc.T
                M, W = s * L, L * d[None, :] * (Y @ X.T)
                P = s * W
                f = torch.exp(cum[-1] - cum)
                U = M.T @ Y + f[:, None] * (Bc @ g.T)
                dx[b, r, h] = d[:, None] * U
                dC_off = torch.exp(cum)[:, None] * (Y @ hp)
                dCh[b, r, h] = W @ Bc + dC_off
                dBh[b, r, h] = W.T @ Cc + (d * f)[:, None] * (X @ g)
                q = f * d * (X * (Bc @ g.T)).sum(1)
                dcum = P.sum(1) - P.sum(0) + (Cc * dC_off).sum(1) - q
                dcum[-1] += torch.exp(cum[-1]) * (g * hp).sum() + q.sum()
                da = torch.flip(torch.cumsum(torch.flip(dcum, [0]), 0), [0])
                ddt[b, r, h] = (X * U).sum(1) + A[h] * da
                dA[h] += (d * da).sum()
    dB = dBh.reshape(Bsz, T, G, hpg, N).sum(3)
    dC = dCh.reshape(Bsz, T, G, hpg, N).sum(3)
    return dx, ddt, dA, dB, dC, dh0 if h0 is not None else None


@pytest.mark.parametrize("B,T,hd,N,G,Q,with_h0,with_dh", [
    (2, 96, 16, 16, 2, 32, True, True),
    (1, 96, 8, 4, 1, 48, False, False),
    (1, 80, 8, 8, NH, 16, True, False),
])
def test_kernel_formulation_matches_the_plain_backward(B, T, hd, N, G, Q,
                                                       with_h0, with_dh):
    """The kernel's formulation in float64 against the plain backward
    (autograd through the f32 scan): 1e-6 of each gradient's scale."""
    (x, dt, A, Bm, Cm, h0), dy, dh = _inputs(B, T, NH, hd, N, G, with_h0,
                                             seed=Q)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, dy)]
    th0 = torch.from_numpy(h0) if with_h0 else None
    tdh = torch.from_numpy(dh) if with_dh else None
    want = tref.ssd_scan_bwd_ref(*t, tdh, chunk=Q, h0=th0)
    got = _kernel_formulation(*t, tdh, Q, th0)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        if w is None:
            assert g is None
            continue
        _scaled(g.numpy(), w.numpy(), 1e-6, name)


def test_missing_final_state_gradient_is_zero():
    """The backward takes no gradient of h_final (training leaves it
    unused) as a zero one (1e-6 of scale: autograd may sum the same
    terms in another order)."""
    (x, dt, A, Bm, Cm, h0), dy, _ = _inputs(1, 64, NH, 16, 16, 1, True)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, dy)]
    th0 = torch.from_numpy(h0)
    a = ops.ssd_scan_bwd(*t, None, chunk=32, h0=th0)
    b = ops.ssd_scan_bwd(*t, torch.zeros_like(th0), chunk=32, h0=th0)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), a, b):
        _scaled(g.numpy(), w.numpy(), 1e-6, name)


def _hi_lo(t):
    """t as a bf16 pair: hi = t rounded, lo = the remainder rounded (the
    kernel's ``pack_split``), both returned as float32."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _bf16_path_model(x, dt, A, Bm, Cm, dy, dh, Q, h0, kt=64):
    """The bf16 path of ``csrc/ssd_scan_bwd.cu`` in float32, tile by tile
    in the kernel's order (kt-row query and key tiles), every operand
    rounded where the kernel rounds it: x, B, C as they come (bf16); dy,
    e dy, w x, h_p, g, W and M as bf16 hi + lo pairs (the lo x lo term
    dropped where both sides are split); products accumulated in f32.
    The states pass (1)-(2), the query-side pass (3), the key-side pass
    (4) with its per-key-tile row partials, then (5)-(7)."""
    Bsz, T, nh, hd = x.shape
    G, N = Bm.shape[2:]
    nc, hpg = T // Q, nh // G
    f32 = torch.float32
    dx = torch.zeros((Bsz, T, nh, hd), dtype=f32)
    ddt = torch.zeros((Bsz, T, nh), dtype=f32)
    dA = torch.zeros((nh,), dtype=f32)
    dBh = torch.zeros((Bsz, T, nh, N), dtype=f32)
    dCh = torch.zeros((Bsz, T, nh, N), dtype=f32)
    dh0 = torch.zeros((Bsz, nh, hd, N), dtype=f32)
    tiles = [slice(t0, min(t0 + kt, Q)) for t0 in range(0, Q, kt)]
    for b in range(Bsz):
        for h in range(nh):
            g = h // hpg
            rows = [slice(c * Q, (c + 1) * Q) for c in range(nc)]
            X = [x[b, r, h].float() for r in rows]
            Bc = [Bm[b, r, g].float() for r in rows]
            Cc = [Cm[b, r, g].float() for r in rows]
            Y = [dy[b, r, h] for r in rows]
            d = [dt[b, r, h] for r in rows]
            cum = [torch.cumsum(dc * A[h], 0) for dc in d]
            S, E = [], []
            for c in range(nc):   # (1) on the tensor cores, split operands
                wx = sum(_hi_lo((d[c] * torch.exp(cum[c][-1] - cum[c]))
                                [:, None] * X[c]))
                ey = sum(_hi_lo(torch.exp(cum[c])[:, None] * Y[c]))
                S.append(wx.T @ Bc[c])
                E.append(ey.T @ Cc[c])
            gv = torch.zeros((hd, N)) if dh is None else dh[b, h].clone()
            Gs = [None] * nc
            for c in reversed(range(nc)):   # (2) reverse, then forward
                Gs[c] = _hi_lo(gv)
                gv = torch.exp(cum[c][-1]) * gv + E[c]
            dh0[b, h] = gv
            hv = torch.zeros((hd, N)) if h0 is None else h0[b, h].clone()
            Hs, gh = [], []
            for c in range(nc):
                Hs.append(_hi_lo(hv))
                gh.append(((Gs[c][0] + Gs[c][1]) * hv).sum())
                hv = torch.exp(cum[c][-1]) * hv + S[c]
            for c in range(nc):
                Yh, Yl = _hi_lo(Y[c])
                cc, dc, Xc, Bq, Cq = cum[c], d[c], X[c], Bc[c], Cc[c]
                rowc = torch.zeros(Q)
                rowparts = torch.zeros(len(tiles), Q)
                cp, q, dd = (torch.zeros(Q) for _ in range(3))
                dC = torch.zeros((Q, N))
                dB = torch.zeros((Q, N))
                u = torch.zeros((Q, hd))

                def seg(ti, tj):
                    i = torch.arange(Q)[ti][:, None]
                    j = torch.arange(Q)[tj][None, :]
                    return torch.where(
                        j <= i, torch.exp(torch.where(
                            j <= i, cc[ti][:, None] - cc[tj][None, :],
                            torch.tensor(-1e30))), torch.tensor(0.0))
                for I, ti in enumerate(tiles):   # (3) query side
                    for tj in tiles[:I + 1]:
                        D = Yh[ti] @ Xc[tj].T + Yl[ti] @ Xc[tj].T
                        Wh, Wl = _hi_lo(seg(ti, tj) * dc[tj][None, :] * D)
                        dC[ti] += Wh @ Bq[tj] + Wl @ Bq[tj]
                    hh, hl = Hs[c]
                    off = torch.exp(cc[ti])[:, None] * (
                        Yh[ti] @ hh + Yl[ti] @ hh + Yh[ti] @ hl)
                    rowc[ti] = (Cq[ti] * off).sum(1)
                    dC[ti] += off
                for J, tj in enumerate(tiles):   # (4) key side
                    for ti in tiles[J:]:
                        sT = Bq[tj] @ Cq[ti].T
                        dT = Xc[tj] @ Yh[ti].T + Xc[tj] @ Yl[ti].T
                        LT = seg(ti, tj).T
                        WT = LT * dc[tj][:, None] * dT
                        P = sT * WT
                        cp[tj] += P.sum(1)
                        rowparts[J, ti] = P.sum(0)
                        Mh, Ml = _hi_lo(sT * LT)
                        u[tj] += Mh @ Yh[ti] + Ml @ Yh[ti] + Mh @ Yl[ti]
                        Wh, Wl = _hi_lo(WT)
                        dB[tj] += Wh @ Cq[ti] + Wl @ Cq[ti]
                    gg = Gs[c][0] + Gs[c][1]
                    f = torch.exp(cc[-1] - cc[tj])
                    gB = f[:, None] * (Bq[tj] @ gg.T)
                    u[tj] += gB
                    q[tj] = dc[tj] * (Xc[tj] * gB).sum(1)
                    dd[tj] = (Xc[tj] * u[tj]).sum(1)
                    dB[tj] += (dc[tj] * f)[:, None] * (Xc[tj] @ gg)
                r = rows[c]
                dx[b, r, h] = dc[:, None] * u
                dBh[b, r, h] = dB
                dCh[b, r, h] = dC
                dcum = rowc + rowparts.sum(0) - cp - q   # (5)
                dcum[-1] += torch.exp(cc[-1]) * gh[c] + q.sum()
                da = torch.flip(torch.cumsum(torch.flip(dcum, [0]), 0), [0])
                ddt[b, r, h] = dd + A[h] * da
                dA[h] += (dc * da).sum()
    dB = dBh.reshape(Bsz, T, G, hpg, N).sum(3)   # (6)
    dC = dCh.reshape(Bsz, T, G, hpg, N).sum(3)
    bf = torch.bfloat16
    return (dx.to(bf), ddt, dA, dB.to(bf), dC.to(bf),
            dh0 if h0 is not None else None)


@pytest.mark.parametrize("B,T,hd,N,G,Q,with_h0,with_dh", [
    (1, 160, 16, 16, 1, 80, True, True),
    (1, 160, 16, 16, NH, 80, False, False),
    (2, 96, 16, 16, 2, 48, True, False),
    (1, 256, 16, 32, 1, 128, False, True),
])
def test_bf16_path_rounding_meets_the_tolerance(B, T, hd, N, G, Q, with_h0,
                                                with_dh):
    """The bf16 kernel's rounding scheme (``_bf16_path_model``: dy, W, M
    and the made state operands as bf16 hi + lo pairs) against the plain
    backward on the same bf16 inputs: 2e-2 of each gradient's scale (the
    card's tolerance), d dt and dA included, over partial last tiles (Q 80,
    48), G = 1 and G = nh, with and without h0 and dh."""
    (x, dt, A, Bm, Cm, h0), dy, dh = _inputs(B, T, NH, hd, N, G, with_h0,
                                             seed=Q + G)
    bf = torch.bfloat16
    xb, Bb, Cb = (torch.from_numpy(a).to(bf) for a in (x, Bm, Cm))
    t = [torch.from_numpy(a) for a in (dt, A, dy)]
    th0 = torch.from_numpy(h0) if with_h0 else None
    tdh = torch.from_numpy(dh) if with_dh else None
    want = tref.ssd_scan_bwd_ref(xb, t[0], t[1], Bb, Cb, t[2], tdh, chunk=Q,
                                 h0=th0)
    got = _bf16_path_model(xb, t[0], t[1], Bb, Cb, t[2], tdh, Q, th0)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _scaled(g.float().numpy(), w.float().numpy(), 2e-2, name)
