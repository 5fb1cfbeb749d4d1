"""The reference's system matrix, assembled row by row as EC3D.f90's
``gen_sparse_matrix`` (465-1049) builds it, into a scipy CSR matrix.

Unknowns ``[Ax | Ay | Az | U]``: A on every cell (flat grid order, x
fastest), U on the conducting cells only, numbered in the same order
(EC3D.f90:101-106).  The per-cell ladder is a copy of the repository's
test oracle (``tests/oracle.py`` ``OracleSystem``), a transcription of the
Fortran with 1-based (i, j, k) and 1-based columns: the conductor's A rows
with their inertial term and their grad-U coupling, one-sided
``(-3, +4, -1)`` at the conductor's surface (667-710), and the U rows'
corner, edge and face cases in the Fortran's order (766-922), the sign
quirk of the (x-, y+, z+) corner included.  The A rows of the other cells
are the 7-point Laplacian with the outer faces' boundary multipliers
(528-651), the same rows the ladder builds, written out over all cells at
once.  None of it shares code with the program, which assembles by mask
algebra over shifted grids.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import sparse

__all__ = ["System", "assemble"]


@dataclass
class System:
    M: sparse.csr_matrix        # (3N + Nc) square
    N: int                      # cells
    cond: np.ndarray            # (Nc,) flat cells of the U unknowns
    inert: np.ndarray           # (Nc,) 2C/dt on those cells
    bnd_a: np.ndarray           # A rows with a one-sided grad-U stencil
    bnd_u: np.ndarray           # U rows (3N + m) of the ladder's cases


def _laplacian_rows(shape_xyz, delta, bnd, skip):
    """(rows, cols, vals), 0-based, of the A rows of every cell that
    ``skip`` (flat bool) does not mark, for Ax; the ladder per axis: a cell
    on the minus face takes its plus neighbour times ``bnd[a, 1]``, one on
    the plus face its minus neighbour times ``bnd[a, 0]``, each with one
    ``s_a`` on the diagonal; inside, ``-s_a`` to both and ``2 s_a``."""
    nx, ny, nz = shape_xyz
    n = np.flatnonzero(~skip)
    ijk = (n % nx, (n // nx) % ny, n // (nx * ny))
    strides = (1, nx, nx * ny)
    rows, cols, vals = [], [], []
    diag = np.zeros(n.size)
    for a in range(3):
        c, sd, st = ijk[a], (nx, ny, nz)[a], strides[a]
        s = 1.0 / float(delta[a]) ** 2
        lo, hi = c == 0, c == sd - 1
        mid = ~lo & ~hi
        for sel, col, val in ((lo, n + st, bnd[a, 1] * s),
                              (hi, n - st, bnd[a, 0] * s),
                              (mid, n - st, -s), (mid, n + st, -s)):
            rows.append(n[sel])
            cols.append(col[sel])
            vals.append(np.full(int(sel.sum()), val))
        diag += np.where(mid, 2 * s, s)
    rows.append(n)
    cols.append(n)
    vals.append(diag)
    return tuple(np.concatenate(x) for x in (rows, cols, vals))


def assemble(case) -> System:
    """The case's system matrix and its boundary row lists."""
    sdx, sdy, sdz = case.shape_xyz
    N = sdx * sdy * sdz
    dx, dy, dz = (float(v) for v in case.delta)
    sx, sy, sz = 1 / dx**2, 1 / dy**2, 1 / dz**2
    dsx, dsy, dsz = 0.5 / dx, 0.5 / dy, 0.5 / dz
    dt = case.dt
    bnd = np.asarray(case.bnd, float)

    Cgeo = case.C[case.geo]                          # (nz, ny, nx)
    condmask = (Cgeo != 0).reshape(-1)
    cond = np.flatnonzero(condmask)
    # geo and the U column (3N + m, 1-based; 0 off the conductor) in the
    # Fortran's layout, padded by 2 cells of air
    geo = np.zeros((sdx + 4, sdy + 4, sdz + 4), np.int64)
    geo[2:-2, 2:-2, 2:-2] = np.transpose(case.geo, (2, 1, 0))
    number = np.zeros(N, np.int64)
    number[cond] = 3 * N + np.arange(1, cond.size + 1)
    gc = np.zeros_like(geo)
    gc[2:-2, 2:-2, 2:-2] = np.transpose(number.reshape(sdz, sdy, sdx),
                                        (2, 1, 0))

    def fc(i, j, k):
        return int(gc[i + 1, j + 1, k + 1])

    # the Laplacian rows of every cell outside the conductor's interior
    ii, jj, kk = cond % sdx, (cond // sdx) % sdy, cond // (sdx * sdy)
    inner = ((ii > 0) & (ii < sdx - 1) & (jj > 0) & (jj < sdy - 1)
             & (kk > 0) & (kk < sdz - 1))
    skip = np.zeros(N, bool)
    skip[cond[inner]] = True
    r0, c0, v0 = _laplacian_rows(case.shape_xyz, case.delta, bnd, skip)
    R = [r0, r0 + N, r0 + 2 * N]
    Cc = [c0 + 1, c0 + 1 + N, c0 + 1 + 2 * N]       # 1-based from here
    V = [v0, v0, v0]
    rows, cols, vals = [], [], []
    bndX, bndY, bndZ = [], [], []
    bndUx, bndUy, bndUz = [], [], []

    def put(row, cs, vs):
        if min(cs) <= 0:      # the reference STOPs: a U column off the grid
            raise ValueError(f"row {row}: a column <= 0")
        rows.extend([row] * len(cs))
        cols.extend(cs)
        vals.extend(vs)

    for flat, inside in zip(cond.tolist(), inner.tolist()):
        i = flat % sdx + 1
        j = (flat // sdx) % sdy + 1
        k = flat // (sdx * sdy) + 1
        nn = flat + 1
        C = float(Cgeo.reshape(-1)[flat])
        kim, kip = nn - 1, nn + 1
        kjm, kjp = nn - sdx, nn + sdx
        kkm, kkp = nn - sdx * sdy, nn + sdx * sdy

        if inside:
            # ---- the conductor's A rows (EC3D.f90:649-710) ----
            colX = [kim, kip, kjm, kjp, kkm, kkp, nn]
            valX = [-sx, -sx, -sy, -sy, -sz, -sz, 2 * (sx + sy + sz)]
            valX[6] += 2 * C / dt
            colY = [c + N for c in colX]
            valY = list(valX)
            colZ = [c + 2 * N for c in colX]
            valZ = list(valX)
            for ax, ds_, cols_, vals_, bl in (
                    (0, dsx, colX, valX, bndX), (1, dsy, colY, valY, bndY),
                    (2, dsz, colZ, valZ, bndZ)):
                def off(d, ax=ax):
                    return ((i + d, j, k), (i, j + d, k), (i, j, k + d))[ax]
                if fc(*off(+1)) == 0:
                    cols_ += [fc(i, j, k), fc(*off(-1)), fc(*off(-2))]
                    vals_ += [-3 * C * ds_, 4 * C * ds_, -1 * C * ds_]
                    bl.append(nn + ax * N)
                elif fc(*off(-1)) == 0:
                    cols_ += [fc(i, j, k), fc(*off(+1)), fc(*off(+2))]
                    vals_ += [3 * C * ds_, -4 * C * ds_, 1 * C * ds_]
                    bl.append(nn + ax * N)
                else:
                    cols_ += [fc(*off(+1)), fc(*off(-1))]
                    vals_ += [-C * ds_, C * ds_]
            put(nn, colX, valX)
            put(N + nn, colY, valY)
            put(2 * N + nn, colZ, valZ)

        # ---- the U row (EC3D.f90:766-922) ----
        nc = fc(i, j, k)
        nim, nip = fc(i - 1, j, k), fc(i + 1, j, k)
        njm, njp = fc(i, j - 1, k), fc(i, j + 1, k)
        nkm, nkp = fc(i, j, k - 1), fc(i, j, k + 1)
        S = 2 * (sx + sy + sz)
        ax_, ay_, az_ = 2.0 / (dt * dx), 2.0 / (dt * dy), 2.0 / (dt * dz)
        fx = fy = fz = 0
        if nim == 0 and njm == 0 and nkm == 0:
            cs = [nip, njp, nkp, nc, nn, N + nn, 2 * N + nn]
            vs = [-2 * sx, -2 * sy, -2 * sz, S, -ax_, -ay_, -az_]
            fx = fy = fz = 1
        elif nip == 0 and njm == 0 and nkm == 0:
            cs = [nim, njp, nkp, nc, nn, N + nn, 2 * N + nn]
            vs = [-2 * sx, -2 * sy, -2 * sz, S, +ax_, -ay_, -az_]
            fx = fy = fz = 1
        elif nim == 0 and njp == 0 and nkm == 0:
            cs = [nip, njm, nkp, nc, nn, N + nn, 2 * N + nn]
            vs = [-2 * sx, -2 * sy, -2 * sz, S, -ax_, +ay_, -az_]
            fx = fy = fz = 1
        elif nip == 0 and njp == 0 and nkm == 0:
            cs = [nim, njm, nkp, nc, nn, N + nn, 2 * N + nn]
            vs = [-2 * sx, -2 * sy, -2 * sz, S, +ax_, +ay_, -az_]
            fx = fy = fz = 1
        elif nim == 0 and njm == 0 and nkp == 0:
            cs = [nip, njp, nkm, nc, nn, N + nn, 2 * N + nn]
            vs = [-2 * sx, -2 * sy, -2 * sz, S, -ax_, -ay_, +az_]
            fx = fy = fz = 1
        elif nip == 0 and njm == 0 and nkp == 0:
            cs = [nim, njp, nkm, nc, nn, N + nn, 2 * N + nn]
            vs = [-2 * sx, -2 * sy, -2 * sz, S, +ax_, -ay_, +az_]
            fx = fy = fz = 1
        elif nim == 0 and njp == 0 and nkp == 0:
            # the reference's sign quirk (EC3D.f90:803-806)
            cs = [nip, njm, nkm, nc, nn, N + nn, 2 * N + nn]
            vs = [-2 * sx, -2 * sy, -2 * sz, S, +ax_, -ay_, +az_]
            fx = fy = fz = 1
        elif nip == 0 and njp == 0 and nkp == 0:
            cs = [nim, njm, nkm, nc, nn, N + nn, 2 * N + nn]
            vs = [-2 * sx, -2 * sy, -2 * sz, S, +ax_, +ay_, +az_]
            fx = fy = fz = 1
        elif njp == 0 and nkm == 0:
            cs = [nip, nim, njm, nkp, nc, N + nn, 2 * N + nn]
            vs = [-sx, -sx, -2 * sy, -2 * sz, S, +ay_, -az_]
            fy = fz = 1
        elif njm == 0 and nkm == 0:
            cs = [nip, nim, njp, nkp, nc, N + nn, 2 * N + nn]
            vs = [-sx, -sx, -2 * sy, -2 * sz, S, -ay_, -az_]
            fy = fz = 1
        elif njp == 0 and nkp == 0:
            cs = [nip, nim, njm, nkm, nc, N + nn, 2 * N + nn]
            vs = [-sx, -sx, -2 * sy, -2 * sz, S, +ay_, +az_]
            fy = fz = 1
        elif njm == 0 and nkp == 0:
            cs = [nip, nim, njp, nkm, nc, N + nn, 2 * N + nn]
            vs = [-sx, -sx, -2 * sy, -2 * sz, S, -ay_, +az_]
            fy = fz = 1
        elif nip == 0 and nkm == 0:
            cs = [nim, njm, njp, nkp, nc, nn, 2 * N + nn]
            vs = [-2 * sx, -sy, -sy, -2 * sz, S, +ax_, -az_]
            fx = fz = 1
        elif nim == 0 and nkm == 0:
            cs = [nip, njm, njp, nkp, nc, nn, 2 * N + nn]
            vs = [-2 * sx, -sy, -sy, -2 * sz, S, -ax_, -az_]
            fx = fz = 1
        elif nip == 0 and nkp == 0:
            cs = [nim, njm, njp, nkm, nc, nn, 2 * N + nn]
            vs = [-2 * sx, -sy, -sy, -2 * sz, S, +ax_, +az_]
            fx = fz = 1
        elif nim == 0 and nkp == 0:
            cs = [nip, njm, njp, nkm, nc, nn, 2 * N + nn]
            vs = [-2 * sx, -sy, -sy, -2 * sz, S, -ax_, +az_]
            fx = fz = 1
        elif nim == 0 and njm == 0:
            cs = [nip, njp, nkp, nkm, nc, nn, N + nn]
            vs = [-2 * sx, -2 * sy, -sz, -sz, S, -ax_, -ay_]
            fx = fy = 1
        elif nip == 0 and njm == 0:
            cs = [nim, njp, nkp, nkm, nc, nn, N + nn]
            vs = [-2 * sx, -2 * sy, -sz, -sz, S, +ax_, -ay_]
            fx = fy = 1
        elif nim == 0 and njp == 0:
            cs = [nip, njm, nkp, nkm, nc, nn, N + nn]
            vs = [-2 * sx, -2 * sy, -sz, -sz, S, -ax_, +ay_]
            fx = fy = 1
        elif nip == 0 and njp == 0:
            cs = [nim, njm, nkm, nkp, nc, nn, N + nn]
            vs = [-2 * sx, -2 * sy, -sz, -sz, S, +ax_, +ay_]
            fx = fy = 1
        elif nim == 0 and njp != 0 and njm != 0 and nkp != 0 and nkm != 0:
            cs = [nip, njm, njp, nkm, nkp, nc, nn]
            vs = [-2 * sx, -sy, -sy, -sz, -sz, S, -ax_]
            fx = 1
        elif nip == 0 and njp != 0 and njm != 0 and nkp != 0 and nkm != 0:
            cs = [nim, njm, njp, nkm, nkp, nc, nn]
            vs = [-2 * sx, -sy, -sy, -sz, -sz, S, +ax_]
            fx = 1
        elif njp == 0 and nip != 0 and nim != 0 and nkp != 0 and nkm != 0:
            cs = [nim, nip, njm, nkm, nkp, nc, N + nn]
            vs = [-sx, -sx, -2 * sy, -sz, -sz, S, +ay_]
            fy = 1
        elif njm == 0 and nip != 0 and nim != 0 and nkp != 0 and nkm != 0:
            cs = [nim, nip, njp, nkm, nkp, nc, N + nn]
            vs = [-sx, -sx, -2 * sy, -sz, -sz, S, -ay_]
            fy = 1
        elif nkp == 0 and nip != 0 and nim != 0 and njp != 0 and njm != 0:
            cs = [nim, nip, njm, njp, nkm, nc, 2 * N + nn]
            vs = [-sx, -sx, -sy, -sy, -2 * sz, S, +az_]
            fz = 1
        elif nkm == 0 and nip != 0 and nim != 0 and njp != 0 and njm != 0:
            cs = [nim, nip, njm, njp, nkp, nc, 2 * N + nn]
            vs = [-sx, -sx, -sy, -sy, -2 * sz, S, -az_]
            fz = 1
        else:
            cs = [nim, nip, njm, njp, nkm, nkp, nc,
                  kip, kim, N + kjp, N + kjm, 2 * N + kkp, 2 * N + kkm]
            vs = [-sx, -sx, -sy, -sy, -sz, -sz, S,
                  -0.5 / (dt * dx), 0.5 / (dt * dx),
                  -0.5 / (dt * dy), 0.5 / (dt * dy),
                  -0.5 / (dt * dz), 0.5 / (dt * dz)]
        if fx:
            bndUx.append(nc)
        if fy:
            bndUy.append(nc)
        if fz:
            bndUz.append(nc)
        put(nc, cs, vs)

    n = 3 * N + cond.size
    r = np.concatenate(R + [np.asarray(rows, np.int64) - 1])
    c = np.concatenate(Cc + [np.asarray(cols, np.int64)]) - 1
    v = np.concatenate(V + [np.asarray(vals, np.float64)])
    coo = sparse.coo_matrix((v, (r, c)), shape=(n, n))
    M = coo.tocsr()
    M.sum_duplicates()
    # the Fortran's duplicate-column guard (EC3D.f90:924-936): no row may
    # name a column twice
    if M.nnz != coo.nnz:
        raise ValueError("a row names a column twice")
    as_idx = lambda xs: np.asarray(sorted(set(xs)), np.int64) - 1
    return System(M=M, N=N, cond=cond, inert=2.0 * Cgeo.reshape(-1)[cond] / dt,
                  bnd_a=as_idx(bndX + bndY + bndZ),
                  bnd_u=as_idx(bndUx + bndUy + bndUz))
