"""OmSim-style .plt result files: the reference's result-inspection
surface (odc/omu.tcl: omu_write_plt:68, omu_read_plt:23, omu_plot:107).

Port of ``hqp_tpu/omu/plt_io.py``: files are written and read in host
numpy as there (the same bytes from the same inputs); only
:func:`solver_trajectory` reads the port's solver, whose iterate and time
grid are tensors on the program's device (one counted copy each).

Format (omu.tcl:80-100):

    <npoints> 0 <ncols>
    time
    x0
    ...
    u0
    ...
    <t_0> <x_0 values> <u_0 values>
    ...
    <t_K> <x_K values> <u_{K-1} values>   (controls of the last stage
                                           rewritten at the final time)

The reader mirrors omu_read_plt's windowing semantics: optional
[tstart, tend] clipping, a minimum time step dtmin, and
duplicate-time rows REPLACING the previous point (omu.tcl:44-53) --
the convention OmSim records use (odc/record.plt ships in that form
and feeds the estimation examples, odc/cranepar.tcl:23).
"""

from __future__ import annotations

import numpy as np

from hqp_tpu_torch.utils import sync


def write_plt(path, ts, X, U, names=None, tscale=1.0):
    """Write a trajectory: ts [K+1], X [K+1, nx], U [K, nu] (piecewise
    constant controls; the terminal row repeats u_{K-1}, omu.tcl:96-99)."""
    ts = np.asarray(ts, float)
    X = np.atleast_2d(np.asarray(X, float))
    U = np.asarray(U, float).reshape(len(ts) - 1, -1)
    K1, nx = X.shape
    nu = U.shape[1]
    if names is None:
        names = [f"x{i}" for i in range(nx)] + [f"u{i}" for i in range(nu)]
    with open(path, "w") as fh:
        fh.write(f"{K1} 0 {nx + nu + 1}\n")
        fh.write("time\n")
        for n in names:
            fh.write(f"{n}\n")
        Upad = np.concatenate([U, U[-1:]], axis=0) if nu else \
            np.zeros((K1, 0))
        for k in range(K1):
            row = [tscale * ts[k]] + list(X[k]) + list(Upad[k])
            fh.write(" ".join(repr(float(v)) for v in row) + "\n")


def read_plt(path, tstart=None, tend=None, dtmin=0.0):
    """Read a .plt file -> (names, data [npoints, ncols]); names[0] is
    'time'.  Windowing/duplicate semantics follow omu_read_plt
    (odc/omu.tcl:23-58): rows with a repeated time REPLACE the previous
    point, rows closer than dtmin to the last accepted point are
    skipped."""
    with open(path) as fh:
        header = fh.readline().split()
        ncols = int(header[2])
        names = [fh.readline().strip() for _ in range(ncols)]
        rows = []
        tprev = None
        for line in fh:
            vals = line.split()
            if not vals:
                continue
            vals = [float(v) for v in vals[:ncols]]
            t = vals[0]
            if tstart is not None and t < tstart:
                continue
            if tend is not None and t > tend:
                break
            if tprev is not None and t == tprev:
                rows[-1] = vals            # replace until time increases
            elif tprev is None or t >= tprev + dtmin:
                rows.append(vals)
                tprev = t
    return names, np.asarray(rows, float)


def plot_series(ts, X, U, sidx, tscale=1.0):
    """The (xdata, ydata) polyline omu_plot draws for variable index
    ``sidx`` (states 0..nx-1, then controls): controls are expanded as
    piecewise-constant staircases (odc/omu.tcl:160-166)."""
    ts = np.asarray(ts, float) * tscale
    X = np.atleast_2d(np.asarray(X, float))
    U = np.asarray(U, float).reshape(len(ts) - 1, -1)
    nx = X.shape[1]
    if sidx < nx:
        return list(ts), [float(v) for v in X[:, sidx]]
    ui = sidx - nx
    xd, yd = [], []
    for k in range(U.shape[0]):
        xd += [ts[k], ts[k + 1]]
        yd += [float(U[k, ui])] * 2
    return xd, yd


def solver_trajectory(solver):
    """(ts, X, U) from a solved SQP solver over an Omu-style program
    (states first, controls after, per stage; terminal controls are
    padding), as host arrays."""
    prg = solver.prg
    nx, nu = prg.nx, prg.nu
    x = sync.to_host(solver.x)
    X = x[:, :nx]
    U = x[:-1, nx:nx + nu]
    ts = sync.to_host(prg.ts)[:: getattr(prg, "sps", 1)] \
        if getattr(prg, "ts", None) is not None \
        else np.arange(X.shape[0], dtype=float)
    return ts, X, U
