"""Command shell: the reference's Tcl command surface as a string interface.

Port of ``hqp_tpu/shell.py``.  The reference drives everything through
Tcl commands bound by the iftcl layer (iftcl/If_Element.h; SURVEY.md
section 2.4): module selection (``prg_name Crane``, ``sqp_solver
Powell``, ``qp_mat_solver LQDOCP``), typed knobs (``sqp_eps 1e-6``,
``prg_kmax 100``), actions (``prg_setup``, ``sqp_init``, ``hqp_solve``)
and result readback (``prg_f``, ``sqp_norm_inf``).  This module
reproduces that command surface over the registry so reference-style
driver scripts keep working:

    sh = Shell()                       # programs on the card
    sh.run('''
        prg_name DID
        prg_setup
        sqp_init
        hqp_solve
    ''')
    sh("prg_f")   -> objective

Every program the shell creates gets the shell's ``device`` (the card
unless the caller names another, ``Shell(device="cpu")``; a program
raises where the card is asked for and there is none).  Commands return
strings (like Tcl); unknown ``<obj>_<attr>`` commands resolve against
registered knob tables, mirroring If_Int/If_Real bindings.  A tensor read
back by a knob is one counted host read.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

# ensure all modules self-register (Hqp_Init/Omu_Init role)
import hqp_tpu_torch.all_modules  # noqa: F401
from hqp_tpu_torch.omu import plt_io
from hqp_tpu_torch.qp import mehrotra as ip
from hqp_tpu_torch.utils.diagnostics import prg_test, qp_dump
from hqp_tpu_torch.utils.registry import modules
from hqp_tpu_torch.utils.sync import host


def _parse(v: str):
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    return v


def _tcl_words(s: str):
    """Tokenize a command line into Tcl words: plain words, "quoted"
    strings and {braced} lists (nesting honored, matching Tcl's list
    semantics -- iftcl/If_RealVec vectors arrive as brace lists).
    Returns (kind, text) pairs; raises on unbalanced braces/quotes
    instead of silently mis-splitting."""
    words = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
            continue
        if c == "{":
            depth, j = 1, i + 1
            while j < n and depth:
                if s[j] == "{":
                    depth += 1
                elif s[j] == "}":
                    depth -= 1
                j += 1
            if depth:
                raise ValueError(f"unbalanced braces in {s!r}")
            words.append(("brace", s[i + 1:j - 1]))
            i = j
        elif c == '"':
            j = s.find('"', i + 1)
            if j < 0:
                raise ValueError(f"unbalanced quote in {s!r}")
            words.append(("str", s[i + 1:j]))
            i = j + 1
        else:
            j = i
            while j < n and not s[j].isspace():
                j += 1
            words.append(("plain", s[i:j]))
            i = j
    return words


def _parse_word(kind, text):
    if kind == "brace":
        return [_parse_word(k, t) for k, t in _tcl_words(text)]
    if kind == "str":
        return text
    return _parse(text)


class Shell:
    """Reference-compatible command interface (hqp/hqp_solve.tcl driver)."""

    #: knob tables: Tcl name -> attribute path on (prg | solver | qp_solver)
    SQP_KNOBS = {
        "sqp_eps": "eps", "sqp_max_iters": "max_iters",
        "sqp_iter": "iter!", "sqp_inf_iters": "inf_iters!",
        "sqp_max_inf_iters": "max_inf_iters",
        "sqp_min_alpha": "min_alpha", "sqp_alpha": "alpha!",
        "sqp_norm_inf": "norm_inf!", "sqp_norm_grd_L": "norm_grd_L!",
        "sqp_norm_s": "norm_dx!", "sqp_norm_x": "norm_x!",
        "sqp_norm_df": "norm_df!", "sqp_sQs": "sQs!", "sqp_xQx": "xQx!",
        "sqp_logging": "logging",
        # Powell watchdog (hqp/Hqp_SqpPowell.C:63-65)
        "sqp_watchdog_start": "watchdog_start",
        "sqp_watchdog_credit": "watchdog_credit",
        "sqp_watchdog_relaxed_steps": "wd_relaxed_steps!",
        "sqp_watchdog_backouts": "wd_backouts!",
        "sqp_damped_multipliers": "damped_multipliers",
    }
    QP_KNOBS = {
        "qp_eps": "eps", "qp_max_iters": "max_iters",
        "qp_max_warm_iters": "max_warm_iters", "qp_init_method":
        "init_method", "qp_gammaf": "gammaf",
    }
    #: mdl_* knobs (omu/Prg_DynamicOpt.C:121-170) -> DynamicOpt/DynamicEst
    #: constructor arguments; values set before prg_name re-create the
    #: program like the reference's setup-stage knob evaluation
    MDL_KNOBS = {
        "mdl_x0": "x0",
        "mdl_x_periodic": "x_periodic", "mdl_u_periodic": "u_periodic",
        "mdl_u_min": "u_min", "mdl_u_max": "u_max", "mdl_u0": "u_init",
        "mdl_der_u_min": "du_min", "mdl_der_u_max": "du_max",
        "mdl_der_u_weight2": "du_weight2",
        "mdl_u_ref": "u_ref", "mdl_u_weight1": "u_weight1",
        "mdl_u_weight2": "u_weight2",
        "mdl_y_ref": "y_ref", "mdl_y_weight1": "y_weight1",
        "mdl_y_weight2": "y_weight2",
        "mdl_y_min": "y_min", "mdl_y_max": "y_max",
        "mdl_yf_ref": "yf_ref", "mdl_yf_weight1": "yf_weight1",
        "mdl_yf_weight2": "yf_weight2",
        "mdl_yf_min": "yf_min", "mdl_yf_max": "yf_max",
        "mdl_y_soft_min": "y_soft_min", "mdl_y_soft_max": "y_soft_max",
        "mdl_y_soft_weight1": "s_lin", "mdl_y_soft_weight2": "s_quad",
        "mdl_u_order": "u_order", "mdl_u_decimation": "decimation",
        "mdl_t_scale_active": "t_scale",
        "mdl_t_scale_min": "t_scale_min", "mdl_t_scale_max": "t_scale_max",
        "mdl_t0": "t0", "mdl_tf": "tf",
        # DynamicEst names (omu/Prg_DynamicEst)
        "mdl_p_active": "p_active", "mdl_p_min": "p_min",
        "mdl_p_max": "p_max", "mdl_x0_active": "x0_active",
        "mdl_y_active": "y_active",
    }

    def __init__(self, rcfile=None, device="cuda"):
        #: the device of every program the shell creates
        self.device = device
        self.prg = None
        self.solver = None
        self._sqp_name = "Powell"
        self._qp_mat_name = None
        self._hela_name = None
        self._prg_kwargs = {}
        # startup file, the ~/.hqprc role (hqp/Hqp_Init.C:215-219); off
        # with HQP_TPU_RC=0 or rcfile=False
        if rcfile is None and os.environ.get("HQP_TPU_RC", "1") != "0":
            rcfile = os.path.expanduser("~/.hqprc")
        if rcfile and os.path.isfile(rcfile):
            try:
                with open(rcfile) as fh:
                    self.run(fh.read())
            except Exception:  # rc errors must not kill the shell
                pass

    # -- dispatch ------------------------------------------------------------

    def __call__(self, line: str) -> str:
        # Tcl words: {1 {2 3}} nests into Python lists (real tokenizer,
        # not a quote-substitution -- nested braces parse correctly)
        words = _tcl_words(line)
        if not words:
            return ""
        cmd = words[0][1]
        args = [_parse_word(k, t) for k, t in words[1:]]
        fn = getattr(self, "cmd_" + cmd, None)
        if fn is not None:
            return str(fn(*args))
        return str(self._knob(cmd, args))

    def run(self, script: str):
        """Execute a newline/';'-separated command script; returns the
        list of results (odc/run analog)."""
        out = []
        for raw in script.replace(";", "\n").splitlines():
            line = raw.split("#")[0].strip()
            if line:
                out.append(self(line))
        return out

    # -- module selection ----------------------------------------------------

    def cmd_prg_name(self, name=None):
        if name is None:
            return self.prg.name if self.prg else "None"
        self._prg_name = name
        self._create_prg()
        return name

    def _create_prg(self):
        self.prg = modules.create("prg_name", self._prg_name,
                                  device=self.device, **self._prg_kwargs)

    def cmd_sqp_solver(self, name=None):
        if name is None:
            return self._sqp_name
        self._sqp_name = name
        return name

    def cmd_sqp_hela(self, name=None):
        """Hessian-approximation module selection (reference:
        ``sqp_hela BFGS``, hqp/Hqp_Init.C:203)."""
        if name is None:
            if self._hela_name:
                return self._hela_name
            if self.solver is not None:
                return type(self.solver.hela).__name__
            return "BFGS"
        self._hela_name = name
        if self.solver is not None:
            self.solver.hela = modules.create("sqp_hela", name)
        return name

    def cmd_sqp_qp_solver(self, name=None):
        """QP solver module selection (reference: ``sqp_qp_solver
        Mehrotra``, hqp/Hqp_Init.C:202-204)."""
        if name is None:
            return getattr(self, "_qp_solver_name", "Mehrotra")
        self._qp_solver_name = name
        return name

    def cmd_qp_mat_solver(self, name=None):
        if name is None:
            return self._qp_mat_name or "SpSC"
        self._qp_mat_name = name
        return name

    def cmd_prg_integrator(self, name=None, steps=None):
        """Integrator module selection (reference: ``prg_integrator RK4``,
        omu/Hqp_Omuses.C:83).  Optional second argument sets the number
        of fixed sub-steps (prg_int_stepsize role)."""
        if name is None:
            it = getattr(self.prg, "integrator", None)
            return type(it).__name__ if it is not None else "None"
        if self.prg is None or not hasattr(self.prg, "integrator"):
            raise KeyError("current program has no integrator slot")
        kw = {"steps": int(steps)} if steps is not None else {}
        self.prg.integrator = modules.create("prg_integrator", name, **kw)
        return name

    # -- actions (hqp_solve.tcl command set) ---------------------------------

    def _need_solver(self):
        if self.solver is None:
            kw = {}
            if self._qp_mat_name:
                kw["kkt_backend"] = modules.create(
                    "qp_mat_solver", self._qp_mat_name)
            qp_name = getattr(self, "_qp_solver_name", None)
            if qp_name:
                kw["qp_solver"] = modules.create("sqp_qp_solver", qp_name)
            if self._hela_name:
                kw["hela"] = modules.create("sqp_hela", self._hela_name)
            self.solver = modules.create("sqp_solver", self._sqp_name,
                                         self.prg, **kw)
        return self.solver

    def cmd_prg_setup(self):
        s = self._need_solver()
        s.init()
        return "ok"

    def cmd_prg_simulate(self):
        self._need_solver().simulate()
        return "ok"

    def cmd_sqp_init(self):
        if self.solver is None or self.solver.x is None:
            self.cmd_prg_setup()
        return "ok"

    def cmd_hqp_solve(self):
        return self._need_solver().solve()

    def cmd_hqp_solve_hot(self):
        return self._need_solver().solve_hot()

    def cmd_sqp_qp_update(self):
        self._need_solver().qp_update()
        return "ok"

    def cmd_sqp_qp_solve(self):
        self._need_solver().qp_solve()
        return "ok"

    def cmd_sqp_step(self):
        self._need_solver().step()
        return "ok"

    def cmd_sqp_qp_reinit_bd(self):
        self._need_solver().qp_reinit_bd()
        return "ok"

    def cmd_sqp_hela_restart(self):
        self._need_solver().hela_restart()
        return "ok"

    def cmd_prg_test(self):
        """Finite-difference derivative check at the current iterate
        (Hqp_SqpProgram::test, hqp/Hqp_SqpProgram.C:116)."""
        s = self._need_solver()
        info = prg_test(self.prg, v=s.x)
        return f"ok max_rel_err {info['max_rel_err']:.3e}"

    def cmd_prg_qp_dump(self, path="qp_dump.npz"):
        """Dump the current QP linearization for offline analysis
        (Hqp_SqpProgram::qp_dump, hqp/Hqp_SqpProgram.C:188)."""
        s = self._need_solver()
        if s.qp is None:
            s.qp_update()
        qp_dump(s.qp, path)
        return path

    def cmd_prg_f(self):
        return host(self.solver.f)

    # -- mixed-integer layer (hqp_solve.tcl:258-262 runs the mip solver
    # over the final relaxation after SQP) --------------------------------

    def cmd_mip_solver(self, name=None):
        if name is None:
            return getattr(self, "_mip_name", "LPSolve")
        self._mip_name = name
        return name

    def cmd_mip_solve(self):
        """Branch & bound over the final QP relaxation, in absolute
        variables, honoring the program's ``x_int`` marks
        (Hqp_Program x_int role, hqp/Hqp_Program.h:47)."""
        prg = self.prg
        int_mask = getattr(prg, "x_int", None)
        if int_mask is None or not np.asarray(int_mask).any():
            raise KeyError("program defines no integer variables (x_int)")
        s = self._need_solver()
        qp, x = s.qp, s.x
        # shift the step-QP (variable dx) to absolute variables z = x + dx
        qp_abs = dataclasses.replace(
            qp, c=qp.c - qp.Q @ x, b=qp.b - qp.A @ x, d=qp.d - qp.C @ x)
        bb = modules.create("mip_solver",
                            getattr(self, "_mip_name", "LPSolve"))
        z, fqp, status = bb.solve(qp_abs, np.asarray(int_mask))
        self._mip_status = status
        if z is not None:
            self._mip_x = z
            self._mip_f = host(prg._eval(z)[0])
        else:
            self._mip_x, self._mip_f = None, float("nan")
        return status

    def cmd_mip_f(self):
        return self._mip_f

    def cmd_mip_x(self):
        return host(self._mip_x)

    def cmd_qp_result(self):
        return ip.RESULT_STRINGS[self.solver.status]

    def cmd_qp_iter(self):
        return self.solver.qp_iters_last

    # -- result inspection (odc/omu.tcl) -------------------------------------

    def cmd_omu_write_plt(self, fname, tscale=1.0):
        """Write the solved trajectory as an OmSim-style .plt file
        (omu_write_plt, odc/omu.tcl:68-100)."""
        ts, X, U = plt_io.solver_trajectory(self._need_solver())
        plt_io.write_plt(fname, ts, X, U, tscale=tscale)
        return fname

    def cmd_omu_read_plt(self, fname, tstart=None, tend=None, dtmin=0.0):
        """Read a .plt file back; stores (names, data) on the shell and
        returns the point count (omu_read_plt, odc/omu.tcl:23-58)."""
        ts = None if tstart in (None, "all") else float(tstart)
        te = None if tend in (None, "all") else float(tend)
        self.plt_names, self.plt_data = plt_io.read_plt(
            fname, tstart=ts, tend=te, dtmin=float(dtmin))
        return self.plt_data.shape[0]

    def cmd_omu_plot(self, sidx, tscale=1.0):
        """The polyline omu_plot would draw for variable ``sidx``
        (controls as piecewise-constant staircases, odc/omu.tcl:107-192);
        returns 'npoints' and stores (xdata, ydata) on the shell."""
        ts, X, U = plt_io.solver_trajectory(self._need_solver())
        self.plot_xdata, self.plot_ydata = plt_io.plot_series(
            ts, X, U, int(sidx), tscale=tscale)
        return len(self.plot_xdata)

    # -- knobs ---------------------------------------------------------------

    def _knob(self, cmd, args):
        # prg_* attributes map onto the program (or constructor kwargs
        # before prg_name), like the reference's If_Int/If_Real bindings
        if cmd in self.SQP_KNOBS:
            return self._attr(self._need_solver(), self.SQP_KNOBS[cmd],
                              args)
        if cmd in self.QP_KNOBS:
            return self._attr(self._need_solver().qp_solver,
                              self.QP_KNOBS[cmd], args)
        if cmd in self.MDL_KNOBS:
            # model-formulation knobs are constructor arguments: store
            # and re-create the program (Prg_DynamicOpt re-reads its
            # mdl_* values in setup, omu/Prg_DynamicOpt.C:232+)
            attr = self.MDL_KNOBS[cmd]
            if args:
                self._prg_kwargs[attr] = args[0]
                if self.prg is not None:
                    self._create_prg()
                    self.solver = None
                return args[0]
            if self.prg is not None and hasattr(self.prg, attr):
                return self._attr(self.prg, attr, args)
            return self._prg_kwargs.get(attr, "")
        if cmd.startswith("prg_int_"):
            # integrator knobs (omu/Omu_Integrator.C: prg_int_rtol,
            # prg_int_atol, prg_int_stepsize, evaluation counters ...)
            it = getattr(self.prg, "integrator", None)
            if it is None:
                raise KeyError("current program has no integrator slot")
            attr = cmd[8:]
            if not hasattr(it, attr):
                raise KeyError(f"integrator has no knob {attr!r}")
            return self._attr(it, attr, args)
        if cmd.startswith("prg_"):
            attr = cmd[4:]
            if self.prg is not None and hasattr(self.prg, attr):
                return self._attr(self.prg, attr, args)
            if args:
                # constructor knob (e.g. prg_kmax): store and re-create
                # the program so derived quantities update
                self._prg_kwargs[attr] = args[0]
                if self.prg is not None:
                    self._create_prg()
                    self.solver = None
                return args[0]
            return self._prg_kwargs.get(attr, "")
        raise KeyError(f"unknown command {cmd!r}")

    @staticmethod
    def _attr(obj, path, args):
        ro = path.endswith("!")
        path = path.rstrip("!")
        if args and not ro:
            # an in-place write: the solvers and programs read their knobs
            # at each use, and the port's caches are keyed by value (the
            # KKT assembly maps by shape), so no cache outlives the write
            setattr(obj, path, args[0])
            return args[0]
        val = getattr(obj, path)
        if isinstance(val, torch.Tensor):
            val = host(val)
        return val
