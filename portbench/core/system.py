"""The program under test, as a configuration runs it.

Everything is built from the configuration's names through the port's
registry (``hqp_tpu_torch.utils.registry.modules``): the program
(``prg_name``), the KKT backend (``qp_mat_solver``) and the IP solver
(``sqp_qp_solver``), each with the keyword arguments the configuration
lists.  One unit of work is a batch of ``batch`` QPs, one a draw,
through the port's ``make_scenario_solve``.

``control=True`` builds the check's control instead: the plain
reference's QP build in float32 in place of the program's, the program's
own float32 factorization (``factor_dtype="f32"``) and the reference's
row violation in float32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Unit:
    """One unit of work and what the program returned for it."""

    v: torch.Tensor             # the draws: [B, K1, nv]
    state: object               # the IP state the program returned
    viol: torch.Tensor          # the program's original-row violations


def _kwargs(cfg, key):
    return {k: cfg[k] for k in cfg.get(key, [])}


class System:
    """The configured program, its solver and its unit of work."""

    def __init__(self, cfg, device, control=False, ref=None):
        import hqp_tpu_torch.all_modules  # noqa: F401  (fills the registry)
        from hqp_tpu_torch.parallel import scenarios
        from hqp_tpu_torch.qp import mehrotra, presolve
        from hqp_tpu_torch.utils.registry import modules

        self.cfg = cfg
        self.batch = int(cfg["batch"])
        self.tau = float(cfg["presolve_tau"])
        self.OPTIMAL = mehrotra.OPTIMAL
        self._presolve = presolve
        self._scenarios = scenarios
        self.prg = modules.create("prg_name", cfg["program"],
                                  device=device, **_kwargs(cfg,
                                                           "program_args"))
        self.prg.setup()
        kkt = _kwargs(cfg, "kkt_args")
        if control:
            kkt["factor_dtype"] = "f32"
        self.backend = modules.create("qp_mat_solver", cfg["kkt_backend"],
                                      **kkt)
        self.solver = modules.create("sqp_qp_solver", cfg["ip_solver"],
                                     self.backend, **_kwargs(cfg, "ip_args"))
        K1, nv = self.prg.K + 1, self.prg.nv
        Q = float(cfg["hessian_diag"]) * torch.eye(
            nv, dtype=torch.float64, device=self.prg.device)
        self.Q = Q.expand((self.batch, K1, nv, nv))
        self.control = control
        self.ref = ref
        self._solve_batch = scenarios.make_scenario_solve(
            self.prg, self.solver, presolve_tau=self.tau)

    # -- the layers' entries, for spans -------------------------------------

    def span_targets(self):
        """(owner, attribute, label) of each layer entry a run reaches."""
        prg_cls, be_cls, ip_cls = (type(self.prg), type(self.backend),
                                   type(self.solver))
        return [(prg_cls, "make_qp_batch", "qp_build"),
                (self._scenarios, "merge_parallel_rows", "qp_build"),
                (ip_cls, "solve_device", "ip"),
                (be_cls, "factor", "kkt.factor"),
                (be_cls, "solve", "kkt.solve"),
                (self._scenarios, "original_row_violation", "violation")]

    # -- one unit of work ----------------------------------------------------

    def _stage_qp(self, fields):
        from hqp_tpu_torch.qp.program import StageQP
        return StageQP(**{k: (t.to(torch.float64)
                              if t.is_floating_point() else t)
                          for k, t in fields.items()})

    def run(self, v) -> Unit:
        if self.control:
            return self._run_control(v)
        st, viol = self._solve_batch(v, self.Q)
        return Unit(v=v, state=st, viol=viol)

    def _run_control(self, v):
        """The batch entry with the reference's float32 QP build and row
        violation in the program's place."""
        from portbench.reference import stageqp

        qp = self._stage_qp(self.ref.build_qp(
            self.cfg, v.to(torch.float32), self.Q.to(torch.float32)))
        qps = self._presolve.merge_parallel_rows(qp, self.tau)
        st = self.solver.solve_device(qps, self.solver.init_state(qps))
        f32 = {k: getattr(qp, k).to(torch.float32)
               if getattr(qp, k).is_floating_point() else getattr(qp, k)
               for k in ("C", "d_lo", "d_up", "con_mask")}
        viol = stageqp.row_violation(f32, st.x.to(torch.float32))
        return Unit(v=v, state=st, viol=viol.to(torch.float64))

    @staticmethod
    def kernel_launches():
        """The program's own launch counters: K1 (every route) and K2."""
        from hqp_tpu_torch.ops import gj_cuda, thomas_cuda
        return dict(k1=gj_cuda.LAUNCHES + gj_cuda.LAUNCHES_LARGE
                    + gj_cuda.LAUNCHES_INV, k2=thomas_cuda.LAUNCHES)

    # -- what the check reads ------------------------------------------------

    def outputs(self):
        """A function from a unit to the program's answer as plain
        tensors, holding nothing of this object (so that the program can
        be freed before the check)."""
        code = self.OPTIMAL

        def answer(unit: Unit):
            st = unit.state
            groups = ("bl", "bu", "gl", "gu")
            return dict(
                x=st.x, y={"dyn": st.y["dyn"], "fix": st.y["fix"]},
                z={g: getattr(st.z, g) for g in groups},
                w={g: getattr(st.w, g) for g in groups},
                optimal=st.result == code, iters=st.iter)
        return answer
