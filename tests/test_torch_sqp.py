"""The port's solve path against the JAX package, layer by layer.

Each layer of the solve path (PartitionedKKT -> Mehrotra -> Docp /
PrgDID / the Omuses programs -> BFGS -> SqpPowell) gets the same seeded
inputs in both packages (handed over as numpy through
``hqp_tpu_torch.convert``) and is compared at a stated tolerance.  The
port's entry points default to the card, so every test here asks for the
CPU (``device="cpu"``, through the helpers below), where the kernel
wrappers take their plain twins.
"""

import functools
import json
import os
import pickle
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import hqp_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from hqp_tpu.models import omu_suite as JS
from hqp_tpu.models.crane import PrgCrane as JPrgCrane
from hqp_tpu.models.did import PrgDID as JPrgDID
from hqp_tpu.qp.kkt_partitioned import PartitionedKKT as JPartitionedKKT
from hqp_tpu.qp.program import IneqGroups as JIneqGroups
from hqp_tpu.sqp.hessian import BFGS as JBFGS
from hqp_tpu.sqp.powell import SqpPowell as JSqpPowell
from tests.test_kkt import random_rhs, random_stage_qp, random_zw

from hqp_tpu_torch import convert
from hqp_tpu_torch.models import omu_suite as S
from hqp_tpu_torch.models.crane import PrgCrane
from hqp_tpu_torch.models.did import PrgDID
from hqp_tpu_torch.qp.kkt_partitioned import PartitionedKKT
from hqp_tpu_torch.qp.mehrotra import Mehrotra, RESULT_STRINGS
from hqp_tpu_torch.sqp.hessian import BFGS
from hqp_tpu_torch.sqp.powell import SqpPowell
from hqp_tpu_torch.utils.registry import modules

_G = ("bl", "bu", "gl", "gu")
CPU = "cpu"



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tests run on one intra-op thread: their tensors are
    small, and the suite's workers share the host's cores, where torch's
    default of a thread per core oversubscribes them (the tests of this
    file ran several times slower that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: runs in a fresh interpreter on the CPU: takes the chunks of names of
#: argv[2]/queue.json in turn, each one no other interpreter has claimed
#: (an argv[2]/chunk<i>.claim file made exclusively), and for each name
#: pickles ``reference_result(name)`` of the test module argv[1] (numpy
#: arrays and plain values in dicts, lists and tuples) as argv[2]/<name>.pkl
#: (written under another name, then renamed), or its traceback as
#: <name>.err; the module's BACKGROUND_DIR is argv[2]
_BACKGROUND = r"""
import importlib, json, os, pickle, sys, traceback
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import torch
torch.set_num_threads(1)
mod = importlib.import_module(sys.argv[1])
where = mod.BACKGROUND_DIR = sys.argv[2]
with open(os.path.join(where, "queue.json")) as fh:
    chunks = json.load(fh)
for i, names in enumerate(chunks):
    try:
        os.close(os.open(os.path.join(where, f"chunk{i}.claim"),
                         os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        continue
    for name in names:
        out = os.path.join(where, name)
        try:
            result = mod.reference_result(name)
        except Exception:
            with open(out + ".err", "w") as fh:
                fh.write(traceback.format_exc())
            continue
        with open(out + ".part", "wb") as fh:
            pickle.dump(result, fh)
        os.replace(out + ".part", out + ".pkl")
"""


def lower_priority(core=None):
    """``preexec_fn`` of the interpreters a test file starts beside its
    tests: a lower scheduling priority, so that they take the cores the
    test workers leave idle and slow the tests down as little as they
    can; with ``core``, bound to that one core.  On a host whose cores the
    tests already fill, a JAX interpreter free to use them all spends
    much of its CPU in XLA threads that wait on one another: bound to one
    core, the reference of test_partitioned_kkt_knobs_match_reference took
    86 s of CPU where it took 152 s (one interpreter alone), with the same
    results to the last bit, and the last test group (tests/conftest.py)
    ran in 482 s of wall and 2714 s of CPU where it took 489 s and 3254 s
    (an 8-core CPU host)."""
    os.nice(10)
    if core is not None:
        os.sched_setaffinity(0, {core})


class Background:
    """The JAX package's side of a test module's slowest comparisons, in
    interpreters of their own started with the module's first test, so
    that they run on the host's idle cores beside the other tests (the
    tests then compare the port with what they computed, as they would
    with the same computation made inline).  ``chunks``: the names in the
    order the module's tests read them, in chunks that share JAX traces;
    each interpreter takes the next chunk no other has taken, so the work
    spreads over them as it comes.  Only the names some selected test of
    the module asks for (``wants``: test name -> names) are made.  One
    interpreter for each of ``places``, bound to one core
    (:func:`lower_priority`): the ``places[i]``-th of the host's cores
    from the top."""

    def __init__(self, request, chunks, wants, tmp, places):
        chosen = set()
        for it in request.session.items:
            if it.module is request.module:
                chosen.update(wants.get(getattr(it, "originalname", ""),
                                        ()))
        chunks = [c for c in ([n for n in c if n in chosen] for c in chunks)
                  if c]
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        self.dir = str(tmp)
        self.procs = []
        if not chunks:
            return
        with open(os.path.join(self.dir, "queue.json"), "w") as fh:
            json.dump(chunks, fh)
        cores = sorted(os.sched_getaffinity(0), reverse=True)
        module = "tests." + os.path.splitext(
            os.path.basename(request.module.__file__))[0]
        for i, place in enumerate(places[:len(chunks)]):
            with open(os.path.join(self.dir, f"stderr{i}.txt"), "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", _BACKGROUND, module, self.dir],
                    cwd=root, env=dict(os.environ, PYTHONPATH=root),
                    stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                    stderr=err, preexec_fn=functools.partial(
                        lower_priority, cores[place % len(cores)])))

    def result(self, name, timeout=900):
        """The saved result of ``name``: waits for it, and fails with the
        reference's traceback if it raised, or with the interpreters'
        errors if they all ended without it."""
        path = os.path.join(self.dir, name)
        t0 = time.monotonic()
        while not os.path.exists(path + ".pkl"):
            if os.path.exists(path + ".err"):
                with open(path + ".err") as fh:
                    pytest.fail(f"reference {name}: {fh.read()}")
            if all(p.poll() is not None for p in self.procs) and \
                    not os.path.exists(path + ".pkl"):
                errs = ""
                for i in range(len(self.procs)):
                    with open(os.path.join(self.dir,
                                           f"stderr{i}.txt")) as fh:
                        errs += fh.read()
                pytest.fail(f"reference {name} was not made: {errs}")
            if time.monotonic() - t0 > timeout:
                pytest.fail(f"reference {name} took over {timeout} s")
            time.sleep(0.2)
        with open(path + ".pkl", "rb") as fh:
            return pickle.load(fh)

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


#: the comparisons of this module whose JAX side runs in the background
#: (Background): the chunks in the order this file's tests read them, a
#: long chunk moved ahead of the shorter ones read before it ends (those
#: tests come last in the file, so that the interpreters have the other
#: tests' time to make them), the names each test reads, and the cores of
#: the interpreters
_NLP = [[f"nlp-{n}-{p}" for p in ("BFGS", "DScale", "Gerschgorin",
                                  "AugBFGS", "Gangster", "Franke",
                                  "Schittkowski")
         if (n, p) not in (("TP383", "DScale"), ("TP383", "Gerschgorin"))]
        for n in ("TP383", "Maratos", "HS99")]
_USER = ["user-" + n for n in ("DIC", "DIC_SFunction", "DIC_FMU",
                               "DID_SFunction-20", "dic_target", "DTOpt")]
_KNOBS = ["knob-cheap_predictor", "knob-gondzio_correctors=2",
          "knob-init_method=1", "knob-init_method=2", "knob-init_method=3",
          "knob-mod_terlaky"]
_LAYOUTS = ["user-" + n for n in ("soft_l1", "u_order1", "du_penalty",
                                  "decimation")]
_ROWS = ["user-" + n for n in ("min_time", "DID_SFunction", "DID")]
BACKGROUND_CHUNKS = (
    ["kkt_knobs"], ["kkt"], ["did60-gj=xla", "did60-reg_corr_rounds=1"],
    ["brake2"], ["Franke", "Schittkowski"], ["did60_qp"] + _KNOBS[:2],
    _KNOBS[2:4], _KNOBS[4:], *_NLP, ["did30"], ["cranepar"],
    ["scen_presolved", "scen_raw"], ["scen_steps"], _USER[:3], _USER[3:],
    ["dic-SDIRK", "dic-Dopri5"], _LAYOUTS[:2], _LAYOUTS[2:], _ROWS)
BACKGROUND_PLACES = (0, 1, 2, 3, 4)
BACKGROUND_WANTS = {
    "test_mehrotra_knob_matches_reference": ["did60_qp"] + _KNOBS,
    "test_did60_alt_solvers_match_reference": ["Franke", "Schittkowski"],
    "test_nlp_suite_matches_reference": sum(_NLP, []),
    "test_scenario_batch_presolved_matches_reference": ["scen_presolved"],
    "test_scenario_batch_raw_mixed_results": ["scen_raw"],
    "test_scenario_init_and_steps_match_reference": ["scen_steps"],
    "test_user_model_solves_match_reference": _USER,
    "test_sqp_dic_matches_reference": ["dic-SDIRK", "dic-Dopri5"],
    "test_partitioned_kkt_knobs_match_reference": ["kkt_knobs"],
    "test_refine_absolute_matches_reference": ["kkt_knobs"],
    "test_braking_arc_sps2_matches_reference": ["brake2"],
    "test_did60_backend_knobs_match_reference": [
        "did60-gj=xla", "did60-reg_corr_rounds=1"],
    "test_partitioned_kkt_matches_reference_f64": ["kkt"],
    "test_partitioned_kkt_matches_reference_f32": ["kkt"],
    "test_mehrotra_first_qp_matches_reference": ["did30"],
    "test_sqp_did30_matches_reference": ["did30"],
    "test_mehrotra_cranepar_first_qp_matches_reference": ["cranepar"],
    "test_sqp_cranepar_matches_reference": ["cranepar"],
    "test_user_model_layouts_match_recorded_reference": _LAYOUTS,
    "test_user_model_reference_rows": _ROWS}


@pytest.fixture(scope="module", autouse=True)
def background(request, tmp_path_factory):
    """This module's Background (BACKGROUND_CHUNKS, BACKGROUND_PLACES)."""
    bg = Background(request, BACKGROUND_CHUNKS, BACKGROUND_WANTS,
                    tmp_path_factory.mktemp("references"), BACKGROUND_PLACES)
    yield bg
    bg.close()


def reference_result(name):
    """The JAX package's side of a comparison of BACKGROUND_CHUNKS."""
    if name == "did60_qp":
        return _qp_arrays(did60_first_qp()[0])
    kind, _, arg = name.partition("-")
    if kind == "knob":
        return knob_reference(arg)
    if kind == "nlp":
        return nlp_reference(*arg.split("-"))
    if kind == "user":
        return user_reference(arg)
    if kind == "dic":
        return dic_reference(arg)
    if kind == "did60":
        return did60_knob_reference(arg)
    if name.startswith("scen_"):
        return scenario_reference(name)
    if name in ("Franke", "Schittkowski"):
        return alt_reference(name)
    return {"kkt": kkt_reference, "kkt_knobs": kkt_knob_reference,
            "brake2": brake_reference, "did30": did30_reference,
            "cranepar": cranepar_reference}[name]()

def _c(a):
    return convert.tensor(a, device=CPU)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(a, b, tol, rtol=None):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol,
                               rtol=tol if rtol is None else rtol)


def _kkt_inputs(K, nx, nu, mc, seed):
    qp = random_stage_qp(K, nx, nu, mc, seed=seed)
    z, w, mask = random_zw(qp, seed=1)
    r = random_rhs(qp, seed=2)
    port = (convert.stage_qp(qp, CPU), convert.ineq(z, CPU),
            convert.ineq(w, CPU), convert.ineq(mask, CPU), _c(r[0]),
            convert.eq(r[1], CPU), convert.ineq(r[2], CPU),
            convert.ineq(r[3], CPU))
    return (qp, z, w, mask, *r), port


def _jax_kkt(backend, qp, z, w, mask, *r):
    """The reference backend's factor + solve, jitted (one compile per
    shape instead of one dispatch per op)."""
    def f(qp, z, w, mask, *r):
        return backend.solve(backend.factor(qp, z, w, mask), qp, z, w, mask,
                             *r)
    return jax.jit(f)(qp, z, w, mask, *r)


def _compare_kkt(jax_sol, port_sol, tol):
    (dxj, dyj, dzj, dwj), (dxt, dyt, dzt, dwt) = jax_sol, port_sol
    _close(dxt, dxj, tol)
    for k in ("dyn", "fix"):
        _close(dyt[k], dyj[k], tol)
    for g in _G:
        _close(getattr(dzt, g), getattr(dzj, g), tol)
        _close(getattr(dwt, g), getattr(dwj, g), tol)


@pytest.mark.parametrize("kmax,cns", [(12, True), (8, False)])
def test_docp_did_matches_reference(kmax, cns):
    jp = JPrgDID(kmax=kmax, with_cns=cns)
    tp = PrgDID(kmax=kmax, with_cns=cns, device=CPU)
    x0j, x0t = jp.setup(), tp.setup()
    _close(x0t, x0j, 0.0)
    rng = np.random.default_rng(kmax)
    v = np.asarray(x0j) + 0.1 * rng.standard_normal(x0j.shape)
    vj, vt = jnp.asarray(v), _c(v)
    for a, b in zip(tp.eval_vals(vt), jp.eval_vals(vj)):
        _close(a, b, 1e-12)
    for a, b in zip(tp.eval_derivs(vt), jp.eval_derivs(vj)):
        _close(a, b, 1e-12)
    _close(tp.simulate(vt), jp.simulate(vj), 1e-12)

    fj, qpj = jp.make_qp(vj)
    ft, qpt = tp.make_qp(vt)
    _close(ft, fj, 1e-12)
    for name in ("c", "A", "b", "lb", "ub", "C", "d_lo", "d_up",
                 "var_mask", "con_mask"):
        _close(getattr(qpt, name), getattr(qpj, name), 1e-12)

    y = {"dyn": rng.standard_normal((kmax, 2)),
         "fix": rng.standard_normal(v.shape)}
    mask = qpj.ineq_mask()
    z = {g: rng.random(getattr(mask, g).shape) for g in _G}
    gj = jp.eval_grd_L(vj, {k: jnp.asarray(a) for k, a in y.items()},
                       JIneqGroups(**{g: jnp.asarray(a)
                                      for g, a in z.items()}))
    gt = tp.eval_grd_L(vt, convert.eq(y, CPU), convert.ineq(z, CPU))
    _close(gt, gj, 1e-12)


# -- the Omuses programs -----------------------------------------------------------


def _omu_pair(name):
    """(reference program, port program, tolerance) at a small size; the
    CranePar pair fits the same measurement record."""
    if name == "Crane":
        return JPrgCrane(K=10), PrgCrane(K=10, device=CPU), 1e-12
    if name == "BatchReactor":
        return (JS.PrgBatchReactor(K=8), S.PrgBatchReactor(K=8, device=CPU),
                1e-12)
    if name == "Bio":                 # values go through IMP's Newton solve
        return JS.PrgBio(K=6), S.PrgBio(K=6, device=CPU), 1e-10
    if name == "TP383omu":
        return JS.PrgTP383omu(), S.PrgTP383omu(device=CPU), 1e-12
    if name == "HS99omu":
        return JS.PrgHS99omu(), S.PrgHS99omu(device=CPU), 1e-12
    jp = JS.PrgCranePar(K=5)
    jp.setup()
    tp = S.PrgCranePar(K=5, s_ref=convert.program_record(jp), device=CPU)
    return jp, tp, 1e-12


@pytest.mark.parametrize("name", ["Crane", "BatchReactor", "Bio",
                                  "TP383omu", "HS99omu", "CranePar"])
def test_omu_program_matches_reference(name):
    """setup, eval_vals, eval_derivs (vmap of jacfwd through the
    integrator), simulate and make_qp at a perturbed iterate."""
    jp, tp, tol = _omu_pair(name)
    x0j, x0t = jp.setup(), tp.setup()
    _close(x0t, x0j, 0.0)
    if hasattr(jp, "ts"):           # the time grid
        _close(tp.ts, jp.ts, tol)
    rng = np.random.default_rng(len(name))
    v = np.asarray(x0j) + 0.1 * rng.standard_normal(x0j.shape)
    vj, vt = jnp.asarray(v), _c(v)
    for a, b in zip(tp.eval_vals(vt), jp.eval_vals(vj)):
        _close(a, b, tol)
    for a, b in zip(tp.eval_derivs(vt), jp.eval_derivs(vj)):
        _close(a, b, tol)
    _close(tp.simulate(vt), jp.simulate(vj), tol)
    fj, qpj = jp.make_qp(vj)
    ft, qpt = tp.make_qp(vt)
    _close(ft, fj, tol)
    for field in ("c", "A", "b", "lb", "ub", "C", "d_lo", "d_up",
                  "var_mask", "con_mask"):
        _close(getattr(qpt, field), getattr(qpj, field), tol)
    if name == "CranePar":
        # the port's own record: its RK4 rollout of the true model plus the
        # same seeded noise
        own = S.PrgCranePar(K=5, device=CPU)
        own.setup()
        _close(own.s_ref, jp.s_ref, 1e-12)


def test_bfgs_update_matches_reference():
    """One damped block BFGS update with eigenvalue control; the blocks
    are built so that some are damped and some need the eigen shift."""
    rng = np.random.default_rng(7)
    B, nb = 9, 3
    X = rng.standard_normal((B, nb, nb))
    Q = X @ np.swapaxes(X, 1, 2) + 0.1 * np.eye(nb)
    s = rng.standard_normal((B, nb))
    u = rng.standard_normal((B, nb))
    u[:3] = -u[:3]                                   # negative curvature
    s[4] = 1e-5 * s[4]                               # tiny step: eigen shift
    for alpha in (1.0, 0.3):
        ref = JBFGS().update(jnp.asarray(Q), jnp.asarray(s), jnp.asarray(u),
                             alpha)
        out = BFGS().update(_c(Q), _c(s), _c(u), alpha)
        _close(out, ref, 1e-12)
    ref = JBFGS(gamma=-0.2).update(jnp.asarray(Q), jnp.asarray(s),
                                   jnp.asarray(u), 0.5)
    out = BFGS(gamma=-0.2).update(_c(Q), _c(s), _c(u), 0.5)
    _close(out, ref, 1e-12)


# -- Mehrotra's equality-only branch, DID-60 --------------------------------------


def test_mehrotra_eq_only_loop(monkeypatch):
    """A program structurally without inequality rows takes the
    equality-only branch in cold_start and step: one Newton step, then
    optimal (the reference's m == 0 case)."""
    qp = convert.stage_qp(random_stage_qp(6, 2, 1, 0, seed=5), CPU)
    m = Mehrotra(eps=1e-9, max_iters=50).with_backend(PartitionedKKT(L=3))
    step = m._step_eq_only(qp, m.init_state(qp))
    monkeypatch.setattr(Mehrotra, "_no_ineq", staticmethod(lambda qp: True))
    out = m.solve(qp, m.init_state(qp))
    assert RESULT_STRINGS[int(out.result)] == "optimal"
    assert int(out.iter) == 1
    _close(out.x, step.x, 0.0)


def test_sqp_did60_oracle():
    """PrgDID(kmax=60) with its path constraint: the SLSQP-validated
    objective of tests/test_sqp_did.py."""
    s = SqpPowell(PrgDID(kmax=60, device=CPU), max_iters=50)
    s.init()
    assert s.solve() == "optimal"
    assert s.norm_inf < s.eps
    x = s.x.numpy()
    np.testing.assert_allclose(x[0, :2], [1.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(x[-1, :2], [-1.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(float(s.f), 98.4, rtol=1e-6)


#: the programs and integrators of the Omuses slice, by registry name
OMU_PROGRAMS = ("Crane", "BatchReactor", "Bio", "TP383omu", "HS99omu",
                "CranePar")


#: the programs of the user-model slice that take no model, by registry name
USER_PROGRAMS = ("DID_SFunction", "DIC", "DIC_SFunction", "DIC_FMU")


#: the NLP programs of the general-NLP slice, by registry name
NLP_NAMES = ("TP383", "Maratos", "HS99", "LQBlend", "Broydn3d", "Bdqrtic",
             "Catena", "SRosenbr")


@pytest.mark.parametrize("case", ["explicit", "default", "omu", "nlp",
                                  "shell"])
def test_cuda_device_refused_without_card(monkeypatch, tmp_path, case):
    """Asking for the card where there is none raises; nothing carries on
    on the CPU.  With no ``device`` the entry points ask for the card, and
    they build on the CPU only when the caller names it.  The registry
    holds every program and integrator of the Omuses slice, the hosted
    suite's programs and every NLP program, and each program refuses the
    card it does not have (before it builds a hosted model), as do
    ``solve_generated`` and ``convert.dense_qp``.  A Shell puts its
    programs on the card unless it is given another device, and so
    refuses ``prg_name`` without one; qp_load does the same."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if case == "shell":
        from hqp_tpu_torch.shell import Shell
        from hqp_tpu_torch.utils.diagnostics import qp_load
        for name in ("DID", "Maratos", "Crane"):
            with pytest.raises(RuntimeError, match="CUDA"):
                Shell(rcfile=False)(f"prg_name {name}")
        sh = Shell(rcfile=False, device=CPU)
        sh.run("prg_name DID; prg_kmax 10; prg_setup")
        assert sh.solver.x.device.type == sh.solver.qp.Q.device.type == CPU
        path = str(tmp_path / "qp.npz")
        assert sh(f"prg_qp_dump {path}") == path
        with pytest.raises(RuntimeError):
            qp_load(path)
        assert qp_load(path, CPU).Q.device.type == CPU
        return
    if case == "nlp":
        assert set(NLP_NAMES) <= set(modules.names("prg_name"))
        for name in NLP_NAMES:
            with pytest.raises(RuntimeError):
                modules.create("prg_name", name)
            prg = modules.create("prg_name", name, device=CPU)
            assert prg.device.type == "cpu"
            assert prg.setup().device.type == "cpu"
        with pytest.raises(RuntimeError):
            TG.solve_generated("lqblend", n=20)
        jqp = JDenseQP.build(jnp.eye(2), jnp.zeros(2))
        with pytest.raises(RuntimeError):
            convert.dense_qp(jqp)
        assert convert.dense_qp(jqp, CPU).Q.device.type == "cpu"
        return
    if case == "explicit":
        with pytest.raises(RuntimeError):
            PrgDID(kmax=10, device="cuda")
        return
    if case == "omu":
        assert set(OMU_PROGRAMS + USER_PROGRAMS) <= \
            set(modules.names("prg_name"))
        assert {"Euler", "RK4", "IMP"} <= set(modules.names("prg_integrator"))
        for name in OMU_PROGRAMS + USER_PROGRAMS:
            with pytest.raises(RuntimeError):
                modules.create("prg_name", name, device="cuda")
            with pytest.raises(RuntimeError):
                modules.create("prg_name", name)
            prg = modules.create("prg_name", name, device=CPU)
            assert prg.device.type == "cpu"
        return
    with pytest.raises(RuntimeError):
        PrgDID(kmax=10)
    for fn, arg in ((convert.tensor, np.zeros(3)),
                    (convert.eq, {"dyn": np.zeros(3)}),
                    (convert.ineq, {g: np.zeros(2) for g in _G})):
        with pytest.raises(RuntimeError):
            fn(arg)
    prg = PrgDID(kmax=10, device=CPU)
    assert prg.device.type == "cpu" and prg.setup().device.type == "cpu"
    assert _c(np.zeros(3)).device.type == "cpu"


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    subprocess.run(
        [sys.executable, "-c",
         "import sys, hqp_tpu_torch, hqp_tpu_torch.sqp.powell, "
         "hqp_tpu_torch.models.did, hqp_tpu_torch.models.crane, "
         "hqp_tpu_torch.models.omu_suite, hqp_tpu_torch.omu.program, "
         "hqp_tpu_torch.convert, hqp_tpu_torch.models.nlp_suite, "
         "hqp_tpu_torch.models.nlp_gen, hqp_tpu_torch.qp.franke, "
         "hqp_tpu_torch.sqp.schittkowski, hqp_tpu_torch.prof_did1000, "
         "hqp_tpu_torch.parallel.scenarios, hqp_tpu_torch.qp.presolve, "
         "hqp_tpu_torch.native, hqp_tpu_torch.qp.kkt_sparse_host, "
         "hqp_tpu_torch.models.sif, hqp_tpu_torch.ops._build_host; "
         "import hqp_tpu_torch.omu.dt_opt, hqp_tpu_torch.omu.dynamic_est, "
         "hqp_tpu_torch.omu.dynamic_opt, hqp_tpu_torch.omu.hosted, "
         "hqp_tpu_torch.omu.plt_io, hqp_tpu_torch.hxi, "
         "hqp_tpu_torch.models.hxi_suite; "
         "import hqp_tpu_torch.shell, hqp_tpu_torch.all_modules, "
         "hqp_tpu_torch.mip, hqp_tpu_torch.qp.client, "
         "hqp_tpu_torch.utils.checkpoint, hqp_tpu_torch.utils.log; "
         "import hqp_tpu_torch.hxi.mx_parse, hqp_tpu_torch.hxi.simulink, "
         "hqp_tpu_torch.hxi.mex, hqp_tpu_torch.parallel.distributed, "
         "hqp_tpu_torch.parallel.sharded_kkt; "
         "from hqp_tpu_torch.utils.registry import modules; "
         "assert {'DynamicOpt', 'DynamicEst', 'SFunctionOpt', "
         "'SFunctionEst'} <= set(modules.names('prg_name')); "
         "assert modules.has('sqp_qp_solver', 'Client'); "
         "assert modules.has('prg_name', 'DID_MEX'); "
         "assert modules.has('qp_mat_solver', 'SpSCdist'); "
         "assert 'jax' not in sys.modules, 'jax imported'"],
        check=True, env=env, cwd=root, timeout=120)


# -- the general-NLP path and the exchangeable modules (solves) --------------------

from hqp_tpu.models import nlp_gen as JG  # noqa: E402
from hqp_tpu.models import nlp_suite as JN  # noqa: E402
from hqp_tpu.qp import kkt as jkkt  # noqa: E402
from hqp_tpu.qp.franke import Franke as JFranke  # noqa: E402
from hqp_tpu.qp.program import DenseQP as JDenseQP  # noqa: E402
from hqp_tpu.sqp import hessian as jhess  # noqa: E402
from hqp_tpu.sqp.schittkowski import SqpSchittkowski as JSqpSchitt  # noqa
from hqp_tpu.sqp.solver import SqpError as JSqpError  # noqa: E402

from hqp_tpu_torch.models import nlp_gen as TG  # noqa: E402
from hqp_tpu_torch.models import nlp_suite as TN  # noqa: E402
from hqp_tpu_torch.qp.franke import Franke  # noqa: E402
from hqp_tpu_torch.qp.kkt import DenseKKT  # noqa: E402
from hqp_tpu_torch.qp.program import DenseQP  # noqa: E402
from hqp_tpu_torch.sqp import hessian as thess  # noqa: E402
from hqp_tpu_torch.sqp.schittkowski import SqpSchittkowski  # noqa: E402
from hqp_tpu_torch.sqp.solver import SqpError  # noqa: E402


def _franke_qp(case):
    """tests/test_franke.py's three QPs, as (Q, c, A, b, C, d) arrays."""
    if case == "box":
        return (np.eye(2), np.array([-3.0, -1.0]), None, None,
                np.concatenate([np.eye(2), -np.eye(2)]),
                np.array([0.0, 0.0, 2.0, 2.0]))
    if case == "eq_ineq":
        return (np.eye(2), np.zeros(2), np.array([[1.0, 1.0]]),
                np.array([-1.0]), np.eye(2), np.zeros(2))
    rng = np.random.default_rng(0)
    n, mi = 6, 8
    M = rng.standard_normal((n, n))
    return (M @ M.T + n * np.eye(n), rng.standard_normal(n), None, None,
            rng.standard_normal((mi, n)), 1.0 + rng.random(mi))


@pytest.mark.parametrize("case", ["box", "eq_ineq", "random"])
def test_franke_matches_reference(case):
    """Franke over DenseKKT on tests/test_franke.py's QPs: the same
    result and iteration count, x and y at 1e-9 (the IP tolerance)."""
    arrs = _franke_qp(case)
    jqp = JDenseQP.build(*(None if a is None else jnp.asarray(a)
                           for a in arrs))
    tqp = DenseQP.build(*(None if a is None else _c(a) for a in arrs))
    jf = JFranke(backend=jkkt.DenseKKT())
    ref = jf.solve(jqp, jf.init_state(jqp))
    tf = Franke(backend=DenseKKT())
    out = tf.solve(tqp, tf.init_state(tqp))
    assert int(out.result) == int(ref.result) == 0
    assert int(out.iter) == int(ref.iter)
    _close(out.x, ref.x, 1e-9)
    _close(out.y, ref.y, 1e-9)


#: the pairings of the exchangeable modules: (SQP class, hela, QP solver)
PAIRINGS = {"BFGS": ("Powell", None, None),
            "DScale": ("Powell", "DScale", None),
            "Gerschgorin": ("Powell", "Gerschgorin", None),
            "AugBFGS": ("Powell", "AugBFGS", None),
            "Gangster": ("Powell", "Gangster", None),
            "Franke": ("Powell", None, "Franke"),
            "Schittkowski": ("Schittkowski", None, None)}


def _pairing(pair, port):
    """(SQP class, keyword arguments) of one pairing in either package."""
    sqp, hela, qp_solver = PAIRINGS[pair]
    if port:
        cls = SqpPowell if sqp == "Powell" else SqpSchittkowski
        kw = {"hela": getattr(thess, hela)()} if hela else {}
        if qp_solver:
            kw["qp_solver"] = Franke()
    else:
        cls = JSqpPowell if sqp == "Powell" else JSqpSchitt
        kw = {"hela": getattr(jhess, hela)()} if hela else {}
        if qp_solver:
            kw["qp_solver"] = JFranke()
    return cls, kw


def _run(cls, prg, simulate=False, **kw):
    """init (simulate) solve; the verdict is "optimal" or the SqpError
    reason."""
    s = cls(prg, **kw)
    s.init()
    if simulate:
        s.simulate()
    try:
        res = s.solve()
    except (SqpError, JSqpError) as e:
        res = e.reason
    return s, res


def _same_solve(js, jres, ts, tres):
    """The same verdict, SQP and IP iterations; f within 1e-9 relative
    (1e-15 absolute for an optimum at 0)."""
    assert tres == jres
    assert (ts.iter, ts.qp_iters_total) == (js.iter, js.qp_iters_total)
    _close(float(ts.f), float(js.f), 1e-15, rtol=1e-9)


def alt_reference(pair):
    """The reference's DID-60 (qp_eps = 1e-7, init/simulate/solve)
    through ``pair``: {res, f, iter, ip}."""
    jcls, jkw = _pairing(pair, port=False)
    js, jres = _run(jcls, JPrgDID(kmax=60), True, max_iters=50, qp_eps=1e-7,
                    **jkw)
    return dict(res=jres, f=float(js.f), iter=js.iter, ip=js.qp_iters_total)


NLP_SUITE = {"TP383": (JN.PrgTP383, TN.PrgTP383),
             "Maratos": (JN.PrgMaratos, TN.PrgMaratos),
             "HS99": (JN.PrgHS99, TN.PrgHS99)}


def nlp_reference(name, pair):
    """The reference's solve of NLP_SUITE[name] through ``pair``
    (max_iters = 120, init/solve): {res, f, iter, qp_iters_total}."""
    jcls, jkw = _pairing(pair, port=False)
    js, jres = _run(jcls, NLP_SUITE[name][0](), max_iters=120, **jkw)
    return dict(res=jres, f=float(js.f), iter=js.iter,
                qp_iters_total=js.qp_iters_total)


@pytest.mark.parametrize("pair,iters", [("DScale", 46),
                                        ("Gerschgorin", 120)])
def test_tp383_failures_match_reference(pair, iters):
    """TP383's two failing pairings, whose ends are chaotic in the
    reference itself (ROADMAP Q3 R11: two to four ulps on one starting
    component turn its DScale run's SqpError("infeasible") at 113 into
    another iteration or into "optimal", and move its Gerschgorin run's
    IP count between 369 and 489).  DScale: the same IP count in each of
    the first 46 SQP iterations and SqpError("iters") there in both
    packages.  Gerschgorin: SqpError("infeasible") at SQP iteration 49
    in both, and f within 1e-9 relative."""
    jcls, jkw = _pairing(pair, port=False)
    tcls, tkw = _pairing(pair, port=True)
    js, jres = _run(jcls, JN.PrgTP383(), max_iters=iters, **jkw)
    ts, tres = _run(tcls, TN.PrgTP383(device=CPU), max_iters=iters, **tkw)
    if pair == "DScale":
        assert jres == tres == "iters"
        assert (ts.iter, ts.qp_iters_total) == (js.iter, js.qp_iters_total)
    else:
        assert jres == tres == "infeasible"
        assert ts.iter == js.iter == 49
        _close(float(ts.f), float(js.f), 0.0, rtol=1e-9)


@pytest.mark.parametrize("start,credit", [(1, 3), (0, 2)])
def test_powell_watchdog_matches_reference(start, credit):
    """Powell's watchdog on Maratos (tests/test_globalization.py:24-52):
    relaxed steps and back-outs counted alike, the same verdict, SQP and
    IP iterations, f within 1e-9 relative."""
    kw = dict(max_iters=60, watchdog_start=start, watchdog_credit=credit)
    js, jres = _run(JSqpPowell, JN.PrgMaratos(), **kw)
    ts, tres = _run(SqpPowell, TN.PrgMaratos(device=CPU), **kw)
    _same_solve(js, jres, ts, tres)
    assert (ts.wd_relaxed_steps, ts.wd_backouts) == \
        (js.wd_relaxed_steps, js.wd_backouts)
    assert ts.wd_relaxed_steps >= 2 if credit == 3 else ts.wd_backouts >= 1


#: the JAX package's registry entries whose modules are not ported yet
PORT_PENDING = set()


def test_registry_holds_the_exchangeable_modules():
    """The names of the ported slices resolve to the port's classes: since
    the host-sparse slice ``qp_mat_solver RedSpBKP`` (the name the
    reference's SparseCallbackKKT takes once ``all_modules`` is imported,
    ROADMAP R4), ``RedSpBKP_host`` and ``SpBKP``, ``sqp_hela SparseBFGS``
    and ``prg_name SIF``/``CUTE``; since the user-model slice the
    formulations ``DynamicOpt``, ``DynamicEst``, ``DTOpt``, ``DTEst``, the
    aliases ``SFunctionOpt``/``SFunctionEst`` and the hosted suite
    ``DID_SFunction``, ``DIC``, ``DIC_SFunction``, ``DIC_FMU``; since the
    integrator slice every ``prg_integrator`` of the reference; since the
    shell slice ``mip_solver LPSolve``/``BranchBound`` and ``sqp_qp_solver
    Client``; since the last two slices ``prg_name DID_MEX`` and
    ``qp_mat_solver SpSCdist``.  After ``all_modules`` (and the modules both
    test files import) the port's registry equals the JAX package's
    (PORT_PENDING is empty); a DenseQP program gets DenseKKT from
    SqpSolver.init."""
    import hqp_tpu.all_modules  # noqa: F401
    import hqp_tpu.parallel.sharded_kkt  # noqa: F401  (SpSCdist)
    import hqp_tpu_torch.all_modules  # noqa: F401
    from hqp_tpu_torch.qp import kkt as tkkt
    want = {"sqp_solver": {"Powell", "Schittkowski"},
            "sqp_qp_solver": {"Mehrotra", "Franke", "Client"},
            "sqp_hela": {"BFGS", "DScale", "Gerschgorin", "AugBFGS",
                         "Gangster", "SparseBFGS"},
            "qp_mat_solver": {"SpSC", "LQDOCP", "DenseKKT", "Riccati",
                              "FullKKT", "RedSpBKP", "RedSpBKP_host",
                              "SpBKP", "SpSCdist"},
            "mip_solver": {"LPSolve", "BranchBound"}}
    for slot, names in want.items():
        assert set(modules.names(slot)) == names, slot
    assert set(jmodules._factories) - set(modules._factories) == \
        PORT_PENDING
    assert set(modules._factories) <= set(jmodules._factories)
    # the integrators: the reference's 15 names (DASPK an alias of BDF),
    # each the port's class of the reference's class name
    import hqp_tpu.omu.integrators  # noqa: F401
    names = set(jmodules.names("prg_integrator"))
    assert set(modules.names("prg_integrator")) == names
    assert len(names) == 15 and "DASPK" in names
    for name in names:
        assert type(modules.create("prg_integrator", name)).__name__ == \
            type(jmodules.create("prg_integrator", name)).__name__, name
    for slot, name, cls in (
            ("qp_mat_solver", "RedSpBKP", tsh.SparseCallbackKKT),
            ("qp_mat_solver", "RedSpBKP_host", tsh.SparseHostKKT),
            ("qp_mat_solver", "SpBKP", tsh.FullSparseBKPKKT),
            ("qp_mat_solver", "FullKKT", tkkt.FullStageKKT),
            ("sqp_qp_solver", "Franke", Franke),
            ("sqp_qp_solver", "Client", Client),
            ("mip_solver", "LPSolve", BranchBound),
            ("mip_solver", "BranchBound", BranchBound),
            ("sqp_hela", "SparseBFGS", thess.SparseBFGS)):
        assert modules.create(slot, name).__class__ is cls, (slot, name)
    from hqp_tpu_torch.parallel.sharded_kkt import ShardedPartitionedKKT
    assert modules._factories[("qp_mat_solver", "SpSCdist")] is \
        ShardedPartitionedKKT
    sif = os.path.join(SIF_DIR, "HS21.SIF")
    for name in ("SIF", "CUTE"):
        assert modules.create("prg_name", name, path=sif,
                              device=CPU).__class__ is tsif.PrgSIF
    s = modules.create("sqp_solver", "Schittkowski",
                       TN.PrgMaratos(device=CPU))
    s.init()
    assert isinstance(s.qp, DenseQP) and isinstance(s._kkt_backend, DenseKKT)
    from hqp_tpu_torch.models import hxi_suite as th
    from hqp_tpu_torch.omu import dt_opt, dynamic_est, dynamic_opt
    for name, cls in (("DID_SFunction", th.PrgDIDSFunction),
                      ("DIC", th.PrgDIC), ("DIC_SFunction", th.PrgDICSFunction),
                      ("DIC_FMU", th.PrgDICFMU), ("DID_MEX", th.PrgDIDMex)):
        assert modules.create("prg_name", name, device=CPU).__class__ is cls
    model = chip_smoke.user_program("dic_target", CPU).model
    est = dict(chip_smoke.USER_CASES["DTEst"][3])
    for name, cls, args, kw in (
            ("DynamicOpt", dynamic_opt.DynamicOpt, (model,), dict(K=4)),
            ("SFunctionOpt", dynamic_opt.DynamicOpt, (model,), dict(K=4)),
            ("DTOpt", dt_opt.DTOpt, (th.HostedModel(th.SFunction(
                th.demo_sfunction_path("sfun_did"), params=[[0.1]])),),
             dict(K=4)),
            ("DynamicEst", dynamic_est.DynamicEst, (model,),
             dict(ys_meas=np.zeros((5, 2)))),
            ("SFunctionEst", dynamic_est.DynamicEst, (model,),
             dict(ys_meas=np.zeros((5, 2)))),
            ("DTEst", dt_opt.DTEst,
             (chip_smoke.user_program("DTEst", CPU).model,), est)):
        prg = modules.create("prg_name", name, *args, **kw, device=CPU)
        assert prg.__class__ is cls, name


# -- the host-sparse slice: the SIF reader ----------------------------------------

from hqp_tpu.models import sif as jsif  # noqa: E402
from tests.test_sparse_bfgs import SeparablePairs as JSeparablePairs  # noqa

from hqp_tpu_torch.models import sif as tsif  # noqa: E402
from hqp_tpu_torch.qp import kkt_sparse_host as tsh  # noqa: E402

SIF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sif")
SIF_FILES = ("HS21", "HS27", "HS35", "HS6", "HS7", "HS76", "TAME")


@pytest.mark.parametrize("name", SIF_FILES)
def test_sif_parses_as_reference(name):
    """Each SIF file of tests/sif parses to the reference's SifData: every
    field equal (arrays to the bit, NaN ranges included; the compiled F
    and temporary expressions as code objects)."""
    path = os.path.join(SIF_DIR, name + ".SIF")
    jd, td = jsif.load_sif(path), tsif.load_sif(path)
    for f in jd.__dataclass_fields__:
        a, b = getattr(td, f), getattr(jd, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif f == "obj_lin":
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a == b, f


@pytest.mark.parametrize("name", ["HS21", "HS7"])
def test_prg_sif_matches_reference(name):
    """PrgSIF of HS21 (quadratic) and HS7 (nonlinear elements, LOG and
    **): the same x0, f0, c, gradient and constraint Jacobian at x0 as the
    reference's, within 1e-12 relative."""
    path = os.path.join(SIF_DIR, name + ".SIF")
    jp, tp = jsif.PrgSIF(path=path), tsif.PrgSIF(path=path, device=CPU)
    jx, tx = jp.setup(), tp.setup()
    _close(tx, jx, 0.0)
    _close(tp.f0(tx), jp.f0(jx), 1e-12)
    _close(tp.c(tx), jp.c(jx), 1e-12)
    for o, r in zip(tp._derivs(tx), jp._derivs(jx)):
        _close(o, r, 1e-12)


@pytest.fixture(scope="module")
def jax_sif():
    """The reference's solve_sif of HS21 and HS27 (one solve each for the
    module)."""
    return {name: jsif.solve_sif(os.path.join(SIF_DIR, name + ".SIF"))
            for name in ("HS21", "HS27")}


@pytest.mark.parametrize("name", ["HS21", "HS27"])
def test_solve_sif_matches_reference(jax_sif, name):
    """solve_sif (SqpPowell, Gerschgorin, Mehrotra(1e-10, 60),
    SparseHostKKT) on the CPU: the reference's verdict, SQP and IP
    counts, and objective within 1e-8 relative."""
    ref = jax_sif[name]
    out = tsif.solve_sif(os.path.join(SIF_DIR, name + ".SIF"), device=CPU)
    assert out["result"] == ref["result"] == "optimal"
    assert (out["sqp_iters"], out["qp_iters_total"]) == \
        (ref["sqp_iters"], ref["qp_iters_total"])
    _close(out["obj"], ref["obj"], 1e-12, rtol=1e-8)
    assert out["ok"] and ref["ok"]


# -- the scenario batch (BASELINE config 5) ----------------------------------------

from hqp_tpu.parallel import scenarios as jscen  # noqa: E402
from hqp_tpu.qp import presolve as jpre  # noqa: E402
from hqp_tpu.qp import mehrotra as jrs  # noqa: E402
from hqp_tpu.qp.mehrotra import Mehrotra as JMehrotra  # noqa: E402

from hqp_tpu_torch.parallel import scenarios as tscen  # noqa: E402

#: BASELINE config 5 (bench.py:326-377): DID-60 at Q = 1e-2 I, 256 draws
#: at scale 1e-3, the presolve's tau
SCEN_N, SCEN_SCALE, SCEN_TAU = 256, 1e-3, 0.02
#: draws of the JAX package's batch: 22 and 144 defeat every raw IP
#: variant (tests/test_presolve.py:73-88), 144 keeps the largest
#: original-row violation after the presolve
JAX_DRAWS = (0, 1, 22, 144)
#: the port's own draws in the CPU test: its fastest (19 IP iterations in
#: the reference) and its slowest (25; chip_smoke.REF_SCEN)
PORT_DRAWS = (22, 128)

_JAX = {}


def _jax_scen():
    """The JAX package's DID-60 with its jitted make_qp, presolve and
    violation, its 256 draws, and the solver of the reference rows: the
    unbatched Mehrotra(PartitionedKKT(L=20, master="cr", gj="xla"),
    eps=1e-9).  Built once per module, so every scenario test and
    reference_values() share one compile of each."""
    if not _JAX:
        prg = JPrgDID(kmax=60)
        v0 = prg.setup()
        Q = jnp.tile(jnp.eye(prg.nv) * 1e-2, (prg.K + 1, 1, 1))
        _JAX.update(
            make=jax.jit(lambda v: prg.make_qp(v, Q=Q)[1]),
            merge=jax.jit(jpre.merge_parallel_rows),
            viol=jax.jit(jpre.original_row_violation),
            slv=JMehrotra(backend=JPartitionedKKT(L=20, master="cr",
                                                  gj="xla"), eps=1e-9),
            draws=np.asarray(jscen.batched_qp(prg, v0, SCEN_N,
                                              scale=SCEN_SCALE)))
    return _JAX


def jax_scenario_solves(draws, tau):
    """The JAX package's unbatched solve of the DID-60 QP at each iterate
    of ``draws`` (numpy [n, K1, nv]), presolved at ``tau`` (None: raw):
    [(result code, IP iterations, x, original-row violation)]."""
    J = _jax_scen()
    out = []
    for v in np.asarray(draws):
        qp = J["make"](jnp.asarray(v))
        qps = qp if tau is None else J["merge"](qp, tau)
        st = J["slv"].solve(qps, J["slv"].init_state(qps))
        out.append((int(st.result), int(st.iter), np.asarray(st.x),
                    float(J["viol"](qp, st.x))))
    return out


def _port_draws():
    """The port's own 256 draws (seed 0) on the CPU."""
    prg = PrgDID(kmax=60, device=CPU)
    return tscen.batched_qp(prg, prg.setup(), SCEN_N, scale=SCEN_SCALE,
                            seed=0)


def _port_scenarios(vb, tau):
    """make_scenario_solve on the CPU over the DID-60 iterates vb with the
    config's solver, Mehrotra(PartitionedKKT(L=20), eps=1e-9)."""
    prg = PrgDID(kmax=60, device=CPU)
    prg.setup()
    Qb = (1e-2 * torch.eye(prg.nv, dtype=torch.float64)).expand(
        vb.shape[0], prg.K + 1, prg.nv, prg.nv)
    slv = Mehrotra(backend=PartitionedKKT(L=20), eps=1e-9)
    return tscen.make_scenario_solve(prg, slv, presolve_tau=tau)(vb, Qb)


def scenario_reference(name):
    """The JAX package's side of a scenario test: {vb, ref} of the
    presolved batch ("scen_presolved": the JAX package's draws JAX_DRAWS
    and the port's PORT_DRAWS) or of the raw one ("scen_raw"), ref being
    :func:`jax_scenario_solves`'; or ("scen_steps") the draws, Q blocks and
    states of make_scenario_init and three make_scenario_step calls of
    test_scenario_init_and_steps_match_reference."""
    if name == "scen_presolved":
        vb = np.concatenate([_jax_scen()["draws"][list(JAX_DRAWS)],
                             _port_draws().numpy()[list(PORT_DRAWS)]])
        return dict(vb=vb, ref=jax_scenario_solves(vb, SCEN_TAU))
    if name == "scen_raw":
        vb = _jax_scen()["draws"][[0, 22, 144]]
        return dict(vb=vb, ref=jax_scenario_solves(vb, None))
    jprg = JPrgDID(kmax=15, with_cns=False)
    vj = jscen.batched_qp(jprg, jprg.setup(), 4, scale=1e-4)
    Qj = jnp.tile(jnp.eye(jprg.nv)[None, None] * 1e-2,
                  (4, jprg.K + 1, 1, 1))
    js = JMehrotra(backend=JPartitionedKKT(L=5))
    jinit = jax.jit(jscen.make_scenario_init(jprg, js))
    jstep = jax.jit(jscen.make_scenario_step(jprg, js))
    states = [jinit(vj, Qj)]
    for _ in range(3):
        states.append(jstep(vj, Qj, states[-1]))
    return dict(v=np.asarray(vj), Q=np.asarray(Qj), states=[_host(dict(
        iter=st.iter, result=st.result, x=st.x, z=st.z, w=st.w, gap=st.gap,
        test=st.test, alpha=st.alpha)) for st in states])


def reference_values(scenarios_only=False):
    """The JAX package's results that chip_smoke.py holds the card to
    (REF_SCEN, REF_ALT, REF_CHAOTIC, REF_F_DID1000, then those of
    :func:`host_sparse_reference_values`), one JSON row each: first
    REF_SCEN, the unbatched
    solves of the port's own 256 draws of BASELINE config 5 (fed as
    numpy, presolved at tau = 0.02) as ["scenarios256", IP count of each
    draw, verdict tally, largest original-row violation]; then [program,
    pairing or n, verdict, f, SQP, IP, then the IP count by SQP
    iteration, qp_eps or norm_inf].  Run from the repository root on a
    CPU host: ``JAX_PLATFORMS=cpu python -c "import jax;
    jax.config.update('jax_platforms', 'cpu'); import tests.test_torch_sqp
    as t; t.reference_values()"`` (``t.reference_values(scenarios_only=
    True)`` for REF_SCEN alone, about 2 minutes)."""
    import json

    ref = jax_scenario_solves(_port_draws().numpy(), SCEN_TAU)
    tally = {}
    for res, *_ in ref:
        name = jrs.RESULT_STRINGS[res]
        tally[name] = tally.get(name, 0) + 1
    print(json.dumps(["scenarios256", [it for _, it, _, _ in ref], tally,
                      max(v for *_, v in ref)]), flush=True)
    if scenarios_only:
        return

    def row(s, res, extra):
        return [res, float(s.f), s.iter, s.qp_iters_total, extra]

    for name, (jp, _) in NLP_SUITE.items():
        for pair in PAIRINGS:
            cls, kw = _pairing(pair, port=False)
            s = cls(jp(), max_iters=120, **kw)
            ips = []
            qp_solve = s.qp_solve
            s.qp_solve = lambda: (qp_solve(), ips.append(s.qp_iters_last))
            s.init()
            try:
                res = s.solve()
            except JSqpError as e:
                res = e.reason
            print(json.dumps([name, pair, *row(s, res, ips)]), flush=True)
    for kmax, pair, eps in ((60, "Franke", 1e-7), (60, "Schittkowski", 1e-7),
                            (1000, "BFGS", 1e-7), (1000, "BFGS", 1e-9),
                            (1000, "Franke", 1e-7),
                            (1000, "Schittkowski", 1e-7)):
        cls, kw = _pairing(pair, port=False)
        s, res = _run(cls, JPrgDID(kmax=kmax), True, max_iters=50,
                      qp_eps=eps, **kw)
        print(json.dumps([f"DID-{kmax}", pair, *row(s, res, eps)]),
              flush=True)
    host_sparse_reference_values()


def host_sparse_reference_values():
    """The JAX package's results that chip_smoke.py phase 18 holds the card
    to, one JSON row each: ["SIF", file, verdict, obj, SQP, IP] of
    solve_sif on each file of tests/sif (REF_SIF); [program, backend or
    hela, verdict, f, SQP, IP] of TP383 through SqpPowell(max_iters=60,
    Mehrotra(eps=1e-9, max_iters=50)) with SparseHostKKT and with
    FullSparseBKPKKT, and of SeparablePairs with SparseBFGS (REF_HOST);
    then the generated families through solve_generated in sorted order,
    one process sharing its backend as the card's run does (REF_FAMILIES,
    REF_CATENA): [family, n, verdict, f, SQP, IP, norm_inf, f after each of
    the first six SQP iterations' QPs].  Run from the repository root on a
    CPU host (about 6 minutes): ``JAX_PLATFORMS=cpu python -c "import jax;
    jax.config.update('jax_platforms', 'cpu'); import tests.test_torch_sqp
    as t; t.host_sparse_reference_values()"``."""
    import json

    from hqp_tpu.models.nlp_gen import solve_generated
    from hqp_tpu.models.nlp_suite import PrgTP383
    from hqp_tpu.qp import kkt_sparse_host as jsh_
    from hqp_tpu.sqp import powell

    for name in SIF_FILES:
        out = jsif.solve_sif(os.path.join(SIF_DIR, name + ".SIF"))
        print(json.dumps(["SIF", name, out["result"], out["obj"],
                          out["sqp_iters"], out["qp_iters_total"]]),
              flush=True)
    for pair in ("RedSpBKP_host", "SpBKP", "SparseBFGS"):
        if pair == "SparseBFGS":
            prog, s = "SeparablePairs", JSqpPowell(
                JSeparablePairs(), max_iters=60, hela=jhess.SparseBFGS())
        else:
            be = (jsh_.SparseHostKKT if pair == "RedSpBKP_host"
                  else jsh_.FullSparseBKPKKT)()
            prog, s = "TP383", JSqpPowell(
                PrgTP383(), max_iters=60, kkt_backend=be,
                qp_solver=JMehrotra(eps=1e-9, max_iters=50, jit=False))
        s.init()
        try:
            res = s.solve()
        except JSqpError as e:
            res = e.reason
        print(json.dumps([prog, pair, res, float(s.f), s.iter,
                          s.qp_iters_total]), flush=True)
    made = []
    init = powell.SqpPowell.init

    def keep(self):           # the solver, to read it after an SqpError
        made.append(self)
        init(self)
        fs = self.f_trace = []
        qp_solve = self.qp_solve

        def traced():
            qp_solve()
            fs.append(float(self.f))

        self.qp_solve = traced

    powell.SqpPowell.init = keep
    try:
        for name in sorted(JG.FAMILIES):
            n = 2000 if name == "lqblend" else 1000
            try:
                res = solve_generated(name, n=n)["result"]
            except JSqpError as e:
                res = e.reason
            s = made[-1]
            print(json.dumps([name, n, res, float(s.f), s.iter,
                              s.qp_iters_total, s.norm_inf,
                              s.f_trace[:6]]), flush=True)
    finally:
        powell.SqpPowell.init = init


# -- the user-model slice: formulations and hosted models ------------------------

import chip_smoke  # noqa: E402
import hqp_tpu.models.hxi_suite  # noqa: E402,F401  (registers the programs)
import hqp_tpu_torch.models.hxi_suite  # noqa: E402,F401  (the same, port)
import hqp_tpu_torch.omu.dt_opt  # noqa: E402,F401
import hqp_tpu.omu.dt_opt  # noqa: E402,F401  (registers the formulations)
from hqp_tpu.hxi.sfunction import SFunction as JSFunction  # noqa: E402
from hqp_tpu.hxi.sfunction import demo_sfunction_path as jdemo_path  # noqa
from hqp_tpu.omu.hosted import HostedModel as JHostedModel  # noqa: E402
from hqp_tpu.omu.integrators import RK4 as JRK4  # noqa: E402
from hqp_tpu.omu.model import Model as JModel  # noqa: E402
from hqp_tpu.utils.registry import modules as jmodules  # noqa: E402
from tests.test_dynamic_opt2 import DIC as JDIC  # noqa: E402
from hqp_tpu.omu.dt_opt import DTOpt as JDTOpt  # noqa: E402
from hqp_tpu.omu.dynamic_opt import DynamicOpt as JDynamicOpt  # noqa: E402
from tests.test_formulations import Decay as JDecay  # noqa: E402

from hqp_tpu_torch.hxi.sfunction import SFunction  # noqa: E402
from hqp_tpu_torch.hxi.sfunction import demo_sfunction_path  # noqa: E402
from hqp_tpu_torch.omu.dt_opt import DTOpt  # noqa: E402
from hqp_tpu_torch.omu.dynamic_opt import DynamicOpt  # noqa: E402
from hqp_tpu_torch.omu.hosted import HostedModel  # noqa: E402
from hqp_tpu_torch.omu.model import Model  # noqa: E402



class JDecayDT(JModel):
    """The JAX twin of chip_smoke's DecayDT: x+ = (1 - 0.05 p) x."""
    nx, nu, ny, npar = 1, 0, 1, 1
    p0 = (0.5,)
    discrete = True

    def dt_update(self, t, x, u, p):
        return (1.0 - 0.05 * p[0]) * x


def jax_user_program(name):
    """The JAX package's program of chip_smoke.USER_CASES[name]."""
    _, prg_name, model, kw, _, _ = chip_smoke.USER_CASES[name]
    if model is None:
        return jmodules.create("prg_name", prg_name, **kw)
    if model[0] == "DIC":
        m = JDIC()
    elif model[0] == "Decay":
        m = JDecay()
        kw = dict(kw, integrator=JRK4(steps=4))
    elif model[0] == "DecayDT":
        m = JDecayDT()
    else:
        m = JHostedModel(JSFunction(jdemo_path(model[0]),
                                    params=[[model[1]]]))
    return jmodules.create("prg_name", prg_name, m, **kw)


def user_solve(name, port):
    """USER_CASES[name] through SqpPowell in either package (the port on
    the CPU): (solver, verdict)."""
    _, _, _, _, skw, sim = chip_smoke.USER_CASES[name]
    if port:
        return _run(SqpPowell, chip_smoke.user_program(name, CPU), sim, **skw)
    return _run(JSqpPowell, jax_user_program(name), sim, **skw)


def hosted_reference_values(names=None):
    """The JAX package's results that chip_smoke.py phase 19 holds the card
    to, one JSON row each: [case, verdict, f, SQP, IP] of each case of
    chip_smoke.USER_CASES (REF_HOSTED), then for the estimation cases
    [case, "confidence", the estimates v[0, :nx], the half-widths]
    (REF_CONFIDENCE).  Run from the repository root on a CPU host (the two
    K = 1000 cases take most of the time): ``JAX_PLATFORMS=cpu python -c
    "import jax; jax.config.update('jax_platforms', 'cpu'); import
    tests.test_torch_sqp as t; t.hosted_reference_values()"``."""
    import json
    for name in names or chip_smoke.USER_CASES:
        s, res = user_solve(name, port=False)
        print(json.dumps([name, res, float(s.f), s.iter, s.qp_iters_total]),
              flush=True)
        if hasattr(s.prg, "confidence"):
            _, half = s.prg.confidence(s.x)
            print(json.dumps([name, "confidence",
                              np.asarray(s.x)[0, :s.prg.nx].tolist(),
                              np.asarray(half).tolist()]), flush=True)


#: DTOpt over the hosted sfun_did (dt = 0.05) with a quadratic soft bound
#: on s, whose solve takes one of two courses by rounding (ROADMAP Q3 R16)
DTOPT_SOFT = dict(x0=[1.0, 0.0], yf_ref=[-1.0, 0.0], K=20, dt=0.05,
                  u_min=[-20.0], u_max=[20.0], u_weight2=[0.05],
                  yf_weight2=[100.0, 100.0], y_soft_max=[np.inf, 0.02])


def dtopt_soft_witness(ulps=4, seeds=(0, 1, 2, 3)):
    """Prints [package, seed, verdict, f, SQP, IP] of DTOPT_SOFT through
    SqpPowell(max_iters=60) in both packages on the CPU: seed 0 from the
    start setup() gives, every other seed from that start with each entry
    moved by ``ulps`` units in the last place, up or down by a draw of the
    seed (f and the QP are then made at the moved start).  ROADMAP Q3 R16's
    witness; run as hosted_reference_values() is (~4 min)."""
    import json
    for port in (False, True):
        for seed in seeds:
            if port:
                prg = DTOpt(HostedModel(SFunction(
                    demo_sfunction_path("sfun_did"), params=[[0.05]])),
                    device=CPU, **DTOPT_SOFT)
                s = SqpPowell(prg, max_iters=60)
            else:
                prg = JDTOpt(JHostedModel(JSFunction(
                    jdemo_path("sfun_did"), params=[[0.05]])), **DTOPT_SOFT)
                s = JSqpPowell(prg, max_iters=60)
            s.init()
            if seed:
                x = np.asarray(s.x, dtype=np.float64)
                sign = np.random.default_rng(seed).choice([-1.0, 1.0],
                                                          x.shape)
                x = x + ulps * np.spacing(x) * sign
                s.x = convert.tensor(x, CPU) if port else jnp.asarray(x)
                s.f, s.qp = s.prg.make_qp(s.x)
            try:
                res = s.solve()
            except (SqpError, JSqpError) as e:
                res = e.reason
            print(json.dumps(["port" if port else "reference", seed, res,
                              float(s.f), s.iter, s.qp_iters_total]),
                  flush=True)


def check_user_solve(name, row=None, conf=None):
    """USER_CASES[name] through SqpPowell in both packages: the same
    verdict, SQP and IP counts, f within 1e-8 relative (1e-14 absolute for
    an optimum at 0); the reference's result is chip_smoke.REF_HOSTED's row; a hosted program's f is its
    native twin's within the reference's parity tolerance; an estimation's
    estimates and confidence half-widths agree within 1e-8 relative, the
    reference's being REF_CONFIDENCE's.  ``row``: the JAX package's
    (verdict, f, SQP, IP) of the case where it was solved beforehand, and
    ``conf`` its (estimates, half-widths) for an estimation
    (:func:`user_reference`)."""
    if row is None:
        ref = user_reference(name)
        row, conf = ref["row"], ref.get("conf")
    jres, jf, jit, jip = row
    ts, tres = user_solve(name, port=True)
    assert tres == jres
    assert (ts.iter, ts.qp_iters_total) == (jit, jip)
    _close(float(ts.f), jf, 1e-14, rtol=1e-8)
    ref = chip_smoke.REF_HOSTED[name]
    assert (jres, jit, jip) == (ref[0], ref[2], ref[3])
    _close(jf, ref[1], 0.0, rtol=1e-12)
    if name in chip_smoke.HOSTED_TWINS:
        twin, rtol = chip_smoke.HOSTED_TWINS[name]
        _close(float(ts.f), chip_smoke.REF_HOSTED[twin][1], 0.0, rtol=rtol)
    if name in chip_smoke.REF_CONFIDENCE:
        theta, half = chip_smoke.REF_CONFIDENCE[name]
        assert conf is not None, "an estimation needs its reference's"
        jtheta, jhalf = conf
        _, thalf = ts.prg.confidence(ts.x)
        nx = ts.prg.nx
        _close(ts.x[0, :nx], jtheta, 0.0, rtol=1e-8)
        _close(thalf, jhalf, 0.0, rtol=1e-8)
        _close(jtheta, theta, 0.0, rtol=1e-12)
        _close(jhalf, half, 0.0, rtol=1e-12)


#: the user-model solves that both packages run in this file: the
#: continuous double integrator in torch ops, through sfun_dic and through
#: the FMU, DynamicOpt on it, the hosted DID without its extra row and DTOpt
#: through sfun_did: one QP shape (K = 20, nx = 2, nu = 1), so that the
#: reference compiles its interior point once (the estimations are in
#: tests/test_torch_kernels.py)
USER_SOLVES = ("DIC", "DIC_SFunction", "DIC_FMU", "DID_SFunction-20",
               "dic_target", "DTOpt")


def user_reference(name):
    """The JAX package's side of :func:`check_user_solve` for
    USER_CASES[name]: {row: (verdict, f, SQP, IP)}, and for an estimation
    {conf: (estimates, confidence half-widths)}."""
    js, jres = user_solve(name, port=False)
    out = dict(row=(jres, float(js.f), js.iter, js.qp_iters_total))
    if name in chip_smoke.REF_CONFIDENCE:
        nx = js.prg.nx
        out["conf"] = (np.asarray(js.x)[0, :nx],
                       np.asarray(js.prg.confidence(js.x)[1]))
    return out


#: USER_CASES' small rows in the layouts of tests/test_dynamic_opt2.py.
#: Each QP shape of these costs the reference its own compile of the
#: interior point (15-40 s on a CPU host), so the reference solves them in
#: the background while this file's other tests run
PORT_ONLY = ("soft_l1", "u_order1", "du_penalty", "decimation")
#: USER_CASES' other small rows, which the port solves on the card alone
#: (chip_smoke.py phase 19): min_time (7 SQP / 62 IP, 30-40 s of the port
#: on a CPU host; its layout's QP is test_dynamic_opt_qp_matches_reference
#: [free_time]), the hosted DID-60 (its K = 20 twin is DID_SFunction-20
#: above) and the native DID-60; the reference solves them beside the
#: others, and its rows are held to REF_HOSTED's
REFERENCE_ONLY = ("min_time", "DID_SFunction", "DID")
class TDIC(Model):
    """Double integrator in torch ops (tests/test_dynamic_opt2.py's DIC)."""
    nx, nu, ny, npar = 2, 1, 2, 0

    def ode(self, t, x, u, p):
        return torch.stack([u[0], x[0]])


#: DynamicOpt layouts (and DTOpt's) for the QP comparison: program keywords
#: on the double integrator (DTOpt: on the hosted sfun_did)
QP_LAYOUTS = {
    "soft_penalty": dict(y_soft_max=[np.inf, 0.05], s_quad=1e4,
                         y_weight1=[0.3, 0.0], u_weight1=[0.2],
                         u_ref=[0.1]),
    "soft_slack": dict(y_soft_min=[-0.5, -np.inf], y_soft_max=[np.inf, 0.05],
                       s_lin=[1.0, 50.0], s_quad=[10.0, 50.0]),
    "u_order1": dict(u_order=1, du_weight2=[1e-4], du_min=[-5.0],
                     du_max=[5.0], u_min=[-3.0], u_max=[3.0]),
    "du_prev": dict(du_weight2=[0.1], u_min=[-3.0], u_init=[0.4]),
    "free_time": dict(x0=[0.0, 0.0], u_min=[-1.0], u_max=[1.0],
                      u_init=[0.5], yf_min=[0.0, 1.0], yf_max=[0.0, 1.0],
                      t_scale=True, t_weight1=1.0),
    "hard_inherit": dict(y_min=[-2.0, -np.inf], y_max=[2.0, 0.1],
                         yf_min=[np.nan, -0.5], yf_weight1=[0.1, 0.2]),
    "decimation": dict(decimation=3, y_max=[np.inf, 0.2],
                       y_soft_max=[1.5, np.inf], s_lin=[2.0, 0.0]),
    "periodic": dict(u_order=1, x_periodic=[True, False],
                     u_periodic=[True], du_weight2=[1e-3]),
    "dtopt": dict(y_min=[-3.0, -np.inf], y_max=[3.0, 0.1],
                  y_soft_max=[np.inf, 0.02], u_weight2=[0.05],
                  yf_weight1=[0.2, 0.0], u_min=[-4.0], u_max=[4.0]),
}


@pytest.mark.parametrize("layout", sorted(QP_LAYOUTS))
def test_dynamic_opt_qp_matches_reference(layout):
    """make_qp of DynamicOpt in each layout (u_order 0 and 1, the u_prev
    state, free final time, soft bounds by penalty and by slack controls,
    hard path and final bounds with NaN inheriting the path bound,
    decimation, periodic states and controls) and of DTOpt over the
    hosted sfun_did at a perturbed iterate: the start, f, Q, c, A, b, the
    bounds and masks within 1e-12."""
    kw = dict(x0=[1.0, 0.0], yf_ref=[-1.0, 0.0], yf_weight2=[100.0, 100.0],
              u_weight2=[0.01], K=6)
    kw.update(QP_LAYOUTS[layout])
    if layout == "dtopt":
        kw.update(dt=0.1)
        jp = JDTOpt(JHostedModel(JSFunction(jdemo_path("sfun_did"),
                                            params=[[0.1]])), **kw)
        tp = DTOpt(HostedModel(SFunction(
            demo_sfunction_path("sfun_did"), params=[[0.1]])),
            device=CPU, **kw)
    else:
        jp, tp = JDynamicOpt(JDIC(), **kw), DynamicOpt(TDIC(), device=CPU,
                                                        **kw)
    assert (tp.nx, tp.nu, tp.mc) == (jp.nx, jp.nu, jp.mc)
    x0j, x0t = jp.setup(), tp.setup()
    _close(x0t, x0j, 0.0)
    rng = np.random.default_rng(sorted(QP_LAYOUTS).index(layout))
    v = np.asarray(x0j) + 0.1 * rng.standard_normal(x0j.shape)
    fj, qj = jp.make_qp(jnp.asarray(v))
    ft, qt = tp.make_qp(convert.tensor(v, CPU))
    _close(ft, fj, 1e-12)
    for name in ("Q", "c", "A", "b", "lb", "ub", "C", "d_lo", "d_up",
                 "var_mask", "con_mask"):
        ref = np.asarray(getattr(qj, name))
        _close(getattr(qt, name), ref, 1e-12 * max(
            np.abs(np.where(np.isfinite(ref), ref, 0)).max(), 1.0), rtol=0)


# -- the rest of the integrators and Mehrotra's knobs ------------------------------

from hqp_tpu.models.hxi_suite import PrgDIC as JPrgDIC  # noqa: E402
from hqp_tpu.omu import integrators as jint  # noqa: E402
from hqp_tpu.qp.mehrotra import Mehrotra as JMehrotra  # noqa: E402

from hqp_tpu_torch.omu import integrators as tint  # noqa: E402
from hqp_tpu_torch.parallel.scenarios import batched_qp  # noqa: E402


def jax_integ_program(name):
    """The JAX package's program of chip_smoke.INTEG_CASES[name]."""
    prg, integ, kw, _ = chip_smoke.INTEG_CASES[name]
    it = jmodules.create("prg_integrator", integ, **kw)
    if prg == "Crane":
        return JPrgCrane(K=50, integrator=it)
    if prg == "Bio":
        return JS.PrgBio(integrator=it)
    return JPrgDIC(K=20, integrator=it)


def integrator_reference_values(names=None):
    """The JAX package's results that chip_smoke.py phase 20 (a)-(c) holds
    the card to (REF_INTEG), one JSON row each: [case, verdict, f, SQP,
    IP] of each case of chip_smoke.INTEG_CASES by SqpPowell(prg,
    max_iters=100), init(), [simulate()], solve().  Run from the
    repository root on a CPU host (about 2 minutes): ``JAX_PLATFORMS=cpu
    python -c "import jax; jax.config.update('jax_platforms', 'cpu');
    import tests.test_torch_sqp as t; t.integrator_reference_values()"``."""
    for name in names or chip_smoke.INTEG_CASES:
        s, res = _run(JSqpPowell, jax_integ_program(name),
                      chip_smoke.INTEG_CASES[name][3], max_iters=100)
        print(json.dumps([name, res, float(s.f), s.iter, s.qp_iters_total]),
              flush=True)


def mehrotra_reference_values(names=None):
    """The JAX package's results that chip_smoke.py phase 20 (d) holds the
    card to (REF_KNOBS), one JSON row each: [knob, verdict, f, SQP, IP] of
    SqpPowell(PrgDID(kmax=1000), max_iters=50, qp_solver=Mehrotra(eps=
    1e-7, max_iters=50, **knob)), init(), simulate(), solve() for each
    knob of chip_smoke.KNOB_CASES.  Run as
    :func:`integrator_reference_values` (about 4 minutes)."""
    for name in names or chip_smoke.KNOB_CASES:
        slv = JMehrotra(eps=chip_smoke.QP_EPS_DID1000, max_iters=50,
                        **chip_smoke.KNOB_CASES[name])
        s, res = _run(JSqpPowell, JPrgDID(kmax=1000), True, max_iters=50,
                      qp_solver=slv)
        print(json.dumps([name, res, float(s.f), s.iter, s.qp_iters_total]),
              flush=True)


_FIRST_QP = {}


def did60_first_qp():
    """The JAX package's first QP of SqpPowell(PrgDID(kmax=60)) and its
    IP state (the QP of test_mehrotra_first_qp_matches_reference's kind,
    with the path constraint), made once per interpreter."""
    if not _FIRST_QP:
        js = JSqpPowell(JPrgDID(kmax=60), max_iters=50)
        js.init()
        js.qp_update()
        _FIRST_QP.update(qp=js.qp, state=js.ip_state)
    return _FIRST_QP["qp"], _FIRST_QP["state"]


def knob_reference(knob):
    """The reference's Mehrotra with ``knob`` on DID-60's first QP:
    {result, iter, x}."""
    jqp, jst = did60_first_qp()
    ref = JMehrotra(eps=1e-9, max_iters=50,
                    **chip_smoke.KNOB_CASES[knob]).with_backend(
        JPartitionedKKT()).solve(jqp, jst)
    return dict(result=int(ref.result), iter=int(ref.iter),
                x=np.asarray(ref.x))


#: the knobs in the combinations the batch test runs (every knob in one,
#: the three together in the last)
KNOB_BATCHES = {
    "init1-terlaky": dict(init_method=1, mod_terlaky=True),
    "init2-gondzio": dict(init_method=2, gondzio_correctors=2),
    "init3-cheap": dict(init_method=3, cheap_predictor=True),
    "terlaky-gondzio-cheap": dict(mod_terlaky=True, gondzio_correctors=2,
                                  cheap_predictor=True),
}


@pytest.fixture(scope="module")
def knob_batch():
    """Four scenario QPs of PrgDID(kmax=20, with_cns=False) (batched_qp's
    draws of seed 0 at scale 1e-2 around the start, Q = 1e-2 I) as one
    batched StageQP and one by one."""
    prg = PrgDID(kmax=20, with_cns=False, device=CPU)
    v = batched_qp(prg, prg.setup(), 4, scale=1e-2, seed=0)
    Q = (1e-2 * torch.eye(prg.nv, dtype=torch.float64)).expand(
        4, prg.K + 1, prg.nv, prg.nv)
    _, qpb = prg.make_qp_batch(v, Q)
    return qpb, [prg.make_qp(v[b], Q[b])[1] for b in range(4)]


@pytest.mark.parametrize("combo", sorted(KNOB_BATCHES))
def test_mehrotra_knobs_batch_equals_unbatched(knob_batch, combo):
    """Mehrotra with the knobs on a batch of four scenario QPs: each
    problem optimal at the IP count of its own unbatched solve, x within
    1e-10 of it (the Terlaky redo and the Gondzio rounds are per-problem
    selects on the batch)."""
    qpb, qps = knob_batch
    m = Mehrotra(eps=1e-9, **KNOB_BATCHES[combo]).with_backend(
        PartitionedKKT())
    outb = m.solve(qpb, m.init_state(qpb))
    for b, qp in enumerate(qps):
        one = m.solve(qp, m.init_state(qp))
        assert int(outb.result[b]) == int(one.result) == 0
        assert int(outb.iter[b]) == int(one.iter)
        _close(outb.x[b], one.x, 1e-10)


def test_odets_taylor_terms_match_jet():
    """OdeTs's Taylor terms at order 8 on a nonlinear model (van der Pol)
    against the reference's recursion through jax.experimental.jet, which
    reads and returns its series as derivatives: within 1e-12."""
    from jax.experimental.jet import jet

    def fj(z):
        return jnp.array([z[1], 1.5 * (1.0 - z[0] * z[0]) * z[1] - z[0]])

    def ft(z):
        return torch.stack([z[1], 1.5 * (1.0 - z[0] * z[0]) * z[1] - z[0]])

    xs = np.array([0.7, -0.4])
    cs = [fj(jnp.asarray(xs))]
    for k in range(1, 8):
        _, series = jet(fj, (jnp.asarray(xs),),
                        ((*cs, jnp.zeros_like(cs[0])),))
        cs.append(series[k - 1] / (k + 1))
    out = tint._taylor_terms(ft, _c(xs), 8)
    assert len(out) == 8
    for o, r in zip(out, cs):
        _close(o, r, 1e-12 * np.abs(np.asarray(r)).max(), rtol=0)


#: test_sqp_dic_matches_reference's integrators and their keywords
DIC_INTEG = {"SDIRK": dict(steps=1, newton_iters=6), "Dopri5": {}}


def dic_reference(integ):
    """The reference's PrgDIC(K=8) by ``integ`` (DIC_INTEG) through
    SqpPowell(max_iters=100), init/solve: {res, f, iter, ip}."""
    js, jres = _run(JSqpPowell, JPrgDIC(K=8, integrator=getattr(
        jint, integ)(**DIC_INTEG[integ])), max_iters=100)
    return dict(res=jres, f=float(js.f), iter=js.iter, ip=js.qp_iters_total)


# -- the shell slice: the command shell and the actions it drives ----------------

from hqp_tpu.docp.nlp import Nlp as JNlp  # noqa: E402
from hqp_tpu.mip.branch_bound import BranchBound as JBranchBound  # noqa: E402
from hqp_tpu.shell import Shell as JShell  # noqa: E402

from hqp_tpu_torch.mip.branch_bound import BranchBound  # noqa: E402
from hqp_tpu_torch.qp.client import Client  # noqa: E402
from hqp_tpu_torch.shell import Shell  # noqa: E402

chip_smoke.register_int_demo()
if not jmodules.has("prg_name", "IntDemoT"):
    @jmodules.register("prg_name", "IntDemoT")
    class JIntDemoT(JNlp):
        """tests/test_mip.py's program, in the JAX package's registry."""
        name = "IntDemoT"
        n = 2
        m = 0
        x_int = [True, True]

        def setup_vars(self):
            return dict(x_min=[0.0, 0.0], x_max=[5.0, 5.0],
                        x_init=[1.0, 1.0])

        def f0(self, x):
            return ((x[0] - 2.3) ** 2 + (x[1] - 1.7) ** 2
                    + 0.2 * x[0] * x[1])


def _shell_row(sh, res):
    """(verdict, f, SQP, IP) of a shell's solver."""
    return (res, float(sh("prg_f")), sh.solver.iter,
            sh.solver.qp_iters_total)


def shell_reference_values():
    """The JAX package's results that chip_smoke.py phase 21 holds the card
    to, one JSON row each: [script, verdict, f, SQP, IP] of each script of
    chip_smoke.SHELL_SCRIPTS in a fresh Shell (REF_SHELL; the one of the
    Client is REF_CLIENT); ["hot", x0, verdict, f, SQP, IP] of each
    hqp_solve_hot step of DID-1000 after prg.set_pinned(x0) (REF_HOT, SQP
    and IP counted over the step); ["Crane resumed", ...] of the Crane
    stopped after CKPT_ITERS SQP iterations, saved, loaded into a fresh
    shell's solver and solved; ["IntDemoT", status, mip_f, mip_x] and
    ["MIQP", status, f, nodes, x] of BranchBound on chip_smoke.MIQP
    (REF_MIP).  Run from the repository root on a CPU host (about 10
    minutes): ``JAX_PLATFORMS=cpu python -c "import jax;
    jax.config.update('jax_platforms', 'cpu'); import tests.test_torch_sqp
    as t; t.shell_reference_values()"``."""
    import tempfile

    from hqp_tpu.utils.checkpoint import load_solver, save_solver

    for name, script in chip_smoke.SHELL_SCRIPTS.items():
        sh = JShell(rcfile=False)
        print(json.dumps([name, *_shell_row(sh, sh.run(script)[-1])]),
              flush=True)
        if name != "DID-1000":
            continue
        for x0 in chip_smoke.HOT_X0:
            sh.prg.set_pinned(jnp.asarray(x0), stage=0)
            it0, ip0 = sh.solver.iter, sh.solver.qp_iters_total
            res, f, it, ip = _shell_row(sh, sh("hqp_solve_hot"))
            print(json.dumps(["hot", x0, res, f, it - it0, ip - ip0]),
                  flush=True)
    sh = JShell(rcfile=False)
    sh.run("prg_name Crane; prg_setup; prg_simulate")
    for _ in range(chip_smoke.CKPT_ITERS):
        sh.run("sqp_qp_update; sqp_qp_solve; sqp_step")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "crane.npz")
        save_solver(path, sh.solver)
        sh = JShell(rcfile=False)
        sh.run("prg_name Crane; prg_setup")
        load_solver(path, sh.solver)
    print(json.dumps(["Crane resumed", *_shell_row(sh, sh("hqp_solve"))]),
          flush=True)
    sh = JShell(rcfile=False)
    sh.run("prg_name IntDemoT; prg_setup; hqp_solve")
    print(json.dumps(["IntDemoT", sh("mip_solve"), float(sh("mip_f")),
                      sh._mip_x.tolist()]), flush=True)
    Q, c, A, b, C, d, im = chip_smoke.miqp_arrays(**chip_smoke.MIQP)
    bb = JBranchBound()
    x, f, status = bb.solve(JDenseQP.build(
        jnp.asarray(Q), jnp.asarray(c), A=jnp.asarray(A), b=jnp.asarray(b),
        C=jnp.asarray(C), d=jnp.asarray(d)), im)
    print(json.dumps(["MIQP", status, float(f), bb.nodes,
                      np.asarray(x).tolist()]), flush=True)


def _knob_runs(sh):
    """tests/test_shell.py's Maratos by Schittkowski at sqp_eps 1e-6, then
    sqp_eps 1e-10 and a second hqp_solve: both rows, the qp_result and the
    evaluation counters."""
    sh.run("prg_name Maratos; sqp_solver Schittkowski; sqp_eps 1e-6; "
           "prg_setup")
    first = _shell_row(sh, sh("hqp_solve"))
    assert float(sh("sqp_eps")) == 1e-6
    second = _shell_row(sh, sh.run("sqp_eps 1e-10; hqp_solve")[-1])
    return [list(first), list(second), sh("qp_result"),
            int(sh("prg_fbd_evals")), int(sh("prg_grd_evals"))]


def test_shell_knobs_between_solves_match_reference():
    """tests/test_shell.py's Maratos by ``sqp_solver Schittkowski`` at
    ``sqp_eps 1e-6``, then ``sqp_eps 1e-10`` written between two
    ``hqp_solve``s: each run, the ``qp_result`` and the evaluation
    counters equal the JAX package's (verdict and SQP/IP counts exactly, f
    within 1e-10 relative), and the knob moved the second run on."""
    jf, js, *jrest = _knob_runs(JShell(rcfile=False))
    tf, ts, *trest = _knob_runs(Shell(rcfile=False, device=CPU))
    for j, t in ((jf, tf), (js, ts)):
        assert t[0] == j[0] == "optimal" and t[2:] == j[2:]
        _close(t[1], j[1], 0.0, rtol=1e-10)
    assert trest == jrest and trest[0] == "optimal"
    assert ts[2] > tf[2]          # the tighter sqp_eps took more steps
    _close(tf[1], -1.0, 1e-5)


def test_client_worker_matches_local_solve():
    """``sqp_qp_solver Client``: Maratos' QPs solved by the worker process
    give the local solve's verdict, SQP/IP counts and f to the last bit
    (Powell with BFGS, the JAX package's REF_ALT row), with the bytes each
    way counted; a job the worker fails (CUDA on a host without it, the
    worker's own device rule) raises RuntimeError with its message, and the
    worker serves the next job."""
    js, jres = _run(JSqpPowell, JN.PrgMaratos(), max_iters=50)
    local, lres = _run(SqpPowell, TN.PrgMaratos(device=CPU), max_iters=50)
    client = Client()
    try:
        remote, rres = _run(SqpPowell, TN.PrgMaratos(device=CPU),
                            qp_solver=client, max_iters=50)
        assert rres == lres == jres == "optimal"
        assert (remote.iter, remote.qp_iters_total) == \
            (local.iter, local.qp_iters_total) == (js.iter, js.qp_iters_total)
        assert float(remote.f) == float(local.f)
        _close(float(remote.f), float(js.f), 0.0, rtol=1e-10)
        assert client.solves == remote.iter
        assert client.moved["sent"] > client.moved["received"] > 0
        assert client.launches == {"K1": 0, "K2": 0}
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            client._call({"device": "cuda"})
        st = client.solve(remote.qp, client.init_state(remote.qp))
        assert int(st.result) == 0
    finally:
        client.close()


def _mip_case(name):
    """tests/test_mip.py's QPs and chip_smoke.MIQP as numpy (Q, c, A, b,
    C, d) and the integer mask."""
    eye = np.eye(2)
    if name == "rounding_trap":
        Q = np.array([[2.0, 1.2], [1.2, 2.0]])
        return (Q, -Q @ np.array([2.4, 1.6]), None, None,
                np.vstack([eye, -eye]), np.array([0.0, 0.0, 4.0, 4.0]),
                [True, True])
    if name == "equality":
        return (np.diag([2.0, 2.0]), np.array([-3.4, -0.4]),
                np.array([[1.0, 1.0]]), np.array([-2.3]),
                np.vstack([eye, -eye]), np.array([0.0, 0.0, 5.0, 5.0]),
                [True, False])
    if name == "infeasible":
        return (np.array([[2.0]]), np.array([0.0]), None, None,
                np.array([[1.0], [-1.0]]), np.array([-0.4, 0.6]), [True])
    if name == "no_integers":
        return (np.diag([2.0, 2.0]), np.array([-2.0, -4.0]), None, None,
                eye, np.zeros(2), [False, False])
    *arrs, im = chip_smoke.miqp_arrays(**chip_smoke.MIQP)
    return (*arrs, im)


#: tests/test_mip.py's cases and chip_smoke's MIQP (see _mip_case)
MIP_CASES = ("rounding_trap", "equality", "infeasible", "no_integers",
             "miqp")


def _jax_branch_bound(name):
    """The JAX package's BranchBound on _mip_case(name): [status, nodes,
    x or None, f]."""
    Q, c, A, b, C, d, im = _mip_case(name)
    bb = JBranchBound()
    x, f, status = bb.solve(JDenseQP.build(
        jnp.asarray(Q), jnp.asarray(c),
        *[None if a is None else jnp.asarray(a) for a in (A, b, C, d)]), im)
    return [status, bb.nodes, None if x is None else np.asarray(x).tolist(),
            float(f)]


def _mip_shell(sh):
    """tests/test_mip.py's shell flow on IntDemoT: [mip_f, mip_x]."""
    sh.run("prg_name IntDemoT; mip_solver BranchBound; prg_setup")
    assert sh("hqp_solve") == "optimal"
    assert sh("mip_solve") == "optimal"
    return [float(sh("mip_f")), sh._mip_x.tolist()]


@pytest.mark.parametrize("name", MIP_CASES)
def test_branch_bound_matches_reference(name):
    """BranchBound on tests/test_mip.py's cases and on chip_smoke's seeded
    MIQP in both packages: the same status, node count and integer
    values, x and f within 1e-8."""
    js, jnodes, jx, jf = _jax_branch_bound(name)
    Q, c, A, b, C, d, im = _mip_case(name)
    tb = BranchBound()
    tx, tf, ts = tb.solve(DenseQP.build(_c(Q), _c(c), *[
        None if a is None else _c(a) for a in (A, b, C, d)]), im)
    assert ts == js
    assert tb.nodes == jnodes
    if jx is None:
        assert tx is None and ts == "infeasible"
        return
    assert tx.device.type == CPU
    _close(tx, np.asarray(jx), 1e-8)
    _close(tf, jf, 1e-8)
    ints = np.flatnonzero(im)
    assert np.array_equal(_np(tx)[ints], np.asarray(jx)[ints])


def test_mip_via_shell_matches_reference():
    """tests/test_mip.py's shell flow on IntDemoT: the SQP solve, then
    ``mip_solve`` over the final relaxation, in both packages: mip_f 0.98
    and x = [2, 1], equal to the reference's."""
    jf, jx = _mip_shell(JShell(rcfile=False))
    tf, tx = _mip_shell(Shell(rcfile=False, device=CPU))
    _close(tf, 0.98, 1e-9)
    _close(tf, jf, 1e-12)
    assert [round(v) for v in tx] == [round(v) for v in jx] == [2, 1]
    _close(np.asarray(tx), np.asarray(jx), 1e-8)


#: programs the shell creates with their defaults (the hosted ones build
#: a compiled model and are left out)
SHELL_PROGRAMS = ("DID", "Crane", "BatchReactor", "Bio", "TP383omu",
                  "HS99omu", "CranePar", "TP383", "Maratos", "HS99", "DIC")


def test_shell_constructor_knobs_match_reference():
    """A ``prg_<name> value`` knob writes the program's attribute where
    the program has one and re-creates the program from constructor
    arguments where it does not (hqp_tpu/shell.py:455-468), so each
    program must keep the reference's attribute names: for every
    constructor argument of the programs above, the port's program has an
    attribute of that name exactly where the reference's has one; and
    ``prg_kmax 1000`` re-creates DID with K = 1000 in both shells."""
    import inspect
    for name in SHELL_PROGRAMS:
        jp = jmodules.create("prg_name", name)
        tp = modules.create("prg_name", name, device=CPU)
        args = set(inspect.signature(type(tp).__init__).parameters) - {
            "self", "device", "kw", "args"}
        assert {a for a in args if hasattr(tp, a)} == \
            {a for a in args if hasattr(jp, a)}, name
    for sh in (JShell(rcfile=False), Shell(rcfile=False, device=CPU)):
        sh.run("prg_name DID; prg_kmax 1000")
        assert sh("prg_K") == "1000" and sh.prg.K == 1000
        assert not hasattr(sh.prg, "kmax")


# -- the MEX and Simulink-coder hosts: the mx parser and DID_MEX ------------------

from hqp_tpu.hxi import mx_parse as jmx  # noqa: E402

from hqp_tpu_torch.hxi import mx_parse as tmx  # noqa: E402

#: tests/test_mex_sfun.py's test_mx_parse inputs, then empty, nested,
#: multi-line and non-finite ones, then text that the parsers refuse (a
#: ragged matrix, unterminated strings, cells and matrices, words, a
#: parenthesised list)
MX_TEXTS = (
    "[1 2; 3 4], 'it''s', {1, 2}, 2.5", "[]", "[1 2; 3]",
    "", "  ", "'a,b', [1,2;3,4]", "{[1, 2], 'x,y'}, -3e-2", "[1 2\n3 4]",
    "[ ; 1 ; ]", "'', {}", "1e3, [inf -Inf NaN]", "{1}}",
    "'abc", "{1, 2", "[1 2", "[1 x]", "1 2", "'a'b'", "x", "(1, 2), 3")


def _mx_value(v):
    """A parsed value as (kind, dtype, shape, bytes): comparable across the
    two packages' own MxCell classes, NaN included."""
    if isinstance(v, np.ndarray):
        return ("array", str(v.dtype), v.shape, v.tobytes())
    return (type(v).__name__, str(v))


@pytest.mark.parametrize("text", MX_TEXTS)
def test_mx_parse_matches_reference(text):
    """The port's mx parser gives the JAX package's result case for case:
    the same top-level split and the same values (numpy arrays bit for bit,
    strings, MxCell cells kept as text), or the same MxParseError
    message."""
    out = []
    for mod in (jmx, tmx):
        try:
            out.append((mod.split_args(text),
                        [_mx_value(v) for v in mod.parse_args(text)]))
        except mod.MxParseError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]
    if text == MX_TEXTS[0]:
        assert [k for k, *_ in out[1][1]] == ["array", "str", "MxCell",
                                              "array"]
    assert issubclass(tmx.MxParseError, ValueError)
    assert issubclass(tmx.MxCell, str)


def mex_reference_values():
    """The JAX package's results that chip_smoke.py phase 22 holds the card
    to, one JSON row each: [case, verdict, f, SQP, IP] of chip_smoke's
    MEX_CASES (REF_MEX), then of DID-1000 by qp_mat_solver SpSCdist on a
    one-device mesh with DID-1000's settings (REF_SHARD).  Run from the
    repository root on a CPU host (about 4 minutes): ``JAX_PLATFORMS=cpu
    python -c "import jax; jax.config.update('jax_platforms', 'cpu');
    import tests.test_torch_sqp as t; t.mex_reference_values()"``."""
    import hqp_tpu.all_modules  # noqa: F401  (DID_MEX)
    from hqp_tpu.parallel.scenarios import make_mesh
    from hqp_tpu.parallel.sharded_kkt import ShardedPartitionedKKT as JShard
    for name, (pkw, skw, sim) in chip_smoke.MEX_CASES.items():
        s, res = _run(JSqpPowell, jmodules.create("prg_name", "DID_MEX",
                                                  **pkw), sim, **skw)
        print(json.dumps([name, res, float(s.f), s.iter, s.qp_iters_total]),
              flush=True)
    be = JShard(make_mesh(1, axes=("sp",)), axis="sp")
    s, res = _run(JSqpPowell, JPrgDID(kmax=1000), True, kkt_backend=be,
                  max_iters=50, qp_eps=chip_smoke.QP_EPS_DID1000)
    print(json.dumps(["SpSCdist DID-1000", res, float(s.f), s.iter,
                      s.qp_iters_total]), flush=True)


def kkt_knob_reference_values():
    """The JAX package's results that chip_smoke.py phase 23 holds the card
    to, one JSON row each: [case, verdict, f, SQP, IP] of DID-1000 with
    DID-1000's settings through PartitionedKKT with each keyword set of
    chip_smoke.KKT_KNOB_CASES (REF_KKT_KNOBS), then through
    ShardedPartitionedKKT(full_shard=False) on a one-device mesh
    (REF_SHARD_REP).  Run as :func:`mex_reference_values` (about 3
    minutes)."""
    from hqp_tpu.parallel.scenarios import make_mesh
    from hqp_tpu.parallel.sharded_kkt import ShardedPartitionedKKT as JShard
    skw = dict(max_iters=50, qp_eps=chip_smoke.QP_EPS_DID1000)
    bes = {name: JPartitionedKKT(**kw)
           for name, kw in chip_smoke.KKT_KNOB_CASES.items()}
    bes["SpSCdist full_shard=False"] = JShard(
        make_mesh(1, axes=("sp",)), axis="sp", full_shard=False)
    for name, be in bes.items():
        s, res = _run(JSqpPowell, JPrgDID(kmax=1000), True, kkt_backend=be,
                      **skw)
        print(json.dumps([name, res, float(s.f), s.iter,
                          s.qp_iters_total]), flush=True)


def test_did_mex60_matches_recorded_reference():
    """DID_MEX at K = 60 (chip_smoke.MEX_CASES; the reference's
    tests/test_mex_sfun.py solve, marked slow in its suite, recorded in
    chip_smoke.REF_MEX by :func:`mex_reference_values`) through the port's
    SqpPowell on the CPU: the reference's verdict and SQP/IP counts, f
    within 1e-8 relative, and within 1e-6 of DID_SFunction's (the same
    model through the cg_sfun interface).  dt reaches the MEX model
    through the mx parser bit for bit: the text ``[dt]`` parses to dt in
    both packages, and the model's sample time is dt."""
    import hqp_tpu_torch.models.hxi_suite as th
    pkw, skw, sim = chip_smoke.MEX_CASES["DID_MEX"]
    prg = modules.create("prg_name", "DID_MEX", **pkw, device=CPU)
    assert type(prg) is th.PrgDIDMex
    text = f"[{prg.dt}]"
    assert tmx.parse_args(text)[0][0, 0] == jmx.parse_args(text)[0][0, 0] \
        == prg.dt == prg.hosted.ev.sample_time
    s, res = _run(SqpPowell, prg, sim, **skw)
    rres, rf, rit, rip = chip_smoke.REF_MEX["DID_MEX"]
    assert (res, s.iter, s.qp_iters_total) == (rres, rit, rip)
    _close(float(s.f), rf, 0.0, rtol=1e-8)
    _close(float(s.f), chip_smoke.REF_HOSTED["DID_SFunction"][1], 0.0,
           rtol=1e-6)


# -- PartitionedKKT's reference keywords, batched_safe, a solve with sps > 1 ----

from hqp_tpu.parallel.scenarios import batched_safe as jbatched_safe  # noqa
from tests.test_sample_periods import _DIC as JBrakeDIC  # noqa: E402

from hqp_tpu_torch.ops import gj_cuda  # noqa: E402
from hqp_tpu_torch.qp import kkt as tkkt  # noqa: E402

#: PartitionedKKT's keywords beyond L, master and factor_dtype, each held
#: against the reference's same keywords on a shape of
#: test_partitioned_kkt_matches_reference_f64 (each keyword set costs the
#: reference a compile of its own)
KKT_KNOBS = {
    "gj=xla": dict(gj="xla"),
    "absolute": dict(refine_relative=False, refine_rounds=2,
                     reg_corr_rounds=1),
    "refine_eps": dict(refine_eps=1e-12),
    "dual_reg": dict(dual_reg=1e-6),
    "no_reg_corr": dict(reg_corr_rounds=0),
    "no_refine": dict(refine_rounds=0),
}
KKT_KNOB_SHAPES = ((12, 2, 1, 1, 3),)
#: the whole DID-60 solve with the two keywords phase 23 of chip_smoke.py
#: runs on DID-1000
DID60_KNOBS = {"gj=xla": dict(gj="xla"),
               "reg_corr_rounds=1": dict(reg_corr_rounds=1)}
#: tests/test_sample_periods.py's braking arc (K = 4, sps = 2 through
#: decimation = 2)
BRAKE = dict(K=4, x0=[1.0, 0.0], u_min=[-60.0], u_max=[60.0],
             y_max=[np.inf, 0.15], yf_ref=[0.0, 0.0],
             yf_weight2=[0.0, 100.0], u_weight2=[1e-5], decimation=2)


def _leaves(sol):
    """(dx, dy dyn and fix, every dz and dw group) as numpy arrays."""
    dx, dy, dz, dw = sol
    return [_np(dx), _np(dy["dyn"]), _np(dy["fix"])] + [
        _np(getattr(t, g)) for t in (dz, dw) for g in _G]


def _norm_rel(out, ref):
    """The largest ||out - ref|| / ||ref|| over the leaves (||out|| where
    ref is zero)."""
    e = 0.0
    for a, b in zip(_leaves(out), ref):
        nb = np.linalg.norm(b)
        e = max(e, np.linalg.norm(a - b) / (nb if nb else 1.0))
    return e


def kkt_knob_reference():
    """The reference's PartitionedKKT factor + solve with each of
    KKT_KNOBS on KKT_KNOB_SHAPES (:func:`_kkt_inputs`' draws), and its
    kkt.refine(relative=False) from the uncorrected base solve of the
    first shape: the leaves of each direction, by "<shape>/<knob>/<i>"."""
    out = {}
    for K, nx, nu, mc, L in KKT_KNOB_SHAPES:
        (qp, z, w, mask, *r), _ = _kkt_inputs(K, nx, nu, mc, seed=K + L)
        for knob, kw in KKT_KNOBS.items():
            sol = _jax_kkt(JPartitionedKKT(L=L, **kw), qp, z, w, mask, *r)
            for i, a in enumerate(_leaves(sol)):
                out[f"{K}/{knob}/{i}"] = a
    K, nx, nu, mc, L = KKT_KNOB_SHAPES[0]
    (qp, z, w, mask, *r), _ = _kkt_inputs(K, nx, nu, mc, seed=K + L)
    be = JPartitionedKKT(L=L, refine_rounds=0, reg_corr_rounds=0)

    def refined(qp, z, w, mask, *r):
        fac = be.factor(qp, z, w, mask)

        def base(*a):
            return be.solve(fac, qp, z, w, mask, *a)

        return jkkt.refine(base, qp, z, w, mask, *r, base(*r), eps=1e-13,
                           max_rounds=3, relative=False)

    for i, a in enumerate(_leaves(jax.jit(refined)(qp, z, w, mask, *r))):
        out[f"refine/{i}"] = a
    return out


def _ref_leaves(ref, key):
    return [ref[f"{key}/{i}"] for i in range(11)]


@pytest.mark.parametrize("shape", KKT_KNOB_SHAPES, ids=lambda s: f"K{s[0]}")
@pytest.mark.parametrize("knob", sorted(KKT_KNOBS))
def test_partitioned_kkt_knobs_match_reference(background, monkeypatch,
                                               knob, shape):
    """PartitionedKKT with each of the reference's keywords (KKT_KNOBS)
    against the reference's PartitionedKKT with the same keywords (in the
    background): dx, dy, dz and dw within 1e-12 relative (norm of each),
    the port's KKT residual < 1e-10.  K1's twin runs once a factorization,
    and not at all with gj="xla" (the library inverse by the caller's
    word); the keywords are part of the backend's identity."""
    ref = background.result("kkt_knobs")
    K, nx, nu, mc, L = shape
    _, (tqp, tz, tw, tmask, *tr) = _kkt_inputs(K, nx, nu, mc, seed=K + L)
    kw = KKT_KNOBS[knob]
    calls = []
    k1 = gj_cuda.interior_factor
    monkeypatch.setattr(gj_cuda, "interior_factor",
                        lambda *a: calls.append(1) or k1(*a))
    tb = PartitionedKKT(L=L, **kw)
    assert tb == PartitionedKKT(L=L, **kw) != PartitionedKKT(L=L)
    assert hash(tb) == hash(PartitionedKKT(L=L, **kw))
    out = tb.solve(tb.factor(tqp, tz, tw, tmask), tqp, tz, tw, tmask, *tr)
    assert len(calls) == (0 if kw.get("gj") == "xla" else 1)
    assert _norm_rel(out, _ref_leaves(ref, f"{K}/{knob}")) <= 1e-12
    *_, res = tkkt.kkt_residual(tqp, tz, tw, tmask, *tr, *out)
    assert float(res) < 1e-10


def test_refine_absolute_matches_reference(background):
    """kkt.refine(relative=False) from the base solve without the
    regularization's corrections (eps 1e-13 absolute, 3 rounds) against
    the reference's on the same inputs: within 1e-12 relative, and closer
    to the KKT system than its start; with a large absolute eps it keeps
    the start, and ``unroll`` changes nothing."""
    ref = background.result("kkt_knobs")
    K, nx, nu, mc, L = KKT_KNOB_SHAPES[0]
    _, (tqp, tz, tw, tmask, *tr) = _kkt_inputs(K, nx, nu, mc, seed=K + L)
    be = PartitionedKKT(L=L, refine_rounds=0, reg_corr_rounds=0)
    fac = be.factor(tqp, tz, tw, tmask)

    def base(*a):
        return be.solve(fac, tqp, tz, tw, tmask, *a)

    sol0 = base(*tr)
    out = tkkt.refine(base, tqp, tz, tw, tmask, *tr, sol0, eps=1e-13,
                      max_rounds=3, relative=False)
    assert _norm_rel(out, _ref_leaves(ref, "refine")) <= 1e-12
    *_, res0 = tkkt.kkt_residual(tqp, tz, tw, tmask, *tr, *sol0)
    *_, res = tkkt.kkt_residual(tqp, tz, tw, tmask, *tr, *out)
    assert float(res) < float(res0)
    kept = tkkt.refine(base, tqp, tz, tw, tmask, *tr, sol0, eps=1e3,
                       max_rounds=3, unroll=True, relative=False)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(kept),
                                                    _leaves(sol0)))


def did60_knob_reference(knob):
    """The reference's DID-60 (SqpPowell, init/solve) through
    PartitionedKKT with DID60_KNOBS[knob]: {res, f, iter, ip, x}."""
    js, jres = _run(JSqpPowell, JPrgDID(kmax=60), max_iters=50,
                    kkt_backend=JPartitionedKKT(**DID60_KNOBS[knob]))
    return dict(res=jres, f=float(js.f), iter=js.iter, ip=js.qp_iters_total,
                x=np.asarray(js.x))


@pytest.mark.parametrize("knob", sorted(DID60_KNOBS))
def test_did60_backend_knobs_match_reference(background, knob):
    """DID-60 through PartitionedKKT with gj="xla" and with
    reg_corr_rounds=1 against the reference's (in the background): the
    same verdict, SQP and IP iterations; f within 1e-10 relative."""
    ref = background.result("did60-" + knob)
    ts, tres = _run(SqpPowell, PrgDID(kmax=60, device=CPU), max_iters=50,
                    kkt_backend=PartitionedKKT(**DID60_KNOBS[knob]))
    assert tres == str(ref["res"]) == "optimal"
    assert (ts.iter, ts.qp_iters_total) == (int(ref["iter"]),
                                            int(ref["ip"]))
    _close(float(ts.f), float(ref["f"]), 0.0, rtol=1e-10)


def test_batched_safe_rebinds_as_reference():
    """scenarios.batched_safe rebinds only what the reference's rebinds
    and only where the caller left it unset (master="cr", gj="xla"), on
    a copy of the backend; a solver whose backend has both set comes back
    as it is."""
    for kw in ({}, {"master": "thomas"}, {"gj": "pallas"},
               {"master": "thomas", "gj": "pallas"}):
        tbe, jbe = PartitionedKKT(L=5, **kw), JPartitionedKKT(L=5, **kw)
        ts = Mehrotra(backend=tbe)
        js = JMehrotra(backend=jbe)
        tout, jout = tscen.batched_safe(ts), jbatched_safe(js)
        assert (tout.backend.master, tout.backend.gj) == \
            (jout.backend.master, jout.backend.gj)
        assert (tout is ts) == (jout is js) == (len(kw) == 2)
        assert (tbe.master, tbe.gj) == (kw.get("master"), kw.get("gj"))
    assert tscen.batched_safe(types.SimpleNamespace(backend=None)).backend \
        is None


def brake_reference():
    """The reference's braking arc at decimation 2 (BRAKE, SqpPowell
    max_iters=80, init/solve): {res, f, iter, ip, x}."""
    js, jres = _run(JSqpPowell, JDynamicOpt(JBrakeDIC(), **BRAKE),
                    max_iters=80)
    return dict(res=jres, f=float(js.f), iter=js.iter, ip=js.qp_iters_total,
                x=np.asarray(js.x))


def test_braking_arc_sps2_matches_reference(background):
    """A whole solve with two sample periods a stage: the braking arc of
    tests/test_sample_periods.py at decimation = 2 (sps = 2; its per-period
    rows hold the bound between the knots) against the reference's (in
    the background): the same verdict, SQP and IP iterations, f within
    1e-12 relative and x within 1e-12."""
    ref = background.result("brake2")
    prg = DynamicOpt(TDIC(), device=CPU, **BRAKE)
    assert prg.sps == 2
    ts, tres = _run(SqpPowell, prg, max_iters=80)
    assert tres == str(ref["res"]) == "optimal"
    assert (ts.iter, ts.qp_iters_total) == (int(ref["iter"]),
                                            int(ref["ip"]))
    _close(float(ts.f), float(ref["f"]), 0.0, rtol=1e-12)
    _close(ts.x, ref["x"], 1e-12, rtol=0.0)


# -- PartitionedKKT, Mehrotra and the whole slice on DID-30 and CranePar ----------
# (their JAX side is made in the background: Background, reference_result)


def _host(tree):
    """A JAX result with every JAX array as a numpy array (for
    pickling)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def _qp_arrays(qp):
    """A QP's fields as numpy arrays (None fields left out)."""
    return {k: np.asarray(v) for k, v in vars(qp).items() if v is not None}


#: the f64 cases of test_partitioned_kkt_matches_reference_f64
KKT_CASES = [(8, 3, 2, 2, 4), (12, 2, 1, 1, 3), (6, 2, 2, 0, 6),
             (5, 3, 1, 1, 1), (10, 2, 1, 0, 4), (25, 5, 0, 0, 16),
             (20, 6, 1, 0, 16)]


def kkt_reference():
    """The reference's PartitionedKKT factor + solve (jitted) on each of
    KKT_CASES in f64 and on the f32 case of
    test_partitioned_kkt_matches_reference_f32: {case or "f32":
    direction}."""
    out = {}
    for K, nx, nu, mc, L in KKT_CASES:
        (qp, z, w, mask, *r), _ = _kkt_inputs(K, nx, nu, mc, seed=K + L)
        out[(K, nx, nu, mc, L)] = _host(_jax_kkt(JPartitionedKKT(L=L), qp, z,
                                                 w, mask, *r))
    (qp, z, w, mask, *r), _ = _kkt_inputs(10, 2, 1, 1, seed=3)
    out["f32"] = _host(_jax_kkt(JPartitionedKKT(L=5, factor_dtype="f32"),
                                qp, z, w, mask, *r))
    return out


@pytest.mark.parametrize("K,nx,nu,mc,L", KKT_CASES)
def test_partitioned_kkt_matches_reference_f64(background, K, nx, nu, mc,
                                               L):
    """f64 factors: the reference inverts the interiors with
    jnp.linalg.inv and reduces the master by CR, the port through the K1
    and K2 twins; both are refined to 1e-10, so they agree at 1e-8.  The
    last two cases are CranePar's layout (nu = 0: one partition of
    L = 25, s = 245, an empty terminal u-block) and the crane's (L = 10,
    s = 124, master blocks of n = 6).  The reference's side is
    :func:`kkt_reference`'s, made in the background."""
    _, (tqp, tz, tw, tmask, *tr) = _kkt_inputs(K, nx, nu, mc, seed=K + L)
    ref = background.result("kkt")[(K, nx, nu, mc, L)]
    tb = PartitionedKKT(L=L)
    out = tb.solve(tb.factor(tqp, tz, tw, tmask), tqp, tz, tw, tmask, *tr)
    _compare_kkt(ref, out, 1e-8)
    # master="cr" keeps the reference's f64 route
    cb = PartitionedKKT(L=L, master="cr")
    out_cr = cb.solve(cb.factor(tqp, tz, tw, tmask), tqp, tz, tw, tmask,
                      *tr)
    _compare_kkt(ref, out_cr, 1e-8)


def test_partitioned_kkt_matches_reference_f32(background):
    """f32 factors (K1/K2 at f32 + f64 refinement) against the
    reference's f32 path (Pallas kernels in interpret mode, in the
    background).  The port refines the master with the instance's 4 inner
    rounds where the reference takes the backend-global 1 round on a CPU
    host, so the two agree at the refinement tolerance, not bitwise."""
    _, (tqp, tz, tw, tmask, *tr) = _kkt_inputs(10, 2, 1, 1, seed=3)
    ref = background.result("kkt")["f32"]
    tb = PartitionedKKT(L=5, factor_dtype="f32")
    fac = tb.factor(tqp, tz, tw, tmask)
    assert fac.Minv.dtype == torch.float32
    assert fac.master[3].dtype == torch.float32
    out = tb.solve(fac, tqp, tz, tw, tmask, *tr)
    _compare_kkt(ref, out, 2e-5)


@pytest.mark.parametrize("pair", ["Franke", "Schittkowski"])
def test_did60_alt_solvers_match_reference(background, pair):
    """DID-60 (qp_eps = 1e-7, init/simulate/solve) through Powell with
    Franke and through Schittkowski, on PartitionedKKT in the port, against
    the reference's (:func:`alt_reference`, in the background): the same
    verdict, SQP and IP iterations; f within 1e-9 relative."""
    ref = background.result(pair)
    tcls, tkw = _pairing(pair, port=True)
    ts, tres = _run(tcls, PrgDID(kmax=60, device=CPU), True, max_iters=50,
                    qp_eps=1e-7, **tkw)
    assert str(ref["res"]) == "optimal"
    assert tres == str(ref["res"])
    assert (ts.iter, ts.qp_iters_total) == (int(ref["iter"]),
                                            int(ref["ip"]))
    _close(float(ts.f), float(ref["f"]), 1e-15, rtol=1e-9)


@pytest.mark.parametrize("name,pair", [
    (name, pair) for name in NLP_SUITE for pair in PAIRINGS
    if (name, pair) not in (("TP383", "DScale"), ("TP383", "Gerschgorin"))])
def test_nlp_suite_matches_reference(background, name, pair):
    """The exchangeable modules on the NLP suite (max_iters = 120,
    init/solve; DenseKKT), phase 15's matrix less TP383's two chaotic
    failures (the next test), against the reference's solves
    (:func:`nlp_reference`, in the background): the same verdict, SQP and
    IP iterations, f within 1e-9 relative."""
    ref = background.result(f"nlp-{name}-{pair}")
    tcls, tkw = _pairing(pair, port=True)
    ts, tres = _run(tcls, NLP_SUITE[name][1](device=CPU), max_iters=120,
                    **tkw)
    _same_solve(types.SimpleNamespace(**ref), ref["res"], ts, tres)


def _ip_result(st):
    """An IP state's result, iteration count and primal-dual iterate."""
    return _host(dict(result=int(st.result), iter=int(st.iter), x=st.x,
                      y=dict(st.y), z=st.z))


def did30_reference():
    """The reference's SqpPowell on PrgDID(kmax=30, with_cns=False): its
    first QP (qp_update at iteration 0 is deterministic and is repeated by
    solve()), the reference's Mehrotra solve of that QP from its cold
    state, and the whole solve's verdict, counts, f and x."""
    js = JSqpPowell(JPrgDID(kmax=30, with_cns=False), max_iters=50)
    js.init()
    js.qp_update()
    jqp0, jst0 = js.qp, js.ip_state
    out = dict(qp=_qp_arrays(jqp0), res=js.solve(), f=float(js.f),
               iter=js.iter, ip=js.qp_iters_total, x=np.asarray(js.x))
    out["first"] = _ip_result(js.qp_solver.solve(jqp0, jst0))
    return out


@pytest.fixture(scope="module")
def did30(background):
    """The port's SqpPowell on PrgDID(kmax=30, with_cns=False) and the
    reference's side (:func:`did30_reference`, in the background)."""
    ts = SqpPowell(PrgDID(kmax=30, with_cns=False, device=CPU),
                   max_iters=50)
    ts.init()
    tres = ts.solve()
    return dict(ref=background.result("did30"), ts=ts, tres=tres)


def test_mehrotra_first_qp_matches_reference(did30):
    """One cold Mehrotra solve of the same first QP: same result code and
    iteration count, x/y/z at 1e-7 (the IP tolerance is 1e-9 relative)."""
    ref = did30["ref"]["first"]
    qp = convert.stage_qp(types.SimpleNamespace(**did30["ref"]["qp"]), CPU)
    m = Mehrotra(eps=1e-9, max_iters=50).with_backend(PartitionedKKT())
    out = m.solve(qp, m.init_state(qp))
    assert int(out.result) == ref["result"] == 0
    assert int(out.iter) == ref["iter"]
    _close(out.x, ref["x"], 1e-7)
    for k in ("dyn", "fix"):
        _close(out.y[k], ref["y"][k], 1e-7)
    for g in _G:
        _close(getattr(out.z, g), getattr(ref["z"], g), 1e-7)


def test_sqp_did30_matches_reference(did30):
    ref, ts = did30["ref"], did30["ts"]
    assert ref["res"] == did30["tres"] == "optimal"
    assert ts.iter == ref["iter"]
    assert ts.qp_iters_total == ref["ip"]
    _close(float(ts.f), ref["f"], 0.0, rtol=1e-9)
    _close(ts.x, ref["x"], 1e-6)
    assert RESULT_STRINGS[ts.status] == "optimal"


def cranepar_reference():
    """The reference's SqpPowell on PrgCranePar() fitting its measurement
    record: the record, its first QP (nu = 0 and no finite bounds: every
    inequality row is masked off), its Mehrotra solve of that QP and the
    equality-only Newton step from the same cold state, and the whole
    solve's verdict, counts and f."""
    jp = JS.PrgCranePar()
    js = JSqpPowell(jp, max_iters=100)
    js.init()
    js.qp_update()
    jqp0, jst0 = js.qp, js.ip_state
    out = dict(record=convert.program_record(jp), qp=_qp_arrays(jqp0),
               res=js.solve(), f=float(js.f), iter=js.iter,
               ip=js.qp_iters_total)
    jm = js.qp_solver
    jeq = jm._step_eq_only(jqp0, jm.init_state(jqp0))
    out.update(first=_ip_result(jm.solve(jqp0, jst0)),
               eq=dict(_ip_result(jeq), test=np.asarray(jeq.test)))
    return out


@pytest.fixture(scope="module")
def cranepar(background):
    """The port's SqpPowell on PrgCranePar() fitting the reference's
    measurement record, and the reference's side
    (:func:`cranepar_reference`, in the background)."""
    ref = background.result("cranepar")
    ts = SqpPowell(S.PrgCranePar(s_ref=ref["record"], device=CPU),
                   max_iters=100)
    ts.init()
    tres = ts.solve()
    return dict(ref=ref, ts=ts, tres=tres)


def test_mehrotra_cranepar_first_qp_matches_reference(cranepar):
    """CranePar's first QP (interior s = 245): the reference's Mehrotra
    solve and the port's agree at 1e-10, and so does the equality-only
    Newton step (Hqp_IpsMehrotra.C:364-415) from the same cold state; the
    port's solve loop ends after that one step when the program has no
    inequality rows."""
    ref = cranepar["ref"]
    qp = convert.stage_qp(types.SimpleNamespace(**ref["qp"]), CPU)
    m = Mehrotra(eps=1e-9, max_iters=50).with_backend(PartitionedKKT())
    out = m.solve(qp, m.init_state(qp))
    assert int(out.result) == ref["first"]["result"] == 0
    assert int(out.iter) == ref["first"]["iter"]
    _close(out.x, ref["first"]["x"], 1e-10)
    for k in ("dyn", "fix"):
        _close(out.y[k], ref["first"]["y"][k], 1e-10)

    jeq = ref["eq"]
    teq = m._step_eq_only(qp, m.init_state(qp))
    assert int(teq.result) == jeq["result"] == 0
    assert int(teq.iter) == jeq["iter"] == 1
    _close(teq.x, jeq["x"], 1e-10)
    for k in ("dyn", "fix"):
        _close(teq.y[k], jeq["y"][k], 1e-10)
    _close(teq.test, jeq["test"], 1e-10)


def test_sqp_cranepar_matches_reference(cranepar):
    """PrgCranePar() (nu = 0; its one interior of s = 245 is what the
    large K1 kernel takes on the card): the same result, SQP and IP
    iterations; f within 1e-8 relative."""
    ref, ts = cranepar["ref"], cranepar["ts"]
    assert ref["res"] == cranepar["tres"] == "optimal"
    assert (ts.iter, ts.qp_iters_total) == (ref["iter"], ref["ip"])
    _close(float(ts.f), ref["f"], 0.0, rtol=1e-8)


def test_scenario_batch_presolved_matches_reference(background):
    """BASELINE config 5's path on a batch of six: the JAX package's draws
    0, 1, 22 and 144 and the port's own draws 0 and 1, presolved at tau =
    0.02 and solved by make_scenario_solve in one batch.  Each scenario
    ends at the JAX package's unbatched verdict and IP count (22, 22, 22
    and 21 on the JAX draws, 19 and 25 on the port's), with x within
    1e-10 and the original-row violation within 1e-12 (1.0693e-3 on draw
    144, VERDICT.md:241-251)."""
    got = background.result("scen_presolved")
    vb, ref = _c(got["vb"]), got["ref"]
    st, viol = _port_scenarios(vb, SCEN_TAU)
    assert [r[:2] for r in ref] == [(0, 22), (0, 22), (0, 22), (0, 21),
                                    (0, 19), (0, 25)]
    assert st.iter.shape == st.result.shape == viol.shape == (6,)
    for b, (res, it, x, v) in enumerate(ref):
        assert (int(st.result[b]), int(st.iter[b])) == (res, it)
        _close(st.x[b], x, 1e-10)
        _close(viol[b], v, 1e-12, rtol=0.0)
    assert abs(float(viol[3]) - 1.0693e-3) < 1e-7


def test_scenario_batch_raw_mixed_results(background):
    """Without the presolve, draws 0, 22 and 144 of the JAX package end
    "optimal" at 26 and "suboptimal" (code 3) at 20 and at 31 IP
    iterations in the reference (tests/test_presolve.py:73-88): in one
    batch each scenario stops at its own verdict and count, with x within
    1e-8 (the failed iterates blow up)."""
    got = background.result("scen_raw")
    vb, ref = _c(got["vb"]), got["ref"]
    st, viol = _port_scenarios(vb, None)
    assert [r[:2] for r in ref] == [(0, 26), (3, 20), (3, 31)]
    assert viol is None
    for b, (res, it, x, _) in enumerate(ref):
        assert (int(st.result[b]), int(st.iter[b])) == (res, it)
        _close(st.x[b], x, 1e-8)


def test_scenario_init_and_steps_match_reference(background):
    """make_scenario_init and three make_scenario_step calls on a batch of
    four perturbed PrgDID(kmax=15, with_cns=False) iterates (scale 1e-4;
    tests/test_parallel.py:20-52 without the mesh) against the JAX
    package's, vmapped and jitted (in the background,
    :func:`scenario_reference`), on the same draws: the state of every
    scenario after each call within 1e-9, and the same iteration counts
    and result codes."""
    ref = background.result("scen_steps")
    tprg = PrgDID(kmax=15, with_cns=False, device=CPU)
    tprg.setup()
    ts = Mehrotra(backend=PartitionedKKT(L=5))
    tinit = tscen.make_scenario_init(tprg, ts)
    tstep = tscen.make_scenario_step(tprg, ts)
    vt, Qt = _c(ref["v"]), _c(ref["Q"])
    tst = tinit(vt, Qt)
    for k, jst in enumerate(ref["states"]):
        if k:
            tst = tstep(vt, Qt, tst)
        assert tst.iter.tolist() == jst["iter"].tolist() == [k] * 4
        assert tst.result.tolist() == jst["result"].tolist()
        _close(tst.x, jst["x"], 1e-9)
        for g in _G:
            _close(getattr(tst.z, g), getattr(jst["z"], g), 1e-9)
            _close(getattr(tst.w, g), getattr(jst["w"], g), 1e-9)
        for name in ("gap", "test", "alpha"):
            _close(getattr(tst, name), jst[name], 1e-9)


@pytest.mark.parametrize("name", USER_SOLVES)
def test_user_model_solves_match_reference(background, name):
    """Each of these cases of chip_smoke.USER_CASES through SqpPowell in
    both packages (the reference's in the background,
    :func:`user_reference`): see :func:`check_user_solve`."""
    check_user_solve(name, **background.result("user-" + name))


@pytest.mark.parametrize("knob", sorted(chip_smoke.KNOB_CASES))
def test_mehrotra_knob_matches_reference(background, knob):
    """Each non-default knob of Mehrotra (those of chip_smoke phase 20
    (d)) on DID-60's first QP against the reference's Mehrotra with the
    same knob (:func:`knob_reference`, in the background): optimal at the
    same IP count, x within 1e-9."""
    ref = background.result("knob-" + knob)
    qp = convert.stage_qp(types.SimpleNamespace(
        **background.result("did60_qp")), CPU)
    m = Mehrotra(eps=1e-9, max_iters=50,
                 **chip_smoke.KNOB_CASES[knob]).with_backend(
        PartitionedKKT())
    out = m.solve(qp, m.init_state(qp))
    assert int(out.result) == int(ref["result"]) == 0
    assert int(out.iter) == int(ref["iter"])
    _close(out.x, ref["x"], 1e-9)


@pytest.mark.parametrize("integ", ["SDIRK", "Dopri5"])
def test_sqp_dic_matches_reference(background, integ):
    """The slice as a whole: PrgDIC(K=8) through SqpPowell -> Mehrotra ->
    PartitionedKKT with its stages integrated by SDIRK (steps 1, six
    Newton iterations, as tests/test_integrators2.py runs it) or by the
    adaptive Dopri5 (the reference's solve in the background,
    :func:`dic_reference`): the same result, SQP and IP iterations, f
    within 1e-8 relative."""
    from hqp_tpu_torch.models.hxi_suite import PrgDIC
    ref = background.result("dic-" + integ)
    ts, tres = _run(SqpPowell, PrgDIC(K=8, integrator=getattr(
        tint, integ)(**DIC_INTEG[integ]), device=CPU), max_iters=100)
    assert ref["res"] == tres == "optimal"
    assert (ts.iter, ts.qp_iters_total) == (ref["iter"], ref["ip"])
    _close(float(ts.f), ref["f"], 0.0, rtol=1e-8)


@pytest.mark.parametrize("name", PORT_ONLY)
def test_user_model_layouts_match_recorded_reference(background, name):
    """DynamicOpt in the layouts of tests/test_dynamic_opt2.py (L1 soft
    bounds by slack controls, u_order = 1, the du penalty, decimation 3) in
    both packages, the reference at chip_smoke.REF_HOSTED's row: see
    :func:`check_user_solve`."""
    check_user_solve(name, **background.result("user-" + name))


@pytest.mark.parametrize("name", REFERENCE_ONLY)
def test_user_model_reference_rows(background, name):
    """The reference's solve of each case of REFERENCE_ONLY gives
    chip_smoke.REF_HOSTED's row: the verdict and SQP/IP counts, f within
    1e-12 relative."""
    res, f, it, ip = background.result("user-" + name)["row"]
    ref = chip_smoke.REF_HOSTED[name]
    assert (res, it, ip) == (ref[0], ref[2], ref[3])
    _close(f, ref[1], 0.0, rtol=1e-12)
