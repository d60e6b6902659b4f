"""SIF reader: real SIF test problems as NLPs (the CUTE role).

Port of ``hqp_tpu/models/sif.py``, with its own copy of the parser (the
reference's reader is numpy-only; the port keeps its own so that it never
imports the JAX package).  The reference's CUTE bridge decodes SIF files
through the external SIF decoder and Fortran callbacks (hqp/Prg_CUTE.C:
117+614, Prg_CUTE_ST.C, hqp_cute/hqp_cute.tcl); here the same ingestion is
native:

* the linear/quadratic subset (ROWS/GROUPS, COLUMNS/VARIABLES,
  RHS/CONSTANTS, RANGES, BOUNDS, START POINT, QUADOBJ/QSECTION/QMATRIX,
  OBJSENSE -- Hock-Schittkowski / Maros-Meszaros style files), and
* the nonlinear subset: ELEMENT TYPE/USES and GROUP TYPE/USES in the data
  part, plus the ELEMENTS / GROUPS function-definition parts, whose
  Fortran F (value) expressions are compiled to Python and evaluated on
  torch tensors; derivatives come from ``torch.func`` through them (the
  decoder's G/H lines are ignored).

Out-of-scope constructs raise SifError: internal element variables (R/IV
range transforms), parametric Z*/X+ loops and group parameters.
Semantics of RHS/RANGES/BOUNDS follow the MPS conventions the decoder
implements (default variable bounds [0, inf), range rows, negative-UP
rule).

:class:`PrgSIF` (``prg_name SIF`` and ``CUTE``) wraps a parsed problem as
an :class:`~hqp_tpu_torch.docp.nlp.Nlp` on a device; :func:`solve_sif`
solves one through the host-sparse path.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from hqp_tpu_torch.docp.nlp import Nlp
from hqp_tpu_torch.utils.registry import modules


class SifError(ValueError):
    pass


@dataclasses.dataclass
class SifData:
    """Parsed linear/quadratic SIF problem (numpy, host-side)."""

    name: str
    var_names: list
    con_names: list            # constraint rows (objective excluded)
    con_types: list            # 'E' | 'L' | 'G' per row
    g: np.ndarray              # linear objective coefficients [n]
    Q: np.ndarray              # quadratic term, f = c0 + g'x + 1/2 x'Qx
    c0: float                  # objective constant
    A: np.ndarray              # constraint coefficients [m, n]
    rhs: np.ndarray            # per-row right-hand side [m]
    ranges: np.ndarray         # per-row range (nan = none) [m]
    x_lo: np.ndarray
    x_up: np.ndarray
    x0: np.ndarray
    x_int: np.ndarray          # integer-variable marker [n] bool
    solution: float | None     # *LO SOLTN comment if present
    maximize: bool = False

    # -- nonlinear structure (empty for linear/quadratic files) ----------
    #: element type -> {"ev": [names], "ep": [names]}
    etypes: dict = dataclasses.field(default_factory=dict)
    #: element name -> {"type": etype, "v": {ev: var}, "p": {ep: float}}
    euses: dict = dataclasses.field(default_factory=dict)
    #: group type -> its formal group-variable name
    gtypes: dict = dataclasses.field(default_factory=dict)
    #: row name -> [(element name, weight)]
    grp_elems: dict = dataclasses.field(default_factory=dict)
    #: row name -> group type (absent = TRIVIAL, identity)
    grp_type: dict = dataclasses.field(default_factory=dict)
    #: element type -> {"temps": [(name, expr)], "f": expr}
    elem_fns: dict = dataclasses.field(default_factory=dict)
    #: group type -> {"temps": [(name, expr)], "f": expr}
    group_fns: dict = dataclasses.field(default_factory=dict)
    #: all objective (N) rows in order; first is the primary
    obj_rows: list = dataclasses.field(default_factory=list)
    #: objective row -> linear coefficient vector [n]
    obj_lin: dict = dataclasses.field(default_factory=dict)
    #: objective row -> subtracted constant (MPS obj-constant rule)
    obj_rhs: dict = dataclasses.field(default_factory=dict)

    def has_nonlinear(self) -> bool:
        return bool(self.euses) or bool(self.grp_type)

    @property
    def n(self):
        return len(self.var_names)

    @property
    def m(self):
        return len(self.con_names)

    def bounds(self):
        """(c_min, c_max) from row types + RHS + RANGES (MPS ranges
        semantics: L row b-|r| <= c <= b; G row b <= c <= b+|r|;
        E row with r >= 0: b <= c <= b+r, with r < 0: b+r <= c <= b)."""
        inf = np.inf
        c_min = np.full(self.m, -inf)
        c_max = np.full(self.m, inf)
        for i, t in enumerate(self.con_types):
            b, r = self.rhs[i], self.ranges[i]
            if t == "E":
                c_min[i] = c_max[i] = b
                if np.isfinite(r):
                    if r >= 0:
                        c_max[i] = b + r
                    else:
                        c_min[i] = b + r
            elif t == "L":
                c_max[i] = b
                if np.isfinite(r):
                    c_min[i] = b - abs(r)
            elif t == "G":
                c_min[i] = b
                if np.isfinite(r):
                    c_max[i] = b + abs(r)
        return c_min, c_max


#: sections the reader understands (everything else is an error,
#: except harmless no-op sections)
_SECTIONS = {
    "NAME", "OBJSENSE", "ROWS", "GROUPS", "CONSTRAINTS", "COLUMNS",
    "VARIABLES", "RHS", "CONSTANTS", "RANGES", "BOUNDS", "START", "QUADOBJ",
    "QSECTION", "QMATRIX", "QUADS", "QUADRATIC", "HESSIAN",
    "OBJECT", "ENDATA",
    "ELEMENT TYPE", "ELEMENT USES", "GROUP TYPE", "GROUP USES",
}


def _split_parts(text: str):
    """Split a SIF file into (data, elements, groups) parts: the data
    part ends at its ENDATA; the optional function-definition parts start
    with top-level ``ELEMENTS``/``GROUPS`` indicator lines (SIF spec: the
    three inputs of the decoder, usually concatenated in one file)."""
    lines = text.splitlines()
    parts = {"data": [], "elements": [], "groups": []}
    cur = "data"
    seen_endata = False
    for raw in lines:
        if raw[:1] not in (" ", "\t", "") and not raw.lstrip().startswith("*"):
            head = raw.split()[0].upper() if raw.split() else ""
            if seen_endata and head == "ELEMENTS":
                cur = "elements"
                seen_endata = False
                continue
            if seen_endata and head == "GROUPS" and cur != "data":
                cur = "groups"
                seen_endata = False
                continue
            if seen_endata and head == "GROUPS" and cur == "data":
                # GROUPS after the data ENDATA = the group-function part
                cur = "groups"
                seen_endata = False
                continue
            if head == "ENDATA":
                parts[cur].append(raw)
                seen_endata = True
                continue
        parts[cur].append(raw)
    return ("\n".join(parts["data"]), "\n".join(parts["elements"]),
            "\n".join(parts["groups"]))


def _parse_fn_part(text: str, what: str) -> dict:
    """Parse an ELEMENTS/GROUPS function-definition part: GLOBALS ``A``
    assignments (shared temporaries) + INDIVIDUALS blocks of ``T type``,
    ``A name expr`` temporaries and the ``F expr`` value line.  G/H
    derivative lines are IGNORED (derivatives come from torch.func
    through the compiled F expression); R/I internal-variable transforms
    are out of the supported subset."""
    fns = {}
    globals_ = []
    section = None
    cur = None

    def close():
        if cur is not None:
            if cur["f"] is None:
                raise SifError(
                    f"{what} type '{cur['name']}' has no F (value) line")
            fns[cur["name"]] = {"temps": globals_ + cur["temps"],
                                "f": cur["f"]}

    for raw in text.splitlines():
        s = raw.strip()
        if not s or s.startswith("*"):
            continue
        if raw[0] not in " \t":
            head = s.split()[0].upper()
            if head in ("TEMPORARIES", "GLOBALS", "INDIVIDUALS",
                        "ELEMENTS", "GROUPS", "ENDATA"):
                section = head
                continue
            raise SifError(f"unknown {what} section '{s}'")
        key = s.split()[0].upper()
        if section == "TEMPORARIES":
            continue        # type declarations (R/M/F names): not needed
        if section in ("GLOBALS", "INDIVIDUALS"):
            if key in ("T", "XT"):
                close()
                cur = {"name": s.split()[1], "temps": [], "f": None}
            elif key in ("A", "XA"):
                rest = s[len(s.split()[0]):].strip()
                nm = rest.split()[0]
                expr = rest[len(nm):].strip()
                tgt = globals_ if section == "GLOBALS" else cur["temps"]
                tgt.append((nm, _compile_expr(expr)))
            elif key == "F":
                if cur is None:
                    raise SifError(f"F line outside a T block: '{s}'")
                cur["f"] = _compile_expr(s[1:].strip())
            elif key in ("G", "H"):
                continue    # analytic derivative lines: torch.func instead
            elif key in ("R", "I", "E"):
                raise SifError(
                    f"{what} internal-variable transform '{s}' is outside "
                    "the supported subset")
            else:
                raise SifError(f"unknown {what} line '{s}'")
    close()
    return fns


_DEXP = re.compile(r"(\d\.?\d*)[dD]([+-]?\d+)")


def _compile_expr(expr: str):
    """Compile a Fortran value expression to a Python code object
    (evaluated against the torch environment of :func:`_fn_env`; ``**``,
    parentheses and intrinsic names carry over directly)."""
    py = _DEXP.sub(r"\1E\2", expr)
    try:
        return compile(py, "<sif-expr>", "eval")
    except SyntaxError as e:
        raise SifError(f"cannot compile SIF expression '{expr}': {e}")


def _fn_env(device):
    """The Fortran intrinsics of the F expressions as torch functions that
    take Python floats and tensors alike (a float becomes a float64
    tensor on ``device``)."""
    def lift(fn):
        def call(*args):
            return fn(*(a if isinstance(a, torch.Tensor) else
                        torch.as_tensor(a, dtype=torch.float64,
                                        device=device) for a in args))
        return call

    return {name: lift(fn) for name, fn in {
        "LOG": torch.log, "LOG10": torch.log10, "EXP": torch.exp,
        "SIN": torch.sin, "COS": torch.cos, "TAN": torch.tan,
        "ASIN": torch.asin, "ACOS": torch.acos, "ATAN": torch.atan,
        "SINH": torch.sinh, "COSH": torch.cosh, "TANH": torch.tanh,
        "SQRT": torch.sqrt, "ABS": torch.abs, "SIGN": torch.sign,
        "MAX": torch.maximum, "MIN": torch.minimum,
    }.items()}

def parse_sif(text: str, name_hint: str = "SIF") -> SifData:
    """Parse a SIF problem (linear/quadratic + the nonlinear subset)."""
    text, elem_text, group_text = _split_parts(text)
    name = name_hint
    var_idx, var_names = {}, []
    con_idx, con_names, con_types = {}, [], []
    obj_row = None
    obj_rows, obj_set = [], set()
    obj_ent = []                         # (obj row, var, value)
    obj_rhs = {}
    g_ent, A_ent, Q_ent = [], [], []     # (idx..., value) triples
    rhs_ent, rng_ent = [], []
    bnd_ent = []                         # (type, var, value|None)
    sp_ent = []                          # (var, value)
    c0 = 0.0
    solution = None
    maximize = False
    int_mode = False
    x_int_names = set()
    # nonlinear structure
    etypes, euses, gtypes = {}, {}, {}
    grp_elems, grp_type = {}, {}

    section = None
    for raw in text.splitlines():
        if not raw.strip():
            continue
        if raw.lstrip().startswith("*"):
            # comment; harvest the conventional solution annotation
            toks = raw.replace("*", " ").split()
            if len(toks) >= 3 and toks[0] in ("LO", "UP") \
                    and toks[1] in ("SOLTN", "SOLUTION"):
                try:
                    solution = float(toks[2].replace("D", "E"))
                except ValueError:
                    pass
            continue
        if raw[0] not in " \t":          # indicator (section) line
            toks = raw.split()
            head = toks[0].upper()
            if head in ("ELEMENT", "GROUP") and len(toks) > 1:
                head = f"{head} {toks[1].upper()}"
            if head not in _SECTIONS:
                raise SifError(f"unknown SIF section '{raw.strip()}'")
            section = head
            if head == "NAME" and len(toks) > 1:
                name = toks[1]
            if head == "ENDATA":
                break
            continue

        toks = raw.split()
        if not toks:
            continue
        if section == "OBJSENSE":
            maximize = toks[0].upper() in ("MAX", "MAXIMIZE")
        elif section in ("ROWS", "GROUPS", "CONSTRAINTS"):
            t = toks[0].upper().lstrip("X")
            if t.startswith("Z"):
                raise SifError("parametric (Z*) SIF rows are unsupported")
            rname = toks[1]
            if t == "N":
                if obj_row is None:
                    obj_row = rname      # first N row is the primary
                obj_rows.append(rname)
                obj_set.add(rname)
                # extra N rows: ignored in the MPS/linear path; summed
                # objective groups in the nonlinear (SIF) path
            elif t in ("E", "L", "G"):
                con_idx[rname] = len(con_names)
                con_names.append(rname)
                con_types.append(t)
            else:
                raise SifError(f"unsupported row type '{toks[0]}'")
        elif section in ("COLUMNS", "VARIABLES"):
            if len(toks) >= 3 and toks[1].strip("'").upper() == "MARKER":
                mk_ = toks[2].strip("'").upper()
                if mk_ == "INTORG":
                    int_mode = True
                elif mk_ == "INTEND":
                    int_mode = False
                continue
            v = toks[0]
            if v not in var_idx:
                var_idx[v] = len(var_names)
                var_names.append(v)
                if int_mode:
                    x_int_names.add(v)
            for rname, val in _pairs(toks[1:], raw):
                if rname == obj_row:
                    g_ent.append((var_idx[v], val))
                elif rname in con_idx:
                    A_ent.append((con_idx[rname], var_idx[v], val))
                if rname in obj_set:
                    obj_ent.append((rname, var_idx[v], val))
                # entries on other free rows are dropped
        elif section in ("RHS", "CONSTANTS"):
            # first token is the rhs-set name unless it is a known row
            body = toks if toks[0] in con_idx or toks[0] in obj_set \
                else toks[1:]
            for rname, val in _pairs(body, raw):
                if rname == obj_row:
                    c0 = -val            # MPS objective-constant rule
                elif rname in con_idx:
                    rhs_ent.append((con_idx[rname], val))
                if rname in obj_set:
                    obj_rhs[rname] = val
        elif section == "RANGES":
            body = toks if toks[0] in con_idx else toks[1:]
            for rname, val in _pairs(body, raw):
                if rname in con_idx:
                    rng_ent.append((con_idx[rname], val))
        elif section == "BOUNDS":
            t = toks[0].upper().lstrip("X")
            # layout: TYPE SETNAME VAR [VALUE]; value-less types: FR/MI/PL/BV
            if t in ("FR", "MI", "PL", "BV"):
                bnd_ent.append((t, toks[-1], None))
            else:
                bnd_ent.append((t, toks[-2], _num(toks[-1], raw)))
        elif section == "START":
            body = toks
            if toks[0].upper() == "XV":
                body = toks[2:]
            elif len(toks) % 2 == 1 and toks[0] not in var_idx:
                body = toks[1:]          # leading start-point-set name
            for vname, val in _pairs(body, raw):
                if vname in var_idx:
                    sp_ent.append((var_idx[vname], val))
        elif section in ("QUADOBJ", "QSECTION", "QMATRIX", "QUADS",
                         "QUADRATIC", "HESSIAN"):
            if len(toks) < 3:
                raise SifError(f"malformed quadratic entry '{raw.strip()}'")
            i, j = var_idx.get(toks[0]), var_idx.get(toks[1])
            if i is None or j is None:
                raise SifError(f"quadratic entry on unknown variable: "
                               f"'{raw.strip()}'")
            Q_ent.append((i, j, _num(toks[2], raw)))
        elif section == "ELEMENT TYPE":
            t = toks[0].upper()
            if t == "EV":
                etypes.setdefault(toks[1], {"ev": [], "ep": []})
                if toks[2] not in etypes[toks[1]]["ev"]:
                    etypes[toks[1]]["ev"].append(toks[2])
            elif t == "EP":
                etypes.setdefault(toks[1], {"ev": [], "ep": []})
                etypes[toks[1]]["ep"].append(toks[2])
            elif t == "IV":
                raise SifError(
                    "SIF internal element variables (IV) are outside the "
                    "supported subset")
            else:
                raise SifError(f"unknown ELEMENT TYPE line '{raw.strip()}'")
        elif section == "ELEMENT USES":
            t = toks[0].upper()
            if t in ("T", "XT"):
                euses[toks[1]] = {"type": toks[2], "v": {}, "p": {}}
            elif t in ("V", "ZV"):
                if t == "ZV":
                    raise SifError("parametric ZV lines are unsupported")
                euses[toks[1]]["v"][toks[2]] = toks[3]
            elif t in ("P", "XP"):
                for pn, pv in _pairs(toks[2:], raw):
                    euses[toks[1]]["p"][pn] = pv
            else:
                raise SifError(f"unknown ELEMENT USES line '{raw.strip()}'")
        elif section == "GROUP TYPE":
            t = toks[0].upper()
            if t == "GV":
                gtypes[toks[1]] = toks[2]
            elif t == "GP":
                raise SifError(
                    "SIF group parameters (GP) are outside the supported "
                    "subset")
            else:
                raise SifError(f"unknown GROUP TYPE line '{raw.strip()}'")
        elif section == "GROUP USES":
            t = toks[0].upper()
            if t in ("T", "XT"):
                grp_type[toks[1]] = toks[2]
            elif t in ("E", "XE"):
                rname = toks[1]
                body = toks[2:]
                lst = grp_elems.setdefault(rname, [])
                k = 0
                while k < len(body):
                    ename = body[k]
                    w = 1.0
                    if k + 1 < len(body):
                        try:
                            w = float(body[k + 1].replace("D", "E"))
                            k += 1
                        except ValueError:
                            pass
                    lst.append((ename, w))
                    k += 1
            else:
                raise SifError(f"unknown GROUP USES line '{raw.strip()}'")
        elif section == "OBJECT":        # OBJECT BOUND: documentation only
            continue
        elif section == "NAME":
            continue
        else:
            raise SifError(f"data line outside a known section: "
                           f"'{raw.strip()}'")

    n, m = len(var_names), len(con_names)
    g = np.zeros(n)
    for i, v in g_ent:
        g[i] += v
    A = np.zeros((m, n))
    for r, i, v in A_ent:
        A[r, i] += v
    Q = np.zeros((n, n))
    for i, j, v in Q_ent:
        # QUADOBJ/QMATRIX entries define f = 1/2 x'Qx; one-triangle input
        # is mirrored, explicit both-triangle input overwrites itself
        Q[i, j] = v
        Q[j, i] = v
    rhs = np.zeros(m)
    for r, v in rhs_ent:
        rhs[r] = v
    rng = np.full(m, np.nan)
    for r, v in rng_ent:
        rng[r] = v

    # default SIF/MPS variable bounds: [0, inf)
    x_lo = np.zeros(n)
    x_up = np.full(n, np.inf)
    lo_explicit = np.zeros(n, bool)
    for t, vname, val in bnd_ent:
        if vname not in var_idx:
            raise SifError(f"bound on unknown variable '{vname}'")
        i = var_idx[vname]
        if t in ("LO", "LI"):
            x_lo[i] = val
            lo_explicit[i] = True
        elif t in ("UP", "UI"):
            x_up[i] = val
            # MPS rule: a negative upper bound with a still-default lower
            # bound frees the lower bound
            if val < 0.0 and not lo_explicit[i]:
                x_lo[i] = -np.inf
        elif t == "FX":
            x_lo[i] = x_up[i] = val
            lo_explicit[i] = True
        elif t == "FR":
            x_lo[i], x_up[i] = -np.inf, np.inf
            lo_explicit[i] = True
        elif t == "MI":
            x_lo[i] = -np.inf
            lo_explicit[i] = True
        elif t == "PL":
            x_up[i] = np.inf
        elif t == "BV":
            x_lo[i], x_up[i] = 0.0, 1.0
            x_int_names.add(vname)
        else:
            raise SifError(f"unsupported bound type '{t}'")

    x0 = np.clip(np.zeros(n), x_lo, x_up)
    x0[~np.isfinite(x0)] = 0.0
    for i, v in sp_ent:
        x0[i] = v
    x_int = np.array([vn in x_int_names for vn in var_names], bool)

    # -- nonlinear structure: function parts + validation -----------------
    elem_fns = _parse_fn_part(elem_text, "ELEMENTS") \
        if elem_text.strip() else {}
    group_fns = _parse_fn_part(group_text, "GROUPS") \
        if group_text.strip() else {}
    for ename, use in euses.items():
        if use["type"] not in elem_fns:
            raise SifError(f"element '{ename}' uses type '{use['type']}' "
                           "with no F definition in the ELEMENTS part")
        if use["type"] not in etypes:
            raise SifError(f"element type '{use['type']}' is used but "
                           "never declared (ELEMENT TYPE)")
        for v in use["v"].values():
            if v not in var_idx:
                raise SifError(f"element '{ename}' maps to unknown "
                               f"variable '{v}'")
    for rname, gt in grp_type.items():
        if gt not in group_fns or gt not in gtypes:
            raise SifError(f"row '{rname}' uses group type '{gt}' with no "
                           "GV declaration / F definition")
    for rname, lst in grp_elems.items():
        if rname not in con_idx and rname not in obj_set:
            raise SifError(f"GROUP USES on unknown row '{rname}'")
        for ename, _w in lst:
            if ename not in euses:
                raise SifError(f"row '{rname}' uses undefined element "
                               f"'{ename}'")
    obj_lin = {}
    if euses or grp_type:
        for rname in obj_rows:
            obj_lin[rname] = np.zeros(n)
        for rname, i, v in obj_ent:
            obj_lin[rname][i] += v

    return SifData(name=name, var_names=var_names, con_names=con_names,
                   con_types=con_types, g=g, Q=Q, c0=float(c0), A=A,
                   rhs=rhs, ranges=rng, x_lo=x_lo, x_up=x_up, x0=x0,
                   x_int=x_int, solution=solution, maximize=maximize,
                   etypes=etypes, euses=euses, gtypes=gtypes,
                   grp_elems=grp_elems, grp_type=grp_type,
                   elem_fns=elem_fns, group_fns=group_fns,
                   obj_rows=obj_rows, obj_lin=obj_lin, obj_rhs=obj_rhs)


def _pairs(toks, raw):
    if len(toks) % 2:
        raise SifError(f"odd (name, value) list in '{raw.strip()}'")
    for k in range(0, len(toks), 2):
        yield toks[k], _num(toks[k + 1], raw)


def _num(tok, raw):
    try:
        return float(tok.replace("D", "E").replace("d", "e"))
    except ValueError:
        raise SifError(f"expected a number, got '{tok}' in '{raw.strip()}'")


def load_sif(path: str) -> SifData:
    with open(path) as fh:
        return parse_sif(fh.read(), name_hint=path)




# ---------------------------------------------------------------------------
# program wrapper: the Prg_CUTE role
# ---------------------------------------------------------------------------


@modules.register("prg_name", "SIF")
@modules.register("prg_name", "CUTE")
class PrgSIF(Nlp):
    """An ingested SIF problem as a general NLP program on ``device``
    (hqp/Prg_CUTE.C's role: CSETUP-style data -> Hqp_SqpProgram)."""

    name = "SIF"

    def __init__(self, source: str | SifData = None, path: str = None,
                 device="cuda"):
        super().__init__(device)
        if path is not None:
            data = load_sif(path)
        elif isinstance(source, SifData):
            data = source
        elif isinstance(source, str):
            data = parse_sif(source)
        else:
            raise SifError("PrgSIF needs a SIF text, path= or SifData")
        self.data = data
        self.name = data.name
        self.n = data.n
        self.m = data.m
        sgn = -1.0 if data.maximize else 1.0

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64,
                                   device=self.device)

        self._Q = t(sgn * data.Q)
        self._g = t(sgn * data.g)
        self._c0 = sgn * data.c0
        self._A = t(data.A)
        self._Qraw = t(data.Q)
        self._obj_lin = {r: t(v) for r, v in data.obj_lin.items()}
        self._vidx = {v: i for i, v in enumerate(data.var_names)}
        self._nl = data.has_nonlinear()
        self._env = _fn_env(self.device)
        if self._nl:
            for rname in data.grp_type:
                if rname in data.obj_rows and np.abs(data.Q).sum() > 0:
                    raise SifError("a group-typed objective row cannot be "
                                   "combined with QUADOBJ terms")

    # -- nonlinear evaluation (torch expressions; derivatives by torch.func,
    # the decoder+Fortran-callback replacement of Prg_CUTE.C:117-614) ----

    def _elem(self, ename, x):
        d = self.data
        use = d.euses[ename]
        fns = d.elem_fns[use["type"]]
        env = dict(self._env)
        for ev, var in use["v"].items():
            env[ev] = x[self._vidx[var]]
        env.update(use["p"])
        for nm, code in fns["temps"]:
            env[nm] = eval(code, {"__builtins__": {}}, env)
        return eval(fns["f"], {"__builtins__": {}}, env)

    def _row_alpha(self, rname, lin_val, x):
        v = lin_val
        for ename, w in self.data.grp_elems.get(rname, []):
            v = v + w * self._elem(ename, x)
        return v

    def _apply_gtype(self, gt, alpha):
        d = self.data
        env = dict(self._env)
        env[d.gtypes[gt]] = alpha
        fns = d.group_fns[gt]
        for nm, code in fns["temps"]:
            env[nm] = eval(code, {"__builtins__": {}}, env)
        return eval(fns["f"], {"__builtins__": {}}, env)

    def setup_vars(self):
        c_min, c_max = self.data.bounds()
        if self._nl:
            # group-typed constraint rows compare g(alpha - b) against 0
            inf = np.inf
            for r, rname in enumerate(self.data.con_names):
                if rname in self.data.grp_type:
                    if np.isfinite(self.data.ranges[r]):
                        raise SifError("RANGES on a group-typed row are "
                                       "unsupported")
                    t = self.data.con_types[r]
                    c_min[r], c_max[r] = {
                        "E": (0.0, 0.0), "L": (-inf, 0.0),
                        "G": (0.0, inf)}[t]
        return dict(x_init=self.data.x0, x_min=self.data.x_lo,
                    x_max=self.data.x_up, c_min=c_min, c_max=c_max)

    def f0(self, x):
        if not self._nl:
            return self._c0 + self._g @ x + 0.5 * x @ (self._Q @ x)
        d = self.data
        f = 0.5 * x @ (self._Qraw @ x)
        for rname in d.obj_rows:
            lin = self._obj_lin[rname] @ x - d.obj_rhs.get(rname, 0.0)
            alpha = self._row_alpha(rname, lin, x)
            gt = d.grp_type.get(rname)
            f = f + (self._apply_gtype(gt, alpha) if gt else alpha)
        return -f if d.maximize else f

    def c(self, x):
        base = self._A @ x
        if not self._nl:
            return base
        d = self.data
        vals = []
        for r, rname in enumerate(d.con_names):
            v = base[r]
            if rname in d.grp_elems or rname in d.grp_type:
                v = self._row_alpha(rname, v, x)
                gt = d.grp_type.get(rname)
                if gt:
                    v = self._apply_gtype(gt, v - d.rhs[r])
            vals.append(v)
        return torch.stack(vals) if vals else base

    def objective(self, f_internal):
        """Report in the problem's own sense (max problems are solved as
        minimizations internally)."""
        return -f_internal if self.data.maximize else f_internal


def solve_sif(path_or_text: str, eps: float = 1e-7, max_iters: int = 100,
              device="cuda"):
    """Solve a SIF file (or text) on ``device`` through the host-sparse
    path: SqpPowell with the Gerschgorin hela, Mehrotra(eps=1e-10,
    max_iters=60) and :class:`~hqp_tpu_torch.qp.kkt_sparse_host.
    SparseHostKKT`, as the reference's ``solve_sif``; returns a summary
    dict."""
    from hqp_tpu_torch.qp.kkt_sparse_host import SparseHostKKT
    from hqp_tpu_torch.qp.mehrotra import Mehrotra
    from hqp_tpu_torch.sqp.hessian import Gerschgorin
    from hqp_tpu_torch.sqp.powell import SqpPowell

    prg = (PrgSIF(path=path_or_text, device=device)
           if os.path.exists(path_or_text)
           else PrgSIF(path_or_text, device=device))
    s = SqpPowell(prg, max_iters=max_iters, eps=eps, hela=Gerschgorin(),
                  qp_solver=Mehrotra(eps=1e-10, max_iters=60),
                  kkt_backend=SparseHostKKT())
    s.init()
    result = s.solve()
    obj = prg.objective(float(s.f))
    out = {"problem": prg.name, "n": prg.n, "m": prg.m, "result": result,
           "obj": obj, "sqp_iters": s.iter,
           "qp_iters_total": s.qp_iters_total,
           "known_solution": prg.data.solution,
           "ok": result == "optimal"}
    if prg.data.solution is not None:
        out["ok"] = out["ok"] and abs(obj - prg.data.solution) <= \
            1e-4 * max(1.0, abs(prg.data.solution))
    return out
