"""Port kernels, small-block linear algebra and integrators against the
JAX package.

The plain torch twins of the CUDA kernels (``hqp_tpu_torch.ops.gj_cuda``
and ``thomas_cuda``) are held against the Pallas kernels run in interpret
mode, as tests/test_pallas_ops.py runs them on the CPU, on the same
seeded numpy inputs; in float64 they are held against numpy.linalg.  The
CUDA kernels themselves run only on a card (chip_smoke.py compares them
with these twins there).  The fixed-step integrators are held against the
reference's on its linear test ODE, and the two programs that lean on
them hardest (Crane at 50 stages, Bio through IMP) are solved end to end
by both packages.
"""

import collections
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

import hqp_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from hqp_tpu.models.crane import PrgCrane as JPrgCrane
from hqp_tpu.models.omu_suite import PrgBio as JPrgBio
from hqp_tpu.omu import integrators as jint
from hqp_tpu.ops import blocktri as jbt
from hqp_tpu.ops import smalllin as jsl
from hqp_tpu.ops.gj_pallas import interior_factor as gj_pallas
from hqp_tpu.ops.thomas_pallas import thomas_solve as thomas_pallas
from hqp_tpu.sqp.powell import SqpPowell as JSqpPowell
from tests.test_omu import F_linear

from hqp_tpu_torch.models.crane import PrgCrane
from hqp_tpu_torch.models.omu_suite import PrgBio
from hqp_tpu_torch.omu import integrators as tint
from hqp_tpu_torch.ops import blocktri, gj_cuda, smalllin, thomas_cuda
from hqp_tpu_torch.sqp.powell import SqpPowell
from hqp_tpu_torch.utils.registry import modules as modules_t



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

def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _gj_inputs(P, s, b, seed):
    rng = np.random.default_rng(seed)
    # a diagonal shift that keeps the largest tiles well conditioned
    shift = 4.0 if s < 100 else 3.0 * np.sqrt(s)
    M = rng.standard_normal((P, s, s)) + shift * np.eye(s)
    M[:, 0, 0] = 0.0          # forces a pivot swap at step 0
    return M, rng.standard_normal((P, s, b))


def _spd_tridiag(N, n, seed):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((N - 1, n, n)) * 0.3
    D = np.tile(np.eye(n) * 3.0, (N, 1, 1)) + rng.standard_normal(
        (N, n, n)) * 0.1
    D = 0.5 * (D + np.swapaxes(D, -1, -2))
    return D, U, rng.standard_normal((N, n))


def _tridiag_dense(D, U):
    N, n, _ = D.shape
    T = np.zeros((N * n, N * n))
    for i in range(N):
        T[i * n:(i + 1) * n, i * n:(i + 1) * n] = D[i]
    for i in range(N - 1):
        T[i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n] = U[i]
        T[(i + 1) * n:(i + 2) * n, i * n:(i + 1) * n] = U[i].T
    return T


# -- K1: batched pivoted Gauss-Jordan ----------------------------------------

#: (1, 245, 10) is CranePar's interior, which takes the large K1 kernel on
#: the card (the register kernel's tile does not fit)
GJ_SHAPES = [(11, 17, 4), (5, 9, 2), (3, 48, 4), (1, 245, 10)]
#: numpy only: s = 73 in interpret mode would cost minutes of compile time;
#: s = 152 and 512 are the large route's ends at b = 10 on an H100
GJ_SHAPES_F64 = GJ_SHAPES + [(2, 73, 4), (1, 152, 10), (1, 512, 10)]


@pytest.mark.parametrize("P,s,b", GJ_SHAPES)
def test_gj_plain_matches_pallas_f32(P, s, b):
    """Same pivot sequence as the TPU kernel; only the rounding order
    differs, so f32 agreement is at 1e-4 of the largest entry."""
    M, B = _gj_inputs(P, s, b, seed=s)
    M32, B32 = M.astype(np.float32), B.astype(np.float32)
    ref = [np.asarray(o) for o in gj_pallas(jnp.asarray(M32),
                                             jnp.asarray(B32))]
    out = gj_cuda.interior_factor(_t(M32, torch.float32),
                                  _t(B32, torch.float32))
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), r,
                                   atol=1e-4 * np.abs(r).max(), rtol=0)


@pytest.mark.parametrize("P,s,b", GJ_SHAPES_F64)
def test_gj_plain_f64_matches_numpy(P, s, b):
    M, B = _gj_inputs(P, s, b, seed=s + 1)
    Minv, W, S = gj_cuda.interior_factor(_t(M), _t(B))
    Wref = np.linalg.solve(M, B)
    for o, r in ((Minv, np.linalg.inv(M)), (W, Wref),
                 (S, np.einsum("psb,psc->pbc", B, Wref))):
        np.testing.assert_allclose(o.numpy(), r,
                                   atol=1e-10 * np.abs(r).max(), rtol=0)


#: an H100's opt-in shared memory a block (bytes)
H100_SMEM_OPTIN = 232448


@pytest.mark.parametrize("b,dtype", [(10, torch.float64), (12, torch.float64),
                                     (10, torch.float32),
                                     (12, torch.float32)])
def test_gj_cluster_size_rule(b, dtype):
    """For every interior the large route takes on an H100 (s = 152 ..
    512), the cluster size is one the kernel has, its band fits a
    thread's registers and its block the opt-in shared memory; s = 512
    in f64 needs 16 blocks."""
    el = torch.finfo(dtype).bits // 8
    for s in range(152, 513):
        C = gj_cuda.cluster_size(s, b, dtype, H100_SMEM_OPTIN)
        assert C in (4, 8, 16)
        rows = -(-s // C)
        assert rows <= 4 * gj_cuda.LARGE_WARPS
        assert 0 < gj_cuda.large_regs(s, dtype, C) <= gj_cuda.LARGE_REG_BYTES
        smem = gj_cuda.large_smem(s, b, dtype, C)
        # at least MIB and the 2 C + 2 pushed and outgoing rows
        assert (s * b + (2 * C + 2) * s) * el < smem <= H100_SMEM_OPTIN
    if dtype == torch.float64:
        assert gj_cuda.cluster_size(512, b, dtype, H100_SMEM_OPTIN) == 16
    with pytest.raises(ValueError):
        gj_cuda.cluster_size(512, b, dtype, 16 * 1024)


@pytest.mark.parametrize("s,b,dtype,want", [
    (98, 4, torch.float64, "batch"),    # the scenario batch, scenarios256
    (48, 4, torch.float64, "batch"),    # DID-1000
    (98, 4, torch.float32, "batch"),
    (1, 4, torch.float64, "batch"),
    (99, 4, torch.float64, "tile"),     # past the batched route's tiles
    (98, 60, torch.float64, "tile"),    # two of b = 60 do not fit an SM
    (124, 12, torch.float64, "tile"),   # the crane
    (151, 10, torch.float64, "tile"),   # the tile route's top
    (152, 10, torch.float64, "large"),
    (245, 10, torch.float64, "large"),  # CranePar
    (513, 10, torch.float64, "inv"),
])
def test_gj_route_rule_at_callers(s, b, dtype, want):
    """K1's route at each caller's shape on an H100: the batched route
    wherever two interiors fit one SM (SpSCdist's [50, 98, 98] too, and at
    any batch), the tile route above, then the large route and
    torch.linalg.inv."""
    assert gj_cuda.route_rule(s, b, dtype, H100_SMEM_OPTIN) == want


@pytest.mark.parametrize("b,dtype", [(4, torch.float64), (10, torch.float64),
                                     (12, torch.float64),
                                     (4, torch.float32)])
def test_gj_route_rule_is_one_size_rule(b, dtype):
    """Over every size the rule is one size rule: the batched route for s
    <= BATCH_MAX, else the tile route up to the size its block holds, the
    large route to 512, torch.linalg.inv above; two batched blocks always
    fit the SM's shared memory where the rule takes them."""
    lim = H100_SMEM_OPTIN
    top = max(s for s in range(1, 513) if gj_cuda.tile_smem(s, b, dtype)
              <= lim)
    ways = [gj_cuda.route_rule(s, b, dtype, lim) for s in range(1, 514)]
    nbat = gj_cuda.BATCH_MAX
    assert ways == (["batch"] * nbat + ["tile"] * (top - nbat)
                    + ["large"] * (512 - top) + ["inv"])
    assert all(2 * (gj_cuda.batch_smem(s, b, dtype) + 1024) <= lim + 1024
               for s in range(1, nbat + 1))


def test_gj_register_layouts():
    """The wrapper's copies of the register kernels' shared-memory layouts
    (chip_smoke.py phase 24 holds both against the kernels'): the tile
    kernel's block holds s <= 151 at b = 10 in f64 on an H100, as phase 8
    found on the card, and takes 29 KB at s = 48 and 147 KB at s = 124
    (b = 4; its source says so); the batched kernel's block holds the
    staged matrix and MIB, W, two columns over the rows of its register
    tile and the 16 past it (64 or 112 rows), the logical positions over
    as many rows and the logical -> row map: 85,808 bytes at s = 98, b = 4
    in f64, about half that in f32."""
    f64, f32 = torch.float64, torch.float32
    assert gj_cuda.tile_smem(151, 10, f64) <= H100_SMEM_OPTIN \
        < gj_cuda.tile_smem(152, 10, f64)
    assert round(gj_cuda.tile_smem(48, 4, f64) / 1024) == 29
    assert round(gj_cuda.tile_smem(124, 4, f64) / 1024) == 147
    for s in range(1, gj_cuda.BATCH_MAX + 1):
        rp = 64 if s <= 48 else 112
        for b, dt in ((4, f64), (12, f64), (4, f32)):
            el = torch.finfo(dt).bits // 8
            need = (s * s + 2 * s * b + 2 * rp) * el + 4 * (rp + s)
            assert need < gj_cuda.batch_smem(s, b, dt) <= need + 160
    assert gj_cuda.batch_smem(98, 4, f64) == 85808
    assert gj_cuda.batch_smem(98, 4, f32) == 43344
    assert gj_cuda.batch_fits(98, 4, f64, H100_SMEM_OPTIN)
    assert not gj_cuda.batch_fits(99, 4, f64, H100_SMEM_OPTIN)


def test_gj_plain_batch_axis_and_nan_pivot():
    """A leading scenario axis flattens into the batch; a NaN column
    never wins the pivot search (the row index stays valid)."""
    M, B = _gj_inputs(6, 7, 2, seed=3)
    out = gj_cuda.interior_factor(_t(M).reshape(2, 3, 7, 7),
                                  _t(B).reshape(2, 3, 7, 2))
    flat = gj_cuda.interior_factor(_t(M), _t(B))
    assert out[0].shape == (2, 3, 7, 7) and out[2].shape == (2, 3, 2, 2)
    for o, f in zip(out, flat):
        torch.testing.assert_close(o.reshape(f.shape), f, rtol=0, atol=0)
    Mn = M.copy()
    Mn[0, 2, 0] = np.nan
    Minv = gj_cuda.interior_factor(_t(Mn), _t(B))[0]
    assert torch.isfinite(Minv[1:]).all()


# -- K2: block-Thomas -----------------------------------------------------------

THOMAS_SHAPES = [(7, 2), (33, 3), (101, 2), (1, 1), (2, 8), (5, 8)]


@pytest.mark.parametrize("N,n", THOMAS_SHAPES)
def test_thomas_plain_matches_pallas_f32(N, n):
    D, U, r = _spd_tridiag(N, n, seed=N)
    D32, U32, r32 = (a.astype(np.float32) for a in (D, U, r))
    ref = np.asarray(thomas_pallas(jnp.asarray(D32), jnp.asarray(U32),
                                   jnp.asarray(r32)))
    x = thomas_cuda.thomas_solve(_t(D32, torch.float32),
                                 _t(U32, torch.float32),
                                 _t(r32, torch.float32))
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), ref,
                               atol=1e-4 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("N,n", [(7, 2), (101, 2), (5, 8)])
def test_thomas_scaled_plain_matches_pallas_f32(N, n):
    """thomas_solve_scaled (d * K2(D, U, d * rhs)) on its plain twin
    against the reference's thomas_solve_scaled, whose Thomas solve runs
    in interpret mode (the shapes and systems of
    test_thomas_plain_matches_pallas_f32, so the traces are shared)."""
    from hqp_tpu.ops.thomas_pallas import thomas_solve_scaled as jscaled
    D, U, r = _spd_tridiag(N, n, seed=N)
    d = np.random.default_rng(N + n).uniform(0.5, 2.0, (N, n))
    a32 = [a.astype(np.float32) for a in (D, U, d, r)]
    ref = np.asarray(jscaled(*(jnp.asarray(a) for a in a32)))
    x = thomas_cuda.thomas_solve_scaled(*(_t(a, torch.float32)
                                          for a in a32))
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), ref,
                               atol=1e-4 * np.abs(ref).max(), rtol=0)
    torch.testing.assert_close(
        x, thomas_cuda.thomas_solve_scaled_plain(
            *(_t(a, torch.float32) for a in a32)), rtol=0, atol=0)


@pytest.mark.parametrize("N,n", THOMAS_SHAPES)
def test_thomas_plain_f64_matches_numpy(N, n):
    D, U, r = _spd_tridiag(N, n, seed=N + 1)
    ref = np.linalg.solve(_tridiag_dense(D, U), r.reshape(-1)).reshape(N, n)
    x = thomas_cuda.thomas_solve(_t(D), _t(U), _t(r))
    np.testing.assert_allclose(x.numpy(), ref,
                               atol=1e-10 * np.abs(ref).max(), rtol=0)
    # a batch of systems solves each system on its own (batched products
    # may round differently from single ones)
    xb = thomas_cuda.thomas_solve(_t(D).expand(3, -1, -1, -1),
                                  _t(U).expand(3, -1, -1, -1),
                                  _t(r).expand(3, -1, -1))
    torch.testing.assert_close(xb, x.expand(3, -1, -1), rtol=0,
                               atol=1e-14 * np.abs(ref).max())


# -- smalllin and blocktri against the reference ---------------------------------


@pytest.mark.parametrize("n,floor", [(3, None), (5, 1e-14), (1, None)])
def test_smalllin_matches_reference(n, floor):
    rng = np.random.default_rng(n)
    X = rng.standard_normal((6, n, n))
    A = X @ np.swapaxes(X, 1, 2) + n * np.eye(n)
    b = rng.standard_normal((6, n))
    Bm = rng.standard_normal((6, n, 2))
    Lj = jsl.chol(jnp.asarray(A), floor_rel=floor)
    Lt = smalllin.chol(_t(A), floor_rel=floor)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=0,
                               atol=1e-12)
    for jf, tf in ((jsl.tri_lower_solve, smalllin.tri_lower_solve),
                   (jsl.tri_upper_solve, smalllin.tri_upper_solve),
                   (jsl.cho_solve, smalllin.cho_solve)):
        for rhs in (b, Bm):
            ref = np.asarray(jf(Lj, jnp.asarray(rhs)))
            np.testing.assert_allclose(tf(Lt, _t(rhs)).numpy(), ref,
                                       rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [1, 4])
def test_spd_solve_matches_reference(n):
    """smalllin.spd_solve (Cholesky, then the two triangular solves) on a
    batch of SPD blocks, for a vector and a matrix right-hand side."""
    rng = np.random.default_rng(10 + n)
    X = rng.standard_normal((5, n, n))
    A = X @ np.swapaxes(X, 1, 2) + n * np.eye(n)
    for rhs in (rng.standard_normal((5, n)), rng.standard_normal((5, n, 3))):
        ref = np.asarray(jsl.spd_solve(jnp.asarray(A), jnp.asarray(rhs)))
        np.testing.assert_allclose(smalllin.spd_solve(_t(A), _t(rhs)).numpy(),
                                   ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("N,n", [(101, 2), (8, 3), (2, 2)])
def test_blocktri_matches_reference(N, n):
    """Equilibration, cyclic reduction and the block-Cholesky scan agree
    with the reference, and so do the equilibrated solves solve_scaled and
    cr_solve_scaled; the f64 Thomas twin, through thomas_solve_scaled,
    agrees with CR (it is the master solve's other route)."""
    D, U, r = _spd_tridiag(N, n, seed=N + n)

    @jax.jit
    def ref_fn(D, U, r):
        Sj, Uj, dj = jbt.equilibrate(D, U)
        Lj, Wj = jbt.factor(Sj, Uj)
        return (Sj, Uj, dj, Lj,
                jbt.cr_solve_scaled(jbt.cr_factor(Sj, Uj), dj, r),
                jbt.solve_scaled(Lj, Wj, dj, r))

    Sj, Uj, dj, Lj, ref, ref_bc = (np.asarray(a) for a in ref_fn(
        jnp.asarray(D), jnp.asarray(U), jnp.asarray(r)))
    St, Ut, dt = blocktri.equilibrate(_t(D), _t(U))
    for a, b in ((St, Sj), (Ut, Uj), (dt, dj)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12)
    x_cr = blocktri.cr_solve_scaled(blocktri.cr_factor(St, Ut), dt, _t(r))
    np.testing.assert_allclose(x_cr.numpy(), ref, rtol=0, atol=1e-12)
    Lt, Wt = blocktri.factor(St, Ut)
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=0, atol=1e-12)
    x_bc = blocktri.solve_scaled(Lt, Wt, dt, _t(r))
    np.testing.assert_allclose(x_bc.numpy(), ref_bc, rtol=0, atol=1e-12)
    x_th = thomas_cuda.thomas_solve_scaled(St, Ut, dt, _t(r))
    np.testing.assert_allclose(x_th.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [1, 3, 6])
def test_smalllin_nopiv_matches_reference(n):
    """The pivot-free LU routines of the implicit integrators, with the
    reference's unrolled order of operations."""
    rng = np.random.default_rng(40 + n)
    A = rng.standard_normal((4, n, n)) + 3.0 * np.eye(n)
    b = rng.standard_normal((4, n))
    Bm = rng.standard_normal((4, n, 3))
    Mj = jsl.lu_nopiv(jnp.asarray(A))
    Mt = smalllin.lu_nopiv(_t(A))
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), rtol=0,
                               atol=1e-12)
    for rhs in (b, Bm):
        np.testing.assert_allclose(
            smalllin.lu_nopiv_solve(Mt, _t(rhs)).numpy(),
            np.asarray(jsl.lu_nopiv_solve(Mj, jnp.asarray(rhs))),
            rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            smalllin.solve_nopiv(_t(A), _t(rhs)).numpy(),
            np.asarray(jsl.solve_nopiv(jnp.asarray(A), jnp.asarray(rhs))),
            rtol=0, atol=1e-12)
    np.testing.assert_allclose(smalllin.inv_nopiv(_t(A)).numpy(),
                               np.asarray(jsl.inv_nopiv(jnp.asarray(A))),
                               rtol=0, atol=1e-12)


# -- the fixed-step integrators ---------------------------------------------------


def _F_linear_torch(kk, t, x, u, dx):
    """tests/test_omu.py's linear test ODE xdot = A x + b u, in torch."""
    A = torch.tensor([[0.0, 1.0], [-2.0, -0.3]], dtype=x.dtype)
    b = torch.tensor([0.0, 1.0], dtype=x.dtype)
    return A @ x + b * u[0] - dx


@pytest.mark.parametrize("name,steps", [("Euler", 7), ("RK4", 5),
                                        ("IMP", 4)])
def test_integrator_matches_reference(name, steps):
    """One sample period of each fixed-step integrator on the linear test
    ODE, and its jacfwd sensitivities to (x, u), for a batch of starting
    points under vmap as Docp.eval_derivs runs them.  IMP's derivatives
    come from the implicit function theorem in both packages."""
    ij = getattr(jint, name)(steps=steps)
    it = getattr(tint, name)(steps=steps)
    rng = np.random.default_rng(steps)
    X = rng.standard_normal((3, 2))
    U = rng.standard_normal((3, 1))
    T0 = np.array([0.0, 0.3, 0.7])

    def fj(x, u, t0):
        return ij.solve(F_linear, 0, t0, t0 + 0.8, x, u)

    def ft(x, u, t0):
        return it.solve(_F_linear_torch, torch.tensor(0), t0, t0 + 0.8, x, u)

    ref = jax.vmap(fj)(*(jnp.asarray(a) for a in (X, U, T0)))
    out = torch.func.vmap(ft)(*(_t(a) for a in (X, U, T0)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    jref = jax.vmap(jax.jacfwd(fj, argnums=(0, 1)))(
        *(jnp.asarray(a) for a in (X, U, T0)))
    jout = torch.func.vmap(torch.func.jacfwd(ft, argnums=(0, 1)))(
        *(_t(a) for a in (X, U, T0)))
    for o, r in zip(jout, jref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12)


# -- the rest of the integrator family --------------------------------------------

#: the test problems of tests/test_integrators2.py with a rate per sample
#: period kk, so that the three stages take different numbers of steps:
#: the oscillator, the stiff relaxation onto cos(t) and the index-1 DAE
#: x0' = -w x0 + x1 + u, 0 = x1 - x0^2
_RATE = {"osc": (1.0, 3.0, 6.0), "stiff": (50.0, 200.0, 1000.0),
         "dae": (1.0, 2.0, 4.0)}
_NX = {"osc": 2, "stiff": 1, "dae": 2}


def _problem_jax(prob):
    rate = jnp.asarray(_RATE[prob])

    def F(kk, t, x, u, dx):
        w = rate[kk]
        if prob == "osc":
            return jnp.array([x[1] - dx[0], -w * w * x[0] + u[0] - dx[1]])
        if prob == "stiff":
            return jnp.array([-w * (x[0] - jnp.cos(t)) + u[0] - dx[0]])
        return jnp.array([-w * x[0] + x[1] + u[0] - dx[0],
                          x[1] - x[0] * x[0]])
    return F


def _problem_torch(prob):
    from hqp_tpu_torch.omu.program import at
    rate = torch.tensor(_RATE[prob], dtype=torch.float64)

    def F(kk, t, x, u, dx):
        w = at(rate, kk)
        if prob == "osc":
            return torch.stack([x[1] - dx[0], -w * w * x[0] + u[0] - dx[1]])
        if prob == "stiff":
            return torch.stack([-w * (x[0] - torch.cos(t)) + u[0] - dx[0]])
        return torch.stack([-w * x[0] + x[1] + u[0] - dx[0],
                            x[1] - x[0] * x[0]])
    return F


#: each integrator of the slice (keywords for both packages) with the
#: problems it runs: the explicit ones the oscillator, the stiff
#: (xdot-form) ones the relaxation too, the DAE solvers all three;
#: tolerances looser than the default where the port's eager loop would
#: take hundreds of iterations
NEW_INTEGRATORS = {
    "Dopri5": ({}, ("osc",)),
    "RKsuite": ({"method": 2, "rtol": 1e-6, "atol": 1e-6}, ("osc",)),
    "RKF78": ({}, ("osc",)),
    "OdeTs": ({"order": 6, "steps": 2}, ("osc",)),
    "GRK4": ({"steps": 3}, ("osc", "stiff")),
    "GRK4Adaptive": ({"rtol": 1e-6, "atol": 1e-6}, ("osc", "stiff")),
    "IMPAdaptive": ({"rtol": 1e-4, "atol": 1e-4}, ("osc", "stiff")),
    "SDIRK": ({"steps": 2}, ("osc", "stiff", "dae")),
    "BDF": ({"steps": 3}, ("osc", "stiff", "dae")),
    "DASPK": ({"steps": 2, "krylov": True}, ("osc", "stiff", "dae")),
    "BDFAdaptive": ({"rtol": 1e-3, "atol": 1e-3}, ("osc", "stiff", "dae")),
    "BDFVarOrder": ({"rtol": 1e-3, "atol": 1e-3}, ("osc", "stiff", "dae")),
}


#: the cases of test_new_integrator_matches_reference, in its order
INTEG_CASES = [(n, p) for n, (_, probs) in NEW_INTEGRATORS.items()
               for p in probs]


def _relmax(out, ref):
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(out) - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def _stage_inputs(prob, seed):
    """Three stages (kk = 0, 1, 2) of seeded starting points and controls
    over [0.3 kk, 0.3 kk + 0.5]; the DAE's start is consistent."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.2, 0.8, (3, _NX[prob]))
    if prob == "dae":
        X[:, 1] = X[:, 0] ** 2
    U = rng.standard_normal((3, 1))
    T0 = np.array([0.0, 0.3, 0.6])
    return X, U, T0, np.arange(3)


def test_adaptive_stages_take_their_own_steps():
    """The stages of one batched loop keep their own step sequences: each
    stage of the batched BDFVarOrder solve equals its unbatched solve to
    the last bit, and they took different numbers of steps (solve_stats,
    the reference's own counters) in both packages."""
    kw = NEW_INTEGRATORS["BDFVarOrder"][0]
    ij, it = jint.BDFVarOrder(**kw), tint.BDFVarOrder(**kw)
    Fj, Ft = _problem_jax("stiff"), _problem_torch("stiff")
    X, U, T0, KK = _stage_inputs("stiff", seed=0)
    out = torch.func.vmap(lambda x, u, t0, kk: it.solve(
        Ft, kk, t0, t0 + 0.5, x, u))(_t(X), _t(U), _t(T0),
                                     torch.as_tensor(KK))
    steps = []
    for k in range(3):
        xs, n, order = it.solve_stats(Ft, k, T0[k], T0[k] + 0.5, _t(X[k]),
                                      _t(U[k]))
        jx, jn, jorder = ij.solve_stats(Fj, k, T0[k], T0[k] + 0.5,
                                        jnp.asarray(X[k]), jnp.asarray(U[k]))
        assert torch.equal(out[k], xs)
        assert (n, order) == (jn, jorder)
        assert _relmax(xs.numpy(), jx) <= 1e-12
        steps.append(n)
    assert len(set(steps)) == 3, steps


def test_truncated_loop_gives_nan():
    """An adaptive loop that runs out of max_steps returns NaN in both
    packages (the SQP treats it as a failed model evaluation); the stage
    that finishes in time keeps its value."""
    Fj, Ft = _problem_jax("osc"), _problem_torch("osc")
    X, U, T0, KK = _stage_inputs("osc", seed=1)
    ij, it = jint.Dopri5(max_steps=12), tint.Dopri5(max_steps=12)
    ref = np.asarray(jax.vmap(lambda x, u, t0, kk: ij.solve(
        Fj, kk, t0, t0 + 0.5, x, u))(jnp.asarray(X), jnp.asarray(U),
                                     jnp.asarray(T0), jnp.asarray(KK)))
    out = torch.func.vmap(lambda x, u, t0, kk: it.solve(
        Ft, kk, t0, t0 + 0.5, x, u))(_t(X), _t(U), _t(T0),
                                     torch.as_tensor(KK)).numpy()
    assert np.isnan(ref).any() and np.isfinite(ref).any()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    ok = np.isfinite(ref)
    np.testing.assert_allclose(out[ok], ref[ok], rtol=1e-12, atol=0)


@pytest.mark.parametrize("restart", [20, 3])
def test_gmres_matches_reference(restart):
    """The port's GMRES against jax.scipy.sparse.linalg.gmres as the
    reference's Newton-Krylov corrector calls it (tol = atol = 0, two
    restarts) on a seeded 8x8 system, with the Krylov space the whole
    space (restart 20 -> 8) and with three vectors a restart."""
    import jax.scipy.sparse.linalg as jsla
    rng = np.random.default_rng(restart)
    A = rng.standard_normal((8, 8)) + 3.0 * np.eye(8)
    b = rng.standard_normal(8)
    ref, _ = jsla.gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                        restart=restart, maxiter=2, tol=0.0, atol=0.0)
    out = tint.gmres(lambda v: _t(A) @ v, _t(b), restart, 2)
    assert _relmax(out.numpy(), ref) <= 1e-12


def test_kernel_wrappers_refuse_bad_input():
    """Off the CPU the wrappers launch or raise: mixed devices, dtypes
    and oversize blocks are refused before any launch."""
    with pytest.raises(ValueError):
        thomas_cuda.thomas_solve(torch.zeros(3, 9, 9, device="meta"),
                                 torch.zeros(2, 9, 9, device="meta"),
                                 torch.zeros(3, 9, device="meta"))
    with pytest.raises(ValueError):
        gj_cuda.interior_factor(torch.zeros(2, 4, 4, device="meta"),
                                torch.zeros(2, 4, 2, device="meta"))


# -- the general-NLP path and the KKT oracles (layer level) -----------------------

from hqp_tpu.docp.nlp import Nlp as JNlp  # noqa: E402
from hqp_tpu.models import nlp_gen as JG  # noqa: E402
from hqp_tpu.models import nlp_suite as JN  # noqa: E402
from hqp_tpu.models.did import PrgDID as JPrgDID  # noqa: E402
from hqp_tpu.qp import kkt as jkkt  # noqa: E402
from hqp_tpu.qp.program import DenseIneq as JDenseIneq  # noqa: E402
from hqp_tpu.qp.program import DenseQP as JDenseQP  # noqa: E402
from hqp_tpu.qp.program import IneqGroups as JIneqGroups  # noqa: E402
from hqp_tpu.qp import mehrotra as jip  # noqa: E402
from hqp_tpu.sqp.solver import SqpError as JSqpError  # noqa: E402
from hqp_tpu.sqp import hessian as jhess  # noqa: E402
from hqp_tpu.utils.diagnostics import est_y as jest_y  # noqa: E402
from tests.test_kkt import random_rhs, random_stage_qp, random_zw  # noqa

from hqp_tpu_torch import convert  # noqa: E402
from hqp_tpu_torch.models import nlp_gen as TG  # noqa: E402
from hqp_tpu_torch.models import nlp_suite as TN  # noqa: E402
from hqp_tpu_torch.models.did import PrgDID  # noqa: E402
from hqp_tpu_torch.qp import kkt as tkkt  # noqa: E402
from hqp_tpu_torch.qp.program import DenseIneq  # noqa: E402
from hqp_tpu_torch.sqp import hessian as thess  # noqa: E402
from hqp_tpu_torch.sqp.solver import SqpError  # noqa: E402
from hqp_tpu_torch.utils.diagnostics import est_y  # noqa: E402
from hqp_tpu_torch.utils.registry import modules  # noqa: E402

CPU = "cpu"
_G = ("bl", "bu", "gl", "gu")


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _rel(out, ref, tol):
    """max |out - ref| <= tol * max(|ref|, 1) over the whole array."""
    o, r = _np(out), _np(ref)
    assert o.shape == r.shape, (o.shape, r.shape)
    if r.size:
        np.testing.assert_allclose(o, r, rtol=0,
                                   atol=tol * max(np.abs(r).max(), 1.0))


def _tree_rel(out, ref, tol):
    """_rel leaf by leaf over dicts and dataclasses of arrays."""
    if isinstance(ref, dict):
        assert sorted(out) == sorted(ref)
        for k in ref:
            _tree_rel(out[k], ref[k], tol)
    elif hasattr(ref, "__dataclass_fields__"):
        for k in ref.__dataclass_fields__:
            _tree_rel(getattr(out, k), getattr(ref, k), tol)
    else:
        _rel(out, ref, tol)


def _random_dense_qp(n, me, mi, seed):
    """A seeded DenseQP (SPD Q, one padded row in each nonempty group) in
    both packages."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    arrs = dict(Q=M @ M.T + n * np.eye(n), c=rng.standard_normal(n),
                A=rng.standard_normal((me, n)), b=rng.standard_normal(me),
                C=rng.standard_normal((mi, n)), d=1.0 + rng.random(mi),
                eq_mask_=np.arange(me) != me - 1,
                ineq_mask_=np.arange(mi) != 1)
    return (JDenseQP(**{k: jnp.asarray(a) for k, a in arrs.items()}),
            convert.dense_qp(type("Q", (), arrs), CPU))


def _dense_zw_rhs(n, me, mi, seed):
    rng = np.random.default_rng(seed)
    z, w = 0.5 + rng.random(mi), 0.5 + rng.random(mi)
    r = (rng.standard_normal(n), rng.standard_normal(me),
         rng.standard_normal(mi), rng.standard_normal(mi))
    jz, jw, jm = (JDenseIneq(g=jnp.asarray(a)) for a in
                  (z, w, np.arange(mi) != 1))
    tz, tw, tm = (DenseIneq(g=convert.tensor(a, CPU)) for a in
                  (z, w, np.arange(mi) != 1))
    jr = (jnp.asarray(r[0]), jnp.asarray(r[1]), JDenseIneq(
        g=jnp.asarray(r[2])), JDenseIneq(g=jnp.asarray(r[3])))
    tr = (convert.tensor(r[0], CPU), convert.tensor(r[1], CPU),
          DenseIneq(g=convert.tensor(r[2], CPU)),
          DenseIneq(g=convert.tensor(r[3], CPU)))
    return (jz, jw, jm, *jr), (tz, tw, tm, *tr)


@pytest.mark.parametrize("n,me,mi", [(6, 2, 5), (9, 0, 4), (5, 3, 0)])
def test_dense_qp_matches_reference(n, me, mi):
    """Every DenseQP method at 1e-14 relative (padded rows included)."""
    jqp, tqp = _random_dense_qp(n, me, mi, seed=n + me + mi)
    rng = np.random.default_rng(1)
    x, y, z = (rng.standard_normal(k) for k in (n, me, mi))
    jx, jy, jz = (jnp.asarray(a) for a in (x, y, z))
    tx, ty, tz = (convert.tensor(a, CPU) for a in (x, y, z))
    for name, ja, ta in (
            ("matvec_Q", (jx,), (tx,)), ("eval_eq", (jx,), (tx,)),
            ("matvec_eqT", (jy,), (ty,)), ("matvec_ineq", (jx,), (tx,)),
            ("matvec_ineqT", (JDenseIneq(g=jz),), (DenseIneq(g=tz),)),
            ("eval_ineq", (jx,), (tx,)), ("ineq_offsets", (), ()),
            ("eq_offsets", (), ()), ("norm_data", (), ()),
            ("zero_x", (), ()), ("x_mask", (), ()), ("eq_mask", (), ()),
            ("ineq_mask", (), ())):
        _tree_rel(getattr(tqp, name)(*ta), getattr(jqp, name)(*ja), 1e-14)
    b = JDenseQP.build(jqp.Q, jqp.c, A=jqp.A, C=jqp.C)
    tb = type(tqp).build(tqp.Q, tqp.c, A=tqp.A, C=tqp.C)
    for k in ("A", "b", "C", "d", "eq_mask_", "ineq_mask_"):
        _rel(getattr(tb, k), getattr(b, k), 0.0)


def _did60_kkt():
    """DID-60's first QP at Q = 1e-2 I (bench.py's build_kkt) with seeded
    barrier data and right-hand side, in both packages."""
    prg = JPrgDID(kmax=60)
    _, qp = prg.make_qp(prg.setup(), Q=jnp.tile(jnp.eye(3) * 1e-2,
                                                 (61, 1, 1)))
    return qp


def _stage_kkt_pair(case):
    qp = _did60_kkt() if case == "DID-60" else random_stage_qp(*case)
    z, w, mask = random_zw(qp, seed=1)
    r = random_rhs(qp, seed=2)
    port = (convert.stage_qp(qp, CPU), convert.ineq(z, CPU),
            convert.ineq(w, CPU), convert.ineq(mask, CPU),
            convert.tensor(r[0], CPU), convert.eq(r[1], CPU),
            convert.ineq(r[2], CPU), convert.ineq(r[3], CPU))
    return (qp, z, w, mask, *r), port


@pytest.mark.parametrize("backend", ["Riccati", "FullKKT"])
@pytest.mark.parametrize("case", [(7, 3, 2, 2), (1, 2, 1, 1), (12, 4, 1, 0),
                                  "DID-60"])
def test_stage_oracles_match_reference(backend, case):
    """RiccatiKKT and FullStageKKT factor + solve against the reference
    backends on the same system: every direction at 1e-10 relative, and
    the port's KKT residual at the refinement tolerance."""
    jargs, targs = _stage_kkt_pair(case)
    jb = {"Riccati": jkkt.RiccatiKKT, "FullKKT": jkkt.FullStageKKT}[backend]()
    tb = modules.create("qp_mat_solver", backend)

    def jsolve(qp, z, w, mask, *r):
        return jb.solve(jb.factor(qp, z, w, mask), qp, z, w, mask, *r)

    ref = jax.jit(jsolve)(*jargs)
    tqp, tz, tw, tm, *tr = targs
    out = tb.solve(tb.factor(tqp, tz, tw, tm), tqp, tz, tw, tm, *tr)
    for o, r in zip(out, ref):
        _tree_rel(o, r, 1e-10)
    *_, res = tkkt.kkt_residual(tqp, tz, tw, tm, *tr, *out)
    scale = float(tkkt.rhs_scale(tqp, tm, *tr))
    assert float(res) <= 1e-8 * max(scale, 1.0), float(res)


def test_riccati_validate_refuses_absent_states():
    """The sequential recursion cannot represent a structurally absent
    state at k >= 1; validate() says so, and passes DID's layout."""
    qp = convert.stage_qp(random_stage_qp(4, 2, 1, 1), CPU)
    tkkt.RiccatiKKT().validate(qp)
    qp.var_mask[2, 0] = False
    with pytest.raises(ValueError):
        tkkt.RiccatiKKT().validate(qp)


@pytest.mark.parametrize("case", [(24, 14, 22), (5, 1, 8), (9, 0, 6),
                                  "HS99"])
def test_dense_kkt_matches_reference(case):
    """DenseKKT factor + solve against the reference backend at 1e-10
    relative: random dense QPs at the (n, me, mi) of the stage shapes
    above lowered, and HS99's first QP (Q repaired as HL.init does)."""
    if case == "HS99":
        jp, tp = JN.PrgHS99(), TN.PrgHS99(device=CPU)
        _, jqp = jp.make_qp(jp.setup(), Q=10.0 * jnp.eye(7))
        tqp = convert.dense_qp(jqp, CPU)
        n, me, mi = jqp.n, jqp.me, jqp.mi
    else:
        n, me, mi = case
        jqp, tqp = _random_dense_qp(n, me, mi, seed=n)
    jr, tr = _dense_zw_rhs(n, me, mi, seed=3)
    jb, tb = jkkt.DenseKKT(), tkkt.DenseKKT()

    def jsolve(qp, z, w, mask, *r):
        return jb.solve(jb.factor(qp, z, w, mask), qp, z, w, mask, *r)

    ref = jax.jit(jsolve)(jqp, *jr)
    out = tb.solve(tb.factor(tqp, *tr[:3]), tqp, *tr)
    for o, r in zip(out, ref):
        _tree_rel(o, r, 1e-10)
    *_, res = tkkt.kkt_residual(tqp, *tr, *out)
    assert float(res) <= 1e-9 * max(float(tkkt.rhs_scale(tqp, tr[2],
                                                          *tr[3:])), 1.0)


@pytest.mark.parametrize("kind", ["stage", "dense"])
def test_est_y_matches_reference(kind):
    """Least-squares multipliers (40 CG steps) at 1e-12 relative, on a
    StageQP with dynamics and fixed-variable rows and on a DenseQP with
    well-conditioned rows.  (On a QP whose J J' has a condition number
    of 50 the two packages part at 1e-9 after 30 steps: CG amplifies the
    last bits of its inner products, summed in another order in each.)"""
    if kind == "stage":
        jqp = random_stage_qp(7, 3, 2, 2)
        lb, ub = np.array(jqp.lb), np.array(jqp.ub)
        lb[3, 1] = ub[3, 1] = 0.5
        lb[5, 0] = ub[5, 0] = -0.2
        jqp = dataclasses.replace(jqp, lb=jnp.asarray(lb),
                                  ub=jnp.asarray(ub))
        tqp = convert.stage_qp(jqp, CPU)
    else:
        jqp, tqp = _random_dense_qp(60, 20, 10, seed=4)
    _tree_rel(est_y(tqp), jest_y(jqp), 1e-12)


def _hela_pair(name):
    return (getattr(jhess, name)(), getattr(thess, name)())


@pytest.mark.parametrize("name", ["DScale", "Gerschgorin", "AugBFGS",
                                  "Gangster"])
def test_hela_matches_reference(name):
    """init (scale 1, program Q zero and nonzero) and two updates on
    seeded blocks at 1e-12; Gerschgorin updates from the exact Hessian
    of Catena (n = 7: nonlinear equality rows) once bound, and repairs
    the blocks before."""
    jp, tp = JG.PrgCatena(n=7), TG.PrgCatena(n=7, device=CPU)
    x = np.asarray(jp.setup()) + 0.05
    tp.setup()
    rng = np.random.default_rng(11)
    y, zg = rng.standard_normal(8), rng.random(0)
    jx, jy, jz = jnp.asarray(x), jnp.asarray(y), JDenseIneq(
        g=jnp.asarray(zg))
    tx, ty, tz = (convert.tensor(x, CPU), convert.tensor(y, CPU),
                  DenseIneq(g=convert.tensor(zg, CPU)))
    jh, th = _hela_pair(name)
    X = rng.standard_normal((1, 7, 7))
    Q = 0.5 * (X + X.transpose(0, 2, 1))
    for Q0 in (np.zeros((1, 7, 7)), Q):
        ref = jh.init(jp, jx, jy, jz, jnp.asarray(Q0))
        out = th.init(tp, tx, ty, tz, convert.tensor(Q0, CPU))
        _rel(out, ref, 1e-12)
    s = rng.standard_normal((1, 7))
    u = rng.standard_normal((1, 7))
    u[0, :3] = s[0, :3] * 2.0                    # some curvature pairs ok
    for alpha in (1.0, 0.5):
        ref = jh.update(ref, jnp.asarray(s), jnp.asarray(u), alpha)
        out = th.update(out, convert.tensor(s, CPU), convert.tensor(u, CPU),
                        alpha)
        _rel(out, ref, 1e-12)
        if name == "Gerschgorin":
            jh.bind(jp, jx, jy, jz)
            th.bind(tp, tx, ty, tz)


@pytest.mark.parametrize("scale", [0, 2, 3])
def test_hela_scale_modes_match_reference(scale):
    """HL.init's other scale modes and the least-squares multiplier
    flag, on the BFGS hela of both packages (Maratos, Q zero)."""
    jh = jhess.BFGS(scale=scale, init_multipliers=True)
    th = thess.BFGS(scale=scale, init_multipliers=True)
    assert th.init_multipliers
    jp, tp = JN.PrgMaratos(), TN.PrgMaratos(device=CPU)
    jx, tx = jp.setup(), tp.setup()
    jy, ty = jnp.asarray([0.3]), convert.tensor([0.3], CPU)
    jz, tz = JDenseIneq(g=jnp.zeros(0)), DenseIneq(g=tx.new_zeros(0))
    _rel(th.init(tp, tx, ty, tz, tx.new_zeros((1, 2, 2))),
         jh.init(jp, jx, jy, jz, jnp.zeros((1, 2, 2))), 1e-12)


@pytest.mark.parametrize("name", ["DID", "Crane"])
def test_docp_hess_blocks_matches_reference(name):
    """Docp.eval_hess_blocks (vmap of hessian over the stages) at 1e-10
    against the reference function called with y["dyn"] as y, the one
    call under which its code is right (ROADMAP Q3 R10).  For the crane
    (mc = 0) the reference also needs z's general groups at their true
    width 0: its padded masked-off row fails its zk @ c."""
    if name == "DID":
        jp, tp = JPrgDID(kmax=8), PrgDID(kmax=8, device=CPU)
    else:
        jp, tp = JPrgCrane(K=4), PrgCrane(K=4, device=CPU)
    v0 = np.asarray(jp.setup())
    tp.setup()
    rng = np.random.default_rng(5)
    v = v0 + 0.1 * rng.standard_normal(v0.shape)
    _, qp = jp.make_qp(jnp.asarray(v))
    mask = qp.ineq_mask()
    z = {g: rng.random(getattr(mask, g).shape) for g in _G}
    y = {"dyn": rng.standard_normal(qp.b.shape),
         "fix": rng.standard_normal(qp.c.shape)}
    zj = dict(z)
    if jp.mc == 0:
        zj["gl"] = zj["gu"] = np.zeros((v.shape[0], 0))
    ref = jp.eval_hess_blocks(jnp.asarray(v), jnp.asarray(y["dyn"]),
                              JIneqGroups(**{g: jnp.asarray(a)
                                             for g, a in zj.items()}))
    out = tp.eval_hess_blocks(convert.tensor(v, CPU), convert.eq(y, CPU),
                              convert.ineq(z, CPU))
    _rel(out, ref, 1e-10)


NLP_PROGRAMS = {
    "TP383": (JN.PrgTP383, TN.PrgTP383, {}),
    "Maratos": (JN.PrgMaratos, TN.PrgMaratos, {}),
    "HS99": (JN.PrgHS99, TN.PrgHS99, {}),
    "LQBlend": (JG.PrgLQBlend, TG.PrgLQBlend, {"n": 60}),
    "Broydn3d": (JG.PrgBroydn3d, TG.PrgBroydn3d, {"n": 40}),
    "Bdqrtic": (JG.PrgBdqrtic, TG.PrgBdqrtic, {"n": 40}),
    "Catena": (JG.PrgCatena, TG.PrgCatena, {"n": 40}),
    "SRosenbr": (JG.PrgSRosenbr, TG.PrgSRosenbr, {"n": 40}),
}


@pytest.mark.parametrize("name", sorted(NLP_PROGRAMS))
def test_nlp_program_matches_reference(name):
    """setup, make_qp, update_fbd_qp, eval_grd_L and eval_hess_blocks of
    each NLP program (the suite and every family at n <= 60) at a
    perturbed point, at 1e-12 relative."""
    jcls, tcls, kw = NLP_PROGRAMS[name]
    jp, tp = jcls(**kw), tcls(device=CPU, **kw)
    assert isinstance(jp, JNlp)
    x0 = np.asarray(jp.setup())
    _rel(tp.setup(), x0, 0.0)
    rng = np.random.default_rng(len(name))
    x = x0 * (1.0 + 0.05 * rng.random(x0.shape)) + 0.01
    jx, tx = jnp.asarray(x), convert.tensor(x, CPU)
    fj, qpj = jp.make_qp(jx)
    ft, qpt = tp.make_qp(tx)
    _rel(ft, fj, 1e-12)
    _tree_rel(qpt, qpj, 1e-12)
    x2 = x * 1.01
    fj, qpj = jp.update_fbd_qp(qpj, jx, jnp.asarray(x2))
    ft, qpt = tp.update_fbd_qp(qpt, tx, convert.tensor(x2, CPU))
    _rel(ft, fj, 1e-12)
    _tree_rel(qpt, qpj, 1e-12)
    y, zg = rng.standard_normal(qpj.me), rng.random(qpj.mi)
    jy, jz = jnp.asarray(y), JDenseIneq(g=jnp.asarray(zg))
    ty, tz = convert.tensor(y, CPU), DenseIneq(g=convert.tensor(zg, CPU))
    _rel(tp.eval_grd_L(tx, ty, tz), jp.eval_grd_L(jx, jy, jz), 1e-12)
    _rel(tp.eval_hess_blocks(tx, ty, tz), jp.eval_hess_blocks(jx, jy, jz),
         1e-12)


def family_reference(name, n):
    """The reference's side of test_families_match_reference: {res, f,
    iter, qp_iters_total}."""
    from hqp_tpu.utils.registry import modules as jmodules
    import hqp_tpu.sqp.hessian  # noqa: F401
    js = JSqpPowell(JG.FAMILIES[name](n=n), max_iters=200, eps=1e-6,
                    qp_solver=jip.Mehrotra(eps=1e-9, max_iters=60),
                    kkt_backend=jkkt.DenseKKT(),
                    hela=jmodules.create("sqp_hela", JG.FAMILY_HELA[name]))
    js.init()
    try:
        jres = js.solve()
    except JSqpError as e:
        jres = e.reason
    return dict(res=jres, f=None if js.f is None else float(js.f),
                iter=js.iter, qp_iters_total=js.qp_iters_total)


# -- the scenario batch: presolve, batched KKT, draws (BASELINE config 5) ----------

from hqp_tpu.parallel import scenarios as jscen  # noqa: E402
from hqp_tpu.qp import presolve as jpre  # noqa: E402
from hqp_tpu.qp.kkt_partitioned import PartitionedKKT as JPartKKT  # noqa

import chip_smoke  # noqa: E402
from hqp_tpu_torch.parallel import scenarios as tscen  # noqa: E402
from hqp_tpu_torch.qp import presolve as tpre  # noqa: E402
from hqp_tpu_torch.qp.kkt_partitioned import PartitionedKKT  # noqa: E402
from hqp_tpu_torch.qp.mehrotra import Mehrotra  # noqa: E402

#: checksum of the port's 256 draws of config 5 (seed 0): the noise's sum
#: and absolute sum and three of its entries; chip_smoke.py phase 17
#: checks the card's draws against the same record
SCEN_CHECKSUM = (-0.29271950609446296, 37.495359228680115,
                 {(0, 0, 0): -0.002310411800234169,
                  (100, 30, 1): 0.00040663832132356315,
                  (255, 60, 2): 0.0012800506857305201})


def _did60_jax(n_draws=None):
    """The JAX package's DID-60, its iterate, Q = 1e-2 I and (with
    ``n_draws``) the first draws of its config-5 batch."""
    prg = JPrgDID(kmax=60)
    v0 = prg.setup()
    Q = jnp.tile(jnp.eye(prg.nv) * 1e-2, (prg.K + 1, 1, 1))
    draws = None if n_draws is None else \
        jscen.batched_qp(prg, v0, 256, scale=1e-3)[:n_draws]
    return prg, v0, Q, draws


def _stack(trees):
    """JAX trees of one structure -> one tree of stacked numpy leaves."""
    return jax.tree_util.tree_map(
        lambda *a: np.stack([np.asarray(x) for x in a]), *trees)


def _presolve_case(qp, case):
    """The cases of tests/test_presolve.py:33-71 on a JAX StageQP: (QP,
    tau)."""
    if case == "parallel":     # the DID path row, tau-parallel to e_x1
        return qp, 0.02
    if case == "wide":         # an off-axis coefficient: the row stays
        return dataclasses.replace(qp, C=qp.C.at[:, 0, 0].set(0.5)), 0.02
    if case == "duplicate":    # an exact copy of the box row e_x1
        return dataclasses.replace(
            qp, C=jnp.zeros_like(qp.C).at[:, 0, 1].set(1.0)), 1e-12
    # a negative-coefficient row with a lower bound on x0
    return dataclasses.replace(
        qp, C=jnp.zeros_like(qp.C).at[:, 0, 0].set(-1.0),
        d_lo=jnp.full_like(qp.d_lo, -0.02),
        d_up=jnp.full_like(qp.d_up, jnp.inf)), 1e-9


@pytest.mark.parametrize("case", ["parallel", "wide", "duplicate",
                                  "negative"])
def test_presolve_matches_reference(case):
    """merge_parallel_rows on the cases of tests/test_presolve.py, alone
    and as a batch of three (the case at the iterate of DID-60 and at two
    draws of config 5): bounds and rhs equal to the JAX package's exactly,
    original_row_violation at a random x within 1e-15."""
    prg, v0, Q, draws = _did60_jax(2)
    jqps, taus = zip(*(_presolve_case(prg.make_qp(v, Q=Q)[1], case)
                       for v in (v0, draws[0], draws[1])))
    tau = taus[0]
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((3,) + v0.shape)
    jout = [jpre.merge_parallel_rows(q, tau) for q in jqps]
    jviol = [float(jpre.original_row_violation(q, jnp.asarray(x)))
             for q, x in zip(jqps, xs)]
    tout = [tpre.merge_parallel_rows(convert.stage_qp(q, CPU), tau)
            for q in jqps]
    tb = convert.stage_qp(_stack(jqps), CPU)
    assert tb.nb == 1 and tb.batch_shape == (3,)
    tbo = tpre.merge_parallel_rows(tb, tau)
    tviol = tpre.original_row_violation(tb, _t(xs))
    assert tviol.shape == (3,)
    for b in range(3):
        for name in ("lb", "ub", "d_lo", "d_up"):
            ref = np.asarray(getattr(jout[b], name))
            np.testing.assert_array_equal(getattr(tout[b], name).numpy(),
                                          ref)
            np.testing.assert_array_equal(getattr(tbo, name)[b].numpy(),
                                          ref)
        one = tpre.original_row_violation(convert.stage_qp(jqps[b], CPU),
                                          _t(xs[b]))
        np.testing.assert_allclose(float(one), jviol[b], rtol=0, atol=1e-15)
        np.testing.assert_allclose(float(tviol[b]), jviol[b], rtol=0,
                                   atol=1e-15)
    merged = np.isfinite(tbo.d_up.numpy()) & tbo.con_mask.numpy()
    assert merged.any() == (case == "wide")


def test_partitioned_kkt_batch_matches_unbatched():
    """PartitionedKKT(L=20) factor+solve on a batch of three presolved
    DID-60 QPs of config 5 (the JAX package's vmapped make_qp and presolve
    at its draws 0, 22 and 144, converted as one batched StageQP), with
    random barrier data and right-hand sides: each problem's solution
    equal to the port's unbatched solve of it within 1e-12 and to the JAX
    package's within 1e-10 (both refine to 1e-10).  The batched StageQP
    equals the port's own make_qp_batch + presolve at the same iterates
    within 1e-12."""
    prg, v0, Q, draws = _did60_jax(145)
    draws = draws[np.array([0, 22, 144])]
    jqpb = jax.jit(jax.vmap(lambda v: jpre.merge_parallel_rows(
        prg.make_qp(v, Q=Q)[1], 0.02)))(draws)
    jqps = [jax.tree_util.tree_map(lambda a, b=b: a[b], jqpb)
            for b in range(3)]
    data = [(*random_zw(q, seed=b)[:2], *random_rhs(q, seed=10 + b))
            for b, q in enumerate(jqps)]
    mask = jqps[0].ineq_mask()

    def port(qp, d):
        z, w, r1, r2, r3, r4 = d
        return (qp, convert.ineq(z, CPU), convert.ineq(w, CPU),
                qp.ineq_mask(), _t(r1), convert.eq(r2, CPU),
                convert.ineq(r3, CPU), convert.ineq(r4, CPU))

    def solve(be, qp, z, w, m, *r):
        return be.solve(be.factor(qp, z, w, m), qp, z, w, m, *r)

    tqpb = convert.stage_qp(jqpb, CPU)
    tprg = PrgDID(kmax=60, device=CPU)
    tprg.setup()
    _, own = tprg.make_qp_batch(_t(draws), _t(np.broadcast_to(
        np.asarray(Q), (3,) + Q.shape)))
    own = tpre.merge_parallel_rows(own, 0.02)
    for name in ("Q", "c", "A", "b", "lb", "ub", "C", "d_lo", "d_up"):
        np.testing.assert_allclose(getattr(own, name).numpy(),
                                   getattr(tqpb, name).numpy(), rtol=1e-12,
                                   atol=1e-12)
    be = PartitionedKKT(L=20)
    outb = solve(be, *port(tqpb, _stack(data)))
    jfn = jax.jit(lambda q, z, w, *r: solve(JPartKKT(L=20), q, z, w, mask,
                                             *r))
    for b in range(3):
        one = solve(be, *port(convert.stage_qp(jqps[b], CPU), data[b]))
        ref = jfn(jqps[b], *data[b])
        for tb_, t1, rj in zip(_sol_leaves(outb), _sol_leaves(one),
                               _sol_leaves(ref)):
            np.testing.assert_allclose(tb_[b].numpy(), t1.numpy(),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(tb_[b].numpy(), np.asarray(rj),
                                       rtol=1e-10, atol=1e-10)


def _sol_leaves(sol):
    """The leaves of a (dx, dy, dz, dw) solution of either package, in one
    order: dx, dy by key, dz and dw by group."""
    dx, dy, dz, dw = sol
    return [dx, *(dy[k] for k in sorted(dy)),
            *(getattr(dz, g) for g in _G), *(getattr(dw, g) for g in _G)]


def test_batched_qp_draws_and_checksum():
    """The port's draws of config 5 come from a CPU torch.Generator: the
    same seed (or generator) gives the same draws, another seed others,
    and the noise matches the checksum that chip_smoke.py phase 17 holds
    the card's draws to."""
    prg = PrgDID(kmax=60, device=CPU)
    v0 = prg.setup()
    a = tscen.batched_qp(prg, v0, 256, scale=1e-3, seed=0)
    b = tscen.batched_qp(prg, v0, 256, scale=1e-3,
                         generator=torch.Generator().manual_seed(0))
    c = tscen.batched_qp(prg, v0, 256, scale=1e-3, seed=1)
    assert a.shape == (256, 61, 3) and a.dtype == torch.float64
    assert torch.equal(a, b) and not torch.equal(a, c)
    noise = a - v0
    total, absum, entries = SCEN_CHECKSUM
    np.testing.assert_allclose(float(noise.sum()), total, rtol=0,
                               atol=1e-12 * absum)
    np.testing.assert_allclose(float(noise.abs().sum()), absum, rtol=1e-12)
    assert {k: float(noise[k]) for k in entries} == entries
    assert chip_smoke.SCEN_CHECKSUM == SCEN_CHECKSUM
    assert abs(float(noise.std()) - 1e-3) < 2e-5


@pytest.fixture
def card():
    """Skips a test where there is no CUDA card (decided here, never while
    the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("s,nb", chip_smoke.BATCH_CASES)
def test_gj_batch_route_on_card(card, s, nb):
    """K1's batched route on the card at s = 5, 48, 97, 98 and one to
    1,000 interiors, on interiors that pivot at every step, with a tie and
    a NaN column: Minv equal to the tile kernel's and the twin's to the
    last bit, W and Schur equal to the tile kernel's and within
    KERNEL_RTOL of the twin's, one launch in LAUNCHES and in
    LAUNCHES_BATCH.  This file imports the JAX package, which is not run
    on the card's host: chip_smoke.py phase 24 runs the same check there."""
    for dt in (torch.float64, torch.float32):
        chip_smoke.hold_batch_route(s, nb, dt, seed=s + nb)


def test_batched_qp_refuses_hot_start():
    """Hot starts stay unbatched: a batched QP given to hot_start, or to
    solve(hot=True), raises NotImplementedError."""
    prg = PrgDID(kmax=15, with_cns=False, device=CPU)
    vb = tscen.batched_qp(prg, prg.setup(), 2, scale=1e-4)
    _, qp = prg.make_qp_batch(vb)
    slv = Mehrotra(backend=PartitionedKKT(L=5))
    st = slv.init_state(qp)
    assert st.iter.shape == (2,) and st.phimin.shape == (2, 51)
    with pytest.raises(NotImplementedError):
        slv.hot_start(qp, st)
    with pytest.raises(NotImplementedError):
        slv.solve(qp, st, hot=True)


# -- the host-sparse slice: native kernels, KKT backends, SparseBFGS --------------

import scipy.sparse as sp  # noqa: E402
from hqp_tpu import native as jnative  # noqa: E402
from hqp_tpu.qp import kkt_sparse_host as jsh  # noqa: E402
from tests.test_native import random_quasidefinite  # noqa: E402
from tests.test_sparse_bfgs import SeparablePairs as JSeparablePairs  # noqa

from hqp_tpu_torch import native as tnative  # noqa: E402
from hqp_tpu_torch.qp import kkt_sparse_host as tsh  # noqa: E402


def _ring(n=200, seed=2):
    """tests/test_native.py's shuffled ring graph (with its diagonal)."""
    perm = np.random.default_rng(seed).permutation(n)
    rows, cols = [], []
    for i in range(n):
        j = (i + 1) % n
        rows += [perm[i], perm[j], perm[i]]
        cols += [perm[j], perm[i], perm[i]]
    K = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    K.sort_indices()
    return K


SPARSE_PATTERNS = {"qd50": lambda: random_quasidefinite(50, 20),
                   "qd300": lambda: random_quasidefinite(300, 100),
                   "ring": _ring}


@pytest.mark.parametrize("name", sorted(SPARSE_PATTERNS))
def test_rcm_order_matches_reference(name):
    """The port's build of the RCM ordering gives the reference's
    permutation on tests/test_native.py's patterns."""
    K = SPARSE_PATTERNS[name]()
    N = K.shape[0]
    np.testing.assert_array_equal(
        tnative.rcm_order(N, K.indptr, K.indices),
        jnative.rcm_order(N, K.indptr, K.indices))


@pytest.mark.parametrize("kind", ["LDL", "BKP"])
@pytest.mark.parametrize("name", ["qd50", "qd300"])
def test_sparse_factors_match_reference(kind, name):
    """SparseLDL and SparseBKP on the quasidefinite matrices of
    tests/test_native.py: the same solves (one and three right-hand
    sides) within 1e-12 relative, the same factor nnz, the same count of
    2x2 pivots; nothing floored or pinned."""
    K = SPARSE_PATTERNS[name]()
    N = K.shape[0]
    b = np.random.default_rng(1).standard_normal((N, 3))
    if kind == "LDL":
        jf = jnative.SparseLDL(N, K.indptr, K.indices).factor(K.data)
        tf = tnative.SparseLDL(N, K.indptr, K.indices).factor(K.data)
        assert tf.n_floored == 0
    else:
        jf = jnative.SparseBKP(N, K.indptr, K.indices, K.data)
        tf = tnative.SparseBKP(N, K.indptr, K.indices, K.data)
        assert tf.n_2x2 == jf.n_2x2 and tf.n_pinned == 0
    assert tf.nnz == jf.nnz
    for rhs in (b[:, 0], b):
        _rel(tf.solve(rhs), jf.solve(rhs), 1e-12)


def test_bkp_rank_one_pins_one_pivot():
    """[[1, 1], [1, 1]]: the BKP pins its zero second pivot to 1.0 in both
    packages (the same answer); the port reports that one pinned pivot,
    and the LDL' at reg = 1e-8 its one floored pivot."""
    K = sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 1.0]]))
    b = np.array([1.0, 0.0])
    jf = jnative.SparseBKP(2, K.indptr, K.indices, K.data)
    tf = tnative.SparseBKP(2, K.indptr, K.indices, K.data)
    np.testing.assert_array_equal(tf.solve(b), jf.solve(b))
    assert (tf.n_pinned, tf.n_2x2) == (1, 0)
    tl = tnative.SparseLDL(2, K.indptr, K.indices).factor(K.data, reg=1e-8)
    jl = jnative.SparseLDL(2, K.indptr, K.indices).factor(K.data, reg=1e-8)
    np.testing.assert_array_equal(tl.solve(b), jl.solve(b))
    assert tl.n_floored == 1


def test_native_refuses_bad_csr():
    """The binding checks what the C code would read through raw
    pointers: a row pointer of the wrong order, a column index outside the
    matrix, a value count other than the pattern's, a right-hand side of
    the wrong length all raise ValueError before any C call."""
    K = sp.csr_matrix(np.array([[2.0, 1.0], [1.0, 2.0]]))
    p, c, v = K.indptr, K.indices, K.data
    for call in (lambda: tnative.SparseLDL(3, p, c),
                 lambda: tnative.rcm_order(2, p, np.array([0, 5, 0, 1])),
                 lambda: tnative.SparseLDL(2, p, c).factor(v[:3]),
                 lambda: tnative.SparseBKP(2, p, c, v[:2]),
                 lambda: tnative.SparseBKP(2, p, c, v).solve(np.ones(3))):
        with pytest.raises(ValueError):
            call()


HOST_BACKENDS = ("SparseHostKKT", "SparseCallbackKKT", "FullSparseBKPKKT")


def _host_backend_solve(be, qp, z, w, mask, *r):
    return be.solve(be.factor(qp, z, w, mask), qp, z, w, mask, *r)


@pytest.mark.parametrize("backend", HOST_BACKENDS)
@pytest.mark.parametrize("n,me,mi", [(6, 2, 5), (9, 0, 4), (5, 3, 0)])
def test_host_sparse_backends_match_reference(backend, n, me, mi):
    """Each host-sparse backend factor + solve on the random DenseQPs of
    test_dense_qp_matches_reference (one padded row in each nonempty
    group) against the reference's backend: the same directions within
    1e-10 relative, with bytes counted each way."""
    jqp, tqp = _random_dense_qp(n, me, mi, seed=n + me + mi)
    jr, tr = _dense_zw_rhs(n, me, mi, seed=3)
    ref = _host_backend_solve(getattr(jsh, backend)(), jqp, *jr)
    be = getattr(tsh, backend)()
    out = _host_backend_solve(be, tqp, *tr)
    for o, r in zip(out, ref):
        _tree_rel(o, r, 1e-10)
    assert be.moved["d2h"] > 0 and be.moved["h2d"] > 0


@pytest.mark.parametrize("backend", HOST_BACKENDS)
def test_host_sparse_factor_repins_another_qp(backend):
    """A backend prepared with one QP and handed another factors the
    other (its matrices are pinned anew): the same directions as the
    reference's backend on the second QP within 1e-10 relative."""
    _, tqp1 = _random_dense_qp(9, 3, 6, seed=1)
    jqp2, tqp2 = _random_dense_qp(9, 3, 6, seed=2)
    jr, tr = _dense_zw_rhs(9, 3, 6, seed=4)
    be = getattr(tsh, backend)()
    be.prepare(tqp1)
    out = _host_backend_solve(be, tqp2, *tr)
    ref = _host_backend_solve(getattr(jsh, backend)(), jqp2, *jr)
    for o, r in zip(out, ref):
        _tree_rel(o, r, 1e-10)


def test_sparse_bfgs_matches_reference():
    """SparseBFGS bound to SeparablePairs at x = 0.5: the same RCM order
    and blocks as the reference's; then one update of a seeded SPD Q
    (every entry nonzero) within 1e-12 relative, and a stage layout
    [4, 3, 3] delegated to the batched BFGS alike."""
    x = np.full(8, 0.5)
    jh, th = jhess.SparseBFGS(), thess.SparseBFGS()
    jp, tp = JSeparablePairs(), chip_smoke.separable_pairs(CPU)
    jp.setup()
    tp.setup()
    jh.bind(jp, jnp.asarray(x), jnp.zeros(0), JDenseIneq(g=jnp.zeros(0)))
    t0 = convert.tensor(np.zeros(0), CPU)
    th.bind(tp, convert.tensor(x, CPU), t0, DenseIneq(g=t0))
    np.testing.assert_array_equal(_np(th._perm), jh._perm)
    assert th._blocks == jh._blocks == [(0, 2), (2, 2), (4, 2), (6, 2)]
    rng = np.random.default_rng(7)
    for B, nb in ((1, 8), (4, 3)):
        M = rng.standard_normal((B, nb, nb))
        Q = M @ np.swapaxes(M, -1, -2) + nb * np.eye(nb)
        s_, u = rng.standard_normal((B, nb)), rng.standard_normal((B, nb))
        ref = jh.update(jnp.asarray(Q), jnp.asarray(s_), jnp.asarray(u), 0.7)
        out = th.update(*(convert.tensor(v, CPU) for v in (Q, s_, u)), 0.7)
        _rel(out, ref, 1e-12)


def test_solve_generated_lqblend_matches_reference():
    """solve_generated("lqblend", n=200, eps=1e-8), the case of
    tests/test_nlp_large.py, in both packages (SparseCallbackKKT shared
    across calls): the same verdict, SQP and IP counts, f within 1e-9
    relative."""
    ref = JG.solve_generated("lqblend", n=200, eps=1e-8)
    out = TG.solve_generated("lqblend", n=200, eps=1e-8, device=CPU)
    assert out["result"] == ref["result"] == "optimal"
    assert (out["sqp_iters"], out["qp_iters_total"]) == \
        (ref["sqp_iters"], ref["qp_iters_total"])
    np.testing.assert_allclose(out["obj"], ref["obj"], rtol=1e-9,
                               atol=1e-15)
    assert isinstance(TG.generated_solver("lqblend", n=20, device=CPU)
                      ._kkt_backend, tsh.SparseCallbackKKT)


# -- the user-model slice: hosted models, the hxi build, plt files, estimations ---

import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

from hqp_tpu.hxi import fmu as jfmu  # noqa: E402
from hqp_tpu.hxi.sfunction import SFunction as JSFunction  # noqa: E402
from hqp_tpu.hxi.sfunction import demo_sfunction_path as jdemo_path  # noqa
from hqp_tpu.hxi.simstruct import PySFunctionHost as JPySFunctionHost  # noqa
from hqp_tpu.models import hxi_suite as JH  # noqa: E402
from hqp_tpu.omu import plt_io as jplt  # noqa: E402
from hqp_tpu.omu.hosted import HostedModel as JHostedModel  # noqa: E402
from tests.test_hxi import _PyDic  # noqa: E402
from tests.test_torch_sqp import check_user_solve  # noqa: E402

from hqp_tpu_torch.hxi import fmu as tfmu  # noqa: E402
from hqp_tpu_torch.hxi import sfunction as tsfun  # noqa: E402
from hqp_tpu_torch.hxi.simstruct import PySFunctionHost  # noqa: E402
from hqp_tpu_torch.models import hxi_suite as TH  # noqa: E402
from hqp_tpu_torch.omu import plt_io as tplt  # noqa: E402
from hqp_tpu_torch.omu.hosted import HostedModel  # noqa: E402
from hqp_tpu_torch.utils import sync  # noqa: E402


def _evaluators(kind):
    """(JAX evaluator, port evaluator) of one hosted model kind."""
    if kind in ("sfun_dic", "sfun_did"):
        par = [[2.0]] if kind == "sfun_dic" else [[0.1]]
        return (JSFunction(jdemo_path(kind), params=par),
                tsfun.SFunction(tsfun.demo_sfunction_path(kind), params=par))
    if kind == "python":
        return (JPySFunctionHost(_PyDic(), params=[[2.0]]),
                PySFunctionHost(_PyDic(), params=[[2.0]]))
    return (jfmu.Fmu(jfmu.build_test_fmu(), params={"m": 4.0}),
            tfmu.Fmu(tfmu.build_test_fmu(), params={"m": 4.0}))


@pytest.mark.parametrize("kind", ["sfun_dic", "sfun_did", "fmu", "python"])
def test_hosted_model_matches_reference(kind):
    """HostedModel's values and vmap(jacfwd) Jacobians over a batch of 7
    stages equal the reference's to the last bit (the same C calls, the
    same finite differences or the FMU's analytic Jacobian), for the state
    map (ode or dt_update) and the outputs; the batched call equals calls
    made stage by stage; each batch crosses to the host in one counted
    read, and its bytes are counted each way."""
    jev, tev = _evaluators(kind)
    jm, tm = JHostedModel(jev), HostedModel(tev)
    assert (tm.nx, tm.nu, tm.ny, tm.discrete) == \
        (jm.nx, jm.nu, jm.ny, jm.discrete)
    rng = np.random.default_rng(11)
    K, nx, nu = 7, tm.nx, tm.nu
    T, X, U = (rng.standard_normal(s) for s in ((K,), (K, nx), (K, nu)))
    step = "dt_update" if tm.discrete else "ode"
    for fn in (step, "outputs"):
        def jf(t, x, u):
            return getattr(jm, fn)(t, x, u, ())

        def tf(t, x, u):
            return getattr(tm, fn)(t, x, u, ())

        ja = [jnp.asarray(a) for a in (T, X, U)]
        ta = [torch.as_tensor(a) for a in (T, X, U)]
        jval = jax.vmap(jf)(*ja)
        jjac = jax.vmap(jax.jacfwd(jf, argnums=(1, 2)))(*ja)
        sync.COUNT, moved = 0, dict(tm.moved)
        tval = torch.func.vmap(tf)(*ta)
        assert sync.COUNT == 1
        assert tm.moved["d2h"] - moved["d2h"] == K * (1 + nx + nu) * 8
        assert tm.moved["h2d"] - moved["h2d"] == tval.numel() * 8
        sync.COUNT = 0
        tjac = torch.func.vmap(torch.func.jacfwd(tf, argnums=(1, 2)))(*ta)
        assert sync.COUNT == 2            # one value batch, one Jacobian batch
        np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
        for o, r in zip(tjac, jjac):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        # stage by stage, in reverse order: the same bits
        for k in reversed(range(K)):
            np.testing.assert_array_equal(
                tf(*(a[k] for a in ta)).numpy(), tval[k].numpy())
            for o, r in zip(torch.func.jacfwd(tf, argnums=(1, 2))(
                    *(a[k] for a in ta)), tjac):
                np.testing.assert_array_equal(o.numpy(), r[k].numpy())


def test_hosted_second_derivative_raises():
    """An exact Hessian through a hosted model (Docp.eval_hess_blocks,
    the Gerschgorin hela's input) raises in both packages: the reference
    with "Pure callbacks do not support JVP", the port naming the hosted
    model; neither returns zeros."""
    jp, tp = JH.PrgDICSFunction(K=3), TH.PrgDICSFunction(K=3, device=CPU)
    v = np.asarray(jp.setup())
    tp.setup()
    rng = np.random.default_rng(2)
    y = rng.standard_normal((3, 2))
    z = {g: rng.random(v.shape) for g in ("bl", "bu")}
    z["gl"] = z["gu"] = np.zeros((4, 1))
    zj = dict(z, gl=np.zeros((4, 0)), gu=np.zeros((4, 0)))
    with pytest.raises(ValueError, match="Pure callbacks do not support"):
        jp.eval_hess_blocks(jnp.asarray(v), jnp.asarray(y),
                            JIneqGroups(**{g: jnp.asarray(a)
                                           for g, a in zj.items()}))
    with pytest.raises(RuntimeError, match="hosted model 'sfun_dic'"):
        tp.eval_hess_blocks(convert.tensor(v, CPU), {"dyn": _t(y)},
                            convert.ineq(z, CPU))


def _tree_listing(root):
    """(size, mtime) of each file under root, but the interpreter's
    __pycache__ and the shared libraries the JAX package itself rebuilds
    next to their sources when stale (hqp_tpu/hxi/sfunction.py:57-71), which
    a test worker running beside this one may do (the port's own writes,
    shared libraries included, are audited by _BUILD_PROBE)."""
    out = {}
    for d, _, files in os.walk(root):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            if not p.endswith(".so"):
                out[p] = (os.path.getsize(p), os.path.getmtime(p))
    return out


#: run in a fresh interpreter that imports only the port: points the hxi
#: build root at a new directory (argv[1]), so that every build happens,
#: then records through an audit hook every path the process opens for
#: writing, creates, renames, links, removes or changes mode of, and the
#: output (-o) of every compiler it starts, while it builds both demo
#: S-functions, the test FMU, the MEX demo both ways (cg_sfun and MEX) and
#: the MEX host library, builds one again, loads the FMU and both MEX demo
#: builds and runs a failing compile; prints one JSON object
_BUILD_PROBE = r"""
import json, os, sys
from hqp_tpu_torch.hxi import fmu, sfunction
default = sfunction.BUILD_ROOT
sfunction.BUILD_ROOT = fmu.BUILD_ROOT = sys.argv[1]
WRITE = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND | os.O_TRUNC
PATHS = ("os.link", "os.symlink", "os.truncate", "shutil.rmtree",
         "shutil.move", "shutil.copyfile")
writes, cc_out = [], []


def where(path, dir_fd=-1):
    # path, resolved against dir_fd (shutil.rmtree removes by dir_fd)
    path = os.fsdecode(path)
    if isinstance(dir_fd, int) and dir_fd >= 0 and not os.path.isabs(path):
        path = os.path.join(os.readlink(f"/proc/self/fd/{dir_fd}"), path)
    return path


def hook(event, args):
    if event == "open":
        path, mode, flags = args
        if isinstance(path, (str, bytes)) and (
                any(c in mode for c in "wax+") if mode else flags & WRITE):
            writes.append(where(path))
    elif event in ("os.rename", "os.replace"):
        writes.extend([where(args[0], args[2]), where(args[1], args[3])])
    elif event in ("os.remove", "os.rmdir"):
        writes.append(where(*args[:2]))
    elif event in ("os.mkdir", "os.chmod"):
        if isinstance(args[0], (str, bytes)):
            writes.append(where(args[0], args[2]))
    elif event in PATHS:
        writes.extend(where(a) for a in args[:2]
                      if isinstance(a, (str, bytes)))
    elif event == "subprocess.Popen":
        argv = [os.fsdecode(a) for a in args[1]]
        if "-o" in argv:
            cc_out.append(argv[argv.index("-o") + 1])


sys.addaudithook(hook)
from hqp_tpu_torch.hxi import mex, simulink
paths = [sfunction.demo_sfunction_path(n) for n in ("sfun_did", "sfun_dic")]
paths.append(fmu.build_test_fmu())
demo = os.path.join(simulink.SIMULINK_DIR, "sfun_did_demo.c")
paths += [simulink.build_sfunction(demo), mex.build_mex_sfunction(demo)]
mex._host_lib()
paths.append(sfunction.INFO["libhximexhost.so"]["path"])
built = [sfunction.INFO[os.path.basename(p)]["built"] for p in paths]
again = sfunction.demo_sfunction_path("sfun_did")
hit = sfunction.INFO["sfun_did.so"]["built"]
f = fmu.Fmu(paths[2])
ev = mex.MexEvaluator(paths[4], args="[0.1]")
cg = simulink.SimulinkSFunction(paths[3], params=[0.1])
try:
    sfunction.run_cc(["cc", "-x", "c", "-", "-o", os.devnull])
    failed = ""
except RuntimeError as e:
    failed = str(e)
print(json.dumps(dict(
    default=default, paths=paths, built=built, again=again, hit=hit,
    fmu_dir=f._dir, failed=failed, writes=writes, cc_out=cc_out,
    jax=sorted(m for m in sys.modules
               if m.split(".")[0] in ("jax", "hqp_tpu")))))
"""


def test_hxi_build_writes_only_under_build():
    """The S-functions and the test FMU are compiled from the port's own
    sources (csrc/hxi) into build/hqp_tpu_torch_hxi/<hash>/, keyed by a
    hash of sources and flags, and each loaded FMU is unpacked there too.
    In a fresh interpreter that imports only the port and builds everything
    anew (_BUILD_PROBE), every file it writes, creates, renames or removes,
    shared libraries included, and every compiler output lies under its
    build root, which by default lies under build/; a rebuild of the same
    source is a cache hit and a failed compile raises.  The same holds for
    the demo S-function of the Simulink-coder and MEX hosts, built both
    ways, and the MEX host library (csrc/hxi_simulink).  Nothing under
    native/ or hqp_tpu/ changes."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    build_dir = os.path.join(root, "build")
    os.makedirs(build_dir, exist_ok=True)
    before = {d: _tree_listing(os.path.join(root, d))
              for d in ("native", "hqp_tpu")}
    fresh = tempfile.mkdtemp(prefix="hxi_probe_", dir=build_dir)
    try:
        proc = subprocess.run(
            [sys.executable, "-B", "-c", _BUILD_PROBE, fresh], cwd=root,
            env=dict(os.environ, PYTHONPATH=root), stdin=subprocess.DEVNULL,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        got = json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(fresh, ignore_errors=True)
    assert got["default"] == os.path.join(build_dir, "hqp_tpu_torch_hxi")
    assert got["jax"] == []
    under = fresh + os.sep
    assert all(p.startswith(under) for p in got["paths"]), got["paths"]
    assert got["built"] == [True] * 6
    assert (got["again"], got["hit"]) == (got["paths"][0], False)
    assert got["fmu_dir"].startswith(under)
    assert "cc failed" in got["failed"]
    assert any(w.endswith(".so") for w in got["writes"])
    stray = [w for w in got["writes"]
             if not os.path.realpath(w).startswith(os.path.realpath(under))]
    assert stray == [], stray
    outs = [o for o in got["cc_out"] if o != os.devnull]
    assert len(outs) == 6 and all(o.startswith(under) for o in outs), outs
    assert {d: _tree_listing(os.path.join(root, d))
            for d in ("native", "hqp_tpu")} == before
    paths = [tsfun.demo_sfunction_path(n) for n in ("sfun_did", "sfun_dic")]
    build = os.path.join(build_dir, "hqp_tpu_torch_hxi") + os.sep
    assert all(p.startswith(build) and os.path.isfile(p) for p in paths)
    ev = tsfun.SFunction(paths[0], params=[[0.1]])
    jev = JSFunction(jdemo_path("sfun_did"), params=[[0.1]])
    np.testing.assert_array_equal(ev.update(0.0, [1.0, 0.0], [2.0]),
                                  jev.update(0.0, [1.0, 0.0], [2.0]))
    with pytest.raises(RuntimeError, match="expects 1 parameter"):
        tsfun.SFunction(paths[1], params=[])


def test_plt_io_matches_reference(tmp_path):
    """write_plt gives the same bytes from the same inputs; read_plt (with
    windowing and duplicate-time replacement), plot_series and
    solver_trajectory (of a solver holding tensors) give the same
    arrays."""
    rng = np.random.default_rng(4)
    ts = np.linspace(0.0, 2.0, 7)
    X, U = rng.standard_normal((7, 3)), rng.standard_normal((6, 2))
    for pkg, name in ((jplt, "j.plt"), (tplt, "t.plt")):
        pkg.write_plt(tmp_path / name, ts, X, U, tscale=1.5)
    assert (tmp_path / "j.plt").read_bytes() == \
        (tmp_path / "t.plt").read_bytes()
    w = tmp_path / "w.plt"
    w.write_text("5 0 2\ntime\nv\n0.0 1.0\n0.5 2.0\n0.5 3.0\n0.6 4.0\n"
                 "1.0 5.0\n")
    for kw in ({}, dict(tstart=0.5, tend=0.6), dict(dtmin=0.45)):
        for p in (tmp_path / "t.plt", w):
            jn, jd = jplt.read_plt(p, **kw)
            tn, td = tplt.read_plt(p, **kw)
            assert tn == jn
            np.testing.assert_array_equal(td, jd)
    for sidx in range(5):
        assert tplt.plot_series(ts, X, U, sidx, tscale=2.0) == \
            jplt.plot_series(ts, X, U, sidx, tscale=2.0)
    x = rng.standard_normal((7, 5))
    prg = types.SimpleNamespace(nx=3, nu=2, sps=2, ts=np.linspace(0, 1, 13))
    ref = jplt.solver_trajectory(types.SimpleNamespace(prg=prg, x=x))
    tprg = types.SimpleNamespace(nx=3, nu=2, sps=2, ts=_t(prg.ts))
    out = tplt.solver_trajectory(types.SimpleNamespace(prg=tprg, x=_t(x)))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


#: the estimations: DynamicEst on the decay model in torch ops and DTEst on
#: its discrete twin (one QP shape, so that the reference compiles its
#: interior point once)
ESTIMATIONS = ("DynamicEst", "DTEst")


# -- the shell slice: DID-60 through the shell, hot re-solves, diagnostics -------

from hqp_tpu.shell import Shell as JShell  # noqa: E402
from hqp_tpu.utils import checkpoint as jckpt  # noqa: E402
from hqp_tpu.utils import diagnostics as jdiag  # noqa: E402

from hqp_tpu_torch.shell import Shell  # noqa: E402
from hqp_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from hqp_tpu_torch.utils import diagnostics as tdiag  # noqa: E402
from hqp_tpu_torch.utils import log as tlog  # noqa: E402
from hqp_tpu_torch.utils import masked as tmk  # noqa: E402
from hqp_tpu_torch.utils import sync  # noqa: E402

#: tests/test_shell.py's test_did_via_shell script
DID60_SCRIPT = """
    prg_name DID
    prg_kmax 60
    sqp_solver Powell
    qp_mat_solver SpSC
    sqp_max_iters 50
    prg_setup
    sqp_init
"""
#: the measured initial states of the DID-60 hot re-solves
HOT60_X0 = ((1.05, 0.0), (1.10, 0.0), (1.15, 0.0))


def _close_scalar(a, b, rtol):
    assert abs(a - b) <= rtol * abs(b), (a, b)


def _did60_shell_drive(sh, pin, tmp):
    """test_did_via_shell's script in ``sh``, then the readbacks, the plt
    file and plot series, the final QP's dump, prg_test at the solution
    and three hqp_solve_hot steps (``pin(prg, x0)`` sets the new initial
    state); returns what each step gave."""
    sh.run(DID60_SCRIPT)
    res = sh("hqp_solve")
    out = {"cold": (res, float(sh("prg_f")), int(sh("sqp_iter")),
                    sh.solver.qp_iters_total),
           "norms": (float(sh("sqp_norm_inf")), float(sh("sqp_eps"))),
           "evals": (int(sh("prg_fbd_evals")), int(sh("prg_grd_evals"))),
           "K": int(sh("prg_K"))}
    plt = str(tmp / "did.plt")
    assert sh(f"omu_write_plt {plt}") == plt
    out["plt"] = (int(sh(f"omu_read_plt {plt}")), list(sh.plt_names),
                  sh.plt_data, int(sh("omu_plot 0")), sh.plot_ydata,
                  int(sh("omu_plot 2")), sh.plot_ydata)
    out["dump"] = sh(f"prg_qp_dump {tmp / 'qp.npz'}")
    out["prg_test"] = sh("prg_test")
    s = sh.solver
    reinit = s.qp_reinit_bd
    restored = []

    def spy():
        before = s.qp.Q
        reinit()
        # (the Q is the snapshot, the Q came back from another one)
        restored.append((s.qp.Q is s._qp_Q_hot, s.qp.Q is not before))

    s.qp_reinit_bd = spy
    out["hot"] = []
    for x0 in HOT60_X0:
        pin(sh.prg, x0)
        s.qp_iters_total = 0
        it0 = s.iter
        res = sh("hqp_solve_hot")
        if len(out["hot"]) == 0:
            snap = (s._qp_Q_hot, np.array(s._qp_Q_hot))
        out["hot"].append((res, float(sh("prg_f")), s.iter - it0,
                           s.qp_iters_total, np.array(s.x)[0, :2]))
    out["restored"] = restored
    out["snapshot_kept"] = np.array_equal(np.array(snap[0]), snap[1]) and \
        s._qp_Q_hot is snap[0]
    return out


def _resume(slv, prg, ck, path):
    """tests/test_aux.py's checkpoint: DID-60 stopped after 3 SQP
    iterations, saved to ``path``, loaded into a fresh solver and
    finished; returns (saver, restored, verdict, f, SQP, IP)."""
    s1 = slv(prg(), max_iters=50)
    s1.init()
    for _ in range(3):
        s1.qp_update()
        s1.qp_solve()
        s1.step()
    ck.save_solver(path, s1)
    s2 = slv(prg(), max_iters=50)
    s2.init()
    ck.load_solver(path, s2)
    assert s2.iter == s1.iter == 3
    res = s2.solve()
    return s1, s2, res, float(s2.f), s2.iter, s2.qp_iters_total


def shell_reference(tmp):
    """The JAX package's side of did60_shells, made in directory ``tmp``:
    :func:`_did60_shell_drive` in its shell, tests/test_diagnostics.py's
    wrong Jacobian through prg_test (whether it raises, then the error
    with the tolerance lifted) and the checkpoint's resumed run."""
    import pathlib
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    j = _did60_shell_drive(
        JShell(rcfile=False),
        lambda prg, x0: prg.set_pinned(jnp.asarray(x0), stage=0), tmp)
    jp = _JBrokenDID(kmax=60)
    try:
        jdiag.prg_test(jp)
        j["broken_raises"] = False
    except ValueError:
        j["broken_raises"] = True
    j["broken"] = jdiag.prg_test(jp, tol=np.inf)["max_rel_err"]
    j["resumed"] = _resume(JSqpPowell, lambda: JPrgDID(kmax=60), jckpt,
                           str(tmp / "ckpt.npz"))[2:]
    return _host(j)


@pytest.fixture(scope="module")
def did60_shells(background, tmp_path_factory):
    """:func:`_did60_shell_drive` in the JAX package's shell (with the rest
    of :func:`shell_reference`, in the background) and in the port's (on
    the CPU), each in a directory of its own."""
    j = background.result("shell60")
    t = _did60_shell_drive(
        Shell(rcfile=False, device="cpu"),
        lambda prg, x0: prg.set_pinned(x0, stage=0),
        tmp_path_factory.mktemp("port"))
    return j, t


def test_shell_did60_matches_reference(did60_shells):
    """tests/test_shell.py's DID-60 script through both shells: the same
    verdict, SQP/IP counts and evaluation counters (prg_fbd_evals,
    prg_grd_evals), f within 1e-10 relative, sqp_norm_inf < sqp_eps;
    ``prg_kmax 1000``-style constructor knobs re-create the program
    (prg_K reads 60 back: the program keeps the reference's K)."""
    j, t = did60_shells
    assert t["cold"][0] == j["cold"][0] == "optimal"
    assert t["cold"][2:] == j["cold"][2:]
    _close_scalar(t["cold"][1], j["cold"][1], 1e-10)
    _close_scalar(t["cold"][1], 98.4, 1e-5)
    assert t["norms"][0] < t["norms"][1] == j["norms"][1]
    assert t["evals"] == j["evals"] and t["evals"][0] > 0
    assert t["K"] == j["K"] == 60


@pytest.mark.parametrize("step", range(len(HOT60_X0)))
def test_mpc_hot_resolve_matches_reference(did60_shells, step):
    """tests/test_hot_start.py's MPC re-solve on DID-60, three steps:
    after ``set_pinned(x0)`` each ``hqp_solve_hot`` gives the reference's
    verdict and SQP/IP counts, f within 1e-10, fewer IP iterations than
    the cold solve, and the new x0 exactly; from the second step on
    qp_reinit_bd restores the Hessian snapshot ``_qp_Q_hot`` (the same
    tensor, never written in place)."""
    j, t = did60_shells
    jr, tr = j["hot"][step], t["hot"][step]
    assert tr[0] == jr[0] == "optimal"
    assert tr[2:4] == jr[2:4]
    assert tr[3] < t["cold"][3]
    _close_scalar(tr[1], jr[1], 1e-10)
    np.testing.assert_array_equal(tr[4], HOT60_X0[step])
    assert t["restored"][step] == (True, step > 0)
    assert j["restored"][step][0]
    assert t["snapshot_kept"]


def test_shell_plt_matches_reference(did60_shells):
    """tests/test_plt.py's shell flow on the solved DID-60: omu_write_plt,
    omu_read_plt (61 points) and omu_plot (61-point state polyline,
    120-point control staircase) give the reference's names and counts and
    its values within 1e-8."""
    j, t = did60_shells
    jn, jnames, jdata, j0, jy0, j2, jy2 = j["plt"]
    tn, tnames, tdata, t0, ty0, t2, ty2 = t["plt"]
    assert (tn, tnames, t0, t2) == (jn, jnames, j0, j2) == \
        (61, ["time", "x0", "x1", "u0"], 61, 120)
    for a, b in ((tdata, jdata), (ty0, jy0), (ty2, jy2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-8,
                                   rtol=1e-8)


def test_qp_dump_loads_across_packages(did60_shells, tmp_path):
    """``prg_qp_dump`` of the JAX package's final QP loads into the port
    as the same QP (every field equal to the last bit), the port's own
    dump round-trips, and the reference's qp_load reads the port's."""
    j, t = did60_shells
    jqp = jdiag.qp_load(j["dump"])
    tqp = tdiag.qp_load(j["dump"], "cpu")
    assert type(tqp).__name__ == type(jqp).__name__ == "StageQP"
    ref = convert.stage_qp(jqp, "cpu")
    for fl in dataclasses.fields(tqp):
        a, b = getattr(tqp, fl.name), getattr(ref, fl.name)
        assert (a is None) == (b is None), fl.name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), fl.name
    mine = tdiag.qp_load(t["dump"], "cpu")
    path = str(tmp_path / "again.npz")
    tdiag.qp_dump(mine, path)
    again = tdiag.qp_load(path, "cpu")
    back = jdiag.qp_load(t["dump"])
    for fl in dataclasses.fields(mine):
        a = getattr(mine, fl.name)
        if a is not None:
            assert torch.equal(getattr(again, fl.name), a), fl.name
            np.testing.assert_array_equal(np.asarray(getattr(back, fl.name)),
                                          a.numpy())


class _BrokenDID(PrgDID):
    """tests/test_diagnostics.py's wrong Jacobian: A off by 1%."""

    def eval_derivs(self, v):
        A, cgrad, C = super().eval_derivs(v)
        return A * 1.01, cgrad, C


class _JBrokenDID(JPrgDID):
    def eval_derivs(self, v):
        A, cgrad, C = super().eval_derivs(v)
        return A * 1.01, cgrad, C


def test_prg_test_matches_reference(did60_shells):
    """prg_test: at DID-60's solution both packages pass (the shell's
    ``prg_test``, max relative error below 1e-4; what remains is the
    central differences' rounding, which no two evaluations share); on
    tests/test_diagnostics.py's wrong Jacobian both raise ValueError and,
    with the check's tolerance lifted, report the same max relative error
    within 1e-6 relative (the same probe directions: seed 0)."""
    j, t = did60_shells
    for out in (j["prg_test"], t["prg_test"]):
        assert out.startswith("ok max_rel_err ")
        assert float(out.split()[-1]) < 1e-4
    tp = _BrokenDID(kmax=60, device="cpu")
    with pytest.raises(ValueError):
        tdiag.prg_test(tp)
    assert j["broken_raises"]
    te = tdiag.prg_test(tp, tol=np.inf)["max_rel_err"]
    assert te > 1e-3
    _close_scalar(te, j["broken"], 1e-6)


def test_checkpoint_resume_matches_reference(did60_shells, tmp_path):
    """tests/test_aux.py's checkpoint: DID-60 stopped after 3 SQP
    iterations, saved, loaded into a fresh solver and finished, in both
    packages: the port resumes to the reference's resumed verdict, SQP/IP
    counts and f (within 1e-10), f within 1e-8 of the straight solve (the
    shell's DID-60); the restored solver shares no storage with the one
    that saved.  (Neither package's checkpoint holds Powell's penalty
    weights, so the resumed run takes its own path: 5 / 49 against the
    straight-on 3 / 40.)"""
    j, t = did60_shells
    s1, s2, *got = _resume(SqpPowell, lambda: PrgDID(kmax=60, device="cpu"),
                           tckpt, str(tmp_path / "ckpt.npz"))
    ref = j["resumed"]
    assert got[0] == ref[0] == "optimal"
    assert tuple(got[2:]) == ref[2:]
    _close_scalar(got[1], ref[1], 1e-10)
    _close_scalar(got[1], t["cold"][1], 1e-8)

    def storages(s):
        return {x.untyped_storage().data_ptr() for x in tmk.leaves(
            (s.x, s.y, s.z, s.qp, s.ip_state, s.d, s.s, s.grd_L))}

    assert not storages(s1) & storages(s2)


def test_save_pytree_round_trip(tmp_path):
    """checkpoint.save_pytree / load_pytree: nested dicts, lists, tuples
    and dataclasses of tensors (f64, f32, int64, bool, empty) and of None
    and plain values come back with their structure, dtypes and values,
    as new tensors on the asked device, with the meta dict; a dataclass
    comes back as the class of ``like``'s node, as a dict of its fields
    without one; the file holds no pickle; anything else is refused, and
    so is the card where there is none."""
    from hqp_tpu_torch.qp.program import IneqGroups
    ineq = IneqGroups(*(torch.full((2, 1), float(i)) for i in range(4)))
    tree = {"x": torch.arange(6.0).reshape(2, 3),
            "groups": [torch.ones(2, dtype=torch.float32),
                       (None, torch.tensor([3, 4]), 2, "bl")],
            "mask": torch.tensor([True, False]), "empty": torch.zeros(0),
            "nested": {"t": (), "l": [1.5, torch.tensor(7.0)]},
            "ineq": [ineq]}
    path = str(tmp_path / "tree.npz")
    tckpt.save_pytree(path, tree, meta={"iter": 3, "f": 1.25})
    got, meta = tckpt.load_pytree(path, device="cpu",
                                  like={"ineq": [ineq]})
    assert meta == {"iter": 3, "f": 1.25}

    def same(a, b):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
            assert not b.numel() or a.untyped_storage().data_ptr() != \
                b.untyped_storage().data_ptr()
        elif isinstance(b, dict):
            assert list(a) == list(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for u, v in zip(a, b):
                same(u, v)
        elif isinstance(b, IneqGroups):
            assert type(a) is IneqGroups
            same(vars(a), vars(b))
        else:
            assert a == b

    same(got, tree)
    plain, _ = tckpt.load_pytree(path, device="cpu")
    same(plain["ineq"][0], vars(ineq))
    with np.load(path, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(
            [f"leaf{i}" for i in range(10)] + ["tree", "meta"])
    with pytest.raises(TypeError, match="cannot save"):
        tckpt.save_pytree(path, {"s": {1, 2}})
    with pytest.raises(TypeError, match="keys"):
        tckpt.save_pytree(path, {1: torch.zeros(1)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tckpt.load_pytree(path)


def test_hxi_builders_write_where_asked(tmp_path):
    """compile_sfunction, build_sfunction, build_mex_sfunction (``out``)
    and build_test_fmu (``out_path``) build from the port's sources at the
    path given, as the reference's builders do, and what they build loads
    and runs as the default build under build/ does."""
    import ctypes

    from hqp_tpu_torch.hxi import fmu, mex, sfunction, simulink
    sdir = os.path.join(sfunction.HXI_DIR, "sfun_did.c")
    src = os.path.join(simulink.SIMULINK_DIR, "sfun_did_demo.c")
    built = {
        "so": sfunction.compile_sfunction(sdir, str(tmp_path / "a" /
                                                    "did.so")),
        "cg": simulink.build_sfunction(src, out=str(tmp_path / "cg.so")),
        "mex": mex.build_mex_sfunction(src, out=str(tmp_path / "m.mexa64")),
        "fmu": fmu.build_test_fmu(str(tmp_path / "dic.fmu"))}
    for k, path in built.items():
        assert os.path.dirname(path).startswith(str(tmp_path)), (k, path)
        assert os.path.isfile(path)
    assert sorted(os.listdir(tmp_path)) == ["a", "cg.so", "dic.fmu",
                                            "m.mexa64"]
    mine, dflt = (sfunction.SFunction(p, params=[0.1]) for p in (
        built["so"], sfunction.demo_sfunction_path("sfun_did")))
    assert (mine.S.nx, mine.S.nxd, mine.S.nu, mine.S.ny) == \
        (dflt.S.nx, dflt.S.nxd, dflt.S.nu, dflt.S.ny)
    assert hasattr(ctypes.CDLL(built["mex"]), "mexFunction")
    a = simulink.SimulinkSFunction(built["cg"], params=[0.05])
    b = mex.MexSFunction(built["mex"], args="[0.05]")
    for sf in (a, b):
        sf.set_inputs([0.5])
        sf.update(t=0.0)
    np.testing.assert_array_equal(a.xd, b.xd)
    assert fmu.Fmu(built["fmu"]).nx == fmu.Fmu(fmu.build_test_fmu()).nx


def test_log_levels_and_timers(capsys, monkeypatch):
    """tests/test_aux.py's log levels and timers, in both packages: the
    same lines printed; a phase counts its calls and waits for no device
    (no torch.cuda.synchronize, no counted host read)."""
    from hqp_tpu.utils import log as jlog
    outs = []
    for lg in (jlog, tlog):
        old = lg.level
        try:
            lg.set_level("info")
            lg.info("sqp", "hello")
            lg.error("qp", "bad")
            lg.log(lg.LOG_ALL, "x", "hidden")
            lg.warning("kkt", "shown")
            outs.append(capsys.readouterr().out)
        finally:
            lg.level = old
    assert outs[0] == outs[1] == \
        "[info] sqp: hello\n[error] qp: bad\n[warning] kkt: shown\n"

    def no_sync(*a):
        raise AssertionError("a phase synchronized the device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    t, n0 = tlog.Timers(), sync.COUNT
    for _ in range(2):
        with t.phase("factor"):
            pass
    with t.phase("solve"):
        pass
    rep = t.report()
    assert rep["factor"]["calls"] == 2 and rep["solve"]["calls"] == 1
    assert sorted(rep) == ["factor", "solve"] and sync.COUNT == n0
    t.reset()
    assert t.report() == {}


# -- the port's spans and refinement counters --------------------------------

#: the modes of traced_solves: tracing off, tracing on, tracing on under a
#: CPU torch.profiler
TRACE_MODES = ("off", "on", "on_profiled")


@pytest.fixture(scope="module")
def traced_solves():
    """Two problems of _scenario_batch's batch presolved and solved by
    Mehrotra(PartitionedKKT(L=5)) in each of TRACE_MODES, with
    torch.cuda.synchronize raising throughout: the states, the deltas of
    sync.COUNT and of the refinement counters, log.timers' records and the
    profiler's user annotations (name, start_ns) in start order.  A
    profile first opens one record_function of its own: the first range
    of a process pays a one-off set-up before its clock reading."""
    prg, v, Q = _scenario_batch()
    v, Q = v[:2], Q[:2]
    solve = tscen.make_scenario_solve(
        prg, Mehrotra(backend=PartitionedKKT(L=5)), presolve_tau=0.02)

    def no_sync(*a):
        raise AssertionError("tracing synchronized the device")

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "synchronize", no_sync)
        for mode in TRACE_MODES:
            tlog.timers.reset()
            n0, c0, r0 = sync.COUNT, tkkt.REFINE_CALLS, tkkt.REFINE_ROUNDS
            profiled = mode.endswith("profiled")
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) \
                if profiled else contextlib.nullcontext()
            tlog.set_tracing(mode.startswith("on"))
            try:
                with prof:
                    with torch.profiler.record_function("warm-up"):
                        pass
                    st, _ = solve(v, Q)
            finally:
                tlog.set_tracing(False)
            events = sorted(
                (e.start_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.is_user_annotation() and e.name() != "warm-up") \
                if profiled else []
            out[mode] = dict(
                st=st, syncs=sync.COUNT - n0,
                calls=tkkt.REFINE_CALLS - c0,
                rounds=tkkt.REFINE_ROUNDS - r0,
                records=list(tlog.timers.records),
                events=[(n, t) for t, n in events])
    tlog.timers.reset()
    return out


def _state_leaves(st):
    return [st.x, st.iter, *tmk.leaves(st.y), *tmk.leaves(st.z),
            *tmk.leaves(st.w)]


def test_tracing_off_records_nothing_and_changes_no_bit(traced_solves):
    """Off, a span is the one shared no-op context: no record, and no
    record_function range under a profiler; on, the batch's x, y, z, w and
    iter are the same to the bit, with the same host reads and refinement
    counts, and the same spans with a profiler and without."""
    off = traced_solves["off"]
    assert off["records"] == []
    assert off["calls"] > 0 and off["rounds"] > 0
    assert tlog.timers.span("a") is tlog.timers.span("b")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tlog.timers.span("mehrotra.solve"):
            pass
    assert tlog.timers.records == [] and not any(
        e.is_user_annotation() for e in prof.profiler.kineto_results.events())
    for mode in ("on", "on_profiled"):
        on = traced_solves[mode]
        for key in ("syncs", "calls", "rounds"):
            assert on[key] == off[key], (mode, key)
        for a, b in zip(_state_leaves(off["st"]), _state_leaves(on["st"]),
                        strict=True):
            assert torch.equal(a, b), mode
    assert [r.name for r in traced_solves["on"]["records"]] == \
        [r.name for r in traced_solves["on_profiled"]["records"]]


def test_spans_nest_under_one_unit(traced_solves):
    """Every refinement round sits in kkt.refine in partitioned.solve in a
    phase of Mehrotra's solve; all spans share the root's unit, their self
    times sum to its duration, the steps, rounds and reads add up."""
    on = traced_solves["on"]
    recs = on["records"]
    by_id = {r.id: r for r in recs}
    root = recs[0]
    assert root.name == "scenarios.solve" and root.parent is None
    assert {r.unit for r in recs} == {root.id}
    assert all(r.end_ns >= r.start_ns >= root.start_ns for r in recs)
    assert sum(r.self_ns for r in recs) == root.end_ns - root.start_ns

    def chain(r):
        names = []
        while r.parent is not None:
            r = by_id[r.parent]
            names.append(r.name)
        return names

    rounds = [r for r in recs if r.name == "kkt.refine.round"]
    assert rounds and len(rounds) == on["rounds"]
    for r in rounds:
        up = chain(r)
        assert up[:2] == ["kkt.refine", "partitioned.solve"], up
        assert up[2].startswith("mehrotra.") and "mehrotra.solve" in up
        assert up[-1] == "scenarios.solve"
    names = collections.Counter(r.name for r in recs)
    steps = int(on["st"].iter.max())
    # the last step call finds every problem done and takes no step
    assert names["mehrotra.step"] == steps + 1
    assert names["mehrotra.predictor"] == steps
    assert names["kkt.refine"] == on["calls"]
    assert sum(r.reads for r in recs) == on["syncs"] > 0
    assert all(r.read_ns >= 0 for r in recs)
    assert names["docp.make_qp_batch"] == names["presolve.merge"] == \
        names["presolve.violation"] == names["mehrotra.solve"] == 1


def test_spans_are_record_functions_on_the_profiler_clock(traced_solves):
    """Under torch.profiler each span is a record_function range of its
    name, in the same order, starting within 100 us of the record's start
    on the profiler's clock (log.timers.epoch_ns)."""
    prof = traced_solves["on_profiled"]
    recs = prof["records"]
    assert [n for n, _ in prof["events"]] == [r.name for r in recs]
    worst = max(abs(t - tlog.timers.epoch_ns(r.start_ns))
                for (_, t), r in zip(prof["events"], recs))
    assert worst < 100_000, worst


# -- the crane as a batch of stage QPs (the benchmark's crane_scen) ----------

from hqp_tpu_torch.docp import program as tdocp  # noqa: E402
from hqp_tpu_torch.omu import program as tomu  # noqa: E402
from portbench.core import check as bcheck  # noqa: E402
from portbench.core import spec as bspec  # noqa: E402
from portbench.core import system as bsystem  # noqa: E402
from portbench.core import traffic as btraffic  # noqa: E402
from portbench.reference import crane as rcrane  # noqa: E402

#: the seed of the crane batch's draws
CRANE_SEED = 2 ** 33 + 5


def _crane_system():
    """The benchmark's crane_scen configuration at K = 10 and B = 3 as the
    benchmark builds it (portbench.core.system.System) on the CPU, and one
    batch of its draws."""
    cfg = dict(bspec.load_cell("crane_scen.montecarlo").config, K=10,
               kmax=10, batch=3)
    sut = bsystem.System(cfg, CPU, ref=rcrane)
    draws = btraffic.Draws(rcrane.base_iterate(cfg, CPU), sut.batch, 1e-3,
                           CRANE_SEED, CPU)
    return sut, draws.next()


@pytest.fixture(scope="module")
def crane_solves():
    """One crane batch solved as the benchmark solves it (presolve tau
    0.02, Mehrotra(PartitionedKKT(L=20), eps=1e-9, max_iters=50)), tracing
    off and then on: each mode's unit, its records and the deltas of the
    integration and QP-build counters."""
    sut, v = _crane_system()
    out = dict(sut=sut)
    for mode in ("off", "on"):
        tlog.timers.reset()
        i0, b0 = tomu.INTEGRATIONS, tdocp.QP_BUILDS
        tlog.set_tracing(mode == "on")
        try:
            unit = sut.run(v)
        finally:
            tlog.set_tracing(False)
        out[mode] = dict(unit=unit, records=list(tlog.timers.records),
                         integrations=tomu.INTEGRATIONS - i0,
                         builds=tdocp.QP_BUILDS - b0)
    tlog.timers.reset()
    return out


def test_crane_reference_qp_matches_program():
    """The benchmark's plain crane (its own RK4 and hand-written
    sensitivities) builds the program's QP on seeded draws: every float
    field to 1e-12 of its largest finite entry, infinities and masks
    equal; its base iterate is the program's."""
    sut, v = _crane_system()
    _, qp = sut.prg.make_qp_batch(v, sut.Q)
    ref = rcrane.build_qp(sut.cfg, v, sut.Q)
    assert torch.equal(rcrane.base_iterate(sut.cfg, CPU), sut.prg.setup())
    for key, want in ref.items():
        got = getattr(qp, key)
        assert got.shape == want.shape, key
        if want.dtype == torch.bool:
            assert torch.equal(got, want), key
            continue
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), fin), key
        assert torch.equal(got[~fin], want[~fin]), key
        if fin.any():
            gap = float((got[fin] - want[fin]).abs().max())
            assert gap <= 1e-12 * float(want[fin].abs().max()), (key, gap)


def test_crane_reference_A_is_its_rk4_maps_derivative():
    """The reference's A (RK4's forward-sensitivity recursion) against
    central differences of its own stage map, step 1e-6: the differences'
    error is O(1e-12) of the entries here, held at 1e-7 of the largest;
    tf passes through, so A's first row is the unit row."""
    sut, v = _crane_system()
    cfg, nx, nv = sut.cfg, rcrane.NX, rcrane.NV
    A = rcrane.build_qp(cfg, v, sut.Q)["A"]
    eps = 1e-6
    cols = []
    for j in range(nv):
        step = torch.zeros_like(v)
        step[..., :-1, j] = eps
        up, dn = ((rcrane.build_qp(cfg, w, sut.Q)["b"] + w[..., 1:, :nx])
                  for w in (v + step, v - step))
        cols.append((up - dn) / (2 * eps))
    fd = torch.stack(cols, dim=-1)
    assert float((A - fd).abs().max()) <= 1e-7 * float(A.abs().max())
    assert torch.equal(A[..., 0, :], torch.eye(nx, nv, dtype=A.dtype)[0]
                       .expand(A.shape[:-2] + (nv,)))


def test_crane_batch_solves_and_passes_the_benchmarks_check(crane_solves):
    """Every draw OPTIMAL, and portbench's check (the reference's QP, its
    presolve and the certificate) finds nothing wrong."""
    sut, unit = crane_solves["sut"], crane_solves["off"]["unit"]
    answer = sut.outputs()
    assert bool(answer(unit)["optimal"].all())
    numbers, attempted, failed = bcheck.judge(rcrane, sut.cfg, [unit],
                                              answer, sut.Q)
    assert (attempted, failed) == (sut.batch, 0), numbers
    assert numbers["viol_gap"]["value"] == 0.0


def test_crane_check_fails_x_moved_by_1e6(crane_solves):
    """The same answers with x moved by 1e-6 fail every QP of the check
    (the equality residuals pass the 1e-9 primal limit)."""
    sut, unit = crane_solves["sut"], crane_solves["off"]["unit"]
    moved = dataclasses.replace(
        unit, state=dataclasses.replace(unit.state, x=unit.state.x + 1e-6))
    numbers, attempted, failed = bcheck.judge(rcrane, sut.cfg, [moved],
                                              sut.outputs(), sut.Q)
    assert failed == attempted == sut.batch
    assert numbers["primal"]["value"] > sut.cfg["limits"]["primal"]


def test_crane_build_spans_and_counters(crane_solves):
    """Traced, docp.eval_vals and docp.eval_derivs sit in
    docp.make_qp_batch; the build integrates the horizon twice (values,
    then again inside jacfwd), so INTEGRATIONS / QP_BUILDS reads 2 with
    tracing on and off; off, nothing is recorded and the answers are the
    same to the bit."""
    off, on = crane_solves["off"], crane_solves["on"]
    assert off["records"] == []
    for mode in (off, on):
        assert mode["builds"] == 1
        assert mode["integrations"] / mode["builds"] == 2.0
    recs = on["records"]
    by_id = {r.id: r for r in recs}
    evals = [r for r in recs
             if r.name in ("docp.eval_vals", "docp.eval_derivs")]
    assert sorted(r.name for r in evals) == ["docp.eval_derivs",
                                             "docp.eval_vals"]
    assert all(by_id[r.parent].name == "docp.make_qp_batch" for r in evals)
    a, b = off["unit"].state, on["unit"].state
    for x, y in zip(_state_leaves(a), _state_leaves(b), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(off["unit"].viol, on["unit"].viol)


# -- the comparisons whose JAX side runs in the background -------------------------

import time  # noqa: E402

from tests.test_torch_sqp import (Background, _host,  # noqa: E402
                                  lower_priority, user_reference)

#: the JAX package's solves of this module made in the background
#: (Background): the chunks in the order this file's tests read them (the
#: two longest first), the cores of the interpreters (past
#: test_torch_sqp.py's five, the last on the first of those), and the
#: names each test reads; the directory of the Background interpreters
#: that run this module (they set it), where a reference may leave files
#: for the tests
BACKGROUND_DIR = None
_INTEG = [f"integ-{n}-{p}" for n, p in INTEG_CASES]
_FAMILIES = ["family-lqblend-100", "family-broydn3d-60", "family-bdqrtic-60",
             "family-catena-40", "family-srosenbr-60"]
BACKGROUND_CHUNKS = (
    ["crane50"], ["bio"], ["shell60"], ["sharded_jax", "sharded_jax_rep"],
    *([f"integ-{n}-{p}" for p in probs]
      for n, (_, probs) in NEW_INTEGRATORS.items()),
    _FAMILIES, ["user-DynamicEst", "user-DTEst"])
BACKGROUND_PLACES = (5, 6, 7, 0)
BACKGROUND_WANTS = {"test_sqp_crane50_matches_reference": ["crane50"],
                    "test_sqp_bio_matches_reference": ["bio"],
                    "test_sharded_kkt_spawned_ranks": ["sharded_jax",
                                                       "sharded_jax_rep"],
                    "test_estimation_solves_match_reference": [
                        "user-DynamicEst", "user-DTEst"],
                    "test_shell_did60_matches_reference": ["shell60"],
                    "test_mpc_hot_resolve_matches_reference": ["shell60"],
                    "test_shell_plt_matches_reference": ["shell60"],
                    "test_qp_dump_loads_across_packages": ["shell60"],
                    "test_prg_test_matches_reference": ["shell60"],
                    "test_checkpoint_resume_matches_reference": ["shell60"],
                    "test_new_integrator_matches_reference": _INTEG,
                    "test_families_match_reference": _FAMILIES}


@pytest.fixture(scope="module", autouse=True)
def background(request, tmp_path_factory):
    """This module's Background (BACKGROUND_CHUNKS, BACKGROUND_PLACES)."""
    bg = Background(request, BACKGROUND_CHUNKS, BACKGROUND_WANTS,
                    tmp_path_factory.mktemp("references"), BACKGROUND_PLACES)
    yield bg
    bg.close()


def reference_result(name):
    """The JAX package's side of a comparison of BACKGROUND_CHUNKS: the
    reference's SqpPowell(prg, max_iters=100), init(), solve() of the Crane
    at K = 50 or of Bio ({res, f, iter, ip}), or its sharded solve of
    SHARD_JAX on its virtual 4-device mesh, or of SHARD_REP with
    full_shard=False on a one-device mesh ({dx, dyn}: jitted on two
    devices that layout corrupts XLA:CPU's heap, the runtime fault
    tests/conftest.py and hqp_tpu/qp/kkt.py describe, and unjitted it
    takes minutes; its direction is the same on one device); or that of an
    estimation ("user-<name>", :func:`user_reference`), of the DID-60
    shell ("shell60", :func:`shell_reference`, in the interpreter's own
    directory) or of an integrator case ("integ-<name>-<prob>",
    :func:`integ_reference`)."""
    if name.startswith("user-"):
        return user_reference(name[len("user-"):])
    if name == "shell60":
        return shell_reference(os.path.join(BACKGROUND_DIR, name))
    if name.startswith("integ-"):
        return integ_reference(*name.split("-")[1:])
    if name.startswith("family-"):
        _, fam, n = name.split("-")
        return family_reference(fam, int(n))
    if name.startswith("sharded_jax"):
        from hqp_tpu.parallel.scenarios import make_mesh
        from hqp_tpu.parallel.sharded_kkt import ShardedPartitionedKKT
        rep = name.endswith("_rep")
        K, nx, nu, mc, L, seed = SHARD_REP[:6] if rep else SHARD_JAX
        qp = random_stage_qp(K, nx, nu, mc, seed=seed)
        z, w, mask = random_zw(qp, seed=1)
        r = random_rhs(qp, seed=2)
        be = ShardedPartitionedKKT(make_mesh(1 if rep else 4, axes=("sp",)),
                                   axis="sp", L=L, full_shard=not rep)

        def solve(qp, z, w, mask, *r):
            return be.solve(be.factor(qp, z, w, mask), qp, z, w, mask, *r)

        dx, dy, _, _ = jax.jit(solve)(qp, z, w, mask, *r)
        return dict(dx=np.asarray(dx), dyn=np.asarray(dy["dyn"]))
    js = JSqpPowell(JPrgCrane(K=50) if name == "crane50" else JPrgBio(),
                    max_iters=100)
    js.init()
    res = js.solve()
    return dict(res=res, f=float(js.f), iter=js.iter, ip=js.qp_iters_total)


def _port_solve(ref, tprg, rtol):
    """The port's SqpPowell(prg, max_iters=100), init(), solve() against
    the reference's ``ref``: the same result, SQP and IP iterations; f
    within ``rtol`` relative."""
    ts = SqpPowell(tprg, max_iters=100)
    ts.init()
    tres = ts.solve()
    assert str(ref["res"]) == tres == "optimal"
    assert (ts.iter, ts.qp_iters_total) == (int(ref["iter"]),
                                            int(ref["ip"]))
    np.testing.assert_allclose(float(ts.f), float(ref["f"]), rtol=rtol,
                               atol=0)


def test_sqp_bio_matches_reference(background):
    """PrgBio(K=51), whose stages integrate by IMP(steps=4): the same
    result, SQP and IP iterations; f within 1e-8 relative."""
    _port_solve(background.result("bio"), PrgBio(device="cpu"), 1e-8)


def test_sqp_crane50_matches_reference(background):
    """The slice as a whole: PrgCrane(K=50) through SqpPowell ->
    Mehrotra -> PartitionedKKT (interiors s = 124 on K1's register
    kernel route, master n = 6 on K2): the same result, SQP and IP
    iterations; f within 1e-9 relative.  (Not K=20: there the IP
    iteration count follows the last bits of the KKT solves near each
    QP's solution -- 114 in the reference, 121 and 112 in the port with
    its Thomas and CR masters; ROADMAP Q3.)"""
    _port_solve(background.result("crane50"), PrgCrane(K=50, device="cpu"),
                1e-9)


# -- the MEX and Simulink-coder hosts ------------------------------------------------

from hqp_tpu.hxi import mex as jmex  # noqa: E402
from hqp_tpu.hxi import simulink as jsimulink  # noqa: E402

from hqp_tpu_torch.hxi import mex as tmex  # noqa: E402
from hqp_tpu_torch.hxi import simulink as tsimulink  # noqa: E402


def test_mex_and_simulink_hosts_match_reference():
    """The port's sfun_did_demo.c built both ways (cg_sfun and MEX, under
    build/): the MEX build exports mexFunction and no cg_sfun wrapper; on
    the same builds the port's SimulinkSFunction, MexSFunction and
    MexEvaluator equal the JAX package's bit for bit: sizes, method flags,
    sample time, outputs and update over seeded inputs, the evaluator's
    update and outputs, a char parameter (its codes reach the model: the
    sample time is ord('a')), and the parameter-count error."""
    import ctypes
    src = os.path.join(tsimulink.SIMULINK_DIR, "sfun_did_demo.c")
    cg, mx = tsimulink.build_sfunction(src), tmex.build_mex_sfunction(src)
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build") + os.sep
    assert cg.startswith(build) and mx.startswith(build)
    lib = ctypes.CDLL(mx)
    assert hasattr(lib, "mexFunction") and not hasattr(lib, "hxi_mdlOutputs")
    rng = np.random.default_rng(0)
    pairs = [(tsimulink.SimulinkSFunction(cg, params=[0.05]),
              jsimulink.SimulinkSFunction(cg, params=[0.05])),
             (tmex.MexSFunction(mx, args="[0.05]"),
              jmex.MexSFunction(mx, args="[0.05]"))]
    for t, j in pairs:
        for a in ("ncont", "ndisc", "nin", "nout", "has_update",
                  "has_derivatives", "has_jacobian"):
            assert getattr(t, a) == getattr(j, a), a
        assert t.sample_time() == j.sample_time() == 0.05
        for k in range(5):
            u = rng.standard_normal(1)
            np.testing.assert_array_equal(t.outputs(t=0.05 * k),
                                          j.outputs(t=0.05 * k))
            for sf in (t, j):
                sf.set_inputs(u)
                sf.update(t=0.05 * k)
            np.testing.assert_array_equal(t.xd, j.xd)
    te, je = tmex.MexEvaluator(mx, args="[0.1]"), \
        jmex.MexEvaluator(mx, args="[0.1]")
    assert (te.nx, te.nxd, te.nu, te.ny, te.sample_time) == \
        (je.nx, je.nxd, je.nu, je.ny, je.sample_time) == (0, 2, 1, 2, 0.1)
    for _ in range(4):
        x, u = rng.standard_normal(2), rng.standard_normal(1)
        np.testing.assert_array_equal(te.update(0.0, x, u),
                                      je.update(0.0, x, u))
        np.testing.assert_array_equal(te.outputs(0.0, x, u),
                                      je.outputs(0.0, x, u))
    tc, jc = tmex.MexSFunction(mx, params=["ab"]), \
        jmex.MexSFunction(mx, params=["ab"])
    assert tc.sample_time() == jc.sample_time() == float(ord("a"))
    for cls in (tmex.MexSFunction, jmex.MexSFunction):
        with pytest.raises(RuntimeError, match="parameter count mismatch"):
            cls(mx, args="[0.1], 'x'")


# -- stage sharding over torch.distributed ----------------------------------------

import torch.distributed as dist  # noqa: E402

from hqp_tpu_torch.parallel import distributed as tdist  # noqa: E402
from hqp_tpu_torch.parallel.sharded_kkt import ShardedPartitionedKKT  # noqa

#: the sharded KKT's cases by world size: (K, nx, nu, mc, L, seed) of
#: tests/test_sharded_kkt.py:33-38 at their device counts (seed K + ndev),
#: its 8-device case at 4 ranks, and SHARD_JAX twice at 4 ranks: with the
#: default rounds and with tests/test_distributed_mp.py's refine_rounds =
#: reg_corr_rounds = 1; a 7th entry names the keywords (SHARD_KW): the
#: 2-device case again with full_shard=False
SHARD_CASES = {
    1: [(8, 3, 1, 1, 4, 9)],
    2: [(12, 2, 2, 0, 6, 14), (12, 2, 2, 0, 6, 14, "rep")],
    4: [(24, 3, 2, 2, 3, 28), (24, 2, 1, 1, 3, 32), (16, 2, 1, 1, 4, 5),
        (16, 2, 1, 1, 4, 5, "rounds1")],
}
SHARD_KW = {"rounds1": dict(refine_rounds=1, reg_corr_rounds=1),
            "rep": dict(full_shard=False)}
#: the case held against the JAX package's sharded solve on its virtual
#: 4-device mesh (tests/test_distributed_mp.py's and test_sharded_kkt.py's
#: oracle shape)
SHARD_JAX = (16, 2, 1, 1, 4, 5)
#: the case held against the JAX package's full_shard=False solve
SHARD_REP = SHARD_CASES[2][1]
#: the sharded scenario batch at 2 ranks: PrgDID(kmax=15, with_cns=False),
#: four draws at scale 1e-4 (test_scenario_init_and_steps' batch)
SHARD_SCEN = dict(kmax=15, n=4, scale=1e-4)


def _case_key(case):
    return "-".join(map(str, case))


def _shard_inputs(case):
    """The port's (qp, z, w, mask, r1..r4) of a SHARD_CASES case on the
    CPU, from tests/test_kkt.py's seeded numpy draws."""
    K, nx, nu, mc, L, seed = case[:6]
    qp = random_stage_qp(K, nx, nu, mc, seed=seed)
    z, w, mask = random_zw(qp, seed=1)
    r = random_rhs(qp, seed=2)
    return (convert.stage_qp(qp, CPU), convert.ineq(z, CPU),
            convert.ineq(w, CPU), convert.ineq(mask, CPU), _t(r[0]),
            convert.eq(r[1], CPU), convert.ineq(r[2], CPU),
            convert.ineq(r[3], CPU))


def _scenario_batch():
    """SHARD_SCEN's program, draws and Q blocks on the CPU."""
    prg = PrgDID(kmax=SHARD_SCEN["kmax"], with_cns=False, device=CPU)
    v = tscen.batched_qp(prg, prg.setup(), SHARD_SCEN["n"],
                         scale=SHARD_SCEN["scale"], seed=0)
    Q = (1e-2 * torch.eye(prg.nv, dtype=torch.float64)).expand(
        SHARD_SCEN["n"], prg.K + 1, prg.nv, prg.nv)
    return prg, v, Q


def _scenario_solve(prg, v, Q):
    """make_scenario_solve with Mehrotra(PartitionedKKT(L=5)): (x, iter,
    result) of every scenario."""
    st, _ = tscen.make_scenario_solve(
        prg, Mehrotra(backend=PartitionedKKT(L=5)))(v, Q)
    return st.x, st.iter, st.result


#: one rank of a gloo group on the CPU, importing only the port (argv:
#: world size, rank, work directory): joins the group through a file store
#: in the directory, then for each case of cases.pt factors and solves with
#: ShardedPartitionedKKT over global_mesh(("sp",)) and records the
#: direction, the true KKT residual, the master's scaling and its count of
#: interiors; then the edge exchanges of a rank-valued row; with scen.pt,
#: its share of the scenario batch (_scenario_solve's) through shard_batch /
#: make_scenario_solve / gather_batch over make_mesh(axes=("dp",)); saves
#: all as rank<r>.pt
_RANK = r"""
import os, sys
import torch
from hqp_tpu_torch.models.did import PrgDID
from hqp_tpu_torch.parallel import distributed as D, scenarios as S
from hqp_tpu_torch.parallel import sharded_kkt as SK
from hqp_tpu_torch.parallel.sharded_kkt import ShardedPartitionedKKT
from hqp_tpu_torch.qp.kkt import kkt_residual
from hqp_tpu_torch.qp.kkt_partitioned import PartitionedKKT
from hqp_tpu_torch.qp.mehrotra import Mehrotra
torch.set_num_threads(1)
n, rank, where = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert D.init_distributed(f"file://{where}/store", n, rank, device="cpu")
out = {"summary": D.process_summary()}
mesh = D.global_mesh(("sp",))
for key, (L, kw, args) in torch.load(os.path.join(where, "cases.pt"),
                                     weights_only=False).items():
    qp, z, w, mask, *rhs = args
    be = ShardedPartitionedKKT(mesh, L=L, **kw)
    c0 = SK.COLLECTIVES
    fac = be.factor(qp, z, w, mask)
    sol = be.solve(fac, qp, z, w, mask, *rhs)
    *_, res = kkt_residual(qp, z, w, mask, *rhs, *sol)
    out[key] = dict(dx=sol[0], dyn=sol[1]["dyn"], res=float(res),
                    dM=fac.dM, parts=fac.Minv.shape[0],
                    L=be._choose_L(qp.K, qp.nx, qp.nu),
                    collectives=SK.COLLECTIVES - c0)
row = torch.arange(3.0) + 10.0 * rank
out["halo"] = (be.from_left(row), be.from_right(row))
scen = os.path.join(where, "scen.pt")
if os.path.exists(scen):
    kmax, v, Q = torch.load(scen)
    prg = PrgDID(kmax=kmax, with_cns=False, device="cpu")
    prg.setup()
    dp = S.make_mesh(axes=("dp",))
    st, _ = S.make_scenario_solve(prg, Mehrotra(
        backend=PartitionedKKT(L=5)))(*S.shard_batch((v, Q), dp))
    out["scen"] = S.gather_batch((st.x, st.iter, st.result), dp)
torch.save(out, os.path.join(where, f"rank{rank}.pt"))
D.dist.destroy_process_group()
"""


class RankGroups:
    """The gloo groups of SHARD_CASES' world sizes 2 and 4 (at most two
    spawned groups), each rank an interpreter of its own (_RANK), started
    with the module's first test at a lower priority (lower_priority) so
    that they run beside the other tests;
    ``result(n)`` waits for group n within its own timeout and returns
    every rank's record."""

    TIMEOUT = 300

    def __init__(self, request, tmp):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        wanted = any(it.module is request.module and getattr(
            it, "originalname", "") == "test_sharded_kkt_spawned_ranks"
            for it in request.session.items)
        self.groups, self.t0 = {}, time.monotonic()
        for n in (2, 4) if wanted else ():
            where = str(tmp / f"ranks{n}")
            os.makedirs(where)
            cases = {}
            for case in SHARD_CASES[n]:
                kw = SHARD_KW[case[6]] if len(case) > 6 else {}
                cases[_case_key(case)] = (case[4], kw, _shard_inputs(case))
            torch.save(cases, os.path.join(where, "cases.pt"))
            if n == 2:
                _, v, Q = _scenario_batch()
                torch.save((SHARD_SCEN["kmax"], v, Q.contiguous()),
                           os.path.join(where, "scen.pt"))
            self.groups[n] = (where, [subprocess.Popen(
                [sys.executable, "-c", _RANK, str(n), str(r), where],
                cwd=root, env=dict(os.environ, PYTHONPATH=root),
                stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                preexec_fn=lower_priority) for r in range(n)])

    def result(self, n):
        where, procs = self.groups[n]
        for r, proc in enumerate(procs):
            left = self.TIMEOUT - (time.monotonic() - self.t0)
            try:
                _, err = proc.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                self.close()
                pytest.fail(f"the {n}-rank group took over {self.TIMEOUT} s")
            assert proc.returncode == 0, f"rank {r}/{n}: {err[-3000:]}"
        return [torch.load(os.path.join(where, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]

    def close(self):
        for _, procs in self.groups.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def rank_groups(request, tmp_path_factory):
    """This module's RankGroups."""
    groups = RankGroups(request, tmp_path_factory.mktemp("ranks"))
    yield groups
    groups.close()


def _hold_sharded(got, case, tol_dM=1e-10):
    """One sharded solve of ``case`` (a rank's record) against the port's
    PartitionedKKT at the same partition length and the true KKT residual:
    residual < 1e-8, dx and dy within rtol 1e-5, atol 1e-6 (the
    reference's sharded tolerances: both directions are refined to their
    own floor); the master's scaling within ``tol_dM``."""
    qp, z, w, mask, *rhs = _shard_inputs(case)
    one = PartitionedKKT(L=got["L"])
    fac = one.factor(qp, z, w, mask)
    dx, dy, _, _ = one.solve(fac, qp, z, w, mask, *rhs)
    assert got["res"] < 1e-8
    np.testing.assert_allclose(_np(got["dx"]), _np(dx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(got["dyn"]), _np(dy["dyn"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(got["dM"]), _np(fac.dM), rtol=tol_dM,
                               atol=1e-12)
    return qp.K // got["L"]


def test_init_distributed_is_a_noop_without_environment(monkeypatch):
    """With no address, world size or rank, in the arguments or in the
    torch.distributed environment, init_distributed initializes nothing
    and returns False; the summary says so."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert tdist.init_distributed(device=CPU) is False
    assert not dist.is_initialized()
    assert tdist.process_summary().startswith("process 0/1")
    with pytest.raises(RuntimeError, match="init_distributed"):
        tdist.global_mesh()


def test_sharded_kkt_one_rank():
    """SHARD_CASES[1] by ShardedPartitionedKKT at world size 1 in this
    process (a gloo group on an in-process store, made without a
    launcher): within the reference's tolerances of PartitionedKKT and
    the true KKT residual, in both layouts (full_shard True and False,
    the latter with PartitionedKKT's other keywords); qp_mat_solver
    SpSCdist makes it; P must divide over the ranks (_choose_L kept as
    the reference's)."""
    assert tdist.init_distributed(world_size=1, device=CPU)
    try:
        mesh = tdist.global_mesh(("sp",))
        assert tdist.process_summary().startswith("process 0/1")
        case = SHARD_CASES[1][0]
        be = modules.create("qp_mat_solver", "SpSCdist", mesh, L=case[4])
        assert type(be) is ShardedPartitionedKKT and be.ndev == 1
        qp, z, w, mask, *rhs = _shard_inputs(case)
        fac = be.factor(qp, z, w, mask)
        sol = be.solve(fac, qp, z, w, mask, *rhs)
        *_, res = tkkt.kkt_residual(qp, z, w, mask, *rhs, *sol)
        got = dict(dx=sol[0], dyn=sol[1]["dyn"], res=float(res), dM=fac.dM,
                   L=be._choose_L(qp.K, qp.nx, qp.nu))
        assert fac.Minv.shape[0] == _hold_sharded(got, case)
        # the other layout, and PartitionedKKT's keywords passed through
        kw = dict(full_shard=False, gj="xla", refine_relative=False,
                  refine_eps=1e-12, reg_corr_rounds=1)
        rep = ShardedPartitionedKKT(mesh, L=case[4], **kw)
        assert [getattr(rep, k) for k in kw] == list(kw.values())
        assert rep == ShardedPartitionedKKT(mesh, L=case[4], **kw) != be
        sol = rep.solve(rep.factor(qp, z, w, mask), qp, z, w, mask, *rhs)
        *_, res = tkkt.kkt_residual(qp, z, w, mask, *rhs, *sol)
        _hold_sharded(dict(got, dx=sol[0], dyn=sol[1]["dyn"],
                           res=float(res)), case)
        two = tdist.global_mesh(("dp", "sp"))
        assert two.shape == (1, 1) and two.mesh_dim_names == ("dp", "sp")
        assert tscen.make_mesh(axes=("dp",)).shape == (1,)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_kkt_spawned_ranks(rank_groups, background, ranks):
    """SHARD_CASES[ranks] in a gloo group of ``ranks`` processes (RankGroups):
    every rank holds the same direction and master scaling, each case
    within the reference's tolerances of PartitionedKKT and the true KKT
    residual, each rank holding P/ranks interiors; the edge exchange
    gives each rank its neighbours' rows and the first and last ranks
    zeros, as a non-cyclic ppermute does.  At 4 ranks SHARD_JAX agrees
    with the JAX package's sharded solve on its 4-device mesh (rtol 1e-5,
    atol 1e-6); at 2 ranks the scenario batch sharded over the ranks gives
    the rows of the unsharded batch (verdict and IP count, x within
    1e-10), and its case with full_shard=False agrees with the JAX
    package's full_shard=False solve (dx within 1e-8; see
    :func:`reference_result`) at fewer collectives than the full-shard
    layout."""
    outs = rank_groups.result(ranks)
    for case in SHARD_CASES[ranks]:
        key = _case_key(case)
        got = outs[0][key]
        for o in outs[1:]:
            for k in ("dx", "dyn", "dM"):
                assert torch.equal(o[key][k], got[k]), (key, k)
        P = _hold_sharded(got, case)
        assert [o[key]["parts"] for o in outs] == [P // ranks] * ranks
    for r, o in enumerate(outs):
        assert o["summary"].startswith(f"process {r}/{ranks}")
        left, right = o["halo"]
        want_l = torch.zeros(3) if r == 0 else torch.arange(3.0) + 10.0 * (
            r - 1)
        want_r = torch.zeros(3) if r == ranks - 1 else \
            torch.arange(3.0) + 10.0 * (r + 1)
        assert torch.equal(left, want_l) and torch.equal(right, want_r)
    if ranks == 2:
        # full_shard=False: the reference's replicated solve around the
        # sharded reduced solves, with fewer collectives than the whole
        # solve on each rank's rows (none in the refinement's norms)
        ref = background.result("sharded_jax_rep")
        got = outs[0][_case_key(SHARD_REP)]
        np.testing.assert_allclose(_np(got["dx"]), ref["dx"], rtol=0,
                                   atol=1e-8)
        assert 0 < got["collectives"] < \
            outs[0][_case_key(SHARD_REP[:6])]["collectives"]
    if ranks == 4:
        ref = background.result("sharded_jax")
        got = outs[0][_case_key(SHARD_JAX)]
        np.testing.assert_allclose(_np(got["dx"]), ref["dx"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(got["dyn"]), ref["dyn"], rtol=1e-5,
                                   atol=1e-6)
    else:
        x, it, res = _scenario_solve(*_scenario_batch())
        for o in outs:
            sx, sit, sres = o["scen"]
            assert sit.tolist() == it.tolist()
            assert sres.tolist() == res.tolist() == [0] * SHARD_SCEN["n"]
            np.testing.assert_allclose(_np(sx), _np(x), rtol=0, atol=1e-10)


# -- the rest of the integrator family, against the background's reference --------


def integ_reference(name, prob):
    """The reference's side of test_new_integrator_matches_reference: one
    sample period of integrator ``name`` on ``prob`` for the three stages
    of _stage_inputs under vmap, and its jacfwd sensitivities to (x, u):
    {x, jac} (jac [dx/dx0, dx/du])."""
    from hqp_tpu.utils.registry import modules as jmodules
    ij = jmodules.create("prg_integrator", name, **NEW_INTEGRATORS[name][0])
    Fj = _problem_jax(prob)
    X, U, T0, KK = _stage_inputs(prob, seed=len(name))

    def fj(x, u, t0, kk):
        return ij.solve(Fj, kk, t0, t0 + 0.5, x, u)

    jargs = (jnp.asarray(X), jnp.asarray(U), jnp.asarray(T0),
             jnp.asarray(KK))
    jac = jax.vmap(jax.jacfwd(fj, argnums=(0, 1)))(*jargs)
    return dict(x=np.asarray(jax.vmap(fj)(*jargs)),
                jac=np.concatenate(jac, axis=-1))


@pytest.mark.parametrize("name,prob", INTEG_CASES)
def test_new_integrator_matches_reference(background, name, prob):
    """One sample period of each integrator of the slice (registered
    name; DASPK is BDF with the Newton-Krylov corrector) for three stages
    under the stage vmap, and its jacfwd sensitivities to (x, u), as
    Docp.eval_derivs runs them: values within 1e-12 and the Jacobian
    [dx/dx0, dx/du] within 1e-10 of the reference's (relative to the
    largest entry of each; the reference's side is :func:`integ_reference`,
    made in the background).  The adaptive loops run every stage in one
    loop whose stages stop at different iterations."""
    ref = background.result(f"integ-{name}-{prob}")
    it = modules_t.create("prg_integrator", name, **NEW_INTEGRATORS[name][0])
    Ft = _problem_torch(prob)
    X, U, T0, KK = _stage_inputs(prob, seed=len(name))

    def ft(x, u, t0, kk):
        return it.solve(Ft, kk, t0, t0 + 0.5, x, u)

    targs = (_t(X), _t(U), _t(T0), torch.as_tensor(KK))
    out = torch.func.vmap(ft)(*targs)
    assert np.isfinite(ref["x"]).all()
    assert _relmax(out.numpy(), ref["x"]) <= 1e-12
    jout = torch.func.vmap(torch.func.jacfwd(ft, argnums=(0, 1)))(*targs)
    assert _relmax(torch.cat(jout, dim=-1).numpy(), ref["jac"]) <= 1e-10


@pytest.mark.parametrize("name,n", [("lqblend", 100), ("broydn3d", 60),
                                    ("bdqrtic", 60), ("catena", 40),
                                    ("srosenbr", 60)])
def test_families_match_reference(background, name, n):
    """Each generated family at small n through solve_generated's
    configuration (Powell, FAMILY_HELA, Mehrotra(1e-9, 60)) with DenseKKT
    in both packages (the reference's in the background,
    :func:`family_reference`), the dense path that stays reachable through
    ``kkt_backend=DenseKKT()``: the same verdict, SQP and IP iterations, f
    within 1e-9 relative.  Catena has n + 1 link equalities on n heights,
    so its dense saddle matrix is singular: both packages end
    "degenerate" at the first QP (ROADMAP Q3 R12)."""
    js = types.SimpleNamespace(**background.result(f"family-{name}-{n}"))
    jres = js.res
    ts = SqpPowell(TG.FAMILIES[name](n=n, device=CPU), max_iters=200,
                   eps=1e-6, qp_solver=Mehrotra(eps=1e-9, max_iters=60),
                   kkt_backend=tkkt.DenseKKT(),
                   hela=modules.create("sqp_hela", TG.FAMILY_HELA[name]))
    ts.init()
    try:
        tres = ts.solve()
    except SqpError as e:
        tres = e.reason
    assert tres == jres == ("degenerate" if name == "catena" else "optimal")
    if tres == "optimal":
        assert (ts.iter, ts.qp_iters_total) == (js.iter, js.qp_iters_total)
        np.testing.assert_allclose(float(ts.f), float(js.f), rtol=1e-9,
                                   atol=1e-15)
        assert ts.norm_inf < 1e-6


@pytest.mark.parametrize("name", ESTIMATIONS)
def test_estimation_solves_match_reference(background, name):
    """Each estimation of chip_smoke.USER_CASES through SqpPowell in both
    packages (the reference's in the background), then confidence(): see
    :func:`check_user_solve`."""
    check_user_solve(name, **background.result("user-" + name))
