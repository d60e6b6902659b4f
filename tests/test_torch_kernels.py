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


@pytest.mark.parametrize("N,n", [(101, 2), (8, 3), (2, 2)])
def test_blocktri_matches_reference(N, n):
    """Equilibration, cyclic reduction and the block-Cholesky scan agree
    with the reference; the f64 Thomas twin agrees with CR (it is the
    master solve's other route)."""
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
    x_bc = dt * blocktri.solve(Lt, Wt, dt * _t(r))
    np.testing.assert_allclose(x_bc.numpy(), ref_bc, rtol=0, atol=1e-12)
    x_th = dt * thomas_cuda.thomas_solve(St, Ut, dt * _t(r))
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


def _solve_pair(jprg, tprg):
    """Both packages' SqpPowell(prg, max_iters=100), init(), solve()."""
    js = JSqpPowell(jprg, max_iters=100)
    js.init()
    jres = js.solve()
    ts = SqpPowell(tprg, max_iters=100)
    ts.init()
    return js, jres, ts, ts.solve()


def test_sqp_bio_matches_reference():
    """PrgBio(K=51), whose stages integrate by IMP(steps=4): the same
    result, SQP and IP iterations; f within 1e-8 relative."""
    js, jres, ts, tres = _solve_pair(JPrgBio(), PrgBio(device="cpu"))
    assert jres == tres == "optimal"
    assert (ts.iter, ts.qp_iters_total) == (js.iter, js.qp_iters_total)
    np.testing.assert_allclose(float(ts.f), float(js.f), rtol=1e-8, atol=0)


def test_sqp_crane50_matches_reference():
    """The slice as a whole: PrgCrane(K=50) through SqpPowell ->
    Mehrotra -> PartitionedKKT (interiors s = 124 on K1's register
    kernel route, master n = 6 on K2): the same result, SQP and IP
    iterations; f within 1e-9 relative.  (Not K=20: there the IP
    iteration count follows the last bits of the KKT solves near each
    QP's solution -- 114 in the reference, 121 and 112 in the port with
    its Thomas and CR masters; ROADMAP Q3.)"""
    js, jres, ts, tres = _solve_pair(JPrgCrane(K=50),
                                     PrgCrane(K=50, device="cpu"))
    assert jres == tres == "optimal"
    assert (ts.iter, ts.qp_iters_total) == (js.iter, js.qp_iters_total)
    np.testing.assert_allclose(float(ts.f), float(js.f), rtol=1e-9, atol=0)


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
