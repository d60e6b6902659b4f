// sparse_ldl.cpp -- host-side sparse symmetric factorization kernels.
//
// The PyTorch port's own copy of the JAX package's native/sparse_ldl.cpp,
// built by hqp_tpu_torch/ops/_build_host.py (g++ -O3 -shared -fPIC
// -std=c++17) and bound by hqp_tpu_torch/native.py.  The arithmetic is
// the original's, so that factors and solves stay bit for bit the
// reference's.  One addition: both factorizations count the pivots they
// floor at `reg` or pin to 1.0 (hqp_ldl_nfloored, hqp_bkp_npinned), so
// that a caller can see a singular matrix that the safeguard hid.
//
// Native counterpart of the reference's sparse factorization layer for the
// general-NLP path: reverse Cuthill-McKee ordering (role of hqp/sprcm.C
// sp_rcm_scan/sp_rcm_order) and a sparse LDL' factorization with diagonal
// regularization (role of meschach/meschext_hl.C spCHOLfac/spMODCHOLfac,
// the kernels behind the reference's Schur-complement KKT path
// Hqp_IpSpSC).  Pivot-free by design: the interior-point reduced KKT is
// quasidefinite after dual regularization, for which LDL' with a fixed
// ordering is backward stable (Vanderbei); iterative refinement upstream
// recovers full accuracy, exactly like the reference layers refinement
// over its factorizations (hqp/Hqp_IpMatrix.C).
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).
//
// Algorithm: up-looking LDL' using the elimination tree (the classic
// sparse-LDL scheme as described in T. Davis, "Direct Methods for Sparse
// Linear Systems", ch. 4) -- implemented from the textbook description.

#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering on the adjacency of a symmetric pattern.
// rowptr/colind: CSR of the full (both triangles) pattern, diagonal ignored.
// perm_out[k] = original index of the k-th reordered node.
// ---------------------------------------------------------------------------
void hqp_rcm_order(int n, const int *rowptr, const int *colind,
                   int *perm_out) {
    std::vector<int> degree(n);
    for (int i = 0; i < n; ++i) {
        int d = 0;
        for (int p = rowptr[i]; p < rowptr[i + 1]; ++p)
            if (colind[p] != i) ++d;
        degree[i] = d;
    }
    std::vector<char> visited(n, 0);
    std::vector<int> order;
    order.reserve(n);

    for (;;) {
        // pick unvisited node of minimum degree as the next component root
        int root = -1;
        for (int i = 0; i < n; ++i)
            if (!visited[i] && (root < 0 || degree[i] < degree[root]))
                root = i;
        if (root < 0) break;

        std::queue<int> q;
        q.push(root);
        visited[root] = 1;
        while (!q.empty()) {
            int u = q.front();
            q.pop();
            order.push_back(u);
            std::vector<int> nbrs;
            for (int p = rowptr[u]; p < rowptr[u + 1]; ++p) {
                int v = colind[p];
                if (v != u && !visited[v]) {
                    visited[v] = 1;
                    nbrs.push_back(v);
                }
            }
            std::sort(nbrs.begin(), nbrs.end(),
                      [&](int a, int b) { return degree[a] < degree[b]; });
            for (int v : nbrs) q.push(v);
        }
    }
    // reverse (the "R" in RCM)
    for (int k = 0; k < n; ++k) perm_out[k] = order[n - 1 - k];
}

// ---------------------------------------------------------------------------
// Sparse LDL' factorization handle
// ---------------------------------------------------------------------------
struct LdlHandle {
    int n;
    // input pattern (upper triangle, CSC == CSR of lower by symmetry)
    std::vector<int> Ap, Ai;        // column pointers / row indices, upper
    // elimination tree and L pattern
    std::vector<int> parent, Lp, Li;
    std::vector<double> Lx, D;
    int nfloored = 0;               // pivots floored at reg (last factor)
    // scratch
    std::vector<int> flag, pattern;
    std::vector<double> y;
};

// Create from the FULL symmetric CSR pattern; we keep the upper triangle
// in CSC form (column j holds rows i <= j), which for a symmetric pattern
// equals the CSR rows restricted to entries <= diagonal, transposed.
void *hqp_ldl_create(int n, const int *rowptr, const int *colind) {
    LdlHandle *h = new LdlHandle();
    h->n = n;
    // build upper-triangular CSC: column j: rows i < j with pattern(i, j),
    // plus the diagonal handled separately.
    std::vector<std::vector<int>> cols(n);
    for (int i = 0; i < n; ++i)
        for (int p = rowptr[i]; p < rowptr[i + 1]; ++p) {
            int j = colind[p];
            if (i < j) cols[j].push_back(i);
        }
    h->Ap.resize(n + 1);
    h->Ap[0] = 0;
    for (int j = 0; j < n; ++j) {
        std::sort(cols[j].begin(), cols[j].end());
        h->Ap[j + 1] = h->Ap[j] + (int)cols[j].size();
    }
    h->Ai.resize(h->Ap[n]);
    for (int j = 0; j < n; ++j)
        std::copy(cols[j].begin(), cols[j].end(),
                  h->Ai.begin() + h->Ap[j]);

    // symbolic: elimination tree + column counts of L (Davis ch. 4)
    h->parent.assign(n, -1);
    std::vector<int> ancestor(n, -1), Lnz(n, 0);
    h->flag.assign(n, -1);
    h->pattern.assign(n, 0);
    for (int k = 0; k < n; ++k) {
        h->flag[k] = k;
        for (int p = h->Ap[k]; p < h->Ap[k + 1]; ++p) {
            int i = h->Ai[p];
            while (h->flag[i] != k) {
                if (h->parent[i] == -1) h->parent[i] = k;
                ++Lnz[i];
                h->flag[i] = k;
                i = h->parent[i];
            }
        }
    }
    h->Lp.resize(n + 1);
    h->Lp[0] = 0;
    for (int k = 0; k < n; ++k) h->Lp[k + 1] = h->Lp[k] + Lnz[k];
    h->Li.resize(h->Lp[n]);
    h->Lx.resize(h->Lp[n]);
    h->D.resize(n);
    h->y.assign(n, 0.0);
    return (void *)h;
}

// Numeric factorization.  values: CSR values of the FULL matrix matching
// the (rowptr, colind) passed to create (we read upper incl. diagonal).
// rowptr/colind must be passed again (same arrays as create).
// reg: |D_k| is floored at reg (modified-Cholesky style safeguard,
// spMODCHOLfac role).  Returns 0 on success.
int hqp_ldl_factor(void *handle, const int *rowptr, const int *colind,
                   const double *values, double reg) {
    LdlHandle *h = (LdlHandle *)handle;
    int n = h->n;
    // gather upper-triangular values column-wise (incl. diagonal)
    std::vector<double> diag(n, 0.0);
    std::vector<double> Axv(h->Ap[n], 0.0);
    {
        std::vector<int> fill(n, 0);
        for (int i = 0; i < n; ++i)
            for (int p = rowptr[i]; p < rowptr[i + 1]; ++p) {
                int j = colind[p];
                if (i == j) diag[i] = values[p];
                else if (i < j) {
                    // locate position of row i in column j (sorted)
                    const int *beg = h->Ai.data() + h->Ap[j];
                    const int *end = h->Ai.data() + h->Ap[j + 1];
                    const int *it = std::lower_bound(beg, end, i);
                    Axv[(int)(it - h->Ai.data())] = values[p];
                }
            }
        (void)fill;
    }

    std::vector<int> Lnz(n, 0);
    h->nfloored = 0;
    for (int k = 0; k < n; ++k) {
        // pattern of row k of L = path union in etree
        int top = n;
        h->flag[k] = k;
        h->y[k] = 0.0;
        for (int p = h->Ap[k]; p < h->Ap[k + 1]; ++p) {
            int i = h->Ai[p];
            h->y[i] = Axv[p];
            int len = 0;
            std::vector<int> stack;
            while (h->flag[i] != k) {
                stack.push_back(i);
                h->flag[i] = k;
                i = h->parent[i];
                ++len;
            }
            while (len-- > 0) {
                h->pattern[--top] = stack[len];
            }
        }
        double d = diag[k];
        // sparse triangular solve along the pattern
        for (int s = top; s < n; ++s) {
            int i = h->pattern[s];
            double yi = h->y[i];
            h->y[i] = 0.0;
            int p2 = h->Lp[i] + Lnz[i];
            for (int p = h->Lp[i]; p < p2; ++p)
                h->y[h->Li[p]] -= h->Lx[p] * yi;
            double l_ki = yi / h->D[i];
            d -= l_ki * yi;
            h->Li[p2] = k;
            h->Lx[p2] = l_ki;
            ++Lnz[i];
        }
        // modified-Cholesky safeguard: keep |d| >= reg, preserve sign
        if (std::fabs(d) < reg) {
            d = (d >= 0.0 ? reg : -reg);
            ++h->nfloored;
        }
        h->D[k] = d;
        if (d == 0.0) return 1;
    }
    return 0;
}

// Solve in place: x <- (LDL')^-1 x
void hqp_ldl_solve(void *handle, double *x) {
    LdlHandle *h = (LdlHandle *)handle;
    int n = h->n;
    // forward: L y = b  (L stored column-wise: column i lists rows k > i)
    for (int i = 0; i < n; ++i) {
        double xi = x[i];
        for (int p = h->Lp[i]; p < h->Lp[i + 1]; ++p)
            x[h->Li[p]] -= h->Lx[p] * xi;
    }
    // diagonal
    for (int i = 0; i < n; ++i) x[i] /= h->D[i];
    // backward: L' x = y
    for (int i = n - 1; i >= 0; --i) {
        double s = x[i];
        for (int p = h->Lp[i]; p < h->Lp[i + 1]; ++p)
            s -= h->Lx[p] * x[h->Li[p]];
        x[i] = s;
    }
}

int hqp_ldl_nnz(void *handle) {
    return ((LdlHandle *)handle)->Lp[((LdlHandle *)handle)->n];
}

int hqp_ldl_nfloored(void *handle) {
    return ((LdlHandle *)handle)->nfloored;
}

void hqp_ldl_destroy(void *handle) { delete (LdlHandle *)handle; }

// ---------------------------------------------------------------------------
// Sparse Bunch-Kaufman-Parlett factorization (symmetric indefinite).
//
// Role of the reference's spBKP kernel family (hqp/spBKP.C spBKPfactor/
// spBKPsolve, hqp/matBKP.C, hqp/bdBKP.C; used by hqp/Hqp_IpSpBKP.C:179
// and Hqp_IpRedSpBKP.C:369 to factor the full/reduced interior-point KKT
// without assuming quasidefiniteness): P'AP = M D M' with M unit lower
// triangular and D block diagonal with 1x1 and 2x2 pivots, chosen by the
// Bunch-Kaufman-Parlett partial-pivoting test (Bunch/Kaufman/Parlett,
// Numer. Math. 27, 1976 -- alpha = (1+sqrt(17))/8).  The reference scales
// alpha by a `tol` knob (spBKP.C:392, `_tol` of Hqp_IpSpBKP) to trade
// stability for sparsity; `tol = 1` is the textbook test.
//
// Implementation is original: a right-looking elimination on
// full-symmetric hash-map rows (fill-in inserted dynamically), with
// symmetric position interchanges done by map relabeling.  This is a
// host-CPU kernel for the general sparse NLP path -- the TPU-structured
// problems use the batched device factorizations in hqp_tpu/qp/.
// ---------------------------------------------------------------------------

struct BkpHandle {
    int n;
    std::vector<int> perm;              // position -> original index
    // M (unit lower) stored row-wise: row k lists (col, val), col < k
    std::vector<int> Mp, Mi;
    std::vector<double> Mx;
    // D block tags: 1 = 1x1 pivot at k; 2 = first row of a 2x2 pivot;
    // 0 = second row of a 2x2 pivot
    std::vector<int> dtag;
    std::vector<double> d11, d12, d22;  // at block start positions
    int n2x2;
    int npinned;                        // 1x1 pivots floored at reg or
                                        // pinned to 1.0
};

namespace {

typedef std::vector<std::pair<int, double>> BkpRow;

inline double bkp_get(const BkpRow &r, int j) {
    for (const auto &e : r)
        if (e.first == j) return e.second;
    return 0.0;
}

inline void bkp_erase(BkpRow &r, int j) {
    for (size_t p = 0; p < r.size(); ++p)
        if (r[p].first == j) {
            r[p] = r.back();
            r.pop_back();
            return;
        }
}

inline void bkp_addto(BkpRow &r, int j, double v) {
    for (auto &e : r)
        if (e.first == j) {
            e.second += v;
            return;
        }
    r.emplace_back(j, v);
}

// swap the labels a <-> b inside one row (symmetric interchange helper)
inline void bkp_relabel(BkpRow &r, int a, int b) {
    for (auto &e : r) {
        if (e.first == a) e.first = b;
        else if (e.first == b) e.first = a;
    }
}

}  // namespace

// Factor the full-symmetric CSR matrix (both triangles present) with BKP
// pivoting.  tol scales the pivot test (1.0 = textbook Bunch-Kaufman;
// smaller favors sparsity over stability, spBKP.C:392).  reg floors a
// structurally singular 1x1 pivot (|d| < reg -> sign(d)*reg) instead of
// failing, the modified-factorization safeguard the reference layers via
// refinement.  Returns NULL only on allocation failure.
void *hqp_bkp_factor(int n, const int *rowptr, const int *colind,
                     const double *values, double tol, double reg) {
    BkpHandle *h = new BkpHandle();
    h->n = n;
    h->perm.resize(n);
    for (int i = 0; i < n; ++i) h->perm[i] = i;
    h->dtag.assign(n, 1);
    h->d11.assign(n, 0.0);
    h->d12.assign(n, 0.0);
    h->d22.assign(n, 0.0);
    h->n2x2 = 0;
    h->npinned = 0;

    // active rows: full symmetric storage (row i holds every active j,
    // including the diagonal); eliminated rows are cleared
    std::vector<BkpRow> R(n);
    for (int i = 0; i < n; ++i) {
        R[i].reserve(rowptr[i + 1] - rowptr[i] + 4);
        for (int p = rowptr[i]; p < rowptr[i + 1]; ++p)
            bkp_addto(R[i], colind[p], values[p]);
    }
    // M rows built during elimination (row j: entries at pivot columns)
    std::vector<BkpRow> Mrow(n);

    const double alpha = tol * 0.6403882032022076;  // tol*(1+sqrt(17))/8

    // symmetric interchange of positions a and b (a < b), both >= front i
    auto interchange = [&](int i, int a, int b) {
        if (a == b) return;
        std::swap(R[a], R[b]);
        for (int k = i; k < n; ++k) bkp_relabel(R[k], a, b);
        std::swap(Mrow[a], Mrow[b]);
        std::swap(h->perm[a], h->perm[b]);
    };

    std::vector<int> nbrs;
    std::vector<double> b1v, b2v;
    // dense scatter workspace: row updates in O(|row| + |nbrs|)
    std::vector<double> work(n, 0.0);
    std::vector<int> mark(n, -1);
    int stamp = 0;
    // apply work[col] += delta against row j (insert fill-in on miss)
    auto row_add = [&](BkpRow &row, int col, double delta) {
        if (mark[col] == stamp) {
            work[col] += delta;
        } else {
            mark[col] = stamp;
            work[col] = delta;
            row.emplace_back(col, 0.0);
        }
    };

    for (int i = 0; i < n;) {
        // lambda = max |a_ji|, j > i (column i == row i by symmetry)
        double lam = 0.0;
        int r = -1;
        double aii = 0.0;
        for (const auto &e : R[i]) {
            if (e.first == i) aii = e.second;
            else if (e.first > i) {
                double v = std::fabs(e.second);
                if (v > lam) { lam = v; r = e.first; }
            }
        }
        bool one = false;
        if (lam == 0.0 || std::fabs(aii) >= alpha * lam) {
            one = true;
        } else {
            // sigma = max |a_kr| over k >= i, k != r (row r by symmetry)
            double sigma = 0.0, arr = 0.0;
            for (const auto &e : R[r]) {
                if (e.first == r) arr = e.second;
                else if (e.first >= i)
                    sigma = std::max(sigma, std::fabs(e.second));
            }
            if (std::fabs(aii) * sigma >= alpha * lam * lam) {
                one = true;
            } else if (std::fabs(arr) >= alpha * sigma) {
                interchange(i, i, r);       // bring r to the front: 1x1
                one = true;
            } else {
                interchange(i, i + 1, r);   // pair (i, r) as a 2x2 pivot
                one = false;
            }
        }

        if (one) {
            double d = bkp_get(R[i], i);
            bool pinned = false;
            if (std::fabs(d) < reg) {
                d = (d >= 0.0 ? reg : -reg);
                pinned = true;
            }
            if (d == 0.0) {         // fully zero row: pin position
                d = 1.0;
                pinned = true;
            }
            if (pinned) ++h->npinned;
            h->dtag[i] = 1;
            h->d11[i] = d;
            nbrs.clear();
            b1v.clear();
            for (const auto &e : R[i])
                if (e.first > i) {
                    nbrs.push_back(e.first);
                    b1v.push_back(e.second);
                }
            for (size_t a = 0; a < nbrs.size(); ++a) {
                int j = nbrs[a];
                double mj = b1v[a] / d;
                Mrow[j].emplace_back(i, mj);
                ++stamp;
                for (auto &e : R[j]) {
                    work[e.first] = e.second;
                    mark[e.first] = stamp;
                }
                for (size_t b = 0; b < nbrs.size(); ++b)
                    row_add(R[j], nbrs[b], -mj * b1v[b]);
                for (auto &e : R[j]) e.second = work[e.first];
                bkp_erase(R[j], i);
            }
            BkpRow().swap(R[i]);
            i += 1;
        } else {
            int i1 = i + 1;
            double a11 = bkp_get(R[i], i);
            double a12 = bkp_get(R[i], i1);
            double a22 = bkp_get(R[i1], i1);
            double det = a11 * a22 - a12 * a12;
            // BKP guarantees |det| bounded away from 0 for a chosen 2x2
            h->dtag[i] = 2;
            h->dtag[i1] = 0;
            h->d11[i] = a11;
            h->d12[i] = a12;
            h->d22[i] = a22;
            ++h->n2x2;
            nbrs.clear();
            b1v.clear();
            b2v.clear();
            ++stamp;  // scatter row i1 for O(1) lookups
            for (const auto &e : R[i1]) {
                work[e.first] = e.second;
                mark[e.first] = stamp;
            }
            for (const auto &e : R[i])
                if (e.first > i1) {
                    nbrs.push_back(e.first);
                    b1v.push_back(e.second);
                    b2v.push_back(mark[e.first] == stamp
                                  ? work[e.first] : 0.0);
                    mark[e.first] = stamp - 1;  // consume
                }
            for (const auto &e : R[i1])
                if (e.first > i1 && mark[e.first] == stamp) {
                    // rows only coupled through i1
                    nbrs.push_back(e.first);
                    b1v.push_back(0.0);
                    b2v.push_back(e.second);
                }
            for (size_t a = 0; a < nbrs.size(); ++a) {
                int j = nbrs[a];
                // [m1 m2] = [b1 b2] * inv([[a11,a12],[a12,a22]])
                double m1 = (b1v[a] * a22 - b2v[a] * a12) / det;
                double m2 = (b2v[a] * a11 - b1v[a] * a12) / det;
                Mrow[j].emplace_back(i, m1);
                Mrow[j].emplace_back(i1, m2);
                ++stamp;
                for (auto &e : R[j]) {
                    work[e.first] = e.second;
                    mark[e.first] = stamp;
                }
                for (size_t b = 0; b < nbrs.size(); ++b)
                    row_add(R[j], nbrs[b],
                            -(m1 * b1v[b] + m2 * b2v[b]));
                for (auto &e : R[j]) e.second = work[e.first];
                bkp_erase(R[j], i);
                bkp_erase(R[j], i1);
            }
            BkpRow().swap(R[i]);
            BkpRow().swap(R[i1]);
            i += 2;
        }
    }

    // pack M rows (sorted by column) into CSR
    h->Mp.resize(n + 1);
    h->Mp[0] = 0;
    for (int k = 0; k < n; ++k) {
        std::sort(Mrow[k].begin(), Mrow[k].end());
        h->Mp[k + 1] = h->Mp[k] + (int)Mrow[k].size();
    }
    h->Mi.resize(h->Mp[n]);
    h->Mx.resize(h->Mp[n]);
    for (int k = 0; k < n; ++k)
        for (size_t p = 0; p < Mrow[k].size(); ++p) {
            h->Mi[h->Mp[k] + p] = Mrow[k][p].first;
            h->Mx[h->Mp[k] + p] = Mrow[k][p].second;
        }
    return (void *)h;
}

// Solve A x = b in place (x holds b on entry, the solution on exit),
// spBKPsolve role: x = P' (M D M')^{-1} P b.
void hqp_bkp_solve(void *handle, double *x) {
    BkpHandle *h = (BkpHandle *)handle;
    int n = h->n;
    std::vector<double> y(n);
    for (int k = 0; k < n; ++k) y[k] = x[h->perm[k]];
    // forward: M z = y (row-wise substitution, M unit lower)
    for (int k = 0; k < n; ++k) {
        double s = y[k];
        for (int p = h->Mp[k]; p < h->Mp[k + 1]; ++p)
            s -= h->Mx[p] * y[h->Mi[p]];
        y[k] = s;
    }
    // block-diagonal solve
    for (int k = 0; k < n;) {
        if (h->dtag[k] == 1) {
            y[k] /= h->d11[k];
            k += 1;
        } else {
            double det = h->d11[k] * h->d22[k] - h->d12[k] * h->d12[k];
            double z1 = y[k], z2 = y[k + 1];
            y[k] = (h->d22[k] * z1 - h->d12[k] * z2) / det;
            y[k + 1] = (h->d11[k] * z2 - h->d12[k] * z1) / det;
            k += 2;
        }
    }
    // backward: M' t = z, done as column saxpys off the row storage
    for (int k = n - 1; k >= 0; --k) {
        double yk = y[k];
        for (int p = h->Mp[k]; p < h->Mp[k + 1]; ++p)
            y[h->Mi[p]] -= h->Mx[p] * yk;
    }
    for (int k = 0; k < n; ++k) x[h->perm[k]] = y[k];
}

int hqp_bkp_nnz(void *handle) {
    return ((BkpHandle *)handle)->Mp[((BkpHandle *)handle)->n];
}

int hqp_bkp_n2x2(void *handle) { return ((BkpHandle *)handle)->n2x2; }

int hqp_bkp_npinned(void *handle) {
    return ((BkpHandle *)handle)->npinned;
}

void hqp_bkp_destroy(void *handle) { delete (BkpHandle *)handle; }

}  // extern "C"
