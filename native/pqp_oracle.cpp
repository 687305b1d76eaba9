// pqp_oracle — single-threaded C++ float32 conformance oracle for the PQP
// multiplicative dual-update solver.
//
// Role in this framework (see SURVEY.md §2.2): an independent, native
// re-implementation of the algorithm semantics of the reference CPU program
// (PQP_CPU.c: dualization 440-498, theta 503-519, update 590-618,
// termination 673-687, primal recovery 352-360), used by the test suite to
// cross-validate the JAX solver on random instances where no golden
// file exists.  This is a fresh implementation — row-major math notation,
// std::vector storage, tolerances passed at runtime — not a copy of the
// reference source.
//
// Everything is float (binary32) on purpose: the reference's entire
// pipeline is float, and the point of the oracle is to pin down what a
// faithful float32 evaluation of the math produces.
//
// Build: see native/Makefile (g++ -O2 -shared).  Python binding: ctypes in
// pqp_for_mpc_tpu/native.py.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

using Vec = std::vector<float>;

// out(r,c) = A(r,k) * B(k,c); row-major, sequential k-accumulation in f32
// (same accumulation order as a textbook triple loop, which is what the
// reference's matrixMultiply performs).
Vec matmul(const Vec& A, const Vec& B, int r, int k, int c) {
  Vec out(static_cast<size_t>(r) * c, 0.0f);
  for (int i = 0; i < r; ++i) {
    for (int j = 0; j < c; ++j) {
      float acc = 0.0f;
      for (int p = 0; p < k; ++p) acc += A[i * k + p] * B[p * c + j];
      out[i * c + j] = acc;
    }
  }
  return out;
}

Vec transpose(const Vec& A, int r, int c) {
  Vec out(static_cast<size_t>(r) * c);
  for (int i = 0; i < r; ++i)
    for (int j = 0; j < c; ++j) out[j * r + i] = A[i * c + j];
  return out;
}

// Dense inverse via Gauss-Jordan elimination with partial pivoting, f32.
// (The reference uses an unpivoted variant, PQP_CPU.c:251-326; pivoting is
// a deliberate robustness improvement — on the well-conditioned Qp of these
// problems both agree far below the conformance tolerance.)
bool invert(const Vec& A, Vec& out, int n) {
  Vec aug(static_cast<size_t>(n) * 2 * n, 0.0f);
  const int w = 2 * n;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) aug[i * w + j] = A[i * n + j];
    aug[i * w + n + i] = 1.0f;
  }
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int rrow = col + 1; rrow < n; ++rrow)
      if (std::fabs(aug[rrow * w + col]) > std::fabs(aug[piv * w + col]))
        piv = rrow;
    if (aug[piv * w + col] == 0.0f) return false;
    if (piv != col)
      for (int j = 0; j < w; ++j) std::swap(aug[piv * w + j], aug[col * w + j]);
    const float d = aug[col * w + col];
    for (int j = 0; j < w; ++j) aug[col * w + j] /= d;
    for (int rrow = 0; rrow < n; ++rrow) {
      if (rrow == col) continue;
      const float f = aug[rrow * w + col];
      if (f == 0.0f) continue;
      for (int j = 0; j < w; ++j) aug[rrow * w + j] -= f * aug[col * w + j];
    }
  }
  out.assign(static_cast<size_t>(n) * n, 0.0f);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) out[i * n + j] = aug[i * w + n + j];
  return true;
}

struct Dual {
  Vec Qd, Fd;        // (N,N), (N)
  float Md = 0.0f;
  Vec Qdp_th, Qdn_th, Fdp, Fdn;  // split matrices/vectors
  Vec theta;         // (N) diagonal regularizer
};

// Qd = Gp Qp^-1 Gp', Fd = Gp Qp^-1 Fp + Kp, Md = Fp'Qp^-1 Fp - Mp,
// theta_i = max(rowsum(max(0,-Qd))_i, theta_floor), plus +/- splits.
Dual dualize(const Vec& Qp_inv, const Vec& Fp, float Mp, const Vec& Gp,
             const Vec& Kp, int N, int M, float theta_floor) {
  Dual d;
  Vec GQi = matmul(Gp, Qp_inv, N, M, M);
  Vec GpT = transpose(Gp, N, M);
  d.Qd = matmul(GQi, GpT, N, M, N);
  d.Fd = matmul(GQi, Fp, N, M, 1);
  for (int i = 0; i < N; ++i) d.Fd[i] += Kp[i];
  Vec QiF = matmul(Qp_inv, Fp, M, M, 1);
  float md = 0.0f;
  for (int i = 0; i < M; ++i) md += Fp[i] * QiF[i];
  d.Md = md - Mp;

  d.Qdp_th.assign(static_cast<size_t>(N) * N, 0.0f);
  d.Qdn_th.assign(static_cast<size_t>(N) * N, 0.0f);
  for (int i = 0; i < N; ++i) {
    float rowsum_neg = 0.0f;
    for (int j = 0; j < N; ++j) {
      const float q = d.Qd[i * N + j];
      const float qp = q > 0.0f ? q : 0.0f;
      const float qn = q < 0.0f ? -q : 0.0f;
      d.Qdp_th[i * N + j] = qp;
      d.Qdn_th[i * N + j] = qn;
      rowsum_neg += qn;
    }
    const float th = rowsum_neg > theta_floor ? rowsum_neg : theta_floor;
    d.theta.push_back(th);
    d.Qdp_th[i * N + i] += th;
    d.Qdn_th[i * N + i] += th;
  }
  d.Fdp.resize(N);
  d.Fdn.resize(N);
  for (int i = 0; i < N; ++i) {
    d.Fdp[i] = d.Fd[i] > 0.0f ? d.Fd[i] : 0.0f;
    d.Fdn[i] = d.Fd[i] < 0.0f ? -d.Fd[i] : 0.0f;
  }
  return d;
}

// U = -Qp^-1 (Fp + Gp' Y)
Vec recover_u(const Vec& Y, const Vec& Fp, const Vec& GpT, const Vec& Qp_inv,
              int N, int M) {
  Vec t = matmul(GpT, Y, M, N, 1);
  for (int i = 0; i < M; ++i) t[i] += Fp[i];
  Vec U = matmul(Qp_inv, t, M, M, 1);
  for (int i = 0; i < M; ++i) U[i] = -U[i];
  return U;
}

// J = 1/2 z'Qz + f'z + m/2
float cost(const Vec& z, const Vec& Q, const Vec& f, float m, int n) {
  Vec Qz = matmul(Q, z, n, n, 1);
  float quad = 0.0f, lin = 0.0f;
  for (int i = 0; i < n; ++i) {
    quad += z[i] * Qz[i];
    lin += f[i] * z[i];
  }
  return 0.5f * quad + lin + 0.5f * m;
}

}  // namespace

extern "C" {

// Solve one dense QP instance with the PQP multiplicative dual update.
// Inputs are row-major float32.  Returns 1 if converged, 0 if the iteration
// cap was hit, -1 if Qp_inv could not be... (never: Qp_inv is given; -1 if
// Qp_inv is singular when inverting to Qp for the primal cost).
//
// Convergence test = the reference's terminate() semantics
// (PQP_CPU.c:673-687): feasibility slack Kp + max(erc*Kp, eac) (no |Kp|),
// then Jp <= -Jd (only when strict != 0, as SolverConfig.strict_weak_duality),
// gap <= eaj, gap/|Jd| <= erj, all in f32.  The gap is Jp+Jd, or with
// gap_comp != 0 the complementarity form Y'(Qd Y + Fd)
// (SolverConfig.gap_from_complementarity).
// iters_out follows the reference's counter convention: h starts at 1 and
// the reported value is h at the first passing check (PQP_CPU.c:714-741).
int pqp_oracle_solve(const float* qp_inv, const float* fp, float mp,
                     const float* gp, const float* kp, int N, int M,
                     float erc, float eac, float eaj, float erj,
                     float theta_floor, float y0, long max_iters, int strict, int gap_comp,
                     float* u_out, float* y_out, long* iters_out,
                     float* jp_out, float* jd_out) {
  const Vec Qp_inv(qp_inv, qp_inv + static_cast<size_t>(M) * M);
  const Vec Fp(fp, fp + M);
  const Vec Gp(gp, gp + static_cast<size_t>(N) * M);
  const Vec Kp(kp, kp + N);

  Vec Qp;
  if (!invert(Qp_inv, Qp, M)) return -1;

  Dual d = dualize(Qp_inv, Fp, mp, Gp, Kp, N, M, theta_floor);
  Vec GpT = transpose(Gp, N, M);

  Vec Y(N, y0);
  Vec slack(N);
  for (int i = 0; i < N; ++i) {
    const float rel = erc * Kp[i];
    slack[i] = Kp[i] + (rel > eac ? rel : eac);
  }

  long h = 1;
  bool ok = false;
  float Jp = 0.0f, Jd = 0.0f;
  Vec U;
  while (h <= max_iters) {
    // terminate() check on the current iterate
    U = recover_u(Y, Fp, GpT, Qp_inv, N, M);
    Vec GpU = matmul(Gp, U, N, M, 1);
    bool feas = true;
    for (int i = 0; i < N; ++i)
      if (GpU[i] > slack[i]) { feas = false; break; }
    if (feas) {
      Jd = cost(Y, d.Qd, d.Fd, d.Md, N);
      Jp = cost(U, Qp, Fp, mp, M);
      float gap = Jp + Jd;
      if (gap_comp) {
        const Vec QdY = matmul(d.Qd, Y, N, N, 1);
        gap = 0.0f;
        for (int i = 0; i < N; ++i) gap += Y[i] * (QdY[i] + d.Fd[i]);
      }
      if (!(strict && Jp > -Jd) && !(gap > eaj) && !(gap / std::fabs(Jd) > erj)) {
        ok = true;
        break;
      }
    }
    // multiplicative update Y <- Y .* ((Qd^-+th)Y + Fd^-) ./ ((Qd^++th)Y + Fd^+)
    Vec num = matmul(d.Qdn_th, Y, N, N, 1);
    Vec den = matmul(d.Qdp_th, Y, N, N, 1);
    for (int i = 0; i < N; ++i)
      Y[i] *= (num[i] + d.Fdn[i]) / (den[i] + d.Fdp[i]);
    ++h;
  }
  if (!ok) {
    U = recover_u(Y, Fp, GpT, Qp_inv, N, M);
    Jd = cost(Y, d.Qd, d.Fd, d.Md, N);
    Jp = cost(U, Qp, Fp, mp, M);
  }
  for (int i = 0; i < M; ++i) u_out[i] = U[i];
  for (int i = 0; i < N; ++i) y_out[i] = Y[i];
  *iters_out = h;
  *jp_out = Jp;
  *jd_out = Jd;
  return ok ? 1 : 0;
}

// Dualize only (for unit tests of the transform): writes Qd (N*N), Fd (N),
// Md (1), theta (N).
void pqp_oracle_dualize(const float* qp_inv, const float* fp, float mp,
                        const float* gp, const float* kp, int N, int M,
                        float theta_floor, float* qd_out, float* fd_out,
                        float* md_out, float* theta_out) {
  const Vec Qp_inv(qp_inv, qp_inv + static_cast<size_t>(M) * M);
  const Vec Fp(fp, fp + M);
  const Vec Gp(gp, gp + static_cast<size_t>(N) * M);
  const Vec Kp(kp, kp + N);
  Dual d = dualize(Qp_inv, Fp, mp, Gp, Kp, N, M, theta_floor);
  for (size_t i = 0; i < d.Qd.size(); ++i) qd_out[i] = d.Qd[i];
  for (int i = 0; i < N; ++i) fd_out[i] = d.Fd[i];
  *md_out = d.Md;
  for (int i = 0; i < N; ++i) theta_out[i] = d.theta[i];
}

}  // extern "C"
