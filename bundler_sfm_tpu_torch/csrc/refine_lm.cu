// The new-camera refine LM, whole, in one launch, for Hopper (sm_90a), f64.
//
// Computes what bundler_sfm_tpu_torch/ops/lm.py::camera_refine_batch_plain
// computes (the port of `camera_refine`, lib/sfm-driver/sfm.c:1006-1190):
// for each lane (camera) of a batch, Levenberg-Marquardt over its 9
// parameters [c(3), w(3), f, k1, k2] against fixed 3D points, in the scaled
// space q = s*x (F_SCALE, K_SCALE), with the focal prior and the distortion
// shrink as penalty residuals, mu initialised from tau * max diag(J0'J0),
// the same accept rule, mu / nu updates and four stop tests, at most
// max_iters iterations; lanes outside `active` come back as given.  At the
// end w is folded into R = exp([w]x) R0 and zeroed in the camera.
//
// It replaces no Pallas kernel: the JAX package vmaps a lax.while_loop
// (bundler_sfm_tpu/ops/lm.py::camera_refine) and leaves it to XLA.  The
// port's tensor form ran that loop from the host, a few hundred small
// launches and one host read an iteration over lanes of at most a few
// dozen cameras and ~10^4 observations: the device did microseconds of work
// an iteration behind ~20 ms of dispatch.
//
// What bounds it on this card: latency.  An iteration is one pass over the
// lane's observations (~220 f64 operations each for the residual, its 2x9
// Jacobian rows and their 54 sums), a block reduction, a serial 9x9
// Cholesky solve, a second pass for the trial cost and a second reduction;
// a lane of 9000 observations is ~2 M f64 operations an iteration, ~15 us
// at one SM's 64 f64 FMA a clock, and the solve and the two reductions add
// a few microseconds of dependent steps that no parallelism shortens.  The
// design keeps everything on the SM for the whole call: one CTA a lane,
// the lane's state in shared memory, the loop in the kernel, no host read
// and no launch between iterations.  The Jacobian is in closed form (the
// rotation's derivative at the current w, with the same small-angle series
// branch as ops/rotations.py::rodrigues), so a pass reads each observation
// once and keeps J'J's 45 unique entries and J'r's 9 in registers.  Sums
// run in a fixed order (strided per thread, a shuffle tree per warp, warps
// in order), with no float atomics, so two launches give the same bits.
// Threads a CTA follow the padded observation count: 128 below 1024, else
// 256.  Lanes are independent and a call has few of them, so the grid is
// one CTA a lane and the card is mostly idle by design: the work a lane
// can share out is bounded by its observations.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CNP = 9;
constexpr int NH = CNP * (CNP + 1) / 2;   // unique entries of J'J (45)
constexpr int NSUM = NH + CNP;            // ... and J'r (54)
constexpr double F_SCALE = 0.001;         // ops/ba.py
constexpr double K_SCALE = 5.0;
constexpr double DBL_EPS = 2.220446049250313e-16;    // torch.finfo.eps
constexpr double DBL_TINY = 2.2250738585072014e-308; // torch.finfo.tiny

// Packed lower triangle: entry (i, j), j <= i.
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// exp([w]x) R0 into R; with M, also d(exp([w]x))/dw_k R0 into M[9k..9k+8].
// The rotation is ops/rotations.py::rodrigues: a = sin t / t, b = (1 - cos
// t) / t^2 with t = sqrt(|w|^2 + 1e-300), and the series 1 - t^2/6, 1/2 -
// t^2/24 below |w|^2 = 1e-16 (where every LM run starts).
__device__ void rotation(const double* w, const double* R0, double* R,
                         double* M) {
  const double t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const double t = sqrt(t2 + 1e-300);
  double a, b, da[3], db[3];
  if (t2 < 1e-16) {
    a = 1.0 - t2 / 6.0;
    b = 0.5 - t2 / 24.0;
    for (int k = 0; k < 3; ++k) {
      da[k] = -w[k] / 3.0;
      db[k] = -w[k] / 12.0;
    }
  } else {
    const double s = sin(t), c = cos(t);
    a = s / t;
    b = (1.0 - c) / t2;
    const double dadt = (c * t - s) / (t * t);
    for (int k = 0; k < 3; ++k) {
      const double dt = w[k] / t;
      da[k] = dadt * dt;
      db[k] = s * dt / t2 - (1.0 - c) * 2.0 * w[k] / (t2 * t2);
    }
  }
  const double W[9] = {0.0, -w[2], w[1], w[2], 0.0, -w[0], -w[1], w[0], 0.0};
  double W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] +
                      W[3 * i + 2] * W[6 + j];
  double Rw[9];
  for (int e = 0; e < 9; ++e)
    Rw[e] = (e % 4 == 0 ? 1.0 : 0.0) + a * W[e] + b * W2[e];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = Rw[3 * i] * R0[j] + Rw[3 * i + 1] * R0[3 + j] +
                     Rw[3 * i + 2] * R0[6 + j];
  if (M == nullptr) return;
  for (int k = 0; k < 3; ++k) {
    // E = [e_k]x; dRw/dw_k = da W + a E + db W^2 + b (E W + W E).
    double E[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    if (k == 0) { E[5] = -1.0; E[7] = 1.0; }
    if (k == 1) { E[2] = 1.0; E[6] = -1.0; }
    if (k == 2) { E[1] = -1.0; E[3] = 1.0; }
    double D[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        double ew = 0.0, we = 0.0;
        for (int m = 0; m < 3; ++m) {
          ew += E[3 * i + m] * W[3 * m + j];
          we += W[3 * i + m] * E[3 * m + j];
        }
        const int e = 3 * i + j;
        D[e] = da[k] * W[e] + a * E[e] + db[k] * W2[e] + b * (ew + we);
      }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        M[9 * k + 3 * i + j] = D[3 * i] * R0[j] + D[3 * i + 1] * R0[3 + j] +
                               D[3 * i + 2] * R0[6 + j];
  }
}

// One observation under camera (R, cam): p = R (X - c), n = -p.xy / p.z,
// the residual f n (1 + k1 |n|^2 + k2 |n|^4) - proj (ops/projection.py's
// Snavely model).
struct Obs {
  double d[3], p[3], iz, n[2], rsq, fac, r[2];
};

__device__ __forceinline__ void observe(const double* R, const double* cam,
                                        const double* X, const double* P,
                                        Obs& o) {
  for (int m = 0; m < 3; ++m) o.d[m] = X[m] - cam[m];
  for (int m = 0; m < 3; ++m)
    o.p[m] = R[3 * m] * o.d[0] + R[3 * m + 1] * o.d[1] + R[3 * m + 2] * o.d[2];
  o.iz = 1.0 / o.p[2];
  o.n[0] = -o.p[0] * o.iz;
  o.n[1] = -o.p[1] * o.iz;
  o.rsq = o.n[0] * o.n[0] + o.n[1] * o.n[1];
  o.fac = 1.0 + cam[7] * o.rsq + cam[8] * o.rsq * o.rsq;
  o.r[0] = cam[6] * o.n[0] * o.fac - P[0];
  o.r[1] = cam[6] * o.n[1] * o.fac - P[1];
}

// Fixed-order sum over the CTA of v[0..K-1] (each thread's partial): a
// shuffle tree per warp, then the warps in order; the totals land in out
// (shared), visible to every thread on return.
template <int T, int K>
__device__ __forceinline__ void block_sum(double (&v)[K],
                                          double (*part)[NSUM], double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) part[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    double s = part[0][threadIdx.x];
    for (int w = 1; w < T / 32; ++w) s += part[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// 0.5 |r|^2 over the lane's observations and its three penalties.
template <int T>
__device__ double cost_pass(const double* R, const double* cam,
                            const double* X, const double* P,
                            const uint8_t* mask, int N, double sfw, double fc,
                            double sdw, double (*part)[NSUM], double* out) {
  double acc[1] = {0.0};
  for (int i = threadIdx.x; i < N; i += T) {
    if (!mask[i]) continue;
    Obs o;
    observe(R, cam, X + 3 * i, P + 2 * i, o);
    acc[0] += o.r[0] * o.r[0] + o.r[1] * o.r[1];
  }
  block_sum<T, 1>(acc, part, out);
  const double p0 = sfw * (cam[6] - fc), p1 = sdw * cam[7], p2 = sdw * cam[8];
  return 0.5 * (out[0] + (p0 * p0 + p1 * p1 + p2 * p2));
}

// J'J (packed lower, 45) and J'r (9) of the scaled Jacobian over the
// lane's observations, into out[0..53]; penalties not included.
template <int T>
__device__ void normal_pass(const double* R, const double* M,
                            const double* cam, const double* scale,
                            const double* X, const double* P,
                            const uint8_t* mask, int N,
                            double (*part)[NSUM], double* out) {
  double acc[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) acc[k] = 0.0;
  const double f = cam[6];
  for (int i = threadIdx.x; i < N; i += T) {
    if (!mask[i]) continue;
    Obs o;
    observe(R, cam, X + 3 * i, P + 2 * i, o);
    // d(f n fac)/dn = G = f (fac I + 2 fac' n n'), fac' = k1 + 2 k2 |n|^2,
    // and dn/dp = -iz [[1, 0, n0], [0, 1, n1]]: row r of d(residual)/dp is
    // A = G[r] dn/dp.
    const double fp = cam[7] + 2.0 * cam[8] * o.rsq;
    const double g00 = f * (o.fac + 2.0 * fp * o.n[0] * o.n[0]);
    const double g01 = f * (2.0 * fp * o.n[0] * o.n[1]);
    const double g11 = f * (o.fac + 2.0 * fp * o.n[1] * o.n[1]);
    const double G[2][2] = {{g00, g01}, {g01, g11}};
    double Mw[3][3];   // dp/dw_k = M_k (X - c)
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int m = 0; m < 3; ++m)
        Mw[k][m] = M[9 * k + 3 * m] * o.d[0] + M[9 * k + 3 * m + 1] * o.d[1] +
                   M[9 * k + 3 * m + 2] * o.d[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const double A[3] = {-G[r][0] * o.iz, -G[r][1] * o.iz,
                           -(G[r][0] * o.n[0] + G[r][1] * o.n[1]) * o.iz};
      double J[CNP];
#pragma unroll
      for (int j = 0; j < 3; ++j)   // dp/dc = -R
        J[j] = -(A[0] * R[j] + A[1] * R[3 + j] + A[2] * R[6 + j]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        J[3 + k] = A[0] * Mw[k][0] + A[1] * Mw[k][1] + A[2] * Mw[k][2];
      J[6] = o.n[r] * o.fac;
      J[7] = f * o.n[r] * o.rsq;
      J[8] = f * o.n[r] * o.rsq * o.rsq;
#pragma unroll
      for (int j = 0; j < CNP; ++j) J[j] *= scale[j];
#pragma unroll
      for (int a = 0; a < CNP; ++a) {
#pragma unroll
        for (int b = 0; b <= a; ++b) acc[tri(a, b)] += J[a] * J[b];
        acc[NH + a] += J[a] * o.r[r];
      }
    }
  }
  block_sum<T, NSUM>(acc, part, out);
}

// Solve (H + mu I) x = g for the 9x9 SPD system, H packed lower, as
// ops/linalg_small.py::cholesky_unrolled / cholesky_substitute do (no
// pivoting; each pivot clamped at the smallest normal double).
__device__ void cholesky_solve9(const double* H, double mu, const double* g,
                                double* x) {
  double L[NH];
  for (int j = 0; j < CNP; ++j) {
    double s = H[tri(j, j)] + mu;
    for (int k = 0; k < j; ++k) s -= L[tri(j, k)] * L[tri(j, k)];
    const double d = sqrt(fmax(s, DBL_TINY));
    L[tri(j, j)] = d;
    for (int i = j + 1; i < CNP; ++i) {
      double v = H[tri(i, j)];
      for (int k = 0; k < j; ++k) v -= L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = v / d;
    }
  }
  double y[CNP];
  for (int i = 0; i < CNP; ++i) {
    double v = g[i];
    for (int k = 0; k < i; ++k) v -= L[tri(i, k)] * y[k];
    y[i] = v / L[tri(i, i)];
  }
  for (int i = CNP - 1; i >= 0; --i) {
    double v = y[i];
    for (int k = i + 1; k < CNP; ++k) v -= L[tri(k, i)] * x[k];
    x[i] = v / L[tri(i, i)];
  }
}

template <int T>
__global__ void __launch_bounds__(T) refine_lm_kernel(
    const double* __restrict__ cam0, const double* __restrict__ R0,
    const double* __restrict__ X, const double* __restrict__ P,
    const uint8_t* __restrict__ mask, const double* __restrict__ fc,
    const double* __restrict__ fw, const uint8_t* __restrict__ active, int N,
    int adjust_focal, int free_k, double dw, int max_iters, double tau,
    double* __restrict__ cam_out, double* __restrict__ R_out,
    double* __restrict__ cost_out, int* __restrict__ iters_out) {
  __shared__ double part[T / 32][NSUM];
  __shared__ double sums[NSUM];
  __shared__ double s_R0[9], s_cam[CNP], s_R[9], s_M[27], s_trial[CNP],
      s_Rt[9], s_scale[CNP];
  __shared__ int s_stop;
  const int lane = blockIdx.x, tid = threadIdx.x;
  const size_t base = static_cast<size_t>(lane) * N;
  X += 3 * base;
  P += 2 * base;
  mask += base;
  // Fixed parameters (focal unless adjust_focal, distortion unless free_k)
  // take a zero column, a 1 on H's diagonal and no step.
  bool fixed[CNP];
  for (int j = 0; j < CNP; ++j)
    fixed[j] = (j == 6 && !adjust_focal) || (j >= 7 && !free_k);
  if (tid < CNP) {
    s_cam[tid] = cam0[CNP * lane + tid];
    s_R0[tid] = R0[9 * lane + tid];
    const double inv_s = tid == 6 ? 1.0 / F_SCALE
                         : tid >= 7 ? 1.0 / K_SCALE : 1.0;
    s_scale[tid] = fixed[tid] ? 0.0 : inv_s;
  }
  __syncthreads();
  const double sfw = sqrt(fw[lane]), sdw = sqrt(dw), fcl = fc[lane];
  if (tid == 0) rotation(s_cam + 3, s_R0, s_R, nullptr);
  __syncthreads();
  double cost = cost_pass<T>(s_R, s_cam, X, P, mask, N, sfw, fcl, sdw, part,
                             sums);
  // Thread 0 alone carries the LM state (mu, nu, and the step's numbers);
  // every thread keeps the cost pass's result.
  double mu = 0.0, nu = 2.0, gmax = 0.0, dnorm = 0.0, pred = 0.0;
  int it = 0;
  if (active[lane]) {
    while (it < max_iters) {
      if (tid == 0) rotation(s_cam + 3, s_R0, s_R, s_M);
      __syncthreads();
      normal_pass<T>(s_R, s_M, s_cam, s_scale, X, P, mask, N, part, sums);
      if (tid == 0) {
        double H[NH], g[CNP], delta[CNP];
        for (int k = 0; k < NH; ++k) H[k] = sums[k];
        for (int k = 0; k < CNP; ++k) g[k] = sums[NH + k];
        // The penalty rows: sqrt(fw) (f - fc) on f, sqrt(dw) k on k1, k2.
        const double jp[3] = {sfw * s_scale[6], sdw * s_scale[7],
                              sdw * s_scale[8]};
        const double rp[3] = {sfw * (s_cam[6] - fcl), sdw * s_cam[7],
                              sdw * s_cam[8]};
        for (int m = 0; m < 3; ++m) {
          H[tri(6 + m, 6 + m)] += jp[m] * jp[m];
          g[6 + m] += jp[m] * rp[m];
        }
        if (it == 0) {   // mu from J0 (the first iteration's J)
          double dmax = H[0];
          for (int j = 1; j < CNP; ++j) dmax = fmax(dmax, H[tri(j, j)]);
          mu = tau * fmax(dmax, 1.0);
        }
        for (int j = 0; j < CNP; ++j)
          if (fixed[j]) H[tri(j, j)] += 1.0;
        cholesky_solve9(H, mu, g, delta);
        double dsq = 0.0, pr = 0.0;
        gmax = 0.0;
        for (int j = 0; j < CNP; ++j) {
          delta[j] = fixed[j] ? 0.0 : -delta[j];
          s_trial[j] = s_cam[j] + delta[j] * s_scale[j];
          gmax = fmax(gmax, fabs(g[j]));
          dsq += delta[j] * delta[j];
          pr += delta[j] * (mu * delta[j] - g[j]);
        }
        dnorm = sqrt(dsq);
        pred = 0.5 * pr;
        rotation(s_trial + 3, s_R0, s_Rt, nullptr);
      }
      __syncthreads();
      const double new_cost = cost_pass<T>(s_Rt, s_trial, X, P, mask, N, sfw,
                                           fcl, sdw, part, sums);
      ++it;
      if (tid == 0) {
        const double rho = (cost - new_cost) / fmax(pred, 1e-300);
        const bool accept = new_cost < cost;
        double mu_next, nu_next;
        if (accept) {
          const double t = 2.0 * rho - 1.0;
          mu_next = mu * fmax(1.0 - t * t * t, 1.0 / 3.0);
          nu_next = 2.0;
        } else {
          mu_next = mu * nu;
          nu_next = nu * 2.0;
        }
        const bool converged =
            accept && (cost - new_cost) <= 1e2 * DBL_EPS * cost;
        s_stop = converged || gmax < 1e-12 || dnorm < 1e-14 ||
                 mu_next > 1e30;
        if (accept) {
          for (int j = 0; j < CNP; ++j) s_cam[j] = s_trial[j];
          cost = new_cost;
        }
        mu = mu_next;
        nu = nu_next;
      }
      __syncthreads();
      if (s_stop) break;
    }
  }
  if (tid == 0) {
    if (active[lane]) {
      rotation(s_cam + 3, s_R0, s_R, nullptr);
      for (int e = 0; e < 9; ++e) R_out[9 * lane + e] = s_R[e];
      for (int j = 0; j < CNP; ++j)
        cam_out[CNP * lane + j] = (j >= 3 && j < 6) ? 0.0 : s_cam[j];
    } else {
      for (int e = 0; e < 9; ++e) R_out[9 * lane + e] = s_R0[e];
      for (int j = 0; j < CNP; ++j) cam_out[CNP * lane + j] = s_cam[j];
    }
    cost_out[lane] = cost;
    iters_out[lane] = it;
  }
}

}  // namespace

extern "C" {

// cam0 [B,9], R0 [B,3,3], X [B,N,3], P [B,N,2] f64; mask [B,N], active [B]
// bytes (0 / 1); fc, fw [B] f64; free_k: estimate distortion; dw its
// penalty weight (0 unless free_k).  Writes cam [B,9] (w folded and
// zeroed), R [B,3,3], cost [B] and each lane's iteration count [B].
// Returns the launch's cudaError_t.
int refine_lm_f64(const double* cam0, const double* R0, const double* X,
                  const double* P, const uint8_t* mask, const double* fc,
                  const double* fw, const uint8_t* active, int B, int N,
                  int adjust_focal, int free_k, double dw, int max_iters,
                  double tau, double* cam_out, double* R_out,
                  double* cost_out, int* iters_out, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1024)
    refine_lm_kernel<128><<<B, 128, 0, s>>>(
        cam0, R0, X, P, mask, fc, fw, active, N, adjust_focal, free_k, dw,
        max_iters, tau, cam_out, R_out, cost_out, iters_out);
  else
    refine_lm_kernel<256><<<B, 256, 0, s>>>(
        cam0, R0, X, P, mask, fc, fw, active, N, adjust_focal, free_k, dw,
        max_iters, tau, cam_out, R_out, cost_out, iters_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
