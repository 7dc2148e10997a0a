// Gauss-Newton RGB-D odometry, one pyramid level, for Hopper (sm_90a).
//
// Replaces: azurekinect3dreconstruction_tpu/ops/pallas/odometry_kernels.py,
// _make_level_kernel (launched by _level_fn). Each GN iteration is two
// launches on one stream, so all iterations of a frame stay on the device
// with no host synchronisation:
//
//   (a) akr_odometry_reduce: one thread per source pixel. It reads the pose
//       from device memory, back-projects the pixel, warps it into the
//       target, samples target intensity and depth bilinearly (in bounds
//       means 0 <= u < W-1, 0 <= v < H-1), forms the photometric and
//       geometric residuals, gates them, Huber-weights them, builds both
//       Jacobian rows from the SOURCE Sobel gradients (the gradient swap)
//       and reduces 21 JtJ + 6 Jtr + 3 count/cost sums over its CTA into
//       one partial row per CTA.
//   (b) akr_odometry_solve: one CTA sums the partial rows in a fixed order,
//       one warp per sum (no float atomics, so the pose is the same from
//       run to run), adds
//       the damping, solves the Jacobi-equilibrated 6x6 system by Cholesky,
//       zeroes a non-finite step, applies the se3 exp, left-composes the
//       pose and writes pose, fitness, rmse, n_valid and the convergence
//       flag.
//
// What bounds it: at 640x576 a level-0 iteration reads 8 float planes
// (6 source, 2 target at 4 bilinear taps) — about 12 MB, all of it resident
// in the 50 MB L2 across iterations — and does ~250 flops per pixel, so it
// is bound by launch latency and the two-pass reduction more than by DRAM.
// The design keeps it to one pass over the pixels per iteration and a
// single tiny tail; the partial rows (30 floats per CTA) never leave L2.
// The TPU kernel's VMEM windows, skewed target windows and lane placement
// have no counterpart here: the gathers go straight to global memory.
//
// State layout (float[16], device): [0..11] pose 3x4 row-major (target from
// source), [12] convergence flag, [13] fitness, [14] rmse, [15] n_valid.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 30;  // 21 JtJ (upper triangle, row-major) + 6 Jtr + 3 counts

struct OdoParams {
  float fx, fy, cx, cy, min_d, max_d, max_dd, s_i, s_d, delta, term_i, term_d, damping, tol2;
};

__device__ __forceinline__ float huber(float r, float s, float delta) {
  const float a = fabsf(r * s);
  return a <= delta ? 1.0f : delta / fmaxf(a, 1e-12f);
}

__device__ __forceinline__ float bilinear(const float* img, int W, int iu, int iv, float fu,
                                          float fv) {
  const float* p = img + iv * W + iu;
  return p[0] * (1.f - fu) * (1.f - fv) + p[1] * fu * (1.f - fv) + p[W] * (1.f - fu) * fv +
         p[W + 1] * fu * fv;
}

// dp'/dxi contracted with a point Jacobian (jx, jy, jz): [I | -hat(p')]
__device__ __forceinline__ void dp_dxi(float jx, float jy, float jz, float px, float py,
                                       float pz, float* J) {
  J[0] = jx;
  J[1] = jy;
  J[2] = jz;
  J[3] = -jy * pz + jz * py;
  J[4] = jx * pz - jz * px;
  J[5] = -jx * py + jy * px;
}

__global__ void __launch_bounds__(kThreads)
odometry_reduce_kernel(const float* __restrict__ src, const float* __restrict__ tgt, int H,
                       int W, const float* __restrict__ state, float* __restrict__ partials,
                       OdoParams p) {
  if (state[12] != 0.f) return;  // level converged: skip the remaining iterations
  __shared__ float warp_sums[kWarps][kSums];
  const int HW = H * W;
  const int idx = blockIdx.x * kThreads + threadIdx.x;

  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;

  if (idx < HW) {
    const int v = idx / W, u = idx % W;
    const float i_s = src[idx], z = src[HW + idx];
    // the warp decides which pixels are in bounds (at the identity pose a
    // whole border column sits on the edge), so its multiply-adds are fused
    // exactly as in the plain version and nowhere else
    const float xs = __fmul_rn(__fdiv_rn(__fsub_rn((float)u, p.cx), p.fx), z);
    const float ys = __fmul_rn(__fdiv_rn(__fsub_rn((float)v, p.cy), p.fy), z);
    const bool valid_s = z > p.min_d && z < p.max_d;
    const float px = __fadd_rn(fmaf(state[2], z, fmaf(state[0], xs, __fmul_rn(state[1], ys))),
                               state[3]);
    const float py = __fadd_rn(fmaf(state[6], z, fmaf(state[4], xs, __fmul_rn(state[5], ys))),
                               state[7]);
    const float pz = __fadd_rn(fmaf(state[10], z, fmaf(state[8], xs, __fmul_rn(state[9], ys))),
                               state[11]);
    const float zs = fmaxf(pz, 1e-6f);
    const float ut = fmaf(__fdiv_rn(px, zs), p.fx, p.cx);
    const float vt = fmaf(__fdiv_rn(py, zs), p.fy, p.cy);
    const bool inb = pz > p.min_d && ut >= 0.f && ut < (float)(W - 1) && vt >= 0.f &&
                     vt < (float)(H - 1);
    float it_w = 0.f, dt_w = 0.f;
    if (inb) {
      const float u0 = floorf(ut), v0 = floorf(vt);
      const int iu = (int)u0, iv = (int)v0;
      it_w = bilinear(tgt, W, iu, iv, ut - u0, vt - v0);
      dt_w = bilinear(tgt + HW, W, iu, iv, ut - u0, vt - v0);
    }
    const float r_i = it_w - i_s;
    const float r_d = dt_w - pz;
    const bool valid = valid_s && inb && dt_w > p.min_d && fabsf(r_d) < p.max_dd;
    acc[29] = valid_s ? 1.f : 0.f;
    if (valid) {
      const float gx = src[2 * HW + idx], gy = src[3 * HW + idx];
      const float gdx = src[4 * HW + idx], gdy = src[5 * HW + idx];
      const float inv_z = 1.f / zs;
      const float ju0 = p.fx * inv_z, ju2 = -p.fx * px * inv_z * inv_z;
      const float jv1 = p.fy * inv_z, jv2 = -p.fy * py * inv_z * inv_z;
      float Ji[6], Jd[6];
      dp_dxi(gx * ju0, gy * jv1, gx * ju2 + gy * jv2, px, py, pz, Ji);
      dp_dxi(gdx * ju0, gdy * jv1, gdx * ju2 + gdy * jv2 - 1.f, px, py, pz, Jd);
      const float w_i = huber(r_i, p.s_i, p.delta) * p.term_i;
      const float w_d = huber(r_d, p.s_d, p.delta) * p.term_d;
      const float wi2 = w_i * w_i * p.s_i * p.s_i;
      const float wd2 = w_d * w_d * p.s_d * p.s_d;
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) acc[k++] = Ji[a] * Ji[b] * wi2 + Jd[a] * Jd[b] * wd2;
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] = Ji[a] * r_i * wi2 + Jd[a] * r_d * wd2;
      acc[27] = 1.f;
      const float ri = r_i * p.s_i, rd = r_d * p.s_d;
      acc[28] = ri * ri + rd * rd;
    }
  }

  // CTA reduction in a fixed order: warp shuffles, then warp 0 over warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    partials[blockIdx.x * kSums + threadIdx.x] = s;
  }
}

// In-place Cholesky solve of a 6x6 SPD system (sqrt guarded at 1e-30).
__device__ void chol_solve6(float A[6][6], const float b[6], float x[6]) {
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-30f)) : s / L[j][j];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// One warp per sum (blockDim = 32 * kSums): lane l adds the partial rows
// l, l+32, ... and a shuffle tree combines the lanes. The order is fixed,
// so the pose is the same from run to run.
__global__ void __launch_bounds__(32 * kSums)
odometry_solve_kernel(const float* __restrict__ partials, int n_blocks,
                      float* __restrict__ state, OdoParams p) {
  if (state[12] != 0.f) return;
  __shared__ float sums[kSums];
  const int lane = threadIdx.x & 31, col = threadIdx.x >> 5;
  double s = 0.0;
  for (int b = lane; b < n_blocks; b += 32) s += (double)partials[b * kSums + col];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) sums[col] = (float)s;
  __syncthreads();
  if (threadIdx.x != 0) return;

  float A[6][6], rhs[6], d[6], y[6], delta[6];
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b, ++k) A[a][b] = A[b][a] = sums[k];
  for (int a = 0; a < 6; ++a) {
    A[a][a] += p.damping;
    rhs[a] = -sums[21 + a];
  }
  // Jacobi equilibration: JtJ mixes pixel^2 and metric units (cond ~1e6+);
  // symmetric diagonal scaling keeps the f32 Cholesky accurate
  for (int a = 0; a < 6; ++a) d[a] = rsqrtf(fmaxf(A[a][a], 1e-30f));
  for (int a = 0; a < 6; ++a) {
    for (int b = 0; b < 6; ++b) A[a][b] *= d[a] * d[b];
    rhs[a] *= d[a];
  }
  chol_solve6(A, rhs, y);
  bool finite = true;
  for (int a = 0; a < 6; ++a) {
    delta[a] = y[a] * d[a];
    finite = finite && isfinite(delta[a]);
  }
  if (!finite)
    for (int a = 0; a < 6; ++a) delta[a] = 0.f;

  // se3 exp of the step (same series thresholds as core.se3.se3_exp)
  const float wx = delta[3], wy = delta[4], wz = delta[5];
  const float t2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(t2 + 1e-32f);
  const bool big = t2 > 1e-6f;
  const float sn = sinf(th), cs = cosf(th);
  const float sa = big ? sn / th : 1.f - t2 / 6.f;
  const float sb = big ? (1.f - cs) / fmaxf(t2, 1e-32f) : 0.5f - t2 / 24.f;
  const float sc = big ? (th - sn) / fmaxf(t2 * th, 1e-32f) : 1.f / 6.f - t2 / 120.f;
  const float Wm[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  float E[3][4];
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
    for (int j = 0; j < 3; ++j) {
      float w2 = 0.f;
      for (int m = 0; m < 3; ++m) w2 += Wm[i][m] * Wm[m][j];
      const float id = (i == j) ? 1.f : 0.f;
      E[i][j] = id + sa * Wm[i][j] + sb * w2;
      t += (id + sb * Wm[i][j] + sc * w2) * delta[j];
    }
    E[i][3] = t;
  }
  float Tn[12];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 4; ++c)
      Tn[r * 4 + c] = E[r][0] * state[c] + E[r][1] * state[4 + c] + E[r][2] * state[8 + c] +
                      (c == 3 ? E[r][3] : 0.f);
  for (int i = 0; i < 12; ++i) state[i] = Tn[i];

  float dn2 = 0.f;
  for (int a = 0; a < 6; ++a) dn2 += delta[a] * delta[a];
  state[12] = (p.tol2 > 0.f && dn2 < p.tol2) ? 1.f : 0.f;
  const float n_valid = sums[27];
  state[13] = n_valid / fmaxf(sums[29], 1.f);
  state[14] = sqrtf(sums[28] / fmaxf(n_valid, 1.f));
  state[15] = n_valid;
}

OdoParams load_params(const float* h) {
  return OdoParams{h[0], h[1], h[2],  h[3],  h[4],  h[5],  h[6],
                   h[7], h[8], h[9], h[10], h[11], h[12], h[13]};
}

}  // namespace

// src: (6, H, W) float32 planes [intensity, depth, gx, gy, gdx, gdy] of the
// source; tgt: (2, H, W) [intensity, depth] of the target; state: float[16];
// partials: float[n_blocks * 30] with n_blocks = ceil(H*W / 256); params
// (host): fx, fy, cx, cy, min_depth, max_depth, max_depth_diff,
// 1/sigma_i, 1/sigma_d, huber_delta, term_i, term_d, damping, tol^2.
extern "C" int akr_odometry_reduce(const float* src, const float* tgt, int H, int W,
                                   const float* state, float* partials, int n_blocks,
                                   const float* params, void* stream) {
  odometry_reduce_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, tgt, H, W, state, partials, load_params(params));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int akr_odometry_solve(const float* partials, int n_blocks, float* state,
                                  const float* params, void* stream) {
  odometry_solve_kernel<<<1, 32 * kSums, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n_blocks, state, load_params(params));
  return static_cast<int>(cudaGetLastError());
}
