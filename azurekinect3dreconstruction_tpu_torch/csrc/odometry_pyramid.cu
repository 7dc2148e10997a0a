// Gauss-Newton RGB-D odometry over the whole image pyramid, one cooperative
// launch per frame pair, for Hopper (sm_90a).
//
// Replaces: azurekinect3dreconstruction_tpu/ops/pallas/odometry_kernels.py,
// _make_level_kernel (one pallas_call per pyramid level, launched by
// _level_fn from compute_odometry_tpu). This kernel runs every level, coarse
// to fine, and every GN iteration of each level in one launch:
//
//   level prologue: each CTA owns a fixed contiguous band of the level's
//       pixels. It reads the source intensity and depth (with the one-pixel
//       halo, edge-clamped), computes the Sobel/8 gradients of both in the
//       operation order of ops/image.py sobel_gradients, zeroes the depth
//       gradients where a 4-neighbour (wrapping at the image edges, as
//       level_inputs' rolls do) has no depth, and back-projects the pixel.
//       On the shared route (below) i_s, z, xs, ys, gx, gy, gdx, gdy stay in
//       shared memory for all of the level's iterations; valid_s is z's
//       depth-range test.
//   GN iteration: every thread warps its pixels by the pose, samples target
//       intensity and depth bilinearly through the read-only path (in bounds
//       means 0 <= u < W-1, 0 <= v < H-1), gates, Huber-weights, builds both
//       Jacobian rows from the SOURCE gradients (the gradient swap) and
//       accumulates the 30 sums (21 JtJ + 6 Jtr + n_valid, cost, n_source) of
//       all its pixels in registers, two pixels at a time. A transposing
//       shuffle sum per warp and a fixed order over warps give the CTA's
//       partial row, written to partials[iteration % 2] as words tagged with
//       the iteration's number. EVERY CTA then reads all partial rows in the
//       same fixed order (in double), waiting on each word's tag, which is the
//       iteration's one grid barrier; adds the damping, solves the
//       Jacobi-equilibrated 6x6 system by Cholesky, zeroes a non-finite step,
//       applies the se3 exp and left-composes the pose. All CTAs run the same
//       arithmetic on the same data, so they hold the same pose to the bit
//       and leave a converged level together; no second barrier is needed,
//       and the double buffer keeps a fast CTA's next partial row off the
//       rows a slow CTA still reads.
//
// What bounds it: arithmetic. At 640x576 with [20, 10, 5] iterations it does
// 8.41 M pixel-iterations of ~245 flops (warp, two bilinear samples,
// Jacobians, 27 weighted products) = ~2.1 GFLOP, ~31 us at 67 TFLOP/s of
// float32, against 7.7 MB of input planes (~2.3 us at 3.35 TB/s). The design
// reads the source planes once per level instead of once per iteration,
// keeps the target planes (2.9 MB at level 0) in L1/L2, replaces the
// 70 launches and one-CTA solves of a frame pair by one launch whose
// iterations are separated by one grid-wide wait each, and gives the card a
// fixed co-resident grid (occupancy x SM count), so the sum order, and with
// it the pose, is the same from run to run. What it does not remove is a
// fixed cost per GN iteration (the CTA sum, the wait for the slowest CTA,
// every CTA reading 132 partial rows from L2, the one-thread solve): 35
// iterations in series, so the kernel stays well above its bound.
//
// Rounding: the warp's multiply-adds are fused (fmaf) exactly where the
// plain version fuses them and unfused (__fmul_rn, __fadd_rn) elsewhere: at
// the identity start a whole border column sits on the u < W-1 edge. The
// gradients and the back-projection are those of level_inputs to the bit.
//
// Two routes, chosen per level (the wrapper's plan, odometry_kernels.level_routes):
//
//   shared: a CTA keeps its band's 8 planes in shared memory (32 B a pixel).
//       The grid holds at most grid x band pixels of a level this way
//       (akr_odometry_pyramid_grid): on an H100 (132 SMs, 227 KB a CTA)
//       about 930,000, enough for 640x576 NFOV, 512x512 WFOV binned depth and
//       the 1280x720 color-aligned frames, and for every level but the
//       finest of the larger frames.
//   large: a level with more pixels (1024x1024 WFOV unbinned; the color
//       modes above 720p: 1920x1080, k4arecorder's default, up to 4096x3072)
//       keeps in shared memory only the 4 gradient planes (gx, gy, gdx, gdy),
//       and only of the first `res` pixels of each band, as many as fit (16 B
//       a pixel: all of a 1024x1024 band of 7,944 pixels, ~90 % of a 1080p
//       band of 15,710, ~22 % at 2160p).
//       Every GN iteration reloads i_s and z through the read-only path,
//       recomputes xs and ys from (u, v, z), and recomputes the other pixels'
//       gradients and their mask from the source planes with the prologue's
//       rounded operations. So the level's working set is its four input
//       planes, read through __ldg: 33.2 MB at 1080p, which the 50 MB L2
//       holds, where a global scratch of the derived planes (66.4 MB at
//       1080p) beside them missed it on every iteration. From 2160p on the
//       four inputs alone exceed the L2 (133 MB at 2160p, 201 MB at 3072p),
//       so there the route is bounded by HBM by design.
//
// Measured on an H100 80GB HBM3 at 700 W (device time a frame pair at [20,
// 10, 5]): 640x576 ~256 us and 1280x720 ~425 us on the shared route, against
// bounds of 31 and 42 us; 1920x1080 ~945 us against 95 us, level 0 on the
// large route at 35 ps a valid pixel-iteration beside the shared route's 32
// (the global scratch it replaces: ~1,490 us, 60 ps); 1024x1024 ~540 us
// against 88 us; 3840x2160 ~4,220 us against 160 us.
//
// Both routes do the same per-pixel arithmetic in the same order, with the
// same grid and the same partial rows, so they give the same pose, fitness
// and rmse to the bit on every pyramid where both apply.
//
// The launch is capture-safe: it allocates nothing and never waits on the
// host. The wrapper gives it the partial rows (2 x grid x 30 tagged 64-bit
// words), which the entry point zeroes on the stream; nothing else is
// allocated for it, whatever the frame size.
//
// State layout (float[16], device): [0..11] pose 3x4 row-major (target from
// source), [12] convergence flag of the finest level, [13] fitness, [14]
// rmse, [15] n_valid. The kernel reads the initial pose from it and writes
// the result back (CTA 0).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 30;  // 21 JtJ (upper triangle, row-major) + 6 Jtr + 3 counts
// pyramid levels a launch takes: at 16 a 1024x1024 image is below one pixel
// from level 11 on, so every count build_pyramid can make from a frame fits.
// Each CTA copies the table to shared memory once and reads its level there.
constexpr int kMaxLevels = 16;
constexpr int kPlanes = 8;  // the shared route: i_s, z, xs, ys, gx, gy, gdx, gdy a pixel
constexpr int kResidentPlanes = 4;  // the large route: gx, gy, gdx, gdy a resident pixel
constexpr int kShared = -1;         // Level::res of a level on the shared route
// the most pixels a level may have: its pixel coordinates are exact in float
constexpr int kMaxPixels = 1 << 24;
constexpr int kMaxDevices = 64;
constexpr int kRowLoads = 16;  // partial rows a warp loads at once (one round up to 256 CTAs)

struct Level {
  const float* is;  // source intensity (H, W)
  const float* ds;  // source depth
  const float* it;  // target intensity
  const float* dt;  // target depth
  int H, W, iters;
  int res;  // kShared, or the large route's resident pixels of each band
  float fx, fy, cx, cy;
};

struct PyramidParams {
  Level lv[kMaxLevels];
  int n_levels;
  float min_d, max_d, max_dd, s_i, s_d, delta, term_i, term_d, damping, tol2;
  float* state;
  unsigned long long* partials;  // [2][grid][kSums] tagged words, zeroed before the launch
};

__device__ __forceinline__ float huber(float r, float s, float delta) {
  const float a = fabsf(r * s);
  return a <= delta ? 1.0f : delta / fmaxf(a, 1e-12f);
}

__device__ __forceinline__ float bilinear(const float* img, int W, int o, float fu, float fv) {
  const float* p = img + o;
  return __ldg(p) * (1.f - fu) * (1.f - fv) + __ldg(p + 1) * fu * (1.f - fv) +
         __ldg(p + W) * (1.f - fu) * fv + __ldg(p + W + 1) * fu * fv;
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

// Sobel/8 of an edge-clamped image at (u, v), in ops/image.py's order:
// sv(j) = (I[v-1][j] + 2 I[v][j]) + I[v+1][j], gx = (sv(u+1) - sv(u-1)) / 8,
// and the same along the other axis for gy (division by 8 is exact).
__device__ __forceinline__ void sobel(const float* img, int W, int u, int um, int up,
                                      int vm, int v, int vp, float* gx, float* gy) {
  const float* rm = img + vm * W;
  const float* r0 = img + v * W;
  const float* rp = img + vp * W;
  const float sv_p = __fadd_rn(__fadd_rn(__ldg(rm + up), __fmul_rn(2.f, __ldg(r0 + up))),
                               __ldg(rp + up));
  const float sv_m = __fadd_rn(__fadd_rn(__ldg(rm + um), __fmul_rn(2.f, __ldg(r0 + um))),
                               __ldg(rp + um));
  const float su_p = __fadd_rn(__fadd_rn(__ldg(rp + um), __fmul_rn(2.f, __ldg(rp + u))),
                               __ldg(rp + up));
  const float su_m = __fadd_rn(__fadd_rn(__ldg(rm + um), __fmul_rn(2.f, __ldg(rm + u))),
                               __ldg(rm + up));
  *gx = __fmul_rn(__fsub_rn(sv_p, sv_m), 0.125f);
  *gy = __fmul_rn(__fsub_rn(su_p, su_m), 0.125f);
}

// The back-projection's coordinate along one axis: ((u - c) / f) z.
__device__ __forceinline__ float back_project(int u, float c, float f, float z) {
  return __fmul_rn(__fdiv_rn(__fsub_rn((float)u, c), f), z);
}

// The source gradients of pixel (u, v) at depth z: Sobel/8 of intensity and
// depth, the depth's zeroed where a 4-neighbour (wrapping at the image
// edges, as level_inputs' rolls do) has no depth.
__device__ __forceinline__ void gradients(const Level& L, int u, int v, float z, float& gx,
                                          float& gy, float& gdx, float& gdy) {
  const int W = L.W, H = L.H;
  const int um = max(u - 1, 0), up = min(u + 1, W - 1);
  const int vm = max(v - 1, 0), vp = min(v + 1, H - 1);
  float dx, dy;
  sobel(L.is, W, u, um, up, vm, v, vp, &gx, &gy);
  sobel(L.ds, W, u, um, up, vm, v, vp, &dx, &dy);
  const int uwm = u == 0 ? W - 1 : u - 1, uwp = u == W - 1 ? 0 : u + 1;
  const int vwm = v == 0 ? H - 1 : v - 1, vwp = v == H - 1 ? 0 : v + 1;
  const bool okg = z > 0.f && __ldg(L.ds + vwm * W + u) > 0.f && __ldg(L.ds + vwp * W + u) > 0.f &&
                   __ldg(L.ds + v * W + uwm) > 0.f && __ldg(L.ds + v * W + uwp) > 0.f;
  gdx = okg ? dx : 0.f;
  gdy = okg ? dy : 0.f;
}

// Cholesky solve of a 6x6 SPD system (sqrt guarded at 1e-30), column by
// column. The solve runs in one thread on the critical path of every
// iteration, so each diagonal is inverted once and the other divisions
// become multiplies by it.
__device__ __forceinline__ void chol_solve6(const float A[6][6], const float b[6], float x[6]) {
  float L[6][6], inv[6], y[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = sqrtf(fmaxf(s, 1e-30f));
    inv[j] = 1.f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t -= L[i][k] * y[k];
    y[i] = t * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) t -= L[k][i] * x[k];
    x[i] = t * inv[i];
  }
}

// One GN step from the 30 sums: damping, Jacobi-equilibrated Cholesky,
// se3 exp (the series thresholds of core.se3.se3_exp), left composition.
// Updates st[0..11] (pose) and st[13..15] (fitness, rmse, n_valid); returns
// the convergence flag.
__device__ float solve_step(const float* sums, float* st, float damping, float tol2) {
  float A[6][6], rhs[6], d[6], y[6], delta[6];
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b, ++k) A[a][b] = A[b][a] = sums[k];
  for (int a = 0; a < 6; ++a) {
    A[a][a] += damping;
    rhs[a] = -sums[21 + a];
  }
  // JtJ mixes pixel^2 and metric units (cond ~1e6+); symmetric diagonal
  // scaling keeps the float32 Cholesky accurate
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

  const float wx = delta[3], wy = delta[4], wz = delta[5];
  const float t2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(t2 + 1e-32f);
  const bool big = t2 > 1e-6f;
  float sn, cs;
  sincosf(th, &sn, &cs);
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
      Tn[r * 4 + c] = E[r][0] * st[c] + E[r][1] * st[4 + c] + E[r][2] * st[8 + c] +
                      (c == 3 ? E[r][3] : 0.f);
  for (int i = 0; i < 12; ++i) st[i] = Tn[i];

  float dn2 = 0.f;
  for (int a = 0; a < 6; ++a) dn2 += delta[a] * delta[a];
  const float n_valid = sums[27];
  st[13] = n_valid / fmaxf(sums[29], 1.f);
  st[14] = sqrtf(sums[28] / fmaxf(n_valid, 1.f));
  st[15] = n_valid;
  return (tol2 > 0.f && dn2 < tol2) ? 1.f : 0.f;
}

// A partial sum travels as one 64-bit word: the float's bits and, above
// them, the number of the GN iteration that wrote it (1, 2, ... in a
// launch; the buffer is zeroed before the launch). A reader polls the word
// until it carries its own iteration's number, so the value and its
// validity arrive together, with no fence and no separate barrier (the
// low-latency protocol of NCCL). All CTAs are co-resident (cooperative
// launch), so every word arrives; 2^22 polls (over a second; a healthy wait
// takes a microsecond or two) mean a CTA is gone: trap, so the launch fails
// instead of hanging the card.
__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ bool depth_ok(float z, const PyramidParams& P) {
  return z > P.min_d && z < P.max_d;
}

// One step of a transposing warp sum: lanes with bit S set keep the upper
// half of their values and pass the lower half to lane ^ S, the others the
// reverse.
template <int S>
__device__ __forceinline__ void fold(float (&v)[32], bool upper) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = upper ? v[i] : v[i + S];
    const float keep = upper ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// The warp's sum of v[lane], for 32 values per lane in 31 shuffles (a
// shuffle tree per value would take 160), in a fixed order.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32], int lane) {
  fold<16>(v, lane & 16);
  fold<8>(v, lane & 8);
  fold<4>(v, lane & 4);
  fold<2>(v, lane & 2);
  fold<1>(v, lane & 1);
  return v[0];
}

// The source side of one pixel as a GN iteration reads it.
struct Source {
  float is, z, xs, ys, gx, gy, gdx, gdy;
};

// The shared route's prologue: every plane of the band's n pixels (from
// pixel beg of the level) into shared memory, `stride` floats a plane.
__device__ __forceinline__ void prologue_shared(const Level& L, float* smem, int beg, int n,
                                                int stride) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int p = beg + i;
    const int v = p / L.W, u = p - v * L.W;
    const float z = __ldg(L.ds + p);
    smem[i] = __ldg(L.is + p);
    smem[stride + i] = z;
    smem[2 * stride + i] = back_project(u, L.cx, L.fx, z);
    smem[3 * stride + i] = back_project(v, L.cy, L.fy, z);
    gradients(L, u, v, z, smem[4 * stride + i], smem[5 * stride + i], smem[6 * stride + i],
              smem[7 * stride + i]);
  }
}

// The large route's prologue: the gradient planes of the band's first
// L.res pixels into shared memory, L.res floats a plane.
__device__ __forceinline__ void prologue_large(const Level& L, float* smem, int beg, int n) {
  const int m = min(n, L.res);
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int p = beg + i;
    const int v = p / L.W, u = p - v * L.W;
    gradients(L, u, v, __ldg(L.ds + p), smem[i], smem[L.res + i], smem[2 * L.res + i],
              smem[3 * L.res + i]);
  }
}

template <bool kLarge>
__device__ __forceinline__ float source_z(const Level& L, const float* smem, int stride, int beg,
                                          int i) {
  return kLarge ? __ldg(L.ds + beg + i) : smem[stride + i];
}

// Band pixel i's source side: from shared memory on the shared route; on the
// large route reloaded, back-projected and, past the resident pixels,
// recomputed, with the prologue's operations.
template <bool kLarge>
__device__ __forceinline__ Source source(const Level& L, const float* smem, int stride, int beg,
                                         int i) {
  Source s;
  if (!kLarge) {
    s.is = smem[i];
    s.z = smem[stride + i];
    s.xs = smem[2 * stride + i];
    s.ys = smem[3 * stride + i];
    s.gx = smem[4 * stride + i];
    s.gy = smem[5 * stride + i];
    s.gdx = smem[6 * stride + i];
    s.gdy = smem[7 * stride + i];
    return s;
  }
  const int p = beg + i;
  const int v = p / L.W, u = p - v * L.W;
  s.is = __ldg(L.is + p);
  s.z = __ldg(L.ds + p);
  s.xs = back_project(u, L.cx, L.fx, s.z);
  s.ys = back_project(v, L.cy, L.fy, s.z);
  if (i < L.res) {
    s.gx = smem[i];
    s.gy = smem[L.res + i];
    s.gdx = smem[2 * L.res + i];
    s.gdy = smem[3 * L.res + i];
  } else {
    gradients(L, u, v, s.z, s.gx, s.gy, s.gdx, s.gdy);
  }
  return s;
}

// One GN iteration's 30 sums over this thread's pixels of the band, added
// into acc: two pixels a thread at a time, without branches, so their
// chains interleave; an invalid pixel contributes zeros (its Jacobians may
// be huge); a warp skips a pair where none of its pixels has depth.
template <bool kLarge>
__device__ __forceinline__ void accumulate(const PyramidParams& P, const Level& L,
                                           const float* smem, int stride, int beg, int n,
                                           const float (&T)[12], float (&acc)[32]) {
  const int W = L.W, H = L.H;
  for (int i0 = threadIdx.x; i0 < n; i0 += 2 * kThreads) {
    const bool any =
        depth_ok(source_z<kLarge>(L, smem, stride, beg, i0), P) ||
        (i0 + kThreads < n && depth_ok(source_z<kLarge>(L, smem, stride, beg, i0 + kThreads), P));
    if (!__any_sync(__activemask(), any)) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = i0 + h * kThreads < n;
      const Source s = source<kLarge>(L, smem, stride, beg, live ? i0 + h * kThreads : i0);
      const float z = s.z;
      const bool valid_s = live && depth_ok(z, P);
      const float xs = s.xs, ys = s.ys;
      const float px = __fadd_rn(fmaf(T[2], z, fmaf(T[0], xs, __fmul_rn(T[1], ys))), T[3]);
      const float py = __fadd_rn(fmaf(T[6], z, fmaf(T[4], xs, __fmul_rn(T[5], ys))), T[7]);
      const float pz = __fadd_rn(fmaf(T[10], z, fmaf(T[8], xs, __fmul_rn(T[9], ys))), T[11]);
      const float zs = fmaxf(pz, 1e-6f);
      const float ut = fmaf(__fdiv_rn(px, zs), L.fx, L.cx);
      const float vt = fmaf(__fdiv_rn(py, zs), L.fy, L.cy);
      const bool inb = valid_s && pz > P.min_d && ut >= 0.f && ut < (float)(W - 1) && vt >= 0.f &&
                       vt < (float)(H - 1);
      // out of bounds: sample the corner pixel with zero weights
      const float u0 = floorf(inb ? ut : 0.f), v0 = floorf(inb ? vt : 0.f);
      const int o = (int)v0 * W + (int)u0;
      const float fu = inb ? ut - u0 : 0.f, fv = inb ? vt - v0 : 0.f;
      const float it_w = bilinear(L.it, W, o, fu, fv);
      const float dt_w = bilinear(L.dt, W, o, fu, fv);
      const float r_i = it_w - s.is;
      const float r_d = dt_w - pz;
      const bool valid = inb && dt_w > P.min_d && fabsf(r_d) < P.max_dd;
      const float gx = s.gx, gy = s.gy, gdx = s.gdx, gdy = s.gdy;
      const float inv_z = 1.f / zs;
      const float ju0 = L.fx * inv_z, ju2 = -L.fx * px * inv_z * inv_z;
      const float jv1 = L.fy * inv_z, jv2 = -L.fy * py * inv_z * inv_z;
      float Ji[6], Jd[6];
      dp_dxi(gx * ju0, gy * jv1, gx * ju2 + gy * jv2, px, py, pz, Ji);
      dp_dxi(gdx * ju0, gdy * jv1, gdx * ju2 + gdy * jv2 - 1.f, px, py, pz, Jd);
      const float w_i = huber(r_i, P.s_i, P.delta) * P.term_i;
      const float w_d = huber(r_d, P.s_d, P.delta) * P.term_d;
      const float wi2 = valid ? w_i * w_i * P.s_i * P.s_i : 0.f;
      const float wd2 = valid ? w_d * w_d * P.s_d * P.s_d : 0.f;
      float Jiw[6], Jdw[6];  // the weighted rows: two fmas per product pair
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        Ji[a] = valid ? Ji[a] : 0.f;
        Jd[a] = valid ? Jd[a] : 0.f;
        Jiw[a] = Ji[a] * wi2;
        Jdw[a] = Jd[a] * wd2;
      }
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b, ++k) acc[k] = fmaf(Jiw[a], Ji[b], fmaf(Jdw[a], Jd[b], acc[k]));
      }
      const float rim = valid ? r_i : 0.f, rdm = valid ? r_d : 0.f;
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] = fmaf(Jiw[a], rim, fmaf(Jdw[a], rdm, acc[21 + a]));
      acc[27] += valid ? 1.f : 0.f;
      const float ri = rim * P.s_i, rd = rdm * P.s_d;
      acc[28] += ri * ri + rd * rd;
      acc[29] += valid_s ? 1.f : 0.f;
    }
  }
}

// kMixed: the instance for a pyramid with a level on the large route; the
// other one (every level shared) compiles without that route, as before it.
template <bool kMixed>
__global__ void __launch_bounds__(kThreads, 1) odometry_pyramid_kernel(const PyramidParams P) {
  // the level's planes: kPlanes x its band (shared route) or kResidentPlanes x res (large route)
  extern __shared__ float smem[];
  __shared__ float warp_sums[kWarps][kSums];
  __shared__ double group_sums[kWarps][kSums];
  __shared__ float sums[kSums];
  __shared__ float st[16];  // pose [0..11], fitness, rmse, n_valid at [13..15]
  __shared__ float conv_s;
  __shared__ Level lv[kMaxLevels];  // P.lv, indexed by the level

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned int G = gridDim.x;

  if (tid < 16) st[tid] = P.state[tid];
#pragma unroll
  for (int j = 0; j < kMaxLevels; ++j)  // constant indices: P stays in parameter space
    if (tid == j) lv[j] = P.lv[j];
  float conv_out = 0.f;  // the finest level's flag (thread 0)
  int step = 0;          // GN iterations so far, all levels: the buffer and the tag
  __syncthreads();

  for (int l = P.n_levels - 1; l >= 0; --l) {
    const Level L = lv[l];
    conv_out = 0.f;  // each level starts unconverged
    if (L.iters <= 0) continue;  // the pose passes through unchanged

    // -- prologue: the source side of this CTA's band, once per level ---------
    const int HW = L.H * L.W;
    const int chunk = (HW + (int)G - 1) / (int)G;
    const int beg = min((int)blockIdx.x * chunk, HW);
    const int n = min(chunk, HW - beg);
    const bool large = kMixed && L.res != kShared;
    if (large)
      prologue_large(L, smem, beg, n);
    else
      prologue_shared(L, smem, beg, n, chunk);
    __syncthreads();

    for (int it = 0; it < L.iters; ++it) {
      const int buf = step++ & 1;
      float T[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) T[k] = st[k];
      float acc[32];  // the 30 sums and two zeros for warp_transpose_sum
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.f;
      if (large)
        accumulate<true>(P, L, smem, chunk, beg, n, T, acc);
      else
        accumulate<false>(P, L, smem, chunk, beg, n, T, acc);

      // this CTA's partial row, in a fixed order: lane k of each warp ends
      // with the warp's sum k, then the warps in order
      const float ws = warp_transpose_sum(acc, lane);
      if (lane < kSums) warp_sums[warp][lane] = ws;
      __syncthreads();
      unsigned long long* const part = P.partials + (size_t)buf * G * kSums;
      const unsigned long long tag = static_cast<unsigned long long>(step);
      if (tid < kSums) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += warp_sums[w][tid];
        store_word(part + (size_t)blockIdx.x * kSums + tid, tag << 32 | __float_as_uint(s));
      }

      // every CTA: all partial rows in the same fixed order, each word
      // waited for until it carries this iteration's tag (that wait is the
      // grid barrier); each warp has all of its loads in flight at once
      if (lane < kSums) {
        double s = 0.0;
        for (unsigned int r0 = warp; r0 < G; r0 += kRowLoads * kWarps) {
          unsigned long long v[kRowLoads];
#pragma unroll
          for (int j = 0; j < kRowLoads; ++j) {
            const unsigned int r = r0 + j * kWarps;
            v[j] = r < G ? load_word(part + (size_t)r * kSums + lane) : tag << 32;
          }
          // one compact wait loop: re-poll only the words not yet tagged
          for (unsigned int polls = 0;; ++polls) {
            bool ready = true;
#pragma unroll
            for (int j = 0; j < kRowLoads; ++j) ready &= (v[j] >> 32) == tag;
            if (ready) break;
            if (polls == (1u << 22)) __trap();
#pragma unroll
            for (int j = 0; j < kRowLoads; ++j) {
              const unsigned int r = r0 + j * kWarps;
              if ((v[j] >> 32) != tag) v[j] = load_word(part + (size_t)r * kSums + lane);
            }
          }
#pragma unroll
          for (int j = 0; j < kRowLoads; ++j)
            s += (double)__uint_as_float(static_cast<unsigned int>(v[j]));
        }
        group_sums[warp][lane] = s;
      }
      __syncthreads();
      if (warp == 0) {
        if (lane < kSums) {
          double s = 0.0;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s += group_sums[w][lane];
          sums[lane] = (float)s;
        }
        __syncwarp();
        if (lane == 0) {
          conv_out = solve_step(sums, st, P.damping, P.tol2);
          conv_s = conv_out;
        }
      }
      __syncthreads();
      if (conv_s != 0.f) break;  // the same value in every CTA
    }
  }

  if (blockIdx.x == 0 && tid == 0) {
    for (int k = 0; k < 12; ++k) P.state[k] = st[k];
    P.state[12] = conv_out;
    for (int k = 13; k < 16; ++k) P.state[k] = st[k];
  }
}

int g_grid[kMaxDevices] = {0};
int g_band[kMaxDevices] = {0};

}  // namespace

// The grid of akr_odometry_pyramid on the current device: the CTAs that are
// co-resident at zero dynamic shared memory in both instances (occupancy x
// SM count), and the
// band: the most pixels whose kPlanes planes one CTA's shared memory holds
// (the large route's resident pixels: kPlanes / kResidentPlanes x band).
// Computed once per process and device, so every launch sums in the same
// order.
extern "C" int akr_odometry_pyramid_grid(int* grid, int* band) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_grid[dev] == 0) {
    int sms = 0, optin = 0, occ = 0, occ_mixed = 0;
    cudaFuncAttributes attr, attr_mixed;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (e = cudaFuncGetAttributes(&attr, odometry_pyramid_kernel<false>)) != cudaSuccess ||
        (e = cudaFuncGetAttributes(&attr_mixed, odometry_pyramid_kernel<true>)) != cudaSuccess)
      return static_cast<int>(e);
    const int smem_static =
        static_cast<int>(std::max(attr.sharedSizeBytes, attr_mixed.sharedSizeBytes));
    if ((e = cudaFuncSetAttribute(odometry_pyramid_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin - smem_static)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(odometry_pyramid_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin - smem_static)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, odometry_pyramid_kernel<false>,
                                                            kThreads, 0)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ_mixed, odometry_pyramid_kernel<true>, kThreads, 0)) != cudaSuccess)
      return static_cast<int>(e);
    occ = std::min(occ, occ_mixed);
    if (occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    g_grid[dev] = occ * sms;
    g_band[dev] = (optin - smem_static) / static_cast<int>(kPlanes * sizeof(float));
  }
  *grid = g_grid[dev];
  *band = g_band[dev];
  return 0;
}

// planes: 4 pointers per level [I_s, D_s, I_t, D_t], each (H, W) float32;
// dims: 3 ints per level [H, W, iterations]; intr: 4 floats per level [fx,
// fy, cx, cy]; n_levels: 1 to kMaxLevels; routes: 1 int per level, kShared
// (-1: the band's kPlanes planes in shared memory) or the large route's
// resident pixels of each band (0 or more); params (host): min_depth,
// max_depth, max_depth_diff, 1/sigma_i, 1/sigma_d, huber_delta, term_i,
// term_d, damping, tol^2; state: float[16]; partials: 64-bit words[2 * grid
// * 30]. Level 0 is the finest; levels run from n_levels-1 down to 0. The
// dynamic shared memory is what the levels that iterate need: kPlanes floats
// a band pixel on the shared route, kResidentPlanes a resident pixel on the
// large one. A level that no route takes (more than kMaxPixels pixels,
// iterated or not; a band over the shared memory on the shared route,
// resident pixels over it on the large one, any other route) is refused
// with cudaErrorInvalidValue, as is a launch the card refuses; neither is
// worked around.
extern "C" int akr_odometry_pyramid(const void* const* planes, const int* dims,
                                    const float* intr, int n_levels, const int* routes,
                                    const float* params, float* state,
                                    unsigned long long* partials, int grid, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid_dev = 0, band = 0;
  cudaError_t e = static_cast<cudaError_t>(akr_odometry_pyramid_grid(&grid_dev, &band));
  if (e != cudaSuccess) return static_cast<int>(e);
  PyramidParams P{};
  long long floats = 0;  // dynamic shared memory, in floats
  bool mixed = false;     // a level on the large route
  for (int l = 0; l < n_levels; ++l) {
    Level& L = P.lv[l];
    L.is = static_cast<const float*>(planes[4 * l]);
    L.ds = static_cast<const float*>(planes[4 * l + 1]);
    L.it = static_cast<const float*>(planes[4 * l + 2]);
    L.dt = static_cast<const float*>(planes[4 * l + 3]);
    L.H = dims[3 * l];
    L.W = dims[3 * l + 1];
    L.iters = dims[3 * l + 2];
    L.res = routes[l];
    L.fx = intr[4 * l];
    L.fy = intr[4 * l + 1];
    L.cx = intr[4 * l + 2];
    L.cy = intr[4 * l + 3];
    if (L.H < 2 || L.W < 2 || static_cast<long long>(L.H) * L.W > kMaxPixels)
      return static_cast<int>(cudaErrorInvalidValue);
    if (L.iters <= 0) continue;
    const long long need = L.res == kShared ? static_cast<long long>(
                                                  (L.H * L.W + grid - 1) / grid) * kPlanes
                           : L.res >= 0     ? static_cast<long long>(L.res) * kResidentPlanes
                                            : -1;
    if (need < 0 || need > static_cast<long long>(band) * kPlanes)
      return static_cast<int>(cudaErrorInvalidValue);
    floats = std::max(floats, need);
    mixed = mixed || L.res != kShared;
  }
  P.n_levels = n_levels;
  P.min_d = params[0];
  P.max_d = params[1];
  P.max_dd = params[2];
  P.s_i = params[3];
  P.s_d = params[4];
  P.delta = params[5];
  P.term_i = params[6];
  P.term_d = params[7];
  P.damping = params[8];
  P.tol2 = params[9];
  P.state = state;
  P.partials = partials;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(partials, 0, sizeof(unsigned long long) * 2 * kSums * grid, s);
  if (e == cudaSuccess) {
    void* args[] = {&P};
    const size_t bytes = static_cast<size_t>(floats) * sizeof(float);
    e = mixed ? cudaLaunchCooperativeKernel(odometry_pyramid_kernel<true>, dim3(grid),
                                            dim3(kThreads), args, bytes, s)
              : cudaLaunchCooperativeKernel(odometry_pyramid_kernel<false>, dim3(grid),
                                            dim3(kThreads), args, bytes, s);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
