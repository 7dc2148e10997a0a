// TSDF worklist integration for Hopper (sm_90a).
//
// Replaces: azurekinect3dreconstruction_tpu/ops/pallas/tsdf_kernels.py,
// _make_kernel (launched by _integrate_fn at :323). Semantics are those of the
// plain tsdf.volume.fuse_blocks restricted to the worklist rows, not of the TPU
// kernel's approximations: full-res depth and float color, no mip levels.
//
// What bounds it on this card: the bytes of the updated sectors. A voxel the
// frame updates reads and writes its tsdf, weight and 3 colors (40 B); the
// arithmetic is a few dozen flops a voxel, and the depth and color images
// (5.9 MB at 640x576) stay resident in the 50 MB L2. Only about half of a
// visible block's voxels lie in the truncation band, so a kernel that moved
// whole rows would move twice the bytes the update needs; and a loop that
// reads one voxel's pool words after its depth gather keeps too few bytes in
// flight to reach the memory's rate.
//
// The design:
// - A work item is a float4 group: 4 consecutive z-voxels of one pool row,
//   one 16-B word of each pool plane (rows are R^3 x 4 B, a multiple of 16;
//   the wrapper checks the pools' alignment).
// - Persistent CTAs, as many as the card holds at once (SMs x resident CTAs a
//   SM from the occupancy API, akr_tsdf_integrate_grid), walk the groups of
//   the live rows, min(*n_active, M) x R^3 / 4, with a grid stride. n_active
//   is read on the device: padding rows cost nothing, a whole-pool worklist
//   costs what a compacted one does, no CTA waits in a half-empty last wave,
//   and the launch needs no host sync (it captures into a CUDA graph).
// - Mask first: for a group's 4 voxels a thread computes the camera point,
//   the pixel and the depth gather, and forms the update predicate in
//   registers before it touches the pool. A group with no updated voxel is
//   neither read nor written; a stored group writes its other voxels back
//   unchanged (no other CTA touches the row).
// - Then the group's five float4 pool words and its color gathers are issued
//   together, and while they are in flight the thread computes the mask of
//   its next group (a two-stage software pipeline in registers), so the DRAM
//   and L2 latencies overlap the arithmetic.
// - R is a template parameter, instantiated for 8, 16 and 32: voxel indices
//   are shifts and masks. Every other block resolution the JAX package takes
//   (any multiple of 8, ops/pallas/tsdf_kernels.py:189, whose index math
//   divides by R) runs one more instance, kAnyR, which takes R at run time
//   and forms the indices by division; a multiple of 8 keeps a group's 4
//   z-voxels in one row and a row a whole number of 16-B words. Any other R
//   is refused.
//
// Rounding: every multiply-add is spelled out, fused (fmaf) exactly where
// the reference's compiled integrate fuses it and unfused (__fmul_rn,
// __fadd_rn) everywhere else, so nvcc's own contraction cannot move a voxel
// across a half-pixel edge; x / z, y / z and 1 / (w + 1) are IEEE divisions
// (__fdiv_rn), and sdf / trunc is a multiply by the float32 reciprocal, as
// the reference compiles it. The x and y terms of the camera point are shared
// by a group's 4 voxels, which changes no rounding. So the kernel agrees to
// the bit with the plain PyTorch version (tsdf/volume.py fuse_blocks, which
// emulates the same fmas in float64). The pixel is chosen by
// round-half-to-even (rintf), as torch.round does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDevices = 64;

struct IntegrateParams {
  float fx, fy, cx, cy, voxel, trunc, inv_trunc, max_w;
};

// A block's voxel index math. R = 8, 16 or 32: shifts and masks on
// compile-time constants. R = 0 (kAnyR): the block resolution `r` at run
// time, any multiple of 8, by division.
constexpr int kAnyR = 0;

template <int R>
struct Block {
  static_assert(R == 8 || R == 16 || R == 32, "block_resolution must be 8, 16 or 32");
  static constexpr int kLog = R == 8 ? 3 : R == 16 ? 4 : 5;
  static constexpr int kGroupsPerRow = R * R * R / 4;
  static constexpr int kLogGroups = 3 * kLog - 2;
  __device__ explicit Block(int) {}
  __device__ int res() const { return R; }
  __device__ int groups_per_row() const { return kGroupsPerRow; }
  __device__ long long row(long long item) const { return item >> kLogGroups; }
  __device__ int group(long long item) const {
    return static_cast<int>(item) & (kGroupsPerRow - 1);
  }
  __device__ void voxel(int lin, int& ix, int& iy, int& iz) const {
    ix = lin >> (2 * kLog);
    iy = (lin >> kLog) & (R - 1);
    iz = lin & (R - 1);
  }
};

template <>
struct Block<kAnyR> {
  int r, g;  // the block resolution and the float4 groups of a row, r^3 / 4
  __device__ explicit Block(int res_) : r(res_), g(res_ * res_ * res_ / 4) {}
  __device__ int res() const { return r; }
  __device__ int groups_per_row() const { return g; }
  __device__ long long row(long long item) const { return item / g; }
  __device__ int group(long long item) const { return static_cast<int>(item % g); }
  __device__ void voxel(int lin, int& ix, int& iy, int& iz) const {
    const int r2 = r * r;
    ix = lin / r2;
    const int rem = lin - ix * r2;
    iy = rem / r;
    iz = rem - iy * r;
  }
};

// One float4 group after the mask phase: where it lives and which of its 4
// voxels the frame updates, with their observed tsdf and pixel.
struct Group {
  int slot, grp;
  bool any;
  bool upd[4];
  float obs[4];
  int pix[4];
};

// The pool words of an updated group and the color at its voxels' pixels.
struct Words {
  float4 t, w, c[3];
  float cim[4][3];
};

template <int R>
__device__ __forceinline__ Group mask_group(const Block<R>& B, long long item, long long n_items,
                                            const int4* __restrict__ worklist,
                                            const float (&T)[12], const float* __restrict__ depth,
                                            int H, int W, int trash, const IntegrateParams& p) {
  Group g;
  int4 row = make_int4(trash, 0, 0, 0);
  if (item < n_items) row = worklist[B.row(item)];
  g.slot = row.x;
  g.grp = B.group(item);
  const int lin = g.grp * 4;
  const int res = B.res();
  int ix, iy, iz;
  B.voxel(lin, ix, iy, iz);
  const float wx = __fmul_rn(__fadd_rn(static_cast<float>(row.y * res + ix), 0.5f), p.voxel);
  const float wy = __fmul_rn(__fadd_rn(static_cast<float>(row.z * res + iy), 0.5f), p.voxel);
  // fma(z, R2, fma(y, R1, x R0)) + t, as se3.transform_points; the x and y
  // terms are shared by the group's 4 voxels
  const float ex = fmaf(wy, T[1], __fmul_rn(wx, T[0]));
  const float ey = fmaf(wy, T[5], __fmul_rn(wx, T[4]));
  const float ez = fmaf(wy, T[9], __fmul_rn(wx, T[8]));
  float z[4], d[4];
  bool in[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float wz = __fmul_rn(__fadd_rn(static_cast<float>(row.w * res + iz + j), 0.5f), p.voxel);
    const float x = __fadd_rn(fmaf(wz, T[2], ex), T[3]);
    const float y = __fadd_rn(fmaf(wz, T[6], ey), T[7]);
    z[j] = __fadd_rn(fmaf(wz, T[10], ez), T[11]);
    const float sz = fmaxf(z[j], 1e-6f);
    const float ur = rintf(fmaf(__fdiv_rn(x, sz), p.fx, p.cx));
    const float vr = rintf(fmaf(__fdiv_rn(y, sz), p.fy, p.cy));
    in[j] = g.slot != trash && z[j] > 1e-4f && ur >= 0.f && vr >= 0.f &&
            ur < static_cast<float>(W) && vr < static_cast<float>(H);
    g.pix[j] = in[j] ? __float2int_rn(vr) * W + __float2int_rn(ur) : 0;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) d[j] = in[j] ? __ldg(depth + g.pix[j]) : 0.f;
  g.any = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float sdf = __fsub_rn(d[j], z[j]);
    g.upd[j] = in[j] && d[j] > 0.f && sdf > -p.trunc;
    g.obs[j] = fminf(__fmul_rn(sdf, p.inv_trunc), 1.0f);
    g.any = g.any || g.upd[j];
  }
  return g;
}

template <int R>
__device__ __forceinline__ void load_words(const Block<R>& B, const Group& g, Words& w,
                                           const float4* __restrict__ tsdf,
                                           const float4* __restrict__ weight,
                                           const float4* __restrict__ color_pool,
                                           const float* __restrict__ color) {
  const int G = B.groups_per_row();
  const size_t off = static_cast<size_t>(g.slot) * G + g.grp;
  const size_t coff = static_cast<size_t>(g.slot) * (3 * G) + g.grp;
  w.t = tsdf[off];
  w.w = weight[off];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) w.c[ch] = color_pool[coff + ch * G];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) w.cim[j][ch] = g.upd[j] ? __ldg(color + 3 * g.pix[j] + ch) : 0.f;
}

template <int R>
__device__ __forceinline__ void update_store(const Block<R>& B, const Group& g, const Words& in,
                                             float4* __restrict__ tsdf,
                                             float4* __restrict__ weight,
                                             float4* __restrict__ color_pool,
                                             const IntegrateParams& p) {
  const int G = B.groups_per_row();
  float t[4] = {in.t.x, in.t.y, in.t.z, in.t.w};
  float w[4] = {in.w.x, in.w.y, in.w.z, in.w.w};
  float c[3][4];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    c[ch][0] = in.c[ch].x;
    c[ch][1] = in.c[ch].y;
    c[ch][2] = in.c[ch].z;
    c[ch][3] = in.c[ch].w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!g.upd[j]) continue;
    const float w_old = w[j];
    const float inv = __fdiv_rn(1.0f, fmaxf(__fadd_rn(w_old, 1.0f), 1.0f));
    t[j] = __fmul_rn(fmaf(t[j], w_old, g.obs[j]), inv);
    w[j] = fminf(__fadd_rn(w_old, 1.0f), p.max_w);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch][j] = __fmul_rn(fmaf(c[ch][j], w_old, in.cim[j][ch]), inv);
  }
  const size_t off = static_cast<size_t>(g.slot) * G + g.grp;
  const size_t coff = static_cast<size_t>(g.slot) * (3 * G) + g.grp;
  tsdf[off] = make_float4(t[0], t[1], t[2], t[3]);
  weight[off] = make_float4(w[0], w[1], w[2], w[3]);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    color_pool[coff + ch * G] = make_float4(c[ch][0], c[ch][1], c[ch][2], c[ch][3]);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
tsdf_integrate_kernel(const int4* __restrict__ worklist, int M, const int* __restrict__ n_active,
                      const float* __restrict__ T_cw, const float* __restrict__ depth,
                      const float* __restrict__ color, int H, int W, float4* __restrict__ tsdf,
                      float4* __restrict__ weight, float4* __restrict__ color_pool, int trash,
                      int res, IntegrateParams p) {
  const Block<R> B(res);
  const int rows = n_active ? min(max(*n_active, 0), M) : M;
  const long long n_items = static_cast<long long>(rows) * B.groups_per_row();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = T_cw[k];

  // a two-stage software pipeline: the next group's mask is computed while
  // the current group's pool words and color gathers are in flight
  long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  Group cur = mask_group<R>(B, item, n_items, worklist, T, depth, H, W, trash, p);
  for (; item < n_items; item += stride) {
    Words words;
    if (cur.any) load_words<R>(B, cur, words, tsdf, weight, color_pool, color);
    const Group next = mask_group<R>(B, item + stride, n_items, worklist, T, depth, H, W, trash, p);
    if (cur.any) update_store<R>(B, cur, words, tsdf, weight, color_pool, p);
    cur = next;
  }
}

// The persistent grid of one instantiation on the current device: the CTAs
// the card holds at once (occupancy x SM count), computed once per process.
template <int R>
cudaError_t persistent_grid(int* grid) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, occ = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, tsdf_integrate_kernel<R>,
                                                            kThreads, 0)) != cudaSuccess)
      return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    cached[dev] = occ * sms;
  }
  *grid = cached[dev];
  return cudaSuccess;
}

template <int R>
cudaError_t launch(const int* worklist, int M, const int* n_active, const float* T_cw,
                   const float* depth, const float* color, int H, int W, float* tsdf,
                   float* weight, float* color_pool, int res, int trash, const IntegrateParams& p,
                   cudaStream_t stream) {
  int grid = 0;
  cudaError_t e = persistent_grid<R>(&grid);
  if (e != cudaSuccess) return e;
  tsdf_integrate_kernel<R><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(worklist), M, n_active, T_cw, depth, color, H, W,
      reinterpret_cast<float4*>(tsdf), reinterpret_cast<float4*>(weight),
      reinterpret_cast<float4*>(color_pool), trash, res, p);
  return cudaGetLastError();
}

// Every block resolution the JAX package takes: a positive multiple of 8
// (its cube a multiple of 128).
bool supported(int R) { return R > 0 && R % 8 == 0; }

}  // namespace

// The persistent grid of the kernel for block resolution R on the current
// device (the CTAs of one launch).
extern "C" int akr_tsdf_integrate_grid(int R, int* grid) {
  switch (R) {
    case 8: return static_cast<int>(persistent_grid<8>(grid));
    case 16: return static_cast<int>(persistent_grid<16>(grid));
    case 32: return static_cast<int>(persistent_grid<32>(grid));
    default:
      return static_cast<int>(supported(R) ? persistent_grid<kAnyR>(grid) : cudaErrorInvalidValue);
  }
}

// worklist: (M, 4) int32 rows (slot, bx, by, bz), padded with `trash`, 16-B
// aligned; n_active: device int32, the live rows (rows past M are not
// integrated), or null for all M; T_cw: 12 floats (3x4 camera-from-world,
// row-major) in device memory; depth (H, W) and color (H, W, 3) float32;
// pools (cap, R^3) / (cap, 3, R^3), 16-B aligned; R a positive multiple of
// 8 (8, 16 and 32 have instances of their own, any other runs the kAnyR
// instance); params (host): fx, fy, cx, cy, voxel, trunc, 1/trunc (float32),
// max_weight.
extern "C" int akr_tsdf_integrate(const int* worklist, int M, const int* n_active,
                                  const float* T_cw, const float* depth, const float* color,
                                  int H, int W, float* tsdf, float* weight, float* color_pool,
                                  int R, int trash, const float* params, void* stream) {
  const IntegrateParams p{params[0], params[1], params[2], params[3],
                          params[4], params[5], params[6], params[7]};
  if (!supported(R)) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 8:
      return static_cast<int>(launch<8>(worklist, M, n_active, T_cw, depth, color, H, W, tsdf,
                                        weight, color_pool, R, trash, p, s));
    case 16:
      return static_cast<int>(launch<16>(worklist, M, n_active, T_cw, depth, color, H, W, tsdf,
                                         weight, color_pool, R, trash, p, s));
    case 32:
      return static_cast<int>(launch<32>(worklist, M, n_active, T_cw, depth, color, H, W, tsdf,
                                         weight, color_pool, R, trash, p, s));
    default:
      return static_cast<int>(launch<kAnyR>(worklist, M, n_active, T_cw, depth, color, H, W,
                                            tsdf, weight, color_pool, R, trash, p, s));
  }
}
