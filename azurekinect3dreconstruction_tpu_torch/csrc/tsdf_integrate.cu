// TSDF worklist integration for Hopper (sm_90a).
//
// Replaces: azurekinect3dreconstruction_tpu/ops/pallas/tsdf_kernels.py,
// _make_kernel (launched by _integrate_fn). Semantics are those of the plain
// tsdf.volume.integrate, not of the TPU kernel's approximations: full-res
// depth and float color, no mip levels, sdf / trunc as a division.
//
// What bounds it: memory traffic. Each visible block reads and writes its
// tsdf, weight and 3 color rows (5 x 4 B x R^3 = 80 KB at R = 16) and gathers
// depth and color at one pixel per voxel; the arithmetic is a few dozen
// flops per voxel. The design: one CTA per worklist row, so a block's pool
// rows are read and written once, coalesced (consecutive threads take
// consecutive voxels). The image gathers go straight to global memory and
// the L2 cache: the 640x576 depth and color planes (5.9 MB) stay resident in
// the 50 MB L2, and neighbouring voxels hit neighbouring pixels. Padded
// worklist rows (the reserved trash slot) exit before touching memory, so a
// static worklist costs only the rows that are live.
//
// Rounding: every multiply-add is spelled out, fused (fmaf) exactly where
// the reference's compiled integrate fuses it and unfused (__fmul_rn,
// __fadd_rn) everywhere else, so nvcc's own contraction cannot move a voxel
// across a half-pixel edge; sdf / trunc is a multiply by the float32
// reciprocal, as the reference compiles it. So the kernel agrees to the bit
// with the plain PyTorch version (tsdf/volume.py fuse_blocks, which emulates
// the same fmas in float64). The pixel is chosen by round-half-to-even
// (rintf), as torch.round does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct IntegrateParams {
  float fx, fy, cx, cy, voxel, trunc, inv_trunc, max_w;
};

__global__ void __launch_bounds__(kThreads)
tsdf_integrate_kernel(const int* __restrict__ worklist, const float* __restrict__ T_cw,
                      const float* __restrict__ depth, const float* __restrict__ color,
                      int H, int W, float* __restrict__ tsdf, float* __restrict__ weight,
                      float* __restrict__ color_pool, int R, int trash, IntegrateParams p) {
  const int* row = worklist + 4 * blockIdx.x;
  const int slot = row[0];
  if (slot == trash) return;  // padding row: nothing to do
  const int bx = row[1] * R, by = row[2] * R, bz = row[3] * R;
  const int V = R * R * R;

  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = T_cw[k];

  float* t_row = tsdf + (size_t)slot * V;
  float* w_row = weight + (size_t)slot * V;
  float* c_row = color_pool + (size_t)slot * 3 * V;

  for (int lin = threadIdx.x; lin < V; lin += kThreads) {
    const int ix = lin / (R * R), iy = (lin / R) % R, iz = lin % R;
    const float wx = __fmul_rn(__fadd_rn((float)(bx + ix), 0.5f), p.voxel);
    const float wy = __fmul_rn(__fadd_rn((float)(by + iy), 0.5f), p.voxel);
    const float wz = __fmul_rn(__fadd_rn((float)(bz + iz), 0.5f), p.voxel);
    // fma(z, R2, fma(y, R1, x R0)) + t, as se3.transform_points
    const float x = __fadd_rn(fmaf(wz, T[2], fmaf(wy, T[1], __fmul_rn(wx, T[0]))), T[3]);
    const float y = __fadd_rn(fmaf(wz, T[6], fmaf(wy, T[5], __fmul_rn(wx, T[4]))), T[7]);
    const float z = __fadd_rn(fmaf(wz, T[10], fmaf(wy, T[9], __fmul_rn(wx, T[8]))), T[11]);
    if (!(z > 1e-4f)) continue;
    const float sz = fmaxf(z, 1e-6f);
    const float u = fmaf(__fdiv_rn(x, sz), p.fx, p.cx);
    const float v = fmaf(__fdiv_rn(y, sz), p.fy, p.cy);
    const float ur = rintf(u), vr = rintf(v);
    if (!(ur >= 0.f && vr >= 0.f && ur < (float)W && vr < (float)H)) continue;
    const int pix = __float2int_rn(vr) * W + __float2int_rn(ur);
    const float d = depth[pix];
    const float sdf = __fsub_rn(d, z);
    if (!(d > 0.f && sdf > -p.trunc)) continue;

    const float obs = fminf(__fmul_rn(sdf, p.inv_trunc), 1.0f);
    const float w_old = w_row[lin];
    const float inv = __fdiv_rn(1.0f, fmaxf(__fadd_rn(w_old, 1.0f), 1.0f));
    t_row[lin] = __fmul_rn(fmaf(t_row[lin], w_old, obs), inv);
    w_row[lin] = fminf(__fadd_rn(w_old, 1.0f), p.max_w);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float* c = c_row + ch * V + lin;
      *c = __fmul_rn(fmaf(*c, w_old, color[3 * pix + ch]), inv);
    }
  }
}

}  // namespace

// worklist: (M, 4) int32 rows (slot, bx, by, bz), padded with `trash`;
// T_cw: 12 floats (3x4 camera-from-world, row-major) in device memory;
// depth (H, W) and color (H, W, 3) float32; pools (cap, R^3) / (cap, 3, R^3);
// params (host): fx, fy, cx, cy, voxel, trunc, 1/trunc (float32), max_weight.
extern "C" int akr_tsdf_integrate(const int* worklist, int M, const float* T_cw,
                                  const float* depth, const float* color, int H, int W,
                                  float* tsdf, float* weight, float* color_pool, int R,
                                  int trash, const float* params, void* stream) {
  IntegrateParams p{params[0], params[1], params[2], params[3],
                    params[4], params[5], params[6], params[7]};
  if (M > 0) {
    tsdf_integrate_kernel<<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        worklist, T_cw, depth, color, H, W, tsdf, weight, color_pool, R, trash, p);
  }
  return static_cast<int>(cudaGetLastError());
}
