// Plane-residual kernel for Hopper (sm_90a): the CUDA counterpart of the
// Pallas TPU kernel sr_livo_tpu/ops/pallas/plane_fit.py::plane_residuals_pallas.
//
// For each keypoint it takes the masked mean and the unnormalised 3x3
// scatter matrix of its first n_found distance-sorted kNN neighbours,
// solves the closed-form symmetric eigenproblem (trigonometric eigenvalues,
// best row cross product of A - l3 I for the normal) and then either
//   (a) plane_rows:  builds the weighted point-to-plane row
//                    h_x = w [n, -(n^T R) x p], h = dist * weight, good; or
//   (b) plane_assoc: returns the association half (unflipped normal,
//                    planarity a2d, closest neighbour) that the cached-
//                    association IEKF reuses across iterations.
// The arithmetic follows the plain PyTorch versions in ops/plane_fit.py
// (ports of models/lio.py::_plane_rows_jnp and
// ops/neighborhood.py::neighborhood_distribution), which are its oracle.
//
// What bounds it: plane_rows at Q = 1024 keypoints and M = 20 neighbours
// reads about 1024 * (60 + 11) * 4 B = 0.29 MB and writes 0.03 MB, about
// 0.1 us at the H100's 3.35 TB/s (plane_assoc on the main path's 512-row
// slices moves about half of that), and does a few hundred float operations per
// keypoint (negligible against 67 TFLOP/s), so a launch (several us) bounds
// it.  The design does nothing about that yet: one warp per keypoint, lanes
// stride over the neighbours with coalesced loads, the eight sums are warp
// shuffle reductions, every lane then runs the eigen solve, and lane 0 runs
// the row tail and writes.  CUDA graphs and fusing with the kNN gather are
// later work.
//
// The plain C entry points return cudaGetLastError() after the launch; the
// ctypes wrapper raises when that is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kTwoPi3 = 2.0943951023931953f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Pca {
  float nx, ny, nz;  // unit normal (smallest-eigenvalue direction)
  float a2d;         // planarity (s2 - s3) / s1
};

// Masked two-pass PCA of one keypoint's neighbour row; every lane of the
// warp returns the same result.
__device__ __forceinline__ Pca neighbourhood_pca(const float* __restrict__ row,
                                                 int cnt, int m, int lane) {
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j = lane; j < m; j += 32) {
    if (j < cnt) {
      sx += row[3 * j + 0];
      sy += row[3 * j + 1];
      sz += row[3 * j + 2];
    }
  }
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  sz = warp_sum(sz);
  const float cnt_safe = fmaxf(static_cast<float>(cnt), 1.0f);
  const float mx = sx / cnt_safe, my = sy / cnt_safe, mz = sz / cnt_safe;

  float a00 = 0.f, a01 = 0.f, a02 = 0.f, a11 = 0.f, a12 = 0.f, a22 = 0.f;
  for (int j = lane; j < m; j += 32) {
    if (j < cnt) {
      const float cx = row[3 * j + 0] - mx;
      const float cy = row[3 * j + 1] - my;
      const float cz = row[3 * j + 2] - mz;
      a00 += cx * cx;
      a01 += cx * cy;
      a02 += cx * cz;
      a11 += cy * cy;
      a12 += cy * cz;
      a22 += cz * cz;
    }
  }
  a00 = warp_sum(a00);
  a01 = warp_sum(a01);
  a02 = warp_sum(a02);
  a11 = warp_sum(a11);
  a12 = warp_sum(a12);
  a22 = warp_sum(a22);

  // Eigenvalues, descending (eigvals_sym3x3).
  const float q = (a00 + a11 + a22) / 3.0f;
  const float p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  const float p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.0f, 1e-30f));
  const float detb = b00 * (b11 * b22 - a12 * a12)
                     - a01 * (a01 * b22 - a12 * a02)
                     + a02 * (a01 * a12 - b11 * a02);
  const float r = fminf(fmaxf(detb / (2.0f * p * p * p), -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  float l1 = q + 2.0f * p * cosf(phi);
  float l3 = q + 2.0f * p * cosf(phi + kTwoPi3);
  float l2 = 3.0f * q - l1 - l3;
  if (p2 < 1e-20f) {
    l1 = q;
    l2 = q;
    l3 = q;
  }

  // Eigenvector of l3: the largest-norm cross product of rows of A - l3 I
  // (first on ties), e_z when its norm is not above 1e-12 (eigvec_for).
  const float m00 = a00 - l3, m11 = a11 - l3, m22 = a22 - l3;
  const float c01x = a01 * a12 - a02 * m11;
  const float c01y = a02 * a01 - m00 * a12;
  const float c01z = m00 * m11 - a01 * a01;
  const float c02x = a01 * m22 - a02 * a12;
  const float c02y = a02 * a02 - m00 * m22;
  const float c02z = m00 * a12 - a01 * a02;
  const float c12x = m11 * m22 - a12 * a12;
  const float c12y = a12 * a02 - a01 * m22;
  const float c12z = a01 * a12 - m11 * a02;
  const float n01 = c01x * c01x + c01y * c01y + c01z * c01z;
  const float n02 = c02x * c02x + c02y * c02y + c02z * c02z;
  const float n12 = c12x * c12x + c12y * c12y + c12z * c12z;
  float bx = c01x, by = c01y, bz = c01z, bn = n01;
  if (n02 > bn) {
    bx = c02x; by = c02y; bz = c02z; bn = n02;
  }
  if (n12 > bn) {
    bx = c12x; by = c12y; bz = c12z; bn = n12;
  }
  const float nrm = sqrtf(bn);
  Pca out;
  if (nrm > 1e-12f) {
    const float inv = 1.0f / fmaxf(nrm, 1e-30f);
    out.nx = bx * inv;
    out.ny = by * inv;
    out.nz = bz * inv;
  } else {
    out.nx = 0.f;
    out.ny = 0.f;
    out.nz = 1.f;
  }
  const float s1 = sqrtf(fabsf(l1)), s2 = sqrtf(fabsf(l2)),
              s3 = sqrtf(fabsf(l3));
  out.a2d = (s2 - s3) / fmaxf(s1, 1e-12f);
  return out;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
plane_rows_kernel(const float* __restrict__ nb, const int* __restrict__ n_found,
                  const float* __restrict__ world,
                  const float* __restrict__ location,
                  const float* __restrict__ r_world,
                  const float* __restrict__ last_trans,
                  const unsigned char* __restrict__ valid, int q_rows, int m,
                  float lam_w, float lam_nb, float power, float max_dist,
                  int min_nb, float nb_decay, float* __restrict__ h_x,
                  float* __restrict__ h, unsigned char* __restrict__ good) {
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= q_rows) return;  // uniform per warp
  const float* row = nb + static_cast<size_t>(k) * m * 3;
  const int cnt = n_found[k];
  const Pca pca = neighbourhood_pca(row, cnt, m, lane);
  if (lane != 0) return;

  const float wx = world[3 * k + 0], wy = world[3 * k + 1],
              wz = world[3 * k + 2];
  float nx = pca.nx, ny = pca.ny, nz = pca.nz;
  // Orient toward the previous sensor position (optimize.cpp:49-51).
  const float dot = nx * (last_trans[0] - wx) + ny * (last_trans[1] - wy)
                    + nz * (last_trans[2] - wz);
  if (dot < 0.f) {
    nx = -nx; ny = -ny; nz = -nz;
  }
  const float c0x = row[0], c0y = row[1], c0z = row[2];
  const float ddx = c0x - wx, ddy = c0y - wy, ddz = c0z - wz;
  const float dcl = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
  const float weight = lam_w * powf(pca.a2d, power)
                       + lam_nb * expf(-dcl / nb_decay);
  const float offset = -(nx * c0x + ny * c0y + nz * c0z);
  const float dist = (nx * wx + ny * wy + nz * wz) + offset;
  const bool ok = valid[k] && cnt >= min_nb && dist < max_dist;
  const float w = ok ? weight : 0.f;

  // J_rot = -n^T R [p]x  (optimize.cpp:101), u = n^T R.
  const float ux = nx * r_world[0] + ny * r_world[3] + nz * r_world[6];
  const float uy = nx * r_world[1] + ny * r_world[4] + nz * r_world[7];
  const float uz = nx * r_world[2] + ny * r_world[5] + nz * r_world[8];
  const float px = location[3 * k + 0], py = location[3 * k + 1],
              pz = location[3 * k + 2];
  float* out = h_x + 6 * static_cast<size_t>(k);
  out[0] = nx * w;
  out[1] = ny * w;
  out[2] = nz * w;
  out[3] = -(uy * pz - uz * py) * w;
  out[4] = -(uz * px - ux * pz) * w;
  out[5] = -(ux * py - uy * px) * w;
  h[k] = ok ? dist * weight : 0.f;
  good[k] = ok ? 1 : 0;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
plane_assoc_kernel(const float* __restrict__ nb,
                   const int* __restrict__ n_found, int q_rows, int m,
                   float* __restrict__ normal, float* __restrict__ a2d,
                   float* __restrict__ closest) {
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= q_rows) return;  // uniform per warp
  const float* row = nb + static_cast<size_t>(k) * m * 3;
  const Pca pca = neighbourhood_pca(row, n_found[k], m, lane);
  if (lane < 3) closest[3 * k + lane] = row[lane];
  if (lane != 0) return;
  normal[3 * k + 0] = pca.nx;
  normal[3 * k + 1] = pca.ny;
  normal[3 * k + 2] = pca.nz;
  a2d[k] = pca.a2d;
}

inline int blocks_for(int q_rows) {
  return (q_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

extern "C" int plane_rows_launch(const float* nb, const int* n_found,
                                 const float* world, const float* location,
                                 const float* r_world, const float* last_trans,
                                 const unsigned char* valid, int q_rows, int m,
                                 float lam_w, float lam_nb, float power,
                                 float max_dist, int min_nb, float nb_decay,
                                 float* h_x, float* h, unsigned char* good,
                                 void* stream) {
  plane_rows_kernel<<<blocks_for(q_rows), 32 * kWarpsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      nb, n_found, world, location, r_world, last_trans, valid, q_rows, m,
      lam_w, lam_nb, power, max_dist, min_nb, nb_decay, h_x, h, good);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plane_assoc_launch(const float* nb, const int* n_found,
                                  int q_rows, int m, float* normal, float* a2d,
                                  float* closest, void* stream) {
  plane_assoc_kernel<<<blocks_for(q_rows), 32 * kWarpsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      nb, n_found, q_rows, m, normal, a2d, closest);
  return static_cast<int>(cudaGetLastError());
}
