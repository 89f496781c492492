// Plane-residual kernel for Hopper (sm_90a): the CUDA counterpart of the
// Pallas TPU kernel sr_livo_tpu/ops/pallas/plane_fit.py::plane_residuals_pallas,
// redesigned to do the whole kNN association itself.
//
// Four entries share one neighbourhood PCA (masked mean and unnormalised 3x3
// scatter matrix of the first n_found distance-sorted neighbours, closed-form
// symmetric eigenproblem, best row cross product of A - l3 I for the normal):
//   knn_plane_rows   voxel map + keypoints + pose -> the weighted
//                    point-to-plane row h_x = w [n, -(n^T R) x p],
//                    h = dist * weight, good (ops/voxel_map.py::knn followed
//                    by models/lio.py::_plane_rows_jnp);
//   knn_plane_assoc  voxel map + keypoints -> unflipped normal, planarity
//                    a2d, closest neighbour and neighbour count, the
//                    association the cached-association IEKF reuses across
//                    iterations (models/lio.py::chunked_assoc);
//   plane_rows, plane_assoc  the same two tails on finished neighbour rows
//                    (the first port of the kernel, off the main path now).
// The arithmetic follows the plain PyTorch versions in ops/plane_fit.py and
// ops/voxel_map.py, which are its oracle.  Integer results are bit-exact
// with them: voxel coordinates by IEEE division and truncation, the 3-prime
// hash and 31-bit signature in uint32 wraparound, the probe rule of
// voxel_map._probe_chain/_resolve, the count threshold, and the top-M order
// (d2, v*K + j) ascending with d2 = (dx*dx + dy*dy) + dz*dz rounded per op
// (build without --use_fast_math; the _rn intrinsics keep nvcc from
// contracting d2 into FMAs).
//
// What bounds the fused entries: per keypoint they read the probe sectors,
// key rows and counts of V = 27 voxels (125 in the initial frames) and the
// occupied part of each found 240-byte voxel block, and do about 8 float
// operations per candidate for the distance, log2(M) for the selection and
// a 150-230 operation PCA tail.  Neighbouring keypoints share most of their
// voxels, so the distinct bytes come from device memory once and the rest
// from the 50 MB L2: for one sweep of chip_smoke.py's slice (428 keypoints)
// about 0.2 MB, 0.06 us at an H100's 3.35 TB/s, with the operations below
// that, so bytes bound them.  A launch takes far longer (about 16 us on an
// H100): a warp's serial latency sets it (dependent probe loads, one
// bulk-copy round trip, then M arg-min rounds).  One launch replaces the
// ~60 PyTorch ops of the plain kNN (probe chain, resolve, block gather, the
// (Q, V*K, 3) candidate tensor and its distances, the sort) and the plane
// launch after it, and keeps the candidates out of device memory.
//
// Design: one warp per keypoint.  (a) Lane l probes voxels l, l+32, ...;
// (b) each lane issues 1-D bulk asynchronous copies (cp.async.bulk, the
// TMA's 1-D form) of its found blocks' first cnt points, rounded up to 16
// bytes, into the warp's shared-memory slab, all completing on one
// mbarrier; (c) lanes compute the distances of their own voxels'
// candidates; (d) M rounds of a warp arg-min on the key (d2, index), two
// __reduce_min_sync each, after which the winning lane rescans its own
// candidates for its next key, so that lane j ends up holding neighbour j;
// (e) the two-pass PCA with lane = neighbour; (f) lane 0 runs the tail.
// Four warps share a block; the slab is V*K*16 bytes plus counts, slots and
// the mbarrier (8.9 KB at V = 27, 41 KB at V = 125, where the block takes
// dynamic shared memory above 48 KB).  The association entry counts the
// valid keypoint prefix on the device (every block, with
// __syncthreads_count) and writes zeros beyond it, so the caller reads
// nothing back to the host.  The PR-1 entries keep their design: one warp
// per keypoint, lanes striding over a finished row.
//
// The plain C entry points return cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a configuration the kernel cannot take); the
// ctypes wrapper raises when that is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kFusedWarps = 4;             // warps per block, fused entries
constexpr int kMaxSharedBytes = 232448;    // 227 KB a block may use
constexpr float kTwoPi3 = 2.0943951023931953f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;    // "no candidate left" key part
constexpr int kSigEmpty = -1;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Pca {
  float nx, ny, nz;  // unit normal (smallest-eigenvalue direction)
  float a2d;         // planarity (s2 - s3) / s1
};

// Masked two-pass PCA of one keypoint's neighbours; `row(j)` returns
// neighbour j (called for j < cnt only).  Every lane of the warp returns
// the same result.
template <typename Row>
__device__ __forceinline__ Pca neighbourhood_pca(Row row, int cnt, int m,
                                                 int lane) {
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j = lane; j < m; j += 32) {
    if (j < cnt) {
      const float3 p = row(j);
      sx += p.x;
      sy += p.y;
      sz += p.z;
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
      const float3 p = row(j);
      const float cx = p.x - mx;
      const float cy = p.y - my;
      const float cz = p.z - mz;
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

// Parameters of the full row's tail (the planarity weight and gates).
struct RowParams {
  float lam_w, lam_nb, power, max_dist;
  int min_nb;
  float nb_decay;
};

// The full row of keypoint k from its PCA, closest neighbour c0 and
// neighbour count (lane 0 only): orientation, weight, distance, gates,
// Jacobian row.
__device__ __forceinline__ void row_tail(
    const Pca& pca, float c0x, float c0y, float c0z, int cnt, bool valid,
    int k, const float* __restrict__ world,
    const float* __restrict__ location, const float* __restrict__ r_world,
    const float* __restrict__ last_trans, const RowParams& rp,
    float* __restrict__ h_x, float* __restrict__ h,
    unsigned char* __restrict__ good) {
  const float wx = world[3 * k + 0], wy = world[3 * k + 1],
              wz = world[3 * k + 2];
  float nx = pca.nx, ny = pca.ny, nz = pca.nz;
  // Orient toward the previous sensor position (optimize.cpp:49-51).
  const float dot = nx * (last_trans[0] - wx) + ny * (last_trans[1] - wy)
                    + nz * (last_trans[2] - wz);
  if (dot < 0.f) {
    nx = -nx; ny = -ny; nz = -nz;
  }
  const float ddx = c0x - wx, ddy = c0y - wy, ddz = c0z - wz;
  const float dcl = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
  const float weight = rp.lam_w * powf(pca.a2d, rp.power)
                       + rp.lam_nb * expf(-dcl / rp.nb_decay);
  const float offset = -(nx * c0x + ny * c0y + nz * c0z);
  const float dist = (nx * wx + ny * wy + nz * wz) + offset;
  const bool ok = valid && cnt >= rp.min_nb && dist < rp.max_dist;
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

// A zero row, not good (a keypoint the fused row entry skips).
__device__ __forceinline__ void zero_row(int k, float* __restrict__ h_x,
                                         float* __restrict__ h,
                                         unsigned char* __restrict__ good) {
#pragma unroll
  for (int i = 0; i < 6; ++i) h_x[6 * static_cast<size_t>(k) + i] = 0.f;
  h[k] = 0.f;
  good[k] = 0;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
plane_rows_kernel(const float* __restrict__ nb, const int* __restrict__ n_found,
                  const float* __restrict__ world,
                  const float* __restrict__ location,
                  const float* __restrict__ r_world,
                  const float* __restrict__ last_trans,
                  const unsigned char* __restrict__ valid, int q_rows, int m,
                  RowParams rp, float* __restrict__ h_x,
                  float* __restrict__ h, unsigned char* __restrict__ good) {
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= q_rows) return;  // uniform per warp
  const float* row = nb + static_cast<size_t>(k) * m * 3;
  const int cnt = n_found[k];
  const Pca pca = neighbourhood_pca(
      [row](int j) {
        return make_float3(row[3 * j + 0], row[3 * j + 1], row[3 * j + 2]);
      },
      cnt, m, lane);
  if (lane != 0) return;
  row_tail(pca, row[0], row[1], row[2], cnt, valid[k] != 0, k, world,
           location, r_world, last_trans, rp, h_x, h, good);
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
  const Pca pca = neighbourhood_pca(
      [row](int j) {
        return make_float3(row[3 * j + 0], row[3 * j + 1], row[3 * j + 2]);
      },
      n_found[k], m, lane);
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

// ---------------------------------------------------------------------------
// The fused entries: kNN over the voxel map + PCA + tail, one warp a keypoint
// ---------------------------------------------------------------------------

struct MapView {
  const int* __restrict__ keys;      // (C, 3) voxel coords
  const int* __restrict__ sig;       // (C,) 31-bit signature, -1 = empty
  const int* __restrict__ counts;    // (C,) points per block
  const float* __restrict__ points;  // (C * K, 3)
  unsigned mask;                     // C - 1 (C a power of two)
  int k;                             // K, points per block
};

struct Search {
  const float* __restrict__ world;          // (Q, 3)
  const unsigned char* __restrict__ valid;  // (Q,)
  const int* __restrict__ threshold;        // () count threshold
  int q_rows;
  float voxel_size;
  int nb;         // neighbourhood radius in voxels: V = (2 nb + 1)^3
  int max_probe;
  int m;          // neighbours kept, <= 32
};

__host__ __device__ inline int voxels_of(int nb) {
  const int side = 2 * nb + 1;
  return side * side * side;
}

// Offset of the mbarrier in a warp's slab: V*K points (12 B) and distance
// keys (4 B), then V counts and V slots, rounded up to 16 bytes.
__host__ __device__ inline int barrier_offset(int nv, int k) {
  return (nv * k * 16 + nv * 8 + 15) / 16 * 16;
}

// Shared memory of one warp.
__host__ __device__ inline int warp_slab_bytes(int nb, int k) {
  return barrier_offset(voxels_of(nb), k) + 16;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(unsigned dst, const void* src,
                                              unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Slot of voxel (cx, cy, cz), -1 when absent: the first signature match
// along the probe chain, taken only before the first empty slot and
// verified against the keys (a verify miss is absent; no probing on).
__device__ __forceinline__ int probe(const MapView& map, int cx, int cy,
                                     int cz, int max_probe) {
  const unsigned ux = static_cast<unsigned>(cx);
  const unsigned uy = static_cast<unsigned>(cy);
  const unsigned uz = static_cast<unsigned>(cz);
  const unsigned base = (ux * 73856093u + uy * 19349669u + uz * 83492791u)
                        & map.mask;
  unsigned hs = ux * 2654435761u + uy * 2246822519u + uz * 3266489917u;
  hs ^= hs >> 15;
  const int want = static_cast<int>(hs & 0x7fffffffu);
  for (int p = 0; p < max_probe; ++p) {
    const unsigned slot = (base + static_cast<unsigned>(p)) & map.mask;
    const int s = map.sig[slot];
    if (s == want) {
      const int* key = map.keys + 3 * static_cast<size_t>(slot);
      return (key[0] == cx && key[1] == cy && key[2] == cz)
                 ? static_cast<int>(slot) : -1;
    }
    if (s == kSigEmpty) return -1;
  }
  return -1;
}

struct Assoc {
  Pca pca;
  int n_found;
  float cx, cy, cz;  // closest neighbour
};

// kNN of world point (wx, wy, wz) over the (2 nb + 1)^3 voxels around it and
// the PCA of the neighbours; every lane returns the same result.
__device__ Assoc associate(const MapView& map, const Search& sp, int thr,
                           float wx, float wy, float wz,
                           unsigned char* __restrict__ slab, int lane) {
  const int side = 2 * sp.nb + 1;
  const int nv = side * side * side;
  const int K = map.k;
  float* pts = reinterpret_cast<float*>(slab);
  unsigned* d2_bits = reinterpret_cast<unsigned*>(slab + nv * K * 12);
  int* cnt_s = reinterpret_cast<int*>(slab + nv * K * 16);
  int* slot_s = cnt_s + nv;
  const unsigned bar = smem_u32(slab + barrier_offset(nv, K));
  if (lane == 0) mbar_init(bar, 32);
  __syncwarp();

  // (a) probe: lane l takes voxels l, l + 32, ... in meshgrid "ij" order
  // (x slowest), the flat candidate order v * K + j of the plain kNN.
  const int qx = __float2int_rz(__fdiv_rn(wx, sp.voxel_size));
  const int qy = __float2int_rz(__fdiv_rn(wy, sp.voxel_size));
  const int qz = __float2int_rz(__fdiv_rn(wz, sp.voxel_size));
  unsigned bytes = 0;
  int slot0 = -1;
  for (int v = lane; v < nv; v += 32) {
    const int ox = v / (side * side) - sp.nb;
    const int oy = (v / side) % side - sp.nb;
    const int oz = v % side - sp.nb;
    const int slot = probe(
        map, static_cast<int>(static_cast<unsigned>(qx) + ox),
        static_cast<int>(static_cast<unsigned>(qy) + oy),
        static_cast<int>(static_cast<unsigned>(qz) + oz), sp.max_probe);
    int c = slot >= 0 ? min(map.counts[slot], K) : 0;
    c = c >= thr ? c : 0;
    cnt_s[v] = c;
    slot_s[v] = slot;
    bytes += (c * 12 + 15) & ~15;
    if (v == 0) slot0 = slot;
  }
  // (b) bulk copies of the occupied part of each found block into the slab
  // at the block's own place v * K, completing on the warp's mbarrier.
  mbar_arrive_expect_tx(bar, bytes);
  for (int v = lane; v < nv; v += 32) {
    const int c = cnt_s[v];
    if (c > 0) {
      bulk_copy_g2s(smem_u32(pts + 3 * v * K),
                    map.points + 3 * static_cast<size_t>(slot_s[v]) * K,
                    (c * 12 + 15) & ~15, bar);
    }
  }
  mbar_wait(bar, 0);

  // (c) distances of the lane's own candidates, and the lane's best key.
  unsigned best_d = kNone, best_i = kNone;
  for (int v = lane; v < nv; v += 32) {
    const int c = cnt_s[v];
    for (int j = 0; j < c; ++j) {
      const int idx = v * K + j;
      const float* p = pts + 3 * idx;
      const float dx = __fsub_rn(p[0], wx);
      const float dy = __fsub_rn(p[1], wy);
      const float dz = __fsub_rn(p[2], wz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const unsigned b = __float_as_uint(d2);  // d2 >= 0: bits order as floats
      d2_bits[idx] = b;
      if (b < best_d) {  // indices ascend, so a tie keeps the lower one
        best_d = b;
        best_i = static_cast<unsigned>(idx);
      }
    }
  }

  // (d) M rounds of a warp arg-min on (d2, index); lane r keeps pick r.
  int n_found = 0;
  int sel = -1;
  for (int r = 0; r < sp.m; ++r) {
    const unsigned md = __reduce_min_sync(kFull, best_d);
    if (md == kNone) break;  // fewer than M candidates
    const unsigned mi =
        __reduce_min_sync(kFull, best_d == md ? best_i : kNone);
    if (lane == r) sel = static_cast<int>(mi);
    ++n_found;
    if (best_i == mi) {  // the winner moves on to its next key
      const unsigned long long last =
          (static_cast<unsigned long long>(md) << 32) | mi;
      unsigned long long next = ~0ull;
      for (int v = lane; v < nv; v += 32) {
        const int c = cnt_s[v];
        for (int j = 0; j < c; ++j) {
          const unsigned idx = static_cast<unsigned>(v * K + j);
          const unsigned long long key =
              (static_cast<unsigned long long>(d2_bits[idx]) << 32) | idx;
          if (key > last && key < next) next = key;
        }
      }
      best_d = next == ~0ull ? kNone : static_cast<unsigned>(next >> 32);
      best_i = next == ~0ull ? kNone : static_cast<unsigned>(next);
    }
  }

  // (e) PCA with lane = neighbour.
  Assoc out;
  out.n_found = n_found;
  out.pca = neighbourhood_pca(
      [pts, sel](int) {
        const float* p = pts + 3 * sel;
        return make_float3(p[0], p[1], p[2]);
      },
      n_found, sp.m, lane);
  // The closest neighbour; with none, the plain kNN's first padding pick:
  // point 0 of voxel 0's block, or of block 0 when voxel 0 is absent.
  const int sel0 = __shfl_sync(kFull, sel, 0);
  const int s0 = __shfl_sync(kFull, slot0, 0);
  const float* c0 = n_found > 0
      ? pts + 3 * sel0
      : map.points + 3 * static_cast<size_t>(s0 >= 0 ? s0 : 0) * K;
  out.cx = c0[0];
  out.cy = c0[1];
  out.cz = c0[2];
  return out;
}

__global__ void __launch_bounds__(32 * kFusedWarps)
knn_plane_assoc_kernel(MapView map, Search sp, int slab_bytes,
                       float* __restrict__ normal, float* __restrict__ a2d,
                       float* __restrict__ closest,
                       int* __restrict__ n_found) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * (blockDim.x >> 5) + warp;
  // Keypoints are prefix-compacted: rows at or past the valid count are
  // not associated.  Every block counts them itself.
  int n_valid = 0;
  for (int i0 = 0; i0 < sp.q_rows; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    n_valid += __syncthreads_count(i < sp.q_rows && sp.valid[i] != 0);
  }
  if (k >= sp.q_rows) return;  // uniform per warp
  if (k >= n_valid) {
    if (lane < 3) {
      normal[3 * k + lane] = 0.f;
      closest[3 * k + lane] = 0.f;
    }
    if (lane == 0) {
      a2d[k] = 0.f;
      n_found[k] = 0;
    }
    return;
  }
  const Assoc a = associate(map, sp, *sp.threshold, sp.world[3 * k + 0],
                            sp.world[3 * k + 1], sp.world[3 * k + 2],
                            smem + warp * slab_bytes, lane);
  if (lane != 0) return;
  normal[3 * k + 0] = a.pca.nx;
  normal[3 * k + 1] = a.pca.ny;
  normal[3 * k + 2] = a.pca.nz;
  a2d[k] = a.pca.a2d;
  closest[3 * k + 0] = a.cx;
  closest[3 * k + 1] = a.cy;
  closest[3 * k + 2] = a.cz;
  n_found[k] = a.n_found;
}

__global__ void __launch_bounds__(32 * kFusedWarps)
knn_plane_rows_kernel(MapView map, Search sp, int slab_bytes,
                      const float* __restrict__ location,
                      const float* __restrict__ r_world,
                      const float* __restrict__ last_trans, RowParams rp,
                      float* __restrict__ h_x, float* __restrict__ h,
                      unsigned char* __restrict__ good) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * (blockDim.x >> 5) + warp;
  if (k >= sp.q_rows) return;  // uniform per warp
  if (sp.valid[k] == 0) {      // skipped: a zero row, not good
    if (lane == 0) zero_row(k, h_x, h, good);
    return;
  }
  const Assoc a = associate(map, sp, *sp.threshold, sp.world[3 * k + 0],
                            sp.world[3 * k + 1], sp.world[3 * k + 2],
                            smem + warp * slab_bytes, lane);
  if (lane != 0) return;
  row_tail(a.pca, a.cx, a.cy, a.cz, a.n_found, true, k, sp.world, location,
           r_world, last_trans, rp, h_x, h, good);
}

// Warps per block and dynamic shared memory of a fused launch; false when
// one warp's slab does not fit.  Above 48 KB the kernel is allowed more.
template <typename Kernel>
bool fused_config(Kernel kernel, int nb, int k, int* warps, int* slab,
                  int* smem) {
  *slab = warp_slab_bytes(nb, k);
  int w = kFusedWarps;
  while (w > 1 && w * *slab > kMaxSharedBytes) --w;
  *warps = w;
  *smem = w * *slab;
  if (*smem > kMaxSharedBytes) return false;
  if (*smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *smem) != cudaSuccess) {
    return false;
  }
  return true;
}

MapView map_view(const int* keys, const int* sig, const int* counts,
                 const float* points, int capacity, int k) {
  return MapView{keys, sig, counts, points,
                 static_cast<unsigned>(capacity - 1), k};
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
  const RowParams rp{lam_w, lam_nb, power, max_dist, min_nb, nb_decay};
  plane_rows_kernel<<<blocks_for(q_rows), 32 * kWarpsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      nb, n_found, world, location, r_world, last_trans, valid, q_rows, m,
      rp, h_x, h, good);
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

extern "C" int knn_plane_assoc_launch(
    const int* keys, const int* sig, const int* counts, const float* points,
    int capacity, int k, const float* world, const unsigned char* valid,
    const int* threshold, int q_rows, float voxel_size, int nb, int max_probe,
    int m, float* normal, float* a2d, float* closest, int* n_found,
    void* stream) {
  int warps, slab, smem;
  if (m < 1 || m > 32 ||
      !fused_config(knn_plane_assoc_kernel, nb, k, &warps, &slab, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Search sp{world, valid, threshold, q_rows, voxel_size, nb, max_probe,
                  m};
  knn_plane_assoc_kernel<<<(q_rows + warps - 1) / warps, 32 * warps, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      map_view(keys, sig, counts, points, capacity, k), sp, slab, normal, a2d,
      closest, n_found);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int knn_plane_rows_launch(
    const int* keys, const int* sig, const int* counts, const float* points,
    int capacity, int k, const float* world, const unsigned char* valid,
    const int* threshold, int q_rows, float voxel_size, int nb, int max_probe,
    int m, const float* location, const float* r_world,
    const float* last_trans, float lam_w, float lam_nb, float power,
    float max_dist, int min_nb, float nb_decay, float* h_x, float* h,
    unsigned char* good, void* stream) {
  int warps, slab, smem;
  if (m < 1 || m > 32 ||
      !fused_config(knn_plane_rows_kernel, nb, k, &warps, &slab, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Search sp{world, valid, threshold, q_rows, voxel_size, nb, max_probe,
                  m};
  const RowParams rp{lam_w, lam_nb, power, max_dist, min_nb, nb_decay};
  knn_plane_rows_kernel<<<(q_rows + warps - 1) / warps, 32 * warps, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      map_view(keys, sig, counts, points, capacity, k), sp, slab, location,
      r_world, last_trans, rp, h_x, h, good);
  return static_cast<int>(cudaGetLastError());
}
