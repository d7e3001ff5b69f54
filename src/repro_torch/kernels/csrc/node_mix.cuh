// The node-order mix of a column tile, shared by the step kernels (sm_90a).
//
// Included by qg_update.cu (qg_step: the dense-gossip step) and compress.cu
// (choco_exchange: the compressed-gossip exchange), each of which builds
// into its own library.  Both take a table of node-stacked leaves [n, f]
// (n nodes, f columns) by value and cut each leaf into tiles of kStepCols
// columns of all n rows: the mix W @ a runs along the node axis only, so a
// block that holds one column tile of all nodes holds all that those
// columns need.  A block walks tiles blockIdx.x, + gridDim.x, ... and finds
// its leaf by a binary search over the leaves' first tiles (the Python
// wrapper lays the tiles out).
//
// Its threads are kStepCols/4 column groups (4 columns each) by ceil(n / R)
// row groups of R consecutive rows: each thread mixes R rows of its 4
// columns, so one read of a row of a from shared memory serves R outputs,
// and W is kept transposed there, so the R weights of a term are one vector
// read.  R is 2 up to 16 nodes and 4 above.  The mix sums in node order,
// k = 0..n-1, one __fmul_rn and one __fadd_rn a term, so it rounds as the
// same sum written out in PyTorch does.
//
// A leaf whose f is a multiple of 4 with every stream 16-byte aligned runs
// on float4 (4 contiguous columns a thread); any other on a scalar loop of
// the same kernel (4 columns a quarter tile apart a thread, so that a
// warp's loads stay coalesced).
#pragma once

#include "elementwise.cuh"

namespace {

constexpr int kStepCols = 64;                   // columns of a tile
constexpr int kStepMaxNodes = 64;               // W and a tile in smem
constexpr int kStepMaxThreads = 256;

// The post-mix QG refresh behind the Alg. 3 tau gate: also the body of
// qg_update.cu's fused_qg_buffer.
struct QgBuffer {
  const float* eta;      // fp32 [1]
  const float* refresh;  // fp32 [1]: write the new buffer iff != 0
  float mu, one_minus_mu;

  struct Bound {
    float s, mu, one_minus_mu;
    bool on;
    __device__ __forceinline__ void operator()(float x_pre, float x_post,
                                               float m, float& out,
                                               float&) const {
      if (!on) {
        out = m;
        return;
      }
      const float d = __fmul_rn(s, __fsub_rn(x_pre, x_post));
      out = __fadd_rn(__fmul_rn(mu, m), __fmul_rn(one_minus_mu, d));
    }
  };
  __device__ __forceinline__ Bound bind() const {
    return {__fdiv_rn(1.0f, __ldg(eta)), mu, one_minus_mu,
            __ldg(refresh) != 0.0f};
  }
};

// Column e (0..3) of 4-column group q in a tile: contiguous on the float4
// path; a quarter tile apart on the scalar loop, so that neighbouring
// threads load neighbouring floats.
__device__ __forceinline__ int step_col(bool vec, int q, int e) {
  return vec ? 4 * q + e : q + kStepCols / 4 * e;
}

__device__ __forceinline__ float& lane(float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Rows a thread mixes, the row stride of W^T in shared memory (n padded
// to R), threads a block (whole warps) and shared memory of a block: W^T
// [n][stride] (padded to 16 bytes), then one tile of the mixed tree
// [n][kStepCols].
__host__ __device__ __forceinline__ int step_rows(int nodes) {
  return nodes <= 16 ? 2 : 4;
}
__host__ __device__ __forceinline__ int step_stride(int nodes, int r) {
  return (nodes + r - 1) / r * r;
}
__host__ __device__ __forceinline__ int step_wt_floats(int nodes, int r) {
  return (nodes * step_stride(nodes, r) + 3) & ~3;
}
inline int step_threads(int nodes, int r) {
  return ((nodes + r - 1) / r * (kStepCols / 4) + 31) / 32 * 32;
}
inline size_t step_smem(int nodes, int r) {
  return sizeof(float) * (step_wt_floats(nodes, r) + nodes * kStepCols);
}

// Blocks that fill the card once with one instantiation ``kernel`` of a
// step kernel (its blocks an SM holds, by node count, cached in ``per_sm``
// at the first launch of each), or ``tiles`` if fewer.
template <class Kernel>
cudaError_t step_grid(Kernel kernel, int (&per_sm)[kStepMaxNodes + 1],
                      int nodes, int threads, size_t smem, int64_t tiles,
                      int64_t* blocks) {
  static int sms = 0;
  cudaError_t err = cudaSuccess;
  if (per_sm[nodes] == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[nodes], kernel,
                                                        threads, smem);
  if (err == cudaSuccess && sms == 0) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t cap =
      static_cast<int64_t>(sms) * (per_sm[nodes] > 0 ? per_sm[nodes] : 1);
  *blocks = tiles < cap ? tiles : cap;
  return cudaSuccess;
}

// The leaf of tile t (the last whose first tile <= t) in a table with
// fields ``n`` (leaves) and ``leaf[i].tile0``; j0 receives the tile's first
// column in it.
template <class Group>
__device__ __forceinline__ const auto& step_leaf(const Group& grp, int64_t t,
                                                 int64_t& j0) {
  int lo = 0, hi = static_cast<int>(grp.n) - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (grp.leaf[mid].tile0 <= t) lo = mid;
    else hi = mid - 1;
  }
  j0 = (t - grp.leaf[lo].tile0) * kStepCols;
  return grp.leaf[lo];
}

// Rows r0 .. r0+R-1 of the stream p [nodes, f] at the thread's 4 columns of
// the tile at column j0 (0 off the leaf, and everywhere unless ``on``).
template <int R>
__device__ __forceinline__ void load_rows(const float* p, int64_t f,
                                          int64_t j0, bool vec, bool on,
                                          int r0, int q, int nodes,
                                          float4 (&v)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!on || r0 + r >= nodes) continue;
    const int64_t row = static_cast<int64_t>(r0 + r) * f;
    if (vec) {
      const int64_t c = j0 + 4 * q;
      if (c < f) v[r] = *reinterpret_cast<const float4*>(p + row + c);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t c = j0 + step_col(false, q, e);
        if (c < f) lane(v[r], e) = p[row + c];
      }
    }
  }
}

// Store v at the thread's 4 columns of the row starting at p + row.
__device__ __forceinline__ void store_row(float* p, int64_t row, int64_t f,
                                          int64_t j0, bool vec, int q,
                                          float4 v) {
  if (vec) {
    const int64_t c = j0 + 4 * q;
    if (c < f) *reinterpret_cast<float4*>(p + row + c) = v;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t c = j0 + step_col(false, q, e);
      if (c < f) p[row + c] = lane(v, e);
    }
  }
}

// Put v at the thread's 4 columns of a tile row in shared memory.
__device__ __forceinline__ void put_tile_row(float* srow, bool vec, int q,
                                             float4 v) {
  if (vec) {
    reinterpret_cast<float4*>(srow)[q] = v;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) srow[step_col(false, q, e)] = lane(v, e);
  }
}

// W^T of the fp32 [nodes, nodes] device tensor w into shared memory:
// swt[j*stride+i] = W[i,j], 0 in the padding.
__device__ __forceinline__ void load_wt(float* swt, const float* w,
                                        int nodes, int stride) {
  for (int k = threadIdx.x; k < nodes * stride; k += blockDim.x) {
    const int j = k / stride, i = k - j * stride;
    swt[k] = i < nodes ? w[i * nodes + j] : 0.0f;
  }
}

template <int R>
__device__ __forceinline__ void load_weights(const float* p, float (&w)[R]) {
  if constexpr (R == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}

// acc[r] = sum_k W[r0+r, k] * tile[k] over the thread's 4 columns, in node
// order k = 0..n-1, from the tile [nodes][kStepCols] and W^T in shared
// memory.
template <int R>
__device__ __forceinline__ void mix_rows(const float* tile, const float* swt,
                                         int stride, int nodes, int q,
                                         int r0, bool vec, float4 (&acc)[R]) {
  for (int j = 0; j < nodes; ++j) {
    float4 aj;
    if (vec) {
      aj = reinterpret_cast<const float4*>(tile + j * kStepCols)[q];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        lane(aj, e) = tile[j * kStepCols + step_col(false, q, e)];
    }
    float wj[R];
    load_weights<R>(swt + j * stride + r0, wj);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __fmul_rn(wj[r], lane(aj, e));
        lane(acc[r], e) = j == 0 ? p : __fadd_rn(lane(acc[r], e), p);
      }
    }
  }
}

}  // namespace
