// Shared launch machinery of the streaming elementwise kernels (sm_90a).
//
// Included by qg_update.cu and compress.cu, each of which builds into its
// own library.  Two shapes of pass:
//
//   launch3   one pass over three fp32 streams of one length into one or
//             two outputs: a 1-D grid-stride loop with 64-bit indices and a
//             masked ragged tail, float4 loads and stores only when every
//             pointer is 16-byte aligned, else the scalar loop;
//   launch_rowwise_group
//             one pass over a group of [rows, f] matrices (each, optionally,
//             with a second matrix of its shape) with one fp32 scalar per
//             row, into two outputs of each shape: one launch for up to
//             kMaxLeaves matrices, every row on float4 between a peeled
//             head and a masked tail (see below).  Nothing is padded.
//
// An Op supplies bind(...) -> a functor applied per element; the functors
// use explicit round-to-nearest intrinsics so that no product and sum fuse
// (the build also passes -fmad=false).  Launches go on the caller's stream;
// nothing syncs or allocates here, and each launcher returns
// cudaGetLastError() for the Python wrapper to check.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 threads = an SM's 2048

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// SMs of the current device.
cudaError_t sm_count(int* sms) {
  int device = 0;
  *sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return err;
}

// Blocks that fill the card once: kBlocksPerSm per SM of the current device.
cudaError_t block_cap(int64_t* cap) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  *cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  return err;
}

// One pass over three fp32 inputs into one output, or two when o1 is set.
template <class Op, bool kVec>
__global__ void __launch_bounds__(kThreads)
    stream3(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ c, float* __restrict__ o0,
            float* __restrict__ o1, int64_t n, Op op) {
  const auto f = op.bind();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t start = 0;
  if (kVec) {
    const int64_t nv = n >> 2;
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const float4* c4 = reinterpret_cast<const float4*>(c);
    float4* o04 = reinterpret_cast<float4*>(o0);
    float4* o14 = reinterpret_cast<float4*>(o1);
    for (int64_t v = tid; v < nv; v += stride) {
      const float4 x = a4[v], y = b4[v], z = c4[v];
      float4 r0, r1;
      f(x.x, y.x, z.x, r0.x, r1.x);
      f(x.y, y.y, z.y, r0.y, r1.y);
      f(x.z, y.z, z.z, r0.z, r1.z);
      f(x.w, y.w, z.w, r0.w, r1.w);
      o04[v] = r0;
      if (o1 != nullptr) o14[v] = r1;
    }
    start = nv << 2;
  }
  for (int64_t i = start + tid; i < n; i += stride) {  // masked ragged tail
    float r0, r1;
    f(a[i], b[i], c[i], r0, r1);
    o0[i] = r0;
    if (o1 != nullptr) o1[i] = r1;
  }
}

template <class Op>
int launch3(const float* a, const float* b, const float* c, float* o0,
            float* o1, int64_t n, Op op, void* stream) {
  if (n <= 0) return cudaSuccess;
  const bool vec = aligned16(a) && aligned16(b) && aligned16(c) &&
                   aligned16(o0) && aligned16(o1);
  const int64_t work = vec ? (n + 3) / 4 : n;
  int64_t cap = 0;
  const cudaError_t err = block_cap(&cap);
  if (err != cudaSuccess) return err;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    stream3<Op, true><<<grid, kThreads, 0, s>>>(a, b, c, o0, o1, n, op);
  else
    stream3<Op, false><<<grid, kThreads, 0, s>>>(a, b, c, o0, o1, n, op);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Grouped row-wise pass: the leaves of one message in one launch.
//
// Each leaf is x [rows, f] (and u, same shape, or null) with one fp32
// scalar per row rs [rows], into q and r [rows, f].  The work is cut into
// tiles of one row each: kTileVecs float4 of the row's body (kRowVecs a
// thread), or kTile elements on the scalar loop.  The host (the Python
// wrapper) lays the tiles out, leaf after leaf, and passes the table by
// value; a block walks tiles blockIdx.x, + gridDim.x, ... and finds its leaf
// by a binary search over the leaves' first tiles, then its row and chunk.
//
// Vector leaves (x, u, q and r share their misalignment modulo 16 bytes, so
// every row of them does): a row is a scalar head up to x's first
// ``peel``-byte boundary (0-31 elements at 128, 0-3 at 16), a float4 body
// and a tail of 0-3 elements; the row's first tile also does its head
// (threads 0-31) and tail (threads 32-35).  The wrapper peels to 128 bytes:
// each warp's 32 float4 of x then sit on four whole 128-byte lines, so a
// row that starts off a line streams about as fast as one that starts on
// it; 16, the least that float4 needs, is kept to measure that against.
// Other leaves (peel 0) take the scalar loop of the same kernel.
// Every load of a tile is issued before the row's scalar is read and
// bound, so a tile waits one memory latency, not two.  Two float4 a thread
// a tile: more tiles for the small leaves of a message, enough bytes in
// flight for the large ones.
constexpr int kRowVecs = 2;                    // float4 a thread a tile
constexpr int64_t kTileVecs = kThreads * kRowVecs;
constexpr int64_t kTile = 4 * kTileVecs;       // elements of a scalar tile
constexpr int kMaxLeaves = 48;                 // leaves a launch
constexpr int kLeafFields = 9;                 // int64 a leaf in the table

struct RowLeaf {
  const float* x;
  const float* u;   // null for the compressors that draw nothing
  const float* rs;  // [rows]
  float* q;
  float* r;
  int64_t f;
  int64_t tile0;    // the leaf's first tile in the launch
  int64_t chunks;   // tiles a row
  int64_t peel;     // 16 or 128: head, float4 body, tail; 0: scalar loop
};

struct RowGroup {
  RowLeaf leaf[kMaxLeaves];
  int64_t tiles;  // of all leaves
  int64_t n;      // leaves
};
// a kernel parameter block holds 4 KB on every toolkit
static_assert(sizeof(RowGroup) <= 4000, "the leaf table outgrows 4 KB");

template <class Op>
__global__ void __launch_bounds__(kThreads)
    rowwise_group(const __grid_constant__ RowGroup g, Op op) {
  const int tid = threadIdx.x;
  for (int64_t t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    int lo = 0, hi = static_cast<int>(g.n) - 1;  // last leaf with tile0 <= t
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (g.leaf[mid].tile0 <= t) lo = mid;
      else hi = mid - 1;
    }
    const RowLeaf& L = g.leaf[lo];
    const int64_t local = t - L.tile0;
    const int64_t row = local / L.chunks, chunk = local - row * L.chunks;
    const int64_t f = L.f, base = row * f;
    const float* __restrict__ x = L.x + base;
    const float* __restrict__ u = L.u != nullptr ? L.u + base : nullptr;
    float* __restrict__ q = L.q + base;
    float* __restrict__ r = L.r + base;
    if (L.peel) {
      // elements before x's first peel-byte boundary (x is 4-aligned)
      const int64_t mis = reinterpret_cast<uintptr_t>(x) & (L.peel - 1);
      const int64_t to_peel = ((L.peel - mis) & (L.peel - 1)) >> 2;
      const int64_t head = to_peel < f ? to_peel : f;
      const int64_t nv = (f - head) >> 2;
      const int64_t j0 = chunk * kTileVecs + tid;
      const float4* x4 = reinterpret_cast<const float4*>(x + head);
      const float4* u4 =
          u != nullptr ? reinterpret_cast<const float4*>(u + head) : nullptr;
      float4 xv[kRowVecs], uv[kRowVecs];
#pragma unroll
      for (int k = 0; k < kRowVecs; ++k) {
        const int64_t j = j0 + k * kThreads;
        xv[k] = uv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < nv) {
          xv[k] = x4[j];
          if (u4 != nullptr) uv[k] = u4[j];
        }
      }
      int64_t c = -1;  // this thread's head or tail element, if any
      if (chunk == 0) {
        const int64_t tail = f - head - 4 * nv;
        if (tid < head) c = tid;
        else if (tid >= 32 && tid < 32 + tail) c = head + 4 * nv + tid - 32;
      }
      const float xs = c >= 0 ? x[c] : 0.0f;
      const float us = c >= 0 && u != nullptr ? u[c] : 0.0f;
      const auto fn = op.bind(__ldg(L.rs + row));
      float4* q4 = reinterpret_cast<float4*>(q + head);
      float4* r4 = reinterpret_cast<float4*>(r + head);
#pragma unroll
      for (int k = 0; k < kRowVecs; ++k) {
        const int64_t j = j0 + k * kThreads;
        if (j < nv) {
          float4 qv, rv;
          fn(xv[k].x, uv[k].x, qv.x, rv.x);
          fn(xv[k].y, uv[k].y, qv.y, rv.y);
          fn(xv[k].z, uv[k].z, qv.z, rv.z);
          fn(xv[k].w, uv[k].w, qv.w, rv.w);
          q4[j] = qv;
          r4[j] = rv;
        }
      }
      if (c >= 0) {
        float qs, rs;
        fn(xs, us, qs, rs);
        q[c] = qs;
        r[c] = rs;
      }
    } else {
      constexpr int kS = 4 * kRowVecs;
      const int64_t c0 = chunk * kTile + tid;
      float xs[kS], us[kS];
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const int64_t c = c0 + k * kThreads;
        xs[k] = c < f ? x[c] : 0.0f;
        us[k] = c < f && u != nullptr ? u[c] : 0.0f;
      }
      const auto fn = op.bind(__ldg(L.rs + row));
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const int64_t c = c0 + k * kThreads;
        if (c < f) {
          float qs, rs;
          fn(xs[k], us[k], qs, rs);
          q[c] = qs;
          r[c] = rs;
        }
      }
    }
  }
}

// Launch one group: ``table`` holds n <= kMaxLeaves leaves of kLeafFields
// int64 each (x, u, rs, q, r, f, tile0, chunks, peel), ``tiles`` their
// total.  The grid fills the card once over the whole group (the blocks of
// this kernel that fit an SM, times its SMs) or covers every tile, if fewer.
template <class Op>
int launch_rowwise_group(const int64_t* table, int n, int64_t tiles, Op op,
                         void* stream) {
  if (n <= 0 || tiles <= 0) return cudaSuccess;
  if (n > kMaxLeaves) return cudaErrorInvalidValue;
  RowGroup g{};
  for (int i = 0; i < n; ++i) {
    const int64_t* e = table + static_cast<int64_t>(i) * kLeafFields;
    g.leaf[i] = {reinterpret_cast<const float*>(e[0]),
                 reinterpret_cast<const float*>(e[1]),
                 reinterpret_cast<const float*>(e[2]),
                 reinterpret_cast<float*>(e[3]),
                 reinterpret_cast<float*>(e[4]),
                 e[5], e[6], e[7], e[8]};
  }
  g.tiles = tiles;
  g.n = n;
  // of this instantiation on the process's card, found at the first launch
  static int per_sm = 0, sms = 0;
  cudaError_t err = cudaSuccess;
  if (per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rowwise_group<Op>, kThreads, 0);
  if (err == cudaSuccess && sms == 0) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t cap = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = tiles < cap ? tiles : cap;
  rowwise_group<Op><<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(g, op);
  return cudaGetLastError();
}

}  // namespace
