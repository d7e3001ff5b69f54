// Shared launch machinery of the streaming elementwise kernels (sm_90a).
//
// Included by qg_update.cu and compress.cu, each of which builds into its
// own library.  Two shapes of pass:
//
//   launch3   one pass over three fp32 streams of one length into one or
//             two outputs: a 1-D grid-stride loop with 64-bit indices and a
//             masked ragged tail, float4 loads and stores only when every
//             pointer is 16-byte aligned, else the scalar loop;
//   launch_rowwise
//             one pass over a [rows, f] matrix (and, optionally, a second
//             matrix of the same shape) with one fp32 scalar per row, into
//             two [rows, f] outputs: a 2-D grid of (column block, row), each
//             block reads its row's scalar once; float4 when f is a multiple
//             of 4 and every pointer is 16-byte aligned (so every row starts
//             aligned), else the scalar loop.  The column tail is masked, so
//             nothing is padded.
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

// Blocks that fill the card once: kBlocksPerSm per SM of the current device.
cudaError_t block_cap(int64_t* cap) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
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

// One pass over x [rows, f] (and u, same shape, when not null) with the
// per-row scalar rs[row], into q and r [rows, f].
template <class Op, bool kVec>
__global__ void __launch_bounds__(kThreads)
    rowwise(const float* __restrict__ x, const float* __restrict__ u,
            const float* __restrict__ rs, float* __restrict__ q,
            float* __restrict__ r, int64_t rows, int64_t f, Op op) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const auto fn = op.bind(__ldg(rs + row));  // the row's scalar, once
    const int64_t base = row * f;
    int64_t start = 0;
    if (kVec) {
      const int64_t nv = f >> 2;
      const float4* x4 = reinterpret_cast<const float4*>(x + base);
      const float4* u4 =
          u != nullptr ? reinterpret_cast<const float4*>(u + base) : nullptr;
      float4* q4 = reinterpret_cast<float4*>(q + base);
      float4* r4 = reinterpret_cast<float4*>(r + base);
      for (int64_t v = tid; v < nv; v += stride) {
        const float4 xv = x4[v];
        const float4 uv = u4 != nullptr ? u4[v] : make_float4(0, 0, 0, 0);
        float4 qv, rv;
        fn(xv.x, uv.x, qv.x, rv.x);
        fn(xv.y, uv.y, qv.y, rv.y);
        fn(xv.z, uv.z, qv.z, rv.z);
        fn(xv.w, uv.w, qv.w, rv.w);
        q4[v] = qv;
        r4[v] = rv;
      }
      start = nv << 2;
    }
    for (int64_t c = start + tid; c < f; c += stride) {  // masked tail
      float qv, rv;
      fn(x[base + c], u != nullptr ? u[base + c] : 0.0f, qv, rv);
      q[base + c] = qv;
      r[base + c] = rv;
    }
  }
}

template <class Op>
int launch_rowwise(const float* x, const float* u, const float* rs, float* q,
                   float* r, int64_t rows, int64_t f, Op op, void* stream) {
  if (rows <= 0 || f <= 0) return cudaSuccess;
  const bool vec = (f & 3) == 0 && aligned16(x) && aligned16(u) &&
                   aligned16(q) && aligned16(r);
  const int64_t work = vec ? f / 4 : f;
  int64_t cap = 0;
  const cudaError_t err = block_cap(&cap);
  if (err != cudaSuccess) return err;
  const int64_t grid_rows = rows < 65535 ? rows : 65535;
  int64_t cols = (work + kThreads - 1) / kThreads;
  const int64_t cols_cap = cap / grid_rows > 0 ? cap / grid_rows : 1;
  if (cols > cols_cap) cols = cols_cap;
  const dim3 grid(static_cast<unsigned>(cols),
                  static_cast<unsigned>(grid_rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    rowwise<Op, true><<<grid, kThreads, 0, s>>>(x, u, rs, q, r, rows, f, op);
  else
    rowwise<Op, false><<<grid, kThreads, 0, s>>>(x, u, rs, q, r, rows, f,
                                                 op);
  return cudaGetLastError();
}

}  // namespace
