// Mamba-2 SSD chunked scan for Hopper (sm_90a).  Replaces the Pallas TPU
// kernel repro/kernels/ssd_scan.py:77 ssd_scan_bh (body _ssd_kernel, :30)
// together with the layout work of its wrapper repro/kernels/ops.py:84
// ssd_scan: it reads the model layout in place and adds the D-skip term.
//
//   ssd_scan_forward   x [B,S,H,P], dt [B,S,H] (fp32), a [H] (fp32, < 0),
//                      b/c [B,S,N], d_skip [H] (fp32)  ->
//                      y [B,S,H,P] in x's dtype, final state [B,H,N,P] fp32
//
// Per head, with h the [N,P] state, h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t^T
// and y_t = C_t h_t + D x_t.  The chunked form, over a chunk of L tokens with
// cum_t the running sum of a*dt inside the chunk:
//   y_t = sum_{s<=t} (C_t.B_s) exp(cum_t - cum_s) dt_s x_s + exp(cum_t) C_t h
//   h'  = exp(cum_L) h + sum_s exp(cum_L - cum_s) dt_s B_s x_s^T
//
// Bound on this card (H100 SXM, 700 W): operations.  The least work is the
// recurrence itself, 5*N*P + 3*P + 2 fp32 operations per token and head
// (decay of the state, the outer product dt B x^T, the read-out C h, the
// D-skip, a*dt and its exp); the chunked form below does more (C.B^T and the
// intra-chunk combine).  At [2,2048,24,64,128] that is 4.0 GFLOP, 0.060 ms
// at 67 TFLOP/s (TF32 off), against 56 MB of x, y, b, c, dt and the state,
// 0.017 ms at 3.35 TB/s.
//
// Design (simple and right first; wgmma and TMA staging come later):
//   * One block per (batch, head, tile of PT of the P columns), 256 threads.
//     The P columns of y and of the state are independent, so splitting P
//     across blocks is exact; each block recomputes cum and C.B^T for its
//     tile.  A loop over the sequence takes the place of the TPU's
//     sequential chunk grid axis; the block carries the state [N, PT] in
//     shared memory, in fp32.  PT is 32 where it divides P, else 16 (the
//     wrapper, kernels/ssd_scan.py, picks it).
//   * The chunk is cut into sub-chunks of kT = 64 tokens carried by the same
//     recurrence (the scan's result does not depend on the chunk beyond
//     rounding; the wrapper only checks that the caller's chunk divides S).
//     At N 128 and a 128-token chunk, b, c, C.B^T, x and the state would
//     need 256 KB of shared memory, more than a block can have; at 64 tokens
//     and PT 32 they take 113 KB.  A short last sub-chunk (S < 64, or S not
//     a multiple of 64) is padded with zero rows: dt 0 adds no decay and B 0
//     no input, so the carried state is exact.
//   * Per sub-chunk: the tiles are loaded (b and c n-major, rows padded by 4
//     words so float4 reads stay aligned and the state update's column reads
//     fall in two banks), warp 0 scans a*dt into cum with shuffles and forms
//     exp(cum_t), exp(cum_L - cum_s) dt_s and exp(cum_L); then three register
//     tiled products, each thread owning a 4 x PT/16 tile: M = C.B^T weighted
//     by exp(cum_t - cum_s) dt_s (lower triangle only), y = exp(cum_t) C h +
//     M x + D x, and h' = exp(cum_L) h + B^T (w x).
//   * exp(cum_t - cum_s) overflows for s > t: those entries are set to 0 by
//     a select and never computed, never multiplied by a 0/1 mask (inf * 0 is
//     NaN).
//   * FMA: the library shares the -fmad=false flag of the bitwise optimizer
//     kernels; this kernel is held to a tolerance, not to bits, and its inner
//     products call __fmaf_rn explicitly (one rounding per multiply-add),
//     which that flag does not affect.
//   * fp32 and bf16 x, b, c; all arithmetic and the state in fp32; y written
//     in x's dtype with round-to-nearest-even.
//
// Launches go on the caller's stream; nothing syncs or allocates here, and
// the launcher returns cudaGetLastError() for the Python wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT = 64;           // tokens per sub-chunk
constexpr int kTS = kT + 4;      // padded row stride of the n-major tiles
constexpr int kThreads = 256;
constexpr int kGroups = 16;      // 16 x 16 thread grid over each product
static_assert(kThreads == kGroups * kGroups, "16 x 16 threads");
static_assert(kT == 4 * kGroups, "one 4-row tile per thread row");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// W consecutive floats of shared memory in one load (16, 8 or 4 bytes)
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* r);
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float* r) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}
template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float* r) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  r[0] = v.x;
  r[1] = v.y;
}
template <>
__device__ __forceinline__ void load_vec<1>(const float* p, float* r) {
  r[0] = p[0];
}

// shared memory of one block, in floats
__host__ __device__ constexpr size_t smem_floats(int N, int PT) {
  return 2 * static_cast<size_t>(N) * kTS   // c, b (n-major)
         + static_cast<size_t>(kT) * kTS    // M transposed
         + static_cast<size_t>(kT) * PT     // x tile
         + static_cast<size_t>(N) * PT      // state
         + 4 * kT + 4;                      // cum, dt, w_in, w_out, decay
}

template <class T, int PT>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a, const T* __restrict__ bm,
            const T* __restrict__ cm, const float* __restrict__ dskip,
            T* __restrict__ y, float* __restrict__ fin, int S, int H, int P,
            int N, long long sx, long long sb, long long sc) {
  constexpr int TN = PT / kGroups;  // P columns per thread in y and state
  extern __shared__ float4 smem4[];
  float* ct = reinterpret_cast<float*>(smem4);  // [N][kTS]  C, n-major
  float* bt = ct + N * kTS;                     // [N][kTS]  B, n-major
  float* mt = bt + N * kTS;                     // [kT][kTS] M^T: mt[s][t]
  float* xs = mt + kT * kTS;                    // [kT][PT]  x tile
  float* st = xs + kT * PT;                     // [N][PT]   carried state
  float* cum = st + N * PT;                     // [kT]
  float* dts = cum + kT;                        // [kT]
  float* w_in = dts + kT;                       // [kT] exp(cum_t)
  float* w_out = w_in + kT;                     // [kT] exp(cum_L-cum_s) dt_s
  float* decay = w_out + kT;                    // [1]  exp(cum_L)

  const int tid = threadIdx.x;
  const int gi = tid / kGroups, gj = tid % kGroups;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const float ah = a[h], dh = dskip[h];
  const size_t tok0 = static_cast<size_t>(b) * S;

  for (int e = tid; e < N * PT; e += kThreads) st[e] = 0.0f;

  for (int s0 = 0; s0 < S; s0 += kT) {
    const int rows = min(kT, S - s0);

    // ---- tiles: b and c n-major, x row-major; zero rows past S
    for (int e = tid; e < kT * N; e += kThreads) {
      const int r = e / N, n = e % N;
      float bv = 0.0f, cv = 0.0f;
      if (r < rows) {
        const size_t tok = tok0 + s0 + r;
        bv = to_f32(bm[tok * sb + n]);
        cv = to_f32(cm[tok * sc + n]);
      }
      bt[n * kTS + r] = bv;
      ct[n * kTS + r] = cv;
    }
    for (int e = tid; e < kT * PT; e += kThreads) {
      const int r = e / PT, pp = e % PT;
      float xv = 0.0f;
      if (r < rows)
        xv = to_f32(x[(tok0 + s0 + r) * sx + static_cast<size_t>(h) * P + p0 +
                      pp]);
      xs[e] = xv;
    }
    // ---- warp 0: cum = running sum of a*dt, two tokens a lane
    if (tid < 32) {
      const int r0 = 2 * tid, r1 = r0 + 1;
      const float d0 = r0 < rows ? dt[(tok0 + s0 + r0) * H + h] : 0.0f;
      const float d1 = r1 < rows ? dt[(tok0 + s0 + r1) * H + h] : 0.0f;
      const float v0 = __fmul_rn(ah, d0), v1 = __fmul_rn(ah, d1);
      float incl = __fadd_rn(v0, v1);
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl = __fadd_rn(incl, o);
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
      const float c0 = __fadd_rn(excl, v0);
      const float c1 = __fadd_rn(c0, v1);
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      cum[r0] = c0;
      cum[r1] = c1;
      dts[r0] = d0;
      dts[r1] = d1;
      w_in[r0] = expf(c0);
      w_in[r1] = expf(c1);
      w_out[r0] = __fmul_rn(expf(__fsub_rn(last, c0)), d0);
      w_out[r1] = __fmul_rn(expf(__fsub_rn(last, c1)), d1);
      if (tid == 0) decay[0] = expf(last);
    }
    __syncthreads();

    // ---- M^T[s][t] = (C_t.B_s) exp(cum_t - cum_s) dt_s for s <= t, else 0;
    // thread (gi, gj) owns rows t = 4gi.. and columns s = 4gj..; tiles
    // wholly above the diagonal are never read and not computed
    if (gj <= gi) {
      float g[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
        load_vec<4>(ct + n * kTS + 4 * gi, cv);
        load_vec<4>(bt + n * kTS + 4 * gj, bv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            g[i][j] = __fmaf_rn(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 4 * gj + j;
        float m[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * gi + i;
          m[i] = 0.0f;
          if (s <= t)
            m[i] = __fmul_rn(
                __fmul_rn(g[i][j], expf(__fsub_rn(cum[t], cum[s]))), dts[s]);
        }
        *reinterpret_cast<float4*>(mt + s * kTS + 4 * gi) =
            make_float4(m[0], m[1], m[2], m[3]);
      }
    }
    __syncthreads();

    // ---- y[t][p] = exp(cum_t) (C h)[t][p] + (M x)[t][p] + D x[t][p];
    // thread (gi, gj) owns rows t = 4gi.. and columns p = TN*gj..
    {
      float acc[4][TN] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[TN];
        load_vec<4>(ct + n * kTS + 4 * gi, cv);
        load_vec<TN>(st + n * PT + TN * gj, sv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fmaf_rn(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmul_rn(acc[i][j], w_in[4 * gi + i]);
      for (int s = 0; s < 4 * gi + 4; ++s) {  // M^T[s][t] = 0 for s > t
        float mv[4], xv[TN];
        load_vec<4>(mt + s * kTS + 4 * gi, mv);
        load_vec<TN>(xs + s * PT + TN * gj, xv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fmaf_rn(mv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * gi + i;
        if (t < rows) {
          T* yr = y + ((tok0 + s0 + t) * H + h) * static_cast<size_t>(P) + p0;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int p = TN * gj + j;
            yr[p] = from_f32<T>(
                __fadd_rn(acc[i][j], __fmul_rn(dh, xs[t * PT + p])));
          }
        }
      }
    }
    __syncthreads();  // y has read the old state

    // ---- h[n][p] = exp(cum_L) h[n][p] + sum_s B[s][n] (w_out[s] x[s][p]);
    // jobs of 4 state rows x TN columns
    {
      const float dec = decay[0];
      for (int job = tid; job < (N / 4) * kGroups; job += kThreads) {
        const int ni = job / kGroups, pj = job % kGroups;
        float acc[4][TN] = {};
        for (int s = 0; s < rows; ++s) {
          float xv[TN];
          load_vec<TN>(xs + s * PT + TN * pj, xv);
          const float w = w_out[s];
#pragma unroll
          for (int j = 0; j < TN; ++j) xv[j] = __fmul_rn(xv[j], w);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float bv = bt[(4 * ni + i) * kTS + s];
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = __fmaf_rn(bv, xv[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            float* sp = st + (4 * ni + i) * PT + TN * pj + j;
            *sp = __fadd_rn(__fmul_rn(dec, *sp), acc[i][j]);
          }
      }
    }
    __syncthreads();  // the next sub-chunk overwrites the tiles
  }

  for (int e = tid; e < N * PT; e += kThreads) {
    const int n = e / PT, pp = e % PT;
    fin[((static_cast<size_t>(b) * H + h) * N + n) * P + p0 + pp] = st[e];
  }
}

template <class T, int PT>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* bm, const void* cm, const float* dskip, void* y,
                   float* fin, int B, int S, int H, int P, int N, long long sx,
                   long long sb, long long sc, cudaStream_t stream) {
  auto kernel = ssd_fwd<T, PT>;
  const size_t smem = sizeof(float) * smem_floats(N, PT);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(P / PT, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), dskip, static_cast<T*>(y), fin, S, H, P, N,
      sx, sb, sc);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(int p_tile, const void* x, const float* dt,
                     const float* a, const void* bm, const void* cm,
                     const float* dskip, void* y, float* fin, int B, int S,
                     int H, int P, int N, long long sx, long long sb,
                     long long sc, cudaStream_t s) {
  switch (p_tile) {
    case 16:
      return launch<T, 16>(x, dt, a, bm, cm, dskip, y, fin, B, S, H, P, N, sx,
                           sb, sc, s);
    case 32:
      return launch<T, 32>(x, dt, a, bm, cm, dskip, y, fin, B, S, H, P, N, sx,
                           sb, sc, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// y [B,S,H,P] (contiguous, x's dtype) and fin [B,H,N,P] (fp32) of the SSD
// scan.  x [B,S,H,P], b and c [B,S,N] are read with token strides sx, sb,
// sc (in elements: rows of a contiguous tensor or of a slice of its last
// axis); dt [B,S,H], a [H], d_skip [H] are contiguous fp32.  dtype 0 is
// fp32, 1 is bf16 (x, b, c and y); p_tile in {16, 32} divides P;
// N % 4 == 0.
int ssd_scan_forward(const void* x, const float* dt, const float* a,
                     const void* b, const void* c, const float* d_skip,
                     void* y, float* fin, int B, int S, int H, int P, int N,
                     long long sx, long long sb, long long sc, int p_tile,
                     int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N % 4 != 0 || P % p_tile != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(p_tile, x, dt, a, b, c, d_skip, y, fin, B, S, H, P,
                           N, sx, sb, sc, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(p_tile, x, dt, a, b, c, d_skip, y, fin, B,
                                   S, H, P, N, sx, sb, sc, s);
  return cudaErrorInvalidValue;
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
