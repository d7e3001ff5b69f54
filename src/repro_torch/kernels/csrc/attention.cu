// Attention kernels for Hopper (sm_90a): one library, two kernels that share
// one online-softmax design.  Each replaces one Pallas TPU kernel of
// repro/kernels/flash_attention.py:
//
//   attn_flash_forward   flash_attention (_fa_kernel): causal or non-causal
//                        GQA attention over q [B,S,H,D], k/v [B,T,K,D], with
//                        an optional sliding window and tanh softcap
//   attn_paged_decode    paged_decode_attention (_paged_kernel): one decode
//                        token per slot over the page pools
//                        k/v [NP,ps,K,D], addressed through block_tables
//                        [B,P] (-1 = unallocated) and lengths [B]
//
// Bounds on this card (H100 SXM, 700 W).
//   * flash: operations.  Each (query, key) pair in the band costs 4*D
//     flops (2*D for q.k, 2*D for p.v); with TF32 off the fp32 rate,
//     67 TFLOP/s, binds.  At [2,1024,32,64] causal that is about 8.6 GFLOP
//     in the band, 0.128 ms, against 12.6 MB of q, k, v and output, 3.8 us
//     at 3.35 TB/s.
//   * paged decode: bytes.  Each live K/V row is read once (2*K*D*4 B per
//     token in fp32) against 4*G*D flops per (head group, row): 1 flop per
//     byte at G = 8, far under the ~20 at which the fp32 rate would bind.
//     At the serving CLI's defaults the live rows are a few MB, a few us
//     at 3.35 TB/s.
//
// Design (simple and right first; wgmma, TMA and split-KV come later):
//   * flash_fwd: one block per (batch, query head, tile of 32 query rows),
//     128 threads, four per query row.  Each thread keeps a quarter of its
//     row's scaled q and of its fp32 accumulator in registers, on dims
//     lane, lane+4, ... (four lanes read four neighbouring shared-memory
//     words: no bank conflict).  A loop over tiles of 64 keys stages K and
//     V in shared memory as fp32; tiles wholly outside the causal/window
//     band are never loaded (the reference's pl.when skip).  Per tile:
//     scores by fmaf over the thread's dims and two shuffles, softcap, the
//     mask (q_pos >= k_pos, q_pos - k_pos < window, inside S and T), then
//     the online softmax m/l/acc update, in the Pallas body's order.
//   * paged_decode: one block per (slot, KV head) holding the group's
//     G = H/K query heads.  A loop over the slot's pages in the block takes
//     the place of the TPU's sequential page grid axis; the block reads its
//     own block-table entries (there is no scalar prefetch).  A page is
//     skipped when its entry is < 0 (or >= NP), when it starts at or past
//     the slot's length, or when it lies wholly outside the window; a live
//     page's K/V rows go to shared memory as fp32, K rows padded by one
//     word so the score loop's rows fall in different banks.
//   * NEG_INF = -2e38 and p = 0 on masked keys, as the reference: a row
//     with no visible key (an inactive slot, length 0) keeps l = 0 and
//     writes acc / max(l, 1e-30) = 0.
//   * fp32 and bf16 storage; all arithmetic in fp32, written back in q's
//     dtype with round-to-nearest-even.
//
// Launches go on the caller's stream; nothing syncs or allocates here, and
// each launcher returns cudaGetLastError() for the Python wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -2.0e38f;

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

// cap * tanh(s / cap), the Gemma-2 softcap; cap 0 is off
__device__ __forceinline__ float cap_score(float s, float cap) {
  return cap > 0.0f ? cap * tanhf(s / cap) : s;
}

// ---------------------------------------------------------------------------
// flash attention forward
// ---------------------------------------------------------------------------

constexpr int kFaRows = 32;                     // query rows per block
constexpr int kFaLanes = 4;                     // threads per query row
constexpr int kFaThreads = kFaRows * kFaLanes;  // 128
constexpr int kFaKeys = 64;                     // keys per shared-memory tile

template <class T, int D>
__global__ void __launch_bounds__(kFaThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
              int H, int KH, int causal, int window, float softcap,
              float scale) {
  constexpr int DL = D / kFaLanes;  // dims per thread
  extern __shared__ float smem[];
  float* ks = smem;                 // [kFaKeys][D]
  float* vs = smem + kFaKeys * D;   // [kFaKeys][D]

  const int tid = threadIdx.x;
  const int row = tid / kFaLanes, lane = tid % kFaLanes;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kh = h / (H / KH);
  const int q0 = blockIdx.x * kFaRows;
  const int q_pos = q0 + row;
  const int q_last = min(q0 + kFaRows, S) - 1;

  float qr[DL], acc[DL];
  const bool q_ok = q_pos < S;
  const size_t q_off = ((static_cast<size_t>(b) * S + q_pos) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    qr[i] = q_ok ? __fmul_rn(to_f32(q[q_off + lane + kFaLanes * i]), scale)
                 : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  // keys [lo, hi) can be seen by some row of this tile
  int lo = 0, hi = causal ? min(Tk, q_last + 1) : Tk;
  if (window) lo = max(0, q0 - window + 1);
  for (int k0 = (lo / kFaKeys) * kFaKeys; k0 < hi; k0 += kFaKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kFaKeys * D; e += kFaThreads) {
      const int key = e / D, d = e % D, kp = k0 + key;
      float kv = 0.0f, vv = 0.0f;
      if (kp < Tk) {
        const size_t off =
            ((static_cast<size_t>(b) * Tk + kp) * KH + kh) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    __syncthreads();

    // scores of this row against the tile's keys; lane j keeps those of
    // keys j, j+4, ... (sc[key / 4])
    float sc[kFaKeys / kFaLanes];
    float mx = kNegInf;
#pragma unroll
    for (int key = 0; key < kFaKeys; ++key) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        s = fmaf(qr[i], ks[key * D + lane + kFaLanes * i], s);
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
      s = cap_score(s, softcap);
      const int kp = k0 + key;
      bool ok = q_ok && kp < Tk;
      if (causal) ok = ok && q_pos >= kp;
      if (window) ok = ok && q_pos - kp < window;
      s = ok ? s : kNegInf;
      mx = fmaxf(mx, s);
      if ((key % kFaLanes) == lane) sc[key / kFaLanes] = s;
    }
    const float m_new = fmaxf(m, mx);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kFaKeys / kFaLanes; ++j) {
      // a masked key holds kNegInf; p is 0 there, as the reference's mask
      const float p = sc[j] == kNegInf ? 0.0f : expf(__fsub_rn(sc[j], m_new));
      sc[j] = p;
      psum = __fadd_rn(psum, p);
    }
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 1));
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 2));
    const float corr = expf(__fsub_rn(m, m_new));
    l = __fadd_rn(__fmul_rn(l, corr), psum);
    m = m_new;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] = __fmul_rn(acc[i], corr);
    const int base = (tid % 32) & ~3;
#pragma unroll
    for (int key = 0; key < kFaKeys; ++key) {
      const float p = __shfl_sync(0xffffffffu, sc[key / kFaLanes],
                                  base + key % kFaLanes);
#pragma unroll
      for (int i = 0; i < DL; ++i)
        acc[i] = fmaf(p, vs[key * D + lane + kFaLanes * i], acc[i]);
    }
  }
  if (q_ok) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DL; ++i)
      o[q_off + lane + kFaLanes * i] = from_f32<T>(__fdiv_rn(acc[i], den));
  }
}

template <class T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int Tk, int H, int KH, int causal,
                         int window, float softcap, float scale,
                         cudaStream_t stream) {
  const int smem = 2 * kFaKeys * D * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((S + kFaRows - 1) / kFaRows, B * H);
  kernel<<<grid, kFaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, KH, causal,
      window, softcap, scale);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch_flash(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int Tk, int H, int KH, int D,
                           int causal, int window, float softcap, float scale,
                           cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_flash<T, 32>(q, k, v, o, B, S, Tk, H, KH, causal, window,
                                 softcap, scale, stream);
    case 64:
      return launch_flash<T, 64>(q, k, v, o, B, S, Tk, H, KH, causal, window,
                                 softcap, scale, stream);
    case 128:
      return launch_flash<T, 128>(q, k, v, o, B, S, Tk, H, KH, causal,
                                  window, softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// paged decode attention
// ---------------------------------------------------------------------------

constexpr int kPdThreads = 128;

template <class T>
__global__ void __launch_bounds__(kPdThreads)
    paged_decode(const T* __restrict__ q, const T* __restrict__ kpool,
                 const T* __restrict__ vpool, const int* __restrict__ tables,
                 const int* __restrict__ lengths, T* __restrict__ o, int NP,
                 int ps, int KH, int G, int D, int P, int window,
                 float softcap, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [G][D] scaled queries
  float* acc = qs + G * D;           // [G][D]
  float* ks = acc + G * D;           // [ps][D + 1]
  float* vs = ks + ps * (D + 1);     // [ps][D]
  float* sc = vs + ps * D;           // [G][ps] scores, then p
  float* mrow = sc + G * ps;         // [G] running max
  float* lrow = mrow + G;            // [G] running sum
  float* crow = lrow + G;            // [G] this page's correction

  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = kPdThreads / 32;
  const int H = KH * G;
  const int length = lengths[b];
  const int q_pos = length - 1;
  const size_t q_off = (static_cast<size_t>(b) * H + kh * G) * D;

  for (int e = tid; e < G * D; e += kPdThreads) {
    qs[e] = __fmul_rn(to_f32(q[q_off + e]), scale);
    acc[e] = 0.0f;
  }
  for (int g = tid; g < G; g += kPdThreads) {
    mrow[g] = kNegInf;
    lrow[g] = 0.0f;
  }

  for (int j = 0; j < P; ++j) {
    const int page = tables[static_cast<size_t>(b) * P + j];
    // uniform over the block: every thread skips a dead page together
    bool live = page >= 0 && page < NP && j * ps < length;
    if (window) live = live && (j + 1) * ps - 1 > q_pos - window;
    if (!live) continue;
    __syncthreads();  // the previous page is consumed, q and acc are set
    for (int e = tid; e < ps * D; e += kPdThreads) {
      const int r = e / D, d = e % D;
      const size_t src =
          ((static_cast<size_t>(page) * ps + r) * KH + kh) * D + d;
      ks[r * (D + 1) + d] = to_f32(kpool[src]);
      vs[e] = to_f32(vpool[src]);
    }
    __syncthreads();
    for (int e = tid; e < G * ps; e += kPdThreads) {
      const int g = e / ps, r = e % ps;
      float s = 0.0f;
      for (int d = 0; d < D; ++d)
        s = fmaf(qs[g * D + d], ks[r * (D + 1) + d], s);
      s = cap_score(s, softcap);
      const int k_pos = j * ps + r;
      bool ok = k_pos <= q_pos;
      if (window) ok = ok && k_pos > q_pos - window;
      sc[e] = ok ? s : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += n_warps) {
      float mx = kNegInf;
      for (int r = lane; r < ps; r += 32) mx = fmaxf(mx, sc[g * ps + r]);
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(mrow[g], mx);
      float psum = 0.0f;
      for (int r = lane; r < ps; r += 32) {
        const int k_pos = j * ps + r;
        bool ok = k_pos <= q_pos;
        if (window) ok = ok && k_pos > q_pos - window;
        const float p = ok ? expf(__fsub_rn(sc[g * ps + r], m_new)) : 0.0f;
        sc[g * ps + r] = p;
        psum = __fadd_rn(psum, p);
      }
      for (int off = 16; off > 0; off /= 2)
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, off));
      if (lane == 0) {
        const float corr = expf(__fsub_rn(mrow[g], m_new));
        crow[g] = corr;
        lrow[g] = __fadd_rn(__fmul_rn(lrow[g], corr), psum);
        mrow[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += kPdThreads) {
      const int g = e / D, d = e % D;
      float a = __fmul_rn(acc[e], crow[g]);
      for (int r = 0; r < ps; ++r) a = fmaf(sc[g * ps + r], vs[r * D + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kPdThreads)
    o[q_off + e] = from_f32<T>(__fdiv_rn(acc[e], fmaxf(lrow[e / D], 1e-30f)));
}

template <class T>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp,
                         const int* tables, const int* lengths, void* o, int B,
                         int KH, int G, int D, int NP, int ps, int P,
                         int window, float softcap, float scale, size_t smem,
                         cudaStream_t stream) {
  auto kernel = paged_decode<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(KH, B);
  kernel<<<grid, kPdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lengths, static_cast<T*>(o), NP, ps,
      KH, G, D, P, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o [B,S,H,D] = attention of q [B,S,H,D] over k/v [B,T,KH,D]; dtype 0 is
// fp32, 1 is bf16; D in {32, 64, 128}.
int attn_flash_forward(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Tk, int H, int KH, int D, int causal,
                       int window, float softcap, float scale, int dtype,
                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_flash<float>(q, k, v, o, B, S, Tk, H, KH, D, causal,
                                 window, softcap, scale, s);
  if (dtype == 1)
    return dispatch_flash<__nv_bfloat16>(q, k, v, o, B, S, Tk, H, KH, D,
                                         causal, window, softcap, scale, s);
  return cudaErrorInvalidValue;
}

// o [B,1,H,D] = one-token attention of q [B,1,H,D] over the page pools
// kp/vp [NP,ps,KH,D] through tables [B,P] and lengths [B] (int32).
int attn_paged_decode(const void* q, const void* kp, const void* vp,
                      const int* tables, const int* lengths, void* o, int B,
                      int H, int KH, int D, int NP, int ps, int P, int window,
                      float softcap, float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int G = H / KH;
  // qs, acc, ks (rows padded by one word), vs, sc, m, l, corr
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(G) * D + ps * (D + 1) +
                       static_cast<size_t>(ps) * D + G * ps + 3 * G);
  if (dtype == 0)
    return launch_paged<float>(q, kp, vp, tables, lengths, o, B, KH, G, D, NP,
                               ps, P, window, softcap, scale, smem, s);
  if (dtype == 1)
    return launch_paged<__nv_bfloat16>(q, kp, vp, tables, lengths, o, B, KH,
                                       G, D, NP, ps, P, window, softcap,
                                       scale, smem, s);
  return cudaErrorInvalidValue;
}

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
