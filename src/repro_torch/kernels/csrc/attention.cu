// Attention kernels for Hopper (sm_90a).  Each replaces one Pallas TPU
// kernel of repro/kernels/flash_attention.py:
//
//   attn_flash_forward   flash_attention (_fa_kernel): causal or non-causal
//                        GQA attention over q [B,S,H,D], k/v [B,T,K,D], with
//                        an optional sliding window and tanh softcap
//   attn_paged_decode    paged_decode_attention (_paged_kernel): one decode
//   attn_paged_merge     token per slot over the page pools k/v [NP,ps,K,D],
//                        addressed through block_tables [B,P] (-1 =
//                        unallocated) and lengths [B]; split over pages
//                        across blocks, then merged by a second pass
//
// Bounds on this card (H100 SXM, 700 W).
//   * flash: operations.  Each (query, key) pair in the band costs 4*D
//     flops (2*D for q.k, 2*D for p.v).  To fp32 accuracy on the tensor
//     cores each product costs three TF32 products (below), so the rate is
//     495 / 3 = 165 TFLOP/s: at [2,1024,32,64] causal 8.6 GFLOP in the
//     band, 0.052 ms, against 12.6 MB of q, k, v and output, 3.8 us at
//     3.35 TB/s.
//   * paged decode: bytes.  Each live K/V row is read once (2*K*D*4 B per
//     token in fp32) against 4*G*D flops per (head group, row): 1 flop per
//     byte at G = 8, far under the ~20 at which the fp32 rate would bind.
//     8 slots x 4096 tokens of TinyLlama's 4 KV heads of 64 are 67 MB,
//     20 us at 3.35 TB/s.
//
// flash_tc: FA2-shaped, on mma.sync.m16n8k8 TF32 with 3xTF32 products.
//   * One block of 4 warps per (batch, query head, 64 query rows), 16 rows
//     a warp.  Scores S = Q K^T and O += P V are m16n8k8 TF32 products
//     accumulated in fp32 in the tensor cores.  TF32 keeps 10 mantissa
//     bits, so each fp32 operand x is split hi = rna(x), lo = rna(x - hi)
//     and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi (the a_lo b_lo
//     term is below fp32 rounding): about fp32's accuracy at three
//     products.  bf16 values are exact in TF32, so in bf16 Q K^T is one
//     product (the scale applied after) and P V two (P's split).  The
//     rounding is two integer operations (measured faster than cvt.rna),
//     and each of the three terms is issued over all of a row's
//     accumulators before the next, so that no product waits on the one
//     before it.
//   * K/V tiles of 32 keys move by 16-byte cp.async into a two-stage ring,
//     one barrier a tile: the next tile's copy runs under this tile's
//     products (32 rather than 64 keys: fewer registers, measured faster).
//     Rows are padded by 16 bytes, so the fragment reads of K (row g,
//     column t) and of V (row 2t, column g) fall in 32 distinct banks.
//     At D = 112 (zamba2's shared block) the fp32 pitch is 116 words,
//     116 = 20 mod 32: K's rows g = 0..7 start on banks 0, 20, 8, 28,
//     16, 4, 24, 12, plus t in 0..3, and V's rows 2t on 0, 8, 16, 24,
//     plus g in 0..7, so both still cover 32 distinct banks; in bf16 the
//     pitch is 60 words and two lanes share each word read.  A tile pair
//     is 2 * 2 * 32 * 116 * 4 = 59,392 B there, past the default 48 KB
//     (the launcher raises the limit, as at D = 128).
//     Keys past T are zero-filled.
//   * The online softmax runs on the accumulator fragments: a thread holds
//     two rows (g, g+8) and columns 2t, 2t+1 of each 8-key block; row max
//     and sum reduce across the quad.  P is fed back as the A operand with
//     no data movement: within an 8-key step, logical k index t is taken as
//     key 2t and t+4 as key 2t+1, and the V fragment is read with the same
//     permutation (a sum over keys does not depend on their order).
//   * Tiles wholly outside the causal/window band are never loaded; the
//     mask (q_pos >= k_pos, q_pos - k_pos < window, inside S and T) gives
//     NEG_INF and p = 0 on masked keys, as the reference, and is formed
//     only on the tiles that cut the band (the others are wholly inside).
//   mma.sync rather than wgmma: TF32 wgmma wants both operands K-major in
//   shared memory, so P V would need V transposed and P staged through
//   shared memory per tile; mma.sync takes P from registers as it stands.
//
// paged_decode (split-KV, flash-decoding) + paged_merge:
//   * Grid (K x ceil(G/8), B, splits): a block holds up to 8 of the group's
//     G = H/K query heads and walks its split's logical rows [s0, s1),
//     clipped to the slot's visible rows [max(0, len - window), len).  A
//     block whose range is empty writes the empty partial (m = NEG_INF,
//     l = 0, acc = 0).  The block reads its split's block-table entries
//     into shared memory once; a row whose entry is < 0 (or >= NP) is
//     masked (p = 0) and never loaded.
//   * Rows go to shared memory by 16-byte cp.async, 32 rows a stage
//     whatever the page size, four threads a row (one page lookup and
//     address each), double-buffered: the next stage's copies run under
//     this stage's work, one barrier a stage.  38 KB of shared memory at
//     D = 64 in fp32, so five blocks fit an SM; a deeper ring cost more
//     in blocks an SM than it gained (measured at 8 slots x 4096).
//   * Each warp takes 8 rows of every stage and keeps its own online
//     softmax (m, l per head; acc over its lanes' dims), so warps never
//     wait on each other within a stage.  Scores: lane (row, dq) holds a
//     quarter of the row of K (float4 reads) and sums each head's dot over
//     its quad by two shuffles; the row max and sum take three more.  P V:
//     p goes through the warp's own shared memory, each lane holds D/32
//     dims of every head's acc.  At the end the four warps' partials merge
//     in warp order.
//   * One split (the engine's shape): the block writes o.  More: it writes
//     its m, l and unnormalised acc to scratch, and paged_merge rescales by
//     exp(m_s - max m) and sums the splits in their order (no atomics: the
//     same bits run to run), dividing by max(l, 1e-30).
//   * NEG_INF = -2e38 and p = 0 on masked keys, as the reference: a row
//     with no visible key (an inactive slot, length 0) keeps l = 0 and
//     writes 0.
//
// fp32 and bf16 storage; all arithmetic in fp32, written back in q's dtype
// with round-to-nearest-even.  Launches go on the caller's stream; nothing
// syncs or allocates here, and each launcher returns cudaGetLastError()
// for the Python wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;

// cap * tanh(s / cap), the Gemma-2 softcap; cap 0 is off
__device__ __forceinline__ float cap_score(float s, float cap) {
  return cap > 0.0f ? cap * tanhf(s / cap) : s;
}

// ---------------------------------------------------------------------------
// flash attention forward on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kFaWarps = 4;
constexpr int kFaThreads = kFaWarps * 32;  // 128
constexpr int kFaRows = kFaWarps * 16;     // 64 query rows per block
constexpr int kFaStages = 2;  // K/V tiles in the ring (a deeper one
                              // measured no faster)

__host__ __device__ constexpr int largest_divisor_upto8(int n) {
  return n % 8 == 0 ? 8 : n % 7 == 0 ? 7 : n % 6 == 0 ? 6 : n % 5 == 0 ? 5
       : n % 4 == 0 ? 4 : n % 3 == 0 ? 3 : n % 2 == 0 ? 2 : 1;
}

template <class T, int D>
struct FlashShape {
  static constexpr int KT = 32;   // keys per tile
  static constexpr int PITCH = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int TILE = KT * PITCH;       // elements of one K tile
  static constexpr int SMEM =
      2 * kFaStages * TILE * static_cast<int>(sizeof(T));
  static constexpr int CPR = D * static_cast<int>(sizeof(T)) / 16;
};

template <class T, int D>
__global__ void __launch_bounds__(kFaThreads)
    flash_tc(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
             int H, int KH, int causal, int window, float softcap,
             float scale) {
  using Sh = FlashShape<T, D>;
  constexpr int KT = Sh::KT, PITCH = Sh::PITCH, TILE = Sh::TILE;
  constexpr int CPR = Sh::CPR, EPC = 16 / static_cast<int>(sizeof(T));
  constexpr int NK = KT / 8;  // 8-key blocks of a tile
  constexpr int ND = D / 8;   // 8-dim blocks of a head
  // 8-dim blocks per P V pass: the largest divisor of ND up to 8, so the
  // passes tile the head exactly (8 at D 64 and 128, 4 at 32, 7 at 112)
  constexpr int NV = largest_divisor_upto8(ND);
  constexpr bool kExact = sizeof(T) == 2;  // bf16: exact in TF32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [stages][KT][PITCH]
  T* vs = ks + kFaStages * TILE;           // [stages][KT][PITCH]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kh = h / (H / KH);
  const int q0 = blockIdx.x * kFaRows;
  const int q_last = min(q0 + kFaRows, S) - 1;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this thread's rows

  // Q as A fragments: qa[kk] = {(ra, 8kk+t), (rb, 8kk+t), (ra, 8kk+t+4),
  // (rb, 8kk+t+4)}; scaled in fp32, raw (exact in TF32) in bf16
  float qa[ND][4];
  {
    const size_t oa = ((static_cast<size_t>(b) * S + ra) * H + h) * D;
    const size_t ob = ((static_cast<size_t>(b) * S + rb) * H + h) * D;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const int d0 = 8 * kk + t, d1 = d0 + 4;
      float x[4] = {ra < S ? to_f32(q[oa + d0]) : 0.0f,
                    rb < S ? to_f32(q[ob + d0]) : 0.0f,
                    ra < S ? to_f32(q[oa + d1]) : 0.0f,
                    rb < S ? to_f32(q[ob + d1]) : 0.0f};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[kk][i] = kExact ? x[i] : __fmul_rn(x[i], scale);
    }
  }
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[n][i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

  // keys [lo, hi) can be seen by some row of this block
  const int lo = window ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_begin = (lo / KT) * KT;
  const int n_tiles = hi > k_begin ? (hi - k_begin + KT - 1) / KT : 0;

  auto issue = [&](int tile, int buf) {
    const int k0 = k_begin + tile * KT;
    for (int e = tid; e < 2 * KT * CPR; e += kFaThreads) {
      const int which = e / (KT * CPR), rem = e % (KT * CPR);
      const int row = rem / CPR, c = rem % CPR, kp = k0 + row;
      const bool ok = kp < Tk;
      const T* base = which ? v : k;
      const T* src =
          base + (((static_cast<size_t>(b) * Tk + (ok ? kp : 0)) * KH + kh) *
                      D + c * EPC);
      T* dst = (which ? vs : ks) + buf * TILE + row * PITCH + c * EPC;
      cp_async16(dst, src, ok);
    }
  };

  constexpr int NS = kFaStages;
  for (int it = 0; it < NS - 1; ++it) {
    if (it < n_tiles) issue(it, it);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it % NS;
    cp_async_wait<NS - 2>();
    // tile `it` is in shared memory for every thread, and every warp is
    // done with tile it-1, whose buffer the next copy refills
    __syncthreads();
    if (it + NS - 1 < n_tiles) issue(it + NS - 1, (it + NS - 1) % NS);
    cp_async_commit();
    const T* kt = ks + buf * TILE;
    const T* vt = vs + buf * TILE;
    const int k0 = k_begin + it * KT;

    // S = Q K^T: sc[j] holds (ra, 8j+2t), (ra, 8j+2t+1), (rb, 8j+2t),
    // (rb, 8j+2t+1).  Dims outer, keys inner: the NK accumulators take
    // independent products in turn
    float sc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kExact)
          ah[i] = __float_as_uint(qa[kk][i]);
        else
          split_tf32_here(qa[kk][i], ah[i], al[i]);
      }
      float kb[NK][2];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const T* krow = kt + (8 * j + g) * PITCH + 8 * kk + t;
        kb[j][0] = to_f32(krow[0]);
        kb[j][1] = to_f32(krow[4]);
      }
      mma_rows<NK, !kExact, !kExact>(sc, 0, ah, al, kb);
    }

    // softcap, mask, online softmax on the fragments.  The mask is formed
    // only on a tile that some key of it hides from some row of this warp
    // (the diagonal, the window's edge, the ends of S and T)
    const int w_first = q0 + warp * 16, w_last = w_first + 15;
    bool unmasked = k0 + KT <= Tk && w_last < S;
    if (causal) unmasked = unmasked && k0 + KT - 1 <= w_first;
    if (window) unmasked = unmasked && w_last - k0 < window;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = kExact ? __fmul_rn(sc[j][i], scale) : sc[j][i];
        s = cap_score(s, softcap);
        if (!unmasked) {
          const int q_pos = i < 2 ? ra : rb;
          const int kp = k0 + 8 * j + 2 * t + (i & 1);
          bool ok = q_pos < S && kp < Tk;
          if (causal) ok = ok && q_pos >= kp;
          if (window) ok = ok && q_pos - kp < window;
          s = ok ? s : kNegInf;
        }
        sc[j][i] = s;
        if (i < 2)
          mx_a = fmaxf(mx_a, s);
        else
          mx_b = fmaxf(mx_b, s);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mn = i < 2 ? mn_a : mn_b;
        // a masked key holds kNegInf; p is 0 there, as the reference's mask
        const float p =
            sc[j][i] == kNegInf ? 0.0f : expf(__fsub_rn(sc[j][i], mn));
        sc[j][i] = p;
        if (i < 2)
          ps_a = __fadd_rn(ps_a, p);
        else
          ps_b = __fadd_rn(ps_b, p);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      ps_a = __fadd_rn(ps_a, __shfl_xor_sync(0xffffffffu, ps_a, off));
      ps_b = __fadd_rn(ps_b, __shfl_xor_sync(0xffffffffu, ps_b, off));
    }
    const float corr_a = expf(__fsub_rn(m_a, mn_a));
    const float corr_b = expf(__fsub_rn(m_b, mn_b));
    l_a = __fadd_rn(__fmul_rn(l_a, corr_a), ps_a);
    l_b = __fadd_rn(__fmul_rn(l_b, corr_b), ps_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] = __fmul_rn(oacc[n][0], corr_a);
      oacc[n][1] = __fmul_rn(oacc[n][1], corr_a);
      oacc[n][2] = __fmul_rn(oacc[n][2], corr_b);
      oacc[n][3] = __fmul_rn(oacc[n][3], corr_b);
    }

    // O += P V; over 8-key step j, k index t is key 2t and t+4 is key 2t+1
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float pa[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(pa[i], ah[i], al[i]);
      const T* v0 = vt + (8 * j + 2 * t) * PITCH;
      const T* v1 = v0 + PITCH;
      // NV 8-dim tiles at a time (registers for their splits at D 128)
#pragma unroll
      for (int n0 = 0; n0 < ND; n0 += NV) {
        float vb[NV][2];
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          vb[n][0] = to_f32(v0[8 * (n0 + n) + g]);
          vb[n][1] = to_f32(v1[8 * (n0 + n) + g]);
        }
        mma_rows<NV, true, !kExact>(oacc, n0, ah, al, vb);
      }
    }
  }

  // oacc[n] holds (ra, 8n+2t), (ra, 8n+2t+1), (rb, 8n+2t), (rb, 8n+2t+1)
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = 8 * n + 2 * t;
    if (ra < S) {
      T* dst = o + ((static_cast<size_t>(b) * S + ra) * H + h) * D + d;
      dst[0] = from_f32<T>(__fdiv_rn(oacc[n][0], den_a));
      dst[1] = from_f32<T>(__fdiv_rn(oacc[n][1], den_a));
    }
    if (rb < S) {
      T* dst = o + ((static_cast<size_t>(b) * S + rb) * H + h) * D + d;
      dst[0] = from_f32<T>(__fdiv_rn(oacc[n][2], den_b));
      dst[1] = from_f32<T>(__fdiv_rn(oacc[n][3], den_b));
    }
  }
}

template <class T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int Tk, int H, int KH, int causal,
                         int window, float softcap, float scale,
                         cudaStream_t stream) {
  constexpr int smem = FlashShape<T, D>::SMEM;
  auto kernel = flash_tc<T, D>;
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
    case 112:
      return launch_flash<T, 112>(q, k, v, o, B, S, Tk, H, KH, causal,
                                  window, softcap, scale, stream);
    case 128:
      return launch_flash<T, 128>(q, k, v, o, B, S, Tk, H, KH, causal,
                                  window, softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// paged decode attention: split-KV pass and merge
// ---------------------------------------------------------------------------

constexpr int kPdThreads = 128;
constexpr int kPdWarps = kPdThreads / 32;
constexpr int kPdStages = 2;  // double buffer: a stage's copies in flight
                              // while the one before is consumed
constexpr int kPdHeads = 8;   // query heads a block holds (G > 8: more
                              // blocks per KV head)

template <class T, int D>
struct PagedShape {
  static constexpr int R = 8 * kPdWarps;  // rows per stage: 8 per warp
  static constexpr int PITCH = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int CPR = D * static_cast<int>(sizeof(T)) / 16;
  static constexpr int DPL = D >= 32 ? D / 32 : 1;  // P V dims per lane
};

// dynamic shared memory of paged_decode<T, D> at pps pages per split
template <class T, int D>
size_t paged_smem(int pps) {
  using Sh = PagedShape<T, D>;
  return sizeof(T) * 2 * kPdStages * static_cast<size_t>(Sh::R) * Sh::PITCH +
         sizeof(float) * (kPdHeads * D + kPdWarps * (8 * kPdHeads +
                                                     2 * kPdHeads)) +
         sizeof(int) * (kPdStages * Sh::R + static_cast<size_t>(pps));
}

template <class T, int D>
__global__ void __launch_bounds__(kPdThreads)
    paged_decode(const T* __restrict__ q, const T* __restrict__ kpool,
                 const T* __restrict__ vpool, const int* __restrict__ tables,
                 const int* __restrict__ lengths, T* __restrict__ o,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, int NP, int ps, int KH, int G,
                 int P, int pps, int window, float softcap, float scale) {
  using Sh = PagedShape<T, D>;
  constexpr int R = Sh::R, PITCH = Sh::PITCH, CPR = Sh::CPR, DPL = Sh::DPL;
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));
  constexpr int NC = D / 16;  // float4 chunks of a row per quad lane
  constexpr int NS = kPdStages, HB = kPdHeads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);        // [NS][R][PITCH]
  T* vs = ks + NS * R * PITCH;                   // [NS][R][PITCH]
  float* qs = reinterpret_cast<float*>(vs + NS * R * PITCH);  // [HB][D]
  float* pw = qs + HB * D;                       // [warps][8 rows][HB] p
  float* wm = pw + kPdWarps * 8 * HB;            // [warps][HB] warp max
  float* wl = wm + kPdWarps * HB;                // [warps][HB] warp sum
  int* rowok = reinterpret_cast<int*>(wl + kPdWarps * HB);  // [NS][R]
  int* tbl = rowok + NS * R;                     // [pps] the split's pages
  float* wacc = reinterpret_cast<float*>(smem_raw);  // [warps][HB][D],
                                                     // after the ring

  const int n_hc = (G + HB - 1) / HB;
  const int kh = blockIdx.x / n_hc, hc = blockIdx.x % n_hc;
  const int b = blockIdx.y, split = blockIdx.z, n_splits = gridDim.z;
  const int h0 = hc * HB, hb = min(HB, G - h0);  // this block's heads
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r8 = lane >> 2, dq = lane & 3;
  const int length = lengths[b];
  const size_t q_off = (static_cast<size_t>(b) * KH * G + kh * G + h0) * D;
  const size_t part = (static_cast<size_t>(b) * KH + kh) * n_splits + split;

  // this block's rows: the split's, clipped to the visible ones
  int r_lo = split * pps * ps;
  const int r_hi = min(min((split + 1) * pps, P) * ps, length);
  if (window) r_lo = max(r_lo, length - window);
  const int n_stages = r_hi > r_lo ? (r_hi - r_lo + R - 1) / R : 0;

  for (int e = tid; e < hb * D; e += kPdThreads)
    qs[e] = __fmul_rn(to_f32(q[q_off + e]), scale);
  for (int j = tid; j < pps; j += kPdThreads) {
    const int idx = split * pps + j;
    tbl[j] = idx < P ? tables[static_cast<size_t>(b) * P + idx] : -1;
  }
  __syncthreads();

  // four threads a row: one page lookup and address a thread, then its
  // quarter of the row's 16-byte chunks of K and of V
  static_assert(R == kPdThreads / 4, "a stage is four threads a row");
  auto issue = [&](int stage, int buf) {
    const int row = tid / 4, quarter = tid % 4;
    const int tok = r_lo + stage * R + row;
    const int page = tok < r_hi ? tbl[tok / ps - split * pps] : -1;
    const bool ok = page >= 0 && page < NP;
    const size_t off =
        ((static_cast<size_t>(ok ? page : 0) * ps + (ok ? tok % ps : 0)) *
             KH + kh) * D;
    T* kd = ks + (buf * R + row) * PITCH;
    T* vd = vs + (buf * R + row) * PITCH;
#pragma unroll
    for (int c = quarter; c < CPR; c += 4) {
      cp_async16(kd + c * EPC, kpool + off + c * EPC, ok);
      cp_async16(vd + c * EPC, vpool + off + c * EPC, ok);
    }
    if (quarter == 0) rowok[buf * R + row] = ok;
  };

  // each warp keeps its own online softmax over its 8 rows of every stage:
  // m, l per head (the same in every lane) and acc over the lane's dims
  float m[HB], l[HB], acc[HB][DPL];
#pragma unroll
  for (int u = 0; u < HB; ++u) {
    m[u] = kNegInf;
    l[u] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[u][i] = 0.0f;
  }
  const int d0 = min(lane * DPL, D - DPL);  // the lane's dims (D 16: lanes
                                            // 16-31 repeat the last one)
  float* pwarp = pw + warp * 8 * HB;

  for (int st = 0; st < NS - 1; ++st) {
    if (st < n_stages) issue(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    const int buf = st % NS;
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage st landed; stage st-1 consumed by every warp
    if (st + NS - 1 < n_stages) issue(st + NS - 1, (st + NS - 1) % NS);
    cp_async_commit();
    const int r = warp * 8 + r8;  // the lane's row of this stage
    const T* krow = ks + (buf * R + r) * PITCH;
    const bool live = rowok[buf * R + r];

    // scores of row r: lane dq holds dims 4dq + 16i; the quad sums
    float4 kr[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) kr[i] = load4(krow + 4 * dq + 16 * i);
    float s[HB];
#pragma unroll
    for (int u = 0; u < HB; ++u) {
      s[u] = kNegInf;
      if (u < hb) {
        float sv = 0.0f;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const float4 qv = load4(qs + u * D + 4 * dq + 16 * i);
          sv = fmaf(qv.x, kr[i].x, sv);
          sv = fmaf(qv.y, kr[i].y, sv);
          sv = fmaf(qv.z, kr[i].z, sv);
          sv = fmaf(qv.w, kr[i].w, sv);
        }
        sv = __fadd_rn(sv, __shfl_xor_sync(0xffffffffu, sv, 1));
        sv = __fadd_rn(sv, __shfl_xor_sync(0xffffffffu, sv, 2));
        s[u] = live ? cap_score(sv, softcap) : kNegInf;
      }
    }

    // online softmax over the warp's 8 rows (lanes differing in r8)
#pragma unroll
    for (int u = 0; u < HB; ++u) {
      if (u < hb) {
        float mx = s[u];
#pragma unroll
        for (int off = 4; off < 32; off *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[u], mx);
        const float p = s[u] == kNegInf ? 0.0f : expf(__fsub_rn(s[u], m_new));
        float psum = p;
#pragma unroll
        for (int off = 4; off < 32; off *= 2)
          psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, off));
        const float corr = expf(__fsub_rn(m[u], m_new));
        l[u] = __fadd_rn(__fmul_rn(l[u], corr), psum);
        m[u] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[u][i] = __fmul_rn(acc[u][i], corr);
        if (dq == 0) pwarp[r8 * HB + u] = p;
      }
    }
    __syncwarp();

    // acc += P V over the warp's 8 rows; p broadcast from shared memory
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const T* vrow = vs + (buf * R + warp * 8 + rr) * PITCH + d0;
      float v[DPL];
      if constexpr (DPL == 4) {
        const float4 x = load4(vrow);
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) v[i] = to_f32(vrow[i]);
      }
#pragma unroll
      for (int u = 0; u < HB; ++u) {
        if (u < hb) {
          const float p = pwarp[rr * HB + u];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[u][i] = fmaf(p, v[i], acc[u][i]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' accumulators

  // the four warps' partials, merged in warp order
  if (lane == 0)
    for (int u = 0; u < hb; ++u) {
      wm[warp * HB + u] = m[u];
      wl[warp * HB + u] = l[u];
    }
  if (lane * DPL < D)
#pragma unroll
    for (int u = 0; u < HB; ++u)
      if (u < hb)
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          wacc[(warp * HB + u) * D + d0 + i] = acc[u][i];
  __syncthreads();
  for (int e = tid; e < hb * D; e += kPdThreads) {
    const int u = e / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kPdWarps; ++w) mx = fmaxf(mx, wm[w * HB + u]);
    float lsum = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kPdWarps; ++w) {
      const float c = expf(__fsub_rn(wm[w * HB + u], mx));
      lsum = fmaf(wl[w * HB + u], c, lsum);
      a = fmaf(wacc[w * HB * D + e], c, a);
    }
    if (n_splits == 1) {
      o[q_off + e] = from_f32<T>(__fdiv_rn(a, fmaxf(lsum, 1e-30f)));
    } else {
      part_acc[(part * G + h0) * D + e] = a;
      if (e % D == 0) {
        part_m[part * G + h0 + u] = mx;
        part_l[part * G + h0 + u] = lsum;
      }
    }
  }
}

// o[b, kh*G + g, d] from the splits' partials, in split order: a thread
// per output element (grid (G*D / 128, K, B)), its loads independent of
// one another so that they overlap
template <class T>
__global__ void __launch_bounds__(kPdThreads)
    paged_merge(const float* __restrict__ part_m,
                const float* __restrict__ part_l,
                const float* __restrict__ part_acc, T* __restrict__ o, int KH,
                int G, int D, int n_splits) {
  const int e = blockIdx.x * kPdThreads + threadIdx.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  if (e >= G * D) return;
  const int g = e / D;
  const size_t part0 = (static_cast<size_t>(b) * KH + kh) * n_splits;
  const size_t q_off = (static_cast<size_t>(b) * KH * G + kh * G) * D;
  float mx = kNegInf;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s)
    mx = fmaxf(mx, part_m[(part0 + s) * G + g]);
  float l = 0.0f, a = 0.0f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(__fsub_rn(part_m[(part0 + s) * G + g], mx));
    l = fmaf(part_l[(part0 + s) * G + g], w, l);
    a = fmaf(part_acc[(part0 + s) * G * D + e], w, a);
  }
  o[q_off + e] = from_f32<T>(__fdiv_rn(a, fmaxf(l, 1e-30f)));
}

template <class T, int D>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp,
                         const int* tables, const int* lengths, void* o,
                         float* pm, float* pl, float* pa, int B, int KH, int G,
                         int NP, int ps, int P, int pps, int n_splits,
                         int window, float softcap, float scale,
                         cudaStream_t stream) {
  auto kernel = paged_decode<T, D>;
  const size_t smem = paged_smem<T, D>(pps);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(KH * ((G + kPdHeads - 1) / kPdHeads), B, n_splits);
  kernel<<<grid, kPdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lengths, static_cast<T*>(o), pm, pl,
      pa, NP, ps, KH, G, P, pps, window, softcap, scale);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch_paged(const void* q, const void* kp, const void* vp,
                           const int* tables, const int* lengths, void* o,
                           float* pm, float* pl, float* pa, int B, int KH,
                           int G, int D, int NP, int ps, int P, int pps,
                           int n_splits, int window, float softcap,
                           float scale, cudaStream_t s) {
#define PAGED_CASE(DIM)                                                      \
  case DIM:                                                                  \
    return launch_paged<T, DIM>(q, kp, vp, tables, lengths, o, pm, pl, pa,  \
                                B, KH, G, NP, ps, P, pps, n_splits, window, \
                                softcap, scale, s);
  switch (D) {
    PAGED_CASE(16)
    PAGED_CASE(32)
    PAGED_CASE(64)
    PAGED_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_CASE
}

}  // namespace

extern "C" {

// o [B,S,H,D] = attention of q [B,S,H,D] over k/v [B,T,KH,D]; dtype 0 is
// fp32, 1 is bf16; D in {32, 64, 112, 128}.
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

// The split pass of one-token attention of q [B,1,H,D] over the page pools
// kp/vp [NP,ps,KH,D] through tables [B,P] and lengths [B] (int32), pps
// pages per split.  With one split it writes o [B,1,H,D]; with more, the
// partials pm/pl [B,KH,splits,G] and pa [B,KH,splits,G,D] (fp32) for
// attn_paged_merge.  D in {16, 32, 64, 128}.
int attn_paged_decode(const void* q, const void* kp, const void* vp,
                      const int* tables, const int* lengths, void* o,
                      void* pm, void* pl, void* pa, int B, int H, int KH,
                      int D, int NP, int ps, int P, int pps, int window,
                      float softcap, float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int G = H / KH;
  const int n_splits = max(1, (P + pps - 1) / pps);
  if (n_splits > 65535) return cudaErrorInvalidValue;
  auto fm = static_cast<float*>(pm), fl = static_cast<float*>(pl),
       fa = static_cast<float*>(pa);
  if (dtype == 0)
    return dispatch_paged<float>(q, kp, vp, tables, lengths, o, fm, fl, fa,
                                 B, KH, G, D, NP, ps, P, pps, n_splits,
                                 window, softcap, scale, s);
  if (dtype == 1)
    return dispatch_paged<__nv_bfloat16>(q, kp, vp, tables, lengths, o, fm,
                                         fl, fa, B, KH, G, D, NP, ps, P, pps,
                                         n_splits, window, softcap, scale, s);
  return cudaErrorInvalidValue;
}

// o [B,1,H,D] from the partials of attn_paged_decode's `splits` splits
int attn_paged_merge(const void* pm, const void* pl, const void* pa, void* o,
                     int B, int H, int KH, int D, int splits, int dtype,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int G = H / KH;
  dim3 grid((G * D + kPdThreads - 1) / kPdThreads, KH, B);
  auto fm = static_cast<const float*>(pm);
  auto fl = static_cast<const float*>(pl);
  auto fa = static_cast<const float*>(pa);
  if (dtype == 0)
    paged_merge<float><<<grid, kPdThreads, 0, s>>>(
        fm, fl, fa, static_cast<float*>(o), KH, G, D, splits);
  else if (dtype == 1)
    paged_merge<__nv_bfloat16><<<grid, kPdThreads, 0, s>>>(
        fm, fl, fa, static_cast<__nv_bfloat16*>(o), KH, G, D, splits);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
