// Mamba-2 SSD scan for Hopper (sm_90a), chunk-parallel on the tensor cores.
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:77 ssd_scan_bh
// (body _ssd_kernel, :30) together with the layout work of its wrapper
// repro/kernels/ops.py:84 ssd_scan: it reads the model layout in place and
// adds the D-skip term.
//
//   x [B,S,H,P], dt [B,S,H] (fp32), a [H] (fp32, < 0), b/c [B,S,N],
//   d_skip [H] (fp32)  ->  y [B,S,H,P] in x's dtype, final state [B,H,N,P]
//
// Per head, with h the [N,P] state, h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t^T
// and y_t = C_t h_t + D x_t.  Over a chunk of L = 64 tokens, with cum_t the
// running sum of a*dt inside the chunk (the SSD paper's chunk-parallel
// form, arXiv:2405.21060 sections 6-7):
//   dS      = sum_s B_s^T (exp(cum_L - cum_s) dt_s x_s)           [N,P]
//   S_in[c] = exp(cum_L[c-1]) S_in[c-1] + dS[c-1],  S_in[0] = 0
//   y_t     = exp(cum_t) C_t S_in + sum_{s<=t} (C_t.B_s) exp(cum_t - cum_s)
//             dt_s x_s + D x_t
// Three kernels, one launch each:
//   ssd_chunk_states   grid (chunk, batch, head group): dS and exp(cum_L)
//                      of every chunk and head into scratch, in parallel;
//   ssd_state_pass     grid over (batch, head, N*P/4): the short serial
//                      scan over the chunks, in place (dS[c] -> S_in[c]),
//                      and the final state;
//   ssd_chunk_outputs  grid (chunk, batch, head group): y.
//
// Bound on this card (H100 SXM, 700 W): operations.  The least work is the
// recurrence itself, 5*N*P + 3*P + 2 operations per token and head; formed
// to fp32 accuracy on the tensor cores (three TF32 products per product,
// tf32_mma.cuh) its rate is 495 / 3 = 165 TFLOP/s: at [2,2048,24,64,128]
// 4.0 GFLOP, 0.025 ms, against 56 MB of x, y, b, c, dt and the final state,
// 0.017 ms at 3.35 TB/s.  The chunked form does more (C.B^T, the masked
// intra-chunk product and the scratch states: about 12 GFLOP of TF32
// products and 150 MB at that shape).
//
// Design:
//   * Products on mma.sync.m16n8k8 TF32 with 3xTF32 operands (each fp32
//     operand split hi/lo).  bf16 x, b, c are exact in TF32 and skip their
//     lo part: C.B^T in bf16 is one product.  The weighted operands
//     (exp(cum_L - cum_s) dt_s x_s, the masked G, the fp32 state) always
//     take the split.  All else, and the carried state, is fp32.
//   * One block of 8 warps owns one (batch, chunk) and a group of up to 8
//     heads (the wrapper picks the group to fill the card).  b and c are
//     one group shared by every head, so the block stages B (and C) once,
//     and the output pass forms G = C B^T once for all its heads.  Each
//     warp scans a*dt of one head with shuffles (up to 8 heads at once).
//   * Tiles go to shared memory in fp32 by 16-byte cp.async where every
//     row is 16-byte aligned (fp32), else by vector loads and conversion;
//     rows past S are zero (dt 0 adds no decay, B 0 and x 0 no input, so
//     the padded chunk is exact).  Pitches are padded so that every
//     fragment read falls in 32 distinct banks.  P is taken in tiles of 64
//     columns (48 where 32 does not divide P); the chunk pass double
//     buffers the x tiles, the next tile's copy running under this one's
//     products.
//   * A warp owns a 16-row tile of the product and PC = 32 (or 16)
//     columns; the masked product runs only over the key blocks at or
//     below the diagonal.  Mask entries with s > t are set to 0 by a select
//     and never computed (exp(cum_t - cum_s) overflows there; inf * 0 is
//     NaN).
//   * The scratch states [B,nc,H,N,P] and decays [B,nc,H] (fp32) are the
//     wrapper's torch.empty; the state pass streams them with float4 loads,
//     four chunks in flight.
//   * y is rounded once to x's dtype (round-to-nearest-even) after the
//     D-skip term is added.
//
// Launches go on the caller's stream; nothing syncs or allocates here, and
// each launcher returns cudaGetLastError() for the Python wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kL = 64;           // tokens per chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeads = 8;     // heads per block: one scan per warp
// two blocks an SM (registers capped at 128 a thread): the output pass's
// 110 KB of shared memory at N 128, P 64 leave room for two
constexpr int kMaxSmem = 232448; // bytes a block may have on the H100
constexpr int kGPitch = kL + 4;  // G rows: fragment reads in 32 banks

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
// columns of a P tile: 64 where 32 divides P (PC 32), else 48
__host__ __device__ constexpr int p_block(int pc) { return pc == 32 ? 64 : 48; }
__host__ __device__ constexpr int p_width(int P, int pc) {
  return P < p_block(pc) ? P : p_block(pc);
}

// shared memory of each pass, in floats (kernels/ssd_scan.py's smem_bytes
// mirrors these for its shape check)
__host__ __device__ constexpr int states_smem(int N, int P, int pc) {
  return kL * (round16(N) + 8)                 // B, token-major
         + 2 * kL * (p_width(P, pc) + 8)       // x tiles, two buffers
         + kMaxHeads * kL;                     // exp(cum_L - cum_s) dt_s
}
__host__ __device__ constexpr int outputs_smem(int N, int P, int pc) {
  return kL * (round16(N) + 4)                 // C
         + (kL * (round16(N) + 4) > round16(N) * (p_width(P, pc) + 8)
                ? kL * (round16(N) + 4)
                : round16(N) * (p_width(P, pc) + 8))  // B, then S_in tiles
         + kL * kGPitch                        // G = C B^T
         + kL * (p_width(P, pc) + 8)           // x tile
         + 3 * kMaxHeads * kL;                 // cum, exp(cum), dt
}

// rows [0, rows) x columns [0, cols) of a row-strided operand into fp32
// shared memory at `pitch`; rows >= valid are zero.  cols % 4 == 0; vec:
// every row is aligned to 16 bytes (fp32) or 8 (bf16).  A cp.async copy
// completes at the caller's cp_async_wait.
template <class T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      long long stride, int rows, int valid,
                                      int cols, bool vec) {
  const int q = cols / 4;
  for (int e = threadIdx.x; e < rows * q; e += kThreads) {
    const int r = e / q, c4 = 4 * (e % q);
    float* d = dst + r * pitch + c4;
    const bool ok = r < valid;
    const T* s = src + (ok ? r * stride : 0) + c4;
    if constexpr (sizeof(T) == 4) {
      if (vec) {
        cp_async16(d, s, ok);
        continue;
      }
    }
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ok) {
      if (vec)
        v = load4(s);
      else
        v = make_float4(to_f32(s[0]), to_f32(s[1]), to_f32(s[2]),
                        to_f32(s[3]));
    }
    *reinterpret_cast<float4*>(d) = v;
  }
}

// cum of a*dt over the chunk's tokens for head h, two tokens a lane of one
// warp: lane l holds tokens 2l and 2l+1 (dt 0 past `valid`).  Returns
// (cum_{2l}, cum_{2l+1}, dt_{2l}, dt_{2l+1}, cum_L).
struct Scan {
  float c0, c1, d0, d1, last;
};
__device__ __forceinline__ Scan scan_chunk(const float* dt, size_t tok0,
                                           int valid, int H, int h, float ah,
                                           int lane) {
  const int r0 = 2 * lane, r1 = r0 + 1;
  Scan o;
  o.d0 = r0 < valid ? dt[(tok0 + r0) * H + h] : 0.0f;
  o.d1 = r1 < valid ? dt[(tok0 + r1) * H + h] : 0.0f;
  const float v0 = __fmul_rn(ah, o.d0), v1 = __fmul_rn(ah, o.d1);
  float incl = __fadd_rn(v0, v1);
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, u);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  o.c0 = __fadd_rn(excl, v0);
  o.c1 = __fadd_rn(o.c0, v1);
  o.last = __shfl_sync(0xffffffffu, o.c1, 31);
  return o;
}

// ---------------------------------------------------------------------------
// pass 1: dS = B^T diag(w_out) X and exp(cum_L) of every chunk and head
// ---------------------------------------------------------------------------

template <class T, int PC>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_states(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const T* __restrict__ bm,
                     float* __restrict__ dstate, float* __restrict__ decay,
                     int S, int H, int P, int N, int hg, long long sx,
                     long long sb, int vec) {
  constexpr bool kExact = sizeof(T) == 2;  // bf16: exact in TF32
  constexpr int NB = PC / 8;               // 8-column tiles of a warp
  const int npad = round16(N), bpitch = npad + 8;
  const int pw_max = p_width(P, PC), xpitch = pw_max + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bs = reinterpret_cast<float*>(smem_raw);  // [kL][bpitch]
  float* xs = bs + kL * bpitch;                    // [2][kL][xpitch]
  float* wo = xs + 2 * kL * xpitch;                // [kMaxHeads][kL]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, nc = gridDim.x, b = blockIdx.y;
  const int h0 = blockIdx.z * hg, nh = min(hg, H - h0);
  const int s0 = c * kL, valid = min(kL, S - s0);
  const size_t tok0 = static_cast<size_t>(b) * S + s0;
  const int ntile = (P + pw_max - 1) / pw_max, units = nh * ntile;

  // B's padding columns [N, npad) stay zero
  for (int e = tid; e < kL * (npad - N); e += kThreads)
    bs[(e / (npad - N)) * bpitch + N + e % (npad - N)] = 0.0f;
  stage(bs, bpitch, bm + tok0 * sb, sb, kL, valid, N, vec);
  auto issue = [&](int u) {
    const int hh = u / ntile, p0 = (u % ntile) * pw_max;
    stage(xs + (u & 1) * kL * xpitch, xpitch,
          x + tok0 * sx + static_cast<size_t>(h0 + hh) * P + p0, sx, kL,
          valid, min(pw_max, P - p0), vec);
  };
  issue(0);
  cp_async_commit();

  for (int hh = warp; hh < nh; hh += kWarps) {
    const Scan sc = scan_chunk(dt, tok0, valid, H, h0 + hh, a[h0 + hh], lane);
    wo[hh * kL + 2 * lane] =
        __fmul_rn(expf(__fsub_rn(sc.last, sc.c0)), sc.d0);
    wo[hh * kL + 2 * lane + 1] =
        __fmul_rn(expf(__fsub_rn(sc.last, sc.c1)), sc.d1);
    if (lane == 0)
      decay[(static_cast<size_t>(b) * nc + c) * H + h0 + hh] = expf(sc.last);
  }

  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) issue(u + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile u, B and w_out are in place for every warp
    const int hh = u / ntile, p0 = (u % ntile) * pw_max;
    const int pw = min(pw_max, P - p0), groups = pw / PC;
    const float* xt = xs + (u & 1) * kL * xpitch;
    const float* w = wo + hh * kL;
    float* out = dstate +
                 ((static_cast<size_t>(b) * nc + c) * H + h0 + hh) *
                     static_cast<size_t>(N) * P +
                 p0;
    for (int job = warp; job < (npad / 16) * groups; job += kWarps) {
      const int m0 = 16 * (job / groups), n0 = PC * (job % groups);
      float acc[NB][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < kL; k0 += 8) {
        // A = B^T: (row n, column s) is bs[s][n]
        const float* ba = bs + (k0 + t) * bpitch + m0 + g;
        const float* bb = ba + 4 * bpitch;
        const float av[4] = {ba[0], ba[8], bb[0], bb[8]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kExact)
            ah[i] = __float_as_uint(av[i]);
          else
            split_tf32(av[i], ah[i], al[i]);
        }
        // B = w_out x: (row s, column p)
        const float w0 = w[k0 + t], w1 = w[k0 + t + 4];
        const float* x0 = xt + (k0 + t) * xpitch + n0 + g;
        const float* x1 = x0 + 4 * xpitch;
        float bv[NB][2];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          bv[j][0] = __fmul_rn(x0[8 * j], w0);
          bv[j][1] = __fmul_rn(x1[8 * j], w1);
        }
        mma_rows<NB, !kExact, true>(acc, 0, ah, al, bv);
      }
      // acc[j] holds (m0+g, n0+8j+2t..+1) and (m0+g+8, n0+8j+2t..+1)
      const int ra = m0 + g, rb = ra + 8;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (ra < N)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(ra) * P +
                                     col) = make_float2(acc[j][0], acc[j][1]);
        if (rb < N)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(rb) * P +
                                     col) = make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();  // every warp is done with buffer u & 1 (refilled next)
  }
}

// ---------------------------------------------------------------------------
// pass 2: S_in[c] = exp(cum_L[c-1]) S_in[c-1] + dS[c-1], in place; final
// state.  One thread per four state entries of a (batch, head).
// ---------------------------------------------------------------------------

constexpr int kAhead = 4;  // chunks whose loads are in flight at once

__global__ void __launch_bounds__(256)
    ssd_state_pass(float* __restrict__ states,
                   const float* __restrict__ decay, float* __restrict__ fin,
                   int nc, int H, int np4, long long total4) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total4; i += step) {
    const long long bh = i / np4;
    const int e = static_cast<int>(i % np4);
    const long long b = bh / H;
    const int h = static_cast<int>(bh % H);
    const size_t cstride = static_cast<size_t>(H) * np4;  // float4s a chunk
    float4* p = reinterpret_cast<float4*>(states) +
                (static_cast<size_t>(b) * nc * H + h) * np4 + e;
    const float* dec = decay + static_cast<size_t>(b) * nc * H + h;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c0 = 0; c0 < nc; c0 += kAhead) {
      float4 d[kAhead];
      float k[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (c0 + j < nc) {
          d[j] = p[(c0 + j) * cstride];
          k[j] = dec[static_cast<size_t>(c0 + j) * H];
        }
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (c0 + j < nc) {
          p[(c0 + j) * cstride] = s;
          s.x = __fadd_rn(__fmul_rn(k[j], s.x), d[j].x);
          s.y = __fadd_rn(__fmul_rn(k[j], s.y), d[j].y);
          s.z = __fadd_rn(__fmul_rn(k[j], s.z), d[j].z);
          s.w = __fadd_rn(__fmul_rn(k[j], s.w), d[j].w);
        }
      }
    }
    reinterpret_cast<float4*>(fin)[i] = s;
  }
}

// ---------------------------------------------------------------------------
// pass 3: y = diag(exp(cum)) C S_in + (G o mask) X + D X
// ---------------------------------------------------------------------------

template <class T, int PC>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_outputs(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ bm,
                      const T* __restrict__ cm,
                      const float* __restrict__ dskip,
                      const float* __restrict__ states, T* __restrict__ y,
                      int S, int H, int P, int N, int hg, long long sx,
                      long long sb, long long sc, int vec) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int NB = PC / 8;
  const int npad = round16(N), cpitch = npad + 4;
  const int pw_max = p_width(P, PC), xpitch = pw_max + 8;
  const int un = max(kL * cpitch, npad * xpitch);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cs = reinterpret_cast<float*>(smem_raw);  // [kL][cpitch]  C
  float* bs = cs + kL * cpitch;  // [kL][cpitch] B, then S_in [npad][xpitch]
  float* st = bs;
  float* gs = bs + un;           // [kL][kGPitch]  G = C B^T
  float* xs = gs + kL * kGPitch; // [kL][xpitch]   x tile
  float* cum = xs + kL * xpitch; // [kMaxHeads][kL]
  float* ecum = cum + kMaxHeads * kL;
  float* dts = ecum + kMaxHeads * kL;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, nc = gridDim.x, b = blockIdx.y;
  const int h0 = blockIdx.z * hg, nh = min(hg, H - h0);
  const int s0 = c * kL, valid = min(kL, S - s0);
  const size_t tok0 = static_cast<size_t>(b) * S + s0;
  const int ntile = (P + pw_max - 1) / pw_max;

  // the padding columns [N, npad) of C and B (rows 0..2kL of one pitch)
  for (int e = tid; e < 2 * kL * (npad - N); e += kThreads)
    cs[(e / (npad - N)) * cpitch + N + e % (npad - N)] = 0.0f;
  stage(cs, cpitch, cm + tok0 * sc, sc, kL, valid, N, vec);
  stage(bs, cpitch, bm + tok0 * sb, sb, kL, valid, N, vec);
  cp_async_commit();
  for (int hh = warp; hh < nh; hh += kWarps) {
    const Scan r = scan_chunk(dt, tok0, valid, H, h0 + hh, a[h0 + hh], lane);
    float* cu = cum + hh * kL;
    float* ec = ecum + hh * kL;
    float* dd = dts + hh * kL;
    cu[2 * lane] = r.c0;
    cu[2 * lane + 1] = r.c1;
    ec[2 * lane] = expf(r.c0);
    ec[2 * lane + 1] = expf(r.c1);
    dd[2 * lane] = r.d0;
    dd[2 * lane + 1] = r.d1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // G = C B^T on the tiles at or below the diagonal (16 rows x 32 columns
  // a warp; a tile wholly above it is never read)
  for (int job = warp; job < (kL / 16) * (kL / 32); job += kWarps) {
    const int m0 = 16 * (job / 2), n0 = 32 * (job % 2);
    if (n0 > m0 + 15) continue;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < npad; k0 += 8) {
      const float* ca = cs + (m0 + g) * cpitch + k0 + t;
      const float av[4] = {ca[0], ca[8 * cpitch], ca[4], ca[8 * cpitch + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kExact)
          ah[i] = __float_as_uint(av[i]);
        else
          split_tf32(av[i], ah[i], al[i]);
      }
      float bv[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* br = bs + (n0 + 8 * j + g) * cpitch + k0 + t;
        bv[j][0] = br[0];
        bv[j][1] = br[4];
      }
      mma_rows<4, !kExact, !kExact>(acc, 0, ah, al, bv);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* gr = gs + (m0 + g) * kGPitch + n0 + 8 * j + 2 * t;
      gr[0] = acc[j][0];
      gr[1] = acc[j][1];
      gr[8 * kGPitch] = acc[j][2];
      gr[8 * kGPitch + 1] = acc[j][3];
    }
  }
  __syncthreads();  // G is complete; B's space takes the S_in tiles
  // S_in's padding rows [N, npad) stay zero
  for (int e = tid; e < (npad - N) * xpitch; e += kThreads)
    st[N * xpitch + e] = 0.0f;

  for (int u = 0; u < nh * ntile; ++u) {
    const int hh = u / ntile, h = h0 + hh, p0 = (u % ntile) * pw_max;
    const int pw = min(pw_max, P - p0), groups = pw / PC;
    stage(st, xpitch,
          states + ((static_cast<size_t>(b) * nc + c) * H + h) *
                       static_cast<size_t>(N) * P + p0,
          P, N, N, pw, true);
    stage(xs, xpitch, x + tok0 * sx + static_cast<size_t>(h) * P + p0, sx,
          kL, valid, pw, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* cu = cum + hh * kL;
    const float* dd = dts + hh * kL;
    const float dh = dskip[h];
    for (int job = warp; job < (kL / 16) * groups; job += kWarps) {
      const int mt = job / groups, m0 = 16 * mt, n0 = PC * (job % groups);
      const int ra = m0 + g, rb = ra + 8;
      float acc[NB][4] = {};
      // C S_in
      for (int k0 = 0; k0 < npad; k0 += 8) {
        const float* ca = cs + ra * cpitch + k0 + t;
        const float av[4] = {ca[0], ca[8 * cpitch], ca[4],
                             ca[8 * cpitch + 4]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kExact)
            ah[i] = __float_as_uint(av[i]);
          else
            split_tf32(av[i], ah[i], al[i]);
        }
        const float* s0r = st + (k0 + t) * xpitch + n0 + g;
        const float* s1r = s0r + 4 * xpitch;
        float bv[NB][2];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          bv[j][0] = s0r[8 * j];
          bv[j][1] = s1r[8 * j];
        }
        mma_rows<NB, !kExact, true>(acc, 0, ah, al, bv);
      }
      const float ea = ecum[hh * kL + ra], eb = ecum[hh * kL + rb];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        acc[j][0] = __fmul_rn(acc[j][0], ea);
        acc[j][1] = __fmul_rn(acc[j][1], ea);
        acc[j][2] = __fmul_rn(acc[j][2], eb);
        acc[j][3] = __fmul_rn(acc[j][3], eb);
      }
      // (G o mask) X over the key blocks at or below the diagonal
      const float cta = cu[ra], ctb = cu[rb];
      for (int k0 = 0; k0 < m0 + 16; k0 += 8) {
        const int sa = k0 + t, sb2 = sa + 4;
        const float* ga = gs + ra * kGPitch;
        const float* gb = gs + rb * kGPitch;
        auto mval = [&](const float* grow, int tt, float ct, int s) {
          return s <= tt ? __fmul_rn(__fmul_rn(grow[s],
                                               expf(__fsub_rn(ct, cu[s]))),
                                     dd[s])
                         : 0.0f;
        };
        const float av[4] = {mval(ga, ra, cta, sa), mval(gb, rb, ctb, sa),
                             mval(ga, ra, cta, sb2), mval(gb, rb, ctb, sb2)};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
        const float* x0 = xs + sa * xpitch + n0 + g;
        const float* x1 = x0 + 4 * xpitch;
        float bv[NB][2];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          bv[j][0] = x0[8 * j];
          bv[j][1] = x1[8 * j];
        }
        mma_rows<NB, true, !kExact>(acc, 0, ah, al, bv);
      }
      // + D x, rounded once to T
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (ra < valid) {
          T* yr = y + ((tok0 + ra) * H + h) * static_cast<size_t>(P) + p0 +
                  col;
          const float* xr = xs + ra * xpitch + col;
          yr[0] = from_f32<T>(__fadd_rn(acc[j][0], __fmul_rn(dh, xr[0])));
          yr[1] = from_f32<T>(__fadd_rn(acc[j][1], __fmul_rn(dh, xr[1])));
        }
        if (rb < valid) {
          T* yr = y + ((tok0 + rb) * H + h) * static_cast<size_t>(P) + p0 +
                  col;
          const float* xr = xs + rb * xpitch + col;
          yr[0] = from_f32<T>(__fadd_rn(acc[j][2], __fmul_rn(dh, xr[0])));
          yr[1] = from_f32<T>(__fadd_rn(acc[j][3], __fmul_rn(dh, xr[1])));
        }
      }
    }
    __syncthreads();  // S_in and x are refilled by the next unit
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <class K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <class T, int PC>
cudaError_t launch_states(const void* x, const float* dt, const float* a,
                          const void* bm, float* dstate, float* decay, int B,
                          int S, int H, int P, int N, int hg, long long sx,
                          long long sb, int vec, cudaStream_t stream) {
  auto kernel = ssd_chunk_states<T, PC>;
  const size_t smem = sizeof(float) * states_smem(N, P, PC);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kL - 1) / kL, B, (H + hg - 1) / hg);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), dstate,
      decay, S, H, P, N, hg, sx, sb, vec);
  return cudaGetLastError();
}

template <class T, int PC>
cudaError_t launch_outputs(const void* x, const float* dt, const float* a,
                           const void* bm, const void* cm,
                           const float* dskip, const float* states, void* y,
                           int B, int S, int H, int P, int N, int hg,
                           long long sx, long long sb, long long sc, int vec,
                           cudaStream_t stream) {
  auto kernel = ssd_chunk_outputs<T, PC>;
  const size_t smem = sizeof(float) * outputs_smem(N, P, PC);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kL - 1) / kL, B, (H + hg - 1) / hg);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), dskip, states, static_cast<T*>(y), S, H, P,
      N, hg, sx, sb, sc, vec);
  return cudaGetLastError();
}

bool shape_ok(int B, int S, int H, int P, int N, int hg, int p_tile) {
  return B >= 1 && S >= 1 && H >= 1 && N >= 4 && N % 4 == 0 && P % 16 == 0 &&
         P >= 16 && (p_tile == 16 || p_tile == 32) && P % p_tile == 0 &&
         hg >= 1 && hg <= kMaxHeads && B <= 65535 && (H + hg - 1) / hg <= 65535;
}

}  // namespace

extern "C" {

// Pass 1.  x [B,S,H,P] and b [B,S,N] are read with token strides sx, sb
// (in elements); dt [B,S,H] and a [H] are contiguous fp32.  Writes dstate
// [B,nc,H,N,P] and decay [B,nc,H] (fp32, contiguous), nc = ceil(S / 64).
// dtype 0 is fp32, 1 bf16 (x and b); p_tile in {16, 32} divides P; hg
// heads a block (1..8); vec: every row 16-byte (fp32) / 8-byte (bf16)
// aligned.
int ssd_chunk_states_forward(const void* x, const float* dt, const float* a,
                             const void* b, float* dstate, float* decay,
                             int B, int S, int H, int P, int N, int hg,
                             long long sx, long long sb, int p_tile, int vec,
                             int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, S, H, P, N, hg, p_tile)) return cudaErrorInvalidValue;
  if (dtype == 0 && p_tile == 32)
    return launch_states<float, 32>(x, dt, a, b, dstate, decay, B, S, H, P, N,
                                    hg, sx, sb, vec, s);
  if (dtype == 0 && p_tile == 16)
    return launch_states<float, 16>(x, dt, a, b, dstate, decay, B, S, H, P, N,
                                    hg, sx, sb, vec, s);
  if (dtype == 1 && p_tile == 32)
    return launch_states<__nv_bfloat16, 32>(x, dt, a, b, dstate, decay, B, S,
                                            H, P, N, hg, sx, sb, vec, s);
  if (dtype == 1 && p_tile == 16)
    return launch_states<__nv_bfloat16, 16>(x, dt, a, b, dstate, decay, B, S,
                                            H, P, N, hg, sx, sb, vec, s);
  return cudaErrorInvalidValue;
}

// Pass 2, in place on states [B,nc,H,N,P] (dS in, S_in out), decay
// [B,nc,H]; writes fin [B,H,N,P].  All fp32, contiguous, 16-byte aligned;
// N * P % 4 == 0.
int ssd_state_pass_forward(float* states, const float* decay, float* fin,
                           int B, int nc, int H, int N, int P, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B < 1 || nc < 1 || H < 1 || (static_cast<long long>(N) * P) % 4 != 0)
    return cudaErrorInvalidValue;
  const int np4 = N * P / 4;
  const long long total4 = static_cast<long long>(B) * H * np4;
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (total4 + 255) / 256;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  ssd_state_pass<<<blocks, 256, 0, s>>>(states, decay, fin, nc, H, np4,
                                        total4);
  return cudaGetLastError();
}

// Pass 3.  x, b, c as pass 1 (c with token stride sc), d_skip [H] fp32,
// states [B,nc,H,N,P] the S_in of pass 2; writes y [B,S,H,P] (contiguous,
// x's dtype).
int ssd_chunk_outputs_forward(const void* x, const float* dt, const float* a,
                              const void* b, const void* c,
                              const float* d_skip, const float* states,
                              void* y, int B, int S, int H, int P, int N,
                              int hg, long long sx, long long sb,
                              long long sc, int p_tile, int vec, int dtype,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, S, H, P, N, hg, p_tile)) return cudaErrorInvalidValue;
  if (dtype == 0 && p_tile == 32)
    return launch_outputs<float, 32>(x, dt, a, b, c, d_skip, states, y, B, S,
                                     H, P, N, hg, sx, sb, sc, vec, s);
  if (dtype == 0 && p_tile == 16)
    return launch_outputs<float, 16>(x, dt, a, b, c, d_skip, states, y, B, S,
                                     H, P, N, hg, sx, sb, sc, vec, s);
  if (dtype == 1 && p_tile == 32)
    return launch_outputs<__nv_bfloat16, 32>(x, dt, a, b, c, d_skip, states,
                                             y, B, S, H, P, N, hg, sx, sb, sc,
                                             vec, s);
  if (dtype == 1 && p_tile == 16)
    return launch_outputs<__nv_bfloat16, 16>(x, dt, a, b, c, d_skip, states,
                                             y, B, S, H, P, N, hg, sx, sb, sc,
                                             vec, s);
  return cudaErrorInvalidValue;
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
