// Compressed-gossip passes for Hopper (sm_90a).
//
// Three elementwise kernels, each replacing one Pallas TPU kernel of
// repro/kernels/compress.py:
//
//   cmp_gamma_correct       gamma_correct (_gamma_correct_kernel): the
//                           CHOCO/EF post-exchange correction
//                           out = x + gamma*(mixed - anchor) over the packed
//                           tree; reads 3 and writes 1 fp32 per element,
//                           16 bytes
//   cmp_threshold_mask_group
//                           threshold_mask (_threshold_mask_kernel): top-k's
//                           mask and residual on each [rows, f] leaf of a
//                           message, q = x*[|x| >= thr_row], r = x - q;
//                           reads 1 and writes 2, 12 bytes per element
//   cmp_quantize_dequantize_group
//                           quantize_dequantize (_qdq_kernel): QSGD's
//                           stochastic quantize -> dequantize and residual on
//                           each [rows, f] leaf with uniform noise u; reads 2
//                           and writes 2, 16 bytes per element
//
// and one that replaces a sequence of them on the compressed-gossip path:
//
//   cmp_choco_exchange      gamma_correct (repro/kernels/compress.py:115),
//                           the dense mix of the anchors (mix_dense of
//                           repro/core/gossip.py) and the QG refresh that
//                           follows the round, fused_qg_buffer
//                           (repro/kernels/qg_update.py:133), in one launch
//                           (see below).
//
// Bound on this card: device-memory bandwidth.  Each does a handful of
// fp32 operations per element (gamma_correct 3, threshold_mask 3,
// quantize_dequantize 9) against 12-16 bytes, far below the ~20
// operations per byte at which the card's fp32 rate would bind.  What the
// design does about it: one pass, each input read once and each output
// written once; the per-row scalar (threshold or scale) is read once per
// tile of a row, gamma rides as a launch argument.
//
// Design:
//   * gamma_correct is launch3 of elementwise.cuh (1-D grid-stride, masked
//     tail, float4 iff every pointer is 16-byte aligned);
//   * the two row-wise kernels are launch_rowwise_group: one launch takes
//     every leaf of a message (up to kMaxLeaves, the leaf table passed by
//     value), since most leaves of a model are too small to be more than a
//     launch's fixed cost; every row of a leaf whose streams share their
//     address modulo 16 bytes (any contiguous leaf from an aligned base)
//     runs on float4 between a head peeled to a 128-byte (or, to compare,
//     16-byte) boundary and a masked tail whatever its width, each thread
//     with two float4 of each input in flight, issued before the row's
//     scalar is bound; the grid fills the card over the whole group.
//     Nothing is padded to the reference's TILE;
//   * every product, sum and quotient is an explicit round-to-nearest
//     intrinsic in the Pallas body's order, and levels/s and s/levels are
//     true divisions (__fdiv_rn), as the plain PyTorch versions in
//     repro_torch/kernels/ref.py compute them;
//   * the scale is clamped to 1e-12 (a zero row quantizes to zero) and xi to
//     levels (u just under 1 cannot round past the top level).  sign(x) is
//     +1, -1 or +0, as torch.sign gives it.
//
// choco_exchange: the exchange half of one compressed gossip round, with
// the QG refresh after it.  After the compressor has made q, the reference
// runs, leaf by leaf or packed: the replica advance a = x_hat + q (CHOCO;
// EF's anchor is q itself), the mix W @ a (one product a leaf), packing,
// gamma_correct x_out = half + gamma*(W a - a), packing again and
// fused_qg_buffer: about 17 launches on the quickstart's four leaves, each
// at the launch floor.  Every leaf is node-stacked [n, f] and the mix runs
// along the node axis, so one launch does it all over column tiles of all
// n nodes (node_mix.cuh, as qg_step):
//   * phase 1: each thread loads half, q (and x_hat; x_pre and m_hat for
//     QG) of its (R nodes, 4 columns), forms a, stores it as the site's new
//     replicas (CHOCO) and writes it into shared memory;
//   * phase 2: after a barrier, mixed = sum_k W[node,k] * a[k] in node
//     order, then x_out = half + gamma*(mixed - a) from a still in
//     registers, and the QG refresh on x_pre, x_out and m_hat.
// Bound on this card: bytes, 8 streams at most (half, x_hat, q, x_pre,
// m_hat in; x_out, x_hat', m_hat' out) against 2n + 8 flops an element.
// Outputs are one buffer a role (the wrapper's torch.empty), each leaf at
// the same element offset in every one, so the table carries one offset
// for the three and stays within 4 KB at 48 leaves.

#include "node_mix.cuh"

namespace {

struct GammaCorrect {
  float gamma;  // the resolved consensus step size, folded to fp32

  __device__ __forceinline__ void operator()(float x, float mixed,
                                             float anchor, float& out,
                                             float&) const {
    out = __fadd_rn(x, __fmul_rn(gamma, __fsub_rn(mixed, anchor)));
  }
  __device__ __forceinline__ GammaCorrect bind() const { return *this; }
};

struct ThresholdMask {
  struct Bound {
    float thr;
    __device__ __forceinline__ void operator()(float x, float, float& q,
                                               float& r) const {
      q = fabsf(x) >= thr ? x : 0.0f;  // ties at the threshold are kept
      r = __fsub_rn(x, q);
    }
  };
  __device__ __forceinline__ Bound bind(float thr) const { return {thr}; }
};

struct QuantizeDequantize {
  float levels;  // L = 2^bits - 1

  struct Bound {
    float up, down, levels;  // L/s and s/L
    __device__ __forceinline__ void operator()(float x, float u, float& q,
                                               float& r) const {
      const float y = __fmul_rn(fabsf(x), up);
      float xi = floorf(__fadd_rn(y, u));
      if (xi > levels) xi = levels;
      const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
      q = __fmul_rn(__fmul_rn(sgn, xi), down);
      r = __fsub_rn(x, q);
    }
  };
  __device__ __forceinline__ Bound bind(float scale) const {
    const float s = isnan(scale) ? scale : fmaxf(scale, 1e-12f);
    return {__fdiv_rn(levels, s), __fdiv_rn(s, levels), levels};
  }
};

constexpr int kExchangeFields = 9;  // int64 a leaf in the table

struct ExchangeLeaf {
  const float* half;   // the half step: the tree the mix hook receives
  const float* x_hat;  // CHOCO: the site's replicas (EF: null)
  const float* q;      // the compressor's output
  const float* x_pre;  // QG: the params before the step (else null)
  const float* m_hat;  // QG: the buffer to refresh (else null)
  int64_t out;         // the leaf's first element in each output buffer
  int64_t f;           // columns: the leaf is [n, f]
  int64_t tile0;       // the leaf's first tile in the launch
  int64_t vec;         // 1: float4 path; 0: scalar loop
};

struct ExchangeGroup {
  ExchangeLeaf leaf[kMaxLeaves];
  float* x_out;
  float* x_hat_out;  // CHOCO: the new replicas (EF: null)
  float* m_out;      // QG: the refreshed buffer (DSGDm: null)
  int64_t tiles;     // of all leaves
  int64_t n;         // leaves
};
// a kernel parameter block holds 4 KB on every toolkit
static_assert(sizeof(ExchangeGroup) <= 4000, "the leaf table outgrows 4 KB");

// A block walks tiles blockIdx.x, + gridDim.x, ...
template <bool kChoco, bool kQg, int R>
__global__ void __launch_bounds__(kStepMaxThreads)
    choco_exchange_kernel(const __grid_constant__ ExchangeGroup grp,
                          const float* __restrict__ w, int nodes,
                          GammaCorrect gc, QgBuffer qb) {
  extern __shared__ float4 smem4[];
  const int stride = step_stride(nodes, R);
  float* swt = reinterpret_cast<float*>(smem4);  // swt[j*stride+i] = W[i,j]
  float* sa = swt + step_wt_floats(nodes, R);
  const int q = threadIdx.x % (kStepCols / 4);
  const int r0 = threadIdx.x / (kStepCols / 4) * R;  // first row of the thread
  const bool active = r0 < nodes;
  QgBuffer::Bound qg_fn{};
  if constexpr (kQg) qg_fn = qb.bind();
  for (int64_t t = blockIdx.x; t < grp.tiles; t += gridDim.x) {
    int64_t j0;
    const ExchangeLeaf& L = step_leaf(grp, t, j0);
    const int64_t f = L.f;
    const bool vec = L.vec != 0;
    float4 h[R], a[R], xh[R], xp[R], mh[R];
    load_rows<R>(L.half, f, j0, vec, active, r0, q, nodes, h);
    load_rows<R>(L.q, f, j0, vec, active, r0, q, nodes, a);
    if constexpr (kChoco)
      load_rows<R>(L.x_hat, f, j0, vec, active, r0, q, nodes, xh);
    if constexpr (kQg) {
      load_rows<R>(L.x_pre, f, j0, vec, active, r0, q, nodes, xp);
      load_rows<R>(L.m_hat, f, j0, vec, active, r0, q, nodes, mh);
    }
    // W^T, while the first tile's loads fly
    if (t == blockIdx.x) load_wt(swt, w, nodes, stride);
    // W^T is in, and the last tile's phase 2 is done with sa
    __syncthreads();
    // phase 1: the anchors of the thread's rows into shared memory
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!active || r0 + r >= nodes) continue;
      if constexpr (kChoco) {  // the replicas advance: a = x_hat + q
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lane(a[r], e) = __fadd_rn(lane(xh[r], e), lane(a[r], e));
        store_row(grp.x_hat_out + L.out, static_cast<int64_t>(r0 + r) * f, f,
                  j0, vec, q, a[r]);
      }
      put_tile_row(sa + (r0 + r) * kStepCols, vec, q, a[r]);
    }
    __syncthreads();
    if (active) {
      // phase 2: W @ a along the nodes, in node order
      float4 acc[R];
      mix_rows<R>(sa, swt, stride, nodes, q, r0, vec, acc);
      // then the correction and the QG refresh, a and the rest in registers
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r0 + r >= nodes) continue;
        const int64_t row = static_cast<int64_t>(r0 + r) * f;
        float4 xo;
        float unused;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          gc(lane(h[r], e), lane(acc[r], e), lane(a[r], e), lane(xo, e),
             unused);
        store_row(grp.x_out + L.out, row, f, j0, vec, q, xo);
        if constexpr (kQg) {
          float4 mo;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            qg_fn(lane(xp[r], e), lane(xo, e), lane(mh[r], e), lane(mo, e),
                  unused);
          store_row(grp.m_out + L.out, row, f, j0, vec, q, mo);
        }
      }
    }
  }
}

template <bool kChoco, bool kQg, int R>
int launch_exchange(const ExchangeGroup& g, int nodes, const float* w,
                    GammaCorrect gc, QgBuffer qb, cudaStream_t stream) {
  const int threads = step_threads(nodes, R);
  const size_t smem = step_smem(nodes, R);
  static int per_sm[kStepMaxNodes + 1] = {};
  int64_t blocks = 0;
  const cudaError_t err =
      step_grid(choco_exchange_kernel<kChoco, kQg, R>, per_sm, nodes, threads,
                smem, g.tiles, &blocks);
  if (err != cudaSuccess) return err;
  choco_exchange_kernel<kChoco, kQg, R>
      <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(g, w, nodes,
                                                                 gc, qb);
  return cudaGetLastError();
}

template <bool kChoco, bool kQg>
int launch_exchange_rows(const ExchangeGroup& g, int nodes, const float* w,
                         GammaCorrect gc, QgBuffer qb, cudaStream_t stream) {
  return step_rows(nodes) == 2
             ? launch_exchange<kChoco, kQg, 2>(g, nodes, w, gc, qb, stream)
             : launch_exchange<kChoco, kQg, 4>(g, nodes, w, gc, qb, stream);
}

}  // namespace

extern "C" {

// out = x + gamma*(mixed - anchor) over n elements.
int cmp_gamma_correct(const float* x, const float* mixed, const float* anchor,
                      float* out, int64_t n, float gamma, void* stream) {
  return launch3(x, mixed, anchor, out, nullptr, n, GammaCorrect{gamma},
                 stream);
}

// q = |x| >= thr[row] ? x : 0, r = x - q on each leaf x [rows, f] of a
// table of n leaves (launch_rowwise_group's layout; u is null).
int cmp_threshold_mask_group(const int64_t* table, int n, int64_t tiles,
                             void* stream) {
  return launch_rowwise_group(table, n, tiles, ThresholdMask{}, stream);
}

// QSGD on each leaf x, u [rows, f] with its scale [rows]; q the dequantized
// value, r = x - q.
int cmp_quantize_dequantize_group(const int64_t* table, int n, int64_t tiles,
                                  float levels, void* stream) {
  return launch_rowwise_group(table, n, tiles, QuantizeDequantize{levels},
                              stream);
}

// One launch of choco_exchange over ``n_leaves`` <= kMaxLeaves leaves of
// ``table`` (kExchangeFields int64 each: half, x_hat, q, x_pre, m_hat, out,
// f, tile0, vec), ``tiles`` their total in tiles of kStepCols columns, each
// leaf [nodes, f] with w the fp32 [nodes, nodes] mixing matrix.  Leaf i's
// outputs start at element ``out`` of x_out, x_hat_out and m_out.
// x_hat_out null: EF (the anchor is q; the table's x_hat is not read);
// m_out null: no refresh (DSGDm; x_pre, m_hat, eta and refresh not read).
// gamma is folded to fp32, mu and one_minus_mu in double on the host.
int cmp_choco_exchange(const int64_t* table, int n_leaves, int64_t tiles,
                       int nodes, float* x_out, float* x_hat_out,
                       float* m_out, const float* w, const float* eta,
                       const float* refresh, float gamma, float mu,
                       float one_minus_mu, void* stream) {
  if (n_leaves <= 0 || tiles <= 0) return cudaSuccess;
  if (n_leaves > kMaxLeaves || nodes < 1 || nodes > kStepMaxNodes ||
      x_out == nullptr ||
      (m_out != nullptr && (eta == nullptr || refresh == nullptr)))
    return cudaErrorInvalidValue;
  ExchangeGroup g{};
  for (int i = 0; i < n_leaves; ++i) {
    const int64_t* e = table + static_cast<int64_t>(i) * kExchangeFields;
    g.leaf[i] = {reinterpret_cast<const float*>(e[0]),
                 reinterpret_cast<const float*>(e[1]),
                 reinterpret_cast<const float*>(e[2]),
                 reinterpret_cast<const float*>(e[3]),
                 reinterpret_cast<const float*>(e[4]),
                 e[5], e[6], e[7], e[8]};
  }
  g.x_out = x_out;
  g.x_hat_out = x_hat_out;
  g.m_out = m_out;
  g.tiles = tiles;
  g.n = n_leaves;
  const GammaCorrect gc{gamma};
  const QgBuffer qb{eta, refresh, mu, one_minus_mu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_hat_out != nullptr)
    return m_out != nullptr
               ? launch_exchange_rows<true, true>(g, nodes, w, gc, qb, s)
               : launch_exchange_rows<true, false>(g, nodes, w, gc, qb, s);
  return m_out != nullptr
             ? launch_exchange_rows<false, true>(g, nodes, w, gc, qb, s)
             : launch_exchange_rows<false, false>(g, nodes, w, gc, qb, s);
}

// The exchange's geometry, for the wrapper to hold its own copy of it
// against: out = {kStepCols, kMaxLeaves, kExchangeFields, kStepMaxNodes}.
int cmp_exchange_geometry(int64_t* out) {
  out[0] = kStepCols;
  out[1] = kMaxLeaves;
  out[2] = kExchangeFields;
  out[3] = kStepMaxNodes;
  return 0;
}

// The row-wise launch geometry, for the wrapper to hold its own copy of it
// against: out = {kTileVecs, kTile, kMaxLeaves, kLeafFields}.
int cmp_rowwise_geometry(int64_t* out) {
  out[0] = kTileVecs;
  out[1] = kTile;
  out[2] = kMaxLeaves;
  out[3] = kLeafFields;
  return 0;
}

const char* cmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
