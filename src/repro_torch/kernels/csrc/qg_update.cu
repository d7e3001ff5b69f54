// Quasi-global momentum optimizer passes for Hopper (sm_90a).
//
// Four elementwise kernels, each replacing one Pallas TPU kernel:
//
//   qg_fused_halfstep   repro/kernels/qg_update.py:fused_halfstep
//                       (_fused_halfstep_kernel): weight decay + HeavyBall /
//                       QG-seeded momentum + the gossip half step
//   qg_fused_qg_buffer  repro/kernels/qg_update.py:fused_qg_buffer
//                       (_fused_qg_buffer_kernel): the post-mix QG buffer
//                       refresh behind the Alg. 3 tau gate
//   qg_local_step       repro/kernels/qg_update.py:qg_local_step
//                       (_local_step_kernel), static lr
//   qg_buffer_update    repro/kernels/qg_update.py:qg_buffer_update
//                       (_buffer_update_kernel), static lr
//
// and one that replaces a sequence of them on the dense-gossip path:
//
//   qg_step             repro/kernels/qg_update.py:116 fused_halfstep, the
//                       dense mix W @ half of repro/core/gossip.py
//                       (mix_dense) and repro/kernels/qg_update.py:133
//                       fused_qg_buffer, in one launch (see below).
//
// Bound on this card: device-memory bandwidth.  Each does a handful of
// flops per element and moves, per element, 12 bytes in and 4 out
// (16 bytes); fused_halfstep with emit_m writes a second output (20
// bytes).  What the design does about it: one pass, each input read once
// and each output written once, nothing else leaves the SM -- coefficients
// ride as launch arguments and the traced lr / refresh gate are read once
// per thread from device memory.
//
// Design (simple and right first; speed is later work):
//   * launch3 of elementwise.cuh: a 1-D grid-stride loop with 64-bit
//     indices and a masked ragged tail, so no padding is needed whatever
//     the packed length; float4 loads and stores only when every pointer
//     is 16-byte aligned, else the scalar loop;
//   * lr and refresh are fp32 [1] device operands, never host values, so a
//     step holds no host sync and stays capturable in a CUDA graph;
//   * every product, sum and quotient is an explicit round-to-nearest
//     intrinsic in the Pallas body's expression order: no FMA contraction
//     (the build also passes -fmad=false), so the kernels round as the
//     plain PyTorch versions in repro_torch/kernels/ref.py do;
//   * launched on the caller's stream; no sync and no allocation inside.
//     Each launcher returns cudaGetLastError() for the wrapper to check.
//
// qg_step: one training step's optimizer segment on the dense-gossip path.
// The reference cuts its fused segments at the mix site (gossip needs the
// per-node tree), so a step there streams x, m, g through fused_halfstep,
// the half step through the product W @ half, and x, x_new, m_hat through
// fused_qg_buffer: with the packing around them, about 22 arrays of the
// tree's size and 12 launches a QG step, where the step needs 5 streams
// (x, m, g in; x_new and m_hat_new, or DSGDm's m_new, out).  Every leaf
// is node-stacked [n, f] and the dense mix runs along the node axis only,
// so a block that holds one column tile of all n nodes holds all that
// those columns need:
//   * phase 1: each thread loads x, m, g of its (R nodes, 4 columns) and
//     forms the half step (and DSGDm's new buffer, stored at once) in
//     registers, writing half into shared memory ([n][kStepCols]);
//   * phase 2: after a barrier, it sums its (nodes, columns) over the n
//     rows of the tile, x_new = sum_k W[node,k] * half[k], in node order
//     k = 0..n-1 with __fmul_rn/__fadd_rn, W read once a block into
//     shared memory from the [n, n] device tensor of the step (so a
//     time-varying topology costs no host read), its first tile's loads
//     in flight meanwhile;
//   * the QG refresh then runs on x (still in registers), x_new and m_hat.
// Bytes bound it still: 20 bytes an element against 2n - 1 flops of the
// mix and about 13 of the two elementwise passes.
// The leaves of a tree go in one launch (up to kMaxLeaves, a table passed
// by value as in elementwise.cuh's rowwise_group), so nothing is packed.
// The tiles, the loads and stores (float4 or the scalar loop) and the mix
// are node_mix.cuh's, shared with compress.cu's choco_exchange; so is the
// QG refresh, QgBuffer.

#include "node_mix.cuh"

namespace {

struct Halfstep {
  const float* eta;  // fp32 [1] on the device
  float beta, wd;
  int nesterov, has_wd;

  struct Bound {
    float neg_eta, beta, wd;
    int nesterov, has_wd;
    __device__ __forceinline__ void operator()(float x, float m, float g,
                                               float& half, float& mn) const {
      const float ge = has_wd ? __fadd_rn(g, __fmul_rn(wd, x)) : g;
      mn = __fadd_rn(__fmul_rn(beta, m), ge);
      const float upd = nesterov ? __fadd_rn(__fmul_rn(beta, mn), ge) : mn;
      half = __fadd_rn(__fmul_rn(neg_eta, upd), x);
    }
  };
  __device__ __forceinline__ Bound bind() const {
    return {-__ldg(eta), beta, wd, nesterov, has_wd};
  }
};

struct LocalStep {
  float eta, beta;
  int nesterov;

  __device__ __forceinline__ void operator()(float x, float m, float g,
                                             float& out, float&) const {
    const float m_local = __fadd_rn(__fmul_rn(beta, m), g);
    const float upd = nesterov ? __fadd_rn(g, __fmul_rn(beta, m_local))
                               : m_local;
    out = __fsub_rn(x, __fmul_rn(eta, upd));
  }
  __device__ __forceinline__ LocalStep bind() const { return *this; }
};

struct BufferUpdate {
  float mu, one_minus_mu, inv_eta;

  __device__ __forceinline__ void operator()(float x_old, float x_new,
                                             float m, float& out,
                                             float&) const {
    const float d = __fmul_rn(__fmul_rn(one_minus_mu, __fsub_rn(x_old, x_new)),
                              inv_eta);
    out = __fadd_rn(__fmul_rn(mu, m), d);
  }
  __device__ __forceinline__ BufferUpdate bind() const { return *this; }
};

// ---------------------------------------------------------------------------
// qg_step: the half step, the dense mix and the QG refresh in one launch,
// over column tiles of all n nodes (node_mix.cuh).  C is 64, so that the
// small trees of the presets give a block to every SM (the quickstart MLP:
// 214 tiles).

constexpr int kStepFields = 8;                  // int64 a leaf in the table

struct StepLeaf {
  const float* x;
  const float* m;  // DSGDm's buffer, or the QG m_hat that seeds it
  const float* g;
  float* x_new;
  float* m_out;    // DSGDm's m_new, or QG's m_hat_new
  int64_t f;       // columns: the leaf is [n, f]
  int64_t tile0;   // the leaf's first tile in the launch
  int64_t vec;     // 1: float4 path; 0: scalar loop
};

struct StepGroup {
  StepLeaf leaf[kMaxLeaves];
  int64_t tiles;  // of all leaves
  int64_t n;      // leaves
};
static_assert(sizeof(StepGroup) <= 3500, "the leaf table outgrows 4 KB");

// A block walks tiles blockIdx.x, + gridDim.x, ...
template <bool kQg, int R>
__global__ void __launch_bounds__(kStepMaxThreads)
    qg_step_kernel(const __grid_constant__ StepGroup grp,
                   const float* __restrict__ w, int nodes, Halfstep hs,
                   QgBuffer qb) {
  extern __shared__ float4 smem4[];
  const int stride = step_stride(nodes, R);
  float* swt = reinterpret_cast<float*>(smem4);  // swt[j*stride+i] = W[i,j]
  float* sh = swt + step_wt_floats(nodes, R);
  const int q = threadIdx.x % (kStepCols / 4);
  const int r0 = threadIdx.x / (kStepCols / 4) * R;  // first row of the thread
  const bool active = r0 < nodes;
  const auto half_fn = hs.bind();
  QgBuffer::Bound qg_fn{};
  if constexpr (kQg) qg_fn = qb.bind();
  for (int64_t t = blockIdx.x; t < grp.tiles; t += gridDim.x) {
    int64_t j0;
    const StepLeaf& L = step_leaf(grp, t, j0);
    const int64_t f = L.f;
    const bool vec = L.vec != 0;
    float4 x[R], m[R], g[R];
    load_rows<R>(L.x, f, j0, vec, active, r0, q, nodes, x);
    load_rows<R>(L.m, f, j0, vec, active, r0, q, nodes, m);
    load_rows<R>(L.g, f, j0, vec, active, r0, q, nodes, g);
    // W^T, while the first tile's loads fly
    if (t == blockIdx.x) load_wt(swt, w, nodes, stride);
    // W^T is in, and the last tile's phase 2 is done with sh
    __syncthreads();
    // phase 1: the half step of the thread's rows into shared memory
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!active || r0 + r >= nodes) continue;
      float4 h, mn;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        half_fn(lane(x[r], e), lane(m[r], e), lane(g[r], e), lane(h, e),
                lane(mn, e));
      if constexpr (!kQg)  // DSGDm's new buffer needs no mix
        store_row(L.m_out, static_cast<int64_t>(r0 + r) * f, f, j0, vec, q,
                  mn);
      put_tile_row(sh + (r0 + r) * kStepCols, vec, q, h);
    }
    __syncthreads();
    if (active) {
      // phase 2: x_new = W @ half along the nodes, in node order
      float4 acc[R];
      mix_rows<R>(sh, swt, stride, nodes, q, r0, vec, acc);
      // then the QG refresh on x (still in registers), x_new and m_hat
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r0 + r >= nodes) continue;
        const int64_t row = static_cast<int64_t>(r0 + r) * f;
        store_row(L.x_new, row, f, j0, vec, q, acc[r]);
        if constexpr (kQg) {
          float4 mo;
          float unused;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            qg_fn(lane(x[r], e), lane(acc[r], e), lane(m[r], e),
                  lane(mo, e), unused);
          store_row(L.m_out, row, f, j0, vec, q, mo);
        }
      }
    }
  }
}

template <bool kQg, int R>
int launch_step(const StepGroup& g, int64_t tiles, int nodes, const float* w,
                Halfstep hs, QgBuffer qb, cudaStream_t stream) {
  const int threads = step_threads(nodes, R);
  const size_t smem = step_smem(nodes, R);
  static int per_sm[kStepMaxNodes + 1] = {};
  int64_t blocks = 0;
  const cudaError_t err = step_grid(qg_step_kernel<kQg, R>, per_sm, nodes,
                                    threads, smem, tiles, &blocks);
  if (err != cudaSuccess) return err;
  qg_step_kernel<kQg, R><<<static_cast<unsigned>(blocks), threads, smem,
                           stream>>>(g, w, nodes, hs, qb);
  return cudaGetLastError();
}

template <bool kQg>
int launch_step_rows(const StepGroup& g, int64_t tiles, int nodes,
                     const float* w, Halfstep hs, QgBuffer qb,
                     cudaStream_t stream) {
  return step_rows(nodes) == 2
             ? launch_step<kQg, 2>(g, tiles, nodes, w, hs, qb, stream)
             : launch_step<kQg, 4>(g, tiles, nodes, w, hs, qb, stream);
}

}  // namespace

extern "C" {

// half = -eta*upd + x with upd the (Nesterov) momentum of g + wd*x; m_out
// (nullable: emit_m) receives the new buffer beta*m + ge.
int qg_fused_halfstep(const float* x, const float* m, const float* g,
                      const float* eta, float* half, float* m_out, int64_t n,
                      float beta, float wd, int nesterov, int has_wd,
                      void* stream) {
  return launch3(x, m, g, half, m_out, n,
                 Halfstep{eta, beta, wd, nesterov, has_wd}, stream);
}

// out = refresh ? mu*m_hat + (1-mu)*((1/eta)*(x_pre - x_post)) : m_hat.
// one_minus_mu is 1-mu folded in double on the host, as the reference does.
int qg_fused_qg_buffer(const float* x_pre, const float* x_post,
                       const float* m_hat, const float* eta,
                       const float* refresh, float* out, int64_t n, float mu,
                       float one_minus_mu, void* stream) {
  return launch3(x_pre, x_post, m_hat, out, nullptr, n,
                 QgBuffer{eta, refresh, mu, one_minus_mu}, stream);
}

// out = x - eta*upd, upd = beta*m_hat + g or g + beta*(beta*m_hat + g).
int qg_local_step(const float* x, const float* m_hat, const float* g,
                  float* out, int64_t n, float eta, float beta, int nesterov,
                  void* stream) {
  return launch3(x, m_hat, g, out, nullptr, n,
                 LocalStep{eta, beta, nesterov}, stream);
}

// out = mu*m_hat + ((1-mu)*(x_old - x_new))*inv_eta, 1-mu and 1/eta folded
// in double on the host.
int qg_buffer_update(const float* x_old, const float* x_new,
                     const float* m_hat, float* out, int64_t n, float mu,
                     float one_minus_mu, float inv_eta, void* stream) {
  return launch3(x_old, x_new, m_hat, out, nullptr, n,
                 BufferUpdate{mu, one_minus_mu, inv_eta}, stream);
}

// One launch of qg_step over ``n_leaves`` <= kMaxLeaves leaves of
// ``table`` (kStepFields int64 each: x, m, g, x_new, m_out, f, tile0,
// vec), ``tiles`` their total in tiles of kStepCols columns, each leaf
// [nodes, f] with w the fp32 [nodes, nodes] mixing matrix.  qg_form != 0:
// m is m_hat and m_out receives the refresh (mu, one_minus_mu folded in
// double on the host) behind the ``refresh`` gate; else m_out receives the
// new HeavyBall buffer and refresh may be null.
int qg_step(const int64_t* table, int n_leaves, int64_t tiles, int nodes,
            const float* w, const float* eta, const float* refresh,
            float beta, float wd, int nesterov, int has_wd, int qg_form,
            float mu, float one_minus_mu, void* stream) {
  if (n_leaves <= 0 || tiles <= 0) return cudaSuccess;
  if (n_leaves > kMaxLeaves || nodes < 1 || nodes > kStepMaxNodes)
    return cudaErrorInvalidValue;
  StepGroup g{};
  for (int i = 0; i < n_leaves; ++i) {
    const int64_t* e = table + static_cast<int64_t>(i) * kStepFields;
    g.leaf[i] = {reinterpret_cast<const float*>(e[0]),
                 reinterpret_cast<const float*>(e[1]),
                 reinterpret_cast<const float*>(e[2]),
                 reinterpret_cast<float*>(e[3]),
                 reinterpret_cast<float*>(e[4]),
                 e[5], e[6], e[7]};
  }
  g.tiles = tiles;
  g.n = n_leaves;
  const Halfstep hs{eta, beta, wd, nesterov, has_wd};
  const QgBuffer qb{eta, refresh, mu, one_minus_mu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return qg_form ? launch_step_rows<true>(g, tiles, nodes, w, hs, qb, s)
                 : launch_step_rows<false>(g, tiles, nodes, w, hs, qb, s);
}

// The tile geometry the wrapper must lay out: columns a tile, leaves a
// launch, int64 fields a leaf, most nodes.
void qg_step_geometry(int64_t* out) {
  out[0] = kStepCols;
  out[1] = kMaxLeaves;
  out[2] = kStepFields;
  out[3] = kStepMaxNodes;
}

const char* qg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
