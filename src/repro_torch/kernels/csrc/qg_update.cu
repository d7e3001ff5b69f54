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
// Bound on this card: device-memory bandwidth.  Each does a handful of
// flops per element and moves, per element, 12 bytes in and 4 out
// (16 bytes); fused_halfstep with emit_m writes a second output (20
// bytes).  What the design does about it: one pass, each input read once
// and each output written once, nothing else leaves the SM -- coefficients
// ride as launch arguments and the traced lr / refresh gate are read once
// per thread from device memory.
//
// Design (simple and right first; speed is later work):
//   * a 1-D grid-stride loop with 64-bit indices; the ragged tail is
//     masked, so no padding is needed whatever the packed length;
//   * float4 loads and stores only when every pointer is 16-byte aligned,
//     else the scalar loop;
//   * lr and refresh are fp32 [1] device operands, never host values, so a
//     step holds no host sync and stays capturable in a CUDA graph;
//   * every product, sum and quotient is an explicit round-to-nearest
//     intrinsic in the Pallas body's expression order: no FMA contraction
//     (the build also passes -fmad=false), so the kernels round as the
//     plain PyTorch versions in repro_torch/kernels/ref.py do;
//   * launched on the caller's stream; no sync and no allocation inside.
//     Each launcher returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 threads = an SM's 2048

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

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <class Op>
int launch3(const float* a, const float* b, const float* c, float* o0,
            float* o1, int64_t n, Op op, void* stream) {
  if (n <= 0) return cudaSuccess;
  const bool vec = aligned16(a) && aligned16(b) && aligned16(c) &&
                   aligned16(o0) && aligned16(o1);
  const int64_t work = vec ? (n + 3) / 4 : n;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
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

const char* qg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
