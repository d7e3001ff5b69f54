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

#include "elementwise.cuh"

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
