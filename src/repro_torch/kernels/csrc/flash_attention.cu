// Flash attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_bhsd` in
// src/repro/kernels/flash_attention.py (the pl.pallas_call at :129).
//
// What it computes: softmax(q k^T / sqrt(hd)) v with GQA (query head h reads
// KV head h / (H/KV) by index; KV heads are never repeated in memory), causal
// or not.  Online softmax keeps the running max m, denominator l and
// accumulator acc in float32, and p stays in float32 before P.V, as in the
// TPU kernel.  Inputs are float32 or bfloat16; the output is in q's dtype.
//
// Layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), o (B, Sq, H, hd), read and
// written through element strides for batch, sequence and head; the head
// dimension must be contiguous.  The ragged tail of either sequence is
// masked here, so any Sq and Sk work.  Causal masking needs Sq == Sk.
//
// Design.  One thread block per (query tile of BM rows, query head, batch).
// The TPU walks key blocks on a sequential grid axis and carries (m, l, acc)
// in VMEM scratch between grid steps; CUDA blocks run in no order, so here
// the key loop runs inside the block and (m, l, acc) stay in registers.
// Key tiles entirely in the causal future of the query tile are never
// loaded.  Q, K, V and the tile's P are staged in shared memory as float32.
// Each of the 128 threads owns 4 query rows x 8 key columns of the score
// tile and 4 rows x hd/8 columns of the accumulator, so the rescale by
// alpha needs no exchange; row max and row sum are reduced over the 8 lanes
// that share a row with warp shuffles.  A masked key contributes p = 0
// explicitly, so a row whose first tiles are fully masked (m still -1e30)
// never adds exp(0) = 1 per masked key.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor, 67 TFLOP/s float32 FMA,
// 3.35 TB/s, at its 700 W limit).  At the serving slice's shape (B=1, H=12,
// KV=2, hd=128, S=1024, causal, bf16) a call needs 4*H*hd*S(S+1)/2 = 3.2
// GFLOP and moves 7.3 MB of q/k/v/o: about 3.3 us at the bf16 tensor peak
// and 2.2 us at the memory rate, so it is bound by operations.  This kernel
// does all its arithmetic in float32 on the CUDA cores (no tensor cores),
// so it cannot go below about 48 us at that shape; tensor-core products
// (mma / wgmma, with TMA loads) are the way to the bound and are later work.
//
// C interface (ctypes): flash_attention_fwd returns a cudaError_t as int,
// the result of cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int NT = 128;       // threads per block: 16 row groups x 8 lanes
constexpr int RM = 4;         // query rows per thread
constexpr int CN = 8;         // key columns per thread (strided by 8)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BM * (HD + 1) + 2 * BN * (HD + 1) + BM * (BN + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int H, int KV, int Sq, int Sk,
                 int64_t qsb, int64_t qss, int64_t qsh,
                 int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh,
                 int64_t osb, int64_t oss, int64_t osh,
                 float scale, int causal) {
  static_assert(HD % CN == 0, "head dim must be a multiple of 8");
  constexpr int LD = HD + 1;      // padded row: conflict-free column reads
  constexpr int LP = BN + 1;
  constexpr int CD = HD / CN;     // accumulator columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;               // BM x LD
  float* Ks = Qs + BM * LD;       // BN x LD
  float* Vs = Ks + BN * LD;       // BN x LD
  float* Ps = Vs + BN * LD;       // BM x LP

  const int tid = threadIdx.x;
  const int ty = tid / CN;        // rows ty*RM .. ty*RM+RM-1
  const int tx = tid % CN;        // columns tx + CN*j
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < BM * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int qr = q0 + r;
    Qs[r * LD + d] = qr < Sq ? to_f(qb[qr * qss + d]) : 0.f;
  }

  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) {
    // last query row of this tile; keys after it are in the causal future
    const int last_q = min(q0 + BM, Sq) - 1;
    n_tiles = min(n_tiles, last_q / BN + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();              // readers of the previous tile are done
    for (int i = tid; i < BN * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const int kr = k0 + r;
      const bool ok = kr < Sk;
      Ks[r * LD + d] = ok ? to_f(kb[kr * kss + d]) : 0.f;
      Vs[r * LD + d] = ok ? to_f(vb[kr * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[RM], kc[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = Qs[(ty * RM + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kc[j] = Ks[(tx + CN * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qr = q0 + ty * RM + i;
      bool live[CN];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kcol = k0 + tx + CN * j;
        live[j] = kcol < Sk && (!causal || kcol <= qr);
        s[i][j] = live[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group8_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * RM + i) * LP + tx + CN * j] = p;
        rs += p;
      }
      rs = group8_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();              // P tile complete

    const int n_keys = min(BN, Sk - k0);
    for (int c = 0; c < n_keys; ++c) {
      float pa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pa[i] = Ps[(ty * RM + i) * LP + c];
#pragma unroll
      for (int cc = 0; cc < CD; ++cc) {
        const float vv = Vs[c * LD + tx + CN * cc];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][cc] = fmaf(pa[i], vv, acc[i][cc]);
      }
    }
  }

  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty * RM + i;
    if (qr < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CD; ++c)
        ob[qr * oss + tx + CN * c] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk,
                   const int64_t* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int H, int KV, int Sq, int Sk,
                        const int64_t* st, float scale, int causal,
                        cudaStream_t stream) {
  switch (hd) {
#define FA_CASE(D) \
    case D: return launch<T, D>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, stream);
    FA_CASE(8) FA_CASE(16) FA_CASE(32) FA_CASE(64) FA_CASE(80) FA_CASE(96)
    FA_CASE(128) FA_CASE(192) FA_CASE(256)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The head dims the kernel is built for; the wrapper checks against it.
int flash_attention_head_dims(int* out, int cap) {
  const int dims[] = {8, 16, 32, 64, 80, 96, 128, 192, 256};
  const int n = (int)(sizeof(dims) / sizeof(dims[0]));
  for (int i = 0; i < n && i < cap; ++i) out[i] = dims[i];
  return n;
}

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides
// (batch, seq, head) for q, k, v, o in that order.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int KV, int Sq, int Sk,
                        int hd, const int64_t* strides, float scale,
                        int causal, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, o, B, H, KV, Sq, Sk, strides, scale, causal, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, Sq, Sk, strides, scale, causal, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
