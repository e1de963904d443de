// Mamba2 SSD chunked scan for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_bhsp` in
// src/repro/kernels/ssd_scan.py (the pl.pallas_call at :122).
//
// What it computes, per (batch b, head h), chunk by chunk with the state h
// (hp x n, float32) carried from one chunk to the next:
//   cum[q] = sum_{j<=q} dt_j A_h                      (restarts each chunk)
//   y[q]   = sum_{k<=q} exp(cum[q]-cum[k]) (C_q.B_k) dt_k x_k
//            + exp(cum[q]) C_q . h_prev
//   h      = exp(cum[end]) h_prev + sum_k exp(cum[end]-cum[k]) dt_k x_k B_k^T
// B and C are shared across heads.  Inputs are float32 or bfloat16 (A is
// float32); all arithmetic is float32; y and the final h are float32.
//
// Layout: x (B, S, nh, hp), dt (B, S, nh), B/C (B, S, n) read through element
// strides (the last dim of x, B and C contiguous); y (B, S, nh, hp) and
// h_final (B, nh, hp, n) written contiguous.  Chunks start at 0 every
// Q = min(chunk, S) steps, as in the JAX wrapper.  The last chunk may be
// partial: steps past S are the JAX wrapper's dt = 0 padding, which leave
// the state unchanged, so the kernel simply stops at S (no pad copy).
//
// Design.  On the TPU the chunk axis of the grid runs in order and h stays
// in VMEM between grid steps.  CUDA blocks run in no order, so here one
// block owns (32 head-dim columns, head, batch) and loops over the chunks
// itself, with h (32 x n) in shared memory.  y[:, p] and h[p, :] depend
// only on column p of x, so splitting hp across blocks needs no exchange;
// each block recomputes C.B^T for its columns (at hp = 64, two blocks per
// head: 128 blocks for B = 1, nh = 64 on 132 SMs).  A whole 256-step
// chunk in float32 would not fit beside the state, so the chunk is tiled
// as the flash kernel tiles attention: query tiles of 64 rows, key tiles
// of 64 steps with k <= q only, no softmax.  The cumulative sum is taken
// per chunk (a warp scan), never over the whole sequence: cum reaches
// about -1500 within one chunk at A = -64, dt = 0.1, and one sum over S
// would make exp(cum_q - cum_k) a difference of far larger numbers.  For
// k > q, cum_q - cum_k is large and positive and exp overflows, so a
// masked weight is selected as 0, never multiplied by a mask.  Each of the
// 128 threads owns 4 query rows x 8 key columns of the score tile and
// 4 rows x 4 columns of y; the state update runs over 4 x 4 micro-tiles.
//
// Bound on an H100 SXM (67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s,
// at its 700 W limit).  At the serving shape (B=1, S=1024, nh=64, hp=64,
// n=64, chunk 256, float32) the function needs about 1.07 GFLOP (the step
// recurrence: two multiply-adds per step, head and state element) and
// moves about 35 MB (x and y dominate): about 16 us at the float32 rate and
// 11 us at the memory rate, so it is bound by operations.  The chunked form
// needs about 2.17 GFLOP with C.B^T taken once per chunk for all heads,
// which share B and C.  This kernel does every product on the CUDA cores in
// float32, recomputes C.B^T per head and column split (128 times per chunk
// at this shape, where once would do), and keeps one chunk's work serial per block; tensor-core
// products, C.B^T shared across heads, and the chunk-state plus
// state-passing split (so chunks run in parallel) are later work.
//
// C interface (ctypes): ssd_scan_fwd returns a cudaError_t as int, the
// result of cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;          // query steps per tile
constexpr int TK = 64;          // key steps per tile
constexpr int PT = 32;          // head-dim columns per block
constexpr int NT = 128;         // threads per block: 16 row groups x 8 lanes
constexpr int RM = 4;           // query rows per thread
constexpr int CN = 8;           // score columns per thread (strided by 8)
constexpr int PC = PT / CN;     // y columns per thread (strided by 8)
constexpr int MAX_STATE = 256;
constexpr int MAX_CHUNK = 4096;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Floats of dynamic shared memory for state size n (padded to n4) and
// chunk length Q.  At n = 256, Q = 4096: 222,336 bytes, under the 227 KB
// a block may use.
size_t smem_floats(int n4, int Q) {
  return (size_t)2 * Q + (size_t)(TQ + TK + PT) * (n4 + 1) +
         (size_t)TK * (PT + 1) + (size_t)TQ * (TK + 1);
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ hfin, int S, int nh, int hp, int n, int Q,
                int64_t xsb, int64_t xss, int64_t xsh,
                int64_t dsb, int64_t dss, int64_t dsh,
                int64_t bsb, int64_t bss, int64_t csb, int64_t css) {
  constexpr int LDX = PT + 1;     // padded rows: conflict-free column reads
  constexpr int LDW = TK + 1;
  const int n4 = (n + 3) & ~3;    // state size padded with zero columns
  const int LDN = n4 + 1;

  extern __shared__ float smem[];
  float* cum = smem;              // Q: dt*A, then its inclusive cumsum
  float* dts = cum + Q;           // Q
  float* Cs = dts + Q;            // TQ x LDN
  float* Bs = Cs + TQ * LDN;      // TK x LDN
  float* Hs = Bs + TK * LDN;      // PT x LDN: the carried state
  float* Xs = Hs + PT * LDN;      // TK x LDX
  float* Ws = Xs + TK * LDX;      // TQ x LDW: masked decay * scores * dt

  const int tid = threadIdx.x;
  const int ty = tid / CN;        // rows ty*RM .. ty*RM+RM-1
  const int tx = tid % CN;        // columns tx + CN*j
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int pw = min(PT, hp - p0);  // valid head-dim columns of this block
  const float Ah = A[h];

  const T* xb = x + b * xsb + h * xsh + p0;
  const T* db = dt + b * dsb + h * dsh;
  const T* bb = Bm + b * bsb;
  const T* cb = Cm + b * csb;

  for (int i = tid; i < PT * LDN; i += NT) Hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int Qv = min(Q, S - c0);  // valid steps of this chunk
    __syncthreads();                // the previous chunk is done with cum, dts
    for (int i = tid; i < Qv; i += NT) {
      const float d = to_f(db[(int64_t)(c0 + i) * dss]);
      dts[i] = d;
      cum[i] = d * Ah;
    }
    __syncthreads();
    if (tid < 32) {                 // inclusive cumsum: one warp, lane segments
      const int per = (Qv + 31) / 32;
      const int s0 = min(tid * per, Qv), s1 = min(s0 + per, Qv);
      float run = 0.f;
      for (int i = s0; i < s1; ++i) { run += cum[i]; cum[i] = run; }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      for (int i = s0; i < s1; ++i) cum[i] += excl;
    }
    __syncthreads();

    // ---- y for each query tile of the chunk ------------------------------
    for (int q0 = 0; q0 < Qv; q0 += TQ) {
      for (int i = tid; i < TQ * n4; i += NT) {
        const int r = i / n4, j = i % n4;
        const int t = q0 + r;
        Cs[r * LDN + j] = (t < Qv && j < n) ? to_f(cb[(int64_t)(c0 + t) * css + j]) : 0.f;
      }
      float acc[RM][PC];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[i][c] = 0.f;

      const int q_last = min(q0 + TQ, Qv) - 1;
      for (int k0 = 0; k0 <= q_last; k0 += TK) {   // key tiles with k <= q only
        __syncthreads();            // C tile written; readers of the last tile done
        for (int i = tid; i < TK * n4; i += NT) {
          const int r = i / n4, j = i % n4;
          const int t = k0 + r;
          Bs[r * LDN + j] = (t < Qv && j < n) ? to_f(bb[(int64_t)(c0 + t) * bss + j]) : 0.f;
        }
        for (int i = tid; i < TK * PT; i += NT) {
          const int r = i / PT, c = i % PT;
          const int t = k0 + r;
          Xs[r * LDX + c] = (t < Qv && c < pw) ? to_f(xb[(int64_t)(c0 + t) * xss + c]) : 0.f;
        }
        __syncthreads();

        float s[RM][CN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < n4; ++d) {
          float ca[RM], bc[CN];
#pragma unroll
          for (int i = 0; i < RM; ++i) ca[i] = Cs[(ty * RM + i) * LDN + d];
#pragma unroll
          for (int j = 0; j < CN; ++j) bc[j] = Bs[(tx + CN * j) * LDN + d];
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j) s[i][j] = fmaf(ca[i], bc[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int q = q0 + ty * RM + i;
          const float cq = q < Qv ? cum[q] : 0.f;
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            const int k = k0 + tx + CN * j;
            // k <= q < Qv: a live pair; otherwise select 0 (exp would overflow)
            Ws[(ty * RM + i) * LDW + tx + CN * j] =
                (q < Qv && k <= q) ? expf(cq - cum[k]) * s[i][j] * dts[k] : 0.f;
          }
        }
        __syncthreads();            // W tile complete

        const int nk = min(TK, Qv - k0);
        for (int kk = 0; kk < nk; ++kk) {
          float wa[RM];
#pragma unroll
          for (int i = 0; i < RM; ++i) wa[i] = Ws[(ty * RM + i) * LDW + kk];
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const float xv = Xs[kk * LDX + tx + CN * c];
#pragma unroll
            for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(wa[i], xv, acc[i][c]);
          }
        }
      }

      // inter-chunk term: exp(cum[q]) * C_q . h_prev (h is not updated yet)
      float ch[RM][PC];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < PC; ++c) ch[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < n4; ++d) {
        float ca[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) ca[i] = Cs[(ty * RM + i) * LDN + d];
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const float hv = Hs[(tx + CN * c) * LDN + d];
#pragma unroll
          for (int i = 0; i < RM; ++i) ch[i][c] = fmaf(ca[i], hv, ch[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int q = q0 + ty * RM + i;
        if (q < Qv) {
          const float e = expf(cum[q]);
          float* yr = y + (((int64_t)b * S + c0 + q) * nh + h) * hp + p0;
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const int p = tx + CN * c;
            if (p < pw) yr[p] = acc[i][c] + e * ch[i][c];
          }
        }
      }
      __syncthreads();              // readers of Cs and Hs are done
    }

    // ---- state update: h = exp(cum_end) h + sum_k w_k x_k B_k^T ------------
    const float cend = cum[Qv - 1];
    const float dec = expf(cend);
    for (int i = tid; i < PT * LDN; i += NT) Hs[i] *= dec;
    for (int k0 = 0; k0 < Qv; k0 += TK) {
      __syncthreads();              // Hs scaled; readers of the last tile done
      for (int i = tid; i < TK * n4; i += NT) {
        const int r = i / n4, j = i % n4;
        const int t = k0 + r;
        Bs[r * LDN + j] = (t < Qv && j < n) ? to_f(bb[(int64_t)(c0 + t) * bss + j]) : 0.f;
      }
      for (int i = tid; i < TK * PT; i += NT) {
        const int r = i / PT, c = i % PT;
        const int t = k0 + r;
        float v = 0.f;
        if (t < Qv && c < pw)
          v = to_f(xb[(int64_t)(c0 + t) * xss + c]) * (expf(cend - cum[t]) * dts[t]);
        Xs[r * LDX + c] = v;
      }
      __syncthreads();
      const int nk = min(TK, Qv - k0);
      const int tiles = (PT / 4) * (n4 / 4);
      for (int mt = tid; mt < tiles; mt += NT) {
        const int pg = mt % (PT / 4), ng = mt / (PT / 4);
        float a[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) a[u][w] = 0.f;
        for (int kk = 0; kk < nk; ++kk) {
          float xv[4], bv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) xv[u] = Xs[kk * LDX + pg * 4 + u];
#pragma unroll
          for (int w = 0; w < 4; ++w) bv[w] = Bs[kk * LDN + ng * 4 + w];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int w = 0; w < 4; ++w) a[u][w] = fmaf(xv[u], bv[w], a[u][w]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) Hs[(pg * 4 + u) * LDN + ng * 4 + w] += a[u][w];
      }
    }
  }
  __syncthreads();

  float* hb = hfin + ((int64_t)b * nh + h) * hp * n;
  for (int i = tid; i < pw * n; i += NT) {
    const int p = i / n, j = i % n;
    hb[(int64_t)(p0 + p) * n + j] = Hs[p * LDN + j];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* hfin, int B, int S, int nh,
                   int hp, int n, int Q, const int64_t* st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats((n + 3) & ~3, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((hp + PT - 1) / PT, nh, B);
  ssd_scan_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(hfin), S, nh, hp, n, Q,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The largest state size n and chunk length the kernel takes; the wrapper
// checks against them.
void ssd_scan_limits(int* max_state, int* max_chunk) {
  *max_state = MAX_STATE;
  *max_chunk = MAX_CHUNK;
}

// dtype (of x, dt, B, C): 0 = float32, 1 = bfloat16; A is float32.
// strides: 10 element strides: x (batch, seq, head), dt (batch, seq, head),
// B (batch, seq), C (batch, seq).
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* hfin, int dtype, int B, int S,
                 int nh, int hp, int n, int chunk, const int64_t* strides,
                 void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || hp <= 0 || n <= 0 || n > MAX_STATE ||
      chunk <= 0 || B > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  const int Q = chunk < S ? chunk : S;
  if (Q > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, dt, A, Bm, Cm, y, hfin, B, S, nh, hp, n, Q, strides, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, hfin, B, S, nh, hp, n, Q, strides, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
