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
// float32), converted on load; all arithmetic is float32; y and the final
// h are float32.
//
// Layout: x (B, S, nh, hp), dt (B, S, nh), B/C (B, S, n) read through element
// strides (the last dim of x, B and C contiguous); y (B, S, nh, hp) and
// h_final (B, nh, hp, n) written contiguous.  Chunks start at 0 every
// Q = min(chunk, S) steps, as in the JAX wrapper.  The last chunk may be
// partial: steps past S are the JAX wrapper's dt = 0 padding, which leave
// the state unchanged, so every pass simply stops at S (no pad copy).
//
// Design.  The TPU kernel walks the chunks in order with h in VMEM.  Here
// the work is split into five passes, the GPU split the TPU kernel's
// docstring names and Mamba2's own GPU implementation uses, so that all
// chunks run in parallel and only a small state pass is sequential:
//   (a) cumsum    cum = cumsum(dt A) per (batch, chunk, head), one warp
//                 each: per-lane sequential runs plus a warp scan, exactly
//                 the arithmetic of the first port, so every later pass
//                 reads the same bits.            -> cum (B, nc, nh, Q)
//   (b) C.B^T     once per (batch, chunk) for all heads, which share B and
//                 C: the causal lower triangle in 64 x 64 tiles, stored
//                 key-major; the tiles of the first key column also store
//                 C transposed for pass (e).       -> cbt (B, nc, Q, Q),
//                                                     ct (B, nc, n, Q)
//   (c) states    states[b,c,h] = sum_k exp(cum_end - cum_k) dt_k B_k x_k^T
//                 in parallel over (batch, chunk, head, n-tile, p-tile).
//                                                  -> st (B, nc, nh, n, hp)
//   (d) passing   sequential over the chunks only, one thread per state
//                 element: the state entering each chunk, and h_final.
//                                                  -> hin (B, nc, nh, n, hp)
//   (e) output    y = sum_{k<=q} exp(cum_q - cum_k) CB[q,k] dt_k x_k
//                     + exp(cum_q) C_q . h_in, in parallel over (query
//                 tile, p-tile, chunk, head, batch), the query tiles with
//                 the most key steps issued first.
// The scratch is one float32 buffer the caller allocates
// (ssd_scan_scratch_floats); each pass is launched on the caller's stream
// and checked with cudaGetLastError().  A masked weight (k > q, where
// exp(cum_q - cum_k) would overflow) is selected as 0, never multiplied by
// a mask.  The products of (b), (c) and (e) share one shape: a 64 x 64
// float32 output tile per 256-thread block, each thread a 4 x 4 micro-tile
// fed by two float4 shared-memory reads per step, operands staged in
// 32-step slices, stored step-major so that every staging store and every
// float4 read is free of bank conflicts.  C.B^T and the intra-chunk sum
// accumulate in the same order as the first port's kernel (fmaf over the
// state index, then over the key index from 0), so only the state's
// summation order differs from it.
//
// Bound on an H100 SXM (67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s,
// at its 700 W limit).  At zamba2-1.2b's prefill (B=1, S=1024, nh=64,
// hp=64, n=64, chunk 256, float32) the function needs at least 1.07 GFLOP
// (the step recurrence: two multiply-adds per step, head and state element)
// and moves 35 MB: 16 us at the float32 rate, 11 us at the memory rate, so
// it is bound by operations.  The chunked form computes 2.17 GFLOP (C.B^T
// once per chunk) and moves about 10 MB of scratch besides.  Every product
// here runs on the CUDA cores in float32; tensor-core products (3xTF32, or
// TF32 where the tolerance allows) are left for later.
//
// C interface (ctypes): ssd_scan_fwd returns a cudaError_t as int, the
// first failure among the passes it launched, or 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_STATE = 256;
constexpr int MAX_CHUNK = 4096;
constexpr int TM = 64;          // output tile of the product passes: TM x TM
constexpr int TS = 32;          // reduction steps staged per slice
constexpr int NT = 256;         // threads of the product passes: 16 x 16, 4 x 4 each
constexpr int SPT = TS * TM / NT;  // staged elements per thread and operand
constexpr int PASS_NT = 256;    // threads of the state pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// acc[i][j] += sum_s As[s][4 ty + i] * Bs[s][4 tx + j] over TS steps;
// As, Bs are TS x TM, step-major.
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], const float* As,
                                         const float* Bs, int ty, int tx) {
#pragma unroll
  for (int s = 0; s < TS; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(As + s * TM + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(Bs + s * TM + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Offsets (floats) of the scratch buffers, each rounded up to 4 floats.
struct Scratch {
  int64_t cum, cbt, ct, st, hin, total;
  Scratch(int B, int nc, int nh, int hp, int n, int Q) {
    auto up = [](int64_t v) { return (v + 3) & ~(int64_t)3; };
    cum = 0;
    cbt = cum + up((int64_t)B * nc * nh * Q);
    ct = cbt + up((int64_t)B * nc * Q * Q);
    st = ct + up((int64_t)B * nc * n * Q);
    hin = st + up((int64_t)B * nc * nh * n * hp);
    total = hin + up((int64_t)B * nc * nh * n * hp);
  }
};

// (a) grid (nc, nh, B), 32 threads; Q floats of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(32)
ssd_cumsum(const T* __restrict__ dt, const float* __restrict__ A,
           float* __restrict__ cum, int S, int nh, int Q,
           int64_t dsb, int64_t dss, int64_t dsh) {
  extern __shared__ float cs[];
  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, Qv = min(Q, S - c0);
  const float Ah = A[h];
  const T* db = dt + b * dsb + h * dsh;
  for (int i = tid; i < Qv; i += 32) cs[i] = to_f(db[(int64_t)(c0 + i) * dss]) * Ah;
  __syncwarp();
  // inclusive cumsum: lane segments, then a scan of the segment sums
  const int per = (Qv + 31) / 32;
  const int s0 = min(tid * per, Qv), s1 = min(s0 + per, Qv);
  float run = 0.f;
  for (int i = s0; i < s1; ++i) { run += cs[i]; cs[i] = run; }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (tid >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (tid == 0) excl = 0.f;
  for (int i = s0; i < s1; ++i) cs[i] += excl;
  __syncwarp();
  float* out = cum + (((int64_t)b * gridDim.x + c) * nh + h) * Q;
  for (int i = tid; i < Qv; i += 32) out[i] = cs[i];
}

// (b) grid (nt * nt * nc, 1, B) with nt = cdiv(Q, TM); tiles above the
// diagonal return at once.  cbt[k][q] = B_k . C_q for k <= q (tile-wise).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_cb(const T* __restrict__ Bm, const T* __restrict__ Cm,
       float* __restrict__ cbt, float* __restrict__ ct, int S, int n, int Q,
       int nc, int64_t bsb, int64_t bss, int64_t csb, int64_t css) {
  __shared__ __align__(16) float Bt[TS * TM];
  __shared__ __align__(16) float Ct[TS * TM];
  const int nt = cdiv(Q, TM);
  const int tile = blockIdx.x % (nt * nt), c = blockIdx.x / (nt * nt);
  const int qt = tile / nt, kt = tile % nt;
  const int b = blockIdx.z;
  const int c0 = c * Q, Qv = min(Q, S - c0);
  const int q0 = qt * TM, k0 = kt * TM;
  if (kt > qt || q0 >= Qv) return;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // staging: each thread keeps one row r (lanes run along the rows) and
  // steps s0, s0 + NT/TM, ... of the slice
  const int r = tid % TM, s0 = tid / TM;
  const bool k_live = k0 + r < Qv, q_live = q0 + r < Qv;
  const T* bb = Bm + b * bsb + (int64_t)(c0 + k0 + r) * bss;
  const T* cb = Cm + b * csb + (int64_t)(c0 + q0 + r) * css;
  float* ctc = ct + ((int64_t)b * nc + c) * n * Q + q0 + r;

  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < n; n0 += TS) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      const int s = s0 + u * (NT / TM), nn = n0 + s;
      Bt[s * TM + r] = (k_live && nn < n) ? to_f(bb[nn]) : 0.f;
      Ct[s * TM + r] = (q_live && nn < n) ? to_f(cb[nn]) : 0.f;
    }
    __syncthreads();
    if (kt == 0 && q_live)                    // C^T of this chunk, for pass (e)
#pragma unroll
      for (int u = 0; u < SPT; ++u) {
        const int s = s0 + u * (NT / TM), nn = n0 + s;
        if (nn < n) ctc[(int64_t)nn * Q] = Ct[s * TM + r];
      }
    tile_fma(acc, Bt, Ct, ty, tx);
  }
  float* out = cbt + ((int64_t)b * nc + c) * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + 4 * ty + i;
    if (kk >= Qv) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qq = q0 + 4 * tx + j;
      if (qq < Qv) out[(int64_t)kk * Q + qq] = acc[i][j];
    }
  }
}

// (c) grid (cdiv(hp, TM) * cdiv(n, TM) * nc, nh, B).
// st[n][p] = sum_k B_k[n] * x_k[p] * exp(cum_end - cum_k) dt_k
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_states(const T* __restrict__ x, const T* __restrict__ dt,
           const T* __restrict__ Bm, const float* __restrict__ cum,
           float* __restrict__ st, int S, int nh, int hp, int n, int Q, int nc,
           int64_t xsb, int64_t xss, int64_t xsh, int64_t dsb, int64_t dss,
           int64_t dsh, int64_t bsb, int64_t bss) {
  __shared__ __align__(16) float Bs[TS * TM];
  __shared__ __align__(16) float Xs[TS * TM];
  __shared__ float w[TS];
  const int npt = cdiv(hp, TM), nnt = cdiv(n, TM);
  const int tile = blockIdx.x % (npt * nnt), c = blockIdx.x / (npt * nnt);
  const int p0 = (tile % npt) * TM, n0 = (tile / npt) * TM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, Qv = min(Q, S - c0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r = tid % TM, s0 = tid / TM;    // staging row and first step
  const bool n_live = n0 + r < n, p_live = p0 + r < hp;
  const T* xb = x + b * xsb + h * xsh + (int64_t)c0 * xss + p0 + r;
  const T* db = dt + b * dsb + h * dsh + (int64_t)c0 * dss;
  const T* bb = Bm + b * bsb + (int64_t)c0 * bss + n0 + r;
  const float* cumc = cum + (((int64_t)b * nc + c) * nh + h) * Q;
  const float cend = cumc[Qv - 1];

  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < Qv; k0 += TS) {
    __syncthreads();
    if (tid < TS) {
      const int t = k0 + tid;
      w[tid] = t < Qv ? expf(cend - cumc[t]) * to_f(db[(int64_t)t * dss]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      const int s = s0 + u * (NT / TM), t = k0 + s;
      const bool live = t < Qv;
      Bs[s * TM + r] = (live && n_live) ? to_f(bb[(int64_t)t * bss]) : 0.f;
      Xs[s * TM + r] = (live && p_live) ? to_f(xb[(int64_t)t * xss]) * w[s] : 0.f;
    }
    __syncthreads();
    tile_fma(acc, Bs, Xs, ty, tx);
  }
  float* out = st + (((int64_t)b * nc + c) * nh + h) * n * hp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int nn = n0 + 4 * ty + i;
    if (nn >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = p0 + 4 * tx + j;
      if (pp < hp) out[(int64_t)nn * hp + pp] = acc[i][j];
    }
  }
}

// (d) one thread per (b, h, n, p): h_in[c] = h; h = exp(cum_end[c]) h + st[c].
__global__ void __launch_bounds__(PASS_NT)
ssd_passing(const float* __restrict__ cum, const float* __restrict__ st,
            float* __restrict__ hin, float* __restrict__ hfin, int B, int S,
            int nh, int hp, int n, int Q, int nc) {
  const int64_t idx = (int64_t)blockIdx.x * PASS_NT + threadIdx.x;
  const int64_t per_head = (int64_t)n * hp;
  if (idx >= (int64_t)B * nh * per_head) return;
  const int64_t e = idx % per_head;              // nn * hp + pp
  const int h = (int)((idx / per_head) % nh);
  const int b = (int)(idx / (per_head * nh));
  float hc = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int Qv = min(Q, S - c * Q);
    const int64_t bch = ((int64_t)b * nc + c) * nh + h;
    hin[bch * per_head + e] = hc;
    hc = expf(cum[bch * Q + Qv - 1]) * hc + st[bch * per_head + e];
  }
  const int nn = (int)(e / hp), pp = (int)(e % hp);
  hfin[(((int64_t)b * nh + h) * hp + pp) * n + nn] = hc;
}

// (e) grid (cdiv(Q, TM) * cdiv(hp, TM) * nc, nh, B).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_output(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ cum, const float* __restrict__ cbt,
           const float* __restrict__ ct, const float* __restrict__ hin,
           float* __restrict__ y, int S, int nh, int hp, int n, int Q, int nc,
           int64_t xsb, int64_t xss, int64_t xsh, int64_t dsb, int64_t dss,
           int64_t dsh) {
  __shared__ __align__(16) float Ws[TS * TM];
  __shared__ __align__(16) float Xs[TS * TM];
  const int nqt = cdiv(Q, TM), npt = cdiv(hp, TM);
  const int tile = blockIdx.x % (nqt * npt), c = blockIdx.x / (nqt * npt);
  const int q0 = (nqt - 1 - tile % nqt) * TM;   // most key steps first
  const int p0 = (tile / nqt) * TM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, Qv = min(Q, S - c0);
  if (q0 >= Qv) return;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // staging: each thread keeps one query row / head-dim column r and steps
  // s0, s0 + NT/TM, ... of the slice
  const int r = tid % TM, s0 = tid / TM;
  const int qq = q0 + r;
  const bool q_live = qq < Qv, p_live = p0 + r < hp;
  const T* xb = x + b * xsb + h * xsh + (int64_t)c0 * xss + p0 + r;
  const T* db = dt + b * dsb + h * dsh + (int64_t)c0 * dss;
  const int64_t bc = (int64_t)b * nc + c;
  const float* cumc = cum + (bc * nh + h) * Q;
  const float* cbc = cbt + bc * Q * Q + qq;
  const float cq = q_live ? cumc[qq] : 0.f;

  // intra-chunk: sum over k <= q of exp(cum_q - cum_k) CB[q,k] dt_k x_k
  float acc[4][4];
  zero(acc);
  const int q_last = min(q0 + TM, Qv) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += TS) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      const int s = s0 + u * (NT / TM), t = k0 + s;
      // k <= q < Qv: a live pair; otherwise select 0 (exp would overflow)
      Ws[s * TM + r] = (q_live && t <= qq)
                           ? expf(cq - cumc[t]) * cbc[(int64_t)t * Q] *
                                 to_f(db[(int64_t)t * dss])
                           : 0.f;
      Xs[s * TM + r] = (t < Qv && p_live) ? to_f(xb[(int64_t)t * xss]) : 0.f;
    }
    __syncthreads();
    tile_fma(acc, Ws, Xs, ty, tx);
  }

  // inter-chunk: exp(cum_q) C_q . h_in (zero for the first chunk)
  float ch[4][4];
  zero(ch);
  if (c > 0) {
    const float* ctc = ct + bc * n * Q + qq;
    const float* hc = hin + (bc * nh + h) * n * hp + p0 + r;
    for (int n0 = 0; n0 < n; n0 += TS) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < SPT; ++u) {
        const int s = s0 + u * (NT / TM), nn = n0 + s;
        Ws[s * TM + r] = (nn < n && q_live) ? ctc[(int64_t)nn * Q] : 0.f;
        Xs[s * TM + r] = (nn < n && p_live) ? hc[(int64_t)nn * hp] : 0.f;
      }
      __syncthreads();
      tile_fma(ch, Ws, Xs, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qo = q0 + 4 * ty + i;
    if (qo >= Qv) continue;
    const float e = expf(cumc[qo]);
    float* yr = y + (((int64_t)b * S + c0 + qo) * nh + h) * hp;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = p0 + 4 * tx + j;
      if (pp < hp) yr[pp] = acc[i][j] + e * ch[i][j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x_, const void* dt_, const float* A,
                   const void* Bm_, const void* Cm_, float* y, float* hfin,
                   float* scratch, int B, int S, int nh, int hp, int n, int Q,
                   int passes, const int64_t* st, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* dt = static_cast<const T*>(dt_);
  const T* Bm = static_cast<const T*>(Bm_);
  const T* Cm = static_cast<const T*>(Cm_);
  const int nc = cdiv(S, Q);
  const Scratch sc(B, nc, nh, hp, n, Q);
  float* cum = scratch + sc.cum;
  float* cbt = scratch + sc.cbt;
  float* ct = scratch + sc.ct;
  float* sst = scratch + sc.st;
  float* hin = scratch + sc.hin;
  cudaError_t err;
  if (passes & 1) {
    ssd_cumsum<T><<<dim3(nc, nh, B), 32, Q * sizeof(float), stream>>>(
        dt, A, cum, S, nh, Q, st[3], st[4], st[5]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (passes & 2) {
    const int nt = cdiv(Q, TM);
    ssd_cb<T><<<dim3(nt * nt * nc, 1, B), NT, 0, stream>>>(
        Bm, Cm, cbt, ct, S, n, Q, nc, st[6], st[7], st[8], st[9]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (passes & 4) {
    ssd_states<T><<<dim3(cdiv(hp, TM) * cdiv(n, TM) * nc, nh, B), NT, 0, stream>>>(
        x, dt, Bm, cum, sst, S, nh, hp, n, Q, nc, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (passes & 8) {
    const int64_t total = (int64_t)B * nh * n * hp;
    ssd_passing<<<(unsigned)((total + PASS_NT - 1) / PASS_NT), PASS_NT, 0, stream>>>(
        cum, sst, hin, hfin, B, S, nh, hp, n, Q, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (passes & 16) {
    ssd_output<T><<<dim3(cdiv(Q, TM) * cdiv(hp, TM) * nc, nh, B), NT, 0, stream>>>(
        x, dt, cum, cbt, ct, hin, y, S, nh, hp, n, Q, nc, st[0], st[1], st[2],
        st[3], st[4], st[5]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool valid(int B, int S, int nh, int hp, int n, int chunk) {
  if (B <= 0 || S <= 0 || nh <= 0 || hp <= 0 || n <= 0 || n > MAX_STATE ||
      chunk <= 0 || B > 65535 || nh > 65535)
    return false;
  const int Q = chunk < S ? chunk : S;
  const int nc = cdiv(S, Q);
  const int64_t tiles = (int64_t)cdiv(Q, TM) * cdiv(Q, TM);
  return Q <= MAX_CHUNK && tiles * nc < (1LL << 31) &&
         (int64_t)cdiv(hp, TM) * cdiv(n, TM) * nc < (1LL << 31);
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

// Floats of scratch that ssd_scan_fwd needs for these sizes; -1 if it does
// not take them.
int64_t ssd_scan_scratch_floats(int B, int S, int nh, int hp, int n, int chunk) {
  if (!valid(B, S, nh, hp, n, chunk)) return -1;
  const int Q = chunk < S ? chunk : S;
  return Scratch(B, cdiv(S, Q), nh, hp, n, Q).total;
}

// dtype (of x, dt, B, C): 0 = float32, 1 = bfloat16; A is float32.
// scratch: ssd_scan_scratch_floats(...) floats.  passes: a bit mask of the
// passes to launch, (a) cumsum = 1, (b) C.B^T = 2, (c) states = 4,
// (d) state passing = 8, (e) output = 16; 31 runs the scan.  Each pass
// reads what the earlier ones wrote, so one alone is only meaningful after
// a full run on the same buffers (to time it).
// strides: 10 element strides: x (batch, seq, head), dt (batch, seq, head),
// B (batch, seq), C (batch, seq).
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* hfin, void* scratch, int dtype,
                 int B, int S, int nh, int hp, int n, int chunk, int passes,
                 const int64_t* strides, void* stream) {
  if (!valid(B, S, nh, hp, n, chunk)) return (int)cudaErrorInvalidValue;
  const int Q = chunk < S ? chunk : S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(hfin);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, dt, Af, Bm, Cm, yf, hf, sc, B, S, nh, hp, n, Q,
                        passes, strides, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, dt, Af, Bm, Cm, yf, hf, sc, B, S, nh, hp,
                                n, Q, passes, strides, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
