// Flash attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_bhsd` in
// src/repro/kernels/flash_attention.py (the pl.pallas_call at :129).
//
// What it computes: softmax(q k^T / sqrt(hd)) v with GQA (query head h reads
// KV head h / (H/KV) by index; KV heads are never repeated in memory), causal
// or not.  Online softmax keeps the running max m, denominator l and
// accumulator acc in float32.  Inputs are float32 or bfloat16; the output is
// in q's dtype.
//
// Layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), o (B, Sq, H, hd), read and
// written through element strides for batch, sequence and head; the head
// dimension must be contiguous.  The ragged tail of either sequence is
// masked here, so any Sq and Sk work.  Causal masking reads query row i as
// position q_offset + i (key j is live where j <= q_offset + i), and needs
// q_offset >= 0 and q_offset + Sq <= Sk: q_offset 0 and Sq == Sk is the
// square causal product; a positive q_offset is a slice of later query rows
// against all keys (one shard of a sequence-sharded q).
//
// Two routes, picked by dtype in flash_attention_fwd (a declared choice, not
// a fallback: both are kernels of this file and nothing is caught):
//
// bfloat16 (the serving dtype): tensor cores, after FlashAttention-2.
//   One block of 4 warps per (query head, batch, query tile of BM = 64
//   rows); each warp owns 16 query rows and walks key tiles of BN = 64.
//   Q, K and V stay bfloat16 in shared memory, each row padded by 8
//   elements so that ldmatrix reads are free of bank conflicts (a row of
//   hd + 8 elements is an odd number of 16-byte units).  S = Q K^T and
//   O += P V run on mma.sync.m16n8k16 (bf16 in, float32 accumulate); V is
//   read with ldmatrix.trans.  K and V tiles are double-buffered with
//   16-byte cp.async, so the next tile's load overlaps this tile's products
//   (views whose rows are not 16-byte aligned are loaded synchronously into
//   the same buffers).  At hd 128 that is 87,040 bytes of shared memory, so
//   two blocks share an SM.  The online softmax stays in registers: m and l
//   are float32 per row, the row max is reduced over the 4 lanes that share
//   a row with __shfl_xor_sync, and l is summed per lane and reduced once at
//   the end.  P is rounded to bfloat16 in registers and used directly as
//   the A operand of P V (the score fragment of two 8-key tiles is the A
//   fragment of one 16-key step), with no round trip through shared memory.
//   Masks apply only on the tiles that need them (the causal diagonal and
//   the ragged tail); a masked score is -inf and gives p = 0 exactly, and a
//   row that has seen only masked keys uses 0 as its max, so it adds
//   nothing.  Key tiles wholly in the causal future are never loaded, and
//   the query tiles with the most key tiles are issued first (the tile index
//   runs backwards on the slowest grid axis), so long causal rows do not
//   form the tail of the wave.  Head dims under 16 are zero-padded to 16 in
//   shared memory.  The output is staged through the warp's own Q rows and
//   written 16 bytes a lane.
//
// float32: the CUDA-core kernel of the first port.  TF32 tensor cores would
//   miss the float32 tolerance (2e-5), so float32 keeps scalar fmaf: one
//   4-warp block per (query tile of 64 rows, head, batch), Q, K, V and the
//   tile's P staged in shared memory as float32, each thread owning 4 query
//   rows x 8 key columns of the score tile; a masked key contributes p = 0
//   explicitly.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor, 67 TFLOP/s float32 FMA,
// 3.35 TB/s, at its 700 W limit).  At qwen2-1.5b's prefill (B=1, H=12,
// KV=2, hd=128, S=1024, causal, bf16) a call needs 4*H*hd*S(S+1)/2 = 3.2
// GFLOP and moves 7.3 MB: 3.3 us at the bf16 tensor peak, 2.2 us at the
// memory rate, so it is bound by operations.  At zamba2-1.2b's shared block
// (H = KV = 32, hd 64) it is bound by bytes (16.8 MB, 5.0 us).  Left for
// later: wgmma and TMA loads (mma.sync reaches only part of the tensor
// rate), and one K/V load shared by the query heads of a GQA group (each
// block loads its KV head's tiles itself, 6 times over at qwen2's 12:2).
//
// C interface (ctypes): flash_attention_fwd returns a cudaError_t as int,
// the result of cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// float32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int NT = 128;       // threads per block (4 warps)
constexpr int RM = 4;         // float32 route: query rows per thread
constexpr int CN = 8;         // float32 route: key columns per thread (strided by 8)
constexpr float NEG_INF = -1e30f;

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
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (size_t)(BM * (HD + 1) + 2 * BN * (HD + 1) + BM * (BN + 1));
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              int H, int KV, int Sq, int Sk,
              int64_t qsb, int64_t qss, int64_t qsh,
              int64_t ksb, int64_t kss, int64_t ksh,
              int64_t vsb, int64_t vss, int64_t vsh,
              int64_t osb, int64_t oss, int64_t osh,
              float scale, int causal, int q_offset) {
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

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < BM * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int qr = q0 + r;
    Qs[r * LD + d] = qr < Sq ? qb[qr * qss + d] : 0.f;
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
    const int last_q = q_offset + min(q0 + BM, Sq) - 1;
    n_tiles = min(n_tiles, last_q / BN + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();              // readers of the previous tile are done
    for (int i = tid; i < BN * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const int kr = k0 + r;
      const bool ok = kr < Sk;
      Ks[r * LD + d] = ok ? kb[kr * kss + d] : 0.f;
      Vs[r * LD + d] = ok ? vb[kr * vss + d] : 0.f;
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
      const int qr = q_offset + q0 + ty * RM + i;   // the row's position
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

  float* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty * RM + i;
    if (qr < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CD; ++c) ob[qr * oss + tx + CN * c] = acc[i][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores (mma.sync), cp.async double buffering
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
struct TcDims {
  static constexpr int HDP = HD < 16 ? 16 : HD;  // head dim in shared memory
  static constexpr int LDS = HDP + 8;            // row stride, elements
  static constexpr int CPR = HDP / 8;            // 16-byte units per row
};

template <int HD>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (size_t)(BM + 4 * BN) * TcDims<HD>::LDS;
}

// Rows [r0, r0 + ROWS) of a (rows, HD) bf16 matrix with row stride ss into
// dst (ROWS x LDS).  Rows at or past n_rows and columns at or past HD are
// zero.  aligned: every row starts on 16 bytes (cp.async); otherwise the
// elements are loaded synchronously.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t ss,
                                          int r0, int n_rows, bool aligned) {
  constexpr int LDS = TcDims<HD>::LDS, CPR = TcDims<HD>::CPR;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < n_rows && c * 8 < HD;
    const bf16* s = src + (ok ? (int64_t)(r0 + r) * ss + c * 8 : 0);
    bf16* d = dst + r * LDS + c * 8;
    if (aligned) {
      cp_async16(smem_addr(d), s, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = ok ? s[e] : __float2bfloat16(0.f);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_bf16_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  int H, int KV, int Sq, int Sk,
                  int64_t qsb, int64_t qss, int64_t qsh,
                  int64_t ksb, int64_t kss, int64_t ksh,
                  int64_t vsb, int64_t vss, int64_t vsh,
                  int64_t osb, int64_t oss, int64_t osh,
                  float scale_log2, int causal, int q_offset, int aligned) {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
  constexpr int HDP = TcDims<HD>::HDP, LDS = TcDims<HD>::LDS;
  constexpr int NKT = BN / 8;     // 8-key column tiles of S
  constexpr int NDT = HDP / 8;    // 8-wide column tiles of O
  const float NEG = -__int_as_float(0x7f800000);   // -inf

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);    // BM x LDS
  bf16* Ks = Qs + BM * LDS;                         // 2 x BN x LDS
  bf16* Vs = Ks + 2 * BN * LDS;                     // 2 x BN x LDS

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // fragment row group, lane in quad
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // most key tiles first
  const int kvh = h / (H / KV);
  const int row_lo = q0 + warp * 16 + g;    // query row of c[0], c[1]; +8: c[2], c[3]

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + kvh * ksh;
  const bf16* vb = v + b * vsb + kvh * vsh;

  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q_offset + min(q0 + BM, Sq) - 1) / BN + 1);

  load_tile<HD, BM>(Qs, qb, qss, q0, Sq, aligned);
  load_tile<HD, BN>(Ks, kb, kss, 0, Sk, aligned);
  load_tile<HD, BN>(Vs, vb, vss, 0, Sk, aligned);
  cp_async_commit();

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // per-lane ldmatrix offsets (elements): A of Q, B of K, B of V (trans)
  const int q_off = (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
  const int k_off = ((lane >> 4) * 8 + (lane & 7)) * LDS + ((lane >> 3) & 1) * 8;
  const int v_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * LDS + (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {        // the next tile loads under this tile's products
      load_tile<HD, BN>(Ks + (buf ^ 1) * BN * LDS, kb, kss, (t + 1) * BN, Sk, aligned);
      load_tile<HD, BN>(Vs + (buf ^ 1) * BN * LDS, vb, vss, (t + 1) * BN, Sk, aligned);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * BN * LDS;
    const bf16* Vt = Vs + buf * BN * LDS;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < HDP / 16; ++kd) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_addr(Qs + q_off + kd * 16));
#pragma unroll
      for (int np = 0; np < NKT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(Kt + k_off + np * 16 * LDS + kd * 16));
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax in the log2 domain; masks only where the tile needs them
    const int k0 = t * BN;
    const bool masked = k0 + BN > Sk || (causal && k0 + BN - 1 > q_offset + q0);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int kc = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qr = q_offset + row_lo + (e >> 1) * 8;
          if (kc >= Sk || (causal && kc > qr)) x = NEG;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      base[i] = m_new == NEG ? 0.f : m_new;   // only masked keys so far
      const float alpha = exp2f(m[i] - base[i]);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < NDT; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - base[e >> 1]);   // -inf: exactly 0
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // O += P V: P from registers as bf16 A fragments, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HDP / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(Vt + v_off + kk * 16 * LDS + dp * 16));
        mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();              // this buffer is free for the tile after next
  }

  // normalise, stage through this warp's own Q rows, write 16 bytes a lane
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = quad_sum(l[i]);
    inv[i] = lt > 0.f ? 1.f / lt : 0.f;
  }
  bf16* Os = Qs + warp * 16 * LDS;
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(Os + (g + 8 * i) * LDS + j * 8 + 2 * t4) =
          pack_bf16(acc[j][2 * i] * inv[i], acc[j][2 * i + 1] * inv[i]);
  __syncwarp();
  bf16* ob = o + b * osb + h * osh;
  for (int i = lane; i < 16 * (HD / 8); i += 32) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    const int qr = q0 + warp * 16 + r;
    if (qr < Sq)
      *reinterpret_cast<uint4*>(ob + (int64_t)qr * oss + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LDS + c * 8);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Sk,
                       const int64_t* st, float scale, int causal, int q_offset,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  flash_fwd_f32<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal, q_offset);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Sq, int Sk,
                        const int64_t* st, float scale, int causal, int q_offset,
                        cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // cp.async moves 16 bytes: q, k and v rows that do not all start on 16
  // bytes are loaded synchronously.  o is written 16 bytes a lane, so its
  // rows must start on 16 (the wrapper allocates it contiguous).
  auto on16 = [](const void* p, const int64_t* s) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % 8 == 0 &&
           s[1] % 8 == 0 && s[2] % 8 == 0;
  };
  const bool aligned = on16(q, st) && on16(k, st + 3) && on16(v, st + 6);
  const int nq = (Sq + BM - 1) / BM;
  if (!on16(o, st + 9) || nq > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid(H, B, nq);
  flash_fwd_bf16_tc<HD><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, KV, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale * 1.4426950408889634f, causal, q_offset,
      (int)aligned);
  return cudaGetLastError();
}

#define FA_DIMS(X) X(8) X(16) X(32) X(64) X(80) X(96) X(128) X(192) X(256)

cudaError_t dispatch(int dtype, int hd, const void* q, const void* k,
                     const void* v, void* o, int B, int H, int KV, int Sq,
                     int Sk, const int64_t* st, float scale, int causal,
                     int q_offset, cudaStream_t s) {
  switch (hd) {
#define FA_CASE(D)                                                              \
    case D:                                                                     \
      if (dtype == 0) return launch_f32<D>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, q_offset, s); \
      if (dtype == 1) return launch_bf16<D>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, q_offset, s); \
      return cudaErrorInvalidValue;
    FA_DIMS(FA_CASE)
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
#define FA_DIM(D) D,
  const int dims[] = {FA_DIMS(FA_DIM)};
#undef FA_DIM
  const int n = (int)(sizeof(dims) / sizeof(dims[0]));
  for (int i = 0; i < n && i < cap; ++i) out[i] = dims[i];
  return n;
}

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel).
// strides: 12 element strides (batch, seq, head) for q, k, v, o in that order.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int KV, int Sq, int Sk,
                        int hd, const int64_t* strides, float scale,
                        int causal, int q_offset, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      q_offset < 0 || (causal ? q_offset + Sq > Sk : q_offset != 0))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, hd, q, k, v, o, B, H, KV, Sq, Sk, strides, scale,
                       causal, q_offset, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
