// Decode attention (flash-decoding) for Hopper (sm_90a), plain CUDA C++.
//
// Replaces no TPU kernel.  The JAX package decodes through plain XLA
// attention over the whole cache; the port's plain version of that
// (`models/ops.py::attention_reference`) reads every slot's whole max_len
// lane, converts it to float32 and copies it again to permute it, about
// five times the cache's bytes a layer.  This kernel computes the same
// function, softmax(q k^T / sqrt(hd)) v for one query row against the
// first kv_len[b] rows of slot b's cache, and reads each live byte once.
//
// What bounds it: bytes.  One query row per head does 4 H hd kv_len
// FLOPs against 2 KV hd kv_len cache elements read, fewer than 2 FLOPs a
// byte in bfloat16, where the H100's tensor cores need ~295 (the float32
// CUDA cores ~20).  The least time of a call is its live K and V bytes
// (plus q and the output) over 3.35 TB/s.  The design spends nothing the
// memory does not need:
//   * it reads only rows [0, kv_len[b]) of each slot: the grid covers
//     max_len in chunks of CHUNK keys, and a block whose chunk starts at or
//     past its slot's kv_len exits at once.  kv_len is read on the device,
//     so the host never waits for it;
//   * one block serves all G = H / KV query heads of its KV head, so each
//     K and V byte is read once, not G times;
//   * each lane loads 16 bytes at a time, a key row's lanes side by side,
//     and UNROLL rows are in flight per lane before any arithmetic.
// Dot products, the online softmax (running max m and sum l) and the P V
// sum are float32, and P is never rounded: the plain version's arithmetic
// in another order of sums.  Inputs are float32 or bfloat16; the output is
// in q's dtype.
//
// Two kernels a call:
//   decode_attn_partial  grid (chunk, KV head, slot), NT threads.  Each
//       key row is read by LPR lanes (16 bytes each); a warp walks RPW rows
//       at a time, each lane group keeping its own (m, l, acc) for the G
//       heads in registers.  The groups of a warp merge by shuffles, the
//       warps through shared memory, and the block writes its chunk's
//       (m, l) and unnormalised acc in float32 to scratch.
//   decode_attn_combine  grid (KV head, slot): the live chunks' partials
//       merged under their common max, divided by the sum, written in q's
//       dtype.
//
// Layout: q (B, 1, H, hd), k/v (B, Sk, KV, hd), out (B, 1, H, hd), read
// and written through element strides for batch, sequence and head; the
// head dimension must be contiguous, and q, k and v must start on 16 bytes
// with strides that keep every row there.  Query head h reads KV head
// h / G.  kv_len is a (B,) int32 vector on the device, or null for the
// whole lane; a value is taken as min(max(kv_len, 1), Sk).  Scratch:
// part_o (B, KV, NC, G, hd) and part_ml (B, KV, NC, G, 2), float32, NC =
// ceil(Sk / CHUNK), allocated by the caller; only live chunks' entries are
// written and read.
//
// C interface (ctypes): decode_attention_fwd returns a cudaError_t as int,
// the result of cudaGetLastError() after each launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NW = 4;             // warps per block
constexpr int NT = 32 * NW;       // threads per block
constexpr int CHUNK = 256;        // keys per block of the partial kernel
constexpr int UNROLL = 4;         // rows a lane group loads before computing
constexpr int MAX_G = 8;          // largest GQA group built
constexpr float NEG_INF = -INFINITY;

// 16 bytes of T as floats
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void to_float(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void to_float(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// exp2(x - mx), 0 for a lane with nothing (x = -inf), whatever mx is
__device__ __forceinline__ float weight(float x, float mx) {
  return x == NEG_INF ? 0.f : exp2f(x - mx);
}

__device__ __forceinline__ int live_len(const int* kv_len, int b, int Sk) {
  if (kv_len == nullptr) return Sk;
  const int n = kv_len[b];
  return n < 1 ? 1 : (n > Sk ? Sk : n);
}

template <typename T, int HD>
struct Lanes {
  static constexpr int VEC = Vec<T>::N;                       // elements a load
  static constexpr int LPR = HD / VEC < 32 ? HD / VEC : 32;   // lanes a key row
  static constexpr int E = HD / LPR;                          // elements a lane
  static constexpr int NV = E / VEC;                          // loads a lane a row
  static constexpr int RPW = 32 / LPR;                        // rows a warp step
  static_assert(HD % VEC == 0 && 32 % LPR == 0 && E % VEC == 0, "unsupported head dim");
};

template <typename T, int HD, int G>
__global__ void __launch_bounds__(NT)
decode_attn_partial(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    int KV, int Sk, int NC,
                    int64_t qsb, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                    int64_t vsb, int64_t vss, int64_t vsh, float scale_log2) {
  using L = Lanes<T, HD>;
  constexpr int E = L::E, NV = L::NV, VEC = L::VEC, LPR = L::LPR, RPW = L::RPW;
  constexpr int STEP = NW * RPW;                              // rows a block step

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = live_len(kv_len, b, Sk);
  const int c0 = c * CHUNK;
  if (c0 >= len) return;                                      // past the live prefix
  const int end = min(c0 + CHUNK, len);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / LPR, j = lane % LPR;                  // row group, lane in it

  float qf[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = q + b * qsb + (int64_t)(kvh * G + g) * qsh + j * E;
#pragma unroll
    for (int n = 0; n < NV; ++n)
      Vec<T>::to_float(*reinterpret_cast<const uint4*>(qp + n * VEC), &qf[g][n * VEC]);
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const T* kb = k + b * ksb + kvh * ksh + j * E;
  const T* vb = v + b * vsb + kvh * vsh + j * E;
  // warp-uniform loop: every lane takes part in every shuffle
  for (int base = c0 + warp * RPW; base < end; base += STEP * UNROLL) {
    uint4 kr[UNROLL][NV], vr[UNROLL][NV];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + rg + u * STEP;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        if (r < end) {
          kr[u][n] = __ldg(reinterpret_cast<const uint4*>(kb + r * kss + n * VEC));
          vr[u][n] = __ldg(reinterpret_cast<const uint4*>(vb + r * vss + n * VEC));
        } else {
          kr[u][n] = make_uint4(0, 0, 0, 0);
          vr[u][n] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    float s[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float kf[VEC];
        Vec<T>::to_float(kr[u][n], kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[u][g] = fmaf(qf[g][n * VEC + e], kf[e], s[u][g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
      const bool live = base + rg + u * STEP < end;
#pragma unroll
      for (int g = 0; g < G; ++g) s[u][g] = live ? s[u][g] * scale_log2 : NEG_INF;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mx = fmaxf(mx, s[u][g]);
      const float corr = weight(m[g], mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        s[u][g] = weight(s[u][g], mx);                        // p, float32
        l[g] += s[u][g];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float vf[VEC];
        Vec<T>::to_float(vr[u][n], vf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][n * VEC + e] = fmaf(s[u][g], vf[e], acc[g][n * VEC + e]);
      }
    }
  }

  // the row groups of a warp: lanes j of two groups differ by a multiple of LPR
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float a = weight(m[g], mx), w = weight(mo, mx);
      l[g] = l[g] * a + lo * w;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * w;
      m[g] = mx;
    }
  }

  // the warps, through shared memory
  __shared__ float sm_o[NW][G][HD];
  __shared__ float sm_m[NW][G], sm_l[NW][G];
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e) sm_o[warp][g][j * E + e] = acc[g][e];
      if (j == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  const int64_t part = ((int64_t)b * KV + kvh) * NC + c;
  float* po = part_o + part * G * HD;
  float* pml = part_ml + part * G * 2;
  for (int i = threadIdx.x; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float o = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float a = weight(sm_m[w][g], mx);
      o += sm_o[w][g][d] * a;
      ls += sm_l[w][g] * a;
    }
    po[i] = o;
    if (d == 0) {
      pml[2 * g] = mx;
      pml[2 * g + 1] = ls;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
decode_attn_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                    const int* __restrict__ kv_len, T* __restrict__ out,
                    int KV, int G, int HD, int Sk, int NC, int64_t osb, int64_t osh) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int nc = (live_len(kv_len, b, Sk) + CHUNK - 1) / CHUNK;   // live chunks
  const int64_t part = ((int64_t)b * KV + kvh) * NC;
  const float* po = part_o + part * G * HD;                       // [c][g][d]
  const float* pml = part_ml + part * G * 2;                      // [c][g][m, l]
  __shared__ float s_max[MAX_G], s_inv[MAX_G];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += NW) {
    float mx = NEG_INF;
    for (int c = lane; c < nc; c += 32) mx = fmaxf(mx, pml[(c * G + g) * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float ls = 0.f;
    for (int c = lane; c < nc; c += 32)
      ls += pml[(c * G + g) * 2 + 1] * weight(pml[(c * G + g) * 2], mx);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
    if (lane == 0) {
      s_max[g] = mx;
      s_inv[g] = 1.f / ls;
    }
  }
  __syncthreads();
  T* ob = out + b * osb + (int64_t)kvh * G * osh;
  for (int i = threadIdx.x; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    const float mx = s_max[g];
    float o = 0.f;
    for (int c = 0; c < nc; ++c)
      o += po[(int64_t)c * G * HD + i] * weight(pml[(c * G + g) * 2], mx);
    store(ob + g * osh + d, o * s_inv[g]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int HD, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len,
                   void* out, float* part_o, float* part_ml, int B, int KV, int Sk,
                   const int64_t* st, float scale, cudaStream_t stream) {
  const int NC = (Sk + CHUNK - 1) / CHUNK;
  dim3 grid(NC, KV, B);
  decode_attn_partial<T, HD, G><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
      part_o, part_ml, KV, Sk, NC, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      scale * 1.4426950408889634f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine<T><<<dim3(KV, B), NT, 0, stream>>>(
      part_o, part_ml, kv_len, static_cast<T*>(out), KV, G, HD, Sk, NC, st[8], st[9]);
  return cudaGetLastError();
}

#define DA_DIMS(X) X(16) X(32) X(64) X(128)
#define DA_GROUPS(X, D) X(D, 1) X(D, 2) X(D, 3) X(D, 4) X(D, 6) X(D, 8)

template <typename T>
cudaError_t dispatch(int hd, int G, const void* q, const void* k, const void* v,
                     const int* kv_len, void* out, float* part_o, float* part_ml, int B,
                     int KV, int Sk, const int64_t* st, float scale, cudaStream_t s) {
#define DA_CASE(D, GG)                                                              \
  if (hd == D && G == GG)                                                           \
    return launch<T, D, GG>(q, k, v, kv_len, out, part_o, part_ml, B, KV, Sk, st, scale, s);
#define DA_DIM(D) DA_GROUPS(DA_CASE, D)
  DA_DIMS(DA_DIM)
#undef DA_DIM
#undef DA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int decode_attention_chunk() { return CHUNK; }

// 1 where the kernel is built for head dim hd and group size G, else 0.
int decode_attention_supported(int hd, int G) {
#define DA_CASE(D, GG) if (hd == D && G == GG) return 1;
#define DA_DIM(D) DA_GROUPS(DA_CASE, D)
  DA_DIMS(DA_DIM)
#undef DA_DIM
#undef DA_CASE
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  strides: 10 element strides, q (batch,
// head), k (batch, seq, head), v (batch, seq, head), out (batch, head).
// kv_len: a (B,) int32 device vector, or null for the whole lane.
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* kv_len,
                         void* out, void* part_o, void* part_ml, int dtype, int B, int H,
                         int KV, int Sk, int hd, const int64_t* strides, float scale,
                         void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || Sk <= 0 || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const int* kl = static_cast<const int*>(kv_len);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(hd, G, q, k, v, kl, out, po, pml, B, KV, Sk, strides, scale, s);
  if (dtype == 1)
    return (int)dispatch<bf16>(hd, G, q, k, v, kl, out, po, pml, B, KV, Sk, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
