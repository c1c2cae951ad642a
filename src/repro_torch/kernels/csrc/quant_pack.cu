// LAQ send-side wire kernels for Hopper (sm_90a), hand-written CUDA C++.
//
// Build (done at first use by repro_torch/kernels/quant_pack.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libquant_pack.so quant_pack.cu
// Plain C interface, loaded with ctypes; every entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// laq_absmax replaces absmax_pallas (src/repro/kernels/quant_pack.py):
//   R = max_i |g_i - qh_i| without materializing the difference.
//   Bound: bytes. It reads 8 B per element and writes one float, so it is
//   an HBM sweep (1.1e9 B at the largest stablelm-1.6b leaf).  Design:
//   grid-stride loop with 16-byte loads, one partial per block from a
//   warp-shuffle tree, then one warp folds the partials.  The max is
//   NaN-propagating (fmaxf would drop a NaN; jnp.max keeps it), and max is
//   order-free, so R equals the reference bit for bit.
//
// laq_quantize_pack replaces quantize_pack_pallas (same file):
//   one sweep that emits the b-bit codes packed little-end-first, delta,
//   q_new = qh + delta and the two criterion moments ||g - q_new||^2 and
//   ||delta||^2.  Bound: bytes: it reads 8 B and writes 8 + b/8 B per
//   element.  Design: each thread takes groups of 8 consecutive elements,
//   which are exactly b whole payload bytes for every b in {1, 2, 4, 8},
//   so the packed bytes are written by one store per group and no two
//   threads share a byte.  Loads and the delta/q_new stores are 16 bytes.
//   Moments: per-thread float64 sums, a fixed shuffle tree per block, one
//   partial per block, then one warp folds the partials in a fixed order:
//   deterministic, no atomics.  The ragged tail is masked here (no padding
//   of the inputs); a tail byte with fewer than 8/b real codes carries the
//   midpoint code in its unused lanes (docs/wire-format.md).
//
// laq_quantize_pack with lane_bits = max(grid) replaces
// quantize_pack_adaptive_pallas (same file):
//   the A-LAQ pass 2.  The width b is chosen per worker and round on the
//   host (select_bits), so the wrapper picks the template arm <b, max(grid)>
//   of the same body as the fixed-width kernel, which writes the b-bit codes
//   into max(grid)-bit lanes.  A pinned width is kernel 2 at that width, bit
//   for bit, because it is kernel 2's body.  Bound: bytes: it reads 8 B and
//   writes 8 + max(grid)/8 B per element.  The tail byte's unused lanes
//   carry the b-bit midpoint code.
//
// laq_sparse_quantize_pack replaces sparse_quant_pack_pallas (same file):
//   the sign-magnitude grid on the k gathered top-k survivors (EF-LAQ):
//   codes = (neg << (b-1)) | mag, deq = +-(lo + mag * step), and the codes
//   packed at b.  Bound: bytes: it reads 4 B and writes 1 + 4 + b/8 B per
//   survivor.  Design: the group of 8 survivors per thread of the pass-2
//   kernel (b whole payload bytes, one store, no shared bytes), 16-byte
//   loads and deq stores, one 8-byte store of the 8 codes.  lo and hi are
//   read from the device (they are reductions over the survivors).  The
//   arithmetic is the reference's under jit, where XLA turns the constant
//   division into a multiply by the reciprocal and contracts into an FMA:
//     step = (hi - lo) * f32(1 / max(L, 1))      (reciprocal from the host)
//     mag  = clamp(floor((|v| - lo) / step + 0.5), 0, L), 0 if !(step > 0)
//     deq  = +-fma(mag, step, lo)
//   The tail byte's unused lanes carry the midpoint code 2^b / 2, as the
//   canonical sparse payload does.
//
// laq_quantize_codes replaces quantize_codes_pallas and, at a width the
// host picks, quantize_codes_adaptive_pallas (same file):
//   the sharded wire's send-side sweep: the b-bit codes UNPACKED, one byte
//   each (the wire packs them along the leaf's last dim itself), and
//   delta.  Bound: bytes: it reads 8 B and writes 1 + 4 B per element.
//   Design: kernel 2's group of 8 elements per thread, 16-byte loads and
//   delta stores, one 8-byte store of the 8 codes.  The adaptive width is
//   chosen on the host before the launch (select_bits), so the wrapper
//   picks the template arm <b>: a pinned width is the fixed-width kernel.
//
// laq_quantize_pack_payload replaces quantize_pack_payload_pallas (same
// file):
//   kernel 2 without q_new and the moments: the codes packed at b, and
//   delta.  The payload keeps the Pallas wrapper's padding to a multiple of
//   4096 elements byte for byte: the pad elements are quantized as d = 0
//   under R, as the Pallas kernel quantizes its zero-padded input.  Bound:
//   bytes: it reads 8 B and writes 4 + b/8 B per element.  Same body as
//   laq_quantize_codes, with the 8 codes of a group packed into b bytes.
//
// laq_dequant_acc replaces dequant_acc_pallas (same file):
//   the receive side: out = acc + sum_w keep_w * delta_w(code, R_w) from W
//   packed payload rows.  Bound: bytes: it reads W b/8 B (+ 4 B with acc)
//   and writes 4 B per element.  Design: a thread takes 8 consecutive
//   elements, which are b whole bytes of each row: one load of b bytes per
//   row, 8 codes unpacked in registers, and 16-byte acc loads and out
//   stores.  The W per-worker constants (2 tau R_w, R_w > 0, keep_w) sit in
//   shared memory; W is a run-time argument up to kMaxWorkers, and the
//   worker loop is unrolled by 4.  The sum order is the Pallas kernel's,
//   fixed and without atomics: acc (or 0) first, then worker by worker,
//   each term delta_w * keep_w rounded before the add (keep is a 0/1 mask,
//   so the product is exact and an FMA would give the same bits).
//
// Rounding of the dense kernels, held bit for bit against the JAX
// reference under jit:
//   denom = f32(2 tau) * R        (2 tau folded in double on the host)
//   q     = clamp(floor((d + R) / denom + 0.5), 0, 2^b - 1)   IEEE division
//   delta = fma(denom, q, -R)     (XLA contracts 2 tau R * q - R to an FMA)
//   R == 0 (or NaN): q = 2^(b-1), delta = 0.
// Compiled with -fmad=false and no fast-math: only the explicit intrinsics
// below fuse or round.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWorkers = 64;              // rows of one laq_dequant_acc

__device__ __forceinline__ float max_nan(float a, float b) {
  // NaN-propagating max of two non-negative values
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float absdiff(float a, float b) {
  return fabsf(__fsub_rn(a, b));
}

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ g, const float* __restrict__ qh,
              int64_t n, int aligned, float* __restrict__ partial) {
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  float m = 0.f;
  int64_t head = 0;
  if (aligned) {
    const int64_t n4 = n / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* q4 = reinterpret_cast<const float4*>(qh);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 a = __ldg(g4 + i);
      const float4 b = __ldg(q4 + i);
      m = max_nan(m, absdiff(a.x, b.x));
      m = max_nan(m, absdiff(a.y, b.y));
      m = max_nan(m, absdiff(a.z, b.z));
      m = max_nan(m, absdiff(a.w, b.w));
    }
    head = n4 * 4;
  }
  for (int64_t i = head + tid; i < n; i += stride)
    m = max_nan(m, absdiff(g[i], qh[i]));

  __shared__ float sh[kWarps];
  m = warp_max(m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? sh[lane] : 0.f;
    m = warp_max(m);
    if (lane == 0) partial[blockIdx.x] = m;
  }
}

__global__ void max_partials_kernel(const float* __restrict__ partial,
                                    int nparts, float* __restrict__ out) {
  float m = 0.f;
  for (int i = threadIdx.x; i < nparts; i += 32) m = max_nan(m, partial[i]);
  m = warp_max(m);
  if (threadIdx.x == 0) out[0] = m;
}

// clamp(floor((d + R) / denom + 0.5), 0, levels); a NaN quotient gives 0
__device__ __forceinline__ float code_of(float d, float R, float denom,
                                         float levels) {
  const float q = floorf(__fadd_rn(__fdiv_rn(__fadd_rn(d, R), denom), 0.5f));
  return fminf(fmaxf(q, 0.f), levels);
}

template <int BITS>
__device__ __forceinline__ void store_packed(uint8_t* p, uint64_t word) {
  if constexpr (BITS == 8) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2((uint32_t)word, (uint32_t)(word >> 32));
  } else if constexpr (BITS == 4) {
    *reinterpret_cast<uint32_t*>(p) = (uint32_t)word;
  } else if constexpr (BITS == 2) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)word;
  } else {
    *p = (uint8_t)word;
  }
}

// BITS: the code width; LANE: the width of a code's lane in the payload
// (LANE == BITS for the fixed-width wire, max(grid) for the adaptive one).
template <int BITS, int LANE>
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ g, const float* __restrict__ qh,
                     const float* __restrict__ Rp, float two_tau, int64_t n,
                     int aligned, uint8_t* __restrict__ packed,
                     float* __restrict__ delta, float* __restrict__ qnew,
                     double* __restrict__ err_part,
                     double* __restrict__ inn_part) {
  constexpr int kLevels = (1 << BITS) - 1;
  constexpr uint32_t kMid = (kLevels + 1) / 2;
  const float R = Rp[0];
  const bool live = R > 0.f;                 // false for R == 0 and NaN
  const float denom = live ? __fmul_rn(two_tau, R) : 1.f;
  const float neg_R = -R;
  const int64_t ngroups = (n + 7) / 8;
  const int64_t nbytes = (n * LANE + 7) / 8;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;

  double err_acc = 0.0, inn_acc = 0.0;
  for (int64_t gi = tid; gi < ngroups; gi += stride) {
    const int64_t base = gi * 8;
    const bool full = base + 8 <= n;
    float gv[8], qv[8];
    if (full && aligned) {
      const float4* g4 = reinterpret_cast<const float4*>(g + base);
      const float4* q4 = reinterpret_cast<const float4*>(qh + base);
      const float4 a0 = __ldg(g4), a1 = __ldg(g4 + 1);
      const float4 b0 = __ldg(q4), b1 = __ldg(q4 + 1);
      gv[0] = a0.x; gv[1] = a0.y; gv[2] = a0.z; gv[3] = a0.w;
      gv[4] = a1.x; gv[5] = a1.y; gv[6] = a1.z; gv[7] = a1.w;
      qv[0] = b0.x; qv[1] = b0.y; qv[2] = b0.z; qv[3] = b0.w;
      qv[4] = b1.x; qv[5] = b1.y; qv[6] = b1.z; qv[7] = b1.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = base + j < n;
        gv[j] = in ? g[base + j] : 0.f;
        qv[j] = in ? qh[base + j] : 0.f;
      }
    }

    float dl[8], qn[8];
    uint64_t word = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = __fsub_rn(gv[j], qv[j]);
      float qf = (float)kMid, dv = 0.f;
      if (live) {
        qf = code_of(d, R, denom, (float)kLevels);
        dv = __fmaf_rn(denom, qf, neg_R);
      }
      const float qnv = __fadd_rn(qv[j], dv);
      dl[j] = dv;
      qn[j] = qnv;
      uint32_t code = (uint32_t)qf;
      if (base + j < n) {
        const double e = (double)__fsub_rn(gv[j], qnv);
        err_acc = __fma_rn(e, e, err_acc);
        inn_acc = __fma_rn((double)dv, (double)dv, inn_acc);
      } else {
        code = kMid;                         // pad lanes of the tail byte
      }
      word |= (uint64_t)code << (LANE * j);
    }

    if (full && aligned) {
      float4* d4 = reinterpret_cast<float4*>(delta + base);
      float4* n4 = reinterpret_cast<float4*>(qnew + base);
      d4[0] = make_float4(dl[0], dl[1], dl[2], dl[3]);
      d4[1] = make_float4(dl[4], dl[5], dl[6], dl[7]);
      n4[0] = make_float4(qn[0], qn[1], qn[2], qn[3]);
      n4[1] = make_float4(qn[4], qn[5], qn[6], qn[7]);
      store_packed<LANE>(packed + gi * LANE, word);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (base + j < n) {
          delta[base + j] = dl[j];
          qnew[base + j] = qn[j];
        }
      }
      for (int k = 0; k < LANE; ++k) {
        if (gi * LANE + k < nbytes)
          packed[gi * LANE + k] = (uint8_t)(word >> (8 * k));
      }
    }
  }

  __shared__ double sh_err[kWarps], sh_inn[kWarps];
  err_acc = warp_sum(err_acc);
  inn_acc = warp_sum(inn_acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh_err[warp] = err_acc;
    sh_inn[warp] = inn_acc;
  }
  __syncthreads();
  if (warp == 0) {
    err_acc = warp_sum(lane < kWarps ? sh_err[lane] : 0.0);
    inn_acc = warp_sum(lane < kWarps ? sh_inn[lane] : 0.0);
    if (lane == 0) {
      err_part[blockIdx.x] = err_acc;
      inn_part[blockIdx.x] = inn_acc;
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
sparse_quantize_pack_kernel(const float* __restrict__ vals,
                            const float* __restrict__ lo_p,
                            const float* __restrict__ hi_p, float inv_levels,
                            int64_t k, int aligned,
                            uint8_t* __restrict__ packed,
                            uint8_t* __restrict__ codes,
                            float* __restrict__ deq) {
  constexpr int kL = (1 << (BITS - 1)) - 1;  // magnitude levels above lo
  constexpr uint32_t kMid = 1u << (BITS - 1);
  const float lo = lo_p[0];
  const float step = __fmul_rn(__fsub_rn(hi_p[0], lo), inv_levels);
  const bool live = step > 0.f;              // false for 0 and NaN
  const float safe = live ? step : 1.f;
  const int64_t ngroups = (k + 7) / 8;
  const int64_t nbytes = (k * BITS + 7) / 8;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;

  for (int64_t gi = tid; gi < ngroups; gi += stride) {
    const int64_t base = gi * 8;
    const bool full = base + 8 <= k;
    float v[8];
    if (full && aligned) {
      const float4* v4 = reinterpret_cast<const float4*>(vals + base);
      const float4 a0 = __ldg(v4), a1 = __ldg(v4 + 1);
      v[0] = a0.x; v[1] = a0.y; v[2] = a0.z; v[3] = a0.w;
      v[4] = a1.x; v[5] = a1.y; v[6] = a1.z; v[7] = a1.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = base + j < k ? vals[base + j] : 0.f;
    }

    float dq[8];
    uint8_t cd[8];
    uint64_t word = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool neg = v[j] < 0.f;
      float mag = 0.f;
      if (live) {
        mag = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(fabsf(v[j]), lo), safe),
                               0.5f));
        mag = fminf(fmaxf(mag, 0.f), (float)kL);
      }
      const float x = __fmaf_rn(mag, step, lo);
      dq[j] = neg ? -x : x;
      uint32_t code = ((uint32_t)neg << (BITS - 1)) | (uint32_t)mag;
      cd[j] = (uint8_t)code;
      if (base + j >= k) code = kMid;        // pad lanes of the tail byte
      word |= (uint64_t)code << (BITS * j);
    }

    if (full && aligned) {
      float4* d4 = reinterpret_cast<float4*>(deq + base);
      d4[0] = make_float4(dq[0], dq[1], dq[2], dq[3]);
      d4[1] = make_float4(dq[4], dq[5], dq[6], dq[7]);
      uint64_t cw = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) cw |= (uint64_t)cd[j] << (8 * j);
      *reinterpret_cast<uint2*>(codes + base) =
          make_uint2((uint32_t)cw, (uint32_t)(cw >> 32));
      store_packed<BITS>(packed + gi * BITS, word);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (base + j < k) {
          deq[base + j] = dq[j];
          codes[base + j] = cd[j];
        }
      }
      for (int b = 0; b < BITS; ++b) {
        if (gi * BITS + b < nbytes)
          packed[gi * BITS + b] = (uint8_t)(word >> (8 * b));
      }
    }
  }
}

// PACK == false: codes one byte each over the n elements (kernels 5, 6).
// PACK == true: codes packed at BITS over npad elements, npad a multiple
// of 8 and >= n, the pad quantized as d = 0 (kernel 3).
template <int BITS, bool PACK>
__global__ void __launch_bounds__(kThreads)
quantize_codes_kernel(const float* __restrict__ g, const float* __restrict__ qh,
                      const float* __restrict__ Rp, float two_tau, int64_t n,
                      int64_t npad, int aligned, uint8_t* __restrict__ codes,
                      float* __restrict__ delta) {
  constexpr int kLevels = (1 << BITS) - 1;
  constexpr uint32_t kMid = (kLevels + 1) / 2;
  constexpr int kLane = PACK ? BITS : 8;     // bits of a code in `codes`
  const float R = Rp[0];
  const bool live = R > 0.f;                 // false for R == 0 and NaN
  const float denom = live ? __fmul_rn(two_tau, R) : 1.f;
  const float neg_R = -R;
  const int64_t ngroups = (npad + 7) / 8;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;

  for (int64_t gi = tid; gi < ngroups; gi += stride) {
    const int64_t base = gi * 8;
    const bool full = base + 8 <= n;
    float gv[8], qv[8];
    if (full && aligned) {
      const float4* g4 = reinterpret_cast<const float4*>(g + base);
      const float4* q4 = reinterpret_cast<const float4*>(qh + base);
      const float4 a0 = __ldg(g4), a1 = __ldg(g4 + 1);
      const float4 b0 = __ldg(q4), b1 = __ldg(q4 + 1);
      gv[0] = a0.x; gv[1] = a0.y; gv[2] = a0.z; gv[3] = a0.w;
      gv[4] = a1.x; gv[5] = a1.y; gv[6] = a1.z; gv[7] = a1.w;
      qv[0] = b0.x; qv[1] = b0.y; qv[2] = b0.z; qv[3] = b0.w;
      qv[4] = b1.x; qv[5] = b1.y; qv[6] = b1.z; qv[7] = b1.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = base + j < n;          // the pad reads as 0 - 0
        gv[j] = in ? g[base + j] : 0.f;
        qv[j] = in ? qh[base + j] : 0.f;
      }
    }

    float dl[8];
    uint64_t word = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float qf = (float)kMid, dv = 0.f;
      if (live) {
        qf = code_of(__fsub_rn(gv[j], qv[j]), R, denom, (float)kLevels);
        dv = __fmaf_rn(denom, qf, neg_R);
      }
      dl[j] = dv;
      word |= (uint64_t)(uint32_t)qf << (kLane * j);
    }

    if (full && aligned) {
      float4* d4 = reinterpret_cast<float4*>(delta + base);
      d4[0] = make_float4(dl[0], dl[1], dl[2], dl[3]);
      d4[1] = make_float4(dl[4], dl[5], dl[6], dl[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (base + j < n) delta[base + j] = dl[j];
    }
    if constexpr (PACK) {                    // whole groups: npad % 8 == 0
      if (aligned) {
        store_packed<BITS>(codes + gi * BITS, word);
      } else {
        for (int k = 0; k < BITS; ++k)
          codes[gi * BITS + k] = (uint8_t)(word >> (8 * k));
      }
    } else if (full && aligned) {
      store_packed<8>(codes + base, word);
    } else {
      for (int j = 0; j < 8; ++j)
        if (base + j < n) codes[base + j] = (uint8_t)(word >> (8 * j));
    }
  }
}

template <int BITS>
__device__ __forceinline__ uint64_t load_packed(const uint8_t* p) {
  if constexpr (BITS == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    return (uint64_t)v.x | ((uint64_t)v.y << 32);
  } else if constexpr (BITS == 4) {
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  } else if constexpr (BITS == 2) {
    return __ldg(reinterpret_cast<const uint16_t*>(p));
  } else {
    return __ldg(p);
  }
}

template <int BITS, bool ACC>
__global__ void __launch_bounds__(kThreads)
dequant_acc_kernel(const uint8_t* __restrict__ packed, int64_t row_bytes,
                   int W, const float* __restrict__ Rp,
                   const float* __restrict__ keep_p, float two_tau, int64_t n,
                   int aligned, const float* __restrict__ acc,
                   float* __restrict__ out) {
  constexpr uint32_t kMask = (1u << BITS) - 1;
  __shared__ float sh_denom[kMaxWorkers], sh_neg_R[kMaxWorkers],
      sh_keep[kMaxWorkers];
  __shared__ bool sh_live[kMaxWorkers];
  for (int w = threadIdx.x; w < W; w += kThreads) {
    const float R = Rp[w];
    sh_live[w] = R > 0.f;                    // false for R == 0 and NaN
    sh_denom[w] = __fmul_rn(two_tau, R);
    sh_neg_R[w] = -R;
    sh_keep[w] = keep_p[w];
  }
  __syncthreads();
  const int64_t ngroups = (n + 7) / 8;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;

  for (int64_t gi = tid; gi < ngroups; gi += stride) {
    const int64_t base = gi * 8;
    const bool full = base + 8 <= n;
    float o[8];
    if (ACC && full && aligned) {
      const float4* a4 = reinterpret_cast<const float4*>(acc + base);
      const float4 a0 = __ldg(a4), a1 = __ldg(a4 + 1);
      o[0] = a0.x; o[1] = a0.y; o[2] = a0.z; o[3] = a0.w;
      o[4] = a1.x; o[5] = a1.y; o[6] = a1.z; o[7] = a1.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = (ACC && base + j < n) ? acc[base + j] : 0.f;
    }
#pragma unroll 4
    for (int w = 0; w < W; ++w) {
      const uint8_t* row = packed + w * row_bytes + gi * BITS;
      uint64_t word = 0;
      if (aligned && gi * BITS + BITS <= row_bytes) {
        word = load_packed<BITS>(row);
      } else {
        for (int k = 0; k < BITS; ++k)
          if (gi * BITS + k < row_bytes) word |= (uint64_t)row[k] << (8 * k);
      }
      const bool live = sh_live[w];
      const float denom = sh_denom[w], neg_R = sh_neg_R[w], kw = sh_keep[w];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float q = (float)((uint32_t)(word >> (BITS * j)) & kMask);
        const float dv = live ? __fmaf_rn(denom, q, neg_R) : 0.f;
        o[j] = __fadd_rn(o[j], __fmul_rn(dv, kw));
      }
    }
    if (full && aligned) {
      float4* o4 = reinterpret_cast<float4*>(out + base);
      o4[0] = make_float4(o[0], o[1], o[2], o[3]);
      o4[1] = make_float4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (base + j < n) out[base + j] = o[j];
    }
  }
}

__global__ void sum_partials_kernel(const double* __restrict__ err_part,
                                    const double* __restrict__ inn_part,
                                    int nparts, float* __restrict__ out) {
  double e = 0.0, s = 0.0;
  for (int i = threadIdx.x; i < nparts; i += 32) {
    e = __dadd_rn(e, err_part[i]);
    s = __dadd_rn(s, inn_part[i]);
  }
  e = warp_sum(e);
  s = warp_sum(s);
  if (threadIdx.x == 0) {
    out[0] = (float)e;
    out[1] = (float)s;
  }
}

template <int BITS, int LANE>
cudaError_t launch_quantize_pack(const float* g, const float* qh,
                                 const float* R, float two_tau, int64_t n,
                                 int aligned, uint8_t* packed, float* delta,
                                 float* qnew, double* err_part,
                                 double* inn_part, int nparts,
                                 cudaStream_t stream) {
  quantize_pack_kernel<BITS, LANE><<<nparts, kThreads, 0, stream>>>(
      g, qh, R, two_tau, n, aligned, packed, delta, qnew, err_part, inn_part);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_sparse(const float* vals, const float* lo, const float* hi,
                          float inv_levels, int64_t k, int aligned,
                          uint8_t* packed, uint8_t* codes, float* deq,
                          int nblocks, cudaStream_t stream) {
  sparse_quantize_pack_kernel<BITS><<<nblocks, kThreads, 0, stream>>>(
      vals, lo, hi, inv_levels, k, aligned, packed, codes, deq);
  return cudaGetLastError();
}

template <int BITS, bool PACK>
cudaError_t launch_codes(const float* g, const float* qh, const float* R,
                         float two_tau, int64_t n, int64_t npad, int aligned,
                         uint8_t* codes, float* delta, int nblocks,
                         cudaStream_t stream) {
  quantize_codes_kernel<BITS, PACK><<<nblocks, kThreads, 0, stream>>>(
      g, qh, R, two_tau, n, npad, aligned, codes, delta);
  return cudaGetLastError();
}

template <bool PACK>
cudaError_t launch_codes_at(int bits, const float* g, const float* qh,
                            const float* R, float two_tau, int64_t n,
                            int64_t npad, int aligned, uint8_t* codes,
                            float* delta, int nblocks, cudaStream_t stream) {
  switch (bits) {
    case 1: return launch_codes<1, PACK>(g, qh, R, two_tau, n, npad, aligned,
                                         codes, delta, nblocks, stream);
    case 2: return launch_codes<2, PACK>(g, qh, R, two_tau, n, npad, aligned,
                                         codes, delta, nblocks, stream);
    case 4: return launch_codes<4, PACK>(g, qh, R, two_tau, n, npad, aligned,
                                         codes, delta, nblocks, stream);
    case 8: return launch_codes<8, PACK>(g, qh, R, two_tau, n, npad, aligned,
                                         codes, delta, nblocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int BITS>
cudaError_t launch_dequant(const uint8_t* packed, int64_t row_bytes, int W,
                           const float* R, const float* keep, float two_tau,
                           int64_t n, int aligned, const float* acc,
                           float* out, int nblocks, cudaStream_t stream) {
  if (acc) {
    dequant_acc_kernel<BITS, true><<<nblocks, kThreads, 0, stream>>>(
        packed, row_bytes, W, R, keep, two_tau, n, aligned, acc, out);
  } else {
    dequant_acc_kernel<BITS, false><<<nblocks, kThreads, 0, stream>>>(
        packed, row_bytes, W, R, keep, two_tau, n, aligned, acc, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int laq_threads_per_block() { return kThreads; }

int laq_max_workers() { return kMaxWorkers; }

// R_out[0] = max |g - qh| over n elements; partial holds nparts floats.
int laq_absmax(const float* g, const float* qh, long long n, int aligned,
               float* partial, int nparts, float* R_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  absmax_kernel<<<nparts, kThreads, 0, s>>>(g, qh, n, aligned, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  max_partials_kernel<<<1, 32, 0, s>>>(partial, nparts, R_out);
  return (int)cudaGetLastError();
}

// One pass-2 sweep; moments[0] = ||g - q_new||^2, moments[1] = ||delta||^2.
// bits-wide codes in lane_bits-wide payload lanes (lane_bits >= bits).
int laq_quantize_pack(const float* g, const float* qh, const float* R,
                      float two_tau, int bits, int lane_bits, long long n,
                      int aligned, uint8_t* packed, float* delta, float* qnew,
                      double* err_part, double* inn_part, int nparts,
                      float* moments, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define LAQ_ARM(B, P)                                                        \
  case (B) * 16 + (P):                                                       \
    err = launch_quantize_pack<B, P>(g, qh, R, two_tau, n, aligned, packed,  \
                                     delta, qnew, err_part, inn_part, nparts, \
                                     s);                                     \
    break;
  switch (bits * 16 + lane_bits) {
    LAQ_ARM(1, 1) LAQ_ARM(1, 2) LAQ_ARM(1, 4) LAQ_ARM(1, 8)
    LAQ_ARM(2, 2) LAQ_ARM(2, 4) LAQ_ARM(2, 8)
    LAQ_ARM(4, 4) LAQ_ARM(4, 8)
    LAQ_ARM(8, 8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAQ_ARM
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, 32, 0, s>>>(err_part, inn_part, nparts, moments);
  return (int)cudaGetLastError();
}

// Sparse quantize + pack of k survivors; lo/hi are device scalars.
int laq_sparse_quantize_pack(const float* vals, const float* lo,
                             const float* hi, float inv_levels, int bits,
                             long long k, int aligned, uint8_t* packed,
                             uint8_t* codes, float* deq, int nblocks,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bits) {
    case 1: err = launch_sparse<1>(vals, lo, hi, inv_levels, k, aligned,
                                   packed, codes, deq, nblocks, s); break;
    case 2: err = launch_sparse<2>(vals, lo, hi, inv_levels, k, aligned,
                                   packed, codes, deq, nblocks, s); break;
    case 4: err = launch_sparse<4>(vals, lo, hi, inv_levels, k, aligned,
                                   packed, codes, deq, nblocks, s); break;
    case 8: err = launch_sparse<8>(vals, lo, hi, inv_levels, k, aligned,
                                   packed, codes, deq, nblocks, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// Unpacked codes [n] and delta [n] of one leaf at width bits.
int laq_quantize_codes(const float* g, const float* qh, const float* R,
                       float two_tau, int bits, long long n, int aligned,
                       uint8_t* codes, float* delta, int nblocks,
                       void* stream) {
  return (int)launch_codes_at<false>(bits, g, qh, R, two_tau, n, n, aligned,
                                     codes, delta, nblocks,
                                     static_cast<cudaStream_t>(stream));
}

// Codes packed at bits over npad (a multiple of 8, >= n) elements, the pad
// quantized as d = 0, and delta [n].
int laq_quantize_pack_payload(const float* g, const float* qh, const float* R,
                              float two_tau, int bits, long long n,
                              long long npad, int aligned, uint8_t* packed,
                              float* delta, int nblocks, void* stream) {
  if (npad % 8 != 0 || npad < n) return (int)cudaErrorInvalidValue;
  return (int)launch_codes_at<true>(bits, g, qh, R, two_tau, n, npad, aligned,
                                    packed, delta, nblocks,
                                    static_cast<cudaStream_t>(stream));
}

// out[n] = (acc or 0) + sum_w keep[w] * delta_w from W rows of row_bytes
// packed bytes each; acc may be null.
int laq_dequant_acc(const uint8_t* packed, long long row_bytes, int W,
                    const float* R, const float* keep, float two_tau, int bits,
                    long long n, int aligned, const float* acc, float* out,
                    int nblocks, void* stream) {
  if (W < 1 || W > kMaxWorkers || row_bytes * 8 / bits < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return (int)launch_dequant<1>(packed, row_bytes, W, R, keep,
                                          two_tau, n, aligned, acc, out,
                                          nblocks, s);
    case 2: return (int)launch_dequant<2>(packed, row_bytes, W, R, keep,
                                          two_tau, n, aligned, acc, out,
                                          nblocks, s);
    case 4: return (int)launch_dequant<4>(packed, row_bytes, W, R, keep,
                                          two_tau, n, aligned, acc, out,
                                          nblocks, s);
    case 8: return (int)launch_dequant<8>(packed, row_bytes, W, R, keep,
                                          two_tau, n, aligned, acc, out,
                                          nblocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
