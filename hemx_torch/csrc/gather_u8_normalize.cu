// Fused gather + uint8 -> float32 normalize for Hopper (sm_90a): the input
// kernel of every training path of hemx_torch.
//
// Replaces the TPU kernel hemx/ops/pallas_kernels.py::u8_normalize_pallas
// (its pl.pallas_call at line 75, body _norm_kernel) together with the
// jnp.take gather that hemx.data.pipeline runs before it:
//
//     out[r, j] = float(ds[idx[r], band_start + j]) * scale + lo
//
// for r < count and j < band, with scale = float32((hi - lo) / 255). The
// product and the sum are rounded apart (__fmul_rn, __fadd_rn; the build
// also passes -fmad=false), so the result equals the plain PyTorch version
// bit for bit.
//
// Bound by bytes: each gathered byte is read once and written as four, with
// two flops per element, so the card's 3.35 TB/s is the limit. What keeps a
// plain gather off that limit, and what this design does about it:
//
// * Masked tail blocks. The work is split over the flat (count x band)
//   output, not over (row, block of a row): a persistent grid of 256-thread
//   blocks walks tiles of 4,096 elements of it, every store is a 16-byte
//   float4, and only the output's last tile ends in a partial vector.
// * Rows whose width is not a multiple of 16. The loads are bulk
//   asynchronous copies (cp.async.bulk global -> shared, completed on an
//   mbarrier) of the 16-byte granules that hold each source row's part of
//   the tile; the threads then read the staged bytes at the row's own byte
//   offset, so neither the row width nor the storage offset of ds matters.
//   A granule is read whole where a row starts or ends inside it: its DRAM
//   sector (32 bytes) was fetched anyway. Only the granules that ds itself
//   starts or ends in, partly outside its bytes, are read with byte loads,
//   so no byte outside ds is touched.
// * Too few bytes in flight. Warp 0 of each block keeps the copies of the
//   block's next three tiles in flight while all its warps convert the
//   current one.
// * Stores. Each warp's float4 stores cover 512 contiguous bytes, and they
//   are streaming stores (evict-first): the output is 4/5 of the traffic
//   and is read once, by the next layer.
//
// The kernel reads each row index once per tile (int32 or int64, through a
// template), allocates nothing, does not synchronise, and launches on the
// stream it is given. Built by nvcc into a shared library with a plain C
// interface and loaded with ctypes by hemx_torch/ops/input_kernels.py.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
// Source rows one tile may span: one per lane of warp 0, which plans it.
constexpr int kMaxSeg = 32;
// Output elements per tile (fewer for rows under kTileMax / (kMaxSeg - 2)).
constexpr int kTileMax = 4096;
// Row k of a tile is staged from byte 48 * k + ceil16(its first element):
// 16-byte aligned, with room for its rounding out to 16-byte granules (up
// to 30 bytes) and for the consumers' 8-byte reads past its end.
constexpr int kStageBytes = kTileMax + 48 * kMaxSeg + 32;

struct Smem {
  alignas(128) unsigned char buf[kStages][kStageBytes];
  // per stage and row of the tile: buf index of the tile's element j is
  // j + off[row]
  int off[kStages][kMaxSeg];
  uint32_t j0[kStages];  // the tile's first element's place in its row
  alignas(8) uint64_t full[kStages];
};

template <typename T>
__device__ __forceinline__ T lesser(T a, T b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from the 16-byte aligned global src to the
// 16-byte aligned shared dst; completes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct Args {
  const unsigned char* ds;
  int64_t ds_bytes;
  float* out;
  int64_t count;       // gathered rows
  int64_t total;       // count * band
  int64_t row_bytes;   // H * W * C
  int64_t band_start;  // h0 * W * C
  int64_t band;        // (h1 - h0) * W * C
  int64_t tile;        // elements per tile, a multiple of 16
  int64_t n_tiles;
  double inv_band;     // 1 / band, for divisions without a divide
  float inv_band_f;
  float scale;
  float lo;
};

// n / band for 0 <= n < 2^52: the quotient through the reciprocal is off
// by at most one, which the remainder corrects.
__device__ __forceinline__ int64_t div_band(const Args& a, int64_t n) {
  int64_t q = static_cast<int64_t>(static_cast<double>(n) * a.inv_band);
  const int64_t r = n - q * a.band;
  if (r < 0) --q;
  else if (r >= a.band) ++q;
  return q;
}

// The same for n < band + kTileMax, in float: with a quotient under 2^20
// the float reciprocal is off by at most one too.
__device__ __forceinline__ uint32_t div_band32(const Args& a, uint32_t n,
                                               uint32_t band) {
  uint32_t q = __float2uint_rz(__uint2float_rz(n) * a.inv_band_f);
  const int32_t r = static_cast<int32_t>(n - q * band);
  if (r < 0) --q;
  else if (r >= static_cast<int32_t>(band)) ++q;
  return q;
}

// Warp 0 plans tile t into stage s: lane k takes the tile's k-th source
// row, issues the bulk copy of its granules and records where its bytes lie.
template <typename Index>
__device__ __forceinline__ void issue(const Args& a, const Index* idx,
                                      Smem& sm, int64_t t, int s) {
  const int lane = threadIdx.x;
  const int64_t p0 = t * a.tile;
  const int64_t r0 = div_band(a, p0);
  // the row index first: its load is the head of the copy's latency
  int64_t row = 0;
  if (r0 + lane < a.count) row = static_cast<int64_t>(__ldg(idx + r0 + lane));
  const int64_t len_tile = lesser(a.tile, a.total - p0);
  const int64_t j0 = p0 - r0 * a.band;
  const int64_t nseg = div_band(a, j0 + len_tile - 1) + 1;
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.ds);
  // ds's whole granules: the bulk copies stay inside [lo16, hi16)
  const uintptr_t lo16 = (base + 15) & ~uintptr_t(15);
  const uintptr_t hi16 = (base + a.ds_bytes) & ~uintptr_t(15);
  // tile elements [first, first + len) of this lane's row
  const int64_t first = lane == 0 ? 0 : lane * a.band - j0;
  const int64_t len =
      lane < nseg ? lesser((lane + 1) * a.band - j0, len_tile) - first : 0;
  const uintptr_t src =
      base + row * a.row_bytes + a.band_start + (lane == 0 ? j0 : 0);
  const uintptr_t f16 = src & ~uintptr_t(15);
  const uintptr_t c16 = (src + len + 15) & ~uintptr_t(15);
  const uint32_t at = static_cast<uint32_t>(48 * lane + ((first + 15) & ~15));
  const uintptr_t g0 = f16 > lo16 ? f16 : lo16;
  const uintptr_t g1 = lesser(c16, hi16);
  const uint32_t bytes =
      (lane < nseg && g1 > g0) ? static_cast<uint32_t>(g1 - g0) : 0u;
  unsigned char* stage = sm.buf[s];
  mbar_arrive_expect_tx(&sm.full[s], bytes);  // all 32 lanes arrive
  if (bytes) bulk_copy(stage + at + (g0 - f16), reinterpret_cast<void*>(g0),
                       bytes, &sm.full[s]);
  if (lane == 0) sm.j0[s] = static_cast<uint32_t>(j0);
  if (lane < nseg) {
    sm.off[s][lane] = static_cast<int>(at + (src - f16) - first);
    // the bytes of ds's own first and last granules (under 16 each)
    const uintptr_t end = src + len;
    const uintptr_t head = g1 > g0 ? lesser(end, g0) : end;
    for (uintptr_t x = src; x < head; ++x)
      stage[at + (x - f16)] = *reinterpret_cast<const unsigned char*>(x);
    if (g1 > g0)
      for (uintptr_t x = src > g1 ? src : g1; x < end; ++x)
        stage[at + (x - f16)] = *reinterpret_cast<const unsigned char*>(x);
  }
}

__device__ __forceinline__ float norm(uint32_t w, int byte, float scale,
                                      float lo) {
  return __fadd_rn(__fmul_rn(__uint2float_rn((w >> (8 * byte)) & 0xffu),
                             scale),
                   lo);
}

// out[j .. j + 3] from the four bytes of w, as a streaming (evict-first)
// store; the output's last vector is cut at len.
__device__ __forceinline__ void put(const Args& a, float* out, uint32_t j,
                                    uint32_t len, uint32_t w) {
  const float4 v = make_float4(norm(w, 0, a.scale, a.lo),
                               norm(w, 1, a.scale, a.lo),
                               norm(w, 2, a.scale, a.lo),
                               norm(w, 3, a.scale, a.lo));
  if (j + 3 < len) {
    __stcs(reinterpret_cast<float4*>(out + j), v);
  } else {
    out[j] = v.x;
    if (j + 1 < len) out[j + 1] = v.y;
    if (j + 2 < len) out[j + 2] = v.z;
  }
}

// All threads convert tile t from stage s: thread i writes the float4s at
// tile elements 4 * (i + m * kThreads).
__device__ __forceinline__ void convert(const Args& a, const Smem& sm,
                                        int64_t t, int s) {
  const int64_t p0 = t * a.tile;
  const uint32_t len_tile =
      static_cast<uint32_t>(lesser(a.tile, a.total - p0));
  const uint32_t band = static_cast<uint32_t>(a.band);
  const uint32_t j0 = sm.j0[s];
  const unsigned char* stage = sm.buf[s];
  const int* off = sm.off[s];
  float* out = a.out + p0;
  if (j0 + len_tile <= band && (off[0] & 3) == 0) {
    // the tile lies in one row, staged 4-byte aligned: one word a vector
    const uint32_t* words = reinterpret_cast<const uint32_t*>(stage + off[0]);
#pragma unroll 4
    for (uint32_t j = 4 * threadIdx.x; j < len_tile; j += 4 * kThreads) {
      put(a, out, j, len_tile, words[j / 4]);
    }
    return;
  }
#pragma unroll 4
  for (uint32_t j = 4 * threadIdx.x; j < len_tile; j += 4 * kThreads) {
    const uint32_t q = j0 + j;
    const uint32_t k = div_band32(a, q, band);  // the tile's row of j
    const uint32_t rem = q - k * band;          // j's place in that row
    uint32_t w;
    if (rem + 3 < band) {  // the four bytes lie in one row
      const uint32_t i = j + off[k];
      const uint32_t* p =
          reinterpret_cast<const uint32_t*>(stage + (i & ~3u));
      w = __funnelshift_r(p[0], p[1], 8 * (i & 3u));
    } else {  // a row ends inside the vector
      w = 0;
      uint32_t ke = k, re = rem;
#pragma unroll
      for (uint32_t e = 0; e < 4; ++e) {
        if (j + e < len_tile)
          w |= static_cast<uint32_t>(stage[j + e + off[ke]]) << (8 * e);
        if (++re == band) re = 0, ++ke;
      }
    }
    put(a, out, j, len_tile, w);
  }
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
    gather_u8_normalize_kernel(Args a, const Index* __restrict__ idx) {
  __shared__ Smem sm;
  // warp 0 sets up the barriers and starts the first tiles' copies; the
  // other warps meet it at the loop's first barrier
  const int64_t ahead = int64_t(kStages - 1) * gridDim.x;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 32);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    for (int m = 0; m < kStages - 1; ++m) {
      const int64_t t = blockIdx.x + int64_t(m) * gridDim.x;
      if (t < a.n_tiles) issue(a, idx, sm, t, m);
    }
  }
  uint32_t m = 0;
  for (int64_t t = blockIdx.x; t < a.n_tiles; t += gridDim.x, ++m) {
    // every thread is done with tile m - 1's stage, which tile
    // m + kStages - 1 reuses; warp 0's offsets and byte loads are visible
    __syncthreads();
    if (threadIdx.x < 32 && t + ahead < a.n_tiles)
      issue(a, idx, sm, t + ahead, (m + kStages - 1) % kStages);
    const int s = m % kStages;
    mbar_wait(&sm.full[s], (m / kStages) & 1);
    convert(a, sm, t, s);
  }
}

template <typename Index>
cudaError_t launch(const Args& a, const void* idx, int dev,
                   cudaStream_t stream) {
  static int blocks[64];  // resident blocks of all SMs, per device
  if (blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_u8_normalize_kernel<Index>, kThreads, 0);
    if (err != cudaSuccess) return err;
    blocks[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t grid = a.n_tiles < blocks[dev] ? a.n_tiles : blocks[dev];
  gather_u8_normalize_kernel<Index><<<static_cast<unsigned>(grid), kThreads,
                                      0, stream>>>(
      a, static_cast<const Index*>(idx));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[r * band + j] = float(ds[idx[r] * row_bytes + band_start + j]) * scale
// + lo, for r < count, j < band_bytes; ds holds ds_bytes bytes. idx holds
// count int32 (idx_bytes 4) or int64 (8) values, each a row of ds (not
// checked). All three lie on device dev; the kernel runs on stream, a
// stream of dev. Returns a cudaError_t: 0 when the launch was accepted.
int gather_u8_normalize(const void* ds, int64_t ds_bytes, const void* idx,
                        int64_t idx_bytes, void* out, int64_t count,
                        int64_t row_bytes, int64_t band_start,
                        int64_t band_bytes, float scale, float lo,
                        int64_t dev, void* stream) {
  if (count <= 0 || band_bytes <= 0) return 0;
  if (band_bytes >= (int64_t(1) << 30) || dev < 0 || dev >= 64 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (idx_bytes != 4 && idx_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.ds = static_cast<const unsigned char*>(ds);
  a.ds_bytes = ds_bytes;
  a.out = static_cast<float*>(out);
  a.count = count;
  a.total = count * band_bytes;
  a.row_bytes = row_bytes;
  a.band_start = band_start;
  a.band = band_bytes;
  // at most kMaxSeg source rows per tile: a tile of L elements spans at most
  // L / band + 2 rows
  const int64_t fit = (band_bytes * (kMaxSeg - 2)) & ~int64_t(15);
  a.tile = fit < kTileMax ? fit : kTileMax;
  a.n_tiles = (a.total + a.tile - 1) / a.tile;
  a.inv_band = 1.0 / static_cast<double>(band_bytes);
  a.inv_band_f = 1.0f / static_cast<float>(band_bytes);
  a.scale = scale;
  a.lo = lo;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = static_cast<int>(dev);
  err = idx_bytes == 8 ? launch<int64_t>(a, idx, d, s)
                       : launch<int32_t>(a, idx, d, s);
  if (prev != dev) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // extern "C"
