// Batched affine-gap Smith-Waterman scoring for NVIDIA Hopper (sm_90a),
// called from JAX through the XLA FFI (breakmer_tpu/ops/sw_cuda.py).
//
// Contract: that of breakmer_tpu/ops/sw.py:sw_score, bit for bit.
//   q [..., Lq] and t [..., Lt] int8 base codes, code >= 4 is pad/N;
//   score, q_end, t_end [...] int32: the best H cell, ties broken by the
//   smallest anti-diagonal i + j and then the smallest i; (0, -1, -1)
//   when no cell is positive. A gap of length g costs open + extend * g.
//
// Layout: one warp per (query, target) pair. Lane k holds query rows
// [32R*tile + kR, 32R*tile + kR + R) in registers and walks the target
// one column per step, lagging lane k-1 by one step, so that the row
// above its first row (H and F of lane k-1's last row) arrives by
// __shfl_up_sync. A query longer than 32R rows is swept in tiles; the
// last row of each tile is carried to the next through the `carry`
// buffer, one (H, F) pair per target column.
//
// Each cell is three DPX instructions plus a compare-select and two adds:
//   E = __viaddmax_s32(E, -ge, Hg_left)        max(E - ge, H(i,j-1) - go)
//   F = __viaddmax_s32(F, -ge, Hg_up)          max(F - ge, H(i-1,j) - go)
//   H = __vimax3_s32_relu(Hg_diag + sg, E, F)  max(H(i-1,j-1) + sub, E, F, 0)
// with Hg = H - go stored in place of H and sg = sub + go, so that the
// diagonal term needs no extra add.
//
// Boundary values differ from the scan's where they cannot be observed:
// E(i, 0) and F(0, j) start at -go instead of a large negative number.
// Both are below zero, lose to the zero floor of H(i, 0) and H(0, j), and
// from the next cell on E and F equal the scan's because H >= 0 and
// extend >= 0 (the dispatcher only calls this kernel when open >= 0 and
// extend >= 0).

#include <climits>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
// query code of a pad/N row: equal to no target code
constexpr int kBadQ = 14;

struct Scoring {
  int mg;  // match + go: the diagonal term on a match
  int xg;  // go - mismatch: the diagonal term on a mismatch
  int go;  // gap_open + gap_extend: the first gapped base
  int ge;  // gap_extend
};

struct Best {
  int s, d, i;
};

__device__ __forceinline__ bool better(int s, int d, int i, const Best& b) {
  return s > b.s || (s == b.s && (d < b.d || (d == b.d && i < b.i)));
}

template <int R>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
sw_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
          int64_t n_pairs, int Lq, int Lt, Scoring p,
          int32_t* __restrict__ out_score, int32_t* __restrict__ out_qend,
          int32_t* __restrict__ out_tend, int2* __restrict__ carry) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_pairs) return;  // uniform across the warp
  const int8_t* qb = q + b * Lq;
  const int8_t* tb = t + b * Lt;
  int2* cb = carry + b * Lt;
  constexpr int kRows = kWarp * R;
  const int n_tiles = (Lq + kRows - 1) / kRows;
  Best best{0, INT_MAX, INT_MAX};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int row0 = tile * kRows + lane * R;
    int qv[R], qx[R], hg[R], e[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + r;
      const int c = i < Lq ? qb[i] : 4;
      const bool bad = c >= 4;
      qv[r] = bad ? kBadQ : c;
      qx[r] = bad ? kNeg : p.xg;
      hg[r] = -p.go;  // H(i, -1) = 0
      e[r] = kNeg;
    }
    const bool from_carry = lane == 0 && tile > 0;
    const bool to_carry = lane == kWarp - 1 && tile + 1 < n_tiles;
    // what this lane hands the lane below after each step: its last
    // row's Hg and F, or the empty top boundary while it is idle
    int pub_hg = -p.go, pub_f = kNeg;
    int diag = -p.go;  // Hg of the row above at the previous column
    int tc_next = lane == 0 ? tb[0] : 4;
    for (int s = 0; s < Lt + kWarp - 1; ++s) {
      const int j = s - lane;
      int up_hg = __shfl_up_sync(kFull, pub_hg, 1);
      int up_f = __shfl_up_sync(kFull, pub_f, 1);
      if (lane == 0) {
        up_hg = -p.go;  // H(-1, j) = 0
        up_f = kNeg;
        if (from_carry && j < Lt) {
          const int2 c = cb[j];
          up_hg = c.x;
          up_f = c.y;
        }
      }
      const int tc = tc_next;
      tc_next = (j + 1 >= 0 && j + 1 < Lt) ? tb[j + 1] : 4;
      if (j >= 0 && j < Lt) {
        int f = up_f, hup = up_hg, dg = diag, cmax = 0;
        if (tc < 4) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int h_left = hg[r];
            const int ev = __viaddmax_s32(e[r], -p.ge, h_left);
            f = __viaddmax_s32(f, -p.ge, hup);
            const int sg = qv[r] == tc ? p.mg : qx[r];
            const int h = __vimax3_s32_relu(dg + sg, ev, f);
            e[r] = ev;
            dg = h_left;
            hup = h - p.go;
            hg[r] = hup;
            cmax = max(cmax, h);
          }
        } else {
          // pad/N target column: no diagonal term
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int ev = __viaddmax_s32(e[r], -p.ge, hg[r]);
            f = __viaddmax_s32(f, -p.ge, hup);
            const int h = __vimax_s32_relu(ev, f);
            e[r] = ev;
            hup = h - p.go;
            hg[r] = hup;
            cmax = max(cmax, h);
          }
        }
        pub_hg = hup;
        pub_f = f;
        if (to_carry) cb[j] = make_int2(hup, f);
        if (cmax > 0 && cmax >= best.s) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int i = row0 + r;
            const int h = hg[r] + p.go;
            if (i < Lq && better(h, i + j, i, best)) best = Best{h, i + j, i};
          }
        }
      } else {
        pub_hg = -p.go;
        pub_f = kNeg;
      }
      diag = up_hg;
    }
    // the next tile's lane 0 reads what this tile's lane 31 wrote
    __syncwarp();
  }

#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const int s2 = __shfl_xor_sync(kFull, best.s, off);
    const int d2 = __shfl_xor_sync(kFull, best.d, off);
    const int i2 = __shfl_xor_sync(kFull, best.i, off);
    if (better(s2, d2, i2, best)) best = Best{s2, d2, i2};
  }
  if (lane == 0) {
    const bool none = best.s <= 0;
    out_score[b] = none ? 0 : best.s;
    out_qend[b] = none ? -1 : best.i;
    out_tend[b] = none ? -1 : best.d - best.i;
  }
}

template <int R>
void launch(cudaStream_t stream, const int8_t* q, const int8_t* t,
            int64_t n_pairs, int Lq, int Lt, Scoring p, int32_t* score,
            int32_t* qend, int32_t* tend, int2* carry) {
  const int64_t blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sw_kernel<R><<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock, 0,
                 stream>>>(q, t, n_pairs, Lq, Lt, p, score, qend, tend, carry);
}

// Rows each lane holds: the query tiers 128/256/512/1024 fill one tile;
// longer queries are tiled at 1024 rows.
int rows_per_lane(int64_t Lq) {
  return Lq <= 128 ? 4 : Lq <= 256 ? 8 : Lq <= 512 ? 16 : 32;
}

}  // namespace

static ffi::Error SwScore(cudaStream_t stream, ffi::Buffer<ffi::S8> q,
                          ffi::Buffer<ffi::S8> t,
                          ffi::ResultBuffer<ffi::S32> score,
                          ffi::ResultBuffer<ffi::S32> q_end,
                          ffi::ResultBuffer<ffi::S32> t_end,
                          ffi::ResultBuffer<ffi::S32> carry, int32_t match,
                          int32_t mismatch, int32_t gap_open,
                          int32_t gap_extend) {
  const auto qd = q.dimensions();
  const auto td = t.dimensions();
  if (qd.size() < 1 || td.size() < 1)
    return ffi::Error::InvalidArgument("sw: q and t need a length axis");
  const int64_t Lq = qd.back(), Lt = td.back();
  if (Lq < 1 || Lt < 1 || Lq > INT_MAX / 2 || Lt > INT_MAX / 2)
    return ffi::Error::InvalidArgument("sw: lengths out of range");
  const int64_t n_pairs = q.element_count() / Lq;
  if (static_cast<int64_t>(t.element_count()) / Lt != n_pairs ||
      static_cast<int64_t>(score->element_count()) != n_pairs)
    return ffi::Error::InvalidArgument("sw: batch sizes disagree");
  const int R = rows_per_lane(Lq);
  if (Lq > kWarp * R &&
      static_cast<int64_t>(carry->element_count()) < 2 * n_pairs * Lt)
    return ffi::Error::InvalidArgument("sw: carry buffer too small");
  if (n_pairs == 0) return ffi::Error::Success();
  const int go = gap_open + gap_extend;
  const Scoring p{match + go, go - mismatch, go, gap_extend};
  auto* c2 = reinterpret_cast<int2*>(carry->typed_data());
  const int8_t* qp = q.typed_data();
  const int8_t* tp = t.typed_data();
  int32_t *sp = score->typed_data(), *qe = q_end->typed_data(),
          *te = t_end->typed_data();
  const int lq = static_cast<int>(Lq), lt = static_cast<int>(Lt);
  switch (R) {
    case 4: launch<4>(stream, qp, tp, n_pairs, lq, lt, p, sp, qe, te, c2); break;
    case 8: launch<8>(stream, qp, tp, n_pairs, lq, lt, p, sp, qe, te, c2); break;
    case 16: launch<16>(stream, qp, tp, n_pairs, lq, lt, p, sp, qe, te, c2); break;
    default: launch<32>(stream, qp, tp, n_pairs, lq, lt, p, sp, qe, te, c2); break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sw kernel launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(BreakmerSwScore, SwScore,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend"));
