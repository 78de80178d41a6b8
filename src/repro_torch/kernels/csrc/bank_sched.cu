// FR-FCFS memory-system walk (Fig 19) for Hopper: a warp, or half of one,
// walks one trace.
//
// Replaces the Pallas TPU kernel repro/kernels/bank_sched.py::bank_sched
// (:138, pl.pallas_call at :172) and the walk around it,
// repro/memsim/sim.py::_scan_sim (:344), a lax.scan that calls the kernel
// once per serviced request, vmapped over (timing table x workload).  Here
// the request loop lives inside the kernel: a launch per step would be
// 20,000 steps x (one kernel + ~30 eager ops) per grid.
//
// Work: every step scores the Q queued requests of a walk against its bank
// state (candidate_times, the same int32 formula as the plain version in
// kernels/bank_sched.py), picks the lexicographic winner (max key, then min
// arrive, then min trace index), updates bank, bus, last-ACT and the sorted
// four-entry tFAW ring, and refills the winner's slot with the next request.
//
// Bound: each step depends on the one before it, so a walk is a serial chain
// of n dependent steps, and that chain, not the card's operation or byte rate,
// sets the time: the work of a whole Fig 19 grid is ~6e9 int32 operations
// (under 0.4 ms at the card's int32 rate) and ~190 MB of output.
// The parallelism is the walks: one per (table, workload), 97 x 12 = 1,164 on
// the whole-DIMM grid, about 9 an SM.  So the design shortens the latency of
// one step, and the instructions the walks sharing an SM issue.  Two kernels:
//
// fast_walk_kernel, for B, R, C <= 32, arrivals nondecreasing along each
// trace and n < 2^25 (the wrapper checks; memsim's traces always qualify):
// - One reduction picks the winner.  With arrivals nondecreasing in the
//   trace index, the slot of max key and then min index also has the min
//   arrival among those, so the lexicographic winner is the max of one
//   packed word: key (2 bits), 2^25 - 1 - index (25 bits), lane (5 bits).
//   Invalid slots pack to 0 and never win (a valid slot exists at every
//   step).  In-order walks (Q = 1) have their own instantiation with no
//   reduction: slot 0 always wins.
// - The bank state lives in registers: lane b holds bank b's open row,
//   ready and precharge-ready times and its cycle row, lane r rank r's last
//   ACT and sorted tFAW ring, lane c channel c's bus time.  A slot reads its
//   bank's state with independent __shfl_syncs; the winner's (bank, rank,
//   channel, hit), row, done, new_pre, t_act, t_col and latency reach every
//   lane in one round of shuffles, and the owning lanes update in place: no
//   shared-memory store, __syncwarp and reload on the chain.
// - A request's static terms (its bank's tRP/tRCD/tRAS/tWR cycles, tCL or
//   tCWL by write, its rank and channel) are looked up once, when the chunk
//   of 32 prefetched requests that holds it moves into shared memory; a step
//   reads its refill, which does not depend on the winner, with two 16-byte
//   broadcast loads.
// - The configuration (bus, activation window, Q == 1) is a template
//   argument: no run-time branch on it sits on the chain.
// - Where Q, B, R and C are at most 16 (Fig 19's configurations), 16 lanes
//   walk a trace and a warp walks two: the shuffles take width 16, each walk
//   has its own reduction, and the warps issue half the instructions.
// - A block is kWarps warps (kFastWarps, 1), each walking its own traces.
//
// walk_kernel, the general one, for what the fast one does not take (B up to
// 512, R and C up to 64, arrivals that decrease, n >= 2^25): lane q < Q owns
// queue slot q; the bank state sits in shared memory (under 1 KB at B = 16);
// the winner comes from three warp reductions and a ballot.
//
// Both load the refill requests in chunks of 32 into registers, two chunks
// before use, so no device-memory load sits on the per-step chain, and
// buffer the per-request (latency, hit) outputs one per lane, written 32 at a
// time, coalesced.  All arithmetic is int32, as in the reference: each kernel
// equals the plain walk bit for bit.

#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 30;
constexpr int kNeg = -1000000;

struct Cfg {
  int n, Q, B, R, C, tbl, trrd, tfaw, use_bus, use_act;
};

struct Req {
  int bank, row, write, arrive;
};

__device__ __forceinline__ Req load_req(const int* __restrict__ tr, long long i, int n) {
  const int* p = tr + 4 * (i < n ? i : n - 1);  // the reference clamps at n - 1
  return Req{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}

// ---- the general kernel

__global__ void __launch_bounds__(32) walk_kernel(const int* __restrict__ traces,
                                                  const int* __restrict__ tc,
                                                  int* __restrict__ lat_out,
                                                  int* __restrict__ hit_out, int W, Cfg cfg) {
  extern __shared__ int smem[];
  const int B = cfg.B, R = cfg.R, C = cfg.C, n = cfg.n, Q = cfg.Q;
  int* s_open = smem;
  int* s_ready = s_open + B;
  int* s_pre = s_ready + B;
  int* s_tc = s_pre + B;  // (B, 6): tRCD tRAS tRP tWR tCL tCWL
  int* s_rank = s_tc + 6 * B;
  int* s_chan = s_rank + B;
  int* s_bus = s_chan + B;  // (C,)
  int* s_last = s_bus + C;  // (R,)
  int* s_faw = s_last + R;  // (R, 4), each row sorted ascending

  const int lane = threadIdx.x;
  const long long walk = blockIdx.x;  // t * W + w
  const int t = static_cast<int>(walk / W), w = static_cast<int>(walk % W);
  const int* tr = traces + 4LL * w * n;
  const int* tct = tc + 6LL * t * B;
  for (int b = lane; b < B; b += 32) {
    s_open[b] = -1;
    s_ready[b] = 0;
    s_pre[b] = kNeg;
    s_rank[b] = (b / C) % R;
    s_chan[b] = b % C;
  }
  for (int i = lane; i < 6 * B; i += 32) s_tc[i] = tct[i];
  for (int c = lane; c < C; c += 32) s_bus[c] = 0;
  for (int r = lane; r < R; r += 32) s_last[r] = kNeg;
  for (int i = lane; i < 4 * R; i += 32) s_faw[i] = kNeg;
  __syncwarp();

  // this lane's queue slot
  const bool slot = lane < Q;
  Req q = slot ? load_req(tr, lane, n) : Req{0, 0, 0, 0};
  int q_idx = slot ? lane : kBig;
  bool q_valid = slot;
  // refill requests Q + step: lane j holds request Q + 32k + j of chunk k
  Req cur = load_req(tr, static_cast<long long>(Q) + lane, n);
  Req nxt = load_req(tr, static_cast<long long>(Q) + 32 + lane, n);
  int t_now = 0, buf_lat = 0, buf_hit = 0;
  const long long out0 = walk * n;

  for (int s = 0; s < n; ++s) {
    // ---- candidate_times for this lane's slot
    int key = -1, hit = 0, t_act = 0, t_col = 0, done = 0, new_pre = 0, lat = 0;
    if (slot) {
      const int b = q.bank;
      const int* row = s_tc + 6 * b;
      const int rdy = s_ready[b], prer = s_pre[b];
      const int start = max(q.arrive, rdy);
      hit = s_open[b] == q.row;
      t_act = max(start, prer) + row[2];
      if (cfg.use_act) {
        const int r = s_rank[b];
        t_act = max(t_act, max(s_last[r] + cfg.trrd, s_faw[4 * r] + cfg.tfaw));
      }
      t_col = hit ? start : t_act + row[0];
      const bool is_wr = q.write == 1;
      const int data_av = t_col + (is_wr ? row[5] : row[4]);
      done = cfg.use_bus ? max(data_av, s_bus[s_chan[b]]) + cfg.tbl : data_av;
      lat = done - q.arrive;
      const int base_pre = hit ? prer : t_act + row[1];
      new_pre = is_wr ? max(base_pre, done + row[3]) : base_pre;
      const int elig = q.arrive <= t_now;
      key = q_valid ? 1 + elig * (1 + hit) : 0;
    }
    __syncwarp();  // every lane has read the state the winner overwrites

    // ---- lexicographic winner: max key, then min arrive, then min trace idx
    const int kmax = __reduce_max_sync(kFull, key);
    const bool c1 = slot && key == kmax;
    const int amin = __reduce_min_sync(kFull, c1 ? q.arrive : kBig);
    const bool c2 = c1 && q.arrive == amin;
    const int imin = __reduce_min_sync(kFull, c2 ? q_idx : kBig);
    const int wl = __ffs(__ballot_sync(kFull, c2 && q_idx == imin)) - 1;

    if (lane == wl) {
      const int b = q.bank;
      s_open[b] = q.row;
      s_ready[b] = done;
      s_pre[b] = new_pre;
      if (cfg.use_bus) s_bus[s_chan[b]] = done;
      if (cfg.use_act && !hit) {
        const int r = s_rank[b];
        s_last[r] = max(s_last[r], t_act);
        // drop the oldest ACT, insert t_act into the sorted ring[1..3]
        int* ring = s_faw + 4 * r;
        const int a0 = ring[1], a1 = ring[2], a2 = ring[3];
        const int v3 = max(a2, t_act);
        int y = min(a2, t_act);
        const int v2 = max(a1, y);
        y = min(a1, y);
        ring[0] = min(a0, y);
        ring[1] = max(a0, y);
        ring[2] = v2;
        ring[3] = v3;
      }
    }
    t_now = max(t_now, __shfl_sync(kFull, t_col, wl));
    const int wlat = __shfl_sync(kFull, lat, wl);
    const int whit = __shfl_sync(kFull, hit, wl);

    // ---- outputs, one per lane, written 32 at a time
    const int j = s & 31;
    if (lane == j) {
      buf_lat = wlat;
      buf_hit = whit;
    }
    if ((j == 31 || s == n - 1) && lane <= j) {
      lat_out[out0 + s - j + lane] = buf_lat;
      hit_out[out0 + s - j + lane] = buf_hit;
    }

    // ---- refill the winner's slot with request Q + s (prefetched in lane j)
    const Req r{__shfl_sync(kFull, cur.bank, j), __shfl_sync(kFull, cur.row, j),
                __shfl_sync(kFull, cur.write, j), __shfl_sync(kFull, cur.arrive, j)};
    if (lane == wl) {
      q = r;
      q_idx = Q + s;
      q_valid = Q + s < n;
    }
    if (j == 31) {
      cur = nxt;
      nxt = load_req(tr, static_cast<long long>(Q) + s + 33 + lane, n);
    }
    __syncwarp();  // the winner's state writes are visible to the next step
  }
}

// ---- the fast kernel

constexpr int kIdxBits = 25;                       // trace indices below 2^25
constexpr unsigned kIdxTop = (1u << kIdxBits) - 1u;
// warps a block of the fast walk (the kernel's kWarps): 2 and 4 ran within 5%
// of 1 on the H100, ahead in some runs and behind in others
constexpr int kFastWarps = 1;

struct FastCfg {
  int n, Q, B, R, C, tbl, trrd, tfaw;
};

// A queued request with its bank's static terms.  meta packs bank (bits 0-4),
// rank (5-9), channel (10-14) and write (15).
struct __align__(16) Slot {
  int meta, row, arrive, trp, trcd, tras, twr, tcol;
};

// Slot of request r, whose bank's cycle row, rank and channel lane r.bank of
// the walk's kWidth lanes holds; every lane of the warp calls it.
template <int kWidth>
__device__ __forceinline__ Slot promote(const Req& r, const int (&b_tc)[6], int b_rank,
                                        int b_chan) {
  const int b = r.bank;
  const bool is_wr = r.write == 1;
  const int rank = __shfl_sync(kFull, b_rank, b, kWidth);
  const int chan = __shfl_sync(kFull, b_chan, b, kWidth);
  const int tcl = __shfl_sync(kFull, b_tc[4], b, kWidth);
  const int tcwl = __shfl_sync(kFull, b_tc[5], b, kWidth);
  return Slot{b | (rank << 5) | (chan << 10) | (static_cast<int>(is_wr) << 15), r.row,
              r.arrive, __shfl_sync(kFull, b_tc[2], b, kWidth),
              __shfl_sync(kFull, b_tc[0], b, kWidth), __shfl_sync(kFull, b_tc[1], b, kWidth),
              __shfl_sync(kFull, b_tc[3], b, kWidth), is_wr ? tcwl : tcl};
}

// kWidth lanes walk one trace: 32 (one walk a warp) or 16 (two walks a warp,
// for Q, B, R, C <= 16, which halves the instructions the walks issue);
// kWarps warps a block.
template <int kWidth, bool kBus, bool kAct, bool kOne, int kWarps>
__global__ void __launch_bounds__(32 * kWarps) fast_walk_kernel(const int* __restrict__ traces,
                                                                const int* __restrict__ tc,
                                                                int* __restrict__ lat_out,
                                                                int* __restrict__ hit_out,
                                                                int W, int walks, FastCfg cfg) {
  constexpr int kWalks = 32 / kWidth;   // walks a warp
  const int n = cfg.n, Q = cfg.Q;
  // the thread's index in its warp, and its warp's in the block
  const unsigned tx = kWarps == 1 ? threadIdx.x : threadIdx.x % 32;
  const int warp = kWarps == 1 ? 0 : static_cast<int>(threadIdx.x / 32);
  const long long first = (static_cast<long long>(blockIdx.x) * kWarps + warp) * kWalks;
  if (kWarps > 1 && first >= walks) return;   // a whole warp past the last walk
  const int lane = tx % kWidth;
  const int half = kWalks == 1 ? 0 : static_cast<int>(tx) / kWidth;
  const long long walk0 = first + half;
  const bool live = walk0 < walks;          // a walk past the last repeats it, storing nothing
  const long long walk = live ? walk0 : walks - 1;   // t * W + w
  const int t = static_cast<int>(walk / W), w = static_cast<int>(walk % W);
  const int* tr = traces + 4LL * w * n;
  const int* tct = tc + 6LL * t * cfg.B;

  // lane b: bank b; lane r: rank r; lane c: channel c (lanes past B, R, C
  // hold state nobody reads)
  int b_tc[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) b_tc[k] = lane < cfg.B ? __ldg(tct + 6 * lane + k) : 0;
  const int b_rank = (lane / cfg.C) % cfg.R, b_chan = lane % cfg.C;
  int b_open = -1, b_ready = 0, b_pre = kNeg;
  int r_last = kNeg, f0 = kNeg, f1 = kNeg, f2 = kNeg, f3 = kNeg;  // ring, ascending
  int c_bus = 0;

  // this lane's queue slot
  Slot q = promote<kWidth>(load_req(tr, lane < Q ? lane : 0, n), b_tc, b_rank, b_chan);
  int q_idx = lane;
  bool q_valid = lane < Q;
  // refill requests Q + step, a chunk of kWidth Slots in shared memory (two
  // buffers), the next chunk prefetched in registers: lane j loads request
  // Q + kWidth * k + j of chunk k
  __shared__ Slot s_chunk[kWarps][kWalks][2][kWidth];
  s_chunk[warp][half][0][lane] = promote<kWidth>(load_req(tr, static_cast<long long>(Q) + lane, n),
                                           b_tc, b_rank, b_chan);
  __syncwarp();
  Req nxt = load_req(tr, static_cast<long long>(Q) + kWidth + lane, n);
  int t_now = 0, buf_lat = 0, buf_hit = 0;
  const long long out0 = walk * n;

  for (int s = 0; s < n; ++s) {
    const int j = s % kWidth, chunk = s / kWidth;
    // the refill (request Q + s) does not depend on the winner: two 16-byte
    // broadcast loads
    const Slot refill = s_chunk[warp][half][chunk & 1][j];

    // ---- candidate_times for this lane's slot
    const int bank = q.meta & 31;
    const int orow = __shfl_sync(kFull, b_open, bank, kWidth);
    const int rdy = __shfl_sync(kFull, b_ready, bank, kWidth);
    const int prer = __shfl_sync(kFull, b_pre, bank, kWidth);
    int la = 0, fo = 0, bus = 0;
    if (kAct) {
      const int rank = (q.meta >> 5) & 31;
      la = __shfl_sync(kFull, r_last, rank, kWidth);
      fo = __shfl_sync(kFull, f0, rank, kWidth);
    }
    if (kBus) bus = __shfl_sync(kFull, c_bus, (q.meta >> 10) & 31, kWidth);
    const int start = max(q.arrive, rdy);
    const int hit = orow == q.row;
    int t_act = max(start, prer) + q.trp;
    if (kAct) t_act = max(t_act, max(la + cfg.trrd, fo + cfg.tfaw));
    const int t_col = hit ? start : t_act + q.trcd;
    const int data_av = t_col + q.tcol;
    const int done = kBus ? max(data_av, bus) + cfg.tbl : data_av;
    const int lat = done - q.arrive;
    const int base_pre = hit ? prer : t_act + q.tras;
    const int new_pre = (q.meta >> 15) ? max(base_pre, done + q.twr) : base_pre;

    // ---- the winner: max key, then min trace index (= min arrive, then
    // min index, for nondecreasing arrivals)
    int wl = 0;
    if (!kOne) {
      const unsigned key = 1u + (q.arrive <= t_now) * (1u + hit);
      const unsigned packed =
          q_valid ? (key << 30) | ((kIdxTop - static_cast<unsigned>(q_idx)) << 5) | lane : 0u;
      unsigned m;
      if (kWalks == 1) {
        m = __reduce_max_sync(kFull, packed);
      } else {   // each walk's own maximum: one reduction a walk
        const unsigned m0 = __reduce_max_sync(kFull, half == 0 ? packed : 0u);
        const unsigned m1 = __reduce_max_sync(kFull, half == 1 ? packed : 0u);
        m = half ? m1 : m0;
      }
      wl = static_cast<int>(m & 31u);
    }
    const int wm = __shfl_sync(kFull, (q.meta & 0x7fff) | (hit << 15), wl, kWidth);
    const int wrow = __shfl_sync(kFull, q.row, wl, kWidth);
    const int wdone = __shfl_sync(kFull, done, wl, kWidth);
    const int wpre = __shfl_sync(kFull, new_pre, wl, kWidth);
    const int wcol = __shfl_sync(kFull, t_col, wl, kWidth);
    const int wlat = __shfl_sync(kFull, lat, wl, kWidth);
    const int wact = kAct ? __shfl_sync(kFull, t_act, wl, kWidth) : 0;
    const int whit = wm >> 15;

    // ---- the owning lanes update
    if (lane == (wm & 31)) {
      b_open = wrow;
      b_ready = wdone;
      b_pre = wpre;
    }
    if (kBus && lane == ((wm >> 10) & 31)) c_bus = wdone;
    if (kAct && !whit && lane == ((wm >> 5) & 31)) {
      r_last = max(r_last, wact);
      // drop the oldest ACT, insert t_act into the sorted ring[1..3]
      const int v3 = max(f3, wact);
      int y = min(f3, wact);
      const int v2 = max(f2, y);
      y = min(f2, y);
      f0 = min(f1, y);
      f1 = max(f1, y);
      f2 = v2;
      f3 = v3;
    }
    t_now = max(t_now, wcol);

    // ---- outputs, one per lane, written kWidth at a time
    if (lane == j) {
      buf_lat = wlat;
      buf_hit = whit;
    }
    if ((j == kWidth - 1 || s == n - 1) && lane <= j && live) {
      lat_out[out0 + s - j + lane] = buf_lat;
      hit_out[out0 + s - j + lane] = buf_hit;
    }

    // ---- refill the winner's slot with request Q + s
    if (lane == wl) {
      q = refill;
      q_idx = Q + s;
      q_valid = Q + s < n;
    }
    if (j == kWidth - 1) {
      __syncwarp();   // every lane has read the buffer it overwrites
      s_chunk[warp][half][(chunk + 1) & 1][lane] = promote<kWidth>(nxt, b_tc, b_rank, b_chan);
      __syncwarp();
      nxt = load_req(tr, static_cast<long long>(Q) + s + kWidth + 1 + lane, n);
    }
  }
}

template <bool kBus, bool kAct, int kWarps>
int launch_fast(const int* traces, const int* tc, int* lat, int* hit, int walks, int W,
                const FastCfg& cfg, cudaStream_t stream) {
  const bool narrow = cfg.Q <= 16 && cfg.B <= 16 && cfg.R <= 16 && cfg.C <= 16;
  const long long per_block = (narrow ? 2LL : 1LL) * kWarps;   // walks a block
  const unsigned blocks = static_cast<unsigned>((walks + per_block - 1) / per_block);
#define WALK(kWidth, kOne)                                                                  \
  fast_walk_kernel<kWidth, kBus, kAct, kOne, kWarps><<<blocks, 32 * kWarps, 0, stream>>>( \
      traces, tc, lat, hit, W, walks, cfg)
  if (narrow) {
    if (cfg.Q == 1) WALK(16, true); else WALK(16, false);
  } else {
    if (cfg.Q == 1) WALK(32, true); else WALK(32, false);
  }
#undef WALK
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  `traces` is (W, n, 4) contiguous int32
// [bank, row, write, arrive] with every bank in [0, B); `tc` is (T, B, 6)
// contiguous int32 cycle rows; `lat` and `hit` are (T, W, n) int32 outputs in
// service order.  1 <= Q <= min(32, n); B, R, C bound the shared memory
// (11 B + C + 5 R ints; the wrapper checks the limits).  Launches on `stream`
// (PyTorch's current stream) and returns cudaGetLastError() as an int:
// non-zero means nothing ran.
extern "C" int bank_sched_walk_launch(const int* traces, const int* tc, int* lat, int* hit,
                                      int T, int W, int n, int Q, int B, int R, int C, int tbl,
                                      int trrd, int tfaw, int use_bus, int use_act,
                                      void* stream) {
  if (T <= 0 || W <= 0 || n <= 0) return 0;
  if (Q < 1 || Q > 32 || Q > n || B < 1 || R < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Cfg cfg{n, Q, B, R, C, tbl, trrd, tfaw, use_bus, use_act};
  const size_t smem = static_cast<size_t>(11 * B + C + 5 * R) * sizeof(int);
  walk_kernel<<<static_cast<unsigned>(T) * static_cast<unsigned>(W), 32, smem,
                static_cast<cudaStream_t>(stream)>>>(traces, tc, lat, hit, W, cfg);
  return static_cast<int>(cudaGetLastError());
}

// The fast kernel's entry point: the same arguments, for B, R, C <= 32,
// arrivals nondecreasing along each trace and n < 2^25 (the wrapper checks
// the arrivals; here the sizes).
extern "C" int bank_sched_fast_launch(const int* traces, const int* tc, int* lat, int* hit,
                                      int T, int W, int n, int Q, int B, int R, int C, int tbl,
                                      int trrd, int tfaw, int use_bus, int use_act,
                                      void* stream) {
  if (T <= 0 || W <= 0 || n <= 0) return 0;
  if (Q < 1 || Q > 32 || Q > n || B < 1 || R < 1 || C < 1 || B > 32 || R > 32 || C > 32 ||
      n > static_cast<int>(kIdxTop))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(T) * W > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const FastCfg cfg{n, Q, B, R, C, tbl, trrd, tfaw};
  const int walks = T * W;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bus && use_act)
    return launch_fast<true, true, kFastWarps>(traces, tc, lat, hit, walks, W, cfg, s);
  if (use_bus) return launch_fast<true, false, kFastWarps>(traces, tc, lat, hit, walks, W, cfg, s);
  if (use_act) return launch_fast<false, true, kFastWarps>(traces, tc, lat, hit, walks, W, cfg, s);
  return launch_fast<false, false, kFastWarps>(traces, tc, lat, hit, walks, W, cfg, s);
}
