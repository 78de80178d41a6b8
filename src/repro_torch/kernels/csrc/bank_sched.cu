// FR-FCFS memory-system walk (Fig 19) for Hopper: one warp walks one trace.
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
// the whole-DIMM grid, one warp each.  Lane q < Q owns queue slot q; the bank
// state (open row, ready, precharge-ready, the (B, 6) cycle rows, bank->rank
// and bank->channel maps, bus per channel, last ACT and tFAW ring per rank)
// sits in shared memory, under 1 KB at B = 16.  The winner comes from three
// warp reductions (__reduce_max_sync / __reduce_min_sync) and a ballot; the
// trace index is unique per slot, so the order is total.  What the design
// does about the chain: the refill request does not depend on the winner
// (it is always request Q + step), so each lane holds requests a chunk of 32
// ahead in registers, loaded two chunks before use, and no device-memory load
// sits on the per-step chain; per-request (latency, hit) outputs are buffered
// one per lane and written 32 at a time, coalesced.  All arithmetic is int32,
// as in the reference: the kernel equals the plain walk bit for bit.

#include <cuda_runtime.h>
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
