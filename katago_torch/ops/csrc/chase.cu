// K1: greedy chase-ladder solver, one warp per lane, the lane's board held
// as row bitmasks in registers.
//
// Replaces katago_tpu/ops/chase_pallas.py::chase_lanes (body _kernel_body);
// the semantic source is katago_tpu/game/ladder.py _chase_one / _chase_apply
// / _would_be_ko_capture_at, ported from that algorithm rather than from the
// Pallas layout. Every tie-break matches bit for bit: lowest flat index first
// ("first set" and the two lowest liberties), the defender's extension
// before its (<= 3) liberty-gaining captures with captures winning ties, ko
// bans left by the last move only, a defender extension that is suicide
// counting as captured even after an escape, an attacker move reported
// illegal still played, and more than C_CAP = 4 captured stones bailing the
// lane as escaped.
//
// Bound on an H100: the function needs only the active lanes' stones
// (labels and hlibs are their analysis), read once: about 3000 of the main
// path's L = 4096 lanes at NN = 361, 4.4 MB, about 1.3 us at 3.35 TB/s.
// The rest is a data-dependent loop of dependent board queries (about 20-40
// per ply, up to 4*size+14 plies), so a call is bound by the latency of its
// longest lane: the number of dependent steps per query is what the design
// has to cut. The first design kept the board in shared memory and answered
// each query with a strided scan of all 361 points (12 deep, each point
// testing up to four neighbours through shared loads): thousands of
// dependent loads per ply.
//
// This design holds the lane's position as bitmasks: row y of the board,
// `size` bits, in thread y of the warp (threads past the board hold 0) —
// the attacker's stones A, the defender's D, and the defender chain C that
// contains the lane's representative stone, kept exactly from move to move
// (a defender move that touches C makes C its merged chain; an attacker move
// removes C's stones if it captures them). Then a query is a few
// instructions and one or two warp collectives:
//   - 4-neighbour dilation: (r << 1) | (r >> 1) within the row, OR'd with
//     the rows above and below from __shfl_up_sync / __shfl_down_sync;
//   - first set: __reduce_min_sync of y * size + __ffs(r) - 1, the lowest
//     flat index, which keeps every tie-break;
//   - counts: __reduce_add_sync of __popc(r);
//   - a chain's mask: flood fill from a seed, each round filling whole
//     horizontal runs at once ((((c + s) ^ c) | s) & c, and the same on the
//     bit-reversed row) and stepping one row up and down, until __any_sync
//     sees no change; so a round costs two shuffles and a vote, and the
//     rounds follow the chain's turns between rows, not its length;
//   - liberties of a chain: popc(dilate(chain) & empty).
// No labels and no liberty counts are carried: a chain's identity is its
// mask, and its liberties are counted when needed, so the kernel reads
// only `stones` and needs no shared memory. Each warp returns as soon as
// its own lane is decided, so one long ladder stalls no other lane. Tensor
// cores, TMA and shared-memory tiling have nothing to do here: the work is
// a chain of small dependent bit operations, whose latency is all there is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_ADJ = 3;
constexpr int C_CAP = 4;
constexpr int WARPS = 4;  // lanes per block
constexpr unsigned FULL = 0xffffffffu;

// The lane's geometry as seen by one thread: y is the thread's row, `row`
// the bits of a full row there (0 past the board's edge).
struct Geo {
  int size, nn, y;
  unsigned row;
};

__device__ __forceinline__ bool any(unsigned r) {
  return __any_sync(FULL, r != 0);
}

__device__ __forceinline__ int count(unsigned r) {
  return __reduce_add_sync(FULL, __popc(r));
}

// lowest flat index set in the board mask, nn when none
__device__ __forceinline__ int first(const Geo& g, unsigned r) {
  return __reduce_min_sync(FULL, r ? g.y * g.size + __ffs(r) - 1 : g.nn);
}

// this thread's row of the one-point mask of p (0 <= p < nn)
__device__ __forceinline__ unsigned bit(const Geo& g, int p) {
  const int py = p / g.size;
  return py == g.y ? 1u << (p - py * g.size) : 0u;
}

// the 4-neighbours of p (p itself excluded), without a shuffle
__device__ __forceinline__ unsigned dil_pt(const Geo& g, int p) {
  const int py = p / g.size;
  const unsigned b = 1u << (p - py * g.size);
  unsigned r = 0;
  if (g.y == py) r = (b << 1) | (b >> 1);
  if (g.y == py - 1 || g.y == py + 1) r = b;
  return r & g.row;
}

// rows y-1 and y+1 of a mask, 0 past the warp's ends
__device__ __forceinline__ unsigned vert(const Geo& g, unsigned r) {
  unsigned up = __shfl_up_sync(FULL, r, 1);
  unsigned dn = __shfl_down_sync(FULL, r, 1);
  if (g.y == 0) up = 0;
  if (g.y == 31) dn = 0;
  return up | dn;
}

// 4-neighbour dilation (the mask's own points only where they neighbour
// another point of it)
__device__ __forceinline__ unsigned dil(const Geo& g, unsigned r) {
  return ((r << 1) | (r >> 1) | vert(g, r)) & g.row;
}

// bits of c in a run (of c) that holds a bit of s at or below them
__device__ __forceinline__ unsigned run_up(unsigned c, unsigned s) {
  return (((c + s) ^ c) | s) & c;
}

// the runs of c that hold a bit of s, whole
__device__ __forceinline__ unsigned hfill(unsigned c, unsigned s) {
  s &= c;
  return run_up(c, s) | __brev(run_up(__brev(c), __brev(s)));
}

// the union of the chains of colour c that hold a bit of seed
__device__ unsigned flood(const Geo& g, unsigned c, unsigned seed) {
  if (!any(seed & c)) return 0;
  unsigned m = hfill(c, seed);
  while (true) {
    const unsigned nm = hfill(c, m | vert(g, m));
    if (!__any_sync(FULL, nm != m)) return m;
    m = nm;
  }
}

// _chase_apply's outcome for the player whose stones are P (opponent O, empty
// E) at m, from the pre-move position. kP / kO: a whole chain of P's / O's
// colour already known (or 0), used instead of flooding it again.
struct Move {
  unsigned mine;      // the mover's chain after the move (m included)
  unsigned cap;       // the stones it captures
  int my_libs, ko_loc;
  bool legal, overflow, joins_kp;
};

__device__ Move analyze(const Geo& g, unsigned P, unsigned O, unsigned E,
                        int m, unsigned kP, unsigned kO) {
  Move mv;
  const unsigned mb = bit(g, m);
  const unsigned nb = dil_pt(g, m);
  mv.joins_kp = any(nb & kP);
  const bool own_any = any(nb & P);
  const unsigned rest = P & ~kP;
  mv.mine = mb | (mv.joins_kp ? kP : 0u) | flood(g, rest, nb);
  // adjacent opponent chains with a single liberty (which is m)
  unsigned cap = 0;
  unsigned t = nb & O;
  while (any(t)) {
    const unsigned qb = bit(g, first(g, t));
    const unsigned ch = any(kO & qb) ? kO : flood(g, O, qb);
    if (count(dil(g, ch) & E) == 1) cap |= ch;
    t &= ~ch;
  }
  mv.cap = cap;
  mv.my_libs = count(dil(g, mv.mine) & (E | cap) & ~mb);
  const int num_cap = count(cap);
  mv.ko_loc = (num_cap == 1 && !own_any && mv.my_libs == 1) ? first(g, cap)
                                                             : -1;
  mv.legal = any(E & mb) && mv.my_libs > 0;
  mv.overflow = num_cap > C_CAP;
  return mv;
}

// wouldBeKoCapture(loc, attacker): every neighbour the defender's or the
// wall, and exactly one adjacent defender chain in atari, a single stone
__device__ bool would_be_ko_capture(const Geo& g, unsigned D, unsigned E,
                                    unsigned C, int loc_raw) {
  const int loc = loc_raw < 0 ? 0 : min(loc_raw, g.nn - 1);
  const unsigned nb = dil_pt(g, loc);
  if (any(nb & ~D)) return false;
  int cap_cnt = 0, single_cnt = 0;
  unsigned t = nb & D;
  while (any(t)) {
    const unsigned qb = bit(g, first(g, t));
    const unsigned ch = any(C & qb) ? C : flood(g, D, qb);
    t &= ~ch;
    if (count(dil(g, ch) & E) == 1) {
      cap_cnt += 1;
      single_cnt += count(ch) == 1 ? 1 : 0;
    }
  }
  return loc_raw < g.nn && cap_cnt == 1 && single_cnt == 1;
}

__global__ void chase_kernel(const int* __restrict__ stones,
                             const int* __restrict__ rep_in,
                             const int* __restrict__ def_in,
                             const int* __restrict__ pre_in,
                             const uint8_t* __restrict__ active,
                             uint8_t* __restrict__ out, int lanes, int size,
                             int max_steps) {
  const int lane = threadIdx.x & 31;
  const int L = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (L >= lanes) return;
  if (!active[L]) {
    if (lane == 0) out[L] = 0;
    return;
  }
  Geo g;
  g.size = size;
  g.nn = size * size;
  g.y = lane;
  g.row = lane < size ? (size == 32 ? FULL : (1u << size) - 1u) : 0u;
  const int nn = g.nn;
  const int def = def_in[L];
  const int att = 3 - def;
  const int rep = rep_in[L];
  const int pre = pre_in[L];

  // the board as flat bitmaps by ballot (thread k keeps word k), then each
  // thread cuts its row out of the two words that hold it
  unsigned wd = 0, wa = 0;
  const long off = (long)L * nn;
  for (int k = 0; k * 32 < nn; ++k) {
    const int p = k * 32 + lane;
    const int s = p < nn ? stones[off + p] : 0;
    const unsigned bd = __ballot_sync(FULL, s == def);
    const unsigned ba = __ballot_sync(FULL, s == att);
    if (lane == k) {
      wd = bd;
      wa = ba;
    }
  }
  const int start = lane < size ? lane * size : 0;
  const int w0 = start >> 5;
  const int w1 = min(w0 + 1, 31);
  const int sh = start & 31;
  const unsigned d0 = __shfl_sync(FULL, wd, w0);
  const unsigned d1 = __shfl_sync(FULL, wd, w1);
  const unsigned a0 = __shfl_sync(FULL, wa, w0);
  const unsigned a1 = __shfl_sync(FULL, wa, w1);
  unsigned D = __funnelshift_r(d0, d1, sh) & g.row;
  unsigned A = __funnelshift_r(a0, a1, sh) & g.row;
  const unsigned repb = bit(g, rep);
  unsigned C = flood(g, D, repb);

  if (pre >= 0) {
    const Move mv = analyze(g, A, D, g.row & ~(A | D), min(pre, nn - 1), 0u,
                            C);
    if (!mv.legal || mv.overflow) {
      if (lane == 0) out[L] = 0;
      return;
    }
    A |= mv.mine;
    D &= ~mv.cap;
    C &= ~mv.cap;
  }

  int ko = -1;
  bool captured = false;
  int ply = 0;
  while (ply < max_steps) {
    // =============== defender ply ===============
    {
      if (!any(D & repb)) {  // the chain is gone
        captured = true;
        break;
      }
      const unsigned E = g.row & ~(A | D);
      const unsigned dC = dil(g, C);
      const unsigned libpts = E & dC;
      const int dlibs = count(libpts);
      const bool term_esc = ko >= 0 || dlibs >= 2;
      int ext = first(g, libpts);
      const bool any_lib = ext < nn;
      if (!any_lib) ext = 0;
      int best_est = -1;
      if (any_lib)
        best_est = count(E & ~bit(g, ext) & (dC | dil_pt(g, ext)));
      int best_move = ext;
      unsigned rem = A & dC;
      for (int t = 0; t < K_ADJ; ++t) {
        const int p = first(g, rem);
        if (p >= nn) break;  // nothing left: later candidates are empty too
        const unsigned ch = flood(g, A, bit(g, p));
        rem &= ~ch;
        const unsigned lone = E & dil(g, ch);
        if (count(lone) != 1) continue;  // not in atari
        const int ci = first(g, lone);
        if (ci == ko) continue;
        const bool joins = any(dC & bit(g, ci));
        const int est_t = count((E | ch) & ~bit(g, ci) &
                                (dC | (joins ? dil_pt(g, ci) : 0u)));
        if (est_t >= best_est) {
          best_est = est_t;
          best_move = ci;
        }
      }
      if (best_est < 0) {  // no defender move at all
        captured = true;
        break;
      }
      const Move mv = analyze(g, D, A, E, best_move, C, 0u);
      if (!mv.legal) {  // suicide counts as captured, even after an escape
        captured = true;
        break;
      }
      if (term_esc || mv.overflow) break;
      D |= mv.mine;
      A &= ~mv.cap;
      if (mv.joins_kp) C = mv.mine;
      ko = mv.ko_loc;
    }
    ++ply;
    if (ply >= max_steps) break;
    // =============== attacker ply ===============
    {
      if (!any(D & repb)) {
        captured = true;
        break;
      }
      const unsigned E = g.row & ~(A | D);
      const unsigned dC = dil(g, C);
      const unsigned libpts = E & dC;
      const int dlibs = count(libpts);
      if (dlibs <= 1) {
        captured = true;
        break;
      }
      if (dlibs >= 3) break;  // escaped
      const int l0 = first(g, libpts);
      const int l1 = first(g, libpts & ~bit(g, l0));
      const int l2[2] = {l0, l0 < nn ? l1 : nn};

      bool refuted[2];
      int est[2];
      for (int t = 0; t < 2; ++t) {
        const int li = min(l2[t], nn - 1);
        const int lo = min(l2[1 - t], nn - 1);
        const bool valid = l2[t] < nn && l2[t] != ko;
        const unsigned lib = bit(g, li);
        const unsigned amask = lib | flood(g, A, dil_pt(g, li));
        const unsigned lone_a = E & ~lib & dil(g, amask);
        const int a_libs = count(lone_a);
        const int est_ext2 =
            count(E & ~lib & ~bit(g, lo) & (dC | dil_pt(g, lo)));
        int est_cap2 = 0;
        if (a_libs == 1) {
          const int ca = first(g, lone_a);
          const bool joins_a = any(dC & bit(g, ca));
          est_cap2 = count((E | amask) & ~lib & ~bit(g, ca) &
                           (dC | (joins_a ? dil_pt(g, ca) : 0u)));
        }
        const int est_def = max(est_ext2, est_cap2);
        refuted[t] = !valid || a_libs < 1 || est_def >= 3;
        est[t] = est_def;
      }
      const bool both_ref = refuted[0] && refuted[1];
      const bool pick1 = !refuted[1] && (refuted[0] || est[1] < est[0]);
      const int att_move = min(pick1 ? l2[1] : l2[0], nn - 1);

      bool double_ko = false;
      if (l2[0] < nn && l2[1] < nn && count(dil_pt(g, l2[0]) & E) == 0 &&
          count(dil_pt(g, l2[1]) & E) == 0) {
        double_ko = would_be_ko_capture(g, D, E, C, l2[0]) &&
                    would_be_ko_capture(g, D, E, C, l2[1]);
      }
      const Move mv = analyze(g, A, D, E, att_move, 0u, C);
      if (both_ref || mv.overflow) break;  // escaped
      if (double_ko) {
        captured = true;
        break;
      }
      // played even when analyze calls it illegal
      A |= mv.mine;
      D &= ~mv.cap;
      C &= ~mv.cap;
      ko = mv.ko_loc;
    }
    ++ply;
  }
  if (lane == 0) out[L] = captured ? 1 : 0;
}

}  // namespace

extern "C" int chase_lanes_launch(const void* stones, const void* rep,
                                  const void* defender, const void* premove,
                                  const void* active, void* out, int lanes,
                                  int size, int max_steps, void* stream) {
  const int blocks = (lanes + WARPS - 1) / WARPS;
  chase_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int*)stones, (const int*)rep, (const int*)defender,
      (const int*)premove, (const uint8_t*)active, (uint8_t*)out, lanes, size,
      max_steps);
  return (int)cudaGetLastError();
}
