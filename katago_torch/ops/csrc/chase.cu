// K1: greedy chase-ladder solver, one warp per lane.
//
// Replaces katago_tpu/ops/chase_pallas.py::chase_lanes (body _kernel_body);
// the semantic source is katago_tpu/game/ladder.py _chase_one / _chase_apply
// / _would_be_ko_capture_at, ported from that algorithm rather than from the
// Pallas layout. Every tie-break matches bit for bit: lowest flat index first
// ("first set" and the two lowest liberties), the defender's extension
// before its (<= 3) liberty-gaining captures with captures winning ties, and
// ko bans left by the last move only.
//
// Bound on an H100: a call's inputs are 3 x L x NN int32 (17.7 MB at the
// production L = 4096, NN = 361: about 5 us at 3.35 TB/s), but inactive
// lanes return at once and an active lane reads its board once; the rest is
// a data-dependent loop of dependent warp-wide scans (about 20 per ply, up to
// 4*size+14 plies), so a call is bound by the latency of its longest lane.
// The design does three things about it: each lane's board lives in shared
// memory for the whole solve (int8 stones, int16 labels and head liberties,
// 361 x 5 B = 1.8 KB, the narrowing of ladder.py:818-822); every per-board
// reduction (first set, counts, arr[loc] reads) is a warp collective
// (__reduce_min_sync / __reduce_add_sync / broadcast shared reads) with no
// block-wide barrier; and each warp exits as soon as its own lane is done,
// so one long ladder stalls no other lane. No padding of labels is needed:
// every label compare is on on-board points.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EMPTY = 0;
constexpr int WALL = 3;
constexpr int K_ADJ = 3;
constexpr int C_CAP = 4;
constexpr int WARPS = 4;  // lanes per block
constexpr unsigned FULL = 0xffffffffu;

struct Board {
  int8_t* st;
  int16_t* lab;
  int16_t* hl;
  int size;
  int nn;
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// neighbour of p in the JAX shift4 order (p+size, p-size, p+1, p-1); -1 when
// off-board
__device__ __forceinline__ int nbr(int p, int d, int size) {
  int y = p / size;
  int x = p - y * size;
  switch (d) {
    case 0: return y + 1 < size ? p + size : -1;
    case 1: return y > 0 ? p - size : -1;
    case 2: return x + 1 < size ? p + 1 : -1;
    default: return x > 0 ? p - 1 : -1;
  }
}

template <class F>
__device__ __forceinline__ bool adj_to(int p, int size, F f) {
  int y = p / size;
  int x = p - y * size;
  return (y + 1 < size && f(p + size)) || (y > 0 && f(p - size)) ||
         (x + 1 < size && f(p + 1)) || (x > 0 && f(p - 1));
}

// lowest p with f(p), nn if none (warp-uniform result)
template <class F>
__device__ __forceinline__ int wfirst(int nn, F f) {
  int best = nn;
  for (int p = lane_id(); p < nn; p += 32) {
    if (f(p)) {
      best = p;
      break;
    }
  }
  return __reduce_min_sync(FULL, best);
}

template <class F>
__device__ __forceinline__ int wcount(int nn, F f) {
  int c = 0;
  for (int p = lane_id(); p < nn; p += 32) c += f(p) ? 1 : 0;
  return __reduce_add_sync(FULL, c);
}

// _chase_apply's outcome, computed from the pre-move state without writing
struct Move {
  int m, player, opp;
  int nbr_l[4];
  bool own_sel[4], cap_sel[4], nbr_stone[4];
  int merged, my_libs, num_cap, ko_loc;
  bool legal, overflow;
};

__device__ Move analyze(const Board& b, int m, int player) {
  Move mv;
  const int nn = b.nn;
  mv.m = m;
  mv.player = player;
  mv.opp = 3 - player;
  mv.merged = m;
  bool own_any = false;
  for (int d = 0; d < 4; ++d) {
    int q = nbr(m, d, b.size);
    int s = q < 0 ? WALL : b.st[q];
    int l = q < 0 ? nn : b.lab[q];
    int lc = l < 0 ? 0 : (l > nn - 1 ? nn - 1 : l);
    int libs = b.hl[lc];
    mv.nbr_l[d] = l;
    mv.nbr_stone[d] = s == 1 || s == 2;
    mv.own_sel[d] = s == player;
    mv.cap_sel[d] = s == mv.opp && libs == 1;
    if (mv.own_sel[d]) mv.merged = min(mv.merged, l);
    own_any = own_any || mv.own_sel[d];
  }
  const Move& c = mv;
  auto own_mask = [&](int p) {
    if (b.st[p] != c.player) return false;
    int l = b.lab[p];
    return (c.own_sel[0] && l == c.nbr_l[0]) ||
           (c.own_sel[1] && l == c.nbr_l[1]) ||
           (c.own_sel[2] && l == c.nbr_l[2]) ||
           (c.own_sel[3] && l == c.nbr_l[3]);
  };
  auto cap_mask = [&](int p) {
    if (b.st[p] != c.opp) return false;
    int l = b.lab[p];
    return (c.cap_sel[0] && l == c.nbr_l[0]) ||
           (c.cap_sel[1] && l == c.nbr_l[1]) ||
           (c.cap_sel[2] && l == c.nbr_l[2]) ||
           (c.cap_sel[3] && l == c.nbr_l[3]);
  };
  auto my_mask = [&](int p) { return p == c.m || own_mask(p); };
  auto new_empty = [&](int p) {
    return p != c.m && (b.st[p] == EMPTY || cap_mask(p));
  };
  mv.my_libs = wcount(nn, [&](int p) {
    return new_empty(p) && adj_to(p, b.size, my_mask);
  });
  mv.num_cap = wcount(nn, cap_mask);
  int first_cap = wfirst(nn, cap_mask);
  bool is_ko = mv.num_cap == 1 && !own_any && mv.my_libs == 1;
  mv.ko_loc = is_ko ? first_cap : -1;
  mv.legal = b.st[m] == EMPTY && mv.my_libs > 0;
  mv.overflow = mv.num_cap > C_CAP;
  return mv;
}

// apply an analyzed move in place (labels and head liberties exact)
__device__ void commit(const Board& b, const Move& mv) {
  const int nn = b.nn;
  const int lane = lane_id();
  const Move& c = mv;
  auto own_mask = [&](int p) {
    if (b.st[p] != c.player) return false;
    int l = b.lab[p];
    return (c.own_sel[0] && l == c.nbr_l[0]) ||
           (c.own_sel[1] && l == c.nbr_l[1]) ||
           (c.own_sel[2] && l == c.nbr_l[2]) ||
           (c.own_sel[3] && l == c.nbr_l[3]);
  };
  auto cap_mask = [&](int p) {
    if (b.st[p] != c.opp) return false;
    int l = b.lab[p];
    return (c.cap_sel[0] && l == c.nbr_l[0]) ||
           (c.cap_sel[1] && l == c.nbr_l[1]) ||
           (c.cap_sel[2] && l == c.nbr_l[2]) ||
           (c.cap_sel[3] && l == c.nbr_l[3]);
  };
  // the (up to C_CAP) lowest captured points, from the pre-move state
  int cap_pts[C_CAP];
  int prev = -1;
  for (int t = 0; t < C_CAP; ++t) {
    int pv = prev;
    cap_pts[t] = wfirst(nn, [&](int p) { return p > pv && cap_mask(p); });
    prev = cap_pts[t] < nn ? cap_pts[t] : nn;
  }
  // masks of this lane's points, then the writes
  unsigned my_bits = 0, cap_bits = 0;
  for (int p = lane, i = 0; p < nn; p += 32, ++i) {
    if (p == c.m || own_mask(p)) my_bits |= 1u << i;
    if (cap_mask(p)) cap_bits |= 1u << i;
  }
  __syncwarp();
  for (int p = lane, i = 0; p < nn; p += 32, ++i) {
    bool mine = (my_bits >> i) & 1u;
    bool capd = (cap_bits >> i) & 1u;
    if (p == c.m) {
      b.st[p] = (int8_t)c.player;
    } else if (capd) {
      b.st[p] = EMPTY;
    }
    if (mine) {
      b.lab[p] = (int16_t)c.merged;
    } else if (capd) {
      b.lab[p] = (int16_t)p;
    }
  }
  __syncwarp();
  if (lane == 0) {
    // (a) surviving chains adjacent to m lose the liberty m
    for (int i = 0; i < 4; ++i) {
      bool dup = false;
      for (int j = 0; j < i; ++j)
        dup = dup || (c.nbr_l[j] == c.nbr_l[i] && c.nbr_stone[j]);
      if (c.nbr_stone[i] && !dup && !c.own_sel[i] && !c.cap_sel[i])
        b.hl[c.nbr_l[i]] -= 1;
    }
    // (b) chains bordering captured points gain those liberties
    for (int t = 0; t < C_CAP; ++t) {
      int cp = cap_pts[t];
      if (cp >= nn) continue;
      int cl[4];
      bool cs[4];
      for (int d = 0; d < 4; ++d) {
        int q = nbr(cp, d, b.size);
        int s = q < 0 ? WALL : b.st[q];
        cl[d] = q < 0 ? nn : b.lab[q];
        cs[d] = s == 1 || s == 2;
      }
      for (int i = 0; i < 4; ++i) {
        bool dup = false;
        for (int j = 0; j < i; ++j) dup = dup || (cl[j] == cl[i] && cs[j]);
        if (cs[i] && !dup && cl[i] != c.merged) b.hl[cl[i]] += 1;
      }
    }
    // (c) the mover's merged chain, recounted from its mask
    b.hl[c.merged] = (int16_t)c.my_libs;
  }
  __syncwarp();
}

// wouldBeKoCapture(loc, attacker): all neighbours defender-or-wall and
// exactly one adjacent single-stone defender chain in atari
__device__ bool would_be_ko_capture(const Board& b, int loc_raw,
                                    int defender) {
  const int nn = b.nn;
  int loc = loc_raw < 0 ? 0 : (loc_raw > nn - 1 ? nn - 1 : loc_raw);
  int ns[4], nl[4];
  bool all_def = true;
  for (int d = 0; d < 4; ++d) {
    int q = nbr(loc, d, b.size);
    ns[d] = q < 0 ? WALL : b.st[q];
    nl[d] = q < 0 ? nn : b.lab[q];
    all_def = all_def && (ns[d] == defender || ns[d] == WALL);
  }
  int cap_cnt = 0, single_cnt = 0;
  for (int i = 0; i < 4; ++i) {
    bool dup = false;
    for (int j = 0; j < i; ++j) dup = dup || (nl[j] == nl[i] && ns[j] == defender);
    bool isdef = ns[i] == defender && !dup;
    int lc = nl[i] < 0 ? 0 : (nl[i] > nn - 1 ? nn - 1 : nl[i]);
    bool in_atari = b.hl[lc] == 1;
    if (isdef && in_atari) {
      int li = nl[i];
      int sz = wcount(nn, [&](int p) {
        return b.lab[p] == li && b.st[p] == defender;
      });
      cap_cnt += 1;
      single_cnt += sz == 1 ? 1 : 0;
    }
  }
  return loc_raw < nn && all_def && cap_cnt == 1 && single_cnt == 1;
}

__device__ int imm_libs(const Board& b, int p) {
  int n = 0;
  for (int d = 0; d < 4; ++d) {
    int q = nbr(p, d, b.size);
    n += (q >= 0 && b.st[q] == EMPTY) ? 1 : 0;
  }
  return n;
}

__global__ void chase_kernel(const int* __restrict__ stones,
                             const int* __restrict__ labels,
                             const int* __restrict__ hlibs,
                             const int* __restrict__ rep_in,
                             const int* __restrict__ def_in,
                             const int* __restrict__ pre_in,
                             const int8_t* __restrict__ active,
                             int8_t* __restrict__ out, int lanes, int size,
                             int max_steps, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = lane_id();
  const int L = blockIdx.x * WARPS + warp;
  if (L >= lanes) return;
  if (!active[L]) {
    if (lane == 0) out[L] = 0;
    return;
  }
  const int nn = size * size;
  const int nn_al = (nn + 7) & ~7;
  unsigned char* base = smem + (size_t)warp * stride;
  Board b;
  b.lab = (int16_t*)base;
  b.hl = (int16_t*)(base + 2 * nn_al);
  b.st = (int8_t*)(base + 4 * nn_al);
  b.size = size;
  b.nn = nn;
  const long off = (long)L * nn;
  for (int p = lane; p < nn; p += 32) {
    b.st[p] = (int8_t)stones[off + p];
    b.lab[p] = (int16_t)labels[off + p];
    b.hl[p] = (int16_t)hlibs[off + p];
  }
  __syncwarp();

  const int rep = rep_in[L];
  const int def = def_in[L];
  const int att = 3 - def;
  const int pre = pre_in[L];
  if (pre >= 0) {
    Move mv = analyze(b, pre > nn - 1 ? nn - 1 : pre, att);
    if (!mv.legal || mv.overflow) {
      if (lane == 0) out[L] = 0;
      return;
    }
    commit(b, mv);
  }

  int ko = -1;
  bool done = false, captured = false;
  int ply = 0;
  while (ply < max_steps) {
    // =============== defender ply ===============
    {
      const int lrep = b.lab[rep];
      const bool gone = b.st[rep] != def;
      if (gone) {
        done = true;
        captured = true;
        break;
      }
      const int dlibs = b.hl[lrep];
      const bool term_esc = ko >= 0 || dlibs >= 2;
      auto def_mask = [&](int q) { return b.lab[q] == lrep && b.st[q] == def; };
      auto empty = [&](int q) { return b.st[q] == EMPTY; };
      auto libpt = [&](int p) { return empty(p) && adj_to(p, size, def_mask); };
      int ext = wfirst(nn, libpt);
      const bool any_lib = ext < nn;
      if (!any_lib) ext = 0;
      int best_est = -1;
      if (any_lib) {
        const int e = ext;
        best_est = wcount(nn, [&](int p) {
          return empty(p) && p != e &&
                 adj_to(p, size, [&](int q) { return def_mask(q) || q == e; });
        });
      }
      int best_move = ext;
      int removed[K_ADJ];
      int nrem = 0;
      for (int t = 0; t < K_ADJ; ++t) {
        const int nr = nrem;
        int p = wfirst(nn, [&](int q) {
          if (b.st[q] != att) return false;
          int l = b.lab[q];
          for (int r = 0; r < nr; ++r)
            if (l == removed[r]) return false;
          return adj_to(q, size, def_mask);
        });
        if (p >= nn) break;  // nothing left: later candidates are empty too
        const int lp = b.lab[p];
        removed[nrem++] = lp;
        auto chain_t = [&](int q) { return b.lab[q] == lp && b.st[q] == att; };
        const bool atari = b.hl[lp] == 1;
        if (!atari) continue;
        int ci = wfirst(nn, [&](int q) {
          return empty(q) && adj_to(q, size, chain_t);
        });
        if (ci >= nn || ci == ko) continue;
        const bool joins = adj_to(ci, size, def_mask);
        const int cc = ci;
        int est_t = wcount(nn, [&](int q) {
          return (empty(q) || chain_t(q)) && q != cc &&
                 adj_to(q, size, [&](int r) {
                   return def_mask(r) || (joins && r == cc);
                 });
        });
        if (est_t >= best_est) {
          best_est = est_t;
          best_move = ci;
        }
      }
      if (best_est < 0) {  // no defender move at all
        done = true;
        captured = true;
        break;
      }
      Move mv = analyze(b, best_move, def);
      const bool new_cap = !mv.legal;
      const bool new_esc = term_esc || (!new_cap && mv.overflow);
      if (new_cap || new_esc) {
        done = true;
        captured = new_cap;
        break;
      }
      commit(b, mv);
      ko = mv.ko_loc;
    }
    ++ply;
    if (ply >= max_steps) break;
    // =============== attacker ply ===============
    {
      const int lrep = b.lab[rep];
      const bool gone = b.st[rep] != def;
      const int dlibs = gone ? 0 : b.hl[lrep];
      if (gone || dlibs <= 1) {
        done = true;
        captured = true;
        break;
      }
      if (dlibs >= 3) {
        done = true;
        captured = false;
        break;
      }
      auto def_mask = [&](int q) { return b.lab[q] == lrep && b.st[q] == def; };
      auto empty = [&](int q) { return b.st[q] == EMPTY; };
      auto libpt = [&](int p) { return empty(p) && adj_to(p, size, def_mask); };
      const int l0 = wfirst(nn, libpt);
      const int l1 = wfirst(nn, [&](int p) { return p > l0 && libpt(p); });
      int l2[2] = {l0, l0 < nn ? l1 : nn};

      bool refuted[2];
      int est[2];
      for (int t = 0; t < 2; ++t) {
        const int li_raw = l2[t];
        const int lo_raw = l2[1 - t];
        const int li = li_raw > nn - 1 ? nn - 1 : li_raw;
        const int lo = lo_raw > nn - 1 ? nn - 1 : lo_raw;
        const bool valid = li_raw < nn && li_raw != ko;
        int all_[4];
        bool als_att[4];
        for (int d = 0; d < 4; ++d) {
          int q = nbr(li, d, size);
          int s = q < 0 ? WALL : b.st[q];
          all_[d] = q < 0 ? nn : b.lab[q];
          als_att[d] = s == att;
        }
        auto amask = [&](int p) {
          if (p == li) return true;
          if (b.st[p] != att) return false;
          int l = b.lab[p];
          return (als_att[0] && l == all_[0]) || (als_att[1] && l == all_[1]) ||
                 (als_att[2] && l == all_[2]) || (als_att[3] && l == all_[3]);
        };
        auto lone_a = [&](int p) {
          return empty(p) && p != li && adj_to(p, size, amask);
        };
        const int a_libs = wcount(nn, lone_a);
        const int est_ext2 = wcount(nn, [&](int p) {
          return empty(p) && p != li && p != lo &&
                 adj_to(p, size, [&](int q) { return def_mask(q) || q == lo; });
        });
        int est_cap2 = 0;
        if (a_libs == 1) {
          int ca = wfirst(nn, lone_a);
          if (ca >= nn) ca = 0;
          const bool joins_a = adj_to(ca, size, def_mask);
          const int cc = ca;
          est_cap2 = wcount(nn, [&](int p) {
            return (empty(p) || amask(p)) && p != li && p != cc &&
                   adj_to(p, size, [&](int q) {
                     return def_mask(q) || (joins_a && q == cc);
                   });
          });
        }
        const int est_def = max(est_ext2, a_libs == 1 ? est_cap2 : 0);
        refuted[t] = !valid || a_libs < 1 || est_def >= 3;
        est[t] = est_def;
      }
      const bool both_ref = refuted[0] && refuted[1];
      const bool pick1 = !refuted[1] && (refuted[0] || est[1] < est[0]);
      int att_move = pick1 ? l2[1] : l2[0];
      if (att_move > nn - 1) att_move = nn - 1;

      bool double_ko = false;
      if (l2[0] < nn && l2[1] < nn && imm_libs(b, l2[0]) == 0 &&
          imm_libs(b, l2[1]) == 0) {
        double_ko = would_be_ko_capture(b, l2[0], def) &&
                    would_be_ko_capture(b, l2[1], def);
      }
      Move mv = analyze(b, att_move, att);
      const bool new_esc = both_ref || mv.overflow;
      const bool new_cap = !new_esc && double_ko;
      if (new_cap || new_esc) {
        done = true;
        captured = new_cap;
        break;
      }
      commit(b, mv);
      ko = mv.ko_loc;
    }
    ++ply;
  }
  if (lane == 0) out[L] = (done && captured) ? 1 : 0;
}

}  // namespace

extern "C" int chase_lanes_launch(const void* stones, const void* labels,
                                  const void* hlibs, const void* rep,
                                  const void* defender, const void* premove,
                                  const void* active, void* out, int lanes,
                                  int size, int max_steps, void* stream) {
  const int nn = size * size;
  const int nn_al = (nn + 7) & ~7;
  const int stride = (5 * nn_al + 15) & ~15;
  const int blocks = (lanes + WARPS - 1) / WARPS;
  const size_t shmem = (size_t)WARPS * stride;
  chase_kernel<<<blocks, WARPS * 32, shmem, (cudaStream_t)stream>>>(
      (const int*)stones, (const int*)labels, (const int*)hlibs,
      (const int*)rep, (const int*)defender, (const int*)premove,
      (const int8_t*)active, (int8_t*)out, lanes, size, max_steps, stride);
  return (int)cudaGetLastError();
}
