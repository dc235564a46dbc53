"""K3 (the exact solvability tier) and K7 (regen, whose exact tier runs
K3's body) against another commit's, with variants, timed on the card in
turns.

    python3 scripts_dev/torch_k3_parts.py [--parent DIR] [--out FILE]

Compiles this tree's `bbx_torch/csrc/solvable_exact.cu` and `regen.cu`,
variants of them (each in its own copy of `csrc/`, edited by exact
strings, `verdict.cuh` among the files a variant may edit), and with
`--parent DIR` (a checkout of another commit, e.g. unpacked from `git
archive`) that commit's two sources with its own headers, into
`build/k3_parts/`, each with its ptxas registers and spills.  The inputs
are `chip_smoke.py`'s: K3 on its mid-game boards and their valid3 at one
lane, at the lanes the disjoint tier leaves of 4,096 and at all 4,096; K7
on the engine step's inputs (16,384 lanes).  Each variant runs each of its
kernel's cases in turns (the list, then the list reversed): its output
against the plain version (bit for bit), its time between CUDA events over
back-to-back calls (`ms`) and its kernel's device time by `torch.profiler`
(`device_ms`).  The variants:
  k3_warps_8, k3_warps_16, k3_warps_32  K3 with 8, 16 or 32 lanes (warps)
                      a block (4; at 32 its rows in dynamic shared memory);
  k3_block_64, k3_block_128  K3 with a block of 2 or 4 warps a lane, which
                      vote with __syncthreads_or after each round of 64 or
                      128 items;
  k3_place_global     K3 reading the PLACE rows at the pieces' ids from
                      global memory instead of staging them;
  k3_la_loops, k7_la_loops  `bb_line_anchors` by a loop over the rows and
                      columns, a popcount each, instead of SWAR;
  k3_unroll2, k7_unroll2  the walk two candidates an iteration;
  k3_all_candidates, k7_all_candidates  the search walking every valid a2,
                      with no pruning by `bb_line_anchors` (the parent's
                      search);
  k3_nc_shared, k3_nc_l2, k7_nc_shared, k7_nc_l2  the search with the
                      NO_CONFLICT shortcut (an a2 whose placement completes
                      no line is a hit iff fit(b1, third) & NO_CONFLICT[j,
                      h][a2]: one AND for a clear and a fit), the rows of
                      the draw's six ordered pairs staged in shared memory
                      (K3: the warp's slice; K7: 3 KB of dynamic shared
                      memory a warp, for each rejected draw) or read from
                      L2; K3's table address comes by `bbx_exact_set_nc`;
  k3_nc_shared_all    k3_nc_shared walking every valid a2 (the shortcut
                      without the pruning);
  k3_flat             K3 with the candidates (order, a1, a2) of each round's
                      32 items flattened over the warp: each thread runs
                      stage 1 of its item, a prefix sum of the items'
                      candidate counts by shuffles, then the warp takes
                      the round's candidates 32 at a time, each thread
                      finding its item by a binary search of the sums;
  k3_empty            K3 returning at once (a launch of the same grid);
  k7_exact_oracle     K7 whose exact tier returns at once with the answer
                      of a table the plain version computed beforehand
                      (`exact_oracle`): the same draws and rounds without
                      the exact search, so K7's time less this variant's is
                      the exact tier's share;
  k7_exact_accept, k7_exact_reject  K7 whose exact tier returns at once,
                      accepting or rejecting every draw the disjoint tier
                      rejects (fewer or more draws than K7 makes).
The results of `k3_empty`, `k7_exact_accept` and `k7_exact_reject` are
wrong by design.  The
script stops when an edit's string is gone from the source.  Needs a CUDA
card.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from bbx_torch.engine import solvability as S  # noqa: E402
from bbx_torch.engine import state as ES  # noqa: E402
from bbx_torch.engine.tables import tables  # noqa: E402
from bbx_torch.ops import build  # noqa: E402

EXACT = "solvable_exact.cu"
REGEN = "regen.cu"
VERDICT = "verdict.cuh"

# The search walking every valid a2, with no pruning by `bb_line_anchors`
# (the parent's search in this tree's kernels).
ALL_CANDIDATES = [
    ("    if (bb_fit(b1, shift3, aok3) == 0) f2 &= bb_line_anchors(b1, shift2, aok2, span2);\n",
     "")]

# The NO_CONFLICT shortcut: the search takes the row NO_CONFLICT[j, h] of
# its pair (second, third), and an a2 whose placement completes no line is
# a hit iff fit(b1, h) & row[a2] (one AND for a clear and a fit).
SHORTCUT = [
    ("                                               u64 aok3, Stop stop) {\n",
     "                                               u64 aok3, const u64* nc23, Stop stop) {\n"),
    ("    if (bb_fit(b1, shift3, aok3) == 0) f2 &= bb_line_anchors(b1, shift2, aok2, span2);\n",
     "    const u64 f3 = bb_fit(b1, shift3, aok3);\n"
     "    if (f3 == 0) f2 &= bb_line_anchors(b1, shift2, aok2, span2);\n"),
    ("        if (bb_fit(bb_clear_lines(b1 | place2[a2]), shift3, aok3)) return 1;\n",
     "        const u64 b2 = b1 | place2[a2];\n"
     "        if ((bb_full_rows(b2) | bb_full_cols(b2)) == 0 ? (f3 & nc23[a2]) != 0\n"
     "                                                    : bb_fit(bb_clear_lines(b2), shift3,\n"
     "                                                             aok3) != 0)\n"
     "            return 1;\n"),
]

# The shortcut with every valid a2 walked (no pruning by `bb_line_anchors`).
SHORTCUT_ALL = [SHORTCUT[0],
                (SHORTCUT[1][0], "    const u64 f3 = bb_fit(b1, shift3, aok3);\n"),
                SHORTCUT[2]]

# K3 with the shortcut: the table's address set by `bbx_exact_set_nc`.
K3_NC_TABLE = ("// Warp thread l copies its share of the rows",
               "__device__ const u64* exact_nc;  // NO_CONFLICT_U64\n"
               "extern \"C\" int bbx_exact_set_nc(const void* p) {\n"
               "#ifdef BBX_EMULATE\n"
               "    exact_nc = (const u64*)p;\n"
               "#else\n"
               "    cudaMemcpyToSymbol(exact_nc, &p, sizeof(p));\n"
               "#endif\n"
               "    return (int)cudaGetLastError();\n"
               "}\n\n"
               "// Warp thread l copies its share of the rows")
K3_SEARCH_END = "                                  s->place[j], s->shift[h], s->aok[h], [] { return false; });\n"
K3_NC_ROW = "exact_nc + (size_t)(id[j] * BB_NUM_PIECES + id[h]) * BB_ANCHORS"


def k3_shortcut(row):
    return K3_SEARCH_END.replace("s->aok[h], [] {", f"s->aok[h], {row},\n"
                                 "                                  [] {")


# ... the six rows of the triple's ordered pairs staged in the warp's slice
# (nc[o] for order o), or read from L2 in the walk.
K3_NC_SHARED = [
    K3_NC_TABLE,
    ("    u64 place[3][BB_ANCHORS];\n", "    u64 place[3][BB_ANCHORS];\n    u64 nc[6][BB_ANCHORS];\n"),
    ("    if (l < 3 * BB_SHIFTS)\n",
     "    for (int o = 0; o < 6; ++o) {\n"
     "        int i, j, h;\n"
     "        bb_exact_order(o, &i, &j, &h);\n"
     f"        ((uint4*)s->nc[o])[l] = __ldg((const uint4*)({K3_NC_ROW}) + l);\n"
     "    }\n"
     "    if (l < 3 * BB_SHIFTS)\n"),
    (K3_SEARCH_END, k3_shortcut("s->nc[o]")),
]
K3_NC_L2 = [K3_NC_TABLE, (K3_SEARCH_END, k3_shortcut(K3_NC_ROW))]

# K3 reading the PLACE rows at the pieces' ids from global memory (L1)
# instead of staging them.
K3_PLACE_GLOBAL = [
    ("#pragma unroll\n    for (int r = 0; r < 3; ++r)\n"
     "        ((uint4*)s->place[r])[l] = __ldg((const uint4*)(place + (size_t)id[r] * BB_ANCHORS) + l);\n",
     ""),
    ("            hit = bb_exact_search(a1, board, s->place[i], s->shift[j], s->aok[j], s->span[j],\n"
     "                                  s->place[j], s->shift[h],",
     "            hit = bb_exact_search(a1, board, (const u64*)place + id[i] * BB_ANCHORS,\n"
     "                                  s->shift[j], s->aok[j], s->span[j],\n"
     "                                  (const u64*)place + id[j] * BB_ANCHORS, s->shift[h],"),
]

K3_LOOP = """    bool found = false;
    for (int base = 0; base < items && !found; base += 32) {
        int hit = 0;
        if (base + l < items) {
            int o, a1, i, j, h;
            bb_exact_item(base + l, m[0], m[1], m[2], &o, &a1);
            bb_exact_order(o, &i, &j, &h);
            hit = bb_exact_search(a1, board, s->place[i], s->shift[j], s->aok[j], s->span[j],
                                  s->place[j], s->shift[h], s->aok[h], [] { return false; });
        }
        found = __any_sync(BB_FULL_WARP, hit);
    }
"""
FLAT = [(K3_LOOP, """    bool found = false;
    auto sh64 = [](u64 x, int src) {
        return (u64)__shfl_sync(BB_FULL_WARP, (unsigned)x, src) |
               (u64)__shfl_sync(BB_FULL_WARP, (unsigned)(x >> 32), src) << 32;
    };
    for (int base = 0; base < items && !found; base += 32) {
        int o = 0;
        u64 b1 = 0, f2 = 0;
        if (base + l < items) {
            int a1, i, j, h;
            bb_exact_item(base + l, m[0], m[1], m[2], &o, &a1);
            bb_exact_order(o, &i, &j, &h);
            b1 = bb_clear_lines(board | s->place[i][a1]);
            f2 = bb_fit(b1, s->shift[j], s->aok[j]);
            if (bb_fit(b1, s->shift[h], s->aok[h]) == 0)
                f2 &= bb_line_anchors(b1, s->shift[j], s->aok[j], s->span[j]);
        }
        const int n = BB_POPC(f2);
        int incl = n;
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_sync(BB_FULL_WARP, (unsigned)incl, l >= d ? l - d : l);
            if (l >= d) incl += up;
        }
        const int total = __shfl_sync(BB_FULL_WARP, (unsigned)incl, 31);
        for (int c0 = 0; c0 < total && !found; c0 += 32) {
            const int c = c0 + l;
            int q = 0;
            for (int step = 16; step >= 1; step >>= 1)
                if ((int)__shfl_sync(BB_FULL_WARP, (unsigned)incl, q + step - 1) <= c) q += step;
            const u64 qb1 = sh64(b1, q), qf2 = sh64(f2, q);
            const int qo = __shfl_sync(BB_FULL_WARP, (unsigned)o, q);
            const int qexcl = (int)__shfl_sync(BB_FULL_WARP, (unsigned)incl, q) -
                              (int)__shfl_sync(BB_FULL_WARP, (unsigned)n, q);
            int hit = 0;
            if (c < total) {
                int i, j, h;
                bb_exact_order(qo, &i, &j, &h);
                const int a2 = bb_nth_bit(qf2, c - qexcl);
                hit = bb_fit(bb_clear_lines(qb1 | s->place[j][a2]), s->shift[h], s->aok[h]) != 0;
            }
            found = __any_sync(BB_FULL_WARP, hit);
        }
    }
""")]

K3_LAUNCH = ("        BBX_LAUNCH(exact_kernel, (k + EXACT_WARPS - 1) / EXACT_WARPS, 32 * EXACT_WARPS,"
             " stream,\n")

# K3's rows in dynamic shared memory, for 32 warps a block (53.8 KB).
K3_DYNAMIC = [
    ("    __shared__ exact_rows s_rows[EXACT_WARPS];\n",
     "    BBX_DYNAMIC_SHARED(smem);\n    exact_rows* s_rows = (exact_rows*)smem;\n"),
    ("    if (k > 0)\n" + K3_LAUNCH,
     "    const int smem = EXACT_WARPS * (int)sizeof(exact_rows);\n"
     "    if (const int err = (int)cudaFuncSetAttribute(\n"
     "            exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))\n"
     "        return err;\n"
     "    if (k > 0)\n"
     "        BBX_LAUNCH_SMEM(exact_kernel, (k + EXACT_WARPS - 1) / EXACT_WARPS,"
     " 32 * EXACT_WARPS, smem, stream,\n"),
]


# K3 with a block of LANE threads a lane (2 or 4 warps): items l, l + LANE,
# ...; the block votes with __syncthreads_or after each round, warp 0
# stages the rows.
def k3_block(lane_threads):
    return [
        ("    const int l = threadIdx.x & 31, w = threadIdx.x >> 5;\n"
         "    const int lane = blockIdx.x * EXACT_WARPS + w;\n"
         "    if (lane >= k) return;  // a whole warp\n"
         "    exact_rows* s = &s_rows[w];\n",
         "    const int t = threadIdx.x, l = t & 31;\n"
         "    const int lane = blockIdx.x;\n"
         "    exact_rows* s = &s_rows[0];\n"),
        ("    if (ok) exact_stage(s, id, l, place, shifts, anchor_ok);\n",
         "    if (ok && t < 32) exact_stage(s, id, l, place, shifts, anchor_ok);\n"),
        ("    __syncwarp();\n    const int items", "    __syncthreads();\n    const int items"),
        ("    for (int base = 0; base < items && !found; base += 32) {\n"
         "        int hit = 0;\n"
         "        if (base + l < items) {\n"
         "            int o, a1, i, j, h;\n"
         "            bb_exact_item(base + l, m[0], m[1], m[2], &o, &a1);\n",
         f"    for (int base = 0; base < items && !found; base += {lane_threads}) {{\n"
         "        int hit = 0;\n"
         "        if (base + t < items) {\n"
         "            int o, a1, i, j, h;\n"
         "            bb_exact_item(base + t, m[0], m[1], m[2], &o, &a1);\n"),
        ("        found = __any_sync(BB_FULL_WARP, hit);\n",
         "        found = __syncthreads_or(hit);\n"),
        ("    if (l == 0) out[lane] = found ? 1 : 0;\n", "    if (t == 0) out[lane] = found ? 1 : 0;\n"),
        (K3_LAUNCH, f"        BBX_LAUNCH(exact_kernel, k, {lane_threads}, stream,\n"),
    ]


# `bb_line_anchors` by a loop over the eight rows and the eight columns,
# a popcount each (the first form), instead of SWAR.
LA_LOOPS = [("    const u64 key = bb_short_row_firsts(free, w) |\n"
             "                    bb_transpose(bb_short_row_firsts(bb_transpose(free), h));\n",
             """    u64 key = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const u64 row = (free >> (8 * i)) & 0xFFULL;
        const int nr = BB_POPC(row);
        if (nr >= 1 && nr <= w) key |= (row & (~row + 1)) << (8 * i);
        const u64 col = (free >> i) & BB_BYTE_LSB;
        const int nc = BB_POPC(col);
        if (nc >= 1 && nc <= h) key |= (col & (~col + 1)) << i;
    }
""")]

# The walk two candidates an iteration.
UNROLL2 = [("""        const int a2 = BB_LOWEST(f2);
        f2 &= f2 - 1;
        if (bb_fit(bb_clear_lines(b1 | place2[a2]), shift3, aok3)) return 1;
""", """        const int a2 = BB_LOWEST(f2);
        f2 &= f2 - 1;
        const int a2b = f2 ? BB_LOWEST(f2) : a2;
        f2 &= f2 - 1;
        const u64 x = bb_fit(bb_clear_lines(b1 | place2[a2]), shift3, aok3);
        const u64 y = bb_fit(bb_clear_lines(b1 | place2[a2b]), shift3, aok3);
        if (x | y) return 1;
""")]

K3_EMPTY = [("    if (lane >= k) return;  // a whole warp\n", "    if (k > 0) return;\n")]

# K7 with the shortcut: its items take the row of their draw's pair, read
# from L2 or staged (the rejected draw's six rows, 3 KB a warp) in dynamic
# shared memory.
K7_ITEM_PARAMS = ("                                                const int* s_span, volatile int* found) {\n",
                  "                                                const int* s_span, const u64* nc,\n"
                  "                                                volatile int* found) {\n")
K7_ITEM_SEARCH = ("                         s_shift + BB_SHIFTS * id[h], s_aok[id[h]],\n"
                  "                         [found] {",
                  "                         s_shift + BB_SHIFTS * id[h], s_aok[id[h]], NC_ROW,\n"
                  "                         [found] {")
K7_CALL = "                                     s_place, s_shift, s_aok, s_span, &s_found[q]);"


def k7_shortcut(row, nc_arg):
    return [K7_ITEM_PARAMS, (K7_ITEM_SEARCH[0], K7_ITEM_SEARCH[1].replace("NC_ROW", row)),
            (K7_CALL, K7_CALL.replace("s_span, &s_found", f"s_span, {nc_arg},\n"
                                      "                                     &s_found"))]


K7_NC_L2 = k7_shortcut("nc + (size_t)(id[j] * BB_NUM_PIECES + id[h]) * BB_ANCHORS", "nc")
K7_NC_SHARED = k7_shortcut("nc + o * BB_ANCHORS", "s_nc[q][0]") + [
    ("    __shared__ int s_busy;\n",
     "    __shared__ int s_busy;\n"
     "    BBX_DYNAMIC_SHARED(smem_nc);\n"
     "    u64 (*s_nc)[6][BB_ANCHORS] = (u64 (*)[6][BB_ANCHORS])smem_nc;\n"),
    ("            const bool ok = bb_disjoint_warp(v[0], v[1], v[2], rows, l, s_nc12[w]);\n",
     "            const bool ok = bb_disjoint_warp(v[0], v[1], v[2], rows, l, s_nc12[w]);\n"
     "            if (!ok)\n"
     "                for (int r = 0; r < 6; ++r) {\n"
     "                    int i_, j_, h_;\n"
     "                    bb_exact_order(r, &i_, &j_, &h_);\n"
     "                    const u64* row = nc + (size_t)(id[j_] * BB_NUM_PIECES + id[h_])"
     " * BB_ANCHORS;\n"
     "                    s_nc[w][r][l] = __ldg(row + l);\n"
     "                    s_nc[w][r][l + 32] = __ldg(row + l + 32);\n"
     "                }\n"),
    ("    BBX_LAUNCH(regen_kernel, (n + REGEN_CHUNK - 1) / REGEN_CHUNK, REGEN_THREADS,\n"
     "               stream,",
     "    const int smem = REGEN_THREADS / 32 * 6 * BB_ANCHORS * 8;\n"
     "    if (const int err = (int)cudaFuncSetAttribute(\n"
     "            regen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))\n"
     "        return err;\n"
     "    BBX_LAUNCH_SMEM(regen_kernel, (n + REGEN_CHUNK - 1) / REGEN_CHUNK, REGEN_THREADS,"
     " smem,\n"
     "               stream,"),
]

K7_EXACT_ORACLE = [
    ("__global__ void __launch_bounds__(REGEN_THREADS)\n",
     "__device__ const unsigned char* regen_oracle;  // [n][100] exact verdicts\n"
     "extern \"C\" int bbx_regen_set_oracle(const void* p) {\n"
     "#ifdef BBX_EMULATE\n"
     "    regen_oracle = (const unsigned char*)p;\n"
     "#else\n"
     "    cudaMemcpyToSymbol(regen_oracle, &p, sizeof(p));\n"
     "#endif\n"
     "    return (int)cudaGetLastError();\n"
     "}\n\n"
     "__global__ void __launch_bounds__(REGEN_THREADS)\n"),
    ("""                if (!found[q])
                    regen_exact_item(off, s_board[s_lane[q]], s_id[q], s_valid[q],
                                     s_place, s_shift, s_aok, s_span, &s_found[q]);
""", """                if (!found[q] && regen_oracle[(size_t)(base + s_lane[q]) * REGEN_MAX_ATTEMPTS +
                                              s_attempt[q]])
                    s_found[q] = 1;
"""),
]


def exact_oracle(bits, seed, need, attempts):
    """[n, 100] uint8: the exact tier's verdict on draw j of lane i, for the
    lanes in need and every attempt K7 may issue them (its accepted one
    and up to 12 more, speculatively)."""
    n = bits.shape[0]
    table = torch.zeros((n, 100), dtype=torch.uint8, device=bits.device)
    needy = need.nonzero().squeeze(1)
    for j in range(100):
        lanes = needy[attempts[needy] + 12 > j]
        if lanes.numel() == 0:
            break
        ids = ES.regen_draw(seed, lanes, j)
        b = bits[lanes]
        v3 = S.valid3_bits_plain(b, ids)
        table[lanes, j] = S.solvable_exact_bits_plain(b, ids, v3).to(torch.uint8)
    return table


def exact_at_once(answer):
    return [("    int o, a1, i, j, h;\n    bb_exact_item(u, v[0], v[1], v[2], &o, &a1);\n",
             ("    *found = 1;\n    return 1;\n" if answer else "    return 0;\n")
             + "    int o, a1, i, j, h;\n    bb_exact_item(u, v[0], v[1], v[2], &o, &a1);\n")]


def _set(name, value, default):
    return (f"#define {name} {default}", f"#define {name} {value}")


# Each variant: its kernel library and its edits, by file of csrc/.
VARIANTS = {
    **{f"k3_warps_{v}": ("solvable_exact",
                         {EXACT: [_set("EXACT_WARPS", f"{v} ", "4 ")] + (K3_DYNAMIC if v == 32 else [])})
       for v in (8, 16, 32)},
    **{f"k3_block_{v}": ("solvable_exact", {EXACT: k3_block(v)}) for v in (64, 128)},
    "k3_place_global": ("solvable_exact", {EXACT: K3_PLACE_GLOBAL}),
    "k3_la_loops": ("solvable_exact", {VERDICT: LA_LOOPS}),
    "k3_unroll2": ("solvable_exact", {VERDICT: UNROLL2}),
    "k3_all_candidates": ("solvable_exact", {VERDICT: ALL_CANDIDATES}),
    "k3_nc_shared": ("solvable_exact", {VERDICT: SHORTCUT, EXACT: K3_NC_SHARED}),
    "k3_nc_l2": ("solvable_exact", {VERDICT: SHORTCUT, EXACT: K3_NC_L2}),
    "k3_nc_shared_all": ("solvable_exact", {VERDICT: SHORTCUT_ALL, EXACT: K3_NC_SHARED}),
    "k3_flat": ("solvable_exact", {EXACT: FLAT}),
    "k3_empty": ("solvable_exact", {EXACT: K3_EMPTY}),
    "k7_all_candidates": ("regen", {VERDICT: ALL_CANDIDATES}),
    "k7_la_loops": ("regen", {VERDICT: LA_LOOPS}),
    "k7_unroll2": ("regen", {VERDICT: UNROLL2}),
    "k7_nc_l2": ("regen", {VERDICT: SHORTCUT, REGEN: K7_NC_L2}),
    "k7_nc_shared": ("regen", {VERDICT: SHORTCUT, REGEN: K7_NC_SHARED}),
    "k7_exact_oracle": ("regen", {REGEN: K7_EXACT_ORACLE}),
    "k7_exact_accept": ("regen", {REGEN: exact_at_once(True)}),
    "k7_exact_reject": ("regen", {REGEN: exact_at_once(False)}),
}
KERNELS = ("solvable_exact", "regen")
DEVICE_NAME = {"solvable_exact": "exact_kernel", "regen": "regen_kernel"}
WRONG_BY_DESIGN = ("_empty", "_exact_accept", "_exact_reject")


def replaced(text, pairs):
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"the source no longer holds {old!r}: update this script")
        text = text.replace(old, new)
    return text


def sources(parent, work):
    """{variant: (kernel, include directory holding its sources)}: this
    tree's csrc/, the parent's, and a copy of this tree's csrc/ a variant
    with its edits."""
    out = {f"{kernel}_this": (kernel, build.CSRC) for kernel in KERNELS}
    if parent:
        for kernel in KERNELS:
            out[f"{kernel}_parent"] = (kernel, os.path.join(parent, "bbx_torch", "csrc"))
    for name, (kernel, edits) in VARIANTS.items():
        csrc = os.path.join(work, name)
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(build.CSRC, csrc)
        for fname, pairs in edits.items():
            path = os.path.join(csrc, fname)
            with open(path) as f:
                text = replaced(f.read(), pairs)
            with open(path, "w") as f:
                f.write(text)
        out[name] = (kernel, csrc)
    return out


def compile_all(srcs, work):
    procs = {}
    for name, (kernel, csrc) in srcs.items():
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", csrc,
               "-o", os.path.join(work, f"lib{name}.so"),
               os.path.join(csrc, build.SOURCES[kernel])]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns, ptxas, libs = {}, {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} does not compile:\n{log}")
        ptxas[name] = [line.strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line]
        _, symbol, argtypes = build.SIGNATURES[srcs[name][0]]
        libs[name] = ctypes.CDLL(os.path.join(work, f"lib{name}.so"))
        fn = getattr(libs[name], symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns, ptxas, libs


def cases(dev):
    """{case: (kernel, args of the C entry point but the stream, the
    outputs, the plain version's outputs, the tensors the args point into;
    K7's with its `exact_oracle` table last)}."""
    tb = tables(dev)
    _, _, bits, ids = CS.midgame_boards(dev)
    v3 = S.valid3_bits_plain(bits, ids)
    rest = (~S.solvable_disjoint_bits_plain(bits, ids, v3)).nonzero().squeeze(1)
    out = {}
    for label, sel in (("1", slice(0, 1)), ("rest", rest), (str(CS.FLEET), slice(None))):
        b, i, v = bits[sel].contiguous(), ids[sel].contiguous(), v3[sel].contiguous()
        k = b.shape[0]
        o = torch.empty(k, dtype=torch.bool, device=dev)
        args = (b.data_ptr(), i.data_ptr(), v.data_ptr(), tb.PLACE_U64.data_ptr(),
                tb.PIECE_SHIFTS_I32.data_ptr(), tb.ANCHOR_OK_U64.data_ptr(), o.data_ptr(), k)
        out[f"k3_{label}_{k}"] = ("solvable_exact", args, (o,),
                                  (S.solvable_exact_bits_plain(b, i, v),), (b, i, v))
    eng = CS.engine_step_inputs(dev)
    n = CS.ENGINE_LANES
    seed = eng["seed"].reshape(())
    got_ids = torch.empty((n, 3), dtype=torch.int32, device=dev)
    attempts = torch.empty(n, dtype=torch.int32, device=dev)
    args = (eng["bits"].data_ptr(), eng["ids"].data_ptr(), eng["need"].data_ptr(),
            seed.data_ptr(), tb.PLACE_U64.data_ptr(), tb.PIECE_SHIFTS_I32.data_ptr(),
            tb.ANCHOR_OK_U64.data_ptr(), tb.NO_CONFLICT_U64.data_ptr(), got_ids.data_ptr(),
            attempts.data_ptr(), n, 0)  # lane base 0: a whole fleet
    want = ES.regen_pieces_plain(eng["bits"], eng["ids"], seed, eng["need"])
    oracle = exact_oracle(eng["bits"], seed, eng["need"], want[1])
    out[f"k7_{n}"] = ("regen", args, (got_ids, attempts), want, (eng, seed, oracle))
    return out


def device_ms(call, kernel_name, reps=30):
    """One call's device time of the kernel by `torch.profiler`, after a
    warm-up step of the profiler's schedule; a session that records none of
    its launches is taken again, twice at most, and then the time is "not
    measured"."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            call()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            prof.step()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel_name in e.name]
        if times:
            return sum(times) / len(times)
    return "not measured"


def event_ms(call, reps=15, inner=20):
    """Median time a call between CUDA events over `inner` back-to-back
    calls."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of another commit")
    ap.add_argument("--out", default=None, help="JSON results path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    work = os.path.join(ROOT, "build", "k3_parts")
    os.makedirs(work, exist_ok=True)
    srcs = sources(args.parent, work)
    fns, ptxas, libs = compile_all(srcs, work)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    # The tables the variants read through a device global of their own.
    setters = {"bbx_exact_set_nc": tables(dev).NO_CONFLICT_U64}
    for case, (kernel, cargs, outs, want, keep) in cases(dev).items():
        if kernel == "regen":
            setters["bbx_regen_set_oracle"] = keep[2]
        for name, lib in libs.items():
            for symbol, table in setters.items():
                if hasattr(lib, symbol):
                    setter = getattr(lib, symbol)
                    setter.argtypes, setter.restype = [ctypes.c_void_p], ctypes.c_int
                    build.check(name, setter(table.data_ptr()))
        names = [name for name in srcs if srcs[name][0] == kernel]
        for name in names + names[::-1]:
            def call(fn=fns[name], cargs=cargs, name=name):
                build.check(name, fn(*cargs, stream))

            for o in outs:
                o.fill_(0)
            call()
            torch.cuda.synchronize()
            row = {"case": case, "variant": name,
                   "equal": all(torch.equal(o, w) for o, w in zip(outs, want))
                   or name.endswith(WRONG_BY_DESIGN),
                   "ms": event_ms(call),
                   "device_ms": device_ms(call, DEVICE_NAME[kernel])}
            if kernel == "regen":
                row["draws"] = int(outs[1].sum())
            rows.append(row)
            print(json.dumps(row), flush=True)
    smi = CS.nvidia_smi()
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "ptxas": ptxas, "rows": rows}, f, indent=2)
    bad = [(r["case"], r["variant"]) for r in rows if not r["equal"]]
    if bad:
        print(f"not equal to the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
