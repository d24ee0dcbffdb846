#!/usr/bin/env python3
"""Where the redesigned kernels B1 (select_gather), B2a
(sa_fwd_layer12), B2b (sa_fwd_gram_pool), B3a (sa_bwd_sweep1), B3b
(sa_bwd_sweep2) and B3c (sa_bwd_sweep3), and the bf16 forms of B2a, B2b,
B3a, B3b and B3c (sa_fwd_layer12_bf16, sa_fwd_gram_pool_bf16,
sa_bwd_sweep1_bf16, sa_bwd_sweep2_bf16, sa_bwd_sweep3_bf16), spend their
time on the card.

    python3 chip_ablate.py                  # one CUDA device, nvcc
    python3 chip_ablate.py sweep1 sweep3    # those kernels' variants only
                                            # (select, layer12, gram_pool,
                                            # sweep1, sweep2, sweep3,
                                            # layer12_bf16, gram_pool_bf16,
                                            # sweep1_bf16, sweep2_bf16,
                                            # sweep3_bf16)
    python3 chip_ablate.py --parent DIR layer12_bf16 layer12_bf16_parent
                                            # + the same parts of the former
                                            # bf16 B2a in DIR's sa_pair.cu
                                            # (a git archive of a commit
                                            # that has it), in turns
    python3 chip_ablate.py precision        # B2a's arithmetic variants:
                                            # precision against float64
    python3 chip_ablate.py rounding         # the card's bf16 rounding rate,
                                            # one or two values at a time
    python3 chip_ablate.py b9_bf16          # B9-bf16's eight launches with
                                            # and without its k-order redo
                                            # (B9_VARIANTS), in turns
    python3 chip_ablate.py tc_sums          # B9-bf16's forward sums on the
                                            # tensor cores against the
                                            # k-order chain (TC_SUMS_CU)
    python3 chip_ablate.py tc_sums_tf       # B9-f32's forward sums on the
                                            # TF32 tensor cores against the
                                            # k-order chain and the mask
                                            # redo's window (TC_SUMS_TF_CU)
    python3 chip_ablate.py b9_f32           # B9's eight f32 launches on the
                                            # TF32 tensor cores with one
                                            # part cut at a time
                                            # (B9_F32_CUTS), in turns; dx
                                            # against its twin with and
                                            # without the mask redo
    python3 chip_ablate.py b8b              # the bf16 B6 and B8b
                                            # (sa_bwd2_sweep2_bf16's
                                            # kernel) with one part cut
                                            # at a time (B8B_CUTS), in
                                            # turns
    python3 chip_ablate.py b8b_f32          # the f32 B6 and B8b
                                            # (sa_bwd2_sweep2's TF32
                                            # kernel) with one part cut
                                            # at a time, and trial forms
                                            # (B8B_F32_CUTS), in turns
    python3 chip_ablate.py --parent DIR b8b_f32
                                            # + DIR's sa_2sweep.cu (its
                                            # f32 B6 and B8b, its cnt1
                                            # against the twin's)
    python3 chip_ablate.py b8a              # B8a (sa_bwd2_sweep1) at bf16
                                            # and f32 with one part cut at
                                            # a time (B8A_CUTS), in turns

Each kernel is rebuilt from facl_tpu_torch/ops/csrc/sa_pair.cu with one
part cut out (the pool, the Gram, a product, the CUDA-core row passes;
B3a's A3, its q3 rows, its row bins; the bf16 B3a's q3 product, A3, h2
pass, and its stage count; the bf16 B3c's h1, h1 M2 and dy1^T [x | 1]),
or, for the bf16 B3a's A3, one part redesigned (on tensor cores), and
every variant is timed by
chip_smoke.device_ms on the main path's shapes (640 clouds x 4,096 rows,
random data; B3a's argmax rows skewed as chip_smoke.py reads them on
the main path: 47% of a group's channels on its first row, 37% dead, the
rest spread), twice, in turns. B2a (sa_fwd_layer12) and its bf16 form
are cut the same way in sa_pair.cu (the product, the h1 pass, the p2
store; the bf16 form also run with 12 or 8 warps a block), and B1
(select_gather, with idx) in select.cu (the selection, the gather, the
idx store), timed on chip_smoke.py's body-like slab clouds and on randn
clouds (640 x 512 points, S = K = 64). A
cut variant's outputs are wrong by design; only its time is read. The full
kernel's time less a variant's is what the part costs where it overlaps
nothing else. A redesigned variant's outputs are held against the
kernel's, and its ptxas use (registers, spills) printed beside the
kernel's (CHECKED). Exits nonzero without a card or if a variant does not
build; prints one JSON line {"ablation": {variant: [ms, ms]}, "checked":
{variant: [error by output]}, "ptxas": {variant: use}, "gpu": ...}.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

CSRC = os.path.join("facl_tpu_torch", "ops", "csrc")
NOPOOL = ("      pool_tile<LP>(c, n0, b3s, tile, upt, run, mx, mn, imx, imn);",
          "      { float z = 0.f; for (int mi = 0; mi < 4; ++mi) for (int nj "
          "= 0; nj < 2; ++nj) for (int q = 0; q < 4; ++q) z += c[mi][nj][q]; "
          "if (z == 1.2345f) mx[threadIdx.x] = z; }")
S1_NOA3 = ("      for (int gi = 0; gi < gpt; ++gi) {\n        const int e = gi",
           "      for (int gi = 0; gi < 0; ++gi) {\n        const int e = gi")
S1_NOQ3 = [("    for (int k = warp; k < ntask; k += NWARP) {",
            "    for (int k = warp; k < 0; k += NWARP) {"),
           ("    for (int r = warp; r < U; r += NWARP) {",
            "    for (int r = warp; r < 0; r += NWARP) {")]
S1_NOBINS = [("      if (k != DEAD && lane == __ffs(peers) - 1)\n"
              "        bits[bit_slot(k, w & 7)] = peers;\n", "")]
S3_NOPROD = ("    for (int kb = 0; kb < 8; ++kb) {\n      const FragA a = "
             "frag_a_rows(H, m0", "    for (int kb = 0; kb < 0; ++kb) {\n"
             "      const FragA a = frag_a_rows(H, m0")
S3_NOA1 = ("      for (int mt = 0; mt < 2; ++mt) {\n        float d[4];",
           "      if (c[0][0] == 1.5f && c[3][3] == 0.5f)\n        acc[0][0] += "
           "c[1][1] + c[2][2];\n      for (int mt = 0; mt < 0; ++mt) {\n"
           "        float d[4];")
S3_NOH1 = ("    h1_rows(X, C0, W1s, v, hh, hl, m1, gt, S3_GT);\n", "")
L12_MMA = ("          mma6(d, a, frag_b3_paired(Wp, b_stride(CW), 8 * nj, "
           "kb, lane));")
L12_NOPROD = (L12_MMA, "          d[0] = __uint_as_float(a.v[0][nj & 3]);")
L12_NOH1 = ("        h1_pair(xa, xb, C0, W1s, v, col, ha, hb);",
            "        ha = make_float2(xa[0], xa[0] + col);\n"
            "        hb = make_float2(xb[0], xb[0] + col);")
# B2a's product in 3xTF32 (its two leading pieces), as the sweeps B2b-B3c
# run theirs: rounded per k step as here, or accumulated in the tensor
# cores across k steps.
L12_3X = ("mma3({acc}, FragA{{{{Split{{a.v[0][0], a.v[1][0]}}, "
          "Split{{a.v[0][1], a.v[1][1]}}, Split{{a.v[0][2], a.v[1][2]}}, "
          "Split{{a.v[0][3], a.v[1][3]}}}}}}, frag_b_paired(SplitBuf{{Wp[0], "
          "Wp[1]}}, b_stride(CW), 8 * nj, kb, lane));")
L12_STEP = ("          float d[4];\n          zero4(d);\n" + L12_MMA + "\n"
            "#pragma unroll\n          for (int r = 0; r < 4; ++r) "
            "c[nj][r] = __fadd_rn(c[nj][r], d[r]);")
#: --precision: B2a's arithmetic variants (p2 against float64, the layer-2
#: ReLU decisions it moves, the pair3 SA chain against float64).
PRECISION = {
    "layer12 (6xTF32)": [],
    "layer12 in 3xTF32, rounded per k step": [
        (L12_MMA, "          " + L12_3X.format(acc="d"))],
    "layer12 in 3xTF32, accumulated in the tensor cores": [
        (L12_STEP, "          " + L12_3X.format(acc="c[nj]"))],
}
L12_NOSTORE = ("        st2r(out + 8 * nj, u);\n"
               "        st2r(out + 8 * CW + 8 * nj, w);\n", "")
# The bf16 B2a (fwd_layer12_bf16_kernel): its product cut (h1 and W2's
# fragments still made), or its h1 chain, or its p2 store.
L12B_NOPROD = ("#pragma unroll\n        for (int s = 0; s < 2; ++s) {\n"
               "          mma_bf16(c[s][2 * np], a[s], b[0], b[1]);\n"
               "          mma_bf16(c[s][2 * np + 1], a[s], b[2], b[3]);\n"
               "        }",
               "#pragma unroll\n        for (int s = 0; s < 2; ++s)\n"
               "          c[s][2 * np][0] += "
               "__uint_as_float(a[s][np] ^ b[np]);")
L12B_NOH1 = ("        h1_bf16_rows<4, XC>(xr, C0, prm + (8 * kk + 4 * jj + t) "
             "* L12B_PP,\n                            h);",
             "        for (int r = 0; r < 4; ++r)\n"
             "          h[r] = __float_as_uint(xr[r][0]) + jj + kk;")
L12B_NOSTORE = ("      *reinterpret_cast<uint4*>(out + r * CW + cl) =\n"
                "          *reinterpret_cast<const uint4*>(stg + r * LDB + "
                "cl);\n", "")
# The former form of B2a-bf16, fwd_layer12_kernel<true> of the f32 design (one
# TF32 pass a k8 step), in a parent tree's sa_pair.cu (--parent DIR): its
# product cut (h1 and W2 still read), or its h1 chain, or its p2 store.
L12P_NOPROD = ("            mma_tf32(d, a0, a1, a2, a3, "
               "__float_as_uint(w.x),\n"
               "                     __float_as_uint(w.y));",
               "            d[0] = __uint_as_float(a0 ^ a1 ^ a2 ^ a3) + w.x + "
               "w.y;")
L12P_NOH1 = ("        h1_pair<BF>(xa, xb, C0, W1s, v, col, ha, hb);",
             "        ha = make_float2(xa[0], xa[0] + col);\n"
             "        hb = make_float2(xb[0], xb[0] + col);")
L12P_NOSTORE = ("        st2r(out + 8 * nj, u);\n"
                "        st2r(out + 8 * CW + 8 * nj, w);\n", "")
SEL_NOSELECT = ("      select_kth(w, K, __float_as_uint(radius_sq), hist, "
                "lane, t, take,\n                 ties);",
                "      t = 0u;\n      take = K;\n      ties = -1;")
SEL_NOGATHER = ("      if (!kGather) continue;", "      if (true) continue;")
SEL_NOIDX = ("      if (idx_out) idx_out[row * K + q] = i;\n", "")
# The bf16 forms of B2b and B3b (fwd_gram_pool_bf16_kernel,
# bwd_sweep2_bf16_kernel): each product, pass or store cut.
GPB_NOGRAM = ("    {   // Gram(h2) = h2^T h2", "    if (0) {   // Gram(h2)")
GPB_NOP3 = ("    {   // p3^T = bf16(W3)^T h2^T", "    if (0) {   // p3^T")
GPB_NOPOOL = ("      pool_tile_t<LP>(c, n0, b3s, tile, upt, run, mx, mn, imx, "
              "imn);",
              "      { float z = 0.f; for (int j = 0; j < 8; ++j) for (int q "
              "= 0; q < 4; ++q) z += c[j][q]; if (z == 1.2345f) "
              "mx[threadIdx.x] = __float2bfloat16_rn(z); }")
GPB_NORELU = ("    {   // h2 = relu(bf16(p2 mul2 + shift2))",
              "    if (0) {   // h2")
S2B_NOM3 = ("        ldsm4t(b, b_rows_at(Ms, 16 * np, 16 * kk, lane));\n"
            "        mma_bf16(c[2 * np], ha2[kk], b[0], b[1]);\n"
            "        mma_bf16(c[2 * np + 1], ha2[kk], b[2], b[3]);",
            "        c[2 * np][0] += __uint_as_float(ha2[kk][np]);")
S2B_NOQ2 = ("        ldsm4(b, b_cols_at(W2s, 16 * np, 16 * kk, lane));\n"
            "        mma_bf16(c[2 * np], qa[kk], b[0], b[1]);\n"
            "        mma_bf16(c[2 * np + 1], qa[kk], b[2], b[3]);",
            "        c[2 * np][0] += __uint_as_float(qa[kk][np]);")
S2B_NOAG = ("    for (int h = 0; h < S2B_ROWS; h += TR)\n      s2b_products(",
            "    for (int h = 0; h < 0; h += TR)\n      s2b_products(")
S2B_NOAG2 = ("  for (int h = 0; h < S2B_ROWS; h += TR)      // the last",
             "  for (int h = 0; h < 0; h += TR)      // the last")
S2B_NOH1 = ("      h1_pair<true>(xa, xb, C0, W1s, v, col, ha, hb);",
            "      ha = make_float2(xa[0], xa[0] + col);\n"
            "      hb = make_float2(xb[0], xb[0] + col);")
S2B_NOMQ = ("      *reinterpret_cast<uint4*>(mq + (r0 + r) * CW + cl) =\n"
            "          *reinterpret_cast<const uint4*>(S + r * LDB + cl);",
            "")
# The bf16 forms of B3a and B3c (bwd_sweep1_bf16_kernel,
# bwd_sweep3_bf16_kernel): a product or a pass cut.
S1B_NOQ3 = ("      for (int kk = 0; kk < 16; ++kk)      // + two core",
            "      for (int kk = 0; kk < 0; ++kk)      // + two core")
S1B_NOA3 = ("    for (int gi = 0; gi < gpt; ++gi) {\n      const uint32_t w = ae",
            "    for (int gi = 0; gi < 0; ++gi) {\n      const uint32_t w = ae")
S1B_NOH2 = ("    for (int q = q0 + tid; q < q1; q += nth) {",
            "    for (int q = q0 + tid; q < 0; q += nth) {")
S1B_NOENT = ("    for (int p = ac; p < E / 2; p += S1B_RT) {",
             "    for (int p = ac; p < 0; p += S1B_RT) {")
S3B_NOPROD = ("        ldsm4t(b, b_rows_at(Ms, 16 * np, 16 * kk, lane));\n"
              "        mma_bf16(c[2 * np], a, b[0], b[1]);\n"
              "        mma_bf16(c[2 * np + 1], a, b[2], b[3]);",
              "        c[2 * np][0] += __uint_as_float(a[np]);")
S3B_NOH1 = ("        h1_pre_bf16(xa, xb, C0, W1s, v, 8 * jc + 2 * t, pa, pb);",
            "        pa = __float_as_uint(xa[0]) + jc;\n"
            "        pb = __float_as_uint(xb[0]) + jc;")
S3B_NOA1 = ("    for (int mt = 0; mt < 4; ++mt) {\n      const uint32_t a[4] = {",
            "    {\n      uint32_t z = 0u;\n      for (int q = 0; q < 16; ++q) "
            "z ^= dy[q >> 1][q & 1];\n      acc[0][0] += z;\n    }\n"
            "    for (int mt = 0; mt < 0; ++mt) {\n      const uint32_t a[4] = {")
# The bf16 B3a with A3 on tensor cores in place of its CUDA-core pass:
# the row warps also keep dy3^T as a bf16 tile (C3W channels, LDB), zero
# but at the tile's entries (each entry cleared by the thread that wrote
# it, the tile after), and warp w adds A3's channels 32 w.. as mma.sync
# m16n8k16 bf16 (dy3^T by ldmatrix, h2 by ldmatrix.trans) over the tile's
# 64 rows; one tile in that buffer, so the row warps meet once more.
S1B_A3MMA = [
    ("  int stage, w3, dt, pos, a3e, h2, q3, vec, bars, total;",
     "  int stage, w3, dt, pos, a3e, h2, q3, vec, bars, dy, total;"),
    ("  l.total = l.bars + (2 * S + 4) * 8;",
     "  l.dy = (l.bars + (2 * S + 4) * 8 + 15) & ~15;\n"
     "  l.total = l.dy + C3W * LDB * 2;"),
    ("  bf* Qs = reinterpret_cast<bf*>(smb + ly.q3);",
     "  bf* Qs = reinterpret_cast<bf*>(smb + ly.q3);\n"
     "  bf* DYs = reinterpret_cast<bf*>(smb + ly.dy);"),
    ("  for (int e = threadIdx.x; e < 2 * E; e += S1B_NT) dpos[e] = S1B_NONE;",
     "  for (int e = threadIdx.x; e < 2 * E; e += S1B_NT) dpos[e] = S1B_NONE;\n"
     "  for (int e = threadIdx.x; e < C3W * LDB / 8; e += S1B_NT)\n"
     "    reinterpret_cast<uint4*>(DYs)[e] = make_uint4(0u, 0u, 0u, 0u);"),
    ("      const uint32_t old = *reinterpret_cast<const uint32_t*>(pb + e);",
     "      const uint32_t old = *reinterpret_cast<const uint32_t*>(pb + e);\n"
     "      const uint32_t prev =\n"
     "          *reinterpret_cast<const uint32_t*>(dpos + (b ^ 1) * E + e);"),
    ("        if (was != S1B_NONE) Db[was] = __float2bfloat16_rn(0.f);",
     "        if (was != S1B_NONE) Db[was] = __float2bfloat16_rn(0.f);\n"
     "        const uint32_t wp = (prev >> (16 * q)) & 0xffffu;\n"
     "        if (wp != S1B_NONE)\n"
     "          reinterpret_cast<uint16_t*>(DYs)[(c + q) * LDB +\n"
     "                                           ((wp >> 11) << 3 |\n"
     "                                            ((wp >> 3) & 7))] = 0;"),
    ("              static_cast<uint16_t>(val >> (16 * q));",
     "              static_cast<uint16_t>(val >> (16 * q));\n"
     "        if (key != DEAD)\n"
     "          reinterpret_cast<uint16_t*>(DYs)[(c + q) * LDB + key] =\n"
     "              static_cast<uint16_t>(dw >> (16 * q));"),
    ("""  for (int64_t i = 0; i < count; ++i) {
    if (i + 1 < count) {
      entries(i + 1);
      release(i + 1);
    }
    // A3 += dy3^T h2 and u3 over tile i's live entries.
    const int b = static_cast<int>(i & 1);
    const uint32_t* ae = a3es + b * E;
    const bf* Hb = H2 + b * U * LDB;
    float su = 0.f;
    for (int gi = 0; gi < gpt; ++gi) {
      const uint32_t w = ae[gi * C3W + ac];
      const int k = static_cast<int>(w >> 16);
      if (k != DEAD) {
        const float dv = __uint_as_float(w << 16);
        const uint4* hrow = reinterpret_cast<const uint4*>(Hb + k * LDB);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const uint4 u = hrow[q];
          const uint32_t hw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int z = 0; z < 4; ++z) {
            const float2 h = unpack_bf16(hw[z]);
            a3[8 * q + 2 * z] = fmaf(dv, h.x, a3[8 * q + 2 * z]);
            a3[8 * q + 2 * z + 1] = fmaf(dv, h.y, a3[8 * q + 2 * z + 1]);
          }
        }
        su += dv;
      }
    }
    u3 += su;
    named_sync(1, S1B_CT);
  }

  double* pa = partA + ((int64_t)blockIdx.x * C3W + ac) * CW;
#pragma unroll
  for (int q = 0; q < 32; ++q)
    *reinterpret_cast<double2*>(pa + 2 * q) =
        make_double2(a3[2 * q], a3[2 * q + 1]);
""", """  const int rw = ac >> 5;
  for (int64_t i = 0; i < count; ++i) {
    const int b = static_cast<int>(i & 1);
    const uint32_t* ae = a3es + b * E;
    const bf* Hb = H2 + b * U * LDB;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[2][4];
      ldsm4(a[0], a_rows_at(DYs, 32 * rw, 16 * kk, lane));
      ldsm4(a[1], a_rows_at(DYs, 32 * rw + 16, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t hb[4];
        ldsm4t(hb, b_rows_at(Hb, 16 * np, 16 * kk, lane));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(a3 + 4 * (8 * mt + 2 * np), a[mt], hb[0], hb[1]);
          mma_bf16(a3 + 4 * (8 * mt + 2 * np + 1), a[mt], hb[2], hb[3]);
        }
      }
    }
    float su = 0.f;
    for (int gi = 0; gi < gpt; ++gi) {
      const uint32_t w = ae[gi * C3W + ac];
      if (static_cast<int>(w >> 16) != DEAD) su += __uint_as_float(w << 16);
    }
    u3 += su;
    named_sync(2, S1B_RT);
    if (i + 1 < count) {
      entries(i + 1);
      release(i + 1);
    }
    named_sync(1, S1B_CT);
  }

#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int ch = 32 * rw + 16 * (q >> 4) + 8 * (q & 1) + g;
    *reinterpret_cast<double2*>(partA + ((int64_t)blockIdx.x * C3W + ch) *
                                            CW + 8 * ((q >> 1) & 7) + 2 * t) =
        make_double2(a3[4 * (q >> 1) + 2 * (q & 1)],
                     a3[4 * (q >> 1) + 2 * (q & 1) + 1]);
  }
""")]
#: Variants whose outputs are held against the kernel's (a redesign of a
#: part, not a cut): max |variant - kernel| / max |kernel| per output;
#: each built with ptxas's report, as is its base (the unchanged kernel),
#: whose use of registers and spills is printed. variant -> (base, the
#: kernel's function name).
CHECKED = {"sweep1_bf16 with A3 on tensor cores": ("sweep1_bf16",
                                                   "bwd_sweep1_bf16_kernel"),
           **{f"layer12_bf16 with {n} warps": (
               "layer12_bf16", "fwd_layer12_bf16_kernelILi4E")
              for n in (12, 8)}}
#: variant -> (kernel, [(text, replacement)]) on that kernel's source.
VARIANTS = {
    "layer12": ("l12", []),
    "layer12 without h1 W2": ("l12", [L12_NOPROD]),
    "layer12 without h1_rows": ("l12", [L12_NOH1]),
    "layer12 without the p2 store": ("l12", [L12_NOSTORE]),
    "layer12 loads only": ("l12", [L12_NOPROD, L12_NOH1, L12_NOSTORE]),
    "layer12 with its k loop rolled": ("l12", [
        ("#pragma unroll 2\n      for (int kb = 0; kb < 8; ++kb) {",
         "#pragma unroll 1\n      for (int kb = 0; kb < 8; ++kb) {")]),
    "layer12_bf16": ("l12b", []),
    "layer12_bf16 without the product": ("l12b", [L12B_NOPROD]),
    "layer12_bf16 without h1": ("l12b", [L12B_NOH1]),
    "layer12_bf16 without the p2 store": ("l12b", [L12B_NOSTORE]),
    "layer12_bf16 loads and stores only": ("l12b", [L12B_NOPROD, L12B_NOH1]),
    "layer12_bf16 with 12 warps": ("l12b", [
        ("constexpr int L12B_NT = 512;", "constexpr int L12B_NT = 384;")]),
    "layer12_bf16 with 8 warps": ("l12b", [
        ("constexpr int L12B_NT = 512;", "constexpr int L12B_NT = 256;")]),
    "layer12_bf16_parent": ("l12p", []),
    "layer12_bf16_parent without the product": ("l12p", [L12P_NOPROD]),
    "layer12_bf16_parent without h1": ("l12p", [L12P_NOH1]),
    "layer12_bf16_parent without the p2 store": ("l12p", [L12P_NOSTORE]),
    "layer12_bf16_parent loads and stores only": ("l12p", [L12P_NOPROD,
                                                           L12P_NOH1]),
    "select": ("sel", []),
    "select without the selection": ("sel", [SEL_NOSELECT]),
    "select without the gather": ("sel", [SEL_NOGATHER]),
    "select without the idx store": ("sel", [SEL_NOIDX]),
    "select with 8 centroids a block": ("sel", [
        ("constexpr int kCPB = 16;", "constexpr int kCPB = 8;")]),
    "select with 32 centroids a block": ("sel", [
        ("constexpr int kCPB = 16;", "constexpr int kCPB = 32;")]),
    "select with distances and compaction only": (
        "sel", [SEL_NOSELECT, SEL_NOGATHER, SEL_NOIDX]),
    "gram_pool": ("gp", []),
    "gram_pool without the pool": ("gp", [NOPOOL]),
    "gram_pool without the Gram": ("gp", [
        ("    if (nw >= mw) {   // Gram(h2)", "    if (0) {   // Gram(h2)")]),
    "gram_pool without h2 W3 and the pool": ("gp", [
        ("    {   // p3 = h2 W3", "    if (0) {   // p3 = h2 W3")]),
    "sweep2": ("s2", []),
    "sweep2 without h2 M3": ("s2", [
        ("      for (int kb = 0; kb < 8; ++kb) {\n        const FragA a = "
         "split_a(raw_a_rows(H2",
         "      for (int kb = 0; kb < 0; ++kb) {\n        const FragA a = "
         "split_a(raw_a_rows(H2")]),
    "sweep2 without q2 and mq": ("s2", [
        ("    {   // q2 = dy2 (gi2 W2^T)", "    if (0) {   // q2")]),
    "sweep2 without A2 and G1": ("s2", [
        ("    {   // A2 = dy2^T h1", "    if (0) {   // A2")]),
    "sweep2 without h1": ("s2", [
        ("    h1_rows(X, C0, W1s, v, h1h, h1l, m1, threadIdx.x, NTM);\n",
         "")]),
    "sweep2 without the row passes": ("s2", [
        ("    relu_rows(S, mul2, shift2, H2);\n"
         "    h1_rows(X, C0, W1s, v, h1h, h1l, m1, threadIdx.x, NTM);\n",
         "")]),
    "gram_pool_bf16": ("gpb", []),
    "gram_pool_bf16 without the Gram": ("gpb", [GPB_NOGRAM]),
    "gram_pool_bf16 without h2 W3 and the pool": ("gpb", [GPB_NOP3]),
    "gram_pool_bf16 without the pool": ("gpb", [GPB_NOPOOL]),
    "gram_pool_bf16 without the ReLU pass": ("gpb", [GPB_NORELU]),
    "gram_pool_bf16 loads only": ("gpb", [GPB_NOGRAM, GPB_NOP3,
                                          GPB_NORELU]),
    "sweep2_bf16": ("s2b", []),
    "sweep2_bf16 without h2 M3": ("s2b", [S2B_NOM3]),
    "sweep2_bf16 without q2": ("s2b", [S2B_NOQ2]),
    "sweep2_bf16 without A2 and G1": ("s2b", [S2B_NOAG, S2B_NOAG2]),
    "sweep2_bf16 without h1": ("s2b", [S2B_NOH1]),
    "sweep2_bf16 without the mq store": ("s2b", [S2B_NOMQ]),
    "sweep2_bf16 loads only": ("s2b", [S2B_NOM3, S2B_NOQ2, S2B_NOH1,
                                       S2B_NOMQ, S2B_NOAG, S2B_NOAG2]),
    "sweep1": ("s1", []),
    "sweep1 without A3": ("s1", [S1_NOA3]),
    "sweep1 without the q3 rows": ("s1", S1_NOQ3),
    "sweep1 without the q3 rows and the bins": ("s1", S1_NOQ3 + S1_NOBINS),
    "sweep1 loads and stores only": ("s1", [S1_NOA3] + S1_NOQ3 + S1_NOBINS),
    "sweep3": ("s3", []),
    "sweep3 without h1 M2": ("s3", [S3_NOPROD]),
    "sweep3 without dy1^T [x | 1]": ("s3", [S3_NOA1]),
    "sweep3 without h1": ("s3", [S3_NOH1]),
    "sweep3 loads only": ("s3", [S3_NOPROD, S3_NOA1, S3_NOH1]),
    "sweep1_bf16": ("s1b", []),
    "sweep1_bf16 without the q3 product": ("s1b", [S1B_NOQ3]),
    "sweep1_bf16 without A3": ("s1b", [S1B_NOA3]),
    "sweep1_bf16 without h2": ("s1b", [S1B_NOH2]),
    "sweep1_bf16 with 2 stages": ("s1b", [
        ("constexpr int S1B_STAGES = 4;", "constexpr int S1B_STAGES = 2;")]),
    "sweep1_bf16 loads and stores only": ("s1b", [S1B_NOQ3, S1B_NOA3,
                                                  S1B_NOH2, S1B_NOENT]),
    "sweep1_bf16 with A3 on tensor cores": ("s1b", S1B_A3MMA),
    "sweep3_bf16": ("s3b", []),
    "sweep3_bf16 without h1 M2": ("s3b", [S3B_NOPROD]),
    "sweep3_bf16 without h1": ("s3b", [S3B_NOH1]),
    "sweep3_bf16 without dy1^T [x | 1]": ("s3b", [S3B_NOA1]),
    "sweep3_bf16 loads and dy1 only": ("s3b", [S3B_NOPROD, S3B_NOH1,
                                               S3B_NOA1]),
}


#: kernel -> (source file, launcher's library and name).
KERNEL_SRC = {"l12": ("sa_pair", "facl_sa_fwd_layer12"),
              "l12b": ("sa_pair", "facl_sa_fwd_layer12_bf16"),
              "l12p": ("sa_pair", "facl_sa_fwd_layer12_bf16"),
              "gp": ("sa_pair", "facl_sa_fwd_gram_pool"),
              "gpb": ("sa_pair", "facl_sa_fwd_gram_pool_bf16"),
              "s2b": ("sa_pair", "facl_sa_bwd_sweep2_bf16"),
              "s1": ("sa_pair", "facl_sa_bwd_sweep1"),
              "s2": ("sa_pair", "facl_sa_bwd_sweep2"),
              "s3": ("sa_pair", "facl_sa_bwd_sweep3"),
              "s1b": ("sa_pair", "facl_sa_bwd_sweep1_bf16"),
              "s3b": ("sa_pair", "facl_sa_bwd_sweep3_bf16"),
              "sel": ("select", "facl_select_gather")}


#: Kernels whose variants are cut from the --parent tree's source.
PARENT_KERNELS = ("l12p",)


def variant_source(src: str, kernel: str, pairs) -> str:
    if kernel == "sel":
        lo, hi = 0, len(src)
    else:
        marks = {"l12": ("fwd_layer12_kernel(const float*", "// B2 sweep B:"),
                 "l12b": ("// B2 sweep A at bf16", "// B2 sweep B at bf16"),
                 "l12p": ("fwd_layer12_kernel(const typename",
                          "// B2 sweep B:"),
                 "gp": ("fwd_gram_pool_kernel(const float*",
                        "// B3 sweep 1:"),
                 "s1": ("bwd_sweep1_kernel(const float*",
                        "// B3 sweep 2 (slim)"),
                 "s2": ("bwd_sweep2_kernel(const float*",
                        "// B3 sweep 3:"),
                 "s3": ("bwd_sweep3_kernel(const float*",
                        "// The bf16 forms of B2a, B2b, B3a, B3b and B3c"),
                 "gpb": ("fwd_gram_pool_bf16_kernel(const __nv_bfloat16",
                         "// B3 sweep 2 (slim) at bf16"),
                 "s2b": ("// B3 sweep 2 (slim) at bf16",
                         "// B3 sweep 1 at bf16"),
                 "s1b": ("// B3 sweep 1 at bf16", "// B3 sweep 3 at bf16"),
                 "s3b": ("// B3 sweep 3 at bf16", "// Every launcher:")}
        lo, hi = (src.index(m) for m in marks[kernel])
    part = src[lo:hi]
    for old, new in pairs:
        if old not in part:
            raise SystemExit(f"chip_ablate: {old!r} not in the kernel")
        part = part.replace(old, new)
    return src[:lo] + part + src[hi:]


#: Phase clocks: a copy of B3a (s1) and B3c (s3) with clock64() read by
#: thread 0 of every block at points of its tile loop (after each barrier
#: and before a few marked lines), the sums written over the first entries
#: of the block's u3 (s1) or [A1 | u1] (s3) partials, which the wrapper
#: sums over blocks. kernel -> (loop head, the text after the loop, the
#: output entry, [(line prefix, "after" or "before", the phase it ends)]).
CLOCKED = {
    "s1": ("  for (int64_t i = 0; i < count; ++i) {",
           "  if (ah == 0) partu[(int64_t)",
           "partu[(int64_t)blockIdx.x * C3W + k]",
           [("    mbar_wait(", "before", "loop"),
            ("    mbar_wait(", "after", "TMA wait"),
            ("    __syncthreads();", "after", "bins, h2"),
            ("    if (threadIdx.x == io) bulk_store_drain_prior", "before",
             "tasks (last warp), A3"),
            ("    __syncthreads();", "after", "barrier"),
            ("    const int ntask = info[TR];", "after", "task info"),
            ("    __syncthreads();", "after", "q3 tasks"),
            ("    fence_async_smem();", "before", "split rows"),
            ("    __syncthreads();", "after", "fence, barrier")]),
    "s3": ("  for (int64_t i = grp; i < count; i += 2) {",
           "    part[(int64_t)blockIdx.x * ne + e] = sum;\n  }",
           "part[(int64_t)blockIdx.x * ne + k]",
           [("    mbar_wait(", "after", "TMA wait"),
            ("    for (int e = gt; e < 8 * TR", "before", "h1"),
            ("    gsync();", "after", "[x | 1], barrier"),
            ("    // dy1 = [h1 > 0]", "before", "h1 M2"),
            ("    // [A1 | u1] += dy1^T", "before", "dy1"),
            ("    gsync();", "before", "A1"),
            ("    gsync();", "after", "barrier")])}


def clocked_source(src: str, kernel: str) -> str:
    loop, last, out, marks = CLOCKED[kernel]
    lo = src.index(loop, src.index({"s1": "bwd_sweep1_kernel(const float*",
                                    "s3": "bwd_sweep3_kernel(const float*"}
                                   [kernel]))
    hi = src.index(last, lo)
    lines, k = [], 0
    for line in src[lo:hi].split("\n"):
        if k < len(marks) and line.startswith(marks[k][0]) and \
                marks[k][1] == "before":
            lines.append(f"    TICK({k});")
            k += 1
        lines.append(line)
        if k < len(marks) and line.startswith(marks[k][0]) and \
                marks[k][1] == "after":
            lines.append(f"    TICK({k});")
            k += 1
    if k != len(marks):
        raise SystemExit(f"chip_ablate: {k} of {len(marks)} clock marks "
                         f"found in {kernel}'s loop")
    body = ("  long long clk_[16] = {}, clk0_ = clock64();\n#define TICK(k) { "
            "const long long clk1_ = clock64(); clk_[k] += clk1_ - clk0_; "
            "clk0_ = clk1_; }\n"
            + "\n".join(lines))
    end = src.index("\n", hi + len(last)) + 1
    tail = (src[hi:end] + "  __syncthreads();\n  if (threadIdx.x == 0)\n"
            f"    for (int k = 0; k < {len(marks)}; ++k) {out} = clk_[k];\n")
    return src[:lo] + body + tail + src[end:]


def precision(cs, libs) -> dict:
    """B2a's arithmetic variants on chip_smoke.py's main-path tensors (the
    model's weights, randn clouds grouped at S = K = 64 and at the fine
    variant's S = 32, K = 128): p2 against float64 (root mean square
    error on the padded rows, the centroid repeated, and on the others),
    the layer-2 ReLU decisions (p2 mul2 + shift2 > 0, float64 statistics)
    that the variant's p2 flips, each variant's device time, and the pair3
    SA chain against float64 (chip_smoke.sa_chain_vs_f64; a miss is
    printed here, not fatal)."""
    from facl_tpu_torch.ops import sa_pair as SP
    from facl_tpu_torch.ops import select as SEL
    from facl_tpu_torch.ops.sa_bwd import _fold_affine
    from facl_tpu_torch.ops.sa_fwd import _finalize
    from facl_tpu_torch.train import Trainer
    dev = "cuda"
    model = Trainer(cs._cfg(64), 100, device=dev).init_state(cs.SEED).model
    layers = [SP.SALayerParams(*(t.detach() for t in lp))
              for lp in model.sa_stage.layers()]
    g = torch.Generator().manual_seed(cs.SEED)
    flat = torch.randn(10, 64, 512, 4, generator=g).to(dev).transpose(
        0, 1).reshape(640, 512, 4).contiguous()
    key = ("sa_pair", "facl_sa_fwd_layer12")
    out = {}
    with cs.swapped([(cs, "check", lambda ok, msg: ok or print(
            f"  miss: {msg}", flush=True))]):
        for S, K in ((64, 64), (32, 128)):
            grouped, _ = SEL.select_gather(flat, S, K, 0.06)
            grouped[:, :3] -= flat[:, :S, :3].transpose(1, 2)[..., None]
            x3 = grouped.reshape(640, 4, S * K)
            R = x3.shape[0] * x3.shape[2]
            rows = x3.transpose(1, 2).reshape(-1, K, 4)
            pad = (rows == rows[:, -1:, :]).all(-1).reshape(-1)
            m1, v1 = SP._moments_from_gram(
                torch.einsum("bcn,bdn->cd", x3, x3), x3.sum((0, 2)),
                layers[0].kernel, layers[0].bias, R)
            mul1, shift1 = _fold_affine(layers[0], m1, v1, 1e-5)
            a12 = (x3, layers[0].kernel, layers[0].bias, mul1, shift1,
                   layers[1].kernel, layers[1].bias)
            p64, s64, ss64 = SP.sa_fwd_layer12_plain(
                *(t.double() for t in a12))
            mul2, shift2 = _fold_affine(
                SP.SALayerParams(*(t.double() for t in layers[1])),
                *_finalize(s64, ss64, R), 1e-5)
            z64 = p64 * mul2 + shift2
            dp = torch.randn(640 * S, 256, generator=g).to(dev)
            SP.sa_fwd_layer12(*a12)
            for name in PRECISION:
                with using_lib(key, libs[name]):
                    ms = cs.device_ms(lambda: SP.sa_fwd_layer12(*a12))[0]
                    e = SP.sa_fwd_layer12(*a12)[0].double() - p64
                    flips = ((e + p64) * mul2 + shift2 > 0) != (z64 > 0)
                    rms = [float(v.pow(2).mean().sqrt())
                           for v in (e[pad], e[~pad])]
                    near = float(z64[flips].abs().min()) if flips.any() \
                        else 0.0
                    print(f"{name} K={K}: {ms:.4f} ms; p2 vs float64 rms "
                          f"{rms[0]:.3e} on padded rows, {rms[1]:.3e} on "
                          f"the others, max {float(e.abs().max()):.3e}; "
                          f"layer-2 ReLU decisions flipped "
                          f"{int(flips.sum())} (the nearest flipped |z| "
                          f"{near:.3e})", flush=True)
                    wk, wt = cs.sa_chain_vs_f64(x3, layers, dp, K, "pair3")
                out[f"{name} K={K}"] = dict(ms=ms, flips=int(flips.sum()),
                                            chain=wk, twins=wt)
    return out


#: --rounding: the card's rate of a bf16 rounding carried back to f32,
#: one value at a time (cvt.rn.bf16.f32, the TF32-pass sweeps' rb) and two
#: at a time (cvt.rn.bf16x2.f32, the bf16 B2b and B3b), against an FMA
#: chain: eight independent chains a thread, 132 x 8 blocks of 256.
ROUNDING_CU = r"""
#include <cuda_bf16.h>
#include <cstdint>
#include <cstdio>
#define ITER 4096
__global__ void one(float* out, float s) {
  float v[8];
  for (int i = 0; i < 8; ++i) v[i] = threadIdx.x * 0.001f + i;
  for (int it = 0; it < ITER; ++it)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __bfloat162float(__float2bfloat16_rn(v[i] * s));
  float a = 0; for (int i = 0; i < 8; ++i) a += v[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = a;
}
__global__ void two(float* out, float s) {
  float v[8];
  for (int i = 0; i < 8; ++i) v[i] = threadIdx.x * 0.001f + i;
  for (int it = 0; it < ITER; ++it)
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      __nv_bfloat162 p = __floats2bfloat162_rn(v[i] * s, v[i + 1] * s);
      uint32_t u = *reinterpret_cast<uint32_t*>(&p);
      v[i] = __uint_as_float(u << 16);
      v[i + 1] = __uint_as_float(u & 0xffff0000u);
    }
  float a = 0; for (int i = 0; i < 8; ++i) a += v[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = a;
}
__global__ void fma_only(float* out, float s) {
  float v[8];
  for (int i = 0; i < 8; ++i) v[i] = threadIdx.x * 0.001f + i;
  for (int it = 0; it < ITER; ++it)
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] * s + 0.5f;
  float a = 0; for (int i = 0; i < 8; ++i) a += v[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = a;
}
int main() {
  float* out;
  cudaMalloc(&out, 132 * 8 * 256 * 4);
  int clk;
  cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  const char* names[3] = {"one at a time", "two at a time", "fma only"};
  void (*ks[3])(float*, float) = {one, two, fma_only};
  for (int k = 0; k < 3; ++k) {
    ks[k]<<<132 * 8, 256>>>(out, 1.0001f);
    cudaEventRecord(a);
    ks[k]<<<132 * 8, 256>>>(out, 1.0001f);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    double vals = 132.0 * 8 * 256 * 8 * ITER;
    printf("rounding %s: %.4f ms, %.1f values a clock an SM at %.0f MHz\n",
           names[k], ms, vals / (ms * 1e-3) / 132 / (clk * 1e3), clk / 1e3);
  }
  return 0;
}
"""


#: B9-bf16's variants (sa_fused.cu, whole file): the kernel; without the
#: k-order redo of the forward sums near a bf16 rounding boundary (no
#: sum flagged); with every redone sum 8 steps long (the redo's listing
#: and one short chain a sum).
B9_VARIANTS = {
    "b9_bf16": [],
    "b9_bf16 without the k-order redo": [(
        "  return win > 0.f && fabsf(static_cast<float>(d)) * ulp <= win;",
        "  return false;")],
    "b9_bf16 with 8-step redo sums": [(
        "  for (int k0 = 0; k0 < kdim; k0 += 8) {\n    const uint4 av",
        "  for (int k0 = 0; k0 < 8; k0 += 8) {\n    const uint4 av")],
}


def b9_bf16(cs, out_dir) -> None:
    """B9-bf16's eight launches of a main-path step (640 clouds x 4,096
    rows, widths 4-64-64-256, pool 64; randn rows, weights scaled by
    sqrt(2 / fan-in)) with each B9_VARIANTS build, twice, in turns. A cut
    variant's outputs are wrong by design; only its time is read."""
    from facl_tpu_torch.ops import sa_kernel as SK
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    from facl_tpu_torch.ops.sa_fwd import _finalize
    libs, _ = build_cuts(out_dir, "sa_fused", None, {
        name: ((), pairs) for name, pairs in B9_VARIANTS.items()}, "b9", {})
    dev = "cuda"
    g = torch.Generator().manual_seed(cs.SEED)
    R, C0, K, widths = 640 * 4096, 4, 64, (64, 64, 256)
    x = torch.randn(R, C0, generator=g).to(dev)
    layers, cin = [], C0
    for w in widths:
        layers.append(SALayerParams(*(t.to(dev) for t in (
            torch.randn(cin, w, generator=g) * (2.0 / cin) ** 0.5,
            0.1 * torch.randn(w, generator=g),
            1 + 0.1 * torch.randn(w, generator=g),
            0.1 * torch.randn(w, generator=g)))))
        cin = w
    dp = torch.randn(R // K, widths[-1], generator=g).to(dev).to(
        torch.bfloat16).float()
    packed = torch.zeros(3, 2, 256, device=dev)
    runs = []
    for l, w in enumerate(widths):
        a = (x, layers, packed.clone(), K, l)
        runs.append((f"stats {l}", SK.sa_fused_stats_bf16, a))
        mean, var = _finalize(*SK.sa_fused_stats_bf16_plain(*a), R)
        packed[l, 0, :w], packed[l, 1, :w] = mean, torch.rsqrt(var + 1e-5)
    runs.append(("pool", SK.sa_fused_pool_bf16, (x, layers, packed, K)))
    bsums = torch.zeros_like(packed)
    for l in reversed(range(3)):
        a = (x, layers, packed, bsums.clone(), dp, K, l)
        runs.append((f"bnsum {l}", SK.sa_fused_bnsum_bf16, a))
        bsums[l, 0, :widths[l]], bsums[l, 1, :widths[l]] = \
            SK.sa_fused_bnsum_bf16_plain(*a)
    runs.append(("final", SK.sa_fused_final_bf16,
                 (x, layers, packed, bsums, dp, K, True)))
    prm = SK._prm(layers, True)
    runs[0][1](*runs[0][2], prm=prm)        # resolves this tree's launcher
    key = ("sa_fused", "facl_sa_fused_bf16")
    times = {name: [[], []] for name in libs}
    for turn in range(2):
        for name, lib in libs.items():
            with using_lib(key, lib):
                for _, fn, args in runs:
                    times[name][turn].append(
                        cs.device_ms(lambda: fn(*args, prm=prm))[0])
    gpu = cs.gpu_name_power()
    for name, (a, b) in times.items():
        print(f"{name}: " + ", ".join(
            f"{n} {u:.4f}/{v:.4f}" for (n, _, _), u, v in zip(runs, a, b))
            + f"; eight {sum(a):.3f} / {sum(b):.3f} ms on the device ({gpu})",
            flush=True)
    print(json.dumps({"b9_bf16": times, "launches": [n for n, _, _ in runs],
                      "gpu": gpu}))


#: B9 at f32 (sa_fused_tf32_kernel): the parts cut, each a set of calls
#: made void inside the kernel's section of sa_fused.cu (from its heading
#: to launch_tf), plus text replaced: the kernel as it is; without the
#: routing and pool passes; without the column sums; without the x
#: prefetch (cp.async of the next tile's rows); without the k-order redo
#: of the masks' sums (no sum near 0 flagged); the products only (every
#: CUDA-core pass cut: routing, pool, column sums, masks, activations,
#: layer 0's product, dx; and the redo, which on such rows flags at
#: random); with the splits by cvt.rna.tf32.f32 (split_rna, defined
#: after the includes) instead of tf32_mma.cuh's integer operations
#: (split); without routing's loads of the pooled cotangent (a constant
#: instead).
NO_REDO = (("  return fabsf(y) <= win;", "  return false;"),)
CVT_SPLIT = (("split(", "split_rna("), ('#include "tf32_mma.cuh"\n', r"""#include "tf32_mma.cuh"
namespace {
__device__ __forceinline__ Split split_rna(float a) {
  Split s;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(s.hi) : "f"(a));
  const float r = __fsub_rn(a, __uint_as_float(s.hi));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(s.lo) : "f"(r));
  return s;
}
}  // namespace
"""))
B9_F32_CUTS = {
    "b9_f32": ((), ()),
    "b9_f32 without routing": (("route_bf", "pool_bf"), ()),
    "b9_f32 without column sums": (("colsums_bf",), ()),
    "b9_f32 without the x prefetch": (("x_fetch", "cp_wait_all"), ()),
    "b9_f32 without the mask redo": ((), NO_REDO),
    "b9_f32 products only": (("route_bf", "pool_bf", "colsums_bf", "mid_bf",
                              "act_tf", "p0_chunk", "dx_part"), NO_REDO),
    "b9_f32 with cvt splits": ((), CVT_SPLIT),
    "b9_f32 without the dout loads": ((), ((
        "const float d = ok ? __ldg(dout + (g0 + g) * wl + cc) : 0.f;",
        "const float d = ok ? 1.f : 0.f;"),)),
}
B9_F32_SECTION = ("// -- B9 at f32 on the TF32 tensor cores", "int launch_tf(")


def void_calls(text: str, names) -> str:
    """``text`` with every call of a function in ``names`` (the name,
    optional template arguments, balanced parentheses) made ((void)0); a
    definition (the name after ``void``) stays."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) +
                     r")(<[^<>()]*>)?\(")
    out, i = [], 0
    for m in pat.finditer(text):
        if m.start() < i or text[:m.start()].rstrip().endswith("void"):
            continue
        depth, k = 0, m.end() - 1
        while True:
            depth += {"(": 1, ")": -1}.get(text[k], 0)
            k += 1
            if depth == 0:
                break
        out.append(text[i:m.start()] + "((void)0)")
        i = k
    return "".join(out) + text[i:]


def section_source(src: str, section, names, pairs) -> str:
    """``src`` with every call of a function in ``names`` made void
    between ``section``'s two markers, and ``pairs`` replaced."""
    if names:
        a = src.index(section[0])
        b = src.index(section[1], a)
        src = src[:a] + void_calls(src[a:b], names) + src[b:]
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"chip_ablate: {old!r} not in the source")
        src = src.replace(old, new)
    return src


def build_cuts(out_dir, source, section, cuts, tag, kernels):
    """Each of ``cuts`` (name -> (calls made void in ``section``, text
    replacements), section_source of csrc/``source``.cu) built by an nvcc
    of its own, all started together: (name -> its library, name -> the ptxas use of each
    kernel whose mangled name holds a key of ``kernels``, labelled by its
    value)."""
    from facl_tpu_torch.ops import _build
    src = open(os.path.join(CSRC, source + ".cu")).read()
    procs = {}
    for i, (name, (names, pairs)) in enumerate(cuts.items()):
        cu, so = out_dir / f"{tag}_{i}.cu", out_dir / f"{tag}_{i}.so"
        cu.write_text(section_source(src, section, names, pairs))
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", os.path.abspath(CSRC),
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, ptxas = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"chip_ablate: {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        use, keep = [], None
        for ln in log.splitlines():       # ptxas: "Compiling entry ..." then
            if "Compiling entry" in ln:   # its use on the next lines
                keep = next((v for k, v in kernels.items() if k in ln), None)
            elif keep and ("registers" in ln or "spill" in ln):
                use.append(f"{keep}: {ln.split(':', 1)[-1].strip()}")
        ptxas[name] = use
    return libs, ptxas


@contextlib.contextmanager
def using_lib(key, lib):
    """_build's launcher ``key`` (module, symbol) taken from ``lib``."""
    from facl_tpu_torch.ops import _build
    ours = _build._FUNCTIONS[key]
    f = getattr(lib, key[1])
    f.argtypes, f.restype = ours[1].argtypes, ctypes.c_int
    _build._FUNCTIONS[key] = (lib, f)
    try:
        yield
    finally:
        _build._FUNCTIONS[key] = ours


def b9_f32(cs, out_dir) -> None:
    """B9's eight f32 launches of a main-path step (640 clouds x 4,096
    rows, widths 4-64-64-256, pool 64; randn rows, weights scaled by
    sqrt(2 / fan-in)) on the TF32 tensor-core kernel with each
    B9_F32_CUTS build, twice, in turns. A cut variant's outputs are wrong
    by design; only its time is read, but the kernel's dx and the dx of
    the build without the mask redo are held against the twin (dout zero
    on chip_smoke's near-tie pairs): rows beyond rtol 1e-5 / atol 1e-5 x
    scale, counted. ptxas use of each build printed."""
    from facl_tpu_torch.ops import sa_kernel as SK
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    from facl_tpu_torch.ops.sa_fwd import _finalize
    libs, ptxas = build_cuts(out_dir, "sa_fused", B9_F32_SECTION,
                             B9_F32_CUTS, "b9f",
                             {"sa_fused_tf32_kernel": "tf32"})
    dev = "cuda"
    g = torch.Generator().manual_seed(cs.SEED)
    R, C0, K, widths = 640 * 4096, 4, 64, (64, 64, 256)
    x = torch.randn(R, C0, generator=g).to(dev)
    layers, cin = [], C0
    for w in widths:
        layers.append(SALayerParams(*(t.to(dev) for t in (
            torch.randn(cin, w, generator=g) * (2.0 / cin) ** 0.5,
            0.1 * torch.randn(w, generator=g),
            1 + 0.1 * torch.randn(w, generator=g),
            0.1 * torch.randn(w, generator=g)))))
        cin = w
    if not SK.f32_on_tensor_cores(R, C0, list(widths), K):
        raise SystemExit("chip_ablate: the main path's net is not on the "
                         "TF32 tensor cores")
    dp = torch.randn(R // K, widths[-1], generator=g).to(dev)
    packed = torch.zeros(3, 2, 256, device=dev)
    runs = []
    for l, w in enumerate(widths):
        a = (x, layers, packed.clone(), K, l)
        runs.append((f"stats {l}", SK.sa_fused_stats, a))
        mean, var = _finalize(*SK.sa_fused_stats_plain(*a), R)
        packed[l, 0, :w], packed[l, 1, :w] = mean, torch.rsqrt(var + 1e-5)
    runs.append(("pool", SK.sa_fused_pool, (x, layers, packed, K)))
    z = cs.b9_z(x.double(), layers, packed)
    near = cs.near_ties(z, K, 1e-5 * float(z.abs().max()))
    del z
    dp = torch.where(near, 0.0, dp)
    bsums = torch.zeros_like(packed)
    for l in reversed(range(3)):
        a = (x, layers, packed, bsums.clone(), dp, K, l)
        runs.append((f"bnsum {l}", SK.sa_fused_bnsum, a))
        bsums[l, 0, :widths[l]], bsums[l, 1, :widths[l]] = \
            SK.sa_fused_bnsum_plain(*a)
    fa = (x, layers, packed, bsums, dp, K, True)
    runs.append(("final", SK.sa_fused_final, fa))
    td = SK.sa_fused_final_plain(*fa)[0]
    prm = SK._prm(layers, False)
    runs[0][1](*runs[0][2], prm=prm)        # resolves this tree's launcher
    key = ("sa_fused", "facl_sa_fused")
    times = {name: [[], []] for name in libs}
    checked = {}
    for turn in range(2):
        for name, lib in libs.items():
            with using_lib(key, lib):
                for _, fn, args in runs:
                    times[name][turn].append(
                        cs.device_ms(lambda: fn(*args, prm=prm))[0])
                if turn == 0 and name in ("b9_f32",
                                          "b9_f32 without the mask redo"):
                    kd = SK.sa_fused_final(*fa, prm=prm)[0]
                    scale = float(td.abs().max())
                    diff = (kd - td).abs()
                    beyond = (diff > 1e-5 * td.abs() + 1e-5 * scale).any(1)
                    checked[name] = [int(beyond.sum()),
                                     float(diff.max()) / scale]
    gpu = cs.gpu_name_power()
    for name, (a, b) in times.items():
        print(f"{name}: " + ", ".join(
            f"{n} {u:.4f}/{v:.4f}" for (n, _, _), u, v in zip(runs, a, b))
            + f"; eight {sum(a):.3f} / {sum(b):.3f} ms on the device ({gpu});"
            f" ptxas {ptxas[name]}", flush=True)
    for name, (nb, wide) in checked.items():
        print(f"{name}: dx {nb} of {R} rows beyond rtol 1e-5 / atol 1e-5 x "
              f"scale of the twin's (widest {wide:.3e} x scale; dout zero on "
              f"{int(near.sum())} near-tie pairs)", flush=True)
    print(json.dumps({"b9_f32": times, "launches": [n for n, _, _ in runs],
                      "dx_rows_beyond": checked, "ptxas": ptxas,
                      "gpu": gpu}))


#: b8a: sa_2sweep.cu's B8a (bwd2_sweep1_kernel) with one part cut at a
#: time: name -> (calls made void, text replacements). "products only"
#: keeps the TMA loads, the four products and the q3 store; "without the
#: TMA prefetch" keeps one stage and issues each tile's copy only when the
#: tile before it is done.
B8A_SECTION = ("// B8a (hybrid2 and hybrid's sweep 1) on the tensor cores",
               "// B6 / B8b:")
B8A_NO_PREFETCH = (
    ("static constexpr int STAGES = BF ? 4 : 2;",
     "static constexpr int STAGES = 1;"),
    ("    for (int64_t i = 0; i < L::STAGES && i < count; ++i) fetch(i);",
     "    if (count > 0) fetch(0);"),
    ("    if (threadIdx.x == 0 && i + L::STAGES < count) fetch(i + L::STAGES);",
     ""),
    ("    mbar_wait(&bars[i % L::STAGES],",
     "    if (threadIdx.x == 0 && i > 0) fetch(i);\n"
     "    mbar_wait(&bars[i % L::STAGES],"))
B8A_CUTS = {
    "b8a": ((), ()),
    "b8a without routing": (("s8_route",), ()),
    "b8a without Gram": (("s8_gram",), ()),
    "b8a without A3": (("s8_a3",), ()),
    "b8a without q3": (("s8_q3",), ()),
    "b8a without the TMA prefetch": ((), B8A_NO_PREFETCH),
    "b8a products only": (("s8_h2", "s8_affine", "s8_route", "s8_dstore"),
                          ()),
}


def b8a(cs, out_dir) -> None:
    """B8a at bf16 and f32 on a main-path shape (640 clouds x 4,096 rows,
    pool 64; randn p2 with each group's last half a copy of its first row,
    as ball query pads a group: ~40% of dy3 nonzero, as on the main path)
    with each B8A_CUTS build, twice, in turns. A cut variant's outputs are
    wrong by design; only its time is read. The full build's outputs are
    held against the twins with dpooled zero on phase 2's near-tie pairs
    (A3 error over max-abs, q3 entries beyond one bf16 ulp or rtol 1e-5 /
    atol 1e-5 x scale), and ptxas use of each build's pool-64 kernels
    printed."""
    from facl_tpu_torch.ops import sa_bwd as SB
    libs, ptxas = build_cuts(out_dir, "sa_2sweep", B8A_SECTION, B8A_CUTS,
                             "b8a", {"bwd2_sweep1_kernelILb1ELi6E": "bf16",
                                     "bwd2_sweep1_kernelILb0ELi6E": "f32"})
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def r(*shape, sc=1.0):
        return sc * torch.randn(*shape, device=dev, generator=g)
    R, K = 640 * 4096, 64
    P = R // K
    p2 = r(R, 64)
    p2v = p2.view(P, K, 64)
    p2v[:, K // 2:] = p2v[:, :1]
    w3, b3 = r(64, 256, sc=0.125), r(256, sc=0.1)
    tail = (r(64, sc=0.3), r(64), w3, b3, r(256, sc=0.2), r(256), r(256))
    dp = r(P, 256)
    bf = torch.bfloat16
    runs, nnz = {}, {}
    for dt, fn in (("bf16", SB.sa_bwd2_sweep1_bf16),
                   ("f32", SB.sa_bwd2_sweep1)):
        x = p2.to(bf) if dt == "bf16" else p2
        if dt == "bf16":                # phase 2's near-ties: the twin's z
            z = SB._z_bf16(SB._h_bf16(x, *tail[:2]), *tail[2:6])
        else:                           # (bf16), a float64 recompute (f32)
            z = (SB._h_from_p(x, *tail[:2]).double() @ w3.double()
                 + b3.double()) * tail[4].double() + tail[5].double()
        d = torch.where(cs.near_ties(z, K, 1e-5 * float(z.abs().max())), 0.0,
                        dp)
        nnz[dt] = int((SB._dy_top(z, d.to(z.dtype), K) != 0).sum())
        del z
        runs[dt] = (fn, "facl_" + fn.__name__,
                    (x, *tail, d.to(x.dtype), K))
    for fn, _, args in runs.values():
        fn(*args)                         # resolves this tree's launchers
    checked = {}
    for dt, (fn, launcher, args) in runs.items():
        k, t = fn(*args), getattr(SB, fn.__name__ + "_plain")(*args)
        a3 = float((k[0] - t[0]).abs().max() / t[0].abs().max())
        if dt == "bf16":
            a, b = k[4].float(), t[4].float()
            n = int(((a - b).abs() > cs.bf16_ulp(
                torch.maximum(a.abs(), b.abs()))).sum())
        else:
            sc = float(t[4].abs().max())
            n = int(((k[4] - t[4]).abs() > 1e-5 * t[4].abs() + 1e-5 * sc)
                    .sum())
        checked[dt] = [a3, n, nnz[dt]]
        del k, t
    times = {name: {dt: [] for dt in runs} for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            for dt, (fn, launcher, args) in runs.items():
                with using_lib(("sa_2sweep", launcher), lib):
                    times[name][dt].append(
                        cs.device_ms(lambda: fn(*args))[0])
    gpu = cs.gpu_name_power()
    for name, by in times.items():
        print(f"{name}: " + ", ".join(
            f"{dt} {a:.4f} / {b:.4f}" for dt, (a, b) in by.items())
            + f" ms on the device ({gpu}); ptxas {ptxas[name]}", flush=True)
    for dt, (a3, n, nnz) in checked.items():
        print(f"b8a {dt} against its twin: A3 {a3:.3e} of its max-abs; q3 "
              f"{n} entries beyond the bar; {nnz} nonzero dy3 of {R * 256}",
              flush=True)
    print(json.dumps({"b8a": times, "checked": checked, "ptxas": ptxas,
                      "gpu": gpu}))


#: b8b: sa_2sweep.cu's bf16 B6 / B8b (bwd2_sweep2_bf16_kernel) with one
#: part cut at a time: name -> (calls made void, text replacements).
#: "without the prefetch" copies each step only when the one before it is
#: done (none ahead); "loads only" keeps the copies, the x transpose and
#: the float64 flushes.
B8B_SECTION = ("// B6 / B8b at bf16 (facl_sa_bwd2_sweep2_bf16)",
               "// B6 / B8b at f32 (facl_sa_bwd2_sweep2)")
B8B_NO_PREFETCH = (
    ("  fetch(0);\n", ""),
    ("    cp_async_wait<0>();\n    __syncthreads();\n"
     "    if (i < count) fetch(i + 1);\n",
     "    __syncthreads();\n    fetch(i);\n    cp_async_wait<0>();\n"
     "    __syncthreads();\n"))
#: The step loop with two block barriers a step: a step's row chain, a
#: barrier, its contraction (two steps of copies in flight).
B8B_TWO_BARRIERS = (
    ("  fetch(0);\n", "  fetch(0);\n  fetch(1);\n"),
    ("    cp_async_wait<0>();\n    __syncthreads();\n"
     "    if (i < count) fetch(i + 1);\n"
     "    if (rows_first && i < count) rows(i);\n"
     "    if (i > 0) contract(i - 1);\n"
     "    if (!rows_first && i < count) rows(i);\n",
     "    cp_async_wait<1>();\n    __syncthreads();\n"
     "    if (i < count) fetch(i + 2);\n"
     "    if (i < count) rows(i);\n    __syncthreads();\n"
     "    if (i < count) contract(i);\n"))
#: The flushes in the step loop replaced by a sum of every accumulator
#: (so that the compiler keeps the products that feed them).
B8B_SINK = ("      s2f_flush<C0>(A, first, m, n, lane, partM, partV, partX, "
            "partU);",
            "      { float z = 0.f; const float* f = &A.a2[0][0];\n"
            "#pragma unroll\n"
            "        for (int q = 0; q < (int)(sizeof(A) / 4); ++q) "
            "z += f[q];\n"
            "        if (z == 1.2345f) partM[0] = z; }")
B8B_CUTS = {
    "b8b": ((), ()),
    "b8b without the row chain": (("s2f_rows",), ()),
    "b8b without the U1 products": (("s2f_u1",), ()),
    "b8b without the n8 tile": (("s2f_n8",), ()),
    "b8b without the contraction": (("s2f_contract",), ()),
    "b8b without the float64 flushes": ((), (B8B_SINK,)),
    "b8b without the prefetch": ((), B8B_NO_PREFETCH),
    "b8b with two barriers a step": ((), B8B_TWO_BARRIERS),
    "b8b with every warp's row chain first": ((), (
        ("const bool rows_first = warp < 8;",
         "const bool rows_first = true;"),)),
    "b8b loads only": (("s2f_rows", "s2f_contract"), ()),
    "b8b flushing every 16 steps": ((), (("S2F_FLUSH = 32;",
                                          "S2F_FLUSH = 16;"),)),
    "b8b flushing every 64 steps": ((), (("S2F_FLUSH = 32;",
                                          "S2F_FLUSH = 64;"),)),
    "b8b flushing all blocks at once": ((), (
        ("(j + 1 + blockIdx.x) % S2F_FLUSH", "(j + 1) % S2F_FLUSH"),)),
}
#: b8b: the builds whose outputs are held against the twins.
B8B_CHECKED = ("b8b", "b8b flushing every 16 steps",
               "b8b flushing every 64 steps")


def b8b(cs, out_dir) -> None:
    """The bf16 B8b (sa_bwd2_sweep2_bf16, x row-major) and B6
    (sa_bwd_sweep2_full_bf16, x channel-major) on the main path's shape
    (640 clouds x 4,096 rows, C0 = 4; p1 and p2 from the bf16 forward's
    twins on randn rows, q3 randn) with each B8B_CUTS build, twice, in
    turns. A cut variant's outputs are wrong by design; only its time is
    read. The B8B_CHECKED builds' outputs are held against the twins
    (cnt1 exact; the widest accumulator error over its max-abs printed
    beside phase 2's ACC2_BAR), and ptxas use of each build's C0 = 4
    kernels printed."""
    from facl_tpu_torch.ops import sa_bwd as SB
    from facl_tpu_torch.ops import sa_fwd as SF
    from facl_tpu_torch.ops import sa_pair as SP
    libs, ptxas = build_cuts(out_dir, "sa_2sweep", B8B_SECTION, B8B_CUTS,
                             "b8b",
                             {"bwd2_sweep2_bf16_kernelILi4ELb0E": "B8b",
                              "bwd2_sweep2_bf16_kernelILi4ELb1E": "B6"})
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def r(*shape, sc=1.0):
        return sc * torch.randn(*shape, device=dev, generator=g)
    R, C0, bf = 640 * 4096, 4, torch.bfloat16
    xr = r(R, C0).to(bf)
    w1, b1, w2 = r(C0, 64, sc=0.3), r(64, sc=0.1), r(64, 64, sc=0.3)
    mul1, shift1, mul2, shift2 = r(64, sc=2.0), r(64), r(64, sc=2.0), r(64)
    p1 = SF.sa_fwd_layer_bf16_plain(xr, w1, b1)[0]
    p2 = SF.sa_fwd_layer_bf16_plain(p1, w2, r(64, sc=0.1), mul1, shift1)[0]
    tail = (p2, mul2, shift2, r(R, 64).to(bf), r(64, 64, sc=0.01),
            r(64, sc=0.1), r(64), w2)
    x3 = xr.view(640, 4096, C0).transpose(1, 2).contiguous()
    runs = {"B8b": (SB.sa_bwd2_sweep2_bf16, SB.sa_bwd2_sweep2_bf16_plain,
                    (xr, p1, mul1, shift1, *tail)),
            "B6": (SP.sa_bwd_sweep2_full_bf16,
                   SP.sa_bwd_sweep2_full_bf16_plain,
                   (x3, w1, b1, mul1, shift1, *tail))}
    key = ("sa_2sweep", "facl_sa_bwd2_sweep2_bf16")
    for fn, _, args in runs.values():
        fn(*args)                         # resolves this tree's launcher
    checked = {}
    for form, (fn, plain, args) in runs.items():
        t = plain(*args)
        for name in B8B_CHECKED:
            with using_lib(key, libs[name]):
                k = fn(*args)
            cs.check(torch.equal(k["cnt1"], t["cnt1"]),
                     f"{name} {form}: cnt1 not exact")
            checked[f"{name} {form}"] = max(
                (float((k[n] - t[n]).abs().max()) /
                 max(float(t[n].abs().max()), 1e-30), n) for n in t)
            del k
        del t
    times = {name: {form: [] for form in runs} for name in libs}
    for _ in range(2):
        for name in libs:
            for form, (fn, _, args) in runs.items():
                with using_lib(key, libs[name]):
                    times[name][form].append(
                        cs.device_ms(lambda: fn(*args))[0])
    gpu = cs.gpu_name_power()
    for name, by in times.items():
        print(f"{name}: " + ", ".join(
            f"{form} {a:.4f} / {b:.4f}" for form, (a, b) in by.items())
            + f" ms on the device ({gpu}); ptxas {ptxas[name]}", flush=True)
    for what, (w, n) in checked.items():
        print(f"{what} against its twin: cnt1 exact; accumulators at most "
              f"{w:.3e} of their max-abs ({n}; bar {cs.ACC2_BAR:g})",
              flush=True)
    print(json.dumps({"b8b": times, "checked": checked, "ptxas": ptxas,
                      "gpu": gpu}))


#: b8b_f32: sa_2sweep.cu's f32 B6 / B8b (bwd2_sweep2_tf32_kernel) with one
#: part cut at a time, as b8b: name -> (calls made void, text
#: replacements); then trials of other forms (wgmma n chunks of 64 or 16;
#: in place of tf32_mma.cuh's split, CUTLASS's, lo = a - hi left for the
#: tensor cores to read in TF32; splits by truncation, hi the f32 value as
#: the tensor cores read it and lo its exact remainder), each a split_v
#: that the section's calls of split reach by a macro.
B8B_F32_SECTION = ("// B6 / B8b at f32 (facl_sa_bwd2_sweep2)", "// -- launchers")
B8B_F32_NO_PREFETCH = (
    ("  fetch(0);\n", ""),
    ("    cp_async_wait<0>();\n"
     "    __syncthreads();                    // step i in; step i - 1 "
     "contracted\n"
     "    fetch(i + 1);                       // the next step's copies\n",
     "    __syncthreads();\n    fetch(i);\n    cp_async_wait<0>();\n"
     "    __syncthreads();\n"))
B8B_F32_SINK = (
    "      s2t_flush<C0, W>(A, first, v, lane, partM, partV, partX, partU);",
    "      { float z = 0.f; const float* f = &A.acc[0][0];\n"
    "#pragma unroll\n"
    "        for (int q = 0; q < (int)(sizeof(A) / 4); ++q) z += f[q];\n"
    "        if (z == 1.2345f) partM[0] = z; }")
B8B_F32_AT = "constexpr int S2T_NT = 512;"


def b8b_f32_split(body):
    """The replacement that makes the section's split the body's."""
    return ((B8B_F32_AT, "__device__ __forceinline__ Split split_v(float a) "
             "{\n" + body + "}\n#define split split_v\n" + B8B_F32_AT),)


B8B_F32_UNROUNDED = b8b_f32_split(
    "  const uint32_t hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;\n"
    "  return Split{hi, __float_as_uint(__fsub_rn(a, __uint_as_float(hi)))};"
    "\n")
B8B_F32_TRUNC = b8b_f32_split(
    "  const uint32_t hi = __float_as_uint(a) & 0xffffe000u;\n"
    "  return Split{__float_as_uint(a), __float_as_uint(\n"
    "      __fsub_rn(a, __uint_as_float(hi)))};\n")
B8B_F32_CUTS = {
    "b8b_f32": ((), ()),
    "b8b_f32 without the row chain": (("s2t_rows",), ()),
    "b8b_f32 without the U1 products": ((), ((
        "      for (int h = 0; h < S2T_NC; ++h) {",
        "      for (int h = 0; h < (kind >= 3 ? 0 : S2T_NC); ++h) {"),)),
    "b8b_f32 without the n8 tile": ((), (
        ("    if constexpr (W == 3) {             // the n8 tile: mq, x",
         "    if constexpr (false) {"),
        ("      if (kind == 2)                    // m1^T [x | 1]",
         "      if (false)"),
        ("      else if (kind < 2)                // dy2^T 1, h1^T 1",
         "      else if (false)"))),
    "b8b_f32 without the contraction": (("s2t_contract",), ()),
    "b8b_f32 without the float64 flushes": ((), (B8B_F32_SINK,)),
    "b8b_f32 without the prefetch": ((), B8B_F32_NO_PREFETCH),
    "b8b_f32 loads only": (("s2t_rows", "s2t_contract"), ()),
    "b8b_f32 flushing every 64 steps": ((), (("S2T_FLUSH = 128;",
                                              "S2T_FLUSH = 64;"),)),
    "b8b_f32 flushing every 256 steps": ((), (("S2T_FLUSH = 128;",
                                               "S2T_FLUSH = 256;"),)),
    "b8b_f32 with n64 chunks": ((), (("S2T_NH = 32;", "S2T_NH = 64;"),)),
    "b8b_f32 with n16 chunks": ((), (("S2T_NH = 32;", "S2T_NH = 16;"),)),
    "b8b_f32 with unrounded lo splits": ((), B8B_F32_UNROUNDED),
    "b8b_f32 with truncating splits": ((), B8B_F32_TRUNC),
}
#: b8b_f32: the builds whose outputs are held against the twins.
B8B_F32_CHECKED = ("b8b_f32", "b8b_f32 flushing every 64 steps",
                   "b8b_f32 flushing every 256 steps",
                   "b8b_f32 with n64 chunks", "b8b_f32 with n16 chunks",
                   "b8b_f32 with unrounded lo splits",
                   "b8b_f32 with truncating splits")


def b8b_f32(cs, out_dir, parent=None) -> None:
    """The f32 B8b (sa_bwd2_sweep2, x row-major) and B6
    (sa_bwd_sweep2_full, x channel-major) on the main path's shape (640
    clouds x 4,096 rows, C0 = 4; p1 and p2 from the forward's twins on
    randn rows, q3 randn) with each B8B_F32_CUTS build, twice, in turns. A
    cut variant's outputs are wrong by design; only its time is read. The
    B8B_F32_CHECKED builds' outputs are held against the twins (the widest
    accumulator error over its max-abs printed beside phase 2's f32 bar,
    1e-4; cnt1 exact for B8b; B6's h1 is the k-order chain and its twin's
    a matmul, so B6's cnt1 is held to the full build's and its entries
    off the twin's are counted), and ptxas use of each build's C0 = 4
    kernels printed. With ``parent`` (a tree's root), that tree's
    sa_2sweep.cu is built too and timed in the same turns at its own
    wrapper's grid (two blocks an SM), and its outputs are compared the
    same way, its cnt1 entries off the twin's and off the full build's
    counted (not checked)."""
    from facl_tpu_torch.ops import sa_bwd as SB
    from facl_tpu_torch.ops import sa_fwd as SF
    from facl_tpu_torch.ops import sa_pair as SP
    if parent:                            # started before the cuts' nvccs
        started = cs.start_parent_build(parent, ("sa_2sweep",))
    libs, ptxas = build_cuts(out_dir, "sa_2sweep", B8B_F32_SECTION,
                             B8B_F32_CUTS, "b8bf",
                             {"bwd2_sweep2_tf32_kernelILi4ELb0E": "B8b",
                              "bwd2_sweep2_tf32_kernelILi4ELb1E": "B6"})
    checked_names = B8B_F32_CHECKED
    grids = {}
    if parent:
        cs.load_parent(started)
        libs["parent"] = cs.PARENT["sa_2sweep"]
        ptxas["parent"] = []
        grids["parent"] = cs.parent_grid_swaps("sa_2sweep", 2)
        checked_names += ("parent",)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def r(*shape, sc=1.0):
        return sc * torch.randn(*shape, device=dev, generator=g)
    R, C0 = 640 * 4096, 4
    xr = r(R, C0)
    w1, b1, w2 = r(C0, 64, sc=0.3), r(64, sc=0.1), r(64, 64, sc=0.3)
    mul1, shift1, mul2, shift2 = r(64, sc=2.0), r(64), r(64, sc=2.0), r(64)
    p1 = SF.sa_fwd_layer_plain(xr, w1, b1)[0]
    p2 = SF.sa_fwd_layer_plain(p1, w2, r(64, sc=0.1), mul1, shift1)[0]
    tail = (p2, mul2, shift2, r(R, 64), r(64, 64, sc=0.01), r(64, sc=0.1),
            r(64), w2)
    x3 = xr.view(640, 4096, C0).transpose(1, 2).contiguous()
    runs = {"B8b": (SB.sa_bwd2_sweep2, SB.sa_bwd2_sweep2_plain,
                    (xr, p1, mul1, shift1, *tail)),
            "B6": (SP.sa_bwd_sweep2_full, SP.sa_bwd_sweep2_full_plain,
                   (x3, w1, b1, mul1, shift1, *tail))}
    key = ("sa_2sweep", "facl_sa_bwd2_sweep2")
    for fn, _, args in runs.values():
        fn(*args)                         # resolves this tree's launcher

    def build(name):
        """The block that runs the wrapper on build ``name``."""
        stack = contextlib.ExitStack()
        stack.enter_context(using_lib(key, libs[name]))
        stack.enter_context(cs.swapped(grids.get(name, [])))
        return stack
    checked = {}
    for form, (fn, plain, args) in runs.items():
        t = plain(*args)
        acc = {n: v for n, v in t.items() if n != "cnt1"}
        cnt = None
        for name in checked_names:
            with build(name):
                k = fn(*args)
            off = int((k["cnt1"] != t["cnt1"]).sum())
            cnt = k["cnt1"] if cnt is None else cnt     # the full build's
            if name == "parent":
                print(f"parent {form}: cnt1 entries off the twin's {off}, "
                      "off this tree's full build's "
                      f"{int((k['cnt1'] != cnt).sum())}", flush=True)
            elif form == "B8b":
                cs.check(off == 0, f"{name} {form}: cnt1 not exact")
            else:
                cs.check(torch.equal(k["cnt1"], cnt),
                         f"{name} {form}: cnt1 not the full build's")
            checked[f"{name} {form}"] = cs.sweep2_share(k, acc) + (off,)
            del k
        del t
    times = {name: {form: [] for form in runs} for name in libs}
    for _ in range(2):
        for name in libs:
            for form, (fn, _, args) in runs.items():
                with build(name):
                    times[name][form].append(
                        cs.device_ms(lambda: fn(*args))[0])
    gpu = cs.gpu_name_power()
    for name, by in times.items():
        print(f"{name}: " + ", ".join(
            f"{form} {a:.4f} / {b:.4f}" for form, (a, b) in by.items())
            + f" ms on the device ({gpu}); ptxas {ptxas[name]}", flush=True)
    for what, (w, n, off) in checked.items():
        print(f"{what} against its twin: accumulators at most {w:.3e} of "
              f"their max-abs ({n}; bar 1e-4); cnt1 entries off the twin's "
              f"{off}", flush=True)
    print(json.dumps({"b8b_f32": times, "checked": checked, "ptxas": ptxas,
                      "gpu": gpu}))


#: tc_sums: sa_fused.cu's own fwd_mma (with its k-order redo) and the
#: sums its tensor cores make before the redo, with S = sum_k A |W|, on
#: 128-row tiles of A (M x kdim, bf16) times W (kdim x 64, bf16).
TC_SUMS_CU = r"""
#include "sa_fused.cu"
namespace {
constexpr int PR = 128;
__global__ void __launch_bounds__(NTB, 1)
probe(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
      int kdim, const float* zero, float* __restrict__ p,
      float* __restrict__ tc, float* __restrict__ sab) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int lda = ldh(kdim), ldw = ldh(CH), ldo = ldf(CH);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(sm);
  __nv_bfloat16* Ws = As + PR * lda;
  float* out = reinterpret_cast<float*>(Ws + kdim * ldw);
  int* wrk = reinterpret_cast<int*>(out + PR * ldo);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * PR;
  for (int e = threadIdx.x; e < PR * kdim; e += NTB)
    As[(e / kdim) * lda + e % kdim] = A[r0 * kdim + e];
  for (int e = threadIdx.x; e < kdim * CH; e += NTB)
    Ws[(e / CH) * ldw + e % CH] = W[e];
  __syncthreads();
  fwd_mma<PR>(As, lda, kdim, Ws, ldw, 0, CH, zero, out, ldo, wrk, true);
  __syncthreads();
  for (int e = threadIdx.x; e < PR * CH; e += NTB)
    p[r0 * CH + e] = out[(e / CH) * ldo + e % CH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int u = warp; u < (PR / 16) * (CH / 16); u += NWB) {
    const int m0 = 16 * (u % (PR / 16)), n0 = 16 * (u / (PR / 16));
    float acc[2][4] = {}, sa[2][4] = {};
    const __nv_bfloat16* pa = As + (m0 + (lane & 15)) * lda + ((lane >> 4) << 3);
    const __nv_bfloat16* pb = Ws + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldw +
                              n0 + ((lane >> 4) << 3);
    for (int k0 = 0; k0 < kdim; k0 += 16) {
      uint32_t a[4], b[4];
      ldsm4(a, pa + k0);
      ldsm4t(b, pb + k0 * ldw);
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
      for (int q = 0; q < 4; ++q) b[q] &= 0x7fff7fffu;
      mma_bf16(sa[0], a, b[0], b[1]);
      mma_bf16(sa[1], a, b[2], b[3]);
    }
    for (int h = 0; h < 2; ++h)
      for (int q = 0; q < 4; ++q) {
        const int64_t i = (r0 + m0 + g + 8 * (q >> 1)) * CH + n0 + 8 * h +
                          2 * t + (q & 1);
        tc[i] = acc[h][q];
        sab[i] = sa[h][q];
      }
  }
}
}  // namespace
extern "C" int facl_tc_sums(const void* A, const void* W, long long M,
                            int kdim, const float* zero, float* p, float* tc,
                            float* sab) {
  const size_t smem = 2 * (PR * ldh(kdim) + kdim * ldh(CH)) +
                      4 * PR * ldf(CH) + 4 * FIXW * NWB;
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  probe<<<static_cast<unsigned>(M / PR), NTB, smem>>>(
      static_cast<const __nv_bfloat16*>(A),
      static_cast<const __nv_bfloat16*>(W), kdim, zero, p, tc, sab);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def tc_sums(cs, out_dir) -> None:
    """Build TC_SUMS_CU and hold B9-bf16's forward sums against the k-order
    chain (fmaf from 0, k ascending; here in torch: each bf16 product is
    exact in f32, so an f32 add is the fmaf) on 262,144 x 64 sums a case:
    kdim 64, 128, 256 (the main path's layer 2 is 64; 256 is the range's
    widest) and three kinds of input: "bench" (A = relu of a normal, W
    normal at sqrt(2 / kdim), as bench.py's step), "heavy" (A and W
    heavy-tailed: a t(2) activation, W with a log-normal scale of sigma
    1.5) and "spread" (each k's column of A, and each entry of W, scaled
    by a power of two up to 2^10 and 2^6 apart). Per case: the largest
    |tensor-core sum - chain| in units of 2^-24 S (fwd_mma's window is 16
    + kdim / 2 of them), their mean, the sums beyond half the window, the
    share of sums the window sends to the redo,
    the sums whose bf16 rounding the tensor cores alone get wrong, and the
    sums fwd_mma still gets wrong (p != bf16(chain))."""
    from facl_tpu_torch.ops import _build
    cu, so = out_dir / "tc_sums.cu", out_dir / "tc_sums.so"
    cu.write_text(TC_SUMS_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    os.path.abspath(CSRC), "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.facl_tc_sums
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev, M, N = "cuda", 128 * 2048, 64
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    bf = torch.bfloat16

    def inputs(kind, kdim):
        a = torch.randn(M, kdim, device=dev, generator=g)
        w = torch.randn(kdim, N, device=dev, generator=g) * (2 / kdim) ** 0.5
        if kind == "heavy":
            chi = (torch.randn(M, kdim, device=dev, generator=g) ** 2 +
                   torch.randn(M, kdim, device=dev, generator=g) ** 2) / 2
            a = a / chi.sqrt().clamp_min(1e-3)
            w = w * torch.exp(1.5 * torch.randn(kdim, N, device=dev,
                                                generator=g))
        elif kind == "spread":
            a = a * torch.exp2(torch.randint(-5, 6, (1, kdim), device=dev,
                                             generator=g).float())
            w = w * torch.exp2(torch.randint(-3, 4, (kdim, N), device=dev,
                                             generator=g).float())
        return torch.relu(a).to(bf).contiguous(), w.to(bf).contiguous()

    zero = torch.zeros(N, device=dev)
    rows = {}
    for kdim in (64, 128, 256):
        for kind in ("bench", "heavy", "spread"):
            a, w = inputs(kind, kdim)
            p, tc, sab = (torch.empty(M, N, device=dev) for _ in range(3))
            code = fn(a.data_ptr(), w.data_ptr(), M, kdim, zero.data_ptr(),
                      p.data_ptr(), tc.data_ptr(), sab.data_ptr())
            if code:
                raise SystemExit(f"chip_ablate: tc_sums launch failed ({code})")
            af, wf = a.float(), w.float()
            chain = torch.zeros(M, N, device=dev)
            for k in range(kdim):
                chain = chain + af[:, k:k + 1] * wf[k]
            ref = chain.to(bf).float()
            live = sab > 0
            units = ((tc - chain).abs() / (sab * 2.0 ** -24))[live]
            bits = tc.view(torch.int32)
            ulp = torch.exp2(((bits >> 23) & 0xff).float() - 150)
            d = ((bits & 0xffff) - 0x8000).abs().float() * ulp
            flagged = live & (d <= (16 + kdim / 2) * 2.0 ** -24 * sab)
            rows[f"kdim {kdim} {kind}"] = dict(
                sums=M * N, max_units=float(units.max()),
                mean_units=float(units.mean()),
                beyond_half_window=int((units > 8 + kdim / 4).sum()),
                window_units=16 + kdim / 2,
                flagged_share=float(flagged.float().mean()),
                tc_rounding_wrong=int((tc.to(bf).float() != ref).sum()),
                fwd_mma_wrong=int((p != ref).sum()))
            print(f"kdim {kdim} {kind}: " + ", ".join(
                f"{k} {v}" for k, v in rows[f"kdim {kdim} {kind}"].items()),
                flush=True)
    print(json.dumps({"tc_sums": rows, "gpu": cs.gpu_name_power()}))


#: tc_sums_tf: sa_fused.cu's own fwd_tf on 64-row tiles of A (M x kdim,
#: f32, A >= 0 as a ReLU's output) times W (kdim x 64, f32): the
#: tensor-core sums without the mask redo (tc), with it (p; ay = 1, by =
#: 0, so the mask is p > 0), and the k-order chain (kdot_tf) of every sum.
TC_SUMS_TF_CU = r"""
#include "sa_fused.cu"
namespace {
constexpr int PT = CH;
__global__ void __launch_bounds__(NTB, 1)
probe_tf(const float* __restrict__ A, const float* __restrict__ W, int kdim,
         const float* zero, const float* one, float* __restrict__ tc,
         float* __restrict__ p, float* __restrict__ chain) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int lda = ldf(kdim), ldw = ldt(CH);
  float* As = reinterpret_cast<float*>(sm);
  float* Ws = As + PT * lda;
  float* out = Ws + kdim * ldw;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * PT;
  for (int e = threadIdx.x; e < PT * kdim; e += NTB)
    As[(e / kdim) * lda + e % kdim] = A[r0 * kdim + e];
  for (int e = threadIdx.x; e < kdim * CH; e += NTB)
    Ws[(e / CH) * ldw + e % CH] = W[e];
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    fwd_tf<PT>(As, lda, kdim, kdim, Ws, ldw, 0, CH, zero, one, zero, out,
               ldw, pass == 1);
    __syncthreads();
    float* dst = pass ? p : tc;
    for (int e = threadIdx.x; e < PT * CH; e += NTB)
      dst[r0 * CH + e] = out[(e / CH) * ldw + e % CH];
    __syncthreads();
  }
  for (int e = threadIdx.x; e < PT * CH; e += NTB)
    chain[r0 * CH + e] = kdot_tf(As + (e / CH) * lda, Ws + e % CH, ldw, kdim);
}
}  // namespace
extern "C" int facl_tc_sums_tf(const float* A, const float* W, long long M,
                               int kdim, const float* zero, const float* one,
                               float* tc, float* p, float* chain) {
  const size_t smem = 4 * (PT * ldf(kdim) + (kdim + PT) * ldt(CH));
  cudaFuncSetAttribute(probe_tf, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  probe_tf<<<static_cast<unsigned>(M / PT), NTB, smem>>>(A, W, kdim, zero,
                                                         one, tc, p, chain);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def tc_sums_tf(cs, out_dir) -> None:
    """Build TC_SUMS_TF_CU and hold B9-f32's forward sums (fwd_tf) against
    the k-order chain (kdot_tf) on 262,144 x 64 sums a case, at kdim 64,
    128 and 256 and tc_sums' three kinds of input (bench, heavy, spread),
    in f32. Per case: the largest and mean |tensor-core sum - chain| in
    units of 2^-24 S (S = sum_k A |W| in float64; near_zero's window is 4
    kdim + 64 of them), the sums beyond half the window, the share the
    window sends to the redo, the chain's own largest distance from the
    float64 sum in the same units, the masks (p > 0) the tensor cores
    alone get wrong against the chain, and those fwd_tf still gets
    wrong."""
    from facl_tpu_torch.ops import _build
    cu, so = out_dir / "tc_sums_tf.cu", out_dir / "tc_sums_tf.so"
    cu.write_text(TC_SUMS_TF_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    os.path.abspath(CSRC), "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).facl_tc_sums_tf
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    dev, M, N = "cuda", 64 * 4096, 64
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def inputs(kind, kdim):
        a = torch.randn(M, kdim, device=dev, generator=g)
        w = torch.randn(kdim, N, device=dev, generator=g) * (2 / kdim) ** 0.5
        if kind == "heavy":
            chi = (torch.randn(M, kdim, device=dev, generator=g) ** 2 +
                   torch.randn(M, kdim, device=dev, generator=g) ** 2) / 2
            a = a / chi.sqrt().clamp_min(1e-3)
            w = w * torch.exp(1.5 * torch.randn(kdim, N, device=dev,
                                                generator=g))
        elif kind == "spread":
            a = a * torch.exp2(torch.randint(-5, 6, (1, kdim), device=dev,
                                             generator=g).float())
            w = w * torch.exp2(torch.randint(-3, 4, (kdim, N), device=dev,
                                             generator=g).float())
        return torch.relu(a).contiguous(), w.contiguous()

    zero, one = torch.zeros(N, device=dev), torch.ones(N, device=dev)
    rows = {}
    for kdim in (64, 128, 256):
        for kind in ("bench", "heavy", "spread"):
            a, w = inputs(kind, kdim)
            tc, p, chain = (torch.empty(M, N, device=dev) for _ in range(3))
            code = fn(a.data_ptr(), w.data_ptr(), M, kdim, zero.data_ptr(),
                      one.data_ptr(), tc.data_ptr(), p.data_ptr(),
                      chain.data_ptr())
            if code:
                raise SystemExit(
                    f"chip_ablate: tc_sums_tf launch failed ({code})")
            ad, wd = a.double(), w.double()
            S = ad @ wd.abs()
            exact = ad @ wd
            live = S > 0
            unit = S * 2.0 ** -24
            units = ((tc.double() - chain.double()).abs() / unit)[live]
            chain_units = ((chain.double() - exact).abs() / unit)[live]
            win = 4 * kdim + 64
            flagged = live & (tc.double().abs() <= win * unit +
                              2.0 ** -22 * tc.double().abs())
            rows[f"kdim {kdim} {kind}"] = dict(
                sums=M * N, max_units=float(units.max()),
                mean_units=float(units.mean()),
                beyond_half_window=int((units > win / 2).sum()),
                window_units=win,
                flagged_share=float(flagged.double().mean()),
                chain_max_units=float(chain_units.max()),
                tc_mask_wrong=int(((tc > 0) != (chain > 0)).sum()),
                fwd_tf_mask_wrong=int(((p > 0) != (chain > 0)).sum()))
            print(f"kdim {kdim} {kind}: " + ", ".join(
                f"{k} {v}" for k, v in rows[f"kdim {kdim} {kind}"].items()),
                flush=True)
            del ad, wd, S, exact
    print(json.dumps({"tc_sums_tf": rows, "gpu": cs.gpu_name_power()}))


def rounding(out_dir) -> None:
    """Build and run ROUNDING_CU (--rounding)."""
    from facl_tpu_torch.ops import _build
    src, exe = out_dir / "rounding.cu", out_dir / "rounding"
    src.write_text(ROUNDING_CU)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(exe), str(src)], check=True)
    print(subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout, end="", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_ablate: needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    import facl_tpu_torch  # noqa: F401  (sets TF32 off)
    from facl_tpu_torch.ops import _build
    from facl_tpu_torch.ops import sa_pair as SP
    from facl_tpu_torch.ops import select as SEL

    src = {f: open(os.path.join(CSRC, f + ".cu")).read()
           for f in ("sa_pair", "select")}
    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    args = sys.argv[1:]
    parent = None                      # --parent DIR: a parent tree's sources
    if "--parent" in args:
        at = args.index("--parent")
        parent = args[at + 1]
        del args[at:at + 2]
        src["parent"] = open(os.path.join(parent, CSRC, "sa_pair.cu")).read()
    only = tuple(args)                   # kernel names: every variant of
    if only == ("rounding",):
        rounding(out_dir)
        print(json.dumps({"gpu": cs.gpu_name_power()}))
        return
    if only == ("b9_bf16",):
        b9_bf16(cs, out_dir)
        return
    if only == ("b9_f32",):
        b9_f32(cs, out_dir)
        return
    if only == ("b8a",):
        b8a(cs, out_dir)
        return
    if only == ("b8b",):
        b8b(cs, out_dir)
        return
    if only == ("b8b_f32",):
        b8b_f32(cs, out_dir, parent)
        return
    if only == ("tc_sums",):
        tc_sums(cs, out_dir)
        return
    if only == ("tc_sums_tf",):
        tc_sums_tf(cs, out_dir)
        return
    if only == ("precision",):
        sources = {name: variant_source(src["sa_pair"], "l12", pairs)
                   for name, pairs in PRECISION.items()}
    else:
        sources = {name: variant_source(
            src["parent" if kernel in PARENT_KERNELS else
                KERNEL_SRC[kernel][0]], kernel, pairs)     # those only
                   for name, (kernel, pairs) in VARIANTS.items()
                   if (not only or name.split()[0] in only) and
                   (parent or kernel not in PARENT_KERNELS)}
    for kernel in ("s1", "s3"):
        if not only or {"s1": "sweep1", "s3": "sweep3"}[kernel] in only:
            sources[f"{kernel} clocks"] = clocked_source(src["sa_pair"],
                                                         kernel)
    reported = {n: fn for v, (base, fn) in CHECKED.items() for n in (v, base)
                if v in sources}
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        inc = os.path.join(parent, CSRC) if name in VARIANTS and \
            VARIANTS[name][0] in PARENT_KERNELS else CSRC  # its headers
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *(_build.NVCC_FLAGS if name in reported else
                               flags), "-I", os.path.abspath(inc), "-o",
             str(out_dir / f"v{i}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out_dir / f"v{i}.so")
    _build.build_all()
    libs, ptxas = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"chip_ablate: {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        if name in reported:          # the 3 lines after the kernel's entry
            lines = log.splitlines()
            at = next(i for i, line in enumerate(lines)
                      if "Compiling entry function" in line and
                      reported[name] in line)
            ptxas[name] = "; ".join(
                line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4]
                if "spill" in line or "registers" in line)
    if only == ("precision",):
        print(json.dumps({"precision": precision(cs, libs),
                          "gpu": cs.gpu_name_power()}))
        return

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def r(*shape, sc=1.0):
        return sc * torch.randn(*shape, device=dev, generator=g)
    Bc, C0, N, K = 640, 4, 4096, 64
    bf = torch.bfloat16
    R = Bc * N
    x3 = r(Bc, C0, N)
    w1, b1 = r(C0, 64, sc=0.5), r(64, sc=0.1)
    w2, w3, b3 = r(64, 64, sc=0.125), r(64, 256, sc=0.125), r(256, sc=0.1)
    b2 = b3[:64].contiguous()
    mul1, shift1, mul2, shift2 = r(64), r(64), r(64, sc=0.3), r(64)
    p2, q3 = r(R, 64), r(R, 64, sc=0.1)
    M3, rc3, gi2 = r(64, 64, sc=0.01), r(64, sc=0.1), r(64)
    P = R // K
    u = torch.rand(P, 256, device=dev, generator=g)
    idx = torch.where(u < 0.47, 0, torch.where(u < 0.84, K, torch.randint(
        0, K, (P, 256), device=dev, generator=g))).to(torch.int32)
    # B1 on chip_smoke.py's body-like slab clouds (a selection at almost
    # every centroid) and on randn clouds (none): 640 x 512 points.
    gs = torch.Generator().manual_seed(cs.SEED + 6)
    slab = cs.slab_clouds(Bc, 512, 4, gs).to(dev)
    rnd = torch.randn(Bc, 512, 4, generator=gs).to(dev)
    calls = {"l12": (SP.sa_fwd_layer12, (x3, w1, b1, mul1, shift1, w2, b2),
                     "facl_sa_fwd_layer12"),
             "l12b": (SP.sa_fwd_layer12_bf16, (x3.to(bf), w1, b1, mul1,
                                               shift1, w2, b2),
                      "facl_sa_fwd_layer12_bf16"),
             "sel": (SEL.select_gather, (slab, 64, K, 0.06, True),
                     "facl_select_gather"),
             "sel randn": (SEL.select_gather, (rnd, 64, K, 0.06, True),
                           "facl_select_gather"),
             "gp": (SP.sa_fwd_gram_pool, (p2, mul2, shift2, w3, b3, K),
                    "facl_sa_fwd_gram_pool"),
             "s1": (SP.sa_bwd_sweep1, (p2, mul2, shift2, r(P, 256), idx,
                                       r(256), w3, K), "facl_sa_bwd_sweep1"),
             "s2": (SP.sa_bwd_sweep2, (x3, w1, b1, mul1, shift1, p2, mul2,
                                       shift2, q3, M3, rc3, gi2, w2),
                    "facl_sa_bwd_sweep2"),
             "s3": (SP.sa_bwd_sweep3, (x3, w1, b1, mul1, shift1, q3,
                                       r(64, 64, sc=0.1), rc3),
                    "facl_sa_bwd_sweep3"),
             "gpb": (SP.sa_fwd_gram_pool_bf16,
                     (p2.to(bf), mul2, shift2, w3, b3, K),
                     "facl_sa_fwd_gram_pool_bf16"),
             "s2b": (SP.sa_bwd_sweep2_bf16, (x3.to(bf), w1, b1, mul1, shift1,
                                             p2.to(bf), mul2, shift2,
                                             q3.to(bf), M3, rc3, gi2, w2),
                     "facl_sa_bwd_sweep2_bf16"),
             "s1b": (SP.sa_bwd_sweep1_bf16, (p2.to(bf), mul2, shift2,
                                             r(P, 256).to(bf), idx, r(256),
                                             w3, K),
                     "facl_sa_bwd_sweep1_bf16"),
             "s3b": (SP.sa_bwd_sweep3_bf16, (x3.to(bf), w1, b1, mul1, shift1,
                                             q3.to(bf), r(64, 64, sc=0.1),
                                             rc3),
                     "facl_sa_bwd_sweep3_bf16")}
    calls["l12p"] = calls["l12b"]         # the parent's form, same call
    for fn, args, _ in calls.values():
        fn(*args)                         # resolves this tree's launchers

    def with_variant(name, call, run):
        """run(fn, args) with variant name's launcher in the kernel's."""
        kernel = VARIANTS[name][0]
        fn, args, launcher = calls[call or kernel]
        with using_lib((KERNEL_SRC[kernel][0], launcher), libs[name]):
            return run(fn, args)

    def timed(name, call=None):
        return with_variant(name, call,
                            lambda fn, args: cs.device_ms(
                                lambda: fn(*args))[0])

    def checked(name):
        """max |variant - kernel| / max |kernel| of each output."""
        fn, args, _ = calls[VARIANTS[name][0]]
        want = fn(*args)
        got = with_variant(name, None, lambda fn, args: fn(*args))
        return [float((a.float() - b.float()).abs().max() /
                      b.float().abs().max()) for a, b in zip(got, want)]

    def clocks(kernel):
        """Mean cycles per tile of each phase (thread 0 of each block)."""
        fn, args, launcher = calls[kernel]
        with using_lib(("sa_pair", launcher), libs[f"{kernel} clocks"]):
            fn(*args)
            out = fn(*args)
        torch.cuda.synchronize()
        phases = [m[2] for m in CLOCKED[kernel][-1]]
        flat = out[1] if kernel == "s1" else \
            torch.cat([out[0], out[1][:, None]], 1).reshape(-1)
        tiles = R / 64 / (1 if kernel == "s1" else 2)   # per thread 0
        return {p: float(flat[k]) / tiles for k, p in enumerate(phases)}

    runs = [(name, None) for name in sources if not name.endswith("clocks")]
    runs += [(f"{name} [randn]", name) for name, _ in runs
             if VARIANTS[name][0] == "sel"]
    times = {name: [] for name, _ in runs}
    for _ in range(2):
        for name, base in runs:
            times[name].append(timed(base or name,
                                     "sel randn" if base else None))
    cyc = {k: clocks(k) for k in ("s1", "s3") if f"{k} clocks" in libs}
    errs = {name: checked(name) for name in CHECKED if name in libs}
    gpu = cs.gpu_name_power()
    for name, ms in times.items():
        print(f"{name}: {ms[0]:.4f} / {ms[1]:.4f} ms on the device ({gpu})",
              flush=True)
    for name, e in errs.items():
        print(f"{name}: max |variant - kernel| / max |kernel| by output: "
              + ", ".join(f"{v:.3e}" for v in e), flush=True)
    for name, use in ptxas.items():
        print(f"ptxas {name}: {use}", flush=True)
    for k, ph in cyc.items():
        print(f"{k} phase clocks (cycles per tile, thread 0, mean over "
              f"blocks): " + ", ".join(f"{p} {c:.0f}" for p, c in ph.items()),
              flush=True)
    print(json.dumps({"ablation": times, "clocks": cyc, "checked": errs,
                      "ptxas": ptxas, "gpu": gpu}))


if __name__ == "__main__":
    main()
