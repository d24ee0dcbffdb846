#!/usr/bin/env python3
"""Where the redesigned SA sweeps B2b (sa_fwd_gram_pool), B3a
(sa_bwd_sweep1), B3b (sa_bwd_sweep2) and B3c (sa_bwd_sweep3) spend their
time on the card.

    python3 chip_ablate.py                  # one CUDA device, nvcc
    python3 chip_ablate.py sweep1 sweep3    # those kernels' variants only

Each kernel is rebuilt from facl_tpu_torch/ops/csrc/sa_pair.cu with one
part cut out (the pool, the Gram, a product, the CUDA-core row passes;
B3a's A3, its q3 rows, its row bins), and every variant is timed by
chip_smoke.device_ms on the main path's shapes (640 clouds x 4,096 rows,
random data; B3a's argmax rows skewed as chip_smoke.py reads them on
the main path: 47% of a group's channels on its first row, 37% dead, the
rest spread), twice, in turns. A
variant's outputs are wrong by design; only its time is read. The full
kernel's time less a variant's is what the part costs where it overlaps
nothing else. Exits nonzero without a card or if a variant does not
build; prints one JSON line {"ablation": {variant: [ms, ms]}, "gpu": ...}.
"""
from __future__ import annotations

import ctypes
import json
import os
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
#: variant -> (kernel, [(text, replacement)]) on that kernel's source.
VARIANTS = {
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
        ("    h1_rows(X, C0, W1s, v, h1h, h1l, m1, threadIdx.x, NTM);\n", "")]),
    "sweep2 without the row passes": ("s2", [
        ("    relu_rows(S, mul2, shift2, H2);\n"
         "    h1_rows(X, C0, W1s, v, h1h, h1l, m1, threadIdx.x, NTM);\n",
         "")]),
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
}


def variant_source(src: str, kernel: str, pairs) -> str:
    lo, hi = {"gp": (src.index("fwd_gram_pool_kernel(const float*"),
                     src.index("// B3 sweep 1:")),
              "s1": (src.index("bwd_sweep1_kernel(const float*"),
                     src.index("// B3 sweep 2 (slim)")),
              "s2": (src.index("bwd_sweep2_kernel(const float*"),
                     src.index("// B3 sweep 3:")),
              "s3": (src.index("bwd_sweep3_kernel(const float*"),
                     src.index("}  // namespace"))}[kernel]
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_ablate: needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    import facl_tpu_torch  # noqa: F401  (sets TF32 off)
    from facl_tpu_torch.ops import _build
    from facl_tpu_torch.ops import sa_pair as SP

    src = open(os.path.join(CSRC, "sa_pair.cu")).read()
    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    only = tuple(sys.argv[1:])           # kernel names: every variant of
    sources = {name: variant_source(src, kernel, pairs)   # those only
               for name, (kernel, pairs) in VARIANTS.items()
               if not only or name.split()[0] in only}
    for kernel in ("s1", "s3"):
        if not only or {"s1": "sweep1", "s3": "sweep3"}[kernel] in only:
            sources[f"{kernel} clocks"] = clocked_source(src, kernel)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *flags, "-I", os.path.abspath(CSRC), "-o",
             str(out_dir / f"v{i}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out_dir / f"v{i}.so")
    _build.build_all()
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"chip_ablate: {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(so))

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def r(*shape, sc=1.0):
        return sc * torch.randn(*shape, device=dev, generator=g)
    Bc, C0, N, K = 640, 4, 4096, 64
    R = Bc * N
    x3 = r(Bc, C0, N)
    w1, b1 = r(C0, 64, sc=0.5), r(64, sc=0.1)
    w2, w3, b3 = r(64, 64, sc=0.125), r(64, 256, sc=0.125), r(256, sc=0.1)
    mul1, shift1, mul2, shift2 = r(64), r(64), r(64, sc=0.3), r(64)
    p2, q3 = r(R, 64), r(R, 64, sc=0.1)
    M3, rc3, gi2 = r(64, 64, sc=0.01), r(64, sc=0.1), r(64)
    P = R // K
    u = torch.rand(P, 256, device=dev, generator=g)
    idx = torch.where(u < 0.47, 0, torch.where(u < 0.84, K, torch.randint(
        0, K, (P, 256), device=dev, generator=g))).to(torch.int32)
    calls = {"gp": (SP.sa_fwd_gram_pool, (p2, mul2, shift2, w3, b3, K),
                    "facl_sa_fwd_gram_pool"),
             "s1": (SP.sa_bwd_sweep1, (p2, mul2, shift2, r(P, 256), idx,
                                       r(256), w3, K), "facl_sa_bwd_sweep1"),
             "s2": (SP.sa_bwd_sweep2, (x3, w1, b1, mul1, shift1, p2, mul2,
                                       shift2, q3, M3, rc3, gi2, w2),
                    "facl_sa_bwd_sweep2"),
             "s3": (SP.sa_bwd_sweep3, (x3, w1, b1, mul1, shift1, q3,
                                       r(64, 64, sc=0.1), rc3),
                    "facl_sa_bwd_sweep3")}
    for fn, args, _ in calls.values():
        fn(*args)                         # resolves this tree's launchers

    def timed(name):
        fn, args, launcher = calls[VARIANTS[name][0]]
        key = ("sa_pair", launcher)
        ours = _build._FUNCTIONS[key]
        vfn = getattr(libs[name], launcher)
        vfn.argtypes, vfn.restype = ours[1].argtypes, ctypes.c_int
        _build._FUNCTIONS[key] = (libs[name], vfn)
        try:
            return cs.device_ms(lambda: fn(*args))[0]
        finally:
            _build._FUNCTIONS[key] = ours

    def clocks(kernel):
        """Mean cycles per tile of each phase (thread 0 of each block)."""
        fn, args, launcher = calls[kernel]
        vfn = getattr(libs[f"{kernel} clocks"], launcher)
        key = ("sa_pair", launcher)
        ours = _build._FUNCTIONS[key]
        vfn.argtypes, vfn.restype = ours[1].argtypes, ctypes.c_int
        _build._FUNCTIONS[key] = (libs[f"{kernel} clocks"], vfn)
        try:
            fn(*args)
            out = fn(*args)
        finally:
            _build._FUNCTIONS[key] = ours
        torch.cuda.synchronize()
        phases = [m[2] for m in CLOCKED[kernel][-1]]
        flat = out[1] if kernel == "s1" else \
            torch.cat([out[0], out[1][:, None]], 1).reshape(-1)
        tiles = R / 64 / (1 if kernel == "s1" else 2)   # per thread 0
        return {p: float(flat[k]) / tiles for k, p in enumerate(phases)}

    times = {name: [] for name in sources if not name.endswith("clocks")}
    for _ in range(2):
        for name in times:
            times[name].append(timed(name))
    cyc = {k: clocks(k) for k in ("s1", "s3") if f"{k} clocks" in libs}
    gpu = cs.gpu_name_power()
    for name, ms in times.items():
        print(f"{name}: {ms[0]:.4f} / {ms[1]:.4f} ms on the device ({gpu})",
              flush=True)
    for k, ph in cyc.items():
        print(f"{k} phase clocks (cycles per tile, thread 0, mean over "
              f"blocks): " + ", ".join(f"{p} {c:.0f}" for p, c in ph.items()),
              flush=True)
    print(json.dumps({"ablation": times, "clocks": cyc, "gpu": gpu}))


if __name__ == "__main__":
    main()
