#!/usr/bin/env python3
"""Where the tensor-core sweeps B2b (sa_fwd_gram_pool) and B3b
(sa_bwd_sweep2) spend their time on the card.

    python3 chip_ablate.py      # one CUDA device, nvcc

Each kernel is rebuilt from facl_tpu_torch/ops/csrc/sa_pair.cu with one
part cut out (the pool, the Gram, a product, the CUDA-core row passes),
and every variant is timed by chip_smoke.device_ms on the main path's
shapes (640 clouds x 4,096 rows, random data), twice, in turns. A
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
        ("    h1_rows(X, C0, W1s, v, h1h, h1l, m1);\n", "")]),
    "sweep2 without the row passes": ("s2", [
        ("    relu_rows(S, mul2, shift2, H2);\n"
         "    h1_rows(X, C0, W1s, v, h1h, h1l, m1);\n", "")]),
}


def variant_source(src: str, kernel: str, pairs) -> str:
    lo, hi = {"gp": (src.index("fwd_gram_pool_kernel(const float*"),
                     src.index("// B3 sweep 1:")),
              "s2": (src.index("bwd_sweep2_kernel(const float*"),
                     src.index("// B3 sweep 3:"))}[kernel]
    part = src[lo:hi]
    for old, new in pairs:
        if old not in part:
            raise SystemExit(f"chip_ablate: {old!r} not in the kernel")
        part = part.replace(old, new)
    return src[:lo] + part + src[hi:]


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
    procs = {}
    for i, (name, (kernel, pairs)) in enumerate(VARIANTS.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(variant_source(src, kernel, pairs))
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
    calls = {"gp": (SP.sa_fwd_gram_pool, (p2, mul2, shift2, w3, b3, K),
                    "facl_sa_fwd_gram_pool"),
             "s2": (SP.sa_bwd_sweep2, (x3, w1, b1, mul1, shift1, p2, mul2,
                                       shift2, q3, M3, rc3, gi2, w2),
                    "facl_sa_bwd_sweep2")}
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

    times = {name: [] for name in VARIANTS}
    for _ in range(2):
        for name in VARIANTS:
            times[name].append(timed(name))
    gpu = cs.gpu_name_power()
    for name, ms in times.items():
        print(f"{name}: {ms[0]:.4f} / {ms[1]:.4f} ms on the device ({gpu})",
              flush=True)
    print(json.dumps({"ablation": times, "gpu": gpu}))


if __name__ == "__main__":
    main()
