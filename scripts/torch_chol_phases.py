#!/usr/bin/env python3
"""Where the time of ``csrc/chol_inverse.cu`` goes, phase by phase, on one
NVIDIA GPU.

    python3 scripts/torch_chol_phases.py [--batch 128] [--p 256]

Builds copies of the kernel that return after each of its phases (the load
of the tiles, the blocked Cholesky, the diagonal tiles' inverses, X = U^-1)
beside the whole kernel, one ``nvcc`` each, side by side, into
``bilevel_gait_gen_tpu_torch/_build/chol-phases-<hash>/``; times each on the
same dense SPD matrices (CUDA events, bare launches in a row) and prints the
cumulative times, each phase's share, and the whole kernel's error against
``kernels.chol_inverse_unrolled``.  The cut copies compute no inverse: they
are for timing only.  The cut points are the kernel's own comment lines; if
one is gone the script stops and names it.
"""
import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bilevel_gait_gen_tpu_torch.ops import kernels  # noqa: E402
from bilevel_gait_gen_tpu_torch.ops.kernel_checks import cuda_ms  # noqa: E402

# (the line the copy returns before, the phases done by then)
CUTS = (("  // S = U^T U by block steps", "load"),
        ("  // X = U^-1: the diagonal tiles' inverses W", "Cholesky"),
        ("  for (int L = nb - 1; L >= 0; --L) {", "diagonal inverses"),
        ("  // Si = X X^T: tile (I, J)", "X = U^-1"))


def build(src: str) -> list[Path]:
    """One library per cut (CHOL_STOP = 1..4) and the whole kernel (0)."""
    for k, (line, _) in enumerate(CUTS, start=1):
        if src.count(line) != 1:
            raise RuntimeError(f"cut point not found once: {line!r}")
        src = src.replace(line, f"  if (CHOL_STOP == {k}) {{ if (tid == 0) "
                                f"Ob[0] = T[0]; return; }}\n{line}")
    out = kernels.BUILD_ROOT / (
        "chol-phases-" + hashlib.sha256(src.encode()).hexdigest()[:16])
    out.mkdir(parents=True, exist_ok=True)
    (out / "chol_phases.cu").write_text(src)
    libs = [out / f"chol_stop{k}.so" for k in range(len(CUTS) + 1)]
    procs = [subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", f"-DCHOL_STOP={k}",
         "-I", str(kernels.CSRC), "-o", str(lib), str(out / "chol_phases.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, lib in enumerate(libs)]
    for pr in procs:
        log = pr.communicate()[0]
        if pr.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + log)
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--p", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    B, p = args.batch, args.p
    libs = build((kernels.CSRC / "chol_inverse.cu").read_text())
    rng = np.random.default_rng(0)
    L = rng.standard_normal((B, p, p)) / np.sqrt(p)
    S = torch.tensor((L @ L.transpose(0, 2, 1) + 0.5 * np.eye(p)).astype(
        np.float32), device="cuda")
    ref = kernels.chol_inverse_unrolled(S)
    stream = torch.cuda.current_stream().cuda_stream
    name = torch.cuda.get_device_name(0)
    print(f"chol_inverse phases [{B}, {p}, {p}] on {name}")
    prev = 0.0
    for k, lib_path in list(enumerate(libs))[1:] + [(0, libs[0])]:
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.bggt_chol_inverse
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        Si = torch.empty_like(S)

        def launch():
            rc = fn(S.data_ptr(), Si.data_ptr(), B, p, stream)
            if rc != 0:
                raise RuntimeError(f"chol_inverse launch: CUDA error {rc}")

        launch()
        torch.cuda.synchronize()
        ms = cuda_ms(launch, inner=5)
        what = CUTS[k - 1][1] if k else "X X^T"
        extra = ""
        if k == 0:
            err = float((Si - ref).abs().max() / ref.abs().max())
            extra = f"; the whole kernel {ms:.4f} ms, rel to the plain {err:.2e}"
        print(f"  up to {what}: {ms:.4f} ms (the phase {ms - prev:.4f}){extra}")
        prev = ms


if __name__ == "__main__":
    main()
