#!/usr/bin/env python3
"""Bare-launch times of the PyTorch port's CUDA kernels on one NVIDIA GPU.

    python3 scripts/torch_kernel_bench.py [ROOT] [--only=gtwg,sweep,gj]
                                          [extra nvcc flags ...]

ROOT is a checkout that holds ``bilevel_gait_gen_tpu_torch`` and
``chip_smoke.py`` (default: this one).  Another checkout, such as an
unpacked parent commit, can be timed beside this one in the same run on the
same card; the script adapts to the older wrappers (no ``ns_gemm_launch``, no
``M=`` keyword, no ``gj_launch``).  ``--only=`` names the sections to run
(default: all three).  It builds the kernels of ROOT, prints the registers
ptxas gave each kernel, checks ``gtwg`` and the Newton-Schulz product against
their plain versions, and times with CUDA events, as the median of 10
timings of several launches in a row (so that no host work sits in the
window):

* ``gtwg`` and the Newton-Schulz product as bare launches at the lane batch
  (512), the polish batch (128) and three ragged shapes, with the PyTorch
  call for the same function beside them;
* on the lane problems of the bench cadence: the iteration kernel alone, the
  sweep through its wrapper with and without the Newton-Schulz refresh, and
  (where the wrapper takes it) the exact sweep handed its M;
* ``gj_inverse`` as bare launches on shifted, identity-padded SPD matrices
  at the RTI shape [128, 232 -> 256] and the lanes' [512, 256, 256], in the
  form the wrapper picks and (where the tree has them) in each form by name,
  with ``torch.linalg.inv`` beside it, and ``spd_inverse`` whole with its
  deflation share at [128, 232, 232].

``chip_smoke.py`` measures the same kernels through their wrappers and
holds them to their tolerances; this script is for comparing two versions
of a kernel.
"""
import inspect
import sys
from pathlib import Path

import numpy as np

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parent.parent).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from bilevel_gait_gen_tpu_torch.ops import kernels  # noqa: E402
from bilevel_gait_gen_tpu_torch.utils.precision import (  # noqa: E402
    set_fp32_precision)


def cuda_ms(fn, inner=1, reps=10, warm=2):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def bench_gj(lib, stream, dev):
    """gj_inverse bare at both path shapes, spd_inverse whole."""
    rng = np.random.default_rng(0)
    forms = hasattr(kernels, "gj_launch")

    def padded(B, n, nv):
        L = rng.standard_normal((B, nv, nv)).astype(np.float32) / np.sqrt(nv)
        M = np.zeros((B, n, n), np.float32)
        M[:, :nv, :nv] = L @ L.transpose(0, 2, 1) + 0.1 * np.eye(
            nv, dtype=np.float32)
        M[:, range(nv, n), range(nv, n)] = 1.0
        return torch.tensor(M + np.float32(1e-3) * np.eye(n, dtype=np.float32),
                            device=dev)

    for B, n, nv in ((128, 256, 232), (512, 256, 256)):
        M = padded(B, n, nv)
        out = torch.empty_like(M)
        ref = kernels.gj_inverse_reference(M, w=kernels.GJ_BLOCK)
        inv_ms = cuda_ms(lambda: torch.linalg.inv(M))
        if forms:
            picked = kernels.gj_form(lib, n, nv)
            todo = [picked] + [f for f in ("resident", "streaming")
                               if f != picked and (f != "resident"
                                                   or nv <= 232)]
        else:
            picked, todo = "parent", ["parent"]
        for form in todo:
            def launch():
                if forms:
                    kernels.gj_launch(lib, stream, M, out, nv, form)
                else:
                    kernels._check(lib, lib.bggt_gj_inverse(
                        M.data_ptr(), out.data_ptr(), B, n, 1, stream), "gj")
            launch()
            torch.cuda.synchronize()
            print(f"gj_inverse [{B}, {nv} -> {n}] {form}"
                  f"{' (picked)' if form == picked else ''}: rel "
                  f"{cs.rel_err(out, ref):.2e}, bitwise "
                  f"{torch.equal(out, ref)}; bare launch "
                  f"{cuda_ms(launch, 5):.3f} ms, torch.linalg.inv "
                  f"{inv_ms:.3f} ms")
    S = padded(128, 232, 232)
    whole = cuda_ms(lambda: kernels.spd_inverse(S))
    nodefl = cuda_ms(lambda: kernels.spd_inverse(S, deflate=0))
    print(f"spd_inverse [128, 232, 232]: whole {whole:.3f} ms, of which "
          f"deflation {whole - nodefl:.3f} ms")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    set_fp32_precision()
    only = {"gtwg", "sweep", "gj"}
    for arg in sys.argv[2:]:
        if arg.startswith("--only="):
            only = set(arg[len("--only="):].split(","))
        else:
            kernels.NVCC_FLAGS = kernels.NVCC_FLAGS + (arg,)
    print(f"== {ROOT}")
    cs.phase_device()
    lib, path = kernels.build()
    for ln in (path.parent / "build.log").read_text().splitlines():
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
            print("  ", ln.strip()[:150])
    dev, stream = torch.device("cuda"), kernels._stream()
    w_hi = 0.01 / torch.finfo(torch.float32).eps
    new_api = hasattr(kernels, "ns_gemm_launch")
    if "gj" in only:
        bench_gj(lib, stream, dev)

    def gemm(A, Bm, C, alpha, diag):
        if new_api:
            kernels.ns_gemm_launch(lib, stream, A, Bm, C, alpha, diag)
        else:
            kernels._check(lib, lib.bggt_gemm(
                A.data_ptr(), Bm.data_ptr(), C.data_ptr(), A.shape[0],
                A.shape[-1], alpha, diag, stream), "gemm")

    g = torch.Generator(device=dev).manual_seed(0)
    shapes = ((512, 1280, 256), (128, 1280, 256), (128, 1232, 232),
              (16, 300, 130), (16, 333, 70))
    for B, m, n in shapes if "gtwg" in only else ():
        H = torch.randn(B, n, n, device=dev, generator=g)
        G = torch.randn(B, m, n, device=dev, generator=g)
        lam = torch.rand(B, m, device=dev, generator=g) + 0.01
        s = torch.rand(B, m, device=dev, generator=g) + 0.01
        W = torch.clamp(lam / s, 1 / w_hi, w_hi)
        M = kernels.gtwg(H, G, lam=lam, s=s, w_hi=w_hi, reg=1e-6)
        ref = kernels.gtwg_reference(H, G, W, 1e-6)
        S = kernels.gtwg(torch.zeros_like(H), G, W)
        out = torch.empty_like(H)
        ms = cuda_ms(lambda: kernels.gtwg_launch(
            lib, stream, H, G, None, lam, s, out, 1e-6, 1 / w_hi, w_hi), 5)
        lib_ms = cuda_ms(lambda: torch.baddbmm(H, (G * W[..., None]).mT, G))
        print(f"gtwg [{B}, n={n}, m={m}]: rel {cs.rel_err(M, ref):.2e}, "
              f"upper triangle bitwise "
              f"{torch.equal(torch.triu(M), torch.triu(ref))}, G^T W G "
              f"symmetric {torch.equal(S, S.mT)}; bare launch {ms:.3f} ms, "
              f"baddbmm on the scaled G {lib_ms:.3f} ms")
        A, Bm = (torch.randn(B, n, n, device=dev, generator=g)
                 for _ in range(2))
        C = torch.empty_like(A)
        gemm(A, Bm, C, -1.0, 2.0)
        refc = 2.0 * torch.eye(n, device=dev) - A @ Bm
        ms = cuda_ms(lambda: gemm(A, Bm, C, -1.0, 2.0), 5)
        eye = torch.eye(n, device=dev).expand(B, n, n)
        lib_ms = cuda_ms(lambda: torch.baddbmm(eye, A, Bm, beta=2.0,
                                               alpha=-1.0))
        print(f"NS product [{B}, {n}, {n}]: bitwise {torch.equal(C, refc)}; "
              f"bare launch {ms:.3f} ms, baddbmm {lib_ms:.3f} ms")

    if "sweep" not in only:
        return
    cfg = cs.bench_config()
    calls = cs.capture_sweeps(cs.lane_qps(cfg, dev), cfg)
    takes_m = "M" in inspect.signature(kernels.ipm_iter).parameters
    for idx in (0, 2):
        args, kw = calls[idx]
        kw = {k: v for k, v in kw.items() if k != "M"}
        H, q, A, b, G, h, ga, x, y, lam, s, done, it, best, Mi_in, _ = args
        ref = kernels.ipm_iter_reference(*cs.clone_args(args), **kw)
        got = kernels.ipm_iter(*cs.clone_args(args), **kw)
        errs = ", ".join(f"{cs.rel_err(a, r):.1e}"
                         for a, r in zip(got[:4], ref[:4]))
        print(f"lane sweep {idx} do_ns={int(args[15])}: x, y, lam, s rel "
              f"{errs}; done {torch.equal(got[4], ref[4])}, it "
              f"{torch.equal(got[5], ref[5])}")
        M = kernels.gtwg(H, G, lam=lam, s=s, w_hi=w_hi, reg=kw["reg"])
        state = [t.clone() for t in (x, y, lam, s, *best)]
        done_i, itc = done.to(torch.int32), it.clone()
        ms = cuda_ms(lambda: kernels.ipm_iter_launch(
            lib, stream, H, q, A, b, G, h, ga, M, Mi_in, *state, done_i, itc,
            reg=kw["reg"], tol=kw["tol"], refine_steps=kw["refine_steps"]), 3)

        def fresh():
            a2 = list(args)
            a2[7:11] = [t.clone() for t in args[7:11]]
            a2[12], a2[13] = it.clone(), tuple(t.clone() for t in best)
            return a2

        line = (f"   iteration kernel alone {ms:.3f} ms; sweep through the "
                f"wrapper {cuda_ms(lambda: kernels.ipm_iter(*fresh(), **kw)):.3f} ms")
        if takes_m:
            same = all(torch.equal(a, b_) for a, b_ in zip(
                kernels.ipm_iter(*cs.clone_args(args), M=M, **kw)[:4],
                got[:4]))
            ms_m = cuda_ms(lambda: kernels.ipm_iter(*fresh(), M=M, **kw))
            line += f", handed its M {ms_m:.3f} ms (same bits: {same})"
        print(line)


if __name__ == "__main__":
    main()
