#!/usr/bin/env python3
"""
Where the gamma kernel's device time goes, on one NVIDIA GPU.

    python3 tools/gamma_breakdown.py      (from the repository root)

Builds bild_tpu_torch/csrc/gamma_accept.cu as it is and five copies of it
(text substitutions, built beside the package's libraries in
bild_tpu_torch/_build/):

- ``static striding``: a thread takes the entries lo + t, lo + t + threads,
  ... in turn, in place of the next entry from the block's counter;
- ``one round``: every entry accepts its first round (the draw kept, its
  sign from the real test), so every entry costs one full round;
- ``one round, no hashing``: as ``one round``, the three element words
  used without their `mix64`;
- ``one round, no float routines``: as ``one round``, the normal a
  difference of its uniforms and the test without its logs;
- ``one round, neither``: both cuts, what is left being the launch, the
  bytes, the block's table of round words and the refill.

Times each by its device time (`chip_smoke.device_ms`: launches replayed in
a CUDA graph), in turns, beside the kernel at 64, 128 and 256 threads a
block and `torch._standard_gamma` at the same shapes, on 640 lanes of 640
entries (config 3's scout draws 640 x 128 x 5) with shapes 10^U(0, 1.5)
(most entries accept in one round) and 10^U(5, 10) (float32's degenerate
case, tens of rounds). The kernel as built, and its static-striding copy,
must equal the plain rounds.
Prints one line per case with the card's name and power limit. Without a
CUDA device it exits non-zero.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ROUND_TEST = "    const bool accept = pos && D::log(u) < rhs;\n"
ACCEPT = ("      out[base + i] = accept ? D::mul(de, v) : T(0);\n")
REFILL = ("      const cg::coalesced_group g = cg::coalesced_threads();\n"
          "      unsigned first = 0;\n"
          "      if (g.thread_rank() == 0) first = atomicAdd(&next, g.size());\n"
          "      i = static_cast<int>(g.shfl(first, 0) + g.thread_rank());\n")
CUTS = {
    "static striding": [(REFILL, "      i += blockDim.x;\n")],
    "one round": [
        (ROUND_TEST, "    const bool real = pos && D::log(u) < rhs;\n"
                     "    const bool accept = true;\n"),
        (ACCEPT, "      out[base + i] = real ? D::mul(de, v) : -D::mul(de, v);\n")],
    "no hashing": [(f"D::uniform(mix64(w.{w} + step))", f"D::uniform(w.{w} + step)")
                   for w in ("u1", "u2", "u")],
    "no float routines": [
        ("const T x = D::normal(u1, u2);", "const T x = D::sub(u1, u2);"),
        ("const T logv = D::log(pos ? v : T(1));", "const T logv = pos ? v : T(1);"),
        ("const bool real = pos && D::log(u) < rhs;",
         "const bool real = pos && u < rhs;")],
}
VARIANTS = {"static striding": ("static striding",),
            "one round": ("one round",),
            "one round, no hashing": ("one round", "no hashing"),
            "one round, no float routines": ("one round", "no float routines"),
            "one round, neither": ("one round", "no hashing", "no float routines")}
CASES = (("shapes 10^U(0, 1.5)", 0.0, 1.5), ("degenerate, 10^U(5, 10)", 5.0, 10.0))
LANES, PER_LANE = 640, 640


def variant_source(cuts):
    """The kernel's source with the substitutions of ``cuts`` made (each
    must match)."""
    src = (ROOT / "bild_tpu_torch" / "csrc" / "gamma_accept.cu").read_text()
    for cut in cuts:
        for old, new in CUTS[cut]:
            if old not in src:
                raise SystemExit(f"gamma_breakdown: {old!r} is not in the source")
            src = src.replace(old, new)
    return src


def build(name, src):
    """``src`` built with the package's nvcc flags into _build/<name>.so."""
    from bild_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"{name}.cu"
    so = _build.BUILD_DIR / f"{name}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.bild_gamma_accept_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, d, c, keys, threads):
    """A launch of the built entry ``fn`` on (d, c, keys) with the plan's
    ranges and ``threads`` threads a block."""
    from bild_tpu_torch.amis import dirichlet

    L, per = keys.numel(), d.numel() // keys.numel()
    blocks, span, _ = dirichlet.gamma_plan(L, per)

    def run():
        out = torch.empty_like(d)
        flag = torch.zeros((), dtype=torch.bool, device=d.device)
        rc = fn(d.data_ptr(), c.data_ptr(), keys.data_ptr(), out.data_ptr(),
                flag.data_ptr(), L, per, blocks, span, threads,
                dirichlet.GAMMA_MAX_ROUNDS, d.device.index or 0,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gamma_breakdown: launch failed ({rc})")
        return out
    return run


def main():
    if not torch.cuda.is_available():
        raise SystemExit("gamma_breakdown.py: no CUDA device")
    import chip_smoke
    from bild_tpu_torch.amis import dirichlet
    from bild_tpu_torch.lanes import LaneRNG

    print(chip_smoke.card(), flush=True)
    kernel = build("gamma_breakdown-kernel", variant_source(()))
    cut = {name: build(f"gamma_breakdown-{i}", variant_source(cuts))
           for i, (name, cuts) in enumerate(VARIANTS.items())}
    gen = torch.Generator(device="cuda").manual_seed(3)
    keys = LaneRNG.from_seeds(list(range(LANES)), "cuda").fold(9).keys
    for label, lo, hi in CASES:
        a = 10.0 ** (lo + (hi - lo) * torch.rand((LANES, PER_LANE), generator=gen,
                                                 device="cuda"))
        d = a - 1.0 / 3.0
        c = 1.0 / torch.sqrt(9.0 * d)
        runs = {f"kernel, {t} threads": launcher(kernel, d, c, keys, t)
                for t in (64, 128, 256)}
        runs.update({name: launcher(fn, d, c, keys, dirichlet.GAMMA_THREADS)
                     for name, fn in cut.items()})
        runs["torch._standard_gamma"] = lambda a=a: torch._standard_gamma(a)
        want = dirichlet._gamma_accept(d, c, LaneRNG(keys))
        for name in (*(f"kernel, {t} threads" for t in (64, 128, 256)),
                     "static striding"):
            if not torch.equal(runs[name](), want):
                raise SystemExit(f"gamma_breakdown: {name} differs from the "
                                 "plain rounds")
        times = {name: [] for name in runs}
        for rep in range(4):                 # in turns, the order flipped
            order = list(runs.items())
            for name, fn in (order if rep % 2 == 0 else order[::-1]):
                times[name].append(chip_smoke.device_ms(fn) * 1e3)
        print(f"{label} ({LANES} x {PER_LANE} float32): "
              + "; ".join(f"{name} {min(v):.2f} us (median {sorted(v)[1]:.2f}"
                          f"-{sorted(v)[2]:.2f})" for name, v in times.items()),
              flush=True)


if __name__ == "__main__":
    main()
