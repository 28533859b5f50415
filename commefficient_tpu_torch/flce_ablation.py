"""Where the flce backward's time goes, on the card.

    python -m commefficient_tpu_torch.flce_ablation [--reps 5]

Builds ``csrc/flce.cu`` as it is and with parts of the backward's tile
loop taken out (each variant a copy of the source with one piece
replaced, all built in parallel into ``_build/ablation/``), times each
pass of the backward (dX, then dW) at the GPT-2 round's shapes (M =
16 320, V = 50 262, C = 768, bf16) with CUDA events, and prints one
JSON line per variant, then the card's name and power limit. The
variants other than ``base`` compute wrong results on purpose: they only
time what is left.

- ``base``: the kernel as it is;
- ``no_d``: d is not formed (the logits are packed into A as they are);
- ``no_grad``: no gradient product (d is kept alive);
- ``loads_only``: neither logits nor gradient products: the cp.async
  ring, the swaps of partial sums and fragments, d and the barriers.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from commefficient_tpu_torch import _build
from commefficient_tpu_torch.ops import flce_kernels as fk

M, V, C = 4 * 8 * 2 * 255, 50_262, 768

_GRAD = """    bwd_grad<NF>(acc, afr,
                 cet_sw128_desc(stage_a, BWD_STR * 128, CET_SW128_ATOM), wg);"""
_KEEP_D = ("    if (afr[0][0] == 0x7fffffffu && afr[1][3] == 3u) "
           "acc[0] += 1.0f;")
_LOGITS = """    bwd_logits_half<NF>(lg, own_desc,
                        cet_sw128_desc(stage_a, 16, CET_SW128_ATOM), wg);"""
_D_START = "    // d = g_lse * softmax"
_D_END = "    uint32_t afr[2][4];"
_NO_D = ("    uint32_t a[4];\n#pragma unroll\n"
         "    for (int j = 0; j < 4; ++j) a[j] = __float_as_uint(h[2 * j]);\n")
# one C entry per pass at C = 768
_PASS = """
extern "C" int cet_ablation_pass(int own_tok, const void* x, const void* w,
                                 const int* labels, const float* lse,
                                 const float* g_lse, const float* g_tok,
                                 void* out, long long M, long long V,
                                 void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  cudaStream_t s = (cudaStream_t)stream;
  if (own_tok)
    return (int)launch_bwd<true, 12>(xb, wb, labels, lse, g_lse, g_tok,
                                     static_cast<bf16*>(out), M, V, s);
  return (int)launch_bwd<false, 12>(xb, wb, labels, lse, g_lse, g_tok,
                                    static_cast<bf16*>(out), M, V, s);
}
"""


def variants(src: str) -> dict:
    """{name: source}; raises if the kernel no longer has a piece that a
    variant takes out."""
    for piece in (_GRAD, _LOGITS, _D_START, _D_END):
        if piece not in src:
            raise RuntimeError(f"csrc/flce.cu has no {piece.strip()[:40]!r}"
                               " any more: update flce_ablation")
    d_block = src[src.index(_D_START):src.index(_D_END)]
    no_grad = src.replace(_GRAD, _KEEP_D)
    out = {"base": src, "no_d": src.replace(d_block, _NO_D),
           "no_grad": no_grad, "loads_only": no_grad.replace(_LOGITS, "")}
    # only the C = 768 instantiations
    return {k: re.sub(r"    CET_FLCE_CASE\((\d+)\)\n",
                      lambda m: m.group(0) if m.group(1) == "12" else "", v)
            + _PASS for k, v in out.items()}


def build(sources: dict) -> dict:
    """Builds every variant in parallel; {name: ctypes function}."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
               str(_build.SRC_DIR), "-o", str(out_dir / f"lib{name}.so"),
               str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")).cet_ablation_pass
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=5)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flce_ablation: needs a CUDA card")
    dev = torch.device("cuda", 0)
    fns = build(variants((_build.SRC_DIR / "flce.cu").read_text()))
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(M, C, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(V, C, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16)
    lab = torch.randint(0, V, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    lse, _ = fk.flce_fwd_plain(x, w, lab)
    g_lse = torch.rand(M, generator=gen, device=dev) / M
    g_tok = -g_lse
    outs = {1: torch.empty_like(x), 0: torch.empty_like(w)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, fn in fns.items():
        row = {}
        for own_tok, key in ((1, "dX_ms"), (0, "dW_ms")):
            def run():
                _build.check(fn(own_tok, x.data_ptr(), w.data_ptr(),
                                lab.data_ptr(), lse.data_ptr(),
                                g_lse.data_ptr(), g_tok.data_ptr(),
                                outs[own_tok].data_ptr(), M, V, stream),
                             f"ablation {name}")
            run()
            torch.cuda.synchronize()
            times = []
            for _ in range(opts.reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            row[key] = float(np.median(times))
        print(json.dumps({"phase": "flce_ablation", "variant": name, **row,
                          "sum_ms": row["dX_ms"] + row["dW_ms"]}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
