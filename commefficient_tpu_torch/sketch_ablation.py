"""Where the sketch and estimates kernels' time goes, on the card.

    python -m commefficient_tpu_torch.sketch_ablation [--reps 10]

Builds ``csrc/sketch.cu`` as it is and with one piece of the sketch and
estimates kernels replaced (each variant a copy of the source, all
built in parallel into ``_build/sketch_ablation/``), times each kernel
at GPT-2's shapes (d = 124 444 417 padded to m = 238 chunks of c =
524 288, r = 5, one-mix signs) with CUDA events and the 50 MB L2
flushed before each launch, and prints one JSON line per variant, one
line of the L2 read rate with each kernel's design floor, then the
card's name and power limit. The variants other than ``base`` compute
wrong results on purpose: they only time what is left.

- ``base``: the kernels as they are, the sketch reading its signs from
  the packed-sign stream (``CountSketch.packed_signs_on``) as the main
  path does;
- ``hashed`` (the sketch only): ``base`` with no stream, each sign
  hashed in the kernel (one murmur mix per row and element);
- ``no_hash``: a constant sign (no mix, no stream, no sign bit);
- ``loads_only``: no hash, and neither the sketch's add nor the
  estimates' median: the loads (their bits XORed together, one logic
  op a load, so that they stay alive), the index arithmetic and the
  stores;
- ``packed_signs`` (the estimates only): each sign read as bit ``row``
  of a byte a coordinate, as the sketch does, in place of the one mix
  a coordinate. A zeroed (padded_d,) u8 array in device memory stands
  in for the stream: the variant times its reads, not its values;
- ``one_row`` (the sketch only): ``base`` at r = 1, one read of v, to
  show what the r-fold re-reads cost.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from commefficient_tpu_torch import _build
from commefficient_tpu_torch.ops import sketch_kernels as sk
from commefficient_tpu_torch.ops.sketch import CountSketch

D, C, R, SEED = 124_444_417, 524_288, 5, 21

_SK_HASH = ("""const uint32_t flip =
                SIGNS == CET_SIGNS_STREAM
                    ? cet_flip_from_byte(__ldg(sgn + g), srow)
                    : cet_sign_flip(g, srow, seed, """
            "SIGNS == CET_SIGNS_ONE_MIX);")
_SK_ADD = "acc[row][k] += cet_apply_flip(x, flip);"
_ES_MIX = "const uint32_t h = ONE_MIX ? cet_mix32(g ^ seed) : 0u;"
_ES_FLIP = """const uint32_t flip = ONE_MIX ? cet_flip_from_mix(h, row)
                                  : cet_sign_flip(g, row, seed, 0);"""
_ES_MEDIAN = "return cet_median<R>(vals, r);"
# no add and no median: the loaded bits are XORed together (one logic
# op a load, which keeps the loads alive)
_SK_XOR = ("acc[row][k] = __uint_as_float(__float_as_uint(acc[row][k]) ^ "
           "__float_as_uint(x));")
# a zeroed (padded_d,) u8 stream in device memory stands in for the
# packed signs: the variant times its reads, not its values
_STREAM = ("__device__ uint8_t cet_ablation_signs[124780544];\n")
_ES_PACKED = ("const uint32_t h = (uint32_t)__ldg(cet_ablation_signs + g) "
              "<< 16;")
_ES_XOR = """{
  uint32_t b = 0u;
  for (int i = 0; i < r; ++i) b ^= __float_as_uint(vals[i]);
  return __uint_as_float(b);
}"""


def variants(src: str) -> dict:
    """{name: source}; raises if the kernels no longer have a piece that
    a variant replaces."""
    for piece in (_SK_HASH, _SK_ADD, _ES_MIX, _ES_FLIP, _ES_MEDIAN,
                  '#include "hash.cuh"\n'):
        if piece not in src:
            raise RuntimeError(f"csrc/sketch.cu has no {piece[:40]!r} any "
                               "more: update sketch_ablation")
    no_hash = (src.replace(_SK_HASH, "const uint32_t flip = 0u;")
               .replace(_ES_MIX, "const uint32_t h = 0u;")
               .replace(_ES_FLIP, "const uint32_t flip = 0u;"))
    loads_only = (no_hash.replace(_SK_ADD, _SK_XOR)
                  .replace(_ES_MEDIAN, _ES_XOR))
    inc = '#include "hash.cuh"\n'
    packed = (src.replace(inc, inc + _STREAM).replace(_ES_MIX, _ES_PACKED)
              .replace(_ES_FLIP, "const uint32_t flip = "
                                 "cet_flip_from_mix(h, row);"))
    return {"base": src, "no_hash": no_hash, "loads_only": loads_only,
            "packed_signs": packed}


def build(sources: dict) -> dict:
    """Builds every variant in parallel; {name: (sketch, estimates)}
    C entry points."""
    out_dir = _build.BUILD_DIR / "sketch_ablation"
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
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        sketch, est = lib.cet_sketch, lib.cet_estimates
        sketch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        est.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_uint, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        sketch.restype = est.restype = ctypes.c_int
        fns[name] = (sketch, est)
    return fns


def time_ms(run, reps, flush):
    """Median CUDA-event time of ``run`` over ``reps`` launches, the L2
    flushed before each."""
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=10)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sketch_ablation: needs a CUDA card")
    dev = torch.device("cuda", 0)
    fns = build(variants((_build.SRC_DIR / "sketch.cu").read_text()))
    s = CountSketch(d=D, c=C, r=R, seed=SEED)
    m, pd = s._m, s._padded_d
    rot = s.rotations_on(dev)
    seed, one_mix = s.sign_seed, int(s._one_mix_signs)
    gen = torch.Generator(device=dev).manual_seed(2)
    vp = torch.nn.functional.pad(torch.randn(D, generator=gen, device=dev),
                                 (0, pd - D))
    signs = s.packed_signs_on(dev)
    table = torch.empty(R, C, device=dev)
    est = torch.empty(pd, device=dev)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def sketch_run(fn, r, out, sgn=signs):
        return lambda: _build.check(
            fn(vp.data_ptr(), rot.data_ptr(), out.data_ptr(), m, C, r, seed,
               one_mix, 0, None if sgn is None else sgn.data_ptr(), stream),
            "ablation sketch")

    def emit(name, **row):
        print(json.dumps({"phase": "sketch_ablation", "variant": name,
                          **row}), flush=True)

    sketch_run(fns["base"][0], R, table)()  # a real table to read
    for name, (sketch, estimates) in fns.items():
        row = {}
        if name != "packed_signs":
            row["sketch_ms"] = time_ms(sketch_run(sketch, R, table.clone()),
                                       opts.reps, flush)
        row["estimates_ms"] = time_ms(lambda: _build.check(
            estimates(table.data_ptr(), rot.data_ptr(), est.data_ptr(), m, C,
                      R, seed, one_mix, D, stream), "ablation estimates"),
            opts.reps, flush)
        emit(name, **row)
        if name == "base":
            emit("hashed", sketch_ms=time_ms(
                sketch_run(sketch, R, table.clone(), None), opts.reps, flush))
    emit("one_row", sketch_ms=time_ms(
        sketch_run(fns["base"][0], 1, torch.empty(1, C, device=dev)),
        opts.reps, flush))
    rate = sk.l2_read_rate(dev)
    print(json.dumps({"phase": "l2_read", "bytes_per_s": rate,
                      "sketch_design_floor_ms": 5 * R * pd / rate * 1e3,
                      "estimates_design_floor_ms": 4 * R * pd / rate * 1e3,
                      "what": "r * padded_d reads from L2 at the probe's "
                              "rate: 4 bytes of v and 1 of the sign stream "
                              "(sketch), 4 of the table (estimates)"}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
